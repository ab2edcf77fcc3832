"""device.idle_map: the share of a map's wall in which the card runs no
kernel, copy or set, in %: 1 - (busy union of the profiled map) / (median
unprofiled wall of the maps of the same recording in this run's window)."""

import statistics


def read(run):
    if run.metric != "map_s" or not run.profiled:
        return None
    walls = [w for w, k in zip(run.unit_walls, run.unit_keys)
             if k == run.profiled["key"]]
    if not walls:
        return None
    return 100.0 * (1.0 - run.profiled["busy_s"] / statistics.median(walls))
