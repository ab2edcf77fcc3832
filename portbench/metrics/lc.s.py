"""lc.s: seconds per map in automatic loop closure (loop_closure/auto_lc:
candidates, chi-square gate, scan matching, re-solve), from the
benchmark's synchronised span around solve_auto_lc."""

import statistics


def read(run):
    spans = run.spans.get("lc")
    return statistics.fmean(spans) if spans else None
