"""kernel.fused_coarse_roofline: the fused coarse CSM kernel's share of its
roofline in the profiled map, in %: the least time of each launch (from
its recorded inputs, portbench/roofline.fused_coarse_work against the
H100 SXM peaks) summed, over the launches' kernel time in the profiler's
trace.  Nothing to read when the map launched no coarse kernel, or when
the trace's launches do not pair with the recorded ones."""

from portbench import roofline


def read(run):
    if not run.launches or not run.profiled:
        return None
    times = run.profiled["kernels"].get("fused_coarse_kernel", [])
    if len(times) != len(run.launches) or sum(times) <= 0:
        return None
    least = sum(roofline.fused_coarse_work(p, t, tb, **kw)["bound_ms"]
                for p, t, tb, kw in run.launches) * 1e-3
    return 100.0 * least / sum(times)
