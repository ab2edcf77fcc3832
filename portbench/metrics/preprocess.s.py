"""preprocess.s: seconds per map in the port's preprocessing and problem
build (core/preprocess, core/problem), from the benchmark's synchronised
span around those calls."""

import statistics


def read(run):
    spans = run.spans.get("preprocess")
    return statistics.fmean(spans) if spans else None
