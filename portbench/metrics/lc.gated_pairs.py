"""lc.gated_pairs: candidate pairs per map that pass the chi-square gate
and go to the scan matcher (len(AutoLCReport.gated_pairs))."""

import statistics


def read(run):
    pairs = run.counts.get("gated_pairs")
    return statistics.fmean(pairs) if pairs and "lc" in run.spans else None
