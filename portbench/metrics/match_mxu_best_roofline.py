"""match_mxu_best's least time over its device time in the traced window
(roofline/match_mxu_best.py)."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "match_mxu_best")
