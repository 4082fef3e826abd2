"""match_mxu's least time over its device time in the traced window
(roofline/match_mxu.py)."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "match_mxu")
