"""Own time of the engine's launch spans (dispatch) per completed read."""
from portbench.readers import ms_per, span_s


def read(run):
    return ms_per(span_s(run, "launch"), run.done)
