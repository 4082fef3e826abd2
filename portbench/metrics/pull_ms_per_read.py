"""Own time of the pull spans (device-to-host copies, the wait for the
device included) per completed read."""
from portbench.readers import ms_per, span_s


def read(run):
    return ms_per(span_s(run, "pull"), run.done)
