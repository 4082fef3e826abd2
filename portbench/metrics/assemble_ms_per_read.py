"""Own time of the engine's assemble spans (the per-chunk blocks joined
into a result's arrays) per completed read."""
from portbench.readers import ms_per, span_s


def read(run):
    return ms_per(span_s(run, "assemble"), run.done)
