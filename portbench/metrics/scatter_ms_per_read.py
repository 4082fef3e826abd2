"""Own time of the service.scatter spans (a fused launch's per-query
views, cache entries and completions) per completed read."""
from portbench.readers import ms_per, span_s


def read(run):
    return ms_per(span_s(run, "service.scatter"), run.done)
