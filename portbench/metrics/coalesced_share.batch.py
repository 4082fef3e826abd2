"""Share of the window's completed requests served by a fused launch
(ServiceStats: n_coalesced_queries over n_completed)."""


def read(run):
    n = run.stats.get("n_completed", 0)
    return 100.0 * run.stats["n_coalesced_queries"] / n if n else None
