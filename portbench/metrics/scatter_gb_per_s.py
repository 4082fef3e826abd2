"""Bytes the service.scatter spans copied into per-query views (their
``bytes``) over those spans' own seconds, in GB/s (1e9 B/GB)."""


def read(run):
    got = [(s[2], s[3].get("bytes")) for s in run.spans
           if s[0] == "service.scatter"]
    own = sum(t for t, _ in got)
    if not run.done or not own or any(b is None for _, b in got):
        return None
    return sum(b for _, b in got) / own / 1e9
