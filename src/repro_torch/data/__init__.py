"""Data plane of the port: near-duplicate filtering on the match engine
(``dedup``).  The LM data pipeline of ``repro.data.pipeline`` arrives
with the LM substrate."""
