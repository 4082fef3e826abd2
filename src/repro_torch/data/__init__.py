"""Data plane of the port: near-duplicate filtering on the match engine
(``dedup``) and the LM data pipeline (``pipeline``: ``SyntheticLM``,
``TextLM``, ``host_shard``)."""
