"""Sharding of the port (counterpart of ``repro.distributed``): the
logical-axis rules and the cyclic row layout of the match stack."""
