"""LM serving (port of ``repro.serving``): the slot engine, n-gram
speculative decoding, and its CRAM-PM proposer."""
