"""Measurement helpers that run the benchmark: the spread of repeated
runs, and the readings a correctness limit is set from."""
