"""Tests of the benchmark: CPU ones, and card ones marked ``cuda``."""
