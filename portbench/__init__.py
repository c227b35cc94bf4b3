"""The port benchmark: one cell of BENCHMARK.json a run (see run.py)."""
