"""The benchmark of misaki_tpu_torch: `run.py` runs one cell of
BENCHMARK.json on the card and prints one JSON line."""
