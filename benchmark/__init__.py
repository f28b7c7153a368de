"""The benchmark of star_tpu_torch (see BENCHMARK.json at the root)."""
