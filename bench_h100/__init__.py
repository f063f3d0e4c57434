"""The benchmark of ``kandinsky2_tpu_torch`` on NVIDIA H100 cards: see
``run.py`` and ``BENCHMARK.json`` at the repository's root."""
