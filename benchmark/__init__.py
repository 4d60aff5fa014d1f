"""The benchmark of the PyTorch port (``bde2vid_tpu_torch``): ``run.py`` runs
one cell of ``BENCHMARK.json`` and prints one JSON result line."""
