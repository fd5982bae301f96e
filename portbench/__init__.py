"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``)
on one H100. ``run.py`` runs one cell once; ``README.md`` says how the
cells, configurations, traffic mixes and metrics are laid out as files."""
