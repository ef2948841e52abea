"""The benchmark of the PyTorch and CUDA port (supervised_gan_tpu_torch):
one command, ``python3 -m portbench.run``, runs one cell of BENCHMARK.json
once on a card.  See PERF.md for the cells, metrics and limits."""
