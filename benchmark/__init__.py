"""The benchmark of designcsg_tpu_torch on the card (see BENCHMARK.json at
the root of the checkout and ``python -m benchmark.run --help``)."""
