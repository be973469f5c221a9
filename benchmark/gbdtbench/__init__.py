"""The harness of the benchmark of ``lightgbm_tpu_torch`` (see
benchmark/README.md).  It imports neither jax nor lightgbm_tpu."""
