"""The benchmark of mec_tpu_torch: see README.md."""
