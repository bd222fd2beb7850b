"""The benchmark of speechmix_tpu_torch on the H100 (see README.md)."""
