"""The benchmark of diamond_types_tpu_torch (see README.md)."""
