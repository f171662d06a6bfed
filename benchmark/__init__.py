"""The benchmark of kaamer_tpu_torch served over HTTP (README.md)."""
