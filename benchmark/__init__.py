"""The benchmark of sgrt_tpu_torch (see run.py)."""
