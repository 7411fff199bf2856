"""The benchmark harness of pyfasst_tpu_torch (see benchmark/run.py)."""
