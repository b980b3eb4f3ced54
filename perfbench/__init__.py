"""The benchmark of pyopenvino_tpu_torch (run.py; README.md)."""
