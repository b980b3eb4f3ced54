"""Command-line tools of the port (``python -m pyopenvino_tpu_torch.tools.<name>``)."""
