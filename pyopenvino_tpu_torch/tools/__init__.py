"""Tools of the port: the command-line ones (``python -m
pyopenvino_tpu_torch.tools.<name>``) and the offline POT quantizer
(``pot_quantize.py``)."""
