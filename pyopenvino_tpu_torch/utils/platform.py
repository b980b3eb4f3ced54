"""Device selection for scripts and applications.

The port's counterpart of ``pyopenvino_tpu/utils/platform.py``.  The JAX
module's ``force_cpu`` and ``persistent_compile_cache`` switch
``jax.config``; here a device is an argument, not a process setting:
``select_device("cpu")`` is ``force_cpu``'s counterpart (pass the device
it returns to ``compile_model`` or ``IECore.load_network``), and
``runtime/cache.enable_model_cache`` is ``persistent_compile_cache``'s.
No environment variable switches either.
"""

from __future__ import annotations

import torch


def select_device(device: str = "auto") -> torch.device:
    """``"cpu"``: the CPU.  ``"gpu"`` and ``"auto"``: the card, and a
    RuntimeError where PyTorch sees none (the port never falls back to the
    CPU on its own)."""
    name = device.lower()
    if name == "cpu":
        return torch.device("cpu")
    if name in ("gpu", "auto"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: PyTorch sees no CUDA device")
        return torch.device("cuda")
    raise ValueError(f"unknown device {device!r}: 'cpu', 'gpu' or 'auto'")
