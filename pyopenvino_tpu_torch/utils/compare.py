"""Golden feature-map comparison: the ``expected_result`` hook of the
interpreter and of the compiled path.

The port's copy of ``pyopenvino_tpu/utils/compare.py``.  An entry is a
bare array or the reference's ``(precision, dims, ndarray)`` record; the
check is ``np.allclose`` at the hook's relative tolerance, printed as a
green MATCH or a red MISMATCH line when asked.
"""

from __future__ import annotations

import numpy as np

_GREEN, _RED, _RESET = "\x1b[32m", "\x1b[31m", "\x1b[0m"


def golden_array(want) -> np.ndarray:
    """Unwrap an expected_result entry: (prec, dims, ndarray) or ndarray."""
    if isinstance(want, tuple) and len(want) == 3:
        _prec, dims, arr = want
        arr = np.asarray(arr)
        return arr.reshape(tuple(dims)) if dims else arr
    return np.asarray(want)


def compare_golden(name: str, got: np.ndarray, want, rtol: float = 1.0,
                   verbose: bool = False) -> bool:
    """allclose against a golden entry, with the reference's colored line."""
    arr = golden_array(want).astype(np.asarray(got).dtype, copy=False)
    ok = bool(np.allclose(got, arr, rtol=rtol))
    if verbose:
        col = _GREEN if ok else _RED
        print(f"{col}{name} : {np.asarray(got).shape} / {arr.shape} "
              f"{'MATCH' if ok else 'MISMATCH'}{_RESET}")
    return ok
