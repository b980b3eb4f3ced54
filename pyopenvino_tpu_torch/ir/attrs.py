"""Attribute-string parsing helpers.

The IR stores every layer attribute as a string ("1, 1", "true", "same_upper");
these helpers are the typed equivalents of the reference's
string_to_boolean/string_to_tuple (reference: pyopenvino/common_def.py:21-32).
The port's own copy of the parts of ``pyopenvino_tpu/ir/attrs.py`` that its
ops read.
"""

from __future__ import annotations

from typing import Tuple


def to_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes")


def to_int_tuple(s: str) -> Tuple[int, ...]:
    s = s.strip()
    if not s:
        return ()
    return tuple(int(t) for t in s.split(","))


def get_int(attrs, key, default=None):
    if key in attrs:
        return int(float(attrs[key]))
    if default is None:
        raise KeyError(key)
    return default


def get_float(attrs, key, default=None):
    if key in attrs:
        return float(attrs[key])
    if default is None:
        raise KeyError(key)
    return default


def get_bool(attrs, key, default=False):
    return to_bool(attrs[key]) if key in attrs else default


def get_str(attrs, key, default=None):
    if key in attrs:
        return attrs[key]
    if default is None:
        raise KeyError(key)
    return default


def get_int_tuple(attrs, key, default=None):
    if key in attrs:
        return to_int_tuple(attrs[key])
    if default is None:
        raise KeyError(key)
    return default
