"""Published peaks of the cards the benchmark knows: NVIDIA's data sheets,
dense rates (no sparsity), at the full power limit.  A card not listed has
no peaks, and the metrics that need them report nothing there."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    # H100 SXM5: 700 W
    "NVIDIA H100 80GB HBM3": {"int8": 1979e12, "bfloat16": 989e12, "tf32": 495e12,
                              "float32": 67e12, "bytes_per_s": 3.35e12},
    # H100 PCIe: 350 W
    "NVIDIA H100 PCIe": {"int8": 1513e12, "bfloat16": 756e12, "tf32": 378e12,
                         "float32": 51e12, "bytes_per_s": 2.0e12},
}


def of(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)
