"""Device activities by kind: a frozen copy of the category table of
``pyopenvino_tpu_torch/runtime/profiling.py`` (PR 23), with one row added,
``patches``, for ``torch.cat``'s copy kernel, which builds the im2col
patches and which that table leaves to ``other``.

Frozen here so that a later change to the program's table cannot move a
kernel from one of the benchmark's metrics to another.  A new kernel name
that matches no row is ``other``: it counts in ``kernel_roofline``'s
denominator and is listed on standard error, so it can lower that share
but never raise it.
"""

from __future__ import annotations

# (category, substrings of the device activity's name), first match wins
CATEGORIES = (
    ("dw_pw_fused", ("dw_pw_kernel",)),
    ("conv2d_direct_f32", ("ConvAF32",)),
    ("conv2d_direct_float_bf16", ("ConvABf16",)),
    ("fused_gemm_bf16_i8w", ("bf16mma::BInt8", "bf16wgmma::BandInt8")),
    ("fused_gemm_bf16", ("bf16_mma_kernel", "bf16_wgmma_kernel")),
    ("conv2d_direct", ("ConvA,", "ConvA>", "ConvAIm2col")),
    ("fused_gemm_i8i8", ("i8i8_mma_kernel", "i8wgmma::TiledA")),
    ("fused_gemm_i8w", ("f32mma::BInt8", "f32wgmma::BInt8")),
    ("fused_gemm", ("f32mma::BFloat", "f32wgmma::BFloat")),
    ("splitk_reduce", ("splitk_reduce",)),
    ("softmax_rows", ("softmax_rows",)),
    ("patches", ("CatArray",)),
    ("copy", ("Memcpy", "Memset")),
    ("pool", ("pool",)),
    ("conv_and_library_gemm", ("conv", "cudnn", "xmma", "sm90", "sm80",
                               "gemm", "gemv", "implicit")),
    ("softmax_library", ("softmax",)),
    ("elementwise", ("elementwise", "vectorized", "copy_kernel", "reduce")),
)

# the int8 loops' categories whose kernel writes bfloat16 under a name of
# its own
BF16_OUT = ("conv2d_direct", "fused_gemm_i8i8", "dw_pw_fused")

# the categories that do a Convolution's, GroupConvolution's or MatMul's
# products: the port's kernels, their split-K reductions and the library's
# convolutions and products
CONV_GEMM = frozenset(
    [cat for cat, _ in CATEGORIES[:CATEGORIES.index(("splitk_reduce", ("splitk_reduce",))) + 1]]
    + [cat + "_bf16" for cat in BF16_OUT] + ["conv_and_library_gemm"])

# everything else the ops layer issues
OPS = frozenset(["softmax_rows", "patches", "copy", "pool", "softmax_library", "elementwise"])

OTHER = "other"


def categorize(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat + "_bf16" if cat in BF16_OUT and "bfloat16" in low else cat
    return OTHER
