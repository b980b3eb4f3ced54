"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it:

  * gemm.fused_gemm      — CUDA C++ (csrc/fused_gemm.cu: float32 B, int8 B,
    and int8 × int8 entry points), replaces
    pyopenvino_tpu/kernels/gemm.py::fused_gemm;
  * conv.conv2d_fused    — Python wrapper over fused_gemm, replaces
    pyopenvino_tpu/kernels/conv.py::conv2d_fused;
  * conv_direct.conv2d_direct — CUDA C++ (csrc/conv_direct.cu: int8 and
    float32 entry points, on the int8 and the TF32 tensor-core loops),
    replaces pyopenvino_tpu/kernels/conv_direct.py::conv2d_direct;
  * dw_pw.dw_pw_fused    — CUDA C++ (csrc/dw_pw.cu: the depthwise stage on
    the CUDA cores, the pointwise on the int8 tensor-core loop's warp
    step), replaces tools/dw_pw_kernel.py::dw_pw_fused;
  * softmax.softmax_rows — Triton, replaces
    pyopenvino_tpu/kernels/softmax.py::softmax_rows.

Submodules are imported where they are used, so importing this package
builds nothing.
"""


def launch_counts():
    """{kernel variant: its launches}: each wrapper's counter, which it adds
    one to where it launches its kernel on the card (``chip_smoke.py``'s
    names)."""
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows

    return {"fused_gemm": fused_gemm.launches,
            "fused_gemm_i8w": fused_gemm.launches_i8w,
            "fused_gemm_i8i8": fused_gemm.launches_i8i8,
            "conv2d_direct": conv2d_direct.launches,
            "conv2d_direct_f32": conv2d_direct.launches_f32,
            "dw_pw_fused": dw_pw_fused.launches,
            "softmax_rows": softmax_rows.launches,
            "fused_gemm_bf16": fused_gemm.launches_bf16,
            "fused_gemm_bf16_i8w": fused_gemm.launches_bf16_i8w,
            "fused_gemm_i8i8_bf16": fused_gemm.launches_i8i8_bf16,
            "conv2d_direct_bf16": conv2d_direct.launches_bf16,
            "softmax_rows_bf16": softmax_rows.launches_bf16,
            "conv2d_direct_float_bf16": conv2d_direct.launches_float_bf16,
            "dw_pw_fused_bf16": dw_pw_fused.launches_bf16}


def reset_launch_counts():
    """Every wrapper's launch counters back to 0."""
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows

    for wrapper in (fused_gemm, conv2d_direct, dw_pw_fused, softmax_rows):
        for name in [a for a in vars(wrapper) if a.startswith("launches")]:
            setattr(wrapper, name, 0)
