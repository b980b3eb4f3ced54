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
