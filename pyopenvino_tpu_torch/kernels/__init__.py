"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it:

  * gemm.fused_gemm      — CUDA C++ (csrc/fused_gemm.cu, a float32-B and
    an int8-B entry point), replaces pyopenvino_tpu/kernels/gemm.py::fused_gemm;
  * conv.conv2d_fused    — Python wrapper over fused_gemm, replaces
    pyopenvino_tpu/kernels/conv.py::conv2d_fused;
  * softmax.softmax_rows — Triton, replaces
    pyopenvino_tpu/kernels/softmax.py::softmax_rows.

Submodules are imported where they are used, so importing this package
builds nothing.
"""
