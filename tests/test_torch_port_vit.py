"""ViT-tiny (the port's ``models/vit_tiny.xml`` with the weights
``models/vit_tiny.py`` replays, byte for byte those of ``tools/gen_vit.py``)
on the port against the JAX package, mirroring tests/test_vit.py: MatMuls
of two activations (Q·Kᵀ with transpose_b, attn·V, rank 4), a SoftMax over
the last axis of a rank-4 tensor, rank-3 MVN as LayerNorm, Gelu MLPs and
rank-3 token linears:
  * FP32 and INT8 weight-only through the public API on the CPU, TORCH and
    KERNELS, against the JAX package's XLA backend one image at a time and
    (FP32) its interpreter, at rtol 1e-3 / atol 1e-5; infer_batch at 2;
  * the numpy interpreter bit for bit; the INT8 weight codes and scales;
  * INT8-FULL: the same activation scales and the logits bit for bit with
    XLA's fused multiply-add epilogue and erfc (tests/torch_port_families.py);
  * INT8 weight-only and INT8-FULL keep FP32's top-1 (tests/test_vit.py:62);
  * batched attention: infer_batch at 3 (tests/test_vit.py:81), baked at
    B = 3 (the head split's Reshape targets patched);
  * INT8-FULL's int8 storage reaches the rank-3 token linears
    (tests/test_quant_full.py:339);
  * bfloat16 in the three modes with tests/test_torch_port_bf16.py's gate;
  * KERNELS: the 25 weight MatMuls take fused_gemm (the rank-3 ones with M
    = 64 tokens: the fuse pass's bias reaches the kernel as (N,), in both
    packages), where the JAX package's Pallas backend calls it; the
    attention MatMuls and rank-4 SoftMax stay off the kernels; under
    INT8-FULL the 8×8/s8 patch embedding takes int8 × int8 fused_gemm."""

import numpy as np
import pytest

from pyopenvino_tpu.config import Config as JaxConfig

from pyopenvino_tpu_torch.config import QuantMode
from pyopenvino_tpu_torch.models import vit_tiny
from torch_port_families import (
    QUANTS, Family, FamilyBf16Case, Int8FullCase, check_bf16, check_kernel_launches, images,
)
from test_torch_port_int8full import BACKEND_PAIRS
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


@pytest.fixture(scope="module")
def family():
    return Family(vit_tiny.vit_tiny_paths(), images((1, 3, 64, 64), 2, 7))


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT], ids=lambda q: q.value)
@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
def test_matches_jax(family, quant, kernel_type):
    _, batch = family.check_matches_jax(quant, kernel_type)
    assert batch.shape == (2, 100)
    for g, w in zip(batch, family.want[quant]):
        assert list(np.argsort(g)[::-1][:3]) == list(np.argsort(w)[::-1][:3])


def test_interpreter_and_codes_match_jax(family):
    family.check_interpreter()
    assert family.check_int8_weight_codes() == 26  # the patch embedding, 25 weight MatMuls


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_int8full_matches_jax(backend, jax_backend, monkeypatch):
    net = Int8FullCase(vit_tiny.vit_tiny_paths(), seed=3).check(backend, jax_backend,
                                                                 monkeypatch)
    assert len(net.act_scales) == 34  # the patch embedding and every MatMul


def test_int8_modes_preserve_ranking(family):
    agree = family.int8_agreement()
    assert all(a == 1.0 for a in agree.values()), agree


def test_batched_attention(family):
    """infer_batch runs the graph baked at B = 3: the rank-4 attention
    MatMuls and the axis-3 SoftMax carry the batch; rows 0 and 2 (one
    image twice) equal the single request, row 1 (another) does not, and
    the rows equal the JAX package's vmapped infer_batch."""
    from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

    exe = family.exe(QuantMode.NONE, "torch")
    blob = family.blobs[:1]
    other = images(blob.shape, 1, 3)
    batch = np.concatenate([blob, other, blob])
    ref = exe.infer({family.input: blob})[family.out]
    out = exe.infer_batch({family.input: batch})[family.out]
    assert out.shape == (3, 100)
    assert exe.compiled()._batched_plan(3) is not None
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out[2], ref[0], rtol=1e-4, atol=1e-6)
    assert not np.allclose(out[1], ref[0], atol=1e-3)
    want = jax_compile(family.jax_model, JaxConfig()).infer_batch({family.input: batch})
    np.testing.assert_allclose(out, want[family.out], rtol=1e-3, atol=1e-5)


def test_int8_dataflow_covers_rank3_matmuls(family):
    """INT8-FULL on TORCH stores int8 codes on the edges into the rank-3
    token linears, as the JAX package's XLA dataflow does, and keeps
    FP32's top-1 (tests/test_quant_full.py:339)."""
    blob = images((1, 3, 64, 64), 1, 0)
    exe = family.exe(QuantMode.INT8_FULL, "torch", [{family.input: blob}])
    c = exe.compiled()
    rank3 = sum(1 for (src, sport), _s in c._int8_edges.items()
                for p, dst, dport in c.model.out_edges[src]
                if p == sport and c.model.nodes[dst].op_type == "MatMul"
                and len(c.model.nodes[dst].inputs[0].shape) == 3)
    assert rank3 >= 4, rank3
    ref = family.exe(QuantMode.NONE, "torch").infer({family.input: blob})[family.out]
    out = exe.infer({family.input: blob})[family.out]
    assert np.argmax(out) == np.argmax(ref)
    assert np.abs(out - ref).max() < 0.05


@pytest.fixture(scope="module")
def bf16_case():
    return FamilyBf16Case(vit_tiny.vit_tiny_paths(), seed=3)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_bf16_matches_jax(bf16_case, backend, jax_backend, quant):
    """MVN's sums and Gelu in bfloat16: XLA keeps float32 between the ops
    of a fusion where the port rounds each (ROADMAP.md §3, fault 5), so the
    relative gate holds; with XLA's excess precision off the distance falls
    to 0–0.47 of JAX's own bf16-vs-f32 one."""
    check_bf16(bf16_case, backend, jax_backend, quant)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_kernel_launches(family, quant, monkeypatch):
    table = check_kernel_launches(family, quant, monkeypatch)
    name = {QuantMode.NONE: "fused_gemm", QuantMode.INT8_WEIGHT: "fused_gemm_i8w",
            QuantMode.INT8_FULL: "fused_gemm_i8i8"}[quant]
    assert set(table) == {name}
    tokens = [(m, k, n, c) for m, k, n, c in table[name] if m == 64]
    assert sum(c for *_, c in tokens) == 24 + (quant == QuantMode.INT8_FULL)
    assert (1, 128, 100, 1) in table[name]
