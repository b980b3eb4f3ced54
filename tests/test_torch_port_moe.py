"""MoE-MLP (the port's ``models/moe_mlp.xml`` with the weights
``models/moe_mlp.py`` replays, byte for byte those of ``tools/gen_moe.py``)
on the port against the JAX package: rank-3 (E, K, N) expert Consts in
batched MatMuls, Tile, a gate-weighted ReduceSum over the experts, Gelu
and 2-D router SoftMaxes:
  * FP32 and INT8 weight-only through the public API on the CPU, TORCH and
    KERNELS, against the JAX package's XLA backend one image at a time and
    (FP32) its interpreter, at rtol 1e-3 / atol 1e-5; infer_batch at 2;
  * the numpy interpreter bit for bit; the INT8 weight codes and scales
    (an (E, K, N) expert Const's per-N scale has one non-unit axis);
  * INT8-FULL: the same activation scales and the logits bit for bit with
    XLA's fused multiply-add epilogue and erfc (tests/torch_port_families.py);
    the expert MatMuls' exact int32 sums off the kernels in both packages;
  * infer_batch: the gate's Reshape (1, E) → (E, 1, 1) names the batch-1
    extent, so the graph cannot be baked at B > 1 and runs one example at a
    time, which equals the JAX package's vmapped infer_batch;
  * INT8-FULL's int8 storage reaches the rank-3 expert MatMuls
    (tests/test_quant_full.py:339);
  * bfloat16 in the three modes against the JAX package with XLA's excess
    precision off (a subprocess), with tests/test_torch_port_bf16.py's gate;
  * KERNELS: the routers (N = 8) and the head (N = 100) take fused_gemm
    where the JAX package's Pallas backend calls it, three softmax_rows
    a forward."""

import os
import subprocess
import sys

import numpy as np
import pytest

from pyopenvino_tpu.config import Config as JaxConfig

from pyopenvino_tpu_torch.config import QuantMode
from pyopenvino_tpu_torch.models import moe_mlp
from torch_port_families import (
    QUANTS, Family, FamilyBf16Case, Int8FullCase, check_bf16, check_kernel_launches, images,
)
from test_torch_port_int8full import BACKEND_PAIRS
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


@pytest.fixture(scope="module")
def family():
    return Family(moe_mlp.moe_mlp_paths(), images((1, 3, 32, 32), 2, 7))


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT], ids=lambda q: q.value)
@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
def test_matches_jax(family, quant, kernel_type):
    _, batch = family.check_matches_jax(quant, kernel_type)
    assert batch.shape == (2, 100)
    assert (batch.argmax(1) == family.want[quant].argmax(1)).all()


def test_interpreter_and_codes_match_jax(family):
    family.check_interpreter()
    assert family.check_int8_weight_codes() == 9  # 2 convs, 2 routers, 4 expert stacks, the head
    scale = family.exe(QuantMode.INT8_WEIGHT, "torch").compiled().weights
    stacks = [v for k, v in scale.items() if k.endswith(".scale") and v.dim() == 3]
    assert sorted(tuple(v.shape) for v in stacks) == [(1, 1, 64)] * 2 + [(1, 1, 128)] * 2


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_int8full_matches_jax(backend, jax_backend, monkeypatch):
    net = Int8FullCase(moe_mlp.moe_mlp_paths(), seed=3).check(backend, jax_backend,
                                                               monkeypatch)
    assert len(net.act_scales) == 9  # 2 convs and 7 MatMuls


def test_int8_modes_preserve_ranking(family):
    agree = family.int8_agreement()
    assert all(a == 1.0 for a in agree.values()), agree


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_infer_batch_runs_per_example(family, quant):
    """The batch cannot be baked (the gate's Reshape target names the
    batch-1 extent), so infer_batch runs the declared graph once per
    example: the rows equal single requests bit for bit, and the JAX
    package's vmapped infer_batch at rtol 1e-3."""
    from pyopenvino_tpu.config import QuantMode as JaxQuantMode
    from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

    cal = [{family.input: family.blobs[:1]}] if quant == QuantMode.INT8_FULL else None
    exe = family.exe(quant, "kernels", cal)
    batch = images((1, 3, 32, 32), 3, 5)
    out = exe.infer_batch({family.input: batch})[family.out]
    assert exe.compiled()._batched_plan(3) is None
    assert out.shape == (3, 100)
    for i in range(3):
        np.testing.assert_array_equal(out[i], exe.infer({family.input: batch[i:i + 1]})[
            family.out][0])
    want = jax_compile(family.jax_model, JaxConfig(quant=JaxQuantMode(quant.value)),
                       calibration_samples=cal).infer_batch({family.input: batch})[family.out]
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-5)


def test_int8_dataflow_covers_batched_matmul(family):
    """INT8-FULL on TORCH stores int8 codes on the edges into the rank-3
    expert MatMuls (the Tile's output, Gelu's), as the JAX package's XLA
    dataflow does, and keeps FP32's top-1 (tests/test_quant_full.py:339)."""
    blob = images((1, 3, 32, 32), 1, 0)
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
    return FamilyBf16Case(moe_mlp.moe_mlp_paths(), seed=3)


@pytest.fixture(scope="module")
def jax_bf16_exact(tmp_path_factory):
    """The JAX package's bfloat16 logits of the six (backend, quant) pairs
    with XLA's excess precision off, computed in a subprocess (XLA reads
    the flag when its CPU backend starts)."""
    out = tmp_path_factory.mktemp("moe_bf16") / "logits.npz"
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from pyopenvino_tpu.config import Backend as JaxBackend\n"
        "from pyopenvino_tpu_torch.models import moe_mlp\n"
        "from torch_port_families import QUANTS, FamilyBf16Case\n"
        "case = FamilyBf16Case(moe_mlp.moe_mlp_paths(), seed=3)\n"
        "np.savez(sys.argv[1], **{f'{be.value}-{q.value}': case.jax(be, q, 'bfloat16')\n"
        "         for be in (JaxBackend.XLA, JaxBackend.PALLAS) for q in QUANTS})\n")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join([tests, os.path.dirname(tests),
                                          os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-c", script, str(out)], env=env, check=True, timeout=900)
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_bf16_matches_jax(bf16_case, jax_bf16_exact, backend, jax_backend, quant):
    """A shallow network: XLA's excess precision in bfloat16 (ROADMAP.md
    §3, fault 5: float32 kept between Gelu's, the gate's and the router's
    ops) moves the default JAX logits as far as bfloat16 itself does (INT8W
    TORCH 0.86 of JAX's own bf16-vs-f32 distance), so the port is held
    against JAX with the excess precision off (equal here, printed)."""
    got, want = check_bf16(bf16_case, backend, jax_backend, quant,
                           want=jax_bf16_exact[f"{jax_backend.value}-{quant.value}"])
    default = bf16_case.jax(jax_backend, quant, "bfloat16")
    print(f"default JAX bf16 (excess precision on) vs port: max "
          f"{np.abs(got - default).max() / np.abs(default).max():.3e}")


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_kernel_launches(family, quant, monkeypatch):
    import chip_smoke

    table = check_kernel_launches(family, quant, monkeypatch)
    name = {QuantMode.NONE: "fused_gemm", QuantMode.INT8_WEIGHT: "fused_gemm_i8w",
            QuantMode.INT8_FULL: "fused_gemm_i8i8"}[quant]
    assert [r for r in table[name] if r[0] == 1] == [(1, 64, 8, 2), (1, 64, 100, 1)]
    exe = family.exe(quant, "kernels")
    if quant != QuantMode.INT8_FULL:
        assert chip_smoke.softmax_rows_of(exe.compiled()) == [8, 8, 100]
