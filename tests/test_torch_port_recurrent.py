"""Slice 19's recurrent ops in the port against the JAX package: LSTMCell,
GRUCell (``linear_before_reset`` 0 and 1), RNNCell, LSTMSequence (forward,
reverse and bidirectional, unequal ``sequence_lengths``, ``clip``, an INT8
weight) and GRUSequence:

  * the port's ``emit`` against the JAX package's ``emit`` on the CPU and
    against its own numpy ``ref_compute``, float32 at rtol 1e-5, and the
    port's ``ref_compute`` equal to the JAX package's bit for bit; the
    masked tail of Y exactly 0;
  * tests/test_recurrent.py's checks through the port (a graph built with
    the JAX package's GraphBuilder, written as IR and parsed by the port,
    run by the port's compiled network on the CPU and by its interpreter):
    each cell and sequence against ``torch.nn``'s at rtol 1e-4 / atol 1e-5,
    with the gate-order translation (PyTorch orders LSTM gates i, f, g, o
    and GRU gates r, z, n; OpenVINO f, i, c, o and z, r, h), so that an
    exact match is the proof of the gate order; the masking and reverse
    direction against a shorter run of the same weights.

Inputs are made with numpy from a seed and handed to both packages."""

import functools
import types

import numpy as np
import pytest
import torch

from pyopenvino_tpu.ir.builder import GraphBuilder
from pyopenvino_tpu.ir.writer import serialize_ir
from pyopenvino_tpu.ops import get_op as jax_get_op
from pyopenvino_tpu.ops.spec import TValue as JaxTValue
from pyopenvino_tpu.runtime.compiler import EmitCtx as JaxEmitCtx

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch.ir import parse_ir
from pyopenvino_tpu_torch.ops import get_op, supported_ops
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.runtime.compiler import EmitCtx, compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
from test_torch_port_extended_ops import RTOL, _rel_err
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

import pyopenvino_tpu.ir.model as jax_ir

NEW_OPS = ("LSTMCell", "GRUCell", "RNNCell", "LSTMSequence", "GRUSequence")
TORCH_RTOL, TORCH_ATOL = 1e-4, 1e-5  # tests/test_recurrent.py's


def _ctxs():
    """(port ctx, JAX ctx) with each package's own ``weight_for``."""
    import jax.numpy as jnp

    jax_ctx = types.SimpleNamespace(compute_dtype=jnp.float32)
    jax_ctx.weight_for = functools.partial(JaxEmitCtx.weight_for, jax_ctx)
    port = types.SimpleNamespace(compute_dtype=torch.float32, weight_for=EmitCtx.weight_for)
    return port, jax_ctx


def _run_both(op_type, attrs, ins, outputs, qscales=None):
    """{port: (port emit, JAX emit, port ref_compute, JAX ref_compute)} for
    a node with ``outputs`` ports on the inputs ``ins`` ({port: ndarray});
    ``qscales``: {port: per-row scale} of int8 weight inputs (the
    interpreters read those weights dequantized)."""
    import jax.numpy as jnp

    qscales = qscales or {}
    kw = dict(id=0, name="n", op_type=op_type, attrs=attrs, inputs={},
              outputs={p: None for p in outputs})
    node, jnode = port_ir.Node(**kw), jax_ir.Node(**kw)
    pctx, jctx = _ctxs()
    pins = {p: TValue(torch.from_numpy(v), qscale=None if p not in qscales
                      else torch.from_numpy(qscales[p])) for p, v in ins.items()}
    jins = {p: JaxTValue(jnp.asarray(v), "L", qscale=None if p not in qscales
                         else jnp.asarray(qscales[p])) for p, v in ins.items()}
    got = get_op(op_type).emit(pctx, node, pins)
    want = jax_get_op(op_type).emit(jctx, jnode, jins)
    ref_in = {p: v.astype(np.float32) * qscales[p] if p in qscales else v
              for p, v in ins.items()}
    ref = get_op(op_type).ref_compute(node, ref_in)
    jref = jax_get_op(op_type).ref_compute(jnode, ref_in)
    assert set(got) == set(want) == set(ref) == set(jref) == set(outputs)
    return {p: (got[p].arr.numpy(), np.asarray(want[p].nchw()), ref[p], jref[p]) for p in outputs}


def _check(results):
    for got, want, ref, jref in results.values():
        assert got.dtype == ref.dtype == np.float32 and got.shape == want.shape == ref.shape
        np.testing.assert_array_equal(ref, jref)
        assert _rel_err(got, want) <= RTOL
        assert _rel_err(got, ref) <= RTOL


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_slice_ops_are_registered():
    assert set(NEW_OPS) <= set(supported_ops())


# -- the cells ------------------------------------------------------------

@pytest.mark.parametrize("clip", [None, 0.5])
def test_lstm_cell_matches_jax(clip):
    rng = np.random.default_rng(0)
    B, I, H = 3, 5, 7
    ins = {0: _randn(rng, B, I), 1: _randn(rng, B, H), 2: _randn(rng, B, H),
           3: _randn(rng, 4 * H, I, scale=0.5), 4: _randn(rng, 4 * H, H, scale=0.5),
           5: _randn(rng, 4 * H, scale=0.1)}
    attrs = {"hidden_size": str(H)}
    if clip is not None:
        attrs["clip"] = str(clip)
    _check(_run_both("LSTMCell", attrs, ins, (6, 7)))


@pytest.mark.parametrize("lbr", [0, 1])
def test_gru_cell_matches_jax(lbr):
    rng = np.random.default_rng(1 + lbr)
    B, I, H = 2, 4, 6
    ins = {0: _randn(rng, B, I), 1: _randn(rng, B, H), 2: _randn(rng, 3 * H, I, scale=0.5),
           3: _randn(rng, 3 * H, H, scale=0.5), 4: _randn(rng, (3 + lbr) * H, scale=0.1)}
    _check(_run_both("GRUCell", {"hidden_size": str(H), "linear_before_reset": str(lbr)},
                     ins, (5,)))


@pytest.mark.parametrize("activation", [None, "relu"])
def test_rnn_cell_matches_jax(activation):
    rng = np.random.default_rng(3)
    B, I, H = 2, 5, 4
    ins = {0: _randn(rng, B, I), 1: _randn(rng, B, H), 2: _randn(rng, H, I, scale=0.5),
           3: _randn(rng, H, H, scale=0.5), 4: _randn(rng, H, scale=0.1)}
    attrs = {"hidden_size": str(H)}
    if activation is not None:
        attrs["activations"] = activation
    _check(_run_both("RNNCell", attrs, ins, (5,)))


def test_bad_activation_and_direction_refused():
    rng = np.random.default_rng(4)
    ins = {0: _randn(rng, 1, 2), 1: _randn(rng, 1, 2), 2: _randn(rng, 2, 2),
           3: _randn(rng, 2, 2), 4: _randn(rng, 2)}
    node = port_ir.Node(id=0, name="n", op_type="RNNCell", inputs={}, outputs={5: None},
                        attrs={"hidden_size": "2", "activations": "elu"})
    with pytest.raises(ValueError, match="unsupported recurrent activation"):
        get_op("RNNCell").ref_compute(node, ins)
    node.attrs["activations"] = "tanh,tanh"
    with pytest.raises(ValueError, match="expected 1 activations"):
        get_op("RNNCell").ref_compute(node, ins)
    seq = port_ir.Node(id=0, name="s", op_type="GRUSequence", inputs={}, outputs={6: None},
                       attrs={"hidden_size": "2", "direction": "sideways"})
    with pytest.raises(ValueError, match="bad direction"):
        get_op("GRUSequence").infer_shapes(seq, {0: (1, 3, 2)}, {})


# -- the sequences --------------------------------------------------------

def _seq_inputs(rng, B, T, I, H, D, gates, n_state, lens):
    ins = {0: _randn(rng, B, T, I)}
    for k in range(n_state):
        ins[1 + k] = _randn(rng, B, D, H)
    ins[1 + n_state] = np.asarray(lens, np.int32)
    ins[2 + n_state] = _randn(rng, D, gates * H, I, scale=0.5)
    ins[3 + n_state] = _randn(rng, D, gates * H, H, scale=0.5)
    return ins


@pytest.mark.parametrize("clip", [None, 0.8])
@pytest.mark.parametrize("direction", ["forward", "reverse", "bidirectional"])
def test_lstm_sequence_matches_jax(direction, clip):
    """Unequal lengths (6, 4, 1 of T = 6): past a row's length Y is exactly
    0 and the final state is the last valid step's."""
    rng = np.random.default_rng(5)
    B, T, I, H = 3, 6, 5, 4
    D = 2 if direction == "bidirectional" else 1
    lens = [6, 4, 1]
    ins = _seq_inputs(rng, B, T, I, H, D, 4, 2, lens)
    ins[6] = _randn(rng, D, 4 * H, scale=0.1)
    attrs = {"hidden_size": str(H), "direction": direction}
    if clip is not None:
        attrs["clip"] = str(clip)
    res = _run_both("LSTMSequence", attrs, ins, (7, 8, 9))
    _check(res)
    y = res[7][0]
    assert y.shape == (B, D, T, H)
    for row, n in enumerate(lens):
        np.testing.assert_array_equal(y[row, :, n:], 0.0)
        assert (y[row, :, :n] != 0).all()
    # the final hidden state is Y at the last valid step (forward) or at
    # step 0 (the reverse direction ends there)
    for row, n in enumerate(lens):
        for di in range(D):
            last = 0 if di == 1 or direction == "reverse" else n - 1
            np.testing.assert_array_equal(res[8][0][row, di], y[row, di, last])


@pytest.mark.parametrize("lbr", [0, 1])
@pytest.mark.parametrize("direction", ["forward", "bidirectional"])
def test_gru_sequence_matches_jax(direction, lbr):
    rng = np.random.default_rng(6)
    B, T, I, H = 2, 5, 3, 6
    D = 2 if direction == "bidirectional" else 1
    ins = _seq_inputs(rng, B, T, I, H, D, 3, 1, [5, 3])
    ins[5] = _randn(rng, D, (3 + lbr) * H, scale=0.1)
    res = _run_both("GRUSequence", {"hidden_size": str(H), "direction": direction,
                                    "linear_before_reset": str(lbr)}, ins, (6, 7))
    _check(res)
    np.testing.assert_array_equal(res[6][0][1, :, 3:], 0.0)


def test_lstm_sequence_int8_weight_matches_jax():
    """An INT8 weight-only (D, 4H, I) stack with one scale per direction and
    output row, dequantized by each package's ``weight_for``."""
    rng = np.random.default_rng(7)
    B, T, I, H, D = 2, 4, 5, 4, 2
    ins = _seq_inputs(rng, B, T, I, H, D, 4, 2, [4, 2])
    ins[6] = _randn(rng, D, 4 * H, scale=0.1)
    qscales = {}
    for p in (4, 5):
        w = ins[p]
        qscales[p] = (np.abs(w).max(axis=2, keepdims=True) / 127.0).astype(np.float32)
        ins[p] = np.clip(np.round(w / qscales[p]), -127, 127).astype(np.int8)
    _check(_run_both("LSTMSequence", {"hidden_size": str(H), "direction": "bidirectional"},
                     ins, (7, 8, 9), qscales))


# -- tests/test_recurrent.py through the port --------------------------------

def _np(t):
    return t.detach().numpy().astype(np.float32)


def _port_model(builder):
    """The JAX GraphBuilder's graph as the port parses it from IR."""
    xml, blob = serialize_ir(builder.build())
    return parse_ir(xml.decode("utf-8"), blob, name="g")


def _both_runs(model, feeds):
    """The port's compiled network on the CPU and its interpreter."""
    return compile_model(model, device="cpu").infer(feeds), Interpreter(model).run(feeds)


def _lstm_weights_from_torch(w_ih, w_hh, b_ih, b_hh):
    """torch (i, f, g, o) chunks → OpenVINO fico W (4H, I), R (4H, H), B (4H)."""
    perm = [1, 0, 2, 3]

    def reorder(m):
        chunks = np.split(m, 4, axis=0)
        return np.concatenate([chunks[p] for p in perm], axis=0)

    return reorder(w_ih), reorder(w_hh), reorder(b_ih + b_hh)


def _gru_weights_from_torch(w_ih, w_hh, b_ih, b_hh):
    """torch (r, z, n) → OpenVINO zrh W, R and the linear_before_reset
    B (4H) = (bz, br, Wbh, Rbh)."""
    perm = [1, 0, 2]

    def reorder(m):
        ch = np.split(m, 3, axis=0)
        return np.concatenate([ch[p] for p in perm], axis=0)

    bi, bh = np.split(b_ih, 3), np.split(b_hh, 3)
    return reorder(w_ih), reorder(w_hh), np.concatenate(
        [bi[1] + bh[1], bi[0] + bh[0], bi[2], bh[2]])


def test_lstm_cell_matches_torch():
    torch.manual_seed(0)
    B, I, H = 3, 5, 7
    cell = torch.nn.LSTMCell(I, H)
    x, h0, c0 = torch.randn(B, I), torch.randn(B, H), torch.randn(B, H)
    h1, c1 = cell(x, (h0, c0))
    W, R, Bb = _lstm_weights_from_torch(_np(cell.weight_ih), _np(cell.weight_hh),
                                        _np(cell.bias_ih), _np(cell.bias_hh))
    b = GraphBuilder("lstm_cell")
    ho, co = b.lstm_cell(b.parameter("x", (B, I)), b.parameter("h", (B, H)),
                         b.parameter("c", (B, H)), b.const(W), b.const(R), b.const(Bb), H)
    b.result(ho, name="h")
    b.result(co, name="c")
    for out in _both_runs(_port_model(b), {"x": _np(x), "h": _np(h0), "c": _np(c0)}):
        np.testing.assert_allclose(out["h"], _np(h1), rtol=TORCH_RTOL, atol=TORCH_ATOL)
        np.testing.assert_allclose(out["c"], _np(c1), rtol=TORCH_RTOL, atol=TORCH_ATOL)


def test_gru_cell_matches_torch_linear_before_reset():
    """torch.nn.GRUCell applies the reset after the hidden linear: OpenVINO's
    linear_before_reset = 1 form."""
    torch.manual_seed(1)
    B, I, H = 2, 4, 6
    cell = torch.nn.GRUCell(I, H)
    x, h0 = torch.randn(B, I), torch.randn(B, H)
    h1 = cell(x, h0)
    W, R, Bb = _gru_weights_from_torch(_np(cell.weight_ih), _np(cell.weight_hh),
                                       _np(cell.bias_ih), _np(cell.bias_hh))
    b = GraphBuilder("gru_cell")
    b.result(b.gru_cell(b.parameter("x", (B, I)), b.parameter("h", (B, H)), b.const(W),
                        b.const(R), b.const(Bb), H, linear_before_reset=1), name="h")
    for out in _both_runs(_port_model(b), {"x": _np(x), "h": _np(h0)}):
        np.testing.assert_allclose(out["h"], _np(h1), rtol=TORCH_RTOL, atol=TORCH_ATOL)


def test_gru_cell_plain_reset_formula():
    """linear_before_reset = 0: candidate = tanh(xp_h + (r∘h)·Rhᵀ + bh),
    against the formula written out in numpy."""
    rng = np.random.default_rng(2)
    B, I, H = 2, 3, 4
    x, h = _randn(rng, B, I), _randn(rng, B, H)
    W, R = _randn(rng, 3 * H, I, scale=0.3), _randn(rng, 3 * H, H, scale=0.3)
    Bb = _randn(rng, 3 * H, scale=0.1)

    def sig(v):
        return 1 / (1 + np.exp(-v))

    xp, hp = x @ W.T, h @ R[:2 * H].T
    z = sig(xp[:, :H] + hp[:, :H] + Bb[:H])
    r = sig(xp[:, H:2 * H] + hp[:, H:2 * H] + Bb[H:2 * H])
    cand = np.tanh(xp[:, 2 * H:] + (r * h) @ R[2 * H:].T + Bb[2 * H:])
    want = (1 - z) * cand + z * h
    b = GraphBuilder("gru_plain")
    b.result(b.gru_cell(b.parameter("x", (B, I)), b.parameter("h", (B, H)), b.const(W),
                        b.const(R), b.const(Bb), H), name="h")
    for out in _both_runs(_port_model(b), {"x": x, "h": h}):
        np.testing.assert_allclose(out["h"], want, rtol=TORCH_RTOL, atol=TORCH_ATOL)


def test_rnn_cell_matches_torch():
    torch.manual_seed(3)
    B, I, H = 2, 5, 4
    cell = torch.nn.RNNCell(I, H)
    x, h0 = torch.randn(B, I), torch.randn(B, H)
    h1 = cell(x, h0)
    b = GraphBuilder("rnn_cell")
    b.result(b.rnn_cell(b.parameter("x", (B, I)), b.parameter("h", (B, H)),
                        b.const(_np(cell.weight_ih)), b.const(_np(cell.weight_hh)),
                        b.const(_np(cell.bias_ih) + _np(cell.bias_hh)), H), name="h")
    for out in _both_runs(_port_model(b), {"x": _np(x), "h": _np(h0)}):
        np.testing.assert_allclose(out["h"], _np(h1), rtol=TORCH_RTOL, atol=TORCH_ATOL)


def _lstm_seq_model(B, T, I, H, D, W, R, Bb, direction):
    b = GraphBuilder("lstm_seq")
    y, ho, co = b.lstm_sequence(
        b.parameter("x", (B, T, I)), b.parameter("h", (B, D, H)), b.parameter("c", (B, D, H)),
        b.parameter("lens", (B,), dtype=np.int32), b.const(W), b.const(R), b.const(Bb), H,
        direction=direction)
    b.result(y, name="y")
    b.result(ho, name="ho")
    b.result(co, name="co")
    return _port_model(b)


@pytest.mark.parametrize("direction", ["forward", "bidirectional"])
def test_lstm_sequence_matches_torch(direction):
    torch.manual_seed(4)
    B, T, I, H = 2, 5, 3, 4
    D = 2 if direction == "bidirectional" else 1
    m = torch.nn.LSTM(I, H, batch_first=True, bidirectional=direction == "bidirectional")
    x, h0, c0 = torch.randn(B, T, I), torch.randn(D, B, H), torch.randn(D, B, H)
    y, (hn, cn) = m(x, (h0, c0))
    stacks = [_lstm_weights_from_torch(*(_np(getattr(m, f"{k}_l0{sfx}")) for k in (
        "weight_ih", "weight_hh", "bias_ih", "bias_hh"))) for sfx in ("", "_reverse")[:D]]
    model = _lstm_seq_model(B, T, I, H, D, *(np.stack(s) for s in zip(*stacks)), direction)
    feeds = {"x": _np(x), "h": _np(h0).transpose(1, 0, 2), "c": _np(c0).transpose(1, 0, 2),
             "lens": np.full(B, T, np.int32)}
    # torch's y is (B, T, D·H) with the directions side by side; ours (B, D, T, H)
    want_y = _np(y).reshape(B, T, D, H).transpose(0, 2, 1, 3)
    for out in _both_runs(model, feeds):
        np.testing.assert_allclose(out["y"], want_y, rtol=TORCH_RTOL, atol=TORCH_ATOL)
        np.testing.assert_allclose(out["ho"], _np(hn).transpose(1, 0, 2), rtol=TORCH_RTOL,
                                   atol=TORCH_ATOL)
        np.testing.assert_allclose(out["co"], _np(cn).transpose(1, 0, 2), rtol=TORCH_RTOL,
                                   atol=TORCH_ATOL)


@pytest.mark.parametrize("direction", ["forward", "reverse"])
def test_lstm_sequence_masking_and_reverse(direction):
    """Rows shorter than T: Y zero past the length, the final state the last
    valid step's; the reverse direction is the forward one over the
    reversed valid prefix.  Checked against a shorter run of the same
    weights."""
    rng = np.random.default_rng(5)
    B, T, I, H = 2, 6, 3, 4
    W, R = _randn(rng, 1, 4 * H, I, scale=0.4), _randn(rng, 1, 4 * H, H, scale=0.4)
    Bb = _randn(rng, 1, 4 * H, scale=0.1)
    x = _randn(rng, B, T, I)
    h0 = c0 = np.zeros((B, 1, H), np.float32)
    lens = np.array([4, 6], np.int32)
    out, it_out = _both_runs(_lstm_seq_model(B, T, I, H, 1, W, R, Bb, direction),
                             {"x": x, "h": h0, "c": c0, "lens": lens})
    np.testing.assert_allclose(out["y"], it_out["y"], rtol=TORCH_RTOL, atol=TORCH_ATOL)
    np.testing.assert_array_equal(out["y"][0, 0, 4:], 0.0)
    out4 = compile_model(_lstm_seq_model(1, 4, I, H, 1, W, R, Bb, direction), device="cpu").infer(
        {"x": x[:1, :4], "h": h0[:1], "c": c0[:1], "lens": np.array([4], np.int32)})
    np.testing.assert_allclose(out["y"][0, 0, :4], out4["y"][0, 0], rtol=TORCH_RTOL,
                               atol=TORCH_ATOL)
    np.testing.assert_allclose(out["ho"][0], out4["ho"][0], rtol=TORCH_RTOL, atol=TORCH_ATOL)


def test_gru_sequence_matches_torch():
    torch.manual_seed(6)
    B, T, I, H = 2, 4, 3, 5
    m = torch.nn.GRU(I, H, batch_first=True)
    x, h0 = torch.randn(B, T, I), torch.randn(1, B, H)
    y, hn = m(x, h0)
    W, R, Bb = _gru_weights_from_torch(_np(m.weight_ih_l0), _np(m.weight_hh_l0),
                                       _np(m.bias_ih_l0), _np(m.bias_hh_l0))
    b = GraphBuilder("gru_seq")
    yv, ho = b.gru_sequence(b.parameter("x", (B, T, I)), b.parameter("h", (B, 1, H)),
                            b.parameter("lens", (B,), dtype=np.int32), b.const(W[None]),
                            b.const(R[None]), b.const(Bb[None]), H, linear_before_reset=1)
    b.result(yv, name="y")
    b.result(ho, name="ho")
    feeds = {"x": _np(x), "h": _np(h0).transpose(1, 0, 2), "lens": np.full(B, T, np.int32)}
    for out in _both_runs(_port_model(b), feeds):
        np.testing.assert_allclose(out["y"][:, 0], _np(y), rtol=TORCH_RTOL, atol=TORCH_ATOL)
        np.testing.assert_allclose(out["ho"][:, 0], _np(hn)[0], rtol=TORCH_RTOL,
                                   atol=TORCH_ATOL)
