"""Recurrent ops: LSTMCell, GRUCell, RNNCell, LSTMSequence and GRUSequence.

Counterpart of ``pyopenvino_tpu/ops/recurrent.py``, in the OpenVINO opset
semantics:

  * LSTMCell (opset4): gate order **fico** (forget, input, candidate,
    output), W (4H, I), R (4H, H), B (4H); outputs Ho, Co;
  * GRUCell (opset3): gate order **zrh**; ``linear_before_reset`` takes the
    candidate as g(Xt·Whᵀ + rt∘(Ht·Rhᵀ + Rbh) + Wbh) with B (4H) = (bz, br,
    Wbh, Rbh), the plain form as g(Xt·Whᵀ + (rt∘Ht)·Rhᵀ + bh), B (3H);
  * RNNCell (opset3): Ht = g(Xt·Wᵀ + Ht·Rᵀ + B);
  * LSTMSequence and GRUSequence (opset5), batch first: X (B, T, I), states
    (B, D, H), sequence_lengths (B,), W (D, GH, I), R (D, GH, H), B (D, GH);
    direction forward, reverse or bidirectional; Y (B, D, T, H) and the
    final state(s) (B, D, H).  Past a row's sequence length Y is zero and
    the state holds its last valid value.

One set of step functions serves both twins: on numpy arrays they are the
JAX package's numpy code (``ref_compute``, the interpreter's), on tensors
the port's ``emit``.  A sequence hoists the input projection of all T steps
into one matmul a direction, as the JAX package does outside its
``lax.scan``; the time loop is a Python loop over T that runs one (B, H) ×
(H, GH) product and the gate math a step, and masks each row past its
length with ``torch.where``.  The JAX package computes these products with
``jnp`` matmuls outside any Pallas kernel, so no kernel of the port runs
here: each product sums in float32 and rounds once to the compute dtype,
as ``ops/matmul.py``'s ``torch.matmul`` route does (TF32 off under FP32,
runtime/compiler.py).  ``clip`` (when set) bounds the gate pre-activations.

Weights resolve through ``ctx.weight_for`` from the first weight port on,
so an INT8 weight-only (D, GH, I) stack is dequantized on every call
(passes/quantize.py quantizes it per direction and output row).  No port
takes an int8-stored activation: under INT8-FULL the compiler dequantizes
one reaching these ops.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.elementwise import sigmoid
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


def _act(name: str):
    """Activation by opset name, on numpy arrays and tensors."""
    if name not in ("sigmoid", "tanh", "relu"):
        raise ValueError(f"unsupported recurrent activation {name!r}")

    def fn(x):
        if isinstance(x, np.ndarray):
            if name == "sigmoid":
                return 1.0 / (1.0 + np.exp(-x))
            if name == "tanh":
                return np.tanh(x)
            return np.maximum(x, 0.0)
        return {"sigmoid": sigmoid, "tanh": torch.tanh, "relu": torch.relu}[name](x)

    return fn


def _activations(node, defaults):
    names = [s.strip() for s in node.attrs.get("activations", "").split(",") if s.strip()]
    if not names:
        names = list(defaults)
    if len(names) != len(defaults):
        raise ValueError(f"{node.op_type}: expected {len(defaults)} activations, got {names}")
    return [_act(n) for n in names]


def _clipper(node):
    clip = float(node.attrs.get("clip", 0) or 0)
    if clip <= 0:
        return lambda x: x

    def fn(x):
        if isinstance(x, np.ndarray):
            return np.clip(x, -clip, clip)
        return torch.clamp(x, -clip, clip)

    return fn


def _hidden(node) -> int:
    return A.get_int(node.attrs, "hidden_size")


def _mm(a, b_t):
    """a @ b_tᵀ (weights are stored gate-major, (GH, I)).  On tensors the
    operands are widened and summed in float32, then rounded once to a's
    dtype (XLA's bfloat16 dot on the CPU)."""
    if isinstance(a, np.ndarray):
        return a @ b_t.swapaxes(-1, -2)
    return a.float().matmul(b_t.float().transpose(-1, -2)).to(a.dtype)


def _where(cond, a, b):
    return np.where(cond, a, b) if isinstance(a, np.ndarray) else torch.where(cond, a, b)


def _stack(xs, axis):
    return np.stack(xs, axis=axis) if isinstance(xs[0], np.ndarray) else torch.stack(xs, dim=axis)


# -- step functions -----------------------------------------------------------
# Each takes the PRE-PROJECTED input xp = x·Wᵀ, so the sequence ops hoist the
# projection of all steps into one product; the cells project inline.


def _lstm_step(xp, h, c, r, b, acts, clip):
    """One fico LSTM step on projected input; returns (h', c')."""
    f_, g_, h_ = acts
    gates = clip(xp + _mm(h, r) + b)
    H = h.shape[-1]
    f = f_(gates[..., 0 * H:1 * H])
    i = f_(gates[..., 1 * H:2 * H])
    cand = g_(gates[..., 2 * H:3 * H])
    o = f_(gates[..., 3 * H:4 * H])
    c_new = f * c + i * cand
    return o * h_(c_new), c_new


def _gru_step(xp, h, r, b, acts, clip, linear_before_reset):
    """One zrh GRU step on projected input; returns h'."""
    f_, g_ = acts
    H = h.shape[-1]
    if linear_before_reset:
        # B = (bz, br, Wbh, Rbh): the reset applies after the hidden linear
        hp = _mm(h, r)
        z = f_(clip(xp[..., :H] + hp[..., :H] + b[..., :H]))
        rt = f_(clip(xp[..., H:2 * H] + hp[..., H:2 * H] + b[..., H:2 * H]))
        cand = g_(clip(xp[..., 2 * H:3 * H]
                       + rt * (hp[..., 2 * H:3 * H] + b[..., 3 * H:4 * H])
                       + b[..., 2 * H:3 * H]))
    else:
        hp = _mm(h, r[:2 * H, :])
        z = f_(clip(xp[..., :H] + hp[..., :H] + b[..., :H]))
        rt = f_(clip(xp[..., H:2 * H] + hp[..., H:2 * H] + b[..., H:2 * H]))
        cand = g_(clip(xp[..., 2 * H:3 * H] + _mm(rt * h, r[2 * H:3 * H, :])
                       + b[..., 2 * H:3 * H]))
    return (1.0 - z) * cand + z * h


def _out_ports(node, n):
    """Declared output port ids (a parsed IR), else consecutive ones from
    the first (the JAX package's convention, shared with Split)."""
    ports = sorted(node.outputs)
    if len(ports) == n:
        return ports
    return [node.out_port + i for i in range(n)]


class _Recurrent(Op):
    """Shared plumbing: ``_compute(node, ins)`` on numpy arrays for
    ``ref_compute`` (results in the dtype of input 1, the state) and on
    tensors for ``emit``, whose inputs from ``first_weight_port`` on go
    through ``ctx.weight_for``."""

    first_weight_port = 0

    def _compute(self, node, ins):
        raise NotImplementedError

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        return {k: np.asarray(v, dtype=inputs[1].dtype)
                for k, v in self._compute(node, inputs).items()}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        ins = {p: ctx.weight_for(node, tv) if p >= self.first_weight_port else tv.arr
               for p, tv in inputs.items()}
        return {p: TValue(v) for p, v in self._compute(node, ins).items()}


# -- single-step cells --------------------------------------------------------


@register
class LSTMCell(_Recurrent):
    type_name = "LSTMCell"
    first_weight_port = 3  # X, H, C | W, R, B

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        ports = _out_ports(node, 2)
        return ShapeResult({ports[0]: tuple(in_shapes[1]), ports[1]: tuple(in_shapes[1])})

    def _compute(self, node, ins):
        acts = _activations(node, ("sigmoid", "tanh", "tanh"))
        h, c = _lstm_step(_mm(ins[0], ins[3]), ins[1], ins[2], ins[4], ins[5],
                          acts, _clipper(node))
        p = _out_ports(node, 2)
        return {p[0]: h, p[1]: c}


@register
class GRUCell(_Recurrent):
    type_name = "GRUCell"
    first_weight_port = 2  # X, H | W, R, B

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: tuple(in_shapes[1])})

    def _compute(self, node, ins):
        acts = _activations(node, ("sigmoid", "tanh"))
        lbr = A.get_bool(node.attrs, "linear_before_reset", False)
        h = _gru_step(_mm(ins[0], ins[2]), ins[1], ins[3], ins[4], acts, _clipper(node), lbr)
        return {node.out_port: h}


@register
class RNNCell(_Recurrent):
    type_name = "RNNCell"
    first_weight_port = 2  # X, H | W, R, B

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: tuple(in_shapes[1])})

    def _compute(self, node, ins):
        (g,) = _activations(node, ("tanh",))
        clip = _clipper(node)
        return {node.out_port: g(clip(_mm(ins[0], ins[2]) + _mm(ins[1], ins[3]) + ins[4]))}


# -- sequences ----------------------------------------------------------------


def _directions(node) -> int:
    d = node.attrs.get("direction", "forward")
    if d not in ("forward", "reverse", "bidirectional"):
        raise ValueError(f"{node.op_type}: bad direction {d!r}")
    return 2 if d == "bidirectional" else 1


def _reverse_valid(x, lens):
    """Reverse each row's valid prefix along the time axis (axis 1):
    out[i, t] = x[i, len_i-1-t] for t < len_i, x[i, t] past it."""
    T = x.shape[1]
    if isinstance(x, np.ndarray):
        t = np.arange(T)[None, :]
        ln = np.asarray(lens).reshape(-1, 1).astype(t.dtype)
        idx = np.where(t < ln, ln - 1 - t, t)
        return np.take_along_axis(x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), axis=1)
    t = torch.arange(T, device=x.device)[None, :]
    ln = lens.reshape(-1, 1).to(t.dtype)
    idx = torch.where(t < ln, ln - 1 - t, t)
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape))


def _scan_one_direction(step_fn, xproj, state, lens):
    """Run ``step_fn(xp_t, state) -> (state', y_t)`` over the projected input
    xproj (B, T, GH) with sequence-length masking; returns (final state,
    Y (B, T, H)).  One Python loop over T for both twins (the JAX package's
    numpy loop; its ``lax.scan`` computes the same steps)."""
    T = xproj.shape[1]
    if isinstance(xproj, np.ndarray):
        valid_all = np.arange(T)[None, :] < np.asarray(lens).reshape(-1, 1)
    else:
        valid_all = torch.arange(T, device=xproj.device)[None, :] < lens.reshape(-1, 1)
    ys = []
    for t in range(T):
        new_state, y = step_fn(xproj[:, t], state)
        valid = valid_all[:, t:t + 1]
        state = tuple(_where(valid, n, o) for n, o in zip(new_state, state))
        ys.append(_where(valid, y, 0.0))
    return state, _stack(ys, 1)


class _Sequence(_Recurrent):
    """Shared LSTM/GRU sequence machinery.  Input ports: 0 X, 1 … n_state
    the initial states, then sequence_lengths, W, R, B."""

    n_state = 0  # carried tensors (H[, C])

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        b, t, _ = in_shapes[0]
        h = _hidden(node)
        d = _directions(node)
        ports = _out_ports(node, 1 + self.n_state)
        out = {ports[0]: (b, d, t, h)}
        for k in range(self.n_state):
            out[ports[1 + k]] = (b, d, h)
        return ShapeResult(out)

    def _dir_step(self, node, r, b):
        """step(xp_t, state) -> (state', y_t) for one direction's R and B."""
        raise NotImplementedError

    def _compute(self, node, ins):
        d = _directions(node)
        reverse0 = node.attrs.get("direction", "forward") == "reverse"
        x = ins[0]
        lens = ins[1 + self.n_state]
        w_all, r_all, b_all = (ins[k + self.n_state] for k in (2, 3, 4))
        ys, finals = [], []
        for di in range(d):
            state = tuple(ins[1 + k][:, di] for k in range(self.n_state))
            rev = di == 1 or reverse0
            xd = _reverse_valid(x, lens) if rev else x
            # the hoisted projection: all T steps in one product
            xproj = _mm(xd, w_all[di])
            state, Y = _scan_one_direction(self._dir_step(node, r_all[di], b_all[di]),
                                           xproj, state, lens)
            if rev:
                Y = _reverse_valid(Y, lens)
            ys.append(Y)
            finals.append(state)
        ports = _out_ports(node, 1 + self.n_state)
        out = {ports[0]: _stack(ys, 1)}  # (B, D, T, H)
        for k in range(self.n_state):
            out[ports[1 + k]] = _stack([f[k] for f in finals], 1)
        return out


@register
class LSTMSequence(_Sequence):
    type_name = "LSTMSequence"
    n_state = 2
    first_weight_port = 4  # X, H, C, lengths | W, R, B

    def _dir_step(self, node, r, b):
        acts = _activations(node, ("sigmoid", "tanh", "tanh"))
        clip = _clipper(node)

        def step(xp_t, state):
            h2, c2 = _lstm_step(xp_t, *state, r, b, acts, clip)
            return (h2, c2), h2

        return step


@register
class GRUSequence(_Sequence):
    type_name = "GRUSequence"
    n_state = 1
    first_weight_port = 3  # X, H, lengths | W, R, B

    def _dir_step(self, node, r, b):
        acts = _activations(node, ("sigmoid", "tanh"))
        clip = _clipper(node)
        lbr = A.get_bool(node.attrs, "linear_before_reset", False)

        def step(xp_t, state):
            h2 = _gru_step(xp_t, state[0], r, b, acts, clip, lbr)
            return (h2,), h2

        return step
