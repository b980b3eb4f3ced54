"""Seeded weights and frames, made on the device.

The weight rule is models/synth.py's roles (He-normal conv and MatMul
weights, N(0, 0.02) biases, N(1, 0.02) Multiply scales, N(0, 0.05) other
floats, a Reshape target its consumer's declared shape), drawn in one call
of a ``torch.Generator`` on the device, and then batch norm folded in from
seeded frames, as a trained network's folded batch norm is: each conv's
output channels are brought to variance 1 over the fold frames and to mean
``ACT_MEAN`` where a ReLU or ReLU6 follows, else 0 (W / sigma, the drawn
bias + shift - mu / sigma), and the classifier's logits to mean 0 and
variance ``LOGIT_SCALE``² per class.

Why: with models/synth.py's weights as they are, ResNet-18 answers every
frame with one class at probability 1, so no comparison of answers could
tell a sound run from a broken one.  Centred pre-activations (mean 0) make
both networks lose a fifth of their signal to noise at every ReLU, so that
the two sides of the check, rounded a bit apart, answer apart; at mean 1
MobileNet-v2's answers in bfloat16 stay near its float32 ones.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.core import plain
from perfbench.core.ir import ELEMENT_TYPES, Graph

FOLD_FRAMES = 16
ACT_MEAN = 1.0
LOGIT_SCALE = 3.0

# purposes of the seeded streams drawn from one --seed
WEIGHTS, FOLD, CALIBRATION, TRAFFIC, SAMPLE = range(5)


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose, from any whole --seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), purpose]).generate_state(
        1, np.uint64)[0] >> 1)


def generator(seed: int, purpose: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g


def frames(graph: Graph, n: int, seed: int, purpose: int, device) -> torch.Tensor:
    """``n`` u8 frames of the network's input shape, uniform in [0, 256)."""
    shape = graph.of_type("Parameter")[0].out_shape[1:]
    return torch.randint(0, 256, (n, *shape), dtype=torch.uint8,
                         generator=generator(seed, purpose, device), device=device)


def _role(graph: Graph, const) -> tuple:
    """(mean, std) of a float Const by its first consumer."""
    shape = const.const_shape
    for dst, index in const.consumers:
        t = graph.layers[dst].type
        if t in ("Convolution", "GroupConvolution") and index == 1:
            return 0.0, float(np.sqrt(2.0 / max(int(np.prod(shape[-3:])), 1)))
        if t == "MatMul" and index == 1:
            return 0.0, float(np.sqrt(2.0 / max(shape[0], 1)))
        if t == "Multiply":
            return 1.0, 0.02
        if t == "Add":
            return 0.0, 0.02
    return 0.0, 0.05


def draw(graph: Graph, seed: int, device) -> Dict[int, torch.Tensor]:
    """{Const id: float32 tensor} of every float Const, before the fold."""
    floats = [c for c in graph.of_type("Const")
              if np.issubdtype(ELEMENT_TYPES[c.attrs["element_type"]], np.floating)]
    sizes = [int(np.prod(c.const_shape)) for c in floats]
    roles = torch.tensor([_role(graph, c) for c in floats], dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    z = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    z = z * roles[:, 1].repeat_interleave(counts) + roles[:, 0].repeat_interleave(counts)
    return {c.id: part.reshape(c.const_shape) for c, part in zip(floats, z.split(sizes))}


def fold(graph: Graph, consts: Dict[int, torch.Tensor], fold_frames: torch.Tensor,
         ops: Optional[plain.Ops] = None) -> None:
    """Fold batch norm into ``consts`` in place, from a float32 walk of
    ``fold_frames`` (module docstring); ``ops`` as ``plain.walk`` takes them."""
    def root(layer, x, w):
        bias, _, act = plain.epilogue(graph, layer)
        if bias is None:
            raise ValueError(f"{layer.name}: no bias to fold batch norm into")
        y = plain.root_float(layer, x, w)
        dims = (0, 2, 3) if y.dim() == 4 else (0,)
        mu, sigma = y.mean(dim=dims), y.std(dim=dims).clamp_min(1e-6)
        gain = LOGIT_SCALE / sigma if layer.type == "MatMul" else 1.0 / sigma
        shift = ACT_MEAN if act is not None and layer.type != "MatMul" else 0.0
        wid = layer.inputs[1][0]
        axes = plain.channel_axes(layer, w.dim())
        shape = [1] * w.dim()
        for a in axes:
            shape[a] = w.shape[a]
        consts[wid] = w * gain.reshape(shape)
        b = consts[bias.id]
        consts[bias.id] = (b.reshape(-1) - mu * gain + shift).reshape(b.shape)
        # the walk adds the folded bias, which holds shift - mu * gain
        return y * gain.reshape((1, -1, 1, 1) if y.dim() == 4 else (1, -1))

    with torch.no_grad(), plain.no_tf32(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        plain.walk(graph, consts, plain.to_input(fold_frames, torch.float32), root_fn=root,
                   ops=ops)


def make(graph: Graph, seed: int, device, ops: Optional[plain.Ops] = None
         ) -> Dict[int, torch.Tensor]:
    """The folded float32 weights of ``seed`` on ``device``."""
    consts = draw(graph, seed, device)
    fold(graph, consts, frames(graph, FOLD_FRAMES, seed, FOLD, device), ops)
    return consts


def blob(graph: Graph, consts: Dict[int, torch.Tensor],
         int_consts: Optional[Dict[str, list]] = None) -> bytes:
    """The ``.bin`` of ``consts``: each at its declared offset, and each
    integer Const the values the configuration gives it by name
    (``int_consts``) or, where it gives none, a Reshape target's declared
    shape."""
    int_consts = int_consts or {}
    out = bytearray(graph.blob_size)
    for c in graph.of_type("Const"):
        dtype = np.dtype(ELEMENT_TYPES[c.attrs["element_type"]])
        if c.id in consts:
            arr = consts[c.id].detach().cpu().numpy().astype(dtype)
        elif c.name in int_consts:
            arr = np.array(int_consts[c.name], dtype=dtype)
        else:
            targets: List[tuple] = [graph.layers[d].out_shape for d, i in c.consumers
                                    if graph.layers[d].type == "Reshape" and i == 1]
            if len(targets) != len(c.consumers) or len(set(targets)) != 1:
                raise NotImplementedError(f"{c.name}: an integer Const that is not one "
                                          f"Reshape target, and no int_consts entry")
            arr = np.array(targets[0], dtype=dtype)
        raw = np.ascontiguousarray(arr).tobytes()
        offset, size = int(c.attrs["offset"]), int(c.attrs["size"])
        if len(raw) != size:
            raise ValueError(f"{c.name}: {len(raw)} bytes, the layout wants {size}")
        out[offset:offset + size] = raw
    return bytes(out)
