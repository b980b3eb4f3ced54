"""The yardstick's arithmetic on hand-made data: work counts, the trace's
interval union and idle gaps, the check's numbers, a configuration's own
operations in the plain walk."""

import dataclasses

import numpy as np
import pytest

import torch

from perfbench.core import check, ir, plain, spec, trace, work

SIZES = {"input": 1, "weight": 1, "bias": 2, "output": 2}


def _graph(name):
    return ir.parse(spec.config(name)["xml"])


@pytest.mark.parametrize("name,gmac,roots", [
    ("resnet18.int8full.bf16", 1.814073344, 21),   # torchvision resnet18: 1.814 GMAC
    ("mobilenet_v2.int8full.bf16", 0.300774272, 53),  # Sandler et al.: about 300 M
])
def test_macs_per_image_match_the_published_counts(name, gmac, roots):
    g = _graph(name)
    assert work.macs_per_image(g) == round(gmac * 1e9)
    assert len(work.nodes(g, 1, SIZES)) == roots
    assert spec.config(name)["macs_per_image"] == round(gmac * 1e9)


def test_one_conv_by_hand():
    g = _graph("resnet18.int8full.bf16")
    stem = work.nodes(g, 2, SIZES)[0]
    # 7x7/2 conv, 3 -> 64 channels, 224 -> 112: x int8, w int8, bias and y bf16
    assert stem["macs"] == 2 * 64 * 112 * 112 * 3 * 7 * 7
    assert stem["bytes"] == 2 * 3 * 224 * 224 + 64 * 3 * 7 * 7 + 64 * 2 + 2 * 64 * 112 * 112 * 2
    bound = work.bound_seconds(g, 2, SIZES, 1e12, 1e9)
    assert bound == pytest.approx(sum(max(2 * n["macs"] / 1e12, n["bytes"] / 1e9)
                                      for n in work.nodes(g, 2, SIZES)))


def test_union_merges_overlaps_and_keeps_gaps():
    iv = np.array([[5, 7], [0, 2], [1, 3], [10, 11], [6, 9]])
    assert trace.union(iv).tolist() == [[0, 3], [5, 9], [10, 11]]
    assert trace.union(np.zeros((0, 2), np.int64)).shape == (0, 2)


def test_reduce_busy_idle_and_labels():
    us = 1000  # ns
    events = [  # (device?, name, start, end, annotation?)
        (False, trace.MARK, 0, 100 * us, False),
        (True, "Memcpy HtoD", -5 * us, 10 * us, False),          # clipped to the window
        (True, "conv2d_direct_i8_wgmma<ConvAIm2col>", 20 * us, 40 * us, False),
        (True, "vectorized_elementwise_kernel", 30 * us, 50 * us, False),  # overlaps
        (True, "mystery_kernel", 90 * us, 120 * us, False),       # clipped, no category
        (True, trace.MARK, 0, 100 * us, True),                    # the range's device span
        (False, "aten::cat", 55 * us, 80 * us, False),            # the host during a gap
    ]
    s = trace.reduce(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((10 + 30 + 10) * 1e-6)
    assert s.activities == 4
    assert s.by_category["conv2d_direct"] == pytest.approx(20e-6)
    assert s.unmatched == {"mystery_kernel": pytest.approx(10e-6)}
    assert s.idle_by_host["aten::cat"] == pytest.approx(40e-6)   # the gap 50..90
    assert s.idle_by_host["python (no operator running)"] == pytest.approx(10e-6)  # 10..20
    bd = s.breakdown()
    assert set(bd) == {"device_ops", "idle_gaps"} and len(bd["device_ops"]) == 4


def test_check_numbers_on_made_answers():
    z = np.array([[3.0, 1.0, 0.0], [0.0, 2.0, 1.0]])
    p = np.exp(z) / np.exp(z).sum(1, keepdims=True)
    same = check.compare([(np.arange(2), p)], p, z)
    assert same["top1_gap"] == 0.0 and same["tv_mean"] == pytest.approx(0.0, abs=1e-7)
    assert same["kl_max"] == pytest.approx(0.0, abs=1e-6) and same["answers"] == 2
    swapped = check.compare([(np.arange(2), p[::-1])], p, z)
    assert swapped["top1_gap"] == pytest.approx(2.0)   # row 0 answered class 1, 3 - 1
    tv = 0.5 * np.abs(p - p[::-1]).sum(1)
    kl = (p * (np.log(p) - np.log(p[::-1]))).sum(1)
    assert swapped["tv_mean"] == pytest.approx(tv.mean())
    assert swapped["kl_max"] == pytest.approx(kl.max())
    # one row of many wrong: the mean hardly moves, the worst row shows it
    many = np.tile(p, (500, 1))
    one = many.copy()
    one[7] = p[(7 + 1) % 2]
    worst = check.compare([(np.tile(np.arange(2), 500), one)], many, np.tile(z, (500, 1)))
    assert worst["tv_mean"] < 0.01 and worst["kl_max"] == pytest.approx(kl[1])
    # a probability the program rounds to 0 reads as the floor, not as infinity
    zero = p.copy()
    zero[0, 2] = 0.0
    floor = check.compare([(np.arange(2), zero)], p, z)
    assert floor["kl_max"] == pytest.approx(
        (p[0, :2] * np.log(p[0, :2] / zero[0, :2])).sum()
        + p[0, 2] * (np.log(p[0, 2]) - np.log(check.PROB_FLOOR)))
    bad = check.compare([(np.arange(2), np.full((2, 3), np.nan))], p, z)
    ok, table = check.verdict(bad, {"top1_gap": 1.0, "tv_mean": 0.5, "kl_max": 3.0})
    assert not ok and np.isnan(table["top1_gap"]["value"]) and np.isnan(table["kl_max"]["value"])


def test_the_walk_takes_a_configurations_own_operations():
    """An operation the walk lacks raises; given in ``ops`` it runs (an op
    of several outputs hands each port on), and ``ops`` override the
    walk's own."""
    g = _graph("resnet18.int8full.bf16")
    pool = g.of_type("MaxPool")[0]
    g.layers[pool.id] = dataclasses.replace(pool, type="Mystery")
    consts = {c.id: torch.full(c.const_shape, 0.01) for c in g.of_type("Const")
              if c.attrs["element_type"] == "f32"}
    x = torch.rand((1, 3, 224, 224))
    with pytest.raises(NotImplementedError, match="Mystery"):
        plain.walk(g, consts, x)

    def mystery(layer, xs, dtype):
        return {min(layer.out_shapes): torch.nn.functional.max_pool2d(
            torch.nn.functional.pad(xs[0], (1, 1, 1, 1), value=float("-inf")), 3, 2)}

    got = plain.walk(g, consts, x, ops={"Mystery": mystery})
    g.layers[pool.id] = pool
    want = plain.walk(g, consts, x)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k])
    calls = []

    def softmax(layer, xs, dtype):
        calls.append(layer.name)
        return torch.softmax(xs[0], dim=1)

    plain.walk(g, consts, x, ops={"SoftMax": softmax})
    assert calls == [g.of_type("SoftMax")[0].name]
