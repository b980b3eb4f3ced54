"""``correct`` on the CPU: the plain reference against the program's own CPU
path at a small batch for both configurations, within the limits that the
configurations state, and the float8 control outside them; then whole runs
(the look for a card skipped) with the timed path broken underneath, one
fault at a time, each seen as not correct."""

import functools

import numpy as np
import pytest
import torch

from perfbench.core import check, harness, spec

SEED = 2**31 + 101


@pytest.mark.parametrize("workload", ["r18.bulk512", "mnv2.bulk512"])
def test_reference_against_the_port_and_the_control(workload):
    torch.set_num_threads(4)
    cell = spec.cell(workload)
    graph, consts, calibration, exe = harness.setup(cell, SEED, "cpu")
    from perfbench.core import traffic

    frames = traffic.pool_frames(graph, 8, SEED, "cpu")
    name = exe.ienet.inputs[0]["name"]
    answers = exe.infer_batch({name: frames.numpy()})[exe.ienet.outputs[0]["name"]]
    probs, logits = harness.reference(cell, graph, consts, calibration)(frames)
    limits = cell.config["checks"]["limits"]
    ok, table = check.verdict(check.compare([(np.arange(8), answers)], probs, logits), limits)
    assert ok, table
    control, _ = harness.reference(cell, graph, consts, calibration,
                                   dtype=torch.float8_e4m3fn)(frames)
    ok, table = check.verdict(check.compare([(np.arange(8), control)], probs, logits), limits)
    assert not ok, table


def _misplaced(out):
    return np.roll(out, 1, axis=0)


def _altered(out):
    return np.roll(out, 1, axis=-1)


def _half(out):
    out = out.copy()
    h = len(out) // 2
    out[h:2 * h] = out[:h]
    return out


def _one_altered(out, first):
    """The first answer of the run alone, its classes moved by one
    (``first``: [True] until it has been altered)."""
    if not first[0]:
        return out
    first[0] = False
    out = out.copy()
    out[0] = np.roll(out[0], 1, axis=-1)
    return out


@pytest.mark.parametrize("workload", ["r18.bulk512", "mnv2.bulk512"])
@pytest.mark.parametrize("fault", [None, _misplaced, _altered, _half, _one_altered])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork

    torch.set_num_threads(4)
    cell = spec.cell(workload)
    cell.traffic.update(batch=4, pool=2, warmup_calls=0)
    if fault is not None:
        sound = CompiledNetwork.infer_batch
        if fault is _one_altered:
            fault = functools.partial(_one_altered, first=[True])

        def broken(self, inputs):
            out = sound(self, inputs)
            return {k: fault(v) for k, v in out.items()}
        monkeypatch.setattr(CompiledNetwork, "infer_batch", broken)
    out = harness.run(cell, SEED, 0.5, False, "cpu", harness.process_start(), lambda s: None)
    assert out["correct"] is (fault is None), out["checks"]
