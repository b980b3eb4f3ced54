"""How ``correct`` is decided: every answer of the window against the plain
reference's answer to the same frame.

Three numbers, each with the limit its configuration file states:

  * ``top1_gap``: the widest gap, in logits, by which the reference's logit
    of the class the program answered first lies below the reference's
    best logit, over every answer.  0 where the two agree on the top class.
    Answers altered or misplaced by the batch show here.
  * ``tv_mean``: the mean over every answer of the total variation distance
    between the program's class probabilities and the reference's, half
    the sum of their absolute differences (0 to 1).  A lower precision
    shows here.
  * ``kl_max``: the largest over every answer of the Kullback-Leibler
    divergence of the program's class probabilities from the reference's,
    sum of p_ref · (log p_ref − log p), in nats, the worst answer's.  One
    answer among thousands with its classes moved shows here; one given
    another frame's answer shows on most seeds, not on all, since frames of
    noise get answers alike (PERF.md, section 2, gives the readings).

A non-finite answer makes both numbers non-finite, which no limit passes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

NAMES = ("top1_gap", "tv_mean", "kl_max")
PROB_FLOOR = 1e-30   # a program's probability of 0 read as this in the KL divergence


def _block(p: np.ndarray, pr: np.ndarray, zr: np.ndarray):
    """(widest gap, sum of TV distances, largest KL divergence, rows not
    finite) of one block."""
    finite = np.isfinite(p).all(axis=1)
    rows = np.arange(len(p))
    g = zr[rows, zr.argmax(1)] - zr[rows, p.argmax(1)]
    gap = float(g[finite].max()) if finite.any() else 0.0
    tv = (0.5 * np.abs(p - pr).sum(1))[finite]
    # the reference's log-probabilities from its logits, exact where it rounds a
    # probability to 0
    zc = zr - zr.max(1, keepdims=True)
    log_pr = zc - np.log(np.exp(zc).sum(1, keepdims=True))
    kl = (np.exp(log_pr) * (log_pr - np.log(np.maximum(p, PROB_FLOOR)))).sum(1)[finite]
    return gap, float(tv.sum()), float(kl.max(initial=0.0)), int((~finite).sum())


def compare(answers: List[tuple], ref_probs: np.ndarray, ref_logits: np.ndarray) -> Dict[str, float]:
    """The numbers over every (frame indices, answers) block; a block equal
    to an earlier one of the same frames is counted again without being
    worked out again."""
    gap, tv_sum, kl_max, n, bad = 0.0, 0.0, 0.0, 0, 0
    seen: Dict[tuple, tuple] = {}
    for idx, out in answers:
        p = np.asarray(out, dtype=np.float32).reshape(len(idx), -1)
        key = (int(idx[0]), len(idx))
        if key in seen and np.array_equal(seen[key][0], p):
            g, t, k, b = seen[key][1]
        else:
            g, t, k, b = _block(p.astype(np.float64), ref_probs[idx],
                                ref_logits[idx].astype(np.float64))
            seen[key] = (p, (g, t, k, b))
        gap, tv_sum, kl_max = max(gap, g), tv_sum + t, max(kl_max, k)
        bad, n = bad + b, n + len(idx)
    if n == 0 or bad:
        nan = float("nan")
        return {"top1_gap": nan, "tv_mean": nan, "kl_max": nan, "answers": n,
                "non_finite": bad}
    return {"top1_gap": gap, "tv_mean": tv_sum / n, "kl_max": kl_max, "answers": n,
            "non_finite": 0}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {value, limit}})."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
