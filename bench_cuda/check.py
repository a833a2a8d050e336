"""What decides ``correct``: the answers the timed window produced, held to
the family's plain reference in float32 with TF32 off.

From the window, ``Reservoir`` keeps a uniform sample of the answers,
drawn from the seed. Once the window has closed and the program is freed,
the reference answers the same inputs, with weights drawn again from the
same seed, and the family's ``compare`` gives the numbers compared
(``families/voicefixer.py``: ``rel_err`` over sampled 30 s segments and
``err_ratio``). An entry point whose answer is not the reference's
``restore`` brings its own ``expected``, and then whole answers are
compared here. Besides, ``wrong_length``: answers whose length is not the
input's (or that are missing); ``nonfinite``: samples that are NaN or
infinite; ``failed``: requests that raised. Each of these has the limit 0.

The configuration's file names the numbers compared and their limits
(``limits``); the other readings are printed beside them.
"""

from __future__ import annotations

import numpy as np


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn by ``rng``
    (Algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.items: list = []
        self.seen = 0

    def offer(self, make):
        """Offer the next answer; ``make()`` gives it only if it is
        kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(make())
            return True
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = make()
            return True
        return False


def rel(p: np.ndarray, r: np.ndarray) -> float:
    """||p - r|| / ||r|| in float64."""
    p, r = p.astype(np.float64), r.astype(np.float64)
    return float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30))


def pairs(kept: list) -> tuple:
    """kept: [(inputs, the program's answers)], a pair a request ->
    ([(input, answer as numpy)], answers missing or extra)."""
    wrong, out = 0, []
    for inputs, answers in kept:
        wrong += abs(len(inputs) - len(answers))
        out += [(x, np.asarray(a)) for x, a in zip(inputs, answers)]
    return out, wrong


def whole_answers(ref, kept: list, expected, own=None) -> dict:
    """The numbers of ``correct`` for the kept (inputs, answers) pairs of
    an entry point that brings ``expected(reference, input)``: every
    answer held whole to it. ``own``, the reference in the
    configuration's own precision, adds ``err_ratio``: the worst of the
    program's ``rel_err`` over the own-precision reference's, which takes
    out how far a weight draw amplifies rounding, the same on both
    sides."""
    err, ratio, nonfinite = 0.0, 0.0, 0
    done, wrong = pairs(kept)
    for x, out in done:
        want = expected(ref, x)
        if out.shape != want.shape:
            wrong += 1
            continue
        nonfinite += int(np.count_nonzero(~np.isfinite(out)))
        err = max(err, rel(out, want))
        if own:
            ratio = max(ratio, rel(out, want) / max(
                rel(expected(own, x), want), 1e-30))
    return as_readings(err, ratio if own else None, wrong, nonfinite)


def as_readings(rel_err, ratio, wrong, nonfinite) -> dict:
    """The readings in the order the result line gives them."""
    out = {"rel_err": rel_err}
    if ratio is not None:
        out["err_ratio"] = ratio
    return out | {"wrong_length": wrong, "nonfinite": nonfinite}


COUNTS = ("wrong_length", "nonfinite", "failed")


def judge(readings: dict, failed: int, limits: dict) -> tuple:
    """(correct, checks, others): the numbers the configuration's
    ``limits`` name, and the counts, each with its limit; the readings it
    does not name are returned apart, to be printed. A run in which no
    error number is compared, or that lacks a number the limits name
    (its value None), is not correct."""
    readings = readings | {"failed": failed}
    missing = {k: None for k in limits if k not in readings}
    checks = {k: {"value": v, "limit": limits.get(k, 0)}
              for k, v in (readings | missing).items()
              if k in limits or k in COUNTS}
    others = {k: v for k, v in readings.items() if k not in checks}
    correct = (len(checks) > len(COUNTS) and not missing
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return correct, checks, others
