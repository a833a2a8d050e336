"""What decides ``correct``: the answers the timed window produced, held to
the plain reference (``reference/model.py``) in float32 with TF32 off.

From the window, ``Reservoir`` keeps a uniform sample of the answers,
drawn from the seed. Once the window has closed and the program is freed,
the reference restores the same inputs, with weights drawn again from the
same seed, and these numbers are compared, each with its limit:

- ``rel_err``: the worst over the sampled segments of
  ||program - reference|| / ||reference||, each 30 s segment cut from the
  program's whole answer at its own offset, so segmenting, padding, the
  peak cap, the centre trim and the concatenation are compared with the
  analysis stage and the vocoder. Of a long answer at most ``segments``
  segments are compared, the last, padded one always among them.
- ``wrong_length``: answers whose length is not the input's;
  ``nonfinite``: samples that are NaN or infinite; ``failed``: requests
  that raised. Each has the limit 0.
- ``err_ratio`` (answers of a bfloat16 configuration): the
  worst over the segments of ``rel_err`` over the same of the reference
  computed in the configuration's own precision. A weight draw that
  amplifies rounding moves the program's error and the control's alike,
  so ``rel_err`` alone does not separate them; this ratio does.

The configuration's file names the numbers compared and their limits
(``limits``); the other readings are printed beside them.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_cuda.reference.model import pad_to

BLOCK_ROWS = 8


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


def segments_to_compare(n_segments: int, k: int,
                        rng: np.random.Generator) -> list:
    """The last segment and up to k - 1 others drawn by rng, in order."""
    others = list(range(n_segments - 1))
    pick = rng.choice(others, size=min(k - 1, len(others)), replace=False) \
        if k > 1 and others else []
    return sorted(int(i) for i in pick) + [n_segments - 1]


def _rel(p: np.ndarray, r: np.ndarray) -> float:
    p, r = p.astype(np.float64), r.astype(np.float64)
    return float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30))


def readings(ref, kept: list, seg_per: int, rng, own=None,
             expected=None) -> dict:
    """kept: [(input waves, the program's answers)], a pair a request.
    With ``own``, the reference in the configuration's own precision, also
    ``err_ratio``: the worst over the segments of the program's
    ``rel_err`` over the own-precision reference's, which takes out how
    far a weight draw amplifies rounding, the same on both sides.
    ``expected(reference, wave)``, an entry point's own reference answer,
    replaces upstream's ``restore_inmem`` in mode 0, whole answers
    compared."""
    rel, ratio, wrong, nonfinite = 0.0, 0.0, 0, 0
    pairs = []
    for waves, answers in kept:
        wrong += abs(len(waves) - len(answers))
        pairs += [(w, np.asarray(a)) for w, a in zip(waves, answers)]
    if expected is not None:
        for wav, out in pairs:
            want = expected(ref, wav)
            if out.shape != want.shape:
                wrong += 1
                continue
            nonfinite += int(np.count_nonzero(~np.isfinite(out)))
            rel = max(rel, _rel(out, want))
            if own:
                ratio = max(ratio, _rel(out, want) / max(
                    _rel(expected(own, wav), want), 1e-30))
        return _readings(rel, ratio if own else None, wrong, nonfinite)
    seg = ref.cfg.pipeline.seg_length
    todo = []  # (answer slice, input row, cut)
    for wav, out in pairs:
        if out.shape != wav.shape:
            wrong += 1
            continue
        nonfinite += int(np.count_nonzero(~np.isfinite(out)))
        n_seg = -(-wav.shape[0] // seg)
        for s in segments_to_compare(n_seg, seg_per, rng):
            n = min(seg, wav.shape[0] - s * seg)
            todo.append((out[s * seg: s * seg + n],
                         pad_to(wav[s * seg: (s + 1) * seg], seg), n))
    for i in range(0, len(todo), BLOCK_ROWS):
        block = todo[i: i + BLOCK_ROWS]
        rows = torch.as_tensor(np.stack([r for _, r, _ in block]),
                               device=ref.device)
        res = ref.restore_rows(rows).cpu().numpy()
        mine = own.restore_rows(rows).cpu().numpy() if own else res
        for (got, _, n), want, near in zip(block, res, mine):
            rel = max(rel, _rel(got, want[:n]))
            if own:
                ratio = max(ratio, _rel(got, want[:n])
                            / max(_rel(near[:n], want[:n]), 1e-30))
    return _readings(rel, ratio if own else None, wrong, nonfinite)


def _readings(rel, ratio, wrong, nonfinite) -> dict:
    out = {"rel_err": rel}
    if ratio is not None:
        out["err_ratio"] = ratio
    return out | {"wrong_length": wrong, "nonfinite": nonfinite}


COUNTS = ("wrong_length", "nonfinite", "failed")


def judge(readings: dict, failed: int, limits: dict) -> tuple:
    """(correct, checks, others): the numbers the configuration's
    ``limits`` name, and the counts, each with its limit; the readings it
    does not name are returned apart, to be printed. A run in which no
    error number is compared is not correct."""
    readings = readings | {"failed": failed}
    checks = {k: {"value": v, "limit": limits.get(k, 0)}
              for k, v in readings.items() if k in limits or k in COUNTS}
    others = {k: v for k, v in readings.items() if k not in checks}
    correct = (len(checks) > len(COUNTS)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return correct, checks, others
