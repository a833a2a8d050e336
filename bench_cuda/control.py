"""Stand-ins for the program that ``correct`` has to reject.

- ``ControlProgram``: the control of ``correct``, the reference put in the
  program's place, computed one step below the configuration's precision
  (``reference/model.py``: "tf32" for a float32 configuration, "fp8" for a
  bfloat16 one).
- ``faulty(kind)``: the program with its timed path broken underneath.
  In ``VoiceFixer._restore_batch_device`` (one call of equal-length rows,
  on the card): "half_batch" restores the first half of a call's rows and
  answers the rest with their mean; "altered" shifts every answer by one
  hop (441 samples) where it is produced. "post_bias_dropped" and
  "pre_bias_dropped" hand the program's loader the vocoder with the
  post-conv's or the pre-conv's bias zeroed, as a kernel that skips that
  bias would compute.

``bench_cuda/calibrate.py`` reads them on the card; the CPU tests see each
come out not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_cuda import model_config
from bench_cuda.program import Program
from bench_cuda.reference.model import Reference

CONTROL = {"parity": "tf32", "production": "fp8"}


def _bias_key(cfg: dict, where: str) -> str:
    """The upstream key of the vocoder's pre-conv or post-conv bias."""
    if where == "pre":
        return "generator.1.bias"
    return f"generator.{4 + 3 * len(cfg['vocoder']['upsample_scales'])}.bias"


class ControlProgram:
    """The reference in the program's place, in ``numerics`` (by default
    the step below the configuration's precision)."""

    def __init__(self, cfg: dict, analysis_sd: dict, vocoder_sd: dict,
                 device, numerics: str | None = None):
        def dev(sd):
            return {k: torch.as_tensor(np.asarray(v), device=device)
                    for k, v in sd.items() if np.asarray(v).dtype.kind == "f"}
        self.ref = Reference(dev(analysis_sd), dev(vocoder_sd),
                             model_config.namespace(cfg),
                             numerics or CONTROL[cfg["precision"]])

    def serve(self, entry, waves: list, kwargs: dict) -> list:
        judge = getattr(entry, "expected", None)
        return [self.ref.restore(w) if judge is None
                else judge(self.ref, w, kwargs) for w in waves]

    def close(self):
        self.ref = None


def _half_batch(restore):
    def call(batch, *a, **k):
        n = max(1, len(batch) // 2)
        outs, peaks = restore(batch[:n], *a, **k)
        rest = len(batch) - n
        if rest:
            outs = torch.cat([outs, outs.mean(0, keepdim=True).expand(
                rest, -1)])
            peaks = torch.cat([peaks, peaks[:1].expand(rest)])
        return outs, peaks
    return call


def _altered(restore):
    def call(batch, *a, **k):
        outs, peaks = restore(batch, *a, **k)
        return torch.roll(outs, 441, dims=-1), peaks
    return call


FAULTS = {"half_batch": _half_batch, "altered": _altered}
BIASES = {"post_bias_dropped": "post", "pre_bias_dropped": "pre"}
KINDS = tuple(FAULTS) + tuple(BIASES)


def faulty(kind: str):
    """A program factory whose timed path has the fault ``kind``."""
    if kind not in KINDS:
        raise KeyError(f"fault {kind!r}: one of {KINDS}")

    def make(cfg, analysis_sd, vocoder_sd, device):
        if kind in BIASES:
            key = _bias_key(cfg, BIASES[kind])
            vocoder_sd = dict(vocoder_sd)
            vocoder_sd[key] = np.zeros_like(vocoder_sd[key])
            return Program(cfg, analysis_sd, vocoder_sd, device)
        prog = Program(cfg, analysis_sd, vocoder_sd, device)
        prog.vf._restore_batch_device = FAULTS[kind](
            prog.vf._restore_batch_device)
        return prog
    return make
