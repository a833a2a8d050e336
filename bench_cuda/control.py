"""Stand-ins for the program that ``correct`` has to reject, for any
family; each is a factory ``make(family, cfg, state, device)`` that
``harness.run_cell`` takes as ``make_program``.

- ``ControlProgram``: the control of ``correct``, the family's reference
  put in the program's place, computed one step below the configuration's
  precision (the family's ``CONTROL``: for VoiceFixer "tf32" for a float32
  configuration, "fp8" for a bfloat16 one).
- ``faulty(kind, family)``: the program with its timed path broken
  underneath, as the family's ``FAULTS[kind]`` breaks it.

``bench_cuda/calibrate.py`` reads them on the card; the CPU tests see each
come out not correct.
"""

from __future__ import annotations

import numpy as np
import torch


class ControlProgram:
    """The reference in the program's place, in ``numerics`` (by default
    the step below the configuration's precision)."""

    def __init__(self, family, cfg: dict, state: tuple, device,
                 numerics: str | None = None):
        def dev(sd):
            return {k: torch.as_tensor(np.asarray(v), device=device)
                    for k, v in sd.items() if np.asarray(v).dtype.kind == "f"}
        self.ref = family.reference(
            tuple(dev(sd) for sd in state), family.namespace(cfg),
            numerics or family.CONTROL[cfg["precision"]])

    def serve(self, entry, inputs: list, kwargs: dict) -> list:
        judge = getattr(entry, "expected", None)
        return [self.ref.restore(x) if judge is None
                else judge(self.ref, x, kwargs) for x in inputs]

    def close(self):
        self.ref = None


def faulty(kind: str, family):
    """A program factory whose timed path has the fault ``kind``, one of
    ``family.FAULTS``."""
    if kind not in family.FAULTS:
        raise KeyError(f"fault {kind!r}: one of {tuple(family.FAULTS)}")

    def make(family, cfg, state, device):
        return family.FAULTS[kind](cfg, state, device)
    return make
