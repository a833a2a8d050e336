"""No run loads JAX or the JAX package, compared by whole top-level
names; the reference loads nothing of the program; without a card the
benchmark prints no result."""

import json
import subprocess
import sys

import pytest

from bench_cuda import spec

ROOT = str(spec.ROOT)


def _python(code: str, timeout: float = 600) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(spec.HERE))
    try:
        import run
    finally:
        sys.path.remove(str(spec.HERE))
    saved = dict(sys.modules)
    try:
        sys.modules["voicefixer_tpu_torch_extra"] = object()
        assert "voicefixer_tpu" not in run.forbidden_modules()
        sys.modules["voicefixer_tpu.config"] = object()
        assert "voicefixer_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_cpu_dry_run_loads_no_jax(tmp_path):
    code = f"""
import json, sys, torch
torch.set_num_threads(2)
from pathlib import Path
sys.path.insert(0, {str(spec.HERE)!r})
from bench_cuda.tests import narrow
import run
base = narrow.make_base(Path({str(tmp_path)!r}))
r = narrow.run(base, "fp32-interactive", traced=True)
print(json.dumps({{"found": run.forbidden_modules(), "correct": r["correct"]}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"found": [], "correct": True}


def test_the_reference_imports_nothing_of_the_program():
    code = """
import sys
import bench_cuda.reference.model
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("voicefixer_tpu_torch", "voicefixer_tpu",
                                    "jax", "jaxlib", "flax"))
print(bad)
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "bench_cuda/run.py", "--workload",
                          "bf16-interactive", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
