"""On a card: a short run of a cell through the command line, correct,
with every metric the cell reports (``-m gpu``)."""

import json
import subprocess
import sys

import pytest

from bench_cuda import spec


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "bench_cuda/run.py", "--workload",
                          "bf16-interactive", "--seed", str(2 ** 31 + 9),
                          "--seconds", "3", "--trace", str(trace)],
                         cwd=str(spec.ROOT), capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    want = {m["name"] for m in spec.metrics_of(
        spec.benchmark(), "bf16-interactive", bool(trace))}
    assert set(r["metrics"]) == want
