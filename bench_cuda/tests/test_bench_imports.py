"""No run loads JAX or the JAX package, compared by whole top-level
names; the reference loads nothing of the program; without a card the
benchmark prints no result; the generic modules reach one model only
through its family."""

import ast
import json
import subprocess
import sys
from pathlib import Path

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
import importlib, pathlib, sys
for path in sorted(pathlib.Path("bench_cuda/reference").glob("*.py")):
    importlib.import_module("bench_cuda.reference." + path.stem)
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


GENERIC = [spec.HERE / f for f in ("harness.py", "check.py", "control.py",
                                   "calibrate.py")] + sorted(
    (spec.HERE / "metrics").glob("*.py"))
# the modules that hold VoiceFixer, which families/voicefixer.py delegates to
VOICEFIXER = ("bench_cuda.program", "bench_cuda.model_config",
              "bench_cuda.reference.model", "bench_cuda.frozen.flops",
              "bench_cuda.frozen.ref_state_dict", "bench_cuda.weights.layout",
              "bench_cuda.weights.draw")
# the files and folders that hold one model's code, or the tests: not checked
OWN_FILES = ("program.py", "model_config.py", "weights.py", "reference",
             "frozen", "tests")
# names of VoiceFixer's configuration, program and reference
WORDS = {"pipeline", "seg_length", "seg_length_seconds", "sample_rate",
         "stft", "mel", "denoiser", "unet", "vocoder", "Program",
         "program_config", "Reference", "VoiceFixer", "restore_rows",
         "pipeline_flops", "mel_filterbank", "SECTIONS", "weights.draw",
         "weights.layout"}


def _imports_and_names(path) -> tuple:
    """(modules and names imported, identifiers and ``a.b`` uses)."""
    imported, names = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported |= {node.module} | {f"{node.module}.{a.name}"
                                         for a in node.names}
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
            if isinstance(node.value, ast.Name):
                names.add(f"{node.value.id}.{node.attr}")
    return imported, names


def _of_one_model(rel: Path, imported) -> set:
    """The modules of one model that the file at ``rel`` (under
    ``bench_cuda/``) imports but does not own. ``families/<name>.py`` owns
    ``reference/<name>.py``, and ``families/voicefixer.py`` also
    VoiceFixer's modules; an entry point owns the reference's pieces that
    its ``expected`` uses; no other file owns any."""
    owned = ()
    if rel.parts[0] == "entries":
        owned = ("bench_cuda.reference",)
    if rel.parts[0] == "families":
        owned = (f"bench_cuda.reference.{rel.stem}",)
        if rel.stem == "voicefixer":
            owned += VOICEFIXER
    held = VOICEFIXER + ("bench_cuda.reference",)
    within = lambda n, ms: any(n == m or n.startswith(m + ".")  # noqa: E731
                               for m in ms)
    return {n for n in imported if within(n, held) and not within(n, owned)}


@pytest.mark.parametrize("path", GENERIC, ids=lambda p: p.name)
def test_generic_modules_reach_one_model_only_through_its_family(path):
    _, names = _imports_and_names(path)
    assert not names & WORDS, names & WORDS


def test_only_a_family_imports_its_models_modules():
    paths = [p for p in spec.HERE.rglob("*.py")
             if not set(p.relative_to(spec.HERE).parts) & set(OWN_FILES)]
    assert set(GENERIC) <= set(paths)
    for path in paths:
        rel = path.relative_to(spec.HERE)
        assert not _of_one_model(rel, _imports_and_names(path)[0]), path
    imported, _ = _imports_and_names(spec.HERE / "families" / "voicefixer.py")
    assert {"bench_cuda.program", "bench_cuda.model_config",
            "bench_cuda.reference.model", "bench_cuda.frozen.flops",
            "bench_cuda.weights"} <= imported


@pytest.mark.parametrize("rel, imported, bad", [
    ("families/bigvgan.py", {"bench_cuda.reference.bigvgan"}, set()),
    ("families/bigvgan.py", {"bench_cuda.reference.model.pad_to"},
     {"bench_cuda.reference.model.pad_to"}),
    ("families/bigvgan.py", {"bench_cuda.program"}, {"bench_cuda.program"}),
    ("harness.py", {"bench_cuda.reference.bigvgan"},
     {"bench_cuda.reference.bigvgan"}),
    ("metrics/mfu.py", {"bench_cuda.weights", "bench_cuda.weights.to_host"},
     set()),
    ("entries/restore_mode1.py", {"bench_cuda.reference.mode1"}, set()),
    ("entries/restore_mode1.py", {"bench_cuda.program"},
     {"bench_cuda.program"})])
def test_a_family_owns_its_reference_and_no_other(rel, imported, bad):
    assert _of_one_model(Path(rel), imported) == bad
