"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (nvcc, ``-gencode arch=compute_90a,code=sm_90a``), named after a
hash of its sources, the shared headers (``common.cuh``, ``hopper.cuh``)
and flags, in ``voicefixer_tpu_torch/build/``. The first
call builds every missing library at once, one nvcc process per source, all
started together. A library is written under a temporary name and renamed
into place, so concurrent builders never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("stft_mel", "gru_bidir", "upsample", "resstack_f32",
           "resstack_wgmma", "convblock")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Build every library that is missing. Returns {name: seconds} for the
    ones built; the compiler's register and shared-memory report goes to
    build/<name>.log."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    took, failed = {}, []
    for n, (tmp, p) in procs.items():
        out = p.communicate()[0].decode(errors="replace")
        took[n] = time.perf_counter() - t0
        (BUILD / f"{n}.log").write_text(out)
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.vf_error_string.argtypes = [ctypes.c_int]
        lib.vf_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.vf_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
