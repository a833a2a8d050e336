"""Build the CUDA kernels and the host libraries at first use and load
them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (nvcc, ``-gencode arch=compute_90a,code=sm_90a``), named after a
hash of its sources, the shared headers (``common.cuh``, ``hopper.cuh``)
and flags, in ``voicefixer_tpu_torch/build/``. A host source,
``csrc/<name>.cpp`` (the FLAC decoder), is built the same way by the C++
compiler ($CXX, else g++; ``-O3 -fPIC -shared -std=c++17``), named after
the hash of its source and flags. The first call for a kernel builds every
missing library at once, one compiler process per source, all started
together; the first call for a host library builds that one alone, and
needs no CUDA. A library is written under a temporary name and renamed
into place, so concurrent builds never load a half-written file. A
failed build raises with the compiler's output.
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
           "resstack_wgmma", "convblock", "snake_aa", "amp_conv")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("flacdec",)
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

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


def cxx() -> str:
    """The host C++ compiler: $CXX, else g++ on PATH."""
    exe = os.environ.get("CXX") or "g++"
    found = shutil.which(exe)
    if not found:
        raise RuntimeError(f"C++ compiler {exe!r} not found: the host "
                           "libraries cannot be built")
    return found


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
        h.update((CSRC / f"{name}.cpp").read_bytes())
    else:
        h = hashlib.sha256(" ".join(FLAGS).encode())
        for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
            h.update(f.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES + HOST_SOURCES) -> dict:
    """Build every library of ``names`` that is missing. Returns {name:
    seconds} for the ones built; the compiler's output (for a kernel, its
    register and shared-memory report) goes to build/<name>.log."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    cmds = {}
    for n in todo:  # every compiler is found before any process starts
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        if n in HOST_SOURCES:
            cmd = [cxx(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cpp")]
        else:
            cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        cmds[n] = (tmp, cmd)
    t0 = time.perf_counter()
    procs = {n: (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT))
             for n, (tmp, cmd) in cmds.items()}
    took, failed = {}, []
    for n, (tmp, p) in procs.items():
        out = p.communicate()[0].decode(errors="replace")
        took[n] = time.perf_counter() - t0
        (BUILD / f"{n}.log").write_text(out)
        if p.returncode != 0:
            failed.append(f"{n}: exit {p.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu or .cpp, built first if needed:
    for a kernel every missing library, for a host library that one."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build_all((name,) if name in HOST_SOURCES else SOURCES)
        lib = ctypes.CDLL(str(path))
        if name not in HOST_SOURCES:
            lib.vf_error_string.argtypes = [ctypes.c_int]
            lib.vf_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.vf_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
