"""Finding, checking and converting the two upstream checkpoints, as
``voicefixer_tpu/pipeline/checkpoints.py`` does, without its download.

Resolution order for each module:
1. an explicit path (an npz tree, or a torch checkpoint converted in
   memory);
2. the converted npz in ~/.cache/voicefixer_tpu/ (the JAX package's cache:
   either package reads what the other wrote);
3. the reference's torch checkpoint in ~/.cache/voicefixer/, checked by
   ``verify_checkpoint``, converted, and written to the npz cache with its
   provenance.
With none of them the loaders raise and name the Zenodo record to fetch by
hand: the port downloads nothing.

``verify_checkpoint``: a size floor and the torch serialization magic (an
HTML error page or a truncated file fails), the first-seen size and sha256
in a ``<ckpt>.integrity.json`` sidecar checked on every later load, and an
exact pin in VOICEFIXER_TPU_{ANALYSIS,VOCODER}_SHA256 where it is set.

The loaders return the JAX-layout tree (numpy leaves);
``utils.weights.from_jax_params`` makes the port's tree of it.
"""

from __future__ import annotations

import hashlib
import json
import os

from voicefixer_tpu_torch.utils import weights as W

ZENODO_ANALYSIS_URL = (
    "https://zenodo.org/record/5600188/files/vf.ckpt?download=1")
ZENODO_VOCODER_URL = ("https://zenodo.org/record/5469951/files/"
                      "model.ckpt-1490000_trimed.pt?download=1")

_HOME = os.path.expanduser("~")
TORCH_ANALYSIS_CKPT = os.path.join(
    _HOME, ".cache/voicefixer/analysis_module/checkpoints/vf.ckpt")
TORCH_VOCODER_CKPT = os.path.join(
    _HOME, ".cache/voicefixer/synthesis_module/44100/"
           "model.ckpt-1490000_trimed.pt")
CACHE_DIR = os.path.join(_HOME, ".cache/voicefixer_tpu")
ANALYSIS_NPZ = os.path.join(CACHE_DIR, "analysis.npz")
VOCODER_NPZ = os.path.join(CACHE_DIR, "vocoder.npz")

_MIN_CKPT_BYTES = 10 * 1024 * 1024  # both real checkpoints are hundreds of MB
_TORCH_MAGIC = (b"PK", b"\x80\x02", b"\x80\x03", b"\x80\x04", b"\x80\x05")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def verify_checkpoint(path: str, which: str, deep: bool = True) -> str:
    """Check the torch checkpoint at ``path`` and return its sha256.
    ``which`` is "analysis" or "vocoder". The sidecar records the first-seen
    size and digest; a later load re-checks the size always and the digest
    when ``deep``."""
    size = os.path.getsize(path)
    if size < _MIN_CKPT_BYTES:
        raise RuntimeError(
            f"{which} checkpoint at {path} is only {size} bytes — a "
            "truncated download or an HTML error page, not a model "
            "checkpoint. Delete it and retry.")
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic not in _TORCH_MAGIC:
        raise RuntimeError(
            f"{which} checkpoint at {path} does not look like a torch "
            f"checkpoint (magic {magic!r}); delete it and retry.")

    sidecar = path + ".integrity.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            rec = json.load(f)
        if rec.get("size") != size:
            raise RuntimeError(
                f"{which} checkpoint at {path} changed size since it was "
                f"verified ({rec.get('size')} -> {size}); it is corrupted "
                "or was replaced. Delete it and the sidecar to re-verify.")
        digest = _sha256(path) if deep else rec.get("sha256")
        if deep and digest != rec.get("sha256"):
            raise RuntimeError(
                f"{which} checkpoint at {path} sha256 mismatch vs its "
                "integrity sidecar; the file is corrupted.")
    else:
        digest = _sha256(path)
        with open(sidecar, "w") as f:
            json.dump({"size": size, "sha256": digest}, f)

    pin = os.environ.get(f"VOICEFIXER_TPU_{which.upper()}_SHA256")
    if pin and digest != pin.lower():
        raise RuntimeError(
            f"{which} checkpoint sha256 {digest} does not match the pinned "
            f"digest {pin}.")
    return digest


def _load(which: str, path: str | None, download: bool) -> dict:
    """The JAX-layout tree of one module. ``download`` is accepted for the
    JAX package's signature; the port never downloads."""
    convert = (W.convert_analysis if which == "analysis"
               else W.convert_vocoder)
    npz_cache = ANALYSIS_NPZ if which == "analysis" else VOCODER_NPZ
    torch_ckpt = (TORCH_ANALYSIS_CKPT if which == "analysis"
                  else TORCH_VOCODER_CKPT)
    url = (ZENODO_ANALYSIS_URL if which == "analysis"
           else ZENODO_VOCODER_URL)

    if path is not None:
        if path.endswith(".npz"):
            return W.load_pytree_npz(path)
        return convert(W.load_torch_state_dict(path))

    if os.path.exists(npz_cache):
        return W.load_pytree_npz(npz_cache)

    if not os.path.exists(torch_ckpt):
        raise RuntimeError(
            f"No {which} checkpoint found (looked for {npz_cache} and "
            f"{torch_ckpt}); this package does not download. Download {url} "
            "manually to the second path, or pass an explicit path.")

    digest = verify_checkpoint(torch_ckpt, which)
    params = convert(W.load_torch_state_dict(torch_ckpt))
    os.makedirs(CACHE_DIR, exist_ok=True)
    W.save_pytree_npz(
        params, npz_cache,
        provenance=f"converted-from-torch source={torch_ckpt} "
                   f"sha256={digest}")
    return params


def load_analysis_params(path: str | None = None,
                         download: bool = True) -> dict:
    """The analysis tree (denoiser + unet), from vf.ckpt or its npz."""
    return _load("analysis", path, download)


def load_vocoder_params(path: str | None = None,
                        download: bool = True) -> dict:
    """The vocoder generator's tree, weight norm folded."""
    return _load("vocoder", path, download)
