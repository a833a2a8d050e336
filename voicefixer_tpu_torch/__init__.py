"""PyTorch and CUDA port of voicefixer_tpu for NVIDIA Hopper (H100).

The JAX package ``voicefixer_tpu`` beside it is the reference: module names
match it, public functions keep its layouts, and the tests hold each module
against its JAX counterpart. This package imports torch and numpy only.

    from voicefixer_tpu_torch import VoiceFixer
    vf = VoiceFixer(ckpt="vf.ckpt", vocoder_ckpt="model.pt")  # on "cuda"
    vf.restore("in.wav", "out.flac", mode=0)
    out = vf.restore_inmem(wav, mode=1)

or, from a shell, ``python -m voicefixer_tpu_torch -i in.wav -o out.wav``.
"""

from voicefixer_tpu_torch.config import DEFAULT_CONFIG, VoiceFixerConfig  # noqa: F401


def __getattr__(name):
    if name == "VoiceFixer":
        from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
        return VoiceFixer
    if name == "Vocoder":
        from voicefixer_tpu_torch.pipeline.vocoder_facade import Vocoder
        return Vocoder
    raise AttributeError(
        f"module 'voicefixer_tpu_torch' has no attribute {name!r}")


__all__ = ["VoiceFixer", "Vocoder", "VoiceFixerConfig", "DEFAULT_CONFIG"]
