"""PyTorch and CUDA port of voicefixer_tpu for NVIDIA Hopper (H100).

The JAX package ``voicefixer_tpu`` beside it is the reference: module names
match it, public functions keep its layouts, and the tests hold each module
against its JAX counterpart. This package imports torch and numpy only.

    from voicefixer_tpu_torch import VoiceFixer
    vf = VoiceFixer.random(0)            # device=None means "cuda"
    out = vf.restore_inmem(wav, mode=0)
"""

from voicefixer_tpu_torch.config import DEFAULT_CONFIG, VoiceFixerConfig  # noqa: F401


def __getattr__(name):
    if name == "VoiceFixer":
        from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
        return VoiceFixer
    raise AttributeError(
        f"module 'voicefixer_tpu_torch' has no attribute {name!r}")


__all__ = ["VoiceFixer", "VoiceFixerConfig", "DEFAULT_CONFIG"]
