"""Parameter trees of the port (counterpart of voicefixer_tpu/utils)."""
