"""Tensor primitives of the port (counterparts of voicefixer_tpu/ops)."""
