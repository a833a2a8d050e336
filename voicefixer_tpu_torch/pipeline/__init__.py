"""Restore pipeline of the port (counterpart of voicefixer_tpu/pipeline)."""
