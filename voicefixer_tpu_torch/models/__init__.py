"""Model stages of the port (counterparts of voicefixer_tpu/models)."""
