"""Running one model over several devices. ``sp`` shards the vocoder's time
axis (``voicefixer_tpu/parallel/sp.py``), in one process."""
