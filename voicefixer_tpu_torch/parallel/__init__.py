"""Running the port over several cards, as ``voicefixer_tpu/parallel/``, one
process a card: ``distributed`` starts the process group, ``mesh`` lays the
ranks out as ("data", "model"), ``inference`` restores chunks data-parallel,
``sharding`` and ``tp`` shard the analysis stage's convolutions by output
channel, ``sp`` shards the vocoder's time axis (across processes, or in one
process over several devices)."""
