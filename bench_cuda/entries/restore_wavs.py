"""``parallel.inference.restore_wavs`` in one process (no mesh): the
recordings of a request restored together, their 30 s segments batched
across recordings in calls of at most ``rows_per_call`` rows; each answer
is what ``restore_inmem`` gives its recording. The mix's ``kwargs`` go to
the call; the reference judges mode 0."""

JUDGED = {"mode": (0,), "max_batch": None}


def validate(kwargs: dict):
    for k, v in kwargs.items():
        if k not in JUDGED or (JUDGED[k] is not None and v not in JUDGED[k]):
            raise ValueError(f"restore_wavs {k}={v!r}: the reference "
                             f"judges only mode 0 and any max_batch")


def call(vf, waves: list, kwargs: dict) -> list:
    from voicefixer_tpu_torch.parallel.inference import restore_wavs
    return list(restore_wavs(vf, waves, mesh=None, **kwargs))
