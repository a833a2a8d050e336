"""vocoder_device_ms (synthesis: ``pipeline/vocoder_facade.py``,
``models/vocoder.py``; K1-K4): device milliseconds per 30 s segment of the
operations launched inside the program's vf.vocoder range, matched to
their host launch by correlation id. Traced sample."""

NAMES = {"vf.vocoder"}


def read(run):
    rec = run.record
    if rec is None or not rec.segments:
        return None
    ops = rec.launched_in(NAMES)
    if not ops:
        return None
    return sum(e.end - e.start for e in ops) / 1e3 / rec.segments
