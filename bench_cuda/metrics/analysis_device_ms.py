"""analysis_device_ms (analysis stage: ``models/analysis.py``,
``models/denoiser.py``, ``models/resunet.py``; K5, K6): device
milliseconds per 30 s segment of the operations launched inside the
program's vf.stft_mel, vf.denoiser and vf.resunet ranges, matched to
their host launch by correlation id. Traced sample."""

NAMES = {"vf.stft_mel", "vf.denoiser", "vf.resunet"}


def read(run):
    rec = run.record
    if rec is None or not rec.segments:
        return None
    ops = rec.launched_in(NAMES)
    if not ops:
        return None
    return sum(e.end - e.start for e in ops) / 1e3 / rec.segments
