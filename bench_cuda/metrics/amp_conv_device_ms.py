"""amp_conv_device_ms (synthesis: ``models/bigvgan.py::amp_stage``):
device milliseconds per segment (in the ``bigvgan`` family an audio
second) of the operations launched inside the program's vf.amp spans (a
stage's three AMP blocks and their mean), matched to their host launch by
correlation id, other than K10's ``snake_aa_kernel``: the dilated
convolutions (cuDNN), the residual adds and the mean. Traced sample; None
where the program enters no vf.amp span."""

NAMES = {"vf.amp"}
KERNEL = "snake_aa_kernel"


def read(run):
    rec = run.record
    if rec is None or not rec.segments:
        return None
    ops = [e for e in rec.launched_in(NAMES) if KERNEL not in e.name]
    if not ops:
        return None
    return sum(e.end - e.start for e in ops) / 1e3 / rec.segments
