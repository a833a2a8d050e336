"""rows_per_call (pipeline: ``VoiceFixer._restore_rows``,
``parallel.inference.rows_per_call``), in rows: the traced sample's 30 s
segments over the program's vf.upload spans within the benchmark's request
spans; one vf.upload is one device call of stacked rows. More rows a call
spread each call's fixed host cost over more audio. Traced sample; None
where the program enters no vf.request or vf.upload span."""


def read(run):
    rec = run.record
    if rec is None or not rec.segments or not rec.named({"vf.request"}):
        return None
    spans = rec.request_spans()
    calls = sum(1 for e in rec.ranges if e.name == "vf.upload"
                and any(s <= e.start and e.end <= t for s, t in spans))
    return rec.segments / calls if calls else None
