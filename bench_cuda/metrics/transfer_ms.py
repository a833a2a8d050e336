"""transfer_ms (transfer: ``VoiceFixer._restore_batch_device`` and
``VoiceFixer._to_host``): milliseconds per 30 s segment in which the card
copies a call's rows or results, within the benchmark's request spans:
the device's memcpy operations whose host call lies inside the program's
vf.upload (``torch.as_tensor(rows).to(device)``) or vf.download
(``.cpu().numpy()``) spans, by correlation id. The host's time in those
spans is not read: vf.download's also holds the wait for the call's
work. Traced sample; None where the program enters no vf.request span."""

from bench_cuda import trace

NAMES = {"vf.upload", "vf.download"}


def read(run):
    rec = run.record
    if rec is None or not rec.segments or not rec.named({"vf.request"}):
        return None
    copies = trace.union((e.start, e.end) for e in rec.launched_in(NAMES)
                         if e.name.startswith("Memcpy"))
    inside = [iv for s, e in rec.request_spans()
              for iv in trace.clip(copies, s, e)]
    return trace.length(inside) / 1e3 / rec.segments
