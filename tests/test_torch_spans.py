"""The port's program spans (``utils.profiling.annotate``) on the request
path, as ``torch.profiler`` records them on the CPU at tiny_test_config:
one ``vf.request`` a call holding the rest, one ``vf.upload`` a device
call, the stages between ``vf.upload`` and ``vf.download``, ``vf.cast``
only where a weight tree is cast (inside its stage for a caller's float32
tree, once an instance outside the stages), and the new spans outside the
four stage spans."""

import json

import numpy as np
import pytest
import torch

from voicefixer_tpu_torch.config import tiny_test_config
from voicefixer_tpu_torch.ops.precision import precision
from voicefixer_tpu_torch.parallel import inference
from voicefixer_tpu_torch.pipeline import plan
from voicefixer_tpu_torch.pipeline.restore import VoiceFixer, restore_batch
from voicefixer_tpu_torch.utils import profiling
from tests.test_torch_weights import one_torch_thread  # noqa: F401

CFG = tiny_test_config()
SR = CFG.pipeline.sample_rate
STAGES = ("vf.stft_mel", "vf.denoiser", "vf.resunet", "vf.vocoder")
NEW = ("vf.plan", "vf.upload", "vf.download", "vf.stitch")


@pytest.fixture(scope="module")
def vf():
    return VoiceFixer.random(7, config=CFG, device="cpu")


def _wav(seconds, seed=0):
    n = int(seconds * SR)
    return (0.1 * np.random.default_rng(seed).standard_normal(n)
            ).astype(np.float32)


def _spans(tmp_path, fn):
    """fn's result and the vf.* ranges its call entered, [(name, start,
    end)] in start order (us)."""
    with profiling.trace(str(tmp_path), device="cpu"):
        out = fn()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e["name"].startswith("vf.")]
    return out, sorted(spans, key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _cap(monkeypatch, rows):
    monkeypatch.setattr(plan, "rows_per_call",
                        lambda vf, seg_len, group=None: rows)


CALLS = {
    "mode0": lambda vf: vf.restore_inmem(_wav(2.5)),
    "overlap": lambda vf: vf.restore_inmem(_wav(2.5),
                                           chunk_overlap_seconds=0.25),
    "mode2": lambda vf: vf.restore_inmem(_wav(1.5), mode=2),
    "wavs": lambda vf: inference.restore_wavs(vf, [_wav(1.5), _wav(0.5, 1)]),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_one_request_span_holds_the_others(vf, tmp_path, call):
    _, spans = _spans(tmp_path, lambda: CALLS[call](vf))
    requests = _named(spans, "vf.request")
    assert len(requests) == 1
    assert all(_inside(s, requests[0]) for s in spans)
    names = {s[0] for s in spans}
    assert set(NEW) <= names
    # one upload a device call, each call through the whole pipeline
    assert len(_named(spans, "vf.upload")) == len(_named(spans, "vf.vocoder"))


@pytest.mark.parametrize("cap,calls", [(None, 1), (1, 3), (2, 2)])
def test_one_upload_a_call_under_a_cap(vf, tmp_path, monkeypatch, cap,
                                       calls):
    """Three segments (the tail padded) in ceil(3 / cap) calls: the count of
    vf.upload is the count of calls that _calls makes."""
    _cap(monkeypatch, cap)
    seen = []
    batch = vf._restore_batch_device

    def counted(rows, *a, **k):
        seen.append(len(rows))
        return batch(rows, *a, **k)
    monkeypatch.setattr(vf, "_restore_batch_device", counted)
    out, spans = _spans(tmp_path, lambda: vf.restore_inmem(_wav(2.5)))
    assert out.shape == (int(2.5 * SR),)
    assert len(seen) == calls and sum(seen) == 3
    assert len(_named(spans, "vf.upload")) == calls
    assert len(_named(spans, "vf.vocoder")) == calls


@pytest.mark.parametrize("entry", ["restore_inmem", "restore_wavs"])
def test_download_follows_the_stages_in_each_call(vf, tmp_path,
                                                  monkeypatch, entry):
    _cap(monkeypatch, 1)
    if entry == "restore_inmem":
        fn = lambda: vf.restore_inmem(_wav(2.0))  # noqa: E731
    else:
        fn = lambda: inference.restore_wavs(  # noqa: E731
            vf, [_wav(1.0), _wav(1.0, 1)])
    _, spans = _spans(tmp_path, fn)
    copy = [s for s in spans if s[0] in ("vf.upload", "vf.download")]
    assert [s[0] for s in copy] == ["vf.upload", "vf.download"] * 2
    for up, down in zip(copy[0::2], copy[1::2]):
        assert up[2] <= down[1]
        # the stages lie between the upload and the download
        stages = [s for s in spans if s[0] in STAGES
                  and up[2] <= s[1] and s[2] <= down[1]]
        assert sorted(s[0] for s in stages) == sorted(STAGES)


def test_new_spans_lie_outside_the_stages(vf, tmp_path):
    _, spans = _spans(tmp_path, lambda: vf.restore_inmem(_wav(2.5)))
    stages = [s for s in spans if s[0] in STAGES]
    for s in spans:
        if s[0] in NEW:
            assert not any(t[1] < s[2] and s[1] < t[2] for t in stages), s


@pytest.mark.parametrize("prec", ["parity", "production"])
def test_weight_casts_inside_their_stage_only_in_production(tmp_path, prec):
    """A caller's float32 trees (``restore_batch`` as a library function)
    are cast on every call, inside the ResUNet's and the vocoder's stage
    spans, in production only."""
    with precision(prec):
        vf = VoiceFixer.random(7, config=CFG, device="cpu")
        rows = torch.from_numpy(np.stack([_wav(1.0), _wav(1.0, 1)]))
        _, spans = _spans(tmp_path, lambda: restore_batch(
            vf.params, vf.vocoder_params, rows, CFG))
    casts = _named(spans, "vf.cast")
    if prec == "parity":
        assert casts == []
        return
    # one cast a call in each of the ResUNet and the vocoder (one call of
    # two rows here), none elsewhere
    owners = [[t[0] for t in spans if t[0] in STAGES and _inside(c, t)]
              for c in casts]
    assert sorted(owners) == [["vf.resunet"], ["vf.vocoder"]]


def test_instance_casts_once_outside_the_stages(tmp_path):
    """In production an instance casts its trees on its first request, in
    one ``vf.cast`` span inside ``vf.request`` and outside the stages; a
    later request enters no ``vf.cast`` span, and still ``vf.resunet`` and
    ``vf.vocoder``: the benchmark's ``weight_cast_ms`` reads 0 there."""
    with precision("production"):
        vf = VoiceFixer.random(7, config=CFG, device="cpu")
        _, first = _spans(tmp_path, lambda: vf.restore_inmem(_wav(1.5)))
        _, later = _spans(tmp_path, lambda: vf.restore_inmem(_wav(1.5, 1)))
    cast, = _named(first, "vf.cast")
    assert _inside(cast, _named(first, "vf.request")[0])
    assert not any(t[1] < cast[2] and cast[1] < t[2]
                   for t in first if t[0] in STAGES)
    assert _named(later, "vf.cast") == []
    assert {"vf.resunet", "vf.vocoder"} <= {s[0] for s in later}
    assert (vf.weight_casts.misses, vf.weight_casts.hits) == (1, 1)


def test_restore_wavs_gives_restore_inmems_names(vf, tmp_path):
    wavs = [_wav(1.5), _wav(0.5, 1)]
    outs, spans = _spans(tmp_path,
                         lambda: inference.restore_wavs(vf, wavs))
    _, alone = _spans(tmp_path, lambda: vf.restore_inmem(wavs[0]))
    assert {s[0] for s in spans} == {s[0] for s in alone}
    assert [o.shape for o in outs] == [w.shape for w in wavs]


def test_annotate_asks_for_the_card_once(monkeypatch):
    asked = []

    def available():
        asked.append(1)
        return False
    monkeypatch.setattr(torch.cuda, "is_available", available)
    profiling._nvtx.cache_clear()
    try:
        for _ in range(3):
            with profiling.annotate("vf.test"):
                pass
    finally:
        profiling._nvtx.cache_clear()
    assert len(asked) == 1


def test_annotate_records_only_under_a_profiler(monkeypatch, tmp_path):
    """Without a running profiler a span enters no ``record_function``
    (it would record nothing); under one it does."""
    entered = []
    real = torch.profiler.record_function

    def counted(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with profiling.annotate("vf.off"):
        pass
    assert entered == []

    def body():
        with profiling.annotate("vf.on"):
            pass
    _, spans = _spans(tmp_path, body)
    assert entered == ["vf.on"] and len(_named(spans, "vf.on")) == 1


def test_bigvgan_synthesize_spans(tmp_path):
    """One ``BigVGAN.synthesize``: ``vf.request`` holds ``vf.upload``, then
    ``vf.vocoder`` with one ``vf.amp`` a stage inside, then
    ``vf.download``."""
    from voicefixer_tpu_torch.config import BigVGANConfig
    from voicefixer_tpu_torch.pipeline.vocoder_facade import BigVGAN
    cfg = BigVGANConfig(upsample_initial_channel=64)
    vocoder = BigVGAN.random(2, cfg, device="cpu")
    mel = np.random.default_rng(0).standard_normal((3, 128)) - 4.0
    out, spans = _spans(tmp_path, lambda: vocoder.synthesize(mel))
    assert out.shape == (1, 3 * cfg.hop_size)
    (request,) = _named(spans, "vf.request")
    (upload,) = _named(spans, "vf.upload")
    (voc,) = _named(spans, "vf.vocoder")
    (download,) = _named(spans, "vf.download")
    amps = _named(spans, "vf.amp")
    assert len(amps) == len(cfg.upsample_rates)
    assert all(_inside(a, voc) for a in amps)
    assert all(_inside(s, request) for s in spans)
    assert upload[2] <= voc[1] and voc[2] <= download[1]
