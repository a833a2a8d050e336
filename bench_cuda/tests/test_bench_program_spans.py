"""The readers of the program's request-path spans (transfer_ms,
plan_stitch_ms, weight_cast_ms, rows_per_call) on a synthetic record of
known values, and what ``harness.breakdown`` names by those spans."""

import pytest

from bench_cuda import harness, spec, trace
from bench_cuda.tests.test_bench_metrics import _chrome as _no_program_spans

FAMILY = spec.family("voicefixer")
CFG = FAMILY.namespace(spec.config("voicefixer-44k-bf16"))
NEW = ("transfer_ms.rate", "transfer_ms.latency", "plan_stitch_ms.rate",
       "plan_stitch_ms.latency", "weight_cast_ms.latency",
       "rows_per_call.rate")


def _chrome(casts: bool = True):
    """Two traced requests, of 2 and 1 segments, in Chrome trace events
    (us). Request 0 (0-1000): plan 20-80, upload 80-130, the stages with a
    cast in the ResUNet (50) and the vocoder (20), download 600-800 (the
    host waits for the call, the card copies 660-700, then the host
    copies), stitch 800-900. Request 1 (1000-1150): plan 10, upload 20, a cast of 10, a
    kernel 1070-1090, download 1100-1130 (on the card 1105-1115), stitch
    10. A plan and an upload after the requests are left out."""
    ev = []

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    def r(name, ts, dur):
        x("user_annotation", name, ts, dur)
    r("bench.request", 0, 1000)
    r("vf.request", 10, 980)
    r("vf.plan", 20, 40)
    r("vf.plan", 60, 20)
    r("vf.upload", 80, 50)
    x("cuda_runtime", "cudaMemcpyAsync", 85, 40, 1)
    x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 110, 15, 1)
    r("vf.stft_mel", 130, 70)
    x("cuda_runtime", "cudaLaunchKernel", 135, 5, 2)
    x("kernel", "void stft_mel_kernel<1>(float*)", 140, 60, 2)
    r("vf.resunet", 200, 200)
    if casts:
        r("vf.cast", 205, 50)
    x("cuda_runtime", "cudaLaunchKernel", 255, 5, 3)
    x("kernel", "sm90_xmma_fprop_cudnn", 260, 140, 3)
    r("vf.vocoder", 400, 200)
    if casts:
        r("vf.cast", 405, 20)
    x("cuda_runtime", "cudaLaunchKernel", 425, 5, 4)
    x("kernel", "void vf::chain_wgmma_kernel<2>(...)", 430, 210, 4)
    r("vf.download", 600, 200)
    x("cuda_runtime", "cudaMemcpyAsync", 605, 190, 5)
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 660, 40, 5)
    r("vf.stitch", 800, 100)
    r("bench.request", 1000, 150)
    r("vf.request", 1010, 135)
    r("vf.plan", 1020, 10)
    r("vf.upload", 1030, 20)
    r("vf.resunet", 1050, 50)
    x("cuda_runtime", "cudaLaunchKernel", 1052, 5, 6)
    if casts:
        r("vf.cast", 1060, 10)
    x("kernel", "sm90_xmma_fprop_cudnn", 1070, 20, 6)
    r("vf.download", 1100, 30)
    x("cuda_runtime", "cudaMemcpyAsync", 1100, 25, 7)
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1105, 10, 7)
    r("vf.stitch", 1130, 10)
    r("vf.plan", 2100, 50)
    r("vf.upload", 2100, 50)
    return ev


def _run(events, segments=(2, 1)):
    rec = trace.Record(trace.from_chrome(events), list(segments),
                       [30.0 * n for n in segments])
    window = [harness.Request([0], 0.0, 1.0, 60.0, 2, True)]
    return harness.Run(FAMILY, CFG, {}, {}, 10.0, window, 0.0, 1.0, 0, rec)


def read(name, run):
    return spec.reader(name).read(run)


@pytest.mark.parametrize("split", ["rate", "latency"])
def test_span_readers_on_known_values(split):
    run = _run(_chrome())
    # the card's copies: up 15 + down 40, down 10 (request 1's upload
    # copies nothing); 3 segments
    assert read(f"transfer_ms.{split}", run) == pytest.approx(0.065 / 3)
    # plan 40 + 20, stitch 100; plan 10, stitch 10
    assert read(f"plan_stitch_ms.{split}", run) == pytest.approx(0.180 / 3)
    assert read("weight_cast_ms.latency", run) == pytest.approx(0.080 / 3)
    assert read("rows_per_call.rate", run) == pytest.approx(1.5)


def test_transfer_counts_only_the_copies_of_the_upload_and_download():
    """A copy launched in a stage and a kernel launched in a download are
    not the transfer's."""
    ev = _chrome()
    for cat, name, ts, dur, corr in (
            ("cuda_runtime", "cudaMemcpyAsync", 210, 3, 8),
            ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 230, 5, 8),
            ("cuda_runtime", "cudaLaunchKernel", 606, 2, 9),
            ("kernel", "void at::native::elementwise_kernel", 645, 5, 9)):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": {"correlation": corr}})
    run = _run(ev)
    assert read("transfer_ms.rate", run) == pytest.approx(0.065 / 3)


def test_plan_and_stitch_are_part_of_the_pipelines_host_time():
    run = _run(_chrome())
    assert (read("plan_stitch_ms.rate", run)
            <= read("pipeline_host_ms.rate", run))


def test_no_cast_reads_zero_where_the_program_has_spans():
    assert read("weight_cast_ms.latency", _run(_chrome(casts=False))) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_programs_request_span(name):
    run = _run(_no_program_spans(), segments=(1, 1))
    assert read(name, run) is None
    run.record = None
    assert read(name, run) is None


def test_breakdown_names_gaps_by_the_programs_spans():
    gaps = dict(harness.breakdown(_run(_chrome()).record)["idle_gaps"])
    # in each download, the card idle between the call's last kernel and
    # the copy (640-660) and after the copy while the host copies
    # (700-1070, 1115-1150), each gap named by where it starts
    assert gaps["vf.download | cudaMemcpyAsync"] == pytest.approx(425e-6)
    assert gaps["vf.upload | cudaMemcpyAsync"] == pytest.approx(15e-6)
    assert gaps["vf.resunet | python"] == pytest.approx(75e-6)


def test_every_new_metric_is_in_benchmark_json():
    names = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in NEW:
        assert names[name]["source"] == "program_span"
        spec.reader(name)
