"""Each metric's reader on a small synthetic record of known values."""

import pytest

from bench_cuda import harness, spec, trace
from bench_cuda.frozen import flops, work

FAMILY = spec.family("voicefixer")
CFG = FAMILY.namespace(spec.config("voicefixer-44k-bf16"))


def _chrome():
    """Two traced requests of one segment each, in Chrome trace events (us):
    request 0 at 0-1000 with the four stage ranges, request 1 at
    1000-2000 with host work alone."""
    ev = []

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)
    x("user_annotation", "bench.request", 0, 1000)
    x("user_annotation", "vf.stft_mel", 100, 50)
    x("user_annotation", "vf.denoiser", 150, 100)
    x("user_annotation", "vf.resunet", 250, 100)
    x("user_annotation", "vf.vocoder", 350, 250)
    x("cuda_runtime", "cudaLaunchKernel", 110, 5, 1)
    x("kernel", "void stft_mel_kernel<1>(float*)", 120, 30, 1)
    x("cuda_runtime", "cudaLaunchKernel", 260, 5, 2)
    x("kernel", "sm90_xmma_fprop_cudnn", 270, 80, 2)
    x("cuda_runtime", "cudaLaunchKernel", 400, 5, 3)
    x("kernel", "void vf::chain_wgmma_kernel<2>(...)", 410, 200, 3)
    x("cuda_runtime", "cudaMemcpyAsync", 700, 100, 4)
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 700, 50, 4)
    x("cpu_op", "aten::copy_", 690, 120)
    x("user_annotation", "bench.request", 1000, 1000)
    x("cpu_op", "aten::ignored_instant", 5, 0)
    ev.append({"ph": "i", "cat": "cpu_op", "name": "instant", "ts": 3})
    return ev


@pytest.fixture
def run():
    rec = trace.Record(trace.from_chrome(_chrome()), [1, 1], [20.0, 10.0])
    window = [harness.Request([0], 0.0, 0.5, 30.0, 1, True),
              harness.Request([1], 0.5, 1.5, 30.0, 1, True),
              harness.Request([0], 1.5, 2.0, 30.0, 1, True)]
    return harness.Run(FAMILY, CFG, {}, {}, 12.5, window, 0.0, 2.0,
                       3 * 2 ** 30, rec)


def read(name, run):
    return spec.reader(name).read(run)


def test_chrome_events_become_plain_events():
    evs = trace.from_chrome(_chrome())
    kinds = [e.kind for e in evs]
    assert kinds.count("device") == 4 and kinds.count("runtime") == 4
    assert kinds.count("range") == 6 and kinds.count("op") == 2
    assert [e.start for e in evs] == sorted(e.start for e in evs)


def test_end_to_end_readers(run):
    assert read("setup_s", run) == 12.5
    assert read("audio_s_per_s", run) == pytest.approx(90.0 / 2.0)
    assert read("latency_p50_ms", run) == pytest.approx(500.0)
    assert read("latency_p95_ms", run) == pytest.approx(950.0)


def test_stage_device_time_follows_the_launch(run):
    # the stft kernel (30 us) under vf.stft_mel and the cuDNN one (80 us)
    # under vf.resunet; the chain kernel (200 us) under vf.vocoder; the
    # copy's launch lies outside every stage; two segments
    assert read("analysis_device_ms.rate", run) == pytest.approx(0.110 / 2)
    assert read("vocoder_device_ms.latency", run) == pytest.approx(
        0.200 / 2)


def test_pipeline_host_time_leaves_out_stages_and_waits(run):
    # request 0: 1000 - 500 (stages) - 100 (copy) = 400 us; request 1:
    # 1000 us of host work; two segments
    assert read("pipeline_host_ms.rate", run) == pytest.approx(1.4 / 2)


def test_idle_share_is_busy_over_the_unprofiled_wall(run):
    # busy 30 + 80 + 200 + 50 = 360 us over 2 traced segments; the
    # window's wall is 2.0 s over 3 segments
    busy = 360e-6 / 2
    assert read("device_idle_share.rate", run) == pytest.approx(
        100 * (1 - busy / (2.0 / 3)))


def test_kernels_roofline_is_least_time_over_kernel_time(run):
    # the port's kernels: stft_mel (30 us) and chain_wgmma (200 us)
    least = spec.reader("kernels_roofline.rate").least_ms(FAMILY, CFG,
                                                          [1, 1])
    assert read("kernels_roofline.rate", run) == pytest.approx(
        100 * least / 0.230)
    assert least > 0


def test_least_time_counts_weights_once_a_request():
    mod = spec.reader("kernels_roofline")
    one = mod.least_ms(FAMILY, CFG, [1])
    assert mod.least_ms(FAMILY, CFG, [1, 1]) == pytest.approx(2 * one)
    assert mod.least_ms(FAMILY, CFG, [2]) <= 2 * one


def test_mfu_and_peak_memory(run):
    per = flops.pipeline_flops(CFG, 30)
    assert per == pytest.approx(3.404e12, rel=1e-3)  # PERF.md's count
    assert read("mfu.rate", run) == pytest.approx(
        100 * 3 * per / 2.0 / work.PEAK_BF16)
    assert read("peak_alloc_gib.rate", run) == pytest.approx(3.0)


# what mfu and kernels_roofline read on the fixture's run at commit
# 8b2e38d, where both computed VoiceFixer's numbers themselves; through the
# family's hooks they read the same to the last bit
PINNED = {"voicefixer-44k-bf16": (0.5163217819243681, 2574.450314555109),
          "voicefixer-44k-fp32": (7.62152600482388, 37701.95836088254)}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_mfu_and_kernels_roofline_read_as_before_the_families(run, config):
    run.cfg = FAMILY.namespace(spec.config(config))
    mfu, roofline = PINNED[config]
    for split in ("rate", "latency"):
        assert read(f"mfu.{split}", run) == mfu
        assert read(f"kernels_roofline.{split}", run) == roofline


def test_readers_find_nothing_in_an_untraced_run(run):
    run.record = None
    for name in ("pipeline_host_ms.rate", "analysis_device_ms.rate",
                 "vocoder_device_ms.rate", "kernels_roofline.rate",
                 "device_idle_share.rate"):
        assert read(name, run) is None, name


def test_breakdown_names_groups_and_gaps(run):
    b = harness.breakdown(run.record)
    groups = dict(b["device_ops"])
    assert groups["K2/K4/K7-bf16 chain_wgmma_kernel"] == pytest.approx(
        200e-6)
    assert groups["K5 stft_mel"] == pytest.approx(30e-6)
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx((2000 - 360) / 1e6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    # the gap after the stft kernel opens inside vf.denoiser, no operator
    assert gaps["vf.denoiser | python"] == pytest.approx(120e-6)
