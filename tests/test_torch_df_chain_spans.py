"""The fidelity chain (dtype "df32") on the benchmark's path, on the CPU:
its tracker entry goes through build_tables_device, so a wrapper set there
sees each job's float64 peaks once, with the table equal to the bit to
the entry's own routing; its analysis's float64 half records the span
"analysis_f64" inside "analysis" (the float32 chain records none), and the
outputs are the same with and without the profiler."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpp_audio_tpu_torch.analysis import chain
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import resynth, vocoder
from cpp_audio_tpu_torch.models import resynth_bank as trb
from cpp_audio_tpu_torch.utils import profiling
from test_torch_tracing import N, SR, _bank
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

VP = vocoder.VocoderParams(sample_rate=SR)
CARRIER = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(N) / SR))


def _config(dtype: str):
    return resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0, dtype=dtype)


def _run(dtype: str = "df32", seed: int = 1):
    return chain.run_offline_chain_device(_bank(seed), N, _config(dtype), VP, CARRIER,
                                          block_size=1 << 13, device="cpu")


def _keep_calls(monkeypatch):
    """Wrap device_tracker.build_tables_device as the benchmark's harness
    does; returns the list of (freq, mag, args, kw) of its calls."""
    calls = []
    build = tdt.build_tables_device

    def keeping(freq, mag, *args, **kw):
        calls.append((freq, mag, args, kw))
        return build(freq, mag, *args, **kw)

    monkeypatch.setattr(tdt, "build_tables_device", keeping)
    return calls


@pytest.mark.parametrize("seed", [1, 2])
def test_harness_wrapper_sees_one_call_a_df_job(monkeypatch, seed):
    calls = _keep_calls(monkeypatch)
    r = _run(seed=seed)
    assert len(calls) == 1
    freq, mag, _args, _kw = calls[0]
    assert freq.dtype == mag.dtype == torch.float64
    assert freq.shape == mag.shape == (r.n_frames, _config("df32").max_voices + 1)
    assert torch.isfinite(mag).any()
    r = _run(seed=seed)
    assert len(calls) == 2


@pytest.mark.parametrize("force_scan", [False, True], ids=["routed", "frame_loop"])
def test_df_table_is_the_split_of_build_tables_device(monkeypatch, force_scan):
    """build_tables_device_df's table and dropped count equal to the bit
    split_increment of build_tables_device's on the same float64 peaks,
    and of the routing under it (_tables on a batch of one)."""
    calls = _keep_calls(monkeypatch)
    _run()
    freq, mag, args, kw = calls[0]
    kw = dict(kw, _force_scan=force_scan)
    got_t, got_d = tdt.build_tables_device_df(freq, mag, *args, **kw)
    ref_t, ref_d = tdt.build_tables_device(freq, mag, *args, **kw)
    assert got_t.dtype == torch.float64 and got_t.shape[-1] == 17
    assert torch.equal(got_t, tdt.split_increment(ref_t))
    assert int(got_d) == int(ref_d)
    kw.pop("_force_scan")
    old_t, old_d = tdt._tables(freq[None], mag[None], *args, force_scan=force_scan, **kw)
    assert torch.equal(got_t, tdt.split_increment(old_t[0]))
    assert int(got_d) == int(old_d[0])
    assert np.count_nonzero(got_t[..., trb._F_VTGT].numpy()) > 0  # some slot plays


def _recorded(dtype: str):
    first = len(profiling.SPANS)
    with profile(activities=[ProfilerActivity.CPU]):
        r = _run(dtype)
    return r, profiling.SPANS.records[first:]


@pytest.mark.parametrize("mode", ["hybrid", "ladder"])
def test_df_step_records_analysis_f64_inside_analysis(monkeypatch, mode):
    monkeypatch.setattr(chain, "DF_ANALYSIS_MODE", mode)
    _r, recs = _recorded("df32")
    f64 = [r for r in recs if r.name == "analysis_f64"]
    assert len(f64) == 1 and f64[0].parent == "analysis"
    outer = [r for r in recs if r.name == "analysis"]
    assert len(outer) == 1 and f64[0].id == outer[0].id
    assert outer[0].t0_ns <= f64[0].t0_ns and f64[0].t1_ns <= outer[0].t1_ns
    assert f64[0].counts["host_waits"] == 0
    assert profiling.SPANS.summary(len(profiling.SPANS) - len(recs))["spans"][
        "analysis_f64"]["jobs"] == 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_other_chains_record_no_analysis_f64(dtype):
    _r, recs = _recorded(dtype)
    assert "analysis" in {r.name for r in recs}
    assert "analysis_f64" not in {r.name for r in recs}


@pytest.mark.parametrize("mode", ["hybrid", "ladder"])
def test_df_outputs_equal_with_and_without_the_span(monkeypatch, mode):
    monkeypatch.setattr(chain, "DF_ANALYSIS_MODE", mode)
    plain = _run()
    traced, recs = _recorded("df32")
    assert "analysis_f64" in {r.name for r in recs}
    assert torch.equal(plain.resynth, traced.resynth)
    assert torch.equal(plain.vocoded, traced.vocoded)
    assert int(plain.dropped) == int(traced.dropped)
    assert plain.resynth.dtype == torch.float32
