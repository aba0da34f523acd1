"""Reproducible float sums on the port's chain and job paths, on the CPU.

On CUDA, a float scatter_add, index_add, accumulating index_put, sum or
mean scatter_reduce or weighted bincount adds in the order its atomics
land, and torch.cumsum of a single row runs a look-back scan whose
association depends on timing: their results differ from run to run. The
`guarded` fixture makes each of those raise on a floating-point tensor (the
cumsum when the scanned tensor has one row of more than one element), and
every path listed in PATHS runs through under it at the tests' small sizes.
Integer sums (exact in any order) and min/max reductions (order-free) stay
allowed. The card's own check, five repeats equal to the bit, is phase 15
of chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.analysis import autotune as tat
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import offline_job as toj
from cpp_audio_tpu_torch.analysis import presets_json as tpj
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.analysis import vocoder as tvocoder
from cpp_audio_tpu_torch.parallel import mesh as tmesh
from cpp_audio_tpu_torch.utils import loudness
from test_chain import _workload
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
LI = loudness.phons_to_index(60.0)


def _float(t) -> bool:
    return torch.is_tensor(t) and (t.is_floating_point() or t.is_complex())


def _one_row(t, dim) -> bool:
    """t scanned along `dim` is a single row of more than one element."""
    if t.dim() == 0:
        return False
    n = t.shape[dim]
    return n > 1 and t.numel() == n


def _cumsum_float(t, dim, dtype=None):
    return _float(t) or (dtype is not None and (dtype.is_floating_point
                                                or dtype.is_complex))


# op name -> predicate on the op's arguments: True means the op's float
# result depends on the execution order on CUDA
GUARDS = {
    "scatter_add": lambda self, dim, index, src: _float(self) or _float(src),
    "index_add": lambda self, dim, index, source, **kw: _float(self) or _float(source),
    "index_put": lambda self, indices, values, accumulate=False: (
        accumulate and (_float(self) or _float(values))),
    "scatter_reduce": lambda self, dim, index, src, reduce, **kw: (
        reduce in ("sum", "mean") and (_float(self) or _float(src))),
    "cumsum": lambda self, dim, dtype=None, **kw: (
        _cumsum_float(self, dim, dtype) and _one_row(self, dim)),
}


def _guard(name, op, check):
    def guarded_op(*args, **kwargs):
        if check(*args, **kwargs):
            raise AssertionError(f"{name} on a float tensor: its sum depends on "
                                 "the execution order on CUDA")
        return op(*args, **kwargs)
    return guarded_op


@pytest.fixture
def guarded(monkeypatch):
    """Every order-dependent float accumulation raises while a test runs."""
    for name, check in GUARDS.items():
        for owner in (torch, torch.Tensor):
            if hasattr(owner, name):
                monkeypatch.setattr(owner, name, _guard(name, getattr(owner, name), check))
        inplace = name + "_"
        if hasattr(torch.Tensor, inplace):
            monkeypatch.setattr(torch.Tensor, inplace,
                                _guard(inplace, getattr(torch.Tensor, inplace), check))
    bincount = torch.bincount
    monkeypatch.setattr(torch, "bincount", _guard(
        "bincount", bincount,
        lambda input, weights=None, minlength=0: weights is not None and _float(weights)))


# each op the fixture guards, called the way that must raise
CAUGHT = {
    "scatter_add": lambda x, i: x.scatter_add(0, i, x),
    "scatter_add_": lambda x, i: x.clone().scatter_add_(0, i, x),
    "torch.scatter_add": lambda x, i: torch.scatter_add(x, 0, i, x),
    "index_add_": lambda x, i: x.clone().index_add_(0, i, x),
    "index_add": lambda x, i: x.index_add(0, i, x),
    "index_put_": lambda x, i: x.clone().index_put_((i,), x, accumulate=True),
    "index_put": lambda x, i: x.index_put((i,), x, accumulate=True),
    "scatter_reduce_sum": lambda x, i: x.scatter_reduce(0, i, x, "sum"),
    "scatter_reduce_mean": lambda x, i: x.clone().scatter_reduce_(0, i, x, "mean"),
    "bincount": lambda x, i: torch.bincount(i, weights=x),
    "torch.cumsum": lambda x, i: torch.cumsum(x, 0),
    "Tensor.cumsum": lambda x, i: x[None].cumsum(-1),
    "cumsum_dtype": lambda x, i: torch.cumsum(i, 0, dtype=torch.float32),
}


@pytest.mark.parametrize("name", list(CAUGHT))
def test_guard_raises_on_float_accumulation(guarded, name):
    x = torch.arange(6, dtype=torch.float32)
    i = torch.tensor([0, 1, 1, 2, 0, 3])
    with pytest.raises(AssertionError, match="execution order"):
        CAUGHT[name](x, i)


def test_guard_allows_exact_and_order_free_ops(guarded):
    """Integer sums, min/max reductions and scans of several rows pass."""
    i = torch.tensor([0, 1, 1, 2, 0, 3])
    assert torch.zeros(4, dtype=torch.int64).scatter_add_(0, i, torch.ones_like(i)).sum() == 6
    x = torch.arange(6, dtype=torch.float64)
    assert float(torch.zeros(4, dtype=torch.float64).scatter_reduce(
        0, i, x, "amax").max()) == 5.0
    assert torch.cumsum(x.reshape(2, 3), dim=-1).shape == (2, 3)
    assert torch.cumsum(x[:1], 0).shape == (1,)
    assert torch.bincount(i).sum() == 6


# ---- the device tracker ----

BASE_KW = dict(stride=512, sample_rate=44100.0, max_voices=12, n_slots=32,
               nearby_distance=0.5, min_volume=1e-6, max_track_pitches=1.0,
               pitch_method=2, volume_method=1, analysis_volume=1.0,
               shift_pre=0.0, shift_post=0.0, stereo_spread=0.8,
               attack=441.0, hold=0.0, decay=800.0, sustain=0.7,
               release=2000.0)


def _cluster_peaks(seed, F=24, k=16):
    """Frequency-sorted peaks in clusters of 1-3 within a few tenths of a
    semitone (the nearby grouping sums real groups); NaN / -inf padded."""
    rng = np.random.default_rng(seed)
    freq = np.full((F, k), np.nan)
    mag = np.full((F, k), -np.inf)
    bases = rng.uniform(100, 3000, 6)
    for f in range(F):
        fs = []
        for b in bases[rng.random(6) < 0.7]:
            for _ in range(int(rng.integers(1, 4))):
                fs.append(b * 2 ** (rng.uniform(-0.3, 0.3) / 12))
        fs = np.unique(np.sort(fs))[:k]
        freq[f, :len(fs)] = fs
        mag[f, :len(fs)] = rng.uniform(-45, -8, len(fs))
    return freq, mag


def _tracker_args(dtype, F, max_voices=12):
    cap = F * max_voices + 16
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (
        loudness.PITCHES, loudness.ELVS[LI],
        np.random.default_rng(1).uniform(-1, 1, cap),
        np.random.default_rng(2).uniform(0, 2, cap)))


def _at(which, dtype):
    """Autotune keywords and arrays for 'scale' (the default major scale)
    or 'allowed' (a chord)."""
    kw = dict(use_autotune=True)
    if which == "allowed":
        kw["autotune_kwargs"] = dict(autotune_type=tat.AutotuneType.CHORD)
    kind, arrays = tchain.autotune_device_arrays(tresynth.ResynthConfig(**kw), dtype,
                                                 device="cpu")
    assert kind == which
    return dict(autotune_kind=kind, autotune_arrays=arrays, autotune_tolerance=0.4)


def _tracker(dtype, at=None, **over):
    def run():
        freq, mag = _cluster_peaks(7)
        F = freq.shape[0]
        kw = dict(BASE_KW, total_frames=F + 6, **over)
        if at is not None:
            kw.update(_at(at, dtype))
        table, dropped = tdt.build_tables_device(
            torch.as_tensor(freq, dtype=dtype), torch.as_tensor(mag, dtype=dtype),
            *_tracker_args(dtype, F), device="cpu", **kw)
        assert table.dtype == dtype and bool(torch.isfinite(table).all())
        assert np.count_nonzero(table[..., tdt._F_VTGT].numpy()) > 20
        return int(dropped)
    return run


def _tracker_df():
    freq, mag = _cluster_peaks(7)
    F = freq.shape[0]
    table, _dropped = tdt.build_tables_device_df(
        torch.as_tensor(freq), torch.as_tensor(mag), *_tracker_args(torch.float64, F),
        device="cpu", **dict(BASE_KW, total_frames=F + 6))
    assert table.shape[-1] == 17 and bool(torch.isfinite(table).all())


def _tracker_batch():
    peaks = [_cluster_peaks(s) for s in (3, 7, 11)]
    freq = torch.as_tensor(np.stack([f for f, _ in peaks]))
    mag = torch.as_tensor(np.stack([m for _, m in peaks]))
    F = freq.shape[1]
    tables, _dropped = tdt.build_tables_device_batch(
        freq, mag, *_tracker_args(torch.float64, F), device="cpu",
        **dict(BASE_KW, total_frames=F + 6))
    assert tables.shape[0] == 3 and bool(torch.isfinite(tables).all())


# ---- the chains and the jobs ----

N = 2 * SR
CARRIER = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(N) / SR))


def _device_chain(dtype):
    def run():
        bank, scfg = _workload(SR, N)
        res = tchain.run_offline_chain_device(
            interop.voicebank_from_numpy(bank), N,
            tresynth.ResynthConfig(sample_rate=SR, dtype=dtype),
            tvocoder.VocoderParams(sample_rate=SR), CARRIER,
            block_size=scfg.block_size, device="cpu")
        assert res.tracker == "device" and int(res.dropped) == 0
        assert float(res.resynth.abs().max()) > 1e-3
        assert float(res.vocoded.abs().max()) > 1e-3
    return run


def _batch_step(dtype):
    """The batched serving step: three jobs of tests/test_chain.py's
    workload, each against its own carrier."""
    def run():
        bank, scfg = _workload(SR, N)
        tbank = interop.voicebank_from_numpy(bank)
        step, _ = tchain.prepare_offline_chain_device_batch(
            [tbank] * 3, N, tresynth.ResynthConfig(sample_rate=SR, dtype=dtype),
            tvocoder.VocoderParams(sample_rate=SR),
            np.stack([CARRIER, -CARRIER, 0.5 * CARRIER]),
            block_size=scfg.block_size, device="cpu")
        stereo, voc, dropped = step()
        assert stereo.shape[0] == voc.shape[0] == 3 and not bool(dropped.any())
        assert float(stereo.abs().max()) > 1e-3 and float(voc.abs().max()) > 1e-3
    return run


def _vocoder(mode, shape):
    def run():
        t = np.arange(SR // 2) / SR
        mod = np.sin(2 * np.pi * 440.0 * t) * (1.0 + np.sin(2 * np.pi * 3.0 * t))
        p = tvocoder.VocoderParams(sample_rate=SR, modulator_window_shape=shape)
        amps = tvocoder._modulator_band_amps_fast(
            torch.as_tensor(mod, dtype=torch.float32), p.band_freqs(),
            window=p.modulator_window, stride=p.stride,
            n_frames=(len(t) - p.modulator_window) // p.stride + 1, sample_rate=SR,
            mode=mode, shape=shape)
        assert bool(torch.isfinite(amps).all()) and float(amps.max()) > 1e-3
    return run


JOB_SR = 11025


def _job(**preset_kw):
    def run():
        t = np.arange(int(0.6 * JOB_SR)) / JOB_SR
        voice = 0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 660.0 * t)
        carrier = 0.5 * np.sign(np.sin(2 * np.pi * 110.0 * t))
        preset = tpj.ResynthPreset(
            window_size_seconds=0.05, window_center_stride_seconds=0.025,
            vocoder_modulator_window_size_seconds=0.04, vocoder_stride_seconds=0.01,
            analysis_volume=1.0, vocoder_volume=0.8, voice_volume=0.3, **preset_kw)
        out = toj.run_offline(preset, voice, carrier, JOB_SR, post="limit", device="cpu")
        assert out.shape == (len(t), 2) and np.isfinite(out).all()
        assert np.abs(out).max() > 1e-3
    return run


def _sharded_chain():
    assert not dist.is_initialized()
    n = SR
    bank, scfg = _workload(SR, n)
    try:
        m = tmesh.default_mesh(device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        step = tmesh.make_sharded_chain(
            m, n, tresynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0),
            tvocoder.VocoderParams(sample_rate=SR), block_size=scfg.block_size,
            device="cpu")(interop.voicebank_from_numpy(bank), CARRIER[:n])
        stereo, voc, dropped = step()
        assert int(dropped) == 0 and float(stereo.abs().max()) > 1e-3
        assert float(voc.abs().max()) > 1e-3
    finally:
        dist.destroy_process_group()


PATHS = {
    "tracker_float32": _tracker(torch.float32),
    "tracker_float64": _tracker(torch.float64),
    "tracker_force_scan_float32": _tracker(torch.float32, _force_scan=True),
    "tracker_force_scan_float64": _tracker(torch.float64, _force_scan=True),
    "tracker_harmonize_merged": _tracker(torch.float64, harmonize_pre=7.0,
                                         harmonize_post=12.0),
    "tracker_harmonize_reference": _tracker(torch.float64, harmonize_pre=12.0,
                                            harmonize_post=-5.0,
                                            harmonize_semantics="reference"),
    "tracker_autotune_scale": _tracker(torch.float64, at="scale"),
    "tracker_autotune_allowed": _tracker(torch.float64, at="allowed", harmonize_pre=7.0),
    "tracker_autotune_scale_float32": _tracker(torch.float32, at="scale"),
    "tracker_df": _tracker_df,
    "tracker_batch": _tracker_batch,
    "device_chain_float32": _device_chain("float32"),
    "device_chain_df32": _device_chain("df32"),
    "batch_step_float32": _batch_step("float32"),
    "batch_step_float64": _batch_step("float64"),
    "vocoder_decimated_rectangular": _vocoder("decimated", "rectangular"),
    "vocoder_full_rectangular": _vocoder("full", "rectangular"),
    "vocoder_full_gaussian": _vocoder("full", "gaussian"),
    "run_offline": _job(),
    "run_offline_feedback": _job(analysis_output_feedback_gain=0.3,
                                 output_delay_seconds=0.2),
    "sharded_chain_world_1": _sharded_chain,
}


@pytest.mark.parametrize("path", list(PATHS))
def test_path_runs_without_order_dependent_sums(guarded, path):
    PATHS[path]()
