"""The port's batched serving step (cpp_audio_tpu_torch.analysis.chain.
prepare_offline_chain_device_batch) and the job axis of every stage it runs,
on the CPU.

Workload: 2 s at 44.1 kHz, 3 jobs of 6 notes padded to 8 voices, block
4096 (tests/test_chain.py:test_batched_chain_matches_single's jobs, one job
more), a shared 110 Hz square carrier. Configurations: the default,
bench.py's autotune row (use_autotune, MUSICAL_SCALE, bench.py:439-446) and
harmonize pre 7 + post 12 in the "merged" semantics (the device tracker's),
each in float32 and float64; every one is held against the port's single
chains, and all but float32 harmonize against JAX's batch.

Two knife-edges of the tracker (ROADMAP.md §C) shape the comparisons with
JAX. Autotune snaps every tuned pitch to an integer (semitone) pitch, so
the distance between a note and a peak it may continue is an integer too,
and at the default match threshold max_track_pitches = 1.0 it falls ON the
threshold: the last bits of each package's snap (about 1e-14 in float64)
decide the match, and with the same float64 peaks the two trackers continue
different notes. The autotune configs here take max_track_pitches = 1.5,
which decides every integer distance as 1.0 does in exact arithmetic and
leaves rounding nothing to flip. Merged harmonize in float32 flips on the
float32 rounding of the harmonized pitches (4e-3 of the peak against JAX's
batch here, the same for the single chains); it is held against JAX in
float64 and, in float32, against the port's single chains only.

Bars:
  - the batch against JAX's batch: dropped equal; resynth max|diff|/peak
    < 2e-3 and vocoded atol 1e-4 in float32 (tests/test_chain.py's bars:
    torch and XLA round float32 FFTs differently); in float64 the vocoded
    leg at atol 1e-9 and the resynth at 1e-5 of the peak: the two float64
    synths differ by ~6e-10 (the NCO word's conversion), and the tracker's
    peaks and glides carry that to < 1e-6 of the resynth's peak;
  - each job against the port's single chain: 1e-3 * peak + 1e-7 (resynth)
    and 3e-3 * peak + 1e-7 (vocoded), dropped equal (tests/test_chain.py:
    145-157, the bars the card holds too);
  - the plain voice-bank renders with a job axis against per-job calls, and
    the batched render of slot tables against per-table renders: to the
    bit (the same computation per job);
  - the batched STFT and top-k against per-row calls: to the bit (the
    CPU's FFT and sort treat each row alone at these lengths); the batched
    vocoder against per-row calls at 1e-6 of the peak: its whole-signal
    FFT of 2^17 points rounds a batch's rows differently from a single row
    (~3e-4 on values ~1e3), as may its correlation product. The
    rectangular window's band energies are box sums, differences of a
    running sum, so in float32 a quiet band's energy is that rounding
    alone, and its amplitude, the square root, magnifies it (1e-4 where
    the single row reads 0, for a single row against float64 as much as
    for the batch); the rectangular cases run in float64.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.analysis import autotune as jat
from cpp_audio_tpu.analysis import chain, resynth, vocoder
from cpp_audio_tpu.core import events, voices
from cpp_audio_tpu.models import sine_synth
from cpp_audio_tpu.ops import envelopes
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.analysis import autotune as tat
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.analysis import vocoder as tvocoder
from cpp_audio_tpu_torch.models import resynth_bank as trb
from cpp_audio_tpu_torch.models import voicebank as tvb
from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
from cpp_audio_tpu_torch.ops import dfft_hybrid as tdfft_hybrid
from cpp_audio_tpu_torch.ops import stft as tstft
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)


SR = 44100
N = 2 * SR
BLOCK = 4096
SEEDS = (1, 2, 3)
CARRIER = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(N) / SR))

HARMONIZE = dict(pitch_harmonize_pre_autotune=7.0, pitch_harmonize_post_autotune=12.0,
                 harmonize_semantics="merged")
AUTOTUNE = dict(use_autotune=True, max_track_pitches=1.5)
CONFIGS = {f"{name}_{dtype}": dict(dtype=dtype, **kw)
           for name, kw in (("default", {}), ("autotune", AUTOTUNE),
                            ("harmonize_merged", HARMONIZE))
           for dtype in ("float32", "float64")}
AGAINST_JAX = [name for name in CONFIGS if name != "harmonize_merged_float32"]


def _job_bank(seed, n_notes=6, pad_to=8):
    rng = np.random.default_rng(seed)
    notes = [events.Note(i, int(rng.uniform(0, N * 0.4)), int(rng.uniform(N * 0.5, N * 0.9)),
                         float(rng.uniform(110, 1760)), float(rng.uniform(0.3, 1.0)),
                         float(rng.uniform(-1, 1))) for i in range(n_notes)]
    sch = voices.schedule_from_notes(notes, pad_to=pad_to)
    cfg = sine_synth.SineSynthConfig(
        sample_rate=SR, block_size=BLOCK, dtype="float32",
        ahdsr=envelopes.AHDSR(attack=441, hold=0, decay=1000, release=2205,
                              sustain=0.7))
    return sine_synth.bank_from_schedule(sch, cfg)


def _configs(name):
    """(JAX ResynthConfig, the port's) for CONFIGS[name]."""
    kw = dict(sample_rate=SR, analysis_volume=1.0, **CONFIGS[name])
    if kw.get("use_autotune"):
        return (resynth.ResynthConfig(**kw, autotune_kwargs=dict(
                    autotune_type=jat.AutotuneType.MUSICAL_SCALE)),
                tresynth.ResynthConfig(**kw, autotune_kwargs=dict(
                    autotune_type=tat.AutotuneType.MUSICAL_SCALE)))
    return resynth.ResynthConfig(**kw), tresynth.ResynthConfig(**kw)


_SERVED = {}


def _served(name):
    """(the port's batch outputs as numpy, the tracker's host syncs in one
    batched step, the port's single chains) for CONFIGS[name], once per
    module."""
    if name not in _SERVED:
        _jcfg, tcfg = _configs(name)
        tbanks = [interop.voicebank_from_numpy(_job_bank(s)) for s in SEEDS]
        targs = (tcfg, tvocoder.VocoderParams(sample_rate=SR), CARRIER)
        step, _ = tchain.prepare_offline_chain_device_batch(tbanks, N, *targs,
                                                            block_size=BLOCK, device="cpu")
        syncs = tdt.HOST_SYNCS
        got = [x.numpy() for x in step()]
        syncs = tdt.HOST_SYNCS - syncs
        singles = [tchain.run_offline_chain_device(b, N, *targs, block_size=BLOCK,
                                                   device="cpu") for b in tbanks]
        _SERVED[name] = got, syncs, singles
    return _SERVED[name]


def _rel(a, b):
    peak = float(np.abs(b).max())
    assert peak > 1e-3
    return float(np.abs(a - b).max()) / peak


@pytest.mark.parametrize("name", AGAINST_JAX)
def test_batch_matches_jax(name):
    jcfg, _tcfg = _configs(name)
    step, _ = chain.prepare_offline_chain_device_batch(
        [_job_bank(s) for s in SEEDS], N, jcfg, vocoder.VocoderParams(sample_rate=SR),
        CARRIER, block_size=BLOCK)
    r_st, r_voc, r_dr = (np.asarray(x) for x in step())
    (stereo, voc, dropped), syncs, _singles = _served(name)
    assert syncs == 1  # the violation flag, read once for the batch
    assert stereo.shape == r_st.shape and voc.shape == r_voc.shape
    assert stereo.shape[0] == len(SEEDS) and stereo.shape[2] == 2
    assert stereo.dtype == voc.dtype == np.dtype(CONFIGS[name]["dtype"])
    np.testing.assert_array_equal(dropped, r_dr)
    f64 = CONFIGS[name]["dtype"] == "float64"
    for b in range(len(SEEDS)):
        assert _rel(stereo[b], r_st[b]) < (1e-5 if f64 else 2e-3)
        np.testing.assert_allclose(voc[b], r_voc[b], atol=1e-9 if f64 else 1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batch_matches_single(name):
    (stereo, voc, dropped), syncs, singles = _served(name)
    assert syncs == 1
    for b, single in enumerate(singles):
        a = single.resynth.numpy()
        assert stereo[b].shape == a.shape
        assert np.abs(a - stereo[b]).max() < 1e-3 * max(np.abs(a).max(), 1e-9) + 1e-7
        va = single.vocoded.numpy()
        assert voc[b].shape == va.shape
        assert np.abs(va - voc[b]).max() < 3e-3 * max(np.abs(va).max(), 1e-9) + 1e-7
        assert int(dropped[b]) == int(single.dropped)


@pytest.mark.parametrize("case", ["batch", "single", "df32"])
def test_step_runs_each_stage_once(monkeypatch, case):
    """One step of the batched chain, of run_offline_chain_device and of
    the fidelity chain: one voice-bank render (one kernel launch on the
    card) over every job, one analysis (an STFT and a top-k; the fidelity
    chain's hybrid peaks), one modulator pass, one carrier vocode, one call
    of the one tracker entry the step's peaks call for, with (B, F, k)
    peaks for a batch and (F, k) for a job (the fidelity chain's entry
    builds its table through one call of build_tables_device), and one
    render (of one chunk here: 2 s fits one). Each function is counted on
    its module, where the chain looks it up at each call (the benchmark's
    harness wraps the tracker's entries there to keep the peaks)."""
    calls, dims = {}, []

    def counted(mod, name):
        plain = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            if mod is tdt:
                dims.append(a[0].dim())
            return plain(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    entries = {"batch": "build_tables_device_batch", "single": "build_tables_device",
               "df32": "build_tables_device_df"}
    for mod, name in ((cv, "render_blocks"), (tstft, "_stft_sqmag"),
                      (tstft, "_top_peaks"), (tdfft_hybrid, "hybrid_peaks_df32"),
                      (tvocoder, "_modulator_band_amps_fast"),
                      (tvocoder, "_carrier_vocode"), (trb, "_render_slots"),
                      *((tdt, e) for e in entries.values())):
        counted(mod, name)
    monkeypatch.setattr(tchain, "DF_ANALYSIS_MODE", "hybrid")
    rcfg = tresynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                  dtype="df32" if case == "df32" else "float32")
    vparams = tvocoder.VocoderParams(sample_rate=SR)
    tbanks = [interop.voicebank_from_numpy(_job_bank(s)) for s in SEEDS]
    if case == "batch":
        step, _ = tchain.prepare_offline_chain_device_batch(
            tbanks, N, rcfg, vparams, CARRIER, block_size=BLOCK, device="cpu")
        stereo, voc, dropped = step()
        assert stereo.shape[0] == voc.shape[0] == dropped.shape[0] == len(SEEDS)
    else:
        r = tchain.run_offline_chain_device(tbanks[0], N, rcfg, vparams, CARRIER,
                                            block_size=BLOCK, device="cpu")
        assert r.resynth.dim() == 2 and r.vocoded.dim() == 1
    analysis = (("hybrid_peaks_df32",) if case == "df32"
                else ("_stft_sqmag", "_top_peaks"))
    tracker = ((entries["df32"], entries["single"]) if case == "df32"
               else (entries[case],))
    assert calls == dict.fromkeys(("render_blocks", *analysis, "_modulator_band_amps_fast",
                                   "_carrier_vocode", *tracker, "_render_slots"), 1)
    assert dims == [3 if case == "batch" else 2] * len(tracker)


@pytest.mark.parametrize("render", ["plain", "tiled"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_plain_job_axis_matches_per_job(render, compact):
    fn = {"plain": cv.render_blocks_plain, "tiled": cv.render_blocks_tiled_plain}[render]
    banks = [_job_bank(s) for s in SEEDS]
    tables, st = tvb.prepare_bank_arrays([interop.voicebank_from_numpy(b) for b in banks],
                                         N // 4, 2048, device="cpu")
    assert tables[0].shape == (len(SEEDS), 8, 8)
    per_job = [tvb.prepare_bank_arrays(interop.voicebank_from_numpy(b), N // 4, 2048,
                                       device="cpu")[0] for b in banks]
    if compact:  # the same row count per block for every job, so they stack
        per_job = [tvb.compact_block_args(t, st)[0] for t in per_job]
        tables = tuple(torch.stack(ts) for ts in zip(*per_job))
    out = fn(*tables, **st)
    assert out.shape == (len(SEEDS), st["n_blocks"] * 2048, 2)
    for j, t in enumerate(per_job):
        assert torch.equal(out[j], fn(*cv.one_job(t), **st)[0])
    assert float(out.abs().max()) > 0.05
    if not compact:
        blocks = tvb.voicebank_blocks_impl(*tables, **st)
        assert blocks.shape == (len(SEEDS), st["n_blocks"], 2048, 2)
        assert torch.equal(blocks.reshape(out.shape), out)


def test_batched_bound_sums_the_jobs():
    banks = [interop.voicebank_from_numpy(_job_bank(s)) for s in SEEDS]
    tables, st = tvb.prepare_bank_arrays(banks, N, BLOCK, device="cpu")
    got = cv.kernel_bound(tables[0], tables[1], n_channels=2, **st)
    per_job = [cv.kernel_bound(tables[0][j:j + 1], tables[1][j:j + 1], n_channels=2, **st)
               for j in range(len(SEEDS))]
    assert got["live_voice_samples"] == sum(p["live_voice_samples"] for p in per_job) > 0
    assert got["flops"] == sum(p["flops"] for p in per_job)
    assert got["bytes"] == sum(p["bytes"] for p in per_job)


def test_mismatched_jobs_raise():
    banks = [interop.voicebank_from_numpy(_job_bank(1)),
             interop.voicebank_from_numpy(_job_bank(2, n_notes=10, pad_to=16))]
    with pytest.raises(ValueError, match=r"\(8, 8\).*\(16, 8\)"):
        tvb.prepare_bank_arrays(banks, N, BLOCK, device="cpu")
    with pytest.raises(ValueError, match="voice tables differ"):
        tchain.prepare_offline_chain_device_batch(
            banks, N, tresynth.ResynthConfig(sample_rate=SR),
            tvocoder.VocoderParams(sample_rate=SR), CARRIER, block_size=BLOCK,
            device="cpu")
    same = banks[:1] * 3
    with pytest.raises(ValueError, match="2 carriers for 3 jobs"):
        tchain.prepare_offline_chain_device_batch(
            same, N, tresynth.ResynthConfig(sample_rate=SR),
            tvocoder.VocoderParams(sample_rate=SR), np.stack([CARRIER] * 2),
            block_size=BLOCK, device="cpu")
    with pytest.raises(ValueError):
        tchain.prepare_offline_chain_device_batch(
            same, N, tresynth.ResynthConfig(sample_rate=SR, dtype="df32"),
            tvocoder.VocoderParams(sample_rate=SR), CARRIER, block_size=BLOCK,
            device="cpu")


def _mono_batch(dtype):
    """The three jobs' mono mixdowns (plain render), (3, N)."""
    banks = [interop.voicebank_from_numpy(_job_bank(s)) for s in SEEDS]
    tables, st = tvb.prepare_bank_arrays(banks, N, BLOCK, dtype, device="cpu")
    return tchain._synth_mono(*tables, n=N, **st)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_stft_and_peaks_match_rows(dtype):
    rcfg = tresynth.ResynthConfig(sample_rate=SR, dtype=dtype)
    mono = _mono_batch(dtype)
    assert mono.shape == (len(SEEDS), N) and mono.dtype == getattr(torch, dtype)
    window = torch.as_tensor(tstft.gaussian_window(rcfg.window_size), dtype=mono.dtype)
    fft_len = tstft.fft_length_for(rcfg.window_size)
    kw = dict(window_size=rcfg.window_size, stride=rcfg.stride, fft_length=fft_len)
    sq = tstft._stft_sqmag(mono, window, **kw)
    freq, mag = tstft._top_peaks(sq, sample_rate=SR, fft_length=fft_len, k=128)
    assert freq.shape == mag.shape == (len(SEEDS), sq.shape[1], 128)
    for b in range(len(SEEDS)):
        sq_b = tstft._stft_sqmag(mono[b], window, **kw)
        assert torch.equal(sq[b], sq_b)
        f_b, m_b = tstft._top_peaks(sq_b, sample_rate=SR, fft_length=fft_len, k=128)
        assert torch.equal(freq[b], f_b) and torch.equal(mag[b], m_b)
    # the contract the tracker reads: -inf padding after the finite peaks
    fin = torch.isfinite(mag)
    assert bool(fin.any()) and bool((fin[..., :-1] | ~fin[..., 1:]).all())


@pytest.mark.parametrize("mode,shape", [("decimated", "gaussian"),
                                        ("decimated", "rectangular"),
                                        ("full", "gaussian"),
                                        ("full", "rectangular")])
def test_batched_vocoder_matches_rows(mode, shape):
    p = tvocoder.VocoderParams(sample_rate=SR, modulator_window_shape=shape)
    dtype = torch.float64 if shape == "rectangular" else torch.float32
    mono = _mono_batch(str(dtype).removeprefix("torch."))
    n_frames = (N - p.modulator_window) // p.stride + 1
    kw = dict(window=p.modulator_window, stride=p.stride, n_frames=n_frames,
              sample_rate=SR, mode=mode, shape=shape)
    amps = tvocoder._modulator_band_amps_fast(mono, p.band_freqs(), **kw)
    assert amps.shape == (len(SEEDS), n_frames, len(p.band_freqs()) - 1)
    rows = [tvocoder._modulator_band_amps_fast(mono[b], p.band_freqs(), **kw)
            for b in range(len(SEEDS))]
    peak = max(float(r.abs().max()) for r in rows)
    assert peak > 1e-3
    for b, r in enumerate(rows):
        assert float((amps[b] - r).abs().max()) <= 1e-6 * peak
    S = p.stride
    car_fft = tstft.fft_length_for(2 * S)
    bm = torch.as_tensor(tvocoder._band_matrix(p.band_freqs(), car_fft // 2 + 1, SR / car_fft),
                         dtype=dtype)
    idx = torch.as_tensor(tvocoder.modulator_alignment_rows(N, p, n_frames))
    own = torch.as_tensor(np.stack([CARRIER, -CARRIER, 0.5 * CARRIER]), dtype=dtype)
    for carrier in (own, own[0]):  # per-job carriers, and one shared
        voc = tvocoder._carrier_vocode(carrier, amps[:, idx], bm, stride=S, fft_len=car_fft)
        for b, r in enumerate(rows):
            one = tvocoder._carrier_vocode(carrier[b] if carrier.dim() == 2 else carrier,
                                           r[idx], bm, stride=S, fft_len=car_fft)
            assert voc[b].shape == one.shape
            assert float((voc[b] - one).abs().max()) <= 1e-6 * float(one.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fields", [16, 17])
def test_batched_render_slots_matches_tables(monkeypatch, dtype, fields):
    """Three tables of tracked notes rendered as one batch against one by
    one, with a chunk budget that splits the frames into several passes."""
    rcfg = trb.TrackedRenderConfig(sample_rate=SR, stride=441)
    tables = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        notes = [trb.TrackedNote(
            frames=[(f0, float(rng.uniform(110, 1760)), float(rng.uniform(0.1, 0.5))),
                    (f0 + 5, float(rng.uniform(110, 1760)), float(rng.uniform(0.1, 0.5)))],
            release_frame=f0 + int(rng.integers(8, 20)), pan=float(rng.uniform(-1, 1)))
            for f0 in rng.integers(0, 20, 10)]
        tables.append(trb._build_slot_tables(notes, 40, rcfg))
    table = torch.as_tensor(np.stack(tables))
    if fields == 17:
        table = tdt.split_increment(table)
    monkeypatch.setattr(trb, "_RENDER_CHUNK_ELEMS", 7 * rcfg.n_slots * rcfg.stride)
    out = trb._render_slots(table, stride=rcfg.stride, dtype=dtype)
    assert out.shape == (len(SEEDS), 40, rcfg.stride, 2)
    assert float(out.abs().max()) > 1e-3
    for b in range(len(SEEDS)):
        assert torch.equal(out[b], trb._render_slots(table[b], stride=rcfg.stride,
                                                     dtype=dtype))
