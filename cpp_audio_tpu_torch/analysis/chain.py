"""Offline chain: synth -> analysis peaks -> tracker -> resynthesis, and the
vocoder of the synth's mixdown.

    voice-bank blocks (CUDA kernel) -> mono mixdown -> sliding Gaussian STFT
    -> top-k peaks -> tracker -> slot table -> tracked-note render; and,
    from the same mixdown, the O(n) vocoder against a carrier.

Port of cpp_audio_tpu/analysis/chain.py, with its two trackers:
  * run_offline_chain (:255-324): the (frames, k) peaks cross to the host
    tracker — the native table packer (C++ pitchpipe_run_offline) when the
    library is available and the draws are sequential, with reference
    harmonize semantics; the Python tracker otherwise — and the slot table
    crosses back;
  * the single-dispatch chain (prepare_offline_chain_device, :453-592;
    run_offline_chain_device, :716-736; resynthesize_signal_device,
    :751-815; prepare_offline_chain_device_batch, :818-936): the device
    tracker (analysis/device_tracker.py) builds the table where the peaks
    are, so nothing crosses to the host but, off the card, the tracker's
    violation flag, and at the end the outputs: run_offline_chain_device
    and the batched step() return host tensors, as the JAX package's
    single chain returns numpy (:739-748).
    Eager PyTorch dispatches op by op; "single dispatch" names the JAX
    program this mirrors, not a property of the port.
The single-dispatch chain has two variants, as in the JAX package: the
float32 (or float64) chain, and the fidelity chain (dtype "df32", JAX's
_fused_single_dispatch_df, :404): synth and vocoder float32, double-grade
analysis peaks, the device tracker and the render's phase advance at float64.
The JAX package carries those double-grade values as df32 (hi, lo) pairs
because the TPU has no float64; here they are float64 inside.
One step (`_step`) runs both variants, for one job or for a batch of jobs
on a leading axis, which every stage's op takes; the variants differ only
in the analysis (`_peaks`) and in the tracker's entry (`_track`).

Spans (utils/profiling.span): a "chain" span around each
run_offline_chain(_device) call and each batched step(), a "staging" span
around the staging of a step's arguments, a span per stage (STAGES)
around its work, and an "outputs" span around the delivery of
run_offline_chain_device's and the batched step()'s outputs to the host
(_to_host); `timings=` reads the stages' spans (profiling.timed).

Reference scope: RtResynth's offline job loop (source/rt.resynth.lib.cpp:
1185-1235 — input -> analysis -> resynth synth + vocoder).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import dtype_of
from ..models import resynth_bank, voicebank
from ..ops import dfft_hybrid
from ..ops import stft as stft_ops
from ..utils import profiling
from ..utils.profiling import span, timed
from . import autotune as at
from . import device_tracker
from . import resynth as resynth_mod
from . import vocoder as vocoder_mod

# the fidelity chain's analysis: "hybrid" (float32 peak selection, float64
# values at the selected bins, ops/dfft_hybrid.py) or "ladder" (float64
# spectrum, selection and values, ops/stft._top_peaks_df). The JAX
# package's environment override (chain.py:38), read at import as there.
DF_ANALYSIS_MODE = os.environ.get("CPP_AUDIO_DF_ANALYSIS", "hybrid")

# the chain's stage spans, in their order: the keys of `timings=`
STAGES = ("synth", "analysis", "vocoder", "tracker", "render")

# Outputs delivered to the host through pinned buffers (_to_host): three a
# job or batch on a CUDA device, none elsewhere; a span counter
PINNED_OUTPUTS = 0
profiling.COUNTERS["pinned_outputs"] = lambda: PINNED_OUTPUTS


@dataclass
class OfflineChainResult:
    resynth: torch.Tensor   # (samples, 2) stereo resynthesis
    vocoded: torch.Tensor   # (m,) vocoder mix of the mixdown
    n_frames: int
    tracker: str = "native"  # which tracker built the slot table
    dropped: object = 0     # dropped-NoteOn count (a host scalar tensor on the device path)


def _synth_dtype(rconfig) -> str:
    """The synth's, the vocoder's and the render's output dtype: float32 in
    the fidelity chain (JAX chain.py:126-136, :149-158), else the config's."""
    return "float32" if rconfig.dtype == "df32" else rconfig.dtype


def _stage_analyze_vocode(bank, n_samples: int,
                          rconfig: resynth_mod.ResynthConfig,
                          vparams: vocoder_mod.VocoderParams, carrier,
                          block_size: int, dev, mod_mode=None):
    """The synth, analysis and vocoder legs' tensors on `dev` and their
    static keywords: (bank_args, av_args, av_kw) for
    `_analyze_vocode(*bank_args, *av_args, **av_kw)`. mod_mode: the
    vocoder's modulator path (vocoder._modulator_band_amps_fast's mode).
    `bank` may be a list of VoiceBanks: a batch of jobs, every voice table
    with a leading job axis (voicebank.prepare_bank_arrays)."""
    bank_args, statics = voicebank.prepare_bank_arrays(
        bank, n_samples, block_size, _synth_dtype(rconfig), device=dev)
    av_args, av_kw = _analyze_vocode_inputs(n_samples, rconfig, vparams,
                                            carrier, dev, mod_mode)
    return bank_args, av_args, dict(av_kw, **statics)


def _analyze_vocode_inputs(n_samples: int, rconfig: resynth_mod.ResynthConfig,
                           vparams: vocoder_mod.VocoderParams, carrier, dev,
                           mod_mode=None):
    """The analysis and vocoder legs' tensors on `dev` and their static
    keywords. The tensors are (window, carrier, band matrix, modulator
    rows); the fidelity chain's are (window, unit-sine scale, carrier, band
    matrix, rows), with the analysis window and its scale (2 / sum(w))^2
    float64 (JAX chain.py:515-518) and the rest float32, and its keyword
    df_mode is the analysis mode DF_ANALYSIS_MODE (None elsewhere)."""
    vdt = dtype_of(_synth_dtype(rconfig))
    sr = rconfig.sample_rate
    S = vparams.stride
    W = vparams.modulator_window
    car_fft = stft_ops.fft_length_for(2 * S)
    edges = vparams.band_freqs()
    n_mod_frames = max(0, (n_samples - W) // S + 1)
    w = stft_ops.gaussian_window(rconfig.window_size, sigmas=4.0)
    if rconfig.dtype == "df32":
        f64 = torch.float64
        analysis = (torch.as_tensor(w, dtype=f64, device=dev),
                    torch.tensor((2.0 / float(np.sum(w))) ** 2, dtype=f64,
                                 device=dev))
    else:
        analysis = (torch.as_tensor(w, dtype=vdt, device=dev),)
    bm_car = torch.as_tensor(
        vocoder_mod._band_matrix(edges, car_fft // 2 + 1, sr / car_fft),
        dtype=vdt, device=dev)
    rows = torch.as_tensor(
        vocoder_mod.modulator_alignment_rows(n_samples, vparams, n_mod_frames),
        device=dev)
    car = torch.as_tensor(np.asarray(carrier), dtype=vdt,
                          device=dev)[..., :n_samples]
    av_kw = dict(n=n_samples, window_size=rconfig.window_size,
                 stride=rconfig.stride,
                 fft_len=stft_ops.fft_length_for(rconfig.window_size),
                 k=rconfig.max_voices + 1, sample_rate=sr, mod_window=W,
                 voc_stride=S, car_fft=car_fft, n_mod_frames=n_mod_frames,
                 vol_mod=float(vparams.volume_modulator),
                 vol_car=float(vparams.volume_carrier),
                 vol_voc=float(vparams.volume_vocoded),
                 edges=tuple(float(e) for e in edges), mod_mode=mod_mode,
                 mod_shape=vparams.modulator_window_shape,
                 df_mode=DF_ANALYSIS_MODE if rconfig.dtype == "df32" else None)
    return (*analysis, car, bm_car, rows), av_kw


def _synth_mono(fp, ip, up, gains, codes, *, n: int, block_size: int,
                n_blocks: int) -> torch.Tensor:
    """Synth render (dense tables: the kernel picks each tile's live rows
    itself) -> mono mixdown of its first n samples, (n,); tables with a
    leading job axis render every job in one launch -> (B, n)."""
    out = voicebank.voicebank_blocks_impl(fp, ip, up, gains, codes,
                                          block_size=block_size,
                                          n_blocks=n_blocks)
    return out.reshape(*out.shape[:-3], -1, out.shape[-1])[..., :n, :].sum(dim=-1)


def _vocode_mix(mono, carrier, bm_car, rows, *, sample_rate: int,
                mod_window: int, voc_stride: int, car_fft: int,
                n_mod_frames: int, vol_mod: float, vol_car: float,
                vol_voc: float, edges: tuple, mod_mode=None,
                mod_shape: str = "gaussian"):
    """The vocoder of the mixdown against the carrier, mixed with both;
    mod_mode selects the modulator path (None: "decimated"). A batch: mono
    (B, n) against a per-job (B, n) or a shared (n,) carrier -> (B, m)."""
    amps = vocoder_mod._modulator_band_amps_fast(
        mono, edges, window=mod_window, stride=voc_stride,
        n_frames=n_mod_frames, sample_rate=sample_rate, mode=mod_mode,
        shape=mod_shape)
    vocoded = vocoder_mod._carrier_vocode(carrier, amps[..., rows, :], bm_car,
                                          stride=voc_stride, fft_len=car_fft)
    out_len = vocoded.shape[-1]
    return (vol_voc * vocoded + vol_mod * mono[..., :out_len]
            + vol_car * carrier[..., :out_len])


def _peaks(mono, window, scale=None, *, window_size: int, stride: int,
           fft_len: int, k: int, sample_rate: int, df_mode=None):
    """The STFT top-k peaks (freq, mag_db) of a mono signal, (F, k). With
    df_mode None: stft._stft_sqmag and _top_peaks in the window's dtype,
    (B, F, k) for a (B, n) batch. Else the fidelity chain's double-grade
    peaks (JAX chain.py:104), float64 inside, from a float64 window and its
    scale (2 / sum(window))^2 (0-d): df_mode "hybrid" selects peaks from
    the float32 rfft spectrum and evaluates the selected bins in float64
    (ops/dfft_hybrid.hybrid_peaks_df32); "ladder" selects and evaluates on
    the float64 spectrum (ops/stft.ladder_peaks_df). Either mode's float64
    work runs in the span "analysis_f64", inside "analysis"."""
    if df_mode is None:
        sq = stft_ops._stft_sqmag(mono, window, window_size=window_size,
                                  stride=stride, fft_length=fft_len)
        return stft_ops._top_peaks(sq, sample_rate=sample_rate,
                                   fft_length=fft_len, k=k)
    if df_mode == "hybrid":
        return dfft_hybrid.hybrid_peaks_df32(
            mono, window, scale, window_size=window_size, stride=stride,
            fft_length=fft_len, sample_rate=sample_rate, k=k)
    if df_mode == "ladder":
        n_frames = max(0, (mono.shape[-1] - window_size) // stride + 1)
        frames = stft_ops.frame_signal(mono, window_size, stride, n_frames)
        return stft_ops.ladder_peaks_df(frames, window, scale,
                                        sample_rate=sample_rate,
                                        fft_length=fft_len, k=k)
    raise ValueError(f"unknown df analysis mode {df_mode!r}")


def _analyze_vocode(fp, ip, up, gains, codes, *args, n: int, block_size: int,
                    n_blocks: int, window_size: int, stride: int, fft_len: int,
                    k: int, df_mode=None, **voc_kw):
    """Synth -> mono mixdown -> STFT top-k peaks, and the vocoder of the
    mixdown (JAX chain.py:46-95, :104), in the spans "synth", "analysis"
    and "vocoder". args: the analysis tensors (_peaks' window, or window and
    scale), carrier, band matrix, modulator rows (_analyze_vocode_inputs).
    Returns (freq, mag_db, vocoder mix); the fidelity chain's synth and
    vocoder run in float32, its peaks are float64. Tables with a leading
    job axis run B jobs as one batch: one kernel launch, one batched STFT
    and top-k, one batched vocoder -> (B, F, k) peaks and (B, m) mixes."""
    *analysis, carrier, bm_car, rows = args
    dev = fp.device
    with span("synth", dev):
        mono = _synth_mono(fp, ip, up, gains, codes, n=n, block_size=block_size,
                           n_blocks=n_blocks)
    with span("analysis", dev):
        freq, mag = _peaks(mono, *analysis, window_size=window_size,
                           stride=stride, fft_len=fft_len, k=k,
                           sample_rate=voc_kw["sample_rate"], df_mode=df_mode)
    with span("vocoder", dev):
        mix = _vocode_mix(mono, carrier, bm_car, rows, **voc_kw)
    return freq, mag, mix


def _host_table(freq, mag, rconfig, n_frames: int, rcfg):
    """The host tracker's (n_frames + 8, n_slots, 16) slot table of host
    (frames, k) peaks, and which tracker built it: the native table packer
    when the library is available, the draws are sequential and the
    harmonize semantics are the reference's (or harmonize is off); the
    Python tracker otherwise (JAX chain.py:305-322)."""
    from .. import native as nat

    native_sem_ok = (rconfig.harmonize_semantics == "reference"
                     or (rconfig.pitch_harmonize_pre_autotune == 0.0
                         and rconfig.pitch_harmonize_post_autotune == 0.0))
    if nat.available() and rconfig.draw_indexing != "stable" and native_sem_ok:
        return resynth_mod.build_tables_native(freq, mag, rconfig,
                                               n_frames + 8, rcfg), "native"
    peaks = stft_ops.top_peaks_to_lists(freq, mag)
    notes, _stats, _dropped = resynth_mod.track(peaks, rconfig,
                                                prefer_native=False)
    return resynth_bank._build_slot_tables(notes, n_frames + 8, rcfg), "python"


def _host_chain_front(bank, n_samples, rconfig, vparams, carrier, block_size,
                      dev):
    """Synth, analysis and vocoder on `dev`, then the host tracker's table
    (the span "tracker": the peaks to the host and the table):
    (table, tracker name, n_frames, vocoder mix)."""
    if rconfig.dtype == "df32":
        raise ValueError("the host-tracker chain runs float32 or float64; the "
                         "fidelity chain (dtype 'df32') is "
                         "run_offline_chain_device")
    with span("staging", dev):
        bank_args, av_args, av_kw = _stage_analyze_vocode(
            bank, n_samples, rconfig, vparams, carrier, block_size, dev)
    freq, mag, mix = _analyze_vocode(*bank_args, *av_args, **av_kw)
    with span("tracker", dev):
        freq_h = freq.cpu().numpy()
        n_frames = int(freq_h.shape[0])
        table, tracker = _host_table(freq_h, mag.cpu().numpy(), rconfig, n_frames,
                                     resynth_mod._render_config(rconfig))
    return table, tracker, n_frames, mix


def run_offline_chain(bank: voicebank.VoiceBank, n_samples: int,
                      rconfig: resynth_mod.ResynthConfig,
                      vparams: vocoder_mod.VocoderParams, carrier,
                      *, block_size: int = 1 << 15, device="cuda",
                      timings: dict | None = None) -> OfflineChainResult:
    """Render `bank`, resynthesize its mono mixdown with the HOST tracker,
    and vocode it, on `device`. The synth leg renders the dense (V, ·)
    voice tables through ops/cuda_voicebank.render_blocks: the CUDA kernel
    for CUDA tensors, which picks each sample tile's live rows itself, so
    no per-block compaction (and no host round trip of the tables)
    precedes it.

    timings: when a dict is given, the device is synchronised after each
    stage and the stage's wall seconds are stored under "synth",
    "analysis", "vocoder", "tracker" and "render", each from the end of
    the one before ("synth" from the call's start, so it includes staging
    the arguments; a measurement aid: the synchronisations cost overlap,
    so time the chain without it). The call is one "chain" span."""
    dev = torch.device(device)
    with span("chain", dev), timed(timings, dev, STAGES):
        table, tracker, n_frames, mix = _host_chain_front(
            bank, n_samples, rconfig, vparams, carrier, block_size, dev)
        with span("render", dev):
            stereo = resynth_bank.render_table(
                table, resynth_mod._render_config(rconfig), device_out=True,
                device=dev)
    return OfflineChainResult(resynth=stereo, vocoded=mix, n_frames=n_frames,
                              tracker=tracker)


def host_chain_table(bank: voicebank.VoiceBank, n_samples: int,
                     rconfig: resynth_mod.ResynthConfig,
                     vparams: vocoder_mod.VocoderParams, carrier,
                     *, block_size: int = 1 << 15, device="cuda") -> np.ndarray:
    """The host pipeline's (total_frames, n_slots, 16) slot table for a
    workload, as float64 numpy: synth -> analysis peaks -> host tracker
    (the front of run_offline_chain without the render; JAX chain.py:661).
    The note-level reference of the fidelity chain (tools/note_metrics.py)
    at dtype "float64"."""
    table, _tracker, _n, _mix = _host_chain_front(
        bank, n_samples, rconfig, vparams, carrier, block_size,
        torch.device(device))
    return np.asarray(table, np.float64)


def autotune_device_arrays(rconfig, dtype=torch.float32, *, device="cuda"):
    """Numeric autotune tables as tensors for the device tracker:
    (root (), scale (8,), equidistant (7,), allowed (A,)). Zeros for the
    unused kind (analysis/autotune.autotune_tables provides the values,
    reference rt.resynth.lib.autotune.cpp:89-142 / rt.resynth.lib.cpp:
    1761-1873). Returns (kind, arrays)."""
    tables = at.autotune_tables(use_autotune=rconfig.use_autotune,
                                **rconfig.autotune_kwargs)
    root, scale, equid, allowed = device_tracker.default_autotune_arrays(
        dtype, device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,  # noqa: E731
                                     device=device)
    if tables["kind"] == "scale":
        root = as_t(tables["root_pitch"])
        scale = as_t(tables["scale"])
        equid = as_t(tables["equidistant"])
    elif tables["kind"] == "allowed":
        allowed = as_t(tables["allowed"])
    return tables["kind"], (root, scale, equid, allowed)


def autotune_device_arrays_df(rconfig, *, device="cuda"):
    """The fidelity tracker's autotune tables (JAX chain.py:162, there as
    df32 (hi, lo) pairs): autotune_device_arrays at float64. Returns
    (kind, float64 tensors)."""
    return autotune_device_arrays(rconfig, torch.float64, device=device)


def tracker_config_kwargs(rconfig, rcfg) -> dict:
    """The device tracker's config-derived keywords (shared by every
    device-tracker path; the context-dependent total_frames / stride /
    sample_rate keys are supplied by each caller)."""
    a = rcfg.ahdsr
    at_kind = at.autotune_tables(use_autotune=rconfig.use_autotune,
                                 **rconfig.autotune_kwargs)["kind"]
    return dict(
        harmonize_pre=rconfig.pitch_harmonize_pre_autotune,
        harmonize_post=rconfig.pitch_harmonize_post_autotune,
        harmonize_semantics=rconfig.harmonize_semantics,
        draw_indexing=rconfig.draw_indexing,
        autotune_kind=at_kind,
        autotune_max_pitch=rconfig.autotune_max_pitch,
        autotune_tolerance=rconfig.autotune_tolerance_pitches,
        max_voices=rconfig.max_voices, n_slots=rcfg.n_slots,
        nearby_distance=rconfig.nearby_distance_tones,
        min_volume=rconfig.min_volume,
        max_track_pitches=rconfig.max_track_pitches,
        pitch_method={"INTERVAL_CENTER": 0, "MAX_VOLUME": 1,
                      "PONDERATE_BY_VOLUME": 2}[rconfig.pitch_method.name],
        volume_method={"MAX_VOLUME": 0, "SUM_VOLUMES": 1}[
            rconfig.volume_method.name],
        analysis_volume=rconfig.analysis_volume,
        shift_pre=rconfig.pitch_shift_pre_autotune,
        shift_post=rconfig.pitch_shift_post_autotune,
        stereo_spread=rconfig.stereo_spread,
        attack=float(np.max(np.asarray(a.attack))),
        hold=float(np.max(np.asarray(a.hold))),
        decay=float(np.max(np.asarray(a.decay))),
        sustain=float(np.asarray(a.sustain)),
        release=float(np.max(np.asarray(a.release))))


def _device_dtype(rconfig) -> torch.dtype:
    """The device tracker's working dtype: float64 in the fidelity chain
    (the JAX package's df32 pairs), else the config's."""
    return torch.float64 if rconfig.dtype == "df32" else dtype_of(rconfig.dtype)


def _n_frames(n_samples: int, rconfig) -> int:
    return max(0, (n_samples - rconfig.window_size) // rconfig.stride + 1)


def _tracker_inputs(rconfig, rcfg, n_frames: int, draws, wdt, dev):
    """The device tracker's arrays on `dev` (loudness pitches, loudness SPL
    at 60 phon, pan pool, phase pool) and its keywords, autotune arrays
    included, for n_frames analysis frames. The pools go as float32 (the
    tracker casts them to its working dtype), as in JAX chain.py:525-526,
    :568-569; draws=None takes the pools that match the host tracker's RNG
    sequence. It readies the tracker for `dev` (device_tracker.ready: on a
    CUDA device the frame-loop kernel's library is loaded here), so that no
    build or load lands inside a job whose tracker takes the exact frame
    loop."""
    from ..utils import loudness

    device_tracker.ready(dev)
    if draws is None:
        draws = resynth_mod.draw_pools(rconfig,
                                       n_frames * rconfig.max_voices + 16)
    li = loudness.phons_to_index(60.0)
    arrays = (
        torch.as_tensor(np.asarray(loudness.PITCHES), dtype=wdt, device=dev),
        torch.as_tensor(np.asarray(loudness.ELVS[li]), dtype=wdt, device=dev),
        *(torch.as_tensor(np.asarray(d), dtype=torch.float32, device=dev)
          for d in draws))
    _kind, at_arrays = autotune_device_arrays(rconfig, wdt, device=dev)
    return arrays, _tracker_call_kwargs(rconfig, rcfg, n_frames, at_arrays)


def _tracker_call_kwargs(rconfig, rcfg, n_frames: int, at_arrays) -> dict:
    """build_tables_device's keywords for n_frames analysis frames and the
    8-frame render tail (JAX chain.py:336-355)."""
    return dict(total_frames=n_frames + 8, stride=rcfg.stride,
                sample_rate=float(rconfig.sample_rate),
                autotune_arrays=at_arrays,
                **tracker_config_kwargs(rconfig, rcfg))


def _track(freq, mag, tracker_args, tr_kw: dict, rconfig):
    """The device tracker's (table, dropped) of the peaks: (B, F, k) go to
    build_tables_device_batch, (F, k) to build_tables_device_df in the
    fidelity chain (which builds its table through build_tables_device)
    and to build_tables_device otherwise. The entry is looked up on
    device_tracker at each call, so that a wrapper set there (the
    benchmark's harness keeps the peaks through one) sees every call."""
    if freq.dim() == 3:
        build = device_tracker.build_tables_device_batch
    elif rconfig.dtype == "df32":
        build = device_tracker.build_tables_device_df
    else:
        build = device_tracker.build_tables_device
    return build(freq, mag, *tracker_args, device=freq.device, **tr_kw)


def _step(bank_args, av_args, tracker_args, *, av_kw: dict, tr_kw: dict,
          rconfig, emit: str = "render"):
    """The whole offline chain on the device, for one job or for a batch of
    jobs on a leading axis: synth -> peaks -> device tracker -> tracked-note
    render, plus the vocoder (JAX chain.py:358-394; the fidelity chain's,
    :404), in the five stages' spans. Returns (framed stereo (..., F, S, 2),
    vocoder mix, dropped) tensors. The fidelity chain (dtype "df32") tracks
    into a 17-field float64 table and renders it to float32 with the phase
    advance in float64; its emit="table" returns the (total_frames,
    n_slots, 17) table in place of the render (the note-level metric's
    input), with no render span."""
    freq, mag, mix = _analyze_vocode(*bank_args, *av_args, **av_kw)
    with span("tracker", freq.device):
        table, dropped = _track(freq, mag, tracker_args, tr_kw, rconfig)
    if emit == "table":
        return table, mix, dropped
    # (F, S, 2): the JAX program's channel-major (2, F, S) was a TPU layout
    with span("render", table.device):
        out = resynth_bank._render_slots(table, stride=tr_kw["stride"],
                                         dtype=_synth_dtype(rconfig))
    return out, mix, dropped


def prepare_offline_chain_device(bank: voicebank.VoiceBank, n_samples: int,
                                 rconfig: resynth_mod.ResynthConfig,
                                 vparams: vocoder_mod.VocoderParams, carrier,
                                 *, block_size: int = 1 << 15, draws=None,
                                 mod_mode=None, emit: str = "render",
                                 device="cuda"):
    """Stage the device-resident arguments of the single-dispatch chain on
    `device` (the span "staging") and return (step, n_frames): `step()`
    runs synth -> STFT -> peaks -> device tracker -> render + vocoder over
    them, in the five stages' spans, and returns (stereo framed (F, S, 2),
    vocoder mix, dropped) tensors; the one device value it reads on the
    host, off the card, is the tracker's violation flag (on the card the
    frame-loop kernel builds the table and nothing is read). Call step()
    back to back to serve; flatten with assemble_framed_stereo.

    dtype "df32" stages the fidelity chain (in the analysis mode
    DF_ANALYSIS_MODE); its emit="table" returns the slot table in place of
    the render (JAX chain.py:436-439).
    draws: optional (pan_draws, phase_draws) pools; defaults to the numpy
    pools matching the host tracker's RNG sequence. mod_mode: the vocoder's
    modulator path, "decimated" (None, the default) or "full" (JAX
    chain.py:457).
    """
    dev = torch.device(device)
    df = rconfig.dtype == "df32"
    if emit not in ("render", "table") or (emit == "table" and not df):
        raise ValueError(f"emit={emit!r}: 'table' is the fidelity chain's "
                         "(dtype 'df32')")
    n_frames = _n_frames(n_samples, rconfig)
    with span("staging", dev):
        bank_args, av_args, av_kw = _stage_analyze_vocode(
            bank, n_samples, rconfig, vparams, carrier, block_size, dev,
            mod_mode)
        tracker_args, tr_kw = _tracker_inputs(
            rconfig, resynth_mod._render_config(rconfig), n_frames, draws,
            _device_dtype(rconfig), dev)

    def step():
        return _step(bank_args, av_args, tracker_args, av_kw=av_kw,
                     tr_kw=tr_kw, rconfig=rconfig, emit=emit)

    def cost_analysis():
        """The operations, bytes and transcendental evaluations one step()
        needs, stage by stage, in bench.py's keys (analysis/cost.py: the
        conventions, and step_cost: the keys). A measurement aid, as the
        JAX package's `.lower().compile()` is: it runs the front of the
        step once (synth -> analysis -> tracker, with the tracker's own
        read of its violation flag where it tries the frame-parallel
        path), copies the voice tables to the host
        (cuda_voicebank.kernel_bound counts there) and reads the run's
        data-dependent counts in one synchronisation."""
        return _step_cost(bank_args, av_args, tracker_args, av_kw=av_kw,
                          tr_kw=tr_kw, rconfig=rconfig, emit=emit)

    step.cost_analysis = cost_analysis
    if df:
        def compiled_text():
            """The ATen ops one step() dispatches, one per line, recorded
            over a run (the port compiles no program: this is what a step
            runs; the JAX package returns its compiled program's text)."""
            return "\n".join(dispatched_ops(step))

        step.compiled_text = compiled_text
    return step, n_frames


def dispatched_ops(run) -> list[str]:
    """The ATen ops (views included) that run() dispatches, in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record():
        run()
    return ops


def _step_cost(bank_args, av_args, tracker_args, *, av_kw: dict, tr_kw: dict,
               rconfig, emit: str) -> dict:
    """cost_analysis of a prepared chain step (see there)."""
    from . import cost

    loops = device_tracker.FRAME_LOOPS
    freq, mag, mix = _analyze_vocode(*bank_args, *av_args, **av_kw)
    table, _dropped = _track(freq, mag, tracker_args, tr_kw, rconfig)
    path = ("frame loop" if device_tracker.FRAME_LOOPS > loops
            else "frame-parallel")
    render_dtype = _synth_dtype(rconfig)
    data = cost.tracker_data(freq, mag, table, path=path,
                             stride=tr_kw["stride"], render_dtype=render_dtype,
                             loudness_points=int(tracker_args[0].shape[0]))
    n, S = av_kw["n"], tr_kw["stride"]
    n_fields = table.shape[-1]
    table_f64 = table.dtype == torch.float64
    fp, ip, _up, gains = bank_args[:4]
    stages = dict(
        synth=cost.synth(fp, ip, block_size=av_kw["block_size"],
                         n_blocks=av_kw["n_blocks"],
                         n_channels=int(gains.shape[-1])),
        analysis=cost.analysis(
            n, n_channels=int(gains.shape[-1]), window_size=av_kw["window_size"],
            stride=av_kw["stride"], fft_len=av_kw["fft_len"], k=av_kw["k"],
            dtype=rconfig.dtype, df_mode=av_kw["df_mode"]),
        vocoder=cost.vocoder(
            n, edges=av_kw["edges"], sample_rate=av_kw["sample_rate"],
            mod_window=av_kw["mod_window"], voc_stride=av_kw["voc_stride"],
            car_fft=av_kw["car_fft"], n_mod_frames=av_kw["n_mod_frames"],
            mod_mode=av_kw["mod_mode"], mod_shape=av_kw["mod_shape"],
            dtype=_synth_dtype(rconfig)),
        tracker=cost.tracker(
            data, float64=table_f64, n_fields=n_fields,
            in_bytes=cost.nbytes([freq, mag, *tracker_args,
                                  *tr_kw["autotune_arrays"]]),
            out_bytes=cost.nbytes([table]) + 8),
        render=(cost.count() if emit == "table" else cost.render(
            data["live_pairs"], stride=S, total_frames=tr_kw["total_frames"],
            n_slots=tr_kw["n_slots"], n_fields=n_fields,
            table_float64=table_f64, dtype=render_dtype)))
    if emit == "table":
        out_bytes = cost.nbytes([table])
    else:
        out_bytes = (tr_kw["total_frames"] * S * cost.N_CHANNELS
                     * dtype_of(render_dtype).itemsize)
    out_bytes += cost.nbytes([mix]) + 8   # the mix and the dropped count
    in_bytes = cost.nbytes([*bank_args, *av_args, *tracker_args,
                            *tr_kw["autotune_arrays"]])
    return cost.step_cost(stages, in_bytes=in_bytes, out_bytes=out_bytes,
                          data=data)


def df32_analysis_peaks(bank: voicebank.VoiceBank, n_samples: int,
                        rconfig: resynth_mod.ResynthConfig,
                        vparams: vocoder_mod.VocoderParams, carrier,
                        *, block_size: int = 1 << 15, device="cuda"):
    """The fidelity chain's ANALYSIS stage alone (JAX chain.py:595): synth
    -> double-grade peaks, returned as (n_frames, k) float64 numpy (freq,
    mag_db). bench.py's same-peaks fidelity row feeds these exact peaks to
    the host float64 tracker and renderer, so the comparison isolates
    tracking and rendering numerics from noise-floor peak churn."""
    if rconfig.dtype != "df32":
        raise ValueError("df32_analysis_peaks takes a dtype 'df32' config")
    bank_args, av_args, av_kw = _stage_analyze_vocode(
        bank, n_samples, rconfig, vparams, carrier, block_size,
        torch.device(device))
    freq, mag, _mix = _analyze_vocode(*bank_args, *av_args, **av_kw)
    return freq.cpu().numpy(), mag.cpu().numpy()


def df32_chain_table(bank: voicebank.VoiceBank, n_samples: int,
                     rconfig: resynth_mod.ResynthConfig,
                     vparams: vocoder_mod.VocoderParams, carrier,
                     *, block_size: int = 1 << 15, draws=None,
                     device="cuda") -> np.ndarray:
    """The fidelity chain's TRACKER OUTPUT (JAX chain.py:645): the
    (total_frames, n_slots, 17) slot table the renderer consumes, float64
    numpy — the note-level ground truth of a device run, for
    tools/note_metrics.py's comparison with host_chain_table at float64."""
    if rconfig.dtype != "df32":
        raise ValueError("df32_chain_table takes a dtype 'df32' config")
    step, _n_frames = prepare_offline_chain_device(
        bank, n_samples, rconfig, vparams, carrier, block_size=block_size,
        draws=draws, emit="table", device=device)
    table, _mix, _dropped = step()
    return table.cpu().numpy()


def assemble_framed_stereo(framed: torch.Tensor, start_sample: int) -> torch.Tensor:
    """(F, S, C) framed render -> (start_sample + F*S, C), and a batch's
    (B, F, S, C) -> (B, start_sample + F*S, C): the flatten is a view; only
    the leading-silence pad copies. (The JAX package's version takes its
    channel-major (C, F, S) and returns (C, T) numpy.)"""
    flat = framed.reshape(*framed.shape[:-3], -1, framed.shape[-1])
    return torch.nn.functional.pad(flat, (0, 0, start_sample, 0))


def _to_host(outputs: tuple, dev: torch.device) -> tuple:
    """The chain's outputs on the host, in the span "outputs". On a CUDA
    device each one is copied without blocking into a pinned host tensor
    from torch's caching host allocator, and the current stream is
    synchronised once, after the last copy. The allocator hands a block out
    again only once no tensor refers to it, so an output that a caller
    keeps is never written over by a later call. Elsewhere the outputs are
    host tensors already and are returned as they are."""
    global PINNED_OUTPUTS
    with span("outputs", dev):
        if dev.type != "cuda":
            return outputs
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in outputs)
        torch.cuda.current_stream(dev).synchronize()
        PINNED_OUTPUTS += len(host)
    return host


def run_offline_chain_device(bank: voicebank.VoiceBank, n_samples: int,
                             rconfig: resynth_mod.ResynthConfig,
                             vparams: vocoder_mod.VocoderParams, carrier,
                             *, block_size: int = 1 << 15, draws=None,
                             device="cuda",
                             timings: dict | None = None) -> OfflineChainResult:
    """The offline chain with the DEVICE tracker (analysis/device_tracker.py)
    in place of the host pitch pipeline: synth, analysis, tracking, render
    and vocoder all on `device`. Covers the reference's default config
    space including autotune (scale/chord/intervals) and harmonize; dtype
    "df32" runs the fidelity chain (float32 out). `resynth` (T, 2),
    `vocoded` and the scalar `dropped` are host tensors, pinned on a CUDA
    device (_to_host). timings: as in run_offline_chain ("tracker" is the
    device tracker; "synth" includes staging the arguments). The call is
    one "chain" span, holding "staging", the five stages' and "outputs"."""
    dev = torch.device(device)
    rcfg = resynth_mod._render_config(rconfig)
    with span("chain", dev), timed(timings, dev, STAGES):
        step, n_frames = prepare_offline_chain_device(
            bank, n_samples, rconfig, vparams, carrier, block_size=block_size,
            draws=draws, device=dev)
        framed, mix, dropped = step()
        stereo, mix, dropped = _to_host(
            (assemble_framed_stereo(framed, rcfg.start_sample), mix, dropped), dev)
    return OfflineChainResult(resynth=stereo, vocoded=mix, n_frames=n_frames,
                              tracker="device", dropped=dropped)


def resynthesize_signal_device(signal, rconfig, *, device="cuda") -> torch.Tensor:
    """Device-resident resynthesis of a mono signal (a host array or a
    tensor) on `device` (JAX chain.py:781-815), the rt.resynth.job WAV
    path: STFT -> peaks -> device tracker -> render (JAX chain.py:751-778),
    covering autotune and harmonize configs. Returns the (T, 2) stereo
    tensor. dtype "df32" analyses in float64 (as JAX does: its working
    dtype is float64), tracks with the fidelity tracker and renders the
    17-field table to float32 (the render config's dtype)."""
    dev = torch.device(device)
    wdt = _device_dtype(rconfig)
    n = int(signal.shape[0]) if torch.is_tensor(signal) else len(signal)
    rcfg = resynth_mod._render_config(rconfig)
    tracker_args, tr_kw = _tracker_inputs(rconfig, rcfg, _n_frames(n, rconfig),
                                          None, wdt, dev)
    freq, mag = _peaks(
        torch.as_tensor(signal, dtype=wdt, device=dev),
        torch.as_tensor(stft_ops.gaussian_window(rconfig.window_size,
                                                 sigmas=4.0),
                        dtype=wdt, device=dev),
        window_size=rconfig.window_size, stride=rconfig.stride,
        fft_len=stft_ops.fft_length_for(rconfig.window_size),
        k=rconfig.max_voices + 1, sample_rate=rconfig.sample_rate)
    table, _dropped = _track(freq, mag, tracker_args, tr_kw, rconfig)
    framed = resynth_bank._render_slots(table, stride=tr_kw["stride"],
                                        dtype=rcfg.dtype)
    return assemble_framed_stereo(framed, rcfg.start_sample)


def prepare_offline_chain_device_batch(banks, n_samples: int,
                                       rconfig: resynth_mod.ResynthConfig,
                                       vparams: vocoder_mod.VocoderParams,
                                       carrier, *, block_size: int = 1 << 15,
                                       draws=None, device="cuda"):
    """Batched serving: B independent jobs per step on `device`.

    The step of prepare_offline_chain_device (_step), run once over the
    stacked jobs, as the JAX program vmaps it (JAX chain.py:906-931): the
    jobs' voice tables stack on a leading axis (equal voice counts, else a
    ValueError naming the shapes), so a step makes one voice-bank kernel
    launch for all jobs, one batched STFT and top-k, one batched vocoder
    (its host-built kernel matrices staged once, not once per job), the
    batched tracker (device_tracker.build_tables_device_batch: one
    frame-local pass over every job's frames, then on the card one
    frame-loop kernel launch for every job, elsewhere the violation flag
    read once for the batch) and the render of every job's table
    (resynth_bank._render_slots: on the card one launch of the render
    kernel over every job's live slots; on the CPU the plain render, in
    chunks of frames). The JAX program's 64-slot render split and its
    lax.cond (JAX chain.py:915-928) worked around conds under vmap.
    float32 or float64, as in the JAX package.

    banks: list of VoiceBank (same n_samples/config per job).
    carrier: (n,) shared or (B, n) per-job.
    Returns (step, n_frames); step() -> (stereo (B, T, 2), vocoded (B, m),
    dropped (B,)) host tensors, pinned on a CUDA device (_to_host). The
    staging is a "staging" span (of the batch that the next step() runs),
    each step() a "chain" span holding the five stages' and "outputs".
    """
    if rconfig.dtype == "df32":
        raise ValueError("the batched chain runs float32 or float64")
    dev = torch.device(device)
    n_frames = _n_frames(n_samples, rconfig)
    rcfg = resynth_mod._render_config(rconfig)
    with span("staging", dev):
        bank_args, av_args, av_kw = _stage_analyze_vocode(
            list(banks), n_samples, rconfig, vparams, carrier, block_size, dev)
        carrier_dev = av_args[1]
        if carrier_dev.dim() == 2 and carrier_dev.shape[0] != len(banks):
            raise ValueError(f"{carrier_dev.shape[0]} carriers for {len(banks)} jobs")
        tracker_args, tr_kw = _tracker_inputs(rconfig, rcfg, n_frames, draws,
                                              dtype_of(rconfig.dtype), dev)

    def step():
        with span("chain", dev):
            framed, mix, dropped = _step(bank_args, av_args, tracker_args,
                                         av_kw=av_kw, tr_kw=tr_kw,
                                         rconfig=rconfig)
            return _to_host((assemble_framed_stereo(framed, rcfg.start_sample), mix,
                             dropped), dev)

    return step, n_frames
