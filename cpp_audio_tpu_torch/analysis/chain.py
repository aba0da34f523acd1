"""Offline chain: synth -> analysis peaks -> tracker -> resynthesis, and the
vocoder of the synth's mixdown.

    voice-bank blocks (CUDA kernel) -> mono mixdown -> sliding Gaussian STFT
    -> top-k peaks -> host tracker (C++ pitchpipe_run_offline, or the Python
    tracker) -> slot table -> tracked-note render; and, from the same
    mixdown, the O(n) vocoder against a carrier.

Port of cpp_audio_tpu/analysis/chain.py `run_offline_chain` (:255-324), with
the same routing: the native table packer when the library is available
(and the draws are sequential, with reference harmonize semantics), the
Python tracker otherwise. Only (frames, k) peak arrays cross to the host.
The single-dispatch device-tracker chain (run_offline_chain_device) is not
ported yet (ROADMAP A7).

Reference scope: RtResynth's offline job loop (source/rt.resynth.lib.cpp:
1185-1235 — input -> analysis -> resynth synth + vocoder).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import dtype_of
from ..models import resynth_bank, voicebank
from ..ops import stft as stft_ops
from . import resynth as resynth_mod
from . import vocoder as vocoder_mod


@dataclass
class OfflineChainResult:
    resynth: torch.Tensor   # (samples, 2) stereo resynthesis
    vocoded: torch.Tensor   # (m,) vocoder mix of the mixdown
    n_frames: int
    tracker: str = "native"  # which host tracker built the slot table


def run_offline_chain(bank: voicebank.VoiceBank, n_samples: int,
                      rconfig: resynth_mod.ResynthConfig,
                      vparams: vocoder_mod.VocoderParams, carrier,
                      *, block_size: int = 1 << 15, device="cuda",
                      timings: dict | None = None) -> OfflineChainResult:
    """Render `bank`, resynthesize its mono mixdown, and vocode it on
    `device`. The synth leg renders per-block compacted voice tables through
    ops/cuda_voicebank.render_blocks (the CUDA kernel for CUDA tensors).

    timings: when a dict is given, the device is synchronised after each
    stage and the stage's wall seconds are stored under "synth",
    "analysis", "vocoder", "tracker" and "render" (a measurement aid: the
    synchronisations cost overlap, so time the chain without it)."""
    from .. import native as nat

    dev = torch.device(device)
    clock = [time.perf_counter()]

    def stage(name):
        if timings is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[name] = now - clock[0]
        clock[0] = now

    sr = rconfig.sample_rate
    dtype = rconfig.dtype
    wdt = dtype_of(dtype)
    args, statics = voicebank.prepare_bank_arrays(bank, n_samples, block_size,
                                                  dtype, device=dev)
    args, statics = voicebank.compact_block_args(args, statics)

    # 1. synth render + mono mixdown
    out = voicebank.voicebank_blocks_compact_impl(*args, **statics)
    mono = out.reshape(-1, out.shape[-1])[:n_samples].sum(dim=1)
    stage("synth")

    # 2. analysis: sliding Gaussian STFT -> top-k peaks
    window = torch.as_tensor(stft_ops.gaussian_window(rconfig.window_size,
                                                      sigmas=4.0),
                             dtype=wdt, device=dev)
    fft_len = stft_ops.fft_length_for(rconfig.window_size)
    sq = stft_ops._stft_sqmag(mono, window, window_size=rconfig.window_size,
                              stride=rconfig.stride, fft_length=fft_len)
    freq, mag = stft_ops._top_peaks(sq, sample_rate=sr, fft_length=fft_len,
                                    k=rconfig.max_voices + 1)
    stage("analysis")

    # 3. vocoder of the mixdown against the carrier
    S = vparams.stride
    W = vparams.modulator_window
    car_fft = stft_ops.fft_length_for(2 * S)
    edges = vparams.band_freqs()
    bm_car = torch.as_tensor(
        vocoder_mod._band_matrix(edges, car_fft // 2 + 1, sr / car_fft),
        dtype=wdt, device=dev)
    n_mod_frames = max(0, (n_samples - W) // S + 1)
    rows = torch.as_tensor(
        vocoder_mod.modulator_alignment_rows(n_samples, vparams, n_mod_frames),
        device=dev)
    carrier_dev = torch.as_tensor(carrier, dtype=wdt, device=dev)[:n_samples]
    amps = vocoder_mod._modulator_band_amps_fast(
        mono, edges, window=W, stride=S, n_frames=n_mod_frames,
        sample_rate=sr, shape=vparams.modulator_window_shape)
    vocoded = vocoder_mod._carrier_vocode(carrier_dev, amps[rows], bm_car,
                                          stride=S, fft_len=car_fft)
    out_len = vocoded.shape[0]
    mix = (float(vparams.volume_vocoded) * vocoded
           + float(vparams.volume_modulator) * mono[:out_len]
           + float(vparams.volume_carrier) * carrier_dev[:out_len])
    stage("vocoder")

    # 4. host: tracking + slot table, then the tracked-note render
    freq_h = freq.cpu().numpy()
    mag_h = mag.cpu().numpy()
    n_frames = int(freq_h.shape[0])
    rcfg = resynth_mod._render_config(rconfig)
    native_sem_ok = (rconfig.harmonize_semantics == "reference"
                     or (rconfig.pitch_harmonize_pre_autotune == 0.0
                         and rconfig.pitch_harmonize_post_autotune == 0.0))
    if nat.available() and rconfig.draw_indexing != "stable" and native_sem_ok:
        table = resynth_mod.build_tables_native(freq_h, mag_h, rconfig,
                                                n_frames + 8, rcfg)
        tracker = "native"
    else:
        peaks = stft_ops.top_peaks_to_lists(freq_h, mag_h)
        notes, _stats, _dropped = resynth_mod.track(peaks, rconfig,
                                                    prefer_native=False)
        table = resynth_bank._build_slot_tables(notes, n_frames + 8, rcfg)
        tracker = "python"
    stage("tracker")
    stereo = resynth_bank.render_table(table, rcfg, device=dev)
    stage("render")
    return OfflineChainResult(resynth=stereo, vocoded=mix, n_frames=n_frames,
                              tracker=tracker)
