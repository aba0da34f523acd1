"""Resumable long offline renders: render-state checkpointing.

The reference checkpoints only *presets* (JSON autosave thread,
source/rt.resynth.lib.cpp:1124-1161) because its renders are short and
realtime. SURVEY.md 5.4 calls for the rebuild to "add render-state
checkpointing only for long offline jobs" — this module is that subsystem.

The offline chain runs here as the reference's own offline duplex loop
(sample-blockwise feed -> pull, rt.resynth.lib.cpp:1185-1235) built from the
streaming components (LiveResynth, StreamingVocoder). After every segment
(a fixed number of blocks) the FULL pipeline state — PeriodicFFT window
buffers, pitch-tracker voices, synth voice states, vocoder crossfade
carries, feedback delay line, accumulated output — is snapshotted to disk
with an atomic tmp+rename. A killed job resumes from the last snapshot and
produces bit-identical output to an uninterrupted run: the block loop is
the same sequence of feed/pull calls regardless of where segment boundaries
fall, and every piece of state round-trips exactly through the snapshot.

Checkpoints are keyed by a fingerprint of (preset, input lengths, sample
rate, post, block size); a stale/mismatched checkpoint is ignored and the
render restarts from scratch.

Port of cpp_audio_tpu/analysis/checkpoint.py. The accumulated mix, the
inputs the vocoder reads and the in-loop limiter's state live on `device`;
LiveResynth renders each block through the voice-bank kernel. The fed-back
mono mix is host data (it re-enters the analysis as captured input does),
so the feedback path copies one block to the host per block. A snapshot
starts with the port's magic and the fingerprint on two text lines, which
are checked before anything is unpickled; the pickled pipeline objects hold
their tensors as host arrays (device.HostPickled), so a snapshot holds no
device storage. The device type is part of the fingerprint: a render never
resumes on another kind of device, whose rounding differs.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import limiter as lim
from ..utils import wav as wavio
from . import offline_job as oj
from .presets_json import OfflineJobConfig, ResynthPreset
from .streaming import LiveResynth, StreamingVocoder

_MAGIC = "cpp_audio_tpu_torch-render-checkpoint-v1"


def _fingerprint(preset: ResynthPreset, voice, carrier, sample_rate: int,
                 post: str, block_size: int,
                 max_feedback_level: float, device) -> str:
    """Keyed by the CONTENT of the inputs (not just their lengths) and every
    parameter that affects the rendered samples, so re-recorded or swapped
    inputs of equal length cannot silently resume a stale snapshot."""
    h = hashlib.sha256()
    h.update(json.dumps(
        [_MAGIC, preset.to_json_dict(), sample_rate, post, block_size,
         max_feedback_level, torch.device(device).type], sort_keys=True).encode())
    for arr in (voice, carrier):
        h.update(b"|")
        if arr is not None and len(arr):
            h.update(np.ascontiguousarray(arr, np.float64).data)
    return h.hexdigest()


@dataclass
class _PipelineState:
    """Everything that must survive a kill."""

    fingerprint: str
    pos: int                       # samples fully processed
    out: torch.Tensor              # (n, 2) accumulated raw mix (pre-post),
    #                                on the device (a host array on disk)
    live: LiveResynth | None       # analysis -> resynthesis leg
    svoc: StreamingVocoder | None  # vocoder leg
    fb_mono: np.ndarray | None     # published mono output (feedback source)
    lim_peak: object = 0.0         # feedback limiter follower state (a 0-d
    #   device tensor while rendering, a float on disk)
    #   (post="limit" feeds back the LIMITED full mix — the published
    #    post-processed L+R sum, rt.resynth.lib.cpp:1263-1273)


def save_checkpoint(path, state: _PipelineState) -> None:
    """Atomic snapshot: write to a tmp file, fsync, rename into place.

    Only the rendered prefix out[:pos] (and fb_mono[:pos]) is written — the
    untouched future region is zeros that load_checkpoint re-pads, so
    snapshot size tracks progress instead of the full render (hours-long
    jobs would otherwise fsync a multi-GB array every segment)."""
    slim = _PipelineState(
        fingerprint=state.fingerprint, pos=state.pos,
        out=state.out[: state.pos].cpu().numpy(), live=state.live,
        svoc=state.svoc,
        fb_mono=(None if state.fb_mono is None
                 else state.fb_mono[: state.pos].copy()),
        lim_peak=float(state.lim_peak))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(f"{_MAGIC}\n{state.fingerprint}\n".encode())
        pickle.dump(slim, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path, fingerprint: str, n: int | None = None, *,
                    device="cuda") -> _PipelineState | None:
    """Load a snapshot; None if absent, unreadable, not the port's, or
    config-mismatched (any exception counts as unreadable — a snapshot from
    an older code layout must restart the render, not crash it). The header
    is checked before anything is unpickled. `n` re-pads the slim arrays
    back to the full render length; the mix goes to `device`."""
    head = f"{_MAGIC}\n{fingerprint}\n".encode()
    try:
        with open(path, "rb") as f:
            if f.read(len(head)) != head:
                return None
            state = pickle.load(f)
    except Exception:
        return None
    if not isinstance(state, _PipelineState):
        return None
    if state.fingerprint != fingerprint:
        return None
    out = np.asarray(state.out)
    if n is not None:
        if len(out) != state.pos or state.pos > n:
            return None
        out = np.concatenate([out, np.zeros((n - state.pos, 2))])
        if state.fb_mono is not None:
            state.fb_mono = np.concatenate(
                [state.fb_mono, np.zeros(n - state.pos)])
    state.out = torch.as_tensor(out, device=torch.device(device))
    return state


def run_offline_streaming(preset: ResynthPreset, voice: np.ndarray | None,
                          carrier: np.ndarray | None, sample_rate: int,
                          post: str = "none", *,
                          checkpoint_path=None,
                          segment_seconds: float = 5.0,
                          block_size: int = 512,
                          resume: bool = True,
                          max_segments: int | None = None,
                          max_feedback_level: float = 4.0,
                          device="cuda") -> np.ndarray | None:
    """Streaming (block-loop) form of offline_job.run_offline with optional
    resumable checkpointing.

    Semantics follow the reference's offline ctor loop: the same pipeline as
    the live app, driven block by block. Output therefore matches
    offline_job.run_offline at the documented streaming latencies (analysis
    events land at window-completion samples; the vocoded stream lags 2
    strides), not bitwise — but is itself exactly reproducible: any
    interrupt/resume sequence yields the identical array.

    checkpoint_path: enable snapshots every `segment_seconds` of audio.
    max_segments: stop (returning None) after that many segments this call —
    used by tests to simulate a kill mid-render. Returns the (n, 2) host
    float64 output.
    """
    dev = torch.device(device)
    n = max(len(voice) if voice is not None else 0,
            len(carrier) if carrier is not None else 0)
    # the fingerprint hashes the ORIGINAL inputs (before padding)
    fp = _fingerprint(preset, voice, carrier, sample_rate, post, block_size,
                      max_feedback_level, dev)
    # a shorter input is trailing silence for the duplex loop (run_offline
    # instead truncates the direct-leg adds, which _direct_legs mirrors)
    n_voice = len(voice) if voice is not None else 0
    n_carrier = len(carrier) if carrier is not None else 0

    def _pad(x):
        x = np.zeros(0) if x is None else np.asarray(x, np.float64)
        return (np.concatenate([x, np.zeros(n - len(x))])
                if len(x) < n else x)

    voice = _pad(voice)
    carrier = _pad(carrier)
    gained = preset.analysis_input_gain * voice
    # the vocoder and the direct legs read the inputs on the device; the
    # analysis is fed from the host, as captured input is
    voice_d = torch.as_tensor(voice, device=dev)
    carrier_d = torch.as_tensor(carrier, device=dev)
    gained_d = torch.as_tensor(gained, device=dev)

    seg_blocks = max(1, int(round(segment_seconds * sample_rate / block_size)))

    state = None
    if checkpoint_path and resume:
        state = load_checkpoint(checkpoint_path, fp, n, device=dev)
    if state is None:
        use_analysis = preset.analysis_volume != 0.0
        use_vocoder = preset.vocoder_volume != 0.0 and n_carrier > 0
        live = None
        if use_analysis:
            cfg = oj.resynth_config_from_preset(preset, sample_rate)
            live = LiveResynth(cfg, device=dev)
        svoc = None
        if use_vocoder:
            vp = oj.vocoder_params_from_preset(preset, sample_rate)
            svoc = StreamingVocoder(vp, device=dev)
        fb_mono = (np.zeros(n)
                   if use_analysis and preset.analysis_output_feedback_gain
                   else None)
        state = _PipelineState(fingerprint=fp, pos=0,
                               out=torch.zeros((n, 2), dtype=torch.float64,
                                               device=dev),
                               live=live, svoc=svoc, fb_mono=fb_mono)

    fb_gain = preset.analysis_output_feedback_gain
    delay = max(1, int(0.5 + preset.output_delay_seconds * sample_rate))
    # feedback must be causal at block granularity (the live delay line is
    # written by the output callback before the analysis thread reads it)
    blk = min(block_size, delay) if state.fb_mono is not None else block_size
    if state.fb_mono is not None:
        seg_blocks = max(1, seg_blocks * block_size // blk)

    segments_done = 0
    while state.pos < n:
        end_seg = min(state.pos + seg_blocks * blk, n)
        while state.pos < end_seg:
            lo = state.pos
            hi = min(lo + blk, n)
            r_blk = None
            if state.live is not None:
                feed = gained[lo:hi]
                if state.fb_mono is not None:
                    delayed = np.zeros(hi - lo)
                    # effective loop delay is delay + 1: the aggregator
                    # pairs input[t] with the previous iteration's output
                    # (see resynth.resynthesize_feedback; rtjob oracle)
                    src_lo = lo - delay - 1
                    if src_lo + (hi - lo) > 0:
                        a = max(src_lo, 0)
                        delayed[a - src_lo:] = state.fb_mono[a: src_lo
                                                             + (hi - lo)]
                    feed = feed + fb_gain * delayed
                    if post != "limit":
                        feed = np.clip(feed, -max_feedback_level,
                                       max_feedback_level)
                state.live.feed(feed)
                r_blk = state.live.pull(hi - lo)
                state.out[lo:hi] += r_blk
            v_blk = None
            if state.svoc is not None:
                v_blk = state.svoc.process(gained_d[lo:hi], carrier_d[lo:hi])
                state.out[lo:hi] += preset.vocoder_volume * v_blk[:, None]
            if state.fb_mono is not None:
                # feed back the published output: the post-processed L+R sum
                # of the FULL mix, all legs included (the reference publishes
                # the mixed output buffer, rt.resynth.lib.cpp:1263-1273);
                # post=="none" is the same mix without the limiter.
                mix = torch.zeros((hi - lo, 2), dtype=torch.float64, device=dev)
                if r_blk is not None:
                    mix += r_blk
                if v_blk is not None:
                    mix += preset.vocoder_volume * v_blk[:, None]
                if preset.voice_volume != 0.0:
                    mix += preset.voice_volume * voice_d[lo:hi, None]
                if preset.carrier_volume != 0.0:
                    mix += preset.carrier_volume * carrier_d[lo:hi, None]
                if post == "limit":
                    mix, state.lim_peak = lim.limit_streaming(
                        mix, state.lim_peak, sample_rate=sample_rate)
                # the one host copy per block: the next feed reads it
                state.fb_mono[lo:hi] = mix.sum(dim=1).cpu().numpy()
            state.pos = hi
        if checkpoint_path:
            save_checkpoint(checkpoint_path, state)
        segments_done += 1
        if max_segments is not None and segments_done >= max_segments \
                and state.pos < n:
            return None

    out = state.out.clone()
    # direct legs + post, as in offline_job.run_offline (stateless: applied
    # on the completed mix, not checkpointed; original lengths — the padding
    # is silence)
    if preset.voice_volume != 0.0:
        out[:n_voice] += preset.voice_volume * voice_d[:n_voice, None]
    if preset.carrier_volume != 0.0:
        out[:n_carrier] += preset.carrier_volume * carrier_d[:n_carrier, None]
    if post == "limit":
        out = lim.limit(out, sample_rate=sample_rate)
    # NaN hygiene only — no clamp: the reference offline-job post chain has
    # none (init_post, rt.resynth.lib.cpp:1247-1261; see run_offline)
    out = torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0).cpu().numpy()
    if checkpoint_path:
        try:
            os.remove(checkpoint_path)
        except OSError:
            pass
    return out


def run_job_checkpointed(config: OfflineJobConfig, checkpoint_path,
                         segment_seconds: float = 5.0,
                         resume: bool = True, *,
                         max_segments: int | None = None,
                         device="cuda") -> np.ndarray | None:
    """offline_job.run_job with resumable render-state checkpointing.
    max_segments: as in run_offline_streaming (a simulated kill: returns
    None and writes no WAV)."""
    preset, voice, carrier, sample_rate = oj.load_job_inputs(config)

    out = run_offline_streaming(preset, voice, carrier, sample_rate,
                                post=config.post,
                                checkpoint_path=checkpoint_path,
                                segment_seconds=segment_seconds,
                                resume=resume, max_segments=max_segments,
                                device=device)
    if out is None:
        return None
    wavio.write_wav(config.output_file, out, sample_rate,
                    bits=32, fmt=wavio.WAVE_FORMAT_IEEE_FLOAT)
    return out
