"""Headless offline RtResynth job (the `rt.resynth.job` scheme).

Reference flow (RtResynth offline ctor, source/rt.resynth.lib.cpp:1185-1235):
read the voice (and optional carrier) WAV sample by sample through the exact
realtime pipeline, then write a stereo float32 WAV, optionally limited
(Postprocessing::Limit). Offline on the device, the pipeline stages run
batched: the analysis->resynthesis chain renders through the tracked voice
bank and the vocoder processes all frames at once; the output mixes

    voice_volume * voice + carrier_volume * carrier
  + vocoder_volume * vocode(voice, carrier) + analysis resynthesis

exactly like the realtime compute's final mix (rt.resynth.lib.cpp:1246-1283,
vocoder volumes rt.resynth.lib.vocoder.cpp:795-805).

Port of cpp_audio_tpu/analysis/offline_job.py. The mix of the legs is a
float64 (n, 2) tensor on `device`; the vocoder, the resynthesis and the
limiter write into it there, and `run_offline` copies it to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import limiter as lim
from ..utils import wav as wavio
from ..utils.midi import Note  # noqa: F401
from ..utils.profiling import span, timed
from . import resynth as rs
from . import vocoder as voc
from .presets_json import OfflineJobConfig, ResynthPreset

# run_offline's spans, in their order: the keys of its `timings=`
STAGES = ("to device", "vocoder", "resynthesize", "limiter", "to host")


def resynth_config_from_preset(p: ResynthPreset, sample_rate: int) -> rs.ResynthConfig:
    return rs.ResynthConfig(
        sample_rate=sample_rate,
        window_size_seconds=p.window_size_seconds,
        window_center_stride_seconds=p.window_center_stride_seconds,
        min_volume=p.min_volume,
        nearby_distance_tones=p.nearby_distance_tones,
        max_track_pitches=p.max_track_pitches,
        pitch_shift_pre_autotune=p.pitch_shift_pre_autotune,
        pitch_shift_post_autotune=p.pitch_shift_post_autotune,
        pitch_harmonize_pre_autotune=p.pitch_harmonize_pre_autotune,
        pitch_harmonize_post_autotune=p.pitch_harmonize_post_autotune,
        stereo_spread=p.stereo_spread,
        analysis_volume=p.analysis_volume,
        use_autotune=p.use_autotune,
        autotune_max_pitch=float(p.autotune_max_pitch),
        autotune_tolerance_pitches=p.autotune_tolerance_pitches,
        autotune_kwargs=dict(
            autotune_type=p.autotune_type,
            musical_scale_mode=p.autotune_musical_scale_mode,
            musical_scale_root_note=p.autotune_musical_scale_root_note,
            root_note_halftones_transpose=p.autotune_root_note_halftones_transpose,
            chord_frequencies=p.autotune_chord_frequencies,
            bit_chord=p.autotune_bit_chord,
            intervals_size=p.autotune_factor,
        ),
        env_attack_seconds=p.env_attack_seconds,
        env_hold_seconds=p.env_hold_seconds,
        env_decay_seconds=p.env_decay_seconds,
        env_release_seconds=p.env_release_seconds,
        env_sustain_level=p.env_sustain_level,
    )


def vocoder_params_from_preset(p: ResynthPreset, sample_rate: int) -> voc.VocoderParams:
    return voc.VocoderParams(
        sample_rate=sample_rate,
        env_follower_cutoff_ratio=p.vocoder_env_follower_cutoff_ratio,
        modulator_window_size_seconds=p.vocoder_modulator_window_size_seconds,
        stride_seconds=p.vocoder_stride_seconds,
        count_bands=p.vocoder_count_bands,
        min_freq=p.vocoder_min_freq,
        max_freq=p.vocoder_max_freq,
        volume_modulator=0.0, volume_carrier=0.0, volume_vocoded=1.0,
    )


def run_offline(preset: ResynthPreset, voice: np.ndarray | None,
                carrier: np.ndarray | None, sample_rate: int,
                post: str = "none", dtype: str = "float32",
                pan_draw_values=None, phase_draw_values=None, *,
                device="cuda", timings: dict | None = None) -> np.ndarray:
    """Run the full chain on mono arrays -> stereo output array (host
    float64, (n, 2)).

    pan_draw_values / phase_draw_values: oracle-replay RNG streams threaded
    into ResynthConfig (see that dataclass). timings: when a dict, the wall
    of each stage ("to device", "vocoder" with the direct legs,
    "resynthesize", "limiter", "to host"), each ending in a synchronise of
    the device, is added to it. Each stage is a span of that name."""
    dev = torch.device(device)
    with timed(timings, dev, STAGES):
        with span("to device", dev):
            n = max(len(voice) if voice is not None else 0,
                    len(carrier) if carrier is not None else 0)
            f64 = dict(dtype=torch.float64, device=dev)
            out = torch.zeros((n, 2), **f64)
            voice = (torch.zeros(n, **f64) if voice is None
                     else torch.as_tensor(voice, **f64))
            carrier = (torch.zeros(n, **f64) if carrier is None
                       else torch.as_tensor(carrier, **f64))

        with span("vocoder", dev):
            gained_voice = preset.analysis_input_gain * voice
            # non-analysis output legs first: with feedback active they are
            # part of the published output the delay line feeds back
            # (init_post publishes the post-processed mono sum of the FULL
            # mix, rt.resynth.lib.cpp:1263-1273)
            if preset.vocoder_volume != 0.0 and len(carrier):
                vp = vocoder_params_from_preset(preset, sample_rate)
                v = voc.vocode(gained_voice, carrier, vp, device_out=True, device=dev)
                m = min(v.shape[0], n)
                out[:m] += preset.vocoder_volume * v[:m, None]
            if preset.voice_volume != 0.0:
                out[: len(voice)] += preset.voice_volume * voice[:, None]
            if preset.carrier_volume != 0.0:
                out[: len(carrier)] += preset.carrier_volume * carrier[:, None]

        with span("resynthesize", dev):
            if preset.analysis_volume != 0.0:
                cfg = resynth_config_from_preset(preset, sample_rate)
                cfg.dtype = dtype
                cfg.pan_draw_values = pan_draw_values
                cfg.phase_draw_values = phase_draw_values
                if preset.analysis_output_feedback_gain != 0.0:
                    # feedback drones: delayed output mixed into the analyzed
                    # stream (rt.resynth.lib.cpp:1629-1651)
                    r = rs.resynthesize_feedback(
                        gained_voice, cfg,
                        feedback_gain=preset.analysis_output_feedback_gain,
                        delay_seconds=preset.output_delay_seconds,
                        post_limit=(post == "limit"), extra_mix=out, device=dev)
                else:
                    r = rs.resynthesize(gained_voice, cfg, device_out=True, device=dev)
                m = min(r.shape[0], n)
                out[:m] += r[:m]

        with span("limiter", dev):
            if post == "limit":
                out = lim.limit(out, sample_rate=sample_rate)
            # NaN hygiene only: the reference post chain has NO clamp in the
            # offline-job modes (init_post, rt.resynth.lib.cpp:1247-1261 —
            # None is empty, Limit is limiter-only; out.h:620-646's clamp
            # belongs to the other engine's post chain) — clamping here broke
            # assembled-oracle parity whenever the unlimited mix exceeded +-1
            out = torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
        with span("to host", dev):
            out = out.cpu().numpy()
    return out


def load_job_inputs(config: OfflineJobConfig):
    """Read + validate a job's preset and input WAVs (shared by run_job and
    analysis/checkpoint.run_job_checkpointed).

    Returns (preset, voice, carrier, sample_rate)."""
    preset = (ResynthPreset.load(config.preset_file) if config.preset_file
              else ResynthPreset())

    voice = carrier = None
    sample_rate = None
    if config.input_voice_file:
        data, sample_rate = wavio.read_wav(config.input_voice_file)
        if data.shape[1] != 1:
            raise ValueError("single channel only")  # params.cpp:380-382
        voice = data[:, 0]
    if config.input_carrier_file:
        data, sr2 = wavio.read_wav(config.input_carrier_file)
        if data.shape[1] != 1:
            raise ValueError("single channel only")
        if sample_rate is not None and sr2 != sample_rate:
            raise ValueError("sample rate mismatch between carrier and voice")
        sample_rate = sr2
        carrier = data[:, 0]
    if sample_rate is None:
        raise ValueError("must have at least one of carrier or voice")
    if not config.output_file:
        raise ValueError("no output file")
    return preset, voice, carrier, sample_rate


def run_job(config: OfflineJobConfig, *, device="cuda",
            timings: dict | None = None) -> np.ndarray:
    """Execute a JSON job config: read WAVs, run the chain on `device`,
    write the output. timings: as in run_offline, plus "wav read" and "wav
    write" (spans of those names)."""
    dev = torch.device(device)
    with timed(timings, dev, ("wav read",)), span("wav read", dev):
        preset, voice, carrier, sample_rate = load_job_inputs(config)
    out = run_offline(preset, voice, carrier, sample_rate, post=config.post,
                      device=device, timings=timings)
    with timed(timings, dev, ("wav write",)), span("wav write", dev):
        wavio.write_wav(config.output_file, out, sample_rate,
                        bits=32, fmt=wavio.WAVE_FORMAT_IEEE_FLOAT)
    return out


def run_job_file(path, *, device="cuda") -> np.ndarray:
    return run_job(OfflineJobConfig.load(path), device=device)
