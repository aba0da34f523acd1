"""Polyphonic sine synthesizer — the reference `sine::Synth` (gen.sine path).

Reference composition per voice (include/gen.sine.h:5-45 over
include/audioelement.h):
    VolumeAdjusted< Enveloped< SineOscillatorAlgo, AHDSREnvelope > >
with NoteOn setting volume = baseVolume * velocity (gen.crtp.h:425) and
`SynthImpl::setupAudioElement` configuring equal-loudness params
(low_index=5 → 63 Hz, log_ratio=0.8, level=30 phon; gen.sine.h:10-21) which
take effect when the element is loudness-compensated
(LoudnessVolumeAdjusted, audioelement.h:1275-1316).

This module is a thin mapping from NoteSchedules onto the shared voice-bank
renderer (models/voicebank.py) — each note is one bank row. Port of
cpp_audio_tpu/models/sine_synth.py; the library entry point is
bank_from_schedule -> render_schedule (or analysis/chain.run_offline_chain);
render_to_wav writes the render to a WAV.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.voices import NoteSchedule
from ..ops import envelopes, oscillators
from ..utils import loudness
from ..utils.convert import freq_to_angle_increment
from . import voicebank

# reference include/audioelement.h:1270 + sound.h:84 (sine base volume 1.0)
REDUCE_UNADJUSTED_VOLUMES = 0.1
SINE_BASE_VOLUME = REDUCE_UNADJUSTED_VOLUMES * 1.0


@dataclass(frozen=True)
class SineSynthConfig:
    sample_rate: int = 44100
    ahdsr: envelopes.AHDSR = None  # type: ignore[assignment]
    n_channels: int = 2
    # LoudnessVolumeAdjusted (True) vs VolumeAdjusted (False) element
    loudness_compensation: bool = False
    loudness_low_index: int = 5   # 63 Hz (gen.sine.h:15)
    loudness_log_ratio: float = 0.8
    loudness_level: float = 30.0
    base_volume: float = SINE_BASE_VOLUME
    block_size: int = 32768
    dtype: str = "float32"

    def __post_init__(self):
        if self.ahdsr is None:
            object.__setattr__(
                self, "ahdsr",
                envelopes.AHDSR(attack=1000, hold=0, decay=1000, release=10000,
                                sustain=0.7).with_min_dt(self.sample_rate),
            )


def _voice_volumes(config: SineSynthConfig, schedule: NoteSchedule) -> np.ndarray:
    if config.loudness_compensation:
        # LoudnessVolumeAdjusted: volume comes from the equal-loudness contour
        # (set in setAngleIncrements, audioelement.h:1291-1298), which
        # overwrites the velocity-based target set earlier in NoteOn.
        vol = np.asarray(
            loudness.equal_loudness_volume_from_freq(
                schedule.frequency,
                low_index=config.loudness_low_index,
                log_ratio=config.loudness_log_ratio,
                level=config.loudness_level,
            )
        )
        return np.where(schedule.velocity > 0, vol, 0.0)
    return config.base_volume * schedule.velocity


def _stereo_gains(pan: np.ndarray, n_channels: int) -> np.ndarray:
    """Constant-power pan (reference include/stereo.h): gains = cos/sin(pi/4*(pan+1))."""
    if n_channels == 1:
        return np.ones((len(pan), 1))
    th = 0.25 * np.pi * (np.clip(pan, -1.0, 1.0) + 1.0)
    g = np.zeros((len(pan), n_channels))
    g[:, 0] = np.cos(th)
    g[:, 1] = np.sin(th)
    return g


def bank_from_schedule(schedule: NoteSchedule, config: SineSynthConfig) -> voicebank.VoiceBank:
    V = schedule.n_rows
    inc = freq_to_angle_increment(schedule.frequency, config.sample_rate)
    aliasing = oscillators.freq_aliasing_multiplicator(
        torch.as_tensor(np.asarray(inc, np.float64))).numpy()
    amp = _voice_volumes(config, schedule) * aliasing
    gains = _stereo_gains(schedule.pan, config.n_channels)
    a = config.ahdsr
    vec = lambda x: np.broadcast_to(np.asarray(x, np.float64), (V,)).copy()
    return voicebank.VoiceBank(
        press=np.asarray(schedule.press, np.float64),
        release=np.asarray(schedule.release, np.float64),
        increment=np.asarray(inc, np.float64),
        phase0=np.asarray(schedule.phase, np.float64),
        amp=amp,
        gains=gains,
        attack=vec(a.attack), hold=vec(a.hold), decay=vec(a.decay),
        release_len=vec(a.release), sustain=vec(a.sustain),
        attack_itp=a.attack_itp, decay_itp=a.decay_itp, release_itp=a.release_itp,
    )


def render_schedule(schedule: NoteSchedule, n_samples: int,
                    config: SineSynthConfig, *, device="cuda") -> torch.Tensor:
    """Offline render of a note schedule -> (n_samples, n_channels) tensor."""
    bank = bank_from_schedule(schedule, config)
    return voicebank.render_bank_sparse(
        bank, n_samples, block_size=config.block_size, dtype=config.dtype,
        device=device)


def render_to_wav(schedule: NoteSchedule, n_samples: int, config: SineSynthConfig,
                  path, *, device="cuda") -> torch.Tensor:
    """render_schedule, written to a WAV at `path` through one host copy;
    returns the render on `device`."""
    from ..utils import wav

    out = render_schedule(schedule, n_samples, config, device=device)
    wav.write_wav(path, out.cpu().numpy(), config.sample_rate)
    return out
