"""Additive harmonics synthesizer — the reference MultiEnveloped path.

Reference composition (tune's oscillator synth, source/main.tune.cpp:29-47):
    LowPass< VolumeAdjusted< MultiEnveloped< SineOscillatorAlgo > >, 2 >
`MultiEnveloped` (include/audioelement.h:486-657) holds one Enveloped sine per
harmonic: harmonic i (1-based) runs at i x the fundamental's angle increment
(setAngleIncrements, audioelement.h:613-619), start angle
property.phase + i*a (setStartAngle, audioelement.h:590-594), its own envelope
with identical AHDSR params (so min-change safety floors differ per harmonic
— each Enveloped scales them by its own period), and output
sum_i volume_i * sig_i (step, audioelement.h:529-545).

Mapping: a note with K audible harmonics becomes K ROWS of the shared
voice-bank renderer — the "wrapper object per harmonic" disappears into the
batch dimension. The order-2 low-pass post filter is LTI with zero initial
state, so filtering the mixdown equals filtering each voice (superposition);
we apply it once to the (C, T) output via the FFT cascade fast path.

Port of cpp_audio_tpu/models/harmonics.py: the bank is built on the host as
there; `render_schedule` renders through voicebank.render_bank_sparse (each
segment one launch of csrc/voicebank.cu on a CUDA device) and low-passes the
tensor on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.voices import NoteSchedule
from ..ops import envelopes, filters, oscillators
from ..utils.convert import freq_to_angle_increment
from . import voicebank
from .sine_synth import SINE_BASE_VOLUME, _stereo_gains

AUDIBLE = 1e-6  # reference isAudible threshold (audioelement.h:401-403)


@dataclass(frozen=True)
class HarmonicsSynthConfig:
    sample_rate: int = 44100
    ahdsr: envelopes.AHDSR = None  # type: ignore[assignment]
    harmonic_volumes: tuple = (1.0,)
    harmonic_phases: tuple | None = None  # rad/pi offsets per harmonic
    lowpass_freq: float | None = None     # order-2 LP cutoff in Hz (LowPass.txt)
    lowpass_order: int = 2
    n_channels: int = 2
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


def _trimmed_harmonics(config) -> tuple[np.ndarray, np.ndarray]:
    """Volumes/phases up to the last audible harmonic (setHarmonics,
    audioelement.h:507-521 discards trailing silent harmonics)."""
    vols = np.asarray(config.harmonic_volumes, np.float64)
    audible = np.nonzero(np.abs(vols) > AUDIBLE)[0]
    n = (audible[-1] + 1) if len(audible) else 1
    vols = vols[:n]
    phases = (np.asarray(config.harmonic_phases, np.float64)[:n]
              if config.harmonic_phases is not None else np.zeros(n))
    return vols, phases


def bank_from_schedule(schedule: NoteSchedule, config: HarmonicsSynthConfig) -> voicebank.VoiceBank:
    vols, phases = _trimmed_harmonics(config)
    K = len(vols)
    V = schedule.n_rows

    # rows = notes x harmonics (note-major)
    h_idx = np.tile(np.arange(1, K + 1, dtype=np.float64), V)          # (V*K,)
    rep = lambda a: np.repeat(np.asarray(a, np.float64), K)
    h_vol = np.tile(vols, V)
    h_phase = np.tile(phases, V)

    inc_fund = freq_to_angle_increment(rep(schedule.frequency), config.sample_rate)
    inc = inc_fund * h_idx
    aliasing = oscillators.freq_aliasing_multiplicator(
        torch.as_tensor(np.asarray(inc, np.float64))).numpy()
    amp = config.base_volume * rep(schedule.velocity) * h_vol * aliasing
    # start angle: property.phase + i * note_phase (audioelement.h:590-594)
    phase0 = h_phase + h_idx * rep(schedule.phase)
    gains = np.repeat(_stereo_gains(schedule.pan, config.n_channels), K, axis=0)

    a = config.ahdsr
    vec = lambda x: np.broadcast_to(np.asarray(x, np.float64), (V * K,)).copy()
    return voicebank.VoiceBank(
        press=rep(schedule.press), release=rep(schedule.release),
        increment=inc, phase0=phase0, amp=amp, gains=gains,
        attack=vec(a.attack), hold=vec(a.hold), decay=vec(a.decay),
        release_len=vec(a.release), sustain=vec(a.sustain),
        attack_itp=a.attack_itp, decay_itp=a.decay_itp, release_itp=a.release_itp,
    )


def render_schedule(schedule: NoteSchedule, n_samples: int,
                    config: HarmonicsSynthConfig, *, device="cuda") -> torch.Tensor:
    """Offline render of a note schedule -> (n_samples, n_channels) tensor
    on `device`."""
    bank = bank_from_schedule(schedule, config)
    out = voicebank.render_bank_sparse(
        bank, n_samples, block_size=config.block_size, dtype=config.dtype,
        device=device)
    if config.lowpass_freq is not None:
        inc = freq_to_angle_increment(config.lowpass_freq, config.sample_rate)
        alpha = float(filters.alpha_from_angle_increment(inc, device="cpu"))
        y = filters.cascade_fft(out.T, alpha, order=config.lowpass_order)
        out = y.T.contiguous()
    return out
