"""AHDSR envelopes in closed form (reference include/audioelement.h:666-1099).

The voice-bank render (models/voicebank.py, csrc/voicebank.cu) and the
tracked-note render (models/resynth_bank.py) evaluate the envelope in their
own tables; `ahdsr_envelope` is the general closed form over a (voices,
time) tile that the carrier synth (models/carrier.py) renders with. This
module also holds the parameter record and the reference's 1 ms floor
(normalizedMinDt, audioelement.h:863-872).

Semantics (see cpp_audio_tpu/ops/envelopes.py for the full derivation):
  - attack sample k (k=0..A-1) has value ease_attack((k+1)/A)
  - hold (H samples) at 1, then decay sample k has 1+(S-1)*ease_decay((k+1)/D),
    then sustain at S; no decay phase when sustain > 0.999999
  - release from the value at the sample before release (`top`), sample k of
    release has top*(1-ease_release((k+1)/R))
  - a release at or before the press skips the note entirely
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import to_tensor
from ..utils.interp import Itp, ease_select

NEVER = np.int64(2**62)  # sentinel for "key never released"


@dataclass
class AHDSR:
    """AHDSR parameters; scalars or per-voice arrays.

    Durations are in samples (like the reference's int32 fields,
    audioelement.h:314-322).
    """

    attack: Any = 100000
    attack_itp: Any = int(Itp.LINEAR)
    hold: Any = 0
    decay: Any = 100000
    decay_itp: Any = int(Itp.LINEAR)
    release: Any = 100000
    release_itp: Any = int(Itp.LINEAR)
    sustain: Any = 0.5

    def with_min_dt(self, sample_rate: int, *, allow_zero_attack: bool = False) -> "AHDSR":
        """Apply the reference's 1ms floor (normalizedMinDt) to A/D/R."""
        if allow_zero_attack:
            return self
        min_dt = sample_rate // 1000
        return AHDSR(
            attack=np.maximum(self.attack, min_dt),
            attack_itp=self.attack_itp,
            hold=np.maximum(self.hold, 0),
            decay=np.maximum(self.decay, min_dt),
            decay_itp=self.decay_itp,
            release=np.maximum(self.release, min_dt),
            release_itp=self.release_itp,
            sustain=self.sustain,
        )


def min_change_duration_from_increment(increment):
    """Enveloped's anti-crack floor: 2.5 signal periods in samples
    (audioelement.h:216-225; period = 2/|inc| per sound.functions.h:70-76)."""
    inc = torch.abs(torch.as_tensor(increment))
    return 2.5 * 2.0 / torch.clamp(inc, min=1e-9)


def _curve(codes, device):
    """(codes tensor, the curve codes that can occur) for ease_select."""
    if torch.is_tensor(codes):
        return codes, None
    host = np.asarray(codes)
    return to_tensor(host, device, torch.int64), sorted(set(np.unique(host).tolist()))


def ahdsr_envelope(t, params: AHDSR, press, release=NEVER, *, min_change=0.0,
                   auto_release: bool = False, dtype=torch.float32, device="cuda"):
    """Closed-form AHDSR value at absolute sample indices `t`.

    t: (T,) or (..., T) absolute sample indices; params: AHDSR with fields
    broadcastable to the voice shape, e.g. (V, 1); press: absolute index of
    the first attack sample, broadcastable (V, 1); release: first release
    sample, NEVER if none; min_change: per-voice safety duration in samples
    (2.5 periods); auto_release: EnvelopeRelease::ReleaseAfterDecay mode.
    Tensors stay on their device (t's decides); host values go to `device`.
    Returns the envelope at the broadcast shape of the inputs (V, T).
    """
    dev = t.device if torch.is_tensor(t) else torch.device(device)

    def f(x):
        return to_tensor(x, dev, dtype)

    t = f(t)
    press = f(press)
    release = f(release)
    min_change = f(min_change)

    sustain_raw = f(params.sustain)
    has_decay = sustain_raw < 0.999999
    sustain = torch.where(has_decay, torch.clamp(sustain_raw, 0.0, 1.0), 1.0)

    A = torch.clamp(torch.maximum(f(params.attack), min_change), min=1.0)
    H = torch.clamp(f(params.hold), min=0.0)
    D = torch.where(has_decay, torch.clamp(torch.maximum(f(params.decay), min_change),
                                           min=1.0), 0.0)
    R = torch.clamp(torch.maximum(f(params.release), min_change), min=1.0)
    D_safe = torch.clamp(D, min=1.0)
    a_itp, a_kinds = _curve(params.attack_itp, dev)
    d_itp, d_kinds = _curve(params.decay_itp, dev)
    r_itp, r_kinds = _curve(params.release_itp, dev)

    if auto_release:
        release = torch.minimum(release, press + A + H + D)

    def env_pressed(tp):
        """Envelope during the pressed phases at local time tp (>= 0)."""
        va = ease_select(a_itp, (tp + 1.0) / A, a_kinds)
        vd = 1.0 + (sustain - 1.0) * ease_select(d_itp, (tp - A - H + 1.0) / D_safe,
                                                 d_kinds)
        return torch.where(tp < A, va, torch.where(
            tp < A + H, 1.0, torch.where(tp < A + H + D, vd, sustain)))

    skipped = release <= press  # pressed and immediately released -> no note
    tp = t - press
    top = env_pressed(release - 1.0 - press)
    k_rel = t - release + 1.0
    v_rel = top * (1.0 - ease_select(r_itp, k_rel / R, r_kinds))
    return torch.where((tp < 0) | skipped, 0.0, torch.where(
        t < release, env_pressed(tp), torch.where(k_rel < R, v_rel, 0.0)))


def envelope_end_time(params: AHDSR, press, release, *, min_change=0.0,
                      auto_release: bool = False):
    """First sample index at which the envelope is guaranteed 0 forever
    after (host numpy)."""
    A = np.maximum(np.maximum(np.asarray(params.attack, np.float64), min_change), 1.0)
    H = np.maximum(np.asarray(params.hold, np.float64), 0.0)
    sustain = np.asarray(params.sustain, np.float64)
    has_decay = sustain < 0.999999
    D = np.where(has_decay, np.maximum(np.maximum(np.asarray(params.decay, np.float64),
                                                  min_change), 1.0), 0.0)
    R = np.maximum(np.maximum(np.asarray(params.release, np.float64), min_change), 1.0)
    release = np.asarray(release, np.float64)
    if auto_release:
        release = np.minimum(release, np.asarray(press, np.float64) + A + H + D)
    return release + R
