"""AHDSR envelope parameters (reference include/audioelement.h:666-1099).

The envelope itself is evaluated in closed form inside the voice-bank render
(models/voicebank.py, csrc/voicebank.cu) and the tracked-note render
(models/resynth_bank.py); this module holds the parameter record and the
reference's 1 ms floor (normalizedMinDt, audioelement.h:863-872).

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

from ..utils.interp import Itp


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
