"""Text preset formats of the `tune` app (reference source/main.tune.cpp).

  - Envelope*.txt (SynthDef::mkEnvelope, main.tune.cpp:1127-1162): lines
    "A ....": each '.' is 10 ms; sustain = dots/10 (10 dots = 1.0). Attack and
    release use EASE_OUT_CUBIC, decay LINEAR.
  - Harmonics*.txt (mkHarmonics, main.tune.cpp:1973-2001): line length =
    harmonic volume, normalized by the max; empty file -> single harmonic 1.
  - LowPass.txt (mkLowPass, main.tune.cpp:1956-1971): first parsable float is
    the cutoff in Hz, default 440.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.envelopes import AHDSR
from .convert import ms_to_frames
from .interp import Itp


def parse_envelope_file(path, sample_rate: int) -> AHDSR:
    e = {"a": 0, "h": 0, "d": 0, "s": 0, "r": 0}
    for line in Path(path).read_text().splitlines():
        if line:
            key = line[0].lower()
            if key in e:
                e[key] = 10.0 * line.count(".")  # each '.' = 10 ms
    return AHDSR(
        attack=ms_to_frames(e["a"], sample_rate),
        attack_itp=int(Itp.EASE_OUT_CUBIC),
        hold=ms_to_frames(e["h"], sample_rate),
        decay=ms_to_frames(e["d"], sample_rate),
        decay_itp=int(Itp.LINEAR),
        release=ms_to_frames(e["r"], sample_rate),
        release_itp=int(Itp.EASE_OUT_CUBIC),
        sustain=0.1 * e["s"] / 10.0,
    )


def parse_harmonics_file(path) -> np.ndarray:
    """Harmonic volumes (index 0 = fundamental), normalized to max 1."""
    volumes = [float(len(line)) for line in Path(path).read_text().splitlines()]
    m = max(volumes) if volumes else 0.0
    if m <= 0:
        return np.array([1.0])
    return np.asarray(volumes) / m


def parse_lowpass_file(path) -> float:
    for line in Path(path).read_text().splitlines():
        try:
            if line.strip():
                return float(line.strip())
        except ValueError:
            continue
    return 440.0
