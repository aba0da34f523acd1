"""WAV utilities (reference main.mod_wav / main.wir_2_wav /
main.count_channels / main.join_non_zeros).

Run as: python -m cpp_audio_tpu_torch.apps.wav_tools <tool> <args...>
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..utils import wav as wavio
from ..utils import wir as wirio


def sliding_average(x: np.ndarray, width: int = 20) -> np.ndarray:
    """The reference's `slidingAverage<T>(20)` per channel (main.mod_wav.cpp:10-22)."""
    kernel = np.ones(width) / width
    out = np.empty_like(x)
    for c in range(x.shape[1]):
        # causal running mean over the last `width` samples
        padded = np.concatenate([np.zeros(width - 1), x[:, c]])
        out[:, c] = np.convolve(padded, kernel, mode="valid")
    return out


def mod_wav(src, dst=None, *, width: int = 20) -> str:
    """Sliding-average filter variant of mod_wav (main.mod_wav.cpp:5-23)."""
    src = Path(src)
    dst = Path(dst) if dst else src.with_name("mod_" + src.name)
    data, sr = wavio.read_wav(src)
    wavio.write_wav(dst, sliding_average(data, width), sr)
    return str(dst)


def self_convolve_wav(src, dst=None) -> str:
    """Self-convolution + peak normalization (rewrite_wav, main.mod_wav.cpp:25-55)."""
    src = Path(src)
    dst = Path(dst) if dst else src.with_name("mod_" + src.name)
    data, sr = wavio.read_wav(src)
    out = np.empty_like(data)
    for c in range(data.shape[1]):
        x = data[:, c]
        full = np.fft.irfft(np.fft.rfft(x, 2 * len(x)) ** 2, 2 * len(x))
        out[:, c] = full[: len(x)]
    peak = np.max(np.abs(out))
    if peak > 0:
        out /= peak
    wavio.write_wav(dst, out, sr)
    return str(dst)


def wir_2_wav(src, dst=None) -> str:
    src = Path(src)
    if dst is None:
        dst = src.with_suffix(".wav") if src.suffix == ".wir" else Path(str(src) + ".wav")
    wirio.wir_to_wav(src, dst)
    return str(dst)


def count_channels(src) -> int:
    data, _ = wavio.read_wav(src)
    return data.shape[1]


def join_non_zeros(src, dst=None) -> str:
    """Drop all-zero frames (main.join_non_zeros.cpp)."""
    src = Path(src)
    dst = Path(dst) if dst else src.with_name("joined_" + src.name)
    wavio.filter_frames(src, dst, lambda fr: bool(np.any(fr != 0)))
    return str(dst)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: wav_tools <mod_wav|self_convolve|wir_2_wav|count_channels|join_non_zeros> <file> [dest]")
        return 1
    tool, *rest = argv
    if tool == "count_channels":
        print(count_channels(rest[0]))
        return 0
    fn = {"mod_wav": mod_wav, "self_convolve": self_convolve_wav,
          "wir_2_wav": wir_2_wav, "join_non_zeros": join_non_zeros}[tool]
    print(fn(*rest))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
