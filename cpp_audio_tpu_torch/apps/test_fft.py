"""Spectral-density validation of loudness-adapted (grey) noise — the
reference `test_fft` scheme (source/main.test_fft.cpp:18-117): filters noise
through equal-loudness FIRs of increasing length and prints ASCII log-log
spectral density plots.

Run: python -m cpp_audio_tpu_torch.apps.test_fft [--taps-exp-max 12] [--device cuda]

Port of cpp_audio_tpu/apps/test_fft.py: the FIR convolution runs on
--device (default cuda); the density and the plot are host numpy.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..ops import fir, noise
from ..utils.profiling import string_plot


def spectral_density(x: np.ndarray, sr: int, n_bands: int = 64):
    spec = np.abs(np.fft.rfft(x)) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / sr)
    edges = np.logspace(np.log10(20), np.log10(sr / 2), n_bands + 1)
    out = np.zeros(n_bands)
    for i in range(n_bands):
        sel = (freqs >= edges[i]) & (freqs < edges[i + 1])
        out[i] = spec[sel].mean() if np.any(sel) else 0.0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--taps-exp-max", type=int, default=12,
                    help="test FIR lengths 2^6..2^N (reference goes to 2^16)")
    ap.add_argument("--sample-rate", type=int, default=44100)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the FIR convolution (default cuda)")
    args = ap.parse_args(argv)
    sr = args.sample_rate

    pink = noise.pink_noise_table(1 << 16, sr)
    for e in range(6, args.taps_exp_max + 1):
        taps = (1 << e) - 1
        h = fir.loudness_fir_coefficients(sr, max(2 * (taps + 1), 1024), taps)
        grey = fir.fft_convolve(pink, h, trim_latency=True,
                                device=args.device).cpu().numpy()
        dens = spectral_density(grey, sr)
        print(f"\n== loudness-adapted noise, FIR taps = {taps} "
              f"(log-log spectral density, 20 Hz .. {sr//2} Hz) ==")
        print(string_plot(np.log10(np.maximum(dens, 1e-20)), height=12, width=64))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
