"""Hybrid double-grade analysis: float32 peak selection, float64 values.

The tracker only consumes the top k peaks of each frame, and the QIFFT only
reads each peak's 3-bin neighbourhood, so the JAX package selects peaks from
the cheap float32 rfft spectrum and re-evaluates only the selected bins in
compensated double-f32 (cpp_audio_tpu/ops/dfft_hybrid.py:302). Hopper has
native float64: here the values come from one float64 rfft of the same
float32 frames (cuFFT D2Z on the card), gathered at b-1, b and b+1.

Port of cpp_audio_tpu/ops/dfft_hybrid.py, `hybrid_peaks_df32` alone. The
factored direct DFT (`_ct_tables`, `dft_bins_df`, `dft_bins3_df`, :81-299)
and its "lean" / "compensated" variants computed a few bins in df32 on the
TPU's matrix unit; float64 needs none of them. Likewise ops/dfft.py (the df32
Stockham FFT) and ops/df32.py (the pair arithmetic) are `torch.fft` at
float64 and `torch.float64` here.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from . import stft as stft_ops


def hybrid_peaks_df32(signal: torch.Tensor, window: torch.Tensor,
                      scale: torch.Tensor, *, window_size: int, stride: int,
                      fft_length: int, sample_rate: int, k: int):
    """float32-select / float64-evaluate analysis of a float32 signal ->
    (freq, mag_db), float64 (n_frames, k), frequency-sorted with -inf
    padding. The values are float64 inside (JAX carries them as df32 pairs
    and returns four float32 limbs).

    window: (window_size,) float64; scale: 0-d float64, the unit-sine
    scale (2 / sum(window))^2. Selection is JAX's (:315-320): the float32
    rfft of frames * float32(window), times float32(scale), through
    `_top_bins`. The float64 half (the spectrum, the three-bin gathers and
    the QIFFT) runs in the span "analysis_f64".
    """
    n = signal.shape[0]
    n_frames = max(0, (n - window_size) // stride + 1)
    frames = stft_ops.frame_signal(signal, window_size, stride, n_frames)
    spec32 = torch.fft.rfft(frames * window.to(torch.float32)[None, :],
                            n=fft_length)
    sq32 = spec32.abs() ** 2 * scale.to(torch.float32)
    bins, top_db = stft_ops._top_bins(sq32, sample_rate=sample_rate,
                                      fft_length=fft_length, k=k)
    nb = fft_length // 2 + 1
    with span("analysis_f64", signal.device):
        sq = stft_ops.frames_sqmag_f64(frames, window, scale, fft_length=fft_length)
        # bins 0 and nb-1 take the -600 dB sentinel in _qifft_df: any in-range
        # neighbour serves there
        sp, sc, sn = (torch.gather(sq, 1, torch.clamp(bins + d, 0, nb - 1))
                      for d in (-1, 0, 1))
        return stft_ops._qifft_df(bins, sp, sc, sn, torch.isfinite(top_db), nb=nb,
                                  sample_rate=sample_rate, fft_length=fft_length)
