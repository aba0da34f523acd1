"""Convolution reverb (reference ReverbPost, include/out.h:166-358 +
useConvolutionReverb, include/audio_context.h:44-71).

The reference partitions the impulse response by block size so convolution
fits the real-time budget (ConvReverbsByBlockSize from cpp.algorithms).
Offline a single FFT convolution of the whole render is both simpler and
faster.

Channel conversion follows the reference (out.h Conversion): an IR with more
channels than the bus is folded down by summing, a mono IR is broadcast.
Wet/dry mixing matches ReverbPost's wet-ratio fade.

Port of cpp_audio_tpu/ops/reverb.py: the IR is host state (read, resampled
on `device`, channel-converted on the host); `apply_reverb` convolves every
channel in one batched FFT convolution on the signal's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import to_tensor
from ..utils import wav as wavio
from .fir import fft_convolve
from .resample import resample_sinc


@dataclass
class Reverb:
    """Impulse-response state (per output channel)."""

    ir: np.ndarray   # (taps, n_channels)
    wet: float = 1.0

    @property
    def latency(self) -> int:
        return 0  # direct convolution has no algorithmic latency

    def channels(self) -> int:
        return self.ir.shape[1]


def load_impulse_response(path, target_sample_rate: int, n_channels: int,
                          *, max_seconds: float | None = None,
                          device="cuda") -> Reverb:
    """Load + resample + channel-convert an IR WAV (useConvolutionReverb).
    The resampling runs on `device`; the IR is kept as a host array."""
    ir, sr = wavio.read_wav(path)
    if max_seconds is not None:
        ir = ir[: int(max_seconds * sr)]
    if sr != target_sample_rate:
        ir = resample_sinc(ir, sr, target_sample_rate, device=device).cpu().numpy()
    ir = convert_channels(ir, n_channels)
    return Reverb(ir=ir)


def convert_channels(ir: np.ndarray, n_channels: int) -> np.ndarray:
    """Reference `Conversion` channel transposition (out.h:262-310)."""
    have = ir.shape[1]
    if have == n_channels:
        return ir
    if have == 1:
        return np.repeat(ir, n_channels, axis=1)
    if have > n_channels:
        # fold extra channels down (sum in round-robin)
        out = np.zeros((ir.shape[0], n_channels))
        for c in range(have):
            out[:, c % n_channels] += ir[:, c]
        return out
    # fewer: cycle the available channels
    return np.stack([ir[:, c % have] for c in range(n_channels)], axis=1)


def apply_reverb(signal, reverb: Reverb, *, dry: float | None = None,
                 device="cuda") -> torch.Tensor:
    """Convolve (frames, C) with the IR; wet/dry mix like ReverbPost.
    Returns a (frames, C) tensor on the signal's device (a host array goes
    to `device`).

    dry defaults to 1-wet (the reference fades wet_ratio between dry and wet,
    out.h:215-247). Channel c convolves with IR column min(c, IR channels - 1).
    """
    signal = to_tensor(signal, device)
    if signal.dim() == 1:
        signal = signal[:, None]
    wet = reverb.wet
    dry = (1.0 - wet) if dry is None else dry
    cols = [min(c, reverb.ir.shape[1] - 1) for c in range(signal.shape[1])]
    h = np.ascontiguousarray(reverb.ir[:, cols].T)
    x = signal.T
    y = fft_convolve(x, h)
    return (wet * y + dry * x).T
