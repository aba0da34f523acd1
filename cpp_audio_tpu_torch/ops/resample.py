"""Sinc resampling (reference cpp.algorithms `resampleSinc` /
InterlacedBuffer, used to match impulse-response sample rates in
useConvolutionReverb, include/audio_context.h:44-71).

Windowed-sinc interpolation evaluated as one batched gather+reduce on the
device: output sample i needs `taps` neighbouring input samples weighted by
a Hann-windowed sinc at fractional offsets — a (n_out, taps) elementwise
product reduced over taps, fully parallel.

Port of cpp_audio_tpu/ops/resample.py: every channel is gathered at once
((n_out, taps, C)), in chunks of output samples that keep the gathered
tensor under _CHUNK_BYTES. Positions are float64 for float64 input and
float32 otherwise, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ..device import to_tensor

_CHUNK_BYTES = 256 << 20  # gathered (chunk, taps, C) elements per pass


def _resample_kernel(x, step: float, *, i0: int, i1: int, taps: int):
    """Output samples [i0, i1) of x (n, C) resampled by `step` input samples
    per output sample -> (i1 - i0, C)."""
    pdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    # position of output sample i in input coordinates
    pos = torch.arange(i0, i1, dtype=pdt, device=x.device) * step
    base = torch.floor(pos).to(torch.int64)
    frac = pos - base
    k = torch.arange(-(taps // 2) + 1, taps // 2 + 1, device=x.device)
    idx = torch.clamp(base[:, None] + k[None, :], 0, x.shape[0] - 1)
    t = k[None, :] - frac[:, None]
    # anti-aliasing: scale the sinc cutoff when downsampling
    cutoff = min(1.0, 1.0 / step)
    s = torch.sinc(t * cutoff) * cutoff
    w = 0.5 + 0.5 * torch.cos(math.pi * t / (taps // 2 + 1))  # Hann over the support
    return torch.sum(x[idx] * (s * w).to(x.dtype)[..., None], dim=1)


def resample_sinc(x, sr_from: int, sr_to: int, *, taps: int = 64,
                  device="cuda") -> torch.Tensor:
    """Resample 1-D or (frames, channels) audio between sample rates; a
    tensor on x's device (a host array goes to `device`)."""
    x = to_tensor(x, device)
    if sr_from == sr_to:
        return x
    step = sr_from / sr_to
    n_out = int(math.floor((x.shape[0] - 1) / step)) + 1
    x2 = x[:, None] if x.dim() == 1 else x
    per_out = taps * x2.shape[1] * max(x2.element_size(), 8)
    chunk = max(1, _CHUNK_BYTES // per_out)
    out = torch.cat([_resample_kernel(x2, step, i0=i0, i1=min(n_out, i0 + chunk), taps=taps)
                     for i0 in range(0, n_out, chunk)])
    return out[:, 0] if x.dim() == 1 else out
