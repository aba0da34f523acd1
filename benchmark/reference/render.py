"""The tracked-note render of a slot table (cpp.audio's ResynthElement:
StereoPanned< VolumeAdjusted< Enveloped< FreqCtrl_< Sine, InterpolatedFreq
>, AHDSR > > >, rt.resynth.lib.cpp:6-19), in closed form per control frame.

Per frame and slot, over the frame's `stride` samples k = 0 .. S-1:
    phase(k)  = phase at the frame boundary + (inc / lam) * expm1(lam * (k + 1)),
                lam = ratio / S (inc * (k + 1) where the glide is flat)
    volume(k) = target + (boundary volume - target) * (1 - alpha)^(k + 1)
    env(k)    = LINEAR attack / hold / decay / sustain from tp0 + k, the
                release ramp from `top` once tr0 + k >= 0
    aliasing  = the anti-alias fade at the increment of the frame's midpoint
    out(k, c) = sum over slots of volume * env * aliasing * sin(pi * phase) * gain[c]
"""

from __future__ import annotations

import math

import torch

from .precision import Precision
from .tracker import F_GL, F_GR


def render(table: torch.Tensor, *, stride: int, prec: Precision,
           frames_per_chunk: int = 32) -> torch.Tensor:
    """(n_frames, P, 16) table -> (n_frames, stride, 2)."""
    dt = prec.dtype
    n, S = table.shape[0], stride
    k1 = torch.arange(1, S + 1, dtype=dt, device=table.device)
    out = torch.empty((n, S, 2), dtype=dt, device=table.device)
    for f0 in range(0, n, frames_per_chunk):
        tab = table[f0:f0 + frames_per_chunk].to(dt)
        (inc, ratio, phb, vtgt, vb, alpha, tp0, tr0, top, A, H, D, sus, R) = (
            tab[..., i:i + 1] for i in range(14))
        lam = ratio / S
        flat = ratio.abs() < 1e-7
        adv = torch.where(flat, inc * k1,
                          (inc / torch.where(flat, 1.0, lam)) * torch.expm1(lam * k1))
        phase = torch.remainder(phb + adv, 2.0)
        vol = vtgt + (vb - vtgt) * torch.exp(k1 * torch.log1p(-alpha))
        tp = tp0 + (k1 - 1.0)
        trm = tr0 + (k1 - 1.0)
        va = torch.clamp((tp + 1.0) / A, 0.0, 1.0)
        vd = 1.0 + (sus - 1.0) * torch.clamp((tp - A - H + 1.0) / torch.clamp(D, min=1.0), 0.0, 1.0)
        pressed = torch.where(tp < A, va, torch.where(tp < A + H, 1.0,
                                                      torch.where(tp < A + H + D, vd, sus)))
        rel = top * (1.0 - torch.clamp((trm + 1.0) / R, 0.0, 1.0))
        env = torch.where(tp < 0, 0.0, torch.where(trm < 0, pressed, rel))
        mid = torch.abs(inc * torch.exp(lam * (S * 0.5)))
        hspp = torch.where(mid == 0.0, torch.full_like(mid, math.inf),
                           1.0 / torch.clamp(mid, min=1e-30))
        aliasing = torch.clamp((hspp - 1.0) / 3.0, 0.0, 1.0)
        sig = vol * env * aliasing * torch.sin(math.pi * phase)
        out[f0:f0 + frames_per_chunk] = prec.einsum("fps,fpc->fsc", sig,
                                                    tab[..., F_GL:F_GR + 1])
    return out
