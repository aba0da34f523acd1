"""The voice bank, sample by sample: every voice an enveloped sine.

For each voice (host float64 fields, as the benchmark made them):
    phase word(t) = ((t - press + 1) * round(inc * 2^31) + round(phase0 * 2^31)) mod 2^32
    phase(t)      = the word read as a signed 32-bit count, times 2^-31 (rad/pi)
    env(t)        = LINEAR attack, hold, decay to sustain, then the release
                    ramp from the value held at the sample before the release
    out(t, c)     = sum over voices of amp * env(t) * sin(pi * phase(t)) * gain[c]
The voice bank's semantics (a fixed-point NCO, the reference's envelope
floors: A, D, R at least 2.5 periods and 1 sample). Rendered in blocks of
samples, over the voices that sound in each block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import Precision

TWO32 = 1 << 32


def envelope_fields(v: dict) -> dict:
    """The effective A, H, D, R, S, the release sample and its `top` value."""
    inc = np.asarray(v["increment"], np.float64)
    min_change = np.floor(0.5 + 2.5 * 2.0 / np.maximum(np.abs(inc), 1e-9))
    A = np.maximum(np.maximum(v["attack"], min_change), 1.0)
    H = np.maximum(v["hold"], 0.0)
    has_decay = v["sustain"] < 0.999999
    S = np.where(has_decay, np.clip(v["sustain"], 0.0, 1.0), 1.0)
    D = np.where(has_decay, np.maximum(np.maximum(v["decay"], min_change), 1.0), 0.0)
    R = np.maximum(np.maximum(v["release_len"], min_change), 1.0)
    press, release = np.asarray(v["press"], np.float64), np.asarray(v["release"], np.float64)
    tp = release - 1.0 - press
    va = np.clip((tp + 1.0) / A, 0.0, 1.0)
    vd = 1.0 + (S - 1.0) * np.clip((tp - A - H + 1.0) / np.maximum(D, 1.0), 0.0, 1.0)
    with np.errstate(invalid="ignore"):
        top = np.where(tp < A, va, np.where(tp < A + H, 1.0, np.where(tp < A + H + D, vd, S)))
    top = np.where(np.isfinite(top), top, 0.0)
    return dict(A=A, H=H, D=D, R=R, S=S, top=top, skipped=release <= press)


def render(v: dict, n: int, prec: Precision, device, block: int = 1 << 17) -> torch.Tensor:
    """(n, C) render of the voices `v` (dict of host arrays: press, release,
    increment, phase0, amp, gains (V, C), attack, hold, decay, release_len,
    sustain; every curve LINEAR)."""
    e = envelope_fields(v)
    press = np.asarray(v["press"], np.float64)
    release = np.asarray(v["release"], np.float64)
    inc_w = np.round(np.asarray(v["increment"], np.float64) * (TWO32 / 2)).astype(np.int64) % TWO32
    ph0_w = np.round(np.asarray(v["phase0"], np.float64) * (TWO32 / 2)).astype(np.int64) % TWO32
    end = np.where(release < press, press, release) + np.ceil(e["R"])
    sounding = ~e["skipped"] & (press < n) & (v["amp"] != 0)
    gains = np.asarray(v["gains"], np.float64)
    out = torch.zeros((n, gains.shape[1]), dtype=prec.dtype, device=device)
    dt = prec.dtype
    for b0 in range(0, n, block):
        b1 = min(n, b0 + block)
        rows = np.nonzero(sounding & (press < b1) & (end > b0))[0]
        if len(rows) == 0:
            continue
        col = lambda a: torch.as_tensor(np.asarray(a, np.float64)[rows], dtype=dt,  # noqa: E731
                                        device=device)[:, None]
        t = torch.arange(b0, b1, dtype=torch.int64, device=device)[None, :]
        p_i = torch.as_tensor(press[rows].astype(np.int64), device=device)[:, None]
        r_i = torch.as_tensor(np.minimum(release[rows], 2.0**62).astype(np.int64),
                              device=device)[:, None]
        tp = (t - p_i).to(dt)
        trm = (t - r_i).to(dt)
        A, H, D, R, S, top = (col(e[k]) for k in ("A", "H", "D", "R", "S", "top"))
        va = torch.clamp((tp + 1.0) / A, 0.0, 1.0)
        vd = 1.0 + (S - 1.0) * torch.clamp((tp - A - H + 1.0) / torch.clamp(D, min=1.0), 0.0, 1.0)
        pressed = torch.where(tp < A, va, torch.where(tp < A + H, 1.0,
                                                      torch.where(tp < A + H + D, vd, S)))
        rel = top * (1.0 - torch.clamp((trm + 1.0) / R, 0.0, 1.0))
        env = torch.where(tp < 0, 0.0, torch.where(trm < 0, pressed,
                                                   torch.where(trm + 1.0 < R, rel, 0.0)))
        word = (((t - p_i + 1) % TWO32) * torch.as_tensor(inc_w[rows], device=device)[:, None]
                + torch.as_tensor(ph0_w[rows], device=device)[:, None]) % TWO32
        signed = (torch.where(word >= TWO32 // 2, word - TWO32, word).to(torch.float64)
                  * 2.0**-31).to(dt)
        sig = col(v["amp"]) * env * torch.sin(math.pi * signed)
        out[b0:b1] = prec.einsum("vt,vc->tc", sig, torch.as_tensor(gains[rows], device=device))
    return out
