"""Output limiter + hygiene (reference cpp.algorithms Limiter<double>, applied
in the post chain at include/out.h:605-648: reverb -> limiter -> clamp ->
NaN guard).

Design (the reference implementation is in the unavailable sibling repo):
an instant-attack / exponential-release peak follower
    p[t] = max(|x[t]|, r * p[t-1])
followed by gain
    g[t] = min(1, ceiling / p[t]).

Port of cpp_audio_tpu/ops/limiter.py. torch has no associative scan, so the
follower runs in two levels: inside chunks of `ch` samples the closed form
p[t] = r^t * max(runmax(x[u] * r^-u), p0 * r) of the JAX package's numpy
form is one torch.cummax over a (chunks, ch) view (ch keeps r^-u below
e^30); across chunks the same recurrence, P[k] = max(e[k], r^ch * P[k-1])
over the chunk ends e[k], runs by doubling (log2(chunks) steps). Every
function computes at its input's dtype on the input's device; a host array
goes to `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_tensor


def _release(release_ms: float, sample_rate: int) -> float:
    return float(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate)))


def _chunk(release: float) -> int:
    """Chunk length of the two-level follower: r^-(ch-1) stays below e^30
    (the JAX package's numpy form, limiter.py:69-70)."""
    logr = np.log(release) if release > 0 else -np.inf
    return max(64, min(4096, int(30.0 / max(-logr, 1e-12))))


def _follow(x_abs: torch.Tensor, release: float, p0) -> torch.Tensor:
    """p[t] = max(x_abs[t], release * p[t-1]) along the last axis of a 1-D
    x_abs, p[-1] = p0 (a float or a 0-d tensor)."""
    n = x_abs.shape[0]
    dt, dev = x_abs.dtype, x_abs.device
    p0 = to_tensor(p0, dev, dt)
    if n == 0:
        return x_abs.clone()
    if release <= 0.0:  # no memory: the follower is |x| (p0 decays at once)
        return x_abs.clone()
    ch = min(_chunk(release), n)
    nc = -(-n // ch)
    x = torch.nn.functional.pad(x_abs, (0, nc * ch - n)).reshape(nc, ch)
    logr = float(np.log(release))
    t = torch.arange(ch, dtype=torch.float64, device=dev)
    rpow = torch.exp(logr * t).to(dt)       # r^t, t < ch
    rinv = torch.exp(-logr * t).to(dt)      # r^-t, bounded by e^30
    # chunk-local follower from 0: r^t * runmax(x[u] * r^-u)
    local = rpow * torch.cummax(x * rinv, dim=1).values
    # carried state entering each chunk: P[k] = max(e[k], R * P[k-1]) over
    # the chunk ends e[k] = local[k, -1], R = r^ch, P[-1] = p0
    R = float(release) ** ch
    P = torch.cat([p0.reshape(1), local[:, -1]])
    s = 1
    while s < P.shape[0]:
        shifted = torch.nn.functional.pad(P[:-s], (s, 0)) * (R ** s)
        P = torch.maximum(P, shifted)
        s *= 2
    # p[k*ch + t] = max(local[k, t], r^(t+1) * P[k-1])
    carry = P[:-1, None] * (rpow * release)
    return torch.maximum(local, carry).reshape(-1)[:n]


def peak_follower(x_abs, release: float, *, axis: int = -1, device="cuda"):
    """p[t] = max(x_abs[t], release * p[t-1]) (p[-1] = 0) along `axis`."""
    x = to_tensor(x_abs, device)
    xm = torch.movedim(x, axis, -1)
    flat = xm.reshape(-1, xm.shape[-1]) if xm.dim() else xm.reshape(1, 1)
    p = torch.stack([_follow(row, release, 0.0) for row in flat]) \
        if flat.shape[0] else flat.clone()
    return torch.movedim(p.reshape(xm.shape), -1, axis)


def _limit(x: torch.Tensor, p0, ceiling: float, release: float):
    x_abs = x.abs().amax(dim=-1) if x.dim() == 2 else x.abs()
    p = _follow(x_abs, release, p0)
    gain = torch.clamp(ceiling / torch.clamp(p, min=1e-12), max=1.0)
    if x.dim() == 2:
        gain = gain[:, None]
    return x * gain, p


def limit(x, *, ceiling: float = 1.0, release_ms: float = 50.0,
          sample_rate: int = 44100, axis: int = 0, device="cuda"):
    """Limit so |output| <= ceiling, with smooth gain recovery.

    x: (frames,) or (frames, channels). Multi-channel input is limited by
    the cross-channel peak so the stereo image is preserved (matching the
    reference's single Limiter on the interleaved bus, out.h:427,605-648).
    axis: the time axis, as in the JAX package: for x of three or more
    dimensions every element is followed on its own along `axis`; for one
    or two it is the frames axis, 0 (or -1 of the peak's one dimension).
    """
    x = to_tensor(x, device)
    release = _release(release_ms, sample_rate)
    if x.dim() > 2:
        p = peak_follower(x.abs(), release, axis=axis, device=x.device)
        return x * torch.clamp(ceiling / torch.clamp(p, min=1e-12), max=1.0)
    if axis not in (0, -1):
        raise ValueError(f"axis {axis} is out of bounds for the peak of a "
                         f"{x.dim()}-D input (one dimension)")
    y, _p = _limit(x, 0.0, ceiling, release)
    return y


def clamp_and_guard(x, limit_val: float = 1.0, *, device="cuda"):
    """Final clamp + NaN->0 guard (reference out.h:620-646)."""
    x = to_tensor(x, device)
    x = torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.clamp(x, -limit_val, limit_val)


def limit_streaming(x, p0=0.0, *, ceiling: float = 1.0,
                    release_ms: float = 50.0, sample_rate: int = 44100,
                    device="cuda"):
    """Block-streaming `limit`: same law, carried follower state.

    Returns (limited_block, p_last). Feeding consecutive blocks with the
    carried p reproduces `limit` over the concatenation (the follower
    recurrence is causal; the two differ only in float rounding). p_last is
    a 0-d tensor on the block's device, so carrying it needs no host read;
    p0 may be a float or such a tensor."""
    x = to_tensor(x, device)
    if x.shape[0] == 0:
        return x.clone(), to_tensor(p0, x.device, x.dtype)
    y, p = _limit(x, p0, ceiling, _release(release_ms, sample_rate))
    return y, p[-1]
