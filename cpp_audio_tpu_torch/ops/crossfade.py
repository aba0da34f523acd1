"""Equal-gain crossfades (cpp.algorithms EqualGainXFade, used by the vocoder
at rt.resynth.lib.vocoder.cpp:530-541 and by channel request transitions).

Equal-gain: the two weights sum to 1 at every point (correlated sources);
shapes: LINEAR and SINUSOIDAL (sin^2 / cos^2).

Port of cpp_audio_tpu/ops/crossfade.py: the weights are host numpy;
`crossfade` and `splice` operate on tensors (host arrays go to `device`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_tensor


def xfade_weights(n: int, shape: str = "sinusoidal", *,
                  inclusive: bool = False):
    """(w_new, w_old) of length n; w_new rises to 1, w_old = 1 - w_new.

    inclusive=False: x = (k+1)/n — the vocoder's half-window overlap
    convention (rt.resynth.lib.vocoder.cpp:530-541), first weight > 0.
    inclusive=True: x = k/(n-1) — the channel request-transition ladder
    (ratio decremented by 1/(size_xfade-1), include/channel.h:235-238,506):
    endpoints ARE 0 and 1 and an odd n puts the exact 0.5 midpoint sample
    in the middle (why xfade sizes are odd >= 3, channel.h:50-60).
    """
    if inclusive:
        x = np.arange(n) / max(n - 1, 1)
    else:
        x = (np.arange(n) + 1.0) / n
    if shape == "linear":
        w_new = x
    elif shape == "sinusoidal":
        w_new = np.sin(0.5 * np.pi * x) ** 2
    else:
        raise ValueError(shape)
    return w_new, 1.0 - w_new


def crossfade(old, new, n: int | None = None, shape: str = "sinusoidal", *,
              device="cuda"):
    """Crossfade old->new over the first n samples (rest = new)."""
    new = to_tensor(new, device)
    old = to_tensor(old, new.device).to(new.device)
    if n is None:
        n = min(old.shape[0], new.shape[0])
    w_new, w_old = xfade_weights(n, shape)
    w_new = torch.as_tensor(w_new, dtype=new.dtype, device=new.device)
    w_old = torch.as_tensor(w_old, dtype=new.dtype, device=new.device)
    if new.dim() == 2:
        w_new = w_new[:, None]
        w_old = w_old[:, None]
    head = new[:n] * w_new + old[:n] * w_old
    return torch.cat([head, new[n:]], dim=0)


def splice(a, b, n_xfade: int, shape: str = "sinusoidal", *, device="cuda"):
    """Concatenate a then b with an n_xfade overlap crossfade (the channel
    request-transition analog, include/channel.h:410-470)."""
    a = to_tensor(a, device)
    b = to_tensor(b, a.device).to(a.device)
    n_xfade = min(n_xfade, a.shape[0], b.shape[0])
    body = crossfade(a[a.shape[0] - n_xfade :], b, n_xfade, shape)
    return torch.cat([a[: a.shape[0] - n_xfade], body], dim=0)
