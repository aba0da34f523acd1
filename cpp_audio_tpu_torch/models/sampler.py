"""Sampler: pitched sample playback (reference SamplerAlgo,
include/audioelement.h:3274-3383, and tune's sampler synths,
source/main.tune.cpp:108,1237-1790).

Reference semantics: a note's angle increment selects the mapped sample at
the smallest key >= the increment (lower_bound; samples are pre-pitched), the
sample plays straight through from the press sample (negative progress =
delayed start), wrapped in an AHDSR envelope (TuneSamplerElement).

All selected samples are packed into one flat device buffer; rendering is a
batched gather — row v reads buffer[offset_v + (t - press_v)] masked to the
sample's length, times the closed-form envelope, then the gain mixdown.
Zero-crossing trimming of loaded WAVs follows tune's SampleAlgoDetailStats
cleanup (main.tune.cpp:1237-1290).

Port of cpp_audio_tpu/models/sampler.py. The JAX package renders one
(V, n_samples) tile; here the timeline is cut into blocks and each block
renders only the notes whose span [press, min(press + len, release + R))
overlaps it, in voice order (in voice chunks when a block's tile would pass
_TILE_ELEMENTS), so no (V, n_samples) tensor is ever built.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from dataclasses import dataclass

import numpy as np
import torch

from ..core.events import Note
from ..device import dtype_of
from ..ops import envelopes
from ..utils.convert import freq_to_angle_increment

REDUCE_UNADJUSTED_VOLUMES = 0.1  # SamplerAlgo::baseVolume (audioelement.h:3278)

_BLOCK = 1 << 15            # samples per time block of _render_sampler
_TILE_ELEMENTS = 1 << 22    # most (voices x samples) rendered in one pass


def trim_sample(data: np.ndarray, threshold: float = 1e-4) -> np.ndarray:
    """Strip leading/trailing silence and cut at zero crossings
    (tune's sample cleanup, main.tune.cpp:1237-1290)."""
    mono = data if data.ndim == 1 else data.mean(axis=1)
    nz = np.nonzero(np.abs(mono) > threshold)[0]
    if len(nz) == 0:
        return data[:0]
    start, end = int(nz[0]), int(nz[-1]) + 1
    # move to the nearest zero crossings (stop at exact zeros too)
    sign = np.signbit(mono)
    while start > 0 and mono[start - 1] != 0 and sign[start] == sign[start - 1]:
        start -= 1
    while end < len(mono) - 1 and mono[end] != 0 and sign[end] == sign[end - 1]:
        end += 1
    return data[start:end]


class SampleMap:
    """increment -> sample buffer map with lower_bound selection."""

    def __init__(self):
        self._incs: list[float] = []
        self._samples: list[np.ndarray] = []

    def add(self, increment: float, sample: np.ndarray) -> None:
        i = bisect_left(self._incs, increment)
        self._incs.insert(i, increment)
        self._samples.insert(i, np.asarray(sample, np.float64).reshape(-1))

    def add_for_frequency(self, freq: float, sample_rate: int, sample) -> None:
        self.add(freq_to_angle_increment(freq, sample_rate), sample)

    def select(self, increment: float) -> np.ndarray | None:
        """lower_bound: smallest key >= increment (audioelement.h:3326-3331)."""
        i = bisect_left(self._incs, increment)
        if i >= len(self._incs):
            return None
        return self._samples[i]

    def select_index(self, increment: float) -> int:
        i = bisect_left(self._incs, increment)
        return i if i < len(self._incs) else -1

    def __len__(self) -> int:
        return len(self._incs)


@dataclass(frozen=True)
class SamplerConfig:
    sample_rate: int = 44100
    ahdsr: envelopes.AHDSR = None  # type: ignore[assignment]
    n_channels: int = 2
    base_volume: float = REDUCE_UNADJUSTED_VOLUMES
    dtype: str = "float32"

    def __post_init__(self):
        if self.ahdsr is None:
            object.__setattr__(
                self, "ahdsr",
                # sampler handles the attack itself -> AllowZeroAttack::Yes
                envelopes.AHDSR(attack=0, hold=0, decay=0, release=4410, sustain=1.0),
            )


def _render_tile(buf, fp, ip, gains, t0: int, t1: int) -> torch.Tensor:
    """Samples [t0, t1) of the rows of fp (V, 4) [amp, A, R, sample length]
    and ip (V, 3) int64 [press, release, buffer offset], mixed by gains
    (V, C) -> (t1 - t0, C). The JAX package's per-sample formula at fp's
    dtype."""
    wdt = fp.dtype
    t = torch.arange(t0, t1, dtype=torch.int64, device=fp.device)[None, :]
    press, release, off = ip[:, 0:1], ip[:, 1:2], ip[:, 2:3]
    amp, A, R, slen = (fp[:, i:i + 1] for i in range(4))

    prog = t - press
    tp = prog.to(wdt)
    in_range = (prog >= 0) & (tp < slen)
    idx = torch.clamp(off + prog, 0, buf.shape[0] - 1)
    sig = torch.where(in_range, buf[idx], 0.0)

    trm = (t - release).to(wdt)
    A1 = torch.clamp(A, min=1.0)
    env_a = torch.clamp((tp + 1.0) / A1, 0.0, 1.0)
    top = torch.clamp((release - press).to(wdt) / A1, 0.0, 1.0)
    env = torch.where(trm < 0, env_a,
                      top * (1.0 - torch.clamp((trm + 1.0) / torch.clamp(R, min=1.0), 0.0, 1.0)))
    return (amp * env * sig).T @ gains


def _render_sampler(buf, fp, ip, gains, span, *, n_samples: int) -> torch.Tensor:
    """Time-blocked render -> (n_samples, C) at fp's dtype on its device.
    span (V, 2) host int64 [first, end) bounds every row's nonzero samples;
    block [t0, t1) of _BLOCK samples renders only the rows whose span
    overlaps it, in voice order, at most _TILE_ELEMENTS // _BLOCK rows per
    pass."""
    out = torch.zeros((n_samples, gains.shape[1]), dtype=fp.dtype, device=fp.device)
    blocks, lists = [], []
    for t0 in range(0, n_samples, _BLOCK):
        t1 = min(n_samples, t0 + _BLOCK)
        rows = np.nonzero((span[:, 0] < t1) & (span[:, 1] > t0))[0]
        if rows.size:
            blocks.append((t0, t1, rows.size))
            lists.append(rows)
    if not blocks:
        return out
    # every block's row list in one host-to-device copy
    all_rows = torch.as_tensor(np.concatenate(lists), device=fp.device)
    per_pass = max(1, _TILE_ELEMENTS // _BLOCK)
    pos = 0
    for t0, t1, n_rows in blocks:
        rows = all_rows[pos:pos + n_rows]
        pos += n_rows
        for r0 in range(0, n_rows, per_pass):
            r = rows[r0:r0 + per_pass]
            out[t0:t1] += _render_tile(buf, fp[r], ip[r], gains[r], t0, t1)
    return out


def render_notes(notes: list[Note], sample_map: SampleMap, n_samples: int,
                 config: SamplerConfig, *, device="cuda") -> torch.Tensor:
    """Render sampler notes -> (n_samples, C) tensor on `device`."""
    dev = torch.device(device)
    wdt = dtype_of(config.dtype)
    sel = []
    for note in notes:
        inc = freq_to_angle_increment(note.frequency, config.sample_rate)
        si = sample_map.select_index(inc)
        # zero-length mapped samples render silence (the reference's imag()
        # range check, audioelement.h:3343) — drop them so the packed
        # buffer gather never sees an empty row
        if si >= 0 and len(sample_map._samples[si]) > 0:
            sel.append((note, si))
    if not sel:
        return torch.zeros((n_samples, config.n_channels), dtype=wdt, device=dev)

    used = sorted({si for _, si in sel})
    offsets = {}
    parts = []
    pos = 0
    for si in used:
        s = sample_map._samples[si]
        offsets[si] = pos
        parts.append(s)
        pos += len(s)
    buf = np.concatenate(parts)

    V = len(sel)
    fp = np.zeros((V, 4))
    ip = np.zeros((V, 3), np.int64)
    gains = np.zeros((V, config.n_channels))
    a = config.ahdsr
    A = max(float(np.max(np.asarray(a.attack))), 1.0)
    R = max(float(np.max(np.asarray(a.release))), config.sample_rate / 1000.0)
    for v, (note, si) in enumerate(sel):
        s = sample_map._samples[si]
        fp[v] = [config.base_volume * note.velocity, A, R, len(s)]
        rel = min(note.release, 2**30)
        ip[v] = [note.press, rel, offsets[si]]
        th = 0.25 * np.pi * (note.pan + 1.0)
        if config.n_channels >= 2:
            gains[v, 0], gains[v, 1] = np.cos(th), np.sin(th)
        else:
            gains[v, 0] = 1.0
    # the sample ends at press + len; the release tail is zero from
    # release + R - 1 on (one sample of margin for the float compare)
    end = np.minimum(ip[:, 0] + fp[:, 3].astype(np.int64),
                     ip[:, 1] + math.ceil(R) + 1)
    span = np.stack([ip[:, 0], end], axis=1)
    dt = np.dtype(config.dtype)
    return _render_sampler(
        torch.as_tensor(buf.astype(dt), device=dev),
        torch.as_tensor(fp.astype(dt), device=dev),
        torch.as_tensor(ip, device=dev),
        torch.as_tensor(gains.astype(dt), device=dev),
        span, n_samples=n_samples)
