"""The voice-bank renderer: batched sine-family note rendering.

Every enveloped sine partial (sine::Synth voices, gen.sine composition
stacks) is one ROW of a (V, T) tile. Per time block:

    phase  = NCO(press, inc)[k]                      # exact uint32 fixed point
    env    = closed-form AHDSR(t - press, ...)       # curves per voice
    sig    = amp[v] * env * sin(pi*phase)
    out    = sig^T @ gains                           # (B,V)@(V,C) mixdown

Port of cpp_audio_tpu/models/voicebank.py. Host precompute (envelope floors,
release `top`, NCO words, per-block compaction) is numpy, as there; every
block render goes through ops/cuda_voicebank.render_blocks, which runs the
hand-written CUDA kernel for CUDA tensors and its plain PyTorch twin for CPU
tensors. `use_pallas` is accepted for the JAX package's signature and
ignored: the tensors' device decides.

NCO words are int64 tensors in [0, 2^32): torch on the CPU has no uint32
add, and a masked int64 computation keeps the low 32 bits exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import dtype_of
from ..ops import cuda_voicebank
from ..utils.interp import Itp, ease_np

NEVER = float(2**62)
_I32_FAR = np.int32(2**31 - 2**24)  # "never" clamp that survives int32 block offsets


@dataclass
class VoiceBank:
    """Host-side SoA description of all partials to render.

    All arrays shape (V,) float64 unless noted. A row is one enveloped sine.
    """

    press: np.ndarray        # absolute first-attack sample
    release: np.ndarray      # absolute release-start sample (NEVER if none)
    increment: np.ndarray    # angle increment (rad/pi) = 2f/sr
    phase0: np.ndarray       # start angle (rad/pi) at the press sample
    amp: np.ndarray          # linear amplitude (volume*aliasing etc.)
    gains: np.ndarray        # (V, C) mixdown gains
    attack: np.ndarray
    hold: np.ndarray
    decay: np.ndarray
    release_len: np.ndarray
    sustain: np.ndarray
    attack_itp: int | np.ndarray = int(Itp.LINEAR)
    decay_itp: int | np.ndarray = int(Itp.LINEAR)
    release_itp: int | np.ndarray = int(Itp.LINEAR)
    auto_release: bool = False

    @property
    def n_rows(self) -> int:
        return len(self.press)


def _host_envelope_derived(bank: VoiceBank):
    """Host f64 precompute of effective envelope params + release top value."""
    min_change = np.floor(0.5 + 2.5 * 2.0 / np.maximum(np.abs(bank.increment), 1e-9))
    A = np.maximum(np.maximum(bank.attack, min_change), 1.0)
    H = np.maximum(bank.hold, 0.0)
    has_decay = bank.sustain < 0.999999
    S = np.where(has_decay, np.clip(bank.sustain, 0.0, 1.0), 1.0)
    D = np.where(has_decay, np.maximum(np.maximum(bank.decay, min_change), 1.0), 0.0)
    R = np.maximum(np.maximum(bank.release_len, min_change), 1.0)

    release = bank.release.copy()
    if bank.auto_release:
        release = np.minimum(release, bank.press + A + H + D)
    skipped = release <= bank.press

    # value at the sample before release (the release 'top', audioelement.h:836-841)
    def host_ease(codes, x):
        if isinstance(codes, (int, np.integer)):
            return ease_np(Itp(int(codes)), x)
        codes = np.asarray(codes)
        out = np.empty(np.broadcast(codes, x).shape)
        for k in np.unique(codes):
            m = codes == k
            out[m] = ease_np(Itp(int(k)), np.broadcast_to(x, out.shape)[m])
        return out

    tp_rel = release - 1.0 - bank.press
    va = host_ease(bank.attack_itp, (tp_rel + 1.0) / A)
    vd = 1.0 + (S - 1.0) * host_ease(bank.decay_itp, (tp_rel - A - H + 1.0) / np.maximum(D, 1.0))
    top = np.where(tp_rel < A, va,
                   np.where(tp_rel < A + H, 1.0, np.where(tp_rel < A + H + D, vd, S)))
    top = np.where(np.isfinite(top), top, 0.0)
    return A, H, D, R, S, release, skipped, top


def retuned_phase0(press, t_change, phase0_old: float,
                   inc_old: float, inc_new: float) -> float:
    """Start angle that makes a frequency change at `t_change` PHASE-
    CONTINUOUS under the kernel's exact uint32 NCO arithmetic (phase counts
    at sample t = (t - press + 1)*inc_fix + phase0_fix mod 2^32): the new
    (inc, phase0) pair reproduces the old phase at the last old-increment
    step, so sample t_change advances from it by one new-increment step —
    the reference's setAngleIncrements retune (Phased, audioelement.h:
    1439-1448; NoteChange path gen.crtp.h:595-618)."""
    TWO32 = 1 << 32
    half = TWO32 >> 1
    io = int(np.round(inc_old * half)) % TWO32
    inew = int(np.round(inc_new * half)) % TWO32
    p0 = int(np.round(phase0_old * half)) % TWO32
    steps = int(t_change) - int(press)  # old-increment steps before t_change
    return ((steps * io + p0 - steps * inew) % TWO32) / half


# packed float field order
_F_AMP, _F_A, _F_H, _F_D, _F_R, _F_S, _F_TOP, _F_SKIP = range(8)
N_FIELDS = 8


def _host_bank_arrays(bank: VoiceBank, dtype: str):
    """numpy (fp, ip, up, gains, codes) for one bank (see prepare_bank_arrays)."""
    A, H, D, R, S, release, skipped, top = _host_envelope_derived(bank)

    TWO32 = 1 << 32
    inc_fix = np.round(bank.increment * (TWO32 / 2.0)).astype(np.int64) % TWO32
    phase0_fix = np.round(bank.phase0 * (TWO32 / 2.0)).astype(np.int64) % TWO32
    press_i = np.clip(bank.press, -_I32_FAR, _I32_FAR).astype(np.int64)
    release_i = np.clip(release, -_I32_FAR, _I32_FAR).astype(np.int64)

    fp = np.stack(
        [bank.amp, A, H, D, R, S, top, skipped.astype(np.float64)], axis=1
    ).astype(np.dtype(dtype))
    ip = np.stack([press_i, release_i], axis=1).astype(np.int32)
    up = np.stack([inc_fix, phase0_fix], axis=1).astype(np.int64)
    codes3 = np.stack(
        [np.broadcast_to(np.asarray(c, np.int32), (bank.n_rows,))
         for c in (bank.attack_itp, bank.decay_itp, bank.release_itp)], axis=1
    )
    gains = np.asarray(bank.gains, np.dtype(dtype))
    return fp, ip, up, gains, codes3


def _stack_jobs(banks, dtype: str):
    """Each bank's host arrays stacked on a leading job axis, as the JAX
    package stacks a batch's (np.stack, JAX chain.py:845-851): the jobs
    must agree on the voice count and the gain channels."""
    per_job = [_host_bank_arrays(b, dtype) for b in banks]
    if not per_job:
        raise ValueError("a batch needs at least one job")
    shapes = [tuple(a.shape for a in arrays) for arrays in per_job]
    if len(set(shapes)) != 1:
        raise ValueError("the jobs' voice tables differ in shape and do not "
                         "stack: (fp, ip, up, gains, codes) shapes per job "
                         f"{shapes}")
    return tuple(np.stack(a) for a in zip(*per_job))


def prepare_bank_arrays(bank, n_samples: int, block_size: int,
                        dtype: str = "float32", *, device="cuda"):
    """Host-side precompute, moved to `device` in one transfer per array.

    Returns ((fp, ip, up, gains, codes) tensors, statics dict with
    block_size and n_blocks). up holds the uint32 NCO words as int64.
    `bank` may be a list of VoiceBanks (a batch of jobs over the same
    n_samples): every table then has a leading job axis, (J, V, ·), and a
    ValueError names the shapes of jobs that do not stack.
    """
    dev = torch.device(device)
    host = (_stack_jobs(bank, dtype) if isinstance(bank, (list, tuple))
            else _host_bank_arrays(bank, dtype))
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host)
    statics = dict(block_size=block_size,
                   n_blocks=(n_samples + block_size - 1) // block_size)
    return args, statics


def compact_block_args(args, statics):
    """Per-block active-voice compaction of prepare_bank_arrays output.

    A voice contributes to block b only if its envelope can be nonzero
    there: press < block_end and release + R > block_start (the AHDSR is
    identically zero outside [press, release + R - 1], reference
    include/audioelement.h:960-999). Each block's active voices are gathered
    into a (n_blocks, V_max) table, V_max padded to a multiple of 8 with
    inert rows (skip=1, press=+FAR). Exact: dropped rows are exact zeros;
    only the mixdown's summation order changes.

    The selection runs on the host (the tables are a few KB); the result
    goes back to the tables' device. Returns ((fpb, ipb, upb, gainsb,
    codesb), statics) with a leading n_blocks axis on every tensor. The
    CUDA kernel selects live rows per sample tile itself, so the chain
    passes it dense tables; this layout serves the JAX package's
    compacted-table contract (voicebank_blocks_compact_impl).
    """
    dev = args[0].device
    fp, ip, up, gains, codes = (a.cpu().numpy() for a in args)
    B = statics["block_size"]
    nb = statics["n_blocks"]
    press = ip[:, 0].astype(np.float64)
    release = ip[:, 1].astype(np.float64)
    R = fp[:, _F_R].astype(np.float64)
    skip = fp[:, _F_SKIP] > 0.5
    lists = [np.nonzero((press < (b + 1) * B)
                        & (release + R > b * B) & ~skip)[0]
             for b in range(nb)]
    vmax = max(8, -(-max((len(a) for a in lists), default=1) // 8) * 8)

    def gather(src, fill):
        out = np.full((nb, vmax) + src.shape[1:], fill, src.dtype)
        for b, idx in enumerate(lists):
            out[b, : len(idx)] = src[idx]
        return out

    fpb = gather(fp, 0.0)
    for b, idx in enumerate(lists):  # inert pad rows
        fpb[b, len(idx):, _F_SKIP] = 1.0
        fpb[b, len(idx):, _F_A] = 1.0
        fpb[b, len(idx):, _F_R] = 1.0
    ipb = gather(ip, _I32_FAR)
    upb = gather(up, 0)
    gainsb = gather(gains, 0.0)
    codesb = gather(codes, 0)
    out = tuple(torch.from_numpy(a).to(dev)
                for a in (fpb, ipb, upb, gainsb, codesb))
    return out, statics


def voicebank_blocks_impl(fp, ip, up, gains, codes, *, block_size: int,
                          n_blocks: int, block_offset: int = 0) -> torch.Tensor:
    """Render n_blocks blocks of block_size samples from one job's dense
    (V, ·) tables, starting at the timeline's block `block_offset` (the
    2-D sharded chain renders its time slice so) -> (n_blocks, block_size,
    C); or from J jobs' (J, V, ·) tables, every job in one kernel launch,
    -> (J, n_blocks, block_size, C)."""
    tables = (fp, ip, up, gains, codes)
    one = fp.dim() == 2
    out = cuda_voicebank.render_blocks(*(cuda_voicebank.one_job(tables) if one else tables),
                                       block_size=block_size, n_blocks=n_blocks,
                                       block_offset=block_offset)
    out = out.view(out.shape[0], n_blocks, block_size, -1)
    return out[0] if one else out


def voicebank_blocks_compact_impl(fpb, ipb, upb, gainsb, codesb, *,
                                  block_size: int, n_blocks: int,
                                  block_offset: int = 0) -> torch.Tensor:
    """voicebank_blocks_impl over one job's per-block compacted voice
    tables (compact_block_args): block b reads its own (V_max, ·) rows and
    renders the timeline's block b + block_offset. Returns (n_blocks,
    block_size, C)."""
    out = cuda_voicebank.render_blocks(
        *cuda_voicebank.one_job((fpb, ipb, upb, gainsb, codesb)),
        block_size=block_size, n_blocks=n_blocks, block_offset=block_offset)
    return out.view(n_blocks, block_size, -1)


def render_bank(bank: VoiceBank, n_samples: int, *, block_size: int = 32768,
                dtype: str = "float32", use_pallas=None,
                device="cuda") -> torch.Tensor:
    """Offline render of a VoiceBank -> (n_samples, C) tensor on `device`.
    use_pallas is accepted for the JAX package's signature and ignored (a
    CUDA tensor always takes the CUDA kernel)."""
    del use_pallas
    args, statics = prepare_bank_arrays(bank, n_samples, block_size, dtype,
                                        device=device)
    out = voicebank_blocks_impl(*args, **statics)
    return out.reshape(-1, out.shape[-1])[:n_samples]


def _slice_bank(bank: VoiceBank, idx: np.ndarray, pad_rows: int,
                time_shift: float) -> VoiceBank:
    """Sub-bank of `idx` rows, shifted by -time_shift, padded with inert rows.

    Shifting press/release (and the render window) together is exact: both
    the NCO phase (phase0 + (t - press + 1)*inc) and the envelope depend only
    on t - press / t - release.
    """
    def take(a, fill=0.0):
        a = np.asarray(a)
        if a.ndim == 0:
            return a
        out = np.full((pad_rows,) + a.shape[1:], fill, dtype=a.dtype)
        out[: len(idx)] = a[idx]
        return out

    def take_itp(c):
        return int(c) if isinstance(c, (int, np.integer)) else take(c, int(Itp.LINEAR))

    # floor BEFORE shifting: the host arrays truncate toward zero, so a
    # fractional press that turns negative after the shift would otherwise
    # round the other way (one-sample offset vs the dense render)
    return VoiceBank(
        press=np.floor(take(bank.press, NEVER)) - time_shift,
        release=np.floor(take(bank.release, NEVER)) - time_shift,
        increment=take(bank.increment, 1.0),
        phase0=take(bank.phase0),
        amp=take(bank.amp),
        gains=take(bank.gains),
        attack=take(bank.attack, 1.0),
        hold=take(bank.hold),
        decay=take(bank.decay, 1.0),
        release_len=take(bank.release_len, 1.0),
        sustain=take(bank.sustain, 1.0),
        attack_itp=take_itp(bank.attack_itp),
        decay_itp=take_itp(bank.decay_itp),
        release_itp=take_itp(bank.release_itp),
        auto_release=bank.auto_release,
    )


def render_bank_sparse(bank: VoiceBank, n_samples: int, *,
                       segment_size: int = 1 << 18, block_size: int = 32768,
                       dtype: str = "float32", use_pallas=None,
                       dense_rows: int = 256, device="cuda") -> torch.Tensor:
    """render_bank for long, sparse schedules: partition the timeline into
    segments and render each with only the voices whose [press, release+R]
    interval overlaps it — O(sum_seg V_active(seg) * segment) instead of
    O(V * T), the analog of the reference's voice pool reusing 127 slots
    (gen.crtp.h:221-225). Row counts are padded to power-of-two buckets, as
    in the JAX package. use_pallas: ignored, as in render_bank.
    """
    del use_pallas
    V = bank.n_rows
    if V <= dense_rows or n_samples <= segment_size:
        return render_bank(bank, n_samples, block_size=block_size,
                           dtype=dtype, device=device)
    min_change = np.floor(0.5 + 2.5 * 2.0 / np.maximum(np.abs(bank.increment), 1e-9))
    R = np.maximum(np.maximum(bank.release_len, min_change), 1.0)
    end = np.minimum(bank.release, float(n_samples)) + R + 2.0
    C = bank.gains.shape[1]
    out = torch.zeros((n_samples, C), dtype=dtype_of(dtype), device=device)
    seg_block = min(block_size, segment_size)
    for t0 in range(0, n_samples, segment_size):
        t1 = min(n_samples, t0 + segment_size)
        idx = np.nonzero((bank.press < t1) & (end > t0))[0]
        if idx.size == 0:
            continue
        rows = max(8, 1 << int(np.ceil(np.log2(idx.size))))
        sub = _slice_bank(bank, idx, rows, float(t0))
        seg = render_bank(sub, segment_size, block_size=seg_block,
                          dtype=dtype, device=device)
        out[t0:t1] += seg[: t1 - t0]
    return out
