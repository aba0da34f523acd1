"""Tracked-note renderer: voices with control-rate frequency/volume targets.

The ResynthElement of the reference (source/rt.resynth.lib.cpp:6-19):
    StereoPanned< VolumeAdjusted< Enveloped< FreqCtrl_< Sine,
        InterpolatedFreq >, AHDSR > > >
Every analysis stride the pitch tracker retargets a voice's frequency and
volume (NoteChange). Per stride the reference then:
  - glides frequency from the previous value to the target exponentially in
    pitch over exactly `stride` samples (InterpolatedFreq with the
    PROPORTIONAL_VALUE_DERIVATIVE trick, include/audioelement.h:2706-2817)
  - low-passes the volume toward the target with per-sample speed capped at
    max_filter_increment = 2/stride (rt.resynth.lib.cpp:100-104 +
    BaseVolumeAdjusted::step, audioelement.h:1195-1216)

Closed forms per control frame (f(t) = from * exp(lambda*t),
lambda = ln(to/from)/stride):
  phase advance  Dphi(k) = (from/lambda) * expm1(lambda * k)
  volume         v(k)    = target + (v_boundary - target) * (1-alpha)^(k+1)
so the whole tile is elementwise — no per-sample recurrence. Frame-boundary
phases and volumes are tiny recurrences computed exactly on the host in f64.

Layout: like the reference's fixed 127-voice pool (rt.resynth.lib.cpp:208),
notes are packed into polyphony SLOTS; the renderer computes
(n_slots, stride) per control frame.

Port of cpp_audio_tpu/models/resynth_bank.py: the 16-field table and the
fidelity chain's 17-field one, whose phase advance is computed in float64.
The host table packer is copied. The render drops the JAX package's
lax.cond split ladder. On a CUDA device it is one launch of the hand-written
kernel (ops/cuda_render, csrc/tracked_render.cu), which renders only the
slots that can sound in each tile of a frame (live_slots); on the CPU it is
the plain PyTorch twin, _render_slots_plain, which bounds memory by
rendering a chunk of frames at a time (eager PyTorch materialises every
intermediate that XLA fused).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import dtype_of
from ..ops import cuda_render, envelopes, oscillators
from ..utils.interp import Itp

# elements per (frames, slots, stride) intermediate of one job in one render
# chunk: 2^24 f32 = 64 MB, a dozen intermediates live at once
_RENDER_CHUNK_ELEMS = 1 << 24
# a batch's chunk spans every job: one job's frames per chunk, so a batch of
# B makes as many passes as one job, up to 16 jobs' worth of elements per
# intermediate (2^28 f32 = 1 GiB, ~12 GiB live at once); larger batches
# take fewer frames per chunk
_RENDER_BATCH_CHUNK_ELEMS = 1 << 28

NEVER_FRAME = 10**9
# packed per-(frame, slot) field order
(_F_INC, _F_RATIO, _F_PHB, _F_VTGT, _F_VB, _F_ALPHA, _F_TP0, _F_TR0,
 _F_TOP, _F_A, _F_H, _F_D, _F_SUS, _F_R, _F_GL, _F_GR) = range(16)
N_FIELDS = 16
# the fidelity chain's table: field 16 holds the rest of the row increment,
# inc - float32(inc), so field 0 + field 16 is the increment
_F_INC_LO = 16
N_FIELDS_DF = 17


@dataclass
class TrackedNote:
    """One tracked voice: control-point trail on the analysis grid.

    frames[i] is (control_frame_index, frequency_hz, volume); the first entry
    is the NoteOn. release_frame is the control frame of the NoteOff
    (NEVER_FRAME if the note still plays at the end).
    """

    frames: list
    release_frame: int = NEVER_FRAME
    pan: float = 0.0
    # start angle (rad/pi) assigned at NoteOn; None = draw from the slot
    # packer's sequential pool (stable draw_indexing assigns it here)
    phase: float | None = None


@dataclass(frozen=True)
class TrackedRenderConfig:
    sample_rate: int
    stride: int                     # samples per control frame
    start_sample: int = 0           # absolute sample of control frame 0
    ahdsr: envelopes.AHDSR = None   # type: ignore[assignment]
    n_channels: int = 2
    n_slots: int = 128              # polyphony (reference: 127 voices)
    dtype: str = "float32"
    # oracle replay: start angles in rad/pi consumed per packed note in
    # note-on order (mersenne<SEEDED::Yes> stream, gen.crtp.h:152);
    # None = numpy RNG(0)
    phase_draw_values: object = None

    def __post_init__(self):
        if self.ahdsr is None:
            # rt.resynth defaults: 0s AHDSR, sustain 1 (rt.resynth.lib.cpp:957-961)
            # -> 1ms floors via AllowZeroAttack::No
            object.__setattr__(
                self, "ahdsr",
                envelopes.AHDSR(attack=0, hold=0, decay=0, release=0, sustain=1.0,
                                attack_itp=int(Itp.LINEAR), decay_itp=int(Itp.LINEAR),
                                release_itp=int(Itp.LINEAR)).with_min_dt(self.sample_rate),
            )


def _note_windows(notes, n_frames, config):
    """Per-note effective frame window [f0, f1) incl. the release tail,
    plus effective envelope params (reference floors: 1 ms + 2.5 periods)."""
    sr = config.sample_rate
    S = config.stride
    a = config.ahdsr
    min_dt = sr / 1000.0
    sus_raw = float(np.asarray(a.sustain))
    has_decay = sus_raw < 0.999999
    sus = min(max(sus_raw, 0.0), 1.0) if has_decay else 1.0
    wins = []
    for note in notes:
        f0 = note.frames[0][0]
        init_inc = 2.0 * note.frames[0][1] / sr
        min_change = np.floor(0.5 + 2.5 * 2.0 / max(abs(init_inc), 1e-9))
        A = max(float(np.max(np.asarray(a.attack))), min_dt, min_change, 1.0)
        H = max(float(np.max(np.asarray(a.hold))), 0.0)
        D = max(float(np.max(np.asarray(a.decay))), min_dt, min_change, 1.0) if has_decay else 0.0
        R = max(float(np.max(np.asarray(a.release))), min_dt, min_change, 1.0)
        rel_f = min(note.release_frame, n_frames)
        # active until release + R samples
        f1 = min(n_frames, rel_f + int(np.ceil(R / S)) + 1)
        wins.append((f0, f1, A, H, D, sus, R, rel_f))
    return wins


def _build_slot_tables(notes: list[TrackedNote], n_frames: int,
                       config: TrackedRenderConfig):
    """Pack notes into polyphony slots; emit (n_frames, n_slots, N_FIELDS)."""
    P = config.n_slots
    S = config.stride
    sr = config.sample_rate
    sus = float(np.asarray(config.ahdsr.sustain))

    table = np.zeros((n_frames, P, N_FIELDS))
    table[:, :, _F_INC] = 1e-6
    table[:, :, _F_A] = 1.0
    table[:, :, _F_D] = 0.0
    table[:, :, _F_SUS] = 1.0
    table[:, :, _F_R] = 1.0
    table[:, :, _F_TP0] = -1e9  # inactive: tp < 0 -> env 0

    wins = _note_windows(notes, n_frames, config)
    slot_free_at = np.zeros(P, dtype=np.int64)  # frame at which slot is free
    order = np.argsort([w[0] for w in wins], kind="stable")
    rng = np.random.default_rng(0)
    phase_vals = (None if config.phase_draw_values is None
                  else np.asarray(config.phase_draw_values, np.float64))
    phase_i = 0
    FAR = 1e12

    def env_pressed(tp, A, H, D, sus):
        if tp < A:
            return min(max((tp + 1.0) / A, 0.0), 1.0)
        if tp < A + H:
            return 1.0
        if D and tp < A + H + D:
            return 1.0 + (sus - 1.0) * min((tp - A - H + 1.0) / D, 1.0)
        return sus

    for ni in order:
        note = notes[ni]
        f0, f1, A, H, D, sus, R, rel_f = wins[ni]
        if f0 >= n_frames or f1 <= f0:
            continue
        cand = np.nonzero(slot_free_at <= f0)[0]
        if len(cand) == 0:
            continue  # polyphony exceeded: drop (reference onDroppedNote)
        slot = int(cand[0])
        slot_free_at[slot] = f1

        press = f0 * S
        release = note.release_frame * S if note.release_frame < NEVER_FRAME else FAR
        top = env_pressed(release - 1.0 - press, A, H, D, sus) if release < FAR else sus

        th = 0.25 * np.pi * (note.pan + 1.0)
        gl, gr = np.cos(th), np.sin(th)

        # control trail across the note's frames
        if note.phase is not None:
            phase = float(note.phase) % 2.0  # stable draw_indexing
        elif phase_vals is not None and phase_i < len(phase_vals):
            phase = float(phase_vals[phase_i]) % 2.0
            phase_i += 1
        else:
            phase = rng.uniform(0.0, 2.0)  # DefaultStartPhase::Random
            phase_i += 1
        i = 0
        cur_f, cur_v = note.frames[0][1], note.frames[0][2]
        prev_inc = 2.0 * cur_f / sr
        vol_b = cur_v  # volume filter inits at target
        for c in range(f0, f1):
            if i + 1 < len(note.frames) and note.frames[i + 1][0] <= c:
                i += 1
                cur_f, cur_v = note.frames[i][1], note.frames[i][2]
            inc_to = 2.0 * cur_f / sr
            inc_from = prev_inc if c > f0 else inc_to
            ratio = np.log(inc_to / inc_from) if inc_to != inc_from else 0.0
            inc_eff = min(2.0 / S, abs(inc_to))
            alpha = 1.0 - np.exp(-np.pi * inc_eff)

            row = table[c, slot]
            row[_F_INC] = inc_from
            row[_F_RATIO] = ratio
            row[_F_PHB] = phase
            row[_F_VTGT] = cur_v
            row[_F_VB] = vol_b
            row[_F_ALPHA] = alpha
            row[_F_TP0] = c * S - press
            row[_F_TR0] = max(c * S - release, -FAR)
            row[_F_TOP] = top
            row[_F_A] = A
            row[_F_H] = H
            row[_F_D] = D
            row[_F_SUS] = sus
            row[_F_R] = R
            row[_F_GL] = gl
            row[_F_GR] = gr

            # advance boundary state exactly (f64 host)
            dphi = (inc_from / (ratio / S)) * np.expm1(ratio) if ratio else S * inc_from
            phase = (phase + dphi) % 2.0
            vol_b = cur_v + (vol_b - cur_v) * (1.0 - alpha) ** S
            prev_inc = inc_to
    return table


def _phase_trajectory(inc, ratio, phb, k1, S: int):
    """Wrapped phases phb + Dphi(k) of a tile, in the dtype of its inputs:
    Dphi(k) = (inc/lambda) * expm1(lambda*(k+1)), lambda = ratio/S, or
    inc*(k+1) where the glide is flat."""
    lam = ratio / S
    small = torch.abs(ratio) < 1e-7
    adv = torch.where(
        small, inc * k1,
        (inc / torch.where(small, 1.0, lam)) * torch.expm1(lam * k1))
    return oscillators.wrap_phase(phb + adv)


def pressed_envelope(tp, A, H, D, sus):
    """The LINEAR AHDSR envelope before the release, at tp samples after
    the press (tp >= 0): attack ramp, hold, decay ramp, sustain. Non-
    increasing in tp once the attack is over."""
    va = torch.clamp((tp + 1.0) / A, 0.0, 1.0)
    vd = 1.0 + (sus - 1.0) * torch.clamp(
        (tp - A - H + 1.0) / torch.clamp(D, min=1.0), 0.0, 1.0)
    return torch.where(tp < A, va, torch.where(
        tp < A + H, 1.0, torch.where(tp < A + H + D, vd, sus)))


def release_envelope(trm, top, R):
    """The release ramp from `top`, at trm samples after the release (trm
    >= 0): non-increasing in trm."""
    return top * (1.0 - torch.clamp((trm + 1.0) / R, 0.0, 1.0))


def live_slots(table: torch.Tensor, *, stride: int, dtype: str, k_lo: int = 0,
               k_hi: int | None = None) -> torch.Tensor:
    """(..., F, P) bool: the (frame, slot) pairs of a slot table to which
    the render gives a nonzero signal somewhere in samples [k_lo, k_hi) of
    the frame (default: the whole frame, [0, stride)), as far as the gains
    and the envelope decide; the kernel's per-tile selection
    (csrc/tracked_render.cu live_in) in plain PyTorch. A pair is dead when
    both gains are zero, or the envelope is zero at every sample k of the
    range (tp = tp0 + k, trm = tr0 + k): before the press (tp < 0); in the
    pressed part [k0, kr) the envelope is non-increasing once the attack is
    over and positive before, so zero at its first and last sample means
    zero over it; in the release part [max(k0, kr), k_hi) it is
    non-increasing, so zero at its first sample means zero over it. The
    envelope is evaluated at those samples with the render's own functions,
    in the render's dtype, so a pair counted dead renders exactly zero over
    the range. An empty slot (tp0 = -1e9, gains 0) is dead; a note's
    release tail is live until its envelope reaches zero."""
    k_hi = stride if k_hi is None else k_hi
    tab = table.to(dtype_of(dtype))
    col = lambda i: tab[..., i]  # noqa: E731
    tp0, tr0, top = col(_F_TP0), col(_F_TR0), col(_F_TOP)
    A, H, D, sus, R = (col(i) for i in (_F_A, _F_H, _F_D, _F_SUS, _F_R))
    k0 = torch.clamp(torch.ceil(-tp0), k_lo, k_hi)   # first sample with tp >= 0
    kr = torch.clamp(torch.ceil(-tr0), k_lo, k_hi)   # first sample with trm >= 0
    pressed_on = (k0 < kr) & (
        (pressed_envelope(tp0 + k0, A, H, D, sus) != 0)
        | (pressed_envelope(tp0 + (kr - 1.0), A, H, D, sus) != 0))
    k_rel = torch.maximum(k0, kr)
    release_on = (k_rel < k_hi) & (release_envelope(tr0 + k_rel, top, R) != 0)
    gains_on = (col(_F_GL) != 0) | (col(_F_GR) != 0)
    return gains_on & (pressed_on | release_on)


def _render_slots(table: torch.Tensor, *, stride: int,
                  dtype: str) -> torch.Tensor:
    """(n_frames, P, 16 or 17) -> (n_frames, stride, 2) stereo, float32 or
    float64; a batch of jobs' tables, (B, n_frames, P, fields), renders to
    (B, n_frames, stride, 2). Dispatches on the table's device: CPU ->
    _render_slots_plain; CUDA -> one launch of the kernel
    (ops/cuda_render.render_slots_cuda, which raises on what it does not
    take) over the table cast to the render's type (a 16-field table) or
    to float64 (the fidelity chain's 17-field table)."""
    kind = table.device.type
    if kind == "cpu":
        return _render_slots_plain(table, stride=stride, dtype=dtype)
    if kind != "cuda":
        raise ValueError(f"no tracked-note renderer for device {table.device}")
    wdt = dtype_of(dtype)
    tab = table.to(wdt if table.shape[-1] == N_FIELDS else torch.float64)
    return cuda_render.render_slots_cuda(tab.contiguous(), stride=stride, dtype=wdt)


def _render_slots_plain(table: torch.Tensor, *, stride: int,
                        dtype: str) -> torch.Tensor:
    """The kernel's plain twin: (n_frames, P, 16 or 17) -> (n_frames,
    stride, 2) stereo, float32 or float64, every slot rendered. A batch of
    jobs' tables, (B, n_frames, P, fields), renders to (B, n_frames,
    stride, 2), every job in each pass. Any device.

    One (frames, P, stride) tile per chunk of frames; the chunk is sized so
    each intermediate stays near _RENDER_CHUNK_ELEMS elements per job, and
    a batch's within _RENDER_BATCH_CHUNK_ELEMS.

    A 17-field table (the fidelity chain's, analysis/device_tracker
    build_tables_device_df) carries the rest of the row increment in field
    16: the increment is field 0 + field 16. A float32 render then computes
    the per-sample phase advance, glide included, in float64 from that
    increment and the float64 phase and ratio, wraps it, and only then casts
    it to float32 for the sine; volumes, envelopes and gains stay float32
    (JAX resynth_bank.py:276-342, there in df32 pairs on a (slot, k1, k0)
    lane layout that the TPU needed). A float64 render adds field 16 to
    field 0, as JAX does (:341-342).
    """
    if table.dim() not in (3, 4) or table.shape[-1] not in (N_FIELDS, N_FIELDS_DF):
        raise ValueError(f"expected a {N_FIELDS}- or {N_FIELDS_DF}-field slot "
                         "table (frames, slots, fields), or a batch of them, "
                         f"got {tuple(table.shape)}")
    df_phase = table.shape[-1] == N_FIELDS_DF
    wdt = dtype_of(dtype)
    f64 = torch.float64
    lead = table.shape[:-3]  # (B,) for a batch
    n, P = table.shape[-3], table.shape[-2]
    S = stride
    chunk = max(1, _RENDER_CHUNK_ELEMS // max(1, P * S))
    if lead:
        chunk = max(1, min(chunk, _RENDER_BATCH_CHUNK_ELEMS // max(1, lead[0] * P * S)))
    k1 = torch.arange(1, S + 1, dtype=wdt, device=table.device)  # k + 1
    k1_64 = torch.arange(1, S + 1, dtype=f64, device=table.device)
    out = torch.empty((*lead, n, S, 2), dtype=wdt, device=table.device)
    for f0 in range(0, n, chunk):
        tab = table[..., f0:f0 + chunk, :, :].to(wdt)
        col = lambda i: tab[..., i:i + 1]  # (.., F, P, 1)
        (incf, ratio, phb, vtgt, vb, alpha, tp0, tr0, top, A, H, D, sus, R) = (
            col(i) for i in range(14))
        gains = tab[..., _F_GL:_F_GR + 1]

        lam = ratio / S
        if df_phase:
            t64 = table[..., f0:f0 + chunk, :, :].to(f64)
            c64 = lambda i: t64[..., i:i + 1]  # noqa: E731
            inc64 = c64(_F_INC) + c64(_F_INC_LO)
            phases = _phase_trajectory(inc64, c64(_F_RATIO), c64(_F_PHB),
                                       k1_64, S).to(wdt)
            if wdt == f64:
                incf = inc64
        else:
            phases = _phase_trajectory(incf, ratio, phb, k1, S)
        # power(1-alpha, k+1) as exp((k+1)*log1p(-alpha)), the log per slot
        vol = vtgt + (vb - vtgt) * torch.exp(k1 * torch.log1p(-alpha))
        tp = tp0 + (k1 - 1.0)
        trm = tr0 + (k1 - 1.0)
        env = torch.where(tp < 0, 0.0, torch.where(
            trm < 0, pressed_envelope(tp, A, H, D, sus),
            release_envelope(trm, top, R)))
        # anti-alias gain at the frame-midpoint increment (a per-slot scalar)
        mid_inc = incf * torch.exp(lam * (S * 0.5))
        aliasing = oscillators.freq_aliasing_multiplicator(mid_inc)
        sig = vol * env * aliasing * oscillators.sine(phases)
        out[..., f0:f0 + chunk, :, :] = torch.einsum("...fps,...fpc->...fsc",
                                                     sig, gains)
    return out


def render_table(table, config: TrackedRenderConfig,
                 device_out: bool = False, *, device="cuda"):
    """Render a prebuilt (total_frames, n_slots, 16) control table (from
    _build_slot_tables or the fused C++ table packer, native/pitchpipe.cpp
    pitchpipe_run_offline) -> (start_sample + total_frames*stride, C): one
    host copy (numpy), or with device_out=True the tensor on `device`."""
    dev = torch.device(device)
    table = torch.as_tensor(np.asarray(table) if not torch.is_tensor(table)
                            else table, device=dev)
    total_frames = table.shape[0]
    out = _render_slots(table, stride=config.stride, dtype=config.dtype)
    body = out.reshape(total_frames * config.stride, -1)[:, :config.n_channels]
    out = torch.nn.functional.pad(body, (0, 0, config.start_sample, 0))
    return out if device_out else out.cpu().numpy()


def render_tracked(notes: list[TrackedNote], n_frames: int,
                   config: TrackedRenderConfig, tail_frames: int = 8,
                   device_out: bool = False, *, device="cuda"):
    """Render tracked notes -> (start_sample + (n_frames+tail)*stride, C),
    numpy or, with device_out=True, the tensor on `device`."""
    total_frames = n_frames + tail_frames
    table = _build_slot_tables(notes, total_frames, config)
    return render_table(table, config, device_out, device=device)
