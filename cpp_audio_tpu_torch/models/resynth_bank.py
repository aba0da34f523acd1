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

Port of cpp_audio_tpu/models/resynth_bank.py, float32 (16-field table)
branch; the 17-field df-phase branch comes with the float64 fidelity chain.
The host table packer is copied. The render drops the JAX package's
lax.cond split ladder and bounds memory by rendering a chunk of frames at a
time instead (eager PyTorch materialises every intermediate that XLA fused).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import dtype_of
from ..ops import envelopes, oscillators
from ..utils.interp import Itp

# elements per (frames, slots, stride) intermediate in one render chunk:
# 2^24 f32 = 64 MB, a dozen intermediates live at once
_RENDER_CHUNK_ELEMS = 1 << 24

NEVER_FRAME = 10**9
# packed per-(frame, slot) field order
(_F_INC, _F_RATIO, _F_PHB, _F_VTGT, _F_VB, _F_ALPHA, _F_TP0, _F_TR0,
 _F_TOP, _F_A, _F_H, _F_D, _F_SUS, _F_R, _F_GL, _F_GR) = range(16)
N_FIELDS = 16


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


def _render_slots(table: torch.Tensor, *, stride: int,
                  dtype: str) -> torch.Tensor:
    """(n_frames, P, 16) -> (n_frames, stride, 2) stereo, float32 or float64.

    One (frames, P, stride) tile per chunk of frames; the chunk is sized so
    each intermediate stays near _RENDER_CHUNK_ELEMS elements.
    """
    if table.shape[2] != N_FIELDS:
        raise ValueError(f"expected a {N_FIELDS}-field slot table, got "
                         f"{table.shape[2]} fields (the df-phase table is "
                         "not ported yet)")
    wdt = dtype_of(dtype)
    n, P = table.shape[0], table.shape[1]
    S = stride
    chunk = max(1, _RENDER_CHUNK_ELEMS // max(1, P * S))
    k1 = torch.arange(1, S + 1, dtype=wdt, device=table.device)  # k + 1
    out = torch.empty((n, S, 2), dtype=wdt, device=table.device)
    for f0 in range(0, n, chunk):
        tab = table[f0:f0 + chunk].to(wdt)
        col = lambda i: tab[:, :, i:i + 1]  # (F, P, 1)
        (incf, ratio, phb, vtgt, vb, alpha, tp0, tr0, top, A, H, D, sus, R) = (
            col(i) for i in range(14))
        gains = tab[:, :, _F_GL:_F_GR + 1]

        lam = ratio / S
        small = torch.abs(ratio) < 1e-7
        adv = torch.where(
            small, incf * k1,
            (incf / torch.where(small, 1.0, lam)) * torch.expm1(lam * k1))
        phases = oscillators.wrap_phase(phb + adv)
        # power(1-alpha, k+1) as exp((k+1)*log1p(-alpha)), the log per slot
        vol = vtgt + (vb - vtgt) * torch.exp(k1 * torch.log1p(-alpha))
        tp = tp0 + (k1 - 1.0)
        trm = tr0 + (k1 - 1.0)
        va = torch.clamp((tp + 1.0) / A, 0.0, 1.0)
        vd = 1.0 + (sus - 1.0) * torch.clamp(
            (tp - A - H + 1.0) / torch.clamp(D, min=1.0), 0.0, 1.0)
        pressed = torch.where(tp < A, va, torch.where(
            tp < A + H, 1.0, torch.where(tp < A + H + D, vd, sus)))
        rel = top * (1.0 - torch.clamp((trm + 1.0) / R, 0.0, 1.0))
        env = torch.where(tp < 0, 0.0, torch.where(trm < 0, pressed, rel))
        # anti-alias gain at the frame-midpoint increment (a per-slot scalar)
        mid_inc = incf * torch.exp(lam * (S * 0.5))
        aliasing = oscillators.freq_aliasing_multiplicator(mid_inc)
        sig = vol * env * aliasing * oscillators.sine(phases)
        out[f0:f0 + chunk] = torch.einsum("fps,fpc->fsc", sig, gains)
    return out


def render_table(table, config: TrackedRenderConfig, *,
                 device="cuda") -> torch.Tensor:
    """Render a prebuilt (total_frames, n_slots, 16) control table (from
    _build_slot_tables or the fused C++ table packer, native/pitchpipe.cpp
    pitchpipe_run_offline) -> (start_sample + total_frames*stride, C)."""
    dev = torch.device(device)
    table = torch.as_tensor(np.asarray(table) if not torch.is_tensor(table)
                            else table, device=dev)
    total_frames = table.shape[0]
    out = _render_slots(table, stride=config.stride, dtype=config.dtype)
    body = out.reshape(total_frames * config.stride, -1)[:, :config.n_channels]
    return torch.nn.functional.pad(body, (0, 0, config.start_sample, 0))


def render_tracked(notes: list[TrackedNote], n_frames: int,
                   config: TrackedRenderConfig, tail_frames: int = 8, *,
                   device="cuda") -> torch.Tensor:
    """Render tracked notes -> (start_sample + (n_frames+tail)*stride, C)."""
    total_frames = n_frames + tail_frames
    table = _build_slot_tables(notes, total_frames, config)
    return render_table(table, config, device=device)
