"""The pitch tracker and the slot table, frame by frame on the host.

A plain sequential form of the reference's RtResynth::step (cpp.audio
source/rt.resynth.lib.cpp:1670-1759, rt.resynth.lib.algo.cpp) for a
configuration without pitch shift, harmonize or autotune: per analysis
frame, peaks -> MIDI pitches and linear volumes -> greedy grouping of
nearby pitches -> one pitch and volume per group -> matching against the
playing notes (note on, change, off), note-ons loudest first by
perceived loudness at 60 phon, pans drawn per accepted note-on; then the
notes packed into polyphony slots with their per-frame control rows
(frequency glide, volume filter, phase at the frame boundary, envelope,
pan gains). float64 throughout.
"""

from __future__ import annotations

import numpy as np

from . import loudness

NEVER_FRAME = 10**9
N_FIELDS = 16
(F_INC, F_RATIO, F_PHB, F_VTGT, F_VB, F_ALPHA, F_TP0, F_TR0,
 F_TOP, F_A, F_H, F_D, F_SUS, F_R, F_GL, F_GR) = range(N_FIELDS)


def midi_pitch(freq: float) -> float:
    return 69.0 + 12.0 * np.log2(freq / 440.0)


HALF_TONE = 2.0 ** (1.0 / 12.0)


def pitch_freq(pitch: float) -> float:
    return 440.0 * HALF_TONE ** (pitch - 69.0)


# A decision whose margin is below these is a knife-edge: float32
# arithmetic (the configuration's) may take either side of it. Semitones
# for pitch comparisons; a share of the compared value for volumes and for
# the perceived-loudness order. float32 pitches of MIDI 20-110 are exact to
# ~8e-6 semitones.
PITCH_EDGE = 2e-4
VOLUME_EDGE = 1e-4
ORDER_EDGE = 1e-4


class Decisions:
    """The comparisons of a tracker run. A comparison within its edge of the
    threshold is recorded as (frame, kind, key); listed in `flips`, it
    takes the other side."""

    def __init__(self, flips=frozenset()):
        self.flips = flips
        self.edges = []
        self.tuned = []  # pitches left per frame after grouping and min_volume

    def greater(self, frame: int, kind: str, key, value: float, threshold: float,
                edge: float) -> bool:
        out = value > threshold
        if abs(value - threshold) < edge:
            ident = (frame, kind, key)
            self.edges.append(ident)
            out ^= ident in self.flips
        return out


def _groups(pitches, volumes, nearby: float, frame: int, dec: Decisions):
    """Greedy monotonic grouping: a group closes when adding the next pitch
    would make its span exceed `nearby`."""
    out, cur = [], None
    for j, (p, v) in enumerate(zip(pitches, volumes)):
        if cur is not None and dec.greater(frame, "group", j, max(cur[1], p) - min(cur[0], p),
                                           nearby, PITCH_EDGE):
            out.append(cur)
            cur = None
        if cur is None:
            cur = [p, p, 0.0, 0.0]  # min, max, sum of p * v, sum of v
        cur[0], cur[1] = min(cur[0], p), max(cur[1], p)
        cur[2] += p * v
        cur[3] += v
    if cur is not None:
        out.append(cur)
    return out


class Note:
    def __init__(self, frame, freq, vol, pan):
        self.frames = [(frame, freq, vol)]
        self.release_frame = NEVER_FRAME
        self.pan = pan


def track(peak_lists, cfg: dict, dec: Decisions | None = None):
    """peak_lists: per frame a list of (freq_hz, level_db), frequency
    ordered. Returns (notes, dropped note-ons)."""
    dec = dec or Decisions()
    li = loudness.phons_to_index(60.0)
    pan_rng = np.random.default_rng(cfg["pan_seed"])
    played = []  # [midi pitch, note]
    notes, dropped = [], 0
    min_vol = cfg["min_volume"]
    for frame, freqmags in enumerate(peak_lists):
        pv = [(midi_pitch(f), 10.0 ** (m / 20.0)) for f, m in freqmags if f > 0]
        tuned = []
        for g, (lo, hi, spv, sv) in enumerate(_groups(
                [p for p, _ in pv], [v for _, v in pv], cfg["nearby_distance_tones"],
                frame, dec)):
            if not dec.greater(frame, "volume", g, min_vol, sv, VOLUME_EDGE * min_vol):
                tuned.append((spv / sv, sv))
        dec.tuned.append(len(tuned))
        # two-pointer matching of the new pitches to the playing notes
        change = [None] * len(tuned)
        keep = [False] * len(played)
        it, reach = 0, cfg["max_track_pitches"]
        for i, (p, _v) in enumerate(tuned):
            while it < len(played):
                if dec.greater(frame, "below", (i, it), p - reach, played[it][0], PITCH_EDGE):
                    it += 1
                    continue
                if not dec.greater(frame, "above", (i, it), played[it][0], p + reach,
                                   PITCH_EDGE):
                    change[i] = it
                    keep[it] = True
                    it += 1
                break
        weight = [v / float(loudness.contour_db(p, li)) for p, v in tuned]
        order = sorted(range(len(tuned)), key=lambda i: -weight[i])
        for a in range(len(order) - 1):
            i, j = order[a], order[a + 1]
            if weight[i] - weight[j] < ORDER_EDGE * abs(weight[i]):
                ident = (frame, "order", (min(i, j), max(i, j)))
                dec.edges.append(ident)
                if ident in dec.flips:
                    order[a], order[a + 1] = j, i
        for j, k in enumerate(keep):
            if not k:
                played[j][1].release_frame = frame
        active = sum(keep)
        new = []
        for i in order:
            p, v = tuned[i]
            freq, vol = pitch_freq(p), cfg["analysis_volume"] * v
            if change[i] is not None:
                entry = played[change[i]]
                entry[1].frames.append((frame, freq, vol))
                entry[0] = p
                continue
            if vol <= 0:
                continue
            if active >= cfg["max_voices"]:
                dropped += 1
                continue
            active += 1
            note = Note(frame, freq, vol, cfg["stereo_spread"] * pan_rng.uniform(-1.0, 1.0))
            notes.append(note)
            new.append([p, note])
        played = [e for j, e in enumerate(played) if keep[j]] + new
        played.sort(key=lambda e: e[0])
    return notes, dropped


def slot_table(notes, n_frames: int, cfg: dict) -> np.ndarray:
    """Pack notes into polyphony slots: (n_frames, n_slots, 16) float64."""
    P, S, sr = cfg["n_slots"], cfg["stride"], cfg["sample_rate"]
    table = np.zeros((n_frames, P, N_FIELDS))
    table[:, :, F_INC] = 1e-6
    table[:, :, F_A] = 1.0
    table[:, :, F_SUS] = 1.0
    table[:, :, F_R] = 1.0
    table[:, :, F_TP0] = -1e9
    min_dt = sr / 1000.0
    sus = 1.0  # sustain 1: no decay stage
    far = 1e12
    free_at = np.zeros(P, dtype=np.int64)
    phase_rng = np.random.default_rng(cfg["phase_seed"])
    wins = []
    for note in notes:
        f0 = note.frames[0][0]
        min_change = np.floor(0.5 + 2.5 * 2.0 / max(abs(2.0 * note.frames[0][1] / sr), 1e-9))
        A = max(cfg["attack"], min_dt, min_change, 1.0)
        H = max(cfg["hold"], 0.0)
        R = max(cfg["release"], min_dt, min_change, 1.0)
        rel_f = min(note.release_frame, n_frames)
        wins.append((f0, min(n_frames, rel_f + int(np.ceil(R / S)) + 1), A, H, R))
    for ni in np.argsort([w[0] for w in wins], kind="stable"):
        note = notes[ni]
        f0, f1, A, H, R = wins[ni]
        if f0 >= n_frames or f1 <= f0:
            continue
        free = np.nonzero(free_at <= f0)[0]
        if len(free) == 0:
            continue
        slot = int(free[0])
        free_at[slot] = f1
        press = f0 * S
        release = note.release_frame * S if note.release_frame < NEVER_FRAME else far
        if release < far:
            tp = release - 1.0 - press
            top = min(max((tp + 1.0) / A, 0.0), 1.0) if tp < A else 1.0
        else:
            top = sus
        th = 0.25 * np.pi * (note.pan + 1.0)
        phase = phase_rng.uniform(0.0, 2.0)
        i = 0
        cur_f, cur_v = note.frames[0][1], note.frames[0][2]
        prev_inc = 2.0 * cur_f / sr
        vol_b = cur_v
        for c in range(f0, f1):
            if i + 1 < len(note.frames) and note.frames[i + 1][0] <= c:
                i += 1
                cur_f, cur_v = note.frames[i][1], note.frames[i][2]
            inc_to = 2.0 * cur_f / sr
            inc_from = prev_inc if c > f0 else inc_to
            ratio = np.log(inc_to / inc_from) if inc_to != inc_from else 0.0
            alpha = 1.0 - np.exp(-np.pi * min(2.0 / S, abs(inc_to)))
            table[c, slot] = (inc_from, ratio, phase, cur_v, vol_b, alpha, c * S - press,
                              max(c * S - release, -far), top, A, H, 0.0, sus, R,
                              np.cos(th), np.sin(th))
            dphi = (inc_from / (ratio / S)) * np.expm1(ratio) if ratio else S * inc_from
            phase = (phase + dphi) % 2.0
            vol_b = cur_v + (vol_b - cur_v) * (1.0 - alpha) ** S
            prev_inc = inc_to
    return table
