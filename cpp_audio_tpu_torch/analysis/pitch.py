"""Pitch pipeline: aggregate -> reduce -> shift -> harmonize -> autotune ->
track -> loudness-order (reference source/rt.resynth.lib.algo.cpp).

Host-side list processing (tens of peaks per frame), exactly like the
reference runs it on its analysis thread — the FFT/peak heavy lifting happens
batched on the device (ops/stft.py); these stages are control logic.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..utils import loudness
from ..utils.midi import Midi

PITCH_EPSILON = 0.0001  # rt.resynth.lib.algo.cpp:3


@dataclass
class PitchVolume:
    midipitch: float
    volume: float


class PitchReductionMethod(enum.Enum):
    INTERVAL_CENTER = "interval_center"
    MAX_VOLUME = "max_volume"
    PONDERATE_BY_VOLUME = "ponderate_by_volume"


class VolumeReductionMethod(enum.Enum):
    MAX_VOLUME = "max_volume"
    SUM_VOLUMES = "sum_volumes"


def frequencies_to_pitches(midi: Midi, freqmags) -> list[PitchVolume]:
    """[(freq, mag_db)] (ordered by freq) -> PitchVolumes (algo.cpp:10-29)."""
    res = []
    for freq, mag_db in freqmags:
        if freq > 0:
            res.append(PitchVolume(float(midi.frequency_to_midi_pitch(freq)),
                                   10.0 ** (mag_db / 20.0)))
    return res


class PitchInterval:
    """Running aggregate of nearby pitches (algo.cpp:42-104)."""

    def __init__(self, pv: PitchVolume):
        self.min_pitch = pv.midipitch
        self.max_pitch = pv.midipitch
        self.max_volume_pitch = pv.midipitch
        self.max_volume = 0.0
        self.sum_products = 0.0
        self.sum_volumes = 0.0
        self._aggregate(pv)

    def extend(self, pv: PitchVolume):
        self.min_pitch = min(self.min_pitch, pv.midipitch)
        self.max_pitch = max(self.max_pitch, pv.midipitch)
        self._aggregate(pv)

    def _aggregate(self, pv: PitchVolume):
        self.sum_volumes += pv.volume
        self.sum_products += pv.midipitch * pv.volume
        if self.max_volume < pv.volume:
            self.max_volume = pv.volume
            self.max_volume_pitch = pv.midipitch

    def get_pitch(self, m: PitchReductionMethod) -> float:
        if m is PitchReductionMethod.INTERVAL_CENTER:
            return 0.5 * (self.min_pitch + self.max_pitch)
        if m is PitchReductionMethod.MAX_VOLUME:
            return self.max_volume_pitch
        return self.sum_products / self.sum_volumes

    def get_volume(self, m: VolumeReductionMethod) -> float:
        return self.max_volume if m is VolumeReductionMethod.MAX_VOLUME else self.sum_volumes


def aggregate_pitches(nearby_distance_tones: float,
                      pitch_volumes: list[PitchVolume]) -> list[PitchInterval]:
    """Greedy monotonic grouping of nearby pitches (algo.cpp:124-161)."""
    intervals: list[PitchInterval] = []
    cur: PitchInterval | None = None
    for pv in pitch_volumes:
        if cur is not None:
            diameter = max(cur.max_pitch, pv.midipitch) - min(cur.min_pitch, pv.midipitch)
            if diameter > nearby_distance_tones:
                intervals.append(cur)
                cur = None
        if cur is None:
            cur = PitchInterval(pv)
        else:
            cur.extend(pv)
    if cur is not None:
        intervals.append(cur)
    return intervals


def reduce_pitches(pitch_method: PitchReductionMethod,
                   volume_method: VolumeReductionMethod,
                   min_volume: float,
                   intervals: list[PitchInterval]) -> list[PitchVolume]:
    """algo.cpp:166-184."""
    out = []
    for i in intervals:
        vol = i.get_volume(volume_method)
        if vol < min_volume:
            continue
        out.append(PitchVolume(i.get_pitch(pitch_method), vol))
    return out


def shift_pitches(shift_amount: float, pitches: list[PitchVolume]) -> None:
    """In-place (algo.cpp:307-316)."""
    if not shift_amount:
        return
    for p in pitches:
        p.midipitch += shift_amount


def _lower_bound_closest_idx(pitch: float, items: list, key) -> int:
    """find_closest_pitch (algo.cpp:189-218): lower_bound probe sequence +
    neighbor comparison. The probe positions (mid = lo + (hi-lo)//2, branch
    on key(items[mid]) < pitch) are exactly std::lower_bound's, which matters
    because harmonize_pitches calls this on a vector whose sorted invariant
    is broken by its own mid-loop appends (algo.cpp:338-348) — on such input
    the binary search can MISS the true closest element, and the reference's
    output reflects that (pinned by tests/test_reference_oracle.py)."""
    lo, hi = 0, len(items)
    while lo < hi:
        mid = (lo + hi) // 2
        if key(items[mid]) < pitch:
            lo = mid + 1
        else:
            hi = mid
    if lo == len(items):
        return lo - 1
    if lo == 0:
        return 0
    return (lo if abs(pitch - key(items[lo])) < abs(pitch - key(items[lo - 1]))
            else lo - 1)


def harmonize_pitches(harmonize_amount: float, pitches: list[PitchVolume],
                      semantics: str = "reference") -> list[PitchVolume]:
    """Add a transposed copy of each pitch, merging a copy that lands within
    PITCH_EPSILON of an existing pitch. Returns a new sorted list.

    semantics="reference" replicates the reference probe-for-probe
    (algo.cpp:318-371): its find_closest_pitch lower_bounds over the GROWING
    vector whose sorted precondition its own appends break, so the search
    can miss a true-closest original once any copy was appended — duplicate
    eps-equal pitches then survive (the reference's own post-merge debug
    Assert of strict ordering, algo.cpp:361-370, fires on exactly these,
    showing the author never intended them; NDEBUG builds play the
    duplicates ~3 dB hot). Reachable with everyday configs: autotune snaps
    pitches to a grid, so an integer harmonize makes exact collisions.

    semantics="merged" is the intent semantics (and exactly what the device
    tracker kernel computes, device_tracker._harmonize_lanes): each copy
    merges into the true closest ORIGINAL within PITCH_EPSILON — all
    merges read the pre-harmonize volumes."""
    if not harmonize_amount:
        return pitches
    sz = len(pitches)
    if semantics == "merged":
        orig = [(pv.midipitch, pv.volume) for pv in pitches]
        for mp, v in orig:
            hp = mp + harmonize_amount
            j = min(range(sz),
                    key=lambda q: (abs(orig[q][0] - hp), q))
            if abs(orig[j][0] - hp) <= PITCH_EPSILON:
                pitches[j].volume += v
            else:
                pitches.append(PitchVolume(hp, v))
        pitches.sort(key=lambda q: q.midipitch)
        return pitches
    for i in range(sz):
        p = pitches[i]
        hp = p.midipitch + harmonize_amount
        closest = pitches[_lower_bound_closest_idx(
            hp, pitches, lambda q: q.midipitch)]
        if abs(closest.midipitch - hp) <= PITCH_EPSILON:
            closest.volume += p.volume
        else:
            pitches.append(PitchVolume(hp, p.volume))
    # merge_sort_step of the two sorted runs == stable sort (algo.cpp:350-360)
    pitches.sort(key=lambda q: q.midipitch)
    return pitches


def autotune_pitches(max_pitch: float, pitch_tolerance: float, pitch_transform,
                     input_pitches: list[PitchVolume]) -> list[PitchVolume]:
    """Snap to allowed pitches, merge coincident, drop out-of-tolerance
    (algo.cpp:191-229)."""
    out: list[PitchVolume] = []
    for pv in input_pitches:
        if pv.midipitch <= max_pitch:
            tp = pitch_transform(pv.midipitch)
            if tp is not None and tp > max_pitch:
                tp = pv.midipitch  # keep output sorted (algo.cpp:213-215)
        else:
            tp = pv.midipitch
        if tp is None:
            continue
        if abs(tp - pv.midipitch) <= pitch_tolerance:
            if out and abs(out[-1].midipitch - tp) < PITCH_EPSILON:
                out[-1].volume += pv.volume
            else:
                out.append(PitchVolume(tp, pv.volume))
    return out


@dataclass
class PlayedNote:
    """algo.cpp:233-250."""

    note_on_frame_id: int
    noteid: int
    midi_pitch: float
    cur_freq: float
    cur_velocity: float


def track_pitches(max_track_pitches: float,
                  new_pitches: list[PitchVolume],
                  played_pitches: list[PlayedNote]) -> tuple[list, list]:
    """Monotonic two-pointer matching (algo.cpp:256-305).

    Returns (pitch_changes, continue_playing): pitch_changes[i] is the index
    into played_pitches matched to new_pitches[i] (or None -> note on);
    continue_playing[j] False -> note off for played_pitches[j].
    """
    pitch_changes: list[int | None] = [None] * len(new_pitches)
    continue_playing = [False] * len(played_pitches)
    it = 0
    end = len(played_pitches)
    for idx, new_pv in enumerate(new_pitches):
        while it != end:
            if played_pitches[it].midi_pitch < new_pv.midipitch - max_track_pitches:
                it += 1
                continue
            if played_pitches[it].midi_pitch <= new_pv.midipitch + max_track_pitches:
                pitch_changes[idx] = it
                continue_playing[it] = True
                it += 1
            break
    return pitch_changes, continue_playing


def order_pitches_by_perceived_loudness(new_pitches: list[PitchVolume],
                                        loudness_level: float = 60.0) -> list[int]:
    """Indexes sorted by descending perceived loudness (algo.cpp:375-411;
    weighting from rt.resynth.lib.cpp:1713-1719: volume / contour-SPL-dB at
    60 phon)."""
    li = loudness.phons_to_index(loudness_level)
    weights = []
    for pv in new_pitches:
        spl_db = float(loudness.equal_loudness_volume_db(pv.midipitch, loudness.PITCHES, li))
        weights.append(pv.volume / spl_db)
    return sorted(range(len(new_pitches)), key=lambda i: -weights[i])


def remove_dead_notes(continue_playing: list[bool],
                      played_pitches: list[PlayedNote]) -> list[PlayedNote]:
    """algo.cpp:415-432."""
    return [n for j, n in enumerate(played_pitches)
            if j >= len(continue_playing) or continue_playing[j]]


def sort_by_current_pitch(played_pitches: list[PlayedNote]) -> None:
    played_pitches.sort(key=lambda n: n.midi_pitch)
