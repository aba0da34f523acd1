"""Pitch sequence generators (reference include/pitch_generators.h).

MultiOctave: repeats a pitch sequence over N octaves, ascending then
descending (pitch_generators.h:26-116). ShufflePattern: plays a window of
upcoming pitches through an index pattern, rotating after each pass
(:118-150). PitchDrifter: slow constant drift (:152-170).
"""

from __future__ import annotations

from ..utils.midi import NUM_HALFTONES_PER_OCTAVE


class MultiOctave:
    def __init__(self, pitch_seq, count_octaves: int):
        self.seq = list(pitch_seq)
        self.end_octave = count_octaves
        self.i = 0            # next index when ascending / prev when descending
        self.octave = 0
        self.asc = True

    def __call__(self) -> float:
        if self.end_octave <= 0:
            return self.seq[0] + self.octave * NUM_HALFTONES_PER_OCTAVE
        while True:
            if self.asc:
                if self.i < len(self.seq):
                    v = self.seq[self.i] + self.octave * NUM_HALFTONES_PER_OCTAVE
                    self.i += 1
                    return v
                if self.octave < self.end_octave:
                    self.octave += 1
                    if self.octave < self.end_octave:
                        self.i = 1
                        return self.seq[0] + self.octave * NUM_HALFTONES_PER_OCTAVE
                    # at the top octave: play the base pitch once
                    return self.seq[0] + self.octave * NUM_HALFTONES_PER_OCTAVE
                self.asc = False
                self.octave = self.end_octave - 1
                self.i = len(self.seq)
            else:
                if self.i > 0:
                    self.i -= 1
                    return self.seq[self.i] + self.octave * NUM_HALFTONES_PER_OCTAVE
                if self.octave > 0:
                    self.octave -= 1
                    self.i = len(self.seq) - 1
                    return self.seq[self.i] + self.octave * NUM_HALFTONES_PER_OCTAVE
                # re-ascend: the base pitch was just played, so the new
                # ascent starts at seq[1] and continues from seq[2]
                # (pitch_generators.h:92-97: ++m_nextPitch then
                # *(m_nextPitch++); out-of-bounds for 1-element sequences
                # in the reference — here seq[0] repeats instead)
                self.asc = True
                if len(self.seq) == 1:
                    self.i = 1
                    return self.seq[0]
                self.i = 2
                return self.seq[1]


class ShufflePattern:
    def __init__(self, gen, pattern: list[int]):
        self.gen = gen
        self.pattern = list(pattern)
        n = max(self.pattern) + 1
        self.values = [gen() for _ in range(n)]
        self.idx = len(self.pattern)

    def __call__(self) -> float:
        if self.idx >= len(self.pattern):
            self.idx = 0
            self.values = self.values[1:] + [self.gen()]
        v = self.values[self.pattern[self.idx]]
        self.idx += 1
        return v


class PitchDrifter:
    def __init__(self, constant_drift: float):
        self.constant_drift = constant_drift
        self.drift = 0.0

    def __call__(self, pitch: float) -> float:
        self.drift += self.constant_drift
        return pitch + self.drift


class Smoothed:
    """Step-limited parameter smoothing (reference include/smoothparam.h)."""

    def __init__(self, max_step: float, initial=None):
        self.max_step = max_step
        self.cur = initial
        self.target = initial

    def set_target(self, t: float) -> None:
        self.target = t
        if self.cur is None:
            self.cur = t

    def step(self) -> float:
        assert self.cur is not None, "no value set"
        d = self.target - self.cur
        if abs(d) <= self.max_step:
            self.cur = self.target
        else:
            self.cur += self.max_step if d > 0 else -self.max_step
        return self.cur
