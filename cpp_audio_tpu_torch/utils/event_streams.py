"""Event streams of the `tune` app (reference source/main.tune.cpp).

  - RainEventStream (main.tune.cpp:193-289): random rain-drop notes. Volume is
    sampled as 1/distance of a uniform point in a disc (energy ~ 1/d^2), and
    the pitch rises with volume ("closer" drops are brighter):
    pitch = A + U(0,2) - 25 + 7*volume.
  - Loop (main.tune.cpp:298-467): repeats a finite event list with a
    per-iteration time offset and fresh note ids.
  - Binary sonification (main.tune.cpp:469-1017): streams the bytes of any
    file as melody. Two forms:
      * binary_sonification_notes — the condensed histogram-ranked scale
        mapping (byte frequency rank -> scale degree);
      * the FULL reference machinery — skip lists of over-repeated bytes
        (SkipBytes, :696-740), per-batch statistics and interestingness
        selection (statsFromBinary + streamFromBinaryPitchesEncoding,
        :744-851,2081-2135), per-voice staggered cyclic byte->pitch maps
        (MidiPitchStreamFromBinary, :889-1016), polyphonic event
        materialization (EventStreamFromBinary, :1018-1082), score
        extraction (scoreFromStream, :2008-2030), loopFromBinary (:2319)
        and moduloPitch range folding (:2439-2461).

Every stream materializes plain `core.events.Note` lists, rendered by any
synth model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.events import Note
from .midi import A_PITCH, Midi


def rain_notes(duration_seconds: float, *, sample_rate: int = 44100,
               min_period: float = 0.03, max_period: float = 0.18,
               min_note_duration: float = 0.05, max_note_duration: float = 0.1,
               seed: int = 0) -> list[Note]:
    """RainEventStream.materializeNextEvents (main.tune.cpp:214-239)."""
    rng = np.random.default_rng(seed)
    midi = Midi()
    notes: list[Note] = []
    t = 0.0
    nid = 0
    while t < duration_seconds:
        # sampleVolume: 1/dist of a uniform point in the unit disc, clamped
        # by a minimum distance where volume = 1 (main.tune.cpp:253-288)
        while True:
            x, y = rng.uniform(-1, 1), rng.uniform(-1, 1)
            sq = x * x + y * y
            if 0.05 * 0.05 <= sq <= 1.0:
                break
        volume = 0.05 / np.sqrt(sq)
        pitch = A_PITCH + rng.uniform(0.0, 2.0) - 25.0 + 7.0 * volume
        freq = float(midi.midi_pitch_to_freq(pitch))
        dur = rng.uniform(min_note_duration, max_note_duration)
        nid += 1
        notes.append(Note(nid, int(t * sample_rate),
                          int((t + dur) * sample_rate), freq, float(volume)))
        t += rng.uniform(min_period, max_period)
    return notes


def loop_notes(base: list[Note], n_iterations: int, period_samples: int,
               *, pitch_offset_per_iteration: float = 0.0) -> list[Note]:
    """Loop: repeat a note list with per-iteration offsets (main.tune.cpp:298+)."""
    midi = Midi()
    out: list[Note] = []
    nid = 0
    for it in range(n_iterations):
        shift = it * period_samples
        factor = midi.half_tone_ratio ** (pitch_offset_per_iteration * it)
        for n in base:
            nid += 1
            out.append(Note(nid, n.press + shift, n.release + shift,
                            n.frequency * factor, n.velocity, n.pan))
    return out


@dataclass
class FileStats:
    """Byte frequency + max run length (main.tune.cpp:477-540)."""

    byte_freq: np.ndarray
    max_consecutive: int

    @classmethod
    def from_bytes(cls, data: bytes) -> "FileStats":
        arr = np.frombuffer(data, dtype=np.uint8)
        freq = np.bincount(arr, minlength=256).astype(np.int64)
        max_run = 0
        if len(arr):
            change = np.nonzero(np.diff(arr) != 0)[0]
            bounds = np.concatenate([[-1], change, [len(arr) - 1]])
            max_run = int(np.max(np.diff(bounds)))
        return cls(freq, max_run)

    def histogram(self) -> np.ndarray:
        """Byte values ordered most->least frequent, zeros dropped."""
        order = np.argsort(-self.byte_freq, kind="stable")
        return order[self.byte_freq[order] > 0]


def binary_sonification_notes(data: bytes, *, sample_rate: int = 44100,
                              note_period: float = 0.09,
                              note_duration: float = 0.2,
                              root_pitch: float = 48.0,
                              scale_offsets=(0, 2, 4, 5, 7, 9, 11),
                              max_notes: int | None = 2000) -> list[Note]:
    """Sonify a byte stream: each byte becomes a note whose scale degree is
    the byte's frequency rank (common bytes = low degrees), octave rises with
    rank (MidiPitchStreamFromBinary condensed)."""
    midi = Midi()
    stats = FileStats.from_bytes(data)
    hist = stats.histogram()
    rank = np.full(256, len(hist), dtype=np.int64)
    rank[hist] = np.arange(len(hist))
    scale = np.asarray(scale_offsets, dtype=np.float64)
    notes: list[Note] = []
    arr = np.frombuffer(data, dtype=np.uint8)
    if max_notes is not None:
        arr = arr[:max_notes]
    for i, b in enumerate(arr):
        r = int(rank[b])
        degree = scale[r % len(scale)]
        octave = r // len(scale)
        pitch = root_pitch + degree + 12 * (octave % 4)
        t0 = int(i * note_period * sample_rate)
        notes.append(Note(i + 1, t0, t0 + int(note_duration * sample_rate),
                          float(midi.midi_pitch_to_freq(pitch)), 0.7))
    return notes


# ---------------------------------------------------------------------------
# Full binary sonification machinery (main.tune.cpp:469-1017,2008-2461)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ByteRange:
    """Half-open byte-index range [begin, end) (main.tune.cpp:612-623)."""

    begin: int
    end: int


class EventsTiming:
    """Note timing for pitch-stream -> event conversion
    (main.tune.cpp:567-590): wait_after_note_on = int(scale*800) ms,
    wait_after_note_off = int(scale*300) ms."""

    def __init__(self, time_scale_factor: float = 0.09):
        self.wait_after_note_on = int(time_scale_factor * 800) / 1000.0
        self.wait_after_note_off = int(time_scale_factor * 300) / 1000.0

    @property
    def note_period(self) -> float:
        return self.wait_after_note_on + self.wait_after_note_off


def compute_skip_ranges(arr: np.ndarray, max_consecutive: int) -> list[ByteRange]:
    """Byte indexes whose run-of-identical-bytes length (counted inclusive of
    the current byte) exceeds max_consecutive (main.tune.cpp:755-780:
    `stats.getCurConsecutiveBytes() > maxConsecutiveBytes` marks the byte
    skipped)."""
    n = len(arr)
    if n == 0:
        return []
    change = np.nonzero(np.diff(arr) != 0)[0]
    run_start = np.zeros(n, dtype=np.int64)
    run_start[change + 1] = change + 1
    run_start = np.maximum.accumulate(run_start)
    run_len = np.arange(n) - run_start + 1
    skip = run_len > max_consecutive
    out = []
    i = 0
    while i < n:
        if skip[i]:
            j = i
            while j < n and skip[j]:
                j += 1
            out.append(ByteRange(i, j))
            i = j
        else:
            i += 1
    return out


def stats_from_binary(data: bytes, batch_size: int = 10000,
                      max_consecutive: int = 11):
    """Partition the non-skipped bytes into batches of batch_size, keyed by
    (max byte frequency, max consecutive run) per batch
    (statsFromBinary, main.tune.cpp:744-851).

    Returns (batches_by_key, skip_ranges): batches_by_key maps
    (max_freq, max_consec) -> list of batches, each batch a list of
    contiguous ByteRanges (skips split ranges)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    skip_ranges = compute_skip_ranges(arr, max_consecutive)
    skip = np.zeros(len(arr), dtype=bool)
    for r in skip_ranges:
        skip[r.begin:r.end] = True
    kept_idx = np.nonzero(~skip)[0]

    batches_by_key: dict = {}
    for b0 in range(0, len(kept_idx), batch_size):
        idx = kept_idx[b0 : b0 + batch_size]
        if len(idx) == 0:
            continue
        # contiguous index runs -> ByteRanges
        ranges = []
        start = prev = int(idx[0])
        for i in idx[1:]:
            i = int(i)
            if i != prev + 1:
                ranges.append(ByteRange(start, prev + 1))
                start = i
            prev = i
        ranges.append(ByteRange(start, prev + 1))
        stats = FileStats.from_bytes(arr[idx].tobytes())
        hist = stats.histogram()
        max_freq = int(stats.byte_freq[hist[0]]) if len(hist) else 0
        key = (max_freq, stats.max_consecutive)
        batches_by_key.setdefault(key, []).append(ranges)
    return batches_by_key, skip_ranges


def select_interesting_ranges(batches_by_key, batch_size: int = 10000,
                              max_freq_ratio: float = 0.03) -> list[ByteRange]:
    """The streamFromBinaryPitchesEncoding batch-selection policy
    (main.tune.cpp:2090-2135): walk batch keys in DESCENDING order, skip
    "boring" batches (max byte frequency > max_freq_ratio * batch_size —
    too-repetitive content makes dull melody), keep the rest's ranges."""
    out: list[ByteRange] = []
    for key in sorted(batches_by_key, reverse=True):
        if key[0] > max_freq_ratio * batch_size:
            continue
        for ranges in batches_by_key[key]:
            out.extend(ranges)
    return out


class MidiPitchStreamFromBinary:
    """Polyphonic byte -> MidiPitch stream (main.tune.cpp:889-1016).

    Each voice owns 256 cyclic byte->byte iterators over [0, max_byte]
    (CyclicByteRangeIterator, :544-566); when uniform_cycle_initialization
    is False, byte value i's iterator starts i steps in (:963-970) so equal
    bytes diverge across values. All voices SHARE the file cursor: each call
    consumes the next byte of the selected ranges.

    pitch = min_pitch + iterator[voice][byte]() with min_pitch defaulting to
    A_pitch - 21 and max_byte = 48 (4 octaves), or derived from the given
    pitch range (:947-957,986-994)."""

    def __init__(self, data: bytes, ranges: list[ByteRange], *,
                 pitch_min: float | None = None, pitch_max: float | None = None,
                 reinit_cycle_at_range_boundary: bool = False,
                 uniform_cycle_initialization: bool = True,
                 n_voices: int = 1):
        self._arr = np.frombuffer(data, dtype=np.uint8)
        self._ranges = list(ranges)
        self._pitch_min = pitch_min
        self._pitch_max = pitch_max
        self._reinit_at_boundary = reinit_cycle_at_range_boundary
        self._uniform_init = uniform_cycle_initialization
        self.n_voices = n_voices
        if pitch_min is not None and pitch_max is not None:
            self._max_byte = min(255, int(0.5 + pitch_max - pitch_min))
        else:
            self._max_byte = 48  # 4 octaves (main.tune.cpp:949)
        self.restart()

    def restart(self) -> None:
        self._range_i = 0
        self._pos = None
        self._reinit_cycles()

    def _reinit_cycles(self) -> None:
        # per (voice, byte-value) next cycle position in [0, max_byte]
        cyc = np.zeros((self.n_voices, 256), dtype=np.int64)
        if not self._uniform_init:
            cyc[:, :] = np.arange(256) % (self._max_byte + 1)
        self._cycle = cyc

    def __call__(self, voice: int) -> float | None:
        while True:
            if self._pos is not None and self._pos < self._cur_end:
                c = int(self._arr[self._pos])
                self._pos += 1
                v = int(self._cycle[voice, c])
                self._cycle[voice, c] = (v + 1) % (self._max_byte + 1)
                min_pitch = (self._pitch_min if self._pitch_min is not None
                             else A_PITCH - 21)
                return float(min_pitch + v)
            # advance to the next non-empty range
            if self._range_i >= len(self._ranges):
                return None
            r = self._ranges[self._range_i]
            self._range_i += 1
            if r.end <= r.begin or r.begin >= len(self._arr):
                continue
            self._pos = r.begin
            self._cur_end = min(r.end, len(self._arr))
            if self._reinit_at_boundary:
                self._reinit_cycles()


def score_from_stream(stream: MidiPitchStreamFromBinary) -> list[list[float]]:
    """Drain the stream round-robin into per-voice pitch lists
    (scoreFromStream, main.tune.cpp:2016-2035)."""
    voices: list[list[float]] = [[] for _ in range(stream.n_voices)]
    while True:
        eos = 0
        for v in range(stream.n_voices):
            p = stream(v)
            if p is None:
                eos += 1
            else:
                voices[v].append(p)
        if eos == stream.n_voices:
            return voices


def notes_from_pitch_voices(voices: list[list[float]], *,
                            timing: EventsTiming | None = None,
                            sample_rate: int = 44100) -> list[Note]:
    """Per-voice pitch sequences -> Note list with the EventStreamFromBinary
    timing (main.tune.cpp:1053-1083): on at t, off at t+wait_on, next note at
    +wait_off; volume 1/n_voices."""
    timing = timing or EventsTiming()
    midi = Midi()
    n_voices = max(len(voices), 1)
    vol = 1.0 / n_voices
    on_s = timing.wait_after_note_on
    period = timing.note_period
    notes: list[Note] = []
    nid = 0
    for pitches in voices:
        t = 0.0
        for p in pitches:
            nid += 1
            notes.append(Note(nid, int(t * sample_rate),
                              int((t + on_s) * sample_rate),
                              float(midi.midi_pitch_to_freq(p)), vol))
            t += period
    return notes


def binary_sonification_notes_full(
        data: bytes, *, polyphony: int = 1, batch_size: int = 10000,
        max_consecutive: int = 11, pitch_min: float | None = None,
        pitch_max: float | None = None, time_scale_factor: float = 0.09,
        uniform_cycle_initialization: bool = True,
        sample_rate: int = 44100, max_notes: int | None = 4000) -> list[Note]:
    """The reference's full sonification path (loopFromBinary minus the
    loop): skip lists -> batch stats -> interesting-range selection ->
    polyphonic cyclic pitch mapping -> timed events."""
    batches, _skips = stats_from_binary(data, batch_size, max_consecutive)
    ranges = select_interesting_ranges(batches, batch_size)
    if not ranges:  # every batch "boring": fall back to all kept ranges
        ranges = [r for rs in batches.values() for b in rs for r in b]
    stream = MidiPitchStreamFromBinary(
        data, ranges, pitch_min=pitch_min, pitch_max=pitch_max,
        uniform_cycle_initialization=uniform_cycle_initialization,
        n_voices=polyphony)
    voices = score_from_stream(stream)
    if max_notes is not None:
        per_voice = max(1, max_notes // max(polyphony, 1))
        voices = [v[:per_voice] for v in voices]
    return notes_from_pitch_voices(
        voices, timing=EventsTiming(time_scale_factor),
        sample_rate=sample_rate)


def loop_from_binary(data: bytes, *, n_iterations: int, polyphony: int = 1,
                     sample_rate: int = 44100, max_notes: int | None = 2000,
                     **kw) -> list[Note]:
    """loopFromBinary (main.tune.cpp:2319-2325): extract the sonified score
    once, then loop it."""
    base = binary_sonification_notes_full(
        data, polyphony=polyphony, sample_rate=sample_rate,
        max_notes=max_notes, **kw)
    period = max((n.release for n in base), default=0)
    return loop_notes(base, n_iterations, period)


def modulo_pitch_notes(notes: list[Note], *, min_pitch: float = 50.0,
                       max_pitch: float = 80.0) -> list[Note]:
    """moduloPitch range folding (main.tune.cpp:2439-2461): transpose down 2
    octaves then fold by octaves into [min_pitch, max_pitch]."""
    import dataclasses

    midi = Midi()
    out = []
    for n in notes:
        p = float(A_PITCH + 12.0 * np.log2(n.frequency / 440.0)) - 24.0
        while p < min_pitch:
            p += 12.0
        while p > max_pitch:
            p -= 12.0
        out.append(dataclasses.replace(
            n, frequency=float(midi.midi_pitch_to_freq(p))))
    return out
