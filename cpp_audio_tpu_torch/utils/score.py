"""Score language: "do re mi fa sol la si" with accidentals and durations.

reference source/parse.music.cpp:1-167 + include/note.h:
  - note names (case-insensitive solfege), uppercase first letter = loud
  - suffix d/D/#/s = sharp, b/B/f = flat
  - '.' = extend the previous note by one unit, or a rest when no note is
    pending; '-' = extend (tie)
  - durations are counted in time units; NoteSpec{note|None, loud, duration}

`notespecs_to_notes` converts a parsed score into absolute-time Notes for the
voice-bank renderer (the reference converts to channel Requests via
`to_request`, note.h:10-40: sine at the well-tempered frequency, volume x2
when loud).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.events import Note as EvNote
from .midi import Midi, Note

_NOTE_NAMES = [("sol", Note.Sol), ("do", Note.Do), ("re", Note.Re),
               ("mi", Note.Mi), ("fa", Note.Fa), ("la", Note.La),
               ("si", Note.Si)]


@dataclass
class NoteSpec:
    note: Note | None  # None = silence
    loud: bool
    duration: int  # in time units


def _parse_note(token: str) -> Note | None:
    low = token.lower().replace("é", "e")
    for name, n in _NOTE_NAMES:
        if low.startswith(name):
            rest = low[len(name):]
            if not rest:
                return n
            if len(rest) > 1:
                return None
            if rest in ("d", "#", "s"):
                return Note((int(n) + 1) % 12)
            if rest in ("b", "f"):
                return Note((int(n) - 1) % 12)
            return None
    return None


def parse_music(score: str) -> list[NoteSpec]:
    """Parse a score string into NoteSpecs (reference parseMusic)."""
    specs: list[NoteSpec] = []
    cur_note: Note | None = None
    cur_loud = False
    cur_dur = 0

    def flush():
        nonlocal cur_note, cur_loud, cur_dur
        if cur_dur:
            specs.append(NoteSpec(cur_note, cur_loud, cur_dur))
        cur_note, cur_loud, cur_dur = None, False, 0

    pos = 0
    n = len(score)
    while pos < n:
        c = score[pos]
        if c == " ":
            pos += 1
        elif c == ".":
            if cur_note is not None:
                flush()
            cur_dur += 1
            pos += 1
        elif c == "-":
            cur_dur += 1
            pos += 1
        else:
            nxt = pos
            while nxt < n and score[nxt] not in " .-":
                nxt += 1
            flush()
            token = score[pos:nxt]
            pos = nxt
            note = _parse_note(token)
            if note is None:
                raise ValueError(f"unrecognized note: {token!r}")
            cur_note = note
            cur_loud = token[0].isupper()
            cur_dur = 1
    flush()
    return specs


def notespecs_to_notes(specs: list[NoteSpec], *, sample_rate: int = 44100,
                       time_unit_ms: float = 180.0, octave: int = 4,
                       velocity: float = 0.5, midi: Midi | None = None,
                       start_sample: int = 0) -> list[EvNote]:
    """Resolve a parsed score into absolute-time Notes.

    Frequency = well-tempered pitch of the note in `octave` (the reference
    plays the interval from La at the ref octave, note.h:28-32); loud notes
    get 2x velocity (note.h:33).
    """
    midi = midi or Midi()
    unit = int(0.5 + time_unit_ms * sample_rate / 1000.0)
    notes: list[EvNote] = []
    t = start_sample
    nid = 1
    for s in specs:
        dur = s.duration * unit
        if s.note is not None:
            interval = int(s.note) - int(Note.La) + 12 * (octave - 4)
            freq = float(midi.Ainterval_to_freq(interval))
            vel = velocity * (2.0 if s.loud else 1.0)
            notes.append(EvNote(nid, t, t + dur, freq, vel))
            nid += 1
        t += dur
    return notes


def ms_to_frames(duration_ms: float, sample_rate: int) -> int:
    """Reference ms_to_frames (sound.functions.h:27-33): float32 arithmetic,
    round-half-up."""
    import numpy as np

    fval = np.float32(sample_rate) / np.float32(1000.0) * np.float32(duration_ms)
    return int(np.float32(0.5) + fval)


def sine_sound_buffer(period: int):
    """One period of the reference's cached SINE soundBuffer
    (source/sound.cpp:218-221 generate(period, sinf) with the mapping
    sound.cpp:97-105: sample i in [0, period) -> sinf(2pi*(i+1)/period) —
    first sample non-zero, LAST sample zero, which is what the channel seam
    sync law (channel.h:721-731) relies on). Float32 like the reference."""
    import numpy as np

    inc = np.float32(2.0 * np.pi) / np.float32(period)
    return np.sin(inc * np.arange(1, period + 1, dtype=np.float32))


def notespecs_to_requests(specs: list[NoteSpec], *, sample_rate: int = 44100,
                          time_unit_ms: float = 180.0, octave: int = 4,
                          volume: float = 0.5, n_outs: int = 2,
                          midi: Midi | None = None):
    """Resolve a parsed score into channel `Request`s (reference `to_request`,
    note.h:10-40): a looping one-period sine table at the note's
    well-tempered frequency (loud = 2x volume, note.h:33), or a silence
    request for rests, each lasting `time_unit * duration` ms.

    Reference laws (request.h:271-310, sound.h:52-67):
      - period = int(sample_rate / freq) — truncation
        (freq_to_period_in_samples, sound.functions.h:45-50);
      - notes below 10 Hz, with zero volumes, or with period <
        minimalPeriod()==3 are SILENCED, keeping the rhythm
        (request.h:281-299, sound.h:28-48);
      - duration converts through float32 ms_to_frames once, from the total
        milliseconds (not per-unit rounding);
      - sine durations round UP to the next period multiple so notes end on
        zero crossings (zeroOnPeriodBoundaries, request.h:308-325).
    """
    import numpy as np

    from ..core.channels import Request, silence

    midi = midi or Midi()
    reqs = []
    for s in specs:
        # f32 like the reference: time_unit * (float)s.duration (note.h:24,35)
        dur_ms = float(np.float32(time_unit_ms) * np.float32(s.duration))
        dur = max(1, ms_to_frames(dur_ms, sample_rate))
        if s.note is None:
            reqs.append(silence(dur))
            continue
        interval = int(s.note) - int(Note.La) + 12 * (octave - 4)
        freq = float(np.float32(midi.Ainterval_to_freq(interval)))
        period = (int(np.float32(sample_rate) / np.float32(freq))
                  if freq > 0 else 1)
        if freq < 10.0 or period < 3:   # silenced, inaudible (request.h:285-299)
            reqs.append(silence(dur))
            continue
        vol = volume * (2.0 if s.loud else 1.0)
        dur = period if dur == 0 else dur + (-dur % period)
        reqs.append(Request.make(sine_sound_buffer(period), vol, dur,
                                 n_outs=n_outs))
    return reqs
