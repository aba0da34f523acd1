"""Event model: NoteOn / NoteOff / NoteChange with NoteIds.

Mirrors the reference's event vocabulary (include/events.h:39-107 — `Event`
union, `NoteId`, mkNoteOn/mkNoteOff/mkNoteChange) but as plain host-side data:
events carry an absolute sample time instead of flowing through RT queues.
The sample-accurate block splitting of events.impl.h becomes exact sample
indices in the schedule consumed by the batched render kernels.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field


class EventType(enum.Enum):
    NOTE_ON = "note_on"
    NOTE_OFF = "note_off"
    NOTE_CHANGE = "note_change"


_noteid_counter = itertools.count(1)


def next_note_id() -> int:
    """Monotonic NoteId source (reference NoteIdsGenerator, rt.resynth.lib.midi.cpp)."""
    return next(_noteid_counter)


@dataclass(frozen=True)
class Event:
    """A timed synth event.

    time: absolute sample index at which the event applies.
    frequency: Hz (NOTE_ON / NOTE_CHANGE).
    velocity: 0..1 volume scale (NOTE_ON / NOTE_CHANGE, reference `velocity`).
    changed_frequency: NOTE_CHANGE retune flag (reference events.h NoteChange).
    """

    type: EventType
    time: int
    note_id: int
    frequency: float = 0.0
    velocity: float = 1.0
    pan: float = 0.0


def mk_note_on(time: int, frequency: float, velocity: float, *, note_id: int | None = None,
               pan: float = 0.0) -> Event:
    return Event(EventType.NOTE_ON, time, note_id if note_id is not None else next_note_id(),
                 frequency, velocity, pan)


def mk_note_off(time: int, note_id: int) -> Event:
    return Event(EventType.NOTE_OFF, time, note_id)


def mk_note_change(time: int, note_id: int, frequency: float, velocity: float) -> Event:
    return Event(EventType.NOTE_CHANGE, time, note_id, frequency, velocity)


@dataclass
class Note:
    """A fully-resolved note: press/release plus control-point trail.

    `changes` holds (time, frequency, velocity) triples from NOTE_CHANGE
    events (pitch tracking / vibrato), always starting with the NOTE_ON
    values at the press time.
    """

    note_id: int
    press: int
    release: int  # sample of key release; NEVER-like large value if none
    frequency: float
    velocity: float
    pan: float = 0.0
    changes: list = field(default_factory=list)
    # start angle in rad/pi, or None for the schedule's default phase
    # policy (setPhase, gen.crtp.h:127-156)
    phase: float | None = None


def events_to_notes(events, *, never: int = 2**62) -> list[Note]:
    """Pair NoteOn/NoteOff/NoteChange events into Note records by NoteId."""
    open_notes: dict[int, Note] = {}
    done: list[Note] = []
    for ev in sorted(events, key=lambda e: (e.time, e.type is not EventType.NOTE_OFF)):
        if ev.type is EventType.NOTE_ON:
            n = Note(ev.note_id, ev.time, never, ev.frequency, ev.velocity, ev.pan,
                     changes=[(ev.time, ev.frequency, ev.velocity)])
            open_notes[ev.note_id] = n
        elif ev.type is EventType.NOTE_OFF:
            n = open_notes.pop(ev.note_id, None)
            if n is not None:
                n.release = ev.time
                done.append(n)
            # dropped NoteOff (no matching NoteOn) is ignored, like the
            # reference's DROPPED_NOTE path (gen.crtp.h:625-628)
        else:  # NOTE_CHANGE
            n = open_notes.get(ev.note_id)
            if n is not None:
                n.changes.append((ev.time, ev.frequency, ev.velocity))
    done.extend(open_notes.values())
    done.sort(key=lambda n: n.press)
    return done
