"""MIDI input: event vocabulary + Standard MIDI File reader + NoteId mapping.

Reference (source/rt.resynth.lib.midi.cpp): live PortMidi input with events
NoteOn/NoteOff/KeyPressure/ChannelPressure/PitchWheel/AllNotesOff, a
`NoteIdsGenerator` multimap (key -> noteids, :190-240), and a poll loop.
There is no audio device here, so the live poll loop is replaced by a
Standard MIDI File (SMF format 0/1) reader producing the same event stream
with absolute sample times; `midi_events_to_notes` applies the reference's
NoteOn/Off/PitchWheel semantics (rt.resynth.lib.cpp:1519-1570 — pitch wheel
multiplies frequencies of future notes by halfToneRatio ** (multiplier *
centered wheel value)).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..core.events import Note
from .midi import Midi


@dataclass(frozen=True)
class MidiEvent:
    time: int          # absolute sample index
    kind: str          # note_on / note_off / key_pressure / channel_pressure /
                       # pitch_wheel / all_notes_off
    channel: int = 0
    key: int = 0
    velocity: int = 0
    value: float = 0.0  # pressure or centered pitch-wheel value (-1..1)


class NoteIdsGenerator:
    """key -> stack of note ids (reference NoteIdsGenerator multimap)."""

    def __init__(self):
        self._next = 0
        self._by_key: dict[int, list[int]] = {}

    def note_on_id(self, key: int) -> int:
        self._next += 1
        self._by_key.setdefault(key, []).append(self._next)
        return self._next

    def note_off_id(self, key: int) -> int | None:
        ids = self._by_key.get(key)
        if not ids:
            return None
        return ids.pop(0)

    def all_ids(self):
        for ids in self._by_key.values():
            yield from ids

    def clear(self):
        self._by_key.clear()


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    v = 0
    while True:
        b = data[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            return v, pos


def read_midi_file(path, sample_rate: int = 44100) -> list[MidiEvent]:
    """Parse an SMF (format 0/1) into sample-timed MidiEvents (merged tracks)."""
    blob = open(path, "rb").read()
    if blob[0:4] != b"MThd":
        raise ValueError(f"{path}: not a MIDI file")
    (hlen, fmt, ntrk, division) = struct.unpack(">IHHH", blob[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    ticks_per_quarter = division
    pos = 8 + hlen

    all_events: list[tuple[int, int, MidiEvent]] = []  # (tick, order, proto)
    tempo_changes: list[tuple[int, int]] = [(0, 500000)]  # (tick, us/quarter)

    order = 0
    for _ in range(ntrk):
        if blob[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        (tlen,) = struct.unpack(">I", blob[pos + 4 : pos + 8])
        data = blob[pos + 8 : pos + 8 + tlen]
        pos += 8 + tlen
        tick = 0
        p = 0
        running = 0
        while p < len(data):
            delta, p = _read_varlen(data, p)
            tick += delta
            status = data[p]
            if status & 0x80:
                p += 1
                if status < 0xF0:
                    running = status
            else:
                status = running
            kind = status & 0xF0
            ch = status & 0x0F
            ev = None
            if kind == 0x90:
                key, vel = data[p], data[p + 1]
                p += 2
                ev = MidiEvent(0, "note_on" if vel else "note_off", ch, key, vel)
            elif kind == 0x80:
                key, vel = data[p], data[p + 1]
                p += 2
                ev = MidiEvent(0, "note_off", ch, key, vel)
            elif kind == 0xA0:
                key, pr = data[p], data[p + 1]
                p += 2
                ev = MidiEvent(0, "key_pressure", ch, key, 0, pr / 127.0)
            elif kind == 0xD0:
                pr = data[p]
                p += 1
                ev = MidiEvent(0, "channel_pressure", ch, 0, 0, pr / 127.0)
            elif kind == 0xE0:
                lo, hi = data[p], data[p + 1]
                p += 2
                raw = lo | (hi << 7)
                ev = MidiEvent(0, "pitch_wheel", ch, 0, 0, (raw - 8192) / 8192.0)
            elif kind == 0xB0:
                cc, val = data[p], data[p + 1]
                p += 2
                if cc == 123:  # All Notes Off
                    ev = MidiEvent(0, "all_notes_off", ch)
            elif kind == 0xC0:
                p += 1  # program change: ignored
            elif status == 0xFF:
                meta = data[p]
                ln, p2 = _read_varlen(data, p + 1)
                if meta == 0x51 and ln == 3:
                    us = (data[p2] << 16) | (data[p2 + 1] << 8) | data[p2 + 2]
                    tempo_changes.append((tick, us))
                p = p2 + ln
            elif status in (0xF0, 0xF7):
                ln, p2 = _read_varlen(data, p + 1)
                p = p2 + ln
            else:
                break  # unknown: stop parsing this track
            if ev is not None:
                all_events.append((tick, order, ev))
                order += 1

    tempo_changes.sort()

    def tick_to_sample(t: int) -> int:
        secs = 0.0
        prev_tick, prev_us = tempo_changes[0]
        for tk, us in tempo_changes[1:]:
            if tk >= t:
                break
            secs += (tk - prev_tick) * prev_us / 1e6 / ticks_per_quarter
            prev_tick, prev_us = tk, us
        secs += (t - prev_tick) * prev_us / 1e6 / ticks_per_quarter
        return int(round(secs * sample_rate))

    all_events.sort(key=lambda x: (x[0], x[1]))
    return [MidiEvent(tick_to_sample(t), e.kind, e.channel, e.key, e.velocity,
                      e.value)
            for t, _, e in all_events]


def midi_events_to_notes(events: list[MidiEvent], *,
                         pitch_wheel_multiplier: float = 2.0,
                         midi: Midi | None = None,
                         never: int = 2**62) -> list[Note]:
    """Apply the reference's live-MIDI semantics to an event stream.

    NoteOn frequency = midi_pitch_to_freq(key) x the current pitch-wheel
    factor (applied to NEW notes via last_angle_increment_multiplier,
    gen.crtp.h:321-324,436); velocity / 127; AllNotesOff releases everything
    (rt.resynth.lib.cpp:1544-1555).
    """
    midi = midi or Midi()
    gen = NoteIdsGenerator()
    open_notes: dict[int, Note] = {}
    done: list[Note] = []
    wheel_factor = 1.0
    for ev in events:
        if ev.kind == "note_on":
            nid = gen.note_on_id(ev.key)
            freq = float(midi.midi_pitch_to_freq(float(ev.key))) * wheel_factor
            open_notes[nid] = Note(nid, ev.time, never, freq,
                                   ev.velocity / 127.0)
        elif ev.kind == "note_off":
            nid = gen.note_off_id(ev.key)
            n = open_notes.pop(nid, None) if nid is not None else None
            if n is not None:
                n.release = ev.time
                done.append(n)
        elif ev.kind == "all_notes_off":
            for nid in list(open_notes):
                n = open_notes.pop(nid)
                n.release = ev.time
                done.append(n)
            gen.clear()
        elif ev.kind == "pitch_wheel":
            half_tones = pitch_wheel_multiplier * ev.value
            wheel_factor = midi.half_tone_ratio**half_tones
    done.extend(open_notes.values())
    done.sort(key=lambda n: n.press)
    return done


def render_midi_file(path, *, sample_rate: int = 44100, config=None,
                     tail_seconds: float = 1.0, device="cuda"):
    """SMF -> polyphonic sine-synth render (the MIDI-playable carrier path):
    ((n, channels) tensor on `device`, sample_rate). On a CUDA device the
    render is one launch of the voice-bank kernel per synth block."""
    from ..core.voices import schedule_from_notes
    from ..models import sine_synth

    events = read_midi_file(path, sample_rate)
    notes = midi_events_to_notes(events)
    cfg = config or sine_synth.SineSynthConfig(sample_rate=sample_rate)
    sch = schedule_from_notes(notes, pad_to=32)
    end = max((n.release for n in notes if n.release < 2**61), default=0)
    n_samples = int(end + tail_seconds * sample_rate)
    return (sine_synth.render_schedule(sch, n_samples, cfg, device=device),
            cfg.sample_rate)
