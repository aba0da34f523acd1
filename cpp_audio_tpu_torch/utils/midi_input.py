"""Live MIDI input: byte-level message parsing + poll loop — the PortMidi
wrapper analog.

Reference (source/rt.resynth.lib.midi.cpp): a `PortMidi` wrapper (line 156)
polls the device in `listen_to_midi_input` (line 320), decodes NoteOn/NoteOff,
KeyPressure, ChannelPressure, PitchWheel and AllNotesOff variants, allocates
NoteIds through `NoteIdsGenerator` (key -> noteid multimap), and forwards
synth events; the pitch wheel becomes a global frequency multiplier
(`onAngleIncrementMultiplier`, gen.crtp.h:320-332, driven from
rt.resynth.lib.cpp:1519-1570).

Here the transport is abstract — any callable yielding raw `(status, d1, d2)`
byte triples (a /dev/snd reader, a network socket, a test fixture) — and the
decode/dispatch logic is identical. `MidiInput.poll()` is synchronous and
steppable; `listen()` wraps it in the reference's poll-thread shape.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from ..core import events
from .midifile import MidiEvent, NoteIdsGenerator
from .midi import Midi

# status-byte high nibbles (MIDI 1.0)
_NOTE_OFF = 0x80
_NOTE_ON = 0x90
_KEY_PRESSURE = 0xA0
_CONTROL = 0xB0
_CHANNEL_PRESSURE = 0xD0
_PITCH_WHEEL = 0xE0
_CC_ALL_NOTES_OFF = 123


def parse_midi_bytes(status: int, d1: int, d2: int, *, time: int = 0,
                     wheel_law: str = "midi14") -> MidiEvent | None:
    """Decode one raw MIDI message into a MidiEvent (or None if unhandled).

    Mirrors the event vocabulary of rt.resynth.lib.midi.cpp (NoteOn with
    velocity 0 is a NoteOff, pitch wheel centers at 8192 -> value in -1..1).

    wheel_law: "midi14" (standard 14-bit (d2<<7)|d1, 8192 centered — right
    for Standard MIDI Files) or "reference" (the reference's Arturia-
    calibrated law, rt.resynth.lib.midi.cpp:90-102,147-148: value =
    d1 + (d2<<8) mapped by -1 + 2*v/0x7F7F — NOT the MIDI 14-bit packing,
    and slightly off-center at wheel rest; oracle-pinned against the
    compiled reference decode).
    """
    kind = status & 0xF0
    channel = status & 0x0F
    if kind == _NOTE_ON and d2 > 0:
        return MidiEvent(time, "note_on", channel, key=d1, velocity=d2)
    if kind == _NOTE_OFF or (kind == _NOTE_ON and d2 == 0):
        return MidiEvent(time, "note_off", channel, key=d1, velocity=d2)
    if kind == _KEY_PRESSURE:
        return MidiEvent(time, "key_pressure", channel, key=d1, value=d2 / 127.0)
    if kind == _CHANNEL_PRESSURE:
        return MidiEvent(time, "channel_pressure", channel, value=d1 / 127.0)
    if kind == _PITCH_WHEEL:
        if wheel_law == "reference":
            raw = d1 + (d2 << 8)  # Arturia packing (midi.cpp:148)
            value = np.float32(-1.0) + np.float32(2.0) * np.float32(
                (raw - 0x0000) * np.float32(1.0 / 0x7F7F))
            return MidiEvent(time, "pitch_wheel", channel, value=float(value))
        raw = (d2 << 7) | d1  # 14-bit, 8192 = centered
        return MidiEvent(time, "pitch_wheel", channel,
                         value=(raw - 8192) / 8192.0)
    if kind == _CONTROL and d1 == _CC_ALL_NOTES_OFF:
        return MidiEvent(time, "all_notes_off", channel)
    return None


@dataclass
class MidiInputStats:
    polled: int = 0
    decoded: int = 0
    unhandled: int = 0


class MidiJitterCompensator:
    """MIDI time-source jitter compensation, in samples.

    Reference (TryAccountForTimeSourceJitter::Yes, gen.crtp.h:477-527 +
    midiDelays()/maxMIDIJitter() maps at gen.crtp.h:121-124): events carry
    timestamps from the MIDI driver's clock, which is offset from the audio
    clock and jitters. A per-source artificial delay is learned from the
    first event: delay = max_jitter + (audio_now - midi_time), so every
    subsequent event scheduled at midi_time + delay lands in the future with
    consistent latency (inter-note timing preserved). The registered delay
    is replaced only when a candidate deviates by more than
    2*(max_jitter + 0.1 ms) — early events measured during program startup
    may carry bogus timings (gen.crtp.h:494-502). Late events play
    immediately (gen.crtp.h:509-515).
    """

    def __init__(self, max_jitter_samples: float, sample_rate: int = 44100):
        self.max_jitter = float(max_jitter_samples)
        # reference adds 100000 ns to the replacement margin
        self._replace_margin = 2.0 * (self.max_jitter + 1e-4 * sample_rate)
        self.delays: dict[int, float] = {}

    def schedule(self, source: int, midi_time: float, now: float) -> float:
        """Absolute sample time at which the event should apply (>= now)."""
        candidate = self.max_jitter + (now - midi_time)
        delay = self.delays.get(source)
        if delay is None or abs(candidate - delay) > self._replace_margin:
            self.delays[source] = delay = candidate
        return max(midi_time + delay, now)


class MidiInput:
    """Poll raw MIDI bytes and drive a synth (listen_to_midi_input analog).

    source: callable returning a list of (status, d1, d2) or
            (timestamp, status, d1, d2) tuples per poll (empty when idle).
    synth:  anything with on_event(core.events.Event) — e.g. StreamingSynth.
    clock:  callable returning the current absolute sample time.
    """

    def __init__(self, source, synth, *, clock=None, sample_rate: int = 44100,
                 pitch_wheel_semitones: float = 2.0, velocity_scale: float = 1.0,
                 max_jitter_seconds: float | None = None, source_key: int = 0):
        self.source = source
        self.synth = synth
        self.clock = clock or (lambda: 0)
        self.sample_rate = sample_rate
        # jitter compensation applies to source-provided timestamps only
        # (4-tuple messages, a foreign clock); clock-stamped events are
        # already in audio time
        self.jitter = (MidiJitterCompensator(max_jitter_seconds * sample_rate,
                                             sample_rate)
                       if max_jitter_seconds else None)
        self.source_key = source_key
        self.pitch_wheel_semitones = pitch_wheel_semitones
        self.velocity_scale = velocity_scale
        self.note_ids = NoteIdsGenerator()
        self.stats = MidiInputStats()
        self._midi = Midi()
        self._freq_mult = 1.0     # onAngleIncrementMultiplier state
        self._base_freq: dict[int, float] = {}   # noteid -> unbent frequency
        self._velocity: dict[int, float] = {}
        self._stop = threading.Event()

    # -- decoding + dispatch ----------------------------------------------
    def poll(self) -> int:
        """Drain the source once; returns the number of synth events sent."""
        sent = 0
        for msg in self.source():
            self.stats.polled += 1
            if len(msg) == 4:
                t, status, d1, d2 = msg
                if self.jitter is not None:
                    t = self.jitter.schedule(self.source_key, t, self.clock())
            else:
                status, d1, d2 = msg
                t = self.clock()
            ev = parse_midi_bytes(status, d1, d2, time=int(t))
            if ev is None:
                self.stats.unhandled += 1
                continue
            self.stats.decoded += 1
            sent += self._dispatch(ev)
        return sent

    def dispatch(self, ev: MidiEvent) -> int:
        """Dispatch an already-decoded MidiEvent (e.g. from a Standard MIDI
        File, utils/midifile.read_midi_file) to the synth; returns the number
        of synth events sent. Same routing as poll()."""
        self.stats.decoded += 1
        return self._dispatch(ev)

    def _dispatch(self, ev: MidiEvent) -> int:
        if ev.kind == "note_on":
            nid = self.note_ids.note_on_id(ev.key)
            freq = float(self._midi.midi_pitch_to_freq(ev.key))
            self._base_freq[nid] = freq
            vel = self.velocity_scale * ev.velocity / 127.0
            self._velocity[nid] = vel
            self.synth.on_event(events.Event(
                events.EventType.NOTE_ON, ev.time, nid,
                freq * self._freq_mult, vel))
            return 1
        if ev.kind == "note_off":
            nid = self.note_ids.note_off_id(ev.key)
            if nid is None:
                return 0
            self._base_freq.pop(nid, None)
            self._velocity.pop(nid, None)
            self.synth.on_event(events.mk_note_off(ev.time, nid))
            return 1
        if ev.kind == "all_notes_off":
            n = 0
            for nid in list(self.note_ids.all_ids()):
                self.synth.on_event(events.mk_note_off(ev.time, nid))
                self._base_freq.pop(nid, None)
                self._velocity.pop(nid, None)
                n += 1
            self.note_ids.clear()
            return n
        if ev.kind == "pitch_wheel":
            # wheel -> frequency multiplier, retuning every live voice
            # (reference onAngleIncrementMultiplier, gen.crtp.h:320-332)
            self._freq_mult = 2.0 ** (
                self.pitch_wheel_semitones * ev.value / 12.0)
            n = 0
            for nid, freq in self._base_freq.items():
                self.synth.on_event(events.mk_note_change(
                    ev.time, nid, freq * self._freq_mult,
                    self._velocity.get(nid, 1.0)))
                n += 1
            return n
        # key/channel pressure: mapped to per-note / global volume changes
        if ev.kind == "key_pressure":
            n = 0
            for nid in self.note_ids._by_key.get(ev.key, []):
                self.synth.on_event(events.mk_note_change(
                    ev.time, nid,
                    self._base_freq.get(nid, 440.0) * self._freq_mult,
                    self.velocity_scale * ev.value))
                self._velocity[nid] = self.velocity_scale * ev.value
                n += 1
            return n
        return 0

    # -- the poll-thread shape (reference listen_to_midi_input) ------------
    def listen(self, *, interval_seconds: float = 0.001, max_polls: int | None = None):
        """Blocking poll loop; run it in a thread for live use."""
        polls = 0
        while not self._stop.is_set():
            self.poll()
            polls += 1
            if max_polls is not None and polls >= max_polls:
                break
            time.sleep(interval_seconds)

    def start(self, **kw) -> threading.Thread:
        th = threading.Thread(target=self.listen, kwargs=kw, daemon=True)
        th.start()
        return th

    def stop(self) -> None:
        self._stop.set()
