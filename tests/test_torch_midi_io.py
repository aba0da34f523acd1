"""The port's MIDI file reader and MIDI input (host copies) against the JAX
package's, on the CPU, and MIDI driving the port's synths.

Bars: decoded events and notes exactly; MidiInput dispatch into the
port's CarrierSynth against JAX's into its own at float64, atol 1e-12 (the
carrier tests' float64 bar, tests/test_torch_carrier.py; at float32 the
file's pitch-wheel glide puts the two packages' transcendentals a few ulps
of phase apart, ~1e-4, which tests/test_torch_carrier.py holds separately);
render_midi_file through the voice bank at atol 2e-5 (the voice-bank bar,
tests/test_pallas_voicebank.py:45).
"""

import struct

import numpy as np
import pytest
import torch

from cpp_audio_tpu.core import events as jevents
from cpp_audio_tpu.models import carrier as jcarrier
from cpp_audio_tpu.utils import midi_input as jmi
from cpp_audio_tpu.utils import midifile as jmf
from cpp_audio_tpu_torch.core import events as tevents
from cpp_audio_tpu_torch.models import carrier as tcarrier
from cpp_audio_tpu_torch.utils import midi_input as tmi
from cpp_audio_tpu_torch.utils import midifile as tmf
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100


def _varlen(v):
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


def _write_smf(path, tracks, ticks_per_quarter=480, tempo_us=500000):
    """A format-1 SMF: tracks of (delta_ticks, bytes); a tempo change
    halfway through the first track exercises the tick->sample map."""
    chunks = b""
    for i, events in enumerate(tracks):
        trk = b"\x00\xff\x51\x03" + struct.pack(">I", tempo_us)[1:] if i == 0 else b""
        for delta, msg in events:
            trk += _varlen(delta) + msg
        trk += b"\x00\xff\x2f\x00"
        chunks += b"MTrk" + struct.pack(">I", len(trk)) + trk
    path.write_bytes(b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks), ticks_per_quarter)
                     + chunks)


def _smf(path):
    _write_smf(path, [
        [(0, bytes([0x90, 69, 100])), (240, bytes([0x90, 72, 90])),
         (0, bytes([0xE0, 0x00, 0x60])),        # wheel up half
         (240, bytes([0xFF, 0x51, 0x03, 0x07, 0xA1, 0x20])),  # tempo 500000 -> 500000
         (120, bytes([0xA0, 72, 64])),          # key pressure
         (120, bytes([0x80, 69, 0])), (0, bytes([72, 0])),   # running status off
         (240, bytes([0xD0, 50])), (0, bytes([0xC0, 5]))],
        [(100, bytes([0x91, 60, 80])), (500, bytes([0xB1, 7, 100])),
         (100, bytes([0xB1, 123, 0])), (480, bytes([0x91, 64, 70])),
         (480, bytes([0x81, 64, 0]))],
    ])


def test_read_midi_file_matches_jax(tmp_path):
    _smf(tmp_path / "t.mid")
    for sr in (SR, 11025):
        got = tmf.read_midi_file(tmp_path / "t.mid", sample_rate=sr)
        ref = jmf.read_midi_file(tmp_path / "t.mid", sample_rate=sr)
        assert [vars(e) for e in got] == [vars(e) for e in ref]
    assert {e.kind for e in got} >= {"note_on", "note_off", "pitch_wheel",
                                      "key_pressure", "channel_pressure", "all_notes_off"}
    notes = tmf.midi_events_to_notes(got, pitch_wheel_multiplier=2.0)
    jnotes = jmf.midi_events_to_notes(ref, pitch_wheel_multiplier=2.0)
    assert [vars(n) for n in notes] == [vars(n) for n in jnotes]
    (tmp_path / "bad.mid").write_bytes(b"RIFF0000")
    with pytest.raises(ValueError):
        tmf.read_midi_file(tmp_path / "bad.mid")


def test_parse_midi_bytes_matches_jax():
    msgs = [(0x90, 69, 100), (0x90, 69, 0), (0x81, 60, 0), (0xE0, 0x00, 0x40),
            (0xE0, 0x7F, 0x7F), (0xE0, 0, 0), (0xB0, 123, 0), (0xB0, 7, 100),
            (0xA2, 60, 64), (0xD3, 90, 0)]
    for law in ("midi14", "reference"):
        for m in msgs:
            got = tmi.parse_midi_bytes(*m, time=7, wheel_law=law)
            ref = jmi.parse_midi_bytes(*m, time=7, wheel_law=law)
            assert (got is None and ref is None) or vars(got) == vars(ref)


def _event_tuple(ev):
    return (ev.type.name, ev.time, ev.note_id, ev.frequency, ev.velocity)


class _Recorder:
    def __init__(self):
        self.events = []

    def on_event(self, ev):
        self.events.append(_event_tuple(ev))
        return True


def test_midi_input_poll_and_jitter_match_jax():
    msgs = [[(1000, 0x90, 69, 100)], [(1500, 0x90, 72, 90), (1600, 0xE0, 0x7F, 0x7F)],
            [(0xA0, 72, 50), (2000, 0x80, 69, 0)], [(0xB0, 123, 0)], []]
    out = []
    for mod in (tmi, jmi):
        it = iter(list(msgs))
        rec = _Recorder()
        mi = mod.MidiInput(lambda: next(it, []), rec, clock=lambda: 3000,
                           sample_rate=SR, max_jitter_seconds=0.01)
        for _ in msgs:
            mi.poll()
        out.append((rec.events, vars(mi.stats)))
    assert out[0] == out[1]


def test_midi_file_dispatch_into_carrier_matches_jax(tmp_path):
    """MidiInput.dispatch of a file's events into each package's
    CarrierSynth, block by block as apps/resynth.py --live --midi does."""
    _smf(tmp_path / "t.mid")
    dtype = "float64"
    osc = dict(saw=0.5, sine=0.3, triangle=0.2, pulse=0.1, noise=0.05)
    synths = (
        tcarrier.CarrierSynth(tcarrier.CarrierSynthConfig(
            sample_rate=SR, osc=tcarrier.CarrierOscMix(**osc), dtype=dtype), device="cpu"),
        jcarrier.CarrierSynth(jcarrier.CarrierSynthConfig(
            sample_rate=SR, osc=jcarrier.CarrierOscMix(**osc), dtype=dtype)))
    inputs = (tmi.MidiInput(lambda: [], synths[0], sample_rate=SR),
              jmi.MidiInput(lambda: [], synths[1], sample_rate=SR))
    evs = (tmf.read_midi_file(tmp_path / "t.mid", SR), jmf.read_midi_file(tmp_path / "t.mid", SR))
    n, block = SR, 512
    outs = ([], [])
    k = [0, 0]
    for t0 in range(0, n, block):
        for i in range(2):
            while k[i] < len(evs[i]) and evs[i][k[i]].time < t0 + block:
                inputs[i].dispatch(evs[i][k[i]])
                k[i] += 1
            outs[i].append(synths[i].compute(t0, block))
    got = torch.cat(outs[0]).numpy()
    ref = np.concatenate([np.asarray(x) for x in outs[1]])
    assert vars(inputs[0].stats) == vars(inputs[1].stats)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_render_midi_file_matches_jax(tmp_path):
    _smf(tmp_path / "t.mid")
    got, sr = tmf.render_midi_file(tmp_path / "t.mid", sample_rate=SR, device="cpu")
    ref, jsr = jmf.render_midi_file(tmp_path / "t.mid", sample_rate=SR)
    assert sr == jsr == SR and torch.is_tensor(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)


def test_note_ids_and_events_copies():
    g = tmf.NoteIdsGenerator()
    a, b = g.note_on_id(60), g.note_on_id(60)
    assert a != b and g.note_off_id(60) == a and g.note_off_id(60) == b
    assert g.note_off_id(60) is None
    ev = tevents.mk_note_off(5, 3)
    jev = jevents.mk_note_off(5, 3)
    assert _event_tuple(ev) == _event_tuple(jev)
