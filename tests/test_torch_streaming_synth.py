"""The port's StreamingSynth (cpp_audio_tpu_torch.models.streaming_synth)
against the JAX package's, on the CPU (the voice-bank kernel's plain version
renders each pulled block here; on a card the kernel does).

Bars: JAX's own (tests/test_engine_streaming.py:131-201): the streamed
render against the offline render at float64 atol 1e-9; the port's blocks
against JAX's at float32 atol 2e-5 (the voice-bank bar,
tests/test_pallas_voicebank.py:45), retunes included; the same drop counts.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.core import events
from cpp_audio_tpu.models import sine_synth, streaming_synth
from cpp_audio_tpu.ops import envelopes
from cpp_audio_tpu_torch.core import events as tevents
from cpp_audio_tpu_torch.core import voices as tvoices
from cpp_audio_tpu_torch.models import sine_synth as tsine
from cpp_audio_tpu_torch.models import streaming_synth as tstreaming
from cpp_audio_tpu_torch.ops import envelopes as tenvelopes
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100


def _pair(ahdsr: dict, n_voices: int, **cfg):
    """(JAX synth, port synth) from one dict of field values."""
    ref = streaming_synth.StreamingSynth(sine_synth.SineSynthConfig(
        sample_rate=SR, ahdsr=envelopes.AHDSR(**ahdsr), **cfg), n_voices=n_voices)
    got = tstreaming.StreamingSynth(tsine.SineSynthConfig(
        sample_rate=SR, ahdsr=tenvelopes.AHDSR(**ahdsr), **cfg), n_voices=n_voices,
        device="cpu")
    return ref, got


def test_voice_stealing_drops_match_jax():
    """The reference channel-occupancy policy (gen.crtp.h:221-225,398-413):
    the same acceptances and drop counts event by event."""
    def run(s, ev):
        seq = [s.on_event(ev.mk_note_on(0, 440.0 + 10 * i, 1.0, note_id=i))
               for i in range(4)]
        seq.append(s.on_event(ev.mk_note_on(0, 660.0, 1.0, note_id=9)))
        seq.append(s.on_event(ev.mk_note_off(100, note_id=0)))
        seq.append(s.on_event(ev.mk_note_on(101, 770.0, 1.0, note_id=10)))
        seq.append(s.on_event(ev.mk_note_on(1200, 770.0, 1.0, note_id=11)))
        return seq, s.dropped_note_on

    ref_s, got_s = _pair(dict(attack=10, hold=0, decay=0, release=1000, sustain=1.0), 2)
    ref, got = run(ref_s, events), run(got_s, tevents)
    assert got == ref == ([True] * 4 + [False, True, False, True], 2)


def test_streamed_matches_offline_float64():
    """Blocks of 4096 pulled through compute() against the offline render
    of the same note (tests/test_engine_streaming.py:131-152)."""
    cfg = tsine.SineSynthConfig(
        sample_rate=SR, dtype="float64",
        ahdsr=tenvelopes.AHDSR(attack=441, hold=0, decay=441, release=2000, sustain=0.7))
    synth = tstreaming.StreamingSynth(cfg, device="cpu")
    synth.on_event(tevents.mk_note_on(0, 440.0, 1.0, note_id=1, pan=0.0))
    blocks = [synth.compute(4096 * i, 4096) for i in range(4)]
    synth.on_event(tevents.mk_note_off(4 * 4096, note_id=1))
    blocks += [synth.compute(4096 * i, 4096) for i in range(4, 7)]
    streamed = torch.cat(blocks)
    assert streamed.dtype == torch.float64 and streamed.shape == (7 * 4096, 2)
    notes = [tevents.Note(1, 0, 4 * 4096, 440.0, 1.0, 0.0)]
    offline = tsine.render_schedule(tvoices.schedule_from_notes(notes, pad_to=8),
                                    7 * 4096, cfg, device="cpu")
    assert float(offline.abs().max()) > 0.05
    np.testing.assert_allclose(streamed.numpy(), offline.numpy(), atol=1e-9)


@pytest.mark.parametrize("block", [512, 496])
def test_blocks_with_retunes_match_jax_float32(block):
    """512-sample pulls (and the ragged 496 a 60 s run ends with) with a
    phase-continuous retune of one voice every block, a second voice
    released mid-run, against JAX's blocks (tests/test_engine_streaming.py:
    154-178 at the live block size)."""
    ref_s, got_s = _pair(dict(attack=100, hold=0, decay=0, release=1000, sustain=1.0), 4)

    def run(s, ev):
        s.on_event(ev.mk_note_on(0, 440.0, 1.0, note_id=1, pan=0.0))
        s.on_event(ev.mk_note_on(300, 660.0, 0.5, note_id=2, pan=0.3))
        out, t = [], 0
        for k in range(12):
            o = s.compute(t, block)
            out.append(o.numpy() if torch.is_tensor(o) else np.asarray(o))
            t += block
            s.on_event(ev.mk_note_change(t, 1, 440.0 + 3.0 * (k + 1), 1.0))
            if k == 6:
                s.on_event(ev.mk_note_off(t, 2))
        return np.concatenate(out)

    ref, got = run(ref_s, events), run(got_s, tevents)
    assert got.dtype == np.float32 and got.shape == ref.shape == (12 * block, 2)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    # the retunes are phase-continuous: no step at a block edge larger than
    # inside the blocks (tests/test_engine_streaming.py:175-178)
    d = np.abs(np.diff(got[:, 0]))
    assert max(d[block * k - 1] for k in range(1, 12)) < 3.0 * np.median(d)


def test_schedule_shift_keeps_far_press_exact():
    """A pull long after the press (press shifted to ~-2.6e6) renders the
    same samples as the offline render at that time (float32, the voice-bank
    bar)."""
    cfg = tsine.SineSynthConfig(
        sample_rate=SR, ahdsr=tenvelopes.AHDSR(attack=441, hold=0, decay=441,
                                               release=2000, sustain=0.7))
    synth = tstreaming.StreamingSynth(cfg, device="cpu")
    synth.on_event(tevents.mk_note_on(0, 110.0, 0.8, note_id=1, pan=0.2))
    t0 = 59 * SR
    bank = synth.bank_at(t0)
    assert bank.press.min() == -t0
    got = synth.compute(t0, 512)
    notes = [tevents.Note(1, 0, int(2**62), 110.0, 0.8, 0.2)]
    sch = tvoices.schedule_from_notes(notes, pad_to=8)
    off = tsine.render_schedule(sch, t0 + 512, cfg, device="cpu")[t0:]
    assert float(off.abs().max()) > 0.02
    np.testing.assert_allclose(got.numpy(), off.numpy(), atol=2e-5)
