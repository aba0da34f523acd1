"""The port's note deduction (cpp_audio_tpu_torch.analysis.notes) against
the JAX package's, on the CPU.

deduce_notes: the same notes (sample bounds equal, pitch within 1e-3
semitone, volume within 1e-4) on a signal of three Hann-shaped tones, with
the dB span at -40: the leakage of their Hann edges leaves notes at ~4 Hz
near -46 dB whose tracking churns with the float32 FFT's rounding (not a
port fault, ROADMAP §C). resynth_deduced: the same notes rendered at
atol 1e-5 (float32, the voice-bank kernel's plain version here).
"""

import dataclasses

import numpy as np
import pytest

from cpp_audio_tpu.analysis import notes
from cpp_audio_tpu_torch.analysis import notes as tnotes
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100


def _signal():
    n = 3 * SR
    t = np.arange(n) / SR
    sig = np.zeros(n)
    for f0, s0, s1, a in [(220.0, 0.1, 1.5, 0.3), (330.0, 0.6, 2.4, 0.2),
                          (523.25, 1.2, 2.9, 0.25)]:
        i0, i1 = int(s0 * SR), int(s1 * SR)
        sig[i0:i1] += a * np.hanning(i1 - i0) * np.sin(2 * np.pi * f0 * t[: i1 - i0])
    return sig


@pytest.fixture(scope="module")
def deduced():
    sig = _signal()
    return (notes.deduce_notes(sig, SR, min_db_span=-40.0),
            tnotes.deduce_notes(sig, SR, min_db_span=-40.0, device="cpu"))


def test_deduce_notes_matches_jax(deduced):
    ref, got = deduced
    assert len(got) == len(ref) >= 3
    for r, g in zip(ref, got):
        assert (g.start_sample, g.end_sample) == (r.start_sample, r.end_sample)
        assert abs(g.midi_pitch - r.midi_pitch) < 1e-3
        assert abs(g.frequency - r.frequency) < 1e-3 * r.frequency
        assert abs(g.volume - r.volume) < 1e-4
    assert sorted(round(g.midi_pitch) for g in got) == [57, 64, 72]


def test_notes_image_and_bmp_bytes_match_jax(deduced, tmp_path):
    ref_notes, _ = deduced
    port_notes = [tnotes.DeducedNote(**dataclasses.asdict(n)) for n in ref_notes]
    for kw in ({}, {"width": 97, "pitch_range": (50, 80)}):
        ref = notes.notes_image(ref_notes, **kw)
        got = tnotes.notes_image(port_notes, **kw)
        np.testing.assert_array_equal(got, ref)
        notes.write_bmp(tmp_path / "ref.bmp", ref)
        tnotes.write_bmp(tmp_path / "got.bmp", got)
        assert (tmp_path / "got.bmp").read_bytes() == (tmp_path / "ref.bmp").read_bytes()
    np.testing.assert_array_equal(tnotes.notes_image([]), notes.notes_image([]))


@pytest.mark.parametrize("stride", [0, 3969])
def test_resynth_deduced_matches_jax(deduced, stride):
    ref_notes, _ = deduced
    port_notes = [tnotes.DeducedNote(**dataclasses.asdict(n)) for n in ref_notes]
    ref = np.asarray(notes.resynth_deduced(ref_notes, sample_rate=SR, stride=stride))
    got = tnotes.resynth_deduced(port_notes, sample_rate=SR, stride=stride,
                                 device="cpu").numpy()
    assert got.shape == ref.shape and got.shape[1] == 1
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
