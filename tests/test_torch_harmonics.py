"""The port's harmonics synth and preset parsing against the JAX package's,
on the CPU (the voice-bank kernel's plain version renders every segment).

The preset files are written into a temporary directory with the contents
tests/test_harmonics.py documents for the reference's synth/ directory.

Bars: render_schedule at atol 2e-5 (the voice bank's bar,
tests/test_pallas_voicebank.py:45) at float32 and float64; with the order-2
low-pass on, 1e-4 (the FFT cascade's bar, tests/test_torch_filters.py).
Preset parsing and the bank tables exact, the anti-alias gains within 1e-15.
"""

import numpy as np
import pytest

from cpp_audio_tpu.core import events as jev
from cpp_audio_tpu.core import voices as jvo
from cpp_audio_tpu.models import harmonics as jh
from cpp_audio_tpu.utils import presets as jpre
from cpp_audio_tpu_torch.core import events as tev
from cpp_audio_tpu_torch.core import voices as tvo
from cpp_audio_tpu_torch.models import harmonics as th
from cpp_audio_tpu_torch.models import voicebank as tvb
from cpp_audio_tpu_torch.utils import presets as tpre
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
BANK_BAR = 2e-5
LOWPASS_BAR = 1e-4
AHDSR_FIELDS = ("attack", "attack_itp", "hold", "decay", "decay_itp", "release",
                "release_itp", "sustain")


def write_presets(d):
    """EnvelopeFast (A 1, H 1, D 2, S 4, R 4 dots), EnvelopeZero, Harmonics
    (5, 2, 0, 2, 0, 1, 0, 3 dots) and LowPass (800) in directory d."""
    (d / "EnvelopeFast.txt").write_text("A .\nH .\nD ..\nS ....\nR ....\n")
    (d / "EnvelopeZero.txt").write_text("A\nS\n")
    (d / "Harmonics.txt").write_text("\n".join("." * k for k in (5, 2, 0, 2, 0, 1, 0, 3)) + "\n")
    (d / "LowPass.txt").write_text("cutoff\n800\n")
    return d


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    return write_presets(tmp_path_factory.mktemp("synth"))


def _notes(mod, n, seconds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        press = int(rng.uniform(0, seconds * SR * 0.9))
        out.append(mod.Note(i + 1, press, press + int(rng.uniform(0.05, 0.4) * SR),
                            float(rng.uniform(80, 2500)), float(rng.uniform(0.3, 1.0)),
                            float(rng.uniform(-1, 1))))
    return out


def _schedules(n, seconds, seed, pad_to):
    return (jvo.schedule_from_notes(_notes(jev, n, seconds, seed), pad_to=pad_to),
            tvo.schedule_from_notes(_notes(tev, n, seconds, seed), pad_to=pad_to))


def _configs(synth_dir, dtype, lowpass):
    out = []
    for pre, h in ((jpre, jh), (tpre, th)):
        out.append(h.HarmonicsSynthConfig(
            sample_rate=SR, ahdsr=pre.parse_envelope_file(synth_dir / "EnvelopeFast.txt", SR),
            harmonic_volumes=tuple(pre.parse_harmonics_file(synth_dir / "Harmonics.txt")),
            lowpass_freq=pre.parse_lowpass_file(synth_dir / "LowPass.txt") if lowpass else None,
            dtype=dtype))
    return out


def test_preset_parsing_matches_jax(synth_dir):
    for name in ("EnvelopeFast.txt", "EnvelopeZero.txt"):
        a = tpre.parse_envelope_file(synth_dir / name, SR)
        b = jpre.parse_envelope_file(synth_dir / name, SR)
        assert [getattr(a, f) for f in AHDSR_FIELDS] == [getattr(b, f) for f in AHDSR_FIELDS]
    fast = tpre.parse_envelope_file(synth_dir / "EnvelopeFast.txt", SR)
    assert (fast.attack, fast.hold, fast.decay, fast.release) == (441, 441, 882, 1764)
    assert fast.sustain == pytest.approx(0.4)
    vols = tpre.parse_harmonics_file(synth_dir / "Harmonics.txt")
    np.testing.assert_array_equal(vols, jpre.parse_harmonics_file(synth_dir / "Harmonics.txt"))
    np.testing.assert_allclose(vols, np.array([5, 2, 0, 2, 0, 1, 0, 3]) / 5.0)
    assert tpre.parse_lowpass_file(synth_dir / "LowPass.txt") == 800.0
    assert jpre.parse_lowpass_file(synth_dir / "LowPass.txt") == 800.0


def test_bank_from_schedule_matches_jax(synth_dir):
    """Every field of the bank, row by row: notes x 8 harmonics, the silent
    and the aliased (above Nyquist) harmonics kept as rows."""
    js, ts = _schedules(12, 2.0, 1, 16)
    js.frequency[0] = ts.frequency[0] = 4000.0  # harmonics 6-8 above Nyquist
    jc, tc = _configs(synth_dir, "float32", True)
    jb, tb = jh.bank_from_schedule(js, jc), th.bank_from_schedule(ts, tc)
    assert tb.n_rows == jb.n_rows == 16 * 8
    for f in ("press", "release", "increment", "phase0", "gains", "attack", "hold",
              "decay", "release_len", "sustain"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    np.testing.assert_allclose(tb.amp, jb.amp, rtol=1e-15, atol=0)
    assert (tb.amp[5:8] == 0).all() and (tb.amp[[2, 4, 6]] == 0).all()
    assert (tb.attack_itp, tb.decay_itp, tb.release_itp) == (jb.attack_itp, jb.decay_itp,
                                                             jb.release_itp)


def test_trailing_silent_harmonics_trimmed():
    cfg = th.HarmonicsSynthConfig(harmonic_volumes=(1.0, 0.0, 0.5, 0.0, 0.0))
    sch = tvo.schedule_from_notes([tev.Note(1, 0, 30000, 220.0, 1.0, 0.0)], pad_to=1)
    assert th.bank_from_schedule(sch, cfg).n_rows == 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("lowpass", [False, True])
def test_render_schedule_matches_jax(synth_dir, dtype, lowpass):
    """A 1 s score of 6 notes with the tune preset (eased attack and
    release): the dense path (48 rows)."""
    js, ts = _schedules(6, 1.0, 2, 6)
    jc, tc = _configs(synth_dir, dtype, lowpass)
    got = th.render_schedule(ts, SR, tc, device="cpu")
    ref = np.asarray(jh.render_schedule(js, SR, jc))
    assert got.shape == ref.shape == (SR, 2) and str(got.dtype) == f"torch.{dtype}"
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=LOWPASS_BAR if lowpass else BANK_BAR)


def test_render_schedule_sparse_three_segments(synth_dir, monkeypatch):
    """36 notes x 8 harmonics = 288 rows (above dense_rows = 256) over 3
    segments of 2^18 samples: the segmented path, one render per segment."""
    n = 3 * (1 << 18) - 5000
    js, ts = _schedules(36, n / SR, 3, 36)
    jc, tc = _configs(synth_dir, "float32", False)
    calls = []
    plain = tvb.render_bank

    def counted(bank, n_samples, **kw):
        calls.append(bank.n_rows)
        return plain(bank, n_samples, **kw)

    monkeypatch.setattr(tvb, "render_bank", counted)
    got = th.render_schedule(ts, n, tc, device="cpu")
    assert len(calls) == 3 and max(calls) < 288
    ref = np.asarray(jh.render_schedule(js, n, jc))
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BANK_BAR)
