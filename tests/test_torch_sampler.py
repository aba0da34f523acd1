"""The port's sampler against the JAX package's, on the CPU.

Bars: SampleMap selection and trim_sample exact (host copies);
render_notes at atol 1e-12 at float64 and 1e-6 at float32, on notes that
cross several of the port's time blocks (sampler._BLOCK samples) and, with
a small sampler._TILE_ELEMENTS, several voice passes inside a block.
"""

import numpy as np
import pytest

from cpp_audio_tpu.core import events as jev
from cpp_audio_tpu.models import sampler as jsm
from cpp_audio_tpu_torch.core import events as tev
from cpp_audio_tpu_torch.models import sampler as tsm
from cpp_audio_tpu_torch.ops import envelopes as tenv
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
BARS = {"float64": 1e-12, "float32": 1e-6}


def _sample(rng, freq, seconds):
    t = np.arange(int(seconds * SR)) / SR
    return np.sin(2 * np.pi * freq * t) * np.exp(-t * rng.uniform(1.0, 4.0))


def _maps(seed=0):
    rng = np.random.default_rng(seed)
    maps = (jsm.SampleMap(), tsm.SampleMap())
    for freq, secs in ((220.0, 1.2), (440.0, 0.6), (880.0, 0.0), (1320.0, 2.0)):
        s = _sample(rng, freq, secs)
        for m in maps:
            m.add_for_frequency(freq, SR, s)
    return maps


def _notes(mod, n, seconds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        press = int(rng.uniform(0, seconds * SR * 0.8))
        out.append(mod.Note(i + 1, press, press + int(rng.uniform(0.05, 1.5) * SR),
                            float(rng.choice([110.0, 200.0, 430.0, 700.0, 1000.0, 5000.0])),
                            float(rng.uniform(0.3, 1.0)), float(rng.uniform(-1, 1))))
    return out


def test_sample_map_and_trim_match_jax():
    jm, tm = _maps()
    assert len(jm) == len(tm) == 4
    for inc in (0.001, 0.0099, 0.02, 0.03, 0.045, 0.06, 0.2):
        assert tm.select_index(inc) == jm.select_index(inc)
        a, b = tm.select(inc), jm.select(inc)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    x = np.zeros(400)
    x[100:300] = np.sin(np.linspace(0.3, 9 * np.pi, 200))
    for data in (x, np.stack([x, 0.5 * x], axis=1), np.zeros(50)):
        np.testing.assert_array_equal(tsm.trim_sample(data), jsm.trim_sample(data))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("tile", [None, 3 * (1 << 15)])
def test_render_notes_matches_jax(dtype, tile, monkeypatch):
    """24 notes over 3 s (about 4 time blocks; samples up to 2 s long, so
    notes span several blocks), a note mapped to the empty sample and one
    above the map; tile = 3 blocks of rows per pass: 3 voices per pass."""
    if tile is not None:
        monkeypatch.setattr(tsm, "_TILE_ELEMENTS", tile)
    n = 3 * SR
    jm, tm = _maps(1)
    jn, tn = _notes(jev, 24, 3.0, 2), _notes(tev, 24, 3.0, 2)
    ah = dict(attack=300, hold=0, decay=0, release=2000, sustain=1.0)
    jc = jsm.SamplerConfig(dtype=dtype, ahdsr=jsm.envelopes.AHDSR(**ah))
    tc = tsm.SamplerConfig(dtype=dtype, ahdsr=tenv.AHDSR(**ah))
    got = tsm.render_notes(tn, tm, n, tc, device="cpu")
    ref = np.asarray(jsm.render_notes(jn, jm, n, jc))
    assert got.shape == ref.shape == (n, 2) and str(got.dtype) == f"torch.{dtype}"
    assert np.abs(ref).max() > 1e-2
    spans = [(x.press // tsm._BLOCK, (x.press + SR) // tsm._BLOCK) for x in tn]
    assert any(b > a + 1 for a, b in spans)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BARS[dtype])


def test_render_notes_default_config_and_silence():
    """The default config (zero attack, 4410-sample release); notes above
    the map render silence, as in the JAX package."""
    jm, tm = _maps(2)
    jn = [jev.Note(1, 100, 30000, 440.0, 1.0, 0.0), jev.Note(2, 50, 9000, 9000.0, 1.0, 0.5)]
    tn = [tev.Note(1, 100, 30000, 440.0, 1.0, 0.0), tev.Note(2, 50, 9000, 9000.0, 1.0, 0.5)]
    got = tsm.render_notes(tn, tm, 40000, tsm.SamplerConfig(dtype="float64"), device="cpu")
    ref = np.asarray(jsm.render_notes(jn, jm, 40000, jsm.SamplerConfig(dtype="float64")))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    silent = tsm.render_notes(tn[1:], tm, 1000, tsm.SamplerConfig(), device="cpu")
    assert silent.shape == (1000, 2) and float(silent.abs().max()) == 0.0
