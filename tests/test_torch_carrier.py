"""The port's carrier synth (cpp_audio_tpu_torch.models.carrier) and the
oscillator / envelope functions it renders with, against the JAX package.

Bars: float32 at t0 < 1 s atol 1e-5 (the two packages evaluate the same
float32 closed form; their transcendental functions round differently in
the last bits); float64 against JAX's per-sample scalar model of the
reference element stack at its own 1e-8 (tests/test_carrier.py:123). At
t0 ~ 59 s both packages' float32 renders sit ~5e-3 from a float64
evaluation of the same closed form (the sample index times the increment
at ~5e4 carries ~4e-3 of phase in float32): both are held there at 1e-2,
on continuous waveforms (sine, triangle), where a phase error cannot flip
a sample across a jump.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.core import events
from cpp_audio_tpu.models import carrier
from cpp_audio_tpu.ops import envelopes, oscillators
from cpp_audio_tpu_torch.core import events as tevents
from cpp_audio_tpu_torch.models import carrier as tcarrier
from cpp_audio_tpu_torch.ops import envelopes as tenvelopes
from cpp_audio_tpu_torch.ops import oscillators as toscillators
from test_carrier import scalar_carrier_voice
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
FULL_MIX = dict(noise=0.15, saw=0.3, triangle=0.2, square=0.1, sine=0.25,
                pulse=0.2, pulse_width=0.3)


def _pair(dtype="float32", **cfg):
    """(JAX synth, port synth) from one dict of config fields."""
    osc = cfg.pop("osc", {})
    ref = carrier.CarrierSynth(carrier.CarrierSynthConfig(
        sample_rate=SR, osc=carrier.CarrierOscMix(**osc), dtype=dtype, **cfg))
    got = tcarrier.CarrierSynth(tcarrier.CarrierSynthConfig(
        sample_rate=SR, osc=tcarrier.CarrierOscMix(**osc), dtype=dtype, **cfg),
        device="cpu")
    return ref, got


def _both(pair, fn):
    """Apply fn(synth, events module) to the JAX and the port synth."""
    return fn(pair[0], events), fn(pair[1], tevents)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _steady(s, ev):
    s.on_event(ev.Event(ev.EventType.NOTE_ON, 50, 1, 440.0, 0.7))
    s.on_event(ev.mk_note_off(4000, 1))
    return _np(s.compute(0, 6000))


def _glide(s, ev, t=2000):
    s.on_event(ev.Event(ev.EventType.NOTE_ON, 0, 1, 300.0, 1.0))
    a = _np(s.compute(0, t))
    s.on_event(ev.mk_note_change(t, 1, 450.0, 1.0))
    return np.concatenate([a, _np(s.compute(t, t))])


@pytest.mark.parametrize("scenario,osc", [("steady", FULL_MIX), ("glide", dict(sine=1.0))])
def test_scalar_parity_float64(scenario, osc):
    """The port at float64 against JAX's per-sample scalar model."""
    s = tcarrier.CarrierSynth(tcarrier.CarrierSynthConfig(
        sample_rate=SR, osc=tcarrier.CarrierOscMix(**osc), seed=3, dtype="float64"),
        device="cpu")
    got = (_steady if scenario == "steady" else _glide)(s, tevents)
    v = (s._finished + list(s._notes.values()))[0]
    mix = carrier.CarrierOscMix(**osc)
    if scenario == "steady":
        want = scalar_carrier_voice(
            6000, sample_rate=SR, press=50, release=4000.0, velocity=0.7,
            segments=[(50, 440.0)], osc=mix, ahdsr=s.config.ahdsr,
            start_phase=v.phase_ref, noise_start=v.noise_start)
    else:
        # the retune moved phase_ref: replay the start angle from the seed
        angle = np.random.default_rng(3).uniform(-1.0, 1.0)
        want = scalar_carrier_voice(
            4000, sample_rate=SR, press=0, release=float(2**62), velocity=1.0,
            segments=[(0, 300.0), (2000, 450.0)], osc=mix, ahdsr=s.config.ahdsr,
            start_phase=np.mod(angle, 2.0), noise_start=v.noise_start)
    assert np.abs(got - want).max() < 1e-8


@pytest.mark.parametrize("scenario", ["steady", "glide"])
def test_matches_jax_float32(scenario):
    """The glide retunes at t = 1000 and renders 1000 samples on: past the
    glide the phase is a float32 sum of ~20 whose last bit the two packages'
    log/expm1 can set differently (XLA's float32 transcendentals differ from
    torch's by up to a few ulps), and one ulp of phase at |phase| ~33 is
    1.2e-5 of a sine (measured at t = 3612 of the 4000-sample scenario)."""
    pair = _pair(osc=FULL_MIX if scenario == "steady" else dict(sine=1.0, triangle=0.5),
                 seed=3)
    ref, got = _both(pair, _steady if scenario == "steady"
                     else lambda s, ev: _glide(s, ev, t=1000))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_block_split_invariance_matches_jax():
    def run(s, ev, splits):
        s.on_event(ev.Event(ev.EventType.NOTE_ON, 10, 1, 220.0, 0.9))
        s.on_event(ev.Event(ev.EventType.NOTE_ON, 700, 2, 330.0, 0.4))
        s.on_event(ev.mk_note_off(3000, 2))
        return np.concatenate([_np(s.compute(t, c)) for t, c in splits])

    osc = dict(saw=0.5, noise=0.3)
    whole = _both(_pair(osc=osc, seed=1), lambda s, ev: run(s, ev, [(0, 4096)]))
    parts = _both(_pair(osc=osc, seed=1),
                  lambda s, ev: run(s, ev, [(0, 1000), (1000, 96), (1096, 3000)]))
    np.testing.assert_allclose(parts[1], whole[1], atol=1e-6)
    np.testing.assert_allclose(whole[1], whole[0], atol=1e-5)
    np.testing.assert_allclose(parts[1], parts[0], atol=1e-5)


def test_polyphony_drop_matches_jax():
    def run(s, ev):
        ok = [s.on_event(ev.Event(ev.EventType.NOTE_ON, 0, i, 100.0 + i, 0.5))
              for i in range(6)]
        return ok, len(s._notes), s.dropped_note_on

    ref, got = _both(_pair(n_voices=2), run)
    assert got == ref == ([True] * 4 + [False] * 2, 4, 2)


def test_release_end_matches_jax():
    def run(s, ev):
        s.on_event(ev.Event(ev.EventType.NOTE_ON, 0, 1, 440.0, 1.0))
        s.on_event(ev.mk_note_off(1000, 1))
        out = _np(s.compute(0, 8000))
        end = s._finished[0].finished_at
        # the channel frees at Done2: the next compute past it drops the voice
        after = _np(s.compute(int(end), 16))
        return out, end, len(s._finished), after

    (ref, ref_end, ref_n, _), (got, got_end, got_n, after) = _both(
        _pair(osc=dict(sine=1.0)), run)
    assert got_end == ref_end < 8000 and got_n == ref_n == 0
    assert np.abs(got[3000:]).max() == 0.0 and np.abs(got[:1000]).max() > 0.1
    assert np.abs(after).max() == 0.0
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("glide", [False, True], ids=["steady", "glide"])
def test_late_block_against_float64(glide):
    """t0 = 59 s: JAX's and the port's float32 renders against the port's
    float64 render of the same voices (the same closed form at float64).
    Measured on the CPU: ~4.1e-3 (port) and ~4.8e-3 (JAX) on a 0.7-velocity
    sine voice glided from 440 to 470 Hz at t = 2000."""
    def run(s, ev):
        s.on_event(ev.Event(ev.EventType.NOTE_ON, 50, 1, 440.0, 0.7))
        s.on_event(ev.Event(ev.EventType.NOTE_ON, 900, 2, 110.0, 0.5))
        if glide:
            s.on_event(ev.mk_note_change(2000, 1, 470.0, 0.6))
        return np.asarray(_np(s.compute(59 * SR, 2048)), np.float64)

    osc = dict(sine=1.0, triangle=0.4)
    ref32, got32 = _both(_pair(osc=osc, seed=3), run)
    _, got64 = _both(_pair(dtype="float64", osc=osc, seed=3), run)
    assert np.abs(got64).max() > 0.3
    assert np.abs(got32 - got64).max() < 1e-2
    assert np.abs(ref32 - got64).max() < 1e-2


def _osc_cases():
    rng = np.random.default_rng(5)
    ph = rng.uniform(0.0, 2.0, (3, 257))
    inc = rng.uniform(0.001, 0.05, (3, 300))
    t = np.arange(-50, 3000, 7.0)
    press = np.array([[0.0], [100.0], [400.0]])
    release = np.array([[2000.0], [90.0], [2500.0]])
    env = envelopes.AHDSR(attack=np.array([[300.0], [50.0], [10.0]]), hold=20,
                          decay=np.array([[400.0], [600.0], [5.0]]),
                          release=np.array([[700.0], [300.0], [800.0]]),
                          attack_itp=3, decay_itp=9, release_itp=0, sustain=0.6)
    tenv = tenvelopes.AHDSR(**vars(env))
    inc1 = np.array([0.01, 0.02])
    return {
        "phase_trajectory": (
            lambda m, e: m.phase_trajectory(np.array([0.3, 1.9, 0.0]), inc)[0],
            lambda m, e: m.phase_trajectory(torch.tensor([0.3, 1.9, 0.0], dtype=torch.float64),
                                            torch.from_numpy(inc))[0]),
        "phase_trajectory_axis0": (
            lambda m, e: m.phase_trajectory(np.array([0.3, 1.9, 0.0]), inc.T, axis=0)[0],
            lambda m, e: m.phase_trajectory(torch.tensor([0.3, 1.9, 0.0], dtype=torch.float64),
                                            torch.from_numpy(inc.T), axis=0)[0]),
        "chunked_cumsum_axis0": (
            lambda m, e: m.chunked_cumsum(np.ones((4, 3)), axis=0),
            lambda m, e: m.chunked_cumsum(np.ones((4, 3)), axis=0)),
        "chunked_cumsum_axis1": (
            lambda m, e: m.chunked_cumsum(np.ones((4, 3)), axis=1),
            lambda m, e: m.chunked_cumsum(np.ones((4, 3)), axis=1)),
        "chunked_cumsum_long_axis0": (  # several chunks of either package
            lambda m, e: m.chunked_cumsum(inc.T.copy(), axis=0, chunk=128),
            lambda m, e: m.chunked_cumsum(torch.from_numpy(inc.T.copy()), axis=0, chunk=64)),
        "phase_trajectory_const": (
            lambda m, e: m.phase_trajectory_const(np.array([0.5, 1.2]), inc1, 400,
                                                  dtype=np.float64),
            lambda m, e: m.phase_trajectory_const(np.array([0.5, 1.2]), inc1, 400,
                                                  dtype=torch.float64, device="cpu")),
        "cosine": (lambda m, e: m.cosine(ph), lambda m, e: m.cosine(torch.from_numpy(ph))),
        "saw": (lambda m, e: m.saw(ph), lambda m, e: m.saw(torch.from_numpy(ph))),
        "square": (lambda m, e: m.square(ph), lambda m, e: m.square(torch.from_numpy(ph))),
        "triangle": (lambda m, e: m.triangle(ph),
                     lambda m, e: m.triangle(torch.from_numpy(ph))),
        "pulse": (lambda m, e: m.pulse(ph, 0.3, 0.85, -0.15),
                  lambda m, e: m.pulse(torch.from_numpy(ph), 0.3, 0.85, -0.15)),
        "pulse_train_levels": (lambda m, e: np.stack(m.pulse_train_levels(np.array([0.3, 2.5]))),
                               lambda m, e: torch.stack(m.pulse_train_levels(
                                   torch.tensor([0.3, 2.5], dtype=torch.float64)))),
        "ring_modulate": (lambda m, e: m.ring_modulate(ph, ph[::-1]),
                          lambda m, e: m.ring_modulate(torch.from_numpy(ph),
                                                       torch.from_numpy(ph[::-1].copy()))),
        "ring_modulate_sines": (
            lambda m, e: m.ring_modulate_sines(0.013, 0.007, 500, phase1=0.2,
                                               dtype=np.float64),
            lambda m, e: m.ring_modulate_sines(0.013, 0.007, 500, phase1=0.2,
                                               dtype=torch.float64, device="cpu")),
        "min_change_duration": (
            lambda m, e: e.min_change_duration_from_increment(inc1),
            lambda m, e: e.min_change_duration_from_increment(torch.from_numpy(inc1))),
        "ahdsr_envelope": (
            lambda m, e: e.ahdsr_envelope(t, env, press, release, min_change=30.0,
                                          dtype=np.float64),
            lambda m, e: e.ahdsr_envelope(torch.from_numpy(t), tenv, press, release,
                                          min_change=30.0, dtype=torch.float64)),
        "ahdsr_auto_release": (
            lambda m, e: e.ahdsr_envelope(t, env, press, auto_release=True,
                                          dtype=np.float64),
            lambda m, e: e.ahdsr_envelope(torch.from_numpy(t), tenv, press,
                                          auto_release=True, dtype=torch.float64)),
        "envelope_end_time": (
            lambda m, e: e.envelope_end_time(env, press, release, min_change=30.0),
            lambda m, e: e.envelope_end_time(tenv, press, release, min_change=30.0)),
    }


@pytest.mark.parametrize("name", sorted(_osc_cases()))
def test_oscillator_and_envelope_functions_match_jax(name):
    ref_fn, got_fn = _osc_cases()[name]
    ref = np.asarray(ref_fn(oscillators, envelopes))
    got = _np(got_fn(toscillators, tenvelopes))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
