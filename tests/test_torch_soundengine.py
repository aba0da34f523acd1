"""The port's procedural SoundEngine (models/soundengine.py, with the host
copies models/voice_presets.py and utils/markov.py) against the JAX
package's, on the CPU.

Bars: host copies (programs, engine configs, Markov walks, spec schedules
and timelines) give exactly JAX's results; logramp_increments in float64
within 1e-12 of JAX; render_program in float64 within 1e-9 of the peak and
in float32 within 2e-4 of it (the batch bar of
tests/test_batched_serving.py:26), against JAX's float64 render (JAX sums
float32 phases in float32 chunks and drifts further, the port in float64;
ROADMAP §C); a batch against JAX's batch and the port's single renders at
2e-4. The JAX package's own scheduler, renderer and batch tests also run
against the port (device="cpu"), at their own bars. Renders are 8,192
samples, so the JAX references share few compiled shapes.
"""

import numpy as np
import pytest
import torch

import test_batched_serving as jt_batch
import test_logramp_exact as jt_logramp
import test_soundengine as jt_se
from cpp_audio_tpu.models import soundengine as jse
from cpp_audio_tpu.models import voice_presets as jvp
from cpp_audio_tpu.utils import markov as jmarkov
from cpp_audio_tpu_torch.models import soundengine as tse
from cpp_audio_tpu_torch.models import voice_presets as tvp
from cpp_audio_tpu_torch.utils import markov as tmarkov
from cpp_audio_tpu_torch.utils.interp import Itp
from test_torch_engine_core import OnCPU, on_port

SR = 44100
N = 8192
F64_BAR = 1e-9
F32_BAR = 2e-4
ENGINE_PROGRAMS = [(m, p.name) for m in (tvp.Mode.BIRDS, tvp.Mode.ROBOTS, tvp.Mode.SWEEP)
                   for p in tvp.PROGRAMS[m]]
ALL_PROGRAMS = [(m, p.name) for m, ps in tvp.PROGRAMS.items() for p in ps]


def _programs(mode, name):
    return (jvp.get_program(jvp.Mode(mode.value), name), tvp.get_program(mode, name))


# ---- the JAX package's own tests, against the port -------------------------

def _se_globals(monkeypatch):
    on_port(monkeypatch, jt_se, se=OnCPU(tse), vp=tvp, MarkovChain=tmarkov.MarkovChain,
            MarkovMove=tmarkov.MarkovMove)


class TestPortMarkov(jt_se.TestMarkov):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        _se_globals(monkeypatch)


class TestPortScheduler(jt_se.TestScheduler):
    _port = TestPortMarkov._port


class TestPortRenderer(jt_se.TestRenderer):
    _port = TestPortMarkov._port


class TestPortBirdsBatch(jt_batch.TestBirdsBatch):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_batch, se=OnCPU(tse), voice_presets=tvp)


# ---- host copies ------------------------------------------------------------

def test_program_inventory_and_order_match_jax():
    """All 27 programs, in the reference's alphabetical order per mode."""
    assert [m.value for m in tvp.PROGRAMS] == [m.value for m in jvp.PROGRAMS]
    for m, ps in tvp.PROGRAMS.items():
        assert [p.name for p in ps] == [p.name for p in jvp.PROGRAMS[jvp.Mode(m.value)]]
    assert sum(len(ps) for ps in tvp.PROGRAMS.values()) == 27


@pytest.mark.parametrize("mode,name", ALL_PROGRAMS, ids=lambda v: getattr(v, "value", v))
def test_program_and_engine_config_match_jax(mode, name):
    jp, tp = _programs(mode, name)
    for f in jp.__dataclass_fields__:
        a, b = getattr(jp, f), getattr(tp, f)
        if hasattr(a, "value"):
            a, b = a.value, b.value
        assert a == b, f
    assert repr(tvp.effective_engine_config(tp, SR)).replace("cpp_audio_tpu_torch", "") \
        == repr(jvp.effective_engine_config(jp, SR)).replace("cpp_audio_tpu", "")


def _walk(markov):
    events = []
    mc = markov.MarkovChain()
    nodes = [mc.emplace(lambda m, me, o, i=i: events.append((i, m.value))) for i in range(4)]
    for a, b, pr in ((0, 1, 0.5), (1, 2, 0.3), (1, 0, 0.2), (2, 3, 0.9), (3, 0, 0.4), (2, 1, 0.1)):
        mc.def_transition(nodes[a], nodes[b], pr)
    mc.initialize(nodes[0])
    rng = np.random.default_rng(8)
    for i, u in enumerate(rng.uniform(0, 1, 60)):
        (mc.step_normalized if i % 3 else mc.step)(float(u), execute=i % 5 != 0)
        events.append(("at", mc.current))
    return events


def test_markov_walk_matches_jax():
    assert _walk(tmarkov) == _walk(jmarkov)


@pytest.mark.parametrize("mode,name", ENGINE_PROGRAMS, ids=lambda v: getattr(v, "value", v))
def test_schedule_matches_jax(mode, name):
    """The Markov walk's spec table and the timeline, for two seeds."""
    jp, tp = _programs(mode, name)
    for seed in (3, 32):
        js = jse.SoundEngineScheduler(jp, SR, 440.0, seed=seed)
        ts = tse.SoundEngineScheduler(tp, SR, 440.0, seed=seed)
        jspecs, tspecs = js.build_specs(), ts.build_specs()
        assert [tuple(vars(s).values()) for s in tspecs] == \
            [tuple(vars(s).values()) for s in jspecs]
        assert [(tuple(vars(s).values()), a, b) for s, a, b in ts.timeline(tspecs)] == \
            [(tuple(vars(s).values()), a, b) for s, a, b in js.timeline(jspecs)]
        assert ts.rng.uniform() == js.rng.uniform()


def test_loudness_lut_matches_jax():
    for args in ((5, 1.0, 30.0, SR), (3, 0.8, 60.0, 48000)):
        for a, b in zip(tse._loudness_lut(*args), jse._loudness_lut(*args)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- device renderer ----------------------------------------------------------

@pytest.mark.parametrize("frm,to,D,s0,itp", jt_logramp.CASES + [
    (0.02, 0.02, 800.0, 0.0, Itp.LINEAR), (0.004, 0.03, 300.0, 120.0, Itp.EASE_OUT_SINE)])
def test_logramp_increments_match_jax(frm, to, D, s0, itp):
    """40k samples of ping-pong legs, float64: within 1e-12 of JAX, and of
    the per-sample scalar port of LogRamp::do_step at JAX's own bar."""
    n = 40000
    want = jt_logramp.closed_form(n, frm, to, D, s0, int(itp))
    f = lambda v: torch.tensor(v, dtype=torch.float64)
    got = tse.logramp_increments(torch.arange(n, dtype=torch.float64), f(frm), f(to), f(D),
                                 f(s0), torch.tensor(int(itp))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    scalar = jt_logramp.scalar_logramp(n, frm, to, D, s0, int(itp))
    assert np.abs(got - scalar).max() <= 1e-10 * max(abs(to - frm), 1e-30) or to == frm


RENDER_CASES = [(tvp.Mode.BIRDS, "Standard & Cute bird", 32), (tvp.Mode.BIRDS, "Talkative bird", 3),
                (tvp.Mode.ROBOTS, "R2D2", 7), (tvp.Mode.SWEEP, "Sweep 1", 1)]


def _render_pair(mode, name, seed, dtype, **kw):
    jp, tp = _programs(mode, name)
    want = np.asarray(jse.render_program(jp, 440.0, N, SR, seed=seed, dtype=dtype, **kw))
    got = tse.render_program(tp, 440.0, N, SR, seed=seed, dtype=dtype, device="cpu", **kw)
    assert torch.is_tensor(got) and got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape == (N, 2)
    return got.numpy(), want


@pytest.mark.parametrize("mode,name,seed", RENDER_CASES, ids=lambda v: getattr(v, "value", v))
def test_render_program_float64_matches_jax(mode, name, seed):
    got, want = _render_pair(mode, name, seed, "float64")
    peak = np.abs(want).max()
    assert peak > 1e-4
    assert np.abs(got - want).max() <= F64_BAR * peak


@pytest.mark.parametrize("mode,name,seed", RENDER_CASES[:3], ids=lambda v: getattr(v, "value", v))
def test_render_program_float32_matches_jax(mode, name, seed):
    """Held against JAX's float64 render: JAX's own float32 render sums its
    phase in float32 chunks and drifts up to 3e-4 of the peak from its
    float64 one (R2D2), the port's float64-summed phase ~1e-5 (ROADMAP §C)."""
    jp, tp = _programs(mode, name)
    want = np.asarray(jse.render_program(jp, 440.0, N, SR, seed=seed, pan=0.25,
                                         dtype="float64"))
    got = tse.render_program(tp, 440.0, N, SR, seed=seed, pan=0.25, device="cpu")
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= F32_BAR * np.abs(want).max()


def test_render_program_batch_matches_jax_and_single_renders():
    jp, tp = _programs(tvp.Mode.BIRDS, tvp.PROGRAMS[tvp.Mode.BIRDS][0].name)
    seeds = [2, 5, 9, 11]
    want = np.asarray(jse.render_program_batch(jp, 440.0, N, SR, seeds=seeds))
    got = tse.render_program_batch(tp, 440.0, N, SR, seeds=seeds, device="cpu")
    assert torch.is_tensor(got) and got.shape == want.shape
    got = got.numpy()
    assert np.abs(got - want).max() <= F32_BAR * np.abs(want).max()
    for bi, seed in enumerate(seeds):
        single = tse.render_program(tp, 440.0, N, SR, seed=seed, device="cpu").numpy()
        peak = max(np.abs(single).max(), 1e-9)
        assert np.abs(got[bi] - single[:got.shape[1]]).max() <= F32_BAR * peak
    host = tse.render_program_batch(tp, 440.0, N, SR, seeds=seeds, device_out=False,
                                    device="cpu")
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, got)


def test_render_is_deterministic():
    tp = tvp.get_program(tvp.Mode.BIRDS, "Scat bird")
    a = tse.render_program(tp, 440.0, N, seed=63, device="cpu")
    b = tse.render_program(tp, 440.0, N, seed=63, device="cpu")
    assert torch.equal(a, b)
    c = tse.render_program_batch(tp, 440.0, N, seeds=[4, 63], device="cpu")
    d = tse.render_program_batch(tp, 440.0, N, seeds=[4, 63], device="cpu")
    assert torch.equal(c, d)
