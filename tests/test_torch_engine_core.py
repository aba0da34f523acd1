"""The port's engine core (core/engine.py, core/wrapper.py, core/queues.py,
core/params.py, core/platform.py), native.RingBuffer, utils.interp.interpolate
and sine_synth.render_to_wav against the JAX package's, on the CPU.

Bars: the streaming convolver and limiter, the engine's bus and the float64
Wrapper at 1e-9 (tests/test_engine_streaming.py's convolver bar); the
float32 Wrapper at 2e-5 (the StreamingSynth float32 bar of
tests/test_torch_streaming_synth.py); interpolate at 1e-12; host copies
(queues, params, platform, ring buffer) give exactly JAX's results. The
JAX package's own test classes for these modules also run against the port
(their module globals pointed at the port's modules, its entry points on
device="cpu"), at those tests' own bars.
"""

import inspect

import numpy as np
import pytest
import torch

import test_engine_streaming as jt_engine
import test_facades as jt_facades
import test_native as jt_native
import test_platform as jt_platform
import test_queues as jt_queues
import test_score_params as jt_params
from cpp_audio_tpu import native as jnative
from cpp_audio_tpu.core import engine as jeng
from cpp_audio_tpu.core import events as jev
from cpp_audio_tpu.core import params as jparams
from cpp_audio_tpu.core import platform as jplat
from cpp_audio_tpu.core import queues as jq
from cpp_audio_tpu.core import wrapper as jwrapper
from cpp_audio_tpu.models import sine_synth as jsine
from cpp_audio_tpu.models import voice_presets as jvp
from cpp_audio_tpu.ops import envelopes as jenv
from cpp_audio_tpu.utils import interp as jinterp
from cpp_audio_tpu.utils import wav as wavio
from cpp_audio_tpu_torch import native as tnative
from cpp_audio_tpu_torch.core import engine as teng
from cpp_audio_tpu_torch.core import events as tev
from cpp_audio_tpu_torch.core import params as tparams
from cpp_audio_tpu_torch.core import platform as tplat
from cpp_audio_tpu_torch.core import queues as tq
from cpp_audio_tpu_torch.core import voices as tvoices
from cpp_audio_tpu_torch.core import wrapper as twrapper
from cpp_audio_tpu_torch.models import sine_synth as tsine
from cpp_audio_tpu_torch.models import voice_presets as tvp
from cpp_audio_tpu_torch.ops import envelopes as tenv
from cpp_audio_tpu_torch.utils import interp as tinterp

SR = 44100
STREAM_BAR = 1e-9
F32_BAR = 2e-5


def _host(v):
    if torch.is_tensor(v):
        return v.numpy()
    if isinstance(v, tuple):
        return tuple(_host(x) for x in v)
    return v


class HostView:
    """A port object seen through the JAX tests: the tensors its methods
    return come back as host arrays, as the JAX package's do."""

    def __init__(self, obj):
        object.__setattr__(self, "_obj", obj)

    def __getattr__(self, name):
        v = getattr(self._obj, name)
        if callable(v) and not isinstance(v, type):
            return lambda *a, **k: _host(v(*a, **k))
        return v

    def __setattr__(self, name, value):
        setattr(self._obj, name, value)

    def __call__(self, *a, **k):
        return _host(self._obj(*a, **k))


class OnCPU:
    """A port module seen through the JAX tests: every callable of it that
    takes `device` gets device="cpu" (the port's default is "cuda"), and
    then the tensors such a function returns come back as host arrays and
    such a class's objects as HostViews."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        v = getattr(self._module, name)
        if not callable(v) or inspect.ismodule(v):
            return v
        try:
            takes = "device" in inspect.signature(v).parameters
        except (TypeError, ValueError):
            takes = False
        if not takes:
            return v
        if isinstance(v, type):
            return lambda *a, **k: HostView(v(*a, device="cpu", **k))
        return lambda *a, **k: _host(v(*a, device="cpu", **k))


def on_port(monkeypatch, jax_test_module, **names):
    """Point the JAX test module's globals `names` at the port's objects."""
    for name, value in names.items():
        monkeypatch.setattr(jax_test_module, name, value)


# ---- the JAX package's own tests, against the port -------------------------

class TestPortStreamingOps(jt_engine.TestStreamingOps):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_engine, eng=OnCPU(teng))


class TestPortEngine(jt_engine.TestEngine):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_engine, eng=OnCPU(teng))


class TestPortWrapper(jt_facades.TestWrapper):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_facades, Wrapper=OnCPU(twrapper).Wrapper, events=tev)


class TestPortMetaQueue(jt_queues.TestMetaQueue):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_queues, **{n: getattr(tq, n) for n in (
            "AudioBufferAggregator", "AudioBufferPubSub", "DroppedFrames",
            "MetaQueue", "ReadQueuedSampleSource")})


class TestPortReadQueuedSampleSource(jt_queues.TestReadQueuedSampleSource):
    _port = TestPortMetaQueue._port


class TestPortAggregatorAndPubSub(jt_queues.TestAggregatorAndPubSub):
    _port = TestPortMetaQueue._port


class TestPortParamPlumbing(jt_params.TestParamPlumbing):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_params, params=tparams, vp=tvp)


def _platform_globals(monkeypatch):
    on_port(monkeypatch, jt_platform, platform=tplat,
            AudioEngine=OnCPU(teng).AudioEngine)


class TestPortOutputContext(jt_platform.TestOutputContext):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        _platform_globals(monkeypatch)


class TestPortInputContext(jt_platform.TestInputContext):
    _port = TestPortOutputContext._port


class TestPortFullDuplex(jt_platform.TestFullDuplex):
    _port = TestPortOutputContext._port


class TestPortInt16OutputContext(jt_platform.TestInt16OutputContext):
    _port = TestPortOutputContext._port


class TestPortSoundDeviceContexts(jt_platform.TestSoundDeviceContexts):
    _port = TestPortOutputContext._port


class TestPortRingBuffer(jt_native.TestRingBuffer):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_native, native=tnative)


# ---- direct parity ----------------------------------------------------------

@pytest.mark.parametrize("taps,partition,block,channels", [
    (64, 256, 128, 1), (3000, 256, 500, 2), (9000, 1024, 3000, 2), (700, 256, 97, 2)])
def test_streaming_convolver_matches_jax(taps, partition, block, channels):
    rng = np.random.default_rng(taps)
    x = rng.standard_normal((6000, channels)) * 0.2
    ir = rng.standard_normal(taps) * 0.05
    j = jeng.StreamingConvolver(ir, wet=0.7, partition=partition)
    t = teng.StreamingConvolver(ir, wet=0.7, partition=partition, device="cpu")
    for s in range(0, len(x), block):
        want = j(x[s:s + block])
        got = t(x[s:s + block])
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=STREAM_BAR)
    offline = np.convolve(x[:, -1], ir)[:len(x)]
    tail = teng.StreamingConvolver(ir, wet=1.0, dry=0.0, partition=partition,
                                   device="cpu")
    streamed = torch.cat([tail(x[s:s + block]) for s in range(0, len(x), block)])
    np.testing.assert_allclose(streamed[:, -1].numpy(), offline, atol=STREAM_BAR)


def test_streaming_limiter_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((20000, 2)) * np.linspace(0.1, 4.0, 20000)[:, None]
    j = jeng.StreamingLimiter(ceiling=0.8, release_ms=30.0)
    t = teng.StreamingLimiter(ceiling=0.8, release_ms=30.0)
    for s, n in ((0, 700), (700, 4096), (4796, 1), (4797, 15203)):
        want = j(x[s:s + n])
        got = t(torch.from_numpy(x[s:s + n]))
        np.testing.assert_allclose(got.numpy(), want, atol=STREAM_BAR)
    assert float(t._peak) == pytest.approx(j._peak, rel=1e-12)
    np.testing.assert_array_equal(
        teng.clamp_guard(torch.tensor([[np.nan, 2.0], [-3.0, 0.5]])).numpy(),
        jeng.clamp_guard(np.array([[np.nan, 2.0], [-3.0, 0.5]])))


def test_engine_bus_and_post_match_jax():
    """Two computes (one finishing), a oneshot and the post chain
    (convolver, limiter, clamp): the bus lives on the device and `step`
    returns a float64 tensor there."""
    rng = np.random.default_rng(3)
    sig = rng.standard_normal((9000, 2))
    ir = rng.standard_normal(2000) * 0.03

    def build(mod, **kw):
        e = mod.AudioEngine(SR, 2, **kw)
        e.register_compute(lambda t0, n: sig[t0:t0 + n] if t0 < 5000 else None)
        e.register_compute(lambda t0, n: 0.5 * np.ones((n, 2)))
        ran = []
        e.enqueue_oneshot(lambda eng, t: ran.append(t))
        e.post.add(mod.StreamingConvolver(ir, wet=0.5, partition=512, **kw))
        e.post.add(mod.StreamingLimiter(ceiling=1.0))
        e.post.add(mod.clamp_guard)
        return e, ran

    je, jran = build(jeng)
    te, tran = build(teng, device="cpu")
    want = je.render(8000, block_size=1500)
    got = te.render(8000, block_size=1500)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=STREAM_BAR)
    assert tran == jran == [0]
    assert len(te._computes) == len(je._computes) == 1
    assert te.stats.frames_rendered == je.stats.frames_rendered == 8000


@pytest.mark.parametrize("dtype,bar", [("float64", STREAM_BAR), ("float32", F32_BAR)])
def test_wrapper_matches_jax(dtype, bar):
    """Wrapper.process with events, through the StreamingSynth and the post
    chain (limiter, clamp)."""
    def run(sine, ev, wrapper, ahdsr):
        cfg = sine.SineSynthConfig(
            sample_rate=SR, dtype=dtype,
            ahdsr=ahdsr(attack=441, hold=0, decay=441, release=2000, sustain=0.7))
        kw = {"device": "cpu"} if wrapper is twrapper else {}
        w = wrapper.Wrapper(cfg, n_voices=4, **kw)
        script = [[ev.mk_note_on(100, 440.0, 1.0, note_id=1, pan=0.3),
                   ev.mk_note_on(900, 660.0, 0.8, note_id=2, pan=-0.5)],
                  [ev.mk_note_change(4096 + 200, 1, 450.0, 0.9)],
                  [ev.mk_note_off(8192 + 10, note_id=1)], []]
        return np.concatenate([np.asarray(w.process(evs, 4096)) for evs in script]), w

    want, jw = run(jsine, jev, jwrapper, jenv.AHDSR)
    got, tw = run(tsine, tev, twrapper, tenv.AHDSR)
    assert got.shape == want.shape == (4 * 4096, 2)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=bar)
    assert tw.stats.blocks_rendered == jw.stats.blocks_rendered == 4


def test_queues_match_jax():
    """The same push / pop / drop sequence through both packages' queues."""
    rng = np.random.default_rng(5)
    blocks = [rng.standard_normal(int(n)) for n in rng.integers(1, 40, 30)]

    def run(q):
        ps = q.AudioBufferPubSub()
        a, b = ps.add_listener(64), ps.add_listener(24)
        agg = q.AudioBufferAggregator(q.ReadQueuedSampleSource(a),
                                      q.ReadQueuedSampleSource(b))
        log = []
        for blk in blocks:
            ok = ps.try_publish_buffer(blk)
            out = agg.read(int(len(blk) * 0.8))
            log.append((ok, out.tolist(), len(a), len(b), a.total_dropped,
                        b.total_dropped, [s.continuity.contiguous for s in agg.sources],
                        [s.underruns for s in agg.sources]))
        log.append([a.pop() for _ in range(len(a))])
        return log

    got, want = run(tq), run(jq)
    assert repr(got) == repr(want)


def test_params_match_jax():
    """Normalized programs, limits and param specs of every mode."""
    for mode, progs in tvp.PROGRAMS.items():
        jmode = jvp.Mode(mode.value)
        assert len(tparams.MODE_PARAMS[mode]) == len(jparams.MODE_PARAMS[jmode])
        assert repr(tparams.get_param_specs(mode)) == repr(jparams.get_param_specs(jmode))
        for p, jp in zip(progs, jvp.PROGRAMS[jmode]):
            tn = tparams.voice_program_to_normalized(p)
            jn = jparams.voice_program_to_normalized(jp)
            assert tn.name == jn.name
            np.testing.assert_array_equal(np.asarray(tn.values), np.asarray(jn.values))
            back = tparams.normalized_to_voice_program(mode, tn)
            jback = jparams.normalized_to_voice_program(jmode, jn)
            assert repr(back).split("(", 1)[1] == repr(jback).split("(", 1)[1]


def test_platform_returns_the_engine_block():
    """A PlayF that returns the engine's device block: the output context
    copies it into the callback buffer (float64 on the host), and the
    result equals the JAX wiring that fills the buffer in place."""
    def engine(mod, **kw):
        e = mod.AudioEngine(SR, 2, **kw)
        e.register_compute(lambda t, n: np.full((n, 2), 0.25) + np.arange(t, t + n)[:, None] * 1e-5)
        return e

    te, je = engine(teng, device="cpu"), engine(jeng)
    tctx, jctx = tplat.OutputContext(), jplat.OutputContext()
    tctx.do_init(0.005, SR, 2, lambda out, t: te.step(out.shape[0]))
    jctx.do_init(0.005, SR, 2, lambda out, t: out.__setitem__(slice(None), je.step(out.shape[0])))
    got, want = tctx.render(1000), jctx.render(1000)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    i16 = tplat.Int16OutputContext()
    i16.do_init(0.01, SR, 2, lambda out, t: torch.full((out.shape[0], 2), 0.5))
    assert (i16.pull_int16(64) == 16383).all()


def test_ring_buffer_matches_jax():
    rng = np.random.default_rng(6)
    t, j = tnative.RingBuffer(100), jnative.RingBuffer(100)
    assert t.capacity == j.capacity
    for n_push, n_pop in rng.integers(0, 90, (40, 2)):
        d = rng.standard_normal(int(n_push)).astype(np.float32)
        assert t.push(d) == j.push(d)
        np.testing.assert_array_equal(t.pop(int(n_pop)), j.pop(int(n_pop)))
        assert (t.size, t.dropped) == (j.size, j.dropped)


@pytest.mark.parametrize("kind", list(jinterp.Itp), ids=lambda k: k.name)
def test_interpolate_matches_jax(kind):
    import jax.numpy as jnp

    t = np.linspace(-10.0, 130.0, 257)
    want = np.asarray(jinterp.interpolate(kind, jnp.asarray(t), 3.0, 5.0, 100.0))
    got = tinterp.interpolate(tinterp.Itp(int(kind)), torch.from_numpy(t), 3.0, 5.0,
                              100.0, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    for tt in (0, 37, 100.0):  # host scalars: float64 as JAX's x64 promotion
        w = float(jinterp.interpolate(kind, tt, 2.0, 10.0, 100.0))
        g = tinterp.interpolate(tinterp.Itp(int(kind)), tt, 2.0, 10.0, 100.0, device="cpu")
        assert g.dtype == torch.float64 and float(g) == pytest.approx(w, abs=1e-12)


def test_render_to_wav_matches_jax(tmp_path):
    def schedule(ev, vmod):
        notes = [ev.Note(1, 100, 15000, 440.0, 0.9, -0.3), ev.Note(2, 3000, 20000, 587.3, 0.6, 0.4)]
        return vmod.schedule_from_notes(notes, pad_to=8)

    from cpp_audio_tpu.core import voices as jvoices

    jcfg = jsine.SineSynthConfig(sample_rate=SR, block_size=8192)
    tcfg = tsine.SineSynthConfig(sample_rate=SR, block_size=8192)
    want = jsine.render_to_wav(schedule(jev, jvoices), 22050, jcfg, tmp_path / "j.wav")
    got = tsine.render_to_wav(schedule(tev, tvoices), 22050, tcfg, tmp_path / "t.wav",
                              device="cpu")
    assert torch.is_tensor(got) and got.shape == (22050, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_BAR)
    back, sr = wavio.read_wav(tmp_path / "t.wav")
    jback, _ = wavio.read_wav(tmp_path / "j.wav")
    assert sr == SR
    np.testing.assert_allclose(back, got.numpy(), atol=1e-6)
    np.testing.assert_allclose(back, jback, atol=F32_BAR)
