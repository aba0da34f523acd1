"""The port's WIND renderer (models/wind.py) and its control walks against
the JAX package's, on the CPU.

Bars: the host walks and their segment tables give exactly JAX's values,
and the tables built on the device exactly the host's; the device
expansion of the walks equals the host walk bit for bit
(tests/test_wind_noise.py:146's cases, itp 0 and 8); the
host-walk render in float64 within 1e-9 of the peak for every
lowpass_mode, and in float32 within 1e-5 RMS-relative
(tests/test_wind_noise.py:154). With device_controls the mix is held in
float64 at 1e-9 on the controls the port expands (fed to JAX's host-walk
render); the whole device-controls render differs from JAX's by the
float32 exp of the frequency map (XLA's float32 exp and the port's, a
float64 exp rounded to float32, differ by one ulp at ~10% of samples,
ROADMAP §C), so it is held at JAX's own bar between the two control
paths, 1e-5 RMS-relative. Batches against the
port's single renders at JAX's 1e-5 of the peak. The JAX package's own
WIND and batch tests also run against the port (device="cpu").
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_batched_serving as jt_batch
import test_wind_noise as jt_wind
from cpp_audio_tpu.models import voice_presets as jvp
from cpp_audio_tpu.models import wind as jwind
from cpp_audio_tpu_torch.models import voice_presets as tvp
from cpp_audio_tpu_torch.models import wind as twind
from cpp_audio_tpu_torch.ops.noise import get_noise_tables
from test_torch_engine_core import OnCPU, on_port

SR = 44100
N = 8192
F64_BAR = 1e-9
RMS_BAR = 1e-5


def _programs(name, **changes):
    jp = jvp.get_program(jvp.Mode.WIND, name)
    tp = tvp.get_program(tvp.Mode.WIND, name)
    return dataclasses.replace(jp, **changes), dataclasses.replace(tp, **changes)


def _rms_rel(got, want):
    return float(np.sqrt(((got - want) ** 2).mean()) / max(np.sqrt((want ** 2).mean()), 1e-12))


@pytest.fixture(scope="module")
def pink():
    return np.asarray(get_noise_tables(SR)["pink"], np.float32)


# ---- the JAX package's own tests, against the port -------------------------

class TestPortWind(jt_wind.TestWind):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_wind, wind=OnCPU(twind), vp=tvp)


class TestPortWindBatch(jt_batch.TestWindBatch):
    @pytest.fixture(autouse=True)
    def _port(self, monkeypatch):
        on_port(monkeypatch, jt_batch, wind_mod=OnCPU(twind), voice_presets=tvp)


# ---- control walks ------------------------------------------------------------

@pytest.mark.parametrize("n_steps,itp,prev0", [(12, 0, None), (997, 8, 0.37), (4000, 5, 0.9)])
def test_long_walks_match_jax(pink, n_steps, itp, prev0):
    T = 30000
    want = jwind.wind_long_walk(pink, 1234, n_steps, itp, T, prev0=prev0)
    np.testing.assert_array_equal(twind.wind_long_walk(pink, 1234, n_steps, itp, T, prev0=prev0),
                                  want)
    np.testing.assert_array_equal(twind._long_walk_np(pink, 1234, n_steps, itp, T, prev0),
                                  jwind._long_walk_np(pink, 1234, n_steps, itp, T, prev0))
    for a, b in zip(twind.wind_long_walk_segments(pink, 1234, n_steps, T, prev0=prev0),
                    jwind.wind_long_walk_segments(pink, 1234, n_steps, T, prev0=prev0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prev0", [None, -0.2])
def test_short_walks_match_jax(pink, prev0):
    inc_long = np.exp(np.linspace(np.log(1e-3), np.log(0.08), 6000)).astype(np.float32)
    want = jwind.wind_short_walk(pink, 77, 44100.0 * 0.003, inc_long, prev0=prev0)
    np.testing.assert_array_equal(
        twind.wind_short_walk(pink, 77, 44100.0 * 0.003, inc_long, prev0=prev0), want)
    np.testing.assert_array_equal(
        twind._short_walk_np(pink, 77, 44100.0 * 0.003, inc_long[:500], prev0),
        jwind._short_walk_np(pink, 77, 44100.0 * 0.003, inc_long[:500], prev0))


@pytest.mark.parametrize("n_steps,T", [(12, 60000), (997, 60000), (1, 5000)])
def test_device_segments_match_the_host_tables(pink, n_steps, T):
    """_walk_segments_dev (the tables built on the device, W walks at once)
    holds exactly wind_long_walk_segments' rows, then rows past T."""
    walks = [(1234, 0.37), (99, 0.1), (len(pink) - 3, 0.9)]
    pos0 = torch.tensor([b % len(pink) for b, _ in walks])
    prev0 = torch.tensor([np.float32(v) for _, v in walks], dtype=torch.float32)
    dev = twind._walk_segments_dev(torch.from_numpy(np.abs(pink)), pos0, prev0,
                                   n_steps=n_steps, T=T)
    for w, (b, v) in enumerate(walks):
        host = twind.wind_long_walk_segments(pink, b, n_steps, T, prev0=v)
        n = len(host[0])
        assert (dev[0][w, n:] >= T).all()
        for got, want in zip(dev, host):
            np.testing.assert_array_equal(got[w, :n].numpy(), want)


@pytest.mark.parametrize("n_steps,itp,T", [(12, 0, 60000), (997, 8, 60000)])
def test_walk_expansion_matches_host_exactly(pink, n_steps, itp, T):
    """tests/test_wind_noise.py:133-146 on the port: the device expansion of
    the host's segment tables equals the host walk bit for bit, and so do
    the rows of a batch whose tables are built on the device."""
    host = twind.wind_long_walk(pink, 1234, n_steps, itp, T, prev0=0.37)
    seg = twind.wind_long_walk_segments(pink, 1234, n_steps, T, prev0=0.37)
    dev = twind._expand_long_walk_dev(*(torch.from_numpy(s) for s in seg), n_steps=n_steps,
                                      itp_code=itp, T=T)
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), host)
    pink_abs = torch.from_numpy(np.abs(pink))
    both = twind._expand_long_walk_dev(
        *twind._walk_segments_dev(pink_abs, torch.tensor([1234, 99]),
                                  torch.tensor([0.37, 0.1], dtype=torch.float32),
                                  n_steps=n_steps, T=T),
        n_steps=n_steps, itp_code=itp, T=T)
    np.testing.assert_array_equal(both[0].numpy(), host)
    np.testing.assert_array_equal(
        both[1].numpy(), twind.wind_long_walk(pink, 99, n_steps, itp, T, prev0=0.1))


# ---- renders ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Heavy rain", "Steady wind", "Sine wind", "Bubbles"])
def test_render_host_walks_float64_matches_jax(name):
    """Heavy rain (order 13), Bubbles (order 129, the deepest), Sine wind
    (a nonzero short wobble: always the host walks)."""
    jp, tp = _programs(name)
    want = np.asarray(jwind.render_program(jp, N, SR, seed=5, dtype="float64"))
    got = twind.render_program(tp, N, SR, seed=5, dtype="float64", device="cpu")
    assert torch.is_tensor(got) and got.dtype == torch.float64 and got.shape == (N, 2)
    peak = np.abs(want).max()
    assert peak > 1e-5
    assert np.abs(got.numpy() - want).max() <= F64_BAR * peak


@pytest.mark.parametrize("mode", ["control", "mute", "bypass"])
def test_lowpass_modes_float64_match_jax(mode):
    """Every lowpass_mode, with the LP member's gain raised so it sounds
    (tests/test_wind_noise.py's lowpass-mode case)."""
    jp, tp = _programs("Steady wind", pink_lp_gain=1.0)
    kw = dict(seed=13, pan=0.0, dtype="float64", lowpass_mode=mode)
    want = np.asarray(jwind.render_program(jp, N, SR, **kw))
    got = twind.render_program(tp, N, SR, device="cpu", **kw).numpy()
    assert np.abs(got - want).max() <= F64_BAR * np.abs(want).max()


def test_render_host_walks_float32_matches_jax():
    jp, tp = _programs("Heavy rain")
    want = np.asarray(jwind.render_program(jp, 24000, SR, seed=5))
    got = twind.render_program(tp, 24000, SR, seed=5, device="cpu")
    assert got.dtype == torch.float32
    assert _rms_rel(got.numpy(), want) <= RMS_BAR


def test_device_controls_mix_float64_matches_jax(monkeypatch):
    """The device-controls render's mix on the controls the port expanded
    on the device, against JAX's float64 render of the same controls."""
    jp, tp = _programs("Heavy rain")
    seen = {}
    mix = twind._wind_mix

    def spy(*args, **kw):
        seen["args"] = args
        return mix(*args, **kw)

    monkeypatch.setattr(twind, "_wind_mix", spy)
    got = twind.render_program(tp, N, SR, seed=5, dtype="float64", device_controls=True,
                               device="cpu").numpy()
    _pink, src_offset, inc_main, c1, c2, w1, w2, params, lut, lut_lo, lut_step, gains = seen["args"]
    import jax.numpy as jnp

    j = lambda x: jnp.asarray(x.numpy()[0] if x.dim() > 1 else x.numpy(), jnp.float64)
    want = np.asarray(jwind._render_wind(
        jwind._pink_dev(SR, "float64"), jnp.asarray(src_offset, jnp.float64),
        j(inc_main), j(c1), j(c2), j(w1), j(w2), j(params), j(lut), j(lut_lo), j(lut_step),
        j(gains), T=N, order=int(tp.filter_order), dtype="float64"))
    assert np.abs(got - want).max() <= F64_BAR * np.abs(want).max()


def test_device_controls_render_matches_jax():
    jp, tp = _programs("Heavy rain")
    want = np.asarray(jwind.render_program(jp, N, SR, seed=5, device_controls=True))
    got = twind.render_program(tp, N, SR, seed=5, device_controls=True, device="cpu")
    assert got.dtype == torch.float32
    assert _rms_rel(got.numpy(), want) <= RMS_BAR


def test_device_controls_match_host_walks():
    """tests/test_wind_noise.py:148-154 on the port."""
    tp = tvp.get_program(tvp.Mode.WIND, "Heavy rain")
    a = twind.render_program(tp, 24000, seed=5, device="cpu").numpy()
    b = twind.render_program(tp, 24000, seed=5, device_controls=True, device="cpu").numpy()
    assert _rms_rel(b, a) < RMS_BAR


def test_batch_matches_single_renders_and_jax():
    jp, tp = _programs("Heavy rain")
    seeds = [2, 7, 11]
    got = twind.render_program_batch(tp, N, SR, seeds=seeds, device="cpu")
    assert torch.is_tensor(got) and got.shape == (3, N, 2)
    got = got.numpy()
    for bi, seed in enumerate(seeds):
        single = twind.render_program(tp, N, SR, seed=seed, device_controls=True,
                                      device="cpu").numpy()
        assert np.abs(got[bi] - single).max() <= RMS_BAR * np.abs(single).max(), seed
    want = np.asarray(jwind.render_program_batch(jp, N, SR, seeds=seeds))
    assert _rms_rel(got, want) <= RMS_BAR
    host = twind.render_program_batch(tp, N, SR, seeds=seeds, device_out=False, device="cpu")
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, got)


def test_renders_are_deterministic():
    tp = tvp.get_program(tvp.Mode.WIND, "Steady wind")
    for kw in ({}, {"device_controls": True}):
        a = twind.render_program(tp, N, seed=9, device="cpu", **kw)
        b = twind.render_program(tp, N, seed=9, device="cpu", **kw)
        assert torch.equal(a, b)
    c = twind.render_program_batch(tp, N, seeds=[1, 9], device="cpu")
    assert torch.equal(c, twind.render_program_batch(tp, N, seeds=[1, 9], device="cpu"))
