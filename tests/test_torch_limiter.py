"""The port's ops/limiter.py against the JAX package's, on the CPU.

Tolerances: float64 inputs (tests/conftest.py turns x64 on for JAX) at
rtol 1e-12 of the signal's peak, the JAX package's own associative-scan and
closed-form followers agreeing to float64 rounding; float32 at 1e-6, the
bar of tests/test_offline_job.py::test_peak_follower_matches_loop.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.ops import limiter as jlim
from cpp_audio_tpu_torch.ops import limiter as tlim
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

F64_BAR = 1e-12


def _loop_follower(x, r, p0=0.0):
    out, prev = np.empty_like(x), p0
    for i, v in enumerate(x):
        prev = max(v, r * prev)
        out[i] = prev
    return out


def _ramp_noise(n, channels=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if channels is None else (n, channels)
    env = np.linspace(0.0, 3.0, n)
    return rng.standard_normal(shape) * (env if channels is None else env[:, None])


@pytest.mark.parametrize("release", [0.99, 0.9999, 0.5])
def test_peak_follower_matches_loop_and_jax(release):
    x = np.abs(_ramp_noise(20000, seed=1))
    x[12000:] = 0.0  # a long silence: the follower decays geometrically
    ref = _loop_follower(x, release)
    got = tlim.peak_follower(x, release, device="cpu").numpy()
    jax = np.asarray(jlim.peak_follower(x, release))
    # atol: the geometric decay through the silence ends in subnormals
    np.testing.assert_allclose(got, ref, rtol=F64_BAR, atol=1e-300)
    np.testing.assert_allclose(got, jax, rtol=F64_BAR, atol=1e-300)


def test_peak_follower_float32_and_axis():
    x = np.abs(_ramp_noise(3000, channels=3, seed=2)).astype(np.float32)
    got = tlim.peak_follower(x, 0.995, axis=0, device="cpu")
    assert got.dtype == torch.float32
    ref = np.stack([_loop_follower(x[:, c].astype(np.float64), 0.995)
                    for c in range(3)], axis=1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("channels", [None, 2])
def test_limit_matches_jax(channels):
    x = _ramp_noise(60000, channels=channels, seed=3)
    got = tlim.limit(x, device="cpu").numpy()
    jax = np.asarray(jlim.limit(x))
    np.testing.assert_allclose(got, jax, rtol=0, atol=F64_BAR * np.abs(x).max())
    assert np.abs(got).max() <= 1.0 + 1e-12


@pytest.mark.parametrize("axis", [1, -2])
def test_limit_axis_matches_jax(axis):
    """limit(x.T, axis=) on a 3-D input, time on axis 1 of x.T, as JAX's:
    every element followed on its own along the time axis."""
    y = np.stack([_ramp_noise(6000, channels=3, seed=4),
                  0.5 * _ramp_noise(6000, channels=3, seed=6)])  # (2, 6000, 3)
    x = y.T
    got = tlim.limit(x, axis=axis, device="cpu").numpy()
    jax = np.asarray(jlim.limit(x, axis=axis))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, jax, rtol=0, atol=F64_BAR * np.abs(x).max())
    assert np.abs(got).max() <= 1.0 + 1e-12


def test_limit_axis_of_a_2d_input_is_its_frames():
    """limit(x.T, axis=1) has the (frames,) peak to follow: JAX and the port
    refuse it alike; axis 0 and -1 are the default's result."""
    x = _ramp_noise(3000, channels=2, seed=5)
    with pytest.raises(ValueError):
        jlim.limit(x, axis=1)
    with pytest.raises(ValueError):
        tlim.limit(x, axis=1, device="cpu")
    for axis in (0, -1):
        np.testing.assert_array_equal(tlim.limit(x, axis=axis, device="cpu").numpy(),
                                      tlim.limit(x, device="cpu").numpy())


def test_limit_passthrough_and_ceiling():
    x = 0.5 * np.sin(np.linspace(0, 50, 4000))
    np.testing.assert_allclose(tlim.limit(x[:, None], device="cpu").numpy()[:, 0], x,
                               atol=1e-7)
    y = 3.0 * np.sin(2 * np.pi * 100 * np.arange(8000) / 44100)
    out = tlim.limit(y[:, None], ceiling=0.8, device="cpu").numpy()
    ref = np.asarray(jlim.limit(y[:, None], ceiling=0.8))
    assert 0.7 < np.abs(out).max() <= 0.8 + 1e-9
    np.testing.assert_allclose(out, ref, atol=F64_BAR * 3.0)


def test_clamp_and_guard_matches_jax():
    x = np.array([0.5, 2.0, -3.0, np.nan, np.inf, -np.inf, -0.25])
    got = tlim.clamp_and_guard(x, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jlim.clamp_and_guard(x)))
    np.testing.assert_array_equal(tlim.clamp_and_guard(x, 0.3, device="cpu").numpy(),
                                  np.asarray(jlim.clamp_and_guard(x, 0.3)))


@pytest.mark.parametrize("block", [1, 511, 3000, 20000])
def test_streamed_blocks_equal_limit_over_the_whole(block):
    """Consecutive blocks with the carried follower state reproduce `limit`
    over their concatenation (and JAX's numpy streaming limiter)."""
    x = _ramp_noise(25000, channels=2, seed=4)
    whole = tlim.limit(x, device="cpu").numpy()
    parts, p = [], 0.0
    jparts, jp = [], 0.0
    for s in range(0, len(x), block):
        y, p = tlim.limit_streaming(x[s:s + block], p, device="cpu")
        assert torch.is_tensor(p) and p.dim() == 0
        parts.append(y.numpy())
        if block >= 511:
            jy, jp = jlim.limit_streaming(x[s:s + block], jp)
            jparts.append(jy)
    streamed = np.concatenate(parts)
    np.testing.assert_allclose(streamed, whole, rtol=0, atol=F64_BAR * 3.0)
    if jparts:
        np.testing.assert_allclose(streamed, np.concatenate(jparts), rtol=0,
                                   atol=F64_BAR * 3.0)
    _y, p_whole = tlim.limit_streaming(x, device="cpu")
    assert float(p) == pytest.approx(float(p_whole), rel=F64_BAR)


def test_limit_streaming_empty_block_keeps_state():
    y, p = tlim.limit_streaming(np.zeros((0, 2)), 0.7, device="cpu")
    assert y.shape == (0, 2) and float(p) == 0.7
    jy, jp = jlim.limit_streaming(np.zeros((0, 2)), 0.7)
    assert jy.shape == (0, 2) and jp == 0.7


def test_limiter_keeps_the_input_dtype_and_device():
    """float32 in, float32 out, on the input tensor's own device. Held
    against JAX's limit of the same samples at float64 (1e-6): JAX's own
    float32 associative scan sits ~1e-5 from it on this ramp, the port's
    chunked closed form ~1e-7."""
    x = torch.linspace(-3, 3, 1000, dtype=torch.float32)
    y = tlim.limit(x, device="cuda")  # a tensor stays on its own device
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    ref = np.asarray(jlim.limit(x.numpy().astype(np.float64)))
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-6)
