"""The port's ops/filters.py and filter-bank vocoder against the JAX
package's, on the CPU.

Tolerances: float64 scans at 1e-13 (both packages run the literal
recurrence; only the association at chunk boundaries differs); float32 at
1e-6 absolute on O(1) signals (a few ulps of float32 accumulated over the
scan); the FFT cascade at 1e-4 (float32 FFT convolution over 4096 points,
rounded differently by torch and XLA: the vocoded leg's FFT bar); the
float32 log-space impulse response against float64 at rtol 2e-4, where
JAX's own sits at up to 4.6e-4. The filter-bank vocoder at 1 s is held to
the bars of tests/test_vocoder_filterbank.py and to JAX's output at atol
1e-4 (the vocoded leg's bar, tests/test_chain.py); its band envelopes' float32
scan drift (alpha ~7e-4 in band 0) is held against a float64 evaluation
within 2e-5. vocode(debug_dir=) writes JAX's file names with the same
contents to 1e-6.
"""

import math

import numpy as np
import pytest
import torch

from cpp_audio_tpu.analysis import vocoder as jvoc
from cpp_audio_tpu.ops import filters as jflt
from cpp_audio_tpu.utils import wav as jwav
from cpp_audio_tpu_torch.analysis import vocoder as tvoc
from cpp_audio_tpu_torch.ops import filters as tflt
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100


def _ab(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def _bar(dtype):
    return 1e-13 if dtype == np.float64 else 1e-6


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("length", [1, 37, 5000])
def test_linear_recurrence_matches_jax(dtype, length):
    a, b = _ab((3, length), dtype, seed=length)
    y0 = np.array([0.3, -1.0, 2.0], dtype)
    got = tflt.linear_recurrence(a, b, y0, device="cpu")
    assert got.dtype == torch.from_numpy(b).dtype and got.shape == b.shape
    ref = np.asarray(jflt.linear_recurrence(a, b, y0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_bar(dtype) * 10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis,chunk", [(-1, 64), (0, 64), (1, 7)])
def test_chunked_affine_scan_matches_jax(dtype, axis, chunk):
    a, b = _ab((2, 4100) if axis != 0 else (4100, 2), dtype, seed=chunk)
    if axis == 1:
        a, b = a[None], b[None]
    got = tflt.chunked_affine_scan(a, b, 0.5, axis=axis, chunk=chunk, device="cpu")
    ref = np.asarray(jflt.chunked_affine_scan(a, b, 0.5, axis=axis, chunk=chunk))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_bar(dtype))


def test_alpha_and_band_gain_match_jax():
    inc = np.array([0.001, -0.02, 0.5, 1.0])
    np.testing.assert_allclose(tflt.alpha_from_angle_increment(inc, device="cpu").numpy(),
                               np.asarray(jflt.alpha_from_angle_increment(inc)),
                               rtol=1e-15)
    w = np.array([0.25, 1.0, 3.0])
    for order in (1, 4):
        np.testing.assert_allclose(tflt.band_gain_compensation(w, order, device="cpu").numpy(),
                                   np.asarray(jflt.band_gain_compensation(w, order)),
                                   rtol=1e-14)


@pytest.mark.parametrize("kind", ["lowpass", "highpass"])
@pytest.mark.parametrize("order", [1, 3])
def test_onepole_and_cascade_match_jax(kind, order):
    rng = np.random.default_rng(order)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    alpha = np.array([[0.05], [0.3]], np.float32)
    got = tflt.cascade(x, alpha, order, kind=kind, device="cpu").numpy()
    ref = np.asarray(jflt.cascade(x, alpha, order, kind=kind))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    one = tflt.onepole_lowpass if kind == "lowpass" else tflt.onepole_highpass
    jone = jflt.onepole_lowpass if kind == "lowpass" else jflt.onepole_highpass
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(one(x64, 0.1, 0.25, device="cpu").numpy(),
                               np.asarray(jone(x64, 0.1, 0.25)), rtol=0, atol=1e-13)


@pytest.mark.parametrize("kind", ["lowpass", "highpass"])
@pytest.mark.parametrize("order", [1, 4])
def test_cascade_fft_matches_jax(kind, order):
    x = np.random.default_rng(5).standard_normal((2, 2000)).astype(np.float32)
    got = tflt.cascade_fft(x, 0.05, order, kind=kind, device="cpu").numpy()
    ref = np.asarray(jflt.cascade_fft(x, 0.05, order, kind=kind))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # the FFT path equals the recurrence (the JAX docstring's claim)
    np.testing.assert_allclose(got, tflt.cascade(x, 0.05, order, kind=kind,
                                                 device="cpu").numpy(), atol=1e-4)


def test_cascade_impulse_response_matches_jax():
    """Both packages evaluate h[n] in float32 log space (lgamma of values
    up to ~400), whose rounding exp() turns into relative error: held
    against the same formula in float64, and against JAX at rtol 1e-3."""
    lgamma = np.frompyfunc(math.lgamma, 1, 1)
    n = np.arange(400.0)
    for alpha, order in ((0.1, 1), (0.02, 5), (0.5, 12)):
        got = tflt.cascade_impulse_response(alpha, order, 400, device="cpu")
        assert got.dtype == torch.float32
        exact = np.exp(order * np.log(alpha) + (lgamma(n + order) - lgamma(n + 1.0)
                                                - math.lgamma(order)).astype(np.float64)
                       + n * np.log1p(-alpha))
        np.testing.assert_allclose(got.numpy(), exact, rtol=2e-4, atol=1e-30)
        ref = np.asarray(jflt.cascade_impulse_response(alpha, order, 400))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-30)


def _signals(n, sr, mod_freq=330.0, trem=3.0):
    t = np.arange(n) / sr
    mod = np.sin(2 * np.pi * mod_freq * t) * (0.5 + 0.5 * np.sin(2 * np.pi * trem * t))
    car = np.sign(np.sin(2 * np.pi * 110.0 * t))
    return mod, car


@pytest.fixture(scope="module")
def filter_bank_pair():
    mod, car = _signals(SR, SR)
    got = tvoc.vocode_filter_bank(mod, car, tvoc.VocoderParams(sample_rate=SR),
                                  device_out=True, device="cpu")
    ref = jvoc.vocode_filter_bank(mod, car, jvoc.VocoderParams(sample_rate=SR))
    return mod, car, got, ref


def test_filter_bank_vocoder_matches_jax(filter_bank_pair):
    mod, car, got, ref = filter_bank_pair
    assert got.dtype == torch.float32 and got.shape == (SR,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # tests/test_vocoder_filterbank.py::test_env_follower_tracks_band_energy
    assert np.abs(got.numpy()).max() > 1e-3
    p = tvoc.VocoderParams(sample_rate=SR, count_bands=4)
    silent = tvoc.vocode_filter_bank(np.zeros(SR), car, p, device_out=True,
                                     device="cpu")
    assert float(silent.abs().max()) < 1e-6


def test_filter_bank_envelope_drift_against_float64():
    """The band envelopes' float32 scans against the same cascade at
    float64: the port stays within 2e-5 in every band (JAX's associative
    scan: ~1e-5 in band 0, the env follower's alpha ~7e-4)."""
    mod, _ = _signals(SR, SR)
    edges = tvoc.VocoderParams(sample_rate=SR).band_freqs()

    def env(dt):
        f_lo = np.asarray(edges[:-1], dt)[:, None]
        f_hi = np.asarray(edges[1:], dt)[:, None]
        al = [tflt.alpha_from_angle_increment(2.0 * f / SR, device="cpu")
              for f in (f_lo, f_hi, f_lo * dt(1 / 20))]
        x = torch.as_tensor(mod.astype(dt))[None].expand(len(f_lo), SR)
        y = tflt.cascade(tflt.cascade(x, al[0], 1, kind="highpass"), al[1], 1)
        return tflt.cascade(y.abs(), al[2], 1).double().numpy()

    drift = np.abs(env(np.float32) - env(np.float64)).max(axis=1)
    assert drift.max() < 2e-5, drift


def test_filter_bank_cutoff_ratio_and_volume_mix():
    """tests/test_vocoder_filterbank.py: a slower follower smears the
    tremolo depth; with volume_vocoded 0 the output is the direct mix."""
    n = SR
    mod, car = _signals(n, SR, trem=8.0)

    def depth(ratio):
        out = tvoc.vocode_filter_bank(
            mod, car, tvoc.VocoderParams(sample_rate=SR, env_follower_cutoff_ratio=ratio),
            device_out=True, device="cpu").numpy()
        b = SR // 20
        rms = np.array([np.sqrt((out[i:i + b] ** 2).mean())
                        for i in range(0, n - b, b)])[2:]
        return (rms.max() - rms.min()) / max(rms.max(), 1e-12)

    assert depth(1.0 / 4.0) > depth(1.0 / 400.0) + 0.1
    mod, car = _signals(8192, SR)
    p = tvoc.VocoderParams(sample_rate=SR, volume_vocoded=0.0, volume_modulator=0.5,
                           volume_carrier=0.25)
    np.testing.assert_allclose(tvoc.vocode_filter_bank(mod, car, p, device_out=True,
                                                       device="cpu").numpy(),
                               0.5 * mod + 0.25 * car, atol=1e-5)


def test_filter_bank_contrast_with_fft_mode(filter_bank_pair):
    """tests/test_vocoder_filterbank.py::test_contrast_with_fft_mode on the
    port: both modes carry the tremolo, but differ."""
    mod, car, got, _ref = filter_bank_pair
    out_fft = tvoc.vocode(mod, car, tvoc.VocoderParams(sample_rate=SR), device_out=True,
                          device="cpu").numpy()
    out_fb = got.numpy()
    m = min(len(out_fft), len(out_fb))
    b = SR // 20
    env_f = np.array([np.abs(out_fft[i:i + b]).mean() for i in range(0, m - b, b)])
    env_b = np.array([np.abs(out_fb[i:i + b]).mean() for i in range(0, m - b, b)])
    assert np.corrcoef(env_f[2:], env_b[2:])[0, 1] > 0.7
    assert np.abs(out_fft[:m] - out_fb[:m]).max() > 1e-3


@pytest.mark.parametrize("mode", ["fft", "filterbank"])
def test_debug_dir_taps_match_jax(tmp_path, mode):
    """vocode(debug_dir=) and vocode_filter_bank(debug_dir=) write the JAX
    package's files. vocode's taps hold the same contents to 1e-6; the
    filter bank's band envelopes carry the scan drift above (1e-4)."""
    mod, car = _signals(SR // 2, SR)
    jd, td = tmp_path / "jax", tmp_path / "port"
    if mode == "fft":
        jvoc.vocode(mod, car, jvoc.VocoderParams(sample_rate=SR), debug_dir=jd)
        tvoc.vocode(mod, car, tvoc.VocoderParams(sample_rate=SR), debug_dir=td,
                    device="cpu")
        bar = 1e-6
    else:
        jvoc.vocode_filter_bank(mod, car, jvoc.VocoderParams(sample_rate=SR), debug_dir=jd)
        tvoc.vocode_filter_bank(mod, car, tvoc.VocoderParams(sample_rate=SR),
                                debug_dir=td, device="cpu")
        bar = 1e-4
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    assert "vocoded.wav" in names and "band_0.wav" in names
    for name in names:
        a, sra = jwav.read_wav(jd / name)
        b, srb = jwav.read_wav(td / name)
        assert sra == srb == SR and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=bar, err_msg=name)


@pytest.mark.parametrize("device_out", [False, True])
def test_filter_bank_device_out_matches_jax(filter_bank_pair, device_out):
    """vocode_filter_bank's device_out as JAX's: numpy by default, the tensor
    on the requested device with True; at the filter bank's bar."""
    mod, car, _got, ref = filter_bank_pair
    kw = {"device_out": True} if device_out else {}
    out = tvoc.vocode_filter_bank(mod, car, tvoc.VocoderParams(sample_rate=SR),
                                  device="cpu", **kw)
    if device_out:
        assert torch.is_tensor(out) and out.device == torch.device("cpu")
        out = out.numpy()
    else:
        assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    empty = tvoc.vocode_filter_bank(mod[:0], car[:0], tvoc.VocoderParams(sample_rate=SR),
                                    device="cpu", **kw)
    assert torch.is_tensor(empty) == device_out and empty.shape == (0,)
