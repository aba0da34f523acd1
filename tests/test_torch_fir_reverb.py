"""The port's offline DSP ops (ops/fir.py, resample.py, reverb.py,
crossfade.py) and the grey noise table against the JAX package's, on the CPU.

Bars: float64 at 1e-10 absolute, float32 at 1e-5 of the reference's peak
(FFT convolutions over up to 2^17 points and 64-tap sinc sums rounded by
torch and XLA in their own orders); host copies (FIR designs, channel
conversion, crossfade weights, noise tables) exact or at 1e-12.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.ops import crossfade as jxf
from cpp_audio_tpu.ops import fir as jfir
from cpp_audio_tpu.ops import noise as jnoise
from cpp_audio_tpu.ops import resample as jrs
from cpp_audio_tpu.ops import reverb as jrv
from cpp_audio_tpu.utils import wav as jwav
from cpp_audio_tpu_torch.ops import crossfade as txf
from cpp_audio_tpu_torch.ops import fir as tfir
from cpp_audio_tpu_torch.ops import noise as tnoise
from cpp_audio_tpu_torch.ops import resample as trs
from cpp_audio_tpu_torch.ops import reverb as trv
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100


def _hold(got, ref, dtype):
    """float64 at 1e-10 absolute; float32 at 1e-5 of the reference's peak."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))


def test_get_noise_tables_match_jax():
    """get_noise_tables needs the equal-loudness FIR of ops/fir.py (the grey
    table); every table and abs-mean equals JAX's within 1e-12."""
    got = tnoise.get_noise_tables(SR)
    ref = jnoise.get_noise_tables(SR)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].shape == v.shape
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12)
        else:
            assert got[k] == pytest.approx(v, abs=1e-12)


def test_fir_designs_are_jax_copies():
    np.testing.assert_array_equal(tfir.loudness_fir_coefficients(SR, 4096, 1023),
                                  jfir.loudness_fir_coefficients(SR, 4096, 1023))
    np.testing.assert_array_equal(tfir.loudness_fir_firls(SR, 451),
                                  jfir.loudness_fir_firls(SR, 451))
    np.testing.assert_array_equal(tfir.firls(101, [0.0, 0.5, 1.0], [1.0, 0.3, 0.0]),
                                  jfir.firls(101, [0.0, 0.5, 1.0], [1.0, 0.3, 0.0]))
    assert tfir.fir_latency(1023) == jfir.fir_latency(1023) == 511


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("shape", [(5000,), (2, 3001)])
def test_fft_convolve_matches_jax(dtype, trim, shape):
    rng = np.random.default_rng(len(shape) + 3 * trim)
    x = rng.standard_normal(shape).astype(dtype)
    h = jfir.loudness_fir_coefficients(SR, 2048, 511).astype(dtype)
    got = tfir.fft_convolve(x, h, trim_latency=trim, device="cpu")
    _hold(got, jfir.fft_convolve(x, h, trim_latency=trim), dtype)


def test_fft_convolve_latency_trim():
    """tests/test_harmonics.py's delay check: a length-9 pure delay of 4
    trimmed by its latency is the identity."""
    x = np.zeros(64)
    x[10] = 1.0
    h = np.zeros(9)
    h[4] = 1.0
    y = tfir.fft_convolve(torch.as_tensor(x), h, trim_latency=True, device="cpu")
    np.testing.assert_allclose(y.numpy(), x, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rates", [(48000, 44100), (22050, 44100)])
@pytest.mark.parametrize("channels", [None, 2])
def test_resample_sinc_matches_jax(dtype, rates, channels):
    rng = np.random.default_rng(rates[0] + (channels or 0))
    n = 3000
    x = rng.standard_normal(n if channels is None else (n, channels)).astype(dtype)
    got = trs.resample_sinc(x, *rates, device="cpu")
    _hold(got, jrs.resample_sinc(x, *rates), dtype)


def test_resample_sinc_chunks_and_identity(monkeypatch):
    """Output chunks (a small _CHUNK_BYTES) give the unchunked result; equal
    rates return the input."""
    x = np.random.default_rng(9).standard_normal((2000, 2))
    whole = trs.resample_sinc(x, 48000, 44100, device="cpu")
    monkeypatch.setattr(trs, "_CHUNK_BYTES", 64 * 2 * 8 * 100)
    np.testing.assert_array_equal(trs.resample_sinc(x, 48000, 44100, device="cpu").numpy(),
                                  whole.numpy())
    np.testing.assert_array_equal(trs.resample_sinc(x, SR, SR, device="cpu").numpy(), x)


@pytest.mark.parametrize("ir_channels", [1, 2, 4])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_apply_reverb_matches_jax(ir_channels, dtype):
    rng = np.random.default_rng(ir_channels)
    sig = rng.standard_normal((6000, 2)).astype(dtype)
    decay = np.exp(-np.arange(900) / 200.0)[:, None]
    ir = rng.standard_normal((900, ir_channels)) * decay
    for wet, dry in ((1.0, None), (0.4, None), (0.7, 0.5)):
        got = trv.apply_reverb(sig, trv.Reverb(ir=ir, wet=wet), dry=dry, device="cpu")
        ref = jrv.apply_reverb(sig, jrv.Reverb(ir=ir, wet=wet), dry=dry)
        _hold(got, ref, dtype)


def test_apply_reverb_mono_signal():
    sig = np.random.default_rng(4).standard_normal(3000)
    ir = np.random.default_rng(5).standard_normal((300, 2))
    got = trv.apply_reverb(sig, trv.Reverb(ir=ir, wet=0.6), device="cpu")
    _hold(got, jrv.apply_reverb(sig, jrv.Reverb(ir=ir, wet=0.6)), np.float64)


@pytest.mark.parametrize("have,want", [(1, 2), (2, 2), (4, 2), (3, 1), (2, 5)])
def test_convert_channels_is_a_jax_copy(have, want):
    ir = np.random.default_rng(have).standard_normal((50, have))
    np.testing.assert_array_equal(trv.convert_channels(ir, want),
                                  jrv.convert_channels(ir, want))


@pytest.mark.parametrize("ir_channels", [1, 4])
def test_load_impulse_response_matches_jax(tmp_path, ir_channels):
    """A 48 kHz IR WAV loaded at 44.1 kHz on two channels, truncated."""
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal((4800, ir_channels))
          * np.exp(-np.arange(4800) / 900.0)[:, None])
    p = tmp_path / "ir.wav"
    jwav.write_wav(p, ir, 48000, bits=64)
    got = trv.load_impulse_response(p, SR, 2, max_seconds=0.08, device="cpu")
    ref = jrv.load_impulse_response(p, SR, 2, max_seconds=0.08)
    assert isinstance(got.ir, np.ndarray) and got.channels() == ref.channels() == 2
    _hold(got.ir, ref.ir, np.float64)


@pytest.mark.parametrize("shape", ["sinusoidal", "linear"])
@pytest.mark.parametrize("inclusive", [False, True])
def test_xfade_weights_are_jax_copies(shape, inclusive):
    for a, b in zip(txf.xfade_weights(33, shape, inclusive=inclusive),
                    jxf.xfade_weights(33, shape, inclusive=inclusive)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("shape", ["sinusoidal", "linear"])
def test_crossfade_and_splice_match_jax(dtype, stereo, shape):
    rng = np.random.default_rng(int(stereo))
    dims = (700, 2) if stereo else (700,)
    a = rng.standard_normal(dims).astype(dtype)
    b = rng.standard_normal((500,) + dims[1:]).astype(dtype)
    for n in (None, 64):
        _hold(txf.crossfade(a, b, n, shape, device="cpu"), jxf.crossfade(a, b, n, shape), dtype)
    for n_x in (101, 5000):
        _hold(txf.splice(a, b, n_x, shape, device="cpu"), jxf.splice(a, b, n_x, shape), dtype)
