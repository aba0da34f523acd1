"""Vocoder port (cpp_audio_tpu_torch.analysis.vocoder) against the JAX package.

Same float32 signals into both. Band amplitudes (decimated and full
modulator paths, both window shapes) at rtol 1e-4: both sides run float32
FFTs of the whole signal whose roundings differ (atol 1e-6 of the largest
amplitude covers bands near silence). _carrier_vocode is held at atol 2e-5
on identical band amplitudes (float32 rfft/irfft of 2S-sample frames).
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.analysis import vocoder
from cpp_audio_tpu_torch.analysis import vocoder as tvoc
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100


def _modulator(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
    sig = sum(rng.uniform(0.05, 0.3) * np.sin(2 * np.pi * f * t)
              for f in (150.0, 440.0, 1200.0, 3500.0, 9000.0))
    return (env * sig + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_params_and_band_matrix_match():
    p, tp = vocoder.VocoderParams(sample_rate=SR), tvoc.VocoderParams(sample_rate=SR)
    assert (tp.stride, tp.modulator_window) == (p.stride, p.modulator_window)
    np.testing.assert_array_equal(tp.band_freqs(), p.band_freqs())
    np.testing.assert_array_equal(tvoc._band_matrix(p.band_freqs(), 257, SR / 512),
                                  vocoder._band_matrix(p.band_freqs(), 257, SR / 512))


@pytest.mark.parametrize("mode", ["decimated", "full"])
@pytest.mark.parametrize("shape", ["gaussian", "rectangular"])
def test_band_amps_match(mode, shape):
    import jax.numpy as jnp

    n = SR
    x = _modulator(n)
    p = vocoder.VocoderParams(sample_rate=SR)
    S, W = p.stride, p.modulator_window
    nf = (n - W) // S + 1
    edges = p.band_freqs()
    ref_edges = tuple(float(e) for e in edges) if mode == "decimated" \
        else jnp.asarray(edges, jnp.float32)
    ref = np.asarray(vocoder._modulator_band_amps_fast(
        jnp.asarray(x), ref_edges, window=W, stride=S, n_frames=nf,
        sample_rate=SR, mode=mode, shape=shape))
    got = tvoc._modulator_band_amps_fast(
        torch.from_numpy(x), edges, window=W, stride=S, n_frames=nf,
        sample_rate=SR, mode=mode, shape=shape).numpy()
    assert got.shape == ref.shape == (nf, len(edges) - 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * float(ref.max()))


def test_carrier_vocode_matches_on_same_amps():
    import jax.numpy as jnp

    n = SR // 2
    p = vocoder.VocoderParams(sample_rate=SR)
    S = p.stride
    car_fft = 512
    n_car = (n - 2 * S) // S + 1
    rng = np.random.default_rng(4)
    amps = rng.uniform(0, 0.5, (n_car, 5)).astype(np.float32)
    carrier = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(n) / SR)).astype(np.float32)
    bm = vocoder._band_matrix(p.band_freqs(), car_fft // 2 + 1, SR / car_fft
                              ).astype(np.float32)
    ref = np.asarray(vocoder._carrier_vocode(jnp.asarray(carrier), jnp.asarray(amps),
                                             jnp.asarray(bm), stride=S,
                                             fft_len=car_fft))
    got = tvoc._carrier_vocode(torch.from_numpy(carrier), torch.from_numpy(amps),
                               torch.from_numpy(bm), stride=S, fft_len=car_fft).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_vocode_matches():
    n = SR
    mod = _modulator(n, seed=2)
    carrier = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(n) / SR))
    p = vocoder.VocoderParams(sample_rate=SR, volume_modulator=0.2)
    ref = vocoder.vocode(mod, carrier, p)
    got = tvoc.vocode(mod, carrier, tvoc.VocoderParams(sample_rate=SR,
                                                      volume_modulator=0.2),
                      device_out=True, device="cpu").numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_exact_modulator_band_amps_match():
    """The per-window FFT modulator (the reference's own FFTModulator form)
    on the same float32 signal, at the band-amplitude tolerance above."""
    import jax.numpy as jnp

    x = _modulator(SR // 2, seed=5)
    p = vocoder.VocoderParams(sample_rate=SR)
    S, W = p.stride, p.modulator_window
    fft_len = 8192
    bm = vocoder._band_matrix(p.band_freqs(), fft_len // 2 + 1, SR / fft_len)
    ref = np.asarray(vocoder._modulator_band_amps(
        jnp.asarray(x), jnp.asarray(bm, jnp.float32), window=W, stride=S,
        fft_len=fft_len))
    got = tvoc._modulator_band_amps(torch.from_numpy(x),
                                    torch.from_numpy(bm.astype(np.float32)),
                                    window=W, stride=S, fft_len=fft_len).numpy()
    assert got.shape == ref.shape == ((len(x) - W) // S + 1, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * float(ref.max()))


def test_vocode_exact_modulator_matches():
    n = SR
    mod = _modulator(n, seed=6)
    carrier = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(n) / SR))
    kw = dict(sample_rate=SR, volume_carrier=0.1)
    ref = np.asarray(vocoder.vocode(mod, carrier, vocoder.VocoderParams(**kw),
                                    exact_modulator=True))
    got = tvoc.vocode(mod, carrier, tvoc.VocoderParams(**kw), exact_modulator=True,
                      device_out=True, device="cpu").numpy()
    assert got.shape == ref.shape and np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("device_out", [False, True])
def test_vocode_device_out_matches_jax(device_out):
    """device_out with JAX's meaning: False (the default) makes one host copy
    (numpy), True returns the tensor on the requested device; both at
    vocode's bar against JAX."""
    n = SR // 2
    mod = _modulator(n, seed=4)
    carrier = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(n) / SR))
    ref = vocoder.vocode(mod, carrier, vocoder.VocoderParams(sample_rate=SR),
                         device_out=device_out)
    kw = {"device_out": True} if device_out else {}
    got = tvoc.vocode(mod, carrier, tvoc.VocoderParams(sample_rate=SR), device="cpu", **kw)
    if device_out:
        assert torch.is_tensor(got) and got.device == torch.device("cpu")
        got = got.numpy()
    else:
        assert isinstance(got, np.ndarray) and isinstance(ref, np.ndarray)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)
