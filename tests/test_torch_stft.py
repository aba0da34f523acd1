"""STFT and peak extraction port (cpp_audio_tpu_torch.ops.stft) against the
JAX package.

torch's and XLA's FFTs round differently, so the spectrum itself is held at
a float32 FFT tolerance (1e-5 of the frame's peak), and the peak selection
is held on the SAME sqmag input: the -inf pattern exactly, frequencies to
1e-3 Hz and magnitudes to 1e-4 dB (float32 log10/QIFFT rounding).
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.ops import stft
from cpp_audio_tpu_torch.ops import stft as tstft
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    sig = np.zeros(n)
    for _ in range(12):
        sig += rng.uniform(0.01, 0.3) * np.sin(2 * np.pi * rng.uniform(60, 8000) * t
                                               + rng.uniform(0, 6))
    return (sig + 1e-4 * rng.standard_normal(n)).astype(np.float32)


def test_window_and_fft_length_match():
    for w in (8, 512, 8000):
        np.testing.assert_array_equal(tstft.gaussian_window(w), stft.gaussian_window(w))
        assert tstft.fft_length_for(w) == stft.fft_length_for(w)


@pytest.mark.parametrize("window,stride", [(8000, 3969), (64, 17), (10, 10)])
def test_frame_signal_matches(window, stride):
    import jax.numpy as jnp

    x = np.arange(20000, dtype=np.float32)
    nf = (len(x) - window) // stride + 1
    ref = np.asarray(stft.frame_signal(jnp.asarray(x), window, stride, nf))
    got = tstft.frame_signal(torch.from_numpy(x), window, stride, nf).numpy()
    np.testing.assert_array_equal(got, ref)


def test_stft_sqmag_matches():
    import jax.numpy as jnp

    x = _signal(3 * SR // 2)
    win = stft.gaussian_window(8000).astype(np.float32)
    kw = dict(window_size=8000, stride=3969, fft_length=8192)
    ref = np.asarray(stft._stft_sqmag(jnp.asarray(x), jnp.asarray(win), **kw))
    got = tstft._stft_sqmag(torch.from_numpy(x), torch.from_numpy(win), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(ref.max()))


def _jax_top(sq, k, fft_length):
    import jax.numpy as jnp

    f, m = stft._top_peaks(jnp.asarray(sq), sample_rate=SR, fft_length=fft_length, k=k)
    return np.asarray(f), np.asarray(m)


def _port_top(sq, k, fft_length):
    f, m = tstft._top_peaks(torch.from_numpy(sq), sample_rate=SR,
                            fft_length=fft_length, k=k)
    return f.numpy(), m.numpy()


def _assert_same_peaks(got, ref):
    (fg, mg), (fr, mr) = got, ref
    assert fg.shape == fr.shape
    fin = np.isfinite(mr)
    np.testing.assert_array_equal(np.isfinite(mg), fin)
    np.testing.assert_allclose(fg[fin], fr[fin], atol=1e-3)
    np.testing.assert_allclose(mg[fin], mr[fin], atol=1e-4)


@pytest.mark.parametrize("k", [8, 128])
def test_top_peaks_on_identical_sqmag(k):
    import jax.numpy as jnp

    x = _signal(2 * SR, seed=1)
    win = stft.gaussian_window(8000).astype(np.float32)
    sq = np.asarray(stft._stft_sqmag(jnp.asarray(x), jnp.asarray(win),
                                     window_size=8000, stride=3969,
                                     fft_length=8192)).astype(np.float32)
    _assert_same_peaks(_port_top(sq, k, 8192), _jax_top(sq, k, 8192))


def test_top_peaks_ties_earliest_bin_wins():
    """Built by hand: 6 equal peaks with room for 3 -> the 3 lowest bins win,
    in frequency order, then -inf entries; a row with fewer peaks than k
    pads with -inf after its finite entries."""
    n_bins = 65
    sq = np.zeros((2, n_bins), np.float32)  # silent bins are never peaks
    tie_bins = [50, 10, 40, 20, 30, 60]
    for b in tie_bins:
        sq[0, b - 1] = sq[0, b + 1] = 0.25
        sq[0, b] = 1.0
    sq[1, 33] = 1.0
    sq[1, 12] = 0.5
    k = 3
    ref = _jax_top(sq, k, 128)
    got = _port_top(sq, k, 128)
    _assert_same_peaks(got, ref)
    bin_hz = SR / 128
    np.testing.assert_allclose(got[0][0], np.array([10, 20, 30]) * bin_hz, atol=1e-3)
    np.testing.assert_allclose(got[1], np.array([[0, 0, 0], [-3.0103, 0, -np.inf]]),
                               atol=1e-3)
    assert np.isfinite(got[1][1, :2]).all() and np.isneginf(got[1][1, 2])


def test_top_peaks_to_lists():
    freq = np.array([[100.0, 200.0, 0.0]])
    mag = np.array([[-3.0, -6.0, -np.inf]])
    assert tstft.top_peaks_to_lists(freq, mag) == stft.top_peaks_to_lists(freq, mag)


def test_public_helpers_match_jax():
    """stft_sqmag, extract_local_max_freqs_mags, extract_top_peaks,
    peaks_to_lists, rectangular_window and db_to_mag against JAX's, on the
    live path's shapes (one float32 window of 8000 samples, k = 128). The
    spectrum is held as in test_stft_sqmag_matches, the peaks on the same
    sqmag input as in test_top_peaks_on_identical_sqmag."""
    x = _signal(8000, seed=3)
    win = stft.gaussian_window(8000)
    ref_sq = np.asarray(stft.stft_sqmag(x, win, 3969))
    got_sq = tstft.stft_sqmag(x, win, 3969, use_matmul_dft=True, device="cpu")
    assert got_sq.dtype == torch.float32 and got_sq.shape == ref_sq.shape == (1, 4097)
    np.testing.assert_allclose(got_sq.numpy(), ref_sq, rtol=0, atol=1e-5 * float(ref_sq.max()))

    sq = ref_sq.astype(np.float32)
    ref_top = stft.extract_top_peaks(sq, SR, 8192, k=128)
    got_top = tstft.extract_top_peaks(sq, SR, 8192, k=128, device="cpu")
    _assert_same_peaks(tuple(t.numpy() for t in got_top),
                       tuple(np.asarray(t) for t in ref_top))

    ref_lm = [np.asarray(a) for a in stft.extract_local_max_freqs_mags(sq, SR, 8192,
                                                                       min_db=-90.0)]
    got_lm = [t.numpy() for t in tstft.extract_local_max_freqs_mags(
        sq, SR, 8192, min_db=-90.0, device="cpu")]
    np.testing.assert_array_equal(got_lm[0], ref_lm[0])
    np.testing.assert_allclose(got_lm[1][ref_lm[0]], ref_lm[1][ref_lm[0]], atol=1e-3)
    ref_lists = stft.peaks_to_lists(*ref_lm)
    got_lists = tstft.peaks_to_lists(*got_lm)
    assert [len(p) for p in got_lists] == [len(p) for p in ref_lists] and len(ref_lists[0]) > 5
    np.testing.assert_allclose(np.asarray(got_lists[0]), np.asarray(ref_lists[0]), atol=1e-3)

    np.testing.assert_array_equal(tstft.rectangular_window(10), stft.rectangular_window(10))
    db = np.array([-120.0, -6.0, 0.0, 3.5])
    np.testing.assert_allclose(tstft.db_to_mag(db), stft.db_to_mag(db), rtol=1e-15)
    np.testing.assert_allclose(tstft.db_to_mag(torch.from_numpy(db)).numpy(),
                               stft.db_to_mag(db), rtol=1e-15)
