"""The fidelity chain's peak functions (cpp_audio_tpu_torch.ops.stft
_top_bins / _top_peaks_df, ops.dfft_hybrid.hybrid_peaks_df32) against the
JAX package's, on the CPU. The port computes in float64 where JAX carries
df32 (hi, lo) pairs; JAX's pairs are compared as hi + lo.

Bars:
  - _top_bins: the same bins; mags at 1e-4 dB (float32 log10 of two libms);
  - hybrid against JAX: where the mags are >= -80 dB, off the edge bins
    (whose mags the -600 dB sentinel inflates), the same selected bins; at
    those above -60 dB (the gate of JAX's own test), frequencies within
    2e-4 Hz and mags within 2e-2 dB (tests/test_hybrid_df.py:154-155).
    Below that gate JAX's values carry
    its df32 direct DFT's error floor, ~2^-24 of the frame norm: there the
    port is held by the next bar, where JAX was off by up to 0.06 dB;
  - hybrid against a numpy float64 QIFFT of the same selected bins, every
    valid lane: 1e-6 Hz and 1e-6 dB;
  - ladder against JAX _top_peaks_df (tests/test_df_peaks.py:51-64): equal
    validity masks, frequencies within 1e-9 Hz on lanes above -60 dB, mags
    within 1e-7 dB on every valid lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpp_audio_tpu.ops import df32, dfft, dfft_hybrid
from cpp_audio_tpu.ops import stft as jstft
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.ops import dfft_hybrid as tdfft_hybrid
from cpp_audio_tpu_torch.ops import stft as tstft
from test_df_peaks import _make_signal
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)


def _small_signal(seed=0):
    """tests/test_hybrid_df.py TestHybridPeaks._setup: two sines and a 1e-5
    noise floor, 0.5 s at 8 kHz."""
    sr = 8000
    rng = np.random.default_rng(seed)
    t = np.arange(sr // 2) / sr
    sig = (0.5 * np.sin(2 * np.pi * 620.3 * t + 0.2)
           + 0.25 * np.sin(2 * np.pi * 1533.7 * t + 1.0)
           + 1e-5 * rng.standard_normal(len(t)))
    return sig.astype(np.float32), dict(sr=sr, W=480, N=512, stride=160, k=8)


def _bench_signal():
    """tests/test_df_peaks.py's 24 sines over 2 s at 44.1 kHz, at the
    chain's analysis window (8000, FFT 8192, stride 3969)."""
    sr = 44100
    return _make_signal(2 * sr, sr), dict(sr=sr, W=8000, N=8192, stride=3969,
                                          k=64)


SIGNALS = {"small": _small_signal, "bench": _bench_signal}


def _window_scale(W):
    w64 = np.asarray(jstft.gaussian_window(W, sigmas=4.0), np.float64)
    return w64, (2.0 / float(np.sum(w64))) ** 2


def _frames(sig, p):
    n_frames = (len(sig) - p["W"]) // p["stride"] + 1
    return np.stack([sig[f * p["stride"]:f * p["stride"] + p["W"]]
                     for f in range(n_frames)])


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_top_bins_matches_jax(name):
    sig, p = SIGNALS[name]()
    w64, scale = _window_scale(p["W"])
    fr = _frames(sig, p) * w64.astype(np.float32)
    sq = (np.abs(np.fft.rfft(fr, n=p["N"])) ** 2 * np.float32(scale)).astype(
        np.float32)
    # more lanes than peaks in the small case: the padding contract too
    for k in (p["k"], 40):
        rb, rm = jstft._top_bins(jnp.asarray(sq), sample_rate=p["sr"],
                                 fft_length=p["N"], k=k)
        gb, gm = tstft._top_bins(torch.from_numpy(sq), sample_rate=p["sr"],
                                 fft_length=p["N"], k=k)
        rb, rm, gb, gm = np.asarray(rb), np.asarray(rm), gb.numpy(), gm.numpy()
        assert gb.shape == rb.shape == (sq.shape[0], k)
        np.testing.assert_array_equal(np.isfinite(gm), np.isfinite(rm))
        np.testing.assert_array_equal(gb, rb)
        fin = np.isfinite(rm)
        assert fin.sum() >= 2 * sq.shape[0]
        np.testing.assert_allclose(gm[fin], rm[fin], rtol=0, atol=1e-4)
        assert (np.diff(np.where(fin, gb, np.iinfo(np.int32).max), axis=1)
                > 0).all()  # ascending, padding last


def _hybrid(name):
    """(signal params, port (freq, mag), JAX (freq, mag) as hi + lo)."""
    sig, p = SIGNALS[name]()
    w64, scale = _window_scale(p["W"])
    kw = dict(window_size=p["W"], stride=p["stride"], fft_length=p["N"],
              sample_rate=p["sr"], k=p["k"])
    whi, wlo = interop.f64_to_df_pair(w64)
    shi, slo = interop.f64_to_df_pair(scale)
    fh, fl, mh, ml = dfft_hybrid.hybrid_peaks_df32(
        jnp.asarray(sig), jnp.asarray(whi), jnp.asarray(wlo),
        jnp.asarray(shi), jnp.asarray(slo), **kw)
    ref = (interop.df_pair_to_f64(fh, fl, device="cpu").numpy(),
           interop.df_pair_to_f64(mh, ml, device="cpu").numpy())
    got = tdfft_hybrid.hybrid_peaks_df32(
        torch.from_numpy(sig), torch.from_numpy(w64),
        torch.tensor(scale, dtype=torch.float64), **kw)
    assert got[0].dtype == got[1].dtype == torch.float64
    return sig, p, (got[0].numpy(), got[1].numpy()), ref


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_hybrid_peaks_match_jax(name):
    _sig, p, (freq, mag), (rfreq, rmag) = _hybrid(name)
    assert freq.shape == rfreq.shape == (freq.shape[0], p["k"])
    binw = p["sr"] / p["N"]
    nb = p["N"] // 2 + 1
    checked = 0
    for f in range(freq.shape[0]):
        # lanes may shift where the packages' float32 noise floors select
        # different quiet peaks, so the loud peaks are matched by bin; the
        # edge bins' mags are the -600 dB sentinel's inflation of a
        # noise-floor value (tests/test_hybrid_df.py:139-143), not loudness
        def loud_bins(fq, mg):
            b = np.rint(fq / binw)
            keep = (mg >= -80.0) & (b > 0) & (b < nb - 1)
            return keep, b[keep]

        loud, bins = loud_bins(freq[f], mag[f])
        rloud, rbins = loud_bins(rfreq[f], rmag[f])
        assert len(set(bins)) == len(bins) and set(bins) == set(rbins)
        order, rorder = np.argsort(bins), np.argsort(rbins)
        fr, rf = freq[f][loud][order], rfreq[f][rloud][rorder]
        mg, rm = mag[f][loud][order], rmag[f][rloud][rorder]
        # values: JAX's own gate (tests/test_hybrid_df.py:133-151), above
        # -60 dB, where its df32 direct DFT's error floor (~2^-24 of the
        # frame norm) stays below the bars
        gate = rm >= -60.0
        assert np.abs(fr - rf)[gate].max(initial=0) < 2e-4
        assert np.abs(mg - rm)[gate].max(initial=0) < 2e-2
        checked += int(gate.sum())
    assert checked >= 2 * freq.shape[0]


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_hybrid_peaks_match_numpy_f64_qifft(name):
    """The port's values against a numpy float64 QIFFT at the port's own
    selected bins (the -600 dB sentinels at bins 0 and nb-1 included)."""
    sig, p, (freq, mag), _ref = _hybrid(name)
    w64, scale = _window_scale(p["W"])
    frames = _frames(sig, p)
    # the port's selection, as hybrid_peaks_df32 makes it (a clipped QIFFT
    # delta of +-0.5 bin leaves the bin ambiguous in the frequency)
    sq32 = (torch.fft.rfft(torch.from_numpy(frames * w64.astype(np.float32)),
                           n=p["N"]).abs() ** 2 * np.float32(scale))
    sel, _ = tstft._top_bins(sq32, sample_rate=p["sr"], fft_length=p["N"],
                             k=p["k"])
    sq = np.abs(np.fft.rfft(frames.astype(np.float64) * w64,
                            n=p["N"])) ** 2 * scale
    db = 10.0 * np.log10(np.maximum(sq, 1e-30))
    nb = p["N"] // 2 + 1
    binw = p["sr"] / p["N"]
    valid = np.isfinite(mag)
    assert valid.sum() >= 2 * freq.shape[0]
    for f, j in zip(*np.nonzero(valid)):
        b = int(sel[f, j])
        prv = db[f, b - 1] if b > 0 else -600.0
        nxt = db[f, b + 1] if b < nb - 1 else -600.0
        den = prv - 2 * db[f, b] + nxt
        d = float(np.clip(0.5 * (prv - nxt) / den if abs(den) > 1e-12 else 0.0,
                          -0.5, 0.5))
        assert abs(freq[f, j] - (b + d) * binw) < 1e-6
        assert abs(mag[f, j] - (db[f, b] - 0.25 * (prv - nxt) * d)) < 1e-6


def test_hybrid_all_padding_when_silent():
    _sig, p = _small_signal()
    w64, scale = _window_scale(p["W"])
    freq, mag = tdfft_hybrid.hybrid_peaks_df32(
        torch.zeros(p["sr"] // 2), torch.from_numpy(w64),
        torch.tensor(scale, dtype=torch.float64), window_size=p["W"],
        stride=p["stride"], fft_length=p["N"], sample_rate=p["sr"], k=p["k"])
    assert not torch.isfinite(mag).any()


def test_ladder_peaks_match_jax():
    """tests/test_df_peaks.py's signal through JAX's df32 spectrum + df32
    _top_peaks_df and through the port's float64 spectrum + _top_peaks_df."""
    sig, p = _bench_signal()
    w64, scale = _window_scale(p["W"])
    kw = dict(sample_rate=p["sr"], fft_length=p["N"], k=p["k"])
    sq = dfft.stft_sqmag_df32(jnp.asarray(sig), w64, window_size=p["W"],
                              stride=p["stride"], fft_length=p["N"])
    fh, fl, mh, ml = jstft._top_peaks_df(sq[0], sq[1], **kw)
    rfreq, rmag = df32.to_f64((fh, fl)), df32.to_f64((mh, ml))
    tsq = tstft.frames_sqmag_f64(
        torch.from_numpy(_frames(sig, p)), torch.from_numpy(w64),
        torch.tensor(scale, dtype=torch.float64), fft_length=p["N"])
    freq, mag = (a.numpy() for a in tstft._top_peaks_df(tsq, **kw))
    v = np.isfinite(mag)
    np.testing.assert_array_equal(v, np.isfinite(np.asarray(mh)))
    loud = v & (mag > -60.0)
    assert loud.sum() > 100
    assert np.abs(freq - rfreq)[loud].max() < 1e-9
    assert np.abs(mag - rmag)[v].max() < 1e-7
