"""The port's live path (cpp_audio_tpu_torch.analysis.streaming) against the
JAX package's: PeriodicFFT, StreamingVocoder and LiveResynth, on the CPU.

Both packages get the same numpy signals and configs built from one dict of
field values. Bars: StreamingVocoder against JAX's at atol 1e-9 (both
float64: numpy's FFT there, torch's here), against the port's offline exact
vocoder at atol 1e-5 after the 2S-1 lag (tests/test_streaming_vocoder.py:
29-47; the offline vocoder is float32); LiveResynth at the same stats and
max|diff|/peak < 2e-3 (the chain bar, tests/test_chain.py:83: both analyse
in float32, whose FFTs round differently).
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.analysis import resynth, streaming, vocoder
from cpp_audio_tpu.core import events
from cpp_audio_tpu.models import carrier
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.analysis import streaming as tstreaming
from cpp_audio_tpu_torch.analysis import vocoder as tvocoder
from cpp_audio_tpu_torch.core import events as tevents
from cpp_audio_tpu_torch.models import carrier as tcarrier
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100


class TestPeriodicFFT:
    """JAX's five cases (tests/test_streaming_resynth.py:10-63) on the port's
    class, then random feeds with drops against JAX's class."""

    def test_window_stride_overlap(self):
        got = []
        p = tstreaming.PeriodicFFT(8, 3, lambda w, end: got.append((w.copy(), end)))
        p.feed(np.arange(20.0))
        assert len(got) == 5
        np.testing.assert_allclose(got[0][0], np.arange(8))
        np.testing.assert_allclose(got[1][0], np.arange(3, 11))
        assert [e for _, e in got] == [8, 11, 14, 17, 20]

    def test_sample_by_sample_matches_block(self):
        a, b = [], []
        p1 = tstreaming.PeriodicFFT(8, 3, lambda w, e: a.append((w.copy(), e)))
        p2 = tstreaming.PeriodicFFT(8, 3, lambda w, e: b.append((w.copy(), e)))
        x = np.random.default_rng(0).standard_normal(40)
        p1.feed(x)
        for s in x:
            p2.feed(s)
        assert len(a) == len(b)
        for (wa, ea), (wb, eb) in zip(a, b):
            np.testing.assert_allclose(wa, wb)
            assert ea == eb

    def test_negative_overlap_skips(self):
        got = []
        p = tstreaming.PeriodicFFT(4, 6, lambda w, e: got.append((w.copy(), e)))
        p.feed(np.arange(16.0))
        assert len(got) == 3
        np.testing.assert_allclose(got[1][0], np.arange(6, 10))
        np.testing.assert_allclose(got[2][0], np.arange(12, 16))

    def test_dropped_frames_resync(self):
        got = []
        p = tstreaming.PeriodicFFT(4, 4, lambda w, e: got.append((w.copy(), e)))
        p.feed(np.arange(3.0))
        p.on_dropped_frames(5)
        p.feed(np.arange(10.0, 14.0))
        assert [e for _, e in got] == [9]
        np.testing.assert_allclose(got[0][0], [0.0, 0.0, 0.0, 10.0])

    def test_dropped_frames_covered_by_pending_skip(self):
        got = []
        p = tstreaming.PeriodicFFT(4, 8, lambda w, e: got.append((w.copy(), e)))
        p.feed(np.arange(4.0))
        p.on_dropped_frames(3)
        p.feed(np.arange(20.0, 25.0))
        assert [e for _, e in got] == [4, 12]
        np.testing.assert_allclose(got[1][0], [21.0, 22.0, 23.0, 24.0])

    @pytest.mark.parametrize("window,stride", [(8, 3), (4, 6), (16, 16)])
    def test_random_feeds_and_drops_match_jax(self, window, stride):
        rng = np.random.default_rng(window * 31 + stride)
        a, b = [], []
        pj = streaming.PeriodicFFT(window, stride, lambda w, e: a.append((w, e)))
        pt = tstreaming.PeriodicFFT(window, stride, lambda w, e: b.append((w, e)))
        for _ in range(60):
            if rng.uniform() < 0.2:
                d = None if rng.uniform() < 0.2 else int(rng.integers(0, 12))
                pj.on_dropped_frames(d)
                pt.on_dropped_frames(d)
            x = rng.standard_normal(int(rng.integers(0, 20)))
            assert pt.feed(x) == pj.feed(x)
            assert pt.samples_until_fire() == pj.samples_until_fire()
        assert len(a) == len(b) > 10
        for (wa, ea), (wb, eb) in zip(a, b):
            np.testing.assert_array_equal(wb, wa)
            assert eb == ea


def _signals(n):
    """tests/test_streaming_vocoder.py:21-26."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / SR
    mod = np.sin(2 * np.pi * 330 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    car = rng.standard_normal(n) * 0.3
    return mod, car


def _stream(sv, mod, car, block):
    outs = [sv.process(mod[i:i + block], car[i:i + block])
            for i in range(0, len(car), block)]
    return np.concatenate([o.numpy() if torch.is_tensor(o) else o for o in outs])


class TestStreamingVocoder:
    @pytest.mark.parametrize("block,seconds", [(512, 0.5), (221, 0.5), (1000, 0.5),
                                               (1, 0.15)])
    def test_matches_jax(self, block, seconds):
        n = int(SR * seconds)
        mod, car = _signals(n)
        kw = dict(sample_rate=SR)
        ref = _stream(streaming.StreamingVocoder(vocoder.VocoderParams(**kw)),
                      mod, car, block)
        got = _stream(tstreaming.StreamingVocoder(tvocoder.VocoderParams(**kw),
                                                  device="cpu"), mod, car, block)
        assert got.shape == ref.shape == (n,)
        assert np.abs(ref).max() > 0.05
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)

    @pytest.mark.parametrize("block", [512, 221, 1000])
    def test_matches_offline_exact_vocoder_after_latency(self, block):
        p = tvocoder.VocoderParams(sample_rate=SR)
        S, W = p.stride, p.modulator_window
        n = SR // 2
        mod, car = _signals(n)
        off = tvocoder.vocode(mod, car, p, exact_modulator=True, device_out=True,
                              device="cpu").numpy()
        stream = _stream(tstreaming.StreamingVocoder(p, device="cpu"), mod, car, block)
        lag = 2 * S - 1
        warm = W + 2 * S
        L = min(len(off), len(stream) - lag)
        assert np.abs(off[warm:L]).max() > 0.05
        assert np.abs(off[warm:L] - stream[warm + lag:L + lag]).max() < 1e-5

    def test_volume_mix(self):
        p = tvocoder.VocoderParams(sample_rate=SR, volume_vocoded=0.0,
                                   volume_modulator=0.25, volume_carrier=0.5)
        mod, car = _signals(4096)
        out = tstreaming.StreamingVocoder(p, device="cpu").process(mod, car).numpy()
        np.testing.assert_allclose(out, 0.25 * mod + 0.5 * car, atol=1e-12)

    def test_zero_modulator_silences_vocoded(self):
        sv = tstreaming.StreamingVocoder(tvocoder.VocoderParams(sample_rate=SR),
                                         device="cpu")
        car = np.random.default_rng(1).standard_normal(SR // 4)
        out = sv.process(np.zeros(len(car)), car).numpy()
        assert np.abs(out).max() < 1e-12


def _tone(seconds, parts):
    n = int(seconds * SR)
    t = np.arange(n)
    sig = np.zeros(n)
    for f0, s0, s1, a in parts:
        on = (t >= int(s0 * SR)) & (t < int(s1 * SR))
        sig[on] += a * np.sin(2 * np.pi * f0 * t[on] / SR)
    return sig


# tests/test_streaming_resynth.py:67-94
LIVE_CFG = dict(sample_rate=SR, window_size_seconds=0.05,
                window_center_stride_seconds=0.025, seed=1,
                env_release_seconds=0.02)
TONE = [(392.0, 0.0, 0.6, 0.4)]
TWO_TONES = [(261.6, 0.05, 0.7, 0.3), (440.0, 0.3, 0.9, 0.25)]


def _assert_live_match(live_ref, ref, live, got):
    assert live.stats == tstreaming.LiveResynthStats(**vars(live_ref.stats))
    assert got.shape == ref.shape and got.shape[1] == 2
    peak = float(np.abs(ref).max())
    assert peak > 1e-3
    assert float(np.abs(got - ref).max()) / peak < 2e-3


@pytest.mark.parametrize("parts", [TONE, TWO_TONES], ids=["tone", "two_tones"])
def test_live_resynth_matches_jax(parts):
    sig = _tone(0.9, parts)
    live_ref = streaming.LiveResynth(resynth.ResynthConfig(**LIVE_CFG))
    ref = live_ref.run_duplex(sig, block_size=512)
    live = tstreaming.LiveResynth(tresynth.ResynthConfig(**LIVE_CFG), device="cpu")
    got = live.run_duplex(sig, block_size=512)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    got = got.numpy()
    assert live.stats.windows > 20 and live.stats.note_on >= 1
    _assert_live_match(live_ref, ref, live, got)
    # silent before the first full window completes
    assert np.abs(got[: live.config.window_size - 1]).max() == 0.0


def test_live_pull_without_input_is_silence():
    live = tstreaming.LiveResynth(tresynth.ResynthConfig(**LIVE_CFG), device="cpu")
    out = live.pull(256)
    assert out.shape == (256, 2)
    assert float(out.abs().max()) == 0.0


def test_live_resynth_with_carrier_vocoder_matches_jax():
    """The vocoder leg driven by each package's CarrierSynth (same seed and
    mix, a held 110 Hz note from t = 0: the live headline's carrier)."""
    sig = _tone(0.5, [(440.0, 0.0, 0.5, 0.5), (660.0, 0.2, 0.45, 0.2)])
    osc = dict(saw=0.6, noise=0.2, square=0.3)
    live_ref = streaming.LiveResynth(
        resynth.ResynthConfig(sample_rate=SR),
        vocoder_params=vocoder.VocoderParams(sample_rate=SR),
        carrier_synth=carrier.CarrierSynth(carrier.CarrierSynthConfig(
            sample_rate=SR, osc=carrier.CarrierOscMix(**osc), seed=4)))
    live = tstreaming.LiveResynth(
        tresynth.ResynthConfig(sample_rate=SR),
        vocoder_params=tvocoder.VocoderParams(sample_rate=SR),
        carrier_synth=tcarrier.CarrierSynth(tcarrier.CarrierSynthConfig(
            sample_rate=SR, osc=tcarrier.CarrierOscMix(**osc), seed=4),
            device="cpu"),
        device="cpu")
    live_ref.carrier_synth.on_event(events.Event(events.EventType.NOTE_ON, 0, 1, 110.0, 1.0))
    live.carrier_synth.on_event(tevents.Event(tevents.EventType.NOTE_ON, 0, 1, 110.0, 1.0))
    ref = live_ref.run_duplex(sig, block_size=512)
    got = live.run_duplex(sig, block_size=512).numpy()
    _assert_live_match(live_ref, ref, live, got)
    # the vocoded leg sounds before the first analysis window's notes do
    W = live.config.window_size
    assert np.abs(got[:W - 1]).max() > 1e-3
