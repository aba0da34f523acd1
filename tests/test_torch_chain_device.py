"""The port's device-tracker chain (cpp_audio_tpu_torch.analysis.chain:
run_offline_chain_device, resynthesize_signal_device,
prepare_offline_chain_device_batch) against the JAX package's, and against
the port's own host-tracker chain, on the CPU.

Bars (tests/test_chain.py): the same n_frames and dropped counts; the
vocoded leg at atol 1e-4 (float32 FFTs of the whole mixdown, rounded
differently by torch and XLA); the resynth leg at max|diff|/peak < 2e-3.
The batch against the single chain at 1e-3 * peak + 1e-7 (resynth) and
3e-3 * peak + 1e-7 (vocoded), as tests/test_chain.py:145-157.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.analysis import chain, resynth, vocoder
from cpp_audio_tpu.core import events, voices
from cpp_audio_tpu.models import sine_synth
from cpp_audio_tpu.ops import envelopes
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.analysis import vocoder as tvocoder
from test_chain import _workload
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
N = 2 * SR
CARRIER = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(N) / SR))
CFG = dict(sample_rate=SR, dtype="float32")


def _rel(a, b):
    peak = float(np.abs(b).max())
    assert peak > 1e-3
    return float(np.abs(a - b).max()) / peak


@pytest.fixture(scope="module")
def single():
    """(JAX device chain, port device chain with stage timings, port host
    chain) on tests/test_chain.py's 2 s workload."""
    bank, scfg = _workload(SR, N)
    ref = chain.run_offline_chain_device(
        bank, N, resynth.ResynthConfig(**CFG),
        vocoder.VocoderParams(sample_rate=SR), CARRIER,
        block_size=scfg.block_size)
    tbank = interop.voicebank_from_numpy(bank)
    targs = (tresynth.ResynthConfig(**CFG),
             tvocoder.VocoderParams(sample_rate=SR), CARRIER)
    timings = {}
    syncs = tdt.HOST_SYNCS
    got = tchain.run_offline_chain_device(tbank, N, *targs,
                                          block_size=scfg.block_size,
                                          device="cpu", timings=timings)
    got_syncs = tdt.HOST_SYNCS - syncs
    host = tchain.run_offline_chain(tbank, N, *targs,
                                    block_size=scfg.block_size, device="cpu")
    return ref, got, host, timings, got_syncs


def test_device_chain_matches_jax(single):
    ref, got, _host, timings, syncs = single
    assert list(timings) == ["synth", "analysis", "vocoder", "tracker", "render"]
    assert syncs == 1  # the violation flag, read once
    assert got.tracker == "device"
    assert got.n_frames == ref.n_frames
    assert int(got.dropped) == int(ref.dropped)
    r_ref, v_ref = np.asarray(ref.resynth), np.asarray(ref.vocoded)
    r, v = got.resynth.numpy(), got.vocoded.numpy()
    assert r.shape == r_ref.shape and r.shape[1] == 2
    assert v.shape == v_ref.shape
    np.testing.assert_allclose(v, v_ref, atol=1e-4)
    assert _rel(r, r_ref) < 2e-3


def test_device_chain_matches_host_chain(single):
    _ref, got, host, _timings, _syncs = single
    assert got.n_frames == host.n_frames
    r, r_h = got.resynth.numpy(), host.resynth.numpy()
    assert r.shape == r_h.shape
    np.testing.assert_allclose(got.vocoded.numpy(), host.vocoded.numpy(),
                               atol=1e-4)
    assert _rel(r, r_h) < 2e-3


def test_prepare_returns_framed_step():
    """prepare_offline_chain_device returns (step, n_frames); step() gives
    the framed (F, S, 2) render, which assemble_framed_stereo flattens to
    run_offline_chain_device's (T, 2)."""
    n = SR // 2
    bank, scfg = _workload(SR, n)
    rcfg = tresynth.ResynthConfig(**CFG)
    step, n_frames = tchain.prepare_offline_chain_device(
        interop.voicebank_from_numpy(bank), n, rcfg,
        tvocoder.VocoderParams(sample_rate=SR), CARRIER[:n],
        block_size=scfg.block_size, device="cpu")
    framed, mix, dropped = step()
    stride = tresynth._render_config(rcfg).stride
    assert framed.shape == (n_frames + 8, stride, 2)
    assert dropped.dim() == 0 and mix.dim() == 1
    flat = tchain.assemble_framed_stereo(framed, 0)
    assert flat.shape == ((n_frames + 8) * stride, 2)
    assert torch.equal(flat[stride:2 * stride], framed[1])


def _mod_mode_mixes(dtype, n):
    """The vocoder mix of prepare_offline_chain_device's step() at `dtype`
    with mod_mode None and "full", on tests/test_chain.py's workload at n
    samples."""
    bank, scfg = _workload(SR, n)
    args = (interop.voicebank_from_numpy(bank), n,
            tresynth.ResynthConfig(sample_rate=SR, dtype=dtype),
            tvocoder.VocoderParams(sample_rate=SR), CARRIER[:n])
    kw = dict(block_size=scfg.block_size, device="cpu")
    return [tchain.prepare_offline_chain_device(*args, mod_mode=mode, **kw)[0]()[1]
            for mode in (None, "full")]


def test_mod_mode_full_matches_jax():
    """prepare_offline_chain_device(mod_mode="full") takes the full-band
    modulator path, as JAX's (chain.py:457): the vocoded leg at the chain's
    atol 1e-4 against JAX's; it differs from the default "decimated"
    path."""
    n = SR
    bank, scfg = _workload(SR, n)
    step, _ = chain.prepare_offline_chain_device(
        bank, n, resynth.ResynthConfig(**CFG), vocoder.VocoderParams(sample_rate=SR),
        CARRIER[:n], block_size=scfg.block_size, mod_mode="full")
    ref = np.asarray(step()[1])
    default, full = _mod_mode_mixes("float32", n)
    assert full.shape == ref.shape and float(np.abs(ref).max()) > 1e-3
    np.testing.assert_allclose(full.numpy(), ref, atol=1e-4)
    assert not torch.equal(full, default)


def test_mod_mode_reaches_the_df32_chain():
    """The fidelity chain's vocoder (float32, on the same float32 synth)
    takes mod_mode too: its "full" mix is the float32 chain's."""
    n = SR // 2
    default, full = _mod_mode_mixes("df32", n)
    assert not torch.equal(full, default)
    assert torch.equal(full, _mod_mode_mixes("float32", n)[1])


def test_df32_device_chain_returns_framed_stereo():
    """The fidelity chain (dtype "df32") through prepare_offline_chain_device:
    step() gives the framed (F, S, 2) float32 render, the float32 vocoder
    mix and a dropped scalar (its parity: tests/test_torch_df_chain.py)."""
    n = SR // 2
    bank, scfg = _workload(SR, n)
    rcfg = tresynth.ResynthConfig(sample_rate=SR, dtype="df32")
    step, n_frames = tchain.prepare_offline_chain_device(
        interop.voicebank_from_numpy(bank), n, rcfg,
        tvocoder.VocoderParams(sample_rate=SR), CARRIER[:n],
        block_size=scfg.block_size, device="cpu")
    framed, mix, dropped = step()
    stride = tresynth._render_config(rcfg).stride
    assert framed.shape == (n_frames + 8, stride, 2)
    assert framed.dtype == mix.dtype == torch.float32
    assert mix.dim() == 1 and dropped.dim() == 0 and int(dropped) == 0
    assert bool(torch.isfinite(framed).all()) and float(framed.abs().max()) > 1e-3


def _tone_signal(n):
    t = np.arange(n) / SR
    sig = np.zeros(n)
    for f0, s0, s1 in [(220, 0.1, 0.9), (440, 0.4, 1.6), (660, 1.0, 1.9)]:
        i0, i1 = int(s0 * SR), int(s1 * SR)
        sig[i0:i1] += 0.2 * np.hanning(i1 - i0) * np.sin(
            2 * np.pi * f0 * t[: i1 - i0])
    return sig


def test_resynthesize_signal_device_matches_jax():
    sig = _tone_signal(N)
    kw = dict(sample_rate=SR, analysis_volume=1.0, dtype="float32")
    ref = np.asarray(chain.resynthesize_signal_device(
        sig, resynth.ResynthConfig(**kw)))
    got = tchain.resynthesize_signal_device(
        sig, tresynth.ResynthConfig(**kw), device="cpu").numpy()
    assert got.shape == ref.shape and got.shape[1] == 2
    assert _rel(got, ref) < 2e-3


def _batch_banks():
    """tests/test_chain.py:test_batched_chain_matches_single's two jobs."""
    banks = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        notes = [events.Note(i, int(rng.uniform(0, N * 0.4)),
                             int(rng.uniform(N * 0.5, N * 0.9)),
                             float(rng.uniform(110, 1760)),
                             float(rng.uniform(0.3, 1.0)),
                             float(rng.uniform(-1, 1))) for i in range(6)]
        sch = voices.schedule_from_notes(notes, pad_to=8)
        cfg = sine_synth.SineSynthConfig(
            sample_rate=SR, block_size=4096, dtype="float32",
            ahdsr=envelopes.AHDSR(attack=441, hold=0, decay=1000,
                                  release=2205, sustain=0.7))
        banks.append(sine_synth.bank_from_schedule(sch, cfg))
    return banks


@pytest.fixture(scope="module")
def batch():
    banks = _batch_banks()
    kw = dict(sample_rate=SR, analysis_volume=1.0, dtype="float32")
    step, _ = chain.prepare_offline_chain_device_batch(
        banks, N, resynth.ResynthConfig(**kw),
        vocoder.VocoderParams(sample_rate=SR), CARRIER, block_size=4096)
    ref = [np.asarray(x) for x in step()]
    tbanks = [interop.voicebank_from_numpy(b) for b in banks]
    targs = (tresynth.ResynthConfig(**kw),
             tvocoder.VocoderParams(sample_rate=SR), CARRIER)
    tstep, _ = tchain.prepare_offline_chain_device_batch(
        tbanks, N, *targs, block_size=4096, device="cpu")
    got = [x.numpy() for x in tstep()]
    singles = [tchain.run_offline_chain_device(b, N, *targs, block_size=4096,
                                               device="cpu")
               for b in tbanks]
    return ref, got, singles


def test_batch_matches_single(batch):
    _ref, (stereo, voc, dropped), singles = batch
    for b, single in enumerate(singles):
        a = single.resynth.numpy()
        assert stereo[b].shape == a.shape
        peak = max(np.abs(a).max(), 1e-9)
        assert np.abs(a - stereo[b]).max() < 1e-3 * peak + 1e-7
        va = single.vocoded.numpy()
        vb = voc[b][: len(va)]
        assert np.abs(va - vb).max() < 3e-3 * max(np.abs(va).max(), 1e-9) + 1e-7
        assert int(dropped[b]) == int(single.dropped)


def test_batch_matches_jax(batch):
    (r_st, r_voc, r_dr), (stereo, voc, dropped), _singles = batch
    assert stereo.shape == r_st.shape and voc.shape == r_voc.shape
    np.testing.assert_array_equal(dropped, r_dr)
    for b in range(stereo.shape[0]):
        assert _rel(stereo[b], r_st[b]) < 2e-3
        np.testing.assert_allclose(voc[b], r_voc[b], atol=1e-4)
