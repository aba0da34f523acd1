"""The fidelity chain (dtype "df32": cpp_audio_tpu_torch.analysis.chain with
the 17-field df-phase render of models/resynth_bank) on the CPU.

Bars:
  - the 17-field render of a JAX-made df table: within 5e-6 * peak of JAX's
    df render and of the port's float64 render of the same table;
  - the 2 s chain (tests/test_chain.py's workload): the render against the
    host float64 tracker (the Python one: the native packer's table is
    float32, which bounds it near -98 dB) + float64 render fed the chain's
    own peaks ("same peaks", bench.py:300-334) at <= -100 dB; the table
    against JAX's host_chain_table at float64 with bench.py's note_e2e_pass
    bars (:389-394); the vocoder mix against the JAX float32 chain's at atol
    1e-4 (tests/test_chain.py);
  - resynthesize routes dtype "df32" as the JAX package does (the render
    config's dtype becomes float32): "auto" is the device path, held
    against the native route of both packages at 2e-3 * peak.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpp_audio_tpu.analysis import chain, resynth, vocoder
from cpp_audio_tpu.models import resynth_bank as rb
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.analysis import vocoder as tvocoder
from cpp_audio_tpu_torch.models import resynth_bank as trb
from cpp_audio_tpu_torch.ops import stft as tstft
from test_chain import _workload
from test_torch_chain_device import _tone_signal
from test_torch_resynth_bank import STRIDE, _notes
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import note_metrics  # noqa: E402

SR = 44100
N = 2 * SR
CARRIER = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(N) / SR))


def _rel(a, b):
    peak = float(np.abs(b).max())
    assert peak > 1e-3
    return float(np.abs(a - b).max()) / peak


def _rms_db(err, ref):
    return 20.0 * np.log10(max(float(np.sqrt(np.mean(np.square(err)))), 1e-30)
                           / float(np.sqrt(np.mean(np.square(ref)))))


def _jax_df_table():
    """A float32 17-field table as JAX's df tracker emits it: field 0 the
    float32 increment, field 16 the rest, every other field float32; from
    the host packer's glides (tests/test_torch_resynth_bank.py)."""
    cfg = rb.TrackedRenderConfig(sample_rate=SR, stride=STRIDE, n_slots=16)
    table = rb._build_slot_tables(_notes(rb, 12, seed=4), 16, cfg)
    hi, lo = interop.f64_to_df_pair(table[..., rb._F_INC])
    t17 = np.concatenate([table, lo[..., None]], axis=-1).astype(np.float32)
    t17[..., rb._F_INC] = hi
    return t17


def test_df_render_matches_jax_df_render():
    t17 = _jax_df_table()
    ref = np.asarray(rb._render_slots(jnp.asarray(t17), stride=STRIDE,
                                      n_channels=2, dtype="float32"))
    got = trb._render_slots(torch.from_numpy(t17), stride=STRIDE,
                           dtype="float32")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.numpy(), ref) < 5e-6


def test_df_render_matches_float64_render():
    t17 = torch.from_numpy(_jax_df_table())
    got = trb._render_slots(t17, stride=STRIDE, dtype="float32").numpy()
    exact = trb._render_slots(t17, stride=STRIDE, dtype="float64").numpy()
    assert _rel(got, exact) < 5e-6
    # the 16-field float32 render of the same table is further off: the
    # df-phase path is what holds the glides' phases
    t16 = t17[..., :16].clone()
    t16[..., 0] += t17[..., 16]
    plain = trb._render_slots(t16, stride=STRIDE, dtype="float32").numpy()
    assert _rel(plain, exact) > 2 * _rel(got, exact)


@pytest.fixture(scope="module")
def df_chain():
    """The port's df chain on the CPU, its own analysis peaks and table,
    and the references: the port's Python host tracker's float64 render of
    those peaks, JAX's float64 host_chain_table and the JAX float32 chain."""
    bank, scfg = _workload(SR, N)
    tbank = interop.voicebank_from_numpy(bank)
    tcfg = tresynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                  dtype="df32")
    targs = (tcfg, tvocoder.VocoderParams(sample_rate=SR), CARRIER)
    kw = dict(block_size=scfg.block_size, device="cpu")
    got = tchain.run_offline_chain_device(tbank, N, *targs, **kw)
    freq, mag = tchain.df32_analysis_peaks(tbank, N, *targs, **kw)
    table = tchain.df32_chain_table(tbank, N, *targs, **kw)
    cfg64 = tresynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                   dtype="float64")
    rcfg64 = tresynth._render_config(cfg64)
    notes, _stats, _dropped = tresynth.track(
        tstft.top_peaks_to_lists(freq, mag), cfg64, prefer_native=False)
    same = trb.render_tracked(notes, freq.shape[0], rcfg64, device_out=True,
                              device="cpu")
    vparams = vocoder.VocoderParams(sample_rate=SR)
    host64 = chain.host_chain_table(
        bank, N, resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                       dtype="float64"),
        vparams, CARRIER, block_size=scfg.block_size)
    jax32 = chain.run_offline_chain(
        bank, N, resynth.ResynthConfig(sample_rate=SR, dtype="float32"),
        vparams, CARRIER, block_size=scfg.block_size)
    return got, (freq, mag), table, same.numpy(), host64, jax32


def test_df_chain_same_peaks(df_chain):
    got, (freq, mag), _table, same, _host64, _jax32 = df_chain
    assert got.tracker == "device" and int(got.dropped) == 0
    assert freq.dtype == mag.dtype == np.float64
    assert freq.shape == (got.n_frames, 128)
    r = got.resynth.numpy()
    assert got.resynth.dtype == torch.float32 and r.shape == same.shape
    assert float(np.abs(same).max()) > 1e-3
    assert _rms_db(r - same, same) <= -100.0


def test_df_chain_note_level_matches_jax_host_float64(df_chain):
    _got, _peaks, table, _same, host64, _jax32 = df_chain
    assert table.dtype == np.float64 and table.shape[-1] == 17
    assert table.shape[:2] == host64.shape[:2]
    nm = note_metrics.note_level_metrics(table, host64, SR)
    assert nm["n_notes_a"] > 3
    assert (nm["f1_weighted"] >= 0.98 and nm["freq_rms_cents"] <= 1.0
            and nm["vol_rms_db"] <= 0.5 and nm["freq_median_cents"] <= 0.1
            and nm["vol_median_db"] <= 0.1), nm


def test_df_chain_vocoder_matches_jax_float32(df_chain):
    got, _peaks, _table, _same, _host64, jax32 = df_chain
    assert got.vocoded.dtype == torch.float32
    np.testing.assert_allclose(got.vocoded.numpy(), np.asarray(jax32.vocoded),
                               atol=1e-4)


def test_df_chain_ladder_mode(monkeypatch):
    """CPP_AUDIO_DF_ANALYSIS="ladder" (the module's DF_ANALYSIS_MODE, read
    when the chain is staged): the same loud peaks as the hybrid, to float64
    rounding, since both evaluate the same float64 spectrum."""
    bank, scfg = _workload(SR, N)
    args = (interop.voicebank_from_numpy(bank), N,
            tresynth.ResynthConfig(sample_rate=SR, dtype="df32"),
            tvocoder.VocoderParams(sample_rate=SR), CARRIER)
    kw = dict(block_size=scfg.block_size, device="cpu")
    hyb = tchain.df32_analysis_peaks(*args, **kw)
    monkeypatch.setattr(tchain, "DF_ANALYSIS_MODE", "ladder")
    lad = tchain.df32_analysis_peaks(*args, **kw)
    for (f_h, m_h), (f_l, m_l) in zip(zip(*hyb), zip(*lad)):
        loud_h, loud_l = f_h[m_h > -60.0], f_l[m_l > -60.0]
        assert loud_h.shape == loud_l.shape
        np.testing.assert_allclose(loud_l, loud_h, rtol=0, atol=1e-9)
    assert (hyb[1] > -60.0).sum() > 20


def test_resynthesize_routes_df32():
    sig = _tone_signal(N)
    kw = dict(sample_rate=SR, analysis_volume=1.0, dtype="df32")
    tcfg = tresynth.ResynthConfig(**kw)
    auto = tresynth.resynthesize(sig, tcfg, device_out=True, device="cpu")
    device = tchain.resynthesize_signal_device(sig, tcfg, device="cpu")
    assert auto.dtype == torch.float32 and auto.shape[1] == 2
    assert torch.equal(auto, device)
    native = tresynth.resynthesize(sig, tcfg, implementation="native",
                                   device_out=True, device="cpu")
    ref = np.asarray(resynth.resynthesize(sig, resynth.ResynthConfig(**kw),
                                          implementation="native"))
    assert native.dtype == torch.float32
    for other in (native.numpy(), ref):
        assert other.shape == auto.shape
        assert _rel(auto.numpy(), other) < 2e-3
