"""The fidelity chain's tracker (cpp_audio_tpu_torch.analysis.device_tracker
build_tables_device_df) on the CPU.

JAX's df32 tracker (build_tables_device_df) is not the reference here: it
does not finish compiling on a CPU within minutes, and it approximates in
df32 pairs what the float64 tracker computes. The port's df tracker is held
against JAX's float64 build_tables_device on the same float64 peaks (its
table with fields 0 + 16 combined, at rtol 1e-9 / atol 1e-12, the bar of
tests/test_torch_device_tracker.py; the dropped counts equal), and against
the host float64 tables (the native table packer and the Python tracker's
_build_slot_tables) at note level: tools/note_metrics.py F1 = 1.0.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_device_tracker as jtests
import test_torch_device_tracker as tt
from cpp_audio_tpu.analysis import chain as jchain
from cpp_audio_tpu.analysis import device_tracker as jdt
from cpp_audio_tpu.analysis import resynth
from cpp_audio_tpu_torch import native
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.models import resynth_bank as trb
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import note_metrics  # noqa: E402

SR = 44100


def _default_case(seed=5, F=24):
    """The chain's default tracker config (ResynthConfig(), k = 128 lanes,
    128 slots) and track-structured float64 peaks for it."""
    cfg, tcfg = resynth.ResynthConfig(), tresynth.ResynthConfig(dtype="df32")
    freq, mag = jtests._random_peaks(np.random.default_rng(seed), F,
                                     cfg.max_voices + 1)
    return cfg, tcfg, freq, mag


def _case(name):
    """(JAX config, port config, freq, mag) of one case."""
    if name in ("default", "force_scan"):
        return _default_case()
    if name == "stable_draws":
        return tt._random_config(1, draw_indexing="stable",
                                 pitch_harmonize_pre_autotune=0.0,
                                 pitch_harmonize_post_autotune=0.0)
    return tt._random_config(2, tt.SCALE, harmonize_semantics="merged")


def _tables(name):
    cfg, tcfg, freq, mag = _case(name)
    rcfg, trcfg = resynth._render_config(cfg), tresynth._render_config(tcfg)
    kw = jchain.tracker_config_kwargs(cfg, rcfg)
    assert tchain.tracker_config_kwargs(tcfg, trcfg) == kw
    kw.update(total_frames=freq.shape[0] + 8, stride=rcfg.stride,
              sample_rate=float(cfg.sample_rate))
    force = dict(_force_scan=True) if name == "force_scan" else {}
    pan, phase = resynth.draw_pools(cfg, freq.shape[0] * cfg.max_voices + 16)
    ref_t, ref_d = jdt.build_tables_device(
        freq, mag, *tt.LOUD, pan, phase, **kw, **force,
        autotune_arrays=tt._at_arrays(cfg, "jax"))
    _kind, at_arrays = tchain.autotune_device_arrays_df(tcfg, device="cpu")
    syncs = tdt.HOST_SYNCS
    got_t, got_d = tdt.build_tables_device_df(
        torch.from_numpy(freq), mag, *tt.LOUD, pan, phase, device="cpu",
        **kw, **force, autotune_arrays=at_arrays)
    took_parallel = tdt.HOST_SYNCS > syncs and int(got_d) == 0
    return np.asarray(ref_t), int(ref_d), got_t, int(got_d), took_parallel


CASES = {"default": True, "force_scan": False, "stable_draws": None,
         "autotune_harmonize": None}


@pytest.mark.parametrize("name", list(CASES))
def test_df_tables_match_jax_float64(name):
    ref, ref_d, got, got_d, took_parallel = _tables(name)
    assert got.dtype == torch.float64 and got.shape == ref.shape[:2] + (17,)
    assert got_d == ref_d
    if CASES[name] is not None:
        assert took_parallel == CASES[name]
    assert np.count_nonzero(ref[..., trb._F_VTGT]) > 20
    got = got.numpy()
    hi, lo = got[..., trb._F_INC], got[..., trb._F_INC_LO]
    # field 0 is the increment rounded to float32, field 16 the rest
    np.testing.assert_array_equal(hi, hi.astype(np.float32))
    assert np.all(np.abs(lo) <= np.abs(hi) * 2.0 ** -24)
    combined = np.concatenate([(hi + lo)[..., None], got[..., 1:16]], axis=-1)
    np.testing.assert_allclose(combined, ref, rtol=1e-9, atol=1e-12)


def test_split_increment_is_exact():
    table = torch.from_numpy(np.random.default_rng(0).uniform(
        1e-6, 0.2, (3, 4, 16)))
    out = tdt.split_increment(table)
    assert out.shape == (3, 4, 17)
    torch.testing.assert_close(out[..., :16].clone().index_fill_(
        -1, torch.tensor([0]), 0.0), table.clone().index_fill_(
        -1, torch.tensor([0]), 0.0), rtol=0, atol=0)
    assert torch.equal(out[..., 0] + out[..., 16], table[..., 0])


def test_df_tracker_takes_float64_peaks():
    with pytest.raises(ValueError, match="float64"):
        tdt.build_tables_device_df(np.zeros((2, 8), np.float32),
                                   np.zeros((2, 8)), *tt.LOUD, np.zeros(8),
                                   np.zeros(8), device="cpu",
                                   **dict(tt.BASE_KW, total_frames=4))


def _host_table(tcfg, freq, mag, tracker):
    trcfg = tresynth._render_config(tcfg)
    total = freq.shape[0] + 8
    if tracker == "native":
        return tresynth.build_tables_native(freq, mag, tcfg, total, trcfg)
    notes, _stats, _dropped = tresynth.track(
        [list(zip(f[np.isfinite(m)], m[np.isfinite(m)]))
         for f, m in zip(freq, mag)], tcfg, prefer_native=False)
    return trb._build_slot_tables(notes, total, trcfg)


@pytest.mark.parametrize("tracker", ["native", "python"])
def test_df_tables_note_sets_equal_host(tracker):
    """The note sets of the df tracker's table and the host float64
    tracker's on the default config's peaks are identical."""
    if tracker == "native" and not native.available():
        pytest.skip("the repo's native library did not build here")
    _cfg, tcfg, freq, mag = _default_case()
    trcfg = tresynth._render_config(tcfg)
    tables = tchain._tracker_inputs(tcfg, trcfg, freq.shape[0], None,
                                    torch.float64, "cpu")
    got, dropped = tdt.build_tables_device_df(
        torch.from_numpy(freq), mag, *tables[0], device="cpu", **tables[1])
    assert int(dropped) == 0
    host = _host_table(tcfg, freq, mag, tracker)
    m = note_metrics.note_level_metrics(got.numpy(), host, SR)
    assert m["n_notes_a"] > 5
    assert m["f1"] == 1.0 and m["f1_weighted"] == 1.0
    assert m["n_notes_a"] == m["n_notes_b"] == m["n_matched"]
