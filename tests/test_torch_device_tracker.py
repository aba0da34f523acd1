"""The port's device tracker (cpp_audio_tpu_torch.analysis.device_tracker)
against the JAX package's (cpp_audio_tpu.analysis.device_tracker), on the
same numpy peaks, on the CPU.

Float64 (the JAX tests run their tracker in float64, conftest enables x64):
the frame-local stage's tuned pitches and volumes at rtol 1e-12 with the
loudness order equal; the batched matching equal; the slot tables at rtol
1e-9, atol 1e-12 with the dropped-NoteOn counts equal. Both packages form
the group sums as one-hot contractions, but each reduces in its own fixed
order (torch's sum over the lane axis, XLA's dot), so the sums of three or
more peaks may round differently in the last bit; the tables carry that
through float64 recurrences (pow, expm1, the mod-2 phase), which is what
the table tolerance allows for.
Float32: the rendered tables at max|diff| < 1e-4 * peak + 1e-7 (the bar of
tests/test_device_tracker.py:179).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_device_tracker as jtests
from cpp_audio_tpu.analysis import autotune as at
from cpp_audio_tpu.analysis import chain as jchain
from cpp_audio_tpu.analysis import device_tracker as jdt
from cpp_audio_tpu.analysis import resynth
from cpp_audio_tpu.utils import loudness
from cpp_audio_tpu_torch.analysis import autotune as tat
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.models import resynth_bank as trb
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

LI = loudness.phons_to_index(60.0)
LOUD = (np.asarray(loudness.PITCHES, np.float64),
        np.asarray(loudness.ELVS[LI], np.float64))
# TestParallelTracker._tables (tests/test_device_tracker.py:145-151)
BASE_KW = dict(stride=512, sample_rate=44100.0, max_voices=12, n_slots=32,
               nearby_distance=0.5, min_volume=1e-6, max_track_pitches=1.0,
               pitch_method=2, volume_method=1, analysis_volume=1.0,
               shift_pre=0.0, shift_post=0.0, stereo_spread=0.8,
               attack=441.0, hold=0.0, decay=800.0, sustain=0.7,
               release=2000.0)


def _pools(F, max_voices):
    cap = F * max_voices + 16
    return (np.random.default_rng(1).uniform(-1, 1, cap),
            np.random.default_rng(2).uniform(0, 2, cap))


def _cluster_peaks(seed, F=24, k=16):
    """Frequency-sorted peaks with clusters of 1-3 peaks inside a few
    tenths of a semitone (so the nearby grouping sums real groups), NaN /
    -inf padded like analyze_arrays."""
    rng = np.random.default_rng(seed)
    freq = np.full((F, k), np.nan)
    mag = np.full((F, k), -np.inf)
    bases = rng.uniform(100, 3000, 6)
    for f in range(F):
        fs = []
        for b in bases[rng.random(6) < 0.7]:
            for _ in range(int(rng.integers(1, 4))):
                fs.append(b * 2 ** (rng.uniform(-0.3, 0.3) / 12))
        fs = np.unique(np.sort(fs))[:k]
        freq[f, :len(fs)] = fs
        mag[f, :len(fs)] = rng.uniform(-45, -8, len(fs))
    return freq, mag


def _at_arrays(cfg, which):
    """Autotune arrays of `cfg` from the JAX package and from the port."""
    if which == "jax":
        return jchain.autotune_device_arrays(cfg, jnp.float64)[1]
    return tchain.autotune_device_arrays(cfg, torch.float64, device="cpu")[1]


# autotune configs as functions of the autotune module: each package's
# ResynthConfig takes its own AutotuneType enum
def NO_AT(_m):
    return {}


def SCALE(_m):
    return dict(use_autotune=True)


def CHORD(m):
    return dict(use_autotune=True,
                autotune_kwargs=dict(autotune_type=m.AutotuneType.CHORD))


FRAME_LOCAL_CASES = {
    "noop": (dict(pitch_method=2, volume_method=1), NO_AT),
    "shift": (dict(pitch_method=0, volume_method=0, shift_pre=3.0,
                   shift_post=-1.0), NO_AT),
    "harmonize_merged": (dict(pitch_method=1, volume_method=1,
                              harmonize_pre=7.0, harmonize_post=12.0,
                              harmonize_semantics="merged"), NO_AT),
    "harmonize_reference": (dict(pitch_method=2, volume_method=0,
                                 harmonize_pre=12.0, harmonize_post=-5.0,
                                 harmonize_semantics="reference"), NO_AT),
    "autotune_scale": (dict(pitch_method=2, volume_method=1,
                            autotune_kind="scale", autotune_tolerance=0.4),
                       SCALE),
    "autotune_allowed": (dict(pitch_method=0, volume_method=1,
                              autotune_kind="allowed", harmonize_pre=7.0),
                         CHORD),
}


def _frame_local_pair(name, seed=3):
    kw, at_cfg = FRAME_LOCAL_CASES[name]
    kw = dict(dict(d=0.5, min_volume=1e-6, shift_pre=0.0, shift_post=0.0,
                   analysis_volume=0.7), **kw)
    cfg = resynth.ResynthConfig(**at_cfg(at))
    tcfg = tresynth.ResynthConfig(**at_cfg(tat))
    freq, mag = _cluster_peaks(seed)
    ref = jdt._frame_local(jnp.asarray(freq), jnp.asarray(mag),
                           *(jnp.asarray(a) for a in LOUD),
                           *_at_arrays(cfg, "jax"), **kw)
    got = tdt._frame_local(torch.from_numpy(freq), torch.from_numpy(mag),
                           *(torch.from_numpy(a) for a in LOUD),
                           *_at_arrays(tcfg, "port"), **kw)
    return [np.array(a) for a in ref], [a.numpy() for a in got]


@pytest.mark.parametrize("name", sorted(FRAME_LOCAL_CASES))
def test_frame_local_matches_jax(name):
    (p_ref, v_ref, o_ref), (p, v, o) = _frame_local_pair(name)
    assert p.shape == p_ref.shape
    assert np.isfinite(p_ref).sum() > 40  # the case tuned real pitches
    np.testing.assert_allclose(p, p_ref, rtol=1e-12)
    np.testing.assert_allclose(v, v_ref, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(o, o_ref)


@pytest.mark.parametrize("name", ["noop", "harmonize_merged"])
def test_match_parallel_matches_jax(name):
    (p_ref, _v, _o), _ = _frame_local_pair(name)
    tvalid = np.isfinite(p_ref)
    m_ref, mp_ref = jdt._match_parallel(jnp.asarray(p_ref),
                                        jnp.asarray(tvalid), 1.0, 128)
    m, mp = tdt._match_parallel(torch.from_numpy(p_ref),
                                torch.from_numpy(tvalid), 1.0, 128)
    assert np.asarray(m_ref).sum() > 20  # notes continued across frames
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mp_ref))


def _random_config(seed, at_cfg=NO_AT, **over):
    """A tests/test_device_tracker.py:357-406 style config with autotune and
    harmonize, and peaks for it."""
    rng = np.random.default_rng(2000 + seed)
    kw = dict(sample_rate=44100, dtype="float64", seed=int(rng.integers(1000)),
              nearby_distance_tones=0.3, min_volume=1e-4,
              max_track_pitches=1.5, pitch_harmonize_pre_autotune=7.0,
              pitch_harmonize_post_autotune=5.0, max_voices=12,
              env_release_seconds=0.02, env_sustain_level=0.6)
    kw.update(over)
    cfg = resynth.ResynthConfig(**kw, **at_cfg(at))
    tcfg = tresynth.ResynthConfig(**kw, **at_cfg(tat))
    freq, mag = jtests._random_peaks(rng, 30, cfg.max_voices + 1)
    return cfg, tcfg, freq, mag


def _tables(freq, mag, kw, *, jax_kw=None, port_kw=None, pools=None):
    F = freq.shape[0]
    pan, phase = pools or _pools(F, kw["max_voices"])
    ref_t, ref_d = jdt.build_tables_device(freq, mag, *LOUD, pan, phase,
                                           **kw, **(jax_kw or {}))
    got_t, got_d = tdt.build_tables_device(freq, mag, *LOUD, pan, phase,
                                           device="cpu", **kw,
                                           **(port_kw or {}))
    return np.asarray(ref_t), int(ref_d), got_t.numpy(), int(got_d)


def _case_inputs(name):
    """(peaks, magnitudes, keywords, pools or None, JAX keywords, port
    keywords) of one build_tables_device case."""
    if name in ("parallel", "force_scan", "min_volume_0"):
        freq, mag = jtests.TestParallelTracker()._peaks(seed=7)
        kw = dict(BASE_KW, total_frames=freq.shape[0] + 6)
        extra = {"force_scan": dict(_force_scan=True),
                 "min_volume_0": dict(min_volume=0.0)}.get(name, {})
        kw.update({k: v for k, v in extra.items() if k != "_force_scan"})
        force = {k: v for k, v in extra.items() if k == "_force_scan"}
        return freq, mag, kw, None, force, force
    if name == "cap_violation":
        # tests/test_device_tracker.py:181-208: every frame saturated with
        # more peaks than max_voices, so NoteOns drop and the violation sends
        # the call to the frame loop; at the "parallel" case's shapes and
        # keywords (max_voices 12), so the JAX reference reuses its compile
        F = 40
        freq = np.tile(np.linspace(100, 3000, 16), (F, 1))
        mag = np.full((F, 16), -20.0)
        return freq, mag, dict(BASE_KW, total_frames=F + 6), None, {}, {}
    if name == "silence":
        freq = np.full((20, 16), np.nan)
        mag = np.full((20, 16), -np.inf)
        return freq, mag, dict(BASE_KW, total_frames=26), None, {}, {}
    if name == "crossing_glides":  # tests/test_device_tracker.py:253-295
        # two tones crossing in pitch mid-run, at the "parallel" case's
        # shapes and keywords
        F, k = 40, 16
        freq = np.full((F, k), np.nan)
        mag = np.full((F, k), -np.inf)
        for fr in range(F):
            pair = sorted([(300.0 * 2 ** (fr / F), -15.0),
                           (600.0 * 2 ** (-fr / F), -18.0)])
            for j, (f0, m0) in enumerate(pair):
                freq[fr, j], mag[fr, j] = f0, m0
        return freq, mag, dict(BASE_KW, total_frames=F + 6), None, {}, {}
    if name == "stable_draws":  # tests/test_device_tracker.py:536-603
        cfg, tcfg, freq, mag = _random_config(
            1, draw_indexing="stable", pitch_harmonize_pre_autotune=0.0,
            pitch_harmonize_post_autotune=0.0)
    elif name == "autotune_harmonize_merged":
        cfg, tcfg, freq, mag = _random_config(
            2, SCALE, harmonize_semantics="merged")
    else:  # autotune_harmonize_reference
        cfg, tcfg, freq, mag = _random_config(
            3, CHORD, harmonize_semantics="reference")
    rcfg, trcfg = resynth._render_config(cfg), tresynth._render_config(tcfg)
    kw = jchain.tracker_config_kwargs(cfg, rcfg)
    assert tchain.tracker_config_kwargs(tcfg, trcfg) == kw
    kw.update(total_frames=freq.shape[0] + 8, stride=rcfg.stride,
              sample_rate=float(cfg.sample_rate))
    return (freq, mag, kw,
            resynth.draw_pools(cfg, freq.shape[0] * cfg.max_voices + 16),
            dict(autotune_arrays=_at_arrays(cfg, "jax")),
            dict(autotune_arrays=_at_arrays(tcfg, "port")))


def _case_tables(name):
    """(JAX table, JAX dropped, port table, port dropped, path the port
    took) for one build_tables_device case."""
    freq, mag, kw, pools, jax_kw, port_kw = _case_inputs(name)
    syncs = tdt.HOST_SYNCS
    out = _tables(freq, mag, kw, jax_kw=jax_kw, port_kw=port_kw, pools=pools)
    took_parallel = tdt.HOST_SYNCS > syncs and out[3] == 0
    return out + (took_parallel,)


BUILD_CASES = {  # case -> does the port keep the frame-parallel table?
    "parallel": True, "force_scan": False, "min_volume_0": False,
    "cap_violation": False, "silence": True, "crossing_glides": True,
    "stable_draws": None, "autotune_harmonize_merged": None,
    "autotune_harmonize_reference": None,
}


@pytest.mark.parametrize("name", list(BUILD_CASES))
def test_build_tables_matches_jax(name):
    ref_t, ref_d, got_t, got_d, took_parallel = _case_tables(name)
    assert got_t.shape == ref_t.shape
    assert got_d == ref_d
    if name == "cap_violation":
        assert got_d > 0
    if BUILD_CASES[name] is not None:
        assert took_parallel == BUILD_CASES[name]
    if name != "silence":
        assert np.count_nonzero(ref_t[..., trb._F_VTGT]) > 20
    np.testing.assert_allclose(got_t, ref_t, rtol=1e-9, atol=1e-12)


ROUTE_CASES = {  # case -> (flag reads, frame loops) of one call on the CPU
    "parallel": (1, 0), "silence": (1, 0), "crossing_glides": (1, 0),
    "cap_violation": (1, 1), "force_scan": (0, 1), "min_volume_0": (0, 1),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_cpu_lanes_keep_the_frame_parallel_try(name):
    """CPU lanes still try the frame-parallel tracker where min_volume > 0
    and the loop is not forced: one violation-flag read, and the exact
    frame loop only on a violation; forced or at min_volume 0, no read and
    one loop. (On the card the frame-loop kernel builds the tables with
    no read: tests/test_torch_cuda_scan.py.)"""
    freq, mag, kw, pools, _jax_kw, port_kw = _case_inputs(name)
    pan, phase = pools or _pools(freq.shape[0], kw["max_voices"])
    syncs, loops = tdt.HOST_SYNCS, tdt.FRAME_LOOPS
    tdt.build_tables_device(freq, mag, *LOUD, pan, phase, device="cpu", **kw,
                            **port_kw)
    assert (tdt.HOST_SYNCS - syncs, tdt.FRAME_LOOPS - loops) == ROUTE_CASES[name]


@pytest.mark.parametrize("force_scan", [False, True])
def test_float32_tables_render_like_jax(force_scan):
    """The serving dtype: float32 peaks, pools and loudness tables through
    both trackers; both tables rendered by the port's float32 renderer."""
    freq, mag = jtests.TestParallelTracker()._peaks(seed=11)
    freq, mag = freq.astype(np.float32), mag.astype(np.float32)
    pan, phase = (p.astype(np.float32) for p in _pools(freq.shape[0], 12))
    loud = tuple(a.astype(np.float32) for a in LOUD)
    kw = dict(BASE_KW, total_frames=freq.shape[0] + 6, _force_scan=force_scan)
    ref_t, ref_d = jdt.build_tables_device(freq, mag, *loud, pan, phase, **kw)
    got_t, got_d = tdt.build_tables_device(freq, mag, *loud, pan, phase,
                                           device="cpu", **kw)
    assert got_t.dtype == torch.float32 and int(got_d) == int(ref_d) == 0

    def render(t):
        t = torch.as_tensor(np.asarray(t, np.float32))
        return trb._render_slots(t, stride=512, dtype="float32").reshape(-1, 2)

    a, b = render(got_t).numpy(), render(ref_t).numpy()
    peak = max(float(np.abs(b).max()), 1e-9)
    assert peak > 1e-3
    assert float(np.abs(a - b).max()) < 1e-4 * peak + 1e-7


@pytest.mark.parametrize("min_volume", [1e-6, 0.0])
def test_batch_matches_jax_and_single(min_volume):
    """build_tables_device_batch against the JAX batch and against the
    port's per-job build_tables_device (tests/test_device_tracker.py:211)."""
    rng = np.random.default_rng(11)
    B, F, k = 3, 30, 16
    freqs, mags = [], []
    for _ in range(B):
        freq, mag = jtests._random_peaks(rng, F, k)
        freqs.append(freq)
        mags.append(mag)
    freq, mag = np.stack(freqs), np.stack(mags)
    pan, phase = _pools(F, 12)
    kw = dict(BASE_KW, total_frames=F + 6, min_volume=min_volume)
    ref_t, ref_d = jdt.build_tables_device_batch(freq, mag, *LOUD, pan, phase,
                                                 **kw)
    got_t, got_d = tdt.build_tables_device_batch(freq, mag, *LOUD, pan, phase,
                                                 device="cpu", **kw)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))
    for b in range(B):
        ts, ds = tdt.build_tables_device(freq[b], mag[b], *LOUD, pan, phase,
                                         device="cpu", **kw)
        np.testing.assert_allclose(got_t[b].numpy(), ts.numpy(), rtol=1e-12,
                                   atol=1e-12)
        assert int(got_d[b]) == int(ds)


@pytest.mark.parametrize("entry, lead", [("build_tables_device", ()),
                                         ("build_tables_device_batch", (1,)),
                                         ("build_tables_device_df", ())],
                         ids=["single", "batch", "df"])
def test_max_voices_cap(entry, lead):
    """Every entry refuses max_voices > 127: the played set holds 128
    pitches (_Q, the frame-loop kernel's Q), so more voices would lose
    note-ons without a count."""
    with pytest.raises(ValueError, match="127"):
        getattr(tdt, entry)(np.zeros(lead + (2, 8)), np.zeros(lead + (2, 8)), *LOUD,
                            np.zeros(8), np.zeros(8), device="cpu",
                            **dict(BASE_KW, total_frames=4, max_voices=128))
