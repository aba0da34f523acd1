"""The chain step's cost analysis (cpp_audio_tpu_torch/analysis/cost.py,
step.cost_analysis() and the fidelity step's compiled_text()) on the CPU,
on tests/test_chain.py's 2 s workload.

The counts are integers and exact: the synth's is the voice-bank kernel's
own bound, the analysis a closed form in the frame count, the render the
live (frame, slot) pairs times the per-pair and per-sample work. The data
behind the data-dependent counts (valid peaks, lanes, notes, written rows,
the tracker's path, the render's live pairs) is held equal to the same
counts read off the JAX package's float64 peaks and device-tracker table
from the same inputs, and JAX's render of the pairs counted dead is zero.
The JAX package's cost analysis is printed beside the port's and shares its keys;
no bar ties the two numbers, because XLA counts its compiled program
(every slot of every frame, padding included) and the port the work the
inputs need.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpp_audio_tpu.analysis import chain, resynth, vocoder
from cpp_audio_tpu.analysis import device_tracker as jdt
from cpp_audio_tpu.models import resynth_bank as jrb
from cpp_audio_tpu.models import voicebank as jvb
from cpp_audio_tpu.ops import stft as jstft
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import cost
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.analysis import vocoder as tvocoder
from cpp_audio_tpu_torch.models import resynth_bank as trb
from cpp_audio_tpu_torch.models import voicebank as tvb
from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
from cpp_audio_tpu_torch.ops import envelopes
from test_chain import _workload
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
N = 2 * SR
CARRIER = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(N) / SR))
BENCH_KEYS = ("flops", "bytes accessed", "transcendentals")
CASES = {"float32": {}, "float64": {}, "df32": {},
         "float32 frame loop": {"min_volume": 0.0}}


def _dtype(case):
    return case.split()[0]


def _bits(out):
    return [t.numpy().tobytes() for t in out]


@pytest.fixture(scope="module")
def steps():
    """Per case: (step, bank, block size, cost_analysis(), the step's
    outputs before and after it, host syncs of a step before and after)."""
    bank, scfg = _workload(SR, N)
    tbank = interop.voicebank_from_numpy(bank)
    out = {}
    for case, extra in CASES.items():
        rcfg = tresynth.ResynthConfig(sample_rate=SR, dtype=_dtype(case), **extra)
        step, _n = tchain.prepare_offline_chain_device(
            tbank, N, rcfg, tvocoder.VocoderParams(sample_rate=SR), CARRIER,
            block_size=scfg.block_size, device="cpu")
        s0 = tdt.HOST_SYNCS
        before = _bits(step())
        s1 = tdt.HOST_SYNCS
        ca = step.cost_analysis()
        s2 = tdt.HOST_SYNCS
        after = _bits(step())
        out[case] = dict(step=step, bank=tbank, block=scfg.block_size,
                         rcfg=rcfg, ca=ca, before=before, after=after,
                         syncs=(s1 - s0, tdt.HOST_SYNCS - s2))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_cost_keys_and_totals(steps, case):
    ca = steps[case]["ca"]
    for key in BENCH_KEYS:
        assert isinstance(ca[key], float) and ca[key] > 0, key
    for key in ("flops", "flops_f64", "transcendentals"):
        assert ca[key] == sum(ca[f"{s} {key}"] for s in cost.STAGES), key
    assert ca["count basis"] == cost.COUNT_BASIS
    for s in cost.STAGES:
        assert ca[f"{s} bytes accessed"] > 0
        assert 0 <= ca[f"{s} flops_f64"] <= ca[f"{s} flops"]
    # the step's own inputs and outputs: below the stages' sum, which
    # counts every intermediate once written and once read
    assert ca["bytes accessed"] < sum(ca[f"{s} bytes accessed"]
                                      for s in cost.STAGES)
    want_path = "frame loop" if case.endswith("frame loop") else "frame-parallel"
    assert ca["tracker path"] == want_path
    f64 = {"float32": 0.0, "float64": ca["flops"]}.get(_dtype(case))
    if f64 is not None:
        assert ca["flops_f64"] == f64
    else:  # df32: float64 analysis values, tracker and render phase
        assert 0 < ca["flops_f64"] < ca["flops"]
        assert ca["tracker flops_f64"] == ca["tracker flops"]
        assert ca["synth flops_f64"] == ca["vocoder flops_f64"] == 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_synth_part_is_kernel_bound(steps, case):
    st = steps[case]
    dtype = "float32" if _dtype(case) == "df32" else _dtype(case)
    tables, statics = tvb.prepare_bank_arrays(st["bank"], N, st["block"], dtype,
                                              device="cpu")
    b = cv.kernel_bound(*cv.one_job(tables[:2]), n_channels=2, **statics)
    ca = st["ca"]
    assert ca["synth flops"] == b["flops"]
    assert ca["synth bytes accessed"] == b["bytes"]
    assert ca["synth transcendentals"] == b["live_voice_samples"]
    assert ca["synth flops_f64"] == (b["flops"] if dtype == "float64" else 0)


def _analysis_closed_form(dtype, df_mode="hybrid"):
    """The analysis count of the 2 s workload, written out: W = 8000,
    stride 3969 -> F = 21 frames of an 8192-point rfft (2.5 N log2 N =
    266240), 4097 bins, k = 128 peaks, n = 88200 samples of 2 channels."""
    F, W, nb, k, n = 21, 8000, 4097, 128, N
    assert F == (n - W) // 3969 + 1
    fft = 2.5 * 8192 * 13
    T = 11
    if dtype != "df32":
        item = 8 if dtype == "float64" else 4
        ops = n + W + 2 + F * (W + fft) + F * nb * (4 + 19 + T) + F * k * 2
        return ops, F * nb, item * (3 * n + W + 2 * F * k)
    if df_mode == "hybrid":
        f32 = n + F * (W + fft) + F * nb * (4 + 19 + T)
        f64 = F * (W + fft) + F * k * (3 * 4 + 23 + 3 * T)
    else:
        f32 = n + F * nb * (1 + 2 + 13 + 1 + T)
        f64 = F * (W + fft) + F * nb * (4 + 2) + F * k * (23 + 3 * T)
    return (f32 + f64, f64), F * nb + 3 * F * k, 4 * 3 * n + 8 * (W + 1 + 2 * F * k)


@pytest.mark.parametrize("case", ["float32", "float64", "df32"])
def test_analysis_part_is_closed_form(steps, case):
    ca = steps[case]["ca"]
    ops, trans, nbytes = _analysis_closed_form(case)
    if case == "df32":
        ops, ops64 = ops
        assert ca["analysis flops_f64"] == ops64
    assert ca["analysis flops"] == ops
    assert ca["analysis transcendentals"] == trans
    assert ca["analysis bytes accessed"] == nbytes


def test_analysis_ladder_is_closed_form():
    c = cost.analysis(N, n_channels=2, window_size=8000, stride=3969,
                      fft_len=8192, k=128, dtype="df32", df_mode="ladder")
    (ops, ops64), trans, nbytes = _analysis_closed_form("df32", "ladder")
    assert c == dict(flops_f32=ops - ops64, flops_f64=ops64, bytes=nbytes,
                     transcendentals=trans)


S_HAND = 100    # samples per frame of the hand-built table
R_HAND = 250.0  # release: frames rel, rel+1, rel+2 sound, rel+3 is written silent


def _hand_table(dtype):
    """A 12-frame, 8-slot table packed by the host packer from four notes at
    1 kHz (no decay, sustain 1): three released (written through rel + 3,
    sounding through rel + 2: (rel - f0) + 3 live pairs each) and one held
    to the end (12 - f0). Returns (table, L)."""
    notes = [trb.TrackedNote([(0, 1000.0, 0.5)], release_frame=4, pan=-0.5),
             trb.TrackedNote([(2, 1000.0, 0.4), (3, 1100.0, 0.6)],
                             release_frame=6, pan=0.3),
             trb.TrackedNote([(5, 1000.0, 0.7)], pan=1.0),
             trb.TrackedNote([(7, 1000.0, 0.3)], release_frame=8, pan=0.0)]
    a = envelopes.AHDSR(attack=50.0, hold=0.0, decay=0.0, release=R_HAND,
                        sustain=1.0)
    cfg = trb.TrackedRenderConfig(sample_rate=SR, stride=S_HAND, ahdsr=a,
                                  n_slots=8, dtype=dtype)
    table = trb._build_slot_tables(notes, 12, cfg)
    live = (4 - 0 + 3) + (6 - 2 + 3) + (12 - 5) + (8 - 7 + 3)
    return torch.as_tensor(table), live


def _default_row(n_fields):
    """The row of a slot that plays nothing (the host packer's)."""
    row = torch.as_tensor(trb._build_slot_tables([], 1, trb.TrackedRenderConfig(
        sample_rate=SR, stride=S_HAND))[0, 0])
    return tdt.split_increment(row) if n_fields == trb.N_FIELDS_DF else row


@pytest.mark.parametrize("dtype,n_fields", [("float32", 16), ("float64", 16),
                                            ("float32", 17)])
def test_render_counts_live_pairs(dtype, n_fields):
    """The 17-field case is the fidelity chain's: the float64 table after
    split_increment, rendered in float32."""
    table, L = _hand_table(dtype)
    if n_fields == trb.N_FIELDS_DF:
        table = tdt.split_increment(table)
    live = cost.live_pairs(table, stride=S_HAND, dtype=dtype)
    assert int(live.sum()) == L
    written = table[..., trb._F_TP0] >= 0
    assert int((written & ~live).sum()) == 3  # the three silent tail frames
    c = cost.render(L, stride=S_HAND, total_frames=12, n_slots=8,
                    n_fields=n_fields, table_float64=True, dtype=dtype)
    per = cost.render_per_pair(stride=S_HAND, n_fields=n_fields, dtype=dtype)
    assert c == dict({key: L * v for key, v in per.items()},
                     bytes=12 * 8 * n_fields * 8 + 12 * S_HAND * 2
                     * (8 if dtype == "float64" else 4))
    if n_fields == trb.N_FIELDS:
        # per pair 20 + 2 transcendentals, per sample 41 + 3, each 11
        # operations
        per = (20 + 2 * 11) + S_HAND * (41 + 3 * 11)
        assert c["flops_f64" if dtype == "float64" else "flops_f32"] == L * per
    else:  # the phase's 5 per pair, 7 + 1 transcendental per sample
        assert c["flops_f64"] == L * (5 + S_HAND * (7 + 11))
    assert c["transcendentals"] == L * (2 + 3 * S_HAND)
    out = trb._render_slots(table, stride=S_HAND, dtype=dtype)
    default = _default_row(n_fields)
    dead_only = table.clone()
    live_only = table.clone()
    live_only[~live] = default
    dead_only[live] = default
    assert not bool(trb._render_slots(dead_only, stride=S_HAND, dtype=dtype).any())
    assert torch.equal(trb._render_slots(live_only, stride=S_HAND, dtype=dtype), out)
    for f, p in live.nonzero().tolist():  # each live pair sounds
        one = default.expand_as(table).clone()
        one[f, p] = table[f, p]
        assert bool(trb._render_slots(one, stride=S_HAND, dtype=dtype)[f].any())


def test_render_part_counts_the_steps_live_pairs(steps):
    ca = steps["float32"]["ca"]
    L = ca["render live pairs"]
    assert 0 < L < 30 * 128
    S = tresynth._render_config(steps["float32"]["rcfg"]).stride
    assert ca["render flops"] == L * ((20 + 22) + S * (41 + 33))


def _jax_peaks_float64():
    """The JAX package's float64 analysis peaks of the workload: the
    analysis of its run_offline_chain (cpp_audio_tpu/analysis/chain.py:
    266-299) on the same bank and carrier."""
    bank, scfg = _workload(SR, N)
    rcfg = resynth.ResynthConfig(sample_rate=SR, dtype="float64")
    vp = vocoder.VocoderParams(sample_rate=SR)
    args, statics = jvb.prepare_bank_arrays(bank, N, scfg.block_size, "float64")
    args, statics = jvb.compact_block_args(args, statics)
    S, W = vp.stride, vp.modulator_window
    car_fft = jstft.fft_length_for(2 * S)
    edges = vp.band_freqs()
    n_mod = (N - W) // S + 1
    rows = np.clip(np.arange((N - 2 * S) // S + 1)
                   - max(0, -(-(W - 2 * S) // S)), 0, n_mod - 1)
    f64 = jnp.float64
    freq, mag, _mix = chain._fused_analyze_vocode(
        *args,
        jnp.asarray(jstft.gaussian_window(rcfg.window_size, sigmas=4.0), f64),
        jnp.asarray(CARRIER, f64), jnp.asarray(edges, f64),
        jnp.asarray(vocoder._band_matrix(edges, car_fft // 2 + 1,
                                         SR / car_fft), f64),
        jnp.asarray(rows), n=N, dtype="float64",
        window_size=rcfg.window_size, stride=rcfg.stride,
        fft_len=jstft.fft_length_for(rcfg.window_size),
        k=rcfg.max_voices + 1, sample_rate=SR, mod_window=W, voc_stride=S,
        car_fft=car_fft, n_mod_frames=n_mod,
        vol_mod=float(vp.volume_modulator), vol_car=float(vp.volume_carrier),
        vol_voc=float(vp.volume_vocoded),
        edges_t=tuple(float(e) for e in edges),
        mod_shape=vp.modulator_window_shape, **statics)
    return np.asarray(freq), np.asarray(mag)


@pytest.fixture(scope="module")
def jax_float64(steps):
    """JAX's side of the float64 case: its peaks, its device tracker's
    table (build_tables_device on the port's tracker arrays and keywords,
    which are JAX's: tests/test_torch_device_tracker.py) and its violation
    flag (the frame-parallel tracker's, which decides build_tables_device's
    path), and the data counts read off them with tracker_data's rules."""
    freq, mag = _jax_peaks_float64()
    rcfg = steps["float64"]["rcfg"]
    targs, kw = tchain._tracker_inputs(rcfg, tresynth._render_config(rcfg),
                                       freq.shape[0], None, torch.float64,
                                       "cpu")
    targs = [t.numpy() for t in targs]
    at_arrays = [t.numpy() for t in kw.pop("autotune_arrays")]
    table, dropped = jdt.build_tables_device(freq, mag, *targs,
                                             autotune_arrays=at_arrays, **kw)
    lanes = jdt._prep_lanes(freq, mag, *targs[:2], at_arrays, kw)
    _t, viol = jdt._parallel_tables(*lanes[:4], *targs[2:], kw, lanes[4],
                                    freq.shape[0])
    table = np.array(table)  # a writable copy
    tp0, tr0 = table[..., jrb._F_TP0], table[..., jrb._F_TR0]
    valid = np.isfinite(mag) & (freq > 0) & np.isfinite(freq)
    return dict(table=table, stride=kw["stride"], dropped=int(dropped),
                counts={"tracker peaks": int(valid.sum()),
                        "loud peaks": int((valid & (mag > NOISE_FLOOR_DB)).sum()),
                        "tracker lanes": int(((tp0 >= 0) & (tr0 < 0)).sum()),
                        "tracker notes": int((tp0 == 0).sum()),
                        "tracker rows": int((tp0 >= 0).sum()),
                        "tracker path": "frame loop" if bool(viol)
                        else "frame-parallel"})


def _port_peaks_float64(rcfg):
    """The port's float64 analysis peaks of the workload (the step's own)."""
    bank, scfg = _workload(SR, N)
    bank_args, av_args, av_kw = tchain._stage_analyze_vocode(
        interop.voicebank_from_numpy(bank), N, rcfg,
        tvocoder.VocoderParams(sample_rate=SR), CARRIER, scfg.block_size,
        torch.device("cpu"))
    freq, mag, _mix = tchain._analyze_vocode(*bank_args, *av_args, **av_kw)
    return freq.numpy(), mag.numpy()


NOISE_FLOOR_DB = -150.0


def test_tracker_data_matches_jax(steps, jax_float64):
    """The port's counts behind the tracker and render parts against the
    same counts of JAX's float64 peaks and table; the render's live pairs
    against cost.live_pairs of JAX's table; the tracker's part against its
    formula on JAX's counts. The valid peaks: the port's count is its own
    peaks' (the rule of device_tracker.valid_peaks), and the peaks above
    NOISE_FLOOR_DB are JAX's; below it the two float64 synths, which
    differ by ~6e-10 of their peak, decide which bins of the spectrum's
    rounding floor are local maxima (one peak of ~2275 here, at -171 dB
    against a -21 dB signal), and the tracker's min_volume drops them."""
    ca = steps["float64"]["ca"]
    want = dict(jax_float64["counts"])
    jax_valid, jax_loud = want.pop("tracker peaks"), want.pop("loud peaks")
    assert {key: ca[key] for key in want} == want
    assert 0 < want["tracker lanes"] < want["tracker rows"]
    freq, mag = _port_peaks_float64(steps["float64"]["rcfg"])
    valid = np.isfinite(mag) & (freq > 0) & np.isfinite(freq)
    assert ca["tracker peaks"] == int(valid.sum())
    assert int((valid & (mag > NOISE_FLOOR_DB)).sum()) == jax_loud > 0
    assert abs(ca["tracker peaks"] - jax_valid) <= int(
        (valid & (mag <= NOISE_FLOOR_DB)).sum())
    live = cost.live_pairs(torch.as_tensor(jax_float64["table"]),
                           stride=jax_float64["stride"], dtype="float64")
    assert ca["render live pairs"] == int(live.sum()) > 0
    peaks = ca["tracker peaks"]
    lanes, notes, rows = (want[f"tracker {key}"]
                          for key in ("lanes", "notes", "rows"))
    # per peak 7 + 2 transcendentals; per lane 15 + the ISO table's 29
    # points, and the frame-parallel 44 + 5; per note 33 + 2; per tail row
    # 19 + 1; each transcendental 11 operations
    assert ca["tracker flops"] == (
        peaks * (7 + 2 * 11) + lanes * (15 + 29 + 44 + 5 * 11)
        + notes * (33 + 2 * 11) + (rows - lanes) * (19 + 11))


def test_jax_render_of_dead_pairs_is_zero(jax_float64):
    """JAX's _render_slots of its own table: zero over the pairs
    cost.live_pairs counts dead, and the live pairs alone render the
    whole table's output exactly."""
    table, S = jax_float64["table"], jax_float64["stride"]
    live = cost.live_pairs(torch.as_tensor(table), stride=S,
                           dtype="float64").numpy()
    assert not live.all()
    default = trb._build_slot_tables([], 1, trb.TrackedRenderConfig(
        sample_rate=SR, stride=S))[0, 0]

    def render(t):
        return np.asarray(jrb._render_slots(t, stride=S, n_channels=2,
                                            dtype="float64"))

    dead_only, live_only = table.copy(), table.copy()
    dead_only[live] = default
    live_only[~live] = default
    assert not render(dead_only).any()
    np.testing.assert_array_equal(render(live_only), render(table))


@pytest.mark.parametrize("case", list(CASES))
def test_cost_analysis_leaves_step_unchanged(steps, case):
    st = steps[case]
    assert st["before"] == st["after"]
    syncs = st["syncs"]
    assert syncs[0] == syncs[1] == (0 if case.endswith("frame loop") else 1)


def test_compiled_text_lists_the_step_ops(steps):
    step = steps["df32"]["step"]
    text = step.compiled_text()
    lines = text.splitlines()
    assert lines and all(line.startswith("aten.") for line in lines)
    assert any(line.startswith("aten._fft_r2c") for line in lines)
    assert step.compiled_text() == text
    assert not hasattr(steps["float32"]["step"], "compiled_text")


def test_jax_cost_analysis_shares_the_keys(steps):
    bank, scfg = _workload(SR, N)
    jstep, _n = chain.prepare_offline_chain_device(
        bank, N, resynth.ResynthConfig(sample_rate=SR, dtype="float32"),
        vocoder.VocoderParams(sample_rate=SR), CARRIER,
        block_size=scfg.block_size)
    ref = jstep.cost_analysis()
    if isinstance(ref, (list, tuple)):
        ref = ref[0]
    got = steps["float32"]["ca"]
    for key in BENCH_KEYS:
        print(f"{key}: XLA:CPU (JAX program) {float(ref[key]):.6g}, "
              f"port (work the inputs need) {got[key]:.6g}")
        assert math.isfinite(float(ref[key])) and got[key] > 0
    assert set(BENCH_KEYS) <= set(ref) & set(got)
