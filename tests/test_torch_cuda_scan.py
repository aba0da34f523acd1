"""The device tracker's exact frame loop: the plain loop on the CPU and the
frame-loop kernel (ops/cuda_scan, csrc/tracker_scan.cu) on the card.

On the CPU (tier 1): device_tracker._scan_tables, and build_tables_device
with the loop forced, send CPU lanes to _scan_tables_plain, job by job,
with no kernel call, on the loop's fixtures (forced loop, voice-cap drops,
min_volume 0, stable draws); a batch equals its jobs one at a time; the
counters; the wrapper's refusals; the route (_tries_frame_parallel) across
devices, what _tables asks it and that every entry obeys it.
What the plain loop computes on those fixtures is held against the JAX
package's frame loop in
tests/test_torch_device_tracker.py (test_build_tables_matches_jax,
test_batch_matches_jax_and_single), which this file, run on the card
without JAX, does not import.

On the card (marked cuda, skipped elsewhere; the file imports neither jax
nor the JAX package):

    python -m pytest tests/test_torch_cuda_scan.py --noconftest -o addopts="" -q

the tracker's entries build every table with one kernel launch and no host
read (headline-like peaks: k = 128, P = 128, 127 voices), held against the
eager loop and, rendered, against the frame-parallel table; a batch's
tables equal its jobs' single calls to the bit; a shape the kernel does
not take raises, with no other path tried. Each kernel case is held
against the eager loop (_scan_tables_plain) run on the card: dropped
counts, which rows are the defaults row (the emit mask, so the slot each
note takes) equal; every float field within 1e-5 (float32)
or 1e-12 (float64) of that field's largest magnitude. The kernel rounds
each operation as the eager loop's ATen kernels do, so it is aimed at the
bit; the bars leave room for a last-ulp difference of a math-library call
carried through the phase and volume recurrences.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.models import resynth_bank as trb
from cpp_audio_tpu_torch.ops import cuda_scan
from cpp_audio_tpu_torch.utils import loudness, profiling
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)
from test_torch_cuda_kernels import cuda_card  # noqa: F401  (fixture)

LI = loudness.phons_to_index(60.0)
# tests/test_torch_device_tracker.py's keywords (TestParallelTracker._tables)
BASE_KW = dict(stride=512, sample_rate=44100.0, max_voices=12, n_slots=32,
               nearby_distance=0.5, min_volume=1e-6, max_track_pitches=1.0,
               pitch_method=2, volume_method=1, analysis_volume=1.0,
               shift_pre=0.0, shift_post=0.0, stereo_spread=0.8,
               attack=441.0, hold=0.0, decay=800.0, sustain=0.7,
               release=2000.0)
CASES = {
    # name -> (keywords over BASE_KW, peak lanes, frames)
    "forced": ({}, 16, 30),
    "cap_drop": (dict(max_voices=6), 16, 30),
    "min_volume_0": (dict(min_volume=0.0), 16, 30),
    "stable_draws": (dict(draw_indexing="stable"), 16, 30),
    "k128": (dict(max_voices=40, n_slots=48, sustain=1.0), 128, 40),
    "k256": (dict(max_voices=60, n_slots=64, harmonize_pre=7.0,
                  harmonize_semantics="merged"), 128, 40),
    "k512": (dict(max_voices=127, n_slots=128, harmonize_pre=7.0,
                  harmonize_post=12.0, harmonize_semantics="merged"), 128, 40),
}
CPU_CASES = ["forced", "cap_drop", "min_volume_0", "stable_draws"]
# headline-like: 128 peak lanes and slots, 127 voices, the headline's
# stride and envelope; _peaks(..., fade=12) does not set the frame-parallel
# tracker's violation flag
HEADLINE_KW = dict(BASE_KW, max_voices=127, n_slots=128, stride=3969,
                   attack=441.0, hold=100.0, decay=2000.0, release=8820.0)
HEADLINE_F = 60
# (device type, min_volume, force_scan) -> tries the frame-parallel
# tracker first
ROUTES = {
    "cpu": (("cpu", 1e-6, False), True),
    "cpu_forced": (("cpu", 1e-6, True), False),
    "cpu_min_volume_0": (("cpu", 0.0, False), False),
    "cuda": (("cuda", 1e-6, False), False),
    "cuda_forced": (("cuda", 1e-6, True), False),
    "cuda_min_volume_0": (("cuda", 0.0, False), False),
    "meta": (("meta", 1e-6, False), True),
}


def _peaks(seed, F, k, presence=0.75, fade=0):
    """Frequency-sorted peaks in clusters of 1-3 inside a few tenths of a
    semitone, gliding and appearing from frame to frame (each cluster in a
    frame with probability `presence`), NaN / -inf padded like the chain's
    analysis (tests/test_torch_device_tracker.py's _cluster_peaks, with
    glides and up to 60 peaks a frame). Over the last `fade` frames the
    clusters end from the highest down, a few a frame, as a take's notes
    end before its close."""
    rng = np.random.default_rng(seed)
    freq = np.full((F, k), np.nan)
    mag = np.full((F, k), -np.inf)
    n_bases = min(max(k // 3, 6), 30)
    bases = rng.uniform(80, 3000, n_bases)
    glide = rng.uniform(-0.15, 0.15, n_bases)
    ceiling = np.concatenate([np.full(F - fade, np.inf), np.geomspace(3200, 60, fade)])
    for f in range(F):
        fs = []
        for b, g in zip(bases, glide):
            if rng.random() < presence and b < ceiling[f]:
                for _ in range(int(rng.integers(1, 4))):
                    fs.append(b * 2 ** ((g * f + rng.uniform(-0.3, 0.3)) / 12))
        fs = np.unique(np.sort(fs))[:k]
        freq[f, :len(fs)] = fs
        mag[f, :len(fs)] = rng.uniform(-45, -8, len(fs))
    return freq, mag


def _pools(n, seed=1):
    return (np.random.default_rng(seed).uniform(-1, 1, n),
            np.random.default_rng(seed + 1).uniform(0, 2, n))


def scan_inputs(name, *, dtype=torch.float64, device="cpu", seeds=(7,)):
    """The frame loop's inputs for case `name`: (B, T, k) lanes of the
    frame-local stage (one job per seed), the analysis frames, the pools,
    the defaults row and the keywords."""
    over, k, F = CASES[name]
    kw = tdt._keywords(**dict(BASE_KW, total_frames=F + 6, **over))
    if name == "cap_drop":  # every frame saturated with 16 loud peaks
        peaks = [(np.tile(np.linspace(100, 3000, 16) * 2 ** (s / 100), (F, 1)),
                  np.full((F, 16), -20.0)) for s in seeds]
    else:
        peaks = [_peaks(s, F, k) for s in seeds]
    dev = torch.device(device)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    freq = as_t(np.stack([p[0] for p in peaks]))
    mag = as_t(np.stack([p[1] for p in peaks]))
    loud = (as_t(np.asarray(loudness.PITCHES)), as_t(np.asarray(loudness.ELVS[LI])))
    pan, phase = (as_t(p) for p in _pools(F * kw["max_voices"] + 16))
    tp, vol, order, _k = tdt._prep_lanes(freq, mag, *loud, None, kw)
    return tp, vol, order, F, pan, phase, tdt._default_row(dtype, dev), kw


def headline_inputs(seeds, *, dtype=torch.float32, device="cpu"):
    """Headline-like peaks of one job a seed, (B, F, 128), with the loudness
    tables and pools as tensors on `device`, and HEADLINE_KW's keywords."""
    peaks = [_peaks(s, HEADLINE_F, 128, fade=12) for s in seeds]
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    arrays = (as_t(np.stack([p[0] for p in peaks])), as_t(np.stack([p[1] for p in peaks])),
              as_t(np.asarray(loudness.PITCHES)), as_t(np.asarray(loudness.ELVS[LI])),
              *(as_t(p) for p in _pools(HEADLINE_F * 127 + 16)))
    return arrays, dict(HEADLINE_KW, total_frames=HEADLINE_F + 8)


def _refuse_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for CPU lanes")
    monkeypatch.setattr(cuda_scan, "scan_tables_cuda", refuse)


# --- CPU: the plain loop --------------------------------------------------

@pytest.mark.parametrize("name", CPU_CASES)
def test_cpu_lanes_take_the_plain_loop(monkeypatch, name):
    """CPU lanes go to _scan_tables_plain: its table and dropped count under
    a job axis, to the bit, with no kernel call or launch; the fixture
    emits notes (and drops some in the cap case)."""
    _refuse_kernel(monkeypatch)
    tp, vol, order, F, pan, phase, defaults, kw = scan_inputs(name)
    launches = cuda_scan.LAUNCHES
    table, dropped = tdt._scan_tables(tp, vol, order, F, pan, phase, defaults, kw)
    want_t, want_d = tdt._scan_tables_plain(tp[0], vol[0], order[0], F, pan,
                                            phase, defaults, kw)
    assert table.shape == (1, kw["total_frames"], kw["n_slots"], 16)
    assert dropped.shape == (1,)
    assert torch.equal(table[0], want_t)
    assert int(dropped[0]) == int(want_d)
    assert cuda_scan.LAUNCHES == launches
    emitted = ~(table == defaults).all(-1)
    assert int(emitted.sum()) > 50
    if name == "cap_drop":
        assert int(dropped[0]) > 0


@pytest.mark.parametrize("name", CPU_CASES)
def test_build_tables_device_forced_takes_the_plain_loop(monkeypatch, name):
    """build_tables_device(_force_scan=True) on CPU peaks: the plain loop's
    table and dropped count on the same lanes, one frame loop counted, no
    kernel call."""
    _refuse_kernel(monkeypatch)
    over, k, F = CASES[name]
    kw = tdt._keywords(**dict(BASE_KW, total_frames=F + 6, **over))
    if name == "cap_drop":
        freq = np.tile(np.linspace(100, 3000, 16), (F, 1))
        mag = np.full((F, 16), -20.0)
    else:
        freq, mag = _peaks(3, F, k)
    pan, phase = _pools(F * kw["max_voices"] + 16)
    loud = (np.asarray(loudness.PITCHES, np.float64),
            np.asarray(loudness.ELVS[LI], np.float64))
    loops = tdt.FRAME_LOOPS
    table, dropped = tdt.build_tables_device(freq, mag, *loud, pan, phase,
                                             device="cpu", _force_scan=True, **kw)
    assert tdt.FRAME_LOOPS == loops + 1
    dev = torch.device("cpu")
    f_t = torch.as_tensor(freq)
    cast = lambda a: torch.as_tensor(a, dtype=f_t.dtype)  # noqa: E731
    tp, vol, order, _k = tdt._prep_lanes(f_t, cast(mag), *map(cast, loud), None, kw)
    want_t, want_d = tdt._scan_tables_plain(tp, vol, order, F, cast(pan),
                                            cast(phase),
                                            tdt._default_row(f_t.dtype, dev), kw)
    assert torch.equal(table, want_t)
    assert int(dropped) == int(want_d)


def test_plain_batch_equals_single_jobs(monkeypatch):
    """(B, T, k) lanes on the CPU: each job's table and dropped count equal
    its own call, to the bit; FRAME_LOOPS rises by B."""
    _refuse_kernel(monkeypatch)
    tp, vol, order, F, pan, phase, defaults, kw = scan_inputs(
        "stable_draws", seeds=(4, 5, 6))
    loops = tdt.FRAME_LOOPS
    table, dropped = tdt._scan_tables(tp, vol, order, F, pan, phase, defaults, kw)
    assert tdt.FRAME_LOOPS == loops + 3
    assert table.shape[0] == 3 and dropped.shape == (3,)
    for b in range(3):
        one_t, one_d = tdt._scan_tables(tp[b:b + 1], vol[b:b + 1], order[b:b + 1], F,
                                        pan, phase, defaults, kw)
        assert torch.equal(table[b], one_t[0])
        assert int(dropped[b]) == int(one_d[0])
    assert tdt.FRAME_LOOPS == loops + 6
    assert not torch.equal(table[0], table[1])


def test_batch_builder_counts_every_job(monkeypatch):
    """build_tables_device_batch with min_volume 0 sends the whole batch
    down the loop in one call: FRAME_LOOPS rises by B."""
    _refuse_kernel(monkeypatch)
    F, B = 20, 3
    peaks = [_peaks(s, F, 16) for s in (11, 12, 13)]
    freq = np.stack([p[0] for p in peaks])
    mag = np.stack([p[1] for p in peaks])
    pan, phase = _pools(F * 12 + 16)
    loud = (np.asarray(loudness.PITCHES, np.float64),
            np.asarray(loudness.ELVS[LI], np.float64))
    kw = dict(BASE_KW, total_frames=F + 6, min_volume=0.0)
    loops, calls = tdt.FRAME_LOOPS, []
    plain = tdt._scan_tables

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return plain(*a, **k)

    monkeypatch.setattr(tdt, "_scan_tables", counted)
    tables, dropped = tdt.build_tables_device_batch(freq, mag, *loud, pan, phase,
                                                    device="cpu", **kw)
    assert calls == [B]
    assert tdt.FRAME_LOOPS == loops + B
    assert tables.shape == (B, F + 6, 32, 16) and dropped.shape == (B,)


@pytest.mark.parametrize("name", list(ROUTES))
def test_route(name):
    args, tries = ROUTES[name]
    assert tdt._tries_frame_parallel(*args) is tries


def test_tables_asks_the_route_of_the_call(monkeypatch):
    """_tables asks the route with the lanes' device type and the call's
    min_volume and force_scan, whatever the lanes and slots (here 128 peak
    lanes, pre-harmonize merged to 256, and 64 slots)."""
    asked = []
    route = tdt._tries_frame_parallel

    def recording(*a):
        asked.append(a)
        return route(*a)

    monkeypatch.setattr(tdt, "_tries_frame_parallel", recording)
    over, k, F = CASES["k256"]
    kw = dict(BASE_KW, total_frames=F + 6, **over)
    freq, mag = _peaks(3, F, k)
    pan, phase = _pools(F * kw["max_voices"] + 16)
    loud = (np.asarray(loudness.PITCHES, np.float64),
            np.asarray(loudness.ELVS[LI], np.float64))
    tdt.build_tables_device(freq, mag, *loud, pan, phase, device="cpu",
                            _force_scan=True, **kw)
    assert asked == [("cpu", 1e-6, True)]


@pytest.mark.parametrize("entry", ["single", "batch", "df"])
def test_entries_obey_the_route(monkeypatch, entry):
    """Where the route says no frame-parallel try (the card's choice,
    here on CPU lanes), every entry sends every job to _scan_tables in one
    call: no frame-parallel pass, no flag read, the plain loop's tables."""
    _refuse_kernel(monkeypatch)

    def no_parallel(*a, **k):
        raise AssertionError("the frame-parallel tracker ran")

    monkeypatch.setattr(tdt, "_parallel_tables", no_parallel)
    monkeypatch.setattr(tdt, "_tries_frame_parallel", lambda *a: False)
    seeds = (31, 32) if entry == "batch" else (31,)
    dtype = torch.float64 if entry == "df" else torch.float32
    (freq, mag, *arrays), kw = headline_inputs(seeds, dtype=dtype)
    syncs, loops = tdt.HOST_SYNCS, tdt.FRAME_LOOPS
    if entry == "batch":
        table, dropped = tdt.build_tables_device_batch(freq, mag, *arrays,
                                                       device="cpu", **kw)
    else:
        build = tdt.build_tables_device_df if entry == "df" else tdt.build_tables_device
        table, dropped = build(freq[0], mag[0], *arrays, device="cpu", **kw)
        table, dropped = table[None], dropped[None]
    assert (tdt.HOST_SYNCS - syncs, tdt.FRAME_LOOPS - loops) == (0, len(seeds))
    kw = tdt._keywords(**kw)
    tp, vol, order, _k = tdt._prep_lanes(freq, mag, *arrays[:2], None, kw)
    defaults = tdt._default_row(dtype, freq.device)
    for b in range(len(seeds)):
        want_t, want_d = tdt._scan_tables_plain(tp[b], vol[b], order[b], HEADLINE_F,
                                                *arrays[2:], defaults, kw)
        if entry == "df":
            want_t = tdt.split_increment(want_t)
        assert torch.equal(table[b], want_t)
        assert int(dropped[b]) == int(want_d) == 0


def test_headline_fixture_takes_the_frame_parallel_path_on_the_cpu():
    """The card tests' headline-like peaks: on the CPU the frame-parallel
    tracker takes them (one flag read, no frame loop), with notes on most
    slots' rows, and its table renders within 2e-3 of the peak of the
    loop's."""
    (freq, mag, *arrays), kw = headline_inputs((41,))
    syncs, loops = tdt.HOST_SYNCS, tdt.FRAME_LOOPS
    table, dropped = tdt.build_tables_device(freq[0], mag[0], *arrays, device="cpu",
                                             **kw)
    assert (tdt.HOST_SYNCS - syncs, tdt.FRAME_LOOPS - loops) == (1, 0)
    loop, _d = tdt.build_tables_device(freq[0], mag[0], *arrays, device="cpu",
                                       _force_scan=True, **kw)
    assert int(dropped) == 0
    assert int((~(table == tdt._default_row(table.dtype, table.device)).all(-1)).sum()) > 1000
    assert _render_gap(table, loop, kw["stride"]) < 2e-3


def test_dispatch_refuses_other_devices():
    tp, vol, order, F, pan, phase, defaults, kw = scan_inputs("forced")
    meta = [a.to("meta") for a in (tp, vol, order, pan, phase, defaults)]
    with pytest.raises(ValueError, match="no exact frame loop"):
        tdt._scan_tables(*meta[:3], F, *meta[3:], kw)


def test_scan_launches_is_a_span_counter():
    assert profiling.COUNTERS["scan_launches"]() == cuda_scan.LAUNCHES
    assert cuda_scan.Q == tdt._Q


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Type, shape, lane count and contiguity are checked before the
    device, so each refusal shows on CPU tensors too."""
    tp, vol, order, F, pan, phase, defaults, kw = scan_inputs(
        "forced", dtype=torch.float32)
    args = (tp, vol, order, F, pan, phase, defaults, kw)

    def call(**over):
        names = ("tp", "vol", "order", "F", "pan", "phase", "defaults", "kw")
        given = dict(zip(names, args), **over)
        return cuda_scan.scan_tables_cuda(*(given[n] for n in names))

    with pytest.raises(ValueError, match="not all on one CUDA device"):
        call()
    with pytest.raises(TypeError, match="float32 or float64"):
        call(tp=tp.half())
    with pytest.raises(TypeError, match="volume must be torch.float32"):
        call(vol=vol.double())
    with pytest.raises(TypeError, match="int64"):
        call(order=order.int())
    with pytest.raises(ValueError, match="contiguous"):
        call(tp=torch.zeros(1, tp.shape[1], 2 * tp.shape[2])[..., ::2])
    for k in (12, 520):
        wide = torch.zeros(1, tp.shape[1], k)
        with pytest.raises(ValueError, match="lanes in multiples of 8"):
            call(tp=wide, vol=wide.clone(), order=wide.long())
    with pytest.raises(ValueError, match="slots"):
        call(kw=dict(kw, n_slots=2000))
    with pytest.raises(ValueError, match="total_frames"):
        call(kw=dict(kw, total_frames=kw["total_frames"] + 1))


def test_scan_constants_are_the_working_types_roundings():
    """Every host scalar the kernel takes is a value of the working type;
    the reciprocals are formed in it, and sus - 1.0 in double first."""
    kw = dict(BASE_KW, total_frames=40)
    for dtype, w in ((torch.float32, np.float32), (torch.float64, np.float64)):
        c = cuda_scan.scan_constants(kw, dtype)
        assert c.dtype == np.float64 and c.shape == (21,)
        assert np.array_equal(c.astype(w).astype(np.float64), c)
        assert c[1] == float(w(1.0) / w(512.0))           # C_INV_S
        assert c[6] == float(w(1.0) / w(44100.0))         # C_INV_SR
        assert c[8] == float(w(0.7 - 1.0))                # C_SUS_M1
    ints = cuda_scan.scan_ints(dict(kw, draw_indexing="stable"), 30)
    assert ints.tolist() == [12, 40, 30, 1, 1]


def _render_gap(got, want, stride):
    """max |render(got) - render(want)| over the peak of render(want)."""
    outs = [trb._render_slots(t, stride=stride, dtype="float32").reshape(-1, 2)
            for t in (got, want)]
    peak = float(outs[1].abs().max())
    assert peak > 1e-3
    return float((outs[0] - outs[1]).abs().max()) / peak


# --- on the card ---------------------------------------------------------

def _to(dev, inputs):
    tp, vol, order, F, pan, phase, defaults, kw = inputs
    return (tp.to(dev), vol.to(dev), order.to(dev), F, pan.to(dev), phase.to(dev),
            defaults.to(dev), kw)


def _hold(got_t, got_d, want_t, want_d, defaults, bar):
    """Dropped counts and emit masks equal; float fields within `bar` of
    each field's largest magnitude. Returns the largest relative gap."""
    assert torch.equal(got_d.cpu(), want_d.cpu())
    got_t, want_t = got_t.cpu(), want_t.cpu()
    defaults = defaults.cpu()
    assert torch.equal((got_t == defaults).all(-1), (want_t == defaults).all(-1))
    scale = want_t.abs().amax(dim=(0, 1, 2)).clamp(min=1e-30)
    gap = ((got_t - want_t).abs().amax(dim=(0, 1, 2)) / scale).max()
    assert float(gap) <= bar, float(gap)
    return float(gap)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_matches_the_eager_loop(cuda_card, dtype, name):
    inputs = _to(cuda_card, scan_inputs(name, dtype=dtype))
    tp, vol, order, F, pan, phase, defaults, kw = inputs
    expect_k = {"k256": 256, "k512": 512}.get(name, tp.shape[-1])
    assert tp.shape[-1] == expect_k
    launches = cuda_scan.LAUNCHES
    got_t, got_d = tdt._scan_tables(*inputs)
    assert cuda_scan.LAUNCHES == launches + 1
    want_t, want_d = tdt._scan_tables_plain(tp[0], vol[0], order[0], F, pan, phase,
                                            defaults, kw)
    torch.cuda.synchronize()
    _hold(got_t[0], got_d[0], want_t, want_d, defaults,
          1e-5 if dtype == torch.float32 else 1e-12)
    emitted = ~(want_t.cpu() == defaults.cpu()).all(-1)
    assert int(emitted.sum()) > 50
    if name == "cap_drop":
        assert int(got_d[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_batch_equals_single_launches(cuda_card, dtype):
    """A batch of 4 jobs in one launch: each job's table and dropped count
    equal its own launch, to the bit."""
    tp, vol, order, F, pan, phase, defaults, kw = _to(
        cuda_card, scan_inputs("k128", dtype=dtype, seeds=(21, 22, 23, 24)))
    launches = cuda_scan.LAUNCHES
    table, dropped = tdt._scan_tables(tp, vol, order, F, pan, phase, defaults, kw)
    assert cuda_scan.LAUNCHES == launches + 1
    for b in range(4):
        one_t, one_d = tdt._scan_tables(tp[b:b + 1].contiguous(),
                                        vol[b:b + 1].contiguous(),
                                        order[b:b + 1].contiguous(), F, pan, phase,
                                        defaults, kw)
        assert torch.equal(table[b], one_t[0])
        assert torch.equal(dropped[b], one_d[0])
    assert cuda_scan.LAUNCHES == launches + 5


@pytest.mark.cuda
def test_kernel_refuses_on_the_card(cuda_card):
    tp, vol, order, F, pan, phase, defaults, kw = _to(
        cuda_card, scan_inputs("forced", dtype=torch.float32))
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_scan.scan_tables_cuda(tp, vol.cpu(), order, F, pan, phase, defaults, kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_scan.scan_tables_cuda(tp.expand(2, -1, -1), vol.expand(2, -1, -1),
                                   order.expand(2, -1, -1), F, pan, phase, defaults, kw)
    lib = cuda_scan.load_library()
    assert lib.tracker_scan_q() == cuda_scan.Q
    assert lib.tracker_scan_n_constants() == len(cuda_scan.scan_constants(kw, tp.dtype))


@pytest.mark.cuda
def test_staging_loads_the_library(cuda_card):
    """The chain's tracker staging loads the kernel's library, so no job
    builds or loads it."""
    cuda_scan.load_library.cache_clear()
    rconfig = tresynth.ResynthConfig(sample_rate=44100)
    tchain._tracker_inputs(rconfig, tresynth._render_config(rconfig), 20, None,
                           torch.float32, cuda_card)
    assert cuda_scan.load_library.cache_info().currsize == 1


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["single", "df"])
def test_card_builds_the_table_in_one_launch(cuda_card, monkeypatch, entry):
    """build_tables_device (float32) and build_tables_device_df (float64)
    on headline-like peaks on the card: exactly 1 kernel launch, no host
    read, one frame loop and no frame-parallel pass; the table is the eager
    loop's on the card within the file's bars, and renders within 2e-3 of
    the peak of the frame-parallel table's render (chip_smoke phase 5's
    bar)."""
    dtype = torch.float64 if entry == "df" else torch.float32
    (freq, mag, *arrays), kw = headline_inputs((41,), dtype=dtype, device=cuda_card)
    parallel = tdt._parallel_tables

    def no_parallel(*a, **k):
        raise AssertionError("the frame-parallel tracker ran on the card")

    monkeypatch.setattr(tdt, "_parallel_tables", no_parallel)
    build = tdt.build_tables_device_df if entry == "df" else tdt.build_tables_device
    launches, syncs, loops = cuda_scan.LAUNCHES, tdt.HOST_SYNCS, tdt.FRAME_LOOPS
    table, dropped = build(freq[0], mag[0], *arrays, device=cuda_card, **kw)
    assert (cuda_scan.LAUNCHES - launches, tdt.HOST_SYNCS - syncs,
            tdt.FRAME_LOOPS - loops) == (1, 0, 1)
    if entry == "df":  # fields 0 and 16 are the increment's two parts
        table = torch.cat([(table[..., :1] + table[..., 16:]), table[..., 1:16]], dim=-1)
    kw = tdt._keywords(**kw)
    tp, vol, order, _k = tdt._prep_lanes(freq[0], mag[0], *arrays[:2], None, kw)
    defaults = tdt._default_row(dtype, freq.device)
    want_t, want_d = tdt._scan_tables_plain(tp, vol, order, HEADLINE_F, *arrays[2:],
                                            defaults, kw)
    torch.cuda.synchronize()
    _hold(table, dropped, want_t, want_d, defaults,
          1e-5 if dtype == torch.float32 else 1e-12)
    par_t, viol = parallel(tp, vol, order, HEADLINE_F, *arrays[2:], defaults, kw)
    assert not bool(viol) and int(dropped) == 0
    assert _render_gap(table.float(), par_t.float(), kw["stride"]) < 2e-3


@pytest.mark.cuda
def test_card_batch_tables_equal_single_calls(cuda_card):
    """build_tables_device_batch on the card: one launch and no host read
    for 4 jobs, each job's table and dropped count equal to the bit to its
    own build_tables_device call."""
    seeds = (41, 42, 43, 44)
    (freq, mag, *arrays), kw = headline_inputs(seeds, device=cuda_card)
    launches, syncs, loops = cuda_scan.LAUNCHES, tdt.HOST_SYNCS, tdt.FRAME_LOOPS
    tables, dropped = tdt.build_tables_device_batch(freq, mag, *arrays,
                                                    device=cuda_card, **kw)
    assert (cuda_scan.LAUNCHES - launches, tdt.HOST_SYNCS - syncs,
            tdt.FRAME_LOOPS - loops) == (1, 0, len(seeds))
    for b in range(len(seeds)):
        one_t, one_d = tdt.build_tables_device(freq[b], mag[b], *arrays,
                                               device=cuda_card, **kw)
        assert torch.equal(tables[b], one_t)
        assert torch.equal(dropped[b], one_d)
    assert tdt.HOST_SYNCS == syncs
    assert not torch.equal(tables[0], tables[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["slots_513", "lanes_544"])
def test_card_refuses_a_shape_the_kernel_does_not_take(cuda_card, monkeypatch, shape):
    """A tracker call on the card whose shape the frame-loop kernel does
    not take (513 slots; 136 peak lanes harmonized twice, merged: 544)
    raises the wrapper's refusal: the frame-parallel tracker is not tried
    in its place and nothing is read on the host."""
    def no_parallel(*a, **k):
        raise AssertionError("the frame-parallel tracker ran on the card")

    monkeypatch.setattr(tdt, "_parallel_tables", no_parallel)
    (freq, mag, *arrays), kw = headline_inputs((41,), device=cuda_card)
    freq, mag = freq[0], mag[0]
    if shape == "slots_513":
        kw = dict(kw, n_slots=513)
    else:
        freq = torch.nn.functional.pad(freq, (0, 8), value=float("nan"))
        mag = torch.nn.functional.pad(mag, (0, 8), value=-float("inf"))
        kw = dict(kw, harmonize_pre=7.0, harmonize_post=12.0,
                  harmonize_semantics="merged")
    syncs = tdt.HOST_SYNCS
    with pytest.raises(ValueError, match="the kernel takes"):
        tdt.build_tables_device(freq, mag, *arrays, device=cuda_card, **kw)
    assert tdt.HOST_SYNCS == syncs
