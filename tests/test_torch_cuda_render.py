"""The tracked-note render kernel (ops/cuda_render, csrc/tracked_render.cu)
against its plain twin, models/resynth_bank._render_slots_plain.

On the CPU (tier 1): the twin of the kernel's per-tile live-slot selection,
resynth_bank.live_slots over a tile's samples, against analysis/cost
.live_pairs, and the render of only each tile's selected slots against the
whole render (equal to the bit); the dispatch of _render_slots.

On the card (marked cuda, skipped elsewhere; the file imports neither jax
nor the JAX package):

    python -m pytest tests/test_torch_cuda_render.py --noconftest -o addopts="" -q

Bars, the kernel against the plain render of the same table on the CPU:
  - float64: 1e-12 of the peak (the same closed forms; libm against
    libdevice in the last ulp of expm1, exp, log1p and sin, and the
    mixdown's summation order);
  - float32 without glides, and the 17-field table's float32 render (its
    phase computed in float64): atol 5e-5, the steady bar of
    tests/test_torch_resynth_bank.py (the phase rounds the same; FMA
    contraction in the volume, the polynomial and the mixdown, the
    summation order, and the exp / log1p ulps of the two libraries);
  - float32 with glides: 1e-3 of the peak. The phase advance
    (inc/lam) expm1(lam (k+1)) reaches ~720 rad/pi in a frame at 4 kHz,
    where one float32 ulp of it is 6e-5 rad/pi; one ulp of expm1 in either
    library moves a voice by up to ~2e-4 of full scale. The kernel is
    also held against the float64 render at the bar
    tests/test_torch_resynth_bank.py holds the float32 eager render to:
    no further from it than 1.5x the plain float32 render is, + 1e-6.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu_torch.analysis import cost
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.models import resynth_bank as trb
from cpp_audio_tpu_torch.ops import cuda_render as cr
from cpp_audio_tpu_torch.ops import envelopes
from cpp_audio_tpu_torch.utils import profiling
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)
from test_torch_cuda_kernels import cuda_card  # noqa: F401  (fixture)

SR = 44100
CASES = [("float32", 16), ("float64", 16), ("float32", 17)]
CASE_IDS = ["f32", "f64", "f32-df"]


def _notes(n_frames, *, seed, glide, n_notes=24):
    rng = np.random.default_rng(seed)
    notes = []
    for _ in range(n_notes):
        f0 = int(rng.integers(0, n_frames - 2))
        f = float(rng.uniform(80, 4000))
        trail = []
        for c in range(f0, min(n_frames, f0 + int(rng.integers(1, 8)))):
            if glide:
                f *= float(2 ** (rng.uniform(-0.5, 0.5) / 12))  # sub-semitone
            trail.append((c, f, float(rng.uniform(0.01, 0.3))))
        rel = trail[-1][0] + 1 if rng.uniform() < 0.8 else trb.NEVER_FRAME
        notes.append(trb.TrackedNote(frames=trail, release_frame=rel,
                                     pan=float(rng.uniform(-1, 1))))
    return notes


def slot_table(stride, *, glide=True, seed=0, n_frames=14, n_slots=32,
               n_fields=16):
    """A float64 slot table of the host packer (attack, hold, decay to 0.6,
    a release of 2500 samples: tails that end inside a frame's later tiles,
    empty slots), whose last six slots of every frame are overwritten with
    rows pressed, or released, on the kernel's first tile edge and one
    sample either side of it. With n_fields 17, the fidelity chain's table
    (device_tracker.split_increment)."""
    a = envelopes.AHDSR(attack=300, hold=100, decay=1500, release=2500,
                        sustain=0.6)
    cfg = trb.TrackedRenderConfig(sample_rate=SR, stride=stride, ahdsr=a,
                                  n_slots=n_slots)
    table = torch.from_numpy(trb._build_slot_tables(
        _notes(n_frames - 4, seed=seed, glide=glide), n_frames, cfg))
    written = (table[..., trb._F_TP0] >= 0).nonzero().tolist()
    src = table[written[len(written) // 2][0], written[len(written) // 2][1]].clone()
    src[trb._F_TOP] = 0.6
    for f in range(n_frames):
        for i, d in enumerate((-1, 0, 1)):
            e = cr.KERNEL_TILE + d
            pressed = src.clone()   # pressed at e, released 700 samples on
            pressed[trb._F_TP0], pressed[trb._F_TR0] = -e, -(e + 700)
            released = src.clone()  # pressed long before, released at e
            released[trb._F_TP0], released[trb._F_TR0] = 50_000.0, -e
            table[f, n_slots - 1 - 2 * i] = pressed
            table[f, n_slots - 2 - 2 * i] = released
    return tdt.split_increment(table) if n_fields == trb.N_FIELDS_DF else table


def _tiles(stride, tile=cr.KERNEL_TILE):
    return [(k0, min(k0 + tile, stride)) for k0 in range(0, stride, tile)]


# --- CPU: the twin of the kernel's per-tile selection --------------------

@pytest.mark.parametrize("stride", [3969, 1500], ids=["headline", "ragged"])
@pytest.mark.parametrize("dtype,n_fields", CASES, ids=CASE_IDS)
def test_tile_selection_implies_live_pairs(dtype, n_fields, stride):
    """A slot selected in any tile of a frame is live in that frame
    (cost.live_pairs), and a live pair is selected in some tile of it."""
    table = slot_table(stride, n_fields=n_fields)
    whole = cost.live_pairs(table, stride=stride, dtype=dtype)
    union = torch.zeros_like(whole)
    for k0, k1 in _tiles(stride):
        sel = trb.live_slots(table, stride=stride, dtype=dtype, k_lo=k0, k_hi=k1)
        assert not bool((sel & ~whole).any())
        union |= sel
    assert torch.equal(union, whole)
    assert 0 < int(whole.sum()) < whole.numel()
    # the tiles drop pairs: some tail ends, or press, inside the frame
    n_sel = sum(int(trb.live_slots(table, stride=stride, dtype=dtype, k_lo=k0,
                                   k_hi=k1).sum()) for k0, k1 in _tiles(stride))
    assert n_sel < len(_tiles(stride)) * int(whole.sum())


@pytest.mark.parametrize("stride", [3969, 1500], ids=["headline", "ragged"])
@pytest.mark.parametrize("dtype,n_fields", CASES + [("float64", 17)],
                         ids=CASE_IDS + ["f64-df"])
def test_tiles_selected_slots_render_the_whole(dtype, n_fields, stride):
    """Rendering, tile by tile, only the tile's selected slots (the others'
    gains zeroed) gives the whole render's samples of the tile, to the
    bit: a slot left out renders exact zeros over the tile."""
    table = slot_table(stride, n_fields=n_fields, seed=1)
    whole = trb._render_slots_plain(table, stride=stride, dtype=dtype)
    assert float(whole.abs().max()) > 0.05
    for k0, k1 in _tiles(stride):
        sel = trb.live_slots(table, stride=stride, dtype=dtype, k_lo=k0, k_hi=k1)
        only = table.clone()
        only[..., trb._F_GL:trb._F_GR + 1] *= sel[..., None].to(only.dtype)
        part = trb._render_slots_plain(only, stride=stride, dtype=dtype)
        assert torch.equal(part[:, k0:k1], whole[:, k0:k1])
        dropped = table.clone()
        dropped[..., trb._F_GL:trb._F_GR + 1] *= (~sel)[..., None].to(only.dtype)
        rest = trb._render_slots_plain(dropped, stride=stride, dtype=dtype)
        assert not bool(rest[:, k0:k1].any())


def test_render_dispatches_cpu_tables_to_the_plain_render(monkeypatch):
    """CPU tables take _render_slots_plain and never the kernel; a device
    with no renderer raises."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for a CPU table")
    monkeypatch.setattr(cr, "render_slots_cuda", refuse)
    table = slot_table(700, n_frames=8, n_slots=16)
    before = cr.LAUNCHES
    for dtype in ("float32", "float64"):
        got = trb._render_slots(table, stride=700, dtype=dtype)
        assert torch.equal(got, trb._render_slots_plain(table, stride=700, dtype=dtype))
    assert cr.LAUNCHES == before
    with pytest.raises(ValueError, match="no tracked-note renderer"):
        trb._render_slots(table.to("meta"), stride=700, dtype="float32")


def test_render_launches_is_a_span_counter():
    assert profiling.COUNTERS["render_launches"]() == cr.LAUNCHES


def test_wrapper_refuses_cpu_tables():
    with pytest.raises(ValueError, match="not a CUDA device"):
        cr.render_slots_cuda(torch.zeros((2, 4, 16)), stride=16,
                             dtype=torch.float32)


# --- on the card ---------------------------------------------------------

def _kernel_and_plain(table, stride, dtype, dev):
    launches = cr.LAUNCHES
    got = trb._render_slots(table.to(dev), stride=stride, dtype=dtype)
    assert cr.LAUNCHES == launches + 1
    torch.cuda.synchronize()
    want = trb._render_slots_plain(table, stride=stride, dtype=dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    return got.cpu(), want


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [3969, 1500], ids=["headline", "ragged"])
@pytest.mark.parametrize("glide", [False, True], ids=["steady", "glides"])
@pytest.mark.parametrize("dtype,n_fields", CASES, ids=CASE_IDS)
def test_kernel_matches_plain(cuda_card, dtype, n_fields, glide, stride):
    # the ragged case's 150 slots take two of the kernel's 128-slot chunks
    table = slot_table(stride, glide=glide, n_fields=n_fields, seed=2,
                       n_slots=150 if stride == 1500 else 32)
    got, want = _kernel_and_plain(table, stride, dtype, cuda_card)
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    assert peak > 0.05
    if dtype == "float64":
        assert err <= 1e-12 * peak, err
    elif glide and n_fields == trb.N_FIELDS:
        assert err <= 1e-3 * peak, err
    else:
        assert err <= 5e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [3969, 1500], ids=["headline", "ragged"])
def test_kernel_float32_as_close_to_float64_as_plain(cuda_card, stride):
    """The float32 kernel with glides is no further from the float64 render
    than the plain float32 render is (x1.5, + 1e-6)."""
    table = slot_table(stride, seed=3)
    got, plain = _kernel_and_plain(table, stride, "float32", cuda_card)
    exact = trb._render_slots_plain(table, stride=stride, dtype="float64")
    err_kernel = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err_kernel <= 1.5 * err_plain + 1e-6, (err_kernel, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n_fields", CASES, ids=CASE_IDS)
def test_kernel_job_axis(cuda_card, dtype, n_fields):
    """A batch of jobs in one launch: each job's slice equals, to the bit,
    the launch of that job alone."""
    tables = [slot_table(3969, n_fields=n_fields, seed=s) for s in (4, 5, 6)]
    batch = torch.stack(tables).to(cuda_card)
    launches = cr.LAUNCHES
    out = trb._render_slots(batch, stride=3969, dtype=dtype)
    assert cr.LAUNCHES == launches + 1
    assert out.shape == (3, 14, 3969, 2)
    for j, t in enumerate(tables):
        assert torch.equal(out[j], trb._render_slots(t.to(cuda_card), stride=3969,
                                                     dtype=dtype))
    assert cr.LAUNCHES == launches + 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n_fields", CASES, ids=CASE_IDS)
def test_kernel_dead_only_table_renders_zeros(cuda_card, dtype, n_fields):
    """The pairs cost.live_pairs counts dead render exact zeros; so does a
    table of empty slots."""
    table = slot_table(3969, n_fields=n_fields, seed=7)
    live = cost.live_pairs(table, stride=3969, dtype=dtype)
    dead_only = table.clone()
    dead_only[..., trb._F_GL:trb._F_GR + 1] *= (~live)[..., None].to(table.dtype)
    out = trb._render_slots(dead_only.to(cuda_card), stride=3969, dtype=dtype)
    assert int(torch.count_nonzero(out)) == 0
    empty = torch.from_numpy(trb._build_slot_tables(
        [], 5, trb.TrackedRenderConfig(sample_rate=SR, stride=3969)))
    if n_fields == trb.N_FIELDS_DF:
        empty = tdt.split_increment(empty)
    out = trb._render_slots(empty.to(cuda_card), stride=3969, dtype=dtype)
    assert out.shape == (5, 3969, 2) and int(torch.count_nonzero(out)) == 0


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_card):
    t16 = torch.zeros((3, 8, 16), device=cuda_card)
    f32, f64 = torch.float32, torch.float64
    with pytest.raises(ValueError, match="not a CUDA device"):
        cr.render_slots_cuda(t16.cpu(), stride=64, dtype=f32)
    with pytest.raises(TypeError, match="float32 or float64"):
        cr.render_slots_cuda(t16.half(), stride=64, dtype=torch.float16)
    with pytest.raises(TypeError, match="must be torch.float32"):
        cr.render_slots_cuda(t16.double(), stride=64, dtype=f32)
    with pytest.raises(TypeError, match="must be torch.float64"):
        cr.render_slots_cuda(torch.zeros((3, 8, 17), device=cuda_card), stride=64,
                             dtype=f32)
    for shape in ((3, 8, 15), (3, 8, 18), (8, 16), (1, 1, 3, 8, 16)):
        with pytest.raises(ValueError, match="16- or 17-field"):
            cr.render_slots_cuda(torch.zeros(shape, device=cuda_card), stride=64,
                                 dtype=f32)
    with pytest.raises(ValueError, match="contiguous"):
        cr.render_slots_cuda(torch.zeros((8, 3, 16), device=cuda_card).transpose(0, 1),
                             stride=64, dtype=f32)
    with pytest.raises(ValueError, match="positive"):
        cr.render_slots_cuda(t16, stride=0, dtype=f32)
    assert cr.load_library().tracked_render_tile() == cr.KERNEL_TILE


@pytest.mark.cuda
def test_kernel_counts_one_launch_a_call(cuda_card):
    table = slot_table(3969, n_frames=8).to(cuda_card)
    before = cr.LAUNCHES
    for i in range(3):
        trb._render_slots(table, stride=3969, dtype="float32")
        assert cr.LAUNCHES == before + i + 1
    assert profiling.COUNTERS["render_launches"]() == cr.LAUNCHES
