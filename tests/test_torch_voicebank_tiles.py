"""The voice-bank kernel's per-tile live-row selection, in plain PyTorch.

csrc/voicebank.cu renders each KERNEL_TILE-sample tile from the rows that
can sound in it. `cuda_voicebank.tile_live_rows` is that selection with the
kernel's int32 offsets and float compares, and `render_blocks_tiled_plain`
renders through it. Here, on the CPU:
  - rows left out of a tile render exact zeros there, and the rows on a
    tile edge (press, and last sounding sample, one sample either side)
    fall on the side the per-sample envelope puts them;
  - the tiled render equals the dense plain render to atol 1e-6 (only the
    mixdown's summation order differs) and the JAX package's
    voicebank_blocks_compact_impl to atol 2e-5 (tests/test_pallas_voicebank.py:45);
  - the closed-form segment counts behind the kernel's bound equal a count
    of the per-sample envelope compares.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.models import voicebank
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.models import voicebank as tvb
from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
from test_torch_cuda_kernels import edge_tables  # and caps torch's threads
from test_torch_voicebank import make_bank


ATOL = 2e-5
EXACT_ORDER = 1e-6  # the same terms summed in another order


def test_tile_edges_and_kernel_tile():
    assert cv.tile_edges(3000) == [(0, 1024), (1024, 2048), (2048, 3000)]
    assert cv.tile_edges(2048) == [(0, 1024), (1024, 2048)]
    assert cv.tile_edges(100, 64) == [(0, 64), (64, 100)]


@pytest.mark.parametrize("block_size", [4096, 3000], ids=["tiled", "ragged"])
def test_edge_rows_fall_where_the_envelope_puts_them(block_size):
    (fp, ip, up, gains, codes), st, E = edge_tables(block_size)
    kinds = sorted(set(torch.unique(codes).tolist()))
    # rows of edge_tables: 0, 2, 4 pressed at E-1, E, E+1; 1, 3, 5 sounding
    # last at E-2, E-1, E; 6-8 skipped. E is sample 1024 of block 1.
    before = cv.tile_live_rows(fp, ip, b=1, block_size=block_size, k0=0, k1=1024)
    after = cv.tile_live_rows(fp, ip, b=1, block_size=block_size, k0=1024, k1=2048)
    assert before.tolist() == [0, 1, 3, 5]   # pressed by E-1; every tail
    assert after.tolist() == [0, 2, 4, 5]    # every press; the tail reaching E
    # every row left out renders exact zeros in its tile, every row kept
    # sounds in it; the rows on the edge sound on their side of it
    tables = (fp, ip, up, gains, codes)
    for (k0, k1), live in (((0, 1024), before), ((1024, 2048), after)):
        for v in range(fp.shape[0]):
            one = _render_rows(1, tables, [v], block_size, kinds, k0, k1)
            if v in live.tolist():
                assert float(one.abs().max()) > 0
            else:
                assert bool((one == 0).all())
    for v, k in ((0, 1023), (1, 1022), (2, 1024), (3, 1023), (4, 1025), (5, 1024)):
        sample = _render_rows(1, tables, [v], block_size, kinds, k, k + 1)
        assert float(sample.abs().max()) > 0, (v, k)
    for v, k in ((0, 1022), (1, 1023), (2, 1023), (3, 1024), (4, 1024), (5, 1025)):
        sample = _render_rows(1, tables, [v], block_size, kinds, k, k + 1)
        assert bool((sample == 0).all()), (v, k)


def _render_rows(b, tables, rows, block_size, kinds, k0, k1):
    idx = torch.tensor(rows)
    return cv._render_block_plain(b, *(t[idx] for t in tables),
                                  block_size=block_size, kinds=kinds, k0=k0, k1=k1)


@pytest.mark.parametrize("block_size", [4096, 3000], ids=["tiled", "ragged"])
@pytest.mark.parametrize("n_channels", [1, 2])
def test_tiled_matches_dense_on_edges(block_size, n_channels):
    args, st, _ = edge_tables(block_size, n_channels)
    dense = cv.render_blocks_plain(*cv.one_job(args), **st)[0]
    tiled = cv.render_blocks_tiled_plain(*cv.one_job(args), **st)[0]
    assert tiled.shape == dense.shape == (4 * block_size, n_channels)
    assert float(dense.abs().max()) > 0.05
    np.testing.assert_allclose(tiled.numpy(), dense.numpy(), atol=EXACT_ORDER)
    assert bool((tiled[3 * block_size:] == 0).all())  # the empty block
    cargs, cst = tvb.compact_block_args(args, st)
    np.testing.assert_allclose(cv.render_blocks_tiled_plain(*cv.one_job(cargs), **cst)[0].numpy(),
                               dense.numpy(), atol=EXACT_ORDER)


@pytest.mark.parametrize("eased", [False, True], ids=["linear", "eased23"])
@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_tiled_matches_jax_compact(eased, layout):
    import jax.numpy as jnp

    n, B = 24576, 4096
    bank = make_bank(46 if eased else 8, eased=eased, seed=1)
    args, st = voicebank.prepare_bank_arrays(bank, n, B, "float32")
    cargs, cst = voicebank.compact_block_args(args, st)
    ref = np.asarray(voicebank.voicebank_blocks_compact_impl(
        *(jnp.asarray(a) for a in cargs), block_size=B, n_blocks=cst["n_blocks"],
        a_itp=cst["a_itp"], d_itp=cst["d_itp"], r_itp=cst["r_itp"],
        out_dtype="float32")).reshape(-1, 2)[:n]
    pargs, pst = tvb.prepare_bank_arrays(interop.voicebank_from_numpy(bank), n,
                                         B, device="cpu")
    if layout == "compact":
        pargs, pst = tvb.compact_block_args(pargs, pst)
    got = cv.render_blocks_tiled_plain(*cv.one_job(pargs), **pst)[0].numpy()[:n]
    np.testing.assert_allclose(got, ref, atol=ATOL)
    dense = cv.render_blocks_plain(*cv.one_job(pargs), **pst)[0].numpy()[:n]
    np.testing.assert_allclose(got, dense, atol=EXACT_ORDER)
    assert np.abs(ref).max() > 0.1


def _brute_segments(fp, ip, block_size, n_blocks):
    """Per-sample envelope compares (float32, as the kernel), counted."""
    counts = dict.fromkeys(cv.SEGMENTS, 0)
    k = torch.arange(block_size, dtype=torch.float32)[None, :]
    for b in range(n_blocks):
        f = fp[b] if fp.dim() == 3 else fp
        i = ip[b] if ip.dim() == 3 else ip
        keep = ~(f[:, 7] > 0.5)
        f, i = f[keep], i[keep]
        A, H, D, R = (f[:, j:j + 1] for j in (1, 2, 3, 4))
        tp = cv._wrap_i32(b * block_size - i[:, 0:1].long()).float() + k
        trm = cv._wrap_i32(b * block_size - i[:, 1:2].long()).float() + k
        pressed = ~(tp < 0) & (trm < 0)
        counts["attack"] += int((pressed & (tp < A)).sum())
        counts["hold"] += int((pressed & ~(tp < A) & (tp < A + H)).sum())
        counts["decay"] += int((pressed & ~(tp < A + H) & (tp < A + H + D)).sum())
        counts["sustain"] += int((pressed & ~(tp < A + H + D)).sum())
        counts["release"] += int((~(tp < 0) & ~(trm < 0) & (trm + 1 < R)).sum())
    return counts


@pytest.mark.parametrize("case", ["edges", "bank_dense", "bank_compact"])
def test_segment_counts_match_the_envelope(case):
    if case == "edges":
        (fp, ip, *_), st, _ = edge_tables(3000)
    else:
        bank = make_bank(46, eased=True, seed=4)
        args, st = tvb.prepare_bank_arrays(interop.voicebank_from_numpy(bank),
                                           20000, 2048, device="cpu")
        if case == "bank_compact":
            args, st = tvb.compact_block_args(args, st)
        fp, ip = args[0], args[1]
    got = cv.segment_voice_samples(fp[None], ip[None], **st)
    assert got == _brute_segments(fp, ip, st["block_size"], st["n_blocks"])
    assert got["sustain"] > 0 and got["release"] > 0 and got["attack"] > 0


def test_chain_renders_dense_tables(monkeypatch):
    """The chain no longer compacts on the host: the kernel selects rows."""
    def refuse(*a, **k):
        raise AssertionError("the chain must not compact the tables")

    monkeypatch.setattr(tvb, "compact_block_args", refuse)
    bank = make_bank(6, seed=5)
    n = 20000
    res = tchain.run_offline_chain(
        interop.voicebank_from_numpy(bank), n,
        tchain.resynth_mod.ResynthConfig(sample_rate=44100, dtype="float32"),
        tchain.vocoder_mod.VocoderParams(sample_rate=44100),
        np.sign(np.sin(2 * np.pi * 110.0 * np.arange(n) / 44100)),
        block_size=4096, device="cpu")
    assert bool(torch.isfinite(res.vocoded).all())


def test_kernel_bound_counts_the_live_work():
    (fp, ip, *_), st, _ = edge_tables(3000)
    counts = cv.segment_voice_samples(fp[None], ip[None], **st)
    bound = cv.kernel_bound(fp[None], ip[None], n_channels=2, **st)
    assert bound["segments"] == counts
    assert bound["live_voice_samples"] == sum(counts.values())
    flops = sum(n * (15 + cv._SEGMENT_FLOPS[s]) for s, n in counts.items())
    assert bound["flops"] == flops
    assert bound["bytes"] == 9 * (68 + 8) + 4 * 3000 * 2 * 4
    t_ops, t_bytes = flops / 67e12, bound["bytes"] / 3.35e12
    assert bound["bound_ms"] == pytest.approx(max(t_ops, t_bytes) * 1e3)
    assert bound["bound_by"] == ("operations" if t_ops >= t_bytes else "bytes")
