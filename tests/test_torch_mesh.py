"""The port's device mesh (cpp_audio_tpu_torch/parallel/mesh.py): the
voice-sharded renderer and the frame-sharded and halo STFTs, against the JAX
package's (cpp_audio_tpu/parallel/mesh.py on its virtual CPU devices) and
the port's single-device functions; the voice bank's block_offset against
JAX's voicebank_blocks_impl(block_offset=); the launcher.

The port's ranks are processes on CPU gloo, spawned once per world size for
the whole file (parallel/launch.spawn with run_calls: the ranks import the
port, never this module). Bars are the JAX tests' own
(tests/test_parallel.py): 1e-9 for the float64 renders, rtol 2e-4 / atol
1e-8 for the STFTs; the voice bank 2e-5 at float32 (its Pallas-vs-XLA bar,
tests/test_pallas_voicebank.py:45) and 1e-9 at float64.
"""

import functools
import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cpp_audio_tpu.core import events, voices
from cpp_audio_tpu.models import sine_synth, voicebank
from cpp_audio_tpu.ops import envelopes
from cpp_audio_tpu.ops import stft as stft_ops
from cpp_audio_tpu.parallel import mesh as pmesh
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.core import events as tevents
from cpp_audio_tpu_torch.core import voices as tvoices
from cpp_audio_tpu_torch.models import sine_synth as tsine_synth
from cpp_audio_tpu_torch.models import voicebank as tvb
from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
from cpp_audio_tpu_torch.ops import envelopes as tenvelopes
from cpp_audio_tpu_torch.parallel import launch
from cpp_audio_tpu_torch.parallel import mesh as tmesh
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
N_RENDER = 30000
STRIDES = (1000, 777)
SIGNAL = (np.sin(2 * np.pi * 440 * np.arange(SR // 2) / SR)
          + 0.1 * np.random.default_rng(2).standard_normal(SR // 2))
WINDOW = stft_ops.gaussian_window(2000)


def _render_case(pkg_events, pkg_voices, pkg_sine, pkg_env, *, uneven=False):
    """tests/test_parallel.py's render workloads on one package's modules:
    16 notes at float64, or (uneven) one note in 4 rows."""
    if uneven:
        cfg = pkg_sine.SineSynthConfig(sample_rate=SR, block_size=4096,
                                       dtype="float64")
        notes = [pkg_events.Note(1, 0, 8000, 440.0, 1.0)]
        return pkg_voices.schedule_from_notes(notes, pad_to=4), 10000, cfg
    cfg = pkg_sine.SineSynthConfig(
        sample_rate=SR, block_size=4096, dtype="float64",
        ahdsr=pkg_env.AHDSR(attack=441, hold=0, decay=441, release=2000,
                            sustain=0.6))
    notes = [pkg_events.Note(i, press=i * 500, release=20000 + i * 300,
                             frequency=220.0 * (1 + 0.25 * i),
                             velocity=0.5 + 0.03 * i, pan=-1.0 + 0.125 * i)
             for i in range(16)]
    return pkg_voices.schedule_from_notes(notes, pad_to=16), N_RENDER, cfg


def _port_case(uneven=False):
    return _render_case(tevents, tvoices, tsine_synth, tenvelopes, uneven=uneven)


def _jax_case(uneven=False):
    return _render_case(events, voices, sine_synth, envelopes, uneven=uneven)


def _calls(world):
    """Named calls every rank of a `world`-rank run makes, in order."""
    cpu = {"device": "cpu"}
    calls = {}
    if world in (2, 4):
        calls["render"] = (tmesh.render_schedule_sharded, _port_case(), cpu)
    if world == 3:
        calls["uneven"] = (tmesh.render_schedule_sharded, _port_case(True), cpu)
    if world in (1, 2, 4):
        for stride in STRIDES:
            calls[f"sharded{stride}"] = (tmesh.stft_sqmag_sharded,
                                         (SIGNAL, WINDOW, stride), cpu)
            calls[f"halo{stride}"] = (tmesh.stft_sqmag_sharded_halo,
                                      (SIGNAL, WINDOW, stride), cpu)
    return calls


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(world)[name]: rank 0's host result of the named call, one
    spawn of `world` gloo ranks per world size."""
    done = {}

    def run(world):
        if world not in done:
            calls = _calls(world)
            out = launch.spawn(world, launch.run_calls, list(calls.values()),
                               device="cpu", timeout=240,
                               store_dir=tmp_path_factory.mktemp("pg"))
            done[world] = dict(zip(calls, out))
        return done[world]

    return run


@pytest.mark.parametrize("world", [2, 4])
def test_render_schedule_sharded_matches_jax_and_single(ranks, world):
    sch, n, cfg = _jax_case()
    ref = pmesh.render_schedule_sharded(sch, n, cfg, mesh=pmesh.default_mesh(4))
    psch, pn, pcfg = _port_case()
    single = tsine_synth.render_schedule(psch, pn, pcfg, device="cpu").numpy()
    got = ranks(world)["render"]
    assert got.shape == (n, 2) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-9)
    np.testing.assert_allclose(got, single, atol=1e-9)


def test_sharded_pads_uneven_voices(ranks):
    """4 voice rows on 3 ranks: pad_voice_axis pads to 6."""
    sch, n, cfg = _jax_case(uneven=True)
    single = sine_synth.render_schedule(sch, n, cfg)
    got = ranks(3)["uneven"]
    np.testing.assert_allclose(got, single, atol=1e-9)
    assert np.abs(single).max() > 0.05
    assert tmesh.pad_voice_axis(_port_case(True)[0], 3).n_rows == 6


@functools.lru_cache(maxsize=None)
def _jax_stfts(stride):
    m4 = pmesh.default_mesh(4)
    return (np.asarray(stft_ops.stft_sqmag(SIGNAL, WINDOW, stride)),
            np.asarray(pmesh.stft_sqmag_sharded(SIGNAL, WINDOW, stride, mesh=m4)),
            np.asarray(pmesh.stft_sqmag_sharded_halo(SIGNAL, WINDOW, stride,
                                                     mesh=m4)))


@pytest.mark.parametrize("variant", ["sharded", "halo"])
@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_stfts_match_jax(ranks, world, stride, variant):
    single, jax_sharded, jax_halo = _jax_stfts(stride)
    got = ranks(world)[f"{variant}{stride}"]
    assert got.shape == single.shape
    for ref in (single, jax_sharded if variant == "sharded" else jax_halo):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-8)


def _offset_bank(dtype):
    from test_torch_voicebank import make_bank

    bank = make_bank(12, eased=True, seed=4)
    n, B = 6 * 2048, 2048
    args, st = voicebank.prepare_bank_arrays(bank, n, B, dtype)
    return args, st


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_block_offset_matches_jax(offset, dtype):
    """voicebank_blocks_impl(block_offset=k), the kernel's plain version on
    the CPU, against JAX's: blocks k .. k+n_blocks-1 of the timeline."""
    args, st = _offset_bank(dtype)
    nb = 3
    ref = np.asarray(voicebank.voicebank_blocks_impl(
        *args, block_size=st["block_size"], n_blocks=nb, a_itp=st["a_itp"],
        d_itp=st["d_itp"], r_itp=st["r_itp"], out_dtype=dtype,
        block_offset=offset))
    targs, tst = interop.bank_args_from_numpy(args, st, device="cpu")
    got = tvb.voicebank_blocks_impl(*targs, block_size=tst["block_size"],
                                    n_blocks=nb, block_offset=offset).numpy()
    assert got.shape == ref.shape == (nb, st["block_size"], 2)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, atol=2e-5 if dtype == "float32" else 1e-9)
    # the tile-by-tile plain form reaches the same blocks
    tiled = cv.render_blocks_tiled_plain(*cv.one_job(targs), block_size=tst["block_size"],
                                         n_blocks=nb, block_offset=offset)
    np.testing.assert_allclose(tiled[0].numpy().reshape(got.shape), got,
                               atol=2e-5 if dtype == "float32" else 1e-9)


def test_block_offset_work_count():
    """The kernel's work count (its bound's input) of an offset render is
    the whole render's less that of the blocks before the offset."""
    args, st = _offset_bank("float32")
    fp, ip = cv.one_job(interop.bank_args_from_numpy(args, st, device="cpu")[0][:2])
    B, nb = st["block_size"], st["n_blocks"]
    whole = cv.segment_voice_samples(fp, ip, block_size=B, n_blocks=nb)
    head = cv.segment_voice_samples(fp, ip, block_size=B, n_blocks=2)
    tail = cv.kernel_bound(fp, ip, block_size=B, n_blocks=nb - 2, block_offset=2,
                           n_channels=2)["segments"]
    assert all(tail[k] == whole[k] - head[k] for k in whole)
    assert sum(tail.values()) > 0


def test_block_offset_compacted_tables():
    """A compacted render of blocks 3..5 with block_offset=3 reads tables
    3..5 (indexed by the local block) and equals the dense render there."""
    args, st = _offset_bank("float32")
    targs, tst = interop.bank_args_from_numpy(args, st, device="cpu")
    B = tst["block_size"]
    dense = tvb.voicebank_blocks_impl(*targs, **tst).numpy()
    cargs, cst = tvb.compact_block_args(targs, tst)
    got = tvb.voicebank_blocks_compact_impl(*(a[3:6] for a in cargs),
                                            block_size=B, n_blocks=3,
                                            block_offset=3).numpy()
    np.testing.assert_allclose(got, dense[3:6], atol=2e-5)


def test_raising_rank_fails_without_hanging(tmp_path):
    """Rank 1 raises (a receive from itself) while rank 0 waits in a receive
    from rank 1: the call fails with rank 1's error well inside its
    deadline instead of waiting out the process group's timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch.spawn(2, launch.run_calls,
                     [(dist.recv, (torch.zeros(1),), {"src": 1})],
                     device="cpu", timeout=60, pg_timeout=60, store_dir=tmp_path)
    assert time.monotonic() - t0 < 50


PUBLIC = ("default_mesh", "pad_voice_axis", "make_sharded_renderer",
          "render_bank_sharded", "stft_sqmag_sharded", "stft_sqmag_sharded_halo",
          "render_schedule_sharded", "make_sharded_chain", "default_mesh_2d",
          "make_sharded_chain_2d", "make_pipelined_chain",
          "render_jobs_pipelined", "render_jobs_farm")


def test_every_jax_function_has_a_counterpart_on_cuda_by_default():
    jax_public = {name for name, f in vars(pmesh).items()
                  if inspect.isfunction(f) and not name.startswith("_")
                  and f.__module__ == pmesh.__name__}
    assert jax_public == set(PUBLIC)
    for name in PUBLIC:
        params = inspect.signature(getattr(tmesh, name)).parameters
        if name != "pad_voice_axis":  # host numpy only
            assert params["device"].default == "cuda", name


def test_default_mesh_starts_a_one_rank_gloo_group():
    assert not dist.is_initialized()
    try:
        m = tmesh.default_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert m.size() == 1 and m.mesh_dim_names == ("v",)
        with pytest.raises(ValueError, match="world size"):
            tmesh.default_mesh(2, device="cpu")
        # one rank: the renderer's all_reduce and the halo's ring are the
        # identity, so the sharded functions equal the single-device ones
        psch, n, pcfg = _port_case()
        got = tmesh.render_schedule_sharded(psch, n, pcfg, mesh=m, device="cpu")
        single = tsine_synth.render_schedule(psch, n, pcfg, device="cpu")
        assert torch.equal(got, single)
        before = dict(tmesh.COUNTS)
        tmesh.stft_sqmag_sharded_halo(SIGNAL, WINDOW, 777, mesh=m, device="cpu")
        assert tmesh.COUNTS["p2p"] == before["p2p"] + 1
        assert tmesh.COUNTS["all_gather"] == before["all_gather"] + 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
