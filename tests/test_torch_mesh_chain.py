"""The port's sharded offline chains (cpp_audio_tpu_torch/parallel/mesh.py):
make_sharded_chain, make_sharded_chain_2d, render_jobs_farm and
render_jobs_pipelined on CPU gloo ranks, against the JAX package's on its
virtual CPU devices (4 of them, as tests/test_parallel.py lays them out) and
against the port's single-device chain (chain.run_offline_chain_device).

Workload: tests/test_parallel.py's `_chain_workload` (8 voices, block 4096),
2 s for the chains and 1 s per job for the farm and the pipeline, a 110 Hz
(and 220 Hz) square carrier. Bars: against JAX, the chain parity bars of
PERF.md §2 (resynth max|diff|/peak < 2e-3, vocoded atol 1e-4: torch's and
XLA's float32 FFTs round differently); against the port's single device,
JAX's own bar for its sharded chains (1e-3 of the peak + 1e-6,
tests/test_parallel.py:96-100) and equal dropped counts. The collectives of
one step stay inside `__graft_entry__.py:108-111`'s bounds.
"""

import functools

import jax
import numpy as np
import pytest
import torch.distributed as dist

from cpp_audio_tpu.analysis import resynth, vocoder
from cpp_audio_tpu.parallel import mesh as pmesh
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.analysis import vocoder as tvocoder
from cpp_audio_tpu_torch.parallel import launch
from cpp_audio_tpu_torch.parallel import mesh as tmesh
from test_parallel import _chain_workload
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
N = 2 * SR        # the chains
N_JOB = SR        # each farm and pipeline job
BLOCK = 4096


def _carrier(f, n):
    return np.sign(np.sin(2 * np.pi * f * np.arange(n) / SR))


CARRIERS = [_carrier(110.0, N_JOB), _carrier(220.0, N_JOB)]


@functools.lru_cache(maxsize=None)
def _banks(n):
    """(JAX bank, port bank) of the workload at n samples."""
    bank, _cfg = _chain_workload(SR, n)
    return bank, interop.voicebank_from_numpy(bank)


def _jax_configs():
    return (resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                  dtype="float32"),
            vocoder.VocoderParams(sample_rate=SR))


def _port_configs():
    return (tresynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                   dtype="float32"),
            tvocoder.VocoderParams(sample_rate=SR))


def _calls(world):
    rcfg, vp = _port_configs()
    bank, bank1 = _banks(N)[1], _banks(N_JOB)[1]
    kw = {"block_size": BLOCK, "device": "cpu"}
    calls = {"chain": (launch.chain_outputs, (N, rcfg, vp, bank, _carrier(110.0, N)), kw),
             "pipelined": (tmesh.render_jobs_pipelined,
                           ([bank1, bank1], N_JOB, rcfg, vp, CARRIERS), kw)}
    if world == 4:
        calls["chain2d"] = (launch.chain_outputs, (N, rcfg, vp, bank, _carrier(110.0, N)),
                            dict(kw, shape=(2, 2)))
        calls["farm"] = (tmesh.render_jobs_farm,
                         ([bank1, bank1], N_JOB, rcfg, vp, CARRIERS),
                         dict(kw, n_groups=2))
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
                               device="cpu", timeout=300,
                               store_dir=tmp_path_factory.mktemp("pg"))
            done[world] = dict(zip(calls, out))
        return done[world]

    return run


@functools.lru_cache(maxsize=None)
def _port_single(n, f):
    rcfg, vp = _port_configs()
    r = tchain.run_offline_chain_device(_banks(n)[1], n, rcfg, vp, _carrier(f, n),
                                        block_size=BLOCK, device="cpu")
    return r.resynth.numpy(), r.vocoded.numpy(), int(r.dropped)


def _rel(got, ref):
    m = min(len(got), len(ref))
    return float(np.abs(got[:m] - ref[:m]).max()) / max(float(np.abs(ref[:m]).max()), 1e-9)


def _check(got, jax_ref, single):
    """One job's (stereo, vocoded, dropped) against JAX's and the port's
    single-device chain."""
    stereo, voc, dropped = (np.asarray(x) for x in got[:3])
    s_res, s_voc, s_dropped = single
    assert stereo.shape[1] == 2 and len(stereo) >= len(s_res)
    assert np.abs(s_res).max() > 1e-3 and np.abs(s_voc).max() > 1e-3
    # JAX's sharded chain of the same layout
    assert _rel(stereo, np.asarray(jax_ref[0])) < 2e-3
    j_voc = np.asarray(jax_ref[1])
    m = min(len(voc), len(j_voc))
    np.testing.assert_allclose(voc[:m], j_voc[:m], atol=1e-4)
    # the port's single-device chain
    peak = np.abs(s_res).max()
    assert np.abs(stereo[: len(s_res)] - s_res).max() < 1e-3 * peak + 1e-6
    vpeak = np.abs(s_voc).max()
    assert np.abs(voc[: len(s_voc)] - s_voc).max() < 1e-3 * vpeak + 1e-6
    assert int(dropped) == s_dropped


@functools.lru_cache(maxsize=None)
def _jax_chain(shape):
    rcfg, vp = _jax_configs()
    m = pmesh.default_mesh(4) if shape is None else pmesh.default_mesh_2d(*shape)
    make = pmesh.make_sharded_chain if shape is None else pmesh.make_sharded_chain_2d
    out = make(m, N, rcfg, vp, block_size=BLOCK)(_banks(N)[0], _carrier(110.0, N))()
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_chain_matches_jax_and_single(ranks, world):
    _check(ranks(world)["chain"], _jax_chain(None), _port_single(N, 110.0))


def test_sharded_chain_2d_matches_jax_and_single(ranks):
    _check(ranks(4)["chain2d"], _jax_chain((2, 2)), _port_single(N, 110.0))


@pytest.mark.parametrize("world,name", [(2, "chain"), (4, "chain"), (4, "chain2d")])
def test_collective_counts_within_the_dry_run_bounds(ranks, world, name):
    counts = ranks(world)[name][3]
    assert 1 <= counts["all_reduce"] <= 4, counts
    assert 1 <= counts["all_gather"] <= 6, counts
    assert counts["broadcast"] == counts["p2p"] == 0, counts


def _jax_jobs(render, **kw):
    rcfg, vp = _jax_configs()
    bank = _banks(N_JOB)[0]
    return render([bank, bank], N_JOB, rcfg, vp, CARRIERS, block_size=BLOCK,
                  devices=jax.devices()[:4], **kw)


def test_render_jobs_farm_matches_jax_and_single(ranks):
    """Two jobs over two groups of two ranks."""
    got = ranks(4)["farm"]
    ref = _jax_jobs(pmesh.render_jobs_farm, n_groups=2)
    assert len(got) == len(ref) == 2
    for job, jref, f in zip(got, ref, (110.0, 220.0)):
        _check(job, jref, _port_single(N_JOB, f))


@pytest.mark.parametrize("world", [2, 4])
def test_render_jobs_pipelined_matches_jax_and_single(ranks, world):
    """Two jobs through stage 1 on the first half of the ranks and stage 2
    on the second half."""
    got = ranks(world)["pipelined"]
    ref = _jax_jobs(pmesh.render_jobs_pipelined)
    assert len(got) == len(ref) == 2
    for job, jref, f in zip(got, ref, (110.0, 220.0)):
        _check(job, jref, _port_single(N_JOB, f))


def test_one_rank_cannot_pipeline_or_farm():
    """One rank holds no second stage (JAX cannot build its second mesh
    there) and no second group (JAX asserts per >= 1, mesh.py:672)."""
    rcfg, vp = _port_configs()
    bank = _banks(N_JOB)[1]
    assert not dist.is_initialized()
    try:
        tmesh.default_mesh(device="cpu")
        with pytest.raises(ValueError, match="two ranks"):
            tmesh.render_jobs_pipelined([bank], N_JOB, rcfg, vp, CARRIERS[:1],
                                        block_size=BLOCK, device="cpu")
        with pytest.raises(ValueError, match="cannot form 2 groups"):
            tmesh.render_jobs_farm([bank], N_JOB, rcfg, vp, CARRIERS[:1],
                                   n_groups=2, block_size=BLOCK, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
