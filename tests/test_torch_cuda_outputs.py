"""The offline chain's delivery of its outputs to the host
(cpp_audio_tpu_torch.analysis.chain._to_host) on the card.

On a CUDA device run_offline_chain_device and the batched step() copy the
stereo, the vocoded mix and the dropped counts without blocking into pinned
host tensors from torch's caching host allocator, then synchronise the
stream once. Held here (marked cuda, skipped elsewhere; the file imports
neither jax nor the JAX package):

    python -m pytest tests/test_torch_cuda_outputs.py --noconftest -o addopts="" -q

  - the outputs are pinned host tensors, equal to the bit to .cpu() of the
    device tensors the step handed over;
  - outputs kept from one call keep their values through a second call on
    another bank;
  - the span counter pinned_outputs reads 3 a call, in the "outputs" span;
  - a call synchronises the stream once, and the batched step() makes no
    other synchronising call from the chain's module.

The CPU's side (host tensors returned as they are, the span, the counter
at 0) is in tests/test_torch_chain_device.py and
tests/test_torch_batch_serving.py.
"""

import os
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.utils import profiling
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)
from test_torch_cuda_kernels import cuda_card  # noqa: F401  (fixture)
from test_torch_tracing import ARGS, N, _bank

KW = dict(block_size=1 << 13)


def _handed(monkeypatch):
    """Wrap chain._to_host; returns the list of the device outputs handed
    to it, one tuple a call."""
    handed = []
    deliver = tchain._to_host

    def kept(outputs, dev):
        handed.append(outputs)
        return deliver(outputs, dev)

    monkeypatch.setattr(tchain, "_to_host", kept)
    return handed


def _single(seed, dev):
    r = tchain.run_offline_chain_device(_bank(seed), N, *ARGS, device=dev, **KW)
    return r.resynth, r.vocoded, r.dropped


def _batch_step(seeds, dev):
    step, _n = tchain.prepare_offline_chain_device_batch(
        [_bank(s) for s in seeds], N, *ARGS, device=dev, **KW)
    return step


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["single", "batch"])
def test_card_outputs_are_pinned_copies_of_the_device_outputs(cuda_card, monkeypatch, case):
    handed = _handed(monkeypatch)
    got = _single(1, cuda_card) if case == "single" else _batch_step((2, 3), cuda_card)()
    assert len(handed) == 1 and len(got) == 3
    for host, device in zip(got, handed[0]):
        assert device.device.type == "cuda"
        assert host.device.type == "cpu" and host.is_pinned()
        assert host.dtype == device.dtype and host.shape == device.shape
        assert torch.equal(host, device.cpu())
    stereo, voc, dropped = got
    assert stereo.shape[-1] == 2 and float(stereo.abs().max()) > 1e-3
    assert dropped.dim() == (0 if case == "single" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["single", "batch"])
def test_card_held_outputs_survive_the_next_call(cuda_card, case):
    if case == "single":
        first = _single(1, cuda_card)
        kept = [t.clone() for t in first]
        second = _single(4, cuda_card)
    else:
        first = _batch_step((2, 3), cuda_card)()
        kept = [t.clone() for t in first]
        second = _batch_step((4, 5), cuda_card)()
    for held, value, other in zip(first, kept, second):
        assert torch.equal(held, value)
        assert held.data_ptr() != other.data_ptr()
    assert not torch.equal(first[0], second[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["single", "batch"])
def test_card_pinned_outputs_count_three_a_call(cuda_card, case):
    step = _batch_step((2, 3), cuda_card) if case == "batch" else None
    run = (lambda: _single(1, cuda_card)) if step is None else step
    run()
    before = tchain.PINNED_OUTPUTS
    first = len(profiling.SPANS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run()
        run()
    assert tchain.PINNED_OUTPUTS - before == 6
    recs = profiling.SPANS.records[first:]
    outs = [r for r in recs if r.name == "outputs"]
    chains = [r for r in recs if r.name == "chain"]
    assert len(outs) == len(chains) == 2
    assert all(o.parent == "chain" and o.counts["pinned_outputs"] == 3 for o in outs)
    assert all(c.counts["pinned_outputs"] == 3 for c in chains)
    spans = profiling.SPANS.summary(first)["spans"]
    assert spans["outputs"]["pinned_outputs"] == 3 and spans["outputs"]["device_ms"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["single", "batch"])
def test_card_call_synchronises_once(cuda_card, monkeypatch, case):
    step = _batch_step((2, 3), cuda_card) if case == "batch" else None
    run = (lambda: _single(1, cuda_card)) if step is None else step
    run()
    torch.cuda.synchronize()
    syncs = []
    plain = torch.cuda.Stream.synchronize

    def counted(self):
        syncs.append(self)
        return plain(self)

    monkeypatch.setattr(torch.cuda.Stream, "synchronize", counted)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert len(syncs) == 1 and syncs[0] == torch.cuda.current_stream(cuda_card)
    assert all(t.is_pinned() for t in out)
    if case == "batch":
        # the step's staging is done: nothing in the chain's module waits
        # for the device but the one synchronisation (torch.cuda.streams)
        here = os.path.join("analysis", "chain.py")
        assert not [w for w in caught if "synchronizing CUDA operation" in str(w.message)
                    and str(w.filename).endswith(here)]
    assert np.isfinite(out[0].numpy()).all()
