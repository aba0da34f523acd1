"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and nvcc; elsewhere they skip. The file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -o addopts="" -q

Bar: atol 2e-5 (tests/test_pallas_voicebank.py:45); the kernel and the plain
version share every formula, and differ in FMA contraction and summation
order only.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu_torch.core import events, voices
from cpp_audio_tpu_torch.models import sine_synth
from cpp_audio_tpu_torch.models import voicebank as tvb
from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
from cpp_audio_tpu_torch.ops import envelopes

ATOL = 2e-5


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _bank(n_notes, *, eased, seed=0, n_channels=2):
    rng = np.random.default_rng(seed)
    notes = [events.Note(i, int(rng.uniform(0, 2000)), int(rng.uniform(4000, 12000)),
                         float(rng.uniform(100, 2000)), float(rng.uniform(0.2, 1.0)),
                         float(rng.uniform(-1, 1))) for i in range(n_notes)]
    sch = voices.schedule_from_notes(notes, pad_to=max(8, n_notes))
    cfg = sine_synth.SineSynthConfig(
        sample_rate=44100, n_channels=n_channels,
        ahdsr=envelopes.AHDSR(attack=441, hold=100, decay=882, release=2205,
                              sustain=0.6))
    bank = sine_synth.bank_from_schedule(sch, cfg)
    if eased:
        code = np.arange(bank.n_rows) % 23
        bank.attack_itp, bank.decay_itp, bank.release_itp = (
            code, (code + 7) % 23, (code + 13) % 23)
    return bank


@pytest.mark.cuda
@pytest.mark.parametrize("eased", [False, True], ids=["linear", "eased23"])
@pytest.mark.parametrize("n_channels", [1, 2])
def test_kernel_matches_plain(cuda_card, eased, n_channels):
    bank = _bank(46 if eased else 300, eased=eased, n_channels=n_channels)
    args, st = tvb.prepare_bank_arrays(bank, 16384 + 77, 1500, device=cuda_card)
    cargs, cst = tvb.compact_block_args(args, st)
    for tables, statics in ((args, st), (cargs, cst)):
        before = cv.LAUNCHES
        k_out = cv.render_blocks(*tables, **statics)
        assert cv.LAUNCHES == before + 1
        p_out = cv.render_blocks_plain(*tables, **statics)
        torch.cuda.synchronize()
        assert k_out.shape == p_out.shape == (statics["n_blocks"] * 1500, n_channels)
        assert float(p_out.abs().max()) > 0.05
        assert float((k_out - p_out).abs().max()) <= ATOL


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_card):
    args, st = tvb.prepare_bank_arrays(_bank(8, eased=False), 4096, 1024,
                                       dtype="float64", device=cuda_card)
    before = cv.LAUNCHES
    with pytest.raises(TypeError):  # float64 has no kernel: raise, no fallback
        cv.render_blocks(*args, **st)
    assert cv.LAUNCHES == before
