"""Voice-bank port (cpp_audio_tpu_torch) against the JAX package.

The same numpy bank, made from a seed, goes through the JAX renderers (XLA
`_voicebank_blocks`, `voicebank_blocks_compact_impl`, and the Pallas kernel
in interpret mode) and through the port's `render_blocks` on CPU tensors,
which takes the kernel's plain PyTorch version. Tolerance: atol 2e-5, the
Pallas-vs-XLA bar of tests/test_pallas_voicebank.py:45 — both sides are
float32 with the same phase/envelope arithmetic; they differ in the mixdown
summation order and in the phase conversion (uint32 -> f32 in XLA, the
int32 bitcast in Pallas and the port, ~1e-7 rad/pi).
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.core import events, voices
from cpp_audio_tpu.models import sine_synth, voicebank
from cpp_audio_tpu.ops import envelopes, fastmath
from cpp_audio_tpu.ops.pallas_voicebank import render_blocks_pallas
from cpp_audio_tpu.utils import interp
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.models import voicebank as tvb
from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
from cpp_audio_tpu_torch.ops import fastmath as tfastmath
from cpp_audio_tpu_torch.utils import interp as tinterp

ATOL = 2e-5


def make_bank(n_notes=8, *, eased=False, seed=0):
    rng = np.random.default_rng(seed)
    notes = [
        events.Note(i, int(rng.uniform(0, 2000)), int(rng.uniform(4000, 12000)),
                    float(rng.uniform(100, 2000)), float(rng.uniform(0.2, 1.0)),
                    float(rng.uniform(-1, 1)))
        for i in range(n_notes)
    ]
    sch = voices.schedule_from_notes(notes, pad_to=max(8, n_notes))
    cfg = sine_synth.SineSynthConfig(
        sample_rate=44100,
        ahdsr=envelopes.AHDSR(attack=441, hold=100, decay=882, release=2205,
                              sustain=0.6),
        dtype="float32",
    )
    bank = sine_synth.bank_from_schedule(sch, cfg)
    if eased:
        # per-voice codes covering all 23 curves in each envelope segment
        code = np.arange(bank.n_rows) % interp._N_CURVES
        bank.attack_itp = code
        bank.decay_itp = (code + 7) % interp._N_CURVES
        bank.release_itp = (code + 13) % interp._N_CURVES
    return bank


def _jax_dense(bank, n, B):
    args, st = voicebank.prepare_bank_arrays(bank, n, B, "float32")
    out = np.asarray(voicebank._voicebank_blocks(*args, out_dtype="float32", **st))
    return args, st, out.reshape(-1, out.shape[-1])[:n]


@pytest.mark.parametrize("eased", [False, True], ids=["linear", "eased23"])
def test_dense_render_matches_xla(eased):
    n, B = 16384, 2048
    bank = make_bank(46 if eased else 8, eased=eased)
    args, st, ref = _jax_dense(bank, n, B)
    if eased:
        assert st["a_itp"] is None  # JAX evaluates per-voice codes
    targs, tst = interop.bank_args_from_numpy(args, st, device="cpu")
    got = cv.render_blocks(*targs, **tst).numpy()[:n]
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.abs(ref).max() > 0.1


def test_dense_render_matches_pallas_interpret():
    n, B = 16384, 2048
    bank = make_bank()
    args, st = voicebank.prepare_bank_arrays(bank, n, B, "float32")
    fp, ip, up, gains, _ = args
    pal = np.asarray(render_blocks_pallas(fp, ip, up, gains, block_size=B,
                                          n_blocks=st["n_blocks"],
                                          interpret=True))[:n]
    targs, tst = interop.bank_args_from_numpy(args, st, device="cpu")
    got = cv.render_blocks(*targs, **tst).numpy()[:n]
    np.testing.assert_allclose(got, pal, atol=ATOL)


@pytest.mark.parametrize("eased", [False, True], ids=["linear", "eased23"])
def test_compact_render_matches_jax(eased):
    import jax.numpy as jnp

    n, B = 24576, 4096
    bank = make_bank(46 if eased else 8, eased=eased, seed=1)
    args, st = voicebank.prepare_bank_arrays(bank, n, B, "float32")
    cargs, cst = voicebank.compact_block_args(args, st)
    ref = np.asarray(voicebank.voicebank_blocks_compact_impl(
        *(jnp.asarray(a) for a in cargs), block_size=B, n_blocks=cst["n_blocks"],
        a_itp=cst["a_itp"], d_itp=cst["d_itp"], r_itp=cst["r_itp"],
        out_dtype="float32")).reshape(-1, 2)[:n]
    # the port's own host path builds the same tables from the same bank
    pargs, pst = tvb.prepare_bank_arrays(interop.voicebank_from_numpy(bank), n,
                                         B, device="cpu")
    tc, tcs = tvb.compact_block_args(pargs, pst)
    for mine, theirs in zip(tc, cargs):
        np.testing.assert_array_equal(mine.numpy(),
                                      np.asarray(theirs).astype(mine.numpy().dtype))
    got = tvb.voicebank_blocks_compact_impl(*tc, **tcs).reshape(-1, 2).numpy()[:n]
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_prepare_bank_arrays_match_jax():
    bank = make_bank(12, eased=True, seed=2)
    args, st = voicebank.prepare_bank_arrays(bank, 10000, 1024, "float32")
    pargs, pst = tvb.prepare_bank_arrays(interop.voicebank_from_numpy(bank),
                                         10000, 1024, device="cpu")
    assert pst == {"block_size": st["block_size"], "n_blocks": st["n_blocks"]}
    for mine, theirs in zip(pargs, args):
        theirs = np.asarray(theirs)
        np.testing.assert_array_equal(mine.numpy(), theirs.astype(mine.numpy().dtype))
    assert pargs[2].dtype == torch.int64  # uint32 words carried as int64


def test_nco_words_bit_exact():
    """((b0 - press + 1) + k) * inc + phase0 mod 2^32 against a numpy uint64
    reference, including the extreme words and the +-FAR press clamp."""
    rng = np.random.default_rng(5)
    far = int(voicebank._I32_FAR)
    press = np.array([0, 1, -5, far, -far, 123456789, -987654], np.int64)
    inc = np.array([2**32 - 1, 1, 0, 2**31, 3_000_000_000, 12345, 2**32 - 7], np.int64)
    phase0 = rng.integers(0, 2**32, press.size, dtype=np.int64)
    B = 4096
    for b in (0, 1, 7, 3000):
        k = np.arange(B, dtype=np.int64)
        base = (b * B - press[:, None] + 1) % 2**32
        ref = (((base + k[None, :]) % 2**32).astype(np.uint64)
               * inc[:, None].astype(np.uint64)
               + phase0[:, None].astype(np.uint64)) % np.uint64(2**32)
        got = cv.nco_words(b * B, torch.from_numpy(press[:, None]),
                           torch.from_numpy(inc[:, None]),
                           torch.from_numpy(phase0[:, None]),
                           torch.from_numpy(k[None, :]))
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), ref)


def test_render_bank_and_sparse_match_jax():
    n = 3 * 8192 + 100
    bank = make_bank(24, seed=3)
    pbank = interop.voicebank_from_numpy(bank)
    ref = voicebank.render_bank(bank, n, block_size=2048, use_pallas="never")
    got = tvb.render_bank(pbank, n, block_size=2048, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # sparse: force the segmented path with small segments and dense_rows
    kw = dict(segment_size=8192, block_size=2048, dense_rows=4)
    ref_s = voicebank.render_bank_sparse(bank, n, use_pallas="never", **kw)
    got_s = tvb.render_bank_sparse(pbank, n, device="cpu", **kw).numpy()
    assert got_s.shape == ref_s.shape
    np.testing.assert_allclose(got_s, ref_s, atol=ATOL)


def test_retuned_phase0_matches_jax():
    for args in [(100, 5000, 0.3, 0.01, 0.013), (0, 1, 1.9, 1.5, 0.0001),
                 (-50, 2**20, 0.0, 0.999, 0.5)]:
        assert tvb.retuned_phase0(*args) == voicebank.retuned_phase0(*args)


@pytest.mark.parametrize("code", range(23))
def test_ease_select_matches_jax(code):
    import jax.numpy as jnp

    x = np.linspace(-0.2, 1.2, 301).astype(np.float32)
    codes = np.full_like(x, code, dtype=np.int32)
    ref = np.asarray(interp.ease_select(jnp.asarray(codes), jnp.asarray(x)))
    got = tinterp.ease_select(torch.from_numpy(codes), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    got1 = tinterp.ease(code, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got1, ref, atol=1e-6)


def test_fastmath_matches_jax():
    import jax.numpy as jnp

    x = np.random.default_rng(0).uniform(-7, 7, 4096).astype(np.float32)
    for name in ("sinpi", "cospi"):
        ref = np.asarray(getattr(fastmath, name)(jnp.asarray(x)))
        got = getattr(tfastmath, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-7)
    xp = np.clip(x / 7.0, -1.0, 0.9999)
    np.testing.assert_allclose(
        tfastmath.sinpi_principal(torch.from_numpy(xp)).numpy(),
        np.asarray(fastmath.sinpi_principal(jnp.asarray(xp))), atol=2e-7)


def test_dispatch_follows_the_tensor_device():
    bank = make_bank(4)
    args, st = tvb.prepare_bank_arrays(interop.voicebank_from_numpy(bank), 4096,
                                       1024, device="cpu")
    before = cv.LAUNCHES
    cv.render_blocks(*args, **st)
    assert cv.LAUNCHES == before  # the CPU takes the plain version
    with pytest.raises(ValueError):  # the kernel never takes CPU tensors
        cv.render_blocks_cuda(*args, **st)
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError):
        cv.render_blocks(*meta, **st)
    assert cv.LAUNCHES == before
