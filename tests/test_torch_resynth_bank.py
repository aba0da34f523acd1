"""Tracked-note renderer port (cpp_audio_tpu_torch.models.resynth_bank)
against the JAX package.

The host slot-table packer is a copy and must agree exactly. The render is
held on the same slot table:
  - float64: atol 1e-9 (the same closed forms, libm rounding only);
  - float32 without glides: atol 5e-5 (exp/log1p ulps of the two libms
    differ in the volume and envelope terms);
  - float32 with glides: the phase advance (inc/lam)*expm1(lam*(k+1)) spans
    hundreds of cycles per stride, so one ulp of expm1 moves the phase by
    ~1e-4 rad/pi. Both float32 renders then sit ~2e-4 from the float64
    render; the port must be no further from it than the JAX package is
    (x1.5), rather than equal to the JAX package's own rounding.
"""

import numpy as np
import pytest
import torch

from cpp_audio_tpu.models import resynth_bank as rb
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.models import resynth_bank as trb

SR = 44100
STRIDE = 3969


def _notes(module, n_frames, seed=0, n_notes=24, glide=True):
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
        rel = trail[-1][0] + 1 if rng.uniform() < 0.8 else module.NEVER_FRAME
        notes.append(module.TrackedNote(frames=trail, release_frame=rel,
                                        pan=float(rng.uniform(-1, 1))))
    return notes


def _configs(**kw):
    return (rb.TrackedRenderConfig(sample_rate=SR, stride=STRIDE, **kw),
            trb.TrackedRenderConfig(sample_rate=SR, stride=STRIDE, **kw))


@pytest.mark.parametrize("n_slots", [8, 32])
def test_slot_tables_match(n_slots):
    cfg, tcfg = _configs(n_slots=n_slots)
    ref = rb._build_slot_tables(_notes(rb, 20), 28, cfg)
    got = trb._build_slot_tables(_notes(trb, 20), 28, tcfg)
    np.testing.assert_array_equal(got, ref)


def _renders(table, dtype):
    import jax.numpy as jnp

    ref = np.asarray(rb._render_slots(jnp.asarray(table, dtype), stride=STRIDE,
                                      n_channels=2, dtype=dtype))
    got = trb._render_slots(interop.slot_table_from_numpy(table, device="cpu"),
                            stride=STRIDE, dtype=dtype).numpy()
    assert got.shape == ref.shape == (table.shape[0], STRIDE, 2)
    assert np.abs(ref).max() > 0.05
    return got, ref


@pytest.mark.parametrize("glide", [False, True], ids=["steady", "glides"])
def test_render_slots_float64_on_same_table(glide):
    cfg, _ = _configs(n_slots=32)
    table = rb._build_slot_tables(_notes(rb, 20, seed=1, glide=glide), 28, cfg)
    got, ref = _renders(table, "float64")
    np.testing.assert_allclose(got, ref, atol=1e-9)


@pytest.mark.parametrize("table_dtype", [np.float64, np.float32])
def test_render_slots_float32_on_same_table(table_dtype):
    cfg, _ = _configs(n_slots=32)
    table = rb._build_slot_tables(_notes(rb, 20, seed=1, glide=False), 28, cfg)
    got, ref = _renders(table.astype(table_dtype), "float32")
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_render_slots_float32_glides_as_accurate_as_jax():
    cfg, _ = _configs(n_slots=32)
    table = rb._build_slot_tables(_notes(rb, 20, seed=1), 28, cfg)
    got, ref = _renders(table, "float32")
    exact, _ = _renders(table, "float64")
    err_port = float(np.abs(got - exact).max())
    err_jax = float(np.abs(ref - exact).max())
    assert err_port <= 1.5 * err_jax + 1e-6, (err_port, err_jax)


def test_render_slots_chunks_frames(monkeypatch):
    """A render split into one-frame chunks equals the one-chunk render."""
    cfg, _ = _configs(n_slots=16)
    table = torch.from_numpy(rb._build_slot_tables(_notes(rb, 12, seed=2), 16, cfg))
    whole = trb._render_slots(table, stride=STRIDE, dtype="float32")
    monkeypatch.setattr(trb, "_RENDER_CHUNK_ELEMS", 1)
    chunked = trb._render_slots(table, stride=STRIDE, dtype="float32")
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_render_tracked_matches():
    cfg, tcfg = _configs(n_slots=32, start_sample=7999)
    ref = rb.render_tracked(_notes(rb, 20, seed=3, glide=False), 20, cfg)
    got = trb.render_tracked(_notes(trb, 20, seed=3, glide=False), 20, tcfg,
                             device="cpu").numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_df_phase_table_is_refused():
    table = torch.zeros((2, 4, 17))
    with pytest.raises(ValueError):
        trb._render_slots(table, stride=16, dtype="float32")
