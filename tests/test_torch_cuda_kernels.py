"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and nvcc; elsewhere they skip. The file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -o addopts="" -q

Bar: atol 2e-5 (tests/test_pallas_voicebank.py:45); the kernel and the plain
version share every formula, and differ in FMA contraction, summation
order and the kernel's integer principal reduction of the NCO word (<= 2.1e-7
per voice-sample, csrc/voicebank.cu).
"""

import os

import numpy as np
import pytest
import torch

from cpp_audio_tpu_torch.core import events, voices
from cpp_audio_tpu_torch.models import sine_synth
from cpp_audio_tpu_torch.models import voicebank as tvb
from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
from cpp_audio_tpu_torch.ops import envelopes


def cap_torch_threads() -> int:
    """Give this test process an even share of the CPU's cores for torch's
    intra-op thread pool: under pytest-xdist every worker would otherwise
    run a pool as wide as the machine, and the workers oversubscribe the
    cores. This module calls it when it is imported, and every
    tests/test_torch_*.py imports this module. Returns the thread count
    set."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, (os.cpu_count() or 1) // max(1, workers))
    torch.set_num_threads(threads)
    return threads


cap_torch_threads()

ATOL = 2e-5


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def edge_tables(block_size, n_channels=2, *, device="cpu", seed=0):
    """Hand-made dense (V, ·) tables whose rows start and end on a kernel
    tile edge and one sample either side of it, plus skipped rows, over 4
    blocks of which the last has no live row. E is the first sample of the
    second tile of block 1; R = 500, so a row released at e - 498 sounds
    last at sample e. Returns ((fp, ip, up, gains, codes), statics, E)."""
    rng = np.random.default_rng(seed)
    E = block_size + cv.KERNEL_TILE
    press, release = [], []
    for d in (-1, 0, 1):
        press.append(E + d)                 # press on the edge
        release.append(E + d + 2000)
        e = E - 1 + d                       # last sounding sample on the edge
        press.append(e - 498 - 3000)
        release.append(e - 498)
    for d in (-1, 0, 1):                    # skipped: released at the press
        press.append(E + d)
        release.append(E + d)
    V = len(press)
    skip = np.array([r <= p for p, r in zip(press, release)], np.float32)
    fp = np.stack([rng.uniform(0.2, 0.5, V), np.full(V, 50.0), np.full(V, 10.0),
                   np.full(V, 100.0), np.full(V, 500.0), np.full(V, 0.6),
                   rng.uniform(0.3, 0.9, V), skip], axis=1).astype(np.float32)
    ip = np.stack([press, release], axis=1).astype(np.int32)
    inc = np.round(2.0 * rng.uniform(100, 2000, V) / 44100 * 2**31).astype(np.int64)
    up = np.stack([inc, rng.integers(0, 2**32, V)], axis=1).astype(np.int64)
    gains = rng.uniform(0.2, 1.0, (V, n_channels)).astype(np.float32)
    code = np.arange(V) % 23
    codes = np.stack([code, (code + 7) % 23, (code + 13) % 23], axis=1).astype(np.int32)
    args = tuple(torch.from_numpy(a).to(device) for a in (fp, ip, up, gains, codes))
    return args, dict(block_size=block_size, n_blocks=4), E


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
        tables = cv.one_job(tables)
        before = cv.LAUNCHES
        k_out = cv.render_blocks(*tables, **statics)
        assert cv.LAUNCHES == before + 1
        p_out = cv.render_blocks_plain(*tables, **statics)
        torch.cuda.synchronize()
        assert k_out.shape == p_out.shape == (1, statics["n_blocks"] * 1500, n_channels)
        assert float(p_out.abs().max()) > 0.05
        assert float((k_out - p_out).abs().max()) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("eased", [False, True], ids=["linear", "eased23"])
@pytest.mark.parametrize("n_channels", [1, 2])
def test_kernel_float64_matches_plain(cuda_card, eased, n_channels):
    """The float64 instantiation (the float64 chains' synth) against the
    plain version in float64, dense and compacted, at 1e-12: both compute
    the same exact forms and differ in FMA contraction, summation order and
    the last ulp of the card's and the CPU's sin, cos and exp2; and a batch
    of two jobs equal to the bit to each job's own launch."""
    bank = _bank(46 if eased else 300, eased=eased, n_channels=n_channels)
    args, st = tvb.prepare_bank_arrays(bank, 16384 + 77, 1500, dtype="float64",
                                       device=cuda_card)
    cargs, cst = tvb.compact_block_args(args, st)
    for tables, statics in ((args, st), (cargs, cst)):
        tables = cv.one_job(tables)
        k_out = cv.render_blocks(*tables, **statics)
        p_out = cv.render_blocks_plain(*tables, **statics)
        torch.cuda.synchronize()
        assert k_out.dtype == p_out.dtype == torch.float64
        assert float(p_out.abs().max()) > 0.05
        assert float((k_out - p_out).abs().max()) <= 1e-12
    pair = tuple(torch.cat([a[None], a[None]]) for a in args)
    out = cv.render_blocks_cuda(*pair, **st)
    assert torch.equal(out[0], out[1])
    assert torch.equal(out[0], cv.render_blocks_cuda(*cv.one_job(args), **st)[0])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_card):
    """float16 tables, gains of another type than fp, and tables without
    the job axis raise, and nothing launches: no fallback."""
    args, st = tvb.prepare_bank_arrays(_bank(8, eased=False), 4096, 1024,
                                       device=cuda_card)
    fp, ip, up, gains, codes = cv.one_job(args)
    before = cv.LAUNCHES
    with pytest.raises(TypeError):
        cv.render_blocks(fp.half(), ip, up, gains.half(), codes, **st)
    with pytest.raises(TypeError):
        cv.render_blocks(fp, ip, up, gains.double(), codes, **st)
    with pytest.raises(ValueError):
        cv.render_blocks(*args, **st)
    assert cv.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_tile_matches_python(cuda_card):
    assert cv.load_library().voicebank_tile() == cv.KERNEL_TILE


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [4096, 3000], ids=["tiled", "ragged"])
@pytest.mark.parametrize("n_channels", [1, 2])
def test_kernel_on_tile_edges(cuda_card, block_size, n_channels):
    """Presses and release-tail ends on a tile edge and one sample either
    side, skipped rows, and an empty last block; dense and compacted."""
    args, st, _ = edge_tables(block_size, n_channels, device=cuda_card)
    cargs, cst = tvb.compact_block_args(args, st)
    for tables, statics in ((args, st), (cargs, cst)):
        tables = cv.one_job(tables)
        k_out = cv.render_blocks_cuda(*tables, **statics)[0]
        p_out = cv.render_blocks_plain(*tables, **statics)[0]
        torch.cuda.synchronize()
        assert float(p_out.abs().max()) > 0.05
        assert float((k_out - p_out).abs().max()) <= ATOL
        assert bool((k_out[3 * block_size:] == 0).all())  # no live row


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edges", "eased"])
def test_kernel_block_offset(cuda_card, case):
    """block_offset shifts the rendered blocks along the timeline: the
    kernel against its plain version, and against the same blocks of a
    render from block 0 (the same launch geometry per block: equal to the
    bit); dense and compacted tables (a compacted table stays indexed by the
    output block). The tile-edge tables from block 1 on, an eased bank's
    from block 2 on."""
    if case == "edges":
        args, st, _ = edge_tables(4096, 2, device=cuda_card)
        offset = 1
    else:
        args, st = tvb.prepare_bank_arrays(_bank(8, eased=True, seed=3), 16384, 4096,
                                           device=cuda_card)
        offset = 2
    B, nb = st["block_size"], st["n_blocks"] - offset
    cargs, _cst = tvb.compact_block_args(args, st)
    args = cv.one_job(args)
    full = cv.render_blocks_cuda(*args, **st)[0]
    k_out = cv.render_blocks_cuda(*args, block_size=B, n_blocks=nb, block_offset=offset)[0]
    p_out = cv.render_blocks_plain(*args, block_size=B, n_blocks=nb, block_offset=offset)[0]
    c_out = cv.render_blocks_cuda(*cv.one_job(a[offset:] for a in cargs), block_size=B,
                                  n_blocks=nb, block_offset=offset)[0]
    torch.cuda.synchronize()
    assert float(p_out.abs().max()) > 0.05
    assert float((k_out - p_out).abs().max()) <= ATOL
    assert torch.equal(k_out, full[offset * B:])
    assert float((c_out - p_out).abs().max()) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("block_offset", [0, 1])
def test_kernel_job_axis(cuda_card, compact, block_offset):
    """Three jobs' tables in one launch (the batched serving step's synth):
    each job's slice equal to the bit to its own launch, and within the bar
    of the plain version; one job's dense tables without the job axis
    raise."""
    banks = [_bank(8, eased=eased, seed=seed)
             for seed, eased in ((1, False), (2, True), (3, False))]
    args, st = tvb.prepare_bank_arrays(banks, 16384 + 77, 1500, device=cuda_card)
    if compact:  # 8 voices compact to 8 rows per block for every job
        per_job = [tvb.compact_block_args(tuple(a[j] for a in args), st)[0]
                   for j in range(len(banks))]
        args = tuple(torch.stack(ts) for ts in zip(*per_job))
    statics = dict(st, n_blocks=st["n_blocks"] - block_offset, block_offset=block_offset)
    before = cv.LAUNCHES
    out = cv.render_blocks(*args, **statics)
    assert cv.LAUNCHES == before + 1
    assert out.shape == (len(banks), statics["n_blocks"] * 1500, 2)
    for j in range(len(banks)):
        tables = tuple(a[j:j + 1] for a in args)
        single = cv.render_blocks_cuda(*tables, **statics)[0]
        plain = cv.render_blocks_plain(*tables, **statics)[0]
        torch.cuda.synchronize()
        assert torch.equal(out[j], single)
        assert float(plain.abs().max()) > 0.05
        assert float((out[j] - plain).abs().max()) <= ATOL
    if not compact:  # one job's dense (V, 8) tables have no job axis
        with pytest.raises(ValueError):
            cv.render_blocks_cuda(*(a[0] for a in args), **statics)


@pytest.mark.cuda
def test_kernel_on_a_live_pull(cuda_card):
    """The live path's shape: one 512-sample block (one CTA, a ragged tile)
    at t0 = 59 s, where StreamingSynth has shifted press and release by -t0:
    a note held since t = 0 (press -2,601,900), one retuned, one releasing."""
    from cpp_audio_tpu_torch.models import streaming_synth

    cfg = sine_synth.SineSynthConfig(
        sample_rate=44100, ahdsr=envelopes.AHDSR(attack=441, hold=100, decay=2000,
                                                 release=8820, sustain=0.7))
    synth = streaming_synth.StreamingSynth(cfg, n_voices=127, device=cuda_card)
    t0 = 59 * 44100
    for i, (press, f) in enumerate([(0, 110.0), (1_000_000, 440.0), (t0 - 3000, 987.0),
                                    (t0 - 700, 1500.0), (t0 + 200, 330.0)]):
        synth.on_event(events.mk_note_on(press, f, 0.9, note_id=i, pan=0.3 * i - 0.5))
    synth.on_event(events.mk_note_change(t0 - 5000, 1, 452.0, 0.7))
    synth.on_event(events.mk_note_off(t0 - 4000, 2))
    bank = synth.bank_at(t0)
    assert bank.press.min() == -t0
    for n in (512, 496):
        args, st = tvb.prepare_bank_arrays(bank, n, n, device=cuda_card)
        before = cv.LAUNCHES
        k_out = synth.compute(t0, n)
        assert cv.LAUNCHES == before + 1
        p_out = cv.render_blocks_plain(*cv.one_job(args), **st)[0]
        torch.cuda.synchronize()
        assert k_out.shape == p_out.shape == (n, 2)
        assert float(p_out.abs().max()) > 0.02
        assert float((k_out - p_out).abs().max()) <= ATOL


def _chirp(n, sr, f0=220.0, f1=660.0):
    t = np.arange(n) / sr
    f = f0 * (f1 / f0) ** (t / t[-1])
    return 0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr)


@pytest.mark.cuda
def test_checkpointed_job_resumes_bitwise_on_the_card(cuda_card, tmp_path):
    """A checkpointed job killed after two segments and resumed on the card
    equals the uninterrupted run on the card bit for bit (every op on the
    streaming path is deterministic there), and launches the kernel."""
    from cpp_audio_tpu_torch.analysis import checkpoint
    from cpp_audio_tpu_torch.analysis.presets_json import ResynthPreset

    sr = 11025
    voice = _chirp(int(1.4 * sr), sr)
    preset = ResynthPreset(analysis_volume=1.0, vocoder_volume=0.6, voice_volume=0.1,
                           analysis_output_feedback_gain=0.3, output_delay_seconds=0.15,
                           window_size_seconds=0.05, window_center_stride_seconds=0.025,
                           vocoder_modulator_window_size_seconds=0.04,
                           vocoder_stride_seconds=0.01)
    kw = dict(post="limit", segment_seconds=0.3, device=cuda_card)
    cv.LAUNCHES = 0
    full = checkpoint.run_offline_streaming(preset, voice, voice, sr, **kw)
    assert cv.LAUNCHES > 0
    path = tmp_path / "ck.bin"
    assert checkpoint.run_offline_streaming(preset, voice, voice, sr, checkpoint_path=path,
                                            max_segments=2, **kw) is None
    resumed = checkpoint.run_offline_streaming(preset, voice, voice, sr,
                                               checkpoint_path=path, **kw)
    np.testing.assert_array_equal(resumed, full)
    assert np.abs(full).max() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_limiter_on_the_card_matches_the_cpu(cuda_card, dtype):
    """limit and limit_streaming on cuda against the same calls on the CPU:
    float64 at 1e-12 of the peak, float32 at 1e-6."""
    from cpp_audio_tpu_torch.ops import limiter

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((200_000, 2)) * np.linspace(0, 3, 200_000)[:, None],
                        dtype=dtype)
    bar = 3e-12 if dtype == torch.float64 else 1e-6
    ref = limiter.limit(x, device="cpu")
    got = limiter.limit(x.to(cuda_card), device=cuda_card)
    assert got.device.type == "cuda" and got.dtype == dtype
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0, atol=bar)
    p = torch.zeros((), dtype=dtype, device=cuda_card)
    parts = []
    for s in range(0, x.shape[0], 512):
        y, p = limiter.limit_streaming(x[s:s + 512].to(cuda_card), p, device=cuda_card)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts).cpu().numpy(), ref.numpy(), rtol=0, atol=bar)
