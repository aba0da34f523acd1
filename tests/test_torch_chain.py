"""The port's offline chain (cpp_audio_tpu_torch.analysis.chain) against the
JAX package's run_offline_chain, plus the port's package-level guards.

Chain bars (tests/test_chain.py): the same n_frames and output shapes; the
vocoded leg at atol 1e-4 (float32 FFTs of the whole mixdown, rounded
differently by torch and XLA); the resynth leg at max|diff|/peak < 2e-3
(the bar of tests/test_chain.py:83 — FFT rounding moves QIFFT peak values
in their last bits, and the tracked render's float32 phase glides amplify
that; noise-floor peak churn is not a port fault, ROADMAP §C).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cpp_audio_tpu.analysis import chain, resynth, vocoder
from cpp_audio_tpu.models import sine_synth
from cpp_audio_tpu_torch import interop
from cpp_audio_tpu_torch.analysis import chain as tchain
from cpp_audio_tpu_torch.analysis import resynth as tresynth
from cpp_audio_tpu_torch.analysis import vocoder as tvocoder
from test_chain import _workload
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cpp_audio_tpu_torch"
SR = 44100


def _chain_pair(n):
    bank, cfg = _workload(SR, n)
    carrier = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(n) / SR))
    ref = chain.run_offline_chain(
        bank, n, resynth.ResynthConfig(sample_rate=SR, dtype="float32"),
        vocoder.VocoderParams(sample_rate=SR), carrier, block_size=cfg.block_size)
    timings = {}
    got = tchain.run_offline_chain(
        interop.voicebank_from_numpy(bank), n,
        tresynth.ResynthConfig(sample_rate=SR, dtype="float32"),
        tvocoder.VocoderParams(sample_rate=SR), carrier,
        block_size=cfg.block_size, device="cpu", timings=timings)
    assert list(timings) == ["synth", "analysis", "vocoder", "tracker", "render"]
    return ref, got


def test_chain_matches_jax():
    ref, got = _chain_pair(2 * SR)
    assert got.n_frames == ref.n_frames
    r_ref, v_ref = np.asarray(ref.resynth), np.asarray(ref.vocoded)
    r, v = got.resynth.numpy(), got.vocoded.numpy()
    assert r.shape == r_ref.shape and r.shape[1] == 2
    assert v.shape == v_ref.shape
    np.testing.assert_allclose(v, v_ref, atol=1e-4)
    peak = float(np.abs(r_ref).max())
    assert peak > 1e-3 and float(np.abs(v_ref).max()) > 1e-3
    assert float(np.abs(r - r_ref).max()) / peak < 2e-3


def _tone_signal(n):
    t = np.arange(n) / SR
    sig = np.zeros(n)
    for f0, s0, s1 in [(220, 0.1, 0.9), (440, 0.4, 1.6), (660, 1.0, 1.9)]:
        i0, i1 = int(s0 * SR), int(s1 * SR)
        sig[i0:i1] += 0.2 * np.hanning(i1 - i0) * np.sin(2 * np.pi * f0 * t[: i1 - i0])
    return sig


@pytest.mark.parametrize("implementation", ["native", "python"])
def test_resynthesize_matches_jax(implementation):
    n = 2 * SR
    sig = _tone_signal(n)
    kw = dict(sample_rate=SR, analysis_volume=1.0, dtype="float32")
    ref = np.asarray(resynth.resynthesize(sig, resynth.ResynthConfig(**kw),
                                          implementation=implementation))
    got = tresynth.resynthesize(sig, tresynth.ResynthConfig(**kw),
                                implementation=implementation, device_out=True,
                                device="cpu").numpy()
    assert got.shape == ref.shape
    peak = float(np.abs(ref).max())
    assert peak > 1e-3
    assert float(np.abs(got - ref).max()) / peak < 2e-3


@pytest.mark.parametrize("implementation", ["auto", "device"])
def test_resynthesize_device_matches_jax(implementation):
    """Both packages route "auto" (the default) and "device" to their
    device tracker chain (chain.resynthesize_signal_device)."""
    n = 2 * SR
    sig = _tone_signal(n)
    kw = dict(sample_rate=SR, analysis_volume=1.0, dtype="float32")
    ref = np.asarray(resynth.resynthesize(sig, resynth.ResynthConfig(**kw),
                                          implementation=implementation))
    got = tresynth.resynthesize(sig, tresynth.ResynthConfig(**kw),
                                implementation=implementation, device_out=True,
                                device="cpu").numpy()
    assert got.shape == ref.shape and got.shape[1] == 2
    peak = float(np.abs(ref).max())
    assert peak > 1e-3
    assert float(np.abs(got - ref).max()) / peak < 2e-3


def test_resynthesize_prefer_native_false_matches_jax():
    """JAX's own call (tests/test_chain.py:103-106): prefer_native=False
    sends "auto" to the Python tracker in both packages."""
    n = 2 * SR
    sig = _tone_signal(n)
    kw = dict(sample_rate=SR, analysis_volume=1.0, dtype="float32")
    ref = np.asarray(resynth.resynthesize(sig, resynth.ResynthConfig(**kw),
                                          prefer_native=False))
    got = tresynth.resynthesize(sig, tresynth.ResynthConfig(**kw),
                                prefer_native=False, device_out=True,
                                device="cpu").numpy()
    assert got.shape == ref.shape and got.shape[1] == 2
    peak = float(np.abs(ref).max())
    assert peak > 1e-3
    assert float(np.abs(got - ref).max()) / peak < 2e-3


def test_tracker_events_match_jax():
    sig = _tone_signal(2 * SR)
    cfg = resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0, dtype="float32")
    tcfg = tresynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0, dtype="float32")
    peaks = resynth.analyze(sig, cfg)
    tpeaks = tresynth.analyze(sig, tcfg, device="cpu")
    assert [len(p) for p in tpeaks] == [len(p) for p in peaks]
    # the pure-Python tracker is a copy: identical notes on identical peaks
    ref_notes, _, ref_dropped = resynth.track_python(peaks, cfg)
    got_notes, _, got_dropped = tresynth.track_python(peaks, tcfg)
    assert got_dropped == ref_dropped
    assert [(n.frames, n.release_frame, n.pan) for n in got_notes] == \
        [(n.frames, n.release_frame, n.pan) for n in ref_notes]


def test_chip_smoke_workload_matches_bench():
    """chip_smoke rebuilds bench.make_synth_workload on the port's modules:
    the same VoiceBank fields at n = 2 s."""
    import bench
    import chip_smoke

    n = 2 * SR
    sch, cfg = bench.make_synth_workload(SR, n)
    tsch, tcfg = chip_smoke.make_synth_workload(SR, n)
    assert tcfg.block_size == cfg.block_size
    ref = sine_synth.bank_from_schedule(sch, cfg)
    from cpp_audio_tpu_torch.models import sine_synth as tsine

    got = tsine.bank_from_schedule(tsch, tcfg)
    for name in ref.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "cpp_audio_tpu")]
    assert bad == []


def test_importing_every_port_module_leaves_jax_out():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cpp_audio_tpu'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_turns_tf32_off():
    import cpp_audio_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """Without CUDA (or without the package beside it) chip_smoke.py exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


@pytest.mark.parametrize("device_out", [False, True])
def test_resynthesize_device_out_matches_jax(device_out):
    """resynthesize's device_out as JAX's: numpy by default, the tensor on
    the requested device with True; at the resynth leg's bar."""
    n = 2 * SR
    sig = _tone_signal(n)
    kw = dict(sample_rate=SR, analysis_volume=1.0, dtype="float32")
    ref = resynth.resynthesize(sig, resynth.ResynthConfig(**kw), device_out=device_out)
    out_kw = {"device_out": True} if device_out else {}
    got = tresynth.resynthesize(sig, tresynth.ResynthConfig(**kw), device="cpu", **out_kw)
    if device_out:
        assert torch.is_tensor(got) and got.device == torch.device("cpu")
        got = got.numpy()
    else:
        assert isinstance(got, np.ndarray) and isinstance(ref, np.ndarray)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) / float(np.abs(ref).max()) < 2e-3


def test_version_matches_jax():
    import cpp_audio_tpu
    import cpp_audio_tpu_torch

    assert cpp_audio_tpu_torch.__version__ == cpp_audio_tpu.__version__ == "0.1.0"
