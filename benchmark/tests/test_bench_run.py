"""Whole runs on the CPU at a tiny size: the result line, the modules a run
loads, and the faults that `correct` has to catch."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import spec as spec_mod
from benchmark.tests.bench_tiny import run_tiny

CELLS = [w["name"] for w in spec_mod.load_spec()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(monkeypatch, workload):
    out = run_tiny(monkeypatch, workload)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    spec = spec_mod.load_spec()
    e2e = {m["name"]: m["unit"] for m in spec_mod.cell_metrics(spec, workload, False)}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == e2e
    assert all(v["value"] > 0 for v in out["metrics"].values())
    cell = spec_mod.cell(spec, workload)
    limits = spec_mod.config(spec, cell["config"])["limits"]
    assert set(out["checks"]) == set(limits)
    json.dumps(out)


def test_traced_result_line(monkeypatch):
    out = run_tiny(monkeypatch, "resynth_64v.clips_2-8s", trace=True)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["correct"] is True
    names = {m["name"] for m in spec_mod.cell_metrics(spec_mod.load_spec(),
                                                      "resynth_64v.clips_2-8s", True)}
    assert set(out["metrics"]) <= names
    assert {"stage_ms.render.clips", "stage_ms.tracker.clips", "frame_loop_pct.clips"} <= set(out["metrics"])


def test_run_loads_no_jax():
    """A whole run in a fresh process loads no module whose top-level name
    is jax, jaxlib, flax or cpp_audio_tpu (compared whole: the port's
    cpp_audio_tpu_torch is allowed)."""
    code = f"""
import sys, time
sys.path.insert(0, {str(spec_mod.ROOT)!r})
from benchmark.harness import runner, spec as spec_mod
from benchmark.tests.bench_tiny import tiny_traffic
spec_mod.traffic = tiny_traffic
runner.run_cell(spec_mod.load_spec(), "resynth_64v.single_60s", 3, 0.2, False, "cpu",
                time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=spec_mod.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "cpp_audio_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "cpp_audio_tpu"}


def test_forbidden_modules_named(monkeypatch):
    from benchmark.harness import runner

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert runner.forbidden_modules() == ["jax"]


def test_no_card_no_result(tmp_path):
    """Without the CUDA devices a cell asks for, a run exits non-zero and
    prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=spec_mod.ROOT)
    assert out.returncode != 0 and "correct" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run exits non-zero and prints no result."""
    import shutil

    shutil.copy(spec_mod.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec_mod.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "correct" not in out.stdout


def _altered_vocoder(monkeypatch):
    from cpp_audio_tpu_torch.analysis import vocoder

    real = vocoder._carrier_vocode
    monkeypatch.setattr(vocoder, "_carrier_vocode",
                        lambda *a, **k: real(*a, **k) * 1.001)


def _altered_render(monkeypatch):
    from cpp_audio_tpu_torch.models import resynth_bank

    real = resynth_bank._render_slots

    def render(table, **k):
        out = real(table, **k)
        out[..., out.shape[-3] // 2, :, :] *= 0.5  # one control frame at half level
        return out
    monkeypatch.setattr(resynth_bank, "_render_slots", render)


def _altered_peaks(monkeypatch):
    from cpp_audio_tpu_torch.ops import stft

    real = stft._top_peaks

    def peaks(*a, **k):
        freq, mag = real(*a, **k)
        return freq, mag + 0.1
    monkeypatch.setattr(stft, "_top_peaks", peaks)


def _half_the_batch(monkeypatch):
    """The batched tracker's tables of the first half of the jobs stand in
    for the rest: half of the batch left out."""
    from cpp_audio_tpu_torch.analysis import device_tracker

    real = device_tracker.build_tables_device_batch

    def build(freq, mag, *a, **k):
        tables, dropped = real(freq, mag, *a, **k)
        half = tables.shape[0] // 2 or 1
        return torch.cat([tables[:half]] * -(-tables.shape[0] // half))[:tables.shape[0]], dropped
    monkeypatch.setattr(device_tracker, "build_tables_device_batch", build)


@pytest.mark.parametrize("fault,workload", [
    (_altered_vocoder, "resynth_64v.single_60s"),
    (_altered_render, "resynth_64v.single_60s"),
    (_altered_peaks, "resynth_64v.clips_2-8s"),
    (_altered_render, "resynth_64v.batch16_60s"),
    (_half_the_batch, "resynth_64v.batch16_60s"),
], ids=["vocoded answer altered", "render altered", "peaks altered",
        "batch render altered", "half the batch left out"])
def test_fault_is_not_correct(monkeypatch, fault, workload):
    """The rest of a run, with the timed path broken underneath: `correct`
    comes out false."""
    fault(monkeypatch)
    out = run_tiny(monkeypatch, workload)
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_on_the_card(workload):
    """One short run of each cell on the card: exit 0 and correct."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", str(2**31 + 9), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=spec_mod.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"

