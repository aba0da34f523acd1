"""The plain reference against the port at a tiny size, its control, and the
frozen count of the voice-bank kernel's work."""

import ast

import pytest
import torch

from benchmark.harness import counts, spec as spec_mod
from benchmark.harness.program import Program, host_peaks
from benchmark.harness.traffic import Traffic
from benchmark.reference import chain as ref_chain
from benchmark.reference.precision import Precision

SPEC = spec_mod.load_spec()
CFG = spec_mod.config(SPEC, "resynth_64v")
RC = spec_mod.driver(CFG).reference_config(CFG)
TINY = {"batch": 1, "take_seconds": [3], "voices": 12, "takes_seed": 2**31 + 5,
        "shuffle_block": 1}


@pytest.fixture(scope="module")
def job():
    return Traffic(TINY, CFG, 1).job(0)


def test_port_agrees_with_reference(job):
    out = Program(CFG, device="cpu").run_job(job)
    f, m = host_peaks(out)
    got = dict(freq=f, mag=m, stereo=out["stereo"], vocoded=out["vocoded"],
               dropped=out["dropped"])
    nums = ref_chain.compare(job, got, RC, "cpu")
    info = nums.pop("info")
    for k, v in nums.items():
        assert v <= CFG["limits"][k], (k, v)
    assert info["knife_edges_taken"] <= CFG["limits"]["knife_edges"]


def test_peaks_are_read_only_where_the_tracker_ran_once(job, monkeypatch):
    """The check's peaks come from the tracker's entry; a job during which
    it did not run once raises, and leaves no stale peaks to the check."""
    from cpp_audio_tpu_torch.analysis import device_tracker

    program = Program(CFG, device="cpu")
    program.run_job(job)
    real = device_tracker.build_tables_device

    def twice(*a, **k):  # a chain that tracks twice: which peaks are the job's?
        real(*a, **k)
        return real(*a, **k)
    monkeypatch.setattr(device_tracker, "build_tables_device", twice)
    with pytest.raises(RuntimeError, match="not once"):
        program.run_job(job)


def test_control_fails(job):
    """The reference in the precision below the configuration's (the
    control) breaks at least one limit."""
    got = ref_chain.outputs(job, RC, Precision("lower"), "cpu")
    nums = ref_chain.compare(job, got, RC, "cpu")
    nums.pop("info")
    assert any(v > CFG["limits"][k] for k, v in nums.items()), nums


def test_reference_against_itself_reads_zero(job):
    got = ref_chain.outputs(job, RC, Precision("float64"), "cpu")
    nums = ref_chain.compare(job, got, RC, "cpu")
    assert nums["vocoded_gap"] == 0.0 and nums["resynth_gap"] == 0.0
    assert nums["peak_db_gap"] == 0.0


def test_reference_imports_nothing_of_the_program():
    for path in (spec_mod.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("cpp_audio_tpu_torch", "cpp_audio_tpu", "jax", "jaxlib",
                                   "flax", "benchmark"), (path.name, name)


def test_frozen_count_equals_the_port_kernel_bound():
    from cpp_audio_tpu_torch.models import voicebank
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    job = Traffic(spec_mod.traffic("single_60s"), CFG, 42).job(0)
    block = CFG["synth"]["block_size"]
    bank = Program(CFG, device="cpu").bank(job["voices"])
    (fp, ip, _up, gains, _codes), st = voicebank.prepare_bank_arrays(
        bank, job["n"], block, "float32", device="cpu")
    port = cv.kernel_bound(fp[None], ip[None], block_size=block, n_blocks=st["n_blocks"],
                           n_channels=int(gains.shape[-1]))
    ours = counts.kernel_bound(job["voices"], job["n"], block)
    assert ours["segments"] == port["segments"]
    assert ours["flops"] == port["flops"] and ours["bytes"] == port["bytes"]
    assert ours["bound_s"] * 1e3 == pytest.approx(port["bound_ms"], rel=1e-12)
    assert ours["live_voice_samples"] > 0


def test_precisions_differ():
    assert Precision("float64").dtype == torch.float64
    assert Precision("lower").dtype == torch.bfloat16
    with pytest.raises(ValueError):
        Precision("float16")
