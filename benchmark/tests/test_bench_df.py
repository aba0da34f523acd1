"""The fidelity chain's cell (configuration resynth_64v_df) on the CPU at a
tiny size: its configuration is resynth_64v's but for the fidelity chain's
keys and limits, no limit looser; a traced run reads the span of its float64
analysis; and the faults a step below the precision it states, or the
float32 chain in its place, make a run not `correct`."""

import json

import pytest
import torch

from benchmark.harness import spec as spec_mod
from benchmark.tests.bench_tiny import run_tiny

CELL = "resynth_64v_df.single_60s"
OWN_KEYS = {"name", "source", "deployment", "program", "dtype", "precision", "assumed",
            "limits"}


def _configs():
    spec = spec_mod.load_spec()
    return spec_mod.config(spec, "resynth_64v_df"), spec_mod.config(spec, "resynth_64v")


def test_config_is_resynth_64v_but_its_own_keys():
    df, f32 = _configs()
    assert df["dtype"] == "df32"
    assert df["driver"] == f32["driver"] == "offline_chain"
    assert {k: v for k, v in df.items() if k not in OWN_KEYS} == {
        k: v for k, v in f32.items() if k not in OWN_KEYS}
    assert set(f32) - OWN_KEYS <= set(df)
    assert df["assumed"][:len(f32["assumed"])] == f32["assumed"]


def test_cell_runs_the_hybrid_analysis():
    """The configuration states the default "hybrid" analysis (its
    `assumed`); the mode is chain.DF_ANALYSIS_MODE, read from
    CPP_AUDIO_DF_ANALYSIS at import, which a run must leave unset."""
    from cpp_audio_tpu_torch.analysis import chain

    assert chain.DF_ANALYSIS_MODE == "hybrid"
    assert any('"hybrid"' in a for a in _configs()[0]["assumed"])


def test_no_df_limit_looser_than_resynth_64v():
    df, f32 = _configs()
    assert set(df["limits"]) == set(f32["limits"])
    assert all(df["limits"][k] <= f32["limits"][k] for k in f32["limits"])
    # the number that tells the fidelity chain from the float32 one
    assert df["limits"]["resynth_gap"] < f32["limits"]["resynth_gap"]


def test_traced_run_reads_the_float64_analysis(monkeypatch):
    """The cell reads each per-layer metric of the single job under a name
    of its own (".job" or bare -> ".df"; the df tracker and render sit
    under the same spans and counters, read by the same readers), and the
    two of its float64 analysis."""
    out = run_tiny(monkeypatch, CELL, trace=True)
    assert out["correct"] is True
    spec = spec_mod.load_spec()
    metrics = spec_mod.cell_metrics(spec, CELL, True)
    names = {m["name"] for m in metrics}
    single = {m["name"]: m for m in spec_mod.cell_metrics(spec, "resynth_64v.single_60s", True)}
    as_df = {n.removesuffix(".job") + ".df": m for n, m in single.items()}
    assert names == set(as_df) | {"stage_gpu_ms.analysis_f64.df", "host_ms.analysis_f64.df"}
    for m in metrics:
        if m["name"] in as_df:
            assert {k: v for k, v in m.items() if k not in ("name", "workloads")} == {
                k: v for k, v in as_df[m["name"]].items() if k not in ("name", "workloads")}
            assert m["workloads"] == [CELL]
    # off the card the spans have no device time and the trace no kernels
    on_card = {n for n in names if n.startswith(("stage_gpu_ms.", "voicebank_roofline.",
                                                 "device_idle_pct."))}
    assert set(out["metrics"]) == names - on_card
    assert out["metrics"]["host_ms.analysis_f64.df"]["value"] > 0
    assert out["metrics"]["host_ms.tracker.df"]["value"] > 0
    json.dumps(out)


def _float32_phase(monkeypatch):
    """The 17-field table's field 16 zeroed before the render: the phase
    advance is the increment rounded to float32."""
    from cpp_audio_tpu_torch.models import resynth_bank

    real = resynth_bank._render_slots

    def render(table, **k):
        assert table.shape[-1] == 17
        table = table.clone()
        table[..., resynth_bank._F_INC_LO] = 0.0
        return real(table, **k)
    monkeypatch.setattr(resynth_bank, "_render_slots", render)


def _float32_peaks_in_tracker(monkeypatch):
    """The df peaks rounded to float32 at the tracker's entry, after the
    analysis has handed them over (so the check reads the float64 peaks
    and the tracker works on float32 values)."""
    from cpp_audio_tpu_torch.analysis import device_tracker

    real = device_tracker.build_tables_device

    def build(freq, mag, *a, **k):
        assert freq.dtype == torch.float64
        return real(freq.float().double(), mag.float().double(), *a, **k)
    monkeypatch.setattr(device_tracker, "build_tables_device", build)


def _float32_chain(monkeypatch):
    """The float32 chain run under the df configuration's limits."""
    real = spec_mod.config

    def config(spec, name, *a):
        c = real(spec, name, *a)
        return dict(c, dtype="float32") if name == "resynth_64v_df" else c
    monkeypatch.setattr(spec_mod, "config", config)


@pytest.mark.parametrize("fault", [_float32_phase, _float32_peaks_in_tracker, _float32_chain],
                         ids=["phase advance float32", "tracker on float32 peaks",
                              "float32 chain"])
def test_float32_in_the_df_chain_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(monkeypatch, CELL)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["checks"]["resynth_gap"]["value"] > out["checks"]["resynth_gap"]["limit"]
