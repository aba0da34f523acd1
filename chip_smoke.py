#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. card and build: the card's name and power limit (nvidia-smi), then the
     voice-bank kernel built from cpp_audio_tpu_torch/csrc/ (nvcc).
  2. kernel against its plain PyTorch version, on the card:
     (a) the bench workload's per-block compacted tables (11, 48, .) at
         block 2^18, LINEAR curves (what the chain passed before the kernel
         selected live rows per tile); (b) a dense bank whose voices carry
         eased curve codes covering all 23 curves; (c) the dense (64, .)
         tables the chain passes now. Bar: max |diff| <= 2e-5
         (tests/test_pallas_voicebank.py:45). Kernel times at (a) and (c)
         on two stopwatches (CUDA events): `cuda_ms`, one synchronised
         call with the host's enqueue on the clock (the kernels line's
         `ms`, at (a), as since the first slice), and `cuda_ms_amortized`,
         back-to-back calls behind a device sleep; plain time at (a); the
         live voice-samples, the kernel's bound
         (cuda_voicebank.kernel_bound) and the share reached.
  3. the offline chain at bench width (bench.py:52-75 rebuilt on the port's
     modules: seed 42, 64 voices, 60 s at 44.1 kHz, block 2^18, 110 Hz
     square carrier, float32) through run_offline_chain on cuda. The kernel
     launch count is set to 0 just before the timed run and read just after.
     Checks: launches > 0, 665 analysis frames, finite outputs, both legs
     peak above 1e-3; then the same chain on a 2 s workload on cuda and on
     the CPU (plain versions), held at the parity tests' bars.
Prints the kernel line {"kernels": [...]}, the card line, and last the
{"ok": true, "device": {...}} line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

KERNEL_BAR = 2e-5          # tests/test_pallas_voicebank.py:45
SR = 44100
SECONDS = 60.0
BENCH_BLOCK = 1 << 18      # bench.py:71


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_synth_workload(sr, n, seed=42, n_voices=64):
    """bench.make_synth_workload (bench.py:52-75) on the port's modules."""
    from cpp_audio_tpu_torch.core import events, voices
    from cpp_audio_tpu_torch.models import sine_synth
    from cpp_audio_tpu_torch.ops import envelopes

    rng = np.random.default_rng(seed)
    notes = []
    for i in range(n_voices):
        press = int(rng.uniform(0, n * 0.5))
        release = press + int(rng.uniform(sr, n * 0.5))
        notes.append(
            events.Note(i, press, release, float(rng.uniform(55, 3520)),
                        float(rng.uniform(0.3, 1.0)), float(rng.uniform(-1, 1)))
        )
    sch = voices.schedule_from_notes(notes, pad_to=n_voices)
    cfg = sine_synth.SineSynthConfig(
        sample_rate=sr,
        ahdsr=envelopes.AHDSR(attack=441, hold=100, decay=2000, release=8820,
                              sustain=0.7),
        block_size=BENCH_BLOCK,
        dtype="float32",
    )
    return sch, cfg


def eased_bank(n_samples: int, seed: int = 3):
    """Dense bank of 46 voices whose attack / decay / release curve codes
    cover all 23 itp curves, with envelopes short enough that every segment
    sounds inside the render."""
    from cpp_audio_tpu_torch.models.voicebank import VoiceBank

    rng = np.random.default_rng(seed)
    V = 46
    code = np.arange(V) % 23
    press = rng.uniform(0, n_samples * 0.4, V).round()
    return VoiceBank(
        press=press, release=press + rng.uniform(2000, n_samples * 0.4, V).round(),
        increment=2.0 * rng.uniform(55, 5000, V) / SR,
        phase0=rng.uniform(0, 2, V), amp=rng.uniform(0.05, 0.3, V),
        gains=rng.uniform(0, 1, (V, 2)), attack=rng.uniform(200, 3000, V),
        hold=rng.uniform(0, 500, V), decay=rng.uniform(200, 3000, V),
        release_len=rng.uniform(500, 6000, V), sustain=rng.uniform(0.2, 0.9, V),
        attack_itp=code, decay_itp=(code + 7) % 23, release_itp=(code + 13) % 23)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of fn() in ms (CUDA events), after one warm-up:
    one call per sample, so the host's enqueue of the call is on the clock.
    The `ms` of the kernels line since the first slice."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_amortized(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one fn() in ms (CUDA events): the median over rounds
    of `reps` back-to-back calls, each round queued behind a ~10 ms device
    sleep so the host's enqueue time stays off the card's clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_build():
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    t0 = time.perf_counter()
    path, log = cv.build()
    cv.load_library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _hold(name, tables, statics) -> float:
    """max |kernel - plain| on one table set; fails above the bar."""
    import torch

    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    k_out = cv.render_blocks_cuda(*tables, **statics)
    p_out = cv.render_blocks_plain(*tables, **statics)
    torch.cuda.synchronize()
    err = float((k_out - p_out).abs().max())
    print(f"[kernel] {name} {tuple(tables[0].shape)} B={statics['block_size']}: "
          f"max|kernel-plain| = {err:.3e}  peak {float(p_out.abs().max()):.4f}")
    if not err <= KERNEL_BAR:
        raise RuntimeError(f"kernel disagrees with plain on {name}: {err} > {KERNEL_BAR}")
    return err


def phase_kernel_vs_plain() -> dict:
    """Holds the kernel against its plain version on (a), (b), (c) and
    times it; returns the measured keys of its entry in the kernels line."""
    from cpp_audio_tpu_torch.models import sine_synth, voicebank
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    bank = sine_synth.bank_from_schedule(sch, cfg)
    args, st = voicebank.prepare_bank_arrays(bank, n, BENCH_BLOCK, device="cuda")
    cargs, cst = voicebank.compact_block_args(args, st)
    if tuple(cargs[0].shape[:2]) != (11, 48):
        raise RuntimeError(f"bench tables compacted to {tuple(cargs[0].shape)}, "
                           "expected (11, 48, 8)")
    err = _hold("(a) compacted LINEAR", cargs, cst)
    ne, be = 1 << 17, 1 << 14
    eargs, est = voicebank.prepare_bank_arrays(eased_bank(ne), ne, be, device="cuda")
    if sorted(set(eargs[4].flatten().tolist())) != list(range(23)):
        raise RuntimeError("eased bank does not cover all 23 curve codes")
    err = max(err, _hold("(b) dense eased", eargs, est))
    err = max(err, _hold("(c) dense headline (the chain's)", args, st))

    def kernel_a():
        return cv.render_blocks_cuda(*cargs, **cst)

    def kernel_c():
        return cv.render_blocks_cuda(*args, **st)

    times = {"ms": cuda_ms(kernel_a), "ms_amortized": cuda_ms_amortized(kernel_a),
             "ms_chain_tables": cuda_ms(kernel_c),
             "ms_chain_tables_amortized": cuda_ms_amortized(kernel_c)}
    plain_ms = cuda_ms(lambda: cv.render_blocks_plain(*cargs, **cst), reps=3)
    bound = cv.kernel_bound(cargs[0], cargs[1], n_channels=2, **cst)
    if cv.kernel_bound(args[0], args[1], n_channels=2, **st)[
            "live_voice_samples"] != bound["live_voice_samples"]:
        raise RuntimeError("compacted and dense tables disagree on the live work")
    live = bound["live_voice_samples"]
    print(f"[kernel] (a) kernel {times['ms']:.4f} ms per call, "
          f"{times['ms_amortized']:.4f} ms amortized; plain {plain_ms:.4f} ms; "
          f"(c) kernel {times['ms_chain_tables']:.4f} ms per call, "
          f"{times['ms_chain_tables_amortized']:.4f} ms amortized")
    print(f"[bound] live voice-samples {live} ({bound['segments']}), "
          f"{bound['flops']} FP32 flops, {bound['bytes']} bytes at (a): bound "
          f"{bound['bound_ms']:.5f} ms by {bound['bound_by']}; share reached "
          + ", ".join(f"{bound['bound_ms'] / t:.3f} by {k}" for k, t in times.items())
          + f"; {live / times['ms_amortized'] / 1e6:.2f} G live voice-samples/s "
          "at (a) amortized")
    return {"max_abs_err": err, **times, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, "live_voice_samples": live}


def _chain_inputs(n, sch, cfg):
    from cpp_audio_tpu_torch.analysis import resynth, vocoder
    from cpp_audio_tpu_torch.models import sine_synth

    bank = sine_synth.bank_from_schedule(sch, cfg)
    rcfg = resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                 dtype="float32")
    vparams = vocoder.VocoderParams(sample_rate=SR)
    carrier = np.sign(np.sin(2 * np.pi * 110.0 * np.arange(n) / SR))
    return bank, rcfg, vparams, carrier


def phase_chain(card: str):
    """Bench-width chain on cuda; returns the kernel launches of the timed run."""
    import torch

    from cpp_audio_tpu_torch.analysis import chain
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg)

    def run(timings=None):
        res = chain.run_offline_chain(bank, n, rcfg, vparams, carrier,
                                      block_size=cfg.block_size, device="cuda",
                                      timings=timings)
        torch.cuda.synchronize()
        return res

    t0 = time.perf_counter()
    run()
    print(f"[chain] first run {time.perf_counter() - t0:.3f} s (cuFFT plans, library loads)")
    walls = []
    for i in range(5):
        if i == 0:
            cv.LAUNCHES = 0
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = cv.LAUNCHES
    wall = statistics.median(walls)
    r, v = res.resynth, res.vocoded
    peak_r = float(r.abs().max())
    peak_v = float(v.abs().max())
    print(f"[chain] tracker={res.tracker} n_frames={res.n_frames} "
          f"resynth {tuple(r.shape)} vocoded {tuple(v.shape)} "
          f"peaks {peak_r:.4f} / {peak_v:.4f} launches={launches}")
    print(f"[chain] warm wall per render: median {wall * 1e3:.3f} ms, "
          f"max {max(walls) * 1e3:.3f} ms of {len(walls)} runs "
          f"({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms), "
          f"realtime factor {SECONDS / wall:.1f}x on {card}")
    if launches <= 0:
        raise RuntimeError("the chain launched the voice-bank kernel no time")
    if res.n_frames != 665:
        raise RuntimeError(f"n_frames {res.n_frames} != 665")
    if not (bool(torch.isfinite(r).all()) and bool(torch.isfinite(v).all())):
        raise RuntimeError("non-finite chain output")
    if not (peak_r > 1e-3 and peak_v > 1e-3):
        raise RuntimeError(f"a chain leg is silent: {peak_r}, {peak_v}")
    if r.dim() != 2 or r.shape[1] != 2:
        raise RuntimeError(f"resynth shape {tuple(r.shape)} is not (T, 2)")
    _profile_chain(run)
    return launches


def _profile_chain(run):
    """Diagnostic: wall time by stage (synchronised after each) and device
    time by kernel over one warm chain run (not a pass/fail phase;
    torch.profiler may not see the device on every machine)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stages = {}
    run(timings=stages)
    print("[stages] " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in stages.items())
          + f" (sum {sum(stages.values()) * 1e3:.3f} ms, synchronised per stage)")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    except Exception as exc:  # noqa: BLE001 - diagnostic only
        print(f"[profile] not measured ({type(exc).__name__}: {exc})")
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    print(f"[profile] device kernels {busy:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"(profiled run): device idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for key, us, count in rows[:12]:
        print(f"[profile] {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def phase_small_reference():
    """The chain on a 2 s workload, cuda against the CPU (plain versions):
    vocoded atol 1e-4, resynth max|diff|/peak < 2e-3 (the parity tests' bars)."""
    from cpp_audio_tpu_torch.analysis import chain

    n = 2 * SR
    sch, cfg = make_synth_workload(SR, n, seed=7, n_voices=8)
    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg)
    out = {dev: chain.run_offline_chain(bank, n, rcfg, vparams, carrier,
                                        block_size=1 << 13, device=dev)
           for dev in ("cuda", "cpu")}
    g, c = out["cuda"], out["cpu"]
    if g.n_frames != c.n_frames or g.resynth.shape != c.resynth.shape:
        raise RuntimeError("cuda and cpu chains disagree on shapes")
    dv = float((g.vocoded.cpu() - c.vocoded).abs().max())
    peak = max(float(c.resynth.abs().max()), 1e-9)
    dr = float((g.resynth.cpu() - c.resynth).abs().max()) / peak
    print(f"[reference] 2 s chain cuda vs cpu: vocoded max|diff| {dv:.3e}, "
          f"resynth max|diff|/peak {dr:.3e}")
    if not (dv <= 1e-4 and dr < 2e-3):
        raise RuntimeError("the cuda chain disagrees with the CPU reference")


def main() -> int:
    try:
        card = card_line()
        print(f"[card] {card}")
        import torch

        if not torch.cuda.is_available():
            print("torch.cuda.is_available() is false: no result", file=sys.stderr)
            return 1
        import cpp_audio_tpu_torch  # noqa: F401

        print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
              f"x{torch.cuda.device_count()}")
        phase_build()
        measured = phase_kernel_vs_plain()
        launches = phase_chain(card)
        phase_small_reference()
    except Exception:  # noqa: BLE001 - report any phase failure, exit non-zero
        traceback.print_exc()
        return 1
    kernels = {"kernels": [{
        "name": "voicebank_render",
        "route": "cuda",
        "source": "cpp_audio_tpu_torch/csrc/voicebank.cu",
        "replaces": "cpp_audio_tpu/ops/pallas_voicebank.py:30",
        "launches": launches,
        **measured,
    }]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
