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
         (cuda_voicebank.kernel_bound) and the share reached. (d) the
         kernel's float64 instantiation on (c)'s and (b)'s banks in
         float64, bar 1e-12, its time amortized at (c) (`ms_f64`) beside
         its plain version's and its bound (FP64 peak).
  3. the offline chain at bench width (bench.py:52-75 rebuilt on the port's
     modules: seed 42, 64 voices, 60 s at 44.1 kHz, block 2^18, 110 Hz
     square carrier, float32) through run_offline_chain on cuda. The kernel
     launch count is set to 0 just before the timed run and read just after.
     Checks: launches > 0, 665 analysis frames, finite outputs, both legs
     peak above 1e-3; then the same chain on a 2 s workload on cuda and on
     the CPU (plain versions), held at the parity tests' bars.
  4. device chain: run_offline_chain_device (the device tracker in place of
     the host one) on the same bench-width workload on cuda: first run,
     5 warm walls, realtime factor, stages, profile, host synchronisations
     per chain; launch count as in 3. Checks as in 3, resynth (T, 2), no
     tracker host synchronisation and one frame-loop kernel launch per
     chain (on the card the exact frame loop builds every table), and
     that the frame-parallel tracker's violation flag on the chain's own
     peaks (read through device_tracker._prep_lanes / _parallel_tables) is
     false, as the JAX headline's, so that phase 5 can hold the loop's
     table against the frame-parallel one.
     Also step() of prepare_offline_chain_device alone (what the JAX
     headline times), and the synchronising calls torch's sync debug mode
     reports per chain and per step(). Then step.cost_analysis()
     (analysis/cost.py: the operations, bytes and transcendentals one
     step() needs) as bench.py's rows (:236-262) for the port, `[cost f32]`:
     gflops_per_render_f32, hbm_gb_per_render_f32, mfu_f32 (the operations
     at the card's peak for their type over the median step() wall),
     hbm_util_f32 and bound_ms_f32 (bench.py's names on another count:
     the work the inputs need, where bench.py reads XLA's count of the
     compiled program; the kernels line says so under cost_basis); and per
     stage its count's bound beside its time from the stage-timed run
     (synchronised per stage). Last,
     cost_analysis() of the 2 s float64 chain (tests/test_chain.py's
     workload) on cuda and on the CPU, the CPU's tracker sent down the
     exact frame loop as the card's is: every count equal.
  5. tracker paths: device_tracker.build_tables_device on the headline
     peaks (on the card the frame-loop kernel: one launch, no host read),
     timed beside the frame-parallel pass as the CPU takes it (frame-local
     stage, _parallel_tables, its flag read), with each one's ATen ops and
     synchronising calls; the two tables rendered, held at max|diff|/peak
     < 2e-3; the entry's table equal to the bit to the forced loop's
     (_force_scan). Then the frame-loop
     kernel (ops/cuda_scan, csrc/tracker_scan.cu) against the eager loop
     (device_tracker._scan_tables_plain) on the card: on the headline lanes
     forced, in float32 and in float64 (the fidelity chain's peaks), and on
     the violating take of the benchmark's batch16_60s takes 1056-1071
     (takes_seed 17, from the mix's own generator, staged by
     prepare_offline_chain_device_batch and analysed by one step() of it):
     dropped counts, emit masks and the slot each note takes equal, float
     fields within 1e-5 (float32) or 1e-12 (float64) of each field's
     largest magnitude, the two tables' renders within 2e-5 of the peak;
     that step in 1 kernel launch (cuda_scan.LAUNCHES set to 0 just before
     it) and 16 frame loops, its tables those of the batch of 16 in one
     launch, equal to the bit to 16 single launches. `scan_ms` (one 60 s
     job), `scan_f64_ms` (the fidelity chain's float64 loop, one 60 s
     job), `scan_batch_ms` (16 jobs, one launch), `scan_plain_ms` (the
     eager loop), `scan_launches` (that step's), `parallel_ms` and
     `parallel_ops` (the frame-parallel pass the card no longer runs) and
     `tracker_ops` (the entry's ATen ops) on the kernels line.
  6. device reference, 2 s: the device chain on cuda against the same chain
     on the CPU and against the host-tracker chain on cuda (vocoded atol
     1e-4, resynth max|diff|/peak < 2e-3); then use_autotune=True on the JAX
     autotune test's signal through resynthesize(implementation="device")
     on cuda, against the CPU and the host tracker.
  7. df chain: the fidelity chain (dtype "df32", hybrid analysis: float32
     synth and vocoder, float64 peaks, tracker and phase advance) at the
     headline width on cuda, driven and checked as in 4 (1 kernel launch
     per chain, float32 resynth), its `[cost df]` rows with the tag df32;
     the tracker's violation flag on its own float64 peaks (false); the
     "ladder" analysis once, its wall.
  8. df fidelity, 12 s of the headline workload, bench.py's rows
     (:282-394) with the float64 reference on device="cpu": same peaks
     <= -80 dB, vocoded <= -120 dB, e2e resynth printed, note_e2e_pass.
  9. df reference, 2 s: the df chain on cuda against the CPU, at the bars
     of 6.
 10. live duplex path (analysis/streaming.LiveResynth with the vocoder leg
     and a CarrierSynth holding a 110 Hz square from t = 0): (a) the 60 s
     headline mixdown fed and pulled in 512-sample steps on cuda: per-pull
     latency (host clock around pull + its .cpu() copy, and around feed +
     pull + copy) p50 / p99 / max after the first 2 s against the 11.61 ms
     budget, split by whether a window fired; wall and realtime factor;
     stats; kernel launches (one per pull with voices); checks 665 windows,
     launches > 0, finite (T, 2), both legs above 1e-3; synchronising
     calls per pull and a profile of ~1 s of steps on a fresh run over the
     first 4 s; StreamingVocoder.process on device tensors must make no
     synchronising call; the carrier's float32 gap to float64 at 59 s.
     (b) the kernel against its plain version on the tables of the run's
     last pull with voices (B = 512, negative press), timed amortized
     beside its bound. (c) StreamingSynth in 512-sample pulls over 10 s of
     held, retuned and released notes against render_schedule, both on
     cuda, bar 2e-5. (d) the 2 s live path on cuda against the CPU (stats
     equal, output < 2e-3 of peak, vocoded leg atol 1e-4), then
     deduce_notes + resynth_deduced on 12 s of the mixdown, cuda against
     the CPU (same notes, render < 2e-3 of peak).
 11. the JSON offline job and the apps, on the headline workload (its mono
     mixdown as the voice WAV, a 110 Hz square as the carrier WAV, written
     through the port's utils/wav.py into build/phase11; the chain's
     analysis and vocoder settings, every leg of the mix on, post "limit"):
     J1 offline_job.run_job at 60 s (first run, median of 3 warm walls,
     stages each synchronised; output finite within the limiter's ceiling,
     the WAV read back equal to the returned array, the 4 runs equal to the
     bit, resynthesize of the gained voice twice equal to the bit in
     torch's default mode, the mix equal to one
     rebuilt from resynthesize and vocode of the gained voice); J2 the same
     job with feedback drones (gain 0.3, delay 1 s: wall, passes), run on
     the headline workload at 12 s (12 passes, each in the device
     tracker's exact frame loop); J3
     checkpoint.run_job_checkpointed at 60 s, segment 5 s, killed after 4
     segments and resumed (walls, snapshot size, the kernel's launches:
     `launches_job`), at 12 s the resumed output bitwise equal to an
     uninterrupted run, and the synchronising calls per block with and
     without the feedback path; J4 every apps.resynth mode and both
     apps.resynth_ui modes at 2 s on cuda, each writing its outputs, and
     the --job output on cuda against the CPU (full mix < 2e-3 of peak, a
     vocoder-only job atol 1e-4); the filter-bank vocoder at 60 s (walls,
     ops) against the CPU at atol 1e-4.
 12. the tune app and the DSP ops, with the tune preset files
     (tests/test_harmonics.py:16-37: eased attack and release, 8
     harmonics, low-pass 800 Hz) written into build/phase12: (a) the 60 s
     rain stream (rain_notes seed 0) through apps.tune.render_notes, the
     harmonics synth, on cuda: rows, segments, first wall and the median
     of 3 warm walls, the kernel's launches (`launches_tune`, one per
     segment, > 0), an instrumented run splitting host prep (bank,
     segment slices, tables and copies) from the kernel's device time and
     the low-pass; output finite, peak > 1e-3. (b) the kernel against its
     plain version on the busiest segment's eased tables (bar 2e-5),
     timed amortized beside its bound. (c) a seeded 64 KB blob sonified in
     full (polyphony 4, ~4,000 notes, ~100 s): first and warm walls, launches
     (`launches_sonify`), the same split. (d) the sampler: the rain stream
     on two seeded pitched sample WAVs (wall, peak device memory, finite),
     2 s of it on cuda against the CPU at 1e-6. (e) the 60 s headline
     stereo mixdown convolved with a seeded 2 s stereo 48 kHz impulse
     response (load_impulse_response resamples it to 44.1 kHz) on cuda
     against the CPU (float32 1e-5 of peak, float64 1e-10), its wall; the
     grey noise table of get_noise_tables(44100) against fir.fft_convolve
     on cuda; apps.test_fft once. (f) every apps.tune mode at ~2 s on cuda
     (score, --demo, --rain, --sonify, --sonify-full --polyphony 2 --loop 2
     --modulo-pitch, --sample, --score2, --play), play_streaming with one
     preset edit (1 reload), the score on cuda against the CPU (1e-4), and
     every apps.wav_tools tool.
 13. the procedural engine at bench.py's L5a widths (bench.py:454-602:
     60 s at 44.1 kHz, "Heavy rain", BIRDS program 0, B = 64), on cuda:
     (a) one WIND "Heavy rain" render with device-expanded controls and
     with the host walks: first wall, median of 3 warm walls (each ending
     in torch.cuda.synchronize), ATen ops, synchronising calls, peak
     device memory, realtime factor, device idle share (profile), the warm
     renders bitwise equal; (b) the same for "Bubbles" (order 129, the
     deepest cascade); (c) one SoundEngine render of BIRDS program 0, then
     batches of 64 at 60 s on fresh seeds (500-563, warmed on 100-163) for
     BIRDS program 0 and "Talkative bird" (the largest tile): aggregate
     realtime factor (64 x 60 s / wall), peak memory, a repeat of the
     timed batch bitwise equal; (d) a WIND "Heavy rain" batch of 64 at
     60 s the same way (an out-of-memory error fails the phase); (e) all
     27 programs at 1 s on cuda against their 12-band fingerprints
     (tests/test_golden_semantics.py's, copied here: 1.5 dB, 3 dB for
     'Small animal eating' through apps.birds.render), and 2 s renders on
     cuda against the CPU (float64 1e-9 of the peak; float32 2e-4 of the
     peak for the SoundEngine, 1e-4 RMS-relative for WIND); (f) the apps
     and the engine core on cuda: apps.birds --list, one one-shot per mode
     at 2 s and a scripted --interactive session, the Birds facade
     (quanta, a program change, a loop re-render), web_demo.make_server
     around it on a localhost port (/api/info, /api/chunk, POST
     /api/program), Wrapper.process with events (its voice-bank kernel
     launches: `launches_wrapper`, > 0) and an AudioEngine with a
     StreamingConvolver and the limiter against the CPU (2e-5 of the
     peak).
 14. the device mesh (cpp_audio_tpu_torch/parallel/mesh.py): (a) one NCCL
     rank on cuda:0 in this process (a file store under build/phase14), at
     the headline width: render_bank_sharded against render_bank (equal to
     the bit); the kernel at block_offset=3 against its plain version (bar
     2e-5) and against render_bank from block 3 (equal to the bit); both
     sharded STFTs of the 60 s mixdown against stft_sqmag (rtol 2e-4, atol
     1e-8); make_sharded_chain and make_sharded_chain_2d on a (1, 1) mesh
     against run_offline_chain_device: medians of 3 warm walls (each ending
     in torch.cuda.synchronize()) beside the single-device chain's, kernel
     launches (`launches_mesh`, `launches_mesh_2d`), collectives per step,
     1e-3 of the peak and dropped equal. (b) two ranks sharing cuda:0
     (parallel/launch.spawn): which collectives gloo and NCCL take on CUDA
     tensors (a printed probe; the plan is fixed: NCCL takes no two ranks of
     one communicator on one card, so (b) runs on gloo), then
     make_sharded_chain at world 2, render_jobs_farm (2 groups of 1) and
     render_jobs_pipelined (1 + 1) on the 2 s chain test workload against
     the single-device chain on cuda, at (a)'s bars; last, each of the two
     ranks builds the device tracker's table from the same headline peaks
     (rank 0's, broadcast), and the gathered tables and dropped counts must
     be equal to the bit (C3: the replicated trackers of the sharded chains
     agree).
 15. reproducibility, in torch's default (non-deterministic) mode: 5 runs
     each of run_offline_chain_device at the headline width (float32 and
     the df chain), resynthesize of J1's gained voice, J1 end to end and
     make_sharded_chain at world 1 (one NCCL rank), every output, the
     device tracker's tables (recorded around its entries) and the
     dropped counts held against the first run's to the bit; one line per
     path with max|diff|, the tables' and dropped's equality and the kernel
     launches (`launches_repro`: the float32 chain's 5 runs); and the
     batched serving step of phase 16 (a), its tables recorded around
     build_tables_device_batch.
 16. batched serving (analysis/chain.prepare_offline_chain_device_batch):
     (a) 16 jobs of the headline (make_synth_workload seeds 42-57, 64
     voices, 60 s, block 2^18, the 110 Hz square carrier, float32) in one
     step(): first call and 5 warm walls ending in
     torch.cuda.synchronize(), the wall per job beside phase 4's
     run_offline_chain_device, kernel launches per step (must be 1; the
     count set to 0 just before a step and read just after: the kernels
     line's `launches_batch`), the tracker's host syncs (must be 0) and
     path (the exact frame loop),
     synchronising calls (sync debug mode) against a single chain's step()
     (no more), peak device memory, profile. The batched synth: each job's
     slice equal to the bit to that job's own launch, max|kernel - plain|
     (bar 2e-5), its time amortized (`ms_batch`) beside its bound
     (`bound_batch`, cuda_voicebank.kernel_bound over every job's live
     voice-samples). Each job within 1e-3 (resynth) and 3e-3 (vocoded) of
     the peak of run_offline_chain_device on its bank on cuda, dropped
     equal; then a float64 batch of 2 (seeds 42, 43) against float64
     singles at the same bars, its synth (the kernel's float64
     instantiation) equal to the bit to each job's own launch and within
     1e-12 of the plain version. (b) bench.py's breadth configurations
     (bench.py:424-452: 127 voices; use_autotune with MUSICAL_SCALE) and
     harmonize pre 7 + post 12 "merged", each through
     run_offline_chain_device at the headline width (first call, 5 warm
     walls, launches, tracker path, peak memory), then as a batch of 4
     (seeds 42-45) held against its singles as in (a); and each on a 2 s
     workload on cuda against the CPU at phase 6's bars: 127 voices and
     the harmonize over the whole chain in float64 (the same chains in
     float32 printed as a reading, without a bar; see _serving_reference),
     autotune as phase 6 holds it.
 17. the tracked-note render kernel (ops/cuda_render, csrc/tracked_render.cu)
     against its plain twin (models/resynth_bank._render_slots_plain) on the
     card at the headline's tables (the device tracker's on phase 4's
     peaks): the float32 16-field table no further from the float64 plain
     render than 1.5x the plain float32 render is (+ 1e-6), the same table
     rendered in float64 within 1e-12 of the peak of the plain, and the
     fidelity chain's 17-field float64 table rendered to float32 within
     5e-5 (tests/test_torch_cuda_render.py's bars); a batch of 16 copies
     in one launch, each job's slice equal to the bit to the single
     launch. Times (CUDA events): one synchronised call (`render_ms`),
     amortized (`render_ms_amortized`), the batch of 16 amortized
     (`render_ms_batch16`), the plain float32 render (`render_plain_ms`);
     the live (frame, slot) pairs and analysis/cost.render's bound
     (`render_bound_ms`) with the share reached; launches per call and per
     step() of prepare_offline_chain_device (`render_launches_step`, must
     be 1).
Prints the kernel line {"kernels": [...]}, the card line, and last the
{"ok": true, "device": {...}} line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

KERNEL_BAR = 2e-5          # tests/test_pallas_voicebank.py:45
# float64: the kernel and the plain version compute the same exact forms;
# they differ in FMA contraction, summation order and the last ulp of sin,
# cos and exp2 (tests/test_torch_cuda_kernels.py:test_kernel_float64_matches_plain)
KERNEL_BAR_F64 = 1e-12
SR = 44100
SECONDS = 60.0
BENCH_BLOCK = 1 << 18      # bench.py:71
CHAIN_WALLS = {}           # phase 4 and 7's median warm walls, by dtype
CHAIN_COSTS = {}           # phase 4 and 7's bench.py cost rows (the kernels line)


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


def make_chain_test_workload(sr, n):
    """tests/test_chain.py:_workload (seed 7, 8 notes, block 2^13) on the
    port's modules: the workload whose device and host chains the JAX
    tests hold at max|diff|/peak < 2e-3 (tests/test_chain.py:63-83)."""
    from cpp_audio_tpu_torch.core import events, voices
    from cpp_audio_tpu_torch.models import sine_synth
    from cpp_audio_tpu_torch.ops import envelopes

    rng = np.random.default_rng(7)
    notes = []
    for i in range(8):
        press = int(rng.uniform(0, n * 0.4))
        release = press + int(rng.uniform(sr // 4, n // 2))
        notes.append(events.Note(i, press, release, float(rng.uniform(110, 1760)),
                                 float(rng.uniform(0.3, 1.0)),
                                 float(rng.uniform(-1, 1))))
    sch = voices.schedule_from_notes(notes, pad_to=8)
    cfg = sine_synth.SineSynthConfig(
        sample_rate=sr,
        ahdsr=envelopes.AHDSR(attack=441, hold=100, decay=2000, release=4410,
                              sustain=0.7),
        block_size=1 << 13,
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
    from cpp_audio_tpu_torch.ops import cuda_render as cr
    from cpp_audio_tpu_torch.ops import cuda_scan as cs
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    for mod in (cv, cr, cs):
        t0 = time.perf_counter()
        path, log = mod.build()
        mod.load_library()
        print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")


def _hold(name, tables, statics, bar=None) -> float:
    """max |kernel - plain| on one job's table set (with the job axis);
    fails above the bar (KERNEL_BAR unless given)."""
    import torch

    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    k_out = cv.render_blocks_cuda(*tables, **statics)
    p_out = cv.render_blocks_plain(*tables, **statics)
    torch.cuda.synchronize()
    err = float((k_out - p_out).abs().max())
    bar = KERNEL_BAR if bar is None else bar
    print(f"[kernel] {name} {tuple(tables[0].shape)} {tables[0].dtype} "
          f"B={statics['block_size']}: max|kernel-plain| = {err:.3e} (bar {bar})  "
          f"peak {float(p_out.abs().max()):.4f}")
    if not (err <= bar and k_out.dtype == p_out.dtype == tables[0].dtype):
        raise RuntimeError(f"kernel disagrees with plain on {name}: {err} > {bar}")
    return err


def phase_kernel_vs_plain() -> dict:
    """Holds the kernel against its plain version on (a), (b), (c) and, in
    float64, (d), and times it; returns the measured keys of its entry in
    the kernels line."""
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
    args, cargs = cv.one_job(args), cv.one_job(cargs)
    err = _hold("(a) compacted LINEAR", cargs, cst)
    ne, be = 1 << 17, 1 << 14
    eargs, est = voicebank.prepare_bank_arrays(eased_bank(ne), ne, be, device="cuda")
    if sorted(set(eargs[4].flatten().tolist())) != list(range(23)):
        raise RuntimeError("eased bank does not cover all 23 curve codes")
    err = max(err, _hold("(b) dense eased", cv.one_job(eargs), est))
    err = max(err, _hold("(c) dense headline (the chain's)", args, st))
    # (d) the float64 instantiation on the headline's tables (the float64
    # chains' synth), and on the eased bank
    args64 = cv.one_job(voicebank.prepare_bank_arrays(bank, n, BENCH_BLOCK, "float64",
                                                      device="cuda")[0])
    err64 = _hold("(d) dense headline float64", args64, st, KERNEL_BAR_F64)
    e64 = voicebank.prepare_bank_arrays(eased_bank(ne), ne, be, "float64", device="cuda")[0]
    err64 = max(err64, _hold("(d) dense eased float64", cv.one_job(e64), est,
                             KERNEL_BAR_F64))

    def kernel_a():
        return cv.render_blocks_cuda(*cargs, **cst)

    def kernel_c():
        return cv.render_blocks_cuda(*args, **st)

    times = {"ms": cuda_ms(kernel_a), "ms_amortized": cuda_ms_amortized(kernel_a),
             "ms_chain_tables": cuda_ms(kernel_c),
             "ms_chain_tables_amortized": cuda_ms_amortized(kernel_c)}
    ms_f64 = cuda_ms_amortized(lambda: cv.render_blocks_cuda(*args64, **st))
    plain_ms_f64 = cuda_ms(lambda: cv.render_blocks_plain(*args64, **st), reps=3)
    bound64 = cv.kernel_bound(args64[0], args64[1], n_channels=2, **st)
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
    print(f"[kernel] (d) float64 at the dense headline tables: {ms_f64:.4f} ms "
          f"amortized; plain {plain_ms_f64:.4f} ms; bound {bound64['bound_ms']:.5f} ms "
          f"by {bound64['bound_by']} ({bound64['flops']} FP64 flops, "
          f"{bound64['bytes']} bytes), share {bound64['bound_ms'] / ms_f64:.3f}")
    return {"max_abs_err": err, **times, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, "live_voice_samples": live,
            "max_abs_err_f64": err64, "ms_f64": ms_f64, "plain_ms_f64": plain_ms_f64,
            "bound_f64": bound64["bound_ms"], "bound_f64_by": bound64["bound_by"]}


def _chain_inputs(n, sch, cfg, dtype="float32"):
    from cpp_audio_tpu_torch.analysis import resynth, vocoder
    from cpp_audio_tpu_torch.models import sine_synth

    bank = sine_synth.bank_from_schedule(sch, cfg)
    rcfg = resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                 dtype=dtype)
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
    print(f"[chain] tracker={res.tracker} n_frames={res.n_frames} "
          f"resynth {tuple(r.shape)} vocoded {tuple(v.shape)} "
          f"peaks {float(r.abs().max()):.4f} / {float(v.abs().max()):.4f} "
          f"launches={launches}")
    print(f"[chain] warm wall per render: median {wall * 1e3:.3f} ms, "
          f"max {max(walls) * 1e3:.3f} ms of {len(walls)} runs "
          f"({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms), "
          f"realtime factor {SECONDS / wall:.1f}x on {card}")
    _check_chain_result(res, launches)
    _profile_chain(run)
    return launches


def _profile_chain(run, tag=""):
    """Diagnostic: wall time by stage (synchronised after each) and device
    time by kernel over one warm chain run (not a pass/fail phase;
    torch.profiler may not see the device on every machine). Returns the
    stage times (s)."""
    stages = {}
    run(timings=stages)
    print(f"[{tag}stages] " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in stages.items())
          + f" (sum {sum(stages.values()) * 1e3:.3f} ms, synchronised per stage)")
    _profile_run(run, tag)
    return stages


def _profile_run(run, tag="", top=12):
    """Diagnostic: device time by kernel and the device's idle share over
    one run, synchronised at its end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    except Exception as exc:  # noqa: BLE001 - diagnostic only
        print(f"[{tag}profile] not measured ({type(exc).__name__}: {exc})")
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    print(f"[{tag}profile] device kernels {busy:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"(profiled run): device idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}; "
          f"{sum(r[2] for r in rows)} device activities (kernels and copies)")
    for key, us, count in rows[:top]:
        print(f"[{tag}profile] {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


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


def _check_chain_result(res, launches):
    """The checks phases 3 and 4 share; returns the two legs' peaks."""
    import torch

    r, v = res.resynth, res.vocoded
    peak_r = float(r.abs().max())
    peak_v = float(v.abs().max())
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
    return peak_r, peak_v


def phase_device_chain(card: str, dtype: str = "float32") -> int:
    """Bench-width device-tracker chain on cuda at `dtype` ("float32", or
    "df32": the fidelity chain); returns the kernel launches of its first
    timed run."""
    import torch

    from cpp_audio_tpu_torch.analysis import chain
    from cpp_audio_tpu_torch.analysis import device_tracker as tdt
    from cpp_audio_tpu_torch.ops import cuda_scan
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    tag = "device chain" if dtype == "float32" else "df chain"
    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg, dtype)

    def run(timings=None):
        res = chain.run_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                             block_size=cfg.block_size,
                                             device="cuda", timings=timings)
        torch.cuda.synchronize()
        return res

    t0 = time.perf_counter()
    run()
    print(f"[{tag}] first run {time.perf_counter() - t0:.3f} s")
    walls = []
    for i in range(5):
        if i == 0:
            cv.LAUNCHES = tdt.HOST_SYNCS = cuda_scan.LAUNCHES = 0
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches, syncs, scans = cv.LAUNCHES, tdt.HOST_SYNCS, cuda_scan.LAUNCHES
    wall = statistics.median(walls)
    CHAIN_WALLS[dtype] = wall
    peak_r, peak_v = _check_chain_result(res, launches)
    print(f"[{tag}] tracker={res.tracker} n_frames={res.n_frames} "
          f"dropped={int(res.dropped)} resynth {tuple(res.resynth.shape)} "
          f"{res.resynth.dtype} vocoded {tuple(res.vocoded.shape)} peaks "
          f"{peak_r:.4f} / {peak_v:.4f} launches={launches} tracker host "
          f"synchronisations per chain={syncs} frame-loop kernel launches={scans}")
    print(f"[{tag}] warm wall per render: median {wall * 1e3:.3f} ms, "
          f"max {max(walls) * 1e3:.3f} ms of {len(walls)} runs "
          f"({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms), "
          f"realtime factor {SECONDS / wall:.1f}x on {card}")
    if syncs != 0 or scans != 1:
        raise RuntimeError(f"{syncs} tracker host synchronisations and {scans} frame-loop "
                           "kernel launches per chain, expected 0 and 1")
    if launches != 1 or int(res.dropped) != 0 or res.resynth.dtype != torch.float32:
        raise RuntimeError(f"{tag}: {launches} kernel launches, dropped "
                           f"{int(res.dropped)}, resynth {res.resynth.dtype}; "
                           "expected 1, 0, float32")
    # the program the JAX headline times: staged once, step() back to back
    step, _ = chain.prepare_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                                 block_size=cfg.block_size,
                                                 device="cuda")

    def run_step():
        out = step()
        torch.cuda.synchronize()
        return out

    run_step()
    step_walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_step()
        step_walls.append(time.perf_counter() - t0)
    step_wall = statistics.median(step_walls)
    print(f"[{tag}] step() alone (arguments staged once): median "
          f"{step_wall * 1e3:.3f} ms of 5 runs "
          f"({', '.join(f'{w * 1e3:.3f}' for w in step_walls)} ms), realtime "
          f"factor {SECONDS / step_wall:.1f}x on {card}")
    print(f"[{tag}] synchronising calls torch reports (sync debug "
          f"mode): per chain {_reported_syncs(run)}; per step() "
          f"{_reported_syncs(run_step)}")
    ca = step.cost_analysis()
    stages = _profile_chain(run, tag="device " if dtype == "float32" else "df ")
    print_cost(card, "f32" if dtype == "float32" else "df32", ca, step_wall,
               stages)
    if dtype == "float32":
        check_cost_card_vs_cpu(card)
    return launches


def cost_rows(ca: dict, wall_s: float, tag: str) -> dict:
    """bench.py's cost rows (bench.py:236-262) of one step's
    cost_analysis() at its median wall: GFLOP and GB per render, the MFU
    (the operations at the card's peak for their type, float32 and
    float64, over the wall), the HBM utilisation (bytes at HBM_PEAK over
    the wall), and the step's bound (ms) with what bounds it."""
    from cpp_audio_tpu_torch.analysis import cost

    flops, f64, nbytes = ca["flops"], ca["flops_f64"], ca["bytes accessed"]
    bound, by = cost.bound_ms(flops, f64, nbytes)
    return {f"gflops_per_render_{tag}": flops / 1e9,
            f"hbm_gb_per_render_{tag}": nbytes / 1e9,
            f"mfu_{tag}": cost.op_seconds(flops, f64) / wall_s,
            f"hbm_util_{tag}": nbytes / cost.HBM_PEAK / wall_s,
            f"bound_ms_{tag}": bound, f"bound_by_{tag}": by}


def print_cost(card: str, tag: str, ca: dict, step_wall: float,
               stages: dict) -> None:
    """The `[cost f32]` / `[cost df]` lines: the step's rows (into
    CHAIN_COSTS) and each stage's bound beside its synchronised time."""
    from cpp_audio_tpu_torch.analysis import cost

    rows = cost_rows(ca, step_wall, tag)
    # bench.py's names, counted otherwise: the work the inputs need, where
    # bench.py reads XLA's count of the compiled (padded) program
    CHAIN_COSTS.update(rows, cost_basis=ca["count basis"])
    label = "f32" if tag == "f32" else "df"
    print(f"[cost {label}] " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in rows.items())
        + f" (count basis: {ca['count basis']}, not XLA's compiled program; "
        f"float64 GFLOP {ca['flops_f64'] / 1e9:.6g}, transcendentals "
        f"{ca['transcendentals']:.6g}, tracker path {ca['tracker path']}, "
        + ", ".join(f"{k} {ca[k]:.0f}" for k in (
            "tracker peaks", "tracker lanes", "tracker notes", "tracker rows",
            "render live pairs"))
        + f"; over the median "
        f"step() wall {step_wall * 1e3:.3f} ms, not synchronised within) on "
        f"{card}")
    for s in cost.STAGES:
        bound, by = cost.bound_ms(ca[f"{s} flops"], ca[f"{s} flops_f64"],
                                  ca[f"{s} bytes accessed"])
        t_ms = stages[s] * 1e3
        staging = "; includes staging the arguments" if s == "synth" else ""
        print(f"[cost {label}] stage {s}: GFLOP {ca[f'{s} flops'] / 1e9:.6g} "
              f"(float64 {ca[f'{s} flops_f64'] / 1e9:.6g}), GB "
              f"{ca[f'{s} bytes accessed'] / 1e9:.6g}, transcendentals "
              f"{ca[f'{s} transcendentals']:.6g}, bound {bound:.6g} ms ({by}), "
              f"stage time {t_ms:.3f} ms (synchronised after each stage, "
              f"unlike step()'s wall{staging}), bound / time "
              f"{bound / t_ms:.4g} on {card}")


def check_cost_card_vs_cpu(card: str) -> None:
    """cost_analysis() of the 2 s float64 chain (tests/test_chain.py's
    workload) on cuda and on the CPU: every count equal (counts do not
    depend on the device; float64 keeps the tracker's decisions off the
    float32 knife-edges). The card's tracker takes the exact frame loop,
    so the CPU's is sent there too (the route told to skip the
    frame-parallel try): the path is part of the count."""
    from cpp_audio_tpu_torch.analysis import chain
    from cpp_audio_tpu_torch.analysis import device_tracker as tdt

    n = 2 * SR
    sch, cfg = make_chain_test_workload(SR, n)
    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg, "float64")
    got = {}
    route = tdt._tries_frame_parallel
    for dev in ("cuda", "cpu"):
        step, _ = chain.prepare_offline_chain_device(
            bank, n, rcfg, vparams, carrier, block_size=cfg.block_size,
            device=dev)
        if dev == "cpu":
            tdt._tries_frame_parallel = lambda *a: False
        try:
            got[dev] = step.cost_analysis()
        finally:
            tdt._tries_frame_parallel = route
    if got["cuda"] != got["cpu"]:
        diff = {k: (v, got["cpu"].get(k)) for k, v in got["cuda"].items()
                if got["cpu"].get(k) != v}
        raise RuntimeError(f"cost_analysis differs, cuda against the CPU: {diff}")
    ca = got["cuda"]
    print(f"[cost check] 2 s float64 chain: all {len(ca)} cost_analysis() "
          f"entries equal on cuda and the CPU (GFLOP {ca['flops'] / 1e9:.6g}, "
          f"GB {ca['bytes accessed'] / 1e9:.6g}, render live pairs "
          f"{ca['render live pairs']:.0f}, tracker path {ca['tracker path']}) "
          f"on {card}")


def _sync_hits(run) -> tuple[int, str]:
    """The synchronising CUDA calls torch's sync debug mode reports over one
    run: their count, and the lines that made them (the explicit
    torch.cuda.synchronize that ends a run is not among them)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    where = sorted({str(w.filename).rsplit("/", 1)[-1] + f":{w.lineno}" for w in hits})
    return len(hits), ", ".join(where) or "none"


def _reported_syncs(run) -> str:
    """Diagnostic: _sync_hits as "count (lines)"."""
    count, where = _sync_hits(run)
    return f"{count} ({where})"


def _dispatched_ops(run) -> int:
    """Diagnostic: the count of ATen ops one run dispatches, views included
    (chain.dispatched_ops)."""
    from cpp_audio_tpu_torch.analysis import chain

    return len(chain.dispatched_ops(run))


def headline_tracker_inputs(n, sch, cfg, dev, dtype="float32"):
    """The device chain's tracker inputs at `dtype` ("float32", or "df32":
    the fidelity chain's float64 ones), staged as
    chain.prepare_offline_chain_device stages them: the peaks of the
    chain's analysis and the tracker's arrays (loudness tables, draw
    pools), its keywords (autotune arrays included) and the render
    config."""
    from cpp_audio_tpu_torch.analysis import chain, resynth

    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg, dtype)
    bank_args, av_args, av_kw = chain._stage_analyze_vocode(
        bank, n, rcfg, vparams, carrier, cfg.block_size, dev)
    freq, mag, _mix = chain._analyze_vocode(*bank_args, *av_args, **av_kw)
    render = resynth._render_config(rcfg)
    arrays, kw = chain._tracker_inputs(rcfg, render, int(freq.shape[0]), None,
                                       freq.dtype, dev)
    return (freq, mag, *arrays), kw, render


def check_frame_parallel(tag, inputs, kw):
    """The violation flag of the frame-parallel tracker on `inputs` (read
    through device_tracker._prep_lanes / _parallel_tables, as the entries
    read it where they try that path); fails unless it is false, as the
    JAX headline's. The card builds the table with the exact frame loop;
    the frame-parallel table it would have taken is valid only where the
    flag is false, and phase 5 holds the two at the render."""
    from cpp_audio_tpu_torch.analysis import device_tracker as tdt

    freq, mag, loud_p, loud_s, pan, phase, at = tdt._inputs(
        *inputs, kw["autotune_arrays"], inputs[0].device)
    tpitch, volume, order, _k = tdt._prep_lanes(freq, mag, loud_p, loud_s, at, kw)
    defaults = tdt._default_row(freq.dtype, freq.device)
    _table, viol = tdt._parallel_tables(tpitch, volume, order, freq.shape[0],
                                        pan, phase, defaults, kw)
    valid = tpitch[:freq.shape[0]].isfinite()
    print(f"[{tag}] headline peaks {tuple(freq.shape)} {freq.dtype}: lanes "
          f"{tpitch.shape[-1]}, tuned pitches per frame max "
          f"{int(valid.sum(-1).max())} mean {float(valid.sum(-1).float().mean()):.1f}; "
          f"frame-parallel violation flag {bool(viol)}")
    if bool(viol) or not kw["min_volume"] > 0:
        raise RuntimeError(f"{tag}: the frame-parallel tracker would not take the headline")


def _scan_lanes(inputs, kw):
    """The exact frame loop's (T, k) lanes of one job's staged tracker
    inputs (device_tracker._inputs, _prep_lanes), its pools and defaults."""
    from cpp_audio_tpu_torch.analysis import device_tracker as tdt

    freq, mag, loud_p, loud_s, pan, phase, at = tdt._inputs(
        *inputs, kw["autotune_arrays"], inputs[0].device)
    tp, vol, order, _k = tdt._prep_lanes(freq, mag, loud_p, loud_s, at, kw)
    return (tp, vol, order), (pan, phase), tdt._default_row(freq.dtype, freq.device)


def _hold_scan(tag, lanes, F, pools, defaults, kw, render):
    """The frame-loop kernel against the eager loop (_scan_tables_plain) on
    the card for one job: dropped counts, emit masks (the rows that are the
    defaults row) and the slot each note takes equal; float fields within
    1e-5 (float32) or 1e-12 (float64) of each field's largest magnitude;
    the two tables' float32 renders within 2e-5 of the peak. Returns the
    kernel's table and the eager loop's wall (s)."""
    import torch

    from cpp_audio_tpu_torch.analysis import device_tracker as tdt
    from cpp_audio_tpu_torch.models import resynth_bank

    tp, vol, order = lanes
    got_t, got_d = tdt._scan_tables(tp[None], vol[None], order[None], F, *pools,
                                    defaults, kw)
    got_t, got_d = got_t[0], got_d[0]
    plain_s, (want_t, want_d) = _synced_wall(
        lambda: tdt._scan_tables_plain(tp, vol, order, F, *pools, defaults, kw))
    emit_g = ~(got_t == defaults).all(-1)
    emit_w = ~(want_t == defaults).all(-1)
    press_g = torch.where(emit_g, got_t[..., tdt._F_TP0], 0)
    press_w = torch.where(emit_w, want_t[..., tdt._F_TP0], 0)
    scale = want_t.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    gaps = ((got_t - want_t).abs().amax(dim=(0, 1)) / scale)
    bits = bool(torch.equal(got_t, want_t))
    outs = [resynth_bank._render_slots(t.float(), stride=render.stride,
                                       dtype="float32").reshape(-1, 2)
            for t in (got_t, want_t)]
    peak = float(outs[1].abs().max())
    r_gap = float((outs[0] - outs[1]).abs().max()) / max(peak, 1e-9)
    bar = 1e-5 if tp.dtype == torch.float32 else 1e-12
    print(f"[scan kernel] {tag}: {tuple(got_t.shape)} {tp.dtype}, lanes {tp.shape[-1]}; "
          f"dropped {int(got_d)} / eager {int(want_d)}; emitted rows {int(emit_g.sum())} / "
          f"{int(emit_w.sum())}, masks equal {bool(torch.equal(emit_g, emit_w))}, slots' "
          f"presses equal {bool(torch.equal(press_g, press_w))}; equal to the bit {bits}; "
          f"largest field gap / field max {float(gaps.max()):.3e} (field "
          f"{int(gaps.argmax())}; bar {bar:g}); renders max|diff|/peak {r_gap:.3e} (peak "
          f"{peak:.4f}, bar 2e-5); eager loop {plain_s:.3f} s")
    if not (int(got_d) == int(want_d) and torch.equal(emit_g, emit_w)
            and torch.equal(press_g, press_w) and float(gaps.max()) <= bar
            and r_gap <= 2e-5 and peak > 1e-3):
        raise RuntimeError(f"{tag}: the frame-loop kernel disagrees with the eager loop")
    return got_t, plain_s


def _violating_batch(dev, first=1056, count=16):
    """The benchmark's 60 s takes `first`..`first + count - 1` of the
    `batch16_60s` mix (takes_seed 17: a batch in which one take sets the
    violation flag), taken from the mix's own generator (Traffic.job) and run
    through the serving path: prepare_offline_chain_device_batch, then one
    step(), with cuda_scan.LAUNCHES set to 0 just before it. The peaks and
    arguments the step hands to build_tables_device_batch, and its tables,
    are kept. Returns (takes, reading): per take its lanes, pools, defaults,
    keywords, render config and whether the frame-parallel tracker's
    violation flag is set for it; the step's kernel launches, frame loops,
    tables and dropped counts."""
    import torch

    from benchmark.harness import program, traffic
    from cpp_audio_tpu_torch.analysis import chain, resynth
    from cpp_audio_tpu_torch.analysis import device_tracker as tdt
    from cpp_audio_tpu_torch.models.voicebank import VoiceBank
    from cpp_audio_tpu_torch.ops import cuda_scan

    with open("benchmark/configs/resynth_64v.json") as fh:
        config = json.load(fh)
    with open("benchmark/traffic/batch16_60s.json") as fh:
        mix = traffic.Traffic(json.load(fh), config, seed=0)
    block = first // mix.block
    jobs = sorted((mix.job(i) for i in range(block * mix.block, (block + 1) * mix.block)),
                  key=lambda j: j["take"])
    jobs = [j for j in jobs if first <= j["take"] < first + count]
    if [j["take"] for j in jobs] != list(range(first, first + count)):
        raise RuntimeError(f"takes {first}-{first + count - 1} are not one shuffle block")
    rconfig, vparams = program.program_configs(config)
    step, _n_frames = chain.prepare_offline_chain_device_batch(
        [VoiceBank(**j["voices"]) for j in jobs], jobs[0]["n"], rconfig, vparams,
        jobs[0]["carrier"], block_size=config["synth"]["block_size"], device=dev)
    plain, kept = tdt.build_tables_device_batch, {}

    def keeping(freq, mag, *args, **kw):
        kept.update(freq=freq, mag=mag, arrays=args, kw=kw)
        kept["out"] = plain(freq, mag, *args, **kw)
        return kept["out"]

    tdt.build_tables_device_batch = keeping
    try:
        torch.cuda.synchronize()
        loops = tdt.FRAME_LOOPS
        cuda_scan.LAUNCHES = 0
        step()
        torch.cuda.synchronize()
        reading = dict(launches=cuda_scan.LAUNCHES, loops=tdt.FRAME_LOOPS - loops,
                       tables=kept["out"][0], dropped=kept["out"][1])
    finally:
        tdt.build_tables_device_batch = plain
    kw = {n: v for n, v in kept["kw"].items() if n != "device"}
    render = resynth._render_config(rconfig)
    takes = []
    for b, job in enumerate(jobs):
        freq, mag = kept["freq"][b], kept["mag"][b]
        lanes, pools, defaults = _scan_lanes((freq, mag, *kept["arrays"]), kw)
        _table, viol = tdt._parallel_tables(*lanes, freq.shape[0], *pools, defaults, kw)
        takes.append(dict(take=job["take"], frames=int(freq.shape[0]), kw=kw,
                          render=render, lanes=lanes, pools=pools, defaults=defaults,
                          violates=bool(viol)))
    torch.cuda.synchronize()
    return takes, reading


def phase_tracker_paths() -> dict:
    """The tracker's two paths on the headline peaks on cuda: the
    violation flag of the frame-parallel path (must be false, as the JAX
    headline's); build_tables_device as the chain calls it (on the card the
    frame-loop kernel: one launch, no host read), its table equal to the
    bit to the forced loop's; the frame-parallel pass as the CPU takes it
    (frame-local stage, _parallel_tables, the flag read), each timed (median
    of 5) and its ATen ops and synchronising calls counted; their renders
    held at max|diff|/peak < 2e-3. Then the frame-loop kernel (ops/cuda_scan)
    against the eager loop on the card (_hold_scan): on the headline lanes
    (forced) in float32 and in float64 (the fidelity chain's peaks), and on
    the violating take of the benchmark's batch of takes 1056-1071, as one
    serving step analyses it (_violating_batch); that step in 1 launch and
    16 frame loops, its tables the batch launch's, whose 16 jobs equal to
    the bit 16 single launches. Times: `scan_ms` (one 60 s job, amortized),
    `scan_f64_ms` (the float64 loop of the fidelity chain's lanes, one 60 s
    job, amortized), `scan_batch_ms` (16 jobs, one launch, amortized),
    `scan_plain_ms` (the eager loop, one job, one synchronised call),
    `parallel_ms` (the frame-parallel pass, one synchronised call);
    `scan_launches` (the serving step's launches), `parallel_ops` and
    `tracker_ops` (ATen ops, views included, of the frame-parallel pass and
    of build_tables_device)."""
    import torch

    from cpp_audio_tpu_torch.analysis import device_tracker as tdt
    from cpp_audio_tpu_torch.models import resynth_bank
    from cpp_audio_tpu_torch.ops import cuda_scan

    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    inputs, kw, render = headline_tracker_inputs(n, sch, cfg, "cuda")
    check_frame_parallel("tracker", inputs, kw)

    def build(force_scan=False):
        table, dropped = tdt.build_tables_device(
            *inputs, device="cuda", _force_scan=force_scan, **kw)
        torch.cuda.synchronize()
        return table, dropped

    def parallel():
        freq, mag, loud_p, loud_s, pan, phase, at = tdt._inputs(
            *inputs, kw["autotune_arrays"], "cuda")
        tp, vol, order, _k = tdt._prep_lanes(freq, mag, loud_p, loud_s, at, kw)
        table, viol = tdt._parallel_tables(tp, vol, order, freq.shape[0], pan, phase,
                                           tdt._default_row(freq.dtype, freq.device), kw)
        flag = bool(viol)
        torch.cuda.synchronize()
        return table, flag

    build()
    parallel()
    cuda_scan.LAUNCHES = tdt.HOST_SYNCS = 0
    runs = [_synced_wall(build) for _ in range(5)]
    scans, syncs = cuda_scan.LAUNCHES, tdt.HOST_SYNCS
    t_loop, (loop, d_loop) = statistics.median(r[0] for r in runs), runs[-1][1]
    par_runs = [_synced_wall(parallel) for _ in range(5)]
    t_par, (par, viol) = statistics.median(r[0] for r in par_runs), par_runs[-1][1]
    forced, _d = build(True)
    outs = [resynth_bank._render_slots(t, stride=render.stride,
                                       dtype="float32").reshape(-1, 2)
            for t in (par, loop)]
    peak = float(outs[0].abs().max())
    rel = float((outs[1] - outs[0]).abs().max()) / max(peak, 1e-9)
    ops_loop, ops_par = _dispatched_ops(build), _dispatched_ops(parallel)
    print(f"[tracker paths] build_tables_device (the frame-loop kernel) "
          f"{t_loop * 1e3:.3f} ms over {kw['total_frames']} frames, frame-parallel "
          f"pass {t_par * 1e3:.3f} ms (medians of 5 synchronised calls); over 5 calls "
          f"{scans} kernel launches, {syncs} tracker host reads; dropped {int(d_loop)}, "
          f"frame-parallel flag {viol}; equal to the bit to the forced loop "
          f"{bool(torch.equal(loop, forced))}; renders max|diff|/peak {rel:.3e} "
          f"(peak {peak:.4f})")
    print(f"[tracker paths] synchronising calls torch reports (sync debug "
          f"mode): build_tables_device {_reported_syncs(build)}; frame-parallel "
          f"pass {_reported_syncs(parallel)}")
    print(f"[tracker paths] ATen ops dispatched (views included): build_tables_device "
          f"{ops_loop}, frame-parallel pass {ops_par}")
    if not (scans == 5 and syncs == 0 and int(d_loop) == 0 and not viol
            and torch.equal(loop, forced) and peak > 1e-3 and rel < 2e-3):
        raise RuntimeError("build_tables_device did not take the frame-loop kernel, or its "
                           "table disagrees with the frame-parallel tracker's")
    _frame_local_memory(inputs, kw)

    F = int(inputs[0].shape[0])
    lanes, pools, defaults = _scan_lanes(inputs, kw)
    _hold_scan("headline, forced", lanes, F, pools, defaults, kw, render)
    inputs64, kw64, render64 = headline_tracker_inputs(n, sch, cfg, "cuda", dtype="df32")
    lanes64, pools64, defaults64 = _scan_lanes(inputs64, kw64)
    F64 = int(inputs64[0].shape[0])
    _hold_scan("headline float64 (fidelity peaks), forced", lanes64,
               F64, pools64, defaults64, kw64, render64)
    scan_f64_ms = cuda_ms_amortized(lambda: cuda_scan.scan_tables_cuda(
        *(a[None] for a in lanes64), F64, *pools64, defaults64, kw64), reps=10)

    takes, step = _violating_batch("cuda")
    bad = [t for t in takes if t["violates"]]
    print(f"[scan kernel] benchmark takes {takes[0]['take']}-{takes[-1]['take']} "
          f"(batch16_60s, takes_seed 17): violation flag set on takes "
          f"{[t['take'] for t in bad]}")
    if not bad:
        raise RuntimeError("no take of the batch sets the violation flag")
    scan_launches = step["launches"]
    print(f"[scan kernel] one step() of prepare_offline_chain_device_batch on them: "
          f"{scan_launches} frame-loop kernel launch, {step['loops']} frame loops")
    if not (scan_launches == 1 and step["loops"] == len(takes)):
        raise RuntimeError("the serving step did not take the frame loop in one launch "
                           "for the whole batch")
    plain_s = None
    for t in bad:
        _table, wall = _hold_scan(f"take {t['take']} (violating)", t["lanes"],
                                  t["frames"], t["pools"], t["defaults"], t["kw"],
                                  t["render"])
        plain_s = wall if plain_s is None else plain_s
    one = bad[0]
    F1 = one["frames"]
    stack = [torch.stack([t["lanes"][i] for t in takes]) for i in range(3)]

    def kernel_one():
        return cuda_scan.scan_tables_cuda(*(a[None] for a in one["lanes"]), F1,
                                          *one["pools"], one["defaults"], one["kw"])

    def kernel_batch():
        return cuda_scan.scan_tables_cuda(*stack, F1, *one["pools"], one["defaults"],
                                          one["kw"])

    b_t, b_d = kernel_batch()
    for i, t in enumerate(takes):
        s_t, s_d = cuda_scan.scan_tables_cuda(*(a[None] for a in t["lanes"]), F1,
                                              *t["pools"], t["defaults"], t["kw"])
        if not (torch.equal(b_t[i], s_t[0]) and torch.equal(b_d[i], s_d[0])):
            raise RuntimeError(f"take {t['take']}: its slice of the batch launch is not "
                               "its own launch")
    if not (torch.equal(step["tables"], b_t) and torch.equal(step["dropped"], b_d)):
        raise RuntimeError("the serving step's tables are not the batch launch's")
    print(f"[scan kernel] the batch of {len(takes)} in one launch equals {len(takes)} "
          f"single launches to the bit, and the serving step's tables are that launch's")
    scan_ms = cuda_ms_amortized(kernel_one, reps=10)
    scan_batch_ms = cuda_ms_amortized(kernel_batch, reps=5)
    print(f"[scan kernel] scan_ms {scan_ms:.4f} (one {F1 + 8}-frame job, amortized), "
          f"scan_f64_ms {scan_f64_ms:.4f} (the headline's float64 lanes, amortized), "
          f"scan_batch_ms {scan_batch_ms:.4f} (16 jobs, one launch, amortized), "
          f"scan_plain_ms {plain_s * 1e3:.1f} (the eager loop, one synchronised call), "
          f"scan_launches {scan_launches} (in one serving step of the violating batch); "
          f"parallel_ms {t_par * 1e3:.3f} and parallel_ops {ops_par} (the frame-parallel "
          f"pass), tracker_ops {ops_loop} (build_tables_device)")
    return {"scan_ms": scan_ms, "scan_f64_ms": scan_f64_ms, "scan_batch_ms": scan_batch_ms,
            "scan_plain_ms": plain_s * 1e3, "scan_launches": scan_launches,
            "parallel_ms": t_par * 1e3, "parallel_ops": ops_par, "tracker_ops": ops_loop}


def _frame_local_memory(inputs, kw, batch: int = 8):
    """Diagnostic: the peak device memory of the tracker's frame-local
    stage (device_tracker._prep_lanes, where the one-hot group sums build
    their (rows, lanes, groups) masks) on the headline peaks: as the
    headline runs it, with harmonize pre and post in the "merged"
    semantics (each stage doubles the lanes and adds a group sum over
    them; the headline's "reference" semantics adds none), and on a batch
    of `batch` copies of the peaks (the batch builder's rows are batch x
    frames)."""
    import torch

    from cpp_audio_tpu_torch.analysis import device_tracker as tdt

    freq, mag, loud_p, loud_s, _pan, _phase, at = tdt._inputs(
        *inputs, kw["autotune_arrays"], inputs[0].device)
    cases = (("headline", freq, mag, kw),
             ("harmonize pre 7 + post 12, merged", freq, mag,
              {**kw, "harmonize_pre": 7.0, "harmonize_post": 12.0,
               "harmonize_semantics": "merged"}),
             (f"batch of {batch}", freq.expand(batch, -1, -1).contiguous(),
              mag.expand(batch, -1, -1).contiguous(), kw))
    parts = []
    for name, f, m, case_kw in cases:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lanes = tdt._prep_lanes(f, m, loud_p, loud_s, at, case_kw)[-1]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        parts.append(f"{name} ({tuple(f.shape)} peaks, {lanes} lanes out) "
                     f"{peak / 2**20:.1f} MiB")
    print("[tracker memory] frame-local stage, peak device memory above its "
          "inputs: " + "; ".join(parts))


def autotune_test_signal(sr):
    """tests/test_device_tracker_autotune.py:_signal: four Hann-windowed
    sines over 2 s, the signal of the JAX package's device-vs-host autotune
    test."""
    n = sr * 2
    t = np.arange(n) / sr
    sig = np.zeros(n)
    for f0, s0, s1, a in [(441.3, 0.1, 1.2, 0.4), (333.7, 0.3, 1.8, 0.3),
                          (552.1, 0.8, 1.9, 0.25), (221.9, 0.0, 0.7, 0.3)]:
        i0, i1 = int(s0 * sr), int(s1 * sr)
        sig[i0:i1] += a * np.hanning(i1 - i0) * np.sin(
            2 * np.pi * f0 * t[: i1 - i0])
    return sig


def _hold_resynth(name, other, g, o, bar=2e-3) -> None:
    peak = max(float(o.abs().max()), 1e-9)
    dr = float((g.cpu() - o.cpu()).abs().max()) / peak
    print(f"[device reference] {name}: cuda device chain vs {other}: resynth "
          f"max|diff|/peak {dr:.3e} (peak {peak:.4f})")
    if not (g.shape == o.shape and peak > 1e-3 and dr < bar):
        raise RuntimeError(f"{name}: the cuda device chain disagrees with {other}")


def phase_device_reference():
    """The 2 s device chain on tests/test_chain.py's workload on cuda
    against the same chain on the CPU and against the host-tracker chain on
    cuda (vocoded atol 1e-4, resynth max|diff|/peak < 2e-3,
    tests/test_chain.py:80-83); then the "scale_major" autotune config
    (use_autotune=True, seed 5) on the JAX package's autotune test signal
    (tests/test_device_tracker_autotune.py:18-68): the device path of
    resynthesize on cuda against the CPU and against the host (python)
    tracker on cuda, at the same resynth bar. (Autotune snaps pitches onto a
    semitone grid, and the tracker matches a pitch to the previous frame's
    within +-max_track_pitches = 1 semitone: where a snapped pitch lands one
    float32 ulp off the grid, that window's edge falls exactly on a
    neighbouring grid pitch, and the card and the CPU, whose float32 peaks
    differ in the last bits, may continue different notes. On the chain
    workload that is what happens, so the autotune config is held on the
    signal its JAX test uses.)"""
    import dataclasses

    from cpp_audio_tpu_torch.analysis import chain, resynth

    n = 2 * SR
    sch, cfg = make_chain_test_workload(SR, n)
    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg)
    args = (bank, n, rcfg, vparams, carrier)
    g = chain.run_offline_chain_device(*args, block_size=1 << 13, device="cuda")
    others = {
        "cpu device chain": chain.run_offline_chain_device(
            *args, block_size=1 << 13, device="cpu"),
        "cuda host chain": chain.run_offline_chain(
            *args, block_size=1 << 13, device="cuda")}
    for other, o in others.items():
        if g.n_frames != o.n_frames or int(g.dropped) != 0:
            raise RuntimeError(f"the cuda device chain and {other} disagree on frames")
        dv = float((g.vocoded.cpu() - o.vocoded.cpu()).abs().max())
        print(f"[device reference] default, 2 s chain: vocoded max|diff| {dv:.3e} "
              f"against {other}")
        if not dv <= 1e-4:
            raise RuntimeError(f"the cuda device chain's vocoder disagrees with {other}")
        _hold_resynth("default, 2 s chain", other, g.resynth, o.resynth)

    sig = autotune_test_signal(SR)
    acfg = dataclasses.replace(rcfg, use_autotune=True, seed=5, analysis_volume=1.0)
    g = resynth.resynthesize(sig, acfg, implementation="device", device_out=True,
                             device="cuda")
    for other, o in (
            ("cpu device path", resynth.resynthesize(
                sig, acfg, implementation="device", device_out=True, device="cpu")),
            ("cuda python tracker", resynth.resynthesize(
                sig, acfg, implementation="python", device_out=True, device="cuda"))):
        n_o = min(g.shape[0], o.shape[0])
        _hold_resynth("autotune scale_major, 2 s signal", other, g[:n_o], o[:n_o])


RENDER_BAR_DF = 5e-5       # tests/test_torch_cuda_render.py: the 17-field float32 render


def phase_render_kernel(card: str) -> dict:
    """Phase 17: the tracked-note render kernel against its plain twin at
    the headline's tables, its times, bound and launches; returns the
    measured keys of its entry in the kernels line."""
    import torch

    from cpp_audio_tpu_torch.analysis import chain, cost
    from cpp_audio_tpu_torch.analysis import device_tracker as tdt
    from cpp_audio_tpu_torch.models import resynth_bank as rb
    from cpp_audio_tpu_torch.ops import cuda_render as cr

    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    inputs, kw, render = headline_tracker_inputs(n, sch, cfg, "cuda")
    table, _ = tdt.build_tables_device(*inputs, device="cuda", **kw)
    inputs_df, kw_df, _ = headline_tracker_inputs(n, sch, cfg, "cuda", "df32")
    table_df, _ = tdt.build_tables_device_df(*inputs_df, device="cuda", **kw_df)
    S = render.stride
    F, P = table.shape[0], table.shape[1]

    def kernel(t, dtype="float32"):
        return rb._render_slots(t, stride=S, dtype=dtype)

    def plain(t, dtype="float32"):
        return rb._render_slots_plain(t, stride=S, dtype=dtype)

    before = cr.LAUNCHES
    got = kernel(table)
    launches_call = cr.LAUNCHES - before
    exact = plain(table, "float64")
    peak = float(exact.abs().max())
    err_kernel = float((got.double() - exact).abs().max())
    err_plain = float((plain(table).double() - exact).abs().max())
    got64 = kernel(table, "float64")
    err64 = float((got64 - plain(table.double(), "float64")).abs().max())
    got_df = kernel(table_df)
    err_df = float((got_df - plain(table_df)).abs().max())
    batch = table.expand(16, *table.shape).contiguous()
    out16 = kernel(batch)
    same16 = all(torch.equal(out16[j], got) for j in range(16))
    torch.cuda.synchronize()
    print(f"[render] headline table {tuple(table.shape)} {table.dtype}, df "
          f"{tuple(table_df.shape)} {table_df.dtype}, stride {S}, peak {peak:.4f}: "
          f"float32 max|kernel-float64| {err_kernel:.3e} against the plain float32's "
          f"{err_plain:.3e} (bar 1.5x + 1e-6); float64 max|kernel-plain| "
          f"{err64:.3e} (bar {KERNEL_BAR_F64 * peak:.3e}); df float32 "
          f"{err_df:.3e} (bar {RENDER_BAR_DF}); batch of 16 equal to the single "
          f"launch: {same16}; launches per call {launches_call}")
    if not (err_kernel <= 1.5 * err_plain + 1e-6 and err64 <= KERNEL_BAR_F64 * peak
            and err_df <= RENDER_BAR_DF and same16 and launches_call == 1
            and peak > 1e-3):
        raise RuntimeError("the render kernel disagrees with its plain twin")

    times = {"render_ms": cuda_ms(lambda: kernel(table)),
             "render_ms_amortized": cuda_ms_amortized(lambda: kernel(table)),
             "render_ms_f64": cuda_ms_amortized(lambda: kernel(table.double(), "float64")),
             "render_ms_df": cuda_ms_amortized(lambda: kernel(table_df)),
             "render_ms_batch16": cuda_ms_amortized(lambda: kernel(batch), reps=5),
             "render_plain_ms": cuda_ms(lambda: plain(table), reps=3)}
    live = int(cost.live_pairs(table, stride=S, dtype="float32").sum())
    c = cost.render(live, stride=S, total_frames=F, n_slots=P, n_fields=16,
                    table_float64=False, dtype="float32")
    bound, by = cost.bound_ms(c["flops_f32"] + c["flops_f64"], c["flops_f64"],
                              c["bytes"])
    print(f"[render] kernel {times['render_ms']:.4f} ms per call, "
          f"{times['render_ms_amortized']:.4f} amortized; float64 "
          f"{times['render_ms_f64']:.4f}, df {times['render_ms_df']:.4f}, batch of 16 "
          f"{times['render_ms_batch16']:.4f} ms amortized; plain float32 "
          f"{times['render_plain_ms']:.4f} ms; live pairs {live} of {F * P}, "
          f"{c['flops_f32'] / 1e9:.4f} GFLOP float32, {c['bytes'] / 1e6:.3f} MB: bound "
          f"{bound:.5f} ms by {by}, share {bound / times['render_ms_amortized']:.4f} "
          f"amortized on {card}")

    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg)
    step, _ = chain.prepare_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                                 block_size=cfg.block_size,
                                                 device="cuda")
    step()
    torch.cuda.synchronize()
    before = cr.LAUNCHES
    step()
    torch.cuda.synchronize()
    launches_step = cr.LAUNCHES - before
    print(f"[render] launches per step() of the device chain: {launches_step}")
    if launches_step != 1:
        raise RuntimeError(f"{launches_step} render launches in one step()")
    return {"render_max_abs_err": err_kernel, "render_max_abs_err_plain": err_plain,
            "render_max_abs_err_f64": err64, "render_max_abs_err_df": err_df,
            **times, "render_bound_ms": bound, "render_bound_by": by,
            "render_live_pairs": live, "render_launches_call": launches_call,
            "render_launches_step": launches_step}


def phase_df_chain(card: str) -> int:
    """The fidelity chain (dtype "df32", hybrid analysis) at the headline
    width on cuda, as phase 4 drives the float32 one; then the tracker's
    violation flag on its own float64 peaks (must be false), and the
    "ladder" analysis once at the headline. Returns the kernel launches of
    its first timed run (must be 1)."""
    import torch

    from cpp_audio_tpu_torch.analysis import chain

    launches = phase_device_chain(card, "df32")
    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    inputs, kw, _render = headline_tracker_inputs(n, sch, cfg, "cuda", "df32")
    check_frame_parallel("df chain", inputs, kw)
    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg, "df32")
    mode = chain.DF_ANALYSIS_MODE
    chain.DF_ANALYSIS_MODE = "ladder"
    try:
        t0 = time.perf_counter()
        res = chain.run_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                             block_size=cfg.block_size,
                                             device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        chain.DF_ANALYSIS_MODE = mode
    _check_chain_result(res, 1)
    print(f"[df chain] ladder analysis (CPP_AUDIO_DF_ANALYSIS=ladder), one run: "
          f"wall {wall * 1e3:.3f} ms, dropped {int(res.dropped)}, peak "
          f"{float(res.resynth.abs().max()):.4f} on {card}")
    return launches


def rms_db(err, ref) -> float:
    """bench.py's fidelity measure: 20 log10 of RMS error over RMS reference."""
    r = float(np.sqrt(np.mean(np.square(ref))))
    e = float(np.sqrt(np.mean(np.square(err))))
    return 20.0 * np.log10(max(e, 1e-30) / max(r, 1e-30))


def phase_df_fidelity():
    """bench.py's fidelity rows (:282-394) for the port, at 12 s of the
    headline workload: the fidelity chain on cuda against the float64
    reference, which runs on device="cpu" (bench.py runs it in a CPU
    subprocess): same peaks (the chain's own df32_analysis_peaks through
    build_tables_native and render_table at float64) <= -80 dB; vocoded
    against run_offline_chain at float64 <= -120 dB; the end-to-end resynth
    printed (no bar); the note-level rows of df32_chain_table against
    host_chain_table at float64 (tools/note_metrics.py) with note_e2e_pass
    true. Also printed: same peaks through the Python host tracker, whose
    table is float64 (the native packer's is float32)."""
    import pathlib

    import torch

    from cpp_audio_tpu_torch.analysis import chain, resynth
    from cpp_audio_tpu_torch.models import resynth_bank
    from cpp_audio_tpu_torch.ops import stft

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tools"))
    import note_metrics

    fsec = 12.0
    fn = int(SR * fsec)
    sch, cfg = make_synth_workload(SR, fn)
    bank, fcfg, vparams, carrier = _chain_inputs(fn, sch, cfg, "df32")
    args = (bank, fn, fcfg, vparams, carrier)
    kw = dict(block_size=cfg.block_size, device="cuda")
    res = chain.run_offline_chain_device(*args, **kw)
    dev_resynth = res.resynth.cpu().numpy().astype(np.float64)
    dev_voc = res.vocoded.cpu().numpy().astype(np.float64)
    freq, mag = chain.df32_analysis_peaks(*args, **kw)
    table_dev = chain.df32_chain_table(*args, **kw)
    torch.cuda.synchronize()

    print("[df fidelity] the float64 reference side runs on device='cpu' "
          "(a reference, as bench.py runs it in a CPU subprocess; not a fallback)")
    t0 = time.perf_counter()
    cfg64 = resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0,
                                  dtype="float64")
    rcfg64 = resynth._render_config(cfg64)
    n_frames = int(freq.shape[0])
    same = {
        "native": resynth_bank.render_table(
            resynth.build_tables_native(freq, mag, cfg64, n_frames + 8, rcfg64),
            rcfg64, device="cpu"),
        "python": resynth_bank.render_tracked(
            resynth.track(stft.top_peaks_to_lists(freq, mag), cfg64,
                          prefer_native=False)[0],
            n_frames, rcfg64, device="cpu")}
    args64 = (bank, fn, cfg64, vparams, carrier)
    e2e = chain.run_offline_chain(*args64, block_size=cfg.block_size, device="cpu")
    table_host = chain.host_chain_table(*args64, block_size=cfg.block_size,
                                        device="cpu")
    print(f"[df fidelity] float64 reference on the CPU: {time.perf_counter() - t0:.1f} s")

    def db_vs(ref, got):
        m = min(len(got), len(ref))
        return rms_db(got[:m] - ref[:m], ref[:m])

    row = {"fidelity_seconds": fsec,
           "fidelity_db_resynth": db_vs(same["native"], dev_resynth),
           "fidelity_db_resynth_python_tracker": db_vs(same["python"], dev_resynth),
           "fidelity_db_resynth_e2e": db_vs(e2e.resynth.numpy(), dev_resynth),
           "fidelity_db_vocoded": db_vs(e2e.vocoded.numpy(), dev_voc)}
    nm = note_metrics.note_level_metrics(table_dev, table_host, SR)
    row.update({f"note_{k}": nm[k] for k in (
        "f1_weighted", "f1", "freq_rms_cents", "vol_rms_db",
        "freq_median_cents", "vol_median_db")})
    row["note_counts"] = [nm["n_notes_a"], nm["n_notes_b"], nm["n_matched"]]
    # bench.py:389-394
    row["note_e2e_pass"] = bool(
        nm["f1_weighted"] >= 0.98 and nm["freq_rms_cents"] <= 1.0
        and nm["vol_rms_db"] <= 0.5 and nm["freq_median_cents"] <= 0.1
        and nm["vol_median_db"] <= 0.1)
    print(f"[df fidelity] {json.dumps(row)}")
    if not (row["fidelity_db_resynth"] <= -80.0
            and row["fidelity_db_vocoded"] <= -120.0 and row["note_e2e_pass"]):
        raise RuntimeError("the fidelity chain misses a bar: same peaks <= -80 dB, "
                           "vocoded <= -120 dB, note_e2e_pass")


def phase_df_reference():
    """The 2 s fidelity chain on tests/test_chain.py's workload on cuda
    against the same chain on the CPU: resynth max|diff|/peak < 2e-3 and
    vocoded atol 1e-4, the bars of phase 6."""
    from cpp_audio_tpu_torch.analysis import chain

    n = 2 * SR
    sch, cfg = make_chain_test_workload(SR, n)
    args = _chain_inputs(n, sch, cfg, "df32")
    g, c = (chain.run_offline_chain_device(args[0], n, *args[1:],
                                           block_size=1 << 13, device=dev)
            for dev in ("cuda", "cpu"))
    if g.n_frames != c.n_frames or int(g.dropped) != int(c.dropped):
        raise RuntimeError("the cuda and cpu df chains disagree on frames")
    dv = float((g.vocoded.cpu() - c.vocoded).abs().max())
    print(f"[df reference] 2 s df chain: vocoded max|diff| {dv:.3e} cuda vs cpu")
    if not dv <= 1e-4:
        raise RuntimeError("the cuda df chain's vocoder disagrees with the CPU")
    _hold_resynth("df chain, 2 s", "cpu df chain", g.resynth, c.resynth)


LIVE_BLOCK = 512                     # samples per pull (run_duplex's default)
LIVE_BUDGET_MS = 1e3 * LIVE_BLOCK / SR  # 11.61 ms: one pull's share of real time
LIVE_LATE = 50 * SR                  # "late" pulls: the input falls silent near 57 s


def headline_mixdown(n, dev):
    """The headline workload's mono mixdown (the chain's synth leg), as host
    float64: the live path's captured input."""
    from cpp_audio_tpu_torch.models import sine_synth, voicebank

    sch, cfg = make_synth_workload(SR, n)
    out = voicebank.render_bank(sine_synth.bank_from_schedule(sch, cfg), n,
                                block_size=cfg.block_size, device=dev)
    return out.sum(dim=1).cpu().numpy().astype(np.float64)


def make_live(dev, *, seed=0, osc=None):
    """LiveResynth as the chain is configured (ResynthConfig and
    VocoderParams of _chain_inputs, 127 voices) with its vocoder leg driven
    by a CarrierSynth holding a 110 Hz note from t = 0 (the headline's
    carrier, square by default)."""
    from cpp_audio_tpu_torch.analysis import resynth, streaming, vocoder
    from cpp_audio_tpu_torch.core import events
    from cpp_audio_tpu_torch.models import carrier

    car = carrier.CarrierSynth(carrier.CarrierSynthConfig(
        sample_rate=SR, osc=carrier.CarrierOscMix(**(osc or {"square": 1.0})),
        seed=seed), device=dev)
    car.on_event(events.Event(events.EventType.NOTE_ON, 0, 1, 110.0, 1.0))
    return streaming.LiveResynth(
        resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0), n_voices=127,
        vocoder_params=vocoder.VocoderParams(sample_rate=SR), carrier_synth=car,
        device=dev)


def record_legs(live):
    """Keep each pull's synth leg and vocoder output (references only: no
    device work is added), the bank with the most notes of the pulls from
    LIVE_LATE on ("late", the latest of equals) and of the whole run
    ("busiest")."""
    legs = {"synth": [], "vocoder": [], "late": None, "busiest": None}
    synth_compute, process, bank_at = (live.synth.compute, live.vocoder.process,
                                       live.synth.bank_at)

    def compute(t0, n):
        legs["synth"].append(out := synth_compute(t0, n))
        return out

    def vocode(mod, car):
        legs["vocoder"].append(out := process(mod, car))
        return out

    def keep(key, t0, b, notes):
        if legs[key] is None or notes >= legs[key][2]:
            legs[key] = (t0, b, notes)

    def bank(t0):
        b = bank_at(t0)
        if b is not None:
            notes = int((b.amp > 0).sum())
            keep("busiest", t0, b, notes + 0.5 * (legs["busiest"] is None))
            if t0 >= LIVE_LATE:
                keep("late", t0, b, notes)
        return b

    live.synth.compute, live.vocoder.process, live.synth.bank_at = compute, vocode, bank
    return legs


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def phase_live(card: str) -> dict:
    """Phase 10: the live duplex path on cuda. (a) the headline mixdown, 60
    s, fed and pulled in 512-sample steps through LiveResynth with the
    vocoder leg; (b) the kernel against its plain version on a late pull's
    tables; (c) StreamingSynth streamed against the offline render; (d) the
    live path and note deduction on cuda against the CPU. Returns the
    kernels-line keys it measures."""
    import torch

    from cpp_audio_tpu_torch.models import voicebank
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    n = int(SR * SECONDS)
    sig = headline_mixdown(n, "cuda")
    live = make_live("cuda")
    legs = record_legs(live)
    pulls, feeds, fired, outs = [], [], [], []
    x = torch.zeros(16, device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x = x + 1.0
    torch.cuda.synchronize()
    print(f"[live] host dispatch of a tiny CUDA add: "
          f"{(time.perf_counter() - t0) / 2000 * 1e6:.2f} us per op on this host")
    # diagnostics of the long pulls: the interpreter's collections of its
    # oldest generation (when, how long) and the CUDA caching allocator's
    # new device allocations and retries over the run
    collections, gc_start = [], []

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                gc_start.append(time.perf_counter())
            elif gc_start:
                collections.append((len(pulls), time.perf_counter() - gc_start.pop()))

    mem0 = torch.cuda.memory_stats()
    gc.callbacks.append(on_gc)
    cv.LAUNCHES = 0
    t_run = time.perf_counter()
    try:
        for i in range(0, n, LIVE_BLOCK):
            blk = sig[i:i + LIVE_BLOCK]
            w = live.stats.windows
            t0 = time.perf_counter()
            live.feed(blk)
            t1 = time.perf_counter()
            out = live.pull(len(blk)).cpu()
            t2 = time.perf_counter()
            feeds.append(t1 - t0)
            pulls.append(t2 - t1)
            fired.append(live.stats.windows > w)
            outs.append(out)
    finally:
        gc.callbacks.remove(on_gc)
    wall = time.perf_counter() - t_run
    launches = cv.LAUNCHES
    mem1 = torch.cuda.memory_stats()
    print(f"[live] during the run: {len(collections)} collections of the oldest "
          "Python generation (pull, ms: "
          + ", ".join(f"{p} {d * 1e3:.1f}" for p, d in collections[:8])
          + f"); CUDA allocator: {mem1.get('num_device_alloc', 0) - mem0.get('num_device_alloc', 0)} "
          f"new device allocations, {mem1.get('num_alloc_retries', 0) - mem0.get('num_alloc_retries', 0)} "
          "retries")
    out = torch.cat(outs)
    synth_leg = torch.cat(legs["synth"])
    voc_leg = torch.cat(legs["vocoder"])
    peak_s, peak_v = float(synth_leg.abs().max()), float(voc_leg.abs().max())
    st = live.stats
    print(f"[live] 60 s headline mixdown in {len(pulls)} pulls of {LIVE_BLOCK} "
          f"(last {n - LIVE_BLOCK * (len(pulls) - 1)}): wall {wall:.3f} s, realtime "
          f"factor {SECONDS / wall:.2f}x on {card}; stats {vars(st)}; synth "
          f"launches {launches}; output {tuple(out.shape)} {out.dtype}, peaks "
          f"resynth leg {peak_s:.4f}, vocoded leg {peak_v:.4f}")
    skip = int(2 * SR) // LIVE_BLOCK
    steps = [f + p for f, p in zip(feeds, pulls)]
    for name, xs in (("pull(512) + .cpu()", pulls), ("feed + pull + .cpu()", steps)):
        xs, fw = xs[skip:], fired[skip:]
        win = [x for x, f in zip(xs, fw) if f]
        quiet = [x for x, f in zip(xs, fw) if not f]
        over = lambda v: sum(x * 1e3 > LIVE_BUDGET_MS for x in v)  # noqa: E731
        worst = int(np.argmax(xs))
        print(f"[live] {name}, {len(xs)} pulls after the first 2 s: p50 "
              f"{_pct(xs, 50):.3f} ms, p99 {_pct(xs, 99):.3f} ms, max "
              f"{max(xs) * 1e3:.3f} ms (pull {worst + skip}, window "
              f"{fw[worst]}); over the {LIVE_BUDGET_MS:.2f} ms budget: "
              f"{over(xs)}; window pulls {len(win)}: p50 {_pct(win, 50):.3f} p99 "
              f"{_pct(win, 99):.3f} ms, {over(win)} over; others {len(quiet)}: p50 "
              f"{_pct(quiet, 50):.3f} p99 {_pct(quiet, 99):.3f} ms, {over(quiet)} over")
    if st.windows != 665 or launches <= 0:
        raise RuntimeError(f"live run: {st.windows} windows (665 expected), "
                           f"{launches} kernel launches")
    if not (bool(torch.isfinite(out).all()) and out.shape == (n, 2)):
        raise RuntimeError(f"live output {tuple(out.shape)} is not finite (T, 2)")
    if not (peak_s > 1e-3 and peak_v > 1e-3):
        raise RuntimeError(f"a live leg is silent: {peak_s}, {peak_v}")

    # (b) the kernel against its plain version on a late pull's tables and
    # on the run's busiest pull's, and its time at both
    err, times = 0.0, {}
    for key in ("late", "busiest"):
        t_pull, bank, n_notes = legs[key]
        args, stat = voicebank.prepare_bank_arrays(bank, LIVE_BLOCK, LIVE_BLOCK,
                                                   device="cuda")
        args = cv.one_job(args)
        err = max(err, _hold(f"(d) live pull ({key}) at t0 = {t_pull} "
                             f"({t_pull / SR:.2f} s), {int(n_notes)} notes, press min "
                             f"{int(bank.press.min())}", args, stat))
        ms = cuda_ms_amortized(lambda: cv.render_blocks_cuda(*args, **stat))
        ms_call = cuda_ms(lambda: cv.render_blocks_cuda(*args, **stat))
        bound = cv.kernel_bound(args[0], args[1], n_channels=2, **stat)
        times[key] = (ms, bound["bound_ms"])
        print(f"[live kernel] {key} pull {tuple(args[0].shape)} x {LIVE_BLOCK}: "
              f"{ms:.5f} ms amortized, {ms_call:.5f} ms per synchronised call; bound "
              f"{bound['bound_ms']:.6f} ms by {bound['bound_by']} "
              f"({bound['live_voice_samples']} live voice-samples, {bound['bytes']} "
              f"bytes); share {bound['bound_ms'] / ms:.4f} amortized")
    ms_live, bound_live = times["busiest"]
    live_diagnostics(sig)
    carrier_late_gap()
    phase_live_streamed_vs_offline()
    launches_notes = phase_live_reference()
    return {"launches_live": launches, "launches_notes": launches_notes,
            "ms_live": ms_live, "bound_live": bound_live,
            "max_abs_err_live": err}


def live_diagnostics(sig):
    """Synchronising calls per pull (sync debug mode) over 50 steps that
    include window pulls, the same with a pageable .cpu() of each output,
    the vocoder alone on device tensors (must make none), and a profile of
    ~1 s of steps: a fresh LiveResynth over the first 4 s of the input."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cpp_audio_tpu_torch.analysis import streaming, vocoder

    live = make_live("cuda")
    blocks = [sig[i:i + LIVE_BLOCK] for i in range(0, 4 * SR, LIVE_BLOCK)]

    def step(blk):
        live.feed(blk)
        return live.pull(len(blk))

    for blk in blocks[:200]:
        step(blk)
    torch.cuda.synchronize()
    w0 = live.stats.windows
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for blk in blocks[200:250]:
                step(blk)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    where = {}
    for w in hits:
        key = str(w.filename).rsplit("/", 1)[-1] + f":{w.lineno}"
        where[key] = where.get(key, 0) + 1
    print(f"[live syncs] 50 steps (feed + pull, {live.stats.windows - w0} window "
          f"pulls): {len(hits)} synchronising calls, {len(hits) / 50:.2f} per pull: "
          + ", ".join(f"{k} x{v}" for k, v in sorted(where.items())))

    sv = streaming.StreamingVocoder(vocoder.VocoderParams(sample_rate=SR), device="cuda")
    mod = torch.as_tensor(sig[:20 * LIVE_BLOCK], device="cuda")
    car = torch.sign(torch.sin(2 * np.pi * 110.0 * torch.arange(
        20 * LIVE_BLOCK, device="cuda", dtype=torch.float64) / SR))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(0, 20 * LIVE_BLOCK, LIVE_BLOCK):
                sv.process(mod[i:i + LIVE_BLOCK], car[i:i + LIVE_BLOCK])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    v_hits = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    print(f"[live syncs] StreamingVocoder.process on device tensors, 20 blocks "
          f"({20 * LIVE_BLOCK // sv.stride} carrier windows): {len(v_hits)} "
          "synchronising calls")
    if v_hits:
        raise RuntimeError("StreamingVocoder.process synchronised on device tensors: "
                           f"{[str(w.message) for w in v_hits[:3]]}")

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for blk in blocks[250:336]:
                step(blk).cpu()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    except Exception as exc:  # noqa: BLE001 - diagnostic only
        print(f"[live profile] not measured ({type(exc).__name__}: {exc})")
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    print(f"[live profile] 86 steps (~1 s of audio): device kernels {busy:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall: device idle share "
          f"{max(0.0, 1 - busy / (wall * 1e3)):.3f}; "
          f"{sum(r[2] for r in rows)} device activities")
    for key, us, count in rows[:10]:
        print(f"[live profile] {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def carrier_late_gap():
    """The carrier's float32 closed form at t0 = 59 s against the same
    voices at float64, on the card (a sine voice held from t = 50 and one
    glided at t = 2000; continuous waveforms, so the gap is the phase's)."""
    from cpp_audio_tpu_torch.core import events
    from cpp_audio_tpu_torch.models import carrier

    outs = {}
    for dt in ("float32", "float64"):
        s = carrier.CarrierSynth(carrier.CarrierSynthConfig(
            sample_rate=SR, osc=carrier.CarrierOscMix(sine=1.0, triangle=0.4),
            seed=3, dtype=dt), device="cuda")
        s.on_event(events.Event(events.EventType.NOTE_ON, 50, 1, 440.0, 0.7))
        s.on_event(events.Event(events.EventType.NOTE_ON, 900, 2, 110.0, 0.5))
        s.on_event(events.mk_note_change(2000, 1, 470.0, 0.6))
        outs[dt] = (s.compute(59 * SR, 2048).double(), s.compute(SR // 2, 2048).double())
    late = float((outs["float32"][0] - outs["float64"][0]).abs().max())
    early = float((outs["float32"][1] - outs["float64"][1]).abs().max())
    print(f"[carrier] float32 against float64 on the card: max|diff| {early:.3e} at "
          f"t0 = 0.5 s, {late:.3e} at t0 = 59 s (peak "
          f"{float(outs['float64'][0].abs().max()):.4f}; the float32 phase of the "
          "JAX package's arithmetic)")


def phase_live_streamed_vs_offline():
    """(c) StreamingSynth pulled in 512-sample blocks over 10 s of held,
    retuned and released notes, against sine_synth.render_schedule of the
    same notes on the card (bar 2e-5). Retunes land on pull boundaries; the
    offline reference renders each stretch between them with the notes'
    frequency and phase-continuous start angle of that stretch
    (voicebank.retuned_phase0)."""
    import torch

    from cpp_audio_tpu_torch.core import events, voices
    from cpp_audio_tpu_torch.models import sine_synth, streaming_synth, voicebank
    from cpp_audio_tpu_torch.ops import envelopes

    n = 10 * SR
    rng = np.random.default_rng(11)
    cfg = sine_synth.SineSynthConfig(
        sample_rate=SR, ahdsr=envelopes.AHDSR(attack=441, hold=100, decay=2000,
                                              release=8820, sustain=0.7))
    notes = {}
    for i in range(24):
        press = int(rng.uniform(0, 0.8 * n))
        release = press + int(rng.uniform(0.2 * SR, 5 * SR)) if i % 3 else 2**62
        notes[i] = dict(press=press, release=release, frequency=float(rng.uniform(60, 3000)),
                        velocity=float(rng.uniform(0.3, 1.0)), pan=float(rng.uniform(-1, 1)),
                        phase=0.0)
    boundaries = [s * SR // LIVE_BLOCK * LIVE_BLOCK for s in (2, 5, 8)]
    retunes = {b: [(i, notes[i]["frequency"] * float(rng.uniform(0.9, 1.1)),
                    float(rng.uniform(0.3, 1.0))) for i in rng.choice(24, 8, replace=False)]
               for b in boundaries}

    synth = streaming_synth.StreamingSynth(cfg, n_voices=127, device="cuda")
    pending = sorted([(v["press"], 0, i) for i, v in notes.items()]
                     + [(v["release"], 1, i) for i, v in notes.items() if v["release"] < n])
    streamed, k = [], 0
    for t in range(0, n, LIVE_BLOCK):
        for i, f, vel in retunes.get(t, []):
            synth.on_event(events.mk_note_change(t, int(i), f, vel))
        while k < len(pending) and pending[k][0] < t + LIVE_BLOCK:
            when, kind, i = pending[k]
            synth.on_event(events.mk_note_on(when, notes[i]["frequency"],
                                             notes[i]["velocity"], note_id=i,
                                             pan=notes[i]["pan"]) if kind == 0
                           else events.mk_note_off(when, i))
            k += 1
        streamed.append(synth.compute(t, min(LIVE_BLOCK, n - t)))
    streamed = torch.cat(streamed)

    offline, edges = [], [0] + boundaries + [n]
    for a, b in zip(edges[:-1], edges[1:]):
        for i, f, vel in retunes.get(a, []):
            v = notes[i]
            # the streaming synth retunes the notes it holds: pressed in an
            # earlier pull, not yet released (retunes precede this pull's events)
            if v["press"] < a <= v["release"]:
                v["phase"] = voicebank.retuned_phase0(
                    v["press"], a, v["phase"], 2.0 * v["frequency"] / SR, 2.0 * f / SR)
                v["frequency"], v["velocity"] = f, vel
        sch = voices.schedule_from_notes(
            [events.Note(i, v["press"], v["release"], v["frequency"], v["velocity"],
                         v["pan"], phase=v["phase"]) for i, v in notes.items()], pad_to=8)
        offline.append(sine_synth.render_schedule(sch, b, cfg, device="cuda")[a:b])
    offline = torch.cat(offline)
    err = float((streamed - offline).abs().max())
    print(f"[live streamed] StreamingSynth, {n // LIVE_BLOCK + 1} pulls of {LIVE_BLOCK} "
          f"over 10 s (24 notes, 16 released, {sum(map(len, retunes.values()))} retunes "
          f"at 3 pull boundaries) against render_schedule on cuda: max|diff| "
          f"{err:.3e}, peak {float(offline.abs().max()):.4f}")
    if not (err <= KERNEL_BAR and float(offline.abs().max()) > 1e-2):
        raise RuntimeError(f"streamed render disagrees with the offline one: {err}")


def phase_live_reference() -> int:
    """(d) The live path with its vocoder leg on cuda against the same run on
    the CPU (plain versions), on the 2 s signal of make_chain_test_workload:
    the same stats, output within 2e-3 of peak, vocoded leg atol 1e-4 (phase
    6's bars); then deduce_notes on 12 s of the headline mixdown, cuda
    against the CPU: with a float64 analysis the same notes (bounds equal,
    pitch within 1e-3 semitone); with the default float32 one, whose FFTs
    round differently on the two devices, at most 5% of the notes may flip
    at a tracker knife-edge (printed); and resynth_deduced of one note list
    on both, within 2e-3 of peak. Returns the kernel launches of the cuda
    note render."""
    import torch

    from cpp_audio_tpu_torch.analysis import notes, resynth
    from cpp_audio_tpu_torch.models import sine_synth, voicebank
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    n = 2 * SR
    sch, cfg = make_chain_test_workload(SR, n)
    sig = voicebank.render_bank(sine_synth.bank_from_schedule(sch, cfg), n,
                                block_size=cfg.block_size, device="cpu"
                                ).sum(dim=1).numpy().astype(np.float64)
    runs = {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        live = make_live(dev, osc={"saw": 0.6, "noise": 0.2, "square": 0.3})
        legs = record_legs(live)
        out = live.run_duplex(sig, block_size=LIVE_BLOCK).cpu()
        runs[where] = (vars(live.stats), out, torch.cat(legs["vocoder"]).cpu())
    (sg, og, vg), (sc, oc, vc) = runs["card"], runs["cpu"]
    peak = float(oc.abs().max())
    dr = float((og - oc).abs().max()) / max(peak, 1e-9)
    dv = float((vg - vc).abs().max())
    print(f"[live reference] 2 s, cuda vs cpu: stats {sg} / {sc}; output "
          f"max|diff|/peak {dr:.3e} (peak {peak:.4f}); vocoded leg max|diff| {dv:.3e}")
    if not (sg == sc and peak > 1e-3 and dr < 2e-3 and dv <= 1e-4):
        raise RuntimeError("the live path on cuda disagrees with the CPU")

    fn = 12 * SR
    mix = headline_mixdown(fn, "cuda")
    found = {}
    for dtype in ("float32", "float64"):
        for where, dev in (("card", "cuda"), ("cpu", "cpu")):
            cfg = resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0, dtype=dtype)
            found[dtype, where] = notes.deduce_notes(mix, SR, min_db_span=-40.0,
                                                     config=cfg, device=dev)
    vmax = max(x.volume for x in found["float32", "cpu"])
    for dtype in ("float32", "float64"):
        only = _unmatched_notes(found[dtype, "card"], found[dtype, "cpu"])
        print(f"[notes] 12 s headline mixdown, analysis {dtype}, dB span -40: "
              f"{len(found[dtype, 'card'])} notes on cuda, {len(found[dtype, 'cpu'])} "
              f"on cpu; unmatched (bounds equal, pitch within 1e-3 semitone) "
              f"{len(only[0])} / {len(only[1])}")
        for dev, xs in zip(("cuda", "cpu"), only):
            for x in xs:
                print(f"[notes]   only on {dev}: pitch {x.midi_pitch:.4f}, samples "
                      f"{x.start_sample}-{x.end_sample}, "
                      f"{20 * np.log10(x.volume / vmax):.1f} dB re the loudest")
        if dtype == "float64" and (only[0] or only[1] or not found[dtype, "cpu"]):
            raise RuntimeError("float64 note deduction on cuda disagrees with the CPU")
        if dtype == "float32" and (len(only[0]) + len(only[1])
                                   > 0.05 * len(found[dtype, "cpu"])):
            raise RuntimeError("float32 note deduction on cuda disagrees with the CPU "
                               "beyond tracker knife-edges")
    # the render: one note list (the CPU's, default float32 analysis) on both
    listed = found["float32", "cpu"]
    stride = resynth.ResynthConfig().stride
    cv.LAUNCHES = 0
    t0 = time.perf_counter()
    g = notes.resynth_deduced(listed, sample_rate=SR, stride=stride, device="cuda")
    torch.cuda.synchronize()
    t_cuda, launches = time.perf_counter() - t0, cv.LAUNCHES
    c = notes.resynth_deduced(listed, sample_rate=SR, stride=stride, device="cpu")
    peak = float(c.abs().max())
    dr = float((g.cpu() - c).abs().max()) / max(peak, 1e-9)
    print(f"[notes] resynth_deduced of {len(listed)} notes, {tuple(g.shape)}: cuda "
          f"{t_cuda * 1e3:.3f} ms ({launches} kernel launches) against the CPU: "
          f"max|diff|/peak {dr:.3e} (peak {peak:.4f})")
    if not (g.shape == c.shape and dr < 2e-3 and launches > 0):
        raise RuntimeError("resynth_deduced on cuda disagrees with the CPU")
    return launches


def _unmatched_notes(a, b):
    """The notes of each list with no twin in the other: the same sample
    bounds and a pitch within 1e-3 semitone."""
    def twin(x, ys):
        return any((x.start_sample, x.end_sample) == (y.start_sample, y.end_sample)
                   and abs(x.midi_pitch - y.midi_pitch) < 1e-3 for y in ys)

    return [x for x in a if not twin(x, b)], [y for y in b if not twin(y, a)]


APP_DIR = "build/phase11"     # inputs, jobs and outputs of phase 11 (git-ignored)
APP_SECONDS = 2.0             # J4: each app mode
RESUME_SECONDS = 12.0         # J3: the bitwise resume check
J2_SECONDS = 12.0             # J2: the feedback job (one pass per second of audio)
SEGMENT_SECONDS = 5.0         # J3: audio seconds between snapshots


def _job_preset(**kw):
    """The chain's analysis and vocoder settings (the preset's defaults:
    window 8000, stride 3969, k = 128; vocoder stride 221, modulator window
    4410) with every leg of the mix on."""
    from cpp_audio_tpu_torch.analysis import offline_job as oj
    from cpp_audio_tpu_torch.analysis.presets_json import ResynthPreset

    p = ResynthPreset(**{**dict(analysis_volume=1.0, vocoder_volume=0.5,
                                voice_volume=0.2, carrier_volume=0.05), **kw})
    rc, vp = oj.resynth_config_from_preset(p, SR), oj.vocoder_params_from_preset(p, SR)
    got = (rc.window_size, rc.stride, rc.max_voices + 1, vp.stride, vp.modulator_window)
    if got != (8000, 3969, 128, 221, 4410):
        raise RuntimeError(f"job preset is not the chain's settings: {got}")
    return p


def write_job(name: str, n: int, preset, post: str = "limit"):
    """Writes the headline mono mixdown (n samples) as the voice WAV and a
    110 Hz square as the carrier WAV (the port's utils/wav.py, float32),
    the preset and the job file under APP_DIR; returns the job config."""
    import os

    from cpp_audio_tpu_torch.analysis.presets_json import OfflineJobConfig
    from cpp_audio_tpu_torch.utils import wav as wavio

    os.makedirs(APP_DIR, exist_ok=True)
    voice, carrier = f"{APP_DIR}/voice_{n}.wav", f"{APP_DIR}/carrier_{n}.wav"
    if not os.path.exists(voice):
        wavio.write_wav(voice, headline_mixdown(n, "cuda"), SR)
        wavio.write_wav(carrier, np.sign(np.sin(2 * np.pi * 110.0 * np.arange(n) / SR)), SR)
    preset.save(f"{APP_DIR}/{name}.preset.json")
    cfg = OfflineJobConfig(preset_file=f"{APP_DIR}/{name}.preset.json",
                           input_voice_file=voice, input_carrier_file=carrier,
                           output_file=f"{APP_DIR}/{name}.wav", post=post)
    cfg.save(f"{APP_DIR}/{name}.job.json")
    return cfg


def _finite_within(name: str, out: np.ndarray, ceiling: float = 1.0) -> float:
    peak = float(np.abs(out).max())
    if not (np.isfinite(out).all() and 1e-3 < peak <= ceiling + 1e-9):
        raise RuntimeError(f"{name}: output not finite within the ceiling (peak {peak})")
    return peak


def phase_jobs_and_apps(card: str) -> dict:
    """Phase 11: the JSON offline job, its feedback drones and its
    checkpointed form at 60 s, the apps, and the filter-bank vocoder.
    Returns the kernels-line keys it measures (launches_job)."""
    import torch

    from cpp_audio_tpu_torch.analysis import device_tracker
    from cpp_audio_tpu_torch.analysis import offline_job as oj
    from cpp_audio_tpu_torch.analysis import resynth as rs
    from cpp_audio_tpu_torch.analysis import vocoder as voc
    from cpp_audio_tpu_torch.ops import limiter as lim
    from cpp_audio_tpu_torch.utils import wav as wavio

    n = int(SR * SECONDS)
    preset = _job_preset()
    cfg = write_job("j1", n, preset)
    _, voice, carrier, _ = oj.load_job_inputs(cfg)

    # J1: the batch job
    t0 = time.perf_counter()
    oj.run_job(cfg, device="cuda")
    first = time.perf_counter() - t0
    walls, outs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        outs.append(oj.run_job(cfg, device="cuda"))
        walls.append(time.perf_counter() - t0)
    stages = {}
    out = oj.run_job(cfg, device="cuda", timings=stages)
    wall = statistics.median(walls)
    print(f"[J1] run_job, {SECONDS:.0f} s job (voice + carrier + vocoder + resynthesis, limit): "
          f"first {first:.3f} s, warm median {wall * 1e3:.3f} ms of 3 "
          f"({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms), {SECONDS / wall:.1f}x "
          f"realtime on {card}; stages " + ", ".join(f"{k} {v * 1e3:.3f} ms"
                                                     for k, v in stages.items())
          + " (synchronised per stage)")
    peak = _finite_within("J1", out)
    data, sr = wavio.read_wav(cfg.output_file)
    if not (sr == SR and np.array_equal(data, out.astype(np.float32).astype(np.float64))):
        raise RuntimeError("J1: the WAV read back is not the returned output")
    spread = max(float(np.abs(o - out).max()) for o in outs)
    print(f"[J1] run to run, 4 runs of the job on the card: max|diff| {spread:.3e} "
          f"({spread / peak:.3e} of peak); {_deterministic_spread(oj, preset, voice)}")
    if spread != 0.0:
        raise RuntimeError(f"J1: the job differs between runs: max|diff| {spread}")
    # the mix rebuilt from its legs' own calls on the same inputs
    f64 = dict(dtype=torch.float64, device="cuda")
    gained = preset.analysis_input_gain * torch.as_tensor(voice, **f64)
    r = rs.resynthesize(gained, oj.resynth_config_from_preset(preset, SR),
                        device_out=True, device="cuda")
    v = voc.vocode(gained, torch.as_tensor(carrier, **f64),
                   oj.vocoder_params_from_preset(preset, SR), device_out=True,
                   device="cuda")
    mix = torch.zeros((n, 2), **f64)
    mix[:v.shape[0]] += preset.vocoder_volume * v[:n, None]
    mix += preset.voice_volume * torch.as_tensor(voice, **f64)[:, None]
    mix += preset.carrier_volume * torch.as_tensor(carrier, **f64)[:, None]
    mix[:min(r.shape[0], n)] += r[:n]
    mix = lim.limit(mix, sample_rate=SR).cpu().numpy()
    d_mix = float(np.abs(mix - out).max()) / peak
    print(f"[J1] output peak {peak:.4f} (ceiling 1); WAV read back equals the output "
          f"(float32); the mix rebuilt from resynthesize (resynth leg {tuple(r.shape)}, "
          f"peak {float(r.abs().max()):.4f}) and vocode of the gained voice: max|diff|/peak "
          f"{d_mix:.3e} (bar 2e-3, the chain's; the run-to-run spread is above)")
    if not d_mix < 2e-3:
        raise RuntimeError(f"J1: the job's mix is not its legs': {d_mix}")

    # J2: feedback drones, on the headline workload at J2_SECONDS
    n2 = int(SR * J2_SECONDS)
    cfg2 = write_job("j2", n2, _job_preset(analysis_output_feedback_gain=0.3,
                                           output_delay_seconds=1.0))
    calls, scans = [], []
    plain_resynthesize, plain_scan = rs.resynthesize, device_tracker._scan_tables

    def counted(*a, **k):
        calls.append(1)
        return plain_resynthesize(*a, **k)

    def counted_scan(*a, **k):
        t0 = time.perf_counter()
        out = plain_scan(*a, **k)
        torch.cuda.synchronize()
        scans.append(time.perf_counter() - t0)
        return out

    rs.resynthesize, device_tracker._scan_tables = counted, counted_scan
    try:
        t0 = time.perf_counter()
        out2 = oj.run_job(cfg2, device="cuda")
        wall2 = time.perf_counter() - t0
    finally:
        rs.resynthesize, device_tracker._scan_tables = plain_resynthesize, plain_scan
    passes = -(-n2 // SR)
    print(f"[J2] feedback drones (gain 0.3, delay 1.0 s), {J2_SECONDS:.0f} s job: wall "
          f"{wall2:.3f} s on {card}; "
          f"{len(calls) - 1} passes of resynthesize on growing prefixes (ceil(n/D) = "
          f"{passes}) + 1 full; {len(scans)} of them took the device tracker's exact "
          f"frame loop (on the card every pass: one launch), {sum(scans):.3f} s in all; peak "
          f"{_finite_within('J2', out2):.4f}")
    if len(calls) != passes + 1:
        raise RuntimeError(f"J2: {len(calls)} resynthesize calls, {passes + 1} expected")

    launches_job = phase_checkpointed_job(card, cfg, preset, n)
    phase_apps(card)
    phase_filter_bank(card, voice, carrier)
    return {"launches_job": launches_job}


def _deterministic_spread(oj, preset, voice) -> str:
    """resynthesize of the job's gained voice twice in torch's default
    (non-deterministic) mode; fails unless the two are equal to the bit."""
    import torch

    from cpp_audio_tpu_torch.analysis import resynth as rs

    if torch.are_deterministic_algorithms_enabled():
        raise RuntimeError("torch's deterministic mode is on: the check needs the default")
    cfg = oj.resynth_config_from_preset(preset, SR)
    a, b = (rs.resynthesize(preset.analysis_input_gain * voice, cfg, device_out=True,
                            device="cuda") for _ in range(2))
    torch.cuda.synchronize()
    diff = float((a - b).abs().max())
    if diff != 0.0:
        raise RuntimeError(f"resynthesize differs between two runs: max|diff| {diff}")
    return f"resynthesize twice in torch's default mode: max|diff| {diff:.3e}"


def phase_checkpointed_job(card, cfg, preset, n) -> int:
    """J3: checkpoint.run_job_checkpointed at 60 s, killed after 4 segments
    and resumed; at RESUME_SECONDS the resumed output bitwise equal to an
    uninterrupted run; the synchronising calls per block with and without
    the feedback path. Returns the kernel launches of the 60 s job."""
    import os
    import warnings

    import torch

    from cpp_audio_tpu_torch.analysis import checkpoint as ck
    from cpp_audio_tpu_torch.analysis import offline_job as oj
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    path = f"{APP_DIR}/j3.ckpt"
    if os.path.exists(path):
        os.remove(path)
    os.remove(cfg.output_file)
    cv.LAUNCHES = 0
    t0 = time.perf_counter()
    killed = ck.run_job_checkpointed(cfg, path, segment_seconds=SEGMENT_SECONDS,
                                     max_segments=4, device="cuda")
    wall_a = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    out = ck.run_job_checkpointed(cfg, path, segment_seconds=SEGMENT_SECONDS, device="cuda")
    wall_b = time.perf_counter() - t0
    launches = cv.LAUNCHES
    blocks = -(-n // 512)
    print(f"[J3] run_job_checkpointed, {SECONDS:.0f} s, segment {SEGMENT_SECONDS} s, {blocks} blocks "
          f"of 512: killed after 4 segments in {wall_a:.3f} s (snapshot {size} bytes), "
          f"resumed to the end in {wall_b:.3f} s ({SECONDS / (wall_a + wall_b):.2f}x "
          f"realtime in all) on {card}; voice-bank kernel launches {launches}; peak "
          f"{_finite_within('J3', out):.4f}")
    if not (killed is None and launches > 0 and out.shape == (n, 2)
            and not os.path.exists(path) and os.path.exists(cfg.output_file)):
        raise RuntimeError("J3: the checkpointed job did not kill, resume and finish")

    m = int(SR * RESUME_SECONDS)
    _, voice, carrier, _ = oj.load_job_inputs(cfg)
    kw = dict(post="limit", segment_seconds=SEGMENT_SECONDS, device="cuda")
    full = ck.run_offline_streaming(preset, voice[:m], carrier[:m], SR, **kw)
    path12 = f"{APP_DIR}/j3_resume.ckpt"
    if os.path.exists(path12):
        os.remove(path12)
    assert_none = ck.run_offline_streaming(preset, voice[:m], carrier[:m], SR,
                                           checkpoint_path=path12, max_segments=1, **kw)
    resumed = ck.run_offline_streaming(preset, voice[:m], carrier[:m], SR,
                                       checkpoint_path=path12, **kw)
    same = assert_none is None and np.array_equal(resumed, full)
    print(f"[J3] {RESUME_SECONDS} s: killed after 1 segment and resumed against an "
          f"uninterrupted run on the card: bitwise equal {same} (max|diff| "
          f"{float(np.abs(resumed - full).max()):.3e})")
    if not same:
        raise RuntimeError("J3: the resumed render is not bitwise the uninterrupted one")

    # synchronising calls per block, without and with the feedback path
    k = 2 * SR
    for name, p in (("no feedback", preset),
                    ("feedback 0.3 / 1 s", _job_preset(analysis_output_feedback_gain=0.3,
                                                       output_delay_seconds=1.0))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ck.run_offline_streaming(p, voice[:k], carrier[:k], SR, post="limit",
                                         device="cuda")
            finally:
                torch.cuda.set_sync_debug_mode("default")
        hits = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
        where = {}
        for w in hits:
            key = str(w.filename).rsplit("/", 1)[-1] + f":{w.lineno}"
            where[key] = where.get(key, 0) + 1
        nb = -(-k // 512)
        print(f"[J3 syncs] {name}, 2 s ({nb} blocks): {len(hits)} synchronising calls, "
              f"{len(hits) / nb:.2f} per block: "
              + ", ".join(f"{a} x{b}" for a, b in sorted(where.items())))
    return launches


def _write_smf(path):
    """A small Standard MIDI File: two carrier notes and a pitch-wheel move."""
    import struct

    trk = b"\x00\xff\x51\x03" + struct.pack(">I", 500000)[1:]
    for delta, msg in ((b"\x00", (0x90, 45, 100)), (b"\x81\x70", (0x90, 52, 90)),
                       (b"\x81\x70", (0xE0, 0x00, 0x50)), (b"\x83\x60", (0x80, 45, 0)),
                       (b"\x00", (0x80, 52, 0))):
        trk += delta + bytes(msg)
    trk += b"\x00\xff\x2f\x00"
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480) + b"MTrk"
                + struct.pack(">I", len(trk)) + trk)


def phase_apps(card):
    """J4: every apps.resynth mode and both apps.resynth_ui modes, in
    process at APP_SECONDS on cuda; each must write its outputs. The --job
    output on the card against the same job on the CPU: the full mix
    within 2e-3 of peak, a vocoder-only job at atol 1e-4."""
    import contextlib
    import io
    import os

    import torch

    from cpp_audio_tpu_torch.apps import resynth as app
    from cpp_audio_tpu_torch.apps import resynth_ui as ui
    from cpp_audio_tpu_torch.utils import wav as wavio

    n = int(SR * APP_SECONDS)
    cfg = write_job("j4", n, _job_preset())
    cfg_voc = write_job("j4_vocoder", n, _job_preset(analysis_volume=0.0, voice_volume=0.0,
                                                     carrier_volume=0.0))
    d = APP_DIR
    _write_smf(f"{d}/j4.mid")
    inp, car = cfg.input_voice_file, cfg.input_carrier_file
    modes = {
        "plain": ([inp, f"{d}/app_plain.wav"], [f"{d}/app_plain.wav"]),
        "--job": (["--job", f"{d}/j4_vocoder.job.json"], [cfg_voc.output_file]),
        "--job --checkpoint": (["--job", f"{d}/j4.job.json", "--checkpoint",
                                f"{d}/app.ckpt", "--checkpoint-seconds", "0.5"],
                               [cfg.output_file]),
        "--live": ([inp, f"{d}/app_live.wav", "--live"], [f"{d}/app_live.wav"]),
        "--live --midi": ([inp, f"{d}/app_midi.wav", "--live", "--midi", f"{d}/j4.mid",
                           "--carrier", "saw=0.8,noise=0.2"], [f"{d}/app_midi.wav"]),
        "--vocode fft": ([inp, f"{d}/app_vfft.wav", "--vocode", car], [f"{d}/app_vfft.wav"]),
        "--vocode filterbank --debug-vocoder": (
            [inp, f"{d}/app_vfb.wav", "--vocode", car, "--vocode-mode", "filterbank",
             "--debug-vocoder", f"{d}/taps"], [f"{d}/app_vfb.wav", f"{d}/taps/vocoded.wav",
                                              f"{d}/taps/band_0.wav"]),
        "--deduce": ([inp, f"{d}/app_deduce.wav", "--deduce"],
                     [f"{d}/app_deduce.wav", f"{d}/app_deduce.notes.bmp"]),
    }
    for name, (argv, outputs) in modes.items():
        for f in outputs:
            if os.path.exists(f):
                os.remove(f)
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = app.main(argv + ["--device", "cuda"])
        wall = time.perf_counter() - t0
        missing = [f for f in outputs if not os.path.exists(f)]
        peak = max(float(np.abs(wavio.read_wav(f)[0]).max()) for f in outputs
                   if f.endswith(".wav") and f not in missing) if len(missing) < len(outputs) else 0
        print(f"[J4] apps.resynth {name}: rc {rc}, {wall:.3f} s, wrote {len(outputs)} "
              f"outputs (peak {peak:.4f}): {text.getvalue().strip()[-120:]}")
        if rc != 0 or missing or not peak > 1e-4:
            raise RuntimeError(f"J4: apps.resynth {name} failed (missing {missing})")

    for name, argv, feed in (("report --vocoder", [inp, "--vocoder"], ""),
                             ("--live", [inp, "--live"], "set min_volume 0.0001\nquit\n")):
        text = io.StringIO()
        stdin, sys.stdin = sys.stdin, io.StringIO(feed)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(text):
                rc = ui.main(argv + ["--device", "cuda"])
        finally:
            sys.stdin = stdin
        wall = time.perf_counter() - t0
        lines = text.getvalue().splitlines()
        gauges = [x.strip() for x in lines if x.endswith(" ms")]
        print(f"[J4] apps.resynth_ui {name}: rc {rc}, {wall:.3f} s, {len(lines)} lines; "
              f"{'; '.join(gauges) or lines[-1]}")
        if rc != 0 or "pitch window" not in text.getvalue():
            raise RuntimeError(f"J4: apps.resynth_ui {name} failed")

    for name, job, bar, rel in (("full mix", cfg, 2e-3, True),
                                ("vocoder only", cfg_voc, 1e-4, False)):
        app_out = {}
        for dev in ("cuda", "cpu"):
            with contextlib.redirect_stdout(io.StringIO()):
                app.main(["--job", f"{d}/{os.path.basename(job.output_file)[:-4]}.job.json",
                          "--device", dev])
            app_out[dev] = wavio.read_wav(job.output_file)[0]
        g, c = app_out["cuda"], app_out["cpu"]
        peak = float(np.abs(c).max())
        diff = float(np.abs(g - c).max()) / (peak if rel else 1.0)
        print(f"[J4] --job {name}, {APP_SECONDS} s, cuda against cpu: max|diff|"
              f"{'/peak' if rel else ''} {diff:.3e} (peak {peak:.4f}; bar {bar})")
        if not (g.shape == c.shape and peak > 1e-3 and diff < bar):
            raise RuntimeError(f"J4: --job {name} on cuda disagrees with the CPU")
    torch.cuda.synchronize()


def phase_filter_bank(card, voice, carrier):
    """The filter-bank vocoder at 60 s on cuda: first call and the median
    of 3 warm walls, its ATen op count; held against the CPU at atol 1e-4
    (tests/test_torch_filters.py's bar against JAX) and a silent modulator
    below 1e-6 (tests/test_vocoder_filterbank.py)."""
    import torch

    from cpp_audio_tpu_torch.analysis import vocoder as voc

    p = voc.VocoderParams(sample_rate=SR)
    mod = torch.as_tensor(voice, dtype=torch.float32, device="cuda")
    car = torch.as_tensor(carrier, dtype=torch.float32, device="cuda")

    def run():
        out = voc.vocode_filter_bank(mod, car, p, device_out=True, device="cuda")
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        g = run()
        walls.append(time.perf_counter() - t0)
    ops = _dispatched_ops(run)
    t0 = time.perf_counter()
    c = voc.vocode_filter_bank(voice, carrier, p, device_out=True, device="cpu")
    t_cpu = time.perf_counter() - t0
    diff = float((g.cpu() - c).abs().max())
    silent = float(voc.vocode_filter_bank(torch.zeros_like(mod), car, p,
                                          device_out=True, device="cuda").abs().max())
    wall = statistics.median(walls)
    print(f"[filter bank] vocode_filter_bank, {SECONDS:.0f} s, {p.count_bands} bands: first "
          f"{first:.3f} s, warm median {wall * 1e3:.3f} ms of 3 "
          f"({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms) on {card}; {ops} ATen ops; "
          f"CPU {t_cpu:.3f} s; cuda against cpu max|diff| {diff:.3e} (peak "
          f"{float(c.abs().max()):.4f}, bar 1e-4); silent modulator {silent:.3e}")
    if not (diff <= 1e-4 and float(c.abs().max()) > 1e-3 and silent < 1e-6):
        raise RuntimeError("the filter-bank vocoder on cuda disagrees with the CPU")


TUNE_DIR = "build/phase12"    # presets, samples and outputs of phase 12 (git-ignored)
TUNE_SECONDS = 60.0           # (a), (d): the rain stream
TUNE_APP_SECONDS = 2.0        # (d) cuda against cpu, (f) the --rain mode
SONIFY_BYTES = 1 << 16        # (c): the seeded blob, sonified in full


def write_tune_presets(d: str) -> str:
    """The tune app's preset files (tests/test_harmonics.py:16-37):
    EnvelopeFast A 1, H 1, D 2, S 4, R 4 dots (eased attack and release);
    Harmonics lines of 5, 2, 0, 2, 0, 1, 0, 3 dots; LowPass 800 Hz."""
    import os

    os.makedirs(d, exist_ok=True)
    with open(f"{d}/EnvelopeFast.txt", "w") as f:
        f.write("A .\nH .\nD ..\nS ....\nR ....\n")
    with open(f"{d}/Harmonics.txt", "w") as f:
        f.write("\n".join("." * k for k in (5, 2, 0, 2, 0, 1, 0, 3)) + "\n")
    with open(f"{d}/LowPass.txt", "w") as f:
        f.write("800\n")
    return d


def write_tune_samples(d: str) -> list:
    """Two seeded pitched samples (1.5 s, five partials, decaying) written
    as WAVs through the port's utils/wav.py; returns the --sample specs.
    The rain stream's pitches (104-175 Hz) select both (lower_bound)."""
    from cpp_audio_tpu_torch.utils import wav as wavio

    rng = np.random.default_rng(12)
    t = np.arange(int(1.5 * SR)) / SR
    specs = []
    for freq in (140.0, 180.0):
        s = sum(rng.uniform(0.2, 1.0) / k * np.sin(2 * np.pi * k * freq * t + rng.uniform(0, 6))
                for k in range(1, 6))
        s = np.concatenate([np.zeros(200), 0.5 * s * np.exp(-3.0 * t) / np.abs(s).max()])
        wavio.write_wav(f"{d}/sample_{freq:.0f}.wav", s, SR)
        specs.append(f"{freq:.0f}={d}/sample_{freq:.0f}.wav")
    return specs


class TuneProbe:
    """Diagnostic instrumentation of one harmonics render (apps.tune
    render_notes on cuda): host time in the bank build, the per-segment
    slices and the table preparation with their host-to-device copies
    (each call synchronised), the kernel's device time (CUDA events around
    each launch), the low-pass, and each segment's tables."""

    def __init__(self):
        self.t = dict.fromkeys(("bank", "slice", "prepare", "lowpass"), 0.0)
        self.events, self.tables, self.rows = [], [], 0

    def __enter__(self):
        import torch

        from cpp_audio_tpu_torch.models import harmonics, voicebank
        from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
        from cpp_audio_tpu_torch.ops import filters

        self._saved = [(harmonics, "bank_from_schedule"), (voicebank, "_slice_bank"),
                       (voicebank, "prepare_bank_arrays"), (filters, "cascade_fft"),
                       (cv, "render_blocks_cuda")]
        self._saved = [(m, a, getattr(m, a)) for m, a in self._saved]
        plain = {a: f for _, a, f in self._saved}

        def timed(key, name):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = plain[name](*a, **k)
                torch.cuda.synchronize()
                self.t[key] += time.perf_counter() - t0
                if name == "bank_from_schedule":
                    self.rows += out.n_rows
                return out
            return run

        def kernel(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = plain["render_blocks_cuda"](*a, **k)
            end.record()
            self.events.append((start, end))
            self.tables.append((a, k))
            return out

        harmonics.bank_from_schedule = timed("bank", "bank_from_schedule")
        voicebank._slice_bank = timed("slice", "_slice_bank")
        voicebank.prepare_bank_arrays = timed("prepare", "prepare_bank_arrays")
        filters.cascade_fft = timed("lowpass", "cascade_fft")
        cv.render_blocks_cuda = kernel
        return self

    def __exit__(self, *exc):
        for m, a, f in self._saved:
            setattr(m, a, f)

    def report(self, wall: float) -> str:
        import torch

        torch.cuda.synchronize()
        kernel_ms = sum(s.elapsed_time(e) for s, e in self.events)
        host = self.t["bank"] + self.t["slice"] + self.t["prepare"]
        rest = wall - host - self.t["lowpass"] - kernel_ms / 1e3
        return (f"host prep {host * 1e3:.3f} ms (bank {self.t['bank'] * 1e3:.3f}, segment "
                f"slices {self.t['slice'] * 1e3:.3f}, tables + copies "
                f"{self.t['prepare'] * 1e3:.3f}); kernel {kernel_ms:.3f} ms device time in "
                f"{len(self.events)} launches; low-pass {self.t['lowpass'] * 1e3:.3f} ms; "
                f"the rest {rest * 1e3:.3f} ms, of a {wall * 1e3:.3f} ms instrumented wall")


def _tune_render(notes, **kw):
    """apps.tune.render_notes on cuda with the phase's presets, synchronised."""
    import torch

    from cpp_audio_tpu_torch.apps import tune

    out, _ = tune.render_notes(notes, synth_dir=TUNE_DIR, sample_rate=SR, device="cuda", **kw)
    torch.cuda.synchronize()
    return out


def _check_audio(name, out, n_channels=2) -> float:
    import torch

    peak = float(out.abs().max())
    if not (out.dim() == 2 and out.shape[1] == n_channels
            and bool(torch.isfinite(out).all()) and peak > 1e-3):
        raise RuntimeError(f"{name}: output {tuple(out.shape)} not finite or silent "
                           f"(peak {peak})")
    return peak


def phase_tune(card: str) -> dict:
    """Phase 12: the tune app and the DSP ops on cuda, (a) to (f) of the
    module docstring. Returns the kernels-line keys it measures."""
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
    from cpp_audio_tpu_torch.utils import event_streams as es
    from cpp_audio_tpu_torch.utils.interp import Itp

    write_tune_presets(TUNE_DIR)
    n = int(SR * TUNE_SECONDS)

    # (a) the harmonics synth at width: the 60 s rain stream
    notes = es.rain_notes(TUNE_SECONDS, sample_rate=SR, seed=0)
    t0 = time.perf_counter()
    _tune_render(notes)
    first = time.perf_counter() - t0
    walls = []
    for i in range(3):
        if i == 0:
            cv.LAUNCHES = 0
        t0 = time.perf_counter()
        out = _tune_render(notes)
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches_tune = cv.LAUNCHES
    with TuneProbe() as probe:
        t0 = time.perf_counter()
        _tune_render(notes)
        wall_probe = time.perf_counter() - t0
    wall = statistics.median(walls)
    peak = _check_audio("(12a) rain", out)
    print(f"[tune] (a) rain_notes({TUNE_SECONDS:.0f} s, seed 0), tune preset: {len(notes)} "
          f"notes, {probe.rows} voice-bank rows, {len(probe.events)} segments; first "
          f"{first:.3f} s, warm median {wall * 1e3:.3f} ms of 3 "
          f"({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms), {TUNE_SECONDS / wall:.1f}x "
          f"realtime on {card}; kernel launches {launches_tune}; output "
          f"{tuple(out.shape)} peak {peak:.4f}")
    print(f"[tune] (a) {probe.report(wall_probe)}")
    if launches_tune <= 0 or launches_tune != len(probe.events):
        raise RuntimeError(f"(12a): {launches_tune} kernel launches for "
                           f"{len(probe.events)} segments")

    # (b) the kernel against its plain version on the busiest segment's
    # eased tables
    seg_args, seg_stat = max(probe.tables, key=lambda t: t[0][0].shape[1])
    codes = set(seg_args[4].flatten().tolist())
    if int(Itp.EASE_OUT_CUBIC) not in codes:
        raise RuntimeError(f"(12b): the tune tables carry no eased curve ({codes})")
    err = _hold(f"(12b) busiest rain segment, curve codes {sorted(codes)}", seg_args, seg_stat)
    ms = cuda_ms_amortized(lambda: cv.render_blocks_cuda(*seg_args, **seg_stat))
    plain_ms = cuda_ms(lambda: cv.render_blocks_plain(*seg_args, **seg_stat), reps=3)
    bound = cv.kernel_bound(seg_args[0], seg_args[1], n_channels=2, **seg_stat)
    print(f"[tune] (b) kernel on {tuple(seg_args[0].shape)} x {seg_stat['n_blocks']} blocks "
          f"of {seg_stat['block_size']}: {ms:.5f} ms amortized, plain {plain_ms:.3f} ms; "
          f"bound {bound['bound_ms']:.6f} ms by {bound['bound_by']} "
          f"({bound['live_voice_samples']} live voice-samples {bound['segments']}, "
          f"{bound['bytes']} bytes); share {bound['bound_ms'] / ms:.4f}")

    # (c) the full sonification of a seeded 64 KB blob, polyphony 4
    blob = np.random.default_rng(8).integers(0, 256, SONIFY_BYTES, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    snotes = es.binary_sonification_notes_full(blob, polyphony=4, sample_rate=SR)
    t_notes = time.perf_counter() - t0
    t0 = time.perf_counter()
    _tune_render(snotes)
    first_s = time.perf_counter() - t0
    walls_s = []
    for i in range(3):
        if i == 0:
            cv.LAUNCHES = 0
        t0 = time.perf_counter()
        sout = _tune_render(snotes)
        walls_s.append(time.perf_counter() - t0)
        if i == 0:
            launches_sonify = cv.LAUNCHES
    wall_s = statistics.median(walls_s)
    with TuneProbe() as sprobe:
        t0 = time.perf_counter()
        _tune_render(snotes)
        wall_sprobe = time.perf_counter() - t0
    secs = sout.shape[0] / SR
    print(f"[tune] (c) binary_sonification_notes_full({SONIFY_BYTES} bytes, polyphony 4): "
          f"{len(snotes)} notes ({t_notes:.3f} s on the host), {sprobe.rows} rows, "
          f"{secs:.1f} s of audio; first {first_s:.3f} s, warm median {wall_s * 1e3:.3f} ms "
          f"of 3 ({', '.join(f'{w * 1e3:.3f}' for w in walls_s)} ms), {secs / wall_s:.1f}x "
          f"realtime on {card}; kernel launches {launches_sonify}; peak "
          f"{_check_audio('(12c) sonify', sout):.4f}")
    print(f"[tune] (c) {sprobe.report(wall_sprobe)}")
    if launches_sonify <= 0:
        raise RuntimeError("(12c): the sonification launched no kernel")

    phase_tune_sampler(card, notes)
    phase_dsp_ops(card)
    phase_tune_apps(card)
    return {"launches_tune": launches_tune, "launches_sonify": launches_sonify,
            "ms_tune": ms, "plain_ms_tune": plain_ms, "bound_tune": bound["bound_ms"],
            "max_abs_err_tune": err}


def phase_tune_sampler(card, notes):
    """(d): the 60 s rain stream on two pitched samples (wall, peak device
    memory, finite output), then 2 s of it on cuda against the CPU at the
    sampler's float32 bar (1e-6, tests/test_torch_sampler.py)."""
    import torch

    from cpp_audio_tpu_torch.apps import tune
    from cpp_audio_tpu_torch.utils import event_streams as es

    specs = write_tune_samples(TUNE_DIR)
    _tune_render(notes, sample_files=specs)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = _tune_render(notes, sample_files=specs)
    wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() - base
    print(f"[tune] (d) sampler, rain {TUNE_SECONDS:.0f} s on {len(specs)} samples: wall "
          f"{wall * 1e3:.3f} ms ({TUNE_SECONDS / wall:.1f}x realtime) on {card}; peak device "
          f"memory {mem / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before; output "
          f"{tuple(out.shape)} peak {_check_audio('(12d) sampler', out):.4f}")
    short = es.rain_notes(TUNE_APP_SECONDS, sample_rate=SR, seed=0)
    g = _tune_render(short, sample_files=specs)
    c, _ = tune.render_notes(short, synth_dir=TUNE_DIR, sample_rate=SR, sample_files=specs,
                             device="cpu")
    diff = float((g.cpu() - c).abs().max())
    print(f"[tune] (d) sampler {TUNE_APP_SECONDS} s, cuda against cpu: max|diff| {diff:.3e} "
          f"(peak {float(c.abs().max()):.4f}, bar 1e-6)")
    if not (g.shape == c.shape and diff <= 1e-6):
        raise RuntimeError("(12d): the sampler on cuda disagrees with the CPU")


def phase_dsp_ops(card):
    """(e): the 60 s headline stereo mixdown through a seeded 2 s stereo
    48 kHz impulse response loaded with load_impulse_response (resampled to
    44.1 kHz) on cuda against the CPU (float32 at 1e-5 of peak, float64 at
    1e-10); the noise tables' grey table against fir.fft_convolve on cuda;
    apps.test_fft once."""
    import contextlib
    import io

    import torch

    from cpp_audio_tpu_torch.apps import test_fft
    from cpp_audio_tpu_torch.models import sine_synth, voicebank
    from cpp_audio_tpu_torch.ops import fir, noise, reverb
    from cpp_audio_tpu_torch.utils import wav as wavio

    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    mix = voicebank.render_bank(sine_synth.bank_from_schedule(sch, cfg), n,
                                block_size=cfg.block_size, device="cuda")
    rng = np.random.default_rng(21)
    m = 2 * 48000
    ir = rng.standard_normal((m, 2)) * np.exp(-np.arange(m) / 12000.0)[:, None] * 0.05
    wavio.write_wav(f"{TUNE_DIR}/ir_48k.wav", ir, 48000)
    rv = reverb.load_impulse_response(f"{TUNE_DIR}/ir_48k.wav", SR, 2, device="cuda")
    rv_cpu = reverb.load_impulse_response(f"{TUNE_DIR}/ir_48k.wav", SR, 2, device="cpu")
    rv.wet = rv_cpu.wet = 0.3
    d_ir = float(np.abs(rv.ir - rv_cpu.ir).max())

    def run():
        y = reverb.apply_reverb(mix, rv)
        torch.cuda.synchronize()
        return y

    run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        g = run()
        walls.append(time.perf_counter() - t0)
    c = reverb.apply_reverb(mix.cpu(), rv_cpu, device="cpu")
    peak = float(c.abs().max())
    d32 = float((g.cpu() - c).abs().max()) / peak
    g64 = reverb.apply_reverb(mix.double(), rv)
    c64 = reverb.apply_reverb(mix.double().cpu(), rv_cpu, device="cpu")
    d64 = float((g64.cpu() - c64).abs().max())
    wall = statistics.median(walls)
    print(f"[dsp] load_impulse_response (2 s stereo at 48 kHz -> {rv.ir.shape[0]} taps at "
          f"44.1 kHz): cuda against cpu max|diff| {d_ir:.3e}; apply_reverb of the "
          f"{SECONDS:.0f} s headline mixdown {tuple(mix.shape)} {mix.dtype}: warm median "
          f"{wall * 1e3:.3f} ms of 3 ({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms) on "
          f"{card}; cuda against cpu: float32 max|diff|/peak {d32:.3e} (peak {peak:.4f}, bar "
          f"1e-5), float64 max|diff| {d64:.3e} (bar 1e-10)")
    if not (rv.ir.shape == (88200, 2) and d_ir <= 1e-10 and d32 <= 1e-5 and d64 <= 1e-10
            and _check_audio("(12e) reverb", g) > 1e-3):
        raise RuntimeError("(12e): the reverb on cuda disagrees with the CPU")

    t0 = time.perf_counter()
    tables = noise.get_noise_tables(SR)
    t_tables = time.perf_counter() - t0
    n_grey, taps = int(SR / 0.1), 1023
    pink = noise.pink_noise_table(n_grey + taps, SR, 12348)
    h = fir.loudness_fir_coefficients(SR, 4096, taps)
    grey = fir.fft_convolve(pink, h, device="cuda")[taps:taps + n_grey]
    grey = (grey / grey.abs().max()).cpu().numpy()
    d_grey = float(np.abs(grey - tables["grey"]).max())
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = test_fft.main(["--device", "cuda"])
    plots = text.getvalue().count("== loudness-adapted noise")
    print(f"[dsp] get_noise_tables({SR}) in {t_tables:.3f} s (host): grey table "
          f"{tables['grey'].shape} against fir.fft_convolve on cuda max|diff| {d_grey:.3e} "
          f"(bar 1e-10); apps.test_fft --device cuda: rc {rc}, {plots} plots")
    if not (d_grey <= 1e-10 and rc == 0 and plots == 7):
        raise RuntimeError("(12e): the grey noise table or apps.test_fft failed")


def phase_tune_apps(card):
    """(f): every apps.tune mode at ~2 s on cuda, each writing its WAV;
    --play with one preset edit (1 reload); the score mode on cuda against
    the CPU (1e-4, the low-pass's bar); every apps.wav_tools tool."""
    import contextlib
    import io
    import os
    import shutil

    from cpp_audio_tpu_torch.apps import tune, wav_tools
    from cpp_audio_tpu_torch.utils import wav as wavio
    from cpp_audio_tpu_torch.utils import wir

    d = TUNE_DIR
    rng = np.random.default_rng(4)
    with open(f"{d}/blob22.bin", "wb") as f:
        f.write(rng.integers(0, 256, 22, dtype=np.uint8).tobytes())
    with open(f"{d}/blob20.bin", "wb") as f:
        f.write(rng.integers(0, 256, 20, dtype=np.uint8).tobytes())
    specs = write_tune_samples(d)
    score = "do re mi fa sol la si Do"
    modes = {  # name: argv, whose m_*.wav is the WAV it writes under TUNE_DIR
        "score": [score, "m_score.wav", "--synth-dir", d, "--time-unit-ms", "140"],
        "--demo": ["--demo", "m_demo.wav"],
        "--rain": ["--rain", str(TUNE_APP_SECONDS), "m_rain.wav", "--synth-dir", d],
        "--sonify": ["--sonify", f"{d}/blob22.bin", "m_sonify.wav", "--synth-dir", d],
        "--sonify-full": ["--sonify", f"{d}/blob20.bin", "m_full.wav", "--sonify-full",
                          "--polyphony", "2", "--loop", "2", "--modulo-pitch"],
        "--sample": ([score + " Re Mi", "m_sample.wav", "--octave", "2", "--time-unit-ms",
                      "140"] + [a for s in specs for a in ("--sample", s)]),
        "--score2": ["do mi sol", "m_duo.wav", "--score2", "sol si re", "--octave2", "3",
                     "--time-unit-ms", "300"],
        "--play": [score, "m_play.wav", "--synth-dir", d, "--play", "--time-unit-ms", "140"],
    }
    for name, argv in modes.items():
        out = next(f"{d}/{a}" for a in argv if a.startswith("m_"))
        argv = [out if a.startswith("m_") else a for a in argv]
        if os.path.exists(out):
            os.remove(out)
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = tune.main(argv + ["--device", "cuda"])
        wall = time.perf_counter() - t0
        data, sr = wavio.read_wav(out)
        peak = float(np.abs(data).max())
        print(f"[tune apps] apps.tune {name}: rc {rc}, {wall:.3f} s, {data.shape[0] / sr:.2f} s "
              f"of audio, peak {peak:.4f}: {text.getvalue().strip()[-90:]}")
        if rc != 0 or not (np.isfinite(data).all() and peak > 1e-4):
            raise RuntimeError(f"(12f): apps.tune {name} failed")

    # --play with one preset edit half a second in: one reload
    play = f"{d}/play"
    shutil.rmtree(play, ignore_errors=True)
    write_tune_presets(play)
    notes = tune.score_to_notes(score, sample_rate=SR, time_unit_ms=140.0)
    edited = []

    def on_block(bi, t):
        if not edited and t > SR // 2:
            with open(f"{play}/Harmonics.txt", "w") as f:
                f.write("--------\n")
            edited.append(bi)

    reloads, total = tune.play_streaming(notes, f"{play}/hot.wav", synth_dir=play,
                                         sample_rate=SR, block_seconds=0.1,
                                         on_block=on_block, device="cuda")
    print(f"[tune apps] play_streaming with a Harmonics.txt edit at block {edited}: "
          f"{reloads} reloads, {total} samples")
    if reloads != 1:
        raise RuntimeError(f"(12f): {reloads} preset reloads, 1 expected")

    g, _ = tune.render_score(score, synth_dir=d, time_unit_ms=140.0, device="cuda")
    c, _ = tune.render_score(score, synth_dir=d, time_unit_ms=140.0, device="cpu")
    diff = float((g.cpu() - c).abs().max())
    print(f"[tune apps] score mode, cuda against cpu: max|diff| {diff:.3e} (peak "
          f"{float(c.abs().max()):.4f}, bar 1e-4)")
    if not (g.shape == c.shape and diff <= 1e-4):
        raise RuntimeError("(12f): the score on cuda disagrees with the CPU")

    src = f"{d}/m_score.wav"
    wir.write_wir(f"{d}/m_score.wir", wavio.read_wav(src)[0], SR)
    for argv in (["count_channels", src], ["mod_wav", src, f"{d}/t_mod.wav"],
                 ["self_convolve", src, f"{d}/t_self.wav"],
                 ["join_non_zeros", src, f"{d}/t_join.wav"],
                 ["wir_2_wav", f"{d}/m_score.wir", f"{d}/t_wir.wav"]):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = wav_tools.main(argv)
        said = text.getvalue().strip()
        if rc != 0 or not (said == "2" or os.path.exists(said)):
            raise RuntimeError(f"(12f): apps.wav_tools {argv[0]} failed: {said}")
        print(f"[tune apps] apps.wav_tools {argv[0]}: {said}")


PROC_DIR = "build/phase13"    # WAVs of phase 13's app runs (git-ignored)
PROC_SECONDS = 60.0           # bench.py's L5a rows (bench.py:454-602)
PROC_BATCH = 64
PROC_SEEDS = list(range(500, 500 + PROC_BATCH))       # timed batches: fresh seeds
PROC_WARM_SEEDS = list(range(100, 100 + PROC_BATCH))  # bench.py's warm-up seeds
PROC_APP_SECONDS = 2.0        # (e) cuda against cpu, (f) the apps
SE_F32_BAR = 2e-4             # tests/test_batched_serving.py:26
WIND_RMS_BAR = 1e-4

# 12-band dB fingerprints of every program (1 s render, seed 32, 440 Hz,
# pan 0): tests/test_golden_semantics.py's table, copied so the script
# stands alone
PROC_FINGERPRINTS = {
    ("birds", "Standard & Cute bird"): [-40.55, -39.05, -36.45, -33.29, -29.36, -21.61, 39.06, 56.86, -17.68, -36.60, -47.19, -54.36],
    ("birds", "Scat bird"): [-24.94, -21.55, -20.23, -15.92, -10.89, 4.72, 55.99, 57.29, -4.47, -23.21, -34.07, -41.49],
    ("birds", "Rhythmic bird"): [-21.05, -22.16, -17.48, -14.79, -8.07, 9.90, 49.43, 55.10, -1.39, -19.77, -30.25, -37.22],
    ("birds", "Slow bird"): [-41.94, -41.19, -38.24, -35.12, -31.86, -24.86, 8.94, 53.64, -19.99, -37.89, -47.20, -53.51],
    ("birds", "BiTone bird"): [-37.09, -34.56, -31.90, -28.20, -21.30, 2.93, 54.72, 56.86, -19.67, -36.29, -45.34, -51.56],
    ("birds", "Happy bird 1"): [-3.41, -1.12, 1.33, 4.41, 8.76, 17.33, 55.00, 56.57, 13.39, 10.27, 8.02, 6.49],
    ("birds", "Happy bird 2"): [-3.99, -1.80, 0.34, 2.61, 4.99, 8.19, 55.50, 53.40, 20.98, 4.51, -3.40, -9.68],
    ("birds", "Laughing bird"): [-0.77, 1.48, 3.63, 5.94, 8.51, 12.42, 54.72, 54.26, 16.30, 8.67, 4.91, 2.81],
    ("birds", "Talkative bird"): [-0.12, 2.09, 4.31, 6.75, 9.53, 13.18, 55.97, 55.82, 15.83, 10.21, 7.17, 5.36],
    ("robots", "R2D2"): [-8.12, -5.22, 5.35, 9.00, 54.22, 50.19, 4.85, -10.07, -18.39, -25.84, -32.17, -37.33],
    ("robots", "Communication"): [9.63, 12.07, 16.32, 22.37, 58.53, 56.51, 22.58, 17.68, 14.93, 12.63, 10.66, 9.22],
    ("sweep", "Sweep 1"): [84.29, 79.80, 68.17, 49.20, 43.67, 40.61, 38.13, 35.87, 33.70, 31.62, 29.72, 28.31],
    ("sweep", "Fullrange"): [44.04, 41.84, 39.60, 37.46, 35.28, 33.11, 30.94, 28.78, 26.65, 24.58, 22.69, 21.28],
    ("wind", "Medium wind in trees"): [50.92, 50.50, 55.22, 59.11, 60.75, 61.31, 60.44, 58.62, 55.21, 51.37, 47.44, 43.86],
    ("wind", "Steady wind"): [31.44, 41.63, 53.89, 60.36, 62.63, 61.00, 55.12, 45.42, 31.59, 15.89, 1.79, -3.72],
    ("wind", "Strong wind"): [63.61, 62.82, 66.14, 67.81, 68.04, 68.11, 67.90, 67.56, 66.15, 64.07, 61.23, 57.61],
    ("wind", "Vinyl cracks"): [-2.12, 0.76, 4.02, 7.47, 13.44, 28.72, 43.40, 50.92, 53.89, 54.30, 53.38, 51.13],
    ("wind", "Small animal eating"): [-1.05, -1.37, 1.02, 3.82, 4.69, 9.55, 18.38, 23.85, 31.94, 32.99, 31.43, 27.52],
    ("wind", "Heavy rain in a car"): [21.67, 22.17, 25.40, 28.45, 37.47, 51.76, 58.58, 62.05, 62.89, 62.99, 62.54, 61.51],
    ("wind", "Light rain in a car"): [8.05, 11.07, 13.76, 16.86, 20.03, 30.97, 44.66, 51.87, 54.36, 54.98, 54.31, 52.49],
    ("wind", "Heavy rain"): [25.96, 38.58, 55.02, 62.48, 65.70, 67.05, 67.50, 67.82, 67.49, 67.33, 67.22, 67.20],
    ("wind", "Light rain"): [21.25, 21.78, 25.55, 31.67, 46.27, 57.69, 62.83, 65.02, 65.42, 65.35, 64.88, 63.95],
    ("wind", "Bubbles"): [-34.36, -28.18, -8.85, 14.70, 22.07, 21.17, 17.59, 12.41, 3.74, -4.47, -16.72, -29.43],
    ("wind", "Earth rumbling"): [61.43, 57.62, 51.96, 38.56, 8.68, 1.43, -1.45, -3.88, -6.11, -8.21, -10.13, -11.53],
    ("wind", "Sine wind"): [-18.80, -16.59, -14.39, -11.91, -8.85, 33.10, 35.82, -4.06, -15.47, -23.04, -29.62, -35.26],
    ("wind", "Kettle whistle pure"): [-20.19, -18.37, -16.12, -11.28, -5.40, -0.87, 7.03, 36.17, 18.30, -11.13, -17.73, -20.14],
    ("wind", "Kettle whistle mixed"): [-13.69, -11.54, -9.25, -6.62, 3.69, 25.67, 40.90, 53.29, 49.93, 35.96, 19.04, 2.46],
}


def band_fingerprint(mono: np.ndarray, sr: int = SR, n_bands: int = 12) -> np.ndarray:
    """tests/test_golden_semantics.band_fingerprint: 12 log-spaced bands
    from 40 Hz to 16 kHz, energy in dB."""
    spec = np.abs(np.fft.rfft(mono)) ** 2
    freqs = np.fft.rfftfreq(len(mono), 1 / sr)
    edges = np.logspace(np.log10(40), np.log10(16000), n_bands + 1)
    return np.array([10 * np.log10(max(spec[(freqs >= edges[i]) & (freqs < edges[i + 1])].sum(),
                                       1e-20)) for i in range(n_bands)])


def _synced_wall(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _peak_memory(fn) -> tuple[int, int]:
    """(peak device bytes allocated during one run above what was held
    before it, bytes held before it)."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held, held


def _render_report(tag, fn, card, audio_seconds) -> dict:
    """(a)-(c)'s single render: first wall, median of 3 warm walls, ATen
    ops, synchronising calls, peak memory, realtime factor, profile; the
    warm renders must be bitwise equal and finite."""
    import torch

    first, _ = _synced_wall(fn)
    walls, outs = [], []
    for _ in range(3):
        w, out = _synced_wall(fn)
        walls.append(w)
        outs.append(out)
    wall = statistics.median(walls)
    ops = _dispatched_ops(fn)
    syncs = _reported_syncs(fn)
    peak, held = _peak_memory(fn)
    out = outs[-1]
    bitwise = all(torch.equal(o, out) for o in outs)
    print(f"[proc] {tag}: {tuple(out.shape)} {out.dtype}; first {first:.3f} s, warm median "
          f"{wall * 1e3:.3f} ms of 3 ({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms), "
          f"{audio_seconds / wall:.1f}x realtime on {card}; {ops} ATen ops; synchronising "
          f"calls {syncs}; peak device memory {peak / 2**20:.1f} MiB above {held / 2**20:.1f} "
          f"held; warm renders bitwise equal: {bitwise}")
    _profile_run(fn, tag=f"proc {tag} ", top=8)
    if not (bitwise and bool(torch.isfinite(out).all()) and float(out.abs().max()) > 1e-5):
        raise RuntimeError(f"(13) {tag}: renders not finite, silent or not bitwise equal")
    return {"wall": wall, "ops": ops, "peak": peak}


def _batch_report(tag, render, card, n) -> None:
    """(c)-(d)'s batch of PROC_BATCH: warmed on PROC_WARM_SEEDS, timed on
    PROC_SEEDS; aggregate realtime factor, peak memory, profile; the timed
    batch rendered again must be bitwise equal."""
    import torch

    first, _ = _synced_wall(lambda: render(PROC_WARM_SEEDS))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall, out = _synced_wall(lambda: render(PROC_SEEDS))
    peak = torch.cuda.max_memory_allocated() - held
    again = render(PROC_SEEDS)
    torch.cuda.synchronize()
    bitwise = torch.equal(again, out)
    del again
    secs = PROC_BATCH * n / SR
    print(f"[proc] {tag}: batch {tuple(out.shape)} {out.dtype}; warm-up (seeds "
          f"{PROC_WARM_SEEDS[0]}-{PROC_WARM_SEEDS[-1]}) {first:.3f} s; timed (seeds "
          f"{PROC_SEEDS[0]}-{PROC_SEEDS[-1]}) {wall:.3f} s, aggregate {secs / wall:.1f}x "
          f"realtime ({PROC_BATCH} x {n / SR:.0f} s) on {card}; peak device memory "
          f"{peak / 2**30:.3f} GiB above {held / 2**30:.3f} held; repeat bitwise equal: "
          f"{bitwise}")
    if not (bitwise and bool(torch.isfinite(out).all()) and out.shape[0] == PROC_BATCH):
        raise RuntimeError(f"(13) {tag}: batch not finite or not bitwise equal")
    del out
    _profile_run(lambda: render(PROC_SEEDS), tag=f"proc {tag} ", top=6)


def phase_procedural(card: str) -> dict:
    """Phase 13: the procedural engine and its apps on cuda, (a) to (f) of
    the module docstring. Returns the kernels-line keys it measures."""
    import torch

    from cpp_audio_tpu_torch.models import soundengine, voice_presets, wind

    n = int(SR * PROC_SECONDS)
    rain = voice_presets.get_program(voice_presets.Mode.WIND, "Heavy rain")
    bubbles = voice_presets.get_program(voice_presets.Mode.WIND, "Bubbles")
    bird0 = voice_presets.PROGRAMS[voice_presets.Mode.BIRDS][0]
    talk = voice_presets.get_program(voice_presets.Mode.BIRDS, "Talkative bird")

    # (a), (b): single WIND renders, the serving path (device-expanded
    # controls) and the host walks
    for prog in (rain, bubbles):
        for dc in (True, False):
            _render_report(
                f"({'a' if prog is rain else 'b'}) WIND {prog.name!r} (order "
                f"{prog.filter_order}), {PROC_SECONDS:.0f} s, "
                f"{'device controls' if dc else 'host walks'}",
                lambda prog=prog, dc=dc: wind.render_program(
                    prog, n, SR, seed=2, device_controls=dc, device="cuda"),
                card, PROC_SECONDS)

    # (c): one SoundEngine render, then the batches
    _render_report(f"(c) SoundEngine {bird0.name!r}, {PROC_SECONDS:.0f} s",
                   lambda: soundengine.render_program(bird0, 440.0, n, SR, seed=2,
                                                      device="cuda"),
                   card, PROC_SECONDS)
    for prog in (bird0, talk):
        specs = max(len(soundengine.SoundEngineScheduler(prog, SR, 440.0, seed=s).build_specs())
                    for s in PROC_SEEDS)
        _batch_report(f"(c) SoundEngine {prog.name!r} (up to {specs} specs a job)",
                      lambda seeds, prog=prog: soundengine.render_program_batch(
                          prog, 440.0, n, SR, seeds=seeds, device_out=True,
                          device="cuda"), card, n)
    # (d): the WIND batch
    _batch_report(f"(d) WIND {rain.name!r}",
                  lambda seeds: wind.render_program_batch(rain, n, SR, seeds=seeds,
                                                          device_out=True,
                                                          device="cuda"), card, n)
    gc.collect()
    torch.cuda.empty_cache()

    phase_procedural_correctness()
    return phase_procedural_apps(card)


def _rms_rel(got, want) -> float:
    return float(np.sqrt(((got - want) ** 2).mean()) / max(np.sqrt((want ** 2).mean()), 1e-12))


def phase_procedural_correctness() -> None:
    """(e): the 27 fingerprints on cuda; 2 s renders cuda against cpu."""
    from cpp_audio_tpu_torch.apps import birds
    from cpp_audio_tpu_torch.models import soundengine, voice_presets, wind

    worst = []
    for (mode, name), ref in sorted(PROC_FINGERPRINTS.items()):
        if (mode, name) == ("wind", "Small animal eating"):
            out, tol = birds.render("wind", name, 1.0, seed=32, device="cuda"), 3.0
        elif mode == "wind":
            p = voice_presets.get_program(voice_presets.Mode.WIND, name)
            out, tol = wind.render_program(p, SR, SR, seed=32, device="cuda"), 1.5
        else:
            p = voice_presets.get_program(voice_presets.Mode(mode), name)
            out = soundengine.render_program(p, 440.0, SR, SR, seed=32, pan=0.0,
                                             dtype="float64", device="cuda")
            tol = 1.5
        host = out.cpu().numpy()
        d = float(np.abs(band_fingerprint(host.sum(axis=1)) - np.asarray(ref)).max())
        worst.append((d, tol, f"{mode}/{name}"))
        if not (np.isfinite(host).all() and d <= tol):
            raise RuntimeError(f"(13e) {mode}/{name}: fingerprint off by {d:.3f} dB (tol {tol})")
    d, tol, which = max(worst)
    print(f"[proc] (e) all {len(worst)} programs at 1 s on cuda: finite, fingerprints within "
          f"tolerance; the largest deviation {d:.3f} dB ({which}, tol {tol})")

    # the device expansion of the control walks on the card, bit for bit
    # the host walk (tests/test_wind_noise.py:133-146's cases)
    import torch

    pink = wind._pink_dev(SR, "float32", "cpu").numpy()
    for n_steps, itp, T in ((12, 0, 60000), (997, 8, 60000)):
        host = wind.wind_long_walk(pink, 1234, n_steps, itp, T, prev0=0.37)
        segs = wind._walk_segments_dev(torch.from_numpy(np.abs(pink)).to("cuda"),
                                       torch.tensor([1234], device="cuda"),
                                       torch.tensor([0.37], dtype=torch.float32, device="cuda"),
                                       n_steps=n_steps, T=T)
        dev = wind._expand_long_walk_dev(*segs, n_steps=n_steps, itp_code=itp, T=T)[0]
        equal = np.array_equal(dev.cpu().numpy(), host)
        print(f"[proc] (e) WIND walk expansion on cuda (n_steps {n_steps}, itp {itp}, {T} "
              f"samples) against the host walk: bitwise equal {equal}")
        if not equal:
            raise RuntimeError("(13e): the device walk expansion differs from the host walk")

    n = int(SR * PROC_APP_SECONDS)
    cases = [("SoundEngine", voice_presets.PROGRAMS[voice_presets.Mode.BIRDS][0], {}),
             ("SoundEngine", voice_presets.get_program(voice_presets.Mode.ROBOTS, "R2D2"), {}),
             ("WIND", voice_presets.get_program(voice_presets.Mode.WIND, "Heavy rain"),
              {"device_controls": True}),
             ("WIND", voice_presets.get_program(voice_presets.Mode.WIND, "Heavy rain"), {}),
             ("WIND", voice_presets.get_program(voice_presets.Mode.WIND, "Sine wind"), {})]
    for kind, prog, kw in cases:
        for dtype in ("float64", "float32"):
            def run(dev):
                if kind == "WIND":
                    return wind.render_program(prog, n, SR, seed=5, dtype=dtype, device=dev,
                                               **kw).cpu().numpy()
                return soundengine.render_program(prog, 440.0, n, SR, seed=5, dtype=dtype,
                                                  device=dev).cpu().numpy()

            g, c = run("cuda"), run("cpu")
            peak = float(np.abs(c).max())
            rel = float(np.abs(g - c).max()) / peak
            if dtype == "float64":
                ok, said = rel <= 1e-9, f"max|diff|/peak {rel:.3e} (bar 1e-9)"
            elif kind == "WIND":
                rr = _rms_rel(g, c)
                ok, said = rr <= WIND_RMS_BAR, f"RMS-relative {rr:.3e} (bar {WIND_RMS_BAR})"
            else:
                ok, said = rel <= SE_F32_BAR, f"max|diff|/peak {rel:.3e} (bar {SE_F32_BAR})"
            print(f"[proc] (e) {kind} {prog.name!r} {kw or ''} {dtype}, {PROC_APP_SECONDS} s, "
                  f"cuda against cpu: {said}, peak {peak:.4f}")
            if not (ok and peak > 1e-5):
                raise RuntimeError(f"(13e) {prog.name} {dtype}: cuda disagrees with cpu")


def phase_procedural_apps(card: str) -> dict:
    """(f): apps.birds, the Birds facade, the web demo, Wrapper.process and
    an AudioEngine with the streaming post chain, on cuda."""
    import contextlib
    import io
    import os
    import threading
    import urllib.request

    import torch

    from cpp_audio_tpu_torch.apps import birds, birds_stream, web_demo
    from cpp_audio_tpu_torch.core import engine, events, wrapper
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
    from cpp_audio_tpu_torch.utils import wav as wavio

    os.makedirs(PROC_DIR, exist_ok=True)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = birds.main(["--list", "--device", "cuda"])
    listed = [ln for ln in text.getvalue().splitlines() if ln.startswith("  ")]
    print(f"[proc apps] apps.birds --list: rc {rc}, {len(listed)} programs")
    if rc != 0 or len(listed) != 27:
        raise RuntimeError("(13f): apps.birds --list failed")
    for mode, program in (("birds", "0"), ("robots", "R2D2"), ("sweep", "1"),
                          ("wind", "Heavy rain")):
        out = f"{PROC_DIR}/{mode}.wav"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = birds.main(["--mode", mode, "--program", program, "--seconds",
                             str(PROC_APP_SECONDS), "--device", "cuda", out])
        wall = time.perf_counter() - t0
        data, sr = wavio.read_wav(out)
        peak = float(np.abs(data).max())
        print(f"[proc apps] apps.birds --mode {mode} --program {program!r}: rc {rc}, "
              f"{wall:.3f} s, {data.shape[0] / sr:.2f} s of audio, peak {peak:.4f}")
        if rc != 0 or not (np.isfinite(data).all() and 1e-5 < peak <= 1.0):
            raise RuntimeError(f"(13f): apps.birds --mode {mode} failed")
    said = io.StringIO()
    notes = birds.interactive(mode="birds", program=0, seconds=PROC_APP_SECONDS,
                              out_dir=f"{PROC_DIR}/session", stdin=io.StringIO("1\nx\nq\n"),
                              stdout=said, seed=3, device="cuda")
    wavs = sorted(os.listdir(f"{PROC_DIR}/session"))
    print(f"[proc apps] apps.birds --interactive, script '1, x, q': {notes} notes, "
          f"{len(wavs)} WAVs, quit: {'quitting' in said.getvalue()}")
    if notes != 3 or len(wavs) < 3 or "quitting" not in said.getvalue():
        raise RuntimeError("(13f): the interactive session failed")

    # the Birds facade: quanta from one host copy per render
    fac = birds_stream.Birds(SR, "birds", render_seconds=PROC_APP_SECONDS, device="cuda")
    fac.note_on(440.0)
    t0 = time.perf_counter()
    quanta = [fac.process() for _ in range(100)]
    t_q = time.perf_counter() - t0
    fac.use_program(2)
    loop = fac.process(int(SR * PROC_APP_SECONDS) + 4096)  # past the end: re-render
    ok = (all(q.shape == (128, 2) and np.isfinite(q).all() for q in quanta)
          and loop.shape == (int(SR * PROC_APP_SECONDS) + 4096, 2) and np.isfinite(loop).all()
          and isinstance(fac._buf, np.ndarray) and fac._program == 2)
    print(f"[proc apps] Birds facade: 100 quanta of 128 in {t_q * 1e3:.3f} ms (one render "
          f"and its host copy, then host slices), program change, loop re-render "
          f"{loop.shape}: ok {ok}")
    if not ok:
        raise RuntimeError("(13f): the Birds facade failed")

    # the web demo around the facade, on a localhost port
    httpd = web_demo.make_server(fac, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/api/info", timeout=30) as r:
            info_status, info = r.status, json.loads(r.read())
        with urllib.request.urlopen(base + "/api/chunk?n=16384", timeout=60) as r:
            chunk_status, pcm = r.status, np.frombuffer(r.read(), np.float32).reshape(-1, 2)
        req = urllib.request.Request(base + "/api/program?i=4", method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            prog_status = r.status
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    ok = (info_status == 200 and len(info["programs"]) == 9 and chunk_status == 200
          and pcm.shape == (16384, 2) and np.isfinite(pcm).all() and prog_status == 200
          and fac._program == 4)
    print(f"[proc apps] web_demo.make_server(Birds(device='cuda')): /api/info {info_status} "
          f"({len(info['programs'])} programs), /api/chunk?n=16384 {chunk_status} "
          f"{pcm.shape}, POST /api/program?i=4 {prog_status}: ok {ok}")
    if not ok:
        raise RuntimeError("(13f): the web demo failed")

    # Wrapper.process with events: each block with voices launches the kernel
    w = wrapper.Wrapper(device="cuda")
    script = [[events.mk_note_on(100, 440.0, 1.0, note_id=1),
               events.mk_note_on(2000, 660.0, 0.7, note_id=2, pan=0.4)],
              [events.mk_note_change(4096 + 300, 1, 452.0, 0.9)],
              [events.mk_note_off(8192 + 5, note_id=1)], [events.mk_note_off(12288, note_id=2)],
              [], []]
    cv.LAUNCHES = 0
    blocks = [w.process(evs, 4096) for evs in script]
    torch.cuda.synchronize()
    launches_wrapper = cv.LAUNCHES
    out = torch.cat(blocks)
    peak = float(out.abs().max())
    print(f"[proc apps] Wrapper.process, {len(script)} blocks of 4096 with events: kernel "
          f"launches {launches_wrapper}, output {tuple(out.shape)} {out.dtype} on "
          f"{out.device}, peak {peak:.4f}")
    if launches_wrapper <= 0 or not (bool(torch.isfinite(out).all()) and 1e-4 < peak <= 1.0):
        raise RuntimeError("(13f): Wrapper.process failed")

    # an AudioEngine with the streaming convolver and the limiter, cuda
    # against cpu
    ir = np.random.default_rng(9).standard_normal((SR // 2, 2)) * np.exp(
        -np.arange(SR // 2) / 4000.0)[:, None] * 0.05

    def run_engine(dev):
        wr = wrapper.Wrapper(device=dev, with_limiter=False)
        wr.engine.post = engine.AudioPost()
        wr.engine.post.add(engine.StreamingConvolver(ir, wet=0.6, partition=2048, device=dev))
        wr.engine.post.add(engine.StreamingLimiter(ceiling=0.5, sample_rate=SR, device=dev))
        wr.engine.post.add(engine.clamp_guard)
        return torch.cat([wr.process(evs, 4096) for evs in script]).cpu().numpy()

    g, c = run_engine("cuda"), run_engine("cpu")
    rel = float(np.abs(g - c).max()) / float(np.abs(c).max())
    print(f"[proc apps] AudioEngine (StreamingSynth, StreamingConvolver {ir.shape[0]} taps, "
          f"StreamingLimiter, clamp), {g.shape[0]} samples, cuda against cpu: max|diff|/peak "
          f"{rel:.3e} (bar {KERNEL_BAR}), peak {float(np.abs(c).max()):.4f}")
    if not rel <= KERNEL_BAR:
        raise RuntimeError("(13f): the engine on cuda disagrees with the CPU")
    return {"launches_wrapper": launches_wrapper}


MESH_DIR = "build/phase14"    # process-group stores of phase 14 (git-ignored)
MESH_SECONDS = 2.0            # (b): each chain and job
PROBE_BACKENDS = ("gloo", "nccl")  # NCCL refuses: the probe reports it
MESH_BAR = 1e-3               # of the peak: JAX's sharded-chain bar (tests/test_parallel.py:96-100)


def _mesh_rel(got, ref) -> float:
    """max |got - ref| / peak(ref) over ref's length (the sharded chains'
    stereo runs longer: its frames are padded to the world size)."""
    m = min(got.shape[0], ref.shape[0])
    return float((got[:m] - ref[:m]).abs().max()) / max(float(ref[:m].abs().max()), 1e-9)


def _hold_mesh(tag, got, ref, bar=MESH_BAR) -> None:
    """(stereo, vocoded, dropped) against a single-device chain result."""
    stereo, voc, dropped = got[:3]
    e_r, e_v = _mesh_rel(stereo, ref.resynth), _mesh_rel(voc, ref.vocoded)
    print(f"[mesh] {tag}: resynth {tuple(stereo.shape)} max|diff|/peak {e_r:.3e}, "
          f"vocoded {e_v:.3e} (bar {bar:g}), dropped {int(dropped)} / {int(ref.dropped)}")
    if not (e_r < bar and e_v < bar and int(dropped) == int(ref.dropped)):
        raise RuntimeError(f"{tag} disagrees with the single-device chain")


def probe_collectives(backend_name, device="cuda"):
    """One rank's report of which collectives its process group takes on
    tensors of `device` (a diagnostic: phase 14 (b)'s plan is fixed, not
    chosen from this)."""
    import torch
    import torch.distributed as dist

    from cpp_audio_tpu_torch.parallel import mesh

    dev = mesh._rank_device(device)
    n = dist.get_world_size()
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    ops = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(4, device=dev)),
        gather.__name__: lambda: gather(torch.empty(4 * n, device=dev),
                                        torch.ones(4, device=dev)),
        "broadcast": lambda: dist.broadcast(torch.ones(4, device=dev), src=0),
    }
    took = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            took[name] = "took"
        except Exception as exc:  # noqa: BLE001 - the probe reports each refusal
            took[name] = f"refused ({type(exc).__name__}: {str(exc).splitlines()[0][:120]})"
    return {backend_name: took}


def phase_mesh(card: str) -> dict:
    """Phase 14: parallel/mesh.py on the card. (a) one NCCL rank in this
    process at the headline width; (b) two ranks sharing cuda:0 on gloo.
    Returns the kernels-line keys it measures."""
    import os

    import torch
    import torch.distributed as dist

    from cpp_audio_tpu_torch.analysis import chain
    from cpp_audio_tpu_torch.models import voicebank
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv
    from cpp_audio_tpu_torch.ops import stft
    from cpp_audio_tpu_torch.parallel import launch, mesh

    os.makedirs(MESH_DIR, exist_ok=True)
    store = os.path.abspath(os.path.join(MESH_DIR, "nccl_store"))
    if os.path.exists(store):
        os.remove(store)
    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg)
    B = cfg.block_size
    out = {}

    # (a) one NCCL rank on cuda:0, in this process
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        m = mesh.default_mesh(device="cuda")
        print(f"[mesh] (a) {dist.get_backend()} world {dist.get_world_size()} on "
              f"{torch.cuda.get_device_name(0)}; gather: dist.{mesh.ALL_GATHER_NAME}")
        got = mesh.render_bank_sharded(bank, n, block_size=B, mesh=m, device="cuda")
        ref = voicebank.render_bank(bank, n, block_size=B, device="cuda")
        torch.cuda.synchronize()
        equal = torch.equal(got, ref)
        print(f"[mesh] (a) render_bank_sharded {tuple(got.shape)} against render_bank: "
              f"equal to the bit {equal}")
        if not equal:
            raise RuntimeError("(14a): render_bank_sharded differs from render_bank")

        args, st = voicebank.prepare_bank_arrays(bank, n, B, device="cuda")
        off_st = dict(block_size=B, n_blocks=st["n_blocks"] - 3, block_offset=3)
        k_out = cv.render_blocks_cuda(*cv.one_job(args), **off_st)[0]
        p_out = cv.render_blocks_plain(*cv.one_job(args), **off_st)[0]
        torch.cuda.synchronize()
        err_off = float((k_out - p_out).abs().max())
        # the same launch geometry from block 3 on: equal to the bit
        same = torch.equal(k_out[: n - 3 * B], ref[3 * B:])
        print(f"[mesh] (a) kernel block_offset=3 ({off_st['n_blocks']} blocks of {B}) "
              f"against its plain version: max|diff| {err_off:.3e} (bar {KERNEL_BAR}); "
              f"equal to render_bank from sample {3 * B}: {same}")
        if not (err_off <= KERNEL_BAR and same):
            raise RuntimeError(f"(14a): the kernel at block_offset=3 disagrees: {err_off}, {same}")
        out["max_abs_err_offset"] = err_off

        mono = ref.sum(dim=1)
        w = stft.gaussian_window(rcfg.window_size)
        single = stft.stft_sqmag(mono, w, rcfg.stride, device="cuda")
        for name, fn in (("stft_sqmag_sharded", mesh.stft_sqmag_sharded),
                         ("stft_sqmag_sharded_halo", mesh.stft_sqmag_sharded_halo)):
            sq = fn(mono, w, rcfg.stride, mesh=m, device="cuda")
            ok = sq.shape == single.shape and bool(torch.allclose(sq, single, rtol=2e-4, atol=1e-8))
            print(f"[mesh] (a) {name} {tuple(sq.shape)} on the 60 s mixdown against "
                  f"stft_sqmag: max|diff| {float((sq - single).abs().max()):.3e}, within "
                  f"rtol 2e-4 atol 1e-8 {ok}")
            if not ok:
                raise RuntimeError(f"(14a): {name} disagrees with stft_sqmag")

        def device_chain():
            res = chain.run_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                                 block_size=B, device="cuda")
            torch.cuda.synchronize()
            return res

        device_chain()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            single_res = device_chain()
            walls.append(time.perf_counter() - t0)
        base = statistics.median(walls)
        print(f"[mesh] (a) run_offline_chain_device: median {base * 1e3:.3f} ms of 3 warm "
              f"({', '.join(f'{x * 1e3:.3f}' for x in walls)} ms) on {card}")
        m2 = mesh.default_mesh_2d(1, 1, device="cuda")
        for key, build in (
                ("launches_mesh", mesh.make_sharded_chain(m, n, rcfg, vparams, block_size=B,
                                                          device="cuda")),
                ("launches_mesh_2d", mesh.make_sharded_chain_2d(m2, n, rcfg, vparams,
                                                                block_size=B, device="cuda"))):
            step = build(bank, carrier)

            def run():
                res = step()
                torch.cuda.synchronize()
                return res

            run()
            walls = []
            for i in range(3):
                if i == 0:
                    cv.LAUNCHES = 0
                t0 = time.perf_counter()
                res = run()
                walls.append(time.perf_counter() - t0)
                if i == 0:
                    out[key] = cv.LAUNCHES
            wall = statistics.median(walls)
            tag = "make_sharded_chain" if key == "launches_mesh" else "make_sharded_chain_2d (1, 1)"
            print(f"[mesh] (a) {tag}: median {wall * 1e3:.3f} ms of 3 warm "
                  f"({', '.join(f'{x * 1e3:.3f}' for x in walls)} ms; {wall / base:.3f}x the "
                  f"single-device chain) on {card}; kernel launches {out[key]}; "
                  f"collectives per step {step.collective_counts()}")
            if out[key] <= 0 or not all(bool(torch.isfinite(t).all()) for t in res[:2]):
                raise RuntimeError(f"(14a): {tag} launched no kernel or is not finite")
            _hold_mesh(f"(a) {tag} against run_offline_chain_device", res, single_res)
    finally:
        dist.destroy_process_group()

    # (b) two ranks sharing cuda:0. NCCL takes no two ranks of one
    # communicator on one card; gloo takes all_reduce, the gather and
    # broadcast on CUDA tensors (the probe prints what each took)
    took = {}
    for backend in PROBE_BACKENDS:
        took.update(launch.spawn(2, probe_collectives, backend, "cuda", backend=backend,
                                 device="cuda", timeout=120, pg_timeout=30,
                                 store_dir=MESH_DIR))
    print(f"[mesh] (b) two ranks on cuda:0, collectives on CUDA tensors: {json.dumps(took)}")
    n2 = int(SR * MESH_SECONDS)
    sch2, cfg2 = make_chain_test_workload(SR, n2)
    bank2, rcfg2, vp2, _ = _chain_inputs(n2, sch2, cfg2)
    cars = [np.sign(np.sin(2 * np.pi * f * np.arange(n2) / SR)) for f in (110.0, 220.0)]
    refs = [chain.run_offline_chain_device(bank2, n2, rcfg2, vp2, c, block_size=cfg2.block_size,
                                           device="cuda") for c in cars]
    kw = {"block_size": cfg2.block_size, "device": "cuda"}
    calls = [(launch.chain_outputs, (n2, rcfg2, vp2, bank2, cars[0]), kw),
             (mesh.render_jobs_farm, ([bank2, bank2], n2, rcfg2, vp2, cars), kw),
             (mesh.render_jobs_pipelined, ([bank2, bank2], n2, rcfg2, vp2, cars), kw)]
    t0 = time.perf_counter()
    chain2, farm, piped = launch.spawn(2, launch.run_calls, calls, backend="gloo",
                                       device="cuda", timeout=400, store_dir=MESH_DIR)
    print(f"[mesh] (b) gloo, 2 ranks on cuda:0: the three runs in {time.perf_counter() - t0:.1f} s "
          f"(spawn and imports included); chain collectives per step {chain2[3]}")
    cpu_refs = [chain.OfflineChainResult(r.resynth.cpu(), r.vocoded.cpu(), r.n_frames,
                                         dropped=int(r.dropped)) for r in refs]

    def tensors(job):
        return tuple(torch.as_tensor(np.asarray(x)) for x in job[:3])

    _hold_mesh("(b) make_sharded_chain at world 2", tensors(chain2), cpu_refs[0])
    for j in range(2):
        _hold_mesh(f"(b) render_jobs_farm (2 groups of 1), job {j}", tensors(farm[j]),
                   cpu_refs[j])
        _hold_mesh(f"(b) render_jobs_pipelined (1 + 1), job {j}", tensors(piped[j]),
                   cpu_refs[j])
    t0 = time.perf_counter()
    same = launch.spawn(2, rank_tracker_table, backend="gloo", device="cuda", timeout=300,
                        store_dir=MESH_DIR)
    print(f"[mesh] (b) C3 on one card: {same['world']} gloo ranks each track the headline "
          f"peaks ({same['shape']} tables) in {time.perf_counter() - t0:.1f} s: tables "
          f"gathered and equal to the bit {same['tables_equal']}, dropped {same['dropped']} "
          f"equal {same['dropped_equal']} (the ranks' own peaks equal to the bit: "
          f"{same['own_peaks_equal']})")
    if not (same["tables_equal"] and same["dropped_equal"]):
        raise RuntimeError("(14b): two ranks built different tracker tables from one set of peaks")
    return out


REPRO_RUNS = 5                # phase 15: runs of each path, held to the bit


def _bits_equal(a, b) -> bool:
    """a and b equal to the bit (NaN pads included): same shape and dtype,
    and the same bytes."""
    import torch

    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return torch.equal(a, b)


def rank_tracker_table() -> dict:
    """One gloo rank of phase 14 (b)'s C3 check: the headline peaks (rank
    0's, broadcast, as the sharded chains' ranks all track one gathered set
    of peaks), the device tracker's table and dropped count on this rank,
    and every rank's gathered. Returns on rank 0 whether the ranks' tables,
    dropped counts and own peaks are equal to the bit."""
    import torch
    import torch.distributed as dist

    from cpp_audio_tpu_torch.analysis import device_tracker as tdt
    from cpp_audio_tpu_torch.parallel import mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    inputs, kw, _render = headline_tracker_inputs(n, sch, cfg, dev)
    own = torch.stack(inputs[:2])
    peaks = own.clone()
    dist.broadcast(peaks, src=0)
    table, dropped = tdt.build_tables_device(peaks[0], peaks[1], *inputs[2:], device=dev,
                                             **kw)
    world = dist.get_world_size()
    tables = mesh._all_gather(table[None], None)
    drops = mesh._all_gather(dropped.reshape(1), None)
    owns = mesh._all_gather(own[None], None)
    torch.cuda.synchronize()
    return {"world": world, "shape": tuple(table.shape), "dropped": drops.tolist(),
            "tables_equal": all(_bits_equal(tables[0], tables[r]) for r in range(world)),
            "dropped_equal": len(set(drops.tolist())) == 1,
            "own_peaks_equal": all(_bits_equal(owns[0], owns[r]) for r in range(world))}


@contextlib.contextmanager
def _recorded_tables():
    """Context: every call of a device_tracker entry (build_tables_device:
    the chains', resynthesize's, the mesh's; build_tables_device_df: the
    fidelity chain's; build_tables_device_batch: the batched serving
    step's) appends its (table, dropped) to the yielded list."""
    from cpp_audio_tpu_torch.analysis import device_tracker as tdt

    names = ("build_tables_device", "build_tables_device_df",
             "build_tables_device_batch")
    plain, calls = {name: getattr(tdt, name) for name in names}, []

    def recording(fn):
        def build(*a, **k):
            out = fn(*a, **k)
            calls.append(out)
            return out
        return build

    for name in names:
        setattr(tdt, name, recording(plain[name]))
    try:
        yield calls
    finally:
        for name in names:
            setattr(tdt, name, plain[name])


def _repeat(tag, run, needs_kernel: bool) -> int:
    """run() (outputs: tensors or arrays) REPRO_RUNS times; every output,
    the tracker's tables and dropped counts against the first run's, to the
    bit. Prints one line; fails on any difference, or when the tracker (or,
    with needs_kernel, the voice-bank kernel) did not run. Returns the
    kernel launches of the runs."""
    import torch

    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    runs = []
    cv.LAUNCHES = 0
    for _ in range(REPRO_RUNS):
        with _recorded_tables() as calls:
            outs = [torch.as_tensor(o) for o in run()]
            torch.cuda.synchronize()
        runs.append((outs, [t for t, _ in calls],
                     [torch.as_tensor(d).tolist() for _, d in calls]))
    launches = cv.LAUNCHES
    outs0, tables0, dropped0 = runs[0]
    diff = max(float((a.to(b.device) - b).abs().max()) if a.numel() else 0.0
               for outs, _t, _d in runs[1:] for a, b in zip(outs, outs0))
    tables_equal = all(len(t) == len(tables0) and all(map(_bits_equal, t, tables0))
                       for _o, t, _d in runs[1:])
    dropped_equal = all(d == dropped0 for _o, _t, d in runs[1:])
    print(f"[repro] {tag}: {REPRO_RUNS} runs, outputs "
          f"{', '.join(str(tuple(o.shape)) for o in outs0)}: max|diff| against the first "
          f"{diff:.3e}; tracker tables {len(tables0)} x {tuple(tables0[0].shape) if tables0 else ()} "
          f"equal to the bit {tables_equal}; dropped {dropped0} equal {dropped_equal}; "
          f"kernel launches {launches}")
    if not tables0 or (needs_kernel and launches <= 0):
        raise RuntimeError(f"(15) {tag}: the tracker or the kernel did not run")
    if not (diff == 0.0 and tables_equal and dropped_equal):
        raise RuntimeError(f"(15) {tag} differs between runs")
    return launches


def phase_repro(card: str) -> dict:
    """Phase 15: the paths whose float sums used to depend on the order of
    the card's atomics, each run REPRO_RUNS times in torch's default
    (non-deterministic) mode and held to the bit. Returns the kernels-line
    key it measures (launches_repro: the float32 device chain's runs)."""
    import os

    import torch
    import torch.distributed as dist

    from cpp_audio_tpu_torch.analysis import chain
    from cpp_audio_tpu_torch.analysis import offline_job as oj
    from cpp_audio_tpu_torch.analysis import resynth as rs
    from cpp_audio_tpu_torch.parallel import mesh

    if torch.are_deterministic_algorithms_enabled():
        raise RuntimeError("(15): torch's deterministic mode is on")
    print(f"[repro] torch's deterministic mode off "
          f"(use_deterministic_algorithms: {torch.are_deterministic_algorithms_enabled()}) "
          f"on {card}")
    n = int(SR * SECONDS)
    sch, cfg = make_synth_workload(SR, n)
    out = {}
    for dtype in ("float32", "df32"):
        bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg, dtype)

        def device_chain(bank=bank, rcfg=rcfg, vparams=vparams, carrier=carrier):
            r = chain.run_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                               block_size=cfg.block_size, device="cuda")
            return r.resynth, r.vocoded, r.dropped

        launches = _repeat(f"run_offline_chain_device ({dtype}), {SECONDS:.0f} s",
                           device_chain, needs_kernel=True)
        if dtype == "float32":
            out["launches_repro"] = launches

    preset = _job_preset()
    job = write_job("j1", n, preset)
    _, voice, _carrier, _ = oj.load_job_inputs(job)
    rcfg_job = oj.resynth_config_from_preset(preset, SR)
    _repeat(f"resynthesize of the job's gained voice, {SECONDS:.0f} s",
            lambda: (rs.resynthesize(preset.analysis_input_gain * voice, rcfg_job,
                                     device_out=True, device="cuda"),),
            needs_kernel=False)
    _repeat(f"J1 offline_job.run_job, {SECONDS:.0f} s",
            lambda: (oj.run_job(job, device="cuda"),), needs_kernel=False)

    step, _ = serving_step(SERVE_SEEDS, n)
    _repeat(f"prepare_offline_chain_device_batch step() at B = {len(SERVE_SEEDS)}, "
            f"{SECONDS:.0f} s", step, needs_kernel=True)
    del step

    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg)
    os.makedirs(MESH_DIR, exist_ok=True)
    store = os.path.abspath(os.path.join(MESH_DIR, "repro_store"))
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        step = mesh.make_sharded_chain(mesh.default_mesh(device="cuda"), n, rcfg, vparams,
                                       block_size=cfg.block_size, device="cuda")(bank, carrier)
        _repeat(f"make_sharded_chain at world 1 (NCCL), {SECONDS:.0f} s", step,
                needs_kernel=True)
    finally:
        dist.destroy_process_group()
    return out


SERVE_SEEDS = list(range(42, 58))  # phase 16 (a): 16 jobs of the headline
SERVE_F64_SEEDS = [42, 43]         # (a): the float64 batch
BREADTH_SEEDS = [42, 43, 44, 45]   # (b): each configuration's batch of 4
# a batch's job against run_offline_chain_device on its bank: resynth and
# vocoded max|diff| over the single chain's peak
# (tests/test_torch_chain_device.py:test_batch_matches_single)
SERVE_BARS = (1e-3, 3e-3)


def serving_step(seeds, n, dtype="float32", n_voices=64, **rcfg_kw):
    """prepare_offline_chain_device_batch over make_synth_workload's banks
    at `seeds` (block 2^18, the 110 Hz square carrier shared, the chain's
    config at `dtype` with `rcfg_kw`), staged on cuda. Returns (run: step()
    ending in torch.cuda.synchronize, returning (stereo, vocoded, dropped);
    (banks, rcfg, vparams, carrier): the single chains' arguments)."""
    import dataclasses

    import torch

    from cpp_audio_tpu_torch.analysis import chain
    from cpp_audio_tpu_torch.models import sine_synth

    banks = []
    for seed in seeds:
        sch, cfg = make_synth_workload(SR, n, seed=seed, n_voices=n_voices)
        banks.append(sine_synth.bank_from_schedule(sch, cfg))
    _bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg, dtype)
    rcfg = dataclasses.replace(rcfg, **rcfg_kw)
    step, n_frames = chain.prepare_offline_chain_device_batch(
        banks, n, rcfg, vparams, carrier, block_size=BENCH_BLOCK, device="cuda")
    if n_frames != int((n - rcfg.window_size) // rcfg.stride + 1):
        raise RuntimeError(f"(16) the batch reports {n_frames} analysis frames")

    def run():
        out = step()
        torch.cuda.synchronize()
        return out

    return run, (banks, rcfg, vparams, carrier)


def _instrumented(run) -> dict:
    """One run ending in torch.cuda.synchronize, timed and counted: its
    wall, output, voice-bank kernel launches (the count set to 0 just
    before, read just after), the device tracker's host syncs, the
    tracker's path (the exact frame loop, device_tracker._scan_tables, as
    the card takes it: the tables it built, FRAME_LOOPS; or the
    frame-parallel tracker) and the peak device memory above what was held
    before it."""
    import torch

    from cpp_audio_tpu_torch.analysis import device_tracker as tdt
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    syncs, loops = tdt.HOST_SYNCS, tdt.FRAME_LOOPS
    cv.LAUNCHES = 0
    wall, out = _synced_wall(run)
    loops = tdt.FRAME_LOOPS - loops
    return {"wall": wall, "out": out, "launches": cv.LAUNCHES,
            "syncs": tdt.HOST_SYNCS - syncs,
            "path": f"exact frame loop ({loops} tables)" if loops else "frame-parallel",
            "peak": torch.cuda.max_memory_allocated() - held, "held": held}


def _walls(run, reps=5) -> tuple[float, list, dict]:
    """(the first call's wall, `reps` warm walls, the first warm run's
    _instrumented record), each run ending in torch.cuda.synchronize."""
    first, _ = _synced_wall(run)
    counted = _instrumented(run)
    walls = [counted.pop("wall")] + [_synced_wall(run)[0] for _ in range(reps - 1)]
    return first, walls, counted


def _memory(rec) -> str:
    return (f"peak device memory {rec['peak'] / 2**30:.3f} GiB above "
            f"{rec['held'] / 2**30:.3f} held")


def _ms_list(walls) -> str:
    return ", ".join(f"{w * 1e3:.3f}" for w in walls)


def _hold_to_singles(tag, out, chain_args, n) -> str:
    """Each job of a batched step's (stereo, vocoded, dropped) against
    run_offline_chain_device on the same bank on cuda, at SERVE_BARS and
    dropped equal; fails above a bar. Returns the worst ratios as text."""
    from cpp_audio_tpu_torch.analysis import chain

    stereo, voc, dropped = out
    banks, rcfg, vparams, carrier = chain_args
    worst_r = worst_v = 0.0
    for j, bank in enumerate(banks):
        one = chain.run_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                             block_size=BENCH_BLOCK, device="cuda")
        peak_r = float(one.resynth.abs().max())
        peak_v = float(one.vocoded.abs().max())
        if stereo[j].shape != one.resynth.shape or voc[j].shape != one.vocoded.shape:
            raise RuntimeError(f"(16) {tag}: job {j}'s shapes differ from its single chain's")
        dr = float((stereo[j] - one.resynth).abs().max()) / max(peak_r, 1e-9)
        dv = float((voc[j] - one.vocoded).abs().max()) / max(peak_v, 1e-9)
        worst_r, worst_v = max(worst_r, dr), max(worst_v, dv)
        if not (peak_r > 1e-3 and peak_v > 1e-3 and dr < SERVE_BARS[0]
                and dv < SERVE_BARS[1] and int(dropped[j]) == int(one.dropped)):
            raise RuntimeError(f"(16) {tag}: job {j} disagrees with its single chain: "
                               f"resynth {dr:.3e}, vocoded {dv:.3e}, dropped "
                               f"{int(dropped[j])} / {int(one.dropped)}")
    return (f"resynth max|diff|/peak {worst_r:.3e} (bar {SERVE_BARS[0]}), vocoded "
            f"{worst_v:.3e} (bar {SERVE_BARS[1]}), dropped equal, over "
            f"{len(banks)} jobs")


def _single_step_syncs(n) -> tuple[int, str]:
    """The synchronising calls of one step() of prepare_offline_chain_device
    on the headline (as phase 4 counts them), warm."""
    import torch

    from cpp_audio_tpu_torch.analysis import chain

    sch, cfg = make_synth_workload(SR, n)
    bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg)
    step, _ = chain.prepare_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                                 block_size=cfg.block_size, device="cuda")

    def run():
        step()
        torch.cuda.synchronize()

    run()
    return _sync_hits(run)


def phase_serving(card: str) -> dict:
    """Phase 16: (a) the batched serving step at width, (b) bench.py's
    breadth configurations; returns the kernels-line keys it measures."""
    measured = _serving_batch(card)
    _serving_breadth(card)
    _serving_reference()
    return measured


def _serving_batch(card: str) -> dict:
    """(a): prepare_offline_chain_device_batch over SERVE_SEEDS' headline
    jobs, float32, then over SERVE_F64_SEEDS in float64."""
    import torch

    from cpp_audio_tpu_torch.models import voicebank
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    n = int(SR * SECONDS)
    B = len(SERVE_SEEDS)
    run, chain_args = serving_step(SERVE_SEEDS, n)
    first, walls, rec = _walls(run)
    wall = statistics.median(walls)
    launches, syncs = rec["launches"], rec["syncs"]
    stereo, voc, dropped = out = rec.pop("out")
    n_sync, where = _sync_hits(run)
    n_sync_single, where_single = _single_step_syncs(n)
    single = CHAIN_WALLS.get("float32")
    print(f"[serving] batch of {B} (seeds {SERVE_SEEDS[0]}-{SERVE_SEEDS[-1]}, 64 voices, "
          f"{SECONDS:.0f} s, block 2^18, float32): stereo {tuple(stereo.shape)}, vocoded "
          f"{tuple(voc.shape)}, dropped {dropped.tolist()}; first step() {first:.3f} s; "
          f"warm median {wall * 1e3:.3f} ms of 5 ({_ms_list(walls)} ms), "
          f"{wall / B * 1e3:.3f} ms per job against run_offline_chain_device's "
          + (f"{single * 1e3:.3f} ms (phase 4)" if single else "(phase 4 not run)")
          + f"; {B * SECONDS / wall:.1f}x realtime aggregate on {card}")
    print(f"[serving] per step(): kernel launches {launches}; tracker host syncs "
          f"{syncs}, path {rec['path']}; synchronising calls (sync debug mode) {n_sync} "
          f"({where}) against a single chain's step() {n_sync_single} ({where_single}); "
          f"{_memory(rec)}")
    if launches != 1 or syncs != 0 or n_sync > n_sync_single:
        raise RuntimeError(f"(16a) {launches} kernel launches, {syncs} tracker syncs, "
                           f"{n_sync} synchronising calls (single step: {n_sync_single}) "
                           "per step; expected 1, 0 and no more than a single step")
    if not (bool(torch.isfinite(stereo).all()) and bool(torch.isfinite(voc).all())
            and stereo.shape[0] == B and stereo.shape[2] == 2):
        raise RuntimeError("(16a) batch output not finite or misshapen")
    del out, stereo, voc

    # the batched synth against each job's own launch (to the bit) and
    # against the plain version; its time and bound
    tables, st = voicebank.prepare_bank_arrays(chain_args[0], n, BENCH_BLOCK,
                                               device="cuda")

    def batched():
        return cv.render_blocks_cuda(*tables, **st)

    synth = batched()
    bitwise = all(torch.equal(synth[j], cv.render_blocks_cuda(*(t[j:j + 1] for t in tables),
                                                              **st)[0])
                  for j in range(B))
    plain = cv.render_blocks_plain(*tables, **st)
    torch.cuda.synchronize()
    err = float((synth - plain).abs().max())
    del plain
    ms_batch = cuda_ms_amortized(batched, reps=10)
    bound = cv.kernel_bound(tables[0], tables[1], n_channels=2, **st)
    print(f"[serving] kernel, one launch at {tuple(tables[0].shape)} x {st['n_blocks']} "
          f"blocks of 2^18: each job's slice equal to the bit to its own launch: "
          f"{bitwise}; max|kernel-plain| {err:.3e} (bar {KERNEL_BAR}); "
          f"{ms_batch:.4f} ms amortized; bound {bound['bound_ms']:.5f} ms by "
          f"{bound['bound_by']} ({bound['live_voice_samples']} live voice-samples), "
          f"share {bound['bound_ms'] / ms_batch:.3f}")
    if not (bitwise and err <= KERNEL_BAR):
        raise RuntimeError("(16a) the batched launch differs from the jobs' own launches "
                           "or from the plain version")
    del synth, tables
    print(f"[serving] float32 batch against the single chains: "
          f"{_hold_to_singles('float32 batch', run(), chain_args, n)}")
    _profile_run(run, tag="serving ")
    del run, chain_args

    run64, args64 = serving_step(SERVE_F64_SEEDS, n, "float64")
    first64, walls64, rec64 = _walls(run64, reps=2)
    out64 = rec64.pop("out")
    print(f"[serving] float64 batch of {len(SERVE_F64_SEEDS)}: stereo "
          f"{tuple(out64[0].shape)} {out64[0].dtype}; first {first64:.3f} s, warm "
          f"{_ms_list(walls64)} ms; launches {rec64['launches']}, tracker path "
          f"{rec64['path']}, {_memory(rec64)}; against the float64 single chains: "
          f"{_hold_to_singles('float64 batch', out64, args64, n)}")
    if out64[0].dtype != torch.float64 or rec64["launches"] != 1:
        raise RuntimeError("(16a) the float64 batch is not float64 or not one launch")
    del out64
    # its synth: the kernel's float64 instantiation, each job's slice
    # against the job's own launch and the plain version
    t64, st64 = voicebank.prepare_bank_arrays(args64[0], n, BENCH_BLOCK, "float64",
                                              device="cuda")
    synth64 = cv.render_blocks_cuda(*t64, **st64)
    bitwise64 = all(torch.equal(synth64[j], cv.render_blocks_cuda(
        *(t[j:j + 1] for t in t64), **st64)[0]) for j in range(len(SERVE_F64_SEEDS)))
    err64 = float((synth64 - cv.render_blocks_plain(*t64, **st64)).abs().max())
    print(f"[serving] float64 batch's synth {tuple(synth64.shape)} {synth64.dtype}: each "
          f"job's slice equal to the bit to its own launch: {bitwise64}; "
          f"max|kernel-plain| {err64:.3e} (bar {KERNEL_BAR_F64})")
    if not (bitwise64 and synth64.dtype == torch.float64 and err64 <= KERNEL_BAR_F64):
        raise RuntimeError("(16a) the float64 batch's synth differs from its jobs' "
                           "launches or from the plain version")
    return {"launches_batch": launches, "ms_batch": ms_batch,
            "bound_batch": bound["bound_ms"], "bound_batch_by": bound["bound_by"],
            "max_abs_err_batch": err}


def _breadth_configs():
    """bench.py's breadth rows and the merged harmonize: (tag, n_voices,
    the chain config's keywords)."""
    from cpp_audio_tpu_torch.analysis import autotune as at

    return (("127 voices", 127, {}),
            ("autotune MUSICAL_SCALE", 64, dict(
                use_autotune=True,
                autotune_kwargs=dict(autotune_type=at.AutotuneType.MUSICAL_SCALE))),
            ("harmonize pre 7 + post 12, merged", 64, dict(
                pitch_harmonize_pre_autotune=7.0, pitch_harmonize_post_autotune=12.0,
                harmonize_semantics="merged")))


def _serving_breadth(card: str) -> None:
    """(b): each breadth configuration through run_offline_chain_device at
    the headline width (seed 42), then as a batch of BREADTH_SEEDS held
    against its single chains."""
    import dataclasses

    import torch

    from cpp_audio_tpu_torch.analysis import chain

    n = int(SR * SECONDS)
    for tag, n_voices, kw in _breadth_configs():
        sch, cfg = make_synth_workload(SR, n, n_voices=n_voices)
        bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg)
        rcfg = dataclasses.replace(rcfg, **kw)

        def run(bank=bank, rcfg=rcfg, vparams=vparams, carrier=carrier):
            res = chain.run_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                                 block_size=cfg.block_size, device="cuda")
            torch.cuda.synchronize()
            return res

        first, walls, rec = _walls(run)
        res = rec.pop("out")
        _check_chain_result(res, rec["launches"])
        wall = statistics.median(walls)
        print(f"[breadth] {tag}: run_offline_chain_device at {SECONDS:.0f} s, "
              f"{n_voices} voices: first {first:.3f} s, warm median {wall * 1e3:.3f} ms "
              f"of 5 ({_ms_list(walls)} ms), {SECONDS / wall:.1f}x realtime on {card}; "
              f"launches {rec['launches']}; tracker path {rec['path']}; dropped "
              f"{int(res.dropped)}; {_memory(rec)}")
        if rec["launches"] != 1:
            raise RuntimeError(f"(16b) {tag}: {rec['launches']} kernel launches, expected 1")
        del res
        # the batch: one call (its first), timed and counted
        brun, bargs = serving_step(BREADTH_SEEDS, n, n_voices=n_voices, **kw)
        brec = _instrumented(brun)
        print(f"[breadth] {tag}: batch of {len(BREADTH_SEEDS)} (seeds "
              f"{BREADTH_SEEDS[0]}-{BREADTH_SEEDS[-1]}): first step() {brec['wall']:.3f} s, "
              f"launches {brec['launches']}, tracker path {brec['path']}, "
              f"{_memory(brec)}; against the single chains: "
              f"{_hold_to_singles(tag, brec['out'], bargs, n)}")
        if brec["launches"] != 1:
            raise RuntimeError(f"(16b) {tag}: the batch made {brec['launches']} kernel launches")
        del brec, brun


def _serving_reference() -> None:
    """(b)'s configurations on 2 s workloads, cuda against the CPU at phase
    6's bars (vocoded atol 1e-4, resynth max|diff|/peak < 2e-3, dropped and
    frame counts equal), over the whole chain in float64: 127 voices
    (make_synth_workload, seed 7) and the merged harmonize (tests/
    test_chain.py's workload). The same chains in float32 are read and
    printed without a bar: there the card's and the CPU's float32 peaks
    differ in their last bits, and which of two peaks a bin apart survives,
    or which note a peak continues, can differ between the devices (at 127
    voices the float32 chain on one CPU differs from its float64 chain by
    7e-2 of the peak). Autotune MUSICAL_SCALE, as phase 6, on the JAX
    autotune test's signal through resynthesize's device path."""
    import dataclasses

    import torch

    from cpp_audio_tpu_torch.analysis import chain, resynth

    n = 2 * SR
    configs = {tag: kw for tag, _n_voices, kw in _breadth_configs()}
    cases = (("127 voices", make_synth_workload(SR, n, seed=7, n_voices=127)),
             ("harmonize pre 7 + post 12, merged", make_chain_test_workload(SR, n)))
    for tag, (sch, cfg) in cases:
        for dtype in ("float64", "float32"):
            bank, rcfg, vparams, carrier = _chain_inputs(n, sch, cfg, dtype)
            rcfg = dataclasses.replace(rcfg, **configs[tag])
            g, c = (chain.run_offline_chain_device(bank, n, rcfg, vparams, carrier,
                                                   block_size=1 << 13, device=dev)
                    for dev in ("cuda", "cpu"))
            dv = float((g.vocoded.cpu() - c.vocoded).abs().max())
            peak = max(float(c.resynth.abs().max()), 1e-9)
            dr = float((g.resynth.cpu() - c.resynth).abs().max()) / peak
            drop = (int(g.dropped), int(c.dropped))
            print(f"[breadth reference] {tag}, 2 s, {dtype}, whole chain cuda vs the CPU: "
                  f"vocoded max|diff| {dv:.3e}, resynth max|diff|/peak {dr:.3e} (peak "
                  f"{peak:.4f}), dropped {drop[0]} / {drop[1]}"
                  + ("" if dtype == "float64" else " (a reading, no bar)"))
            if g.resynth.dtype != getattr(torch, dtype):
                raise RuntimeError(f"(16b) {tag}: the {dtype} chain returned "
                                   f"{g.resynth.dtype}")
            if dtype == "float64":
                if not (dv <= 1e-4 and g.n_frames == c.n_frames and drop[0] == drop[1]):
                    raise RuntimeError(f"(16b) {tag}: the cuda chain disagrees with the CPU")
                _hold_resynth(f"{tag}, 2 s, float64", "the CPU", g.resynth, c.resynth)
    sig = autotune_test_signal(SR)
    _bank, rcfg, _vp, _car = _chain_inputs(n, *make_chain_test_workload(SR, n))
    acfg = dataclasses.replace(rcfg, seed=5, **configs["autotune MUSICAL_SCALE"])
    g, c = (resynth.resynthesize(sig, acfg, implementation="device", device_out=True,
                                 device=dev) for dev in ("cuda", "cpu"))
    n_o = min(g.shape[0], c.shape[0])
    _hold_resynth("autotune MUSICAL_SCALE, 2 s signal", "cpu device path", g[:n_o], c[:n_o])


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
        render_measured = phase_render_kernel(card)
        launches = phase_chain(card)
        phase_small_reference()
        launches_device = phase_device_chain(card)
        scan_measured = phase_tracker_paths()
        phase_device_reference()
        launches_df = phase_df_chain(card)
        phase_df_fidelity()
        phase_df_reference()
        measured.update(phase_live(card))
        measured.update(phase_jobs_and_apps(card))
        measured.update(phase_tune(card))
        measured.update(phase_procedural(card))
        measured.update(phase_mesh(card))
        measured.update(phase_repro(card))
        measured.update(phase_serving(card))
    except Exception:  # noqa: BLE001 - report any phase failure, exit non-zero
        traceback.print_exc()
        return 1
    kernels = {"kernels": [{
        "name": "voicebank_render",
        "route": "cuda",
        "source": "cpp_audio_tpu_torch/csrc/voicebank.cu",
        "replaces": "cpp_audio_tpu/ops/pallas_voicebank.py:30",
        "launches": launches,
        "launches_device_chain": launches_device,
        "launches_df_chain": launches_df,
        **CHAIN_COSTS,
        **measured,
    }, {
        "name": "tracked_render",
        "route": "cuda",
        "source": "cpp_audio_tpu_torch/csrc/tracked_render.cu",
        "replaces": None,
        **render_measured,
    }, {
        "name": "tracker_scan",
        "route": "cuda",
        "source": "cpp_audio_tpu_torch/csrc/tracker_scan.cu",
        "replaces": None,
        **scan_measured,
    }]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
