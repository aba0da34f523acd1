#!/usr/bin/env python3
"""Time this checkout's voice-bank kernel against another checkout's, in
turns, on one NVIDIA card.

    python3 tools/voicebank_ab.py --other DIR

DIR holds another `cpp_audio_tpu_torch` package (for example the parent
commit, `git archive <commit> | tar -x -C build/parent`, or a copy whose
csrc/voicebank.cu was edited). Each version is built and launched by its own
package's `ops/cuda_voicebank.render_blocks_cuda`, so each is timed as its
own wrapper launches it (one job's tables with the job axis, or without it
for a package from before the wrapper took one). Both are held against this checkout's plain version
at 2e-5, then timed in the order other, this, this, other on both of
chip_smoke's stopwatches (`cuda_ms`: one synchronised call, the host's
enqueue on the clock; `cuda_ms_amortized`: back-to-back calls behind a
device sleep) on the bench workload (bench.py:52-75, 60 s, 64 voices, block
2^18) at three table sets: the per-block compacted (11, 48, .) tables, the
dense (64, .) tables, and "sustained": the dense tables with every voice
pressed at sample 0 and never released, so every voice-sample is live and in
one segment. The SM clock is sampled (nvidia-smi) while this checkout's
kernel runs back to back. Prints the card line and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def load_voicebank_ops(root: Path, alias: str):
    """Import root/cpp_audio_tpu_torch as the package `alias` and return its
    ops.cuda_voicebank module (the package imports itself relatively only)."""
    init = root / "cpp_audio_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.cuda_voicebank")


def launcher(mod, tables, statics):
    """A call of mod's kernel wrapper on one job's tables -> (T, C): with
    the job axis, or, where mod's wrapper refuses that (a package from
    before the job axis), without it."""
    jobs = tuple(t.unsqueeze(0) for t in tables)
    try:
        mod.render_blocks_cuda(*jobs, **statics)
        return lambda: mod.render_blocks_cuda(*jobs, **statics)[0]
    except ValueError:
        return lambda: mod.render_blocks_cuda(*tables, **statics)


def sm_clock_under_load(fn, seconds: float = 2.0) -> list[float]:
    """SM clock (MHz, nvidia-smi) sampled while fn runs back to back."""
    import torch

    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30)
            samples.append(float(out.stdout.split()[0]))
            time.sleep(0.1)

    poller = threading.Thread(target=poll)
    t0 = time.perf_counter()
    poller.start()
    while time.perf_counter() - t0 < seconds:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    stop.set()
    poller.join()
    return samples


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    a = ap.parse_args()

    import torch

    from cpp_audio_tpu_torch.models import sine_synth, voicebank
    from cpp_audio_tpu_torch.ops import cuda_voicebank as cv

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"[card] {card}")
    ops = {"other": load_voicebank_ops(a.other.resolve(), "other_port"), "this": cv}
    for k, mod in ops.items():
        _path, log = mod.build()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {k}] {line.strip()}")

    n = int(chip_smoke.SR * chip_smoke.SECONDS)
    sch, cfg = chip_smoke.make_synth_workload(chip_smoke.SR, n)
    bank = sine_synth.bank_from_schedule(sch, cfg)
    dense = voicebank.prepare_bank_arrays(bank, n, chip_smoke.BENCH_BLOCK, device="cuda")
    compact = voicebank.compact_block_args(*dense)
    fp, ip, up, gains, codes = dense[0]
    held = ip.clone()
    held[:, 0] = 0
    held[:, 1] = 2**31 - 2**24  # the "never" clamp of prepare_bank_arrays
    sustained = ((fp, held, up, gains, codes), dense[1])
    order = ["other", "this", "this", "other"]
    clocks = {"per_call": chip_smoke.cuda_ms, "amortized": chip_smoke.cuda_ms_amortized}
    result = {"card": card, "other": str(a.other), "order": order}
    for label, (tables, statics) in (("compacted", compact), ("dense", dense),
                                     ("sustained", sustained)):
        plain = cv.render_blocks_plain(*cv.one_job(tables), **statics)[0]
        runs = {k: launcher(m, tables, statics) for k, m in ops.items()}
        errs = {}
        for k, fn in runs.items():
            out = fn()
            torch.cuda.synchronize()
            errs[k] = float((out - plain).abs().max())
            if not errs[k] <= chip_smoke.KERNEL_BAR:
                raise RuntimeError(f"{k} kernel disagrees with plain on {label}: {errs[k]}")
        entry = {"shape": list(tables[0].shape), "max_abs_err": errs,
                 "live_voice_samples": sum(cv.segment_voice_samples(
                     tables[0][None], tables[1][None], **statics).values())}
        for clock, timer in clocks.items():
            times = [(k, timer(runs[k])) for k in order]
            mean = {k: sum(t for j, t in times if j == k) / 2 for k in ops}
            entry[clock] = {"ms_in_turns": times,
                            "speedup": mean["other"] / mean["this"]}
            print(f"[ab] {label} {tuple(tables[0].shape)} {clock}: " + ", ".join(
                f"{k} {t:.4f} ms" for k, t in times)
                + f"; this is {entry[clock]['speedup']:.2f}x faster; errs {errs}")
        result[label] = entry
        if label == "sustained":
            result["sm_clock_mhz_under_load"] = sm_clock_under_load(runs["this"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
