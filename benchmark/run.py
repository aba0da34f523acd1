"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output;
exits non-zero, printing no result, without the CUDA devices the cell asks
for. Caches of the program's builds live in fixed directories of the
checkout (build/).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    try:
        import cpp_audio_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        sys.exit(2)
    from benchmark.harness import runner

    sys.exit(runner.main(t_start=T_START))
