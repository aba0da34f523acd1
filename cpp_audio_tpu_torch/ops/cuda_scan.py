"""The device tracker's exact frame loop: the hand-written CUDA kernel's wrapper.

The kernel (csrc/tracker_scan.cu) replaces no Pallas kernel: the JAX
package's frame loop is a lax.scan that XLA compiles. It runs the loop of
analysis/device_tracker (`_track_step` over every frame, the carry in
shared memory) for a batch of jobs, (B, T, k) lanes, in one launch: one CTA
a job, so each job's table equals, to the bit, a launch of that job alone.
See the source for the design and what bounds it.

The plain version of the same function is
device_tracker._scan_tables_plain (one job), and device_tracker
._scan_tables dispatches on the lanes' device: CPU tensors take the plain
loop, CUDA tensors this kernel (or an exception). On a CUDA device the
tracker builds every table here (device_tracker._tries_frame_parallel).
`LAUNCHES` counts
launches; the stage spans record its change as the counter
"scan_launches".
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import numpy as np
import torch

from ..utils import profiling
from . import cuda_voicebank

LAUNCHES = 0  # kernel launches (incremented by scan_tables_cuda only)
profiling.COUNTERS["scan_launches"] = lambda: LAUNCHES

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tracker_scan.cu"
Q = 128            # the kernel's played-set capacity (device_tracker._Q)
MAX_LANES = 512    # lanes and slots: one thread each (csrc kMaxThreads)
N_FIELDS = 16      # table fields (device_tracker._NF)


def build() -> tuple[Path, str]:
    """Compile csrc/tracker_scan.cu into the kernels' build directory
    (once per source content): (library path, ptxas report)."""
    return cuda_voicebank.build(SOURCE, "tracker_scan")


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tracker_scan.restype = i32
    lib.tracker_scan.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, i64, vp, i64,
                                 vp, vp, vp, i32, vp, vp, vp]
    lib.tracker_scan_q.restype = i32
    lib.tracker_scan_q.argtypes = []
    lib.tracker_scan_n_constants.restype = i32
    lib.tracker_scan_n_constants.argtypes = []
    return lib


def scan_constants(kw: dict, dtype: torch.dtype) -> np.ndarray:
    """The host scalars of `_track_step`, each rounded as the eager loop on
    the card rounds it, as float64 (exact) in the kernel's order (the C_*
    enum of csrc/tracker_scan.cu). A Python scalar in a tensor op becomes
    the working type; a tensor divided by a host scalar is multiplied on
    the card by its reciprocal, formed in the working type; a sum of Python
    floats is formed in double first (sus - 1.0)."""
    w = np.float64 if dtype == torch.float64 else np.float32
    S = float(kw["stride"])
    sr = float(kw["sample_rate"])
    sustain = float(kw["sustain"])
    has_decay = sustain < 0.999999
    sus = min(max(sustain, 0.0), 1.0) if has_decay else 1.0
    min_dt = sr / 1000.0
    values = [
        S,                                              # C_S
        w(1.0) / w(S),                                  # C_INV_S
        float(kw["max_track_pitches"]),                 # C_MAXD
        69.0,                                           # C_69
        w(1.0) / w(12.0),                               # C_INV_12
        440.0,                                          # C_440
        w(1.0) / w(sr),                                 # C_INV_SR
        sus,                                            # C_SUS
        sus - 1.0,                                      # C_SUS_M1
        1e-9,                                           # C_EPS_INC
        max(float(kw["attack"]), min_dt, 1.0),          # C_ATTACK
        max(float(kw["decay"]), min_dt, 1.0),           # C_DECAY
        max(float(kw["release"]), min_dt, 1.0),         # C_RELEASE
        max(float(kw["hold"]), 0.0),                    # C_HOLD
        1e12,                                           # C_FAR
        -1e12,                                          # C_NEG_FAR
        float(kw["stereo_spread"]),                     # C_SPREAD
        0.25 * math.pi,                                 # C_QPI
        1e-30,                                          # C_TINY
        -math.pi,                                       # C_NEG_PI
        2.0 / S,                                        # C_TWO_OVER_S
    ]
    return np.array([w(v) for v in values], dtype=w).astype(np.float64)


def scan_ints(kw: dict, n_data_frames: int) -> np.ndarray:
    """max_voices, total_frames, the analysis frames, has_decay, stable
    draws: the kernel's integer statics, as int32."""
    return np.array([int(kw["max_voices"]), int(kw["total_frames"]),
                     int(n_data_frames), int(float(kw["sustain"]) < 0.999999),
                     int(kw["draw_indexing"] == "stable")],
                    dtype=np.int32)


def scan_tables_cuda(tpitch: torch.Tensor, volume: torch.Tensor,
                     loud_order: torch.Tensor, n_data_frames: int,
                     pan_draws: torch.Tensor, phase_draws: torch.Tensor,
                     defaults: torch.Tensor, kw: dict):
    """Launch the kernel on torch.cuda.current_stream(): (B, T, k) tuned
    pitches and volumes (float32 or float64) and int64 loudness orders,
    contiguous, with the pools and the (16,) defaults row of the same type
    -> ((B, T, n_slots, 16) table, (B,) int64 dropped), on the device.
    Never synchronises."""
    global LAUNCHES
    wdt = tpitch.dtype
    if wdt not in (torch.float32, torch.float64):
        raise TypeError(f"the frame-loop kernel runs float32 or float64 lanes, not {wdt}")
    for name, a in (("volume", volume), ("pan_draws", pan_draws),
                    ("phase_draws", phase_draws), ("defaults", defaults)):
        if a.dtype != wdt:
            raise TypeError(f"{name} must be {wdt}, got {a.dtype}")
    if loud_order.dtype != torch.int64:
        raise TypeError(f"loud_order must be int64, got {loud_order.dtype}")
    if tpitch.dim() != 3 or volume.shape != tpitch.shape or loud_order.shape != tpitch.shape:
        raise ValueError("expected (jobs, frames, lanes) tpitch, volume and loud_order "
                         f"of one shape, got {tuple(tpitch.shape)}, "
                         f"{tuple(volume.shape)}, {tuple(loud_order.shape)}")
    B, T, k = tpitch.shape
    P = int(kw["n_slots"])
    if k % 8 or not 8 <= k <= MAX_LANES:
        raise ValueError(f"the kernel takes 8 to {MAX_LANES} lanes in multiples of 8, got {k}")
    if not 1 <= P <= MAX_LANES:
        raise ValueError(f"the kernel takes 1 to {MAX_LANES} slots, got {P}")
    if T != int(kw["total_frames"]):
        raise ValueError(f"{T} frames of lanes for total_frames {kw['total_frames']}")
    if pan_draws.dim() != 1 or phase_draws.dim() != 1 or not (
            pan_draws.numel() and phase_draws.numel()):
        raise ValueError("the pools must be non-empty 1-D tensors")
    if defaults.shape != (N_FIELDS,):
        raise ValueError(f"the defaults row must be ({N_FIELDS},), got {tuple(defaults.shape)}")
    tensors = (tpitch, volume, loud_order, pan_draws, phase_draws, defaults)
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("scan_tables_cuda: every input must be contiguous")
    if any(a.device.type != "cuda" or a.device != tpitch.device for a in tensors):
        raise ValueError(f"scan_tables_cuda: the inputs are on {tpitch.device}, "
                         "not all on one CUDA device")
    if B > 2**31 - 1:
        raise ValueError(f"{B} jobs exceed the grid's x limit")
    table = torch.empty((B, T, P, N_FIELDS), dtype=wdt, device=tpitch.device)
    dropped = torch.empty((B,), dtype=torch.int64, device=tpitch.device)
    consts = scan_constants(kw, wdt)
    ints = scan_ints(kw, n_data_frames)
    lib = load_library()
    with torch.cuda.device(tpitch.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tracker_scan(
            tpitch.data_ptr(), volume.data_ptr(), loud_order.data_ptr(), B, T, k, P,
            pan_draws.data_ptr(), pan_draws.numel(), phase_draws.data_ptr(),
            phase_draws.numel(), defaults.data_ptr(),
            consts.ctypes.data_as(ctypes.c_void_p), ints.ctypes.data_as(ctypes.c_void_p),
            int(wdt == torch.float64), table.data_ptr(), dropped.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"frame-loop kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return table, dropped
