"""Tracked-note render: the hand-written CUDA kernel's wrapper.

The kernel (csrc/tracked_render.cu) replaces no Pallas kernel: the JAX
package left this render to XLA, which fuses it. It renders a slot table of
models/resynth_bank, (F, P, 16 or 17) or a batch of them (J, F, P, ·), to
(F, S, 2) stereo (or (J, F, S, 2)) in one launch, every job of a batch
in the same launch, each job's slice equal to the bit to a launch of that
job alone. A 16-field table is of the render's type (float32 or float64);
the fidelity chain's 17-field table is float64 and its phase is computed in
float64 whatever the render's type. See the source for the design and what
bounds it.

The plain version of the same function is models/resynth_bank
._render_slots_plain, and resynth_bank._render_slots dispatches on the
table's device: CPU tensors take the plain version, CUDA tensors this
kernel (or an exception). The kernel renders each KERNEL_TILE-sample tile
of a frame from the slots that can sound in it; resynth_bank.live_slots is
that selection in plain PyTorch. `LAUNCHES` counts launches; the stage
spans record its change as the counter "render_launches".
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..utils import profiling
from . import cuda_voicebank

LAUNCHES = 0  # kernel launches (incremented by render_slots_cuda only)
profiling.COUNTERS["render_launches"] = lambda: LAUNCHES

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tracked_render.cu"
KERNEL_TILE = 1024  # samples per CTA tile (tracked_render_tile())
FIELDS = (16, 17)   # resynth_bank.N_FIELDS, N_FIELDS_DF


def build() -> tuple[Path, str]:
    """Compile csrc/tracked_render.cu into the kernels' build directory
    (once per source content): (library path, ptxas report)."""
    return cuda_voicebank.build(SOURCE, "tracked_render")


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tracked_render.restype = i32
    lib.tracked_render.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.tracked_render_tile.restype = i32
    lib.tracked_render_tile.argtypes = []
    return lib


def render_slots_cuda(table: torch.Tensor, *, stride: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Launch the kernel on torch.cuda.current_stream(): (F, P, n_fields) or
    (J, F, P, n_fields) contiguous -> (F, stride, 2) or (J, F, stride, 2)
    of `dtype` (float32 or float64). A 16-field table must be of `dtype`,
    a 17-field table float64. Never synchronises."""
    global LAUNCHES
    if table.device.type != "cuda":
        raise ValueError(f"render_slots_cuda: the table is on {table.device}, "
                         "not a CUDA device")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the render kernel renders float32 or float64, not {dtype}")
    if table.dim() not in (3, 4) or table.shape[-1] not in FIELDS:
        raise ValueError("expected a 16- or 17-field slot table (frames, slots, "
                         f"fields) or a batch of them, got {tuple(table.shape)}")
    n_fields = table.shape[-1]
    want = dtype if n_fields == FIELDS[0] else torch.float64
    if table.dtype != want:
        raise TypeError(f"a {n_fields}-field table rendered to {dtype} must be "
                        f"{want}, got {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("render_slots_cuda: the table must be contiguous")
    if stride < 1:
        raise ValueError(f"stride {stride} must be positive")
    lead = table.shape[:-3]
    n_jobs = lead[0] if lead else 1
    n_frames, n_slots = table.shape[-3], table.shape[-2]
    if n_jobs > 65535:
        raise ValueError(f"{n_jobs} jobs exceed the grid's y limit")
    if n_frames * -(-stride // KERNEL_TILE) > 2**31 - 1:
        raise ValueError(f"{n_frames} frames of {stride} samples exceed the grid's x limit")
    out = torch.empty((*lead, n_frames, stride, 2), dtype=dtype, device=table.device)
    lib = load_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tracked_render(table.data_ptr(), out.data_ptr(), n_jobs, n_frames,
                                n_slots, stride, n_fields,
                                int(dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"tracked-render kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
