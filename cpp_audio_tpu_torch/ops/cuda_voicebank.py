"""Voice-bank block renderer: the hand-written CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel cpp_audio_tpu/ops/pallas_voicebank.py:30
(`_kernel`, launched by `render_blocks_pallas`, :86) and the XLA form of the
same math (cpp_audio_tpu/models/voicebank.py:180 `_render_block`), whose
per-voice eased curve codes the kernel also evaluates. See
csrc/voicebank.cu for the kernel's design and what bounds it.

Array contract (shared by both versions): every table has a leading job
axis, J jobs rendered by one kernel launch (one job: J = 1, `one_job`),
and, after it, an optional n_blocks axis for the per-block compacted layout
(models/voicebank.compact_block_args):
    fp    (J, [n_blocks,] V, 8) float  [amp, A, H, D, R, S, top, skip]
    ip    (J, [n_blocks,] V, 2) int32  [press, release]
    up    (J, [n_blocks,] V, 2) int64  [inc, phase0] uint32 NCO words, in [0, 2^32)
    gains (J, [n_blocks,] V, C) float
    codes (J, [n_blocks,] V, 3) int32  attack / decay / release easing codes
Returns (J, n_blocks * block_size, C) of fp's dtype; each job's slice of a
launch equals the bit to a launch of that job alone (the batched serving
step, analysis/chain.prepare_offline_chain_device_batch, renders every job
in one launch). The kernel renders float32 or float64 tables (gains of the
same type). `block_offset` (default 0) shifts the rendered blocks along
the timeline: output block b is the timeline's block b + block_offset (its
samples start at (b + block_offset) * block_size), while a compacted
table's rows stay indexed by b. The 2-D sharded chain
(parallel/mesh.make_sharded_chain_2d) renders its time slice this way.

`render_blocks` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version, CUDA tensors launch the kernel (or raise). There is
no fallback between the two. `LAUNCHES` counts kernel launches.

The kernel renders each KERNEL_TILE-sample tile from the rows that can
sound in it; `tile_live_rows` is that selection in plain PyTorch (the same
int32 offsets and float compares), and `render_blocks_tiled_plain` renders
through it, so the CPU tests reach the tile edges and the voice order.
`segment_voice_samples` counts the work the kernel's bound is built from.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..utils.interp import ease_select
from . import fastmath, oscillators

LAUNCHES = 0  # kernel launches (incremented by render_blocks_cuda only)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "voicebank.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNEL_TILE = 1024  # samples per CTA tile of csrc/voicebank.cu (voicebank_tile())
_MASK32 = 0xFFFFFFFF
_NCO_SCALE = 2.0 ** -31  # int32 NCO counts -> rad/pi


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the voice-bank kernel cannot be built")


def build() -> tuple[Path, str]:
    """Compile csrc/voicebank.cu into BUILD_DIR (once per source content).

    Returns (shared library path, compiler log — ptxas register and spill
    report, empty when the library was already built). Raises on failure.
    """
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
                       ).hexdigest()[:12]
    lib = BUILD_DIR / f"libvoicebank_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, proc.stderr


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    vp = ctypes.c_void_p
    lib.voicebank_render.restype = ctypes.c_int
    ll, i32 = ctypes.c_longlong, ctypes.c_int
    lib.voicebank_render.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, ll, ll,
                                     i32, i32, i32, i32, i32, vp]
    lib.voicebank_tile.restype = ctypes.c_int
    lib.voicebank_tile.argtypes = []
    return lib


def one_job(tables) -> tuple:
    """One job's tables (fp, ip, up, gains, codes) with the job axis added."""
    return tuple(t.unsqueeze(0) for t in tables)


def render_blocks_cuda(fp, ip, up, gains, codes, *, block_size: int,
                       n_blocks: int, block_offset: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on torch.cuda.current_stream(): every job of
    the tables in one launch; float32 or float64."""
    global LAUNCHES
    tensors = (fp, ip, up, gains, codes)
    if any(t.device.type != "cuda" or t.device != fp.device for t in tensors):
        raise ValueError("render_blocks_cuda: every table must be on one CUDA device")
    if fp.dtype not in (torch.float32, torch.float64) or gains.dtype != fp.dtype:
        raise TypeError("the voice-bank kernel renders float32 or float64 tables "
                        f"of one type (got fp {fp.dtype}, gains {gains.dtype})")
    if ip.dtype != torch.int32 or codes.dtype != torch.int32:
        raise TypeError("ip and codes must be int32")
    if up.dtype != torch.int64:
        raise TypeError("up must hold the uint32 NCO words as int64")
    if fp.dim() not in (3, 4) or fp.shape[-1] != 8:
        raise ValueError("fp must be (J, V, 8) or (J, n_blocks, V, 8), got "
                         f"{tuple(fp.shape)}")
    compact = fp.dim() == 4
    n_jobs = fp.shape[0]
    lead = fp.shape[:-1]
    C = gains.shape[-1]
    if (ip.shape[:-1] != lead or up.shape[:-1] != lead or codes.shape[:-1] != lead
            or gains.shape[:-1] != lead or ip.shape[-1] != 2 or up.shape[-1] != 2
            or codes.shape[-1] != 3):
        raise ValueError("fp, ip, up, gains and codes disagree on their leading shape")
    if compact and fp.shape[1] < n_blocks:
        raise ValueError(f"{fp.shape[1]} block tables for {n_blocks} blocks")
    if C not in (1, 2):
        raise ValueError(f"the kernel mixes 1 or 2 channels, got {C}")
    if n_blocks > 65535:
        raise ValueError(f"n_blocks {n_blocks} exceeds the grid's y limit")
    if n_jobs > 65535:
        raise ValueError(f"{n_jobs} jobs exceed the grid's z limit")
    if not 0 <= block_offset < 2**31 - n_blocks:
        raise ValueError(f"block_offset {block_offset} out of the kernel's int range")
    fp_c = fp.contiguous()
    ip_c = ip.contiguous()
    up_c = up.contiguous()  # the kernel reads the words' low 32 bits
    g_c = gains.contiguous()
    codes_c = codes.contiguous()
    n_rows = fp.shape[-2]
    out = torch.empty((n_jobs, n_blocks * block_size, C), dtype=fp.dtype,
                      device=fp.device)
    lib = load_library()
    with torch.cuda.device(fp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.voicebank_render(
            fp_c.data_ptr(), ip_c.data_ptr(), up_c.data_ptr(), g_c.data_ptr(),
            codes_c.data_ptr(), out.data_ptr(), n_rows, C,
            n_rows if compact else 0, int(np.prod(lead[1:])), block_size,
            n_blocks, n_jobs, block_offset, int(fp.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"voice-bank kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits."""
    return ((x + 2**31) & _MASK32) - 2**31


def _mul_mod32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x * y) mod 2^32 for x, y in [0, 2^32), without int64 overflow: y is
    split into 16-bit halves so every partial product stays below 2^48."""
    lo = y & 0xFFFF
    hi = y >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def nco_words(b0: int, press: torch.Tensor, inc: torch.Tensor,
              phase0: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact NCO words ((b0 - press + 1) + k) * inc + phase0 mod 2^32, as
    int64 in [0, 2^32) (the kernel computes the same in native uint32).
    press is the int32 press sample; inc, phase0 are words in [0, 2^32)."""
    base = (b0 - press + 1) & _MASK32
    return (_mul_mod32((base + k) & _MASK32, inc) + phase0) & _MASK32


def _render_block_plain(b: int, fp, ip, up, gains, codes, *, block_size: int,
                        kinds, k0: int = 0, k1: int | None = None) -> torch.Tensor:
    """Samples [k0, k1) of block b (default: the whole block) from (V, ·)
    tables, mixed to (k1 - k0, C): the kernel's math in plain PyTorch
    (uint32 NCO carried in int64, masked to 32 bits — torch on the CPU has
    no uint32 add)."""
    wdt = fp.dtype
    dev = fp.device
    k1 = block_size if k1 is None else k1
    k_i = torch.arange(k0, k1, dtype=torch.int64, device=dev)[None, :]
    k = k_i.to(wdt)
    press = ip[:, 0:1].to(torch.int64)
    release = ip[:, 1:2].to(torch.int64)
    inc, phase0 = up[:, 0:1], up[:, 1:2]
    amp, A, H, D, R, S, top, skip = (fp[:, i:i + 1] for i in range(8))
    skipped = skip > 0.5
    b0 = b * block_size

    tp = _wrap_i32(b0 - press).to(wdt) + k
    trm = _wrap_i32(b0 - release).to(wdt) + k
    va = ease_select(codes[:, 0:1], (tp + 1.0) / A, kinds)
    vd = 1.0 + (S - 1.0) * ease_select(
        codes[:, 1:2], (tp - A - H + 1.0) / torch.clamp(D, min=1.0), kinds)
    pressed = torch.where(tp < A, va, torch.where(
        tp < A + H, 1.0, torch.where(tp < A + H + D, vd, S)))
    rel = top * (1.0 - ease_select(codes[:, 2:3], (trm + 1.0) / R, kinds))
    env = torch.where((tp < 0) | skipped, 0.0, torch.where(
        trm < 0, pressed, torch.where(trm + 1.0 < R, rel, 0.0)))

    ph = nco_words(b0, press, inc, phase0, k_i)
    phases = _wrap_i32(ph).to(wdt) * _NCO_SCALE  # the int32 bitcast, [-1, 1)
    sig = amp * env * fastmath.sinpi_principal(phases)
    return oscillators.mixdown(sig, gains)


def _per_job(render, tables, **statics) -> torch.Tensor:
    """The (J, T, C) stack of `render` over each job's tables (the tables'
    first axis), one job at a time."""
    return torch.stack([render(*(t[j] for t in tables), **statics)
                        for j in range(tables[0].shape[0])])


def _render_job_plain(fp, ip, up, gains, codes, *, block_size: int,
                      n_blocks: int, block_offset: int = 0) -> torch.Tensor:
    """One job's dense (V, ·) or compacted (n_blocks, V, ·) tables, block
    by block -> (n_blocks * block_size, C)."""
    kinds = sorted(set(torch.unique(codes).tolist()))
    compact = fp.dim() == 3
    outs = []
    for b in range(n_blocks):
        tab = (fp[b], ip[b], up[b], gains[b], codes[b]) if compact else (
            fp, ip, up, gains, codes)
        outs.append(_render_block_plain(b + block_offset, *tab,
                                        block_size=block_size, kinds=kinds))
    if not outs:
        return torch.zeros((0, gains.shape[-1]), dtype=fp.dtype, device=fp.device)
    return torch.cat(outs, dim=0)


def render_blocks_plain(fp, ip, up, gains, codes, *, block_size: int,
                        n_blocks: int, block_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, job by job and block by block
    (bounded memory: one (V, block_size) tile at a time). Any float dtype;
    any device."""
    return _per_job(_render_job_plain, (fp, ip, up, gains, codes),
                    block_size=block_size, n_blocks=n_blocks,
                    block_offset=block_offset)


def tile_edges(block_size: int, tile: int = KERNEL_TILE) -> list[tuple[int, int]]:
    """The kernel's sample tiles of one block, [k0, k1); the last is ragged
    when block_size is not a multiple of the tile."""
    return [(k0, min(k0 + tile, block_size)) for k0 in range(0, block_size, tile)]


def tile_live_rows(fp, ip, *, b: int, block_size: int, k0: int,
                   k1: int) -> torch.Tensor:
    """Indices, in voice order, of the rows of (V, ·) tables that can sound
    in samples [k0, k1) of block b: not skipped, pressed by sample k1 - 1,
    and the release tail not over at sample k0. The offsets are the
    kernel's: int32 differences b*B - press and b*B - release, converted to
    the tables' float type, plus the sample index, compared as the
    per-sample envelope compares them. A row left out renders exact zeros
    over the whole range: its envelope segment never decreases with k."""
    b0 = b * block_size
    wdt = fp.dtype
    tp_last = _wrap_i32(b0 - ip[:, 0].to(torch.int64)).to(wdt) + float(k1 - 1)
    tr_first = _wrap_i32(b0 - ip[:, 1].to(torch.int64)).to(wdt) + float(k0)
    live = ~(fp[:, 7] > 0.5) & ~(tp_last < 0) & (tr_first + 1.0 < fp[:, 4])
    return torch.nonzero(live).flatten()


def _render_job_tiled_plain(fp, ip, up, gains, codes, *, block_size: int,
                            n_blocks: int, block_offset: int = 0,
                            tile: int = KERNEL_TILE) -> torch.Tensor:
    """render_blocks_tiled_plain of one job's (V, ·) or (n_blocks, V, ·)
    tables -> (n_blocks * block_size, C)."""
    kinds = sorted(set(torch.unique(codes).tolist()))
    compact = fp.dim() == 3
    C = gains.shape[-1]
    outs = []
    for b in range(n_blocks):
        tab = (fp[b], ip[b], up[b], gains[b], codes[b]) if compact else (
            fp, ip, up, gains, codes)
        bt = b + block_offset
        for k0, k1 in tile_edges(block_size, tile):
            rows = tile_live_rows(tab[0], tab[1], b=bt, block_size=block_size,
                                  k0=k0, k1=k1)
            if rows.numel() == 0:
                outs.append(torch.zeros((k1 - k0, C), dtype=fp.dtype,
                                        device=fp.device))
                continue
            outs.append(_render_block_plain(
                bt, *(t[rows] for t in tab), block_size=block_size, kinds=kinds,
                k0=k0, k1=k1))
    if not outs:
        return torch.zeros((0, C), dtype=fp.dtype, device=fp.device)
    return torch.cat(outs, dim=0)


def render_blocks_tiled_plain(fp, ip, up, gains, codes, *, block_size: int,
                              n_blocks: int, block_offset: int = 0,
                              tile: int = KERNEL_TILE) -> torch.Tensor:
    """render_blocks_plain as the kernel organises it: each tile of each
    block renders only its `tile_live_rows`, in voice order; a tile with
    none is zeros. Dense or per-block compacted tables, job by job."""
    return _per_job(_render_job_tiled_plain, (fp, ip, up, gains, codes),
                    block_size=block_size, n_blocks=n_blocks,
                    block_offset=block_offset, tile=tile)


SEGMENTS = ("attack", "hold", "decay", "sustain", "release")


def segment_voice_samples(fp, ip, *, block_size: int, n_blocks: int,
                          block_offset: int = 0) -> dict:
    """(row, sample) pairs of a render in each envelope segment, summed
    over the jobs: the live voice-samples, the work the kernel cannot skip.
    Counted in closed form on the host from the kernel's thresholds (A,
    A + H, A + H + D, R in the tables' type, against integer offsets t -
    press, t - release), block by block over the block's own rows for
    compacted tables, the blocks starting at the timeline's block
    `block_offset`. Skipped rows count nothing."""
    fp = fp.detach().cpu().numpy()
    ip = ip.detach().cpu().numpy().astype(np.int64)
    counts = dict.fromkeys(SEGMENTS, 0)
    for f_job, i_job in zip(fp, ip):
        for b in range(n_blocks):
            f = f_job[b] if f_job.ndim == 3 else f_job
            i = i_job[b] if i_job.ndim == 3 else i_job
            lo, hi = (b + block_offset) * block_size, (b + block_offset + 1) * block_size
            keep = ~(f[:, 7] > 0.5)
            p, rl = i[keep, 0], i[keep, 1]
            A, H, D, R = (f[keep, j] for j in (1, 2, 3, 4))
            AH = A + H
            ends = [p + np.ceil(A), p + np.ceil(AH), p + np.ceil(AH + D)]
            # pressed segments end at the release; the release tail runs while
            # t - release + 1 < R, i.e. to release - 1 + ceil(R)
            bounds = [p] + [np.minimum(e.astype(np.int64), rl) for e in ends] + [rl]
            for name, a, z in zip(SEGMENTS[:4], bounds[:4], bounds[1:]):
                counts[name] += int(np.maximum(0, np.minimum(z, hi) - np.maximum(a, lo)).sum())
            rz = rl - 1 + np.ceil(R).astype(np.int64)
            ra = np.maximum(rl, p)
            counts["release"] += int(np.maximum(0, np.minimum(rz, hi) - np.maximum(ra, lo)).sum())
    return counts


FP32_PEAK = 67e12   # FLOP/s, H100 SXM outside the tensor cores (NVIDIA data sheet)
FP64_PEAK = 34e12   # FLOP/s, the same in float64 (NVIDIA data sheet)
HBM_PEAK = 3.35e12  # bytes/s, H100 SXM HBM3
# Operations per live voice-sample of csrc/voicebank.cu with LINEAR curves,
# counted from the float source (an FMA counts 2): every segment pays the
# principal reduction's subtraction, z^2, the polynomial's four FMAs and
# product (11) and one FMA per mixdown channel (2C); attack adds the sample
# index, offset, +1, product with 1/A, clamp (2) and envelope product (7),
# decay index, offset, -A, -H, +1, product with 1/max(D,1), clamp,
# 1 + (S-1)x and envelope product (11), release index, offset, +1, product
# with 1/R, clamp, 1 - x, top* and envelope product (9). The float64
# instantiation does the same formulas (a division in place of each
# product with a reciprocal, rint and the sign in place of the integer
# reduction), counted alike.
_SEGMENT_FLOPS = {"attack": 7, "hold": 0, "decay": 11, "sustain": 0, "release": 9}
_INT_ROW_BYTES = 2 * 4 + 2 * 8 + 3 * 4  # ip, up (int64), codes


def kernel_bound(fp, ip, *, block_size: int, n_blocks: int,
                 n_channels: int, block_offset: int = 0) -> dict:
    """The least time the card could take for one launch over every job of
    the tables: the larger of the live voice-samples' operations over the
    tables' type's peak (FP32_PEAK or FP64_PEAK) and the bytes (tables read
    once, output written once) over HBM_PEAK."""
    counts = segment_voice_samples(fp, ip, block_size=block_size,
                                   n_blocks=n_blocks, block_offset=block_offset)
    flops = sum(n * (11 + 2 * n_channels + _SEGMENT_FLOPS[s])
                for s, n in counts.items())
    rows = int(np.prod(fp.shape[:-1]))
    item = fp.element_size()
    n_bytes = (rows * (8 * item + _INT_ROW_BYTES + item * n_channels)
               + fp.shape[0] * n_blocks * block_size * n_channels * item)
    peak = FP64_PEAK if fp.dtype == torch.float64 else FP32_PEAK
    t_ops, t_bytes = flops / peak, n_bytes / HBM_PEAK
    return dict(live_voice_samples=sum(counts.values()), segments=counts,
                flops=flops, bytes=n_bytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def render_blocks(fp, ip, up, gains, codes, *, block_size: int,
                  n_blocks: int, block_offset: int = 0) -> torch.Tensor:
    """Dispatch on the device of the tables: CPU -> render_blocks_plain,
    CUDA -> render_blocks_cuda (which raises on what it does not take)."""
    kind = fp.device.type
    statics = dict(block_size=block_size, n_blocks=n_blocks,
                   block_offset=block_offset)
    if kind == "cpu":
        return render_blocks_plain(fp, ip, up, gains, codes, **statics)
    if kind == "cuda":
        return render_blocks_cuda(fp, ip, up, gains, codes, **statics)
    raise ValueError(f"no voice-bank renderer for device {fp.device}")
