"""Voice-bank block renderer: the hand-written CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel cpp_audio_tpu/ops/pallas_voicebank.py:30
(`_kernel`, launched by `render_blocks_pallas`, :86) and the XLA form of the
same math (cpp_audio_tpu/models/voicebank.py:180 `_render_block`), whose
per-voice eased curve codes the kernel also evaluates. See
csrc/voicebank.cu for the kernel's design and what bounds it.

Array contract (shared by both versions), with an optional leading n_blocks
axis on every table for the per-block compacted layout
(models/voicebank.compact_block_args):
    fp    (.., V, 8) float  [amp, A, H, D, R, S, top, skip]
    ip    (.., V, 2) int32  [press, release]
    up    (.., V, 2) int64  [inc, phase0] uint32 NCO words, in [0, 2^32)
    gains (.., V, C) float
    codes (.., V, 3) int32  attack / decay / release easing codes
Returns (n_blocks * block_size, C).

`render_blocks` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version, CUDA tensors launch the kernel (or raise). There is
no fallback between the two. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.interp import ease_select
from . import fastmath, oscillators

LAUNCHES = 0  # kernel launches (incremented by render_blocks_cuda only)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "voicebank.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    lib.voicebank_render.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, vp]
    return lib


def _as_int32_bits(up: torch.Tensor) -> torch.Tensor:
    """uint32 NCO words (int64 in [0, 2^32)) -> the same bits as int32."""
    return torch.where(up >= 2**31, up - 2**32, up).to(torch.int32)


def render_blocks_cuda(fp, ip, up, gains, codes, *, block_size: int,
                       n_blocks: int) -> torch.Tensor:
    """Launch the CUDA kernel on torch.cuda.current_stream(); float32 only."""
    global LAUNCHES
    tensors = (fp, ip, up, gains, codes)
    if any(t.device.type != "cuda" or t.device != fp.device for t in tensors):
        raise ValueError("render_blocks_cuda: every table must be on one CUDA device")
    if fp.dtype != torch.float32 or gains.dtype != torch.float32:
        raise TypeError("the voice-bank kernel renders float32 only "
                        f"(got fp {fp.dtype}, gains {gains.dtype})")
    if ip.dtype != torch.int32 or codes.dtype != torch.int32:
        raise TypeError("ip and codes must be int32")
    if up.dtype != torch.int64:
        raise TypeError("up must hold the uint32 NCO words as int64")
    compact = fp.dim() == 3
    if fp.dim() not in (2, 3) or fp.shape[-1] != 8:
        raise ValueError(f"fp must be (V, 8) or (n_blocks, V, 8), got {tuple(fp.shape)}")
    lead = fp.shape[:-1]
    C = gains.shape[-1]
    if (ip.shape[:-1] != lead or up.shape[:-1] != lead or codes.shape[:-1] != lead
            or gains.shape[:-1] != lead or ip.shape[-1] != 2 or up.shape[-1] != 2
            or codes.shape[-1] != 3):
        raise ValueError("fp, ip, up, gains and codes disagree on their leading shape")
    if compact and fp.shape[0] < n_blocks:
        raise ValueError(f"{fp.shape[0]} block tables for {n_blocks} blocks")
    if C not in (1, 2):
        raise ValueError(f"the kernel mixes 1 or 2 channels, got {C}")
    if n_blocks > 65535:
        raise ValueError(f"n_blocks {n_blocks} exceeds the grid's y limit")
    fp_c = fp.contiguous()
    ip_c = ip.contiguous()
    up_c = _as_int32_bits(up).contiguous()
    g_c = gains.contiguous()
    codes_c = codes.contiguous()
    n_rows = fp.shape[-2]
    out = torch.empty((n_blocks * block_size, C), dtype=torch.float32,
                      device=fp.device)
    lib = load_library()
    with torch.cuda.device(fp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.voicebank_render(
            fp_c.data_ptr(), ip_c.data_ptr(), up_c.data_ptr(), g_c.data_ptr(),
            codes_c.data_ptr(), out.data_ptr(), n_rows, C,
            n_rows if compact else 0, block_size, n_blocks, stream)
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
                        kinds) -> torch.Tensor:
    """One (V, block_size) tile mixed to (block_size, C): the kernel's math
    in plain PyTorch (uint32 NCO carried in int64, masked to 32 bits —
    torch on the CPU has no uint32 add)."""
    wdt = fp.dtype
    dev = fp.device
    k_i = torch.arange(block_size, dtype=torch.int64, device=dev)[None, :]
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


def render_blocks_plain(fp, ip, up, gains, codes, *, block_size: int,
                        n_blocks: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, block by block (bounded memory:
    one (V, block_size) tile at a time). Any float dtype; any device."""
    kinds = sorted(set(torch.unique(codes).tolist()))
    compact = fp.dim() == 3
    outs = []
    for b in range(n_blocks):
        tab = (fp[b], ip[b], up[b], gains[b], codes[b]) if compact else (
            fp, ip, up, gains, codes)
        outs.append(_render_block_plain(b, *tab, block_size=block_size,
                                        kinds=kinds))
    if not outs:
        return torch.zeros((0, gains.shape[-1]), dtype=fp.dtype, device=fp.device)
    return torch.cat(outs, dim=0)


def render_blocks(fp, ip, up, gains, codes, *, block_size: int,
                  n_blocks: int) -> torch.Tensor:
    """Dispatch on the device of the tables: CPU -> render_blocks_plain,
    CUDA -> render_blocks_cuda (which raises on what it does not take)."""
    kind = fp.device.type
    if kind == "cpu":
        return render_blocks_plain(fp, ip, up, gains, codes,
                                   block_size=block_size, n_blocks=n_blocks)
    if kind == "cuda":
        return render_blocks_cuda(fp, ip, up, gains, codes,
                                  block_size=block_size, n_blocks=n_blocks)
    raise ValueError(f"no voice-bank renderer for device {fp.device}")
