"""Device and precision helpers.

The JAX package forces ``precision=HIGHEST`` on every matmul whose values
matter, because the TPU's default float32 matmul is bf16-grade (a missing one
on the final mixdown was a flat -53 dB noise floor,
cpp_audio_tpu/ops/oscillators.py:202-207). The GPU analog is TF32: cuBLAS matmuls and cuDNN convolutions may round float32
inputs to 10 mantissa bits. use_highest_precision() turns that off for the
whole process; it runs when the package is imported.
"""

from __future__ import annotations

import torch


def use_highest_precision() -> None:
    """Full float32 for every matmul and convolution (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dtype_of(name: str) -> torch.dtype:
    """torch dtype for the package's dtype strings ("float32", "float64")."""
    return {"float32": torch.float32, "float64": torch.float64}[name]


use_highest_precision()
