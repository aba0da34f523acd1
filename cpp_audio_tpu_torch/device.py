"""Device and precision helpers.

The JAX package forces ``precision=HIGHEST`` on every matmul whose values
matter, because the TPU's default float32 matmul is bf16-grade (a missing one
on the final mixdown was a flat -53 dB noise floor,
cpp_audio_tpu/ops/oscillators.py:202-207). The GPU analog is TF32: cuBLAS matmuls and cuDNN convolutions may round float32
inputs to 10 mantissa bits. use_highest_precision() turns that off for the
whole process; it runs when the package is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def use_highest_precision() -> None:
    """Full float32 for every matmul and convolution (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dtype_of(name: str) -> torch.dtype:
    """torch dtype for the package's dtype strings ("float32", "float64")."""
    return {"float32": torch.float32, "float64": torch.float64}[name]


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """x as a tensor: a tensor stays on its own device (cast to dtype if
    given); a host scalar becomes a fill on `device` (no synchronising
    host-to-device copy); a host array is copied to `device`."""
    if torch.is_tensor(x):
        return x if dtype is None else x.to(dtype)
    a = np.asarray(x)
    if a.ndim == 0:
        return torch.full((), a.item(), dtype=dtype, device=torch.device(device))
    return torch.as_tensor(a, dtype=dtype, device=torch.device(device))


class _HostArray:
    """A tensor's values as a host array, inside a pickled object's state."""

    def __init__(self, array: np.ndarray):
        self.array = array


class HostPickled:
    """Pickles the object's attributes with every tensor among them written
    as a host array, and restores those onto the object's `device`
    attribute on load: a snapshot taken on a card holds no device storage
    and unpickles without torch.save's device mapping."""

    def __getstate__(self):
        return {k: _HostArray(v.detach().cpu().numpy()) if torch.is_tensor(v) else v
                for k, v in self.__dict__.items()}

    def __setstate__(self, state):
        dev = state.get("device")
        self.__dict__.update(
            {k: torch.from_numpy(v.array).to(dev) if isinstance(v, _HostArray) else v
             for k, v in state.items()})


use_highest_precision()
