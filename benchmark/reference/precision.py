"""The two precisions the reference computes in.

"float64": the reference itself.
"lower": its control, the nearest step below the configuration's float32
with TF32 off, for each kind of operation: elementwise arithmetic in
bfloat16 (the step below other float32 work), matrix products of those
bfloat16 values accumulated in float32 (as TF32 or bfloat16 tensor cores
do), and FFTs in float32 on bfloat16 values (torch has no bfloat16 FFT),
their results rounded back to bfloat16. The NCO's phase words stay exact
integers, as in the kernel.
"""

from __future__ import annotations

import torch


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "lower"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.bfloat16

    def fft_in(self, x: torch.Tensor) -> torch.Tensor:
        """x as an FFT takes it."""
        return x.to(self.dtype) if self.name == "float64" else x.to(self.dtype).float()

    def einsum(self, spec: str, *xs: torch.Tensor) -> torch.Tensor:
        if self.name == "float64":
            return torch.einsum(spec, *(x.to(torch.float64) for x in xs))
        out = torch.einsum(spec, *(x.to(self.dtype).float() for x in xs))
        return out.to(self.dtype)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.einsum("ij,jk->ik", a, b)
