"""cpp_audio_tpu_torch — the PyTorch / CUDA port of cpp_audio_tpu.

The JAX package (cpp_audio_tpu) is the reference; this package computes the
same functions on torch tensors and runs its one hand-written kernel (the
voice-bank renderer, csrc/voicebank.cu) on an NVIDIA Hopper card. It keeps the
JAX package's layout (core/ ops/ models/ analysis/ utils/) and module names,
so every function has a counterpart of the same name there.

Conventions:
  - every entry point takes an explicit ``device`` (default ``"cuda"``);
    nothing falls back to the CPU when no card is present;
  - host-side control logic (note tracking, slot packing, draw pools) stays
    numpy / the repo's C++ library (native/), as in the JAX package;
  - this package imports neither jax nor cpp_audio_tpu.

Importing it turns TF32 off (device.use_highest_precision), the GPU form of
the JAX package's precision=HIGHEST rule.
"""

from . import device  # noqa: F401  (sets the float32 matmul precision)

__version__ = "0.1.0"
