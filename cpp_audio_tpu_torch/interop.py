"""Carry state from the JAX package into this one, as numpy.

The parity tests build a workload once (numpy inputs from a seed) and feed
the same state to cpp_audio_tpu and to this port. These functions take the
JAX package's objects duck-typed — anything with the same fields, or array
likes convertible by numpy — so this module imports neither jax nor
cpp_audio_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import voicebank


def voicebank_from_numpy(bank) -> voicebank.VoiceBank:
    """Port VoiceBank with the same field values as `bank` (a
    cpp_audio_tpu VoiceBank or any object with its fields)."""
    kw = {}
    for f in dataclasses.fields(voicebank.VoiceBank):
        v = getattr(bank, f.name)
        kw[f.name] = v if isinstance(v, (bool, int, np.integer)) else np.array(v)
    return voicebank.VoiceBank(**kw)


def bank_args_from_numpy(args, statics, *, device="cuda"):
    """(fp, ip, up, gains, codes) arrays + statics from cpp_audio_tpu's
    prepare_bank_arrays or compact_block_args -> the port's tensors and
    statics (block_size, n_blocks). The uint32 NCO words become int64."""
    fp, ip, up, gains, codes = (np.asarray(a) for a in args)
    dev = torch.device(device)
    tensors = tuple(_tensor(a, dev) for a in (
        fp, ip.astype(np.int32), up.astype(np.uint32).astype(np.int64),
        gains, codes.astype(np.int32)))
    return tensors, dict(block_size=int(statics["block_size"]),
                         n_blocks=int(statics["n_blocks"]))


def slot_table_from_numpy(table, *, device="cuda") -> torch.Tensor:
    """A (frames, slots, fields) slot control table (resynth_bank
    _build_slot_tables, the native table packer, or the JAX device tracker) as a
    tensor of the same dtype on `device`."""
    return _tensor(table, torch.device(device))


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """Copy of an array-like as a tensor on `dev` (the copy makes it
    writable; jax arrays hand numpy read-only views)."""
    return torch.from_numpy(np.array(a, copy=True)).to(dev)
