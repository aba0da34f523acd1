"""The voice-bank kernel's least time, counted from a job's voices: a frozen
copy of cpp_audio_tpu_torch.ops.cuda_voicebank.segment_voice_samples and
kernel_bound (their arithmetic as of this benchmark), applied to the voice
fields as the benchmark made them, so the roofline reads the same work
whatever implements the kernel.

Live voice-samples: per voice, the samples of the rendered blocks that fall
in each envelope segment (attack, hold, decay, sustain from the press; the
release from the release sample for ceil(R) samples), with A, H, D, R the
effective envelope lengths in float32 and press and release as int32
samples; a voice whose release is at or before its press renders nothing.
Operations per live voice-sample of the float kernel with LINEAR curves (an
FMA counts 2): 11 in every segment (the phase reduction, z^2, the sine
polynomial), 2 per output channel (the mixdown), and 7 more in the attack,
11 in the decay and 9 in the release. Bytes: every voice's row read once
(8 floats, two int32, two int64 NCO words, three int32 curve codes, a gain
per channel) and the rendered blocks written once. Peaks: 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM (NVIDIA H100 SXM data
sheet).
"""

from __future__ import annotations

import numpy as np

FP32_PEAK = 67e12
HBM_PEAK = 3.35e12
SEGMENTS = ("attack", "hold", "decay", "sustain", "release")
SEGMENT_FLOPS = {"attack": 7, "hold": 0, "decay": 11, "sustain": 0, "release": 9}
INT_ROW_BYTES = 2 * 4 + 2 * 8 + 3 * 4
I32_FAR = 2**31 - 2**24


def segment_voice_samples(voices: dict, n: int, block_size: int) -> dict:
    inc = np.asarray(voices["increment"], np.float64)
    min_change = np.floor(0.5 + 2.5 * 2.0 / np.maximum(np.abs(inc), 1e-9))
    sus = np.asarray(voices["sustain"], np.float64)
    has_decay = sus < 0.999999
    A = np.maximum(np.maximum(voices["attack"], min_change), 1.0).astype(np.float32)
    H = np.maximum(voices["hold"], 0.0).astype(np.float32)
    D = np.where(has_decay, np.maximum(np.maximum(voices["decay"], min_change), 1.0),
                 0.0).astype(np.float32)
    R = np.maximum(np.maximum(voices["release_len"], min_change), 1.0).astype(np.float32)
    press = np.asarray(voices["press"], np.float64)
    release = np.asarray(voices["release"], np.float64)
    keep = ~(release <= press)
    p = np.clip(press, -I32_FAR, I32_FAR).astype(np.int64)[keep]
    rl = np.clip(release, -I32_FAR, I32_FAR).astype(np.int64)[keep]
    A, H, D, R = A[keep], H[keep], D[keep], R[keep]
    AH = (A + H).astype(np.float32)
    ends = [p + np.ceil(A), p + np.ceil(AH), p + np.ceil((AH + D).astype(np.float32))]
    bounds = [p] + [np.minimum(e.astype(np.int64), rl) for e in ends] + [rl]
    rz = rl - 1 + np.ceil(R).astype(np.int64)
    ra = np.maximum(rl, p)
    counts = dict.fromkeys(SEGMENTS, 0)
    n_blocks = (n + block_size - 1) // block_size
    for b in range(n_blocks):
        lo, hi = b * block_size, (b + 1) * block_size
        for name, a, z in zip(SEGMENTS[:4], bounds[:4], bounds[1:]):
            counts[name] += int(np.maximum(0, np.minimum(z, hi) - np.maximum(a, lo)).sum())
        counts["release"] += int(np.maximum(0, np.minimum(rz, hi) - np.maximum(ra, lo)).sum())
    return counts


def kernel_bound(voices: dict, n: int, block_size: int) -> dict:
    """One job's live voice-samples, operations, bytes and least time."""
    C = np.asarray(voices["gains"]).shape[1]
    counts = segment_voice_samples(voices, n, block_size)
    flops = sum(k * (11 + 2 * C + SEGMENT_FLOPS[s]) for s, k in counts.items())
    rows = len(voices["press"])
    n_blocks = (n + block_size - 1) // block_size
    n_bytes = rows * (8 * 4 + INT_ROW_BYTES + 4 * C) + n_blocks * block_size * C * 4
    t_ops, t_bytes = flops / FP32_PEAK, n_bytes / HBM_PEAK
    return dict(live_voice_samples=sum(counts.values()), segments=counts, flops=flops,
                bytes=n_bytes, bound_s=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")
