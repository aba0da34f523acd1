"""Operation, byte and transcendental counts of the device chain's stages.

The port's counterpart of the cost analysis XLA gives the JAX package's
compiled chain step (cpp_audio_tpu/analysis/chain.py:548-591), which
bench.py turns into GFLOP, HBM and utilisation rows. XLA counts its compiled
program, padding included: every one of the render's 128 slots in every
frame. These counts are of the work the chain's function needs on its
inputs, the roofline rule for data-dependent work: the render counts the
live (frame, slot) pairs of the table the step built, the tracker the peaks,
lanes, notes and table rows its data holds. What an implementation
chose (a one-hot group sum, pointer doubling, a stable sort, a transform of
every bin where a few are read) counts as the work it stands for, so the
counts judge any later implementation alike.

Conventions, used by every count below:
  * one arithmetic operation counts 1: add, subtract, multiply, divide,
    square root, min, max, abs, floor, ceil, a comparison; a fusable
    a*b + c counts 2, as ops/cuda_voicebank.kernel_bound counts; a select
    counts 0, a clamp 2, x mod m 4 (a division, a floor and a fused
    multiply-add);
  * a real FFT or inverse real FFT of length N counts 2.5 N log2 N at the
    length the function uses, a complex one 5 N log2 N;
  * a selection or a sort counts one comparison per element it selects from;
  * each sin, cos, exp, exp2, log, log2, log10, log1p, expm1 or pow counts 1
    in `transcendentals` and TRANSCENDENTAL_FLOPS operations, the cost that
    kernel_bound gives the voice bank's sine polynomial;
  * operations in float64 count in flops_f64, the rest in flops_f32;
  * bytes: a stage's inputs read once and its outputs written once, at
    their dtype, whatever the implementation reads again.

Every count function returns {flops_f32, flops_f64, bytes, transcendentals}
as Python ints: counts do not depend on the device.
"""

from __future__ import annotations

import math

import torch

from ..models import resynth_bank as rb
from ..ops import cuda_voicebank as cv
from ..ops.cuda_voicebank import FP32_PEAK, FP64_PEAK, HBM_PEAK
from . import device_tracker as dt
from . import vocoder as vocoder_mod

TRANSCENDENTAL_FLOPS = 11
N_CHANNELS = 2  # the chain's stereo render

STAGES = ("synth", "analysis", "vocoder", "tracker", "render")
# What these counts count, beside XLA's count of a compiled program (the
# JAX package's cost_analysis, bench.py's rows): the work the inputs need.
COUNT_BASIS = "live work"


def count(f32: int = 0, f64: int = 0, trans32: int = 0, trans64: int = 0,
          nbytes: int = 0) -> dict:
    """A count from arithmetic operations and transcendental evaluations in
    each type: each transcendental adds TRANSCENDENTAL_FLOPS operations."""
    T = TRANSCENDENTAL_FLOPS
    return dict(flops_f32=int(f32 + T * trans32), flops_f64=int(f64 + T * trans64),
                bytes=int(nbytes), transcendentals=int(trans32 + trans64))


def _one_type(f64: bool, ops: int, trans: int = 0, nbytes: int = 0) -> dict:
    """A count whose work is all in one type."""
    return (count(f64=ops, trans64=trans, nbytes=nbytes) if f64
            else count(f32=ops, trans32=trans, nbytes=nbytes))


def total(*counts: dict) -> dict:
    return {key: sum(c[key] for c in counts) for key in counts[0]}


def rfft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def cfft_flops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def op_seconds(flops: float, flops_f64: float) -> float:
    """The operations' least time (s): the float32 ones at FP32_PEAK, the
    float64 ones (flops_f64 of flops) at FP64_PEAK."""
    return (flops - flops_f64) / FP32_PEAK + flops_f64 / FP64_PEAK


def bound_ms(flops: float, flops_f64: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for this work: the larger of the
    operations at the peak of their type and the bytes at HBM_PEAK, in ms,
    with what bounds it."""
    t_ops = op_seconds(flops, flops_f64)
    t_bytes = nbytes / HBM_PEAK
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def synth(fp, ip, *, block_size: int, n_blocks: int, n_channels: int) -> dict:
    """The voice-bank kernel over one job's dense (V, 8) / (V, 2) tables:
    kernel_bound's operations (its live voice-samples, each with one sine)
    and bytes. kernel_bound copies the tables to the host to count."""
    fp, ip = cv.one_job((fp, ip))
    b = cv.kernel_bound(fp, ip, block_size=block_size, n_blocks=n_blocks,
                        n_channels=n_channels)
    if fp.dtype == torch.float64:
        return dict(flops_f32=0, flops_f64=b["flops"], bytes=b["bytes"],
                    transcendentals=b["live_voice_samples"])
    return dict(flops_f32=b["flops"], flops_f64=0, bytes=b["bytes"],
                transcendentals=b["live_voice_samples"])


# Per spectrum bin of a peak-picking pass (ops/stft._peaks, _top_k_lanes):
# the dB value (clamp, log10, x10: 2 + 1 transcendental), the local-maximum
# test (3 comparisons), the QIFFT magnitude that is the selection's score
# (denominator 3, |denominator| test 2, delta 3, clamp 2, magnitude 3: 13),
# and the selection (1). Which bins are local maxima is data, so the score
# counts at every bin the selection compares.
_BIN_DB, _BIN_PEAK, _BIN_SCORE, _BIN_SELECT = 2, 3, 13, 1
_SQMAG = 4        # re^2 + im^2 (a multiply and an FMA), times the scale
_PEAK_FREQ = 2    # (bin + delta) * sr / N, at each selected peak
# the float64 QIFFT at a selected peak (ops/stft._qifft_df): three dB values
# (2 + 1 transcendental each), edge tests 2, denominator 3, difference 1,
# |denominator| test 2, delta 2, clamp 2, frequency 2, magnitude 3
_QIFFT_DF, _QIFFT_DF_TRANS = 23, 3


def analysis(n: int, *, n_channels: int, window_size: int, stride: int,
             fft_len: int, k: int, dtype: str, df_mode: str = "hybrid") -> dict:
    """The mono mixdown of the synth's (n, C) output, then the STFT peaks of
    F frames (chain._fused_analyze_vocode(_df)'s analysis): windowing, the
    rfft at fft_len, |X|^2, the per-bin peak test and score, the top-k
    selection and interpolation. dtype "float32" / "float64":
    stft._stft_sqmag and _top_peaks in that type. dtype "df32":
    df_mode "hybrid" (ops/dfft_hybrid.hybrid_peaks_df32: the float32
    selection, then the float64 spectrum and |X|^2 at the 3 bins around
    each selected peak, and the float64 QIFFT there) or "ladder"
    (stft.frames_sqmag_f64 and _top_peaks_df: the float64 spectrum, |X|^2
    and local-maximum test at every bin, the float32 dB score and
    selection, the float64 QIFFT at the selected peaks).
    Bytes: the (n, C) synth output and the window in; the (F, k) peaks and
    the (n,) mixdown, which the vocoder reads, out."""
    F = max(0, (n - window_size) // stride + 1)
    nb = fft_len // 2 + 1
    W = window_size
    mix = n * (n_channels - 1)
    spectrum = F * (W + rfft_flops(fft_len))   # window product, transform
    select = F * nb * (_BIN_DB + _BIN_PEAK + _BIN_SCORE + _BIN_SELECT)
    if dtype != "df32":
        f64 = dtype == "float64"
        item = 8 if f64 else 4
        # the scale (2 / sum(w))^2: W additions, a division and a square
        ops = (mix + W + 2 + spectrum + F * nb * _SQMAG + select
               + F * k * _PEAK_FREQ)
        return _one_type(f64, ops, F * nb,
                   item * (n * n_channels + W + 2 * F * k + n))
    peaks = F * k
    if df_mode == "hybrid":
        c32 = count(f32=mix + spectrum + F * nb * _SQMAG + select,
                    trans32=F * nb)
        c64 = count(f64=spectrum + 3 * peaks * _SQMAG + peaks * _QIFFT_DF,
                    trans64=peaks * _QIFFT_DF_TRANS)
    elif df_mode == "ladder":
        # float32: the eps test of the local-maximum test, dB, score, select
        c32 = count(f32=mix + F * nb * (1 + _BIN_DB + _BIN_SCORE + _BIN_SELECT),
                    trans32=F * nb)
        # float64: the spectrum, |X|^2, two local-maximum comparisons
        c64 = count(f64=spectrum + F * nb * (_SQMAG + 2) + peaks * _QIFFT_DF,
                    trans64=peaks * _QIFFT_DF_TRANS)
    else:
        raise ValueError(f"unknown df analysis mode {df_mode!r}")
    c = total(c32, c64)
    c["bytes"] = 4 * n * n_channels + 8 * (W + 1) + 8 * 2 * F * k + 4 * n
    return c


def vocoder(n: int, *, edges, sample_rate: int, mod_window: int,
            voc_stride: int, car_fft: int, n_mod_frames: int, mod_mode=None,
            mod_shape: str = "gaussian", dtype: str) -> dict:
    """The vocoder of the (n,) mixdown against the carrier and the
    three-way mix (chain._vocode_mix). The modulator
    (vocoder._modulator_band_amps_fast) in its mode: "decimated" is one
    whole-signal rfft, then per band a complex ifft of length m (its plan,
    vocoder.ssb_bands), |z|^2 (3 per sample) and the windowed energy at
    every modulator frame: the w^2 correlation ("gaussian": an FMA per
    tap, ceil(W/d) taps, one more where the decimation d > 1 interpolates)
    or a cumsum (m additions) read at two interpolated positions (7 per
    frame, "rectangular"), and the band's scale (1); "full" is one rfft,
    a complex ifft of the whole length per pair of bands, y^2 per sample
    and band, and the correlation (2 W per frame) or the cumsum (n) and
    its difference (1 per frame). Each band amplitude is a multiply, a
    clamp at 0 and a square root (3). The carrier (vocoder._carrier_vocode),
    per carrier frame: an rfft and an irfft at car_fft, the per-bin gain
    product (2: the band gain is its band's amplitude, a selection), and
    per output sample the crossfade (3) and the mix (5).
    Bytes: the mixdown, the carrier, the carrier band matrix and the
    modulator rows in; the mix out."""
    mode = mod_mode or vocoder_mod.FAST_MODULATOR_MODE
    n_bands = len(edges) - 1
    M = n_mod_frames
    if mode == "decimated":
        n_fft, bands = vocoder_mod.ssb_bands(edges, n, sample_rate)
        ops = rfft_flops(n_fft)
        for k_lo, k_hi, m in bands:
            if k_hi < k_lo:
                continue
            d = n_fft // m
            ops += cfft_flops(m) + 3 * m + M
            if mod_shape == "rectangular":
                ops += m + 7 * M
            else:
                ops += 2 * (-(-mod_window // d) + (d > 1)) * M
    elif mode == "full":
        n_fft = 1 << max(0, (n - 1).bit_length())
        ops = (rfft_flops(n_fft) + -(-n_bands // 2) * cfft_flops(n_fft)
               + n_bands * n)
        ops += n_bands * ((n + M) if mod_shape == "rectangular"
                          else 2 * mod_window * M)
    else:
        raise ValueError(f"unknown modulator mode {mode!r}")
    ops += 3 * M * n_bands
    n_car = max(0, (n - 2 * voc_stride) // voc_stride + 1)
    out_len = n_car * voc_stride
    nbc = car_fft // 2 + 1
    ops += n_car * (2 * rfft_flops(car_fft) + 2 * nbc) + (3 + 5) * out_len
    f64 = dtype == "float64"
    item = 8 if f64 else 4
    return _one_type(f64, ops, 0,
               item * (2 * n + nbc * n_bands + out_len) + 8 * n_car)


# The device tracker (analysis/device_tracker.py), as (operations,
# transcendentals) per element of its data (tracker_data).
# Per valid peak, the frame-local stage (_frame_local): the pitch 69 + 12
# log2(f / 440) (a division and an FMA, 1), the volume 10^(mag / 20) (1, 1),
# the nearby grouping over sorted pitches (the group's start plus the
# distance, a comparison: 2), the peak's part of its group's volume and
# pitch sums (2).
_PEAK = (7, 2)
# Per lane, a row the tracker wrote for a pressed note (tr0 < 0): its
# group's pitch, min_volume test and sort (4); the loudness order: the clamp
# into the ISO table (2), the interpolation (6), volume over loudness, the
# sort and analysis_volume (3), and one comparison per point of the table.
_LANE = (15, 0)
# The frame-parallel tracker (_build_tables_parallel), per lane: matching
# against the previous frame (the window ends, 2, their merge, 2, the
# two-pointer step, 3: 7), the increment 2 f / sr (3, 1), the glide ratio
# log(to / from) (2, 1), the volume filter's alpha 1 - exp(-pi min(|inc|,
# 2/S)) (4, 1), the phase advance inc / lam expm1(ratio) (4, 1), the
# per-frame decay (1 - alpha)^S (1, 1) and its affine term (2), the note
# chain's carried state (the frame offset 1, the phase sum mod 2 with its
# own mod 2: 9, the affine volume map composed 3: 13), the row's start
# phase and volume (7) and tp0 (1); per release-tail row (tr0 >= 0): the
# phase (S inc mod 2, the offset's FMA, mod 2: 11), the decay power (1, 1),
# the volume (4), tp0 and tr0 (3).
_LANE_PARALLEL, _TAIL_PARALLEL = (44, 5), (19, 1)
# The exact frame loop (_track_step), per lane: matching against the
# played set (7), the increment (3, 1), the set's merge (2); per written
# row: the ratio (2, 1), alpha (4, 1), the phase advance (4, 1) and its mod
# 2 (5), the volume decay (4, 1), tp0 and tr0 (3).
_LANE_LOOP, _ROW_LOOP = (12, 1), (22, 4)
# Per note: at its press min_change floor(0.5 + 5 / |inc|) (4), the A, D, R
# floors (6), the draw rank (1), pan and its angle (3) and the angle's cos
# and sin; at its end the envelope at the release (tp 2, attack 4, decay
# 7, segment tests 3: 16) and the tail's end frame (ceil, add, clamp: 3).
_NOTE = (33, 2)
# Per written row of the fidelity table: split_increment's cast back and
# subtraction.
_SPLIT = 2


def tracker(data: dict, *, float64: bool, n_fields: int, in_bytes: int,
            out_bytes: int) -> dict:
    """The device tracker's work (build_tables_device / build_tables_device_df)
    counted from `data` (tracker_data): valid peaks, lanes, notes, written
    rows and the path taken ("frame-parallel", or "frame loop" when the
    violation flag sent the call to the exact frame loop: that loop's work
    is counted, not the parallel attempt before it). A lane is counted where
    it plays: the frame loop's lanes that the voice cap drops are not. The
    optional pitch stages between the grouping and the loudness order
    (shifts, harmonize, autotune: a few operations per lane) are not
    counted; the lanes a harmonize stage adds are. Bytes: in_bytes (the
    peaks, the loudness tables, the draw pools, the autotune arrays) in,
    out_bytes (the table and the dropped count) out."""
    def times(n, per):
        return n * per[0], n * per[1]

    lanes, rows = data["lanes"], data["rows"]
    parts = [times(data["peaks"], _PEAK),
             times(lanes, (_LANE[0] + data["loudness_points"], _LANE[1])),
             times(data["notes"], _NOTE)]
    if data["path"] == "frame loop":
        parts += [times(lanes, _LANE_LOOP), times(rows, _ROW_LOOP)]
    else:
        parts += [times(lanes, _LANE_PARALLEL),
                  times(rows - lanes, _TAIL_PARALLEL)]
    if n_fields == rb.N_FIELDS_DF:
        parts.append((rows * _SPLIT, 0))
    ops, trans = (sum(c) for c in zip(*parts))
    return _one_type(float64, ops, trans, in_bytes + out_bytes)


def tracker_data(freq, mag, table, *, path: str, stride: int,
                 render_dtype: str, loudness_points: int) -> dict:
    """The data-dependent counts of one chain run, from its (F, k) peaks and
    the slot table its tracker built, read to the host in one
    synchronisation: valid peaks (device_tracker.valid_peaks), lanes (rows
    of a pressed note: tp0 >= 0, tr0 < 0), notes (rows at their press: tp0
    = 0), written rows (tp0 >= 0; empty slots hold -1e9) and the render's
    live pairs (live_pairs)."""
    tp0, tr0 = table[..., rb._F_TP0], table[..., rb._F_TR0]
    written = tp0 >= 0
    live = live_pairs(table, stride=stride, dtype=render_dtype)
    vals = torch.stack([dt.valid_peaks(freq, mag).sum(),
                        (written & (tr0 < 0)).sum(), (tp0 == 0).sum(),
                        written.sum(), live.sum()]).tolist()
    return dict(zip(("peaks", "lanes", "notes", "rows", "live_pairs"),
                    (int(v) for v in vals)),
                path=path, loudness_points=int(loudness_points))


def live_pairs(table: torch.Tensor, *, stride: int, dtype: str) -> torch.Tensor:
    """(..., F, P) bool: the (frame, slot) pairs of a slot table to which
    models/resynth_bank._render_slots gives a nonzero signal somewhere in
    the frame (resynth_bank.live_slots over the whole frame): a pair
    counted dead renders exactly zero."""
    return rb.live_slots(table, stride=stride, dtype=dtype)


# The render (models/resynth_bank._render_slots) per live pair: lam (1),
# the flat-glide test (2), inc / lam (1), log1p(-alpha) (1, 1), vb - vtgt
# (1), the envelope's A + H, A + H + D, max(D, 1), sus - 1 (4), the
# midpoint increment inc exp(lam S / 2) (2, 1), the aliasing gain (|inc|,
# the zero test, the floor, 1 / x, - 1, / 3, clamp: 8).
_PAIR, _PAIR_TRANS = 20, 2
# per sample of a live pair: the phase, the glide's form (lam (k+1), expm1,
# the product, + phb, mod 2: 7, 1), the volume (k+1) log1p(-alpha) -> exp
# -> FMA (3, 1), tp and trm (2), the attack (4), the decay (7), the
# segment tests (3), the release (6), the before-press and release tests
# (2), vol x env x gain x sin (3, 1: the sine), the stereo mix (2 FMAs: 4)
_SAMPLE, _SAMPLE_TRANS = 41, 3
# the fidelity table (17 fields) carries the phase in float64: the
# increment's two parts added (1) and lam, the flat-glide test and inc /
# lam (4) per pair, the phase (7, 1) per sample; the rest stays in the
# render's dtype (its lam for the midpoint increment, 1)
_PAIR_DF64, _SAMPLE_DF64, _SAMPLE_DF64_TRANS = 5, 7, 1


def render_per_pair(*, stride: int, n_fields: int, dtype: str) -> dict:
    """The render's count for one live pair: per-pair terms once, per-sample
    terms `stride` times (bytes 0: they are the table's and the output's,
    counted by `render`)."""
    S = stride
    f64 = dtype == "float64"
    if n_fields == rb.N_FIELDS or f64:
        extra = 1 if n_fields == rb.N_FIELDS_DF else 0   # the increment's sum
        return _one_type(f64, _PAIR + extra + S * _SAMPLE,
                   _PAIR_TRANS + S * _SAMPLE_TRANS)
    return total(
        count(f64=_PAIR_DF64 + S * _SAMPLE_DF64, trans64=S * _SAMPLE_DF64_TRANS),
        # all but the flat-glide test and inc / lam, which run in float64
        count(f32=_PAIR - 3 + S * (_SAMPLE - _SAMPLE_DF64),
              trans32=_PAIR_TRANS + S * (_SAMPLE_TRANS - _SAMPLE_DF64_TRANS)))


def render(n_live: int, *, stride: int, total_frames: int, n_slots: int,
           n_fields: int, table_float64: bool, dtype: str) -> dict:
    """The render of a (total_frames, n_slots, n_fields) table with n_live
    live pairs to (total_frames, stride, 2) in `dtype`. Bytes: the table in,
    the framed stereo out."""
    per = render_per_pair(stride=stride, n_fields=n_fields, dtype=dtype)
    c = {key: n_live * v for key, v in per.items()}
    c["bytes"] = (total_frames * n_slots * n_fields * (8 if table_float64 else 4)
                  + total_frames * stride * N_CHANNELS
                  * (8 if dtype == "float64" else 4))
    return c


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def step_cost(stages: dict, *, in_bytes: int, out_bytes: int,
              data: dict) -> dict:
    """A chain step's cost in bench.py's keys: "flops" (every operation,
    float64 ones included), "flops_f64" (those in float64), "bytes
    accessed" (the step's inputs read once and its outputs written once:
    not the stages' sum, since a fused step need not write the stages'
    intermediates) and "transcendentals", as floats; each stage's parts
    under "<stage> flops", "<stage> flops_f64", "<stage> bytes accessed"
    and "<stage> transcendentals"; the data behind the data-dependent
    counts (tracker_data) as "tracker path", "tracker peaks", "tracker
    lanes", "tracker notes", "tracker rows" and "render live pairs"; and
    "count basis", COUNT_BASIS."""
    out = {}
    for name in STAGES:
        c = stages[name]
        out[f"{name} flops"] = float(c["flops_f32"] + c["flops_f64"])
        out[f"{name} flops_f64"] = float(c["flops_f64"])
        out[f"{name} bytes accessed"] = float(c["bytes"])
        out[f"{name} transcendentals"] = float(c["transcendentals"])
    for key in ("flops", "flops_f64", "transcendentals"):
        out[key] = sum(out[f"{name} {key}"] for name in STAGES)
    out["bytes accessed"] = float(in_bytes + out_bytes)
    out["tracker path"] = data["path"]
    for key in ("peaks", "lanes", "notes", "rows"):
        out[f"tracker {key}"] = float(data[key])
    out["render live pairs"] = float(data["live_pairs"])
    out["count basis"] = COUNT_BASIS
    return out
