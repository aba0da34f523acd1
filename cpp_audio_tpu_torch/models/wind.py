"""WIND mode: pink-noise-driven filter textures (rain, wind, bubbles...).

Reference composition (include/soundengine.h:196-222 MixOf<WIND> +
gen.voice.h:955-985 wiring):
    Mix[ LowPass<pink, N>,
         AsymBandPass<pink, N>   (center + width driven by slow |pink| noise),
         AsymBandReject<pink, N>,
         loudness-adjusted sine  (freq = long-term noise walk * short wobble) ]
Controls:
  - long-term control: |pink| sampled every n_slow_long samples, interpolated
    (SlowIter/AbsIter/Ctrl, audioelement.h:2823-3029), mapped exponentially
    into the angle-increment range of the center octaves (SoundEngineFreqCtrl,
    soundengine.h:48-104; octave -> 10*2^octave Hz, gen.voice.h:855-861)
  - short-term wobble: inc *= 2^(noise*amp), noise rate inversely
    proportional to the long-term frequency (ShortTermNoiseAdderCtrl,
    soundengine.h:107-173)
  - band width: 2^lerp(width_range, |noise|), gain-compensated
    (BandAlgo_::step, audioelement.h:2288-2302)

Split: the control walks are EXACT reference-iterator state machines
(WindFreqIter's 3x-fast ascents — the gust asymmetry — SlowIter's eased
major steps and integer rate adaptation; pinned against the compiled
reference by tests/test_reference_oracle.py) run on the host in C++
(native/windwalk.cpp, numpy/python fallbacks here), or, with
device_controls, as per-segment tables built and expanded on the device
from each walk's start; the device
renders from the resulting control arrays — the noise source is one gather,
and the order-N one-pole cascades with per-sample cutoffs are chained
filters.linear_recurrence scans (the reference's hardest preset is order
129 'Bubbles').

The reference leaves the LowPass member's cutoff at its filter default (no
setFilterAngleIncrements call reaches it; soundengine.h:217 declares the
member, gen.voice.h wires only the band algos). By default this renderer
instead tracks the main control frequency — a documented divergence that
makes the member musically useful. For parity work `lowpass_mode` selects
the plausible reference defaults instead: the `Filter` type lives in the
absent cpp.algorithms sibling, so its never-initialized coefficient is
either 0 (member contributes silence -> "mute") or passes the signal
unfiltered ("bypass"); both are provided. NB every factory preset leaves
PINK_NOISE_LP_GAIN at its make_common default of 0 (gen.voice.h:625-699),
so the choice is inaudible for all 27 programs either way — it only
matters for user programs that raise the LP gain.

Port of cpp_audio_tpu/models/wind.py. The walks and their segment tables
are host copies. Every stage of the cascades is one linear_recurrence call
over a stack of rows: the four cascades that start from the noise source
(the band-pass low-pass, the band-reject low-pass and high-pass, the main
low-pass) and every batch row run as rows of one tensor, a high-pass row
being y - lp(y); then the band-pass's high-pass runs its own `order`
stages. That is 2 x order calls per render (the JAX package runs 5 x order
cascade stages). A batch is the leading axis of every control array.
Renders return tensors on `device`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import dtype_of
from ..ops import oscillators
from ..ops.filters import chunked_affine_scan, linear_recurrence
from ..ops.noise import get_noise_tables
from ..utils.interp import _CURVES, Itp, ease_np
from .soundengine import _lut_dev, _pan_gains
from .voice_presets import Mode, VoiceProgram, effective_engine_config


def _long_walk_np(table, start: int, n_steps: int, itp_code: int,
                  T: int, prev0: float | None = None) -> np.ndarray:
    """Exact Ctrl<WindFreqIter<SlowIter<AbsIter<noise>>>> walk, segment-
    vectorized (pure-numpy fallback for native/windwalk.cpp; pinned against
    the reference's compiled iterators by tests/test_reference_oracle.py).

    Per table segment [prev -> cur] the walk advances 3 sub-steps per sample
    when ascending and 1 when descending (WindFreqIter SCALE_UP,
    audioelement.h:2934-2974), stopping early at the major-step boundary
    where the read lands on the new segment at x=0."""
    tab = np.abs(np.asarray(table, np.float32))
    m = len(tab)
    n_steps = max(1, int(n_steps))
    out = np.empty(T, np.float32)
    k = 0
    if prev0 is None:
        pos = int(start) % m
        prev = tab[pos]
        pos = (pos + 1) % m
    else:
        # the reference's real spec-start state: prev from a DISCARDED
        # position draw, iterator AT start, unadvanced (playNextSpec's
        # forgetPastSignals-then-set_sample_rate double init)
        pos = int(start) % m
        prev = np.float32(prev0)
    while k < T:
        cur = tab[pos]
        rate = 1 if prev > cur else 3
        seg = -(-n_steps // rate)  # ceil: samples until the major fires
        take = min(seg, T - k)
        j = np.arange(1, take + 1, dtype=np.float64)
        x = np.minimum(j * rate, n_steps) / n_steps
        v = prev + (cur - prev) * ease_np(Itp(itp_code), x)
        if take == seg:
            v[-1] = cur  # the major-firing sample reads the new segment at 0
        out[k:k + take] = v
        k += take
        prev = cur
        pos = (pos + 1) % m
    return out


def _short_walk_np(table, start: int, rate: float,
                   inc_long: np.ndarray,
                   prev0: float | None = None) -> np.ndarray:
    """Exact short-term wobble (ShortTermNoiseAdderCtrl's SlowIter retuned
    per sample, soundengine.h:134-143 + the integer adapt rule,
    audioelement.h:2863-2880). Per-sample data-dependent integer recurrence
    — python-loop fallback for native/windwalk.cpp (a few seconds per
    minute of audio; the native path is ~ms)."""
    f32 = np.float32
    tab = np.asarray(table, f32)
    m = len(tab)
    pos = int(start) % m
    if prev0 is None:
        prev = tab[pos]
        pos = (pos + 1) % m
    else:
        prev = f32(prev0)  # see _long_walk_np
    n_steps = -1
    slow_it = 0
    rate32 = f32(rate)
    out = np.empty(len(inc_long), f32)
    # all arithmetic in float32, matching the reference's float math
    # (soundengine.h:139, audioelement.h:2863-2930) and the native path
    for k, inc in enumerate(np.asarray(inc_long, f32)):
        # int32 cast like the reference's uint_steps (overflow clamped —
        # the reference's float->int32 overflow is UB, so both this and
        # native/windwalk.cpp clamp instead for absurd rate/inc ratios)
        n = 1 + min(int(rate32 / inc), 2**31 - 2)
        if n != n_steps:
            if slow_it:
                slow_it = int(f32(f32(slow_it + 0.5) / f32(n_steps)) * f32(n))
                if slow_it == n:
                    slow_it = 0
                    prev = tab[pos]
                    pos = (pos + 1) % m
            n_steps = n
        slow_it += 1
        if slow_it >= n_steps:
            slow_it = 0
            prev = tab[pos]
            pos = (pos + 1) % m
        cur = tab[pos]
        x = min(f32(1.0), f32(f32(slow_it) / f32(n_steps)))
        out[k] = prev + (cur - prev) * x
    return out


def wind_long_walk(table, start: int, n_steps: int, itp_code: int,
                   T: int, prev0: float | None = None) -> np.ndarray:
    from .. import native as nat

    if nat.available():
        return nat.wind_long_walk(table, start, max(1, int(n_steps)),
                                  int(itp_code), T, prev0)
    return _long_walk_np(table, start, n_steps, itp_code, T, prev0)


def wind_short_walk(table, start: int, rate: float, inc_long,
                    prev0: float | None = None) -> np.ndarray:
    from .. import native as nat

    if nat.available():
        return nat.wind_short_walk(table, start, rate, inc_long, prev0)
    return _short_walk_np(table, start, rate, inc_long, prev0)



def _cascade_dynamic(x, alpha, order: int, highpass):
    """`order` sections of one-pole cascades with per-sample alphas, all
    rows at once: row r of x (rows, ..., T) runs low-pass sections
    (highpass[r] false) or high-pass ones (y - lp(y)) at its own alpha, one
    linear_recurrence call per section."""
    one_minus = 1.0 - alpha
    hp = torch.as_tensor(highpass, device=x.device).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    for _ in range(order):
        lp = linear_recurrence(one_minus, alpha * x)
        x = torch.where(hp, x - lp, lp)
    return x


@functools.lru_cache(maxsize=8)
def _pink_dev(sr: int, dtype: str, device: str):
    """Device-resident pink table, cached per (sample_rate, dtype, device):
    the table is a render constant (~MBs)."""
    return torch.as_tensor(np.asarray(get_noise_tables(sr)["pink"]),
                           dtype=dtype_of(dtype), device=torch.device(device))


def wind_long_walk_segments(table, start: int, n_steps: int, T: int,
                            prev0: float | None = None):
    """Segment decomposition of the long walk for DEVICE expansion: the
    same iterator trace as _long_walk_np, but emitting one row per table
    segment instead of T samples. Returns (starts, prevs, curs, rates)
    numpy arrays (int32/f32/f32/f32); segment i covers samples
    [starts[i], starts[i+1]) (open-ended at T) with
        v(j) = prev + (cur - prev) * ease(min(j*rate, n)/n),  j = 1..len
    and the segment-completing sample reading exactly `cur`
    (audioelement.h:2934-2974 WindFreqIter; kills the audio-rate
    host->device control transfers, docs/PERF_NOTES.md backlog)."""
    tab = np.abs(np.asarray(table, np.float32))
    m = len(tab)
    n_steps = max(1, int(n_steps))
    # fully vectorized (short-step programs produce ~1e5 segments per
    # minute — a python per-segment loop costs seconds): the read sequence
    # is just consecutive table entries, lengths follow from the
    # ascend/descend rate, starts are the exclusive cumsum
    lmin = -(-n_steps // 3)
    n_max = -(-T // lmin) + 2
    pos0 = int(start) % m
    if prev0 is None:
        first_prev = tab[pos0]
        pos0 = (pos0 + 1) % m
    else:
        first_prev = np.float32(prev0)
    idx = (pos0 + np.arange(n_max, dtype=np.int64)) % m
    curs = tab[idx]
    prevs = np.empty(n_max, np.float32)
    prevs[0] = first_prev
    prevs[1:] = curs[:-1]
    rates = np.where(prevs > curs, 1, 3).astype(np.int64)
    lens = -(-n_steps // rates)
    starts = np.zeros(n_max, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    keep = starts < T
    return (starts[keep].astype(np.int32), prevs[keep], curs[keep],
            rates[keep].astype(np.float32))


def _walk_segments_dev(pink_abs, pos0, prev0, *, n_steps: int, T: int):
    """wind_long_walk_segments on the device, for W walks at once.

    pink_abs: (m,) float32 |pink table|; pos0: (W,) int64 position of each
    walk's first read; prev0: (W,) float32 the value it starts from (the
    host function's prev0 path). Returns (starts, prevs, curs, rates), each
    (W, n_max): the host function's segments (the same table reads,
    ascend/descend rates and exclusive-cumsum starts) followed by the
    segments that start at or past T, which the expansion never reads."""
    dev = pink_abs.device
    n_steps = max(1, int(n_steps))
    lmin = -(-n_steps // 3)
    n_max = -(-T // lmin) + 2
    idx = torch.remainder(pos0[:, None] + torch.arange(n_max, device=dev), pink_abs.shape[0])
    curs = pink_abs[idx]
    prevs = torch.cat([prev0[:, None], curs[:, :-1]], dim=1)
    rates = torch.where(prevs > curs, 1, 3)
    lens = -torch.div(-n_steps, rates, rounding_mode="floor")  # samples until the major fires
    starts = oscillators.chunked_cumsum(lens) - lens
    return starts, prevs, curs, rates.to(torch.float32)


def _expand_long_walk_dev(starts, prevs, curs, rates, *, n_steps: int,
                          itp_code: int, T: int):
    """(..., n_seg) segment tables -> (..., T) f32 walk values, entirely on
    the device.

    Each sample's segment is the count of segment starts at or before it,
    less one (the starts flagged in a (..., T) mask and summed by
    oscillators.chunked_cumsum; starts at or past T are dropped), and its
    segment's params are gathered; then the eased interpolation is
    evaluated elementwise. Samples before the first start are 0. f32; the
    curves match utils/interp ease curves (ease(1) is forced to `cur`
    exactly, as the host walk does), so this equals the host walk bit for
    bit."""
    lead = starts.shape[:-1]
    dev = starts.device
    starts = starts.to(torch.int64)
    flag = torch.zeros(lead + (T + 1,), dtype=torch.int32, device=dev)
    flag.scatter_(-1, torch.clamp(starts, 0, T), 1)
    seg = oscillators.chunked_cumsum(flag[..., :T]).to(torch.int64) - 1
    at = torch.clamp(seg, min=0)
    prev_t, cur_t, rate_t = (torch.gather(v.to(torch.float32), -1, at)
                             for v in (prevs, curs, rates))
    t = torch.arange(T, device=dev)
    j = (t - torch.gather(starts, -1, at) + 1).to(torch.float32)
    # a tensor divisor: CUDA divides by a host scalar as a product with its
    # reciprocal, an ulp off the host walk's quotient
    n = torch.tensor(float(n_steps), dtype=torch.float32, device=dev)
    x = torch.minimum(j * rate_t, n) / n
    e = _CURVES[Itp(itp_code)](x)
    v = torch.where(x >= 1.0, cur_t, prev_t + (cur_t - prev_t) * e)
    return torch.where(seg >= 0, v, torch.zeros((), dtype=v.dtype, device=dev))


def _device_controls(pink_abs, pos0, prev0, logmap, *, n_steps: int, itp_main: int,
                     T: int):
    """The five control arrays (inc_main, c1, c2, w1, w2), each (B, T),
    from their walks' starts: pos0 and prev0 (B, 5), in the order main, c1,
    c2, w1, w2. Only valid when the short-term wobble amplitude is 0 (then
    inc_main is the exp-mapped long walk).

    logmap = (log_lo, log_hi, inv_f) of the exponential frequency map
    (SoundEngineFreqCtrl, soundengine.h:48-104), float32; its exp is taken
    in float64 and rounded to float32, so the card and the CPU agree."""
    log_lo, log_hi, inv_f = (logmap[i] for i in range(3))

    def exp_map(walk):
        arg = log_lo + (log_hi - log_lo) * (walk * inv_f)
        return torch.exp(arg.to(torch.float64)).to(torch.float32)

    def walk(w, code):
        segs = _walk_segments_dev(pink_abs, pos0[:, w], prev0[:, w], n_steps=n_steps, T=T)
        return _expand_long_walk_dev(*segs, n_steps=n_steps, itp_code=code, T=T)

    lin = int(Itp.LINEAR)
    return (exp_map(walk(0, itp_main)), exp_map(walk(1, lin)), exp_map(walk(2, lin)),
            walk(3, lin), walk(4, lin))


def _wind_mix(pink, src_offset: int, inc_main, c1, c2, w1, w2, params, lut,
              lut_lo, lut_step, gains, *, order: int,
              lowpass_mode: str = "control"):
    """The WIND mix from its control arrays (B, T): inc_main (main control
    increments incl. the short-term wobble), c1/c2 (band center
    increments), w1/w2 (raw width walk values); params (B, 8), gains
    (B, C) -> (B, T, C)."""
    B, T = inc_main.shape
    dev, wdt = inc_main.device, lut.dtype
    t = torch.arange(T, dtype=wdt, device=dev)
    (w_min, w_max, lp_gain, bp_gain, br_gain, sine_gain,
     xfade, velocity) = (params[:, i, None] for i in range(8))

    # sine member with equal-loudness volume
    phase = oscillators.wrapped_cumsum(inc_main)
    idx = torch.clamp((torch.log2(torch.clamp(inc_main, min=1e-9)) - lut_lo) / lut_step,
                      0.0, lut.shape[0] - 1.001)
    i0 = idx.to(torch.int64)
    fr = idx - i0
    lvol = lut[i0] * (1.0 - fr) + lut[i0 + 1] * fr
    # the reference low-passes the loudness target with time constant = the
    # current period (BaseVolumeAdjusted::step, audioelement.h:1195-1216),
    # initialized AT the first target — same law as models/soundengine.py
    a_sine = 1.0 - torch.exp(-math.pi * inc_main)
    a_sine = torch.where(t == 0.0, 1.0, a_sine)
    lvol = chunked_affine_scan(1.0 - a_sine, a_sine * lvol)
    y_sine = lvol * oscillators.sine(phase) * oscillators.freq_aliasing_multiplicator(inc_main)

    # source noise (BufferIter with randomized start, sound.h:181-233):
    # table[(off + t) mod n], one gather shared by every batch row
    n = pink.shape[0]
    src = pink[(src_offset % n + torch.arange(T, device=dev)) % n]

    def band_alphas(center, wn):
        # width factor 2^lerp(range, |walk|) (BandAlgo_::step,
        # audioelement.h:2288-2302)
        wf = torch.exp2(w_min + (w_max - w_min) * torch.clamp(torch.abs(wn), 0.0, 1.0))
        low = center / wf
        high = center * wf
        return 1.0 - torch.exp(-math.pi * low), 1.0 - torch.exp(-math.pi * high)

    # NO band-pass gain compensation: BandPassAlgo_::setCompensation
    # computes expt<ORDER>(1 + 1/wf^2) with ORDER = VariableOrder for the
    # wind band filters (audioelement.h:2131), and VariableOrder must be 0
    # for that instantiation to compile, so the reference's variable-order
    # compensation is expt<0> = 1 (pinned by the windrender oracle).
    a_low1, a_high1 = band_alphas(c1, w1)
    a_low2, a_high2 = band_alphas(c2, w2)
    # the members that start from the source: band-pass LP at a_high, then
    # band-reject = LP at low + HP at high (audioelement.h:2186-2241), and
    # the main LP member
    alphas = [a_high1, a_low2, a_high2]
    highpass = [False, False, True]
    if lowpass_mode == "control":  # documented divergence (module docstring)
        alphas.append(1.0 - torch.exp(-math.pi * inc_main))
        highpass.append(False)
    alpha = torch.stack(alphas)
    y = _cascade_dynamic(src.expand(alpha.shape), alpha, order, highpass)
    del alpha, alphas
    y_bp = _cascade_dynamic(y[:1], a_low1[None], order, [True])[0]
    y_br = y[1] + y[2]
    if lowpass_mode == "control":
        y_lp = y[3]
    elif lowpass_mode == "bypass":  # reference default if Filter init passes
        y_lp = src
    else:  # "mute": reference default if the uninitialized coefficient is 0
        y_lp = torch.zeros_like(src)

    mix = lp_gain * y_lp + bp_gain * y_bp + br_gain * y_br + sine_gain * y_sine
    env = torch.clamp((t + 1.0) / torch.clamp(xfade, min=1.0), 0.0, 1.0)
    sig = velocity * env * mix
    return sig[:, :, None] * gains[:, None, :]


def _walk_start(rng, m: int):
    """BufferIter's draws: uniform_real over [0, size-1) -> int, twice (the
    discarded position giving prev, then the iterator's start)."""
    a = int(rng.integers(0, m - 1))
    b = int(rng.integers(0, m - 1))
    return a, b


def _seg_walk_starts(rng, pink32):
    """The device-controls path's walk starts, drawn in the host-walk
    path's rng order (main, wobble, c1, w1, c2, w2; the wobble's draws are
    consumed though amp == 0 makes inc_main == inc_long exactly):
    (pos0, prev0) lists for main, c1, c2, w1, w2, as wind_long_walk_segments
    takes them (start mod the table, |table[discarded draw]|)."""
    m = len(pink32)
    main, _wobble, c1, w1, c2, w2 = (_walk_start(rng, m) for _ in range(6))
    walks = (main, c1, c2, w1, w2)
    return [b % m for _a, b in walks], [float(np.abs(pink32[a])) for a, _b in walks]


def _wind_setup(p: VoiceProgram, sample_rate: int):
    """The program's engine-facing values: (eff, pink32, logmap)."""
    # all engine-facing values go through the reference's f32 program
    # storage + setupAudioElement conversions (voice_presets.
    # effective_engine_config, pinned against compiled gen.voice.h):
    # center octaves -> f32 pow2 freqs -> 2f/sr increments, slow-step
    # counts sr*2.268^stored truncated by the int parameters, widths/gains
    # f32-roundtripped, envelope charac time rounded
    eff = effective_engine_config(p, sample_rate)
    tables = get_noise_tables(sample_rate)
    pink32 = np.asarray(tables["pink"], np.float32)
    inv_approx = 1.0 / (2.0 * tables["pink_abs_mean"])
    inc_lo, inc_hi = eff["center_inc_range"]
    logmap = np.array([np.float32(np.log(inc_lo)), np.float32(np.log(inc_hi)),
                       np.float32(inv_approx)], np.float32)
    return eff, pink32, logmap


def _params(eff, velocity: float, p: VoiceProgram) -> list:
    return [eff["width_range"][0], eff["width_range"][1],
            eff["gains"][0], eff["gains"][1], eff["gains"][2], eff["gains"][3],
            eff["env_charac_time"], velocity * p.gain]


def render_program(program: VoiceProgram, n_samples: int, sample_rate: int = 44100,
                   *, seed: int = 1, velocity: float = 1.0, pan: float | None = None,
                   n_channels: int = 2, dtype: str = "float32",
                   lowpass_mode: str = "control",
                   device_controls: bool = False, device="cuda") -> torch.Tensor:
    """Render a WIND program to an (n_samples, C) tensor on `device`.

    lowpass_mode: "control" (default; LP member tracks the main control
    frequency), "mute" or "bypass" (the two plausible reference defaults —
    see module docstring).

    device_controls: build the control walks' segment tables and expand
    them ON the device from each walk's start (two numbers a walk) instead
    of copying 5 audio-rate arrays (~50 MB per 60 s render) to it. Requires
    a zero short-wobble amplitude (all factory WIND programs with
    spec_short_amp == 0; others fall back to host walks). The device
    expansion equals the host walk's f32 outputs bit for bit (the same
    segments, and the eased interpolation evaluates the same f32 curve
    expressions as the host); the frequency map's exp differs from the
    host walks' numpy float32 exp by an ulp here and there."""
    p = program
    assert p.mode is Mode.WIND
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    eff, pink32, logmap = _wind_setup(p, sample_rate)
    n_slow_long = eff["n_slow_steps_long"]
    m = len(pink32)
    dt = dtype_of(dtype)

    # host-exact control walks (the reference's asymmetric noise iterators;
    # see wind_long_walk/wind_short_walk): main control with short-term
    # wobble, band centers (LINEAR interp — gen.voice.h:361-388 never sets
    # theirs; only the main control gets the program interpolation via
    # create_wind, soundengine.h:720-736), raw width walks.
    # Each walk starts from the reference's spec-start state (pinned by the
    # windrender oracle): prev from one discarded uniform position draw,
    # the iterator AT a second draw, unadvanced — playNextSpec runs
    # forgetPastSignals and then set_sample_rate, whose
    # BufferIter::set_sample_rate re-draws the position (sound.h:185-190).
    def long_walk(itp_code):
        a, b = _walk_start(rng, m)
        return wind_long_walk(pink32, b, n_slow_long, itp_code, n_samples,
                              prev0=float(np.abs(pink32[a])))

    use_seg = device_controls and float(eff["spec_short_amp"]) == 0.0
    if use_seg:
        pos0, prev0 = _seg_walk_starts(rng, pink32)
    else:
        log_lo, log_hi, inv_f = logmap

        def exp_map(walk):
            return np.exp(log_lo + (log_hi - log_lo) * (walk * inv_f), dtype=np.float32)

        inc_long = exp_map(long_walk(int(p.interpolation)))
        a, b = _walk_start(rng, m)
        wobble = wind_short_walk(pink32, b, eff["spec_short_rate"], inc_long,
                                 prev0=float(pink32[a]))
        inc_main = inc_long * np.exp2(wobble * np.float32(eff["spec_short_amp"]))
        lin = int(Itp.LINEAR)
        c1 = exp_map(long_walk(lin))
        w1 = long_walk(lin)
        c2 = exp_map(long_walk(lin))
        w2 = long_walk(lin)
    # the noise SOURCES are soundBufferWrapperAlgos, all reset to the same
    # DETERMINISTIC mid-table index by setStartAngle(0)
    # (audioelement.h:1545-1556): first read at int(size*0.5 + 0.5)
    src_offset = int(m * 0.5 + 0.5)

    if pan is None:
        pan = float(rng.uniform(-1.0, 1.0))
    gains = torch.as_tensor(_pan_gains(pan, n_channels)[None, :], dtype=dt, device=dev)
    params = torch.as_tensor([_params(eff, velocity, p)], dtype=dt, device=dev)
    lut, lut_lo, lut_step = _lut_dev(
        int(p.loudness_ref_freq_index), float(p.loudness_compensation),
        float(p.loudness_level), sample_rate, dtype, str(dev))
    if use_seg:
        ctl = _device_controls(
            _pink_dev(sample_rate, "float32", str(dev)).abs(),
            torch.as_tensor([pos0], device=dev), torch.as_tensor([prev0], dtype=torch.float32,
                                                                  device=dev),
            torch.as_tensor(logmap, device=dev), n_steps=n_slow_long,
            itp_main=int(p.interpolation), T=n_samples)
        ctl = [c.to(dt) for c in ctl]
    else:
        ctl = [torch.as_tensor(np.asarray(c)[None], dtype=dt, device=dev)
               for c in (inc_main, c1, c2, w1, w2)]
    out = _wind_mix(_pink_dev(sample_rate, dtype, str(dev)), src_offset, *ctl, params,
                    lut, lut_lo, lut_step, gains, order=int(p.filter_order),
                    lowpass_mode=lowpass_mode)
    return out[0]


# ---- batched multi-instance serving ----

def render_program_batch(program: VoiceProgram, n_samples: int,
                         sample_rate: int = 44100, *, seeds,
                         velocity: float = 1.0, pans=None,
                         n_channels: int = 2, dtype: str = "float32",
                         lowpass_mode: str = "control",
                         device_out: bool = True, device="cuda"):
    """Serve B independent WIND renders (same program, different seeds) in
    one batched render -> (B, n_samples, C): a tensor on `device`, or with
    device_out=False one host copy of it (numpy).

    Per-instance host work is only the walks' starts and the pan (the
    device-controls path); requires spec_short_amp == 0 like
    render_program(device_controls=True). Instance b equals
    render_program(program, ..., seed=seeds[b], device_controls=True) up to
    scan chunk-boundary roundoff."""
    p = program
    assert p.mode is Mode.WIND
    eff, pink32, logmap = _wind_setup(p, sample_rate)
    assert float(eff["spec_short_amp"]) == 0.0, \
        "batched serving needs the device-controls path (zero short wobble)"
    n_slow_long = eff["n_slow_steps_long"]
    m = len(pink32)
    dev = torch.device(device)
    dt = dtype_of(dtype)

    pos0, prev0, gains, params = [], [], [], []
    for bi, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        starts = _seg_walk_starts(rng, pink32)
        pos0.append(starts[0])
        prev0.append(starts[1])
        pan = (float(pans[bi]) if pans is not None and pans[bi] is not None
               else float(rng.uniform(-1.0, 1.0)))
        gains.append(_pan_gains(pan, n_channels))
        params.append(_params(eff, velocity, p))

    ctl = _device_controls(
        _pink_dev(sample_rate, "float32", str(dev)).abs(), torch.as_tensor(pos0, device=dev),
        torch.as_tensor(prev0, dtype=torch.float32, device=dev),
        torch.as_tensor(logmap, device=dev), n_steps=n_slow_long,
        itp_main=int(p.interpolation), T=n_samples)
    lut, lut_lo, lut_step = _lut_dev(
        int(p.loudness_ref_freq_index), float(p.loudness_compensation),
        float(p.loudness_level), sample_rate, dtype, str(dev))
    out = _wind_mix(_pink_dev(sample_rate, dtype, str(dev)), int(m * 0.5 + 0.5),
                    *(c.to(dt) for c in ctl),
                    torch.as_tensor(np.asarray(params), dtype=dt, device=dev),
                    lut, lut_lo, lut_step,
                    torch.as_tensor(np.asarray(gains), dtype=dt, device=dev),
                    order=int(p.filter_order), lowpass_mode=lowpass_mode)
    return out if device_out else out.cpu().numpy()
