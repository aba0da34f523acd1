"""Procedural SoundEngine: Markov-driven ramp specs -> batched spec renderer.

Reference: include/soundengine.h. A note triggers a Markov-chain walk whose
node lambdas emit up to 30 "ramp specs" (soundengine.h:1035-1120) — frequency
glides with volume and articulation — which the engine then plays through 3
rotating enveloped ramps, one spec after another, with equal-gain crossfades
(attack/release = xfade_len; playNextSpec, soundengine.h:776-803) and optional
articulative silence between specs (orchestrate_algos, soundengine.h:744-774).

Split:
  HOST  — the Markov walk and spec scheduling (the reference also runs this
          off the real-time path, at note setup: gen.voice.h:999-1034). Output
          is a dense spec table with absolute start/release times.
  DEVICE— all specs render in parallel as rows of a (specs, L) tile: the
          LogRamp trajectory has a closed form (the
          PROPORTIONAL_VALUE_DERIVATIVE stepping solves ds/dt = C*f(s), an
          exponential in s — LogRamp, include/audioelement.h:2464-2572), the
          phase is a cumsum, the equal-loudness volume is a table lookup, and
          the per-spec xfade envelope is the standard closed form. Spec
          segments are added into the output timeline.

Modes BIRDS / ROBOTS / SWEEP use this renderer; WIND (noise-driven filter
textures) lives in models/wind.py.

Port of cpp_audio_tpu/models/soundengine.py: the scheduler, the spec table
and the loudness table are host copies; the tile renders in plain PyTorch on
`device`. The phase is a float64 cumsum, wrapped (oscillators.wrapped_cumsum);
the loudness EMA runs on filters.chunked_affine_scan. The overlap-add adds
each spec row's segment into its slice of the timeline, one row after
another (the batch: one row index across all jobs at a time, whose target
frames never collide), so two renders on the card are bitwise equal.
Renders return tensors on `device`.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import dtype_of
from ..ops import filters, oscillators
from ..utils import loudness
from ..utils.convert import freq_to_angle_increment, ms_to_frames
from ..utils.interp import ease_select
from ..utils.markov import MarkovChain, MarkovMove
from ..utils.midi import Midi
from .voice_presets import FreqXfade, Mode, VoiceProgram

INT_MAX_HALF = 2**30


@dataclass
class RampSpec:
    from_inc: float
    to_inc: float
    duration: float      # samples (value-trajectory duration D)
    start_sample: float  # s0 offset into the trajectory
    itp: int
    volume: float = 1.0
    silence_follows: bool = True


class _SpecBuilder:
    """Mirrors SoundEngine::play + RampSpecs build (soundengine.h:497-562)."""

    N_SPECS = 30

    def __init__(self, engine):
        self.e = engine
        self.specs: list[RampSpec] = []
        self.state_freq = 0.0
        self.state_factor = 0.0

    def next_slot(self) -> bool:
        return len(self.specs) < self.N_SPECS

    def play(self, length, freq1, freq2, freq_scatter):
        e = self.e
        length = length * 2.0 ** e.rng.uniform(e.min_exp, e.max_exp)
        n_frames = float(ms_to_frames(length, e.sample_rate))
        if n_frames <= 0:
            return
        if not self.next_slot():
            return
        current = self.specs[-1] if self.specs else None
        if self.state_freq == freq1:
            pass  # reuse previous scatter when base value repeats
        else:
            scatter = 1.0 + freq_scatter
            self.state_factor = e.rng.uniform(1.0 / scatter, scatter)
        self.state_freq = freq2
        freq1 = freq1 * self.state_factor
        freq2 = freq2 * self.state_factor

        spec = RampSpec(
            from_inc=freq_to_angle_increment(freq1, e.sample_rate),
            to_inc=freq_to_angle_increment(freq2, e.sample_rate),
            duration=n_frames, start_sample=0.0, itp=e.interpolation,
            volume=1.0, silence_follows=True,
        )
        self.specs.append(spec)
        if e.xfade_freq is FreqXfade.NO:
            return
        if current is not None:
            from_inc = current.to_inc
            to_inc = spec.from_inc
            diff = from_inc - to_inc
            if e.xfade_freq is FreqXfade.ALL or diff:
                if self.next_slot():
                    # move the new spec one later; insert a transition
                    if from_inc == to_inc:
                        from_inc *= 1.00001  # make the ramp non-trivial
                    trans = RampSpec(
                        from_inc=from_inc, to_inc=to_inc, duration=float(e.freq_xfade),
                        start_sample=0.0, itp=e.freq_interpolation, volume=1.0,
                        silence_follows=True,
                    )
                    self.specs.insert(len(self.specs) - 1, trans)
                else:
                    self.specs.pop()

    def emit(self, from_f, to_f, n_frames, start_ratio, itp, volume, silence):
        if not self.next_slot():
            return
        e = self.e
        self.specs.append(RampSpec(
            from_inc=freq_to_angle_increment(from_f, e.sample_rate),
            to_inc=freq_to_angle_increment(to_f, e.sample_rate),
            duration=n_frames, start_sample=start_ratio * n_frames, itp=itp,
            volume=volume, silence_follows=silence,
        ))


class SoundEngineScheduler:
    """Host-side SoundEngine state + markov graphs (soundengine.h:565-1003)."""

    def __init__(self, program: VoiceProgram, sample_rate: int, base_freq: float,
                 seed: int = 1):
        p = program
        self.program = p
        self.sample_rate = sample_rate
        self.base_freq = base_freq
        self.rng = np.random.default_rng(seed)
        self.midi = Midi()
        # engine-facing values go through the reference's f32 program
        # storage + setupAudioElement conversions (effective_engine_config,
        # pinned against compiled gen.voice.h): env charac time ROUNDS,
        # freq_xfade and the articulative pause TRUNCATE
        from .voice_presets import effective_engine_config
        eff = effective_engine_config(p, sample_rate)
        self.min_exp, self.max_exp = eff["length_exp"]
        self.length = eff["length"]
        self.interpolation = p.interpolation
        self.freq_interpolation = p.freq_interpolation
        self.xfade_freq = p.xfade_freq
        self.xfade_len = eff["env_charac_time"]
        self.freq_xfade = eff.get("freq_xfade", 0)
        self.pause_len = (eff["init"][-1]
                          if p.mode in (Mode.BIRDS, Mode.ROBOTS) else 0)
        self.phase_ratio1 = eff.get("phase_ratio1", 0.0)
        self.phase_ratio2 = eff.get("phase_ratio2", 0.0)

    def _rand01(self) -> float:
        return float(self.rng.uniform(0.0, 1.0))

    def build_specs(self) -> list[RampSpec]:
        p = self.program
        b = _SpecBuilder(self)
        if p.mode is Mode.BIRDS:
            mc = self._create_birds(b)
        elif p.mode is Mode.ROBOTS:
            mc = self._create_robot(b)
        elif p.mode is Mode.SWEEP:
            mc = self._create_sweep(b)
        else:
            raise ValueError("WIND mode renders via models/wind.py")
        mc.initialize(p.start_node if p.mode is not Mode.SWEEP else 0)
        for _ in range(p.pre_tries):
            mc.step_normalized(self._rand01(), execute=False)
        for _ in range(p.min_path_length):
            mc.step_normalized(self._rand01(), execute=True)
        for _ in range(p.additional_tries):
            mc.step(self._rand01(), execute=True)
        return b.specs

    # --- markov graphs (soundengine.h:565-736) ---

    def _create_birds(self, b: _SpecBuilder) -> MarkovChain:
        mc = MarkovChain()
        f = self.base_freq
        sc = self.program.freq_scatter
        n1 = mc.emplace(lambda m, me, o: None)

        def node2(m, me, o):
            if m is MarkovMove.ENTER_NODE:
                b.play(self.length, f * 4, f * 3, sc)
            else:
                b.play(self.length, f * 2, f * 4, sc)

        n2 = mc.emplace(node2)

        def node3(m, me, o):
            if m is MarkovMove.ENTER_NODE:
                b.play(self.length, f * 4, f * 3, sc)

        n3 = mc.emplace(node3)
        mc.def_transition(n1, n2, 0.5)
        mc.def_transition(n2, n1, 0.015)
        mc.def_transition(n1, n3, 0.5)
        mc.def_transition(n3, n1, 0.015)
        mc.def_transition(n3, n2, 0.885)
        return mc

    def _rand_frames(self, scale: float = 1.0) -> float:
        length = scale * self.length * 2.0 ** self.rng.uniform(self.min_exp, self.max_exp)
        return float(ms_to_frames(length, self.sample_rate))

    def _create_robot(self, b: _SpecBuilder) -> MarkovChain:
        p = self.program
        # initialize_robot randomization (soundengine.h:926-961)
        scatter = 1.0 + p.freq_scatter
        f1 = self.rng.uniform(self.base_freq / scatter, self.base_freq * scatter)
        detune = 0.985
        f2 = self.rng.uniform(f1 * detune, f1 / detune)
        vol1 = vol2 = 1.0
        har_att = min(max(p.harmonic_attenuation, 0.0), 0.99)
        if not self.rng.integers(0, 2):
            f1 = self.midi.transpose_frequency(f1, p.d1)
            vol1 = har_att**p.d1
        else:
            f2 = self.midi.transpose_frequency(f2, p.d2)
            vol2 = har_att**p.d2
        itp = self.interpolation
        pr1 = self.phase_ratio1
        mc = MarkovChain()

        def node0(m, me, o):
            if m is MarkovMove.LEAVE_NODE:
                n = self._rand_frames()
                b.emit(f1, f1, n, pr1, itp, vol1, False)
                b.emit(f2, f2, n, pr1, itp, vol2, True)

        def node2(m, me, o):
            if m is MarkovMove.ENTER_NODE:
                n = self._rand_frames()
                b.emit(f2, f2, n, pr1, itp, vol2, True)
                b.emit(self.midi.transpose_frequency(f2, 2),
                       self.midi.transpose_frequency(f2, 2), n, pr1, itp, vol2, True)
                b.emit(self.midi.transpose_frequency(f2, 4),
                       self.midi.transpose_frequency(f2, 4), n, pr1, itp, vol2, True)

        def node3(m, me, o):
            if m is MarkovMove.ENTER_NODE:
                n = self._rand_frames(scale=2.0)
                b.emit(f2, f1, n, pr1, itp, min(vol1, vol2), True)

        i0 = mc.emplace(node0)
        i1 = mc.emplace(lambda m, me, o: None)
        i2 = mc.emplace(node2)
        i3 = mc.emplace(node3)
        mc.def_transition(i0, i1, 1.0)
        mc.def_transition(i1, i2, 0.2)
        mc.def_transition(i2, i1, 0.1)
        mc.def_transition(i1, i3, 0.2)
        mc.def_transition(i3, i1, 1.0)
        return mc

    def _create_sweep(self, b: _SpecBuilder) -> MarkovChain:
        p = self.program
        itp = self.interpolation
        pr1 = self.phase_ratio1
        mc = MarkovChain()

        def node0(m, me, o):
            if m is MarkovMove.LEAVE_NODE:
                n = self._rand_frames()
                b.emit(p.low_freq, p.high_freq, n, pr1, itp, 1.0, True)

        i0 = mc.emplace(node0)
        i1 = mc.emplace(lambda m, me, o: None)
        mc.def_transition(i0, i1, 1.0)
        return mc

    def timeline(self, specs: list[RampSpec]) -> list[tuple[RampSpec, int, int]]:
        """(spec, t_press, t_release) — sequential spec playback with
        articulative pauses (orchestrate_algos, soundengine.h:744-803)."""
        out = []
        t = 0
        for spec in specs:
            dur = int(0.5 + spec.duration)
            time_to_release = max(dur - self.xfade_len, 0)
            release = t + time_to_release
            out.append((spec, t, release))
            t = release + (self.pause_len if spec.silence_follows else 0)
        return out


def _loudness_lut(low_index: int, log_ratio: float, level: float, sample_rate: int,
                  n: int = 4096):
    """Equal-loudness volume as a dense lookup over log2(increment)."""
    log2_inc = np.linspace(-18.0, 1.0, n)  # inc 4e-6 .. 2 (rad/pi)
    freqs = (2.0**log2_inc) * 0.5 * sample_rate
    vols = np.asarray(loudness.equal_loudness_volume_from_freq(
        freqs, low_index=low_index, log_ratio=log_ratio, level=level))
    return log2_inc[0], log2_inc[1] - log2_inc[0], vols.astype(np.float64)


@functools.lru_cache(maxsize=32)
def _lut_dev(low_index: int, log_ratio: float, level: float, sr: int,
             dtype: str, device: str):
    """The loudness LUT and its two scalars as tensors on `device`, cached
    per configuration (a render constant)."""
    lut_lo, lut_step, lut = _loudness_lut(low_index, log_ratio, level, sr)
    dt, dev = dtype_of(dtype), torch.device(device)
    return (torch.as_tensor(lut, dtype=dt, device=dev),
            torch.tensor(lut_lo, dtype=dt, device=dev),
            torch.tensor(lut_step, dtype=dt, device=dev))


def logramp_increments(k, frm, to, D, s0, itp_codes, kinds=None):
    """EXACT closed-form LogRamp increment at sample offsets k (broadcastable
    tensors).

    The reference (LogRamp::do_step, include/audioelement.h:2523-2543) steps
    cur_sample by C*f where f is the LINEARLY-interpolated increment at
    normalized position (cur_sample+0.5)/D (regardless of the value easing),
    and when cur_sample + 0.5 > D restarts at 0 with from/to swapped
    (audioelement.h:2524-2527). Because f is linear in cur_sample the
    discrete recurrence is AFFINE, s' = alpha*s + beta with
    alpha_leg = 1 + C*g_leg (g_leg = (b-a)/D, C = ln(to/frm)/(to-frm),
    invariant under the swap), so it has the exact closed form
        s_tau = (s_start + c_leg) * alpha_leg^tau - c_leg,
        c_leg = a/g_leg + 0.5
    and each leg's integer duration is exact too: the s + 0.5 > D trigger
    is u = s + c_leg crossing b/g_leg, at
        N_leg = floor(ln((b/g_leg) / u_start) / ln(alpha_leg)) + 1.
    Each DIRECTION therefore has its own duration (N_A forward, N_B
    backward); after the first (possibly mid-range, from s0) leg the legs
    alternate backward/forward. The value uses the CURRENT leg's
    orientation: a_leg + (b_leg - a_leg) * ease(s/D).

    The expressions and their order are the JAX package's: the leg
    durations are floors of log ratios, which a reordered expression can
    move by one sample. kinds: the curve codes present (ease_select).
    """
    g = (to - frm) / D
    same = torch.abs(to - frm) < 1e-12 * torch.abs(frm)
    g_safe = torch.where(same, 1.0, g)
    lam = torch.where(same, 0.0,
                      torch.log(torch.clamp(to, min=1e-30)
                                / torch.clamp(frm, min=1e-30)) / D)
    # exact discrete growth factors per orientation
    ln_aA = torch.log1p(torch.where(same, 1.0, lam))    # alpha_A = 1 + lam
    ln_aB = torch.log1p(torch.where(same, 1.0, -lam))   # alpha_B = 1 - lam
    ln_aA_s = torch.where(same, 1.0, ln_aA)
    ln_aB_s = torch.where(same, 1.0, ln_aB)

    def _ratio(num, den):
        return torch.clamp(torch.abs(num) / torch.clamp(torch.abs(den), min=1e-30),
                           min=1e-30)

    c_A = frm / g_safe + 0.5
    c_B = -to / g_safe + 0.5
    u_trig_A = to / g_safe
    u_trig_B = -frm / g_safe
    u1_0 = s0 + c_A
    # integer leg durations (exact: smallest k with alpha^k > ratio)
    N_1 = torch.floor(torch.log(_ratio(u_trig_A, u1_0)) / ln_aA_s) + 1.0
    N_A = torch.floor(torch.log(_ratio(u_trig_A, c_A)) / ln_aA_s) + 1.0
    N_B = torch.floor(torch.log(_ratio(u_trig_B, c_B)) / ln_aB_s) + 1.0

    # leg 1 (clamp the exponent: s only matters for k < N_1; unclamped, a
    # downward glide drives exp() deep into subnormals across the whole
    # (V, L) grid)
    s1 = u1_0 * torch.exp(torch.clamp(ln_aA * k, -60.0, 60.0)) - c_A
    value_1 = frm + (to - frm) * ease_select(
        itp_codes, torch.clamp(s1 / D, 0.0, 1.0), kinds)

    # ping-pong legs: backward (N_B) then forward (N_A), alternating
    N_P = torch.clamp(N_A + N_B, min=1.0)
    tpp = k - N_1
    cyc = torch.floor(tpp / N_P)
    rem = tpp - cyc * N_P
    inB = rem < N_B
    tau = torch.where(inB, rem, rem - N_B)
    a_leg = torch.where(inB, to, frm)
    b_leg = torch.where(inB, frm, to)
    c_leg = torch.where(inB, c_B, c_A)
    ln_a_leg = torch.where(inB, ln_aB, ln_aA)
    s_pp = c_leg * torch.expm1(torch.clamp(ln_a_leg * tau, -60.0, 60.0))
    value_pp = a_leg + (b_leg - a_leg) * ease_select(
        itp_codes, torch.clamp(s_pp / D, 0.0, 1.0), kinds)

    value = torch.where(k < N_1, value_1, value_pp)
    return torch.where(same, frm, value)


def _spec_signal(k, fp, itp_codes, lut, lut_lo, lut_step, kinds, *, valid=None):
    """The spec rows' signal on their local grids k: fp (..., 10) packed
    [from, to, D, s0, vol, A, R, rl, active_len, amp]. valid (None: every
    k) marks the grid positions at or after the spec's start (the batch's
    frame-aligned grids start before it)."""
    frm, to, D, s0, vol, A, R, rl, act, amp = (fp[..., i, None] for i in range(10))
    inc = logramp_increments(k, frm, to, D, s0, itp_codes[..., None], kinds)
    if valid is not None:
        inc = torch.where(valid, inc, 0.0)
    # phase: cumulative sum of increments (exact trajectory integral)
    phase = oscillators.wrapped_cumsum(inc)

    # equal-loudness volume lookup on log2(inc)
    idx = torch.clamp((torch.log2(torch.clamp(inc, min=1e-9)) - lut_lo) / lut_step,
                      0.0, lut.shape[0] - 1.001)
    i0 = idx.to(torch.int64)
    fracl = idx - i0
    lvol = lut[i0] * (1.0 - fracl) + lut[i0 + 1] * fracl
    # the reference LOW-PASSES the loudness target with time constant = the
    # current period (BaseVolumeAdjusted::step, audioelement.h:1195-1216:
    # alpha_t = 1 - exp(-pi*inc_t), filter initialized AT the first target) —
    # a time-varying EMA, solved exactly with the chunked affine scan.
    al = 1.0 - torch.exp(-math.pi * inc)
    al = torch.where(k == 0.0, 1.0, al)
    if valid is not None:
        al = torch.where(valid, al, 0.0)
    lvol = filters.chunked_affine_scan(1.0 - al, al * lvol, axis=-1)

    # xfade envelope: linear attack A from k=0, linear release R at rl
    env_a = torch.clamp((k + 1.0) / A, 0.0, 1.0)
    top = torch.clamp(rl / A, 0.0, 1.0)
    env = torch.where(k < rl, env_a,
                      top * (1.0 - torch.clamp((k - rl + 1.0) / R, 0.0, 1.0)))
    active = k < act
    if valid is not None:
        active = valid & active
    return torch.where(active, amp * vol * lvol * env
                       * oscillators.freq_aliasing_multiplicator(inc)
                       * oscillators.sine(phase), 0.0)


def _render_specs(fp, itp_codes, gains, t0, lut, lut_lo, lut_step, *,
                  L: int, T: int, n_channels: int, kinds):
    """fp: (V, 10) packed [from, to, D, s0, vol, A, R, rl, active_len, amp];
    t0: host ints. Renders all specs on a local (V, L) grid and adds each
    row's segment into (T, C) at its start."""
    k = torch.arange(L, dtype=fp.dtype, device=fp.device)[None, :]
    sig = _spec_signal(k, fp, itp_codes, lut, lut_lo, lut_step, kinds)
    out = torch.zeros((T + L, n_channels), dtype=fp.dtype, device=fp.device)
    for v in range(fp.shape[0]):
        t = int(np.clip(t0[v], 0, T))
        out[t:t + L] += sig[v, :, None] * gains[v]
    return out[:T]


def _spec_rows(timeline, xfade_len: int, min_dt: int, velocity: float):
    """(rows, codes, t0) of a job's timeline: the packed spec table."""
    V = len(timeline)
    rows = np.zeros((V, 10))
    codes = np.zeros(V, np.int32)
    t0 = np.zeros(V, np.int64)
    for i, (spec, press, release) in enumerate(timeline):
        # attack/release = max(xfade_len, 1ms) EXACTLY: the engine's ramps
        # never receive Enveloped::setAngleIncrements, so the 2.5-period
        # anti-zipper floor (audioelement.h:216-225) stays at its zero
        # default here. Elements that DO get setAngleIncrements
        # (ResynthElement, the carrier) keep the floor.
        A = max(xfade_len, min_dt, 1.0)
        R = max(xfade_len, min_dt, 1.0)
        rl = max(release - press, 0)
        act = rl + R
        rows[i] = [spec.from_inc, spec.to_inc, max(spec.duration, 1.0),
                   spec.start_sample, spec.volume, A, R, rl, act, velocity]
        codes[i] = spec.itp
        t0[i] = press
    return rows, codes, t0


def _pan_gains(pan: float, n_channels: int) -> np.ndarray:
    th = 0.25 * np.pi * (pan + 1.0)
    if n_channels == 1:
        return np.ones(1)
    return np.array([np.cos(th), np.sin(th)])[:n_channels]


def render_program(program: VoiceProgram, base_freq: float, n_samples: int,
                   sample_rate: int = 44100, *, seed: int = 1, velocity: float = 1.0,
                   pan: float | None = None, n_channels: int = 2,
                   dtype: str = "float32", rng=None, device="cuda") -> torch.Tensor:
    """Render one SoundEngine note (the `birds` app path) to an
    (n_samples, C) tensor on `device`.

    rng overrides the scheduler's random source (the compiled-reference
    waveform oracle replays the reference's exact draw sequence through it).
    """
    dev = torch.device(device)
    sched = SoundEngineScheduler(program, sample_rate, base_freq, seed=seed)
    if rng is not None:
        sched.rng = rng
    specs = sched.build_specs()
    if not specs:
        return torch.zeros((n_samples, n_channels), dtype=dtype_of(dtype), device=dev)
    timeline = sched.timeline(specs)

    sr = sample_rate
    # AHDSREnvelopeBase's normalizedMinDt: sample_rate/1000 in INTEGER
    # arithmetic (audioelement.h:863-872)
    min_dt = sr // 1000
    rows, codes, t0 = _spec_rows(timeline, sched.xfade_len, min_dt, velocity)
    # the output length in powers of two, as the JAX package buckets it;
    # the local grid never needs to reach past the render horizon: segment
    # content beyond T is sliced away, so cap L at the T bucket
    T_pad = int(2 ** np.ceil(np.log2(max(n_samples, 256))))
    L = int(2 ** np.ceil(np.log2(max(rows[:, 8].max() + 1, 256))))
    L = min(L, T_pad)

    p = program
    if pan is None:
        pan = float(sched.rng.uniform(-1.0, 1.0))
    gains = np.tile(_pan_gains(pan, n_channels)[None, :], (len(rows), 1))
    gains *= p.sine_gain * p.gain

    lut, lut_lo, lut_step = _lut_dev(
        int(p.loudness_ref_freq_index), float(p.loudness_compensation),
        float(p.loudness_level), sr, dtype, str(dev))
    dt = dtype_of(dtype)
    out = _render_specs(
        torch.as_tensor(rows, dtype=dt, device=dev),
        torch.as_tensor(codes, device=dev), torch.as_tensor(gains, dtype=dt, device=dev),
        t0, lut, lut_lo, lut_step, L=L, T=T_pad, n_channels=n_channels,
        kinds=sorted(set(codes.tolist())))
    return out[:n_samples]


# ---- batched multi-job serving ----

def _render_specs_batch(fp, itp_codes, gains, t0, lut, lut_lo, lut_step, *,
                        L: int, F_T: int, n_channels: int, kinds):
    """Batched `_render_specs`: fp (B, V, 10), codes (B, V), gains
    (B, V, C), t0 (B, V) host ints -> (B, F_T*L, C).

    Each spec evaluates on a FRAME-ALIGNED (2L,) grid (k = j - t0 mod L, so
    a segment spans at most two L-frames) and its two halves add into
    frames t0 // L and t0 // L + 1, one spec row index at a time across the
    batch: within a row index every job writes its own frames, so no two
    writes of one step collide. The closed forms are identical to
    _render_specs; only cumsum/scan chunk boundaries differ (ULP-level), so
    batch == single render to f32 roundoff."""
    B, V = t0.shape
    dev, wdt = fp.device, fp.dtype
    off = torch.as_tensor(t0 % L, dtype=wdt, device=dev)
    # frames at or past F_T (specs starting beyond the render) land in one
    # spare frame that is dropped
    first = np.minimum(t0 // L, F_T)
    second = np.minimum(t0 // L + 1, F_T)
    first, second = (torch.as_tensor(f, dtype=torch.int64, device=dev) for f in (first, second))
    j = torch.arange(2 * L, dtype=wdt, device=dev)[None, None, :]
    k = j - off[:, :, None]
    sig = _spec_signal(k, fp, itp_codes, lut, lut_lo, lut_step, kinds, valid=k >= 0.0)
    out = torch.zeros((B, F_T + 1, L, n_channels), dtype=wdt, device=dev)
    rows = torch.arange(B, device=dev)
    for v in range(V):
        g = gains[:, v, None, :]
        out[rows, first[:, v]] += sig[:, v, :L, None] * g
        out[rows, second[:, v]] += sig[:, v, L:, None] * g
    return out[:, :F_T].reshape(B, F_T * L, n_channels)


def render_program_batch(program: VoiceProgram, base_freq: float,
                         n_samples: int, sample_rate: int = 44100, *,
                         seeds, velocity: float = 1.0, pans=None,
                         n_channels: int = 2, dtype: str = "float32",
                         device_out: bool = False, device="cuda"):
    """Serve B independent SoundEngine renders (same program, different
    seeds) in one batched render (reference framing: one engine instance
    per call, main.birds.cpp:82-83 — this is the many-instance serving
    path).

    Returns (B, T_out, C) with T_out = min(n_samples, padded span of the
    longest job) — renders are silent past each job's span, so callers
    treating row b as a length-n_samples render zero-extend. One host copy
    (numpy), or with device_out=True the tensor on `device`."""
    sr = sample_rate
    min_dt = sr // 1000
    jobs = []
    for bi, seed in enumerate(seeds):
        sched = SoundEngineScheduler(program, sr, base_freq, seed=seed)
        specs = sched.build_specs()
        timeline = sched.timeline(specs) if specs else []
        if pans is not None and pans[bi] is not None:
            pan = float(pans[bi])
        else:
            pan = float(sched.rng.uniform(-1.0, 1.0))
        jobs.append((sched, timeline, pan))

    B = len(jobs)
    Vmax = max(max((len(tl) for _s, tl, _p in jobs), default=1), 1)
    # inert rows for the jobs with fewer specs (zero amplitude and length)
    rows = np.zeros((B, Vmax, 10))
    rows[:, :, 0] = 1e-6
    rows[:, :, 1] = 1e-6
    rows[:, :, 2] = 1.0
    rows[:, :, 5] = 1.0
    rows[:, :, 6] = 1.0
    codes = np.zeros((B, Vmax), np.int32)
    t0 = np.zeros((B, Vmax), np.int64)
    gains = np.zeros((B, Vmax, n_channels))
    p = program
    end_max = 256
    act_max = 256
    for bi, (sched, timeline, pan) in enumerate(jobs):
        gains[bi, :, :] = _pan_gains(pan, n_channels)[None, :] * (p.sine_gain * p.gain)
        if not timeline:
            continue
        r, c, t = _spec_rows(timeline, sched.xfade_len, min_dt, velocity)
        V = len(timeline)
        rows[bi, :V], codes[bi, :V], t0[bi, :V] = r, c, t
        act_max = max(act_max, int((r[:, 8] + 1).max()))
        end_max = max(end_max, int((t + r[:, 8] + 1).max()))
    T_cap = int(2 ** np.ceil(np.log2(max(n_samples, 256))))
    L = min(int(2 ** np.ceil(np.log2(act_max))), T_cap)
    T_call = min(int(2 ** np.ceil(np.log2(end_max))), T_cap)
    T_call = max(T_call, L)
    F_T = T_call // L

    dev = torch.device(device)
    lut, lut_lo, lut_step = _lut_dev(
        int(p.loudness_ref_freq_index), float(p.loudness_compensation),
        float(p.loudness_level), sr, dtype, str(dev))
    dt = dtype_of(dtype)
    out = _render_specs_batch(
        torch.as_tensor(rows, dtype=dt, device=dev), torch.as_tensor(codes, device=dev),
        torch.as_tensor(gains, dtype=dt, device=dev), t0, lut, lut_lo, lut_step,
        L=L, F_T=F_T, n_channels=n_channels, kinds=sorted(set(codes.flatten().tolist())))
    out = out[:, :n_samples]
    return out if device_out else out.cpu().numpy()
