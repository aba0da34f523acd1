"""MIDI-playable vocoder carrier synth — the reference's SynthVocoderCarier.

Reference (source/rt.resynth.lib.cpp:21-52): the carrier element is
    VolumeAdjusted< Enveloped< FreqCtrl_< UnityGainMix<
        VolumeAdjusted<soundBufferWrapperAlgo<NOISE>>,
        VolumeAdjusted<FOscillatorAlgo<SAW>>,
        VolumeAdjusted<FOscillatorAlgo<TRIANGLE>>,
        VolumeAdjusted<FOscillatorAlgo<SQUARE>>,
        VolumeAdjusted<SineOscillatorAlgo>,
        VolumeAdjusted<PulseTrainAlgo> >,
      InterpolatedFreq >, AHDSR >, BaseVolumeDef::One >
played as a mono 127-voice sine::Synth (rt.resynth.lib.cpp:212-221) from live
MIDI (rt.resynth.lib.cpp:1519-1570), with per-oscillator volume targets and
the pulse width set by VocoderCarrierElementInitializer
(rt.resynth.lib.cpp:137-196; frequency glides over 100 samples:
`getCtrl().setup(100, itp::LINEAR)`).

All voices are rows of a (V, T) tile; phases, glides and envelopes are
closed-form in the sample index (no per-sample recurrence):

  - InterpolatedFreq's PROPORTIONAL_VALUE_DERIVATIVE stepping
    (include/audioelement.h:2706-2817) is an exactly solvable affine
    recurrence: the emitted increment is g_n = (from+a/2)*(1+lam)^n - a/2
    (a = (to-from)/G, lam = ln(to/from)/G), first step exactly `from`,
    clamping to `to` after m = floor(ln(to/(from+a/2))/ln(1+lam))+1 steps;
    the phase advance is its geometric partial sum (_glide_phase_advance).
  - All six oscillators share one phase trajectory (SynchronizePhase
    distributes the same start angle and FreqCtrl_ feeds the same increments
    to every member; soundBufferWrapperAlgo ignores frequency and steps its
    looping noise table one entry per sample, include/audioelement.h:1506-1580).
  - The UnityGainMix is a weighted sum with the per-osc VolumeAdjusted
    targets as weights (constant per note, so their volume LPFs sit at
    steady state).
  - The outer element uses BaseVolumeDef::One (it feeds the vocoder), so
    NoteOn volume = velocity (include/audioelement.h:1245-1249).

Port of cpp_audio_tpu/models/carrier.py. The tile render `_carrier_block` is
plain PyTorch on the synth's device, in the JAX package's arithmetic: the
sample index and the glide phase in the working dtype, so at float32 the
phase at large t carries the same rounding as there (PERF.md). Start angles
are drawn from numpy's default_rng(seed), as there. Under a torch profiler
a compute() is the span `live_carrier`, and its tables' uploads count in
utils/profiling.LIVE_WAITS.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.events import Event, EventType
from ..device import HostPickled, dtype_of
from ..ops import envelopes, noise as noise_ops, oscillators
from ..utils import profiling
from ..utils.profiling import span

NEVER = float(2**62)


@dataclass(frozen=True)
class CarrierOscMix:
    """Per-oscillator volumes + pulse width (VocoderCarrierElementInitializer
    fields, rt.resynth.lib.cpp:137-196; defaults rt.resynth.lib.cpp:978-984)."""

    noise: float = 0.0
    saw: float = 0.0
    triangle: float = 0.0
    square: float = 0.0
    sine: float = 0.0
    pulse: float = 0.0
    pulse_width: float = 0.01


@dataclass(frozen=True)
class CarrierSynthConfig:
    sample_rate: int = 44100
    ahdsr: envelopes.AHDSR = None  # type: ignore[assignment]
    osc: CarrierOscMix = field(default_factory=CarrierOscMix)
    # VocoderCarrierElementInitializer: getCtrl().setup(100, itp::LINEAR)
    glide_samples: int = 100
    n_voices: int = 127
    dtype: str = "float32"
    seed: int = 0

    def __post_init__(self):
        if self.ahdsr is None:
            # rt.resynth env defaults (rt.resynth.lib.cpp:957-961) with the
            # AllowZeroAttack::No 1 ms floor
            object.__setattr__(
                self, "ahdsr",
                envelopes.AHDSR(attack=0, hold=0, decay=0, release=0,
                                sustain=1.0).with_min_dt(self.sample_rate),
            )


@dataclass
class _Voice:
    note_id: int
    press: int
    release: float          # NEVER while held
    velocity: float
    inc_from: float         # rad/pi increment at glide start
    inc_to: float
    t_ref: int              # sample index where the current glide started
    phase_ref: float        # phase (rad/pi) before the step producing t_ref
    noise_start: int        # noise-table index at the press sample
    finished_at: float = NEVER  # envelope Done2 sample


def _glide_phase_advance(u, inc_from, inc_to, G: float):
    """Phase advance (rad/pi) after u whole steps of the reference's
    InterpolatedFreq glide — exact discrete semantics.

    The reference (include/audioelement.h:2746-2787) advances a progress
    variable by C*f(cur+0.5) per step with the emitted value LINEAR in the
    progress, which makes the emitted increment the affine recurrence
    g_{n+1} = g_n*(1+lam) + lam*a/2 with a=(to-from)/G, lam=ln(to/from)/G.
    Closed form: g_n = b*(1+lam)^n - a/2, b = from + a/2, so the first
    post-retune step emits exactly `from`. The glide clamps to `to` at step
    m = floor(ln(to/b)/ln(1+lam)) + 1, steady thereafter. Phase advance over
    u steps is the geometric partial sum
        Phi(u) = b*((1+lam)^min(u,m) - 1)/lam - a/2*min(u,m)
                 + to*max(u - m, 0).
    """
    a = (inc_to - inc_from) / G
    lam = torch.log(torch.clamp(inc_to, min=1e-30)
                    / torch.clamp(inc_from, min=1e-30)) / G
    steady = torch.abs(lam) < 1e-12
    lam_s = torch.where(steady, 1.0, lam)
    b = torch.clamp(inc_from + 0.5 * a, min=1e-30)
    logr = torch.log(torch.clamp(1.0 + lam_s, min=1e-30))
    logr_s = torch.where(steady, 1.0, logr)
    m = torch.clamp(torch.floor(torch.log(torch.clamp(inc_to, min=1e-30) / b)
                                / logr_s) + 1.0, min=0.0)
    ug = torch.minimum(u, m)
    phi_glide = b * torch.expm1(ug * logr_s) / lam_s - 0.5 * a * ug
    return torch.where(steady, inc_to * u,
                       phi_glide + inc_to * torch.clamp(u - m, min=0.0))


def _carrier_block(fp, ip, osc_vols, pulse_levels, noise_table, t0: int, *,
                   n: int, glide_samples: int, a_itp: int, d_itp: int,
                   r_itp: int, out_dtype: str) -> torch.Tensor:
    """Render n mono samples starting at absolute sample t0 -> (n,) tensor.

    fp:  (V, 12) working floats [press, release, velocity, inc_from, inc_to,
         t_ref, phase_ref, A, H, D, R, sustain] (attack/decay/release already
         floored on the host incl. the 2.5-period min-change)
    ip:  (V, 3) int32 [press, t_ref, noise_start]
    osc_vols: (V, 6) [noise, saw, triangle, square, sine, pulse]
    pulse_levels: (V, 3) [width, high, low]
    noise_table: (N,) looping white-noise buffer
    """
    wdt = dtype_of(out_dtype)
    dev = fp.device
    fp = fp.to(wdt)
    t_i = torch.arange(n, dtype=torch.int32, device=dev)[None, :] + int(t0)
    t = t_i.to(wdt)                                       # (1, T) absolute

    press, release, vel, inc_from, inc_to, t_ref, phase_ref, A, H, D, R, sus = (
        fp[:, i:i + 1] for i in range(12))

    # envelope (closed-form AHDSR; params pre-floored so min_change=0 here)
    params = envelopes.AHDSR(attack=A, attack_itp=a_itp, hold=H, decay=D,
                             decay_itp=d_itp, release=R, release_itp=r_itp,
                             sustain=sus)
    env = envelopes.ahdsr_envelope(t, params, press, release, dtype=wdt)

    # phase: closed-form exponential glide from the per-voice reference point
    u = t - t_ref + 1.0
    ph = oscillators.wrap_phase(
        phase_ref + _glide_phase_advance(u, inc_from, inc_to, float(glide_samples)))

    width, high, low = (pulse_levels[:, i:i + 1] for i in range(3))
    vol = [osc_vols[:, i:i + 1] for i in range(6)]
    wave = (vol[4] * oscillators.sine(ph)
            + vol[1] * oscillators.saw(ph)
            + vol[2] * oscillators.triangle(ph)
            + vol[3] * oscillators.square(ph)
            + vol[5] * oscillators.pulse(ph, width, high, low))

    # noise: one table entry per sample from the per-voice start index
    # (soundBufferWrapperAlgo::step, audioelement.h:1566-1572)
    N = noise_table.shape[0]
    nidx = torch.remainder(ip[:, 2:3] + (t_i - ip[:, 0:1]), N).long()
    wave = wave + vol[0] * noise_table[nidx].to(wdt)

    return torch.sum(vel * env * wave, dim=0)


class CarrierSynth(HostPickled):
    """Event-driven mono polyphonic carrier synth (on_event + compute).

    Same surface as models/streaming_synth.StreamingSynth; compute() returns
    a mono (n,) tensor on `device` for the vocoder's
    `vocoder_carrier.compute(&carrier_val, 1)` role (rt.resynth.lib.cpp:1408).
    """

    def __init__(self, config: CarrierSynthConfig | None = None, *,
                 device="cuda"):
        self.config = config or CarrierSynthConfig()
        cfg = self.config
        self.device = torch.device(device)
        self._rng = np.random.default_rng(cfg.seed)
        self._notes: dict[int, _Voice] = {}
        self._finished: list[_Voice] = []
        self.dropped_note_on = 0
        sr = cfg.sample_rate
        self._noise = np.asarray(
            noise_ops.white_noise_table(int(0.05 * sr)), np.float32)
        self._noise_dev = torch.from_numpy(self._noise).to(self.device)

    # -- helpers -----------------------------------------------------------
    def _inc(self, frequency: float) -> float:
        return 2.0 * frequency / self.config.sample_rate

    def _glide_params(self, v: _Voice):
        """(a, lam, b, m) of the exact discrete glide (see
        _glide_phase_advance); None when steady."""
        G = float(self.config.glide_samples)
        if v.inc_from == v.inc_to or v.inc_from <= 0 or v.inc_to <= 0:
            return None
        a = (v.inc_to - v.inc_from) / G
        lam = np.log(v.inc_to / v.inc_from) / G
        b = v.inc_from + 0.5 * a
        m = max(np.floor(np.log(v.inc_to / b) / np.log1p(lam)) + 1.0, 0.0)
        return a, lam, b, m

    def _inc_at(self, v: _Voice, t: int) -> float:
        """Increment used for sample t-1 — the reference's *f_result, which
        a retune at t adopts as its new `from` (audioelement.h:2751-2760)."""
        g = self._glide_params(v)
        if g is None:
            return v.inc_to
        a, lam, b, m = g
        n = max(t - 1 - v.t_ref, 0)
        if n >= m:
            return v.inc_to
        return b * (1.0 + lam) ** n - 0.5 * a

    def _phase_at(self, v: _Voice, t: int) -> float:
        """Phase after the step producing sample t-1 (discrete glide sum,
        matching _glide_phase_advance)."""
        u = float(max(t - v.t_ref, 0))
        g = self._glide_params(v)
        if g is None:
            d = v.inc_to * u
        else:
            a, lam, b, m = g
            ug = min(u, m)
            d = (b * np.expm1(ug * np.log1p(lam)) / lam - 0.5 * a * ug
                 + v.inc_to * max(u - m, 0.0))
        return float(np.mod(v.phase_ref + d, 2.0))

    # -- event interface (reference onEvent via MidiInput) ------------------
    def on_event(self, ev: Event) -> bool:
        if ev.type is EventType.NOTE_ON:
            # reference channel-occupancy drop (gen.crtp.h:221-225,398-413):
            # the pool holds 2*n_voices channels and a releasing voice
            # occupies its channel until the envelope reaches Done2
            self._gc(int(ev.time))
            if (len(self._notes) + len(self._finished)
                    >= 2 * self.config.n_voices):
                self.dropped_note_on += 1
                return False
            inc = self._inc(ev.frequency)
            t = int(ev.time)
            # DefaultStartPhase::Random (rt.resynth.lib.cpp:217): random start
            # angle, which also seeds the noise-table index (setStartAngle,
            # audioelement.h:1544-1556)
            angle = self._rng.uniform(-1.0, 1.0)
            noise_start = int(((angle + 1.0) * len(self._noise) * 0.5) + 0.5)
            self._notes[ev.note_id] = _Voice(
                ev.note_id, t, NEVER, ev.velocity, inc, inc, t,
                float(np.mod(angle, 2.0)), noise_start)
            return True
        if ev.type is EventType.NOTE_OFF:
            v = self._notes.pop(ev.note_id, None)
            if v is None:
                return False
            v.release = float(ev.time)
            cfg = self.config
            floor = np.floor(0.5 + 2.5 * 2.0 / max(self._inc_at(v, int(ev.time)), 1e-9))
            # + the EnvelopeDone1->Done2 window (n_frames_per_buffer + 1 =
            # 17 steps, audioelement.h:744-749) before the channel frees
            v.finished_at = v.release + max(
                float(np.max(np.asarray(cfg.ahdsr.release))), floor, 1.0) + 17
            self._finished.append(v)
            return True
        # NOTE_CHANGE: retune through the 100-sample InterpolatedFreq glide
        v = self._notes.get(ev.note_id)
        if v is None:
            return False
        t = int(ev.time)
        v.phase_ref = self._phase_at(v, t)
        v.inc_from = max(self._inc_at(v, t), 1e-9)
        v.inc_to = max(self._inc(ev.frequency), 1e-9)
        v.t_ref = t
        v.velocity = ev.velocity
        return True

    def all_notes_off(self, t: int) -> None:
        for nid in list(self._notes):
            self.on_event(Event(EventType.NOTE_OFF, t, nid, 0.0, 0.0))

    # -- rendering ----------------------------------------------------------
    def _gc(self, t: int) -> None:
        # channel freed exactly when its envelope finished (Done2)
        self._finished = [v for v in self._finished if v.finished_at > t]

    def _tables(self, active):
        """Host (fp, ip, vols, pulse_levels) rows of the active voices,
        padded to a power of two >= 8 with inert rows."""
        cfg = self.config
        a = cfg.ahdsr
        pad = max(8, 1 << int(np.ceil(np.log2(len(active)))))
        fp = np.zeros((pad, 12))
        ip = np.zeros((pad, 3), np.int32)
        vols = np.zeros((pad, 6))
        pl = np.zeros((pad, 3))
        fp[:, 3] = fp[:, 4] = 1.0  # inert rows: unit increments
        fp[:, 11] = 1.0
        o = cfg.osc
        sus = float(np.asarray(a.sustain))
        hold = max(float(np.max(np.asarray(a.hold))), 0.0)
        for i, v in enumerate(active):
            # reference floors: 1 ms (with_min_dt) + 2.5 periods (Enveloped)
            mc = np.floor(0.5 + 2.5 * 2.0 / max(abs(v.inc_to), 1e-9))
            A = max(float(np.max(np.asarray(a.attack))), mc, 1.0)
            D = (max(float(np.max(np.asarray(a.decay))), mc, 1.0)
                 if sus < 0.999999 else 0.0)
            R = max(float(np.max(np.asarray(a.release))), mc, 1.0)
            rel = min(v.release, 2.0**31 - 2.0**24)
            fp[i] = [v.press, rel, v.velocity, v.inc_from, v.inc_to,
                     v.t_ref, v.phase_ref, A, hold, D, R, sus]
            ip[i] = [v.press, v.t_ref, v.noise_start]
            vols[i] = [o.noise, o.saw, o.triangle, o.square, o.sine, o.pulse]
        high = 0.5 * (2.0 - min(max(o.pulse_width, 0.0), 2.0))
        pl[:, 0] = o.pulse_width
        pl[:, 1] = high
        pl[:, 2] = high - 1.0
        return fp, ip, vols, pl

    def compute(self, t0: int, n: int) -> torch.Tensor:
        """Render n mono samples covering [t0, t0+n) -> (n,) tensor on the
        synth's device, in the config's dtype."""
        with span("live_carrier", self.device):
            self._gc(t0)
            active = list(self._notes.values()) + self._finished
            cfg = self.config
            dt = dtype_of(cfg.dtype)
            if not active:
                return torch.zeros(n, dtype=dt, device=self.device)
            fp, ip, vols, pl = self._tables(active)
            a = cfg.ahdsr
            profiling.LIVE_WAITS += 4  # the four tables up
            return _carrier_block(
                torch.as_tensor(fp, dtype=dt, device=self.device),
                torch.as_tensor(ip, device=self.device),
                torch.as_tensor(vols, dtype=dt, device=self.device),
                torch.as_tensor(pl, dtype=dt, device=self.device),
                self._noise_dev, t0, n=n, glide_samples=cfg.glide_samples,
                a_itp=int(np.asarray(a.attack_itp)),
                d_itp=int(np.asarray(a.decay_itp)),
                r_itp=int(np.asarray(a.release_itp)), out_dtype=cfg.dtype)

    def render(self, n_samples: int, block_size: int = 4096) -> torch.Tensor:
        """Offline render of the current state (no further events)."""
        parts = [self.compute(t, min(block_size, n_samples - t))
                 for t in range(0, n_samples, block_size)]
        if not parts:
            return torch.zeros(0, dtype=dtype_of(self.config.dtype),
                               device=self.device)
        return torch.cat(parts)
