"""The live duplex path, plain: what one live user hears, callback by callback,
and the comparison that decides `correct` for the live cells.

The stream: the fed input (host float64, the captured audio) in callbacks of
`block` samples; in each, the block is fed, then as many samples are pulled.

  analysis   window f covers fed samples [f * stride, f * stride + window)
             and completes at sample window + f * stride; its peaks are
             analysis.peaks' (the program's: the k loudest, as they enter
             its tracker)
  tracker    tracker.track over the program's window peaks; each window's
             notes become synth events at the window's last sample (window
             + f * stride - 1), in note order: a note not yet sounding and
             updated in this window is a note-on (retried while the synth
             has no channel for it), a sounding note released in it a
             note-off, a sounding note updated in it a change
  synth      2 x n_voices channels, a note occupying one through its
             release and the 17 steps after it; a note-on finding none free
             is dropped and counted. A change retunes the note's fixed-point
             phase word so that its phase runs on unbroken, and sets its
             velocity. A pull renders its block from the notes as they stand
             after the block's events (a change acts from the block's first
             sample), each an enveloped sine of synth.render
  carrier    a square at `hz` from sample 0, its start angle numpy's first
             uniform(-1, 1) draw of default_rng(seed), through a LINEAR
             attack of max(attack, 2.5 periods) samples to 1
  vocoder    modulator window j covers fed samples [j * S, j * S + W) (S the
             vocoder's stride, W its window), its band amplitudes from the
             Gaussian-windowed spectrum's energy per band; carrier window c
             covers [c * S, c * S + 2S) and takes the amplitudes of
             modulator window c + floor((2S - W) / S), none before the
             first; its scaled spectrum's inverse, crossfaded linearly with
             the previous window's second half, is output from sample
             2S - 1 + c * S on (the streaming vocoder's latency)

reference/vocoder.vocode computes the offline vocoder, whose modulator
reads band energies off the whole signal's analytic signal and whose first
carrier windows take modulator window 0; the live vocoder reads each band
off one windowed spectrum and is silent until its first modulator window,
so it is written out here.

`compare(fed, got, cfg, device)` judges what a side produced (the program,
or `outputs(...)` in lower precision: the control):
  peak_db_gap    analysis.peak_gap_db of every window's peaks
  resynth_gap    the synth leg of each sampled callback: max |error| / peak
  vocoded_gap    the vocoded leg of each sampled callback, alike
  dropped_gap    |tracker's dropped note-ons - the reference's| + |synth's
                 dropped note-ons - the reference's|, over the whole stream
  knife_edges    the tracker's knife-edge decisions taken the side's way to
                 follow its events (as chain.follow does), infinite where
                 its events still part from the reference's after the cap
The carrier's sign flips that fall within float32's reach of a sample are
knife-edges too: there the reference takes the side's carrier sample (the
side keeps its carrier blocks around each sampled callback).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import analysis, synth, tracker
from .chain import FLOOR_DB, LOOKBACK, MAX_TRIALS, RANK_MARGIN_DB, SPAN_DB, top_peaks
from .precision import Precision

NEVER = 2.0 ** 62
TWO32 = 1 << 32
DONE_STEPS = 17      # a released channel frees this many steps after its release ends
EVENT_REL = 1e-9     # events part where a frequency, velocity or pan differs by more
# float32's reach of the carrier's phase, a share of it: three roundings (the
# increment, its product with the sample count, the sum), 2^-24 each, with room
CARRIER_REACH = 2.0 ** -22


# -- the synth ---------------------------------------------------------------

class _Note:
    __slots__ = ("press", "release", "freq", "vel", "pan", "inc_w", "ph0_w", "finished_at")

    def __init__(self, t, freq, vel, pan, sr):
        self.press, self.release, self.freq, self.vel, self.pan = t, NEVER, freq, vel, pan
        self.inc_w, self.ph0_w, self.finished_at = _word(2.0 * freq / sr), 0, NEVER


def _word(inc: float) -> int:
    return int(np.round(inc * (TWO32 // 2))) % TWO32


class StreamingSynth:
    """The channel pool and the notes' state, event by event."""

    def __init__(self, cfg: dict):
        self.cfg, self.sr = cfg["synth"], cfg["sample_rate"]
        self.held, self.finished, self.dropped = {}, [], 0
        self.channels = 2 * cfg["n_voices"]

    def event(self, t: int, kind: str, key, freq: float, vel: float, pan: float) -> bool:
        if kind == "on":
            self.finished = [v for v in self.finished if v.finished_at > t]
            if len(self.held) + len(self.finished) >= self.channels:
                self.dropped += 1
                return False
            self.held[key] = _Note(t, freq, vel, pan, self.sr)
            return True
        v = self.held.get(key)
        if v is None:
            return False
        if kind == "off":
            del self.held[key]
            inc = 2.0 * abs(v.freq) / self.sr
            R = max(self.cfg["release"], math.floor(0.5 + 2.5 * 2.0 / max(inc, 1e-9)), 1.0)
            v.release, v.finished_at = t, t + R + DONE_STEPS
            self.finished.append(v)
            return True
        new = _word(2.0 * freq / self.sr)
        steps = t - v.press  # steps of the old word before t
        v.ph0_w = (steps * v.inc_w + v.ph0_w - steps * new) % TWO32
        v.inc_w, v.freq, v.vel = new, freq, vel
        return True

    def sounding(self, t0: int) -> list:
        return [(v.press, v.release, v.freq, v.vel, v.pan, v.ph0_w)
                for v in list(self.held.values()) + self.finished if v.finished_at > t0]


def render_block(notes: list, t0: int, n: int, cfg: dict, prec: Precision, device) -> torch.Tensor:
    """(n, 2) of the sounding notes over samples [t0, t0 + n)."""
    s, sr = cfg["synth"], cfg["sample_rate"]
    if not notes:
        return torch.zeros((n, 2), dtype=prec.dtype, device=device)
    press, release, freq, vel, pan, ph0 = (np.array(x, np.float64) for x in zip(*notes))
    inc = 2.0 * freq / sr
    fade = np.clip((1.0 / np.abs(inc) - 1.0) / 3.0, 0.0, 1.0)
    th = 0.25 * np.pi * (np.clip(pan, -1.0, 1.0) + 1.0)
    full = np.ones_like(inc)
    v = dict(press=press - t0, release=np.where(release < NEVER, release - t0, NEVER),
             increment=inc, phase0=ph0 / (TWO32 // 2), amp=s["base_volume"] * vel * fade,
             gains=np.stack([np.cos(th), np.sin(th)], axis=1), attack=s["attack"] * full,
             hold=s["hold"] * full, decay=s["decay"] * full, release_len=s["release"] * full,
             sustain=s["sustain"] * full)
    return synth.render(v, n, prec, device)


# -- the tracker's events ----------------------------------------------------

def replay(notes: list, n_windows: int, cfg: dict, pulls: list[int]):
    """The synth events of every window and the notes sounding at each pull
    (the block starts `pulls`, ascending). Returns (events: (t, kind, freq,
    vel, pan) in order, {t0: sounding notes}, the synth's dropped note-ons)."""
    W, S, blk = cfg["window"], cfg["stride"], cfg["block"]
    at, rel = {}, {}
    for i, note in enumerate(notes):
        for f, freq, vol in note.frames:
            at.setdefault(f, {})[i] = (freq, vol)
        if note.release_frame < n_windows:
            rel.setdefault(note.release_frame, []).append(i)
    syn = StreamingSynth(cfg)
    live, events, snaps = set(), [], {}
    pending = list(pulls)
    for f in range(n_windows):
        t = W + f * S - 1
        while pending and pending[0] + blk <= t:
            snaps[pending[0]] = syn.sounding(pending[0])
            pending.pop(0)
        entries = at.get(f, {})
        for i in sorted(set(entries) | {i for i in rel.get(f, ()) if i in live}):
            if i not in live:
                freq, vol = entries[i]
                ev = (t, "on", freq, vol, notes[i].pan)
                if syn.event(t, "on", i, freq, vol, notes[i].pan):
                    live.add(i)
            elif notes[i].release_frame <= f:
                ev = (t, "off", 0.0, 0.0, 0.0)
                syn.event(t, "off", i, 0.0, 0.0, 0.0)
                live.discard(i)
            else:
                freq, vol = entries[i]
                ev = (t, "change", freq, vol, 0.0)
                syn.event(t, "change", i, freq, vol, 0.0)
            events.append(ev)
    for t0 in pending:
        snaps[t0] = syn.sounding(t0)
    return events, snaps, syn.dropped


def _same(a, b) -> bool:
    if a[:2] != b[:2]:
        return False
    return all(abs(x - y) <= EVENT_REL * max(abs(x), abs(y)) for x, y in zip(a[2:], b[2:]))


def first_parting(got: list, want: list, cfg: dict):
    """The window of the first event where two event streams part, or None."""
    for a, b in zip(got, want):
        if not _same(a, b):
            return (min(a[0], b[0]) + 1 - cfg["window"]) // cfg["stride"]
    if len(got) != len(want):
        t = (got if len(got) > len(want) else want)[min(len(got), len(want))][0]
        return (t + 1 - cfg["window"]) // cfg["stride"]
    return None


def _peak_lists(freq: np.ndarray, mag: np.ndarray) -> list:
    ok = np.isfinite(mag)
    return [list(zip(freq[f][ok[f]].tolist(), mag[f][ok[f]].tolist()))
            for f in range(freq.shape[0])]


def follow(peak_lists: list, got_events: list, cfg: dict, pulls: list[int]):
    """The reference's tracker and synth over a side's window peaks, with
    the knife-edge decisions taken the side's way where its events part
    from the reference's (up to cfg["max_flips"]). Returns (snaps, tracker
    dropped, synth dropped, knife-edges taken or inf, knife-edges met)."""
    def run(dec):
        notes, dropped = tracker.track(peak_lists, cfg["tracker"], dec)
        events, snaps, syn_dropped = replay(notes, len(peak_lists), cfg, pulls)
        return events, snaps, dropped, syn_dropped

    flips = frozenset()
    dec = tracker.Decisions(flips)
    best = run(dec)
    apart = first_parting(got_events, best[0], cfg)
    trials = 0
    while apart is not None and trials < MAX_TRIALS and len(flips) < cfg["max_flips"]:
        cands = sorted({e for e in dec.edges if apart - LOOKBACK <= e[0] <= apart} - flips,
                       key=lambda e: -e[0])
        for c in cands[:MAX_TRIALS - trials]:
            trials += 1
            d2 = tracker.Decisions(flips | {c})
            r2 = run(d2)
            a2 = first_parting(got_events, r2[0], cfg)
            if a2 is None or a2 > apart:
                flips, dec, best, apart = flips | {c}, d2, r2, a2
                break
        else:
            break
    taken = float(len(flips)) if apart is None else math.inf
    return best[1], best[2], best[3], taken, len(dec.edges)


# -- the carrier and the vocoder ---------------------------------------------

def _carrier_phase(cfg: dict, t0: int, n: int):
    """The carrier's phase (rad/pi, unwrapped) at samples [t0, t0 + n)."""
    c, sr = cfg["carrier"], cfg["sample_rate"]
    inc = 2.0 * c["hz"] / sr
    start = float(np.mod(np.random.default_rng(c["seed"]).uniform(-1.0, 1.0), 2.0))
    return start + inc * (np.arange(t0, t0 + n, dtype=np.float64) + 1.0), inc


def carrier(cfg: dict, t0: int, n: int, prec: Precision) -> np.ndarray:
    """The carrier's samples [t0, t0 + n), in `prec` (host float64)."""
    c = cfg["carrier"]
    phase, inc = _carrier_phase(cfg, t0, n)
    ph = np.mod(phase, 2.0)
    wave = np.where((ph > 0.5) & (ph < 1.5), -1.0, 1.0)
    A = max(c["attack"], math.floor(0.5 + 2.5 * 2.0 / inc), 1.0)
    t = torch.as_tensor(np.arange(t0, t0 + n, dtype=np.float64)).to(prec.dtype)
    env = torch.clamp((t + 1.0) / A, 0.0, 1.0)
    return (c["velocity"] * env * torch.as_tensor(wave).to(prec.dtype)).double().numpy()


def followed_carrier(cfg: dict, t0: int, n: int, side: list) -> tuple[np.ndarray, int]:
    """The reference's carrier over [t0, t0 + n), with the side's sample
    where a sign flip lies within float32's reach of it; and how many such
    samples it took. `side`: (start, samples) blocks of the side's carrier."""
    own = carrier(cfg, t0, n, Precision("float64"))
    phase, _inc = _carrier_phase(cfg, t0, n)
    off = np.abs(np.mod(phase, 1.0) - 0.5)  # distance to 0.5 or 1.5 (mod 2)
    edge = off < CARRIER_REACH * (np.abs(phase) + 2.0)
    taken = 0
    for start, samples in side:
        lo, hi = max(t0, start), min(t0 + n, start + len(samples))
        if hi <= lo:
            continue
        sel = np.nonzero(edge[lo - t0:hi - t0])[0]
        own[lo - t0 + sel] = samples[lo - start + sel]
        taken += len(sel)
    return own, taken


def _band_bins(edges, nfft: int, sr: int) -> np.ndarray:
    hz = np.arange(nfft // 2 + 1) * (sr / nfft)
    return np.stack([(hz > lo) & (hz <= hi) for lo, hi in zip(edges[:-1], edges[1:])],
                    axis=1).astype(np.float64)


def vocoded_leg(fed: np.ndarray, car, t0: int, n: int, cfg: dict, prec: Precision,
                device) -> np.ndarray:
    """The vocoder's output mix at samples [t0, t0 + n). `car(a, b)`: the
    carrier's samples [a, b) (host float64)."""
    v, sr = cfg["vocoder"], cfg["sample_rate"]
    S, W = v["stride"], v["window"]
    lag = 2 * S - 1
    out = np.zeros(n)
    c_lo, c_hi = max(0, (t0 - lag) // S), (t0 + n - 1 - lag) // S
    if c_hi >= 0:
        dt = prec.dtype
        cs = np.arange(max(0, c_lo - 1), c_hi + 1)
        base = cs[0] * S
        cars = car(base, (cs[-1] + 2) * S)
        frames = torch.as_tensor(np.stack([cars[c * S - base:c * S - base + 2 * S] for c in cs]),
                                 device=device).to(dt)
        js = cs + (2 * S - W) // S
        nfft_m = analysis.fft_length(W)
        w = torch.as_tensor(analysis.gaussian_window(W), device=device).to(dt)
        scale = 2.0 / math.sqrt(nfft_m * float((analysis.gaussian_window(W) ** 2).sum()))
        amps = torch.zeros((len(cs), len(v["edges"]) - 1), dtype=dt, device=device)
        ok = np.nonzero(js >= 0)[0]
        if len(ok):
            mod = torch.as_tensor(np.stack([fed[j * S:j * S + W] for j in js[ok]]),
                                  device=device).to(dt)
            spec = torch.fft.rfft(prec.fft_in(mod * w), n=nfft_m)
            sq = ((spec.real ** 2 + spec.imag ** 2) * scale ** 2).to(dt)
            bm = torch.as_tensor(_band_bins(v["edges"], nfft_m, sr), device=device)
            amps[ok] = torch.sqrt(prec.matmul(sq, bm))
        nfft_c = analysis.fft_length(2 * S)
        bc = torch.as_tensor(_band_bins(v["edges"], nfft_c, sr).T, device=device)
        spec = torch.fft.rfft(prec.fft_in(frames), n=nfft_c)
        sig = torch.fft.irfft(spec * prec.fft_in(prec.matmul(amps, bc)),
                              n=nfft_c)[:, :2 * S].to(dt)
        k = torch.arange(S, dtype=dt, device=device)
        w_new = (k + 1.0) / S
        old = torch.cat([sig.new_zeros((1, S)), sig[:-1, S:]]) if cs[0] == 0 else sig[:-1, S:]
        new = sig[:, :S] if cs[0] == 0 else sig[1:, :S]
        first = cs[0] if cs[0] == 0 else cs[0] + 1
        voc = (new * w_new + old * (1.0 - w_new)).reshape(-1).double().cpu().numpy()
        p0 = lag + first * S
        lo, hi = max(t0, p0), min(t0 + n, p0 + len(voc))
        out[lo - t0:hi - t0] = voc[lo - p0:hi - p0]
    out = v["vol_voc"] * out
    if v["vol_mod"]:
        out += v["vol_mod"] * fed[t0:t0 + n]
    if v["vol_car"]:
        out += v["vol_car"] * car(t0, t0 + n)
    return out


# -- a side's outputs, and the comparison --------------------------------------

def n_windows(n_fed: int, cfg: dict) -> int:
    return max(0, (n_fed - cfg["window"]) // cfg["stride"] + 1)


def _window_peaks(fed: np.ndarray, n_fed: int, cfg: dict, prec: Precision, device):
    return analysis.peaks(torch.as_tensor(fed[:n_fed], device=device), window=cfg["window"],
                          stride=cfg["stride"], sample_rate=cfg["sample_rate"], prec=prec)


def outputs(fed: np.ndarray, n_fed: int, callbacks: list[int], cfg: dict, prec: Precision,
            device) -> dict:
    """What the program hands the check for a stream of n_fed samples and
    its sampled callbacks, computed by the reference in `prec`."""
    blk = cfg["block"]
    m = n_windows(n_fed, cfg)
    freq, mag = top_peaks(_window_peaks(fed, n_fed, cfg, prec, device), m,
                          cfg["peaks_per_frame"])
    lists = _peak_lists(freq, mag)
    notes, dropped = tracker.track(lists, cfg["tracker"])
    pulls = sorted(i * blk for i in callbacks)
    events, snaps, syn_dropped = replay(notes, m, cfg, pulls)
    cbs = []
    for i in callbacks:
        t0 = i * blk
        car_blocks = [(a, carrier(cfg, a, blk, prec))
                      for a in range(max(0, t0 - 3 * blk), t0 + 1, blk)]
        side = dict(car_blocks)

        def car(a, b):
            return np.concatenate([side[x] if x in side else carrier(cfg, x, blk, prec)
                                   for x in range(a - a % blk, b, blk)])[a % blk:a % blk + b - a]

        voc = vocoded_leg(fed, car, t0, blk, cfg, prec, device)
        syn = render_block(snaps[t0], t0, blk, cfg, prec, device).double().cpu().numpy()
        cbs.append(dict(index=i, synth=syn, vocoded=voc, carrier=car_blocks))
    return dict(n_fed=n_fed, peaks=lists, events=events, dropped=(dropped, syn_dropped),
                callbacks=cbs)


def _rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return math.inf
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def compare(fed: np.ndarray, got: dict, cfg: dict, device):
    """(whole-stream numbers, [per sampled callback numbers], info) of `got`."""
    f64 = Precision("float64")
    blk, n_fed = cfg["block"], got["n_fed"]
    m = n_windows(n_fed, cfg)
    k = cfg["peaks_per_frame"]
    lists = got["peaks"]
    if len(lists) != m:
        peak_gap = 999.0
    else:
        freq = np.zeros((m, k))
        mag = np.full((m, k), -np.inf)
        for f, peaks in enumerate(lists):
            if peaks:
                freq[f, :len(peaks)], mag[f, :len(peaks)] = np.array(peaks).T
        nfft = analysis.fft_length(cfg["window"])
        peak_gap = analysis.peak_gap_db(
            _window_peaks(fed, n_fed, cfg, f64, device), freq, mag,
            bin_hz=cfg["sample_rate"] / nfft, fft_bins=nfft // 2 + 1, span_db=SPAN_DB,
            floor_db=FLOOR_DB, rank_margin_db=RANK_MARGIN_DB)
    cbs = got["callbacks"]
    pulls = sorted(c["index"] * blk for c in cbs)
    snaps, dropped, syn_dropped, taken, met = follow(lists, got["events"], cfg, pulls)
    stream = dict(peak_db_gap=peak_gap,
                  dropped_gap=float(abs(got["dropped"][0] - dropped)
                                    + abs(got["dropped"][1] - syn_dropped)),
                  knife_edges=taken)
    per, car_taken = [], 0
    for c in cbs:
        t0 = c["index"] * blk

        def car(a, b, side=c["carrier"]):
            nonlocal car_taken
            samples, n_taken = followed_carrier(cfg, a, b - a, side)
            car_taken += n_taken
            return samples

        want_voc = vocoded_leg(fed, car, t0, blk, cfg, f64, device)
        want_syn = render_block(snaps[t0], t0, blk, cfg, f64, device).cpu().numpy()
        per.append(dict(index=c["index"], resynth_gap=_rel_gap(np.asarray(c["synth"]), want_syn),
                        vocoded_gap=_rel_gap(np.asarray(c["vocoded"]), want_voc)))
    info = dict(windows=m, knife_edges_met=met, carrier_edges_taken=car_taken,
                notes_at_pulls=[len(snaps[p]) for p in pulls])
    return stream, per, info
