"""One offline job through the plain chain, and the comparison that
decides `correct`.

`outputs(job, cfg, prec)` is the reference put in the program's place: the
job's voices -> the mixdown -> its top analysis peaks -> the tracker -> the
slot table -> the render, and the vocoder of the mixdown. With prec
"lower" it is the control (precision.py).

`compare(job, got, cfg)` judges what one side produced for a job, against
the float64 reference, in four numbers:
  peak_db_gap    the widest level gap in dB between the reference's own
                 analysis peaks and the side's (synth and analysis), over
                 the peaks within SPAN_DB of each frame's loudest and
                 above FLOOR_DB
  vocoded_gap    max |vocoded - reference| / max |reference| (synth and
                 vocoder)
  resynth_gap    max |stereo - reference| / max |reference| (tracker and
                 render), where the reference tracks the side's own peaks:
                 float32 peaks differ from float64 ones below the noise
                 floor, and a tracker fed different peaks plays different
                 notes, so this stage follows the side from its peaks, which
                 peak_db_gap has held against the reference's
  dropped_gap    |dropped note-ons - the reference tracker's|
The reference follows a side's knife-edge decisions (follow(): a
comparison within float32's reach of its threshold may go either way in a
float32 tracker), at most cfg["max_flips"] a job; compare() reports how
many it took, and how many knife-edges it met, under "info".
"""

from __future__ import annotations

import numpy as np
import torch

from . import analysis, render, synth, tracker, vocoder
from .precision import Precision

SPAN_DB = 50.0
FLOOR_DB = -80.0  # a unit sine reads 0 dB; the takes' voices -40 to -20 dB
RANK_MARGIN_DB = 1.0
LOCATE = 0.05      # a control frame this far apart (share of the peak) marks a parting
LOOKBACK = 16      # frames before a parting searched for the knife-edge behind it
MAX_TRIALS = 32


def _mono(job: dict, cfg: dict, prec: Precision, device) -> torch.Tensor:
    return synth.render(job["voices"], job["n"], prec, device).sum(dim=1)


def top_peaks(ref, n_frames: int, k: int):
    """The k loudest of each frame's peaks (the earliest winning ties), in
    frequency order, as (n_frames, k) freq and level arrays, level -inf
    where a frame has fewer."""
    fr, hz, db = ref
    freq = np.zeros((n_frames, k))
    mag = np.full((n_frames, k), -np.inf)
    for f in range(n_frames):
        sel = np.nonzero(fr == f)[0]
        pick = np.sort(sel[np.argsort(-db[sel], kind="stable")[:k]])
        freq[f, :len(pick)] = hz[pick]
        mag[f, :len(pick)] = db[pick]
    return freq, mag


def _peak_lists(freq: np.ndarray, mag: np.ndarray):
    ok = np.isfinite(mag)
    return [list(zip(freq[f][ok[f]].astype(np.float64).tolist(),
                     mag[f][ok[f]].astype(np.float64).tolist()))
            for f in range(freq.shape[0])]


def resynth(freq: np.ndarray, mag: np.ndarray, cfg: dict, prec: Precision, device,
            dec: tracker.Decisions | None = None):
    """Tracker -> slot table -> render of (n_frames, k) peaks: ((T, 2)
    stereo on `device`, dropped note-ons)."""
    tr = cfg["tracker"]
    notes, dropped = tracker.track(_peak_lists(freq, mag), tr, dec)
    table = tracker.slot_table(notes, freq.shape[0] + tr["tail_frames"], tr)
    framed = render.render(torch.as_tensor(table, device=device), stride=tr["stride"],
                           prec=prec)
    flat = framed.reshape(-1, 2)
    return torch.nn.functional.pad(flat, (0, 0, cfg["window"] - 1, 0)), dropped


def _first_apart(got: np.ndarray, want: np.ndarray, cfg: dict):
    """The first control frame whose samples differ by more than LOCATE of
    the reference's peak, or None."""
    if got.shape != want.shape:
        return None
    S, start = cfg["stride"], cfg["window"] - 1
    body = np.abs(got[start:] - want[start:]).reshape(-1, S * 2).max(axis=1)
    far = np.nonzero(body > LOCATE * max(float(np.abs(want).max()), 1e-30))[0]
    return int(far[0]) if len(far) else None


def follow(freq: np.ndarray, mag: np.ndarray, got_stereo: np.ndarray, cfg: dict, device):
    """The reference's resynthesis of a side's peaks, with the knife-edge
    decisions (tracker.Decisions) resolved as the side's output shows:
    where the outputs part, each knife-edge of the LOOKBACK frames before
    is tried on the other side, latest first, and kept if the outputs then
    part later, up to cfg["max_flips"] of them. Returns (stereo (host), dropped,
    knife-edges taken, knife-edges met)."""
    prec = Precision("float64")
    flips = frozenset()
    dec = tracker.Decisions(flips)
    stereo, dropped = resynth(freq, mag, cfg, prec, device, dec)
    stereo = stereo.cpu().numpy()
    apart = _first_apart(got_stereo, stereo, cfg)
    trials = 0
    while apart is not None and trials < MAX_TRIALS and len(flips) < cfg["max_flips"]:
        cands = sorted({e for e in dec.edges if apart - LOOKBACK <= e[0] <= apart} - flips,
                       key=lambda e: -e[0])
        for c in cands[:MAX_TRIALS - trials]:
            trials += 1
            d2 = tracker.Decisions(flips | {c})
            s2, dr2 = resynth(freq, mag, cfg, prec, device, d2)
            s2 = s2.cpu().numpy()
            a2 = _first_apart(got_stereo, s2, cfg)
            if a2 is None or a2 > apart:
                flips, dec, stereo, dropped, apart = flips | {c}, d2, s2, dr2, a2
                break
        else:
            break
    return stereo, dropped, len(flips), len(dec.edges)


def outputs(job: dict, cfg: dict, prec: Precision, device) -> dict:
    """What the chain returns for `job`, computed by the reference in
    `prec`: {"freq", "mag", "stereo", "vocoded", "dropped"} (host arrays)."""
    mono = _mono(job, cfg, prec, device)
    n_frames = max(0, (job["n"] - cfg["window"]) // cfg["stride"] + 1)
    ref = analysis.peaks(mono, window=cfg["window"], stride=cfg["stride"],
                         sample_rate=cfg["sample_rate"], prec=prec)
    freq, mag = top_peaks(ref, n_frames, cfg["peaks_per_frame"])
    stereo, dropped = resynth(freq, mag, cfg, prec, device)
    voc = vocoder.vocode(mono, torch.as_tensor(job["carrier"], device=device),
                         cfg["vocoder"], prec)
    return dict(freq=freq, mag=mag, stereo=stereo.double().cpu().numpy(),
                vocoded=voc.double().cpu().numpy(), dropped=int(dropped))


def _rel_gap(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    peak = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / max(peak, 1e-30)


def compare(job: dict, got: dict, cfg: dict, device) -> dict:
    """The four numbers of `got` (a side's outputs for `job`), and "info"."""
    prec = Precision("float64")
    mono = _mono(job, cfg, prec, device)
    ref = analysis.peaks(mono, window=cfg["window"], stride=cfg["stride"],
                         sample_rate=cfg["sample_rate"], prec=prec)
    bin_hz = cfg["sample_rate"] / analysis.fft_length(cfg["window"])
    peak_gap = analysis.peak_gap_db(ref, np.asarray(got["freq"]), np.asarray(got["mag"]),
                                    bin_hz=bin_hz, fft_bins=analysis.fft_length(cfg["window"]) // 2 + 1,
                                    span_db=SPAN_DB,
                                    floor_db=FLOOR_DB, rank_margin_db=RANK_MARGIN_DB)
    voc = vocoder.vocode(mono, torch.as_tensor(job["carrier"], device=device),
                         cfg["vocoder"], prec).cpu().numpy()
    del mono
    got_stereo = np.asarray(got["stereo"])
    stereo, dropped, flips, edges = follow(np.asarray(got["freq"], np.float64),
                                           np.asarray(got["mag"], np.float64), got_stereo,
                                           cfg, device)
    return dict(peak_db_gap=peak_gap,
                vocoded_gap=_rel_gap(got["vocoded"], voc),
                resynth_gap=_rel_gap(got_stereo, stereo),
                dropped_gap=float(abs(int(got["dropped"]) - dropped)),
                info=dict(knife_edges_taken=flips, knife_edges_met=edges))
