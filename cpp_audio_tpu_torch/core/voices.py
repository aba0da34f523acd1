"""Voice scheduling: notes -> dense SoA schedules for the batched kernels.

The reference manages a fixed pool of voice objects with a lock-free CAS
acquisition protocol (ImplCRTP, include/gen.crtp.h:195-629; envelope-state CAS
at include/audioelement.h:354-399) because real-time threads can't allocate.
On TPU the analog is a dense schedule: every note is a row in SoA arrays
(press/release/frequency/velocity/pan/phase), padded to a static row count so
the kernel shape is stable. Polyphony limits become an explicit host-side
filter (`enforce_polyphony`) that drops notes exactly when the reference's
pool would have (`onDroppedNote`, gen.crtp.h:412-413,625-628).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .events import Note

NEVER = float(2**62)


@dataclass
class NoteSchedule:
    """SoA note schedule. All arrays have shape (n_rows,); rows beyond
    `n_notes` are inert padding (velocity 0, press NEVER)."""

    press: np.ndarray      # float64, absolute sample of first attack sample
    release: np.ndarray    # float64, absolute sample of release start (NEVER if none)
    frequency: np.ndarray  # float64 Hz
    velocity: np.ndarray   # float64 0..1
    pan: np.ndarray        # float64 -1..1
    phase: np.ndarray      # float64 start angle (rad/pi)
    n_notes: int

    @property
    def n_rows(self) -> int:
        return len(self.press)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def schedule_from_notes(notes: list[Note], *, pad_to: int = 128,
                        default_phase: str = "zero", seed: int = 0) -> NoteSchedule:
    """Build a padded NoteSchedule from resolved notes.

    default_phase: 'zero' or 'random' — the reference's DefaultStartPhase
    policy (setPhase, gen.crtp.h:127-156). Phase synchronization against
    same-frequency active voices (SynchronizePhase::Yes) is implemented by
    matching the phase origin: voices at equal frequency started at different
    times get a start angle that aligns them, see `synchronize_phases`.
    """
    n = len(notes)
    rows = max(pad_to, round_up(max(n, 1), pad_to))
    press = np.full(rows, NEVER)
    release = np.full(rows, NEVER)
    freq = np.full(rows, 1.0)
    vel = np.zeros(rows)
    pan = np.zeros(rows)
    phase = np.zeros(rows)
    rng = np.random.default_rng(seed)
    for i, note in enumerate(notes):
        press[i] = note.press
        release[i] = note.release
        freq[i] = note.frequency
        vel[i] = note.velocity
        pan[i] = note.pan
        ph = getattr(note, "phase", None)
        if ph is not None:
            phase[i] = ph
        elif default_phase == "random":
            phase[i] = rng.uniform(0.0, 2.0)
    return NoteSchedule(press, release, freq, vel, pan, phase, n)


def synchronize_phases(s: NoteSchedule, sample_rate: int) -> NoteSchedule:
    """SynchronizePhase::Yes policy: a voice starting while another voice of
    the same frequency is active adopts an aligned angle so they don't
    phase-cancel (reference setPhase, gen.crtp.h:127-156).

    With our absolute-time phase model phase(t) = phase0 + (t - press + 1)*inc,
    alignment means phase0_new = phase0_old + (press_new - press_old) * inc.

    O(n log n): notes group by frequency and sweep in press order (live
    noteOns arrive press-ordered). Alignment is TRANSITIVE — a note aligned
    to any member of an overlapping chain carries the same phase clock as
    the chain's anchor — so tracking one (anchor, max_release) per open
    chain reproduces the reference's first-active-voice scan exactly.
    """
    phase = s.phase.copy()
    inc = 2.0 * s.frequency / sample_rate
    order = np.argsort(s.press[: s.n_notes], kind="stable")
    # frequency groups within 1e-9 tolerance via sorted runs
    freq_order = np.argsort(s.frequency[: s.n_notes], kind="stable")
    fsorted = s.frequency[freq_order]
    group = np.zeros(s.n_notes, dtype=np.int64)
    if s.n_notes:
        group[freq_order] = np.cumsum(
            np.concatenate([[0], (np.diff(fsorted) > 1e-9).astype(np.int64)]))
    chains: dict[int, tuple[int, float]] = {}  # group -> (anchor_idx, max_rel)
    for i in order:
        g = int(group[i])
        chain = chains.get(g)
        if chain is not None and s.press[i] < chain[1]:
            j = chain[0]
            phase[i] = np.mod(
                phase[j] + (s.press[i] - s.press[j]) * inc[i], 2.0)
            chains[g] = (j, max(chain[1], float(s.release[i])))
        else:
            chains[g] = (int(i), float(s.release[i]))
    return NoteSchedule(s.press, s.release, s.frequency, s.velocity, s.pan, phase, s.n_notes)


def enforce_polyphony(notes: list[Note], n_voices: int,
                      release_tail: float = 0.0) -> tuple[list[Note], int]:
    """Drop notes that the reference's fixed pool would have dropped.

    A voice stays busy from press until release + release_tail (the envelope
    release keeps the voice RT-active until Done2). Returns (kept, n_dropped).
    """
    ends: list[float] = []  # active voice end times
    kept: list[Note] = []
    dropped = 0
    for note in sorted(notes, key=lambda n: n.press):
        ends = [e for e in ends if e > note.press]
        if len(ends) < n_voices:
            ends.append(min(note.release + release_tail, NEVER))
            kept.append(note)
        else:
            dropped += 1
    return kept, dropped
