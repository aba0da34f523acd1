"""Note deduction + visualization (the `resynth` app, source/main.resynth.cpp).

Reference flow: WAV -> deduceNotesSlow (cpp.algorithms) -> filter notes by dB
span -> draw a notes BMP -> resynth() to WAV (main.resynth.cpp:5-88). The
deduction reuses the framework's analysis chain (device STFT + peak tracking
on the host); `write_bmp` emits a piano-roll BMP (pure-python BMP writer).

Port of cpp_audio_tpu/analysis/notes.py: the analysis runs on `device`, and
`resynth_deduced` renders through sine_synth.render_schedule, so through the
voice-bank kernel on a card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.events import Note
from ..core.voices import schedule_from_notes
from ..models import resynth_bank, sine_synth
from ..ops import envelopes
from ..utils.midi import Midi
from . import resynth as rs


@dataclass
class DeducedNote:
    """A deduced note (cpp.algorithms `DeducedNote` analog)."""

    midi_pitch: float
    frequency: float
    start_sample: int
    end_sample: int
    volume: float


def deduce_notes(signal, sample_rate: int = 44100, *,
                 min_db_span: float = -60.0,
                 config: rs.ResynthConfig | None = None,
                 device="cuda") -> list[DeducedNote]:
    """Deduce discrete notes from a mono signal (analysis on `device`).

    min_db_span filters out notes whose peak volume is more than |min_db_span|
    dB below the loudest note (main.resynth.cpp's dB-span filter).
    """
    cfg = config or rs.ResynthConfig(sample_rate=sample_rate, analysis_volume=1.0)
    cfg.sample_rate = sample_rate
    peaks = rs.analyze(np.asarray(signal, np.float64), cfg, device=device)
    tracked, _, _ = rs.track(peaks, cfg)
    midi = Midi()
    S = cfg.stride
    W = cfg.window_size
    out = []
    for tn in tracked:
        f0 = tn.frames[0][0]
        f1 = tn.release_frame if tn.release_frame < resynth_bank.NEVER_FRAME \
            else (len(peaks))
        vol = max(v for _, _, v in tn.frames)
        freq = tn.frames[0][1]
        out.append(DeducedNote(
            midi_pitch=float(midi.frequency_to_midi_pitch(freq)),
            frequency=freq,
            start_sample=W + f0 * S,
            end_sample=W + f1 * S,
            volume=vol,
        ))
    if out:
        vmax = max(n.volume for n in out)
        thr = vmax * 10.0 ** (min_db_span / 20.0)
        out = [n for n in out if n.volume >= thr]
    out.sort(key=lambda n: n.start_sample)
    return out


def notes_image(notes: list[DeducedNote], *, width: int = 800,
                pitch_range: tuple[float, float] | None = None) -> np.ndarray:
    """Piano-roll grayscale image (rows = pitch, cols = time), brightness =
    volume (the reference draws a notes BMP, main.resynth.cpp)."""
    if not notes:
        return np.zeros((1, width), np.uint8)
    t1 = max(n.end_sample for n in notes)
    if pitch_range is None:
        lo = int(np.floor(min(n.midi_pitch for n in notes))) - 1
        hi = int(np.ceil(max(n.midi_pitch for n in notes))) + 1
    else:
        lo, hi = int(pitch_range[0]), int(pitch_range[1])
    h = max(hi - lo + 1, 2)
    img = np.zeros((h, width))
    vmax = max(n.volume for n in notes)
    for n in notes:
        r = min(max(hi - int(round(n.midi_pitch)), 0), h - 1)
        c0 = int(n.start_sample / max(t1, 1) * (width - 1))
        c1 = max(c0 + 1, int(n.end_sample / max(t1, 1) * (width - 1)))
        img[r, c0:c1] = np.maximum(img[r, c0:c1], n.volume / vmax)
    return (img * 255).astype(np.uint8)


def write_bmp(path, gray: np.ndarray) -> None:
    """Minimal 8-bit grayscale BMP writer (palette BMP, bottom-up rows)."""
    import struct

    h, w = gray.shape
    row_size = (w + 3) & ~3
    pixel_bytes = row_size * h
    palette = b"".join(struct.pack("<BBBB", i, i, i, 0) for i in range(256))
    header_size = 14 + 40 + len(palette)
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", header_size + pixel_bytes, 0, 0, header_size))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, pixel_bytes,
                            2835, 2835, 256, 0))
        f.write(palette)
        pad = b"\x00" * (row_size - w)
        for r in range(h - 1, -1, -1):
            f.write(gray[r].tobytes() + pad)


def resynth_deduced(notes: list[DeducedNote], n_samples: int | None = None,
                    sample_rate: int = 44100, *, stride: int = 0,
                    device="cuda") -> torch.Tensor:
    """Re-synthesize deduced notes with enveloped sines (include/resynth.hpp:
    AHDSR 1000/0/1000/10000 frames, sustain 0.7, mono output) -> an
    (n_samples, 1) tensor on `device`.

    The reference releases each voice `stride + end - start` samples after
    the press (resynth.hpp:97 — one extra analysis stride of sustain);
    volumes are applied UNCLAMPED as linear targets (DbToMag of the deduced
    dB amplitude, resynth.hpp:88). With n_samples=None the render drains
    every envelope like the reference's final `while(!recordFrame())`.

    Oscillator-slot reuse carries PHASE: `SineOscillatorAlgo::
    forgetPastSignals()` is a no-op (audioelement.h:2388), so a note played
    on a reused pool slot starts at the stale angle where the previous note
    froze. A voice steps while RT-active — press through release delay +
    max(R, 2.5-period floor) release steps + the 17-step Done1->Done2
    window (audioelement.h:702-756) — and its slot is acquirable from the
    following frame; the simulation below replays that slot policy and
    angle accumulation exactly."""
    R = 10000
    slots: list[list[float]] = []  # [first_reusable_frame, stale_phase]
    ordered = sorted(range(len(notes)), key=lambda i: notes[i].start_sample)
    phases = [0.0] * len(notes)
    for i in ordered:
        n = notes[i]
        press = n.start_sample
        delay = stride + (n.end_sample - n.start_sample)
        inc = 2.0 * n.frequency / sample_rate
        min_change = int(0.5 + 2.5 * (2.0 / max(inc, 1e-12)))
        steps = delay + max(R, min_change, 1) + 17
        for slot in slots:
            if slot[0] <= press:  # first !isEnvelopeRTActive (resynth.hpp:19)
                break
        else:
            slot = [0, 0.0]
            slots.append(slot)
        phases[i] = slot[1]
        slot[0] = press + steps
        slot[1] = (slot[1] + inc * steps) % 2.0

    ev = [Note(i + 1, n.start_sample, n.end_sample + stride, n.frequency,
               n.volume * 10.0, 0.0,  # /baseVolume(0.1) net = volume
               phase=phases[i])
          for i, n in enumerate(notes)]
    cfg = sine_synth.SineSynthConfig(
        sample_rate=sample_rate,
        ahdsr=envelopes.AHDSR(attack=1000, hold=0, decay=1000, release=10000,
                              sustain=0.7),
        n_channels=1,
    )
    if n_samples is None:
        last = max((n.end_sample + stride for n in notes), default=0)
        n_samples = last + 10000 + 2048  # release + min-change margin
    sch = schedule_from_notes(ev, pad_to=8)
    return sine_synth.render_schedule(sch, n_samples, cfg, device=device)
