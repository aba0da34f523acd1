"""Streaming polyphonic synth: the ImplCRTP event interface over the
voice-bank kernel, for block-by-block (realtime-style) rendering.

Reference: ImplCRTP::onEvent + compute (include/gen.crtp.h:195-629). Events
arrive between blocks; each block renders the currently-active bank rows with
the same closed-form kernel as the offline path, shifted so the block starts
at the engine time. Voice stealing follows the reference's CHANNEL-OCCUPANCY
rule: the pool holds n_channels = 2 * n_voices channels (gen.crtp.h:
221-225), a NoteOn acquires any channel whose envelope reached Done2
(tryAcquire, gen.crtp.h:398-413), and a channel stays occupied through its
whole release (until the envelope finishes: release + max(R, the
2.5-period anti-crack floor)); a NoteOn finding every channel occupied is
dropped and counted (onDroppedNote).

Known live-path delta: a NOTE_CHANGE velocity lands as a step at the next
block boundary, where the reference low-passes the volume target with a
one-period time constant (VolumeAdjusted, audioelement.h:1159-1216).
Frequency retunes ARE phase-continuous (voicebank.retuned_phase0).

Port of cpp_audio_tpu/models/streaming_synth.py. Every pulled block renders
through voicebank.render_bank, so on a CUDA device each pull launches the
voice-bank kernel once (one block of n samples, press and release shifted by
-t0: a note held since long before t0 reaches the kernel with a large
negative press); on the CPU the kernel's plain version renders it. Under a
torch profiler a pull is the span `live_synth` (the bank's build, its
tables' upload and the kernel's dispatch), and the uploads count in
utils/profiling.LIVE_WAITS.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import voices as voices_mod
from ..core.events import Event, EventType
from ..device import HostPickled, dtype_of
from ..utils import profiling
from ..utils.profiling import span
from . import sine_synth, voicebank

# the host tables voicebank.prepare_bank_arrays uploads: fp, ip, up, gains, codes
_BANK_TABLES = 5


@dataclass
class _Active:
    note_id: int
    press: int
    release: float
    frequency: float
    velocity: float
    pan: float
    finished_at: float = voicebank.NEVER  # envelope Done2 sample
    phase0: float = 0.0     # start angle at press (rad/pi)


class StreamingSynth(HostPickled):
    """Event-driven synth compute (on_event + compute(t0, n))."""

    def __init__(self, config: sine_synth.SineSynthConfig | None = None,
                 n_voices: int = 32, *, device="cuda"):
        self.config = config or sine_synth.SineSynthConfig()
        self.n_voices = n_voices
        self.device = torch.device(device)
        self._notes: dict[int, _Active] = {}
        self._finished: list[_Active] = []  # releasing, kept until env done
        self.dropped_note_on = 0

    # after the release completes, the envelope sits in EnvelopeDone1 for
    # n_frames_per_buffer + 1 = 17 more steps before Done2 makes the channel
    # acquirable (audioelement.h:744-749; n_frames_per_buffer = 16,
    # audioelement.h:3)
    _DONE1_TO_DONE2 = 17

    def _release_length(self, frequency: float) -> float:
        """Samples from onKeyReleased to the channel becoming acquirable:
        max(R, 2.5-period anti-crack floor) release steps (getReleaseTime,
        audioelement.h:1003-1005) + the Done1->Done2 window."""
        cfg = self.config
        inc = 2.0 * abs(frequency) / cfg.sample_rate
        floor = np.floor(0.5 + 2.5 * 2.0 / max(inc, 1e-9))
        return max(float(np.max(np.asarray(cfg.ahdsr.release))), floor,
                   1.0) + self._DONE1_TO_DONE2

    # --- event interface (reference onEvent) ---
    def on_event(self, ev: Event) -> bool:
        if ev.type is EventType.NOTE_ON:
            # channel-occupancy drop (gen.crtp.h:398-413): releasing voices
            # still occupy their channel until the envelope reaches Done2
            self._gc(ev.time)
            if len(self._notes) + len(self._finished) >= 2 * self.n_voices:
                self.dropped_note_on += 1
                return False
            self._notes[ev.note_id] = _Active(
                ev.note_id, ev.time, voicebank.NEVER, ev.frequency, ev.velocity,
                ev.pan,
            )
            return True
        if ev.type is EventType.NOTE_OFF:
            a = self._notes.pop(ev.note_id, None)
            if a is None:
                return False
            a.release = ev.time
            a.finished_at = ev.time + self._release_length(a.frequency)
            self._finished.append(a)
            return True
        # NOTE_CHANGE: phase-continuous retune (the reference's
        # setAngleIncrements path, gen.crtp.h:595-618): the kernel renders
        # phase from the press sample, so an in-place frequency change
        # would rewrite the whole phase history; compensate via the start
        # angle instead
        a = self._notes.get(ev.note_id)
        if a is None:
            return False
        sr = self.config.sample_rate
        a.phase0 = voicebank.retuned_phase0(
            a.press, ev.time, a.phase0,
            2.0 * a.frequency / sr, 2.0 * ev.frequency / sr)
        a.frequency = ev.frequency
        a.velocity = ev.velocity
        return True

    def _gc(self, t: int) -> None:
        # channel freed exactly when its envelope finished (Done2)
        self._finished = [a for a in self._finished if a.finished_at > t]

    def bank_at(self, t0: int) -> voicebank.VoiceBank | None:
        """The bank a pull at t0 renders (None when no voice sounds):
        the active rows, padded to a multiple of 8, with press and release
        shifted so the kernel's block 0 starts at t0."""
        self._gc(t0)
        active = list(self._notes.values()) + self._finished
        if not active:
            return None
        sched = voices_mod.schedule_from_notes(
            [type("N", (), dict(press=a.press, release=a.release,
                                frequency=a.frequency, velocity=a.velocity,
                                pan=a.pan, phase=a.phase0))() for a in active],
            pad_to=8,
        )
        sched.press -= t0
        sched.release = np.where(sched.release < voices_mod.NEVER / 2,
                                 sched.release - t0, sched.release)
        return sine_synth.bank_from_schedule(sched, self.config)

    def compute(self, t0: int, n: int) -> torch.Tensor:
        """Render [t0, t0+n) -> (n, n_channels) tensor on the synth's
        device, in the config's dtype."""
        with span("live_synth", self.device):
            bank = self.bank_at(t0)
            if bank is None:
                return torch.zeros((n, self.config.n_channels),
                                   dtype=dtype_of(self.config.dtype), device=self.device)
            profiling.LIVE_WAITS += _BANK_TABLES
            return voicebank.render_bank(bank, n, block_size=n, dtype=self.config.dtype,
                                         device=self.device)
