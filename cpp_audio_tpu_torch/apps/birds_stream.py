"""Streaming Birds engine facade — the WASM/AudioWorklet demo analog.

Reference (source/unity.build.birds.lib.cpp:47-240 + docs/js/*): an embind
class `Birds{ctor(sample_rate, synth_type), maxCountPrograms, useProgram,
process(in, out), teardown}` renders 128-frame AudioWorklet quanta; a program
change performs noteOff + noteOn (unity.build.birds.lib.cpp:150-170).

Here the procedural schedule renders lazily in chunks: each noteOn builds the
Markov spec schedule (host) and the device renders it once; `process` then
serves quanta from the rendered buffer, re-rendering on program change.

Port of cpp_audio_tpu/apps/birds_stream.py: each render runs on `device`
and is copied to the host once; quanta are then served from that host
buffer, with no device work and no synchronisation per quantum.
"""

from __future__ import annotations

import numpy as np

from ..models import soundengine, voice_presets, wind

WORKLET_QUANTUM = 128  # frames (reference unity.build.birds.lib.cpp:47)


class Birds:
    def __init__(self, sample_rate: int = 44100, mode: str = "birds",
                 render_seconds: float = 10.0, n_channels: int = 2, *,
                 device="cuda"):
        self.device = device
        self.sample_rate = sample_rate
        self.mode = voice_presets.Mode(mode)
        self.n_channels = n_channels
        self.render_seconds = render_seconds
        self._buf: np.ndarray | None = None
        self._pos = 0
        self._program = 0
        self._seed = 1
        self._alive = True

    def max_count_programs(self) -> int:
        return len(voice_presets.PROGRAMS[self.mode])

    def use_program(self, index: int) -> None:
        """Program change = noteOff + noteOn (re-render the schedule)."""
        assert self._alive
        self._program = index % self.max_count_programs()
        self._seed += 1
        self._render()

    def note_on(self, freq: float = 440.0) -> None:
        self._freq = freq
        self._render()

    def _render(self) -> None:
        prog = voice_presets.PROGRAMS[self.mode][self._program]
        n = int(self.render_seconds * self.sample_rate)
        freq = getattr(self, "_freq", 440.0)
        if self.mode is voice_presets.Mode.WIND:
            out = wind.render_program(prog, n, self.sample_rate, seed=self._seed,
                                      n_channels=self.n_channels, device=self.device)
        else:
            out = soundengine.render_program(prog, freq, n, self.sample_rate,
                                             seed=self._seed,
                                             n_channels=self.n_channels,
                                             device=self.device)
        self._buf = out.cpu().numpy()
        self._pos = 0

    def process(self, n_frames: int = WORKLET_QUANTUM) -> np.ndarray:
        """Serve the next audio quantum (loops the rendered schedule)."""
        assert self._alive
        if self._buf is None:
            self._render()
        out = np.zeros((n_frames, self.n_channels))
        done = 0
        while done < n_frames:
            avail = len(self._buf) - self._pos
            if avail == 0:
                self._seed += 1  # replay with fresh randomness
                self._render()
                avail = len(self._buf)
            take = min(avail, n_frames - done)
            out[done : done + take] = self._buf[self._pos : self._pos + take]
            self._pos += take
            done += take
        return out

    def teardown(self) -> None:
        self._alive = False
        self._buf = None
