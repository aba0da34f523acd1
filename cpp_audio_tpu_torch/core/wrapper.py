"""Plugin-host-style harness (reference `Wrapper<T, ReverbT>`,
include/gen.crtp.h:632-670): owns a stepper + a synth, exposes the
block-processing entry a VST-like host would call.

Here it bundles an AudioEngine with a StreamingSynth and the post chain,
giving external hosts a single `process(events, n_frames) -> block` call
with sample-accurate event application (events.impl.h block splitting: the
synth's closed-form kernels honour exact press/release samples, so no manual
block splitting is needed).

Port of cpp_audio_tpu/core/wrapper.py: the synth and the engine run on
`device`; on a card each `process` with sounding voices launches the
voice-bank kernel once (StreamingSynth.compute), and the block comes back
as a float64 tensor on `device`.
"""

from __future__ import annotations

import torch

from ..models import sine_synth, streaming_synth
from . import engine as eng
from .events import Event


class Wrapper:
    def __init__(self, config: sine_synth.SineSynthConfig | None = None,
                 n_voices: int = 32, with_limiter: bool = True, *, device="cuda"):
        self.config = config or sine_synth.SineSynthConfig()
        self.synth = streaming_synth.StreamingSynth(self.config, n_voices=n_voices,
                                                    device=device)
        self.engine = eng.AudioEngine(self.config.sample_rate,
                                      self.config.n_channels, device=device)
        self.engine.register_compute(self.synth.compute)
        if with_limiter:
            self.engine.post.add(eng.StreamingLimiter(
                sample_rate=self.config.sample_rate, device=device))
        self.engine.post.add(eng.clamp_guard)

    def process(self, events: list[Event], n_frames: int) -> torch.Tensor:
        """Apply this block's events and render n_frames."""
        for ev in events:
            self.synth.on_event(ev)
        return self.engine.step(n_frames)

    @property
    def stats(self):
        return self.engine.stats
