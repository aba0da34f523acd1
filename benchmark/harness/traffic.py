"""The one generator of every traffic mix: offline jobs, one fixed sequence
of takes for every seed, in an order drawn from the seed.

A take of `s` seconds is `voices` enveloped sines drawn by
chip_smoke.make_synth_workload's generator (bench.py:52-75): per voice, a
press in the first half of the take, a length from 1 s to half the take,
55-3520 Hz, velocity 0.3-1, pan -1..1. Nothing is screened out: the takes
come in the generator's own proportions.

Take t of a mix is drawn from numpy's generator seeded with
(`takes_seed`, 0, t), the mix's own seed, so every run's seed sends the same
takes; its length comes from `take_seconds`, in blocks of one of each
length, in an order drawn per block from (`takes_seed`, 2, block). A run's
--seed orders them: job i is a take of the same block of `shuffle_block`
consecutive takes (a multiple of the lengths), in an order drawn per block
from (seed, 2, block). So every window holds the same takes but for its
last block, and no take repeats. Warm-up takes come from
(`takes_seed`, 1, j), outside the sequence. Voices are host float64 arrays
with the voice bank's fields (amp = base volume * velocity * the anti-alias
fade; constant-power pan gains; start angle 0); the carrier is the
configuration's square wave.
"""

from __future__ import annotations

import numpy as np


class Traffic:
    def __init__(self, data: dict, config: dict, seed: int):
        self.data = data
        self.config = config
        self.seed = int(seed)
        self.takes_seed = int(data["takes_seed"])
        self.batch = int(data["batch"])
        self.lengths = [float(s) for s in data["take_seconds"]]
        self.block = int(data["shuffle_block"])
        if self.block % len(self.lengths):
            raise ValueError("shuffle_block is not a multiple of the take lengths")
        self.sr = int(config["sample_rate"])
        self._carriers = {}
        self._order = (None, None)  # (block, the seed's order in it)

    def take_seconds(self, t: int) -> float:
        """The length of take t of the fixed sequence."""
        L = len(self.lengths)
        order = np.random.default_rng([self.takes_seed, 2, t // L]).permutation(L)
        return self.lengths[int(order[t % L])]

    def take_of(self, i: int) -> int:
        """The take that job i of this seed's run sends."""
        b, r = divmod(i, self.block)
        if self._order[0] != b:
            self._order = (b, np.random.default_rng([self.seed, 2, b]).permutation(self.block))
        return b * self.block + int(self._order[1][r])

    def carrier(self, n: int) -> np.ndarray:
        if n not in self._carriers:
            c = self.config["carrier"]
            t = np.arange(n) / self.sr
            self._carriers[n] = np.sign(np.sin(2 * np.pi * c["hz"] * t))
        return self._carriers[n]

    def _take(self, stream: int, t: int, seconds: float) -> dict:
        n = int(round(seconds * self.sr))
        rng = np.random.default_rng([self.takes_seed, stream, t])
        return dict(index=t, seconds=n / self.sr, n=n,
                    voices=voices(rng, n, self.sr, int(self.data["voices"]),
                                  self.config["synth"]),
                    carrier=self.carrier(n))

    def job(self, i: int) -> dict:
        t = self.take_of(i)
        job = self._take(0, t, self.take_seconds(t))
        job["take"] = t
        job["index"] = i
        return job

    def warm_jobs(self) -> list[dict]:
        """One batch of each take length, outside the sequence."""
        return [self._take(1, j * self.batch + b, s)
                for j, s in enumerate(sorted(set(self.lengths)))
                for b in range(self.batch)]


def voices(rng, n: int, sr: int, n_voices: int, synth: dict) -> dict:
    press = np.zeros(n_voices)
    release = np.zeros(n_voices)
    freq = np.zeros(n_voices)
    vel = np.zeros(n_voices)
    pan = np.zeros(n_voices)
    for i in range(n_voices):
        press[i] = int(rng.uniform(0, n * 0.5))
        release[i] = press[i] + int(rng.uniform(sr, n * 0.5))
        freq[i] = rng.uniform(55, 3520)
        vel[i] = rng.uniform(0.3, 1.0)
        pan[i] = rng.uniform(-1, 1)
    inc = 2.0 * freq / sr
    hspp = 1.0 / np.abs(inc)
    fade = np.clip((hspp - 1.0) / 3.0, 0.0, 1.0)
    th = 0.25 * np.pi * (np.clip(pan, -1.0, 1.0) + 1.0)
    full = lambda x: np.full(n_voices, float(x))  # noqa: E731
    return dict(press=press, release=release, increment=inc, phase0=np.zeros(n_voices),
                amp=synth["base_volume"] * vel * fade,
                gains=np.stack([np.cos(th), np.sin(th)], axis=1),
                attack=full(synth["attack"]), hold=full(synth["hold"]),
                decay=full(synth["decay"]), release_len=full(synth["release"]),
                sustain=full(synth["sustain"]))
