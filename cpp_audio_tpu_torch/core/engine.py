"""Streaming block engine — the reference's SimpleAudioOutContext + AudioPost.

Reference (include/simple_audio_context.h:5-133, include/out.h:219-248): the
real-time callback drains a oneshot queue, runs every registered compute over
<=16-frame chunks into a double-precision bus, then the post chain (reverb ->
limiter -> clamp/NaN guard) and casts to the output format.

Here there is no real-time thread to protect, so oneshots are plain
callables drained at block boundaries, and blocks are large (thousands of
frames). Post processors carry state across blocks explicitly (convolution
tails, limiter peak), which is the streaming equivalent of the offline
whole-signal operators in ops/.

Port of cpp_audio_tpu/core/engine.py. The bus is a float64 tensor on the
engine's `device`: each compute's block (a tensor, e.g. StreamingSynth's on
its device, or a host array) is added there, the post chain runs there
(StreamingConvolver on torch.fft, StreamingLimiter on ops/limiter with its
peak carried as a device scalar) and `step` returns the bus as a device
tensor. Nothing in a step reads a value back to the host; the caller makes
the one host copy of a block (core/platform's output contexts do it in the
callback). EngineStats' compute time is the host's time per step (dispatch
on the card).

This is the host wrapper a sounddevice/portaudio callback (or a WASM
AudioWorklet analog) drives for "realtime" playback; the offline renderers
bypass it entirely.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..device import to_tensor
from ..ops import limiter


class AudioPost:
    """Ordered post-processing chain (reference out.h:219-248)."""

    def __init__(self):
        self._procs: list = []

    def add(self, proc) -> None:
        self._procs.append(proc)

    def process(self, block: torch.Tensor) -> torch.Tensor:
        for p in self._procs:
            block = p(block)
        return block


class StreamingConvolver:
    """Uniformly-partitioned zero-latency streaming convolution — the
    reference's ConvReverbsByBlockSize semantics (include/out.h:357): the IR
    is split into FFT partitions so per-block cost is bounded by
    O((n + P) log P + K*P) regardless of IR length, instead of O(n * taps).

    Scheme: the first partition (lags [0, P)) convolves the live block
    directly via one FFT (zero latency); partitions k >= 1 consume a
    frequency-delay line of completed P-sample input frames — frame j's
    spectrum X_j = rfft(frames j-1..j) contributes irfft(X_j * H_k)[P:]
    to output range [(j+k)P, (j+k+1)P), strictly in the future for k >= 1,
    so everything stays causal. All channels and all delay-line taps batch
    into one product-sum per completed frame. Float64 on `device`; blocks
    are (n, C) tensors (host arrays go to `device`).
    """

    def __init__(self, ir, wet: float = 1.0, dry: float | None = None,
                 partition: int = 4096, *, device="cuda"):
        self.device = torch.device(device)
        ir = torch.as_tensor(np.asarray(ir, np.float64), device=self.device)
        if ir.dim() == 1:
            ir = ir[:, None]
        self.wet = wet
        self.dry = (1.0 - wet) if dry is None else dry
        P = 1 << max(8, int(np.ceil(np.log2(max(partition, 2)))))
        self.partition = P
        taps = ir.shape[0]
        self.n_parts = K = max(1, -(-taps // P))
        self.n_channels = ir.shape[1]
        irp = torch.zeros((K * P, ir.shape[1]), dtype=torch.float64, device=self.device)
        irp[:taps] = ir
        self._h0 = irp[:P]  # direct partition, (P, C)
        # spectra of partitions 1..K-1 over 2P windows: (K-1, P+1, C)
        if K > 1:
            parts = irp[P:].reshape(K - 1, P, ir.shape[1])
            self._H = torch.fft.rfft(parts, n=2 * P, dim=1)
        else:
            self._H = torch.zeros((0, P + 1, ir.shape[1]), dtype=torch.complex128,
                                  device=self.device)
        self._h0_spec_cache: dict[int, torch.Tensor] = {}
        # _hist: the P input samples BEFORE _inbuf; _inbuf: the partial frame
        # toward the next X_j (so _hist ++ _inbuf ++ block is gap-free)
        self._hist = self._zeros(P, 0)
        self._inbuf = self._zeros(0, 0)
        self._fdl = None                  # (K-1, P+1, C) newest-first spectra
        self._t = 0                       # absolute input samples consumed
        self._sched = self._zeros(0, 0)   # future tail output (absolute pos)
        self._sched_t = 0

    def _zeros(self, n: int, c: int) -> torch.Tensor:
        return torch.zeros((n, c), dtype=torch.float64, device=self.device)

    def _ensure_channels(self, c: int) -> None:
        if self._hist.shape[1] != c:
            P = self.partition
            self._hist = self._zeros(P, c)
            self._inbuf = self._zeros(0, c)
            self._fdl = torch.zeros((self._H.shape[0], P + 1, c), dtype=torch.complex128,
                                    device=self.device)
            self._sched = self._zeros(0, c)
            if self._h0.shape[1] != c:
                self._h0 = self._h0[:, :1].expand(P, c).clone()
                self._H = self._H[:, :, :1].expand(self._H.shape[:2] + (c,)).clone()
                self._h0_spec_cache.clear()

    def __call__(self, block) -> torch.Tensor:
        block = to_tensor(block, self.device).to(self.device, torch.float64)
        P = self.partition
        n, c = block.shape
        self._ensure_channels(c)
        t0 = self._t

        # 1. complete P-frames feed the frequency-delay line FIRST: with
        # n > P, a frame completed mid-block contributes to output inside
        # this very block (its contribution starts at frame_end)
        consumed_before = self._inbuf.shape[0]
        hist2 = torch.cat([self._hist, self._inbuf, block], dim=0)
        n_buf = consumed_before + n
        pos = 0
        while n_buf - pos >= P:
            frame_end = t0 - consumed_before + pos + P  # absolute time
            if self._H.shape[0]:
                # window = frames (j-1, j): 2P samples ending at the frame end
                X = torch.fft.rfft(hist2[pos : pos + 2 * P], dim=0)  # (P+1, C)
                self._fdl = torch.roll(self._fdl, 1, dims=0)
                self._fdl[0] = X
                # combined K-1 partitions = the tail of output frame
                # [frame_end, frame_end + P)
                Y = (self._fdl * self._H).sum(dim=0)
                y = torch.fft.irfft(Y, n=2 * P, dim=0)[P:]
                self._schedule(frame_end, y)
            pos += P
        self._inbuf = hist2[P + pos :]
        self._hist = hist2[pos : pos + P]

        # 2. direct part: conv(hist ++ block, h0) at lags < P, via one FFT
        nfft = 1 << int(np.ceil(np.log2(n + 2 * P)))
        x = hist2[consumed_before : consumed_before + P + n]  # hist + block
        hk = self._h0_spec_cache.get(nfft)
        if hk is None:
            hk = torch.fft.rfft(self._h0, n=nfft, dim=0)
            self._h0_spec_cache[nfft] = hk
        full = torch.fft.irfft(torch.fft.rfft(x, n=nfft, dim=0) * hk, n=nfft, dim=0)
        out = full[P : P + n].clone()

        # 3. overlay scheduled tail contributions, drop what's now past
        if self._sched.shape[0]:
            lo = max(t0, self._sched_t)
            hi = min(t0 + n, self._sched_t + self._sched.shape[0])
            if hi > lo:
                out[lo - t0 : hi - t0] += self._sched[lo - self._sched_t
                                                      : hi - self._sched_t]
            drop = min(max(t0 + n - self._sched_t, 0), self._sched.shape[0])
            self._sched = self._sched[drop:]
            self._sched_t += drop
        if self._sched.shape[0] == 0:
            self._sched_t = t0 + n
        self._t = t0 + n
        return self.wet * out + self.dry * block

    def _schedule(self, at: int, y: torch.Tensor) -> None:
        if self._sched.shape[0] == 0:
            self._sched_t = max(self._sched_t, at)
        end = at + y.shape[0]
        cur_end = self._sched_t + self._sched.shape[0]
        if end > cur_end:
            self._sched = torch.cat([self._sched, self._zeros(end - cur_end, y.shape[1])])
        self._sched[at - self._sched_t : at - self._sched_t + y.shape[0]] += y


class StreamingLimiter:
    """Instant-attack / exponential-release limiter with carried peak:
    p_i = max(v_i, r*p_{i-1}) over the block's cross-channel peaks v, gain
    min(1, ceiling / p) (ops/limiter.limit_streaming). The carried peak is
    a 0-d tensor on the block's device, so a step never reads it back. A
    tensor block stays on its device; a host array goes to `device`."""

    def __init__(self, ceiling: float = 1.0, release_ms: float = 50.0,
                 sample_rate: int = 44100, *, device="cuda"):
        self.device = torch.device(device)
        self.ceiling = ceiling
        self.release_ms = release_ms
        self.sample_rate = sample_rate
        self.r = float(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate)))
        self._peak = 0.0

    def __call__(self, block) -> torch.Tensor:
        block = to_tensor(block, self.device)
        if block.shape[0] == 0:
            return block
        out, self._peak = limiter.limit_streaming(
            block, self._peak, ceiling=self.ceiling, release_ms=self.release_ms,
            sample_rate=self.sample_rate)
        return out


def clamp_guard(block) -> torch.Tensor:
    """Final clamp + NaN guard (reference out.h:620-646); a tensor block
    stays on its device (the engine's bus always is one)."""
    return limiter.clamp_and_guard(block, device="cpu")


@dataclass
class EngineStats:
    """Observability counters (reference AsyncLogger drop counts, queue
    gauges, per-stage durations — SURVEY §5.5)."""

    blocks_rendered: int = 0
    frames_rendered: int = 0
    oneshots_run: int = 0
    compute_seconds: float = 0.0

    @property
    def cpu_load(self) -> float:
        """Compute time / rendered audio time (Pa_GetStreamCpuLoad analog)."""
        if not self.frames_rendered:
            return 0.0
        return self.compute_seconds / (self.frames_rendered / 44100.0)


class AudioEngine:
    """Block-streaming engine with compute registry + oneshot queue + post,
    its bus on `device`."""

    def __init__(self, sample_rate: int = 44100, n_channels: int = 2, *,
                 device="cuda"):
        self.sample_rate = sample_rate
        self.n_channels = n_channels
        self.device = torch.device(device)
        self.post = AudioPost()
        self._computes: list = []
        self._oneshots: deque = deque()
        self._t = 0
        self.stats = EngineStats()

    # --- NRT -> engine handoff (reference enqueueOneShot) ---
    def enqueue_oneshot(self, fn) -> None:
        self._oneshots.append(fn)

    def register_compute(self, fn) -> None:
        """fn(t0: int, n: int) -> (n, C) tensor or array, or None when
        finished."""
        self._computes.append(fn)

    @property
    def current_time(self) -> int:
        return self._t

    def step(self, n_frames: int) -> torch.Tensor:
        """Render the next block (reference SimpleAudioOutContext::step):
        an (n_frames, C) float64 tensor on the engine's device."""
        t0 = time.perf_counter()
        while self._oneshots:
            self._oneshots.popleft()(self, self._t)
            self.stats.oneshots_run += 1
        bus = torch.zeros((n_frames, self.n_channels), dtype=torch.float64,
                          device=self.device)
        dead = []
        for fn in self._computes:
            out = fn(self._t, n_frames)
            if out is None:
                dead.append(fn)
            else:
                bus += to_tensor(out, self.device).to(self.device)
        for fn in dead:
            self._computes.remove(fn)
        bus = self.post.process(bus)
        self._t += n_frames
        self.stats.blocks_rendered += 1
        self.stats.frames_rendered += n_frames
        self.stats.compute_seconds += time.perf_counter() - t0
        return bus

    def render(self, n_frames: int, block_size: int = 4096) -> torch.Tensor:
        """Drive the engine for n_frames (offline use of the streaming path)."""
        blocks = []
        done = 0
        while done < n_frames:
            n = min(block_size, n_frames - done)
            blocks.append(self.step(n))
            done += n
        return torch.cat(blocks, dim=0)
