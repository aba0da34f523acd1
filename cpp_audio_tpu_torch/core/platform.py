"""Virtual audio-device contexts — the platform I/O layer (L1) analog.

Reference (include/audio_platforms.h:24-116, audio_platform_pa.h:204-980,
audio_platform_au.h:24-255): `Context<AudioPlatform>` owns an OS output
stream whose RT callback publishes `n_audio_cb_frames`, computes a TimeNanos
from the monotonic frame count, and invokes the registered `PlayF`;
`AudioInput` feeds a `RecordF`; `FullDuplexContext` runs both on one stream.

This environment has no OS audio devices, so the platform layer drives the
same PlayF/RecordF contracts against virtual transports: a clocked pull loop
that renders into a WAV / array (output), a WAV / array that replays in
callback-sized chunks (input), and a full-duplex loop that runs RecordF then
PlayF per block exactly like the reference's single RT thread
(audio_platform_pa.h:478-790). The engine stack above (AudioEngine, synths,
resynth) is device-agnostic behind these lambdas — the property the reference
demonstrates with its offline mode (rt.resynth.lib.cpp:1185-1235).

Host copy of cpp_audio_tpu/core/platform.py. A PlayF may also return its
block instead of filling `out` (an engine's `step` returns a tensor on its
device): the context then copies it into `out`, the one host copy of the
block, inside the callback's timing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

# the reference exposes the most recent callback size as a global so NRT
# threads can size their queues (audio_platforms.h:111-116)
n_audio_cb_frames: int = -1


def wait_for_first_n_audio_cb_frames() -> int:
    """In the reference this blocks until the RT callback ran once; the
    virtual contexts publish synchronously, so this just validates state."""
    if n_audio_cb_frames <= 0:
        raise RuntimeError("no context has run a callback yet")
    return n_audio_cb_frames


def _play(play_f, out: np.ndarray, t_nanos: int) -> None:
    """Run a PlayF on `out`; a block it returns (a tensor on any device or
    an array) is copied into `out`."""
    block = play_f(out, t_nanos)
    if block is None:
        return
    if torch.is_tensor(block):
        block = block.detach().cpu().numpy()
    out[:] = np.reshape(block, out.shape)


def frames_to_nanos(frame: int, sample_rate: int) -> int:
    """Monotonic frame count -> TimeNanos (audio_platforms.h:36-98)."""
    return int(frame * 1_000_000_000 // sample_rate)


@dataclass
class StreamStats:
    """RT diagnostics gauges: CPU load (Pa_GetStreamCpuLoad analog,
    audio_platform_pa.h:217), per-callback time stats (AudioCbTimeStats,
    audio_platform_pa.h:31-60), overflow count (AudioOverflow, :61-74) and
    time-source deviation detection (SignificantTimeDeviation + analyzeTime,
    :75-167)."""

    callbacks: int = 0
    compute_seconds: float = 0.0
    budget_seconds: float = 0.0
    # AudioCbTimeStats analogs
    min_callback_seconds: float = float("inf")
    max_callback_seconds: float = 0.0
    # AudioOverflow analog: callbacks whose compute exceeded their budget
    overflows: int = 0
    # SignificantTimeDeviation analog
    time_deviations: int = 0
    max_time_deviation_seconds: float = 0.0

    def record_callback(self, compute_s: float, budget_s: float) -> None:
        self.callbacks += 1
        self.compute_seconds += compute_s
        self.budget_seconds += budget_s
        self.min_callback_seconds = min(self.min_callback_seconds, compute_s)
        self.max_callback_seconds = max(self.max_callback_seconds, compute_s)
        if compute_s > budget_s > 0:
            self.overflows += 1

    def analyze_time(self, reported_nanos: int, frame_clock_nanos: int,
                     threshold_seconds: float = 0.01) -> bool:
        """Compare an externally-reported stream time against the frame-count
        clock (reference analyzeTime, audio_platform_pa.h:270-300); returns
        True when the deviation is significant (and counts it)."""
        dev = abs(reported_nanos - frame_clock_nanos) * 1e-9
        self.max_time_deviation_seconds = max(
            self.max_time_deviation_seconds, dev)
        if dev > threshold_seconds:
            self.time_deviations += 1
            return True
        return False

    @property
    def cpu_load(self) -> float:
        return (self.compute_seconds / self.budget_seconds
                if self.budget_seconds > 0 else 0.0)


class OutputContext:
    """Output stream: pulls blocks from a PlayF callback
    (reference Context<PortAudio>::audiooutCallback, audio_platform_pa.h:254).

    PlayF signature: play_f(out: (n, n_outs) float array, t_nanos: int) —
    fills `out` in place (the reference's `PlayF` contract).
    """

    def __init__(self, n_outs: int = 2):
        self.n_outs = n_outs
        self._play_f = None
        self._sample_rate = 0
        self._frames = 0
        self._initialized = False
        self.stats = StreamStats()
        self.frames_per_callback = 512  # observed iOS size (audio_platform_au.h:11)

    # -- reference public interface (audio_platforms.h doInit/doTearDown) --
    def do_init(self, min_latency_seconds: float, sample_rate: int,
                n_outs: int, play_f) -> None:
        self.n_outs = n_outs
        self._sample_rate = int(sample_rate)
        self._play_f = play_f
        self._initialized = True
        # PA_MIN_LATENCY_MSEC env override (audio_context.cpp:60-92), then
        # latency -> callback size, next power of two like PortAudio tends to
        min_latency_seconds = effective_min_latency_seconds(min_latency_seconds)
        want = max(1, int(min_latency_seconds * sample_rate))
        self.frames_per_callback = 1 << (want - 1).bit_length()

    def initialized(self) -> bool:
        return self._initialized

    def get_sample_rate(self) -> int:
        return self._sample_rate

    def get_stream_cpu_load(self) -> float:
        return self.stats.cpu_load

    def do_tear_down(self) -> None:
        self._initialized = False
        self._play_f = None

    # -- the virtual device: pull n frames through the callback ------------
    def pull(self, n_frames: int | None = None) -> np.ndarray:
        global n_audio_cb_frames
        if not self._initialized:
            raise RuntimeError("do_init first")
        n = self.frames_per_callback if n_frames is None else n_frames
        n_audio_cb_frames = n
        out = np.zeros((n, self.n_outs))
        t = frames_to_nanos(self._frames, self._sample_rate)
        t0 = time.perf_counter()
        _play(self._play_f, out, t)
        self.stats.record_callback(time.perf_counter() - t0,
                                   n / self._sample_rate)
        self._frames += n
        return out

    def render(self, n_frames: int) -> np.ndarray:
        """Pull callback-sized chunks until n_frames are rendered."""
        parts = []
        left = n_frames
        while left > 0:
            take = min(self.frames_per_callback, left)
            parts.append(self.pull(take))
            left -= take
        return np.concatenate(parts, axis=0)


class InputContext:
    """Input stream: pushes blocks of a source signal into a RecordF
    (reference AudioInput<PortAudio>, audio_platform_pa.h:794-980).

    RecordF signature: record_f(buf: (n,) float array, t_nanos: int).
    """

    def __init__(self, source: np.ndarray, sample_rate: int):
        src = np.asarray(source, np.float64)
        self._source = src.mean(axis=1) if src.ndim == 2 else src
        self._sample_rate = int(sample_rate)
        self._pos = 0
        self._record_f = None
        self.stats = StreamStats()

    def do_init(self, record_f) -> None:
        self._record_f = record_f

    @property
    def exhausted(self) -> bool:
        return self._pos >= len(self._source)

    def push(self, n_frames: int) -> int:
        """Deliver up to n_frames to the RecordF; returns frames delivered."""
        if self._record_f is None:
            raise RuntimeError("do_init first")
        take = min(n_frames, len(self._source) - self._pos)
        if take <= 0:
            return 0
        buf = self._source[self._pos : self._pos + take]
        t = frames_to_nanos(self._pos, self._sample_rate)
        t0 = time.perf_counter()
        self._record_f(buf, t)
        self.stats.record_callback(time.perf_counter() - t0,
                                   take / self._sample_rate)
        self._pos += take
        return take


class FullDuplexContext:
    """In+out on one clock: each block runs RecordF then PlayF, like the
    reference's single-stream duplex callback (audio_platform_pa.h:478-790)."""

    def __init__(self, source: np.ndarray, sample_rate: int, n_outs: int = 2,
                 frames_per_callback: int = 512):
        self.input = InputContext(source, sample_rate)
        self.output = OutputContext(n_outs)
        self.frames_per_callback = frames_per_callback
        self._sample_rate = int(sample_rate)

    def do_init(self, record_f, play_f) -> None:
        self.input.do_init(record_f)
        self.output.do_init(self.frames_per_callback / self._sample_rate,
                            self._sample_rate, self.output.n_outs, play_f)
        self.output.frames_per_callback = self.frames_per_callback

    def run(self, n_frames: int | None = None) -> np.ndarray:
        """Run the duplex loop until the input is exhausted (or n_frames)."""
        total = (len(self.input._source) if n_frames is None else n_frames)
        parts = []
        done = 0
        while done < total:
            take = min(self.frames_per_callback, total - done)
            self.input.push(take)
            parts.append(self.output.pull(take))
            done += take
        return np.concatenate(parts, axis=0) if parts else np.zeros(
            (0, self.output.n_outs))


class Int16OutputContext(OutputContext):
    """AudioUnit-style output context analog (reference
    Context<AudioPlatform::AudioUnits>, include/audio_platform_au.h:24-255).

    What distinguishes the reference's iOS path from its PortAudio path:

    - the OS picks the callback size and it can CHANGE mid-stream ("we cannot
      know for sure how much the os will ask us to compute", observed 512 on
      an iPhone 4s; it may shrink when a bluetooth device renegotiates —
      audio_platform_au.h:10-13,56-58);
    - the callback renders floats into a preallocated staging buffer, then
      quantizes to interleaved SInt16 with `(SInt16)(sample * 32767.f)`
      (truncation, not rounding — audio_platform_au.h:79-88).

    Here `pull()` reproduces both: an optional per-call frame count models
    the OS-chosen size, and delivery is an int16 interleaved array quantized
    exactly like the reference. The float staging buffer is reused across
    callbacks (the reference preallocates to avoid RT allocation).
    """

    def __init__(self, n_outs: int = 2):
        super().__init__(n_outs)
        self.frames_per_callback = 512  # observed iOS callback size (au.h:11)
        self._staging = np.zeros((1024, n_outs))  # initial_buffer_size analog

    def pull_int16(self, n_frames: int | None = None) -> np.ndarray:
        """Run one render callback; returns (n, n_outs) int16 frames."""
        global n_audio_cb_frames
        if not self._initialized:
            raise RuntimeError("do_init first")
        n = self.frames_per_callback if n_frames is None else n_frames
        n_audio_cb_frames = n
        if self._staging.shape[0] < n or self._staging.shape[1] != self.n_outs:
            self._staging = np.zeros((n, self.n_outs))
        buf = self._staging[:n]
        buf[:] = 0.0
        t = frames_to_nanos(self._frames, self._sample_rate)
        t0 = time.perf_counter()
        _play(self._play_f, buf, t)
        self.stats.record_callback(time.perf_counter() - t0,
                                   n / self._sample_rate)
        self._frames += n
        # (SInt16)(val * 32767.f) — C cast truncates toward zero (au.h:84)
        return np.trunc(buf * 32767.0).astype(np.int16)

    def render_int16(self, n_frames: int,
                     callback_sizes=None) -> np.ndarray:
        """Render n_frames through OS-chosen callback sizes (an iterable of
        per-callback frame counts, cycled; defaults to frames_per_callback)."""
        parts = []
        left = n_frames
        sizes = iter(lambda: self.frames_per_callback, None) \
            if callback_sizes is None else _cycle(callback_sizes)
        for size in sizes:
            if left <= 0:
                break
            take = min(size, left)
            parts.append(self.pull_int16(take))
            left -= take
        return np.concatenate(parts, axis=0) if parts else np.zeros(
            (0, self.n_outs), np.int16)


def _cycle(seq):
    while True:
        yield from seq


# ---------------------------------------------------------------------------
# Latency override + optional real audio-device backend
# ---------------------------------------------------------------------------

PA_MIN_LATENCY_MSEC = "PA_MIN_LATENCY_MSEC"


def override_portaudio_min_latency_millis(latency_ms: int) -> bool:
    """Set the PA_MIN_LATENCY_MSEC env var (reference
    overridePortaudioMinLatencyMillis, source/audio_context.cpp:60-92)."""
    import os

    if latency_ms <= 0:
        return False
    os.environ[PA_MIN_LATENCY_MSEC] = str(int(latency_ms))
    return True


def effective_min_latency_seconds(requested_seconds: float) -> float:
    """Honor the PA_MIN_LATENCY_MSEC env override when set (the reference's
    PortAudio build reads this env var; audio_context.cpp:60-92)."""
    import os

    v = os.environ.get(PA_MIN_LATENCY_MSEC)
    if v:
        try:
            ms = float(v)
            if ms > 0:
                return ms / 1000.0
        except ValueError:
            pass
    return requested_seconds


def _sounddevice_or_none():
    try:
        import sounddevice  # noqa: F401

        sounddevice.query_devices()  # raises when no backend/devices exist
        return sounddevice
    except Exception:
        return None


class SoundDeviceOutputContext:
    """Real audio-device output behind the same do_init/PlayF contract
    (the reference's Context<PortAudio>, audio_platform_pa.h:204-470),
    backed by the `sounddevice` library when present.

    Selected automatically by make_output_context(); this environment has no
    audio device, so tests exercise the virtual contexts only.
    """

    def __init__(self, n_outs: int = 2):
        self.n_outs = n_outs
        self._sd = _sounddevice_or_none()
        if self._sd is None:
            raise RuntimeError("no sounddevice backend / audio device")
        self._stream = None
        self._play_f = None
        self._frames = 0
        self._sample_rate = 0
        self.stats = StreamStats()

    def do_init(self, min_latency_seconds: float, sample_rate: int,
                n_outs: int, play_f) -> None:
        global n_audio_cb_frames
        self.n_outs = n_outs
        self._sample_rate = int(sample_rate)
        self._play_f = play_f
        latency = effective_min_latency_seconds(min_latency_seconds)

        def callback(outdata, frames, time_info, status):
            global n_audio_cb_frames
            n_audio_cb_frames = frames
            t = frames_to_nanos(self._frames, self._sample_rate)
            t0 = time.perf_counter()
            buf = np.zeros((frames, self.n_outs))
            _play(self._play_f, buf, t)
            outdata[:] = buf
            self.stats.record_callback(time.perf_counter() - t0,
                                       frames / self._sample_rate)
            self._frames += frames

        self._stream = self._sd.OutputStream(
            samplerate=sample_rate, channels=n_outs, latency=latency,
            callback=callback)
        self._stream.start()

    def initialized(self) -> bool:
        return self._stream is not None

    def get_sample_rate(self) -> int:
        return self._sample_rate

    def get_stream_cpu_load(self) -> float:
        return self.stats.cpu_load

    def do_tear_down(self) -> None:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None


class SoundDeviceFullDuplexContext:
    """Real full-duplex stream (RecordF then PlayF per callback, the
    reference's FullDuplexContext shape, audio_platform_pa.h:478-790)."""

    def __init__(self, sample_rate: int, n_outs: int = 2):
        self._sd = _sounddevice_or_none()
        if self._sd is None:
            raise RuntimeError("no sounddevice backend / audio device")
        self._sample_rate = int(sample_rate)
        self.n_outs = n_outs
        self._stream = None
        self._frames = 0
        self.stats = StreamStats()

    def do_init(self, record_f, play_f,
                min_latency_seconds: float = 0.008) -> None:
        latency = effective_min_latency_seconds(min_latency_seconds)

        def callback(indata, outdata, frames, time_info, status):
            global n_audio_cb_frames
            n_audio_cb_frames = frames
            t = frames_to_nanos(self._frames, self._sample_rate)
            t0 = time.perf_counter()
            record_f(indata.mean(axis=1) if indata.ndim == 2
                     else np.asarray(indata), t)
            buf = np.zeros((frames, self.n_outs))
            _play(play_f, buf, t)
            outdata[:] = buf
            self.stats.record_callback(time.perf_counter() - t0,
                                       frames / self._sample_rate)
            self._frames += frames

        self._stream = self._sd.Stream(
            samplerate=self._sample_rate, channels=(1, self.n_outs),
            latency=latency, callback=callback)
        self._stream.start()

    def do_tear_down(self) -> None:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None


def make_output_context(n_outs: int = 2, *, prefer_device: bool = True):
    """The reference's platform selection analog: a real device-backed
    context when one exists, the virtual OutputContext otherwise."""
    if prefer_device and _sounddevice_or_none() is not None:
        return SoundDeviceOutputContext(n_outs)
    return OutputContext(n_outs)
