"""Live (block-streaming) analysis -> resynthesis — the realtime RtResynth
shape, built from the same stages as the offline pipeline.

Reference:
- `PeriodicFFT` (source/rt.resynth.lib.periodicfft.cpp:14-181): `feed()`
  accumulates samples into a sliding window; when the window fills, the FFT
  op runs and the buffer keeps `window - stride` overlap (memmove); negative
  overlap (stride > window) skips input; `on_dropped_frames` resynchronizes.
- `RtResynth` (source/rt.resynth.lib.cpp:389-2148): the live object wiring
  input -> analysis -> the polyphonic synth, one pitch-pipeline step per
  completed window.

Port of cpp_audio_tpu/analysis/streaming.py. `PeriodicFFT` is the same host
buffering logic. `StreamingVocoder` keeps its state on `device` in float64
and runs every window that completes inside one `process()` call as one
batched FFT per side: which windows complete, and which modulator window
each carrier window reads, follow from sample counts alone, so the host
never reads device data there. `LiveResynth` analyses each completed window
on the device, copies its (k,) peaks to the host tracker, and renders
through StreamingSynth (the voice-bank kernel, once per pull on a card).

`LiveResynth.process` is the duplex callback. Under a torch profiler it
records the spans (utils/profiling.span) `duplex` (the callback, one job
id each), `live_analysis` (a window's STFT, top-k peaks and their copy to
the host), `live_tracker` (PitchTracker.step and the diff into synth
events), `live_synth` (models/streaming_synth), `live_carrier`
(models/carrier) and `live_vocoder` (the modulator block's upload and
StreamingVocoder.process); the counter profiling.LIVE_WAITS counts each
host array the path uploads and each device array it reads back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import events
from ..device import HostPickled
from ..models import sine_synth
from ..models.streaming_synth import StreamingSynth
from ..ops import envelopes, stft
from ..utils import profiling
from ..utils.profiling import span
from . import vocoder as voc
from .resynth import AnalysisFrameResult, PitchTracker, ResynthConfig


class PeriodicFFT(HostPickled):
    """Sliding-window buffer: feed samples, get a callback per full window.

    on_window(window_samples, end_sample): called when a window completes;
    `end_sample` is the absolute index just past the window (analysis results
    become valid there — rt.resynth.lib.periodicfft.cpp:55-180).
    """

    def __init__(self, window_size: int, stride: int, on_window):
        if window_size <= 0 or stride <= 0:
            raise ValueError("window_size and stride must be positive")
        self.window_size = window_size
        self.stride = stride
        self.on_window = on_window
        self._win = np.zeros(window_size)
        self._end = 0             # fill position (reference `end`)
        self._skip = 0            # reference `ignore_frames` (may go <0
        #                           after an uncovered drop — no skipping
        #                           happens then, periodicfft.cpp:55-59,69-78)
        self._t = 0               # absolute source-sample index consumed

    def feed(self, samples) -> int:
        """Consume a block; returns how many windows completed
        (PeriodicFFT::feed/onFullBuffer, periodicfft.cpp:55-66,136-180)."""
        samples = np.atleast_1d(np.asarray(samples, np.float64))
        fired = 0
        i, n = 0, len(samples)
        while i < n:
            if self._skip > 0:
                take = min(self._skip, n - i)
                self._skip -= take
                i += take
                self._t += take
                continue
            take = min(self.window_size - self._end, n - i)
            self._win[self._end:self._end + take] = samples[i:i + take]
            self._end += take
            i += take
            self._t += take
            if self._end == self.window_size:
                self._end = 0
                fired += 1
                self.on_window(self._win.copy(), self._t)
                overlap = self.window_size - self.stride
                if overlap >= 0:
                    self._win[:overlap] = self._win[self.stride:]
                    self._end = overlap
                    self._skip = 0
                else:
                    self._skip = -overlap
        return fired

    def on_dropped_frames(self, n: int | None) -> None:
        """Resync after an input overrun (periodicfft.cpp:69-78): a drop
        fully covered by a pending skip is absorbed; otherwise the window
        CONTENT is zeroed but the fill position (and so the fire cadence)
        is kept, exactly like the reference's reset_samples. n=None means
        an unknown drop count (unconditional zeroing, position kept)."""
        if n is not None:
            self._t += n
            self._skip -= n
            if self._skip >= 0:
                return
        self._win[:] = 0.0

    def samples_until_fire(self) -> int:
        """How many more fed samples complete the next window."""
        return max(0, self._skip) + self.window_size - self._end


def _completed_windows(tail: torch.Tensor, block: torch.Tensor, t0: int,
                       window: int, stride: int):
    """The sliding windows (length `window`, stride `stride`, the first
    ending at sample `window`) that complete while `block` is fed after t0
    samples, of which `tail` holds the last min(t0, window - 1).

    Returns (frames (m, window) view, index of the first completed window,
    m, the new tail). Host arithmetic only: what completes depends on the
    sample counts, not on the data."""
    n = block.shape[0]
    first = 0 if t0 < window else (t0 - window) // stride + 1
    last = (t0 + n - window) // stride if t0 + n >= window else -1
    m = max(0, last - first + 1)
    stream = torch.cat([tail, block]) if tail.numel() else block
    base = t0 - tail.shape[0]
    frames = None
    if m:
        start = first * stride - base
        frames = stream[start:start + (m - 1) * stride + window].unfold(0, window, stride)
    return frames, first, m, stream[-(window - 1):] if window > 1 else stream[:0]


class StreamingVocoder(HostPickled):
    """Block-streaming FFT vocoder — the live Vocoder compute
    (source/rt.resynth.lib.vocoder.cpp:396-560,734-860) in feed/pull form.

    Per output sample the reference pulls one (modulator, carrier) pair,
    feeds each into its own PeriodicFFT (modulator window W stride S; carrier
    window 2S stride S), scales carrier bins by the latest per-band modulator
    amplitudes, IFFTs, and equal-gain-crossfades the new half-window against
    the previous one.

    Here both sides keep their last W-1 (2S-1) samples on `device`, and one
    `process()` call runs every window completing in its block as one
    batched rfft per side (float64, as the JAX package's numpy form). The
    modulator is fed first at equal positions (vocoder.cpp:761-812): carrier
    window c, which ends at 2S + c*S, reads the amplitudes of the last
    modulator window ending at or before it — index c + (2S - W)//S, the
    previous call's last amplitudes (zeros before the first window) when
    that lies before this call's first window. The crossfade then runs over
    the whole batch. Nothing in process() reads device data on the host.

    The vocoded stream lags the input by 2S - 1 samples (the carrier window
    must fill before its first crossfaded half emerges, and the reference
    emits the first sample inside the completing feed() itself), so
    streaming[t + 2*S - 1] == offline[t] once the first modulator window has
    completed (t >= W); before that the streaming path has no band
    amplitudes yet (silence).
    """

    def __init__(self, params: voc.VocoderParams, *, device="cuda"):
        self.params = params
        dev = self.device = torch.device(device)
        S = params.stride
        W = params.modulator_window
        self.stride = S
        self._mod_fft = stft.fft_length_for(W)
        self._car_fft = stft.fft_length_for(2 * S)
        sr = params.sample_rate
        edges = params.band_freqs()

        def f64(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)

        self._bm_mod = f64(voc._band_matrix(edges, self._mod_fft // 2 + 1,
                                            sr / self._mod_fft))
        self._bm_car_t = f64(voc._band_matrix(edges, self._car_fft // 2 + 1,
                                              sr / self._car_fft).T)
        # the reference modulator windows with the 4-sigma Gaussian
        # (SqMagFftOperation<Window::Gaussian>, vocoder.cpp:241); scale per
        # vocoder._modulator_band_amps: unit in-band sine -> band amp 1
        win = params.modulator_window_array()
        self._mod_win = f64(win)
        self._mod_scale = 2.0 / float(np.sqrt(self._mod_fft * (win ** 2).sum()))
        self._w_new = f64((np.arange(S) + 1.0) / S)  # linear equal-gain, vocoder.cpp:538-541
        self._amps = f64(np.zeros(params.count_bands))
        self._prev_tail = f64(np.zeros(S))
        self._mod_tail = f64(np.zeros(0))
        self._car_tail = f64(np.zeros(0))
        # crossfaded vocoded samples not yet returned, at absolute output
        # positions [_q_start, _q_start + len(_queue)); the first is emitted
        # at 2S - 1 (inside the feed that completes carrier window 0,
        # vocoder.cpp:509-527), and the rest follow contiguously
        self._queue = f64(np.zeros(0))
        self._q_start = 2 * S - 1
        self._t_out = 0

    def _block(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return torch.atleast_1d(x).to(device=self.device, dtype=torch.float64)
        return torch.as_tensor(np.atleast_1d(np.asarray(x, np.float64)),
                               device=self.device)

    def process(self, modulator, carrier) -> torch.Tensor:
        """Feed equal-length modulator+carrier blocks; return the output
        block on `device` (float64): volume_modulator*mod +
        volume_carrier*car + volume_vocoded*vocoded (Vocoder compute mix,
        vocoder.cpp:795-805)."""
        car = self._block(carrier)
        n = car.shape[0]
        mod = self._block(modulator)[:n]
        t0 = self._t_out
        self._t_out += n
        S, W = self.stride, self.params.modulator_window

        frames, m0, m, self._mod_tail = _completed_windows(
            self._mod_tail, mod, t0, W, S)
        table = self._amps[None]
        if m:  # latest per-band modulator amplitudes (vocoder.cpp:109-163)
            spec = torch.fft.rfft(frames * self._mod_win, n=self._mod_fft)
            sq = (spec.abs() * self._mod_scale) ** 2
            table = torch.cat([table, torch.sqrt(sq @ self._bm_mod)])
            self._amps = table[-1]
        frames, c0, r, self._car_tail = _completed_windows(
            self._car_tail, car, t0, 2 * S, S)
        if r:
            rows = torch.arange(c0, c0 + r, device=self.device) + (
                (2 * S - W) // S - m0 + 1)
            amps = table[rows.clamp_(min=0)]                  # (r, bands)
            spec = torch.fft.rfft(frames, n=self._car_fft)
            sig = torch.fft.irfft(spec * (amps @ self._bm_car_t),
                                  n=self._car_fft)[:, :2 * S]
            old = torch.cat([self._prev_tail[None], sig[:-1, S:]])
            out = sig[:, :S] * self._w_new + old * (1.0 - self._w_new)
            self._prev_tail = sig[-1, S:]
            self._queue = torch.cat([self._queue, out.reshape(-1)])

        q0, q1 = self._q_start, self._q_start + self._queue.shape[0]
        lo, hi = max(t0, q0), min(t0 + n, q1)
        p = self.params
        out = p.volume_modulator * mod + p.volume_carrier * car
        if hi > lo:
            out[lo - t0:hi - t0] += p.volume_vocoded * self._queue[lo - q0:hi - q0]
        # drop everything at or before the end of this block
        drop = min(max(t0 + n - q0, 0), self._queue.shape[0])
        self._queue = self._queue[drop:]
        self._q_start += drop
        return out


@dataclass
class LiveResynthStats:
    windows: int = 0
    note_on: int = 0
    note_off: int = 0
    note_change: int = 0
    dropped_note_on: int = 0


class LiveResynth(HostPickled):
    """Streaming analysis -> resynthesis: feed input blocks, pull output
    blocks (the RtResynth live loop in offline-steppable form).

    Events are applied at the sample where their window completed, exactly
    like the reference's analysis thread publishing into the RT synth.
    Input arrives on the host (as captured audio does); `pull` returns an
    (n, 2) float64 tensor on `device`, which the caller copies to the host
    as an audio callback would.
    """

    def __init__(self, config: ResynthConfig | None = None, n_voices: int = 127,
                 *, vocoder_params: "voc.VocoderParams | None" = None,
                 carrier_synth=None, device="cuda"):
        """vocoder_params + carrier_synth enable the live vocoder leg: the
        carrier synth (models/carrier.CarrierSynth, usually driven by MIDI)
        renders per pulled block, and the StreamingVocoder modulates it with
        the live input — the reference's vocoder compute wiring
        (rt.resynth.lib.cpp:1397-1418 get_modulator_carrier_sample +
        vocoder_carrier.compute)."""
        self.config = config or ResynthConfig()
        cfg = self.config
        self.device = torch.device(device)
        self.tracker = PitchTracker(cfg)
        self.carrier_synth = carrier_synth
        self.vocoder = (StreamingVocoder(vocoder_params, device=device)
                        if vocoder_params is not None else None)
        self._mod_fifo = np.zeros(0)  # input awaiting the vocoder modulator
        sr = cfg.sample_rate
        synth_cfg = sine_synth.SineSynthConfig(
            sample_rate=sr,
            ahdsr=envelopes.AHDSR(
                attack=max(1, int(0.5 + cfg.env_attack_seconds * sr)),
                hold=int(0.5 + cfg.env_hold_seconds * sr),
                decay=int(0.5 + cfg.env_decay_seconds * sr),
                release=max(1, int(0.5 + cfg.env_release_seconds * sr)),
                sustain=cfg.env_sustain_level,
            ),
            dtype=cfg.dtype,
        )
        self.synth = StreamingSynth(synth_cfg, n_voices=n_voices, device=device)
        self._window = torch.as_tensor(stft.gaussian_window(cfg.window_size, sigmas=4.0),
                                       dtype=torch.float32, device=self.device)
        self._fft_len = stft.fft_length_for(cfg.window_size)
        self._live: dict[int, int] = {}  # tracker noteid -> last change frame
        self.stats = LiveResynthStats()
        self.periodic_fft = PeriodicFFT(cfg.window_size, cfg.stride,
                                        self._on_window)
        self._t_out = 0

    # -- analysis side ------------------------------------------------------
    def _peaks_of(self, window: np.ndarray):
        """One window's top-k peaks on the device; one (2, k) copy to the
        host tracker."""
        sig = torch.from_numpy(window.astype(np.float32)).to(self.device)
        sq = stft.stft_sqmag(sig, self._window, self.config.stride)
        freq, mag = stft.extract_top_peaks(sq, self.config.sample_rate,
                                           self._fft_len,
                                           k=self.config.max_voices + 1)
        fm = torch.cat([freq, mag]).cpu().numpy()
        profiling.LIVE_WAITS += 2  # the window up, the peaks down
        return stft.top_peaks_to_lists(fm[:1], fm[1:])[0]

    def _on_window(self, window: np.ndarray, end_sample: int) -> None:
        with span("live_analysis", self.device):
            peaks = self._peaks_of(window)
        with span("live_tracker", self.device):
            self._track(peaks, end_sample)

    def _track(self, peaks, end_sample: int) -> None:
        st: AnalysisFrameResult = self.tracker.step(peaks)
        self.stats.windows += 1
        self.stats.note_on += st.note_on
        self.stats.note_change += st.note_change
        self.stats.note_off += st.note_off
        self.stats.dropped_note_on += st.dropped

        # diff tracker voices -> synth events at the window's LAST sample:
        # the duplex loop analyzes a completed window before rendering that
        # same sample index, so the events already sound at end_sample - 1
        # (rt.resynth.lib.cpp:1215-1231)
        t_ev = end_sample - 1
        frame = st.frame_idx
        for nid, tn in self.tracker.voices.items():
            last_f, freq, vol = tn.frames[-1]
            if nid not in self._live:
                if last_f == frame:
                    if self.synth.on_event(events.Event(
                            events.EventType.NOTE_ON, t_ev, nid,
                            freq, vol, tn.pan)):
                        self._live[nid] = frame
            elif tn.release_frame <= frame:
                self.synth.on_event(events.mk_note_off(t_ev, nid))
                self._live.pop(nid, None)
            elif last_f == frame:
                self.synth.on_event(events.mk_note_change(t_ev, nid,
                                                          freq, vol))
                self._live[nid] = frame

    # -- the duplex surface --------------------------------------------------
    def feed(self, input_block) -> None:
        """Push captured input samples (the RecordF side)."""
        self.periodic_fft.feed(input_block)
        if self.vocoder is not None:
            blk = np.atleast_1d(np.asarray(input_block, np.float64))
            self._mod_fifo = np.concatenate([self._mod_fifo, blk])

    def pull(self, n_frames: int) -> torch.Tensor:
        """Render the next output block (the PlayF side) -> (n, 2) float64
        tensor on `device`."""
        t0 = self._t_out
        out = self.synth.compute(t0, n_frames).to(torch.float64)
        self._t_out += n_frames
        if self.vocoder is not None:
            carrier = (self.carrier_synth.compute(t0, n_frames)
                       if self.carrier_synth is not None
                       else torch.zeros(n_frames, dtype=torch.float64,
                                        device=self.device))
            # modulator samples: the fed input, zero-padded on starvation
            # (the reference's ReadQueuedSampleSource yields silence until
            # the queue has data, rt.resynth.lib.metaqueue.cpp:78-158)
            mod = np.zeros(n_frames)
            take = min(n_frames, len(self._mod_fifo))
            mod[:take] = self._mod_fifo[:take]
            self._mod_fifo = self._mod_fifo[take:]
            with span("live_vocoder", self.device):
                vocoded = self.vocoder.process(torch.from_numpy(mod).to(self.device),
                                               carrier)
                profiling.LIVE_WAITS += 1  # the modulator block up
            out = out + vocoded[:, None]
        return out

    def process(self, input_block) -> torch.Tensor:
        """The duplex callback (rt.resynth.lib.cpp:1285): feed the captured
        block, then pull as many frames -> (n, 2) float64 tensor on
        `device`, equal to the bit to feed() followed by pull()."""
        block = np.atleast_1d(np.asarray(input_block, np.float64))
        with span("duplex", self.device):
            self.feed(block)
            return self.pull(block.shape[0])

    def run_duplex(self, signal, block_size: int = 512) -> torch.Tensor:
        """Offline-driven duplex loop: one process() callback per block, like
        the reference's offline ctor loop (rt.resynth.lib.cpp:1185-1235)."""
        signal = np.asarray(signal, np.float64)
        parts = []
        for i in range(0, len(signal), block_size):
            parts.append(self.process(signal[i : i + block_size]))
        if not parts:
            return torch.zeros((0, 2), dtype=torch.float64, device=self.device)
        return torch.cat(parts)
