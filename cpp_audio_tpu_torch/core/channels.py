"""Channel-based playback queues with equal-gain request crossfades.

The reference's (deprecated but still-used) first-generation engine plays
`Request`s — (buffer, per-output volumes, duration-in-frames) — through
`Channel` queues that crossfade between consecutive requests
(include/request.h:27,177,268,365,412; include/channel.h:88), pooled by
`Channels` with auto-close channel reuse (include/channels.h:213-272) and
aggregated per crossfade policy by `ChannelsVecAggregate`
(include/channels_aggregate.h:6-47).

This module is a faithful model of the reference's Channel state machine,
validated frame-exactly against the compiled reference channel
(tests/test_reference_oracle.py, `oracle channel`). The machine
(channel.h:242-900):

- A crossfade of odd size `2h+1` is split into a LEFT half (`h+1` frames,
  outgoing ratio 1 -> 0.5, written by handleToZero/write_left_xfade and
  counted against the OUTGOING request's remaining samples,
  channel.h:766-785) and a RIGHT half (`h` frames, incoming ratio rising
  0.5+1/(2h) -> 1, written by duringRightXfade/write_right_xfade and counted
  against the INCOMING request, channel.h:741-760,707-714). Request
  durations therefore span mid-seam to mid-seam: the rendered timeline is
  `sum(durations) + size_xfade - 1` frames and each request occupies exactly
  its `duration_in_frames` of it.
- The FIRST request fades in from zero and the queue end fades out to zero
  through the same ladder, emulated by pseudo-requests with no buffer: a
  from-zero pseudo (duration 2*size_xfade, remaining h+1, channel.h:325-329)
  and a to-zero pseudo (duration size_xfade-1, remaining h,
  channel.h:318-323).
- At `onBeginToZero` (channel.h:716-739) the incoming soundBuffer's read
  index is synchronized to `(size-1-h) mod size` so that buffer index 0
  lands just past mid-seam ("a sinus will start at the first positive
  value").
- `addRequest` REJECTS requests shorter than `2*size_xfade` under UseXfade
  (channel.h:242-252) and returns False.
- Channel volume ramps (`toVolume`, channel.h:215-219,692-698) step
  `(target-current)/n` per frame, applied BEFORE the multiply, and only on
  frames actually written (silence after the queue drains does not advance
  the ramp).
- `xfade_now` (channel.h:107-124) starts the seam on the very next frame;
  `stopPlayingByXFadeToZero` (channel.h:260-268) is a volume ramp to zero
  with `active=false`, after which `shouldReset` (channel.h:281-289) clears
  the queue.
- SkipXfade channels splice requests raw from buffer index 0 with exact
  durations and no fades (channel.h:296-310).

Design: there is no RT thread, so the queue logic is plain host
control flow, and the per-sample writer loops become vectorized block
writes: `write_single` is one modular gather over the looping buffer, the
xfade writers are short ladder-weighted gathers. Buffers loop (the
reference's soundBuffers are periodic tables), so a request longer than its
buffer tiles it — a gather, not a copy.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class XfadePolicy(enum.Enum):
    """Reference include/channel.h XfadePolicy (UseXfade / SkipXfade)."""

    USE_XFADE = "use_xfade"
    SKIP_XFADE = "skip_xfade"


class ClosingPolicy(enum.Enum):
    """Reference include/channels.h ChannelClosingPolicy."""

    AUTO_CLOSE = "auto_close"
    EXPLICIT_CLOSE = "explicit_close"


@dataclass(frozen=True)
class Request:
    """A playable item (reference include/request.h:27).

    buffer   : (m,) mono or (m, n_outs) frames; loops if duration > m
               (the reference's periodic soundBuffer).
    volumes  : scalar or (n_outs,) per-output gains (reference Volumes<n>).
    length   : duration in frames (reference `duration_in_frames`).
    """

    buffer: np.ndarray
    volumes: np.ndarray
    length: int

    @staticmethod
    def make(buffer, volumes=1.0, length: int | None = None,
             n_outs: int = 2) -> "Request":
        buf = np.asarray(buffer, np.float64)
        vol = np.broadcast_to(np.asarray(volumes, np.float64), (n_outs,)).copy()
        if length is None:
            length = buf.shape[0]
        if length <= 0:
            raise ValueError("request length must be positive")
        return Request(buf, vol, int(length))

    def read(self, start: int, n: int, n_outs: int) -> np.ndarray:
        """Frames [start, start+n) of the looping buffer as (n, n_outs),
        volumes applied (reference write_single_SoundBuffer wrap-at-size,
        channel.h:368-387)."""
        m = self.buffer.shape[0]
        idx = (start + np.arange(n)) % m
        seg = self.buffer[idx]
        if seg.ndim == 1:
            seg = seg[:, None]
        if seg.shape[1] < n_outs:
            seg = np.broadcast_to(seg[:, :1], (n, n_outs))
        return seg[:, :n_outs] * self.volumes[None, :n_outs]


def silence(length: int) -> Request:
    """A silent request (reference plays a zeroed soundBuffer for rests)."""
    return Request(np.zeros(1), np.zeros(2), int(length))


class Channel:
    """A playback queue with equal-gain crossfades between consecutive
    requests — a frame-exact model of reference include/channel.h:88
    (see module docstring for the machine)."""

    def __init__(self, n_outs: int = 2, xfade_length: int = 401,
                 xfade_policy: XfadePolicy = XfadePolicy.USE_XFADE,
                 volume: float = 1.0):
        if xfade_policy is XfadePolicy.USE_XFADE:
            if xfade_length < 3:
                xfade_length = 3           # min_xfade_size, channel.h:96
            if xfade_length % 2 == 0:      # odd, channel.h:224
                xfade_length += 1
        self.n_outs = n_outs
        self.xfade_policy = xfade_policy
        self._half = (xfade_length - 1) // 2   # size_half_xfade
        self._queue: list[Request] = []
        self._played_any = False   # guards auto-close reuse of fresh channels
        # --- reference Channel state (channel.h:130-152) ---
        self._current: Request | None = None   # real request being played
        self._cur_dur = 0          # current.duration_in_frames (pseudo too)
        self._cur_pseudo = False   # current is a from/to-zero pseudo-request
        self._previous: Request | None = None
        self._rsc = 0              # remaining_samples_count
        self._cni = 0              # current_next_sample_index
        self._oni = 0              # other_next_sample_index
        self._next = False         # seam is between two requests
        self._active = True
        self._vol = float(volume)          # chan_vol.current
        self._vol_inc = 0.0                # chan_vol.increments
        self._vol_rem = 0                  # volume_transition_remaining
        self.closing_policy = ClosingPolicy.EXPLICIT_CLOSE
        self.open = True

    # -- xfade geometry ----------------------------------------------------
    @property
    def xfade_length(self) -> int:
        return 1 + 2 * self._half      # get_size_xfade, channel.h:230

    def _xinc(self) -> float:
        return 1.0 / (self.xfade_length - 1.0)   # channel.h:236-238

    # -- queue API (reference channel.h addRequest:242) --------------------
    def add_request(self, req: Request) -> bool:
        if (self.xfade_policy is XfadePolicy.USE_XFADE
                and req.length < 2 * self.xfade_length):
            return False               # channel.h:244-246
        self._played_any = True
        self._queue.append(req)
        return True

    def play(self, *requests: Request) -> None:
        for r in requests:
            if not self.add_request(r):
                raise ValueError(
                    f"request length {r.length} < 2*xfade "
                    f"({2 * self.xfade_length}) rejected (channel.h:244)")

    def cancel_last_request(self) -> None:
        if self._queue:
            self._queue.pop()

    # -- status -------------------------------------------------------------
    def _should_reset(self) -> bool:
        # channel.h:281-289: once a fade-to-zero ramp has run its course
        if self._active:
            return False
        if self._vol_inc < 0.0 and abs(self._vol_inc) < abs(self._vol):
            return False
        return True

    def is_playing(self) -> bool:
        if self._should_reset():
            return False
        # channel.h:271-279: pseudo-requests (no buffer) do not count
        return bool(self._rsc != 0 or self._queue or self._current is not None)

    @property
    def done(self) -> bool:
        return not self.is_playing()

    @property
    def reusable(self) -> bool:
        """Finished auto-close channels can be handed out again
        (reference channels.h:213-272 autoclosed-channel reuse)."""
        return (self.closing_policy is ClosingPolicy.AUTO_CLOSE
                and self._played_any and self.done)

    # -- volume -------------------------------------------------------------
    def set_volume(self, target: float, n_steps: int = 0) -> None:
        """Instant setVolume (channel.h:209) or toVolume ramp over n_steps
        frames (channel.h:215-219), stepped pre-multiply per written frame."""
        if n_steps <= 0:
            self._vol = float(target)
            self._vol_inc = 0.0
            self._vol_rem = 0
        else:
            self.to_volume(target, n_steps)

    def to_volume(self, target: float, n_steps: int) -> None:
        self._vol_rem = int(n_steps)
        self._vol_inc = (float(target) - self._vol) / n_steps

    def _vol_curve(self, n: int) -> np.ndarray:
        """stepVolume (channel.h:692-698) applied to n written frames: the
        increment lands BEFORE each multiply, and stops after _vol_rem."""
        if self._vol_rem == 0:
            return np.full(n, self._vol)
        steps = np.minimum(np.arange(n) + 1.0, self._vol_rem)
        curve = self._vol + self._vol_inc * steps
        took = min(n, self._vol_rem)
        self._vol += self._vol_inc * took
        self._vol_rem -= took
        return curve

    # -- control ------------------------------------------------------------
    def xfade_now(self) -> None:
        """Start the crossfade to the next request (or the fade-out) on the
        very next frame (channel.h:107-124)."""
        assert self.xfade_policy is XfadePolicy.USE_XFADE
        new_c = 1 + self._half
        if self._queue:
            self._rsc = new_c
            self._cur_dur = self.xfade_length
        else:
            self._rsc = new_c

    def stop_playing_by_xfade_to_zero(self, n_steps: int) -> None:
        """channel.h:260-268: fade the channel volume to zero over n_steps
        (negative = one xfade length); the channel then resets."""
        self._active = False
        if n_steps < 0:
            n_steps = self.xfade_length
        self.to_volume(0.0, n_steps)

    # -- the state machine (channel.h:296-900) ------------------------------
    def _consume(self) -> bool:
        """channel.h consume(): advance to the next request or install a
        from-zero / to-zero pseudo-request. Returns False when fully done."""
        if self.xfade_policy is XfadePolicy.SKIP_XFADE:
            if not self._queue:
                self._current = None
                return False
            self._current = self._queue.pop(0)
            self._cur_dur = self._current.length
            self._rsc = self._cur_dur
            self._cni = 0
            return True
        backup = self._cni
        self._previous = self._current
        prev_pseudo = self._cur_pseudo
        self._current = None
        self._cur_pseudo = False
        if not self._queue:
            if self._previous is None:
                return False
            # emulate a right xfade 'to zero' (channel.h:318-323)
            self._cur_pseudo = True
            self._cur_dur = self.xfade_length - 1
            self._rsc = self._half
            self._cni = 0
        elif not self._next:
            # emulate a left xfade 'from zero' (channel.h:325-329)
            self._cur_pseudo = True
            self._cur_dur = 2 * self.xfade_length
            self._rsc = self._half + 1
        else:
            self._current = self._queue.pop(0)
            self._cur_dur = self._current.length
            self._rsc = self._cur_dur
            self._cni = self._oni
        if prev_pseudo:
            self._previous = None   # pseudo-requests have no buffer
        self._oni = backup
        return True

    def _done(self) -> bool:
        if self._should_reset():
            # channel.h done(): avoid residual noise at very low volume
            self._queue.clear()
            self._current = None
            self._previous = None
            self._cur_pseudo = False
            self._rsc = 0
            return True
        return self._rsc == 0 and not self._consume()

    def _xfade_from_zero_remaining(self) -> int:
        # channel.h:707-714
        if self._next:
            return self._half - (self._cur_dur - self._rsc)
        return (self.xfade_length - 1) - (self._cur_dur - self._rsc)

    def _on_begin_to_zero(self) -> None:
        # channel.h:716-739: sync the incoming buffer so index 0 lands just
        # past mid-seam
        self._next = bool(self._queue)
        if self._next:
            sz = self._queue[0].buffer.shape[0]
            self._oni = (sz - 1 - self._half) % sz

    def _mix(self, out: np.ndarray, pos: int, n: int,
             cur_w: np.ndarray | float, other: Request | None,
             other_w: np.ndarray | None) -> None:
        """One vectorized xfade/single segment: out[pos:pos+n] += volumes
        and the channel volume curve applied per frame."""
        vol = self._vol_curve(n)
        acc = np.zeros((n, self.n_outs))
        if self._current is not None:
            acc += self._current.read(self._cni, n, self.n_outs) \
                * (np.asarray(cur_w).reshape(-1, 1) if np.ndim(cur_w) else cur_w)
            self._cni = (self._cni + n) % self._current.buffer.shape[0]
        if other is not None and other_w is not None:
            acc += other.read(self._oni, n, self.n_outs) * other_w.reshape(-1, 1)
            self._oni = (self._oni + n) % other.buffer.shape[0]
        out[pos:pos + n] += acc * vol[:, None]

    def _write_left_xfade(self, out, pos, ratio: float, n: int) -> None:
        # channel.h:411-444: outgoing `current` falls from `ratio`, the
        # incoming queue front rises (1-ratio), both stepping 1/(size-1)
        w = ratio - self._xinc() * np.arange(n)
        other = self._queue[0] if (self._next and self._queue) else None
        self._mix(out, pos, n, w, other, (1.0 - w) if other is not None else None)

    def _write_right_xfade(self, out, pos, ratio: float, n: int) -> None:
        # channel.h:446-475: incoming `current` rises from 1-ratio while
        # `previous` finishes its fall
        w = (1.0 - ratio) + self._xinc() * np.arange(n)
        other = self._previous if (self._next or self._current is None) else None
        self._mix(out, pos, n, w, other, (1.0 - w) if other is not None else None)

    def _during_right_xfade(self, out, pos: int, budget: int) -> tuple[int, bool]:
        """channel.h:741-760. Returns (frames written, machine done)."""
        remaining = self._xfade_from_zero_remaining()
        nw = min(remaining, self._rsc, budget)
        if nw > 0:
            ratio = (remaining - 1.0) / (2.0 * self._half)
            self._write_right_xfade(out, pos, ratio, nw)
            self._rsc -= nw
        if remaining == nw:
            self._previous = None
        # the reference evaluates done() (and thus possibly consume()) even
        # when the budget is exhausted (channel.h:758) — observable when a
        # request is added between steps
        return nw, self._done()

    def _handle_to_zero(self, out, pos: int, budget: int) -> tuple[int, bool]:
        """channel.h:766-785. Returns (frames written, continue machine)."""
        if self._rsc == self._half + 1:
            self._on_begin_to_zero()
        ratio = 0.5 + (self._rsc - 1.0) / (2.0 * self._half)
        nw = min(self._rsc, budget)
        self._write_left_xfade(out, pos, ratio, nw)
        self._rsc -= nw
        if budget - nw <= 0:
            return nw, False
        return nw, self._consume()

    def step(self, n: int) -> np.ndarray:
        """Emit the next n frames as (n, n_outs), consuming the queue —
        reference Channel::step (channel.h:784-900), vectorized."""
        out = np.zeros((n, self.n_outs))
        pos = 0
        if self._done():
            return out
        if self.xfade_policy is XfadePolicy.SKIP_XFADE:
            while pos < n:
                nw = min(self._rsc, n - pos)
                self._mix(out, pos, nw, 1.0, None, None)
                self._rsc -= nw
                pos += nw
                if self._rsc == 0 and not self._consume():
                    break
            return out
        budget = n
        while True:
            while self._rsc < budget:
                remaining = self._xfade_from_zero_remaining()
                if remaining > 0:
                    nw, fin = self._during_right_xfade(out, pos, budget)
                    pos += nw
                    budget -= nw
                    if fin or budget <= 0:
                        return out
                normal = self._rsc - (self._half + 1)
                if normal > 0:
                    nw = min(normal, budget)
                    self._mix(out, pos, nw, 1.0, None, None)
                    self._rsc -= nw
                    pos += nw
                    budget -= nw
                    if budget <= 0:
                        return out
                nw, cont = self._handle_to_zero(out, pos, budget)
                pos += nw
                budget -= nw
                if not cont:
                    return out
            remaining = self._xfade_from_zero_remaining()
            if remaining > 0:
                nw, fin = self._during_right_xfade(out, pos, budget)
                pos += nw
                budget -= nw
                if fin or budget <= 0:
                    return out
                if self._rsc < budget:
                    continue
            normal = self._rsc - (self._half + 1)
            if normal > 0:
                nw = min(normal, budget)
                self._mix(out, pos, nw, 1.0, None, None)
                self._rsc -= nw
                pos += nw
                budget -= nw
                if budget <= 0:
                    return out
            if self._rsc <= self._half + 1:
                nw, cont = self._handle_to_zero(out, pos, budget)
                pos += nw
                budget -= nw
                if not cont:
                    return out
                continue
            return out


class Channels:
    """Channel pool (reference include/channels.h:10-400): open_channel with
    auto-close reuse, play onto a channel, sum all channels per block."""

    def __init__(self, n_outs: int = 2, n_channels: int = 32,
                 xfade_length: int = 401,
                 xfade_policy: XfadePolicy = XfadePolicy.USE_XFADE):
        self.n_outs = n_outs
        self.xfade_policy = xfade_policy
        self.xfade_length = xfade_length
        self._channels: dict[int, Channel] = {}
        self._next_id = 0
        self.max_channels = n_channels

    def open_channel(self, volume: float = 1.0,
                     closing_policy: ClosingPolicy = ClosingPolicy.AUTO_CLOSE,
                     xfade_length: int | None = None) -> int:
        # reuse a finished auto-close channel before allocating a new one
        for cid, ch in self._channels.items():
            if ch.reusable:
                self._channels[cid] = self._mk(volume, closing_policy,
                                               xfade_length)
                return cid
        if len(self._channels) >= self.max_channels:
            raise RuntimeError("out of channels")
        cid = self._next_id
        self._next_id += 1
        self._channels[cid] = self._mk(volume, closing_policy, xfade_length)
        return cid

    def _mk(self, volume, closing_policy, xfade_length) -> Channel:
        ch = Channel(self.n_outs,
                     self.xfade_length if xfade_length is None else xfade_length,
                     self.xfade_policy, volume)
        ch.closing_policy = closing_policy
        return ch

    def play(self, channel_id: int, *requests: Request) -> None:
        self._channels[channel_id].play(*requests)

    def close(self, channel_id: int) -> None:
        self._channels.pop(channel_id, None)

    def close_with_fadeout(self, channel_id: int, fadeout_frames: int = 5000) -> None:
        """Fade the channel to silence over fadeout_frames instead of cutting
        (reference AudioOutContext xfade_on_close = 5000 samples,
        include/audio_context.h:73, via stopPlayingByXFadeToZero)."""
        ch = self._channels.get(channel_id)
        if ch is None:
            return
        if ch.is_playing():
            ch.stop_playing_by_xfade_to_zero(fadeout_frames)
        ch.closing_policy = ClosingPolicy.AUTO_CLOSE

    def channel(self, channel_id: int) -> Channel:
        return self._channels[channel_id]

    def step(self, n: int) -> np.ndarray:
        out = np.zeros((n, self.n_outs))
        for ch in self._channels.values():
            if not ch.done:
                out += ch.step(n)
        return out

    def render(self, n: int, block_size: int = 4096) -> np.ndarray:
        blocks = [self.step(min(block_size, n - i))
                  for i in range(0, n, block_size)]
        return np.concatenate(blocks, axis=0) if blocks else np.zeros((0, self.n_outs))

    @property
    def done(self) -> bool:
        return all(ch.done for ch in self._channels.values())


@dataclass
class ChannelsAggregate:
    """Three channel collections by crossfade flavor (reference
    include/channels_aggregate.h:6-47: XFade / NoXFade / XFadeInfinite)."""

    n_outs: int = 2
    xfade: Channels = None           # type: ignore[assignment]
    no_xfade: Channels = None        # type: ignore[assignment]
    xfade_infinite: Channels = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.xfade is None:
            self.xfade = Channels(self.n_outs, xfade_policy=XfadePolicy.USE_XFADE)
        if self.no_xfade is None:
            self.no_xfade = Channels(self.n_outs, xfade_policy=XfadePolicy.SKIP_XFADE)
        if self.xfade_infinite is None:
            self.xfade_infinite = Channels(self.n_outs, xfade_length=4001,
                                           xfade_policy=XfadePolicy.USE_XFADE)

    def step(self, n: int) -> np.ndarray:
        return (self.xfade.step(n) + self.no_xfade.step(n)
                + self.xfade_infinite.step(n))
