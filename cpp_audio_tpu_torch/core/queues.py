"""Sample-stream queues with dropped-frame accounting — the RT/NRT
transport layer (reference rt.resynth.lib.metaqueue.cpp / pubsub.cpp).

Reference components:
- `MetaQueue` (metaqueue.cpp:10-50): an SPSC queue whose items are either
  samples or in-band `CountDroppedFrames` tokens, so consumers observe
  exactly where overruns happened.
- `drain_queue_until_size_smaller` (metaqueue.cpp:54).
- `SampleContinuity` (metaqueue.cpp:70): marks whether a stream resumed
  contiguously after drops.
- `ReadQueuedSampleSource` (metaqueue.cpp:78-158): starts consuming only
  once the queue is half-full, balancing latency against starvation.
- `AudioBufferAggregator`: zips several streams sample-by-sample.
- `AudioBufferPubSub` (pubsub.cpp:12): fans the RT signal out to listener
  queues, dropping (with accounting) when a listener lags.

Context: these carry audio between the host callback world and
the device-block world (the native SPSC ring in native/ringbuffer.cpp is the
lock-free transport; this module is the bookkeeping layer above it, which is
pure control logic and stays in Python).

Host copy of cpp_audio_tpu/core/queues.py.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass
class DroppedFrames:
    """In-band overrun token (reference CountDroppedFrames)."""

    count: int


class MetaQueue:
    """Bounded item-granular FIFO of samples with in-band drop accounting,
    exactly the reference MetaQueue over an SPSC variant queue
    (metaqueue.cpp:10-50; pinned against the compiled reference by
    tests/test_reference_oracle.py):

    - capacity counts ITEMS (samples and drop tokens alike);
    - a buffer push is per-sample: when the queue fills mid-buffer only the
      REMAINDER is dropped (accumulated into a pending token);
    - the pending token is pushed in-band before the next buffer — and if
      even the token doesn't fit, the whole new buffer is dropped too.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._q: deque = deque()  # float samples and DroppedFrames tokens
        self._pending_drops = 0
        self.total_dropped = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def fill_ratio(self) -> float:
        return len(self._q) / self.capacity if self.capacity else 0.0

    def try_push(self, block) -> bool:
        block = np.atleast_1d(np.asarray(block, np.float64))
        n = len(block)
        if self._pending_drops:
            if len(self._q) >= self.capacity:
                self._pending_drops += n
                self.total_dropped += n
                return False
            self._q.append(DroppedFrames(self._pending_drops))
            self._pending_drops = 0
        for i in range(n):
            if len(self._q) >= self.capacity:
                self._pending_drops += n - i
                self.total_dropped += n - i
                return False
            self._q.append(float(block[i]))
        return True

    def pop(self):
        """Next item: a float sample or a DroppedFrames token (None if
        empty)."""
        if not self._q:
            return None
        return self._q.popleft()

    def drain_until_size_smaller(self, target: int) -> int:
        """Discard oldest items until at most target remain — silently, like
        the reference (drain_queue_until_size_smaller, metaqueue.cpp:54-67:
        plain try_pop, no accounting; its callers balance LATENCY with it,
        the loss is signalled separately by the drop token that triggered
        it). Returns the number of items discarded."""
        dropped = 0
        while len(self._q) > target:
            self._q.popleft()
            dropped += 1
        return dropped


@dataclass
class SampleContinuity:
    """Whether the consumed stream is gap-free (metaqueue.cpp:70)."""

    contiguous: bool = True

    def on_drop(self) -> None:
        self.contiguous = False


class ReadQueuedSampleSource:
    """Pull-side adapter that starts only at half-full occupancy
    (reference metaqueue.cpp:78-158): it waits for capacity/2 queued items,
    then DRAINS down to capacity/2 (latency balancing) before the first
    read; a drop token re-establishes the balance by draining again and
    marks the stream discontinuous. One reference delta: on a true underrun
    after start the reference throws ("should never happen"); here the
    stream degrades to zeros with `underruns` accounting instead."""

    def __init__(self, queue: MetaQueue):
        self.queue = queue
        self.started = False
        self.continuity = SampleContinuity()
        self.underruns = 0

    @property
    def _min_size(self) -> int:
        return self.queue.capacity // 2

    def read_one(self):
        """One sample (metaqueue.cpp:90-142): None while pre-rolling."""
        if not self.started:
            if len(self.queue) < self._min_size:
                return None
            self.queue.drain_until_size_smaller(self._min_size)
            self.started = True
        while True:
            item = self.queue.pop()
            if item is None:
                self.underruns += 1
                self.continuity.on_drop()
                return 0.0
            if isinstance(item, DroppedFrames):
                self.queue.drain_until_size_smaller(self._min_size)
                self.continuity.on_drop()
                continue
            return item

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(n)
        for i in range(n):
            v = self.read_one()
            if v is not None:
                out[i] = v
        return out


class AudioBufferAggregator:
    """Zip several sample streams into one summed stream, halting on the
    shortest (the reference aggregates input + delayed-output feedback)."""

    def __init__(self, *sources):
        self.sources = list(sources)

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(n)
        for s in self.sources:
            out += s.read(n)
        return out


class AudioBufferPubSub:
    """Fan a signal out to listener MetaQueues (reference pubsub.cpp:12):
    publishing never blocks; lagging listeners drop with accounting."""

    def __init__(self):
        self._listeners: list[MetaQueue] = []

    def add_listener(self, capacity: int) -> MetaQueue:
        q = MetaQueue(capacity)
        self._listeners.append(q)
        return q

    def remove_listener(self, q: MetaQueue) -> None:
        if q in self._listeners:
            self._listeners.remove(q)

    def try_publish_buffer(self, block) -> int:
        """Publish to all listeners; returns how many accepted."""
        ok = 0
        for q in self._listeners:
            ok += bool(q.try_push(block))
        return ok
