/* AudioWorklet processor for the streaming birds demo.
 *
 * Reference analog: docs/js/birds-worklet-processor.js, which calls the WASM
 * engine's process(in, out) per 128-frame render quantum
 * (source/unity.build.birds.lib.cpp:47,200-240). Here the engine renders
 * server-side; the main thread posts interleaved-stereo f32 PCM chunks into
 * this processor's ring buffer and we emit 128-frame quanta from it.
 */
class BirdsStreamProcessor extends AudioWorkletProcessor {
  constructor() {
    super();
    this.capacity = sampleRate * 8;           // 8 s ring, per channel
    this.ring = [new Float32Array(this.capacity),
                 new Float32Array(this.capacity)];
    this.readPos = 0;
    this.writePos = 0;
    this.queued = 0;
    this.port.onmessage = (e) => {
      if (e.data.flush) { this.readPos = this.writePos; this.queued = 0; }
      if (e.data.pcm) this.enqueue(new Float32Array(e.data.pcm));
      this.port.postMessage({queuedFrames: this.queued});
    };
  }

  enqueue(interleaved) {
    const n = interleaved.length >> 1;
    for (let i = 0; i < n; i++) {
      const w = (this.writePos + i) % this.capacity;
      this.ring[0][w] = interleaved[2 * i];
      this.ring[1][w] = interleaved[2 * i + 1];
    }
    this.writePos = (this.writePos + n) % this.capacity;
    this.queued = Math.min(this.queued + n, this.capacity);
  }

  process(inputs, outputs) {
    const out = outputs[0];
    const n = out[0].length;                  // 128-frame quantum
    const take = Math.min(n, this.queued);
    for (let ch = 0; ch < out.length; ch++) {
      const src = this.ring[Math.min(ch, 1)];
      for (let i = 0; i < take; i++)
        out[ch][i] = src[(this.readPos + i) % this.capacity];
      for (let i = take; i < n; i++) out[ch][i] = 0;  // underrun -> silence
    }
    this.readPos = (this.readPos + take) % this.capacity;
    this.queued -= take;
    return true;
  }
}
registerProcessor('birds-stream-processor', BirdsStreamProcessor);
