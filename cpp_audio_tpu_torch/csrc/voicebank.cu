// Voice-bank block renderer for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cpp_audio_tpu/ops/pallas_voicebank.py:30
// (_kernel, launched by render_blocks_pallas at :86), and also evaluates the
// per-voice eased curve codes that only the XLA form had
// (cpp_audio_tpu/models/voicebank.py:180 _render_block), so every voice-bank
// render of the port on CUDA runs here.
//
// What it computes, per time block b, sample k of that block and voice row v
// (b counts from block_offset: a launch renders blocks block_offset ..
// block_offset + n_blocks - 1 of the timeline into its output's blocks
// 0 .. n_blocks - 1; a compacted table's rows stay indexed by the local b):
//   phase  = ((b*B - press + 1) + k) * inc + phase0   mod 2^32   (exact NCO)
//            bitcast to int32, times 2^-31 -> rad/pi in [-1, 1)
//   env    = closed-form AHDSR from int32 sample offsets (attack, hold,
//            decay to S, release from the precomputed `top`; 0 before the
//            press and when skipped), each segment through its easing curve
//   sig    = amp * env * sinpi_principal(phase)
//   out[b*B + k, c] = sum_v sig * gains[v, c]          (voice order)
//
// Design. One CTA renders one tile of kTile = 1024 samples of one block
// (grid: tiles x blocks); nothing carries between CTAs.
//  1. Live rows per tile. The CTA reads the block's rows kThreads at a time;
//     each thread tests one row: not skipped, pressed by the tile's last
//     sample, and its release tail not over at the tile's first sample —
//     the same int32 offsets and float compares as the per-sample envelope,
//     so a row that fails renders exact zeros over the whole tile. A warp
//     ballot and a prefix over the warps' counts pack the live rows into
//     shared memory in voice order, with what the sample loop needs
//     precomputed. A tile with no live row writes zeros. At the headline
//     workload (bench.py:52-75) this drops 69% of the row-samples that a
//     dense (rows x samples) loop evaluates.
//  2. Envelope segment hoisted. The envelope's segment (before the press,
//     attack, hold, decay, sustain, release, silent) never decreases with k:
//     both offsets grow and float rounding is monotone. So when the tile's
//     first and last samples fall in one segment, every sample between does;
//     the CTA decides that once per row. A row in hold or sustain over the
//     whole tile (most of the headline's live voice-samples) folds amp * env
//     into its gains. Any other row evaluates env * sin (the segment's
//     formula through the 23-curve switch, with the row's reciprocals 1/A,
//     1/max(D,1), 1/R in place of the divisions) in a rolled loop into
//     shared memory, each thread deciding the segment once for its 8
//     samples, or per sample where it changes inside them. No sample loop
//     calls a slow-path subroutine (IEEE division, sqrtf, sinf): such calls
//     made ptxas keep the loop state in local memory.
//  3. Stepped NCO. Each thread owns 8 consecutive samples, so its uint32
//     phase word advances by `+= inc` — the same bits as the closed form.
//     The word carries a quarter-turn offset q = phase + 2^30, so the
//     principal reduction is integer work instead of two conversions (I2F
//     and FRND, quarter-rate on sm_90): the top bit of q is the sign flip
//     (round(x) = +-1), and the low 31 bits minus 2^30 are the reduced
//     z in [-0.5, 0.5], rounded to 2^-23 by placing them in a float's
//     mantissa. That rounding (<= 2^-24 rad/pi) plus the plain version's
//     own rounding of float(word) (<= 2^-25) moves sin by <= 2.8e-7 per
//     voice-sample, so 64 voices at full gain stay below the 2e-5 bar even
//     if every error had the same sign. It measured faster than the
//     I2F + rintf form at the headline (tools/voicebank_ab.py, PERF.md).
//     Stores are float4.
//  4. Occupancy and balance. 128 threads x 8 samples: 256 threads measured
//     within 2%, 16 samples a thread slower (more registers, coarser live
//     selection). `__launch_bounds__(128, 9)` holds ptxas to 56 registers,
//     9 CTAs per SM: 3% faster at the headline than the 63 registers it
//     picks alone, despite a few bytes of spills (tools/voicebank_ab.py,
//     PERF.md). CTAs are small (at most
//     128 rows x 1024 samples) and many (256 tiles x 11 blocks at the
//     headline), so the hardware's dynamic CTA scheduling balances the
//     uneven live counts (0-48 rows); a persistent grid with a heaviest-first
//     work list would need the live counts before the launch, i.e. a
//     pre-pass, for a tail of at most one CTA per SM.
//  Tensor cores and TMA do not serve this kernel: the mixdown has C <= 2
//  columns, below wgmma's minimum width of 8, and is 2 of ~15 operations
//  per voice-sample; a row's tables are 76 bytes, read once per CTA.
//
// Bound (cuda_voicebank.kernel_bound, PERF.md): FP32 operations per live
// voice-sample (FMA = 2), counted from this source for LINEAR curves: 11 + 2C
// in hold and sustain (z, z^2, the polynomial's four FMAs and product, one
// FMA per channel), 7 / 11 / 9 more in attack / decay / release (the
// segment's formula in envelope(), with the envelope product). At the
// headline's 44.9 M live voice-samples that is 0.68 GFLOP, 10 us at
// 67 TFLOP/s, above the 23 MB of output at 3.35 TB/s (7 us): the kernel is
// operations-bound. The flop count leaves out the integer NCO and reduction
// (5 INT32 instructions per voice-sample) and the per-row set-up, which take
// issue slots too: the hold/sustain loop issues ~14 instructions per
// voice-sample for 15 flops, where 14 slots of FMAs would be 28, so even at
// full issue it reaches ~54% of the flop bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound through ctypes (cpp_audio_tpu_torch/ops/cuda_voicebank.py); the host
// function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSamplesPerThread = 8;
constexpr int kTile = kThreads * kSamplesPerThread;
constexpr int kWarps = kThreads / 32;

// packed float field order (cpp_audio_tpu/models/voicebank.py:136)
enum { F_AMP, F_A, F_H, F_D, F_R, F_S, F_TOP, F_SKIP, N_FIELDS };

// envelope segments, in the order a row passes through them
enum { SEG_PRE, SEG_ATTACK, SEG_HOLD, SEG_DECAY, SEG_SUSTAIN, SEG_RELEASE,
       SEG_SILENT, SEG_MIXED };

// sin(pi*z) = z*(C1 + C3 z^2 + C5 z^4 + C7 z^6 + C9 z^8), z in [-0.5, 0.5]
// (cpp_audio_tpu/ops/fastmath.py:21-25)
__device__ __forceinline__ float poly_sinpi(float z) {
  const float z2 = z * z;
  return z * (3.14159258f + z2 * (-5.16770687f + z2 * (2.55003119f +
         z2 * (-0.59804419f + z2 * 0.07721839f))));
}

// sin(pi * x) for the NCO word w (x = int32(w) * 2^-31), given q = w + 2^30.
// round(x) is 0 when q's top bit is clear and +-1 when it is set, where the
// result changes sign; z = x - round(x) is ((q & 0x7fffffff) - 2^30) * 2^-31.
// 1 + (q & 0x7fffffff) * 2^-31, rounded to the float grid of [1, 2], is built
// in the mantissa; minus 1.5 it is z exactly. The sign goes onto z: the
// polynomial is odd.
__device__ __forceinline__ float sinpi_word(unsigned q) {
  const unsigned m = ((q & 0x7fffffffu) + 128u) >> 8;
  const float z = __uint_as_float(0x3f800000u + m) - 1.5f;
  return poly_sinpi(__uint_as_float(__float_as_uint(z) ^ (q & 0x80000000u)));
}

// sqrt for v >= 0 through the hardware reciprocal square root: no slow
// path (a subroutine call) in the sample loops
__device__ __forceinline__ float sqrt_nonneg(float v) {
  return v > 0.0f ? v * rsqrtf(v) : 0.0f;
}

// Penner easing families, in-curves and out-curves (utils/interp.py). The
// sine family uses the hardware sin/cos (abs error < 5e-7 on [0, pi/2]).
__device__ __forceinline__ float ease_in(int family, float x) {
  switch (family) {
    case 0: return x * x;
    case 1: return x * x * x;
    case 2: return x * x * x * x;
    case 3: return x * x * x * x * x;
    case 4: return 1.0f - __cosf(x * 1.57079632679489662f);
    case 5: return x <= 0.0f ? 0.0f : exp2f(10.0f * (x - 1.0f));
    default: return 1.0f - sqrt_nonneg(1.0f - x * x);
  }
}

__device__ __forceinline__ float ease_out(int family, float x) {
  const float y = x - 1.0f;
  switch (family) {
    case 0: return x * (2.0f - x);
    case 1: return y * y * y + 1.0f;
    case 2: return 1.0f - y * y * y * y;
    case 3: return y * y * y * y * y + 1.0f;
    case 4: return __sinf(x * 1.57079632679489662f);
    case 5: return x >= 1.0f ? 1.0f : 1.0f - exp2f(-10.0f * x);
    default: return sqrt_nonneg(1.0f - y * y);
  }
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// The 23 itp curves (Itp enum, utils/interp.py): 0 LINEAR and
// 1 PROPORTIONAL_VALUE_DERIVATIVE are the identity in the endpoint-free
// table; codes 2..22 are (in, out, in-out) for quad, cubic, quart, quint,
// sine, expo, circ. Unknown codes leave x unchanged (the select's default).
__device__ __forceinline__ bool is_identity(int code) {
  return code < 2 || code > 22;
}

__device__ __forceinline__ float ease(int code, float x) {
  x = clamp01(x);
  if (is_identity(code)) return x;
  const int family = (code - 2) / 3;
  switch ((code - 2) % 3) {
    case 0: return ease_in(family, x);
    case 1: return ease_out(family, x);
    default:
      return x < 0.5f ? 0.5f * ease_in(family, 2.0f * x)
                      : 0.5f + 0.5f * ease_out(family, 2.0f * x - 1.0f);
  }
}

// One live row, staged in shared memory for the tile.
struct Row {
  float A, H, AH, AHD, R, S, top;
  float rA, rDm, rR;  // 1/A, 1/max(D, 1), 1/R (hardware reciprocal)
  float tp0, tr0;   // float(int32(b*B - press)), float(int32(b*B - release))
  float amp;
  unsigned q;       // NCO word at the tile's first sample, plus 2^30
  unsigned inc;
  int a_itp, d_itp, r_itp;
  int seg;          // the tile's segment, or SEG_MIXED
  float flat;       // the tile's envelope if constant (hold 1, sustain S), else -1
};

// The segment of a sample at offsets tp = t - press, trm = t - release:
// exactly the compares of the per-sample envelope.
__device__ __forceinline__ int segment(const Row& r, float tp, float trm) {
  if (tp < 0.0f) return SEG_PRE;
  if (trm < 0.0f) {
    if (tp < r.A) return SEG_ATTACK;
    if (tp < r.AH) return SEG_HOLD;
    if (tp < r.AHD) return SEG_DECAY;
    return SEG_SUSTAIN;
  }
  return trm + 1.0f < r.R ? SEG_RELEASE : SEG_SILENT;
}

// The envelope of one sample inside segment `seg`. Divisions are products
// with the row's reciprocals (<= 2 ulp from the quotient).
__device__ __forceinline__ float envelope(const Row& r, int seg, float tp,
                                          float trm) {
  switch (seg) {
    case SEG_ATTACK: return ease(r.a_itp, (tp + 1.0f) * r.rA);
    case SEG_HOLD: return 1.0f;
    case SEG_DECAY:
      return 1.0f + (r.S - 1.0f) * ease(r.d_itp, (tp - r.A - r.H + 1.0f) * r.rDm);
    case SEG_SUSTAIN: return r.S;
    case SEG_RELEASE:
      return r.top * (1.0f - ease(r.r_itp, (trm + 1.0f) * r.rR));
    default: return 0.0f;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 9)
voicebank_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                 const long long* __restrict__ up,
                 const float* __restrict__ gains,
                 const int* __restrict__ codes, float* __restrict__ out,
                 int n_rows, long long block_row_stride, int block_size,
                 int block_offset) {
  __shared__ Row s_row[kThreads];
  __shared__ float s_g[kThreads][C];
  __shared__ int s_count[kWarps];
  __shared__ float s_sig[kSamplesPerThread][kThreads];  // each thread its own

  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const int tile_last = min(tile0 + kTile, block_size) - 1;
  const long long row0 = (long long)b * block_row_stride;
  // int32 sample arithmetic as in the JAX package; the subtractions below
  // run in unsigned so a wrap (only for the +-FAR "never" clamp) is defined
  const unsigned b0 = (unsigned)(b + block_offset) * (unsigned)block_size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k0 = tile0 + (int)threadIdx.x * kSamplesPerThread;
  const float kf0 = (float)k0;

  float acc[kSamplesPerThread][C];
#pragma unroll
  for (int j = 0; j < kSamplesPerThread; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0f;

  for (int c0 = 0; c0 < n_rows; c0 += kThreads) {
    // 1. test this thread's row, pack the live ones in voice order
    const int v = c0 + (int)threadIdx.x;
    Row r;
    bool live = false;
    if (v < n_rows) {
      const long long i = row0 + v;
      const float* f = fp + i * N_FIELDS;
      const unsigned press = (unsigned)ip[i * 2];
      const unsigned release = (unsigned)ip[i * 2 + 1];
      r.A = f[F_A];
      r.H = f[F_H];
      r.AH = r.A + r.H;
      r.AHD = r.AH + f[F_D];
      r.R = f[F_R];
      r.S = f[F_S];
      r.top = f[F_TOP];
      r.amp = f[F_AMP];
      r.tp0 = (float)(int)(b0 - press);
      r.tr0 = (float)(int)(b0 - release);
      const float tpl = r.tp0 + (float)tile_last;
      const float trf = r.tr0 + (float)tile0;
      live = !(f[F_SKIP] > 0.5f) && !(tpl < 0.0f) && trf + 1.0f < r.R;
      if (live) {
        r.inc = (unsigned)up[i * 2];
        const unsigned phase0 = (unsigned)up[i * 2 + 1];
        r.q = (b0 - press + 1u + (unsigned)tile0) * r.inc + phase0 + 0x40000000u;
        r.rA = __fdividef(1.0f, r.A);
        r.rDm = __fdividef(1.0f, fmaxf(f[F_D], 1.0f));
        r.rR = __fdividef(1.0f, r.R);
        r.a_itp = codes[i * 3];
        r.d_itp = codes[i * 3 + 1];
        r.r_itp = codes[i * 3 + 2];
        const int s_first = segment(r, r.tp0 + (float)tile0, trf);
        const int s_last = segment(r, tpl, r.tr0 + (float)tile_last);
        r.seg = s_first == s_last ? s_first : SEG_MIXED;
        r.flat = r.seg == SEG_HOLD ? 1.0f : r.seg == SEG_SUSTAIN ? r.S : -1.0f;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    __syncthreads();  // the previous chunk is fully consumed
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u));
    int n_live = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      slot += w < warp ? s_count[w] : 0;
      n_live += s_count[w];
    }
    if (live) {
      s_row[slot] = r;
      const long long i = row0 + v;
#pragma unroll
      for (int c = 0; c < C; ++c) s_g[slot][c] = gains[i * C + c];
    }
    __syncthreads();
    if (k0 >= block_size) continue;  // past a ragged block end: no samples

    // 2. this thread's 8 samples over the live rows
    for (int l = 0; l < n_live; ++l) {
      const Row& rw = s_row[l];
      unsigned q = rw.q + (unsigned)(k0 - tile0) * rw.inc;
      const unsigned inc = rw.inc;
      float g[C];
#pragma unroll
      for (int c = 0; c < C; ++c) g[c] = rw.amp * s_g[l][c];

      if (rw.flat >= 0.0f) {
        // hold or sustain over the whole tile: the envelope folds into the
        // gains. Of the dispatch forms measured (a test on `seg` here, a
        // per-sample segment below, LINEAR loops of their own), this test
        // on a field of its own was the fastest at the headline
        // (tools/voicebank_ab.py, PERF.md).
#pragma unroll
        for (int c = 0; c < C; ++c) g[c] *= rw.flat;
#pragma unroll
        for (int j = 0; j < kSamplesPerThread; ++j) {
          const float s = sinpi_word(q);
          q += inc;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[j][c] = fmaf(s, g[c], acc[j][c]);
        }
        continue;
      }
      int seg = rw.seg;
      if (seg == SEG_MIXED) {
        const float kf1 = kf0 + (float)(kSamplesPerThread - 1);
        const int s_first = segment(rw, rw.tp0 + kf0, rw.tr0 + kf0);
        const int s_last = segment(rw, rw.tp0 + kf1, rw.tr0 + kf1);
        seg = s_first == s_last ? s_first : SEG_MIXED;
      }
      if (seg == SEG_PRE || seg == SEG_SILENT) continue;  // exact zeros
      // env * sin per sample in a rolled loop into shared memory (the
      // 23-curve switch exists once), then the unrolled mixdown
#pragma unroll 1
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const float kf = kf0 + (float)j;
        const float tp = rw.tp0 + kf;
        const float trm = rw.tr0 + kf;
        s_sig[j][threadIdx.x] =
            envelope(rw, seg == SEG_MIXED ? segment(rw, tp, trm) : seg, tp, trm) *
            sinpi_word(q);
        q += inc;
      }
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[j][c] = fmaf(s_sig[j][threadIdx.x], g[c], acc[j][c]);
    }
  }
  if (k0 >= block_size) return;

  // 3. store: (t, C) row-major, 16-byte stores where aligned
  const long long t0 = (long long)b * block_size + k0;
  float* o = out + t0 * C;
  if (k0 + kSamplesPerThread <= block_size && ((t0 * C) & 3) == 0) {
    float flat[kSamplesPerThread * C];
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) flat[j * C + c] = acc[j][c];
#pragma unroll
    for (int i = 0; i < kSamplesPerThread * C / 4; ++i)
      reinterpret_cast<float4*>(o)[i] =
          make_float4(flat[4 * i], flat[4 * i + 1], flat[4 * i + 2], flat[4 * i + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j)
      if (k0 + j < block_size)
#pragma unroll
        for (int c = 0; c < C; ++c) o[j * C + c] = acc[j][c];
  }
}

template <int C>
void launch(const float* fp, const int* ip, const long long* up,
            const float* gains, const int* codes, float* out, int n_rows,
            long long block_row_stride, int block_size, int n_blocks,
            int block_offset, cudaStream_t stream) {
  const dim3 grid((block_size + kTile - 1) / kTile, n_blocks);
  voicebank_kernel<C><<<grid, kThreads, 0, stream>>>(
      fp, ip, up, gains, codes, out, n_rows, block_row_stride, block_size,
      block_offset);
}

}  // namespace

// Samples per CTA tile: the granularity of the live-row selection
// (ops/cuda_voicebank.KERNEL_TILE mirrors it).
extern "C" int voicebank_tile(void) { return kTile; }

// Renders n_blocks blocks of block_size samples, the timeline's blocks
// block_offset .. block_offset + n_blocks - 1, into out (n_blocks*block_size,
// n_channels) float32. Row r of output block b is read at index
// b*block_row_stride + r of fp (.., 8) f32, ip (.., 2) int32 [press,
// release], up (.., 2) int64 [inc, phase0] uint32 words, gains
// (.., n_channels) f32 and codes (.., 3) int32. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int voicebank_render(const float* fp, const int* ip,
                                const long long* up, const float* gains,
                                const int* codes, float* out, int n_rows,
                                int n_channels, long long block_row_stride,
                                int block_size, int n_blocks, int block_offset,
                                void* stream) {
  if (n_blocks <= 0 || block_size <= 0) return 0;
  if (n_rows < 0 || n_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_channels == 1) {
    launch<1>(fp, ip, up, gains, codes, out, n_rows, block_row_stride,
              block_size, n_blocks, block_offset, s);
  } else if (n_channels == 2) {
    launch<2>(fp, ip, up, gains, codes, out, n_rows, block_row_stride,
              block_size, n_blocks, block_offset, s);
  } else {
    return (int)cudaErrorInvalidValue;  // mono and stereo mixdowns only
  }
  return (int)cudaGetLastError();
}
