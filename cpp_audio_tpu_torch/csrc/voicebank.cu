// Voice-bank block renderer for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cpp_audio_tpu/ops/pallas_voicebank.py:30
// (_kernel, launched by render_blocks_pallas at :86), and also evaluates the
// per-voice eased curve codes that only the XLA form had
// (cpp_audio_tpu/models/voicebank.py:180 _render_block), so every voice-bank
// render of the port on CUDA runs here.
//
// What it computes (float32, or float64 for float64 tables: 6. below), per
// job j, time block b, sample k of that block and
// voice row v (b counts from block_offset: a launch renders blocks
// block_offset .. block_offset + n_blocks - 1 of the timeline into its
// output's blocks 0 .. n_blocks - 1; a compacted table's rows stay indexed by
// the local b; job j reads its own tables and writes its own output, so a
// job of a batched launch computes what a launch of that job alone does):
//   phase  = ((b*B - press + 1) + k) * inc + phase0   mod 2^32   (exact NCO)
//            bitcast to int32, times 2^-31 -> rad/pi in [-1, 1)
//   env    = closed-form AHDSR from int32 sample offsets (attack, hold,
//            decay to S, release from the precomputed `top`; 0 before the
//            press and when skipped), each segment through its easing curve
//   sig    = amp * env * sinpi_principal(phase)
//   out[j, b*B + k, c] = sum_v sig * gains[v, c]       (voice order)
//
// Design. One CTA renders one tile of kTile = 1024 samples of one block of
// one job (grid: tiles x blocks x jobs); nothing carries between CTAs.
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
//  5. Jobs. The batched serving step (analysis/chain.py
//     prepare_offline_chain_device_batch) renders every job's tables in one
//     launch: the job is blockIdx.z, which only offsets the rows a CTA reads
//     and the samples it writes. Per output sample the arithmetic and the
//     mixdown order are a single-job launch's, so each job's slice equals
//     its own launch to the bit; the batch fills the card B times over with
//     the same CTAs (16 x 2816 at the serving cell).
//  6. Types. The body is a template on the sample type. float is the
//     design above. double serves the float64 chains (ResynthConfig dtype
//     "float64", as the JAX package's XLA path renders them in float64,
//     cpp_audio_tpu/models/voicebank.py:184): tables, envelope, sine and
//     mixdown in double, with the plain float64 version's exact forms — the
//     NCO word converted whole and reduced by rint, IEEE division, sqrt,
//     sin, cos, exp2 — and scalar stores; the same tiles, live rows and
//     segment hoisting, with ptxas held to 4 CTAs per SM instead of 9.
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

// Per-type primitives. float takes the hardware's fast forms, so no sample
// loop calls a slow-path subroutine (IEEE division, sqrtf, sinf: such calls
// made ptxas keep the loop state in local memory); double takes the exact
// forms the plain float64 version computes (ops/cuda_voicebank.py).
__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mul_add(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float at_least(float x, float lo) { return fmaxf(x, lo); }
__device__ __forceinline__ double at_least(double x, double lo) { return fmax(x, lo); }
__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ double clamp01(double x) {
  return fmin(fmax(x, 0.0), 1.0);
}
// sqrt for v >= 0; float through the hardware reciprocal square root
__device__ __forceinline__ float sqrt_nonneg(float v) {
  return v > 0.0f ? v * rsqrtf(v) : 0.0f;
}
__device__ __forceinline__ double sqrt_nonneg(double v) {
  return v > 0.0 ? sqrt(v) : 0.0;
}
// cos and sin of x * pi/2; float through the hardware sin/cos (abs error
// < 5e-7 on [0, pi/2])
__device__ __forceinline__ float cos_half_pi(float x) {
  return __cosf(x * 1.57079632679489662f);
}
__device__ __forceinline__ double cos_half_pi(double x) {
  return cos(x * 1.5707963267948966);
}
__device__ __forceinline__ float sin_half_pi(float x) {
  return __sinf(x * 1.57079632679489662f);
}
__device__ __forceinline__ double sin_half_pi(double x) {
  return sin(x * 1.5707963267948966);
}
__device__ __forceinline__ float pow2(float x) { return exp2f(x); }
__device__ __forceinline__ double pow2(double x) { return exp2(x); }
// x / v for a row's divisor v, through what the row stores of v:
// quotient_factor(v). float stores the hardware reciprocal and multiplies
// (<= 2 ulp from the quotient); double stores v and divides.
__device__ __forceinline__ float quotient_factor(float v) {
  return __fdividef(1.0f, v);
}
__device__ __forceinline__ double quotient_factor(double v) { return v; }
__device__ __forceinline__ float quotient(float x, float f) { return x * f; }
__device__ __forceinline__ double quotient(double x, double f) { return x / f; }

// sin(pi*z) = z*(C1 + C3 z^2 + C5 z^4 + C7 z^6 + C9 z^8), z in [-0.5, 0.5]
// (cpp_audio_tpu/ops/fastmath.py:21-25; each constant rounds to the same
// float as its literal with an f suffix)
template <typename T>
__device__ __forceinline__ T poly_sinpi(T z) {
  const T z2 = z * z;
  return z * (T(3.14159258) + z2 * (T(-5.16770687) + z2 * (T(2.55003119) +
         z2 * (T(-0.59804419) + z2 * T(0.07721839)))));
}

// sin(pi * x) for the NCO word w (x = int32(w) * 2^-31), given q = w + 2^30.
template <typename T>
__device__ __forceinline__ T sinpi_word(unsigned q);

// float: round(x) is 0 when q's top bit is clear and +-1 when it is set,
// where the result changes sign; z = x - round(x) is ((q & 0x7fffffff) -
// 2^30) * 2^-31. 1 + (q & 0x7fffffff) * 2^-31, rounded to the float grid of
// [1, 2], is built in the mantissa; minus 1.5 it is z exactly. The sign goes
// onto z: the polynomial is odd.
template <>
__device__ __forceinline__ float sinpi_word<float>(unsigned q) {
  const unsigned m = ((q & 0x7fffffffu) + 128u) >> 8;
  const float z = __uint_as_float(0x3f800000u + m) - 1.5f;
  return poly_sinpi(__uint_as_float(__float_as_uint(z) ^ (q & 0x80000000u)));
}

// double: x holds the word exactly; the plain version's principal
// reduction (fastmath.sinpi_principal: round half to even, sign (-1)^m)
template <>
__device__ __forceinline__ double sinpi_word<double>(unsigned q) {
  const double x = (double)(int)(q - 0x40000000u) * 0x1p-31;
  const double m = rint(x);
  return (1.0 - 2.0 * fabs(m)) * poly_sinpi(x - m);
}

// Penner easing families, in-curves and out-curves (utils/interp.py).
template <typename T>
__device__ __forceinline__ T ease_in(int family, T x) {
  switch (family) {
    case 0: return x * x;
    case 1: return x * x * x;
    case 2: return x * x * x * x;
    case 3: return x * x * x * x * x;
    case 4: return T(1) - cos_half_pi(x);
    case 5: return x <= T(0) ? T(0) : pow2(T(10) * (x - T(1)));
    default: return T(1) - sqrt_nonneg(T(1) - x * x);
  }
}

template <typename T>
__device__ __forceinline__ T ease_out(int family, T x) {
  const T y = x - T(1);
  switch (family) {
    case 0: return x * (T(2) - x);
    case 1: return y * y * y + T(1);
    case 2: return T(1) - y * y * y * y;
    case 3: return y * y * y * y * y + T(1);
    case 4: return sin_half_pi(x);
    case 5: return x >= T(1) ? T(1) : T(1) - pow2(T(-10) * x);
    default: return sqrt_nonneg(T(1) - y * y);
  }
}

// The 23 itp curves (Itp enum, utils/interp.py): 0 LINEAR and
// 1 PROPORTIONAL_VALUE_DERIVATIVE are the identity in the endpoint-free
// table; codes 2..22 are (in, out, in-out) for quad, cubic, quart, quint,
// sine, expo, circ. Unknown codes leave x unchanged (the select's default).
__device__ __forceinline__ bool is_identity(int code) {
  return code < 2 || code > 22;
}

template <typename T>
__device__ __forceinline__ T ease(int code, T x) {
  x = clamp01(x);
  if (is_identity(code)) return x;
  const int family = (code - 2) / 3;
  switch ((code - 2) % 3) {
    case 0: return ease_in(family, x);
    case 1: return ease_out(family, x);
    default:
      return x < T(0.5) ? T(0.5) * ease_in(family, T(2) * x)
                        : T(0.5) + T(0.5) * ease_out(family, T(2) * x - T(1));
  }
}

// One live row, staged in shared memory for the tile.
template <typename T>
struct Row {
  T A, H, AH, AHD, R, S, top;
  T rA, rDm, rR;    // quotient_factor of A, max(D, 1), R
  T tp0, tr0;       // T(int32(b*B - press)), T(int32(b*B - release))
  T amp;
  unsigned q;       // NCO word at the tile's first sample, plus 2^30
  unsigned inc;
  int a_itp, d_itp, r_itp;
  int seg;          // the tile's segment, or SEG_MIXED
  T flat;           // the tile's envelope if constant (hold 1, sustain S), else -1
};

// The segment of a sample at offsets tp = t - press, trm = t - release:
// exactly the compares of the per-sample envelope.
template <typename T>
__device__ __forceinline__ int segment(const Row<T>& r, T tp, T trm) {
  if (tp < T(0)) return SEG_PRE;
  if (trm < T(0)) {
    if (tp < r.A) return SEG_ATTACK;
    if (tp < r.AH) return SEG_HOLD;
    if (tp < r.AHD) return SEG_DECAY;
    return SEG_SUSTAIN;
  }
  return trm + T(1) < r.R ? SEG_RELEASE : SEG_SILENT;
}

// The envelope of one sample inside segment `seg`. Divisions go through
// the row's quotient factors (float: <= 2 ulp from the quotient).
template <typename T>
__device__ __forceinline__ T envelope(const Row<T>& r, int seg, T tp, T trm) {
  switch (seg) {
    case SEG_ATTACK: return ease(r.a_itp, quotient(tp + T(1), r.rA));
    case SEG_HOLD: return T(1);
    case SEG_DECAY:
      return T(1) + (r.S - T(1)) * ease(r.d_itp, quotient(tp - r.A - r.H + T(1), r.rDm));
    case SEG_SUSTAIN: return r.S;
    case SEG_RELEASE:
      return r.top * (T(1) - ease(r.r_itp, quotient(trm + T(1), r.rR)));
    default: return T(0);
  }
}

// CTAs per SM that ptxas must fit: 9 (56 registers) for float; double's
// rows and accumulators take twice the registers
template <typename T>
struct Occupancy {
  static constexpr int kMinCtas = sizeof(T) == 4 ? 9 : 4;
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kMinCtas)
voicebank_kernel(const T* __restrict__ fp, const int* __restrict__ ip,
                 const long long* __restrict__ up,
                 const T* __restrict__ gains,
                 const int* __restrict__ codes, T* __restrict__ out,
                 int n_rows, long long block_row_stride,
                 long long job_row_stride, int block_size, int block_offset) {
  __shared__ Row<T> s_row[kThreads];
  __shared__ T s_g[kThreads][C];
  __shared__ int s_count[kWarps];
  __shared__ T s_sig[kSamplesPerThread][kThreads];  // each thread its own

  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const int tile_last = min(tile0 + kTile, block_size) - 1;
  const long long row0 =
      (long long)blockIdx.z * job_row_stride + (long long)b * block_row_stride;
  // int32 sample arithmetic as in the JAX package; the subtractions below
  // run in unsigned so a wrap (only for the +-FAR "never" clamp) is defined
  const unsigned b0 = (unsigned)(b + block_offset) * (unsigned)block_size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k0 = tile0 + (int)threadIdx.x * kSamplesPerThread;
  const T kf0 = (T)k0;

  T acc[kSamplesPerThread][C];
#pragma unroll
  for (int j = 0; j < kSamplesPerThread; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = T(0);

  for (int c0 = 0; c0 < n_rows; c0 += kThreads) {
    // 1. test this thread's row, pack the live ones in voice order
    const int v = c0 + (int)threadIdx.x;
    Row<T> r;
    bool live = false;
    if (v < n_rows) {
      const long long i = row0 + v;
      const T* f = fp + i * N_FIELDS;
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
      r.tp0 = (T)(int)(b0 - press);
      r.tr0 = (T)(int)(b0 - release);
      const T tpl = r.tp0 + (T)tile_last;
      const T trf = r.tr0 + (T)tile0;
      live = !(f[F_SKIP] > T(0.5)) && !(tpl < T(0)) && trf + T(1) < r.R;
      if (live) {
        r.inc = (unsigned)up[i * 2];
        const unsigned phase0 = (unsigned)up[i * 2 + 1];
        r.q = (b0 - press + 1u + (unsigned)tile0) * r.inc + phase0 + 0x40000000u;
        r.rA = quotient_factor(r.A);
        r.rDm = quotient_factor(at_least(f[F_D], T(1)));
        r.rR = quotient_factor(r.R);
        r.a_itp = codes[i * 3];
        r.d_itp = codes[i * 3 + 1];
        r.r_itp = codes[i * 3 + 2];
        const int s_first = segment(r, r.tp0 + (T)tile0, trf);
        const int s_last = segment(r, tpl, r.tr0 + (T)tile_last);
        r.seg = s_first == s_last ? s_first : SEG_MIXED;
        r.flat = r.seg == SEG_HOLD ? T(1) : r.seg == SEG_SUSTAIN ? r.S : T(-1);
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
      const Row<T>& rw = s_row[l];
      unsigned q = rw.q + (unsigned)(k0 - tile0) * rw.inc;
      const unsigned inc = rw.inc;
      T g[C];
#pragma unroll
      for (int c = 0; c < C; ++c) g[c] = rw.amp * s_g[l][c];

      if (rw.flat >= T(0)) {
        // hold or sustain over the whole tile: the envelope folds into the
        // gains. Of the dispatch forms measured (a test on `seg` here, a
        // per-sample segment below, LINEAR loops of their own), this test
        // on a field of its own was the fastest at the headline
        // (tools/voicebank_ab.py, PERF.md).
#pragma unroll
        for (int c = 0; c < C; ++c) g[c] *= rw.flat;
#pragma unroll
        for (int j = 0; j < kSamplesPerThread; ++j) {
          const T s = sinpi_word<T>(q);
          q += inc;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[j][c] = mul_add(s, g[c], acc[j][c]);
        }
        continue;
      }
      int seg = rw.seg;
      if (seg == SEG_MIXED) {
        const T kf1 = kf0 + (T)(kSamplesPerThread - 1);
        const int s_first = segment(rw, rw.tp0 + kf0, rw.tr0 + kf0);
        const int s_last = segment(rw, rw.tp0 + kf1, rw.tr0 + kf1);
        seg = s_first == s_last ? s_first : SEG_MIXED;
      }
      if (seg == SEG_PRE || seg == SEG_SILENT) continue;  // exact zeros
      // env * sin per sample in a rolled loop into shared memory (the
      // 23-curve switch exists once), then the unrolled mixdown
#pragma unroll 1
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const T kf = kf0 + (T)j;
        const T tp = rw.tp0 + kf;
        const T trm = rw.tr0 + kf;
        s_sig[j][threadIdx.x] =
            envelope(rw, seg == SEG_MIXED ? segment(rw, tp, trm) : seg, tp, trm) *
            sinpi_word<T>(q);
        q += inc;
      }
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[j][c] = mul_add(s_sig[j][threadIdx.x], g[c], acc[j][c]);
    }
  }
  if (k0 >= block_size) return;

  // 3. store: (t, C) row-major; float takes 16-byte stores where aligned
  const long long t0 =
      ((long long)blockIdx.z * gridDim.y + b) * block_size + k0;
  T* o = out + t0 * C;
  if constexpr (sizeof(T) == 4) {
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
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kSamplesPerThread; ++j)
    if (k0 + j < block_size)
#pragma unroll
      for (int c = 0; c < C; ++c) o[j * C + c] = acc[j][c];
}

template <typename T, int C>
void launch(const void* fp, const int* ip, const long long* up,
            const void* gains, const int* codes, void* out, int n_rows,
            long long block_row_stride, long long job_row_stride,
            int block_size, int n_blocks, int n_jobs, int block_offset,
            cudaStream_t stream) {
  const dim3 grid((block_size + kTile - 1) / kTile, n_blocks, n_jobs);
  voicebank_kernel<T, C><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(fp), ip, up, static_cast<const T*>(gains), codes,
      static_cast<T*>(out), n_rows, block_row_stride, job_row_stride,
      block_size, block_offset);
}

template <typename T>
int launch_channels(const void* fp, const int* ip, const long long* up,
                    const void* gains, const int* codes, void* out, int n_rows,
                    int n_channels, long long block_row_stride,
                    long long job_row_stride, int block_size, int n_blocks,
                    int n_jobs, int block_offset, cudaStream_t stream) {
  if (n_channels == 1) {
    launch<T, 1>(fp, ip, up, gains, codes, out, n_rows, block_row_stride,
                 job_row_stride, block_size, n_blocks, n_jobs, block_offset, stream);
  } else if (n_channels == 2) {
    launch<T, 2>(fp, ip, up, gains, codes, out, n_rows, block_row_stride,
                 job_row_stride, block_size, n_blocks, n_jobs, block_offset, stream);
  } else {
    return (int)cudaErrorInvalidValue;  // mono and stereo mixdowns only
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Samples per CTA tile: the granularity of the live-row selection
// (ops/cuda_voicebank.KERNEL_TILE mirrors it).
extern "C" int voicebank_tile(void) { return kTile; }

// Renders n_blocks blocks of block_size samples for each of n_jobs jobs, the
// timeline's blocks block_offset .. block_offset + n_blocks - 1, into out
// (n_jobs, n_blocks*block_size, n_channels), float32 or, when f64 is
// nonzero, float64. Row r of job j's output block b is read at index
// j*job_row_stride + b*block_row_stride + r of fp (.., 8) and gains (..,
// n_channels) of out's type, ip (.., 2) int32 [press, release], up (.., 2)
// int64 [inc, phase0] uint32 words and codes (.., 3) int32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int voicebank_render(const void* fp, const int* ip,
                                const long long* up, const void* gains,
                                const int* codes, void* out, int n_rows,
                                int n_channels, long long block_row_stride,
                                long long job_row_stride, int block_size,
                                int n_blocks, int n_jobs, int block_offset,
                                int f64, void* stream) {
  if (n_blocks <= 0 || block_size <= 0 || n_jobs <= 0) return 0;
  if (n_rows < 0 || n_blocks > 65535 || n_jobs > 65535)
    return (int)cudaErrorInvalidValue;  // the grid's y and z limits
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? launch_channels<double>(fp, ip, up, gains, codes, out, n_rows,
                                       n_channels, block_row_stride,
                                       job_row_stride, block_size, n_blocks,
                                       n_jobs, block_offset, s)
             : launch_channels<float>(fp, ip, up, gains, codes, out, n_rows,
                                      n_channels, block_row_stride,
                                      job_row_stride, block_size, n_blocks,
                                      n_jobs, block_offset, s);
}
