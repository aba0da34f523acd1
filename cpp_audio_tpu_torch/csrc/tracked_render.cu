// Tracked-note render for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package renders the tracked notes
// (cpp_audio_tpu/models/resynth_bank.py _render_slots) in XLA, which fuses
// the per-sample chain into one pass. The port's eager form of the same
// math (models/resynth_bank._render_slots_plain) builds a dozen (frames,
// slots, stride) float tensors per chunk of frames in ~40 elementwise
// passes over device memory, for every slot, dead or alive; this kernel
// does the whole render in one pass with nothing but the table read and the
// stereo written.
//
// What it computes, per job j, control frame f, sample k < S of the frame
// and slot p of the (J, F, P, 16 or 17) slot table (field order of
// models/resynth_bank.py), in the render type T (float or double):
//   phase = wrap2(phb + (small ? inc*(k+1) : (inc/lam) * expm1(lam*(k+1))))
//           lam = ratio/S, small = |ratio| < 1e-7, wrap2(x) in [0, 2)
//   vol   = vtgt + (vb - vtgt) * exp((k+1) * log1p(-alpha))
//   env   = 0 before the press (tp < 0), the LINEAR AHDSR pressed envelope
//           while trm < 0, else the release ramp from `top`
//           (tp = tp0 + k, trm = tr0 + k)
//   al    = the aliasing gain of the frame-midpoint increment
//           inc * exp(lam * S/2) (oscillators.freq_aliasing_multiplicator)
//   sig   = vol * env * al * sinpi(phase)
//   out[j, f, k, c] = sum_p sig * gain[p, c], c = left, right (slot order)
// with the eager form's order of operations: the phase's products and
// sums round as the eager form's separate passes do (no contraction), the
// polynomial sine of ops/fastmath.py in float (libm sin(pi x) in double),
// accurate libdevice expf / expm1f / log1pf (no __expf-style intrinsics).
// A 17-field table (the fidelity chain's, read as double) carries the rest
// of the increment in field 16: the phase is computed in double from field
// 0 + field 16 and the double ratio and start phase, wrapped, and only then
// cast to T; everything else is in T from the fields cast to T (as
// _render_slots_plain's `tab = table.to(wdt)`).
//
// Design. One CTA renders one tile of kTile = 1024 samples (128 threads x
// 8) of one frame of one job: grid (frame * tiles, job); nothing carries
// between CTAs, no atomics, so each job's slice of a batched launch equals
// that job's own launch to the bit.
//  1. The frame's row (P slots x NF fields, contiguous) is read into shared
//     memory with coalesced loads, kThreads slots at a time.
//  2. Per-slot terms once per CTA: lam, the flat-glide test, inc/lam,
//     log1p(-alpha), vb - vtgt, A + H, A + H + D, max(D, 1), sus - 1, the
//     aliasing gain.
//  3. Live slots per tile. A slot is dead over the tile's samples [k_lo,
//     k_hi) when both gains are zero, or its envelope is zero at the end
//     points of the pressed and release parts of that range: the pressed
//     envelope is positive in the attack and non-increasing after it, the
//     release ramp non-increasing (analysis/cost.live_pairs over the whole
//     frame; models/resynth_bank.live_slots is this test in plain PyTorch).
//     A dead slot renders exact zeros over the tile, so it is skipped; a
//     warp ballot and a prefix over the warps' counts pack the live slots
//     into shared memory in slot order. At the headline (bench.py:52-75)
//     13% of the (frame, slot) pairs are live (analysis/cost.live_pairs).
//  4. Per sample, in registers: each thread owns samples k_lo + t + 128 i,
//     i < 8, and for each live slot in slot order adds sig * gain into two
//     register sums; the stores are float2 (double2), coalesced.
//  Tensor cores do not serve it: the mixdown has 2 columns; TMA does not
//  either: a CTA reads one 8-17 KB row once.
//
// Bound (analysis/cost.render over the live pairs, PERF.md): ~3 transcendentals
// (expm1, exp, the sine) and ~41 other operations per live pair-sample: at
// the headline's 11,533 live pairs x 3,969 samples (45.8 M) about 3.4 GFLOP
// float32 counted with 11 per transcendental, 0.05 ms at 67 TFLOP/s, against
// 5.5 MB of table in and 21 MB of stereo out, 0.008 ms at 3.35 TB/s: the
// kernel is bound by its FP32 and SFU work over the live pair-samples. The
// design spends nothing on dead pairs (3.), keeps every intermediate in
// registers (4.), and fills the card with many small CTAs (2,700 at the
// headline, 43,200 for a batch of 16).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound through ctypes (cpp_audio_tpu_torch/ops/cuda_render.py); the host
// function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kSamplesPerThread = 8;
constexpr int kTile = kThreads * kSamplesPerThread;
constexpr int kWarps = kThreads / 32;

// packed per-(frame, slot) field order (models/resynth_bank.py)
enum { F_INC, F_RATIO, F_PHB, F_VTGT, F_VB, F_ALPHA, F_TP0, F_TR0, F_TOP, F_A,
       F_H, F_D, F_SUS, F_R, F_GL, F_GR, F_INC_LO };

// Per-type primitives: products and sums that round alone (the eager form's
// separate passes), and libdevice's accurate transcendentals.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float expm1_(float x) { return expm1f(x); }
__device__ __forceinline__ double expm1_(double x) { return expm1(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }

template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return min_(max_(x, lo), hi);
}

// sin(pi*z) = z*(C1 + C3 z^2 + C5 z^4 + C7 z^6 + C9 z^8), z in [-0.5, 0.5]
// (ops/fastmath.py _poly_sinpi; each constant rounds to the same float as
// its literal with an f suffix)
__device__ __forceinline__ float poly_sinpi(float z) {
  const float z2 = z * z;
  return z * (3.14159258f + z2 * (-5.16770687f + z2 * (2.55003119f +
         z2 * (-0.59804419f + z2 * 0.07721839f))));
}

// sin(pi * x): float as fastmath.sinpi (two folds by round-half-even, the
// sign (-1)^m, the polynomial); double as the plain float64 render,
// sin(pi * x) through libm.
__device__ __forceinline__ float sinpi_(float x) {
  x = sub_rn(x, 2.0f * rintf(x * 0.5f));
  const float m = rintf(x);
  const float z = sub_rn(x, m);
  return (1.0f - 2.0f * fabsf(m)) * poly_sinpi(z);
}
__device__ __forceinline__ double sinpi_(double x) {
  return sin(mul_rn(3.141592653589793, x));
}

// One slot of the frame, its per-slot terms computed once per CTA. PT is
// the phase's type: double for a 17-field table, else T.
template <typename T, typename PT>
struct Slot {
  PT phb, scale, lam;  // phase: phb + (small ? scale * k1 : scale * expm1(lam * k1))
  T vtgt, dv, l1p;     // volume: vtgt + dv * exp(k1 * l1p)
  T tp0, tr0, A, H, AH, AHD, Dm, sus, sus1, top, R;
  T al, gl, gr;        // aliasing gain, channel gains
  int small;
};

// The LINEAR AHDSR envelope before the release, at tp >= 0 samples after
// the press (resynth_bank.pressed_envelope).
template <typename T, typename PT>
__device__ __forceinline__ T pressed(const Slot<T, PT>& s, T tp) {
  if (tp < s.A) return clamp((tp + T(1)) / s.A, T(0), T(1));
  if (tp < s.AH) return T(1);
  if (tp < s.AHD)
    return T(1) + s.sus1 * clamp(((tp - s.A) - s.H + T(1)) / s.Dm, T(0), T(1));
  return s.sus;
}

// The release ramp from `top` at trm >= 0 samples after the release
// (resynth_bank.release_envelope).
template <typename T, typename PT>
__device__ __forceinline__ T released(const Slot<T, PT>& s, T trm) {
  return s.top * (T(1) - clamp((trm + T(1)) / s.R, T(0), T(1)));
}

// Whether the slot can sound in samples [k_lo, k_hi) of the frame: the test
// of resynth_bank.live_slots, in T.
template <typename T, typename PT>
__device__ __forceinline__ bool live_in(const Slot<T, PT>& s, T k_lo, T k_hi) {
  if (!(s.gl != T(0) || s.gr != T(0))) return false;
  const T k0 = clamp(ceil_(-s.tp0), k_lo, k_hi);  // first sample with tp >= 0
  const T kr = clamp(ceil_(-s.tr0), k_lo, k_hi);  // first sample with trm >= 0
  const bool pressed_on =
      k0 < kr && (pressed(s, s.tp0 + k0) != T(0) ||
                  pressed(s, s.tp0 + (kr - T(1))) != T(0));
  const T k_rel = max_(k0, kr);
  const bool release_on = k_rel < k_hi && released(s, s.tr0 + k_rel) != T(0);
  return pressed_on || release_on;
}

// The slot's terms from its raw fields f (the table's type TT).
template <typename T, typename PT, typename TT, bool DF>
__device__ __forceinline__ Slot<T, PT> make_slot(const TT* f, int stride) {
  Slot<T, PT> s;
  PT inc, ratio;
  if constexpr (DF) {
    inc = (PT)f[F_INC] + (PT)f[F_INC_LO];
    ratio = (PT)f[F_RATIO];
    s.phb = (PT)f[F_PHB];
  } else {
    inc = (PT)(T)f[F_INC];
    ratio = (PT)(T)f[F_RATIO];
    s.phb = (PT)(T)f[F_PHB];
  }
  s.lam = ratio / (PT)stride;
  s.small = abs_(ratio) < PT(1e-7);
  s.scale = s.small ? inc : inc / s.lam;
  s.vtgt = (T)f[F_VTGT];
  s.dv = (T)f[F_VB] - s.vtgt;
  s.l1p = log1p_(-(T)f[F_ALPHA]);
  s.tp0 = (T)f[F_TP0];
  s.tr0 = (T)f[F_TR0];
  s.top = (T)f[F_TOP];
  s.A = (T)f[F_A];
  s.H = (T)f[F_H];
  const T D = (T)f[F_D];
  s.AH = s.A + s.H;
  s.AHD = s.AH + D;
  s.Dm = max_(D, T(1));
  s.sus = (T)f[F_SUS];
  s.sus1 = s.sus - T(1);
  s.R = (T)f[F_R];
  s.gl = (T)f[F_GL];
  s.gr = (T)f[F_GR];
  // the anti-alias gain at the frame-midpoint increment: a float64 render
  // of a 17-field table takes the whole increment, any other the field
  // cast to T (the eager form's `incf`)
  const T inc_t = (DF && sizeof(T) == 8) ? (T)inc : (T)f[F_INC];
  const T lam_t = (T)f[F_RATIO] / (T)stride;
  const T mid = inc_t * exp_(lam_t * (T)(stride * 0.5));
  // half samples per period 1/|mid| (infinite at 0, where the gain is 1)
  const T a = abs_(mid);
  s.al = a == T(0) ? T(1)
                   : clamp((T(1) / max_(a, T(1e-30)) - T(1)) / T(3), T(0), T(1));
  return s;
}

// The wrapped phase of sample k (k1 = k + 1) in [0, 2): the eager form's
// products and sums each rounded alone; x - 2 floor(x / 2) is
// torch.remainder(x, 2) for finite x.
template <typename T, typename PT>
__device__ __forceinline__ PT phase_at(const Slot<T, PT>& s, PT k1) {
  const PT adv = s.small ? mul_rn(s.scale, k1) : mul_rn(s.scale, expm1_(mul_rn(s.lam, k1)));
  const PT x = add_rn(s.phb, adv);
  return sub_rn(x, mul_rn(PT(2), floor_(mul_rn(x, PT(0.5)))));
}

// One stereo sample as one 8- or 16-byte store.
__device__ __forceinline__ void store2(float* o, float l, float r) {
  *reinterpret_cast<float2*>(o) = make_float2(l, r);
}
__device__ __forceinline__ void store2(double* o, double l, double r) {
  *reinterpret_cast<double2*>(o) = make_double2(l, r);
}

template <typename T, typename TT, bool DF>
__global__ void __launch_bounds__(kThreads)
tracked_render_kernel(const TT* __restrict__ table, T* __restrict__ out,
                      int n_frames, int n_slots, int stride, int n_tiles) {
  using PT = typename std::conditional<DF, double, T>::type;
  constexpr int NF = DF ? 17 : 16;
  __shared__ TT s_raw[kThreads * NF];
  __shared__ Slot<T, PT> s_slot[kThreads];
  __shared__ int s_count[kWarps];

  const int tile = blockIdx.x % n_tiles;
  const int frame = blockIdx.x / n_tiles;
  const long long jf = (long long)blockIdx.y * n_frames + frame;
  const int k_lo = tile * kTile;
  const int k_hi = min(k_lo + kTile, stride);
  const TT* row = table + jf * n_slots * NF;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  T acc_l[kSamplesPerThread], acc_r[kSamplesPerThread];
#pragma unroll
  for (int i = 0; i < kSamplesPerThread; ++i) acc_l[i] = acc_r[i] = T(0);

  for (int c0 = 0; c0 < n_slots; c0 += kThreads) {
    const int n_chunk = min(kThreads, n_slots - c0);
    __syncthreads();  // the previous chunk is fully consumed
    // 1. the chunk's rows, coalesced
    for (int i = threadIdx.x; i < n_chunk * NF; i += kThreads)
      s_raw[i] = row[(long long)c0 * NF + i];
    __syncthreads();
    // 2. + 3. this thread's slot: its terms and the live test
    Slot<T, PT> s;
    bool live = false;
    if ((int)threadIdx.x < n_chunk) {
      s = make_slot<T, PT, TT, DF>(s_raw + threadIdx.x * NF, stride);
      live = live_in(s, (T)k_lo, (T)k_hi);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u));
    int n_live = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? s_count[w] : 0;
      n_live += s_count[w];
    }
    if (live) s_slot[pos] = s;
    __syncthreads();

    // 4. this thread's samples over the live slots, in slot order
    for (int l = 0; l < n_live; ++l) {
      const Slot<T, PT>& sl = s_slot[l];
#pragma unroll
      for (int i = 0; i < kSamplesPerThread; ++i) {
        const int k = k_lo + (int)threadIdx.x + i * kThreads;
        if (k >= k_hi) break;
        const T kt = (T)k;
        const T k1 = (T)(k + 1);
        const T tp = sl.tp0 + kt;
        const T trm = sl.tr0 + kt;
        const T env = tp < T(0) ? T(0)
                      : trm < T(0) ? pressed(sl, tp) : released(sl, trm);
        const T vol = sl.vtgt + sl.dv * exp_(k1 * sl.l1p);
        const T ph = (T)phase_at(sl, (PT)(k + 1));
        const T sig = vol * env * sl.al * sinpi_(ph);
        acc_l[i] += sig * sl.gl;
        acc_r[i] += sig * sl.gr;
      }
    }
  }

  T* o = out + jf * stride * 2;
#pragma unroll
  for (int i = 0; i < kSamplesPerThread; ++i) {
    const int k = k_lo + (int)threadIdx.x + i * kThreads;
    if (k < k_hi) store2(o + 2 * (long long)k, acc_l[i], acc_r[i]);
  }
}

template <typename T, typename TT, bool DF>
int launch(const void* table, void* out, int n_jobs, int n_frames, int n_slots,
           int stride, cudaStream_t stream) {
  const int n_tiles = (stride + kTile - 1) / kTile;
  const dim3 grid((unsigned)(n_frames * n_tiles), (unsigned)n_jobs);
  tracked_render_kernel<T, TT, DF><<<grid, kThreads, 0, stream>>>(
      static_cast<const TT*>(table), static_cast<T*>(out), n_frames, n_slots,
      stride, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Samples per CTA tile: the granularity of the live-slot selection
// (ops/cuda_render.KERNEL_TILE mirrors it).
extern "C" int tracked_render_tile(void) { return kTile; }

// Renders the (n_jobs, n_frames, n_slots, n_fields) slot table, contiguous,
// into out (n_jobs, n_frames, stride, 2), float32 or, when f64 is nonzero,
// float64. A 16-field table is of out's type; a 17-field table is float64.
// Returns the cudaError_t of the launch (0 on success; nothing is launched
// for an empty table).
extern "C" int tracked_render(const void* table, void* out, int n_jobs,
                              int n_frames, int n_slots, int stride,
                              int n_fields, int f64, void* stream) {
  if (n_jobs < 0 || n_frames < 0 || n_slots < 0 || stride < 0)
    return (int)cudaErrorInvalidValue;
  if (n_jobs == 0 || n_frames == 0 || stride == 0) return 0;
  const long long tiles = (stride + kTile - 1) / kTile;
  if (n_jobs > 65535 || (long long)n_frames * tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;  // the grid's y and x limits
  cudaStream_t s = (cudaStream_t)stream;
  if (n_fields == 16)
    return f64 ? launch<double, double, false>(table, out, n_jobs, n_frames,
                                                n_slots, stride, s)
               : launch<float, float, false>(table, out, n_jobs, n_frames,
                                              n_slots, stride, s);
  if (n_fields == 17)
    return f64 ? launch<double, double, true>(table, out, n_jobs, n_frames,
                                               n_slots, stride, s)
               : launch<float, double, true>(table, out, n_jobs, n_frames,
                                              n_slots, stride, s);
  return (int)cudaErrorInvalidValue;  // 16- or 17-field tables only
}
