// The device tracker's exact frame loop for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's exact frame loop
// (cpp_audio_tpu/analysis/device_tracker.py `_scan_tables`) is a lax.scan
// over frames that XLA compiles into one device loop. The port's eager form
// of it (analysis/device_tracker._scan_tables_plain, one `_track_step` a
// frame) dispatches ~475 ATen ops a frame from the host, ~321,000 for a
// 60 s take, and leaves the card idle between them for seconds. This
// kernel runs the whole loop of every job of a call in one launch.
//
// What it computes, per job: the frame loop's carry (_ScanCarry: the played
// set of Q = 128 pitches and slots, pitch-sorted and +inf padded; the P
// slots' state, release-end frame and 14 float state columns; the draw
// counters and the dropped-NoteOn count) and, per frame f, the steps (a)-(g)
// of `_track_step`: (a) free the expired release tails; (b) the two-pointer
// matching of the frame's tuned pitches against the played set; (c) note
// offs of the played entries not continued (data frames only); (d) note
// changes of the matched slots; (e) note ons, loudest first, up to the
// voice cap, into the lowest free slots, with their pan and phase draws;
// (f) the played set rebuilt from the continued entries and the accepted
// ons; (g) the frame's (P, 16) table rows, then the phase, volume and
// increment recurrences of the sounding slots. Output: the (B, T, P, 16)
// table and the (B,) dropped counts, in float32 or float64.
//
// Numerics follow the eager loop on the card op for op: every product,
// sum and quotient rounds alone (__fmul_rn, __fadd_rn, __fdiv_rn and the
// double forms: no contraction into FMA), and the transcendental and
// rounding functions are the CUDA math library's that ATen's kernels call
// (exp2, exp, expm1, log, pow, cos, sin, floor, ceil, fmod). Where ATen
// divides a tensor by a host scalar it multiplies by the scalar's
// reciprocal, formed on the host in the working type, and `scalar / tensor`
// is `reciprocal(tensor) * scalar` (torch.Tensor.__rtruediv__): the kernel
// does the same, with the reciprocals and the host-rounded scalars passed
// in from ops/cuda_scan.scan_constants. So the kernel's table is the eager
// loop's, on the card, to the bit where both libraries agree.
//
// Design. One CTA per job (blockIdx.x), blockDim = max(k, Q, P) rounded up
// to a warp: one thread per lane, per played entry and per slot. The carry
// lives in shared memory for the whole loop; a frame is a chain of block
// phases between barriers:
//   1. each lane stores its prefetched tuned pitch, volume and loudness
//      rank (and issues the loads of the next frame's), searches the played
//      set for its window [lb, ub) (binary search in shared memory) and
//      forms its increment; each slot frees an expired tail (a);
//   2. one thread runs the two-pointer recurrence c = max(it, lb),
//      matched = c < ub, it = c + matched over the lanes up to the last
//      valid one (b); the blocked carry-lookahead of the Python form is
//      slower than this short serial chain in one thread;
//   3. note offs per played entry (c), note changes per matched lane (d);
//   4. one block scan (warp shuffles + shared memory) gives each lane its
//      rank among the note ons in loudness order and each free slot its
//      rank among the free slots (e);
//   5. births of the accepted ons into their slots, draws from the pools;
//   6. a block scan ranks the continued and the accepted lanes for (f);
//      every slot emits its row of the frame straight to the table and
//      advances its recurrences (g);
//   7. (f): a continued entry's played pitch is its matched lane's tuned
//      pitch, so both sorted lists are ranks over the frame's sorted lanes
//      and the rank-based merge of the Python form (kept i at i + #ons
//      strictly below, on j at j + #kept at or below) is a binary search
//      per element in the lanes; the new played set is written in place.
//
// Bound: the serial chain of T frames x the barrier phases of a frame, and
// in each frame the one-thread two-pointer loop over the valid lanes.
// Bytes do not bound it: a 60 s job's table is 675 x 128 x 16 x 4 B =
// 5.5 MB, 1.6 us at 3.35 TB/s, and its lanes 1 MB; operations do not
// either (a few thousand a frame). A batch of B jobs takes B of the card's
// 132 SMs and about the time of one job.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound through ctypes (cpp_audio_tpu_torch/ops/cuda_scan.py); the host
// function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQ = 128;        // played-set capacity (device_tracker._Q)
constexpr int kNF = 16;        // table fields
constexpr int kNS = 14;        // per-slot float state columns
constexpr int kMaxThreads = 512;   // lanes and slots: the merged harmonize stages give k = 512

// table field order (models/resynth_bank.py)
enum { F_INC, F_RATIO, F_PHB, F_VTGT, F_VB, F_ALPHA, F_TP0, F_TR0, F_TOP, F_A,
       F_H, F_D, F_SUS, F_R, F_GL, F_GR };
// per-slot state columns (device_tracker._S_*)
enum { S_PRESS, S_RELEASE, S_TOP, S_A, S_H, S_D, S_R, S_GL, S_GR, S_PHASE,
       S_VOLB, S_PREVINC, S_CURINC, S_CURVOL };
// host-rounded constants (ops/cuda_scan.scan_constants, same order)
enum { C_S, C_INV_S, C_MAXD, C_69, C_INV_12, C_440, C_INV_SR, C_SUS,
       C_SUS_M1, C_EPS_INC, C_ATTACK, C_DECAY, C_RELEASE, C_HOLD, C_FAR,
       C_NEG_FAR, C_SPREAD, C_QPI, C_TINY, C_NEG_PI, C_TWO_OVER_S, kNConst };

struct Params {
  double c[kNConst];
  int max_voices;
  int total_frames;
  int n_data;
  int has_decay;
  int stable_draws;
};

// Products, sums and quotients that round alone; the math library's
// functions, as ATen's kernels call them.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp2_(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2_(double x) { return exp2(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float expm1_(float x) { return expm1f(x); }
__device__ __forceinline__ double expm1_(double x) { return expm1(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float pow_(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }
__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// torch.clamp(x, min=lo) / (x, max=hi): NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x != x ? x : (x < lo ? lo : x); }
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) { return x != x ? x : (x > hi ? hi : x); }
template <typename T>
__device__ __forceinline__ T clamp01(T x) { return clamp_max(clamp_min(x, T(0)), T(1)); }

// torch.remainder(x, 2.0) (ATen: fmod, then + b where the signs differ)
template <typename T>
__device__ __forceinline__ T remainder2(T x) {
  T m = fmod_(x, T(2));
  if (m != T(0) && m < T(0)) m = add_rn(m, T(2));
  return m;
}

template <typename T>
__device__ __forceinline__ bool finite_(T x) { return isfinite(x); }

// torch.searchsorted over a sorted array: left = #(a < v), right = #(a <= v)
template <typename T>
__device__ __forceinline__ int lower_bound(const T* a, int n, T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] >= v)) lo = mid + 1; else hi = mid;
  }
  return lo;
}
template <typename T>
__device__ __forceinline__ int upper_bound(const T* a, int n, T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] > v)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive block scan of v over every thread (blockDim.x a multiple of
// 32); `total` gets the sum. Two barriers; the caller keeps a barrier
// between the last read of wsum and the next scan.
__device__ __forceinline__ int block_excl_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) wsum[lane] = s;
  }
  __syncthreads();
  total = wsum[nw - 1];
  return (w ? wsum[w - 1] : 0) + x - v;
}

// Shared-memory layout of one CTA: the carry, the frame's lanes and the
// phases' scratch. The host computes its size with the same function.
template <typename T>
struct Smem {
  T* tp; T* vol; T* inc;                       // k lanes
  int* ord; int* lb; int* ub; int* match;      // k lanes
  int* ison; int* newslot; int* lslot;         // k lanes
  int* pref_new; int* pref_kept;               // k lanes
  T* plp; int* pls; int* cont;                 // Q played entries
  T* sf;                                       // kNS x P slot state
  int* state; int* f1; int* fbr;               // P slots
  T* def;                                      // kNF defaults
  T* cst;                                      // kNConst constants
  int* wsum;                                   // 32 warp sums
  int* misc;                                   // [0] matches, [1] last valid lane + 1
};

__host__ __device__ inline size_t align8(size_t x) { return (x + 7) & ~size_t(7); }

// Carves `bytes` at *off from base (null when only sizing).
__host__ __device__ inline char* carve(char* base, size_t* off, size_t bytes) {
  char* p = base ? base + *off : nullptr;
  *off = align8(*off + bytes);
  return p;
}

template <typename T>
__host__ __device__ inline size_t smem_layout(int k, int P, char* base, Smem<T>* s) {
  size_t off = 0;
  Smem<T> d;
  d.tp = (T*)carve(base, &off, sizeof(T) * k);
  d.vol = (T*)carve(base, &off, sizeof(T) * k);
  d.inc = (T*)carve(base, &off, sizeof(T) * k);
  d.plp = (T*)carve(base, &off, sizeof(T) * kQ);
  d.sf = (T*)carve(base, &off, sizeof(T) * kNS * P);
  d.def = (T*)carve(base, &off, sizeof(T) * kNF);
  d.cst = (T*)carve(base, &off, sizeof(T) * kNConst);
  d.ord = (int*)carve(base, &off, sizeof(int) * k);
  d.lb = (int*)carve(base, &off, sizeof(int) * k);
  d.ub = (int*)carve(base, &off, sizeof(int) * k);
  d.match = (int*)carve(base, &off, sizeof(int) * k);
  d.ison = (int*)carve(base, &off, sizeof(int) * k);
  d.newslot = (int*)carve(base, &off, sizeof(int) * k);
  d.lslot = (int*)carve(base, &off, sizeof(int) * k);
  d.pref_new = (int*)carve(base, &off, sizeof(int) * k);
  d.pref_kept = (int*)carve(base, &off, sizeof(int) * k);
  d.pls = (int*)carve(base, &off, sizeof(int) * kQ);
  d.cont = (int*)carve(base, &off, sizeof(int) * kQ);
  d.state = (int*)carve(base, &off, sizeof(int) * P);
  d.f1 = (int*)carve(base, &off, sizeof(int) * P);
  d.fbr = (int*)carve(base, &off, sizeof(int) * P);
  d.wsum = (int*)carve(base, &off, sizeof(int) * 32);
  d.misc = (int*)carve(base, &off, sizeof(int) * 4);
  if (s) *s = d;
  return off;
}

template <typename T>
__device__ __forceinline__ T& sfc(const Smem<T>& s, int col, int P, int slot) {
  return s.sf[col * P + slot];
}

// 2 * freq_of_pitch(pitch) / sr, as the eager form rounds it:
// 440 * exp2((pitch - 69) * (1/12)), doubled, times 1/sr
template <typename T>
__device__ __forceinline__ T increment_of(T pitch, const T* c) {
  const T fr = mul_rn(c[C_440], exp2_(mul_rn(sub_rn(pitch, c[C_69]), c[C_INV_12])));
  return mul_rn(mul_rn(T(2), fr), c[C_INV_SR]);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
tracker_scan_kernel(const T* __restrict__ tpitch, const T* __restrict__ volume,
                    const long long* __restrict__ loud_order, int n_frames, int k,
                    int P, const T* __restrict__ pan_draws, long long n_pan,
                    const T* __restrict__ phase_draws, long long n_phase,
                    const T* __restrict__ defaults, Params prm,
                    T* __restrict__ table, long long* __restrict__ dropped_out) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem<T> s;
  smem_layout<T>(k, P, smem_raw, &s);
  const int t = threadIdx.x;
  const int job = blockIdx.x;
  const long long lane_base = (long long)job * n_frames * k;
  T* out = table + (long long)job * n_frames * P * kNF;

  const T* c = s.cst;
  if (t < kNConst) s.cst[t] = (T)prm.c[t];
  const double S_d = prm.c[C_S];
  const T inf = (T)INFINITY;

  // the carry's initial state (_ScanCarry)
  if (t < kQ) { s.plp[t] = inf; s.pls[t] = -1; }
  if (t < P) {
    s.state[t] = 0;
    s.f1[t] = 0;
    for (int col = 0; col < kNS; ++col) sfc(s, col, P, t) = T(0);
    sfc(s, S_RELEASE, P, t) = (T)prm.c[C_FAR];  // s.cst is read after the barrier
    sfc(s, S_TOP, P, t) = T(1);
    sfc(s, S_A, P, t) = T(1);
    sfc(s, S_R, P, t) = T(1);
  }
  if (t < kNF) s.def[t] = defaults[t];
  if (t == 0) { s.misc[0] = 0; s.misc[1] = 0; }
  long long pan_ctr = 0, phase_ctr = 0, dropped = 0;  // the same in every thread

  T r_tp = inf, r_vol = T(0);
  int r_ord = 0;
  if (t < k && n_frames > 0) {
    r_tp = tpitch[lane_base + t];
    r_vol = volume[lane_base + t];
    r_ord = (int)loud_order[lane_base + t];
  }
  __syncthreads();

  for (int f = 0; f < n_frames; ++f) {
    const bool is_data = f < prm.n_data;
    const T fS = (T)((double)f * S_d);
    const T fS_m1 = (T)((double)fS - 1.0);

    // ---- 1. lanes: store, prefetch, windows [lb, ub), increments; (a)
    const T x = r_tp;
    const bool tvalid = t < k && finite_(x) && is_data;
    if (t < k) {
      s.tp[t] = x;
      s.vol[t] = r_vol;
      s.ord[t] = r_ord;
      s.match[t] = -1;
      s.newslot[t] = -2;  // -2: not an accepted on (set in 5.)
      s.lb[t] = lower_bound(s.plp, kQ, sub_rn(x, c[C_MAXD]));
      s.ub[t] = tvalid ? upper_bound(s.plp, kQ, add_rn(x, c[C_MAXD])) : -1;
      s.inc[t] = increment_of(x, c);
      if (tvalid) atomicMax(&s.misc[1], t + 1);
      if (f + 1 < n_frames) {
        const long long o = lane_base + (long long)(f + 1) * k + t;
        r_tp = tpitch[o];
        r_vol = volume[o];
        r_ord = (int)loud_order[o];
      }
    }
    if (t < P && s.state[t] == 2 && f >= s.f1[t]) s.state[t] = 0;  // (a)
    if (t < kQ) s.cont[t] = 0;
    __syncthreads();

    // ---- 2. (b) the two-pointer recurrence, one thread
    if (t == 0) {
      const int last = s.misc[1];
      int it = 0, nm = 0;
      for (int j0 = 0; j0 < last; j0 += 8) {
        int lbv[8], ubv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = j0 + i;
          lbv[i] = j < last ? s.lb[j] : 0;
          ubv[i] = j < last ? s.ub[j] : -1;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int cc = max(it, lbv[i]);
          const bool m = cc < ubv[i];
          if (m) { s.match[j0 + i] = cc; s.cont[cc] = 1; ++nm; }
          it = cc + (int)m;
        }
      }
      s.misc[0] = nm;
    }
    __syncthreads();
    const int n_cont = s.misc[0];

    // ---- 3. (c) note offs, (d) note changes, the note-on candidates
    if (t < kQ && is_data && finite_(s.plp[t]) && !s.cont[t]) {
      const int sl = s.pls[t];
      if (sl >= 0) {
        const T press = sfc(s, S_PRESS, P, sl), A = sfc(s, S_A, P, sl);
        const T H = sfc(s, S_H, P, sl), D = sfc(s, S_D, P, sl);
        const T R = sfc(s, S_R, P, sl);
        // envelope value the release starts from (env_pressed at release-1)
        const T tp = sub_rn(fS_m1, press);
        const T va = clamp01(div_rn(add_rn(tp, T(1)), A));
        const T vd = add_rn(mul_rn(c[C_SUS_M1],
                                   clamp01(div_rn(add_rn(sub_rn(sub_rn(tp, A), H), T(1)),
                                                  clamp_min(D, T(1))))),
                            T(1));
        const T AH = add_rn(A, H);
        const T AHD = add_rn(AH, D);
        const T top = tp < A ? va
                    : (tp < AH ? T(1) : ((D > T(0) && tp < AHD) ? vd : c[C_SUS]));
        const long long f1 = (long long)f + (long long)ceil_(mul_rn(R, c[C_INV_S])) + 1;
        s.state[sl] = 2;
        sfc(s, S_RELEASE, P, sl) = fS;
        sfc(s, S_TOP, P, sl) = top;
        s.f1[sl] = (int)(f1 < prm.total_frames ? f1 : prm.total_frames);
      }
    }
    if (t < k) {
      const int m = s.match[t];
      int sl = -1;
      if (m >= 0) {
        sl = s.pls[m];
        if (sl >= 0) {
          sfc(s, S_CURINC, P, sl) = s.inc[t];
          sfc(s, S_CURVOL, P, sl) = s.vol[t];
        }
      }
      s.lslot[t] = sl;
      s.ison[t] = tvalid && m < 0 && s.vol[t] > T(0);
    }
    __syncthreads();

    // ---- 4. (e) ranks: ons in loudness order, free slots in slot order
    const int on = t < k ? s.ison[s.ord[t]] : 0;
    const int fr = t < P ? (int)(s.state[t] == 0) : 0;
    int tot;
    const int ex = block_excl_scan(on | (fr << 16), s.wsum, tot);
    const int rank = ex & 0xffff, frank = ex >> 16;
    const int n_on = tot & 0xffff, n_free = tot >> 16;
    if (fr) s.fbr[frank] = t;
    const int cap = prm.max_voices - n_cont;
    const int n_allowed = min(n_on, max(cap, 0));
    const int n_slotted = min(n_allowed, n_free);
    const bool allowed = on && rank < cap;
    __syncthreads();

    // ---- 5. births of the accepted ons
    if (t < k) {
      if (allowed) {
        const int j = s.ord[t];
        int slot = -1;  // accepted, no free slot
        if (rank < n_free) {
          slot = s.fbr[rank];
          const long long pan_idx = prm.stable_draws
              ? (long long)f * prm.max_voices + rank : pan_ctr + rank;
          const long long phase_idx = prm.stable_draws
              ? pan_idx : phase_ctr + rank;
          const T pan = mul_rn(c[C_SPREAD],
                               pan_draws[min(max(pan_idx, 0LL), n_pan - 1)]);
          const T th = mul_rn(c[C_QPI], add_rn(pan, T(1)));
          const T ph0 = phase_draws[min(max(phase_idx, 0LL), n_phase - 1)];
          const T on_inc = s.inc[j];
          const T on_vol = s.vol[j];
          // floor(0.5 + 5 * reciprocal(clamp(|inc|, min=1e-9)))
          const T mc = floor_(add_rn(mul_rn(div_rn(T(1), clamp_min(abs_(on_inc),
                                                                      c[C_EPS_INC])),
                                            T(5)),
                                     T(0.5)));
          const T A = clamp_min(clamp_min(mc, c[C_ATTACK]), T(1));
          const T D = prm.has_decay ? clamp_min(clamp_min(mc, c[C_DECAY]), T(1)) : T(0);
          const T R = clamp_min(clamp_min(mc, c[C_RELEASE]), T(1));
          s.state[slot] = 1;
          s.f1[slot] = prm.total_frames;
          sfc(s, S_PRESS, P, slot) = fS;
          sfc(s, S_RELEASE, P, slot) = c[C_FAR];
          sfc(s, S_TOP, P, slot) = c[C_SUS];
          sfc(s, S_A, P, slot) = A;
          sfc(s, S_H, P, slot) = c[C_HOLD];
          sfc(s, S_D, P, slot) = D;
          sfc(s, S_R, P, slot) = R;
          sfc(s, S_GL, P, slot) = cos_(th);
          sfc(s, S_GR, P, slot) = sin_(th);
          sfc(s, S_PHASE, P, slot) = ph0;
          sfc(s, S_VOLB, P, slot) = on_vol;
          sfc(s, S_PREVINC, P, slot) = on_inc;
          sfc(s, S_CURINC, P, slot) = on_inc;
          sfc(s, S_CURVOL, P, slot) = on_vol;
        }
        s.newslot[j] = slot;
      }
    }
    pan_ctr += n_allowed;
    phase_ctr += n_slotted;
    dropped += n_on - n_allowed;
    __syncthreads();

    // ---- 6. (f) ranks of the continued and accepted lanes; (g) the rows
    const int is_new = t < k && s.newslot[t] != -2;
    const int kept = t < k && s.match[t] >= 0;
    int tot2;
    const int ex2 = block_excl_scan(is_new | (kept << 16), s.wsum, tot2);
    const int n_new = tot2 & 0xffff, n_kept = tot2 >> 16;
    if (t < k) { s.pref_new[t] = ex2 & 0xffff; s.pref_kept[t] = ex2 >> 16; }

    if (t < P) {
      T* row = out + ((long long)f * P + t) * kNF;
      const bool emit = s.state[t] > 0 && f < s.f1[t];
      const T inc_to = sfc(s, S_CURINC, P, t);
      const T inc_from = sfc(s, S_PREVINC, P, t);
      if (emit) {
        const T ratio = inc_to == inc_from ? T(0)
            : log_(div_rn(clamp_min(inc_to, c[C_TINY]), clamp_min(inc_from, c[C_TINY])));
        const T alpha = sub_rn(T(1), exp_(mul_rn(c[C_NEG_PI],
                                                 clamp_max(abs_(inc_to), c[C_TWO_OVER_S]))));
        const T phase = sfc(s, S_PHASE, P, t);
        const T curvol = sfc(s, S_CURVOL, P, t);
        const T volb = sfc(s, S_VOLB, P, t);
        T v[kNF];
        v[F_INC] = inc_from;
        v[F_RATIO] = ratio;
        v[F_PHB] = phase;
        v[F_VTGT] = curvol;
        v[F_VB] = volb;
        v[F_ALPHA] = alpha;
        v[F_TP0] = sub_rn(fS, sfc(s, S_PRESS, P, t));
        v[F_TR0] = clamp_min(sub_rn(fS, sfc(s, S_RELEASE, P, t)), c[C_NEG_FAR]);
        v[F_TOP] = sfc(s, S_TOP, P, t);
        v[F_A] = sfc(s, S_A, P, t);
        v[F_H] = sfc(s, S_H, P, t);
        v[F_D] = sfc(s, S_D, P, t);
        v[F_SUS] = c[C_SUS];
        v[F_R] = sfc(s, S_R, P, t);
        v[F_GL] = sfc(s, S_GL, P, t);
        v[F_GR] = sfc(s, S_GR, P, t);
#pragma unroll
        for (int i = 0; i < kNF; ++i) row[i] = v[i];
        // the recurrences of a sounding slot
        const T lam = mul_rn(ratio, c[C_INV_S]);
        const T dphi = ratio == T(0) ? mul_rn(c[C_S], inc_from)
            : mul_rn(div_rn(inc_from, lam == T(0) ? T(1) : lam), expm1_(ratio));
        sfc(s, S_PHASE, P, t) = remainder2(add_rn(phase, dphi));
        sfc(s, S_VOLB, P, t) = add_rn(curvol, mul_rn(sub_rn(volb, curvol),
                                                     pow_(sub_rn(T(1), alpha), c[C_S])));
        sfc(s, S_PREVINC, P, t) = inc_to;
      } else {
#pragma unroll
        for (int i = 0; i < kNF; ++i) row[i] = s.def[i];
      }
    }
    __syncthreads();

    // ---- 7. (f) the new played set: kept i at i + #ons strictly below,
    // on j at j + #kept at or below (kept before new on equal pitches)
    if (t < k && (is_new || kept)) {
      const T xp = s.tp[t];
      int pos, slot;
      if (kept) {
        const int lo = lower_bound(s.tp, k, xp);
        pos = s.pref_kept[t] + (lo < k ? s.pref_new[lo] : n_new);
        slot = s.lslot[t];
      } else {
        const int hi = upper_bound(s.tp, k, xp);
        pos = s.pref_new[t] + (hi < k ? s.pref_kept[hi] : n_kept);
        slot = s.newslot[t];
      }
      if (pos < kQ) { s.plp[pos] = xp; s.pls[pos] = slot; }
    }
    if (t < kQ && t >= n_new + n_kept) { s.plp[t] = inf; s.pls[t] = -1; }
    if (t == 0) s.misc[1] = 0;
    __syncthreads();
  }
  if (t == 0) dropped_out[job] = dropped;
}

template <typename T>
int launch(const void* tpitch, const void* volume, const void* loud_order,
           int n_jobs, int n_frames, int k, int P, const void* pan, long long n_pan,
           const void* phase, long long n_phase, const void* defaults,
           const Params& prm, void* table, void* dropped, cudaStream_t stream) {
  int threads = k > kQ ? k : kQ;
  if (P > threads) threads = P;
  threads = (threads + 31) & ~31;
  const size_t smem = smem_layout<T>(k, P, nullptr, nullptr);
  cudaError_t e = cudaFuncSetAttribute(tracker_scan_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  tracker_scan_kernel<T><<<n_jobs, threads, smem, stream>>>(
      static_cast<const T*>(tpitch), static_cast<const T*>(volume),
      static_cast<const long long*>(loud_order), n_frames, k, P,
      static_cast<const T*>(pan), n_pan, static_cast<const T*>(phase), n_phase,
      static_cast<const T*>(defaults), prm, static_cast<T*>(table),
      static_cast<long long*>(dropped));
  return (int)cudaGetLastError();
}

}  // namespace

// Played-set capacity the kernel holds (device_tracker._Q; ops/cuda_scan
// checks it) and the number of constants it takes.
extern "C" int tracker_scan_q(void) { return kQ; }
extern "C" int tracker_scan_n_constants(void) { return kNConst; }

// The exact frame loop of n_jobs jobs in one launch. tpitch, volume
// (n_jobs, n_frames, k) of the working type (float32, or float64 when f64
// is nonzero), loud_order (n_jobs, n_frames, k) int64, the pools (n_pan,),
// (n_phase,) and the defaults row (16,) of the working type, all
// contiguous on the device; consts: kNConst host doubles
// (ops/cuda_scan.scan_constants); ints: max_voices, total_frames (=
// n_frames), n_data (analysis frames), has_decay, stable draws. Writes
// table (n_jobs, n_frames, n_slots, 16) and dropped (n_jobs,) int64.
// Returns the cudaError_t of the launch (0 on success; nothing is launched
// for no job or no frame).
extern "C" int tracker_scan(const void* tpitch, const void* volume,
                            const void* loud_order, int n_jobs, int n_frames, int k,
                            int n_slots, const void* pan, long long n_pan,
                            const void* phase, long long n_phase, const void* defaults,
                            const double* consts, const int* ints, int f64,
                            void* table, void* dropped, void* stream) {
  if (n_jobs < 0 || n_frames < 0 || k < 1 || k > kMaxThreads || n_slots < 1
      || n_slots > kMaxThreads || n_pan < 1 || n_phase < 1)
    return (int)cudaErrorInvalidValue;
  if (n_jobs == 0) return 0;
  if (n_jobs > 2147483647) return (int)cudaErrorInvalidValue;
  Params prm;
  for (int i = 0; i < kNConst; ++i) prm.c[i] = consts[i];
  prm.max_voices = ints[0];
  prm.total_frames = ints[1];
  prm.n_data = ints[2];
  prm.has_decay = ints[3];
  prm.stable_draws = ints[4];
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch<double>(tpitch, volume, loud_order, n_jobs, n_frames, k, n_slots,
                          pan, n_pan, phase, n_phase, defaults, prm, table, dropped, s);
  return launch<float>(tpitch, volume, loud_order, n_jobs, n_frames, k, n_slots,
                       pan, n_pan, phase, n_phase, defaults, prm, table, dropped, s);
}
