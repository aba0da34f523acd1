// Voice-bank block renderer for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cpp_audio_tpu/ops/pallas_voicebank.py:30
// (_kernel, launched by render_blocks_pallas at :86), and also evaluates the
// per-voice eased curve codes that only the XLA form had
// (cpp_audio_tpu/models/voicebank.py:180 _render_block), so every voice-bank
// render of the port on CUDA runs here.
//
// What it computes, per time block b, sample k of that block and voice row v:
//   phase  = ((b*B - press + 1) + k) * inc + phase0   mod 2^32   (exact NCO)
//            bitcast to int32, times 2^-31 -> rad/pi in [-1, 1)
//   env    = closed-form AHDSR from int32 sample offsets (attack, hold,
//            decay to S, release from the precomputed `top`; 0 before the
//            press and when skipped), each segment through its easing curve
//   sig    = amp * env * sinpi_principal(phase)
//   out[b*B + k, c] = sum_v sig * gains[v, c]          (voice order)
//
// Design. The TPU kernel ran one grid step per time block and built the
// whole (V, B) tile in VMEM before an MXU mixdown. Here the grid is 2-D —
// sample tiles x time blocks — and nothing carries between blocks. Each
// thread owns kSamplesPerThread samples of block b (strided by the block
// width so a warp's stores are contiguous), loops over the block's voice
// rows, which are staged in shared memory kChunk rows at a time (so there is
// no bound on V), and keeps the C channel sums in registers, summed in voice
// order: deterministic, no atomics. The output is written (t, C) row-major.
// Tables come with a per-block row stride: 0 for the dense (V, fields)
// layout, V_max for the per-block compacted (n_blocks, V_max, fields) one.
//
// Bound. FP32 ALU work: about 40 flops per voice-sample (envelope, NCO,
// degree-9 sine polynomial, C multiply-adds), against 8 bytes of output per
// sample per channel pair. The C = 2 mixdown is a reduction over voices that
// is useless to the tensor cores, so it stays in FMA units. Making it fast —
// skipping voice rows that are silent over a whole sample tile, tuning
// occupancy and samples per thread — is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound through ctypes (cpp_audio_tpu_torch/ops/cuda_voicebank.py); the host
// function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 4;
constexpr int kTile = kThreads * kSamplesPerThread;
constexpr int kChunk = 128;

// packed float field order (cpp_audio_tpu/models/voicebank.py:136)
enum { F_AMP, F_A, F_H, F_D, F_R, F_S, F_TOP, F_SKIP, N_FIELDS };

// sin(pi*z) = z*(C1 + C3 z^2 + C5 z^4 + C7 z^6 + C9 z^8), z in [-0.5, 0.5]
// (cpp_audio_tpu/ops/fastmath.py:21-25)
__device__ __forceinline__ float poly_sinpi(float z) {
  const float z2 = z * z;
  return z * (3.14159258f + z2 * (-5.16770687f + z2 * (2.55003119f +
         z2 * (-0.59804419f + z2 * 0.07721839f))));
}

__device__ __forceinline__ float sinpi_principal(float x) {
  const float m = rintf(x);  // round half to even, like jnp.round
  const float z = x - m;
  const float s = 1.0f - 2.0f * fabsf(m);
  return s * poly_sinpi(z);
}

// Penner easing families, in-curves and out-curves (utils/interp.py)
__device__ __forceinline__ float ease_in(int family, float x) {
  switch (family) {
    case 0: return x * x;
    case 1: return x * x * x;
    case 2: return x * x * x * x;
    case 3: return x * x * x * x * x;
    case 4: return 1.0f - cosf(x * 1.57079632679489662f);
    case 5: return x <= 0.0f ? 0.0f : exp2f(10.0f * (x - 1.0f));
    default: return 1.0f - sqrtf(fmaxf(0.0f, 1.0f - x * x));
  }
}

__device__ __forceinline__ float ease_out(int family, float x) {
  const float y = x - 1.0f;
  switch (family) {
    case 0: return x * (2.0f - x);
    case 1: return y * y * y + 1.0f;
    case 2: return 1.0f - y * y * y * y;
    case 3: return y * y * y * y * y + 1.0f;
    case 4: return sinf(x * 1.57079632679489662f);
    case 5: return x >= 1.0f ? 1.0f : 1.0f - exp2f(-10.0f * x);
    default: return sqrtf(fmaxf(0.0f, 1.0f - y * y));
  }
}

// The 23 itp curves (Itp enum, utils/interp.py): 0 LINEAR and
// 1 PROPORTIONAL_VALUE_DERIVATIVE are the identity in the endpoint-free
// table; codes 2..22 are (in, out, in-out) for quad, cubic, quart, quint,
// sine, expo, circ. Unknown codes leave x unchanged (the select's default).
__device__ __forceinline__ float ease(int code, float x) {
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  if (code < 2 || code > 22) return x;
  const int family = (code - 2) / 3;
  switch ((code - 2) % 3) {
    case 0: return ease_in(family, x);
    case 1: return ease_out(family, x);
    default:
      return x < 0.5f ? 0.5f * ease_in(family, 2.0f * x)
                      : 0.5f + 0.5f * ease_out(family, 2.0f * x - 1.0f);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
voicebank_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                 const unsigned* __restrict__ up,
                 const float* __restrict__ gains,
                 const int* __restrict__ codes, float* __restrict__ out,
                 int n_rows, long long block_row_stride, int block_size) {
  __shared__ float s_fp[kChunk][N_FIELDS];
  __shared__ int s_ip[kChunk][2];
  __shared__ unsigned s_up[kChunk][2];
  __shared__ float s_g[kChunk][C];
  __shared__ int s_codes[kChunk][3];

  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const long long row0 = (long long)b * block_row_stride;
  // int32 sample arithmetic as in the JAX package; the subtractions below
  // run in unsigned so a wrap (only for the +-FAR "never" clamp) is defined
  const unsigned b0 = (unsigned)b * (unsigned)block_size;

  float acc[kSamplesPerThread][C];
#pragma unroll
  for (int j = 0; j < kSamplesPerThread; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0f;

  for (int c0 = 0; c0 < n_rows; c0 += kChunk) {
    const int nc = min(kChunk, n_rows - c0);
    const long long r = row0 + c0;
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < nc * N_FIELDS; i += kThreads)
      s_fp[i / N_FIELDS][i % N_FIELDS] = fp[r * N_FIELDS + i];
    for (int i = threadIdx.x; i < nc * 2; i += kThreads) {
      s_ip[i / 2][i % 2] = ip[r * 2 + i];
      s_up[i / 2][i % 2] = up[r * 2 + i];
    }
    for (int i = threadIdx.x; i < nc * C; i += kThreads)
      s_g[i / C][i % C] = gains[r * C + i];
    for (int i = threadIdx.x; i < nc * 3; i += kThreads)
      s_codes[i / 3][i % 3] = codes[r * 3 + i];
    __syncthreads();

    for (int v = 0; v < nc; ++v) {
      const float amp = s_fp[v][F_AMP];
      const float A = s_fp[v][F_A];
      const float H = s_fp[v][F_H];
      const float D = s_fp[v][F_D];
      const float R = s_fp[v][F_R];
      const float S = s_fp[v][F_S];
      const float top = s_fp[v][F_TOP];
      const bool skipped = s_fp[v][F_SKIP] > 0.5f;
      const unsigned press = (unsigned)s_ip[v][0];
      const unsigned release = (unsigned)s_ip[v][1];
      const unsigned inc = s_up[v][0];
      const unsigned phase0 = s_up[v][1];
      const int a_itp = s_codes[v][0];
      const int d_itp = s_codes[v][1];
      const int r_itp = s_codes[v][2];
      const float tp0 = (float)(int)(b0 - press);
      const float tr0 = (float)(int)(b0 - release);
      const unsigned base = b0 - press + 1u;
      const float Dm = fmaxf(D, 1.0f);

#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const int k = tile0 + j * kThreads + (int)threadIdx.x;
        const float kf = (float)k;
        const float tp = tp0 + kf;
        const float trm = tr0 + kf;
        float env = 0.0f;
        if (!(tp < 0.0f) && !skipped) {
          if (trm < 0.0f) {
            if (tp < A) {
              env = ease(a_itp, (tp + 1.0f) / A);
            } else if (tp < A + H) {
              env = 1.0f;
            } else if (tp < A + H + D) {
              env = 1.0f + (S - 1.0f) * ease(d_itp, (tp - A - H + 1.0f) / Dm);
            } else {
              env = S;
            }
          } else if (trm + 1.0f < R) {
            env = top * (1.0f - ease(r_itp, (trm + 1.0f) / R));
          }
        }
        // exact NCO in native uint32 (wraps mod 2^32)
        const unsigned ph = (base + (unsigned)k) * inc + phase0;
        const float phase = (float)(int)ph * 4.6566128730773926e-10f;  // 2^-31
        const float sig = amp * env * sinpi_principal(phase);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[j][c] += sig * s_g[v][c];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kSamplesPerThread; ++j) {
    const int k = tile0 + j * kThreads + (int)threadIdx.x;
    if (k < block_size) {
      const long long t = (long long)b * block_size + k;
#pragma unroll
      for (int c = 0; c < C; ++c) out[t * C + c] = acc[j][c];
    }
  }
}

template <int C>
void launch(const float* fp, const int* ip, const unsigned* up,
            const float* gains, const int* codes, float* out, int n_rows,
            long long block_row_stride, int block_size, int n_blocks,
            cudaStream_t stream) {
  const dim3 grid((block_size + kTile - 1) / kTile, n_blocks);
  voicebank_kernel<C><<<grid, kThreads, 0, stream>>>(
      fp, ip, up, gains, codes, out, n_rows, block_row_stride, block_size);
}

}  // namespace

// Renders n_blocks blocks of block_size samples into out (n_blocks*block_size,
// n_channels) float32. Row r of block b is read at index b*block_row_stride + r
// of fp (.., 8) f32, ip (.., 2) int32 [press, release], up (.., 2) uint32
// [inc, phase0], gains (.., n_channels) f32 and codes (.., 3) int32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int voicebank_render(const float* fp, const int* ip,
                                const unsigned* up, const float* gains,
                                const int* codes, float* out, int n_rows,
                                int n_channels, long long block_row_stride,
                                int block_size, int n_blocks, void* stream) {
  if (n_blocks <= 0 || block_size <= 0) return 0;
  if (n_rows < 0 || n_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_channels == 1) {
    launch<1>(fp, ip, up, gains, codes, out, n_rows, block_row_stride,
              block_size, n_blocks, s);
  } else if (n_channels == 2) {
    launch<2>(fp, ip, up, gains, codes, out, n_rows, block_row_stride,
              block_size, n_blocks, s);
  } else {
    return (int)cudaErrorInvalidValue;  // mono and stereo mixdowns only
  }
  return (int)cudaGetLastError();
}
