// Flash attention for Hopper: causal (+ sliding window) GQA softmax
// attention over a whole sequence, one pass, with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_kernel`, launched by `flash_attention_pallas`).
//
// Layouts (the model's, as `kernels/flash_attention/ops.py` takes them):
// q (B, S, Hq, D), k and v (B, S, Hkv, D), all float32 or all bfloat16,
// contiguous; query head h reads KV head h / (Hq / Hkv).  The output has
// q's layout and dtype.
//
// What bounds it on an H100: at the one-shot prefill's shapes (S = 4096,
// D = 128) every key meets ~S/2 queries, so the work is 4*D operations per
// (query, key) pair under the causal diagonal and the kernel is bound by
// operations, not by bytes; the TPU kernel exists to keep the S x S scores
// out of device memory, and so does this one.
//
// What this simple design does about that:
//   * one block per (lane, query head, 64-row query tile) holds its query
//     tile in shared memory as float32 and walks the key tiles in a loop,
//     which replaces the TPU grid's sequential KV axis; the (m, l)
//     statistics and the output accumulator stay in registers and never
//     touch device memory;
//   * the walk covers only the key tiles some row of the query tile may
//     attend: tiles wholly above the causal diagonal or wholly outside the
//     window are skipped (the TPU kernel computes them and masks them to
//     nothing, so the result is the same); query tiles are issued heaviest
//     first, so the long walks start early;
//   * the ragged tail of S is masked by index: no padded copy is made;
//   * each thread owns a 4 x 4 block of the 64 x 64 score tile (rows
//     tr*4 + i, columns tc + 16*j) and 4 x D/16 outputs, so each shared
//     memory read feeds four FMAs; K rows are padded by one word so the
//     16 columns of a half-warp fall in 16 banks; the row max and row sum
//     of the softmax are warp shuffles over the 16 threads of a row;
//   * the probabilities overwrite the key tile in shared memory once the
//     scores are taken, so two blocks fit on an SM at D = 128.
// Tensor cores (mma.sync / wgmma) and TMA loads are left to later work.
//
// Numerics follow the TPU kernel: q, k and v are widened to float32,
// scores are (q . k) * D^-0.5, masked scores are NEG_INF = -1e30 (finite,
// so a row whose step is wholly masked takes exp(0) = 1 there and the next
// real step wipes it through corr), p = exp(s - m) stays float32 for p . v,
// and the end divides by max(l, 1e-30) (kernel.py:47-73).  The online
// softmax steps over 64 keys where the TPU kernel steps over 128: the same
// function, with the running max taken in other steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per online-softmax step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory of one block, in floats: the query tile [BQ][D+1], the key
// tile [BKV][D+1] (later the probabilities [BQ][BKV+1]), the value tile
// [BKV][D].
template <int D>
struct Layout {
  static constexpr int QS = D + 1;    // row stride of the q and k tiles
  static constexpr int PS = BKV + 1;  // row stride of the probabilities
  static constexpr int Q = BQ * QS;
  static constexpr int KP = BKV * QS > BQ * PS ? BKV * QS : BQ * PS;
  static constexpr int V = BKV * D;
  static constexpr int TOTAL = Q + KP + V;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int Hq, int Hkv,
    int window, float sm_scale) {
  using L = Layout<D>;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float flash_smem[];
  float* sq = flash_smem;
  float* sk = flash_smem + L::Q;
  float* sp = sk;  // the probabilities overwrite the key tile
  float* sv = sk + L::KP;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // rows tr*4 .. tr*4+3
  const int tc = tid % 16;  // columns tc + 16*j

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    sq[r * L::QS + d] =
        qp < S ? to_f32(q[(((size_t)b * S + qp) * Hq + h) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // key tiles holding a key some row of this tile may attend
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_hi = q_last / BKV;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BKV : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous step's readers of p and v are done
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const int kp = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (kp < S) {
        const size_t src = (((size_t)b * S + kp) * Hkv + hk) * D + d;
        kv = to_f32(k[src]);
        vv = to_f32(v[src]);
      }
      sk[t * L::QS + d] = kv;
      sv[i] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(tr * 4 + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(tc + 16 * j) * L::QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        bool valid = kp <= qp && kp < S;
        if (window > 0) valid = valid && kp > qp - window;
        s[i][j] = valid ? s[i][j] * sm_scale : NEG_INF;
      }
    }
    __syncthreads();  // every thread has read the key tile: p may replace it

    // online-softmax update; the 16 threads of a row are 16 lanes of a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sp[(tr * 4 + i) * L::PS + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BKV; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(tr * 4 + i) * L::PS + t];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = sv[t * D + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tr * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = out + (((size_t)b * S + qp) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(dst + tc + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int window, float sm_scale,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = sizeof(float) * Layout<D>::TOTAL;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, window,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Hq, int Hkv, int D, int window, float sm_scale,
               cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, Hq, Hkv, window, sm_scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, Hq, Hkv, window, sm_scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, Hq, Hkv, window, sm_scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, Hq, D), k / v (B, S, Hkv, D) -> out (B, S, Hq, D), all of one
// dtype (0 = float32, 1 = bfloat16); D in {32, 64, 128}; Hq a multiple of
// Hkv; window 0 = full causal.  Returns a cudaError_t.
extern "C" int imagine_flash_attention(const void* q, const void* k,
                                       const void* v, void* out, int B,
                                       int S, int Hq, int Hkv, int D,
                                       int window, float sm_scale, int dtype,
                                       void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, B, S, Hq, Hkv, D, window,
                             sm_scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, D, window,
                                     sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
