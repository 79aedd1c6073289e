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
// Three routes, picked in Python by dtype and head dim (`kernels/
// flash_attention/kernel.py`, `route`), each its own entry point:
//
// tensor_core (bfloat16 q, k, v): `flash_tc_kernel`, on the pieces of
// csrc/tc_attention.cuh.  The operations bound is met on the tensor cores:
//   * one block, one warpgroup of 4 warps, per (lane, query head, 64-row
//     query tile); warp w holds rows 16w .. 16w + 15 of the 64 x D float32
//     accumulator and their (m, l) statistics in registers;
//   * the query tile and two stages of 64-key K and V tiles sit in shared
//     memory in wgmma's 128-byte swizzled layout (64-byte at D = 32); every
//     thread copies with 16-byte cp.async, and the next tile's copies run
//     under the current tile's products;
//   * S = Q K^T is one wgmma m64n64k16 per 16 columns of D, both operands
//     from shared memory; O += P V is wgmma m64nDk16 with P in registers
//     (the score accumulator is, element for element, P's A fragment) and
//     V read in place through the transpose bit (MN-major), so V is never
//     copied into another layout;
//   * P is split into bf16 hi + lo and multiplied twice into the same V,
//     which keeps the float32 p of the TPU kernel to 16 bits (one bf16 P
//     misses the output's one-ulp tolerance: PERF.md);
//   * key tiles wholly above the diagonal or outside the window are not
//     visited; only the diagonal, window-edge and ragged tiles are masked;
//     blocks start heaviest query tile first across all (lane, head)s; the
//     ragged tail of S is zero-filled by the copies and masked by index
//     (no padded copy);
//   * the epilogue stages the bf16 output tile through shared memory so
//     each thread stores 16 bytes of a row;
//   * D = 256 (161 KB of tiles, one block an SM): the 64 x 256 float32
//     accumulator takes 128 registers a thread, so O += P V is issued one
//     16-key step at a time (P hi + lo of that step, then wait), which
//     keeps 8 P registers live instead of 32, and each step is two
//     m64n128k16 over V's two column halves (tc_attention.cuh).
// An mma.sync design of the same tile (ldmatrix fragments, every warp
// reading all of K and V, as the paged prefill does) was a quarter slower
// at the one-shot prefill's shape (PERF.md).
//
// cuda_core (float32 q, k, v at D <= 256): `flash_attention_kernel`, the
// first design, kept for float32 because bf16 operands would round its
// inputs:
//   * one block per (lane, query head, 64-row query tile) holds its query
//     tile in shared memory as float32 and walks the key tiles in a loop,
//     which replaces the TPU grid's sequential KV axis; the (m, l)
//     statistics and the output accumulator stay in registers and never
//     touch device memory;
//   * the same tile skipping and ragged-S masking as above; the query
//     tiles of one (lane, head) heaviest first;
//   * each thread owns a 4 x 4 block of the 64 x 64 score tile (rows
//     tr*4 + i, columns tc + 16*j) and 4 x D/16 outputs, so each shared
//     memory read feeds four FMAs; K rows are padded by one word so the
//     16 columns of a half-warp fall in 16 banks; the row max and row sum
//     of the softmax are warp shuffles over the 16 threads of a row;
//   * the probabilities overwrite the key tile in shared memory once the
//     scores are taken, so two blocks fit on an SM at D = 128.
//
// wide, the route past D 256 (float32 or bfloat16 q, k, v, any D):
// `flash_wide_kernel`.  The tiles above hold whole rows of D, in registers
// (the accumulator) and in shared memory (q, k, v); past 256 they no
// longer fit, so this design streams D instead:
//   * one block of 8 warps per (lane, query head, 32 query rows, 512
//     output columns): warp w owns query rows q0 + 4w .. 4w + 3, their
//     (m, l) and a 512-column slice of their output rows, 16 float32
//     values a row a lane (columns lane + 32c); grid.z walks the slices,
//     so any D takes the same registers, and D <= 512 takes one;
//   * a step covers 32 keys, one a lane.  The scores stream over D in
//     32-column slices: the block stages the 32 query rows' and the 32
//     keys' slice in shared memory (rows padded by one word against bank
//     conflicts), and each lane adds its key's 32 products to a running
//     float32 score of each of its warp's rows, in column order, reading
//     each key column once for the four rows;
//   * the online softmax of each row is warp shuffles (max, then sum of
//     p); the step's value rows over the block's 512 columns are staged
//     in shared memory (72 KB in all), and each lane adds p_t * v for its
//     columns below D, p_t broadcast from lane t;
//   * past 512 columns, every block of a row recomputes the row's scores:
//     the route exists for head dims no config uses, and holds the
//     reference's function there; it is not built for speed.
// Nothing is zero-padded: D is a run-time value, and columns past D are
// read as zeros and never stored.
//
// Numerics follow the TPU kernel on both routes: scores are (q . k) *
// D^-0.5 summed in float32 from exact products, masked scores are NEG_INF
// = -1e30 (finite, so a row whose step is wholly masked takes exp(0) = 1
// there and the next real step wipes it through corr), p = exp(s - m) is
// float32 (hi + lo on the tensor cores) for p . v, l sums the float32 p,
// and the end divides by max(l, 1e-30) (kernel.py:47-73).  The online
// softmax steps over 64 keys where the TPU kernel steps over 128: the same
// function, with the running max taken in other steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_attention.cuh"

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

// ------------------------------------------------------ route wide, D > 256
constexpr int WIDE_ROWS = 32;                // query rows a block
constexpr int WIDE_RPW = WIDE_ROWS / 8;      // query rows a warp
constexpr int WIDE_KEYS = 32;                // keys a step: one a lane
constexpr int WIDE_COLS = 16;                // output columns a lane
constexpr int WIDE_SLICE = 32 * WIDE_COLS;   // output columns a block
// shared memory: the query rows' and the keys' 32-column slice (rows
// padded by one word), the step's value rows over the block's columns
constexpr int WIDE_SMEM =
    (int)sizeof(float) * ((WIDE_ROWS + WIDE_KEYS) * 33 +
                          WIDE_KEYS * WIDE_SLICE);
static_assert(THREADS == 256 && WIDE_RPW * 8 == WIDE_ROWS, "8 warps");

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int Hq, int Hkv,
    int D, int window, float sm_scale) {
  extern __shared__ __align__(16) float wide_smem[];
  float(*sq)[33] = reinterpret_cast<float(*)[33]>(wide_smem);
  float(*sk)[33] = reinterpret_cast<float(*)[33]>(wide_smem + WIDE_ROWS * 33);
  float(*sv)[WIDE_SLICE] = reinterpret_cast<float(*)[WIDE_SLICE]>(
      wide_smem + (WIDE_ROWS + WIDE_KEYS) * 33);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int d0 = blockIdx.z * WIDE_SLICE;     // this block's output columns
  const int cols = D - d0;                    // of them, those below D
  const int q0 = qt * WIDE_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * WIDE_RPW;             // this warp's first row

  float m[WIDE_RPW], l[WIDE_RPW], acc[WIDE_RPW][WIDE_COLS];
#pragma unroll
  for (int r = 0; r < WIDE_RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < WIDE_COLS; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + WIDE_ROWS, S) - 1;
  const int kt_hi = q_last / WIDE_KEYS;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / WIDE_KEYS : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * WIDE_KEYS;
    // the scores of key k0 + lane for the warp's rows, over D in 32-column
    // slices, each key column read once for all of them
    float s[WIDE_RPW];
#pragma unroll
    for (int r = 0; r < WIDE_RPW; ++r) s[r] = 0.f;
    for (int dc = 0; dc < D; dc += 32) {
      __syncthreads();  // the previous slice's (or step's) readers are done
      for (int i = tid; i < WIDE_ROWS * 32; i += THREADS) {
        const int r = i / 32, c = i % 32;
        const int p = q0 + r, d = dc + c;
        sq[r][c] = p < S && d < D
            ? to_f32(q[(((size_t)b * S + p) * Hq + h) * D + d]) : 0.f;
      }
      for (int i = tid; i < WIDE_KEYS * 32; i += THREADS) {
        const int t = i / 32, c = i % 32;
        const int kp = k0 + t, d = dc + c;
        sk[t][c] = kp < S && d < D
            ? to_f32(k[(((size_t)b * S + kp) * Hkv + hk) * D + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float kc = sk[lane][c];
#pragma unroll
        for (int r = 0; r < WIDE_RPW; ++r)
          s[r] = fmaf(sq[r0 + r][c], kc, s[r]);
      }
    }

    // the online softmax of each of the warp's rows
    const int kp = k0 + lane;
    float p[WIDE_RPW];
#pragma unroll
    for (int r = 0; r < WIDE_RPW; ++r) {
      const int qp = q0 + r0 + r;
      bool valid = kp <= qp && kp < S;
      if (window > 0) valid = valid && kp > qp - window;
      const float sc = valid ? s[r] * sm_scale : NEG_INF;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      p[r] = expf(sc - m_new);
      float sum = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < WIDE_COLS; ++c) acc[r][c] *= corr;
    }

    // this block's columns of the step's value rows (the score slices'
    // barriers ordered every earlier reader of sv before these writes)
    for (int i = tid; i < WIDE_KEYS * WIDE_SLICE; i += THREADS) {
      const int t = i / WIDE_SLICE, c = i % WIDE_SLICE;
      const int vp = k0 + t, d = d0 + c;
      sv[t][c] = vp < S && d < D
          ? to_f32(v[(((size_t)b * S + vp) * Hkv + hk) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < WIDE_KEYS; ++t) {
      float vv[WIDE_COLS];
#pragma unroll
      for (int c = 0; c < WIDE_COLS; ++c)
        vv[c] = 32 * c < cols ? sv[t][lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < WIDE_RPW; ++r) {
        const float pt = __shfl_sync(0xffffffffu, p[r], t);
#pragma unroll
        for (int c = 0; c < WIDE_COLS; ++c)
          if (32 * c < cols) acc[r][c] = fmaf(pt, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < WIDE_RPW; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* dst = out + (((size_t)b * S + qp) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < WIDE_COLS; ++c) {
      const int d = d0 + lane + 32 * c;
      if (d < D) store(dst + d, acc[r][c] / denom);
    }
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out,
                int B, int S, int Hq, int Hkv, int D, int window,
                float sm_scale, cudaStream_t stream) {
  if ((size_t)B * Hq > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = flash_wide_kernel<T>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + WIDE_ROWS - 1) / WIDE_ROWS, B * Hq,
                  (D + WIDE_SLICE - 1) / WIDE_SLICE);
  kernel<<<grid, THREADS, WIDE_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, D, window,
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
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, Hq, Hkv, window, sm_scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------ route tensor_core
// Rows `p0 ..` of one head of q, k or v ((B, S, H, D), element (b, p, hh,
// d) at ((b * S + p) * H + hh) * D + d) into a swizzled tile of BKV rows;
// rows at or past S are zeros.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int b,
                                          int S, int H, int hh, int p0,
                                          int tid) {
  using Sw = tca::Swz<D>;
  constexpr int COPIES = tca::BKV * Sw::CH / tca::THREADS;
  static_assert(COPIES * tca::THREADS == tca::BKV * Sw::CH, "whole rows");
#pragma unroll
  for (int it = 0; it < COPIES; ++it) {
    const int i = it * tca::THREADS + tid;
    const int r = i / Sw::CH, c = i % Sw::CH;
    const int p = p0 + r;
    const bool ok = p < S;
    const __nv_bfloat16* g =
        src + (ok ? (((size_t)b * S + p) * H + hh) * D + c * 8 : 0);
    tc::cp_async<16>(dst + Sw::off(r, c), g, ok);
  }
}

// Shared memory: the query tile, then two stages of [K tile][V tile],
// each bf16 [64][D] in wgmma's swizzled layout from a 1024-byte aligned
// base (the slack covers the alignment).
template <int D>
struct TcLayout {
  static constexpr int TILE = tca::Swz<D>::TILE_BYTES;
  static constexpr int BYTES = 5 * TILE + 1024;
};

// One warpgroup per (lane, query head, 64-row query tile); grid (B * Hq,
// query tiles).
template <int D>
__global__ void __launch_bounds__(tca::THREADS, 2) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int S, int Hq, int Hkv, int window, float sm_scale) {
  using Sw = tca::Swz<D>;
  constexpr int TILE = TcLayout<D>::TILE;
  constexpr int BQ_ = tca::BQ, BKV_ = tca::BKV;
  extern __shared__ __align__(128) uint8_t flash_tc_smem[];
  uint8_t* sm = flash_tc_smem +
                ((1024 - (tc::smem_u32(flash_tc_smem) & 1023)) & 1023);
  const uint32_t base = tc::smem_u32(sm);

  // blocks start in the order of their index, x fastest: the query tiles
  // of every (lane, head) heaviest first, so the long walks start early
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ_;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // key tiles holding a key some row of this tile may attend
  const int q_last = min(q0 + BQ_, S) - 1;
  const int kt_hi = q_last / BKV_;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BKV_ : 0;

  // the query tile at base, stage s's K at base + (1 + 2s) * TILE and V
  // after it
  load_rows<D>(base, q, b, S, Hq, h, q0, tid);
  load_rows<D>(base + TILE, k, b, S, Hkv, hk, kt_lo * BKV_, tid);
  load_rows<D>(base + 2 * TILE, v, b, S, Hkv, hk, kt_lo * BKV_, tid);
  tc::cp_async_commit();
  tca::Warp<D> w;
  tca::start(w);

  const int qp0 = q0 + 16 * warp + lane / 4;  // rows qp0 and qp0 + 8
  const int t2 = 2 * (lane % 4);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    const uint32_t kt_s = base + (1 + 2 * st) * TILE, vt_s = kt_s + TILE;
    if (kt < kt_hi) {
      const uint32_t nxt = base + (1 + 2 * (st ^ 1)) * TILE;
      load_rows<D>(nxt, k, b, S, Hkv, hk, (kt + 1) * BKV_, tid);
      load_rows<D>(nxt + TILE, v, b, S, Hkv, hk, (kt + 1) * BKV_, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();   // tile kt has landed for this thread ...
    tc::fence_proxy_async();  // ... is visible to wgmma ...
    __syncthreads();          // ... and has landed for all

    float s[BKV_ / 8][4];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      tca::wgmma_ss_n64(s, tca::desc_k<D>(base, kk),
                        tca::desc_k<D>(kt_s, kk), kk);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tca::keep(s);

    const int k0 = kt * BKV_;
    // the diagonal tile (and the ragged end of S past it) and the
    // window's edge need the mask; every other visited tile is whole
    const bool edge = k0 + BKV_ - 1 > q0 ||
                      (window > 0 && k0 <= q0 + BQ_ - 1 - window);
#pragma unroll
    for (int j = 0; j < BKV_ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sc = s[j][e] * sm_scale;
        if (edge) {
          const int kp = k0 + 8 * j + t2 + (e & 1);
          const int qp = qp0 + 8 * (e >> 1);
          bool valid = kp <= qp;
          if (window > 0) valid = valid && kp > qp - window;
          sc = valid ? sc : tca::NEG_INF;
        }
        s[j][e] = sc;
      }
    }
    tca::softmax<D, false>(w, s, nullptr, lane);
    if constexpr (D <= 128) {
      uint32_t hi[BKV_ / 16][4], lo[BKV_ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV_ / 16; ++kk) {
        tca::p_frags<true>(s, kk, hi[kk], lo[kk]);
      }
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV_ / 16; ++kk) {
        tca::wgmma_pv<D>(w.o, hi[kk], vt_s, kk);
        tca::wgmma_pv<D>(w.o, lo[kk], vt_s, kk);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tca::keep(w.o);
    } else {   // one step's P live at a time beside the 128-register O
#pragma unroll
      for (int kk = 0; kk < BKV_ / 16; ++kk) {
        uint32_t hi[4], lo[4];
        tca::p_frags<true>(s, kk, hi, lo);
        tc::wgmma_fence();
        tca::wgmma_pv<D>(w.o, hi, vt_s, kk);
        tca::wgmma_pv<D>(w.o, lo, vt_s, kk);
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tca::keep(w.o);
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  // epilogue: the bf16 tile through the query tile's slot, then 16-byte
  // rows
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + lane / 4 + 8 * hh;
      *reinterpret_cast<uint32_t*>(sm + Sw::off(r, j) + 2 * t2) =
          tca::pack(tca::out_value(w, j, 2 * hh),
                    tca::out_value(w, j, 2 * hh + 1));
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ_ * Sw::CH; i += tca::THREADS) {
    const int r = i / Sw::CH, c = i % Sw::CH;
    const int qp = q0 + r;
    if (qp >= S) continue;
    *reinterpret_cast<uint4*>(out + (((size_t)b * S + qp) * Hq + h) * D +
                              8 * c) =
        *reinterpret_cast<const uint4*>(sm + Sw::off(r, c));
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int Hq, int Hkv, int window, float sm_scale,
              cudaStream_t stream) {
  auto kernel = flash_tc_kernel<D>;
  constexpr int smem = TcLayout<D>::BYTES;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(B * Hq, (S + tca::BQ - 1) / tca::BQ);
  kernel<<<grid, tca::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, Hq, Hkv, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Route cuda_core.  q (B, S, Hq, D), k / v (B, S, Hkv, D) -> out (B, S, Hq,
// D), all of one dtype (0 = float32, 1 = bfloat16); D in {32, 64, 128,
// 256}; Hq a multiple of Hkv; window 0 = full causal.  Returns a
// cudaError_t.
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

// Route wide: as cuda_core with any D >= 1 on the design that streams D
// (B * Hq at most 65535); the route takes it past D 256.  Returns a
// cudaError_t.
extern "C" int imagine_flash_attention_wide(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int S, int Hq, int Hkv, int D,
                                            int window, float sm_scale,
                                            int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_wide<float>(q, k, v, out, B, S, Hq, Hkv, D, window,
                              sm_scale, s);
  if (dtype == 1)
    return launch_wide<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, D, window,
                                      sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// Route tensor_core: as above with every tensor bfloat16 and 16-byte
// aligned.  Returns a cudaError_t.
extern "C" int imagine_flash_attention_tc(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int S, int Hq, int Hkv, int D,
                                          int window, float sm_scale,
                                          void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t addrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (addrs % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_tc<32>(q, k, v, out, B, S, Hq, Hkv, window, sm_scale, s);
    case 64:
      return launch_tc<64>(q, k, v, out, B, S, Hq, Hkv, window, sm_scale, s);
    case 128:
      return launch_tc<128>(q, k, v, out, B, S, Hq, Hkv, window, sm_scale,
                            s);
    case 256:
      return launch_tc<256>(q, k, v, out, B, S, Hq, Hkv, window, sm_scale,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
