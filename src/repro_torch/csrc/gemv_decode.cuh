// The decode route of both GEMVs (M <= 8): y = (x @ W) * scale over b-bit
// packed rows, b in {2, 4, 8}.
//
// Included by csrc/bitplane_gemv.cu (its decode route) and
// csrc/int8_matvec.cu (the int8 bit-parallel baseline's decode route: its
// row-major (K, N) int8 codes are byte for byte the 8-bit packed rows, and
// `decode_a<8>` reads a byte as a two's-complement code).  One source
// serves both kernels' decode.
//
// At the serving path's shapes the bytes take 0.1-3.4 us on the card, so
// the design is about filling it and keeping the chain of each thread
// short.  A first design (one block of 32 warps per 32 output columns,
// byte loads, an integer digit walk and float32 FMAs) gave N = 2048 64
// blocks and N = 256 8, and its CUDA-core work alone was above the bytes
// bound at M = 8 (PERF.md).  This one:
//   * splits K: a column tile of 128 weight columns gets `splits` blocks (a
//     Python function of the shapes and the SM count, kernels/_gemv.py
//     `decode_splits`), launched as one thread-block cluster; each block
//     sums its share of K over 8 warps, adds the warps' sums in warp order,
//     and the cluster adds its blocks' sums through distributed shared
//     memory in split order.  No partial sums go to device memory, no
//     second kernel runs, no atomics: two runs give the same bits;
//   * reads each packed row once, 16 bytes a lane (16 neighbouring
//     columns; 8-byte or byte loads where N or the base is not aligned),
//     eight loads in flight a lane before any is used;
//   * bfloat16 x: the products on the tensor cores, mma.sync m16n8k16 with
//     the decoded weight as A (16 columns x 16 K) and x^T as B (n = 8: the
//     decode step's 8 lanes, rows past M zero).  The fragment layout is
//     chosen so that a lane's 16-byte reads feed its A registers directly:
//     tile f's row g is column 16g + 2f, and the lane's K pairs are its own
//     packed rows.  Codes become bf16 by exponent-bias tricks (tc_gemm.cuh:
//     a code XOR its sign bit in the mantissa of bf16 128, paired by prmt,
//     less the bias; 8-bit codes through the float 2^23), not by I2F;
//   * float32 x (the engine path at M = 1): the same loads, each code made
//     a float by the same 2^23 trick and met by x in float32 FMAs on the
//     CUDA cores (bf16 would round x); exact on integer inputs whose sums
//     stay below 2^24.
// A b <= 8-bit code is exact in bf16 and a bf16 x times it exact in
// float32, so both products are the TPU kernels' (which cast x to float32
// and dot exact codes); only the order of the float32 sums differs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace {
// ------------------------------------------------------------ route decode
// M <= 8: split-K over a cluster of blocks, the packed rows read once with
// 16-byte loads, bf16 x on mma.sync and float32 x on the CUDA cores.  The
// note at the top of the file says why.  `launch<BITS>` is the entry.
namespace dec {

constexpr int COLS = 128;        // weight columns a block: 16 a lane group
constexpr int KSTEP = 16;        // K of one mma.sync step
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 8;          // rows of x a launch takes (mma's n = 8)
constexpr int MAX_SPLITS = 8;    // the portable cluster size

// Lane (g, t) = (lane / 4, lane % 4) of a warp owns columns n0 + 16 g ..
// n0 + 16 g + 15 and, in every K step at kb, the four K kb + 4t .. kb + 4t
// + 3: LANE_ROWS packed rows of STEP_ROWS, read 16 bytes (its columns) at a
// time, UNROLL steps of them in flight (8 loads a lane).
template <int BITS>
struct Step {
  static constexpr int STEP_ROWS = KSTEP * BITS / 8;
  static constexpr int LANE_ROWS = BITS / 2;
  static constexpr int UNROLL = 8 / LANE_ROWS;
};

// 16 bytes of packed row `row` (N bytes a row) from column `col`, zeros
// past N or when !ok.  VEC: 16 or 8 when N and the base allow, else 1.
template <int VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row,
                                        int col, int N, bool ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || col >= N) return v;
  if constexpr (VEC == 16) {
    v = __ldg(reinterpret_cast<const uint4*>(row + col));
  } else if constexpr (VEC == 8) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(row + col));
    v.x = lo.x;
    v.y = lo.y;
    if (col + 8 < N) {
      const uint2 hi = __ldg(reinterpret_cast<const uint2*>(row + col + 8));
      v.z = hi.x;
      v.w = hi.y;
    }
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (col + i < N) {
        w[i / 4] |= (uint32_t)__ldg(row + col + i) << (8 * (i % 4));
      }
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The A fragment of mma tile f from the lane's rows of one K step.  Tile f
// row g is column 16 g + 2f, row g + 8 column 16 g + 2f + 1 (bytes j, j + 1
// of word f / 2); its K pairs (2t, 2t+1) and (2t+8, 2t+9) are the K kb +
// 4t, +1 and kb + 4t + 2, +3 of the B fragment (x), so each register pairs
// two codes of one column: a[0] / a[2] the low / high K pair of column
// 2f, a[1] / a[3] of column 2f + 1.
template <int BITS>
__device__ __forceinline__ void decode_a(const uint4 (&w)[BITS / 2], int f,
                                         uint32_t (&a)[4]) {
  const int q = f >> 1, j = 2 * (f & 1);
  if constexpr (BITS == 8) {
    // rows 4t .. 4t + 3: one K each; c XOR 0x80 in the low byte of the
    // float 2^23, less 2^23 + 128, is c, and exact again in bf16
    uint32_t v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = word(w[r], q) ^ 0x80808080u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {       // column 2f + h
#pragma unroll
      for (int p = 0; p < 2; ++p) {     // K pair p: rows 2p, 2p + 1
        const float f0 =
            __uint_as_float(__byte_perm(v[2 * p], 0x4B000000u,
                                        0x7540 | (j + h))) - 8388736.f;
        const float f1 =
            __uint_as_float(__byte_perm(v[2 * p + 1], 0x4B000000u,
                                        0x7540 | (j + h))) - 8388736.f;
        __nv_bfloat162 pr = __floats2bfloat162_rn(f0, f1);
        a[2 * p + h] = *reinterpret_cast<uint32_t*>(&pr);
      }
    }
  } else {
    // 4-bit: rows 2t, 2t + 1, a K pair each (low, high nibble); 2-bit: row
    // t, K pairs in crumbs (0, 1) and (2, 3).  Each code XOR its sign bit
    // (c + 2^(b-1)) paired in the mantissas of bf16 128, less 128 +
    // 2^(b-1), is exact (tc_gemm.cuh's decode)
    constexpr uint32_t MASK = BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
    constexpr uint32_t BIAS = BITS == 4 ? 0x08080808u : 0x02020202u;
    constexpr uint32_t SUB = BITS == 4 ? 0xC308C308u : 0xC302C302u;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t src = word(w[BITS == 4 ? p : 0], q);
      const int s0 = BITS == 4 ? 0 : 4 * p;
      const uint32_t lo = ((src >> s0) & MASK) ^ BIAS;
      const uint32_t hi = ((src >> (s0 + BITS)) & MASK) ^ BIAS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[2 * p + h] = tc::bf2_add(
            tc::pair_bytes(lo, hi, j + h) | 0x43004300u, SUB);
      }
    }
  }
}

// The signed code of K kb + 4t + i, column byte c, as a float (exact).
template <int BITS>
__device__ __forceinline__ float code_f32(const uint4 (&w)[BITS / 2], int i,
                                          int c) {
  constexpr int PER_BYTE = 8 / BITS;
  const uint32_t src = word(w[i / PER_BYTE], c / 4);
  const int shift = (i % PER_BYTE) * BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr uint32_t SIGN = 1u << (BITS - 1);
  const uint32_t biased = ((src >> (8 * (c % 4) + shift)) & MASK) ^ SIGN;
  return __uint_as_float(0x4B000000u | biased) - (8388608.f + (float)SIGN);
}

// The block's per-warp sums [warp][m][column] summed in warp order into
// `part`, then the cluster's parts (split z = cluster rank z) summed in
// split order by the cluster's threads, scaled and stored.
__device__ __forceinline__ void reduce_store(
    float (&red)[WARPS][ROWS][COLS], float (&part)[ROWS][COLS],
    const float* __restrict__ scale, void* __restrict__ out, int M, int N,
    int n0, int out_bf16) {
  namespace cg = cooperative_groups;
  const int tid = threadIdx.x;
  __syncthreads();
  for (int i = tid; i < M * COLS; i += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += (&red[w][0][0])[i];
    (&part[0][0])[i] = sum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's part is in its block's shared memory
  const int splits = (int)gridDim.y, rank = (int)cluster.block_rank();
  for (int i = rank * THREADS + tid; i < M * COLS; i += splits * THREADS) {
    const int n = n0 + i % COLS;
    if (n >= N) continue;
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) {
      sum += cluster.map_shared_rank(&part[0][0], z)[i];
    }
    sum *= scale[n];
    const size_t o = (size_t)(i / COLS) * N + n;
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(sum);
    } else {
      reinterpret_cast<float*>(out)[o] = sum;
    }
  }
  cluster.sync();   // no block leaves while another reads its part
}

// bfloat16 x: grid (column tiles, splits), one cluster per column tile;
// split blockIdx.y takes K steps [y * per, (y + 1) * per), its warps every
// WARPS-th of them.  D (16 x 8) = A (16 columns x 16 K) x B (16 K x 8 rows
// of x): lane (g, t) adds y rows 2t, 2t + 1 at its 16 columns.
template <int BITS, int VEC>
__global__ void __launch_bounds__(THREADS)
decode_mma_kernel(const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ x,
                  void* __restrict__ out, int M, int K, int N, int per,
                  int x_vec, int out_bf16) {
  using S = Step<BITS>;
  __shared__ __align__(16) float red[WARPS][ROWS][COLS];
  __shared__ __align__(16) float part[ROWS][COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * COLS, col = n0 + 16 * g;
  const int KP = K * BITS / 8, k_steps = (K + KSTEP - 1) / KSTEP;
  const int s0 = blockIdx.y * per, s1 = min(k_steps, s0 + per);
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x) + (size_t)g * K;

  float acc[8][4];
#pragma unroll
  for (int f = 0; f < 8; ++f) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  }
  for (int base = s0 + warp; base < s1; base += WARPS * S::UNROLL) {
    uint4 w[S::UNROLL][S::LANE_ROWS];
    uint32_t xb[S::UNROLL][2];
#pragma unroll
    for (int u = 0; u < S::UNROLL; ++u) {
      const int ks = base + u * WARPS;
      const bool ok = ks < s1;
#pragma unroll
      for (int r = 0; r < S::LANE_ROWS; ++r) {
        const int pr = ks * S::STEP_ROWS + S::LANE_ROWS * t + r;
        w[u][r] = load16<VEC>(packed + (size_t)pr * N, col, N,
                              ok && pr < KP);
      }
      // x row g at K kb + 4t .. + 3, as two bf16 pairs; rows past M zero
      const int k = ks * KSTEP + 4 * t;
      xb[u][0] = xb[u][1] = 0u;
      if (ok && g < M) {
        if (x_vec && k + 3 < K) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(xr + k));
          xb[u][0] = v.x;
          xb[u][1] = v.y;
        } else {
          uint32_t e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            e[i] = k + i < K ? (uint32_t)__ldg(xr + k + i) : 0u;
          }
          xb[u][0] = e[0] | (e[1] << 16);
          xb[u][1] = e[2] | (e[3] << 16);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < S::UNROLL; ++u) {
      if (base + u * WARPS >= s1) break;
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        uint32_t a[4];
        decode_a<BITS>(w[u], f, a);
        tc::mma(acc[f], a, xb[u][0], xb[u][1]);
      }
    }
  }
  // acc[f]: y rows 2t, 2t + 1 at columns 16 g + 2f (e 0, 1) and + 1 (e 2, 3)
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int c = 16 * g + 2 * f;
    *reinterpret_cast<float2*>(&red[warp][2 * t][c]) =
        make_float2(acc[f][0], acc[f][2]);
    *reinterpret_cast<float2*>(&red[warp][2 * t + 1][c]) =
        make_float2(acc[f][1], acc[f][3]);
  }
  reduce_store(red, part, scale, out, M, N, n0, out_bf16);
}

// float32 x on the CUDA cores (bf16 would round x), rows 0 .. MR - 1
// (MR >= M): the same grid, loads and columns; lane (g, t) sums its four
// K a step for its 16 columns, then the four t of a column are added.
template <int BITS, int VEC, int MR>
__global__ void __launch_bounds__(THREADS)
decode_fma_kernel(const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale,
                  const float* __restrict__ x, void* __restrict__ out,
                  int M, int K, int N, int per, int x_vec, int out_bf16) {
  using S = Step<BITS>;
  __shared__ __align__(16) float red[WARPS][ROWS][COLS];
  __shared__ __align__(16) float part[ROWS][COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * COLS, col = n0 + 16 * g;
  const int KP = K * BITS / 8, k_steps = (K + KSTEP - 1) / KSTEP;
  const int s0 = blockIdx.y * per, s1 = min(k_steps, s0 + per);

  float acc[MR][16];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;
  }
  for (int base = s0 + warp; base < s1; base += WARPS * S::UNROLL) {
    uint4 w[S::UNROLL][S::LANE_ROWS];
#pragma unroll
    for (int u = 0; u < S::UNROLL; ++u) {
      const int ks = base + u * WARPS;
#pragma unroll
      for (int r = 0; r < S::LANE_ROWS; ++r) {
        const int pr = ks * S::STEP_ROWS + S::LANE_ROWS * t + r;
        w[u][r] = load16<VEC>(packed + (size_t)pr * N, col, N,
                              ks < s1 && pr < KP);
      }
    }
#pragma unroll
    for (int u = 0; u < S::UNROLL; ++u) {
      const int ks = base + u * WARPS;
      if (ks >= s1) break;
      const int k = ks * KSTEP + 4 * t;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        float xv[4] = {0.f, 0.f, 0.f, 0.f};
        if (m < M) {
          const float* xr = x + (size_t)m * K + k;
          if (x_vec && k + 3 < K) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(xr));
            xv[0] = v.x;
            xv[1] = v.y;
            xv[2] = v.z;
            xv[3] = v.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              xv[i] = k + i < K ? __ldg(xr + i) : 0.f;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            acc[m][c] = fmaf(xv[i], code_f32<BITS>(w[u], i, c), acc[m][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 1);
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 2);
    }
    if (m < M) {
      // lane t stores the column quarter 4t .. 4t + 3 of its 16
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = t == 0 ? acc[m][e] : t == 1 ? acc[m][4 + e]
             : t == 2 ? acc[m][8 + e] : acc[m][12 + e];
      }
      *reinterpret_cast<float4*>(&red[warp][m][16 * g + 4 * t]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  reduce_store(red, part, scale, out, M, N, n0, out_bf16);
}

template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;   // one cluster: every split of a tile
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BITS, int VEC>
int launch_vec(const void* packed, const void* scale, const void* x,
               void* out, int M, int K, int N, int splits, int per,
               int x_vec, int x_bf16, int out_bf16, cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS, splits);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  if (x_bf16) {
    return launch_cluster(decode_mma_kernel<BITS, VEC>, grid, stream, p, s,
                          static_cast<const __nv_bfloat16*>(x), out, M, K, N,
                          per, x_vec, out_bf16);
  }
  const float* xf = static_cast<const float*>(x);
  if (M == 1) {
    return launch_cluster(decode_fma_kernel<BITS, VEC, 1>, grid, stream, p,
                          s, xf, out, M, K, N, per, x_vec, out_bf16);
  }
  return launch_cluster(decode_fma_kernel<BITS, VEC, ROWS>, grid, stream, p,
                        s, xf, out, M, K, N, per, x_vec, out_bf16);
}

template <int BITS>
int launch(const void* packed, const void* scale, const void* x, void* out,
           int M, int K, int N, int splits, int x_bf16, int out_bf16,
           cudaStream_t stream) {
  const int k_steps = (K + KSTEP - 1) / KSTEP;
  if (M > ROWS || splits < 1 || splits > MAX_SPLITS || splits > k_steps) {
    return (int)cudaErrorInvalidValue;
  }
  const int per = (k_steps + splits - 1) / splits;
  if ((k_steps + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  // x rows read 4 elements at a time when every row start is aligned
  const int x_vec = K % 4 == 0 && xa % (x_bf16 ? 8 : 16) == 0;
  if (N % 16 == 0 && pa % 16 == 0) {
    return launch_vec<BITS, 16>(packed, scale, x, out, M, K, N, splits, per,
                                x_vec, x_bf16, out_bf16, stream);
  }
  if (N % 8 == 0 && pa % 8 == 0) {
    return launch_vec<BITS, 8>(packed, scale, x, out, M, K, N, splits, per,
                               x_vec, x_bf16, out_bf16, stream);
  }
  return launch_vec<BITS, 1>(packed, scale, x, out, M, K, N, splits, per,
                             x_vec, x_bf16, out_bf16, stream);
}

}  // namespace dec

}  // namespace
