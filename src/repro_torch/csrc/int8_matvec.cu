// Bit-parallel int8 GEMV for Hopper: y = (x @ q) * scale, the paper's
// BRAMAC-style comparison point for the bit-serial engine.
//
// Replaces the TPU kernel src/repro/kernels/int8_matvec/kernel.py
// (`_kernel`, launched by `int8_matvec_pallas`).
//
// `q` is row-major (K, N) int8, `scale` is (1, N) float32, x is (M, K)
// float32 or bfloat16, and y is (M, N) float32 or bfloat16:
//   y[m, n] = (sum_k float(x[m, k]) * float(q[k, n])) * scale[n],
// accumulated in float32.  Each weight retires in one multiply (no digit
// walk): the same device-memory traffic as the 8-bit bit-serial engine with
// one pass instead of eight.  x stays float: quantizing it for dp4a / IMMA
// would compute another function.
//
// What bounds it on an H100: at M <= 8 each weight byte meets a handful of
// rows, so it is bound by device-memory bytes (one per weight).  At larger
// M it does 2*M*K*N float32 operations on the CUDA cores.
//
// What this simple design does about that:
//   * the coalesced direction is N: each thread owns 4 adjacent columns and
//     reads their codes with one 32-bit load, so a group of 8 lanes reads
//     one 32-byte sector of a row of q;
//   * a block covers 32 columns; its groups of 8 lanes split each K tile
//     row by row and add their partial sums in shared memory at the end
//     (a fixed order, so the result does not change from run to run);
//   * each thread issues UNROLL independent loads before it uses any, so a
//     memory-bound call keeps many bytes in flight;
//   * the x rows of the block's K tile are staged in shared memory as
//     float32, transposed so the TM rows that meet one weight are one
//     vectorised broadcast read;
//   * two block shapes: up to 8 rows (decode) with 32 K groups, and 16 rows
//     with 16 K groups for larger M; row tiles beyond the first are more
//     blocks of the grid, which read the same weights again from L2;
//   * the per-channel scale is applied once, after the whole K sum, as
//     kernel.py:32-33 does;
//   * ragged M, K and N are masked by index; nothing is padded.  A 32-bit
//     load needs N % 4 == 0 and an aligned q; otherwise the 4 codes are read
//     one byte at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 8;            // lanes per column group
constexpr int COLS = 4 * GROUP;     // columns per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The codes of columns c0..c0+3 of one row of q, low byte first; columns at
// or beyond N read as 0.
template <bool VEC>
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ row,
                                          int c0, int N) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned int*>(row + c0));
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c0 + j < N) w |= (uint32_t)(uint8_t)__ldg(row + c0 + j) << (8 * j);
  }
  return w;
}

// One block: 32 output columns x TM rows.  Its threads form KG groups of 8
// lanes; group kg takes rows kg, kg + KG, ... of each TK-row K tile.
template <int TM, int WARPS, int TK, int UNROLL, bool VEC, typename XT>
__global__ void __launch_bounds__(32 * WARPS)
int8_matvec_kernel(const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   const XT* __restrict__ x, void* __restrict__ out, int M,
                   int K, int N, int out_bf16) {
  constexpr int THREADS = 32 * WARPS;
  constexpr int KG = THREADS / GROUP;
  static_assert(TM % 4 == 0, "x rows are read as float4");
  static_assert(TK >= KG * COLS, "the reduction must fit the x tile");
  // x tile as [k][m] while accumulating; [kg][m][column] partial sums at
  // the end.  TK * TM floats.
  extern __shared__ __align__(16) unsigned char imagine_smem[];
  float* smem = reinterpret_cast<float*>(imagine_smem);

  const int g = threadIdx.x % GROUP;
  const int kg = threadIdx.x / GROUP;
  const int c0 = blockIdx.x * COLS + 4 * g;
  const int m0 = blockIdx.y * TM;

  float acc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += TK) {
    const int nk = min(TK, K - k0);
    for (int i = threadIdx.x; i < TM * TK; i += THREADS) {
      const int m = i / TK, k = i % TK;  // coalesced along k
      float v = 0.f;
      if (m0 + m < M && k < nk) v = to_f32(x[(size_t)(m0 + m) * K + k0 + k]);
      smem[k * TM + m] = v;
    }
    __syncthreads();
    if (c0 < N) {
      for (int base = kg; base < nk; base += KG * UNROLL) {
        uint32_t word[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int k = base + u * KG;
          word[u] = k < nk ? load4<VEC>(q + (size_t)(k0 + k) * N, c0, N)
                           : 0u;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int k = base + u * KG;
          if (k < nk) {
            float wv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wv[j] = (float)(int8_t)(word[u] >> (8 * j));
            }
            const float4* xs = reinterpret_cast<const float4*>(smem + k * TM);
#pragma unroll
            for (int m4 = 0; m4 < TM / 4; ++m4) {
              const float4 xv = xs[m4];
              const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  acc[4 * m4 + r][j] = fmaf(xm[r], wv[j], acc[4 * m4 + r][j]);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    red[((kg * TM + m) * COLS) / 4 + g] =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TM * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    const int col = blockIdx.x * COLS + c;
    if (m0 + m >= M || col >= N) continue;
    float sum = 0.f;
    for (int w = 0; w < KG; ++w) sum += smem[(w * TM + m) * COLS + c];
    sum *= scale[col];
    const size_t o = (size_t)(m0 + m) * N + col;
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(sum);
    } else {
      reinterpret_cast<float*>(out)[o] = sum;
    }
  }
}

template <int TM, int WARPS, int TK, int UNROLL, typename XT>
int launch(const void* q, const void* scale, const void* x, void* out, int M,
           int K, int N, int out_bf16, cudaStream_t stream) {
  const int row_tiles = (M + TM - 1) / TM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + COLS - 1) / COLS, row_tiles);
  const size_t smem = sizeof(float) * TK * TM;  // 32 KB: no opt-in needed
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  const XT* xx = static_cast<const XT*>(x);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (vec) {
    int8_matvec_kernel<TM, WARPS, TK, UNROLL, true, XT>
        <<<grid, 32 * WARPS, smem, stream>>>(qq, s, xx, out, M, K, N,
                                             out_bf16);
  } else {
    int8_matvec_kernel<TM, WARPS, TK, UNROLL, false, XT>
        <<<grid, 32 * WARPS, smem, stream>>>(qq, s, xx, out, M, K, N,
                                             out_bf16);
  }
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_rows(const void* q, const void* scale, const void* x, void* out,
                int M, int K, int N, int out_bf16, cudaStream_t stream) {
  if (M <= 8) {  // decode: bytes-bound, as many loads in flight as fit
    return launch<8, 8, 1024, 16, XT>(q, scale, x, out, M, K, N, out_bf16,
                                      stream);
  }
  return launch<16, 4, 512, 4, XT>(q, scale, x, out, M, K, N, out_bf16,
                                   stream);
}

}  // namespace

// y (M, N) = (x (M, K) @ q (K, N)) * scale (1, N).
// x_bf16 / out_bf16: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int imagine_int8_matvec(const void* q, const void* scale,
                                   const void* x, void* out, int M, int K,
                                   int N, int x_bf16, int out_bf16,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch_rows<__nv_bfloat16>(q, scale, x, out, M, K, N, out_bf16,
                                      s);
  }
  return launch_rows<float>(q, scale, x, out, M, K, N, out_bf16, s);
}
