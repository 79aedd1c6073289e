// Bit-plane GEMV for Hopper: y = (x @ W) * scale over b-bit packed weights.
//
// Replaces the TPU kernel src/repro/kernels/bitplane_gemv/kernel.py
// (`_kernel`, launched by `bitplane_gemv_pallas`).
//
// W holds b in {2,4,8}-bit two's-complement codes packed along K into int8
// words, low bits first: element k = i*per_byte + s lives in word i, digit s
// (kernel.py:47-56).  `packed` is row-major (K*b/8, N), `scale` is (1, N)
// float32, x is (M, K) float32 or bfloat16, and y is (M, N) float32 or
// bfloat16.  Accumulation is float32.
//
// Three routes, each its own C entry point; the caller picks one by M and
// the type of x (kernels/bitplane_gemv/kernel.py, `route`):
//   * decode (M <= 8): each weight byte is used by a handful of rows, so
//     the kernel is bound by device-memory bytes, b/8 per weight;
//   * tensor_core (bfloat16 x, M > 8: chunked and one-shot prefill): the
//     tile of csrc/tc_gemm.cuh, bound by 2*M*K*N bf16 tensor-core operations;
//   * rows (float32 x, M > 8): the CUDA-core design below with 32-row
//     blocks, as a bf16 x would round float32 activations.
//
// Decode: `dec::` in csrc/gemv_decode.cuh (split-K over a thread-block
// cluster, bf16 x on mma.sync), shared with the int8 baseline's decode
// route.  A b <= 8-bit code is exact in bf16 and a bf16 x times it exact in
// float32, so its products are the TPU kernel's, which casts x to float32
// and dots exact digits (kernel.py:60-79); only the order of the float32
// sums differs.  The TPU kernel's radix-digit walk does not survive there:
// the code is rebuilt whole and the result cannot depend on radix, which
// the entry point still checks.
//
// Rows (`bitplane_gemv_kernel`), the CUDA-core design:
//   * neighbouring threads own neighbouring output columns n, so every
//     packed byte is read once per row block, by one thread, and a warp's
//     reads of one packed row are coalesced;
//   * a block covers 32 columns and up to 32 rows; its 8 warps split each K
//     tile between them and add their partial sums in shared memory at the
//     end;
//   * each thread issues UNROLL independent packed-word loads before it
//     uses any, so a memory-bound call keeps many bytes in flight instead
//     of waiting out one load's latency at a time;
//   * the x tile is staged in shared memory as float32, transposed so the
//     TM rows that meet one weight are one vectorised broadcast read;
//   * each code's radix-bit digits are retired into the signed weight in
//     registers, the top digit carrying the sign (kernel.py:63-79), with
//     bits and radix compile-time constants so the walk costs a few
//     integer instructions; the weight meets x in one fp32 FMA per row.
//     Every product is exact, so the result does not depend on radix at
//     all; it differs from the plain version only in the order of the sum;
//   * edges in M, K and N are masked in the kernel; nothing is padded.
// The per-channel scale is applied once, at the end, as kernel.py:82-84 does.
// Bias is not part of the kernel: EnginePlan.apply adds it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemv_decode.cuh"
#include "tc_gemm.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Signed value of one BITS-bit two's-complement code, retired RADIX bits
// at a time with the top digit signed.  RADIX is a compile-time constant,
// so the walk unrolls into a few shifts and adds per code.
template <int BITS, int RADIX>
__device__ __forceinline__ int retire_digits(unsigned code) {
  constexpr int n_digits = BITS / RADIX;
  constexpr int digit_mask = (1 << RADIX) - 1;
  int value = 0;
#pragma unroll
  for (int d = 0; d < n_digits; ++d) {
    int digit = (int)(code >> (d * RADIX)) & digit_mask;
    if (d == n_digits - 1) digit -= ((digit >> (RADIX - 1)) & 1) << RADIX;
    value += digit * (1 << (d * RADIX));
  }
  return value;
}

// One block: 32 output columns (one per lane) x TM rows; WARPS warps split
// each TK-element K tile; UNROLL packed words in flight per thread.
template <int BITS, int RADIX, int WARPS, int TM, int TK, int UNROLL,
          typename XT>
__global__ void __launch_bounds__(32 * WARPS)
bitplane_gemv_kernel(const uint8_t* __restrict__ packed,
                     const float* __restrict__ scale,
                     const XT* __restrict__ x, void* __restrict__ out,
                     int M, int K, int N, int out_bf16) {
  constexpr int THREADS = 32 * WARPS;
  constexpr int PER_BYTE = 8 / BITS;
  constexpr int TILE_WORDS = TK / PER_BYTE;
  constexpr unsigned CODE_MASK = (1u << BITS) - 1u;
  static_assert(TK * TM >= WARPS * TM * 32, "reduction must fit the tile");
  // x tile as [k][m] while accumulating; [warp][m][column] partial sums at
  // the end.  TK * TM floats.
  extern __shared__ __align__(16) unsigned char imagine_smem[];
  float* smem = reinterpret_cast<float*>(imagine_smem);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * TM;
  const int kp = K / PER_BYTE;

  float acc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = threadIdx.x; i < TM * TK; i += THREADS) {
      const int m = i / TK, k = i % TK;  // coalesced along k
      float v = 0.f;
      if (m0 + m < M && k0 + k < K) {
        v = to_f32(x[(size_t)(m0 + m) * K + k0 + k]);
      }
      smem[k * TM + m] = v;
    }
    __syncthreads();
    const int w0 = k0 / PER_BYTE;
    const int nw = min(TILE_WORDS, kp - w0);  // words of this tile
    if (n < N) {
      for (int base = warp * UNROLL; base < nw; base += WARPS * UNROLL) {
        unsigned word[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          word[u] = base + u < nw ? packed[(size_t)(w0 + base + u) * N + n]
                                  : 0u;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (base + u < nw) {
#pragma unroll
            for (int s = 0; s < PER_BYTE; ++s) {
              const float wv = (float)retire_digits<BITS, RADIX>(
                  (word[u] >> (s * BITS)) & CODE_MASK);
              const float* xs = smem + ((base + u) * PER_BYTE + s) * TM;
#pragma unroll
              for (int m = 0; m < TM; ++m) acc[m] = fmaf(xs[m], wv, acc[m]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) smem[(warp * TM + m) * 32 + lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < TM * 32; i += THREADS) {
    const int m = i / 32, c = i % 32;
    const int col = blockIdx.x * 32 + c;
    if (m0 + m >= M || col >= N) continue;
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += smem[(w * TM + m) * 32 + c];
    sum *= scale[col];
    const size_t o = (size_t)(m0 + m) * N + col;
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(sum);
    } else {
      reinterpret_cast<float*>(out)[o] = sum;
    }
  }
}

template <int WARPS, int TM, int TK, int UNROLL, typename XT>
int launch(const void* packed, const void* scale, const void* x, void* out,
           int M, int K, int N, int bits, int radix, int out_bf16,
           cudaStream_t stream) {
  const dim3 grid((N + 31) / 32, (M + TM - 1) / TM);
  const size_t smem = sizeof(float) * TK * TM;  // 32 KB: no opt-in needed
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  const XT* xx = static_cast<const XT*>(x);
#define IMAGINE_GEMV(B, R)                                                   \
  if (bits == B && radix == R) {                                             \
    bitplane_gemv_kernel<B, R, WARPS, TM, TK, UNROLL, XT>                    \
        <<<grid, 32 * WARPS, smem, stream>>>(p, s, xx, out, M, K, N,         \
                                             out_bf16);                      \
    return (int)cudaGetLastError();                                          \
  }
  IMAGINE_GEMV(2, 1)
  IMAGINE_GEMV(2, 2)
  IMAGINE_GEMV(4, 1)
  IMAGINE_GEMV(4, 2)
  IMAGINE_GEMV(4, 4)
  IMAGINE_GEMV(8, 1)
  IMAGINE_GEMV(8, 2)
  IMAGINE_GEMV(8, 4)
  IMAGINE_GEMV(8, 8)
#undef IMAGINE_GEMV
  return (int)cudaErrorInvalidValue;
}

int check(int M, int K, int N, int bits, int radix) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  if (radix < 1 || radix > bits || bits % radix != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (K % (8 / bits) != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// y (M, N) = (x (M, K) @ unpack(packed (K*bits/8, N))) * scale (1, N).
// x_bf16 / out_bf16: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t.

// M <= 8 (the decode route): `splits` K splits, 1 .. 8, each holding some
// K (kernels/_gemv.py, `decode_splits`).  The result does not depend on
// radix, which is checked and otherwise unused.
extern "C" int imagine_bitplane_gemv_decode(const void* packed,
                                            const void* scale, const void* x,
                                            void* out, int M, int K, int N,
                                            int bits, int radix, int splits,
                                            int x_bf16, int out_bf16,
                                            void* stream) {
  if (int err = check(M, K, N, bits, radix)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      return dec::launch<2>(packed, scale, x, out, M, K, N, splits, x_bf16,
                            out_bf16, s);
    case 4:
      return dec::launch<4>(packed, scale, x, out, M, K, N, splits, x_bf16,
                            out_bf16, s);
    default:
      return dec::launch<8>(packed, scale, x, out, M, K, N, splits, x_bf16,
                            out_bf16, s);
  }
}

// float32 x at M > 8 on the CUDA cores, 32 rows a block (bfloat16 x at
// M > 8 takes the tensor-core entry below).
extern "C" int imagine_bitplane_gemv_rows(const void* packed,
                                          const void* scale, const void* x,
                                          void* out, int M, int K, int N,
                                          int bits, int radix, int x_bf16,
                                          int out_bf16, void* stream) {
  if (int err = check(M, K, N, bits, radix)) return err;
  if (x_bf16) return (int)cudaErrorInvalidValue;
  return launch<8, 32, 256, 4, float>(packed, scale, x, out, M, K, N, bits,
                                      radix, out_bf16,
                                      static_cast<cudaStream_t>(stream));
}

// bfloat16 x through the tensor-core tile; the result does not depend on
// radix.  `partial`: float32 (splits, M, N) when splits > 1, else null.
extern "C" int imagine_bitplane_gemv_tc(const void* packed, const void* scale,
                                        const void* x, void* out,
                                        void* partial, int M, int K, int N,
                                        int bits, int splits, int out_bf16,
                                        void* stream) {
  if (int err = check(M, K, N, bits, 1)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      return tc::launch<2>(packed, scale, x, out, partial, M, K, N, splits,
                           out_bf16, s);
    case 4:
      return tc::launch<4>(packed, scale, x, out, partial, M, K, N, splits,
                           out_bf16, s);
    default:
      return tc::launch<8>(packed, scale, x, out, partial, M, K, N, splits,
                           out_bf16, s);
  }
}
