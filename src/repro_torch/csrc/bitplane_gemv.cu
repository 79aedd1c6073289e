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
// Decode: `dec::` in csrc/gemv_decode.cuh (a balanced stream-K schedule
// over a grid the card holds at once, bf16 x on mma.sync), shared with the
// int8 baseline's decode route.  A b <= 8-bit code is exact in bf16 and a
// bf16 x times it exact in
// float32, so its products are the TPU kernel's, which casts x to float32
// and dots exact digits (kernel.py:60-79); only the order of the float32
// sums differs.  The TPU kernel's radix-digit walk does not survive there:
// the code is rebuilt whole and the result cannot depend on radix, which
// the entry point still checks.
//
// Rows: `rows::` in csrc/gemv_rows.cuh.  The expert-grouped launch over
// stacked MoE experts is csrc/bitplane_gemv_grouped.cu.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemv_decode.cuh"
#include "gemv_rows.cuh"
#include "tc_gemm.cuh"

// y (M, N) = (x (M, K) @ unpack(packed (K*bits/8, N))) * scale (1, N).
// x_bf16 / out_bf16: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t.

// M <= 8 (the decode route): `grid` blocks, 1 .. dec::MAX_GRID and at most
// the launch's (column tile, K step) units (kernels/_gemv.py `decode_grid`);
// `scratch` the split tiles' sums and counters (`decode_scratch`).  The
// result does not depend on radix, which is checked and otherwise unused.
extern "C" int imagine_bitplane_gemv_decode(const void* packed,
                                            const void* scale, const void* x,
                                            void* out, void* scratch, int M,
                                            int K, int N, int bits, int radix,
                                            int grid, int x_bf16,
                                            int out_bf16, void* stream) {
  if (int err = rows::check(M, K, N, bits, radix)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      return dec::launch<2>(packed, scale, x, out, scratch, M, K, N, grid,
                            x_bf16, out_bf16, s);
    case 4:
      return dec::launch<4>(packed, scale, x, out, scratch, M, K, N, grid,
                            x_bf16, out_bf16, s);
    default:
      return dec::launch<8>(packed, scale, x, out, scratch, M, K, N, grid,
                            x_bf16, out_bf16, s);
  }
}

// Blocks of the decode route's kernel for (bits, x_bf16, M) that one SM of
// the current device holds at once, into `blocks` (both GEMVs' decode
// routes instantiate the same kernel, the int8 baseline's at 8 bits).
extern "C" int imagine_gemv_decode_occupancy(int bits, int x_bf16, int M,
                                             int* blocks) {
  switch (bits) {
    case 2:
      return dec::occupancy<2>(x_bf16, M, blocks);
    case 4:
      return dec::occupancy<4>(x_bf16, M, blocks);
    case 8:
      return dec::occupancy<8>(x_bf16, M, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// float32 x at M > 8 on the CUDA cores, 32 rows a block (bfloat16 x at
// M > 8 takes the tensor-core entry below).
extern "C" int imagine_bitplane_gemv_rows(const void* packed,
                                          const void* scale, const void* x,
                                          void* out, int M, int K, int N,
                                          int bits, int radix, int x_bf16,
                                          int out_bf16, void* stream) {
  if (int err = rows::check(M, K, N, bits, radix)) return err;
  if (x_bf16) return (int)cudaErrorInvalidValue;
  return rows::launch<8, 32, 256, 4, float, false>(
      packed, scale, x, out, nullptr, 1, M, K, N, bits, radix, out_bf16,
      static_cast<cudaStream_t>(stream));
}

// bfloat16 x through the tensor-core tile; the result does not depend on
// radix.  `partial`: float32 (splits, M, N) when splits > 1, else null.
extern "C" int imagine_bitplane_gemv_tc(const void* packed, const void* scale,
                                        const void* x, void* out,
                                        void* partial, int M, int K, int N,
                                        int bits, int splits, int out_bf16,
                                        void* stream) {
  if (int err = rows::check(M, K, N, bits, 1)) return err;
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
