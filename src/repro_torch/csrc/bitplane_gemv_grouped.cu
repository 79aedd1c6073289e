// The bit-plane GEMV's expert-grouped launch for Hopper: the function of the
// TPU kernel src/repro/kernels/bitplane_gemv/kernel.py (`_kernel`,
// launched by `bitplane_gemv_pallas`) over stacked MoE experts.
//
// `imagine_bitplane_gemv_grouped`: packed (E, K*b/8, N) with (E, 1, N)
// scales, and x / y rows sorted by expert, expert e's at [offsets[e],
// offsets[e+1]) with `offsets` (E + 1,) int32 on the device.  JAX runs its experts through
// the jnp reference (src/repro/engine/backends.py:206-209 refuses stacked
// weights), so this is the TPU kernel's function on the one layout it
// never took.  Each route puts the experts on one more grid dimension
// (grid.z: the decode route's split-K cluster is on grid.y); a block reads
// its expert's row range on the device and returns at once when it holds
// no rows of it, so a step reads only the codes of the experts the routing
// chose, with no count read back by the host.  The route and the launch's
// row tiles come from `max_rows`, a bound on an expert's rows that the
// caller fixes from the shapes (kernels/_gemv.py `grouped_route`), so the
// launch can be captured in a CUDA graph.  Bound: the codes of the touched
// experts (b/8 bytes a weight) at decode, 2 * rows * K * N bf16 operations
// in a prefill chunk.
//
// The three routes' kernels are csrc/gemv_decode.cuh's grouped cluster
// kernels (`dec::launch_grouped`), csrc/gemv_rows.cuh's (`rows::`) and
// csrc/tc_gemm.cuh's (`tc::`), the last two instantiated here with their
// GROUPED switch on; this file is apart from csrc/bitplane_gemv.cu so that
// the two compile side by side.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemv_decode.cuh"
#include "gemv_rows.cuh"
#include "tc_gemm.cuh"

// Stacked experts (the note at the top): packed (E, K*bits/8, N), scale
// (E, 1, N), x (R, K) and out (R, N) rows sorted by expert, `offsets`
// (E + 1,) int32 on the device.  `route`: 0 decode (max_rows <= 8, K split
// `splits`), 1 rows (float32 x), 2 tensor_core (bfloat16 x); `max_rows`
// bounds an expert's rows (each route computes at least that many of an
// expert's rows).  Rows past offsets[E] are not written.
extern "C" int imagine_bitplane_gemv_grouped(
    const void* packed, const void* scale, const void* x, const void* offsets,
    void* out, int E, int max_rows, int K, int N, int bits, int radix,
    int splits, int route, int x_bf16, int out_bf16, void* stream) {
  if (int err = rows::check(max_rows, K, N, bits, radix)) return err;
  if (E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (route == 0) {
    if (max_rows > dec::ROWS) return (int)cudaErrorInvalidValue;
    switch (bits) {
      case 2:
        return dec::launch_grouped<2>(packed, scale, x, out, off, E, K, N,
                                      splits, x_bf16, out_bf16, s);
      case 4:
        return dec::launch_grouped<4>(packed, scale, x, out, off, E, K, N,
                                      splits, x_bf16, out_bf16, s);
      default:
        return dec::launch_grouped<8>(packed, scale, x, out, off, E, K, N,
                                      splits, x_bf16, out_bf16, s);
    }
  }
  if (route == 1) {
    if (x_bf16) return (int)cudaErrorInvalidValue;
    return rows::launch<8, 32, 256, 4, float, true>(packed, scale, x, out, off, E,
                                              max_rows, K, N, bits, radix,
                                              out_bf16, s);
  }
  if (route != 2 || !x_bf16) return (int)cudaErrorInvalidValue;
  switch (bits) {
    case 2:
      return tc::launch_grouped<2>(packed, scale, x, out, off, E, max_rows, K,
                                   N, out_bf16, s);
    case 4:
      return tc::launch_grouped<4>(packed, scale, x, out, off, E, max_rows, K,
                                   N, out_bf16, s);
    default:
      return tc::launch_grouped<8>(packed, scale, x, out, off, E, max_rows, K,
                                   N, out_bf16, s);
  }
}
