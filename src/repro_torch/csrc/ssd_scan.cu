// Mamba2 SSD chunked scan for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py (`_kernel`,
// launched by `ssd_scan_pallas`).
//
// Inputs (the kernel's pre-discretised form, kernel.py:66-75): xdt
// (B, S, H, P) = x * dt, la (B, S, H) = dt * A (float32, <= 0), b_in and
// c_in (B, S, N); xdt, b_in and c_in are all float32 or all bfloat16.
// Outputs, both float32: y (B, S, H, P) and the final state h (B, H, P, N).
// P = 64 (the model's ssm_head_dim); N in {64, 128}.
//
// Per (lane, head) the chunks of `chunk` steps run in order, as the TPU
// grid's innermost axis does; within a chunk, with cum the inclusive
// cumulative sum of la and total = cum[-1] (kernel.py:34-60):
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j   (intra)
//        + exp(cum_i) (C_i . h)                                (inter)
//   h'   = h exp(total) + sum_j exp(total - cum_j) xdt_j (x) B_j
// all in float32, the state entering the chunk read by the inter term.
//
// What bounds it on an H100: the chunked algorithm does ~L*(N+P) operations
// per step and head (L = chunk) against ~2P+2N/H bytes, so at L = 256 it
// is bound by operations, and by the sequential walk over chunks.
//
// What this simple design does about that:
//   * one block per (lane, head) walks its chunks in a loop, which replaces
//     the TPU grid's sequential chunk axis; the (P, N) float32 state lives
//     in shared memory for the whole walk and is written once at the end;
//   * a chunk is cut into 64-step sub-tiles: the C tile of the rows i, the
//     B and xdt tiles of the columns j, the decayed (C B^T) tile and the
//     state are staged in shared memory as float32, so the (L, L) decay
//     mask and the intra-chunk products never touch device memory; sub-tiles
//     wholly above the diagonal are skipped (they are masked to zero);
//   * each thread owns a 4 x 4 block of each 64 x 64 product (4 x N/16 of
//     the state update), so one shared-memory read feeds four FMAs; rows of
//     the N-wide tiles are padded by one word so a half-warp's 16 columns
//     fall in 16 banks;
//   * steps past the end of a chunk shorter than 64 are masked by index.
// With one block per (lane, head), B = 4 lanes x H = 24 heads give 96
// blocks on 132 SMs, one block each (~133 KB of shared memory at N = 128).
// The two-pass design (chunk states in parallel, a short scan, then the
// outputs) that fills the card is left to later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int P = 64;   // head width
constexpr int TL = 64;  // steps per sub-tile of a chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared memory of one block, in floats: state [P][N+1], C tile [TL][N+1],
// B tile [TL][N+1], decayed C B^T tile [TL][TL+1], xdt tile [TL][P], the
// state-update decays [TL], then cum and the scan's scratch, [chunk] each.
template <int N>
struct Layout {
  static constexpr int NS = N + 1;
  static constexpr int GS = TL + 1;
  static constexpr int FIXED = P * NS + 2 * TL * NS + TL * GS + TL * P + TL;
};

// Rows [r0, r0 + TL) of a (B, S, N) tensor for lane b, step offset c0,
// masked to the chunk's `len` steps, into a [TL][N+1] float32 tile.
template <typename T, int N>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int b,
                                          int S, int c0, int r0, int len) {
  for (int i = threadIdx.x; i < TL * N; i += THREADS) {
    const int r = i / N, n = i % N;
    const int row = r0 + r;
    dst[r * (N + 1) + n] =
        row < len ? to_f32(src[((size_t)b * S + c0 + row) * N + n]) : 0.f;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const T* __restrict__ xdt, const float* __restrict__ la,
    const T* __restrict__ b_in, const T* __restrict__ c_in,
    float* __restrict__ y, float* __restrict__ h_out, int S, int H,
    int chunk) {
  using L = Layout<N>;
  constexpr int NS = L::NS, GS = L::GS, NPT = N / 16;
  extern __shared__ __align__(16) float ssd_smem[];
  float* sh = ssd_smem;        // [P][NS] state
  float* sc = sh + P * NS;     // [TL][NS] C rows i
  float* sb = sc + TL * NS;    // [TL][NS] B rows j
  float* sg = sb + TL * NS;    // [TL][GS] decayed C B^T
  float* sx = sg + TL * GS;    // [TL][P] xdt rows j
  float* sdec = sx + TL * P;   // [TL] exp(total - cum_j)
  float* scum = sdec + TL;     // [chunk]
  float* stmp = scum + chunk;  // [chunk]

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // rows tr*4 .. tr*4+3
  const int tc = tid % 16;  // columns tc + 16*j
  const int n_tiles = (chunk + TL - 1) / TL;

  for (int i = tid; i < P * NS; i += THREADS) sh[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();  // the previous chunk's readers of cum are done
    for (int t = tid; t < chunk; t += THREADS)
      scum[t] = la[((size_t)b * S + c0 + t) * H + hh];
    __syncthreads();
    // inclusive cumulative sum (Hillis-Steele), ping-pong in shared memory
    float* src = scum;
    float* dst = stmp;
    for (int off = 1; off < chunk; off <<= 1) {
      for (int t = tid; t < chunk; t += THREADS)
        dst[t] = src[t] + (t >= off ? src[t - off] : 0.f);
      __syncthreads();
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    const float* cum = src;
    const float total = cum[chunk - 1];

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * TL;
      load_rows<T, N>(sc, c_in, b, S, c0, i0, chunk);
      __syncthreads();

      // inter: exp(cum_i) * (C_i . h_p), the state entering the chunk
      float yo[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yo[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sc[(tr * 4 + i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = sh[(tc + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yo[i][j] = fmaf(cv[i], hv[j], yo[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + tr * 4 + i;
        const float e = row < chunk ? expf(cum[row]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) yo[i][j] *= e;
      }

      // intra: sum over the column tiles at or below the diagonal
      float yi[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = 0.f;
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TL;
        __syncthreads();  // the previous readers of sb, sg and sx are done
        load_rows<T, N>(sb, b_in, b, S, c0, j0, chunk);
        for (int i = tid; i < TL * P; i += THREADS) {
          const int r = i / P, p = i % P;
          const int row = j0 + r;
          sx[i] = row < chunk
                      ? to_f32(xdt[(((size_t)b * S + c0 + row) * H + hh) * P +
                                   p])
                      : 0.f;
        }
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sc[(tr * 4 + i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sb[(tc + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = i0 + tr * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rj = j0 + tc + 16 * j;
            const float w = (rj <= ri && ri < chunk)
                                ? g[i][j] * expf(cum[ri] - cum[rj])
                                : 0.f;
            sg[(tr * 4 + i) * GS + tc + 16 * j] = w;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int t = 0; t < TL; ++t) {
          float gv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = sg[(tr * 4 + i) * GS + t];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = sx[t * P + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(gv[i], xv[j], yi[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + tr * 4 + i;
        if (row >= chunk) continue;
        float* dst = y + (((size_t)b * S + c0 + row) * H + hh) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[tc + 16 * j] = yi[i][j] + yo[i][j];
      }
    }

    // state update: h' = h exp(total) + sum_j exp(total - cum_j) xdt_j (x) B_j
    float u[4][NPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NPT; ++c) u[i][c] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * TL;
      __syncthreads();  // the previous readers of sb, sx and sdec are done
      load_rows<T, N>(sb, b_in, b, S, c0, j0, chunk);
      for (int i = tid; i < TL * P; i += THREADS) {
        const int r = i / P, p = i % P;
        const int row = j0 + r;
        sx[i] = row < chunk
                    ? to_f32(xdt[(((size_t)b * S + c0 + row) * H + hh) * P +
                                 p])
                    : 0.f;
      }
      for (int t = tid; t < TL; t += THREADS)
        sdec[t] = j0 + t < chunk ? expf(total - cum[j0 + t]) : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < TL; ++t) {
        const float w = sdec[t];
        float xv[4], bv[NPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sx[t * P + tr * 4 + i] * w;
#pragma unroll
        for (int c = 0; c < NPT; ++c) bv[c] = sb[t * NS + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NPT; ++c) u[i][c] = fmaf(xv[i], bv[c], u[i][c]);
      }
    }
    __syncthreads();  // every reader of the entering state is done
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        float* hp = sh + (tr * 4 + i) * NS + tc + 16 * c;
        *hp = *hp * et + u[i][c];
      }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i % N;
    h_out[(((size_t)b * H + hh) * P + p) * N + n] = sh[p * NS + n];
  }
}

template <typename T, int N>
int launch(const void* xdt, const void* la, const void* b_in,
           const void* c_in, void* y, void* h_out, int B, int S, int H,
           int chunk, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, N>;
  const size_t smem = sizeof(float) * (Layout<N>::FIXED + 2 * (size_t)chunk);
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const float*>(la),
      static_cast<const T*>(b_in), static_cast<const T*>(c_in),
      static_cast<float*>(y), static_cast<float*>(h_out), S, H, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const void* xdt, const void* la, const void* b_in,
               const void* c_in, void* y, void* h_out, int B, int S, int H,
               int N, int chunk, cudaStream_t stream) {
  if (N == 64)
    return launch<T, 64>(xdt, la, b_in, c_in, y, h_out, B, S, H, chunk,
                         stream);
  if (N == 128)
    return launch<T, 128>(xdt, la, b_in, c_in, y, h_out, B, S, H, chunk,
                          stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xdt (B, S, H, P), la (B, S, H) float32, b_in / c_in (B, S, N) -> y
// (B, S, H, P) float32, h (B, H, P, N) float32.  xdt, b_in and c_in share
// one dtype (0 = float32, 1 = bfloat16); P must be 64 and N 64 or 128;
// S a multiple of chunk.  Returns a cudaError_t.
extern "C" int imagine_ssd_scan(const void* xdt, const void* la,
                                const void* b_in, const void* c_in, void* y,
                                void* h_out, int B, int S, int H, int Pdim,
                                int N, int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Pdim != P || chunk <= 0 ||
      S % chunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(xdt, la, b_in, c_in, y, h_out, B, S, H, N,
                             chunk, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(xdt, la, b_in, c_in, y, h_out, B, S, H,
                                     N, chunk, s);
  return (int)cudaErrorInvalidValue;
}
