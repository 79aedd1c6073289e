// Mamba2 SSD chunked scan for Hopper: chunk-parallel passes on tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py (`_kernel`,
// launched by `ssd_scan_pallas`).
//
// Inputs (the kernel's pre-discretised form, kernel.py:66-75): xdt
// (B, S, H, P) = x * dt, la (B, S, H) = dt * A (float32, <= 0), b_in and
// c_in (B, S, N); xdt, b_in and c_in are all float32 or all bfloat16.
// Outputs, both float32: y (B, S, H, P) and the final state h (B, H, P, N),
// from a zero initial state.  P = 64 (the model's ssm_head_dim); N in
// {64, 128}.
//
// Within a chunk of L steps, with cum the inclusive cumulative sum of la
// and total = cum[L - 1] (kernel.py:34-60):
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j   (intra)
//        + exp(cum_i) (C_i . h)                                (inter)
//   h'   = h exp(total) + S,  S = sum_j exp(total - cum_j) xdt_j (x) B_j
// with h the state entering the chunk.  The TPU walks the chunks of a
// (lane, head) in order in one grid row.  Here three kernels, launched one
// after the other by the one C entry point, run the chunks in parallel:
//   1. `ssd_chunk_state_kernel`, grid (head, chunk, lane): cum by warp
//      shuffles, then the chunk's own update S (P x N) = (w xdt)^T B with
//      w_j = exp(total - cum_j), into float32 scratch (B, nc, H, P, N), and
//      total into (B, nc, H);
//   2. `ssd_state_scan_kernel`, grid (P N / 1024, head, lane): over the
//      chunks in order, h_c = h_{c-1} exp(total_c) + S_c, four state
//      entries a thread; it writes the state entering each chunk over S
//      and the final state to h;
//   3. the outputs: the inter term from the entering state, then the
//      intra term on and under the diagonal, one head a block.  bf16
//      inputs: `ssd_output_wgmma_kernel`, grid (row half x head, chunk,
//      lane), a warpgroup on wgmma for the 64-row tiles u and 3 - u of a
//      chunk.  float32 inputs: `ssd_output_kernel`, grid (row half x head,
//      chunk, lane), 8 warps on mma.sync for 128 rows.  C B^T does not
//      depend on the head, but forming it once for two heads of a block
//      was slower on the H100 than forming it per head (PERF.md).
//
// What bounds it on an H100: at the `ssm` shape (B 4, S 4096, H 24, P 64,
// N 128, chunk 256, bf16) the inputs and outputs are 164 MB (0.049 ms at
// 3.35 TB/s) and the products ~20 GFLOP (0.020 ms on bf16 tensor cores),
// so it is bound by bytes; the scratch adds 50 MB written by pass 1 and
// read and written by pass 2 and read by pass 3.  In practice the passes
// are bound by latency: each block waits on its copies and on its chains
// of tensor-core products, with few blocks a multiprocessor (PERF.md).
//
// Products on the tensor cores (mma.sync m16n8k16; wgmma m64n64k16 in the
// bf16 output pass), with float32 sums:
//   * C B^T has exact bf16 operands (bf16 inputs);
//   * the float32 operands (the decayed C B^T tile, the entering state h,
//     the decay-weighted xdt of the state update) are each split into bf16
//     hi + lo (lo = bf16(v - hi), 16 bits of v), and each product is two
//     mmas, hi and then lo: a single bf16 rounding would miss the
//     tolerance against the float64 recurrence (tests/test_torch_ssd_scan.py
//     models this arithmetic on the CPU);
//   * float32 inputs (a test route) split C, B and xdt too, and a product
//     of two split operands is three mmas (hi hi, lo hi, hi lo).
// For mma.sync, operands are staged in shared memory as bf16 rows padded by
// 16 bytes (so the 8 rows of one ldmatrix fall in 8 bank groups) and read
// by ldmatrix, with .trans where the contraction runs along a tile's rows;
// bf16 rows are copied as they are by cp.async, into rings of tiles whose
// next tile is in flight while this one's products run.  The mma.sync
// output pass holds its 128 rows of C and streams B and xdt in tiles of 32
// steps up to its last row; warp w owns the row tile w of its half, tiles
// above the diagonal are skipped.  S and that pass's y go out through
// shared memory, so that a warp's stores are runs of 512 bytes.
// The head is the fastest grid index of passes 1 and 3: the blocks in
// flight read neighbouring 128-byte pieces of the same xdt rows (one head
// each) and share the chunk's B and C rows in L2.  Steps past the end of a
// chunk (chunks that are not a multiple of 16, or a shorter last chunk) are
// zero rows, masked by index.
//
// The launcher allocates the scratch with torch.empty and sizes every grid
// from the shapes: no host sync, nothing read back.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"
#include "tc_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tc::mma;
using tc::smem_u32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int P = 64;            // head width
constexpr int MAX_CHUNK = 256;   // steps of a chunk (one per thread in cum)
constexpr int JT = 64;           // steps of a pass-1 xdt / B tile
constexpr int XS = P + 8;        // padded row of a P-wide bf16 tile
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Two floats as a bf16 pair (x in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// What is left of (x, y) after their bf16 pair `hi`, as a bf16 pair (the
// differences are exact in float32).
__device__ __forceinline__ uint32_t pack_rest(float x, float y,
                                              uint32_t hi) {
  return pack(x - __uint_as_float(hi << 16),
              y - __uint_as_float(hi & 0xFFFF0000u));
}

// 8 consecutive float32 elements (32-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

struct NoScale {
  __device__ float operator()(int) const { return 1.f; }
};

// The state update's weights w_j = exp(total - cum_j), for tile rows from
// `w`.
struct Weights {
  const float* w;
  __device__ float operator()(int r) const { return w[r]; }
};

// Rows [0, rows) of W float32 elements of `src` (row r at src + r * ld),
// times scale(r), into the bf16 tiles `hi` and `lo` (what is left after
// hi) with rows of W + 8; rows at or past `valid` are zeros.  Four groups
// of 8 elements a thread are loaded before any is stored.
template <int W, typename Scale>
__device__ __forceinline__ void stage(bf16* hi, bf16* lo, const float* src,
                                      size_t ld, int rows, int valid,
                                      Scale scale) {
  constexpr int G = W / 8;
  constexpr int BATCH = 4;
  const int total = rows * G;
  for (int base = threadIdx.x; base < total; base += THREADS * BATCH) {
    float v[BATCH][8];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * THREADS;
      const int r = i / G, q = i % G;
      if (i < total && r < valid) {
        load8(src + r * ld + 8 * q, v[u]);
        const float s = scale(r);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] *= s;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * THREADS;
      if (i >= total) break;
      const int off = (i / G) * (W + 8) + 8 * (i % G);
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = pack(v[u][2 * e], v[u][2 * e + 1]);
        l[e] = pack_rest(v[u][2 * e], v[u][2 * e + 1], h[e]);
      }
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// Inclusive cumulative sum of la over the chunk's `len` steps (la[t * H]
// for step t) into cum[0 .. MAX_CHUNK), by a block of NT threads, each
// taking steps t, t + NT, ...: each run of 32 steps is scanned by warp
// shuffles, then gets the totals of the runs before it added in order
// (wsum holds the MAX_CHUNK / 32 run totals); steps past len add 0.  The
// caller syncs before reading cum.
template <int NT>
__device__ __forceinline__ void chunk_cum(const float* __restrict__ la,
                                          int H, int len, float* cum,
                                          float* wsum) {
  constexpr int ROUNDS = MAX_CHUNK / NT;
  const int lane = threadIdx.x & 31;
  float v[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int t = threadIdx.x + NT * k;
    v[k] = t < len ? la[(size_t)t * H] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, v[k], off);
      if (lane >= off) v[k] += u;
    }
    if (lane == 31) wsum[t >> 5] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int t = threadIdx.x + NT * k;
    float pre = 0.f;
    for (int w = 0; w < (t >> 5); ++w) pre += wsum[w];
    cum[t] = pre + v[k];
  }
}

// Rows [0, rows) of W bf16 elements of `src` (row r at src + r * ld) into
// the tile `dst` with rows of W + 8, by 16-byte cp.async; rows at or past
// `valid` are zero-filled.  The caller commits and waits.
template <int W>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          size_t ld, int rows, int valid) {
  constexpr int G = W / 8;
  for (int i = threadIdx.x; i < rows * G; i += THREADS) {
    const int r = i / G, q = i % G;
    const bool ok = r < valid;
    tc::cp_async<16>(smem_u32(dst + r * (W + 8) + 8 * q),
                     ok ? src + r * ld + 8 * q : src, ok);
  }
}

// ------------------------------------------------ pass 1: chunk states
// S (P x N) = sum_j (w_j xdt_j) (x) B_j for one (chunk, head, lane):
// A = (w xdt)^T (16 p x 16 j) split hi + lo, B = B_j (16 j x 8 n); warp w
// owns p rows 16 (w % 4) .. and the n half (w / 4).
//
// Shared memory in bytes: cum, the weights w and the warp totals, then a
// ring of STAGES buffers of a JT-step tile: for bfloat16 inputs xdt
// [JT][XS] and B [JT][N + 8] as they are, copied by cp.async (STAGES - 1
// tiles in flight while one tile's products run) and weighted when the A
// fragments are formed; for float32 inputs w xdt and B as bf16 hi and lo,
// staged through registers.
template <bool F32, int N>
struct StateLayout {
  static constexpr int BS = N + 8;
  static constexpr int SPLITS = F32 ? 2 : 1;
  static constexpr size_t STATS = sizeof(float) * (2 * MAX_CHUNK + WARPS);
  static constexpr int STAGES = 2;
  static constexpr int T_ELEMS = SPLITS * (JT * XS + JT * BS);
  static constexpr size_t BYTES = STATS + 2 * STAGES * (size_t)T_ELEMS;
  static_assert(2 * STAGES * T_ELEMS >= 4 * P * (N + 8),
                "S is staged over the tiles");
};

// The A fragment (16 p x 16 j) of k step kk of the raw [j][p] xdt tile,
// each element times its w_j (w: the tile's weights), as bf16 hi and lo.
// a[0] / a[1] hold j 2t, 2t + 1 (p rows g, g + 8), a[2] / a[3] j 2t + 8,
// 2t + 9.
__device__ __forceinline__ void weighted_a(const bf16* xs, const float* w,
                                           int kk, int p0, int lane,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const int q = lane >> 3, r = lane & 7, t = lane & 3;
  uint32_t raw[4];
  ldsm_t(smem_u32(xs + (16 * kk + r + 8 * (q >> 1)) * XS + p0 + 8 * (q & 1)),
         raw);
  const int j = 16 * kk + 2 * t;
  const float wl[2] = {w[j], w[j + 8]}, wh[2] = {w[j + 1], w[j + 9]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = __uint_as_float(raw[i] << 16) * wl[i >> 1];
    const float x1 = __uint_as_float(raw[i] & 0xFFFF0000u) * wh[i >> 1];
    hi[i] = pack(x0, x1);
    lo[i] = pack_rest(x0, x1, hi[i]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS,
                                  std::is_same<T, float>::value ? 1 : 3)
ssd_chunk_state_kernel(const T* __restrict__ xdt, const float* __restrict__ la,
                       const T* __restrict__ b_in, float* __restrict__ st,
                       float* __restrict__ tot, int S, int H, int L) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using Lay = StateLayout<F32, N>;
  constexpr int BS = Lay::BS;
  constexpr int NT = N / 16;         // n tiles of 8 a warp
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  float* cum = reinterpret_cast<float*>(ssd_smem);   // [MAX_CHUNK]
  float* wgt = cum + MAX_CHUNK;                       // [MAX_CHUNK]
  float* wsum = wgt + MAX_CHUNK;                      // [WARPS]
  bf16* tiles = reinterpret_cast<bf16*>(ssd_smem + Lay::STATS);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int c0 = c * L, len = min(L, S - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, r = lane & 7;
  const T* xsrc = xdt + (((size_t)b * S + c0) * H + h) * P;  // step j: + j H P
  const T* bsrc = b_in + ((size_t)b * S + c0) * N;
  constexpr int STAGES = Lay::STAGES;
  const int njt = (len + JT - 1) / JT;
  // buffer jt % STAGES: x (hi[, lo]) [JT][XS], then B (hi[, lo]) [JT][BS]
  auto tile_at = [&](int jt) { return tiles + (jt % STAGES) * Lay::T_ELEMS; };
  // tile jt into its buffer; one cp.async group a call, empty past njt
  auto fetch = [&](int jt) {
    const int j0 = jt * JT;
    if (jt >= njt) {
      tc::cp_async_commit();
      return;
    }
    bf16* xt = tile_at(jt);
    bf16* bt = xt + Lay::SPLITS * JT * XS;
    if constexpr (F32) {
      stage<P>(xt, xt + JT * XS, xsrc + (size_t)j0 * H * P,
                     (size_t)H * P, JT, len - j0, Weights{wgt + j0});
      stage<N>(bt, bt + JT * BS, bsrc + (size_t)j0 * N, (size_t)N, JT,
                     len - j0, NoScale{});
    } else {
      copy_rows<P>(xt, xsrc + (size_t)j0 * H * P, (size_t)H * P, JT,
                   len - j0);
      copy_rows<N>(bt, bsrc + (size_t)j0 * N, (size_t)N, JT, len - j0);
      tc::cp_async_commit();
    }
  };
  if constexpr (!F32) {              // in flight while cum is formed
    for (int jt = 0; jt < STAGES - 1; ++jt) fetch(jt);
  }
  chunk_cum<THREADS>(la + ((size_t)b * S + c0) * H + h, H, len, cum, wsum);
  __syncthreads();
  const float total = cum[len - 1];
  for (int j = threadIdx.x; j < MAX_CHUNK; j += THREADS) {
    wgt[j] = j < len ? expf(total - cum[j]) : 0.f;
  }
  __syncthreads();
  if constexpr (F32) {               // weighted as they are staged
    for (int jt = 0; jt < STAGES - 1; ++jt) fetch(jt);
  }

  const int p0 = 16 * (warp & 3), n0 = (N / 2) * (warp >> 2);
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  for (int jt = 0; jt < njt; ++jt) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile jt has landed; tile jt - 1's readers are done
    fetch(jt + STAGES - 1);            // into tile jt - 1's buffer
    const bf16* xt = tile_at(jt);
    const bf16* bt = xt + Lay::SPLITS * JT * XS;
    const int j0 = jt * JT;
    const int steps = (min(JT, len - j0) + 15) / 16;
    for (int kk = 0; kk < steps; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (F32) {
        const int aoff = (16 * kk + r + 8 * (q >> 1)) * XS + p0 + 8 * (q & 1);
        ldsm_t(smem_u32(xt + aoff), ah);
        ldsm_t(smem_u32(xt + JT * XS + aoff), al);
      } else {
        weighted_a(xt, wgt + j0, kk, p0, lane, ah, al);
      }
      const int brow = 16 * kk + r + 8 * (q & 1);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // B (j x n) from the [j][n] tile: ldmatrix.trans, n tiles nt, nt + 1
        const int boff = brow * BS + n0 + 8 * nt + 8 * (q >> 1);
        uint32_t bb[4];
        ldsm_t(smem_u32(bt + boff), bb);
        mma(acc[nt], ah, bb[0], bb[1]);
        mma(acc[nt + 1], ah, bb[2], bb[3]);
        mma(acc[nt], al, bb[0], bb[1]);
        mma(acc[nt + 1], al, bb[2], bb[3]);
        if constexpr (F32) {
          ldsm_t(smem_u32(bt + JT * BS + boff), bb);
          mma(acc[nt], ah, bb[0], bb[1]);
          mma(acc[nt + 1], ah, bb[2], bb[3]);
        }
      }
    }
  }
  // S through shared memory ([P][N + 8] floats over the tiles), then to
  // the scratch in 16-byte pieces, a warp's stores one run of 512 bytes
  tc::cp_async_wait<0>();
  __syncthreads();   // every tile's readers are done
  float* so = reinterpret_cast<float*>(tiles);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(so + (p0 + g) * (N + 8) + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(so + (p0 + g + 8) * (N + 8) + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(
      st + (((size_t)b * nc + c) * H + h) * P * N);
  for (int i = threadIdx.x; i < P * N / 4; i += THREADS) {
    const int row = i / (N / 4), c4 = i % (N / 4);
    dst[i] = *reinterpret_cast<const float4*>(so + row * (N + 8) + 4 * c4);
  }
  if (threadIdx.x == 0) tot[((size_t)b * nc + c) * H + h] = total;
}

// ---------------------------------------------- pass 2: inter-chunk scan
// For one (lane, head), four state entries a thread: over the chunks in
// order, the state entering chunk c as bf16 hi and lo planes (the operand
// pass 3 copies as it is), then h = h exp(total_c) + S_c; the next chunk's
// S is loaded before this one's stores.  enter is (B, nc, H, 2, P, N).
template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_state_scan_kernel(const float* __restrict__ st,
                      const float* __restrict__ tot,
                      bf16* __restrict__ enter, float* __restrict__ h_out,
                      int H, int nc) {
  constexpr int Q = P * N / 4;       // float4 entries of a state
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const size_t first = (size_t)b * nc * H + h;   // (b, chunk 0, h)
  const float4* slab = reinterpret_cast<const float4*>(st) + first * Q + e;
  uint2* hi = reinterpret_cast<uint2*>(enter) + first * 2 * Q + e;
  const size_t cs = (size_t)H * Q;   // float4s from chunk c to c + 1
  const float* tt = tot + first;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 next = slab[0];
  for (int c = 0; c < nc; ++c) {
    const float4 s = next;
    if (c + 1 < nc) next = slab[(c + 1) * cs];
    const float d = expf(tt[(size_t)c * H]);
    const uint2 vh = make_uint2(pack(acc.x, acc.y), pack(acc.z, acc.w));
    hi[c * 2 * cs] = vh;
    hi[c * 2 * cs + Q] = make_uint2(pack_rest(acc.x, acc.y, vh.x),
                                    pack_rest(acc.z, acc.w, vh.y));
    acc = make_float4(fmaf(acc.x, d, s.x), fmaf(acc.y, d, s.y),
                      fmaf(acc.z, d, s.z), fmaf(acc.w, d, s.w));
  }
  reinterpret_cast<float4*>(h_out)[((size_t)b * H + h) * Q + e] = acc;
}

// ---------------------------------------- pass 3 on mma.sync: outputs
// float32 inputs (a test route): C, B and xdt are split into bf16 hi + lo
// as they are staged, through registers.
constexpr int JO = 32;             // steps of a pass-3 B / xdt tile
constexpr int ROWS = 16 * WARPS;   // rows of a chunk a pass-3 block takes

// Shared memory of pass 3 in bytes: cum and the warp totals; the block's
// C rows [ROWS][N + 8] as hi and lo; then one region that holds the
// entering state (hi + lo, [P][N + 8]) for the inter term and afterwards a
// ring of two buffers of a JO-step B tile [JO][N + 8] and xdt tile
// [JO][XS], each hi and lo, for the intra term; at the end y
// ([ROWS][P + 8] floats) over all of it but the statistics.
template <int N>
struct OutLayout {
  static constexpr int CS = N + 8;
  static constexpr int STAGES = 2;
  static constexpr size_t STATS = sizeof(float) * (MAX_CHUNK + WARPS);
  static constexpr size_t C_BYTES = 2 * 2 * (size_t)ROWS * CS;
  static constexpr size_t H_BYTES = 2 * 2 * (size_t)P * CS;
  static constexpr int J_ELEMS = 2 * (JO * CS + JO * XS);
  static constexpr size_t RING = 2 * (size_t)STAGES * J_ELEMS;
  static constexpr size_t WORK = C_BYTES + (H_BYTES > RING ? H_BYTES : RING);
  static constexpr size_t Y_BYTES = 4 * (size_t)ROWS * (P + 8);
  static constexpr size_t BYTES = STATS + (WORK > Y_BYTES ? WORK : Y_BYTES);
};

// y for head h and rows [ROWS u, ROWS (u + 1)) of one (chunk, lane): warp
// w owns the row tile 8 u + w.  The two row halves of a chunk are
// neighbouring blocks, so the second reads the entering state and the
// B / xdt tiles from L2.
template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_output_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                  const float* __restrict__ b_in,
                  const float* __restrict__ c_in,
                  const bf16* __restrict__ enter, float* __restrict__ y,
                  int S, int H, int L) {
  using Lay = OutLayout<N>;
  constexpr int CS = Lay::CS;
  constexpr int KS = N / 16;         // k steps over the state
  constexpr int STAGES = Lay::STAGES;
  constexpr int HALVES = MAX_CHUNK / ROWS;
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int u = blockIdx.x % HALVES, h = blockIdx.x / HALVES;
  const int c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int c0 = c * L, len = min(L, S - c0);
  const int r0 = ROWS * u;           // the block's first row
  if (r0 >= len) return;             // a chunk of at most ROWS steps
  const int lp = (len + 15) / 16 * 16;
  const int rows = min(ROWS, lp - r0);
  float* cum = reinterpret_cast<float*>(ssd_smem);    // [MAX_CHUNK]
  float* wsum = cum + MAX_CHUNK;                       // [WARPS]
  bf16* ch = reinterpret_cast<bf16*>(ssd_smem + Lay::STATS);  // [ROWS][CS]
  bf16* cl = ch + ROWS * CS;                           // [ROWS][CS]
  bf16* region = cl + ROWS * CS;
  bf16* hh = region;                                   // [P][CS]
  bf16* hl = hh + P * CS;                              // [P][CS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, r = lane & 7, g = lane >> 2, t = lane & 3;
  const int rt = r0 / 16 + warp;     // the warp's row tile in the chunk
  const bool live = 16 * rt < len;
  const float* csrc = c_in + ((size_t)b * S + c0 + r0) * N;
  const float* bsrc = b_in + ((size_t)b * S + c0) * N;
  const float* xsrc = xdt + (((size_t)b * S + c0) * H + h) * P;  // + j H P
  stage<N>(ch, cl, csrc, (size_t)N, rows, len - r0, NoScale{});
  chunk_cum<THREADS>(la + ((size_t)b * S + c0) * H + h, H, len, cum, wsum);
  cum[threadIdx.x] *= LOG2E;         // exp(a - b) = 2^(a' - b')
  const bool inter = c > 0;          // the first chunk enters a zero state
  if (inter) {
    const bf16* e = enter + (((size_t)b * nc + c) * H + h) * 2 * P * N;
    copy_rows<N>(hh, e, (size_t)N, P, P);
    copy_rows<N>(hl, e + P * N, (size_t)N, P, P);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // A fragments of the warp's rows of C at k step ks, hi and lo
  auto c_frag = [&](int ks, uint32_t (&a)[4], uint32_t (&alo)[4]) {
    const int aoff = (16 * warp + r + 8 * (q & 1)) * CS + 16 * ks +
                     8 * (q >> 1);
    ldsm(smem_u32(ch + aoff), a);
    ldsm(smem_u32(cl + aoff), alo);
  };
  float acc[P / 8][4];
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
  }

  // inter: acc = exp(cum_i) (C_i . h), C (i x n) as A, h [p][n] as B
  if (inter && live) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4], alo[4];
      c_frag(ks, a, alo);
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        const int boff = (16 * pp + r + 8 * (q >> 1)) * CS + 16 * ks +
                         8 * (q & 1);
        uint32_t bhi[4], blo[4];
        ldsm(smem_u32(hh + boff), bhi);
        ldsm(smem_u32(hl + boff), blo);
        float(&d0)[4] = acc[2 * pp];
        float(&d1)[4] = acc[2 * pp + 1];
        mma(d0, a, bhi[0], bhi[1]);
        mma(d1, a, bhi[2], bhi[3]);
        mma(d0, a, blo[0], blo[1]);
        mma(d1, a, blo[2], blo[3]);
        mma(d0, alo, bhi[0], bhi[1]);
        mma(d1, alo, bhi[2], bhi[3]);
      }
    }
    const int i0 = 16 * rt + g;
    const float e0 = exp2f(cum[i0]), e1 = exp2f(cum[i0 + 8]);
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      acc[pt][0] *= e0;
      acc[pt][1] *= e0;
      acc[pt][2] *= e1;
      acc[pt][3] *= e1;
    }
  }

  // intra: B / xdt tiles of JO steps up to the block's last row, the next
  // staged before this one's products run; every 16 x 16 tile of C B^T on
  // or under the diagonal, decayed and split, times xdt
  const int jmax = min(len, r0 + ROWS);
  const int njt = (jmax + JO - 1) / JO;
  // buffer jt % STAGES: B hi, B lo [JO][CS], then xdt hi, xdt lo [JO][XS]
  auto tile_at = [&](int jt) { return region + (jt % STAGES) * Lay::J_ELEMS; };
  auto fetch = [&](int jt) {
    if (jt >= njt) return;
    const int j0 = jt * JO;
    bf16* bh = tile_at(jt);
    bf16* xh = bh + 2 * JO * CS;
    stage<N>(bh, bh + JO * CS, bsrc + (size_t)j0 * N, (size_t)N, JO,
             len - j0, NoScale{});
    stage<P>(xh, xh + JO * XS, xsrc + (size_t)j0 * H * P, (size_t)H * P, JO,
             len - j0, NoScale{});
  };
  __syncthreads();   // the entering state's readers are done
  fetch(0);
  for (int jt = 0; jt < njt; ++jt) {
    __syncthreads();   // tile jt is staged; tile jt - 1's readers are done
    fetch(jt + 1);                     // into tile jt - 1's buffer
    const bf16* bh = tile_at(jt);
    const bf16* bl = bh + JO * CS;
    const bf16* xh = bl + JO * CS;
    const bf16* xl = xh + JO * XS;
    const int j0 = jt * JO;
    const int jb0 = j0 / 16, jb1 = jb0 + (min(JO, len - j0) + 15) / 16;
    if (!live || rt < jb0) continue;
    const int jend = min(jb1, rt + 1);
    for (int jb = jb0; jb < jend; ++jb) {
      const int jr = 16 * (jb - jb0);  // the column tile's first row
      float gg[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) gg[i][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int boff = (jr + r + 8 * (q >> 1)) * CS + 16 * ks + 8 * (q & 1);
        uint32_t a[4], alo[4], bb[4], blo[4];
        c_frag(ks, a, alo);
        ldsm(smem_u32(bh + boff), bb);
        ldsm(smem_u32(bl + boff), blo);
        mma(gg[0], a, bb[0], bb[1]);
        mma(gg[1], a, bb[2], bb[3]);
        mma(gg[0], alo, bb[0], bb[1]);
        mma(gg[1], alo, bb[2], bb[3]);
        mma(gg[0], a, blo[0], blo[1]);
        mma(gg[1], a, blo[2], blo[3]);
      }
      const int i0 = 16 * rt + g;
      const int jj = 16 * jb + 2 * t;  // columns jj, +1, +8, +9
      const float ci[2] = {cum[i0], cum[i0 + 8]};
      const float cj[4] = {cum[jj], cum[jj + 1], cum[jj + 8], cum[jj + 9]};
      float d[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jj + 8 * i + (e & 1), row = i0 + 8 * (e >> 1);
          d[i][e] = j <= row
                        ? gg[i][e] * exp2f(ci[e >> 1] - cj[2 * i + (e & 1)])
                        : 0.f;
        }
      }
      // the decayed tile as the A fragment of the next product: hi, lo
      uint32_t ghi[4], glo[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ghi[2 * i] = pack(d[i][0], d[i][1]);
        ghi[2 * i + 1] = pack(d[i][2], d[i][3]);
        glo[2 * i] = pack_rest(d[i][0], d[i][1], ghi[2 * i]);
        glo[2 * i + 1] = pack_rest(d[i][2], d[i][3], ghi[2 * i + 1]);
      }
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        const int xoff = (jr + r + 8 * (q & 1)) * XS + 16 * pp +
                         8 * (q >> 1);
        uint32_t xb[4];
        ldsm_t(smem_u32(xh + xoff), xb);
        float(&d0)[4] = acc[2 * pp];
        float(&d1)[4] = acc[2 * pp + 1];
        mma(d0, ghi, xb[0], xb[1]);
        mma(d1, ghi, xb[2], xb[3]);
        mma(d0, glo, xb[0], xb[1]);
        mma(d1, glo, xb[2], xb[3]);
        ldsm_t(smem_u32(xl + xoff), xb);
        mma(d0, ghi, xb[0], xb[1]);
        mma(d1, ghi, xb[2], xb[3]);
      }
    }
  }

  // y through shared memory ([ROWS][P + 8] floats over C and the region),
  // then to y in 16-byte pieces
  constexpr int YS = P + 8;
  __syncthreads();   // every tile's readers are done
  float* yo = reinterpret_cast<float*>(ch);
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt) {
    float* at = yo + (16 * warp + g) * YS + 8 * pt + 2 * t;
    *reinterpret_cast<float2*>(at) = make_float2(acc[pt][0], acc[pt][1]);
    *reinterpret_cast<float2*>(at + 8 * YS) =
        make_float2(acc[pt][2], acc[pt][3]);
  }
  __syncthreads();
  const int out_rows = min(ROWS, len - r0);
  for (int i = threadIdx.x; i < out_rows * P / 4; i += THREADS) {
    const int row = i / (P / 4), c4 = i % (P / 4);
    *reinterpret_cast<float4*>(
        y + (((size_t)b * S + c0 + r0 + row) * H + h) * P + 4 * c4) =
        *reinterpret_cast<const float4*>(yo + row * YS + 4 * c4);
  }
}

// ------------------------------------- pass 3 on wgmma (bf16 inputs)
// One warpgroup (128 threads) per (row half u, head, chunk, lane):
// it owns the 64-row tiles u and 3 - u of the chunk, so both halves take
// five 64 x 64 tiles of C B^T on or under the diagonal.  Its C rows and
// the entering state (hi, lo) are copied into shared memory in wgmma's
// swizzled layout (tc_attention.cuh `Swz`); first y = exp(cum_i) (C h_hi^T
// + C h_lo^T) for both row tiles, then the B and xdt tiles of 64 steps
// stream through a ring of WG_STAGES buffers over the states' area, and
// for each row tile that reaches a key tile S = C B^T (wgmma from shared
// memory), the decay and on the diagonal the mask on the accumulator, and
// y += (S_hi + S_lo) xdt with the split tile as the A operand in registers
// (tca::p_frags), as flash attention's P V.  wgmma reads each operand tile
// once for 64 rows, where mma.sync's ldmatrix reads it once for 16; two
// blocks share a multiprocessor.  The SSD_ABLATE_* switches (set only by
// ssd_ablation.py, never by the package's build) leave one part of this
// pass out, so that its time can be read; the result is then wrong.
constexpr int WG = 128;            // threads of a warpgroup
constexpr int WG_ROWS = 64;        // rows of a row tile, steps of a key tile
constexpr int WG_TILES = MAX_CHUNK / WG_ROWS;
constexpr int WG_STAGES = 3;

// Shared memory: 1024 bytes of alignment slack; C [2][64][N]; one region
// that holds h hi and lo [64][N] and then the ring of WG_STAGES buffers of
// B [64][N] and xdt [64][P], all bf16 in `Swz` tiles; then cum (log2 e
// scaled) and the warp totals.
template <int N>
struct WgLayout {
  static constexpr int TN = tca::Swz<N>::TILE_BYTES;
  static constexpr int TP = tca::Swz<P>::TILE_BYTES;
  static constexpr int STAGE = TN + TP;
  static constexpr int C0 = 0;
  static constexpr int R0 = C0 + 2 * TN;
  static constexpr int REGION = WG_STAGES * STAGE > 2 * TN
                                    ? WG_STAGES * STAGE : 2 * TN;
  static constexpr int STATS = R0 + REGION;
  static constexpr size_t BYTES =
      1024 + STATS + sizeof(float) * (MAX_CHUNK + WARPS);
};

// Rows [0, 64) of W bf16 elements of `src` (row r at src + r * ld) into the
// `Swz` tile at `dst` by 16-byte cp.async, a warpgroup's threads; rows at
// or past `valid` zeros.
template <int W>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src,
                                          size_t ld, int valid) {
  using Sw = tca::Swz<W>;
  for (int i = threadIdx.x; i < WG_ROWS * Sw::CH; i += WG) {
    const int r = i / Sw::CH, c = i % Sw::CH;
    const bool ok = r < valid;
    tc::cp_async<16>(dst + Sw::off(r, c), ok ? src + r * ld + 8 * c : src,
                     ok);
  }
}

template <int N>
__global__ void __launch_bounds__(WG, 2)
ssd_output_wgmma_kernel(const bf16* __restrict__ xdt,
                        const float* __restrict__ la,
                        const bf16* __restrict__ b_in,
                        const bf16* __restrict__ c_in,
                        const bf16* __restrict__ enter, float* __restrict__ y,
                        int S, int H, int L) {
  using Lay = WgLayout<N>;
  extern __shared__ __align__(128) uint8_t ssd_wg_smem[];
  uint8_t* sm = ssd_wg_smem +
                ((1024 - (tc::smem_u32(ssd_wg_smem) & 1023)) & 1023);
  const uint32_t base = tc::smem_u32(sm);
  float* cum = reinterpret_cast<float*>(sm + Lay::STATS);   // [MAX_CHUNK]
  float* wsum = cum + MAX_CHUNK;                             // [WARPS]
  const int u = blockIdx.x & 1, h = blockIdx.x >> 1;
  const int c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int c0 = c * L, len = min(L, S - c0);
  int rt[2] = {u, WG_TILES - 1 - u};         // the block's row tiles
  bool live[2] = {rt[0] * WG_ROWS < len, rt[1] * WG_ROWS < len};
  if (!live[0]) return;                      // a short chunk: nothing here
#ifdef SSD_ABLATE_INTER
  const bool inter = false;
#else
  const bool inter = c > 0;          // the first chunk enters a zero state
#endif
  for (int k = 0; k < 2; ++k) {
    if (!live[k]) continue;
    copy_tile<N>(base + Lay::C0 + k * Lay::TN,
                 c_in + ((size_t)b * S + c0 + rt[k] * WG_ROWS) * N,
                 (size_t)N, len - rt[k] * WG_ROWS);
  }
  if (inter) {
    const bf16* e = enter + (((size_t)b * nc + c) * H + h) * 2 * P * N;
    copy_tile<N>(base + Lay::R0, e, (size_t)N, P);
    copy_tile<N>(base + Lay::R0 + Lay::TN, e + P * N, (size_t)N, P);
  }
  tc::cp_async_commit();
  chunk_cum<WG>(la + ((size_t)b * S + c0) * H + h, H, len, cum, wsum);
  for (int t = threadIdx.x; t < MAX_CHUNK; t += WG) {
    cum[t] *= LOG2E;                 // exp(a - b) = 2^(a' - b')
  }
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();           // the copies are visible to wgmma
  __syncthreads();

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  float acc[2][P / 8][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][j][e] = 0.f;
    }
  }
  if (inter) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!live[k]) continue;
      const uint32_t ct = base + Lay::C0 + k * Lay::TN;
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        tca::wgmma_ss_n64(acc[k], tca::desc_k<N>(ct, kk),
                          tca::desc_k<N>(base + Lay::R0, kk), kk);
      }
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        tca::wgmma_ss_n64(acc[k], tca::desc_k<N>(ct, kk),
                          tca::desc_k<N>(base + Lay::R0 + Lay::TN, kk), 1);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tca::keep(acc[k]);
      const int i0 = rt[k] * WG_ROWS + 16 * w + g;
      const float e0 = exp2f(cum[i0]), e1 = exp2f(cum[i0 + 8]);
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        acc[k][j][0] *= e0;
        acc[k][j][1] *= e0;
        acc[k][j][2] *= e1;
        acc[k][j][3] *= e1;
      }
    }
  }

  // the B / xdt tiles of 64 steps up to the last live row tile, in a ring
  // over the states' area; one cp.async group a tile, empty past the last
  const int nkt = (live[1] ? rt[1] : rt[0]) + 1;
  auto stage_at = [&](int kt) {
    return base + Lay::R0 + (kt % WG_STAGES) * Lay::STAGE;
  };
  auto fetch = [&](int kt) {
#ifndef SSD_ABLATE_COPY
    if (kt < nkt) {
      const int j0 = kt * WG_ROWS;
      copy_tile<N>(stage_at(kt), b_in + ((size_t)b * S + c0 + j0) * N,
                   (size_t)N, len - j0);
      copy_tile<P>(stage_at(kt) + Lay::TN,
                   xdt + (((size_t)b * S + c0 + j0) * H + h) * P,
                   (size_t)H * P, len - j0);
    }
#endif
    tc::cp_async_commit();
  };
  __syncthreads();   // the states' readers are done
  for (int kt = 0; kt < WG_STAGES - 1; ++kt) fetch(kt);
  for (int kt = 0; kt < nkt; ++kt) {
    tc::cp_async_wait<WG_STAGES - 2>();
    tc::fence_proxy_async();
    __syncthreads();   // tile kt has landed; tile kt - 1's readers are done
    fetch(kt + WG_STAGES - 1);         // into tile kt - 1's buffer
    const uint32_t bt = stage_at(kt), xt = bt + Lay::TN;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!live[k] || rt[k] < kt) continue;
      const uint32_t ct = base + Lay::C0 + k * Lay::TN;
      const int i0 = rt[k] * WG_ROWS + 16 * w + g;     // rows i0, i0 + 8
      float sc[WG_ROWS / 8][4];
#ifdef SSD_ABLATE_G
#pragma unroll
      for (int j = 0; j < WG_ROWS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 1.f;
      }
#else
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        tca::wgmma_ss_n64(sc, tca::desc_k<N>(ct, kk),
                          tca::desc_k<N>(bt, kk), kk);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tca::keep(sc);
#endif
      // the decay, and on the diagonal tile the mask j <= i
      const bool diag = kt == rt[k];
      const float ci[2] = {cum[i0], cum[i0 + 8]};
#pragma unroll
      for (int j = 0; j < WG_ROWS / 8; ++j) {
        const int jc = kt * WG_ROWS + 8 * j + t2;       // columns jc, jc + 1
        const float cj[2] = {cum[jc], cum[jc + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#ifdef SSD_ABLATE_DECAY
          sc[j][e] += 0.f * (ci[e >> 1] + cj[e & 1]);
#else
          const bool on = !diag || jc + (e & 1) <= i0 + 8 * (e >> 1);
          sc[j][e] = on ? sc[j][e] * exp2f(ci[e >> 1] - cj[e & 1]) : 0.f;
#endif
        }
      }
      uint32_t hi[WG_ROWS / 16][4], lo[WG_ROWS / 16][4];
#pragma unroll
      for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
        tca::p_frags<true>(sc, kk, hi[kk], lo[kk]);
      }
#ifdef SSD_ABLATE_PV
      acc[k][0][0] += __uint_as_float((hi[0][0] ^ lo[3][3]) & 0x7fu);
#else
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
        const uint64_t dx = tca::desc_v<P>(xt, kk);
        tca::wgmma_rs_t_n64(acc[k], hi[kk], dx);
        tca::wgmma_rs_t_n64(acc[k], lo[kk], dx);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tca::keep(acc[k]);
#endif
    }
  }

  float* yr = y + (((size_t)b * S + c0) * H + h) * P + t2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!live[k]) continue;
    const int i0 = rt[k] * WG_ROWS + 16 * w + g;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 8 * hh;
        if (i < len) {
          *reinterpret_cast<float2*>(yr + (size_t)i * H * P + 8 * j) =
              make_float2(acc[k][j][2 * hh], acc[k][j][2 * hh + 1]);
        }
      }
    }
  }
}

// Allows `kernel` the card's largest dynamic shared memory, once per
// instantiation; refuses `bytes` above it.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  return 0;
}

// The C entry point's pointers and sizes.
struct Args {
  const void *xdt, *la, *b_in, *c_in;
  void *y, *h_out, *st, *enter, *tot;
  int B, S, H, L;
};

template <typename T, int N>
int launch(const Args& g, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int nc = (g.S + g.L - 1) / g.L;
  const T* x = static_cast<const T*>(g.xdt);
  const float* la = static_cast<const float*>(g.la);
  const T* bi = static_cast<const T*>(g.b_in);
  const T* ci = static_cast<const T*>(g.c_in);
  float* st = static_cast<float*>(g.st);
  bf16* enter = static_cast<bf16*>(g.enter);
  float* tot = static_cast<float*>(g.tot);

  auto k1 = ssd_chunk_state_kernel<T, N>;
  const size_t smem1 = StateLayout<F32, N>::BYTES;
  static bool configured1 = false;
  if (int err = allow_smem(k1, smem1, configured1)) return err;
  k1<<<dim3(g.H, nc, g.B), THREADS, smem1, stream>>>(x, la, bi, st, tot,
                                                      g.S, g.H, g.L);
  if (cudaError_t err = cudaGetLastError()) return (int)err;

  ssd_state_scan_kernel<N><<<dim3(P * N / 4 / THREADS, g.H, g.B), THREADS, 0,
                             stream>>>(st, tot, enter,
                                       static_cast<float*>(g.h_out), g.H, nc);
  if (cudaError_t err = cudaGetLastError()) return (int)err;

  if constexpr (!F32) {
    auto k3 = ssd_output_wgmma_kernel<N>;
    const size_t smem3 = WgLayout<N>::BYTES;
    static bool configured3 = false;
    if (int err = allow_smem(k3, smem3, configured3)) return err;
    k3<<<dim3(2 * g.H, nc, g.B), WG, smem3, stream>>>(
        x, la, bi, ci, enter, static_cast<float*>(g.y), g.S, g.H, g.L);
  } else {
    auto k3 = ssd_output_kernel<N>;
    const size_t smem3 = OutLayout<N>::BYTES;
    static bool configured3 = false;
    if (int err = allow_smem(k3, smem3, configured3)) return err;
    k3<<<dim3(g.H * (MAX_CHUNK / ROWS), nc, g.B), THREADS, smem3, stream>>>(
        x, la, bi, ci, enter, static_cast<float*>(g.y), g.S, g.H, g.L);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const Args& g, int N, cudaStream_t stream) {
  if (N == 64) return launch<T, 64>(g, stream);
  if (N == 128) return launch<T, 128>(g, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xdt (B, S, H, P), la (B, S, H) float32, b_in / c_in (B, S, N) -> y
// (B, S, H, P) float32, h (B, H, P, N) float32, through the scratch st
// (B, nc, H, P, N) and tot (B, nc, H), float32, and enter (B, nc, H, 2, P,
// N) bfloat16, nc = ceil(S / chunk).  xdt, b_in and c_in share one dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned; P must be 64, N 64 or 128,
// chunk 1 .. 256 (the last chunk may be shorter).  Returns a cudaError_t.
extern "C" int imagine_ssd_scan(const void* xdt, const void* la,
                                const void* b_in, const void* c_in, void* y,
                                void* h_out, void* st, void* enter, void* tot,
                                int B, int S, int H, int Pdim, int N,
                                int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Pdim != P || chunk <= 0 ||
      chunk > MAX_CHUNK || B > 65535 || H > 65535 ||
      (S + chunk - 1) / chunk > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Args g{xdt, la, b_in, c_in, y, h_out, st, enter, tot, B, S, H, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_n<float>(g, N, s);
  if (dtype == 1) return dispatch_n<bf16>(g, N, s);
  return (int)cudaErrorInvalidValue;
}
