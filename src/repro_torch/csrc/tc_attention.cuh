// Tensor-core pieces of the port's two attention kernels (sm_90a): the
// online-softmax attention of 64 query rows (16 a warp) against a step of
// BKV keys, bf16 operands and float32 sums.
//
// Included by csrc/flash_attention.cu (route tensor_core: causal GQA
// attention over a whole sequence, on wgmma) and csrc/paged_attention.cu
// (route tensor_core of the chunked prefill, on mma.sync m16n8k16), and by
// csrc/ssd_scan.cu, whose bf16 output pass takes the `Swz` tiles, the
// descriptors, the wgmma wrappers and `p_frags` with C, B and xdt in the
// places of Q, K and V.  Both
// stage K and V in shared memory as bf16 tiles of [key][D] in wgmma's
// swizzled layout (`Swz`), take S = Q K^T on the tensor cores, mask and
// scale S themselves, call `softmax` (the online-softmax step on the
// accumulator fragments), and take O += P V with P from registers
// (`p_frags`): on mma.sync the paged prefill holds its query rows as A
// fragments (`load_q`, `scores`) and reads K and V through ldmatrix (`pv`,
// `update`); flash attention issues wgmma from shared-memory descriptors
// (`desc_k`, `desc_v`, `wgmma_ss_n64`, `wgmma_pv`).
//
// What a warp holds: the D-wide float32 output accumulator and, for rows g
// and g + 8 of the lane's quad (g = lane / 4), the running max m and sum l.
// Head dims are 32, 64, 128 and 256.  At D = 256 the accumulator alone is
// 128 float32 registers a thread (64 rows a warpgroup, or 16 a warp, times
// 256 columns over 128 or 32 threads), so nothing else of that size stays
// in registers beside it: the paged prefill's warps read their Q fragments
// from the query tile in shared memory at each k-step instead of holding
// them (`kQInRegs`), and flash attention issues O += P V one 16-key step
// at a time, so only one step's P fragments are live.
// Accumulator element e of n8 block j is row g + 8 * (e >> 1), column
// 8j + 2t + (e & 1) (t = lane % 4), on mma.sync and on wgmma (whose warp w
// holds rows 16w .. 16w + 15 of the 64): the row statistics are quad
// shuffles, and the score accumulator of keys 16kk .. 16kk + 15 is, element
// for element, the A fragment of P for the k-step kk of P V, so P never
// leaves the registers.
//
// Why two instruction sets: wgmma reads B once for a warpgroup's 64 rows
// where mma.sync's ldmatrix reads it once a warp, which is what flash
// attention's long walks pay for; the paged prefill's blocks take a handful
// of steps and are bound by latency, where mma.sync's 16-row tiles suffice.
//
// Numerics, kept from the TPU kernels and from the CUDA-core routes:
//   * Q K^T multiplies exact bf16 operands and sums them in float32; the
//     caller multiplies the float32 scores by sm_scale (and by the K scale
//     of int8 pools) and sets masked scores to NEG_INF = -1e30, a finite
//     number: a step wholly masked for a row gives exp(0) = 1 there and the
//     next real step wipes it through corr = exp(m_old - m_new);
//   * l accumulates the float32 p before any rounding or V-scale fold;
//   * SPLIT_P (flash attention): the TPU kernel keeps p in float32 for
//     p . v.  A single bf16 p misses the bf16 output's one-ulp tolerance
//     many times over (tests/test_torch_flash_attention.py models both);
//     p = hi + lo with hi = bf16(p), lo = bf16(p - hi) carries 16 bits of
//     p, and the two products against the same exact bf16 V are summed in
//     float32;
//   * one bf16 P (paged prefill): p is rounded to bf16 once, after the V
//     scale of int8 pools (VSCALE) multiplies it, which is the TPU kernel's
//     own cast sequence; an int8 V code is exact in bf16;
//   * the caller's epilogue divides by max(l, 1e-30).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {
namespace tca {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;   // query rows a block
constexpr int BKV = 64;          // keys a step

// A tile of BKV (= BQ) rows of D bf16 in shared memory, in wgmma's
// canonical swizzled layout: D cut into column blocks of ROW_B bytes (64
// elements, 32 at D = 32), each block BKV rows of ROW_B bytes, and in each
// row 16-byte chunk c at chunk c XOR (row / PERIOD) % CPH: the 128-byte
// swizzle (64-byte at D = 32) that wgmma reads from a tile whose base is
// 1024-byte aligned.  The 8 row addresses of one ldmatrix (one chunk of 8
// consecutive rows) fall in 8 distinct bank groups.
template <int D>
struct Swz {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "head dims 32, 64, 128, 256");
  static constexpr int CH = D / 8;                    // chunks a row
  static constexpr int ROW_B = D >= 64 ? 128 : 2 * D;  // bytes a block row
  static constexpr int CPH = ROW_B / 16;              // chunks a block row
  static constexpr int PERIOD = 128 / ROW_B;
  static constexpr int BLOCK = BKV * ROW_B;           // bytes a column block
  static constexpr int TILE_BYTES = BKV * 2 * D;
  static __device__ __forceinline__ int off(int row, int chunk) {
    return (chunk / CPH) * BLOCK + row * ROW_B +
           (((chunk % CPH) ^ ((row / PERIOD) % CPH)) << 4);
  }
};
static_assert(BQ == BKV, "a query tile fits a key tile");

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

using tc::mma;   // m16n8k16, bf16 in, float32 sums (ptx.cuh)

// Two floats as a bf16 pair (x in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// What is left of (x, y) after their bf16 pair `hi`, as a bf16 pair: the
// differences are exact in float32.
__device__ __forceinline__ uint32_t pack_rest(float x, float y,
                                              uint32_t hi) {
  const float hx = __uint_as_float(hi << 16);
  const float hy = __uint_as_float(hi & 0xFFFF0000u);
  return pack(x - hx, y - hy);
}

// Q's A fragments stay in registers up to D = 128 (D / 4 registers a
// thread); at D = 256 they would take 64 beside the accumulator's 128.
template <int D>
constexpr bool kQInRegs = D <= 128;

template <int D>
struct Warp {
  uint32_t q[kQInRegs<D> ? D / 16 : 1][4];   // the warp's 16 query rows,
                                             // A fragments (kQInRegs)
  uint32_t q_tile;         // !kQInRegs: the query tile ...
  int q_row0;              // ... and the warp's first row in it
  float o[D / 8][4];       // the output accumulator
  float m[2], l[2];        // rows g and g + 8: running max and sum
};

// The accumulator and statistics empty.
template <int D>
__device__ __forceinline__ void start(Warp<D>& w) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) w.o[j][e] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    w.m[h] = NEG_INF;
    w.l[h] = 0.f;
  }
}

// The A fragment of k-step kk from rows row0 .. row0 + 15 of a swizzled
// tile.
template <int D>
__device__ __forceinline__ void q_frag(uint32_t tile, int row0, int kk,
                                       int lane, uint32_t (&a)[4]) {
  ldsm_x4(tile + Swz<D>::off(row0 + (lane & 15), 2 * kk + (lane >> 4)), a);
}

// The warp's A fragments from rows row0 .. row0 + 15 of a swizzled tile
// (!kQInRegs: the tile's address, which must then hold them until the
// warp's last `scores`); the accumulator and statistics start empty.
template <int D>
__device__ __forceinline__ void load_q(Warp<D>& w, uint32_t tile, int row0,
                                       int lane) {
  if constexpr (kQInRegs<D>) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag<D>(tile, row0, kk, lane,
                                                  w.q[kk]);
  } else {
    w.q_tile = tile;
    w.q_row0 = row0;
  }
  start(w);
}

// s = Q K^T over the BKV keys of the tile at `kt` (rows are keys): the raw
// float32 dot products, before any scale or mask.
template <int D>
__device__ __forceinline__ void scores(const Warp<D>& w, uint32_t kt,
                                       int lane, float (&s)[BKV / 8][4]) {
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  const int key = (lane & 7) + ((lane >> 4) << 3);
  const int half = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (kQInRegs<D>) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = w.q[kk][i];
    } else {
      q_frag<D>(w.q_tile, w.q_row0, kk, lane, a);
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(kt + Swz<D>::off(8 * j + key, 2 * kk + half), b);
      mma(s[j], a, b[0], b[1]);
      mma(s[j + 1], a, b[2], b[3]);
    }
  }
}

// The online-softmax step on scaled, masked scores s: the running max and
// sum move on, the accumulator is scaled by corr, and s becomes p.
// VSCALE: p is multiplied by the key's V scale `vs[key]` (shared memory)
// after l has taken it.
template <int D, bool VSCALE>
__device__ __forceinline__ void softmax(Warp<D>& w, float (&s)[BKV / 8][4],
                                        const float* vs, int lane) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float corr[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    m_new[h] = fmaxf(w.m[h], mx[h]);
    corr[h] = expf(w.m[h] - m_new[h]);
  }
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - m_new[e >> 1]);
      sum[e >> 1] += p;
      s[j][e] = p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    w.l[h] = w.l[h] * corr[h] + sum[h];
    w.m[h] = m_new[h];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    w.o[j][0] *= corr[0];
    w.o[j][1] *= corr[0];
    w.o[j][2] *= corr[1];
    w.o[j][3] *= corr[1];
  }
  if constexpr (VSCALE) {
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const float v0 = vs[8 * j + t2], v1 = vs[8 * j + t2 + 1];
      s[j][0] *= v0;
      s[j][1] *= v1;
      s[j][2] *= v0;
      s[j][3] *= v1;
    }
  }
}

// P of keys 16kk .. 16kk + 15 as the A fragment of k-step kk: p rounded to
// bf16 (hi) and, SPLIT_P, what is left of p after hi, as bf16 (lo).
template <bool SPLIT_P>
__device__ __forceinline__ void p_frags(const float (&s)[BKV / 8][4], int kk,
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float(&p0)[4] = s[2 * kk];
  const float(&p1)[4] = s[2 * kk + 1];
  hi[0] = pack(p0[0], p0[1]);
  hi[1] = pack(p0[2], p0[3]);
  hi[2] = pack(p1[0], p1[1]);
  hi[3] = pack(p1[2], p1[3]);
  if constexpr (SPLIT_P) {
    lo[0] = pack_rest(p0[0], p0[1], hi[0]);
    lo[1] = pack_rest(p0[2], p0[3], hi[1]);
    lo[2] = pack_rest(p1[0], p1[1], hi[2]);
    lo[3] = pack_rest(p1[2], p1[3], hi[3]);
  }
}

// O += P V on mma.sync, P from s (p, one bf16 operand), V the tile at `vt`
// (rows are keys).
template <int D>
__device__ __forceinline__ void pv(Warp<D>& w, const float (&s)[BKV / 8][4],
                                   uint32_t vt, int lane) {
  const int key = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int half = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    uint32_t hi[4], lo[4];
    p_frags<false>(s, kk, hi, lo);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(vt + Swz<D>::off(16 * kk + key, j + half), b);
      mma(w.o[j], hi, b[0], b[1]);
      mma(w.o[j + 1], hi, b[2], b[3]);
    }
  }
}

// The online-softmax step and O += P V (mma.sync), from scaled, masked
// scores s.
template <int D, bool VSCALE>
__device__ __forceinline__ void update(Warp<D>& w, float (&s)[BKV / 8][4],
                                       uint32_t vt, const float* vs,
                                       int lane) {
  softmax<D, VSCALE>(w, s, vs, lane);
  pv<D>(w, s, vt, lane);
}

// ------------------------------------------------------------ wgmma
// A warpgroup (4 warps) runs the products of its 64 rows as one: warp w
// holds rows 16w .. 16w + 15 of the accumulators in the layout above.

// Shared-memory matrix descriptor of a tile in the layout of `Swz`: start
// address >> 4, leading and stride byte offsets >> 4, the swizzle (1:
// 128-byte, 2: 64-byte).
template <int D>
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, uint32_t lead,
                                          uint32_t stride) {
  constexpr uint64_t layout = Swz<D>::ROW_B == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (layout << 62);
}

// k-step kk (16 columns of D) of a K-major operand (rows x D, the Q or K
// tile): within a column block, 32 bytes a step; 8-row groups ROW_B * 8
// bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using Sw = Swz<D>;
  constexpr int STEPS = Sw::ROW_B / 32;   // k-steps a column block
  return gdesc<D>(tile + (kk / STEPS) * Sw::BLOCK + (kk % STEPS) * 32, 16,
                  8 * Sw::ROW_B);
}

// k-step kk (keys 16kk .. 16kk + 15) of the V tile (keys x D) as an
// MN-major B operand: column blocks BLOCK bytes apart (leading), 8-key
// groups ROW_B * 8 bytes apart (stride).
template <int D>
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int kk) {
  using Sw = Swz<D>;
  return gdesc<D>(tile + kk * 16 * Sw::ROW_B, Sw::BLOCK, 8 * Sw::ROW_B);
}

// d (64 x 64 float32) (+)= A (64 x 16 bf16, K-major in shared memory) @
// B (16 x 64 bf16, K-major in shared memory); d is zeroed first unless
// `accumulate`.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32 float32) += A (64 x 16 bf16, in registers) @ B (16 x 32
// bf16, MN-major in shared memory: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_t_n32(float (&d)[4][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 float32) += A (64 x 16 bf16, in registers) @ B (16 x 64
// bf16, MN-major in shared memory: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_t_n64(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[J0 .. J0 + 15] (64 x 128 float32) += A (64 x 16 bf16, in registers) @
// B (16 x 128 bf16, MN-major in shared memory: the transpose bit set).
template <int J0, int N>
__device__ __forceinline__ void wgmma_rs_t_n128(float (&d)[N][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(J0 + 16 <= N, "128 columns of the accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[J0 + 0][0]), "+f"(d[J0 + 0][1]),
        "+f"(d[J0 + 0][2]), "+f"(d[J0 + 0][3]),
        "+f"(d[J0 + 1][0]), "+f"(d[J0 + 1][1]),
        "+f"(d[J0 + 1][2]), "+f"(d[J0 + 1][3]),
        "+f"(d[J0 + 2][0]), "+f"(d[J0 + 2][1]),
        "+f"(d[J0 + 2][2]), "+f"(d[J0 + 2][3]),
        "+f"(d[J0 + 3][0]), "+f"(d[J0 + 3][1]),
        "+f"(d[J0 + 3][2]), "+f"(d[J0 + 3][3]),
        "+f"(d[J0 + 4][0]), "+f"(d[J0 + 4][1]),
        "+f"(d[J0 + 4][2]), "+f"(d[J0 + 4][3]),
        "+f"(d[J0 + 5][0]), "+f"(d[J0 + 5][1]),
        "+f"(d[J0 + 5][2]), "+f"(d[J0 + 5][3]),
        "+f"(d[J0 + 6][0]), "+f"(d[J0 + 6][1]),
        "+f"(d[J0 + 6][2]), "+f"(d[J0 + 6][3]),
        "+f"(d[J0 + 7][0]), "+f"(d[J0 + 7][1]),
        "+f"(d[J0 + 7][2]), "+f"(d[J0 + 7][3]),
        "+f"(d[J0 + 8][0]), "+f"(d[J0 + 8][1]),
        "+f"(d[J0 + 8][2]), "+f"(d[J0 + 8][3]),
        "+f"(d[J0 + 9][0]), "+f"(d[J0 + 9][1]),
        "+f"(d[J0 + 9][2]), "+f"(d[J0 + 9][3]),
        "+f"(d[J0 + 10][0]), "+f"(d[J0 + 10][1]),
        "+f"(d[J0 + 10][2]), "+f"(d[J0 + 10][3]),
        "+f"(d[J0 + 11][0]), "+f"(d[J0 + 11][1]),
        "+f"(d[J0 + 11][2]), "+f"(d[J0 + 11][3]),
        "+f"(d[J0 + 12][0]), "+f"(d[J0 + 12][1]),
        "+f"(d[J0 + 12][2]), "+f"(d[J0 + 12][3]),
        "+f"(d[J0 + 13][0]), "+f"(d[J0 + 13][1]),
        "+f"(d[J0 + 13][2]), "+f"(d[J0 + 13][3]),
        "+f"(d[J0 + 14][0]), "+f"(d[J0 + 14][1]),
        "+f"(d[J0 + 14][2]), "+f"(d[J0 + 14][3]),
        "+f"(d[J0 + 15][0]), "+f"(d[J0 + 15][1]),
        "+f"(d[J0 + 15][2]), "+f"(d[J0 + 15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x D) += P (k-step kk, in registers) @ V (keys 16kk .. 16kk + 15 of
// the tile at `vt`).  D = 256: two m64n128k16, V's column blocks 0-1 and
// 2-3 (each pair laid out as a D = 128 tile's).
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 8][4],
                                         const uint32_t (&a)[4],
                                         uint32_t vt, int kk) {
  const uint64_t db = desc_v<D>(vt, kk);
  if constexpr (D == 32) wgmma_rs_t_n32(d, a, db);
  if constexpr (D == 64) wgmma_rs_t_n64(d, a, db);
  if constexpr (D == 128) wgmma_rs_t_n128<0>(d, a, db);
  if constexpr (D == 256) {
    wgmma_rs_t_n128<0>(d, a, db);
    wgmma_rs_t_n128<16>(d, a, desc_v<D>(vt + 2 * Swz<D>::BLOCK, kk));
  }
}

// Keeps the compiler from moving accumulators across the wait for the
// asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

// Accumulator element e of n8 block j as the output: divided by
// max(l, 1e-30) of its row (g + 8 * (e >> 1)).
template <int D>
__device__ __forceinline__ float out_value(const Warp<D>& w, int j, int e) {
  return w.o[j][e] / fmaxf(w.l[e >> 1], 1e-30f);
}

}  // namespace tca
}  // namespace
