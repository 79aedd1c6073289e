// The decode route of both GEMVs (M <= 8): y = (x @ W) * scale over b-bit
// packed rows, b in {2, 4, 8}.
//
// Included by csrc/bitplane_gemv.cu (its decode route), csrc/int8_matvec.cu
// (the int8 bit-parallel baseline's decode route: its row-major (K, N) int8
// codes are byte for byte the 8-bit packed rows, and `decode_a<8>` reads a
// byte as a two's-complement code) and csrc/bitplane_gemv_grouped.cu (the
// stacked MoE experts).  One source serves every decode.
//
// A launch reads each code once and little else, so it is bound by device
// memory: 0.5-180 MB a launch at the serving shapes, 0.15-53 us at 3.35
// TB/s.  A first design (one block of 32 warps per 32 output columns, byte
// loads, an integer digit walk and float32 FMAs) gave N = 2048 64 blocks
// and its CUDA-core work alone was above the bytes bound at M = 8; a second
// (a cluster of at most 8 blocks a column tile, still the grouped launch's)
// left SMs idle in a partial second wave and kept few bytes in flight
// (PERF.md).  The dense launch (`launch<BITS>`) now runs a balanced
// schedule:
//   * the work is units of (column tile of 128 weight columns, K step of
//     16), tile-major; a grid of `grid` blocks (the blocks the card holds at
//     once, fewer for a short launch, or the multiple of the tiles that
//     keeps 5/6 of them busy: kernels/_gemv.py `decode_grid`) gives block b
//     the units [b U / grid, (b + 1) U / grid) of the U, so the pieces
//     differ by at most one unit, every SM streams an equal share to the
//     end, and a narrow N fills the card as a wide one does;
//   * warp w of a block takes every WARPS-th K step of each tile of its
//     piece, from the w-th; each lane loads its 16-byte slices of the
//     step's packed rows (its 16 columns; streaming loads, first out of L2,
//     3-8% faster than .cg ones) and its 8 bytes of x into registers AHEAD
//     steps before it uses them, and reloads a slot as soon as it is used:
//     4-5 KB of codes in flight a warp, 64-80 KB an SM at
//     two blocks an SM; a block that moves on to its next tile has that
//     tile's first steps in flight while it adds up the last one's.  (A
//     ring of cp.async copies in shared memory kept more in flight and
//     streamed at 1.9 TB/s at most, register loads 2.8: PERF.md);
//   * a tile whose K lies in one piece is summed by its block (the warps'
//     sums in warp order) and stored.  A tile shared by several pieces: each
//     block writes its float32 sum to a scratch slot of its own, then counts
//     itself in on the tile's counter; the last to arrive adds the slots in
//     piece order, stores y and sets the counter back to zero.  No float
//     atomics, no second kernel, no memset: the scratch and the counters
//     are the caller's (kernels/_gemv.py `decode_scratch`: one buffer a
//     stream, zeroed once) and left zero by every launch, so a launch
//     reads nothing from the host and is captured in a graph as one node;
//     two runs give the same bits.  Launches that share a buffer must run
//     in stream order;
//   * bfloat16 x: the products on the tensor cores, mma.sync m16n8k16 with
//     the decoded weight as A (16 columns x 16 K) and x^T as B (n = 8: the
//     decode step's 8 lanes, rows past M zero).  The fragment layout is
//     chosen so that a lane's 16-byte slices feed its A registers directly:
//     tile f's row g is column 16g + 2f, and the lane's K pairs are its own
//     packed rows.  Codes become bf16 by exponent-bias tricks (a code XOR
//     its sign bit in the mantissa of bf16 128, paired by prmt, less the
//     bias; 8-bit codes through the float 2^23), not by I2F;
//   * float32 x (the engine path at M = 1): the same units and loads, each
//     code made a float by the same 2^23 trick and met by x in float32 FMAs
//     on the CUDA cores (bf16 would round x); exact on integer inputs whose
//     sums stay below 2^24.
// A b <= 8-bit code is exact in bf16 and a bf16 x times it exact in
// float32, so both products are the TPU kernels' (which cast x to float32
// and dot exact codes); only the order of the float32 sums differs.
//
// The expert-grouped launch (`launch_grouped`, the bit-plane GEMV's stacked
// MoE experts) keeps the cluster design: a column tile of an expert gets
// `splits` blocks as one thread-block cluster, with the experts on grid.z.
// Each block sums its share of K over 8 warps, adds the warps' sums in warp
// order, and the cluster adds its blocks' sums through distributed shared
// memory in split order.  A block reads its expert's rows [offsets[e],
// offsets[e+1]) from device memory and returns at once when there are none
// (a cluster shares one expert, so all its blocks return together);
// otherwise it takes that expert's codes, scales, rows of x and rows of y
// by base offsets and runs on its first ROWS rows.  A step thus reads the
// codes of the experts it routed rows to and no others, and the launch
// waits on nothing from the host; a partition made on the host could not
// balance rows known only on the device.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace {
// ------------------------------------------------------------ route decode
// M <= 8: the packed rows read once in 16-byte slices, bf16 x on mma.sync
// and float32 x on the CUDA cores.  The note at the top of the file says
// why.  `launch<BITS>` (dense) and `launch_grouped<BITS>` are the entries.
namespace dec {

constexpr int COLS = 128;        // weight columns of a tile: 16 a lane group
constexpr int KSTEP = 16;        // K of one mma.sync step
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 8;          // rows of x a launch takes (mma's n = 8)
constexpr int MAX_SPLITS = 8;    // the portable cluster size (grouped)
constexpr int MAX_GRID = 512;    // blocks of a dense launch (scratch slots)

// Lane (g, t) = (lane / 4, lane % 4) of a warp owns columns n0 + 16 g ..
// n0 + 16 g + 15 and, in every K step at kb, the four K kb + 4t .. kb + 4t
// + 3: LANE_ROWS packed rows of STEP_ROWS, read 16 bytes (its columns) at a
// time.  The grouped kernels load UNROLL steps of them at once, then use
// them (8 loads a lane); the dense kernel keeps AHEAD steps in flight,
// loading one as it uses one (8 to 10 loads a lane).
template <int BITS>
struct Step {
  static constexpr int STEP_ROWS = KSTEP * BITS / 8;
  static constexpr int LANE_ROWS = BITS / 2;
  static constexpr int UNROLL = 8 / LANE_ROWS;
  static constexpr int AHEAD = BITS == 2 ? 8 : 10 / LANE_ROWS;
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
// of word f / 2), so each register pairs two codes of one column: a[0] /
// a[2] the low / high K pair of column 2f, a[1] / a[3] of column 2f + 1.
// Its K pairs (2t, 2t+1) and (2t+8, 2t+9) are, of the lane's K kb + 4t ..
// kb + 4t + 3, the first two and the last two (2 and 8 bits), or the even
// two and the odd two at 4 bits: there the lane's rows 2t and 2t + 1 hold
// K 4t, 4t+1 and 4t+2, 4t+3 of each column as byte nibbles, and one prmt
// pairs a column's bytes of the two rows, so each register costs a mask
// (and for three of four a shift).  `x_frag` puts x in the same order.
// Nibbles 0 and 4 of v (bits 0-3, 16-19) XOR their sign bit in the
// mantissas of bf16 128: (v & 0x000F000F) ^ 0x43084308 in one lop3.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t v) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"
      : "=r"(d)
      : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  return d;
}

template <int BITS>
__device__ __forceinline__ void decode_a(const uint4 (&w)[BITS / 2], int f,
                                         uint32_t (&a)[4]) {
  const int q = f >> 1, j = 2 * (f & 1);
  if constexpr (BITS == 4) {
    // bytes j, j + 1 of row 2t, then of row 2t + 1; each nibble XOR its sign
    // bit in the mantissa of bf16 128 (one lop3), less 136, is exact
    const uint32_t v =
        __byte_perm(word(w[0], q), word(w[1], q),
                    j | ((j + 1) << 4) | ((j + 4) << 8) | ((j + 5) << 12));
    constexpr uint32_t SUB = 0xC308C308u;
    a[0] = tc::bf2_add(nibbles_bf16(v), SUB);
    a[1] = tc::bf2_add(nibbles_bf16(v >> 8), SUB);
    a[2] = tc::bf2_add(nibbles_bf16(v >> 4), SUB);
    a[3] = tc::bf2_add(nibbles_bf16(v >> 12), SUB);
  } else if constexpr (BITS == 8) {
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
    // 2-bit: row t, K pairs in crumbs (0, 1) and (2, 3).  Each code XOR its
    // sign bit (c + 2) paired in the mantissas of bf16 128, less 130, is
    // exact (tc_gemm.cuh's decode)
    constexpr uint32_t MASK = 0x03030303u, BIAS = 0x02020202u;
    constexpr uint32_t SUB = 0xC302C302u;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t src = word(w[0], q);
      const int s0 = 4 * p;
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

// The B fragment (b0, b1) of x row g's K kb + 4t .. kb + 4t + 3, two bf16
// pairs (e0 e1, e2 e3), in decode_a's K order: (e0 e2, e1 e3) at 4 bits.
template <int BITS>
__device__ __forceinline__ uint2 x_frag(uint2 e) {
  if constexpr (BITS == 4) {
    return make_uint2(__byte_perm(e.x, e.y, 0x5410),
                      __byte_perm(e.x, e.y, 0x7632));
  } else {
    return e;
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

__device__ __forceinline__ void store_y(void* __restrict__ out, size_t o,
                                        float v, int out_bf16) {
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
  } else {
    reinterpret_cast<float*>(out)[o] = v;
  }
}

// x rows g < M at K k .. k + 3 as two bf16 pairs (zeros past M and K).
__device__ __forceinline__ uint2 x_pairs(const uint16_t* __restrict__ xr,
                                         int k, int K, bool ok, int x_vec) {
  if (!ok) return make_uint2(0u, 0u);
  if (x_vec && k + 3 < K) return __ldg(reinterpret_cast<const uint2*>(xr + k));
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    e[i] = k + i < K ? (uint32_t)__ldg(xr + k + i) : 0u;
  }
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

// lane (g, t)'s FMA sums acc[m][c] (columns 16 g + c, its four K a step)
// added over the four t of a column, rows m < M stored to red[m][16 g ..].
template <int MR>
__device__ __forceinline__ void fma_to_red(float (&acc)[MR][16],
                                           float (&red)[ROWS][COLS], int M,
                                           int g, int t) {
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
      *reinterpret_cast<float4*>(&red[m][16 * g + 4 * t]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ------------------------------------------- dense: the balanced schedule
// Scratch of the tiles shared by pieces, SCRATCH_WORDS 4-byte words from
// the caller: `partials`, block b's float32 sums of the tile its piece
// starts in (slot 2b) and of the tile it ends in (2b + 1), ROWS x COLS
// each; then `arrivals`, a tile's counter at the slot of its last piece's
// block.  Zero before the first launch; each launch leaves every counter
// zero again.
constexpr int PARTIAL_WORDS = 2 * MAX_GRID * ROWS * COLS;
constexpr int SCRATCH_WORDS = PARTIAL_WORDS + MAX_GRID;

// The block whose piece holds unit u of `units` over `grid` blocks (block
// b holds [b units / grid, (b + 1) units / grid)).
__device__ __forceinline__ int owner(long long u, long long units,
                                     int grid) {
  return (int)(((u + 1) * grid - 1) / units);
}

// MR 0: bfloat16 x on mma.sync; MR 1 or ROWS: float32 x on FMAs, rows 0 ..
// MR - 1 (MR >= M).  x_vec: x rows read 4 elements at a time.
template <int BITS, int VEC, int MR>
__global__ void __launch_bounds__(THREADS, MR == ROWS ? 1 : 2)
decode_balanced_kernel(const uint8_t* __restrict__ packed,
                       const float* __restrict__ scale,
                       const void* __restrict__ x, void* __restrict__ out,
                       float* __restrict__ partials,
                       int* __restrict__ arrivals, int M, int K, int N,
                       int x_vec, int out_bf16) {
  using S = Step<BITS>;
  constexpr int L = S::LANE_ROWS, A = S::AHEAD;
  __shared__ __align__(16) float red[WARPS][ROWS][COLS];
  __shared__ int finisher;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int KP = K * BITS / 8, k_steps = (K + KSTEP - 1) / KSTEP;
  const int grid = (int)gridDim.x, b = (int)blockIdx.x;
  const long long units = (long long)((N + COLS - 1) / COLS) * k_steps;
  const long long u0 = b * units / grid, u1 = (b + 1LL) * units / grid;
  const uint16_t* xr = static_cast<const uint16_t*>(x) + (size_t)g * K;

  // the piece's K steps [s0, s1) of a tile: the warp takes s0 + warp, s0 +
  // warp + WARPS, ...: n of them, at the lane's columns col ..
  int s0 = 0, n = 0, col = 0;
  auto enter = [&](int tl) {
    const long long lo = (long long)tl * k_steps;
    s0 = (int)(max(u0, lo) - lo);
    const int s1 = (int)(min(u1, lo + k_steps) - lo);
    n = s1 - s0 > warp ? (s1 - s0 - warp + WARPS - 1) / WARPS : 0;
    col = tl * COLS + 16 * g;
  };
  // the lane's packed rows and x of the warp's i-th step, zeros past n
  auto load = [&](int i, uint4 (&wi)[L], uint2& xi) {
    const int ks = s0 + warp + WARPS * i;
    const bool ok = i < n;
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const int pr = ks * S::STEP_ROWS + L * t + r;
      const uint8_t* row = packed + (size_t)pr * N;
      if constexpr (VEC == 16) {
        wi[r] = ok && pr < KP && col < N
                    ? __ldcs(reinterpret_cast<const uint4*>(row + col))
                    : make_uint4(0u, 0u, 0u, 0u);
      } else {
        wi[r] = load16<VEC>(row, col, N, ok && pr < KP);
      }
    }
    if constexpr (MR == 0) {
      xi = x_pairs(xr, ks * KSTEP + 4 * t, K, ok && g < M, x_vec);
    }
  };
  // a window of A steps in flight: step i sits in slot i % A, refilled with
  // step i + A as soon as it is used
  uint4 w[A][L];
  uint2 xv[A];
  int tile = (int)(u0 / k_steps);
  enter(tile);
#pragma unroll
  for (int i = 0; i < A; ++i) load(i, w[i], xv[i]);
  for (; (long long)tile * k_steps < u1; ++tile) {
    const long long t_lo = (long long)tile * k_steps, t_hi = t_lo + k_steps;
    // bf16: acc[f] the mma tile f's (16 x 8) fragment; float32: acc[m] row
    // m at the lane's 16 columns
    float acc[MR == 0 ? 8 : MR][MR == 0 ? 4 : 16];
#pragma unroll
    for (int r = 0; r < (MR == 0 ? 8 : MR); ++r) {
#pragma unroll
      for (int e = 0; e < (MR == 0 ? 4 : 16); ++e) acc[r][e] = 0.f;
    }
    for (int base = 0; base < n; base += A) {
#pragma unroll
      for (int i = 0; i < A; ++i) {
        if constexpr (MR == 0) {
          // a step past n holds zero x: its products add nothing
          const uint2 xb = x_frag<BITS>(xv[i]);
#pragma unroll
          for (int f = 0; f < 8; ++f) {
            uint32_t a[4];
            decode_a<BITS>(w[i], f, a);
            tc::mma(acc[f], a, xb.x, xb.y);
          }
        } else if (base + i < n) {
          const int k = (s0 + warp + WARPS * (base + i)) * KSTEP + 4 * t;
          const float* xf = static_cast<const float*>(x);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            float xm[4] = {0.f, 0.f, 0.f, 0.f};
            if (m < M) {
              const float* xrow = xf + (size_t)m * K + k;
              if (x_vec && k + 3 < K) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(xrow));
                xm[0] = v.x;
                xm[1] = v.y;
                xm[2] = v.z;
                xm[3] = v.w;
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  xm[e] = k + e < K ? __ldg(xrow + e) : 0.f;
                }
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
              for (int c = 0; c < 16; ++c) {
                acc[m][c] = fmaf(xm[e], code_f32<BITS>(w[i], e, c),
                                 acc[m][c]);
              }
            }
          }
        }
        load(base + i + A, w[i], xv[i]);
      }
    }
    // the warp's sums of this tile: y rows by column
    if constexpr (MR == 0) {
      // acc f: y rows 2t, 2t + 1 at columns 16 g + 2f (e 0, 1) and + 1
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int c = 16 * g + 2 * f;
        *reinterpret_cast<float2*>(&red[warp][2 * t][c]) =
            make_float2(acc[f][0], acc[f][2]);
        *reinterpret_cast<float2*>(&red[warp][2 * t + 1][c]) =
            make_float2(acc[f][1], acc[f][3]);
      }
    } else {
      fma_to_red<MR>(acc, red[warp], M, g, t);
    }
    __syncthreads();
    // thread tid < M * 32 takes row tid / 32, columns 4 (tid % 32) .. + 3
    const int q = tid % (COLS / 4), row = tid / (COLS / 4);
    const bool mine_q = tid < M * (COLS / 4);
    const int n4 = tile * COLS + 4 * q;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mine_q) {   // the warps' sums, in warp order
#pragma unroll
      for (int v = 0; v < WARPS; ++v) {
        const float4 r4 =
            *reinterpret_cast<const float4*>(&red[v][row][4 * q]);
        sum.x += r4.x;
        sum.y += r4.y;
        sum.z += r4.z;
        sum.w += r4.w;
      }
    }
    // the whole tile is this piece's, or pieces first .. last share it: a
    // piece's slot is 2b when it starts in the tile, else 2b + 1 (only the
    // first piece can start before it)
    const bool whole = u0 <= t_lo && t_hi <= u1;
    const int first = whole ? b : owner(t_lo, units, grid);
    const int last = whole ? b : owner(t_hi - 1, units, grid);
    float4* slots = reinterpret_cast<float4*>(partials);
    constexpr int SLOT = ROWS * COLS / 4;
    if (!whole) {
      if (mine_q) {
        __stcg(slots + (size_t)(2 * b + (u0 >= t_lo ? 0 : 1)) * SLOT + tid,
               sum);
        __threadfence();   // before the count; no load is in flight here
      }
      __syncthreads();
      if (tid == 0) {
        finisher = atomicAdd(&arrivals[last], 1) == last - first;
        if (finisher) arrivals[last] = 0;   // every piece has counted
        __threadfence();   // the other pieces' sums before ours are read
      }
    }
    // the next tile's first A steps go out while this one's sums are added
    if (t_hi < u1) {
      enter(tile + 1);
#pragma unroll
      for (int i = 0; i < A; ++i) load(i, w[i], xv[i]);
    }
    if (!whole) __syncthreads();   // `finisher` is read
    if (mine_q && (whole || finisher)) {
      if (!whole) {   // the pieces' sums in piece order
        const long long first_lo = first * units / grid;
        sum = __ldcg(slots + (size_t)(2 * first + (first_lo >= t_lo ? 0 : 1))
                     * SLOT + tid);
        int p = first + 1;
        for (; p + 8 <= last + 1; p += 8) {
          float4 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = __ldcg(slots + (size_t)(2 * (p + e)) * SLOT + tid);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sum.x += v[e].x;
            sum.y += v[e].y;
            sum.z += v[e].z;
            sum.w += v[e].w;
          }
        }
        for (; p <= last; ++p) {
          const float4 v = __ldcg(slots + (size_t)(2 * p) * SLOT + tid);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
      }
      const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n4 + e < N) {
          store_y(out, (size_t)row * N + n4 + e, s4[e] * scale[n4 + e],
                  out_bf16);
        }
      }
    }
    __syncthreads();   // red and `finisher` are free for the next tile
  }
}

template <int BITS, int VEC, int MR>
int launch_balanced(const void* packed, const void* scale, const void* x,
                    void* out, void* scratch, int M, int K, int N, int grid,
                    int x_vec, int out_bf16, cudaStream_t stream) {
  float* partials = static_cast<float*>(scratch);
  decode_balanced_kernel<BITS, VEC, MR><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      x, out, partials, reinterpret_cast<int*>(partials + PARTIAL_WORDS), M,
      K, N, x_vec, out_bf16);
  return (int)cudaGetLastError();
}

template <int BITS, int VEC>
int launch_by_x(const void* packed, const void* scale, const void* x,
                void* out, void* scratch, int M, int K, int N, int grid,
                int x_vec, int x_bf16, int out_bf16, cudaStream_t stream) {
  if (x_bf16) {
    return launch_balanced<BITS, VEC, 0>(packed, scale, x, out, scratch, M,
                                         K, N, grid, x_vec, out_bf16, stream);
  }
  if (M == 1) {
    return launch_balanced<BITS, VEC, 1>(packed, scale, x, out, scratch, M,
                                         K, N, grid, x_vec, out_bf16, stream);
  }
  return launch_balanced<BITS, VEC, ROWS>(packed, scale, x, out, scratch, M,
                                          K, N, grid, x_vec, out_bf16,
                                          stream);
}

// y (M, N) for M <= ROWS on `grid` blocks, 1 .. MAX_GRID and at most the
// launch's (column tile, K step) units (kernels/_gemv.py `decode_grid`).
// `scratch`: SCRATCH_WORDS 4-byte words, zero before its first launch and
// used by one launch at a time (kernels/_gemv.py `decode_scratch`).
template <int BITS>
int launch(const void* packed, const void* scale, const void* x, void* out,
           void* scratch, int M, int K, int N, int grid, int x_bf16,
           int out_bf16, cudaStream_t stream) {
  const long long units =
      (long long)((N + COLS - 1) / COLS) * ((K + KSTEP - 1) / KSTEP);
  if (M < 1 || M > ROWS || grid < 1 || grid > MAX_GRID || grid > units ||
      scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  // x rows read 4 elements at a time when every row start is aligned
  const int x_vec = K % 4 == 0 && xa % (x_bf16 ? 8 : 16) == 0;
  if (N % 16 == 0 && pa % 16 == 0) {
    return launch_by_x<BITS, 16>(packed, scale, x, out, scratch, M, K, N,
                                 grid, x_vec, x_bf16, out_bf16, stream);
  }
  if (N % 8 == 0 && pa % 8 == 0) {
    return launch_by_x<BITS, 8>(packed, scale, x, out, scratch, M, K, N, grid,
                                x_vec, x_bf16, out_bf16, stream);
  }
  return launch_by_x<BITS, 1>(packed, scale, x, out, scratch, M, K, N, grid,
                              x_vec, x_bf16, out_bf16, stream);
}

// Blocks of the dense kernel for (x_bf16, M) that one SM holds at once.
template <int BITS>
int occupancy(int x_bf16, int M, int* blocks) {
  const void* kernel =
      x_bf16   ? (const void*)decode_balanced_kernel<BITS, 16, 0>
      : M == 1 ? (const void*)decode_balanced_kernel<BITS, 16, 1>
               : (const void*)decode_balanced_kernel<BITS, 16, ROWS>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            THREADS, 0);
}

// ----------------------------------------- grouped: the cluster design
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
    store_y(out, (size_t)(i / COLS) * N + n, sum * scale[n], out_bf16);
  }
  cluster.sync();   // no block leaves while another reads its part
}

// bfloat16 x: grid (column tiles, splits, experts), one cluster per column
// tile of an expert; split blockIdx.y takes K steps [y * per, (y + 1) *
// per), its warps every WARPS-th of them.  D (16 x 8) = A (16 columns x 16
// K) x B (16 K x 8 rows of x): lane (g, t) adds y rows 2t, 2t + 1 at its 16
// columns.
template <int BITS, int VEC>
__global__ void __launch_bounds__(THREADS)
decode_mma_kernel(const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ x,
                  void* __restrict__ out, const int* __restrict__ offsets,
                  int K, int N, int per, int x_vec, int out_bf16) {
  using S = Step<BITS>;
  // expert blockIdx.z's rows, codes and scales
  const int e = blockIdx.z, r0 = offsets[e];
  const int M = min(offsets[e + 1] - r0, ROWS);
  if (M <= 0) return;     // the whole cluster: it shares the expert
  packed += (size_t)e * (K * BITS / 8) * N;
  scale += (size_t)e * N;
  x += (size_t)r0 * K;
  out = static_cast<uint8_t*>(out) + (size_t)r0 * N * (out_bf16 ? 2 : 4);
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
    for (int c = 0; c < 4; ++c) acc[f][c] = 0.f;
  }
  for (int base = s0 + warp; base < s1; base += WARPS * S::UNROLL) {
    uint4 w[S::UNROLL][S::LANE_ROWS];
    uint2 xb[S::UNROLL];
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
      xb[u] = x_frag<BITS>(
          x_pairs(xr, ks * KSTEP + 4 * t, K, ok && g < M, x_vec));
    }
#pragma unroll
    for (int u = 0; u < S::UNROLL; ++u) {
      if (base + u * WARPS >= s1) break;
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        uint32_t a[4];
        decode_a<BITS>(w[u], f, a);
        tc::mma(acc[f], a, xb[u].x, xb[u].y);
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

// float32 x on the CUDA cores (bf16 would round x), an expert's rows 0 ..
// ROWS - 1: the same grid, loads and columns; lane (g, t) sums its four K
// a step for its 16 columns, then the four t of a column are added.
template <int BITS, int VEC>
__global__ void __launch_bounds__(THREADS)
decode_fma_kernel(const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale,
                  const float* __restrict__ x, void* __restrict__ out,
                  const int* __restrict__ offsets, int K, int N, int per,
                  int x_vec, int out_bf16) {
  using S = Step<BITS>;
  const int e = blockIdx.z, r0 = offsets[e];
  const int M = min(offsets[e + 1] - r0, ROWS);
  if (M <= 0) return;     // the whole cluster: it shares the expert
  packed += (size_t)e * (K * BITS / 8) * N;
  scale += (size_t)e * N;
  x += (size_t)r0 * K;
  out = static_cast<uint8_t*>(out) + (size_t)r0 * N * (out_bf16 ? 2 : 4);
  __shared__ __align__(16) float red[WARPS][ROWS][COLS];
  __shared__ __align__(16) float part[ROWS][COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * COLS, col = n0 + 16 * g;
  const int KP = K * BITS / 8, k_steps = (K + KSTEP - 1) / KSTEP;
  const int s0 = blockIdx.y * per, s1 = min(k_steps, s0 + per);

  float acc[ROWS][16];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
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
      for (int m = 0; m < ROWS; ++m) {
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
  fma_to_red<ROWS>(acc, red[warp], M, g, t);
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

// grid (column tiles, splits, experts).
template <int BITS, int VEC>
int launch_grouped_vec(const void* packed, const void* scale, const void* x,
                       void* out, const int* offsets, int experts, int K,
                       int N, int splits, int per, int x_vec, int x_bf16,
                       int out_bf16, cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS, splits, experts);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  if (x_bf16) {
    return launch_cluster(decode_mma_kernel<BITS, VEC>, grid, stream, p, s,
                          static_cast<const __nv_bfloat16*>(x), out, offsets,
                          K, N, per, x_vec, out_bf16);
  }
  return launch_cluster(decode_fma_kernel<BITS, VEC>, grid, stream, p, s,
                        static_cast<const float*>(x), out, offsets, K, N, per,
                        x_vec, out_bf16);
}

// Stacked experts: packed (E, K*BITS/8, N), scale (E, 1, N), x and out
// rows sorted by expert with expert e's at [offsets[e], offsets[e+1]) on
// the device; each expert's first ROWS rows are computed.  `splits` K
// splits, 1 .. MAX_SPLITS, each holding some K.
template <int BITS>
int launch_grouped(const void* packed, const void* scale, const void* x,
                   void* out, const int* offsets, int experts, int K, int N,
                   int splits, int x_bf16, int out_bf16,
                   cudaStream_t stream) {
  if (experts < 1 || experts > 65535 || offsets == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int k_steps = (K + KSTEP - 1) / KSTEP;
  if (splits < 1 || splits > MAX_SPLITS || splits > k_steps) {
    return (int)cudaErrorInvalidValue;
  }
  const int per = (k_steps + splits - 1) / splits;
  if ((k_steps + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  // x rows read 4 elements at a time when every row start is aligned (an
  // expert's rows start at a whole row, so the same holds for each)
  const int x_vec = K % 4 == 0 && xa % (x_bf16 ? 8 : 16) == 0;
  // an expert's codes start N * K * BITS / 8 bytes on: as aligned as N
  if (N % 16 == 0 && pa % 16 == 0) {
    return launch_grouped_vec<BITS, 16>(packed, scale, x, out, offsets,
                                        experts, K, N, splits, per, x_vec,
                                        x_bf16, out_bf16, stream);
  }
  if (N % 8 == 0 && pa % 8 == 0) {
    return launch_grouped_vec<BITS, 8>(packed, scale, x, out, offsets,
                                       experts, K, N, splits, per, x_vec,
                                       x_bf16, out_bf16, stream);
  }
  return launch_grouped_vec<BITS, 1>(packed, scale, x, out, offsets, experts,
                                     K, N, splits, per, x_vec, x_bf16,
                                     out_bf16, stream);
}

}  // namespace dec

}  // namespace
