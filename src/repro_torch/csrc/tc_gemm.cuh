// Tensor-core tile of the GEMV at prefill-sized M, for Hopper (sm_90a):
// y (M, N) = (x (M, K) @ W) * scale with x bfloat16 and W b-bit
// two's-complement codes packed along K into int8 rows, low bits first
// (element k = i*per_byte + s is word i, digit s).  At b = 8 the packed
// rows are the int8 bit-parallel baseline's (K, N) codes.
//
// Included by csrc/bitplane_gemv.cu (b in {2, 4, 8}) and csrc/int8_matvec.cu
// (b = 8): for bfloat16 x and M > 8 it replaces the TPU kernels
// src/repro/kernels/bitplane_gemv/kernel.py (`_kernel`, :29-84) and
// src/repro/kernels/int8_matvec/kernel.py (`_kernel`, :18-33).
//
// What it computes.  Every code is an integer in [-128, 127], exact in
// bf16, and a bf16 x bf16 product is exact in the float32 sum, so the TPU
// kernel's radix-digit walk (kernel.py:63-79) collapses into one product on
// the rebuilt code: the result does not depend on radix.  The per-channel
// scale is applied once, after the whole K sum (kernel.py:82-84).
//
// What bounds it on an H100: 2*M*K*N bf16 operations against the tensor
// cores' 989 TFLOP/s, and the integer work of rebuilding the codes, which
// the tensor cores wait on unless it runs beside them.
//
// The design (PERF.md's findings tell which designs lost and why):
//   * the product is taken transposed, y^T = W^T x^T: wgmma's A operand is
//     the decoded weight, built straight into registers, and its B operand
//     is the x tile in shared memory.  The decoded weight never passes
//     through shared memory, which a design that decoded into a B tile
//     there had to write once and read once for every 64 rows;
//   * a block computes a 128 x 256 tile of y (128 rows of x, 256 weight
//     columns: reading x once per 256 columns halves the x traffic of a
//     128-column tile).  Two consumer warpgroups each own 128 weight columns
//     as two 64-row A fragments, wgmma m64n128k16 against all 128 rows of
//     x, the float32 sums in registers;
//   * a consumer rebuilds the A registers of the next 16-deep K step while
//     the tensor cores multiply the current one (two register buffers);
//     integers become bf16 by exponent-bias tricks (the code ORed into the
//     mantissa of bf16 128, then a subtraction; 8-bit codes through the
//     float 2^23), not by I2F.  Each thread owns 4 neighbouring weight
//     columns, so one 32-bit read of a packed row feeds 4 registers;
//   * one producer warpgroup keeps AHEAD stages of cp.async in flight: x
//     (swizzled for wgmma) and the packed rows (rows padded so the
//     consumers' reads meet no bank conflict), K advancing 64 a stage
//     through a ring of STAGES.  Named barriers hand a stage over: FULL once
//     its copies have landed, EMPTY once both consumers are done with it;
//   * copy widths follow the alignment of each row: 16, 8 or 4 bytes through
//     cp.async, else element loads (mamba2-130m's N = 3352 rows are 8-byte
//     aligned, d = 1983 rows byte-aligned); the common widths are template
//     parameters, as a width read at run time costs registers.  Edges in M,
//     N and K are zero in shared memory (cp.async's src-size zero-fills),
//     both x and codes at the K edge, so the sum stays exact; nothing is
//     padded in device memory;
//   * the epilogue transposes the sums through shared memory (the spent
//     ring) and stores rows of y in 16-byte pieces;
//   * where the output tiles are too few to fill the card the caller splits
//     K over gridDim.z: each split writes float32 partial sums and a second
//     kernel adds them in split order and applies the scale, so the result
//     is the same every run (no atomics).
//
// The expert-grouped launch (`launch_grouped`, the bit-plane GEMV's stacked
// MoE experts): grid.z runs over the experts instead of K splits (there
// is no split: the experts fill the card).  A block reads its expert's
// rows [offsets[e], offsets[e+1]) from device memory, returns at once
// when its row tile lies past them, and otherwise runs the tile above on
// that expert's codes, scales, rows of x and rows of y, by base offsets
// (the copies are cp.async from pointers: no descriptor to rebuild).  The
// row tiles of a launch are sized by a static bound on an expert's rows,
// so a step reads only the codes of the experts it routed rows to and the
// launch can be captured in a graph.
//
// Timing copies only (tc_gemm_ablation.py at the root of the repository):
// TC_ABLATE_DECODE, TC_ABLATE_MMA and TC_ABLATE_EPILOGUE each leave one part
// of the kernel out, and the result is then wrong.  No build of the
// package defines them.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {
namespace tc {

constexpr int BM = 128;                 // rows of x (rows of y) per block
constexpr int BN = 256;                 // weight columns (columns of y)
constexpr int BK = 64;                  // K per stage: one 128-byte bf16 row
constexpr int CONSUMERS = 2;            // warpgroups issuing wgmma
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + one producer
constexpr int PRODUCER_THREADS = 128;
constexpr int X_BYTES = BM * BK * 2;    // one stage of x, 16 KB
// named barriers: stage slot s full (BAR_FULL + s), empty (BAR_EMPTY + s),
// the producer's threads, the consumers' (0: the kernel has no
// __syncthreads)
constexpr int BAR_FULL = 1;
constexpr int BAR_EMPTY = 8;
constexpr int BAR_PRODUCER = 15;
constexpr int BAR_CONSUMERS = 0;

// Shared memory of one block, from a 1024-byte aligned base (the swizzle's
// period): [x stages][packed stages]; after the last stage the ring holds
// the transposed output tile.
template <int BITS>
struct Smem {
  static constexpr int STAGES = BITS == 2 ? 7 : 6;   // deep enough for the
  static constexpr int AHEAD = STAGES - 1;            // float32 output tile
  static constexpr int P_ROWS = BK * BITS / 8;   // packed rows per stage
  // padded so the rows one consumer read touches fall in distinct banks:
  // 8-bit reads rows 2t (t = lane % 4), narrower codes rows t
  static constexpr int P_PITCH = BN + (BITS == 8 ? 16 : 32);
  static constexpr int P_BYTES = P_ROWS * P_PITCH;
  static constexpr int X_OFF = 0;
  static constexpr int P_OFF = STAGES * X_BYTES;
  static constexpr int RING = P_OFF + STAGES * P_BYTES;
  static constexpr int BYTES = RING + 1024;
  static_assert(BM * (BN * 4 + 16) <= RING, "the output tile fits the ring");
  static_assert(BYTES <= 232448, "227 KB of shared memory a block");
};

// One stage of x: BM rows x BK bf16 into the swizzled tile at `xs`, V bytes
// a copy (V divides the row's 2K bytes, so a copy is wholly inside or
// wholly outside K).
template <int V>
__device__ __forceinline__ void load_x(uint32_t xs, uint8_t* xg,
                                       const __nv_bfloat16* __restrict__ x,
                                       int M, int K, int m0, int k0,
                                       int tid) {
  constexpr int E = V / 2;                    // elements a copy
  constexpr int PER_ROW = BK / E;
  constexpr int ITERS = BM * PER_ROW / PRODUCER_THREADS;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * PRODUCER_THREADS + tid;
    const int r = i / PER_ROW, c = (i % PER_ROW) * E;
    const bool ok = m0 + r < M && k0 + c < K;
    const __nv_bfloat16* src = x + (ok ? (size_t)(m0 + r) * K + k0 + c : 0);
    const int off = swizzle(r, c >> 3) + (c & 7) * 2;
    if constexpr (V >= 4) {
      cp_async<V>(xs + off, src, ok);
    } else {
      *reinterpret_cast<uint16_t*>(xg + off) =
          ok ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
    }
  }
}

// One stage of packed rows: P_ROWS x BN bytes at `ps`, rows P_PITCH apart.
template <int BITS, int V>
__device__ __forceinline__ void load_packed(uint32_t ps, uint8_t* pg,
                                            const uint8_t* __restrict__ packed,
                                            int KP, int N, int p0, int n0,
                                            int tid) {
  constexpr int PER_ROW = BN / V;
  constexpr int COPIES = Smem<BITS>::P_ROWS * PER_ROW;
  static_assert(COPIES % PRODUCER_THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < COPIES / PRODUCER_THREADS; ++it) {
    const int i = it * PRODUCER_THREADS + tid;
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    const bool ok = p0 + r < KP && n0 + c < N;
    const uint8_t* src = packed + (ok ? (size_t)(p0 + r) * N + n0 + c : 0);
    const int off = r * Smem<BITS>::P_PITCH + c;
    if constexpr (V >= 4) {
      cp_async<V>(ps + off, src, ok);
    } else {
      pg[off] = ok ? *src : (uint8_t)0;
    }
  }
}

// bf16x2 a * 1 + b: exact on the small integers the decode builds.
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

// Byte j of a in bits 0-7 and byte j of b in bits 16-23, zero between:
// prmt's selector bit 3 copies the sign bit of the chosen byte, 0 for the
// small biased codes (__byte_perm ignores that bit).
__device__ __forceinline__ uint32_t pair_bytes(uint32_t a, uint32_t b,
                                               int j) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b),
        "r"(j | ((8 | j) << 4) | ((4 + j) << 8) | ((8 | (4 + j)) << 12)));
  return d;
}

// A fragments.  Lane (g, t) = (lane / 4, lane % 4) of a warp holds, for
// its rows g and g + 8 of a 64-row fragment, the bf16 pairs of K = 2t, 2t+1
// and 2t+8, 2t+9 of a 16-deep step: a[0] (row g, low K), a[1] (row g + 8,
// low K), a[2] (row g, high K), a[3] (row g + 8, high K).  Rows map to
// weight columns so that a thread's four are neighbours: fragment f, row
// g + 8h is column nb + 2f + h, nb = 128*warpgroup + 32*warp + 4g.
//
// The packed words of step kk at byte column nb: wd[] holds one 32-bit read
// of each packed row that carries the thread's K (its byte j belongs to
// column nb + j).
template <int BITS>
__device__ __forceinline__ void load_words(const uint8_t* p, int nb, int kk,
                                           int t, uint32_t (&wd)[4]) {
  constexpr int PITCH = Smem<BITS>::P_PITCH;
  auto word = [&](int row) {
    return *reinterpret_cast<const uint32_t*>(p + row * PITCH + nb);
  };
  if constexpr (BITS == 4) {          // K 2t, 2t+1 share a byte: row 8kk + t
    wd[0] = word(8 * kk + t);
    wd[1] = word(8 * kk + t + 4);
  } else if constexpr (BITS == 2) {   // a byte holds K 4i .. 4i+3
    wd[0] = word(4 * kk + (t >> 1));
    wd[1] = word(4 * kk + 2 + (t >> 1));
  } else {                            // a row per K
    const int r = 16 * kk + 2 * t;
    wd[0] = word(r);
    wd[1] = word(r + 1);
    wd[2] = word(r + 8);
    wd[3] = word(r + 9);
  }
}

// Fragment f's four registers from the step's words: byte 2f + h of each
// word holds the code(s) of the column of row g + 8h.
template <int BITS>
__device__ __forceinline__ void decode_frag(const uint32_t (&wd)[4], int f,
                                            int t, uint32_t (&a)[4]) {
  if constexpr (BITS == 8) {
    // code c XOR 0x80 = c + 128 in the low byte of the float 2^23; less
    // 2^23 + 128 it is exactly c, and two of them round exactly to bf16
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t va = wd[2 * (q >> 1)] ^ 0x80808080u;
      const uint32_t vb = wd[2 * (q >> 1) + 1] ^ 0x80808080u;
      const int j = 2 * f + (q & 1);
      const float f0 =
          __uint_as_float(__byte_perm(va, 0x4B000000u, 0x7540 | j)) -
          8388736.f;
      const float f1 =
          __uint_as_float(__byte_perm(vb, 0x4B000000u, 0x7540 | j)) -
          8388736.f;
      __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
      a[q] = *reinterpret_cast<uint32_t*>(&h);
    }
  } else {
    // each byte of lo / hi: the code of K 2t / 2t+1 (or 2t+8 / 2t+9) of one
    // column, XOR its sign bit (c + 2^(b-1)); a pair of them in the mantissa
    // of bf16 128 (0x4300), less 128 + 2^(b-1), is exact
    constexpr uint32_t MASK = BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
    constexpr uint32_t BIAS = BITS == 4 ? 0x08080808u : 0x02020202u;
    constexpr uint32_t SUB = BITS == 4 ? 0xC308C308u    // -136
                                       : 0xC302C302u;   // -130
    const int s0 = BITS == 4 ? 0 : 4 * (t & 1);   // the code's bit in a byte
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w = wd[q >> 1];
      const uint32_t lo = ((w >> s0) & MASK) ^ BIAS;
      const uint32_t hi = ((w >> (s0 + BITS)) & MASK) ^ BIAS;
      const int j = 2 * f + (q & 1);
      a[q] = bf2_add(pair_bytes(lo, hi, j) | 0x43004300u, SUB);
    }
  }
}

// One stage of x and packed rows into ring slot `slot`.  XV / PV: copy
// widths fixed at compile time (0: read x_vec / p_vec at run time, for
// rows whose alignment the fast instantiations do not take).
template <int BITS, int XV, int PV>
__device__ __forceinline__ void load_stage(uint8_t* sm, uint32_t sa, int slot,
                                           int kt, const uint8_t* packed,
                                           const __nv_bfloat16* x, int M,
                                           int K, int N, int m0, int n0,
                                           int x_vec, int p_vec, int tid) {
  using L = Smem<BITS>;
  const int k0 = kt * BK;
  const int xo = L::X_OFF + slot * X_BYTES;
  if constexpr (XV != 0) {
    load_x<XV>(sa + xo, sm + xo, x, M, K, m0, k0, tid);
  } else {
    switch (x_vec) {
      case 16: load_x<16>(sa + xo, sm + xo, x, M, K, m0, k0, tid); break;
      case 8: load_x<8>(sa + xo, sm + xo, x, M, K, m0, k0, tid); break;
      case 4: load_x<4>(sa + xo, sm + xo, x, M, K, m0, k0, tid); break;
      default: load_x<2>(sa + xo, sm + xo, x, M, K, m0, k0, tid); break;
    }
  }
  const int po = L::P_OFF + slot * L::P_BYTES;
  const int KP = K * BITS / 8, p0 = k0 * BITS / 8;
  if constexpr (PV != 0) {
    load_packed<BITS, PV>(sa + po, sm + po, packed, KP, N, p0, n0, tid);
  } else {
    switch (p_vec) {
      case 16:
        load_packed<BITS, 16>(sa + po, sm + po, packed, KP, N, p0, n0, tid);
        break;
      case 8:
        load_packed<BITS, 8>(sa + po, sm + po, packed, KP, N, p0, n0, tid);
        break;
      case 4:
        load_packed<BITS, 4>(sa + po, sm + po, packed, KP, N, p0, n0, tid);
        break;
      default:
        load_packed<BITS, 1>(sa + po, sm + po, packed, KP, N, p0, n0, tid);
        break;
    }
  }
}

// One fragment's sums, scaled unless partial, into the staged [x row][weight
// column] tile: rows 8j + 2*t4 + c, columns c0 and c0 + 1.
__device__ __forceinline__ void stage_frag(const float (&acc)[64], uint8_t* sm,
                                           int c0, int n0, int N,
                                           const float* __restrict__ scale,
                                           const float* partial, bool f32,
                                           int pitch, int t4) {
  const int esize = f32 ? 4 : 2;
  float s0 = 1.f, s1 = 1.f;
  if (partial == nullptr) {
    s0 = n0 + c0 < N ? scale[n0 + c0] : 0.f;
    s1 = n0 + c0 + 1 < N ? scale[n0 + c0 + 1] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = 8 * j + 2 * t4 + c;
      const float v0 = acc[4 * j + c] * s0;
      const float v1 = acc[4 * j + 2 + c] * s1;
      uint8_t* dst = sm + r * pitch + c0 * esize;
      if (f32) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// y tile (blockIdx.y, blockIdx.x) over the K tiles of split blockIdx.z.
// partial == nullptr: writes (sum * scale) to out; else the float32 sum to
// partial[blockIdx.z] (M x N).
//
// Warpgroup 2 produces: it keeps AHEAD stages of copies in flight, marks
// stage t full once its copies have landed, and refills the slot of stage
// t - 1 once the consumers have marked it empty.  Warpgroups 0 and 1
// consume stage t: rebuild A for each 16-deep step while the previous
// step's wgmma run, wait for the last, mark the stage empty.
template <int BITS, int XV, int PV, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 1)
tc_gemm_kernel(const uint8_t* __restrict__ packed,
               const float* __restrict__ scale,
               const __nv_bfloat16* __restrict__ x, void* __restrict__ out,
               float* __restrict__ partial, const int* __restrict__ offsets,
               int M, int K, int N, int tiles_per_split, int x_vec,
               int p_vec, int out_bf16) {
  using L = Smem<BITS>;
  constexpr int STAGES = L::STAGES, AHEAD = L::AHEAD;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  if constexpr (GROUPED) {   // expert blockIdx.z's rows, codes and scales
    const int e = blockIdx.z, r0 = offsets[e];
    M = offsets[e + 1] - r0;
    if (m0 >= M) return;     // every thread of the block: no barrier yet
    packed += (size_t)e * (K * BITS / 8) * N;
    scale += (size_t)e * N;
    x += (size_t)r0 * K;
    out = static_cast<uint8_t*>(out) + (size_t)r0 * N * (out_bf16 ? 2 : 4);
  }
  extern __shared__ __align__(1024) uint8_t tc_smem_raw[];
  uint8_t* sm = tc_smem_raw + ((1024 - (smem_u32(tc_smem_raw) & 1023)) & 1023);
  const uint32_t sa = smem_u32(sm);
  const int wg = threadIdx.x / 128;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = GROUPED ? 0 : blockIdx.z * tiles_per_split;
  const int nt = min(k_tiles, kt0 + tiles_per_split) - kt0;

  if (wg == CONSUMERS) {
    const int tid = threadIdx.x - 128 * CONSUMERS;
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      if (s < nt) {
        load_stage<BITS, XV, PV>(sm, sa, s, kt0 + s, packed, x, M, K, N, m0,
                                 n0, x_vec, p_vec, tid);
      }
      cp_async_commit();
    }
    for (int t = 0; t < nt; ++t) {
      cp_async_wait<AHEAD - 1>();  // stage t has landed for this thread
      bar_sync(BAR_PRODUCER, PRODUCER_THREADS);   // ... and for all
      fence_proxy_async();
      bar_arrive(BAR_FULL + t % STAGES, THREADS);
      const int ld = t + AHEAD;    // into the slot of stage t - 1
      if (ld < nt) {
        if (ld >= STAGES) bar_sync(BAR_EMPTY + ld % STAGES, THREADS);
        load_stage<BITS, XV, PV>(sm, sa, ld % STAGES, kt0 + ld, packed, x, M,
                                 K, N, m0, n0, x_vec, p_vec, tid);
      }
      cp_async_commit();
    }
    return;
  }

  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int nb = 128 * wg + 32 * warp + 4 * g8;   // the thread's 4 columns
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    bar_sync(BAR_FULL + s, THREADS);
    const uint8_t* p = sm + L::P_OFF + s * L::P_BYTES;
    const uint32_t xa = sa + L::X_OFF + s * X_BYTES;
    uint32_t wd[4];
#ifdef TC_ABLATE_DECODE
    uint32_t a[2][2][4] = {};
#else
    uint32_t a[2][2][4];
    load_words<BITS>(p, nb, 0, t4, wd);
    decode_frag<BITS>(wd, 0, t4, a[0][0]);
    decode_frag<BITS>(wd, 1, t4, a[0][1]);
#endif
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_fence();
#ifndef TC_ABLATE_MMA
      wgmma_rs(acc0, a[kk & 1][0], desc(xa + 32 * kk));
      wgmma_rs(acc1, a[kk & 1][1], desc(xa + 32 * kk));
#endif
      wgmma_commit();
      if (kk + 1 < BK / 16) {
        wgmma_wait<1>();   // step kk - 1 is done: its A registers are free
#ifndef TC_ABLATE_DECODE
        load_words<BITS>(p, nb, kk + 1, t4, wd);
        decode_frag<BITS>(wd, 0, t4, a[(kk + 1) & 1][0]);
        decode_frag<BITS>(wd, 1, t4, a[(kk + 1) & 1][1]);
#endif
      }
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    bar_arrive(BAR_EMPTY + s, THREADS);
  }

#ifdef TC_ABLATE_EPILOGUE
  if (M > 0) return;
#endif
  // Epilogue: accumulator i of fragment f, thread (warp, g, t), is D row
  // 16*warp + g + 8*((i >> 1) & 1), i.e. weight column nb + 2f + h, and D
  // column 8*(i >> 2) + 2t + (i & 1), i.e. a row of x.  Both consumers are
  // done with the ring before it holds the transposed tile.
  bar_sync(BAR_CONSUMERS, 128 * CONSUMERS);
  fence_proxy_async();
  const bool f32 = partial != nullptr || !out_bf16;
  const int esize = f32 ? 4 : 2;
  const int pitch = BN * esize + 16;
  stage_frag(acc0, sm, nb, n0, N, scale, partial, f32, pitch, t4);
  stage_frag(acc1, sm, nb + 2, n0, N, scale, partial, f32, pitch, t4);
  bar_sync(BAR_CONSUMERS, 128 * CONSUMERS);
  const int per_chunk = 16 / esize;
  const int chunks = BN / per_chunk;
  uint8_t* base = partial != nullptr
                      ? reinterpret_cast<uint8_t*>(partial +
                                                   (size_t)blockIdx.z * M * N)
                      : static_cast<uint8_t*>(out);
  for (int i = threadIdx.x; i < BM * chunks; i += 128 * CONSUMERS) {
    const int r = i / chunks, c = (i % chunks) * per_chunk;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const uint8_t* src = sm + r * pitch + c * esize;
    uint8_t* dst = base + ((size_t)row * N + col) * esize;
    if (col + per_chunk <= N &&
        (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < per_chunk && col + e < N; ++e) {
        if (f32) {
          reinterpret_cast<float*>(dst)[e] =
              reinterpret_cast<const float*>(src)[e];
        } else {
          reinterpret_cast<uint16_t*>(dst)[e] =
              reinterpret_cast<const uint16_t*>(src)[e];
        }
      }
    }
  }
}

// out = (sum over splits of partial, in split order) * scale.
__global__ void tc_reduce_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ scale,
                                 void* __restrict__ out, int M, int N,
                                 int splits, int out_bf16) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * total + i];
    s *= scale[i % N];
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(s);
    } else {
      reinterpret_cast<float*>(out)[i] = s;
    }
  }
}

// The widest copy in {16, 8, 4} bytes that divides a row of `row_bytes`
// and the base address; `narrow` (an element) otherwise.
inline int copy_width(const void* base, long long row_bytes, int narrow) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int v = 16; v >= 4; v /= 2) {
    if (row_bytes % v == 0 && a % v == 0) return v;
  }
  return narrow;
}

// The kernel at the alignment of x's rows and of the packed rows.
template <int BITS, bool GROUPED>
int launch_tile(const void* packed, const void* scale, const void* x,
                void* out, void* partial, const int* offsets, dim3 grid,
                int M, int K, int N, int per, int out_bf16,
                cudaStream_t stream) {
  const int x_vec = copy_width(x, 2LL * K, 2);
  const int p_vec = copy_width(packed, N, 1);
  auto kernel = tc_gemm_kernel<BITS, 0, 0, GROUPED>;
  if (x_vec == 16 && p_vec == 16) {
    kernel = tc_gemm_kernel<BITS, 16, 16, GROUPED>;
  }
  if (x_vec == 16 && p_vec == 8) kernel = tc_gemm_kernel<BITS, 16, 8, GROUPED>;
  constexpr int smem = Smem<BITS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(x), out,
      static_cast<float*>(partial), offsets, M, K, N, per, x_vec, p_vec,
      out_bf16);
  return (int)cudaGetLastError();
}

// y = (x @ W) * scale through the tile above; `splits` K splits (every
// split non-empty), `partial` a float32 (splits, M, N) buffer when
// splits > 1.  Returns a cudaError_t.
template <int BITS>
int launch(const void* packed, const void* scale, const void* x, void* out,
           void* partial, int M, int K, int N, int splits, int out_bf16,
           cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % (8 / BITS) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int k_tiles = (K + BK - 1) / BK;
  if (splits < 1 || splits > k_tiles) return (int)cudaErrorInvalidValue;
  const int per = (k_tiles + splits - 1) / splits;
  if ((k_tiles + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  if ((splits > 1) != (partial != nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int err = launch_tile<BITS, false>(packed, scale, x, out, partial,
                                           nullptr, grid, M, K, N, per,
                                           out_bf16, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                       : 4096);
  tc_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      out, M, N, splits, out_bf16);
  return (int)cudaGetLastError();
}

// Stacked experts: packed (E, K*BITS/8, N), scale (E, 1, N), x and out
// rows sorted by expert with expert e's at [offsets[e], offsets[e+1]) on
// the device; each expert's first ceil(max_rows / BM) * BM rows are
// computed.
template <int BITS>
int launch_grouped(const void* packed, const void* scale, const void* x,
                   void* out, const int* offsets, int experts, int max_rows,
                   int K, int N, int out_bf16, cudaStream_t stream) {
  if (max_rows <= 0 || K <= 0 || N <= 0 || K % (8 / BITS) != 0 ||
      experts < 1 || experts > 65535 || offsets == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + BN - 1) / BN, (max_rows + BM - 1) / BM, experts);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  return launch_tile<BITS, true>(packed, scale, x, out, nullptr, offsets,
                                 grid, max_rows, K, N, (K + BK - 1) / BK,
                                 out_bf16, stream);
}

}  // namespace tc
}  // namespace
