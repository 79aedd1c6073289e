// Paged attention for Hopper: decode and chunked prefill that read K/V
// pages in place through the block table.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention/kernel.py:
//   * decode:  `_body`, `_kernel_full`, `_kernel_quant`, launched by
//              `paged_attention_pallas`;
//   * prefill: `_prefill_body`, `_pf_kernel_full`, `_pf_kernel_quant`,
//              launched by `paged_prefill_pallas`.
//
// Layouts (the JAX package's): queries (B, C, Hkv, G, Dh) with C = 1 at
// decode, pools (P, page, Hkv, Dh) in float32, bfloat16 or int8, int8 pools
// with (P, page, Hkv) bfloat16 scales, block tables (B, n_blocks) int32.
// The output has the queries' layout in float32.
//
// What bounds it on an H100: decode reads every valid K/V page once per
// (lane, KV head) and does 4*G*Dh operations per cached token, so it is
// bound by device-memory bytes; at the serving path's shapes (8 lanes, 2
// KV heads, contexts of a few hundred tokens) those bytes take well under a
// microsecond, so what a design has to beat is latency: the length of the
// longest chain of dependent loads and products.  Prefill reuses each page
// for block_q*G query rows; at the serving path's shapes (a 32-token chunk)
// its bytes and operations take about a microsecond too, so what bounds it
// is also latency: the few steps of each block's walk over the pages, each
// a gather from device memory and a dependent chain of products and
// softmax.
//
// Prefill has two routes, picked in Python by dtype
// (`kernels/paged_attention/kernel.py`, `prefill_route`), each its own entry
// point; decode has one.
//
// Decode (every pool and query dtype): `paged_decode_split_kernel` and
// `paged_decode_combine_kernel`, split-KV (flash-decoding):
//   * the lane's keys are cut into splits of split_tokens (64 for Dh <=
//     128) and one block of 8 warps takes one (split, KV head, lane), so
//     the card sees B * Hkv * splits blocks instead of B * Hkv walks (a
//     first design, one block per (lane, KV head) walking the whole
//     context 128 tokens a step, ran 16 blocks at the serving path's shape
//     and took 90 us, PERF.md).  The split count comes from the block
//     table's width, not from the positions, so the grid is fixed by the
//     shapes, nothing is read back to the host and the launch can be
//     captured in a CUDA graph; a split that holds no attended key (past
//     cur_pos, or before the window) returns at once;
//   * what a block does is one chain of latencies, so the design keeps it
//     short: the split's attended page rows go to shared memory as they
//     are (int8, bf16 or float32) by 16-byte cp.async through the block
//     table, all in flight at once, while the int8 scales and the queries
//     load under them; split_tokens is a compile-time constant, so every
//     loop over the split's keys unrolls.  (A version that staged float32
//     rows with four ld.global.nc a thread and ran 4 warps with rolled
//     loops took 17 us a call, PERF.md);
//   * scores: a warp per key row, lanes across Dh (elements lane + 32 j),
//     the 8 query heads of a pass in registers, and one recursive-halving
//     shuffle reduction (9 shuffles) for all 8 dot products, instead of a
//     serial Dh-long chain per score; G query heads go 8 a pass;
//   * a warp per head then takes the split's softmax and p . v, lanes
//     across Dh, one float32 FMA chain per attended row, on the CUDA cores
//     (a tensor-core P V would have to split the int8 path's float32 p
//     into bf16 hi + lo, and these products take a fraction of a
//     microsecond);
//   * each split leaves (m, l, acc) in float32 scratch that the caller
//     allocates; the second kernel, launched from the same entry point,
//     combines the splits that hold an attended key in split order: m* =
//     max m_s, w_s = exp(m_s - m*), out = sum w_s acc_s / max(sum w_s l_s,
//     1e-30).  No atomics: two runs give the same bits.
//
// Prefill, tensor_core (bfloat16 queries; bfloat16 or int8 pools):
// `paged_prefill_tc_kernel`, on the tile of csrc/tc_attention.cuh:
//   * one block of 4 warps per (lane, KV head, query block) holds 64 query
//     rows, block_q chunk offsets x G heads (row r is offset r / G, head
//     r % G), as mma.sync A fragments: each page is read once per block and
//     feeds every row;
//   * the walk covers only the pages some row attends, 64 keys a step; the
//     step's page rows are gathered through the block table with 16-byte
//     cp.async into a two-stage ring, so the next step's gather runs under
//     the current step's products; keys past the walk's end are zeros;
//   * int8 codes land as bytes and are widened to bf16 tiles in shared
//     memory (exactly: c + 2^23 + 128 in a float's low byte, less the
//     same); their per-key scales are read one step ahead into registers;
//   * S = Q K^T and O += P V on mma.sync m16n8k16 with float32 sums.
//
// Prefill, cuda_core (float32 queries or pools): `paged_attention_kernel`:
//   * one block per (lane, KV head, query block) holds all G query heads
//     of its KV head, so each page is read from device memory once per
//     block and feeds every query row of the block;
//   * the block walks the lane's block table in a loop, which replaces the
//     TPU's sequential grid axis, several pages per step (step_pages, as
//     many as shared memory holds up to 64 tokens), so each step's loads,
//     scores and softmax run wide and the walk has few steps; the walk
//     covers only the pages that hold a key some row attends (causal
//     bound, valid length, window): the others contribute nothing to any
//     row that attends at least one key, so the result is the same;
//   * K and V are staged in shared memory as float32 (K rows padded by one
//     word against bank conflicts); scores, the running (m, l) and the
//     output accumulator stay in shared memory and never touch device
//     memory (online softmax, as the TPU kernel keeps them in VMEM).
//
// Numerics follow the TPU kernel cast for cast on every route, because an
// ulp here can flip a greedy token:
//   * masked scores are NEG_INF = -1e30, a finite number: a fully masked
//     step gives exp(0) = 1 and the next real step wipes it through corr;
//     the end divides by max(l, 1e-30) (kernel.py:54, :124);
//   * decode, full-precision pools: q is rounded to the pool dtype before
//     QK^T and p to the pool dtype before PV (kernel.py:85, :115);
//   * decode, int8 pools: q goes through bf16, the K scale multiplies the
//     scores and the V scale the float32 probabilities, which are not
//     rounded (kernel.py:78-80, :92, :111);
//   * prefill, full-precision pools: q is not rounded (kernel.py:249), p is
//     rounded to the pool dtype (kernel.py:280);
//   * prefill, int8 pools: q goes through bf16 and p is rounded to bf16
//     after the V-scale fold (kernel.py:243, :277-278);
//   * the scores are (q . k) * sm_scale in float32, times the K scale of
//     int8 pools; l accumulates p before the V-scale fold and the rounding.
// On the tensor-core route every operand of a product is already a bf16
// value (bf16 q, bf16 or int8 K and V, p rounded to bf16), so the bf16
// products are the TPU kernel's own; only the order of the float32 sums
// differs.  The online-softmax steps span several pages where the TPU
// kernel steps one page at a time, and decode takes its maxima per split
// and combines the splits at the end: the same function, with the running
// max taken over other groups of keys and the float32 sums in another
// order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_attention.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int PREFILL_STEP_TOKENS = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// Round a float32 to storage type T and back (identity for float; int8
// pools never round through their own type, the callers use bf16 there).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Smem {
  float *q, *acc, *k, *v, *p, *m, *l, *corr, *red, *ks, *vs;
};

// The block's shared-memory carve-up for R query rows, Dh, T step tokens
// and TPR threads per softmax row; returns the float count.  With a null
// base only the count is wanted.
__host__ __device__ inline size_t carve(float* base, int R, int Dh, int T,
                                        int TPR, Smem* s) {
  const size_t sizes[11] = {
      (size_t)R * Dh, (size_t)R * Dh, (size_t)T * (Dh + 1), (size_t)T * Dh,
      (size_t)R * T, (size_t)R, (size_t)R, (size_t)R, (size_t)R * TPR,
      (size_t)T, (size_t)T};
  float** slots[11] = {&s->q, &s->acc, &s->k, &s->v, &s->p, &s->m,
                       &s->l, &s->corr, &s->red, &s->ks, &s->vs};
  size_t o = 0;
  for (int i = 0; i < 11; ++i) {
    if (base != nullptr) *slots[i] = base + o;
    o += sizes[i];
  }
  return o;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ pos0,
    const int* __restrict__ seq_lens, float* __restrict__ out, int C,
    int Hkv, int G, int Dh, int page, int n_blocks, int block_q,
    int step_pages, int window, float sm_scale) {
  constexpr bool QUANT = sizeof(KT) == 1;
  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int R = block_q * G;  // query rows: block_q chunk offsets x G heads
  const int T = step_pages * page;
  const int TPR = THREADS / R;  // threads per softmax row (R <= THREADS)
  const int kstride = Dh + 1;

  extern __shared__ __align__(16) unsigned char imagine_smem[];
  Smem s;
  carve(reinterpret_cast<float*>(imagine_smem), R, Dh, T, TPR, &s);

  // logical positions: row r is chunk offset c = iq*block_q + r/G at
  // position pos0[b] + c
  const int c_lo = iq * block_q;
  const int c_hi = min(c_lo + block_q, C) - 1;
  const int base = pos0[b];
  const int qpos_min = base + c_lo;
  const int qpos_max = base + c_hi;
  const int limit = min(seq_lens[b], base + C);
  // pages holding a key some row may attend: [blk_lo, blk_hi)
  const int kv_end = min(qpos_max + 1, limit);
  const int blk_hi = kv_end > 0 ? min(n_blocks, (kv_end + page - 1) / page)
                                : 0;
  const int blk_lo = window > 0 ? max(0, qpos_min - window + 1) / page : 0;

  for (int i = threadIdx.x; i < R * Dh; i += THREADS) {
    const int r = i / Dh, d = i % Dh;
    const int c = c_lo + r / G, g = r % G;
    float v = 0.f;
    if (c < C) {
      const float qv =
          to_f32(q[((((size_t)b * C + c) * Hkv + h) * G + g) * Dh + d]);
      v = QUANT ? round_to<__nv_bfloat16>(qv) : qv;
    }
    s.q[i] = v;
    s.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += THREADS) {
    s.m[r] = NEG_INF;
    s.l[r] = 0.f;
  }

  for (int b0 = blk_lo; b0 < blk_hi; b0 += step_pages) {
    const int nt = min(step_pages, blk_hi - b0) * page;  // tokens this step
    const int kv0 = b0 * page;

    __syncthreads();  // the previous step's readers are done
    for (int i = threadIdx.x; i < nt * Dh; i += THREADS) {
      const int t = i / Dh, d = i % Dh;
      const size_t pg = (size_t)block_tables[(size_t)b * n_blocks + b0 +
                                             t / page];
      const size_t src = ((pg * page + t % page) * Hkv + h) * Dh + d;
      s.k[t * kstride + d] = to_f32(k_pages[src]);
      s.v[i] = to_f32(v_pages[src]);
    }
    if (QUANT) {
      for (int t = threadIdx.x; t < nt; t += THREADS) {
        const size_t pg = (size_t)block_tables[(size_t)b * n_blocks + b0 +
                                               t / page];
        const size_t src = (pg * page + t % page) * Hkv + h;
        s.ks[t] = __bfloat162float(k_scale[src]);
        s.vs[t] = __bfloat162float(v_scale[src]);
      }
    }
    __syncthreads();

    // scores with the causal / valid-length / window mask
    for (int i = threadIdx.x; i < R * nt; i += THREADS) {
      const int r = i / nt, t = i % nt;
      const float* qr = s.q + r * Dh;
      const float* kt = s.k + t * kstride;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kt[d], dot);
      float sc = dot * sm_scale;
      if (QUANT) sc *= s.ks[t];
      const int qpos = base + c_lo + r / G;
      const int kv = kv0 + t;
      bool valid = kv <= qpos && kv < limit;
      if (window > 0) valid = valid && kv > qpos - window;
      s.p[r * T + t] = valid ? sc : NEG_INF;
    }
    __syncthreads();

    // online-softmax update: TPR threads per row; p becomes the PV weights
    const int r = threadIdx.x / TPR, j = threadIdx.x % TPR;
    float* pr = s.p + r * T;
    if (r < R) {
      float mx = NEG_INF;
      for (int t = j; t < nt; t += TPR) mx = fmaxf(mx, pr[t]);
      s.red[r * TPR + j] = mx;
    }
    __syncthreads();
    float m_new = 0.f, corr = 0.f;
    if (r < R) {
      m_new = s.m[r];
      for (int jj = 0; jj < TPR; ++jj) m_new = fmaxf(m_new, s.red[r * TPR + jj]);
      corr = expf(s.m[r] - m_new);
    }
    __syncthreads();  // every thread of the row has read m and red
    if (r < R) {
      float sum = 0.f;
      for (int t = j; t < nt; t += TPR) {
        float p = expf(pr[t] - m_new);
        sum += p;
        if (QUANT) {
          p = round_to<__nv_bfloat16>(p * s.vs[t]);
        } else {
          p = round_to<KT>(p);
        }
        pr[t] = p;
      }
      s.red[r * TPR + j] = sum;
    }
    __syncthreads();
    if (r < R && j == 0) {
      float sum = 0.f;
      for (int jj = 0; jj < TPR; ++jj) sum += s.red[r * TPR + jj];
      s.l[r] = s.l[r] * corr + sum;
      s.m[r] = m_new;
      s.corr[r] = corr;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < R * Dh; i += THREADS) {
      const int rr = i / Dh, d = i % Dh;
      const float* prr = s.p + rr * T;
      float pv = 0.f;
      for (int t = 0; t < nt; ++t) pv = fmaf(prr[t], s.v[t * Dh + d], pv);
      s.acc[i] = s.acc[i] * s.corr[rr] + pv;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < R * Dh; i += THREADS) {
    const int r = i / Dh, d = i % Dh;
    const int c = c_lo + r / G, g = r % G;
    if (c >= C) continue;
    out[((((size_t)b * C + c) * Hkv + h) * G + g) * Dh + d] =
        s.acc[i] / fmaxf(s.l[r], 1e-30f);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* pos0, const void* seq_lens, void* out, int B, int C,
           int Hkv, int G, int Dh, int page, int n_blocks, int block_q,
           int window, float sm_scale, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KT>;
  const int R = block_q * G;
  if (R > THREADS) return (int)cudaErrorInvalidValue;
  // the device's opt-in limit, and the kernel allowed to use all of it,
  // once per instantiation
  static int max_smem = 0;
  if (max_smem == 0) {
    int device = 0, limit = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return (int)err;
    max_smem = limit;
  }
  // as many pages per step as fit, up to the step's token target
  int step_pages = PREFILL_STEP_TOKENS > page ? PREFILL_STEP_TOKENS / page
                                              : 1;
  size_t smem = 0;
  for (;; --step_pages) {
    if (step_pages < 1) return (int)cudaErrorInvalidValue;
    Smem sizes_only;
    smem = sizeof(float) * carve(nullptr, R, Dh, step_pages * page,
                                 THREADS / R, &sizes_only);
    if (smem <= (size_t)max_smem) break;
  }
  const dim3 grid((C + block_q - 1) / block_q, Hkv, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(block_tables), static_cast<const int*>(pos0),
      static_cast<const int*>(seq_lens), static_cast<float*>(out), C, Hkv, G,
      Dh, page, n_blocks, block_q, step_pages, window, sm_scale);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scale, const void* v_scale,
             const void* block_tables, const void* pos0, const void* seq_lens,
             void* out, int B, int C, int Hkv, int G, int Dh, int page,
             int n_blocks, int block_q, int window, float sm_scale,
             int q_dtype, int pool_dtype, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || G <= 0 || Dh <= 0 || page <= 0 ||
      n_blocks <= 0 || block_q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (q_dtype != 0 && q_dtype != 1) return (int)cudaErrorInvalidValue;
  if (pool_dtype < 0 || pool_dtype > 2) return (int)cudaErrorInvalidValue;
  if (pool_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IMAGINE_PA_LAUNCH(QT, KT)                                            \
  return launch<QT, KT>(q, k_pages, v_pages, k_scale, v_scale,             \
                        block_tables, pos0, seq_lens, out, B, C, Hkv, G, Dh, \
                        page, n_blocks, block_q, window, sm_scale, s)
  if (q_dtype == 0) {
    if (pool_dtype == 0) IMAGINE_PA_LAUNCH(float, float);
    if (pool_dtype == 1) IMAGINE_PA_LAUNCH(float, __nv_bfloat16);
    IMAGINE_PA_LAUNCH(float, int8_t);
  }
  if (pool_dtype == 0) IMAGINE_PA_LAUNCH(__nv_bfloat16, float);
  if (pool_dtype == 1) IMAGINE_PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  IMAGINE_PA_LAUNCH(__nv_bfloat16, int8_t);
#undef IMAGINE_PA_LAUNCH
}


// ------------------------------------------- prefill, route tensor_core
// Shared memory.  bf16 pools: two stages of [K][V] bf16 tiles ([BKV][D],
// swizzled), the query rows passing through stage 1's K slot.  int8
// pools: two stages of [K][V] int8 tiles ([BKV][D] bytes), the bf16 K and
// V tiles they widen into (the query rows pass through the K one), and the
// step's K and V scales as float32.
template <int D, bool QUANT>
struct PfLayout {
  static constexpr int TILE = tca::Swz<D>::TILE_BYTES;
  static constexpr int STAGE = 2 * tca::BKV * D * (QUANT ? 1 : 2);
  static constexpr int WIDE = 2 * STAGE;
  static constexpr int SCALES = WIDE + 2 * TILE;
  static constexpr int BYTES = QUANT ? SCALES + 2 * tca::BKV * 4 : WIDE;
  static constexpr int Q_SLOT = QUANT ? WIDE : STAGE;
};

// One int8 [BKV][D] tile widened to a swizzled bf16 tile: each code c as
// the float 2^23 + (c + 128) (its biased byte under the exponent), less
// 2^23 + 128, which is exact and exact again in bf16.
template <int D>
__device__ __forceinline__ void widen(const uint8_t* raw, uint8_t* wide,
                                      int tid) {
  using Sw = tca::Swz<D>;
  constexpr int PER_ROW = D / 16;   // 16 codes a read
  constexpr int READS = tca::BKV * PER_ROW / tca::THREADS;
#pragma unroll
  for (int it = 0; it < READS; ++it) {
    const int i = it * tca::THREADS + tid;
    const int t = i / PER_ROW, c = i % PER_ROW;
    const uint4 codes = *reinterpret_cast<const uint4*>(raw + t * D + 16 * c);
    const uint32_t words[4] = {codes.x, codes.y, codes.z, codes.w};
    uint32_t pairs[8];
#pragma unroll
    for (int wd = 0; wd < 4; ++wd) {
      const uint32_t biased = words[wd] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | j)) -
               8388736.f;
      }
      pairs[2 * wd] = tca::pack(f[0], f[1]);
      pairs[2 * wd + 1] = tca::pack(f[2], f[3]);
    }
    *reinterpret_cast<uint4*>(wide + Sw::off(t, 2 * c)) =
        make_uint4(pairs[0], pairs[1], pairs[2], pairs[3]);
    *reinterpret_cast<uint4*>(wide + Sw::off(t, 2 * c + 1)) =
        make_uint4(pairs[4], pairs[5], pairs[6], pairs[7]);
  }
}

// Grid (query blocks, Hkv, B); block_q * G <= 64 rows a block.
template <int D, bool QUANT>
__global__ void __launch_bounds__(tca::THREADS, 2) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_pages,
    const uint8_t* __restrict__ v_pages,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ pos0,
    const int* __restrict__ seq_lens, float* __restrict__ out, int C,
    int Hkv, int G, int page, int n_blocks, int block_q, int window,
    float sm_scale) {
  using L = PfLayout<D, QUANT>;
  using Sw = tca::Swz<D>;
  constexpr int BKV_ = tca::BKV, THREADS_ = tca::THREADS;
  constexpr int ES = QUANT ? 1 : 2;        // bytes a pool element
  constexpr int RCH = D * ES / 16;         // 16-byte chunks a pool row
  extern __shared__ __align__(128) uint8_t pf_tc_smem[];
  uint8_t* sm = pf_tc_smem;
  const uint32_t base = tc::smem_u32(sm);
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // logical positions: row r is chunk offset c = iq*block_q + r/G at
  // position pos0[b] + c; keys valid below limit
  const int rows = block_q * G;
  const int c_lo = iq * block_q;
  const int c_hi = min(c_lo + block_q, C) - 1;
  const int pbase = pos0[b];
  const int limit = min(seq_lens[b], pbase + C);
  // keys some row may attend: [kv_lo, kv_end), from a page boundary
  const int kv_end = min(min(pbase + c_hi + 1, limit), n_blocks * page);
  const int kv_lo =
      window > 0 ? max(0, pbase + c_lo - window + 1) / page * page : 0;
  const int n_steps = kv_end > kv_lo ? (kv_end - kv_lo + BKV_ - 1) / BKV_
                                     : 0;
  const int* bt = block_tables + (size_t)b * n_blocks;

  // the page rows of keys kv0 .. kv0 + BKV - 1 into stage st; keys past
  // the walk's end are zeros
  auto gather = [&](int st, int kv0) {
    const uint32_t kd = base + st * L::STAGE, vd = kd + L::STAGE / 2;
    constexpr int COPIES = BKV_ * RCH / THREADS_;
    static_assert(COPIES * THREADS_ == BKV_ * RCH, "whole rows a step");
#pragma unroll
    for (int it = 0; it < COPIES; ++it) {
      const int i = it * THREADS_ + tid;
      const int t = i / RCH, c = i % RCH;
      const int kv = kv0 + t;
      const bool ok = kv < kv_end;
      size_t src = 0;
      if (ok) {
        src = (((size_t)bt[kv / page] * page + kv % page) * Hkv + h) *
                  (D * ES) + 16 * c;
      }
      const int dst = QUANT ? t * D + 16 * c : Sw::off(t, c);
      tc::cp_async<16>(kd + dst, k_pages + src, ok);
      tc::cp_async<16>(vd + dst, v_pages + src, ok);
    }
  };
  // int8 pools: thread tid holds the K (tid < 64) or V scale of key
  // kv0 + tid % 64, read a step ahead of its use
  auto scale_of = [&](int kv0) {
    const int kv = kv0 + tid % BKV_;
    if (kv >= kv_end) return 0.f;
    const __nv_bfloat16* sc = tid < BKV_ ? k_scale : v_scale;
    return __bfloat162float(
        sc[((size_t)bt[kv / page] * page + kv % page) * Hkv + h]);
  };

  {
    constexpr int COPIES = tca::BQ * Sw::CH / THREADS_;
#pragma unroll
    for (int it = 0; it < COPIES; ++it) {
      const int i = it * THREADS_ + tid;
      const int r = i / Sw::CH, c = i % Sw::CH;
      const int cq = c_lo + r / G;
      const bool ok = r < rows && cq < C;
      const __nv_bfloat16* src =
          q + (ok ? ((((size_t)b * C + cq) * Hkv + h) * G + r % G) * D +
                        8 * c
                  : 0);
      tc::cp_async<16>(base + L::Q_SLOT + Sw::off(r, c), src, ok);
    }
  }
  tc::cp_async_commit();
  float scale_cur = 0.f;
  if (n_steps > 0) {
    gather(0, kv_lo);
    if constexpr (QUANT) scale_cur = scale_of(kv_lo);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();
  tca::Warp<D> w;
  tca::load_q(w, base + L::Q_SLOT, 16 * warp, lane);
  __syncthreads();  // every warp holds its rows: the slot may be refilled

  const int r0 = 16 * warp + lane / 4;   // rows r0 and r0 + 8
  const int qpos[2] = {pbase + c_lo + r0 / G, pbase + c_lo + (r0 + 8) / G};
  const int t2 = 2 * (lane % 4);
  float* scales = reinterpret_cast<float*>(sm + L::SCALES);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    const int kv0 = kv_lo + i * BKV_;
    float scale_next = 0.f;
    if (i + 1 < n_steps) {
      gather(st ^ 1, kv0 + BKV_);
      if constexpr (QUANT) scale_next = scale_of(kv0 + BKV_);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // step i has landed for this thread ...
    __syncthreads();         // ... and for all
    uint32_t kt = base + st * L::STAGE, vt = kt + L::STAGE / 2;
    if constexpr (QUANT) {
      widen<D>(sm + st * L::STAGE, sm + L::WIDE, tid);
      widen<D>(sm + st * L::STAGE + L::STAGE / 2, sm + L::WIDE + L::TILE,
               tid);
      scales[tid] = scale_cur;   // [0, 64): K scales, [64, 128): V scales
      __syncthreads();
      kt = base + L::WIDE;
      vt = kt + L::TILE;
    }

    float s[BKV_ / 8][4];
    tca::scores(w, kt, lane, s);
#pragma unroll
    for (int j = 0; j < BKV_ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + t2 + (e & 1);
        const int kv = kv0 + col;
        const int qp = qpos[e >> 1];
        float sc = s[j][e] * sm_scale;
        if constexpr (QUANT) sc *= scales[col];
        bool valid = kv <= qp && kv < limit;
        if (window > 0) valid = valid && kv > qp - window;
        s[j][e] = valid ? sc : tca::NEG_INF;
      }
    }
    tca::update<D, QUANT>(w, s, vt, scales + BKV_, lane);
    __syncthreads();  // every warp is done with this step's tiles
    scale_cur = scale_next;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    const int cq = c_lo + r / G;
    if (r >= rows || cq >= C) continue;
    float* dst = out + ((((size_t)b * C + cq) * Hkv + h) * G + r % G) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j + t2) =
          make_float2(tca::out_value(w, j, 2 * hh),
                      tca::out_value(w, j, 2 * hh + 1));
    }
  }
}

template <int D, bool QUANT>
int launch_prefill_tc(const void* q, const void* k_pages, const void* v_pages,
                      const void* k_scale, const void* v_scale,
                      const void* block_tables, const void* pos0,
                      const void* seq_lens, void* out, int B, int C, int Hkv,
                      int G, int page, int n_blocks, int block_q, int window,
                      float sm_scale, cudaStream_t stream) {
  auto kernel = paged_prefill_tc_kernel<D, QUANT>;
  constexpr int smem = PfLayout<D, QUANT>::BYTES;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((C + block_q - 1) / block_q, Hkv, B);
  kernel<<<grid, tca::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(k_pages),
      static_cast<const uint8_t*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(block_tables), static_cast<const int*>(pos0),
      static_cast<const int*>(seq_lens), static_cast<float*>(out), C, Hkv, G,
      page, n_blocks, block_q, window, sm_scale);
  return (int)cudaGetLastError();
}

template <bool QUANT>
int dispatch_prefill_tc(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scale,
                        const void* v_scale, const void* block_tables,
                        const void* pos0, const void* seq_lens, void* out,
                        int B, int C, int Hkv, int G, int Dh, int page,
                        int n_blocks, int block_q, int window,
                        float sm_scale, cudaStream_t stream) {
#define IMAGINE_PF_TC(D)                                                    \
  return launch_prefill_tc<D, QUANT>(q, k_pages, v_pages, k_scale, v_scale, \
                                     block_tables, pos0, seq_lens, out, B,  \
                                     C, Hkv, G, page, n_blocks, block_q,    \
                                     window, sm_scale, stream)
  switch (Dh) {
    case 32: IMAGINE_PF_TC(32);
    case 64: IMAGINE_PF_TC(64);
    case 128: IMAGINE_PF_TC(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IMAGINE_PF_TC
}


// ------------------------------------------------------------------ decode
// Split-KV (flash-decoding) design; the note at the top of the file says
// why.  Kernel 1 writes each split's (m, l, acc), kernel 2 combines them.
constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_HEADS = DEC_WARPS;         // query heads a pass: 1 a warp
constexpr int DEC_MAX_DPL = 16;              // Dh <= 32 * 16
constexpr int DEC_MAX_TOKENS = 64;           // keys a split, at most
constexpr int DEC_TILE_ELEMS = 64 * 128;     // split_tokens * Dh, at most
constexpr int DEC_SMEM_MAX =                 // float32 pools' tiles + p
    (int)sizeof(float) * (2 * DEC_TILE_ELEMS + DEC_HEADS * DEC_MAX_TOKENS);
constexpr int COMBINE_THREADS = 128;

// Keys a split holds for DPL head-dim elements a lane (Dh <= 32 * DPL):
// the K and V tiles stay at DEC_TILE_ELEMS elements each
// (kernels/paged_attention/kernel.py, `decode_split_tokens`).
template <int DPL>
__host__ __device__ constexpr int dec_tokens() {
  return DPL <= 4 ? DEC_MAX_TOKENS : DEC_TILE_ELEMS / (32 * DPL);
}

struct DecodeArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const __nv_bfloat16* k_scale;
  const __nv_bfloat16* v_scale;
  const int* block_tables;
  const int* cur_pos;
  float* out;
  float* acc;   // (B, Hkv, splits, G, Dh)
  float* ml;    // (B, Hkv, splits, G, 2): m, l
  int B, Hkv, G, Dh, page, n_blocks, splits, split_tokens, window;
  float sm_scale;
};

// The keys lane b attends: [*lo, *hi), at most the block table's capacity.
__device__ __forceinline__ void decode_range(const DecodeArgs& a, int b,
                                             int* lo, int* hi) {
  const int cur = a.cur_pos[b];
  *hi = min(cur + 1, a.n_blocks * a.page);
  *lo = a.window > 0 ? max(0, cur - a.window + 1) : 0;
}

// Sum of v[i] over the warp's 32 lanes for the 8 heads at once, by
// recursive halving: 9 shuffles.  Lane l returns head (l >> 2) & 7's sum.
__device__ __forceinline__ float reduce_heads(float (&v)[DEC_HEADS],
                                              int lane) {
  static_assert(DEC_HEADS == 8, "three halving steps");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = lane & 16;
    const float send = up ? v[i] : v[i + 4];
    v[i] = (up ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool up = lane & 8;
    const float send = up ? v[i] : v[i + 2];
    v[i] = (up ? v[i + 2] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  {
    const bool up = lane & 4;
    const float send = up ? v[0] : v[1];
    v[0] = (up ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return v[0];
}

// One pass's queries, cast as the TPU kernel casts them: lane holds
// elements lane + 32 j of heads g0 .. g0 + 7 (zeros past G and Dh).
template <typename QT, typename KT, int DPL>
__device__ __forceinline__ void load_queries(const QT* __restrict__ qg,
                                             int g0, int G, int Dh, int lane,
                                             float (&qr)[DEC_HEADS][DPL]) {
  constexpr bool QUANT = sizeof(KT) == 1;
#pragma unroll
  for (int i = 0; i < DEC_HEADS; ++i) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      float v = 0.f;
      if (g0 + i < G && d < Dh) {
        const float qv = to_f32(qg[(size_t)(g0 + i) * Dh + d]);
        v = QUANT ? round_to<__nv_bfloat16>(qv) : round_to<KT>(qv);
      }
      qr[i][j] = v;
    }
  }
}

// Grid (splits, Hkv, B): split sp of lane b's keys for KV head h, all G of
// its query heads, DEC_HEADS a pass.  DPL = head-dim elements a lane.
template <typename QT, typename KT, int DPL>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_split_kernel(const DecodeArgs a, int vec16) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int T = dec_tokens<DPL>();
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Dh = a.Dh, G = a.G;
  int kv_lo, kv_hi;
  decode_range(a, b, &kv_lo, &kv_hi);
  const int k0 = sp * T;
  // the split's rows that hold an attended key: [lo, hi)
  const int lo = max(k0, kv_lo) - k0, hi = min(k0 + T, kv_hi) - k0;
  if (lo >= hi) return;   // the combine never reads this split

  extern __shared__ __align__(16) unsigned char dec_raw[];
  KT* kt = reinterpret_cast<KT*>(dec_raw);   // [T][Dh] K rows, pool dtype
  KT* vt = kt + T * Dh;                      // [T][Dh] V rows
  float* pt = reinterpret_cast<float*>(      // [DEC_HEADS][T] scores, then
      dec_raw + 2 * T * Dh * sizeof(KT));    // weights (16-byte aligned)
  __shared__ float kscl[T], vscl[T];         // int8 pools' scales
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const KT* kp = static_cast<const KT*>(a.k_pages);
  const KT* vp = static_cast<const KT*>(a.v_pages);
  const int* bt = a.block_tables + (size_t)b * a.n_blocks;
  // pool element of row t's (page row, head) start, through the table
  auto row = [&](int t) {
    const int key = k0 + t;
    return (((size_t)bt[key / a.page] * a.page + key % a.page) * a.Hkv +
            h) * Dh;
  };

  // the attended rows' K and V into shared memory as they are: 16-byte
  // cp.async, all in flight at once, where rows and pools allow
  if (vec16) {
    constexpr int E = 16 / (int)sizeof(KT);
    const int per_row = Dh / E, half = T * per_row;
    const uint32_t base = tc::smem_u32(dec_raw);
    for (int i = tid; i < 2 * half; i += DEC_THREADS) {
      const int j = i % half, t = j / per_row;
      if (t < lo || t >= hi) continue;
      const size_t off = row(t) + (j % per_row) * E;
      tc::cp_async<16>(base + (i < half ? 0 : T * Dh * sizeof(KT)) +
                           j * 16,
                       (i < half ? kp : vp) + off, true);
    }
    tc::cp_async_commit();
  } else {
    for (int i = tid; i < 2 * T * Dh; i += DEC_THREADS) {
      const int j = i % (T * Dh), t = j / Dh;
      if (t >= lo && t < hi) {
        (i < T * Dh ? kt : vt)[j] = (i < T * Dh ? kp : vp)[row(t) + j % Dh];
      }
    }
  }
  // under the copies: the int8 pools' scales and the first pass's queries
  if (QUANT && tid < T) {
    float ksv = 0.f, vsv = 0.f;
    if (tid >= lo && tid < hi) {
      const size_t o = row(tid) / Dh;
      ksv = __bfloat162float(a.k_scale[o]);
      vsv = __bfloat162float(a.v_scale[o]);
    }
    kscl[tid] = ksv;
    vscl[tid] = vsv;
  }
  const QT* qg =
      static_cast<const QT*>(a.q) + ((size_t)b * a.Hkv + h) * G * Dh;
  float qr[DEC_HEADS][DPL];
  load_queries<QT, KT, DPL>(qg, 0, G, Dh, lane, qr);
  if (vec16) tc::cp_async_wait<0>();
  __syncthreads();

  const size_t split_row = ((size_t)b * a.Hkv + h) * a.splits + sp;
  for (int g0 = 0; g0 < G; g0 += DEC_HEADS) {
    if (g0 > 0) load_queries<QT, KT, DPL>(qg, g0, G, Dh, lane, qr);
    // scores: a warp per row, lanes across Dh, one reduction for 8 heads
#pragma unroll
    for (int u = 0; u < T / DEC_WARPS; ++u) {
      const int t = warp + DEC_WARPS * u;
      if (t < lo || t >= hi) {
        if (lane < DEC_HEADS) pt[lane * T + t] = NEG_INF;
        continue;
      }
      float kd[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        kd[j] = d < Dh ? to_f32(kt[t * Dh + d]) : 0.f;
      }
      float v[DEC_HEADS];
#pragma unroll
      for (int i = 0; i < DEC_HEADS; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) dot = fmaf(qr[i][j], kd[j], dot);
        v[i] = dot;
      }
      const float dot = reduce_heads(v, lane);
      if ((lane & 3) == 0) {
        float sc = dot * a.sm_scale;
        if (QUANT) sc *= kscl[t];
        pt[((lane >> 2) & 7) * T + t] = sc;
      }
    }
    __syncthreads();

    // the split's softmax, a warp per head: m, l to scratch; p becomes the
    // PV weight (times the V scale, or rounded to the pool dtype); then
    // p . v, the same warp, lanes across Dh
    {
      const int g = g0 + warp;
      float* pr = pt + warp * T;
      float mx = NEG_INF;
#pragma unroll
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, pr[t]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      float sum = 0.f;
#pragma unroll
      for (int t = lane; t < T; t += 32) {
        const float e = expf(pr[t] - mx);
        sum += e;
        pr[t] = QUANT ? e * vscl[t] : round_to<KT>(e);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      __syncwarp();
      if (g < G) {
        if (lane == 0) {
          a.ml[(split_row * G + g) * 2] = mx;
          a.ml[(split_row * G + g) * 2 + 1] = sum;
        }
        float o[DPL];
#pragma unroll
        for (int j = 0; j < DPL; ++j) o[j] = 0.f;
#pragma unroll 8
        for (int t = lo; t < hi; ++t) {
          const float w = pr[t];
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            const int d = lane + 32 * j;
            if (d < Dh) o[j] = fmaf(w, to_f32(vt[t * Dh + d]), o[j]);
          }
        }
        float* dst = a.acc + (split_row * G + g) * Dh;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < Dh) dst[d] = o[j];
        }
      }
    }
    __syncthreads();   // the next pass rewrites pt
  }
}

// Grid (ceil(G * Dh / COMBINE_THREADS), Hkv, B): out = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30), w_s = exp(m_s - max m), over the splits that
// hold an attended key, in split order.
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_decode_combine_kernel(const DecodeArgs a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= a.G * a.Dh) return;
  const int g = i / a.Dh, d = i % a.Dh;
  int kv_lo, kv_hi;
  decode_range(a, b, &kv_lo, &kv_hi);
  const size_t bh = (size_t)b * a.Hkv + h;
  float o = 0.f, l = 0.f;
  if (kv_hi > kv_lo) {
    const int s_lo = kv_lo / a.split_tokens;
    const int s_hi = (kv_hi - 1) / a.split_tokens;
    float m = NEG_INF;
    for (int s = s_lo; s <= s_hi; ++s) {
      m = fmaxf(m, a.ml[((bh * a.splits + s) * a.G + g) * 2]);
    }
    for (int s = s_lo; s <= s_hi; ++s) {
      const size_t r = (bh * a.splits + s) * a.G + g;
      const float w = expf(a.ml[2 * r] - m);
      l += w * a.ml[2 * r + 1];
      o += w * a.acc[r * a.Dh + d];
    }
  }
  a.out[(bh * a.G + g) * a.Dh + d] = o / fmaxf(l, 1e-30f);
}

template <typename QT, typename KT, int DPL>
int launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  constexpr int T = dec_tokens<DPL>();
  if (a.split_tokens != T) return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_split_kernel<QT, KT, DPL>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DEC_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem =
      2 * (size_t)T * a.Dh * sizeof(KT) + sizeof(float) * DEC_HEADS * T;
  const int vec16 =
      (a.Dh * (int)sizeof(KT)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(a.k_pages) |
       reinterpret_cast<uintptr_t>(a.v_pages)) % 16 == 0;
  kernel<<<dim3(a.splits, a.Hkv, a.B), DEC_THREADS, smem, stream>>>(a,
                                                                     vec16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<<<
      dim3((a.G * a.Dh + COMBINE_THREADS - 1) / COMBINE_THREADS, a.Hkv,
           a.B),
      COMBINE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int decode_dpl(const DecodeArgs& a, cudaStream_t stream) {
  if (a.Dh <= 32) return launch_decode<QT, KT, 1>(a, stream);
  if (a.Dh <= 64) return launch_decode<QT, KT, 2>(a, stream);
  if (a.Dh <= 128) return launch_decode<QT, KT, 4>(a, stream);
  if (a.Dh <= 256) return launch_decode<QT, KT, 8>(a, stream);
  return launch_decode<QT, KT, 16>(a, stream);
}

}  // namespace

// Decode: q (B, Hkv, G, Dh) at positions cur_pos (B,) -> out (B, Hkv, G, Dh)
// float32, through `splits` splits of `split_tokens` keys (splits *
// split_tokens >= n_blocks * page > (splits - 1) * split_tokens; at most
// 16 * 512 / Dh keys, Dh <= 512).  acc (B, Hkv, splits, G, Dh) and ml (B,
// Hkv, splits, G, 2) are float32 scratch.  Two kernels on `stream`, no
// host synchronisation.  Returns a cudaError_t.
extern "C" int imagine_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* cur_pos, void* out, void* acc, void* ml, int B, int Hkv,
    int G, int Dh, int page, int n_blocks, int splits, int split_tokens,
    int window, float sm_scale, int q_dtype, int pool_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || Dh <= 0 || Dh > 32 * DEC_MAX_DPL ||
      page <= 0 || n_blocks <= 0 || split_tokens <= 0 ||
      split_tokens * Dh > DEC_TILE_ELEMS ||
      split_tokens > DEC_MAX_TOKENS || acc == nullptr || ml == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long cap = (long long)n_blocks * page;
  if (splits != (cap + split_tokens - 1) / split_tokens) {
    return (int)cudaErrorInvalidValue;
  }
  if (q_dtype != 0 && q_dtype != 1) return (int)cudaErrorInvalidValue;
  if (pool_dtype < 0 || pool_dtype > 2) return (int)cudaErrorInvalidValue;
  if (pool_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const DecodeArgs a{q, k_pages, v_pages,
                     static_cast<const __nv_bfloat16*>(k_scale),
                     static_cast<const __nv_bfloat16*>(v_scale),
                     static_cast<const int*>(block_tables),
                     static_cast<const int*>(cur_pos),
                     static_cast<float*>(out), static_cast<float*>(acc),
                     static_cast<float*>(ml), B, Hkv, G, Dh, page, n_blocks,
                     splits, split_tokens, window, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) {
    if (pool_dtype == 0) return decode_dpl<float, float>(a, s);
    if (pool_dtype == 1) return decode_dpl<float, __nv_bfloat16>(a, s);
    return decode_dpl<float, int8_t>(a, s);
  }
  if (pool_dtype == 0) return decode_dpl<__nv_bfloat16, float>(a, s);
  if (pool_dtype == 1) return decode_dpl<__nv_bfloat16, __nv_bfloat16>(a, s);
  return decode_dpl<__nv_bfloat16, int8_t>(a, s);
}

// Chunked prefill, route cuda_core: q (B, C, Hkv, G, Dh) at positions
// pos0[b] + [0, C), keys valid below min(seq_lens[b], pos0[b] + C) -> out
// (B, C, Hkv, G, Dh) float32, block_q chunk offsets per block (block_q * G
// must not exceed 256).  Returns a cudaError_t.
extern "C" int imagine_paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos0, const void* seq_lens, void* out, int B, int C, int Hkv,
    int G, int Dh, int page, int n_blocks, int block_q, int window,
    float sm_scale, int q_dtype, int pool_dtype, void* stream) {
  if (seq_lens == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(q, k_pages, v_pages, k_scale, v_scale, block_tables, pos0,
                  seq_lens, out, B, C, Hkv, G, Dh, page, n_blocks, block_q,
                  window, sm_scale, q_dtype, pool_dtype, stream);
}

// Chunked prefill, route tensor_core: as above with q bfloat16, pools
// bfloat16 (pool_dtype 1) or int8 with bf16 scales (pool_dtype 2), Dh in
// {32, 64, 128}, block_q * G at most 64, q and the pools 16-byte aligned.
// Returns a cudaError_t.
extern "C" int imagine_paged_prefill_attention_tc(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos0, const void* seq_lens, void* out, int B, int C, int Hkv,
    int G, int Dh, int page, int n_blocks, int block_q, int window,
    float sm_scale, int pool_dtype, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || G <= 0 || page <= 0 || n_blocks <= 0 ||
      block_q <= 0 || block_q * G > tca::BQ || seq_lens == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k_pages) |
                          reinterpret_cast<uintptr_t>(v_pages) |
                          reinterpret_cast<uintptr_t>(out);
  if (addrs % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 1) {
    return dispatch_prefill_tc<false>(q, k_pages, v_pages, nullptr, nullptr,
                                      block_tables, pos0, seq_lens, out, B, C,
                                      Hkv, G, Dh, page, n_blocks, block_q,
                                      window, sm_scale, s);
  }
  if (pool_dtype == 2 && k_scale != nullptr && v_scale != nullptr) {
    return dispatch_prefill_tc<true>(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, pos0, seq_lens, out, B, C,
                                     Hkv, G, Dh, page, n_blocks, block_q,
                                     window, sm_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
