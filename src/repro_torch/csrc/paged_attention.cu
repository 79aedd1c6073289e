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
// bound by device-memory bytes.  Prefill reuses each page for block_q*G
// query rows; at the serving path's shapes (8 lanes, a 32-token chunk,
// contexts of a few hundred tokens) its bytes and operations take about a
// microsecond on the card, so what bounds it is latency: the few steps of
// each block's walk over the pages, each a gather from device memory and
// a dependent chain of products and softmax.
//
// Prefill has two routes, picked in Python by dtype
// (`kernels/paged_attention/kernel.py`, `prefill_route`), each its own entry
// point; decode has one.
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
// Decode, and prefill's cuda_core route (float32 queries or pools):
// `paged_attention_kernel`, the first design:
//   * one block per (lane, KV head[, query block]) holds all G query heads
//     of its KV head, so each page is read from device memory once per
//     block and feeds every query row of the block;
//   * the block walks the lane's block table in a loop, which replaces the
//     TPU's sequential grid axis, several pages per step (step_pages, as
//     many as shared memory holds up to 128 tokens at decode, 64 at
//     prefill), so each step's loads, scores and softmax run wide and the
//     walk has few steps; the walk covers only the pages that hold a key
//     some row attends (causal bound, valid length, window): the others
//     contribute nothing to any row that attends at least one key, so the
//     result is the same;
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
//     scores and the V scale the probabilities (kernel.py:78-80, :92, :111);
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
// kernel steps one page at a time: the same function, with the running max
// taken over more keys at once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_attention.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int DECODE_STEP_TOKENS = 128;
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

template <typename QT, typename KT, bool DECODE>
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
  // position pos0[b] + c; decode has one offset at cur_pos = pos0[b]
  const int c_lo = iq * block_q;
  const int c_hi = min(c_lo + block_q, C) - 1;
  const int base = pos0[b];
  const int qpos_min = base + c_lo;
  const int qpos_max = base + c_hi;
  const int limit = DECODE ? qpos_max + 1 : min(seq_lens[b], base + C);
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
      if (QUANT) {
        v = round_to<__nv_bfloat16>(qv);
      } else if (DECODE) {
        v = round_to<KT>(qv);
      } else {
        v = qv;
      }
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
          p *= s.vs[t];
          if (!DECODE) p = round_to<__nv_bfloat16>(p);
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

template <typename QT, typename KT, bool DECODE>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* pos0, const void* seq_lens, void* out, int B, int C,
           int Hkv, int G, int Dh, int page, int n_blocks, int block_q,
           int window, float sm_scale, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KT, DECODE>;
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
  const int target = DECODE ? DECODE_STEP_TOKENS : PREFILL_STEP_TOKENS;
  int step_pages = target > page ? target / page : 1;
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
template <bool DECODE>
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
  return launch<QT, KT, DECODE>(q, k_pages, v_pages, k_scale, v_scale,       \
                                block_tables, pos0, seq_lens, out, B, C, Hkv, \
                                G, Dh, page, n_blocks, block_q, window,       \
                                sm_scale, s)
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

}  // namespace

// Decode: q (B, Hkv, G, Dh) at positions cur_pos (B,) -> out (B, Hkv, G, Dh)
// float32.  G must not exceed 256.  Returns a cudaError_t.
extern "C" int imagine_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* cur_pos, void* out, int B, int Hkv, int G, int Dh, int page,
    int n_blocks, int window, float sm_scale, int q_dtype, int pool_dtype,
    void* stream) {
  return dispatch<true>(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                        cur_pos, nullptr, out, B, 1, Hkv, G, Dh, page,
                        n_blocks, 1, window, sm_scale, q_dtype, pool_dtype,
                        stream);
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
  return dispatch<false>(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                         pos0, seq_lens, out, B, C, Hkv, G, Dh, page, n_blocks,
                         block_q, window, sm_scale, q_dtype, pool_dtype,
                         stream);
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
