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
// query rows and at the port's sizes is bound by neither: it is small.
//
// What this simple design does about that:
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
// Numerics follow the TPU kernel cast for cast, because an ulp here can
// flip a greedy token:
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
//   * l accumulates p before the V-scale fold and the rounding.
// The online-softmax steps span several pages where the TPU kernel steps
// one page at a time: the same function, with the running max taken over
// more keys at once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// Chunked prefill: q (B, C, Hkv, G, Dh) at positions pos0[b] + [0, C), keys
// valid below min(seq_lens[b], pos0[b] + C) -> out (B, C, Hkv, G, Dh)
// float32, block_q chunk offsets per block (block_q * G must not exceed
// 256).  Returns a cudaError_t.
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
