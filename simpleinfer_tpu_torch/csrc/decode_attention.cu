// Per-row-length KV-cache decode attention (flash-decoding) for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind
// `decode_attention` (simpleinfer_tpu/kernels/decode_attn.py,
// pallas_call in `_decode_impl`). For each row n and kv head h, the G
// query heads grouped under h attend the cache positions
// j < min(lengths[n], bound):
//
//     s[g,j] = scale * q[n,h,g,:] . k[n,h,j,:]  (* k_scale[n,h,j])
//     m = max_j s,  l = sum_j exp(s - m),
//     o[g,:] = sum_j exp(s[g,j] - m) * v[n,h,j,:]  (* v_scale[n,h,j])
//
// returned UNNORMALIZED (o, m, l) in f32, with the finite sentinel
// m = -1e30 (and o = 0, l = 0) for a row with nothing to attend: the
// caller merges it with the decode block's scratch keys.
//
// What bounds it on an H100: one query per head against the whole cache
// is ~4 FLOPs per cache element read: bytes-bound (3.35 TB/s) by the KV
// read. The design:
//   - one block per (row, kv head) walks only that row's occupied
//     positions, in tiles of `block_k`: the per-row length bound the TPU
//     kernel gets by clamping its index maps (a young row stays cheap
//     next to an old one);
//   - each K/V tile is read once, coalesced in 16-byte loads (positions
//     are contiguous rows of D), and converted to f32 in shared memory;
//     the G grouped query heads share it (GQA: one read serves G heads);
//   - int8 leaves are dequantized in registers: the per-vector scale is
//     constant over head_dim, so it folds onto the scores (k) and onto
//     the probabilities (v); no f32 cache is ever materialized;
//   - the online softmax (running max, sum, accumulator) is f32, the
//     tile straddling the length is masked with the finite -1e30;
//   - the accumulator lives in shared memory, so any G * D fits.
// Splitting a long row over several blocks (split-K) is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/build.py) and called
//             through ctypes via `si_decode_attention`.

#include <math.h>

#include "epilogue.cuh"

namespace {

using namespace si;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr int MAX_SMEM = 232448;  // an H100 block's shared memory
constexpr int MAX_DEVICES = 64;   // devices with a remembered smem limit

size_t smem_bytes(int g, int d, int bk) {
  // Qs [G][D], Ks [BK][D+1], Vs [BK][D], S [G][BK], KS [BK], VS [BK],
  // Acc [G][D], m/l/alpha [G]
  return sizeof(float) * (size_t(g) * d + size_t(bk) * (d + 1) +
                          size_t(bk) * d + size_t(g) * bk + 2 * size_t(bk) +
                          size_t(g) * d + 3 * size_t(g));
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
si_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                 const float* __restrict__ ks, const TC* __restrict__ v,
                 const float* __restrict__ vs,
                 const int* __restrict__ lengths, float* __restrict__ o,
                 float* __restrict__ mo, float* __restrict__ lo, int KV,
                 int G, int L, int D, int bound, int BK, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [G][D]
  float* Ks = Qs + G * D;            // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* S = Vs + BK * D;            // [G][BK] scores, then probs
  float* KS = S + G * BK;            // [BK]
  float* VS = KS + BK;               // [BK]
  float* Acc = VS + BK;              // [G][D]
  float* Mr = Acc + G * D;           // [G] running max
  float* Lr = Mr + G;                // [G] running sum
  float* Al = Lr + G;                // [G] this tile's rescale

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = blockIdx.x / KV, h = blockIdx.x % KV;
  const bool quant = ks != nullptr;
  const int64_t row = static_cast<int64_t>(n) * KV + h;  // [N, KV] index
  const int len = max(0, min(min(lengths[n], bound), L));

  const TQ* qb = q + row * G * D;
  const TC* kb = k + row * L * D;
  const TC* vb = v + row * L * D;
  for (int e = tid; e < G * D; e += THREADS) {
    Qs[e] = to_f32(qb[e]);
    Acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    Mr[g] = NEG;
    Lr[g] = 0.0f;
  }

  for (int k0 = 0; k0 < len; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    // the tile's rows are contiguous: 16-byte loads when D allows
    constexpr int VEC = 16 / sizeof(TC);
    if (D % VEC == 0) {
      for (int e = tid; e < BK * D / VEC; e += THREADS) {
        const int c = (e * VEC) / D, d0 = (e * VEC) % D;
        const int j = k0 + c;
        alignas(16) TC kv[VEC];
        alignas(16) TC vv[VEC];
        if (j < len) {
          *reinterpret_cast<uint4*>(kv) =
              *reinterpret_cast<const uint4*>(kb + int64_t(j) * D + d0);
          *reinterpret_cast<uint4*>(vv) =
              *reinterpret_cast<const uint4*>(vb + int64_t(j) * D + d0);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          Ks[c * (D + 1) + d0 + i] = j < len ? to_f32(kv[i]) : 0.0f;
          Vs[c * D + d0 + i] = j < len ? to_f32(vv[i]) : 0.0f;
        }
      }
    } else {
      for (int e = tid; e < BK * D; e += THREADS) {
        const int c = e / D, dd = e % D;
        const int j = k0 + c;
        const bool in = j < len;
        Ks[c * (D + 1) + dd] = in ? to_f32(kb[int64_t(j) * D + dd]) : 0.0f;
        Vs[c * D + dd] = in ? to_f32(vb[int64_t(j) * D + dd]) : 0.0f;
      }
    }
    for (int c = tid; c < BK; c += THREADS) {
      const int j = k0 + c;
      const bool in = j < len;
      KS[c] = quant && in ? ks[row * L + j] : 1.0f;
      VS[c] = quant && in ? vs[row * L + j] : 1.0f;
    }
    __syncthreads();

    for (int e = tid; e < G * BK; e += THREADS) {
      const int g = e / BK, c = e % BK;
      float s = NEG;
      if (k0 + c < len) {
        const float* qr = Qs + g * D;
        const float* kr = Ks + c * (D + 1);
        float dot = 0.0f;
        for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        // (q . k_q) * k_s == q . (k_q * k_s): dequant on the score
        s = dot * scale * KS[c];
      }
      S[e] = s;
    }
    __syncthreads();

    // one warp per query head: tile max, probabilities, running sums
    for (int g = warp; g < G; g += WARPS) {
      float* sg = S + g * BK;
      float mt = NEG;
      for (int c = lane; c < BK; c += 32) mt = fmaxf(mt, sg[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_prev = Mr[g];
      const float m_new = fmaxf(m_prev, mt);
      float lt = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        // masked keys (s = -1e30) underflow to exactly 0: the tile holds
        // at least one live key, so m_new is a real score
        const float p = expf(sg[c] - m_new);
        lt += p;
        sg[c] = p * VS[c];  // fold the v scale onto the probability
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);  // 0 when m_prev = NEG
        Al[g] = alpha;
        Lr[g] = alpha * Lr[g] + lt;
        Mr[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * D; e += THREADS) {
      const int g = e / D, dd = e % D;
      const float* pg = S + g * BK;
      float a = Acc[e] * Al[g];
      for (int c = 0; c < BK; ++c) a = fmaf(pg[c], Vs[c * D + dd], a);
      Acc[e] = a;
    }
  }
  __syncthreads();

  float* ob = o + row * G * D;
  for (int e = tid; e < G * D; e += THREADS) ob[e] = Acc[e];
  for (int g = tid; g < G; g += THREADS) {
    mo[row * G + g] = Mr[g];
    lo[row * G + g] = Lr[g];
  }
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const float* ks,
                   const void* v, const float* vs, const int* lengths,
                   float* o, float* m, float* l, int N, int KV, int G, int L,
                   int D, int bound, int BK, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(G, D, BK);
  // allow the instance the card's whole per-block shared memory once per
  // device (the attribute is per device; the call costs host time, so
  // not on every launch)
  static bool limit_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !limit_set[dev]) {
    err = cudaFuncSetAttribute(si_decode_kernel<TQ, TC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) limit_set[dev] = true;
  }
  si_decode_kernel<TQ, TC><<<N * KV, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), ks,
      static_cast<const TC*>(v), vs, lengths, o, m, l, KV, G, L, D, bound,
      BK, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_cache(int c_dtype, const void* q, const void* k,
                           const float* ks, const void* v, const float* vs,
                           const int* lengths, float* o, float* m, float* l,
                           int N, int KV, int G, int L, int D, int bound,
                           int BK, float scale, cudaStream_t stream) {
  switch (c_dtype) {
    case DT_F32:
      return launch<TQ, float>(q, k, nullptr, v, nullptr, lengths, o, m, l,
                               N, KV, G, L, D, bound, BK, scale, stream);
    case DT_BF16:
      return launch<TQ, __nv_bfloat16>(q, k, nullptr, v, nullptr, lengths, o,
                                       m, l, N, KV, G, L, D, bound, BK,
                                       scale, stream);
    case DT_I8:
      if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return launch<TQ, int8_t>(q, k, ks, v, vs, lengths, o, m, l, N, KV, G,
                                L, D, bound, BK, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. q [N, KV, G, D] (f32/bf16), k and v
// [N, KV, L, D] (f32, bf16, or int8 with f32 [N, KV, L, 1] scales ks/vs),
// lengths int32 [N]; writes o [N, KV, G, D], m and l [N, KV, G, 1] (f32).
// Launches on `stream`, does not synchronise, allocates nothing; returns
// the cudaError_t of the launch.
extern "C" int si_decode_attention(const void* q, int q_dtype, const void* k,
                                   const void* ks, const void* v,
                                   const void* vs, int c_dtype,
                                   const void* lengths, void* o, void* m,
                                   void* l, int N, int KV, int G, int L,
                                   int D, int bound, int block_k, float scale,
                                   void* stream) {
  if (N <= 0 || KV <= 0 || G <= 0 || L < 0 || D <= 0 || block_k <= 0 ||
      smem_bytes(G, D, block_k) > MAX_SMEM)
    return cudaErrorInvalidValue;
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* lens = static_cast<const int*>(lengths);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case DT_F32:
      return dispatch_cache<float>(c_dtype, q, k, ksf, v, vsf, lens, of, mf,
                                   lf, N, KV, G, L, D, bound, block_k, scale,
                                   st);
    case DT_BF16:
      return dispatch_cache<__nv_bfloat16>(c_dtype, q, k, ksf, v, vsf, lens,
                                           of, mf, lf, N, KV, G, L, D, bound,
                                           block_k, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
