// Flash attention (online softmax) for Hopper.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (with its band helper
// `_band_first_block`) behind `flash_attention`
// (simpleinfer_tpu/kernels/attention.py, pallas_call in `_flash_impl`):
//
//     out[b,h,i,:] = softmax_j(scale * q[b,h,i,:] . k[b,h,j,:]) v[b,h,j,:]
//
// over the keys j live for query i: all of them, or j <= i (causal,
// Lq == Lk), or i - W < j <= i (a sliding window W). A query row with no
// live key gives 0, not NaN.
//
// What bounds it on an H100: prefill at L = 2048, head_dim 64 is
// ~2 * 2 * L^2 * D / 2 FLOPs per head (causal) against 4 * L * D bytes
// of q, k, v, out: hundreds of FLOPs per byte, so the operations bound
// it (989 TFLOP/s bf16 on tensor cores). This first kernel runs the two
// products in fp32 FMA on the CUDA cores (67 TFLOP/s at most), so it is
// bound by its own design; tensor cores (mma.sync / wgmma) and TMA are
// later work. What the design does:
//   - one block per (batch*head, 64-query tile); K/V walk in 64-key
//     tiles through shared memory; each query row keeps its running max,
//     sum and output accumulator in f32 registers (4 threads per row),
//     so the [Lq, Lk] scores never reach device memory;
//   - the causal grid stops at the diagonal tile, and a band starts at
//     the first tile it touches (floor(max(q0 - W + 1, 0) / 64), the
//     TPU's `_band_first_block`): dead tiles are neither read nor
//     computed;
//   - P·V runs in f32 (the TPU body casts P to the input dtype for its
//     bf16 MXU);
//   - head_dim is masked, not padded (the TPU pads D to 128): the
//     accumulator is sized by a compile-time bound (64, 128 or 256) and
//     the loops run to the real D (64 here, 24 in the qwen3-like test
//     model);
//   - q, k, v and out are strided views with a contiguous head dim, so
//     the caller's transposes cost no copies.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/build.py) and called
//             through ctypes via `si_flash_attention`.

#include <math.h>

#include "epilogue.cuh"

namespace {

using namespace si;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int RT = 4;         // threads per query row
constexpr int THREADS = BQ * RT;
constexpr int KPT = BK / RT;  // scores per thread per tile
constexpr int MAX_DEVICES = 64;  // devices with a remembered smem limit

struct Strides {
  int64_t b, h, l;
};

__host__ __device__ constexpr size_t smem_bytes(int d) {
  // Qs [BQ][d+1], Ks [BK][d+1], Vs [BK][d], Ps [BQ][BK+1] (f32)
  return sizeof(float) *
         (size_t(BQ) * (d + 1) + size_t(BK) * (d + 1) + size_t(BK) * d +
          size_t(BQ) * (BK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
si_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int H, int Lq,
                int Lk, int D, Strides sq, Strides sk, Strides sv,
                Strides so, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);             // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);             // [BK][D]
  float* Ps = Vs + BK * D;                   // [BQ][BK+1]

  const int tid = threadIdx.x;
  const int r = tid / RT;   // the block's query row of this thread
  const int j = tid % RT;   // its quarter of the keys and of head_dim
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + r;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int rr = e / D, dd = e % D;
    const int gi = q0 + rr;
    Qs[rr * (D + 1) + dd] = gi < Lq ? to_f32(qb[gi * sq.l + dd]) : 0.0f;
  }

  constexpr int NACC = DMAX / RT;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  float m_run = -INFINITY, l_run = 0.0f;

  const int n_tiles = (Lk + BK - 1) / BK;
  int t_first = 0, t_last = n_tiles - 1;
  if (causal) {
    t_last = min(t_last, (q0 + BQ - 1) / BK);
    if (window > 0) t_first = max(q0 - (window - 1), 0) / BK;
  }

  for (int t = t_first; t <= t_last; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, dd = e % D;
      const int gk = k0 + c;
      const bool in = gk < Lk;
      Ks[c * (D + 1) + dd] = in ? to_f32(kb[gk * sk.l + dd]) : 0.0f;
      Vs[c * D + dd] = in ? to_f32(vb[gk * sv.l + dd]) : 0.0f;
    }
    __syncthreads();

    // scores of this row against keys c = j + RT*i
    float s[KPT];
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int c = j + RT * i;
      const int kj = k0 + c;
      bool live = kj < Lk;
      if (causal) {
        live = live && kj <= qi;
        if (window > 0) live = live && kj > qi - window;
      }
      float dot = 0.0f;
      if (live) {
        const float* qr = Qs + r * (D + 1);
        const float* kr = Ks + c * (D + 1);
        for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        dot *= scale;
      }
      s[i] = live ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, s[i]);
    }
    // the RT threads of a row are neighbouring lanes of one warp
#pragma unroll
    for (int off = 1; off < RT; off <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    const float m_new = fmaxf(m_run, m_tile);
    // a row with no live key so far keeps m = -inf: exp(-inf - -inf)
    // would be NaN, so shift by 0 there
    const float safe_m = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = m_run == -INFINITY ? 0.0f : expf(m_run - safe_m);
    float l_tile = 0.0f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = s[i] == -INFINITY ? 0.0f : expf(s[i] - safe_m);
      Ps[r * (BK + 1) + j + RT * i] = p;
      l_tile += p;
    }
#pragma unroll
    for (int off = 1; off < RT; off <<= 1)
      l_tile += __shfl_xor_sync(0xffffffffu, l_tile, off);
    l_run = alpha * l_run + l_tile;
    m_run = m_new;
    __syncwarp();  // Ps of this row are written by lanes of this warp

    // acc[i] holds head dim j + RT*i of this row
    const float* pr = Ps + r * (BK + 1);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const float* vr = Vs + c * D;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int dd = j + RT * i;
        if (dd < D) acc[i] = fmaf(p, vr[dd], acc[i]);
      }
    }
  }

  if (qi < Lq) {
    T* ob = out + b * so.b + h * so.h + qi * so.l;
    const float inv = l_run > 0.0f ? 1.0f / l_run : 0.0f;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int dd = j + RT * i;
      if (dd < D) ob[dd] = from_f32<T>(l_run > 0.0f ? acc[i] * inv : 0.0f);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, int D, Strides sq,
                   Strides sk, Strides sv, Strides so, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  // raise the instance's dynamic shared memory limit to its widest D
  // once per device (the attribute is per device; the call costs host
  // time, so not on every launch)
  static bool limit_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !limit_set[dev]) {
    err = cudaFuncSetAttribute(si_flash_kernel<T, DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(DMAX)));
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) limit_set[dev] = true;
  }
  const dim3 grid((Lq + BQ - 1) / BQ, B * H);
  si_flash_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Lq, Lk, D, sq, sk,
      sv, so, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int Lq, int Lk, int D,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                         causal, window, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                          causal, window, scale, stream);
  return launch<T, 256>(q, k, v, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                        causal, window, scale, stream);
}

}  // namespace

// Plain C entry point for ctypes. q/k/v/out are [B, H, L, D] with the
// given (batch, head, position) element strides and a contiguous head
// dim; dtype 0 = f32, 1 = bf16 for all four. window = 0 means no band.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// the cudaError_t of the launch.
extern "C" int si_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int Lq, int Lk, int D, int64_t sqb, int64_t sqh, int64_t sql,
    int64_t skb, int64_t skh, int64_t skl, int64_t svb, int64_t svh,
    int64_t svl, int64_t sob, int64_t soh, int64_t sol, int causal,
    int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk < 0 || D <= 0 || D > 256 ||
      B * H > 65535 || window < 0 || (causal && Lq != Lk))
    return cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sql}, sk{skb, skh, skl}, sv{svb, svh, svl},
      so{sob, soh, sol};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return dispatch_d<float>(q, k, v, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                               causal, window, scale, st);
    case DT_BF16:
      return dispatch_d<__nv_bfloat16>(q, k, v, out, B, H, Lq, Lk, D, sq, sk,
                                       sv, so, causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
