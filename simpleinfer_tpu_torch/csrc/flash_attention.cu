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
// it (989 TFLOP/s bf16 on tensor cores).
//
// bf16 inputs (the llama service's prefill), FA2-style on the tensor
// cores:
//   - one block per (batch*head, 128-query tile): 4 warps of 32 query
//     rows (two m16 tiles sharing each K and V fragment) up to head_dim
//     64, 8 warps of 16 above; the grid walks the query tiles from the
//     last (the heaviest under the causal mask) to the first, so the
//     causal tail balances;
//   - Q stays in shared memory; K/V come in 64-key tiles through a
//     2-stage cp.async ring (16-byte copies, zero fill past L and past
//     D: head_dim 24 runs in a 32-wide tile; rows that are not 16-byte
//     multiples stage with narrower loads);
//   - S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 out), fragments by
//     ldmatrix; the f32 logits take the scale in the log2 domain inside
//     the exponent's FFMA, and the exponent is the MUFU's ex2.approx
//     (about 2^-22 relative; P is rounded to bf16, 2^-8, right after);
//     the running max and sum per row stay in registers, reduced across
//     the 4 lanes of a row by quad shuffles; a row with no live key so
//     far keeps m = -inf and is shifted by 0 (safe_m), its alpha is 0;
//   - P is rounded to bf16 in registers and fed straight back as the A
//     fragment of P V (the TPU body's own semantics: P at the input
//     dtype); V's B fragments by ldmatrix.trans; f32 accumulation;
//   - only tiles that cross the diagonal, the band edge or L are
//     masked; the causal grid stops at the diagonal tile, a band starts
//     at the first tile it touches (floor(max(q0 - W + 1, 0) / 64), the
//     TPU's `_band_first_block`), and a warp skips the tiles in which
//     none of its rows has a live key.
// f32 inputs (the fp32 parity mode) keep a CUDA-core kernel with P in
// f32: 64-query blocks, 4 threads per row, head_dim masked.
//
// q, k, v and out are strided views with a contiguous head dim, so the
// caller's transposes cost no copies.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/build.py) and called
//             through ctypes via `si_flash_attention`.

#include <math.h>

#include <type_traits>

#include "epilogue.cuh"
#include "mma.cuh"

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

// ---- bf16 on the tensor cores ---------------------------------------------
constexpr int TQ = 128;              // query rows per block
constexpr int TK = 64;               // keys per tile

// m16 row tiles per warp: two up to head_dim 64 (the K/V fragments of a
// key tile then serve both, and a warp has twice the independent work),
// one above (the O accumulator of head_dim 128 / 256 takes 64 / 128
// registers a tile)
__host__ __device__ constexpr int tc_mw(int dp) { return dp <= 64 ? 2 : 1; }
__host__ __device__ constexpr int tc_threads(int dp) {
  return TQ / (16 * tc_mw(dp)) * 32;
}

// Qs [TQ][DP+8], then 2 stages of Ks [TK][DP+8] and Vs [TK][DP+8] (bf16;
// the 8-element pad puts the 8 rows of an ldmatrix on distinct banks)
__host__ __device__ constexpr size_t tc_smem_bytes(int dp) {
  return sizeof(__nv_bfloat16) * size_t(dp + 8) * (TQ + 4 * TK);
}

// DP: the head dim padded to a multiple of 16 (32, 64, 128 or 256)
template <int DP, bool VEC>
__global__ void __launch_bounds__(tc_threads(DP), 1)
si_flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int H, int Lq, int Lk,
                    int D, Strides sq, Strides sk, Strides sv, Strides so,
                    int causal, int window, float scale) {
  constexpr int MW = tc_mw(DP);
  constexpr int THREADS = tc_threads(DP);
  constexpr int RS = DP + 8;
  constexpr int NT = TK / 8;       // n8 score tiles per key tile
  constexpr int DT = DP / 8;       // n8 output tiles
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TQ * RS;            // [2][TK][RS]
  __nv_bfloat16* Vs = Ks + 2 * TK * RS;        // [2][TK][RS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;   // heavy tiles first
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // rows [0, ROWS) of src (position stride ls) from position p0 into
  // dst [ROWS][RS], zero past L and past D. 16-byte staging: each thread
  // copies column 8 * (tid % (DP / 8)) of every (THREADS / (DP / 8))-th
  // row, so its column offset is set up once
  constexpr int VPR = DP / 8;                  // 16-byte vectors per row
  const int vd = 8 * (tid % VPR);
  auto stage = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                   int64_t ls, int p0, auto rows_c, int L) {
    constexpr int ROWS = decltype(rows_c)::value;
    if constexpr (VEC) {
      static_assert(ROWS * VPR % THREADS == 0, "rows do not divide");
#pragma unroll
      for (int i = 0; i < ROWS * VPR / THREADS; ++i) {
        const int r = tid / VPR + i * (THREADS / VPR);
        const bool ok = p0 + r < L && vd < D;
        cp_async16(dst + r * RS + vd, ok ? src + (p0 + r) * ls + vd : src,
                   ok);
      }
    } else {
      for (int e = tid; e < ROWS * DP; e += THREADS) {
        const int r = e / DP, d = e % DP;
        dst[r * RS + d] = p0 + r < L && d < D ? src[(p0 + r) * ls + d] : zero;
      }
    }
  };
  using q_rows = std::integral_constant<int, TQ>;
  using kv_rows = std::integral_constant<int, TK>;

  const int n_tiles = (Lk + TK - 1) / TK;
  int t_first = 0, t_last = n_tiles - 1;
  if (causal) {
    t_last = min(t_last, (q0 + TQ - 1) / TK);
    if (window > 0) t_first = max(q0 - (window - 1), 0) / TK;
  }

  stage(Qs, qb, sq.l, q0, q_rows{}, Lq);
  if (t_first <= t_last) {
    stage(Ks, kb, sk.l, t_first * TK, kv_rows{}, Lk);
    stage(Vs, vb, sv.l, t_first * TK, kv_rows{}, Lk);
  }
  cp_async_commit();

  // this warp's rows wq0 .. wq0 + 16 * MW - 1; row tile mt holds rows
  // wq0 + 16 * mt + g (e < 2) and + 8 (e >= 2) in this thread
  const int wq0 = q0 + 16 * MW * warp;
  const int wq1 = wq0 + 16 * MW - 1;
  const float sl2 = scale * 1.4426950408889634f;   // scale in log2 units
  float o[MW][DT][4];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][i][e] = 0.0f;
  float m_run[MW][2], l_run[MW][2];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run[mt][r] = -INFINITY;
      l_run[mt][r] = 0.0f;
    }

  for (int tt = t_first, it = 0; tt <= t_last; ++tt, ++it) {
    const int st = it & 1;
    if (tt < t_last) {
      stage(Ks + (st ^ 1) * TK * RS, kb, sk.l, (tt + 1) * TK, kv_rows{},
            Lk);
      stage(Vs + (st ^ 1) * TK * RS, vb, sv.l, (tt + 1) * TK, kv_rows{},
            Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tt * TK;
    // no live key for any of this warp's rows: past its last row
    // (causal), wholly before the band of its first row, or rows past Lq
    bool skip = wq0 >= Lq;
    if (causal) {
      skip = skip || k0 > wq1;
      if (window > 0) skip = skip || k0 + TK - 1 <= wq0 - window;
    }
    if (!skip) {
      const __nv_bfloat16* Kt = Ks + st * TK * RS;
      const __nv_bfloat16* Vt = Vs + st * TK * RS;
      float s[MW][NT][4];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][i][e] = 0.0f;
      // fragments are loaded a batch ahead of the MMAs that use them,
      // and neighbouring MMAs write different tiles
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[MW][4], bk[NT / 2][4];
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
          ldmatrix_x4(a[mt], Qs + (16 * MW * warp + 16 * mt + (lane & 15)) *
                                      RS + 16 * kk + (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2)
          ldmatrix_x4(bk[n2], Kt + (16 * n2 + (lane & 7) + (lane >> 4) * 8) *
                                       RS + 16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2)
#pragma unroll
          for (int mt = 0; mt < MW; ++mt) {
            mma_bf16(s[mt][2 * n2], a[mt], bk[n2][0], bk[n2][1]);
            mma_bf16(s[mt][2 * n2 + 1], a[mt], bk[n2][2], bk[n2][3]);
          }
      }
      bool masked = k0 + TK > Lk;
      if (causal) {
        masked = masked || k0 + TK - 1 > wq0;
        if (window > 0) masked = masked || k0 <= wq1 - window;
      }
      // raw logits; the scale (in log2 units) joins the exponent's FFMA
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mt][i][e];
            if (masked) {
              const int kj = k0 + 8 * i + 2 * t + (e & 1);
              const int qi = wq0 + 16 * mt + g + 8 * (e >> 1);
              bool live = kj < Lk;
              if (causal) {
                live = live && kj <= qi;
                if (window > 0) live = live && kj > qi - window;
              }
              x = live ? x : -INFINITY;
            }
            s[mt][i][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2], safe[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[mt][r], mx[r]);
          // a row with no live key so far keeps m = -inf: exp(-inf -
          // -inf) would be NaN, so shift by 0 there
          safe[r] = m_new == -INFINITY ? 0.0f : m_new * sl2;
          alpha[r] = m_run[mt][r] == -INFINITY
                         ? 0.0f
                         : fast_exp2(fmaf(m_run[mt][r], sl2, -safe[r]));
          m_run[mt][r] = m_new;
          l_run[mt][r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // exp2(s * sl2 - m * sl2): 0 at -inf
            const float p = fast_exp2(fmaf(s[mt][i][e], sl2, -safe[e >> 1]));
            s[mt][i][e] = p;
            l_run[mt][e >> 1] += p;
          }
        // no row of the warp's tile moved its max: O keeps its scale
        if (!__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) {
#pragma unroll
          for (int i = 0; i < DT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][i][e] *= alpha[e >> 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[MW][4];
#pragma unroll
        for (int mt = 0; mt < MW; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
        // d tiles a batch (2 at head_dim 256, whose O takes 128 registers)
        constexpr int DB = DP == 256 ? 2 : DP / 16 < 4 ? DP / 16 : 4;
#pragma unroll
        for (int d0 = 0; d0 < DP / 16; d0 += DB) {
          uint32_t bv[DB][4];
#pragma unroll
          for (int d2 = 0; d2 < DB; ++d2)
            ldmatrix_x4_trans(bv[d2], Vt + (16 * kk + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * RS +
                                          16 * (d0 + d2) + (lane >> 4) * 8);
#pragma unroll
          for (int d2 = 0; d2 < DB; ++d2)
#pragma unroll
            for (int mt = 0; mt < MW; ++mt) {
              mma_bf16(o[mt][2 * (d0 + d2)], a[mt], bv[d2][0], bv[d2][1]);
              mma_bf16(o[mt][2 * (d0 + d2) + 1], a[mt], bv[d2][2],
                       bv[d2][3]);
            }
        }
      }
    }
    __syncthreads();   // this stage is free for the load after next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qi = wq0 + 16 * mt + g + 8 * r;
      if (qi >= Lq) continue;
      const float inv = l > 0.0f ? 1.0f / l : 0.0f;
      __nv_bfloat16* ob = out + b * so.b + h * so.h + qi * so.l;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        const int d = 8 * i + 2 * t;
        if (d < D) ob[d] = __float2bfloat16_rn(o[mt][i][2 * r] * inv);
        if (d + 1 < D)
          ob[d + 1] = __float2bfloat16_rn(o[mt][i][2 * r + 1] * inv);
      }
    }
}

template <int DP, bool VEC>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int Lq, int Lk, int D,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes(DP);
  static bool limit_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !limit_set[dev]) {
    err = cudaFuncSetAttribute(si_flash_mma_kernel<DP, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) limit_set[dev] = true;
  }
  const int q_tiles = (Lq + TQ - 1) / TQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  si_flash_mma_kernel<DP, VEC><<<dim3(B * H, q_tiles), tc_threads(DP), smem,
                                 stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), H, Lq, Lk, D, sq, sk, sv, so, causal,
      window, scale);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch_mma_d(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int Lq, int Lk, int D,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           int causal, int window, float scale,
                           cudaStream_t stream) {
  if (D <= 32)
    return launch_mma<32, VEC>(q, k, v, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                               causal, window, scale, stream);
  if (D <= 64)
    return launch_mma<64, VEC>(q, k, v, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                               causal, window, scale, stream);
  if (D <= 128)
    return launch_mma<128, VEC>(q, k, v, out, B, H, Lq, Lk, D, sq, sk, sv,
                                so, causal, window, scale, stream);
  return launch_mma<256, VEC>(q, k, v, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                              causal, window, scale, stream);
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.l % 8 == 0;
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
    case DT_BF16: {   // tensor cores; 16-byte staging where rows allow
      // the running max is taken on the unscaled logits: scale > 0
      if (!(scale > 0.0f)) return cudaErrorInvalidValue;
      const bool vec = D % 8 == 0 && aligned16(q, sq) && aligned16(k, sk) &&
                       aligned16(v, sv);
      return vec ? dispatch_mma_d<true>(q, k, v, out, B, H, Lq, Lk, D, sq, sk,
                                        sv, so, causal, window, scale, st)
                 : dispatch_mma_d<false>(q, k, v, out, B, H, Lq, Lk, D, sq,
                                         sk, sv, so, causal, window, scale,
                                         st);
    }
    default:
      return cudaErrorInvalidValue;
  }
}
