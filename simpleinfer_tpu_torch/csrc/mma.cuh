// Tensor-core building blocks shared by matmul_int4w.cu,
// flash_attention.cu, matmul.cu, conv3x3.cu, matmul_s8s8.cu,
// decode_attention.cu, c3block.cu and stem.cu: 16-byte cp.async staging
// with zero fill, bulk (TMA) copies on mbarriers, ldmatrix fragment
// loads, mma.sync m16n8k16 (bf16 in, f32 accumulate) and bf16 pair
// packing; and (namespace si::tc, at the end) the cp.async ring (`ring`)
// and the bf16 GEMM tile of matmul.cu, conv3x3.cu and c3block.cu: x / w
// stages, int8 w converted to bf16 once per block, the k16 MMA loop and
// the shared-memory epilogue, whose activation dispatch and tile store
// matmul_s8s8.cu shares. Fragment
// layouts follow the PTX ISA (m16n8k16 .bf16): with g = lane / 4 and
// t = lane % 4,
//   A (16x16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                   a3 (g+8, 2t+8..);
//   B (16x8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16x8, f32):  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"

namespace si {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `valid` false writes zeros
// and reads nothing (src-size 0), so `src` need only be a mapped address
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 or 8 bytes global -> shared through L1 (.cg takes 16 only); the same
// zero fill when not `valid`
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool valid) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca takes 4, 8 or 16");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

// mbarriers and the bulk copy engine (TMA): one thread starts a copy of
// contiguous bytes, which counts itself in on an mbarrier as it lands
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// the inits seen by the async proxy (and the other threads, after a
// barrier)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// until the phase of `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@P bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16; both ends 16-byte aligned) global -> shared
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed (a [k][n] tile read as B fragments)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16) * b (16x8 bf16), f32 accumulation (registers only,
// so not volatile: the compiler may schedule it among other work)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b, the same product with a zero accumulator
__device__ __forceinline__ void mma_bf16_c0(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// 2^x by the MUFU alone (ex2.approx.ftz: about 2^-22 relative, 0 at
// -inf, subnormal results flushed to 0), without exp2f's subnormal range
// handling
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the bf16 GEMM tile of matmul.cu and conv3x3.cu ------------------------
// out[BM x BN] of one block = sum over K stages of x[BM x BK] (bf16, K-
// contiguous rows) times w[BK x BN] (bf16, or int8 converted to bf16 in
// shared memory), f32 accumulators in registers. Warps: WARPS_M x WARPS_N,
// each MT m16 tiles x 4 n8 tiles (32 columns). A kernel stages its own x
// rows (plain rows for a GEMM, a 3x3 tap's shifted pixels for a conv) and
// takes the rest from here. A stage in shared memory: x [BM][XS] bf16,
// w [BK][WS] bf16, and the raw int8 w [BK][QS] it is converted from. The
// pads put the 8 rows of an ldmatrix on distinct banks.
namespace tc {

constexpr int BK = 32;       // K depth of a stage: two k16 steps
constexpr int STAGES = 4;    // cp.async ring
constexpr int XS = BK + 8;   // x row in a stage (bf16)

template <int WARPS_M_, int WARPS_N_, int MT_>
struct Tile {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, MT = MT_;
  static constexpr int BM = 16 * MT * WARPS_M;
  static constexpr int BN = 32 * WARPS_N;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WS = BN + 8;    // bf16 w row (elements)
  static constexpr int QS = BN + 16;   // int8 w row (bytes)
  static constexpr int OS = BN + 8;    // output tile row (elements)
  static constexpr int W_OFF = BM * XS * 2;
  static constexpr int Q_OFF = W_OFF + BK * WS * 2;
  static constexpr int STAGE = Q_OFF + BK * QS;
  static constexpr int SMEM = STAGES * STAGE;
  // 16-byte vectors of a stage per thread: x, bf16 w, int8 w
  static constexpr int XV = BM * (BK / 8) / THREADS;
  static constexpr int WV = BK * (BN / 8) / THREADS;
  static constexpr int QV = (BK * (BN / 16) + THREADS - 1) / THREADS;
  static_assert(XV * THREADS == BM * (BK / 8) &&
                    WV * THREADS == BK * (BN / 8),
                "stage does not divide among the threads");
  static_assert(BM * OS * 4 <= SMEM, "f32 output tile does not fit");
  // the x row and 8-column vector a thread stages (vector i)
  __device__ static int x_row(int tid, int i) {
    return tid / (BK / 8) + i * (THREADS / (BK / 8));
  }
  __device__ static int x_vec(int tid) { return tid % (BK / 8); }
};

// The ring of NS stages: stages 0 .. NS-2 in flight ahead; for each stage
// c, wait for this thread's cp.async copies of it, `land(c)` (work on what
// this thread copied, or wait for a TMA copy's mbarrier, before the
// barrier), one barrier (stage c is in for all, stage c-1 is free), issue
// stage c + NS - 1, `compute(c)`. Ends with every copy landed and every
// warp done with the ring.
template <int NS = STAGES, class Load, class Land, class Compute>
__device__ __forceinline__ void ring(int n_stages, Load&& load, Land&& land,
                                     Compute&& compute) {
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < n_stages; ++c) {
    cp_async_wait<NS - 2>();   // this thread's copies of stage c
    land(c);
    __syncthreads();
    if (c + NS - 1 < n_stages) load(c + NS - 1);
    cp_async_commit();
    compute(c);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ __nv_bfloat16* x_area(uint8_t* st) {
  return reinterpret_cast<__nv_bfloat16*>(st);
}
template <class T>
__device__ __forceinline__ __nv_bfloat16* w_area(uint8_t* st) {
  return reinterpret_cast<__nv_bfloat16*>(st + T::W_OFF);
}

// x: the thread's XV vectors of columns k0 + 8v .. +7 from `src[i]` (its
// rows' first element, null off the map), zero past K (K % 8 == 0)
template <class T>
__device__ __forceinline__ void stage_x_vec(
    uint8_t* st, const __nv_bfloat16* const (&src)[T::XV],
    const __nv_bfloat16* base, int k0, int K, int tid) {
  const int v = T::x_vec(tid);
  const bool k_ok = k0 + 8 * v < K;
#pragma unroll
  for (int i = 0; i < T::XV; ++i) {
    const bool ok = k_ok && src[i] != nullptr;
    cp_async16(x_area(st) + T::x_row(tid, i) * XS + 8 * v,
               ok ? src[i] + k0 + 8 * v : base, ok);
  }
}

// w rows k0 .. k0+BK of a row-major [K, N] matrix, columns n0 .. n0+BN:
// bf16 by 16-byte cp.async straight into the w area (N % 8 == 0); int8
// by 16-byte cp.async into the raw area (N % 16 == 0), converted by
// `convert_w` once it has landed; zero outside the matrix
template <class T>
__device__ __forceinline__ void stage_w_vec(uint8_t* st,
                                            const __nv_bfloat16* w, int k0,
                                            int n0, int K, int N, int tid) {
#pragma unroll
  for (int i = 0; i < T::WV; ++i) {
    const int e = tid + i * T::THREADS;
    const int r = e / (T::BN / 8), c = 8 * (e % (T::BN / 8));
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async16(w_area<T>(st) + r * T::WS + c,
               ok ? w + static_cast<int64_t>(k0 + r) * N + n0 + c : w, ok);
  }
}
template <class T>
__device__ __forceinline__ void stage_w_vec(uint8_t* st, const int8_t* w,
                                            int k0, int n0, int K, int N,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < T::QV; ++i) {
    const int e = tid + i * T::THREADS;
    if (e >= BK * (T::BN / 16)) break;
    const int r = e / (T::BN / 16), c = 16 * (e % (T::BN / 16));
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async16(st + T::Q_OFF + r * T::QS + c,
               ok ? w + static_cast<int64_t>(k0 + r) * N + n0 + c : w, ok);
  }
}

// 4 int8 (one word) -> 4 bf16 (two words), exact: the biased byte b + 128
// under the f32 exponent of 2^23, minus 2^23 + 128, is b as an f32 whose
// low 16 bits are zero (|b| <= 128 has at most 8 significant bits), so
// its high half is b in bf16
__device__ __forceinline__ uint2 s8x4_to_bf16x4(uint32_t q) {
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.0f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// the int8 vectors this thread staged (`stage_w_vec`), once they landed
// (cp_async_wait: a thread's own copies need no barrier), into the bf16
// w area; the barrier that follows shows every thread's part to all
template <class T>
__device__ __forceinline__ void convert_w(uint8_t* st, int tid) {
#pragma unroll
  for (int i = 0; i < T::QV; ++i) {
    const int e = tid + i * T::THREADS;
    if (e >= BK * (T::BN / 16)) break;
    const int r = e / (T::BN / 16), c = 16 * (e % (T::BN / 16));
    const uint4 q =
        *reinterpret_cast<const uint4*>(st + T::Q_OFF + r * T::QS + c);
    const uint2 a = s8x4_to_bf16x4(q.x), b = s8x4_to_bf16x4(q.y);
    const uint2 cc = s8x4_to_bf16x4(q.z), d = s8x4_to_bf16x4(q.w);
    uint4* dst = reinterpret_cast<uint4*>(w_area<T>(st) + r * T::WS + c);
    dst[0] = make_uint4(a.x, a.y, b.x, b.y);
    dst[1] = make_uint4(cc.x, cc.y, d.x, d.y);
  }
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
  return v;
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t v) {
  return __float2bfloat16_rn(static_cast<float>(v));  // exact
}

// the same w tile by element loads (ragged N or unaligned rows): written
// as bf16 when the load returns; the ring's barriers order it like a copy
template <class T, typename TW>
__device__ __forceinline__ void stage_w_elem(uint8_t* st, const TW* w,
                                             int k0, int n0, int K, int N,
                                             int tid) {
  __nv_bfloat16* ws = w_area<T>(st);
  for (int e = tid; e < BK * T::BN; e += T::THREADS) {
    const int r = e / T::BN, c = e % T::BN;
    const bool ok = k0 + r < K && n0 + c < N;
    ws[r * T::WS + c] =
        ok ? to_bf16(w[static_cast<int64_t>(k0 + r) * N + n0 + c])
           : __float2bfloat16_rn(0.0f);
  }
}

// acc[mi][j] += x rows (warp's mi-th m16 tile) times w columns (warp's
// j-th n8 tile) over the stage's BK; A by ldmatrix, B by ldmatrix.trans
template <class T>
__device__ __forceinline__ void mma_stage(uint8_t* st,
                                          float (&acc)[T::MT][4][4],
                                          int wm, int wn, int lane) {
  const __nv_bfloat16* xs = x_area(st);
  const __nv_bfloat16* ws = w_area<T>(st);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[T::MT][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi)
      ldmatrix_x4(a[mi], xs + (16 * (wm * T::MT + mi) + (lane & 15)) * XS +
                             16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4_trans(b[nj], ws + (16 * kk + (lane & 15)) * T::WS +
                                   32 * wn + 16 * nj + (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        mma_bf16(acc[mi][2 * nj], a[mi], b[nj][0], b[nj][1]);
        mma_bf16(acc[mi][2 * nj + 1], a[mi], b[nj][2], b[nj][3]);
      }
  }
}

// f(the activation code): a compile-time constant for the paths' own
// activations (none and relu on ResNet-50, silu on YOLOv5), -1 for the
// rest, which then switch on `act` at every output. The epilogue's loop
// is compiled once per case, so a launch fetches its own code only: a
// switch inside the loop of a thread's 32 or 64 outputs, inlined at every
// output, cost more in instruction fetch than the stores did
template <typename F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  using std::integral_constant;
  switch (act) {
    case ACT_NONE: f(integral_constant<int, ACT_NONE>{}); break;
    case ACT_RELU: f(integral_constant<int, ACT_RELU>{}); break;
    case ACT_SILU: f(integral_constant<int, ACT_SILU>{}); break;
    default: f(integral_constant<int, -1>{}); break;
  }
}

// act(acc * scale[n]? + bias[n]?) cast to TO, into the output tile
// [BM][OS] at the start of shared memory (the ring is done with)
template <class T, typename TO>
__device__ __forceinline__ void epilogue_to_smem(
    uint8_t* smem, const float (&acc)[T::MT][4][4],
    const float* __restrict__ scale, const void* __restrict__ bias,
    int bias_dtype, int n0, int N, int act, float act_arg, int wm, int wn,
    int lane) {
  TO* os = reinterpret_cast<TO*>(smem);
  const int g = lane / 4, t = lane % 4;
  with_act(act, [&](auto A) {
    constexpr int kAct = decltype(A)::value;
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // n8 tile j: columns 32 wn + 8 j + 2 t
      float sv[2], bv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gn = n0 + 32 * wn + 8 * j + 2 * t + e;
        sv[e] = scale != nullptr && gn < N ? scale[gn] : 1.0f;
        bv[e] = bias != nullptr && gn < N ? load_bias(bias, bias_dtype, gn)
                                          : 0.0f;
      }
#pragma unroll
      for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = acc[mi][j][2 * hh + e];
            if (scale != nullptr) v[e] *= sv[e];
            if (bias != nullptr) v[e] += bv[e];
            v[e] = activate(v[e], kAct < 0 ? act : kAct, act_arg);
          }
          TO* dst = os + (16 * (wm * T::MT + mi) + g + 8 * hh) * T::OS +
                    32 * wn + 8 * j + 2 * t;
          if constexpr (sizeof(TO) == 4) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
        }
    }
  });
}

// the output tile to out[m0 .., n0 ..] of a row-major [M, N] matrix: 16-
// byte stores along rows where `vec` (N * sizeof(TO) and out 16-byte
// aligned), else element stores; neighbouring threads store neighbouring
// addresses either way
template <class T, typename TO>
__device__ __forceinline__ void store_tile(const uint8_t* smem,
                                           TO* __restrict__ out, int64_t m0,
                                           int n0, int64_t M, int N, bool vec,
                                           int tid) {
  const TO* os = reinterpret_cast<const TO*>(smem);
  if (vec) {
    constexpr int EV = 16 / sizeof(TO);   // elements per vector
    constexpr int VR = T::BN / EV;        // vectors per tile row
    for (int e = tid; e < T::BM * VR; e += T::THREADS) {
      const int r = e / VR, c = EV * (e % VR);
      const int64_t gm = m0 + r;
      if (gm < M && n0 + c < N)
        *reinterpret_cast<uint4*>(out + gm * N + n0 + c) =
            *reinterpret_cast<const uint4*>(os + r * T::OS + c);
    }
  } else {
    for (int e = tid; e < T::BM * T::BN; e += T::THREADS) {
      const int r = e / T::BN, c = e % T::BN;
      const int64_t gm = m0 + r;
      if (gm < M && n0 + c < N) out[gm * N + n0 + c] = os[r * T::OS + c];
    }
  }
}

// raise a kernel's dynamic shared memory limit once per device
constexpr int MAX_DEVICES = 64;
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// the two tiles: 128 x 128 for N > 64, 128 x 64 for N <= 64 (the wrapper
// chooses by N and passes the width)
using Wide = Tile<2, 4, 4>;
using Narrow = Tile<4, 2, 2>;

}  // namespace tc
}  // namespace si
