// The whole YOLOv5 C3 block for Hopper: cv1 / cv2 1x1, T bottlenecks
// (1x1, 3x3 "same", optional residual) and cv3 over the never copied
// concat, with optional int8 3x3 taps.
//
// Replaces the Pallas TPU kernel `_c3_kernel` behind `c3_block`
// (simpleinfer_tpu/kernels/c3block.py, pallas_call in `c3_block`). Per
// image of x [N, H, W, C] (NHWC, f32 or bf16 = T):
//
//     y1 = act(x @ cv1_w + cv1_b)                                  (T)
//     for t < T:
//       a  = act(y1 @ a_w[t] + a_b[t])        (T; f32 with s8 taps)
//       z  = act(conv3x3(a, b_w[t]) + b_b[t])                      (T)
//            s8 taps: q = clip(rint(a / s_img), +-127) with s_img =
//            max(max|a| over the IMAGE, 1e-8) / 127, z = act(s32 sum of
//            q x b_w[t] (int8) * (s_img * b_scale[t]) + b_b[t])
//       y1 = shortcut ? y1 + z : z                                 (T)
//     y2  = act(x @ cv2_w + cv2_b)                                 (T)
//     out = act(y1 @ cv3_w1 + y2 @ cv3_w2 + cv3_b)                 (T)
//
// with f32 sums, rounding to T where c3_block_reference rounds.
//
// What bounds it on an H100: at yolov5l-640-b16 the blocks do 127-329
// GFLOP each (2 * 9 * hid^2 per pixel and bottleneck in the 3x3s) over
// intermediates of 26-105 MB per stage: the 3x3s are bound by the bf16
// tensor cores (989 TFLOP/s), C3_1's narrow stages (hid 64) by the
// workspace's bytes (~1.7 GB at 3.35 TB/s, ~0.5 ms).
//
// Design. The TPU kernel keeps a whole image in ~100 MB of VMEM and
// walks it in row bands of 32 with halo rows recomputed. A Hopper block
// has 227 KB of shared memory, and a C3_1 band of 38 rows is 0.8 MB in
// bf16, so here the intermediates live in a workspace the wrapper
// allocates, and the block is a SPLIT into one kernel per stage,
// enqueued by one call of `si_c3_block`:
//   - the s8 taps quantize per IMAGE, which needs the abs-max over every
//     row of the image before the 3x3 starts. A stage boundary is that
//     grid-wide barrier: the 1x1 kernel's epilogue folds its |a| into the
//     image's abs-max with atomicMax on the bits of a non-negative float,
//     the next kernel reads it. A cooperative kernel with grid.sync()
//     would need all of its blocks resident at once (16 images x 5 bands
//     = 80 blocks at C3_1 b16, leaving 52 of 132 SMs idle) and would
//     recompute halo rows: 2T/rh more 3x3 work per band, 19% at C3_1 and
//     60-90% at C3_2/C3_3 (rh 20, T 6/9). Split kernels tile the whole
//     batch with no halo and fill every SM.
// bf16 x with C, hid and OC multiples of 8 (every block the gates take):
// the bf16 tensor cores, the GEMM tile of csrc/mma.cuh (si::tc: the
// cp.async ring, ldmatrix, mma.sync m16n8k16, f32 accumulators) as
// csrc/matmul.cu and csrc/conv3x3.cu run it. The workspace holds y1 and
// y2 side by side, ybuf [M, 2 hid]:
//   - cv1 and cv2 are ONE GEMM with N = 2 hid (x read once), each 8-
//     column vector of w staged from the half it lies in (cv1_w or
//     cv2_w), the bias likewise; y1 and y2 land in their halves of ybuf;
//   - cv3 is ONE GEMM with K = 2 hid over ybuf: the concat is ybuf's
//     layout and is never copied; its w rows come from cv3_w1 or cv3_w2;
//   - the bottleneck 1x1 reads y1 with row stride 2 hid; the fp-tap 3x3
//     is conv3x3.cu's tap-major implicit GEMM (per tap `tap_row` gives a
//     staged row its source pixel, 16-byte cp.async, zero fill off the
//     image), and its epilogue rounds to bf16 and adds the residual into
//     y1 in place;
//   - s8 taps: the bottleneck 1x1's epilogue writes a in f32 and folds
//     the per-image |a| max; one elementwise kernel quantizes a to int8
//     ONCE ([M, hid], rint(a / s_img) with an IEEE division, as the
//     reference); the 3x3 stages int8 rows by 16-byte cp.async with zero
//     fill and multiplies with mma.sync m16n8k32 s8 -> s32 (IMMA, exact),
//     its w tile transposed to [n][k] in shared memory by the threads
//     that copied it (4 x 4 bytes each, byte_perm); the epilogue
//     dequantizes by s_img * b_scale[n], adds the bias, activates,
//     rounds and adds the residual;
//   - the bf16 stages add each stage's two k16 products to the f32
//     accumulators on the CUDA cores (`mma_stage_promoted` says why);
//   - every epilogue runs bias and activation in registers (the
//     activation compiled into its own loop, si::tc::with_act; SiLU by
//     __expf), puts the tile in shared memory and stores 16-byte vectors
//     along rows.
// f32 x (the parity mode, exact to f32 summation order), or channel
// widths off 8: each 1x1 and fp-tap 3x3 is a 64 x 64 f32-FMA tile of
// csrc/tiles.cuh (y1 [M, hid] and y2 in the bottleneck buffer; cv3 sums
// two K segments), and the s8 taps take the int8 route above (its sum is
// exact either way). wgmma through a 4-D TMA map with out-of-bounds zero
// fill is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/c3block.py does this at
//             first use) and called through ctypes via `si_c3_block`.

#include <algorithm>

#include "mma.cuh"
#include "tiles.cuh"

namespace {

using namespace si;
using si::tile::tap_row;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// the image's s8 activation scale from its abs-max bits
__device__ __forceinline__ float image_scale(const int* amax, int64_t img) {
  return fmaxf(__int_as_float(amax[img]), 1e-8f) / 127.0f;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- the stores every route shares -----------------------------------------
// The tile z [ROWS][OS] of TO in shared memory to out[m0 + r, n0 + c]
// (row stride ldo): plain, or into y in place as y + z rounded to TO
// (`residual`); 16-byte vectors along rows where `vec` (a thread's
// residual vectors all loaded before the first store, so their latencies
// overlap), else elements. AMAX (f32 z): fold each row's |z| into its
// image's abs-max, one atomic a warp where its lanes end in one image
// (one a thread contended at the L2).
template <typename TO, int ROWS, int COLS, int OS, int THREADS, bool AMAX>
__device__ __forceinline__ void store_rows(const uint8_t* smem, TO* out,
                                           int64_t ldo, int64_t m0, int n0,
                                           int64_t M, int N, bool residual,
                                           bool vec, int* amax, int64_t hw,
                                           int tid) {
  const TO* zs = reinterpret_cast<const TO*>(smem);
  constexpr int EV = 16 / sizeof(TO);
  constexpr int VR = COLS / EV;
  constexpr int PER = ROWS * VR / THREADS;   // vectors a thread
  static_assert(PER * THREADS == ROWS * VR, "tile does not divide");
  int64_t cur_img = -1;
  float cur_max = 0.0f;
  auto fold = [&](int64_t gm, float m) {
    if constexpr (AMAX) {
      const int64_t img = gm / hw;
      if (img != cur_img) {
        if (cur_img >= 0) atomicMax(amax + cur_img, __float_as_int(cur_max));
        cur_img = img;
        cur_max = 0.0f;
      }
      cur_max = fmaxf(cur_max, m);
    }
  };
  if (vec) {
    uint4 y[PER];
    if (residual) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = tid + i * THREADS;
        const int64_t gm = m0 + e / VR;
        const int c = EV * (e % VR);
        if (gm < M && n0 + c < N)
          y[i] = *reinterpret_cast<const uint4*>(out + gm * ldo + n0 + c);
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / VR, c = EV * (e % VR);
      const int64_t gm = m0 + r;
      if (gm >= M || n0 + c >= N) continue;
      uint4 z = *reinterpret_cast<const uint4*>(zs + r * OS + c);
      if (residual) {
        const TO* zv = reinterpret_cast<const TO*>(&z);
        const TO* yv = reinterpret_cast<const TO*>(&y[i]);
        alignas(16) TO s[EV];
#pragma unroll
        for (int k = 0; k < EV; ++k)
          s[k] = from_f32<TO>(to_f32(zv[k]) + to_f32(yv[k]));
        z = *reinterpret_cast<const uint4*>(s);
      }
      *reinterpret_cast<uint4*>(out + gm * ldo + n0 + c) = z;
      if constexpr (AMAX) {
        const float* zv = reinterpret_cast<const float*>(&z);
        float m = 0.0f;
#pragma unroll
        for (int k = 0; k < EV; ++k) m = fmaxf(m, fabsf(zv[k]));
        fold(gm, m);
      }
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const int64_t gm = m0 + r;
      if (gm >= M || n0 + c >= N) continue;
      TO* dst = out + gm * ldo + n0 + c;
      const float z = to_f32(zs[r * OS + c]);
      *dst = residual ? from_f32<TO>(z + to_f32(*dst)) : zs[r * OS + c];
      fold(gm, fabsf(z));
    }
  }
  if constexpr (AMAX) {
    const int64_t img0 = __shfl_sync(0xffffffffu, cur_img, 0);
    if (__all_sync(0xffffffffu, cur_img == img0)) {
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        cur_max = fmaxf(cur_max, __shfl_xor_sync(0xffffffffu, cur_max, o));
      if (tid % 32 == 0 && img0 >= 0)
        atomicMax(amax + img0, __float_as_int(cur_max));
    } else if (cur_img >= 0) {
      atomicMax(amax + cur_img, __float_as_int(cur_max));
    }
  }
}

// the activation of the tensor-core epilogues: SiLU by __expf and
// __fdividef (expf and an IEEE division made the epilogues a large part
// of a yolov5l C3 block on an H100; the difference is ~1e-6 relative,
// under one bf16 ulp), the rest as csrc/epilogue.cuh computes them
template <int A>
__device__ __forceinline__ float act_c3(float v, int act, float a) {
  if constexpr (A == ACT_SILU) return __fdividef(v, 1.0f + __expf(-v));
  return activate(v, A < 0 ? act : A, a);
}

// ---- bf16: the tensor-core stages -----------------------------------------
enum Out { OUT_STORE = 0, OUT_F32_AMAX = 1, OUT_RESIDUAL = 2 };

struct TcArgs {
  const __nv_bfloat16* a;  // activation rows [M, lda]; K columns read
  int64_t lda;
  int K;                   // per tap
  // w: [taps, K, N], or two halves: by column (col_split = hid: w1, w2
  // [K, hid]) or by row (row_split = hid: w1, w2 [hid, N])
  const __nv_bfloat16* w1;
  const __nv_bfloat16* w2;
  int col_split, row_split;
  const void* b1;   // bias [N], or its halves by column, of bias_dtype
  const void* b2;
  int bias_dtype;
  void* out;        // [M, ldo] of bf16 (f32 for OUT_F32_AMAX)
  int64_t ldo;
  int* amax;
  int M, N, H, W;
  int shortcut;
  int act;
  float act_arg;
};

__device__ __forceinline__ const __nv_bfloat16* w_at(const TcArgs& p, int tap,
                                                     int k, int n) {
  if (p.col_split > 0)
    return n < p.col_split
               ? p.w1 + static_cast<int64_t>(k) * p.col_split + n
               : p.w2 + static_cast<int64_t>(k) * (p.N - p.col_split) + n -
                     p.col_split;
  if (p.row_split > 0)
    return k < p.row_split
               ? p.w1 + static_cast<int64_t>(k) * p.N + n
               : p.w2 + static_cast<int64_t>(k - p.row_split) * p.N + n;
  return p.w1 + (static_cast<int64_t>(tap) * p.K + k) * p.N + n;
}

__device__ __forceinline__ float bias_at(const TcArgs& p, int n) {
  return p.col_split > 0 && n >= p.col_split
             ? load_bias(p.b2, p.bias_dtype, n - p.col_split)
             : load_bias(p.b1, p.bias_dtype, n);
}

// acc[mi][j] += the stage's x rows times w columns (si::tc::mma_stage's
// fragments), the stage's two k16 products summed by the tensor cores
// into a zero accumulator and then added to acc in f32 on the CUDA
// cores. With the tensor cores' own f32 accumulation over a whole K,
// yolov5l's C3_3 (9 bottlenecks, where every flipped bf16 rounding
// carries on) read a mean distance from the f32 reference of 5.2e-4 x
// scale, past c3_block's limit of 5e-4 (chip_smoke.py on an H100);
// summed once a stage it reads inside the limit, at some cost in time
template <class TL>
__device__ __forceinline__ void mma_stage_promoted(
    const uint8_t* st, float (&acc)[TL::MT][4][4], int wm, int wn,
    int lane) {
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
  const __nv_bfloat16* ws =
      reinterpret_cast<const __nv_bfloat16*>(st + TL::W_OFF);
  static_assert(tc::BK == 32, "two k16 steps a stage");
  uint32_t b[2][2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4_trans(b[kk][nj], ws + (16 * kk + (lane & 15)) * TL::WS +
                                       32 * wn + 16 * nj + (lane >> 4) * 8);
#pragma unroll
  for (int mi = 0; mi < TL::MT; ++mi) {
    uint32_t a[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4(a[kk], xs + (16 * (wm * TL::MT + mi) + (lane & 15)) *
                                  tc::XS + 16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[4];
        mma_bf16_c0(part, a[0], b[0][nj][2 * h], b[0][nj][2 * h + 1]);
        mma_bf16(part, a[1], b[1][nj][2 * h], b[1][nj][2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][2 * nj + h][e] += part[e];
      }
  }
}

// One BM x BN output tile of a 1x1 (TAPS 1) or 3x3 "same" (TAPS 9)
// stage: the si::tc ring over taps x K / 32 stages, x rows by 16-byte
// cp.async (3x3: the tap's source pixel, zero off the image), w vectors
// from their half, then bias, activation, rounding and the store of OUT.
template <class TL, int TAPS, int OUT>
__global__ void __launch_bounds__(TL::THREADS, 2) c3_tc_kernel(TcArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  using TO = std::conditional_t<OUT == OUT_F32_AMAX, float, __nv_bfloat16>;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int n0 = blockIdx.x * TL::BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * TL::BM;
  const int k_steps = (p.K + tc::BK - 1) / tc::BK;
  const int n_stages = TAPS * k_steps;

  const __nv_bfloat16* src[TL::XV];
  int src_tap = -1;

  auto load = [&](int c) {
    uint8_t* st = smem + (c % tc::STAGES) * TL::STAGE;
    const int tap = c / k_steps;
    const int k0 = (c - tap * k_steps) * tc::BK;
    if (tap != src_tap) {
      src_tap = tap;
#pragma unroll
      for (int i = 0; i < TL::XV; ++i) {
        const int64_t gm = m0 + TL::x_row(tid, i);
        const int64_t r = TAPS == 9 ? tap_row(gm, p.M, p.H, p.W,
                                              tap / 3 - 1, tap % 3 - 1)
                                    : (gm < p.M ? gm : -1);
        src[i] = r >= 0 ? p.a + r * p.lda : nullptr;
      }
    }
    tc::stage_x_vec<TL>(st, src, p.a, k0, p.K, tid);
#pragma unroll
    for (int i = 0; i < TL::WV; ++i) {
      const int e = tid + i * TL::THREADS;
      const int r = e / (TL::BN / 8), c8 = 8 * (e % (TL::BN / 8));
      const bool ok = k0 + r < p.K && n0 + c8 < p.N;
      cp_async16(tc::w_area<TL>(st) + r * TL::WS + c8,
                 ok ? w_at(p, tap, k0 + r, n0 + c8) : p.w1, ok);
    }
  };

  float acc[TL::MT][4][4];
#pragma unroll
  for (int i = 0; i < TL::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  tc::ring(n_stages, load, [](int) {}, [&](int c) {
    mma_stage_promoted<TL>(smem + (c % tc::STAGES) * TL::STAGE, acc, wm, wn,
                           lane);
  });

  // epilogue: bias and activation in registers, the tile as TO in smem
  TO* zs = reinterpret_cast<TO*>(smem);
  const int g = lane / 4, t = lane % 4;
  tc::with_act(p.act, [&](auto A) {
    constexpr int kAct = decltype(A)::value;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float bv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gn = n0 + 32 * wn + 8 * j + 2 * t + e;
        bv[e] = gn < p.N ? bias_at(p, gn) : 0.0f;
      }
#pragma unroll
      for (int mi = 0; mi < TL::MT; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = act_c3<kAct>(acc[mi][j][2 * hh + e] + bv[e], p.act,
                                p.act_arg);
          TO* dst = zs + (16 * (wm * TL::MT + mi) + g + 8 * hh) * TL::OS +
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
  __syncthreads();
  store_rows<TO, TL::BM, TL::BN, TL::OS, TL::THREADS, OUT == OUT_F32_AMAX>(
      smem, static_cast<TO*>(p.out), p.ldo, m0, n0, p.M, p.N,
      OUT == OUT_RESIDUAL && p.shortcut, true, p.amax,
      static_cast<int64_t>(p.H) * p.W, tid);
}

template <class TL, int TAPS, int OUT>
cudaError_t launch_tc_tile(const TcArgs& p, cudaStream_t st) {
  static bool done[tc::MAX_DEVICES] = {};
  auto kern = c3_tc_kernel<TL, TAPS, OUT>;
  cudaError_t err = tc::allow_smem(kern, TL::SMEM, done);
  if (err != cudaSuccess) return err;
  const int m_tiles = (p.M + TL::BM - 1) / TL::BM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  kern<<<dim3((p.N + TL::BN - 1) / TL::BN, m_tiles), TL::THREADS, TL::SMEM,
         st>>>(p);
  return cudaGetLastError();
}

// 128 x 64 tiles for N <= 64, 128 x 128 above (as matmul.cu chooses)
template <int TAPS, int OUT>
cudaError_t launch_tc(const TcArgs& p, cudaStream_t st) {
  return p.N <= 64 ? launch_tc_tile<tc::Narrow, TAPS, OUT>(p, st)
                   : launch_tc_tile<tc::Wide, TAPS, OUT>(p, st);
}

// ---- s8 taps: quantize once, then the int8 tensor cores --------------------
// q = clip(rint(a / s_img), +-127) for a [M, K] f32, once per element:
// round half to even, as torch.round, after an IEEE division, as the
// reference's a / s. Four elements a thread (K % 4 == 0: one image)
__device__ __forceinline__ int quantize_s8(float a, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(a, s)), -127.0f),
                                127.0f));
}
__global__ void c3_quantize_kernel(const float* __restrict__ a,
                                   const int* __restrict__ amax,
                                   int8_t* __restrict__ q, int64_t total,
                                   int K, int64_t hw) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (K % 4 == 0) {
    for (; 4 * i < total; i += stride) {
      const float s = image_scale(amax, (4 * i / K) / hw);
      const float4 v = reinterpret_cast<const float4*>(a)[i];
      reinterpret_cast<char4*>(q)[i] =
          make_char4(quantize_s8(v.x, s), quantize_s8(v.y, s),
                     quantize_s8(v.z, s), quantize_s8(v.w, s));
    }
  } else {
    for (; i < total; i += stride)
      q[i] = quantize_s8(a[i], image_scale(amax, (i / K) / hw));
  }
}

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), exact s32 sums.
// Fragments (PTX ISA, m16n8k32 .s8), g = lane / 4, t = lane % 4:
// A a0 (g, 4t..4t+3), a1 (g+8, ..), a2 (g, 16+4t..), a3 (g+8, 16+4t..);
// B b0 (k 4t..4t+3, n g), b1 (k 16+4t.., n g); C as m16n8k16's.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the s8 tap tile: 128 pixels x 64 channels, 8 warps of 32 x 32. K runs
// in chunks of 64: per chunk the block holds the 9 taps' w transposed to
// [tap][n][k] in shared memory (loaded once), and a ring of q stages, one
// per tap, [128][QS] with k-contiguous rows. Rows of 80 bytes put the 8
// rows of an ldmatrix on distinct banks.
namespace s8t {
constexpr int BM = 128, BN = 64, BK = 64, THREADS = 256;
constexpr int QS = BK + 16;
constexpr int STAGES = 4;
constexpr int A_STAGE = BM * QS;
constexpr int W_OFF = STAGES * A_STAGE;
constexpr int W_TAP = BN * QS;
constexpr int SMEM = W_OFF + 9 * W_TAP;
constexpr int OS = BN + 8;  // output tile row (elements)
constexpr int XV = BM * (BK / 16) / THREADS;  // q vectors a thread stages
static_assert(BM * OS * 4 <= SMEM, "f32 output tile does not fit");
}  // namespace s8t

struct S8Args {
  const int8_t* q;    // [M, K] quantized activation of the bottleneck 1x1
  const int* amax;    // per-image abs-max bits of the f32 activation
  const int8_t* w;    // taps [9, K, N] int8, per-output-channel quantized
  const float* wsc;   // [N] tap weight scales
  const void* bias;   // [N] of bias_dtype
  int bias_dtype;
  void* y;            // y1 [M, ldy] (T), updated in place
  int64_t ldy;
  int shortcut;
  int M, N, K, H, W;
  int act;
  float act_arg;
};

// One 128 x 64 output tile of the s8-tap 3x3. VX (K = N, a multiple of
// 16; q and w aligned): q rows by 16-byte cp.async with zero fill, w by
// 4-byte loads, each thread transposing 4 x 4 bytes with byte_perm;
// else element loads (ragged hid).
template <typename T, bool VX>
__global__ void __launch_bounds__(s8t::THREADS, 2)
c3_s8_tap_kernel(S8Args p) {
  using namespace s8t;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int n0 = blockIdx.x * BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t hw = static_cast<int64_t>(p.H) * p.W;

  // the image, row and column of each q row this thread stages (VX)
  int64_t base[XV];
  int py[XV], px[XV];
#pragma unroll
  for (int i = 0; i < XV; ++i) {
    const int64_t gm = m0 + tid / (BK / 16) + i * (THREADS / (BK / 16));
    const int64_t img = gm / hw;
    const int rem = static_cast<int>(gm - img * hw);
    base[i] = img * hw;
    py[i] = gm < p.M ? rem / p.W : -(1 << 20);
    px[i] = rem % p.W;
  }

  // the image scales of the epilogue's rows (amax is final: the 1x1
  // kernel before this one folded it)
  float s_img[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t gm = m0 + 32 * wm + 16 * mi + lane / 4 + 8 * hh;
      s_img[mi][hh] = gm < p.M ? image_scale(p.amax, gm / hw) : 0.0f;
    }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // stage `tap`: q rows shifted by the tap, columns k0 .. k0 + 63
    auto load = [&](int tap) {
      uint8_t* st = smem + (tap % STAGES) * A_STAGE;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      if constexpr (VX) {
        const int v = tid % (BK / 16);
#pragma unroll
        for (int i = 0; i < XV; ++i) {
          const int r = tid / (BK / 16) + i * (THREADS / (BK / 16));
          const int yy = py[i] + dy, xx = px[i] + dx;
          const bool ok = yy >= 0 && yy < p.H && xx >= 0 && xx < p.W &&
                          k0 + 16 * v < p.K;
          cp_async16(st + r * QS + 16 * v,
                     ok ? p.q + (base[i] + static_cast<int64_t>(yy) * p.W +
                                 xx) * p.K + k0 + 16 * v
                        : p.q,
                     ok);
        }
      } else {
        for (int e = tid; e < BM * BK; e += THREADS) {
          const int r = e / BK, kk = e % BK;
          const int64_t row = tap_row(m0 + r, p.M, p.H, p.W, dy, dx);
          st[r * QS + kk] =
              row >= 0 && k0 + kk < p.K ? p.q[row * p.K + k0 + kk] : 0;
        }
      }
    };
    // the 9 taps' w rows k0 .. k0 + 63 into [tap][n][k], after the ring's
    // first q copies are on their way; the ring's first barrier shows it
    auto land = [&](int c) {
      if (c != 0) return;
      uint8_t* ws = smem + W_OFF;
      if constexpr (VX) {
        const int kb = tid / (BN / 4), nb = tid % (BN / 4);
        const bool ok = k0 + 4 * kb < p.K && n0 + 4 * nb < p.N;
        uint32_t r[9][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[tap][i] = ok ? __ldg(reinterpret_cast<const uint32_t*>(
                                 p.w + (static_cast<int64_t>(tap) * p.K +
                                        k0 + 4 * kb + i) * p.N +
                                 n0 + 4 * nb))
                           : 0u;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t lo01 = __byte_perm(r[tap][0], r[tap][1], 0x5140);
          const uint32_t hi01 = __byte_perm(r[tap][0], r[tap][1], 0x7362);
          const uint32_t lo23 = __byte_perm(r[tap][2], r[tap][3], 0x5140);
          const uint32_t hi23 = __byte_perm(r[tap][2], r[tap][3], 0x7362);
          const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410),
                                   __byte_perm(lo01, lo23, 0x7632),
                                   __byte_perm(hi01, hi23, 0x5410),
                                   __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint32_t*>(ws + tap * W_TAP +
                                         (4 * nb + j) * QS + 4 * kb) = col[j];
        }
      } else {
        for (int e = tid; e < 9 * BN * BK; e += THREADS) {
          const int tap = e / (BN * BK), n = (e / BK) % BN, kk = e % BK;
          ws[tap * W_TAP + n * QS + kk] =
              k0 + kk < p.K && n0 + n < p.N
                  ? p.w[(static_cast<int64_t>(tap) * p.K + k0 + kk) * p.N +
                        n0 + n]
                  : 0;
        }
      }
    };
    tc::ring<STAGES>(9, load, land, [&](int tap) {
      const uint8_t* st = smem + (tap % STAGES) * A_STAGE;
      const uint8_t* ws = smem + W_OFF + tap * W_TAP;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], st + (32 * wm + 16 * mi + (lane & 15)) * QS +
                                 32 * kk + (lane >> 4) * 16);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldmatrix_x4(b[nj], ws + (32 * wn + 16 * nj + (lane & 7) +
                                   ((lane >> 4) << 3)) * QS +
                                 32 * kk + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            mma_s8(acc[mi][2 * nj], a[mi], b[nj][0], b[nj][1]);
            mma_s8(acc[mi][2 * nj + 1], a[mi], b[nj][2], b[nj][3]);
          }
      }
    });
  }

  // epilogue: s32 * (s_img * wsc[n]) + bias, activation, rounded to T
  T* zs = reinterpret_cast<T*>(smem);
  const int g = lane / 4, t = lane % 4;
  float wsc[4][2], bv[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + 32 * wn + 8 * j + 2 * t + e;
      wsc[j][e] = gn < p.N ? p.wsc[gn] : 0.0f;
      bv[j][e] = gn < p.N ? load_bias(p.bias, p.bias_dtype, gn) : 0.0f;
    }
  tc::with_act(p.act, [&](auto A) {
    constexpr int kAct = decltype(A)::value;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 32 * wm + 16 * mi + g + 8 * hh;
        const float s = s_img[mi][hh];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = act_c3<kAct>(__int2float_rn(acc[mi][j][2 * hh + e]) *
                                    (s * wsc[j][e]) + bv[j][e],
                                p.act, p.act_arg);
          T* dst = zs + r * OS + 32 * wn + 8 * j + 2 * t;
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      }
  });
  __syncthreads();
  const bool vec = p.N % (16 / sizeof(T)) == 0 &&
                   p.ldy % (16 / sizeof(T)) == 0 && aligned16(p.y);
  store_rows<T, BM, BN, OS, THREADS, false>(
      smem, static_cast<T*>(p.y), p.ldy, m0, n0, p.M, p.N, p.shortcut != 0,
      vec, nullptr, hw, tid);
}

template <typename T>
cudaError_t s8_taps(const float* abuf, int8_t* qbuf, const int* amax,
                    const S8Args& p, cudaStream_t st) {
  const int64_t total = static_cast<int64_t>(p.M) * p.K;
  const int64_t hw = static_cast<int64_t>(p.H) * p.W;
  const int blocks = static_cast<int>(
      std::min<int64_t>((total / 4 + 255) / 256 + 1, 132 * 16));
  c3_quantize_kernel<<<blocks, 256, 0, st>>>(abuf, amax, qbuf, total, p.K,
                                             hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int m_tiles = (p.M + s8t::BM - 1) / s8t::BM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.N + s8t::BN - 1) / s8t::BN, m_tiles);
  const bool vx = p.K % 16 == 0 && p.N == p.K && aligned16(p.q) &&
                  aligned16(p.w);
  static bool done[2][tc::MAX_DEVICES] = {};
  if (vx) {
    auto kern = c3_s8_tap_kernel<T, true>;
    err = tc::allow_smem(kern, s8t::SMEM, done[0]);
    if (err != cudaSuccess) return err;
    kern<<<grid, s8t::THREADS, s8t::SMEM, st>>>(p);
  } else {
    auto kern = c3_s8_tap_kernel<T, false>;
    err = tc::allow_smem(kern, s8t::SMEM, done[1]);
    if (err != cudaSuccess) return err;
    kern<<<grid, s8t::THREADS, s8t::SMEM, st>>>(p);
  }
  return cudaGetLastError();
}

// ---- f32 (or widths off 8): the f32-FMA tile -------------------------------
struct FpArgs {
  const void* a1;   // [M, k1] (T), or the [N, H, W, k1] tap input
  const void* w1;   // [k1, N] (T), or taps [9, k1, N]
  int k1;
  const void* a2;   // optional second K segment (cv3's y2 half)
  const void* w2;
  int k2;
  const void* bias;   // [N] of bias_dtype
  int bias_dtype;
  void* out;          // 1x1: [M, N] of TO
  void* y;            // taps: y1 [M, N] (T), updated in place
  int shortcut;
  int* amax;          // 1x1 with f32 out: per-image abs-max bits, or null
  int M, N, H, W;
  int act;
  float act_arg;
};

// One 64x64 output tile of a 1x1 conv (TAPS = false: one or two K
// segments, epilogue act + store, optionally the per-image abs-max) or
// of a 3x3 "same" conv with fp taps (TAPS = true: 9 shifted segments,
// epilogue act, round to T, residual into y).
template <typename T, typename TO, bool TAPS>
__global__ void __launch_bounds__(tile::THREADS) c3_fp_kernel(FpArgs p) {
  using namespace si::tile;
  __shared__ __align__(16) FTileA As;  // a tile, K-major
  __shared__ __align__(16) FTileB Bs;  // w tile

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int N = p.N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int nseg = TAPS ? 9 : (p.a2 != nullptr ? 2 : 1);
  for (int seg = 0; seg < nseg; ++seg) {
    const bool first = TAPS || seg == 0;
    const T* a = static_cast<const T*>(first ? p.a1 : p.a2);
    const int K = first ? p.k1 : p.k2;
    const T* w = static_cast<const T*>(first ? p.w1 : p.w2) +
                 (TAPS ? static_cast<int64_t>(seg) * K * N : 0);
    const int dy = seg / 3 - 1, dx = seg % 3 - 1;
    const auto row = [=](int r) -> int64_t {
      const int64_t gm = m0 + r;
      return TAPS ? tap_row(gm, p.M, p.H, p.W, dy, dx) : (gm < p.M ? gm : -1);
    };
    for (int k0 = 0; k0 < K; k0 += BK) {
      stage_a_f32(As, a, row, k0, K, tid);
      stage_w_f32(Bs, w, k0, n0, K, N, tid);
      __syncthreads();
      fma_step(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }

  // epilogue in registers, rows outer so a thread's image changes rarely
  const int64_t hw = static_cast<int64_t>(p.H) * p.W;
  int64_t cur_img = -1;
  float cur_max = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty * TM + i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      const float v = activate(acc[i][j] + load_bias(p.bias, p.bias_dtype, gn),
                               p.act, p.act_arg);
      const int64_t o = gm * N + gn;
      if constexpr (TAPS) {
        T* y = static_cast<T*>(p.y);
        const float z = round_to<T>(v);
        y[o] = from_f32<T>(p.shortcut ? z + to_f32(y[o]) : z);
      } else {
        static_cast<TO*>(p.out)[o] = from_f32<TO>(v);
        if (p.amax != nullptr) {
          const int64_t img = gm / hw;
          if (img != cur_img) {
            if (cur_img >= 0) atomicMax(p.amax + cur_img, __float_as_int(cur_max));
            cur_img = img;
            cur_max = 0.0f;
          }
          cur_max = fmaxf(cur_max, fabsf(v));
        }
      }
    }
  }
  if (!TAPS && p.amax != nullptr && cur_img >= 0)
    atomicMax(p.amax + cur_img, __float_as_int(cur_max));
}

dim3 grid_of(int M, int N) {
  return dim3((M + tile::BM - 1) / tile::BM, (N + tile::BN - 1) / tile::BN);
}

const float* F32(const void* p) { return static_cast<const float*>(p); }

// element n of a bias vector of `dtype` (f32 or bf16)
const void* at(const void* bias, int dtype, int64_t n) {
  return static_cast<const char*>(bias) + n * (dtype == DT_BF16 ? 2 : 4);
}

template <typename T, typename TO>
cudaError_t pointwise(const void* a1, const void* w1, int k1, const void* a2,
                      const void* w2, int k2, const void* bias,
                      int bias_dtype, void* out, int* amax, int M, int N,
                      int H, int W, int act, float act_arg, cudaStream_t st) {
  FpArgs p{a1, w1, k1, a2, w2, k2, bias, bias_dtype, out, nullptr, 0, amax,
           M, N, H, W, act, act_arg};
  c3_fp_kernel<T, TO, false><<<grid_of(M, N), tile::THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

struct Block {
  const void *x, *cv1_w, *cv2_w, *cv3_w1, *cv3_w2, *a_w, *b_w;
  const void *cv1_b, *cv2_b, *cv3_b, *a_b, *b_b;  // of bias_dtype
  int bias_dtype;
  const float* b_scale;
  void* ybuf;    // [M, 2 hid] of T
  void* abuf;    // [M, hid] f32 (or T)
  int8_t* qbuf;  // [M, hid] int8 (s8 taps)
  int* amax;     // [n]
  void* out;
  int n, h, w, c, hid, oc, nbtl, shortcut, act;
  float act_arg;
};

// bf16 on the tensor cores (c, hid, oc multiples of 8, operands aligned)
cudaError_t run_block_tc(const Block& b, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const int M = b.n * b.h * b.w;
  const int hid = b.hid;
  const int64_t ld = 2 * static_cast<int64_t>(hid);
  const int64_t hh = static_cast<int64_t>(hid) * hid;
  const bool s8 = b.b_scale != nullptr;
  bf* y = static_cast<bf*>(b.ybuf);
  TcArgs p{};
  p.M = M;
  p.H = b.h;
  p.W = b.w;
  p.act = b.act;
  p.act_arg = b.act_arg;
  // cv1 | cv2 -> ybuf's two halves
  p.a = static_cast<const bf*>(b.x);
  p.lda = b.c;
  p.K = b.c;
  p.w1 = static_cast<const bf*>(b.cv1_w);
  p.w2 = static_cast<const bf*>(b.cv2_w);
  p.col_split = hid;
  p.b1 = b.cv1_b;
  p.b2 = b.cv2_b;
  p.bias_dtype = b.bias_dtype;
  p.out = y;
  p.ldo = ld;
  p.N = 2 * hid;
  cudaError_t err = launch_tc<1, OUT_STORE>(p, st);
  p.col_split = 0;
  p.w2 = nullptr;
  p.b2 = nullptr;
  for (int t = 0; t < b.nbtl && err == cudaSuccess; ++t) {
    // the bottleneck 1x1 over y1 (row stride 2 hid)
    p.a = y;
    p.lda = ld;
    p.K = hid;
    p.N = hid;
    p.w1 = static_cast<const bf*>(b.a_w) + t * hh;
    p.b1 = at(b.a_b, b.bias_dtype, t * hid);
    p.out = b.abuf;
    p.ldo = hid;
    if (s8) {
      err = cudaMemsetAsync(b.amax, 0, sizeof(int) * b.n, st);
      if (err != cudaSuccess) break;
      p.amax = b.amax;
      err = launch_tc<1, OUT_F32_AMAX>(p, st);
      if (err != cudaSuccess) break;
      S8Args q{b.qbuf, b.amax, static_cast<const int8_t*>(b.b_w) + t * 9 * hh,
               b.b_scale + t * hid, at(b.b_b, b.bias_dtype, t * hid),
               b.bias_dtype, y, ld, b.shortcut, M, hid, hid, b.h, b.w, b.act,
               b.act_arg};
      err = s8_taps<bf>(static_cast<const float*>(b.abuf), b.qbuf, b.amax,
                        q, st);
    } else {
      err = launch_tc<1, OUT_STORE>(p, st);
      if (err != cudaSuccess) break;
      // the 3x3 over a, residual into y1
      TcArgs r = p;
      r.a = static_cast<const bf*>(b.abuf);
      r.lda = hid;
      r.w1 = static_cast<const bf*>(b.b_w) + t * 9 * hh;
      r.b1 = at(b.b_b, b.bias_dtype, t * hid);
      r.out = y;
      r.ldo = ld;
      r.shortcut = b.shortcut;
      err = launch_tc<9, OUT_RESIDUAL>(r, st);
    }
  }
  if (err != cudaSuccess) return err;
  // cv3 over [y1 | y2], its w rows from cv3_w1 then cv3_w2
  p.a = y;
  p.lda = ld;
  p.K = 2 * hid;
  p.N = b.oc;
  p.w1 = static_cast<const bf*>(b.cv3_w1);
  p.w2 = static_cast<const bf*>(b.cv3_w2);
  p.row_split = hid;
  p.b1 = b.cv3_b;
  p.out = b.out;
  p.ldo = b.oc;
  p.amax = nullptr;
  return launch_tc<1, OUT_STORE>(p, st);
}

// f32 (or bf16 with widths off 8) on the f32-FMA tile; y1 is ybuf's
// first M * hid elements, y2 reuses abuf
template <typename T>
cudaError_t run_block_fma(const Block& b, cudaStream_t st) {
  const int M = b.n * b.h * b.w;
  const int hid = b.hid;
  const bool s8 = b.b_scale != nullptr;
  const int64_t hh = static_cast<int64_t>(hid) * hid;
  void* y1 = b.ybuf;
  const int bd = b.bias_dtype;
  cudaError_t err = pointwise<T, T>(b.x, b.cv1_w, b.c, nullptr, nullptr, 0,
                                    b.cv1_b, bd, y1, nullptr, M, hid, b.h,
                                    b.w, b.act, b.act_arg, st);
  for (int t = 0; t < b.nbtl && err == cudaSuccess; ++t) {
    const void* aw = static_cast<const T*>(b.a_w) + t * hh;
    if (s8) {
      err = cudaMemsetAsync(b.amax, 0, sizeof(int) * b.n, st);
      if (err != cudaSuccess) break;
      err = pointwise<T, float>(y1, aw, hid, nullptr, nullptr, 0,
                                at(b.a_b, bd, t * hid), bd, b.abuf, b.amax,
                                M, hid, b.h, b.w, b.act, b.act_arg, st);
      if (err != cudaSuccess) break;
      S8Args q{b.qbuf, b.amax, static_cast<const int8_t*>(b.b_w) + t * 9 * hh,
               b.b_scale + t * hid, at(b.b_b, bd, t * hid), bd, y1, hid,
               b.shortcut, M, hid, hid, b.h, b.w, b.act, b.act_arg};
      err = s8_taps<T>(static_cast<const float*>(b.abuf), b.qbuf, b.amax, q,
                       st);
    } else {
      err = pointwise<T, T>(y1, aw, hid, nullptr, nullptr, 0,
                            at(b.a_b, bd, t * hid), bd, b.abuf, nullptr, M,
                            hid, b.h, b.w, b.act, b.act_arg, st);
      if (err != cudaSuccess) break;
      FpArgs p{b.abuf, static_cast<const T*>(b.b_w) + t * 9 * hh, hid,
               nullptr, nullptr, 0, at(b.b_b, bd, t * hid), bd, nullptr, y1,
               b.shortcut, nullptr, M, hid, b.h, b.w, b.act, b.act_arg};
      c3_fp_kernel<T, T, true><<<grid_of(M, hid), tile::THREADS, 0, st>>>(p);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return err;
  // y2 reuses the bottleneck buffer, which the chain no longer needs
  err = pointwise<T, T>(b.x, b.cv2_w, b.c, nullptr, nullptr, 0, b.cv2_b, bd,
                        b.abuf, nullptr, M, hid, b.h, b.w, b.act, b.act_arg,
                        st);
  if (err != cudaSuccess) return err;
  return pointwise<T, T>(y1, b.cv3_w1, hid, b.abuf, b.cv3_w2, hid, b.cv3_b,
                         bd, b.out, nullptr, M, b.oc, b.h, b.w, b.act,
                         b.act_arg, st);
}

bool tc_route(const Block& b) {
  if (b.c % 8 || b.hid % 8 || b.oc % 8) return false;
  const void* ptrs[] = {b.x, b.cv1_w, b.cv2_w, b.cv3_w1, b.cv3_w2, b.a_w,
                        b.b_w, b.ybuf, b.abuf, b.out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

// Plain C entry point for ctypes. Enqueues the block's kernels (and,
// with s8 taps, one memset of the abs-max slots per bottleneck) on
// `stream`, does not synchronise, allocates nothing; returns the first
// cudaError_t. x and out: [n, h, w, c|oc] of `dtype` (f32 or bf16);
// weights of the same dtype: cv1_w / cv2_w [c, hid], cv3_w1 / cv3_w2
// [hid, oc], a_w [T, hid, hid], b_w [T, 9, hid, hid] (int8 when b_scale,
// f32 [T, hid], is given); biases of bias_dtype (f32 or bf16), b_scale
// f32. Workspace: ybuf [n*h*w*2*hid] of
// dtype, abuf [n*h*w*hid] f32, qbuf [n*h*w*hid] int8 (with b_scale, else
// may be null), amax [n] int32. bf16 takes the tensor cores when c, hid
// and oc are multiples of 8 and every operand is 16-byte aligned; the
// route taken is returned in *route (1 tensor cores, 0 f32-FMA tile).
extern "C" int si_c3_block(const void* x, int dtype, int bias_dtype,
                           const void* cv1_w,
                           const void* cv1_b, const void* cv2_w,
                           const void* cv2_b, const void* cv3_w1,
                           const void* cv3_w2, const void* cv3_b,
                           const void* a_w, const void* a_b, const void* b_w,
                           const void* b_b, const void* b_scale, void* ybuf,
                           void* abuf, void* qbuf, void* amax, void* out,
                           int n, int h, int w, int c, int hid, int oc,
                           int nbtl, int shortcut, int act, float act_arg,
                           int* route, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || hid <= 0 || oc <= 0 ||
      nbtl < 0)
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  if (b_scale != nullptr && qbuf == nullptr) return cudaErrorInvalidValue;
  if (bias_dtype != DT_F32 && bias_dtype != DT_BF16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Block b{x, cv1_w, cv2_w, cv3_w1, cv3_w2, a_w, b_w,
                cv1_b, cv2_b, cv3_b, a_b, b_b, bias_dtype,
                F32(b_scale), ybuf, abuf, static_cast<int8_t*>(qbuf),
                static_cast<int*>(amax), out, n, h, w, c, hid, oc, nbtl,
                shortcut, act, act_arg};
  switch (dtype) {
    case DT_F32:
      if (route != nullptr) *route = 0;
      return run_block_fma<float>(b, st);
    case DT_BF16: {
      const bool tc = tc_route(b);
      if (route != nullptr) *route = tc ? 1 : 0;
      return tc ? run_block_tc(b, st) : run_block_fma<__nv_bfloat16>(b, st);
    }
    default:
      return cudaErrorInvalidValue;
  }
}
