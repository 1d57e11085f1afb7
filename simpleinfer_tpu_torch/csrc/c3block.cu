// The whole YOLOv5 C3 block for Hopper: cv1 / cv2 1x1, T bottlenecks
// (1x1, 3x3 "same", optional residual) and cv3 over the never
// materialized concat, with optional int8 3x3 taps.
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
// What bounds it on an H100: at yolov5l-640-b16 C3_1 (160x160, C 128,
// hid 64, T 3) the block is ~127 GFLOP against ~210 MB of its own input
// and output: operations bound it (0.13 ms at 989 TFLOP/s bf16) above
// its bytes (0.06 ms at 3.35 TB/s); the unfused chain would move
// ~11 intermediates of 52-105 MB each through device memory on top.
//
// Design. The TPU kernel keeps a whole image in ~100 MB of VMEM and
// walks it in row bands of 32 with halo rows recomputed. A Hopper block
// has 227 KB of shared memory, and a C3_1 band of 38 rows is 0.8 MB in
// bf16, so here the intermediates live in a workspace the wrapper
// allocates (y1 and one bottleneck activation; ~160 MB at C3_1 b16,
// much of it in the 50 MB L2), and the block is a SPLIT into one kernel
// per stage, 2T + 3 launches enqueued by one call of `si_c3_block`:
//   - the s8 taps quantize per IMAGE, which needs the abs-max over every
//     row of the image before the 3x3 starts. A stage boundary is that
//     grid-wide barrier: the 1x1 kernel's epilogue folds its |a| into the
//     image's abs-max with atomicMax on the bits of a non-negative float,
//     the next kernel reads it. A cooperative kernel with grid.sync()
//     would need all of its blocks resident at once (16 images x 5 bands
//     = 80 blocks at C3_1 b16, leaving 52 of 132 SMs idle) and would
//     recompute halo rows: 2T/rh more 3x3 work per band, 19% at C3_1 and
//     60-90% at C3_2/C3_3 (rh 20, T 6/9). Split kernels tile the whole
//     batch with no halo and fill every SM;
//   - the concat never materializes: cv3 sums two K segments (y1 with
//     cv3_w1, y2 with cv3_w2), as the TPU kernel's split cv3 does;
//   - each stage is a 64x64-tile GEMM over all N*H*W pixels, K walked in
//     a loop inside the block; the 3x3 is 9 shifted taps of that loop,
//     the shift and the zero "same" padding computed per staged row
//     (no im2col, no padded copies); the residual add updates y1 in
//     place in the 3x3's epilogue;
//   - fp taps and every 1x1 multiply in f32 FMA on the CUDA cores; s8
//     taps quantize a while staging it and multiply with __dp4a into an
//     exact int32 sum: the f32 and int8 tiles of csrc/tiles.cuh, which
//     csrc/matmul.cu and csrc/matmul_s8s8.cu use too;
//   - bias, activation, rounding to T and the residual run in registers
//     in each epilogue.
// Tensor cores (mma.sync / wgmma), TMA and keeping a tile's chain in
// shared memory are later work; this version is the simple, right one.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/c3block.py does this at
//             first use) and called through ctypes via `si_c3_block`.

#include "tiles.cuh"

namespace {

using namespace si;
using namespace si::tile;   // 64 pixels x 64 channels per block

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// the image's s8 activation scale from its abs-max bits
__device__ __forceinline__ float image_scale(const int* amax, int64_t img) {
  return fmaxf(__int_as_float(amax[img]), 1e-8f) / 127.0f;
}

struct FpArgs {
  const void* a1;   // [M, k1] (T), or the [N, H, W, k1] tap input
  const void* w1;   // [k1, N] (T), or taps [9, k1, N]
  int k1;
  const void* a2;   // optional second K segment (cv3's y2 half)
  const void* w2;
  int k2;
  const float* bias;  // [N]
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
__global__ void __launch_bounds__(THREADS) c3_fp_kernel(FpArgs p) {
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
      const float v = activate(acc[i][j] + p.bias[gn], p.act, p.act_arg);
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

struct S8Args {
  const float* a;     // [N, H, W, K] f32 activation of the bottleneck 1x1
  const int* amax;    // per-image abs-max bits of `a`
  const int8_t* w;    // taps [9, K, N] int8, per-output-channel quantized
  const float* wsc;   // [N] tap weight scales
  const float* bias;  // [N]
  void* y;            // y1 [M, N] (T), updated in place
  int shortcut;
  int M, N, K, H, W;
  int act;
  float act_arg;
};

// One 64x64 output tile of the s8-tap 3x3: a is quantized per image as
// it is staged, 4 channels to a word; w is staged transposed to [n][k];
// __dp4a sums exactly in int32; the epilogue dequantizes by
// s_img * wsc[n] and adds the residual.
template <typename T>
__global__ void __launch_bounds__(THREADS) c3_s8_tap_kernel(S8Args p) {
  __shared__ WTile As;
  __shared__ WTile Bs;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int N = p.N, K = p.K;
  const int64_t hw = static_cast<int64_t>(p.H) * p.W;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int8_t* w = p.w + static_cast<int64_t>(tap) * K * N;
    for (int k0 = 0; k0 < K; k0 += BK8) {
#pragma unroll
      for (int i = 0; i < (BM * KW8) / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / KW8, c = e % KW8;
        const int64_t gm = m0 + r;
        const int64_t src = tap_row(gm, p.M, p.H, p.W, dy, dx);
        int v = 0;
        if (src >= 0) {
          const float s = image_scale(p.amax, gm / hw);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int gk = k0 + 4 * c + b;
            if (gk < K) {
              // round half to even, as jnp.round / torch.round
              const float q = fminf(fmaxf(rintf(p.a[src * K + gk] / s),
                                          -127.0f), 127.0f);
              v |= (static_cast<int>(q) & 0xff) << (8 * b);
            }
          }
        }
        As[r][c] = v;
      }
      stage_w_s8(Bs, w, k0, n0, K, N, tid);
      __syncthreads();
      dp4a_step(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }

  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
    if (gm >= p.M) continue;
    const float s = image_scale(p.amax, gm / hw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float v = __int2float_rn(acc[i][j]) * (s * p.wsc[gn]) + p.bias[gn];
      const float z = round_to<T>(activate(v, p.act, p.act_arg));
      const int64_t o = gm * N + gn;
      y[o] = from_f32<T>(p.shortcut ? z + to_f32(y[o]) : z);
    }
  }
}

dim3 grid_of(int M, int N) {
  return dim3((M + BM - 1) / BM, (N + BN - 1) / BN);
}

const float* F32(const void* p) { return static_cast<const float*>(p); }

template <typename T, typename TO>
cudaError_t pointwise(const void* a1, const void* w1, int k1, const void* a2,
                      const void* w2, int k2, const float* bias, void* out,
                      int* amax, int M, int N, int H, int W, int act,
                      float act_arg, cudaStream_t st) {
  FpArgs p{a1, w1, k1, a2, w2, k2, bias, out, nullptr, 0, amax,
           M, N, H, W, act, act_arg};
  c3_fp_kernel<T, TO, false><<<grid_of(M, N), THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_block(const void* x, const void* cv1_w, const float* cv1_b,
                      const void* cv2_w, const float* cv2_b,
                      const void* cv3_w1, const void* cv3_w2,
                      const float* cv3_b, const void* a_w, const float* a_b,
                      const void* b_w, const float* b_b, const float* b_scale,
                      void* y1, void* abuf, int* amax, void* out, int n,
                      int h, int w, int c, int hid, int oc, int nbtl,
                      int shortcut, int act, float act_arg, cudaStream_t st) {
  const int M = n * h * w;
  const bool s8 = b_scale != nullptr;
  const int64_t hh = static_cast<int64_t>(hid) * hid;
  cudaError_t err = pointwise<T, T>(x, cv1_w, c, nullptr, nullptr, 0, cv1_b,
                                    y1, nullptr, M, hid, h, w, act, act_arg,
                                    st);
  for (int t = 0; t < nbtl && err == cudaSuccess; ++t) {
    const void* aw = static_cast<const T*>(a_w) + t * hh;
    if (s8) {
      err = cudaMemsetAsync(amax, 0, sizeof(int) * n, st);
      if (err != cudaSuccess) break;
      err = pointwise<T, float>(y1, aw, hid, nullptr, nullptr, 0,
                                a_b + t * hid, abuf, amax, M, hid, h, w, act,
                                act_arg, st);
      if (err != cudaSuccess) break;
      S8Args p{static_cast<const float*>(abuf), amax,
               static_cast<const int8_t*>(b_w) + t * 9 * hh,
               b_scale + t * hid, b_b + t * hid, y1, shortcut,
               M, hid, hid, h, w, act, act_arg};
      c3_s8_tap_kernel<T><<<grid_of(M, hid), THREADS, 0, st>>>(p);
      err = cudaGetLastError();
    } else {
      err = pointwise<T, T>(y1, aw, hid, nullptr, nullptr, 0, a_b + t * hid,
                            abuf, nullptr, M, hid, h, w, act, act_arg, st);
      if (err != cudaSuccess) break;
      FpArgs p{abuf, static_cast<const T*>(b_w) + t * 9 * hh, hid, nullptr,
               nullptr, 0, b_b + t * hid, nullptr, y1, shortcut, nullptr,
               M, hid, h, w, act, act_arg};
      c3_fp_kernel<T, T, true><<<grid_of(M, hid), THREADS, 0, st>>>(p);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return err;
  // y2 reuses the bottleneck buffer, which the chain no longer needs
  err = pointwise<T, T>(x, cv2_w, c, nullptr, nullptr, 0, cv2_b, abuf,
                        nullptr, M, hid, h, w, act, act_arg, st);
  if (err != cudaSuccess) return err;
  return pointwise<T, T>(y1, cv3_w1, hid, abuf, cv3_w2, hid, cv3_b, out,
                         nullptr, M, oc, h, w, act, act_arg, st);
}

}  // namespace

// Plain C entry point for ctypes. Enqueues the block's 2T + 3 kernels
// (and, with s8 taps, one memset of the abs-max slots per bottleneck) on
// `stream`, does not synchronise, allocates nothing; returns the first
// cudaError_t. x and out: [n, h, w, c|oc] of `dtype` (f32 or bf16);
// weights of the same dtype: cv1_w / cv2_w [c, hid], cv3_w1 / cv3_w2
// [hid, oc], a_w [T, hid, hid], b_w [T, 9, hid, hid] (int8 when b_scale,
// f32 [T, hid], is given); biases f32. Workspace: y1 [n*h*w*hid] of
// dtype, abuf [n*h*w*hid] f32, amax [n] int32.
extern "C" int si_c3_block(const void* x, int dtype, const void* cv1_w,
                           const void* cv1_b, const void* cv2_w,
                           const void* cv2_b, const void* cv3_w1,
                           const void* cv3_w2, const void* cv3_b,
                           const void* a_w, const void* a_b, const void* b_w,
                           const void* b_b, const void* b_scale, void* y1,
                           void* abuf, void* amax, void* out, int n, int h,
                           int w, int c, int hid, int oc, int nbtl,
                           int shortcut, int act, float act_arg,
                           void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || hid <= 0 || oc <= 0 ||
      nbtl < 0)
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* am = static_cast<int*>(amax);
  switch (dtype) {
    case DT_F32:
      return run_block<float>(x, cv1_w, F32(cv1_b), cv2_w, F32(cv2_b),
                              cv3_w1, cv3_w2, F32(cv3_b), a_w, F32(a_b), b_w,
                              F32(b_b), F32(b_scale), y1, abuf, am, out, n, h,
                              w, c, hid, oc, nbtl, shortcut, act, act_arg,
                              st);
    case DT_BF16:
      return run_block<__nv_bfloat16>(
          x, cv1_w, F32(cv1_b), cv2_w, F32(cv2_b), cv3_w1, cv3_w2, F32(cv3_b),
          a_w, F32(a_b), b_w, F32(b_b), F32(b_scale), y1, abuf, am, out, n, h,
          w, c, hid, oc, nbtl, shortcut, act, act_arg, st);
    default:
      return cudaErrorInvalidValue;
  }
}
