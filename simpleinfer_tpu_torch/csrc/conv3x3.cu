// 3x3 stride-1 "same" conv as an implicit GEMM, for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` behind `conv3x3_s1_same`
// (simpleinfer_tpu/kernels/conv3x3.py, pallas_call in `conv3x3_s1_same`):
//
//     out[n, y, x, o] = act(sum over (dy, dx, c) of
//                           x[n, y + dy - 1, x + dx - 1, c] * w[dy, dx, c, o]
//                           + bias[o])
//
// on an NHWC map x [N, H, W, C] (f32 or bf16 = T) with w [3, 3, C, OC]
// in T (HWIO), f32 bias, f32 sums, one rounding to T at the store.
//
// What bounds it on an H100: at the ResNet-50-224-b128 3x3 convs (56^2 x
// 64 -> 64 to 7^2 x 512 -> 512) and the YOLOv5s-640-b8 C3 bottlenecks the
// work is 2 * 9 * C * OC operations per pixel against 2 * (C + OC) bytes
// of bf16 input and output: 288 to 2,300 FLOPs per byte, at or above the
// card's bf16 ridge (~295), so the bf16 tensor-core rate bounds the big
// ones; the kernel runs on the CUDA cores in f32 FMA, far above that
// bound, as the port's other first kernels do.
//
// Design. The TPU kernel holds a whole image flat in VMEM and builds each
// tap as a `jnp.roll` of it by the tap's flat shift, masked where the
// shift wraps across a row or falls off the image. Here each 64-pixel x
// 64-channel output tile is a block, and the 9 taps are 9 K segments of
// the f32 tile loop of csrc/tiles.cuh: per tap the block computes, once,
// each of its 64 rows' source pixel (y + dy, x + dx), or -1 where that
// lies off the image (`tap_row`, shared with csrc/c3block.cu), and stages
// the tap's [64, 32] slice of x from those rows, zeros for -1. No roll,
// no mask tensor, no padded copy of x; any H, W, C and OC, ragged edges
// masked. The bias + activation epilogue runs in registers before the one
// store. Tensor cores (mma.sync / wgmma) and TMA are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/conv3x3.py does this at
//             first use) and called through ctypes via `si_conv3x3`.

#include "tiles.cuh"

namespace {

using namespace si;
using namespace si::tile;

template <typename T>
__global__ void __launch_bounds__(THREADS)
si_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out,
                  int M, int H, int W, int C, int OC, int act,
                  float act_arg) {
  __shared__ __align__(16) FTileA As;  // x tile, K-major
  __shared__ __align__(16) FTileB Bs;  // w tile
  __shared__ int64_t src[BM];          // the tap's source row of each row

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t* rows = src;
  const auto row = [=](int r) -> int64_t { return rows[r]; };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    // the previous tap's last __syncthreads ends every read of src
    if (tid < BM) src[tid] = tap_row(m0 + tid, M, H, W, tap / 3 - 1,
                                     tap % 3 - 1);
    __syncthreads();
    const T* wt = w + static_cast<int64_t>(tap) * C * OC;
    for (int k0 = 0; k0 < C; k0 += BK) {
      stage_a_f32(As, x, row, k0, C, tid);
      stage_w_f32(Bs, wt, k0, n0, C, OC, tid);
      __syncthreads();
      fma_step(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }

  // epilogue in registers: bias, activation, cast, store
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    if (gn >= OC) continue;
    const float b = bias[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gm = m0 + ty * TM + i;
      if (gm >= M) continue;
      out[gm * OC + gn] = from_f32<T>(activate(acc[i][j] + b, act, act_arg));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias,
                   void* out, int M, int H, int W, int C, int OC, int act,
                   float act_arg, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (OC + BN - 1) / BN);
  si_conv3x3_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), M, H, W, C, OC, act, act_arg);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// x [n, h, w, c] and out [n, h, w, oc] of `dtype` (f32 or bf16), w
// [3, 3, c, oc] of the same dtype, bias f32 [oc] (not null).
extern "C" int si_conv3x3(const void* x, int dtype, const void* w,
                          const void* bias, void* out, int n, int h, int w_,
                          int c, int oc, int act, float act_arg,
                          void* stream) {
  if (n <= 0 || h <= 0 || w_ <= 0 || c <= 0 || oc <= 0 || bias == nullptr)
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  const int M = n * h * w_;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<float>(x, w, b, out, M, h, w_, c, oc, act, act_arg, st);
    case DT_BF16:
      return launch<__nv_bfloat16>(x, w, b, out, M, h, w_, c, oc, act,
                                   act_arg, st);
    default:
      return cudaErrorInvalidValue;
  }
}
