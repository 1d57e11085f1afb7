// Tiled GEMM with a fused dequant / bias / activation epilogue, for Hopper.
//
// Replaces the Pallas TPU kernel `_matmul_kernel` behind `matmul` and
// `matmul_int8w` (simpleinfer_tpu/kernels/matmul.py, pallas_call in
// `_matmul_impl`):
//
//     out[M,N] = act((x[M,K] @ w[K,N]) * scale[N]? + bias[N]?)
//
// with f32 accumulation, for any M, N and K.
//
// What bounds it on an H100: at the YOLOv5s pointwise-conv shapes
// (K = 32..512, N = 32..256, M = 8*H*W = 3,200..204,800) the work is a
// few hundred FLOPs per byte of x and out at most, so the bytes of x and
// out set the floor (3.35 TB/s); w is small and stays in L2. The design
// therefore aims at reading x once and writing out once:
//   - one 64x64 output tile per block, K walked in a loop inside the
//     block (the TPU's sequential K grid axis with a VMEM accumulator
//     becomes registers; blocks run in parallel in no order): the f32
//     tile of csrc/tiles.cuh;
//   - x and w tiles are converted to f32 as they are staged into shared
//     memory, so an int8 weight is read as 1 byte and dequantized by
//     scale[n] once per output in the epilogue (the scale is constant
//     along K);
//   - f32 operands use plain fp32 FMA: no TF32, and none of the bf16
//     hi/lo split the Pallas body needs because the TPU MXU multiplies
//     in bf16;
//   - ragged edges are masked loads and stores: no padded copies of x,
//     w or out (the Pallas wrapper pads to 256/256/512 tiles);
//   - the epilogue (scale, bias, activation, cast) runs in registers
//     before the one store of out.
// Tensor cores (mma.sync / wgmma) and TMA are later work; this version is
// the simple, right one.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/matmul.py does this at
//             first use) and called through ctypes via `si_matmul`.

#include "tiles.cuh"

namespace {

using namespace si;
using namespace si::tile;

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(THREADS)
si_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                 const float* __restrict__ scale,
                 const void* __restrict__ bias, int bias_dtype,
                 TO* __restrict__ out, int M, int N, int K, int act,
                 float act_arg) {
  __shared__ __align__(16) FTileA As;  // x tile, K-major
  __shared__ __align__(16) FTileB Bs;  // w tile

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const auto row = [=](int r) -> int64_t {
    return m0 + r < M ? m0 + r : -1;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_a_f32(As, x, row, k0, K, tid);
    stage_w_f32(Bs, w, k0, n0, K, N, tid);
    __syncthreads();
    fma_step(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  // epilogue in registers: dequant scale, bias, activation, cast, store
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    if (gn >= N) continue;
    const float s = scale != nullptr ? scale[gn] : 1.0f;
    float b = 0.0f;
    if (bias != nullptr) {
      b = bias_dtype == DT_BF16
              ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[gn])
              : static_cast<const float*>(bias)[gn];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gm = m0 + ty * TM + i;
      if (gm >= M) continue;
      float v = acc[i][j];
      if (scale != nullptr) v *= s;
      if (bias != nullptr) v += b;
      out[gm * N + gn] = from_f32<TO>(activate(v, act, act_arg));
    }
  }
}

template <typename TX, typename TW, typename TO>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const void* bias, int bias_dtype, void* out, int M, int N,
                   int K, int act, float act_arg, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  si_matmul_kernel<TX, TW, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), scale, bias,
      bias_dtype, static_cast<TO*>(out), M, N, K, act, act_arg);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t dispatch_out(int out_dtype, const void* x, const void* w,
                         const float* scale, const void* bias, int bias_dtype,
                         void* out, int M, int N, int K, int act,
                         float act_arg, cudaStream_t stream) {
  switch (out_dtype) {
    case DT_F32:
      return launch<TX, TW, float>(x, w, scale, bias, bias_dtype, out, M, N,
                                   K, act, act_arg, stream);
    case DT_BF16:
      return launch<TX, TW, __nv_bfloat16>(x, w, scale, bias, bias_dtype,
                                           out, M, N, K, act, act_arg,
                                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t dispatch_w(int w_dtype, int out_dtype, const void* x,
                       const void* w, const float* scale, const void* bias,
                       int bias_dtype, void* out, int M, int N, int K,
                       int act, float act_arg, cudaStream_t stream) {
  switch (w_dtype) {
    case DT_F32:
      return dispatch_out<TX, float>(out_dtype, x, w, scale, bias,
                                     bias_dtype, out, M, N, K, act, act_arg,
                                     stream);
    case DT_BF16:
      return dispatch_out<TX, __nv_bfloat16>(out_dtype, x, w, scale, bias,
                                             bias_dtype, out, M, N, K, act,
                                             act_arg, stream);
    case DT_I8:
      return dispatch_out<TX, int8_t>(out_dtype, x, w, scale, bias,
                                      bias_dtype, out, M, N, K, act,
                                      act_arg, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// `scale` (f32 [N]) and `bias` ([N], f32 or bf16) may be null.
extern "C" int si_matmul(const void* x, int x_dtype, const void* w,
                         int w_dtype, const void* scale, const void* bias,
                         int bias_dtype, void* out, int out_dtype, int M,
                         int N, int K, int act, float act_arg,
                         void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  if (bias != nullptr && bias_dtype != DT_F32 && bias_dtype != DT_BF16)
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case DT_F32:
      return dispatch_w<float>(w_dtype, out_dtype, x, w, s, bias, bias_dtype,
                               out, M, N, K, act, act_arg, st);
    case DT_BF16:
      return dispatch_w<__nv_bfloat16>(w_dtype, out_dtype, x, w, s, bias,
                                       bias_dtype, out, M, N, K, act,
                                       act_arg, st);
    default:
      return cudaErrorInvalidValue;
  }
}
