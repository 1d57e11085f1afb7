// Static-int8 GEMM, s8 x s8 -> exact s32, with a fused dequant / bias /
// activation epilogue, for Hopper.
//
// Replaces the Pallas TPU kernel `_matmul_s8s8_kernel` behind
// `matmul_s8s8` (simpleinfer_tpu/kernels/matmul.py, pallas_call in
// `_matmul_s8s8_impl`):
//
//     out[M,N] = act(float(sum_k x[m,k] * w[k,n]) * scale[n] + bias[n]?)
//
// with the sum exact in int32 (|acc| <= K * 127^2), for any M, N and K.
// `scale` is act_scale * w_scale per output channel, or w_scale alone
// when per-channel activation scales were folded into the weight
// (ops/conv.int8_epilogue's convention). Out is f32 or bf16.
//
// The port's callers: the static-int8 kxk convs (ops/conv.py, over an
// int8 im2col of the NHWC input: M = N*OH*OW, K = KH*KW*IC, N = OC) and
// the static-int8 nn.Linear (ops/linear.py). PyTorch has no int8
// convolution on CUDA, so this kernel is the exact s8 product the JAX
// package gets from XLA's s8 conv.
//
// What bounds it on an H100: at the YOLOv5l-640-b16 3x3 s2 convs
// (K = 1,152..4,608, N = 256..1,024) the operations at 1,979 TOP/s int8
// and the conv's own bytes at 3.35 TB/s take about as long (~0.03 ms
// for the 128->256 conv: 60 GOP, ~105 MB). This first version is the
// simple, right one and reaches neither: it multiplies on the CUDA cores
// with __dp4a (4 int8 products summed into an int32 per instruction):
//   - one 64x64 output tile per block, 256 threads of 4x4 outputs each,
//     K walked in 64-byte steps inside the block (the TPU's sequential
//     K grid axis with a VMEM s32 accumulator becomes registers);
//   - x and w tiles are staged into shared memory as 32-bit words of 4
//     consecutive k, w transposed to [n][k] so both operands of a
//     __dp4a are one aligned word; rows padded to 17 words so the reads
//     of a warp hit 16 different banks;
//   - each thread owns rows ty + 16 i and columns tx + 16 j, so the
//     epilogue's stores are coalesced along n (the w staging and the
//     __dp4a loop are the int8 tile of csrc/tiles.cuh);
//   - ragged edges are masked loads and stores: no padded copies (the
//     Pallas wrapper pads to 512/1024/1024 tiles);
//   - the epilogue (int32 -> f32, scale, bias, activation, cast) runs in
//     registers before the one store of out.
// Tensor cores (mma.sync / wgmma s8) and TMA are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/matmul.py does this at
//             first use) and called through ctypes via `si_matmul_s8s8`.

#include "tiles.cuh"

namespace {

using namespace si;
using namespace si::tile;

// 4 consecutive k of row `row` of a row-major [rows, K] int8 matrix as
// one little-endian word (byte b = element k + b), zero past the edge
__device__ __forceinline__ int load_row_word(const int8_t* __restrict__ p,
                                             int64_t row, int rows, int k,
                                             int K, bool aligned) {
  if (row >= rows || k >= K) return 0;
  const int8_t* src = p + row * K + k;
  if (aligned) return *reinterpret_cast<const int*>(src);  // k + 3 < K
  int v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k + b < K) v |= static_cast<int>(static_cast<uint8_t>(src[b])) << (8 * b);
  return v;
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
si_s8s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale,
               const void* __restrict__ bias, int bias_dtype,
               TO* __restrict__ out, int M, int N, int K, int act,
               float act_arg) {
  __shared__ WTile As;  // x tile, [m][k / 4]
  __shared__ WTile Bs;  // w tile transposed, [n][k / 4]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  // whole words straight from global memory when every row starts on a
  // 4-byte boundary
  const bool x_aligned =
      (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK8) {
    // x[m0:m0+BM, k0:k0+BK8]: neighbouring threads read neighbouring words
#pragma unroll
    for (int i = 0; i < (BM * KW8) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / KW8, c = e % KW8;
      As[r][c] = load_row_word(x, m0 + r, M, k0 + 4 * c, K, x_aligned);
    }
    stage_w_s8(Bs, w, k0, n0, K, N, tid);
    __syncthreads();
    dp4a_step(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  // epilogue in registers: exact int32 -> f32 (round to nearest even, as
  // the JAX package's astype), dequant scale, bias, activation, cast
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float s = scale[gn];
    const float bb = bias != nullptr ? load_bias(bias, bias_dtype, gn) : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
      float v = __int2float_rn(acc[i][j]) * s;
      if (bias != nullptr) v += bb;
      out[gm * N + gn] = from_f32<TO>(activate(v, act, act_arg));
    }
  }
}

template <typename TO>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale,
                   const void* bias, int bias_dtype, void* out, int M, int N,
                   int K, int act, float act_arg, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  si_s8s8_kernel<TO><<<grid, THREADS, 0, stream>>>(
      x, w, scale, bias, bias_dtype, static_cast<TO*>(out), M, N, K, act,
      act_arg);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// x: int8 [M, K], w: int8 [K, N] (both row-major), scale: f32 [N],
// bias: [N] f32 or bf16 or null, out: [M, N] f32 or bf16.
extern "C" int si_matmul_s8s8(const void* x, const void* w, const void* scale,
                              const void* bias, int bias_dtype, void* out,
                              int out_dtype, int M, int N, int K, int act,
                              float act_arg, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || scale == nullptr)
    return cudaErrorInvalidValue;
  if (bias != nullptr && bias_dtype != DT_F32 && bias_dtype != DT_BF16)
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case DT_F32:
      return launch<float>(xq, wq, s, bias, bias_dtype, out, M, N, K, act,
                           act_arg, st);
    case DT_BF16:
      return launch<__nv_bfloat16>(xq, wq, s, bias, bias_dtype, out, M, N, K,
                                   act, act_arg, st);
    default:
      return cudaErrorInvalidValue;
  }
}
