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
// What bounds it on an H100: the port runs it as the pointwise convs of
// ResNet-50-224-b128 (33 a forward: M = 128 * H * W = 6,272 .. 401,408,
// K and N 64 .. 2,048, f32 out where a requantize follows) and of
// YOLOv5s-640-b8 / yolov5l-640-b16 (M up to 204,800, N 32 .. 512). There
// the work is at most a few hundred FLOPs per byte of x and out, below
// the card's bf16 ridge (~295 FLOP/byte), so moving x in and out back at
// 3.35 TB/s is the floor: the bytes bound it (out is up to 4x x, as at
// ResNet-50 layer1 conv3: K 64, N 256, f32 out). Only the widest layer4
// convs (K 2,048) come near the tensor cores' rate.
//
// bf16 x with bf16 or int8 w (every launch of the four paths): the bf16
// tensor cores, the tile of csrc/mma.cuh (si::tc).
//   - x comes in by 16-byte cp.async, a [128 x 32] stage at a time, in a
//     ring of 4 stages, so two stages load while the tensor cores work on
//     a third; rows past M and columns past K are zero-filled. Ragged K
//     or unaligned rows stage by element loads instead.
//   - w comes in as its own bytes by cp.async: bf16 straight into the
//     stage's w tile; int8 into a raw tile that the block converts ONCE
//     into the bf16 tile (each thread its own 16 bytes, exact: int8 is
//     exact in bf16), so the weight stays 1 byte in memory and no warp
//     converts fragments of its own. The B fragments then come by
//     ldmatrix.trans, the x fragments by ldmatrix.
//   - mma.sync m16n8k16, bf16 x bf16 -> f32; 8 warps, each 64 x 32 of a
//     128 x 128 output tile (N > 64), or 32 x 32 of a 128 x 64 tile
//     (N <= 64, YOLOv5s's narrow convs; the wrapper picks by N). Blocks
//     walk N fastest, so the blocks in flight share their x rows in L2.
//     One barrier per stage; a stage's int8 bytes are converted by the
//     threads that copied them, between their cp.async wait and it.
//   - The epilogue runs in registers: acc * scale[n] after the MMA (the
//     int8 dequant, as matmul_int8w_ref scales the f32 product), + bias,
//     the activation (all 13 codes; none, relu and silu each compiled
//     into a loop of its own, as instruction fetch of a switch inlined at
//     every output took more time than the stores), the cast; then the
//     tile goes out through shared memory as 16-byte stores along whole
//     rows (storing straight from registers measured slower).
//   - 2 blocks an SM (94 KB of shared memory and <= 128 registers each).
//     On an H100 more blocks an SM, 64-deep stages and a 128 x 64 tile
//     for the narrower grids all measured slower; the tile runs at 1.2 to
//     2.5x the time of torch.addmm at the ResNet-50 shapes.
// f32 x or f32 w (fp32, the parity mode): the exact f32-FMA tile of
// csrc/tiles.cuh (one 64 x 64 output tile per block, operands converted
// to f32 as they are staged, an int8 weight read as 1 byte and
// dequantized by scale[n] in the epilogue). No TF32, and an f32 weight is
// never rounded to bf16: matmul_ref multiplies in f32.
// Ragged edges are masked: no padded copies of x, w or out (the Pallas
// wrapper pads to 256/256/512 tiles). wgmma and TMA are the lever past
// mma.sync.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/build.py) and called
//             through ctypes via `si_matmul`.

#include "mma.cuh"
#include "tiles.cuh"

namespace {

using namespace si;
using namespace si::tile;

// ---- f32 x or f32 w: the exact f32-FMA tile --------------------------------
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

// ---- bf16 x, bf16 or int8 w: the tensor cores -----------------------------
// T: the tile (tc::Wide or tc::Narrow); VX: x rows by 16-byte cp.async
// (K % 8 == 0, x 16-byte aligned), else element loads; vw: the same for w
// (N % 8 bf16 / N % 16 int8, w aligned); vo: 16-byte output stores. 2
// blocks an SM; 1 for the element-staged x (ragged shapes only), whose
// index math spills at 128 registers
template <class T, typename TW, typename TO, bool VX>
__global__ void __launch_bounds__(T::THREADS, VX ? 2 : 1)
si_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const TW* __restrict__ w,
                     const float* __restrict__ scale,
                     const void* __restrict__ bias, int bias_dtype,
                     TO* __restrict__ out, int M, int N, int K, int act,
                     float act_arg, bool vw, bool vo) {
  constexpr bool INT8_W = sizeof(TW) == 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int n0 = blockIdx.x * T::BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * T::BM;
  const int n_stages = (K + tc::BK - 1) / tc::BK;

  // the rows this thread stages, fixed for the whole K walk
  const __nv_bfloat16* src[T::XV];
#pragma unroll
  for (int i = 0; i < T::XV; ++i) {
    const int64_t gm = m0 + T::x_row(tid, i);
    src[i] = gm < M ? x + gm * K : nullptr;
  }

  auto load = [&](int c) {
    uint8_t* st = smem + (c % tc::STAGES) * T::STAGE;
    const int k0 = c * tc::BK;
    if constexpr (VX) {
      tc::stage_x_vec<T>(st, src, x, k0, K, tid);
    } else {
      __nv_bfloat16* xs = tc::x_area(st);
      for (int e = tid; e < T::BM * tc::BK; e += T::THREADS) {
        const int r = e / tc::BK, kk = e % tc::BK;
        const int64_t gm = m0 + r;
        xs[r * tc::XS + kk] = gm < M && k0 + kk < K
                                  ? x[gm * K + k0 + kk]
                                  : __float2bfloat16_rn(0.0f);
      }
    }
    if (vw)
      tc::stage_w_vec<T>(st, w, k0, n0, K, N, tid);
    else
      tc::stage_w_elem<T>(st, w, k0, n0, K, N, tid);
  };

  float acc[T::MT][4][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // a stage's int8 bytes are converted by the threads that copied them
  tc::ring(
      n_stages, load,
      [&](int c) {
        if constexpr (INT8_W) {
          if (vw) tc::convert_w<T>(smem + (c % tc::STAGES) * T::STAGE, tid);
        }
      },
      [&](int c) {
        tc::mma_stage<T>(smem + (c % tc::STAGES) * T::STAGE, acc, wm, wn,
                         lane);
      });
  tc::epilogue_to_smem<T, TO>(smem, acc, scale, bias, bias_dtype, n0, N, act,
                              act_arg, wm, wn, lane);
  __syncthreads();
  tc::store_tile<T, TO>(smem, out, m0, n0, M, N, vo, tid);
}

template <class T, typename TW, typename TO, bool VX>
cudaError_t launch_mma_tile(const __nv_bfloat16* x, const TW* w,
                            const float* scale, const void* bias,
                            int bias_dtype, TO* out, int M, int N, int K,
                            int act, float act_arg, bool vw, bool vo,
                            cudaStream_t stream) {
  static bool done[tc::MAX_DEVICES] = {};
  auto kern = si_matmul_mma_kernel<T, TW, TO, VX>;
  cudaError_t err = tc::allow_smem(kern, T::SMEM, done);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + T::BM - 1) / T::BM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  kern<<<dim3((N + T::BN - 1) / T::BN, m_tiles), T::THREADS, T::SMEM,
         stream>>>(x, w, scale, bias, bias_dtype, out, M, N, K, act, act_arg,
                   vw, vo);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TW, typename TO>
cudaError_t launch_mma(const void* x, const void* w, const float* scale,
                       const void* bias, int bias_dtype, void* out, int M,
                       int N, int K, int act, float act_arg, int block_n,
                       cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wt = static_cast<const TW*>(w);
  auto* o = static_cast<TO*>(out);
  const bool vx = K % 8 == 0 && aligned16(x);
  const bool vw = N % (16 / sizeof(TW)) == 0 && aligned16(w);
  const bool vo = N % (16 / sizeof(TO)) == 0 && aligned16(out);
  if (block_n == 64)
    return vx ? launch_mma_tile<tc::Narrow, TW, TO, true>(
                    xb, wt, scale, bias, bias_dtype, o, M, N, K, act,
                    act_arg, vw, vo, stream)
              : launch_mma_tile<tc::Narrow, TW, TO, false>(
                    xb, wt, scale, bias, bias_dtype, o, M, N, K, act,
                    act_arg, vw, vo, stream);
  if (block_n == 128)
    return vx ? launch_mma_tile<tc::Wide, TW, TO, true>(
                    xb, wt, scale, bias, bias_dtype, o, M, N, K, act,
                    act_arg, vw, vo, stream)
              : launch_mma_tile<tc::Wide, TW, TO, false>(
                    xb, wt, scale, bias, bias_dtype, o, M, N, K, act,
                    act_arg, vw, vo, stream);
  return cudaErrorInvalidValue;
}

template <typename TW>
cudaError_t dispatch_mma(int out_dtype, const void* x, const void* w,
                         const float* scale, const void* bias,
                         int bias_dtype, void* out, int M, int N, int K,
                         int act, float act_arg, int block_n,
                         cudaStream_t stream) {
  switch (out_dtype) {
    case DT_F32:
      return launch_mma<TW, float>(x, w, scale, bias, bias_dtype, out, M, N,
                                   K, act, act_arg, block_n, stream);
    case DT_BF16:
      return launch_mma<TW, __nv_bfloat16>(x, w, scale, bias, bias_dtype,
                                           out, M, N, K, act, act_arg,
                                           block_n, stream);
    default:
      return cudaErrorInvalidValue;
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

cudaError_t dispatch_f32x(int w_dtype, int out_dtype, const void* x,
                          const void* w, const float* scale, const void* bias,
                          int bias_dtype, void* out, int M, int N, int K,
                          int act, float act_arg, cudaStream_t stream) {
  switch (w_dtype) {
    case DT_F32:
      return dispatch_out<float, float>(out_dtype, x, w, scale, bias,
                                        bias_dtype, out, M, N, K, act,
                                        act_arg, stream);
    case DT_BF16:
      return dispatch_out<float, __nv_bfloat16>(out_dtype, x, w, scale, bias,
                                                bias_dtype, out, M, N, K, act,
                                                act_arg, stream);
    case DT_I8:
      return dispatch_out<float, int8_t>(out_dtype, x, w, scale, bias,
                                         bias_dtype, out, M, N, K, act,
                                         act_arg, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// `scale` (f32 [N]) and `bias` ([N], f32 or bf16) may be null. bf16 x
// with bf16 or int8 w runs on the tensor cores in output tiles
// `block_n` (64 or 128) wide; any f32 operand runs the f32-FMA tile and
// ignores `block_n`.
extern "C" int si_matmul(const void* x, int x_dtype, const void* w,
                         int w_dtype, const void* scale, const void* bias,
                         int bias_dtype, void* out, int out_dtype, int M,
                         int N, int K, int act, float act_arg, int block_n,
                         void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  if (bias != nullptr && bias_dtype != DT_F32 && bias_dtype != DT_BF16)
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_F32)
    return dispatch_f32x(w_dtype, out_dtype, x, w, s, bias, bias_dtype, out,
                         M, N, K, act, act_arg, st);
  if (x_dtype != DT_BF16) return cudaErrorInvalidValue;
  switch (w_dtype) {
    case DT_F32:   // an f32 weight stays f32: the FMA tile
      return dispatch_out<__nv_bfloat16, float>(out_dtype, x, w, s, bias,
                                                bias_dtype, out, M, N, K, act,
                                                act_arg, st);
    case DT_BF16:
      return dispatch_mma<__nv_bfloat16>(out_dtype, x, w, s, bias, bias_dtype,
                                         out, M, N, K, act, act_arg, block_n,
                                         st);
    case DT_I8:
      return dispatch_mma<int8_t>(out_dtype, x, w, s, bias, bias_dtype, out,
                                  M, N, K, act, act_arg, block_n, st);
    default:
      return cudaErrorInvalidValue;
  }
}
