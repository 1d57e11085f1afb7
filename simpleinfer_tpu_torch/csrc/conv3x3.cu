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
// card's bf16 ridge (~295), so the bf16 tensor cores (989 TFLOP/s) bound
// the big ones and the CUDA cores never could.
//
// Design. The TPU kernel holds a whole image flat in VMEM and builds each
// tap as a `jnp.roll` of it by the tap's flat shift, masked where the
// shift wraps across a row or falls off the image. Here the conv is a
// GEMM of M = N * H * W pixels by OC with K = 9 * C, walked tap-major:
// one loop over (tap, c0), 9 * ceil(C / 32) stages.
// bf16 x: the tensor-core tile of csrc/mma.cuh (si::tc), as matmul.cu's.
//   - At each tap every row the thread stages gets its source pixel (y +
//     dy, x + dx) once, from `tap_row` (csrc/tiles.cuh, shared with
//     c3block.cu), or -1 off the image. The row's 32-channel slice is then
//     four 16-byte cp.async, zero-filled for -1 rows: no roll, no mask
//     tensor, no padded copy of x. C that is no multiple of 8 (or an
//     unaligned x) stages by element loads.
//   - The tap's w [C, OC] rows come by 16-byte cp.async into the stage's
//     w tile and are read by ldmatrix.trans; x fragments by ldmatrix.
//   - A ring of 4 stages, one barrier per stage; mma.sync m16n8k16, bf16
//     x bf16 -> f32; 128 x 128 output tiles of 8 warps (OC > 64) or 128 x
//     64 (OC <= 64), blocks walking OC fastest.
//   - Bias and activation in registers, the one rounding to bf16, and the
//     tile out through shared memory as 16-byte stores along rows.
//   - No spills (ptxas -v); ~210 TFLOP/s at the ResNet-50 3x3 shapes on an
//     H100, 1.3 to 2.4x cuDNN's time.
// f32 x (exact to f32 summation order): each 64-pixel x 64-channel output
// tile is a block, and the 9 taps are 9 K segments of the f32-FMA tile
// loop of csrc/tiles.cuh, the tap's source rows from `tap_row` as above.
// Any H, W, C and OC; ragged edges masked. wgmma and TMA are the lever
// past mma.sync.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/build.py) and called
//             through ctypes via `si_conv3x3`.

#include "mma.cuh"
#include "tiles.cuh"

namespace {

using namespace si;
using namespace si::tile;

// ---- f32 x: the exact f32-FMA tile -----------------------------------------
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

// ---- bf16 x: the tensor cores ----------------------------------------------
// T: the tile (tc::Wide or tc::Narrow); VX: x rows by 16-byte cp.async (C %
// 8 == 0, x aligned), else element loads; vw: w rows the same (OC % 8 ==
// 0, w aligned); vo: 16-byte output stores (OC % 8 == 0, out aligned)
template <class T, bool VX>
__global__ void __launch_bounds__(T::THREADS, 2)
si_conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int M, int H, int W,
                      int C, int OC, int act, float act_arg, bool vw,
                      bool vo) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int n0 = blockIdx.x * T::BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * T::BM;
  const int c_steps = (C + tc::BK - 1) / tc::BK;
  const int n_stages = 9 * c_steps;

  // the source rows of the thread's staged rows at the current tap (the
  // stages are loaded in order, so a tap's rows are found once)
  const __nv_bfloat16* src[T::XV];
  int src_tap = -1;

  auto load = [&](int c) {
    uint8_t* st = smem + (c % tc::STAGES) * T::STAGE;
    const int tap = c / c_steps;
    const int k0 = (c - tap * c_steps) * tc::BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    if constexpr (VX) {
      if (tap != src_tap) {
        src_tap = tap;
#pragma unroll
        for (int i = 0; i < T::XV; ++i) {
          const int64_t r = tap_row(m0 + T::x_row(tid, i), M, H, W, dy, dx);
          src[i] = r >= 0 ? x + r * C : nullptr;
        }
      }
      tc::stage_x_vec<T>(st, src, x, k0, C, tid);
    } else {
      __nv_bfloat16* xs = tc::x_area(st);
      for (int e = tid; e < T::BM * tc::BK; e += T::THREADS) {
        const int r = e / tc::BK, kk = e % tc::BK;
        const int64_t row = tap_row(m0 + r, M, H, W, dy, dx);
        xs[r * tc::XS + kk] = row >= 0 && k0 + kk < C
                                  ? x[row * C + k0 + kk]
                                  : __float2bfloat16_rn(0.0f);
      }
    }
    const __nv_bfloat16* wt = w + static_cast<int64_t>(tap) * C * OC;
    if (vw)
      tc::stage_w_vec<T>(st, wt, k0, n0, C, OC, tid);
    else
      tc::stage_w_elem<T>(st, wt, k0, n0, C, OC, tid);
  };

  float acc[T::MT][4][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  tc::ring(n_stages, load, [](int) {}, [&](int c) {
    tc::mma_stage<T>(smem + (c % tc::STAGES) * T::STAGE, acc, wm, wn, lane);
  });
  tc::epilogue_to_smem<T, __nv_bfloat16>(smem, acc, nullptr, bias, DT_F32,
                                         n0, OC, act, act_arg, wm, wn, lane);
  __syncthreads();
  tc::store_tile<T, __nv_bfloat16>(smem, out, m0, n0, M, OC, vo, tid);
}

template <class T, bool VX>
cudaError_t launch_mma_tile(const __nv_bfloat16* x, const __nv_bfloat16* w,
                            const float* bias, __nv_bfloat16* out, int M,
                            int H, int W, int C, int OC, int act,
                            float act_arg, bool vw, bool vo,
                            cudaStream_t stream) {
  static bool done[tc::MAX_DEVICES] = {};
  auto kern = si_conv3x3_mma_kernel<T, VX>;
  cudaError_t err = tc::allow_smem(kern, T::SMEM, done);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + T::BM - 1) / T::BM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  kern<<<dim3((OC + T::BN - 1) / T::BN, m_tiles), T::THREADS, T::SMEM,
         stream>>>(x, w, bias, out, M, H, W, C, OC, act, act_arg, vw, vo);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t launch_mma(const void* x, const void* w, const float* bias,
                       void* out, int M, int H, int W, int C, int OC,
                       int act, float act_arg, int block_n,
                       cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const bool vx = C % 8 == 0 && aligned16(x);
  const bool vw = OC % 8 == 0 && aligned16(w);
  const bool vo = OC % 8 == 0 && aligned16(out);
  if (block_n == 64)
    return vx ? launch_mma_tile<tc::Narrow, true>(xb, wb, bias, o, M, H, W,
                                                  C, OC, act, act_arg, vw,
                                                  vo, stream)
              : launch_mma_tile<tc::Narrow, false>(xb, wb, bias, o, M, H, W,
                                                   C, OC, act, act_arg, vw,
                                                   vo, stream);
  if (block_n == 128)
    return vx ? launch_mma_tile<tc::Wide, true>(xb, wb, bias, o, M, H, W, C,
                                                OC, act, act_arg, vw, vo,
                                                stream)
              : launch_mma_tile<tc::Wide, false>(xb, wb, bias, o, M, H, W,
                                                 C, OC, act, act_arg, vw, vo,
                                                 stream);
  return cudaErrorInvalidValue;
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
// [3, 3, c, oc] of the same dtype, bias f32 [oc] (not null). bf16 runs on
// the tensor cores in output tiles `block_n` (64 or 128) wide; f32 runs
// the f32-FMA tile and ignores `block_n`.
extern "C" int si_conv3x3(const void* x, int dtype, const void* w,
                          const void* bias, void* out, int n, int h, int w_,
                          int c, int oc, int act, float act_arg, int block_n,
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
      return launch_mma(x, w, b, out, M, h, w_, c, oc, act, act_arg, block_n,
                        st);
    default:
      return cudaErrorInvalidValue;
  }
}
