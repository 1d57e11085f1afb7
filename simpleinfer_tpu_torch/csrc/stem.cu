// The YOLOv5 6x6 stride-2 pad-2 stem conv as an in-kernel im2col GEMM,
// for Hopper.
//
// Replaces the Pallas TPU kernel `_stem_kernel` behind `stem_s2d`
// (simpleinfer_tpu/kernels/stem.py, pallas_call in `stem_s2d`). Input
// in the TPU's staged layout, kept at the public function:
//
//     x [N, 645, 6, 320] bf16   rows (2 top + 640 + 3 bottom pad) x
//                               slot (W parity wl * 3 + channel c) x
//                               lane m (output column)
//     w [128, OC] bf16          row k = kh*18 + j*6 + wl*3 + c (108 used)
//     out[n, oh, m, o] = act(sum over k < 108 of
//                            x[n, 2*oh + kh, wl*3 + c, m + j - 1] * w[k, o]
//                            + bias[o])     bf16 [N, 320, 320, OC]
//
// with lanes -1 and 320 read as zero (the W padding; the H padding is in
// the staged rows), f32 sums and one rounding to bf16.
//
// What bounds it on an H100: per output pixel 2 * 108 * OC operations
// against 12 staged input values (24 bytes) and 2 * OC bytes of output:
// 78 FLOPs per byte at OC 32, below the bf16 ridge (~295), so the bytes
// bound it (at N 8, OC 32: 19.8 MB in, 52.4 MB out, ~0.022 ms at
// 3.35 TB/s). The kernel aims to read the input once and write the
// output once; it multiplies in f32 FMA on the CUDA cores.
//
// Design. The TPU kernel keeps the 320 output columns in lanes end to end
// (Mosaic cannot split or merge the lane dim), rolls the lanes for the
// m - 1 / m + 1 taps and contracts with a transposed dot. None of that
// carries over. Here a block owns 64 output pixels x 64 channels and
// walks K = 108 in steps of 32 with the f32 tile loop of csrc/tiles.cuh:
// the block computes each of its rows' (image, row, lane) once, and each
// staged element its (kh, j, slot) from k, reading lane m + j - 1 of
// staged row 2*oh + kh, zero past either edge of the lanes. Neighbouring
// threads stage neighbouring output pixels, i.e. neighbouring lanes of
// one staged row: coalesced reads. The bias + activation epilogue runs in
// registers before the one store. Tensor cores and TMA are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/stem.py does this at
//             first use) and called through ctypes via `si_stem_s2d`.

#include "tiles.cuh"

namespace {

using namespace si;
using namespace si::tile;

constexpr int HP = 645;      // staged rows: 640 + 2 top + 3 bottom pad
constexpr int SLOTS = 6;     // W parity x channel
constexpr int LANES = 320;   // output columns
constexpr int OHW = 320;     // output rows (= output columns)
constexpr int KU = 108;      // useful patch taps: 6 kh x 3 j x 6 slots

__global__ void __launch_bounds__(THREADS)
si_stem_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int M, int OC, int act, float act_arg) {
  __shared__ __align__(16) FTileA As;  // patch tile, K-major
  __shared__ __align__(16) FTileB Bs;  // w tile
  __shared__ int64_t base[BM];         // offset of x[n, 2*oh, 0, 0]
  __shared__ int lane[BM];             // m, or far off the lanes past M

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  if (tid < BM) {
    const int64_t gm = m0 + tid;
    if (gm < M) {
      const int64_t img = gm / (OHW * LANES);
      const int rem = static_cast<int>(gm - img * (OHW * LANES));
      const int oh = rem / LANES;
      base[tid] = (img * HP + 2 * oh) * static_cast<int64_t>(SLOTS * LANES);
      lane[tid] = rem % LANES;
    } else {
      base[tid] = 0;
      lane[tid] = -(1 << 20);
    }
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < KU; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e % BM, c = e / BM;   // neighbouring threads: rows
      const int k = k0 + c;
      float v = 0.0f;
      if (k < KU) {
        const int kh = k / 18, rem = k - kh * 18;
        const int j = rem / SLOTS, slot = rem - j * SLOTS;
        const int m = lane[r] + j - 1;
        if (m >= 0 && m < LANES)
          v = __bfloat162float(x[base[r] + (kh * SLOTS + slot) * LANES + m]);
      }
      As[c][r] = v;
    }
    stage_w_f32(Bs, w, k0, n0, KU, OC, tid);  // rows >= 108 never read
    __syncthreads();
    fma_step(As, Bs, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    if (gn >= OC) continue;
    const float b = bias[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gm = m0 + ty * TM + i;
      if (gm >= M) continue;
      out[gm * OC + gn] =
          from_f32<__nv_bfloat16>(activate(acc[i][j] + b, act, act_arg));
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// x bf16 [n, 645, 6, 320], w bf16 [128, oc] (rows >= 108 unused), bias
// f32 [oc], out bf16 [n, 320, 320, oc].
extern "C" int si_stem_s2d(const void* x, const void* w, const void* bias,
                           void* out, int n, int oc, int act, float act_arg,
                           void* stream) {
  if (n <= 0 || oc <= 0 || bias == nullptr) return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  const int M = n * OHW * LANES;
  const dim3 grid((M + BM - 1) / BM, (oc + BN - 1) / BN);
  si_stem_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, oc, act, act_arg);
  return cudaGetLastError();
}
