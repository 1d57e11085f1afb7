// The 64x64 f32-FMA output tile of the port's f32 routes (csrc/matmul.cu,
// csrc/conv3x3.cu and csrc/c3block.cu: the exact fp32 parity mode, and
// c3block.cu's bf16 blocks with channel widths off 8): 256 threads of
// 4x4 outputs each, K walked in steps staged through shared memory, a
// and w converted to f32 as they are staged, a K-major so that a thread
// reads its 4 rows and 4 columns as float4s, the accumulator in
// registers. A kernel stages its a tile its own way (masked rows, shifted
// 3x3 taps) and takes the w staging and the inner loop from here; the
// epilogues stay in the kernels. `tap_row` is the 3x3 "same" tap
// addressing that csrc/c3block.cu and csrc/conv3x3.cu share.
#pragma once

#include "epilogue.cuh"

namespace si {
namespace tile {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int BK = 32;        // K depth staged per step
constexpr int PAD = 4;        // keeps float4 rows 16-byte aligned

using FTileA = float[BK][BM + PAD];  // a tile, K-major
using FTileB = float[BK][BN + PAD];  // w tile

// the source pixel of output row gm for the 3x3 tap (dy, dx) of an
// [N, H, W, K] map: its row in that map, or -1 off the image ("same"
// zero padding) or past the M rows
__device__ __forceinline__ int64_t tap_row(int64_t gm, int64_t M, int H,
                                           int W, int dy, int dx) {
  if (gm >= M) return -1;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t img = gm / hw;
  const int rem = static_cast<int>(gm - img * hw);
  const int y = rem / W + dy, x = rem % W + dx;
  if (y < 0 || y >= H || x < 0 || x >= W) return -1;
  return (img * H + y) * W + x;
}

// a[src(r), k0:k0+BK] into row r of the K-major tile, for r < BM; a row
// src(r) < 0 and k >= K read as zero. Neighbouring threads read
// neighbouring k (coalesced).
template <typename T, typename RowFn>
__device__ __forceinline__ void stage_a_f32(FTileA& As,
                                            const T* __restrict__ a,
                                            RowFn src, int k0, int K,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < (BM * BK) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / BK, c = e % BK;
    const int64_t row = src(r);
    const int gk = k0 + c;
    As[c][r] = (row >= 0 && gk < K) ? to_f32(a[row * K + gk]) : 0.0f;
  }
}

// w[k0:k0+BK, n0:n0+BN] of a row-major [K, N] matrix, zero outside it.
// Neighbouring threads read neighbouring n.
template <typename TW>
__device__ __forceinline__ void stage_w_f32(FTileB& Bs,
                                            const TW* __restrict__ w, int k0,
                                            int n0, int K, int N, int tid) {
#pragma unroll
  for (int i = 0; i < (BK * BN) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / BN, c = e % BN;
    const int gk = k0 + r, gn = n0 + c;
    Bs[r][c] = (gk < K && gn < N)
                   ? to_f32(w[static_cast<int64_t>(gk) * N + gn])
                   : 0.0f;
  }
}

// acc[i][j] += sum over the staged K of a[ty*TM + i] * w[tx*TN + j]
__device__ __forceinline__ void fma_step(const FTileA& As, const FTileB& Bs,
                                         float (&acc)[TM][TN], int tx,
                                         int ty) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
    const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
    const float av[TM] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace tile
}  // namespace si
