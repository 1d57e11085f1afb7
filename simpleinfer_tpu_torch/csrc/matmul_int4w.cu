// Group-wise int4 weight GEMM with a fused bias / activation epilogue, for
// Hopper.
//
// Replaces the Pallas TPU kernel `_matmul_int4w_kernel` behind
// `matmul_int4w` (simpleinfer_tpu/kernels/matmul.py, pallas_call in
// `_matmul_int4w_impl`):
//
//     out[M,N] = act(x[M,K] @ dequant(packed, scale) + bias[N]?)
//
// The weight is the Quantized4Tensor layout (quant/tensor.py): packed
// int8 [Kp/2, N]; for K-group g of `group` rows, packed rows
// [g*group/2, (g+1)*group/2) hold logical row g*group + r in the high
// nibble and row g*group + group/2 + r in the low nibble; scale f32
// [Kp/group, N]. Rows >= K (the logical K) are zero padding; x is [M, K].
//
// What bounds it on an H100: in LLM decode M is the slot count (16), so
// the work is a GEMV over ~0.4 GB of packed weights per decode step:
// bytes-bound, 3.35 TB/s. In prefill M is thousands of rows and the fp32
// FMA work bounds it. The design:
//   - each packed byte is read from device memory ONCE: a block stages
//     a [32 x BN] chunk of packed bytes in registers, sign-extends the
//     high nibble (p >> 4 on the int32 of the byte) into one shared-
//     memory tile and, after the first pass, the low nibble
//     ((p << 28) >> 28) into the same tile, so both halves of a group
//     come from one read;
//   - the nibbles are dequantized in f32 (value * the group's scale row,
//     as matmul_int4w_ref does) - not the bf16 dequant of the Pallas
//     body, which is a TPU means (the MXU multiplies in bf16);
//   - f32 FMA accumulation in registers, BM x BN output tile per block,
//     K walked group by group inside the block;
//   - two kernels: for M <= 16 (decode) a GEMV whose blocks own 32
//     columns and split K over 8 slices summed in shared memory (16
//     independent byte loads in flight per thread); otherwise (prefill)
//     64 x 64 output tiles;
//   - the logical K is masked on the x loads (pad rows of the weight are
//     zeros), the ragged M and N on loads and stores: no padded copies
//     (the Pallas wrapper pads x, packed and scale);
//   - bias, activation and the cast to the output dtype (f32 for the
//     decode projections, proj_nlo; the input dtype for nn.Linear) run
//     in registers before the one store.
// Tensor cores, TMA and a split of K over blocks for the decode shapes
// are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/build.py) and called
//             through ctypes via `si_matmul_int4w`.

#include "epilogue.cuh"

namespace {

using namespace si;

constexpr int KC = 32;  // packed rows staged per chunk (= K rows per pass)
constexpr int PAD = 4;

template <typename TX, typename TO, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
si_matmul_int4w_kernel(const TX* __restrict__ x,
                       const int8_t* __restrict__ packed,
                       const float* __restrict__ scale,
                       const void* __restrict__ bias, int bias_dtype,
                       TO* __restrict__ out, int M, int N, int K, int kp2,
                       int group, int act, float act_arg) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int PER_W = (KC * BN) / THREADS;  // packed bytes per thread
  constexpr int PER_X = (KC * BM) / THREADS;  // x elements per thread
  static_assert((KC * BN) % THREADS == 0 && (KC * BM) % THREADS == 0,
                "tile does not divide among the threads");
  __shared__ __align__(16) float As[KC][BM + PAD];  // x rows, K-major
  __shared__ __align__(16) float Bs[KC][BN + PAD];  // dequantized weights

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int half = group / 2;
  const int n_groups = (2 * kp2) / group;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int g = 0; g < n_groups; ++g) {
    for (int r0 = 0; r0 < half; r0 += KC) {
      // one read of the packed chunk: rows g*half + r0 + r, columns
      // n0 + c (neighbouring threads on neighbouring columns)
      int32_t p[PER_W];
      float s[PER_W];
#pragma unroll
      for (int i = 0; i < PER_W; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / BN, c = e % BN;
        const int gn = n0 + c;
        p[i] = 0;
        s[i] = 0.0f;
        if (r0 + r < half && gn < N) {
          p[i] = packed[static_cast<int64_t>(g * half + r0 + r) * N + gn];
          s[i] = scale[static_cast<int64_t>(g) * N + gn];
        }
      }
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        // pass 0: high nibbles = logical rows g*group + r0 + r;
        // pass 1: low nibbles = logical rows g*group + half + r0 + r
        const int k0 = g * group + pass * half + r0;
#pragma unroll
        for (int i = 0; i < PER_X; ++i) {
          const int e = tid + i * THREADS;
          const int r = e / KC, kk = e % KC;  // neighbouring threads: k
          const int64_t gm = m0 + r;
          const int gk = k0 + kk;
          float v = 0.0f;
          if (gm < M && gk < K && r0 + kk < half)
            v = to_f32(x[gm * K + gk]);
          As[kk][r] = v;
        }
#pragma unroll
        for (int i = 0; i < PER_W; ++i) {
          const int e = tid + i * THREADS;
          const int r = e / BN, c = e % BN;
          // p[i] is the sign-extended byte: its arithmetic >> 4 is the
          // high nibble; the low nibble is shifted up through uint32
          const int32_t q =
              pass == 0 ? p[i] >> 4
                        : static_cast<int32_t>(static_cast<uint32_t>(p[i])
                                               << 28) >> 28;
          Bs[r][c] = static_cast<float>(q) * s[i];
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
          float a[TM], b[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    if (gn >= N) continue;
    const float b = bias != nullptr ? load_bias(bias, bias_dtype, gn) : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gm = m0 + ty * TM + i;
      if (gm >= M) continue;
      out[gm * N + gn] = from_f32<TO>(activate(acc[i][j] + b, act, act_arg));
    }
  }
}

// Decode shapes, M <= 16: a GEMV over the packed weights. A block owns
// 32 columns (one warp-wide, coalesced byte per thread per packed row)
// and splits K over 8 slices of threads; each thread keeps the 16 rows'
// f32 sums of its column in registers, and the slices are summed in
// shared memory at the end. Per 128-packed-row chunk the x values the
// chunk's high and low nibbles multiply are staged in shared memory,
// and each thread has 16 independent byte loads in flight.
constexpr int GV_COLS = 32;
constexpr int GV_SLICES = 8;
constexpr int GV_THREADS = GV_COLS * GV_SLICES;
constexpr int GV_MMAX = 16;
constexpr int GV_CHUNK = 128;                    // packed rows per chunk
constexpr int GV_RPS = GV_CHUNK / GV_SLICES;     // packed rows per slice

template <typename TX, typename TO>
__global__ void __launch_bounds__(GV_THREADS)
si_matmul_int4w_gemv(const TX* __restrict__ x,
                     const int8_t* __restrict__ packed,
                     const float* __restrict__ scale,
                     const void* __restrict__ bias, int bias_dtype,
                     TO* __restrict__ out, int M, int N, int K, int kp2,
                     int group, int act, float act_arg) {
  // x for the chunk: [hi|lo][packed row j][row m], zero past M and K
  __shared__ __align__(16) float xs[2][GV_CHUNK][GV_MMAX];
  __shared__ float red[GV_SLICES][GV_MMAX][GV_COLS];

  const int tid = threadIdx.x;
  const int c = tid % GV_COLS, slice = tid / GV_COLS;
  const int n = blockIdx.x * GV_COLS + c;
  const int half = group / 2;

  float acc[GV_MMAX];
#pragma unroll
  for (int m = 0; m < GV_MMAX; ++m) acc[m] = 0.0f;

  for (int R0 = 0; R0 < kp2; R0 += GV_CHUNK) {
    __syncthreads();  // the previous chunk's x is no longer read
    for (int e = tid; e < 2 * GV_CHUNK * GV_MMAX; e += GV_THREADS) {
      const int lo = e / (GV_CHUNK * GV_MMAX);
      const int m = (e / GV_CHUNK) % GV_MMAX;
      const int j = e % GV_CHUNK;  // neighbouring threads: neighbouring k
      const int R = R0 + j;
      const int k = (R / half) * group + lo * half + R % half;
      float v = 0.0f;
      if (R < kp2 && m < M && k < K) v = to_f32(x[int64_t(m) * K + k]);
      xs[lo][j][m] = v;
    }
    __syncthreads();
    if (n < N) {
      int32_t p[GV_RPS];
#pragma unroll
      for (int i = 0; i < GV_RPS; ++i) {
        const int R = R0 + slice * GV_RPS + i;
        p[i] = R < kp2 ? packed[int64_t(R) * N + n] : 0;
      }
#pragma unroll
      for (int i = 0; i < GV_RPS; ++i) {
        const int j = slice * GV_RPS + i;
        const int R = R0 + j;
        if (R >= kp2) break;
        const float s = scale[int64_t(R / half) * N + n];
        const float whi = static_cast<float>(p[i] >> 4) * s;
        const float wlo = static_cast<float>(
            static_cast<int32_t>(static_cast<uint32_t>(p[i]) << 28) >> 28) * s;
        const float4* h4 = reinterpret_cast<const float4*>(xs[0][j]);
        const float4* l4 = reinterpret_cast<const float4*>(xs[1][j]);
#pragma unroll
        for (int q = 0; q < GV_MMAX / 4; ++q) {
          const float4 a = h4[q], b = l4[q];
          acc[4 * q + 0] = fmaf(a.x, whi, fmaf(b.x, wlo, acc[4 * q + 0]));
          acc[4 * q + 1] = fmaf(a.y, whi, fmaf(b.y, wlo, acc[4 * q + 1]));
          acc[4 * q + 2] = fmaf(a.z, whi, fmaf(b.z, wlo, acc[4 * q + 2]));
          acc[4 * q + 3] = fmaf(a.w, whi, fmaf(b.w, wlo, acc[4 * q + 3]));
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < GV_MMAX; ++m) red[slice][m][c] = acc[m];
  __syncthreads();
  for (int e = tid; e < GV_MMAX * GV_COLS; e += GV_THREADS) {
    const int m = e / GV_COLS, cc = e % GV_COLS;
    const int gn = blockIdx.x * GV_COLS + cc;
    if (m >= M || gn >= N) continue;
    float v = 0.0f;
#pragma unroll
    for (int sl = 0; sl < GV_SLICES; ++sl) v += red[sl][m][cc];
    if (bias != nullptr) v += load_bias(bias, bias_dtype, gn);
    out[int64_t(m) * N + gn] = from_f32<TO>(activate(v, act, act_arg));
  }
}

template <typename TX, typename TO, int BM, int BN, int TM, int TN>
cudaError_t launch(const void* x, const int8_t* packed, const float* scale,
                   const void* bias, int bias_dtype, void* out, int M, int N,
                   int K, int kp2, int group, int act, float act_arg,
                   cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  si_matmul_int4w_kernel<TX, TO, BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const TX*>(x), packed, scale, bias, bias_dtype,
          static_cast<TO*>(out), M, N, K, kp2, group, act, act_arg);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t dispatch_tile(const void* x, const int8_t* packed,
                          const float* scale, const void* bias,
                          int bias_dtype, void* out, int M, int N, int K,
                          int kp2, int group, int act, float act_arg,
                          cudaStream_t stream) {
  if (M <= GV_MMAX) {  // decode: the GEMV over the packed weights
    si_matmul_int4w_gemv<TX, TO>
        <<<(N + GV_COLS - 1) / GV_COLS, GV_THREADS, 0, stream>>>(
            static_cast<const TX*>(x), packed, scale, bias, bias_dtype,
            static_cast<TO*>(out), M, N, K, kp2, group, act, act_arg);
    return cudaGetLastError();
  }
  return launch<TX, TO, 64, 64, 4, 4>(x, packed, scale, bias, bias_dtype,
                                      out, M, N, K, kp2, group, act, act_arg,
                                      stream);
}

template <typename TX>
cudaError_t dispatch_out(int out_dtype, const void* x, const int8_t* packed,
                         const float* scale, const void* bias,
                         int bias_dtype, void* out, int M, int N, int K,
                         int kp2, int group, int act, float act_arg,
                         cudaStream_t stream) {
  switch (out_dtype) {
    case DT_F32:
      return dispatch_tile<TX, float>(x, packed, scale, bias, bias_dtype,
                                      out, M, N, K, kp2, group, act, act_arg,
                                      stream);
    case DT_BF16:
      return dispatch_tile<TX, __nv_bfloat16>(x, packed, scale, bias,
                                              bias_dtype, out, M, N, K, kp2,
                                              group, act, act_arg, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// x [M, K] (f32 or bf16), packed int8 [kp2, N], scale f32 [2*kp2/group, N],
// bias ([N], f32 or bf16) may be null.
extern "C" int si_matmul_int4w(const void* x, int x_dtype, const void* packed,
                               const void* scale, const void* bias,
                               int bias_dtype, void* out, int out_dtype,
                               int M, int N, int K, int kp2, int group,
                               int act, float act_arg, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || group < 2 || group % 2 ||
      (2 * kp2) % group || 2 * kp2 < K)
    return cudaErrorInvalidValue;
  if (bias != nullptr && bias_dtype != DT_F32 && bias_dtype != DT_BF16)
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case DT_F32:
      return dispatch_out<float>(out_dtype, x, p, s, bias, bias_dtype, out, M,
                                 N, K, kp2, group, act, act_arg, st);
    case DT_BF16:
      return dispatch_out<__nv_bfloat16>(out_dtype, x, p, s, bias,
                                         bias_dtype, out, M, N, K, kp2, group,
                                         act, act_arg, st);
    default:
      return cudaErrorInvalidValue;
  }
}
