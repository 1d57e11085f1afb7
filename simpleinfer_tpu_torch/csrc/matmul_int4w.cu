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
// bytes-bound, 3.35 TB/s. In prefill M is thousands of rows: the
// operations bound it, 989 TFLOP/s on the bf16 tensor cores.
//
// bf16 x (the llama service's path), a group of 32, 64, 128, ...:
// tensor cores.
//   - The packed bytes, x and the group scales come into shared memory
//     by 16-byte cp.async in a ring of 4 stages; a stage holds 32 packed
//     rows x 128 columns (both nibbles: 64 logical K rows), the x columns
//     they multiply, zero-filled past M, past K and past the block's K
//     range, and the scale rows of the groups it ends. Ragged N or K
//     (rows that are not 16-byte multiples) stage with narrower loads.
//   - mma.sync m16n8k16, bf16 x bf16 -> f32, x fragments by ldmatrix.
//     The weight fragments are built in registers: one 32-bit shared
//     load gives a packed row's bytes of 4 neighbouring columns, so a
//     warp's 4 n8 tiles take column 4*g + j (tile j, fragment column g),
//     and each thread ends up owning 8 neighbouring output columns. Two
//     byte_perms and a mask turn 4 bytes into the high- and the low-
//     nibble pairs; a nibble u becomes bf16 exactly as the bits
//     0x4300 | (u ^ 8) = 136 + q minus 136 (an int4 is exact in bf16).
//     A k16 step runs the high-nibble MMAs of all its tiles, then the
//     low-nibble ones, so neighbouring MMAs never wait on each other.
//   - Each group's products are summed in f32 by the MMA into a partial
//     sum that is scaled by the group's f32 scale once, one FMA per
//     output per group (not a bf16 dequant before the product): the
//     result stays within f32 summation order of matmul_int4w_ref.
//   - Prefill (M > 16): 128 x 128 output tiles, 8 warps of 64 x 32;
//     blocks walk N fastest, so the blocks in flight share x rows in L2.
//   - Decode (M <= 16): one m16 tile, 128 columns per block of 4 warps,
//     and K split over blocks (gridDim.z, whole groups each, at most 8,
//     the count chosen by the wrapper so that some 2 x 132 blocks stream
//     bytes). The slices of a column tile are one thread-block cluster:
//     each leaves its f32 partial sums in its shared memory, and each
//     then sums a share of the tile over all slices through distributed
//     shared memory, in slice order (no atomics: reruns are bit-equal),
//     applying bias, activation and the cast. One launch, no workspace.
//   - Bias, activation and the cast to the output dtype run in registers
//     before the one store.
// f32 x (the fp32 parity mode), and bf16 x with another group: CUDA-core
// kernels that dequantize in f32 (value * the group's scale row, as
// matmul_int4w_ref does), exact to f32 summation order:
//   - each packed byte is read from device memory ONCE: a block stages
//     a [32 x BN] chunk of packed bytes in registers, sign-extends the
//     high nibble (p >> 4 on the int32 of the byte) into one shared-
//     memory tile and, after the first pass, the low nibble
//     ((p << 28) >> 28) into the same tile;
//   - for M <= 16 a GEMV whose blocks own 32 columns and split K over 8
//     slices summed in shared memory; otherwise 64 x 64 output tiles.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/build.py) and called
//             through ctypes via `si_matmul_int4w`.

#include <cooperative_groups.h>

#include <type_traits>

#include "epilogue.cuh"
#include "mma.cuh"

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

// ---- bf16 x on the tensor cores ------------------------------------------
constexpr int TC_KC = 32;                 // packed rows per stage
constexpr int TC_BN = 128;                // output columns per block
constexpr int TC_XS = 2 * TC_KC + 8;      // x row in smem: hi | lo | pad
constexpr int TC_PS = TC_BN + 16;         // packed row in smem (+ pad)
constexpr int TC_STAGES = 4;
constexpr int MAX_DEVICES = 64;           // devices with a remembered limit

// the most K slices of the decode route: a portable cluster's blocks
constexpr int MAX_SLICES = 8;

__host__ __device__ constexpr int tc_stage_bytes(int bm) {
  return bm * TC_XS * 2 + TC_KC * TC_PS + 2 * TC_BN * 4;
}

// (u & 0xF) of each half of a word -> the bf16 pair of the signed int4s
__device__ __forceinline__ uint32_t nibbles_to_bf16(uint32_t u) {
  uint32_t v = (u & 0x000F000Fu) ^ 0x43084308u;      // 136 + q, exact
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// One kernel for both routes. Block: WARPS_M x 4 warps, each warp MT m16
// tiles x 32 columns; BM = 16 * MT * WARPS_M rows, 128 columns; blockIdx.z
// takes groups [z*gps, (z+1)*gps). half = group / 2 = 1 << lgh. SPLIT:
// the gridDim.z slices of a column tile are one thread-block cluster,
// which sums their f32 partials in slice order through distributed
// shared memory before the epilogue; else the epilogue straight from the
// block's own sums. out is [M, N] of TO. A stage: x [BM][TC_XS] bf16,
// the packed bytes [TC_KC][TC_PS], and the scale rows of the groups its
// two k16 steps end [2][TC_BN] f32.
template <typename TO, int WARPS_M, int MT, bool VEC, bool SPLIT>
__global__ void __launch_bounds__(WARPS_M * 128, 1)
si_int4w_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const void* __restrict__ bias, int bias_dtype,
                    TO* __restrict__ out, int M, int N, int K, int kp2,
                    int lgh, int gps, int act, float act_arg) {
  constexpr int BM = 16 * MT * WARPS_M;
  constexpr int THREADS = WARPS_M * 128;
  constexpr int STAGE = tc_stage_bytes(BM);
  constexpr int P_OFF = BM * TC_XS * 2;              // packed bytes
  constexpr int S_OFF = P_OFF + TC_KC * TC_PS;       // scale rows
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * TC_BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int half = 1 << lgh;
  const int n_groups = kp2 >> lgh;
  const int row_begin = (blockIdx.z * gps) << lgh;
  const int row_end = min((blockIdx.z + 1) * gps, n_groups) << lgh;
  const int n_chunks = (row_end - row_begin + TC_KC - 1) / TC_KC;

  // logical K column of x multiplied by packed row r (high nibble)
  auto k_hi = [&](int r) {
    return ((r >> lgh) << (lgh + 1)) + (r & (half - 1));
  };
  // a k16 step at packed row rs ends its group
  auto ends = [&](int rs) {
    return rs < row_end && ((rs + 16) & (half - 1)) == 0;
  };

  // 16-byte staging: each thread's vectors sit at fixed rows and columns
  // of a stage, so their addresses are set up once
  constexpr int XV = BM * 8 / THREADS;           // x vectors per thread
  constexpr int PV = TC_KC * (TC_BN / 16) / THREADS;
  static_assert(XV * THREADS == BM * 8 && PV * THREADS == TC_KC * TC_BN / 16,
                "stage does not divide among the threads");
  const int x_hv = tid % 4, x_lo = (tid / 4) % 2;
  const __nv_bfloat16* x_row[XV];
  bool x_ok[XV];
#pragma unroll
  for (int i = 0; i < XV; ++i) {
    const int64_t gm = m0 + tid / 8 + i * (THREADS / 8);
    x_ok[i] = gm < M;
    x_row[i] = x + (x_ok[i] ? gm * K : 0);
  }
  const int p_gn = n0 + 16 * (tid % 8);
  const bool p_ok = p_gn < N;
  const int8_t* p_col = packed + (p_ok ? p_gn : 0);
  const int s_gn = n0 + 4 * (tid % 32);

  auto load_chunk = [&](int c, int s) {
    uint8_t* st = smem + s * STAGE;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
    uint8_t* ps = st + P_OFF;
    float* sc = reinterpret_cast<float*>(st + S_OFF);
    const int R = row_begin + c * TC_KC;
    if constexpr (VEC) {
      // x: per row 8 vectors of 8 columns (4 for the high-nibble rows,
      // 4 for the low); K % 8 == 0, so a vector is all in or all out
      const int rr = R + 8 * x_hv;
      const int k = rr < row_end ? k_hi(rr) + x_lo * half : K;
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const bool ok = x_ok[i] && k < K;
        cp_async16(xs + (tid / 8 + i * (THREADS / 8)) * TC_XS +
                       x_lo * TC_KC + 8 * x_hv,
                   ok ? x_row[i] + k : x, ok);
      }
#pragma unroll
      for (int i = 0; i < PV; ++i) {
        const int r = tid / 8 + i * (THREADS / 8);
        const bool ok = p_ok && R + r < row_end;
        cp_async16(ps + r * TC_PS + 16 * (tid % 8),
                   ok ? p_col + static_cast<int64_t>(R + r) * N : packed, ok);
      }
      if (tid < 2 * (TC_BN / 4)) {   // the scale rows of the groups it ends
        const int ss = tid / (TC_BN / 4), rs = R + 16 * ss;
        if (ends(rs)) {
          const bool ok = s_gn < N;
          cp_async16(sc + ss * TC_BN + 4 * (tid % 32),
                     ok ? scale + static_cast<int64_t>(rs >> lgh) * N + s_gn
                        : scale,
                     ok);
        }
      }
    } else {
      for (int e = tid; e < BM * 2 * TC_KC; e += THREADS) {
        const int m = e / (2 * TC_KC), kk = e % (2 * TC_KC);
        const int lo = kk / TC_KC, rr = R + kk % TC_KC;
        const int64_t gm = m0 + m;
        const int k = k_hi(rr) + lo * half;
        xs[m * TC_XS + kk] = rr < row_end && gm < M && k < K
                                 ? x[gm * K + k]
                                 : __float2bfloat16_rn(0.0f);
      }
      for (int e = tid; e < TC_KC * TC_BN; e += THREADS) {
        const int r = e / TC_BN, cc = e % TC_BN;
        const int gr = R + r, gn = n0 + cc;
        const int64_t at = static_cast<int64_t>(gr) * N + gn;
        ps[r * TC_PS + cc] =
            gr < row_end && gn < N ? static_cast<uint8_t>(packed[at]) : 0;
      }
      for (int e = tid; e < 2 * TC_BN; e += THREADS) {
        const int ss = e / TC_BN, cc = e % TC_BN;
        const int rs = R + 16 * ss, gn = n0 + cc;
        if (ends(rs))
          sc[ss * TC_BN + cc] =
              gn < N ? scale[static_cast<int64_t>(rs >> lgh) * N + gn] : 0.0f;
      }
    }
  };

  float acc[MT][4][4], part[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.0f;

  // this thread's 8 output columns: n0 + wn*32 + 8t + o, o = 4*(e&1) + j
  const int col0 = n0 + wn * 32 + 8 * t;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // chunk c landed; chunk c-1's stage is free
    if (c + TC_STAGES - 1 < n_chunks)
      load_chunk(c + TC_STAGES - 1, (c + TC_STAGES - 1) % TC_STAGES);
    cp_async_commit();

    const uint8_t* st = smem + (c % TC_STAGES) * STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const uint8_t* ps = st + P_OFF;
    const float* sc = reinterpret_cast<const float*>(st + S_OFF);
    const int R = row_begin + c * TC_KC;
#pragma unroll
    for (int ss = 0; ss < 2; ++ss) {
      const int rs = R + 16 * ss;
      if (rs >= row_end) break;
      // packed rows 2t, 2t+1, 2t+8, 2t+9 of this k16 step, columns
      // wn*32 + 4g .. +3: the B fragments of 4 n8 tiles, both nibbles
      const uint8_t* pb = ps + (16 * ss + 2 * t) * TC_PS + wn * 32 + 4 * g;
      const uint32_t wa = *reinterpret_cast<const uint32_t*>(pb);
      const uint32_t wb = *reinterpret_cast<const uint32_t*>(pb + TC_PS);
      const uint32_t wc = *reinterpret_cast<const uint32_t*>(pb + 8 * TC_PS);
      const uint32_t wd = *reinterpret_cast<const uint32_t*>(pb + 9 * TC_PS);
      const __nv_bfloat16* xr = xs + (wm * MT * 16 + (lane & 15)) * TC_XS +
                                16 * ss + (lane >> 4) * 8;
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], xr + mi * 16 * TC_XS);
      uint32_t b[4][2];
      // the high nibbles (k rows of the group's first half), then the
      // low: the MMAs of a batch are independent of each other
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of the even row in byte 0, of the odd row in byte 2
        const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
        b[j][0] = nibbles_to_bf16(__byte_perm(wa, wb, sel) >> 4);
        b[j][1] = nibbles_to_bf16(__byte_perm(wc, wd, sel) >> 4);
      }
      if ((rs & (half - 1)) == 0) {   // a group starts: a fresh partial
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16_c0(part[mi][j], a[mi], b[j][0], b[j][1]);
      } else {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(part[mi][j], a[mi], b[j][0], b[j][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], xr + mi * 16 * TC_XS + TC_KC);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
        b[j][0] = nibbles_to_bf16(__byte_perm(wa, wb, sel));
        b[j][1] = nibbles_to_bf16(__byte_perm(wc, wd, sel));
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(part[mi][j], a[mi], b[j][0], b[j][1]);
      if (ends(rs)) {   // the group ends: scale and fold
        const float4 s0 =
            *reinterpret_cast<const float4*>(sc + ss * TC_BN + wn * 32 + 8 * t);
        const float4 s1 = *reinterpret_cast<const float4*>(
            sc + ss * TC_BN + wn * 32 + 8 * t + 4);
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mi][j][e] =
                  fmaf(part[mi][j][e], sv[4 * (e & 1) + j], acc[mi][j][e]);
      }
    }
  }
  cp_async_wait<0>();

  const bool vec_store = VEC && col0 + 8 <= N;
  if constexpr (SPLIT) {
    // each slice leaves its f32 sums of the tile [BM][TC_BN] in its own
    // shared memory; then every slice sums a share of the tile over all
    // the cluster's slices, in slice order (a fixed order: reruns are
    // bit-equal), and runs the epilogue on it
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int TILE = BM * TC_BN;
    static_assert(TILE * 4 <= TC_STAGES * STAGE, "partials do not fit");
    __syncthreads();   // every warp is done with the stages
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int o = 0; o < 8; ++o)
          part[(wm * MT * 16 + mi * 16 + g + 8 * hh) * TC_BN + wn * 32 +
               8 * t + o] = acc[mi][o & 3][2 * hh + (o >> 2)];
    cluster.sync();
    const int slices = static_cast<int>(cluster.num_blocks());
    const int share = (TILE + slices - 1) / slices;
    const int i0 = static_cast<int>(cluster.block_rank()) * share;
    for (int i = i0 + tid; i < min(TILE, i0 + share); i += THREADS) {
      float v = 0.0f;
#pragma unroll
      for (int z = 0; z < MAX_SLICES; ++z)
        if (z < slices) v += cluster.map_shared_rank(part, z)[i];
      const int64_t gm = m0 + i / TC_BN;
      const int gn = n0 + i % TC_BN;
      if (gm < M && gn < N) {
        if (bias != nullptr) v += load_bias(bias, bias_dtype, gn);
        out[gm * N + gn] = from_f32<TO>(activate(v, act, act_arg));
      }
    }
    cluster.sync();   // the slices' partials stay until every share is read
    return;
  }

  float bv[8];
#pragma unroll
  for (int o = 0; o < 8; ++o)
    bv[o] = bias != nullptr && col0 + o < N
                ? load_bias(bias, bias_dtype, col0 + o)
                : 0.0f;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t gm = m0 + wm * MT * 16 + mi * 16 + g + 8 * hh;
      if (gm >= M) continue;
      TO* dst = out + gm * N + col0;
      alignas(16) TO r[8];
#pragma unroll
      for (int o = 0; o < 8; ++o)
        r[o] = from_f32<TO>(activate(
            acc[mi][o & 3][2 * hh + (o >> 2)] + bv[o], act, act_arg));
      if (vec_store) {
        constexpr int NV = 8 * sizeof(TO) / 16;
#pragma unroll
        for (int q = 0; q < NV; ++q)
          reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<uint4*>(r)[q];
      } else {
#pragma unroll
        for (int o = 0; o < 8; ++o)
          if (col0 + o < N) dst[o] = r[o];
      }
    }
}

// raise a kernel instance's dynamic shared memory limit once per device
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename TO, bool VEC>
cudaError_t launch_mma(const __nv_bfloat16* x, const int8_t* packed,
                       const float* scale, const void* bias, int bias_dtype,
                       void* out, int splits, int M, int N, int K, int kp2,
                       int group, int act, float act_arg,
                       cudaStream_t stream) {
  const int n_groups = (2 * kp2) / group;
  const int lgh = __builtin_ctz(group) - 1;     // group = 2 << lgh
  const int n_tiles = (N + TC_BN - 1) / TC_BN;
  if (M <= 16) {   // decode: K split over the blocks of a cluster
    if (splits < 1 || splits > n_groups || splits > MAX_SLICES)
      return cudaErrorInvalidValue;
    const int gps = (n_groups + splits - 1) / splits;
    if ((n_groups + gps - 1) / gps != splits) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_tiles, 1, splits);
    cfg.blockDim = dim3(128);
    cfg.dynamicSmemBytes = TC_STAGES * tc_stage_bytes(16);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, si_int4w_mma_kernel<TO, 1, 1, VEC, true>,
                              x, packed, scale, bias, bias_dtype,
                              static_cast<TO*>(out), M, N, K, kp2, lgh, gps,
                              act, act_arg);
  }
  constexpr int SMEM = TC_STAGES * tc_stage_bytes(128);
  static bool done[MAX_DEVICES] = {};
  auto kern = si_int4w_mma_kernel<TO, 2, 4, VEC, false>;
  cudaError_t err = allow_smem(kern, SMEM, done);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + 127) / 128;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  kern<<<dim3(n_tiles, m_tiles, 1), 256, SMEM, stream>>>(
      x, packed, scale, bias, bias_dtype, static_cast<TO*>(out), M, N, K, kp2,
      lgh, n_groups, act, act_arg);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch_mma(const __nv_bfloat16* x, const int8_t* packed,
                         const float* scale, const void* bias,
                         int bias_dtype, void* out, int splits, int M, int N,
                         int K, int kp2, int group, int act, float act_arg,
                         cudaStream_t stream) {
  // 16-byte staging needs 16-byte rows and bases
  const bool vec = K % 8 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch_mma<TO, true>(x, packed, scale, bias, bias_dtype, out,
                                    splits, M, N, K, kp2, group, act,
                                    act_arg, stream)
             : launch_mma<TO, false>(x, packed, scale, bias, bias_dtype, out,
                                     splits, M, N, K, kp2, group, act,
                                     act_arg, stream);
}

// ---- dispatch -------------------------------------------------------------
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
                          int bias_dtype, void* out, int splits, int M,
                          int N, int K, int kp2, int group, int act,
                          float act_arg, cudaStream_t stream) {
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (group % 32 == 0 && (group & (group - 1)) == 0)   // 32, 64, 128, ...
      return dispatch_mma<TO>(static_cast<const __nv_bfloat16*>(x), packed,
                              scale, bias, bias_dtype, out, splits, M, N, K,
                              kp2, group, act, act_arg, stream);
  }
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
                         int bias_dtype, void* out, int splits, int M, int N,
                         int K, int kp2, int group, int act, float act_arg,
                         cudaStream_t stream) {
  switch (out_dtype) {
    case DT_F32:
      return dispatch_tile<TX, float>(x, packed, scale, bias, bias_dtype,
                                      out, splits, M, N, K, kp2, group, act,
                                      act_arg, stream);
    case DT_BF16:
      return dispatch_tile<TX, __nv_bfloat16>(x, packed, scale, bias,
                                              bias_dtype, out, splits, M, N,
                                              K, kp2, group, act, act_arg,
                                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// x [M, K] (f32 or bf16), packed int8 [kp2, N], scale f32 [2*kp2/group, N],
// bias ([N], f32 or bf16) may be null. For bf16 x with M <= 16 and a
// group of 32, 64, 128, ... (a power of two), `splits` is the number of
// K slices (1 <= splits <= min(groups, 8), each slice whole groups:
// ceil(groups / ceil(groups / splits)) == splits); otherwise it is
// ignored.
extern "C" int si_matmul_int4w(const void* x, int x_dtype, const void* packed,
                               const void* scale, const void* bias,
                               int bias_dtype, void* out, int out_dtype,
                               int splits, int M, int N, int K, int kp2,
                               int group, int act, float act_arg,
                               void* stream) {
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
      return dispatch_out<float>(out_dtype, x, p, s, bias, bias_dtype, out,
                                 splits, M, N, K, kp2, group, act, act_arg,
                                 st);
    case DT_BF16:
      return dispatch_out<__nv_bfloat16>(out_dtype, x, p, s, bias,
                                         bias_dtype, out, splits, M, N, K,
                                         kp2, group, act, act_arg, st);
    default:
      return cudaErrorInvalidValue;
  }
}
