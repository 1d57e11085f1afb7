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
// What bounds it on an H100: at ResNet-50-224-b128's 3x3 convs (K =
// 1,152..4,608, N = 128..512) and yolov5l-640-b16's 3x3 stride-2 convs
// the operations take ~0.015 ms a conv at 1,979 TOP/s int8, and reading
// the int8 im2col the conv passes in (M x K bytes, 9x the conv's own
// input at stride 1) up to three times that at 3.35 TB/s. The design
// feeds the s8 tensor cores at the rate those bytes arrive:
//   - wgmma m64n128k32 .s32.s8.s8: a 128 x 128 output tile a block, two
//     warpgroups of 64 rows, the s32 sums in registers; both operands
//     read by the tensor cores from shared memory (no fragments through
//     registers);
//   - w comes K-major: the [K, N] view of a contiguous [N, K] tensor
//     (Engine.place_weights lays each static-int8 weight out so once),
//     as wgmma's s8 operands must be (no transpose for 8-bit types); a
//     row-major w is copied so by the wrapper (and counted there);
//   - stages of 128 bytes of K, x rows and w columns in the 128-byte
//     swizzled layout wgmma reads without bank conflicts, in the ring of
//     csrc/mma.cuh (si::tc::ring, 3 stages: 96 KB, two blocks an SM).
//     With K % 16 == 0 and aligned operands, one thread fills a stage by
//     two TMA tile copies (cuTensorMapEncodeTiled maps, zero past M, N
//     and K) that land on an mbarrier; otherwise every thread stores its
//     bytes (ragged K, unaligned views), seen by the async proxy before
//     the ring's barrier. Blocks walk N fastest, so the blocks in flight
//     share their x rows in L2;
//   - the sum stays exact in s32; the epilogue is matmul_s8s8_ref's f32
//     operations in its order: int32 -> f32 (round to nearest even, as
//     the JAX package's astype), * scale[n], + bias[n], the activation
//     (none, relu and silu each compiled into a loop of their own; SiLU
//     by the MUFU's exponential and reciprocal: with expf and an IEEE
//     division it took as long as the loads at yolov5l's widest conv),
//     the cast. It runs from the s32 tile in shared memory, 4 columns a
//     thread with their scale and bias in registers, and stores 16 or 8
//     bytes at a time.
// The implicit-GEMM walk over the padded int8 NHWC input (reading x by
// tap, as csrc/conv3x3.cu does) would drop the im2col's bytes; a
// persistent tile that overlaps one tile's epilogue with the next one's
// loads, and warp-specialized producers, are the next levers.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/matmul.py does this at
//             first use) and called through ctypes via `si_matmul_s8s8`.

#include <cuda.h>

#include "mma.cuh"

namespace {

using namespace si;

constexpr int BM = 128, BN = 128;   // output tile
constexpr int THREADS = 256;        // two warpgroups of 64 rows
constexpr int KB = 128;             // K bytes of a stage: four k32 steps
constexpr int NS = 3;               // stages in the ring
constexpr int SBO = 8 * KB;         // 8-row swizzle atoms (1024 bytes)
constexpr int A_BYTES = BM * KB;
constexpr int STAGE = A_BYTES + BN * KB;
constexpr int SMEM = NS * STAGE + 1024;   // + room to align to 1024
static_assert(KB == 128, "one 128-byte swizzle row a row");

// the s32 tile of the epilogue in shared memory, rows OS ints apart
constexpr int OS = BN + 4;
static_assert(BM * OS * 4 <= NS * STAGE, "the sums' tile fits the ring");

// (row r, 16-byte chunk c) of an operand in a stage: rows of 128 bytes,
// the chunk index XOR the row's place in its 8-row atom (the 128-byte
// swizzle that TMA writes and wgmma reads)
__device__ __forceinline__ int swz_off(int r, int c) {
  return r * KB + ((c ^ (r & 7)) << 4);
}

// wgmma's shared-memory matrix descriptor, K-major with the 128-byte
// swizzle: start address, 8-row atoms SBO apart (16-byte units; the
// leading offset is unused for this layout)
__device__ __forceinline__ uint64_t desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(SBO >> 4) << 32) | (uint64_t(1) << 62);
}

// a [128 rows x 128 bytes] box at (k0, row0) of a 2-D tensor map into
// shared memory, counted in on `bar`; `hint` the L2 policy (x is read
// once, evict first; w by every row tile, evict last)
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int k0, int row0, uint64_t* bar,
                                        uint64_t hint) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0),
      "r"(row0), "l"(hint)
      : "memory");
}
constexpr uint64_t EVICT_FIRST = 0x12F0000000000000ull;
constexpr uint64_t EVICT_LAST = 0x14F0000000000000ull;

// d (64 rows of the warpgroup x 128, s32) += a (64 x 32 s8) * b (32 x 128)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));   // scale-d: accumulate into d
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators are settled here: no read of them moves above the wait
__device__ __forceinline__ void settle(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// this thread's shared-memory writes (cp.async's landed ones and plain
// stores) seen by the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// SiLU by the MUFU's exponential and reciprocal: within a few f32 ulps
// of x / (1 + exp(-x)) (0 once exp(-x) overflows, as x / inf), at a
// fraction of the instructions of expf and an IEEE division (yolov5l's
// s8 convs spend their epilogue here)
__device__ __forceinline__ float silu_fast(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// the stage's bytes of a [rows, K] matrix (x, or w K-major) by the
// threads: 16-byte cp.async where `vec` (K % 16 == 0, aligned), else
// element stores; rows r0 .. r0 + 128, zero past `rows` and K
template <int ROWS>
__device__ __forceinline__ void stage_rows(uint8_t* area, const int8_t* p,
                                           int64_t r0, int64_t rows, int k0,
                                           int K, bool vec, int tid) {
  if (vec) {
    for (int e = tid; e < ROWS * (KB / 16); e += THREADS) {
      const int r = e / (KB / 16), c = e % (KB / 16);
      const bool ok = r0 + r < rows && k0 + 16 * c < K;
      cp_async16(area + swz_off(r, c), ok ? p + (r0 + r) * K + k0 + 16 * c : p,
                 ok);
    }
    return;
  }
  for (int e = tid; e < ROWS * KB; e += THREADS) {
    const int r = e / KB, kk = e % KB;
    const int64_t gr = r0 + r;
    area[swz_off(r, kk / 16) + kk % 16] =
        gr < rows && k0 + kk < K ? static_cast<uint8_t>(p[gr * K + k0 + kk])
                                 : uint8_t(0);
  }
}

// TMA: both operands by tensor-map copies (x and w maps valid); else the
// threads stage them, `vx` / `vw` saying which may go by 16-byte cp.async;
// vo: 16-byte (f32) or 8-byte (bf16) stores of 4 columns
template <typename TO, bool TMA>
__global__ void __launch_bounds__(THREADS, 2)
si_s8s8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const void* __restrict__ bias, int bias_dtype,
                     TO* __restrict__ out, int M, int N, int K, int act,
                     float act_arg, bool vx, bool vw, bool vo) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NS];   // TMA stages landed
  // swizzle atoms are 1024-byte aligned
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int n_stages = (K + KB - 1) / KB;

  if constexpr (TMA) {
    if (tid < NS) mbar_init(full + tid, 1);
    mbar_init_fence();
    __syncthreads();
  }
  auto load = [&](int c) {
    uint8_t* st = smem + (c % NS) * STAGE;
    const int k0 = c * KB;
    if constexpr (TMA) {
      if (tid == 0) {
        mbar_expect_tx(full + c % NS, STAGE);
        tma_box(st, &xmap, k0, static_cast<int>(m0), full + c % NS,
                EVICT_FIRST);
        tma_box(st + A_BYTES, &wmap, k0, n0, full + c % NS, EVICT_LAST);
      }
    } else {
      stage_rows<BM>(st, x, m0, M, k0, K, vx, tid);
      stage_rows<BN>(st + A_BYTES, w, n0, N, k0, K, vw, tid);
    }
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  tc::ring<NS>(
      n_stages, load,
      [&](int c) {
        if constexpr (TMA)
          mbar_wait(full + c % NS, (c / NS) & 1);
        else
          fence_async_proxy();
      },
      [&](int c) {
        const uint8_t* st = smem + (c % NS) * STAGE;
        const uint8_t* a = st + wg * 64 * KB;   // the warpgroup's rows
        const uint8_t* b = st + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)   // k32 steps within the atom
          wgmma_s8(acc, desc(a + 32 * kk), desc(b + 32 * kk));
        wgmma_commit();
        wgmma_wait_all();   // the stage is free before the ring reloads it
        settle(acc);
      });

  // epilogue in two passes: the s32 sums to a [BM][OS] tile in shared
  // memory as they are (acc[4 j + 2 h + e] is row 64 wg + 16 warp + g +
  // 8 h, column 8 j + 2 t + e; g = lane / 4, t = lane % 4), then by rows,
  // 4 columns a thread: int32 -> f32 (round to nearest even, as the JAX
  // astype), * scale[n], + bias[n], the activation, the cast, the store
  // (16 or 8 bytes where `vo`)
  int* ts = reinterpret_cast<int*>(smem);
  const int g = lane / 4, t = lane % 4;
  const int r0 = 64 * wg + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int2*>(ts + (r0 + 8 * h) * OS + 8 * j + 2 * t) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  // a thread's 4 columns are the same in every row it takes
  const int c = 4 * (tid % (BN / 4));
  const int gn = n0 + c;
  float sv[4], bv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = min(gn + q, N - 1);
    sv[q] = scale[n];
    bv[q] = bias != nullptr ? load_bias(bias, bias_dtype, n) : 0.0f;
  }
  tc::with_act(act, [&](auto A) {
    constexpr int kAct = decltype(A)::value;
#pragma unroll 4
    for (int r = tid / (BN / 4); r < BM; r += THREADS / (BN / 4)) {
      const int64_t gm = m0 + r;
      if (gm >= M || gn >= N) break;
      const int4 a = *reinterpret_cast<const int4*>(ts + r * OS + c);
      const int ai[4] = {a.x, a.y, a.z, a.w};
      alignas(8) TO o4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = __int2float_rn(ai[q]) * sv[q];
        if (bias != nullptr) v += bv[q];
        v = kAct == ACT_SILU ? silu_fast(v)
                             : activate(v, kAct < 0 ? act : kAct, act_arg);
        o4[q] = from_f32<TO>(v);
      }
      TO* dst = out + gm * N + gn;
      if (vo && gn + 4 <= N) {
        if constexpr (sizeof(TO) == 4)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(o4);
        else
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<uint2*>(o4);
      } else {
        for (int q = 0; q < 4 && gn + q < N; ++q) dst[q] = o4[q];
      }
    }
  });
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a 2-D tensor map of a [rows, K] int8 matrix (row stride K bytes) in
// 128 x 128-byte boxes with the 128-byte swizzle; false where the encoder
// refuses it
bool tensor_map(CUtensorMap* map, const int8_t* p, int64_t rows, int K,
                int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn)
                                            : nullptr;
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K)};
  const cuuint32_t box[2] = {KB, cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<int8_t*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO, bool TMA>
cudaError_t launch_tile(const CUtensorMap& xmap, const CUtensorMap& wmap,
                        const int8_t* x, const int8_t* w, const float* scale,
                        const void* bias, int bias_dtype, TO* out, int M,
                        int N, int K, int act, float act_arg, bool vx,
                        bool vw, bool vo, cudaStream_t stream) {
  static bool done[tc::MAX_DEVICES] = {};
  auto kern = si_s8s8_wgmma_kernel<TO, TMA>;
  cudaError_t err = tc::allow_smem(kern, SMEM, done);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  kern<<<dim3((N + BN - 1) / BN, m_tiles), THREADS, SMEM, stream>>>(
      xmap, wmap, x, w, scale, bias, bias_dtype, out, M, N, K, act, act_arg,
      vx, vw, vo);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale,
                   const void* bias, int bias_dtype, void* out, int M, int N,
                   int K, int act, float act_arg, cudaStream_t stream) {
  auto* o = static_cast<TO*>(out);
  const bool vx = K % 16 == 0 && aligned16(x);
  const bool vw = K % 16 == 0 && aligned16(w);
  const bool vo = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) %
                                     (4 * sizeof(TO)) == 0;
  CUtensorMap xmap = {}, wmap = {};
  if (vx && vw && tensor_map(&xmap, x, M, K, BM) &&
      tensor_map(&wmap, w, N, K, BN))
    return launch_tile<TO, true>(xmap, wmap, x, w, scale, bias, bias_dtype, o,
                                 M, N, K, act, act_arg, vx, vw, vo, stream);
  return launch_tile<TO, false>(xmap, wmap, x, w, scale, bias, bias_dtype, o,
                                M, N, K, act, act_arg, vx, vw, vo, stream);
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// x: int8 [M, K] row-major; w: int8 [K, N] K-major (element (k, n) at
// w[n * K + k], the [K, N] view of a contiguous [N, K] tensor); scale:
// f32 [N]; bias: [N] f32 or bf16 or null; out: [M, N] f32 or bf16,
// row-major.
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
