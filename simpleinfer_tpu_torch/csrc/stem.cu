// The YOLOv5 6x6 stride-2 pad-2 stem conv as an im2col GEMM in shared
// memory on the tensor cores, for Hopper.
//
// Replaces the Pallas TPU kernel `_stem_kernel` behind `stem_s2d`
// (simpleinfer_tpu/kernels/stem.py, pallas_call in `stem_s2d`). Input
// in the TPU's staged layout, kept at the public function:
//
//     x [N, 645, 6, 320] bf16   rows (2 top + 640 + 3 bottom pad) x
//                               slot (W parity wl * 3 + channel c) x
//                               lane m (output column)
//     w [128, OC] bf16 or f32   row k = kh*18 + j*6 + wl*3 + c (108 used)
//     out[n, oh, m, o] = act(sum over k < 108 of
//                            x[n, 2*oh + kh, wl*3 + c, m + j - 1] * w[k, o]
//                            + bias[o])     bf16 [N, 320, 320, OC]
//
// with lanes -1 and 320 read as zero (the W padding; the H padding is in
// the staged rows), f32 sums and one rounding to bf16.
//
// What bounds it on an H100: per output pixel 2 * 108 * OC operations
// against 12 staged input values (24 bytes) and 2 * OC bytes of output:
// 78-87 FLOPs per byte at OC 32-64, below the bf16 ridge (~295), so the
// bytes bound it (at N 8, OC 32: 19.8 MB in, 52.4 MB out, ~0.022 ms at
// 3.35 TB/s). The kernel reads each staged row from device memory about
// once (three neighbouring blocks share it through the L2) and writes
// the output once.
//
// Design. The TPU kernel keeps the 320 output columns in lanes end to end
// (Mosaic cannot split or merge the lane dim), rolls the lanes for the
// m - 1 / m + 1 taps and contracts with a transposed dot. Here a block
// walks a band of output rows (n, oh0 .. oh0 + R - 1), one at a time:
// 320 pixels x up to 64 channels a step, R chosen so that every block
// is resident at once (2 an SM).
//   - Output row oh reads staged rows 2 oh .. 2 oh + 5 (6 slots each, 640
//     contiguous bytes apiece); the next one 4 of those and 2 new rows.
//     The block keeps a ring of 8 staged rows: the 2 rows of step i + 1
//     come by bulk (TMA) copies on an mbarrier while step i multiplies.
//     Each lands in the middle copy of the patch area P[j][ring row]
//     [slot][lane] (j = 1: lane m itself), rows padded to 328 lanes so
//     the 8 rows of an ldmatrix fall on distinct banks; the threads then
//     write the two shifted copies of the new rows (j = 0: lane m - 1,
//     j = 2: lane m + 1, zero past either edge) as 16-byte vectors, each
//     a funnel shift of two neighbouring vectors. P holds the patch
//     matrix [k = 108][m = 320] m-contiguous, so the A fragments of
//     mma.sync come by ldmatrix.trans from it: no element gathers, and
//     each staged row is copied into shared memory once a block.
//   - K = 108 runs as 7 k16 steps; rows 108 .. 111 read a zero row.
//   - w [112, OC] is staged once a block, converted to bf16 (w may be
//     given in f32: the wrapper casts nothing per call), zero past row
//     108 and past OC; its B fragments by ldmatrix.trans.
//   - mma.sync m16n8k16 bf16 -> f32 with N = OC (an n8 tile per 8
//     channels, up to 64 a block; blocks along y take the next 64), so no
//     column is idle at OC 16, 32, 48 or 64. 10 warps, 2 m16 tiles each.
//   - Bias and activation in registers (the activation compiled into its
//     own loop, SiLU by __expf), then the four lanes of an output pixel
//     trade bf16 pairs by shuffles so that each stores whole 16-byte
//     chunks: a warp's store covers 64 contiguous bytes of 8 pixels of
//     the output row (n, oh), 320 * OC * 2 contiguous bytes (stores of
//     bf16 pairs left sectors half full and were most of the time at
//     OC 64).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/stem.py does this at
//             first use) and called through ctypes via `si_stem_s2d`.

#include <algorithm>

#include "mma.cuh"

namespace {

using namespace si;

constexpr int HP = 645;       // staged rows: 640 + 2 top + 3 bottom pad
constexpr int SLOTS = 6;      // W parity x channel
constexpr int LANES = 320;    // output columns
constexpr int OHW = 320;      // output rows (= output columns)
constexpr int KU = 108;       // useful patch taps: 6 kh x 3 j x 6 slots
constexpr int KP = 112;       // 7 k16 steps
constexpr int PS = LANES + 8; // patch row (elements): 656 bytes
constexpr int RING = 8;       // staged rows held: 6 in use + 2 arriving
constexpr int PROWS = 3 * RING * SLOTS;  // (j, ring row, slot)
constexpr int THREADS = 320;             // 10 warps, 2 m16 tiles each
constexpr int ROW_BYTES = LANES * 2;     // one staged (row, slot)
constexpr int MAX_NW = 64;               // channels a block
constexpr int BLOCKS_PER_SM = 2;

// shared memory: the patch rows, a zero row, w [KP][NW + 8], the bias,
// the mbarrier
constexpr int P_OFF = 0;
constexpr int Z_OFF = P_OFF + PROWS * PS * 2;
constexpr int W_OFF = Z_OFF + PS * 2;
template <int NW>
struct Smem {
  static constexpr int WS = NW + 8;
  static constexpr int B_OFF = W_OFF + KP * WS * 2;
  static constexpr int BAR_OFF = B_OFF + NW * 4;
  static constexpr int BYTES = BAR_OFF + 16;
};

__device__ __forceinline__ int prow(int j, int ring_row, int slot) {
  return (j * RING + ring_row) * SLOTS + slot;
}

template <typename TW>
__device__ __forceinline__ __nv_bfloat16 w_bf16(TW v);
template <>
__device__ __forceinline__ __nv_bfloat16 w_bf16(__nv_bfloat16 v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 w_bf16(float v) {
  return __float2bfloat16_rn(v);
}

// SiLU by __expf and __fdividef (~1e-6 relative from expf and an IEEE
// division, under one bf16 ulp), the rest as csrc/epilogue.cuh has them
template <int A>
__device__ __forceinline__ float act_stem(float v, int act, float a) {
  if constexpr (A == ACT_SILU) return __fdividef(v, 1.0f + __expf(-v));
  return activate(v, A < 0 ? act : A, a);
}

// NT n8 tiles (NW = 8 NT channels); VO: 16-byte output stores (OC % 8 ==
// 0, out aligned), else element stores; R output rows a block
template <int NT, typename TW, bool VO>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
si_stem_kernel(const __nv_bfloat16* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int OC, int R, int act,
               float act_arg) {
  constexpr int NW = 8 * NT;
  using S = Smem<NW>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + P_OFF);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + W_OFF);
  const __nv_bfloat16* Z = reinterpret_cast<__nv_bfloat16*>(smem + Z_OFF);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bands = (OHW + R - 1) / R;
  const int64_t img = blockIdx.x / bands;
  const int oh0 = static_cast<int>(blockIdx.x % bands) * R;
  const int rows = min(R, OHW - oh0);
  const int c0 = blockIdx.y * NW;
  const __nv_bfloat16* xi = x + img * HP * static_cast<int64_t>(SLOTS * LANES);

  // staged rows [sr0, sr0 + n) into the ring (one thread; every slot row
  // 640 bytes on the same mbarrier phase)
  auto fetch = [&](int sr0, int n) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, n * SLOTS * ROW_BYTES);
    for (int r = 0; r < n * SLOTS; ++r) {
      const int sr = sr0 + r / SLOTS, slot = r % SLOTS;
      bulk_copy(P + prow(1, sr % RING, slot) * PS,
                xi + (static_cast<int64_t>(sr) * SLOTS + slot) * LANES,
                ROW_BYTES, bar);
    }
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    fetch(2 * oh0, 6);
  }
  // meanwhile: w (bf16, zero past row 108 and column OC) and the zero row
  for (int e = tid; e < KP * NW; e += THREADS) {
    const int k = e / NW, c = e % NW;
    Ws[k * S::WS + c] = k < KU && c0 + c < OC
                            ? w_bf16(w[static_cast<int64_t>(k) * OC + c0 + c])
                            : __float2bfloat16_rn(0.0f);
  }
  for (int e = tid; e < PS / 8; e += THREADS)
    reinterpret_cast<uint4*>(smem + Z_OFF)[e] = make_uint4(0, 0, 0, 0);
  // the bias of the block's output columns
  float* bs = reinterpret_cast<float*>(smem + S::B_OFF);
  for (int c = tid; c < NW; c += THREADS)
    bs[c] = c0 + c < OC ? bias[c0 + c] : 0.0f;
  // the lane's ldmatrix.trans row of A at each k16 step: k = 16 s + (lane
  // % 8) + 8 (lane / 16), m offset 8 ((lane / 8) % 2)
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int a_m = ((lane >> 3) & 1) * 8;
  __syncthreads();   // the mbarrier's init, w and the zero row seen by all

  for (int i = 0; i < rows; ++i) {
    const int oh = oh0 + i;
    const int new0 = i == 0 ? 2 * oh : 2 * oh + 4;   // rows that arrived
    const int n_new = i == 0 ? 6 : 2;
    mbar_wait(bar, i & 1);
    // the shifted copies of the new rows: P[0][..][m] = P[1][..][m - 1],
    // P[2][..][m] = P[1][..][m + 1], zero past either edge
    constexpr int VECS = LANES / 8;
    for (int e = tid; e < n_new * SLOTS * VECS; e += THREADS) {
      const int r = e / VECS, v = e % VECS;
      const int rr = (new0 + r / SLOTS) % RING, slot = r % SLOTS;
      const uint4* mid =
          reinterpret_cast<const uint4*>(P + prow(1, rr, slot) * PS);
      const uint4 cur = mid[v];
      const uint4 prev = v > 0 ? mid[v - 1] : make_uint4(0, 0, 0, 0);
      const uint4 next = v + 1 < VECS ? mid[v + 1] : make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(P + prow(0, rr, slot) * PS)[v] = make_uint4(
          __funnelshift_r(prev.w, cur.x, 16),
          __funnelshift_r(cur.x, cur.y, 16),
          __funnelshift_r(cur.y, cur.z, 16),
          __funnelshift_r(cur.z, cur.w, 16));
      reinterpret_cast<uint4*>(P + prow(2, rr, slot) * PS)[v] = make_uint4(
          __funnelshift_r(cur.x, cur.y, 16),
          __funnelshift_r(cur.y, cur.z, 16),
          __funnelshift_r(cur.z, cur.w, 16),
          __funnelshift_r(cur.w, next.x, 16));
    }
    __syncthreads();   // P complete for oh; every warp done with oh - 1
    // the next row's 2 staged rows replace rows 2 oh - 2, 2 oh - 1
    if (tid == 0 && i + 1 < rows) fetch(2 * oh + 6, 2);

    uint32_t a_row[KP / 16];
#pragma unroll
    for (int s = 0; s < KP / 16; ++s) {
      const int k = 16 * s + a_k;
      const int kh = k / 18, j = (k % 18) / SLOTS, slot = k % SLOTS;
      // rows 108 .. 111 read the zero row (656 bytes: any m offset fits)
      a_row[s] = smem_u32(
          (k < KU ? P + prow(j, (2 * oh + kh) % RING, slot) * PS : Z) + a_m);
    }
    __nv_bfloat16* dst =
        out + ((img * OHW + oh) * static_cast<int64_t>(LANES)) * OC + c0;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int m0 = 16 * (warp + 10 * mt);
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < KP / 16; ++s) {
        uint32_t a[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
            "[%4];\n"
            : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
            : "r"(a_row[s] + 2 * m0));
#pragma unroll
        for (int nj = 0; nj < NT / 2; ++nj) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Ws + (16 * s + (lane & 15)) * S::WS +
                                   16 * nj + (lane >> 4) * 8);
          mma_bf16(acc[2 * nj], a, b[0], b[1]);
          mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
        }
      }
      // bias, activation, bf16 pairs; then each quad of lanes (one output
      // pixel) trades pairs so that lane t holds whole 16-byte chunks of
      // channels 8 j .. 8 j + 7 for j = t mod 4: a warp's store covers 64
      // contiguous bytes of 8 pixels (pair stores left sectors half full)
      const int g = lane / 4, t = lane % 4;
      tc::with_act(act, [&](auto A) {
        constexpr int kAct = decltype(A)::value;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          __nv_bfloat16* o = dst + static_cast<int64_t>(m0 + g + 8 * hh) * OC;
          uint32_t pr[NT];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int c = 8 * j + 2 * t;
            const float2 b2 = *reinterpret_cast<const float2*>(bs + c);
            const float v0 = act_stem<kAct>(acc[j][2 * hh] + b2.x, act,
                                            act_arg);
            const float v1 = act_stem<kAct>(acc[j][2 * hh + 1] + b2.y, act,
                                            act_arg);
            pr[j] = pack_bf16(v0, v1);
            if constexpr (!VO) {
              if (c0 + c < OC) o[c] = __float2bfloat16_rn(v0);
              if (c0 + c + 1 < OC) o[c + 1] = __float2bfloat16_rn(v1);
            }
          }
          if constexpr (VO) {
#pragma unroll
            for (int q = 0; q < (NT + 3) / 4; ++q) {
              // round r: send the pair of chunk 4 q + ((t - r) & 3) to
              // that lane, take the pair of chunk 4 q + t from lane
              // (t + r) & 3, which is word (t + r) & 3 of the chunk
              uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int js = (t - r) & 3;
                uint32_t send = 0u;
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  if (k == js && 4 * q + k < NT)
                    send = pr[min(4 * q + k, NT - 1)];
                const int src = (t + r) & 3;
                const uint32_t got =
                    __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  if (k == src) word[k] = got;
              }
              const int c = 8 * (4 * q + t);
              if (4 * q + t < NT && c0 + c < OC)
                *reinterpret_cast<uint4*>(o + c) =
                    make_uint4(word[0], word[1], word[2], word[3]);
            }
          }
        }
      });
    }
  }
}

template <int NT, typename TW, bool VO>
cudaError_t launch_nt(const void* x, const void* w, const float* bias,
                      void* out, int n, int oc, int act, float act_arg,
                      cudaStream_t st) {
  static bool done[tc::MAX_DEVICES] = {};
  auto kern = si_stem_kernel<NT, TW, VO>;
  constexpr int smem = Smem<8 * NT>::BYTES;
  cudaError_t err = tc::allow_smem(kern, smem, done);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // rows a block: every block of one chunk of channels resident at once
  const int slots = std::max(1, sms * BLOCKS_PER_SM);
  const int r = std::max(1, (n * OHW + slots - 1) / slots);
  const int bands = (OHW + r - 1) / r;
  const dim3 grid(n * bands, (oc + 8 * NT - 1) / (8 * NT));
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const TW*>(w), bias,
      static_cast<__nv_bfloat16*>(out), oc, r, act, act_arg);
  return cudaGetLastError();
}

// the n8 tiles a block: OC rounded up to 16 channels, at most 64
template <typename TW, bool VO>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   int n, int oc, int act, float act_arg, cudaStream_t st) {
  switch (oc > MAX_NW ? MAX_NW / 16 : (oc + 15) / 16) {
    case 1: return launch_nt<2, TW, VO>(x, w, bias, out, n, oc, act, act_arg,
                                        st);
    case 2: return launch_nt<4, TW, VO>(x, w, bias, out, n, oc, act, act_arg,
                                        st);
    case 3: return launch_nt<6, TW, VO>(x, w, bias, out, n, oc, act, act_arg,
                                        st);
    default: return launch_nt<8, TW, VO>(x, w, bias, out, n, oc, act,
                                         act_arg, st);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// x bf16 [n, 645, 6, 320] (16-byte aligned), w [128, oc] of w_dtype (f32
// or bf16; rows >= 108 unused), bias f32 [oc], out bf16 [n, 320, 320, oc].
extern "C" int si_stem_s2d(const void* x, const void* w, int w_dtype,
                           const void* bias, void* out, int n, int oc,
                           int act, float act_arg, void* stream) {
  if (n <= 0 || oc <= 0 || bias == nullptr || !aligned16(x))
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_ELU) return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vo = oc % 8 == 0 && aligned16(out);
  if (w_dtype == DT_BF16)
    return vo ? launch<__nv_bfloat16, true>(x, w, b, out, n, oc, act,
                                            act_arg, st)
              : launch<__nv_bfloat16, false>(x, w, b, out, n, oc, act,
                                             act_arg, st);
  if (w_dtype == DT_F32)
    return vo ? launch<float, true>(x, w, b, out, n, oc, act, act_arg, st)
              : launch<float, false>(x, w, b, out, n, oc, act, act_arg, st);
  return cudaErrorInvalidValue;
}
