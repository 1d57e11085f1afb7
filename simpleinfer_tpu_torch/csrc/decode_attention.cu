// Per-row-length KV-cache decode attention (flash-decoding) for Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind
// `decode_attention` (simpleinfer_tpu/kernels/decode_attn.py,
// pallas_call in `_decode_impl`). For each row n and kv head h, the G
// query heads grouped under h attend the cache positions
// j < min(lengths[n], bound):
//
//     s[g,j] = scale * q[n,h,g,:] . k[n,h,j,:]  (* k_scale[n,h,j])
//     m = max_j s,  l = sum_j exp(s - m),
//     o[g,:] = sum_j exp(s[g,j] - m) * v[n,h,j,:]  (* v_scale[n,h,j])
//
// returned UNNORMALIZED (o, m, l) in f32, with the finite sentinel
// m = -1e30 (and o = 0, l = 0) for a row with nothing to attend: the
// caller merges it with the decode block's scratch keys.
//
// What bounds it on an H100: one query per head against the cache is
// 4 G FLOPs per cache position and D elements of K and V each: bytes-
// bound (3.35 TB/s) by the KV read, but at G = 4 every bf16 element
// costs 8 FMAs, about 40% of the FP32 peak at the full HBM rate. The
// design keeps the bytes in flight and the arithmetic in registers:
//   - split over positions: each (row, kv head) is S thread blocks (S
//     fixed at launch from the bound); block z takes its share
//     [z*per, z*per + per) of the row's live prefix, per = ceil(len / S),
//     derived from lengths[n] on the device (the host never reads the
//     lengths). A block with an empty share contributes the neutral
//     partial (m = -1e30, l = 0, o = 0);
//   - K and V tiles come into a 3-stage ring (csrc/mma.cuh, si::tc::ring)
//     in their storage dtype (bf16, f32 or int8): a tile's rows are
//     contiguous, so where they need no padding one thread moves each
//     tile with one bulk (TMA) copy that lands on an mbarrier; otherwise
//     every thread copies 16 bytes at a time by cp.async (8 or 4 where a
//     row's bytes allow no more, element copies below that), zero past
//     the share; the int8 scales by 4-byte cp.async beside them. Rows past
//     the share are never read;
//   - a cache row is read by a group of `lp` lanes, each its own 16
//     bytes (8 for int8) straight into registers and widened there; the
//     group's q slice (all G heads) lives in registers, so a warp
//     covers 32 / lp positions a step and the G heads share each read
//     (GQA); the dot products reduce over the group by xor shuffles;
//   - every lane group runs its own online softmax (running max, sum
//     and its slice of o, f32) over 2 positions at a time, P.V as f32
//     FMAs from registers (P is never rounded); int8 scales fold onto
//     the scores (k) and the probabilities (v);
//   - the partials merge in a fixed order: the block's lane groups
//     through shared memory in group order; then each split writes its
//     partial to a scratch buffer and counts itself in, and the last of a
//     row's splits to arrive merges all S in split order (its counter
//     back to 0 for the next launch). Reruns are bit-equal.
// Scores stay on the CUDA cores: the FMAs take less time than the bytes
// at G <= 4 (the llama path's G is 4).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (kernels/build.py) and called
//             through ctypes via `si_decode_attention`.

#include <math.h>

#include "mma.cuh"

namespace {

using namespace si;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int NI = 2;        // positions of a lane group per tile
constexpr int STAGES = 3;    // the ring
constexpr int MAX_SPLITS = 16;   // blocks sharing a (row, kv head)
constexpr int MAX_GT = 8;        // query heads per block
constexpr float NEG = -1e30f;
constexpr float L2E = 1.4426950408889634f;
// an H100 block's shared memory, less room for the static `last` flag
constexpr int MAX_SMEM = 232448 - 1024;

// bytes of a cache row one lane reads: 16, or 8 for int8 (so an int8
// lane widens 8 values, as a bf16 lane does)
template <typename TC>
__host__ __device__ constexpr int lane_bytes() {
  return sizeof(TC) == 1 ? 8 : 16;
}

// Shared memory of one block. The ring: STAGES x (K tile, V tile, and
// for int8 the k and v scales of the tile's positions). After the walk
// the same memory holds the partials: per lane group its o slice and m,
// l and merge weight per head, then the block's merged (o, m, l).
struct Layout {
  int lp, pw, bk, rb, dp, groups, tile, stage, ring;
  int po, pm, pl, pwt, bo, bm, bl, total;
  __host__ __device__ Layout(int lb, int vec, int row_bytes, int gt,
                             bool quant) {
    lp = 1;
    while (lp * lb < row_bytes) lp *= 2;
    pw = 32 / (lp < 32 ? lp : 32);
    bk = NI * WARPS * pw;
    rb = lp * lb;
    dp = lp * vec;
    groups = WARPS * pw;
    tile = bk * rb;
    stage = 2 * tile + (quant ? 2 * bk * 4 : 0);
    ring = STAGES * stage;
    po = 0;
    pm = po + groups * gt * dp * 4;
    pl = pm + groups * gt * 4;
    pwt = pl + groups * gt * 4;
    bo = pwt + groups * gt * 4;
    bm = bo + gt * dp * 4;
    bl = bm + gt * 4;
    const int parts = bl + gt * 4;
    total = ring > parts ? ring : parts;
  }
};

// the lane's 16 (8) bytes of a cache row, widened to f32, exactly
__device__ __forceinline__ void widen(const uint8_t* p, float (&f)[4],
                                      float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void widen(const uint8_t* p, float (&f)[8],
                                      __nv_bfloat16) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint8_t* p, float (&f)[8],
                                      int8_t) {
  // the biased byte b + 128 under the exponent of 2^23, minus 2^23 + 128
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u,
                                       0x7440 + i % 4)) - 8388736.0f;
}

// rows [p0, p0 + n_pos) of a [L, D] cache plane into a tile of rows
// `rb` bytes apart; rows past n_pos zero-filled. `ch` bytes a copy (16,
// 8 or 4; 2^lcp copies span a padded row, those past the row's own bytes
// are skipped), or element copies when ch is 0
template <typename TC>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const TC* src,
                                           int p0, int n_pos, int bk,
                                           int rb, int D, int ch, int lcp,
                                           int tid) {
  const int row_bytes = D * static_cast<int>(sizeof(TC));
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src);
  if (ch == 0) {
    for (int e = tid; e < bk * D; e += THREADS) {
      const int j = e / D, d = e % D;
      reinterpret_cast<TC*>(dst + j * rb)[d] =
          j < n_pos ? src[int64_t(p0 + j) * D + d] : static_cast<TC>(0.0f);
    }
    return;
  }
  for (int e = tid; e < bk << lcp; e += THREADS) {
    const int j = e >> lcp, c = (e & ((1 << lcp) - 1)) * ch;
    if (c >= row_bytes) continue;
    const bool ok = j < n_pos;
    const uint8_t* from = ok ? s + int64_t(p0 + j) * row_bytes + c : s;
    uint8_t* to = dst + j * rb + c;
    if (ch == 16)
      cp_async16(to, from, ok);
    else if (ch == 8)
      cp_async_ca<8>(to, from, ok);
    else
      cp_async_ca<4>(to, from, ok);
  }
}

// One block: split z of the S of row = n * KV + h, query heads
// [g0, g0 + GT) of the row's G (those past G are zero). TC: the cache
// dtype; GT: query heads a block carries in registers. With S > 1 the
// splits meet in `part` ([rows x head groups][S][GT][D + 2]: o, m, l)
// and `count` (one counter per row and head group, 0 between launches).
template <typename TC, int GT>
__global__ void __launch_bounds__(THREADS)
si_decode_split_kernel(const void* __restrict__ q, bool q_bf16,
                       const TC* __restrict__ k, const float* __restrict__ ks,
                       const TC* __restrict__ v, const float* __restrict__ vs,
                       const int* __restrict__ lengths,
                       float* __restrict__ o, float* __restrict__ mo,
                       float* __restrict__ lo, float* __restrict__ part,
                       int* __restrict__ count, int S, int KV, int G, int L,
                       int D, int bound, int ch, int lcp, bool bulk,
                       float scale) {
  constexpr int LB = lane_bytes<TC>();
  constexpr int VEC = LB / sizeof(TC);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;   // this block merges the row's splits
  __shared__ __align__(8) uint64_t full[STAGES];   // bulk tiles landed
  const int z = blockIdx.x % S;
  const int row = blockIdx.x / S;
  const int n = row / KV;
  const int g0 = blockIdx.y * GT;
  const int gn = min(GT, G - g0);
  const bool quant = ks != nullptr;
  const int row_bytes = D * static_cast<int>(sizeof(TC));
  const Layout lay(LB, VEC, row_bytes, GT, quant);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / lay.lp, qi = lane % lay.lp;

  // this split's share [c0, c1) of the row's live prefix
  const int len = max(0, min(min(lengths[n], bound), L));
  const int per = (len + S - 1) / S;
  const int c0 = min(len, z * per), c1 = min(len, c0 + per);
  const int n_tiles = (c1 - c0 + lay.bk - 1) / lay.bk;
  const int64_t plane = int64_t(row) * L;   // position 0 of the row
  const TC* kb = k + plane * D;
  const TC* vb = v + plane * D;

  // the group's slice of q, every head of the block, zero past D and G
  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = qi * VEC + e;
      const int64_t at = (int64_t(row) * G + g0 + g) * D + d;
      qr[g][e] = g < gn && d < D
                     ? (q_bf16 ? __bfloat162float(
                                     static_cast<const __nv_bfloat16*>(q)[at])
                               : static_cast<const float*>(q)[at])
                     : 0.0f;
    }

  // padded rows read zeros past D: clear the ring once (copies write the
  // row's own bytes only)
  if (lay.rb > row_bytes) {
    for (int e = tid; e < lay.ring / 16; e += THREADS)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  if (bulk) {
    if (tid < STAGES) mbar_init(full + tid, 1);
    mbar_init_fence();
    __syncthreads();
  }
  auto load = [&](int t) {
    uint8_t* st = smem + (t % STAGES) * lay.stage;
    const int p0 = c0 + t * lay.bk, n_pos = min(lay.bk, c1 - p0);
    if (bulk) {   // the tile's rows are contiguous: two copies, one thread
      if (tid == 0) {
        const int bytes = n_pos * row_bytes;
        mbar_expect_tx(full + t % STAGES, 2 * bytes);
        bulk_copy(st, kb + int64_t(p0) * D, bytes, full + t % STAGES);
        bulk_copy(st + lay.tile, vb + int64_t(p0) * D, bytes,
                  full + t % STAGES);
      }
      return;
    }
    stage_rows(st, kb, p0, n_pos, lay.bk, lay.rb, D, ch, lcp, tid);
    stage_rows(st + lay.tile, vb, p0, n_pos, lay.bk, lay.rb, D, ch, lcp,
               tid);
    if (quant) {
      float* sc = reinterpret_cast<float*>(st + 2 * lay.tile);
      for (int j = tid; j < lay.bk; j += THREADS) {
        const bool ok = j < n_pos;
        const int64_t at = plane + (ok ? p0 + j : 0);
        cp_async_ca<4>(sc + j, ks + at, ok);
        cp_async_ca<4>(sc + lay.bk + j, vs + at, ok);
      }
    }
  };

  float m_run[GT], l_run[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m_run[g] = NEG;
    l_run[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  }

  auto land = [&](int t) {
    if (bulk) mbar_wait(full + t % STAGES, (t / STAGES) & 1);
  };
  tc::ring<STAGES>(n_tiles, load, land, [&](int t) {
    const uint8_t* st = smem + (t % STAGES) * lay.stage;
    const float* sc = reinterpret_cast<const float*>(st + 2 * lay.tile);
    const int p0 = c0 + t * lay.bk;

    float s[GT][NI];
    int j_of[NI];
    bool live[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int j = (warp * NI + i) * lay.pw + grp;
      j_of[i] = j;
      live[i] = p0 + j < c1;
      float kf[VEC];
      widen(st + j * lay.rb + qi * LB, kf, TC());
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        // over the lane group (lp lanes): unrolled, so the reductions
        // of the NI x GT dot products interleave
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          if (off < lay.lp) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float sv = dot * scale;
        if (quant) sv *= sc[j];      // (q . k_q) * k_s: dequant the score
        s[g][i] = live[i] ? sv : NEG;
      }
    }
    // the lane group's online softmax over its NI positions
    float p[GT][NI];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mt = s[g][0];
#pragma unroll
      for (int i = 1; i < NI; ++i) mt = fmaxf(mt, s[g][i]);
      const float m_new = fmaxf(m_run[g], mt);
      const float ml = m_new * L2E;
      // the difference first: m_run * L2E - ml contracts to an FMA whose
      // rounding residue (~1e22 at m = -1e30) would overflow ex2
      const float alpha = fast_exp2((m_run[g] - m_new) * L2E);  // 0 from NEG
      float lt = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        p[g][i] = live[i] ? fast_exp2(fmaf(s[g][i], L2E, -ml)) : 0.0f;
        lt += p[g][i];
      }
      l_run[g] = fmaf(l_run[g], alpha, lt);
      m_run[g] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float vf[VEC];
      widen(st + lay.tile + j_of[i] * lay.rb + qi * LB, vf, TC());
      const float vsc = quant ? sc[lay.bk + j_of[i]] : 1.0f;
      if (!live[i]) continue;   // past the share: a bulk tile leaves it stale
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pv = p[g][i] * vsc;   // fold the v scale onto p
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
      }
    }
  });   // the ring is free: the partials take its place

  float* po = reinterpret_cast<float*>(smem + lay.po);
  float* pm = reinterpret_cast<float*>(smem + lay.pm);
  float* pl = reinterpret_cast<float*>(smem + lay.pl);
  float* pwt = reinterpret_cast<float*>(smem + lay.pwt);
  float* bo = reinterpret_cast<float*>(smem + lay.bo);
  float* bm = reinterpret_cast<float*>(smem + lay.bm);
  float* bl = reinterpret_cast<float*>(smem + lay.bl);
  const int gi = warp * lay.pw + grp;   // the lane group
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      po[(gi * GT + g) * lay.dp + qi * VEC + e] = acc[g][e];
    if (qi == 0) {
      pm[gi * GT + g] = m_run[g];
      pl[gi * GT + g] = l_run[g];
    }
  }
  __syncthreads();
  // the block's merge, lane groups in order: max, weights, sums
  for (int g = tid; g < gn; g += THREADS) {
    float mx = NEG;
    for (int i = 0; i < lay.groups; ++i) mx = fmaxf(mx, pm[i * GT + g]);
    bm[g] = mx;
  }
  __syncthreads();
  for (int e = tid; e < lay.groups * gn; e += THREADS) {
    const int i = e / gn, g = e % gn;
    pwt[i * GT + g] = fast_exp2((pm[i * GT + g] - bm[g]) * L2E);
  }
  __syncthreads();
  for (int e = tid; e < gn * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float sum = 0.0f;
    for (int i = 0; i < lay.groups; ++i)
      sum = fmaf(po[(i * GT + g) * lay.dp + d], pwt[i * GT + g], sum);
    bo[g * lay.dp + d] = sum;
  }
  for (int g = tid; g < gn; g += THREADS) {
    float sum = 0.0f;
    for (int i = 0; i < lay.groups; ++i)
      sum = fmaf(pl[i * GT + g], pwt[i * GT + g], sum);
    bl[g] = sum;
  }

  __syncthreads();
  const int64_t hrow = int64_t(row) * gridDim.y + blockIdx.y;
  const int64_t out0 = int64_t(row) * G + g0;   // the block's first head
  if (S == 1) {
    for (int e = tid; e < gn * D; e += THREADS)
      o[(out0 + e / D) * D + e % D] = bo[(e / D) * lay.dp + e % D];
    for (int g = tid; g < gn; g += THREADS) {
      mo[out0 + g] = bm[g];
      lo[out0 + g] = bl[g];
    }
    return;
  }
  // this split's partial to the scratch, then count it in
  const int psz = GT * (D + 2);
  float* pp = part + (hrow * S + z) * psz;
  for (int e = tid; e < gn * D; e += THREADS)
    pp[e] = bo[(e / D) * lay.dp + e % D];
  for (int g = tid; g < gn; g += THREADS) {
    pp[GT * D + g] = bm[g];
    pp[GT * D + GT + g] = bl[g];
  }
  __threadfence();   // the partial is seen before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + hrow, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();   // and the others' partials are seen here
  // the last split merges all S in split order
  const float* p0s = part + hrow * S * psz;
  for (int e = tid; e < gn * D; e += THREADS) {
    const int g = e / D;
    float mx = NEG;
    for (int r = 0; r < S; ++r)
      mx = fmaxf(mx, __ldcg(p0s + r * psz + GT * D + g));
    float sum = 0.0f;
    for (int r = 0; r < S; ++r)
      sum = fmaf(__ldcg(p0s + r * psz + e),
                 fast_exp2((__ldcg(p0s + r * psz + GT * D + g) - mx) * L2E),
                 sum);
    o[(out0 + g) * D + e % D] = sum;
  }
  for (int g = tid; g < gn; g += THREADS) {
    float mx = NEG;
    for (int r = 0; r < S; ++r)
      mx = fmaxf(mx, __ldcg(p0s + r * psz + GT * D + g));
    float sum = 0.0f;
    for (int r = 0; r < S; ++r)
      sum = fmaf(__ldcg(p0s + r * psz + GT * D + GT + g),
                 fast_exp2((__ldcg(p0s + r * psz + GT * D + g) - mx) * L2E),
                 sum);
    mo[out0 + g] = mx;
    lo[out0 + g] = sum;
  }
  if (tid == 0) count[hrow] = 0;   // ready for the next launch
}

template <typename TC, int GT>
cudaError_t launch(const void* q, bool q_bf16, const void* k,
                   const float* ks, const void* v, const float* vs,
                   const int* lengths, float* o, float* m, float* l,
                   float* part, int* count, int N, int KV, int G, int L,
                   int D, int bound, int splits, float scale,
                   cudaStream_t stream) {
  constexpr int LB = lane_bytes<TC>();
  const int row_bytes = D * static_cast<int>(sizeof(TC));
  const Layout lay(LB, LB / sizeof(TC), row_bytes, GT, ks != nullptr);
  if (lay.lp > 32 || lay.total > MAX_SMEM) return cudaErrorInvalidValue;
  // bytes a copy: the largest of 16, 8, 4 that a row's bytes allow
  const int ch = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8
                 : row_bytes % 4 == 0 ? 4 : 0;
  int lcp = 0;   // log2 of the copies spanning a padded row
  while (ch > 0 && (ch << lcp) < lay.rb) ++lcp;
  // whole unpadded rows of 16-byte multiples: a tile is one bulk copy
  const bool bulk = ks == nullptr && ch == 16 && lay.rb == row_bytes;
  static bool done[tc::MAX_DEVICES] = {};
  auto kern = si_decode_split_kernel<TC, GT>;
  cudaError_t err = tc::allow_smem(kern, MAX_SMEM, done);
  if (err != cudaSuccess) return err;
  kern<<<dim3(N * KV * splits, (G + GT - 1) / GT), THREADS, lay.total,
         stream>>>(q, q_bf16, static_cast<const TC*>(k), ks,
                   static_cast<const TC*>(v), vs, lengths, o, m, l, part,
                   count, splits, KV, G, L, D, bound, ch, lcp, bulk, scale);
  return cudaGetLastError();
}

// heads per block: the least of 1, 2, 4, 8 that holds G (8 for larger G,
// whose head groups take gridDim.y)
template <typename TC>
cudaError_t dispatch_heads(const void* q, bool q_bf16, const void* k,
                           const float* ks, const void* v, const float* vs,
                           const int* lengths, float* o, float* m, float* l,
                           float* part, int* count, int N, int KV, int G,
                           int L, int D, int bound, int splits, float scale,
                           cudaStream_t stream) {
#define SI_DECODE_LAUNCH(GT)                                                 \
  return launch<TC, GT>(q, q_bf16, k, ks, v, vs, lengths, o, m, l, part,     \
                        count, N, KV, G, L, D, bound, splits, scale, stream)
  if (G <= 1) SI_DECODE_LAUNCH(1);
  if (G <= 2) SI_DECODE_LAUNCH(2);
  if (G <= 4) SI_DECODE_LAUNCH(4);
  SI_DECODE_LAUNCH(MAX_GT);
#undef SI_DECODE_LAUNCH
}

}  // namespace

// Plain C entry point for ctypes. q [N, KV, G, D] (f32/bf16), k and v
// [N, KV, L, D] (f32, bf16, or int8 with f32 [N, KV, L, 1] scales ks/vs),
// lengths int32 [N]; writes o [N, KV, G, D], m and l [N, KV, G, 1] (f32).
// `splits` blocks (1..16) share each (row, kv head); with more than one
// they meet in `part` (f32, splits x N x KV x ceil(G / 8) x 8 x (D + 2)
// at least) and `count` (int32, N x KV x ceil(G / 8), all 0; left 0). A
// cache row's bytes (D x the dtype's size) may be at most 512 (256 for
// int8). Launches on `stream`, does not synchronise, allocates nothing;
// returns the cudaError_t of the launch.
extern "C" int si_decode_attention(const void* q, int q_dtype, const void* k,
                                   const void* ks, const void* v,
                                   const void* vs, int c_dtype,
                                   const void* lengths, void* o, void* m,
                                   void* l, void* part, void* count, int N,
                                   int KV, int G, int L, int D, int bound,
                                   int splits, float scale, void* stream) {
  if (N <= 0 || KV <= 0 || G <= 0 || L < 0 || D <= 0 || splits < 1 ||
      splits > MAX_SPLITS || int64_t(N) * KV * splits > 0x7fffffff ||
      (G + MAX_GT - 1) / MAX_GT > 65535 ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  if (q_dtype != DT_F32 && q_dtype != DT_BF16) return cudaErrorInvalidValue;
  const bool qb = q_dtype == DT_BF16;
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* lens = static_cast<const int*>(lengths);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* pf = static_cast<float*>(part);
  int* cnt = static_cast<int*>(count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_dtype) {
    case DT_F32:
      return dispatch_heads<float>(q, qb, k, nullptr, v, nullptr, lens, of,
                                   mf, lf, pf, cnt, N, KV, G, L, D, bound,
                                   splits, scale, st);
    case DT_BF16:
      return dispatch_heads<__nv_bfloat16>(q, qb, k, nullptr, v, nullptr,
                                           lens, of, mf, lf, pf, cnt, N, KV,
                                           G, L, D, bound, splits, scale, st);
    case DT_I8:
      if (ksf == nullptr || vsf == nullptr) return cudaErrorInvalidValue;
      return dispatch_heads<int8_t>(q, qb, k, ksf, v, vsf, lens, of, mf, lf,
                                    pf, cnt, N, KV, G, L, D, bound, splits,
                                    scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
