// Causal flash attention for NVIDIA Hopper: forward, dK/dV and dQ.
//
// Replaces jax's bundled Pallas TPU kernel that the JAX package reaches
// through distributed_lion_tpu/ops/attention.py:70 (attention_flash):
//   jax/experimental/pallas/ops/tpu/flash_attention.py
//     forward  pallas_call :758 in _flash_attention_impl :589
//     dK/dV    pallas_call :1121 in _flash_attention_bwd_dkv :941
//     dQ       pallas_call :1456 in _flash_attention_bwd_dq :1287
// and di = sum(o * do) stays outside the kernels, as jax computes it (:273).
//
// Layout: q, k, v and do are [B, H, T, D] bf16 tensors taken through their
// batch, head and time strides (head_dim contiguous), so the model's
// transposed views of its qkv projection need no copy. o, dq, dk, dv are
// written contiguous [B, H, T, D] bf16; lse and di are contiguous [B, H, T]
// float32. Scores are s = scale * q.k; lse = m + log(sum exp(s - m)).
//
// Bound: at GPT-2 124M's shape (B 8, H 12, T 1024, D 64) the forward moves
// 50.7 MB and does 12.9 GFLOP of causal products, so on an H100 SXM it is
// bytes-bound (0.015 ms) and the backward is operations-bound.
//
// Forward and dK/dV (Hopper design, hopper.cuh): one block of three
// warpgroups. Warpgroup 0 is the producer: one thread issues TMA loads of
// the tiles (128-byte swizzle, rows past T zero-filled) into a ring of
// STAGES buffers, each with a full and an empty mbarrier, and the
// warpgroup gives its registers to the consumers (setmaxnreg). Warpgroups 1
// and 2 are consumers of 64 rows each: their products are wgmma (bf16,
// float32 sums in registers), both operands from swizzled shared memory for
// the scores, and for the second product A from registers (P or dS rounded
// to bf16 in the accumulator's own layout) and B read MN-major. Scores,
// softmax and the masks stay in registers; no score tile goes through shared
// memory. One block per SM (registers bound it); the ring and the
// asynchronous wgmma hide the latency that resident blocks hid before.
// - forward: a block per 128 queries walks key tiles of 128 up to the
//   diagonal (the only masked tile) with an online softmax in the exp2
//   domain; the row max and sum are shared by the 4 threads of a row by
//   shuffles. o = O / l, lse = m + log(l) in natural log.
// - dK/dV: a block per 128 keys holds K and V in shared memory and streams
//   query tiles of 64 (with their lse and di) from the diagonal to T;
//   P^T = exp(s^T - lse) and dS^T = P^T (dP^T - di) in registers, then
//   dV += P^T.dO and dK += dS^T.Q.
// dQ (one block per 64-row query tile, 4 warps) is still the first design:
// tiles staged by plain 16-byte loads, nvcuda::wmma 16x16x16 products, the
// scores through shared memory in float32.
//
// Every output element is summed by one block in a fixed order: no atomics,
// and the results are the same bits from run to run. P and dS are rounded to
// bf16 before their products, as the plain versions round them. Causal
// masking is applied on the diagonal tiles, rows past T load as zeros and
// are never written. head_dim is a template parameter; only D = 64 is
// instantiated.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

// ------------------------------------------------- forward and dK/dV (Hopper)

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG_THREADS = 128;
constexpr int HOPPER_THREADS = 3 * WG_THREADS;  // a producer and two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536
constexpr int STAGES = 2;

// Forward tiles: 128 queries per block (64 per consumer warpgroup), key
// tiles of 128, so the diagonal is one tile.
constexpr int FWD_BM = 128;
constexpr int FWD_BN = 128;

template <int D>
struct FwdSmem {  // byte offsets from a 1024-byte boundary
  static constexpr int TILE = FWD_BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + FWD_BM * D * 2;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BARS = V + STAGES * TILE;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + hopper::SW128_ATOM_BYTES;
};

// dK/dV tiles: 128 keys per block (64 per consumer warpgroup), query tiles
// of 64 streamed through the ring with their lse and di rows.
constexpr int DKV_BN = 128;
constexpr int DKV_BQ = 64;

template <int D>
struct DkvSmem {
  static constexpr int TILE = DKV_BQ * D * 2;
  static constexpr int K = 0;
  static constexpr int V = K + DKV_BN * D * 2;
  static constexpr int Q = V + DKV_BN * D * 2;
  static constexpr int DO = Q + STAGES * TILE;
  static constexpr int LSE = DO + STAGES * TILE;         // float [STAGES][DKV_BQ], lse * log2(e)
  static constexpr int DI = LSE + STAGES * DKV_BQ * 4;   // float [STAGES][DKV_BQ]
  static constexpr int BARS = DI + STAGES * DKV_BQ * 4;  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + hopper::SW128_ATOM_BYTES;
};

// Row max and row sum over the 4 threads that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Writes a consumer warpgroup's m64n64 accumulator times `mul` as bf16 rows
// [row0, row0 + 64) of out (contiguous [T, 64] of one (b, h)); rows at or
// past T are not written.
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[32], const float (&mul)[2],
                                           int row0, int T) {
  const int t = threadIdx.x % WG_THREADS, lane = t % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * (t / 32) + lane / 4 + 8 * h;
    if (row >= T) continue;
    bf16* dst = out + (long long)row * 64 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul[h], acc[4 * j + 2 * h + 1] * mul[h]);
  }
}

// One block per (b*h, 128-query tile); blockIdx.x is b*h and blockIdx.y
// counts tiles from the last (the longest rows) down, so the longest start
// first. Warpgroup 0 loads Q once and K/V tiles 0..tile into the ring;
// warpgroups 1 and 2 each own 64 query rows.
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int T, float scale_log2) {
  static_assert(D == 64, "one 128-byte swizzle row per tile row: head_dim 64");
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = tile * FWD_BM;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * WG_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, FWD_BM * D * 2);
      hopper::tma_load_4d(sQ, &tq, q_full, 0, q0, h, b);
      for (int j = 0; j <= tile; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
        hopper::tma_load_4d(sK + s * FWD_BN * D, &tk, &full[s], 0, j * FWD_BN, h, b);
        hopper::tma_load_4d(sV + s * FWD_BN * D, &tv, &full[s], 0, j * FWD_BN, h, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG_THREADS, lane = t % 32;
    const int row0 = 64 * (wg - 1);                 // this warpgroup's first row in the tile
    const int r = row0 + 16 * (t / 32) + lane / 4;  // rows r and r + 8 of the tile
    const bf16* sQw = sQ + row0 * D;

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of scale * log2(e) * s
    float l[2] = {0.0f, 0.0f};             // this thread's part of the running sum
    hopper::mbar_wait(q_full, 0);

    for (int j = 0; j <= tile; ++j) {
      const int s = j % STAGES;
      const bf16* sKs = sK + s * FWD_BN * D;
      const bf16* sVs = sV + s * FWD_BN * D;
      hopper::mbar_wait(&full[s], (j / STAGES) & 1);

      float S[64];  // S = Q K^T: 64 rows x 128 keys
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n128k16_ss<0>(S, hopper::desc_k_major(sQw, kk),
                                       hopper::desc_k_major(sKs, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(S);

      if (j == tile) {  // the diagonal tile: key column c is masked past row r
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          if (c > r + 8 * ((i / 2) % 2)) S[i] = -INFINITY;
        }
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          mx = fmaxf(mx, fmaxf(S[4 * jj + 2 * hr], S[4 * jj + 2 * hr + 1]));
        // finite: key 0 of a row's first tile is never masked
        const float m_new = fmaxf(m[hr], quad_max(mx) * scale_log2);
        alpha[hr] = exp2f(m[hr] - m_new);
        m[hr] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int hr = (i / 2) % 2;
        S[i] = exp2f(S[i] * scale_log2 - m[hr]);
        sum[hr] += S[i];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + sum[hr];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i / 2) % 2];

      uint32_t pa[8][4];  // P rounded to bf16, as the A operand of P V
      hopper::a_fragments(S, pa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_BN / 16; ++kk)
        hopper::wgmma_m64n64k16_rs<1>(acc, pa[kk], hopper::desc_mn_major(sVs, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[s]);
    }

    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] = quad_sum(l[hr]);
      inv[hr] = 1.0f / l[hr];
    }
    store_rows(o + (long long)bh * T * D, acc, inv, q0 + row0, T);
    if (lane % 4 == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qi = q0 + r + 8 * hr;
        if (qi < T) lse[(long long)bh * T + qi] = m[hr] * LN2 + logf(l[hr]);
      }
    }
  }
}

// One block per (b*h, 128-key tile); blockIdx.y counts key tiles from the
// first (the most query tiles) up. Warpgroup 0 loads K and V once, then its
// warp 0 streams the Q and dO tiles from the diagonal to T by TMA while its
// warp 1 stages each tile's lse (times log2(e)) and di rows; warpgroups 1
// and 2 each own 64 keys and hold their dK and dV in registers.
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, float scale,
                     float scale_log2) {
  static_assert(D == 64, "one 128-byte swizzle row per tile row: head_dim 64");
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::DO);
  float* sLse = reinterpret_cast<float*>(smem + L::LSE);
  float* sDi = reinterpret_cast<float*>(smem + L::DI);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * DKV_BN;
  const int first = k0 / DKV_BQ;                  // the first query tile: the diagonal
  const int n_tiles = (T + DKV_BQ - 1) / DKV_BQ;  // query tiles first..n_tiles-1
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // the TMA thread and the 32 lanes staging lse, di
      hopper::mbar_init(&empty[s], 2 * WG_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * DKV_BN * D * 2);
      hopper::tma_load_4d(sK, &tk, kv_full, 0, k0, h, b);
      hopper::tma_load_4d(sV, &tv, kv_full, 0, k0, h, b);
      for (int it = first; it < n_tiles; ++it) {
        const int n = it - first, s = n % STAGES;
        hopper::mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
        hopper::tma_load_4d(sQ + s * DKV_BQ * D, &tq, &full[s], 0, it * DKV_BQ, h, b);
        hopper::tma_load_4d(sdO + s * DKV_BQ * D, &tdo, &full[s], 0, it * DKV_BQ, h, b);
      }
    } else if (warp == 1) {
      const float* lse_bh = lse + (long long)bh * T;
      const float* di_bh = di + (long long)bh * T;
      for (int it = first; it < n_tiles; ++it) {
        const int n = it - first, s = n % STAGES;
        hopper::mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
#pragma unroll
        for (int c = lane; c < DKV_BQ; c += 32) {
          const int qi = it * DKV_BQ + c;
          sLse[s * DKV_BQ + c] = qi < T ? lse_bh[qi] * LOG2E : 0.0f;
          sDi[s * DKV_BQ + c] = qi < T ? di_bh[qi] : 0.0f;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG_THREADS, lane = t % 32;
    const int key0 = k0 + 64 * (wg - 1);               // this warpgroup's first key
    const int kr = key0 + 16 * (t / 32) + lane / 4;  // keys kr and kr + 8
    const bf16* sKw = sK + 64 * (wg - 1) * D;
    const bf16* sVw = sV + 64 * (wg - 1) * D;

    float dK[32], dV[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dK[i] = dV[i] = 0.0f;
    hopper::mbar_wait(kv_full, 0);

    for (int it = first; it < n_tiles; ++it) {
      const int n = it - first, s = n % STAGES;
      hopper::mbar_wait(&full[s], (n / STAGES) & 1);
      if (it * DKV_BQ + DKV_BQ <= key0) {  // every query of the tile precedes these keys
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
      const bf16* sQs = sQ + s * DKV_BQ * D;
      const bf16* sdOs = sdO + s * DKV_BQ * D;
      const float* lse_s = sLse + s * DKV_BQ;
      const float* di_s = sDi + s * DKV_BQ;

      float St[32], dPt[32];  // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16_ss<0>(St, hopper::desc_k_major(sKw, kk),
                                      hopper::desc_k_major(sQs, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16_ss<0>(dPt, hopper::desc_k_major(sVw, kk),
                                      hopper::desc_k_major(sdOs, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(St);
      hopper::fence_regs(dPt);

      // P^T = exp(s^T - lse) under the causal mask, dS^T = P^T (dP^T - di)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int qi = it * DKV_BQ + c, kj = kr + 8 * ((i / 2) % 2);
        const float p = (qi < T && kj <= qi) ? exp2f(St[i] * scale_log2 - lse_s[c]) : 0.0f;
        St[i] = p;
        dPt[i] = p * (dPt[i] - di_s[c]);
      }
      uint32_t pa[4][4], dsa[4][4];
      hopper::a_fragments(St, pa);
      hopper::a_fragments(dPt, dsa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        hopper::wgmma_m64n64k16_rs<1>(dV, pa[kk], hopper::desc_mn_major(sdOs, kk), 1);
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        hopper::wgmma_m64n64k16_rs<1>(dK, dsa[kk], hopper::desc_mn_major(sQs, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dV);
      hopper::fence_regs(dK);
      hopper::mbar_arrive(&empty[s]);
    }

    const long long base = (long long)bh * T * D;
    const float k_mul[2] = {scale, scale}, v_mul[2] = {1.0f, 1.0f};
    store_rows(dk + base, dK, k_mul, key0, T);
    store_rows(dv + base, dV, v_mul, key0, T);
  }
}

// ----------------------------------------------------- dQ (first design, wmma)

constexpr int BM = 64;         // query rows per tile
constexpr int BN = 64;         // key rows per tile
constexpr int THREADS = 128;   // 4 warps; warp w owns tile rows [16w, 16w+16)
constexpr int LDF = 64 + 4;    // float row stride of a 64-column score tile
constexpr int LDP = 64 + 8;    // bf16 row stride of a 64-column probability tile

static_assert(BM == BN, "the diagonal tile is square");
static_assert(BM == 16 * (THREADS / 32), "one 16-row wmma strip per warp");

template <int D>
__host__ __device__ constexpr int ld_tile() { return D + 8; }  // bf16 row stride of a [64, D] tile

struct Strides {
  long long b, h, t;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Rows [row0, row0 + 64) of one (b, h) slice into shared memory, 16 bytes a
// thread; rows at or past T are zero.
template <int D>
__device__ void load_tile(bf16* dst, const bf16* src, long long stride_t, int row0, int T) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride_t + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld_tile<D>() + c * 8) = val;
  }
}

// out[16 x N] (float, stride LDF) = a[16 x K] . b^T, for this warp's strip;
// b is a row-major [N, K] tile.
template <int K, int N>
__device__ void strip_product(float* out, const bf16* a, int lda, const bf16* b, int ldb) {
  static_assert(N <= LDF, "the output strip fits a score tile row");
#pragma unroll
  for (int nf = 0; nf < N / 16; ++nf) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      wmma::load_matrix_sync(fb, b + nf * 16 * ldb + kk * 16, ldb);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + nf * 16, c, LDF, wmma::mem_row_major);
  }
}

// acc[D/16] += a[16 x 64] . b[64 x D] (b row-major), for this warp's strip.
template <int D>
__device__ void strip_accumulate(FragC* acc, const bf16* a, const bf16* b) {
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDP);
      wmma::load_matrix_sync(fb, b + kk * 16 * ld_tile<D>() + nf * 16, ld_tile<D>());
      wmma::mma_sync(acc[nf], fa, fb, acc[nf]);
    }
  }
}

// Writes this warp's strip of acc, times `mul`, as bf16 rows of out
// (contiguous [T, D] of one (b, h)); `scratch` is the warp's float strip.
template <int D>
__device__ void store_strip(bf16* out, const FragC* acc, float* scratch, float mul,
                            int row0, int T) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf)
    wmma::store_matrix_sync(scratch + nf * 16, acc[nf], LDF, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, half = lane & 1;
  const int row = row0 + warp * 16 + r;
  if (row < T) {
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      out[(long long)row * D + half * (D / 2) + c] =
          __float2bfloat16(scratch[r * LDF + half * (D / 2) + c] * mul);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    bf16* __restrict__ dq, int H, int T,
                    Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  constexpr int LD = ld_tile<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BM * LD;
  bf16* sK = sdO + BM * LD;
  bf16* sV = sK + BN * LD;
  float* sS = reinterpret_cast<float*>(sV + BN * LD);  // S, queries x keys
  float* sdP = sS + BM * LDF;
  bf16* sdS = reinterpret_cast<bf16*>(sdP + BM * LDF);
  float* sLse = reinterpret_cast<float*>(sdS + BM * LDP);
  float* sDi = sLse + BM;

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = tile * BM;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row = tid >> 1, half = tid & 1;
  const int qi = q0 + row;
  float* wS = sS + warp * 16 * LDF;
  float* wdP = sdP + warp * 16 * LDF;

  load_tile<D>(sQ, q + b * sq.b + h * sq.h, sq.t, q0, T);
  load_tile<D>(sdO, dout + b * sdo.b + h * sdo.h, sdo.t, q0, T);
  if (tid < BM) {
    sLse[tid] = q0 + tid < T ? lse[(long long)bh * T + q0 + tid] : 0.0f;
    sDi[tid] = q0 + tid < T ? di[(long long)bh * T + q0 + tid] : 0.0f;
  }
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  FragC dq_acc[D / 16];
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf) wmma::fill_fragment(dq_acc[nf], 0.0f);

  for (int j = 0; j <= tile; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_tile<D>(sK, kb, sk.t, k0, T);
    load_tile<D>(sV, vb, sv.t, k0, T);
    __syncthreads();

    strip_product<D, BN>(wS, sQ + warp * 16 * LD, LD, sK, LD);    // S = Q K^T
    strip_product<D, BN>(wdP, sdO + warp * 16 * LD, LD, sV, LD);  // dP = dO V^T
    __syncwarp();
    const float lse_r = sLse[row], di_r = sDi[row];
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      const int col = half * (BN / 2) + c, kj = k0 + col;
      float p = 0.0f;
      if (qi < T && kj <= qi) p = expf(sS[row * LDF + col] * scale - lse_r);
      sdS[row * LDP + col] = __float2bfloat16(p * (sdP[row * LDF + col] - di_r));
    }
    __syncwarp();
    strip_accumulate<D>(dq_acc, sdS + warp * 16 * LDP, sK);  // dQ += dS K
  }

  store_strip<D>(dq + (long long)bh * T * D, dq_acc, wS, scale, q0, T);
}

template <int D>
constexpr size_t bwd_smem() {
  return (size_t)(2 * BM + 2 * BN) * ld_tile<D>() * 2 + (size_t)2 * 64 * LDF * 4 +
         (size_t)2 * 64 * LDP * 2 + (size_t)2 * BM * 4;
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// strides: q then k then v (batch, head, time), in elements.
int flash_attention_fwd_bf16_hd64(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int H, int T, const long long* strides,
                                  float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  const void* ops[3] = {q, k, v};
  const int rows[3] = {FWD_BM, FWD_BN, FWD_BN};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = hopper::encode_bhtd(&maps[i], ops[i], B, H, T, 64, strides[3 * i], strides[3 * i + 1],
                              strides[3 * i + 2], rows[i]);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdSmem<64>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + FWD_BM - 1) / FWD_BM);
  flash_fwd_kernel<64><<<grid, HOPPER_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), static_cast<float*>(lse), H, T,
      scale * LOG2E);
  return cudaGetLastError();
}

// strides: q, k, v, do (batch, head, time), in elements.
int flash_attention_bwd_dkv_bf16_hd64(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* di,
                                      void* dk, void* dv, int B, int H, int T,
                                      const long long* strides, float scale, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const void* ops[4] = {q, k, v, dout};
  const int rows[4] = {DKV_BQ, DKV_BN, DKV_BN, DKV_BQ};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = hopper::encode_bhtd(&maps[i], ops[i], B, H, T, 64, strides[3 * i], strides[3 * i + 1],
                              strides[3 * i + 2], rows[i]);
  if (err != cudaSuccess) return err;
  constexpr int smem = DkvSmem<64>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + DKV_BN - 1) / DKV_BN);
  flash_bwd_dkv_kernel<64><<<grid, HOPPER_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, scale,
      scale * LOG2E);
  return cudaGetLastError();
}

int flash_attention_bwd_dq_bf16_hd64(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* di,
                                     void* dq, int B, int H, int T, const long long* strides,
                                     float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = bwd_smem<64>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<64><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dq), H, T, strides_at(strides, 0),
      strides_at(strides, 1), strides_at(strides, 2), strides_at(strides, 3), scale);
  return cudaGetLastError();
}

}  // extern "C"
