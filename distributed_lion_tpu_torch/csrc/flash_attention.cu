// Causal flash attention for NVIDIA Hopper: forward, dK/dV, dQ, and the
// backward's di = sum(o * do).
//
// Replaces jax's bundled Pallas TPU kernel that the JAX package reaches
// through distributed_lion_tpu/ops/attention.py:70 (attention_flash):
//   jax/experimental/pallas/ops/tpu/flash_attention.py
//     forward  pallas_call :758 in _flash_attention_impl :589
//     dK/dV    pallas_call :1121 in _flash_attention_bwd_dkv :941
//     dQ       pallas_call :1456 in _flash_attention_bwd_dq :1287
// jax computes di in jnp between its pallas_calls (:273); here it is a
// kernel of its own (flash_di_kernel), the one the backward kernels read.
//
// Layout: q, k, v and do are [B, H, T, D] bf16 tensors taken through their
// batch, head and time strides (head_dim contiguous), so the model's
// transposed views of its qkv projection need no copy; di reads o the same
// way. o, dq, dk, dv are written contiguous [B, H, T, D] bf16; lse and di
// are contiguous [B, H, T] float32. Scores are s = scale * q.k; lse = m +
// log(sum exp(s - m)).
//
// Bound: at GPT-2 124M's shape (B 8, H 12, T 1024, D 64) the forward moves
// 50.7 MB and does 12.9 GFLOP of causal products, so on an H100 SXM it is
// bytes-bound (0.015 ms) and the backward is operations-bound; the same holds
// at Llama-2-7B's (B 4, H 32, T 1024, D 128): 134 MB and 34.4 GFLOP forward.
// di is bytes-bound: it reads o and do once (67 MB at Llama-2-7B's shape).
//
// The three attention kernels (Hopper design, hopper.cuh): one block of three
// warpgroups. Warpgroup 0 is the producer: one thread issues TMA loads of
// the tiles (128-byte swizzle, rows past T zero-filled) into a ring of
// buffers, each with a full and an empty mbarrier, and the warpgroup gives
// its registers to the consumers (setmaxnreg). Warpgroups 1 and 2 are
// consumers of 64 rows each: their products are wgmma (bf16, float32 sums
// in registers). One block per SM (registers bound it); the ring and the
// asynchronous wgmma hide the latency that resident blocks hid before.
// - forward: a block per 128 queries walks key tiles of 128 up to the
//   diagonal (the only masked tile) with an online softmax in the exp2
//   domain; the row max and sum are shared by the 4 threads of a row by
//   shuffles. o = O / l, lse = m + log(l) in natural log. P is the A operand
//   of P.V from registers (the accumulator rounded to bf16 in its own
//   layout), V read MN-major. A consumer follows FlashAttention-3's
//   intra-warpgroup order (fwd_consume_overlapped): the next tile's S =
//   Q.K^T is issued with this tile's P.V, and its softmax runs under P.V;
//   K and V go through rings of their own, K a tile ahead, and the blocks
//   go out in groups of 16 heads, longest tiles first.
// - dK/dV: a block per 128 keys holds K and V in shared memory and streams
//   query tiles of 64 (with their lse and di) from the diagonal to T;
//   P^T = exp(s^T - lse) and dS^T = P^T (dP^T - di), then dV += P^T.dO and
//   dK += dS^T.Q. At head_dim 64 a consumer runs each tile in series, P^T and
//   dS^T as register A fragments. At 128 its dK and dV take 128 registers a
//   thread, so P^T and dS^T go to two bf16 tiles in shared memory that its
//   threads write and dV/dK read as SS products; the next tile's S^T/dP^T
//   are issued before this tile's dV/dK, which run under the next tile's
//   exponentials (dkv_consume_overlapped).
// - dQ: a block per 128 queries holds Q and dO in shared memory and streams
//   K and V tiles of 64 from 0 to the diagonal; S = Q.K^T and dP = dO.V^T,
//   P = exp2(s - lse) and dS = P (dP - di), then dQ += dS.K with dS as
//   register A fragments and the same K tile read MN-major. A consumer skips
//   a key tile wholly above its rows' diagonal. At head_dim 64 each tile runs
//   in series; at 128 the next tile's S/dP are issued with this tile's dQ
//   product and their exponentials run under it (dq_consume_overlapped).
// - di: D / 8 threads a row, 16 bytes of o and of do each, summed in a fixed
//   order (flash_di_kernel).
//
// The forward's consumer, and the backward's at head_dim 128, are shaped for
// ptxas (CUDA 12.9), which serializes every wgmma of a kernel (a wait after
// each) when it cannot prove a register operand untouched while a group is
// in flight:
// the loops are peeled so each pass issues and waits for the same groups,
// the warpgroup index comes through a shuffle so descriptors are uniform,
// fragments are written only while nothing is in flight, and the consumers
// wait on mbarriers without the trap path (hopper::mbar_wait_spin), whose
// presence held the backward kernels to the launch bound's 168 registers
// (and made the forward's spill). The hd 128 backward's grid is tile-major:
// at this width a head's Q/dO (or K/V) tiles no longer fit L2 across the
// heads a head-major grid keeps resident.
//
// Every output element is summed by one block in a fixed order: no atomics,
// and the results are the same bits from run to run. P and dS are rounded to
// bf16 before their products, as the plain versions round them. Causal
// masking is applied on the diagonal tiles, rows past T load as zeros and
// are never written. head_dim is a template parameter, instantiated at 64
// (GPT-2) and 128 (Llama). At 128 a tile row is two 128-byte swizzle rows:
// each tile is loaded as two TMA boxes of 64 columns into two column blocks
// (hopper.cuh), and the products step across both. The forward and the
// head_dim 128 backward compute exp2 by ex2.approx.ftz, with the diagonal
// mask as a select (in the forward, under a branch on the diagonal tile):
// an exponent below -126 gives 0 where exp2f keeps a denormal, a change to
// P (and to the forward's running sum) of less than 2^-126.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

using bf16 = __nv_bfloat16;

namespace {

// ------------------------------------------------- forward and dK/dV (Hopper)

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG_THREADS = 128;
constexpr int HOPPER_THREADS = 3 * WG_THREADS;  // a producer and two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536

// Forward tiles: 128 queries per block (64 per consumer warpgroup), key
// tiles of 128, so the diagonal is one tile.
constexpr int FWD_BM = 128;
constexpr int FWD_BN = 128;

// Bytes between the 64-column blocks of a tile of `rows` rows.
__host__ __device__ constexpr uint32_t block_bytes(int rows) {
  return rows * hopper::SW_COLS * 2;
}

// LBO of an MN-major operand of `rows` rows whose N is the head_dim: the
// column-block stride at head_dim 128, unused (hopper::MN_LBO) at 64.
template <int D>
__host__ __device__ constexpr uint32_t mn_lbo(int rows) {
  return D == 64 ? hopper::MN_LBO : block_bytes(rows);
}

// Two rings of two stages, one of K tiles and one of V tiles, each stage
// behind a full and an empty barrier: the consumers hold a K tile from its
// S to the next tile's S, and a V tile one tile longer, to its P.V
// (fwd_consume_overlapped), so K's stage is released first and the
// producer loads K tile j + 1 ahead of V tile j.
template <int D>
struct FwdSmem {  // byte offsets from a 1024-byte boundary
  static constexpr int STAGES = 2;
  static constexpr int TILE = FWD_BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + FWD_BM * D * 2;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BARS = V + STAGES * TILE;  // q_full, full[K, V][], empty[K, V][]
  static constexpr int BYTES = BARS + (1 + 4 * STAGES) * 8 + hopper::SW128_ATOM_BYTES;
};

// dK/dV tiles: 128 keys per block (64 per consumer warpgroup), query tiles
// of 64 streamed through the ring with their lse and di rows. At head_dim
// 128 the ring has three stages, and each consumer has two bf16 64 x 64
// tiles of its own (P^T and dS^T) that its threads write and its wgmma read.
constexpr int DKV_BN = 128;

template <int D>
struct DkvSmem {
  static constexpr int BQ = 64;
  static constexpr int STAGES = D == 64 ? 2 : 3;
  static constexpr int TILE = BQ * D * 2;
  static constexpr int PT_TILE = 64 * BQ * 2;        // one consumer's P^T or dS^T, bf16
  static constexpr int K = 0;
  static constexpr int V = K + DKV_BN * D * 2;
  static constexpr int Q = V + DKV_BN * D * 2;
  static constexpr int DO = Q + STAGES * TILE;
  static constexpr int PT = DO + STAGES * TILE;      // [consumer][P^T, dS^T], head_dim 128
  static constexpr int LSE = PT + (D == 64 ? 0 : 2 * 2 * PT_TILE);  // float [STAGES][BQ]
  static constexpr int DI = LSE + STAGES * BQ * 4;   // float [STAGES][BQ]
  static constexpr int BARS = DI + STAGES * BQ * 4;  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + hopper::SW128_ATOM_BYTES;
};

// The attention kernels' grid: a block per (b*h, tile). At head_dim 64 b*h
// is blockIdx.x, so the resident blocks span many heads, and a head's K/V
// (or Q/dO) tiles, which every block of that head re-reads, fit L2 at
// GPT-2's shape all the same. At 128 (Llama-2-7B: 67 MB of K and V, or of Q
// and dO) they do not, so the tile is blockIdx.x: the blocks of one head
// run side by side and read its tiles from L2, and the few heads resident
// at once fit it. The forward goes one step further (fwd_head_group):
// groups of FWD_HEAD_GROUP heads, and within a group every head's longest
// tile first, then the next longest, so the last blocks to start are short
// ones while a group's K/V (8 MB at head_dim 128) stays in L2.
template <int D>
__host__ __device__ constexpr bool tile_major() { return D == 128; }
template <int D>
dim3 block_grid(int bh, int tiles) {
  return tile_major<D>() ? dim3(tiles, bh) : dim3(bh, tiles);
}
// (unsigned, as blockIdx is, so that the arithmetic on them stays unsigned)
template <int D>
__device__ __forceinline__ unsigned grid_bh() {
  return tile_major<D>() ? blockIdx.y : blockIdx.x;
}
template <int D>
__device__ __forceinline__ unsigned grid_tile() {
  return tile_major<D>() ? blockIdx.x : blockIdx.y;
}
template <int D>
__device__ __forceinline__ unsigned grid_tiles() {
  return tile_major<D>() ? gridDim.x : gridDim.y;
}

constexpr int FWD_HEAD_GROUP = 16;

// The forward's heads a group: the largest power of two up to
// FWD_HEAD_GROUP that divides b*h.
inline int fwd_head_group(int bh) {
  int group = 1;
  while (group * 2 <= FWD_HEAD_GROUP && bh % (group * 2) == 0) group *= 2;
  return group;
}

// Row max and row sum over the 4 threads that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Writes a consumer warpgroup's m64nD accumulator times `mul` as bf16 rows
// [row0, row0 + 64) of out (contiguous [T, D] of one (b, h)); rows at or
// past T are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           const float (&mul)[2], int row0, int T) {
  const int t = threadIdx.x % WG_THREADS, lane = t % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * (t / 32) + lane / 4 + 8 * h;
    if (row >= T) continue;
    bf16* dst = out + (long long)row * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul[h], acc[4 * j + 2 * h + 1] * mul[h]);
  }
}

// Tile j's P = exp2(s * scale * log2(e) - m) in place of its scores S (a
// consumer's 64 rows x 128 keys): on the diagonal tile (`diag`, the same
// for the whole warpgroup) the causal mask (key column c kept where c <=
// row r of the tile, r + 8 for the thread's second row), then the running
// max m and sum l updated, and alpha the factor for the O summed so far.
// exp2 by ex2.approx.ftz.
__device__ __forceinline__ void fwd_softmax_ftz(float (&S)[64], float (&m)[2], float (&l)[2],
                                                float (&alpha)[2], bool diag, int r, int lane,
                                                float scale_log2) {
  if (diag) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      S[i] = c <= r + 8 * ((i / 2) % 2) ? S[i] : -INFINITY;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      mx = fmaxf(mx, fmaxf(S[4 * jj + 2 * hr], S[4 * jj + 2 * hr + 1]));
    // finite: key 0 of a row's first tile is never masked
    const float m_new = fmaxf(m[hr], quad_max(mx) * scale_log2);
    alpha[hr] = hopper::exp2_ftz(m[hr] - m_new);
    m[hr] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int hr = (i / 2) % 2;
    S[i] = hopper::exp2_ftz(S[i] * scale_log2 - m[hr]);
    sum[hr] += S[i];
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + sum[hr];
}

// o = O / l and lse = m + log(l) (natural log) of a consumer's 64 rows from
// row0 of the tile at q0, l summed over the 4 threads of each row; rows at
// or past T are not written. m * ln 2 is rounded before the add
// (__fmul_rn, never fused), so lse's bits do not hang on whether the
// compiler fuses the two.
template <int D>
__device__ __forceinline__ void fwd_store(bf16* o, float* lse, const float (&acc)[D / 2],
                                          const float (&m)[2], float (&l)[2], int q0, int row0,
                                          int r, int lane, int T) {
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    inv[hr] = 1.0f / l[hr];
  }
  store_rows<D>(o, acc, inv, q0 + row0, T);
  if (lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + r + 8 * hr;
      if (qi < T) lse[qi] = __fmul_rn(m[hr], LN2) + logf(l[hr]);  // no fused multiply-add
    }
  }
}

// The consumer of flash_fwd_kernel: 64 query rows, O (D / 2 floats a
// thread) in registers over key tiles 0..tile, in
// FlashAttention-3's intra-warpgroup order: with tile j's P already bf16 A
// fragments and no wgmma in flight, issue tile j + 1's S = Q K^T, then O +=
// P V of tile j; wait for S alone (wgmma groups complete in order), release
// K tile j + 1 and run its max, exponentials and sums while the P V group
// runs; then wait for it, release V tile j, rescale O by tile j + 1's alpha
// and repack. So the tensor cores have the next product queued while the
// softmax runs, the fragments are written only while no group is in
// flight, and O is rescaled in the same order as a consumer that runs each
// tile in series would rescale it (the same bits). The first tile's scores
// and the last tile's P V are peeled, so every pass issues and waits for
// the same groups.
template <int D>
__device__ __forceinline__ void fwd_consume_overlapped(const bf16* sQ, const bf16* sK,
                                                       const bf16* sV, uint64_t* q_full,
                                                       uint64_t* full, uint64_t* empty, bf16* o,
                                                       float* lse, int tile, int T,
                                                       float scale_log2) {
  using L = FwdSmem<D>;
  constexpr int STAGES = L::STAGES;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  const int t = threadIdx.x % WG_THREADS, lane = t % 32;
  const int row0 = 64 * (wg - 1);                 // this warpgroup's first row in the tile
  const int r = row0 + 16 * (t / 32) + lane / 4;  // rows r and r + 8 of the tile
  // first k-step descriptors: this warpgroup's Q rows, and stage 0's K
  // (K-major) and V (MN-major) tiles; a stage is L::TILE bytes further on
  const uint64_t dQ0 = hopper::desc_k_major(sQ + row0 * hopper::SW_COLS, 0, 0);
  const uint64_t dK0 = hopper::desc_k_major(sK, 0, 0);
  const uint64_t dV0 = hopper::desc_mn_major(sV, 0, mn_lbo<D>(FWD_BN));

  float acc[D / 2], S[64];
  float m[2] = {-INFINITY, -INFINITY};  // running max of scale * log2(e) * s
  float l[2] = {0.0f, 0.0f};             // this thread's part of the running sum
  float alpha[2];
  uint32_t pa[FWD_BN / 16][4];  // P rounded to bf16, as the A operand of P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  hopper::mbar_wait_spin(q_full, 0);

  uint64_t* v_full = full + STAGES;  // V's barriers after K's
  uint64_t* v_empty = empty + STAGES;
  auto scores = [&](int j) {  // issue S = Q K^T of key tile j
    const int s = j % STAGES;
    const uint64_t dK = hopper::desc_advance(dK0, s * L::TILE);
    hopper::mbar_wait_spin(&full[s], (j / STAGES) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n128k16_ss<0>(S, hopper::desc_k_step(dQ0, kk, block_bytes(FWD_BM)),
                                     hopper::desc_k_step(dK, kk, block_bytes(FWD_BN)), kk > 0);
    hopper::wgmma_commit();
  };
  auto probs = [&](int j) {  // tile j's P from its finished scores
    hopper::fence_regs(S);
    fwd_softmax_ftz(S, m, l, alpha, j == tile, r, lane, scale_log2);
  };
  auto values = [&](int j) {  // issue O += P V of key tile j
    const uint64_t dV = hopper::desc_advance(dV0, (j % STAGES) * L::TILE);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_BN / 16; ++kk)
      hopper::wgmma_rs_mn<D>(acc, pa[kk], hopper::desc_mn_step(dV, kk));
    hopper::wgmma_commit();
  };

  scores(0);
  hopper::wgmma_wait<0>();
  hopper::mbar_arrive(&empty[0]);
  probs(0);  // O is 0: no rescale
  hopper::a_fragments(S, pa);
  for (int j = 0; j < tile; ++j) {
    hopper::mbar_wait_spin(&v_full[j % STAGES], (j / STAGES) & 1);
    scores(j + 1);
    values(j);
    hopper::wgmma_wait<1>();  // tile j + 1's scores; tile j's P V runs on
    hopper::mbar_arrive(&empty[(j + 1) % STAGES]);
    probs(j + 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&v_empty[j % STAGES]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    hopper::a_fragments(S, pa);
  }
  hopper::mbar_wait_spin(&v_full[tile % STAGES], (tile / STAGES) & 1);
  values(tile);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::mbar_arrive(&v_empty[tile % STAGES]);
  fwd_store<D>(o, lse, acc, m, l, tile * FWD_BM, row0, r, lane, T);
}

// One block per (b*h, 128-query tile), in groups of heads
// (fwd_head_group): blockIdx.x is a tile's rank (longest first) times the
// group plus the head in it, blockIdx.y the group. Warpgroup 0 loads Q once,
// and K tiles 0..tile and V tiles 0..tile each into its own ring, K a tile
// ahead; warpgroups 1 and 2 each own 64 query rows (fwd_consume_overlapped).
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int T, float scale_log2) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = FwdSmem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;         // K's ring, then V's
  uint64_t* empty = full + 2 * STAGES;

  // ptxas (CUDA 12.9) lays this kernel out differently for edits that change
  // nothing: passing tile * FWD_BM to the Q load in place of q0 ran it 10%
  // slower at head_dim 128, the same bits. Time any edit (probes/).
  const int tiles = (T + FWD_BM - 1) / FWD_BM, group = gridDim.x / tiles;
  const int bh = blockIdx.y * group + blockIdx.x % group, b = bh / H, h = bh % H;
  const int tile = tiles - 1 - blockIdx.x / group, q0 = tile * FWD_BM;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < 2 * STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * WG_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      auto load = [&](int j, int ring) {  // K (ring 0) or V (ring 1) tile j
        const int s = j % STAGES, n = ring * STAGES + s;
        hopper::mbar_wait(&empty[n], ((j / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[n], L::TILE);
        hopper::tma_load_rows<D>((ring ? sV : sK) + s * FWD_BN * D, ring ? &tv : &tk, &full[n],
                                 FWD_BN, j * FWD_BN, h, b);
      };
      hopper::mbar_arrive_expect_tx(q_full, FWD_BM * D * 2);
      hopper::tma_load_rows<D>(sQ, &tq, q_full, FWD_BM, q0, h, b);
      load(0, 0);
      for (int j = 0; j <= tile; ++j) {
        if (j < tile) load(j + 1, 0);
        load(j, 1);
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    fwd_consume_overlapped<D>(sQ, sK, sV, q_full, full, empty, o + (long long)bh * T * D,
                              lse + (long long)bh * T, tile, T, scale_log2);
  }
}

// S^T = K Q^T and dP^T = V dO^T of one query tile for a consumer's 64 keys
// (m64n64k16, both operands K-major in shared memory, 8 k-steps across the
// two column blocks at head_dim 128), issued as one wgmma group; the
// arguments are the tiles' first k-step descriptors.
template <int D>
__device__ __forceinline__ void issue_dkv_scores(float (&St)[32], float (&dPt)[32], uint64_t dK0,
                                                 uint64_t dV0, uint64_t dQ0, uint64_t dO0) {
  using L = DkvSmem<D>;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_m64n64k16_ss<0>(St, hopper::desc_k_step(dK0, kk, block_bytes(DKV_BN)),
                                  hopper::desc_k_step(dQ0, kk, block_bytes(L::BQ)), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_m64n64k16_ss<0>(dPt, hopper::desc_k_step(dV0, kk, block_bytes(DKV_BN)),
                                  hopper::desc_k_step(dO0, kk, block_bytes(L::BQ)), kk > 0);
  hopper::wgmma_commit();
}

// The head_dim 128 consumer of flash_bwd_dkv_kernel: one warpgroup, 64 keys
// from key0, dK and dV (64 floats a thread each) in registers for the whole
// walk over query tiles first..n_tiles-1 (stage of tile it: (it - first)
// % STAGES). Per tile: S^T and dP^T into registers (one wgmma group); P^T =
// exp2(s^T - lse) and dS^T = P^T (dP^T - di) in place; both rounded to bf16
// into the consumer's two swizzled tiles (store_sw128_tile, then the proxy
// fence and a named barrier of its 128 threads); then dV += P^T dO and dK +=
// dS^T Q as SS products from those tiles (A K-major, B the stage's dO and Q
// read MN-major), so no A fragment stays in registers beside the 128
// accumulators. Overlap: the next tile's S^T/dP^T group is issued before
// this tile's dV/dK group, and the wait at the top of the next tile lets the
// dV/dK group run under its exponentials (wgmma groups complete in order).
template <int D>
__device__ __forceinline__ void dkv_consume_overlapped(
    const bf16* sK, const bf16* sV, const bf16* sQ, const bf16* sdO, bf16* sPt,
    const float* sLse, const float* sDi, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    bf16* dk, bf16* dv, int first, int n_tiles, int k0, int T, float scale, float scale_log2) {
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  const int t = threadIdx.x % WG_THREADS, lane = t % 32;
  const int k_off = 64 * (wg - 1);                 // this warpgroup's rows of the K, V tiles
  const int key0 = k0 + k_off;                     // its first key
  const int kr = key0 + 16 * (t / 32) + lane / 4;  // keys kr and kr + 8
  sPt += (wg - 1) * 2 * 64 * BQ;                   // its P^T tile, then its dS^T tile
  bf16* sdSt = sPt + 64 * BQ;
  // first k-step descriptors: this warpgroup's K and V rows, its P^T and
  // dS^T tiles, and stage 0's Q and dO tiles (K-major, and dO, Q MN-major);
  // a stage is L::TILE bytes further on
  const uint64_t dK0 = hopper::desc_k_major(sK + k_off * hopper::SW_COLS, 0, 0);
  const uint64_t dV0 = hopper::desc_k_major(sV + k_off * hopper::SW_COLS, 0, 0);
  const uint64_t dPt0 = hopper::desc_k_major(sPt, 0, 0), dSt0 = hopper::desc_k_major(sdSt, 0, 0);
  const uint64_t dQk0 = hopper::desc_k_major(sQ, 0, 0), dOk0 = hopper::desc_k_major(sdO, 0, 0);
  const uint64_t dQm0 = hopper::desc_mn_major(sQ, 0, block_bytes(BQ));
  const uint64_t dOm0 = hopper::desc_mn_major(sdO, 0, block_bytes(BQ));

  float dK[D / 2], dV[D / 2], St[32], dPt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dK[i] = dV[i] = 0.0f;
  hopper::mbar_wait_spin(kv_full, 0);

  // query tiles wholly before these keys: released unread
  const int mine = key0 / BQ;
  for (int it = first; it < min(mine, n_tiles); ++it) {
    const int n = it - first, s = n % STAGES;
    hopper::mbar_wait_spin(&full[s], (n / STAGES) & 1);
    hopper::mbar_arrive(&empty[s]);
  }
  auto scores = [&](int it) {  // issue tile it's S^T and dP^T
    const int n = it - first, s = n % STAGES;
    hopper::mbar_wait_spin(&full[s], (n / STAGES) & 1);
    issue_dkv_scores<D>(St, dPt, dK0, dV0, hopper::desc_advance(dQk0, s * L::TILE),
                        hopper::desc_advance(dOk0, s * L::TILE));
  };
  // tile it's P^T and dS^T from its finished scores into the two bf16
  // tiles, once the previous tile's dV/dK group (which reads them) is done
  auto probs = [&](int it) {
    hopper::fence_regs(St);
    hopper::fence_regs(dPt);
    const int n = it - first, s = n % STAGES;
    const float* lse_s = sLse + s * BQ;
    const float* di_s = sDi + s * BQ;
    // kept: query columns c with lo[h] <= c < hi (the diagonal, and T)
    const bool edge = it * BQ < key0 + 64 || it * BQ + BQ > T;
    const int hi = edge ? T - it * BQ : BQ;
    const int lo[2] = {edge ? kr - it * BQ : 0, edge ? kr + 8 - it * BQ : 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 d2 = *reinterpret_cast<const float2*>(di_s + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = hopper::exp2_ftz(St[i] * scale_log2 - (e ? l2.y : l2.x));
          St[i] = c + e >= lo[h] && c + e < hi ? p : 0.0f;
          dPt[i] = St[i] * (dPt[i] - (e ? d2.y : d2.x));
        }
      }
    }
    hopper::wgmma_wait<0>();
    if (it > mine) hopper::mbar_arrive(&empty[(n - 1) % STAGES]);
    hopper::store_sw128_tile(sPt, St);
    hopper::store_sw128_tile(sdSt, dPt);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(wg, WG_THREADS);
  };
  auto grads = [&](int it) {  // issue dV += P^T dO and dK += dS^T Q of tile it
    const uint32_t stage = ((it - first) % STAGES) * L::TILE;
    const uint64_t dOm = hopper::desc_advance(dOm0, stage), dQm = hopper::desc_advance(dQm0, stage);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_m64n128k16_ss<1>(dV, hopper::desc_k_step(dPt0, kk, 0),
                                     hopper::desc_mn_step(dOm, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_m64n128k16_ss<1>(dK, hopper::desc_k_step(dSt0, kk, 0),
                                     hopper::desc_mn_step(dQm, kk), 1);
    hopper::wgmma_commit();
  };
  if (mine < n_tiles) {
    // the loop is peeled so that every pass issues and waits for the same
    // groups: its exponentials run under the previous tile's dV/dK group
    scores(mine);
    hopper::wgmma_wait<0>();
    for (int it = mine; it < n_tiles - 1; ++it) {
      probs(it);
      scores(it + 1);
      grads(it);
      hopper::wgmma_wait<1>();  // tile it + 1's scores; tile it's dV/dK group runs on
    }
    probs(n_tiles - 1);
    grads(n_tiles - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dV);
    hopper::fence_regs(dK);
    hopper::mbar_arrive(&empty[(n_tiles - 1 - first) % STAGES]);
  }

  const float k_mul[2] = {scale, scale}, v_mul[2] = {1.0f, 1.0f};
  store_rows<D>(dk, dK, k_mul, key0, T);
  store_rows<D>(dv, dV, v_mul, key0, T);
}

// One block per (b*h, 128-key tile), laid out by block_grid; key tiles count
// from the first (the most query tiles) up. Warpgroup 0 loads K and V once,
// then its warp 0 streams the Q and dO tiles from the diagonal to T by TMA
// while its warp 1 stages each tile's lse (times log2(e)) and di rows;
// warpgroups 1 and 2 each own 64 keys and hold their dK and dV in
// registers. At head_dim 64 a consumer runs each tile in series with P^T
// and dS^T as register A fragments; at 128, dkv_consume_overlapped.
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, float scale,
                     float scale_log2) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
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

  const int bh = grid_bh<D>(), b = bh / H, h = bh % H;
  const int k0 = grid_tile<D>() * DKV_BN;
  const int first = k0 / BQ;              // the first query tile: the diagonal
  const int n_tiles = (T + BQ - 1) / BQ;  // query tiles first..n_tiles-1
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
      hopper::tma_load_rows<D>(sK, &tk, kv_full, DKV_BN, k0, h, b);
      hopper::tma_load_rows<D>(sV, &tv, kv_full, DKV_BN, k0, h, b);
      for (int it = first; it < n_tiles; ++it) {
        const int n = it - first, s = n % STAGES;
        hopper::mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
        hopper::tma_load_rows<D>(sQ + s * BQ * D, &tq, &full[s], BQ, it * BQ, h, b);
        hopper::tma_load_rows<D>(sdO + s * BQ * D, &tdo, &full[s], BQ, it * BQ, h, b);
      }
    } else if (warp == 1) {
      const float* lse_bh = lse + (long long)bh * T;
      const float* di_bh = di + (long long)bh * T;
      for (int it = first; it < n_tiles; ++it) {
        const int n = it - first, s = n % STAGES;
        hopper::mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
#pragma unroll
        for (int c = lane; c < BQ; c += 32) {
          const int qi = it * BQ + c;
          sLse[s * BQ + c] = qi < T ? lse_bh[qi] * LOG2E : 0.0f;
          sDi[s * BQ + c] = qi < T ? di_bh[qi] : 0.0f;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else if constexpr (D == 128) {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const long long base = (long long)bh * T * D;
    dkv_consume_overlapped<D>(sK, sV, sQ, sdO, reinterpret_cast<bf16*>(smem + L::PT), sLse, sDi,
                              kv_full, full, empty, dk + base, dv + base, first, n_tiles, k0, T,
                              scale, scale_log2);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG_THREADS, lane = t % 32;
    const int key0 = k0 + 64 * (wg - 1);               // this warpgroup's first key
    const int kr = key0 + 16 * (t / 32) + lane / 4;  // keys kr and kr + 8
    const bf16* sKw = sK + 64 * (wg - 1) * hopper::SW_COLS;  // its 64 rows of each block
    const bf16* sVw = sV + 64 * (wg - 1) * hopper::SW_COLS;

    float dK[D / 2], dV[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dK[i] = dV[i] = 0.0f;
    hopper::mbar_wait(kv_full, 0);

    for (int it = first; it < n_tiles; ++it) {
      const int n = it - first, s = n % STAGES;
      hopper::mbar_wait(&full[s], (n / STAGES) & 1);
      if (it * BQ + BQ <= key0) {  // every query of the tile precedes these keys
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
      const bf16* sQs = sQ + s * BQ * D;
      const bf16* sdOs = sdO + s * BQ * D;
      const float* lse_s = sLse + s * BQ;
      const float* di_s = sDi + s * BQ;

      float St[BQ / 2], dPt[BQ / 2];  // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_k<BQ>(St, hopper::desc_k_major(sKw, kk, block_bytes(DKV_BN)),
                               hopper::desc_k_major(sQs, kk, block_bytes(BQ)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_k<BQ>(dPt, hopper::desc_k_major(sVw, kk, block_bytes(DKV_BN)),
                               hopper::desc_k_major(sdOs, kk, block_bytes(BQ)), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(St);
      hopper::fence_regs(dPt);

      // P^T = exp(s^T - lse) under the causal mask, dS^T = P^T (dP^T - di)
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int qi = it * BQ + c, kj = kr + 8 * ((i / 2) % 2);
        const float p = (qi < T && kj <= qi) ? exp2f(St[i] * scale_log2 - lse_s[c]) : 0.0f;
        St[i] = p;
        dPt[i] = p * (dPt[i] - di_s[c]);
      }
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
      hopper::a_fragments(St, pa);
      hopper::a_fragments(dPt, dsa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hopper::wgmma_rs_mn<D>(dV, pa[kk], hopper::desc_mn_major(sdOs, kk, mn_lbo<D>(BQ)));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hopper::wgmma_rs_mn<D>(dK, dsa[kk], hopper::desc_mn_major(sQs, kk, mn_lbo<D>(BQ)));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dV);
      hopper::fence_regs(dK);
      hopper::mbar_arrive(&empty[s]);
    }

    const long long base = (long long)bh * T * D;
    const float k_mul[2] = {scale, scale}, v_mul[2] = {1.0f, 1.0f};
    store_rows<D>(dk + base, dK, k_mul, key0, T);
    store_rows<D>(dv + base, dV, v_mul, key0, T);
  }
}

// ------------------------------------------------------------ dQ (Hopper)

// dQ tiles: 128 queries per block (64 per consumer warpgroup), key tiles of
// 64 streamed with their V tiles. At 64 keys, S, dP, dQ and the dS fragments
// of a tile fit the consumers' registers with no spill, and the first
// consumer skips the upper half of the block's diagonal; 128-key tiles spill.
// At head_dim 128 the ring has three stages, and a consumer runs a tile's
// exponentials under the previous tile's dQ product (dq_consume_overlapped).
constexpr int DQ_BM = 128;
constexpr int DQ_BN = 64;

template <int D>
struct DqSmem {
  static constexpr int STAGES = D == 64 ? 2 : 3;
  static constexpr int TILE = DQ_BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = Q + DQ_BM * D * 2;
  static constexpr int K = DO + DQ_BM * D * 2;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BARS = V + STAGES * TILE;  // qdo_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + hopper::SW128_ATOM_BYTES;
};

// d[64 x 64] = a[64 x D] . b[64 x D]^T, a a consumer's rows of a DQ_BM-row
// tile and b a DQ_BN-row tile, both K-major swizzled tiles in shared memory;
// issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_scores(float (&d)[32], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_m64n64k16_ss<0>(d, hopper::desc_k_major(a, kk, block_bytes(DQ_BM)),
                                  hopper::desc_k_major(b, kk, block_bytes(DQ_BN)), kk > 0);
}

// P = exp2(s * scale * log2(e) - lse * log2(e)) and dS = P (dP - di) in
// place of dP for the head_dim 128 consumer, branch-free: exp2_ftz, and the
// causal mask where `diag` as a select (key column c kept where c <= row -
// k0, row r of the block's tile).
__device__ __forceinline__ void dq_softmax_grad_ftz(const float (&S)[32], float (&dP)[32],
                                                    const float (&lse2)[2], const float (&dii)[2],
                                                    bool diag, int k0, int q0, int r, int lane,
                                                    float scale_log2) {
  const int last[2] = {diag ? q0 + r - k0 : DQ_BN, diag ? q0 + r + 8 - k0 : DQ_BN};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
    const int hr = (i / 2) % 2;
    const float p = hopper::exp2_ftz(S[i] * scale_log2 - lse2[hr]);
    dP[i] = c <= last[hr] ? p * (dP[i] - dii[hr]) : 0.0f;
  }
}

// S = Q K^T and dP = dO V^T of a key tile (m64n64k16, 8 k-steps), issued as
// one wgmma group: dq, do the first k-step descriptors of the consumer's Q
// and dO rows, dk, dv those of the tile's stage.
template <int D>
__device__ __forceinline__ void issue_dq_scores(float (&S)[32], float (&dP)[32], uint64_t dq,
                                                uint64_t dout, uint64_t dk, uint64_t dv) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_m64n64k16_ss<0>(S, hopper::desc_k_step(dq, kk, block_bytes(DQ_BM)),
                                  hopper::desc_k_step(dk, kk, block_bytes(DQ_BN)), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_m64n64k16_ss<0>(dP, hopper::desc_k_step(dout, kk, block_bytes(DQ_BM)),
                                  hopper::desc_k_step(dv, kk, block_bytes(DQ_BN)), kk > 0);
  hopper::wgmma_commit();
}

// The head_dim 128 consumer of flash_bwd_dq_kernel: 64 query rows, dQ (64
// floats a thread) in registers over key tiles 0..n_mine-1, in
// FlashAttention-3's order: with tile j's dS already bf16 A fragments and
// no wgmma in flight, issue tile j + 1's S and dP, then dQ += dS K for tile
// j; wait for the scores alone (wgmma groups complete in order), and run
// tile j + 1's exponentials while dQ's group runs; then wait for it and
// repack. So the fragments and every other wgmma input are written only
// while no group is in flight, and one S/dP register set serves every tile.
// Key tiles n_mine..n_kv-1, wholly above these rows' diagonal, are released
// unread. The warpgroup index comes through a shuffle, so the compiler
// knows it (and every descriptor) to be uniform in the warp.
template <int D>
__device__ __forceinline__ void dq_consume_overlapped(
    const bf16* sQ, const bf16* sdO, const bf16* sK, const bf16* sV, uint64_t* qdo_full,
    uint64_t* full, uint64_t* empty, const float* lse, const float* di, bf16* dq, int n_kv,
    int q0, int T, float scale, float scale_log2) {
  constexpr int STAGES = DqSmem<D>::STAGES;
  constexpr uint32_t TILE = DqSmem<D>::TILE;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  const int t = threadIdx.x % WG_THREADS, lane = t % 32;
  const int row0 = 64 * (wg - 1);                 // this warpgroup's first row in the tile
  const int r = row0 + 16 * (t / 32) + lane / 4;  // rows r and r + 8 of the tile
  const int qa = q0 + row0;                       // this warpgroup's first query
  const uint64_t dQd = hopper::desc_k_major(sQ + row0 * hopper::SW_COLS, 0, 0);
  const uint64_t dOd = hopper::desc_k_major(sdO + row0 * hopper::SW_COLS, 0, 0);
  const uint64_t dKk = hopper::desc_k_major(sK, 0, 0), dVk = hopper::desc_k_major(sV, 0, 0);
  const uint64_t dKm = hopper::desc_mn_major(sK, 0, mn_lbo<D>(DQ_BN));

  float lse2[2], dii[2];  // rows past T: zeros (their Q and dO rows are zeros, never written)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r + 8 * hr;
    lse2[hr] = qi < T ? lse[qi] * LOG2E : 0.0f;
    dii[hr] = qi < T ? di[qi] : 0.0f;
  }
  const int n_mine = qa >= T ? 0 : min(n_kv, qa / DQ_BN + 1);  // up to the diagonal
  float dQ[D / 2], S[32], dP[32];
  uint32_t dsa[DQ_BN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dQ[i] = 0.0f;
  hopper::mbar_wait_spin(qdo_full, 0);

  auto scores = [&](int j) {  // issue key tile j's S and dP
    const int s = j % STAGES;
    hopper::mbar_wait_spin(&full[s], (j / STAGES) & 1);
    issue_dq_scores<D>(S, dP, dQd, dOd, hopper::desc_advance(dKk, s * TILE),
                       hopper::desc_advance(dVk, s * TILE));
  };
  auto grad_ds = [&](int j) {  // dS of key tile j from its finished scores
    hopper::fence_regs(S);
    hopper::fence_regs(dP);
    const int k0 = j * DQ_BN;
    dq_softmax_grad_ftz(S, dP, lse2, dii, k0 + DQ_BN - 1 > qa, k0, q0, r, lane, scale_log2);
  };
  auto grad_q = [&](int j) {  // issue dQ += dS K of key tile j
    const uint64_t km = hopper::desc_advance(dKm, (j % STAGES) * TILE);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BN / 16; ++kk)
      hopper::wgmma_rs_mn<D>(dQ, dsa[kk], hopper::desc_mn_step(km, kk));
    hopper::wgmma_commit();
  };
  if (n_mine > 0) {
    // peeled, so that every pass issues and waits for the same groups
    scores(0);
    hopper::wgmma_wait<0>();
    grad_ds(0);
    hopper::a_fragments(dP, dsa);
    for (int j = 0; j < n_mine - 1; ++j) {
      scores(j + 1);
      grad_q(j);
      hopper::wgmma_wait<1>();  // tile j + 1's scores; tile j's dQ group runs on
      grad_ds(j + 1);
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(&empty[j % STAGES]);
      hopper::a_fragments(dP, dsa);
    }
    grad_q(n_mine - 1);
    hopper::wgmma_wait<0>();
    hopper::mbar_arrive(&empty[(n_mine - 1) % STAGES]);
  }
  hopper::fence_regs(dQ);
  for (int j = n_mine; j < n_kv; ++j) {
    hopper::mbar_wait_spin(&full[j % STAGES], (j / STAGES) & 1);
    hopper::mbar_arrive(&empty[j % STAGES]);
  }
  const float mul[2] = {scale, scale};
  store_rows<D>(dq, dQ, mul, qa, T);
}

// One block per (b*h, 128-query tile), laid out by block_grid; tiles count
// from the last (the most key tiles) down, so the longest start first.
// Warpgroup 0 loads Q and dO once and streams the K and V tiles from 0 to
// the diagonal into the ring; warpgroups 1 and 2 each own 64 query rows and
// hold their dQ, and their rows' lse * log2(e) and di, in registers. At
// head_dim 64 a consumer runs each key tile in series; at 128,
// dq_consume_overlapped.
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    bf16* __restrict__ dq, int H, int T, float scale, float scale_log2) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = DqSmem<D>;
  constexpr int STAGES = L::STAGES;
  constexpr int NS = DQ_BN / 2;  // accumulator floats of a 64 x DQ_BN tile per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::DO);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = grid_bh<D>(), b = bh / H, h = bh % H;
  const int tile = grid_tiles<D>() - 1 - grid_tile<D>();
  const int q0 = tile * DQ_BM;
  // key tiles 0..n_kv-1: up to the block's last query, and none wholly past T
  const int n_kv = min((q0 + DQ_BM + DQ_BN - 1) / DQ_BN, (T + DQ_BN - 1) / DQ_BN);
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qdo_full, 1);
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
      hopper::mbar_arrive_expect_tx(qdo_full, 2 * DQ_BM * D * 2);
      hopper::tma_load_rows<D>(sQ, &tq, qdo_full, DQ_BM, q0, h, b);
      hopper::tma_load_rows<D>(sdO, &tdo, qdo_full, DQ_BM, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
        hopper::tma_load_rows<D>(sK + s * DQ_BN * D, &tk, &full[s], DQ_BN, j * DQ_BN, h, b);
        hopper::tma_load_rows<D>(sV + s * DQ_BN * D, &tv, &full[s], DQ_BN, j * DQ_BN, h, b);
      }
    }
  } else if constexpr (D == 128) {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    dq_consume_overlapped<D>(sQ, sdO, sK, sV, qdo_full, full, empty, lse + (long long)bh * T,
                             di + (long long)bh * T, dq + (long long)bh * T * D, n_kv, q0, T,
                             scale, scale_log2);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG_THREADS, lane = t % 32;
    const int row0 = 64 * (wg - 1);                 // this warpgroup's first row in the tile
    const int r = row0 + 16 * (t / 32) + lane / 4;  // rows r and r + 8 of the tile
    const int qa = q0 + row0;                       // this warpgroup's first query
    const bf16* sQw = sQ + row0 * hopper::SW_COLS;  // row0 of each column block
    const bf16* sdOw = sdO + row0 * hopper::SW_COLS;

    float lse2[2], dii[2];  // rows past T: zeros (their Q and dO rows are zeros, never written)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + r + 8 * hr;
      lse2[hr] = qi < T ? lse[(long long)bh * T + qi] * LOG2E : 0.0f;
      dii[hr] = qi < T ? di[(long long)bh * T + qi] : 0.0f;
    }
    float dQ[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dQ[i] = 0.0f;
    hopper::mbar_wait(qdo_full, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      const int k0 = j * DQ_BN;
      hopper::mbar_wait(&full[s], (j / STAGES) & 1);
      if (k0 > qa + 63 || qa >= T) {  // every key follows these rows, or no row is real
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
      const bf16* sKs = sK + s * DQ_BN * D;
      const bf16* sVs = sV + s * DQ_BN * D;

      float S[NS], dP[NS];  // S = Q K^T and dP = dO V^T: 64 rows x DQ_BN keys
      hopper::wgmma_fence();
      issue_scores<D>(S, sQw, sKs);
      issue_scores<D>(dP, sdOw, sVs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(S);
      hopper::fence_regs(dP);

      // P = exp2(s * scale * log2(e) - lse * log2(e)) under the causal mask,
      // dS = P (dP - di), in place of dP
      const bool diag = k0 + DQ_BN - 1 > qa;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int hr = (i / 2) % 2;
        const bool masked = diag && k0 + c > q0 + r + 8 * hr;
        const float p = masked ? 0.0f : exp2f(S[i] * scale_log2 - lse2[hr]);
        dP[i] = p * (dP[i] - dii[hr]);
      }
      uint32_t dsa[DQ_BN / 16][4];  // dS rounded to bf16, as the A operand of dS K
      hopper::a_fragments(dP, dsa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk)
        hopper::wgmma_rs_mn<D>(dQ, dsa[kk], hopper::desc_mn_major(sKs, kk, mn_lbo<D>(DQ_BN)));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dQ);
      hopper::mbar_arrive(&empty[s]);
    }

    const float mul[2] = {scale, scale};
    store_rows<D>(dq + (long long)bh * T * D, dQ, mul, qa, T);
  }
}

// ------------------------------------------------------------ di = sum(o * do)

// The backward's di: for each row of [B, H, T], the float32 sum over
// head_dim of o * do (a product of two bf16 values is exact in float32). It
// reads o and do once and is bytes-bound. D / 8 threads hold a row, each
// loading 16 bytes of o and of do (streaming loads, so inputs that fit L2
// are not kept there). Each row sums in a fixed order: a thread's 8
// products in order, then the row's threads by a butterfly of shuffles, so
// every call gives the same bits. A block per DI_ROWS rows of one (b, h):
// blockIdx.y is b*h.
constexpr int DI_THREADS = 256;
template <int D>
constexpr int DI_ROWS = DI_THREADS / (D / 8);

template <int D>
__global__ void __launch_bounds__(DI_THREADS)
flash_di_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ di,
                int H, int T, long long osb, long long osh, long long ost, long long dsb,
                long long dsh, long long dst) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  constexpr int LANES = D / 8;  // threads of a row
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int part = threadIdx.x % LANES;
  const int t = blockIdx.x * DI_ROWS<D> + threadIdx.x / LANES;
  uint4 x = make_uint4(0, 0, 0, 0), y = x;
  if (t < T) {
    x = __ldcs(reinterpret_cast<const uint4*>(o + b * osb + h * osh + t * ost + 8 * part));
    y = __ldcs(reinterpret_cast<const uint4*>(dout + b * dsb + h * dsh + t * dst + 8 * part));
  }
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
  float sum = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a = __bfloat1622float2(xs[e]), c = __bfloat1622float2(ys[e]);
    sum += a.x * c.x;
    sum += a.y * c.y;
  }
#pragma unroll
  for (int lanes = 1; lanes < LANES; lanes *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, lanes);
  if (part == 0 && t < T) di[(long long)bh * T + t] = sum;
}

// ------------------------------------------------------------ launches

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int T, const long long* strides, float scale, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  const void* ops[3] = {q, k, v};
  const int rows[3] = {FWD_BM, FWD_BN, FWD_BN};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = hopper::encode_bhtd(&maps[i], ops[i], B, H, T, D, strides[3 * i], strides[3 * i + 1],
                              strides[3 * i + 2], rows[i]);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdSmem<D>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T + FWD_BM - 1) / FWD_BM, group = fwd_head_group(B * H);
  const dim3 grid(tiles * group, B * H / group);
  flash_fwd_kernel<D><<<grid, HOPPER_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), static_cast<float*>(lse), H, T,
      scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* di, void* dk, void* dv, int B, int H,
                           int T, const long long* strides, float scale, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const void* ops[4] = {q, k, v, dout};
  const int rows[4] = {DkvSmem<D>::BQ, DKV_BN, DKV_BN, DkvSmem<D>::BQ};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = hopper::encode_bhtd(&maps[i], ops[i], B, H, T, D, strides[3 * i], strides[3 * i + 1],
                              strides[3 * i + 2], rows[i]);
  if (err != cudaSuccess) return err;
  constexpr int smem = DkvSmem<D>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = block_grid<D>(B * H, (T + DKV_BN - 1) / DKV_BN);
  flash_bwd_dkv_kernel<D><<<grid, HOPPER_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, scale,
      scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* di, void* dq, int B, int H, int T,
                          const long long* strides, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const void* ops[4] = {q, k, v, dout};
  const int rows[4] = {DQ_BM, DQ_BN, DQ_BN, DQ_BM};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = hopper::encode_bhtd(&maps[i], ops[i], B, H, T, D, strides[3 * i], strides[3 * i + 1],
                              strides[3 * i + 2], rows[i]);
  if (err != cudaSuccess) return err;
  constexpr int smem = DqSmem<D>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = block_grid<D>(B * H, (T + DQ_BM - 1) / DQ_BM);
  flash_bwd_dq_kernel<D><<<grid, HOPPER_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dq), H, T, scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_di(const void* o, const void* dout, void* di, int B, int H, int T,
                      const long long* strides, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + DI_ROWS<D> - 1) / DI_ROWS<D>, B * H);
  flash_di_kernel<D><<<grid, DI_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(di), H, T,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5]);
  return cudaGetLastError();
}

}  // namespace

// The C entries, one per kernel and head_dim: flash_attention_{fwd, bwd_dkv,
// bwd_dq, di}_bf16_hd{64, 128}. strides: q, k, v (and do for the backward;
// o and do for di), each (batch, head, time), in elements.
#define FLASH_ENTRIES(D)                                                                        \
  int flash_attention_fwd_bf16_hd##D(const void* q, const void* k, const void* v, void* o,      \
                                     void* lse, int B, int H, int T, const long long* strides,  \
                                     float scale, int device, void* stream) {                   \
    return launch_fwd<D>(q, k, v, o, lse, B, H, T, strides, scale, device, stream);             \
  }                                                                                             \
  int flash_attention_bwd_dkv_bf16_hd##D(const void* q, const void* k, const void* v,           \
                                         const void* dout, const void* lse, const void* di,     \
                                         void* dk, void* dv, int B, int H, int T,               \
                                         const long long* strides, float scale, int device,     \
                                         void* stream) {                                        \
    return launch_bwd_dkv<D>(q, k, v, dout, lse, di, dk, dv, B, H, T, strides, scale, device,   \
                             stream);                                                           \
  }                                                                                             \
  int flash_attention_bwd_dq_bf16_hd##D(const void* q, const void* k, const void* v,            \
                                        const void* dout, const void* lse, const void* di,      \
                                        void* dq, int B, int H, int T,                          \
                                        const long long* strides, float scale, int device,      \
                                        void* stream) {                                         \
    return launch_bwd_dq<D>(q, k, v, dout, lse, di, dq, B, H, T, strides, scale, device,        \
                            stream);                                                            \
  }                                                                                             \
  int flash_attention_di_bf16_hd##D(const void* o, const void* dout, void* di, int B, int H,    \
                                    int T, const long long* strides, int device,                \
                                    void* stream) {                                             \
    return launch_di<D>(o, dout, di, B, H, T, strides, device, stream);                         \
  }

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The attention kernels' tiles at head_dim 64 or 128, into out[9]: the
// forward's queries per block, key tile and stages a ring (K and V each
// have one); dK/dV's keys per block and query tile; dQ's queries per block
// and key tile; 1 where the backward's grid is tile-major (block_grid), 0
// where head-major; and the forward's most heads a group (fwd_head_group).
// Returns -1 for another head_dim.
int flash_attention_tiles(int head_dim, int* out) {
  if (head_dim != 64 && head_dim != 128) return -1;
  const bool hd64 = head_dim == 64;
  out[0] = FWD_BM;
  out[1] = FWD_BN;
  out[2] = FwdSmem<64>::STAGES;
  out[3] = DKV_BN;
  out[4] = hd64 ? DkvSmem<64>::BQ : DkvSmem<128>::BQ;
  out[5] = DQ_BM;
  out[6] = DQ_BN;
  out[7] = hd64 ? tile_major<64>() : tile_major<128>();
  out[8] = FWD_HEAD_GROUP;
  return 0;
}

FLASH_ENTRIES(64)
FLASH_ENTRIES(128)

}  // extern "C"
