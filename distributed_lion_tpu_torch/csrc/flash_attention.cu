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
// bytes-bound (0.015 ms) and the backward is operations-bound. This first
// version is simple rather than fast: one block of 4 warps per (b*h, 64-row
// tile), tiles staged in shared memory by plain 16-byte loads, bf16
// tensor-core products through nvcuda::wmma (16x16x16, float32 sums), and
// the softmax in float32 through shared memory. No TMA, no wgmma, no
// pipelining; that is later work.
//
// Forward (one block per query tile): loops over key tiles up to the
// diagonal with an online softmax (running max and sum per row, float32);
// P is rounded to bf16 before P.V, as the plain version rounds the
// probabilities before its value product.
// dK/dV (one block per key tile): loops over query tiles from the diagonal
// to T, recomputing P^T = exp(s^T - lse) and dS^T = P^T * (dP^T - di).
// dQ (one block per query tile): loops over key tiles up to the diagonal.
// Each output element is summed by one block, so no atomics are needed and
// the results are deterministic.
//
// Causal masking is applied inside the diagonal tile, and a T that is not a
// multiple of the tile is masked in the kernel (rows past T load as zeros
// and are never written). head_dim is a template parameter; only D = 64 is
// instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

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

// out[16 x N] (float, stride LDF) = a[16 x K] . b, for this warp's strip.
// B_COL: b is read as the transpose of a row-major [N, K] tile (b^T), else
// as a row-major [K, N] tile.
template <int K, int N, bool B_COL>
__device__ void strip_product(float* out, const bf16* a, int lda, const bf16* b, int ldb) {
  static_assert(N <= LDF, "the output strip fits a score tile row");
#pragma unroll
  for (int nf = 0; nf < N / 16; ++nf) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      if constexpr (B_COL) {
        FragBCol fb;
        wmma::load_matrix_sync(fb, b + nf * 16 * ldb + kk * 16, ldb);
        wmma::mma_sync(c, fa, fb, c);
      } else {
        FragBRow fb;
        wmma::load_matrix_sync(fb, b + kk * 16 * ldb + nf * 16, ldb);
        wmma::mma_sync(c, fa, fb, c);
      }
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
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int T, Strides sq, Strides sk, Strides sv, float scale) {
  constexpr int LD = ld_tile<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LD;
  bf16* sV = sK + BN * LD;
  float* sS = reinterpret_cast<float*>(sV + BN * LD);
  bf16* sP = reinterpret_cast<bf16*>(sS + BM * LDF);

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = tile * BM;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row = tid >> 1, half = tid & 1;  // this thread's row, and its half of the columns
  const int qi = q0 + row;
  float* wS = sS + warp * 16 * LDF;

  load_tile<D>(sQ, q + b * sq.b + h * sq.h, sq.t, q0, T);
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int j = 0; j <= tile; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_tile<D>(sK, kb, sk.t, k0, T);
    load_tile<D>(sV, vb, sv.t, k0, T);
    __syncthreads();

    strip_product<D, BN, true>(wS, sQ + warp * 16 * LD, LD, sK, LD);  // S = Q K^T
    __syncwarp();

    float s[BN / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      const int col = half * (BN / 2) + c, kj = k0 + col;
      const float x = kj <= qi ? sS[row * LDF + col] * scale : -INFINITY;
      s[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: key 0 of the row's first tile is unmasked
    const float alpha = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      const float p = expf(s[c] - m_new);
      sP[row * LDP + half * (BN / 2) + c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] *= alpha;
    __syncwarp();

    strip_product<BN, D, false>(wS, sP + warp * 16 * LDP, LDP, sV, LD);  // P V
    __syncwarp();
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] += sS[row * LDF + half * (D / 2) + c];
  }

  if (qi < T) {
    const float inv = 1.0f / l;
    bf16* orow = o + ((long long)bh * T + qi) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = __float2bfloat16(acc[c] * inv);
    if (half == 0) lse[(long long)bh * T + qi] = m + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T,
                     Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  constexpr int LD = ld_tile<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;
  bf16* sdO = sQ + BM * LD;
  float* sS = reinterpret_cast<float*>(sdO + BM * LD);  // S^T, keys x queries
  float* sdP = sS + BN * LDF;                          // dP^T
  bf16* sP = reinterpret_cast<bf16*>(sdP + BN * LDF);  // P^T, bf16
  bf16* sdS = sP + BN * LDP;                           // dS^T, bf16
  float* sLse = reinterpret_cast<float*>(sdS + BN * LDP);
  float* sDi = sLse + BM;

  const int jt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = jt * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row = tid >> 1, half = tid & 1;
  const int kj = k0 + row;
  float* wS = sS + warp * 16 * LDF;
  float* wdP = sdP + warp * 16 * LDF;

  load_tile<D>(sK, k + b * sk.b + h * sk.h, sk.t, k0, T);
  load_tile<D>(sV, v + b * sv.b + h * sv.h, sv.t, k0, T);
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * T;
  const float* dib = di + (long long)bh * T;

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf) {
    wmma::fill_fragment(dk_acc[nf], 0.0f);
    wmma::fill_fragment(dv_acc[nf], 0.0f);
  }

  const int n_tiles = (T + BM - 1) / BM;
  for (int it = jt; it < n_tiles; ++it) {
    const int q0 = it * BM;
    __syncthreads();
    load_tile<D>(sQ, qb, sq.t, q0, T);
    load_tile<D>(sdO, dob, sdo.t, q0, T);
    if (tid < BM) {
      sLse[tid] = q0 + tid < T ? lseb[q0 + tid] : 0.0f;
      sDi[tid] = q0 + tid < T ? dib[q0 + tid] : 0.0f;
    }
    __syncthreads();

    strip_product<D, BM, true>(wS, sK + warp * 16 * LD, LD, sQ, LD);    // S^T = K Q^T
    strip_product<D, BM, true>(wdP, sV + warp * 16 * LD, LD, sdO, LD);  // dP^T = V dO^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < BM / 2; ++c) {
      const int col = half * (BM / 2) + c, qi = q0 + col;
      float p = 0.0f;
      if (qi < T && kj <= qi) p = expf(sS[row * LDF + col] * scale - sLse[col]);
      sP[row * LDP + col] = __float2bfloat16(p);
      sdS[row * LDP + col] = __float2bfloat16(p * (sdP[row * LDF + col] - sDi[col]));
    }
    __syncwarp();
    strip_accumulate<D>(dv_acc, sP + warp * 16 * LDP, sdO);   // dV += P^T dO
    strip_accumulate<D>(dk_acc, sdS + warp * 16 * LDP, sQ);   // dK += dS^T Q
  }

  const long long base = (long long)bh * T * D;
  store_strip<D>(dk + base, dk_acc, wS, scale, k0, T);
  store_strip<D>(dv + base, dv_acc, wS, 1.0f, k0, T);
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

    strip_product<D, BN, true>(wS, sQ + warp * 16 * LD, LD, sK, LD);    // S = Q K^T
    strip_product<D, BN, true>(wdP, sdO + warp * 16 * LD, LD, sV, LD);  // dP = dO V^T
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
constexpr size_t fwd_smem() {
  return (size_t)(BM + 2 * BN) * ld_tile<D>() * 2 + (size_t)BM * LDF * 4 + (size_t)BM * LDP * 2;
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
  constexpr size_t smem = fwd_smem<64>();
  err = cudaFuncSetAttribute(flash_fwd_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BM - 1) / BM, B * H);
  flash_fwd_kernel<64><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, T, strides_at(strides, 0),
      strides_at(strides, 1), strides_at(strides, 2), scale);
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
  constexpr size_t smem = bwd_smem<64>();
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BN - 1) / BN, B * H);
  flash_bwd_dkv_kernel<64><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T,
      strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
      strides_at(strides, 3), scale);
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
