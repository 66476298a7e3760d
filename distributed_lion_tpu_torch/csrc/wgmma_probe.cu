// Probe of the wgmma operand forms that the flash kernels use, each on known
// matrices, through the building blocks of hopper.cuh (TMA with the 128-byte
// swizzle, mbarrier, descriptors, the accumulator -> A-fragment repack).
// probes/wgmma_forms.py builds it, runs it and compares with torch.matmul.
//
// One warpgroup. Inputs (bf16, row-major): a [64, 64], bk [128, 64], v [128, 64].
// Outputs (float32, row-major):
//   c1 [64, 128] = a . bk^T           A and B K-major, m64n128k16 (S = Q.K^T)
//   c2 [64, 64]  = a . bk[:64]^T      A and B K-major, m64n64k16 (S^T = K.Q^T)
//   c3 [64, 64]  = bf16(c1) . v       A from registers, B MN-major, 8 k-steps (P.V)
//   c4 [64, 64]  = a . v[:64]         A K-major, B MN-major from shared memory
// c4 takes the MN-major descriptor's LBO and SBO from the caller, so the
// probe can show which pair the card reads as the hopper.cuh constants do.
//
// The head_dim 128 forms (wgmma_probe128), on tiles loaded as two boxes of
// 64 columns each (hopper::tma_load_rows<128>). Inputs (bf16, row-major):
// a [64, 128], bk [128, 128], v [128, 128]. Outputs (float32, row-major):
//   e1 [64, 128] = a . bk^T            K-major over both column blocks, m64n128k16
//                                      (the forward's S = Q.K^T)
//   e2 [64, 16]  = a . bk[:16]^T       the same at m64n16k16 (dK/dV's S^T = K.Q^T)
//   e3 [64, 64]  = a . bk[:64]^T       the same at m64n64k16 (dQ's S = Q.K^T)
//   e4 [64, 128] = bf16(e1) . v        A from registers, B MN-major at N = 128,
//                                      8 k-steps, m64n128k16 RS (P.V)
//   e5 [64, 128] = bf16(e2) . v[:16]   the same over 1 k-step (P^T.dO, dS^T.Q)
//   e6 [64, 128] = bf16(e3) . bk[:64]  the same over 4 k-steps of bk read
//                                      MN-major (dS.K)
//   e7 [64, 128] = a[:, :64] . v[:64]  B MN-major from shared memory at N = 128
//                                      with the caller's (LBO, SBO)
//
// The head_dim 128 backward forms (wgmma_probe_bwd128): a [64, 128] (a query
// tile of Q or dO, 64 rows) and bk [128, 128] (a block's 128 keys), loaded
// as above. Outputs (float32, row-major):
//   f1 [64, 64]  = bk[64:] . a^T       m64n64k16, A the second 64 rows of the
//                                      128-row tile, B the 64-row tile, both
//                                      K-major across both column blocks
//                                      (dK/dV's S^T = K Q^T, consumer 2)
//   f2 [64, 128] = bf16(f1) . a        m64n128k16 with A and B from shared
//                                      memory: A the threads' own bf16 store
//                                      of f1 (hopper::store_sw128_tile, then
//                                      the proxy fence and a named barrier),
//                                      B the 64-row tile MN-major at N = 128
//                                      (dV += P^T dO, dK += dS^T Q)
//   f3 [64, 64]  = bk[:64] . a^T       issued as a group before a second
//   f4 [64, 128] = bf16(f1) . a        group (f4's); wgmma_wait<1> completes
//                                      f3's group alone, wait<0> f4's (the
//                                      overlapped loop's two groups in flight)

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// Writes one m64nN accumulator as a row-major [64, N] float32 matrix.
template <int N>
__device__ void store_acc(float* out, const float (&d)[N / 2]) {
  const int t = threadIdx.x, w = t / 32, l = t % 32;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (l % 4) + (i % 2);
    out[row * N + col] = d[i];
  }
}

__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tv, float* c1, float* c2, float* c3,
                   float* c4, uint32_t mn_lbo, uint32_t mn_sbo) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(smem);      // [64][64]
  bf16* sB = sA + 64 * 64;                       // [128][64]
  bf16* sV = sB + 128 * 64;                      // [128][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + 128 * 64);

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (64 + 128 + 128) * 64 * 2);
    tma_load_4d(sA, &ta, bar, 0, 0, 0, 0);
    tma_load_4d(sB, &tb, bar, 0, 0, 0, 0);
    tma_load_4d(sV, &tv, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);

  float d1[64], d2[32], d3[32], d4[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss<0>(d1, desc_k_major(sA, kk, 64 * 128), desc_k_major(sB, kk, 128 * 128),
                           kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss<0>(d2, desc_k_major(sA, kk, 64 * 128), desc_k_major(sB, kk, 128 * 128),
                          kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss<1>(d4, desc_k_major(sA, kk, 64 * 128),
                          desc_sw128(smem_addr(sV) + 2048 * kk, mn_lbo, mn_sbo), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d1);
  fence_regs(d2);
  fence_regs(d4);

  uint32_t pa[8][4];
  a_fragments(d1, pa);
#pragma unroll
  for (int i = 0; i < 32; ++i) d3[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs<1>(d3, pa[kk], desc_mn_major(sV, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d3);

  store_acc<128>(c1, d1);
  store_acc<64>(c2, d2);
  store_acc<64>(c3, d3);
  store_acc<64>(c4, d4);
}

// The head_dim 128 forms: see the file's head. Column blocks of a tile of
// `rows` rows are rows * 128 bytes apart.
__global__ void __launch_bounds__(128)
wgmma_probe128_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tv, float* e1, float* e2, float* e3,
                      float* e4, float* e5, float* e6, float* e7, uint32_t mn_lbo,
                      uint32_t mn_sbo) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(smem);      // [64][128]: 2 blocks of 64 x 128 bytes
  bf16* sB = sA + 64 * 128;                      // [128][128]
  bf16* sV = sB + 128 * 128;                     // [128][128]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + 128 * 128);
  constexpr uint32_t A_BLOCK = 64 * 128, B_BLOCK = 128 * 128;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (64 + 128 + 128) * 128 * 2);
    tma_load_rows<128>(sA, &ta, bar, 64, 0, 0, 0);
    tma_load_rows<128>(sB, &tb, bar, 128, 0, 0, 0);
    tma_load_rows<128>(sV, &tv, bar, 128, 0, 0, 0);
  }
  mbar_wait(bar, 0);

  float d1[64], d2[8], d3[32], d7[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_k<128>(d1, desc_k_major(sA, kk, A_BLOCK), desc_k_major(sB, kk, B_BLOCK), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_k<16>(d2, desc_k_major(sA, kk, A_BLOCK), desc_k_major(sB, kk, B_BLOCK), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_k<64>(d3, desc_k_major(sA, kk, A_BLOCK), desc_k_major(sB, kk, B_BLOCK), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss<1>(d7, desc_k_major(sA, kk, A_BLOCK),
                           desc_sw128(smem_addr(sV) + 2048 * kk, mn_lbo, mn_sbo), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d1);
  fence_regs(d2);
  fence_regs(d3);
  fence_regs(d7);
  store_acc<128>(e1, d1);
  store_acc<16>(e2, d2);
  store_acc<64>(e3, d3);
  store_acc<128>(e7, d7);

  float d[64];
  {
    uint32_t pa[8][4];
    a_fragments(d1, pa);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs_mn<128>(d, pa[kk], desc_mn_major(sV, kk, B_BLOCK));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    store_acc<128>(e4, d);
  }
  {
    uint32_t pa[1][4];
    a_fragments(d2, pa);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    wgmma_fence();
    wgmma_rs_mn<128>(d, pa[0], desc_mn_major(sV, 0, B_BLOCK));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    store_acc<128>(e5, d);
  }
  {
    uint32_t pa[4][4];
    a_fragments(d3, pa);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<128>(d, pa[kk], desc_mn_major(sB, kk, B_BLOCK));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    store_acc<128>(e6, d);
  }

}

// The head_dim 128 backward forms: see the file's head.
__global__ void __launch_bounds__(128)
wgmma_probe_bwd128_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, float* f1, float* f2,
                          float* f3, float* f4) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(smem);      // [64][128]: 2 blocks of 64 x 128 bytes
  bf16* sB = sA + 64 * 128;                      // [128][128]
  bf16* sP = sB + 128 * 128;                     // [64][64], written by the threads
  uint64_t* bar = reinterpret_cast<uint64_t*>(sP + 64 * 64);
  constexpr uint32_t A_BLOCK = 64 * 128, B_BLOCK = 128 * 128;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (64 + 128) * 128 * 2);
    tma_load_rows<128>(sA, &ta, bar, 64, 0, 0, 0);
    tma_load_rows<128>(sB, &tb, bar, 128, 0, 0, 0);
  }
  mbar_wait(bar, 0);

  float d1[32], d3[32], d2[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss<0>(d1, desc_k_major(sB + 64 * SW_COLS, kk, B_BLOCK),
                          desc_k_major(sA, kk, A_BLOCK), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d1);
  store_acc<64>(f1, d1);

  store_sw128_tile(sP, d1);
  fence_proxy_async();
  named_barrier_sync(1, 128);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss<1>(d2, desc_k_major(sP, kk, 0), desc_mn_major(sA, kk, A_BLOCK), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d2);
  store_acc<128>(f2, d2);

  // two groups in flight: the scores first, then the product from sP
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss<0>(d3, desc_k_major(sB, kk, B_BLOCK), desc_k_major(sA, kk, A_BLOCK),
                          kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss<1>(d2, desc_k_major(sP, kk, 0), desc_mn_major(sA, kk, A_BLOCK), kk > 0);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(d3);
  store_acc<64>(f3, d3);
  wgmma_wait<0>();
  fence_regs(d2);
  store_acc<128>(f4, d2);
}

}  // namespace

extern "C" {

const char* wgmma_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a, bk, v: contiguous bf16 [64, 64], [128, 64], [128, 64] on the current
// device; c1..c4 contiguous float32 outputs.
int wgmma_probe(const void* a, const void* bk, const void* v, void* c1, void* c2, void* c3,
                void* c4, unsigned mn_lbo, unsigned mn_sbo, void* stream) {
  CUtensorMap ta, tb, tv;
  cudaError_t err = encode_bhtd(&ta, a, 1, 1, 64, 64, 64 * 64, 64 * 64, 64, 64);
  if (err == cudaSuccess) err = encode_bhtd(&tb, bk, 1, 1, 128, 64, 128 * 64, 128 * 64, 64, 128);
  if (err == cudaSuccess) err = encode_bhtd(&tv, v, 1, 1, 128, 64, 128 * 64, 128 * 64, 64, 128);
  if (err != cudaSuccess) return err;
  const int smem = (64 + 128 + 128) * 64 * 2 + 8 + 1024;
  err = cudaFuncSetAttribute(wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  wgmma_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tv, static_cast<float*>(c1), static_cast<float*>(c2), static_cast<float*>(c3),
      static_cast<float*>(c4), mn_lbo, mn_sbo);
  return cudaGetLastError();
}

// a, bk, v: contiguous bf16 [64, 128], [128, 128], [128, 128] on the current
// device; e1..e7 contiguous float32 outputs.
int wgmma_probe128(const void* a, const void* bk, const void* v, void* e1, void* e2, void* e3,
                   void* e4, void* e5, void* e6, void* e7, unsigned mn_lbo, unsigned mn_sbo,
                   void* stream) {
  CUtensorMap ta, tb, tv;
  cudaError_t err = encode_bhtd(&ta, a, 1, 1, 64, 128, 64 * 128, 64 * 128, 128, 64);
  if (err == cudaSuccess)
    err = encode_bhtd(&tb, bk, 1, 1, 128, 128, 128 * 128, 128 * 128, 128, 128);
  if (err == cudaSuccess)
    err = encode_bhtd(&tv, v, 1, 1, 128, 128, 128 * 128, 128 * 128, 128, 128);
  if (err != cudaSuccess) return err;
  const int smem = (64 + 128 + 128) * 128 * 2 + 8 + 1024;
  err = cudaFuncSetAttribute(wgmma_probe128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  float* out[7] = {static_cast<float*>(e1), static_cast<float*>(e2), static_cast<float*>(e3),
                   static_cast<float*>(e4), static_cast<float*>(e5), static_cast<float*>(e6),
                   static_cast<float*>(e7)};
  wgmma_probe128_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tv, out[0], out[1], out[2], out[3], out[4], out[5], out[6], mn_lbo, mn_sbo);
  return cudaGetLastError();
}

// a, bk: contiguous bf16 [64, 128], [128, 128] on the current device; f1..f4
// contiguous float32 outputs.
int wgmma_probe_bwd128(const void* a, const void* bk, void* f1, void* f2, void* f3, void* f4,
                       void* stream) {
  CUtensorMap ta, tb;
  cudaError_t err = encode_bhtd(&ta, a, 1, 1, 64, 128, 64 * 128, 64 * 128, 128, 64);
  if (err == cudaSuccess)
    err = encode_bhtd(&tb, bk, 1, 1, 128, 128, 128 * 128, 128 * 128, 128, 128);
  if (err != cudaSuccess) return err;
  const int smem = (64 + 128) * 128 * 2 + 64 * 64 * 2 + 8 + 1024;
  err = cudaFuncSetAttribute(wgmma_probe_bwd128_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wgmma_probe_bwd128_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<float*>(f1), static_cast<float*>(f2), static_cast<float*>(f3),
      static_cast<float*>(f4));
  return cudaGetLastError();
}

}  // extern "C"
