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
    wgmma_m64n128k16_ss<0>(d1, desc_k_major(sA, kk), desc_k_major(sB, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss<0>(d2, desc_k_major(sA, kk), desc_k_major(sB, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss<1>(d4, desc_k_major(sA, kk),
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

}  // extern "C"
