// Hopper (sm_90a) building blocks in raw PTX, shared by the port's CUDA kernels.
//
// - TMA: a host-encoded CUtensorMap over a [B, H, T, D] bf16 tensor taken
//   through its strides (dimensions {D, T, H, B}), a box of {64, rows, 1, 1}
//   and the 128-byte swizzle; rows past T load as zeros. One thread issues
//   cp.async.bulk.tensor and the copy completes on an mbarrier.
// - mbarrier: init, arrive, arrive-expect-tx, and a parity wait.
// - wgmma: the shared-memory matrix descriptor of a 128-byte-swizzled tile,
//   fence / commit / wait, and m64n{16,64,128}k16 bf16 products with
//   float32 sums, with A from shared memory or from registers; an
//   accumulator stored by the threads as such a tile (store_sw128_tile) for
//   a later product to read, behind the proxy fence and a named barrier.
// - setmaxnreg: register hand-over between a producer warpgroup and its
//   consumers.
//
// Tile layout in shared memory: TMA with CU_TENSOR_MAP_SWIZZLE_128B writes a
// box of 64 bf16 columns as 128-byte rows, 16-byte chunk c of row r stored at
// chunk c ^ (r % 8); eight rows form a 1024-byte atom and the atoms follow one
// another, so every tile starts on a 1024-byte boundary. wgmma reads such a
// tile in two ways:
// - K-major: the reduction (k) dimension runs along the row, as for Q and K
//   in Q.K^T. A k-step of 16 elements starts 32 bytes further along the row;
//   the 8-row atoms are SBO = 1024 bytes apart (LBO is unused).
// - MN-major: the reduction dimension runs down the rows, as for V in P.V.
//   A k-step of 16 rows starts 2048 bytes further; the 8-row groups along k
//   are SBO = 1024 bytes apart, and LBO steps to the next 64 columns of N.
// A tile wider than 64 columns (head_dim 128) is loaded as one box per 64
// columns, the column blocks stored one after another, each rows x 128
// bytes: a K-major k-step past the first block's four starts in the next
// block, and an MN-major product of N = 128 reads the second block at LBO =
// the column-block stride.
// probes/wgmma_forms.py checks each form on the card against torch.matmul.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr uint32_t SW128_ATOM_BYTES = 1024;  // 8 rows of 128 bytes
constexpr uint32_t KMAJOR_LBO = 16;          // unused by the hardware for a swizzled K-major tile
constexpr uint32_t MN_LBO = 0;               // unused for a tile of 64 columns
constexpr int SW_COLS = 64;                  // bf16 columns of one 128-byte swizzle row (a box)
constexpr uint64_t WAIT_LIMIT_NS = 20ull * 1000 * 1000 * 1000;

// ------------------------------------------------------------------ host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library links no libcuda; nullptr when the driver does not have it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over one bf16 [B, H, T, D] operand with element strides sb,
// sh, st (head_dim contiguous): dimensions {D, T, H, B}, a box of
// {64, box_rows, 1, 1}, 128-byte swizzle, zeros outside the tensor. TMA
// needs a 16-byte-aligned base and byte strides that are multiples of 16
// below 2^40 (ops/flash_attention.strided_ok checks them first).
inline cudaError_t encode_bhtd(CUtensorMap* map, const void* base, int B, int H, int T, int D,
                               long long sb, long long sh, long long st, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is
// allocated with 1024 bytes to spare).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((SW128_ATOM_BYTES - (a & (SW128_ATOM_BYTES - 1))) & (SW128_ATOM_BYTES - 1));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// ---- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialized barriers visible to the async proxy (TMA); a
// __syncthreads() follows before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_wait without the time limit: for consumer warpgroups whose registers
// the accumulators need. ptxas (CUDA 12.9) holds a kernel whose such
// consumers carry the trap path to the launch bound's 168 registers, their
// setmaxnreg budget unused; the producer's waits keep the limit, so a
// consumer that never arrives still ends the launch there.
__device__ __forceinline__ void mbar_wait_spin(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// Waits until the barrier's phase of parity `parity` has completed (a
// barrier starts in phase 0; waiting on parity 1 first passes at once). A
// wait longer than WAIT_LIMIT_NS traps, so a wrong parity fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - start > WAIT_LIMIT_NS) __trap();
}

// ---- TMA

// The box of `map` at coordinates {c0, c1, c2, c3} (innermost first) into
// shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A [rows, D] bf16 tile at time t0 of (b, h) into dst as D / 64 boxes of 64
// columns, column block c at dst + c * rows * 64 elements, all completing on
// bar (whose expected bytes count the whole tile).
template <int D>
__device__ __forceinline__ void tma_load_rows(__nv_bfloat16* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int t0, int h, int b) {
  static_assert(D % SW_COLS == 0, "head_dim a multiple of 64");
#pragma unroll
  for (int c = 0; c < D / SW_COLS; ++c)
    tma_load_4d(dst + c * rows * SW_COLS, map, bar, c * SW_COLS, t0, h, b);
}

// ---- setmaxnreg (the whole warpgroup executes it)

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma

// Descriptor of a 128-byte-swizzled tile (layout type 1) whose first row is
// at shared address `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// k-step kk (16 elements of k) of a K-major tile whose 64-column blocks are
// block_bytes apart: four k-steps to a block.
__device__ __forceinline__ uint64_t desc_k_major(const void* tile, int kk, uint32_t block_bytes) {
  return desc_sw128(smem_addr(tile) + (kk / 4) * block_bytes + 32 * (kk % 4), KMAJOR_LBO,
                    SW128_ATOM_BYTES);
}

// k-step kk (16 rows) of an MN-major tile whose 64-column blocks are
// block_bytes apart (MN_LBO for a tile of 64 columns).
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile, int kk,
                                                  uint32_t block_bytes = MN_LBO) {
  return desc_sw128(smem_addr(tile) + 2048 * kk, block_bytes, SW128_ATOM_BYTES);
}

// Makes this thread's shared-memory stores visible to the async proxy, so
// that a wgmma issued after a barrier reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1 to 15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The descriptor `bytes` further along its tile than `desc` (a later k-step,
// column block or ring stage): the start address field counts 16-byte units
// and no shared address carries out of it.
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// desc_advance to k-step kk of a K-major tile (see desc_k_major).
__device__ __forceinline__ uint64_t desc_k_step(uint64_t desc, int kk, uint32_t block_bytes) {
  return desc_advance(desc, (kk / 4) * block_bytes + 32 * (kk % 4));
}

// desc_advance to k-step kk of an MN-major tile (see desc_mn_major).
__device__ __forceinline__ uint64_t desc_mn_step(uint64_t desc, int kk) {
  return desc_advance(desc, 2048 * kk);
}

// 2^x by the multi-function unit alone (ex2.approx.ftz: results below 2^-126
// are 0, where exp2f takes a slower path to keep them as denormals).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Orders register and shared-memory accesses before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers at this point, so the compiler moves no read of
// them above the wgmma_wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of an m64nN product, for thread t of the warpgroup
// (warp w = t / 32, lane l): d[4j + 2h + e] holds row 16w + l/4 + 8h, column
// 8j + 2(l % 4) + e.
//
// The bf16 A fragment for k-step kk (columns 16kk..16kk+15 of such an
// accumulator, read as the A operand of the next product): the same rows
// and columns, so no data moves between threads.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void a_fragments(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
  }
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Stores an m64n64 accumulator, rounded to bf16, as a 64 x 64 tile in the
// TMA layout (128-byte rows, chunk c of row r at chunk c ^ (r % 8); tile on
// a 1024-byte boundary), so a following wgmma reads it K-major as its A
// operand (desc_k_major). Thread t's column pair 8j + 2(l % 4) is 4 bytes
// of chunk j, stored at chunk j ^ (l / 4) of its rows (r % 8 = l / 4): the
// address of chunk l / 4 XOR 16 j. The 8 rows a warp writes at once cover
// the 32 banks once. The caller fences (fence_proxy_async) and synchronizes
// the warpgroup before the wgmma.
__device__ __forceinline__ void store_sw128_tile(void* tile, const float (&d)[32]) {
  const int t = threadIdx.x % 128, l = t % 32;
  const uint32_t row = smem_addr(tile) + (16 * (t / 32) + l / 4) * 128 + 16 * (l / 4) + 4 * (l % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t a = row ^ (16 * j);
    st_shared_b32(a, pack_bf16x2(d[4 * j], d[4 * j + 1]));             // row r
    st_shared_b32(a + 8 * 128, pack_bf16x2(d[4 * j + 2], d[4 * j + 3]));  // row r + 8
  }
}

// The products: scale_d = 0 overwrites D, 1 adds to it. A read from shared
// memory is K-major; B is K-major for TRANS_B = 0 and MN-major for 1.

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 16] (+)= A[64 x 16] . B[16 x 16], A and B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A from registers (a fragment of
// a_fragments), B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A from registers (a fragment
// of a_fragments), B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// The products by width, for code templated on it. wgmma_ss_k: D[64 x N]
// (+)= A . B^T with A and B K-major in shared memory (N = 16, 64 or 128);
// wgmma_rs_mn: D[64 x N] += A . B with A from registers and B MN-major in
// shared memory (N = 64 or 128).
template <int N>
__device__ __forceinline__ void wgmma_ss_k(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  static_assert(N == 16 || N == 64 || N == 128, "m64n{16,64,128}k16");
  if constexpr (N == 16)
    wgmma_m64n16k16_ss<0>(d, desc_a, desc_b, scale_d);
  else if constexpr (N == 64)
    wgmma_m64n64k16_ss<0>(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n128k16_ss<0>(d, desc_a, desc_b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  static_assert(N == 64 || N == 128, "m64n{64,128}k16 with A from registers");
  if constexpr (N == 64)
    wgmma_m64n64k16_rs<1>(d, a, desc_b, 1);
  else
    wgmma_m64n128k16_rs<1>(d, a, desc_b, 1);
}

}  // namespace hopper
