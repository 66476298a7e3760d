// One vote bucket's health counts on NVIDIA Hopper: the margin histogram of
// its tally and the count of coordinates whose local ballot lost.
//
// Replaces the Pallas TPU kernel distributed_lion_tpu/ops/pallas_lion.py:233
// (bucket_vote_stats; _stats_kernel :206, pallas_call :255):
//   bin(t) = min(|t| * nbins // world, nbins - 1)   hist[bin(t)] += 1
//   disagree += (ballot > 0) != (t > 0)
// over n coordinates of int8 ballots and an int8 or int32 tally, into
// out[nbins + 1] int32 (the last slot is the disagreement count), which the
// caller zeroes.
//
// Bound: each coordinate is read once and nothing is written but the
// nbins + 1 counts, so on an H100 SXM it is bytes-bound: 2 B a coordinate
// with an int8 tally (0.074 ms at GPT-2 124M's 124,439,808), 5 B with an
// int32 one. Per coordinate the work is one lookup into a small fixed set of
// bins, so the design keeps the instruction count per byte low enough for
// the loads to set the pace:
// - a grid-stride loop over a few blocks per SM; each thread loads 32
//   coordinates a step as 16-byte vectors (a bucket's window may start at
//   any byte offset of its flat buffer: the coordinates before the ballots'
//   first 16-byte boundary and after the last whole step go through a
//   scalar loop, and so does every coordinate when the tally's offset does
//   not line up with the ballots');
// - the counters live in registers: eight 8-bit lanes in two 32-bit words,
//   one lane per bin, to which a coordinate adds the increment that a
//   256-entry shared-memory table holds for its tally (indexed by the raw
//   int8 tally byte, or by min(|t|, world) for an int32 tally when world is
//   below 256; above that the bin is divided out). The lanes are emptied
//   into 32-bit counters before they can reach 256.
// - the disagreement of an int8 tally is counted four coordinates at a time
//   on packed bytes (a byte is > 0 when its low seven bits are not all zero
//   and its sign bit is clear), with one popcount;
// - the block sums its threads' counters by __reduce_add_sync within each
//   warp and through shared memory across warps, then adds one atomic per
//   bin to out. The counts are exact integers, so the result does not
//   depend on the order.
// The bin count is a template parameter (at most 8 lanes); 8 (the port's
// telemetry.NBINS) is instantiated.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int STEP = 32;        // coordinates a thread loads per vector step
constexpr int LANE_MAX = 255;   // an 8-bit lane's largest count
constexpr int TABLE = 256;

constexpr int MAX_WORLD = 1 << 28;  // a * NBINS below 2^31 for every a <= world

// margin_bins' rule for a = |t|; a is clipped to world first (every larger
// |t| lands in the top bin too), so the product fits 32 bits.
template <int NBINS>
__device__ __forceinline__ int bin_of(unsigned a, int world) {
  const unsigned b = (a < (unsigned)world ? a : (unsigned)world) * NBINS / (unsigned)world;
  return b < NBINS - 1 ? (int)b : NBINS - 1;
}

// The increment of bin k: lanes 0-3 in the first word, 4-7 in the second.
__device__ __forceinline__ uint2 lane_one(int k) {
  return k < 4 ? make_uint2(1u << (8 * k), 0u) : make_uint2(0u, 1u << (8 * (k - 4)));
}

// Per-byte "x > 0" of four packed int8 values: bit 7 of each byte.
__device__ __forceinline__ uint32_t positive4(uint32_t x) {
  return ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) & ~x & 0x80808080u;
}

template <int NBINS>
struct Counts {
  uint32_t lo = 0, hi = 0;  // 8-bit lanes
  int pending = 0;          // coordinates added to the lanes since they were emptied
  int bins[NBINS] = {};
  int disagree = 0;

  __device__ __forceinline__ void empty_lanes() {
#pragma unroll
    for (int k = 0; k < NBINS; ++k) bins[k] += ((k < 4 ? lo : hi) >> (8 * (k % 4))) & 0xFFu;
    lo = hi = 0;
    pending = 0;
  }
  // Room in the lanes for m more coordinates.
  __device__ __forceinline__ void reserve(int m) {
    if (pending + m > LANE_MAX) empty_lanes();
    pending += m;
  }
  __device__ __forceinline__ void add(uint2 inc) {
    lo += inc.x;
    hi += inc.y;
  }
};

template <typename T>
__device__ __forceinline__ unsigned magnitude(T t) {
  return t < 0 ? 0u - (unsigned)t : (unsigned)t;
}

// The table slot of tally t (see the file's note).
template <typename T>
__device__ __forceinline__ unsigned slot(T t, int world) {
  if constexpr (sizeof(T) == 1) {
    return (uint8_t)t;
  } else {
    const unsigned a = magnitude(t);
    return a < (unsigned)world ? a : (unsigned)world;
  }
}

template <typename T, int NBINS, bool DIVIDE>
__device__ __forceinline__ void count_one(Counts<NBINS>& c, const uint2* table, int8_t b, T t,
                                          int world) {
  if constexpr (DIVIDE)
    c.add(lane_one(bin_of<NBINS>(magnitude(t), world)));
  else
    c.add(table[slot(t, world)]);
  c.disagree += (b > 0) != (t > 0);
}

// DIVIDE: an int32 tally with world >= TABLE, binned by division.
template <typename T, int NBINS, bool DIVIDE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
vote_stats_kernel(const int8_t* __restrict__ ballots, const T* __restrict__ tally,
                  int* __restrict__ out, long long n, int world) {
  static_assert(NBINS >= 1 && NBINS <= 8, "eight 8-bit lanes");
  __shared__ uint2 table[TABLE];
  __shared__ int warp_sums[THREADS / 32][NBINS + 1];

  for (int i = threadIdx.x; i < TABLE; i += THREADS) {
    const unsigned a = sizeof(T) == 1 ? magnitude((int8_t)i) : (unsigned)i;
    table[i] = lane_one(bin_of<NBINS>(a, world));
  }
  __syncthreads();

  // [0, head) and [head + steps * STEP, n) go through the scalar loop
  long long head = (16 - (long long)((uintptr_t)ballots % 16)) % 16;
  if (head > n) head = n;
  if ((uintptr_t)(tally + head) % 16 != 0) head = n;  // the tally does not line up: all scalar
  const long long steps = (n - head) / STEP;
  const long long body_end = head + steps * STEP;

  Counts<NBINS> c;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;

  for (long long v = tid; v < steps; v += stride) {
    const long long e0 = head + v * STEP;
    const uint4* bp = reinterpret_cast<const uint4*>(ballots + e0);
    const uint4* tp = reinterpret_cast<const uint4*>(tally + e0);
    constexpr int TV = STEP * (int)sizeof(T) / 16;  // tally vectors per step
    uint4 bv[2], tv[TV];
#pragma unroll
    for (int i = 0; i < 2; ++i) bv[i] = __ldg(bp + i);
#pragma unroll
    for (int i = 0; i < TV; ++i) tv[i] = __ldg(tp + i);
    c.reserve(STEP);
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(bv);
    if constexpr (sizeof(T) == 1) {
      const uint32_t* tw = reinterpret_cast<const uint32_t*>(tv);
#pragma unroll
      for (int w = 0; w < STEP / 4; ++w) {
        c.disagree += __popc(positive4(bw[w]) ^ positive4(tw[w]));
#pragma unroll
        for (int e = 0; e < 4; ++e) c.add(table[(tw[w] >> (8 * e)) & 0xFFu]);
      }
    } else {
      const T* tt = reinterpret_cast<const T*>(tv);
      const int8_t* bb = reinterpret_cast<const int8_t*>(bv);
#pragma unroll
      for (int e = 0; e < STEP; ++e) count_one<T, NBINS, DIVIDE>(c, table, bb[e], tt[e], world);
    }
  }

  const long long scalars = head + (n - body_end);
  for (long long i = tid; i < scalars; i += stride) {
    const long long e = i < head ? i : body_end + (i - head);
    c.reserve(1);
    count_one<T, NBINS, DIVIDE>(c, table, ballots[e], tally[e], world);
  }
  c.empty_lanes();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k <= NBINS; ++k) {
    const int sum = __reduce_add_sync(0xffffffffu, k < NBINS ? c.bins[k] : c.disagree);
    if (lane == 0) warp_sums[warp][k] = sum;
  }
  __syncthreads();
  if (threadIdx.x <= NBINS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) sum += warp_sums[w][threadIdx.x];
    if (sum != 0) atomicAdd(out + threadIdx.x, sum);
  }
}

int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    counts[device] = 0;
  return counts[device];
}

template <typename T>
int launch(const void* ballots, const void* tally, void* out, long long n, int world, int nbins,
           int device, void* stream) {
  if (nbins != 8 || world < 1 || world > MAX_WORLD || n < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidDevice;
  const long long want = (n / STEP + THREADS - 1) / THREADS + 1;
  const int blocks = (int)(want < (long long)sms * BLOCKS_PER_SM ? want : sms * BLOCKS_PER_SM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const int8_t*>(ballots);
  const auto t = static_cast<const T*>(tally);
  const auto o = static_cast<int*>(out);
  if constexpr (sizeof(T) > 1) {
    if (world >= TABLE) {
      vote_stats_kernel<T, 8, true><<<blocks, THREADS, 0, s>>>(b, t, o, n, world);
      return cudaGetLastError();
    }
  }
  vote_stats_kernel<T, 8, false><<<blocks, THREADS, 0, s>>>(b, t, o, n, world);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vote_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ballots int8 [n], tally int8 [n], out int32 [nbins + 1] zeroed; nbins 8
// only, 1 <= world <= 2^28.
int vote_stats_int8(const void* ballots, const void* tally, void* out, long long n, int world,
                    int nbins, int device, void* stream) {
  return launch<int8_t>(ballots, tally, out, n, world, nbins, device, stream);
}

// ballots int8 [n], tally int32 [n], out int32 [nbins + 1] zeroed; nbins 8
// only, 1 <= world <= 2^28.
int vote_stats_int32(const void* ballots, const void* tally, void* out, long long n, int world,
                     int nbins, int device, void* stream) {
  return launch<int32_t>(ballots, tally, out, n, world, nbins, device, stream);
}

}  // extern "C"
