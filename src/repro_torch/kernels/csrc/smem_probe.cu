// A probe of shared memory's read rate, for the ceiling that
// lut_matmul.cu's note states for lut_gather's table reads (128 bytes a
// clock an SM, a warp's 64-bit read as two wavefronts).  It runs no part of
// the model: launch/smem_rate.py builds and times it.
//
// One block per SM fills a table laid out as the gather's ([16 groups][8
// row pairs][14 entries] float2, 112 bytes a group and row pair), then
// every warp reads it `iters` times, one 64-bit read a lane per group and
// row pair, as the gather does, and sums what it read.  The lanes read
//   pattern 0: entry (5 lane + 3 j) mod 14 of group j: at most 14 distinct
//              entries a read, as the gather's keys give;
//   pattern 1: one entry for all 32 lanes (a broadcast);
//   pattern 2: 32 distinct consecutive float2, 256 bytes a read, from a
//              second table of 256-byte rows (no duplicates).
// Each warp records clock64 (SM cycles) and globaltimer (ns) around its
// loop; the caller takes each block's span.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUPS = 16, PAIRS = 8, T1 = 14;

__device__ __forceinline__ uint64_t ns_now() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int PATTERN>
__global__ void probe(int iters, float* sink, long long* cycles,
                      long long* ns) {
  // pattern 2 reads rows of 32 float2 (256 bytes); the others the
  // gather's rows of 14
  constexpr int ROW = PATTERN == 2 ? 32 : T1;
  __shared__ float2 tbl[GROUPS * PAIRS * ROW];
  for (int e = threadIdx.x; e < GROUPS * PAIRS * ROW; e += blockDim.x)
    tbl[e] = make_float2(e * 0.5f, e * 0.25f);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the shared address of each group's entry for this lane, row pair 0
  uint32_t addr[GROUPS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int t = PATTERN == 0 ? (5 * lane + 3 * j) % T1 : PATTERN == 1 ? j % T1 : lane;
    addr[j] = static_cast<uint32_t>(__cvta_generic_to_shared(tbl + j * PAIRS * ROW + t));
  }
  float a[PAIRS], b[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) a[p] = b[p] = 0.f;
  const long long c0 = clock64();
  const uint64_t t0 = ns_now();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        // volatile: the same addresses every pass, which must not be
        // hoisted out of the loop
        float x, y;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                     : "=f"(x), "=f"(y) : "r"(addr[j] + p * ROW * 8));
        a[p] += x;
        b[p] += y;
      }
  }
  const long long c1 = clock64();
  const uint64_t t1 = ns_now();
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  if (lane == 0) {
    cycles[2 * w] = c0;
    cycles[2 * w + 1] = c1;
    ns[2 * w] = static_cast<long long>(t0);
    ns[2 * w + 1] = static_cast<long long>(t1);
  }
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) sum += a[p] + b[p];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// Launch `blocks` blocks of `threads` threads on `pattern` (0, 1, 2), each
// warp reading 16 x 8 64-bit entries a lane `iters` times.  sink: blocks *
// threads floats; cycles and ns: 2 per warp (start, end).  Returns the
// launch error.
extern "C" int smem_probe(int pattern, int blocks, int threads, int iters,
                          void* sink, void* cycles, void* ns, void* stream) {
  if (pattern < 0 || pattern > 2 || blocks <= 0 || threads <= 0 ||
      threads % 32 != 0 || threads > 1024 || iters <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sink);
  long long* c = static_cast<long long*>(cycles);
  long long* t = static_cast<long long*>(ns);
  if (pattern == 0) probe<0><<<blocks, threads, 0, s>>>(iters, out, c, t);
  else if (pattern == 1) probe<1><<<blocks, threads, 0, s>>>(iters, out, c, t);
  else probe<2><<<blocks, threads, 0, s>>>(iters, out, c, t);
  return static_cast<int>(cudaGetLastError());
}
