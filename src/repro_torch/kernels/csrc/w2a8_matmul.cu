// W1.58A8 ternary matmul (int8 activations, exact int32) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/w2a8_matmul.py::w2a8_matmul
// (body _w2a8_kernel; registry name w2a8):
//   y[b, o] = sum_k x_q[b, k] * trit(o, k)      (int8 x trit -> int32, exact)
//   trit(o, 5j + i) = (byte[o, j] / 3^i) % 3 - 1.
// The largest sum, 6912 * 127 at bitnet's widest K, is far inside int32.
//
// What bounds it on the H100: the packed bytes (1.6 bits per weight) over
// the 3.35 TB/s memory rate; the 2*M*N*K integer operations over the
// 1,979 TOP/s int8 rate stay below that up to M near 60.  This
// first design is simple and right rather than fast, the skeleton of
// dequant_matmul.cu with an integer inner product:
//   * one block per (128 outputs, BB activation rows), BB the smallest of
//     1, 2, 4, 8 that covers M; the reduction over K is a loop inside the
//     block;
//   * per step of 64 bytes (320 weights) the block stages the int8 x slice
//     and the [128, 64] byte tile in shared memory (row stride 68 bytes, 17
//     words, so the per-thread word reads hit distinct banks) with unrolled,
//     coalesced loads;
//   * each thread owns one output column; it reads its bytes four at a time
//     (one 32-bit word), decodes the 20 trits by div/mod 3 into five words of
//     four int8 trits, and takes five __dp4a per row against the staged x
//     read as words (20 bytes per 4 packed bytes, so always word-aligned).
// Ragged K is masked, not padded: the loop covers only the bytes that cover
// x's K columns, and x stages as zero past K, so the surplus trits of a last
// byte and the zero bytes staged past it (five -1 trits each) multiply zeros.
// Known limits, for the later work that makes it fast: only N/128 blocks at
// decode (latency-bound); byte-wide global loads; bytes re-read once per
// BB-row tile at prefill; dp4a on the CUDA cores instead of the int8 tensor
// cores (wgmma s8 with the tile decoded to int8 in shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 128;   // output columns per block == threads
constexpr int TPB = 5;    // trits per byte
constexpr int BJ = 64;    // bytes per step (a multiple of 4)
constexpr int BK = BJ * TPB;        // weights per step
constexpr int PSTRIDE = BJ + 4;     // staged byte row stride (17 words)

template <int BB>
__global__ void __launch_bounds__(BO)
w2a8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ packed,
            int32_t* __restrict__ out, int M, int N, int K, int NB) {
  __shared__ __align__(16) int8_t xs[BB * BK];          // [BB][BK]
  __shared__ __align__(16) uint8_t ps[BO * PSTRIDE];    // [BO][BJ + 4]

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * BO;
  const int b0 = blockIdx.y * BB;
  const int o = o0 + tid;
  const int nb = min(BB, M - b0);
  const int JB = (K + TPB - 1) / TPB;     // bytes covering the K columns

  int acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0;

  for (int j0 = 0; j0 < JB; j0 += BJ) {
    const int nj = min(BJ, JB - j0);
    // stage the x slice (zero past K and past M) and the byte tile (zero
    // past N and past the covering bytes)
#pragma unroll
    for (int i = 0; i < (BB * BK + BO - 1) / BO; ++i) {
      const int e = tid + i * BO;
      if (e < BB * BK) {
        const int b = e / BK;
        const int kk = j0 * TPB + e % BK;
        xs[e] = (b < nb && kk < K)
            ? x[static_cast<size_t>(b0 + b) * K + kk] : static_cast<int8_t>(0);
      }
    }
#pragma unroll
    for (int i = 0; i < BJ; ++i) {
      const int e = tid + i * BO;
      const int r = e / BJ;
      const int c = e % BJ;
      const int oo = o0 + r;
      ps[r * PSTRIDE + c] = (oo < N && c < nj)
          ? packed[static_cast<size_t>(oo) * NB + j0 + c] : 0;
    }
    __syncthreads();
    if (o < N) {
      const uint32_t* pr = reinterpret_cast<const uint32_t*>(ps + tid * PSTRIDE);
      const int* xw = reinterpret_cast<const int*>(xs);
#pragma unroll 2
      for (int q = 0; q < (nj + 3) / 4; ++q) {
        // four bytes -> 20 trits -> five words of four int8 trits
        const uint32_t v4 = pr[q];
        unsigned w[TPB] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll
        for (int byte = 0; byte < 4; ++byte) {
          unsigned v = (v4 >> (8 * byte)) & 0xFFu;
#pragma unroll
          for (int i = 0; i < TPB; ++i) {
            const int t = byte * TPB + i;
            const int trit = static_cast<int>(v % 3u) - 1;
            v /= 3u;
            w[t / 4] |= (static_cast<unsigned>(trit) & 0xFFu) << (8 * (t % 4));
          }
        }
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          const int* xb = xw + (b * BK + q * 4 * TPB) / 4;
#pragma unroll
          for (int i = 0; i < TPB; ++i)
            acc[b] = __dp4a(xb[i], static_cast<int>(w[i]), acc[b]);
        }
      }
    }
    __syncthreads();
  }
  if (o < N) {
#pragma unroll
    for (int b = 0; b < BB; ++b)
      if (b < nb) out[static_cast<size_t>(b0 + b) * N + o] = acc[b];
  }
}

template <int BB>
void launch(const void* x, const void* packed, void* out, int M, int N, int K,
            int NB, cudaStream_t stream) {
  dim3 grid((N + BO - 1) / BO, (M + BB - 1) / BB);
  w2a8_kernel<BB><<<grid, BO, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<int32_t*>(out), M, N, K, NB);
}

}  // namespace

// x: [M, K] int8 (K <= 5*NB; no padding needed); packed: [N, NB] base-3
// bytes; out: [M, N] int32, exact and unscaled.  Launches on `stream`;
// returns the launch error.
extern "C" int w2a8_matmul_s32(const void* x, const void* packed, void* out,
                               int M, int N, int K, int NB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) launch<1>(x, packed, out, M, N, K, NB, s);
  else if (M <= 2) launch<2>(x, packed, out, M, N, K, NB, s);
  else if (M <= 4) launch<4>(x, packed, out, M, N, K, NB, s);
  else launch<8>(x, packed, out, M, N, K, NB, s);
  return static_cast<int>(cudaGetLastError());
}
