// Packed base-3 dequant ternary matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dequant_matmul.py::packed_matmul
// (body _dequant_kernel, decode _unpack_block; registry name dequant_packed):
//   y[b, o] = sum_k x[b, k] * trit(o, k),
//   trit(o, 5j + i) = (byte[o, j] / 3^i) % 3 - 1,
// the paper's dequant baseline: every weight is decoded to a number and
// multiplied, with f32 accumulation.
//
// What bounds it on the H100: the packed bytes (1.6 bits per weight) over
// the 3.35 TB/s memory rate at M = 1; from M = 2 on, the 2*M*N*K flops of
// the multiply-adds over the 67 TFLOP/s f32 rate of the CUDA cores (the
// multiplies of the baseline are the point of it).  This first design is
// simple and right rather than fast, the same skeleton as lut_matmul.cu:
//   * one block per (128 outputs, BB activation rows), BB the smallest of
//     1, 2, 4, 8 that covers M; the reduction over K is a loop inside the
//     block (no atomics, deterministic sums);
//   * per step of BJ bytes (5*BJ weights; BJ = 64, or 32 at BB = 8) the
//     block stages the x slice in shared memory with coalesced loads and the
//     [128, BJ] byte tile (row stride BJ+4 bytes, an odd word count, so the
//     per-thread byte reads hit distinct banks), each with unrolled loads so
//     a thread's loads are in flight together;
//   * each thread owns one output column, decodes each staged byte into its
//     five trits by div/mod 3 (as _unpack_block does) and multiply-adds them
//     against the staged x of its BB rows (broadcast reads) in registers.
// Ragged K is masked, not padded: byte 0 decodes to five -1 trits, so the
// loop stops at the bytes that cover x's K columns (the served rows' 128-byte
// padding is never read) and x stages as zero past K, which zeroes the
// products of a last byte's surplus trits.  Rows past M stage as zero;
// columns past N are not stored.
// Known limits, for the later work that makes it fast: only N/128 blocks at
// decode (5 to 54 at bitnet's shapes, on 132 SMs), each a single 4-warp
// block with the whole K loop (latency-bound); byte-wide global loads; bytes
// re-read once per BB-row tile at prefill; the multiplies stay on the CUDA
// cores (a tensor-core version decodes the tile to bf16 in shared memory
// and issues wgmma).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 128;   // output columns per block == threads
constexpr int TPB = 5;    // trits per byte

template <int BB>
__global__ void __launch_bounds__(BO)
dequant_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
               float* __restrict__ out, int M, int N, int K, int NB) {
  constexpr int BJ = BB >= 8 ? 32 : 64;   // bytes per step
  constexpr int BK = BJ * TPB;            // weights per step
  constexpr int PSTRIDE = BJ + 4;         // staged byte row stride
  __shared__ float xs[BB * BK];           // [BB][BK]
  __shared__ uint8_t ps[BO * PSTRIDE];    // [BO][BJ + 4]

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * BO;
  const int b0 = blockIdx.y * BB;
  const int o = o0 + tid;
  const int nb = min(BB, M - b0);
  const int JB = (K + TPB - 1) / TPB;     // bytes covering the K columns

  float acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;

  for (int j0 = 0; j0 < JB; j0 += BJ) {
    const int nj = min(BJ, JB - j0);
    // stage the x slice (zero past K and past M) and the byte tile
#pragma unroll
    for (int i = 0; i < (BB * BK + BO - 1) / BO; ++i) {
      const int e = tid + i * BO;
      if (e < BB * BK) {
        const int b = e / BK;
        const int kk = j0 * TPB + e % BK;
        xs[e] = (b < nb && kk < K)
            ? x[static_cast<size_t>(b0 + b) * K + kk] : 0.f;
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
    // decode and multiply-accumulate: five div/mod-3 trits per byte
    if (o < N) {
      const uint8_t* pr = ps + tid * PSTRIDE;
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        unsigned v = pr[j];
#pragma unroll
        for (int i = 0; i < TPB; ++i) {
          const float w = static_cast<float>(static_cast<int>(v % 3u) - 1);
          v /= 3u;
          const float* xc = xs + j * TPB + i;
#pragma unroll
          for (int b = 0; b < BB; ++b) acc[b] = fmaf(xc[b * BK], w, acc[b]);
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
  dequant_kernel<BB><<<grid, BO, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(packed),
      static_cast<float*>(out), M, N, K, NB);
}

}  // namespace

// x: [M, K] f32 (K <= 5*NB; no padding needed); packed: [N, NB] base-3
// bytes; out: [M, N] f32, unscaled.  Launches on `stream`; returns the
// launch error.
extern "C" int dequant_packed_matmul_f32(const void* x, const void* packed,
                                         void* out, int M, int N, int K,
                                         int NB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) launch<1>(x, packed, out, M, N, K, NB, s);
  else if (M <= 2) launch<2>(x, packed, out, M, N, K, NB, s);
  else if (M <= 4) launch<4>(x, packed, out, M, N, K, NB, s);
  else launch<8>(x, packed, out, M, N, K, NB, s);
  return static_cast<int>(cudaGetLastError());
}
