// TL2 two-trit LUT ternary matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/tl2_matmul.py::tl2_matmul
// (body _tl2_kernel; registry name tl2):
//   y[b, o] = sum_q table[b, q, digit(o, q)]
//   table[b, q, d] = (d/3 - 1) * x[b, 2q] + (d%3 - 1) * x[b, 2q + 1]
// where trit pairs are base-9 digits, five per 16-bit word
// (word = sum_p d_p * 9^p, 1.6 bits per weight), f32 accumulation.
//
// What bounds it on the H100: at decode M the work is a stream over the
// weight words (2 bytes per 10 weights) against five table reads per word
// and row, so the word bytes over the 3.35 TB/s memory rate are the floor.
// This first design is simple and right rather than fast:
//   * one block per (128 outputs, BB activation rows), BB the smallest of
//     1, 2, 4, 8 that covers M; the reduction over words is a loop inside
//     the block;
//   * per step of BW words (5*BW pairs; BW = 64, 64, 32, 16 for BB = 1, 2,
//     4, 8, so the tables stay near 23 KB) the block stages the x slice in
//     shared memory with coalesced loads, builds the [BB, 5*BW, 9] f32 pair
//     tables there, and stages the [128, BW] word tile (row stride BW+2
//     halfwords, an odd word count, so the per-thread word reads hit
//     distinct banks), each with unrolled loads so a thread's loads are in
//     flight together;
//   * each thread owns one output column, decodes each word into its five
//     digits by div/mod 9 and accumulates table[b][q][d] in registers.
// Word 0 decodes to (-1, -1) pairs, so the tail is masked by W (the loop
// never visits a word past W) rather than padded, and the caller zero-pads x
// to W*10 columns.  With int8 activations every table entry and partial sum
// is an integer below 2^24, so the result is exact.
// Known limits, for the later work that makes it fast: only N/128 blocks at
// decode, each a single 4-warp block with the whole K loop (latency-bound);
// words re-read once per BB-row tile at prefill; the div/mod-9 decode on
// the fetch path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 128;    // output columns per block == threads
constexpr int PAIRS = 5;   // base-9 digits per word

template <int BB>
__global__ void __launch_bounds__(BO)
tl2_kernel(const float* __restrict__ x, const uint16_t* __restrict__ words,
           float* __restrict__ out, int M, int N, int W) {
  constexpr int BW = BB >= 8 ? 16 : (BB == 4 ? 32 : 64);  // words per step
  constexpr int BQ = BW * PAIRS;                           // pairs per step
  constexpr int WSTRIDE = BW + 2;                          // staged row stride
  __shared__ float xs[BB * BQ * 2];         // [BB][BQ][2]
  __shared__ float tables[BB * BQ * 9];     // [BB][BQ][9]
  __shared__ uint16_t ws[BO * WSTRIDE];     // [BO][BW + 2]

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * BO;
  const int b0 = blockIdx.y * BB;
  const int o = o0 + tid;
  const int nb = min(BB, M - b0);
  const size_t K = static_cast<size_t>(W) * 2 * PAIRS;

  float acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;

  for (int w0 = 0; w0 < W; w0 += BW) {
    const int nw = min(BW, W - w0);
    // stage the x slice and the word tile, with unrolled loads so a
    // thread's loads are in flight together; rows past M and words past W
    // read as zero
#pragma unroll
    for (int i = 0; i < (BB * BQ * 2 + BO - 1) / BO; ++i) {
      const int e = tid + i * BO;
      if (e < BB * BQ * 2) {
        const int b = e / (BQ * 2);
        const int c = e % (BQ * 2);
        xs[e] = (b < nb && c < nw * PAIRS * 2)
            ? x[(b0 + b) * K + static_cast<size_t>(w0) * PAIRS * 2 + c] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < BW; ++i) {
      const int e = tid + i * BO;
      const int r = e / BW;
      const int c = e % BW;
      const int oo = o0 + r;
      ws[r * WSTRIDE + c] = (oo < N && c < nw)
          ? words[static_cast<size_t>(oo) * W + w0 + c] : 0;
    }
    __syncthreads();
    // build phase: 9-entry table per trit pair
    for (int e = tid; e < BB * BQ * 9; e += BO) {
      const int d = e % 9;
      const float* xr = xs + (e / 9) * 2;
      const int t0 = d / 3 - 1;
      const int t1 = d % 3 - 1;
      float s = 0.f;
      if (t0 > 0) s += xr[0];
      else if (t0 < 0) s -= xr[0];
      if (t1 > 0) s += xr[1];
      else if (t1 < 0) s -= xr[1];
      tables[e] = s;
    }
    __syncthreads();
    // fetch phase: five div/mod-9 digits per word, one table read per row
    if (o < N) {
      const uint16_t* wr = ws + tid * WSTRIDE;
#pragma unroll 4
      for (int w = 0; w < nw; ++w) {
        unsigned v = wr[w];
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) {
          const unsigned d = v % 9u;
          v /= 9u;
          const float* tq = tables + (w * PAIRS + p) * 9 + d;
#pragma unroll
          for (int b = 0; b < BB; ++b) acc[b] += tq[b * BQ * 9];
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
void launch(const void* x, const void* words, void* out, int M, int N, int W,
            cudaStream_t stream) {
  dim3 grid((N + BO - 1) / BO, (M + BB - 1) / BB);
  tl2_kernel<BB><<<grid, BO, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint16_t*>(words),
      static_cast<float*>(out), M, N, W);
}

}  // namespace

// x: [M, W*10] f32 (zero-padded past the logical K); words: [N, W] 16-bit
// TL2 words (held as int16 by the caller, read here as unsigned);
// out: [M, N] f32, unscaled.  Launches on `stream`; returns the launch error.
extern "C" int tl2_matmul_f32(const void* x, const void* words, void* out,
                              int M, int N, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) launch<1>(x, words, out, M, N, W, s);
  else if (M <= 2) launch<2>(x, words, out, M, N, W, s);
  else if (M <= 4) launch<4>(x, words, out, M, N, W, s);
  else launch<8>(x, words, out, M, N, W, s);
  return static_cast<int>(cudaGetLastError());
}
