// Sign-flip ternary matmul baseline for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/signflip_matmul.py::
// signflip_matmul (body _signflip_kernel; registry name signflip):
//   y[b, o] = sum_k (w[o, k] > 0 ? x[b, k] : w[o, k] < 0 ? -x[b, k] : 0)
// over int8 trits, one byte per weight: the paper's Fig. 1 baseline, in
// which each multiplier becomes a 3:1 mux of {+x, -x, 0} feeding an adder.
// No multiply: each trit selects an add, a subtract or nothing, in f32.
//
// What bounds it on the H100: the trits stream at 8 bits per weight (five
// times the packed kernels' 1.6), so at decode M the trit bytes over the
// 3.35 TB/s memory rate are the floor; the M*N*K conditional adds over the
// 67 TFLOP/s f32 rate take over from M = 20.  This first design is
// simple and right rather than fast, the skeleton of dequant_matmul.cu:
//   * one block per (128 outputs, BB activation rows), BB the smallest of
//     1, 2, 4, 8 that covers M; the reduction over K is a loop inside the
//     block;
//   * per step of 128 weights the block stages the x slice and the
//     [128, 128] trit tile in shared memory (row stride 132 bytes, 33 words,
//     so the per-thread word reads hit distinct banks) with unrolled,
//     coalesced loads;
//   * each thread owns one output column, reads its trits four at a time
//     (one 32-bit word) and adds, subtracts or skips the staged x of its BB
//     rows (broadcast reads), accumulating in registers.
// Ragged edges are masked: trits past K and rows past M stage as zero,
// columns past N are not stored; nothing is padded.
// Known limits, for the later work that makes it fast: only N/128 blocks at
// decode (latency-bound); byte-wide global loads; trits re-read once per
// BB-row tile at prefill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 128;             // output columns per block == threads
constexpr int BK = 128;             // weights per step
constexpr int WSTRIDE = BK + 4;     // staged trit row stride (33 words)

template <int BB>
__global__ void __launch_bounds__(BO)
signflip_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                float* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[BB * BK];                        // [BB][BK]
  __shared__ __align__(16) int8_t ws[BO * WSTRIDE];    // [BO][BK + 4]

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * BO;
  const int b0 = blockIdx.y * BB;
  const int o = o0 + tid;
  const int nb = min(BB, M - b0);

  float acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int nk = min(BK, K - k0);
    // stage the x slice and the trit tile; past K, N or M they read as zero
#pragma unroll
    for (int i = 0; i < (BB * BK + BO - 1) / BO; ++i) {
      const int e = tid + i * BO;
      if (e < BB * BK) {
        const int b = e / BK;
        const int c = e % BK;
        xs[e] = (b < nb && c < nk)
            ? x[static_cast<size_t>(b0 + b) * K + k0 + c] : 0.f;
      }
    }
    // (32 loads in flight at a time: all 128 at once spill registers)
#pragma unroll 32
    for (int i = 0; i < BK; ++i) {
      const int e = tid + i * BO;
      const int r = e / BK;
      const int c = e % BK;
      const int oo = o0 + r;
      ws[r * WSTRIDE + c] = (oo < N && c < nk)
          ? w[static_cast<size_t>(oo) * K + k0 + c] : static_cast<int8_t>(0);
    }
    __syncthreads();
    // conditional add / subtract, four trits per word
    if (o < N) {
      const uint32_t* wr = reinterpret_cast<const uint32_t*>(ws + tid * WSTRIDE);
#pragma unroll 4
      for (int q = 0; q < (nk + 3) / 4; ++q) {
        const uint32_t t4 = wr[q];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = static_cast<int8_t>((t4 >> (8 * i)) & 0xFFu);
          const float* xc = xs + 4 * q + i;
#pragma unroll
          for (int b = 0; b < BB; ++b) {
            const float v = xc[b * BK];
            acc[b] += t > 0 ? v : (t < 0 ? -v : 0.f);
          }
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
void launch(const void* x, const void* w, void* out, int M, int N, int K,
            cudaStream_t stream) {
  dim3 grid((N + BO - 1) / BO, (M + BB - 1) / BB);
  signflip_kernel<BB><<<grid, BO, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(out), M, N, K);
}

}  // namespace

// x: [M, K] f32; w: [N, K] int8 trits in {-1, 0, 1}; out: [M, N] f32,
// unscaled.  Launches on `stream`; returns the launch error.
extern "C" int signflip_matmul_f32(const void* x, const void* w, void* out,
                                   int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) launch<1>(x, w, out, M, N, K, s);
  else if (M <= 2) launch<2>(x, w, out, M, N, K, s);
  else if (M <= 4) launch<4>(x, w, out, M, N, K, s);
  else launch<8>(x, w, out, M, N, K, s);
  return static_cast<int>(cudaGetLastError());
}
