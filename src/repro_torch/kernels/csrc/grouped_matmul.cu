// Grouped (batched-expert) packed ternary matmuls for Hopper (sm_90a): the
// MoE expert stacks, one launch for all experts.
//
// Replaces the Pallas TPU kernels of repro/kernels/grouped_matmul.py
// (body _grouped_kernel, padding and call _pad_and_call):
//   * grouped_packed_matmul (registry grouped_dequant), f32 activations:
//       y[e, c, o] = sum_k x[e, c, k] * trit(e, o, k)     (f32 sums)
//   * grouped_w2a8_matmul (registry grouped_w2a8), int8 activations:
//       y[e, c, o] = sum_k x_q[e, c, k] * trit(e, o, k)   (exact int32)
// with trit(e, o, 5j + i) = (byte[e, o, j] / 3^i) % 3 - 1.  The largest
// int32 sum, 6400 * 127 at phi3.5-moe's widest K, is far inside int32.
//
// What bounds it on the H100: every expert's packed bytes (1.6 bits per
// weight) stream on every call, whatever number of tokens an expert got:
// 84 MB per expert stack at phi3.5-moe's shapes, 25 us at 3.35 TB/s.  The
// capacity C (rows per expert) is 1 at decode and 5 at a 32-token
// admission chunk, so the 2*E*C*N*K operations stay near or below that
// (at C = 5 the f32 adds of grouped_dequant, 31 us at 67 TFLOP/s, bind).
//
// Design: the dense kernels (dequant_matmul.cu, w2a8_matmul.cu) with an
// expert grid dimension, not the TPU grid carried over block by block.
// The TPU kernel's sequential K grid axis, which accumulates into the
// output block across grid steps, is a loop inside the block here (blocks
// run in no order, nothing carries over between them):
//   * one block per (128 outputs, BB rows of one expert, expert e =
//     blockIdx.z); BB is the smallest of 1, 2, 4, 8 that covers C, so a
//     decode step (C = 1) computes one row and phi3.5's N = 6400 gives
//     50 x 16 = 800 blocks on 132 SMs (the dense kernel had 5 to 54);
//   * each expert's operands sit at the strides C*K (x), N*NB (bytes) and
//     C*N (out) from the stack's start;
//   * per step of BJ bytes the block stages the x slice of its rows and
//     the [128, BJ] byte tile in shared memory (row stride BJ+4 bytes, an
//     odd word count, so the per-thread reads hit distinct banks), each
//     thread owns one output column and decodes its bytes by div/mod 3:
//     f32 multiply-adds for grouped_dequant, and for grouped_w2a8 four
//     bytes at a time into five words of four int8 trits, five __dp4a a row.
// Ragged K is masked, not padded: byte 0 decodes to five -1 trits, so the
// loop stops at the bytes that cover K (the served rows' 128-byte padding
// is never read) and x stages as zero past K, which zeroes the products of
// a last byte's surplus trits.  Rows past C stage as zero; columns past N
// are not stored.  An expert with no routed tokens has all-zero rows in x
// and still streams its bytes, as the TPU kernel does.
// Known limits, for the later work that makes it fast: byte-wide global
// loads; one 4-warp block per tile with the whole K loop (latency-bound);
// the multiplies on the CUDA cores (a tensor-core version decodes the tile
// to bf16 or int8 in shared memory and issues wgmma).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 128;   // output columns per block == threads
constexpr int TPB = 5;    // trits per byte

template <int BJ>
__device__ __forceinline__ void stage_bytes(uint8_t* ps,
                                            const uint8_t* __restrict__ packed,
                                            int o0, int N, int NB, int j0,
                                            int nj) {
  constexpr int PSTRIDE = BJ + 4;
  // 16 loads in flight a thread: a full unroll holds all BJ bytes in
  // registers at once and spills past 255
#pragma unroll 16
  for (int i = 0; i < BJ; ++i) {
    const int e = threadIdx.x + i * BO;
    const int r = e / BJ;
    const int c = e % BJ;
    const int oo = o0 + r;
    ps[r * PSTRIDE + c] = (oo < N && c < nj)
        ? packed[static_cast<size_t>(oo) * NB + j0 + c] : 0;
  }
}

template <int BB>
__global__ void __launch_bounds__(BO)
grouped_dequant_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ packed,
                       float* __restrict__ out, int C, int N, int K, int NB) {
  constexpr int BJ = BB >= 8 ? 32 : 64;   // bytes per step
  constexpr int BK = BJ * TPB;            // weights per step
  constexpr int PSTRIDE = BJ + 4;         // staged byte row stride
  __shared__ float xs[BB * BK];           // [BB][BK]
  __shared__ uint8_t ps[BO * PSTRIDE];    // [BO][BJ + 4]

  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int o0 = blockIdx.x * BO;
  const int b0 = blockIdx.y * BB;
  const int o = o0 + tid;
  const int nb = min(BB, C - b0);
  const int JB = (K + TPB - 1) / TPB;     // bytes covering the K columns
  x += static_cast<size_t>(e) * C * K;
  packed += static_cast<size_t>(e) * N * NB;
  out += static_cast<size_t>(e) * C * N;

  float acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;

  for (int j0 = 0; j0 < JB; j0 += BJ) {
    const int nj = min(BJ, JB - j0);
#pragma unroll
    for (int i = 0; i < (BB * BK + BO - 1) / BO; ++i) {
      const int t = tid + i * BO;
      if (t < BB * BK) {
        const int b = t / BK;
        const int kk = j0 * TPB + t % BK;
        xs[t] = (b < nb && kk < K)
            ? x[static_cast<size_t>(b0 + b) * K + kk] : 0.f;
      }
    }
    stage_bytes<BJ>(ps, packed, o0, N, NB, j0, nj);
    __syncthreads();
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
__global__ void __launch_bounds__(BO)
grouped_w2a8_kernel(const int8_t* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    int32_t* __restrict__ out, int C, int N, int K, int NB) {
  constexpr int BJ = 64;                  // bytes per step (a multiple of 4)
  constexpr int BK = BJ * TPB;            // weights per step
  constexpr int PSTRIDE = BJ + 4;         // staged byte row stride (17 words)
  __shared__ __align__(16) int8_t xs[BB * BK];          // [BB][BK]
  __shared__ __align__(16) uint8_t ps[BO * PSTRIDE];    // [BO][BJ + 4]

  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int o0 = blockIdx.x * BO;
  const int b0 = blockIdx.y * BB;
  const int o = o0 + tid;
  const int nb = min(BB, C - b0);
  const int JB = (K + TPB - 1) / TPB;
  x += static_cast<size_t>(e) * C * K;
  packed += static_cast<size_t>(e) * N * NB;
  out += static_cast<size_t>(e) * C * N;

  int acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0;

  for (int j0 = 0; j0 < JB; j0 += BJ) {
    const int nj = min(BJ, JB - j0);
#pragma unroll
    for (int i = 0; i < (BB * BK + BO - 1) / BO; ++i) {
      const int t = tid + i * BO;
      if (t < BB * BK) {
        const int b = t / BK;
        const int kk = j0 * TPB + t % BK;
        xs[t] = (b < nb && kk < K)
            ? x[static_cast<size_t>(b0 + b) * K + kk] : static_cast<int8_t>(0);
      }
    }
    stage_bytes<BJ>(ps, packed, o0, N, NB, j0, nj);
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
dim3 grid_of(int E, int C, int N) {
  return dim3((N + BO - 1) / BO, (C + BB - 1) / BB, E);
}

template <int BB>
void launch_dequant(const void* x, const void* packed, void* out, int E,
                    int C, int N, int K, int NB, cudaStream_t stream) {
  grouped_dequant_kernel<BB><<<grid_of<BB>(E, C, N), BO, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(packed),
      static_cast<float*>(out), C, N, K, NB);
}

template <int BB>
void launch_w2a8(const void* x, const void* packed, void* out, int E, int C,
                 int N, int K, int NB, cudaStream_t stream) {
  grouped_w2a8_kernel<BB><<<grid_of<BB>(E, C, N), BO, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<int32_t*>(out), C, N, K, NB);
}

}  // namespace

// x: [E, C, K] f32 (K <= 5*NB; no padding needed); packed: [E, N, NB]
// base-3 bytes; out: [E, C, N] f32, unscaled.  Launches on `stream`;
// returns the launch error.
extern "C" int grouped_dequant_matmul_f32(const void* x, const void* packed,
                                          void* out, int E, int C, int N,
                                          int K, int NB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 1) launch_dequant<1>(x, packed, out, E, C, N, K, NB, s);
  else if (C <= 2) launch_dequant<2>(x, packed, out, E, C, N, K, NB, s);
  else if (C <= 4) launch_dequant<4>(x, packed, out, E, C, N, K, NB, s);
  else launch_dequant<8>(x, packed, out, E, C, N, K, NB, s);
  return static_cast<int>(cudaGetLastError());
}

// x: [E, C, K] int8 (K <= 5*NB); packed: [E, N, NB] base-3 bytes; out:
// [E, C, N] int32, exact and unscaled.  Launches on `stream`; returns the
// launch error.
extern "C" int grouped_w2a8_matmul_i32(const void* x, const void* packed,
                                       void* out, int E, int C, int N, int K,
                                       int NB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 1) launch_w2a8<1>(x, packed, out, E, C, N, K, NB, s);
  else if (C <= 2) launch_w2a8<2>(x, packed, out, E, C, N, K, NB, s);
  else if (C <= 4) launch_w2a8<4>(x, packed, out, E, C, N, K, NB, s);
  else launch_w2a8<8>(x, packed, out, E, C, N, K, NB, s);
  return static_cast<int>(cudaGetLastError());
}
