// Two-phase LUT ternary matmul for Hopper (sm_90a), with both fetch
// lowerings of the reference.
//
// Replaces the Pallas TPU kernel repro/kernels/lut_matmul.py::lut_matmul
// (body _lut_kernel), both of its fetches:
//   * fetch="gather" (registry name lut_gather, entry lut_gather_matmul_f32):
//       y[b, o] = sum_g sign(key[o, g]) * table[b, g, idx(key[o, g])]
//   * fetch="onehot" (registry name lut_onehot, entry lut_onehot_matmul_f32):
//       y[b, o] = sum_g sum_t table[b, g, t] * onehot[o, g, t],
//       onehot[o, g, t] = sign(key[o, g]) if t == idx(key[o, g]) else 0,
//     the contraction of the tables with the signed one-hot over all T+1
//     entries (the MXU form on the TPU; here f32 FMAs on the CUDA cores);
//   table[b, g, t] = dot(C[t], x[b, g*mu : (g+1)*mu])   (t < T; entry T = 0)
// with key = sym << idx_bits | idx, C the [T+1, mu] combo matrix of the
// positive-half ternary combos (row T all zero) and f32 accumulation.  Both
// fetches give the same sums: every one-hot product but one is a signed zero.
//
// What bounds it on the H100: at decode M (a handful of rows) the work is a
// stream over the weight keys, one byte per mu=3 group (2.67 bits per
// weight), against a few table reads per key, so the key bytes over the
// 3.35 TB/s memory rate are the floor.  This first design is simple and
// right rather than fast:
//   * one block per (128 outputs, BB activation rows), BB the smallest of
//     1, 2, 4, 8 that covers M (no table work for rows that do not exist);
//     the reduction over groups is a loop inside the block (blocks run in no
//     order, so nothing carries between them and no atomics are needed);
//   * per step of BG groups the block stages the x slice in shared memory
//     with coalesced loads, builds the [BB, BG, T+1] f32 tables there from
//     the combo matrix (also in shared memory), and stages the [128, BG] key
//     tile (row stride BG+4 bytes, an odd word count, so the per-thread key
//     reads hit distinct banks), each with unrolled loads so a thread's loads
//     are in flight together;
//   * each thread owns one output column o, splits its key into sym/idx,
//     reads tables[b][g][idx] for its BB rows and accumulates +-v in
//     registers.
// Ragged edges are masked: rows past M and groups past G never read global
// memory (masked keys take the zero key T, whose entry is 0), columns past N
// are not stored.  The caller zero-pads x to G*mu columns.
// Known limits, for the later work that makes it fast: only N/128 blocks at
// decode (5 to 54 at bitnet's shapes, on 132 SMs), each a single 4-warp
// block with the whole K loop, so it is bound by latency rather than bytes;
// keys re-read once per BB-row tile at prefill; no asynchronous copies.
// The one-hot fetch does T+1 = 14 FMAs per key and row where the gather
// does one read, so it is bound by those operations (2*M*N*G*14 flops over
// the 67 TFLOP/s f32 rate, above the key bytes' time at every M); a
// tensor-core version (TF32, or bf16-split tables) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 128;                  // output columns per block == threads
constexpr int SMEM_BUDGET = 40 * 1024;   // bytes of tables + tiles per block

__host__ __device__ constexpr int pow3(int n) {
  return n == 0 ? 1 : 3 * pow3(n - 1);
}
__host__ __device__ constexpr int pow2_floor(int v) {
  return v >= 2 ? 2 * pow2_floor(v / 2) : 1;
}
__host__ __device__ constexpr int log2i(int v) {
  return v > 1 ? 1 + log2i(v / 2) : 0;
}
__host__ __device__ constexpr int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int MU>
struct Lut {
  static constexpr int T1 = (pow3(MU) + 1) / 2;   // T stored entries + zero
  static constexpr int T = T1 - 1;
  static constexpr int IB = log2i(2 * T1 - 1);     // ceil(log2(T1)), >= 1
};

// groups per reduction step: a power of two in [8, 64] whose shared tiles
// fit the budget
template <int MU, int BB>
__host__ __device__ constexpr int step_groups() {
  return clampi(pow2_floor(SMEM_BUDGET /
                           (BB * Lut<MU>::T1 * 4 + BO + BB * MU * 4)), 8, 64);
}

template <int MU, int BB, bool ONEHOT>
__global__ void __launch_bounds__(BO)
lut_kernel(const float* __restrict__ x, const uint8_t* __restrict__ keys,
                  float* __restrict__ out, int M, int N, int G) {
  constexpr int T1 = Lut<MU>::T1;
  constexpr int T = Lut<MU>::T;
  constexpr int IB = Lut<MU>::IB;
  constexpr int BG = step_groups<MU, BB>();
  constexpr int LG = log2i(BG);
  constexpr int KSTRIDE = BG + 4;
  __shared__ float C[T1 * MU];              // [T1][MU], row T all zero
  __shared__ float xs[BB * BG * MU];        // [BB][BG][MU]
  __shared__ float tables[BB * BG * T1];    // [BB][BG][T1]
  __shared__ uint8_t ks[BO * KSTRIDE];      // [BO][BG + 4]

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * BO;
  const int b0 = blockIdx.y * BB;
  const int o = o0 + tid;
  const int nb = min(BB, M - b0);
  const size_t K = static_cast<size_t>(G) * MU;

  // combo matrix: row t < T holds the base-3 digits of T + 1 + t, minus 1
  for (int e = tid; e < T1 * MU; e += BO) {
    const int t = e / MU;
    int v = T + 1 + t;
    for (int i = 0; i < e % MU; ++i) v /= 3;
    C[e] = t < T ? static_cast<float>(v % 3 - 1) : 0.f;
  }

  float acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;

  for (int g0 = 0; g0 < G; g0 += BG) {
    const int ng = min(BG, G - g0);
    // stage the x slice and the key tile.  The loops have compile-time trip
    // counts and are unrolled, so every load of a thread is in flight at
    // once instead of one memory latency per element.  Rows past M and
    // groups past G read as zero; masked keys take the zero key T.
#pragma unroll
    for (int i = 0; i < (BB * BG * MU + BO - 1) / BO; ++i) {
      const int e = tid + i * BO;
      if (e < BB * BG * MU) {
        const int b = e / (BG * MU);
        const int c = e % (BG * MU);
        xs[e] = (b < nb && c < ng * MU)
            ? x[(b0 + b) * K + static_cast<size_t>(g0) * MU + c] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < BG; ++i) {
      const int e = tid + i * BO;
      const int r = e >> LG;
      const int c = e & (BG - 1);
      const int oo = o0 + r;
      ks[r * KSTRIDE + c] = (oo < N && c < ng)
          ? keys[static_cast<size_t>(oo) * G + g0 + c] : static_cast<uint8_t>(T);
    }
    __syncthreads();
    // build phase: tables[b][g][t] = sum_i C[t][i] * x[b][g][i]
    for (int e = tid; e < BB * BG * T1; e += BO) {
      const float* xr = xs + (e / T1) * MU;
      const float* cr = C + (e % T1) * MU;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MU; ++i) s += cr[i] * xr[i];
      tables[e] = s;
    }
    __syncthreads();
    // fetch phase
    if (o < N) {
      const uint8_t* kr = ks + tid * KSTRIDE;
      if constexpr (ONEHOT) {
        // signed one-hot over the T+1 entries, contracted with each row's
        // tables (the same table entries for every thread: broadcast reads)
#pragma unroll 2
        for (int g = 0; g < ng; ++g) {
          const int key = kr[g];
          const int idx = key & ((1 << IB) - 1);
          const float sgn = (key >> IB) != 0 ? -1.f : 1.f;
          float oh[T1];
#pragma unroll
          for (int t = 0; t < T1; ++t) oh[t] = t == idx ? sgn : 0.f;
#pragma unroll
          for (int b = 0; b < BB; ++b) {
            const float* tb = tables + (b * BG + g) * T1;
#pragma unroll
            for (int t = 0; t < T1; ++t) acc[b] = fmaf(tb[t], oh[t], acc[b]);
          }
        }
      } else {
        // gather: one key per group, one table read per row
#pragma unroll 8
        for (int g = 0; g < ng; ++g) {
          const int key = kr[g];
          const float* tg = tables + g * T1 + (key & ((1 << IB) - 1));
          const bool neg = (key >> IB) != 0;
#pragma unroll
          for (int b = 0; b < BB; ++b) {
            const float v = tg[b * BG * T1];
            acc[b] += neg ? -v : v;
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

template <int MU, int BB, bool ONEHOT>
void launch(const void* x, const void* keys, void* out, int M, int N, int G,
            cudaStream_t stream) {
  dim3 grid((N + BO - 1) / BO, (M + BB - 1) / BB);
  lut_kernel<MU, BB, ONEHOT><<<grid, BO, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(keys),
      static_cast<float*>(out), M, N, G);
}

template <int MU, bool ONEHOT>
void launch_rows(const void* x, const void* keys, void* out, int M, int N,
                 int G, cudaStream_t stream) {
  if (M <= 1) launch<MU, 1, ONEHOT>(x, keys, out, M, N, G, stream);
  else if (M <= 2) launch<MU, 2, ONEHOT>(x, keys, out, M, N, G, stream);
  else if (M <= 4) launch<MU, 4, ONEHOT>(x, keys, out, M, N, G, stream);
  else launch<MU, 8, ONEHOT>(x, keys, out, M, N, G, stream);
}

}  // namespace

// Both entry points: x: [M, G*mu] f32 (zero-padded past the logical K);
// keys: [N, G] uint8; out: [M, N] f32, unscaled.  Built for mu = 3 only, the
// group size of every configuration the port serves.  Launch on `stream`;
// return the launch error (cudaErrorInvalidValue for any other mu).
extern "C" int lut_gather_matmul_f32(const void* x, const void* keys, void* out,
                                     int M, int N, int G, int mu,
                                     void* stream) {
  if (mu != 3) return static_cast<int>(cudaErrorInvalidValue);
  launch_rows<3, false>(x, keys, out, M, N, G,
                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lut_onehot_matmul_f32(const void* x, const void* keys, void* out,
                                     int M, int N, int G, int mu,
                                     void* stream) {
  if (mu != 3) return static_cast<int>(cudaErrorInvalidValue);
  launch_rows<3, true>(x, keys, out, M, N, G,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
