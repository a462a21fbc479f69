// Sign-flip ternary matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/signflip_matmul.py::
// signflip_matmul (body _signflip_kernel; registry name signflip):
//   y[b, o] = sum_k (w[o, k] > 0 ? x[b, k] : w[o, k] < 0 ? -x[b, k] : 0)
//           = x @ [w == +1]^T - x @ [w == -1]^T
// over int8 trits, one byte per weight, unscaled, f32 out: the paper's
// Fig. 1 baseline, each multiplier a 3:1 mux of {+x, -x, 0}.  Multiplying
// by a trit decoded to +1, 0 or -1 is exact, so a product on the tensor
// cores is the same add, subtract or skip the TPU kernel runs on its MXU.
//
// What bounds it on the H100.  The trits stream at 8 bits per weight: one
// bitnet layer (K, N) in {(2560, 2560) x2, (2560, 640) x2, (2560, 6912) x2,
// (6912, 2560)} is 69.5 MB, 21 us at 3.35 TB/s.  That is the bound at M = 4
// (the largest call, 17.7 MB, is 5.3 us) and at M = 32 (5.6 us): the
// function's M*N*K adds, run on the bf16 tensor cores at 989 TFLOP/s, take
// 0.6 us for the largest call at M = 32.  Keeping 3.35
// TB/s in flight takes about 25-30 KB of outstanding loads per SM.  The
// first design lost 148x to that bound: 5-54 blocks on 132 SMs, byte-wide
// loads with 32 in flight, scalar select-and-add.  This one:
//
// 1. Full-card grid.  A block of 4 warps owns 64 output columns (2 warps
//    of 32 columns each, the other 2 splitting each step along K; or 4 x
//    16 columns), or where N is small 32 or 16 columns (2 or 3 more warps
//    along K); MT = 8, 16 or 32 activation rows (the smallest that covers
//    M, more as grid.z); and a balanced share of K.  K splits in 1, 2, 4
//    or 8 until there are two blocks an SM, and the plan takes the widest
//    layout that gets there within one wave of resident blocks (asked of
//    the runtime once per kernel), else the one with most blocks in one
//    wave.  At bitnet's M = 4 that is 320, 320 (16 columns), 432 and 320
//    blocks at (K, N) = (2560, 2560), (2560, 640), (2560, 6912), (6912,
//    2560); at M = 32 the same but 160 of 32 columns at (2560, 640).  Wider
//    tiles and 32 columns a warp read less x per trit from shared memory,
//    which sets the pace at M = 32.  The S blocks of a column tile form one
//    thread-block cluster: each leaves its partial tile in shared memory,
//    and after a cluster barrier each sums a 1 / S share of the tile over
//    the S blocks' shared memory (distributed shared memory), in split
//    order, and stores it.  No float atomics and no global scratch: two
//    calls on the same inputs are bitwise equal, and the partials never
//    leave the chip.  Summing global partials in each tile's last block
//    behind a counter instead was slower on the card: it ends every call
//    with a chain of fences, an atomic and L2 round trips.
// 2. Asynchronous 16-byte copies.  A step is 4 or 8 KB of trits ([64][64],
//    [32][128], [16][256] or [64][128]) and the same K range of x; both
//    arrive by cp.async, 16 bytes a thread, into a ring of 4 slots (3 for
//    8 KB steps): 12-16 KB of trits a block in flight while the current
//    step computes.  Trits stream past L1 (.cg); x, which every column
//    tile reads again, is cached there too (.ca).  x streams beside the
//    trits, so no block waits for its whole share of x before its first
//    MMA.  Deeper rings were no faster on the card: the grid, not the
//    loads in flight, sets the pace.  Each thread's copy sources are
//    worked out once and advance by a step.
// 3. Tensor cores, swap-AB.  The weight tile is the 16-row A operand of
//    mma.sync.m16n8k16 bf16 -> f32 (rows = output columns), x the 8-column
//    B operand (columns = activation rows), so decode fills no padding
//    rows.  Each thread reads 16 trits of two rows as one 16-byte shared
//    load; four trits decode to two bf16x2 words with two sign-replicating
//    byte permutes, a shift and two masks each (no multiply; bytes 0x01,
//    0xFF, 0x00 -> 0x3F80, 0xBF80, 0x0000).  The K order inside 64 trits is
//    permuted alike for A and B (thread t's fragment columns {2t, 2t+1,
//    2t+8, 2t+9} of MMA s are trits 16t + 4s + {0..3}), so each fragment
//    is one 32-bit word of the 16-byte load and needs no shuffle.
// 4. Exact f32 activations.  f32 x splits, as its fragments are read,
//    into three bf16 terms by truncation: hi = x with its low 16 bits
//    cleared, mid = (x - hi) truncated alike, lo = x - hi - mid; both
//    differences are exact, the sum is x for |x| >= 2^-110 (below it lo
//    loses bits under 2^-133), and truncation cannot overflow at +-f32
//    max.  All three products accumulate into the same f32 sums.  Where x
//    is not finite, hi carries it (NaN as a quiet NaN) and mid = lo = 0;
//    unlike the plain select, a zero trit then gives 0 * inf = NaN.  bf16
//    and int8 x are exact in one bf16 term, so the wrapper passes them as
//    they are (one term: a third of the MMAs, half or a quarter of the
//    staged bytes) and casts only other types to f32.  int8 x is widened
//    by a byte permute and one f32 subtraction, not the quarter-rate
//    int-to-float conversion, and sums integers below 2^24, exactly.
//
// Ragged edges are masked: columns past N, rows past M and k past K load
// as zero (cp.async src-size 0 or less than 16), and what lies past N or M
// is not stored.  Rows are read at their strides, so the served trits'
// padded rows need no copy.  The 16-byte copies need 16-byte aligned rows:
// every served shape has them (K = 2560, 6912, 4096, 6400; trit rows
// padded to a multiple of 640), the entry refuses any other, and the
// wrapper copies such an input to a 16-byte row stride first.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;        // 4 warps
// ring slots of a step (trits and x): three steps in flight of 4 KB of
// trits, two of 8 KB
__host__ __device__ constexpr int stages_for(int step_bytes) {
  return step_bytes > 4096 ? 3 : 4;
}
constexpr int MAX_SPLITS = 8;       // a portable cluster

enum XKind { X_F32 = 0, X_BF16 = 1, X_I8 = 2 };

template <int KIND> struct XType;
template <> struct XType<X_F32> { using T = float; static constexpr int TERMS = 3; };
template <> struct XType<X_BF16> { using T = uint16_t; static constexpr int TERMS = 1; };
template <> struct XType<X_I8> { using T = int8_t; static constexpr int TERMS = 1; };

// bytes of one staged x row of a step (16 of padding keep the fragment
// reads of neighbouring rows in different banks)
__host__ __device__ constexpr int x_row_bytes(int sk, int elem) {
  return sk * elem + 16;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// Four trits (the bytes of w, each 0x01, 0xFF or 0x00) to two bf16x2
// words: lo = (t0, t1), hi = (t2, t3).  A selector nibble with bit 3 set
// replicates the sign bit of the byte it names; w << 7 moves each byte's
// bit 0 (set for +1 and -1) into its sign bit.
__device__ __forceinline__ void decode4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t nz = w << 7;
  lo = (prmt(nz, 0u, 0x9988u) & 0x3F803F80u) | (prmt(w, 0u, 0x9988u) & 0x80008000u);
  hi = (prmt(nz, 0u, 0xBBAAu) & 0x3F803F80u) | (prmt(w, 0u, 0xBBAAu) & 0x80008000u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes to shared memory, of which the first `valid` come from src and
// the rest are zero.  Trits stream past L1 (.cg); x, which every column
// tile reads again, is kept there too (.ca), so blocks of one split on an
// SM share it.
template <bool L1 = false>
__device__ __forceinline__ void copy16(void* dst, const void* src, int valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid));
  else
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// f32 -> hi, mid, lo bf16 terms by truncation (see the note, point 4).
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7F800000u) == 0x7F800000u) {
    hi = (u & 0x007FFFFFu) ? 0x7FC0u : (u >> 16);
    mid = lo = 0u;
    return;
  }
  const uint32_t h = u & 0xFFFF0000u;
  const float r = v - __uint_as_float(h);
  const uint32_t m = __float_as_uint(r) & 0xFFFF0000u;
  const float l = r - __uint_as_float(m);
  hi = h >> 16;
  mid = m >> 16;
  lo = __float_as_uint(l) >> 16;
}

// MMA s's B fragments of one 8-row tile of int8 or f32 x: the thread's
// x[g][c + 4s .. c + 4s + 4) (c = its 16-value chunk, at `row`) as two
// bf16x2 words per term, b[q][0..1]; int8 x converted, f32 x split into
// its three terms.
template <int KIND>
__device__ __forceinline__ void load_b(const unsigned char* row, int s,
                                       uint32_t (&b)[3][2]) {
  if constexpr (KIND == X_I8) {
    // each byte biased to v + 128 under the f32 2^23, less 2^23 + 128: v
    // exactly, without the quarter-rate int-to-float conversion
    const uint32_t u = *reinterpret_cast<const uint32_t*>(row + 4 * s) ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(prmt(u, 0x4B000000u, 0x7650u + i)) - 8388736.0f;
    b[0][0] = prmt(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
    b[0][1] = prmt(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
  } else {
    const float4 v = *reinterpret_cast<const float4*>(row + 16 * s);
    uint32_t h[4], m[4], l[4];
    split3(v.x, h[0], m[0], l[0]);
    split3(v.y, h[1], m[1], l[1]);
    split3(v.z, h[2], m[2], l[2]);
    split3(v.w, h[3], m[3], l[3]);
    b[0][0] = h[0] | (h[1] << 16); b[0][1] = h[2] | (h[3] << 16);
    b[1][0] = m[0] | (m[1] << 16); b[1][1] = m[2] | (m[3] << 16);
    b[2][0] = l[0] | (l[1] << 16); b[2][1] = l[2] | (l[3] << 16);
  }
}

// One block: columns [o0, o0 + 16 WN), rows [m0, m0 + 8 NT), the steps of
// split blockIdx.y (a balanced share of ceil(K / SK) steps, SK = 64 (4 /
// WN)).  Warp w owns the 16 columns 16 (w % WN) and the (w / WN)-th 64
// trits of each step.  A ring slot holds a step's trits ([16 WN][SK]
// bytes, 16-byte chunks XOR-swizzled by row parity where a row spans more
// than 128 bytes) and its x ([8 NT][x_row_bytes]).  The S blocks of a
// column tile form one cluster; with S > 1 each leaves its partial tile in
// shared memory and sums a 1 / S share of the tile over all S, in split
// order.
template <int KIND, int NT, int WN, int RT>
__global__ void __launch_bounds__(THREADS, 4)
signflip_kernel(const void* __restrict__ xv, const int8_t* __restrict__ w,
                float* __restrict__ out, int M, int N, int K, long long ldx,
                long long ldw, int S) {
  using T = typename XType<KIND>::T;
  constexpr int TERMS = XType<KIND>::TERMS;
  constexpr int MT = 8 * NT;
  constexpr int BN = 16 * WN * RT;          // columns per block
  constexpr int WK = 4 / WN;                // warps along K
  constexpr int SK = 64 * WK;               // trits per row per step
  constexpr int STEP = BN * SK;             // trit bytes a step
  constexpr int CPR = SK / 16;              // 16-byte trit chunks per row
  constexpr int SWZ = CPR >= 8 ? 4 : 0;     // chunk XOR for odd rows
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // x per chunk
  constexpr int XROW = x_row_bytes(SK, sizeof(T));
  constexpr int XCPR = SK / EPC;            // x chunks per staged row
  constexpr int SLOT = STEP + MT * XROW;
  constexpr int STAGES = stages_for(STEP);
  static_assert(STEP % (16 * THREADS) == 0, "whole chunks per thread");
  extern __shared__ __align__(16) unsigned char smem[];

  const T* x = static_cast<const T*>(xv);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wk = warp / WN;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int ksteps = (K + SK - 1) / SK;
  const int s0 = static_cast<int>(static_cast<long long>(split) * ksteps / S);
  const int nsteps =
      static_cast<int>(static_cast<long long>(split + 1) * ksteps / S) - s0;

  // Each thread copies the 16-byte chunk at one column of every WROWS-th
  // trit row and every XROWS-th x row of a step, the same for every step:
  // its sources advance by SK trits a step.  Past N, M or K reads as 0.
  constexpr int WROWS = THREADS / CPR, XROWS = THREADS / XCPR;
  static_assert(THREADS % CPR == 0 && THREADS % XCPR == 0 && WROWS % 2 == 0,
                "fixed chunk columns, and rows of one swizzle parity");
  const int wr = tid / CPR, wch = tid % CPR, xr = tid / XCPR, xch = tid % XCPR;
  const int wk0 = s0 * SK + wch * 16, xk0 = s0 * SK + xch * EPC;
  const int8_t* wsrc = w + (o0 + wr) * ldw + wk0;
  const T* xsrc = x + (m0 + xr) * ldx + xk0;
  const int wdst = wr * SK + ((wch ^ ((wr & 1) * SWZ)) * 16);
  const int xdst = STEP + xr * XROW + xch * 16;
  auto load_step = [&](int step, int slot) {
    unsigned char* dst = smem + slot * SLOT;
    const int dk = step * SK;
    const int wv = max(0, min(16, K - wk0 - dk));
#pragma unroll
    for (int i = 0; i < STEP / 16 / THREADS; ++i) {
      const int valid = o0 + wr + i * WROWS < N ? wv : 0;
      copy16(dst + wdst + i * WROWS * SK,
                      valid ? wsrc + i * WROWS * ldw + dk : w, valid);
    }
    const int xv = max(0, min(EPC, K - xk0 - dk)) * int(sizeof(T));
#pragma unroll
    for (int i = 0; i < (MT + XROWS - 1) / XROWS; ++i) {
      if (MT % XROWS != 0 && xr + i * XROWS >= MT) break;
      const int valid = m0 + xr + i * XROWS < M ? xv : 0;
      copy16<true>(dst + xdst + i * XROWS * XROW,
                            valid ? xsrc + i * XROWS * ldx + dk : x, valid);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_step(s, s);
    cp_async_commit();
  }

  float acc[RT][NT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][n][j] = 0.f;

  // this thread's 16 trits of rows g and g + 8 (same parity) of each of its
  // column tiles in a step, and the same 16 k of x
  const int arow = (wn * 16 * RT + g) * SK + (((wk * 4 + t) ^ ((g & 1) * SWZ)) * 16);
  const int xoff = STEP + g * XROW + (wk * 64 + t * 16) * int(sizeof(T));
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();        // step i landed; every warp is done with i - 1
    if (i + STAGES - 1 < nsteps) load_step(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const unsigned char* slot = smem + (i % STAGES) * SLOT;
    // a[r][s]: MMA s's A fragment of column tile r: rows g and g + 8,
    // trits 16t + 4s + {0..3}
    uint32_t a[RT][4][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const uint4 wa = *reinterpret_cast<const uint4*>(slot + arow + 16 * r * SK);
      const uint4 wb = *reinterpret_cast<const uint4*>(slot + arow + (16 * r + 8) * SK);
      decode4(wa.x, a[r][0][0], a[r][0][2]);
      decode4(wb.x, a[r][0][1], a[r][0][3]);
      decode4(wa.y, a[r][1][0], a[r][1][2]);
      decode4(wb.y, a[r][1][1], a[r][1][3]);
      decode4(wa.z, a[r][2][0], a[r][2][2]);
      decode4(wb.z, a[r][2][1], a[r][2][3]);
      decode4(wa.w, a[r][3][0], a[r][3][2]);
      decode4(wb.w, a[r][3][1], a[r][3][3]);
    }
    // (f32 x: one 8-row tile at a time, or its split fragments crowd the
    // registers)
#pragma unroll (KIND == X_F32 ? 1 : NT)
    for (int n = 0; n < NT; ++n) {
      const unsigned char* xrow = slot + xoff + n * 8 * XROW;
      if constexpr (KIND == X_BF16) {
        // two 16-byte reads: rows g and g + 1 of a quarter warp fall in
        // different banks
        const uint4 p = *reinterpret_cast<const uint4*>(xrow);
        const uint4 q = *reinterpret_cast<const uint4*>(xrow + 16);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          mma_bf16(acc[r][n], a[r][0], p.x, p.y);
          mma_bf16(acc[r][n], a[r][1], p.z, p.w);
          mma_bf16(acc[r][n], a[r][2], q.x, q.y);
          mma_bf16(acc[r][n], a[r][3], q.z, q.w);
        }
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t b[3][2];
          load_b<KIND>(xrow, s, b);
#pragma unroll
          for (int q = 0; q < TERMS; ++q)
#pragma unroll
            for (int r = 0; r < RT; ++r) mma_bf16(acc[r][n], a[r][s], b[q][0], b[q][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();          // the ring is free for the sums below

  float* red = reinterpret_cast<float*>(smem);
  if constexpr (WK > 1) {
    // the K-warps' sums into warp wk = 0's, in wk order
    constexpr int V = RT * NT * 4;
    if (wk > 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            red[(((wk - 1) * WN + wn) * V + (r * NT + n) * 4 + j) * 32 + lane] = acc[r][n][j];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int v = 0; v < WK - 1; ++v)
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[r][n][j] += red[((v * WN + wn) * V + (r * NT + n) * 4 + j) * 32 + lane];
    }
    __syncthreads();
  }

  // acc[r][n][j]: column 16 (RT wn + r) + g (+8 for j >= 2), row 8n + 2t
  // (+1 for odd j) of the tile
  if (S == 1) {
    if (wk == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = o0 + 16 * (RT * wn + r) + g + (j >> 1) * 8;
            const int b = m0 + n * 8 + 2 * t + (j & 1);
            if (o < N && b < M) out[static_cast<size_t>(b) * N + o] = acc[r][n][j];
          }
    }
    return;
  }

  // split-K: the partial tile [MT][BN] in shared memory, then each block of
  // the cluster sums its share of the tile over the S blocks in split
  // order, reading the others' shared memory
  if (wk == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(n * 8 + 2 * t + (j & 1)) * BN + 16 * (RT * wn + r) + g + (j >> 1) * 8] =
              acc[r][n][j];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int QUADS = MT * BN / 4;
  const int share = QUADS / S;
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank * share + tid; e < (rank + 1) * share; e += THREADS) {
    const int b = m0 + (e * 4) / BN, o = o0 + (e * 4) % BN;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < S; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red + e * 4, q));
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    if (b < M) {
      float* y = out + static_cast<size_t>(b) * N + o;
      if (N % 4 == 0 && o + 3 < N) {
        *reinterpret_cast<float4*>(y) = sum;
      } else {
        const float v4[4] = {sum.x, sum.y, sum.z, sum.w};
        for (int c = 0; c < 4 && o + c < N; ++c) y[c] = v4[c];
      }
    }
  }
  cluster.sync();           // no block leaves while others read its sums
}

// Column layouts: warps along N (the other 4 / WN split each step along
// K) and 16-column tiles a warp owns.
struct Layout { int wn, rt; };
constexpr Layout kLayouts[] = {{2, 2}, {4, 1}, {2, 1}, {1, 1}};
constexpr int kNumLayouts = 4;

template <int KIND, int NT, int WN, int RT>
struct Config {
  static constexpr int SK = 64 * (4 / WN);
  static constexpr size_t SMEM =
      size_t(stages_for(16 * WN * RT * SK)) * (size_t(16 * WN * RT) * SK +
                        8 * NT * x_row_bytes(SK, sizeof(typename XType<KIND>::T)));

  // blocks an SM holds (0 if that cannot be asked), asked once; also
  // allows the kernel its shared memory
  static int resident() {
    static int n = -1;
    if (n < 0) {
      auto kernel = signflip_kernel<KIND, NT, WN, RT>;
      int r = 0;
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM)) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, kernel, THREADS, SMEM) !=
              cudaSuccess)
        r = 0;
      n = r;
    }
    return n;
  }

  static cudaError_t launch(dim3 grid, const void* x, const void* w, void* out,
                            int M, int N, int K, long long ldx, long long ldw,
                            cudaStream_t stream) {
    if (resident() < 1) return cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = grid.y;     // the splits of a column tile
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, signflip_kernel<KIND, NT, WN, RT>, x,
                              static_cast<const int8_t*>(w),
                              static_cast<float*>(out), M, N, K, ldx, ldw,
                              static_cast<int>(grid.y));
  }
};

template <int KIND, int NT>
int resident(int layout) {
  switch (layout) {
    case 0: return Config<KIND, NT, 2, 2>::resident();
    case 1: return Config<KIND, NT, 4, 1>::resident();
    case 2: return Config<KIND, NT, 2, 1>::resident();
    default: return Config<KIND, NT, 1, 1>::resident();
  }
}

// Column layout and splits of one call.  Each layout splits K in one,
// two, four or eight (a cluster) until it has two blocks an SM.  The
// widest layout (the least x staged per trit) that reaches that within
// one wave of resident blocks wins; where none does, the layout with the
// most blocks in one wave; where none fits one wave, the fewest waves.
template <int KIND, int NT>
cudaError_t run(const void* x, const void* w, void* out, int M, int N, int K,
                long long ldx, long long ldw, int sms, cudaStream_t stream) {
  const long want = 2L * sms;
  int best = -1, best_splits = 1;
  long best_blocks = 0, best_waves = 0;
  for (int l = 0; l < kNumLayouts; ++l) {
    const int wn = kLayouts[l].wn, bn = 16 * wn * kLayouts[l].rt, sk = 64 * (4 / wn);
    const int ksteps = (K + sk - 1) / sk;
    const long tiles = long((N + bn - 1) / bn) * ((M + 8 * NT - 1) / (8 * NT));
    int splits = 1;
    while (splits < MAX_SPLITS && 2 * splits <= ksteps && tiles * splits < want)
      splits *= 2;
    const long slots = long(resident<KIND, NT>(l)) * sms;
    if (slots < 1) continue;
    const long blocks = tiles * splits;
    const long waves = (blocks + slots - 1) / slots;
    if (best < 0 || waves < best_waves ||
        (waves == best_waves && best_blocks < want && blocks > best_blocks)) {
      best = l;
      best_splits = splits;
      best_blocks = blocks;
      best_waves = waves;
    }
  }
  if (best < 0) return cudaErrorInvalidConfiguration;
  const int bn = 16 * kLayouts[best].wn * kLayouts[best].rt;
  const dim3 grid((N + bn - 1) / bn, best_splits, (M + 8 * NT - 1) / (8 * NT));
  switch (best) {
    case 0: return Config<KIND, NT, 2, 2>::launch(grid, x, w, out, M, N, K, ldx, ldw, stream);
    case 1: return Config<KIND, NT, 4, 1>::launch(grid, x, w, out, M, N, K, ldx, ldw, stream);
    case 2: return Config<KIND, NT, 2, 1>::launch(grid, x, w, out, M, N, K, ldx, ldw, stream);
    default: return Config<KIND, NT, 1, 1>::launch(grid, x, w, out, M, N, K, ldx, ldw, stream);
  }
}

template <int KIND>
cudaError_t run_kind(const void* x, const void* w, void* out, int M, int N,
                     int K, long long ldx, long long ldw, int sms,
                     cudaStream_t s) {
  // 16-byte copies need every row, and so every 16-byte chunk of it, to
  // start 16-byte aligned
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      ldx * long(sizeof(typename XType<KIND>::T)) % 16 != 0 || ldw % 16 != 0)
    return cudaErrorInvalidValue;
  if (M <= 8) return run<KIND, 1>(x, w, out, M, N, K, ldx, ldw, sms, s);
  if (M <= 16) return run<KIND, 2>(x, w, out, M, N, K, ldx, ldw, sms, s);
  return run<KIND, 4>(x, w, out, M, N, K, ldx, ldw, sms, s);
}

}  // namespace

// x: [M, K] with row stride ldx (elements), x_kind 0 = f32, 1 = bf16,
// 2 = int8; w: [N, K] int8 trits in {-1, 0, 1} with row stride ldw (bytes,
// as the served base-3 bytes' 128-byte row padding leaves them); out: [M, N]
// f32, unscaled.  Rows start 16-byte aligned (pointers and strides).
// Launches on `stream`; returns the launch error (0 on success).
extern "C" int signflip_matmul_f32(const void* x, int x_kind, const void* w,
                                   void* out, int M, int N, int K,
                                   long long ldx, long long ldw, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || x_kind < 0 || x_kind > 2 || ldx < 0 ||
      ldw < K)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == X_F32) e = run_kind<X_F32>(x, w, out, M, N, K, ldx, ldw, sms, s);
  else if (x_kind == X_BF16) e = run_kind<X_BF16>(x, w, out, M, N, K, ldx, ldw, sms, s);
  else e = run_kind<X_I8>(x, w, out, M, N, K, ldx, ldw, sms, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
