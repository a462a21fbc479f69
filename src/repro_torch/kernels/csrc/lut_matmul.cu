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
//     entries (the MXU form on the TPU; here on the tensor cores);
//   table[b, g, t] = dot(C[t], x[b, g*mu : (g+1)*mu])   (t < T; entry T = 0)
// with key = sym << 4 | idx, C the [T+1, mu] combo matrix of the positive
// half of the ternary combos (row T all zero), mu = 3, T + 1 = 14, and f32
// sums.  Both fetches give the same sums: every other one-hot product is 0.
//
// What bounds it on the H100 (one bitnet layer: (K, N) = (2560, 2560) x2,
// (2560, 640) x2, (2560, 6912) x2, (6912, 2560) x1; 23.2 M keys):
//   * bytes: the keys, one byte per group of 3 weights, 23.2 MB a layer:
//     6.9 us at 3.35 TB/s, at every M;
//   * the gather's shared-memory reads: one 4-byte table entry per key
//     and row, 4 M bytes a key, at 128 B/clk per SM.  Measured on the
//     H100 for this read pattern (launch/smem_rate.py): 127.9 B/clk, a
//     warp's 64-bit read taking two wavefronts though it names at most
//     14 distinct entries (only a read of one entry by all 32 lanes is
//     served in one), at an SM clock of about 1.99 GHz under load.  At
//     the 1.98 GHz maximum (33.4 TB/s over 132 SMs; chip_smoke reads it
//     each run) these reads take 11.1 us a layer at M = 4 and 89 us at
//     M = 32, where they and not the bytes would bound it;
//   * the one-hot's MMAs: mma.sync.m16n8k16 takes one group (16 entries)
//     by 16 output columns by 8 (row, term) slots, 3 bf16 terms a row:
//     2.9 M MMAs a layer at M = 4 (12 of 16 slots used), 17.4 M at M = 32,
//     12 and 72 us at the 989 TFLOP/s peak; mma.sync reaches a fraction
//     of that peak on Hopper;
//   * the one-hot's A fragments: each key's one-hot is made in registers
//     by the four lanes that hold a quarter of its 16 entries, about 6
//     integer instructions a lane (16-lane integer pipes: two issue
//     cycles each), 24 a key where the gather spends about 11 for 4 rows:
//     at M = 4 this, not the MMAs, sets the one-hot's pace (about 40 us a
//     layer at full issue);
//   * per call, a cost that does not grow with the keys: launch, the
//     first loads from a cold L2 (the timer flushes it) and the cluster
//     reduction; the smallest call, 0.55 M keys, takes about 9 us on the
//     card (PERF.md), 7 calls a layer.
// On the card (PERF.md §6) neither kernel is near these ceilings: at M =
// 4 the one-hot is held by its fragment work and the per-call cost, and
// at M = 32 the gather takes about 2.5x its shared-memory ceiling, the
// largest calls about 2x; what holds the rest is not measured.
// The first design lost 140x to the key bytes: 5-54 blocks of 128
// threads on 132 SMs, each walking all of K, byte-wide synchronous loads,
// and 14 f32 FMAs per key and row for the one-hot.  This one:
//
// 1. Full-card grid, deterministic split-K.  A block is 4 warps: WN = 4, 2
//    or 1 along N and WK = 4 / WN along K, each K-warp taking one 16-group
//    chunk of every step (a step is 16 WK groups), so narrow tiles still
//    keep 4 warps an SM busy.  The gather gives a warp 32 output columns
//    (one a lane), the one-hot 16 (one MMA tile).  K splits in S = 1, 2,
//    4 or 8 until there are 4 blocks an SM (2 for row tiles past 8); the
//    plan takes the widest layout (the most columns sharing a table
//    build) that gets there within one wave of resident blocks (asked of
//    the runtime once per kernel), else the one with most blocks in one
//    wave.  Row tiles are 4, 8 or 16 rows, more as grid z: at M = 32 two
//    tiles of 16 spread the shared-memory reads over more SMs than one of
//    32.  Each block builds the tables of its own K share only.  The S
//    blocks of a column tile form one thread-block cluster: each sums its
//    warps' partial tiles (and the one-hot's terms) in its own shared
//    memory, then after a cluster barrier each sums a 1 / S share of the
//    tile over the S blocks' shared memory, all S reads in flight, in
//    split order.  No float atomics: two calls on the same inputs are
//    bitwise equal.
// 2. Keys as served, in a 16-byte cp.async ring.  The served keys are a
//    view of rows padded to 16 bytes (the padding holds the zero key), so
//    every row starts 16-byte aligned and is read at its stride; the
//    wrapper copies only inputs that are not.  A step's copies are the WK
//    16-byte chunks of each of the block's key rows (XOR-swizzled so eight
//    rows' chunk falls in eight bank groups) and the 48 WK columns of x
//    they cover, by cp.async (keys past L1, x through it, since every
//    column tile reads it again) into a ring of 4 slots: three steps in
//    flight while one computes.
// 3. x as served.  f32, bf16 and int8 x are read as they are, one
//    instantiation each; the table build converts them.  Columns past the
//    logical K (and rows past M, groups past G) load as zero (cp.async
//    src-size), so x of width K needs no padding: the last group is short.
//    Rows past M are never built (their tables are zeroed once).
// 4. The gather on the CUDA cores.  The tables of a step lie as
//    [group][row pair][entry] float2: 14 entries of 8 bytes, 112 bytes, so
//    the 16 lanes a shared-memory wavefront serves, all on one group and
//    row pair, read distinct banks whatever their keys, and each 64-bit
//    read brings two rows.  The sum is an FMA by +-1.0 (the key's sym bit
//    moved to the float's sign), kept in f32 registers per row.
// 5. The one-hot on the tensor cores, swap-AB.  The signed one-hot is the
//    A operand of mma.sync.m16n8k16 (16 output columns by k16, one k16
//    step one group's 16 entries: 14 and two zeros); each lane makes its
//    fragment's bf16 +-1 / 0 values from two key bytes in registers with
//    one 64-bit shift each (onehot_words), and no one-hot is stored.  The
//    entries are permuted alike in A and B so that a lane's four k-slots
//    are entries 4t..4t+3.  The tables are the B operand, built once a
//    step as exact bf16 terms, slot n = q MT + b holding term q of row b
//    (so at M = 4 the 3 terms of 4 rows fill 12 of two tiles' 16 slots),
//    one accumulator tile per B tile and the terms summed at the end.
//    bf16 and int8 x feed the entry's three signed x components d_q x_q,
//    each exact in bf16: a word is one AND and one XOR of x_q with masks
//    known at compile time.  f32 x, whose components would need three
//    terms each, feeds each f32 entry split by truncation into hi + mid +
//    lo (as signflip splits x).  The split feed alone would serve every
//    dtype with as many terms and MMAs, but its longer table build made
//    the one-hot 19% slower a layer at M = 4 and 24-32% at M = 32 on
//    bf16 x (launch/lut_times.py on the H100; PERF.md §6).
//    +-1 times an exact term is exact, so the contraction is the same
//    conditional add the TPU kernel runs on its MXU.
//
// Ragged edges are masked: columns past N and rows past M compute on zero
// keys or zero x and are not stored.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int MU = 3;
constexpr int T1 = 14;              // T stored entries + the zero entry
constexpr int IB = 4;               // idx bits; sym is bit 4
constexpr int SG = 16;              // groups a step: one 16-byte key chunk
constexpr int STAGES = 4;           // ring slots
constexpr int MAX_SPLITS = 8;       // a portable cluster

enum XKind { X_F32 = 0, X_BF16 = 1, X_I8 = 2 };
enum Fetch { GATHER = 0, ONEHOT = 1 };

template <int KIND> struct XType;
template <> struct XType<X_F32> { using T = float; };
template <> struct XType<X_BF16> { using T = uint16_t; };
template <> struct XType<X_I8> { using T = int8_t; };

// the combo digit d_i(t) in {-1, 0, 1} of entry t (row t of C): the
// base-3 digits of T + 1 + t, minus 1; entry T is the zero combo
__host__ __device__ constexpr int digit(int t, int i) {
  int v = T1 + t;
  for (int j = 0; j < i; ++j) v /= 3;
  return t < T1 - 1 ? v % 3 - 1 : 0;
}

template <int KIND>
__device__ __forceinline__ float to_f32(typename XType<KIND>::T v) {
  if constexpr (KIND == X_F32) return v;
  else if constexpr (KIND == X_BF16) return __uint_as_float(static_cast<uint32_t>(v) << 16);
  else return static_cast<float>(v);
}

// entry t of one row's table from its group's three x values, as adds and
// subtracts of the digits known at compile time
template <int t>
__device__ __forceinline__ float combo(float x0, float x1, float x2) {
  constexpr int d0 = digit(t, 0), d1 = digit(t, 1), d2 = digit(t, 2);
  float s = 0.f;
  if constexpr (d0 != 0) s = d0 > 0 ? x0 : -x0;
  if constexpr (d1 != 0) s = d1 > 0 ? s + x1 : s - x1;
  if constexpr (d2 != 0) s = d2 > 0 ? s + x2 : s - x2;
  return s;
}

template <int... ts>
__device__ __forceinline__ void combos(std::integer_sequence<int, ts...>,
                                       float x0, float x1, float x2, float* e) {
  ((e[ts] = combo<ts>(x0, x1, x2)), ...);
}

// the T1 entries of one row's table for one group
__device__ __forceinline__ void table_row(float x0, float x1, float x2,
                                          float* e) {
  combos(std::make_integer_sequence<int, T1>{}, x0, x1, x2, e);
}

// f32 -> hi, mid, lo bf16 terms by truncation: both differences are exact
// and the sum is v for |v| >= 2^-110; a non-finite v rides in hi
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t u = __float_as_uint(v);
  const bool finite = (u & 0x7F800000u) != 0x7F800000u;
  const uint32_t h = u & 0xFFFF0000u;
  const float r = v - __uint_as_float(h);
  const uint32_t m = __float_as_uint(r) & 0xFFFF0000u;
  const float l = r - __uint_as_float(m);
  hi = finite ? h >> 16 : (u & 0x007FFFFFu) ? 0x7FC0u : u >> 16;
  mid = finite ? m >> 16 : 0u;
  lo = finite ? __float_as_uint(l) >> 16 : 0u;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two A-fragment words of key i of a key word w for the thread whose
// k-slots are entries 4t .. 4t + 3 (t64 = 64t): lo holds entries 4t,
// 4t + 1, hi entries 4t + 2, 4t + 3, each bf16 +-1 where idx names it
// (sign from sym), else 0.  One 64-bit shift does it: sv << 16 (idx - 4t)
// lands in the right half of lo or hi when 0 <= idx - 4t < 4, and shl
// clamps every other amount (idx < 4t wraps to a huge one) to a shift
// out.
__device__ __forceinline__ void onehot_words(uint32_t w, uint32_t w16, int i,
                                             uint32_t t64, uint32_t& lo,
                                             uint32_t& hi) {
  // key i of the word w; w16 holds 16 idx in each byte
  const uint32_t s = __byte_perm(w16, 0u, 0x4440u | i) - t64;
  const uint64_t sv = 0x3F80u | (((w >> (8 * i)) << (15 - IB)) & 0x8000u);
  uint64_t v;
  asm("shl.b64 %0, %1, %2;" : "=l"(v) : "l"(sv), "r"(s));
  lo = static_cast<uint32_t>(v);
  hi = static_cast<uint32_t>(v >> 32);
}

// 16 bytes to shared memory, of which the first `valid` come from src and
// the rest are zero.  Keys stream past L1 (.cg); x, which every column
// tile reads again, is kept there too (.ca).
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

// Shapes of one instantiation: FETCH, x KIND, MT rows a block (a multiple
// of 4), and WN of the block's 4 warps along N (the other WK = 4 / WN
// each take one 16-group chunk of every step).
template <int FETCH, int KIND, int MT, int WN>
struct Shape {
  using T = typename XType<KIND>::T;
  static constexpr int THREADS = 128;
  static constexpr int WK = 4 / WN;                   // warps along K
  static constexpr int BN = (FETCH == GATHER ? 32 : 16) * WN;  // columns
  static constexpr int SGS = SG * WK;                 // groups a step
  static constexpr int CPR = WK;                      // key chunks a row
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // x per chunk
  static constexpr int XCOLS = SGS * MU;              // x columns a step
  static constexpr int XCPR = XCOLS / EPC;            // x chunks a row
  // a staged x row, padded by 16 bytes so rows fall in different banks
  static constexpr int XROW = XCOLS * static_cast<int>(sizeof(T)) + 16;
  static constexpr int KEYS = BN * 16 * CPR;          // key bytes a step
  static constexpr int SLOT = KEYS + MT * XROW;
  // one-hot B operand: slot n = q MT + b holds term q of row b, in NTT
  // tiles of 8
  static constexpr int NR = FETCH == GATHER ? MT : 3 * MT;
  static constexpr int NTT = FETCH == GATHER ? 1 : (NR + 7) / 8;
  // tables of a step: gather [SGS][MT / 2][T1] float2; one-hot
  // [SGS][NTT][8 slots][16 entries] bf16
  static constexpr int TBL = FETCH == GATHER ? SGS * MT * T1 * 4 : SGS * NTT * 256;
  static constexpr int RED = WK * NR * BN * 4;        // the partial tiles
  static constexpr int RING = STAGES * SLOT + TBL;
  static constexpr size_t SMEM = RING > RED ? RING : RED;
  static_assert(MT % 4 == 0 && TBL % 16 == 0, "row tile");
  static_assert(XCOLS % EPC == 0, "whole x chunks a step");
};

// the 16-byte chunk c of key row r as stored: XOR-swizzled so that eight
// consecutive rows' chunk c fall in eight different bank groups
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((r / (8 / CPR)) % CPR);
}

// bf16 masks of one table word (entries 2p, 2p + 1) in term q of the
// component feed: keep the halves whose digit d_q is not 0, flip the sign
// of those whose digit is -1
__host__ __device__ constexpr uint32_t keep_mask(int q, int p) {
  return (digit(2 * p, q) ? 0x0000FFFFu : 0u) | (digit(2 * p + 1, q) ? 0xFFFF0000u : 0u);
}
__host__ __device__ constexpr uint32_t flip_mask(int q, int p) {
  return (digit(2 * p, q) < 0 ? 0x00008000u : 0u) |
         (digit(2 * p + 1, q) < 0 ? 0x80000000u : 0u);
}

// the 8 words of term q from uu, x_q's bf16 bits in both halves; the
// masks are constants of the compiled code
template <int q, int... ps>
__device__ __forceinline__ void component_words(std::integer_sequence<int, ps...>,
                                                uint32_t uu, uint32_t* w) {
  ((w[ps] = (uu & std::integral_constant<uint32_t, keep_mask(q, ps)>::value) ^
            std::integral_constant<uint32_t, flip_mask(q, ps)>::value), ...);
}

// One block: columns [o0, o0 + BN), rows [m0, m0 + MT), the steps of split
// blockIdx.y (a balanced share of ceil(G / SGS) steps of SGS groups).
// Warp w owns columns BN / WN (w % WN) and the (w / WN)-th 16 groups of
// each step.  x rows are ldx elements apart, key rows ldk bytes; both
// start 16-byte aligned.  The S blocks of a column tile form a cluster.
template <int FETCH, int KIND, int MT, int WN>
__global__ void __launch_bounds__(128)
lut_kernel(const void* __restrict__ xv, const uint8_t* __restrict__ keys,
           float* __restrict__ out, int M, int N, int K, int G, long long ldx,
           long long ldk, int S) {
  using Sh = Shape<FETCH, KIND, MT, WN>;
  using T = typename Sh::T;
  constexpr int THREADS = Sh::THREADS, WK = Sh::WK, BN = Sh::BN;
  constexpr int SGS = Sh::SGS, CPR = Sh::CPR, EPC = Sh::EPC, XCPR = Sh::XCPR;
  constexpr int XROW = Sh::XROW, KEYS = Sh::KEYS, SLOT = Sh::SLOT;
  constexpr int NR = Sh::NR, NTT = Sh::NTT, TBL = Sh::TBL;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tbl = smem + STAGES * SLOT;

  const T* x = static_cast<const T*>(xv);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wk = warp / WN;
  const int o0 = blockIdx.x * BN;
  const int m0 = blockIdx.z * MT;
  const int rows = min(MT, M - m0);       // rows of the tile that exist
  const int ksteps = (G + SGS - 1) / SGS;
  const int s0 = static_cast<int>(static_cast<long long>(blockIdx.y) * ksteps / S);
  const int nsteps =
      static_cast<int>(static_cast<long long>(blockIdx.y + 1) * ksteps / S) - s0;

  // a step's copies: CPR 16-byte key chunks of each column row (rows past
  // N and groups past G read as 0), and the step's x columns of each row
  // (rows past M and columns past K read as 0)
  auto load_step = [&](int step, int slot) {
    unsigned char* dst = smem + slot * SLOT;
    const int g0 = (s0 + step) * SGS;
    for (int e = tid; e < BN * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int gc = g0 + 16 * c;
      const int valid = o0 + r < N ? max(0, min(16, G - gc)) : 0;
      copy16(dst + (r * CPR + swz<CPR>(r, c)) * 16,
             valid ? keys + (o0 + r) * ldk + gc : keys, valid);
    }
    const int k0 = g0 * MU;
    for (int e = tid; e < MT * XCPR; e += THREADS) {
      const int b = e / XCPR, c = e % XCPR;
      const int k = k0 + c * EPC;
      const int valid = b < rows
          ? max(0, min(EPC, K - k)) * static_cast<int>(sizeof(T)) : 0;
      copy16<true>(dst + KEYS + b * XROW + c * 16,
                   valid ? x + (m0 + b) * ldx + k : x, valid);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_step(s, s);
    cp_async_commit();
  }
  // table entries of rows past M stay zero: the builds skip them
  for (int e = tid; e < TBL / 16; e += THREADS)
    reinterpret_cast<uint4*>(tbl)[e] = make_uint4(0u, 0u, 0u, 0u);

  // gather: acc[b], row b of column o0 + BN / WN wn + lane; one-hot:
  // mma[n][j] of B tile n (columns BN / WN wn + g (+8 for j >= 2), slots
  // 8n + 2t (+1 for odd j))
  float acc[FETCH == GATHER ? MT : 1];
  float mma[NTT][4];
#pragma unroll
  for (int b = 0; b < (FETCH == GATHER ? MT : 1); ++b) acc[b] = 0.f;
#pragma unroll
  for (int n = 0; n < NTT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma[n][j] = 0.f;
  const int g = lane >> 2, t = lane & 3;

  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();        // step i landed; every warp is done with i - 1
    if (i + STAGES - 1 < nsteps) load_step(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* slot = smem + (i % STAGES) * SLOT;
    const unsigned char* xs = slot + KEYS;

    // build the step's tables from its x, rows that exist only
    if constexpr (FETCH == GATHER) {
      // task (group j, row pair p): 14 float2, stored as 7 float4
      for (int e = tid; e < SGS * (MT / 2); e += THREADS) {
        const int j = e / (MT / 2), p = e % (MT / 2);
        if (2 * p >= rows) continue;
        const T* xa = reinterpret_cast<const T*>(xs + (2 * p) * XROW) + j * MU;
        const T* xb = reinterpret_cast<const T*>(xs + (2 * p + 1) * XROW) + j * MU;
        float ea[T1], eb[T1];
        table_row(to_f32<KIND>(xa[0]), to_f32<KIND>(xa[1]), to_f32<KIND>(xa[2]), ea);
        table_row(to_f32<KIND>(xb[0]), to_f32<KIND>(xb[1]), to_f32<KIND>(xb[2]), eb);
        float4* dst = reinterpret_cast<float4*>(tbl) + (j * (MT / 2) + p) * (T1 / 2);
#pragma unroll
        for (int q = 0; q < T1 / 2; ++q)
          dst[q] = make_float4(ea[2 * q], eb[2 * q], ea[2 * q + 1], eb[2 * q + 1]);
      }
    } else {
      // task (group j, row b): three exact bf16 terms of its 16 entries
      // (14 and two zeros), 32 bytes each, at B slots q MT + b
      for (int e = tid; e < SGS * MT; e += THREADS) {
        const int j = e / MT, b = e % MT;
        if (b >= rows) continue;
        const T* xr = reinterpret_cast<const T*>(xs + b * XROW) + j * MU;
        uint32_t w[3][8];
        if constexpr (KIND == X_F32) {
          // each f32 entry split by truncation into hi + mid + lo
          float ev[16];
          table_row(xr[0], xr[1], xr[2], ev);
          ev[14] = ev[15] = 0.f;
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            uint32_t h0, md0, l0, h1, md1, l1;
            split3(ev[2 * p], h0, md0, l0);
            split3(ev[2 * p + 1], h1, md1, l1);
            w[0][p] = h0 | (h1 << 16);
            w[1][p] = md0 | (md1 << 16);
            w[2][p] = l0 | (l1 << 16);
          }
        } else {
          // term q: the entries' signed x_q components d_q(t) x_q, exact
          // in bf16 for bf16 and int8 x
          uint32_t uu[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t u;
            if constexpr (KIND == X_BF16) u = xr[q];
            else u = __float_as_uint(static_cast<float>(xr[q])) >> 16;
            uu[q] = u | (u << 16);
          }
          component_words<0>(std::make_integer_sequence<int, 8>{}, uu[0], w[0]);
          component_words<1>(std::make_integer_sequence<int, 8>{}, uu[1], w[1]);
          component_words<2>(std::make_integer_sequence<int, 8>{}, uu[2], w[2]);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int n = q * MT + b;
          uint4* dst = reinterpret_cast<uint4*>(tbl + (j * NTT + n / 8) * 256 + (n % 8) * 32);
          dst[0] = make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
          dst[1] = make_uint4(w[q][4], w[q][5], w[q][6], w[q][7]);
        }
      }
    }
    __syncthreads();        // the tables are built

    if constexpr (FETCH == GATHER) {
      // one column a lane: its 16 keys of chunk wk, one table entry a key
      // and row
      const int r = wn * 32 + lane;
      const uint4 kw = *reinterpret_cast<const uint4*>(
          slot + (r * CPR + swz<CPR>(r, wk)) * 16);
      const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
      const float2* tf = reinterpret_cast<const float2*>(tbl) + wk * SG * (MT / 2) * T1;
#pragma unroll
      for (int j = 0; j < SG; ++j) {
        const uint32_t key = words[j >> 2] >> (8 * (j & 3));
        const float sgn = __uint_as_float(0x3F800000u | ((key & (1u << IB)) << (31 - IB)));
        const float2* e = tf + j * (MT / 2) * T1 + (key & 15u);
#pragma unroll
        for (int p = 0; p < MT / 2; ++p) {
          const float2 v = e[p * T1];
          acc[2 * p] = fmaf(v.x, sgn, acc[2 * p]);
          acc[2 * p + 1] = fmaf(v.y, sgn, acc[2 * p + 1]);
        }
      }
    } else {
      // one 16-column MMA tile a warp: the keys of its columns g and g + 8
      const int ra = wn * 16 + g, rb = ra + 8;
      const uint4 ka = *reinterpret_cast<const uint4*>(
          slot + (ra * CPR + swz<CPR>(ra, wk)) * 16);
      const uint4 kb = *reinterpret_cast<const uint4*>(
          slot + (rb * CPR + swz<CPR>(rb, wk)) * 16);
      const uint32_t wa[4] = {ka.x, ka.y, ka.z, ka.w};
      const uint32_t wb[4] = {kb.x, kb.y, kb.z, kb.w};
      // 16 idx in each byte, once a word
      uint32_t xa[4], xb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xa[q] = (wa[q] << 4) & 0xF0F0F0F0u;
        xb[q] = (wb[q] << 4) & 0xF0F0F0F0u;
      }
      const unsigned char* tb = tbl + wk * SG * NTT * 256 + g * 32 + t * 8;
      const uint32_t t64 = 64u * t;
#pragma unroll
      for (int j = 0; j < SG; ++j) {
        uint32_t a[4];
        onehot_words(wa[j >> 2], xa[j >> 2], j & 3, t64, a[0], a[2]);
        onehot_words(wb[j >> 2], xb[j >> 2], j & 3, t64, a[1], a[3]);
#pragma unroll
        for (int n = 0; n < NTT; ++n) {
          const uint2 bb = *reinterpret_cast<const uint2*>(tb + (j * NTT + n) * 256);
          mma_bf16(mma[n], a, bb.x, bb.y);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();          // the ring is free for the partial tiles

  // each warp's partial tile in shared memory, red[wk][NR][BN]
  float* red = reinterpret_cast<float*>(smem);
  if constexpr (FETCH == GATHER) {
#pragma unroll
    for (int b = 0; b < MT; ++b) red[(wk * NR + b) * BN + wn * 32 + lane] = acc[b];
  } else {
#pragma unroll
    for (int n = 0; n < NTT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = n * 8 + 2 * t + (j & 1);
        if (NR % 8 == 0 || nn < NR)
          red[(wk * NR + nn) * BN + wn * 16 + g + (j >> 1) * 8] = mma[n][j];
      }
  }
  // the warps' planes (and terms) summed in place into plane 0, in a
  // fixed order: red[b][o] is then the block's partial tile
  constexpr int QUADS = MT * BN / 4;
  constexpr int TERMS = FETCH == GATHER ? 1 : 3;
  if constexpr (WK * TERMS > 1) {
    __syncthreads();
    for (int e = tid; e < QUADS; e += THREADS) {
      const int b = (e * 4) / BN, o = (e * 4) % BN;
      float4 sum = *reinterpret_cast<const float4*>(red + b * BN + o);
#pragma unroll
      for (int w = 0; w < WK; ++w)
#pragma unroll
        for (int u = 0; u < TERMS; ++u) {
          if (w == 0 && u == 0) continue;
          const float4 v = *reinterpret_cast<const float4*>(
              red + (w * NR + u * MT + b) * BN + o);
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
      *reinterpret_cast<float4*>(red + b * BN + o) = sum;
    }
  }
  // each block of the cluster sums its share of the tile over the S
  // blocks in split order, all S reads in flight at once, and stores it
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int e1 = (rank + 1) * QUADS / S;
  for (int e = rank * QUADS / S + tid; e < e1; e += THREADS) {
    const int b = (e * 4) / BN, o = (e * 4) % BN;
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < S)
        v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red + e * 4, q));
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLITS; ++q)
      if (q < S) {
        sum.x += v[q].x; sum.y += v[q].y; sum.z += v[q].z; sum.w += v[q].w;
      }
    if (b < rows) {
      float* y = out + static_cast<size_t>(m0 + b) * N + o0 + o;
      if (N % 4 == 0 && o0 + o + 3 < N) {
        *reinterpret_cast<float4*>(y) = sum;
      } else {
        const float v4[4] = {sum.x, sum.y, sum.z, sum.w};
        for (int c = 0; c < 4 && o0 + o + c < N; ++c) y[c] = v4[c];
      }
    }
  }
  cluster.sync();           // no block leaves while others read its sums
}

template <int FETCH, int KIND, int MT, int WN>
struct Config {
  using Sh = Shape<FETCH, KIND, MT, WN>;

  // blocks an SM holds (0 if that cannot be asked or the block does not
  // fit), asked once; also allows the kernel its shared memory
  static int resident() {
    static int n = -1;
    if (n < 0) {
      auto kernel = lut_kernel<FETCH, KIND, MT, WN>;
      int r = 0;
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Sh::SMEM)) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, kernel, Sh::THREADS,
                                                        Sh::SMEM) != cudaSuccess)
        r = 0;
      cudaGetLastError();   // a block that does not fit is no launch error
      n = r;
    }
    return n;
  }

  static cudaError_t launch(dim3 grid, const void* x, const void* keys, void* out,
                            int M, int N, int K, int G, long long ldx,
                            long long ldk, cudaStream_t stream) {
    if (resident() < 1) return cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(Sh::THREADS);
    cfg.dynamicSmemBytes = Sh::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = grid.y;     // the splits of a column tile
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, lut_kernel<FETCH, KIND, MT, WN>, x,
                              static_cast<const uint8_t*>(keys),
                              static_cast<float*>(out), M, N, K, G, ldx, ldk,
                              static_cast<int>(grid.y));
  }
};

constexpr int kWarpsN[] = {4, 2, 1};    // widest block first
constexpr int kNumLayouts = 3;

template <int FETCH, int KIND, int MT>
int resident(int layout) {
  switch (layout) {
    case 0: return Config<FETCH, KIND, MT, 4>::resident();
    case 1: return Config<FETCH, KIND, MT, 2>::resident();
    default: return Config<FETCH, KIND, MT, 1>::resident();
  }
}

// The plan of one call: grid (column tiles, splits, row tiles) and the
// layout (index into kWarpsN).  Each layout splits K in one, two, four or
// eight (a cluster) until it has `want` blocks: four an SM for row tiles
// of up to 8 (latency sets the pace; more warps hide it), two for taller
// ones (bandwidth does; a wider block shares its table build more).  The
// widest layout that reaches that within one wave of resident blocks
// wins; where none does, the layout with the most blocks in one wave;
// where none fits one wave, the fewest waves.  Returns -1 if no layout
// can run.
template <int FETCH, int KIND, int MT>
int plan(int M, int N, int G, int sms, dim3& grid) {
  const long want = (MT <= 8 ? 4L : 2L) * sms;
  int best = -1, best_splits = 1;
  long best_blocks = 0, best_waves = 0;
  for (int l = 0; l < kNumLayouts; ++l) {
    const int bn = (FETCH == GATHER ? 32 : 16) * kWarpsN[l];
    const int ksteps = (G + SG * (4 / kWarpsN[l]) - 1) / (SG * (4 / kWarpsN[l]));
    const long tiles = long((N + bn - 1) / bn) * ((M + MT - 1) / MT);
    int splits = 1;
    while (splits < MAX_SPLITS && 2 * splits <= ksteps && tiles * splits < want)
      splits *= 2;
    const long slots = long(resident<FETCH, KIND, MT>(l)) * sms;
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
  if (best >= 0) {
    const int bn = (FETCH == GATHER ? 32 : 16) * kWarpsN[best];
    grid = dim3((N + bn - 1) / bn, best_splits, (M + MT - 1) / MT);
  }
  return best;
}

template <int FETCH, int KIND, int MT>
cudaError_t run(const void* x, const void* keys, void* out, int M, int N, int K,
                int G, long long ldx, long long ldk, int sms, cudaStream_t s,
                int* launched) {
  dim3 grid;
  const int l = plan<FETCH, KIND, MT>(M, N, G, sms, grid);
  if (l < 0) return cudaErrorInvalidConfiguration;
  if (launched) {           // the grid, for the caller's record
    launched[0] = grid.x; launched[1] = grid.y; launched[2] = grid.z;
    launched[3] = Shape<FETCH, KIND, MT, 4>::THREADS;
  }
  switch (l) {
    case 0: return Config<FETCH, KIND, MT, 4>::launch(grid, x, keys, out, M, N, K, G, ldx, ldk, s);
    case 1: return Config<FETCH, KIND, MT, 2>::launch(grid, x, keys, out, M, N, K, G, ldx, ldk, s);
    default: return Config<FETCH, KIND, MT, 1>::launch(grid, x, keys, out, M, N, K, G, ldx, ldk, s);
  }
}

template <int FETCH, int KIND>
cudaError_t run_rows(const void* x, const void* keys, void* out, int M, int N,
                     int K, int G, long long ldx, long long ldk, int sms,
                     cudaStream_t s, int* launched) {
  // taller row tiles would spread fewer blocks over the SMs at prefill
  // (M = 32 reads as fast in two tiles of 16: the gather is bound by its
  // shared-memory reads, which every SM must share)
  if (M <= 4) return run<FETCH, KIND, 4>(x, keys, out, M, N, K, G, ldx, ldk, sms, s, launched);
  if (M <= 8) return run<FETCH, KIND, 8>(x, keys, out, M, N, K, G, ldx, ldk, sms, s, launched);
  return run<FETCH, KIND, 16>(x, keys, out, M, N, K, G, ldx, ldk, sms, s, launched);
}

template <int FETCH>
int call(const void* x, int x_kind, const void* keys, void* out, int M, int N,
         int K, int G, int mu, long long ldx, long long ldk, void* stream,
         int* launched) {
  // x rows of ldx elements and key rows of ldk bytes, 16-byte aligned
  const int esize = x_kind == X_F32 ? 4 : x_kind == X_BF16 ? 2 : 1;
  if (mu != MU || M <= 0 || N <= 0 || G <= 0 || x_kind < 0 || x_kind > 2 ||
      K <= (G - 1) * MU || K > G * MU || ldx < K || ldk < G ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(keys) % 16 != 0 || ldx * esize % 16 != 0 ||
      ldk % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == X_F32) e = run_rows<FETCH, X_F32>(x, keys, out, M, N, K, G, ldx, ldk, sms, s, launched);
  else if (x_kind == X_BF16) e = run_rows<FETCH, X_BF16>(x, keys, out, M, N, K, G, ldx, ldk, sms, s, launched);
  else e = run_rows<FETCH, X_I8>(x, keys, out, M, N, K, G, ldx, ldk, sms, s, launched);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// Both entry points: x: [M, K] with row stride ldx (elements), x_kind 0 =
// f32, 1 = bf16, 2 = int8, K the logical width ((G-1)*mu < K <= G*mu: the
// last group may be short); keys: [N, G] uint8 with row stride ldk
// (bytes); out: [M, N] f32, unscaled.  Rows start 16-byte aligned
// (pointers and strides).  Built for mu = 3 only, the group size of every
// configuration the port serves.  Launch on `stream`; where `grid` is not
// null, write the grid launched to it (column tiles, K splits, row tiles,
// threads a block).  Return the launch error (cudaErrorInvalidValue for
// any other mu or a misaligned row).
extern "C" int lut_gather_matmul_f32(const void* x, int x_kind, const void* keys,
                                     void* out, int M, int N, int K, int G,
                                     int mu, long long ldx, long long ldk,
                                     void* stream, int* grid) {
  return call<GATHER>(x, x_kind, keys, out, M, N, K, G, mu, ldx, ldk, stream,
                       grid);
}

extern "C" int lut_onehot_matmul_f32(const void* x, int x_kind, const void* keys,
                                     void* out, int M, int N, int K, int G,
                                     int mu, long long ldx, long long ldk,
                                     void* stream, int* grid) {
  return call<ONEHOT>(x, x_kind, keys, out, M, N, K, G, mu, ldx, ldk, stream,
                       grid);
}
