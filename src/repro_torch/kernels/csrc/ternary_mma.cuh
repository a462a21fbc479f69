// The packed-ternary tensor-core matmul shared by packed_matmul.cu
// (dequant_packed, w2a8: base-3 bytes), grouped_matmul.cu (grouped_dequant,
// grouped_w2a8: base-3 bytes, one matrix per expert) and tl2_matmul.cu
// (tl2: TL2 words):
//   y[e, b, o] = sum_k x[e, b, k] * trit(e, o, k)          (unscaled)
// over rows of packed trits that hold five trits a byte in both encodings,
// for E experts (E = 1 for the dense entries).  The base-3 byte encoding
// (Base3) is this header's; tl2_matmul.cu defines its own (how a lane's
// 32-bit word, 20 trits, becomes base-3 digit planes; see Word).  Each
// source holds its C entries; the grid plan, the copy ring, the decode
// into fragments, the MMAs and the split-K sum are this header's,
// instantiated per source.
//
// 1. Full-card grid, deterministic split-K.  A block of 4 warps owns 64
//    output columns (2 warps of 32, the other 2 splitting each step along
//    K; or 4 x 16), or where N is small 32 or 16 columns (2 or 3 more
//    warps along K); MT = 8, 16 or 32 activation rows (the smallest that
//    covers M, the rows of one expert); and a balanced share of K.  grid.z
//    is e * (row tiles) + row tile: expert e's x rows start at row e M of
//    an [E M, K] view, its weight rows at row e N of an [E N, NB] view and
//    its output at row e M of [E M, N]; the offsets fold into the row
//    indices and the weight address before the main loop.  An encoding
//    marks expert stacks (Enc::EXPERTS); one-matrix sources (E = 1) keep
//    grid.z the row tile and compile with no expert arithmetic at all.
//    The tiles are E x column tiles x row tiles.  K splits in 1,
//    2, 4 or 8 until there are two blocks an SM, and the plan takes the
//    widest layout that gets there within one wave of resident blocks
//    (asked of the runtime once per kernel), else the one with most blocks
//    in one wave, as signflip_matmul.cu's plan does.  The S blocks of a
//    column tile form one thread-block cluster: each leaves its partial
//    tile in shared memory, and after a cluster barrier each sums a 1 / S
//    share of the tile over the S blocks' shared memory (distributed shared
//    memory), in split order, and stores it.  No atomics: two calls on the
//    same inputs are bitwise equal.  The entry reports the grid it launched.
// 2. Rows and x as served, in a 16-byte cp.async ring.  A step is 32 bytes
//    of each row a warp along K takes (160 trits), so BN x 32 WK bytes (2
//    or 4 KB), and the same 160 WK values of each x row below M; both
//    arrive by cp.async, 16 bytes a thread, into a ring of 4 slots, so
//    loads stay in flight while a step decodes; 3 or 2 where a slot passes
//    12 or 16 KB (x of 16 or 32 rows): a block holds only 1-3 steps at
//    bitnet's shapes, so residency matters more than depth.  Rows stream
//    past L1 (.cg); x, which every column tile reads again, is cached there
//    too (.ca).  Rows are read at their strides (a served row's padding is
//    never read): copies stop at the bytes that cover K (whole code units),
//    and never read past a row's NB bytes (src-size), the rest of a chunk
//    reads as zero.  x stages as zero past K, so whatever trits the zero
//    bytes or the last unit's spare trits decode to add nothing; x rows
//    past M are not staged at all (they reach only output rows that are not
//    stored).  The row tile's 16-byte chunks are XOR-swizzled by row so the
//    8 rows of a fragment read fall in distinct banks; the x rows are
//    padded for the same (see x_row_bytes).
// 3. x as it comes, one instantiation per kind.  f32 x splits, as its
//    fragments are read, into three bf16 terms by truncation (hi = x with
//    its low 16 bits cleared, mid = (x - hi) alike, lo = x - hi - mid;
//    exact for |x| >= 2^-110, as in signflip_matmul.cu point 4), all summed
//    into the same f32 sums.  bf16 x is one exact term; int8 x on the bf16
//    MMA is widened to one exact bf16 term by a byte permute and one f32
//    subtraction, and on the s8 MMA is read as it is.
// 4. Decode straight into tensor-core fragments, swap-AB.  The trits are
//    the 16-row A operand (rows = output columns), x the 8-column B operand
//    (columns = activation rows).  Lane t of a quad holds, for rows g and g
//    + 8, the 32-bit words at bytes 4t and 16 + 4t of each 32-byte warp
//    chunk: trits 20t .. 20t + 19 and 80 + 20t .., read with one 32-bit
//    shared load each.  The K order inside a chunk is permuted alike for A
//    and B so that each lane's fragments come out of its own words with no
//    shuffle:
//      bf16 (m16n8k16, 10 MMAs a chunk): MMA (c, s), lane t's k slots {2t,
//        2t + 1, 2t + 8, 2t + 9} are trits 80c + 20t + 4s + {0, 1, 2, 3},
//        so its B fragment is one 8-byte shared load of x;
//      s8 (m16n8k32, 5 MMAs a chunk): MMA s, lane t's k slots 4t + {0..3}
//        are trits 20t + 4s + {0..3} and slots 4t + 16 + {0..3} are 80 +
//        20t + 4s + {0..3}: B is two 4-byte loads.
//    (dequant_matmul.fragment_trits models this order, and
//    tl2_matmul.fragment_digits where A reads each trit in a TL2 word; the
//    CPU tests check both.)  The encoding turns a word into two registers
//    of two values below 243 in 16-bit lanes, each five base-3 digits, and
//    digits() splits both lanes at once with no division: v / 3 = (v *
//    171) >> 9 for v < 256, and 242 * 171 < 2^16, so no carry crosses the
//    lanes; the digit is v - 3q.  Trit L of the word is digit
//    Enc::digit(L) of plane Enc::plane(L), in byte 2 (L / 10) of that
//    register.  A bf16 pair takes a byte permute that gathers its two
//    digits, one multiply-add that makes each a selector nibble pair (d, d
//    + 4), and a byte permute that looks both up (0xBF80, 0, 0x3F80 for
//    digit 0, 1, 2): 3 instructions for 2 trits.  An s8 quad takes three
//    byte permutes that gather its four digits, then + 0x7F and ^ 0x80 a
//    byte (0xFF, 0, 1).  No integer division, no int-to-float conversion,
//    no table in memory (a warp's reads of a 243-entry table would fall on
//    random entries and conflict).
// 5. Exactness.  On the s8 MMA int8 x trit products sum in int32 (at most
//    127 * K, far inside it); the bf16 MMA on int8 x sums integers below
//    2^24 in f32.  Both are exact.
//
// Ragged edges are masked: columns past N and k past K load as zero, and
// what lies past N or M is not stored.  The 16-byte copies need rows that
// start 16-byte aligned (pointers and strides): the served rows are, the
// entries refuse any other, and the wrappers copy such an input first.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;        // 4 warps
constexpr int MAX_SPLITS = 8;       // a portable cluster
constexpr int WARP_BYTES = 32;      // bytes of a row a warp decodes a step
constexpr int TRITS_PER_BYTE = 5;   // in base-3 bytes and TL2 words alike
constexpr int WARP_TRITS = TRITS_PER_BYTE * WARP_BYTES;

// x kinds and MMAs: X_F32, X_BF16 and X_I8 feed the bf16 MMA (f32 sums);
// W2A8 and S8_F32 feed int8 x to the s8 MMA (exact int32 sums), stored as
// int32 and as f32
enum Mode { X_F32 = 0, X_BF16 = 1, X_I8 = 2, W2A8 = 3, S8_F32 = 4 };

template <int MODE> struct Traits;
template <> struct Traits<X_F32> { using T = float; using Acc = float; using Out = float; static constexpr int TERMS = 3; static constexpr bool S8 = false; };
template <> struct Traits<X_BF16> { using T = uint16_t; using Acc = float; using Out = float; static constexpr int TERMS = 1; static constexpr bool S8 = false; };
template <> struct Traits<X_I8> { using T = int8_t; using Acc = float; using Out = float; static constexpr int TERMS = 1; static constexpr bool S8 = false; };
template <> struct Traits<W2A8> { using T = int8_t; using Acc = int32_t; using Out = int32_t; static constexpr int TERMS = 1; static constexpr bool S8 = true; };
template <> struct Traits<S8_F32> { using T = int8_t; using Acc = int32_t; using Out = float; static constexpr int TERMS = 1; static constexpr bool S8 = true; };

// Bytes of one staged x row of a step: the WK K-warps' 160 values each,
// padded so that rows start 32 (bf16: 8-byte reads, lanes 40 bytes apart),
// 64 (f32: 16-byte reads, 80 apart) or 16 (int8: 4-byte reads, 20 apart)
// bytes apart modulo 128, where a fragment read's lanes hit distinct banks.
__host__ __device__ constexpr int x_row_bytes(int wk, int elem) {
  const int raw = WARP_TRITS * wk * elem;
  const int want = elem == 4 ? 64 : elem == 2 ? 32 : 16;
  return raw + (want - raw % 128 + 128) % 128;
}

// ring slots: 4, or 3 and 2 where a slot (x of 16 or 32 rows) is large,
// so that 4 blocks an SM stay resident (see the note, point 2)
__host__ __device__ constexpr int stages_for(int slot_bytes) {
  return slot_bytes <= 12288 ? 4 : slot_bytes <= 16384 ? 3 : 2;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The five base-3 digits of the two values (each < 243) in the 16-bit
// lanes of p: d[i] holds digit i of each, 0, 1 or 2.  v / 3 = (v * 171) >>
// 9 for v < 256, and 242 * 171 < 2^16, so one multiply, shift and mask
// divide both lanes at once; the digit is v - 3q, with no borrow between
// lanes.
__device__ __forceinline__ void digits(uint32_t p, uint32_t (&d)[5]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t q = ((p * 171u) >> 9) & 0x007F007Fu;
    d[i] = p - 3u * q;
    p = q;
  }
  d[4] = p;                           // v / 81 < 3
}

// One lane's 32-bit word of a row (20 trits) as digit planes: Enc::planes
// fills d[plane][i] with digit i of the 16-bit lanes of that plane; trit L
// is digit Enc::digit(L) of plane Enc::plane(L), in byte 2 (L / 10).
template <class Enc>
struct Word {
  uint32_t d[2][5];
  __device__ __forceinline__ explicit Word(uint32_t w) { Enc::planes(w, d); }
  __device__ __forceinline__ uint32_t reg(int L) const {
    return d[Enc::plane(L)][Enc::digit(L)];
  }
  // a prmt selector that puts trit L's digit in byte 0 and L2's in byte 1
  static __device__ __forceinline__ uint32_t gather(int L, int L2) {
    return ((L / 10) * 2) | ((4 + (L2 / 10) * 2) << 4);
  }
};

// Base-3 bytes: five trits a byte, trit L of a 32-bit word is digit L % 5
// of byte L / 5.
struct Base3 {
  static constexpr int UNIT_BYTES = 1;
  static constexpr bool EXPERTS = false;    // one matrix (see packed_kernel)
  static __device__ __forceinline__ void planes(uint32_t w, uint32_t (&d)[2][5]) {
    digits(w & 0x00FF00FFu, d[0]);
    digits((w >> 8) & 0x00FF00FFu, d[1]);
  }
  static __host__ __device__ constexpr int plane(int L) { return (L / 5) & 1; }
  static __host__ __device__ constexpr int digit(int L) { return L % 5; }
};

// Trits L and L + 1 of a word as a bf16 pair (L in the low half).  The two
// digits, gathered into bytes 0 and 1, become prmt selector nibble pairs
// (d, d + 4) that look up bytes {0x80, 0x00, 0x80} and {0xBF, 0x00, 0x3F}:
// digit 0, 1, 2 -> 0xBF80, 0, 0x3F80 (-1, 0, +1).
template <class Enc>
__device__ __forceinline__ uint32_t bf16_pair(const Word<Enc>& w, int L) {
  const uint32_t s = prmt(w.reg(L), w.reg(L + 1), Word<Enc>::gather(L, L + 1));
  return prmt(0x00800080u, 0x003F00BFu, s * 0x11u + 0x4040u);
}

// Trits L .. L + 3 of a word as four s8 (byte j = trit L + j): the digits
// gathered into bytes, then d + 0x7F ^ 0x80 a byte: 0xFF, 0x00, 0x01.
template <class Enc>
__device__ __forceinline__ uint32_t s8_quad(const Word<Enc>& w, int L) {
  const uint32_t lo = prmt(w.reg(L), w.reg(L + 1), Word<Enc>::gather(L, L + 1));
  const uint32_t hi = prmt(w.reg(L + 2), w.reg(L + 3), Word<Enc>::gather(L + 2, L + 3));
  return (prmt(lo, hi, 0x5410u) + 0x7F7F7F7Fu) ^ 0x80808080u;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes to shared memory, of which the first `valid` come from src and
// the rest are zero.  Rows stream past L1 (.cg); x, which every column
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

// f32 -> hi, mid, lo bf16 terms by truncation (see the note, point 3).
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

// The bf16 MMA's B fragment of one MMA: x[g][k .. k + 4) at p as two
// bf16x2 words per term, b[q][0..1] (int8 x widened, f32 x split).
template <int MODE>
__device__ __forceinline__ void load_b(const unsigned char* p, uint32_t (&b)[3][2]) {
  if constexpr (MODE == X_BF16) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    b[0][0] = v.x;
    b[0][1] = v.y;
  } else if constexpr (MODE == X_I8) {
    // each byte biased to v + 128 under the f32 2^23, less 2^23 + 128: v
    // exactly, without the quarter-rate int-to-float conversion
    const uint32_t u = ld32(p) ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(prmt(u, 0x4B000000u, 0x7650u + i)) - 8388736.0f;
    b[0][0] = prmt(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
    b[0][1] = prmt(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
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

template <typename Acc>
__device__ __forceinline__ Acc from_bits(uint32_t u) {
  if constexpr (std::is_floating_point<Acc>::value) return __uint_as_float(u);
  else return static_cast<Acc>(static_cast<int32_t>(u));
}

// One block: columns [o0, o0 + 16 WN RT), rows [m0, m0 + 8 NT) of expert
// blockIdx.z / (row tiles) (M rows and N columns an expert), the steps
// of split blockIdx.y (a balanced share of ceil(JB / SB) steps of SB = 32
// WK bytes a row; JB = the bytes that cover K).  Warp w owns the 16 RT
// columns from 16 RT (w % WN) and the (w / WN)-th 32 bytes of each step.
// A ring slot holds a step's row bytes ([BN][SB], 16-byte chunks
// XOR-swizzled by row) and its x ([8 NT][x_row_bytes]).  The S blocks of a
// column tile form one cluster; with S > 1 each leaves its partial tile in
// shared memory and sums a 1 / S share of the tile over all S, in split
// order.
template <int MODE, int NT, int WN, int RT, class Enc>
__global__ void __launch_bounds__(THREADS, 4)
packed_kernel(const void* __restrict__ xv, const uint8_t* __restrict__ w,
              void* __restrict__ outv, int M, int N, int K, int JB,
              long long ldx, long long ldw, int S) {
  using T = typename Traits<MODE>::T;
  using Acc = typename Traits<MODE>::Acc;
  using Out = typename Traits<MODE>::Out;
  constexpr int TERMS = Traits<MODE>::TERMS;
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int MT = 8 * NT;
  constexpr int BN = 16 * WN * RT;          // columns per block
  constexpr int WK = 4 / WN;                // warps along K
  constexpr int SB = WARP_BYTES * WK;       // bytes of a row a step
  constexpr int STEP = BN * SB;
  constexpr int CPR = SB / 16;              // 16-byte chunks a row
  constexpr int LINE_ROWS = 8 / CPR;        // rows a 128-byte line holds
  constexpr int EPC = 16 / ESZ;             // x values a chunk
  constexpr int XK = TRITS_PER_BYTE * SB;   // x values a row a step
  constexpr int XCPR = XK / EPC;
  constexpr int XROW = x_row_bytes(WK, ESZ);
  constexpr int SLOT = STEP + MT * XROW;
  constexpr int STAGES = stages_for(SLOT);
  static_assert(STEP % (16 * THREADS) == 0, "whole chunks per thread");
  extern __shared__ __align__(16) unsigned char smem[];

  const T* x = static_cast<const T*>(xv);
  Out* out = static_cast<Out*>(outv);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wk = warp / WN;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  // grid.z = e * row tiles + row tile over expert stacks (Enc::EXPERTS),
  // else the row tile (E = 1): the tile's rows are rows [m0, m0 + MT) of
  // expert e, whose x and output rows start at row erow = e M of x [E M, K]
  // and out [E M, N] and whose weight rows start at row e N; the offsets
  // are taken here, once (for E = 1 they fold away at compile time)
  int m0 = blockIdx.z * MT, erow = 0;
  if constexpr (Enc::EXPERTS) {
    const int row_tiles = (M + MT - 1) / MT;
    const int expert = blockIdx.z / row_tiles;
    m0 = (blockIdx.z - expert * row_tiles) * MT;
    erow = expert * M;
    w += static_cast<long long>(expert) * N * ldw;
  }
  const int ksteps = (JB + SB - 1) / SB;
  const int s0 = static_cast<int>(static_cast<long long>(split) * ksteps / S);
  const int nsteps =
      static_cast<int>(static_cast<long long>(split + 1) * ksteps / S) - s0;
  const int xrows = min(MT, M - m0);        // x rows past M are not staged

  // 16-byte chunk c of row r lies at chunk c ^ swz(r): the 8 rows g of a
  // fragment read (8 or 16 apart in the tile: the same swizzle) fall in
  // distinct 16-byte slots of a 128-byte line
  auto swz = [&](int r) { return (r / LINE_ROWS) & (CPR - 1); };
  // Each thread copies the 16-byte chunk at one column of every WROWS-th
  // row of a step, the same for every step: its sources advance by SB
  // bytes a step.  Past N or JB reads as 0.
  constexpr int WROWS = THREADS / CPR;
  const int wr = tid / CPR, wch = tid % CPR;
  const int wb0 = s0 * SB + wch * 16;
  const uint8_t* wsrc = w + (o0 + wr) * ldw + wb0;
  const int wdst = wr * SB + ((wch ^ swz(wr)) * 16);
  auto load_step = [&](int step, int slot) {
    unsigned char* dst = smem + slot * SLOT;
    const int db = step * SB;
    const int wv = max(0, min(16, JB - wb0 - db));
#pragma unroll
    for (int i = 0; i < STEP / 16 / THREADS; ++i) {
      const int valid = o0 + wr + i * WROWS < N ? wv : 0;
      copy16(dst + wdst + i * WROWS * SB, valid ? wsrc + i * WROWS * ldw + db : w, valid);
    }
    const int k0 = (s0 + step) * XK;
    for (int c = tid; c < xrows * XCPR; c += THREADS) {
      const int r = c / XCPR, k = k0 + (c % XCPR) * EPC;
      const int valid = max(0, min(EPC, K - k)) * ESZ;
      copy16<true>(dst + STEP + r * XROW + (c % XCPR) * 16,
                   valid ? x + (erow + m0 + r) * ldx + k : x, valid);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_step(s, s);
    cp_async_commit();
  }

  Acc acc[RT][NT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][n][j] = Acc(0);

  // this lane's words: rows g and g + 8 of each column tile, bytes 4t and
  // 16 + 4t of its warp's 32-byte chunk (chunks 2 wk and 2 wk + 1)
  const int arow = (16 * RT * wn + g) * SB + 4 * t;
  const int aoff0 = ((2 * wk) ^ swz(g)) * 16, aoff1 = ((2 * wk + 1) ^ swz(g)) * 16;
  const int xoff = STEP + g * XROW + (wk * WARP_TRITS + 20 * t) * ESZ;
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();        // step i landed; every warp is done with i - 1
    if (i + STAGES - 1 < nsteps) load_step(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const unsigned char* slot = smem + (i % STAGES) * SLOT;
    if constexpr (!Traits<MODE>::S8) {
      // word c: MMAs (c, 0..4); lane t's k slots {2t, 2t+1, 2t+8, 2t+9} of
      // MMA (c, s) are trits 80c + 20t + 4s + {0..3}
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t a[RT][5][4];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const unsigned char* p = slot + arow + 16 * r * SB + (c ? aoff1 : aoff0);
          const Word<Enc> lo(ld32(p)), hi(ld32(p + 8 * SB));
#pragma unroll
          for (int s = 0; s < 5; ++s) {
            a[r][s][0] = bf16_pair(lo, 4 * s);
            a[r][s][1] = bf16_pair(hi, 4 * s);
            a[r][s][2] = bf16_pair(lo, 4 * s + 2);
            a[r][s][3] = bf16_pair(hi, 4 * s + 2);
          }
        }
        // (f32 x: one 8-row tile at a time, or its split fragments crowd
        // the registers)
#pragma unroll (MODE == X_F32 ? 1 : NT)
        for (int n = 0; n < NT; ++n) {
          const unsigned char* xr = slot + xoff + n * 8 * XROW + 80 * c * ESZ;
#pragma unroll
          for (int s = 0; s < 5; ++s) {
            uint32_t b[3][2];
            load_b<MODE>(xr + 4 * s * ESZ, b);
#pragma unroll
            for (int q = 0; q < TERMS; ++q)
#pragma unroll
              for (int r = 0; r < RT; ++r) mma_bf16(acc[r][n], a[r][s], b[q][0], b[q][1]);
          }
        }
      }
    } else {
      // MMA s: lane t's k slots 4t + {0..3} are trits 20t + 4s + {0..3} of
      // word 0, slots 4t + 16 + {0..3} the same of word 1 (80 trits on)
      uint32_t a[RT][5][4];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const unsigned char* p = slot + arow + 16 * r * SB;
        const Word<Enc> lo0(ld32(p + aoff0)), hi0(ld32(p + 8 * SB + aoff0));
        const Word<Enc> lo1(ld32(p + aoff1)), hi1(ld32(p + 8 * SB + aoff1));
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          a[r][s][0] = s8_quad(lo0, 4 * s);
          a[r][s][1] = s8_quad(hi0, 4 * s);
          a[r][s][2] = s8_quad(lo1, 4 * s);
          a[r][s][3] = s8_quad(hi1, 4 * s);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const unsigned char* xr = slot + xoff + n * 8 * XROW;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          const uint32_t b0 = ld32(xr + 4 * s), b1 = ld32(xr + 80 + 4 * s);
#pragma unroll
          for (int r = 0; r < RT; ++r) mma_s8(acc[r][n], a[r][s], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();          // the ring is free for the sums below

  Acc* red = reinterpret_cast<Acc*>(smem);
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
            if (o < N && b < M) out[static_cast<size_t>(erow + b) * N + o] = static_cast<Out>(acc[r][n][j]);
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
    Acc sum[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
    for (int q = 0; q < S; ++q) {
      const uint4 v = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(red + e * 4, q));
      sum[0] += from_bits<Acc>(v.x);
      sum[1] += from_bits<Acc>(v.y);
      sum[2] += from_bits<Acc>(v.z);
      sum[3] += from_bits<Acc>(v.w);
    }
    if (b < M) {
      Out* y = out + static_cast<size_t>(erow + b) * N + o;
      for (int c = 0; c < 4 && o + c < N; ++c) y[c] = static_cast<Out>(sum[c]);
    }
  }
  cluster.sync();           // no block leaves while others read its sums
}

// Column layouts: warps along N (the other 4 / WN split each step along
// K) and 16-column tiles a warp owns.
struct Layout { int wn, rt; };
constexpr Layout kLayouts[] = {{2, 2}, {4, 1}, {2, 1}, {1, 1}};
constexpr int kNumLayouts = 4;

template <int MODE, int NT, int WN, int RT, class Enc>
struct Config {
  static constexpr int WK = 4 / WN;
  static constexpr int SLOT = 16 * WN * RT * WARP_BYTES * WK +
      8 * NT * x_row_bytes(WK, sizeof(typename Traits<MODE>::T));
  static constexpr int RED = 4 * (8 * NT * 16 * WN * RT > (WK - 1) * WN * RT * NT * 4 * 32
                                      ? 8 * NT * 16 * WN * RT
                                      : (WK - 1) * WN * RT * NT * 4 * 32);
  static constexpr size_t SMEM = size_t(stages_for(SLOT) * SLOT > RED ? stages_for(SLOT) * SLOT : RED);

  // blocks an SM holds (0 if that cannot be asked), asked once; also
  // allows the kernel its shared memory
  static int resident() {
    static int n = -1;
    if (n < 0) {
      auto kernel = packed_kernel<MODE, NT, WN, RT, Enc>;
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
                            int M, int N, int K, int JB, long long ldx,
                            long long ldw, cudaStream_t stream) {
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
    return cudaLaunchKernelEx(&cfg, packed_kernel<MODE, NT, WN, RT, Enc>, x,
                              static_cast<const uint8_t*>(w), out, M, N, K, JB,
                              ldx, ldw, static_cast<int>(grid.y));
  }
};

template <int MODE, int NT, class Enc>
int resident(int layout) {
  switch (layout) {
    case 0: return Config<MODE, NT, 2, 2, Enc>::resident();
    case 1: return Config<MODE, NT, 4, 1, Enc>::resident();
    case 2: return Config<MODE, NT, 2, 1, Enc>::resident();
    default: return Config<MODE, NT, 1, 1, Enc>::resident();
  }
}

// Column layout and splits of one call over E experts of M rows: a layout
// has E x column tiles x row tiles, and splits K in one,
// two, four or eight (a cluster) until it has two blocks an SM.  The
// widest layout that reaches that within one wave of resident blocks
// wins; where none does, the layout with the most blocks in one wave;
// where none fits one wave, the fewest waves.
template <int MODE, int NT, class Enc>
cudaError_t run(const void* x, const void* w, void* out, int E, int M, int N,
                int K, int JB, long long ldx, long long ldw, int sms,
                cudaStream_t stream, int* launched) {
  const long want = 2L * sms;
  int best = -1, best_splits = 1;
  long best_blocks = 0, best_waves = 0;
  for (int l = 0; l < kNumLayouts; ++l) {
    const int wn = kLayouts[l].wn, bn = 16 * wn * kLayouts[l].rt;
    const int sb = WARP_BYTES * (4 / wn);
    const int ksteps = (JB + sb - 1) / sb;
    const long tiles = long(E) * ((N + bn - 1) / bn) * ((M + 8 * NT - 1) / (8 * NT));
    int splits = 1;
    while (splits < MAX_SPLITS && 2 * splits <= ksteps && tiles * splits < want)
      splits *= 2;
    const long slots = long(resident<MODE, NT, Enc>(l)) * sms;
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
  const dim3 grid((N + bn - 1) / bn, best_splits, E * ((M + 8 * NT - 1) / (8 * NT)));
  if (launched) {           // the grid, for the caller's record
    launched[0] = grid.x; launched[1] = grid.y; launched[2] = grid.z;
    launched[3] = THREADS;
  }
  switch (best) {
    case 0: return Config<MODE, NT, 2, 2, Enc>::launch(grid, x, w, out, M, N, K, JB, ldx, ldw, stream);
    case 1: return Config<MODE, NT, 4, 1, Enc>::launch(grid, x, w, out, M, N, K, JB, ldx, ldw, stream);
    case 2: return Config<MODE, NT, 2, 1, Enc>::launch(grid, x, w, out, M, N, K, JB, ldx, ldw, stream);
    default: return Config<MODE, NT, 1, 1, Enc>::launch(grid, x, w, out, M, N, K, JB, ldx, ldw, stream);
  }
}

// One call over E experts: x [E M, K] at row stride ldx (elements), rows
// of NB bytes, [E N] of them, at stride ldw (bytes), both 16-byte aligned;
// out [E, M, N].  The copies read the bytes that cover K in whole code
// units of Enc::UNIT_BYTES (five trits a byte).
template <class Enc, int MODE>
int call(const void* x, const void* w, void* out, int E, int M, int N, int K,
         int NB, long long ldx, long long ldw, void* stream, int* launched) {
  const long long esize = sizeof(typename Traits<MODE>::T);
  const long long row_tiles = M <= 16 ? 1 : (M + 31) / 32;   // a row tile of 8, 16 or 32
  if (E <= 0 || (E > 1 && !Enc::EXPERTS) || M <= 0 || N <= 0 || K <= 0 || NB <= 0 ||
      E * row_tiles > 65535 || K > 1LL * TRITS_PER_BYTE * NB ||
      ldx < K || ldw < NB || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || ldx * esize % 16 != 0 ||
      ldw % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int UNIT_TRITS = TRITS_PER_BYTE * Enc::UNIT_BYTES;
  const int cover = (K + UNIT_TRITS - 1) / UNIT_TRITS * Enc::UNIT_BYTES;
  const int JB = cover < NB ? cover : NB;                 // bytes covering K
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) e = run<MODE, 1, Enc>(x, w, out, E, M, N, K, JB, ldx, ldw, sms, s, launched);
  else if (M <= 16) e = run<MODE, 2, Enc>(x, w, out, E, M, N, K, JB, ldx, ldw, sms, s, launched);
  else e = run<MODE, 4, Enc>(x, w, out, E, M, N, K, JB, ldx, ldw, sms, s, launched);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace
