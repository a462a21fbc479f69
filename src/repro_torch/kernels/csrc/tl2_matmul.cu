// TL2 ternary matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/tl2_matmul.py::tl2_matmul
// (body _tl2_kernel; registry name tl2):
//   y[b, o] = sum_q table[b, q, digit(o, q)]
//   table[b, q, d] = (d/3 - 1) * x[b, 2q] + (d%3 - 1) * x[b, 2q + 1]
// where trit pairs are base-9 digits, five per 16-bit word (word = sum_p
// d_p * 9^p, 1.6 bits a weight), f32 sums.  That is y[b, o] = sum_k x[b,
// k] * trit(o, k), unscaled: the TPU kernel's tables and one-hot fetch
// only pick each pair's sum, and multiplying x by a trit decoded to +1, 0
// or -1 on the tensor cores is the same add, subtract or skip.
//
// What bounds it on the H100.  A bitnet layer, (K, N) in {(2560, 2560)
// x2, (2560, 640) x2, (2560, 6912) x2, (6912, 2560)}, is 69.5 M trits in
// 13.9 MB of words: 4.2 us at 3.35 TB/s, the bound at M = 1, 2, 4 and 32
// (as m16n8k16 bf16 MMAs on 8-row tiles its adds take 1.1 us at the 989
// TFLOP/s peak for any M <= 8, 4.5 us at M = 32; as s8 MMAs half).  The real
// work is the decode, and under it the per-call floor: no call on the
// cold-L2 timer takes much under 9 us, so seven calls cost about 63 us a
// layer whatever the kernel does.  A first design lost 4.9x to the bf16
// matmul on decoded weights at M = 1: 5-54 blocks of 128 threads each
// walking all of K, synchronous 2-byte word and f32 x loads, f32 pair
// tables built per block and step, and five div / mod 9 a word.
//
// The design is ternary_mma.cuh's (packed_matmul.cu runs it on base-3
// bytes): a full-card grid with K split in a thread-block cluster and
// summed in split order (two calls are bitwise equal), a 16-byte cp.async
// ring of words and x read at their strides, and swap-AB mma.sync with
// the trits as A: m16n8k16 bf16 with f32 sums for bf16 x, and for f32 x
// three bf16 terms by truncation; m16n8k32 s8 with exact int32 sums for
// int8 x, converted to f32 as they are stored (|sum| <= 127 K < 2^24).
// x comes as it is (f32, bf16 or int8, K wide; staged as zero past K, so
// the last word's spare trits and the zero-filled rest of a chunk add
// nothing), and the words as served, rows padded to 16 bytes with the
// word of ten zero trits.  A TL2 word holds five trits a byte, as base-3
// bytes do, so a warp's 32 bytes are 160 trits and the grid, ring and
// fragment layout carry over unchanged.
//
// The encoding, decoded with no division.  A word is the 10-digit base-3
// number v = sum_p ((t_2p + 1) 3 + (t_2p+1 + 1)) 9^p: trit k is base-3
// digit k ^ 1 (each pair swapped).  v < 59049, and v / 243 = (v * 69043)
// >> 24 exactly for every such v (checked on the CPU), so one IMAD.HI a
// word (69043 * 2^8 as the high-word multiplier) and one PRMT put the two
// words' high halves hi = v / 243 (digits 5-9) in the 16-bit lanes of one
// register, and one IMAD makes lo = w - 243 hi (digits 0-4) in the lanes
// of another, with no borrow between them.  Both are below 243, as a
// base-3 byte is, and the digits come out four instructions for two.  The
// pair swap costs nothing: trit L of the 32-bit word is digit (L % 10) ^ 1
// of its word, and the byte permutes that gather digits into fragments
// take it from plane ((L % 10) ^ 1) / 5, so B stays contiguous runs of x.
// The compiled loop of the 4 x 16-column layout at one 8-row tile (4
// words a lane a step; python -m repro_torch.launch.sass_count --source
// tl2_matmul) holds 656 instructions for bf16 and 581 for s8, 18 more than
// packed_matmul.cu's same loops (638 and 563): 4.5 a word (PRMT 84 for
// 80, IMAD 254 for 240), so about 69.5 integer instructions a bf16 word
// and 64.5 an s8 word as packed_matmul.cu counts them, 3.5 and 3.2 a trit.
// Registers: 86-128 a thread and no spills (ptxas).
// (tl2_matmul.fragment_digits models which digit of which word A reads for
// each k slot; the CPU tests check that A and B take the same K order and
// that the recipe gives unpack_tl2's trits for every word value.)

#include "ternary_mma.cuh"

namespace {

// TL2 words: trit L of a 32-bit word (two words, ten trits each) is base-3
// digit (L % 10) ^ 1 of word L / 10; digits 0-4 of each word in plane 0,
// digits 5-9 in plane 1, the word's 16-bit lane = byte 2 (L / 10).
struct TL2 {
  static constexpr int UNIT_BYTES = 2;
  static constexpr bool EXPERTS = false;
  static __device__ __forceinline__ void planes(uint32_t w, uint32_t (&d)[2][5]) {
    // v / 243 = (v * 69043) >> 24 = umulhi(v, 69043 << 8) for v < 59049
    const uint32_t hi = prmt(__umulhi(w & 0xFFFFu, 69043u << 8),
                             __umulhi(w >> 16, 69043u << 8), 0x5410u);
    digits(w - 243u * hi, d[0]);
    digits(hi, d[1]);
  }
  static __host__ __device__ constexpr int plane(int L) { return ((L % 10) ^ 1) / 5; }
  static __host__ __device__ constexpr int digit(int L) { return ((L % 10) ^ 1) % 5; }
};

}  // namespace

// x: [M, K] with row stride ldx (elements), K the width of x (K <= 10 W;
// columns past the weight's logical width are zero); x_kind 0 = f32, 1 =
// bf16, 2 = int8.  words: [N, W] 16-bit TL2 words (held as int16 by the
// caller, read here as unsigned) with row stride ldw (words; the served
// rows are padded to 16 bytes).  out: [M, N] f32, unscaled.  Rows start
// 16-byte aligned (pointers and strides).  Launch on `stream`; where
// `grid` is not null, write the grid launched to it (column tiles, K
// splits, row tiles, threads a block).  Return the launch error (0 on
// success).
extern "C" int tl2_matmul_f32(const void* x, int x_kind, const void* words,
                              void* out, int M, int N, int K, int W,
                              long long ldx, long long ldw, void* stream,
                              int* grid) {
  if (W <= 0 || W > (1 << 29)) return static_cast<int>(cudaErrorInvalidValue);
  const int NB = 2 * W;
  const long long ldb = 2 * ldw;
  switch (x_kind) {
    case X_F32: return call<TL2, X_F32>(x, words, out, 1, M, N, K, NB, ldx, ldb, stream, grid);
    case X_BF16: return call<TL2, X_BF16>(x, words, out, 1, M, N, K, NB, ldx, ldb, stream, grid);
    case X_I8: return call<TL2, S8_F32>(x, words, out, 1, M, N, K, NB, ldx, ldb, stream, grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
