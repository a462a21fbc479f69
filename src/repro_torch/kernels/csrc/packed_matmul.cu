// Base-3 packed ternary matmuls for Hopper (sm_90a), on the tensor cores:
// dequant_packed (bf16 MMA, f32 sums) and w2a8 (s8 MMA, exact int32 sums).
//
// Replaces two Pallas TPU kernels that stream the same serving artifact,
// base-3 bytes of five trits (1.6 bits a weight), decode them in the tile
// and multiply:
//   * repro/kernels/dequant_matmul.py::packed_matmul (body _dequant_kernel,
//     decode _unpack_block; registry name dequant_packed):
//       y[b, o] = sum_k x[b, k] * trit(o, k)          (unscaled, f32)
//   * repro/kernels/w2a8_matmul.py::w2a8_matmul (body _w2a8_kernel;
//     registry name w2a8): the same sum over int8 x, exact in int32;
// with trit(o, 5j + i) = (byte[o, j] / 3^i) % 3 - 1.  Multiplying by a
// trit decoded to +1, 0 or -1 is exact, so a product on the tensor cores
// is the same add, subtract or skip as the TPU kernels' MXU product.  Both
// run the design of ternary_mma.cuh (full-card grid with split-K summed in
// a thread-block cluster, a 16-byte cp.async ring, trits decoded with no
// division straight into swap-AB mma.sync fragments), which tl2_matmul.cu
// shares for TL2 words and grouped_matmul.cu for expert stacks; the header
// holds the byte encoding (Base3), this source the entries.
//
// What bounds them on the H100.  A bitnet layer, (K, N) in {(2560, 2560)
// x2, (2560, 640) x2, (2560, 6912) x2, (6912, 2560)}, is 69.5 M trits in
// 13.9 MB of bytes: 4.2 us at 3.35 TB/s, the bound at M = 4 and M = 32.
// Its M*N*K adds on the tensor cores, as mma.sync m16n8k16 bf16 (16
// columns x k16 x 8 rows, 272 k MMAs a layer per 8-row tile and bf16
// term) take 1.1 us at M = 4 and 4.5 us at M = 32 at the 989 TFLOP/s peak
// (13.5 us on f32 x's three terms); as m16n8k32 s8, half.  The real work
// is the decode: every trit is decoded once per (column tile, row tile)
// that reads it, and row tiles of 8, 16 or 32 rows cover M = 4 and M = 32
// in one, so once.  At 3.25 integer instructions a trit (below) that is
// 226 M a layer, about 14 us at the H100's 64 integer lanes an SM-clock
// (132 x 64 x 1.98 GHz = 16.7 T/s), less where the multiplies issue to
// the FMA pipe.  Under all of it lies the per-call floor: no call on the
// cold-L2 timer takes much under 9 us, so seven calls cost about 63 us a
// layer whatever the kernel does.  A first design lost to latency instead:
// 5-54 blocks of 128 threads on 132 SMs each walking all of K, byte-wide
// synchronous loads, an integer / 3 and % 3 per trit.  At bitnet's M = 4
// the plan launches 160 blocks at (2560, 640) and 320, 432 and 320 at
// (2560, 2560), (2560, 6912) and (6912, 2560).  At M = 32 a deeper ring
// for 32-row x (26 KB a slot) would leave 2 blocks an SM and two waves at
// (2560, 6912), where 2 slots keep 4 blocks resident.
//
// The encoding.  A lane's 32-bit word is four bytes; the two bytes of each
// 16-bit lane of (w & 0x00FF00FF) and ((w >> 8) & 0x00FF00FF) are the two
// digit planes, so trit L = 5b + i is digit i of byte b: plane b & 1, byte
// 2 (b >> 1) = 2 (L / 10) of the register.  Two instructions a word split
// it; the digits then cost four instructions for two.  The compiled loop
// of the 4 x 16-column layout (4 words a lane a step; python -m
// repro_torch.launch.sass_count) holds 80 PRMT for bf16 and 60 for s8, 20
// and 15 a word as written, beside the IMAD, LOP3 and SHF of the digits
// (26, 10 and 9 a word for bf16) and of the copy addresses: 65
// instructions a bf16 word and 60 an s8 word, so 3.25 and 3.0 integer
// instructions a trit.
//
// Registers: 86-128 a thread and no spills (ptxas); f32 x at M > 8 keeps
// its sums in a 32-128 byte stack frame, as its row tiles are not unrolled.

#include "ternary_mma.cuh"

// Both entries: x: [M, K] with row stride ldx (elements), K the width of x
// (K <= 5 NB; columns past the weight's logical width are zero); packed:
// [N, NB] base-3 bytes with row stride ldw (bytes; the served rows are
// padded to 128); out: [M, N], unscaled.  Rows start 16-byte aligned
// (pointers and strides).  Launch on `stream`; where `grid` is not null,
// write the grid launched to it (column tiles, K splits, row tiles,
// threads a block).  Return the launch error (0 on success).

// dequant_packed: x_kind 0 = f32, 1 = bf16, 2 = int8; out f32.
extern "C" int dequant_packed_matmul_f32(const void* x, int x_kind,
                                         const void* packed, void* out, int M,
                                         int N, int K, int NB, long long ldx,
                                         long long ldw, void* stream, int* grid) {
  switch (x_kind) {
    case X_F32: return call<Base3, X_F32>(x, packed, out, 1, M, N, K, NB, ldx, ldw, stream, grid);
    case X_BF16: return call<Base3, X_BF16>(x, packed, out, 1, M, N, K, NB, ldx, ldw, stream, grid);
    case X_I8: return call<Base3, X_I8>(x, packed, out, 1, M, N, K, NB, ldx, ldw, stream, grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// w2a8: int8 x; out int32, exact.
extern "C" int w2a8_matmul_s32(const void* x, const void* packed, void* out,
                               int M, int N, int K, int NB, long long ldx,
                               long long ldw, void* stream, int* grid) {
  return call<Base3, W2A8>(x, packed, out, 1, M, N, K, NB, ldx, ldw, stream, grid);
}
