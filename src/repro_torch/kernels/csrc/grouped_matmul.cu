// Grouped (batched-expert) base-3 packed ternary matmuls for Hopper
// (sm_90a), on the tensor cores: the MoE expert stacks, one launch for all
// experts.
//
// Replaces the Pallas TPU kernel of repro/kernels/grouped_matmul.py,
// _grouped_kernel with its padding and call _pad_and_call (:45-107), as
// reached by
//   * grouped_packed_matmul (registry grouped_dequant), float activations:
//       y[e, c, o] = sum_k x[e, c, k] * trit(e, o, k)     (f32 sums)
//   * grouped_w2a8_matmul (registry grouped_w2a8), int8 activations:
//       y[e, c, o] = sum_k x_q[e, c, k] * trit(e, o, k)   (exact int32)
// with trit(e, o, 5j + i) = (byte[e, o, j] / 3^i) % 3 - 1.  The largest
// int32 sum, 6400 * 127 at phi3.5-moe's widest K, is far inside int32.
//
// What bounds it on the H100.  Every expert's bytes stream on every call,
// whatever number of tokens an expert got: a phi3.5-moe expert stack is
// 16 x 6400 x 820 bytes (wi, wg) or 16 x 4096 x 1280 (wo), about 84 MB,
// 25 us at 3.35 TB/s, so 0.0756 ms a layer of three stacks, whatever the
// capacity C (rows an expert: 1 at decode, 5 at a 32-token admission
// chunk).  The decode is the larger cost: a layer holds 1.26 G trits
// (3 x 16 x 6400 x 4096), and at ternary_mma.cuh's 3.25 integer
// instructions a trit (bf16 MMA) or 3.0 (s8) and the card's 16.7 T integer
// instructions a second (132 SMs x 64 lanes x 1.98 GHz) it needs about
// 0.245 ms a layer for bf16 and 0.226 for s8: decode issue, not bytes, is
// the expected limit.  One 8-row tile covers C <= 8, so each trit is
// decoded once and C = 1 and C = 5 cost about the same; the MMAs (20 G
// flops a layer on 8-row tiles, 20 us at 989 TFLOP/s bf16) hide under the
// decode.  Under it lies the per-call floor of the dense kernels, about
// 8.5 us, three calls a layer.  A first design lost 1.4-2.8x to the bf16
// torch.bmm on decoded weights: one 4-warp block per 128 columns walking
// all of K, byte-wide synchronous loads, an integer / 3 and % 3 per trit,
// f32 fmaf or __dp4a on the CUDA cores, and x cast to f32 on every call.
//
// The design is ternary_mma.cuh's, which packed_matmul.cu runs for one
// matrix, with an expert grid dimension: grid.z = e * (row tiles) + row
// tile, and expert e's x rows, weight rows and output offset once before
// the main loop (x as an [E C, K] view at row stride ldx, the bytes as an
// [E N, NB] view at row stride ldw, out [E, C, N]).  So a call is a
// full-card grid (phi3.5: 1,600 blocks of 64 columns at N = 6400 and
// 1,024 at N = 4096, E x column tiles x row tiles, over 4 resident blocks
// an SM: no K split, no cluster sum), a 16-byte cp.async ring of the
// served rows and of x as it comes (f32 as three bf16 terms, bf16 as one,
// int8 widened; on the s8 MMA for grouped_w2a8), and trits decoded with no
// division straight into swap-AB mma.sync fragments.  Ragged K is masked,
// never padded; x rows past C are not staged; columns past N are not
// stored; the served rows' 128-byte padding is never read.  An expert with
// no routed tokens has all-zero rows in x and still streams its bytes, as
// the TPU kernel does.  The 48 instantiations are packed_matmul.cu's, under
// their own encoding name; the compiled main loops of the 4 x 16-column
// layout hold 633 instructions for bf16 and 563 for s8 (packed_matmul.cu:
// 638 and 563; python -m repro_torch.launch.sass_count --source
// grouped_matmul), the expert offset being taken before them.  Registers:
// 88-128 a thread and no spills (ptxas); f32 x at C > 8 keeps its sums in
// a 32-128 byte stack frame, as in packed_matmul.cu.

#include "ternary_mma.cuh"

namespace {

// Base-3 bytes in expert stacks: grid.z carries the expert (see
// ternary_mma.cuh, point 1), and a device trace tells these kernels from
// packed_matmul.cu's by the name.
struct ExpertBase3 : Base3 {
  static constexpr bool EXPERTS = true;
};

}  // namespace

// Both entries: x: [E C, K] with row stride ldx (elements), expert e's
// rows from row e C, K the width of x (K <= 5 NB; columns past the
// weight's logical width are zero); packed: [E N, NB] base-3 bytes with
// row stride ldw (bytes; the served rows are padded to 128), expert e's
// rows from row e N; out: [E, C, N], unscaled.  Rows start 16-byte aligned
// (pointers and strides).  Launch on `stream`; where `grid` is not null,
// write the grid launched to it (column tiles, K splits, E x row tiles,
// threads a block).  Return the launch error (0 on success).

// grouped_dequant: x_kind 0 = f32, 1 = bf16, 2 = int8; out f32.
extern "C" int grouped_dequant_matmul_f32(const void* x, int x_kind,
                                          const void* packed, void* out, int E,
                                          int C, int N, int K, int NB,
                                          long long ldx, long long ldw,
                                          void* stream, int* grid) {
  switch (x_kind) {
    case X_F32: return call<ExpertBase3, X_F32>(x, packed, out, E, C, N, K, NB, ldx, ldw, stream, grid);
    case X_BF16: return call<ExpertBase3, X_BF16>(x, packed, out, E, C, N, K, NB, ldx, ldw, stream, grid);
    case X_I8: return call<ExpertBase3, X_I8>(x, packed, out, E, C, N, K, NB, ldx, ldw, stream, grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// grouped_w2a8: int8 x on the s8 MMA; out int32, exact.
extern "C" int grouped_w2a8_matmul_i32(const void* x, const void* packed,
                                       void* out, int E, int C, int N, int K,
                                       int NB, long long ldx, long long ldw,
                                       void* stream, int* grid) {
  return call<ExpertBase3, W2A8>(x, packed, out, E, C, N, K, NB, ldx, ldw, stream, grid);
}
