#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the eight hand-written CUDA kernels from
``src/repro_torch/kernels/csrc`` (``lut_gather``, ``lut_onehot``, ``tl2``,
``dequant_packed``, ``w2a8``, ``signflip``, ``grouped_dequant``,
``grouped_w2a8``; one ``nvcc`` per source, all at once), then serves
eleven models at full width, each built layer by layer from a seed
(``decode.init_serving_params``; the bf16 tree is never held), trains
bitnet at full width and depth and serves the trained weights, trains
zamba2 at full width and depth and xlstm at full width and one layer pair,
and measures a step's roofline and the packing ablation.  First, after the
kernel checks at bitnet's shapes, the hardware-generation side
(``hardware``):

  * the paper's model (``repro_torch.core``: the generator, the §IV cost
    model, the DSE) at its design points, printed with Table IV's two
    baseline ratios and Table V's rows and held to the published anchors
    under ``tests/test_cost_model.py``'s tolerances (``hardware_model``;
    areas at 16 nm, TOPS/mm^2 at 800 MHz: the paper's ASIC model, not a
    measurement);
  * the generated core (mu = 3, L = 32, K = 32, int8) simulated on the
    card (``core.simulator``) on bitnet's FFN ``wi`` (2560 -> 6912) and
    ``wo`` (6912 -> 2560) at full width with int8-valued activations:
    ``y`` must equal the int64 product, the CUDA ``lut_gather`` at M = 1
    on the same keys (launched through the design's kernel plan: the
    path's launches) and its plain version, exactly (every f32 partial sum
    is an integer under 2^24); the cores at mu 1, 2, 4 and 5 against the
    int64 product.  The modelled cycles and the simulator's wall time are
    recorded.  ``lut_gather`` at M = 1, int8, is checked and timed at both
    shapes as a kernel row.

Then

bitnet-b1.58-2b (30 layers, d_model 2560), through ``DecodeEngine`` under
``ContinuousScheduler``, on these paths:

  * on the analytical prior, with an empty autotune cache: batch 4 (the
    main path, ``lut_gather``), batch 1 and int8 activations (``tl2``);
  * sharded (``sharded_phase``, after the prior paths): the batch-4
    requests served by ``DecodeEngine(mesh=...)`` as two ranks of this
    one card (``launch.mesh.run_ranks`` over gloo, which stages every
    collective through the host: NCCL refuses two ranks on one GPU), each
    rank building bitnet from the seed and keeping its slice, at mesh
    ``1x2`` (each rank its half of the packed rows of wq, wi, wg and both
    wo, every scale whole, the kv projections whole; exact gathers join
    the columns) and ``2x1`` (each rank 2 of the 4 rows); the kernels are
    held against their plain versions first at every local shape the
    ranks run; every rank's launches must be its selection, the ranks'
    streams equal and equal to ``batch4``'s (where they part, the
    single-device top-2 margin there below 2^-3, as
    ``zamba2_generational``); per rank its launches, gathers (calls,
    bytes, host ms) and tokens/s, labelled as gloo through the host on
    one card, not a tensor-parallel speed;
  * autotuned: ``DecodeEngine.autotune_shapes`` times every eligible kernel
    at the engine's shapes (bf16 and int8, batch 4; twice, to show how far
    the winners repeat), then batch 4 serves under ``auto`` on those
    measurements, once with bf16 and once with int8 activations;
  * pinned: ``fixed:lut_onehot``, ``fixed:dequant_packed``,
    ``fixed:signflip`` (bf16) and ``fixed:w2a8`` (int8), batch 4;
  * traffic (after the prior paths, before autotune): the first 12
    arrivals of the ``agentic`` scenario (its lengths kept, arrivals cut),
    replayed open-loop on the wall clock by ``LoadGenerator`` at batch 4
    on bitnet's first 10 blocks (the depth cut for the script's time
    limit; full width), ``max_len`` from the scenario's geometry, three
    times on fresh engines over the same weights: without a prefix store,
    with one that starts empty (512 MiB, so nothing is evicted), and with
    one of 21.3 MiB (27 blocks, as the engine's default 64 MiB holds at 30
    layers, so LRU eviction runs).  Every
    request's token stream must be the same in all three replays (a dense
    step computes each row on its own, and admission prefills on a private
    single-row cache, so which rows share a batch changes no stream), the
    512 MiB replay must prefill fewer chunks and hit at least once, the
    21.3 MiB replay must evict at least one block, and ``lut_gather`` must
    launch in each;
  * speculative (after the traffic phase, before autotune): batch 4,
    ``spec_k`` 4, six requests (prompts of 3 to 120 tokens, 24 new tokens
    each) through four slots, each spec engine held against a non-spec
    engine with canonical greedy selection on the same target and
    requests: ``spec_twin`` (the target with the ``wo`` scales of blocks
    1..29 zeroed, so those blocks add exactly 0.0, and as draft its block 0
    alone: every stream equal, acceptance at least 0.9), ``spec_draft2``
    (the served bitnet with its first two blocks as draft: streams equal,
    some proposals rejected) and ``spec_draft2_dynamic`` (the same pair
    under dynamic ``spec_k``: streams equal, some request's last window
    under 4); then ``verify_check``, teacher-forced on one ragged batch-4
    cache: ``verify_step`` of 4 candidates within 2^-4 of 4 sequential
    ``decode_step`` calls, and a rollback that leaves every rejected
    slot's k, v and position bitwise as snapshotted;

then, with bitnet's tree freed, phi3.5-moe-42b-a6.6b (32 layers, d_model
4096, 16 experts top-2, d_ff 6400, an MoE FFN on every layer) on these:

  * ``moe_batch4``: the prior on the empty cache, bf16, batch 4 (attention
    on ``lut_gather``, every expert stack on ``grouped_dequant``: 3 launches
    per layer per step);
  * ``moe_int8_w2a8``: ``fixed:w2a8`` with int8 activations, batch 4
    (``w2a8`` and ``grouped_w2a8``);
  * ``moe_autotuned``: ``autotune_shapes`` at bf16 (dense and grouped
    shapes), then batch 4 under ``auto``;

then, with phi3.5's tree freed, the recurrent families, each built layer
by layer from the seed at full width and depth and served on the prior
through whole-prompt admission (one single-row ``prefill`` per request,
``lut_gather`` at the prompt's row count), each tree freed before the
next is built:

  * zamba2-2.7b (54 Mamba2 layers, d_model 2560, one shared attention+FFN
    block after every 6th, 9 invocations): ``zamba2_batch4`` (bitnet's
    batch-4 requests, prompts 3 to 120), ``zamba2_batch1`` (one 40-token
    prompt, ``tl2`` at decode) and ``zamba2_generational`` (``run()`` on
    four prompts of one length, one batched prefill at M = 4 x 24, its
    streams held to ``serve()``'s on the same requests by the margin rule
    below); ``cross_check`` on the whole-prompt prefill logits; and
    ``recurrent_check``: a 40-token prompt's prefill against the same
    prompt fed one token at a time through ``decode_step`` from
    ``init_cache``;
  * xlstm-125m (12 layers, d_model 768): ``xlstm_batch4`` (the same
    requests: its 96 and 120 cross the sLSTM's 64-step chunk), its
    ``cross_check``, and ``recurrent_check`` at 70 and 120 tokens, where
    the reference's padded sLSTM steps would show;

then, each earlier tree freed first, the other attention archs, each on
the prior at batch 4 (8 requests, 16 new tokens, max_len 256) at full
width and depth, each tree freed before the next is built:

  * ``qwen3_batch4`` (qwen3-0.6b: 28 layers, d_model 1024, head_dim 128
    so q_dim 2048, qk_norm, tied embeddings) and ``gemma_batch4``
    (gemma-7b: 28 layers, d_model 3072, head_dim 256, GeGLU d_ff 24,576,
    scaled embeddings, a tied 256,000-row head), through chunked
    admission (bitnet's requests);
  * ``internvl2_batch4`` (internvl2-2b: 24 layers, d_model 2048; the
    engine's zero vision embeddings over the first 64 positions; prompts
    of 64 to 120 tokens) and ``whisper_batch4`` (whisper-large-v3: 32
    encoder and 32 decoder layers, d_model 1280; the engine's zero frames;
    bitnet's requests), through whole-prompt admission: whisper's encoder
    and each decoder layer's cross keys and values run ``lut_gather`` at
    M = enc_seq = 1500 a request; ``encdec_layer_check`` holds its first
    encoder and decoder blocks sub-layer by sub-layer;
  * ``qwen2p5_batch4`` (qwen2.5-14b: 48 layers, d_model 5120, QKV bias)
    and ``yi_batch4`` (yi-34b: 60 layers, d_model 7168), through chunked
    admission.

Each of them runs ``cross_check`` with seeded non-zero frames and vision
embeddings; its kernel phase checks ``lut_gather`` at decode (M=4) and
at the admission chunk (M=32), or, for the whole-prompt two, at every
row count their paths and checks run (M=1500 included);

then llama4-maverick-400b-a17b at full width (d_model 5120, 128 experts
top-1 with a shared expert, an MoE block after every dense block of
``dense_ff`` 16,384, vocab 202,048) with its depth cut from 48 to
``LLAMA4_LAYERS`` = 8 layers (4 groups; 13.4 GB packed plus the 4.1 GB
embedding and head; at 48 layers the ternary weights alone pack to about
80 GB), each expert packed as it is drawn:

  * ``llama4_batch4``: bitnet's batch-4 requests on the prior through
    whole-prompt admission; ``grouped_dequant`` at E=128, C=1 (its
    capacity at decode and at every prompt here) launched 3 times per MoE
    layer per step, ``lut_gather`` on the attention, dense-FFN and
    shared-expert projections; ``layer_check`` over all 8 blocks,
    ``cross_check`` (held where no token was rerouted) and
    ``forced_check``, as ``moe_autotuned``'s;

then training (``launch.train``):

  * ``train_bitnet``: bitnet-b1.58-2b at full width and depth in QAT
    (int8 activation fake-quant, AdamW), 10 steps at global batch 8 x 512
    tokens, warmup 2, from the seed-0 init: each step's loss, gradient
    norm, ms and tokens/s, and the peak device memory;
  * ``train_resume``: the same at full width and 4 layers (its
    checkpoint of bf16 parameters and f32 AdamW moments is 9.3 GB; the
    30-layer state's is 27 GB): 10 steps with an async checkpoint after
    step 5, then a second ``train()`` that restores it and trains steps
    6-9, deterministic algorithms on: the losses and final parameters
    must equal the uninterrupted run's bitwise;
  * ``train_check``: one step with gradient compression of a 2-layer
    bitnet at full width on the card and on the CPU from the same weights
    and batch (tolerances below);
  * ``train_then_serve``: ``decode.quantize_for_serving`` packs the
    trained 30-layer tree, which serves bitnet's batch-4 requests on the
    prior through the hand kernels, with ``cross_check`` against
    ``fixed:ref`` (the flow of the reference's
    ``test_full_lifecycle_train_quantize_serve``);
  * ``train_zamba2`` and ``train_xlstm``: zamba2-2.7b (54 Mamba2 layers,
    the shared block after every 6th) at full width and depth and
    xlstm-125m at full width with its depth cut to one mLSTM/sLSTM pair
    of its six (the script's time limit), AdamW, 6 steps of 8 x 512
    tokens from the seed-0 init: every step finite, the peak device
    memory under 75 GB; step ms, tokens/s, peak GB;
  * ``train_check`` for zamba2 (one group: 6 Mamba2 blocks and the shared
    block) and xlstm (one pair) at full width, card vs CPU, under
    bitnet's bounds;

then the dry-run tooling's two phases:

  * ``roofline``: one decode step each of ``batch4`` (bitnet),
    ``moe_batch4`` (phi3.5) and ``zamba2_batch4``, every slot live,
    counted on the card inside each path after its timed steps
    (``launch.roofline.from_trace``: ``launch.op_cost``'s FLOPs and
    roofline bytes over ``decode.decode_step`` on the live cache) and
    traced by ``torch.profiler``: the counted FLOPs and bytes, the
    roofline step on the H100's peaks and its bounding term, the path's
    measured step ms (untraced wall) and busy ms, and
    ``roofline_fraction`` = roofline ms / measured step ms; printed after
    training, one line a path;
  * ``ablate`` (``launch.ablate``): bitnet at full width and depth,
    decode at 128 rows against 4,096 cache positions (40.3 GB of bf16
    KV), once with the bf16 tree of its ternary weights (trits times
    scale in bf16, a plain bf16 model) and once with the packed tree
    (``lut_gather`` at M = 128 on the prior, held against its plain
    version at bitnet's four shapes first): per tree the weight GB, one
    step's memory term (``op_cost`` on fake tensors), the measured wall
    ms (median of 10 after 3 warm-up steps) and busy ms; the two trees'
    logits within 2^-3, or, where the bf16 tree itself (no hand kernel)
    lies over 2^-3 from the plain path run in f64, both within its f64
    distance + 2^-3 (``cross_check``'s rule for ``fixed:ref``).

Their kernel phase checks ``lut_gather`` at decode (M=4) and at the longest
whole prompt (M=120) and ``tl2`` at M=1 on each model's shapes (zamba2's
also ``tl2`` at int8, M=4), the rows their layer lines sum; and, at every
row count their paths and checks run (each prompt length, the decode
batch, the generational batch's 4 x 24 rows, the cross-check prompt,
``recurrent_check``'s prompts), whatever the prior selects there.  Each
path and check asserts that every row count it runs was checked.

The kernel phase of each model checks every (kernel, M or capacity C,
activation dtype) that dispatch selects on any of its paths, decode and
prefill alike, at the model's shapes (the autotuned paths' selections are
checked once they are known), and each path asserts that what it selected
was checked.  Every serving path is driven with the kernels' launch
counters set to 0 just before it and read just after; each kernel the path
selects must have launched, and no other.  After each path the prefill
logits of one prompt through its kernels are held against the plain
``ref`` path (``grouped_ref`` on the experts) on the card.

Each phase prints one JSON line; a fuller record goes to
``smoke_out/chip_smoke.json``.  The last two lines are the kernel summary
and ``{"ok": true, "device": {...}}``.  Any failure ends the process with a
nonzero exit and no result line; so does a machine without a CUDA card.

Tolerances:
  * kernel vs plain, float inputs: both accumulate in f32 in different
    orders, so they agree to a few f32 ulps of the row's absolute sum:
    atol = 1e-5 * max_b sum_k |x[b, k]|.  int8 inputs: every partial sum is an
    integer below 2^24, so the results must be equal.
    ``w2a8`` and ``grouped_w2a8`` sum in int32 and must equal the plain
    version (and ``w2a8`` the int64 product).
  * prefill logits, kernels vs ``ref``: the two differ only in the f32
    summation order inside each projection; where that flips a bf16 rounding
    of an activation the change is one bf16 ulp, and through 30 residual
    layers the logits (magnitude < 8) move by a few bf16 ulps at most:
    atol = 2^-3, four ulps at magnitude 4 to 8.  With int8 activations
    every kernel sums the same integers exactly (int32, or f32 below 2^24)
    and the same scales follow, so every int8 path (prior, autotuned,
    ``fixed:w2a8``, ``moe_int8_w2a8``) must equal ``fixed:ref`` exactly
    (atol 0).
  * sharded prefill logits (``sharded_phase``): the cross-check prompt
    admitted under ``fixed:lut_gather`` by each mesh's ranks against one
    device, held to 2^-4, the port's serving tolerance, and reported with
    whether they are bitwise equal: the ranks' projections compute whole
    output columns over the same K, but the f32 hand kernels plan their
    column tiles and K split from N (``split_check``: the bf16 head and
    the attention over a rank's kv groups are bitwise, ``w2a8`` too), so
    at half the columns a column's sum is ordered otherwise (on an NVIDIA
    H100 80GB HBM3 at 700 W: 0.0547 at 1x2, 2x1 bitwise).
  * verify against sequential decode (``verify_check``): ``lut_gather``
    plans its launch by M (16 at the verify, 4 at decode), so the two sum
    each row in another order and the logits differ in f32 rounding: held
    to 2^-4, the port's serving tolerance, and reported with whether they
    are bitwise equal.  The spec streams are held equal to the non-spec
    ones: both select on bf16-rounded logits, which absorbs that noise
    unless a top logit lies within it of a rounding boundary.
  * the f64 yardstick (``yardstick_logits``): for zamba2 and the attention
    archs above, ``cross_check`` also runs the plain path in f64 end to
    end (``decode.f64_params`` under ``fixed:ref``: f64 activations,
    norms, attention and recurrences, trits decoded to f64, the model's
    constants kept at their bf16 rounding) and reports how far the path
    and ``fixed:ref`` each sit from it.  Where a path misses its bound
    against ``fixed:ref`` the f64 logits hold it instead: if both lie
    within 2^-3 of them, ``fixed:ref`` is the wrong yardstick at that
    depth; if ``fixed:ref`` itself lies ``d_ref`` > 2^-3 from them, the
    drift is the bf16 model's own (no hand kernel runs on ``fixed:ref``),
    and the path's logits must lie within ``d_ref + 2^-3`` of both
    ``fixed:ref``'s and the f64 ones (``drift_held``).  That rule is
    coarser than 2^-3, so where it decides, ``fault_control`` runs the
    path again with 1, 4, 16 and 64 output rows of the middle layer's FFN
    ``wo`` negated: the rule must reject the 64-row fault and
    ``layer_check`` the one-row fault, and all four distances are
    reported.  On an NVIDIA H100 80GB HBM3 at 700 W, gemma-7b's
    ``fixed:ref`` sits 0.336 from its f64 logits and the prior 0.373, the
    two 0.344 apart (its logits reach 25.4).
    The dense archs and internvl2 also run ``layer_check`` (every
    sub-layer fed the reference's input, 2^-5).
  * zamba2's 63 blocks (54 Mamba2 layers, 9 shared-block calls) carry a
    one-ulp difference further than bitnet's 30: on an NVIDIA H100 80GB
    HBM3 at 700 W its whole-model prefill logits sit 0.199 from
    ``fixed:ref``'s, over the 2^-3 bitnet holds (the plain path's own
    prefill and stepped decode part about as far, see
    ``recurrent_check``), and ``run()`` and
    ``serve()`` part at margins of 0.094 and 0.016.  Its kernels are therefore held block by block
    (``recurrent_layer_check``: each Mamba2 mixer, each shared block's
    attention and FFN, each mLSTM and sLSTM block fed the reference's own
    input, within 2^-5 of the output's largest magnitude, as the MoE's
    ``layer_check``), and its whole-model logits only to 2^-1, an eighth
    of their magnitude (a kernel that is wrong moves them by the order of
    the logits themselves); xlstm's 12 layers keep 2^-3.
  * ``recurrent_check``: the prefill runs ``lut_gather`` at M = the
    prompt length and the token-by-token decode ``tl2`` at M = 1, which
    sum in other orders, and the SSD, mLSTM, sLSTM gate products and
    attention reduce in other orders chunked than step by step.  At full
    width these recurrences carry a last-bit difference far: on the same
    card xlstm's sLSTM ``h`` ends 10% apart after 70 tokens and zamba2's
    SSM state 6.5% apart after 40.  The plain path (``fixed:ref``, no hand
    kernel: f32 products on decoded trits) parts as far: the check runs it
    too, under the same bounds, and reports both spreads side by side; it
    is the measurement these bounds stand on.  So the whole model is held
    only to a sanity bound (logits within 2^-1, every state leaf within
    2^-2 of its largest magnitude, the slot positions equal), and each
    block to a tight one (``block_step_check``): every
    Mamba2, mLSTM and sLSTM block fed the prompt's own input at that
    block, once in its prefill form and once a position at a time in its
    decode form from the initial state; outputs and final states within
    2^-5 of their largest magnitude.  xlstm's cells keep ``(C, n)``
    scaled by ``e^-m`` with a running stabilizer ``m`` (a max of log
    gates) and read them only as ``C e^m, n e^m``: a last-bit change of a
    gate input moves ``m`` and rescales ``C`` and ``n`` with it, so the
    stepped ``C``, ``n`` are brought to the prefill's stabilizer (times
    ``e^(m_step - m_prefill)``) before they are compared, and the
    stabilizers themselves are reported, not held.
  * ``zamba2_generational``: ``run()`` prefills at M = 96 where
    ``serve()`` prefills each request at M = 24, so their logits differ in
    f32 rounding; the streams must agree up to the first token where they
    differ, and there the top-2 margin of the bf16 logits (teacher-forced
    through one decode step a token) must be below 2^-3.
  * MoE: the top-2 routing is discontinuous in the hidden state, so a
    one-ulp difference can send a token to another expert and move the
    logits by more than any summation-order tolerance.  Each MoE path is
    therefore also held sub-layer by sub-layer with the reference's own
    input fed to both (so both take the same routing): each attention and
    MoE output within 2^-5 of its largest magnitude (a few bf16 roundings
    of each projection's output, eight ulps at the top binade; a wrong
    kernel is off by the order of the output itself), exactly at int8.
    The full-model logits are recorded with the number of tokens whose
    experts differ; ``moe_batch4`` and ``moe_int8_w2a8`` are held to 2^-3
    and 0 there as the dense paths are, and ``moe_autotuned`` only where
    no token was rerouted.  ``moe_batch4`` and ``moe_autotuned`` are also
    run with each layer's top-2 experts teacher-forced to ``fixed:ref``'s
    (gates from the path's own router), and those logits are held to 2^-3
    of ``fixed:ref``'s: a bound on the kernels over the whole model with
    the routing noise taken out.

  * ``train_check`` (bitnet, zamba2, xlstm): the card and the CPU sum
    the products in other orders, which can move a bf16 activation by an ulp and an int8
    activation code by one.  The loss is held to 2^-10 relative, each
    gradient leaf to a relative L2 distance of 2^-4, and each leaf's
    update to 2^-1: after the int8 gradient round trip AdamW's first
    step is about ``lr x sign(g)``, so a gradient entry whose int8 code
    the two round differently, or whose sign the rounding flips, moves
    its update by up to 2 lr (on an NVIDIA H100 80GB HBM3 at 700 W:
    6.1e-5, 0.024 and 0.18; the updates' signs agree on 97.8% of every
    matrix's entries or more).

Timing: each kernel, its plain version and the library yardstick are timed
call by call from a cold L2 by the timer autotune uses
(``dispatch.cold_times_ms``): a read of 128 MB before every call, the calls
queued behind a device sleep so each event pair holds device time only.  A
``kernel`` row keeps each series' mean (``ms``, ``plain_ms``,
``library_ms``) and beside it the median, minimum and maximum
(``ms_median``, ``ms_min``, ``ms_max``, and the same for the other two;
autotune ranks by the median); a ``layer`` row sums the means and the
medians over one layer.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")
SEED = 0
ARCH = "bitnet-b1.58-2b"
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
ZAMBA = "zamba2-2.7b"
XLSTM = "xlstm-125m"
QWEN3 = "qwen3-0.6b"
GEMMA = "gemma-7b"
QWEN25 = "qwen2.5-14b"
YI = "yi-34b"
WHISPER = "whisper-large-v3"
VLM = "internvl2-2b"
LLAMA4 = "llama4-maverick-400b-a17b"
#: llama4's depth on the card: 4 groups of (dense, MoE) of its 24; at 48
#: layers its ternary weights alone pack to about 80 GB
LLAMA4_LAYERS = 8
#: the attention archs served after the recurrent families, in order, each
#: tree freed before the next is built, and their paths' name prefixes
ATTN_ARCHS = {QWEN3: "qwen3", GEMMA: "gemma", VLM: "internvl2",
              WHISPER: "whisper", QWEN25: "qwen2p5", YI: "yi"}
#: the models that admit whole prompts (no chunked prefill)
WHOLE_PROMPT = (ZAMBA, XLSTM, WHISPER, VLM, LLAMA4)
#: the models whose cross_check also measures both paths against the plain
#: path run in f64 (``decode.f64_params``)
YARDSTICK = (ZAMBA, *ATTN_ARCHS)
#: per model, (K, N) of its dense ternary projections and how many of each
#: one layer has: bitnet wq, wo (attention) | wk, wv | wg, wi | down (the
#: FFN's wo); phi3.5-moe wq, wo | wk, wv (its FFN is the MoE); zamba2 one
#: group of 6 Mamba2 layers and the shared block: wz, wx | the mixer's wo |
#: wq, wk, wv, wo | wi, wg | the FFN's wo; xlstm one mLSTM and one sLSTM
#: layer: up | wq, wk, wv | down | ffn_up | ffn_down; the dense archs and
#: internvl2 wq | wk, wv | wo | wi, wg | the FFN's wo (equal shapes
#: merged); whisper one encoder layer and one decoder layer's cross-
#: attention keys and values (all at M = enc_seq), or one decoder layer
#: (decode): the attentions' 6 square projections | wi | the FFN's wo;
#: llama4 one group (a dense block, then an MoE block): both attentions'
#: wq, wo | their wk, wv | the dense FFN's wi, wg | its wo | the shared
#: expert's wi, wg | its wo
LAYER_KN = {ARCH: {(2560, 2560): 2, (2560, 640): 2, (2560, 6912): 2,
                   (6912, 2560): 1},
            QWEN3: {(1024, 2048): 1, (1024, 1024): 2, (2048, 1024): 1,
                    (1024, 3072): 2, (3072, 1024): 1},
            GEMMA: {(3072, 4096): 3, (4096, 3072): 1, (3072, 24576): 2,
                    (24576, 3072): 1},
            QWEN25: {(5120, 5120): 2, (5120, 1024): 2, (5120, 13824): 2,
                     (13824, 5120): 1},
            YI: {(7168, 7168): 2, (7168, 1024): 2, (7168, 20480): 2,
                 (20480, 7168): 1},
            VLM: {(2048, 2048): 2, (2048, 1024): 2, (2048, 8192): 2,
                  (8192, 2048): 1},
            WHISPER: {(1280, 1280): 6, (1280, 5120): 1, (5120, 1280): 1},
            MOE_ARCH: {(4096, 4096): 2, (4096, 1024): 2},
            LLAMA4: {(5120, 5120): 4, (5120, 1024): 4, (5120, 16384): 2,
                     (16384, 5120): 1, (5120, 8192): 2, (8192, 5120): 1},
            ZAMBA: {(2560, 5120): 12, (5120, 2560): 6, (2560, 2560): 4,
                    (2560, 10240): 2, (10240, 2560): 1},
            XLSTM: {(768, 3072): 1, (1536, 1536): 3, (1536, 768): 1,
                    (768, 2048): 1, (1024, 768): 1}}
#: per model, (E, K, N) of its expert stacks and how many one layer has:
#: wi, wg | wo
#: sharded serving (``sharded_phase``): bitnet at full width and depth as
#: two ranks of one card, over gloo (NCCL refuses two ranks on one GPU),
#: at these meshes, one spawn of the two ranks serving both; the local
#: shapes a rank runs at 1x2 are their own "model" (each rank's wq, attention
#: wo | the replicated wk, wv (5 kv heads) | wi, wg | the FFN's wo); at 2x1
#: nothing is split and a rank decodes 2 of the 4 rows
SHARD_MESHES = ("1x2", "2x1")
SHARD_BACKEND = "gloo"
SHARD_1X2 = f"{ARCH}@1x2"
LAYER_KN[SHARD_1X2] = {(2560, 1280): 2, (2560, 640): 2, (2560, 3456): 2,
                       (6912, 1280): 1}
#: sharded prefill logits against single-device ones under fixed:lut_gather
#: (see the module docstring)
SHARD_LOGIT_ATOL = 2.0 ** -4
#: the per-rank line's label: what its times are, and are not
SHARD_LABEL = ("gloo through the host, one card: not a tensor-parallel "
               "speed")
LAYER_EKN = {ARCH: {}, MOE_ARCH: {(16, 4096, 6400): 2, (16, 6400, 4096): 1},
             LLAMA4: {(128, 5120, 8192): 2, (128, 8192, 5120): 1},
             ZAMBA: {}, XLSTM: {}, SHARD_1X2: {},
             **{m: {} for m in ATTN_ARCHS}}
#: shared memory returns 128 bytes a clock an SM (times the SMs and the
#: SM clock read in the run: the ceiling of lut_gather's table reads)
SMEM_BYTES_PER_CLOCK = 128
LOGIT_ATOL = 2.0 ** -3
#: sub-layer outputs with the same input, kernels vs ``ref``, relative to
#: the output's largest magnitude (see the module docstring)
LAYER_RTOL = 2.0 ** -5
DEVICE = "cuda"
#: admission prefill chunk of every chunked serving path (the M of prefill
#: matmuls)
PREFILL_CHUNK = 32
#: the whole-prompt row count a recurrent model's path selection is taken
#: at (the longest prompt)
WHOLE_M = 120
#: the prompt lengths of every batch-4 path, and of every batch-1 path
BATCH4_LENGTHS = [3, 120, 17, 64, 33, 96, 5, 48]
BATCH1_LENGTHS = [40]
#: internvl2's batch-4 prompts: each at least its 64 vision positions
VLM_LENGTHS = [64, 120, 96, 80, 64, 120, 80, 96]
#: the cross-check prompt's length (a VLM's: its vision_tokens, when longer)
CROSS_LENGTH = 45
#: the generational path: requests, their one prompt length and budget
GEN_REQUESTS = 4
GEN_LENGTH = 24
GEN_NEW_TOKENS = 16
#: recurrent_check: prompt lengths per model and the bounds, which the
#: plain path (``fixed:ref``) is held to as well in the same run (see the
#: module docstring)
RECURRENT_LENGTHS = {ZAMBA: [40], XLSTM: [70, 120]}
RECURRENT_LOGIT_ATOL = 2.0 ** -1
RECURRENT_STATE_RTOL = 2.0 ** -2
#: xlstm's stabilized states and their stabilizers (see the module
#: docstring)
STABILIZED = {"mC": "mm", "mn": "mm", "sc": "sm", "sn": "sm"}
#: cross_check's bound on the whole-model prefill logits, per model: the
#: 2^-3 of LOGIT_ATOL is not met at zamba2's depth (see the module docstring
#: and the ``fixed:ref`` rows of recurrent_check)
CROSS_ATOL = {ZAMBA: 2.0 ** -1}
#: fault_control's faults: the path's first n output rows of the middle
#: layer's FFN ``wo`` negated, for each n; the drift rule must reject the
#: last, layer_check the first
FAULT_ROWS = (1, 4, 16, 64)
#: serving paths on the prior: name -> (model, decode batch, activation
#: dtype, policy)
PATHS = {"batch4": (ARCH, 4, "bfloat16", None),
         "batch1": (ARCH, 1, "bfloat16", None),
         "int8": (ARCH, 4, "int8", None),
         "moe_batch4": (MOE_ARCH, 4, "bfloat16", None),
         "moe_int8_w2a8": (MOE_ARCH, 4, "int8", "fixed:w2a8"),
         "zamba2_batch4": (ZAMBA, 4, "bfloat16", "prior"),
         "zamba2_batch1": (ZAMBA, 1, "bfloat16", "prior"),
         "xlstm_batch4": (XLSTM, 4, "bfloat16", "prior"),
         **{f"{tag}_batch4": (m, 4, "bfloat16", "prior")
            for m, tag in ATTN_ARCHS.items()},
         "llama4_batch4": (LLAMA4, 4, "bfloat16", "prior"),
         "train_then_serve": (ARCH, 4, "bfloat16", "prior")}
#: the traffic phase: scenario, arrivals kept (the scenario's lengths are
#: kept whole), and the stores' budgets: one large enough that nothing is
#: evicted, and the engine's default, which must evict
TRAFFIC_SCENARIO = "agentic"
TRAFFIC_REQUESTS = 12
TRAFFIC_STORE_MB = 512.0
#: the replays run bitnet's first TRAFFIC_LAYERS blocks (the script's time
#: limit; a replay's wall time is mostly per-layer host work), with the
#: evicting store cut in proportion: 27 blocks, as the engine's default
#: 64 MiB holds at all 30 layers
TRAFFIC_LAYERS = 10
TRAFFIC_EVICT_MB = 64.0 * TRAFFIC_LAYERS / 30
#: the speculative phase: candidates a round, the requests' prompt lengths
#: (six through four slots) and budgets, and the mismatched draft's depth
#: (the served target's first blocks)
SPEC_K = 4
SPEC_LENGTHS = [3, 120, 17, 64, 33, 5]
SPEC_NEW_TOKENS = 24
SPEC_DRAFT_LAYERS = 2
#: verify against sequential decode: the port's serving tolerance
VERIFY_ATOL = 2.0 ** -4
#: the training phase: bitnet's steps, global batch, sequence length,
#: warmup and peak learning rate; the run checkpoints after step
#: TRAIN_RESUME_AT - 1, and a second run resumes from there
TRAIN_STEPS = 10
#: the periodic checkpoint's interval: after step 5 only, within 10 steps
TRAIN_RESUME_AT = 6
TRAIN_RESUME_LAYERS = 4
TRAIN_BATCH = 8
TRAIN_SEQ = 512
TRAIN_WARMUP = 2
TRAIN_LR = 3e-4
#: the recurrent archs' training runs at full width and depth: AdamW
#: steps at bitnet's TRAIN_BATCH x TRAIN_SEQ tokens, each peak under
#: TRAIN_PEAK_GB of device memory
TRAIN_REC_STEPS = 6
TRAIN_PEAK_GB = 75.0
#: the recurrent archs' training depth where the script's time limit cuts
#: it (full width kept): xlstm one mLSTM/sLSTM pair of its six (at 12
#: layers its 6 steps took 94-99 s, its sLSTM stepping the 512 positions
#: one at a time; the whole script then 849 and 970 s)
TRAIN_REC_LAYERS = {XLSTM: 2}
#: train_check: depth per arch (the smallest each trunk has: bitnet 2
#: layers, one zamba2 group of 6 Mamba2 blocks and the shared block, one
#: xlstm mLSTM/sLSTM pair), the (batch, sequence length) of its
#: card-vs-CPU step, and its relative bounds (see the module docstring).
#: zamba2's CPU step is mostly per-parameter work (fake quant, gradient
#: compression, AdamW over 0.5 G parameters): on the card machine's 8
#: cores its train step took 28.2 s at 2 x 64 and 20.6 s at 1 x 32, the
#: whole comparison 50 and 26 s
TRAIN_CHECK_LAYERS = {ARCH: 2, ZAMBA: 6, XLSTM: 2}
TRAIN_CHECK_SHAPE = {ARCH: (2, 64), ZAMBA: (1, 32), XLSTM: (2, 64)}
TRAIN_CHECK_RTOL = {"loss": 2.0 ** -10, "grad": 2.0 ** -4, "update": 2.0 ** -1}
#: the hardware phase: the generated core simulated on the card on bitnet's
#: wi and wo, against the int64 product, lut_gather (M=1) and its plain
#: version; the other group sizes simulated against the int64 product only;
#: the simulator's wall time is the median of HW_SIM_REPS runs
HW_CORE = {"mu": 3, "L": 32, "K": 32, "act_dtype": "int8"}
HW_OTHER_MU = (1, 2, 4, 5)
HW_SIM_REPS = 3
#: the roofline phase: the paths whose decode step is counted
#: (``launch.op_cost`` on the card, after the path's timed steps) and
#: profiled over ROOFLINE_STEPS traced steps
ROOFLINE_PATHS = ("batch4", "moe_batch4", "zamba2_batch4")
ROOFLINE_STEPS = 4
#: the ablate phase (``launch.ablate``): bitnet's bf16 and packed trees at
#: full width and depth, decode at this batch against a cache of this
#: many positions (40.3 GB of bf16 KV)
ABLATE_BATCH = 128
ABLATE_SEQ = 4096
#: bitnet's pinned paths (batch 4): name -> (policy, activation dtype)
PINNED = {"lut_onehot": ("fixed:lut_onehot", "bfloat16"),
          "dequant_packed": ("fixed:dequant_packed", "bfloat16"),
          "signflip": ("fixed:signflip", "bfloat16"),
          "w2a8": ("fixed:w2a8", "int8")}
#: every hand kernel: name -> (CUDA source, the TPU kernel it replaces, the
#: model, M (capacity C for a grouped kernel) and act its summary in the
#: kernels line is taken at)
SOURCES = {
    "lut_gather": ("src/repro_torch/kernels/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul.py:96", ARCH, 4, "bfloat16"),
    "lut_onehot": ("src/repro_torch/kernels/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul.py:96", ARCH, 4, "bfloat16"),
    "tl2": ("src/repro_torch/kernels/csrc/tl2_matmul.cu",
            "src/repro/kernels/tl2_matmul.py:176", ARCH, 1, "bfloat16"),
    "dequant_packed": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:59", ARCH, 4,
                       "bfloat16"),
    "w2a8": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
             "src/repro/kernels/w2a8_matmul.py:50", ARCH, 4, "int8"),
    "signflip": ("src/repro_torch/kernels/csrc/signflip_matmul.cu",
                 "src/repro/kernels/signflip_matmul.py:48", ARCH, 4,
                 "bfloat16"),
    "grouped_dequant": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                        "src/repro/kernels/grouped_matmul.py:112", MOE_ARCH,
                        1, "bfloat16"),
    "grouped_w2a8": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                     "src/repro/kernels/grouped_matmul.py:143", MOE_ARCH, 1,
                     "int8"),
}
HAND_KERNELS = tuple(SOURCES)
GROUPED_KERNELS = ("grouped_dequant", "grouped_w2a8")
#: the CUDA sources, one nvcc each
CUDA_SOURCES = ["lut_matmul", "tl2_matmul", "packed_matmul", "signflip_matmul",
                "grouped_matmul"]
#: the kernels whose per-layer times chip_smoke sets side by side (the
#: packed kernels and tl2 at int8 beside signflip, which does the same MMAs
#: on 5x the bytes), at decode and prefill; and tl2 at bf16 batch-1 and
#: batch-2 decode
LAYER_ROWS = [(name, m, act) for m in (4, PREFILL_CHUNK)
              for name, act in (("dequant_packed", "bfloat16"),
                                ("w2a8", "int8"), ("tl2", "int8"),
                                ("signflip", "bfloat16"))] + \
    [("tl2", m, "bfloat16") for m in (1, 2)]
#: the grouped kernels' per-layer rows (phi3.5-moe's three expert stacks),
#: at the capacities of a batch-4 decode step and of an admission chunk
MOE_LAYER_ROWS = [(name, m, act) for name, act in (("grouped_dequant",
                                                     "bfloat16"),
                                                    ("grouped_w2a8", "int8"))
                  for m in (4, PREFILL_CHUNK)]
#: the later models' per-layer rows: what their paths run on the prior
#: (the dense archs' decode and admission chunk; internvl2's longest
#: prompt; whisper's encoder and cross keys and values at M = enc_seq)
MODEL_LAYER_ROWS = {
    ZAMBA: [("lut_gather", 4, "bfloat16"), ("lut_gather", WHOLE_M, "bfloat16"),
            ("tl2", 1, "bfloat16"), ("tl2", 4, "int8")],
    XLSTM: [("lut_gather", 4, "bfloat16"), ("lut_gather", WHOLE_M, "bfloat16"),
            ("tl2", 1, "bfloat16")],
    **{m: [("lut_gather", 4, "bfloat16"),
           ("lut_gather", PREFILL_CHUNK, "bfloat16")]
       for m in (QWEN3, GEMMA, QWEN25, YI)},
    VLM: [("lut_gather", 4, "bfloat16"), ("lut_gather", WHOLE_M, "bfloat16")],
    LLAMA4: [("lut_gather", 4, "bfloat16"),
             ("lut_gather", WHOLE_M, "bfloat16"),
             ("grouped_dequant", 1, "bfloat16")],
    WHISPER: [("lut_gather", 4, "bfloat16"), ("lut_gather", 1500, "bfloat16")]}

RECORD: dict = {}


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """Print and record one phase line, with ``t``: seconds since the
    script started (where the run's time goes)."""
    line = {"phase": phase, **fields, "t": time.perf_counter() - T0}
    RECORD.setdefault("phases", []).append(line)
    print(json.dumps(line), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clocks_mhz() -> tuple[float, float]:
    """The card's SM clock now and its maximum, in MHz, as nvidia-smi reads
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True)
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return float(now), float(top)


def smem_bytes_per_s(torch) -> float:
    """Shared memory's peak rate over the card: 128 bytes a clock an SM at
    the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SMEM_BYTES_PER_CLOCK * sms * sm_clocks_mhz()[1] * 1e6


# ---------------------------------------------------------------------------
# per-kernel check and timing
# ---------------------------------------------------------------------------


def kernel_case(torch, name: str, m: int, k: int, n: int, act: str, flush,
                e: int | None = None):
    """Check one hand kernel against its plain version at one shape and
    time both and the library yardstick.  A grouped kernel takes ``e``
    experts of ``m`` rows (the capacity).  ``flush``: the buffer read to
    flush the L2."""
    from repro_torch.core import encoding
    from repro_torch.kernels import dequant_matmul as deq
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import lut_matmul as lut
    from repro_torch.kernels import signflip_matmul as sf
    from repro_torch.kernels import tl2_matmul as tl2
    from repro_torch.kernels import w2a8_matmul as w8
    from repro_torch.kernels.dispatch import TernaryWeight, cold_times_ms
    from repro_torch.launch import roofline as rl

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 7 * m + k + n)
    lead = () if e is None else (e,)
    if act == "int8":
        x = torch.randint(-127, 128, (*lead, m, k), generator=g, device=dev,
                          dtype=torch.int8)
    else:
        x = torch.randn((*lead, m, k), generator=g, device=dev,
                        dtype=torch.bfloat16)
    trits = torch.randint(-1, 2, (*lead, n, k), generator=g, device=dev,
                          dtype=torch.int8)
    # base-3 bytes with the serving artifact's row padding (an expert stack
    # packed expert by expert: at llama4's E=128 the whole stack's int32
    # packing temporaries would take over 40 GB)
    packed = torch.stack([encoding.pad_rows(encoding.pack_base3(t),
                                            encoding.PACKED_ROW_BYTES)
                          for t in trits.reshape(-1, n, k)]).reshape(
                              *lead, n, -1)
    rate = rl.PEAK_FLOPS_F32
    experts = e or 1
    packed_bytes = experts * n * -(-k // encoding.TRITS_PER_BYTE)
    # ``ops`` is the function's floor on this weight encoding, not what the
    # kernel's design spends: one add per trit, key or pair and row, plus
    # the table build where the encoding needs one
    if name in GROUPED_KERNELS:
        fn, plain_fn = ((gm.grouped_packed_matmul,
                         gm.grouped_packed_matmul_torch)
                        if name == "grouped_dequant" else
                        (gm.grouped_w2a8_matmul, gm.grouped_w2a8_matmul_torch))
        kernel = lambda: fn(x, packed, k)                       # noqa: E731
        plain = lambda: plain_fn(x, packed, k)                  # noqa: E731
        wbytes = packed_bytes     # every expert streams; padding never read
        ops = e * m * n * k
        # the adds run on the tensor cores: s8 for grouped_w2a8, else bf16
        rate = (rl.PEAK_OPS_INT8 if name == "grouped_w2a8"
                else rl.PEAK_FLOPS_BF16)
    else:
        w = TernaryWeight.from_packed(packed, 1.0, k)
        mu = w.mu
    ceiling = None
    if name in ("lut_gather", "lut_onehot"):
        # as served: x of the logical width, the weight's keys view (rows
        # padded to 16 bytes), neither copied
        keys = w.keys()
        G = keys.shape[1]
        onehot = name == "lut_onehot"
        fn, plain_fn = ((lut.lut_onehot_matmul, lut.lut_onehot_matmul_torch)
                        if onehot else
                        (lut.lut_matmul, lut.lut_matmul_torch))
        kernel = lambda: fn(x, keys, mu)                        # noqa: E731
        plain = lambda: plain_fn(x, keys, mu)                   # noqa: E731
        wbytes = n * G * keys.element_size()
        # whichever fetch computes it: the table build, then one add per
        # key and row
        ops = m * G * encoding.table_size(mu) + m * n * G
        if onehot:
            # the adds run on the bf16 tensor cores; the design's ceiling:
            # one m16n8k16 MMA (4096 flops) per group, 16 columns and 8
            # (row, bf16 term) slots, 3 terms a row, at the peak rate
            rate = rl.PEAK_FLOPS_BF16
            mmas = -(-n // 16) * G * -(-3 * m // 8)
            ceiling = ("tensor cores",
                       mmas * 4096 / rl.PEAK_FLOPS_BF16 * 1e3)
        else:
            # the design's ceiling: one 4-byte table read per key and row
            ceiling = ("shared memory",
                       4 * m * n * G / smem_bytes_per_s(torch) * 1e3)
    elif name == "tl2":
        # as served: x of the logical width, the weight's words view (rows
        # padded to 16 bytes), neither copied
        words = w.tl2()
        fn = tl2.tl2_matmul
        kernel = lambda: fn(x, words, k)                        # noqa: E731
        plain = lambda: tl2.tl2_matmul_torch(x, words, k)       # noqa: E731
        wbytes = words.numel() * words.element_size()   # padding never read
        ops = m * n * k
        # the adds run on the tensor cores: s8 for int8 x, else bf16
        rate = rl.PEAK_OPS_INT8 if act == "int8" else rl.PEAK_FLOPS_BF16
    elif name == "dequant_packed":
        fn = deq.packed_matmul
        kernel = lambda: fn(x, packed, k)                       # noqa: E731
        plain = lambda: deq.packed_matmul_torch(x, packed, k)   # noqa: E731
        wbytes = packed_bytes                # the padding is never read
        ops = m * n * k
        rate = rl.PEAK_FLOPS_BF16   # the adds run on the bf16 tensor cores
    elif name == "w2a8":
        fn = w8.w2a8_matmul
        kernel = lambda: fn(x, packed, k)                       # noqa: E731
        plain = lambda: w8.w2a8_matmul_torch(x, packed, k)      # noqa: E731
        wbytes = packed_bytes
        ops = m * n * k
        rate = rl.PEAK_OPS_INT8
    elif name == "signflip":
        wt = w.trits()
        kernel = lambda: sf.signflip_matmul(x, wt)              # noqa: E731
        plain = lambda: sf.signflip_matmul_torch(x, wt)         # noqa: E731
        wbytes = wt.numel()
        ops = m * n * k
        rate = rl.PEAK_FLOPS_BF16   # the adds run on the bf16 tensor cores
    elif name not in GROUPED_KERNELS:
        raise KeyError(name)
    wd = trits.to(torch.bfloat16).transpose(-1, -2)     # decoded [.., K, N]
    xb = x.to(torch.bfloat16)
    # the yardstick: one bf16 product on decoded weights (never in the port)
    library = ((lambda: torch.bmm(xb, wd)) if e is not None   # noqa: E731
               else (lambda: torch.matmul(xb, wd)))          # noqa: E731

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    if act == "int8":
        exact = torch.equal(got, want)
        if e is None:
            exact = exact and torch.equal(
                got.cpu().to(torch.int64),
                x.cpu().to(torch.int64) @ trits.cpu().to(torch.int64).T)
        tol = 0.0
        if not exact:
            raise AssertionError(f"{name} int8 E={e} M={m} K={k} N={n}: not "
                                 f"exact (max abs err {err})")
    else:
        tol = 1e-5 * float(x.double().abs().sum(-1).max()) + 1e-6
        if not err <= tol:
            raise AssertionError(f"{name} E={e} M={m} K={k} N={n}: max abs "
                                 f"err {err} > {tol}")
    nbytes = x.numel() * x.element_size() + wbytes + experts * m * n * 4
    t_bytes = nbytes / rl.HBM_BW * 1e3
    t_ops = ops / rate * 1e3

    row = {"kernel": name, "E": e, "M": m, "K": k, "N": n, "act": act,
           "max_abs_err": err, "tol": tol,
           **series_ms("ms", cold_times_ms(kernel, 20, flush)),
           **series_ms("plain_ms", cold_times_ms(plain, 5, flush)),
           **series_ms("library_ms", cold_times_ms(library, 20, flush)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops, "ops_per_s": rate}
    if ceiling is not None:
        row["ceiling_by"], row["ceiling_ms"] = ceiling
    if name != "signflip":
        row["grid"] = fn.last_grid
    return row


def series_ms(key: str, times: list[float]) -> dict:
    """A timed series as ``key`` (its mean) and ``key_median``,
    ``key_min`` and ``key_max``."""
    return {key: statistics.fmean(times),
            f"{key}_median": statistics.median(times),
            f"{key}_min": min(times), f"{key}_max": max(times)}


def capacity(model: str, m: int) -> int:
    """The per-expert capacity of a forward over ``m`` tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.layers import moe_capacity

    return moe_capacity(get_config(arch_of(model)), m)


def path_selection(model: str, batch: int, act: str,
                   policy: str | None = None, spec_k: int = 0) -> dict:
    """What dispatch selects on one serving path of ``model``: ``{shape:
    kernel}`` for its decode M (the batch) and its prefill M (the chunk;
    ``WHOLE_M`` for a whole-prompt model, see :func:`whole_prompt_rows`),
    and with ``spec_k`` its verify M (batch x spec_k; a draft cut from the
    model decodes and prefills at the first two); a dense shape is ``(M,
    K, N)``, a grouped one ``(E, C, K, N)``."""
    from repro_torch.kernels.dispatch import select_kernel

    from repro_torch.configs.registry import get_config

    sel = {}
    prefill_m = WHOLE_M if model in WHOLE_PROMPT else PREFILL_CHUNK
    # whisper's encoder and cross keys and values run at M = enc_seq
    enc = get_config(arch_of(model)).enc_seq
    for m in (batch, prefill_m) + ((batch * spec_k,) if spec_k else ()) + \
            ((enc,) if enc else ()):
        for k, n in LAYER_KN[model]:
            sel[(m, k, n)] = select_kernel(m, k, n, act, policy=policy).name
        for e, k, n in LAYER_EKN[model]:
            c = capacity(model, m)
            sel[(e, c, k, n)] = select_kernel(c, k, n, act, policy=policy,
                                              e=e).name
    return sel


def arch_of(model: str) -> str:
    """The arch of a ``LAYER_KN`` key (a sharded path's local shapes are
    keyed ``<arch>@<mesh>``)."""
    return model.split("@")[0]


def cross_length(model: str) -> int:
    """The cross-check prompt's length for ``model``: ``CROSS_LENGTH``, or
    the model's shortest prompt where that is longer (a VLM's vision
    positions)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.decode import min_prompt_len

    return max(CROSS_LENGTH, min_prompt_len(get_config(model)))


def batch4_lengths(model: str) -> list[int]:
    return VLM_LENGTHS if model == VLM else BATCH4_LENGTHS


def whole_prompt_ms(model: str) -> list[int]:
    """Every row count at which a whole-prompt model's paths and checks
    run its projections: each batch-4 prompt (the warm-up's and the
    decode-step timing's too) and the batch-4 decode (M=4), the
    cross-check prompt; the recurrent models' also ``recurrent_check``'s
    prompts and their stepped decode (M=1), zamba2's the batch-1 prompt,
    the generational batch's one prefill (``GEN_REQUESTS`` x
    ``GEN_LENGTH`` rows) and the margin rule's single-row prefill
    (``GEN_LENGTH``); whisper's its encoder and cross keys and values (M =
    enc_seq)."""
    from repro_torch.configs.registry import get_config

    ms = set(batch4_lengths(model)) | {4, cross_length(model)}
    if model in RECURRENT_LENGTHS:
        ms |= {1} | set(RECURRENT_LENGTHS[model])
    if model == ZAMBA:
        ms |= set(BATCH1_LENGTHS) | {GEN_LENGTH, GEN_REQUESTS * GEN_LENGTH}
    if get_config(model).enc_seq:
        ms.add(get_config(model).enc_seq)
    return sorted(ms)


def rows_cases(model: str, rows, act: str, policy: str | None) -> set:
    """The ``(model, kernel, M, act)`` of the hand kernels dispatch selects
    at each M of ``rows`` on the model's shapes."""
    from repro_torch.kernels.dispatch import select_kernel

    return {(model, name, m, act) for m in set(rows)
            for k, n in LAYER_KN[model]
            if (name := select_kernel(m, k, n, act, policy=policy).name)
            in HAND_KERNELS}


def whole_prompt_rows(model: str, rows, act: str, checked: set,
                      policy: str | None = None) -> None:
    """A whole-prompt model runs its projections at each prompt's row
    count: at each M of ``rows`` the hand kernel dispatch selects at every
    shape of the model must have been held against its plain version at
    that M (``checked``; the kernel phase checks a case at every shape of
    the model)."""
    missing = sorted(rows_cases(model, rows, act, policy) - checked)
    if missing:
        raise AssertionError(f"{model}: rows {sorted(set(rows))} run hand "
                             f"kernels the kernel phase did not check: "
                             f"{missing}")


def selected_cases(model: str, selection: dict, act: str) -> set:
    """The ``(model, kernel, M or C, act)`` of the hand kernels in a path
    selection."""
    return {(model, name, shape[-3], act)
            for shape, name in selection.items() if name in HAND_KERNELS}


def kernel_cases(model: str) -> list[tuple]:
    """``(model, kernel, M or C, act)`` to check before serving ``model``:
    bitnet's decode points at batch 4, 1, 2 and int8 batch 4 (``tl2`` at
    int8 also at the prefill chunk, M=32), each dense
    kernel ported after the first slice at decode (M=4) and prefill (M=32);
    phi3.5-moe's grouped kernels at decode (C=1) and at the admission chunk
    (C=5); the recurrent models' ``lut_gather`` at decode (M=4) and at the
    longest whole prompt (M=120) and ``tl2`` at M=1 (zamba2's also at int8,
    M=4), and whatever the prior selects at every row count their paths
    and checks run (:func:`whole_prompt_ms`); plus every one that a prior,
    pinned or speculative serving path selects (the speculative ones also
    at the verify, M=16); the later attention archs' layer rows
    (``MODEL_LAYER_ROWS``) and, for whisper and internvl2, every row
    count their paths and checks run."""
    cases = {(model, name, m, act)
             for name, m, act in MODEL_LAYER_ROWS.get(model, [])}
    if model in WHOLE_PROMPT:
        cases |= rows_cases(model, whole_prompt_ms(model), "bfloat16",
                            "prior")
    elif model == ARCH:
        cases = {(ARCH, "lut_gather", 4, "bfloat16"),
                 (ARCH, "lut_gather", 32, "bfloat16"),
                 (ARCH, "lut_onehot", 4, "bfloat16"),
                 (ARCH, "lut_onehot", 32, "bfloat16"),
                 (ARCH, "tl2", 1, "bfloat16"), (ARCH, "tl2", 2, "bfloat16"),
                 (ARCH, "tl2", 4, "int8"), (ARCH, "tl2", 32, "int8")}
        for policy, act in PINNED.values():
            cases |= selected_cases(ARCH, path_selection(ARCH, 4, act,
                                                         policy), act)
        cases |= selected_cases(ARCH, path_selection(
            ARCH, 4, "bfloat16", None, SPEC_K), "bfloat16")
    elif model == MOE_ARCH:
        cases = {(model, name, capacity(model, m), act)
                 for name, act in (("grouped_dequant", "bfloat16"),
                                   ("grouped_w2a8", "int8"))
                 for m in (4, PREFILL_CHUNK)}
    for mdl, batch, act, policy in PATHS.values():
        if mdl == model:
            cases |= selected_cases(model, path_selection(model, batch, act,
                                                          policy), act)
    return sorted(cases)


def check_kernels(torch, cases, flush) -> list[dict]:
    rows = []
    for model, name, m, act in cases:
        if name in GROUPED_KERNELS:
            shapes = [(e, k, n) for e, k, n in LAYER_EKN[model]]
        else:
            shapes = [(None, k, n) for k, n in LAYER_KN[model]]
        for e, k, n in shapes:
            row = kernel_case(torch, name, m, k, n, act, flush, e=e)
            row["model"] = model
            emit("kernel", **row)
            rows.append(row)
    return rows


def layer_summary(rows: list[dict], name: str, model: str, m: int,
                  act: str) -> dict:
    """One kernel's numbers for one layer of ``model`` at the main path's
    M or C: the sums over the layer's projections (or expert stacks) of
    the per-shape times."""
    from repro_torch.launch.roofline import HBM_BW

    grouped = name in GROUPED_KERNELS
    counts = ({(k, n): c for (_, k, n), c in LAYER_EKN[model].items()}
              if grouped else LAYER_KN[model])
    sel = {(r["K"], r["N"]): r for r in rows
           if r["kernel"] == name and r["M"] == m and r["act"] == act
           and r["model"] == model}
    keys = ["ms", "plain_ms", "library_ms", "ms_median", "plain_ms_median",
            "library_ms_median"]
    tot = {key: sum(sel[kn][key] * c for kn, c in counts.items())
           for key in keys}
    t_bytes = sum(sel[kn]["bytes"] * c for kn, c in counts.items()) \
        / HBM_BW * 1e3
    t_ops = sum(sel[kn]["ops"] / sel[kn]["ops_per_s"] * c
                for kn, c in counts.items()) * 1e3
    what = ("3 expert stacks (wi, wg, wo)" if grouped else
            f"{sum(counts.values())} projections")
    return {**tot, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "at": f"{model}, {'C' if grouped else 'M'}={m} {act}, sum over "
                  f"one layer's {what}"}


def lut_ceilings(rows: list[dict]) -> list[dict]:
    """The LUT kernels' design ceilings (their source note's) for one
    bitnet layer at each M they were timed at, beside the layer's time:
    the sums over the layer's projections."""
    out = []
    for name in ("lut_gather", "lut_onehot"):
        for m in sorted({r["M"] for r in rows if r["kernel"] == name}):
            sel = {(r["K"], r["N"]): r for r in rows
                   if r["kernel"] == name and r["M"] == m
                   and r["act"] == "bfloat16" and r["model"] == ARCH}
            if set(sel) != set(LAYER_KN[ARCH]):
                continue
            tot = {key: sum(sel[kn][key] * c
                            for kn, c in LAYER_KN[ARCH].items())
                   for key in ("ms", "library_ms", "ceiling_ms")}
            out.append({"kernel": name, "M": m, **tot,
                        "ceiling_by": next(iter(sel.values()))["ceiling_by"],
                        "sm_clock_max_mhz": sm_clocks_mhz()[1]})
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_requests(lengths, new_tokens: int, vocab: int, seed: int):
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(2, vocab, size=n).tolist(),
                    max_new_tokens=new_tokens) for n in lengths]


def serve_path(torch, served, cfg, model: str, *, batch: int, lengths,
               new_tokens: int, checked: set, roofline: bool = False,
               streams: list | None = None) -> dict:
    """Serve one path (``cfg.matmul_policy``) and return its record.  A
    one-request warm-up first derives the kernels' weight encodings (set-up,
    untimed); then the counters are set to 0, the requests are served, and
    the counters read.  Every hand kernel the path selects must be in
    ``checked`` and must have launched; no other hand kernel may have.
    With ``roofline``, the record also holds :func:`roofline_step`'s;
    ``streams`` gets the requests' token streams."""
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import ContinuousScheduler

    act = "int8" if cfg.act_dtype == "int8" else cfg.dtype
    selection = path_selection(model, batch, act, cfg.matmul_policy)
    if model in WHOLE_PROMPT:
        # whisper's encoder and cross keys and values: M = enc_seq
        whole_prompt_rows(model, [*lengths, batch] + [cfg.enc_seq] * bool(
            cfg.enc_seq), act, checked, cfg.matmul_policy)
    cases = selected_cases(model, selection, act)
    expect = {name for _, name, _, _ in cases}
    unchecked = sorted(cases - checked)
    if unchecked:
        raise AssertionError(f"path selects kernels the kernel phase did not "
                             f"check: {unchecked}")
    engine = DecodeEngine(served, cfg, batch_size=batch, max_len=256,
                          prefill_chunk=PREFILL_CHUNK, device=DEVICE)
    if engine.prefill_chunk != PREFILL_CHUNK:
        raise AssertionError(f"prefill chunk {engine.prefill_chunk} != "
                             f"{PREFILL_CHUNK}")
    engine.serve(make_requests([lengths[0]], 2, cfg.vocab_size, SEED + 99))
    torch.cuda.synchronize()
    reqs = make_requests(lengths, new_tokens, cfg.vocab_size, SEED + batch)
    sched = ContinuousScheduler(engine)
    for r in reqs:
        sched.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    for r in reqs:
        if not (r.done and len(r.out) == new_tokens) or \
                not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid} ended with {r.out} "
                                 f"(done={r.done})")
    if streams is not None:
        streams.extend(r.out for r in reqs)
    # no prefix store, so cache affinity leaves admission FIFO
    if [r.rid for r in sched.admission_order] != [r.rid for r in reqs] or \
            sched.stats.affinity_reorders:
        raise AssertionError("a path without a prefix store admitted out of "
                             "submission order")
    check_launches(counts, expect)
    selected = {":".join(f"{d}{v}" for d, v in zip(
        "EMKN" if len(shape) == 4 else "MKN", shape)): name
        for shape, name in selection.items()}
    n_tok = sum(len(r.out) for r in reqs)
    step_ms, step_launches = decode_step_ms(torch, engine, cfg, lengths[0])
    roof = roofline_step(torch, engine, cfg, step_ms) if roofline else None
    del engine
    return {"model": model, "policy": cfg.matmul_policy or "auto",
            "act": act, "batch": batch, "requests": len(reqs),
            "prompt_lengths": lengths, "new_tokens": n_tok,
            "decode_steps": sched.stats.decode_steps,
            "prefill_chunks": sched.stats.prefill_chunks,
            "seconds": dt, "tokens_per_s": n_tok / dt,
            "decode_step_ms": step_ms,
            "launches_per_decode_step": step_launches, "launches": counts,
            "selected": selected,
            **({"roofline": roof} if roof is not None else {})}


def check_launches(counts: dict, expect: set) -> None:
    """Each hand kernel in ``expect`` launched, and no other."""
    wrong = {name: c for name, c in counts.items()
             if (c > 0) != (name in expect)}
    if wrong:
        raise AssertionError(f"launches {counts} disagree with the path's "
                             f"selected hand kernels {sorted(expect)}")


def traffic_phase(torch, served, cfg, checked: set) -> dict:
    """Replay the first ``TRAFFIC_REQUESTS`` arrivals of
    ``TRAFFIC_SCENARIO`` open-loop on the wall clock at batch 4, on a fresh
    engine without a prefix store, then on one whose store starts empty
    with ``TRAFFIC_STORE_MB``, then on one with ``TRAFFIC_EVICT_MB``; each
    replay is driven with the launch counters set to 0 just before it and
    read just after.  Fails unless every request's stream is the same in
    all three, the large store's replay prefilled fewer chunks and hit at
    least once, the small store evicted at least one block, and each replay
    launched exactly the path's selected hand kernels (``lut_gather`` on
    the prior).  Returns ``{replay: record}``."""
    from dataclasses import replace

    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.launch.serve import tenant_lines
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.loadgen import LoadGenerator, generate_trace
    from repro_torch.serving.workload import get_scenario

    batch = 4
    selection = path_selection(ARCH, batch, cfg.dtype, cfg.matmul_policy)
    cases = selected_cases(ARCH, selection, cfg.dtype)
    expect = {name for _, name, _, _ in cases}
    if "lut_gather" not in expect or cases - checked:
        raise AssertionError(f"traffic path selects {sorted(cases)}; "
                             f"unchecked {sorted(cases - checked)}")
    scenario = replace(get_scenario(TRAFFIC_SCENARIO),
                       max_requests=TRAFFIC_REQUESTS)
    trace = generate_trace(scenario, cfg.vocab_size, seed=SEED)
    need = scenario.max_prompt_len() + scenario.max_new_tokens() + 1
    max_len = -(-need // 16) * 16
    out, streams = {}, {}
    for name, store, mb in (("no_store", False, TRAFFIC_STORE_MB),
                            ("store", True, TRAFFIC_STORE_MB),
                            ("store_evicting", True, TRAFFIC_EVICT_MB)):
        engine = DecodeEngine(served, cfg, batch_size=batch, max_len=max_len,
                              prefill_chunk=PREFILL_CHUNK, device=DEVICE,
                              prefix_cache=store, prefix_cache_mb=mb)
        # set-up, untimed: derive the kernels' weight encodings with a
        # prompt shorter than a block, which leaves the store empty
        engine.serve(make_requests([8], 2, cfg.vocab_size, SEED + 99))
        torch.cuda.synchronize()
        if engine.prefix_store is not None and (
                len(engine.prefix_store) or engine.prefix_store.stats.lookups):
            raise AssertionError("the warm-up touched the prefix store")
        gen = LoadGenerator(engine, trace, clock="wall")
        reset_launch_counts()
        t0 = time.perf_counter()
        res = gen.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        check_launches(counts, expect)
        reqs = sorted(gen.sched.completed, key=lambda r: r.rid)
        if len(reqs) != len(trace) or any(
                not r.done or len(r.out) != ev.new_tokens
                or not all(0 <= t < cfg.vocab_size for t in r.out)
                for r, ev in zip(reqs, trace)):
            raise AssertionError(f"traffic {name}: a request did not finish "
                                 f"with its budget of valid tokens")
        streams[name] = [r.out for r in reqs]
        st = res.stats
        rec = {"scenario": scenario.name, "arrivals": len(trace),
               "batch": batch, "max_len": max_len,
               "prefill_chunk": PREFILL_CHUNK, "seconds": dt,
               "makespan_s": res.makespan_s, "offered_qps": res.offered_qps,
               "achieved_qps": res.achieved_qps,
               "new_tokens": res.emitted_tokens,
               "tokens_per_s": res.emitted_tokens / dt,
               "decode_steps": st.decode_steps,
               "prefill_chunks": st.prefill_chunks,
               "affinity_reorders": st.affinity_reorders,
               "queue_wait_s": st.queue_wait_summary(),
               "tenants": tenant_lines(scenario, res), "launches": counts}
        if engine.prefix_store is not None:
            ps = engine.prefix_store
            rec["prefix_store"] = {
                "budget_mib": mb,
                "lookups": ps.stats.lookups,
                "hit_blocks": ps.stats.hit_blocks,
                "reused_tokens": ps.stats.reused_tokens,
                "published_blocks": ps.stats.published_blocks,
                "evicted_blocks": ps.stats.evicted_blocks,
                "resident_blocks": len(ps),
                "resident_mib": ps.nbytes / (1 << 20)}
        out[name] = rec
        del engine, gen
        torch.cuda.empty_cache()
    for name in ("store", "store_evicting"):
        same = [a == b for a, b in zip(streams["no_store"], streams[name])]
        if not all(same):
            raise AssertionError(
                f"traffic: streams of requests "
                f"{[i for i, ok in enumerate(same) if not ok]} differ in "
                f"the {name} replay")
    if not out["store"]["prefill_chunks"] < out["no_store"]["prefill_chunks"]:
        raise AssertionError("traffic: the store replay prefilled no fewer "
                             "chunks")
    if out["store"]["prefix_store"]["hit_blocks"] < 1:
        raise AssertionError("traffic: the store replay had no hit")
    if out["store_evicting"]["prefix_store"]["evicted_blocks"] < 1:
        raise AssertionError(f"traffic: the {TRAFFIC_EVICT_MB:g} MiB store "
                             f"evicted no block")
    return out


def tail_zeroed(blocks: dict) -> dict:
    """The stacked blocks with the ``wo`` scales (attention and FFN output)
    of every block but the first set to 0, in new scale tensors (the packed
    bytes are shared): those blocks then add exactly 0.0 to the residual
    stream, and the model computes what its first block alone does."""
    out = {}
    for key, v in blocks.items():
        if isinstance(v, dict) and key == "wo":
            scale = v["scale"].clone()
            scale[1:] = 0
            out[key] = dict(v, scale=scale)
        elif isinstance(v, dict):
            out[key] = tail_zeroed(v)
        else:
            out[key] = v
    return out


def first_blocks(served: dict, n: int) -> dict:
    """The serving tree cut to its first ``n`` blocks (views), sharing the
    embedding, final norm and LM head."""
    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[:n]

    return dict(served, blocks=cut(served["blocks"]))


def run_requests(torch, engine, cfg, dynamic: bool = False):
    """Serve ``SPEC_LENGTHS`` with ``SPEC_NEW_TOKENS`` each (after an
    untimed one-request warm-up), with the launch counters set to 0 just
    before and read just after.  Returns ``(requests, scheduler stats,
    seconds, launch counts)``."""
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.serving.scheduler import ContinuousScheduler

    engine.serve(make_requests([8], 2, cfg.vocab_size, SEED + 99))
    torch.cuda.synchronize()
    reqs = make_requests(SPEC_LENGTHS, SPEC_NEW_TOKENS, cfg.vocab_size,
                         SEED + 24)
    sched = ContinuousScheduler(engine, dynamic_spec_k=dynamic)
    for r in reqs:
        sched.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    for r in reqs:
        if not (r.done and len(r.out) == SPEC_NEW_TOKENS) or \
                not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid} ended with {r.out} "
                                 f"(done={r.done})")
    return reqs, sched.stats, dt, counts


def spec_round_ms(torch, engine, cfg, rounds: int = 6):
    """Wall time of one spec round with every slot live, and each hand
    kernel's launches per round: admit one request per slot, two rounds of
    warm-up, then ``rounds`` rounds ending in a synchronize."""
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)

    state = engine.sched_start()
    for slot, r in enumerate(make_requests(
            [8] * engine.B, SPEC_K * (rounds + 3), cfg.vocab_size, SEED + 3)):
        state = engine.sched_admit(state, slot, r)
    for _ in range(2):
        state = engine.sched_spec_step(state)[0]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(rounds):
        state = engine.sched_spec_step(state)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / rounds * 1e3
    return ms, {k: v / rounds for k, v in launch_counts().items() if v}


def stream_mismatch(torch, tree, cfg, prompt, base, spec) -> dict:
    """Where a spec stream first leaves its baseline: the request's
    position ``t`` and the target's two largest bf16 logits there, taken
    as the baseline takes them (one decode step a token at batch 4) and
    as a verify of the 4 tokens before ``t`` takes them."""
    from repro_torch.models.decode import decode_step, verify_step
    from repro_torch.serving.engine import DecodeEngine, Request

    t = next(i for i, (a, b) in enumerate(zip(base, spec)) if a != b)
    eng = DecodeEngine(tree, cfg, batch_size=4, max_len=256,
                       prefill_chunk=PREFILL_CHUNK, device=DEVICE)
    dead = torch.full((4,), -1, dtype=torch.int32, device=DEVICE)
    plen = len(prompt)

    def admitted():
        return eng.sched_admit(eng.sched_start(), 0,
                               Request(prompt=prompt, max_new_tokens=t + 1))

    def decoded(state, n):
        logits, cache = state["logits"], state["cache"]
        for i in range(n):
            toks = torch.full((4,), 1, dtype=torch.int64, device=DEVICE)
            toks[0] = base[i]
            index = dead.clone()
            index[0] = plen + i
            logits, cache = decode_step(eng.params, cfg, cache, toks, index)
        return logits[0], cache

    def top2(logits):
        v, i = logits[:cfg.vocab_size].to(torch.bfloat16).float().topk(2)
        return list(zip(i.tolist(), v.tolist()))

    seq, _ = decoded(admitted(), t)
    w = min(t, SPEC_K)
    _, cache = decoded(admitted(), t - w)
    cands = torch.ones((4, w), dtype=torch.int64, device=DEVICE)
    cands[0] = torch.tensor(base[t - w:t], device=DEVICE)
    start = dead.clone()
    start[0] = plen + t - w
    vlogits, _ = verify_step(eng.params, cfg, cache, cands, start)
    return {"position": t, "baseline_token": base[t], "spec_token": spec[t],
            "decode_top2": top2(seq), "verify_top2": top2(vlogits[0, -1])}


def spec_phase(torch, served, cfg, checked: set, card: str) -> dict:
    """The speculative paths at batch 4 on the prior (see the module
    docstring): each spec engine, and a non-spec engine with canonical
    greedy selection on the same target, serve the same six requests, each
    run with the launch counters set to 0 just before it and read just
    after.  Fails unless every stream equals the baseline's, each path's
    own gate holds and each spec run launched exactly the path's selected
    hand kernels (``lut_gather`` on the prior, the verify at M=16
    included).  Emits each path's line (with ``card``) as it ends; returns
    ``{path: record}``."""
    from repro_torch.serving.engine import DecodeEngine, SamplerConfig

    batch = 4
    selection = path_selection(ARCH, batch, cfg.dtype, cfg.matmul_policy,
                               SPEC_K)
    cases = selected_cases(ARCH, selection, cfg.dtype)
    expect = {name for _, name, _, _ in cases}
    if "lut_gather" not in expect or cases - checked:
        raise AssertionError(f"spec paths select {sorted(cases)}; "
                             f"unchecked {sorted(cases - checked)}")
    twin = dict(served, blocks=tail_zeroed(served["blocks"]))
    d2 = SPEC_DRAFT_LAYERS
    pairs = {"spec_twin": ("twin", twin, first_blocks(twin, 1), 1, False),
             "spec_draft2": ("served", served, first_blocks(served, d2), d2,
                             False),
             "spec_draft2_dynamic": ("served", served,
                                     first_blocks(served, d2), d2, True)}
    greedy = SamplerConfig(canonical_greedy=True)
    kw = dict(batch_size=batch, max_len=256, prefill_chunk=PREFILL_CHUNK,
              device=DEVICE, sampler=greedy)
    baselines, out = {}, {}
    for name, (target_name, target, dtree, depth, dynamic) in pairs.items():
        if target_name not in baselines:
            engine = DecodeEngine(target, cfg, **kw)
            reqs, st, dt, counts = run_requests(torch, engine, cfg)
            check_launches(counts, expect)
            step_ms, step_launches = decode_step_ms(torch, engine, cfg)
            n_tok = sum(len(r.out) for r in reqs)
            baselines[target_name] = {
                "streams": [r.out for r in reqs], "seconds": dt,
                "tokens_per_s": n_tok / dt, "decode_steps": st.decode_steps,
                "prefill_chunks": st.prefill_chunks,
                "decode_step_ms": step_ms,
                "launches_per_decode_step": step_launches,
                "launches": counts}
            del engine
            torch.cuda.empty_cache()
        base = baselines[target_name]
        engine = DecodeEngine(target, cfg, draft=(dtree, cfg.with_(
            n_layers=depth)), spec_k=SPEC_K, **kw)
        reqs, st, dt, counts = run_requests(torch, engine, cfg, dynamic)
        check_launches(counts, expect)
        streams = [r.out for r in reqs]
        if streams != base["streams"]:
            i = next(i for i, (a, b) in enumerate(zip(base["streams"],
                                                       streams)) if a != b)
            raise AssertionError(
                f"{name}: request {i}'s stream leaves the baseline's: "
                f"{stream_mismatch(torch, target, cfg, reqs[i].prompt, base['streams'][i], streams[i])}")
        round_ms, round_launches = spec_round_ms(torch, engine, cfg)
        del engine
        torch.cuda.empty_cache()
        n_tok = sum(len(r.out) for r in reqs)
        windows = sorted(st.spec_window_by_rid.values())
        rec = {"target": f"{ARCH} ({cfg.n_layers} blocks"
                         + (", wo scales of blocks 1.. zeroed)"
                            if target_name == "twin" else ")"),
               "draft_blocks": depth, "spec_k": SPEC_K,
               "dynamic_spec_k": dynamic, "batch": batch,
               "requests": len(reqs), "prompt_lengths": SPEC_LENGTHS,
               "new_tokens": n_tok, "streams_equal": True,
               "acceptance_rate": st.acceptance_rate,
               "drafted_tokens": st.drafted_tokens,
               "accepted_drafted_tokens": st.accepted_drafted_tokens,
               "spec_rounds": st.spec_rounds,
               "decode_step_equivalents": base["decode_steps"],
               "prefill_chunks": st.prefill_chunks,
               "seconds": dt, "tokens_per_s": n_tok / dt,
               "round_ms": round_ms, "launches_per_round": round_launches,
               "last_windows": windows, "launches": counts,
               "baseline": {k: v for k, v in base.items()
                            if k != "streams"}}
        if name == "spec_twin" and not st.acceptance_rate >= 0.9:
            raise AssertionError(f"spec_twin: acceptance "
                                 f"{st.acceptance_rate} < 0.9")
        if name == "spec_draft2" and not \
                st.accepted_drafted_tokens < st.drafted_tokens:
            raise AssertionError("spec_draft2: the mismatched draft had every "
                                 "proposal accepted")
        if dynamic and not (windows and windows[0] < SPEC_K):
            raise AssertionError(f"{name}: no request's last window is under "
                                 f"{SPEC_K}: {windows}")
        out[name] = rec
        emit(name, gpu=card, **rec)
    return out


def verify_check(torch, served, cfg) -> dict:
    """Teacher-forced on one ragged batch-4 cache (four prompts admitted
    as served): ``verify_step`` of ``SPEC_K`` random candidates a row
    against as many sequential ``decode_step`` calls, logits within
    ``VERIFY_ATOL``; then a rollback keeping ``[1, 2, 3, 4]`` must leave
    every rejected slot's k, v and position bitwise as the snapshot holds
    them and every kept slot as the verify wrote it."""
    from repro_torch.models.decode import (decode_step, rollback_kv_window,
                                           snapshot_kv_window, verify_step)
    from repro_torch.serving.engine import DecodeEngine

    eng = DecodeEngine(served, cfg, batch_size=4, max_len=256,
                       prefill_chunk=PREFILL_CHUNK, device=DEVICE)
    state = eng.sched_start()
    for slot, r in enumerate(make_requests([3, 40, 17, 64], 8,
                                           cfg.vocab_size, SEED + 11)):
        state = eng.sched_admit(state, slot, r)
    cache = state["cache"]
    start = state["index"] + 1
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    cands = torch.randint(2, cfg.vocab_size, (4, SPEC_K), generator=g,
                          device=DEVICE)

    def clone(c):
        return {k: v.clone() for k, v in c.items()}

    seq, seq_logits = clone(cache), []
    for j in range(SPEC_K):
        logits, seq = decode_step(eng.params, cfg, seq, cands[:, j], start + j)
        seq_logits.append(logits)
    seq_logits = torch.stack(seq_logits, 1)
    undo = snapshot_kv_window(cfg, cache, start, SPEC_K)
    vlogits, vcache = verify_step(eng.params, cfg, clone(cache), cands, start)
    torch.cuda.synchronize()
    if not (torch.isfinite(vlogits).all() and torch.isfinite(seq_logits).all()):
        raise AssertionError("verify_check: non-finite logits")
    diff = float((vlogits - seq_logits).abs().max())
    kv_diff = max(float((vcache[n].float() - seq[n].float()).abs().max())
                  for n in ("k", "v"))
    if not diff <= VERIFY_ATOL:
        raise AssertionError(f"verify_check: verify vs sequential decode "
                             f"logits max abs diff {diff} > {VERIFY_ATOL}")
    post = clone(vcache)
    keep = [1, 2, 3, 4]
    rolled = rollback_kv_window(cfg, vcache, undo, torch.tensor(keep))
    restored = 0
    for b in range(4):
        for j in range(SPEC_K):
            s = int(undo["slot"][b, j])
            rejected = j >= keep[b]
            want = {n: undo[n][:, b, j] if rejected else post[n][:, b, s]
                    for n in ("k", "v")}
            want["pos"] = (undo["pos"][b, j].expand(cfg.n_layers) if rejected
                           else post["pos"][:, b, s])
            for n, w in want.items():
                if not torch.equal(rolled[n][:, b, s], w):
                    raise AssertionError(
                        f"verify_check: after the rollback row {b}'s "
                        f"candidate {j} has other {n} than the "
                        f"{'snapshot' if rejected else 'verify'}")
            restored += rejected
    del eng
    return {"arch": cfg.name, "batch": 4, "spec_k": SPEC_K,
            "start": start.tolist(), "max_abs_diff": diff,
            "atol": VERIFY_ATOL, "bitwise_equal": diff == 0.0,
            "kv_max_abs_diff": kv_diff,
            "argmax_equal": bool(torch.equal(vlogits.argmax(-1),
                                              seq_logits.argmax(-1))),
            "rollback_keep": keep, "restored_slots": restored,
            "rollback_bitwise": True}


def decode_step_ms(torch, engine, cfg, plen: int = 8, steps: int = 10):
    """Wall time of one decode step with every slot live, and each hand
    kernel's launches per step (after the path's counters were read):
    admit one ``plen``-token request per slot, warm up, time ``steps``
    scheduler steps ending in a synchronize."""
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)

    state = engine.sched_start()
    for slot, r in enumerate(make_requests([plen] * engine.B, steps + 4,
                                           cfg.vocab_size, SEED + 3)):
        state = engine.sched_admit(state, slot, r)
    for _ in range(2):
        state, _, _ = engine.sched_step(state)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _, _ = engine.sched_step(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return ms, {k: v / steps for k, v in launch_counts().items() if v}


def roofline_step(torch, engine, cfg, step_ms: float) -> dict:
    """One decode step of ``engine`` with every slot live (8-token
    prompts), after the path's timed steps: its FLOPs and bytes counted on
    the card (``launch.roofline.from_trace``: ``launch.op_cost`` over
    ``decode.decode_step`` on the live cache), its roofline on the H100's
    peaks, which term bounds it, and its busy ms (``launch.profile``'s
    ``profile_steps`` over ``ROOFLINE_STEPS`` traced steps);
    ``roofline_fraction`` is the roofline step over the path's measured
    step (``step_ms``, untraced wall time)."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.profile import profile_steps
    from repro_torch.models.decode import decode_step

    plen = 8
    state = engine.sched_start()
    for slot, r in enumerate(make_requests([plen] * engine.B, 4,
                                           cfg.vocab_size, SEED + 5)):
        state = engine.sched_admit(state, slot, r)
    state, _, _ = engine.sched_step(state)
    tokens = state["logits"].argmax(-1).to(torch.int32)
    index = state["index"] + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    roof, detail = rl.from_trace(decode_step, engine.params, engine.cfg,
                                 state["cache"], tokens, index)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = profile_steps(engine, ROOFLINE_STEPS, plen)
    profile_s = time.perf_counter() - t0
    roof_ms = roof.step_time_s * 1e3
    busy = prof["device_busy_ms_per_step"]
    return {"flops": roof.flops_per_device, "bytes": roof.bytes_per_device,
            "bytes_materialized": detail["bytes_materialized"],
            "raw_flop_counter_flops": detail["raw_flop_counter_flops"],
            "ops_counted": detail["ops"],
            "compute_ms": roof.compute_s * 1e3,
            "memory_ms": roof.memory_s * 1e3, "roofline_ms": roof_ms,
            "bound_by": roof.bottleneck, "step_ms": step_ms,
            "busy_ms": busy, "traced_wall_ms": prof["wall_ms_per_step"],
            "idle_share": prof["device_idle_share"],
            "roofline_fraction": roof_ms / step_ms,
            "roofline_fraction_of_busy": roof_ms / busy,
            "count_s": count_s, "profile_s": profile_s}


def _prompt_chunks(torch, cfg):
    """The cross-check prompt (:func:`cross_length` tokens) as admission
    runs it: ``(tokens [1, chunk], positions [1, chunk], take)`` per
    chunk."""
    import numpy as np

    from repro_torch.models.decode import prefill_chunks_of

    prompt = np.random.default_rng(SEED + 5).integers(
        2, cfg.vocab_size, size=cross_length(cfg.name))
    for start, valid in prefill_chunks_of(len(prompt), PREFILL_CHUNK):
        toks = torch.ones((1, PREFILL_CHUNK), dtype=torch.int64, device=DEVICE)
        toks[0, :valid] = torch.from_numpy(prompt[start:start + valid])
        pos = torch.full((1, PREFILL_CHUNK), -1, dtype=torch.int32,
                         device=DEVICE)
        pos[0, :valid] = torch.arange(start, start + valid, dtype=torch.int32)
        yield toks, pos, valid - 1


def _cross_tokens(torch, cfg):
    """The cross-check prompt whole, ``[1, S]``."""
    return torch.cat([t[:, :take + 1]
                      for t, _, take in _prompt_chunks(torch, cfg)], 1)


def stub_inputs(torch, cfg, dtype=None) -> dict:
    """Seeded non-zero frontend inputs for one row (whisper's frame
    embeddings, a VLM's vision embeddings; bf16 values, in ``dtype`` if
    given), so the checks exercise the encoder beyond its positions and
    the vision rows beyond zeros; ``{}`` for a model without a frontend."""
    n = {"audio_stub": cfg.enc_seq,
         "vit_stub": cfg.vision_tokens}.get(cfg.frontend)
    if n is None:
        return {}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    x = torch.randn((1, n, cfg.d_model), generator=g, device=DEVICE,
                    dtype=torch.bfloat16)
    key = "frames" if cfg.frontend == "audio_stub" else "vision_embeds"
    return {key: x if dtype is None else x.to(dtype)}


def _prefill_logits(torch, served, cfg):
    """The cross-check prompt's last-token logits after prefill under
    ``cfg``, as admission runs it: chunk by chunk, or whole (with the
    seeded frontend inputs) where the model admits whole prompts."""
    from repro_torch.models.decode import (bind_serving_weights, init_cache,
                                           prefill, prefill_chunk)

    p = bind_serving_weights(served, cfg)
    if cfg.name in WHOLE_PROMPT:
        batch = {"tokens": _cross_tokens(torch, cfg),
                 **stub_inputs(torch, cfg)}
        return prefill(p, cfg, batch, 256)[1][0, :cfg.vocab_size].float()
    cache = init_cache(cfg, 1, 256, device=DEVICE)
    for toks, pos, take in _prompt_chunks(torch, cfg):
        cache, out = prefill_chunk(p, cfg, cache, toks, pos, take)
    return out[0, :cfg.vocab_size].float()


def yardstick_logits(torch, served, cfg):
    """The cross-check prompt's last-token logits of the plain path run in
    f64 end to end (``decode.f64_params`` under ``fixed:ref``, f64
    frontend inputs): one whole prefill of the prompt.  The bf16 model's
    own rounding drift is its distance from this, with or without the
    kernels."""
    from repro_torch.models.decode import f64_params, prefill

    c = cfg.with_(matmul_policy="fixed:ref")
    batch = {"tokens": _cross_tokens(torch, cfg),
             **stub_inputs(torch, cfg, torch.float64)}
    out = prefill(f64_params(served), c, batch, 256)[1]
    return out[0, :cfg.vocab_size]


def forced_check(torch, served, cfg) -> dict:
    """Prefill logits of the cross-check prompt through the path's kernels
    (``cfg.matmul_policy``) with every MoE layer call's top-k experts
    teacher-forced to those ``fixed:ref`` takes, against ``fixed:ref``:
    within ``LOGIT_ATOL`` (0 with int8 activations).  The path keeps its
    own router: the forced experts' gates are its own probabilities at
    them, renormalized as ``route`` does.  With routing noise forced out,
    this bounds the kernels' error over the whole model."""
    from repro_torch.models import layers

    path = cfg.matmul_policy or "auto"
    atol = 0.0 if cfg.act_dtype == "int8" else LOGIT_ATOL
    route = layers.route
    choices = []

    def recording(router, xf, c):
        probs, vals, idx = route(router, xf, c)
        choices.append(idx)
        return probs, vals, idx

    def forced(router, xf, c):
        probs = route(router, xf, c)[0]
        idx = next(replay)
        vals = probs.gather(-1, idx)
        return probs, vals / torch.clamp(vals.sum(-1, keepdim=True), 1e-9), idx

    try:
        layers.route = recording
        ref = _prefill_logits(torch, served,
                              cfg.with_(matmul_policy="fixed:ref"))
        replay = iter(choices)
        layers.route = forced
        kern = _prefill_logits(torch, served, cfg)
    finally:
        layers.route = route
    if next(replay, None) is not None or not choices:
        raise AssertionError(f"{path}: the forced run made other MoE calls "
                             f"than the {len(choices)} recorded")
    if not (torch.isfinite(kern).all() and torch.isfinite(ref).all()):
        raise AssertionError("non-finite prefill logits")
    diff = float((kern - ref).abs().max())
    if not diff <= atol:
        raise AssertionError(f"teacher-forced prefill logits: {path} vs ref "
                             f"max abs diff {diff} > {atol}")
    return {"arch": cfg.name, "policy": path, "act_dtype": cfg.act_dtype,
            "max_abs_diff": diff, "atol": atol,
            "forced_moe_calls": len(choices),
            "argmax_equal": bool(kern.argmax() == ref.argmax())}


def drift_held(diff: float, d_kern: float, d_ref: float) -> bool:
    """cross_check's rule where ``fixed:ref`` itself lies ``d_ref`` >
    ``LOGIT_ATOL`` from the f64 logits (the bf16 model's own drift): the
    path's logits within ``d_ref + LOGIT_ATOL`` of ``fixed:ref``'s
    (``diff``, what the kernels change) and of the f64 ones (``d_kern``)."""
    return max(diff, d_kern) <= d_ref + LOGIT_ATOL


def _with_fault(torch, served, cfg, rows: int, run):
    """``run()`` with the path's output rows ``[0, rows)`` of the middle
    layer's FFN ``wo`` negated after its kernel ran (as if those rows'
    trits were flipped); ``fixed:ref``'s calls are left whole.  Returns
    ``(run's result, the rows the fault hit)``."""
    from repro_torch.models import layers
    from repro_torch.models.model import layer_blocks

    target = layer_blocks(served)[cfg.n_layers // 2]["ffn"]["wo"]["packed"]
    matmul = layers.ternary_matmul
    hits = []

    def faulty(x, w, **kw):
        out = matmul(x, w, **kw)
        if kw.get("policy") != "fixed:ref" and \
                w.packed().data_ptr() == target.data_ptr():
            hits.append(x.shape[:-1].numel())
            out = out.clone()
            out[..., :rows] = -out[..., :rows]
        return out

    layers.ternary_matmul = faulty
    try:
        return run(), sum(hits)
    finally:
        layers.ternary_matmul = matmul


def fault_control(torch, served, cfg, ref, y, d_ref) -> dict:
    """The control of :func:`drift_held`: the path's prefill logits with
    each fault of ``FAULT_ROWS`` (:func:`_with_fault`), held against the
    same ``fixed:ref`` logits ``ref`` and f64 logits ``y``; raises unless
    the rule rejects the largest fault, and unless :func:`layer_check`
    rejects the smallest at the faulted layer's FFN."""
    layer = cfg.n_layers // 2
    faults = []
    for rows in FAULT_ROWS:
        kern, hit = _with_fault(torch, served, cfg, rows,
                                lambda: _prefill_logits(torch, served, cfg))
        diff = float((kern - ref).abs().max())
        d_kern = float((kern.double() - y).abs().max())
        faults.append({"rows": rows, "rows_run": hit, "max_abs_diff": diff,
                       "f64_max_abs_diff": d_kern,
                       "held": drift_held(diff, d_kern, d_ref)})
    rec = {"layer": layer, "bound": d_ref + LOGIT_ATOL, "faults": faults}
    if not faults[-1]["rows_run"] or faults[-1]["held"]:
        raise AssertionError(f"the drift rule holds a faulty path: {rec}")
    try:
        _with_fault(torch, served, cfg, FAULT_ROWS[0],
                    lambda: layer_check(torch, served, cfg))
    except AssertionError as e:
        if f"layer {layer} ffn" not in str(e):
            raise
        rec["layer_check"] = str(e)
    else:
        raise AssertionError(f"layer_check holds a path with {FAULT_ROWS[0]} "
                             f"row(s) of layer {layer}'s FFN wo negated")
    return rec


def cross_check(torch, served, cfg, *, routing_may_differ=False) -> dict:
    """Prefill logits of one prompt through the path's kernels
    (``cfg.matmul_policy``) and through ``fixed:ref``, chunk by chunk as
    admission runs it, at ``cfg``'s activation dtype: within ``LOGIT_ATOL``
    with float activations, equal with int8 ones.

    For an MoE model the top-k experts each token takes in each layer are
    recorded on both runs.  With ``routing_may_differ`` a path whose
    routing differs from the reference's somewhere is not held to
    ``LOGIT_ATOL``: a token sent to another expert changes its output by
    that expert's whole contribution, which no summation-order tolerance
    covers; its sub-layers are held to the reference by
    :func:`layer_check` instead, and the difference is reported.

    For the models of ``YARDSTICK`` both logits are also measured against
    the plain path run in f64 (:func:`yardstick_logits`), and where the
    path misses its bound against ``fixed:ref`` the f64 logits hold it
    instead (see the module docstring): within ``LOGIT_ATOL`` of them, as
    ``fixed:ref`` is; or, where ``fixed:ref`` itself lies beyond
    ``LOGIT_ATOL`` of them (the bf16 model's own drift), by
    :func:`drift_held`, with :func:`fault_control` run as its control."""
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import route

    path = cfg.matmul_policy or "auto"
    atol = 0.0 if cfg.act_dtype == "int8" else CROSS_ATOL.get(cfg.name,
                                                              LOGIT_ATOL)
    logits, routes = {}, {}
    moe_ffn = model_mod.moe_ffn

    def recording(p, x, c):
        routes[c.matmul_policy].append(
            route(p["router"], x.reshape(-1, x.shape[-1]), c)[2].sort(-1)[0])
        return moe_ffn(p, x, c)

    model_mod.moe_ffn = recording
    try:
        for policy in (path, "fixed:ref"):
            routes[policy] = []
            logits[policy] = _prefill_logits(
                torch, served, cfg.with_(matmul_policy=policy))
    finally:
        model_mod.moe_ffn = moe_ffn
    # (layer call, token) rows whose top-k expert set differs
    rerouted = sum(int((a != b).any(-1).sum())
                   for a, b in zip(routes[path], routes["fixed:ref"]))
    kern, ref = logits[path], logits["fixed:ref"]
    if not (torch.isfinite(kern).all() and torch.isfinite(ref).all()):
        raise AssertionError("non-finite prefill logits")
    diff = float((kern - ref).abs().max())
    f64 = {}
    if cfg.name in YARDSTICK:
        y = yardstick_logits(torch, served, cfg)
        if not torch.isfinite(y).all():
            raise AssertionError("non-finite f64 logits")
        f64 = {"f64_max_abs_diff": float((kern.double() - y).abs().max()),
               "ref_f64_max_abs_diff": float((ref.double() - y).abs().max())}
    yardstick = "fixed:ref"
    if f64 and not diff <= atol:
        d_kern, d_ref = f64["f64_max_abs_diff"], f64["ref_f64_max_abs_diff"]
        if max(d_kern, d_ref) <= LOGIT_ATOL:
            yardstick = "f64"
        elif d_ref > LOGIT_ATOL and drift_held(diff, d_kern, d_ref):
            yardstick = "fixed:ref's own drift from f64"
            f64["fault_control"] = fault_control(torch, served, cfg, ref, y,
                                                 d_ref)
    held = not (routing_may_differ and rerouted)
    if held and not (diff <= atol or yardstick != "fixed:ref"):
        raise AssertionError(f"prefill logits: {path} vs ref max abs diff "
                             f"{diff} > {atol} (tokens rerouted: "
                             f"{rerouted}; against f64: {f64})")
    return {"arch": cfg.name, "policy": path, **f64, "yardstick": yardstick,
            "act_dtype": cfg.act_dtype, "max_abs_diff": diff, "atol": atol,
            "held_to_atol": held, "rerouted_tokens": rerouted,
            "routed_tokens": sum(int(a.shape[0]) for a in routes[path]),
            "max_abs_logit": float(ref.abs().max()),
            "argmax_equal": bool(kern.argmax() == ref.argmax())}


def layer_check(torch, served, cfg) -> dict:
    """The cross-check prompt's first chunk through the stack with every
    sub-layer (attention, MoE FFN) of the path fed the reference's own
    input, so both take the same routing: each sub-layer's output through
    the path's kernels within ``LAYER_RTOL`` of its largest magnitude of
    the ``fixed:ref`` output (equal with int8 activations), and the final
    logits from the reference's last hidden state likewise."""
    from repro_torch.models.decode import bind_serving_weights, cache_len
    from repro_torch.models.layers import append_attention, rms_norm
    from repro_torch.models.model import attn_layers, block_ffn, embed_tokens

    path = cfg.matmul_policy or "auto"
    cp, cr = cfg, cfg.with_(matmul_policy="fixed:ref")
    blocks = zip(attn_layers(bind_serving_weights(served, cp), cp),
                 attn_layers(bind_serving_weights(served, cr), cr))
    rtol = 0.0 if cfg.act_dtype == "int8" else LAYER_RTOL
    toks, pos, _ = next(_prompt_chunks(torch, cfg))
    CL = cache_len(cfg, 256)
    empty = torch.zeros((1, CL, cfg.n_kv_heads, cfg.head_dim),
                        dtype=torch.bfloat16, device=DEVICE)
    no_pos = torch.full((1, CL), -1, dtype=torch.int32, device=DEVICE)
    h = embed_tokens(served, cfg, toks)
    worst = 0.0

    def held(got, want, what):
        nonlocal worst
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        worst = max(worst, err / scale)
        if not err <= rtol * scale:
            raise AssertionError(f"{path} {what}: max abs err {err} > "
                                 f"{rtol} * {scale}")

    for i, (bp, br) in enumerate(blocks):
        hn = rms_norm(br["ln1"], h, offset=cfg.rmsnorm_offset)
        a = [append_attention(b["attn"], hn, c, positions=pos,
                              cache_k=empty, cache_v=empty,
                              k_positions=no_pos, window=cfg.window)[0]
             for b, c in ((bp, cp), (br, cr))]
        held(*a, f"layer {i} attention")
        h = h + a[1]
        hn = rms_norm(br["ln2"], h, offset=cfg.rmsnorm_offset)
        f = [block_ffn(b, hn, c)[0] for b, c in ((bp, cp), (br, cr))]
        held(*f, f"layer {i} ffn")
        h = h + f[1]
    return {"arch": cfg.name, "policy": path, "act_dtype": cfg.act_dtype,
            "layers": cfg.n_layers, "rtol": rtol,
            "worst_err_over_max": worst}


def recurrent_layer_check(torch, served, cfg) -> dict:
    """The cross-check prompt through a whole-prompt model with every
    block of the path fed the reference's own input (zamba2: each Mamba2
    mixer, each shared block's attention and FFN; xlstm: each mLSTM and
    sLSTM block): each block's output through the path's kernels within
    ``LAYER_RTOL`` of the largest magnitude of ``fixed:ref``'s."""
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.decode import bind_serving_weights
    from repro_torch.models.layers import attention, ffn, rms_norm
    from repro_torch.models.model import embed_tokens

    path = cfg.matmul_policy or "auto"
    cp, cr = cfg, cfg.with_(matmul_policy="fixed:ref")
    P, R = bind_serving_weights(served, cp), bind_serving_weights(served, cr)
    toks = _cross_tokens(torch, cfg)
    positions = torch.arange(toks.shape[1], device=DEVICE)
    h = embed_tokens(served, cfg, toks)
    worst, blocks = 0.0, 0

    def held(fn, what):
        nonlocal worst, blocks
        got, want = fn(P, cp), fn(R, cr)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        worst, blocks = max(worst, err / scale), blocks + 1
        if not err <= LAYER_RTOL * scale:
            raise AssertionError(f"{cfg.name} {path} {what}: max abs err "
                                 f"{err} > {LAYER_RTOL} * {scale}")
        return want

    if cfg.name == ZAMBA:
        for i in range(cfg.n_layers):
            hn = rms_norm(R["mamba_blocks"][i]["ln"], h)
            h = h + held(lambda p, c: ssm.mamba2_block(
                p["mamba_blocks"][i]["mixer"], hn, c)[0], f"mamba2 {i}")
            if (i + 1) % cfg.attn_every:
                continue
            hn = rms_norm(R["shared_attn"]["ln1"], h)
            h = h + held(lambda p, c: attention(
                p["shared_attn"]["attn"], hn, c, positions=positions,
                window=cfg.window), f"shared attention after {i}")
            hn = rms_norm(R["shared_attn"]["ln2"], h)
            h = h + held(lambda p, c: ffn(p["shared_attn"]["ffn"], hn, c),
                         f"shared ffn after {i}")
    else:
        for i in range(cfg.n_layers // 2):
            hn = rms_norm(R["mlstm_blocks"][i]["ln"], h)
            h = h + held(lambda p, c: xlstm.mlstm_block(
                p["mlstm_blocks"][i]["cell"], hn, c)[0], f"mlstm {i}")
            hn = rms_norm(R["slstm_blocks"][i]["ln"], h)
            h = h + held(lambda p, c: xlstm.slstm_block(
                p["slstm_blocks"][i]["cell"], hn, c)[0], f"slstm {i}")
    return {"arch": cfg.name, "policy": path, "act_dtype": cfg.act_dtype,
            "blocks": blocks, "rtol": LAYER_RTOL,
            "worst_err_over_max": worst}


def encdec_layer_check(torch, served, cfg) -> dict:
    """whisper's first encoder block (on the seeded frames) and first
    decoder block (on the cross-check prompt, over the reference's encoder
    output), every sub-layer of the path fed the reference's own input:
    the attentions, the FFNs and the cross-attention keys and values (M =
    enc_seq) each within ``LAYER_RTOL`` of the largest magnitude of
    ``fixed:ref``'s."""
    from repro_torch.models.decode import bind_serving_weights
    from repro_torch.models.layers import attention, cross_kv, ffn, rms_norm
    from repro_torch.models.model import (embed_tokens, sinusoidal_positions,
                                          whisper_encode, with_positions)

    path = cfg.matmul_policy or "auto"
    cp, cr = cfg, cfg.with_(matmul_policy="fixed:ref")
    P, R = bind_serving_weights(served, cp), bind_serving_weights(served, cr)
    worst, held_n = 0.0, 0

    def held(fn, what):
        nonlocal worst, held_n
        got, want = fn(P, cp), fn(R, cr)
        for g, w, part in ((got, want, ""),) if torch.is_tensor(got) else \
                zip(got, want, (" k", " v")):
            err = float((g.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            worst, held_n = max(worst, err / scale), held_n + 1
            if not err <= LAYER_RTOL * scale:
                raise AssertionError(f"{cfg.name} {path} {what}{part}: max "
                                     f"abs err {err} > {LAYER_RTOL} * "
                                     f"{scale}")
        return want

    frames = stub_inputs(torch, cfg)["frames"]
    S = frames.shape[1]
    x = with_positions(frames, sinusoidal_positions(S, cfg.d_model,
                                                    DEVICE)[None])
    pos = torch.arange(S, device=DEVICE)
    e0 = R["enc_blocks"][0]
    hn = rms_norm(e0["ln1"], x)
    x = x + held(lambda p, c: attention(
        p["enc_blocks"][0]["attn"], hn, c, positions=pos, kind="full",
        use_rope=False), "encoder block 0 attention")
    hn = rms_norm(e0["ln2"], x)
    held(lambda p, c: ffn(p["enc_blocks"][0]["ffn"], hn, c),
         "encoder block 0 ffn")
    enc_out = whisper_encode(R, cr, frames)
    toks = _cross_tokens(torch, cfg)
    T = toks.shape[1]
    h = with_positions(embed_tokens(served, cfg, toks),
                       sinusoidal_positions(T, cfg.d_model, DEVICE)[None])
    tpos = torch.arange(T, device=DEVICE)
    d0 = R["dec_blocks"][0]
    hn = rms_norm(d0["ln1"], h)
    h = h + held(lambda p, c: attention(
        p["dec_blocks"][0]["self_attn"], hn, c, positions=tpos,
        use_rope=False), "decoder block 0 self-attention")
    kv = held(lambda p, c: cross_kv(p["dec_blocks"][0]["cross_attn"],
                                    enc_out, c),
              "decoder block 0 cross keys/values")
    hn = rms_norm(d0["ln2"], h)
    h = h + held(lambda p, c: attention(
        p["dec_blocks"][0]["cross_attn"], hn, c, positions=tpos,
        k_positions=pos, kind="full", kv=kv, use_rope=False),
        "decoder block 0 cross-attention")
    hn = rms_norm(d0["ln3"], h)
    held(lambda p, c: ffn(p["dec_blocks"][0]["ffn"], hn, c),
         "decoder block 0 ffn")
    return {"arch": cfg.name, "policy": path, "act_dtype": cfg.act_dtype,
            "blocks": "encoder 0, decoder 0", "held": held_n,
            "rtol": LAYER_RTOL, "worst_err_over_max": worst}


def aligned(torch, state, m_state, m_to):
    """A stabilized state (``C`` or ``n``, kept times ``e^-m``) brought
    from its stabilizer ``m_state`` to ``m_to``, in f64."""
    shift = torch.exp(m_state.double() - m_to.double())
    return state.double() * shift.reshape(
        *shift.shape, *[1] * (state.ndim - shift.ndim))


def block_step_check(torch, served, cfg, S: int) -> dict:
    """Each recurrent block of a whole-prompt model (zamba2's Mamba2
    mixers; xlstm's mLSTM and sLSTM blocks) fed the prefill's own input at
    that block for a random ``S``-token prompt, once in its prefill form
    and once a position at a time in its decode form from the initial
    state, on the prior: outputs and final states within ``LAYER_RTOL``
    of their largest magnitude (stabilized states aligned first, see the
    module docstring).  The residual stream advances by the prefill
    form's output, so no block's error reaches the next."""
    import numpy as np

    from repro_torch.models import ssm, xlstm
    from repro_torch.models.decode import _shared_block, bind_serving_weights
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import embed_tokens

    p = bind_serving_weights(served, cfg)
    toks = torch.from_numpy(np.random.default_rng(SEED + S).integers(
        2, cfg.vocab_size, size=(1, S))).to(DEVICE)
    positions = torch.arange(S, device=DEVICE)
    h = embed_tokens(p, cfg, toks)
    worst, blocks = {}, 0

    def held(what, got, want):
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.double().abs().max())
        worst[what] = max(worst.get(what, 0.0), err / scale)
        if not err <= LAYER_RTOL * scale:
            raise AssertionError(f"{cfg.name} S={S} {what}: stepped vs "
                                 f"prefill max abs err {err} > "
                                 f"{LAYER_RTOL} * {scale}")

    def stepped(fn, x, state):
        ys = []
        for t in range(S):
            y, state = fn(x[:, t:t + 1], state)
            ys.append(y)
        return torch.cat(ys, 1), state

    if cfg.name == ZAMBA:
        for i, blk in enumerate(p["mamba_blocks"]):
            h_in = rms_norm(blk["ln"], h)
            y, (st, cv) = ssm.mamba2_block(blk["mixer"], h_in, cfg)
            d_in, H, N = ssm.ssm_dims(cfg)
            st0 = torch.zeros((1, H, N, cfg.ssm_head_dim), device=DEVICE)
            cv0 = torch.zeros((1, cfg.ssm_conv - 1, d_in + 2 * N),
                              dtype=torch.bfloat16, device=DEVICE)
            ys, (sst, scv) = stepped(lambda x, s: ssm.mamba2_block(
                blk["mixer"], x, cfg, state=s[0], conv_state=s[1]), h_in,
                (st0, cv0))
            held("mamba2 y", ys, y)
            held("mamba2 ssm state", sst, st)
            held("mamba2 conv state", scv, cv)
            blocks += 1
            h = h + y
            if (i + 1) % cfg.attn_every == 0:
                h, _ = _shared_block(p["shared_attn"], h, cfg,
                                     positions=positions, window=cfg.window,
                                     return_kv=True)
    else:
        for mblk, sblk in zip(p["mlstm_blocks"], p["slstm_blocks"]):
            h_in = rms_norm(mblk["ln"], h)
            y, (C, n, m) = xlstm.mlstm_block(mblk["cell"], h_in, cfg)
            _, H, dk = xlstm.mlstm_dims(cfg)
            init = (torch.zeros((1, H, dk, dk), device=DEVICE),
                    torch.zeros((1, H, dk), device=DEVICE),
                    torch.full((1, H), -1e30, device=DEVICE))
            ys, (sC, sn, sm) = stepped(lambda x, s: xlstm.mlstm_block(
                mblk["cell"], x, cfg, state=s, decode=True), h_in, init)
            held("mlstm y", ys, y)
            held("mlstm C", aligned(torch, sC, sm, m), C)
            held("mlstm n", aligned(torch, sn, sm, m), n)
            h = h + y
            h_in = rms_norm(sblk["ln"], h)
            y, (c, n, hh, m) = xlstm.slstm_block(sblk["cell"], h_in, cfg)
            ys, (sc, sn, sh, sm) = stepped(lambda x, s: xlstm.slstm_block(
                sblk["cell"], x, cfg, state=s), h_in, None)
            held("slstm y", ys, y)
            held("slstm c", aligned(torch, sc, sm, m), c)
            held("slstm n", aligned(torch, sn, sm, m), n)
            held("slstm h", sh, hh)
            blocks += 2
            h = h + y
    return {"arch": cfg.name, "prompt_len": S, "blocks": blocks,
            "rtol": LAYER_RTOL, "worst_err_over_max": worst}


def top2_margin(torch, engine, cfg, prompt, stream, t: int) -> float:
    """The top-2 margin of the bf16-rounded logits before ``stream[t]``,
    teacher-forced: the prompt's whole prefill, then one decode step a
    token of ``stream[:t]``."""
    from repro_torch.models.decode import decode_step, prefill

    toks = torch.tensor([prompt], dtype=torch.int64, device=DEVICE)
    cache, logits = prefill(engine.params, cfg, {"tokens": toks},
                            engine.max_len)
    for i in range(t):
        logits, cache = decode_step(
            engine.params, cfg, cache,
            torch.tensor([stream[i]], device=DEVICE), len(prompt) + i)
    top = logits[0, :cfg.vocab_size].to(torch.bfloat16).float().topk(2)[0]
    return float(top[0] - top[1])


def generational_path(torch, served, cfg, checked: set) -> dict:
    """``DecodeEngine.run`` (generational batching) on ``GEN_REQUESTS``
    requests of one prompt length at batch 4, canonical greedy, with the
    launch counters set to 0 just before and read just after; then
    ``serve()`` on the same requests.  The streams must agree by the
    margin rule (see the module docstring).  Returns the path's record."""
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.serving.engine import DecodeEngine, SamplerConfig

    model, batch, act = cfg.name, GEN_REQUESTS, cfg.dtype
    selection = path_selection(model, batch, act, cfg.matmul_policy)
    whole_prompt_rows(model, [GEN_LENGTH, batch * GEN_LENGTH, batch], act,
                      checked, cfg.matmul_policy)
    cases = selected_cases(model, selection, act)
    if cases - checked:
        raise AssertionError(f"generational path selects unchecked "
                             f"{sorted(cases - checked)}")
    engine = DecodeEngine(served, cfg, batch_size=batch, max_len=256,
                          prefill_chunk=PREFILL_CHUNK, device=DEVICE,
                          sampler=SamplerConfig(canonical_greedy=True))
    engine.run(make_requests([GEN_LENGTH], 2, cfg.vocab_size, SEED + 99))
    torch.cuda.synchronize()
    reqs = make_requests([GEN_LENGTH] * batch, GEN_NEW_TOKENS, cfg.vocab_size,
                         SEED + 11)
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(counts, {name for _, name, _, _ in cases})
    for r in reqs:
        if not (r.done and len(r.out) == GEN_NEW_TOKENS) or \
                not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid} ended with {r.out}")
    base = make_requests([GEN_LENGTH] * batch, GEN_NEW_TOKENS,
                         cfg.vocab_size, SEED + 11)
    engine.serve(base)
    divergences = []
    for i, (a, b) in enumerate(zip(reqs, base)):
        if a.out == b.out:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a.out, b.out)) if x != y)
        margin = top2_margin(torch, engine, cfg, b.prompt, b.out, t)
        divergences.append({"request": i, "position": t, "margin": margin})
        if not margin < LOGIT_ATOL:
            raise AssertionError(f"run() and serve() streams of request {i} "
                                 f"differ at {t}, where the top-2 margin "
                                 f"{margin} is not below {LOGIT_ATOL}")
    n_tok = sum(len(r.out) for r in reqs)
    del engine
    return {"model": model, "policy": cfg.matmul_policy or "auto",
            "act": act, "batch": batch, "requests": len(reqs),
            "prompt_lengths": [GEN_LENGTH] * batch, "new_tokens": n_tok,
            "decode_steps": GEN_NEW_TOKENS - 1, "seconds": dt,
            "tokens_per_s": n_tok / dt,
            "decode_step_ms_with_prefill": dt / GEN_NEW_TOKENS * 1e3,
            "streams_equal_serve": not divergences,
            "divergences": divergences, "launches": counts,
            "selected": {f"M{m}:K{k}:N{n}": name
                         for (m, k, n), name in selection.items()}}


def recurrent_check(torch, served, cfg, S: int) -> dict:
    """A random ``S``-token prompt's whole prefill against the same prompt
    fed one token at a time through ``decode_step`` from ``init_cache``,
    under ``cfg.matmul_policy``: last-position logits within
    ``RECURRENT_LOGIT_ATOL`` and every cache leaf within
    ``RECURRENT_STATE_RTOL`` of its largest magnitude (slot positions
    equal)."""
    import numpy as np

    from repro_torch.models.decode import (bind_serving_weights, decode_step,
                                           init_cache, prefill)

    p = bind_serving_weights(served, cfg)
    prompt = torch.from_numpy(np.random.default_rng(SEED + S).integers(
        2, cfg.vocab_size, size=(1, S))).to(DEVICE)
    t0 = time.perf_counter()
    cw, lw = prefill(p, cfg, {"tokens": prompt}, 256)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cs = init_cache(cfg, 1, 256, device=DEVICE)
    for i in range(S):
        ls, cs = decode_step(p, cfg, cs, prompt[:, i], i)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lw, ls = lw[0, :cfg.vocab_size], ls[0, :cfg.vocab_size]
    logit_diff = float((lw - ls).abs().max())
    atol, rtol = RECURRENT_LOGIT_ATOL, RECURRENT_STATE_RTOL
    if not (torch.isfinite(lw).all() and torch.isfinite(ls).all()):
        raise AssertionError("non-finite logits")
    if not logit_diff <= atol:
        raise AssertionError(f"{cfg.name} S={S}: prefill vs token-by-token "
                             f"logits differ by {logit_diff}")
    leaves = {}
    for name, leaf in cw.items():
        if name == "pos":
            if not torch.equal(leaf, cs[name]):
                raise AssertionError(f"{cfg.name} S={S}: slot positions "
                                     f"differ")
            continue
        a = leaf.double()
        b = (aligned(torch, cs[name], cs[STABILIZED[name]],
                     cw[STABILIZED[name]]) if name in STABILIZED
             else cs[name].double())
        err, scale = float((a - b).abs().max()), float(a.abs().max())
        leaves[name] = {"max_abs_diff": err, "max_abs": scale}
        if name in STABILIZED.values():
            continue        # the stabilizers themselves: reported only
        if not err <= rtol * scale:
            raise AssertionError(f"{cfg.name} S={S}: state {name} differs "
                                 f"by {err} > {rtol} * {scale}")
    return {"arch": cfg.name, "policy": cfg.matmul_policy or "auto",
            "prompt_len": S, "logits_max_abs_diff":
            logit_diff, "logits_atol": atol,
            "max_abs_logit": float(lw.abs().max()),
            "argmax_equal": bool(lw.argmax() == ls.argmax()),
            "state_rtol": rtol, "states": leaves,
            "prefill_s": t1 - t0, "token_by_token_s": t2 - t1}


# ---------------------------------------------------------------------------


def sharded_rank(mesh, device, cfg, lengths, new_tokens: int) -> dict:
    """One rank of ``sharded_phase``: ``cfg`` (bitnet's) built from the seed
    on this rank's card, then for each of ``SHARD_MESHES`` (the first is ``mesh``,
    the others built over the same world) an engine on the prior serving
    the batch-4 path's requests with the launch counters and the mesh's
    collective counts set to 0 just before and read just after, and an
    engine pinned to ``lut_gather`` admitting the cross-check prompt (its
    last position's logits)."""
    import numpy as np
    import torch

    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.decode import init_serving_params
    from repro_torch.serving.engine import DecodeEngine, Request
    from repro_torch.serving.scheduler import ContinuousScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    served = init_serving_params(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    sync()
    out = {"build_s": time.perf_counter() - t0, "meshes": {}}
    meshes = [mesh] + [make_serving_mesh(spec, backend=mesh.backend)
                       for spec in SHARD_MESHES[1:]]
    prompt = np.random.default_rng(SEED + 5).integers(
        2, cfg.vocab_size, size=CROSS_LENGTH).tolist()
    for spec, m in zip(SHARD_MESHES, meshes):
        engine = DecodeEngine(served, cfg, batch_size=4, max_len=256,
                              prefill_chunk=PREFILL_CHUNK, device=device,
                              mesh=m)
        engine.serve(make_requests([lengths[0]], 2, cfg.vocab_size,
                                   SEED + 99))
        sync()
        reqs = make_requests(lengths, new_tokens, cfg.vocab_size, SEED + 4)
        sched = ContinuousScheduler(engine)
        for r in reqs:
            sched.submit(r)
        reset_launch_counts()
        m.stats.reset()
        t1 = time.perf_counter()
        sched.run()
        sync()
        dt = time.perf_counter() - t1
        counts = launch_counts()
        n_tok = sum(len(r.out) for r in reqs)
        rec = {"mesh": spec, "coords": m.coords, "seconds": dt,
               "tokens": n_tok, "tokens_per_s": n_tok / dt,
               "decode_steps": sched.stats.decode_steps,
               "prefill_chunks": sched.stats.prefill_chunks,
               "launches": counts, "gathers": m.stats.as_dict(),
               "streams": [r.out for r in reqs],
               "done": all(r.done for r in reqs),
               "universe": engine.matmul_shape_universe(),
               "cache_k": list(engine.sched_start()["cache"]["k"].shape)}
        del engine
        pinned = DecodeEngine(
            served, cfg.with_(matmul_policy="fixed:lut_gather"),
            batch_size=4, max_len=256, prefill_chunk=PREFILL_CHUNK,
            device=device, mesh=m)
        state = pinned.sched_admit(pinned.sched_start(), 0,
                                   Request(prompt=prompt))
        rec["logits"] = state["logits"][0, :cfg.vocab_size].float().cpu() \
            .numpy()
        del pinned, state
        out["meshes"][spec] = rec
    if device.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def split_check(torch) -> dict:
    """Which products a 1x2 rank runs sum each output column as the whole
    product does: each dense hand kernel (``REGISTRY[name].run``, as
    dispatch launches it) on a random weight against the concatenation of
    the same kernel on its two halves of rows, at bitnet's shapes and the
    decode and admission M; the bf16 head (``torch.matmul`` at the whole
    and half vocab); and the attention (``layers._sdpa``) over bitnet's 5
    kv groups against a rank's 3 (q zero-padded to whole groups, as
    ``layers._local_groups``).  Returns, per product, whether every case
    was bitwise equal and the largest difference."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import encoding
    from repro_torch.kernels.dispatch import REGISTRY, TernaryWeight
    from repro_torch.models import layers

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    out = {}

    def record(name, a, b):
        d = float((a.double() - b.double()).abs().max())
        prev = out.get(name, {"bitwise": True, "max_abs": 0.0})
        out[name] = {"bitwise": prev["bitwise"] and torch.equal(a, b),
                     "max_abs": max(prev["max_abs"], d)}

    def weight(trits):
        return TernaryWeight.from_packed(encoding.pad_rows(
            encoding.pack_base3(trits), encoding.PACKED_ROW_BYTES), 1.0,
            trits.shape[1])

    for m in (4, PREFILL_CHUNK):
        for k, n in ((2560, 2560), (2560, 6912), (6912, 2560)):
            trits = torch.randint(-1, 2, (n, k), generator=g, device=dev,
                                  dtype=torch.int8)
            whole, halves = weight(trits), [weight(t.contiguous())
                                            for t in trits.chunk(2)]
            xb = torch.randn((m, k), generator=g, device=dev,
                             dtype=torch.bfloat16)
            x8 = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                               dtype=torch.int8)
            for name in ("lut_gather", "lut_onehot", "tl2", "dequant_packed",
                         "signflip", "w2a8"):
                x = x8 if name == "w2a8" else xb
                run = REGISTRY[name].run
                record(name, run(x, whole, 3),
                       torch.cat([run(x, h, 3) for h in halves], -1))
        h = torch.randn((m, 2560), generator=g, device=dev,
                        dtype=torch.bfloat16)
        head = torch.randn((2560, 128256), generator=g, device=dev,
                           dtype=torch.bfloat16) * 0.02
        record("lm_head", h @ head, torch.cat(
            [h @ w.contiguous() for w in head.chunk(2, 1)], -1))
    cfg = get_config(ARCH)
    for sq, sk in ((1, 256), (PREFILL_CHUNK, 256)):
        q = torch.randn((4, sq, 20, 128), generator=g, device=dev,
                        dtype=torch.bfloat16)
        kv = [torch.randn((4, sk, 5, 128), generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2)]
        qp = torch.arange(sk - sq, sk, device=dev).expand(4, sq)
        kp = torch.arange(sk, device=dev).expand(4, sk)
        full = layers._sdpa(q, *kv, cfg, q_pos=qp, k_pos=kp).reshape(
            4, sq, 20, 128)
        for h0, (g0, g1), front in ((0, (0, 3), 0), (10, (2, 5), 2)):
            qr = torch.nn.functional.pad(q[:, :, h0:h0 + 10],
                                         (0, 0, front, 12 - 10 - front))
            part = layers._sdpa(qr, kv[0][:, :, g0:g1], kv[1][:, :, g0:g1],
                                cfg, q_pos=qp, k_pos=kp).reshape(
                                    4, sq, 12, 128)
            record("attention", full[:, :, h0:h0 + 10],
                   part[:, :, front:front + 10])
    return out


def sharded_phase(torch, served, cfg, rows: list, checked: set, flush,
                  card: str, batch4_streams) -> dict:
    """bitnet at full width and depth served as two ranks of one card
    (``launch.mesh.run_ranks`` over ``SHARD_BACKEND``, the kernels built
    before the ranks start), at each of ``SHARD_MESHES``: the kernels at the
    local shapes a rank runs held against their plain versions first; each
    rank's launches must be its path's selection (checked), every rank's
    streams equal, and equal to the ``batch4`` path's (where they part, the
    single-device top-2 margin there below 2^-3, as ``generational_path``);
    the prefill logits under ``fixed:lut_gather`` within
    ``SHARD_LOGIT_ATOL`` of the single-device ones.  Returns the paths'
    records."""
    import numpy as np

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.serving.engine import DecodeEngine

    lut = "fixed:lut_gather"
    # what each mesh's ranks dispatch: 1x2 at its local shapes (decode M=4,
    # the admission chunk M=32, on the prior and pinned), 2x1 at bitnet's
    # (decode M=2, chunk M=32)
    select = {"1x2": path_selection(SHARD_1X2, 4, "bfloat16"),
              "2x1": path_selection(ARCH, 2, "bfloat16")}
    cases = (selected_cases(SHARD_1X2, select["1x2"], "bfloat16")
             | selected_cases(SHARD_1X2, path_selection(
                 SHARD_1X2, 4, "bfloat16", lut), "bfloat16"))
    rows += check_kernels(torch, sorted(cases - checked), flush)
    checked |= cases
    emit("split_check", gpu=card, **split_check(torch))
    for name, mdl in (("1x2", SHARD_1X2), ("2x1", ARCH)):
        unchecked = selected_cases(mdl, select[name], "bfloat16") - checked
        if unchecked:
            raise AssertionError(f"sharded {name} selects unchecked "
                                 f"{sorted(unchecked)}")
    t0 = time.perf_counter()
    ranks = run_ranks(sharded_rank, SHARD_MESHES[0], backend=SHARD_BACKEND,
                      device=DEVICE, args=(cfg, BATCH4_LENGTHS, 16),
                      timeout=240)
    wall = time.perf_counter() - t0
    single = _prefill_logits(torch, served, cfg.with_(matmul_policy=lut))
    single = single.cpu().numpy()
    engine = None     # the single-device margin rule's, where streams part
    reqs = make_requests(BATCH4_LENGTHS, 16, cfg.vocab_size, SEED + 4)
    paths = {}
    for spec in SHARD_MESHES:
        recs = [r["meshes"][spec] for r in ranks]
        expect = {name for _, name, _, _ in selected_cases(
            SHARD_1X2 if spec == "1x2" else ARCH, select[spec], "bfloat16")}
        for rec in recs:
            check_launches(rec["launches"], expect)
            if rec["streams"] != recs[0]["streams"] or not rec["done"]:
                raise AssertionError(f"sharded {spec}: the ranks' streams "
                                     f"differ or a request did not finish")
        divergences = []
        for i, (a, b) in enumerate(zip(recs[0]["streams"], batch4_streams)):
            if a == b:
                continue
            t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            engine = engine or DecodeEngine(
                served, cfg, batch_size=4, max_len=256,
                prefill_chunk=PREFILL_CHUNK, device=DEVICE)
            margin = top2_margin(torch, engine, cfg, reqs[i].prompt, b, t)
            divergences.append({"request": i, "position": t,
                                "margin": margin})
            if not margin < LOGIT_ATOL:
                raise AssertionError(
                    f"sharded {spec}: request {i} parts from batch4 at {t}, "
                    f"where the top-2 margin {margin} is not below "
                    f"{LOGIT_ATOL}")
        diff = float(np.abs(recs[0]["logits"].astype(np.float64)
                            - single.astype(np.float64)).max())
        if not diff <= SHARD_LOGIT_ATOL:
            raise AssertionError(f"sharded {spec}: prefill logits under "
                                 f"{lut} {diff} from single-device, over "
                                 f"{SHARD_LOGIT_ATOL}")
        launches = {k: sum(r["launches"][k] for r in recs)
                    for k in recs[0]["launches"]}
        paths[f"sharded_{spec}"] = {
            "model": ARCH, "mesh": spec, "backend": SHARD_BACKEND,
            "policy": "auto", "act": "bfloat16", "batch": 4,
            "requests": len(reqs), "new_tokens": recs[0]["tokens"],
            "decode_steps": recs[0]["decode_steps"],
            "prefill_chunks": recs[0]["prefill_chunks"],
            "streams_equal_batch4": not divergences,
            "divergences": divergences,
            "logits_vs_single_max_abs": diff,
            "logits_bitwise": diff == 0.0,
            "launches": launches,
            "per_rank": [{"coords": r["coords"], "launches": {
                k: v for k, v in r["launches"].items() if v},
                "gather_calls": r["gathers"]["calls"],
                "gather_bytes": r["gathers"]["bytes"],
                "gather_ms": r["gathers"]["ms"], "seconds": r["seconds"],
                "tokens_per_s": r["tokens_per_s"],
                "universe": r["universe"], "cache_k": r["cache_k"]}
                for r in recs],
            "timing": SHARD_LABEL,
            "selected": {f"M{m}:K{k}:N{n}": name
                         for (m, k, n), name in select[spec].items()}}
    del engine
    for rank, r in enumerate(ranks):
        emit("sharded_rank", rank=rank, build_s=r["build_s"],
             peak_gb=r.get("peak_gb"), gpu=card)
    paths["sharded_1x2"]["phase_wall_s"] = wall
    return paths


def autotune_phase(torch, served, cfg, measurements: int = 2) -> dict:
    """``DecodeEngine.autotune_shapes`` at batch 4 for ``cfg``'s activation
    dtype, dense and grouped shapes; one line per shape with every eligible
    kernel's µs and the winner.  Every eligible hand kernel must have a time
    at every shape.  With two measurements the cache keeps the second, and
    the first shows whether the winners repeat."""
    from repro_torch.kernels.dispatch import eligible_kernels
    from repro_torch.serving.engine import DecodeEngine

    act = "int8" if cfg.act_dtype == "int8" else cfg.dtype
    engine = DecodeEngine(served, cfg, batch_size=4, max_len=256,
                          prefill_chunk=PREFILL_CHUNK, device=DEVICE)
    t0 = time.perf_counter()
    first = results = engine.autotune_shapes()
    seconds = time.perf_counter() - t0
    for _ in range(measurements - 1):
        results = engine.autotune_shapes()
    del engine
    table = {}
    for shape, us in sorted(results.items()):
        e = shape[0] if len(shape) == 4 else None
        m, k, n = shape[-3:]
        want = {s.name for s in eligible_kernels(m, k, n, act, e)}
        if set(us) != want or not all(t > 0 for t in us.values()):
            raise AssertionError(f"autotune {shape} {act}: timed "
                                 f"{sorted(us)}, eligible {sorted(want)}")
        winner = min(us, key=us.get)
        before = first[shape]
        emit("autotune", model=cfg.name, act=act, E=e, M=m, K=k, N=n, us=us,
             winner=winner, first_us=before,
             first_winner=min(before, key=before.get))
        key = ("" if e is None else f"E{e}:") + f"M{m}:K{k}:N{n}"
        table[key] = {"us": us, "winner": winner, "first_us": before}
    return {"model": cfg.name, "act": act, "seconds": seconds,
            "measurements": measurements, "shapes": table,
            "winners_repeated": sum(
                min(first[s], key=first[s].get) == min(r, key=r.get)
                for s, r in results.items())}


def recurrent_phase(torch, rows: list, checked: set, flush,
                    card: str) -> dict:
    """zamba2-2.7b, then xlstm-125m (see the module docstring): each
    model's kernel checks (appended to ``rows`` and ``checked``), its tree
    built at full width and depth, its paths served, ``cross_check`` and
    ``recurrent_check``; each tree freed before the next is built.
    Returns ``{path: record}``."""
    import gc

    lengths = BATCH4_LENGTHS
    paths = {}
    for model in RECURRENT_LENGTHS:
        cases = kernel_cases(model)
        rows += check_kernels(torch, cases, flush)
        checked |= set(cases)
        for name, m, act in MODEL_LAYER_ROWS[model]:
            emit("layer", kernel=name, **layer_summary(rows, name, model, m,
                                                       act))
        cfg, served = build_model(torch, model)
        # on the prior: bitnet's autotune measured its 2560 x 2560 shape,
        # which zamba2's shared attention shares
        cfg = cfg.with_(matmul_policy="prior")

        def run_path(name, **kw):
            paths[name] = serve_path(torch, served, cfg, model,
                                     checked=checked,
                                     roofline=name in ROOFLINE_PATHS, **kw)
            emit(f"serve_{name}", gpu=card, **paths[name])
            torch.cuda.empty_cache()

        tag = model.split("-")[0]
        run_path(f"{tag}_batch4", batch=4, lengths=lengths, new_tokens=16)
        if model == ZAMBA:
            run_path("zamba2_batch1", batch=1, lengths=BATCH1_LENGTHS,
                     new_tokens=16)
            paths["zamba2_generational"] = generational_path(
                torch, served, cfg, checked)
            emit("serve_zamba2_generational", gpu=card,
                 **paths["zamba2_generational"])
        whole_prompt_rows(model, [CROSS_LENGTH, 1, *RECURRENT_LENGTHS[model]],
                          cfg.dtype, checked, cfg.matmul_policy)
        emit("layer_check", **recurrent_layer_check(torch, served, cfg))
        emit("cross_check", **cross_check(torch, served, cfg))
        ref = cfg.with_(matmul_policy="fixed:ref")
        for n in RECURRENT_LENGTHS[model]:
            emit("block_step_check", **block_step_check(torch, served, cfg,
                                                        n))
            # the plain path's own prefill-vs-stepped spread: what the
            # whole-model bounds stand on (see the module docstring)
            for c in (cfg, ref):
                emit("recurrent_check", **recurrent_check(torch, served, c,
                                                          n))
        del served, run_path
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def attention_archs_phase(torch, rows: list, checked: set, flush,
                          card: str) -> dict:
    """The attention archs of ``ATTN_ARCHS``, in order: each model's
    kernel checks (appended to ``rows`` and ``checked``), its tree built
    layer by layer at full width and depth, its batch-4 path served on the
    prior (the dense archs through chunked admission, internvl2 and
    whisper through whole prompts with the engine's zero frontend inputs),
    each model's ``layer_check`` (whisper's ``encdec_layer_check``) and
    ``cross_check`` (seeded frontend inputs), then the tree freed.
    Returns ``{path: record}``."""
    import gc

    paths = {}
    for model, tag in ATTN_ARCHS.items():
        cases = kernel_cases(model)
        rows += check_kernels(torch, cases, flush)
        checked |= set(cases)
        for name, m, act in MODEL_LAYER_ROWS[model]:
            emit("layer", kernel=name, **layer_summary(rows, name, model, m,
                                                       act))
        cfg, served = build_model(torch, model)
        cfg = cfg.with_(matmul_policy="prior")
        name = f"{tag}_batch4"
        paths[name] = serve_path(torch, served, cfg, model, batch=4,
                                 lengths=batch4_lengths(model), new_tokens=16,
                                 checked=checked)
        emit(f"serve_{name}", gpu=card, **paths[name])
        torch.cuda.empty_cache()
        if model in WHOLE_PROMPT:
            whole_prompt_rows(model, [cross_length(model)], cfg.dtype,
                              checked, cfg.matmul_policy)
        emit("layer_check", **(encdec_layer_check if cfg.is_encdec
                                else layer_check)(torch, served, cfg))
        emit("cross_check", **cross_check(torch, served, cfg))
        del served
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def llama4_phase(torch, rows: list, checked: set, flush, card) -> dict:
    """llama4-maverick at full width and ``LLAMA4_LAYERS`` layers: its
    kernel checks (appended to ``rows`` and ``checked``; the grouped
    kernels at E=128), its tree built layer by layer (each expert packed as
    it is drawn), ``llama4_batch4`` served on the prior through whole-prompt
    admission with ``grouped_dequant`` launched three times per MoE layer
    per decode step, then ``layer_check`` (every block of the cut depth,
    the first dense and the first MoE block among them), ``cross_check``
    (held where no token was rerouted) and ``forced_check`` (the experts
    teacher-forced to ``fixed:ref``'s, held to 2^-3); the tree freed.
    Returns ``{path: record}``."""
    import gc

    cases = kernel_cases(LLAMA4)
    rows += check_kernels(torch, cases, flush)
    checked |= set(cases)
    for name, m, act in MODEL_LAYER_ROWS[LLAMA4]:
        emit("layer", kernel=name, **layer_summary(rows, name, LLAMA4, m,
                                                   act))
    cfg, served = build_model(torch, LLAMA4, LLAMA4_LAYERS)
    cfg = cfg.with_(matmul_policy="prior")
    rec = serve_path(torch, served, cfg, LLAMA4, batch=4,
                     lengths=BATCH4_LENGTHS, new_tokens=16, checked=checked)
    moe_layers = cfg.n_layers // cfg.moe_every
    per_step = rec["launches_per_decode_step"]
    if per_step.get("grouped_dequant") != 3 * moe_layers:
        raise AssertionError(f"grouped_dequant launched {per_step} times per "
                             f"decode step, not {3 * moe_layers}")
    rec["depth_cut"] = {"n_layers": cfg.n_layers, "of": 48,
                        "groups": moe_layers}
    emit("serve_llama4_batch4", gpu=card, **rec)
    torch.cuda.empty_cache()
    whole_prompt_rows(LLAMA4, [cross_length(LLAMA4)], cfg.dtype, checked,
                      cfg.matmul_policy)
    emit("layer_check", **layer_check(torch, served, cfg))
    emit("cross_check", **cross_check(torch, served, cfg,
                                      routing_may_differ=True))
    emit("forced_check", **forced_check(torch, served, cfg))
    del served
    gc.collect()
    torch.cuda.empty_cache()
    return {"llama4_batch4": rec}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


def _tree_pairs(a, b, path=()):
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _tree_pairs(a[k], b[k], path + (k,))
    else:
        yield "/".join(path), a, b


def _steps_record(records: list[dict], batch: int = TRAIN_BATCH) -> dict:
    tokens = batch * TRAIN_SEQ
    ms = statistics.median(r["ms"] for r in records[1:])
    return {"steps": [{**r, "tokens_per_s": tokens / r["ms"] * 1e3}
                      for r in records],
            "step_ms_median_after_first": ms,
            "tokens_per_s_median_after_first": tokens / ms * 1e3}


def train_bitnet(torch, card) -> tuple[dict, dict]:
    """bitnet-b1.58-2b at full width and depth in QAT (int8 activation
    fake-quant) on AdamW: ``train()`` from the seed-0 init for
    ``TRAIN_STEPS`` steps at global batch ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens.  Every step must be finite and none skipped.  Returns
    ``(record, the trained parameters)``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import train

    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, warmup=TRAIN_WARMUP, lr=TRAIN_LR,
                device=DEVICE, log_every=1)
    seconds = time.perf_counter() - t0
    recs = run["records"]
    if any(r["skipped"] or not math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"a step was skipped or not finite: {recs}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "optimizer": cfg.optimizer,
            "quantize_acts": cfg.quantize_acts, "gpu": card,
            "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
            "warmup": TRAIN_WARMUP, "lr": TRAIN_LR, "seconds": seconds,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            **_steps_record(recs)}, run["params"]


def train_resume(torch, card) -> dict:
    """Checkpoint and resume at full width with the depth cut to
    ``TRAIN_RESUME_LAYERS`` (a checkpoint of the 30-layer state, bf16
    parameters and f32 AdamW moments, is 27 GB; this one is 9.3 GB):
    ``train()`` for ``TRAIN_STEPS`` steps with an async checkpoint after
    step ``TRAIN_RESUME_AT - 1`` and no final one, then a second
    ``train()`` that restores it and trains to the end.  Deterministic
    algorithms on (``CUBLAS_WORKSPACE_CONFIG`` set at start): its losses
    and final parameters must equal the uninterrupted run's bitwise."""
    import gc
    import shutil
    import warnings

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import train

    cfg = get_config(ARCH).with_(n_layers=TRAIN_RESUME_LAYERS)
    ckdir = os.path.join(OUT_DIR, "train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    runs, seconds = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, every in (("uninterrupted", TRAIN_RESUME_AT),
                                ("resumed", 10 ** 9)):
                t0 = time.perf_counter()
                runs[name] = train(cfg, steps=TRAIN_STEPS, ckpt_dir=ckdir,
                                   checkpoint_every=every, save_final=False,
                                   global_batch=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ, warmup=TRAIN_WARMUP,
                                   lr=TRAIN_LR, device=DEVICE, log_every=1)
                seconds[name] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    full, resumed = runs["uninterrupted"], runs["resumed"]
    shutil.rmtree(ckdir, ignore_errors=True)
    want = full["history"]
    if resumed["history"] != want[TRAIN_RESUME_AT:]:
        raise AssertionError(f"losses: uninterrupted {want}, resumed "
                             f"{resumed['history']}")
    differ = [p for p, a, b in _tree_pairs(full["params"], resumed["params"])
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"resumed parameters differ from the "
                             f"uninterrupted run's at {differ[:5]}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "gpu": card,
            "checkpoint_after_step": TRAIN_RESUME_AT - 1,
            "losses": want, "resumed_losses": resumed["history"],
            "resumed_equal": "bitwise (losses and every parameter)",
            "seconds": seconds,
            "nondeterministic_warnings": sorted({str(w.message)[:160]
                                                 for w in caught})}


def _step_on(torch, cfg, params, batch_np, device):
    """One ``make_train_step`` step with ``compress=True`` on ``device``
    from copies of ``params``: ``(loss, grads, update)``, the gradients of
    ``train_loss`` at ``params`` and ``params`` after the step minus
    before, both moved to the host."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import train_loss
    from repro_torch.optim import compression
    from repro_torch.optim.optimizers import (make_optimizer, tree_leaves,
                                              tree_unflatten)

    p = _tree_to(params, device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    names = [n for n, _, _ in _tree_pairs(p, p)]
    leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
    loss = train_loss(tree_unflatten(p, leaves), cfg, batch)[0]
    grads = dict(zip(names, (g.float().cpu() for g in
                             torch.autograd.grad(loss, leaves))))
    del leaves
    before = _tree_to(p, "cpu")
    opt = make_optimizer(cfg.optimizer, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                         total=TRAIN_STEPS)
    step = make_train_step(cfg, opt, compress=True)
    p, _, _, metrics = step(p, opt.init(p), compression.init_error_state(p),
                            batch, 1)
    update = {n: a.float().cpu() - b.float()
              for n, a, b in _tree_pairs(p, before)}
    return float(metrics["loss"]), float(loss.detach()), grads, update


def train_check(torch, arch: str = ARCH) -> dict:
    """One train step of ``arch`` at full width and its
    ``TRAIN_CHECK_LAYERS`` depth with gradient compression, on the card and
    on the CPU from the same weights and batch: the loss, each leaf's
    gradient and each leaf's update must agree (``TRAIN_CHECK_RTOL``, see
    the module docstring)."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.models.model import init_params

    cfg = get_config(arch).with_(n_layers=TRAIN_CHECK_LAYERS[arch])
    # drawn on the card (a CPU draw of bitnet's 0.8 G parameters takes
    # tens of seconds), kept on the host
    params = _tree_to(init_params(cfg, torch.Generator(
        device=DEVICE).manual_seed(SEED + 31), DEVICE), "cpu")
    torch.cuda.empty_cache()
    rows, seq = TRAIN_CHECK_SHAPE[arch]
    batch = SyntheticLMStream(DataConfig(cfg.vocab_size, seq,
                                         rows)).batch(0)
    t0 = time.perf_counter()
    card = _step_on(torch, cfg, params, batch, DEVICE)
    t1 = time.perf_counter()
    cpu = _step_on(torch, cfg, params, batch, "cpu")
    t2 = time.perf_counter()

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    out = {"loss_card": card[0], "loss_cpu": cpu[0],
           "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0]),
           "grad_rel": {n: rel(card[2][n], cpu[2][n]) for n in cpu[2]},
           "update_rel": {n: rel(card[3][n], cpu[3][n]) for n in cpu[3]},
           "update_sign_agree": {n: float(np.mean(
               (torch.sign(card[3][n]) == torch.sign(cpu[3][n])).numpy()))
               for n in cpu[3]}}
    worst = {"loss": out["loss_rel"], "grad": max(out["grad_rel"].values()),
             "update": max(out["update_rel"].values())}
    for key, value in worst.items():
        if not value <= TRAIN_CHECK_RTOL[key]:
            raise AssertionError(f"train_check {arch}: {key} relative "
                                 f"difference "
                                 f"{value} > {TRAIN_CHECK_RTOL[key]}: {out}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "compress": True,
            "batch": rows, "seq_len": seq,
            "card_seconds": t1 - t0, "cpu_seconds": t2 - t1,
            "worst": worst, "rtol": TRAIN_CHECK_RTOL, **out}


def train_recurrent(torch, card, arch: str) -> dict:
    """``arch`` (zamba2 or xlstm) at full width and depth (xlstm's cut to
    ``TRAIN_REC_LAYERS``) in QAT on AdamW: ``train()`` from the seed-0
    init for ``TRAIN_REC_STEPS`` steps of ``TRAIN_BATCH`` rows of
    ``TRAIN_SEQ`` tokens.  Every step must be finite and none skipped, and
    the peak device memory under ``TRAIN_PEAK_GB``."""
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import train

    cfg = get_config(arch)
    full = cfg.n_layers
    cfg = cfg.with_(n_layers=TRAIN_REC_LAYERS.get(arch, full))
    batch = TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train(cfg, steps=TRAIN_REC_STEPS, global_batch=batch,
                seq_len=TRAIN_SEQ, warmup=TRAIN_WARMUP, lr=TRAIN_LR,
                device=DEVICE, log_every=1)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    del run["params"]
    gc.collect()
    torch.cuda.empty_cache()
    recs = run["records"]
    if any(r["skipped"] or not math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"{arch}: a step was skipped or not finite: "
                             f"{recs}")
    if not peak < TRAIN_PEAK_GB:
        raise AssertionError(f"{arch}: training peaked at {peak} GB, not "
                             f"under {TRAIN_PEAK_GB}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "full_depth": full,
            "d_model": cfg.d_model, "optimizer": cfg.optimizer,
            "quantize_acts": cfg.quantize_acts, "remat": cfg.remat,
            "gpu": card, "global_batch": batch, "seq_len": TRAIN_SEQ,
            "warmup": TRAIN_WARMUP, "lr": TRAIN_LR, "seconds": seconds,
            "max_memory_allocated_gb": peak, **_steps_record(recs, batch)}


def train_phase(torch, checked: set, card: str) -> dict:
    """``train_bitnet``, ``train_resume``, ``train_check``, then
    ``train_then_serve``: the
    trained 30-layer tree packed by ``decode.quantize_for_serving`` and
    served at batch 4 on the prior through the hand kernels, with
    ``cross_check`` against ``fixed:ref``; then, bitnet freed,
    ``train_zamba2`` and ``train_xlstm`` (:func:`train_recurrent`) and
    their ``train_check``.  Returns ``{path: record}``."""
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.models.decode import quantize_for_serving

    rec, params = train_bitnet(torch, card)
    emit("train_bitnet", **rec)
    emit("train_resume", **train_resume(torch, card))
    emit("train_check", gpu=card, **train_check(torch))
    # on the prior: bitnet's autotune measured these shapes earlier
    cfg = get_config(ARCH).with_(matmul_policy="prior")
    served = quantize_for_serving(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    path = serve_path(torch, served, cfg, ARCH, batch=4,
                      lengths=BATCH4_LENGTHS, new_tokens=16, checked=checked)
    emit("serve_train_then_serve", gpu=card, **path)
    emit("cross_check", **cross_check(torch, served, cfg))
    del served
    gc.collect()
    torch.cuda.empty_cache()
    for arch, name in ((ZAMBA, "train_zamba2"), (XLSTM, "train_xlstm")):
        emit(name, **train_recurrent(torch, card, arch))
    for arch in (ZAMBA, XLSTM):
        emit("train_check", gpu=card, **train_check(torch, arch))
    return {"train_then_serve": path}


def ablate_phase(torch, rows: list, checked: set, flush, card) -> dict:
    """The packing ablation (``launch.ablate.run``): bitnet's bf16 and
    packed trees at full width and depth, decode at ``ABLATE_BATCH`` rows
    against ``ABLATE_SEQ`` cache positions.  First the hand kernels the
    packed arm selects at M = ``ABLATE_BATCH`` (on the prior) are held
    against their plain versions at bitnet's shapes (appended to ``rows``
    and ``checked``); the launch counters are set to 0 just before the
    ablation and read just after.  Returns ``{path: record}``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.launch import ablate

    selection = {shape: name for shape, name in path_selection(
        ARCH, ABLATE_BATCH, "bfloat16", "prior").items()
        if shape[-3] == ABLATE_BATCH}
    cases = selected_cases(ARCH, selection, "bfloat16")
    rows += check_kernels(torch, sorted(cases - checked), flush)
    checked |= cases
    for _, name, m, act in sorted(cases):
        emit("layer", kernel=name, **layer_summary(rows, name, ARCH, m, act))
    reset_launch_counts()
    rec = ablate.run(get_config(ARCH), ABLATE_BATCH, ABLATE_SEQ,
                     torch.device(DEVICE), SEED)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(counts, {name for _, name, _, _ in cases})
    if not rec["logits_held"]:
        raise AssertionError(f"ablate: the packed and bf16 trees' logits "
                             f"differ by {rec['logits_max_abs_diff']} > "
                             f"{rec['logits_atol']}, and not by the bf16 "
                             f"model's own drift (f64 distances "
                             f"{rec['f64_distance_bf16']}, "
                             f"{rec['f64_distance_packed']})")
    for arm in ("bf16", "packed"):
        rec[arm].pop("wall_ms_all")
    rec.update(launches=counts, selected={
        ":".join(f"{d}{v}" for d, v in zip("MKN", shape)): name
        for shape, name in selection.items()})
    emit("ablate", gpu=card, **rec)
    torch.cuda.empty_cache()
    return {"ablate_packed": rec}


# ---------------------------------------------------------------------------
# the hardware-generation side
# ---------------------------------------------------------------------------


def paper_model() -> dict:
    """The generator and the §IV cost model at the paper's design points,
    held to its published anchors under ``tests/test_cost_model.py``'s
    tolerances: Table IV (the 32 x 32 fp16 core at mu = 3: 0.120 mm^2, the
    dequant and sign-flip baselines 2.23x and 1.64x its area, mu = 3
    optimal), Table V (TENET's (32, 2, 32) within 0.05 of 1.004x the
    matched-throughput optimum and 7.9x its published 28 nm area scaled to
    16 nm, TeLLMe-v2 off the frontier, the (34, 2, 30) int8 core 33,125
    µm^2), int8's optimum at mu 1 or 2 and Fig. 8's aspect directions.
    Every number is the paper's 16 nm ASIC model, not a measurement."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core import dse
    from repro_torch.core.generator import LUTCoreConfig, generate

    # Table IV's tile is 32 x 32 weights (n = L mu = 32, m = K = 32)
    c = cm.get_coeffs("fp16")
    gates = cm.area_gates_lut(3, 32, 32, c)
    table_iv = {"dequant_ratio": cm.area_gates_dequant_baseline(32, 32, c)
                / gates,
                "signflip_ratio": cm.area_gates_signflip_baseline(32, 32, c)
                / gates,
                "area_mm2": cm.lut_core_area_mm2(3, 32, 32, "fp16"),
                "tops_per_mm2": cm.tops_per_mm2(3, 32, 32, "fp16"),
                "optimal_mu": cm.optimal_mu(32, 32, "fp16")}
    table_v = dse.sota_comparison()
    anchor_um2 = dse.DesignPoint(mu=2, L=34, K=30, dtype="int8").area_um2()
    rows = {r["work"]: r for r in table_v}
    fp_geo, i8_geo = (dse.optimal_geometry(1024, dt) for dt in ("fp16", "int8"))
    checks = {
        "table_iv_mu3_optimal": table_iv["optimal_mu"] == 3,
        "table_iv_dequant_2.23": math.isclose(table_iv["dequant_ratio"], 2.23,
                                              rel_tol=0.05),
        "table_iv_signflip_1.64": math.isclose(table_iv["signflip_ratio"],
                                               1.64, rel_tol=0.05),
        "table_iv_area_0.120": math.isclose(table_iv["area_mm2"], 0.120,
                                            rel_tol=0.01),
        "table_v_area_33125": math.isclose(anchor_um2, 33_125, rel_tol=0.01),
        "table_v_tenet_1.004": abs(rows["tenet"]["model_prediction"]
                                   - 1.004) <= 0.05,
        "table_v_tenet_7.9": math.isclose(
            rows["tenet"]["area_decrease_vs_published"], 7.9, rel_tol=0.15),
        "table_v_tellme_off_frontier":
            rows["tellme_v2"]["model_prediction"] > 1.1,
        "int8_mu_1_or_2": cm.optimal_mu(32, 32, "int8") in (1, 2),
        "fig8_geometry": fp_geo.m > fp_geo.n and i8_geo.n > i8_geo.m}
    failed = sorted(k for k, ok in checks.items() if not ok)
    if failed:
        raise AssertionError(f"the port's cost model misses the paper's "
                             f"anchors {failed}: {table_iv}, {table_v}")
    designs = {f"ours_{r['work']}": generate(LUTCoreConfig(
        mu=r["ours"][1], L=r["ours"][0], K=r["ours"][2],
        act_dtype=dse.SOTA[r["work"]]["dtype"])).report() for r in table_v}
    return {"what": "the paper's 16 nm ASIC cost model (area in um^2 and "
                    "mm^2 at 16 nm, TOPS/mm^2 at F_CLK_16NM = 800 MHz); "
                    "modelled, not measured",
            "table_iv": table_iv, "table_v": table_v, "table_v_anchor_um2": anchor_um2,
            "designs": designs, "checks": sorted(checks)}


def hardware_phase(torch, rows: list, checked: set, flush, card) -> dict:
    """The paper's model (:func:`paper_model`), then the generated core
    (``HW_CORE``) simulated on the card on bitnet-b1.58-2b's FFN ``wi``
    (2560 -> 6912) and ``wo`` (6912 -> 2560) at full width: trits from the
    seed-0 draw of a layer's weights, ternarized as served, int8-valued
    activations from the seed.  Each simulated ``y`` must equal the int64
    product, the CUDA ``lut_gather`` at M = 1 on the same keys (the served
    key layout), launched through the design's kernel plan with the
    counters set to 0 just before and read just after, and its plain
    version: f32 is exact there, every partial sum an integer under 2^24.
    The other group sizes (``HW_OTHER_MU``) are simulated against the int64
    product only: no kernel is built for them.  Returns ``{"hardware":
    path record}``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import encoding
    from repro_torch.core.generator import LUTCoreConfig, generate
    from repro_torch.core.quantization import ternarize
    from repro_torch.core.simulator import simulate_gemv
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.kernels.lut_matmul import lut_matmul_torch
    from repro_torch.models.model import init_layer

    emit("hardware_model", **paper_model())
    cfg = get_config(ARCH)
    dev = torch.device(DEVICE)
    layer = init_layer(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)["ffn"]
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    design = generate(LUTCoreConfig(**HW_CORE))
    mu = design.config.mu
    projections = {}
    for name in ("wi", "wo"):
        w_t = ternarize(layer[name]["w"])[0].T.contiguous()     # [N, K]
        x = torch.randint(-127, 128, (w_t.shape[1],), generator=g,
                          device=dev, dtype=torch.int8)
        keys = encoding.encode_weight_matrix(w_t, mu)
        keys = encoding.pad_rows(keys, encoding.KEY_ROW_BYTES,
                                 encoding.table_size(mu))[:, :keys.shape[1]]
        projections[name] = (w_t, x, keys)
        n, k = w_t.shape
        row = kernel_case(torch, "lut_gather", 1, k, n, "int8", flush)
        row["model"] = ARCH
        emit("kernel", **row)
        rows.append(row)
    checked.add((ARCH, "lut_gather", 1, "int8"))
    del layer

    out = {}
    reset_launch_counts()
    kern = {name: design.kernel_plan.run(x[None], keys)[0]
            for name, (_, x, keys) in projections.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(counts, {"lut_gather"})
    for name, (w_t, x, keys) in projections.items():
        want = (w_t.to(torch.int64) * x.to(torch.int64)).sum(-1)
        plain = lut_matmul_torch(x[None], keys, mu)[0]
        times = []
        for _ in range(HW_SIM_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, stats = simulate_gemv(design, w_t, x, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        equal = {"sim_vs_int64": torch.equal(y, want),
                 "kernel_vs_int64": torch.equal(kern[name],
                                                want.to(torch.float32)),
                 "kernel_vs_plain": torch.equal(kern[name], plain)}
        if not all(equal.values()) or y.device.type != dev.type:
            raise AssertionError(f"hardware {name}: {equal} on {y.device}")
        others = {}
        for omu in HW_OTHER_MU:
            od = generate(LUTCoreConfig(**{**HW_CORE, "mu": omu}))
            t0 = time.perf_counter()
            oy, ostats = simulate_gemv(od, w_t, x, device=dev)
            torch.cuda.synchronize()
            if not torch.equal(oy, want):
                raise AssertionError(f"hardware {name}: the mu={omu} core's "
                                     f"simulation is not the int64 product")
            others[omu] = {"cycles": ostats.cycles,
                           "wall_ms": (time.perf_counter() - t0) * 1e3}
        n, k = w_t.shape
        out[name] = {"K": k, "N": n, "equal": equal,
                     "cycles_modelled": stats.cycles,
                     "build_phases": stats.build_phases,
                     "fetch_cycles": stats.fetch_cycles,
                     "mac_equiv": stats.mac_equiv,
                     "muls_per_cycle_modelled": stats.muls_per_cycle,
                     "sim_wall_ms": statistics.median(times),
                     "sim_wall_ms_all": times,
                     "other_mu_vs_int64": others}
    rec = {"design": HW_CORE, "report": design.report(),
           "kernel_plan": {"kernel": design.kernel_plan.kernel,
                           "block_n": design.kernel_plan.block_n,
                           "block_m": design.kernel_plan.block_m},
           "cycles_note": "the generated core's modelled ASIC schedule "
                          "(Eq. 1), not a device measurement",
           "gpu": card, **out, "launches": counts}
    emit("hardware", **rec)
    return {"hardware": rec}


def packed_gb(tree) -> float:
    """GB of packed ternary bytes in a serving tree."""
    if isinstance(tree, dict):
        if "packed" in tree:
            return tree["packed"].numel() / 1e9
        return sum(packed_gb(v) for v in tree.values())
    return 0.0


def build_model(torch, model: str, n_layers: int | None = None):
    """The model's serving tree at full width, built layer by layer from the
    seed (at ``n_layers`` where its depth is cut); emits the init line,
    with the peak device memory of the build."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.decode import init_serving_params

    cfg = get_config(model)
    full = cfg.n_layers
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = init_serving_params(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    emit("init", arch=cfg.name, n_layers=cfg.n_layers, full_depth=full,
         d_model=cfg.d_model, enc_layers=cfg.enc_layers,
         n_experts=cfg.n_experts,
         seconds=time.perf_counter() - t0,
         packed_gb=packed_gb(served),
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.empty_cache()
    return cfg, served


def main() -> int:
    import gc

    # cuBLAS reads it when it first makes a handle: the training phase's
    # deterministic algorithms need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # a fresh autotune cache of this run's own: the prior paths run on it
    # empty, the autotuned paths on what this run measured
    cache_path = os.path.join(OUT_DIR, "autotune.json")
    if os.path.exists(cache_path):
        os.unlink(cache_path)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache_path
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import FLUSH_BYTES, get_autotune_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_line()
    print(card, flush=True)
    clock, clock_max = sm_clocks_mhz()
    emit("env", gpu=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         sm_clock_mhz=clock, sm_clock_max_mhz=clock_max)

    t0 = time.perf_counter()
    logs = _build.build_all(CUDA_SOURCES)
    usage = {name: re.findall(r"(?:Used \d+ registers|\d+ bytes spill)"
                              r"[^\n]*", log)
             for name, log in logs.items() if log}
    # ptxas reports each kernel instantiation once, with its registers (a
    # source built before this run has no log and is not counted)
    emit("build", seconds=time.perf_counter() - t0,
         instantiations={name: sum(line.startswith("Used") for line in lines)
                         for name, lines in usage.items()},
         spilling={name: sum(bool(re.search(r"\b[1-9]\d* bytes spill", line))
                             for line in lines)
                   for name, lines in usage.items()},
         ptxas=usage)

    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    cases = kernel_cases(ARCH)
    rows = check_kernels(torch, cases, flush)
    checked = set(cases)
    for c in lut_ceilings(rows):
        emit("lut_ceiling", **c)
    for name, m, act in LAYER_ROWS:
        emit("layer", kernel=name, **layer_summary(rows, name, ARCH, m, act))

    # 0. the hardware-generation side: the paper's model, and the generated
    # LUT core simulated on the card against lut_gather
    paths = hardware_phase(torch, rows, checked, flush, card)

    cfg, served = build_model(torch, ARCH)
    lengths = BATCH4_LENGTHS
    short = [3, 40, 20, 9]
    cfg8 = cfg.with_(act_dtype="int8")

    streams = {}

    def run_path(name, c, model=ARCH, **kw):
        paths[name] = serve_path(torch, served, c, model, checked=checked,
                                 roofline=name in ROOFLINE_PATHS,
                                 streams=streams.setdefault(name, []), **kw)
        emit(f"serve_{name}", gpu=card, **paths[name])
        torch.cuda.empty_cache()

    # 1. bitnet on the prior, on the empty cache
    if get_autotune_cache().entries:
        raise AssertionError("the autotune cache is not empty")
    run_path("batch4", cfg, batch=4, lengths=lengths, new_tokens=16)
    run_path("batch1", cfg, batch=1, lengths=BATCH1_LENGTHS, new_tokens=16)
    run_path("int8", cfg8, batch=4, lengths=short, new_tokens=4)
    for c in (cfg, cfg8):
        emit("cross_check", **cross_check(torch, served, c))

    # 1a. bitnet sharded: two ranks of this card at 1x2 and 2x1
    for name, rec in sharded_phase(torch, served, cfg, rows, checked, flush,
                                   card, streams["batch4"]).items():
        paths[name] = rec
        emit(f"serve_{name}", gpu=card, **rec)
    emit("layer", kernel="lut_gather", **layer_summary(
        rows, "lut_gather", SHARD_1X2, 4, "bfloat16"))

    # 1b. bitnet under arriving traffic, on the prior (before autotune)
    for name, rec in traffic_phase(
            torch, first_blocks(served, TRAFFIC_LAYERS),
            cfg.with_(n_layers=TRAFFIC_LAYERS), checked).items():
        paths[f"traffic_{name}"] = rec
        emit(f"traffic_{name}", gpu=card, **rec)
        torch.cuda.empty_cache()

    # 1c. bitnet speculative, on the prior (before autotune)
    paths.update(spec_phase(torch, served, cfg, checked, card))
    emit("verify_check", **verify_check(torch, served, cfg))
    torch.cuda.empty_cache()

    # 2. bitnet autotuned: measure, check whatever the measurements now
    # select, serve under auto
    tuned = {f"{ARCH}:{c.act_dtype}": autotune_phase(torch, served, c)
             for c in (cfg, cfg8)}
    more = sorted((selected_cases(ARCH, path_selection(ARCH, 4, "bfloat16"),
                                  "bfloat16")
                   | selected_cases(ARCH, path_selection(ARCH, 4, "int8"),
                                    "int8"))
                  - checked)
    rows += check_kernels(torch, more, flush)
    checked |= set(more)
    run_path("autotuned", cfg, batch=4, lengths=lengths, new_tokens=16)
    emit("cross_check", **cross_check(torch, served, cfg))
    run_path("autotuned_int8", cfg8, batch=4, lengths=short, new_tokens=4)
    emit("cross_check", **cross_check(torch, served, cfg8))

    # 3. bitnet pinned, one path per kernel ported after the first slice
    for name, (policy, act) in PINNED.items():
        c = (cfg8 if act == "int8" else cfg).with_(matmul_policy=policy)
        run_path(f"pinned_{name}", c, batch=4, lengths=short, new_tokens=4)
        emit("cross_check", **cross_check(torch, served, c))

    # 4. phi3.5-moe, with bitnet's tree freed first; its prior paths run
    # before its autotune (bitnet's measurements share none of its shapes)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    cases = kernel_cases(MOE_ARCH)
    rows += check_kernels(torch, cases, flush)
    checked |= set(cases)
    for name, m, act in MOE_LAYER_ROWS:
        emit("layer", kernel=name, **layer_summary(
            rows, name, MOE_ARCH, capacity(MOE_ARCH, m), act))
    cfg, served = build_model(torch, MOE_ARCH)
    cfg8 = cfg.with_(act_dtype="int8")
    run_path("moe_batch4", cfg, MOE_ARCH, batch=4, lengths=lengths,
             new_tokens=16)
    per_step = paths["moe_batch4"]["launches_per_decode_step"]
    if per_step.get("grouped_dequant") != 3 * cfg.n_layers:
        raise AssertionError(f"grouped_dequant launched {per_step} times per "
                             f"decode step, not {3 * cfg.n_layers}")
    emit("cross_check", **cross_check(torch, served, cfg))
    emit("forced_check", **forced_check(torch, served, cfg))
    emit("layer_check", **layer_check(torch, served, cfg))
    w2a8 = cfg8.with_(matmul_policy="fixed:w2a8")
    run_path("moe_int8_w2a8", w2a8, MOE_ARCH, batch=4, lengths=short,
             new_tokens=4)
    emit("cross_check", **cross_check(torch, served, w2a8))
    emit("layer_check", **layer_check(torch, served, w2a8))

    tuned[f"{MOE_ARCH}:{cfg.act_dtype}"] = autotune_phase(
        torch, served, cfg, measurements=1)
    more = sorted(selected_cases(MOE_ARCH, path_selection(
        MOE_ARCH, 4, "bfloat16"), "bfloat16") - checked)
    rows += check_kernels(torch, more, flush)
    checked |= set(more)
    run_path("moe_autotuned", cfg, MOE_ARCH, batch=4, lengths=lengths,
             new_tokens=16)
    emit("cross_check", **cross_check(torch, served, cfg,
                                      routing_may_differ=True))
    emit("forced_check", **forced_check(torch, served, cfg))
    emit("layer_check", **layer_check(torch, served, cfg))
    RECORD["autotune"] = tuned

    # 5. the recurrent families, with phi3.5's tree freed first
    del served
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(recurrent_phase(torch, rows, checked, flush, card))

    # 6. the other attention archs (dense, VLM, encoder-decoder)
    paths.update(attention_archs_phase(torch, rows, checked, flush, card))

    # 7. llama4-maverick's dense/MoE interleave at a cut depth
    paths.update(llama4_phase(torch, rows, checked, flush, card))

    # 8. training: bitnet at full width and depth, then served
    paths.update(train_phase(torch, checked, card))

    # 9. the roofline of three paths' decode steps (counted inside each
    # path, after its timed steps), then the packing ablation
    for name in ROOFLINE_PATHS:
        emit("roofline", path=name, model=paths[name]["model"], gpu=card,
             **paths[name]["roofline"])
    paths.update(ablate_phase(torch, rows, checked, flush, card))
    del flush

    kernels = []
    for name, (src, replaces, model, m, act) in SOURCES.items():
        s = layer_summary(rows, name, model, m, act)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {k: p["launches"][name]
                                 for k, p in paths.items()
                                 if p["launches"][name]},
            **s})
    RECORD["kernels"] = kernels
    RECORD["seconds"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(RECORD, fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
