#!/usr/bin/env python3
"""On-GPU smoke of deepspeed_tpu_torch: builds the CUDA kernels from the
checkout, holds each against its plain PyTorch version on the card, then
serves GPT-2 760M and trains it (random weights from the seeded host
init), serves Mixtral-8x7B's widths at 4 of its 32 layers in bf16,
Mixtral-8x7B at 16 of its 32 layers with int8 weights and an int8 KV
cache, Llama-2 7B whole in bf16 and with int8 weights and cache,
fused decode off and on, GPT-NeoX-20B whole (all 44 layers) in bf16
fused off and on and with int8 weights and cache, BLOOM-560m and GPT-Neo
2.7B (random weights drawn on the card), trains mixtral:1b-moe at full
width with the grouped MoE dispatch, runs block-sparse attention
forward and backward at GPT-2 760M's attention width and S 16384, trains
BERT-Large (MLM pretraining at bench.py's BERT arm) and Llama-2 7B,
GPT-NeoX-20B, BLOOM-560m and GPT-Neo 2.7B at full width (depth cut),
trains GPT-2 760M in fp16 on the fp16 forms of the flash kernels and
checkpoints it (async save, a fresh engine loads and resumes bit for
bit), checkpoints MoE training with the residual MoE and the noisy gate
and the bf16 byte diet the same way, and serves Mixtral's einsum
dispatch, through the port's own entry points.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --only 20,21   # the build, then phases 2-4,
                                         # 7-9, 11-36 as listed (no
                                         # kernels line)

Phases (any failed check exits non-zero before the final line):
  1. device: card name and power limit, torch/CUDA versions, kernel build
     seconds (one nvcc per source, all started together), the compiler's
     registers and spills, and the count of wgmma (HGMMA) and TMA load
     (UTMALDG) instructions in the built flash forward and backward
     (cuobjdump); each Hopper grouped-GEMM kernel instance must hold
     HGMMA, UTMALDG and UTMASTG, with 0 spill bytes and no ptxas C75xx
     (serialised wgmma) warning; every decode kernel instance's registers,
     with 0 spill bytes; each block-sparse Hopper instance (forward and
     backward) HGMMA and UTMALDG, 0 spill bytes, no C7520, its ptxas
     lines printed; the streaming expert kernels (the bf16 slot kernel's
     mma.sync HMMA and UTMALDG, its UBLKCP counted; the int8 group
     kernel's HGMMA and UTMALDG), 0 spill bytes, no C75xx warning, their
     ptxas lines printed; the decode weight stream (qgemm's stream form
     and the fused layer's four bf16-compute instances: mma.sync HMMA and
     UTMALDG; qgemm_stream and all eight fused instances 0 spill bytes),
     no C75xx warning in qgemm.cu or the fused instances;
  2. kernels at the serving path's shapes: max |kernel - plain| within the
     stated tolerance (the flash forward at every head dim, 64 / 80 / 96 /
     128: S 16, 129, 1024, segment ids, fused-QKV views, GQA rep 4 at hd
     128; two launches and batch row 0 at B 1 vs B 4 bit-identical; the
     decode kernel also at its chunk edges, cache_len 0, 1, C - 1, C,
     C + 1, S_max, and decode_identity: for every variant, cache type and
     dtype, row 0 bit-identical at B 1 vs B 8, at S_max 1024 vs 2048 and
     over two launches), then
     median times of the kernel, the plain version and the PyTorch library
     call (scaled_dot_product_attention, timed here only) beside the least
     time the card could take, and the flash forward at a Llama-2 7B
     prefill (B 1, S 1024, H 32, hd 128); the flash forward's and SDPA's
     device times (profiler) beside them here and in phases 3 and 24; the
     decode kernel's device time (profiler, exactly one kernel a call) over
     24 layers' own caches and at Mixtral-8x7B's GQA shape over 32, beside
     SDPA with the same mask and the wrapper's host ms a call;
  3. the flash backward kernels (dK/dV, dQ) against the plain backward,
     fp32 and bf16, at every head dim (64 / 80 / 96 / 128): the training
     shape, GQA, segment ids, non-causal, a ragged S and strided
     fused-QKV views, and segment ids at B 8, S 1024, causal and
     bidirectional, where both bf16 kernels must take the (batch, head)
     tile order (each bf16 case prints the order each kernel took); two
     launches and batch row 0 at B 1 vs B 4 bit-identical (dq, dk, dv);
     then, on the training main path's own
     inputs (B 12, S 1024, H 16, hd 96, bf16, q/k/v strided views of the
     fused QKV projection), the forward and both backward kernels held
     against the plain versions and timed beside them, SDPA and the
     bound (CUDA events, and the profiler's device time of each kernel
     and of SDPA's backward, here and in phase 24; SDPA's from profiler
     windows that saw every kernel of its calls);
  4. fp32 serving at full width: init_inference -> scheduler with a pool
     small enough to force a preemption; eight greedy requests must be
     token-identical to the static generate, two last-step decode logits
     within 1e-3 of a full forward with the plain attention and head, and
     the kernel launch counts must be 24 per prefill / per decode step
     and one tied fp32 head (ds_ggemm_t, through rows_matmul) each;
  5. bf16 over HTTP (the serving main path): eight concurrent requests,
     one of them sampled and repeated; prefill / decode / gather times,
     tokens/s and TTFT;
  6. fp32 training parity: 4 layers at the 760M widths, the flash kernels
     against the plain attention through initialize -> train_batch (gas
     2, WarmupLR, clipping), per-step losses within 1e-4 relative, final
     params close, and exactly 2 L forward / L dK/dV / L dQ launches per
     micro-step;
  7. bf16 training at full width (the training main path): bench.py's
     GPT-2 760M configuration (micro-batch 12, seq 1024, full remat, the
     Kahan bf16 optimizer diet), 3 warm-up and 10 timed steps: step time,
     tokens/s, MFU, peak memory, losses, launch counts, and one profiled
     step (device busy share, top kernels);
  8. the int8-serving kernels at the 760M serving shapes against their
     plain versions: the block quantizer on the four stacked block
     leaves (exact), qgemm at M 8 / 64 / 900 for the four projections,
     the int8-cache decode attention at DECODE_LENS and at its chunk edges
     (also timed at Mixtral-8x7B's GQA shape), the fused layer at
     B 8, W 1 and 4, float / int8 weights x float / int8 cache (fp32
     <= 1e-4 abs, TF32 off; bf16 <= 2e-2 of each output's max; new int8
     K/V codes within one code), each qgemm case with the form it took;
     qgemm_identity (row 0 at M 8 and 96 bit-identical to M 1, and over
     two launches; bf16 and fp32 rows) and fused_identity (row 0's
     outputs at B 8 and 96 bit-identical to B 1, and over two launches;
     bf16 int8 / float weights and caches, fp32 int8); then each timed
     over 24 layers' own weights and caches beside its plain version and
     its bound (qgemm also beside torch.matmul on the dequantized bf16
     weights; the fused layer's phase stamps with its GEMM phases' weight
     TB/s, here and in phases 17 and 20);
  9. fp32 int8 weights + int8 KV cache at full width: the scheduler (a
     pool that forces a preemption) token-identical to the static
     generate with fused decode off and on; launch counts per decode
     step: unfused 96 qgemm + 24 int8 decode, fused 24 fused layers and
     no decode or qgemm, no qgemm in prefill; teacher-forced fused and
     unfused decode logits within 1e-3;
  10. bf16 int8 over HTTP (the slice's main path): the engine load (4
     quantizer launches), then phase 5's eight requests with fused
     decode off and on: tokens/s, TTFT, TPOT, a profiled decode window,
     the params' device bytes;
  11. the grouped-GEMM kernels at Mixtral-8x7B's expert shapes (gate/in
     4096 -> 14336, out 14336 -> 4096) against their plain versions:
     ds_ggemm_slots at R 1 / 16 / 128, ds_ggemm at R 129 / 1800, random,
     all-on-one-expert and two-empty-expert routing (fp32 <= 1e-4 abs,
     bf16 <= 2e-2 of the output's max; ds_ggemm's padding tiles zero),
     each case with the source its launch took by the shape rules (the
     bf16 slot form: the streaming kernel of grouped_gemm_stream.cu);
     slot_identity: row 0 of the bf16 slot kernel bit-identical over two
     launches and at R 1 and 128 against R 16, the same expert and x; each
     timed at the main path's shapes (events and device time) beside its
     plain version, its bound and torch._grouped_mm; the flash forward and
     the float decode kernel held at H 32 / KV 8 / hd 128;
  12. fp32 Mixtral-8x7B widths at 2 layers, float and int8 KV cache: the
     scheduler (a pool that forces a preemption) token-identical to the
     static generate, and its fused arm (the fused layer over each
     layer's attention half) token-identical to it; exact launch counts
     (per decode step 3 L slot + L decode, fused 3 L slot + L fused; per
     prefill L flash + 3 L ggemm above a 64-token bucket, else 3 L
     slot; one fp32 head, ds_ggemm through rows_matmul, a prefill and a
     decode step), teacher-forced decode logits within 1e-3 of a full
     forward with the plain kernels and head;
  13. bf16 Mixtral-8x7B widths at 4 of its 32 layers over HTTP (slice
     4's main path, its depth cut for the smoke's time limit): the
     device init, phase 5's eight requests,
     tokens/s, TTFT, TPOT, decode ms per step, a profiled decode window,
     the params' device bytes and peak memory; one decode step's slot
     launches held against the plain version on the path's own rows, and
     no bf16 launch off the streaming kernel's shape rule;
  14. the int8 grouped-GEMM kernels at Mixtral-8x7B's expert shapes
     against their plain versions: ds_ggemm_slots_q at R 1 / 16 / 128,
     ds_ggemm_q at R 129 / 192 / 1800, random, one-expert and two-empty
     routing (fp32 <= 1e-4 abs, bf16 <= 2e-2 of the output's max; padding
     tiles zero), each case with the source its launch took (bf16 rows of
     both: the streaming kernels); ggemm_q_identity: row 0
     bit-identical over two launches and at R 129 and 1800 against R 192,
     and at the out projection the nb edge (20 scale groups of 205
     columns) held and bit-identical over two launches; slot_q_identity:
     the rows of ds_ggemm_slots_q at R 1, 2, 16 and 128 bit-identical to
     the same rows of ds_ggemm_q at R 129, 192 and 1800 and over two
     launches, at both projections and at the nb edge; each timed at the
     main path's shapes (R 16 at 8 sequences, R 192 at 96; events and
     device time) beside its plain version, its bound (codes and scales)
     and torch._grouped_mm on the dequantized bf16 stack (context only);
     qgemm held and timed at M 8 / 96 for N 4096 and
     1024 (bf16) and the router's N 8 (fp32 rows);
  15. fp32 int8 Mixtral-8x7B widths at 2 layers, at max_num_seqs 8 and
     96, each with a float and an int8 KV cache (a pool that forces a
     preemption), and at 8 the fused arm: exact launch counts (per decode
     step 3 L slot-q or 3 L ggemm-q, 5 L qgemm, L decode of the cache's
     kind; fused L fused, L qgemm (the router) and no decode; no int8
     grouped or qgemm launch in prefill); the scheduler token-identical
     to the static generate (int8 cache: every request not preempted,
     at 8 and 96; the rows of qgemm at M 1, 8 and 96 and of the expert
     GEMMs at R 2, 16 and 192 and the fp32 lm_head at M 1, 8 and 96
     held equal, none left changing with M; head_dot held against an
     fp64 product at every fp32 head of the smoke's models, rows 1, 8,
     96 and 912), the
     fused arm to the unfused one; on the
     float cache teacher-forced
     decode logits within 1e-3 of a full forward with the plain kernels;
     on the int8 cache every request not preempted token-identical to
     itself in a run with the prompts reordered;
  16. bf16 int8 Mixtral-8x7B at 16 of its 32 layers (cut for the time
     limit; all 32 fit the card) over HTTP (the int8 slice's
     main path): the quantizing device init (seconds, quantizer
     launches, params' device bytes), then phase 5's eight requests at
     max_num_seqs 8, unfused and fused, and 96 requests of 16-256 prompt
     tokens and 32 new tokens at max_num_seqs 96: tokens/s, TTFT, TPOT,
     decode ms per step, a profiled decode window, peak memory; at 96
     one decode step's ds_ggemm_q launches held against the plain version
     on the path's own rows, and no bf16 launch off the streaming kernels'
     shape rules;
  17. the fused layer kernel at the Llama-2 7B spec (RMSNorm, split QKV,
     rotary, SwiGLU), Mixtral-8x7B's attention half (GQA rep 4, mlp
     "none") and a small GQA + SwiGLU + biases spec with head_dim 96,
     against its plain version at B 8, W 1 and 4, float / int8 weights x
     float / int8 cache (fp32 <= 1e-4 abs, TF32 off; bf16 <= 2e-2 of
     each output's max; new int8 K/V codes within one code); then timed
     in bf16 at B 8, W 1 over 32 layers' own weights and caches beside
     its plain version and its bound (weights + cache bytes at 3.35
     TB/s; no library call computes it);
  18. fp32 Llama-2 7B widths at 4 layers (cut for time), float and int8
     weights x float and int8 cache, a pool that forces a preemption:
     the scheduler token-identical to the static generate (int8 cache:
     fused and unfused each to its own, every request not preempted),
     fused token-identical to unfused, exact launch
     counts (per decode step unfused L decode + 7 L qgemm with int8
     weights, fused L fused and no decode or qgemm; per prefill L flash
     and no qgemm), teacher-
     forced decode logits, fused and unfused, within 1e-3 of a full
     forward with the plain attention;
  19. Llama-2 7B at all 32 layers over HTTP (the slice's main path): bf16,
     and int8 weights with an int8 KV cache, each with fused decode off
     and on: the device init (seconds, quantizer launches, params'
     device bytes), phase 5's eight requests, tokens/s, TTFT, TPOT,
     decode ms per step, a profiled decode window, peak memory;
  20. the decode kernel's ALiBi variant (BLOOM-560m's shape, B 8, H 16,
     hd 64, and GQA H 32 / KV 8, hd 128) and windowed variant (GPT-Neo
     2.7B's shape, H 20, hd 128, window 256, sm_scale 1, floors from
     DECODE_LENS, the positions below them poisoned; and the GQA shape;
     both also at the chunk edges, floors C - 1, C, C + 1 and at the
     length),
     each over a float and an int8 cache, fp32 and bf16; the fused layer
     at the GPT-NeoX-20B, Pythia-160m and BLOOM-560m specs at B 8, W 1
     and 4, float / int8 weights x float / int8 cache; all against their
     plain versions (fp32 <= 1e-4 abs, TF32 off; bf16 <= 2e-2 of each
     output's max; new int8 K/V codes within one code), then timed in
     bf16 over the model's own layers (ALiBi 24, window 32, NeoX-20B 44,
     BLOOM 24) beside the plain version, the bound and SDPA with the
     same mask (float cache);
  21. fp32 GPT-NeoX-20B, BLOOM-560m and GPT-Neo 2.7B widths at 4 layers
     (GPT-Neo: 2 global, 2 local), fp32 and int8 weights x float and
     int8 KV cache, NeoX and BLOOM fused off and on, a pool that forces a
     preemption: exact launch counts per prefill and decode step (NeoX L
     flash, L decode or L fused; BLOOM no flash, L ALiBi decode or L
     fused; GPT-Neo no flash, L windowed decode; unfused int8 weights 4 L
     qgemm besides), fused token-identical to unfused, the scheduler to the
     static generate (int8 cache: every request not preempted), teacher-
     forced decode logits within 1e-3 of a plain full forward;
  22. GPT-NeoX-20B at all 44 layers over HTTP (the slice's main path):
     bf16 fused off and on, int8 weights + int8 KV cache fused on: load
     seconds, quantizer launches (176), params' device bytes, phase 5's
     eight requests, tokens/s, TTFT, TPOT, decode ms per step, a profiled
     decode window, peak memory;
  23. BLOOM-560m (bf16 fused off and on; int8 weights + int8 cache
     unfused) and GPT-Neo 2.7B (bf16; int8 weights + int8 cache) at all
     their layers over HTTP, as phase 22;
  24. the training path's grouped kernels at mixtral:1b-moe's shapes
     (gate/in K 1024, N 3584; out K 3584, N 1024): the forward ds_ggemm,
     the transposed-RHS ds_ggemm_t (dx) and ds_tgmm (dW) against their
     plain versions at R 16,384 (skewed, random, two-empty routing) and a
     ragged R 3,001 (fp32 <= 1e-4 abs, TF32 off; bf16 <= 2e-2 of each
     output's max; padding rows and empty experts zero), bf16 on the
     Hopper kernels and on layout_tile (forced), and a bf16 shape outside
     the Hopper rule (K 1020, N 3580) on layout_tile by the rule; 64 rows
     of one expert at R 64 and R 16,384 bit-identical (forward, dx), dW
     twice bit for bit; each timed in bf16 beside its plain version, its
     bound and torch._grouped_mm (events, device time), with the
     wrapper's host ms a call on both routes; the flash forward and
     backward at B 8, S 1024, H 16, KV 8, hd 64, fp32 and bf16, timed
     beside SDPA;
  25. fp32 MoE training parity: 1b-moe widths at 2 layers (cut for
     time), micro 2, gas 2, S 512, 3 steps through initialize ->
     train_batch, grouped dispatch, the kernels against the plain
     versions: losses within 1e-4 relative, each param leaf within
     PARAM_TOL of its movement, exact launches per step (per micro-step
     6 L ds_ggemm, 3 L ds_ggemm_t, 3 L ds_tgmm, 2 L flash forward, L
     dK/dV, L dQ; none of the bf16 layout_tile route), none in the plain
     run; an einsum arm ("auto" when
     training) of 2 steps: finite losses, no grouped launch;
  26. bf16 MoE training at full width (the slice's main path):
     mixtral:1b-moe (8 layers, nothing cut), grouped dispatch, seq 1024,
     micro-batch 8, full remat, bench.py's optimizer byte diet; 3 warm-up
     and 10 timed steps: step time, tokens/s, MFU, peak memory, losses,
     exact launch counts, one profiled step (busy share, top kernels, the
     grouped kernels' share);
  27. block-sparse attention (the slice's main path, nothing cut): the
     forward, dQ and dK/dV kernels against their plain versions at B 2,
     S 2048 (and two ragged S) over every layout class, a per-head layout and one with empty
     rows and columns, blocks 16 / 32 / 64 / 128, head dims 64 / 80 /
     96 / 128, causal and bidirectional, fp32 and bf16 (fp32 <= 1e-4 abs, TF32
     off; bf16 o <= 2e-2 abs, lse <= 1e-3, gradients <= 2e-2 of each
     output's max; empty rows and columns exact zeros; inf in every kv
     block a head never reads, and in q and dO of its rows with no live
     block, leaves o, lse, dq, dk and dv bit-identical; the forward
     without lse, o bit-identical); at S 8192 lists of 3 or more
     segments on both sides of the bf16 kernels' tile plan and, at S
     1040, part-filled gathered tiles; block_sparse_fwd_identity (the
     bf16 o and lse) and block_sparse_bwd_identity (dq, dk, dv), each
     bit-identical over two launches and batch row 0 at B 1 vs B 2,
     Fixed and BigBird, split lists included; the
     reference's own check, sparse_self_attention impl "pallas" against
     "dense" at S 1024, block 128, bf16 (gradient deltas <= 0.02); then
     SparseSelfAttention forward + backward at B 1, S 16384, H 16, hd 96,
     bf16, causal, for DeepSpeed's documented "fixed" layout (block 16)
     and BigBird (block 64): 10 timed iterations, exactly one launch of
     each kernel an iteration, and one iteration against the plain
     versions on the card (no launch); each kernel timed at that shape
     beside its plain version, its bound and SDPA with the layout as a
     boolean mask, the tile plans (fill per side), and the dense causal
     flash kernels for context.
  28. the flash forward and backward pair at BERT-Large's pretraining
     shape (B 32, S 512, H 16, hd 64, bf16, non-causal, q / k / v views
     of the fused QKV projection), without segment ids and with a
     padding mask (trailing pads of 1 to 256 positions) as segment ids:
     each against its plain version (o <= 2e-2 abs, lse <= 1e-3,
     gradients <= 2e-2 of each output's max; with segments the forward's
     real rows also against the plain bidirectional attention), then
     timed (CUDA events, device time) beside the plain version, SDPA (a
     boolean same-segment mask with segments) and the bound (the pairs
     the segments leave);
  29. fp32 BERT parity: BERT-Large's widths at 4 of its 24 layers (cut
     for time), padded MLM batches with token types, micro 2, gas 2, S
     512, 3 steps through initialize -> train_batch, the flash kernels
     (segment ids) against the plain attention: losses within 1e-4
     relative, each param leaf within PARAM_TOL of its movement (the key
     bias within Adam's bound), exactly 2 L forward / L dK/dV / L dQ
     launches per micro-step, none in the plain run; one micro-step's
     first flash launches against the plain versions on the path's own
     q / k / v (and the forward's real rows against the plain route);
  30. BERT-Large MLM pretraining in bf16 (the slice's main path:
     bench.py's BERT arm, 24 layers, nothing cut): S 512 x micro-batch
     32 and S 128 x 128, full remat, the byte diet, 3 warm-up and 10
     timed steps: step time, tokens/s, MFU (bench.py's 6N + 6LSD, which
     counts attention as causal), peak memory, losses, exact launch
     counts, a profiled step; at S 512 the path's first flash launches
     held against the plain versions;
  31. the families' training: fp32 parity at 2 layers of Llama-2 7B and
     GPT-NeoX-20B widths (flash against plain, as phase 29; exactly 2 L /
     L / L flash launches per micro-step) and of BLOOM-560m and GPT-Neo
     2.7B (plain attention, as in the reference: remat against no remat,
     no flash launch); then bf16 at full width, depth cut for the time
     limit (Llama-2 7B 4 of 32 layers, NeoX-20B 4 of 44, BLOOM-560m all
     24, GPT-Neo 2.7B 8 of 32), S 1024, micro-batch 4, the byte diet, 2
     warm-up and 5 timed steps: step time, tokens/s, MFU, peak memory,
     exact launch counts.
  32. the fp16 forms of the flash forward, dK/dV and dQ kernels against
     their plain versions at every head dim (the training shape, GQA,
     segment ids, non-causal, a ragged S, fused-QKV views; o <= 5e-3 abs,
     lse <= 1e-3, gradients <= 1e-2 of each output's max), two launches
     and row 0 at B 1 vs B 4 bit-identical, the range sweep (dO times
     2^0 .. 2^15 at GPT-2's head shape: the kernels and the plain
     versions overflow the same outputs at every scale, max |dS| beside
     it), then GPT-2 760M's training shape without and with segment ids
     timed (CUDA events, device time) beside the plain versions, SDPA in
     fp16 and the bound;
  33. GPT-2 760M in fp16 (the slice's main path: bench.py's shapes, 24
     layers, micro-batch 12, seq 1024, full remat, dynamic loss scale
     from 2^16, fp32 masters and moments): 3 steps, an async
     save_checkpoint, 3 more steps at once; a fresh engine (params zeros)
     load_checkpoints and takes the same 3 steps: losses, loss scales,
     skipped steps and params bit-identical; exact flash launches, all
     fp16 forms; step time, MFU, peak memory, the scale trajectory, the
     checkpoint's bytes, the save, commit and load times;
  34. mixtral:1b-moe at full width, bf16 with the byte diet, grouped
     dispatch, the residual MoE and the noisy gate ("Jitter"): the same
     round trip, bit-identical, exact grouped and flash launches;
  35. the bf16 byte-diet GPT-2 at the 760M widths, 4 of 24 layers (cut
     for time): the same round trip (synchronous save), bit-identical
     (the Kahan compensation is saved);
  36. Mixtral-8x7B widths at 2 layers, fp32, serving.moe_dispatch
     "einsum" through init_inference -> the scheduler (a pool that forces
     a preemption): greedy tokens identical to the static generate under
     the same dispatch, no expert GEMM launch (ds_ggemm: the fp32 head
     alone, one a prefill and a decode step).
Every serving phase (9, 10, 15, 16, 18, 19, 21-23) also holds qgemm's tile
form (M > 128) at no launch.
Earlier lines are JSON objects; the line before the last two is the
``kernels`` object, then the nvidia-smi line, and the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA device; exits 2
without one.
"""
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core flop/s,
# fp32 (non-tensor-core) flop/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
LAYERS = 24                 # gpt2:760m
PROMPT_LENS = [7, 64, 129, 256, 300, 511, 700, 900]
MAX_NEW = 64
DECODE_LENS = [1, 17, 255, 256, 511, 700, 1023, 1024]
TOL = {"float32": {"o": 1e-4, "lse": 1e-4},
       "bfloat16": {"o": 2e-2, "lse": 1e-3}}
# flash backward: fp32 abs (TF32 off); bf16 relative to each tensor's
# max magnitude (P and dS enter the tensor-core products in bf16)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: every kernel source of the port, built in parallel at start-up
KERNEL_SOURCES = ("decode_attention", "ds_flash_fwd", "ds_flash_bwd",
                  "quantization", "qgemm", "fused_decode", "grouped_gemm",
                  "grouped_gemm_hopper", "grouped_gemm_stream",
                  "block_sparse_attention")
# the training shape of bench.py's 760M configuration
TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_HD = 12, 1024, 16, 96


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, reps=15, inner=10, warmup=3):
    """Milliseconds per call: CUDA events around ``inner`` back-to-back
    calls (so the device queue stays full and host launch gaps drop
    out), median over ``reps`` such runs.  Inputs stay warm in L2."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def sass_counts(build, lib):
    """wgmma (HGMMA) and TMA load (UTMALDG) instructions in a built
    library's SASS, by cuobjdump from the toolkit that built it."""
    import shutil
    cob = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(cob):
        return "cuobjdump not found"
    out = subprocess.run([cob, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout.splitlines()
    return {op: sum(op in ln for ln in out) for op in ("HGMMA", "UTMALDG")}


def sass_by_function(build, lib, ops=("HGMMA", "UTMALDG", "UTMASTG")):
    """The count of each of ``ops`` in each function of a built
    library's SASS (cuobjdump), by the function's mangled name."""
    import shutil
    cob = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(cob):
        return {}
    out = subprocess.run([cob, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout.splitlines()
    funcs, cur = {}, None
    for ln in out:
        if "Function :" in ln:
            cur = ln.split("Function :", 1)[1].strip()
            funcs[cur] = dict.fromkeys(ops, 0)
        elif cur is not None:
            for op in ops:
                funcs[cur][op] += op in ln
    return funcs


def grouped_hopper_build_checks(build, libs):
    """The Hopper grouped kernels as built: every instance with wgmma
    (HGMMA) and TMA loads and stores in its SASS, and, where this process
    built the source, 0 spill bytes and no ptxas C75xx warning (wgmma
    serialised) in its report."""
    funcs = sass_by_function(build, libs["grouped_gemm_hopper"])
    hop = {n: c for n, c in funcs.items() if "ggemm_hopper" in n}
    log = build.build_log.get("grouped_gemm_hopper", {}).get("log")
    spills = c75 = None
    if log is not None:
        spills = [ln.strip() for ln in log.splitlines()
                  if any(int(n) for n in re.findall(
                      r"(\d+) bytes spill (?:stores|loads)", ln))]
        c75 = [ln.strip() for ln in log.splitlines() if "C75" in ln]
    emit({"check": "grouped_gemm_hopper_build", "sass_by_kernel": hop,
          "spill_lines": spills, "c75_warnings": c75,
          "ptxas_read": log is not None})
    check(len(hop) == 4 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                and c["UTMASTG"] > 0 for c in hop.values()),
          f"grouped_gemm_hopper: wgmma / TMA missing from SASS {hop}")
    check(log is None or (not spills and not c75),
          f"grouped_gemm_hopper: spills {spills} or serialised wgmma {c75}")


#: the block-sparse Hopper kernels' names (4 forward and 8 backward
#: instances: head dims 64 / 80 / 96 / 128, x dQ and dK/dV)
SPARSE_HOPPER = ("bsa_fwd_bf16", "bsa_bwd_bf16")


def sparse_build_checks(build, libs):
    """The block-sparse bf16 kernels (``bsa_fwd_bf16`` and
    ``bsa_bwd_bf16``, head dims 64 / 80 / 96 / 128, the backward x dQ,
    dK/dV) as built: wgmma (HGMMA) and TMA loads (UTMALDG) in each
    instance's SASS, and, where this process built the source, 0 spill
    bytes and no ptxas C7520 warning (every wgmma serialised; the C7519
    note of an injected warpgroup.arrive, which the flash kernels carry
    too, is counted), with each instance's ptxas lines (registers, spills)
    printed.  Returns the SASS counts by instance."""
    funcs = sass_by_function(build, libs["block_sparse_attention"],
                             ops=("HGMMA", "UTMALDG"))
    hop = {n: c for n, c in funcs.items()
           if any(k in n for k in SPARSE_HOPPER)}
    log = build.build_log.get("block_sparse_attention", {}).get("log")
    spills, c75, c7519, name, ptxas = [], [], 0, None, {}
    for ln in (log or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if any(k in m.group(1)
                                     for k in SPARSE_HOPPER) else None
        elif name and ("spill" in ln or "Used" in ln):
            ptxas.setdefault(name, []).append(ln.strip())
            if any(int(n) for n in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", ln)):
                spills.append(f"{name}: {ln.strip()}")
        if any(k in ln for k in SPARSE_HOPPER):
            if "C7520" in ln:
                c75.append(ln.strip())
            c7519 += "C7519" in ln
    emit({"check": "block_sparse_attention_build", "sass_by_kernel": hop,
          "ptxas_by_kernel": ptxas, "spill_lines": spills,
          "c7520_warnings": c75, "c7519_notes": c7519,
          "ptxas_read": log is not None})
    check(len(hop) == 12 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                 for c in hop.values())
          and sum("bsa_fwd_bf16" in n for n in hop) == 4,
          f"block_sparse_attention: wgmma / TMA missing from SASS {hop}")
    check(not spills and not c75,
          f"block_sparse_attention: spills {spills} or serialised wgmma "
          f"{c75}")
    return hop


#: the streaming expert kernels (csrc/grouped_gemm_stream.cu): the bf16
#: slot kernel (mma.sync) and the int8-expert group and slot kernels
#: (wgmma)
STREAM_KERNELS = ("slot_stream", "ggemm_q_stream", "slot_q_stream")


def stream_build_checks(build, libs):
    """The streaming expert kernels as built: the slot kernel's mma.sync
    (HMMA) and TMA loads (UTMALDG; its rows of x by cp.async.bulk,
    UBLKCP, counted), the int8 group and slot kernels' wgmma (HGMMA) and
    TMA loads, and,
    where this process built the source, 0 spill bytes and no ptxas C75xx
    warning (the C7519 note of an injected warpgroup.arrive counted), with
    each kernel's ptxas lines printed."""
    funcs = sass_by_function(build, libs["grouped_gemm_stream"],
                             ops=("HMMA", "HGMMA", "UTMALDG", "UBLKCP"))
    kern = {n: c for n, c in funcs.items()
            if any(k in n for k in STREAM_KERNELS)}
    log = build.build_log.get("grouped_gemm_stream", {}).get("log")
    spills, c75, c7519, name, ptxas = [], [], 0, None, {}
    for ln in (log or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if any(k in m.group(1)
                                     for k in STREAM_KERNELS) else None
        elif name and ("spill" in ln or "Used" in ln):
            ptxas.setdefault(name, []).append(ln.strip())
            if any(int(n) for n in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", ln)):
                spills.append(f"{name}: {ln.strip()}")
        if "C75" in ln:
            if "C7519" in ln:
                c7519 += 1
            else:
                c75.append(ln.strip())
    emit({"check": "grouped_gemm_stream_build", "sass_by_kernel": kern,
          "ptxas_by_kernel": ptxas, "spill_lines": spills,
          "c75_warnings": c75, "c7519_notes": c7519,
          "ptxas_read": log is not None})
    slot = [c for n, c in kern.items() if "slot_stream" in n]
    q8 = [c for n, c in kern.items() if "ggemm_q_stream" in n]
    # the int8 slot kernel's two instances (one scale group a warpgroup's
    # columns, or any groups)
    sq8 = [c for n, c in kern.items() if "slot_q_stream" in n]
    check(len(slot) == 1 and slot[0]["HMMA"] > 0 and slot[0]["UTMALDG"] > 0
          and len(q8) == 1 and len(sq8) == 2
          and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in q8 + sq8),
          f"grouped_gemm_stream: mma / wgmma / TMA missing from SASS {kern}")
    check(log is None or (not spills and not c75),
          f"grouped_gemm_stream: spills {spills} or serialised wgmma {c75}")


#: the decode weight stream's kernels (csrc/decode_stream.cuh): qgemm's
#: stream form and the fused layer's bf16-compute instances
DECODE_STREAM = ("qgemm_stream", "fused_layer_kernel")


def decode_stream_build_checks(build, libs):
    """The decode weight stream's kernels as built: qgemm's stream form and
    the four bf16-compute instances of the fused layer, each with mma.sync
    (HMMA) and TMA loads (UTMALDG) in its SASS; qgemm_stream and all eight
    fused layer instances 0 spill bytes and no ptxas C75xx warning where
    this process built them; every ptxas line of qgemm.cu and the fused
    instances printed."""
    kern = {}
    for lib in ("qgemm", "fused_decode"):
        funcs = sass_by_function(build, libs[lib], ops=("HMMA", "UTMALDG"))
        kern.update({n: c for n, c in funcs.items()
                     if any(k in n for k in DECODE_STREAM)})
    logs = {tag: r["log"] for tag, r in build.build_log.items()
            if tag == "qgemm" or tag.startswith("fused_decode_layer[")}
    spills, c75, ptxas = [], [], {}
    for tag, log in logs.items():
        name = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                name = f"{tag}:{m.group(1)}"
            elif name and ("spill" in ln or "Used" in ln):
                ptxas.setdefault(name, []).append(ln.strip())
                if any(k in name for k in DECODE_STREAM) and any(
                        int(n) for n in re.findall(
                            r"(\d+) bytes spill (?:stores|loads)", ln)):
                    spills.append(f"{name}: {ln.strip()}")
            if "C75" in ln:
                c75.append(f"{tag}: {ln.strip()}")
    emit({"check": "decode_stream_build", "sass_by_kernel": kern,
          "ptxas_by_kernel": ptxas, "spill_lines": spills,
          "c75_warnings": c75, "ptxas_read": sorted(logs)})
    stream = [c for n, c in kern.items() if "qgemm_stream" in n]
    fused = [c for n, c in kern.items()
             if "fused_layer_kernel" in n and c["HMMA"] > 0]
    check(len(stream) == 1 and stream[0]["HMMA"] > 0
          and stream[0]["UTMALDG"] > 0 and len(fused) == 4
          and all(c["UTMALDG"] > 0 for c in fused),
          f"decode stream: mma.sync / TMA missing from SASS {kern}")
    check(not spills and not c75,
          f"decode stream: spills {spills} or ptxas warnings {c75}")


def decode_build_checks(build):
    """The decode kernel as built: each instance's registers and spill
    bytes from ptxas (0 spills held), where this process built it."""
    log = build.build_log.get("decode_attention", {}).get("log")
    regs, spills, name = {}, [], None
    for ln in (log or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        elif name and "spill" in ln:
            if any(int(n) for n in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", ln)):
                spills.append(f"{name}: {ln.strip()}")
        elif name and "Used" in ln:
            mr = re.search(r"Used (\d+) registers", ln)
            if mr:
                regs[name] = int(mr.group(1))
                name = None
    emit({"check": "decode_attention_build", "ptxas_read": log is not None,
          "instances": len(regs),
          "registers": {"min": min(regs.values(), default=None),
                        "max": max(regs.values(), default=None)},
          "registers_by_instance": regs, "spill_lines": spills})
    check(not spills, f"decode_attention: spills {spills}")


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: no output"


# ----------------------------------------------------------------- kernels
def kernel_phase(torch, da, fa):
    dev = "cuda"
    g = torch.Generator(device="cpu").manual_seed(1234)

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    def unif(*shape):
        # v in [-1, 1): outputs stay below 1 in magnitude, where one bf16
        # ulp is 2^-7, so the bf16 tolerance measures the kernel and not
        # the output rounding of large values
        return torch.rand(*shape, generator=g) * 2 - 1

    errs = {"decode_attention": 0.0, "ds_flash_fwd": 0.0}
    tol_used = {"decode_attention": 0.0, "ds_flash_fwd": 0.0}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        tol = TOL[dt_name]
        for (B, H, KV, hd, S, lens) in [
                (8, 16, 16, 96, 1024, DECODE_LENS),
                (8, 32, 8, 128, 1024, DECODE_LENS)]:
            q = randn(B, H, hd).to(dev, dt)
            k = randn(B, S, KV, hd).to(dev, dt)
            v = unif(B, S, KV, hd).to(dev, dt)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            o = da.decode_attention_cuda(q, k, v, L)
            r = da.decode_attention_plain(q, k, v, L)
            torch.cuda.synchronize()
            e = float((o.float() - r.float()).abs().max())
            emit({"check": "decode_attention", "dtype": dt_name,
                  "shape": [B, H, KV, hd, S], "max_abs_err": e,
                  "tol": tol["o"]})
            check(e <= tol["o"], f"decode_attention {dt_name} "
                  f"{(B, H, KV, hd, S)}: err {e} > {tol['o']}")
            errs["decode_attention"] = max(errs["decode_attention"], e)
            tol_used["decode_attention"] = max(tol_used["decode_attention"],
                                               tol["o"])
        if dt_name == "float32":   # both dtypes, the float cache
            gd = torch.Generator(device="cuda").manual_seed(1235)
            e_edge = decode_edge_checks(torch, da, gd, "plain", False,
                                        [DECODE_SHAPES["plain"], DECODE_GQA])
            errs["decode_attention"] = max(errs["decode_attention"], e_edge)
            decode_identity_checks(torch, da)
            decode_launch_checks(torch, da)
        cases = [(1, S, 16, 16, 96, True, False, False)
                 for S in (16, 272, 1024)]
        cases.append((2, 272, 16, 4, 96, False, True, False))
        # the prefill's own layout: q/k/v strided views of one fused
        # [B, S, 3 * H * hd] projection, at the largest prompt bucket
        cases.append((1, 912, 16, 16, 96, True, False, True))
        # every head dim the kernels take: S 16, 129 and 1024 causal,
        # bidirectional with segment ids, strided fused-QKV views; GQA
        # rep 4 at hd 128 (Mixtral's 32 / 8 heads)
        for hd in fa.HEAD_DIMS:
            for case in [(1, 16, 16, 16, hd, True, False, False),
                         (1, 129, 16, 16, hd, True, False, False),
                         (1, 1024, 16, 16, hd, True, False, False),
                         (2, 129, 8, 8, hd, False, True, False),
                         (1, 1024, 16, 16, hd, True, False, True)]:
                if case not in cases:
                    cases.append(case)
        cases.append((2, 1024, 32, 8, 128, True, False, False))
        # segment ids at a size that takes the (batch, head) tile order
        # (k / v over 40 MB), bidirectional and causal
        cases += [(8, 1024, 16, 16, 96, c, True, False)
                  for c in (False, True)]
        for (B, S, H, KV, hd, causal, seg, fused) in cases:
            if fused:
                qkv = randn(B, S, 3 * H * hd)
                qkv[..., 2 * H * hd:] = unif(B, S, H * hd)
                q, k, v = (t.unflatten(-1, (H, hd)) for t in
                           qkv.to(dev, dt).split(H * hd, dim=-1))
            else:
                q = randn(B, S, H, hd).to(dev, dt)
                k = randn(B, S, KV, hd).to(dev, dt)
                v = unif(B, S, KV, hd).to(dev, dt)
            sg = None
            if seg:     # three packed segments, the first a segment-0 pad
                sg = torch.zeros(B, S, dtype=torch.int32)
                sg[:, S // 3:] = 1
                sg[:, 2 * S // 3:] = 2
                sg = sg.to(dev)
            o, lse = fa.flash_attention_fwd_cuda(q, k, v, sg, causal)
            ro, rl = fa.flash_attention_fwd_plain(q, k, v, sg, causal)
            torch.cuda.synchronize()
            eo = float((o.float() - ro.float()).abs().max())
            el = float((lse - rl).abs().max())
            order = (flash_tile_order(fa, B, S, H, KV, hd, causal)
                     if dt == torch.bfloat16 else None)
            if B == 8 and seg and order is not None:
                check(order == "by (batch, head)", f"ds_flash_fwd "
                      f"{(B, S, H, KV, hd)} took the tile order {order}")
            emit({"check": "ds_flash_fwd", "dtype": dt_name,
                  "shape": [B, S, H, KV, hd], "causal": causal,
                  "segments": seg, "fused_qkv_views": fused,
                  "tile_order": order, "max_abs_err_o": eo,
                  "max_abs_err_lse": el, "tol_o": tol["o"],
                  "tol_lse": tol["lse"]})
            check(eo <= tol["o"] and el <= tol["lse"],
                  f"ds_flash_fwd {dt_name} {(B, S, H, KV, hd)}: o err {eo}, "
                  f"lse err {el}")
            errs["ds_flash_fwd"] = max(errs["ds_flash_fwd"], eo)
            tol_used["ds_flash_fwd"] = max(tol_used["ds_flash_fwd"],
                                           tol["o"])
    flash_identity_checks(torch, fa, randn, unif)
    return errs, tol_used


def flash_tile_order(fa, B, S, H, KV, hd, causal):
    """The tile order the bf16 forward takes at this shape on this card
    (``ds_flash_fwd_tile_order``): "by level" or "by (batch, head)"."""
    import ctypes
    fn = fa.build.load("ds_flash_fwd").ds_flash_fwd_tile_order
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    r = fn(B, S, H, KV, hd, int(causal))
    check(r in (0, 1), f"ds_flash_fwd_tile_order returned {r}")
    return "by (batch, head)" if r else "by level"


def flash_identity_checks(torch, fa, randn, unif):
    """The flash forward bit for bit: two launches on the same inputs
    (determinism), and batch row 0 launched at B 1 against the same row
    at B 4 (a row's bits do not depend on the rows beside it), fp32 and
    bf16, at every head dim, causal S 1024."""
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for hd in fa.HEAD_DIMS:
            q = randn(4, 1024, 16, hd).to("cuda", dt)
            k = randn(4, 1024, 16, hd).to("cuda", dt)
            v = unif(4, 1024, 16, hd).to("cuda", dt)
            o1, l1 = fa.flash_attention_fwd_cuda(q, k, v)
            o2, l2 = fa.flash_attention_fwd_cuda(q, k, v)
            ob, lb = fa.flash_attention_fwd_cuda(q[:1], k[:1], v[:1])
            torch.cuda.synchronize()
            same = torch.equal(o1, o2) and torch.equal(l1, l2)
            row = torch.equal(o1[:1], ob) and torch.equal(l1[:1], lb)
            emit({"check": "ds_flash_fwd_identity", "dtype": dt_name,
                  "shape": [4, 1024, 16, 16, hd], "causal": True,
                  "two_launches_bit_identical": same,
                  "row_0_at_B_1_vs_B_4_bit_identical": row})
            check(same and row, f"ds_flash_fwd {dt_name} hd {hd}: two "
                  f"launches identical {same}, row 0 at B 1 vs B 4 {row}")


def kernel_times(torch, F, da, fa):
    """Times at the 760M serving shapes (bf16): decode B=8, H=KV=16,
    hd=96, S_max=1024 over DECODE_LENS, device time over 24 layers' own
    caches beside SDPA (and Mixtral-8x7B's GQA shape over 32); flash B=1,
    H=16, hd=96, S=1024 causal."""
    dev = "cuda"
    dt = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(99)
    H, hd = 16, 96
    dec = decode_layer_times(torch, F, da, H, H, hd, LAYERS)
    dec.update(work="one layer, B 8, H 16, hd 96, S_max 1024, DECODE_LENS, "
                    "bf16 (24 layers' own caches)",
               times_by_shape={"mixtral_8x7b_gqa": decode_layer_times(
                   torch, F, da, *DECODE_GQA[:3], 32)})

    def flash_at(S, B=1):
        q = torch.randn(B, S, H, hd, generator=g).to(dev, dt)
        k = torch.randn(B, S, H, hd, generator=g).to(dev, dt)
        v = torch.randn(B, S, H, hd, generator=g).to(dev, dt)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        r = {"kernel_ms": time_ms(
            lambda: fa.flash_attention_fwd_cuda(q, k, v))}
        flops = 4 * B * H * hd * S * S / 2
        bytes_ = 4 * B * S * H * hd * 2 + B * H * S * 4
        r["bound_ms"] = max(flops / BF16_FLOPS, bytes_ / HBM_BPS) * 1e3
        r["bound_by"] = ("operations" if flops / BF16_FLOPS
                         >= bytes_ / HBM_BPS else "bytes")
        return r, (q, k, v, qt, kt, vt)

    fl, (q, k, v, qt, kt, vt) = flash_at(1024)
    fl["plain_ms"] = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v))
    fl["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    per_s, per_s_dev = {}, {}
    for n in PROMPT_LENS:
        sp = -(-n // 16) * 16
        r, (qb, kb, vb, *_) = flash_at(sp)
        per_s[str(sp)] = r["kernel_ms"]
        per_s_dev[str(sp)] = device_ms(torch, [
            lambda: fa.flash_attention_fwd_cuda(qb, kb, vb)], reps=20,
            one_kernel=True)[0]
    # hd 128: a Llama-2 7B prefill, B 1, S 1024, H 32, causal
    H, hd = 32, 128
    fl128, (q2, k2, v2, qt2, kt2, vt2) = flash_at(1024)
    fl128["plain_ms"] = time_ms(lambda: fa.flash_attention_fwd_plain(
        q2, k2, v2))
    fl128["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt2, kt2, vt2, is_causal=True))
    fl.update(flash_fwd_device_ms(torch, F, fa, q, k, v))
    fl128.update(flash_fwd_device_ms(torch, F, fa, q2, k2, v2))
    for r, args in ((fl, (q, k, v)), (fl128, (q2, k2, v2))):
        r["host_ms_per_call"] = host_ms_per_call(
            torch, lambda: fa.flash_attention_fwd_cuda(*args))
    return dec, fl, per_s, fl128, per_s_dev


def host_ms_per_call(torch, fn, n=200, reps=5):
    """The host's milliseconds per call of ``fn`` (the wrapper's checks,
    allocations and launch): the host clock around ``n`` calls left
    unsynchronised, median over ``reps``.  While the device takes less
    per call than the host, its queue stays short and this is the host's
    time alone."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e3)
        torch.cuda.synchronize()
    return statistics.median(out)


def flash_fwd_device_ms(torch, F, fa, q, k, v, enable_gqa=False):
    """The flash forward's and SDPA's device time per call (profiler): a
    call's host time (``host_ms_per_call``) can exceed the kernel's, and
    then the CUDA-event times above measure the host."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return {"device_ms": device_ms(torch, [
                lambda: fa.flash_attention_fwd_cuda(q, k, v)], reps=20)[0],
            "library_device_ms": device_ms(torch, [
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=enable_gqa)],
                reps=20)[0]}


def flash_bwd_device_ms(torch, F, fa, args, enable_gqa=False):
    """The backward kernels' device time per call (profiler) and SDPA's
    backward's (``sdpa_bwd_device_ms``)."""
    return {
        "ds_flash_bwd_dkv": device_ms(torch, [
            lambda: fa.flash_attention_bwd_dkv_cuda(*args)], reps=20,
            one_kernel=True)[0],
        "ds_flash_bwd_dq": device_ms(torch, [
            lambda: fa.flash_attention_bwd_dq_cuda(*args)], reps=20,
            one_kernel=True)[0],
        **sdpa_bwd_device_ms(torch, F, *args[:4], enable_gqa=enable_gqa)}


def sdpa_bwd_device_ms(torch, F, q, k, v, do, enable_gqa=False,
                       sdpa_kw=None):
    """SDPA's backward's device time per call: the device time of its
    forward + backward less its forward's, each from profiler windows
    that saw every kernel of the call (``whole_device_ms``; None where
    none did).  CUDA events around SDPA's backward also time the host's
    autograd work between its launches.  ``sdpa_kw``: SDPA's masking
    arguments (default causal).  Returns {"library": ms,
    "library_kernels_per_call": {"fwd": n, "fwd_bwd": n}}."""
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    kw = {"is_causal": True} if sdpa_kw is None else sdpa_kw

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl,
                                              enable_gqa=enable_gqa, **kw)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (ql, kl, vl), dot)
    both, n_both = whole_device_ms(torch, sdpa_fwd_bwd)
    fwd, n_fwd = whole_device_ms(torch, sdpa)
    return {"library": None if both is None or fwd is None else both - fwd,
            "library_kernels_per_call": {"fwd": n_fwd, "fwd_bwd": n_both}}


def kernel_times_phase(torch, F, da, fa):
    """Phase 2's times, emitted; returns the decode kernel's, the flash
    forward's at S 1024 and the flash forward's by prompt bucket."""
    dec_t, fl_t, flash_by_s, fl128, dev_by_s = kernel_times(torch, F, da,
                                                            fa)
    emit({"phase": "kernel_times", "decode_attention": dec_t,
          "ds_flash_fwd_s1024": fl_t, "ds_flash_fwd_ms_by_bucket":
          flash_by_s, "ds_flash_fwd_device_ms_by_bucket": dev_by_s,
          "ds_flash_fwd_llama_prefill_hd128": fl128})
    return dec_t, fl_t, flash_by_s


# -------------------------------------------------------------- the slice
def prompts_for(lens, vocab, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def fp32_phase(torch, dt, da, fa):
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             RequestState, SamplingParams)
    t0 = time.perf_counter()
    model = gpt2_model("760m", dtype="float32")
    eng = dt.init_inference(model, {"dtype": "float32"})
    init_s = time.perf_counter() - t0
    cfg = model.config
    prompts = prompts_for(PROMPT_LENS, cfg.vocab_size)
    # 139 usable blocks of 16: the first admissions take 127, decode
    # growth then runs the pool dry and forces a preemption
    scfg = ServingConfig(num_blocks=140)
    sched = ContinuousBatchingScheduler(model, eng.params, scfg)
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    da.decode_attention.launches = 0
    fa.flash_attention_fwd.launches = 0
    gg.ds_ggemm.transpose_launches = 0
    t0 = time.perf_counter()
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in prompts]
    sched.run_until_idle()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    c = sched.metrics.counters
    # the tied fp32 head (head_dot -> rows_matmul) is ds_ggemm_t's
    launches = {"decode_attention": da.decode_attention.launches,
                "ds_flash_fwd": fa.flash_attention_fwd.launches,
                "ds_ggemm_t": gg.ds_ggemm.transpose_launches}
    emit({"phase": "fp32_serve", "init_s": init_s, "serve_s": serve_s,
          "prefills": c["prefills"], "decode_steps": c["decode_steps"],
          "preemptions": c["preemptions"], "resumed": c["resumed"],
          "launches": launches})
    check(all(r.state == RequestState.FINISHED
              and r.num_generated == MAX_NEW for r in reqs),
          "fp32: not every request finished with its full length")
    check(c["preemptions"] >= 1, "fp32: the pool did not force a preemption")
    check(launches["ds_flash_fwd"] == LAYERS * c["prefills"],
          f"fp32: flash launches {launches['ds_flash_fwd']} != "
          f"{LAYERS} x {c['prefills']} prefills")
    check(launches["decode_attention"] == LAYERS * c["decode_steps"],
          f"fp32: decode launches {launches['decode_attention']} != "
          f"{LAYERS} x {c['decode_steps']} decode steps")
    check(launches["ds_ggemm_t"] == c["prefills"] + c["decode_steps"],
          f"fp32: head launches {launches['ds_ggemm_t']} != one a prefill "
          f"and one a decode step")
    mismatched = []
    for p, r in zip(prompts, reqs):
        ref = eng.generate(p, max_new_tokens=MAX_NEW)[0, p.size:]
        if list(ref) != list(r.output_ids):
            mismatched.append(int(p.size))
    emit({"phase": "fp32_parity", "requests": len(reqs),
          "token_identical": not mismatched, "mismatched_prompts":
          mismatched})
    check(not mismatched, f"fp32: scheduler != static generate for prompt "
          f"lengths {mismatched}")
    # decode-path logits at the last step vs a full forward with the
    # plain attention (selected explicitly)
    plain = gpt2_model("760m", dtype="float32", attention_impl="plain")
    worst = 0.0
    with torch.no_grad():
        for i in (2, 6):
            toks = list(prompts[i]) + list(reqs[i].output_ids[:-1])
            n = len(prompts[i])
            ids = torch.tensor([toks], dtype=torch.int32, device="cuda")
            cache = model.init_cache_fn(1, -(-len(toks) // 64) * 64,
                                        torch.float32, "cuda")
            logits, cache = model.prefill_fn(
                eng.params, {"input_ids": ids[:, :n]}, cache)
            for pos in range(n, len(toks)):
                logits, cache = model.decode_fn(
                    eng.params, ids[:, pos],
                    cache, torch.tensor([pos], dtype=torch.int32,
                                        device="cuda"))
            with plain_head():
                full = plain.apply(eng.params, {"input_ids": ids})[:, -1]
            e = float((logits - full).abs().max())
            worst = max(worst, e)
            emit({"phase": "fp32_logits", "prompt_len": n,
                  "max_abs_err": e, "tol": 1e-3})
    check(worst <= 1e-3, f"fp32: decode logits differ from the plain "
          f"forward by {worst}")
    return eng


def post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def bf16_phase(torch, eng32, da, fa):
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving.scheduler import \
        ContinuousBatchingScheduler
    model = gpt2_model("760m", dtype="bfloat16")
    eng = InferenceEngine(model, DeepSpeedInferenceConfig(dtype="bfloat16"),
                          model_parameters=eng32.params)
    sched = ContinuousBatchingScheduler(
        model, eng.params, ServingConfig(fused_decode=False))
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=1)

    def start():       # the main path: counts set to 0 just before ...
        da.decode_attention.launches = 0
        fa.flash_attention_fwd.launches = 0

    def done():        # ... and read just after
        return {"decode_attention": da.decode_attention.launches,
                "ds_flash_fwd": fa.flash_attention_fwd.launches}
    outs, wall_s, _, launches, window = serve_http(torch, sched, prompts,
                                                   start, done)
    check(all(v > 0 for v in launches.values()),
          f"bf16: a kernel was not launched on the main path {launches}")
    busy = profile_decode(torch, sched, prompts)
    m = sched.metrics
    prefill_ms = {}
    for n, sp, s in m.prefill_s:
        prefill_ms.setdefault(str(n), []).append(s * 1e3)
    # the dense pool gather the decode step runs per step (k and v)
    pos_idx = torch.randint(0, sched.pool["k"].shape[1],
                            (sched.cfg.max_num_seqs, sched.s_pad),
                            device="cuda")
    gather_ms = time_ms(lambda: [p[:, pos_idx] for p in sched.pool.values()])
    base = serve_report(outs, wall_s, window)
    report = {"phase": "bf16_http", "requests": base["requests"],
              "decode_profile": busy,
              "wall_s": wall_s, "generated_tokens": base["generated_tokens"],
              "tokens_per_s": base["tokens_per_s"],
              "ttft_p50_ms": base["ttft_p50_ms"],
              "tpot_p50_ms": base["tpot_p50_ms"],
              "prefill_ms_by_prompt_len": prefill_ms,
              "decode_ms_per_step": base["decode_ms_per_step"],
              "decode_steps": base["decode_steps"],
              "full_batch_decode_ms_per_step":
              base["full_batch_decode_ms_per_step"],
              "gather_ms_per_step": gather_ms,
              "launches": launches,
              "sampled_repeat_identical": True}
    emit(report)
    return launches, report


#: new tokens of a profiling run: the profiled window is the scheduler's
#: first full-size decode window (8 steps) with every prompt active; the
#: tokens after it only drain the requests
PROFILE_NEW = 16


def profile_decode(torch, sched, prompts, max_new=PROFILE_NEW):
    """torch.profiler over one decode window of the bf16 scheduler with
    all of ``prompts`` active: the device's busy share of the window's
    wall time and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.serving import RequestState, SamplingParams
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    while not all(r.state == RequestState.DECODE for r in reqs):
        sched.step()
    torch.cuda.synchronize()
    steps0 = sched.metrics.counters["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = sched.metrics.counters["decode_steps"] - steps0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    # None: the profiler recorded no device time (not measured)
    busy_ms = sum(by_name.values()) / 1e3 if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    sched.run_until_idle()
    return {"window_steps": steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if busy_ms else None,
            "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}


# ------------------------------------------------------- flash backward
def attn_bound(B, S, H, KV, hd, products, causal, q_side, kv_side, rows,
               itemsize=2):
    """(bound_ms, bound_by) for attention-shaped work: ``products``
    S x S x hd matrix products per (b, h) (halved when causal) on the
    tensor cores, against ``q_side`` [B, S, H, hd] and ``kv_side``
    [B, S, KV, hd] tensors moved once plus ``rows`` fp32 [B, H, S] rows."""
    flops = products * 2.0 * S * S * hd * B * H * (0.5 if causal else 1.0)
    bytes_ = (q_side * B * S * H * hd + kv_side * B * S * KV * hd) \
        * itemsize + rows * B * H * S * 4
    t_ops, t_bytes = flops / BF16_FLOPS, bytes_ / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_inputs(torch, fa, g, B, S, H, KV, hd, dt, causal, seg, fused):
    """Seeded inputs, the forward kernel's (o, lse) and delta for one
    backward case; V and dO drawn in [-1, 1) (see kernel_phase)."""
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    def unif(*shape):
        return torch.rand(*shape, generator=g) * 2 - 1
    if fused:
        qkv = randn(B, S, 3 * H * hd)
        qkv[..., 2 * H * hd:] = unif(B, S, H * hd)
        q, k, v = (t.unflatten(-1, (H, hd)) for t in
                   qkv.to(dev, dt).split(H * hd, dim=-1))
    else:
        q = randn(B, S, H, hd).to(dev, dt)
        k = randn(B, S, KV, hd).to(dev, dt)
        v = unif(B, S, KV, hd).to(dev, dt)
    sg = None
    if seg:     # three packed segments, the first a segment-0 pad
        sg = torch.zeros(B, S, dtype=torch.int32)
        sg[:, S // 3:] = 1
        sg[:, 2 * S // 3:] = 2
        sg = sg.to(dev)
    do = unif(B, S, H, hd).to(dev, dt)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, sg, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, sg


def bwd_kernel_phase(torch, fa):
    """dK/dV and dQ kernels against the plain backward on the card, at
    every head dim the wrapper takes, fp32 and bf16; then the identity
    checks (``bwd_identity_checks``)."""
    g = torch.Generator(device="cpu").manual_seed(4321)
    H = TRAIN_H
    cases = [  # (B, S, H, KV, causal, segments, fused qkv views)
        (2, TRAIN_S, H, H, True, False, False),     # the training shape
        (2, TRAIN_S, 8, 2, True, False, False),     # GQA
        (2, 272, H, 4, True, True, False),          # segment ids
        (2, 272, H, H, False, False, False),        # non-causal
        (2, 272, H, H, True, False, False),         # ragged S
        (1, 912, H, H, True, False, True),          # strided fused views
        # segment ids at a size that takes the (batch, head) tile order,
        # causal and bidirectional
        (8, TRAIN_S, H, H, True, True, False),
        (8, TRAIN_S, H, H, False, True, False),
    ]
    errs = {"ds_flash_bwd_dkv": 0.0, "ds_flash_bwd_dq": 0.0}
    rel = {"ds_flash_bwd_dkv": 0.0, "ds_flash_bwd_dq": 0.0}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        tol = BWD_TOL[dt_name]
        for hd, (B, S, Hq, KV, causal, seg, fused) in (
                (hd, c) for hd in fa.HEAD_DIMS for c in cases):
            q, k, v, do, lse, delta, sg = bwd_inputs(
                torch, fa, g, B, S, Hq, KV, hd, dt, causal, seg, fused)
            got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta, sg,
                                              causal)
            ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, sg,
                                               causal)
            torch.cuda.synchronize()
            order = (bwd_tile_order(fa, B, S, Hq, KV, causal)
                     if dt == torch.bfloat16 else None)
            if B == 8 and seg and order is not None:
                check(order == {"dkv": "by (batch, head)",
                                "dq": "by (batch, head)"},
                      f"ds_flash_bwd {(B, S, Hq, KV, hd)} causal={causal} "
                      f"took the tile orders {order}")
            row = {"check": "ds_flash_bwd", "dtype": dt_name,
                   "shape": [B, S, Hq, KV, hd], "causal": causal,
                   "segments": seg, "fused_qkv_views": fused,
                   "tile_order": order,
                   "tol": tol, "tol_kind": ("abs" if dt_name == "float32"
                                            else "rel_to_max")}
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                e = float((a.float() - b.float()).abs().max())
                r = e / max(float(b.float().abs().max()), 1e-30)
                row[f"max_abs_err_{name}"] = e
                row[f"rel_err_{name}"] = r
                kern = "ds_flash_bwd_dq" if name == "dq" \
                    else "ds_flash_bwd_dkv"
                errs[kern] = max(errs[kern], e)
                rel[kern] = max(rel[kern], r)
                check((e if dt_name == "float32" else r) <= tol,
                      f"ds_flash_bwd {dt_name} {(B, S, Hq, KV, hd)} "
                      f"causal={causal} seg={seg} fused={fused}: {name} "
                      f"err {e} (rel {r}) > {tol}")
            emit(row)
    bwd_identity_checks(torch, fa, g)
    return errs, rel


def bwd_tile_order(fa, B, S, H, KV, causal):
    """The tile order each bf16 backward kernel takes at this shape on
    this card (``ds_flash_bwd_tile_order``): {"dkv": ..., "dq": ...},
    each "by level" or "by (batch, head)"."""
    import ctypes
    fn = fa.build.load("ds_flash_bwd").ds_flash_bwd_tile_order
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    out = {}
    for name, dkv in (("dkv", 1), ("dq", 0)):
        r = fn(B, S, H, KV, int(causal), dkv)
        check(r in (0, 1), f"ds_flash_bwd_tile_order returned {r}")
        out[name] = "by (batch, head)" if r else "by level"
    return out


def bwd_identity_checks(torch, fa, g):
    """The flash backward bit for bit, as ``flash_identity_checks`` holds
    the forward: two launches on the same inputs, and batch row 0's dq,
    dk, dv launched at B 1 against the same row at B 4, fp32 and bf16, at
    every head dim, causal S 1024."""
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for hd in fa.HEAD_DIMS:
            q, k, v, do, lse, delta, _ = bwd_inputs(
                torch, fa, g, 4, 1024, 16, 16, hd, dt, True, False, False)
            one = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta)
            two = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta)
            b1 = fa.flash_attention_bwd_cuda(q[:1], k[:1], v[:1], do[:1],
                                             lse[:1], delta[:1])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(one, two))
            row = all(torch.equal(a[:1], b) for a, b in zip(one, b1))
            emit({"check": "ds_flash_bwd_identity", "dtype": dt_name,
                  "shape": [4, 1024, 16, 16, hd], "causal": True,
                  "two_launches_bit_identical": same,
                  "row_0_at_B_1_vs_B_4_bit_identical": row})
            check(same and row, f"ds_flash_bwd {dt_name} hd {hd}: two "
                  f"launches identical {same}, row 0 at B 1 vs B 4 {row}")


def train_kernel_times(torch, F, fa):
    """The forward and both backward kernels at the training shape
    (bf16) on the inputs the training main path gives them: q/k/v
    strided views of one fused QKV projection (``_block_qkv``), dO
    contiguous.  Each kernel's outputs are held against the plain
    version's on the same inputs (TOL / BWD_TOL), then the kernels are
    timed beside the plain versions, SDPA and the bound."""
    dt = torch.bfloat16
    B, S, H, hd = TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_HD
    g = torch.Generator(device="cpu").manual_seed(77)
    q, k, v, do, lse, delta, _ = bwd_inputs(
        torch, fa, g, B, S, H, H, hd, dt, True, False, True)
    # ---- outputs against the plain version at this shape
    tol = TOL["bfloat16"]
    o, lse_k = fa.flash_attention_fwd_cuda(q, k, v)
    ro, rl = fa.flash_attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    errs = {"ds_flash_fwd": float((o.float() - ro.float()).abs().max())}
    el = float((lse_k - rl).abs().max())
    emit({"check": "ds_flash_fwd", "dtype": "bfloat16",
          "shape": [B, S, H, H, hd], "causal": True, "segments": False,
          "fused_qkv_views": True, "max_abs_err_o": errs["ds_flash_fwd"],
          "max_abs_err_lse": el, "tol_o": tol["o"], "tol_lse": tol["lse"]})
    check(errs["ds_flash_fwd"] <= tol["o"] and el <= tol["lse"],
          f"ds_flash_fwd at the training shape: o err "
          f"{errs['ds_flash_fwd']}, lse err {el}")
    del o, ro, rl, lse_k
    got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta)
    ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    rel = {}
    row = {"check": "ds_flash_bwd", "dtype": "bfloat16",
           "shape": [B, S, H, H, hd], "causal": True, "segments": False,
           "fused_qkv_views": True, "tol": BWD_TOL["bfloat16"],
           "tol_kind": "rel_to_max"}
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        e = float((a.float() - b.float()).abs().max())
        r = e / max(float(b.float().abs().max()), 1e-30)
        row[f"max_abs_err_{name}"], row[f"rel_err_{name}"] = e, r
        kern = "ds_flash_bwd_dq" if name == "dq" else "ds_flash_bwd_dkv"
        errs[kern] = max(errs.get(kern, 0.0), e)
        rel[kern] = max(rel.get(kern, 0.0), r)
        check(r <= BWD_TOL["bfloat16"], f"ds_flash_bwd at the training "
              f"shape: {name} err {e} (rel {r}) > {BWD_TOL['bfloat16']}")
    emit(row)
    del got, ref
    # ---- times on the same inputs
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out = {}
    fwd = {"kernel_ms": time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v)),
           "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(
               q, k, v), reps=5, inner=3),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True))}
    fwd["bound_ms"], fwd["bound_by"] = attn_bound(B, S, H, H, hd, 2, True,
                                                  2, 2, 1)
    fwd.update(flash_fwd_device_ms(torch, F, fa, q, k, v))
    out["ds_flash_fwd"] = fwd
    dkv = {"kernel_ms": time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        q, k, v, do, lse, delta))}
    dq = {"kernel_ms": time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, do, lse, delta))}
    dkv["bound_ms"], dkv["bound_by"] = attn_bound(B, S, H, H, hd, 4, True,
                                                  2, 4, 2)
    dq["bound_ms"], dq["bound_by"] = attn_bound(B, S, H, H, hd, 3, True,
                                                3, 2, 2)
    # the plain version and SDPA compute both backward kernels' outputs
    # at once: their times are the pair's, given on both rows
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, do, lse, delta), reps=5, inner=3)
    ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        torch.autograd.grad(o, (ql, kl, vl), dot)
    lib = time_ms(sdpa_fwd_bwd) - time_ms(
        lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True))
    dev = flash_bwd_device_ms(torch, F, fa, (q, k, v, do, lse, delta))
    for name, r in (("ds_flash_bwd_dkv", dkv), ("ds_flash_bwd_dq", dq)):
        r["plain_ms"], r["library_ms"] = plain, lib
        r["device_ms"], r["library_device_ms"] = dev[name], dev["library"]
        r["library_kernels_per_call"] = dev["library_kernels_per_call"]
        r["plain_and_library_are_for_the_pair"] = True
    out["ds_flash_bwd_dkv"], out["ds_flash_bwd_dq"] = dkv, dq
    # FlashAttention-2's five-product backward (the pair does seven)
    out["fa2_five_product_bwd_bound_ms"] = attn_bound(
        B, S, H, H, hd, 5, True, 3, 4, 2)[0]
    return out, errs, rel


# -------------------------------------------------------------- training
def train_config(micro, gas, lr, **extra):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": lr}},
           "zero_optimization": {"stage": 2},
           "steps_per_print": 0}
    cfg.update(extra)
    return cfg


def launch_counts(fa):
    return {"ds_flash_fwd": fa.flash_attention_fwd.launches,
            "ds_flash_bwd_dkv": fa.flash_attention_bwd.dkv_launches,
            "ds_flash_bwd_dq": fa.flash_attention_bwd.dq_launches}


def reset_flash(fa):
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.dkv_launches = 0
    fa.flash_attention_bwd.dq_launches = 0
    fa.flash_attention_fwd.f16_launches = 0
    fa.flash_attention_bwd.dkv_f16_launches = 0
    fa.flash_attention_bwd.dq_f16_launches = 0


def f16_launch_counts(fa):
    """The fp16 forms' launches among ``launch_counts``."""
    return {"ds_flash_fwd_f16": fa.flash_attention_fwd.f16_launches,
            "ds_flash_bwd_dkv_f16": fa.flash_attention_bwd.dkv_f16_launches,
            "ds_flash_bwd_dq_f16": fa.flash_attention_bwd.dq_f16_launches}


def fp32_train_phase(torch, dt, da, fa):
    """4 layers at the 760M widths, fp32: the flash kernels (impl
    "flash") against the plain einsum attention (impl "plain") through
    initialize -> train_batch, from the same params and batches (micro 2,
    gas 2, seq 1024, 3 steps; ``train_parity``)."""
    import numpy as np
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    L = 4
    rng = np.random.default_rng(5)
    batches = [lm_batch(np, rng, (2, 2), TRAIN_S, 50257) for _ in range(3)]
    return train_parity(
        torch, dt, fa, "gpt2", "gpt2_760m_fp32_parity",
        lambda arm: gpt2_model("custom", num_layers=L, num_heads=16,
                               d_model=1536, max_seq_len=TRAIN_S,
                               dtype="float32", remat=True,
                               attention_impl=arm),
        ("flash", "plain"), batches, 1e-4, L)


#: fp32 parity: |flash - plain| / |movement from init| per param leaf
PARAM_TOL = 5e-2


def _diff_ratio(torch, a, b, init):
    p0 = torch.as_tensor(init, device=a.device, dtype=a.dtype)
    return float((a.detach() - b.detach()).norm()
                 / max(float((b.detach() - p0).norm()), 1e-30))


def bf16_train_phase(torch, dt, da, fa):
    """The training main path: bench.py's GPT-2 760M configuration at
    full width through initialize -> train_batch (micro-batch 12, seq
    1024, full remat, the byte diet; 3 warm-up and 10 timed steps and a
    profiled one, ``bf16_train_arm``)."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    model = gpt2_model("760m", max_seq_len=TRAIN_S, dtype="bfloat16",
                       remat=True, remat_policy="nothing")
    report = bf16_train_arm(torch, dt, fa, "gpt2", "gpt2_760m_train_bf16",
                            model, TRAIN_B, TRAIN_S, 3, 10, lm_batch,
                            profile=True)
    V = model.config.vocab_size
    check(abs(report["first_loss"] - math.log(V)) <= 0.5,
          f"bf16 train: first loss {report['first_loss']} not near ln(V) = "
          f"{math.log(V)}")
    return report["launches"], report


#: the hand grouped-GEMM kernels' category of the profiled train step
GROUPED_CATEGORY = "grouped GEMM (hand kernels)"
#: device-time categories of the profiled train step, by kernel name
KERNEL_CATEGORIES = (
    (GROUPED_CATEGORY, ("ggemm_kernel", "ggemm_t_kernel", "tgmm_kernel",
                        "ggemm_hopper")),
    ("flash attention (hand kernels)", ("flash_fwd_h", "flash_bwd_h",
                                        "dkv_f32", "dq_f32",
                                        "flash_fwd_f32")),
    ("GEMM (cuBLAS / CUTLASS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("reductions (softmax, LayerNorm, norms)", ("reduce", "softmax",
                                                 "norm", "nll")),
    ("index / embedding", ("index", "scatter", "embedding")),
    ("elementwise and casts", ("elementwise", "copy", "fill")),
)


def profile_train_step(torch, eng, batch):
    """torch.profiler over one bf16 train step: the device's busy share
    of the step's wall time, device time by kernel category and the
    kernels that take the most; then one unprofiled step split by CUDA
    events into loss + gradients and the optimizer update."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    # None: the profiler recorded no device time (not measured)
    busy_ms = sum(by_name.values()) / 1e3 if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    by_cat = {}
    for n, t in by_name.items():
        cat = next((c for c, keys in KERNEL_CATEGORIES
                    if any(k in n for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + t / 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    _, grads = eng._loss_and_grads({k: v[0] for k, v in batch.items()})
    ev[1].record()
    eng._apply_grads(grads)
    ev[2].record()
    torch.cuda.synchronize()
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if busy_ms else None,
            "device_ms_by_category": by_cat,
            "split_ms": {"loss_and_grads": ev[0].elapsed_time(ev[1]),
                         "optimizer_update": ev[1].elapsed_time(ev[2])},
            "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}


# ------------------------------------------------- int8 serving (slice 3)
D760, M760, H760, HD760 = 1536, 6144, 16, 96
#: the stacked block projections of gpt2:760m: name -> (K, N)
PROJ_SHAPES = {"qkv_w": (D760, 3 * D760), "proj_w": (D760, D760),
               "mlp_in_w": (D760, M760), "mlp_out_w": (M760, D760)}
QGEMM_M = (8, 64, 900)
#: qgemm (M, K, N) off the 760M shapes
RAGGED_QGEMM = ((1, 700, 1000), (8, 700, 1000), (3, 1536, 300),
                (9, 300, 1000), (2, 1536, 4608))
#: fp32: abs (TF32 off); bf16: relative to each output's max magnitude
INT8_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FUSED_W = (1, 4)


def int8_modules():
    from deepspeed_tpu_torch.ops.kernels import fused_decode as fd
    from deepspeed_tpu_torch.ops.kernels import qgemm as qg
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    return qz, qg, fd


def err_of(torch, got, ref, dt_name):
    """(max |got - ref|, the value held to the tolerance): abs for fp32,
    relative to max |ref| for bf16."""
    e = float((got.float() - ref.float()).abs().max())
    if dt_name == "float32":
        return e, e
    return e, e / max(float(ref.float().abs().max()), 1e-30)


def device_ms(torch, fns, reps=5, one_kernel=False):
    """Device milliseconds per call over ``reps`` sweeps of ``fns`` (one
    per layer, each with its own weights, as a decode step streams
    them): the kernels' own time from torch.profiler, without the host's
    gaps between launches.  Returns (ms per call, kernels per call).
    ``one_kernel``: each call launches exactly one kernel, so ms per call
    is the mean kernel record (robust to records the profiler drops).
    CUPTI now and then hands back a window with no device record at all;
    the window is then profiled once more, and if that one is empty too
    the same sweeps are timed by CUDA events (host gaps included, kernels
    per call None) and a note goes to stderr."""
    from torch.profiler import ProfilerActivity, profile
    for f in fns:
        f()
    torch.cuda.synchronize()
    calls = reps * len(fns)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for f in fns:
                    f()
            torch.cuda.synchronize()
        ts = [e.device_time for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ts:
            per_call = sum(ts) / (len(ts) if one_kernel else calls)
            return per_call / 1e3, len(ts) / calls
    print("chip_smoke: device_ms: the profiler saw no device time twice; "
          "timed by CUDA events instead", file=sys.stderr, flush=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        for f in fns:
            f()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, None


def whole_device_ms(torch, fn, reps=10, windows=3, tries=8):
    """Device milliseconds per call of ``fn``, a call of several kernels,
    as the median over ``windows`` profiler windows that each saw every
    kernel of every call.  Each window runs ``reps`` calls as a warm-up
    step (the profiler's own records on, their events dropped) before
    the ``reps`` calls it keeps: without it, on an H100 with torch 2.11,
    every window late in a whole smoke lost one kernel record (5.9 SDPA
    kernels a call where a fresh process saw 6).  A window that still
    loses records reads low (SDPA's backward once read 0.045 ms, under
    the flash pair's bound); it shows as fewer kernels per call than the
    most any window saw, or as a fraction, and is profiled again.  Returns (ms, kernels per call), or
    (None, what the windows saw) with a note on stderr when ``tries``
    windows give fewer than ``windows`` whole ones."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):      # the warm-up step, then the kept one
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ts = [e.device_time for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append((sum(ts) / reps / 1e3, len(ts) / reps))
        most = max(k for _, k in seen)
        whole = [m for m, k in seen if k == most]
        if len(whole) >= windows and most == int(most) and most > 0:
            return statistics.median(whole), int(most)
    print(f"chip_smoke: whole_device_ms: {windows} profiler windows with "
          f"every kernel not reached in {tries}: (ms, kernels per call) "
          f"{seen}; the device time is not measured", file=sys.stderr,
          flush=True)
    return None, seen


def call_ms(fns):
    """Milliseconds per call of back-to-back calls of ``fns`` by CUDA
    events: the device time plus whatever host time the wrapper leaves
    between launches."""
    return time_ms(lambda: [f() for f in fns], reps=5, inner=2) / len(fns)


def timed(torch, kernel, plain, plain_reps=2):
    """kernel_ms and plain_ms (device time per call, see device_ms),
    call_ms of the kernel (host gaps included) and the kernels per
    call of each."""
    k_ms, k_n = device_ms(torch, kernel, one_kernel=True)
    p_ms, p_n = device_ms(torch, plain, reps=plain_reps)
    return {"kernel_ms": k_ms, "plain_ms": p_ms, "call_ms": call_ms(kernel),
            "kernels_per_call": k_n, "plain_kernels_per_call": p_n}


def bound_of(bytes_, flops, peak):
    t_b, t_o = bytes_ / HBM_BPS, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def quant_kernel_phase(torch, qz):
    """The block quantizer on the four stacked block leaves of gpt2:760m
    (bf16 values, as the engine quantizes them) and on ragged layouts:
    codes and scales exactly the plain version's; times over the leaves
    the engine quantizes at load."""
    g = torch.Generator(device="cuda").manual_seed(31)
    leaves = {n: (torch.randn(LAYERS, K, N, generator=g, device="cuda")
                  * 0.02).to(torch.bfloat16)
              for n, (K, N) in PROJ_SHAPES.items()}
    cases = [(n, w) for n, w in leaves.items()]
    for shape, dt in (((64, 1000), torch.float32), ((7, 300), torch.bfloat16),
                      ((5, 3, 512), torch.float32)):
        x = torch.randn(*shape, generator=g, device="cuda").to(dt)
        x[0, ..., :128] = 0            # an all-zero group: scale 1.0
        cases.append((f"ragged_{'x'.join(map(str, shape))}_{dt}"
                      .replace("torch.", ""), x))
    worst = 0
    for name, x in cases:
        q, s = qz.block_quantize_int8_cuda(x)
        rq, rs = qz.block_quantize_int8_plain(x)
        torch.cuda.synchronize()
        codes = int((q.int() - rq.int()).abs().max())
        sdiff = float((s - rs).abs().max())
        emit({"check": "block_quantize_int8", "case": name,
              "shape": list(x.shape), "dtype": str(x.dtype),
              "max_code_diff": codes, "max_scale_diff": sdiff, "tol": 0})
        check(codes == 0 and sdiff == 0.0,
              f"block_quantize_int8 {name}: codes differ by {codes}, "
              f"scales by {sdiff}")
        worst = max(worst, codes, sdiff)
    n = sum(w.numel() for w in leaves.values())
    t = timed(torch, [lambda w=w: qz.block_quantize_int8_cuda(w)
                      for w in leaves.values()],
              [lambda w=w: qz.block_quantize_int8_plain(w)
               for w in leaves.values()])
    # per call above; the row's work is the four leaves
    t = {k: v * 4 if k.endswith("_ms") else v for k, v in t.items()}
    t.update(work="the four stacked block leaves of gpt2:760m, bf16 "
                  "(4 launches, the engine load)", library_ms=None)
    t["bound_ms"], t["bound_by"] = bound_of(n * (2 + 1) + n // 256 * 4,
                                            n * 4, FP32_FLOPS)
    emit({"phase": "quant_kernel_times", **t})
    return leaves, float(worst), t


def qgemm_kernel_phase(torch, qz, qg, leaves):
    """qgemm against its plain version at M in QGEMM_M for the four
    projection shapes, bf16 and fp32 x; then a decode step's 96
    launches (M 8, bf16, 24 layers' own weights) timed beside the plain
    version and torch.matmul on the pre-dequantized bf16 weights."""
    g = torch.Generator(device="cuda").manual_seed(32)
    qs = {n: qz.block_quantize_int8(w) for n, w in leaves.items()}
    worst = 0.0
    for name, (K, N) in PROJ_SHAPES.items():
        q, s = qs[name]
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            for M in QGEMM_M:
                x = torch.randn(M, K, generator=g, device="cuda").to(dt)
                o = qg.qgemm_cuda(x, q[0], s[0])
                r = qg.qgemm_plain(x, q[0], s[0])
                torch.cuda.synchronize()
                e, held = err_of(torch, o, r, dt_name)
                emit({"check": "qgemm", "proj": name, "M": M, "K": K,
                      "N": N, "dtype": dt_name, "route": qg.qgemm_route(
                          M, K, N, s.shape[-1], dt), "max_abs_err": e,
                      "held": held, "tol": INT8_TOL[dt_name],
                      "tol_kind": "abs" if dt_name == "float32"
                      else "rel_to_max"})
                check(held <= INT8_TOL[dt_name], f"qgemm {name} M={M} "
                      f"{dt_name}: err {e} (held {held})")
                worst = max(worst, held)
    # ragged layouts through both paths: scale groups that split a lane's
    # 8 columns (N 1000: 4 groups of 250), N % 8 != 0 (element loads),
    # K off the 64-row chunk, 1 to 8 rows and past the decode path
    for M, K, N in RAGGED_QGEMM:
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            q, s = qz.block_quantize_int8(
                torch.randn(K, N, generator=g, device="cuda"))
            x = torch.randn(M, K, generator=g, device="cuda").to(dt)
            o = qg.qgemm_cuda(x, q, s)
            r = qg.qgemm_plain(x, q, s)
            torch.cuda.synchronize()
            e, held = err_of(torch, o, r, dt_name)
            emit({"check": "qgemm", "proj": "ragged", "M": M, "K": K,
                  "N": N, "groups": s.shape[-1], "dtype": dt_name,
                  "route": qg.qgemm_route(M, K, N, s.shape[-1], dt),
                  "max_abs_err": e, "held": held, "tol": INT8_TOL[dt_name]})
            check(held <= INT8_TOL[dt_name], f"qgemm ragged {(M, K, N)} "
                  f"{dt_name}: err {e} (held {held})")
            worst = max(worst, held)
    ident = qgemm_identity_checks(torch, qg, qs, g)
    # a decode step: 24 layers x 4 projections at M = 8, bf16
    x = {n: torch.randn(8, K, generator=g, device="cuda").to(torch.bfloat16)
         for n, (K, N) in PROJ_SHAPES.items()}
    calls = [(n, l) for l in range(LAYERS) for n in PROJ_SHAPES]
    deq = {n: qz.block_dequantize_int8(*qs[n]).to(torch.bfloat16)
           for n in PROJ_SHAPES}
    per_proj = {}
    for name, (K, N) in PROJ_SHAPES.items():
        q, s = qs[name]
        nb = s.shape[-1]
        b, f = bound_of(K * N + K * nb * 4 + 8 * K * 2 + 8 * N * 2,
                        2 * 8 * K * N, BF16_FLOPS)
        per_proj[name] = {
            "K": K, "N": N,
            "kernel_ms": device_ms(torch, [
                lambda l=l: qg.qgemm_cuda(x[name], q[l], s[l])
                for l in range(LAYERS)], one_kernel=True)[0],
            "matmul_bf16_ms": device_ms(torch, [
                lambda l=l: x[name] @ deq[name][l]
                for l in range(LAYERS)])[0],
            "bound_ms": b, "bound_by": f}
    step = timed(torch, [lambda n=n, l=l: qg.qgemm_cuda(
        x[n], qs[n][0][l], qs[n][1][l]) for n, l in calls],
        [lambda n=n, l=l: qg.qgemm_plain(x[n], qs[n][0][l], qs[n][1][l])
         for n, l in calls])
    step["matmul_bf16_ms"] = device_ms(torch, [
        lambda n=n, l=l: x[n] @ deq[n][l] for n, l in calls])[0]
    # per call above; a decode step is the 96 calls
    step = {k: v * len(calls) if k.endswith("_ms") else v
            for k, v in step.items()}
    step.update(bound_ms=LAYERS * sum(p["bound_ms"]
                                      for p in per_proj.values()),
                launches=len(calls))
    del deq
    layer = {k: v / LAYERS if k.endswith("_ms") else v
             for k, v in step.items() if k != "launches"}
    layer.update(work="one layer's four decode projections (4 launches, "
                      "M 8, bf16, each layer's own weights)",
                 bound_by="bytes", library_ms=None, identity=ident)
    emit({"phase": "qgemm_kernel_times", "per_projection": per_proj,
          "decode_step": step, "per_layer": layer})
    return worst, layer


def qgemm_identity_checks(torch, qg, qs, g):
    """qgemm_identity: row 0 of qgemm at M 8 and 96 bit-identical to the
    same row at M 1, and at M 1 over two launches, for bf16 rows (the
    decode weight stream) and fp32 rows (8-row blocks), at GPT-2 760M's
    QKV and MLP-out projections; each with the forms the M took."""
    out = {}
    for name in ("qkv_w", "mlp_out_w"):
        q, s = (t[0] for t in qs[name])
        K, N = q.shape
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            x = torch.randn(96, K, generator=g, device="cuda").to(dt)
            ref = qg.qgemm_cuda(x[:1], q, s)[0]
            row = {f"{M}_equals_1": bool(torch.equal(
                qg.qgemm_cuda(x[:M], q, s)[0], ref)) for M in (8, 96)}
            row["two_launches"] = bool(torch.equal(
                qg.qgemm_cuda(x[:1], q, s)[0], ref))
            out[f"{name}_{dt_name}"] = dict(row, routes={
                M: qg.qgemm_route(M, K, N, s.shape[-1], dt)
                for M in (1, 8, 96)})
            check(all(row.values()), f"qgemm_identity {name} {dt_name}: "
                  f"{out[f'{name}_{dt_name}']}")
    emit({"check": "qgemm_identity", **out})
    return out


def fused_identity_checks(torch, qz, da, fd, spec, g):
    """fused_identity: the fused layer's row 0 (x_out, new K/V and their
    scales) at B 8 and 96 bit-identical to the same row at B 1, and at
    B 1 over two launches: GPT-2 760M's spec at W 1 with row 0 at 1000
    cached positions (16 attention chunks merged), bf16 with int8 weights
    and cache and with bf16 weights and cache, and fp32 with int8 weights
    and cache."""
    out = {}
    for dt_name, w8, c8 in (("bfloat16", True, True),
                            ("bfloat16", False, False),
                            ("float32", True, True)):
        dt = getattr(torch, dt_name)
        cw = fused_weights(torch, g, dt, w8, qz)
        k, v, ks, vs = spec_cache(torch, g, dt, c8, da, H760, HD760, B=96)
        x = torch.randn(96, 1, D760, generator=g, device="cuda").to(dt)
        lens = torch.randint(0, 1023, (96,), generator=g, device="cuda",
                             dtype=torch.int32)
        lens[0] = 1000

        def row0(B):
            got = fd.fused_layer_cuda(
                x[:B], cw, k[:B], v[:B], lens[:B], spec,
                None if ks is None else ks[:B],
                None if vs is None else vs[:B])
            return [t[0] for t in got if t is not None]

        ref = row0(1)
        same = lambda a: all(bool(torch.equal(p, r))    # noqa: E731
                             for p, r in zip(a, ref))
        row = {f"{B}_equals_1": same(row0(B)) for B in (8, 96)}
        row["two_launches"] = same(row0(1))
        key = f"{dt_name}_{'int8' if w8 else 'float'}_weights_" \
              f"{'int8' if c8 else 'float'}_cache"
        out[key] = row
        check(all(row.values()), f"fused_identity {key}: {row}")
        del cw, k, v, ks, vs
        torch.cuda.empty_cache()
    emit({"check": "fused_identity", **out})
    return out


def decode_int8_kernel_phase(torch, F, da):
    """The int8-cache decode kernel against its plain version (fp32 and
    bf16 queries, MHA at the 760M shape and GQA, at DECODE_LENS and at
    the chunk edges), then timed at the 760M serving shape over 24
    layers' own caches and at Mixtral-8x7B's GQA shape over 32."""
    g = torch.Generator(device="cuda").manual_seed(33)
    L = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    worst = 0.0
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for (B, H, KV, hd, S) in [(8, H760, H760, HD760, 1024),
                                  (8, 32, 8, 128, 1024)]:
            q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
            kq, ks = da.quantize_kv(torch.randn(B, S, KV, hd, generator=g,
                                                device="cuda"))
            vq, vs = da.quantize_kv(torch.rand(B, S, KV, hd, generator=g,
                                               device="cuda") * 2 - 1)
            o = da.decode_attention_cuda(q, kq, vq, L, k_scale=ks,
                                         v_scale=vs)
            r = da.decode_attention_plain(q, kq, vq, L, k_scale=ks,
                                          v_scale=vs)
            torch.cuda.synchronize()
            e, held = err_of(torch, o, r, dt_name)
            emit({"check": "decode_attention_int8", "dtype": dt_name,
                  "shape": [B, H, KV, hd, S], "max_abs_err": e,
                  "held": held, "tol": INT8_TOL[dt_name]})
            check(held <= INT8_TOL[dt_name], f"decode_attention_int8 "
                  f"{dt_name} {(B, H, KV, hd, S)}: err {e} (held {held})")
            worst = max(worst, held)
    worst = max(worst, decode_edge_checks(
        torch, da, g, "plain", True, [DECODE_SHAPES["plain"], DECODE_GQA]))
    t = decode_layer_times(torch, F, da, H760, H760, HD760, LAYERS,
                           int8_cache=True)
    t.update(work="one layer, B 8, H 16, hd 96, S_max 1024, DECODE_LENS, "
                  "bf16 query (24 layers' own caches)",
             times_by_shape={"mixtral_8x7b_gqa": decode_layer_times(
                 torch, F, da, *DECODE_GQA[:3], 32, int8_cache=True)})
    emit({"phase": "decode_int8_kernel_times", **t})
    return worst, t


def fused_weights(torch, g, dt, int8_weights, qz):
    """One GPT-2 760M layer's canonical fused weights, seeded (std 0.02
    projections, LayerNorm scales near 1), int8 projections quantized
    from the compute-dtype values."""
    from deepspeed_tpu_torch.models.model import QuantizedTensor
    D, M = D760, M760

    def r(*shape, std=0.02, mean=0.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std
                + mean).to(dt)
    cw = {"n1_s": r(D, std=0.1, mean=1.0), "n1_b": r(D, std=0.1),
          "wqkv": r(D, 3 * D), "bqkv": r(3 * D), "wo": r(D, D), "bo": r(D),
          "n2_s": r(D, std=0.1, mean=1.0), "n2_b": r(D, std=0.1),
          "w_in": r(D, M), "b_in": r(M), "w_out": r(M, D), "b_out": r(D)}
    if int8_weights:
        for k in ("wqkv", "wo", "w_in", "w_out"):
            cw[k] = QuantizedTensor(*qz.block_quantize_int8(cw[k]), dt)
    return cw


#: the fused layer's GEMM phases (fd.PHASES) and their weights' keys
GEMM_PHASE_KEYS = {"qkv_gemm": ("wqkv", "wq", "wk", "wv"),
                   "out_proj_gemm": ("wo",),
                   "mlp_in_gemm": ("w_in", "w_gate", "w_up"),
                   "mlp_out_gemm": ("w_out", "w_down")}


def fused_phase_us(torch, fd, x, layers, caches, lens, spec,
                   alibi_slopes=None):
    """Microseconds of each phase of the fused kernel (its device-clock
    stamps, fd.PHASES), median over one call per layer; under
    ``gemm_tb_s`` each GEMM phase's weight bytes (codes and scales) over
    its time, in TB/s."""
    st = torch.zeros(len(fd.PHASES) + 1, dtype=torch.int64, device="cuda")
    rows = []
    for cw, c in zip(layers, caches):
        fd.fused_layer_cuda(x, cw, c[0], c[1], lens, spec, c[2], c[3],
                            alibi_slopes, stamps=st)
        t = st.tolist()
        rows.append([(b - a) / 1e3 for a, b in zip(t, t[1:])])
    us = {name: statistics.median(r[i] for r in rows)
          for i, name in enumerate(fd.PHASES)}
    cw = layers[0]
    us["gemm_tb_s"] = {
        name: sum(nbytes(cw[k]) for k in keys if k in cw)
        / (us[name] * 1e-6) / 1e12 if us[name] > 0 else None
        for name, keys in GEMM_PHASE_KEYS.items()}
    return us


def fused_check(torch, got, ref, dt_name, row):
    """Hold the fused kernel's outputs ``got`` against the plain version's
    ``ref`` (x_out, new_k, new_v, new_ks, new_vs), recording into
    ``row``: fp32 <= 1e-4 abs, bf16 <= 2e-2 of each output's max, new
    int8 K/V codes within one code, their scales within the tolerance
    relative.  Returns (ok, the worst held float error)."""
    ok, worst = True, 0.0
    B, W = got[0].shape[:2]
    # an int8 cache: row (b, j) attends the window's codes at positions
    # <= j; where one of them rounds a step apart (a last-bit difference
    # of K or V on a rounding boundary), the row attends different values,
    # and its x_out is held to the bf16-class bound instead
    flip = torch.zeros(B, W, dtype=torch.bool, device=got[0].device)
    if got[3] is not None:
        for a, b in zip(got[1:3], ref[1:3]):
            flip |= (a != b).flatten(2).any(-1)
        flip = flip.int().cummax(dim=1).values.bool()
        row["rows_with_a_code_step"] = int(flip.sum())
    for name, a, b in zip(("x_out", "new_k", "new_v", "new_ks", "new_vs"),
                          got, ref):
        if b is None:
            continue
        if b.dtype == torch.int8:
            d = int((a.int() - b.int()).abs().max())
            row[f"max_code_diff_{name}"] = d
            ok &= d <= 1
            continue
        if name == "x_out" and bool(flip.any()):
            _, hf = err_of(torch, a[flip], b[flip], "bfloat16")
            row["held_x_out_code_step_rows"] = hf
            ok &= hf <= INT8_TOL["bfloat16"]
            if bool(flip.all()):
                continue
            a, b = a[~flip], b[~flip]
        e, held = err_of(torch, a, b, dt_name)
        if name in ("new_ks", "new_vs"):
            held = float(((a - b).abs() / b.abs()).max())
            row[f"max_rel_err_{name}"] = held
            ok &= held <= INT8_TOL[dt_name]
            continue
        row[f"max_abs_err_{name}"] = e
        row[f"held_{name}"] = held
        ok &= held <= INT8_TOL[dt_name]
        worst = max(worst, held)
    return bool(ok), worst


def fused_kernel_phase(torch, qz, da, fd):
    """The fused layer kernel against its plain version (the unfused
    composition) at B 8, W 1 and 4, float / int8 weights x float / int8
    cache, fp32 and bf16; then timed in bf16 at W 1 over 24 layers' own
    weights and caches."""
    from deepspeed_tpu_torch.models.gpt2 import _fused_spec, gpt2_model
    spec = _fused_spec(gpt2_model("760m").config)
    g = torch.Generator(device="cuda").manual_seed(34)
    worst = 0.0
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for w8 in (False, True):
            cw = fused_weights(torch, g, dt, w8, qz)
            for c8 in (False, True):
                k, v, ks, vs = spec_cache(torch, g, dt, c8, da, H760, HD760)
                for W in FUSED_W:
                    lens = torch.tensor([min(n, 1024 - W)
                                         for n in DECODE_LENS],
                                        dtype=torch.int32, device="cuda")
                    x = torch.randn(8, W, D760, generator=g,
                                    device="cuda").to(dt)
                    got = fd.fused_layer_cuda(x, cw, k, v, lens, spec, ks, vs)
                    ref = fd.fused_layer_plain(x, cw, k, v, lens, spec, ks,
                                               vs)
                    row = {"check": "ds_fused_layer", "dtype": dt_name,
                           "int8_weights": w8, "int8_cache": c8, "W": W,
                           "tol": INT8_TOL[dt_name]}
                    ok, held = fused_check(torch, got, ref, dt_name, row)
                    worst = max(worst, held)
                    emit(row)
                    check(ok, f"ds_fused_layer {dt_name} w8={w8} c8={c8} "
                          f"W={W}: {row}")
            del cw
    ident = fused_identity_checks(torch, qz, da, fd, spec, g)
    # times: bf16, B 8, W 1, 24 layers' own weights and caches
    dt = torch.bfloat16
    lens = torch.tensor([min(n, 1023) for n in DECODE_LENS],
                        dtype=torch.int32, device="cuda")
    x = torch.randn(8, 1, D760, generator=g, device="cuda").to(dt)
    n_pos = int(lens.sum())
    times = {}
    for w8 in (True, False):
        layers = [fused_weights(torch, g, dt, w8, qz) for _ in range(LAYERS)]
        for c8 in (True, False):
            caches = [spec_cache(torch, g, dt, c8, da, H760, HD760)
                      for _ in range(LAYERS)]
            fns = [lambda cw=cw, c=c: fd.fused_layer_cuda(
                x, cw, c[0], c[1], lens, spec, c[2], c[3])
                for cw, c in zip(layers, caches)]
            plain = [lambda cw=cw, c=c: fd.fused_layer_plain(
                x, cw, c[0], c[1], lens, spec, c[2], c[3])
                for cw, c in zip(layers, caches)]
            wbytes = sum((v.q.numel() + v.s.numel() * 4) if hasattr(v, "q")
                         else v.numel() * v.element_size()
                         for v in layers[0].values())
            cbytes = n_pos * 2 * H760 * HD760 * (1 if c8 else 2) \
                + (n_pos * 2 * H760 * 4 if c8 else 0)
            flops = 2 * 8 * (D760 * 3 * D760 + D760 * D760
                             + 2 * D760 * M760) + 4 * (n_pos + 8) * H760 \
                * HD760
            b, f = bound_of(wbytes + cbytes + 4 * 8 * D760 * 2, flops,
                            BF16_FLOPS)
            key = f"{'int8' if w8 else 'bf16'}_weights_" \
                  f"{'int8' if c8 else 'bf16'}_cache"
            times[key] = dict(timed(torch, fns, plain),
                              bound_ms=b, bound_by=f, weight_bytes=wbytes,
                              cache_bytes=cbytes, library_ms=None,
                              phase_us=fused_phase_us(torch, fd, x, layers,
                                                      caches, lens, spec))
            del caches, fns, plain
        del layers
        torch.cuda.empty_cache()
    emit({"phase": "fused_kernel_times", "B": 8, "W": 1,
          "lens": lens.tolist(), "by_config": times})
    main_t = dict(times["int8_weights_int8_cache"],
                  work="one layer, B 8, W 1, DECODE_LENS (<= 1023), bf16, "
                       "int8 weights and cache (24 layers' own)",
                  identity=ident)
    return worst, main_t, times


def int8_kernel_phase(torch, F, da):
    """Phase 8: the four int8-serving kernels at the 760M serving shapes.
    Returns (times by kernel, max held error by kernel)."""
    qz, qg, fd = int8_modules()
    leaves, e_q, t_q = quant_kernel_phase(torch, qz)
    e_g, t_g = qgemm_kernel_phase(torch, qz, qg, leaves)
    del leaves
    torch.cuda.empty_cache()
    e_d, t_d = decode_int8_kernel_phase(torch, F, da)
    torch.cuda.empty_cache()
    e_f, t_f, _ = fused_kernel_phase(torch, qz, da, fd)
    return ({"block_quantize_int8": t_q, "qgemm": t_g,
             "decode_attention_int8": t_d, "ds_fused_layer": t_f},
            {"block_quantize_int8": e_q, "qgemm": e_g,
             "decode_attention_int8": e_d, "ds_fused_layer": e_f})


def int8_counts(da, qz, qg, fd, fa):
    return {"block_quantize_int8": qz.block_quantize_int8.launches,
            "qgemm": qg.qgemm.launches,
            "decode_attention_int8": da.decode_attention.int8_launches,
            "ds_fused_layer": fd.ds_fused_layer.launches,
            "decode_attention": da.decode_attention.launches,
            "ds_flash_fwd": fa.flash_attention_fwd.launches}


def reset_int8_counts(da, qz, qg, fd, fa):
    qz.block_quantize_int8.launches = 0
    qg.qgemm.launches = 0
    da.decode_attention.int8_launches = 0
    fd.ds_fused_layer.launches = 0
    da.decode_attention.launches = 0
    fa.flash_attention_fwd.launches = 0


def int8_parity_phase(torch, da, fa):
    """fp32, int8 weights and an int8 cache at full width: the scheduler
    (a pool that forces a preemption) is token-identical to the static
    generate with fused decode off and on, with the launch counts of
    each path; teacher-forced fused and unfused decode logits agree."""
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             RequestState, SamplingParams)
    qz, qg, fd = int8_modules()
    model = gpt2_model("760m", dtype="float32")
    eng = InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype="float32", quant={"enabled": True}, kv_cache_dtype="int8"))
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=2)
    report = {"phase": "fp32_int8_parity"}
    for fused in (False, True):
        sched = ContinuousBatchingScheduler(
            model, eng.params, ServingConfig(num_blocks=140,
                                             fused_decode=fused),
            kv_cache_dtype="int8")
        reset_int8_counts(da, qz, qg, fd, fa)
        reqs = [sched.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
                for p in prompts]
        sched.run_until_idle()
        torch.cuda.synchronize()
        n = int8_counts(da, qz, qg, fd, fa)
        c = sched.metrics.counters
        steps, prefills = c["decode_steps"], c["prefills"]
        want = {"block_quantize_int8": 0, "decode_attention": 0,
                "ds_flash_fwd": LAYERS * prefills,
                "qgemm": 0 if fused else 4 * LAYERS * steps,
                "decode_attention_int8": 0 if fused else LAYERS * steps,
                "ds_fused_layer": LAYERS * steps if fused else 0}
        mismatched = []
        for p, r in zip(prompts, reqs):
            ref = eng.generate(p, max_new_tokens=MAX_NEW,
                               fused_decode=fused)[0, p.size:]
            if list(ref) != list(r.output_ids):
                mismatched.append(int(p.size))
        key = "fused" if fused else "unfused"
        report[key] = {"prefills": prefills, "decode_steps": steps,
                       "preemptions": c["preemptions"], "launches": n,
                       "want": want, "token_identical": not mismatched,
                       "mismatched_prompts": mismatched}
        check(all(r.state == RequestState.FINISHED
                  and r.num_generated == MAX_NEW for r in reqs),
              f"fp32 int8 {key}: not every request finished")
        check(c["preemptions"] >= 1,
              f"fp32 int8 {key}: the pool did not force a preemption")
        check(n == want, f"fp32 int8 {key}: launches {n} != {want}")
        check(not mismatched, f"fp32 int8 {key}: scheduler != static "
              f"generate for prompt lengths {mismatched}")
    # teacher-forced: the same tokens through fused and unfused decode
    worst = 0.0
    with torch.no_grad():
        for i in (1, 5):
            toks = torch.tensor(
                [list(prompts[i]) + list(reqs[i].output_ids[:-1])],
                dtype=torch.int32, device="cuda")
            n0 = len(prompts[i])
            size = -(-toks.shape[1] // 64) * 64
            out = {}
            for fused in (False, True):
                cache = model.init_cache_fn(1, size, "int8", "cuda")
                _, cache = model.prefill_fn(
                    eng.params, {"input_ids": toks[:, :n0]}, cache)
                out[fused] = torch.stack([model.decode_fn(
                    eng.params, toks[:, pos], cache,
                    torch.tensor([pos], dtype=torch.int32, device="cuda"),
                    fused=fused)[0] for pos in range(n0, toks.shape[1])])
            e = float((out[True] - out[False]).abs().max())
            worst = max(worst, e)
    report.update(teacher_forced_max_abs_err=worst, tol=1e-3)
    emit(report)
    check(worst <= 1e-3, f"fp32 int8: fused and unfused decode logits "
          f"differ by {worst}")


def serve_http(torch, sched, prompts, on_start, on_done, max_new=MAX_NEW):
    """Concurrent /generate requests, one per prompt (the fourth sampled,
    then repeated), of ``max_new`` tokens each, through the HTTP server
    over ``sched``: ``on_start`` runs just before the first request,
    ``on_done`` just after they all return.  Returns (responses, wall
    seconds, /metrics text, ``on_done``'s value, the scheduler's
    decode-window entries of the concurrent run alone: not the sampled
    request's replay after it)."""
    from deepspeed_tpu_torch.serving.server import make_server
    httpd, loop = make_server(sched, port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    server.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        bodies = [{"input_ids": p.tolist(), "max_new_tokens": max_new}
                  for p in prompts]
        bodies[3].update(do_sample=True, seed=4242, temperature=0.8,
                         top_k=50, top_p=0.95)
        results = [None] * len(bodies)

        def worker(i):
            results[i] = post(base + "/generate", bodies[i])

        n0 = len(sched.metrics.decode_window_s)
        on_start()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall_s = time.perf_counter() - t0
        done = on_done()
        window = list(sched.metrics.decode_window_s)[n0:]
        check(all(r is not None and r[0] == 200 for r in results),
              f"http: not every /generate returned 200: "
              f"{[r and r[0] for r in results]}")
        outs = [r[1] for r in results]
        check(all(len(o["output_ids"]) == max_new for o in outs),
              "http: a request came back short")
        vocab = sched.model.config.vocab_size
        check(all(0 <= t < vocab for o in outs for t in o["output_ids"]),
              "http: token id out of range")
        _, again = post(base + "/generate", bodies[3])
        check(again["output_ids"] == outs[3]["output_ids"],
              "http: the sampled request did not repeat identically")
        hs, hbody = get(base + "/healthz")
        ms, mbody = get(base + "/metrics")
        check(hs == 200 and json.loads(hbody)["state"] == "ready",
              f"http: /healthz {hs} {hbody}")
        check(ms == 200 and "kernel_launches{kernel=\"decode_attention\"}"
              in mbody and "serving_generated_tokens" in mbody,
              "http: /metrics is not the expected Prometheus text")
    finally:
        httpd.shutdown()
        loop.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    return outs, wall_s, mbody, done, window


def serve_report(outs, wall_s, window):
    """End-to-end numbers of one ``serve_http`` run; decode ms per step
    over the run's decode window (``window``: (steps, batch, seconds)
    entries), and over its steps with every request active."""
    steps = sum(k for k, _, _ in window)
    full = [(k, s) for k, b, s in window if b == len(outs)]
    full_steps = sum(k for k, _ in full)
    gen = sum(len(o["output_ids"]) for o in outs)
    ttft = sorted(o["ttft_ms"] for o in outs)
    tpot = sorted((o["latency_ms"] - o["ttft_ms"]) / (len(o["output_ids"])
                                                     - 1) for o in outs)
    return {"requests": len(outs), "wall_s": wall_s,
            "generated_tokens": gen, "tokens_per_s": gen / wall_s,
            "ttft_p50_ms": statistics.median(ttft),
            "tpot_p50_ms": statistics.median(tpot),
            "decode_steps": steps,
            "decode_ms_per_step": sum(s for _, _, s in window)
            / max(steps, 1) * 1e3,
            "full_batch_decode_steps": full_steps,
            "full_batch_decode_ms_per_step": sum(s for _, s in full)
            / max(full_steps, 1) * 1e3}


def int8_http_phase(torch, da, fa):
    """The slice's main path: bf16 gpt2:760m with int8 weights and an
    int8 KV cache over HTTP, fused decode off and on.  The engine load
    (the block quantizer) and each serving run are counted from 0."""
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving.scheduler import \
        ContinuousBatchingScheduler
    qz, qg, fd = int8_modules()
    model = gpt2_model("760m", dtype="bfloat16")
    torch.cuda.synchronize()
    reset_int8_counts(da, qz, qg, fd, fa)
    t0 = time.perf_counter()
    # the seeded host init (numpy, fp32), quantized leaf by leaf
    eng = InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype="bfloat16", quant={"enabled": True}, kv_cache_dtype="int8"))
    torch.cuda.synchronize()
    load = {"load_s": time.perf_counter() - t0,
            "launches": int8_counts(da, qz, qg, fd, fa)}
    check(load["launches"]["block_quantize_int8"] == 4,
          f"int8 load: {load['launches']} (want 4 quantizer launches)")
    load["params_device_bytes"] = nbytes(eng.params)
    load["blocks_device_bytes"] = nbytes(eng.params["blocks"])
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=1)
    runs = {}
    for fused in (False, True):
        key = "fused" if fused else "unfused"
        sched = ContinuousBatchingScheduler(
            model, eng.params, ServingConfig(fused_decode=fused),
            kv_cache_dtype="int8")
        outs, wall_s, mbody, n, window = serve_http(
            torch, sched, prompts,
            on_start=lambda: reset_int8_counts(da, qz, qg, fd, fa),
            on_done=lambda: int8_counts(da, qz, qg, fd, fa))
        path = ("ds_fused_layer",) if fused else ("qgemm",
                                                  "decode_attention_int8")
        idle = ("qgemm", "decode_attention_int8") if fused \
            else ("ds_fused_layer",)
        check(all(n[k] > 0 for k in path + ("ds_flash_fwd",))
              and all(n[k] == 0 for k in idle + ("decode_attention",)),
              f"int8 http {key}: launches {n}")
        check('kernel_launches{kernel="qgemm"}' in mbody,
              "int8 http: /metrics lacks the qgemm launch count")
        runs[key] = {**serve_report(outs, wall_s, window), "launches": n,
                     "decode_profile": profile_decode(torch, sched,
                                                      prompts),
                     "outputs": [o["output_ids"][:8] for o in outs]}
        del sched
        torch.cuda.empty_cache()
    emit({"phase": "bf16_int8_http", "engine_load": load, **runs})
    return load, runs


# ------------------------------------------------ Mixtral serving (slice 4)
#: Mixtral-8x7B widths (MIXTRAL_SIZES["8x7b"]); the bf16 main path runs 4
#: of its 32 layers (all 32 in bf16 do not fit 80 GB; 4 keep the smoke
#: inside its time limit)
MIX_D, MIX_F, MIX_E, MIX_K = 4096, 14336, 8, 2
MIX_LAYERS = 4             # phase 13, cut for the time limit
MIX_PARITY_LAYERS = 2       # phases 12 and 15, cut for the time limit
#: the two expert projections: name -> (K, N)
MOE_SHAPES = {"gate_in": (MIX_D, MIX_F), "out": (MIX_F, MIX_D)}
SLOT_R = (1, 16, 128)
GROUP_R = (129, 1800)


def moe_modules():
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    return gg


def routed(torch, g, R, skew):
    """Expert ids of R routed rows: random over the 8 experts, all on one
    expert, or two experts left empty."""
    e = torch.randint(0, MIX_E, (R,), generator=g, device="cuda")
    if skew == "one_expert":
        e[:] = 5
    elif skew == "two_empty":
        e = e % (MIX_E - 2)
    return e.int()


def ggemm_io(gg, x, e, R):
    """(plan, kernel input) of one routed batch: raw rows and a slot plan
    for R <= SLOT_MAX_ROWS, else group-padded rows and a group plan."""
    if R <= gg.SLOT_MAX_ROWS:
        return gg.make_slot_plan(e, MIX_E), x
    plan = gg.make_group_plan(e, MIX_E)
    return plan, gg.scatter_to_groups(x, plan)


def ggemm_bound(torch, gg, plan, xin, R, K, N):
    """(bound_ms, bound_by) of one grouped GEMM on this batch (bf16): the
    R routed input rows read once (a padded layout's padding rows are
    zeros the function never needs to read), the weights of the experts
    that have rows read once and every output row written once (the
    padded layout's too), against 2 R K N operations on the real rows."""
    if isinstance(plan, gg.SlotPlan):
        experts = int(plan.valid.sum())
    else:
        experts = int((plan.counts > 0).sum())
    out_rows = xin.shape[0]
    return bound_of(experts * K * N * 2 + R * K * 2 + out_rows * N * 2,
                    2 * R * K * N, BF16_FLOPS)


def grouped_mm_library(torch, gg, x, w, e):
    """One PyTorch call on the same rows sorted by expert:
    ``torch._grouped_mm`` where this torch has it, else None and the
    reason (context only; the port never calls it)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch has no _grouped_mm"
    order = torch.argsort(e.long(), stable=True)
    xs = x[order].contiguous()
    counts = torch.bincount(e.long(), minlength=MIX_E)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    try:
        fn(xs, w, offs=offs)
        torch.cuda.synchronize()
        return time_ms(lambda: fn(xs, w, offs=offs), reps=5, inner=5), None
    except Exception as err:           # the library call's own limits
        return None, f"torch._grouped_mm refused: {str(err)[:160]}"


def grouped_route(gg, name, x, w, s=None):
    """The source whose kernel a launch of ``name`` on these operands
    takes, by the wrapper's shape rules (``hopper_route``,
    ``stream_route_q``)."""
    K, N = x.shape[1], w.shape[2]
    if name in ("ds_ggemm_q", "ds_ggemm_slots_q"):
        hop = gg.stream_route_q(x.dtype, (x.data_ptr(), w.data_ptr(),
                                          s.data_ptr()), K, N, s.shape[2])
    else:
        hop = gg.hopper_route(x.dtype, (x.data_ptr(), w.data_ptr()), (K, N))
    if not hop:
        return "grouped_gemm.cu"
    return "grouped_gemm_hopper.cu" if name == "ds_ggemm" \
        else "grouped_gemm_stream.cu"


def off_rule_counts(gg):
    """bf16 launches of the slot and int8 group and slot kernels that the
    shape rules sent to csrc/grouped_gemm.cu (none on the main paths)."""
    return {"ds_ggemm_slots_unaligned": gg.ds_ggemm_slots.unaligned_launches,
            "ds_ggemm_q_unaligned": gg.ds_ggemm.unaligned_int8_launches,
            "ds_ggemm_slots_q_unaligned":
            gg.ds_ggemm_slots.unaligned_int8_launches}


def slot_identity_checks(torch, gg, g, w, proj):
    """slot_identity: the bf16 slot kernel (the streaming kernel) at one
    projection's weights: row 0 (expert 3, the same x) bit-identical over
    two launches and at R 1 and 128 against R 16, over random routing."""
    K = w.shape[1]
    x = torch.randn(128, K, generator=g, device="cuda").to(torch.bfloat16)
    e = routed(torch, g, 128, "random")
    e[0] = 3

    def row0(R):
        return gg.ggemm_slots_cuda(x[:R], w, gg.make_slot_plan(e[:R],
                                                               MIX_E))[0]
    ref = row0(16)
    same = {"two_launches": torch.equal(row0(16), ref),
            "R_1_vs_16": torch.equal(row0(1), ref),
            "R_128_vs_16": torch.equal(row0(128), ref)}
    emit({"check": "slot_identity", "proj": proj, "K": K, "N": w.shape[2],
          "route": grouped_route(gg, "ds_ggemm_slots", x, w), **same})
    check(all(same.values()), f"slot_identity {proj}: {same}")
    return same


def moe_kernel_phase(torch, gg, da, fa):
    """Phase 11: ds_ggemm and ds_ggemm_slots against their plain versions
    at Mixtral's expert shapes (R 1, 16, 128 slot; 129, 1800 group;
    random, all-on-one-expert and two-empty routing; fp32 <= 1e-4 abs
    with TF32 off, bf16 <= 2e-2 of the output's max), timed beside the
    plain version, the bound and torch._grouped_mm; then the flash forward
    and the float decode kernel at H 32 / KV 8 / hd 128."""
    g = torch.Generator(device="cuda").manual_seed(41)
    worst = {"ds_ggemm": 0.0, "ds_ggemm_slots": 0.0}
    times, ident = {}, {}
    gg.ds_ggemm_slots.unaligned_launches = 0
    gg.ds_ggemm.unaligned_int8_launches = 0
    gg.ds_ggemm_slots.unaligned_int8_launches = 0
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for proj, (K, N) in MOE_SHAPES.items():
            w = (torch.randn(MIX_E, K, N, generator=g, device="cuda")
                 * 0.02).to(dt)
            for R in SLOT_R + GROUP_R:
                x = torch.randn(R, K, generator=g, device="cuda").to(dt)
                for skew in ("random", "one_expert", "two_empty"):
                    e = routed(torch, g, R, skew)
                    plan, xin = ggemm_io(gg, x, e, R)
                    slot = R <= gg.SLOT_MAX_ROWS
                    name = "ds_ggemm_slots" if slot else "ds_ggemm"
                    if slot:
                        got = gg.ggemm_slots_cuda(xin, w, plan)
                        ref = gg.ggemm_slots_plain(xin, w, plan)
                    else:
                        got = gg.ggemm_cuda(xin, w, plan)
                        ref = gg.ggemm_plain(xin, w, plan)
                    torch.cuda.synchronize()
                    e_abs, held = err_of(torch, got, ref, dt_name)
                    # padding tiles must hold zeros, as the Pallas kernel's
                    zeros = True
                    if not slot:
                        pad = torch.ones(got.shape[0], dtype=torch.bool,
                                         device="cuda")
                        pad[plan.row_to_padded.long()] = False
                        zeros = not bool(got[pad].any())
                    emit({"check": name, "dtype": dt_name, "proj": proj,
                          "R": R, "K": K, "N": N, "routing": skew,
                          "route": grouped_route(gg, name, xin, w),
                          "max_abs_err": e_abs, "held": held,
                          "tol": INT8_TOL[dt_name],
                          "padding_zeros": zeros})
                    check(held <= INT8_TOL[dt_name] and zeros,
                          f"{name} {dt_name} {proj} R {R} {skew}: err "
                          f"{held} > {INT8_TOL[dt_name]} or padding not 0")
                    worst[name] = max(worst[name], held)
            if dt_name == "bfloat16":
                ident[proj] = slot_identity_checks(torch, gg, g, w, proj)
            del w
            torch.cuda.empty_cache()
    check(not any(off_rule_counts(gg).values()),
          f"grouped kernels: main-path shapes off the shape rules "
          f"{off_rule_counts(gg)}")
    # times at the main path's shapes, bf16: a decode step's slot launch
    # (batch 8: R 16 over all 8 experts) and a 900-token prompt's
    # group-padded launch (R 1800, random routing)
    dt = torch.bfloat16
    for proj, (K, N) in MOE_SHAPES.items():
        w = (torch.randn(MIX_E, K, N, generator=g, device="cuda")
             * 0.02).to(dt)
        for R, e in ((16, torch.arange(16, device="cuda").int() % MIX_E),
                     (1800, routed(torch, g, 1800, "random"))):
            x = torch.randn(R, K, generator=g, device="cuda").to(dt)
            plan, xin = ggemm_io(gg, x, e, R)
            if R <= gg.SLOT_MAX_ROWS:
                name, kern, plain = ("ds_ggemm_slots", gg.ggemm_slots_cuda,
                                     gg.ggemm_slots_plain)
            else:
                name, kern, plain = ("ds_ggemm", gg.ggemm_cuda,
                                     gg.ggemm_plain)
            t = {"kernel_ms": time_ms(lambda: kern(xin, w, plan), reps=5,
                                      inner=5),
                 "plain_ms": time_ms(lambda: plain(xin, w, plan), reps=3,
                                     inner=2)}
            t["bound_ms"], t["bound_by"] = ggemm_bound(torch, gg, plan, xin,
                                                       R, K, N)
            t["device_ms"] = device_ms(
                torch, [lambda: kern(xin, w, plan)], reps=10,
                one_kernel=True)[0]
            t["route"] = grouped_route(gg, name, xin, w)
            t["library_ms"], why = grouped_mm_library(torch, gg, x, w, e)
            if why:
                t["library_note"] = why
            t.update(work=f"{proj} K {K} N {N}, R {R}, bf16", R=R)
            emit({"phase": "moe_kernel_times", "kernel": name, "proj": proj,
                  **t})
            times.setdefault(name, {})[proj] = t
        del w
        torch.cuda.empty_cache()
    # the ported attention kernels at Mixtral's heads (first time there)
    attn = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        tol = TOL[dt_name]
        q = torch.randn(1, 912, 32, 128, generator=g, device="cuda").to(dt)
        k = torch.randn(1, 912, 8, 128, generator=g, device="cuda").to(dt)
        v = (torch.rand(1, 912, 8, 128, generator=g, device="cuda") * 2
             - 1).to(dt)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v)
        ro, rl = fa.flash_attention_fwd_plain(q, k, v)
        qd = torch.randn(8, 32, 128, generator=g, device="cuda").to(dt)
        kd = torch.randn(8, 1024, 8, 128, generator=g, device="cuda").to(dt)
        vd = (torch.rand(8, 1024, 8, 128, generator=g, device="cuda") * 2
              - 1).to(dt)
        L = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
        od = da.decode_attention_cuda(qd, kd, vd, L)
        rd = da.decode_attention_plain(qd, kd, vd, L)
        torch.cuda.synchronize()
        errs = {"ds_flash_fwd": float((o.float() - ro.float()).abs().max()),
                "ds_flash_fwd_lse": float((lse - rl).abs().max()),
                "decode_attention": float((od.float() - rd.float()).abs()
                                          .max())}
        emit({"check": "attention_at_mixtral_heads", "dtype": dt_name,
              "H": 32, "KV": 8, "hd": 128, **errs, "tol_o": tol["o"],
              "tol_lse": tol["lse"]})
        check(errs["ds_flash_fwd"] <= tol["o"]
              and errs["ds_flash_fwd_lse"] <= tol["lse"]
              and errs["decode_attention"] <= tol["o"],
              f"attention at H 32 / KV 8 / hd 128, {dt_name}: {errs}")
        attn[dt_name] = errs
    times["slot_identity"] = ident
    return times, worst, attn


def moe_counts(gg, da, fa):
    from deepspeed_tpu_torch.ops.kernels.fused_decode import ds_fused_layer
    return {"ds_fused_layer": ds_fused_layer.launches,
            "ds_ggemm": gg.ds_ggemm.launches,
            "ds_ggemm_slots": gg.ds_ggemm_slots.launches,
            "ds_flash_fwd": fa.flash_attention_fwd.launches,
            "decode_attention": da.decode_attention.launches,
            "decode_attention_int8": da.decode_attention.int8_launches}


def reset_moe_counts(gg, da, fa):
    from deepspeed_tpu_torch.ops.kernels.fused_decode import ds_fused_layer
    ds_fused_layer.launches = 0
    gg.ds_ggemm.launches = gg.ds_ggemm_slots.launches = 0
    gg.ds_ggemm_slots.unaligned_launches = 0
    gg.ds_ggemm.unaligned_int8_launches = 0
    gg.ds_ggemm_slots.unaligned_int8_launches = 0
    fa.flash_attention_fwd.launches = 0
    da.decode_attention.launches = da.decode_attention.int8_launches = 0


class plain_head:
    """Within the block, the fp32 LM head on the card (``head_dot``)
    takes the plain product ``x @ w`` instead of ``rows_matmul``: a
    plain reference's head stays independent of the kernel under test.
    The wrapper is restored after."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
        self.gg, self.saved = gg, gg.rows_matmul
        gg.rows_matmul = lambda x, w, transpose_w=False: \
            x @ (w.T if transpose_w else w)

    def __exit__(self, *exc):
        self.gg.rows_matmul = self.saved


class plain_grouped_gemm:
    """Within the block, the MoE layer's grouped GEMMs take their plain
    versions on the card (the full-forward oracle); the wrappers and
    their counts are restored after."""

    def __init__(self, gg):
        self.gg = gg

    def __enter__(self):
        from deepspeed_tpu_torch.models.model import quantized_parts
        gg = self.gg
        self.saved = gg.ds_ggemm, gg.ds_ggemm_slots

        def plain(float_form, int8_form):
            def mm(x, w, plan, **kw):
                qs = quantized_parts(w)
                return float_form(x, w, plan) if qs is None \
                    else int8_form(x, *qs, plan)
            return mm
        gg.ds_ggemm = plain(gg.ggemm_plain, gg.ggemm_q_plain)
        gg.ds_ggemm_slots = plain(gg.ggemm_slots_plain,
                                  gg.ggemm_slots_q_plain)

    def __exit__(self, *exc):
        self.gg.ds_ggemm, self.gg.ds_ggemm_slots = self.saved


def mixtral_parity_phase(torch, gg, da, fa):
    """Phase 12: fp32 Mixtral-8x7B widths at 2 layers, float and int8 KV
    cache: the scheduler (a pool that forces a preemption) token-identical
    to the static generate; its fused arm (the fused layer over each
    layer's attention half, the experts after it) token-identical to the
    unfused scheduler on both caches; exact launch counts (per decode
    step 3 L slot + L decode, fused: 3 L slot + L fused and no decode,
    no expert ggemm; per
    prefill L flash plus 3 L ggemm for a prompt bucket above 64 tokens,
    else 3 L slot; the fp32 head, ds_ggemm through rows_matmul, once a
    prefill and once a decode step); teacher-forced decode logits within
    1e-3 of a full forward with the plain kernels and head."""
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             RequestState, SamplingParams)
    import deepspeed_tpu_torch as dt
    L = MIX_PARITY_LAYERS
    torch.cuda.synchronize()
    report = {"phase": "fp32_mixtral_parity", "layers": L,
              "memory_allocated_at_start": torch.cuda.memory_allocated()}
    t0 = time.perf_counter()
    model = mixtral_model("8x7b", num_layers=L, dtype="float32")
    eng = dt.init_inference(model, {"dtype": "float32"})
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=5)
    for kv in (None, "int8"):
        if kv:      # the same weights, an int8 cache for the generate
            eng = InferenceEngine(model, DeepSpeedInferenceConfig(
                dtype="float32", kv_cache_dtype="int8"),
                model_parameters=eng.params)
        outs = {}
        for fused in (False, True):
            sched = ContinuousBatchingScheduler(
                model, eng.params, ServingConfig(num_blocks=140,
                                                 fused_decode=fused),
                kv_cache_dtype=kv)
            reset_moe_counts(gg, da, fa)
            reqs = [sched.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
                    for p in prompts]
            sched.run_until_idle()
            torch.cuda.synchronize()
            n = moe_counts(gg, da, fa)
            c = sched.metrics.counters
            steps, prefills = c["decode_steps"], c["prefills"]
            big = sum(1 for _, sp, _ in sched.metrics.prefill_s
                      if 2 * sp > 128)
            dec = 0 if fused else L * steps
            # ds_ggemm: the experts, and the fp32 head (rows_matmul) once
            # a prefill and once a decode step
            want = {"ds_fused_layer": L * steps if fused else 0,
                    "ds_ggemm": 3 * L * big + prefills + steps,
                    "ds_ggemm_slots": 3 * L * (steps + prefills - big),
                    "ds_flash_fwd": L * prefills,
                    "decode_attention": 0 if kv else dec,
                    "decode_attention_int8": dec if kv else 0}
            outs[fused] = [list(r.output_ids) for r in reqs]
            key = ("int8_kv" if kv else "float_kv") \
                + ("_fused" if fused else "")
            report[key] = {"prefills": prefills, "long_prefills": big,
                           "decode_steps": steps,
                           "preemptions": c["preemptions"], "launches": n,
                           "want": want}
            check(all(r.state == RequestState.FINISHED
                      and r.num_generated == MAX_NEW for r in reqs),
                  f"fp32 mixtral {key}: not every request finished")
            check(c["preemptions"] >= 1,
                  f"fp32 mixtral {key}: the pool did not force a preemption")
            check(n == want, f"fp32 mixtral {key}: launches {n} != {want}")
            if fused:   # the fused arm: token-identical to the unfused one
                same = outs[True] == outs[False]
                report[key]["token_identical_to_unfused"] = same
                check(same, f"fp32 mixtral {key}: fused tokens != unfused")
            else:
                mismatched = []
                for p, r in zip(prompts, reqs):
                    ref = eng.generate(p, max_new_tokens=MAX_NEW)[0, p.size:]
                    if list(ref) != list(r.output_ids):
                        mismatched.append(int(p.size))
                report[key].update(token_identical=not mismatched,
                                   mismatched_prompts=mismatched)
                check(not mismatched, f"fp32 mixtral {key}: scheduler != "
                      f"static generate for prompt lengths {mismatched}")
            del sched
    # teacher-forced decode (float cache) against a full forward with the
    # plain attention and the plain grouped GEMMs
    plain = mixtral_model("8x7b", num_layers=L, dtype="float32",
                          attention_impl="plain")
    eng = InferenceEngine(model, DeepSpeedInferenceConfig(dtype="float32"),
                          model_parameters=eng.params)
    worst = 0.0
    with torch.no_grad():
        for i in (2, 6):
            toks = list(prompts[i]) + list(reqs[i].output_ids[:-1])
            n0 = len(prompts[i])
            ids = torch.tensor([toks], dtype=torch.int32, device="cuda")
            cache = model.init_cache_fn(1, -(-len(toks) // 64) * 64,
                                        torch.float32, "cuda")
            logits, cache = model.prefill_fn(
                eng.params, {"input_ids": ids[:, :n0]}, cache)
            for pos in range(n0, len(toks)):
                logits, cache = model.decode_fn(
                    eng.params, ids[:, pos], cache,
                    torch.tensor([pos], dtype=torch.int32, device="cuda"))
            with plain_grouped_gemm(gg), plain_head():
                full = plain.apply(eng.params, {"input_ids": ids})[:, -1]
            e = float((logits - full).abs().max())
            worst = max(worst, e)
    report.update(teacher_forced_max_abs_err=worst, tol=1e-3)
    emit(report)
    check(worst <= 1e-3, f"fp32 mixtral: decode logits differ from the "
          f"plain full forward by {worst}")


class capture_grouped:
    """Within the block, the launches through the wrappers ``names`` of
    module ``gg`` also keep their arguments and outputs in ``calls``; the
    wrappers are restored after.  The grouped wrappers (``ggemm_slots_cuda``,
    ``ggemm_q_cuda``: what the MoE layer reaches through ds_ggemm_slots
    and ds_ggemm) and the flash launchers (``flash_attention_fwd_cuda``,
    ``flash_attention_bwd_cuda``) count their own launches, so the
    counts stay where they are."""

    def __init__(self, gg, names):
        self.gg, self.names, self.calls = gg, names, []

    def __enter__(self):
        self.saved = {n: getattr(self.gg, n) for n in self.names}
        for n, f in self.saved.items():
            def kept(*args, _f=f, _n=n):
                out = _f(*args)
                self.calls.append((_n, args, out))
                return out
            setattr(self.gg, n, kept)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.gg, n, f)


def path_expert_check(torch, gg, sched, prompts, names, label):
    """One decode step of the path with every prompt active (the decode
    batch is max_num_seqs rows whatever is active): each expert GEMM that
    step launched through ``names`` held against its plain version on the
    path's own rows (bf16 <= 2e-2 of the output's max), with the route it
    took.  Runs after the path's counts were read."""
    from deepspeed_tpu_torch.serving import RequestState, SamplingParams
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=PROFILE_NEW))
            for p in prompts]
    while not all(r.state == RequestState.DECODE for r in reqs):
        check(not any(r.state == RequestState.FINISHED for r in reqs),
              f"{label}: a request finished before every prompt decoded")
        sched.step()
    torch.cuda.synchronize()
    with capture_grouped(gg, names) as cap:
        sched.step()
        torch.cuda.synchronize()
    worst, rows, routes = 0.0, set(), set()
    for name, args, out in cap.calls:
        if name == "ggemm_slots_cuda":
            x, w, plan = args
            ref = gg.ggemm_slots_plain(x, w, plan)
            rows.add(x.shape[0])
            routes.add(grouped_route(gg, "ds_ggemm_slots", x, w))
        elif name == "ggemm_slots_q_cuda":
            x, q, s, plan = args
            ref = gg.ggemm_slots_q_plain(x, q, s, plan)
            rows.add(x.shape[0])
            routes.add(grouped_route(gg, "ds_ggemm_slots_q", x, q, s))
        else:
            x, q, s, plan = args
            ref = gg.ggemm_q_plain(x, q, s, plan)
            rows.add(int(plan.counts.sum()))
            routes.add(grouped_route(gg, "ds_ggemm_q", x, q, s))
        worst = max(worst, err_of(torch, out, ref, "bfloat16")[1])
        del ref
    n = len(cap.calls)
    del cap
    sched.run_until_idle()
    torch.cuda.empty_cache()
    report = {"calls": n, "routed_rows": sorted(rows),
              "routes": sorted(routes), "max_rel_err": worst,
              "tol": INT8_TOL["bfloat16"]}
    emit({"check": f"{label}_path_expert_gemms", **report})
    check(n > 0 and worst <= INT8_TOL["bfloat16"],
          f"{label}: one decode step's expert GEMMs against their plain "
          f"versions: {report}")
    return report


def mixtral_http_phase(torch, gg, da, fa):
    """Phase 13, the slice's main path: init_inference(mixtral_model(
    "8x7b", num_layers=16), bf16) -> scheduler -> HTTP with phase 5's
    eight requests: device-init seconds, params' device bytes, tokens/s,
    TTFT, TPOT, decode ms per step, a profiled decode window, peak
    memory; the launch counts of the run."""
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving.scheduler import \
        ContinuousBatchingScheduler
    import deepspeed_tpu_torch as dt
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mixtral_model("8x7b", num_layers=MIX_LAYERS, dtype="bfloat16")
    eng = dt.init_inference(model, {"dtype": "bfloat16"})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_bytes = nbytes(eng.params)
    sched = ContinuousBatchingScheduler(model, eng.params, ServingConfig())
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=1)
    outs, wall_s, mbody, n, window = serve_http(
        torch, sched, prompts, on_start=lambda: reset_moe_counts(gg, da, fa),
        on_done=lambda: {**moe_counts(gg, da, fa), **off_rule_counts(gg)})
    check(all(n[k] > 0 for k in ("ds_ggemm", "ds_ggemm_slots",
                                 "ds_flash_fwd", "decode_attention"))
          and n["decode_attention_int8"] == 0
          and not any(off_rule_counts(gg).values()),
          f"mixtral http: launches {n}")
    check('kernel_launches{kernel="ds_ggemm_slots"}' in mbody,
          "mixtral http: /metrics lacks the grouped-GEMM launch counts")
    report = {"phase": "bf16_mixtral_http", "layers": MIX_LAYERS,
              "memory_allocated_at_start": at_start, "init_s": init_s,
              "params": model.meta["n_params"],
              "params_device_bytes": params_bytes,
              **serve_report(outs, wall_s, window), "launches": n,
              "outputs": [o["output_ids"][:8] for o in outs]}
    report["decode_profile"] = profile_decode(torch, sched, prompts)
    report["path_expert_gemms"] = path_expert_check(
        torch, gg, sched, prompts, ("ggemm_slots_cuda",), "bf16_mixtral")
    report["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(report)
    del sched, eng      # the next phase needs the card's memory back
    return report


# ------------------------------------------- int8 Mixtral serving (slice 5)
#: the int8 slice's main path: Mixtral-8x7B with int8 weights (all 32
#: layers, 47.7 GB, fit one card), bf16 compute, int8 KV cache; the
#: smoke serves 16 of them, cut for its time limit
MIX_Q_LAYERS = 16
SLOT_Q_R = (1, 16, 128)
GROUP_Q_R = (129, 192, 1800)
#: the wide-batch arm: max_num_seqs 96 (R = 192 routed rows a decode
#: step: the group-padded int8 kernel), 96 requests of 16-256 prompt
#: tokens and 32 new tokens; the pool holds every request's 18 blocks
WIDE_SEQS, WIDE_NEW, WIDE_BLOCKS_PER_SEQ = 96, 32, 18
#: qgemm at Mixtral's decode projections: (M, K, N, x dtype); N 8 is the
#: router, whose rows enter in fp32
MIX_QGEMM = ((8, MIX_D, MIX_D, "bfloat16"), (96, MIX_D, MIX_D, "bfloat16"),
             (8, MIX_D, 1024, "bfloat16"), (96, MIX_D, 1024, "bfloat16"),
             (8, MIX_D, MIX_E, "float32"), (96, MIX_D, MIX_E, "float32"))
#: the >= 3-dim block leaves the int8 engine quantizes
MIX_Q_LEAVES = (("wq",), ("wk",), ("wv",), ("wo",), ("moe", "router"),
                ("moe", "w_gate"), ("moe", "w_in"), ("moe", "w_out"))


def ggemm_q_bound(torch, gg, plan, xin, R, K, N, nb):
    """(bound_ms, bound_by) of one int8 grouped GEMM (bf16 rows): the R
    routed input rows, the codes AND scales of the experts that have rows
    read once, every output row (the padded layout's too) written once,
    against 2 R K N operations on the real rows."""
    if isinstance(plan, gg.SlotPlan):
        experts = int(plan.valid.sum())
    else:
        experts = int((plan.counts > 0).sum())
    return bound_of(experts * K * (N + nb * 4) + R * K * 2
                    + xin.shape[0] * N * 2, 2 * R * K * N, BF16_FLOPS)


#: the nb edge: Mixtral's out projection (K 14336, N 4096) with 20 scale
#: groups a row, group width 205, so the kernel's 256-column units meet
#: group edges inside them
Q_EDGE_NB = 20


def ggemm_q_identity_checks(torch, gg, g, q, s, proj):
    """ggemm_q_identity: the int8 group kernel (bf16 rows, the streaming
    kernel) at one projection's codes: row 0 (expert 5, the same x)
    bit-identical over two launches and at R 129 and 1800 against R 192,
    over random routing; at the out projection also the nb edge (scale
    groups of 205 columns: group edges inside a unit) against the plain
    version, two launches bit-identical."""
    K = q.shape[1]
    x = torch.randn(1800, K, generator=g, device="cuda").to(torch.bfloat16)
    e = routed(torch, g, 1800, "random")
    e[0] = 5

    def run(R, q_, s_):
        plan = gg.make_group_plan(e[:R], MIX_E)
        xin = gg.scatter_to_groups(x[:R], plan)
        return gg.ggemm_q_cuda(xin, q_, s_, plan), plan, xin

    def row0(R):
        out, plan, _ = run(R, q, s)
        return out[int(plan.row_to_padded[0])]
    ref = row0(192)
    out = {"two_launches": torch.equal(row0(192), ref),
           "R_129_vs_192": torch.equal(row0(129), ref),
           "R_1800_vs_192": torch.equal(row0(1800), ref)}
    rep = {"check": "ggemm_q_identity", "proj": proj, "K": K,
           "N": q.shape[2], "nb": s.shape[2]}
    if proj == "out":
        # codes and scales drawn directly: the quantizer's groups are 256
        qe = torch.randint(-127, 128, q.shape, generator=g, device="cuda",
                           dtype=torch.int64).to(torch.int8)
        se = torch.rand(q.shape[0], K, Q_EDGE_NB, generator=g,
                        device="cuda") * 4e-4 + 1e-4
        got, plan, xin = run(192, qe, se)
        again = run(192, qe, se)[0]
        _, held = err_of(torch, got, gg.ggemm_q_plain(xin, qe, se, plan),
                         "bfloat16")
        out["nb_edge_two_launches"] = torch.equal(got, again)
        out["nb_edge_within_tol"] = held <= INT8_TOL["bfloat16"]
        rep.update(nb_edge={"nb": Q_EDGE_NB, "qblock": -(-q.shape[2]
                                                         // Q_EDGE_NB),
                            "held": held, "tol": INT8_TOL["bfloat16"],
                            "route": grouped_route(gg, "ds_ggemm_q", xin,
                                                   qe, se)})
        del qe, se, got, again
    rep.update(route=grouped_route(gg, "ds_ggemm_q", x, q, s), **out)
    emit(rep)
    check(all(out.values()), f"ggemm_q_identity {proj}: {rep}")
    return rep


def slot_q_identity_checks(torch, gg, g, q, s, proj):
    """slot_q_identity: the int8 slot kernel against the int8 group kernel
    (bf16 rows, both streaming kernels) at one projection's codes: over
    random routing of 1800 rows, the rows of ds_ggemm_slots_q at R 1, 2,
    16 and 128 bit-identical to the same rows (the same x, the same
    experts) of ds_ggemm_q at R 129, 192 and 1800, and the slot form's R 16
    bit-identical over two launches; at the out projection also at the nb
    edge (scale groups of 205 columns: group edges inside a unit), slot R
    16 and 128 against group R 192."""
    K = q.shape[1]
    x = torch.randn(1800, K, generator=g, device="cuda").to(torch.bfloat16)
    e = routed(torch, g, 1800, "random")

    def slot(R, q_, s_):
        return gg.ggemm_slots_q_cuda(x[:R], q_, s_,
                                     gg.make_slot_plan(e[:R], MIX_E))

    def group(R, q_, s_):
        plan = gg.make_group_plan(e[:R], MIX_E)
        return gg.gather_from_groups(gg.ggemm_q_cuda(
            gg.scatter_to_groups(x[:R], plan), q_, s_, plan), plan)
    slots = {R: slot(R, q, s) for R in (1, 2, 16, 128)}
    out = {"slot_16_two_launches": torch.equal(slot(16, q, s), slots[16])}
    for Rg in (129, 192, 1800):
        got = group(Rg, q, s)
        for R, rows in slots.items():
            out[f"slot_{R}_vs_group_{Rg}"] = torch.equal(rows, got[:R])
        del got
    rep = {"check": "slot_q_identity", "proj": proj, "K": K,
           "N": q.shape[2], "nb": s.shape[2],
           "route": grouped_route(gg, "ds_ggemm_slots_q", x, q, s),
           "group_route": grouped_route(gg, "ds_ggemm_q", x, q, s)}
    if proj == "out":
        qe = torch.randint(-127, 128, q.shape, generator=g, device="cuda",
                           dtype=torch.int64).to(torch.int8)
        se = torch.rand(q.shape[0], K, Q_EDGE_NB, generator=g,
                        device="cuda") * 4e-4 + 1e-4
        got = group(192, qe, se)
        for R in (16, 128):
            out[f"nb_edge_slot_{R}_vs_group_192"] = torch.equal(
                slot(R, qe, se), got[:R])
        out["nb_edge_slot_16_two_launches"] = torch.equal(
            slot(16, qe, se), slot(16, qe, se))
        rep["nb_edge"] = {"nb": Q_EDGE_NB,
                          "route": grouped_route(gg, "ds_ggemm_slots_q", x,
                                                 qe, se)}
        del qe, se, got
    rep.update(out)
    emit(rep)
    check(all(out.values()), f"slot_q_identity {proj}: {rep}")
    return rep


def moe_int8_kernel_phase(torch, gg, qz, qg):
    """Phase 14: ds_ggemm_slots_q (R 1, 16, 128) and ds_ggemm_q (R 129,
    192, 1800) against their plain versions at Mixtral's expert shapes,
    random, all-on-one-expert and two-empty routing (fp32 <= 1e-4 abs,
    bf16 <= 2e-2 of the output's max; padding tiles zero); bf16 rows of
    both bit-identical to each other (slot_q_identity); each timed at
    the main path's shapes (a decode step's R 16 over 8 experts at 8
    sequences, R 192 at 96) beside its plain version, its bound and
    torch._grouped_mm on the dequantized bf16 stack (context only); qgemm
    held and timed at Mixtral's projection and router shapes."""
    g = torch.Generator(device="cuda").manual_seed(51)
    worst = {"ds_ggemm_q": 0.0, "ds_ggemm_slots_q": 0.0, "qgemm": 0.0}
    # the slot kernel stages at most kSlotSG scale groups a 128-column
    # tile meets: a finer layout (4-lane groups) is refused at launch
    x = torch.randn(16, 64, generator=g, device="cuda")
    plan, xin = ggemm_io(gg, x, routed(torch, g, 16, "random"), 16)
    q = torch.ones(MIX_E, 64, 96, dtype=torch.int8, device="cuda")
    try:
        gg.ggemm_slots_q_cuda(xin, q, torch.ones(MIX_E, 64, 24,
                                                 device="cuda"), plan)
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "ds_ggemm_slots_q computed a scale layout of more "
          "groups a tile than it stages")
    times, ident, slot_ident = {}, {}, {}
    gg.ds_ggemm_slots.unaligned_launches = 0
    gg.ds_ggemm.unaligned_int8_launches = 0
    gg.ds_ggemm_slots.unaligned_int8_launches = 0
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for proj, (K, N) in MOE_SHAPES.items():
            q, s = qz.block_quantize_int8(
                (torch.randn(MIX_E, K, N, generator=g, device="cuda")
                 * 0.02).to(dt))
            for R in SLOT_Q_R + GROUP_Q_R:
                x = torch.randn(R, K, generator=g, device="cuda").to(dt)
                for skew in ("random", "one_expert", "two_empty"):
                    e = routed(torch, g, R, skew)
                    plan, xin = ggemm_io(gg, x, e, R)
                    slot = R <= gg.SLOT_MAX_ROWS
                    if slot:
                        name = "ds_ggemm_slots_q"
                        got = gg.ggemm_slots_q_cuda(xin, q, s, plan)
                        ref = gg.ggemm_slots_q_plain(xin, q, s, plan)
                    else:
                        name = "ds_ggemm_q"
                        got = gg.ggemm_q_cuda(xin, q, s, plan)
                        ref = gg.ggemm_q_plain(xin, q, s, plan)
                    torch.cuda.synchronize()
                    e_abs, held = err_of(torch, got, ref, dt_name)
                    zeros = True
                    if not slot:
                        pad = torch.ones(got.shape[0], dtype=torch.bool,
                                         device="cuda")
                        pad[plan.row_to_padded.long()] = False
                        zeros = not bool(got[pad].any())
                    emit({"check": name, "dtype": dt_name, "proj": proj,
                          "R": R, "K": K, "N": N, "routing": skew,
                          "route": grouped_route(gg, name, xin, q, s),
                          "max_abs_err": e_abs, "held": held,
                          "tol": INT8_TOL[dt_name],
                          "padding_zeros": zeros})
                    check(held <= INT8_TOL[dt_name] and zeros,
                          f"{name} {dt_name} {proj} R {R} {skew}: err "
                          f"{held} > {INT8_TOL[dt_name]} or padding not 0")
                    worst[name] = max(worst[name], held)
            if dt_name == "bfloat16":
                ident[proj] = ggemm_q_identity_checks(torch, gg, g, q, s,
                                                      proj)
                slot_ident[proj] = slot_q_identity_checks(torch, gg, g, q,
                                                          s, proj)
            del q, s
            torch.cuda.empty_cache()
    check(not any(off_rule_counts(gg).values()),
          f"int8 grouped kernels: main-path shapes off the shape rules "
          f"{off_rule_counts(gg)}")
    dt = torch.bfloat16
    for proj, (K, N) in MOE_SHAPES.items():
        q, s = qz.block_quantize_int8(
            (torch.randn(MIX_E, K, N, generator=g, device="cuda")
             * 0.02).to(dt))
        wdq = gg.dequant_experts(q, s, dt)    # context only
        for R, e in ((16, torch.arange(16, device="cuda").int() % MIX_E),
                     (2 * WIDE_SEQS, routed(torch, g, 2 * WIDE_SEQS,
                                            "random"))):
            x = torch.randn(R, K, generator=g, device="cuda").to(dt)
            plan, xin = ggemm_io(gg, x, e, R)
            if R <= gg.SLOT_MAX_ROWS:
                name, kern, plain = ("ds_ggemm_slots_q",
                                     gg.ggemm_slots_q_cuda,
                                     gg.ggemm_slots_q_plain)
            else:
                name, kern, plain = ("ds_ggemm_q", gg.ggemm_q_cuda,
                                     gg.ggemm_q_plain)
            t = {"kernel_ms": time_ms(lambda: kern(xin, q, s, plan), reps=5,
                                      inner=5),
                 "plain_ms": time_ms(lambda: plain(xin, q, s, plan), reps=3,
                                     inner=2),
                 "library_ms": None}
            t["bound_ms"], t["bound_by"] = ggemm_q_bound(
                torch, gg, plan, xin, R, K, N, s.shape[-1])
            t["device_ms"] = device_ms(
                torch, [lambda: kern(xin, q, s, plan)], reps=10,
                one_kernel=True)[0]
            t["route"] = grouped_route(gg, name, xin, q, s)
            t["grouped_mm_bf16_ms"], why = grouped_mm_library(torch, gg, x,
                                                              wdq, e)
            if why:
                t["library_note"] = why
            t.update(work=f"{proj} K {K} N {N}, R {R}, bf16 rows, int8 "
                          f"experts", R=R, padded_rows=xin.shape[0])
            emit({"phase": "moe_int8_kernel_times", "kernel": name,
                  "proj": proj, **t})
            times.setdefault(name, {})[proj] = t
        del q, s, wdq
        torch.cuda.empty_cache()
    qtimes = {}
    for M, K, N, dt_name in MIX_QGEMM:
        dt = getattr(torch, dt_name)
        q, s = qz.block_quantize_int8(
            (torch.randn(K, N, generator=g, device="cuda") * 0.02)
            .to(torch.bfloat16))
        x = torch.randn(M, K, generator=g, device="cuda").to(dt)
        got = qg.qgemm_cuda(x, q, s)
        ref = qg.qgemm_plain(x, q, s)
        torch.cuda.synchronize()
        e_abs, held = err_of(torch, got, ref, dt_name)
        t = {"kernel_ms": time_ms(lambda: qg.qgemm_cuda(x, q, s), reps=5,
                                  inner=10),
             "plain_ms": time_ms(lambda: qg.qgemm_plain(x, q, s), reps=3,
                                 inner=4)}
        xb = x.element_size()
        t["bound_ms"], t["bound_by"] = bound_of(
            K * N + s.numel() * 4 + M * K * xb + M * N * xb, 2 * M * K * N,
            BF16_FLOPS)
        key = f"M{M}_K{K}_N{N}_{dt_name}"
        emit({"check": "qgemm_mixtral", "shape": key, "max_abs_err": e_abs,
              "held": held, "tol": INT8_TOL[dt_name], **t})
        check(held <= INT8_TOL[dt_name], f"qgemm {key}: err {held}")
        worst["qgemm"] = max(worst["qgemm"], held)
        qtimes[key] = t
    times["ggemm_q_identity"] = ident
    times["slot_q_identity"] = slot_ident
    return times, worst, qtimes


def moe_int8_counts(gg, qz, qg, da, fa):
    return {"ds_ggemm_q": gg.ds_ggemm.int8_launches,
            "ds_ggemm_slots_q": gg.ds_ggemm_slots.int8_launches,
            "qgemm": qg.qgemm.launches,
            "block_quantize_int8": qz.block_quantize_int8.launches,
            **moe_counts(gg, da, fa)}


def reset_moe_int8_counts(gg, qz, qg, da, fa):
    gg.ds_ggemm.int8_launches = gg.ds_ggemm_slots.int8_launches = 0
    qg.qgemm.launches = qz.block_quantize_int8.launches = 0
    reset_moe_counts(gg, da, fa)


def first_diffs(prompts, reqs, refs):
    """{prompt length: first differing token} of each request whose
    output differs from its reference token list."""
    out = {}
    for p, r, ref in zip(prompts, reqs, refs):
        got = list(r.output_ids)
        if got != list(ref):
            out[int(p.size)] = next(j for j, (a, b) in
                                    enumerate(zip(got, ref)) if a != b)
    return out


def batch_invariance(torch, model, params, prompts, reqs, seqs, key):
    """The int8-cache arm's held identity: the prompts again, submitted
    in reverse order to a scheduler of the same max_num_seqs and int8
    cache whose pool preempts nothing; every request of the first run
    that was not preempted must come out token-identical (the preempted
    ones are re-prefilled at another length and only reported)."""
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             SamplingParams)
    sched = ContinuousBatchingScheduler(
        model, params, ServingConfig(max_num_seqs=seqs),
        kv_cache_dtype="int8")
    again = [sched.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
             for p in prompts[::-1]][::-1]
    sched.run_until_idle()
    torch.cuda.synchronize()
    check(sched.metrics.counters["preemptions"] == 0,
          f"fp32 int8 mixtral {key}: the reordered run preempted")
    kept = [i for i, r in enumerate(reqs) if r.num_preemptions == 0]
    diff = first_diffs([prompts[i] for i in kept], [reqs[i] for i in kept],
                       [again[i].output_ids for i in kept])
    preempted = [i for i in range(len(reqs)) if i not in kept]
    report = {"reordered_identical_not_preempted": not diff,
              "not_preempted": len(kept),
              "reordered_first_diff_by_prompt_len": diff,
              "preempted_first_diff_by_prompt_len": first_diffs(
                  [prompts[i] for i in preempted],
                  [reqs[i] for i in preempted],
                  [again[i].output_ids for i in preempted])}
    check(kept and not diff, f"fp32 int8 mixtral {key}: requests that were "
          f"not preempted differ from the reordered run {diff}")
    return report


def row_dependence(torch, gg, qg, params, D):
    """Phase 15's evidence for its 96-sequence arm: whether the bits of
    one row's output change with the rows computed beside it, on fp32
    rows and layer 0's int8 weights.  qgemm (wq, the router) at M 1 (the
    static generate), 8 and 96 (the decode paths: 8-row blocks whatever
    M), held equal; the gate experts through ds_ggemm_slots_q at R 2 (one
    token's two routed rows, as the generate runs them) and R 16, and
    ds_ggemm_q at R 192 (96 tokens), the first token's rows compared, held
    equal (both sum a row in one fmaf chain over K in order); the fp32
    lm_head through the model's ``head_dot`` (``rows_matmul``: the grouped
    GEMM's fp32 kernel over one group) at M 1, 8 and 96, held equal, with
    cuBLAS's ``x @ lm_head`` beside it (reported), and the cost at the
    phase's largest prefill (M 912) and the 96-row decode: both timed
    (CUDA events, ms a call)."""
    from deepspeed_tpu_torch.models.model import layer_params
    g = torch.Generator(device="cuda").manual_seed(71)
    x = torch.randn(96, D, generator=g, device="cuda")
    layer = layer_params(params["blocks"], 0)

    def same(fn, sizes):
        ref = fn(sizes[0])
        return {f"{n}_equals_{sizes[0]}": bool(torch.equal(fn(n), ref))
                for n in sizes[1:]}
    out = {}
    for name, w in (("qgemm_wq", layer["wq"]),
                    ("qgemm_router", layer["moe"]["router"])):
        out[name] = same(lambda M, w=w: qg.qgemm(x[:M], w.q, w.s)[0],
                         (1, 8, 96))
        check(all(out[name].values()), f"row_dependence {name}: row 0's "
              f"bits change with M {out[name]}")
    from deepspeed_tpu_torch.models.model import head_dot
    with torch.no_grad():
        out["lm_head"] = same(lambda M: head_dot(x[:M],
                                                 params["lm_head"])[0],
                              (1, 8, 96))
        check(all(out["lm_head"].values()), f"row_dependence lm_head: row "
              f"0's bits change with M {out['lm_head']}")
        cub = same(lambda M: (x[:M] @ params["lm_head"])[0], (1, 8, 96))
        xp = torch.randn(912, D, generator=g, device="cuda")
        cost = {}
        for label, rows in (("prefill_912", xp), ("decode_96", x)):
            cost[label] = {
                "rows_matmul_ms": time_ms(lambda: head_dot(
                    rows, params["lm_head"]), reps=5, inner=3),
                "cublas_ms": time_ms(lambda: rows @ params["lm_head"],
                                     reps=5, inner=3)}
    emit({"check": "rows_matmul_lm_head", "cublas_row_0": cub,
          "cost": cost, "shape": [D, int(params["lm_head"].shape[1])]})
    wg = layer["moe"]["w_gate"]
    E = wg.q.shape[0]
    eids = torch.randint(0, E, (192,), generator=g, device="cuda")
    rows = x.repeat_interleave(2, dim=0)

    def slots(R):
        plan = gg.make_slot_plan(eids[:R], E)
        return gg.ds_ggemm_slots(rows[:R], wg, plan)[:2]

    def group(R):
        plan = gg.make_group_plan(eids[:R], E)
        return gg.gather_from_groups(gg.ds_ggemm(gg.scatter_to_groups(
            rows[:R], plan), wg, plan), plan)[:2]
    ref = slots(2)
    out["experts"] = {
        "slot_q_16_equals_slot_q_2": bool(torch.equal(slots(16), ref)),
        "ggemm_q_192_equals_slot_q_2": bool(torch.equal(group(192), ref))}
    check(all(out["experts"].values()), f"row_dependence experts: the "
          f"first token's rows change with R {out['experts']}")
    return out


#: head_dot against an fp64 product: max |error| over logits of O(1)
#: (x ~ N(0, 1), weights ~ N(0, 0.02))
HEAD_TOL = 1e-4
#: the rows the serving paths give the head: phase 15's largest prefill
#: bucket, the 96-sequence decode, the 8-sequence decode, the generate
HEAD_ROWS = (912, 96, 8, 1)


def head_value_checks(torch, gg):
    """Every fp32 LM head the smoke's models serve, through the models'
    ``head_dot`` (``rows_matmul``: ds_ggemm, or ds_ggemm_t for a tied
    [V, D] head), at HEAD_ROWS rows: held within HEAD_TOL of the fp64
    product on the same inputs (the ragged vocabulary tail included),
    each call one launch of its kernel, and row 0's bits the same at
    every row count; cuBLAS's fp32 ``x @ w`` error beside it
    (reported)."""
    from deepspeed_tpu_torch.models.bloom import bloom_model
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.models.gptneo import gptneo_model
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.models.model import head_dot
    from deepspeed_tpu_torch.models.neox import neox_model
    heads = {"gpt2_760m_wte": (gpt2_model("760m").config, True),
             "gptneo_2.7b_wte": (gptneo_model("2.7b").config, True),
             "bloom_560m_wte": (bloom_model("560m").config, True),
             "mixtral_8x7b_llama_7b_lm_head":
                 (mixtral_model("8x7b").config, False),
             "neox_20b_embed_out": (neox_model("20b").config, False)}
    g = torch.Generator(device="cuda").manual_seed(73)
    out = {}
    for name, (cfg, tied) in heads.items():
        D, V = cfg.d_model, cfg.vocab_size
        x = torch.randn(max(HEAD_ROWS), D, generator=g, device="cuda")
        w = torch.randn(*((V, D) if tied else (D, V)), generator=g,
                        device="cuda") * 0.02
        ref = x.double() @ (w.T if tied else w).double()
        row = {"shape": [D, V], "tied": tied}
        with torch.no_grad():
            first = None
            for M in HEAD_ROWS:
                gg.ds_ggemm.launches = gg.ds_ggemm.transpose_launches = 0
                got = head_dot(x[:M], w, transpose_w=tied)
                n = gg.ds_ggemm.transpose_launches if tied \
                    else gg.ds_ggemm.launches
                cub = x[:M] @ (w.T if tied else w)
                torch.cuda.synchronize()
                first = got[:1] if first is None else first
                row[f"M_{M}"] = {
                    "max_abs_err": float((got.double() - ref[:M]).abs()
                                         .max()),
                    "tail_max_abs_err": float((got[:, -64:].double()
                                               - ref[:M, -64:]).abs().max()),
                    "cublas_max_abs_err": float((cub.double() - ref[:M])
                                                .abs().max()),
                    "launches": n,
                    "row_0_equals_max_rows": bool(torch.equal(got[:1],
                                                              first)),
                    "finite": bool(torch.isfinite(got).all())}
                del got, cub
        out[name] = row
        bad = {M: r for M, r in row.items() if isinstance(r, dict) and not (
            r["max_abs_err"] <= HEAD_TOL and r["launches"] == 1
            and r["row_0_equals_max_rows"] and r["finite"])}
        emit({"check": "head_dot_values", "head": name, "tol": HEAD_TOL,
              **row})
        check(not bad, f"head_dot {name}: {bad}")
        del x, w, ref
        torch.cuda.empty_cache()
    return out


def mixtral_int8_parity_phase(torch, gg, qz, qg, da, fa):
    """Phase 15: fp32 int8 Mixtral-8x7B widths at 2 layers, at
    max_num_seqs 8 (the slot arm, unfused and fused) and 96 (the
    group-padded arm), each with a float and an int8 KV cache and a pool
    that forces a preemption.  Launch counts exact in every run (per
    decode step 3 L of the arm's int8 grouped kernel, 5 L qgemm, L decode
    of the cache's kind; fused: L fused, L qgemm (the router), no decode;
    per prefill L flash and 3 L float grouped GEMMs on the dequantized
    layer, no int8 grouped or qgemm launch).  Float cache: the scheduler
    token-identical to the static generate, the fused arm to the unfused
    one, and teacher-forced decode logits within 1e-3 of a full forward
    with the plain kernels.  Int8 cache: the generate prefills at the
    scheduler's 16-token bucket, so at max_num_seqs 8 and 96 every request
    that was not preempted is held token-identical to the static generate
    (at 96 the decode runs ds_ggemm_q where the one-row generate runs the
    slot kernel: ``row_dependence`` holds their rows, qgemm's at M 1, 8
    and 96 and the fp32 lm_head's, equal, and no row left changing with
    M); a
    preempted request re-prefills its generated tail (its K/V then come
    from the prefill's GEMMs, not the decode's, and an int8 cache turns
    a last-bit difference into a whole code step), so its identity is
    reported.  Also held there: the fused
    arm token-identical to the unfused one, and every request that was
    not preempted token-identical to the same request in a second run of
    the arm with the prompts submitted in reverse order and a pool that
    preempts nothing."""
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             RequestState, SamplingParams)
    import deepspeed_tpu_torch as dt
    L = MIX_PARITY_LAYERS
    torch.cuda.synchronize()
    report = {"phase": "fp32_mixtral_int8_parity", "layers": L,
              "memory_allocated_at_start": torch.cuda.memory_allocated()}
    t0 = time.perf_counter()
    model = mixtral_model("8x7b", num_layers=L, dtype="float32")
    engines = {"int8": dt.init_inference(model, {"dtype": "float32"},
                                         quant={"enabled": True},
                                         kv_cache_dtype="int8")}
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    # the same int8 weights, a float cache for the static generate
    engines[None] = InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype="float32", quant={"enabled": True}),
        model_parameters=engines["int8"].params)
    params = engines["int8"].params
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=6)
    static = {}
    for kv, eng in engines.items():
        t0 = time.perf_counter()
        static[kv] = [list(eng.generate(p, max_new_tokens=MAX_NEW)
                           [0, p.size:]) for p in prompts]
        report[f"static_generate_s_{kv or 'float'}_kv"] = \
            time.perf_counter() - t0
    for seqs in (8, WIDE_SEQS):
        for kv in (None, "int8"):
            unfused = None
            for fused in (False, True) if seqs == 8 else (False,):
                sched = ContinuousBatchingScheduler(
                    model, params, ServingConfig(num_blocks=140,
                                                 max_num_seqs=seqs,
                                                 fused_decode=fused),
                    kv_cache_dtype=kv)
                reset_moe_int8_counts(gg, qz, qg, da, fa)
                t0 = time.perf_counter()
                reqs = [sched.submit(p, SamplingParams(
                    max_new_tokens=MAX_NEW)) for p in prompts]
                sched.run_until_idle()
                torch.cuda.synchronize()
                serve_s = time.perf_counter() - t0
                n = moe_int8_counts(gg, qz, qg, da, fa)
                c = sched.metrics.counters
                steps, prefills = c["decode_steps"], c["prefills"]
                big = sum(1 for _, sp, _ in sched.metrics.prefill_s
                          if 2 * sp > 128)
                slot = 2 * seqs <= gg.SLOT_MAX_ROWS
                dec = 0 if fused else L * steps
                # fused: the projections run in the fused layer, qgemm
                # takes the router alone
                want = {"ds_fused_layer": L * steps if fused else 0,
                        "ds_ggemm_slots_q": 3 * L * steps if slot else 0,
                        "ds_ggemm_q": 0 if slot else 3 * L * steps,
                        "qgemm": (1 if fused else 5) * L * steps,
                        "block_quantize_int8": 0,
                        # the experts, and the fp32 head (rows_matmul)
                        "ds_ggemm": 3 * L * big + prefills + steps,
                        "ds_ggemm_slots": 3 * L * (prefills - big),
                        "ds_flash_fwd": L * prefills,
                        "decode_attention": 0 if kv else dec,
                        "decode_attention_int8": dec if kv else 0}
                first_diff = first_diffs(prompts, reqs, static[kv])
                preempted = [int(p.size) for p, r in zip(prompts, reqs)
                             if r.num_preemptions]
                kept_diff = {n0: t for n0, t in first_diff.items()
                             if n0 not in preempted}
                key = f"max_num_seqs_{seqs}_{'int8' if kv else 'float'}_kv" \
                    + ("_fused" if fused else "")
                report[key] = {"prefills": prefills, "long_prefills": big,
                               "decode_steps": steps, "serve_s": serve_s,
                               "preemptions": c["preemptions"],
                               "preempted_prompt_lens": preempted,
                               "launches": n, "want": want,
                               "token_identical": not first_diff,
                               "first_diff_by_prompt_len": first_diff}
                check(all(r.state == RequestState.FINISHED
                          and r.num_generated == MAX_NEW for r in reqs),
                      f"fp32 int8 mixtral {key}: not every request finished")
                check(c["preemptions"] >= 1,
                      f"fp32 int8 mixtral {key}: the pool did not force a "
                      "preemption")
                check(n == want,
                      f"fp32 int8 mixtral {key}: launches {n} != {want}")
                outs = [list(r.output_ids) for r in reqs]
                if fused:
                    same = outs == unfused
                    report[key]["token_identical_to_unfused"] = same
                    check(same, f"fp32 int8 mixtral {key}: fused tokens "
                          "!= unfused tokens")
                    del sched
                    continue
                unfused = outs
                # float cache: every request; int8 cache: every request
                # that was not preempted (a resumed one re-prefills its
                # generated tail, whose K/V then come from the prefill's
                # GEMMs, not the decode's); at 96 rows the decode's
                # ds_ggemm_q sums a row as the generate's slot kernel does
                # (row_dependence)
                check(not (kept_diff if kv else first_diff),
                      f"fp32 int8 mixtral {key}: scheduler != static "
                      f"generate (prompt length: first differing token) "
                      f"{first_diff}")
                if kv:
                    report[key].update(batch_invariance(
                        torch, model, params, prompts, reqs, seqs, key))
                if slot and not kv:
                    forced = reqs
                del sched
    report["row_dependence"] = row_dependence(torch, gg, qg, params,
                                              model.config.d_model)
    report["head_values"] = head_value_checks(torch, gg)
    # no product of the path changes with the rows beside it (queue C 2,
    # closed: the fp32 lm_head on rows_matmul), beside the wide int8 arm
    report["rows_depending_on_M"] = sorted(
        name for name, same in report["row_dependence"].items()
        if not all(same.values()))
    check(not report["rows_depending_on_M"], f"fp32 int8 mixtral: rows "
          f"that change with M {report['rows_depending_on_M']}")
    del engines[None]
    # teacher-forced decode through the int8 kernels (float cache) against
    # a full forward on the dequantized layers with the plain kernels
    plain = mixtral_model("8x7b", num_layers=L, dtype="float32",
                          attention_impl="plain")
    worst = 0.0
    with torch.no_grad():
        for i in (2, 6):
            toks = list(prompts[i]) + list(forced[i].output_ids[:-1])
            n0 = len(prompts[i])
            ids = torch.tensor([toks], dtype=torch.int32, device="cuda")
            cache = model.init_cache_fn(1, -(-len(toks) // 64) * 64,
                                        torch.float32, "cuda")
            logits, cache = model.prefill_fn(
                params, {"input_ids": ids[:, :n0]}, cache)
            for pos in range(n0, len(toks)):
                logits, cache = model.decode_fn(
                    params, ids[:, pos], cache,
                    torch.tensor([pos], dtype=torch.int32, device="cuda"))
            with plain_grouped_gemm(gg), plain_head():
                full = plain.apply(params, {"input_ids": ids})[:, -1]
            worst = max(worst, float((logits - full).abs().max()))
    report.update(teacher_forced_max_abs_err=worst, tol=1e-3)
    check(worst <= 1e-3, f"fp32 int8 mixtral: decode logits differ from "
          f"the plain full forward by {worst}")
    emit(report)
    return report


def mixtral_int8_http_phase(torch, gg, qz, qg, da, fa):
    """Phase 16, the slice's main path: init_inference(mixtral_model(
    "8x7b"), bf16, quant enabled, int8 KV cache) at MIX_Q_LAYERS (the
    quantizing device init: seconds, quantizer launches, params' device
    bytes) -> scheduler -> HTTP, three arms: phase 5's eight requests at
    max_num_seqs 8 (the slot kernel), unfused and fused (the fused layer
    over each layer's attention half), and 96 requests of 16-256 prompt
    tokens, 32 new tokens each, at max_num_seqs 96 (the group-padded
    kernel).  Each arm: tokens/s, TTFT, TPOT, decode ms per step of the
    timed run, launch counts, a profiled decode window, peak memory; the
    unfused 8-sequence arm and the 96-sequence arm also hold one decode
    step's int8 expert GEMMs against their plain versions on the path's
    own rows."""
    import gc
    import numpy as np
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.models.model import QuantizedTensor
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving.scheduler import \
        ContinuousBatchingScheduler
    import deepspeed_tpu_torch as dt
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    emit({"phase": "mixtral_int8_start", "memory_allocated": at_start})
    check(at_start < 4e9, f"int8 mixtral: {at_start} bytes still allocated "
          "before the load (an earlier engine was not freed)")
    torch.cuda.reset_peak_memory_stats()
    reset_moe_int8_counts(gg, qz, qg, da, fa)
    t0 = time.perf_counter()
    model = mixtral_model("8x7b", num_layers=MIX_Q_LAYERS,
                          dtype="bfloat16")
    eng = dt.init_inference(model, {"dtype": "bfloat16"},
                            quant={"enabled": True}, kv_cache_dtype="int8")
    torch.cuda.synchronize()
    L = model.config.num_layers

    def leaf(path):
        t = eng.params["blocks"]
        for k in path:
            t = t[k]
        return t
    load = {"init_s": time.perf_counter() - t0, "layers": L,
            "launches": moe_int8_counts(gg, qz, qg, da, fa),
            "params": model.meta["n_params"],
            "params_device_bytes": nbytes(eng.params),
            "blocks_device_bytes": nbytes(eng.params["blocks"]),
            "memory_allocated": torch.cuda.memory_allocated(),
            "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    want_q = L * (5 + 3 * MIX_E)   # per layer: 4 projections + router, and
    #                                 every [layer, expert] expert slice
    check(L == MIX_Q_LAYERS and all(isinstance(leaf(p), QuantizedTensor)
                                    for p in MIX_Q_LEAVES)
          and load["launches"]["block_quantize_int8"] == want_q,
          f"int8 mixtral load: {L} layers, launches {load['launches']} "
          f"(want {want_q} quantizer launches and every block leaf int8)")
    rng = np.random.default_rng(7)
    prompts8 = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=1)
    arms = {
        "max_num_seqs_8": (ServingConfig(), prompts8, MAX_NEW,
                           "ds_ggemm_slots_q", "ds_ggemm_q"),
        # the fused arm: each layer's attention half in the fused layer
        "max_num_seqs_8_fused": (ServingConfig(fused_decode=True), prompts8,
                                 MAX_NEW, "ds_ggemm_slots_q", "ds_ggemm_q"),
        f"max_num_seqs_{WIDE_SEQS}": (
            ServingConfig(max_num_seqs=WIDE_SEQS,
                          num_blocks=WIDE_SEQS * WIDE_BLOCKS_PER_SEQ + 1,
                          max_blocks_per_seq=WIDE_BLOCKS_PER_SEQ),
            prompts_for(rng.integers(16, 257, WIDE_SEQS),
                        model.config.vocab_size, seed=2), WIDE_NEW,
            "ds_ggemm_q", "ds_ggemm_slots_q"),
    }
    runs = {}
    for key, (cfg, prompts, max_new, kern, idle) in arms.items():
        torch.cuda.reset_peak_memory_stats()
        sched = ContinuousBatchingScheduler(model, eng.params, cfg,
                                            kv_cache_dtype="int8")
        outs, wall_s, mbody, n, window = serve_http(
            torch, sched, prompts,
            on_start=lambda: reset_moe_int8_counts(gg, qz, qg, da, fa),
            on_done=lambda: {**moe_int8_counts(gg, qz, qg, da, fa),
                             **off_rule_counts(gg)},
            max_new=max_new)
        attn = "ds_fused_layer" if cfg.fused_decode \
            else "decode_attention_int8"
        check(all(n[k] > 0 for k in (kern, "qgemm", attn, "ds_flash_fwd"))
              and n[idle] == 0 and n["decode_attention"] == 0
              and not any(off_rule_counts(gg).values())
              and n["ds_fused_layer" if attn != "ds_fused_layer"
                    else "decode_attention_int8"] == 0
              and n["ds_ggemm"] + n["ds_ggemm_slots"] > 0,
              f"int8 mixtral http {key}: launches {n}")
        check(f'kernel_launches{{kernel="{kern}"}}' in mbody,
              f"int8 mixtral http {key}: /metrics lacks {kern}")
        run = {**serve_report(outs, wall_s, window), "launches": n,
               "prompt_tokens": int(sum(p.size for p in prompts)),
               "outputs": [o["output_ids"][:8] for o in outs[:8]]}
        # the decode batch is max_num_seqs rows whatever is active, so
        # eight of the prompts give the arm's per-step device work
        run["decode_profile"] = profile_decode(torch, sched, prompts[:8])
        if kern == "ds_ggemm_q":    # R 2 x 96: the group-padded kernel
            run["path_expert_gemms"] = path_expert_check(
                torch, gg, sched, prompts[:8], ("ggemm_q_cuda",),
                f"int8_mixtral_{key}")
        elif not cfg.fused_decode:  # R 2 x 8 = 16: the int8 slot kernel
            run["path_expert_gemms"] = path_expert_check(
                torch, gg, sched, prompts[:8], ("ggemm_slots_q_cuda",),
                f"int8_mixtral_{key}")
        run["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
        runs[key] = run
        del sched
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "bf16_mixtral_int8_http", "engine_load": load, **runs})
    return load, runs


# --------------------------------------------- Llama serving (slice 6)
LLAMA_D, LLAMA_M, LLAMA_KV, LLAMA_HD = 4096, 11008, 32, 128
LLAMA_LAYERS = 32           # llama:7b, nothing cut (phases 17, 19)
LLAMA_PARITY_LAYERS = 4


def family_specs():
    """(name, spec, d_mlp) of phase 17: Llama-2 7B's layer, Mixtral-8x7B's
    attention half, and a small spec where GQA (rep 4), SwiGLU, the
    InternLM biases and head_dim 96 (a rotary half of 48) meet."""
    from deepspeed_tpu_torch.models import llama, mixtral
    small = llama.LlamaConfig(d_model=1536, num_heads=16, num_kv_heads=4,
                              d_mlp=4096, attn_bias=True)
    return (("llama_7b", llama.fused_spec(llama.LlamaConfig()), LLAMA_M),
            ("mixtral_8x7b", mixtral.fused_spec(mixtral.MixtralConfig()), 0),
            ("gqa_swiglu_biased", llama.fused_spec(small), small.d_mlp))


def spec_weights(torch, g, spec, M, dt, int8_weights, qz, res_std=0.02):
    """A layer's canonical fused weights for ``spec``, seeded (std 0.02
    projections and biases, ``res_std`` for the projections that feed
    the residual stream, norm scales near 1), int8 projections quantized
    from the compute-dtype values."""
    from deepspeed_tpu_torch.models.model import QuantizedTensor
    from deepspeed_tpu_torch.ops.kernels.fused_decode import _weight_order
    D = spec.d_model
    Dq = spec.num_heads * spec.head_dim
    Dk = spec.num_kv_heads * spec.head_dim
    shapes = {"n1_s": (D,), "n2_s": (D,), "n1_b": (D,), "n2_b": (D,),
              "wq": (D, Dq), "wk": (D, Dk), "wv": (D, Dk), "bq": (Dq,),
              "bk": (Dk,), "bv": (Dk,), "wqkv": (D, Dq + 2 * Dk),
              "bqkv": (Dq + 2 * Dk,), "wo": (Dq, D), "bo": (D,),
              "w_gate": (D, M), "w_up": (D, M), "w_down": (M, D),
              "w_in": (D, M), "b_in": (M,), "w_out": (M, D), "b_out": (D,)}
    cw = {}
    for key in _weight_order(spec):
        t = torch.randn(*shapes[key], generator=g, device="cuda")
        std = res_std if key in ("wo", "w_out", "w_down") else 0.02
        cw[key] = (t * 0.1 + 1 if key.endswith("_s") else t * std).to(dt)
        if int8_weights and key.startswith("w"):
            cw[key] = QuantizedTensor(*qz.block_quantize_int8(cw[key]), dt)
    return cw


def spec_cache(torch, g, dt, int8_cache, da, KV, hd, B=8, S=1024):
    k = torch.randn(B, S, KV, hd, generator=g, device="cuda")
    v = torch.rand(B, S, KV, hd, generator=g, device="cuda") * 2 - 1
    if int8_cache:
        (kq, ks), (vq, vs) = da.quantize_kv(k), da.quantize_kv(v)
        return kq, vq, ks, vs
    return k.to(dt), v.to(dt), None, None


def nbytes(t):
    """Device bytes of a tensor, a ``QuantizedTensor`` (codes and scales)
    or a tree of them."""
    if isinstance(t, dict):
        return sum(nbytes(v) for v in t.values())
    if hasattr(t, "q"):
        return nbytes(t.q) + nbytes(t.s)
    return t.numel() * t.element_size()


def fused_bound(spec, M, cw, lens, int8_cache, B=8):
    """(bound_ms, bound_by) of one fused layer call at W 1: its weight
    bytes, the cache positions it reads (codes and scales for an int8
    cache), x in and out; products 2 B (weights) plus the attention's
    4 (positions + B) H hd, at the bf16 peak."""
    KV, H, hd = spec.num_kv_heads, spec.num_heads, spec.head_dim
    n_pos = int(lens.sum())
    wbytes = nbytes(cw)
    cbytes = n_pos * 2 * KV * hd * (1 if int8_cache else 2) \
        + (n_pos * 2 * KV * 4 if int8_cache else 0)
    weights = sum((w.q if hasattr(w, "q") else w).numel()
                  for k, w in cw.items() if k.startswith("w"))
    flops = 2 * B * weights + 4 * (n_pos + B) * H * hd
    b, f = bound_of(wbytes + cbytes + 2 * B * spec.d_model * 2, flops,
                    BF16_FLOPS)
    return b, f, wbytes, cbytes


def fused_family_phase(torch, qz, da, fd):
    """Phase 17: the fused layer kernel at the Llama-2 7B spec, Mixtral-
    8x7B's attention-half spec and a small GQA + SwiGLU + biases spec,
    against its plain version at B 8, W 1 and 4, float / int8 weights x
    float / int8 cache, fp32 and bf16 (then :func:`fused_family_times`).
    Returns the worst held error by spec."""
    g = torch.Generator(device="cuda").manual_seed(61)
    worst = {}
    for name, spec, M in family_specs():
        KV, hd, D = spec.num_kv_heads, spec.head_dim, spec.d_model
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            for w8 in (False, True):
                cw = spec_weights(torch, g, spec, M, dt, w8, qz)
                for c8 in (False, True):
                    k, v, ks, vs = spec_cache(torch, g, dt, c8, da, KV, hd)
                    for W in FUSED_W:
                        lens = torch.tensor([min(n, 1024 - W)
                                             for n in DECODE_LENS],
                                            dtype=torch.int32, device="cuda")
                        x = torch.randn(8, W, D, generator=g,
                                        device="cuda").to(dt)
                        got = fd.fused_layer_cuda(x, cw, k, v, lens, spec,
                                                  ks, vs)
                        ref = fd.fused_layer_plain(x, cw, k, v, lens, spec,
                                                   ks, vs)
                        row = {"check": "ds_fused_layer", "spec": name,
                               "dtype": dt_name, "int8_weights": w8,
                               "int8_cache": c8, "W": W,
                               "tol": INT8_TOL[dt_name]}
                        ok, held = fused_check(torch, got, ref, dt_name, row)
                        worst[name] = max(worst.get(name, 0.0), held)
                        emit(row)
                        check(ok, f"ds_fused_layer {name} {dt_name} "
                              f"w8={w8} c8={c8} W={W}: {row}")
                    del k, v, ks, vs
                del cw
        torch.cuda.empty_cache()
    return worst


def fused_family_times(torch, qz, da, fd):
    """Phase 17's times: bf16, B 8, W 1, over 32 layers' own weights and
    caches (Llama: its four weight x cache configurations; Mixtral: bf16
    and int8 weights and cache), beside the plain version and the bound.
    Returns the times of each family's main-path configuration."""
    g = torch.Generator(device="cuda").manual_seed(62)
    dt = torch.bfloat16
    lens = torch.tensor([min(n, 1023) for n in DECODE_LENS],
                        dtype=torch.int32, device="cuda")
    times = {}
    configs = {"llama_7b": ((False, False), (False, True), (True, False),
                            (True, True)),
               "mixtral_8x7b": ((False, False), (True, True))}
    for name, spec, M in family_specs():
        if name not in configs:
            continue
        x = torch.randn(8, 1, spec.d_model, generator=g,
                        device="cuda").to(dt)
        by = {}
        for w8, c8 in configs[name]:
            layers = [spec_weights(torch, g, spec, M, dt, w8, qz)
                      for _ in range(LLAMA_LAYERS)]
            caches = [spec_cache(torch, g, dt, c8, da, spec.num_kv_heads,
                                 spec.head_dim) for _ in range(LLAMA_LAYERS)]
            fns = [lambda cw=cw, c=c: fd.fused_layer_cuda(
                x, cw, c[0], c[1], lens, spec, c[2], c[3])
                for cw, c in zip(layers, caches)]
            plain = [lambda cw=cw, c=c: fd.fused_layer_plain(
                x, cw, c[0], c[1], lens, spec, c[2], c[3])
                for cw, c in zip(layers, caches)]
            b, f, wbytes, cbytes = fused_bound(spec, M, layers[0], lens, c8)
            key = f"{'int8' if w8 else 'bf16'}_weights_" \
                  f"{'int8' if c8 else 'bf16'}_cache"
            by[key] = dict(timed(torch, fns, plain),
                           bound_ms=b, bound_by=f, weight_bytes=wbytes,
                           cache_bytes=cbytes, library_ms=None,
                           phase_us=fused_phase_us(torch, fd, x, layers,
                                                   caches, lens, spec))
            del layers, caches, fns, plain
            torch.cuda.empty_cache()
        times[name] = by
    emit({"phase": "fused_family_kernel_times", "B": 8, "W": 1,
          "lens": lens.tolist(), "layers": LLAMA_LAYERS, "by_spec": times})
    main_t = {
        "llama_7b": dict(times["llama_7b"]["bf16_weights_bf16_cache"],
                         work="one Llama-2 7B layer, B 8, W 1, DECODE_LENS "
                              "(<= 1023), bf16 weights and cache (32 "
                              "layers' own)"),
        "mixtral_8x7b": dict(times["mixtral_8x7b"]["int8_weights_int8_cache"],
                             work="one Mixtral-8x7B attention half, B 8, W "
                                  "1, DECODE_LENS (<= 1023), bf16, int8 "
                                  "weights and cache (32 layers' own)")}
    return main_t


def llama_parity_phase(torch, da, fa):
    """Phase 18: fp32 Llama-2 7B widths at 4 layers (cut for time), float
    and int8 weights, each with a float and an int8 KV cache, a pool that
    forces a preemption.  Held: exact launch counts (per decode step
    unfused L decode of the cache's kind and 7 L qgemm with int8 weights,
    fused L fused layers and no decode or qgemm; per prefill L flash and
    no qgemm); the fused scheduler token-identical to the unfused one; on
    the float cache the unfused scheduler token-identical to the static
    generate; on the int8 cache each path's scheduler token-identical to
    its own static generate for every request not preempted (the
    preempted one reported); teacher-forced decode logits,
    fused and unfused, within 1e-3 of a full forward with the plain
    attention (float cache)."""
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             RequestState, SamplingParams)
    qz, qg, fd = int8_modules()
    L = LLAMA_PARITY_LAYERS
    model = llama_model("7b", num_layers=L, dtype="float32")
    plain = llama_model("7b", num_layers=L, dtype="float32",
                        attention_impl="plain")
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=8)
    report = {"phase": "fp32_llama_parity", "layers": L}
    for w8 in (False, True):
        t0 = time.perf_counter()
        engines = {"int8": InferenceEngine(model, DeepSpeedInferenceConfig(
            dtype="float32", quant={"enabled": w8}, kv_cache_dtype="int8"))}
        engines[None] = InferenceEngine(model, DeepSpeedInferenceConfig(
            dtype="float32", quant={"enabled": w8}),
            model_parameters=engines["int8"].params)
        params = engines[None].params
        torch.cuda.synchronize()
        wkey = "int8_weights" if w8 else "fp32_weights"
        report[f"{wkey}_init_s"] = time.perf_counter() - t0
        for kv, eng in engines.items():
            outs = {}
            for fused in (False, True):
                if kv or not fused:
                    static = [list(eng.generate(
                        p, max_new_tokens=MAX_NEW, fused_decode=fused)
                        [0, p.size:]) for p in prompts]
                sched = ContinuousBatchingScheduler(
                    model, params, ServingConfig(num_blocks=140,
                                                 fused_decode=fused),
                    kv_cache_dtype=kv)
                reset_int8_counts(da, qz, qg, fd, fa)
                reqs = [sched.submit(p, SamplingParams(
                    max_new_tokens=MAX_NEW)) for p in prompts]
                sched.run_until_idle()
                torch.cuda.synchronize()
                n = int8_counts(da, qz, qg, fd, fa)
                c = sched.metrics.counters
                steps, prefills = c["decode_steps"], c["prefills"]
                dec = 0 if fused else L * steps
                want = {"block_quantize_int8": 0,
                        "ds_flash_fwd": L * prefills,
                        "qgemm": 7 * L * steps if w8 and not fused else 0,
                        "decode_attention": 0 if kv else dec,
                        "decode_attention_int8": dec if kv else 0,
                        "ds_fused_layer": L * steps if fused else 0}
                outs[fused] = [list(r.output_ids) for r in reqs]
                key = f"{wkey}_{'int8' if kv else 'float'}_kv_" \
                      f"{'fused' if fused else 'unfused'}"
                diff = first_diffs(prompts, reqs, static)
                preempted = [int(p.size) for p, r in zip(prompts, reqs)
                             if r.num_preemptions]
                kept = {n0: t for n0, t in diff.items()
                        if n0 not in preempted}
                report[key] = {"prefills": prefills, "decode_steps": steps,
                               "preemptions": c["preemptions"],
                               "preempted_prompt_lens": preempted,
                               "launches": n, "want": want,
                               "static_first_diff_by_prompt_len": diff}
                check(all(r.state == RequestState.FINISHED
                          and r.num_generated == MAX_NEW for r in reqs),
                      f"fp32 llama {key}: not every request finished")
                check(c["preemptions"] >= 1,
                      f"fp32 llama {key}: the pool did not force a "
                      "preemption")
                check(n == want, f"fp32 llama {key}: launches {n} != {want}")
                if fused:
                    same = outs[True] == outs[False]
                    report[key]["token_identical_to_unfused"] = same
                    check(same, f"fp32 llama {key}: fused tokens != "
                          "unfused tokens")
                # float cache: the unfused scheduler is the static
                # generate, every request.  int8 cache: each path's
                # scheduler is its own static generate for every request
                # not preempted (a resumed request re-prefills its
                # generated tail, whose K/V then come from the prefill's
                # GEMMs, and one last bit can move a cache code)
                if kv:
                    check(not kept, f"fp32 llama {key}: scheduler != static "
                          f"generate for requests not preempted (prompt "
                          f"length: first differing token) {diff}")
                elif not fused:
                    check(not diff, f"fp32 llama {key}: scheduler != static "
                          f"generate (prompt length: first differing token) "
                          f"{diff}")
                del sched
        # teacher-forced decode (float cache), fused and unfused, against
        # a full forward with the plain attention
        worst = 0.0
        with torch.no_grad():
            for i in (1, 5):
                toks = list(prompts[i]) + outs[False][i][:-1]
                n0 = len(prompts[i])
                ids = torch.tensor([toks], dtype=torch.int32, device="cuda")
                with plain_head():
                    full = plain.apply(params, {"input_ids": ids})[:, -1]
                for fused in (False, True):
                    cache = model.init_cache_fn(1, -(-len(toks) // 64) * 64,
                                                torch.float32, "cuda")
                    logits, cache = model.prefill_fn(
                        params, {"input_ids": ids[:, :n0]}, cache)
                    for pos in range(n0, len(toks)):
                        logits, cache = model.decode_fn(
                            params, ids[:, pos], cache,
                            torch.tensor([pos], dtype=torch.int32,
                                         device="cuda"), fused=fused)
                    worst = max(worst, float((logits - full).abs().max()))
        report[f"{wkey}_teacher_forced_max_abs_err"] = worst
        check(worst <= 1e-3, f"fp32 llama {wkey}: decode logits differ from "
              f"the plain full forward by {worst}")
        del engines, params
        torch.cuda.empty_cache()
    report["tol"] = 1e-3
    emit(report)


def llama_http_phase(torch, da, fa):
    """Phase 19, the slice's main path: init_inference(llama_model("7b"))
    at all 32 layers and full width, bf16, over HTTP, two engines (bf16
    weights and cache; int8 weights and an int8 KV cache), each served
    with fused decode off and on: the device init (seconds, quantizer
    launches, params' device bytes), then phase 5's eight requests:
    tokens/s, TTFT, TPOT, decode ms per step, launch counts, a profiled
    decode window, peak memory.  Returns ({weights: load}, {arm: run})."""
    import gc
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.models.model import QuantizedTensor
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving.scheduler import \
        ContinuousBatchingScheduler
    import deepspeed_tpu_torch as dt
    qz, qg, fd = int8_modules()
    gc.collect()
    torch.cuda.empty_cache()
    model = llama_model("7b", dtype="bfloat16",
                        num_layers=LLAMA_LAYERS)
    L = model.config.num_layers
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=1)
    out = {"phase": "bf16_llama_http", "layers": L,
           "params": model.meta["n_params"]}
    loads, runs = {}, {}
    for w8 in (False, True):
        wkey = "int8" if w8 else "bf16"
        kv = "int8" if w8 else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_int8_counts(da, qz, qg, fd, fa)
        t0 = time.perf_counter()
        eng = dt.init_inference(model, {"dtype": "bfloat16"},
                                quant={"enabled": w8}, kv_cache_dtype=kv)
        torch.cuda.synchronize()
        load = {"init_s": time.perf_counter() - t0,
                "launches": int8_counts(da, qz, qg, fd, fa),
                "params_device_bytes": nbytes(eng.params),
                "blocks_device_bytes": nbytes(eng.params["blocks"]),
                "peak_memory_allocated": torch.cuda.max_memory_allocated()}
        want_q = 7 * L if w8 else 0
        proj = [w for k, w in eng.params["blocks"].items()
                if not k.endswith("norm")]
        check(load["launches"]["block_quantize_int8"] == want_q
              and len(proj) == 7
              and all(isinstance(w, QuantizedTensor) == w8 for w in proj),
              f"llama {wkey} load: launches {load['launches']} (want "
              f"{want_q} quantizer launches, the 7 projections "
              f"{'int8' if w8 else 'bf16'})")
        loads[wkey] = load
        for fused in (False, True):
            key = f"{wkey}_{'fused' if fused else 'unfused'}"
            torch.cuda.reset_peak_memory_stats()
            sched = ContinuousBatchingScheduler(
                model, eng.params, ServingConfig(fused_decode=fused),
                kv_cache_dtype=kv)
            outs, wall_s, mbody, n, window = serve_http(
                torch, sched, prompts,
                on_start=lambda: reset_int8_counts(da, qz, qg, fd, fa),
                on_done=lambda: int8_counts(da, qz, qg, fd, fa))
            dec = "decode_attention_int8" if kv else "decode_attention"
            path = ("ds_fused_layer",) if fused else (
                (dec, "qgemm") if w8 else (dec,))
            idle = {"ds_fused_layer", "qgemm", "decode_attention",
                    "decode_attention_int8", "block_quantize_int8"} \
                - set(path)
            check(all(n[k] > 0 for k in path + ("ds_flash_fwd",))
                  and all(n[k] == 0 for k in idle),
                  f"llama http {key}: launches {n}")
            check('kernel_launches{kernel="ds_fused_layer"}' in mbody,
                  "llama http: /metrics lacks the fused-layer launch count")
            run = {**serve_report(outs, wall_s, window), "launches": n,
                   "outputs": [o["output_ids"][:8] for o in outs]}
            run["decode_profile"] = profile_decode(torch, sched, prompts)
            run["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
            runs[key] = run
            del sched
            gc.collect()
            torch.cuda.empty_cache()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    emit({**out, "engine_load": loads, **runs})
    return loads, runs


# ------------------------------------------- slice 7: NeoX, BLOOM, GPT-Neo
NEOX_LAYERS = 44            # neox:20b, nothing cut (phases 20, 22)
FAMILY_PARITY_LAYERS = 4
GPTNEO_WINDOW = 256


def slice7_counts(da, qz, qg, fd, fa):
    """:func:`int8_counts` and the decode kernel's ALiBi and windowed
    counters."""
    return {**int8_counts(da, qz, qg, fd, fa),
            "decode_attention_alibi": da.decode_attention.alibi_launches,
            "decode_attention_windowed":
            da.decode_attention.windowed_launches}


def reset_slice7_counts(da, qz, qg, fd, fa):
    reset_int8_counts(da, qz, qg, fd, fa)
    da.decode_attention.alibi_launches = 0
    da.decode_attention.windowed_launches = 0


def slice7_specs():
    """(name, spec, d_mlp, the std of the residual projections) of phase
    20's fused layer: GPT-NeoX-20B's layer (head-major QKV, 24 of 96 dims
    rotary, exact GELU, parallel residual), Pythia-160m's (hd 64, 16
    rotary dims) and BLOOM-560m's (head-major QKV, ALiBi, tanh GELU,
    serial residual); weights at the families' own init scales (0.02,
    and 0.02 / sqrt(2 L) for ``dense_w`` and ``mlp_out_w``)."""
    from deepspeed_tpu_torch.models import bloom, neox
    out = []
    for name, mod, cfg in (
            ("neox_20b", neox, neox.NeoXConfig(**neox.NEOX_SIZES["20b"])),
            ("pythia_160m", neox,
             neox.NeoXConfig(**neox.NEOX_SIZES["pythia-160m"])),
            ("bloom_560m", bloom,
             bloom.BloomConfig(**bloom.BLOOM_SIZES["560m"]))):
        out.append((name, mod.fused_spec(cfg), cfg.d_mlp,
                     0.02 / (2 * cfg.num_layers) ** 0.5))
    return out


def decode_variant_cases(torch, g, variant):
    """Phase 20's decode inputs: (B, H, KV, hd, floors or None, slopes or
    None, sm_scale) — ALiBi at BLOOM-560m's shape (B 8, H 16, hd 64) and
    at a GQA shape (H 32 over KV 8, hd 128); the window at GPT-Neo
    2.7B's (H 20, hd 128, window 256, sm_scale 1) and the same GQA
    shape, floors max(len - 256, 0) from DECODE_LENS."""
    from deepspeed_tpu_torch.models.bloom import slopes_on
    L = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    floors = torch.clamp(L - GPTNEO_WINDOW, min=0).to(torch.int32)
    if variant == "alibi":
        return [(8, 16, 16, 64, None, slopes_on(16, "cuda"), None),
                (8, 32, 8, 128, None, slopes_on(32, "cuda"), None)]
    return [(8, 20, 20, 128, floors, None, 1.0),
            (8, 32, 8, 128, floors, None, None)]


def decode_variant_inputs(torch, da, g, B, H, KV, hd, floors, dt,
                          int8_cache, S=1024):
    """q and a cache (positions below a row's floor poisoned with large
    values, so a kernel that reads one of them cannot agree)."""
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device="cuda")
    v = torch.rand(B, S, KV, hd, generator=g, device="cuda") * 2 - 1
    if floors is not None:
        below = (torch.arange(S, device="cuda")[None, :]
                 < floors[:, None])[..., None, None]
        k = torch.where(below, torch.full_like(k, 100.0), k)
        v = torch.where(below, torch.full_like(v, -100.0), v)
    if int8_cache:
        (kq, ks), (vq, vs) = da.quantize_kv(k), da.quantize_kv(v)
        return q, kq, vq, ks, vs
    return q, k.to(dt), v.to(dt), None, None


#: the decode kernel's variants at the shapes of the models that run them:
#: (H, KV, hd, sm_scale) of GPT-2 760M (float and int8 caches), BLOOM-560m
#: (ALiBi) and GPT-Neo 2.7B's local layers (window 256, sm_scale 1)
DECODE_SHAPES = {"plain": (16, 16, 96, None), "alibi": (16, 16, 64, None),
                 "windowed": (20, 20, 128, 1.0)}
#: GQA: Mixtral-8x7B's 32 query heads over 8 kv heads
DECODE_GQA = (32, 8, 128, None)


def decode_extras(torch, variant, H, floors):
    """A variant's extra arguments: BLOOM's ALiBi slopes or the floors."""
    if variant == "alibi":
        from deepspeed_tpu_torch.models.bloom import slopes_on
        return {"alibi_slopes": slopes_on(H, "cuda")}
    if variant == "windowed":
        return {"min_pos": floors}
    return {}


def decode_edge_checks(torch, da, g, variant, int8_cache, shapes):
    """The decode kernel at its chunk edges against the plain version, fp32
    and bf16 queries: with C the instance's positions per chunk
    (``chunk_positions``), rows of cache_len 0, 1, C - 1, C, C + 1, S_max
    (2 C + 64), 2 C + 1 and C + 2; the windowed variant with floors 0, 0,
    C - 1, C - 1, C, C + 1, C + 1, C + 2 (rows 2 and 7 at their length),
    the positions below a floor poisoned.  Within the tolerance (fp32 abs,
    bf16 of the output's max), finite, and a row with nothing to attend
    exact zeros.  Returns the worst held error."""
    worst = 0.0
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for H, KV, hd, sm in shapes:
            C = da.chunk_positions(hd, torch.int8 if int8_cache else dt)
            S = 2 * C + 64
            lens = [0, 1, C - 1, C, C + 1, S, 2 * C + 1, C + 2]
            L = torch.tensor(lens, dtype=torch.int32, device="cuda")
            floors = None
            if variant == "windowed":
                floors = torch.tensor(
                    [0, 0, C - 1, C - 1, C, C + 1, C + 1, C + 2],
                    dtype=torch.int32, device="cuda")
            q, k, v, ks, vs = decode_variant_inputs(
                torch, da, g, len(lens), H, KV, hd, floors, dt, int8_cache,
                S=S)
            kw = dict(sm_scale=sm, k_scale=ks, v_scale=vs,
                      **decode_extras(torch, variant, H, floors))
            o = da.decode_attention_cuda(q, k, v, L, **kw)
            r = da.decode_attention_plain(q, k, v, L, **kw)
            torch.cuda.synchronize()
            e, held = err_of(torch, o, r, dt_name)
            first = floors if floors is not None else torch.zeros_like(L)
            empty = (first >= L).nonzero().flatten().tolist()
            zeros = all(bool((o[b] == 0).all()) for b in empty)
            finite = bool(torch.isfinite(o).all())
            emit({"check": "decode_attention_chunk_edges",
                  "variant": variant, "int8_cache": int8_cache,
                  "dtype": dt_name, "shape": [len(lens), H, KV, hd, S],
                  "chunk": C, "cache_len": lens,
                  "floors": None if floors is None else floors.tolist(),
                  "max_abs_err": e, "held": held,
                  "tol": INT8_TOL[dt_name], "empty_rows_zero": zeros,
                  "finite": finite})
            check(held <= INT8_TOL[dt_name] and zeros and finite,
                  f"decode_attention chunk edges {variant} int8_cache="
                  f"{int8_cache} {dt_name} {(H, KV, hd)}: err {e} (held "
                  f"{held}), empty rows zero {zeros}, finite {finite}")
            worst = max(worst, held)
    return worst


def decode_identity_checks(torch, da):
    """decode_identity: a row's bits follow only its own inputs.  Row 0
    (700 positions; floor 444 for the window) bit-identical at B 1 and at
    B 8 (the other rows at other lengths), at S_max 1024 and 2048, and
    two launches at S_max 2048 bit-identical; every variant at its
    model's shape, float and int8 caches, fp32 and bf16."""
    g = torch.Generator(device="cuda").manual_seed(97)
    L = torch.tensor([700, 1, 1024, 300, 5, 999, 64, 129],
                     dtype=torch.int32, device="cuda")
    for variant, (H, KV, hd, sm) in DECODE_SHAPES.items():
        floors = None
        if variant == "windowed":
            floors = torch.clamp(L - GPTNEO_WINDOW, min=0).to(torch.int32)
        for c8 in (False, True):
            for dt_name in ("float32", "bfloat16"):
                q, k, v, ks, vs = decode_variant_inputs(
                    torch, da, g, 8, H, KV, hd, floors,
                    getattr(torch, dt_name), c8, S=2048)

                def run(nb, ns):
                    def cut(x):
                        return None if x is None \
                            else x[:nb, :ns].contiguous()
                    fl = None if floors is None else floors[:nb].contiguous()
                    return da.decode_attention_cuda(
                        q[:nb].contiguous(), cut(k), cut(v),
                        L[:nb].contiguous(), sm_scale=sm, k_scale=cut(ks),
                        v_scale=cut(vs), **decode_extras(torch, variant, H,
                                                         fl))
                o8, o1, o2, o2b = run(8, 1024), run(1, 1024), run(8, 2048), \
                    run(8, 2048)
                torch.cuda.synchronize()
                by_b = torch.equal(o8[:1], o1)
                by_s = torch.equal(o8[0], o2[0])
                again = torch.equal(o2, o2b)
                emit({"check": "decode_identity", "variant": variant,
                      "int8_cache": c8, "dtype": dt_name,
                      "shape": [8, H, KV, hd], "row_0_len": 700,
                      "row_0_at_B_1_vs_B_8_bit_identical": by_b,
                      "row_0_at_S_max_1024_vs_2048_bit_identical": by_s,
                      "two_launches_bit_identical": again})
                check(by_b and by_s and again,
                      f"decode_identity {variant} int8_cache={c8} "
                      f"{dt_name}: B 1 vs 8 {by_b}, S_max 1024 vs 2048 "
                      f"{by_s}, two launches {again}")


def decode_launch_checks(torch, da):
    """One kernel a call for every variant and cache type at its model's
    shape and at the GQA shape (B 8, S_max 1024, DECODE_LENS, bf16): the
    kernel records a profiler window sees over 20 calls, read at the
    start of the smoke, where the profiler sees every record (a window
    that reads otherwise is read again, up to three times)."""
    g = torch.Generator(device="cuda").manual_seed(77)
    L = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    floors = torch.clamp(L - GPTNEO_WINDOW, min=0).to(torch.int32)
    for variant, shape in (*DECODE_SHAPES.items(), ("gqa", DECODE_GQA)):
        H, KV, hd, sm = shape
        fl = floors if variant == "windowed" else None
        for c8 in (False, True):
            q, k, v, ks, vs = decode_variant_inputs(
                torch, da, g, 8, H, KV, hd, fl, torch.bfloat16, c8)
            kw = dict(sm_scale=sm, k_scale=ks, v_scale=vs,
                      **decode_extras(torch, variant, H, fl))
            for _ in range(3):
                _, n = device_ms(torch, [
                    lambda: da.decode_attention_cuda(q, k, v, L, **kw)],
                    reps=20, one_kernel=True)
                if n == 1:
                    break
            emit({"check": "decode_kernels_per_call", "variant": variant,
                  "int8_cache": c8, "shape": [8, H, KV, hd, 1024],
                  "kernels_per_call": n})
            check(n == 1, f"decode_attention {variant} int8_cache={c8}: "
                  f"{n} kernels a call, not 1")


def decode_layer_times(torch, F, da, H, KV, hd, layers, variant="plain",
                       sm=None, int8_cache=False):
    """One layer's decode kernel timed as a decode step meets it: device
    time (profiler) over ``layers`` layers' own caches (cold in L2), B 8,
    S_max 1024, DECODE_LENS (windowed: floors 256 below), bf16 queries;
    beside the plain version, SDPA with the same mask (float cache; context
    only, the port never calls it), the bound (bytes read once) and the
    wrapper's host ms a call, and the kernels a call each profiler window
    saw (late in a whole smoke a window can lose records: phase 2's
    ``decode_launch_checks`` holds one kernel a call while the profiler
    sees every record)."""
    g = torch.Generator(device="cuda").manual_seed(71 + hd + layers)
    B, dt = 8, torch.bfloat16
    L = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    floors = None
    if variant == "windowed":
        floors = torch.clamp(L - GPTNEO_WINDOW, min=0).to(torch.int32)
    caches = [decode_variant_inputs(torch, da, g, B, H, KV, hd, floors, dt,
                                    int8_cache) for _ in range(layers)]
    q = caches[0][0]
    ex = decode_extras(torch, variant, H, floors)
    kw = [dict(sm_scale=sm, k_scale=c[3], v_scale=c[4], **ex)
          for c in caches]
    kern = [lambda c=c, w=w: da.decode_attention_cuda(q, c[1], c[2], L, **w)
            for c, w in zip(caches, kw)]
    plain = [lambda c=c, w=w: da.decode_attention_plain(q, c[1], c[2], L,
                                                        **w)
             for c, w in zip(caches, kw)]
    t = timed(torch, kern, plain)
    first = floors if floors is not None else torch.zeros_like(L)
    n = int((L - first).sum())       # the positions the rows attend
    per_pos = 2 * KV * hd * (1 if int8_cache else 2) \
        + (2 * KV * 4 if int8_cache else 0)
    t["bound_ms"], t["bound_by"] = bound_of(
        n * per_pos + 2 * B * H * hd * 2 + 4 * B
        + (4 * H if variant == "alibi" else 0)
        + (4 * B if variant == "windowed" else 0),
        4 * n * H * hd, BF16_FLOPS)
    t.update(attended_positions=n, shape=[B, H, KV, hd, 1024],
             layers=layers, chunk=da.chunk_positions(
                 hd, torch.int8 if int8_cache else dt), library_ms=None,
             host_ms_per_call=host_ms_per_call(torch, kern[0], n=100))
    if not int8_cache:
        pos = torch.arange(1024, device="cuda")
        valid = (pos[None, :] < L[:, None]) & (pos[None, :]
                                               >= first[:, None])
        if variant == "alibi":
            mask = torch.where(valid[:, None, None, :],
                               ex["alibi_slopes"][None, :, None, None]
                               * pos.float(), float("-inf")).to(dt)
        else:
            mask = valid[:, None, None, :]
        kt = [(c[1].transpose(1, 2), c[2].transpose(1, 2)) for c in caches]
        qt = q[:, :, None]
        t["library_ms"], t["library_kernels_per_call"] = device_ms(torch, [
            lambda a=a: F.scaled_dot_product_attention(
                qt, a[0], a[1], attn_mask=mask, scale=sm,
                enable_gqa=H != KV) for a in kt])
        del kt
    del caches, kern, plain
    torch.cuda.empty_cache()
    return t


def decode_variant_phase(torch, F, da):
    """Phase 20, decode: the ALiBi and windowed variants, each over a
    float and an int8 cache, fp32 and bf16 queries, against the plain
    version, at DECODE_LENS and at the chunk edges; then each timed in
    bf16 over the model's own layers' caches (ALiBi: 24 BLOOM-560m
    layers; window: 32 GPT-Neo 2.7B local layers) beside the plain
    version, SDPA with the same mask and the bound.
    Returns ({variant: worst held error}, {variant: {cache: times}})."""
    g = torch.Generator(device="cuda").manual_seed(71)
    L = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    worst, times = {}, {}
    for variant in ("alibi", "windowed"):
        worst[variant] = 0.0
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            for B, H, KV, hd, floors, slopes, sm in decode_variant_cases(
                    torch, g, variant):
                for c8 in (False, True):
                    q, k, v, ks, vs = decode_variant_inputs(
                        torch, da, g, B, H, KV, hd, floors, dt, c8)
                    kw = dict(sm_scale=sm, k_scale=ks, v_scale=vs,
                              alibi_slopes=slopes, min_pos=floors)
                    o = da.decode_attention_cuda(q, k, v, L, **kw)
                    r = da.decode_attention_plain(q, k, v, L, **kw)
                    torch.cuda.synchronize()
                    e, held = err_of(torch, o, r, dt_name)
                    emit({"check": f"decode_attention_{variant}",
                          "dtype": dt_name, "int8_cache": c8,
                          "shape": [B, H, KV, hd, 1024], "max_abs_err": e,
                          "held": held, "tol": INT8_TOL[dt_name],
                          "finite": bool(torch.isfinite(o).all())})
                    check(held <= INT8_TOL[dt_name]
                          and bool(torch.isfinite(o).all()),
                          f"decode_attention {variant} {dt_name} int8_cache="
                          f"{c8} {(B, H, KV, hd)}: err {e} (held {held})")
                    worst[variant] = max(worst[variant], held)
        for c8 in (False, True):
            worst[variant] = max(worst[variant], decode_edge_checks(
                torch, da, g, variant, c8,
                [DECODE_SHAPES[variant], DECODE_GQA]))
        # times: bf16, the model's own shape, one cache per layer
        H, KV, hd, sm = DECODE_SHAPES[variant]
        layers = 24 if variant == "alibi" else 32
        by_cache = {"int8" if c8 else "bf16": decode_layer_times(
            torch, F, da, H, KV, hd, layers, variant, sm, c8)
            for c8 in (False, True)}
        times[variant] = by_cache
    emit({"phase": "decode_variant_kernel_times", "lens": DECODE_LENS,
          "alibi_work": "one BLOOM-560m layer: B 8, H 16, hd 64, S_max "
                        "1024, bf16 query (24 layers' own caches)",
          "windowed_work": "one GPT-Neo 2.7B local layer: B 8, H 20, hd "
                           "128, window 256, sm_scale 1, bf16 query (32 "
                           "layers' own caches)", **times})
    return worst, times


def slice7_fused_phase(torch, qz, da, fd):
    """Phase 20, fused: the fused layer at the NeoX-20B, Pythia-160m and
    BLOOM-560m specs against its plain version at B 8, W 1 and 4, float
    / int8 weights x float / int8 cache, fp32 and bf16; then timed in
    bf16 at W 1 over the model's own layers (NeoX-20B: 44, bf16 and
    int8 weights and cache; BLOOM-560m: 24, bf16) beside the plain
    version and the bound.  Returns (worst held error by spec, times by
    spec)."""
    from deepspeed_tpu_torch.models.bloom import slopes_on
    g = torch.Generator(device="cuda").manual_seed(72)
    worst = {}
    specs = slice7_specs()
    for name, spec, M, res in specs:
        KV, hd, D = spec.num_kv_heads, spec.head_dim, spec.d_model
        sl = slopes_on(spec.num_heads, "cuda") if spec.alibi else None
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            for w8 in (False, True):
                cw = spec_weights(torch, g, spec, M, dt, w8, qz, res)
                for c8 in (False, True):
                    k, v, ks, vs = spec_cache(torch, g, dt, c8, da, KV, hd)
                    for W in FUSED_W:
                        lens = torch.tensor([min(n, 1024 - W)
                                             for n in DECODE_LENS],
                                            dtype=torch.int32, device="cuda")
                        x = torch.randn(8, W, D, generator=g,
                                        device="cuda").to(dt)
                        got = fd.fused_layer_cuda(x, cw, k, v, lens, spec,
                                                  ks, vs, sl)
                        ref = fd.fused_layer_plain(x, cw, k, v, lens, spec,
                                                   ks, vs, sl)
                        row = {"check": "ds_fused_layer", "spec": name,
                               "dtype": dt_name, "int8_weights": w8,
                               "int8_cache": c8, "W": W,
                               "tol": INT8_TOL[dt_name]}
                        ok, held = fused_check(torch, got, ref, dt_name, row)
                        worst[name] = max(worst.get(name, 0.0), held)
                        emit(row)
                        check(ok, f"ds_fused_layer {name} {dt_name} "
                              f"w8={w8} c8={c8} W={W}: {row}")
                    del k, v, ks, vs
                del cw
        torch.cuda.empty_cache()
    dt = torch.bfloat16
    lens = torch.tensor([min(n, 1023) for n in DECODE_LENS],
                        dtype=torch.int32, device="cuda")
    configs = {"neox_20b": (NEOX_LAYERS, ((False, False), (True, True))),
               "bloom_560m": (24, ((False, False),))}
    times = {}
    for name, spec, M, res in specs:
        if name not in configs:
            continue
        n_layers, arms = configs[name]
        sl = slopes_on(spec.num_heads, "cuda") if spec.alibi else None
        x = torch.randn(8, 1, spec.d_model, generator=g, device="cuda").to(dt)
        by = {}
        for w8, c8 in arms:
            layers = [spec_weights(torch, g, spec, M, dt, w8, qz, res)
                      for _ in range(n_layers)]
            caches = [spec_cache(torch, g, dt, c8, da, spec.num_kv_heads,
                                 spec.head_dim) for _ in range(n_layers)]
            fns = [lambda cw=cw, c=c: fd.fused_layer_cuda(
                x, cw, c[0], c[1], lens, spec, c[2], c[3], sl)
                for cw, c in zip(layers, caches)]
            plain = [lambda cw=cw, c=c: fd.fused_layer_plain(
                x, cw, c[0], c[1], lens, spec, c[2], c[3], sl)
                for cw, c in zip(layers, caches)]
            b, f, wbytes, cbytes = fused_bound(spec, M, layers[0], lens, c8)
            key = f"{'int8' if w8 else 'bf16'}_weights_" \
                  f"{'int8' if c8 else 'bf16'}_cache"
            by[key] = dict(timed(torch, fns, plain),
                           bound_ms=b, bound_by=f, weight_bytes=wbytes,
                           cache_bytes=cbytes, library_ms=None,
                           phase_us=fused_phase_us(torch, fd, x, layers,
                                                   caches, lens, spec, sl))
            del layers, caches, fns, plain
            torch.cuda.empty_cache()
        times[name] = by
    emit({"phase": "slice7_fused_kernel_times", "B": 8, "W": 1,
          "lens": lens.tolist(), "by_spec": times})
    return worst, times


def slice7_kernel_phase(torch, F, da):
    """Phase 20: the decode kernel's ALiBi and windowed variants and the
    fused layer's NeoX and BLOOM specs against their plain versions, then
    timed.  Returns (worst held error by variant, times by variant)."""
    qz, qg, fd = int8_modules()
    dec_err, dec_t = decode_variant_phase(torch, F, da)
    torch.cuda.empty_cache()
    fus_err, fus_t = slice7_fused_phase(torch, qz, da, fd)
    return ({"decode_attention_alibi": dec_err["alibi"],
             "decode_attention_windowed": dec_err["windowed"],
             "ds_fused_layer_neox_spec": fus_err["neox_20b"],
             "ds_fused_layer_pythia_spec": fus_err["pythia_160m"],
             "ds_fused_layer_bloom_spec": fus_err["bloom_560m"]},
            {"decode_attention_alibi": dict(
                dec_t["alibi"]["bf16"], times_by_cache=dec_t["alibi"],
                work="one BLOOM-560m layer, B 8, H 16, hd 64, S_max 1024, "
                     "DECODE_LENS, bf16 (24 layers' own caches)"),
             "decode_attention_windowed": dict(
                 dec_t["windowed"]["bf16"], times_by_cache=dec_t["windowed"],
                 work="one GPT-Neo 2.7B local layer, B 8, H 20, hd 128, "
                      "window 256, DECODE_LENS, bf16 (32 layers' own "
                      "caches)"),
             "ds_fused_layer_neox_spec": dict(
                 fus_t["neox_20b"]["bf16_weights_bf16_cache"],
                 times_by_config=fus_t["neox_20b"],
                 work="one GPT-NeoX-20B layer, B 8, W 1, DECODE_LENS "
                      "(<= 1023), bf16 weights and cache (44 layers' own)"),
             "ds_fused_layer_bloom_spec": dict(
                 fus_t["bloom_560m"]["bf16_weights_bf16_cache"],
                 work="one BLOOM-560m layer, B 8, W 1, DECODE_LENS "
                      "(<= 1023), bf16 weights and cache (24 layers' "
                      "own)")})


def slice7_families(layers=None):
    """{family: (model constructor, size, depth overrides)} of phase 21 at
    the published widths; ``layers`` cuts the depth (GPT-Neo keeps its
    alternating global / local pattern)."""
    from deepspeed_tpu_torch.models.bloom import bloom_model
    from deepspeed_tpu_torch.models.gptneo import gptneo_model
    from deepspeed_tpu_torch.models.neox import neox_model
    depth = {} if layers is None else {"num_layers": layers}
    return {"neox_20b": (neox_model, "20b", depth),
            "bloom_560m": (bloom_model, "560m", depth),
            "gptneo_2.7b": (gptneo_model, "2.7b", depth)}


def slice7_want(family, L, prefills, steps, w8, kv, fused):
    """Exact launches of a serving run: NeoX per prefill L flash, per
    decode step L decode of the cache's kind or L fused; BLOOM no flash
    (the ALiBi einsum), L ALiBi decode or L fused; GPT-Neo no flash, L
    windowed decode (every layer: floor 0 on the global ones); unfused
    with int8 weights 4 L qgemm a step besides."""
    plain_dec = family == "neox_20b" and not fused
    dec = L * steps
    return {"block_quantize_int8": 0,
            "ds_flash_fwd": L * prefills if family == "neox_20b" else 0,
            "qgemm": 4 * dec if w8 and not fused else 0,
            "decode_attention": dec if plain_dec and not kv else 0,
            "decode_attention_int8": dec if plain_dec and kv else 0,
            "decode_attention_alibi":
            dec if family == "bloom_560m" and not fused else 0,
            "decode_attention_windowed": dec if family == "gptneo_2.7b"
            else 0,
            "ds_fused_layer": dec if fused else 0}


def norm_row_dependence(torch):
    """Whether a row's norm output changes with the rows beside it on the
    card (row 0 at B 2, 4 and 8 against B 1, fp32, the widths of BLOOM-
    560m and mixtral:1b-moe, GPT-2 760M, GPT-Neo 2.7B, Llama-2 7B /
    Mixtral-8x7B and NeoX-20B): LayerNorm and RMSNorm by torch's ``mean``
    (the reference's arithmetic), the port's LayerNorm (``F.layer_norm``
    on the card) and RMSNorm (``F.rms_norm`` on the card), cuBLAS's fp32
    ``x @ W`` at [D, D], and the port's fp32 projection (``qdot``: one
    product a row at decode sizes)."""
    from deepspeed_tpu_torch.models.gpt2 import _layer_norm
    from deepspeed_tpu_torch.models.llama import _rms_norm
    from deepspeed_tpu_torch.models.model import qdot

    def mean_ln(t, s, b):
        mu = t.mean(-1, keepdim=True)
        var = ((t - mu) ** 2).mean(-1, keepdim=True)
        return (t - mu) * torch.rsqrt(var + 1e-5) * s + b

    def mean_rms(t, s):
        return t * torch.rsqrt((t * t).mean(-1, keepdim=True) + 1e-5) * s
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for D in (1024, 1536, 2560, 4096, 6144):
        x = torch.randn(8, 1, D, generator=g, device="cuda")
        s = torch.rand(D, generator=g, device="cuda") + 0.5
        b = torch.randn(D, generator=g, device="cuda") * 0.1
        w = torch.randn(D, D, generator=g, device="cuda") * 0.02
        for name, fn in (("mean_layer_norm", lambda t: mean_ln(t, s, b)),
                         ("port_layer_norm", lambda t: _layer_norm(
                             t, s, b, 1e-5)),
                         ("mean_rms_norm", lambda t: mean_rms(t, s)),
                         ("port_rms_norm", lambda t: _rms_norm(t, s, 1e-5)),
                         ("cublas_fp32_gemm", lambda t: t @ w),
                         ("port_fp32_qdot", lambda t: qdot(t, w))):
            ref = fn(x[:1])[0]
            out[f"{name}_d{D}"] = [bool(torch.equal(fn(x[:B])[0], ref))
                                   for B in (2, 4, 8)]
    return out


def slice7_parity_phase(torch, da, fa):
    """Phase 21: fp32 GPT-NeoX-20B, BLOOM-560m and GPT-Neo 2.7B at their
    published widths and 4 layers (GPT-Neo: 2 global, 2 local), fp32
    and int8 weights x float and int8 KV cache, NeoX and BLOOM with
    fused decode off and on, a pool that forces a preemption.  Held:
    exact launch counts (:func:`slice7_want`); the fused scheduler
    token-identical to the unfused one; on the float cache the unfused
    scheduler token-identical to the static generate; on the int8 cache
    each path's scheduler token-identical to its own static generate for
    every request not preempted; teacher-forced decode logits (float
    cache, each path) within 1e-3 of a full forward with plain
    attention."""
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             RequestState, SamplingParams)
    qz, qg, fd = int8_modules()
    L = FAMILY_PARITY_LAYERS
    report = {"phase": "fp32_slice7_parity", "layers": L,
              "row_0_equal_at_B_2_4_8": norm_row_dependence(torch)}
    emit({"phase": "row_dependence_slice7",
          "row_0_equal_at_B_2_4_8": report["row_0_equal_at_B_2_4_8"]})
    check(all(all(v) for k, v in report["row_0_equal_at_B_2_4_8"]
              .items() if k.startswith("port_")),
          "the port's LayerNorm, RMSNorm or fp32 decode projection changes "
          f"a row's bits with the rows beside it: "
          f"{report['row_0_equal_at_B_2_4_8']}")
    for family, (make, size, depth) in slice7_families(L).items():
        model = make(size, dtype="float32", **depth)
        plain = (make(size, dtype="float32", attention_impl="plain", **depth)
                 if family == "neox_20b" else model)
        has_fused = model.fused_spec is not None
        prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=21)
        for w8 in (False, True):
            t0 = time.perf_counter()
            engines = {"int8": InferenceEngine(
                model, DeepSpeedInferenceConfig(
                    dtype="float32", quant={"enabled": w8},
                    kv_cache_dtype="int8"))}
            engines[None] = InferenceEngine(
                model, DeepSpeedInferenceConfig(dtype="float32",
                                                quant={"enabled": w8}),
                model_parameters=engines["int8"].params)
            params = engines[None].params
            torch.cuda.synchronize()
            wkey = f"{family}_{'int8' if w8 else 'fp32'}_weights"
            report[f"{wkey}_init_s"] = time.perf_counter() - t0
            outs = {}
            for kv, eng in engines.items():
                for fused in ((False, True) if has_fused else (False,)):
                    static = [list(eng.generate(
                        p, max_new_tokens=MAX_NEW, fused_decode=fused)
                        [0, p.size:]) for p in prompts] \
                        if kv or not fused else None
                    sched = ContinuousBatchingScheduler(
                        model, params, ServingConfig(num_blocks=140,
                                                     fused_decode=fused),
                        kv_cache_dtype=kv)
                    reset_slice7_counts(da, qz, qg, fd, fa)
                    reqs = [sched.submit(p, SamplingParams(
                        max_new_tokens=MAX_NEW)) for p in prompts]
                    sched.run_until_idle()
                    torch.cuda.synchronize()
                    n = slice7_counts(da, qz, qg, fd, fa)
                    c = sched.metrics.counters
                    want = slice7_want(family, model.config.num_layers,
                                       c["prefills"], c["decode_steps"], w8,
                                       kv, fused)
                    key = f"{wkey}_{'int8' if kv else 'float'}_kv_" \
                          f"{'fused' if fused else 'unfused'}"
                    got = [list(r.output_ids) for r in reqs]
                    outs[(kv, fused)] = got
                    preempted = [int(p.size) for p, r in zip(prompts, reqs)
                                 if r.num_preemptions]
                    row = {"prefills": c["prefills"],
                           "decode_steps": c["decode_steps"],
                           "preemptions": c["preemptions"],
                           "preempted_prompt_lens": preempted,
                           "launches": n, "want": want}
                    check(all(r.state == RequestState.FINISHED
                              and r.num_generated == MAX_NEW for r in reqs),
                          f"fp32 {key}: not every request finished")
                    check(c["preemptions"] >= 1,
                          f"fp32 {key}: the pool did not force a preemption")
                    check(n == want, f"fp32 {key}: launches {n} != {want}")
                    if static is not None:
                        diff = first_diffs(prompts, reqs, static)
                        row["static_first_diff_by_prompt_len"] = diff
                        kept = {n0: t for n0, t in diff.items()
                                if n0 not in preempted}
                        # GPT-Neo, fp32 weights, int8 cache: reported.
                        # cuBLAS's fp32 GEMM rows change with M (the
                        # row_0_equal report), so new K/V codes flip by a
                        # step between the 8-row and the one-row decode,
                        # and the unscaled scores turn them into other
                        # tokens; int8 weights (qgemm rows are independent
                        # of M) hold it
                        held = not (kv and family == "gptneo_2.7b"
                                    and not w8)
                        row["static_identity_held"] = held
                        check(not held or not (kept if kv else diff),
                              f"fp32 {key}: scheduler != static generate "
                              f"(prompt length: first differing token) "
                              f"{diff}")
                    if fused:
                        same = got == outs[(kv, False)]
                        row["token_identical_to_unfused"] = same
                        check(same, f"fp32 {key}: fused tokens != unfused")
                    report[key] = row
                    del sched
            # teacher-forced decode (float cache) against a full forward
            # with plain attention
            worst = 0.0
            with torch.no_grad():
                for i in (1, 5):
                    toks = list(prompts[i]) + outs[(None, False)][i][:-1]
                    n0 = len(prompts[i])
                    ids = torch.tensor([toks], dtype=torch.int32,
                                       device="cuda")
                    with plain_head():
                        full = plain.apply(params,
                                           {"input_ids": ids})[:, -1]
                    for fused in ((False, True) if has_fused else (False,)):
                        cache = model.init_cache_fn(
                            1, -(-len(toks) // 64) * 64, torch.float32,
                            "cuda")
                        logits, cache = model.prefill_fn(
                            params, {"input_ids": ids[:, :n0]}, cache)
                        for pos in range(n0, len(toks)):
                            logits, cache = model.decode_fn(
                                params, ids[:, pos], cache,
                                torch.tensor([pos], dtype=torch.int32,
                                             device="cuda"), fused=fused)
                        worst = max(worst,
                                    float((logits - full).abs().max()))
            report[f"{wkey}_teacher_forced_max_abs_err"] = worst
            check(worst <= 1e-3, f"fp32 {wkey}: decode logits differ from "
                  f"the plain full forward by {worst}")
            del engines, params
            torch.cuda.empty_cache()
    report["tol"] = 1e-3
    emit(report)


def family_http(torch, da, fa, model, label, arms, load_quantizer):
    """Serve ``model`` (bf16) over HTTP in each of ``arms`` ((int8
    weights and cache, fused) pairs; the engines in arm order, each
    freed before the next): the device init (seconds, quantizer
    launches == ``load_quantizer`` with int8 weights, params' device
    bytes), then phase 5's eight requests per arm: tokens/s, TTFT, TPOT,
    decode ms per step, launches, a profiled decode window, peak memory.
    Returns ({weights: load}, {arm: run})."""
    import gc
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving.scheduler import \
        ContinuousBatchingScheduler
    import deepspeed_tpu_torch as dt
    qz, qg, fd = int8_modules()
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=1)
    loads, runs = {}, {}
    for w8 in sorted({w for w, _ in arms}):
        wkey = "int8" if w8 else "bf16"
        kv = "int8" if w8 else None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_slice7_counts(da, qz, qg, fd, fa)
        t0 = time.perf_counter()
        eng = dt.init_inference(model, {"dtype": "bfloat16"},
                                quant={"enabled": w8}, kv_cache_dtype=kv)
        torch.cuda.synchronize()
        load = {"init_s": time.perf_counter() - t0,
                "launches": slice7_counts(da, qz, qg, fd, fa),
                "params_device_bytes": nbytes(eng.params),
                "blocks_device_bytes": nbytes(eng.params["blocks"]),
                "peak_memory_allocated": torch.cuda.max_memory_allocated()}
        check(load["launches"]["block_quantize_int8"]
              == (load_quantizer if w8 else 0),
              f"{label} {wkey} load: launches {load['launches']}")
        loads[wkey] = load
        for fused in [f for w, f in arms if w == w8]:
            key = f"{wkey}_{'fused' if fused else 'unfused'}"
            torch.cuda.reset_peak_memory_stats()
            sched = ContinuousBatchingScheduler(
                model, eng.params, ServingConfig(fused_decode=fused),
                kv_cache_dtype=kv)
            outs, wall_s, mbody, n, window = serve_http(
                torch, sched, prompts,
                on_start=lambda: reset_slice7_counts(da, qz, qg, fd, fa),
                on_done=lambda: slice7_counts(da, qz, qg, fd, fa))
            run = {**serve_report(outs, wall_s, window), "launches": n,
                   "outputs": [o["output_ids"][:8] for o in outs]}
            run["decode_profile"] = profile_decode(torch, sched, prompts)
            run["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
            runs[key] = run
            del sched
            gc.collect()
            torch.cuda.empty_cache()
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    return loads, runs


def check_path(label, key, n, path):
    """The run launched each kernel of ``path`` and none of the other
    serving kernels (the flash forward aside: prefill's)."""
    serving = {"ds_fused_layer", "qgemm", "decode_attention",
               "decode_attention_int8", "decode_attention_alibi",
               "decode_attention_windowed", "block_quantize_int8"}
    check(all(n[k] > 0 for k in path)
          and all(n[k] == 0 for k in serving - set(path)),
          f"{label} http {key}: launches {n} (want {path} and no other)")


def neox_http_phase(torch, da, fa):
    """Phase 22, the slice's main path: init_inference(neox_model("20b"))
    at all 44 layers and full width, bf16, over HTTP: bf16 fused off and
    on, then int8 weights + int8 KV cache fused on."""
    from deepspeed_tpu_torch.models.neox import neox_model
    model = neox_model("20b", dtype="bfloat16", num_layers=NEOX_LAYERS)
    L = model.config.num_layers
    loads, runs = family_http(
        torch, da, fa, model, "neox",
        ((False, False), (False, True), (True, True)), 4 * L)
    check_path("neox", "bf16_unfused", runs["bf16_unfused"]["launches"],
               ("decode_attention", "ds_flash_fwd"))
    check_path("neox", "bf16_fused", runs["bf16_fused"]["launches"],
               ("ds_fused_layer", "ds_flash_fwd"))
    check_path("neox", "int8_fused", runs["int8_fused"]["launches"],
               ("ds_fused_layer", "ds_flash_fwd"))
    emit({"phase": "bf16_neox_http", "layers": L,
          "params": model.meta["n_params"], "engine_load": loads, **runs})
    return loads, runs


def bloom_gptneo_http_phase(torch, da, fa):
    """Phase 23: BLOOM-560m (bf16 fused off and on; int8 weights + int8
    cache unfused: ALiBi over the int8 cache) and GPT-Neo 2.7B (bf16;
    int8 weights + int8 cache), all layers, over HTTP."""
    from deepspeed_tpu_torch.models.bloom import bloom_model
    from deepspeed_tpu_torch.models.gptneo import gptneo_model
    out = {}
    model = bloom_model("560m", dtype="bfloat16")
    L = model.config.num_layers
    loads, runs = family_http(
        torch, da, fa, model, "bloom",
        ((False, False), (False, True), (True, False)), 4 * L)
    check_path("bloom", "bf16_unfused", runs["bf16_unfused"]["launches"],
               ("decode_attention_alibi",))
    check_path("bloom", "bf16_fused", runs["bf16_fused"]["launches"],
               ("ds_fused_layer",))
    check_path("bloom", "int8_unfused", runs["int8_unfused"]["launches"],
               ("decode_attention_alibi", "qgemm"))
    out["bloom_560m"] = {"layers": L, "params": model.meta["n_params"],
                         "engine_load": loads, **runs}
    model = gptneo_model("2.7b", dtype="bfloat16")
    L = model.config.num_layers
    loads, runs = family_http(torch, da, fa, model, "gptneo",
                              ((False, False), (True, False)), 4 * L)
    check_path("gptneo", "bf16_unfused", runs["bf16_unfused"]["launches"],
               ("decode_attention_windowed",))
    check_path("gptneo", "int8_unfused", runs["int8_unfused"]["launches"],
               ("decode_attention_windowed", "qgemm"))
    out["gptneo_2.7b"] = {"layers": L, "params": model.meta["n_params"],
                          "engine_load": loads, **runs}
    emit({"phase": "bf16_bloom_gptneo_http", **out})
    return out


# ------------------------------------------- MoE training (slice 8)
#: mixtral:1b-moe (``MIXTRAL_SIZES["1b-moe"]``) and bench.py's MoE
#: training cell (``bench.py:57-63``: seq 1024, micro-batch 8): T 8192
#: tokens, R 16,384 routed rows a micro-step
MT_D, MT_F, MT_E, MT_K = 1024, 3584, 8, 2
MT_L, MT_H, MT_KV, MT_HD = 8, 16, 8, 64
MT_B, MT_S = 8, 1024
MT_R = MT_B * MT_S * MT_K
#: the expert projections: name -> (K, N) of the forward GEMM
MT_SHAPES = {"gate_in": (MT_D, MT_F), "out": (MT_F, MT_D)}
#: phase 25 (fp32 parity), cut for time: 2 layers, micro 2, gas 2, S 512
MT_PARITY = dict(layers=2, micro=2, gas=2, seq=512, steps=3)


def moe_train_counts(gg, fa):
    return {"ds_ggemm": gg.ds_ggemm.launches,
            "ds_ggemm_t": gg.ds_ggemm.transpose_launches,
            "ds_tgmm": gg.ds_tgmm.launches,
            "ds_ggemm_slots": gg.ds_ggemm_slots.launches,
            **unaligned_counts(gg), **launch_counts(fa)}


def unaligned_counts(gg):
    """bf16 grouped launches that the wrapper's shape rule sent to the
    layout_tile kernels (none on a main path)."""
    return {"ds_ggemm_unaligned": gg.ds_ggemm.unaligned_launches,
            "ds_ggemm_t_unaligned": gg.ds_ggemm.unaligned_transpose_launches,
            "ds_tgmm_unaligned": gg.ds_tgmm.unaligned_launches}


def reset_moe_train_counts(gg, fa):
    gg.ds_ggemm.launches = gg.ds_ggemm.transpose_launches = 0
    gg.ds_tgmm.launches = gg.ds_ggemm_slots.launches = 0
    gg.ds_ggemm.unaligned_launches = 0
    gg.ds_ggemm.unaligned_transpose_launches = 0
    gg.ds_tgmm.unaligned_launches = 0
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.dkv_launches = 0
    fa.flash_attention_bwd.dq_launches = 0


def moe_train_want(L, micro_steps):
    """Launches of ``micro_steps`` grouped-dispatch micro-steps with full
    remat: the forward GEMMs twice (forward and recompute), each backward
    form once, 3 a layer each; flash forward twice, dK/dV and dQ once a
    layer; none of the bf16 layout_tile route (its shapes are not the
    model's)."""
    return {"ds_ggemm": 6 * L * micro_steps, "ds_ggemm_t": 3 * L *
            micro_steps, "ds_tgmm": 3 * L * micro_steps,
            "ds_ggemm_slots": 0, "ds_ggemm_unaligned": 0,
            "ds_ggemm_t_unaligned": 0, "ds_tgmm_unaligned": 0,
            "ds_flash_fwd": 2 * L * micro_steps,
            "ds_flash_bwd_dkv": L * micro_steps,
            "ds_flash_bwd_dq": L * micro_steps}


def train_routed(torch, g, R, E, routing):
    """Expert ids of R routed rows: skewed (expert e drawn with weight
    2^-min(e, 3), as a router early in training favours a few experts),
    random, two experts left empty."""
    if routing == "skewed":
        p = torch.tensor([2.0 ** -min(i, 3) for i in range(E)],
                         device="cuda")
        return torch.multinomial(p, R, replacement=True,
                                 generator=g).int()
    e = torch.randint(0, E, (R,), generator=g, device="cuda")
    if routing == "two_empty":
        e = e % (E - 2)
    return e.int()


def grouped_mm_time(torch, a, b, offs):
    """(ms, note) of one ``torch._grouped_mm(a, b, offs=offs)`` call
    (context only; the port never calls it), or (None, the reason)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch has no _grouped_mm"
    try:
        fn(a, b, offs=offs)
        torch.cuda.synchronize()
        return time_ms(lambda: fn(a, b, offs=offs), reps=5, inner=5), None
    except Exception as err:           # the library call's own limits
        return None, f"torch._grouped_mm refused: {str(err)[:160]}"


class tile_route:
    """Within the block the grouped wrappers send bf16 to the layout_tile
    kernels whatever the shape (the route of a shape the Hopper kernels'
    rule refuses, and the kernels those replaced), so both routes are
    held and timed at the same shapes; the rule is restored after."""

    def __init__(self, gg):
        self.gg = gg

    def __enter__(self):
        self.saved = self.gg.hopper_route
        self.gg.hopper_route = lambda dtype, ptrs, dims: False

    def __exit__(self, *exc):
        self.gg.hopper_route = self.saved


#: the grouped kernels whose bf16 form runs on the Hopper kernels
HOPPER_GROUPED = ("ds_ggemm", "ds_ggemm_t", "ds_tgmm")
#: phase 24's bf16 shape outside the Hopper kernels' rule (K and N not
#: multiples of 8): the layout_tile route, held against the plain versions
MT_UNALIGNED = (1020, 3580)


def grouped_outs(gg, x, w, dy, dys, plan):
    """The three grouped kernels' outputs beside their plain versions'."""
    return {"ds_ggemm": (gg.ggemm_cuda(x, w, plan),
                         gg.ggemm_plain(x, w, plan)),
            "ds_ggemm_t": (gg.ggemm_t_cuda(dy, w, plan),
                           gg.ggemm_t_plain(dy, w, plan)),
            "ds_tgmm": (gg.tgmm_cuda(x, dys, plan),
                        gg.tgmm_plain(x, dys, plan))}


def grouped_identity_checks(torch, gg, g):
    """ds_ggemm_identity / ds_ggemm_t_identity: 64 rows of one expert
    (and its weights), alone at R 64 and as that expert's first 64 routed
    rows among R 16,384, give bit-identical forward and dx rows (a row's
    bits do not depend on the rows around it); ds_tgmm_repeat: dW twice
    at R 16,384, bit for bit.  bf16, gate/in shape."""
    K, N = MT_SHAPES["gate_in"]
    dt = torch.bfloat16
    w = (torch.randn(MT_E, K, N, generator=g, device="cuda") * 0.02).to(dt)
    xe = torch.randn(64, K, generator=g, device="cuda").to(dt)
    dye = torch.randn(64, N, generator=g, device="cuda").to(dt)
    ex = 3
    rows = {}
    for R in (64, MT_R):
        e = train_routed(torch, g, R, MT_E, "random")
        e[:64] = ex   # the expert's first 64 rows: a tile's rows 0-63
        xr = torch.randn(R, K, generator=g, device="cuda").to(dt)
        dyr = torch.randn(R, N, generator=g, device="cuda").to(dt)
        xr[:64], dyr[:64] = xe, dye
        plan = gg.make_group_plan(e, MT_E)
        x, dy = gg.scatter_to_groups(xr, plan), gg.scatter_to_groups(dyr,
                                                                     plan)
        at = plan.row_to_padded[:64].long()
        rows[R] = (gg.ggemm_cuda(x, w, plan)[at],
                   gg.ggemm_t_cuda(dy, w, plan)[at])
        if R == MT_R:
            dw1 = gg.tgmm_cuda(x, (dy.float() * 1e-3).to(dt), plan)
            dw2 = gg.tgmm_cuda(x, (dy.float() * 1e-3).to(dt), plan)
        del x, dy, xr, dyr
    torch.cuda.synchronize()
    out = {"ds_ggemm_identity": bool(torch.equal(rows[64][0],
                                                 rows[MT_R][0])),
           "ds_ggemm_t_identity": bool(torch.equal(rows[64][1],
                                                   rows[MT_R][1])),
           "ds_tgmm_repeat_identical": bool(torch.equal(dw1, dw2))}
    emit({"check": "grouped_identity", "expert": ex, "rows": 64,
          "R": [64, MT_R], **out})
    check(all(out.values()), f"grouped kernels: rows depend on the batch "
          f"or dW on the run: {out}")
    return out


def moe_train_kernel_phase(torch, gg, fa):
    """Phase 24: the three grouped kernels of the training path against
    their plain versions at mixtral:1b-moe's training shapes (R 16,384
    skewed, random and two-empty routing, and a ragged R 3,001; fp32 <=
    1e-4 abs with TF32 off, bf16 <= 2e-2 of each output's max; padding
    rows of the forward and dx zero, empty experts' dW exact zeros), bf16
    on both routes (the Hopper kernels, which these shapes take, and
    layout_tile, forced), and a bf16 shape outside the Hopper rule (K
    1020, N 3580) on layout_tile by the rule itself; the identity checks
    (grouped_identity_checks); then each timed in bf16 at R 16,384
    (random routing, as the main path's router gives) beside its plain
    version, its bound and torch._grouped_mm (CUDA events; device time by
    the profiler), with the wrapper's host time a call on both routes.
    Then the flash kernels at B 8, S 1024, H 16, KV 8, hd 64 (forward,
    dK/dV, dQ; fp32 and bf16) against their plain versions, timed in bf16
    beside SDPA.  dy is drawn N(0, 1) for dx and
    1e-3 N(0, 1) for dW, so both outputs are O(0.1-1), where an fp32
    abs tolerance means something."""
    g = torch.Generator(device="cuda").manual_seed(81)
    worst = {"ds_ggemm": 0.0, "ds_ggemm_t": 0.0, "ds_tgmm": 0.0}
    cases = [(MT_R, "skewed"), (MT_R, "random"), (MT_R, "two_empty"),
             (3001, "random")]
    shapes = [(proj, K, N, cases) for proj, (K, N) in MT_SHAPES.items()]
    shapes.append(("unaligned", *MT_UNALIGNED, [(3001, "random")]))
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        tol = INT8_TOL[dt_name]
        for proj, K, N, proj_cases in shapes:
            if proj == "unaligned" and dt_name == "float32":
                continue
            w = (torch.randn(MT_E, K, N, generator=g, device="cuda")
                 * 0.02).to(dt)
            for R, routing in proj_cases:
                e = train_routed(torch, g, R, MT_E, routing)
                plan = gg.make_group_plan(e, MT_E)
                x = gg.scatter_to_groups(torch.randn(
                    R, K, generator=g, device="cuda").to(dt), plan)
                dy = gg.scatter_to_groups(torch.randn(
                    R, N, generator=g, device="cuda").to(dt), plan)
                dys = (dy.float() * 1e-3).to(dt)
                pad = torch.ones(plan.padded_rows, dtype=torch.bool,
                                 device="cuda")
                pad[plan.row_to_padded.long()] = False
                empty = (plan.counts == 0).nonzero().flatten().tolist()
                routes = {"rule": contextlib.nullcontext()}
                if dt_name == "bfloat16" and proj != "unaligned":
                    routes["layout_tile"] = tile_route(gg)
                for route, ctx in routes.items():
                    before = unaligned_counts(gg)
                    with ctx:
                        outs = grouped_outs(gg, x, w, dy, dys, plan)
                    torch.cuda.synchronize()
                    moved = {k: v - before[k]
                             for k, v in unaligned_counts(gg).items()}
                    # the rule's route: layout_tile exactly where it is due
                    tiled = dt_name == "bfloat16" and (
                        proj == "unaligned" or route == "layout_tile")
                    check(all(v == (1 if tiled else 0)
                              for v in moved.values()),
                          f"grouped {dt_name} {proj} ({route}): the "
                          f"unaligned counts moved {moved}")
                    for name, (got, ref) in outs.items():
                        e_abs, held = err_of(torch, got, ref, dt_name)
                        zeros = (not bool(got[pad].any())) \
                            if name != "ds_tgmm" \
                            else all(not bool(got[i].any()) for i in empty)
                        emit({"check": name, "dtype": dt_name, "proj": proj,
                              "route": route if dt_name == "bfloat16"
                              and proj != "unaligned" else "layout_tile",
                              "R": R, "routing": routing, "K": K, "N": N,
                              "padded_rows": plan.padded_rows,
                              "max_abs_err": e_abs, "held": held,
                              "tol": tol,
                              "out_max": float(ref.float().abs().max()),
                              "zeros_where_due": zeros})
                        check(held <= tol and zeros,
                              f"{name} {dt_name} {proj} ({route}) R {R} "
                              f"{routing}: err {held} > {tol} or padding / "
                              "empty experts not 0")
                        worst[name] = max(worst[name], held)
                    del outs
                del x, dy, dys
            del w
            torch.cuda.empty_cache()
    identity = grouped_identity_checks(torch, gg, g)
    times = {}
    dt = torch.bfloat16
    for proj, (K, N) in MT_SHAPES.items():
        w = (torch.randn(MT_E, K, N, generator=g, device="cuda")
             * 0.02).to(dt)
        e = train_routed(torch, g, MT_R, MT_E, "random")
        plan = gg.make_group_plan(e, MT_E)
        xr = torch.randn(MT_R, K, generator=g, device="cuda").to(dt)
        dyr = (torch.randn(MT_R, N, generator=g, device="cuda")
               * 1e-3).to(dt)
        x, dy = gg.scatter_to_groups(xr, plan), gg.scatter_to_groups(dyr,
                                                                     plan)
        order = torch.argsort(e.long(), stable=True)
        xs, dys = xr[order].contiguous(), dyr[order].contiguous()
        offs = torch.cumsum(torch.bincount(e.long(), minlength=MT_E),
                            0).to(torch.int32)
        active = int((plan.counts > 0).sum())
        runs = {
            "ds_ggemm": (lambda: gg.ggemm_cuda(x, w, plan),
                         lambda: gg.ggemm_plain(x, w, plan),
                         ggemm_bound(torch, gg, plan, x, MT_R, K, N),
                         (xs, w)),
            "ds_ggemm_t": (lambda: gg.ggemm_t_cuda(dy, w, plan),
                           lambda: gg.ggemm_t_plain(dy, w, plan),
                           ggemm_bound(torch, gg, plan, dy, MT_R, N, K),
                           (dys, w.transpose(-2, -1))),
            "ds_tgmm": (lambda: gg.tgmm_cuda(x, dy, plan),
                        lambda: gg.tgmm_plain(x, dy, plan),
                        bound_of(MT_E * K * N * 2 + MT_R * (K + N) * 2,
                                 2 * MT_R * K * N, BF16_FLOPS),
                        (xs.t(), dys))}
        for name, (kern, plain, bound, lib) in runs.items():
            t = {"kernel_ms": time_ms(kern, reps=5, inner=5),
                 "plain_ms": time_ms(plain, reps=3, inner=2)}
            t["bound_ms"], t["bound_by"] = bound
            t["library_ms"], why = grouped_mm_time(torch, *lib, offs)
            if why:
                t["library_note"] = why
            t["device_ms"] = device_ms(torch, [kern], reps=10,
                                       one_kernel=True)[0]
            if t["library_ms"] is not None:
                t["library_device_ms"], t["library_kernels_per_call"] = \
                    device_ms(torch, [lambda: torch._grouped_mm(
                        *lib, offs=offs)], reps=10)
            t["host_ms"] = host_ms_per_call(torch, kern, n=50)
            with tile_route(gg):
                # the wrapper's host time on the route this replaces
                t["layout_tile_host_ms"] = host_ms_per_call(torch, kern,
                                                            n=50)
            t.update(work=f"{proj} K {K} N {N}, R {MT_R} "
                     f"({plan.padded_rows} padded rows, {active} experts), "
                     "bf16", R=MT_R)
            emit({"phase": "moe_train_kernel_times", "kernel": name,
                  "proj": proj, **t})
            times.setdefault(name, {})[proj] = t
        del w, x, dy, xr, dyr, xs, dys
        torch.cuda.empty_cache()
    reset_moe_train_counts(gg, fa)
    flash = moe_train_flash_phase(torch, fa)
    return times, worst, flash, identity


def moe_train_flash_phase(torch, fa):
    """The flash kernels at the MoE training shape (B 8, S 1024, H 16,
    KV 8, hd 64, separate q / k / v as the Mixtral layer gives them):
    forward and backward against the plain versions, fp32 and bf16, then
    the bf16 kernels timed beside the plain versions, SDPA (GQA) and the
    bound."""
    import torch.nn.functional as F
    g = torch.Generator(device="cpu").manual_seed(82)
    B, S, H, KV, hd = MT_B, MT_S, MT_H, MT_KV, MT_HD
    errs = {"ds_flash_fwd": 0.0, "ds_flash_bwd_dkv": 0.0,
            "ds_flash_bwd_dq": 0.0}
    rel = {"ds_flash_bwd_dkv": 0.0, "ds_flash_bwd_dq": 0.0}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        q, k, v, do, lse, delta, _ = bwd_inputs(
            torch, fa, g, B, S, H, KV, hd, dt, True, False, False)
        o, lk = fa.flash_attention_fwd_cuda(q, k, v)
        ro, rl = fa.flash_attention_fwd_plain(q, k, v)
        torch.cuda.synchronize()
        eo = float((o.float() - ro.float()).abs().max())
        el = float((lk - rl).abs().max())
        row = {"check": "flash_at_moe_train_shape", "dtype": dt_name,
               "shape": [B, S, H, KV, hd], "max_abs_err_o": eo,
               "max_abs_err_lse": el, "tol_o": TOL[dt_name]["o"],
               "tol_lse": TOL[dt_name]["lse"], "tol_bwd": BWD_TOL[dt_name]}
        check(eo <= TOL[dt_name]["o"] and el <= TOL[dt_name]["lse"],
              f"ds_flash_fwd {dt_name} at the MoE training shape: o err "
              f"{eo}, lse err {el}")
        errs["ds_flash_fwd"] = max(errs["ds_flash_fwd"], eo)
        del o, ro, rl, lk
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta)
        ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            e = float((a.float() - b.float()).abs().max())
            r = e / max(float(b.float().abs().max()), 1e-30)
            row[f"max_abs_err_{name}"], row[f"rel_err_{name}"] = e, r
            kern = "ds_flash_bwd_dq" if name == "dq" else "ds_flash_bwd_dkv"
            errs[kern] = max(errs[kern], e)
            rel[kern] = max(rel[kern], r)
            check((e if dt_name == "float32" else r) <= BWD_TOL[dt_name],
                  f"ds_flash_bwd {dt_name} at the MoE training shape: "
                  f"{name} err {e} (rel {r})")
        emit(row)
        del got, ref
        if dt_name == "float32":
            del q, k, v, do, lse, delta
            torch.cuda.empty_cache()
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    times = {}
    fwd = {"kernel_ms": time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v)),
           "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(
               q, k, v), reps=3, inner=2),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True))}
    fwd["bound_ms"], fwd["bound_by"] = attn_bound(B, S, H, KV, hd, 2, True,
                                                  2, 2, 1)
    fwd.update(flash_fwd_device_ms(torch, F, fa, q, k, v, enable_gqa=True))
    dkv = {"kernel_ms": time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        q, k, v, do, lse, delta))}
    dq = {"kernel_ms": time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, do, lse, delta))}
    dkv["bound_ms"], dkv["bound_by"] = attn_bound(B, S, H, KV, hd, 4, True,
                                                  2, 4, 2)
    dq["bound_ms"], dq["bound_by"] = attn_bound(B, S, H, KV, hd, 3, True,
                                                3, 2, 2)
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, do, lse, delta), reps=3, inner=2)
    ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (ql, kl, vl), dot)
    lib = time_ms(sdpa_fwd_bwd) - time_ms(sdpa)
    dev = flash_bwd_device_ms(torch, F, fa, (q, k, v, do, lse, delta),
                              enable_gqa=True)
    for name, r in (("ds_flash_bwd_dkv", dkv), ("ds_flash_bwd_dq", dq)):
        r["plain_ms"], r["library_ms"] = plain, lib
        r["device_ms"], r["library_device_ms"] = dev[name], dev["library"]
        r["library_kernels_per_call"] = dev["library_kernels_per_call"]
        r["plain_and_library_are_for_the_pair"] = True
    times.update(ds_flash_fwd=fwd, ds_flash_bwd_dkv=dkv, ds_flash_bwd_dq=dq)
    emit({"phase": "moe_train_flash_times", "shape": [B, S, H, KV, hd],
          "dtype": "bfloat16", **times})
    return {"errs": errs, "rel": rel, "times": times}


class plain_grouped_backward(plain_grouped_gemm):
    """:class:`plain_grouped_gemm` for training: the forward, the
    transposed-RHS form and dW take their plain versions on the card."""

    def __enter__(self):
        super().__enter__()
        gg = self.gg
        self.saved_bwd = gg.ds_ggemm, gg.ds_tgmm
        fwd = gg.ds_ggemm

        def mm(x, w, plan, transpose_rhs=False):
            return gg.ggemm_t_plain(x, w, plan) if transpose_rhs \
                else fwd(x, w, plan)
        gg.ds_ggemm = mm
        gg.ds_tgmm = gg.tgmm_plain

    def __exit__(self, *exc):
        self.gg.ds_ggemm, self.gg.ds_tgmm = self.saved_bwd
        super().__exit__(*exc)


def mt_model(dtype, **over):
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    return mixtral_model("1b-moe", dtype=dtype, remat=True,
                         remat_policy="nothing", **over)


def moe_train_parity_phase(torch, dt, gg, fa):
    """Phase 25: fp32 mixtral:1b-moe widths at 2 layers (cut for time),
    micro 2, gas 2, S 512, 3 steps through initialize -> train_batch
    (WarmupLR, clipping), grouped dispatch: the kernels (grouped GEMMs
    and flash) against the plain versions (plain_grouped_backward and
    attention_impl "plain") from the same params and batches.  Held:
    per-step losses within 1e-4 relative, each param leaf's difference
    within PARAM_TOL of its own movement, exact launches per step
    (:func:`moe_train_want`) and none in the plain run.  Then the einsum
    arm ("auto" trains through the capacity formulation), 2 steps:
    finite losses and no grouped launch."""
    import numpy as np
    P = MT_PARITY
    L, micro, gas, S, steps = (P["layers"], P["micro"], P["gas"], P["seq"],
                               P["steps"])
    cfg = train_config(micro, gas, 1e-4, gradient_clipping=1.0,
                       scheduler={"type": "WarmupLR",
                                  "params": {"warmup_num_steps": 3}})
    init = None
    runs = {}
    for arm in ("kernels", "plain", "einsum"):
        model = mt_model("float32", num_layers=L, max_seq_len=S,
                         moe_dispatch="auto" if arm == "einsum"
                         else "grouped",
                         attention_impl="plain" if arm == "plain"
                         else "auto")
        if init is None:
            init = model.init(0, "cuda", torch.float32)
        eng, *_ = dt.initialize(model=model, config=cfg,
                                model_parameters=init)
        rng = np.random.default_rng(25)
        losses, per_step = [], []
        for _ in range(2 if arm == "einsum" else steps):
            b = {"input_ids": rng.integers(0, model.config.vocab_size,
                                           (gas, micro, S), dtype=np.int32)}
            reset_moe_train_counts(gg, fa)
            if arm == "plain":
                with plain_grouped_backward(gg):
                    losses.append(float(eng.train_batch(batch=b)))
            else:
                losses.append(float(eng.train_batch(batch=b)))
            torch.cuda.synchronize()
            per_step.append(moe_train_counts(gg, fa))
        runs[arm] = (eng, losses, per_step)
    (ek, lk, ck), (ep, lp, cp), (_, le, ce) = (runs["kernels"],
                                               runs["plain"], runs["einsum"])
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    want = moe_train_want(L, gas)
    ratios = {}

    def leaves(tree, prefix=""):
        for key, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{key}/")
            else:
                yield f"{prefix}{key}", v
    p0 = dict(leaves(init))
    pp = dict(leaves(ep.params))
    for name, pk in leaves(ek.params):
        ratios[name] = _diff_ratio(torch, pk, pp[name], p0[name])
    report = {"phase": "fp32_moe_train_parity", "layers": L, "micro": micro,
              "gas": gas, "seq": S, "steps": steps, "losses_kernels": lk,
              "losses_plain": lp, "loss_rel_err": rel,
              "launches_per_step_kernels": ck,
              "launches_per_step_plain": cp, "want_per_step": want,
              "param_diff_over_movement": ratios, "param_tol": PARAM_TOL,
              "einsum_losses": le, "einsum_launches_per_step": ce}
    emit(report)
    check(all(r <= 1e-4 for r in rel), f"fp32 MoE train: losses differ "
          f"{rel}")
    check(all(c == want for c in ck), f"fp32 MoE train: launches {ck} != "
          f"{want} per step")
    check(all(all(v == 0 for v in c.values()) for c in cp),
          f"fp32 MoE train: the plain run launched kernels {cp}")
    check(max(ratios.values()) <= PARAM_TOL,
          f"fp32 MoE train: params differ {ratios}")
    check(all(math.isfinite(x) for x in le)
          and all(c["ds_ggemm"] == c["ds_ggemm_t"] == c["ds_tgmm"] ==
                  c["ds_ggemm_slots"] == 0 for c in ce),
          f"fp32 MoE train, einsum arm: losses {le}, launches {ce}")
    return report


def moe_train_bf16_phase(torch, dt, gg, fa):
    """Phase 26, the slice's main path: mixtral:1b-moe at full width
    (nothing cut: 8 layers, d 1024, 16 / 8 heads of hd 64, d_ff 3584, 8
    experts, top-2, vocab 32000) with grouped dispatch, seq 1024,
    micro-batch 8, full remat, bench.py's optimizer byte diet, through
    initialize -> train_batch: 3 warm-up steps, then 10 timed steps with
    every count set to 0 just before and read just after; step seconds,
    tokens/s, MFU (bench.py's 6 N_active + 6 L S D flops per token
    against 989 TFLOP/s), peak memory, losses, one profiled step."""
    import numpy as np
    model = mt_model("bfloat16", max_seq_len=MT_S, moe_dispatch="grouped")
    c = model.config
    cfg = train_config(MT_B, 1, 1e-4,
                       bf16={"enabled": True,
                             "master_weights_dtype": "bfloat16",
                             "optimizer_states_dtype": "bfloat16"},
                       data_types={"grad_accum_dtype": "bf16"})
    t0 = time.perf_counter()
    eng, *_ = dt.initialize(model=model, config=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)

    def batch():
        return {"input_ids": rng.integers(0, c.vocab_size, (1, MT_B, MT_S),
                                          dtype=np.int32)}
    losses = [eng.train_batch(batch=batch()) for _ in range(3)]
    timed = [batch() for _ in range(10)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_moe_train_counts(gg, fa)
    t0 = time.perf_counter()
    losses += [eng.train_batch(batch=b) for b in timed]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = moe_train_counts(gg, fa)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = wall / len(timed)
    tokens_per_s = MT_B * MT_S / step_s
    flops_per_token = model.flops_per_token \
        + 6.0 * c.num_layers * MT_S * c.d_model
    profile = profile_train_step(torch, eng, batch())
    cats = profile["device_ms_by_category"]
    busy = profile["device_busy_ms"]
    report = {"phase": "bf16_moe_train", "model": "mixtral-1b-moe",
              "moe_dispatch": "grouped", "n_params": model.meta["n_params"],
              "active_params": model.meta["active_params"],
              "micro_batch": MT_B, "seq": MT_S, "routed_rows": MT_R,
              "init_s": init_s, "timed_steps": len(timed), "step_s": step_s,
              "tokens_per_s": tokens_per_s,
              "flops_per_token": flops_per_token,
              "mfu": flops_per_token * tokens_per_s / BF16_FLOPS,
              "peak_allocated_gb": peak / 1e9, "first_loss": losses[0],
              "last_loss": losses[-1], "losses": losses,
              "launches": launches, "train_profile": profile,
              "grouped_gemm_share_of_busy":
              cats.get(GROUPED_CATEGORY, 0.0) / busy if busy else None}
    emit(report)
    want = moe_train_want(c.num_layers, len(timed))
    check(launches == want, f"bf16 MoE train: launches {launches} != {want}")
    check(all(math.isfinite(x) for x in losses),
          f"bf16 MoE train: non-finite loss {losses}")
    # ln V plus the aux loss (0.01 x ~E x sum(me ce) ~ 0.02 a layer)
    check(abs(losses[0] - math.log(c.vocab_size)) <= 0.5,
          f"bf16 MoE train: first loss {losses[0]} not near ln(V) = "
          f"{math.log(c.vocab_size)}")
    return launches, report


# ------------------------------------------------------ sparse attention
# the slice's path: GPT-2 760M's attention width (16 heads of hd 96) at a
# long sequence, one sequence, bf16, causal; nothing cut
SP_B, SP_S, SP_H, SP_HD = 1, 16384, 16, 96
SP_ITERS = 10
SP_CHECK_B, SP_CHECK_S = 2, 2048
SP_REF_GRAD_TOL = 0.02      # the JAX package's own check of this op
# 27c at S 16384, beside the max-abs limits (which a late row's |o| ~ 0.015
# and a local column's small dK / dV sit near): the whole tensor's
# ||got - plain|| / ||plain||, and each row's (one position and head) max
# error over that row's max |plain| (floored at a tenth of the median row
# max, see path_errs). A row error of 2^-7 is one bf16 step of the row's
# max; o, dk and dv read that at the Fixed layout, dq's worst row 0.022
# (PERF.md section 2), so dq's rows are held to 5e-2
SP_PATH_REL_TOL = 1e-2
SP_PATH_ROW_TOL = {"o": 2e-2, "dq": 5e-2, "dk": 2e-2, "dv": 2e-2}
SP_PATH_ROW_FLOOR = 0.1
SPARSE_KERNELS = ("block_sparse_attention_fwd", "block_sparse_attention_dq",
                  "block_sparse_attention_dkv")


def sparse_modules():
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    return sa, bs


def sparse_path_configs(sa):
    """The path's two layouts at 16 heads: DeepSpeed's documented
    ``sparse_attention`` mode "fixed" setting, and BigBird."""
    return {
        "fixed": sa.FixedSparsityConfig(
            num_heads=SP_H, block=16, num_local_blocks=4,
            num_global_blocks=1, attention="unidirectional"),
        "bigbird": sa.BigBirdSparsityConfig(
            num_heads=SP_H, block=64, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1,
            attention="unidirectional")}


def sparse_counts(bs):
    return {name: getattr(bs, name).launches for name in SPARSE_KERNELS}


def reset_sparse_counts(bs):
    for name in SPARSE_KERNELS:
        getattr(bs, name).launches = 0


def path_errs(torch, got, plain):
    """``got`` against ``plain`` at the path's size: max abs error, the
    relative norm of the difference, and the largest row error (rows along
    the last dim) over that row's max |plain|, floored at SP_PATH_ROW_FLOOR
    of the median row max: a row far below the rest is cancellation noise
    (dq's first row under causal attends one key, so P = 1 and dS = dP -
    dsum is rounding either way) and is held against the floor. Beside
    them the number of floored rows and the plain tensor's rms and median
    row max (the magnitudes the limits are read against), and where the
    worst row lies."""
    import numpy as np
    a, b = got.float(), plain.float()
    d = (a - b).abs()
    row_err, row_max = d.amax(-1), b.abs().amax(-1)
    median = float(row_max.median())
    floor = max(SP_PATH_ROW_FLOOR * median, 1e-30)
    ratio = row_err / row_max.clamp_min(floor)
    worst = int(ratio.argmax())
    return {"max_abs_err": float(d.max()),
            "rel_norm_err": float(d.norm() / b.norm().clamp_min(1e-30)),
            "max_row_rel_err": float(ratio.max()),
            "worst_row_bsh": [int(i) for i in np.unravel_index(
                worst, ratio.shape)],
            "worst_row_max": float(row_max.flatten()[worst]),
            "floored_rows": int((row_max < floor).sum()),
            "plain_rms": float(b.pow(2).mean().sqrt()),
            "plain_median_row_max": median}


def sparse_check_cases(sa, np):
    """(label, config or layout, S, causal, H, hd, B): S 2048 at B 2 but
    two ragged cases (S 2000 and 2016, where the last CTA holds fewer
    blocks than it has slots); every layout class, a per-head layout and
    one with empty rows and columns; blocks 16, 32, 64 and 128, head dims
    64, 80, 96 and 128 (80 at every block size), causal and bidirectional.
    Then, for the bf16 kernels' tile plans: three cases at S 8192, B 1
    whose longest lists span 3 or more segments (Fixed and BigBird: the
    dK/dV side; dense: both sides), and one at S 1040 (65 blocks of 16)
    whose gathered streamed and own tiles end part-filled."""
    S, B = SP_CHECK_S, SP_CHECK_B
    n = S // 64
    empty = np.zeros((2, n, n), np.int64)
    empty[:, 0, 1] = 1          # causal: block row 0 sees nothing (empty)
    empty[:, 1:, 0] = 1
    for i in range(2, n, 2):    # odd columns but 1 attended by no row
        empty[:, i, i] = 1
    empty[1, 5, 3] = 1          # the heads differ
    cases = [
        ("fixed_b16_causal", sa.FixedSparsityConfig(
            4, 16, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional"), S, True, 4, 96),
        ("bigbird_b64_bidir", sa.BigBirdSparsityConfig(4, 64), S, False, 4,
         64),
        ("bslongformer_b128_causal", sa.BSLongformerSparsityConfig(
            2, 128, global_block_indices=[0, 7]), S, True, 2, 128),
        ("variable_b32_causal", sa.VariableSparsityConfig(
            4, 32, num_random_blocks=1, local_window_blocks=[2, 4],
            global_block_indices=[0, 9], seed=3), S, True, 4, 64),
        ("bigbird_per_head_b32_bidir", sa.BigBirdSparsityConfig(
            4, 32, different_layout_per_head=True, num_random_blocks=2,
            seed=5), S, False, 4, 128),
        ("empty_rows_cols_b64_causal", empty, S, True, 2, 96),
        ("fixed_b128_bidir", sa.FixedSparsityConfig(
            2, 128, num_local_blocks=2, num_global_blocks=1), S, False, 2,
         96),
        ("dense_b64_causal", sa.DenseSparsityConfig(2, 64), S, True, 2, 128),
        ("fixed_b16_ragged_bidir", sa.FixedSparsityConfig(
            2, 16, num_local_blocks=4), 2000, False, 2, 64),
        ("bigbird_b32_ragged_causal", sa.BigBirdSparsityConfig(
            2, 32, attention="unidirectional"), 2016, True, 2, 96),
        # head dim 80 at every block size (each kernel's KW 16 / 32 / 64)
        ("fixed_b16_causal_hd80", sa.FixedSparsityConfig(
            2, 16, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional"), S, True, 2, 80),
        ("variable_b32_ragged_causal_hd80", sa.VariableSparsityConfig(
            2, 32, num_random_blocks=1, local_window_blocks=[2, 4],
            global_block_indices=[0, 9], seed=4), 2016, True, 2, 80),
        ("empty_rows_cols_b64_causal_hd80", empty, S, True, 2, 80),
        ("bigbird_b128_bidir_hd80", sa.BigBirdSparsityConfig(2, 128), S,
         False, 2, 80)]
    long = [
        ("fixed_b16_causal_s8192_segments", sa.FixedSparsityConfig(
            2, 16, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional"), 8192, True, 2, 96, 1),
        ("bigbird_b64_causal_s8192_segments", sa.BigBirdSparsityConfig(
            2, 64, num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1, attention="unidirectional"), 8192, True, 2,
         96, 1),
        ("dense_b64_causal_s8192_segments", sa.DenseSparsityConfig(2, 64),
         8192, True, 2, 64, 1),
        ("bigbird_b16_part_filled_causal", sa.BigBirdSparsityConfig(
            2, 16, num_random_blocks=2, num_sliding_window_blocks=3,
            num_global_blocks=1, attention="unidirectional", seed=9), 1040,
         True, 2, 96, 2)]
    return [(*c, B) for c in cases] + long


def tile_plan_report(tps, hd):
    """The bf16 kernels' tile plans (one per side; the forward and dQ walk
    the "dq" side) as reported: fill, items, streamed tiles, the segment
    length, split units, partial tiles and the workspace they take per
    batch row at head dim ``hd`` (each kernel's fp32 partials, ``
    partial_floats``: dQ's 64 x hd, the forward's o and row values, two
    64 x hd for dK/dV), the longest item, the most segments of a unit,
    and the streamed and own tiles with an empty slot (part-filled)."""
    import numpy as np
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import \
        partial_floats
    out = {}
    for side, tp in tps.items():
        g = tp.g
        kernels = ("fwd", "dq") if side == "dq" else ("dkv",)
        out[side] = {
            "fill": tp.fill, "items": int(len(tp.items)),
            "streamed_tiles": int(len(tp.tiles)), "segment": tp.segment,
            "split_units": tp.n_split, "partials": tp.n_partials,
            "workspace_bytes_per_batch_row": {
                k: tp.n_partials * partial_floats(k, hd) * 4
                for k in kernels},
            "longest_item": int(
                tp.items[:, 3].max(initial=0)),
            "max_segments": int(tp.items[:, 6].max(initial=1)),
            "part_filled_streamed": int((tp.tiles[:, :g] < 0).any(1).sum()),
            "part_filled_own": int(np.sum((tp.own[:, :g] < 0).any(1)
                                          & (tp.own[:, 0] >= 0)))}
    return out


def sparse_kernel_phase(torch, sa, bs):
    """Phase 27a: the three kernels against their plain versions over
    :func:`sparse_check_cases`, fp32 and bf16: o and lse, then dq, dk and
    dv given the plain forward's lse and dsum (fp32 <= 1e-4 abs with TF32
    off; bf16 o <= 2e-2 abs, lse <= 1e-3, gradients <= 2e-2 of each
    output's max); lse +inf exactly where the plain one is; rows with no
    live block and kv blocks no row attends exact zeros; and with inf in
    every block no kernel reads (k and v of the kv blocks a head does not
    attend, q and dO of its rows with no live block, NaN in those rows'
    lse and dsum), o, lse, dq, dk and dv bit-identical.  The bf16 cases
    report the tile plans (:func:`tile_plan_report`); some
    case must have a list of 3 or more segments on each side, and
    part-filled streamed and own tiles."""
    import numpy as np
    g = torch.Generator(device="cpu").manual_seed(27)
    errs = {n: 0.0 for n in SPARSE_KERNELS}
    rel = {n: 0.0 for n in SPARSE_KERNELS}
    poisoned = zero_rows = zero_cols = 0
    reach = {"dq_segments": 0, "dkv_segments": 0, "part_streamed": 0,
             "part_own": 0}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for label, cfg, S, causal, H, hd, B in sparse_check_cases(sa, np):
            lay = cfg if isinstance(cfg, np.ndarray) else cfg.make_layout(S)
            q, k = (torch.randn(B, S, H, hd, generator=g).to("cuda", dt)
                    for _ in range(2))
            v, do = ((torch.rand(B, S, H, hd, generator=g) * 2 - 1)
                     .to("cuda", dt) for _ in range(2))
            plan = bs.BlockSparsePlan(lay, causal, "cuda")
            block = S // plan.n
            o, lse = bs.block_sparse_attention_fwd_cuda(q, k, v, plan)
            o_nl, lse_nl = bs.block_sparse_attention_fwd_cuda(
                q, k, v, plan, with_lse=False)
            ro, rl = bs.block_sparse_attention_fwd_plain(q, k, v, plan)
            dsum = (do.float() * ro.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            got = (bs.block_sparse_attention_dq_cuda(q, k, v, do, rl, dsum,
                                                     plan),
                   *bs.block_sparse_attention_dkv_cuda(q, k, v, do, rl, dsum,
                                                       plan))
            ref = (bs.block_sparse_attention_dq_plain(q, k, v, do, rl, dsum,
                                                      plan),
                   *bs.block_sparse_attention_dkv_plain(q, k, v, do, rl,
                                                        dsum, plan))
            torch.cuda.synchronize()
            e_o = float((o.float() - ro.float()).abs().max())
            fin = torch.isfinite(rl)
            e_l = float((lse[fin] - rl[fin]).abs().max()) if fin.any() \
                else 0.0
            inf_same = bool(torch.equal(torch.isinf(lse), ~fin)
                            and (lse[~fin] > 0).all())
            # the inference path: no lse written, o bit-identical
            no_lse_same = lse_nl is None and bool(torch.equal(o, o_nl))
            row = {"check": "block_sparse_kernels", "case": label,
                   "dtype": dt_name, "shape": [B, S, H, hd],
                   "block": block, "causal": causal,
                   "live_blocks": plan.live, "max_active": plan.max_active,
                   "max_q": plan.max_q, "max_abs_err_o": e_o,
                   "max_abs_err_lse": e_l, "lse_inf_where_plain": inf_same,
                   "o_without_lse_bit_identical": no_lse_same}
            ok = e_o <= TOL[dt_name]["o"] and e_l <= TOL[dt_name]["lse"] \
                and inf_same and no_lse_same
            errs["block_sparse_attention_fwd"] = max(
                errs["block_sparse_attention_fwd"], e_o)
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                e = float((a.float() - b.float()).abs().max())
                r = e / max(float(b.float().abs().max()), 1e-30)
                row[f"max_abs_err_{name}"], row[f"rel_err_{name}"] = e, r
                kern = "block_sparse_attention_" + ("dq" if name == "dq"
                                                    else "dkv")
                errs[kern] = max(errs[kern], e)
                rel[kern] = max(rel[kern], r)
                ok = ok and (e if dt_name == "float32" else r) \
                    <= BWD_TOL[dt_name]
            # exact zeros: rows of empty block rows, columns no row attends
            dead_r = torch.from_numpy(np.repeat(plan.kv_cnt_np.T == 0, block,
                                                axis=0)).cuda()   # [S, H]
            dead_c = torch.from_numpy(np.repeat(plan.q_cnt_np.T == 0, block,
                                                axis=0)).cuda()
            zeros = not (bool(o[:, dead_r].any()) or bool(got[0][:, dead_r]
                                                          .any())
                         or bool(got[1][:, dead_c].any())
                         or bool(got[2][:, dead_c].any()))
            zero_rows += int(dead_r.sum()) * B
            zero_cols += int(dead_c.sum()) * B
            # poison: inf in every kv block a head never reads, in q and dO
            # of its rows with no live block, NaN in those rows' lse, dsum
            k2, v2 = k.clone(), v.clone()
            k2[:, dead_c] = float("inf")
            v2[:, dead_c] = float("inf")
            q2, do2 = q.clone(), do.clone()
            q2[:, dead_r] = float("inf")
            do2[:, dead_r] = float("inf")
            rl2, dsum2 = rl.clone(), dsum.clone()
            rl2.transpose(1, 2)[:, dead_r] = float("nan")
            dsum2.transpose(1, 2)[:, dead_r] = float("nan")
            o2, lse2 = bs.block_sparse_attention_fwd_cuda(q, k2, v2, plan)
            same = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
            got2 = (bs.block_sparse_attention_dq_cuda(q2, k2, v2, do2, rl2,
                                                      dsum2, plan),
                    *bs.block_sparse_attention_dkv_cuda(q2, k2, v2, do2, rl2,
                                                        dsum2, plan))
            same_bwd = all(bool(torch.equal(a, b)) for a, b in zip(got,
                                                                   got2))
            poisoned += int(dead_c.sum()) // block
            row.update(zeros_where_due=zeros, poisoned_blocks=int(
                dead_c.sum()) // block, poisoned_rows=int(dead_r.sum()),
                poisoned_o_lse_bit_identical=same,
                poisoned_grads_bit_identical=same_bwd,
                tol=TOL[dt_name], tol_bwd=BWD_TOL[dt_name])
            if dt_name == "bfloat16":
                rep_ = tile_plan_report(plan.tile_plans(block), hd)
                row["tile_plan"] = rep_
                reach["dq_segments"] = max(reach["dq_segments"],
                                           rep_["dq"]["max_segments"])
                reach["dkv_segments"] = max(reach["dkv_segments"],
                                            rep_["dkv"]["max_segments"])
                for side in rep_.values():
                    reach["part_streamed"] += side["part_filled_streamed"]
                    reach["part_own"] += side["part_filled_own"]
            emit(row)
            check(ok and zeros and same and same_bwd,
                  f"block-sparse kernels {label} {dt_name}: {row}")
            del q, k, v, do, o, ro, lse, rl, got, ref, k2, v2, o2, lse2, o_nl
            del q2, do2, rl2, dsum2, got2
    check(poisoned > 0 and zero_rows > 0 and zero_cols > 0,
          "block-sparse kernels: no case had empty rows, empty columns or "
          "blocks to poison")
    check(min(reach["dq_segments"], reach["dkv_segments"]) >= 3
          and reach["part_streamed"] > 0 and reach["part_own"] > 0,
          f"block-sparse kernels: the cases did not reach a list of 3 "
          f"segments on each side and part-filled tiles: {reach}")
    torch.cuda.empty_cache()
    return errs, rel, {"poisoned_blocks": poisoned, "zero_rows": zero_rows,
                       "zero_cols": zero_cols}


def sparse_identity_configs(sa, H):
    """The path's two layouts at H heads (S 8192 cuts 6 of the Fixed dQ
    side's lists and 2 of BigBird's dK/dV side's)."""
    return (("fixed", sa.FixedSparsityConfig(
                H, 16, num_local_blocks=4, num_global_blocks=1,
                attention="unidirectional")),
            ("bigbird", sa.BigBirdSparsityConfig(
                H, 64, num_random_blocks=1, num_sliding_window_blocks=3,
                num_global_blocks=1, attention="unidirectional")))


def sparse_fwd_identity(torch, sa, bs):
    """``block_sparse_fwd_identity``: the bf16 forward at S 8192, H 2, hd
    96, causal, for the Fixed and BigBird path layouts (the Fixed one
    with split dQ-side lists): o and lse bit-identical over two launches,
    and batch row 0 bit-identical at B 1 and B 2 (row 1 other inputs)."""
    g = torch.Generator(device="cpu").manual_seed(274)
    S, H, hd = 8192, 2, SP_HD
    report = {}
    for label, cfg in sparse_identity_configs(sa, H):
        plan = bs.BlockSparsePlan(cfg.make_layout(S), True, "cuda")
        q, k = (torch.randn(2, S, H, hd, generator=g).to("cuda",
                                                         torch.bfloat16)
                for _ in range(2))
        v = (torch.rand(2, S, H, hd, generator=g) * 2 - 1).to(
            "cuda", torch.bfloat16)

        def fwd(b):
            return bs.block_sparse_attention_fwd_cuda(q[:b], k[:b], v[:b],
                                                      plan)
        one, again, two = fwd(1), fwd(1), fwd(2)
        torch.cuda.synchronize()
        report[label] = {
            "repeat_identical": all(bool(torch.equal(a, b))
                                    for a, b in zip(one, again)),
            "row0_b1_vs_b2_identical": all(bool(torch.equal(a[0], b[0]))
                                           for a, b in zip(one, two)),
            "dq_side_split_units":
            plan.tile_plan(cfg.block, "dq").n_split}
        del q, k, v, one, again, two
    emit({"check": "block_sparse_fwd_identity", "shape": [S, H, hd],
          "dtype": "bfloat16", "causal": True, **report})
    check(all(r["repeat_identical"] and r["row0_b1_vs_b2_identical"]
              for r in report.values())
          and any(r["dq_side_split_units"] for r in report.values()),
          f"block_sparse_fwd_identity: {report}")
    return report


def sparse_bwd_identity(torch, sa, bs):
    """``block_sparse_bwd_identity``: the bf16 dQ and dK/dV kernels at S
    8192, H 2, hd 96, causal, for the Fixed and BigBird path layouts (both
    with split lists on the dK/dV side): dq, dk and dv bit-identical over
    two launches, and batch row 0 bit-identical at B 1 and B 2 (row 1
    other inputs)."""
    g = torch.Generator(device="cpu").manual_seed(273)
    S, H, hd = 8192, 2, SP_HD
    report = {}
    for label, cfg in sparse_identity_configs(sa, H):
        plan = bs.BlockSparsePlan(cfg.make_layout(S), True, "cuda")
        q, k, v, do = ((torch.rand(2, S, H, hd, generator=g) * 2 - 1)
                       .to("cuda", torch.bfloat16) for _ in range(4))
        o, lse = bs.block_sparse_attention_fwd_cuda(q, k, v, plan)
        dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()

        def grads(b):
            args = [x[:b] for x in (q, k, v, do, lse, dsum)]
            return (bs.block_sparse_attention_dq_cuda(*args, plan),
                    *bs.block_sparse_attention_dkv_cuda(*args, plan))
        one, again, two = grads(1), grads(1), grads(2)
        torch.cuda.synchronize()
        r = {"repeat_identical": all(bool(torch.equal(a, b))
                                     for a, b in zip(one, again)),
             "row0_b1_vs_b2_identical": all(bool(torch.equal(a[0], b[0]))
                                            for a, b in zip(one, two)),
             "split_units": {side: tp.n_split for side, tp in
                             plan.tile_plans(cfg.block).items()}}
        report[label] = r
        del q, k, v, do, o, lse, dsum, one, again, two
    emit({"check": "block_sparse_bwd_identity", "shape": [S, H, hd],
          "dtype": "bfloat16", "causal": True, **report})
    check(all(r["repeat_identical"] and r["row0_b1_vs_b2_identical"]
              for r in report.values()),
          f"block_sparse_bwd_identity: {report}")
    return report


def sparse_reference_phase(torch, sa):
    """Phase 27b, the reference's own check of the op (the JAX package's
    block-sparse check): ``sparse_self_attention(impl="pallas")`` forward
    and backward against ``impl="dense"`` at S 1024, block 128, bf16 (B 2,
    H 16, hd 96, a Fixed bidirectional and a BigBird unidirectional causal
    layout; the upstream gradient drawn in [-1, 1)): outputs within 2e-2
    and gradient deltas within 0.02."""
    B, S, H, hd = 2, 1024, SP_H, SP_HD
    g = torch.Generator(device="cpu").manual_seed(271)
    report = {}
    for label, cfg, causal in (
            ("fixed_bidir", sa.FixedSparsityConfig(
                H, 128, num_local_blocks=4, num_global_blocks=1), False),
            ("bigbird_unidirectional_causal", sa.BigBirdSparsityConfig(
                H, 128, attention="unidirectional"), True)):
        q, k = (torch.randn(B, S, H, hd, generator=g).to("cuda",
                                                         torch.bfloat16)
                for _ in range(2))
        v, go = ((torch.rand(B, S, H, hd, generator=g) * 2 - 1)
                 .to("cuda", torch.bfloat16) for _ in range(2))
        res = {}
        for impl in ("pallas", "dense"):
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            o = sa.sparse_self_attention(*leaves, cfg, causal=causal,
                                         impl=impl)
            res[impl] = (o.detach(), torch.autograd.grad(o, leaves, go))
        torch.cuda.synchronize()
        (o1, g1), (o2, g2) = res["pallas"], res["dense"]
        r = {"o_delta": float((o1.float() - o2.float()).abs().max()),
             "grad_deltas": [float((a.float() - b.float()).abs().max())
                             for a, b in zip(g1, g2)],
             "grad_max": [float(b.float().abs().max()) for b in g2]}
        report[label] = r
        check(r["o_delta"] <= TOL["bfloat16"]["o"]
              and max(r["grad_deltas"]) <= SP_REF_GRAD_TOL,
              f"sparse_self_attention pallas vs dense {label}: {r}")
    emit({"check": "sparse_self_attention_pallas_vs_dense",
          "shape": [B, S, H, hd], "block": 128, "dtype": "bfloat16",
          "tol_o": TOL["bfloat16"]["o"], "tol_grad": SP_REF_GRAD_TOL,
          **report})
    return report


def sparse_bound(bs, plan, B, S, H, hd, kind):
    """(bound_ms, bound_by) of one kernel call at this plan: the visible
    pairs of the live blocks (a diagonal block half when causal) times 4
    (forward), 6 (dQ) or 8 (dK/dV) x hd flops at the bf16 peak, against
    its inputs read once and outputs written once (bf16 [B, S, H, hd]
    tensors, fp32 [B, H, S] rows, the int32 arrays of the tile plan side
    the bf16 kernel reads: the dQ side for the forward and dQ)."""
    block = S // plan.n
    diag = block * (block + 1) // 2 if plan.causal else block * block
    pairs = B * ((plan.live - plan.live_diag) * block * block
                 + plan.live_diag * diag)
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    x, rows = B * S * H * hd * 2, B * H * S * 4
    side = plan.tile_plan(block, "dkv" if kind == "dkv" else "dq").dev
    plan_bytes = sum(t.numel() * 4 for t in side)
    bytes_ = {"fwd": 4 * x + rows, "dq": 5 * x + 2 * rows,
              "dkv": 6 * x + 2 * rows}[kind] + plan_bytes
    return bound_of(bytes_, 2.0 * products * pairs * hd, BF16_FLOPS)


def sparse_path_phase(torch, sa, bs):
    """Phase 27c, the slice's main path: ``SparseSelfAttention(cfg,
    impl="pallas")`` forward and ``.backward()`` at B 1, S 16384, H 16, hd
    96 (GPT-2 760M's attention), bf16, causal, for the Fixed and the
    BigBird layout (:func:`sparse_path_configs`): a warm-up call (which
    builds the layout and the device plan), then SP_ITERS timed
    iterations with every count set to 0 just before and read just after
    (exactly one forward, one dQ and one dK/dV launch an iteration). Then
    the plain versions on the same inputs and plan (forward, dsum, dQ and
    dK/dV, as 27a; no launch) hold the kernels' output and gradients at
    this size: o <= 2e-2 abs, gradients <= 2e-2 of each one's max, and for
    each of o, dq, dk, dv (:func:`path_errs`) the relative norm of the
    difference <= SP_PATH_REL_TOL and every row's error within
    SP_PATH_ROW_TOL of that row's max."""
    B, S, H, hd = SP_B, SP_S, SP_H, SP_HD
    g = torch.Generator(device="cuda").manual_seed(272)
    bf = torch.bfloat16
    q, k = (torch.randn(B, S, H, hd, generator=g, device="cuda").to(bf)
            for _ in range(2))
    v, go = ((torch.rand(B, S, H, hd, generator=g, device="cuda") * 2 - 1)
             .to(bf) for _ in range(2))
    runs = {}
    for label, cfg in sparse_path_configs(sa).items():
        attn = sa.SparseSelfAttention(cfg, impl="pallas")
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attn(*leaves, causal=True).backward(go)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_sparse_counts(bs)
        t0 = time.perf_counter()
        for _ in range(SP_ITERS):
            for x in leaves:
                x.grad = None
            attn(*leaves, causal=True).backward(go)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sparse_counts(bs)
        peak = torch.cuda.max_memory_allocated()
        o = attn(*leaves, causal=True).detach()
        grads = [x.grad for x in leaves]
        plan = sa.cached_plan(cfg, S, True, "cuda")
        reset_sparse_counts(bs)
        po, plse = bs.block_sparse_attention_fwd_plain(q, k, v, plan)
        dsum = (go.float() * po.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        pg = (bs.block_sparse_attention_dq_plain(q, k, v, go, plse, dsum,
                                                 plan),
              *bs.block_sparse_attention_dkv_plain(q, k, v, go, plse, dsum,
                                                   plan))
        torch.cuda.synchronize()
        plain_launches = sparse_counts(bs)
        vs_plain = {name: path_errs(torch, a, b) for name, a, b in zip(
            ("o", "dq", "dk", "dv"), (o, *grads), (po, *pg))}
        e_o = vs_plain["o"]["max_abs_err"]
        g_rel = [float((a.float() - b.float()).abs().max())
                 / max(float(b.float().abs().max()), 1e-30)
                 for a, b in zip(grads, pg)]
        finite = all(bool(torch.isfinite(t).all()) for t in (o, *grads))
        r = {"phase": "sparse_attention_path", "layout": label,
             "config": {k2: v2 for k2, v2 in vars(cfg).items()},
             "shape": [B, S, H, hd], "dtype": "bfloat16", "causal": True,
             "block": cfg.block, "live_blocks": plan.live,
             "density": plan.live / (H * plan.n * plan.n),
             "max_active": plan.max_active, "max_q": plan.max_q,
             "first_call_s": first_s, "iters": SP_ITERS,
             "fwd_bwd_ms": wall / SP_ITERS * 1e3,
             "peak_allocated_gb": peak / 1e9, "launches": launches,
             "plain_run_launches": plain_launches,
             "vs_plain_max_abs_err_o": e_o, "vs_plain_rel_err_grads": g_rel,
             "vs_plain": vs_plain, "tol_rel_norm": SP_PATH_REL_TOL,
             "tol_row": SP_PATH_ROW_TOL, "finite": finite}
        emit(r)
        check(launches == {n: SP_ITERS for n in SPARSE_KERNELS},
              f"sparse path {label}: launches {launches} != {SP_ITERS} each")
        check(all(v2 == 0 for v2 in plain_launches.values()),
              f"sparse path {label}: the plain run launched {plain_launches}")
        scaled = all(m["rel_norm_err"] <= SP_PATH_REL_TOL
                     and m["max_row_rel_err"] <= SP_PATH_ROW_TOL[name]
                     for name, m in vs_plain.items())
        check(finite and e_o <= TOL["bfloat16"]["o"]
              and max(g_rel) <= BWD_TOL["bfloat16"] and scaled,
              f"sparse path {label} vs plain: o err {e_o}, grads {g_rel}, "
              f"{vs_plain}")
        runs[label] = r
        del attn, leaves, o, grads, po, plse, dsum, pg
        torch.cuda.empty_cache()
    return (q, k, v, go), runs


def sparse_times(torch, F, sa, bs, fa, inputs):
    """Phase 27d: each kernel timed (CUDA events) at the path's shape for
    both layouts, beside its plain version, its bound and SDPA with the
    layout expanded to a boolean [S, S] mask (shared across heads; forward
    alone, and forward + backward less forward for the pair); and, for
    context, the port's dense causal flash kernels at the same shape."""
    q, k, v, go = inputs
    B, S, H, hd = q.shape
    times = {}
    for label, cfg in sparse_path_configs(sa).items():
        plan = sa.cached_plan(cfg, S, True, "cuda")
        o, lse = bs.block_sparse_attention_fwd_cuda(q, k, v, plan)
        dsum = (go.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, go, lse, dsum, plan)
        t = {
            "block_sparse_attention_fwd": {
                "kernel_ms": time_ms(lambda: bs.block_sparse_attention_fwd_cuda(
                    q, k, v, plan), reps=5, inner=3),
                "plain_ms": time_ms(lambda: bs.block_sparse_attention_fwd_plain(
                    q, k, v, plan), reps=2, inner=1, warmup=1)},
            "block_sparse_attention_dq": {
                "kernel_ms": time_ms(lambda: bs.block_sparse_attention_dq_cuda(
                    *args), reps=5, inner=3),
                "plain_ms": time_ms(lambda: bs.block_sparse_attention_dq_plain(
                    *args), reps=2, inner=1, warmup=1)},
            "block_sparse_attention_dkv": {
                "kernel_ms": time_ms(lambda: bs.block_sparse_attention_dkv_cuda(
                    *args), reps=5, inner=3),
                "plain_ms": time_ms(lambda: bs.block_sparse_attention_dkv_plain(
                    *args), reps=2, inner=1, warmup=1)}}
        for name, kind in zip(SPARSE_KERNELS, ("fwd", "dq", "dkv")):
            t[name]["bound_ms"], t[name]["bound_by"] = sparse_bound(
                bs, plan, B, S, H, hd, kind)
        # the library yardstick: SDPA with the layout as a boolean mask
        mask = sa.layout_to_mask(sa.cached_layout(cfg, S)[:1], S, "cuda")
        mask = (mask & torch.tril(torch.ones(S, S, dtype=torch.bool,
                                             device="cuda")))[None]
        qt, kt, vt, got = (x.transpose(1, 2) for x in (q, k, v, go))
        ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        fwd_ms = time_ms(sdpa, reps=5, inner=2)
        pair_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (ql, kl, vl),
                                                      got),
                          reps=5, inner=2) - fwd_ms
        t["block_sparse_attention_fwd"]["library_ms"] = fwd_ms
        for name in SPARSE_KERNELS[1:]:
            t[name]["library_ms"] = pair_ms
            t[name]["library_is_for_the_pair"] = True
        for name in SPARSE_KERNELS:
            t[name]["work"] = (f"{label} layout, block {cfg.block}, B {B}, "
                               f"S {S}, H {H}, hd {hd}, bf16, causal, "
                               f"{plan.live} live blocks")
        # the bf16 kernels' tile plans: fill (live pairs over computed
        # pairs) per side, items, splits, workspace
        t["tile_plan"] = tile_plan_report(plan.tile_plans(cfg.block), hd)
        times[label] = t
        emit({"phase": "sparse_attention_times", "layout": label, **t})
        del o, lse, dsum, args, mask, ql, kl, vl
        torch.cuda.empty_cache()
    # context: the port's dense causal flash kernels at the same shape
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    delta = (go.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dense = {
        "ds_flash_fwd_ms": time_ms(lambda: fa.flash_attention_fwd_cuda(
            q, k, v), reps=3, inner=1),
        "ds_flash_bwd_dkv_ms": time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
            q, k, v, go, lse, delta), reps=3, inner=1),
        "ds_flash_bwd_dq_ms": time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
            q, k, v, go, lse, delta), reps=3, inner=1),
        "fwd_bound_ms": attn_bound(B, S, H, H, hd, 2, True, 2, 2, 1)[0],
        "bwd_bound_ms": attn_bound(B, S, H, H, hd, 7, True, 3, 4, 2)[0]}
    emit({"phase": "sparse_attention_dense_flash_context",
          "shape": [B, S, H, hd], "dtype": "bfloat16", "causal": True,
          **dense})
    return times, dense


def sparse_attention_phase(torch, F, fa):
    """Phase 27: the block-sparse slice (27a kernels and the forward's and
    backward's identities, 27b the reference's check, 27c the main path,
    27d times)."""
    sa, bs = sparse_modules()
    errs, rel, zeros = sparse_kernel_phase(torch, sa, bs)
    fwd_identity = sparse_fwd_identity(torch, sa, bs)
    identity = sparse_bwd_identity(torch, sa, bs)
    ref = sparse_reference_phase(torch, sa)
    inputs, runs = sparse_path_phase(torch, sa, bs)
    times, dense = sparse_times(torch, F, sa, bs, fa, inputs)
    del inputs
    torch.cuda.empty_cache()
    for r in runs.values():
        for name, kern in (("o", "fwd"), ("dq", "dq"), ("dk", "dkv"),
                           ("dv", "dkv")):
            kern = "block_sparse_attention_" + kern
            errs[kern] = max(errs[kern], r["vs_plain"][name]["max_abs_err"])
    return {"errs": errs, "rel": rel, "zeros": zeros, "reference": ref,
            "runs": runs, "times": times, "dense_flash": dense,
            "identity": identity, "fwd_identity": fwd_identity}


#: what each variant row of the kernels line replaces, beside the TPU
#: kernel's file and line
VARIANT_NOTES = {
    "ds_fused_layer_llama_spec":
    " (Llama spec: RMSNorm, split QKV, rotary, SwiGLU)",
    "ds_fused_layer_mixtral_spec":
    " (Mixtral spec: RMSNorm, split QKV, rotary, GQA rep 4, mlp none)",
    "ds_fused_layer_neox_spec":
    " (NeoX spec: head-major QKV, partial rotary, parallel residual, "
    "exact GELU)",
    "ds_fused_layer_bloom_spec":
    " (BLOOM spec: head-major QKV, ALiBi, tanh GELU, serial residual)",
    "ds_ggemm_t": " (transpose_rhs=True)",
    "decode_attention_alibi": " (alibi=True)",
    "decode_attention_windowed": " (windowed=True)",
}


def fused_paths(runs, prefix):
    """The fused layer's launches on the fused arms whose names start with
    ``prefix`` (by arm), and their sum."""
    paths = {arm: n["ds_fused_layer"] for arm, n in runs.items()
             if arm.startswith(prefix) and arm.endswith("_fused")}
    return sum(paths.values()), paths


def no_qgemm_tile(label, fn):
    """Run serving phase ``label`` and hold qgemm's tile form (M > 128, its
    own counter) at no launch there: every decode path runs at most 128
    rows, and prefill dequantizes instead."""
    qg = int8_modules()[1]
    n0 = qg.qgemm.tile_launches
    out = fn()
    n = qg.qgemm.tile_launches - n0
    emit({"check": "qgemm_tile_launches", "phase": label, "launches": n})
    check(n == 0, f"{label}: {n} qgemm launches took the tile form")
    return out


# --------------------------------- BERT and the families' training (slice 10)
#: bench.py's BERT arm (BASELINE row 1): (seq, micro-batch) arms
BERT_ARMS = ((512, 32), (128, 128))
BERT_H, BERT_HD = 16, 64                # bert-large
#: fp32 BERT parity at BERT-Large's widths, depth cut for the time limit
BERT_PARITY = dict(layers=4, micro=2, gas=2, seq=512, steps=3)
#: fp32 parity of the trained families at their served configs' widths
FAMILY_PARITY = dict(layers=2, micro=2, gas=2, seq=512, steps=3)
#: bf16 training at full width: (family, size, layers run, layers of the
#: published model); depth cut for the smoke's time limit
FAMILY_TRAIN = (("llama", "7b", 4, 32), ("neox", "20b", 4, 44),
                ("bloom", "560m", 24, 24), ("gptneo", "2.7b", 8, 32))
FAMILY_SEQ, FAMILY_MICRO = 1024, 4
FAMILY_WARMUP, FAMILY_TIMED = 2, 5
#: families whose attention is the flash kernels (the others run the
#: reference's plain einsum forms, ALiBi and banded)
FLASH_FAMILIES = ("gpt2", "bert", "llama", "neox")


def family_model(family, size, **over):
    from deepspeed_tpu_torch.serving.server import model_from_spec
    return model_from_spec(f"{family}:{size}", **over)


def trailing_pads(np, rows, S):
    """[rows, S] int32 padding mask (1 real, 0 pad): trailing pads of a
    different length, 1 to S / 2, in each row after the first."""
    mask = np.ones((rows, S), np.int32)
    for r in range(1, rows):
        mask[r, S - 1 - (r * 37) % (S // 2):] = 0
    return mask


def real_rows_err(torch, o, q, k, v, seg):
    """Max abs difference of the flash route's output ``o`` from the plain
    bidirectional attention on the real-token rows (segment 1) only: the
    plain route masks keys alone, so its pad rows differ by design."""
    from deepspeed_tpu_torch.ops.attention import \
        plain_bidirectional_attention
    po = plain_bidirectional_attention(q, k, v, seg)
    return float((o.float() - po.float()).abs()[seg.bool()].max())


def mlm_batch(np, rng, lead, S, V, pad=False, types=False):
    """bench.py's BERT batch: ids in [0, V), 15 % of the positions
    labelled with their id and -100 elsewhere (position 0 always
    labelled).  ``pad``: trailing pads of a different length in each row
    after the first (1 to S / 2), labels -100 there, ``attention_mask``
    1 real / 0 pad; ``types``: token types 0, then 1 from the middle."""
    ids = rng.integers(0, V, lead + (S,), dtype=np.int32)
    picked = rng.random(ids.shape) < 0.15
    picked[..., 0] = True
    b = {"input_ids": ids}
    if pad:
        mask = trailing_pads(np, ids.size // S, S).reshape(ids.shape)
        picked &= mask == 1
        b["attention_mask"] = mask
    if types:
        b["token_type_ids"] = np.broadcast_to(
            (np.arange(S) >= S // 2).astype(np.int32), ids.shape).copy()
    b["labels"] = np.where(picked, ids, -100).astype(np.int32)
    return b


def lm_batch(np, rng, lead, S, V):
    return {"input_ids": rng.integers(0, V, lead + (S,), dtype=np.int32)}


def flash_want(family, L, micro_steps):
    """Exact flash launches of ``micro_steps`` micro-steps under full
    remat: 2 L forward (the recompute launches it again), L dK/dV, L dQ;
    none for the plain-attention families."""
    n = L * micro_steps if family in FLASH_FAMILIES else 0
    return {"ds_flash_fwd": 2 * n, "ds_flash_bwd_dkv": n,
            "ds_flash_bwd_dq": n}


def path_flash_check(torch, fa, eng, mb, label):
    """One micro-step of a training path with its flash launches kept
    (``capture_grouped``), the first forward and backward launch each held
    against the kernels' plain versions on the same inputs (the path's
    own q, k, v, dO, lse, delta and segment ids; fp32 o / lse /
    gradients <= 1e-4 abs, bf16 o <= 2e-2 abs, lse <= 1e-3, gradients
    <= 2e-2 of each output's max); with segment ids also the forward's
    real-token rows against the plain route (``real_rows_err``).
    Launches here are not the path's count (the counts were read
    before)."""
    names = ("flash_attention_fwd_cuda", "flash_attention_bwd_cuda")
    with capture_grouped(fa, names) as cap:
        eng._loss_and_grads(mb)
    torch.cuda.synchronize()
    first = {}
    for name, args, out in cap.calls:
        first.setdefault(name, (args, out))
    del cap
    with torch.no_grad():
        return _path_flash_check(torch, fa, first, names, label)


def _path_flash_check(torch, fa, calls, names, label):
    (q, k, v, seg, causal, sm), (o, lse) = calls[names[0]]
    dt_name = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    ro, rl = fa.flash_attention_fwd_plain(q, k, v, seg, causal, sm)
    r = {"check": "path_flash", "path": label, "dtype": dt_name,
         "shape": list(q.shape), "causal": bool(causal),
         "segments": seg is not None,
         "max_abs_err_o": float((o.float() - ro.float()).abs().max()),
         "max_abs_err_lse": float((lse - rl).abs().max())}
    tol = TOL[dt_name]
    ok = r["max_abs_err_o"] <= tol["o"] and r["max_abs_err_lse"] <= tol["lse"]
    if seg is not None and not causal:
        real = seg.bool()
        r["max_abs_err_o_real_rows_vs_plain_route"] = e = real_rows_err(
            torch, o, q, k, v, seg)
        r["real_rows"], r["pad_rows"] = int(real.sum()), int((~real).sum())
        ok = ok and e <= tol["o"]
    args, got = calls[names[1]]
    ref = fa.flash_attention_bwd_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        e, held = err_of(torch, a, b, dt_name)
        r[f"max_abs_err_{name}"], r[f"held_{name}"] = e, held
        ok = ok and held <= BWD_TOL[dt_name]
    r["tol"], r["bwd_tol"] = tol, BWD_TOL[dt_name]
    emit(r)
    check(ok, f"{label}: the path's flash launches vs plain: {r}")
    return r


def named_leaves(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(named_leaves(v, f"{prefix}{key}/"))
        else:
            out[prefix + key] = v
    return out


def key_bias_cols(family, cfg):
    """The key bias's columns of ``blocks/qkv_b`` (an analytically zero
    gradient: a per-query shift of every score; its rounding noise turns
    into +-lr Adam steps): fused [q | k | v] for GPT-2, BERT and GPT-Neo,
    head-major [h: q | k | v] for NeoX and BLOOM; none for Llama."""
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    if family in ("gpt2", "bert", "gptneo"):
        return list(range(D, 2 * D))
    if family in ("neox", "bloom"):
        return [h * 3 * hd + hd + i for h in range(H) for i in range(hd)]
    return None


def train_parity(torch, dt, fa, family, label, make_model, arms, batches,
                 lr, L):
    """fp32 parity through initialize -> train_batch: ``make_model(arm)``
    for the two arms (the flash kernels against the plain attention, or
    for the plain-attention families remat against no remat), from the
    same params drawn on the card and the same batches (gas 2, WarmupLR,
    clipping): per-step losses within 1e-4 relative, each leaf's
    difference within PARAM_TOL of its movement from the init (the key
    bias within Adam's bound), exact flash launches per step (the first
    arm 2 L / L / L per micro-step under remat for the flash families,
    0 otherwise; the plain arm none); then the path's first flash
    launches against the plain versions (``path_flash_check``)."""
    gas = batches[0]["input_ids"].shape[0]
    cfg = train_config(batches[0]["input_ids"].shape[1], gas, lr,
                       gradient_clipping=1.0,
                       scheduler={"type": "WarmupLR",
                                  "params": {"warmup_num_steps": 3}})
    init, runs, path = None, {}, None
    for arm in arms:
        model = make_model(arm)
        if init is None:
            init = model.init(0, "cuda", torch.float32)
        eng, *_ = dt.initialize(model=model, config=cfg,
                                model_parameters=init)
        losses, per_step = [], []
        for b in batches:
            reset_flash(fa)
            losses.append(float(eng.train_batch(batch=b)))
            per_step.append(launch_counts(fa))
        if arm == arms[0] and family in FLASH_FAMILIES:
            path = path_flash_check(torch, fa, eng, {
                k: v[0] for k, v in batches[0].items()}, label)
        runs[arm] = ({k: t.detach() for k, t in
                      named_leaves(eng.params).items()}, losses, per_step)
        sched = eng.lr_schedule
        del eng
        torch.cuda.empty_cache()
    (pa, la, ca), (pb, lb, cb) = runs[arms[0]], runs[arms[1]]
    rel = [abs(a - b) / abs(b) for a, b in zip(la, lb)]
    kcols = key_bias_cols(family, model.config)
    adam_bound = 2 * sum(sched(t) for t in range(len(batches)))
    ratios, kbias = {}, None
    init_named = named_leaves(init)
    for name, a in pa.items():
        b, p0 = pb[name], init_named[name]
        if name == "blocks/qkv_b" and kcols is not None:
            kbias = float((a[:, kcols] - b[:, kcols]).abs().max())
            skip = set(kcols)
            keep = [c for c in range(a.shape[1]) if c not in skip]
            a, b, p0 = a[:, keep], b[:, keep], p0[:, keep]
        ratios[name] = _diff_ratio(torch, a, b, p0)
    want = flash_want(family, L, gas)
    plain_want = want if arms[1] == "no_remat" else flash_want("plain", L, 0)
    report = {"phase": "train_parity", "path": label, "arms": list(arms),
              "layers": L, "micro": cfg["train_micro_batch_size_per_gpu"],
              "gas": gas, "seq": batches[0]["input_ids"].shape[-1],
              "steps": len(batches), f"losses_{arms[0]}": la,
              f"losses_{arms[1]}": lb, "loss_rel_err": rel,
              f"launches_per_step_{arms[0]}": ca,
              f"launches_per_step_{arms[1]}": cb,
              "want_per_step": want, "param_diff_over_movement": ratios,
              "max_param_ratio": max(ratios.values()),
              "key_bias_max_abs_diff": kbias, "key_bias_adam_bound":
              adam_bound, "param_tol": PARAM_TOL, "path_flash": path}
    emit(report)
    check(all(math.isfinite(x) for x in la + lb),
          f"{label}: non-finite loss {la} {lb}")
    check(all(r <= 1e-4 for r in rel), f"{label}: losses differ {rel}")
    check(all(c == want for c in ca), f"{label}: {arms[0]} launches {ca} "
          f"!= {want} per step")
    check(all(c == plain_want for c in cb),
          f"{label}: {arms[1]} launches {cb} != {plain_want} per step")
    check(max(ratios.values()) <= PARAM_TOL,
          f"{label}: params differ {ratios}")
    check(kbias is None or kbias <= adam_bound,
          f"{label}: key bias {kbias} beyond Adam's bound {adam_bound}")
    del init
    torch.cuda.empty_cache()
    return report


def bf16_train_arm(torch, dt, fa, family, label, model, micro, S, warmup,
                   timed, make_batch, profile=False, path_check=False):
    """bf16 training at full width through initialize -> train_batch
    with bench.py's optimizer byte diet (Kahan bf16 masters, bf16
    moments and gradient accumulation), ZeRO stage 2 on one device, gas
    1, weights drawn on the card: ``warmup`` steps, then ``timed`` steps
    with the counts set to 0 just before and read just after (exact
    flash launches, ``flash_want``); step time, tokens/s, MFU by
    bench.py's formula ((6 N + 6 L S D) flops a token: its attention
    term is the causal half of 12 L S D, for BERT too) against 989
    TFLOP/s, peak memory, losses; optionally one profiled step and the
    path's first flash launches against the plain versions."""
    import numpy as np
    c = model.config
    cfg = train_config(micro, 1, 1e-4,
                       bf16={"enabled": True,
                             "master_weights_dtype": "bfloat16",
                             "optimizer_states_dtype": "bfloat16"},
                       data_types={"grad_accum_dtype": "bf16"})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, *_ = dt.initialize(model=model, config=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)

    def batch():
        return make_batch(np, rng, (1, micro), S, c.vocab_size)
    losses = [eng.train_batch(batch=batch()) for _ in range(warmup)]
    steps = [batch() for _ in range(timed)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    t0 = time.perf_counter()
    losses += [eng.train_batch(batch=b) for b in steps]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = wall / timed
    tokens_per_s = micro * S / step_s
    flops_per_token = model.flops_per_token \
        + 6.0 * c.num_layers * S * c.d_model
    report = {"phase": "bf16_train", "path": label,
              "model": model.meta["name"], "layers": c.num_layers,
              "n_params": model.meta["n_params"], "micro_batch": micro,
              "seq": S, "init_s": init_s, "warmup_steps": warmup,
              "timed_steps": timed, "step_s": step_s,
              "tokens_per_s": tokens_per_s,
              "flops_per_token": flops_per_token,
              "mfu": flops_per_token * tokens_per_s / BF16_FLOPS,
              "peak_allocated_gb": peak / 1e9, "first_loss": losses[0],
              "last_loss": losses[-1], "losses": losses,
              "launches": launches}
    if profile:
        report["train_profile"] = profile_train_step(torch, eng, batch())
    if path_check:
        report["path_flash"] = path_flash_check(
            torch, fa, eng, {k: v[0] for k, v in batch().items()}, label)
    emit(report)
    want = flash_want(family, c.num_layers, timed)
    check(launches == want, f"{label}: launches {launches} != {want}")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss {losses}")
    del eng
    torch.cuda.empty_cache()
    return report


def bert_shape_inputs(torch, fa, g, B, S, H, hd, seg):
    """BERT-Large attention inputs as the path gives them: q / k / v
    strided views of one fused [B, S, 3 H hd] projection (V drawn in
    [-1, 1)), dO, and ``seg``: trailing pads of 1 to S / 2 positions in
    each row after the first as segment ids (real 1, pad 0); the forward
    kernel's lse and delta."""
    qkv = torch.randn(B, S, 3 * H * hd, generator=g)
    qkv[..., 2 * H * hd:] = torch.rand(B, S, H * hd, generator=g) * 2 - 1
    q, k, v = (t.unflatten(-1, (H, hd)) for t in
               qkv.to("cuda", torch.bfloat16).split(H * hd, dim=-1))
    do = (torch.rand(B, S, H, hd, generator=g) * 2 - 1).to(
        "cuda", torch.bfloat16)
    sg = None
    if seg:
        import numpy as np
        sg = torch.from_numpy(trailing_pads(np, B, S)).cuda()
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, sg, False)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, sg


def seg_bound(B, S, H, hd, sg, products, q_side, kv_side, rows):
    """(bound_ms, bound_by) of non-causal attention work: ``products``
    matrix products over the (query, key) pairs this run's segment ids
    leave (every pair without them), tensors moved once as
    ``attn_bound``."""
    if sg is None:
        pairs = B * S * S
    else:
        real = sg.sum(-1).double()
        pairs = int((real ** 2 + (S - real) ** 2).sum())
    flops = products * 2.0 * pairs * hd * H
    bytes_ = (q_side + kv_side) * B * S * H * hd * 2 + rows * B * H * S * 4
    t_ops, t_bytes = flops / BF16_FLOPS, bytes_ / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bert_kernel_phase(torch, F, fa):
    """Phase 28: the flash forward and backward pair at BERT-Large's
    pretraining shape (B 32, S 512, H 16, hd 64, bf16, non-causal, the
    fused-QKV views), without segment ids (bench.py's batch) and with a
    padding mask as segment ids: each kernel against its plain version
    (o <= 2e-2 abs, lse <= 1e-3, gradients <= 2e-2 of each output's max;
    with segments the forward's real rows also against the plain
    bidirectional attention), then timed (CUDA events; device time)
    beside the plain version, SDPA (a boolean same-segment mask with
    segments) and the bound (the pairs the segments leave)."""
    S, B = BERT_ARMS[0]
    H, hd = BERT_H, BERT_HD
    g = torch.Generator(device="cpu").manual_seed(28)
    out, errs, rel = {}, {}, {}
    for seg in (False, True):
        label = "segments" if seg else "no_segments"
        q, k, v, do, lse, delta, sg = bert_shape_inputs(
            torch, fa, g, B, S, H, hd, seg)
        tol = TOL["bfloat16"]
        o, lk = fa.flash_attention_fwd_cuda(q, k, v, sg, False)
        ro, rl = fa.flash_attention_fwd_plain(q, k, v, sg, False)
        row = {"check": "ds_flash_bert_shape", "segments": seg,
               "shape": [B, S, H, hd], "dtype": "bfloat16",
               "causal": False, "fused_qkv_views": True,
               "max_abs_err_o": float((o.float() - ro.float()).abs().max()),
               "max_abs_err_lse": float((lk - rl).abs().max())}
        ok = (row["max_abs_err_o"] <= tol["o"]
              and row["max_abs_err_lse"] <= tol["lse"])
        if seg:
            row["max_abs_err_o_real_rows_vs_plain_route"] = e = \
                real_rows_err(torch, o, q, k, v, sg)
            ok = ok and e <= tol["o"]
        errs["ds_flash_fwd"] = max(errs.get("ds_flash_fwd", 0.0),
                                   row["max_abs_err_o"])
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta, sg,
                                          False)
        ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, sg,
                                           False)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            e, r = err_of(torch, a, b, "bfloat16")
            row[f"max_abs_err_{name}"], row[f"rel_err_{name}"] = e, r
            kern = "ds_flash_bwd_dq" if name == "dq" else "ds_flash_bwd_dkv"
            errs[kern] = max(errs.get(kern, 0.0), e)
            rel[kern] = max(rel.get(kern, 0.0), r)
            ok = ok and r <= BWD_TOL["bfloat16"]
        emit(row)
        check(ok, f"flash at BERT-Large's shape ({label}): {row}")
        del o, ro, rl, lk, got, ref
        torch.cuda.empty_cache()
        # ---- times on the same inputs
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = ({"attn_mask": (sg[:, None, :, None] == sg[:, None, None, :])}
              if seg else {"is_causal": False})
        args = (q, k, v, do, lse, delta, sg, False)
        fwd = {"kernel_ms": time_ms(
                   lambda: fa.flash_attention_fwd_cuda(q, k, v, sg, False)),
               "device_ms": device_ms(torch, [
                   lambda: fa.flash_attention_fwd_cuda(q, k, v, sg, False)],
                   reps=20, one_kernel=True)[0],
               "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(
                   q, k, v, sg, False), reps=5, inner=2),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, **kw)),
               "library_device_ms": device_ms(torch, [
                   lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)],
                   reps=20)[0]}
        fwd["bound_ms"], fwd["bound_by"] = seg_bound(B, S, H, hd, sg, 2, 2,
                                                     2, 1)
        dkv = {"kernel_ms": time_ms(
                   lambda: fa.flash_attention_bwd_dkv_cuda(*args)),
               "device_ms": device_ms(torch, [
                   lambda: fa.flash_attention_bwd_dkv_cuda(*args)], reps=20,
                   one_kernel=True)[0]}
        dq = {"kernel_ms": time_ms(
                  lambda: fa.flash_attention_bwd_dq_cuda(*args)),
              "device_ms": device_ms(torch, [
                  lambda: fa.flash_attention_bwd_dq_cuda(*args)], reps=20,
                  one_kernel=True)[0]}
        dkv["bound_ms"], dkv["bound_by"] = seg_bound(B, S, H, hd, sg, 4, 2,
                                                     4, 2)
        dq["bound_ms"], dq["bound_by"] = seg_bound(B, S, H, hd, sg, 3, 3,
                                                   2, 2)
        plain = time_ms(lambda: fa.flash_attention_bwd_plain(*args),
                        reps=5, inner=2)
        lib = sdpa_bwd_device_ms(torch, F, q, k, v, do, sdpa_kw=kw)
        for r in (dkv, dq):
            r.update(plain_ms=plain, library_ms=lib["library"],
                     library_device_ms=lib["library"],
                     library_kernels_per_call=lib["library_kernels_per_call"],
                     plain_and_library_are_for_the_pair=True)
        pair_bound = seg_bound(B, S, H, hd, sg, 7, 4, 3, 2)
        out[label] = {"ds_flash_fwd": fwd, "ds_flash_bwd_dkv": dkv,
                      "ds_flash_bwd_dq": dq, "pair_bound_ms": pair_bound[0],
                      "pair_bound_by": pair_bound[1],
                      "real_tokens": int(sg.sum()) if seg else B * S}
        del q, k, v, do, lse, delta, sg, qt, kt, vt, kw, args
        torch.cuda.empty_cache()
    emit({"phase": "bert_kernel_times", "shape": [B, S, H, hd],
          "dtype": "bfloat16", "causal": False,
          "times_by": "kernel_ms and library_ms: CUDA events; device_ms and "
          "library_device_ms: the profiler (SDPA's backward: forward + "
          "backward less forward)", **out})
    return out, errs, rel


def bert_parity_phase(torch, dt, fa):
    """Phase 29: fp32 BERT at BERT-Large's widths (4 of its 24 layers),
    padded MLM batches with token types (``mlm_batch``), the flash
    kernels (impl "auto": segment ids from the padding mask) against the
    plain attention (impl "plain") through initialize -> train_batch
    (``train_parity``)."""
    import numpy as np
    from deepspeed_tpu_torch.models.bert import bert_model
    p = BERT_PARITY
    rng = np.random.default_rng(29)
    batches = [mlm_batch(np, rng, (p["gas"], p["micro"]), p["seq"], 30522,
                         pad=True, types=True) for _ in range(p["steps"])]
    return train_parity(
        torch, dt, fa, "bert", "bert_large_fp32_parity",
        lambda arm: bert_model("large", num_layers=p["layers"],
                               max_seq_len=p["seq"], dtype="float32",
                               remat=True, attention_impl=
                               "auto" if arm == "flash" else "plain"),
        ("flash", "plain"), batches, 1e-4, p["layers"])


def bert_train_phase(torch, dt, fa):
    """Phase 30, the slice's main path: BERT-Large MLM pretraining at
    bench.py's BERT arm (24 layers, d 1024, 16 heads, vocab 30522; S 512
    micro-batch 32, and S 128 micro-batch 128), full remat, the byte
    diet, 3 warm-up and 10 timed steps (``bf16_train_arm``), a profiled
    step and the path's own flash launches held at S 512."""
    from deepspeed_tpu_torch.models.bert import bert_model
    runs = {}
    for S, micro in BERT_ARMS:
        model = bert_model("large", max_seq_len=S, dtype="bfloat16",
                           remat=True, remat_policy="nothing")
        label = f"bert_large_s{S}_b{micro}"
        runs[label] = bf16_train_arm(
            torch, dt, fa, "bert", label, model, micro, S, 3, 10, mlm_batch,
            profile=True, path_check=(S, micro) == BERT_ARMS[0])
        check(abs(runs[label]["first_loss"]
                  - math.log(model.config.vocab_size)) <= 0.5,
              f"{label}: first loss {runs[label]['first_loss']} not near "
              f"ln(V) = {math.log(model.config.vocab_size)}")
    return runs


def family_train_phase(torch, dt, fa):
    """Phase 31: the families' training.  fp32 parity at 2 layers of each
    served config's widths (Llama-2 7B, GPT-NeoX-20B: the flash kernels
    against the plain attention; BLOOM-560m, GPT-Neo 2.7B, whose
    attention is plain as in the reference: remat against no remat;
    ``train_parity``), then bf16 at full width with the depth cut for the
    time limit (``FAMILY_TRAIN``), S 1024, micro-batch 4, 2 warm-up and 5
    timed steps (``bf16_train_arm``)."""
    import numpy as np
    p = FAMILY_PARITY
    parity, train = {}, {}
    for family, size, _, _ in FAMILY_TRAIN:
        arms = (("flash", "plain") if family in FLASH_FAMILIES
                else ("remat", "no_remat"))
        rng = np.random.default_rng(31)
        V = family_model(family, size).config.vocab_size
        batches = [lm_batch(np, rng, (p["gas"], p["micro"]), p["seq"], V)
                   for _ in range(p["steps"])]

        def make(arm, family=family, size=size):
            over = dict(num_layers=p["layers"], dtype="float32",
                        remat=arm != "no_remat")
            if family in FLASH_FAMILIES:
                over["attention_impl"] = "plain" if arm == "plain" else "auto"
            return family_model(family, size, **over)
        parity[family] = train_parity(
            torch, dt, fa, family, f"{family}_{size}_fp32_parity", make,
            arms, batches, 1e-4, p["layers"])
    for family, size, layers, of in FAMILY_TRAIN:
        label = f"{family}_{size}_train_bf16"
        model = family_model(family, size, num_layers=layers,
                             dtype="bfloat16", remat=True)
        train[label] = bf16_train_arm(
            torch, dt, fa, family, label, model, FAMILY_MICRO, FAMILY_SEQ,
            FAMILY_WARMUP, FAMILY_TIMED, lm_batch)
        train[label]["layers_of_published"] = of
    return parity, train


# ------------------------------------------------------ fp16 (slice 11)
#: the fp16 forms' tolerances: o abs (v in [-1, 1), where one fp16 ulp is
#: 2^-10), lse abs; gradients relative to each output's max
TOL16 = {"o": 5e-3, "lse": 1e-3}
BWD_TOL16 = 1e-2
#: dO scales of the fp16 range sweep (powers of two, as a loss scale; dO
#: is drawn in [-1, 1), so up to 2^15 it stays finite in fp16 while its
#: dS passes fp16's 65504)
F16_SCALE_POWERS = (0, 4, 8, 10, 12, 14, 15)


def f16_case(torch, fa, g, B, S, H, KV, hd, causal, seg, fused,
             do_scale=1.0):
    """One fp16 case against the plain versions: the forward's o and lse,
    then the backward on the kernel forward's (o, lse) with dO times
    ``do_scale``.  Returns (row, errs, rel, (got, ref)) with got / ref the
    backward's (dq, dk, dv)."""
    q, k, v, do, lse, delta, sg = bwd_inputs(
        torch, fa, g, B, S, H, KV, hd, torch.float16, causal, seg, fused)
    if do_scale != 1.0:
        do = (do.float() * do_scale).half()
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, sg, causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
    o, lk = fa.flash_attention_fwd_cuda(q, k, v, sg, causal)
    ro, rl = fa.flash_attention_fwd_plain(q, k, v, sg, causal)
    got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta, sg, causal)
    ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, sg, causal)
    torch.cuda.synchronize()
    errs = {"ds_flash_fwd_f16": float((o.float() - ro.float()).abs().max())}
    row = {"check": "ds_flash_f16", "shape": [B, S, H, KV, hd],
           "causal": causal, "segments": seg, "fused_qkv_views": fused,
           "do_scale": do_scale, "max_abs_err_o": errs["ds_flash_fwd_f16"],
           "max_abs_err_lse": float((lk - rl).abs().max()),
           "tol_o": TOL16["o"], "tol_lse": TOL16["lse"],
           "tol_grads_rel_to_max": BWD_TOL16}
    rel = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        fin = torch.isfinite(b.float())
        e = float((a.float() - b.float())[fin].abs().max()) \
            if bool(fin.any()) else 0.0
        r = e / max(float(b.float()[fin].abs().max()) if bool(fin.any())
                    else 0.0, 1e-30)
        row[f"max_abs_err_{name}"], row[f"rel_err_{name}"] = e, r
        kern = "ds_flash_bwd_dq_f16" if name == "dq" \
            else "ds_flash_bwd_dkv_f16"
        errs[kern] = max(errs.get(kern, 0.0), e)
        rel[kern] = max(rel.get(kern, 0.0), r)
    return row, errs, rel, (got, ref), (q, k, v, do, lse, delta, sg)


def f16_kernel_phase(torch, F, fa):
    """Phase 32: the fp16 forms of the flash forward, dK/dV and dQ
    kernels against their plain versions at every head dim (the training
    shape, GQA, segment ids, non-causal, a ragged S, strided fused-QKV
    views), the identity checks, the range sweep (dO times 2^0 .. 2^15:
    the kernels and the plain versions overflow the same outputs at
    every scale, the loss scaler's skip decision), then GPT-2 760M's
    training shape with and without segment ids, timed (CUDA events,
    device time, each kernel's one launch a call, held at or above its
    bound) beside the plain versions, SDPA in fp16 and the bound.
    Returns (times, errs, rel)."""
    g = torch.Generator(device="cpu").manual_seed(1616)
    H = TRAIN_H
    cases = [(2, TRAIN_S, H, H, True, False, False),
             (2, TRAIN_S, 8, 2, True, False, False),
             (2, 272, H, 4, True, True, False),
             (2, 272, H, H, False, False, False),
             (1, 912, H, H, True, False, True)]
    errs, rel = {}, {}

    def hold(row, e, r, label):
        for d, src in ((errs, e), (rel, r)):
            for kname, val in src.items():
                d[kname] = max(d.get(kname, 0.0), val)
        emit(row)
        check(row["max_abs_err_o"] <= TOL16["o"]
              and row["max_abs_err_lse"] <= TOL16["lse"]
              and max(row[f"rel_err_{n}"] for n in ("dq", "dk", "dv"))
              <= BWD_TOL16, f"fp16 flash {label}: {row}")
    for hd in fa.HEAD_DIMS:
        for (B, S, Hq, KV, causal, seg, fused) in cases:
            row, e, r, _, _ = f16_case(torch, fa, g, B, S, Hq, KV, hd,
                                       causal, seg, fused)
            hold(row, e, r, f"{(B, S, Hq, KV, hd)}")
    # identity: two launches, and batch row 0 at B 1 vs B 4
    for hd in fa.HEAD_DIMS:
        q, k, v, do, lse, delta, _ = bwd_inputs(
            torch, fa, g, 4, 1024, 16, 16, hd, torch.float16, True, False,
            False)
        f1 = fa.flash_attention_fwd_cuda(q, k, v)
        f2 = fa.flash_attention_fwd_cuda(q, k, v)
        fb = fa.flash_attention_fwd_cuda(q[:1], k[:1], v[:1])
        b1 = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta)
        b2 = fa.flash_attention_bwd_cuda(q, k, v, do, lse, delta)
        bb = fa.flash_attention_bwd_cuda(q[:1], k[:1], v[:1], do[:1],
                                         lse[:1], delta[:1])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(f1 + b1, f2 + b2))
        row0 = all(torch.equal(a[:1], b) for a, b in zip(f1 + b1, fb + bb))
        emit({"check": "ds_flash_f16_identity", "shape": [4, 1024, 16, 16,
                                                          hd],
              "two_launches_bit_identical": same,
              "row_0_at_B_1_vs_B_4_bit_identical": row0})
        check(same and row0, f"fp16 flash hd {hd}: two launches identical "
              f"{same}, row 0 at B 1 vs B 4 {row0}")
    # the range sweep at GPT-2's head shape: the kernels and the plain
    # versions must overflow the same outputs (the loss scaler's skip),
    # and agree where finite; max |dS| beside it (fp16 ends at 65504)
    sweep = []
    for pw in F16_SCALE_POWERS:
        row, e, r, (got, ref), ins = f16_case(
            torch, fa, torch.Generator(device="cpu").manual_seed(1617),
            2, TRAIN_S, H, H, TRAIN_HD, True, False, False,
            do_scale=float(2 ** pw))
        q, k, v, do, lse, delta, _ = ins
        with torch.no_grad():      # max |P (dP - delta)| in fp32
            s_ = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
                * TRAIN_HD ** -0.5
            s_ = s_.masked_fill(~torch.ones(TRAIN_S, TRAIN_S, dtype=torch.bool,
                                            device="cuda").tril(),
                                float("-inf"))
            pp = torch.exp(s_ - lse[..., None])
            dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
            ds_max = float((pp * (dp - delta[..., None])).abs().max())
            del s_, pp, dp
        flags = {n: [bool((~torch.isfinite(a)).any()),
                     bool((~torch.isfinite(b)).any())]
                 for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        row.update(scale_power=pw, max_abs_ds=ds_max,
                   ds_beyond_fp16=ds_max > 65504.0,
                   nonfinite_kernel_vs_plain=flags)
        emit(row)
        sweep.append({"scale_power": pw, "max_abs_ds": ds_max,
                      "nonfinite_kernel_vs_plain": flags})
        check(all(a == b for a, b in flags.values()),
              f"fp16 flash at dO x 2^{pw}: the kernels and the plain "
              f"versions overflow different outputs {flags}")
        check(max(row[f"rel_err_{n}"] for n in ("dq", "dk", "dv"))
              <= BWD_TOL16, f"fp16 flash at dO x 2^{pw}: {row}")
        del got, ref, ins
    # GPT-2 760M's training shape, the main path's inputs (fused views),
    # without and with segment ids; timed
    times = {}
    for label, seg in (("no_segments", False), ("segments", True)):
        B, S, hd = TRAIN_B, TRAIN_S, TRAIN_HD
        row, e, r, _, ins = f16_case(torch, fa, g, B, S, H, H, hd, True,
                                     seg, True)
        hold(row, e, r, f"training shape {label}")
        q, k, v, do, lse, delta, sg = ins
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        mask = None
        if seg:
            mask = (sg[:, None, :, None] == sg[:, None, None, :]) & \
                torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
        kw = {"is_causal": True} if mask is None else {"attn_mask": mask}
        fwd = {"kernel_ms": time_ms(
                   lambda: fa.flash_attention_fwd_cuda(q, k, v, sg)),
               "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(
                   q, k, v, sg), reps=5, inner=3),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, **kw)),
               "device_ms": device_ms(torch, [
                   lambda: fa.flash_attention_fwd_cuda(q, k, v, sg)],
                   reps=20, one_kernel=True)[0],
               "library_device_ms": device_ms(torch, [
                   lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)],
                   reps=20)[0]}
        fwd["bound_ms"], fwd["bound_by"] = attn_bound(B, S, H, H, hd, 2,
                                                      True, 2, 2, 1)
        args = (q, k, v, do, lse, delta, sg)
        dkv = {"kernel_ms": time_ms(
                   lambda: fa.flash_attention_bwd_dkv_cuda(*args)),
               "device_ms": device_ms(torch, [
                   lambda: fa.flash_attention_bwd_dkv_cuda(*args)], reps=20,
                   one_kernel=True)[0]}
        dq = {"kernel_ms": time_ms(
                  lambda: fa.flash_attention_bwd_dq_cuda(*args)),
              "device_ms": device_ms(torch, [
                  lambda: fa.flash_attention_bwd_dq_cuda(*args)], reps=20,
                  one_kernel=True)[0]}
        dkv["bound_ms"], dkv["bound_by"] = attn_bound(B, S, H, H, hd, 4,
                                                      True, 2, 4, 2)
        dq["bound_ms"], dq["bound_by"] = attn_bound(B, S, H, H, hd, 3, True,
                                                    3, 2, 2)
        plain = time_ms(lambda: fa.flash_attention_bwd_plain(*args),
                        reps=5, inner=3)
        ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(ql, kl, vl, **kw)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (ql, kl, vl), dot)
        lib = time_ms(sdpa_fwd_bwd) - time_ms(sdpa)
        lib_dev = sdpa_bwd_device_ms(torch, F, q, k, v, do, sdpa_kw=kw)
        for r_ in (dkv, dq):
            r_.update(plain_ms=plain, library_ms=lib,
                      library_device_ms=lib_dev["library"],
                      library_kernels_per_call=lib_dev[
                          "library_kernels_per_call"],
                      plain_and_library_are_for_the_pair=True)
        times[label] = {"ds_flash_fwd_f16": fwd, "ds_flash_bwd_dkv_f16": dkv,
                        "ds_flash_bwd_dq_f16": dq}
        # a device time under the bound is a measurement that lost records
        low = {n: (t["device_ms"], t["bound_ms"])
               for n, t in times[label].items()
               if not t["device_ms"] >= t["bound_ms"]}
        check(not low, f"fp16 flash {label}: device ms under the bound {low}")
        del ins, args, q, k, v, do, ql, kl, vl
        torch.cuda.empty_cache()
    emit({"phase": "f16_kernel_times", "dtype": "float16",
          "shape": [TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_HD], "causal": True,
          "fused_qkv_views": True, "range_sweep": sweep, **times})
    return times, errs, rel


#: the round trips' steps: before the save, after it (the uninterrupted
#: run) and again from a fresh engine that loads the checkpoint
RT_STEPS = 3


def ckpt_root(torch, need_bytes, label):
    """A fresh temporary directory on local disk for one round trip's
    checkpoint; fails when the filesystem has less than twice the state's
    bytes free (the npz is written beside the state it replaces)."""
    import shutil
    import tempfile
    base = tempfile.gettempdir()
    free = shutil.disk_usage(base).free
    check(free >= 2 * need_bytes, f"{label}: {free / 1e9:.1f} GB free under "
          f"{base}, the checkpoint needs {2 * need_bytes / 1e9:.1f} GB")
    return tempfile.mkdtemp(prefix=f"ds_ckpt_{label}_", dir=base), free


def roundtrip_arm(torch, dt, label, make_model, cfg, micro, S, counts,
                  reset, want=None):
    """One training round trip through the port's entry points: a fresh
    engine (weights drawn on the card) takes RT_STEPS steps and
    ``save_checkpoint`` (``checkpoint.async_save`` in ``cfg`` puts the
    write in the background), then RT_STEPS more at once; a second fresh
    engine (its params zeros) ``load_checkpoint``s the tag and takes the
    same RT_STEPS.
    Returns the report; ``resume_bit_identical``: the resumed losses,
    loss scales, skipped steps and final params equal the uninterrupted
    run's bit for bit.  ``counts`` / ``reset`` read and zero the kernel
    launch counts: zeroed before the first step, read after the
    uninterrupted run's last (``want``: the exact counts, if given)."""
    import numpy as np
    import shutil
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map
    model = make_model()
    c = model.config
    rng = np.random.default_rng(0)
    batches = [lm_batch(np, rng, (1, micro), S, c.vocab_size)
               for _ in range(2 * RT_STEPS)]

    def steps(eng, bs):
        out = {"losses": [], "loss_scales": [], "step_ms": []}
        for b in bs:
            t0 = time.perf_counter()
            loss = float(eng.train_batch(batch=b))
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(loss)
            out["loss_scales"].append(eng.loss_scale)
        out["skipped_steps"] = eng.skipped_steps
        return out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, *_ = dt.initialize(model=model, config=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = sum(
        (v.numel() * v.element_size() if torch.is_tensor(v) else 4)
        for v in eng.state_leaves().values())
    root, free = ckpt_root(torch, state_bytes, label)
    torch.cuda.reset_peak_memory_stats()
    reset()
    before = steps(eng, batches[:RT_STEPS])
    t0 = time.perf_counter()
    eng.save_checkpoint(root)
    save_s = time.perf_counter() - t0
    after = steps(eng, batches[RT_STEPS:])
    launches = counts()
    eng.wait_pending_checkpoint()
    times = dict(eng.checkpoint_times)
    peak = torch.cuda.max_memory_allocated()
    final = [p.detach().clone() for p in tree_leaves(eng.params)]
    # the fresh engine starts from zeros (the load must set every leaf;
    # a second host init of the weights would only cost time)
    zeros = tree_map(lambda p: torch.zeros_like(p.detach()), eng.params)
    del eng
    torch.cuda.empty_cache()
    eng2, *_ = dt.initialize(model=make_model(), config=cfg,
                             model_parameters=zeros)
    del zeros
    t0 = time.perf_counter()
    path, _ = eng2.load_checkpoint(root)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resumed = steps(eng2, batches[RT_STEPS:])
    same_params = all(torch.equal(a, b) for a, b in
                      zip(final, tree_leaves(eng2.params)))
    worst = max(float((a.detach().float() - b.detach().float()).abs().max())
                for a, b in zip(final, tree_leaves(eng2.params)))
    ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(path) for f in fs)
    shutil.rmtree(root, ignore_errors=True)
    del eng2, final
    torch.cuda.empty_cache()
    same = {k: after[k] == resumed[k]
            for k in ("losses", "loss_scales", "skipped_steps")}
    same["params"] = same_params
    report = {"path": label, "model": model.meta["name"],
              "layers": c.num_layers, "n_params": model.meta["n_params"],
              "micro_batch": micro, "seq": S, "init_s": init_s,
              "before_save": before, "after_save": after,
              "resumed": resumed, "launches": launches,
              "peak_allocated_gb": peak / 1e9,
              "step_ms_steady": statistics.median(
                  before["step_ms"][1:] + after["step_ms"]),
              "checkpoint_bytes": ckpt_bytes, "state_bytes": state_bytes,
              "disk_free_gb": free / 1e9, "save_s": save_s,
              "save_blocking_s": times.get("save_s"),
              "commit_s": times.get("commit_s"), "load_s": load_s,
              "identical": same, "resume_max_abs_param_diff": worst,
              "resume_bit_identical": all(same.values())}
    check(all(math.isfinite(x) for x in before["losses"] + after["losses"]
              + resumed["losses"]) or before["skipped_steps"] > 0,
          f"{label}: non-finite loss {report}")
    if want is not None:
        check(launches == want, f"{label}: launches {launches} != {want}")
    return report


def f16_train_phase(torch, dt, fa):
    """Phase 33, the slice's main path: GPT-2 760M at bench.py's shapes
    (24 layers, d 1536, micro-batch 12, seq 1024, full remat) in fp16
    with dynamic loss scaling (initial_scale_power 16), Adam's moments
    and the masters fp32, ``checkpoint.async_save``; the round trip of
    ``roundtrip_arm`` held bit-identical; exact flash launches, every one
    an fp16 form's."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    cfg = train_config(TRAIN_B, 1, 1e-4, fp16={"enabled": True},
                       checkpoint={"async_save": True})

    def make():
        return gpt2_model("760m", max_seq_len=TRAIN_S, dtype="float16",
                          remat=True, remat_policy="nothing")
    want = flash_want("gpt2", 24, 2 * RT_STEPS)
    report = roundtrip_arm(
        torch, dt, "gpt2_760m_train_fp16", make, cfg, TRAIN_B, TRAIN_S,
        lambda: {**launch_counts(fa), **f16_launch_counts(fa)},
        lambda: reset_flash(fa),
        want={**want, **{k + "_f16": v for k, v in want.items()}})
    # fp16 MoE on the card is refused until the grouped kernels have an
    # fp16 form, by the queue item's name
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    try:
        dt.initialize(model=mixtral_model("tiny", dtype="float16"),
                      config=train_config(2, 1, 1e-4,
                                          fp16={"enabled": True}))
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    check(refused is not None and "fp16 grouped and block-sparse kernels"
          in refused, f"fp16 MoE on the card was not refused: {refused}")
    report["fp16_moe_refusal"] = refused
    model = make()
    flops = model.flops_per_token + 6.0 * 24 * TRAIN_S * 1536
    report.update(phase="fp16_train", flops_per_token=flops,
                  tokens_per_s=TRAIN_B * TRAIN_S
                  / (report["step_ms_steady"] / 1e3),
                  mfu=flops * TRAIN_B * TRAIN_S
                  / (report["step_ms_steady"] / 1e3) / BF16_FLOPS)
    emit(report)
    check(report["resume_bit_identical"], f"fp16 GPT-2 760M: the resumed "
          f"run differs from the uninterrupted one {report['identical']}")
    return report


def moe_roundtrip_phase(torch, dt, gg, fa):
    """Phase 34: mixtral:1b-moe at full width (8 layers, nothing cut),
    bf16 with bench.py's byte diet, grouped dispatch, the residual MoE
    and the noisy gate ("Jitter"), seq 1024, micro-batch 8, full remat:
    the round trip (``roundtrip_arm``) and exact grouped / flash launches
    of its uninterrupted run; bit-identity reported (an atomic op on the
    path would break it: none is known)."""
    cfg = train_config(MT_B, 1, 1e-4,
                       bf16={"enabled": True,
                             "master_weights_dtype": "bfloat16",
                             "optimizer_states_dtype": "bfloat16"},
                       data_types={"grad_accum_dtype": "bf16"},
                       checkpoint={"async_save": True})

    def make():
        return mt_model("bfloat16", max_seq_len=MT_S, moe_dispatch="grouped",
                        use_residual=True, noisy_gate_policy="Jitter")
    report = roundtrip_arm(
        torch, dt, "mixtral_1b_moe_residual_jitter_bf16", make, cfg, MT_B,
        MT_S, lambda: moe_train_counts(gg, fa),
        lambda: reset_moe_train_counts(gg, fa),
        want=moe_train_want(8, 2 * RT_STEPS))
    report["phase"] = "moe_roundtrip"
    emit(report)
    check(report["resume_bit_identical"], f"MoE round trip: the resumed "
          f"run differs from the uninterrupted one {report['identical']}, "
          f"max param diff {report['resume_max_abs_param_diff']}")
    return report


def diet_roundtrip_phase(torch, dt, fa):
    """Phase 35: the bf16 byte-diet GPT-2 (Kahan bf16 masters, bf16
    moments and gradients) at the 760M widths, 4 of 24 layers (cut for
    time), micro-batch 12, seq 1024: the round trip (synchronous save)
    held bit-identical, which needs the Kahan compensation saved."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    cfg = train_config(TRAIN_B, 1, 1e-4,
                       bf16={"enabled": True,
                             "master_weights_dtype": "bfloat16",
                             "optimizer_states_dtype": "bfloat16"},
                       data_types={"grad_accum_dtype": "bf16"})

    def make():
        return gpt2_model("760m", max_seq_len=TRAIN_S, dtype="bfloat16",
                          num_layers=4, remat=True, remat_policy="nothing")
    report = roundtrip_arm(
        torch, dt, "gpt2_760m_4_layers_bf16_diet", make, cfg, TRAIN_B,
        TRAIN_S, lambda: launch_counts(fa), lambda: reset_flash(fa),
        want=flash_want("gpt2", 4, 2 * RT_STEPS))
    report["phase"] = "diet_roundtrip"
    emit(report)
    check(report["resume_bit_identical"], f"bf16 diet round trip: the "
          f"resumed run differs {report['identical']}")
    return report


def einsum_serving_phase(torch, gg, da, fa):
    """Phase 36: Mixtral-8x7B widths at 2 layers in fp32 with
    ``serving.moe_dispatch="einsum"`` (the GShard capacity tensors in
    plain PyTorch; eval capacity drop-free) through init_inference -> the
    scheduler (a pool that forces a preemption): the greedy tokens equal
    the static generate's under the same dispatch; no expert GEMM launch
    (ds_ggemm counts the fp32 head alone), the flash and decode kernels
    as phase 12 counts them."""
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.moe.layer import dispatch_scope
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             RequestState, SamplingParams)
    import deepspeed_tpu_torch as dt
    L = 2
    t0 = time.perf_counter()
    model = mixtral_model("8x7b", num_layers=L, dtype="float32")
    eng = dt.init_inference(model, {"dtype": "float32"})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=7)
    sched = ContinuousBatchingScheduler(
        model, eng.params, ServingConfig(num_blocks=140,
                                         moe_dispatch="einsum"))
    reset_moe_counts(gg, da, fa)
    t0 = time.perf_counter()
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in prompts]
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = moe_counts(gg, da, fa)
    c = sched.metrics.counters
    mismatched = []
    with dispatch_scope("einsum"):
        for p, r in zip(prompts, reqs):
            ref = eng.generate(p, max_new_tokens=MAX_NEW)[0, p.size:]
            if list(ref) != list(r.output_ids):
                mismatched.append(int(p.size))
    # ds_ggemm: the fp32 head (rows_matmul) alone, once a prefill and
    # once a decode step; no expert GEMM
    want = {"ds_ggemm": c["prefills"] + c["decode_steps"],
            "ds_ggemm_slots": 0, "ds_fused_layer": 0,
            "ds_flash_fwd": L * c["prefills"],
            "decode_attention": L * c["decode_steps"],
            "decode_attention_int8": 0}
    report = {"phase": "einsum_serving", "layers": L, "init_s": init_s,
              "wall_s": wall, "prefills": c["prefills"],
              "decode_steps": c["decode_steps"],
              "preemptions": c["preemptions"], "launches": n, "want": want,
              "token_identical_to_static_generate": not mismatched,
              "mismatched_prompts": mismatched}
    emit(report)
    check(all(r.state == RequestState.FINISHED
              and r.num_generated == MAX_NEW for r in reqs),
          "einsum serving: not every request finished")
    check(c["preemptions"] >= 1, "einsum serving: no preemption forced")
    check(n == want, f"einsum serving: launches {n} != {want}")
    check(not mismatched, f"einsum serving: scheduler != static generate "
          f"for prompt lengths {mismatched}")
    del sched, eng
    torch.cuda.empty_cache()
    return report


def run_only(torch, only, da, fa):
    """``--only``: the listed phases among 2-4, 7-9 and 11-36 alone,
    after the build, for work on one path (no kernels line)."""
    import torch.nn.functional as F
    import deepspeed_tpu_torch as dt
    gg = moe_modules()
    qz, qg, fd = int8_modules()
    table = {
        2: lambda: (kernel_phase(torch, da, fa),
                    kernel_times_phase(torch, F, da, fa)),
        4: lambda: fp32_phase(torch, dt, da, fa),
        9: lambda: no_qgemm_tile(9, lambda: int8_parity_phase(torch, da,
                                                              fa)),
        3: lambda: (bwd_kernel_phase(torch, fa), emit(
            {"phase": "train_kernel_times", **train_kernel_times(
                torch, F, fa)[0]})),
        7: lambda: bf16_train_phase(torch, dt, da, fa),
        8: lambda: int8_kernel_phase(torch, F, da),
        11: lambda: moe_kernel_phase(torch, gg, da, fa),
        12: lambda: mixtral_parity_phase(torch, gg, da, fa),
        13: lambda: mixtral_http_phase(torch, gg, da, fa),
        14: lambda: moe_int8_kernel_phase(torch, gg, qz, qg),
        15: lambda: no_qgemm_tile(
            15, lambda: mixtral_int8_parity_phase(torch, gg, qz, qg, da, fa)),
        16: lambda: no_qgemm_tile(
            16, lambda: mixtral_int8_http_phase(torch, gg, qz, qg, da, fa)),
        17: lambda: (fused_family_phase(torch, qz, da, fd),
                     fused_family_times(torch, qz, da, fd)),
        18: lambda: no_qgemm_tile(
            18, lambda: llama_parity_phase(torch, da, fa)),
        19: lambda: no_qgemm_tile(
            19, lambda: llama_http_phase(torch, da, fa)),
        20: lambda: slice7_kernel_phase(torch, F, da),
        21: lambda: no_qgemm_tile(
            21, lambda: slice7_parity_phase(torch, da, fa)),
        22: lambda: no_qgemm_tile(
            22, lambda: neox_http_phase(torch, da, fa)),
        23: lambda: no_qgemm_tile(
            23, lambda: bloom_gptneo_http_phase(torch, da, fa)),
        24: lambda: moe_train_kernel_phase(torch, gg, fa),
        25: lambda: moe_train_parity_phase(torch, dt, gg, fa),
        26: lambda: moe_train_bf16_phase(torch, dt, gg, fa),
        27: lambda: sparse_attention_phase(torch, F, fa),
        28: lambda: bert_kernel_phase(torch, F, fa),
        29: lambda: bert_parity_phase(torch, dt, fa),
        30: lambda: bert_train_phase(torch, dt, fa),
        31: lambda: family_train_phase(torch, dt, fa),
        32: lambda: f16_kernel_phase(torch, F, fa),
        33: lambda: f16_train_phase(torch, dt, fa),
        34: lambda: moe_roundtrip_phase(torch, dt, gg, fa),
        35: lambda: diet_roundtrip_phase(torch, dt, fa),
        36: lambda: einsum_serving_phase(torch, gg, da, fa)}
    for n in only:
        check(n in table, f"--only: phase {n} is not one of {sorted(table)}")
        table[n]()
        torch.cuda.empty_cache()


def main():
    only = []
    if "--only" in sys.argv[1:]:
        i = sys.argv.index("--only")
        only = [int(n) for n in sys.argv[i + 1].split(",")]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import deepspeed_tpu_torch as dt
        from deepspeed_tpu_torch.ops.kernels import build
        from deepspeed_tpu_torch.ops.kernels import decode_attention as da
        from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the deepspeed_tpu_torch package is not next to "
              f"this script ({e})", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    libs = build.build(KERNEL_SOURCES)
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "build_s_by_source": {n: r["seconds"]
                                for n, r in build.build_log.items()},
          # the -Xptxas -v report: registers and spills per kernel
          "ptxas": [ln.strip() for r in build.build_log.values()
                    for ln in r["log"].splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln or "C75" in ln],
          "ds_flash_fwd_sass": sass_counts(build, libs["ds_flash_fwd"]),
          "ds_flash_bwd_sass": sass_counts(build, libs["ds_flash_bwd"]),
          "grouped_gemm_hopper_sass": sass_counts(
              build, libs["grouped_gemm_hopper"]),
          "grouped_gemm_stream_sass": sass_counts(
              build, libs["grouped_gemm_stream"]),
          "block_sparse_attention_sass": sass_counts(
              build, libs["block_sparse_attention"])})
    grouped_hopper_build_checks(build, libs)
    stream_build_checks(build, libs)
    decode_stream_build_checks(build, libs)
    sparse_build_checks(build, libs)
    decode_build_checks(build)

    if only:
        run_only(torch, only, da, fa)
        print(smi, flush=True)
        emit({"ok": True, "only": only,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}})
        return 0

    errs, tols = kernel_phase(torch, da, fa)
    dec_t, fl_t, flash_by_s = kernel_times_phase(torch, F, da, fa)
    bwd_errs, bwd_rel = bwd_kernel_phase(torch, fa)
    train_t, train_errs, train_rel = train_kernel_times(torch, F, fa)
    errs["ds_flash_fwd"] = max(errs["ds_flash_fwd"],
                               train_errs.pop("ds_flash_fwd"))
    for kern, e in train_errs.items():
        bwd_errs[kern] = max(bwd_errs[kern], e)
        bwd_rel[kern] = max(bwd_rel[kern], train_rel[kern])
    emit({"phase": "train_kernel_times",
          "shape": [TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_HD], "dtype":
          "bfloat16", "causal": True, "fused_qkv_views": True, **train_t})
    torch.cuda.empty_cache()

    eng32 = fp32_phase(torch, dt, da, fa)
    serve_launches, report = bf16_phase(torch, eng32, da, fa)
    del eng32
    torch.cuda.empty_cache()

    fp32_train_phase(torch, dt, da, fa)
    torch.cuda.empty_cache()
    train_launches, train_report = bf16_train_phase(torch, dt, da, fa)
    torch.cuda.empty_cache()

    int8_t, int8_errs = int8_kernel_phase(torch, F, da)
    torch.cuda.empty_cache()
    no_qgemm_tile(9, lambda: int8_parity_phase(torch, da, fa))
    torch.cuda.empty_cache()
    int8_load, int8_runs = no_qgemm_tile(
        10, lambda: int8_http_phase(torch, da, fa))
    torch.cuda.empty_cache()

    gg = moe_modules()
    emit({"phase": "moe_start",
          "memory_allocated": torch.cuda.memory_allocated()})
    moe_t, moe_errs, attn_errs = moe_kernel_phase(torch, gg, da, fa)
    torch.cuda.empty_cache()
    mixtral_parity_phase(torch, gg, da, fa)
    torch.cuda.empty_cache()
    mix = mixtral_http_phase(torch, gg, da, fa)
    mix_n, mix_path = mix["launches"], mix["path_expert_gemms"]
    del mix
    qz, qg, fd = int8_modules()
    moeq_t, moeq_errs, qgemm_mix_t = moe_int8_kernel_phase(torch, gg, qz, qg)
    torch.cuda.empty_cache()
    mixq_par = no_qgemm_tile(15, lambda: mixtral_int8_parity_phase(
        torch, gg, qz, qg, da, fa))
    torch.cuda.empty_cache()
    mixq_load, mixq = no_qgemm_tile(16, lambda: mixtral_int8_http_phase(
        torch, gg, qz, qg, da, fa))
    mq8 = mixq["max_num_seqs_8"]["launches"]
    mq8f = mixq["max_num_seqs_8_fused"]["launches"]
    mq96 = mixq[f"max_num_seqs_{WIDE_SEQS}"]["launches"]
    torch.cuda.empty_cache()

    fam_errs = fused_family_phase(torch, qz, da, fd)
    torch.cuda.empty_cache()
    fam_t = fused_family_times(torch, qz, da, fd)
    torch.cuda.empty_cache()
    no_qgemm_tile(18, lambda: llama_parity_phase(torch, da, fa))
    torch.cuda.empty_cache()
    llama_loads, llama = no_qgemm_tile(
        19, lambda: llama_http_phase(torch, da, fa))
    lq = {arm: run["launches"] for arm, run in llama.items()}
    torch.cuda.empty_cache()

    s7_errs, s7_t = slice7_kernel_phase(torch, F, da)
    torch.cuda.empty_cache()
    no_qgemm_tile(21, lambda: slice7_parity_phase(torch, da, fa))
    torch.cuda.empty_cache()
    neox_loads, neox = no_qgemm_tile(
        22, lambda: neox_http_phase(torch, da, fa))
    torch.cuda.empty_cache()
    bg = no_qgemm_tile(23, lambda: bloom_gptneo_http_phase(torch, da, fa))
    torch.cuda.empty_cache()
    mt_t, mt_errs, mt_flash, mt_ident = moe_train_kernel_phase(torch, gg,
                                                               fa)
    torch.cuda.empty_cache()
    moe_train_parity_phase(torch, dt, gg, fa)
    torch.cuda.empty_cache()
    mt_n, _ = moe_train_bf16_phase(torch, dt, gg, fa)
    torch.cuda.empty_cache()
    sparse = sparse_attention_phase(torch, F, fa)
    torch.cuda.empty_cache()
    bert_t, bert_errs, bert_rel = bert_kernel_phase(torch, F, fa)
    torch.cuda.empty_cache()
    bert_parity_phase(torch, dt, fa)
    bert_runs = bert_train_phase(torch, dt, fa)
    _, fam_train = family_train_phase(torch, dt, fa)
    train10 = {**bert_runs, **fam_train}
    torch.cuda.empty_cache()
    f16_t, f16_errs, f16_rel = f16_kernel_phase(torch, F, fa)
    torch.cuda.empty_cache()
    f16_run = f16_train_phase(torch, dt, fa)
    moe_rt = moe_roundtrip_phase(torch, dt, gg, fa)
    diet_rt = diet_roundtrip_phase(torch, dt, fa)
    einsum_serving_phase(torch, gg, da, fa)
    #: slice 11's bf16 round trips, by path: their uninterrupted runs'
    #: launches
    rt_paths = {r["path"]: r["launches"] for r in (moe_rt, diet_rt)}
    s7 = {f"neox_http_{arm}": run["launches"] for arm, run in neox.items()}
    s7_loads = {"neox_int8_load": neox_loads}
    for fam, label in (("bloom_560m", "bloom"), ("gptneo_2.7b", "gptneo")):
        s7.update({f"{label}_http_{arm}": run["launches"]
                   for arm, run in bg[fam].items()
                   if isinstance(run, dict) and "launches" in run})
        s7_loads[f"{label}_int8_load"] = bg[fam]["engine_load"]

    def paths_of(name, **earlier):
        """The kernel's launches on each main path (those given, then the
        int8 Mixtral arms', the Llama arms' and slice 7's), and their
        sum."""
        paths = {**earlier, "mixtral_int8_http_8": mq8.get(name, 0),
                 "mixtral_int8_http_8_fused": mq8f.get(name, 0),
                 f"mixtral_int8_http_{WIDE_SEQS}": mq96.get(name, 0),
                 **{f"llama_http_{arm}": n[name] for arm, n in lq.items()
                    if name in n},
                 **{arm: n[name] for arm, n in s7.items() if name in n}}
        paths = {k: v for k, v in paths.items() if v}
        return sum(paths.values()), paths

    pallas = "deepspeed_tpu/ops/pallas/"
    fwd_t = dict(train_t["ds_flash_fwd"],
                 serving_b1_s1024=fl_t)      # PR 1's serving-shape row
    for dt_name, e in attn_errs.items():
        errs["decode_attention"] = max(errs["decode_attention"],
                                       e["decode_attention"])
        errs["ds_flash_fwd"] = max(errs["ds_flash_fwd"], e["ds_flash_fwd"])
    # the flash kernels at the MoE training shape (phase 24) and at
    # BERT-Large's (phase 28)
    for fl in (mt_flash, {"errs": bert_errs, "rel": bert_rel}):
        errs["ds_flash_fwd"] = max(errs["ds_flash_fwd"],
                                   fl["errs"]["ds_flash_fwd"])
        for kern in ("ds_flash_bwd_dkv", "ds_flash_bwd_dq"):
            bwd_errs[kern] = max(bwd_errs[kern], fl["errs"][kern])
            bwd_rel[kern] = max(bwd_rel[kern], fl["rel"][kern])

    def train10_paths(name):
        """The kernel's launches on slice 10's bf16 training paths and
        slice 11's bf16 round trips."""
        return {path: n for path, n in (
            *((r["path"], r["launches"].get(name, 0))
              for r in train10.values()),
            *((path, n.get(name, 0)) for path, n in rt_paths.items())) if n}
    mtrain = "mixtral_train_bf16"
    llama_load_q = llama_loads["int8"]["launches"]["block_quantize_int8"]
    s7_load_q = {k: v["int8"]["launches"]["block_quantize_int8"]
                 for k, v in s7_loads.items()}
    llama_fused = {f"llama_http_{arm}": n["ds_fused_layer"]
                   for arm, n in lq.items() if arm.endswith("_fused")}
    rows = (
        ("decode_attention", dec_t, "decode_attention.cu",
         "decode_attention.py:40",
         *paths_of("decode_attention",
                   serve_http=serve_launches["decode_attention"],
                   mixtral_http=mix_n["decode_attention"]),
         errs["decode_attention"], tols["decode_attention"]),
        ("ds_flash_fwd", fwd_t, "ds_flash_fwd.cu", "ds_flash_attention.py:35",
         *paths_of("ds_flash_fwd",
                  serve_http=serve_launches["ds_flash_fwd"],
                  train_bf16=train_launches["ds_flash_fwd"],
                  mixtral_http=mix_n["ds_flash_fwd"],
                  **{mtrain: mt_n["ds_flash_fwd"]},
                  **train10_paths("ds_flash_fwd")),
         errs["ds_flash_fwd"], tols["ds_flash_fwd"]),
        ("ds_flash_bwd_dkv", train_t["ds_flash_bwd_dkv"], "ds_flash_bwd.cu",
         "ds_flash_attention.py:86", *paths_of(
             "ds_flash_bwd_dkv",
             train_bf16=train_launches["ds_flash_bwd_dkv"],
             **{mtrain: mt_n["ds_flash_bwd_dkv"]},
             **train10_paths("ds_flash_bwd_dkv")),
         bwd_errs["ds_flash_bwd_dkv"], BWD_TOL),
        ("ds_flash_bwd_dq", train_t["ds_flash_bwd_dq"], "ds_flash_bwd.cu",
         "ds_flash_attention.py:160", *paths_of(
             "ds_flash_bwd_dq", train_bf16=train_launches["ds_flash_bwd_dq"],
             **{mtrain: mt_n["ds_flash_bwd_dq"]},
             **train10_paths("ds_flash_bwd_dq")),
         bwd_errs["ds_flash_bwd_dq"], BWD_TOL),
        *((f"{name}_f16", f16_t["no_segments"][f"{name}_f16"],
           f"{name}.cu".replace("_dkv", "").replace("_dq", ""),
           f"ds_flash_attention.py:{line} (fp16 form)",
           f16_run["launches"][f"{name}_f16"],
           {f16_run["path"]: f16_run["launches"][f"{name}_f16"]},
           f16_errs[f"{name}_f16"], TOL16 if name.endswith("fwd")
           else BWD_TOL16)
          for name, line in (("ds_flash_fwd", 35), ("ds_flash_bwd_dkv", 86),
                             ("ds_flash_bwd_dq", 160))),
        ("block_quantize_int8", int8_t["block_quantize_int8"],
         "quantization.cu", "quantization.py:57",
         int8_load["launches"]["block_quantize_int8"]
         + mixq_load["launches"]["block_quantize_int8"] + llama_load_q
         + sum(s7_load_q.values()),
         {"int8_engine_load": int8_load["launches"]["block_quantize_int8"],
          "mixtral_int8_load":
          mixq_load["launches"]["block_quantize_int8"],
          "llama_int8_load": llama_load_q, **s7_load_q},
         int8_errs["block_quantize_int8"], 0),
        ("qgemm", int8_t["qgemm"], "qgemm.cu", "qgemm.py:66",
         *paths_of("qgemm", int8_http_unfused=int8_runs["unfused"]
                  ["launches"]["qgemm"]),
         max(int8_errs["qgemm"], moeq_errs["qgemm"]), INT8_TOL),
        ("decode_attention_int8", int8_t["decode_attention_int8"],
         "decode_attention.cu", "decode_attention.py:40",
         *paths_of("decode_attention_int8", int8_http_unfused=int8_runs[
             "unfused"]["launches"]["decode_attention_int8"]),
         int8_errs["decode_attention_int8"], INT8_TOL),
        ("ds_fused_layer", int8_t["ds_fused_layer"], "fused_decode.cu",
         "fused_decode.py:480",
         int8_runs["fused"]["launches"]["ds_fused_layer"],
         {"int8_http_fused": int8_runs["fused"]["launches"]["ds_fused_layer"]},
         int8_errs["ds_fused_layer"], INT8_TOL),
        ("decode_attention_alibi", s7_t["decode_attention_alibi"],
         "decode_attention.cu", "decode_attention.py:40",
         *paths_of("decode_attention_alibi"),
         s7_errs["decode_attention_alibi"], INT8_TOL),
        ("decode_attention_windowed", s7_t["decode_attention_windowed"],
         "decode_attention.cu", "decode_attention.py:40",
         *paths_of("decode_attention_windowed"),
         s7_errs["decode_attention_windowed"], INT8_TOL),
        ("ds_fused_layer_neox_spec", s7_t["ds_fused_layer_neox_spec"],
         "fused_decode.cu", "fused_decode.py:480",
         *fused_paths(s7, "neox_http_"),
         max(s7_errs["ds_fused_layer_neox_spec"],
             s7_errs["ds_fused_layer_pythia_spec"]), INT8_TOL),
        ("ds_fused_layer_bloom_spec", s7_t["ds_fused_layer_bloom_spec"],
         "fused_decode.cu", "fused_decode.py:480",
         *fused_paths(s7, "bloom_http_"),
         s7_errs["ds_fused_layer_bloom_spec"], INT8_TOL),
        ("ds_fused_layer_llama_spec", fam_t["llama_7b"], "fused_decode.cu",
         "fused_decode.py:480", sum(llama_fused.values()), llama_fused,
         fam_errs["llama_7b"], INT8_TOL),
        ("ds_fused_layer_mixtral_spec", fam_t["mixtral_8x7b"],
         "fused_decode.cu", "fused_decode.py:480", mq8f["ds_fused_layer"],
         {"mixtral_int8_http_8_fused": mq8f["ds_fused_layer"]},
         fam_errs["mixtral_8x7b"], INT8_TOL),
        ("ds_ggemm", moe_t["ds_ggemm"]["gate_in"], "grouped_gemm_hopper.cu",
         "grouped_gemm.py:163",
         *paths_of("ds_ggemm", mixtral_http=mix_n["ds_ggemm"],
                   **{mtrain: mt_n["ds_ggemm"]},
                   **train10_paths("ds_ggemm")),
         max(moe_errs["ds_ggemm"], mt_errs["ds_ggemm"]), INT8_TOL),
        ("ds_ggemm_t", mt_t["ds_ggemm_t"]["gate_in"],
         "grouped_gemm_hopper.cu", "grouped_gemm.py:163", *paths_of(
             "ds_ggemm_t", **{mtrain: mt_n["ds_ggemm_t"]},
             **train10_paths("ds_ggemm_t")),
         mt_errs["ds_ggemm_t"], INT8_TOL),
        ("ds_tgmm", mt_t["ds_tgmm"]["gate_in"], "grouped_gemm_hopper.cu",
         "grouped_gemm.py:222", *paths_of(
             "ds_tgmm", **{mtrain: mt_n["ds_tgmm"]},
             **train10_paths("ds_tgmm")),
         mt_errs["ds_tgmm"], INT8_TOL),
        ("ds_ggemm_slots", moe_t["ds_ggemm_slots"]["gate_in"],
         "grouped_gemm_stream.cu", "grouped_gemm.py:433",
         *paths_of("ds_ggemm_slots", mixtral_http=mix_n["ds_ggemm_slots"]),
         moe_errs["ds_ggemm_slots"], INT8_TOL),
        ("ds_ggemm_q", moeq_t["ds_ggemm_q"]["gate_in"],
         "grouped_gemm_stream.cu", "grouped_gemm.py:200", *paths_of("ds_ggemm_q"),
         moeq_errs["ds_ggemm_q"], INT8_TOL),
        ("ds_ggemm_slots_q", moeq_t["ds_ggemm_slots_q"]["gate_in"],
         "grouped_gemm_stream.cu", "grouped_gemm.py:452",
         *paths_of("ds_ggemm_slots_q"), moeq_errs["ds_ggemm_slots_q"],
         INT8_TOL),
        *((name, sparse["times"]["fixed"][name], "block_sparse_attention.cu",
           f"block_sparse_attention.py:{line}",
           sum(r["launches"][name] for r in sparse["runs"].values()),
           {f"sparse_{label}_s{SP_S}": r["launches"][name]
            for label, r in sparse["runs"].items()},
           sparse["errs"][name], TOL if name.endswith("fwd") else BWD_TOL)
          for name, line in zip(SPARSE_KERNELS, (75, 178, 209))))
    kernels = []
    for name, t, src, replaces, n, by_path, err, tol in rows:
        check(n > 0, f"{name} was not launched on a main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/csrc/{src}",
            "replaces": pallas + replaces, "tpu_kernel": pallas + replaces,
            "launches": n, "launches_by_path": by_path,
            "max_abs_err": err, "tol": tol, "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        if name in bwd_rel:
            kernels[-1]["max_rel_err_bf16"] = bwd_rel[name]
        if name.endswith("_f16"):
            # phase 32: GPT-2 760M's training shape in fp16, without and
            # with segment ids; the range sweep of the loss scale
            kernels[-1].update(
                dtype="float16", times_with_segments=f16_t["segments"][name],
                max_rel_err_f16=f16_rel.get(name),
                err_kind="o abs / gradients rel_to_max")
        if name.startswith("decode_attention"):
            # device time over the model's layers' own caches; one launch
            # a call (held), Mixtral's GQA shape beside the model's
            kernels[-1].update(
                kernels_per_call=t["kernels_per_call"], chunk=t["chunk"],
                host_ms_per_call=t["host_ms_per_call"],
                times_by_shape=t.get("times_by_shape"))
        if "device_ms" in t:
            # the profiler's device time of the kernel and of the library
            # call (CUDA events around SDPA's backward also time the host)
            kernels[-1].update(device_ms=t["device_ms"],
                               library_device_ms=t.get("library_device_ms"))
        if name in int8_t or name in moe_t or name in moeq_t \
                or name.endswith("_spec") or name in s7_t:
            # fp32 checks abs, bf16 checks relative to each output's max
            kernels[-1].update(err_kind="fp32 abs / bf16 rel_to_max",
                               work=t["work"])
        if name in moe_t:
            kernels[-1]["times_by_proj"] = moe_t[name]
        if name in ("ds_ggemm_slots", "ds_ggemm_q", "ds_ggemm_slots_q"):
            # bf16 (int8 experts: bf16 rows) on the streaming kernels; fp32
            # and bf16 shapes outside their rule in grouped_gemm.cu
            kernels[-1]["source_fp32_and_unaligned_bf16"] = \
                "deepspeed_tpu_torch/csrc/grouped_gemm.cu"
            kernels[-1]["entry_point"] = {
                "ds_ggemm_slots": "ds_ggemm_slots_s",
                "ds_ggemm_q": "ds_ggemm_q_s",
                "ds_ggemm_slots_q": "ds_ggemm_slots_q_s"}[name]
            kernels[-1]["identity"] = {
                "ds_ggemm_slots": moe_t["slot_identity"],
                "ds_ggemm_q": moeq_t["ggemm_q_identity"],
                "ds_ggemm_slots_q": moeq_t["slot_q_identity"]}[name]
            kernels[-1]["path_expert_gemms"] = {
                "ds_ggemm_slots": mix_path,
                "ds_ggemm_q": mixq[f"max_num_seqs_{WIDE_SEQS}"]
                ["path_expert_gemms"],
                "ds_ggemm_slots_q": mixq["max_num_seqs_8"]
                ["path_expert_gemms"]}[name]
        if name in mt_t:
            # phase 24: at mixtral:1b-moe's training shapes (R 16,384)
            kernels[-1].update(err_kind="fp32 abs / bf16 rel_to_max",
                               work=t["work"])
            kernels[-1]["times_at_moe_train_shape"] = mt_t[name]
        if name in HOPPER_GROUPED:
            # bf16 on the Hopper kernels; fp32 and bf16 shapes outside
            # their rule on layout_tile
            kernels[-1]["source_fp32_and_unaligned_bf16"] = \
                "deepspeed_tpu_torch/csrc/grouped_gemm.cu"
            kernels[-1]["identity"] = {
                k: v for k, v in mt_ident.items()
                if k.startswith(name + "_") and k[len(name) + 1:] in
                ("identity", "repeat_identical")}
        if name in mt_flash["times"]:
            kernels[-1]["times_at_moe_train_shape"] = \
                mt_flash["times"][name]
        if name in bert_t["segments"]:
            # phase 28: BERT-Large's shape, without and with segment ids
            kernels[-1]["times_at_bert_shape"] = {
                label: t10[name] for label, t10 in bert_t.items()}
        if name in moeq_t:
            # context only: torch._grouped_mm on the dequantized bf16 stack
            kernels[-1]["times_by_proj"] = moeq_t[name]
            kernels[-1]["grouped_mm_bf16_ms"] = t["grouped_mm_bf16_ms"]
            # phase 15, int8 cache: identity with the static generate and
            # across batch orders held for the requests not preempted at 8
            # rows (the slot arm) and at 96 (the group arm)
            slot = name == "ds_ggemm_slots_q"
            run = mixq_par[f"max_num_seqs_{8 if slot else WIDE_SEQS}_int8_kv"]
            held = f"held for the {run['not_preempted']} requests not " \
                "preempted"
            kernels[-1].update(int8_kv_static_generate_identity=held,
                               int8_kv_reordered_identity=held)
        if name == "qgemm":
            # context only: torch.matmul on the dequantized bf16 weights
            kernels[-1]["matmul_bf16_ms"] = t["matmul_bf16_ms"]
            kernels[-1]["times_at_mixtral_shapes"] = qgemm_mix_t
            kernels[-1]["identity"] = t["identity"]
        if name == "qgemm" or name.startswith("ds_fused_layer"):
            # bf16 rows (bf16 compute) on the decode weight stream
            kernels[-1]["sources"] = [
                kernels[-1]["source"],
                "deepspeed_tpu_torch/csrc/decode_stream.cuh"] + (
                ["deepspeed_tpu_torch/csrc/fused_decode.cuh"]
                if name.startswith("ds_fused_layer") else [])
        if name == "ds_fused_layer":
            kernels[-1]["identity"] = t["identity"]
        if name == "decode_attention_int8":
            kernels[-1]["replaces"] += " (quantized=True)"
            kernels[-1]["tpu_kernel"] = kernels[-1]["replaces"]
        if name in VARIANT_NOTES:
            kernels[-1]["replaces"] += VARIANT_NOTES[name]
            kernels[-1]["tpu_kernel"] = kernels[-1]["replaces"]
        if name in s7_t:
            for extra in ("times_by_cache", "times_by_config"):
                if extra in s7_t[name]:
                    kernels[-1][extra] = s7_t[name][extra]
        if name in SPARSE_KERNELS:
            # phase 27: the Fixed layout's times; BigBird's beside them
            kernels[-1].update(
                work=t["work"], times_by_layout={
                    label: sparse["times"][label][name]
                    for label in sparse["times"]},
                err_kind="fp32 abs / bf16 o abs, gradients rel_to_max")
            if name in sparse["rel"] and not name.endswith("fwd"):
                kernels[-1]["max_rel_err_bf16"] = sparse["rel"][name]
                kernels[-1]["identity"] = sparse["identity"]
            if name.endswith("fwd"):
                kernels[-1]["identity"] = sparse["fwd_identity"]
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
