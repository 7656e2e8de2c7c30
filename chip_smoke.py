#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi) and torch's CUDA version;
  2. build every CUDA kernel from src/repro_torch/csrc (one nvcc per source,
     all at once) and print the build time and, for each compiled kernel,
     ptxas' registers, shared memory and spills;
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes: the wire codec bit for bit (int8 and fp8, bf16 and
     f32 inputs, d = 2560 and 96 and 200; each decode on the route
     wire_codec.decode_route names, "warp256" at b = 256 and "strided"
     for the rest and for a payload based 1 byte off), flash attention within 2e-4 (f32)
     and 5e-2 (bf16), causal, GQA and sliding-window, head dims 128 and 256
     (recurrentgemma's 10 q heads on one kv head, window 2048, at S = 512
     and at S = 3072 where the window bites), query rows without any key
     (Sq 256 against Skv 128 under window 16: the mean of V) on both
     routes; the RG-LRU scan within
     2e-4 (f32) / 1e-2 (bf16) of its plain version relative to the largest
     value ([4, 512, 2560] with and without h0, ragged [3, 300, 200], S =
     1, 63, 64, 65 and 0, [1, 4096, 2560] (64 chunks chained by
     look-back), log a in (-20, 0), two calls in a row on different
     inputs; two calls on the same inputs bit for bit);
     the WKV6 forward and backward kernels against the plain version's
     forward and autograd (the training shape in bf16 and f32, S = 96,
     strong decay, a given initial state, ragged S = 130; bf16 at head dim
     64 on the chunked tensor-core route, the rest, with bf16 at head dim
     32 and bf16 whose r is based 2 bytes off 16, on SIMT) and, at
     constant log w = -5 and -20 where the plain version overflows,
     against wkv6_scan and its autograd; the grouped expert matmul
     (moe_gmm) within 2e-4 (f32) / 1e-2
     (bf16) of its plain version relative to the largest value, at
     granite-moe-3b-a800m's prefill shapes ([40, 512, 1536] @ [40, 1536,
     512] and [40, 512, 512] @ [40, 512, 1536]), its decode shape
     (capacity 8), a ragged [5, 37, 200] @ [5, 200, 72], C past one tile
     (130) and the small-C variant's C = 1, 8, 12, 16, and qwen3-moe's
     128 experts ([128, 160, 2048] @ [128, 2048, 768], its w2, capacity
     8), each on the route moe_gmm.route names (bf16: "wgmma" or
     "wgmma_small_c"; f32: "simt"); flash at granite's heads (24 q on 8
     kv heads of 64) and qwen3-moe's (32 q on 4 kv heads of 128), every
     bf16 case on the tensor-core route "mma"; WKV6 at rwkv6-3b serving's
     calls from a state, a decode step [4, 1, 40, 64] and S = 10 (bf16 on
     "chunked", f32 on SIMT); the flash backward kernel against
     attention_bwd_plain within 2e-4 (f32) / 5e-2 (bf16) absolute and
     element by element within 2e-5 + 1e-4 |p| (f32) / 1e-3 + 2^-7 |p|
     (bf16) (qwen1.5-4b's training call [2, 20, 512, 128] bf16 causal, granite's
     24 q on 8 kv heads of 64, a window, f32, a dO in the model layout and
     one with no unit stride along dh, rows without keys, a q based 2
     bytes off 16), each on its backward route (bf16 on the tensor-core
     route "mma", f32 and the misaligned q on "simt"), the forward's
     log-sum-exp beside the plain one, and two backward calls on the same
     inputs bit for bit; the three backward kernels of the hybrid and MoE
     training paths against their plain versions (check_rglru_bwd,
     check_moe_gmm_bwd, check_flash_bwd256: the RG-LRU backward at
     [2, 4096, 2560] f32, S = 1, 65 and 0, R = 200 and 130, with and
     without h0, with dh_last, log a in (-20, 0) and bf16, within 2e-4 /
     1e-2 of the largest value, the path's call twice bit for bit; the
     grouped matmul's backward at granite's training shapes (capacity
     256) in bf16 and f32, C = 8, 37 and 130, ragged D and F and
     misaligned views, within 2e-4 / 1e-2, bf16 that TMA can address on
     "wgmma" and the rest on "simt"; the flash backward at dh 256,
     [2, 10, 4096, 256] bf16 on one kv head with window 2048, ragged S
     and rows without keys in bf16 on "mma", and [1, 10, 300, 256] f32
     with window 100 on "simt", within FLASH_TOL and the element gate,
     twice bit for bit); flash at whisper-small's calls (check_flash_whisper:
     [8, 12, 1500, 64] and [8, 12, 224, 64] on [8, 12, 1500, 64]
     non-causal, [8, 12, 224, 64] causal, model-layout views, bf16 on
     "mma" and f32 on "simt", within FLASH_TOL, the element gate and an
     lse within 1e-4; the backward at [8, 12, 448, 64] on
     [8, 12, 1500, 64] and [32, 12, 1500, 64] non-causal bf16, and
     [1, 4, 100, 64] on [1, 4, 300, 64] f32); flash under paligemma-3b's
     prefix-LM mask both ways (check_flash_prefix: the training call
     [2, 8, 768, 256] and the patch prefill [4, 8, 384, 256] on one kv
     head with prefix 256, a prefix of 200 splitting a key tile, prefixes
     at and past Sq that give the non-causal call's bits, bf16 on "mma",
     f32 on "simt" at dh 16 and 256; the forward within FLASH_TOL, on P|V|
     within FLASH_FWD_ELEM and its lse within 1e-4, the backward within
     FLASH_TOL and FLASH_BWD_ELEM, twice bit for bit).  Small f32 models
     on the card are held to the same
     models on the CPU: a qwen prefill, the paligemma SMOKE forward
     loss, every gradient and the patch prefill (8 patches + 40 tokens),
     a recurrentgemma prefill of a
     12-token prompt (window 8: the ring wraps) and 8 decode steps, a
     granite-moe prefill and 8 decode steps (the router's top-k expert ids
     compared first), qwen3-moe split at cut 1 ('none' tokens equal the
     static tokens, measured bytes equal billed bytes), and one pipelined
     training step each of an RWKV, a qwen, a granite-moe and a
     paligemma model (int8 hop; loss
     and updated parameters; the qwen step through the flash backward
     kernel, granite's through the grouped matmul's backward too) and
     one accumulated (k 2) step of a recurrentgemma model (the RG-LRU
     backward), each with its exact launches, and
     one interleaved (S 2, v 2, k 2) int8+topk0.25 step with gradient
     compression of the qwen model widened to 4 layers (loss, parameters,
     the EF buffer's live slots; top-k and int8 rounding flips on near-ties
     counted and printed); the streaming runtime (run_streaming) of
     the qwen model widened to 4 layers, cut 2, 3 UEs, 3 rounds, 'none'
     and int8+topk0.25, the CPU replaying the card's codec decisions
     (losses within 1e-5, parameters within 1e-5 but for one element in
     10^4 and the key bias, held to AdamW's reach); the
     continuous-batching engine, its decode step captured as a CUDA
     graph, on the SMOKE qwen, recurrentgemma and granite-moe (16 slots,
     where the naive MoE capacity would drop tokens): greedy tokens equal
     the CPU engine's and the card's solo decodes, tokens sampled at T 0.7
     equal at 1 and 3 slots and to solo, a replayed step leaves the
     inactive slots' bytes as they were, prompt + gen == cache_len runs;
     the same for the rwkv6 SMOKE engine (the WKV6 state in each lane);
  4. the main paths at full width, random weights from seed 0, bf16 compute:
     a. serving qwen1.5-4b (40 layers, batch 4, prompt 512, 32 greedy
        tokens) through the serving CLI's entry point: the static path, then
        split inference at cut 20 over a loopback socket for none, int8 and
        fp8.  Measured payload bytes must equal billed bytes, there must be
        gen + 1 uplink frames, 'none' split tokens must equal the static
        tokens bit for bit, and every serving kernel must have launched,
        every decode on route "warp256" (the codec's calls are counted by
        shape: prefill hop and decode steps);
     b. serving recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local attention
        with window 2048; tied embeddings; batch 4, prompt 512, 32 greedy
        tokens) through the same entry point: tokens in range, exactly 18
        rglru_scan and 8 flash_attention launches (the prefill's layers),
        every flash launch on the "mma" route, and --split-cut refused with
        ValueError; prefill ms, decode tok/s and peak GB printed;
     c. C2P2SL training of rwkv6-3b (32 layers, f32 master weights, batch 8,
        seq 512) through the training CLI's entry point: 3 steps of the
        2-stage, 4-micro-batch pipeline cut at 16, for wire none and int8.
        Every loss finite, every parameter tensor changed, the hop's bytes
        per step equal to the billed bytes up and down, and the WKV6 and
        (int8) codec kernels launched, every WKV6 launch on the chunked
        route;
     d. one make_c2p2sl_step with 2 UEs and a ragged shard_batch (b = [5,
        3], k = 4), its loss printed beside the pipelined loss on the same
        weights and batch;
     f. C2P2SL training of qwen1.5-4b (40 layers, f32 master weights,
        batch 8, seq 512) through the training CLI's entry point, after
        rwkv6-3b's state is freed: 3 steps of the 2-stage, 4-micro-batch
        pipeline cut at 20, the hop int8 both ways.  Every loss finite,
        every parameter tensor changed, hop bytes up and down equal to the
        billed bytes, exactly 960 flash forward launches (2 a block and
        micro-batch under the activation checkpoint), every one on "mma",
        and 480 flash backward launches, every one on "mma"; the losses
        beside those of the SIMT backward, the first equal to 5 digits;
        24 encodes and 24 decodes of the [1024, 2560] hop, every decode on
        "warp256"; peak GB beside the card's name and power limit;
     i. interleaved C2P2SL training of qwen1.5-4b (after f): the same
        command with --virtual-stages 2 and --wire-dtype int8+topk0.25
        (4 chunks of 10 layers, 3 hops a micro-batch: int8 forward, top-k
        with error feedback on the gradient).  Every loss finite, every
        parameter changed, hop bytes a step 31,948,800 up and 23,642,112
        down, equal to the bills; 12 hops each way a step; exactly 960 /
        480 flash launches and 36 encodes and 36 decodes of the [1024,
        2560] hop (the top-k backward launches no codec kernel); the EF
        buffer [2, 9, 2, 512, 2560] f32 finite after every step and
        nonzero in exactly its 12 live slots; the first loss within 5e-2
        of f's; peak GB; one more step traced.  Then qwen1.5-4b's widths with the depth cut to
        20 layers (the f32 error-feedback tree of 40 would not fit),
        the same spec with make_lm_train_step(compress=True), 3 steps:
        error_fb finite and nonzero, one more encode and decode a
        parameter leaf a step on f32 [n / 256, 256];
     g. continuous batching of qwen1.5-4b (after e): 12 requests of prompt
        512 with budgets 8 / 32 / 128, 8 slots, longest first, 2048-token
        prefill chunks, cache_len 640, through the serving CLI (the decode
        step one CUDA graph), then the engine on the same weights captured
        and with graph=False: the same tokens in all three, exactly 40
        flash launches a prefill chunk and none in decode, and three
        requests (one per budget) decoded solo with teacher forcing on the
        engine's tokens within CB_TOL of the largest |logit|, every token
        the argmax of the engine's logits; wall, tok/s, decode steps,
        prefill chunks, engine units against the convoy's, occupancy,
        TTFT p50 / p99, the capture's ms, and one decode step (8 lanes)
        untraced and under torch.profiler, for each;
     h. the paper's wireless C2P2SL (after d; no kernel of ours: cuDNN
        convolutions, GroupNorm and one small matmul, f32 with TF32 off):
        scipy's version, then Algorithm 1 on the Table I fleet of 8 UEs
        (seed 0) at batch 512: the plan (l, k, v, b, tau), its
        bubble-rate history and the simulated C2P2SL / PSL / EPSL / SL
        batch seconds of the Table I system model; the plan must be
        feasible (b >= 0 summing to 512, tau >= 0 and > 0 where b > 0,
        summing to at most the frame, l storage-feasible) and its
        simulated C2P2SL time no higher than after AO's first iteration
        and below PSL's.  ResNet-18 (f32, from a torch.Generator seed) is
        trained 3 steps at batch 512 by each of C2P2SL (the plan's cut
        and integer split, k = min(plan k, smallest b_i)), PSL, EPSL and
        SL from the same weights, SGD 0.05 / momentum 0.9: every loss
        finite, every parameter moved, no kernel of ours launched; after
        step 1 C2P2SL's parameters equal PSL's within 2e-4, and after step
        3 EPSL's UE side differs by more; C2P2SL's step 1 at batch 32 equals the
        CPU's within 1e-3; each scheme's step ms and peak GB beside the
        card's name and power limit;
     j. the streaming C2P2SL runtime (after i), through run_streaming:
        qwen1.5-4b in bf16 (no f32 master), cut 20, 2 UE clients of 2 x
        512, 3 rounds, AdamW 1e-3; (a) int8 on the unshaped loopback,
        (b) int8+topk0.25 with the link shaped to 1e8 B/s both ways and a
        LinkEstimator fed by the measured hops.  Every round's loss
        finite and seen by each client, every parameter moved, every
        hop's payload bytes equal to the bill (2,662,400 up; 2,662,400 /
        1,970,176 down), exactly 600 / 240 flash launches on "mma" and
        12 + 12 / 6 + 6 codec calls at [1024, 2560] bf16 a run, the QoS
        snapshot's rounds, frames and stragglers, (b)'s top-k residuals
        finite and nonzero after every round and its estimator fed both
        directions by measured hops alone; round ms, peak GB and each
        client's hop seconds.  Then the runtime's CLI at the reference's
        example on the card, and split serving at cut 20 int8 through a
        QoSMonitor and a LinkShaper (gen + 1 frames, the unshaped
        tokens);
     m. "qwen1.5-4b checkpoint, resume and replan" (after j, the earlier
        phases' state freed), through the training CLI, in ckpts/chip_smoke
        of the checkout (deleted at the end): (a) at qwen1.5-4b's widths
        with its depth cut to CK_LAYERS = 8 of 40 (``depth_cut``), the int8
        k 4 run of 3 steps checkpoints at step 2 (exactly one checkpoint on
        disk, its bytes against the 16.9 GB of f32 weights and AdamW's m
        and v, by the count), then the same flags resume there and train
        step 3:
        its loss equal to the uninterrupted run's bit for bit, and every
        leaf's checksum of the final f32 master weights; the disk, save
        and restore seconds and the peak host RSS printed; (b) 8 steps at
        --pipeline-k auto --virtual-stages 1 --wire-dtype int8 with
        RP_HINTS and the bandwidth drop RP_TRACE under --replan
        every:2,hysteresis:0.05: the planned cell RP_PLAN, the one switch
        RP_SWITCH (to the top-k hop at step 3, the EF buffer created and
        then live in exactly its slots), "2 cell compile(s)", finite
        losses, every step's hop bytes its own cell's bill; (c) both
        runs' exact launches, every flash on "mma", the codec calls by
        shape;
     n. serving qwen3-moe-30b-a3b at full width (after g; 48 MoE layers,
        128 experts of d_ff 768, top 8, 32 q heads on 4 kv heads of 128,
        untied; 61.1 GB of bf16 weights), each init after the card's
        memory is read (at most 1 GB still allocated), through the serving
        CLI's entry point: static (exactly 144 moe_gmm and 48 flash
        launches in the prefill and 144 x 33 moe_gmm in the run, the
        prefill's on "wgmma" at capacity 160, the decode steps' on
        "wgmma_small_c" at capacity 8), split at cut 24 in int8 (33 frames
        of 4,259,840 + 32 x 8,320 B, equal to the bills), then g's request
        mix (the init's peak at most the parameters' bytes + 2.5 GB;
        launches by prefill chunk and decode step; the engine's tokens
        (budgets 8 and 32) against a teacher-forced decode from its own
        prefill bucket, the
        (token, layer) expert choices that flip counted and, where any
        do, the engine's choices replayed; the request's solo decode
        printed beside it with the prefill assignments its own capacity
        keeps or drops otherwise, ROADMAP Queue 3 fault 18);
     o. serving rwkv6-3b at full width (after n) through the same entry
        point: static (exactly 32 + 32 x 32 wkv6 launches, every one on
        "chunked", the decode steps' S = 1 calls from the cached state
        too), a 64-token prompt with and without --token-loop-prefill (32
        x (64 + 8) launches against 32 x 9; the tokens compared), split
        at cut 16 in int8 (5,324,800 + 32 x 10,400 B), then g's request
        mix (32 wkv6 launches a prefill chunk and a decode step, the
        captured step included), and the same engine in f32 against solo
        decodes within RS_F32_TOL (bf16 amplifies roundings, fault 20);
     e. serving granite-moe-3b-a800m (32 MoE layers, 40 experts top-8, 24
        heads on 8 kv heads of 64, tied embeddings; batch 4, prompt 512, 32
        greedy tokens) through the serving CLI's entry point: tokens in
        range, exactly 96 moe_gmm and 32 flash_attention launches in the
        prefill and 96 x 33 = 3168 moe_gmm in the run, every prefill
        moe_gmm on the "wgmma" route and every decode one on
        "wgmma_small_c", every flash on "mma", and --split-cut refused
        with ValueError; prefill ms, decode tok/s and peak GB;
     k. C2P2SL training of granite-moe-3b-a800m (after j) through the
        training CLI at f's spec (S 2, k 4, int8, batch 8 x 512, 3 steps;
        capacity 256 a micro-batch): every loss and aux finite, every
        parameter changed (the router through the aux), hop bytes equal
        to the bills at d = 1536, exactly GT_LAUNCHES (2304 moe_gmm and
        1152 moe_gmm_bwd, all on "wgmma", 768 / 384 flash on "mma", 24 +
        24 codec calls at [1024, 1536]), peak GB, one more step traced;
     l. training of recurrentgemma-2b (after k) through the training CLI
        with --microbatches 2 at batch 4 x 4096 (past the window of 2048),
        3 steps: every loss finite, every parameter changed, exactly
        RT_LAUNCHES (216 rglru_scan, 108 rglru_scan_bwd, 96 flash and 48
        flash backwards at dh 256, all on "mma"), peak GB, one more step
        traced;
     p. whisper-small, the encoder-decoder, at full width (after l; 12
        "enc" and 12 "xattn" layers of d 768, 12 heads of 64, 1500 stub
        frames, vocab 51865 padded to 51872; 278.2 M parameters): static
        serving through the serving CLI, 8 segments of 1500 frames,
        prompt 224, 224 tokens (cache 448): greedy, sampled at T 0.8 and
        with --token-loop-prefill (exactly 36 flash launches, 12 a call
        shape: the encoder [8, 12, 1500, 64] and the cross-attention
        [8, 12, 224 -> 1500, 64] non-causal, the self-attention causal;
        the token loop the encoder's 12; none in decode; all on "mma"),
        --continuous and --split-cut refused with ValueError; the token
        loop against the one-pass prefill in f32 (every kernel on its f32
        route) within 3e-3 + 3e-3 |logit|, the last logits and 4 greedy
        steps, and the bf16 gap printed beside it; then C2P2SL training
        through the training CLI (f32 master weights, AdamW, 32 x 448 with
        32 x 1500 frames, S 2 cut at 6, k 4, int8, 3 steps): finite
        losses, every parameter moved but the cross path's four unread
        biases (still zero), hop bytes the bills of h alone, exactly 648 /
        324 flash launches on "mma" (by shape: the encoder once a step
        over the batch) and 24 + 24 codec calls at [3584, 768]; one more
        step traced, and one prefill and four decode steps traced;
     q. paligemma-3b, the prefix-LM, at full width (after p; 18 "attn"
        layers of d 2048, 8 q heads on 1 kv head of 256, d_ff 16384
        gated GELU, vocab 257216 tied, 256 stub patches; 2.51 B
        parameters): static serving through the serving CLI at batch 4,
        prompt 128, 32 tokens, which takes the token loop without patches
        as the reference's does (no kernel launched), --continuous and
        --split-cut refused with ValueError; the patch prefill through
        LM.prefill_with_cache (4 x (256 patches + 128 tokens), cache 416)
        and 32 greedy steps: exactly 18 flash launches, all on "mma" at
        [4, 8, 384, 256] with the prefix 256, none in decode; then C2P2SL
        training through the training CLI (f32 master weights, AdamW, 8 x
        512 tokens with 256 patches each, S 2 cut at 9, k 4, int8, 3
        steps): finite losses, every parameter moved, hop bytes
        12,779,520 each way a step (the bills at 768 rows a sequence),
        exactly 432 / 216 flash launches on "mma" with the prefix and 24 +
        24 codec calls at [1536, 2048]; one more step traced, and the
        patch prefill and four decode steps traced;
  5. timings: torch.profiler traces of one prefill and four decode steps
     of qwen, one prefill and one decode step each of recurrentgemma and
     granite-moe, and one training step of each of rwkv6-3b and qwen1.5-4b
     (device busy time and idle share, top kernels, the WKV6 kernels'
     total, the flash forward's, and the backward's dq and dK/dV kernels'
     apart); per kernel its device time, its
     plain version's, its bound and the library yardstick where one
     PyTorch call computes the same function (torch.bmm for moe_gmm and,
     twice, for its backward, SDPA for flash and, with the window as a
     boolean mask, for the dh-256 backward, torch.mul for the int8
     decode); the three backward kernels of k and l at their calls
     (time_backwards; the grouped matmul's and the dh-256 flash
     backward's tensor-core routes beside their SIMT routes on the same
     values as ``simt_ms``, with ptxas' registers and spills); the codec
     at each shape
     the main paths coded (qwen's prefill hop and decode steps, the
     training hop), each row with the launches at its shape; for moe_gmm
     and flash also the achieved TFLOP/s and the share of the bound; the
     kernels at n's and o's shapes (flash at 32 q on 4 kv heads, moe_gmm
     at E 128 in prefill and decode, WKV6 at rwkv6's prefill and decode
     calls); the codec at compress_grads' largest call (f32 [1519360, 256], the
     embedding's and the head's); for
     WKV6 and the RG-LRU scan the route, ptxas' registers and spills, and
     for WKV6 the f32 call's (SIMT) time in the same run; the flash
     forward with lse and the flash backward at qwen's training call from
     cold data, with SDPA's forward under grad mode (which keeps its lse)
     and its backward (torch.autograd.grad) as their library yardsticks,
     the backward's SIMT route at the same shape (q based 2 bytes off 16)
     as ``simt_ms``, and its two tensor-core kernels' ptxas registers and
     spills; flash at whisper-small's calls (time_whisper: the forward at
     its encoder, cross- and self-attention serving calls, the backward
     at its training cross-attention and encoder calls, with SDPA's time
     and the factor of each call slower than it); flash at paligemma's
     prefix calls (time_paligemma, between CUDA events: the forward with
     lse at the training call and without at the patch prefill, the
     backward at the training call, SDPA with the prefix as a boolean mask
     their yardstick).

The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate, bf16
# tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12

ARCH, CUT, BATCH, PROMPT, GEN, SEED = "qwen1.5-4b", 20, 4, 512, 32, 0
# the hybrid serving path: recurrentgemma-2b, the same batch and lengths
RG_ARCH = "recurrentgemma-2b"
RG_LAUNCHES = {"rglru_scan": 18, "flash_attention": 8}   # one per layer
RG_SHAPE = (BATCH, PROMPT, 2560)                # the prefill's scan call
RG_HEADS = (10, 1, 256, 2048)                   # q heads, kv heads, dh, window
# the training path: rwkv6-3b, 2 stages (cut 16), 4 micro-batches
T_ARCH, T_BATCH, T_SEQ, T_K, T_STEPS = "rwkv6-3b", 8, 512, 4, 3
WKV_SHAPE = (T_BATCH // T_K, T_SEQ, 40, 64)     # one micro-batch's call
# the dense training path: qwen1.5-4b, the same batch, k and steps, cut at
# 20, int8 hop; each block's forward runs twice under its checkpoint
Q_LAYERS = 40
Q_TRAIN = (T_BATCH // T_K, 20, T_SEQ, 128)      # one micro-batch's attention
Q_LAUNCHES = {"flash_attention": 2 * Q_LAYERS * T_K * T_STEPS,
              "flash_attention_bwd": Q_LAYERS * T_K * T_STEPS,
              "wire_encode": 2 * T_K * T_STEPS,
              "wire_decode": 2 * T_K * T_STEPS}
# the interleaved top-k path: qwen1.5-4b, the same batch, k and steps, v 2
# (4 chunks of 10 layers), int8 forward hops and a top-k 0.25 gradient hop
# with error feedback: S*v - 1 = 3 hops a micro-batch, 12 a step.  The
# top-k backward launches no codec kernel; a hop's bytes a step are 3 x
# the forward bill up, 3 x the backward bill down (4096 rows of 640
# payload bytes, 640 int16 indices and one f32 scale)
TK_V, TK_WIRE = 2, "int8+topk0.25"
TK_HOPS = (2 * TK_V - 1) * T_K
TK_LAUNCHES = {"flash_attention": 2 * Q_LAYERS * T_K * T_STEPS,
               "flash_attention_bwd": Q_LAYERS * T_K * T_STEPS,
               "wire_encode": TK_HOPS * T_STEPS,
               "wire_decode": TK_HOPS * T_STEPS}
TK_UP, TK_DOWN = 3 * 10_649_600, 3 * 4096 * (640 + 2 * 640 + 4)
# the EF buffer [S, ticks, mb, seq, d] of that spec
TK_EF_SHAPE = (2, 9, T_BATCH // T_K, T_SEQ, 2560)
# the checkpoint, resume and replan phase (qwen1.5-4b FULL, batch 8 x 512):
# (a) the int8 k 4 run of 3 steps saving at step 2, then the same flags
# resuming there; (b) the planner and the online re-planner at S 2, v 1,
# --pipeline-k auto, int8, calibrated by RP_HINTS (a 5e8 B/s link, 3 ms a
# message), fed the bandwidth drop RP_TRACE: k 4 int8 is planned, and at
# step 3 the codec switches to the top-k hop, once
# (tests/test_torch_launch_train.py pins both from the planner alone)
RP_HINTS = {"link_bw_Bps": 5e8, "hop_overhead_s": 3e-3}
RP_TRACE = {"steps": [0, 3], "bw_Bps": [5e8, 1e7]}
RP_SPEC, RP_STEPS = "every:2,hysteresis:0.05", 8
RP_PLAN = (2, 4, 1, "int8")
RP_SWITCH = (3, RP_PLAN, (2, 4, 1, TK_WIRE))
RP_FLASH = {"flash_attention": 2 * Q_LAYERS * T_K,
            "flash_attention_bwd": Q_LAYERS * T_K}     # a step's launches
# a step's codec calls: int8 codes both hops, the top-k hop codes only
# the forward one (its gradient hop launches no codec kernel)
RP_CODEC = {"int8": 2 * T_K, TK_WIRE: T_K}
# part (a) runs qwen1.5-4b's widths with the depth cut to CK_LAYERS of its
# 40 layers (the CLI has no depth flag: ``depth_cut`` swaps the registry's
# FULL config while the run lasts), to keep the script inside its time
# limit: the state a checkpoint holds (f32 master weights, AdamW's m and v,
# the step) is then 16.9 GB, not 47.4.  Part (b) keeps the 40 layers: at 8
# the planner picks k 2 and switches at step 1, not RP_PLAN and RP_SWITCH
CK_LAYERS = 8
CKPT_STATE_GB = 16.9
# the compressed run (--compress-grads): qwen1.5-4b's widths, its depth cut
# to 20 layers, since the f32 error-feedback tree adds 4 B a parameter
# (15.8 GB at 40 layers on a 74.60 GB step); the same spec, batch, steps
TC_LAYERS = 20
# the streaming C2P2SL path: the runtime (runtime/driver.py run_streaming)
# training qwen1.5-4b FULL cut at 20, 2 UE clients of 2 sequences of 512,
# 3 rounds, AdamW 1e-3, the model drawn from seed 0 in bf16 with no f32
# master copy.  Run (a) int8 on the unshaped loopback, run (b) int8+topk0.25
# with the link shaped to S_BW both ways and a LinkEstimator fed by the
# measured hops.  A client-round runs 20 flash forwards below the cut with
# no graph kept, the same 20 again under autograd and once more in their
# backward (one checkpoint a block), and the BS side's 20 + 20, beside 20
# backwards a side.  The hops code [2 x 512, 2560] bf16: an int8 ACT up
# (2 encode / decode calls a client-round with the dense int8 GRAD, 1 with
# the top-k one, which launches no codec kernel)
S_CUT, S_CLIENTS, S_BPC, S_ROUNDS, S_LR, S_BW = 20, 2, 2, 3, 1e-3, 1e8
S_CLIENT_ROUNDS = S_CLIENTS * S_ROUNDS
S_FLASH = {"flash_attention": (S_CUT + 2 * S_CUT + 2 * (Q_LAYERS - S_CUT))
           * S_CLIENT_ROUNDS,
           "flash_attention_bwd": Q_LAYERS * S_CLIENT_ROUNDS}
S_RUNS = {"int8": {**S_FLASH, "wire_encode": 2 * S_CLIENT_ROUNDS,
                   "wire_decode": 2 * S_CLIENT_ROUNDS},
          TK_WIRE: {**S_FLASH, "wire_encode": S_CLIENT_ROUNDS,
                    "wire_decode": S_CLIENT_ROUNDS}}
# the bills a client-hop: n = 2 x 512 x 2560 elements, int8 1 + 4/256 B an
# element either way; top-k 640 of 2560 a row: 640 payload bytes, 640
# int16 indices and one f32 scale
S_ROWS = S_BPC * T_SEQ
S_BILL_INT8 = S_ROWS * 2560 + S_ROWS * 10 * 4
S_BILL_TOPK = S_ROWS * (640 + 2 * 640 + 4)
# the runtime's CLI at the reference docstring's example (its own small
# model, f32)
S_CLI = ["--clients", "4", "--steps", "20", "--wire-dtype", TK_WIRE,
         "--bw-Bps", "2e6"]


# the MoE serving path: granite-moe-3b-a800m, the same batch and lengths;
# capacity _capacity(4 * 512, 8, 40, 1.25) = 512 in prefill, 8 in decode
GR_ARCH, GR_LAYERS = "granite-moe-3b-a800m", 32
GR_PREFILL = {"moe_gmm": 3 * GR_LAYERS, "flash_attention": GR_LAYERS}
GR_RUN = {"moe_gmm": 3 * GR_LAYERS * (GEN + 1), "flash_attention": GR_LAYERS}
GR_GMM = (40, 512, 1536, 512)                   # E, C, D, F of w1 and w3
GR_GMM_DECODE = (40, 8, 1536, 512)
GR_HEADS = (24, 8, 64)                          # q heads, kv heads, dh
# the qwen3-moe-30b-a3b serving path at full width (48 MoE layers, 128
# experts of d_ff 768, top 8, 32 q heads on 4 kv heads of 128, untied; 61.1
# GB of bf16 weights): static at the qwen batch and lengths, split at cut
# 24 (int8), and the continuous phase's request mix.  Capacity
# _capacity(4 * 512, 8, 128, 1.25) = 160 in a 4-prompt prefill, 8 in a
# decode step (static B 4, and the engine's 8 dropless lanes).  Before its
# first init the card must hold at most QM_HELD bytes; the init's peak is
# at most the parameters' bytes plus QM_INIT_SLACK (one layer's draw: 1.21
# GB of bf16 experts and a 0.81 GB f32 transient of torch.randn)
QM_ARCH, QM_LAYERS, QM_CUT = "qwen3-moe-30b-a3b", 48, 24
QM_HEADS = (32, 4, 128)                         # q heads, kv heads, dh
QM_GMM = (128, 160, 2048, 768)                  # E, C, D, F of w1 and w3
QM_GMM_DECODE = (128, 8, 2048, 768)
QM_PREFILL = {"moe_gmm": 3 * QM_LAYERS, "flash_attention": QM_LAYERS}
QM_RUN = {"moe_gmm": 3 * QM_LAYERS * (GEN + 1), "flash_attention": QM_LAYERS}
QM_HELD, QM_INIT_SLACK = 1e9, 2.5e9
# rwkv6-3b serving at full width (32 layers, d 2560, 40 heads of 64): static,
# split at cut 16 (int8) and the continuous mix; one wkv6 launch a layer in a
# prefill and in a decode step, every one on the chunked route; then the
# static path at a 64-token prompt and 8 tokens with and without
# --token-loop-prefill (the prompt through the decode step, S = 1 a launch)
RS_LAYERS, RS_CUT = 32, 16
RS_DECODE = (BATCH, 1, 40, 64)                  # a static decode step's call
RS_LOOP = (64, 8)                               # prompt, gen of the loop run
# random-weight rwkv6-3b in bf16 amplifies single roundings through its 32
# layers (ROADMAP Queue 3, fault 20): its engine is held to solo decodes
# in f32, where the largest gap measured on an H100 is 4.8e-5 of the
# largest |logit| (PERF.md); bf16 takes no teacher-forced reference
RS_F32_TOL = 2e-4
# the MoE training path: granite-moe-3b-a800m FULL through the training CLI
# at the rwkv / qwen spec (S 2 cut at 16, k 4, int8 hop, batch 8 x 512, 3
# steps); a micro-batch of 2 x 512 tokens gives the capacity
# _capacity(1024, 8, 40, 1.25) = 256.  Each block's forward runs twice
# under its activation checkpoint (three grouped products and one flash
# each), its backward once
GT_LAUNCHES = {"moe_gmm": 2 * 3 * GR_LAYERS * T_K * T_STEPS,
               "moe_gmm_bwd": 3 * GR_LAYERS * T_K * T_STEPS,
               "flash_attention": 2 * GR_LAYERS * T_K * T_STEPS,
               "flash_attention_bwd": GR_LAYERS * T_K * T_STEPS,
               "wire_encode": 2 * T_K * T_STEPS,
               "wire_decode": 2 * T_K * T_STEPS}
GT_GMM = (40, 256, 1536, 512)                   # E, C, D, F of w1 and w3
# the hybrid training path: recurrentgemma-2b FULL, 4 x 4096 tokens (past
# the window of 2048), k 2 by gradient accumulation, 3 steps: 18 RG-LRU
# and 8 local-attention blocks, each forward twice under its checkpoint
RT_BATCH, RT_SEQ, RT_K = 4, 4096, 2
RT_LAUNCHES = {"rglru_scan": 2 * 18 * RT_K * T_STEPS,
               "rglru_scan_bwd": 18 * RT_K * T_STEPS,
               "flash_attention": 2 * 8 * RT_K * T_STEPS,
               "flash_attention_bwd": 8 * RT_K * T_STEPS}
RT_SCAN = (RT_BATCH // RT_K, RT_SEQ, 2560)      # one micro-batch's scan
# the continuous-batching path: qwen1.5-4b, 12 requests of prompt 512 with
# budgets 8 / 32 / 128 (seeded shuffle), 8 slots, longest first, chunks of
# up to 2048 prompt tokens; cache_len = prompt + the largest budget
CB_REQUESTS, CB_SLOTS, CB_MIX, CB_CHUNK = 12, 8, "8,32,128", 2048
CB_CACHE = PROMPT + 128
# teacher-forced solo decode against the engine: the largest logit gap over
# the largest |logit|.  Both runs round every activation, and the logits
# themselves (the head's bf16 product), to bf16: steps of 2^-8 to 2^-7 of
# a value.  They take GEMMs of another M (8 lanes: cuBLAS' 64x8 tiles; 1
# lane: its GEMV), which sum in another order and flip single roundings
# through 40 layers.  2e-2 is 2.6 to 5.1 bf16 steps of the largest logit
CB_TOL = 2e-2

# the wireless C2P2SL path: Algorithm 1 on the Table I fleet of 8 UEs (seed
# 0) at the paper's batch of 512, then ResNet-18 (f32) trained 3 steps by
# each scheme from the same weights; C2P2SL's update equals PSL's within
# the reference's equivalence bound (tests/test_equivalence.py), and one
# step at SMOKE batch 32 on the card equals the CPU's within W_CARD_TOL
W_UES, W_STEPS, W_TOL, W_CARD_TOL = 8, 3, 2e-4, 1e-3
W_SCHEMES = ("C2P2SL", "PSL", "EPSL", "SL")

SERVING_KERNELS = ("wire_encode", "wire_decode", "flash_attention")
TRAINING_KERNELS = ("wkv6", "wkv6_bwd", "wire_encode", "wire_decode")
FLASH_TOL = {"float32": 2e-4, "bfloat16": 5e-2}  # forward and backward
# the backward also element by element: |g - p| <= atol + rtol |p|.  bf16
# rounds each gradient to 2^-8 of its size, so rtol 2^-7 leaves a factor 2
# and atol 1e-3 covers the f32 sums' error near zero (~1e-6 in f32 cases)
FLASH_BWD_ELEM = {"float32": (2e-5, 1e-4), "bfloat16": (1e-3, 2 ** -7)}
# the forward element by element at whisper's calls: |o - p| <= atol + rtol
# P|V|, P the plain softmax (f32).  On "mma" P rounds to bf16 (2^-9 of each
# p) before P V and o rounds at 2^-9 of |o| <= P|V|, so the error is under
# 2^-8 P|V| and rtol 2^-7 leaves a factor 2; |o| itself cancels to ~0.04
# over 1500 keys, so a gate on |o| fails a right kernel's causal rows
FLASH_FWD_ELEM = {"float32": (2e-5, 1e-4), "bfloat16": (1e-3, 2 ** -7)}
# qwen1.5-4b's three int8 training losses through the SIMT backward (the
# flash backward's first kernels, before its tensor-core route): the first
# step's loss depends on the forward alone, so it must agree to 5 digits
Q_LOSSES_SIMT = (12.45325, 12.44874, 12.42027)
# the first and last losses of the granite-moe and recurrentgemma training
# runs through the SIMT backwards of moe_gmm and of flash at dh 256 (the
# tensor-core routes sum in another order: printed beside, not required)
GT_LOSSES_SIMT = (11.65197, 11.64274)
RT_LOSSES_SIMT = (14.13339, 13.91081)
# whisper-small, the encoder-decoder (12 "enc" and 12 "xattn" layers of d
# 768, 12 heads of 64 q on 12 kv, 1500 stub frames, vocab 51865 padded to
# 51872; 278.2 M parameters): static serving of WH_BATCH audio segments,
# prompt WH_PROMPT and WH_GEN tokens (the cache 448, whisper's decoder
# context), greedy, sampled at WH_TEMP and by --token-loop-prefill; the f32
# token loop against the one-pass prefill within the reference test's
# WH_LOOP_TOL for the last logits and WH_LOOP_STEPS decode steps; C2P2SL
# training at WH_T_BATCH x WH_T_SEQ with frames, S 2 cut at 6, k 4, int8.
# A prefill launches 12 encoder and 12 + 12 decoder flash calls (none in
# decode: decode attention is plain), a token loop the encoder's 12; a
# training step 2 x 12 encoder forwards (once over the batch, each twice
# under its checkpoint) and 2 x 2 x 12 decoder forwards a micro-batch, one
# backward each
WH_ARCH, WH_LAYERS, WH_FRAMES, WH_HEADS = "whisper-small", 12, 1500, 12
WH_BATCH, WH_PROMPT, WH_GEN, WH_TEMP = 8, 224, 224, 0.8
WH_LOOP_TOL, WH_LOOP_STEPS = 3e-3, 4
WH_PREFILL = {"flash_attention": 3 * WH_LAYERS}
WH_LOOP = {"flash_attention": WH_LAYERS}
WH_T_BATCH, WH_T_SEQ, WH_T_CUT = 32, 448, 6
WH_MB = WH_T_BATCH // T_K                       # a micro-batch's rows
WH_T_LAUNCHES = {"flash_attention": (2 * WH_LAYERS + 4 * WH_LAYERS * T_K)
                 * T_STEPS,
                 "flash_attention_bwd": (WH_LAYERS + 2 * WH_LAYERS * T_K)
                 * T_STEPS,
                 "wire_encode": 2 * T_K * T_STEPS,
                 "wire_decode": 2 * T_K * T_STEPS}
# the flash calls of the path (B, H, Sq, Skv, dh, causal), forward
# (serving's, the encoder at the serving batch) and backward (training's)
WH_FLASH = {"enc": (WH_BATCH, WH_HEADS, WH_FRAMES, WH_FRAMES, 64, False),
            "cross": (WH_BATCH, WH_HEADS, WH_PROMPT, WH_FRAMES, 64, False),
            "self": (WH_BATCH, WH_HEADS, WH_PROMPT, WH_PROMPT, 64, True)}
WH_FLASH_BWD = {"cross": (WH_MB, WH_HEADS, WH_T_SEQ, WH_FRAMES, 64, False),
                "enc": (WH_T_BATCH, WH_HEADS, WH_FRAMES, WH_FRAMES, 64,
                        False)}
# paligemma-3b, the prefix-LM (18 "attn" layers of d 2048, 8 q heads on 1
# kv head of 256, d_ff 16384 gated GELU, vocab 257216 tied, 256 stub
# patches before the tokens, attended bidirectionally; 2.51 B parameters
# drawn): static serving through the CLI at batch 4, prompt PG_PROMPT,
# PG_GEN tokens, which takes the token loop without patches as the
# reference's CLI does (no flash launch: decode attention is plain); the
# patch prefill through LM.prefill_with_cache, 256 patches + PG_PROMPT
# tokens (S 384, cache PG_CACHE), one flash a layer with the prefix, then
# PG_GEN greedy steps; C2P2SL training at T_BATCH x T_SEQ tokens + 256
# patches (768 rows a sequence on every hop), S 2 cut at 9, k 4, int8, 3
# steps: each block's flash forward twice a micro-batch (its checkpoint)
# and its backward once.  A step's hop bytes: 4 micro-batch hops of 2 x
# 768 rows of 2048 int8 and 12,288 f32 scales, each way
PG_ARCH, PG_LAYERS, PG_PATCHES = "paligemma-3b", 18, 256
PG_PROMPT, PG_GEN = 128, 32
PG_CACHE = PG_PATCHES + PG_PROMPT + PG_GEN      # 416
PG_T_CUT, PG_T_ROWS = 9, T_SEQ + PG_PATCHES     # 768 rows a sequence
PG_PREFILL = {"flash_attention": PG_LAYERS}
PG_T_LAUNCHES = {"flash_attention": 2 * PG_LAYERS * T_K * T_STEPS,
                 "flash_attention_bwd": PG_LAYERS * T_K * T_STEPS,
                 "wire_encode": 2 * T_K * T_STEPS,
                 "wire_decode": 2 * T_K * T_STEPS}
PG_HOP_BYTES = T_K * (T_BATCH // T_K * PG_T_ROWS * 2048
                      + T_BATCH // T_K * PG_T_ROWS * 2048 // 256 * 4)
# the flash calls of the path (B, Hq, Hkv, S, dh, prefix): training's (a
# micro-batch) and the patch prefill's
PG_FLASH = {"train": (T_BATCH // T_K, 8, 1, PG_T_ROWS, 256, PG_PATCHES),
            "prefill": (BATCH, 8, 1, PG_PATCHES + PG_PROMPT, 256,
                        PG_PATCHES)}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Wall time per call between CUDA events: device time plus whatever
    host overhead keeps the device waiting between launches."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_us(events):
    """Sum of the self device time (us) of the CUDA entries of a
    profiler's ``key_averages()``, and those entries."""
    rows = [e for e in events if str(getattr(e, "device_type", "")).endswith(
        "CUDA")]
    us = lambda e: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
    return sum(us(e) for e in rows), sorted(rows, key=us, reverse=True), us


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: the CUDA kernels' own time in a window of
    ``iters`` calls traced with torch.profiler (CUPTI), host overhead
    between launches left out.  CUDA events where the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, _, _ = _kernel_us(prof.key_averages())
    if total_us <= 0:
        print("profiler recorded no device time: timing with CUDA events")
        return cuda_ms(fn, iters, warmup)
    return total_us / iters / 1e3


L2_BYTES = 50e6                                  # H100's L2 cache


def cold_ms(fn, args, nbytes: int, iters: int = 20, copy=None) -> float:
    """``device_ms`` of ``fn(*args)`` as a caller whose data is not in L2
    would see it: the call runs on copies of ``args`` in turn (enough that
    they pass twice the L2's 50 MB at ``nbytes`` a call, at most 64) and
    keeps every result until the window ends, so no call reads what an
    earlier one left in L2 or writes into lines it left dirty there.
    ``copy(args)`` makes one copy (default: each tensor cloned)."""
    import torch
    n = min(64, max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    if copy is None:
        copy = lambda xs: tuple(a.clone() if torch.is_tensor(a) else a
                                for a in xs)
    copies = [args] + [copy(args) for _ in range(n - 1)]
    keep, turn = [], [0]

    def call():
        keep.append(fn(*copies[turn[0] % n]))
        turn[0] += 1
    ms = device_ms(call, iters=iters)
    del keep, copies
    return ms


def ptxas_report(log: str):
    """One (kernel, resources, spills) triple per function in a ``ptxas
    -v`` log: registers, barriers and shared memory from its "Used" line,
    stack and spill bytes from the line before it."""
    rows, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            rows.append((name, line.split("Used", 1)[1].strip(), spill))
    names = [r[0] for r in rows]
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True, timeout=60).stdout
        if len(out.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "").split("(")[0]
                     for n in out.splitlines()]
    return [(n, used, spill) for n, (_, used, spill) in zip(names, rows)]


def rate_line(row, ops: float) -> str:
    """A kernel row's time beside its achieved rate, the share of its
    bound and its library call's time."""
    lib = row["library_ms"]
    return (f"kernel {row['name']}: {row['ms']:.4f} ms, "
            f"{ops / row['ms'] / 1e9:.1f} TFLOP/s, "
            f"{row['bound_ms'] / row['ms']:.3f} of its bound "
            f"({row['bound_ms']:.4f} ms, {row['bound_by']}), library "
            f"{lib:.4f} ms ({row['ms'] / lib:.2f}x), max abs err "
            f"{row['max_abs_err']:.3e}")


def bound(nbytes: float, ops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 3


def check_codec(torch, wc, dev):
    """Encode/decode kernels against their plain versions, bit for bit;
    each decode on the route ``wire_codec.decode_route`` names (b = 256
    on "warp256", the rest and a payload view 1 byte off on "strided")."""
    gen = torch.Generator(device=dev).manual_seed(1)
    # (shape, dtype, payload based 1 byte off)
    cases = [((BATCH * PROMPT, 2560), torch.bfloat16, False),
             ((BATCH, 2560), torch.bfloat16, False),
             ((BATCH * PROMPT, 2560), torch.float32, True),
             ((BATCH, 2560), torch.bfloat16, True),
             ((37, 96), torch.bfloat16, False),
             ((3, 11, 96), torch.float32, False),
             ((33, 200), torch.float32, False)]
    for shape, dt, misaligned in cases:
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dt)
        x.view(-1, shape[-1])[0, :wc.wire_block(shape[-1])] = 0  # zero block
        for wire in ("int8", "fp8"):
            q, s = wc.encode_cuda(x, wire)
            qp, sp = wc.encode_plain(x, wire)
            torch.cuda.synchronize()
            if not (torch.equal(q.view(torch.uint8), qp.view(torch.uint8))
                    and torch.equal(s, sp)):
                bad = (q.view(torch.uint8) != qp.view(torch.uint8)).sum()
                fail(f"wire_encode {wire} {shape} {dt}: {int(bad)} payload "
                     f"bytes differ, max scale diff "
                     f"{float((s - sp).abs().max())}")
            if misaligned:
                buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
                q = buf[1:].view(q.shape).copy_(q)
            want = "warp256" if q.shape[-1] == 256 and not misaligned \
                else "strided"
            wc.ROUTES.clear()
            y = wc.decode_cuda(q, s, dt)
            yp = wc.decode_plain(q, s, dt)
            torch.cuda.synchronize()
            if dict(wc.ROUTES) != {want: 1}:
                fail(f"wire_decode {wire} {shape} {dt}: routes "
                     f"{dict(wc.ROUTES)}, expected {want}")
            if not torch.equal(y, yp):
                fail(f"wire_decode {wire} {shape} {dt} [{want}]: max diff "
                     f"{float((y.float() - yp.float()).abs().max())}")
            print(f"codec {wire:4s} {str(tuple(shape)):14s} "
                  f"{str(dt):15s} bit-exact, decode [{want}]"
                  f"{' payload 1 byte off' if misaligned else ''}")


def check_flash(torch, fa, dev):
    """Flash kernel against the plain version; returns the max error at
    each main path's bf16 shape, by head dim (qwen3-moe's 32 q heads on 4
    kv heads under "gqa8")."""
    gen = torch.Generator(device=dev).manual_seed(2)
    tol = {getattr(torch, name): t for name, t in FLASH_TOL.items()}
    hq, hkv, dh, w = RG_HEADS
    # (B, Hq, Hkv, S, dh, causal, window, dtype, model layout [B,S,H,dh])
    cases = [(BATCH, 20, 20, PROMPT, 128, True, 0, torch.bfloat16, True),
             (BATCH, 20, 20, PROMPT, 128, True, 0, torch.float32, True),
             (BATCH, hq, hkv, PROMPT, dh, True, w, torch.bfloat16, True),
             (BATCH, hq, hkv, PROMPT, dh, True, w, torch.float32, True),
             (1, hq, hkv, 3072, dh, True, w, torch.float32, False),
             (1, hq, hkv, 3072, dh, True, w, torch.bfloat16, False),
             (BATCH, GR_HEADS[0], GR_HEADS[1], PROMPT, GR_HEADS[2], True, 0,
              torch.bfloat16, True),
             (BATCH, GR_HEADS[0], GR_HEADS[1], PROMPT, GR_HEADS[2], True, 0,
              torch.float32, True),
             (BATCH, QM_HEADS[0], QM_HEADS[1], PROMPT, QM_HEADS[2], True, 0,
              torch.bfloat16, True),
             (BATCH, QM_HEADS[0], QM_HEADS[1], PROMPT, QM_HEADS[2], True, 0,
              torch.float32, True),
             (2, 8, 4, 200, 64, True, 0, torch.float32, False),
             (2, 8, 4, 200, 64, True, 0, torch.bfloat16, False),
             (2, 4, 4, 300, 128, True, 64, torch.float32, False),
             (2, 4, 4, 300, 128, True, 64, torch.bfloat16, False),
             (1, 4, 2, 130, 32, False, 0, torch.float32, False),
             (1, 4, 2, 130, 32, False, 0, torch.bfloat16, False),
             (2, 3, 3, 33, 16, False, 0, torch.bfloat16, True)]
    main_err = {}
    for b, hq, hkv, s, dh, causal, window, dt, bshd in cases:
        def mk(h):
            if bshd:
                t = torch.randn((b, s, h, dh), generator=gen, device=dev)
                return t.to(dt).transpose(1, 2)
            return torch.randn((b, h, s, dh), generator=gen,
                               device=dev).to(dt)
        q, k, v = mk(hq), mk(hkv), mk(hkv)
        want = "mma" if dt == torch.bfloat16 else "simt"
        fa.ROUTES.clear()
        o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        op = fa.attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((o.float() - op.float()).abs().max())
        name = (f"flash B{b} H{hq}/{hkv} S{s} dh{dh} causal={causal} "
                f"window={window} {dt}{' [B,S,H,dh] view' if bshd else ''}")
        if dict(fa.ROUTES) != {want: 1}:
            fail(f"{name}: routes {dict(fa.ROUTES)}, expected {want}")
        if not err <= tol[dt]:
            fail(f"{name}: max abs err {err} > {tol[dt]}")
        print(f"{name} [{want}]: max abs err {err:.3e} (tol {tol[dt]})")
        if bshd and dt == torch.bfloat16:
            main_err["gqa8" if hq == QM_HEADS[0] else dh] = err
    check_flash_rows_without_keys(torch, fa, dev, gen, tol)
    main_err.update(check_flash_whisper(torch, fa, dev, gen, tol))
    return main_err


def check_flash_whisper(torch, fa, dev, gen, tol):
    """whisper-small's forward calls (``WH_FLASH``) in the model layout
    ([B, S, H, 64] views), bf16 on "mma" and f32 on "simt": the encoder
    non-causal over 1500 frames, the cross-attention of 224 rows on 1500
    keys (23 tiles of 64 and a ragged 28; Sq != Skv), the decoder's
    causal self-attention.  Held to ``FLASH_TOL`` absolute against the
    plain version, and, with and without lse, element by element to
    ``FLASH_FWD_ELEM`` against the plain version in f32 on the inputs
    upcast: over 1500 keys a typical |o| is ~0.04, under the absolute
    bf16 gate, while a route that leaves out the ragged tile's P V fails
    the element gate (tests/test_torch_flash_fwd_gate.py emulates both).
    The kernel's lse within 1e-4 of the plain lse.  Returns the bf16 max
    error by call."""
    errs = {}
    for name, (b, h, sq, skv, dh, causal) in WH_FLASH.items():
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=dev)
                       .to(dt).transpose(1, 2) for s in (sq, skv, skv))
            want = "mma" if dt == torch.bfloat16 else "simt"
            fa.ROUTES.clear()
            o = fa.flash_attention_cuda(q, k, v, causal=causal)
            o2, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                              with_lse=True)
            op = fa.attention_plain(q, k, v, causal=causal)
            up = [t.float() for t in (q, k, v)]
            op32, lse_p = fa.attention_plain_lse(*up, causal=causal)
            mag = fa.attention_plain(up[0], up[1], up[2].abs(), causal=causal)
            torch.cuda.synchronize()
            err = float((o.float() - op.float()).abs().max())
            atol, rtol = FLASH_FWD_ELEM[str(dt).split(".")[-1]]
            share = max(float(((x.float() - op32).abs()
                               / (atol + rtol * mag)).max())
                        for x in (o, o2))
            lse_err = float((lse - lse_p).abs().max())
            label = (f"flash whisper {name} B{b} H{h} Sq{sq} Skv{skv} dh{dh} "
                     f"causal={causal} {dt} [B,S,H,dh] view")
            if dict(fa.ROUTES) != {want: 2} or o.stride() != q.stride():
                fail(f"{label}: routes {dict(fa.ROUTES)}, expected {want} "
                     f"twice; out strides {o.stride()} != q's {q.stride()}")
            if not err <= tol[dt]:
                fail(f"{label}: max abs err {err} > {tol[dt]}")
            if not (share <= 1.0 and lse_err <= 1e-4):
                fail(f"{label}: an element's error is {share:.3f} of its "
                     f"limit {atol} + {rtol} P|V| (in f32), or lse err "
                     f"{lse_err} > 1e-4")
            print(f"{label} [{want}]: max abs err {err:.3e} (tol {tol[dt]});"
                  f" worst element {share:.3f} of {atol:g} + {rtol:g} P|V|;"
                  f" lse err {lse_err:.1e}")
            if dt == torch.bfloat16:
                errs[f"whisper_{name}"] = err
            del q, k, v, o, o2, lse, op, up, op32, lse_p, mag
    return errs


def check_flash_rows_without_keys(torch, fa, dev, gen, tol):
    """Sq >= Skv + window (ROADMAP Queue 3, fault 5): q [1, 1, 256, 64]
    against k/v [1, 1, 128, 64] under window 16, causal and not; rows
    143-255 have no key, so the plain version gives each the mean of V
    over all 128 keys.  f32 and bf16 on their routes, and bf16 forced onto
    SIMT by a q whose base is 2 bytes off."""
    n = 256 * 64
    for dt, misaligned in ((torch.float32, False), (torch.bfloat16, False),
                           (torch.bfloat16, True)):
        for causal in (True, False):
            buf = torch.randn(n + 1, generator=gen, device=dev).to(dt)
            q = (buf[1:] if misaligned else buf[:n]).view(1, 1, 256, 64)
            k, v = (torch.randn((1, 1, 128, 64), generator=gen,
                                device=dev).to(dt) for _ in range(2))
            want = "mma" if dt == torch.bfloat16 and not misaligned \
                else "simt"
            fa.ROUTES.clear()
            o = fa.flash_attention_cuda(q, k, v, causal=causal, window=16)
            op = fa.attention_plain(q, k, v, causal=causal, window=16)
            torch.cuda.synchronize()
            err = float((o.float() - op.float()).abs().max())
            name = (f"flash rows without keys Sq 256 Skv 128 window 16 "
                    f"causal={causal} {dt}"
                    f"{' misaligned q' if misaligned else ''}")
            if dict(fa.ROUTES) != {want: 1}:
                fail(f"{name}: routes {dict(fa.ROUTES)}, expected {want}")
            if not err <= tol[dt]:
                fail(f"{name}: max abs err {err} > {tol[dt]}")
            print(f"{name} [{want}]: max abs err {err:.3e} (tol {tol[dt]})")


def check_flash_bwd(torch, fa, dev):
    """The flash backward kernel against ``attention_bwd_plain`` on the
    same values: the forward runs on its route with lse, the plain
    version in f32 on the inputs upcast (its outputs are not rounded a
    second time).  Tolerance ``FLASH_TOL`` absolute, the forward's
    contract, and element by element ``FLASH_BWD_ELEM`` (|g - p| <= atol
    + rtol |p|: bf16 outputs round at 2^-8 of their size, so a missing
    contribution to a small entry shows); the error relative to the
    largest value and the worst element's share of its limit printed
    beside them; the kernel's lse within 1e-4 of the plain lse.  Cases: qwen1.5-4b's training call
    [2, 20, 512, 128] bf16 causal in the model layout (dO as autograd
    gives it: a [B, S, H, dh] view), granite's 24 q on 8 kv heads of 64, a
    window, f32, a dO with no unit stride along dh (copied by the wrapper),
    and rows without keys (q [1, 1, 256, 64], k/v [1, 1, 128, 64], window
    16: rows 143-255 add dO / 128 to every row of dV, nothing to dq or
    dk).  Every case runs the backward twice on the same inputs: the same
    bits.  Each case's backward route is asserted (``BWD_ROUTES``): bf16 on
    "mma" (head dims 64 and 128), f32 and a bf16 q based 2 bytes off 16 on
    "simt".  Then whisper-small's training calls, non-causal with Sq !=
    Skv and a ragged Skv of 1500 (23 key tiles of 64 and one of 28 live
    rows): the cross-attention [8, 12, 448, 64] on [8, 12, 1500, 64] and
    the encoder at [32, 12, 1500, 64], bf16 on "mma", and [1, 4, 100, 64]
    on [1, 4, 300, 64] f32 on "simt".  Returns (the max abs error at
    qwen's call, whisper's by call)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    b, h, s, dh = Q_TRAIN
    gh, gkv, gdh = GR_HEADS
    # (B, Hq, Hkv, Sq, Skv, dh, causal, window, dtype, q/k/v in the model
    # layout, dO layout: "bshd" a model-layout view, "bhsd" contiguous,
    # "bhds" a [B, H, dh, S] transpose; q based 2 bytes off 16)
    cases = [(b, h, h, s, s, dh, True, 0, bf16, True, "bshd", False),
             (b, gh, gkv, s, s, gdh, True, 0, bf16, True, "bshd", False),
             (2, 4, 4, 300, 300, 128, True, 64, bf16, False, "bhsd", False),
             (2, 4, 2, 300, 300, 64, True, 48, f32, False, "bhsd", False),
             (b, 4, 4, s, s, dh, True, 0, f32, True, "bshd", False),
             (1, 4, 2, 130, 130, 64, False, 0, bf16, False, "bhds", False),
             (1, 1, 1, 256, 128, 64, True, 16, bf16, False, "bhsd", False),
             (1, 1, 1, 256, 128, 64, True, 16, f32, False, "bhsd", False),
             (2, 4, 4, 130, 130, 64, True, 0, bf16, False, "bhsd", True)]
    # whisper-small's training calls (WH_FLASH_BWD: the cross-attention of
    # 448 rows on 1500 keys, the encoder at the training batch), non-causal,
    # dO in the model layout as autograd gives it, and a small f32 case
    # whose Skv is ragged and longer than Sq
    whisper = {}
    for name, (wb, wh, wsq, wskv, wdh, wcausal) in WH_FLASH_BWD.items():
        whisper[len(cases)] = f"whisper_{name}"
        cases.append((wb, wh, wh, wsq, wskv, wdh, wcausal, 0, bf16, True,
                      "bshd", False))
    cases.append((1, 4, 4, 100, 300, 64, False, 0, f32, True, "bshd", False))
    main_err, whisper_err = None, {}
    for i, (bb, hq, hkv, sq, skv, d, causal, window, dt, bshd, dol,
            mis) in enumerate(cases):
        def mk(h_, s_, layout):
            shape = {"bshd": (bb, s_, h_, d), "bhsd": (bb, h_, s_, d),
                     "bhds": (bb, h_, d, s_)}[layout]
            t = torch.randn(shape, generator=gen, device=dev).to(dt)
            return {"bshd": lambda: t.transpose(1, 2), "bhsd": lambda: t,
                    "bhds": lambda: t.transpose(2, 3)}[layout]()
        lay = "bshd" if bshd else "bhsd"
        q, k, v = mk(hq, sq, lay), mk(hkv, skv, lay), mk(hkv, skv, lay)
        do = mk(hq, sq, dol)
        if mis:
            buf = torch.empty(q.numel() + 1, dtype=dt, device=dev)
            q = buf[1:].view(q.shape).copy_(q)
        kw = dict(causal=causal, window=window)
        fa.ROUTES.clear()
        fa.BWD_ROUTES.clear()
        o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        up = [t.float() for t in (q, k, v)]
        _, lse_p = fa.attention_plain_lse(*up, **kw)
        plain = fa.attention_bwd_plain(*up, o.float(), lse_p, do.float(),
                                       **kw)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        atol, rtol = FLASH_BWD_ELEM[str(dt).split(".")[-1]]
        want = "mma" if dt == bf16 and not mis else "simt"
        errs = {n: float((g.float() - p).abs().max())
                for n, g, p in zip(("dq", "dk", "dv"), grads, plain)}
        share = max(float(((g.float() - p).abs() / (atol + rtol * p.abs()))
                          .max()) for g, p in zip(grads, plain))
        rel = {n: errs[n] / max(float(p.abs().max()), 1e-30)
               for n, p in zip(("dq", "dk", "dv"), plain)}
        lse_err = float((lse - lse_p).abs().max())
        name = (f"flash_bwd B{bb} H{hq}/{hkv} Sq{sq} Skv{skv} dh{d} "
                f"causal={causal} window={window} {dt} dO {dol}"
                f"{' q 2 bytes off' if mis else ''}")
        if dict(fa.ROUTES) != {want: 1}:
            fail(f"{name}: forward routes {dict(fa.ROUTES)}, expected {want}")
        if dict(fa.BWD_ROUTES) != {want: 2}:
            fail(f"{name}: backward routes {dict(fa.BWD_ROUTES)}, expected "
                 f"{want}")
        if not (max(errs.values()) <= tol and lse_err <= 1e-4):
            fail(f"{name}: max abs errs {errs} > {tol} or lse err "
                 f"{lse_err} > 1e-4")
        if not share <= 1.0:
            fail(f"{name}: an element's error is {share:.3f} of its limit "
                 f"{atol} + {rtol} |plain|")
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            fail(f"{name}: a second backward call gave other bits")
        print(f"{name} [forward and backward {want}]: max abs err "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (tol {tol}); relative to the largest value "
              + ", ".join(f"{n} {e:.1e}" for n, e in rel.items())
              + f"; worst element {share:.3f} of {atol:g} + {rtol:g} |p|"
              + f"; lse err {lse_err:.1e}; second call: the same bits")
        if main_err is None:
            main_err = max(errs.values())
        if i in whisper:
            whisper_err[whisper[i]] = max(errs.values())
        del q, k, v, do, o, lse, grads, again, up, plain
    return main_err, whisper_err


RGLRU_TOL = {"float32": 2e-4, "bfloat16": 1e-2}


def check_rglru(torch, rg, dev):
    """RG-LRU scan kernel against its plain version, relative to the
    largest value: 2e-4 in f32 (the reference's bound on its own kernel),
    1e-2 in bf16 (h and h_last rounded to bf16).  log a is drawn from the
    model's range, -8 softplus(lambda) r in (-0.105, 0), or from (-20, 0)
    (strong decay).  Shapes: the model's call, ragged S and R, S = 1,
    CHUNK - 1, CHUNK, CHUNK + 1 and 0, and [1, 4096, 2560] (64 chunks
    chained by look-back).  Then two calls in a row on different inputs,
    each held to the plain version (no stale flag is read), and two calls
    on the same inputs, bit for bit.  Returns the max abs error of h at the
    model's call (f32, no h0)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    f32, bf16, c = torch.float32, torch.bfloat16, rg.CHUNK
    # (shape, dtype, h0 given, log a span)
    cases = [(RG_SHAPE, f32, False, 0.105), (RG_SHAPE, f32, True, 0.105),
             (RG_SHAPE, bf16, False, 0.105), (RG_SHAPE, bf16, True, 0.105),
             ((3, 300, 200), f32, True, 0.105),
             ((3, 300, 200), bf16, False, 0.105),
             ((2, 1, 70), f32, True, 0.105), ((2, c - 1, 70), f32, False, 0.105),
             ((2, c, 70), bf16, True, 0.105), ((2, c + 1, 130), f32, True, 0.105),
             ((2, 0, 70), f32, True, 0.105), ((2, 0, 70), bf16, False, 0.105),
             ((1, 4096, 2560), f32, True, 0.105),
             ((2, 300, 130), f32, True, 20.0), ((2, 300, 130), bf16, True, 20.0)]
    main = None

    def inputs(shape, dt, with_h0, span):
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        la = (-span * torch.rand(shape, generator=gen, device=dev)).to(dt)
        h0 = torch.randn((shape[0], shape[2]), generator=gen, device=dev) \
            if with_h0 else None
        return x, la, h0

    def held(name, dt, got, want):
        (h, last), (hp, lastp) = got, want
        tol = RGLRU_TOL[str(dt).split(".")[-1]]
        err = max(_rel_err(h, hp) if h.numel() else 0.0,
                  _rel_err(last, lastp))
        if not (err <= tol and h.dtype == last.dtype == dt
                and h.shape == hp.shape):
            fail(f"{name}: max rel err {err} > {tol} (or dtype {h.dtype}, "
                 f"shape {tuple(h.shape)})")
        print(f"{name}: max rel err {err:.3e} (tol {tol})")

    for shape, dt, with_h0, span in cases:
        x, la, h0 = inputs(shape, dt, with_h0, span)
        h, last = rg.rglru_cuda(x, la, h0)
        hp, lastp = rg.rglru_plain(x, la, h0)
        torch.cuda.synchronize()
        held(f"rglru {shape} {dt}{' h0 given' if with_h0 else ''}"
             f"{' log a in (-20, 0)' if span > 1 else ''}", dt, (h, last),
             (hp, lastp))
        if shape == RG_SHAPE and dt == f32 and not with_h0:
            main = float((h - hp).abs().max())
    ins = [inputs(RG_SHAPE, f32, True, 0.105) for _ in range(2)]
    outs = [rg.rglru_cuda(*i) for i in ins]
    for k, (i, o) in enumerate(zip(ins, outs)):
        held(f"rglru {RG_SHAPE} back-to-back call {k + 1} of 2", f32, o,
             rg.rglru_plain(*i))
    again = rg.rglru_cuda(*ins[1])
    torch.cuda.synchronize()
    if not (torch.equal(again[0], outs[1][0])
            and torch.equal(again[1], outs[1][1])):
        fail("rglru: two calls on the same inputs differ")
    print(f"rglru {RG_SHAPE}: two calls on the same inputs, same bits")
    return main


def check_small_hybrid(torch, dev):
    """The f32 SMOKE recurrentgemma (3 layers, window 8) on the card
    against the same model on the CPU: prefill logits of a 12-token prompt
    (the ring wraps, the window masks) and 8 decode steps' logits, 1e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.utils.trees import tree_map
    cfg = get_arch(RG_ARCH).smoke
    cpu, card = LM(cfg, "cpu"), LM(cfg, dev)
    params = cpu.init(torch.Generator().manual_seed(SEED))
    pcard = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(3))
    errs = []
    with torch.inference_mode():
        lc, sc = cpu.prefill_with_cache(params, {"tokens": toks}, 20,
                                        torch.float32)
        lg, sg = card.prefill_with_cache(pcard, {"tokens": toks.to(dev)}, 20,
                                         torch.float32)
        errs.append(float((lg.cpu() - lc).abs().max()))
        tok = torch.argmax(lc, -1, keepdim=True)
        for pos in range(12, 20):
            lc, _ = cpu.decode_step(params, tok, sc["cache"], pos)
            lg, _ = card.decode_step(pcard, tok.to(dev), sg["cache"], pos)
            errs.append(float((lg.cpu() - lc).abs().max()))
            tok = torch.argmax(lc, -1, keepdim=True)
    if not (lg.shape == (2, cfg.vocab) and all(math.isfinite(e) and e <= 1e-3
                                               for e in errs)):
        fail(f"small recurrentgemma on the card vs CPU: logit errs {errs}")
    print(f"small f32 recurrentgemma, card vs CPU: prefill logits max err "
          f"{errs[0]:.3e}, 8 decode steps max err {max(errs[1:]):.3e} "
          f"(tol 1e-3)")


GMM_TOL = {"float32": 2e-4, "bfloat16": 1e-2}


def check_moe_gmm(torch, mg, dev):
    """The grouped expert matmul kernel against its plain version,
    relative to the largest value: 2e-4 in f32 (sums over D in another
    order), 1e-2 in bf16 (the output rounded once, one bf16 step is 2^-8;
    the tensor cores sum in another order).  Each call must take the
    route its dtype and C imply.  Returns the max abs errors at the
    prefill (w1) and decode shapes in bf16, granite's and qwen3-moe's (128
    experts: [128, 160, 2048] @ [128, 2048, 768], its w2 and capacity
    8)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    e, c, d, f = GR_GMM
    qe, qc, qd, qf = QM_GMM
    shapes = [GR_GMM, (e, c, f, d), GR_GMM_DECODE, (5, 37, 200, 72),
              (3, 130, 200, 72), (2, 1, 200, 72), (3, 8, 200, 72),
              (2, 12, 200, 72), (2, 16, 200, 72), QM_GMM, (qe, qc, qf, qd),
              QM_GMM_DECODE]
    main = {}
    for shape in shapes:
        for dt in (torch.bfloat16, torch.float32):
            e_, c_, d_, f_ = shape
            h = torch.randn((e_, c_, d_), generator=gen, device=dev).to(dt)
            w = (torch.randn((e_, d_, f_), generator=gen, device=dev)
                 / math.sqrt(d_)).to(dt)
            want = "simt" if dt == torch.float32 else (
                "wgmma_small_c" if c_ <= mg.SMALL_C else "wgmma")
            mg.ROUTES.clear()
            out = mg.moe_gmm_cuda(h, w)
            plain = mg.moe_gmm_plain(h, w)
            torch.cuda.synchronize()
            tol = GMM_TOL[str(dt).split(".")[-1]]
            err = _rel_err(out, plain)
            name = f"moe_gmm [{e_},{c_},{d_}] @ [{e_},{d_},{f_}] {dt}"
            if dict(mg.ROUTES) != {want: 1}:
                fail(f"{name}: routes {dict(mg.ROUTES)}, expected {want}")
            if not (err <= tol and out.dtype == dt
                    and tuple(out.shape) == (e_, c_, f_)):
                fail(f"{name}: max rel err {err} > {tol} (or dtype "
                     f"{out.dtype}, shape {tuple(out.shape)})")
            print(f"{name} [{want}]: max rel err {err:.3e} (tol {tol})")
            if dt == torch.bfloat16 and shape in (GR_GMM, GR_GMM_DECODE,
                                                  QM_GMM, QM_GMM_DECODE):
                main[shape] = float((out.float() - plain.float()).abs().max())
    return main


def _routes_of(orig, where, routes):
    """The router ``orig`` (``moe._route``), also recording each call's
    (probs, expert ids) on the CPU under ``routes[where]``."""
    def route(x, router, topk):
        out = orig(x, router, topk)
        routes[where].append((out[0].detach().cpu(), out[2].detach().cpu()))
        return out
    return route


def check_small_moe(torch, dev):
    """The f32 SMOKE granite-moe (2 layers, top 2 of 5 experts, tied
    head) on the card against the same model on the CPU: a 12-token
    prefill and 8 decode steps fed the CPU's greedy tokens.  The router's
    top-k expert ids of every MoE call are compared first: a flip at a
    near-tie fails as such, with its probability gap.  Then the logits,
    within 1e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.utils.trees import tree_map
    cfg = get_arch(GR_ARCH).smoke
    cpu, card = LM(cfg, "cpu"), LM(cfg, dev)
    params = cpu.init(torch.Generator().manual_seed(SEED))
    pcard = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(3))
    routes, logits, feed = {"cpu": [], "card": []}, {}, []
    orig = moe._route
    try:
        with torch.inference_mode():
            moe._route = _routes_of(orig, "cpu", routes)
            lc, sc = cpu.prefill_with_cache(params, {"tokens": toks}, 20,
                                            torch.float32)
            logits["cpu"] = [lc]
            for pos in range(12, 20):
                feed.append(torch.argmax(lc, -1, keepdim=True))
                lc, _ = cpu.decode_step(params, feed[-1], sc["cache"], pos)
                logits["cpu"].append(lc)
            moe._route = _routes_of(orig, "card", routes)
            lg, sg = card.prefill_with_cache(pcard, {"tokens": toks.to(dev)},
                                             20, torch.float32)
            logits["card"] = [lg.cpu()]
            for pos, tok in zip(range(12, 20), feed):
                lg, _ = card.decode_step(pcard, tok.to(dev), sg["cache"], pos)
                logits["card"].append(lg.cpu())
    finally:
        moe._route = orig
    if len(routes["cpu"]) != len(routes["card"]) or not routes["cpu"]:
        fail(f"small granite-moe: {len(routes['cpu'])} router calls on the "
             f"CPU, {len(routes['card'])} on the card")
    for i, ((pc, ic), (_, ig)) in enumerate(zip(routes["cpu"],
                                                routes["card"])):
        if not torch.equal(ic, ig):
            t = int((ic != ig).any(-1).nonzero()[0, 0])
            top = torch.sort(pc[t], descending=True).values
            k = ic.shape[-1]
            fail(f"small granite-moe: router top-k differs at call {i} "
                 f"(layer {i % cfg.num_layers}), token {t}: ids "
                 f"{ic[t].tolist()} on the CPU, {ig[t].tolist()} on the "
                 f"card; CPU probabilities at ranks k, k+1: "
                 f"{top[k - 1]:.9f}, {top[k]:.9f} (a near-tie flip)")
    errs = [float((g - c).abs().max())
            for g, c in zip(logits["card"], logits["cpu"])]
    if not (logits["card"][0].shape == (2, cfg.vocab)
            and all(math.isfinite(e) and e <= 1e-3 for e in errs)):
        fail(f"small granite-moe on the card vs CPU: logit errs {errs}")
    print(f"small f32 granite-moe, card vs CPU: router top-k ids equal in "
          f"all {len(routes['cpu'])} MoE calls; prefill logits max err "
          f"{errs[0]:.3e}, 8 decode steps max err {max(errs[1:]):.3e} "
          f"(tol 1e-3)")


def check_small_moe_split(torch, ops, serve):
    """qwen3-moe SMOKE (f32, untied head) through the serving CLI on the
    card: static, then split at cut 1 with wire none and int8 over the
    loopback socket.  'none' tokens must equal the static tokens, and the
    measured payload bytes the billed bytes."""
    argv = ["--arch", QM_ARCH, "--size", "smoke", "--batch", "2",
            "--prompt-len", "12", "--gen", "8", "--seed", str(SEED)]
    ops.reset_launches()
    static = serve.main(argv)
    for wire in ("none", "int8"):
        res = serve.main(argv + ["--split-cut", "1", "--wire-dtype", wire])
        if res["measured_payload_bytes"] != res["billed_payload_bytes"]:
            fail(f"{QM_ARCH} smoke split {wire}: measured "
                 f"{res['measured_payload_bytes']} B != billed "
                 f"{res['billed_payload_bytes']} B")
        if wire == "none" and not torch.equal(res["tokens"],
                                              static["tokens"]):
            fail(f"{QM_ARCH} smoke split 'none' tokens differ from the "
                 "static tokens")
        print(f"{QM_ARCH} smoke split cut 1 {wire} on the card: "
              f"{res['frames']} frames, {res['measured_payload_bytes']} B "
              f"measured == billed"
              + (", tokens == static tokens" if wire == "none" else ""))
    launches = dict(ops.LAUNCHES)
    for name in ("moe_gmm", "flash_attention", "wire_encode", "wire_decode"):
        if launches.get(name, 0) <= 0:
            fail(f"{QM_ARCH} smoke split: kernel {name} was not launched")


def check_small_model(torch, dev):
    """A small f32 model on the card against the same model on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.utils.trees import tree_map
    cfg = get_arch(ARCH).smoke
    cpu = LM(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(SEED))
    card = LM(cfg, dev)
    pcard = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, cfg.vocab, (2, 70),
                         generator=torch.Generator().manual_seed(3))
    lc, _ = cpu.prefill_with_cache(params, {"tokens": toks}, 80,
                                   torch.float32)
    lg, _ = card.prefill_with_cache(pcard, {"tokens": toks.to(dev)}, 80,
                                    torch.float32)
    err = float((lg.cpu() - lc).abs().max())
    if not (lg.shape == (2, cfg.vocab) and math.isfinite(err) and err <= 1e-3):
        fail(f"small model on the card vs CPU: max logit err {err}")
    print(f"small f32 model, card vs CPU prefill logits: max err {err:.3e}")


def check_small_paligemma(torch, ops, dev):
    """paligemma-3b SMOKE in f32 (2 layers, d 64, 4 q heads on 1 kv head
    of 16, 8 patches) on the card against the CPU: the training forward's
    loss and every parameter's gradient with 8 patches before 40 tokens
    (the card's through the flash forward and backward kernels with the
    prefix: 2 layers, each forward again under its checkpoint), within
    1e-4 of the loss and of the largest gradient; then the patch prefill's
    last logits within 1e-3, as ``check_small_model``.  The C²P²SL step
    is ``check_small_training``'s."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.utils.trees import tree_leaves, tree_map
    cfg = get_arch(PG_ARCH).smoke
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(SEED),
                                 master=True)
    gen = torch.Generator().manual_seed(8)
    batch = {n: torch.randint(0, cfg.vocab, (4, 40), generator=gen)
             for n in ("tokens", "labels")}
    batch["patch_embeds"] = torch.randn((4, cfg.num_patches, cfg.d_model),
                                        generator=gen)
    out = {}
    for where in ("cpu", dev):
        model = LM(cfg, where)
        p = tree_map(lambda t: t.detach().clone().to(where)
                     .requires_grad_(True), params)
        b = {n: t.to(where) for n, t in batch.items()}
        ops.reset_launches()
        loss, _ = model.forward(p, b)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        launches = dict(ops.LAUNCHES)
        with torch.no_grad():
            logits, st = model.prefill_with_cache(
                p, {n: t for n, t in b.items() if n != "labels"}, 56,
                torch.float32)
        out[str(where)] = (float(loss), grads, logits.cpu(), launches,
                           st["position"])
    (lc, gc_, xc, _, _), (lg, gg, xg, launches, pos) = (out["cpu"],
                                                        out[str(dev)])
    top = max(float(g.abs().max()) for g in gc_)
    gerr = max(float((a.cpu() - b_).abs().max()) for a, b_ in zip(gg, gc_))
    xerr = float((xg - xc).abs().max())
    want = {"flash_attention": 4, "flash_attention_bwd": 2}
    if not (abs(lg - lc) <= 1e-4 * abs(lc) and gerr <= 1e-4 * max(top, 1.0)
            and xerr <= 1e-3 and pos == 48):
        fail(f"small {PG_ARCH}, card vs CPU: loss {lg} vs {lc}, max grad "
             f"diff {gerr} (largest {top}), prefill logits {xerr}, "
             f"position {pos}")
    if launches != want:
        fail(f"small {PG_ARCH} forward and backward: launches {launches}, "
             f"expected {want}")
    print(f"small f32 {PG_ARCH} (8 patches + 40 tokens), card vs CPU: loss "
          f"{lg:.6f} vs {lc:.6f}, max gradient diff {gerr:.2e} (largest "
          f"{top:.3e}, tol 1e-4 of it), prefill logits {xerr:.2e} (tol "
          f"1e-3), position {pos}; launches {launches}")


def check_rglru_bwd(torch, rg, dev):
    """The RG-LRU backward kernel against ``rglru_bwd_plain`` on the
    kernel's own forward h, within 2e-4 (f32) / 1e-2 (bf16) of the largest
    value: the training path's call ([2, 4096, 2560] f32, no h0, no
    gradient of h_last), S = 1, S = 65 (past one chunk), R = 200 and 130
    (not multiples of 64), with and without h0, with dh_last, S = 0 (dh0 =
    dh_last), log a in (-20, 0) and bf16; two calls on the path's inputs
    bit for bit.  Returns the path call's error."""
    gen = torch.Generator(device=dev).manual_seed(21)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (b, s, r, h0, dh_last, log a span, dtype)
        (*RT_SCAN, False, False, 0.105, f32),
        (2, 1, 200, True, True, 0.105, f32),
        (2, 65, 200, False, True, 0.105, f32),
        (3, 300, 130, True, True, 20.0, f32),
        (2, 0, 64, True, True, 0.105, f32),
        (2, 130, 2560, True, True, 0.105, bf16),
    ]
    path_err = None
    for b, s, r, with_h0, with_dl, span, dt in cases:
        x = torch.randn((b, s, r), generator=gen, device=dev).to(dt)
        la = (-span * torch.rand((b, s, r), generator=gen, device=dev)).to(dt)
        h0 = torch.randn((b, r), generator=gen, device=dev) if with_h0 \
            else None
        h, _ = rg.rglru_cuda(x, la, h0)
        dh = torch.randn((b, s, r), generator=gen, device=dev).to(dt)
        dl = torch.randn((b, r), generator=gen, device=dev).to(dt) \
            if with_dl else None
        got = rg.rglru_bwd_cuda(x, la, h0, h, dh, dl)
        want = rg.rglru_bwd_plain(x, la, h0, h, dh, dl)
        torch.cuda.synchronize()
        tol = 2e-4 if dt == f32 else 1e-2
        errs = [_rel_err(a, w) if a.numel() else 0.0
                for a, w in zip(got, want) if a is not None]
        if (got[2] is None) != (h0 is None) or not max(errs) <= tol:
            fail(f"rglru_bwd at [{b}, {s}, {r}] {dt} h0 {with_h0} dh_last "
                 f"{with_dl}: errors {errs} (tol {tol})")
        if path_err is None:
            path_err = max(float((a.float() - w.float()).abs().max())
                           for a, w in zip(got[:2], want[:2]))
            again = rg.rglru_bwd_cuda(x, la, h0, h, dh, dl)
            if not all(torch.equal(a, c) for a, c in zip(got[:2], again[:2])):
                fail("rglru_bwd: two calls on the same inputs differ")
        print(f"rglru_bwd at [{b}, {s}, {r}] {str(dt)[6:]} (h0 {with_h0}, "
              f"dh_last {with_dl}, log a in (-{span}, 0)): dx, dlog a"
              f"{', dh0' if with_h0 else ''} within "
              f"{', '.join(f'{e:.2e}' for e in errs)} of the largest value "
              f"(tol {tol})")
    return path_err


def check_moe_gmm_bwd(torch, mg, dev):
    """The grouped matmul's backward kernel (dh, dw) against
    ``moe_gmm_bwd_plain`` within 2e-4 (f32) / 1e-2 (bf16) of the largest
    value, each call on its asserted route (``mg.BWD_ROUTES``): granite-
    moe-3b-a800m's training shapes (capacity 256) in bf16 ("wgmma") and
    f32 ("simt"), C below ``SMALL_C`` (8), ragged C, D and F (37, 200,
    72; 130, 96, 40), F = 33 (rows 66 bytes apart: "simt" in bf16 too),
    and misaligned views (h from a [C, E, D] buffer based 2 bytes off 16,
    w a column slice, dout without a unit stride: "simt").  Returns the
    max abs error at the path's w1 shape in bf16."""
    gen = torch.Generator(device=dev).manual_seed(22)
    f32, bf16 = torch.float32, torch.bfloat16
    e, c, d, f = GT_GMM
    cases = [(GT_GMM, bf16, "wgmma"), ((e, c, f, d), bf16, "wgmma"),
             (GT_GMM, f32, "simt"), ((3, 8, 200, 72), f32, "simt"),
             ((3, 8, 200, 72), bf16, "wgmma"),
             ((5, 37, 200, 72), bf16, "wgmma"),
             ((2, 130, 96, 40), bf16, "wgmma"),
             ((2, 130, 96, 33), f32, "simt"),
             ((2, 130, 96, 33), bf16, "simt")]
    path_err = None
    for (e_, c_, d_, f_), dt, want_route in cases:
        h = torch.randn((e_, c_, d_), generator=gen, device=dev).to(dt)
        w = (torch.randn((e_, d_, f_), generator=gen, device=dev)
             / math.sqrt(d_)).to(dt)
        dout = torch.randn((e_, c_, f_), generator=gen, device=dev).to(dt)
        mg.BWD_ROUTES.clear()
        got = mg.moe_gmm_bwd_cuda(h, w, dout)
        want = mg.moe_gmm_bwd_plain(h, w, dout)
        torch.cuda.synchronize()
        if dict(mg.BWD_ROUTES) != {want_route: 1}:
            fail(f"moe_gmm_bwd at [{e_}, {c_}, {d_}, {f_}] {dt}: routes "
                 f"{dict(mg.BWD_ROUTES)}, expected {want_route}")
        tol = 2e-4 if dt == f32 else 1e-2
        errs = [_rel_err(a, b_) for a, b_ in zip(got, want)]
        if not max(errs) <= tol:
            fail(f"moe_gmm_bwd at [{e_}, {c_}, {d_}, {f_}] {dt}: errors "
                 f"{errs} (tol {tol})")
        if path_err is None:
            path_err = max(float((a.float() - b_.float()).abs().max())
                           for a, b_ in zip(got, want))
        print(f"moe_gmm_bwd at E, C, D, F = {[e_, c_, d_, f_]} "
              f"{str(dt)[6:]} on {want_route}: dh, dw within "
              f"{errs[0]:.2e}, {errs[1]:.2e} of the largest value (tol "
              f"{tol})")
    buf = torch.randn(20 * 3 * 48 + 1, generator=gen, device=dev).to(bf16)
    h = buf[1:].view(20, 3, 48).transpose(0, 1)
    w = (torch.randn((3, 48, 40), generator=gen, device=dev) / 7).to(
        bf16)[:, :, :33]
    dout = torch.randn((3, 33, 20), generator=gen, device=dev).to(
        bf16).transpose(1, 2)
    mg.BWD_ROUTES.clear()
    errs = [_rel_err(a, b_) for a, b_ in zip(mg.moe_gmm_bwd_cuda(h, w, dout),
                                             mg.moe_gmm_bwd_plain(h, w, dout))]
    if dict(mg.BWD_ROUTES) != {"simt": 1}:
        fail(f"moe_gmm_bwd on misaligned views: routes "
             f"{dict(mg.BWD_ROUTES)}")
    if not max(errs) <= 1e-2:
        fail(f"moe_gmm_bwd on misaligned views: errors {errs}")
    print(f"moe_gmm_bwd on misaligned bf16 views, simt: within "
          f"{max(errs):.2e}")
    return path_err


def check_flash_bwd256(torch, fa, dev):
    """The flash backward at head dim 256 against ``attention_bwd_plain``:
    recurrentgemma-2b's training call ([2, 10, 4096, 256] q on one kv
    head in the model layout, causal, window 2048 shorter than S) and two
    small bf16 calls (ragged S 300 with window 100; Sq 256 on Skv 130 with
    window 48, whose last rows see no key), all on "mma" (the dK/dV
    kernel's heads split over ``dkv_groups`` blocks: 5 and 10), and a
    ragged f32 call ([1, 10, 300, 256], window 100) on "simt"; within
    ``FLASH_TOL`` absolute and ``FLASH_BWD_ELEM`` element by element, two
    calls bit for bit.  Returns the training call's max abs error."""
    gen = torch.Generator(device=dev).manual_seed(23)
    hq, hkv, dh, window = RG_HEADS
    path_err = None
    for b, sq, skv, win, dt in (
            (RT_BATCH // RT_K, RT_SEQ, RT_SEQ, window, "bfloat16"),
            (1, 300, 300, 100, "bfloat16"), (1, 256, 130, 48, "bfloat16"),
            (1, 300, 300, 100, "float32")):
        tdt = getattr(torch, dt)
        mk = lambda h, s: torch.randn((b, s, h, dh), generator=gen,
                                      device=dev).to(tdt).transpose(1, 2)
        q, k, v, do = mk(hq, sq), mk(hkv, skv), mk(hkv, skv), mk(hq, sq)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=win,
                                         with_lse=True)
        fa.BWD_ROUTES.clear()
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True,
                                          window=win)
        again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True,
                                            window=win)
        route = "mma" if dt == "bfloat16" else "simt"
        if dict(fa.BWD_ROUTES) != {route: 2}:
            fail(f"flash_bwd dh 256 {dt}: routes {dict(fa.BWD_ROUTES)}, "
                 f"expected {route}")
        f = [t.float() for t in (q, k, v)]
        want = fa.attention_bwd_plain(*f, o.float(), lse, do.float(),
                                      causal=True, window=win)
        torch.cuda.synchronize()
        atol, rtol = FLASH_BWD_ELEM[dt]
        errs, shares = [], []
        for g, w_, g2 in zip(got, want, again):
            diff = (g.float() - w_).abs()
            errs.append(float(diff.max()))
            shares.append(float((diff / (atol + rtol * w_.abs())).max()))
            if not (errs[-1] <= FLASH_TOL[dt] and shares[-1] <= 1.0
                    and torch.equal(g, g2)):
                fail(f"flash_bwd dh 256 at [{b}, {hq}, {sq}, {dh}] on Skv "
                     f"{skv} {dt} window {win}: max err {errs[-1]}, element "
                     f"gate share {shares[-1]}, or repeat failed")
        del want
        if path_err is None:
            path_err = max(errs)
        groups = fa.dkv_groups(dh, hq // hkv, hkv, b, skv)
        print(f"flash_bwd dh 256 at [{b}, {hq}, {sq}, {dh}] on {hkv} kv "
              f"head, Skv {skv}, {dt}, window {win}, route {route}"
              + (f" ({groups} head groups)" if route == "mma" else "")
              + f": dq, dk, dv max err {', '.join(f'{e:.2e}' for e in errs)}"
              f" (tol {FLASH_TOL[dt]}), element gate at most "
              f"{max(shares):.3f} of its bound, two calls bit for bit")
    return path_err


def check_flash_prefix(torch, fa, dev):
    """The flash forward and backward under paligemma-3b's prefix-LM mask
    (causal, the first ``prefix_len`` keys seen by every row), the
    extension of ``check_flash`` / ``check_flash_bwd``: its training call
    [2, 8, 768, 256] and its patch prefill [4, 8, 384, 256] (8 q heads on
    one kv head, prefix 256), a prefix of 200 that splits a key tile, a
    prefix at Sq (300) and one past it (400), both then the non-causal
    call's bits both ways, bf16 on "mma" (the backward on ``bwd256``); f32
    on "simt" at dh 16 (prefix 37) and dh 256 (prefix 64).  q, k, v and dO
    in the model layout.  The output, with and without lse, within
    ``FLASH_TOL`` and element by element within ``FLASH_FWD_ELEM`` of the
    plain version in f32 on the inputs upcast (on P|V|), the lse within
    1e-4, dq, dk and dv within ``FLASH_TOL`` and ``FLASH_BWD_ELEM``, two
    backward calls bit for bit.  Returns the max abs errors of the
    forward ("paligemma_<call>") and backward ("bwd_paligemma_<call>") at
    the path's two calls."""
    gen = torch.Generator(device=dev).manual_seed(29)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, *PG_FLASH[name], bf16) for name in ("train", "prefill")]
    cases += [("ragged prefix", 1, 8, 1, 512, 256, 200, bf16),
              ("prefix at Sq", 1, 4, 1, 300, 256, 300, bf16),
              ("prefix past Sq", 1, 4, 1, 300, 256, 400, bf16),
              ("f32 dh 16", 1, 4, 1, 100, 16, 37, f32),
              ("f32 dh 256", 1, 4, 1, 130, 256, 64, f32)]
    errs = {}
    for name, b, hq, hkv, s, dh, prefix, dt in cases:
        q, k, v, do = (torch.randn((b, s, h, dh), generator=gen, device=dev)
                       .to(dt).transpose(1, 2) for h in (hq, hkv, hkv, hq))
        kw = dict(causal=True, prefix_len=prefix)
        dtn = str(dt).split(".")[-1]
        route = "mma" if dt == bf16 else "simt"
        bwd_route = route if dh in fa.BWD_MMA_HEAD_DIMS else "simt"
        fa.ROUTES.clear()
        fa.BWD_ROUTES.clear()
        out = fa.flash_attention_cuda(q, k, v, **kw)
        o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        up = [t.float() for t in (q, k, v)]
        want, lse_p = fa.attention_plain_lse(*up, **kw)
        mag = fa.attention_plain(up[0], up[1], up[2].abs(), **kw)
        plain = fa.attention_bwd_plain(*up, o.float(), lse_p, do.float(),
                                       **kw)
        torch.cuda.synchronize()
        label = (f"flash prefix {name} [{b}, {hq}/{hkv}, {s}, {dh}] prefix "
                 f"{prefix} {dtn}")
        if (dict(fa.ROUTES), dict(fa.BWD_ROUTES)) != ({route: 2},
                                                      {bwd_route: 2}):
            fail(f"{label}: routes {dict(fa.ROUTES)} / "
                 f"{dict(fa.BWD_ROUTES)}, expected {route} / {bwd_route}")
        tol = FLASH_TOL[dtn]
        atol, rtol = FLASH_FWD_ELEM[dtn]
        err = max(float((x.float() - want).abs().max()) for x in (out, o))
        share = max(float(((x.float() - want).abs() / (atol + rtol * mag))
                          .max()) for x in (out, o))
        lse_err = float((lse - lse_p).abs().max())
        batol, brtol = FLASH_BWD_ELEM[dtn]
        berr = max(float((g.float() - p).abs().max())
                   for g, p in zip(grads, plain))
        bshare = max(float(((g.float() - p).abs() / (batol + brtol * p.abs()))
                           .max()) for g, p in zip(grads, plain))
        if not (err <= tol and share <= 1.0 and lse_err <= 1e-4):
            fail(f"{label}: forward max err {err} (tol {tol}), element "
                 f"share {share:.3f} of {atol} + {rtol} P|V|, lse err "
                 f"{lse_err}")
        if not (berr <= tol and bshare <= 1.0):
            fail(f"{label}: backward max err {berr} (tol {tol}), element "
                 f"share {bshare:.3f} of {batol} + {brtol} |p|")
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            fail(f"{label}: a second backward call gave other bits")
        same = ""
        if prefix >= s:
            o2, lse2 = fa.flash_attention_cuda(q, k, v, causal=False,
                                               with_lse=True)
            free = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                               causal=False)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2) and all(
                    torch.equal(x, y) for x, y in zip(grads, free))):
                fail(f"{label}: not the non-causal call's bits")
            same = "; the non-causal call's bits both ways"
        print(f"{label} [forward {route}, backward {bwd_route}]: forward "
              f"max err {err:.3e}, worst element {share:.3f} of {atol:g} + "
              f"{rtol:g} P|V|, lse err {lse_err:.1e}; backward max err "
              f"{berr:.3e}, worst element {bshare:.3f} of {batol:g} + "
              f"{brtol:g} |p|, two calls bit for bit{same}")
        if name in PG_FLASH:
            errs[f"paligemma_{name}"] = max(err, lse_err)
            errs[f"bwd_paligemma_{name}"] = berr
        del q, k, v, do, out, o, lse, grads, again, up, want, mag, plain
    return errs


WKV_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _rel_err(a, b):
    """max |a - b| / max(1, max |b|): the error against the plain version
    in units of its largest value."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(1.0,
                                                    float(b.abs().max()))


def check_wkv6(torch, rw, dev):
    """WKV6 forward and backward kernels against the plain version's
    forward and autograd.  Tolerance relative to the largest value: 1e-4
    in f32 (sums in another order over up to 512 steps); 1e-2 in bf16,
    whose r, k, v, out and dr, dk, dv are rounded to bf16 (step 2^-8).
    rwkv6-3b serving's calls from a state: a decode step (S = 1) and S =
    10, on the route ``rwkv6.route`` names (bf16 at dh 64: "chunked").
    Returns the max abs errors of out and of the gradients at the
    training shape in bf16, and of out at the decode step's."""
    gen = torch.Generator(device=dev).manual_seed(6)
    # (shape [B, S, H, dh], dtype, strong decay, initial state, r based 2
    # bytes off 16); bf16 at dh 64 with aligned bases takes the chunked
    # route, the rest (bf16 at dh 32 or misaligned too) the SIMT kernels
    cases = [(WKV_SHAPE, torch.bfloat16, False, False, False),
             (WKV_SHAPE, torch.float32, False, False, False),
             ((2, 96, 4, 64), torch.float32, False, False, False),
             ((2, 96, 4, 64), torch.bfloat16, False, False, False),
             ((2, 96, 4, 64), torch.bfloat16, False, False, True),
             ((2, 128, 3, 32), torch.float32, True, False, False),
             ((2, 128, 3, 32), torch.bfloat16, True, False, False),
             ((1, 70, 2, 16), torch.float32, False, True, False),
             ((2, 64, 3, 64), torch.float32, True, True, False),
             ((2, 64, 3, 64), torch.bfloat16, True, True, False),
             ((1, 130, 3, 64), torch.bfloat16, False, True, False),
             (RS_DECODE, torch.bfloat16, False, True, False),
             (RS_DECODE, torch.float32, False, True, False),
             ((BATCH, 10, 40, 64), torch.bfloat16, False, True, False),
             ((BATCH, 10, 40, 64), torch.float32, False, True, False)]
    main = decode = None
    for shape, dt, strong, with_s0, misaligned in cases:
        b, s, h, dh = shape
        rnd = lambda *sh: torch.randn(sh, generator=gen, device=dev)
        r, k, v = (rnd(*shape).to(dt) for _ in range(3))
        if misaligned:
            buf = torch.empty(r.numel() + 1, dtype=dt, device=dev)
            r = buf[1:].view(shape).copy_(r)
        # the reference's decay draws: w = exp(-exp(U(lo, 0.5)))
        lo = -3.0 if strong else -6.0
        logw = -torch.exp(torch.rand(shape, generator=gen, device=dev)
                          * (0.5 - lo) + lo)
        u = rnd(h, dh) * 0.2
        s0 = rnd(b, h, dh, dh) * 0.1 if with_s0 else None
        rw.ROUTES.clear()
        out, s_t = rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)
        dout = rnd(*shape).to(dt)
        ds_t = rnd(b, h, dh, dh) if with_s0 else None
        grads = rw.wkv6_bwd_cuda(r, k, v, logw, u, s0, dout, ds_t)
        how = "chunked" if dt == torch.bfloat16 and dh == 64 \
            and not misaligned else "simt"
        if rw.route(dt, dh, [r.data_ptr()]) != how:
            fail(f"wkv6 {shape} {dt}: rwkv6.route disagrees with {how}")
        if dict(rw.ROUTES) != {f"wkv6:{how}": 1, f"wkv6_bwd:{how}": 1}:
            fail(f"wkv6 {shape} {dt}: routes {dict(rw.ROUTES)}, expected "
                 f"{how}")
        ins = [t.detach().clone().requires_grad_(True)
               for t in (r, k, v, logw, u)]
        s0p = s0.detach().clone().requires_grad_(True) if with_s0 else None
        op, sp = rw.wkv6_plain(*ins, s0p)
        loss = (op.float() * dout.float()).sum()
        if with_s0:
            loss = loss + (sp * ds_t).sum()
        plain = torch.autograd.grad(loss, ins + ([s0p] if with_s0 else []))
        torch.cuda.synchronize()
        tol = WKV_TOL[str(dt).split(".")[-1]]
        errs = {"out": _rel_err(out, op), "state": _rel_err(s_t, sp)}
        for name, g, gp in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"),
                               grads, plain):
            errs[name] = _rel_err(g, gp)
        name = (f"wkv6 [{how}] {shape} {dt}"
                f"{' strong decay' if strong else ''}"
                f"{' s0 given' if with_s0 else ''}"
                f"{' r misaligned' if misaligned else ''}")
        bad = {n: e for n, e in errs.items() if not e <= tol}
        if bad:
            fail(f"{name}: relative errors {bad} > {tol}")
        print(f"{name}: forward and backward within {tol} of plain "
              f"(max rel {max(errs.values()):.2e}: "
              + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()) + ")")
        if shape == WKV_SHAPE and dt == torch.bfloat16 and not misaligned:
            main = (float((out.float() - op.detach().float()).abs().max()),
                    max(float((g.float() - gp.float()).abs().max())
                        for g, gp in zip(grads, plain)))
        if shape == RS_DECODE and dt == torch.bfloat16:
            decode = float((out.float() - op.detach().float()).abs().max())
    check_wkv6_strong_decay(torch, rw, dev, gen)
    return main + (decode,)


def check_wkv6_strong_decay(torch, rw, dev, gen):
    """The chunked route at constant log w = -5 and -20, where the
    reference's single-level chunked form (and so ``wkv6_plain``) overflows
    (ROADMAP Queue 3, fault 7): [2, 130, 3, 64] bf16 with s0 and ds_T,
    against ``wkv6_scan`` and its autograd; every output finite and within
    1e-2 of the largest value."""
    shape, tol = (2, 130, 3, 64), WKV_TOL["bfloat16"]
    b, s, h, dh = shape
    for log_w in (-5.0, -20.0):
        rnd = lambda *sh: torch.randn(sh, generator=gen, device=dev)
        r, k, v = (rnd(*shape).to(torch.bfloat16) for _ in range(3))
        logw = torch.full(shape, log_w, device=dev)
        u, s0 = rnd(h, dh) * 0.2, rnd(b, h, dh, dh) * 0.1
        dout, ds_t = rnd(*shape).to(torch.bfloat16), rnd(b, h, dh, dh)
        rw.ROUTES.clear()
        out, s_t = rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)
        grads = rw.wkv6_bwd_cuda(r, k, v, logw, u, s0, dout, ds_t)
        if dict(rw.ROUTES) != {"wkv6:chunked": 1, "wkv6_bwd:chunked": 1}:
            fail(f"wkv6 log w {log_w}: routes {dict(rw.ROUTES)}")
        ins = [t.detach().clone().requires_grad_(True)
               for t in (r, k, v, logw, u, s0)]
        op, sp = rw.wkv6_scan(*ins[:3], ins[3].exp(), ins[4], ins[5])
        loss = (op.float() * dout.float()).sum() + (sp * ds_t).sum()
        plain = torch.autograd.grad(loss, ins)
        torch.cuda.synchronize()
        got = [out, s_t, *grads]
        if not all(bool(torch.isfinite(t).all()) for t in got):
            fail(f"wkv6 log w {log_w}: a non-finite output")
        errs = {"out": _rel_err(out, op), "state": _rel_err(s_t, sp)}
        for name, g, gp in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"),
                               grads, plain):
            errs[name] = _rel_err(g, gp)
        bad = {n: e for n, e in errs.items() if not e <= tol}
        if bad:
            fail(f"wkv6 log w {log_w}: relative errors {bad} > {tol}")
        print(f"wkv6 [chunked] {shape} bf16 constant log w {log_w} s0 "
              f"given: finite, within {tol} of wkv6_scan (max rel "
              f"{max(errs.values()):.2e}: "
              + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()) + ")")


def check_small_training(torch, ops, dev):
    """One training step of small f32 RWKV, qwen, granite-moe and
    paligemma models (the 2-stage, 2-micro-batch pipeline; paligemma's
    8 patches before 40 tokens, the int8 hop only) and of the small
    recurrentgemma
    (k 2 by accumulation: a mixed stack does not pipeline) on the card
    against the same step on the CPU, the pipeline's hop raw and
    int8-coded (the codec is bit-exact on both devices, so the coded hop's
    backward on the card is held here too); on the card the step must
    launch exactly its model's forward and backward kernels (WKV6, flash,
    the grouped matmul or the RG-LRU scan; 2 blocks x 2 micro-batches: 8
    forwards, as each block's forward runs again under its activation
    checkpoint, and 4 backwards; granite's blocks three grouped products
    each).  SGD, so the updated parameters are linear in the gradients
    (Adam's first step divides by |g| and turns rounding noise into sign
    flips)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.parallel.pipeline import PipelineSpec
    from repro_torch.parallel.steps import make_lm_train_step
    from repro_torch.training.optim import sgd
    from repro_torch.utils.trees import tree_leaves, tree_map
    flash = {"flash_attention": 8, "flash_attention_bwd": 4}
    for arch, kernels, wires in (
            (T_ARCH, {"wkv6": 8, "wkv6_bwd": 4}, ("none", "int8")),
            (ARCH, flash, ("none", "int8")),
            (GR_ARCH, {**flash, "moe_gmm": 24, "moe_gmm_bwd": 12},
             ("none", "int8")),
            (RG_ARCH, {"rglru_scan": 8, "rglru_scan_bwd": 4,
                       "flash_attention": 4, "flash_attention_bwd": 2},
             ("k 2",)),
            (PG_ARCH, flash, ("int8",))):
        cfg = get_arch(arch).smoke
        params = LM(cfg, "cpu").init(torch.Generator().manual_seed(SEED),
                                     master=True)
        gen = torch.Generator().manual_seed(7)
        batch = {n: torch.randint(0, cfg.vocab, (4, 40), generator=gen)
                 for n in ("tokens", "labels")}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.randn(
                (4, cfg.num_patches, cfg.d_model), generator=gen)
        for wire in wires:
            kw = dict(microbatches=2) if wire == "k 2" else dict(
                pipeline=PipelineSpec(num_stages=2, microbatches=2,
                                      wire_dtype=wire))
            out = {}
            for where in ("cpu", dev):
                model = LM(cfg, where)
                opt = sgd(0.1, momentum=0.9)
                p = tree_map(lambda t: t.detach().clone().to(where), params)
                state = {"params": p, "opt_state": opt.init(p), "step": 0}
                step = make_lm_train_step(model, opt, **kw)
                ops.reset_launches()
                state, mets = step(state, {n: t.to(where)
                                           for n, t in batch.items()})
                out[str(where)] = (float(mets["loss"]), state["params"])
            launches = {k: ops.LAUNCHES.get(k, 0) for k in kernels}
            (lc, pc), (lg, pg) = out["cpu"], out[str(dev)]
            perr = max(float((a.detach().cpu() - b.detach()).abs().max())
                       for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
            if not (abs(lg - lc) <= 1e-4 * abs(lc) and perr <= 1e-4):
                fail(f"small {arch} training step ({wire} hop), card vs "
                     f"CPU: loss {lg} vs {lc}, max parameter diff {perr}")
            if launches != kernels:
                fail(f"small {arch} training step ({wire} hop): launches "
                     f"{launches}, expected {kernels}")
            print(f"small f32 {arch} training step ({wire} hop), card vs "
                  f"CPU: loss {lg:.6f} vs {lc:.6f}, max updated-parameter "
                  f"diff {perr:.2e} (tol 1e-4); launches {launches}")
    check_small_topk_step(torch, ops, dev)


@contextlib.contextmanager
def hop_decisions(wire, runs):
    """While the block runs, append to ``runs[-1]`` (a dict the caller
    appends per run) each forward hop's int8 payload, in call order,
    under "forward", and each top-k hop's kept indices, by EF slot, under
    "topk": the codec's decisions, to be compared between a card run and
    a CPU run."""
    dense, encode = wire.encode, wire.topk_encode
    backward = wire.CodedHopEF.backward
    slot = [None]

    def enc_dense(x, w):
        q, sc = dense(x, w)
        runs[-1].setdefault("forward", []).append(q.cpu())
        return q, sc

    def bwd(ctx, g):
        slot[0] = ctx.ef.storage_offset() // ctx.ef.numel()
        return backward(ctx, g)

    def enc(x, w):
        q, idx, s = encode(x, w)
        runs[-1].setdefault("topk", {})[slot[0]] = idx.cpu()
        return q, idx, s
    wire.encode, wire.topk_encode = enc_dense, enc
    wire.CodedHopEF.backward = staticmethod(bwd)
    try:
        yield
    finally:
        wire.encode, wire.topk_encode = dense, encode
        wire.CodedHopEF.backward = staticmethod(backward)


def check_small_topk_step(torch, ops, dev):
    """The interleaved top-k step with gradient compression on the card
    against the CPU: the f32 SMOKE qwen widened to 4 layers (S 2 x v 2
    chunks of one layer), k 2, ``TK_WIRE``, ``compress=True``, one SGD
    step.  Loss at 1e-4; ``error_fb``'s int8 rounding flips (the two
    residuals at half a quantum on either side) are counted and printed,
    any other difference past 1e-6 fails; parameters at 1e-4 once each
    flip's step (SGD: lr x the residuals' difference) is taken out; the
    EF buffer live in the same slots, the schedule's, and its elements
    more than 1e-4 of its largest apart counted and printed, beside the
    codec decisions the two devices took differently on near-ties
    (``hop_decisions``: forward hop payload elements a quantum apart,
    top-k picks).  Exactly the path's
    launches: 16 flash forwards, 8 backwards, 6 hop encodes and decodes
    and one more of each a parameter leaf."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.parallel import wire
    from repro_torch.parallel.pipeline import PipelineSpec, wire_ef_zeros
    from repro_torch.parallel.steps import make_lm_train_step
    from repro_torch.training.compress import init_error_fb
    from repro_torch.training.optim import sgd
    from repro_torch.utils.trees import tree_leaves, tree_map
    cfg = dataclasses.replace(get_arch(ARCH).smoke, num_layers=4)
    spec = PipelineSpec(2, 2, virtual_stages=TK_V, wire_dtype=TK_WIRE)
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(SEED),
                                 master=True)
    gen = torch.Generator().manual_seed(7)
    batch = {n: torch.randint(0, cfg.vocab, (4, 40), generator=gen)
             for n in ("tokens", "labels")}
    out, runs = {}, []
    for where in ("cpu", dev):
        opt = sgd(0.1, momentum=0.9)
        p = tree_map(lambda t: t.detach().clone().to(where), params)
        state = {"params": p, "opt_state": opt.init(p), "step": 0,
                 "wire_ef": wire_ef_zeros(cfg, spec, 4, 40, where),
                 "error_fb": init_error_fb(p)}
        step = make_lm_train_step(LM(cfg, where), opt, pipeline=spec,
                                  compress=True)
        ops.reset_launches()
        runs.append({})
        with hop_decisions(wire, runs):
            state, mets = step(state, {n: t.to(where)
                                       for n, t in batch.items()})
        out[str(where)] = (float(mets["loss"]), state, dict(ops.LAUNCHES))
    cpu_run, card_run = runs
    fwd_flips = sum(int((a.int() != b.int()).sum()) for a, b in zip(
        cpu_run["forward"], card_run["forward"], strict=True))
    topk_flips = sum(int((cpu_run["topk"][k].sort(-1).values
                          != card_run["topk"][k].sort(-1).values).sum())
                     for k in cpu_run["topk"])
    (lc, sc, _), (lg, sg, launches) = out["cpu"], out[str(dev)]
    n_leaves = len(tree_leaves(params))
    want = {"flash_attention": 16, "flash_attention_bwd": 8,
            "wire_encode": 6 + n_leaves, "wire_decode": 6 + n_leaves}
    name = f"small f32 {ARCH} (4 layers) S 2 v 2 {TK_WIRE} compressed step"
    if launches != want:
        fail(f"{name}: launches {launches} != {want}")
    # an int8 rounding flip of a compressed gradient moves its parameter
    # by lr x one quantum: lr times the two residuals' difference
    flips, fb_err, perr, raw = 0, 0.0, 0.0, 0.0
    for a, b, ea, eb in zip(tree_leaves(sg["params"]),
                            tree_leaves(sc["params"]),
                            tree_leaves(sg["error_fb"]),
                            tree_leaves(sc["error_fb"])):
        a, b, ea = a.detach().cpu(), b.detach(), ea.cpu()
        off = (ea - eb).abs() > 1e-6
        flips += int(off.sum())
        if off.any() and float((ea + eb)[off].abs().max()) > 1e-6:
            fail(f"{name}: error_fb differs beyond an int8 rounding flip")
        fb_err = max(fb_err, float((ea - eb).abs().masked_fill(off, 0).max()))
        raw = max(raw, float((a - b).abs().max()))
        perr = max(perr, float(((a - b) - 0.1 * (ea - eb)).abs().max()))
    if not (abs(lg - lc) <= 1e-4 * abs(lc) and perr <= 1e-4):
        fail(f"{name}, card vs CPU: loss {lg} vs {lc}, max parameter diff "
             f"{raw}, {perr} past the int8 flips' steps")
    efc, efg = sc["wire_ef"], sg["wire_ef"].cpu()
    live_c, _ = check_ef_buffer(torch, f"{name} (CPU)", efc, spec)
    live_g, _ = check_ef_buffer(torch, f"{name} (card)", efg, spec)
    ef_tol = 1e-4 * float(efc.abs().max())
    ef_apart = int(((efc - efg).abs() > ef_tol).sum())
    print(f"{name}, card vs CPU: loss {lg:.6f} vs {lc:.6f}, max "
          f"updated-parameter diff {raw:.2e}, {perr:.2e} past the int8 "
          f"flips' steps (tol 1e-4); EF buffer live in "
          f"{live_g} slots on both, max diff "
          f"{float((efc - efg).abs().max()):.2e} of largest "
          f"{float(efc.abs().max()):.2e}, {ef_apart} elements past 1e-4 of "
          f"it; decisions that differ on near-ties: {fwd_flips} forward hop "
          f"elements (int8 roundings), {topk_flips} top-k picks; error_fb: "
          f"{flips} int8 rounding flips, the rest within {fb_err:.2e}; "
          f"launches {launches}")


@contextlib.contextmanager
def stream_decisions(torch, replay):
    """While the block runs, record (``replay`` None) or replay (``replay``
    the dict a recording run filled) the streaming runtime's codec
    decisions, keyed by (direction, client, round): each ACT frame's
    dense payload and each GRAD frame's top-k picks and payload.  A
    replaying run keeps its own arithmetic (scales, the EF residual from
    the replayed picks) and counts the decisions it would have taken
    otherwise.  Yields (record, flips)."""
    from repro_torch.parallel import wire
    from repro_torch.runtime.bs import BSDispatcher
    from repro_torch.runtime.ue import UEClient
    from repro_torch.training.compress import quantize_blocks
    record = {} if replay is None else replay
    flips = {"payload elements": 0, "top-k picks": 0}
    key = [None]
    act_frame, grad_frame = UEClient._act_frame, BSDispatcher._grad_frame
    dense, topk = wire.encode, wire.topk_encode

    def act(self, acts, labels, step, dl):
        key[0] = ("up", self.client_id, step)
        return act_frame(self, acts, labels, step, dl)

    def grad(self, cid, step, g, loss):
        key[0] = ("down", cid, step)
        return grad_frame(self, cid, step, g, loss)

    def enc(x, w):
        q, sc = dense(x, w)
        if replay is None:
            record[key[0]] = q.cpu()
            return q, sc
        want = record.pop(key[0])
        flips["payload elements"] += int(
            (want.float() != q.cpu().float()).sum())
        return want.to(q.device), sc

    def enc_topk(x, w):
        q, idx, sc = topk(x, w)
        if replay is None:
            record[key[0]] = (q.cpu(), idx.cpu())
            return q, idx, sc
        want_q, want_idx = record.pop(key[0])
        flips["top-k picks"] += int((want_idx.sort(-1).values
                                     != idx.cpu().sort(-1).values).sum())
        idx = want_idx.to(x.device)
        q, sc = quantize_blocks(
            torch.gather(x.to(torch.float32), -1, idx.long()),
            wire.parse_wire_dtype(w)[0])
        flips["payload elements"] += int(
            (want_q.float() != q.cpu().float()).sum())
        return want_q.to(x.device), idx, sc

    UEClient._act_frame, BSDispatcher._grad_frame = act, grad
    wire.encode, wire.topk_encode = enc, enc_topk
    try:
        yield record, flips
    finally:
        UEClient._act_frame, BSDispatcher._grad_frame = act_frame, grad_frame
        wire.encode, wire.topk_encode = dense, topk


def flat_leaves(tree, prefix="") -> dict:
    """A parameter tree's leaves by dotted path (a tuple's items by
    index)."""
    if isinstance(tree, (dict, tuple, list)):
        out = {}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            out.update(flat_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree.detach()}


def check_small_streaming(torch, ops, dev):
    """The streaming runtime on the card against the same run on the CPU:
    the f32 SMOKE qwen widened to 4 layers, cut 2, 3 clients of 2
    sequences of 32, 3 rounds, AdamW 1e-3, for 'none' and ``TK_WIRE``,
    from one set of weights.  The CPU run replays the card's codec
    decisions (``stream_decisions``), whose near-ties each device's f32
    roundings may land either side of; the flips are counted and printed.
    Losses and each client's losses within 1e-5; parameters within 1e-5
    but for one element in 10^4, those and the attention's key bias held
    to AdamW's reach (2 lr a round): AdamW divides each element's step
    by its own running size, so where that size is at the rounding
    noise's scale (the key bias: the softmax cancels any shift common to
    a row's keys, and only RoPE's rotation of it reaches the loss) or the
    first moment nearly cancels, each device's f32 roundings become
    steps of their own (ROADMAP Queue 3, fault 13).  The card run
    launches exactly its flash and codec kernels."""
    import asyncio
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.runtime.driver import run_streaming
    from repro_torch.utils.trees import tree_map
    cfg = dataclasses.replace(get_arch(ARCH).smoke, num_layers=4)
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(SEED))
    n, rounds, lr = 3, 3, 1e-3
    for wire in ("none", TK_WIRE):
        out, record = {}, None
        for where in (dev, "cpu"):       # the CPU replays the card's hops
            ops.reset_launches()
            with stream_decisions(torch, record) as (record, flips):
                res = asyncio.run(run_streaming(
                    cfg, cut=2, n_clients=n, steps=rounds,
                    batch_per_client=2, seq=32, wire_dtype=wire, lr=lr,
                    params=tree_map(lambda t: t.clone().to(where), params),
                    device=where))
            out[str(where)] = (res, dict(ops.LAUNCHES))
        (rg, launches), (rc, _) = out[str(dev)], out["cpu"]
        coded = wire != "none"
        want = {"flash_attention": (2 + 4 + 4) * n * rounds,
                "flash_attention_bwd": 4 * n * rounds}
        if coded:
            want.update(wire_encode=n * rounds, wire_decode=n * rounds)
        if launches != want:
            fail(f"small streaming {wire}: launches {launches} != {want}")
        name = f"small f32 {ARCH} (4 layers) streaming, 3 UEs, {wire}"
        lerr = max(abs(a - b) for a, b in zip(rg["losses"], rc["losses"]))
        lerr = max([lerr] + [abs(a - b) for c in rc["client_losses"]
                             for a, b in zip(rg["client_losses"][c],
                                             rc["client_losses"][c])])
        bound = 2 * rounds * lr          # AdamW moves an element <= ~lr
        got = [{h: flat_leaves(r["params"][h]) for h in ("ue", "bs")}
               for r in (rg, rc)]
        n_el, outliers, worst, kb_err, per_leaf = 0, 0, (0.0, ""), 0.0, {}
        for half in ("ue", "bs"):
            for path, a in got[0][half].items():
                d = (a.cpu() - got[1][half][path]).abs()
                n_el += d.numel()
                if path == "blocks.attn.kb":
                    kb_err = max(kb_err, float(d.max()))
                    continue
                off = int((d > 1e-5).sum())
                outliers += off
                worst = max(worst, (float(d.max()), f"{half}.{path}"))
                if off:
                    per_leaf[f"{half}.{path}"] = (off, d.numel(),
                                                  float(d.max()))
        ok = (lerr <= 1e-5 and outliers <= n_el // 10 ** 4
              and worst[0] <= bound and kb_err <= bound)
        print(f"{name}, card vs CPU: losses within {lerr:.2e} (tol 1e-5); "
              f"parameters: {outliers} of {n_el} elements past 1e-5 (at "
              f"most {n_el // 10 ** 4}: one in 10^4), by leaf {per_leaf}, "
              f"the largest {worst[0]:.2e} ({worst[1]}), the key biases "
              f"{kb_err:.2e} (both within {bound:g}, AdamW's reach); "
              f"decisions the CPU would have taken otherwise: {flips}; "
              f"launches {launches}")
        if not ok:
            fail(f"{name}: card and CPU apart past the bounds above")


# ------------------------------------------------------------------ phase 4


@contextlib.contextmanager
def codec_calls(wc):
    """Count each launching call of the codec kernels' wrappers while the
    block runs, under (kernel, rows, d, activation dtype name, wire): the
    codec's launches split by shape.  Yields the Counter."""
    calls = collections.Counter()
    enc, dec = wc.encode_cuda, wc.decode_cuda

    def name(dtype):
        return str(dtype).split(".")[-1]

    def encode(x, wire_dtype):
        if x.numel():
            calls[("wire_encode", x.numel() // x.shape[-1], x.shape[-1],
                   name(x.dtype), wire_dtype)] += 1
        return enc(x, wire_dtype)

    def decode(q, scale, out_dtype):
        if q.numel():
            d = q.shape[-2] * q.shape[-1]
            calls[("wire_decode", q.numel() // d, d, name(out_dtype),
                   "int8" if name(q.dtype) == "int8" else "fp8")] += 1
        return dec(q, scale, out_dtype)

    wc.encode_cuda, wc.decode_cuda = encode, decode
    try:
        yield calls
    finally:
        wc.encode_cuda, wc.decode_cuda = enc, dec


@contextlib.contextmanager
def flash_calls(fa):
    """Count each call of the flash wrappers while the block runs, under
    (kernel, B, Hq, Sq, Skv, dh, causal, dtype, prefix_len): the flash
    launches split by shape and mask.  Yields the Counter."""
    calls = collections.Counter()
    fwd, bwd = fa.flash_attention_cuda, fa.flash_attention_bwd_cuda

    def key(kernel, q, k, causal, kw):
        return (kernel, *q.shape[:3], k.shape[2], q.shape[3], bool(causal),
                str(q.dtype).split(".")[-1], int(kw.get("prefix_len", 0)))

    def forward(q, k, v, *, causal=True, **kw):
        calls[key("flash_attention", q, k, causal, kw)] += 1
        return fwd(q, k, v, causal=causal, **kw)

    def backward(q, k, v, o, lse, do, *, causal=True, **kw):
        calls[key("flash_attention_bwd", q, k, causal, kw)] += 1
        return bwd(q, k, v, o, lse, do, causal=causal, **kw)

    fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = forward, backward
    try:
        yield calls
    finally:
        fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = fwd, bwd


def check_codec_calls(wc, where, launches, calls, routes):
    """The shape counts cover every codec launch, and every decode took
    the vector route (d_model 2560: b = 256)."""
    for kernel in ("wire_encode", "wire_decode"):
        n = sum(v for k, v in calls.items() if k[0] == kernel)
        if n != launches.get(kernel, 0):
            fail(f"{where}: {n} {kernel} calls recorded by shape, "
                 f"{launches.get(kernel, 0)} launches")
    if routes != {"warp256": launches.get("wire_decode", 0)}:
        fail(f"{where}: decode routes {routes}, expected every one of "
             f"{launches.get('wire_decode', 0)} on warp256")
    print(f"{where}: codec launches by (kernel, rows, d, dtype, wire): "
          + "; ".join(f"{k}: {v}" for k, v in sorted(calls.items()))
          + f"; decode routes {routes}")


def run_main_path(torch, ops, serve, wc):
    base = ["--arch", ARCH, "--size", "full", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--seed", str(SEED)]
    from repro_torch.kernels import flash_attention as fa
    ops.reset_launches()
    fa.ROUTES.clear()
    wc.ROUTES.clear()
    with codec_calls(wc) as calls:
        static = serve.main(base)
        split = {w: serve.main(base + ["--split-cut", str(CUT),
                                       "--wire-dtype", w])
                 for w in ("none", "int8", "fp8")}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_codec_calls(wc, "serving path", launches, calls, dict(wc.ROUTES))
    toks = static["tokens"]
    if tuple(toks.shape) != (BATCH, GEN) or int(toks.min()) < 0:
        fail(f"static tokens {tuple(toks.shape)} out of range")
    for w, res in split.items():
        if res["frames"] != GEN + 1:
            fail(f"split {w}: {res['frames']} frames != gen + 1")
        if not res["rel"] <= 0.01:
            fail(f"split {w}: measured {res['measured_payload_bytes']} B vs "
                 f"billed {res['billed_payload_bytes']} B")
        if tuple(res["tokens"].shape) != (BATCH, GEN):
            fail(f"split {w}: tokens {tuple(res['tokens'].shape)}")
    if not torch.equal(split["none"]["tokens"], toks):
        fail("split 'none' tokens differ from the static path's")
    print(f"split none tokens == static tokens ({BATCH}x{GEN})")
    for name in SERVING_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    if dict(fa.ROUTES) != {"mma": launches["flash_attention"]}:
        fail(f"serving flash routes {dict(fa.ROUTES)}: not all on mma")
    print(f"serving-path launches: {json.dumps(launches, sort_keys=True)}; "
          f"flash routes {dict(fa.ROUTES)}")
    return static, split, launches, calls


def run_hybrid_serving(torch, ops, serve):
    """recurrentgemma-2b static serving at full width through the serving
    CLI's entry point; the launch counts are read around that one run.
    Then --split-cut on it must raise ValueError (as the reference's
    SplitDecode does for a heterogeneous stack)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    argv = ["--arch", RG_ARCH, "--size", "full", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--seed",
            str(SEED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    fa.ROUTES.clear()
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = res["tokens"]
    vocab = get_arch(RG_ARCH).full.vocab
    if tuple(toks.shape) != (BATCH, GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= vocab:
        fail(f"{RG_ARCH} tokens {tuple(toks.shape)} out of range")
    if launches != RG_LAUNCHES:
        fail(f"{RG_ARCH} serving launches {launches} != {RG_LAUNCHES}")
    if dict(fa.ROUTES) != {"mma": RG_LAUNCHES["flash_attention"]}:
        fail(f"{RG_ARCH} flash routes {dict(fa.ROUTES)}: not all on mma")
    print(f"{RG_ARCH} serving-path launches: "
          f"{json.dumps(launches, sort_keys=True)}")
    try:
        serve.main(argv + ["--split-cut", "13"])
    except ValueError as e:
        print(f"{RG_ARCH} --split-cut 13: ValueError ({e})")
    else:
        fail(f"{RG_ARCH} --split-cut ran on a heterogeneous stack")
    torch.cuda.empty_cache()
    return res, launches, peak_gb


def run_moe_serving(torch, ops, serve):
    """granite-moe-3b-a800m static serving at full width through the
    serving CLI's entry point; the launch counts are read around that one
    run (the prefill's from the CLI's own count).  Then --split-cut on it
    must raise ValueError (tied embeddings, as the reference's
    SplitDecode refuses)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    argv = ["--arch", GR_ARCH, "--size", "full", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--seed",
            str(SEED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    fa.ROUTES.clear()
    mg.ROUTES.clear()
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = res["tokens"]
    vocab = get_arch(GR_ARCH).full.vocab
    if tuple(toks.shape) != (BATCH, GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= vocab:
        fail(f"{GR_ARCH} tokens {tuple(toks.shape)} out of range")
    if res["prefill_launches"] != GR_PREFILL:
        fail(f"{GR_ARCH} prefill launches {res['prefill_launches']} != "
             f"{GR_PREFILL}")
    if launches != GR_RUN:
        fail(f"{GR_ARCH} serving launches {launches} != {GR_RUN}")
    # prefill (capacity 512) on the 128-row tiles, decode (capacity 8) on
    # the small-C variant, flash on the tensor cores
    routes = {"wgmma": GR_PREFILL["moe_gmm"],
              "wgmma_small_c": GR_RUN["moe_gmm"] - GR_PREFILL["moe_gmm"]}
    if dict(mg.ROUTES) != routes:
        fail(f"{GR_ARCH} moe_gmm routes {dict(mg.ROUTES)} != {routes}")
    if dict(fa.ROUTES) != {"mma": GR_RUN["flash_attention"]}:
        fail(f"{GR_ARCH} flash routes {dict(fa.ROUTES)}: not all on mma")
    print(f"{GR_ARCH} prefill launches: "
          f"{json.dumps(res['prefill_launches'], sort_keys=True)}; whole "
          f"run: {json.dumps(launches, sort_keys=True)}; moe_gmm routes "
          f"{json.dumps(dict(mg.ROUTES), sort_keys=True)}, flash routes "
          f"{json.dumps(dict(fa.ROUTES))}")
    try:
        serve.main(argv + ["--split-cut", "16"])
    except ValueError as e:
        print(f"{GR_ARCH} --split-cut 16: ValueError ({e})")
    else:
        fail(f"{GR_ARCH} --split-cut ran with tied embeddings")
    torch.cuda.empty_cache()
    return res, launches, peak_gb


def _engine_reqs(vocab, specs, rid0=0):
    import numpy as np

    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(11)
    return [Request(rid=rid0 + i, prompt=rng.integers(0, vocab, p),
                    max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def check_small_engines(torch, dev):
    """The continuous-batching engine on small f32 models, its decode step
    captured as a CUDA graph: dense qwen SMOKE, recurrentgemma SMOKE (the
    RG-LRU scan and windowed flash in prefill, the ring in decode),
    granite-moe SMOKE at 16 slots (5 experts, top 2: the batched step's
    naive capacity would drop tokens) and rwkv6 SMOKE (the WKV6 kernel
    from each lane's state).  Greedy tokens equal the card's
    solo decodes and the CPU engine's exactly; tokens sampled at T = 0.7
    are the same at 1 and 3 slots and equal the card's solo decodes; a
    replayed step leaves an inactive slot's arena bytes as they were; a
    request with prompt + gen == cache_len runs."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.serving import kv
    from repro_torch.serving.engine import ServingEngine, solo_decode
    from repro_torch.utils.trees import tree_leaves, tree_map
    for arch, slots, specs in (
            (ARCH, 2, [(5, 4), (5, 2), (7, 6), (5, 3), (7, 5)]),
            (RG_ARCH, 2, [(12, 6), (5, 3), (12, 4), (9, 8)]),
            (GR_ARCH, 16, [(4, 3)] * 16),
            (T_ARCH, 2, [(5, 4), (5, 2), (7, 6), (5, 3), (7, 5)])):
        cfg = get_arch(arch).smoke
        cpu, card = LM(cfg, "cpu"), LM(cfg, dev)
        params = cpu.init(torch.Generator().manual_seed(SEED))
        pcard = tree_map(lambda t: t.to(dev), params)
        want = ServingEngine(cpu, params, slots=slots, cache_len=20).run(
            _engine_reqs(cfg.vocab, specs))
        eng = ServingEngine(card, pcard, slots=slots, cache_len=20,
                            graph=True)
        got = eng.run(_engine_reqs(cfg.vocab, specs))
        for r in _engine_reqs(cfg.vocab, specs):
            solo = solo_decode(card, pcard, r.prompt, r.max_new_tokens,
                               cache_len=20)
            if not (np.array_equal(got[r.rid], want[r.rid])
                    and np.array_equal(got[r.rid], solo)):
                fail(f"small {arch} engine (graph) on the card: request "
                     f"{r.rid} tokens {got[r.rid].tolist()}, CPU engine "
                     f"{want[r.rid].tolist()}, card solo {solo.tolist()}")
        sampled = {n: ServingEngine(card, pcard, slots=n, cache_len=20,
                                    temperature=0.7, seed=9, graph=True)
                   .run(_engine_reqs(cfg.vocab, specs[:4]))
                   for n in (1, 3)}
        for r in _engine_reqs(cfg.vocab, specs[:4]):
            solo = solo_decode(card, pcard, r.prompt, r.max_new_tokens,
                               cache_len=20, temperature=0.7, seed=9,
                               rid=r.rid)
            if not (np.array_equal(sampled[1][r.rid], solo)
                    and np.array_equal(sampled[3][r.rid], solo)):
                fail(f"small {arch} engine sampled at T 0.7: request "
                     f"{r.rid} {sampled[1][r.rid].tolist()} (1 slot), "
                     f"{sampled[3][r.rid].tolist()} (3 slots), solo "
                     f"{solo.tolist()}")
        print(f"small f32 {arch} engine, {slots} slots, step captured "
              f"({eng.capture_ms:.1f} ms): {len(got)} requests' greedy "
              f"tokens == CPU engine's == card solo decodes; sampled at "
              f"T 0.7 equal at 1 and 3 slots and to solo")
        if arch == GR_ARCH:
            continue
        # pins: a replayed step keeps an inactive slot's bytes; a request
        # whose prompt + gen == cache_len runs to its end
        pin = ServingEngine(card, pcard, slots=3, cache_len=20, graph=True)
        for r in _engine_reqs(cfg.vocab, [(5, 1), (5, 15)]):
            pin.submit(r)
        pin.step_once()
        rows = lambda s: [t.clone() for t in tree_leaves(
            kv.take_slot(pin.cache, pin.axes, s))]
        before = [rows(s) for s in (0, 2)]
        pin.step_once()
        after = [rows(s) for s in (0, 2)]
        if not all(torch.equal(a, b) for x, y in zip(before, after)
                   for a, b in zip(x, y)):
            fail(f"small {arch}: a replayed step changed an inactive slot")
        out = pin.run()
        solo = solo_decode(card, pcard, _engine_reqs(cfg.vocab, [(5, 1), (
            5, 15)])[1].prompt, 15, cache_len=20)
        if not (np.array_equal(out[1], solo) and pin.positions.max() == 20):
            fail(f"small {arch}: prompt + gen == cache_len: "
                 f"{out[1].tolist()} vs solo {solo.tolist()}")
        print(f"small f32 {arch}: a replayed step leaves the inactive "
              f"slots' bytes unchanged; prompt 5 + gen 15 == cache_len 20 "
              f"runs and equals its solo decode")


def profile_engine_step(torch, engine, name, card):
    """One decode step of a full engine (8 lanes active, nothing queued):
    4 steps on the host clock, then 4 under torch.profiler (wall, device
    busy and idle share per step), beside the card.  Device time by CUDA
    events where the trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    for r in _engine_reqs(engine.model.cfg.vocab,
                          [(PROMPT, 128)] * CB_SLOTS, rid0=1000):
        engine.submit(r)
    while len(engine.scheduler) or engine.decode_steps < 4:
        engine.step_once()
    chunks = engine.prefill_chunks
    steps = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step_once()
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step_once()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    if engine.prefill_chunks != chunks or not engine.active.all():
        fail(f"continuous {name}: the profiled steps were not pure decode")
    busy_us, rows, us = _kernel_us(prof.key_averages())
    busy = busy_us / 1e3 / steps
    how = "torch.profiler"
    if busy <= 0:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        engine.step_once()
        end.record()
        torch.cuda.synchronize()
        busy, how = start.elapsed_time(end), "CUDA events (no trace)"
    print(f"profile continuous {name} decode step (8 lanes, {how}): wall "
          f"{wall:.3f} ms/step, device busy {busy:.3f} ms/step, idle share "
          f"{1 - busy / wall:.3f}; untraced wall {untraced:.3f} ms/step "
          f"(idle share {1 - busy / untraced:.3f} against it) ({card})")
    for e in rows[:4]:
        print(f"  {us(e) / 1e3 / steps:9.3f} ms/step  "
              f"{e.count // steps:5d} calls/step  {e.key[:70]}")
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "untraced_ms": untraced, "idle_untraced": 1 - busy / untraced}


def _engine_line(name, res, stats, convoy, card):
    lat = stats["qos"]["latency"]
    print(f"continuous {name}: {res['emitted']} tokens of "
          f"{res['requests']} requests in {res['wall_s'] * 1e3:.1f} ms, "
          f"{res['tok_s']:.1f} tok/s; {stats['decode_steps']} decode steps, "
          f"{stats['prefill_chunks']} prefill chunks; engine units "
          f"{stats['engine_units']} vs convoy(batch {BATCH}) {convoy}; "
          f"occupancy {stats['occupancy_mean']:.3f}/{CB_SLOTS}; ttft p50 "
          f"{lat['p50_ttft_s'] * 1e3:.1f} ms, p99 "
          f"{lat['p99_ttft_s'] * 1e3:.1f} ms; capture "
          + (f"{stats['capture_ms']:.1f} ms" if stats["graph"] else "none")
          + f" ({card})")


def _cb_want(arch, stats):
    """The launches a continuous run must count, from its prefill chunks
    and decode steps (and the capture's eager warm-up steps, with all
    lanes inactive): flash once a layer in a bucket prefill and never in
    decode; qwen3-moe's three grouped products a layer in both; rwkv6's
    WKV6 once a layer in both."""
    from repro_torch.serving.engine import _WARMUP_STEPS
    chunks = stats["prefill_chunks"]
    steps = stats["decode_steps"] + (_WARMUP_STEPS if stats["graph"] else 0)
    if arch == QM_ARCH:
        return {"flash_attention": QM_LAYERS * chunks,
                "moe_gmm": 3 * QM_LAYERS * (chunks + steps)}
    if arch == T_ARCH:
        return {"wkv6": RS_LAYERS * (chunks + steps)}
    return {"flash_attention": Q_LAYERS * chunks}


def _check_routes(name, launches, fa, mg, rw, small_c=0):
    """Every flash launch on "mma", every WKV6 launch on "chunked", and
    moe_gmm's on "wgmma", but ``small_c`` of them (the decode steps'
    capacity 8) on "wgmma_small_c"."""
    want = {}
    if launches.get("flash_attention"):
        want["flash"] = {"mma": launches["flash_attention"]}
    if launches.get("moe_gmm"):
        want["moe_gmm"] = {k: v for k, v in (
            ("wgmma", launches["moe_gmm"] - small_c),
            ("wgmma_small_c", small_c)) if v}
    if launches.get("wkv6"):
        want["wkv6"] = {"wkv6:chunked": launches["wkv6"]}
    got = {"flash": dict(fa.ROUTES), "moe_gmm": dict(mg.ROUTES),
           "wkv6": dict(rw.ROUTES)}
    got = {k: v for k, v in got.items() if v}
    if got != want:
        fail(f"{name}: routes {got} != {want}")
    return got


def _reset_counts(ops, *counters):
    ops.reset_launches()
    for c in counters:
        c.clear()


def _free_card(torch, what):
    """Before a full-width init: what the card still holds after a
    garbage collection, printed; fails if more than QM_HELD bytes are
    still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    print(f"before {what}: {held / 1e9:.3f} GB allocated, "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    if held > QM_HELD:
        fail(f"{held / 1e9:.3f} GB still allocated before {what} (> "
             f"{QM_HELD / 1e9:.1f} GB)")


def _guard_and_init(torch, arch, dev):
    """``LM.init`` from SEED after ``_free_card``, timed and its peak
    read: (model, params, init s, peak bytes, parameter bytes)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.utils.trees import tree_leaves
    _free_card(torch, f"{arch}'s init")
    torch.cuda.reset_peak_memory_stats()
    model = LM(get_arch(arch).full, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(params)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{arch} init: {sum(t.numel() for t in leaves):,} parameters, "
          f"{nbytes / 1e9:.3f} GB, {init_s:.2f} s, peak "
          f"{peak / 1e9:.3f} GB ({(peak - nbytes) / 1e9:.3f} GB over the "
          "parameters)")
    return model, params, init_s, peak, nbytes


@contextlib.contextmanager
def route_tape(torch, moe, replay=None):
    """While the block runs, ``moe._route`` keeps on the host the expert
    ids its router picks in every decode call (at most CB_SLOTS token
    rows) in ``tape["ids"]``, and ``moe._slots`` the keep flags of every
    prefill call in ``tape["keep"]``.  ``replay`` maps a decode call's
    number (from 0) to expert ids that replace the router's own top k
    there (still recorded as its own), the gates taken from the router's
    own probabilities at them and renormalised: the engine's decisions
    replayed in a reference run.  Eager runs only: each decode call
    syncs with the host."""
    tape = {"ids": [], "keep": []}
    route, slots = moe._route, moe._slots

    def taped_route(x, router, topk):
        probs, gate, idx = route(x, router, topk)
        if x.shape[0] <= CB_SLOTS:
            n = len(tape["ids"])
            tape["ids"].append(idx.cpu())
            if replay is not None and n in replay:
                idx = replay[n].to(idx.device).reshape(idx.shape)
                gate = torch.gather(probs, -1, idx)
                gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True),
                                              1e-9)
        return probs, gate, idx

    def taped_slots(idx, n_experts, capacity):
        slot, keep = slots(idx, n_experts, capacity)
        if idx.shape[0] > CB_SLOTS:
            tape["keep"].append(keep.cpu())
        return slot, keep

    moe._route, moe._slots = taped_route, taped_slots
    try:
        yield tape
    finally:
        moe._route, moe._slots = route, slots


def bucket_solo(torch, model, params, prompts, i, forced, cache_len,
                np):
    """Teacher-forced batch-1 decode of prompt ``i`` of a prefill bucket:
    the bucket's prefill as the engine admits it (``prompts`` in its
    order), row ``i`` of its cache taken out, then one static decode step
    a token: the prefill's argmax first, then ``forced``.  -> logits [n,
    V] on the host."""
    from repro_torch.serving import kv
    from repro_torch.utils.trees import tree_map
    with torch.inference_mode():
        toks = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                               device=model.device)
        logits, state = model.prefill_with_cache(
            params, {"tokens": toks}, cache_len, torch.float32)
        axes = kv.slot_axes(model, cache_len, torch.float32)
        cache = tree_map(lambda t: t.clone(), kv.expand_slot(
            kv.take_slot(state["cache"], axes, i), axes))
        del state
        tok = torch.argmax(logits[i:i + 1], dim=-1, keepdim=True)
        pos, out = toks.shape[1], []
        for j in range(len(forced)):
            lg, cache = model.decode_step(params, tok, cache, pos)
            out.append(lg[0].cpu())
            pos += 1
            tok = torch.full((1, 1), int(forced[j]), dtype=torch.int64,
                             device=model.device)
        return torch.stack(out)


def _lane_ids(steps, ids, rid, layers):
    """One request's expert ids in an engine run: for each decode step it
    was active in, the ids of its lane at every layer [layers, K]."""
    out = []
    for lanes, start in steps:
        for slot, r in lanes.items():
            if r == rid:
                out.append([ids[start + l][slot] for l in range(layers)])
    return out


def _flips(a, b):
    """(token, layer) pairs whose expert-id sets differ, and the ids of
    ``a`` not in ``b``, over two runs' [tokens][layers] ids."""
    pairs = ids = 0
    for ta, tb in zip(a, b, strict=True):
        for la, lb in zip(ta, tb, strict=True):
            sa, sb = set(la.reshape(-1).tolist()), set(lb.reshape(-1).tolist())
            pairs += sa != sb
            ids += len(sa - sb)
    return pairs, ids


def moe_references(torch, moe, model, params, req, out, eng_ids, chunk,
                   np, solo):
    """qwen3-moe's teacher-forced references of one request against the
    engine (``out``: its emitted tokens, ``eng_ids``: its lanes' expert
    ids, ``chunk``: the requests of the prefill bucket it was admitted
    in, itself among them):
      * the bucket reference (``bucket_solo``) with the engine's expert
        choices replayed at every (token, layer), and the count of those
        where its own router picks another set (the flips);
      * with ``solo``, the request's solo decode (``solo_decode``: its
        own prefill, its own routing), whose capacity keeps or drops other
        assignments of its prompt than the bucket's (ROADMAP Queue 3,
        fault 18).
    -> dict of the logits and the counts."""
    from repro_torch.serving.engine import solo_decode
    i = [r.rid for r in chunk].index(req.rid)
    prompts = [r.prompt for r in chunk]
    replay = {j * QM_LAYERS + l: eng_ids[j][l]
              for j in range(len(out)) for l in range(QM_LAYERS)}
    per_token = lambda ids: [ids[j * QM_LAYERS:(j + 1) * QM_LAYERS]
                             for j in range(len(out))]
    with route_tape(torch, moe, replay=replay) as tape:
        res = {"replayed": bucket_solo(torch, model, params, prompts, i, out,
                                       CB_CACHE, np)}
    res["flips"] = _flips(eng_ids, per_token(tape["ids"]))
    if not solo:
        return res
    s, k = len(req.prompt), eng_ids[0][0].numel()
    bucket_keep = [kp[i * s * k:(i + 1) * s * k] for kp in tape["keep"]]
    with route_tape(torch, moe) as tape:
        _, res["solo"] = solo_decode(model, params, req.prompt, len(out),
                                     cache_len=CB_CACHE, forced=out,
                                     keep_logits=True)
    res["solo_flips"] = _flips(eng_ids, per_token(tape["ids"]))
    res["keep_differs"] = sum(int((a != b).sum()) for a, b in
                              zip(bucket_keep, tape["keep"], strict=True))
    res["dropped"] = (sum(int((~a).sum()) for a in bucket_keep),
                      sum(int((~b).sum()) for b in tape["keep"]))
    return res


def run_continuous(torch, ops, serve, card, arch=ARCH,
                   ref_gens=(8, 32, 128)):
    """Continuous batching of ``arch`` FULL on the card: through the
    serving CLI (the decode step one CUDA graph), then the engine on the
    same weights captured (logits kept for three requests) and with
    graph=False.  Fails unless the three emit the same tokens, every
    kernel launches as ``_cb_want`` counts, each on its route, and one
    request of each budget in ``ref_gens``, decoded with teacher forcing
    on the engine's tokens, gives the engine's logits within CB_TOL of the
    largest
    |logit| (ROADMAP Queue 3, fault 8's contract), every emitted token
    the argmax of the engine's own logits.  The teacher-forced run is the
    request's solo decode; for qwen3-moe it is the decode from the
    engine's own prefill bucket with the engine's expert choices replayed
    (``moe_references``; the choices its own router would flip counted),
    and the shortest request's solo decode is printed beside it with the
    assignments its own prefill keeps or drops otherwise (fault 18).
    rwkv6-3b in bf16 takes no reference (fault 20: ``run_engine_f32``
    holds its engine); qwen3-moe's run eagerly at ~0.2 s a token, for
    the budgets 8 and 32.
    The engines' weights come from a full-width init whose peak is
    printed (``_guard_and_init``: nothing left on the card before
    it)."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rwkv6 as rw
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServingEngine, convoy_units, \
        solo_decode
    argv = ["--arch", arch, "--size", "full", "--continuous", "--requests",
            str(CB_REQUESTS), "--prompt-len", str(PROMPT), "--gen-mix",
            CB_MIX, "--slots", str(CB_SLOTS), "--policy", "longest_first",
            "--prefill-chunk-tokens", str(CB_CHUNK), "--batch", str(BATCH),
            "--seed", str(SEED)]
    _free_card(torch, f"the {arch} continuous CLI")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(ops, fa.ROUTES, mg.ROUTES, rw.ROUTES)
    cli = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = cli["stats"]
    want = _cb_want(arch, stats)
    if launches != want:
        fail(f"continuous {arch}: launches {launches} != {want} (prefill "
             f"chunks {stats['prefill_chunks']}, decode steps "
             f"{stats['decode_steps']})")
    routes = _check_routes(f"continuous {arch}", launches, fa, mg, rw,
                           launches.get("moe_gmm", 0)
                           - 3 * QM_LAYERS * stats["prefill_chunks"])
    if not stats["graph"] or stats["qos"]["completed"] != CB_REQUESTS:
        fail(f"continuous {arch}: graph {stats['graph']}, "
             f"{stats['qos']['completed']} of {CB_REQUESTS} completed")
    print(f"continuous {arch} through the CLI: launches "
          f"{json.dumps(launches, sort_keys=True)} for "
          f"{stats['prefill_chunks']} prefill chunks and "
          f"{stats['decode_steps']} decode steps; routes "
          f"{json.dumps(routes, sort_keys=True)}; peak {peak_gb:.2f} GB")
    args = serve.parse_args(argv)
    model, params, init_s, init_peak, nbytes = _guard_and_init(
        torch, arch, torch.device("cuda", 0))
    reqs = serve._request_mix(model.cfg, args)
    convoy = convoy_units(reqs, BATCH)
    pick = {}
    for r in reqs:
        pick.setdefault(r.max_new_tokens, r.rid)
    results = {"cli": dict(emitted=sum(len(v) for v in
                                       cli["tokens"].values()),
                           requests=len(reqs), wall_s=cli["wall_s"],
                           tok_s=cli["tok_s"])}
    _engine_line("CLI, captured", results["cli"], stats, convoy, card)
    runs, profiles, chunks, lanes = {}, {}, [], None
    for name, graph in (("captured", True), ("eager", False)):
        engine = ServingEngine(
            model, params, slots=CB_SLOTS, cache_len=CB_CACHE,
            prefill_chunk_tokens=CB_CHUNK, policy="longest_first",
            seed=SEED, graph=graph, keep_logits=pick.values())
        if arch == QM_ARCH and graph:          # the buckets it admits
            admit = engine._admit_chunk
            engine._admit_chunk = lambda c, admit=admit: (
                chunks.append(list(c)), admit(c))[1]
        tape = contextlib.nullcontext({})
        if arch == QM_ARCH and not graph:      # its lanes' expert ids
            tape, steps = route_tape(torch, moe), []
            run_step = engine._run_step
            engine._run_step = lambda run_step=run_step: (steps.append((
                {s: r.rid for s, r in engine._tenant.items()
                 if engine.active[s]}, len(taped["ids"]))), run_step())[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tape as taped:
            out = engine.run(serve._request_mix(model.cfg, args))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if arch == QM_ARCH:             # the wrappers' cycles, undone
            engine.__dict__.pop("_admit_chunk", None)
            engine.__dict__.pop("_run_step", None)
        if arch == QM_ARCH and not graph:
            lanes = {rid: _lane_ids(steps, taped["ids"], rid, QM_LAYERS)
                     for rid in pick.values()}
        emitted = sum(len(v) for v in out.values())
        results[name] = dict(emitted=emitted, requests=len(reqs),
                             wall_s=wall, tok_s=emitted / wall)
        _engine_line(name, results[name], engine.stats(), convoy, card)
        runs[name] = (out, {rid: engine.kept_logits[rid]
                            for rid in pick.values()})
        if graph or arch != QM_ARCH:   # qwen3-moe's eager step: 0.2 s
            profiles[name] = profile_engine_step(torch, engine, name, card)
        del engine
        torch.cuda.empty_cache()
    for rid, toks in cli["tokens"].items():
        for name, (out, _) in runs.items():
            if not np.array_equal(out[rid], toks):
                fail(f"continuous {arch}: request {rid} tokens differ "
                     f"between the CLI's captured run and the {name} run")
    same = max(float((runs["captured"][1][rid] - runs["eager"][1][rid])
                     .abs().max()) for rid in pick.values())
    print(f"continuous {arch}: the CLI's, the captured and the eager runs "
          f"emit the same tokens for all {len(reqs)} requests; captured "
          f"against eager logits of the kept requests: largest gap {same}")
    gaps = []
    for gen, rid in sorted(pick.items()):
        req = reqs[rid]
        if gen not in ref_gens:
            continue
        for name, (out, kept) in runs.items():
            if not torch.equal(torch.argmax(kept[rid], -1).to(torch.int32),
                               torch.as_tensor(out[rid])):
                fail(f"continuous {arch} {name}: request {rid}'s tokens "
                     "are not the argmax of the engine's logits")
        eng = runs["captured"][1][rid]
        top = float(eng.abs().max())
        forced = runs["captured"][0][rid]
        if arch == QM_ARCH:
            chunk = next(c for c in chunks if rid in [r.rid for r in c])
            ref = moe_references(torch, moe, model, params, req, forced,
                                 lanes[rid], chunk, np, solo=gen == min(pick))
            held = float((ref["replayed"] - eng).abs().max())
            print(f"teacher-forced request {rid} (gen {gen}, in a bucket of "
                  f"{len(chunk)}) from the engine's bucket with its expert "
                  f"choices replayed vs the captured engine: largest logit "
                  f"gap {held:.4e}, largest |logit| {top:.4f}, ratio "
                  f"{held / top:.4e} (tol {CB_TOL}); its own router picks "
                  f"another set at {ref['flips'][0]} (token, layer) pairs "
                  f"({ref['flips'][1]} ids of "
                  f"{len(forced) * QM_LAYERS * lanes[rid][0][0].numel()})")
            if "solo" in ref:
                solo = float((ref["solo"] - eng).abs().max())
                print(f"  its solo decode (own prefill and routing): gap "
                      f"{solo:.4e} ({solo / top:.4e}); {ref['solo_flips'][0]}"
                      f" flips; its prefill keeps or drops "
                      f"{ref['keep_differs']} assignments otherwise "
                      f"(dropped: {ref['dropped'][0]} in the bucket's rows, "
                      f"{ref['dropped'][1]} alone; fault 18)")
                if ref["keep_differs"] == 0 and ref["solo_flips"][0] == 0 \
                        and not solo <= CB_TOL * top:
                    fail(f"continuous {arch}: request {rid}'s solo decode "
                         f"differs by {solo} > {CB_TOL} x {top} with the "
                         "engine's prefill and routing")
        else:
            _, ref = solo_decode(model, params, req.prompt, gen,
                                 cache_len=CB_CACHE, forced=forced,
                                 keep_logits=True)
            held = float((ref - eng).abs().max())
            print(f"teacher-forced solo decode of request {rid} (gen {gen}) "
                  f"vs the captured engine: largest logit gap {held:.4e}, "
                  f"largest |logit| {top:.4f}, ratio {held / top:.4e} (tol "
                  f"{CB_TOL})")
        gaps.append(held / top)
        if not held <= CB_TOL * top:
            fail(f"continuous {arch}: request {rid}'s teacher-forced "
                 f"logits differ by {held} > {CB_TOL} x {top}")
    del model, params
    torch.cuda.empty_cache()
    return results, profiles, max(gaps, default=None), peak_gb, {
        "init_s": init_s, "init_peak": init_peak, "param_bytes": nbytes,
        "cli_launches": launches, "chunks": stats["prefill_chunks"],
        "steps": stats["decode_steps"]}


def _static_argv(arch, prompt=None, gen=None):
    return ["--arch", arch, "--size", "full", "--batch", str(BATCH),
            "--prompt-len", str(prompt or PROMPT), "--gen", str(gen or GEN),
            "--seed", str(SEED)]


def _serve_counted(torch, ops, serve, argv, counters):
    """``serve.main(argv)`` after ``_free_card``, with every launch and
    route count set to 0 before it; -> (its result, the launches, peak
    GB)."""
    _free_card(torch, " ".join(argv[:2] + argv[-4:]))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(ops, *counters)
    res = serve.main(argv)
    torch.cuda.synchronize()
    return res, dict(ops.LAUNCHES), torch.cuda.max_memory_allocated() / 1e9


def _check_tokens(name, toks, shape, vocab):
    if tuple(toks.shape) != shape or int(toks.min()) < 0 \
            or int(toks.max()) >= vocab:
        fail(f"{name}: tokens {tuple(toks.shape)} out of range")


def _check_split(name, res, d):
    """gen + 1 INFER frames whose payload bytes equal the bill at d_model
    ``d`` in int8 (1 byte an element, one f32 scale a block: 256 at the
    full widths): the prompt's hop, then one a decoded token."""
    from repro_torch.kernels.wire_codec import wire_block
    bill = lambda rows: rows * d + rows * d // wire_block(d) * 4
    want = bill(BATCH * PROMPT) + GEN * bill(BATCH)
    if res["frames"] != GEN + 1 or res["measured_payload_bytes"] != want \
            or res["billed_payload_bytes"] != want:
        fail(f"{name}: {res['frames']} frames, measured "
             f"{res['measured_payload_bytes']} B, billed "
             f"{res['billed_payload_bytes']} B; expected {GEN + 1} frames "
             f"and {want} B")
    print(f"{name}: {res['frames']} frames, {res['measured_payload_bytes']:,}"
          f" B measured == billed ({bill(BATCH * PROMPT):,} B for the "
          f"prompt's hop + {GEN} x {bill(BATCH):,} B); prefill "
          f"{res['prefill_ms']:.2f} ms, decode {res['decode_tok_s']:.1f} "
          "tok/s")


def _serving_lines(arch, res, card):
    """The serving phase's summary: static, split and continuous walls,
    the init and the peaks, beside the card."""
    print(f"main path {arch} static: prefill "
          f"{res['static']['prefill_ms']:.2f} ms, decode "
          f"{res['static']['decode_tok_s']:.1f} tok/s, peak "
          f"{res['static_peak']:.2f} GB; split int8: prefill "
          f"{res['split']['prefill_ms']:.2f} ms, decode "
          f"{res['split']['decode_tok_s']:.1f} tok/s; init "
          f"{res['init_s']:.2f} s, peak {res['init_peak'] / 1e9:.3f} GB for "
          f"{res['param_bytes'] / 1e9:.3f} GB of parameters ({card})")
    for name, r in res["continuous"].items():
        p = res["profiles"].get(name)
        print(f"main path continuous {arch} {name}: {r['tok_s']:.1f} tok/s"
              + (f"; decode step {p['busy_ms']:.3f} device ms, idle share "
                 f"{p['idle']:.3f} traced, {p['idle_untraced']:.3f} against "
                 f"the untraced {p['untraced_ms']:.3f} ms" if p else "")
              + f" ({card})")
    if "f32_gap" in res:
        print(f"main path continuous {arch}: teacher-forced logit gap "
              f"{res['f32_gap']:.4e} of the largest |logit| in f32 (tol "
              f"{RS_F32_TOL}; bf16's not held, fault 20); peak "
              f"{res['cb_peak']:.2f} GB")
        return
    print(f"main path continuous {arch}: teacher-forced logit gap "
          f"{res['gap']:.4e} of the largest |logit| (tol {CB_TOL}); peak "
          f"{res['cb_peak']:.2f} GB")


def run_engine_f32(torch, serve, arch, card):
    """``arch`` FULL in f32 (its weights drawn from SEED in f32; every
    kernel on its f32 route): the engine, its step captured, on the
    continuous mix, and one request of each budget decoded solo with
    teacher forcing on the engine's tokens, within RS_F32_TOL of the
    largest |logit|.  Returns the largest gap over the largest |logit|."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import ServingEngine, solo_decode
    _free_card(torch, f"{arch}'s f32 init")
    cfg = dataclasses.replace(get_arch(arch).full, dtype="float32")
    model = LM(cfg, torch.device("cuda", 0))
    params = model.init(torch.Generator(device=model.device).manual_seed(
        SEED))
    args = serve.parse_args(["--arch", arch, "--requests", str(CB_REQUESTS),
                             "--prompt-len", str(PROMPT), "--gen-mix",
                             CB_MIX, "--seed", str(SEED)])
    reqs = serve._request_mix(cfg, args)
    pick = {}
    for r in reqs:
        pick.setdefault(r.max_new_tokens, r.rid)
    engine = ServingEngine(model, params, slots=CB_SLOTS, cache_len=CB_CACHE,
                           prefill_chunk_tokens=CB_CHUNK,
                           policy="longest_first", seed=SEED, graph=True,
                           keep_logits=pick.values())
    out = engine.run(reqs)
    gaps = []
    for gen, rid in sorted(pick.items()):
        eng = engine.kept_logits[rid]
        _, solo = solo_decode(model, params, reqs[rid].prompt, gen,
                              cache_len=CB_CACHE, forced=out[rid],
                              keep_logits=True)
        top = float(eng.abs().max())
        gap = float((solo - eng).abs().max())
        gaps.append(gap / top)
        print(f"{arch} f32 engine (captured) vs teacher-forced solo decode "
              f"of request {rid} (gen {gen}): largest logit gap {gap:.4e}, "
              f"largest |logit| {top:.4f}, ratio {gap / top:.4e} (tol "
              f"{RS_F32_TOL}) ({card})")
        if not (np.array_equal(torch.argmax(eng, -1).numpy(), out[rid])
                and gap <= RS_F32_TOL * top):
            fail(f"{arch} f32 engine: request {rid} differs from its solo "
                 f"decode by {gap} > {RS_F32_TOL} x {top}, or its tokens "
                 "are not its logits' argmax")
    del engine, model, params
    torch.cuda.empty_cache()
    return max(gaps)


def run_qwen3_serving(torch, ops, serve, card):
    """qwen3-moe-30b-a3b at full width through the serving CLI's entry
    point, every init from seed 0 after the card's memory is checked
    (``_free_card``): static (prefill launches QM_PREFILL, the
    run QM_RUN; moe_gmm on "wgmma" in prefill, capacity 160, and on
    "wgmma_small_c" in decode, capacity 8; flash on "mma"), split at cut
    24 in int8 (``_check_split``; the codec's decodes on "warp256"), then
    the continuous mix (``run_continuous``: the init's peak against the
    parameters' bytes, the engine against its teacher-forced references
    and the expert choices that flip).  Returns the phase's numbers."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rwkv6 as rw
    from repro_torch.kernels import wire_codec as wc
    vocab = get_arch(QM_ARCH).full.vocab
    counters = (fa.ROUTES, mg.ROUTES, rw.ROUTES, wc.ROUTES)
    static, launches, peak = _serve_counted(
        torch, ops, serve, _static_argv(QM_ARCH), counters)
    _check_tokens(f"{QM_ARCH} static", static["tokens"], (BATCH, GEN), vocab)
    if static["prefill_launches"] != QM_PREFILL or launches != QM_RUN:
        fail(f"{QM_ARCH} static: prefill launches "
             f"{static['prefill_launches']}, run {launches}; expected "
             f"{QM_PREFILL}, {QM_RUN}")
    routes = _check_routes(f"{QM_ARCH} static", launches, fa, mg, rw,
                           3 * QM_LAYERS * GEN)
    print(f"{QM_ARCH} static: prefill {static['prefill_ms']:.2f} ms, decode "
          f"{static['decode_tok_s']:.1f} tok/s, peak {peak:.2f} GB; launches "
          f"{json.dumps(launches, sort_keys=True)}, routes "
          f"{json.dumps(routes, sort_keys=True)} ({card})")
    split, split_launches, split_peak = _serve_counted(
        torch, ops, serve, _static_argv(QM_ARCH) + [
            "--split-cut", str(QM_CUT), "--wire-dtype", "int8"], counters)
    _check_tokens(f"{QM_ARCH} split", split["tokens"], (BATCH, GEN), vocab)
    want = dict(QM_RUN, wire_encode=GEN + 1, wire_decode=GEN + 1)
    if split_launches != want or dict(wc.ROUTES) != {"warp256": GEN + 1}:
        fail(f"{QM_ARCH} split: launches {split_launches}, decode routes "
             f"{dict(wc.ROUTES)}; expected {want}, all on warp256")
    _check_routes(f"{QM_ARCH} split", split_launches, fa, mg, rw,
                  3 * QM_LAYERS * GEN)
    _check_split(f"{QM_ARCH} split at cut {QM_CUT} int8 (peak "
                 f"{split_peak:.2f} GB)", split, get_arch(QM_ARCH).full.d_model)
    cb, profiles, gap, cb_peak, cb_info = run_continuous(
        torch, ops, serve, card, QM_ARCH, ref_gens=(8, 32))
    if not cb_info["init_peak"] <= cb_info["param_bytes"] + QM_INIT_SLACK:
        fail(f"{QM_ARCH}: init peak {cb_info['init_peak'] / 1e9:.3f} GB > "
             f"the parameters' {cb_info['param_bytes'] / 1e9:.3f} GB + "
             f"{QM_INIT_SLACK / 1e9} GB")
    return {"static": static, "static_peak": peak, "split": split,
            "continuous": cb, "profiles": profiles, "gap": gap,
            "cb_peak": cb_peak, "launches": [launches, split_launches,
                                             cb_info["cli_launches"]],
            **cb_info}


def run_rwkv_serving(torch, ops, serve, card):
    """rwkv6-3b at full width through the serving CLI's entry point:
    static (exactly one wkv6 launch a layer in the prefill and in each
    decode step, every one on "chunked": the decode steps' S = 1 calls
    from the cached state too), the same at a RS_LOOP prompt with and
    without --token-loop-prefill (one launch a layer a prompt token; the
    tokens compared and printed), split at cut 16 in int8
    (``_check_split``), then the continuous mix (``run_continuous``).
    Returns the phase's numbers."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rwkv6 as rw
    from repro_torch.kernels import wire_codec as wc
    vocab = get_arch(T_ARCH).full.vocab
    counters = (fa.ROUTES, mg.ROUTES, rw.ROUTES, wc.ROUTES)
    run = {"wkv6": RS_LAYERS * (GEN + 1)}
    static, launches, peak = _serve_counted(
        torch, ops, serve, _static_argv(T_ARCH), counters)
    _check_tokens(f"{T_ARCH} static", static["tokens"], (BATCH, GEN), vocab)
    if static["prefill_launches"] != {"wkv6": RS_LAYERS} or launches != run:
        fail(f"{T_ARCH} static: prefill launches "
             f"{static['prefill_launches']}, run {launches}; expected "
             f"{RS_LAYERS} and {run} wkv6")
    _check_routes(f"{T_ARCH} static", launches, fa, mg, rw)
    print(f"{T_ARCH} static: prefill {static['prefill_ms']:.2f} ms, decode "
          f"{static['decode_tok_s']:.1f} tok/s, peak {peak:.2f} GB; "
          f"{launches['wkv6']} wkv6 launches, every one on chunked "
          f"({card})")
    loop = {}
    for flag in ([], ["--token-loop-prefill"]):
        res, n, _ = _serve_counted(torch, ops, serve, _static_argv(
            T_ARCH, *RS_LOOP) + flag, counters)
        _check_tokens(f"{T_ARCH} {flag}", res["tokens"], (BATCH, RS_LOOP[1]),
                      vocab)
        steps = (RS_LOOP[0] if flag else 1) + RS_LOOP[1]
        if n != {"wkv6": RS_LAYERS * steps}:
            fail(f"{T_ARCH} prompt {RS_LOOP[0]} {flag}: launches {n}, "
                 f"expected {RS_LAYERS * steps} wkv6")
        _check_routes(f"{T_ARCH} prompt {RS_LOOP[0]} {flag}", n, fa, mg, rw)
        loop[bool(flag)] = res
    agree = int((loop[True]["tokens"] == loop[False]["tokens"]).sum())
    print(f"{T_ARCH} prompt {RS_LOOP[0]}, {RS_LOOP[1]} tokens: "
          f"--token-loop-prefill {loop[True]['prefill_ms']:.2f} ms "
          f"({RS_LAYERS * RS_LOOP[0]} wkv6 launches at S = 1) against the "
          f"one-pass prefill's {loop[False]['prefill_ms']:.2f} ms; "
          f"{agree} of {BATCH * RS_LOOP[1]} tokens equal (bf16)")
    split, split_launches, split_peak = _serve_counted(
        torch, ops, serve, _static_argv(T_ARCH) + [
            "--split-cut", str(RS_CUT), "--wire-dtype", "int8"], counters)
    _check_tokens(f"{T_ARCH} split", split["tokens"], (BATCH, GEN), vocab)
    want = dict(run, wire_encode=GEN + 1, wire_decode=GEN + 1)
    if split_launches != want or dict(wc.ROUTES) != {"warp256": GEN + 1}:
        fail(f"{T_ARCH} split: launches {split_launches}, decode routes "
             f"{dict(wc.ROUTES)}; expected {want}, all on warp256")
    _check_routes(f"{T_ARCH} split", split_launches, fa, mg, rw)
    _check_split(f"{T_ARCH} split at cut {RS_CUT} int8 (peak "
                 f"{split_peak:.2f} GB)", split, get_arch(T_ARCH).full.d_model)
    cb, profiles, gap, cb_peak, cb_info = run_continuous(
        torch, ops, serve, card, T_ARCH, ref_gens=())
    cb_info["f32_gap"] = run_engine_f32(torch, serve, T_ARCH, card)
    return {"static": static, "static_peak": peak, "split": split,
            "continuous": cb, "profiles": profiles, "gap": gap,
            "cb_peak": cb_peak, "launches": [launches, split_launches,
                                             cb_info["cli_launches"]],
            **cb_info}


def _train_argv(wire: str, arch: str = T_ARCH, v: int = 1):
    return ["--arch", arch, "--size", "full", "--pipeline-stages", "2",
            "--pipeline-k", str(T_K), "--batch", str(T_BATCH), "--seq",
            str(T_SEQ), "--steps", str(T_STEPS), "--seed", str(SEED),
            "--wire-dtype", wire, "--log-every", "1"] + (
                ["--virtual-stages", str(v)] if v > 1 else [])


def billed_step_bytes(protocol, spec, d: int, act_bytes: int,
                      rows: int = T_BATCH * T_SEQ):
    """A pipelined step's billed hop bytes (up, down): S*v - 1 hops of
    the whole batch (``rows`` tokens), up at the forward rate, down at the
    backward one."""
    hops = spec.num_stages * spec.virtual_stages - 1
    n = rows * d
    return tuple(hops * protocol.billed_hop_bytes(
        n, d, spec.wire_dtype, act_bytes, backward=bwd)
        for bwd in (False, True))


def check_training_run(torch, protocol, dev, res, name, wire,
                       rows: int = T_BATCH * T_SEQ, unread=()):
    """A training CLI run's result: every loss finite, the hop's bytes up
    and down each step equal to the billed bytes (``billed_step_bytes`` of
    ``rows`` tokens), and every parameter tensor changed from its initial
    value (drawn again from the run's seed) but those named in ``unread``
    (dotted paths), which no forward reads: they must keep their zeros.
    Returns (parameter tensors, billed bytes a step up, down)."""
    from repro_torch.models.lm import LM
    model, spec = res["model"], res["pipeline"]
    if (spec.wire_dtype if spec else "none") != wire:
        fail(f"{name}: the run's codec is not {wire}")
    up, down = billed_step_bytes(protocol, spec, model.cfg.d_model,
                                 model.dtype.itemsize, rows) \
        if spec else (0, 0)
    for row in res["rows"]:
        if not math.isfinite(row["loss"]):
            fail(f"{name}: step {row['step']} loss {row['loss']}")
        if (row["hop_bytes_up"], row["hop_bytes_down"]) != (up, down):
            fail(f"{name} step {row['step']}: hop bytes up "
                 f"{row['hop_bytes_up']} down {row['hop_bytes_down']} != "
                 f"billed {up} / {down}")
    fresh = flat_leaves(LM(model.cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED), master=True))
    got = flat_leaves(res["state"]["params"])
    same = {k for k, t in fresh.items() if torch.equal(got[k], t)}
    if same != set(unread) or any(got[k].any() for k in unread):
        fail(f"{name}: {len(same)} of {len(fresh)} parameter tensors did "
             f"not change ({sorted(same)}); expected {sorted(unread)}, "
             "at zero")
    return len(fresh), up, down


def run_training_path(torch, ops, train, protocol, dev, wc, profile_int8):
    """C2P2SL training of rwkv6-3b at full width through the training
    CLI, wire none then int8.  Returns (rows per wire, launches, codec
    calls by shape); the int8 run's final state goes to
    ``profile_int8(result)`` after the launch counts are read.  Every
    WKV6 launch must take the chunked route, every decode "warp256"."""
    from repro_torch.kernels import rwkv6 as rw
    rows, launches, keep = {}, None, None
    ops.reset_launches()
    rw.ROUTES.clear()
    wc.ROUTES.clear()
    for wire in ("none", "int8"):
        with codec_calls(wc) as calls:
            res = train.main(_train_argv(wire))
        torch.cuda.synchronize()
        rows[wire] = res["rows"]
        n, up, _down = check_training_run(torch, protocol, dev, res,
                                          f"train {wire}", wire)
        print(f"train {wire}: losses "
              f"{[round(r['loss'], 5) for r in res['rows']]}, all {n} "
              f"parameter tensors changed, hop bytes per step up == down == "
              f"billed {up:.0f}")
        if wire == "int8":
            launches = dict(ops.LAUNCHES)
            routes = dict(rw.ROUTES)
            check_codec_calls(wc, "training path", launches, calls,
                              dict(wc.ROUTES))
            keep = res
        del res
        torch.cuda.empty_cache()
    for name in TRAINING_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the training path")
    want = {"wkv6:chunked": launches["wkv6"],
            "wkv6_bwd:chunked": launches["wkv6_bwd"]}
    if routes != want:
        fail(f"training-path WKV6 routes {routes}, expected {want}")
    print(f"training-path launches: {json.dumps(launches, sort_keys=True)}; "
          f"WKV6 routes {json.dumps(routes, sort_keys=True)}")
    profile_int8(keep)
    del keep
    torch.cuda.empty_cache()
    return rows, launches, calls


def run_qwen_training(torch, ops, train, protocol, dev, wc, card):
    """C2P2SL training of qwen1.5-4b at full width through the training
    CLI, int8 hop, after rwkv6-3b's state is freed; the launch counts are
    read around that one run; every flash forward and backward on "mma".
    Its losses print beside ``Q_LOSSES_SIMT``, the first equal to 5
    digits.  Returns (rows, launches, codec calls by shape); the final
    state goes to ``profile_training_step``, whose flash lines give the
    forward's and the two backward kernels' device time."""
    from repro_torch.kernels import flash_attention as fa
    torch.cuda.synchronize()
    ops.reset_launches()
    fa.ROUTES.clear()
    fa.BWD_ROUTES.clear()
    wc.ROUTES.clear()
    held = torch.cuda.memory_allocated() / 1e9
    with codec_calls(wc) as calls:
        res = train.main(_train_argv("int8", ARCH))
    torch.cuda.synchronize()
    launches, routes = dict(ops.LAUNCHES), dict(fa.ROUTES)
    bwd_routes = dict(fa.BWD_ROUTES)
    n, billed, _down = check_training_run(torch, protocol, dev, res,
                                          f"train {ARCH}", "int8")
    d = res["model"].cfg.d_model
    if launches != Q_LAUNCHES:
        fail(f"train {ARCH}: launches {launches} != {Q_LAUNCHES}")
    if routes != {"mma": Q_LAUNCHES["flash_attention"]}:
        fail(f"train {ARCH}: flash routes {routes}: not all on mma")
    if bwd_routes != {"mma": Q_LAUNCHES["flash_attention_bwd"]}:
        fail(f"train {ARCH}: flash backward routes {bwd_routes}: not all "
             f"on mma")
    losses = [r["loss"] for r in res["rows"]]
    if round(losses[0], 5) != Q_LOSSES_SIMT[0]:
        fail(f"train {ARCH}: first loss {losses[0]:.6f} != "
             f"{Q_LOSSES_SIMT[0]} (the forward is the same)")
    check_codec_calls(wc, f"{ARCH} training path", launches, calls,
                      dict(wc.ROUTES))
    rows_, dt = T_BATCH // T_K * T_SEQ, str(res["model"].dtype).split(".")[-1]
    want = {(kern, rows_, d, dt, "int8"): Q_LAUNCHES[kern]
            for kern in ("wire_encode", "wire_decode")}
    if dict(calls) != want:
        fail(f"train {ARCH}: codec calls {dict(calls)} != {want}")
    peak = max(r["peak_gb"] for r in res["rows"])
    print(f"train {ARCH} int8: losses {[round(x, 5) for x in losses]} "
          f"(SIMT backward: {list(Q_LOSSES_SIMT)}), all {n} parameter "
          f"tensors changed, hop bytes per step up == down == billed "
          f"{billed:.0f}; launches {json.dumps(launches, sort_keys=True)}, "
          f"flash routes {routes}, backward routes {bwd_routes}; peak "
          f"{peak:.2f} GB on {card}, {held:.3f} GB of it held by earlier "
          f"phases")
    profile_training_step(torch, res, {"flash forward": "flash_fwd",
                                       "flash backward dq": "flash_bwd_dq",
                                       "flash backward dkv": "flash_bwd_dkv"})
    rows = res["rows"]
    del res
    torch.cuda.empty_cache()
    return rows, launches, calls


def _check_train_launches(name, launches, routes, want):
    """A full-width training run's exact launch counts and kernel routes
    (``routes``: each route counter against the routes it must take)."""
    if launches != want:
        fail(f"train {name}: launches {launches} != {want}")
    for what, (got, expect) in routes.items():
        if got != expect:
            fail(f"train {name}: {what} routes {got} != {expect}")


def run_granite_training(torch, ops, train, protocol, dev, wc, card):
    """C2P2SL training of granite-moe-3b-a800m at full width through the
    training CLI (S 2, k 4, int8 hop, 8 x 512, 3 steps): every loss and
    aux finite, every parameter moved (the router through the aux), hop
    bytes equal to the bills at d = 1536, exactly ``GT_LAUNCHES``, every
    grouped-matmul forward and backward on "wgmma", every flash forward
    and backward (dh 64) on "mma", every decode on "warp256".  One more step traced.
    Returns (rows, launches, codec calls by shape)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    torch.cuda.synchronize()
    ops.reset_launches()
    for counter in (fa.ROUTES, fa.BWD_ROUTES, mg.ROUTES, mg.BWD_ROUTES,
                    wc.ROUTES):
        counter.clear()
    with codec_calls(wc) as calls:
        res = train.main(_train_argv("int8", GR_ARCH))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    _check_train_launches(GR_ARCH, launches, {
        "moe_gmm": (dict(mg.ROUTES), {"wgmma": GT_LAUNCHES["moe_gmm"]}),
        "moe_gmm backward": (dict(mg.BWD_ROUTES),
                             {"wgmma": GT_LAUNCHES["moe_gmm_bwd"]}),
        "flash": (dict(fa.ROUTES), {"mma": GT_LAUNCHES["flash_attention"]}),
        "flash backward": (dict(fa.BWD_ROUTES),
                           {"mma": GT_LAUNCHES["flash_attention_bwd"]})},
        GT_LAUNCHES)
    n, billed, _down = check_training_run(torch, protocol, dev, res,
                                          f"train {GR_ARCH}", "int8")
    check_codec_calls(wc, f"{GR_ARCH} training path", launches, calls,
                      dict(wc.ROUTES))
    d = res["model"].cfg.d_model
    want = {(kern, T_BATCH // T_K * T_SEQ, d, "bfloat16", "int8"):
            GT_LAUNCHES[kern] for kern in ("wire_encode", "wire_decode")}
    if dict(calls) != want:
        fail(f"train {GR_ARCH}: codec calls {dict(calls)} != {want}")
    rows = res["rows"]
    if not all(math.isfinite(r["aux"]) and r["aux"] > 0 for r in rows):
        fail(f"train {GR_ARCH}: aux {[r['aux'] for r in rows]}")
    print(f"train {GR_ARCH} int8: losses "
          f"{[round(r['loss'], 5) for r in rows]} (through the SIMT "
          f"moe_gmm_bwd {GT_LOSSES_SIMT[0]} -> {GT_LOSSES_SIMT[1]}: first "
          f"{rows[0]['loss'] - GT_LOSSES_SIMT[0]:+.5f}, last "
          f"{rows[-1]['loss'] - GT_LOSSES_SIMT[1]:+.5f}), aux "
          f"{[round(r['aux'], 5) for r in rows]}, all {n} parameter "
          f"tensors changed, hop bytes per step up == down == billed "
          f"{billed:.0f}; launches {json.dumps(launches, sort_keys=True)}; "
          f"peak {max(r['peak_gb'] for r in rows):.2f} GB on {card}")
    profile_training_step(torch, res, {
        "moe_gmm forward": "gmm_wgmma<2,",
        "moe_gmm backward": "gmm_wgmma<4,",
        "flash backward": "flash_bwd"})
    del res
    torch.cuda.empty_cache()
    return rows, launches, calls


def _whisper_argv(*extra):
    return ["--arch", WH_ARCH, "--size", "full", "--batch", str(WH_BATCH),
            "--prompt-len", str(WH_PROMPT), "--gen", str(WH_GEN), "--seed",
            str(SEED), *extra]


def whisper_loop_gap(torch, serve, dev, dtype):
    """whisper-small FULL at ``dtype`` (its weights drawn from SEED at that
    dtype; f32 takes every kernel's f32 route) on the serve CLI's prompts
    and frames: the one-pass prefill against ``_encode`` +
    ``fill_cross_kv`` + the token loop, then WH_LOOP_STEPS greedy decode
    steps from both caches.  Returns (the largest |gap| of each step's
    logits, whether each step is within WH_LOOP_TOL + WH_LOOP_TOL |one
    pass| element by element, the largest |logit|)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_arch(WH_ARCH).full,
                              dtype=str(dtype).split(".")[-1])
    model = LM(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (WH_BATCH, WH_PROMPT)), device=dev)
    frames = torch.as_tensor(rng.standard_normal(
        (WH_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32),
        device=dev).to(model.dtype)
    cache_len = WH_PROMPT + WH_LOOP_STEPS
    gaps, within, top = [], [], 0.0
    with torch.inference_mode():
        la, sa = model.prefill_with_cache(
            params, {"tokens": prompts, "frames": frames}, cache_len,
            torch.float32)
        cache = model.fill_cross_kv(params, model._encode(params, frames),
                                    model.init_cache(WH_BATCH, cache_len,
                                                     torch.float32))
        lb, sb = serve.prefill_into_cache(model, params, prompts, cache)
        for i in range(WH_LOOP_STEPS + 1):
            if i:
                tok = torch.argmax(la, -1, keepdim=True)
                la, _ = model.decode_step(params, tok, sa["cache"],
                                          WH_PROMPT + i - 1)
                lb, _ = model.decode_step(params, tok, sb["cache"],
                                          WH_PROMPT + i - 1)
            gaps.append(float((la - lb).abs().max()))
            within.append(bool(((la - lb).abs()
                                <= WH_LOOP_TOL * (1 + la.abs())).all()))
            top = max(top, float(la.abs().max()))
    del model, params, sa, sb, cache
    return gaps, within, top


def run_whisper(torch, ops, serve, train, protocol, dev, wc, card):
    """whisper-small at full width, the encoder-decoder: static serving
    through the serving CLI (greedy, sampled at WH_TEMP, and
    --token-loop-prefill; exactly WH_PREFILL / WH_LOOP flash launches,
    every one on "mma", by call shape), the f32 and bf16 token loops
    against the one-pass prefill (f32 held within WH_LOOP_TOL), the
    refusals of --continuous and --split-cut, then C2P2SL training
    through the training CLI (S 2 cut at 6, k 4, int8, WH_T_BATCH x
    WH_T_SEQ with frames, 3 steps): finite losses, every parameter moved
    but the cross path's four unread biases (their zeros kept), hop bytes
    equal to the bills of h alone, exactly WH_T_LAUNCHES, every flash
    forward and backward on "mma", the codec's calls at [WH_MB x
    WH_T_SEQ, 768]; one more step traced.  Returns the phase's numbers:
    the runs, the flash calls by shape (serving's and training's) and the
    launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rwkv6 as rw
    cfg = get_arch(WH_ARCH).full
    counters = (fa.ROUTES, fa.BWD_ROUTES, mg.ROUTES, rw.ROUTES, wc.ROUTES)
    out, serve_calls = {}, collections.Counter()
    serve_launches = collections.Counter()
    for name, extra, want in (
            ("static", [], WH_PREFILL),
            (f"sampled T {WH_TEMP}", ["--temperature", str(WH_TEMP)],
             WH_PREFILL),
            ("--token-loop-prefill", ["--token-loop-prefill"], WH_LOOP)):
        with flash_calls(fa) as calls:
            res, launches, peak = _serve_counted(
                torch, ops, serve, _whisper_argv(*extra), counters)
        _check_tokens(f"{WH_ARCH} {name}", res["tokens"],
                      (WH_BATCH, WH_GEN), cfg.vocab)
        if res["prefill_launches"] != want or launches != want:
            fail(f"{WH_ARCH} {name}: prefill launches "
                 f"{res['prefill_launches']}, run {launches}; expected "
                 f"{want} in both (decode attention is plain)")
        _check_routes(f"{WH_ARCH} {name}", launches, fa, mg, rw)
        serve_calls.update(calls)
        serve_launches.update(launches)
        out[name] = dict(res, peak=peak)
        print(f"{WH_ARCH} {name}: B {WH_BATCH} x prompt {WH_PROMPT} with "
              f"{WH_BATCH} x {WH_FRAMES} frames, {WH_GEN} tokens: prefill "
              f"{res['prefill_ms']:.2f} ms, decode "
              f"{res['decode_tok_s']:.1f} tok/s, peak {peak:.2f} GB; flash "
              f"{launches['flash_attention']} on mma by (B, H, Sq, Skv, dh, "
              f"causal): " + "; ".join(
                  f"{k[1:7]}: {v}" for k, v in sorted(calls.items()))
              + f" ({card})")
    toks = {k: r["tokens"] for k, r in out.items()}
    print(f"{WH_ARCH} tokens: token loop == static in "
          f"{int((toks['--token-loop-prefill'] == toks['static']).sum())} "
          f"of {WH_BATCH * WH_GEN} (bf16), sampled == greedy in "
          f"{int((toks[f'sampled T {WH_TEMP}'] == toks['static']).sum())}")
    for flag, match in ((["--continuous", "--requests", "2"],
                         "continuous batching"),
                        (["--split-cut", "6", "--wire-dtype", "int8"],
                         "SplitDecode")):
        try:
            serve.main(_whisper_argv(*flag))
        except ValueError as e:
            if match not in str(e):
                fail(f"{WH_ARCH} {flag[0]}: raised {e!r}")
            print(f"{WH_ARCH} {' '.join(flag)}: refused ({e})")
        else:
            fail(f"{WH_ARCH} {flag[0]}: served; the reference refuses it")
    gaps = {}
    for dt in (torch.float32, torch.bfloat16):
        _free_card(torch, f"{WH_ARCH} {dt} token loop")
        gaps[dt] = whisper_loop_gap(torch, serve, dev, dt)
        g, ok, top = gaps[dt]
        print(f"{WH_ARCH} {str(dt).split('.')[-1]}: token loop against the "
              f"one-pass prefill, the last logits then {WH_LOOP_STEPS} "
              f"greedy steps: max |gap| {', '.join(f'{x:.3e}' for x in g)} "
              f"(largest |logit| {top:.3f}); within {WH_LOOP_TOL} + "
              f"{WH_LOOP_TOL} |logit|: {ok}"
              + ("" if dt == torch.float32 else " (not held)"))
    if not all(gaps[torch.float32][1]):
        fail(f"{WH_ARCH} f32 token loop: gaps {gaps[torch.float32][0]} "
             f"outside {WH_LOOP_TOL}")

    _free_card(torch, f"{WH_ARCH} training")
    torch.cuda.synchronize()
    _reset_counts(ops, *counters)
    with codec_calls(wc) as ccalls, flash_calls(fa) as tcalls:
        res = train.main(["--arch", WH_ARCH, "--size", "full",
                          "--pipeline-stages", "2", "--pipeline-k", str(T_K),
                          "--batch", str(WH_T_BATCH), "--seq", str(WH_T_SEQ),
                          "--steps", str(T_STEPS), "--seed", str(SEED),
                          "--wire-dtype", "int8", "--log-every", "1"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    _check_train_launches(WH_ARCH, launches, {
        "flash": (dict(fa.ROUTES), {"mma": WH_T_LAUNCHES["flash_attention"]}),
        "flash backward": (dict(fa.BWD_ROUTES),
                           {"mma": WH_T_LAUNCHES["flash_attention_bwd"]})},
        WH_T_LAUNCHES)
    unread = [f"blocks.cross.{b}" for b in ("qb", "kb", "vb", "ob")]
    n, up, down = check_training_run(torch, protocol, dev, res,
                                     f"train {WH_ARCH}", "int8",
                                     WH_T_BATCH * WH_T_SEQ, unread)
    check_codec_calls(wc, f"{WH_ARCH} training path", launches, ccalls,
                      dict(wc.ROUTES))
    want = {(kern, WH_MB * WH_T_SEQ, cfg.d_model, "bfloat16", "int8"):
            WH_T_LAUNCHES[kern] for kern in ("wire_encode", "wire_decode")}
    if dict(ccalls) != want:
        fail(f"train {WH_ARCH}: codec calls {dict(ccalls)} != {want}")
    if res["pipeline"].microbatches != T_K or len(
            res["model"].cfg.layer_kinds) // res["pipeline"].num_stages \
            != WH_T_CUT:
        fail(f"train {WH_ARCH}: the pipeline is not S 2, k {T_K}, cut at "
             f"{WH_T_CUT}")
    for r in res["rows"]:
        print(f"main path train {WH_ARCH} int8 step {r['step']}: loss "
              f"{r['loss']:.5f}, {r['step_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} "
              f"GB, hop up {r['hop_bytes_up']} B (billed {up:.0f}), down "
              f"{r['hop_bytes_down']} B (billed {down:.0f}) ({card})")
    print(f"train {WH_ARCH}: all {n} parameter tensors changed but the "
          f"{len(unread)} unread cross biases (still zero); launches "
          f"{json.dumps(launches, sort_keys=True)}; flash by (kernel, B, H, "
          f"Sq, Skv, dh, causal): " + "; ".join(
              f"{k[:7]}: {v}" for k, v in sorted(tcalls.items())))
    rows = res["rows"]
    profile_training_step(torch, res, {"flash forward": "flash_fwd",
                                       "flash backward": "flash_bwd"},
                          shape=(WH_T_BATCH, WH_T_SEQ))
    del res
    torch.cuda.empty_cache()
    return {"serve": out, "serve_calls": serve_calls,
            "serve_launches": dict(serve_launches), "gaps": gaps,
            "train_rows": rows, "train_launches": launches,
            "train_calls": tcalls}


def _pg_argv(*extra):
    return ["--arch", PG_ARCH, "--size", "full", "--batch", str(BATCH),
            "--prompt-len", str(PG_PROMPT), "--gen", str(PG_GEN), "--seed",
            str(SEED), *extra]


def paligemma_prefill(torch, ops, fa, dev, card):
    """paligemma-3b FULL's patch prefill: ``LM.prefill_with_cache`` of
    [BATCH, 256, 2048] stub patch embeddings (numpy draws from SEED, in
    bf16) before BATCH x PG_PROMPT tokens (S 384, the cache PG_CACHE in
    f32, as the serve CLI keeps it), then PG_GEN greedy steps of
    ``serving.engine.make_sample_step``: exactly PG_PREFILL flash launches,
    every one on "mma" at [4, 8, 384, 256] with the prefix 256 (counted
    by call), none in decode; finite logits, tokens in range, the
    position 384 + PG_GEN at the end.  Returns (prefill ms, decode tok/s,
    peak GB, the flash calls)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import make_sample_step
    cfg = get_arch(PG_ARCH).full
    _free_card(torch, f"{PG_ARCH} patch prefill")
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, PG_PROMPT)),
                             device=dev)
    patches = torch.as_tensor(rng.standard_normal(
        (BATCH, PG_PATCHES, cfg.d_model)).astype(np.float32),
        device=dev).to(model.dtype)
    step = make_sample_step(model, 0.0, SEED)
    rows = torch.arange(BATCH, device=dev)
    _reset_counts(ops, fa.ROUTES)
    with torch.inference_mode(), flash_calls(fa) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = model.prefill_with_cache(
            params, {"tokens": tokens, "patch_embeds": patches}, PG_CACHE,
            torch.float32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill = dict(ops.LAUNCHES)
        finite = bool(torch.isfinite(logits).all())
        tok, cache, pos = torch.argmax(logits, -1, keepdim=True), \
            st["cache"], st["position"]
        out = []
        t0 = time.perf_counter()
        for i in range(PG_GEN):
            nxt, logits, cache = step(params, tok, cache, pos, rows, i)
            pos += 1
            tok = nxt[:, None]
            out.append(nxt)
        toks = torch.stack(out, 1).cpu()
        decode_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    key = ("flash_attention", BATCH, 8, PG_PATCHES + PG_PROMPT,
           PG_PATCHES + PG_PROMPT, 256, True, "bfloat16", PG_PATCHES)
    if prefill != PG_PREFILL or launches != PG_PREFILL \
            or dict(calls) != {key: PG_LAYERS} \
            or dict(fa.ROUTES) != {"mma": PG_LAYERS}:
        fail(f"{PG_ARCH} patch prefill: launches {prefill}, run "
             f"{launches}, calls {dict(calls)}, routes {dict(fa.ROUTES)}; "
             f"expected {PG_PREFILL} with the prefix, on mma, none in "
             "decode")
    if not finite or pos != PG_CACHE or logits.shape != (BATCH, cfg.vocab):
        fail(f"{PG_ARCH} patch prefill: finite logits {finite}, position "
             f"{pos} (expected {PG_CACHE}), logits {tuple(logits.shape)}")
    _check_tokens(f"{PG_ARCH} patch prefill", toks, (BATCH, PG_GEN),
                  cfg.vocab)
    tok_s = PG_GEN * BATCH / decode_s
    print(f"{PG_ARCH} patch prefill: {BATCH} x ({PG_PATCHES} patches + "
          f"{PG_PROMPT} tokens) in {prefill_ms:.2f} ms, {PG_GEN} greedy "
          f"steps at {tok_s:.1f} tok/s, peak {peak:.2f} GB; flash "
          f"{PG_LAYERS} on mma at [{BATCH}, 8, {PG_PATCHES + PG_PROMPT}, "
          f"256] with prefix {PG_PATCHES}, none in decode; sample "
          f"{toks[0, :8].tolist()} ({card})")
    del model, params, cache, st, logits
    return prefill_ms, tok_s, peak, calls


def run_paligemma(torch, ops, serve, train, protocol, dev, wc, card):
    """paligemma-3b at full width, the prefix-LM: static serving through
    the serving CLI (batch 4, prompt PG_PROMPT, PG_GEN tokens: the token
    loop without patches, as the reference's CLI serves the vlm family;
    no flash launch, decode attention being plain), the refusals of
    --continuous and --split-cut (tied embeddings, ``SplitDecode``'s first
    check), the patch prefill (``paligemma_prefill``), then C2P2SL
    training through the training CLI (f32 master weights, AdamW, T_BATCH
    x T_SEQ tokens with 256 patches each, S 2 cut at 9, k 4, int8, 3
    steps): finite losses, every parameter moved, each step's hop bytes
    PG_HOP_BYTES each way, the bills at 768 rows a sequence (at 512 rows
    they would be 8,519,680: the prefix dropped), exactly PG_T_LAUNCHES,
    every flash forward and backward on "mma" at [2, 8, 768, 256] with the
    prefix 256, the codec's calls at [2 x 768, 2048]; one more step
    traced.  Returns the phase's numbers."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rwkv6 as rw
    cfg = get_arch(PG_ARCH).full
    counters = (fa.ROUTES, fa.BWD_ROUTES, mg.ROUTES, rw.ROUTES, wc.ROUTES)
    res, launches, peak = _serve_counted(torch, ops, serve, _pg_argv(),
                                         counters)
    _check_tokens(f"{PG_ARCH} CLI", res["tokens"], (BATCH, PG_GEN),
                  cfg.vocab)
    if res["prefill_launches"] != {} or launches != {}:
        fail(f"{PG_ARCH} CLI: prefill launches {res['prefill_launches']}, "
             f"run {launches}; the token loop launches no flash")
    cli = dict(res, peak=peak)
    print(f"{PG_ARCH} CLI (token loop, no patches): B {BATCH} x prompt "
          f"{PG_PROMPT}, {PG_GEN} tokens: prefill {res['prefill_ms']:.2f} "
          f"ms, decode {res['decode_tok_s']:.1f} tok/s, peak {peak:.2f} GB, "
          f"no kernel launched ({card})")
    del res
    for flag, match in ((["--continuous", "--requests", "2"],
                         "continuous batching"),
                        (["--split-cut", str(PG_T_CUT), "--wire-dtype",
                          "int8"], "tied embeddings")):
        try:
            serve.main(_pg_argv(*flag))
        except ValueError as e:
            if match not in str(e):
                fail(f"{PG_ARCH} {flag[0]}: raised {e!r}")
            print(f"{PG_ARCH} {' '.join(flag)}: refused ({e})")
        else:
            fail(f"{PG_ARCH} {flag[0]}: served; the reference refuses it")
    prefill_ms, tok_s, prefill_peak, pcalls = paligemma_prefill(
        torch, ops, fa, dev, card)

    _free_card(torch, f"{PG_ARCH} training")
    _reset_counts(ops, *counters)
    with codec_calls(wc) as ccalls, flash_calls(fa) as tcalls:
        res = train.main(["--arch", PG_ARCH, "--size", "full",
                          "--pipeline-stages", "2", "--pipeline-k", str(T_K),
                          "--batch", str(T_BATCH), "--seq", str(T_SEQ),
                          "--steps", str(T_STEPS), "--seed", str(SEED),
                          "--wire-dtype", "int8", "--log-every", "1"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    _check_train_launches(PG_ARCH, launches, {
        "flash": (dict(fa.ROUTES), {"mma": PG_T_LAUNCHES["flash_attention"]}),
        "flash backward": (dict(fa.BWD_ROUTES),
                           {"mma": PG_T_LAUNCHES["flash_attention_bwd"]})},
        PG_T_LAUNCHES)
    mb = T_BATCH // T_K
    want = {(kern, mb, 8, PG_T_ROWS, PG_T_ROWS, 256, True, "bfloat16",
             PG_PATCHES): PG_T_LAUNCHES[kern]
            for kern in ("flash_attention", "flash_attention_bwd")}
    if dict(tcalls) != want:
        fail(f"train {PG_ARCH}: flash calls {dict(tcalls)} != {want}")
    n, up, down = check_training_run(torch, protocol, dev, res,
                                     f"train {PG_ARCH}", "int8",
                                     T_BATCH * PG_T_ROWS)
    if (up, down) != (PG_HOP_BYTES, PG_HOP_BYTES):
        fail(f"train {PG_ARCH}: billed {up} / {down} B a step, expected "
             f"{PG_HOP_BYTES} each way (768 rows a sequence)")
    check_codec_calls(wc, f"{PG_ARCH} training path", launches, ccalls,
                      dict(wc.ROUTES))
    cwant = {(kern, mb * PG_T_ROWS, cfg.d_model, "bfloat16", "int8"):
             PG_T_LAUNCHES[kern] for kern in ("wire_encode", "wire_decode")}
    if dict(ccalls) != cwant:
        fail(f"train {PG_ARCH}: codec calls {dict(ccalls)} != {cwant}")
    if res["pipeline"].microbatches != T_K or cfg.num_layers \
            // res["pipeline"].num_stages != PG_T_CUT:
        fail(f"train {PG_ARCH}: the pipeline is not S 2, k {T_K}, cut at "
             f"{PG_T_CUT}")
    for r in res["rows"]:
        print(f"main path train {PG_ARCH} int8 step {r['step']}: loss "
              f"{r['loss']:.5f}, {r['step_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} "
              f"GB, hop up {r['hop_bytes_up']} B, down "
              f"{r['hop_bytes_down']} B (billed {up:.0f} each way; at 512 "
              f"rows 8,519,680) ({card})")
    print(f"train {PG_ARCH}: all {n} parameter tensors changed; launches "
          f"{json.dumps(launches, sort_keys=True)}; flash by (kernel, B, H, "
          f"Sq, Skv, dh, causal, dtype, prefix): " + "; ".join(
              f"{k[:9]}: {v}" for k, v in sorted(tcalls.items())))
    rows = res["rows"]
    profile_training_step(torch, res, {"flash forward": "flash_fwd",
                                       "flash backward": "flash_bwd"})
    del res
    torch.cuda.empty_cache()
    return {"cli": cli, "prefill_ms": prefill_ms, "tok_s": tok_s,
            "prefill_peak": prefill_peak, "prefill_calls": pcalls,
            "train_rows": rows, "train_launches": launches,
            "train_calls": tcalls}


def run_hybrid_training(torch, ops, train, protocol, dev, card):
    """Training of recurrentgemma-2b at full width through the training
    CLI (k 2 by accumulation, 4 x 4096, 3 steps): every loss finite, every
    parameter moved, exactly ``RT_LAUNCHES``, every flash forward and
    every flash backward (dh 256, window 2048 < S) on "mma".
    One more step traced.  Returns (rows, launches)."""
    from repro_torch.kernels import flash_attention as fa
    torch.cuda.synchronize()
    ops.reset_launches()
    fa.ROUTES.clear()
    fa.BWD_ROUTES.clear()
    res = train.main(["--arch", RG_ARCH, "--size", "full", "--microbatches",
                      str(RT_K), "--batch", str(RT_BATCH), "--seq",
                      str(RT_SEQ), "--steps", str(T_STEPS), "--seed",
                      str(SEED), "--log-every", "1"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    _check_train_launches(RG_ARCH, launches, {
        "flash": (dict(fa.ROUTES), {"mma": RT_LAUNCHES["flash_attention"]}),
        "flash backward": (dict(fa.BWD_ROUTES),
                           {"mma": RT_LAUNCHES["flash_attention_bwd"]})},
        RT_LAUNCHES)
    n, _, _ = check_training_run(torch, protocol, dev, res,
                                 f"train {RG_ARCH}", "none")
    rows = res["rows"]
    print(f"train {RG_ARCH} k {RT_K}: losses "
          f"{[round(r['loss'], 5) for r in rows]} (through the SIMT dh-256 "
          f"backward {RT_LOSSES_SIMT[0]} -> {RT_LOSSES_SIMT[1]}: first "
          f"{rows[0]['loss'] - RT_LOSSES_SIMT[0]:+.5f}, last "
          f"{rows[-1]['loss'] - RT_LOSSES_SIMT[1]:+.5f}), all {n} parameter "
          f"tensors changed; launches {json.dumps(launches, sort_keys=True)}"
          f"; peak {max(r['peak_gb'] for r in rows):.2f} GB on {card}")
    profile_training_step(torch, res, {"rglru forward": "rglru_chunked<",
                                       "rglru backward": "rglru_chunked_bwd",
                                       "flash backward": "flash_bwd",
                                       "flash backward's group sum":
                                       "bwd256::sum_groups"},
                          shape=(RT_BATCH, RT_SEQ), microbatches=RT_K)
    del res
    torch.cuda.empty_cache()
    return rows, launches


@contextlib.contextmanager
def recorded_steps(train, record):
    """While the block runs, the training CLI's step function calls
    ``record(state, meter)`` after each step (inside the CLI's timed
    step: one norm and one all-finite test over the EF buffer)."""
    make = train.make_lm_train_step

    def wrap(*args, **kw):
        step = make(*args, **kw)

        def recorded(state, batch):
            state, mets = step(state, batch)
            record(state, step.meter)
            return state, mets
        recorded.meter = step.meter
        return recorded
    train.make_lm_train_step = wrap
    try:
        yield
    finally:
        train.make_lm_train_step = make


def ef_live_slots(torch, spec):
    """The EF buffer's slots the hops write, [(c + 1) mod S, sigma(m) +
    c] for chunk boundaries c < S*v - 1 (parallel/pipeline.py)."""
    from repro_torch.parallel.pipeline import _sigma, wire_ef_ticks
    s, v = spec.num_stages, spec.virtual_stages
    live = torch.zeros((s, wire_ef_ticks(spec)), dtype=torch.bool)
    for m in range(spec.microbatches):
        for c in range(s * v - 1):
            live[(c + 1) % s, _sigma(m, s, v) + c] = True
    return live


def check_ef_buffer(torch, name, ef, spec):
    """An EF buffer after a run: finite, nonzero in exactly the live
    slots of ``spec``'s schedule and zero elsewhere.  Returns the number
    of live slots and the buffer's norm."""
    if not bool(torch.isfinite(ef).all()):
        fail(f"{name}: the EF buffer holds non-finite values")
    live = (ef.flatten(2).abs().amax(-1) > 0).cpu()
    want = ef_live_slots(torch, spec)
    if not torch.equal(live, want):
        fail(f"{name}: EF slots live {live.int().tolist()}, expected "
             f"{want.int().tolist()}")
    return int(want.sum()), float(torch.linalg.vector_norm(ef))


def run_qwen_topk_training(torch, ops, train, protocol, dev, wc, card,
                           v1_first_loss):
    """C2P2SL training of qwen1.5-4b at full width through the training
    CLI with v = 2 and the top-k gradient hop (``TK_WIRE``), after the
    int8 v = 1 run's state is freed: hop bytes a step ``TK_UP`` /
    ``TK_DOWN``, equal to the bills; 12 hops each way a step; exactly
    ``TK_LAUNCHES``, every codec call at [1024, 2560] bf16 int8 (the
    top-k backward launches none), every flash on "mma"; the EF buffer
    ``TK_EF_SHAPE`` finite after every step and live in exactly its 12
    slots; the first loss within 5e-2 relative of the v = 1 run's.  Then
    one more step traced (``profile_training_step``: the top-k kernels'
    device time on lines of their own).  Returns (rows, launches, codec
    calls by shape)."""
    from repro_torch.kernels import flash_attention as fa
    name = f"train {ARCH} v {TK_V} {TK_WIRE}"
    torch.cuda.synchronize()
    ops.reset_launches()
    fa.ROUTES.clear()
    fa.BWD_ROUTES.clear()
    wc.ROUTES.clear()
    seen, held = [], torch.cuda.memory_allocated() / 1e9

    def record(state, meter):
        ef = state["wire_ef"]
        seen.append((bool(torch.isfinite(ef).all()),
                     float(torch.linalg.vector_norm(ef)), meter.hops_up,
                     meter.hops_down))
    with codec_calls(wc) as calls, recorded_steps(train, record):
        res = train.main(_train_argv(TK_WIRE, ARCH, TK_V))
    torch.cuda.synchronize()
    launches, routes = dict(ops.LAUNCHES), dict(fa.ROUTES)
    bwd_routes = dict(fa.BWD_ROUTES)
    n, up, down = check_training_run(torch, protocol, dev, res, name,
                                     TK_WIRE)
    if (up, down) != (TK_UP, TK_DOWN):
        fail(f"{name}: billed {up} / {down} != {TK_UP} / {TK_DOWN}")
    if launches != TK_LAUNCHES:
        fail(f"{name}: launches {launches} != {TK_LAUNCHES}")
    if routes != {"mma": TK_LAUNCHES["flash_attention"]} or bwd_routes != {
            "mma": TK_LAUNCHES["flash_attention_bwd"]}:
        fail(f"{name}: flash routes {routes}, backward {bwd_routes}")
    check_codec_calls(wc, name, launches, calls, dict(wc.ROUTES))
    model = res["model"]
    want = {(kern, T_BATCH // T_K * T_SEQ, model.cfg.d_model,
             str(model.dtype).split(".")[-1], "int8"): TK_LAUNCHES[kern]
            for kern in ("wire_encode", "wire_decode")}
    if dict(calls) != want:
        fail(f"{name}: codec calls {dict(calls)} != {want}")
    for i, (finite, norm, hu, hd) in enumerate(seen, 1):
        if not finite or (hu, hd) != (TK_HOPS, TK_HOPS):
            fail(f"{name} step {i}: EF finite {finite} (norm {norm}), hops "
                 f"up {hu} down {hd} != {TK_HOPS}")
    ef = res["state"]["wire_ef"]
    if tuple(ef.shape) != TK_EF_SHAPE or ef.dtype != torch.float32:
        fail(f"{name}: EF buffer {tuple(ef.shape)} {ef.dtype}")
    live, ef_norm = check_ef_buffer(torch, name, ef, res["pipeline"])
    losses = [r["loss"] for r in res["rows"]]
    if abs(losses[0] - v1_first_loss) > 5e-2 * abs(v1_first_loss):
        fail(f"{name}: first loss {losses[0]} not within 5e-2 of the v = 1 "
             f"int8 run's {v1_first_loss}")
    peak = max(r["peak_gb"] for r in res["rows"])
    print(f"{name}: losses {[round(x, 5) for x in losses]} (first beside "
          f"the v = 1 int8 run's {v1_first_loss:.5f}: "
          f"{abs(losses[0] - v1_first_loss) / abs(v1_first_loss):.2e} "
          f"relative, tol 5e-2), all {n} parameter tensors changed, hop "
          f"bytes per step up {up:.0f} down {down:.0f} == billed, {TK_HOPS} "
          f"hops each way a step; launches "
          f"{json.dumps(launches, sort_keys=True)}; EF buffer "
          f"{list(TK_EF_SHAPE)} f32 live in {live} of "
          f"{TK_EF_SHAPE[0] * TK_EF_SHAPE[1]} slots, norm {ef_norm:.6e} (after steps: "
          f"{[round(x[1], 6) for x in seen]}); peak {peak:.2f} GB on {card}, "
          f"{held:.3f} GB of it held by earlier phases")
    del ef
    profile_training_step(torch, res, {
        "flash forward": "flash_fwd", "flash backward": "flash_bwd",
        "top-k select": "radixFindKthValues", "top-k gather": "TopK",
        "top-k sort": "SortKV", "top-k scatter": "scatter"})
    rows = res["rows"]
    del res, model
    torch.cuda.empty_cache()
    return rows, launches, calls


def run_qwen_compressed(torch, ops, protocol, dev, wc, card):
    """qwen1.5-4b's widths with the depth cut to ``TC_LAYERS``, the v = 2
    top-k spec and ``make_lm_train_step(compress=True)`` (the CLI has no
    depth flag), 3 AdamW steps as the CLI runs them: losses finite, hop
    bytes equal to the bills, the EF buffer live in its 12 slots,
    ``error_fb`` finite and nonzero, and the codec launched once more a
    parameter leaf a step each way, on f32 [n / 256, 256].  Returns
    (rows, launches, the codec calls of the gradients, the hops' codec
    calls)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenTaskConfig, token_batches
    from repro_torch.models.lm import LM
    from repro_torch.parallel.pipeline import PipelineSpec, wire_ef_zeros
    from repro_torch.parallel.steps import make_lm_train_step
    from repro_torch.training.compress import init_error_fb
    from repro_torch.training.optim import adamw, cosine_schedule
    from repro_torch.utils.trees import tree_leaves
    name = f"train {ARCH} cut to {TC_LAYERS} layers, compressed"
    cfg = dataclasses.replace(get_arch(ARCH).full, num_layers=TC_LAYERS)
    spec = PipelineSpec(2, T_K, virtual_stages=TK_V, wire_dtype=TK_WIRE)
    model = LM(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        master=True)
    leaves = tree_leaves(params)
    n_leaves, n_params = len(leaves), sum(p.numel() for p in leaves)
    del leaves
    opt = adamw(cosine_schedule(3e-4, warmup=20, total=T_STEPS),
                grad_clip=1.0)
    state = {"params": params, "opt_state": opt.init(params), "step": 0,
             "wire_ef": wire_ef_zeros(cfg, spec, T_BATCH, T_SEQ, dev),
             "error_fb": init_error_fb(params)}
    del params
    step = make_lm_train_step(model, opt, pipeline=spec, compress=True)
    batches = token_batches(TokenTaskConfig(vocab=cfg.vocab), T_BATCH,
                            T_SEQ, seed=SEED)
    up, down = billed_step_bytes(protocol, spec, cfg.d_model,
                                 model.dtype.itemsize)
    ops.reset_launches()
    wc.ROUTES.clear()
    rows = []
    with codec_calls(wc) as calls:
        for i in range(T_STEPS):
            batch = {n: torch.as_tensor(a, device=dev)
                     for n, a in next(batches).items()}
            step.meter.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, mets = step(state, batch)
            loss = float(mets["loss"])
            torch.cuda.synchronize()
            rows.append((loss, (time.perf_counter() - t0) * 1e3,
                         torch.cuda.max_memory_allocated() / 1e9))
            if not math.isfinite(loss):
                fail(f"{name}: step {i + 1} loss {loss}")
            if (step.meter.up, step.meter.down) != (up, down):
                fail(f"{name} step {i + 1}: hop bytes {step.meter.up} / "
                     f"{step.meter.down} != billed {up} / {down}")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_codec_calls(wc, name, launches, calls, dict(wc.ROUTES))
    hops = TK_HOPS * T_STEPS
    want = {"flash_attention": 2 * TC_LAYERS * T_K * T_STEPS,
            "flash_attention_bwd": TC_LAYERS * T_K * T_STEPS,
            "wire_encode": hops + n_leaves * T_STEPS,
            "wire_decode": hops + n_leaves * T_STEPS}
    if launches != want:
        fail(f"{name}: launches {launches} != {want}")
    grads = collections.Counter({k: v for k, v in calls.items()
                                 if k[2] == 256})
    hop_calls = collections.Counter({k: v for k, v in calls.items()
                                     if k[2] != 256})
    for kern in ("wire_encode", "wire_decode"):
        n = sum(v for k, v in grads.items() if k[0] == kern)
        if n != n_leaves * T_STEPS or any(k[3] != "float32" for k in grads):
            fail(f"{name}: {kern} on the gradients {dict(grads)}, expected "
                 f"{n_leaves} f32 calls a step")
    fb = tree_leaves(state["error_fb"])
    if not all(bool(torch.isfinite(t).all()) for t in fb) or not any(
            bool(t.any()) for t in fb):
        fail(f"{name}: error_fb not finite or all zero")
    fb_norm = math.sqrt(sum(float(torch.linalg.vector_norm(t)) ** 2
                            for t in fb))
    live, ef_norm = check_ef_buffer(torch, name, state["wire_ef"], spec)
    print(f"{name}: {n_params / 1e9:.3f} B parameters in {n_leaves} "
          f"tensors; losses {[round(r[0], 5) for r in rows]}; step ms "
          f"{[round(r[1], 1) for r in rows]}; peak "
          f"{max(r[2] for r in rows):.2f} GB on {card}; hop bytes per step "
          f"{up:.0f} / {down:.0f} == billed; error_fb norm {fb_norm:.6e}; "
          f"EF buffer live in {live} slots, norm {ef_norm:.6e}; launches "
          f"{json.dumps(launches, sort_keys=True)}; the gradients' codec "
          f"calls by (kernel, rows, d, dtype, wire): "
          + "; ".join(f"{k}: {v}" for k, v in sorted(grads.items())))
    del state, fb, step
    torch.cuda.empty_cache()
    return rows, launches, grads, hop_calls


@contextlib.contextmanager
def host_rss_peak(interval_s: float = 0.05):
    """The process's peak resident set while the block runs, sampled from
    /proc/self/statm every ``interval_s`` by a thread.  Yields a dict
    whose ``"gb"`` holds the peak when the block ends."""
    import threading
    page = os.sysconf("SC_PAGE_SIZE")
    out, stop = {"gb": 0.0}, threading.Event()

    def sample():
        while True:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * page / 1e9
            out["gb"] = max(out["gb"], rss)
            if stop.wait(interval_s):
                return
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()


def leaf_checksums(torch, tree, chunk: int = 1 << 24):
    """Per leaf of f32 tensors: the sums of its 32-bit patterns, plain and
    weighted by position (mod 65521, plus 1), in int64 (wrapping), taken
    on the card chunk by chunk.  Equal checksums for bit-equal leaves;
    one flipped bit changes both sums."""
    from repro_torch.utils.trees import tree_leaves
    out = []
    for t in tree_leaves(tree):
        if t.dtype != torch.float32:
            fail(f"checksum of a {t.dtype} leaf: f32 master weights only")
        bits = t.detach().reshape(-1).view(torch.int32)
        s1 = s2 = 0
        for c in range(0, bits.numel(), chunk):
            b = bits[c:c + chunk].to(torch.int64)
            w = torch.arange(c, c + b.numel(), device=b.device) % 65521 + 1
            s1 += int(b.sum())
            s2 += int((b * w).sum())
        out.append((s1, s2))
    return out


def _state_bytes(torch, state):
    """Bytes of a train state's arrays as the checkpoint stores them (bf16
    widened to f32; the int step as int32)."""
    from repro_torch.utils.trees import tree_leaves
    n = 0
    for t in tree_leaves(state):
        if isinstance(t, torch.Tensor):
            n += t.numel() * (4 if t.dtype == torch.bfloat16
                              else t.element_size())
        else:
            n += 4
    return n


def _reset_counters(torch, ops, fa, wc):
    """Zero the launch and route counters before a run."""
    torch.cuda.synchronize()
    ops.reset_launches()
    fa.ROUTES.clear()
    fa.BWD_ROUTES.clear()
    wc.ROUTES.clear()


def _check_run_launches(name, ops, fa, wc, steps, calls, d,
                        layers=Q_LAYERS):
    """A run's exact launches: each step's flash forwards and backwards
    (``RP_FLASH`` at 40 layers, in proportion at ``layers``), all on
    "mma"; the codec's calls by shape, ``steps`` maps each codec to its
    step count (``RP_CODEC`` calls a step), every one at [T_BATCH / T_K *
    T_SEQ, d] bf16 int8, every decode on "warp256".  Returns the
    launches."""
    n = sum(steps.values())
    codec = sum(RP_CODEC[w] * s for w, s in steps.items())
    want = {k: v * n * layers // Q_LAYERS for k, v in RP_FLASH.items()}
    want.update(wire_encode=codec, wire_decode=codec)
    launches = dict(ops.LAUNCHES)
    _check_train_launches(name, launches, {
        "flash": (dict(fa.ROUTES), {"mma": want["flash_attention"]}),
        "flash backward": (dict(fa.BWD_ROUTES),
                           {"mma": want["flash_attention_bwd"]})}, want)
    check_codec_calls(wc, name, launches, calls, dict(wc.ROUTES))
    shape = {(k, T_BATCH // T_K * T_SEQ, d, "bfloat16", "int8"): codec
             for k in ("wire_encode", "wire_decode")}
    if dict(calls) != shape:
        fail(f"{name}: codec calls {dict(calls)} != {shape}")
    return launches


@contextlib.contextmanager
def depth_cut(arch: str, layers: int):
    """While the block runs, the registry's ``arch`` has its FULL config's
    depth cut to ``layers`` (widths kept): the CLIs, which have no depth
    flag, then run it."""
    import dataclasses

    from repro_torch import configs
    spec = configs.ARCHS[arch]
    configs.ARCHS[arch] = dataclasses.replace(
        spec, full=dataclasses.replace(spec.full, num_layers=layers))
    try:
        yield
    finally:
        configs.ARCHS[arch] = spec


def run_ckpt_resume(torch, ops, train, fa, wc, card, ckpt_dir):
    """Part (a) of the phase "qwen1.5-4b checkpoint, resume and replan",
    at qwen1.5-4b's widths with ``CK_LAYERS`` layers (``depth_cut``):
    run A trains 3 int8 steps and checkpoints at step 2 (exactly one
    checkpoint on disk); run B, the same flags, resumes there and trains
    step 3.  B's step-3 loss equals A's bit for bit, and so does every
    leaf's checksum of the final f32 master weights (taken from A before
    B runs).  Prints the disk, the checkpoint's bytes against
    ``CKPT_STATE_GB`` by the count, the save and restore seconds and the
    peak host RSS.  Returns (launches, codec calls by shape)."""
    from repro_torch.training import checkpoint as ck
    name = f"{ARCH} cut to {CK_LAYERS} layers, checkpoint and resume"
    du = shutil.disk_usage(ckpt_dir)
    with open("/proc/self/statm") as f:
        rss0 = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
    print(f"{name}: host RSS {rss0:.2f} GB at the start; checkpoint directory on a disk of {du.total / 1e9:.1f} "
          f"GB, {du.free / 1e9:.1f} GB free ({CKPT_STATE_GB} GB needed)")
    if du.free < CKPT_STATE_GB * 1.05e9:
        fail(f"{name}: {du.free / 1e9:.1f} GB free, the checkpoint takes "
             f"{CKPT_STATE_GB} GB: cut the depth")
    argv = _train_argv("int8", ARCH) + ["--ckpt-dir", ckpt_dir]
    _reset_counters(torch, ops, fa, wc)
    with codec_calls(wc) as calls, host_rss_peak() as rss, \
            depth_cut(ARCH, CK_LAYERS):
        a = train.main(argv + ["--ckpt-every", "2"])
        torch.cuda.synchronize()
        on_disk = sorted(os.listdir(ckpt_dir))
        if on_disk != ["step_2"]:
            fail(f"{name}: run A left {on_disk}, expected ['step_2']")
        npz = os.path.join(ckpt_dir, "step_2", "proc_0.npz")
        file_bytes = os.path.getsize(npz)
        count = _state_bytes(torch, a["state"])
        arrays = len(ck.manifest(ckpt_dir, 2)["arrays"])
        a_loss = a["rows"][2]["loss"]
        a_sums = leaf_checksums(torch, a["state"]["params"])
        save_s = a["ckpt"]["save_s"][2]
        rss_a = rss["gb"]
        del a
        torch.cuda.empty_cache()
        b = train.main(argv + ["--ckpt-every", "0"])
        torch.cuda.synchronize()
    if b["model"].cfg.num_layers != CK_LAYERS:
        fail(f"{name}: the run had {b['model'].cfg.num_layers} layers")
    launches = _check_run_launches(name, ops, fa, wc, {"int8": 4}, calls,
                                   b["model"].cfg.d_model, CK_LAYERS)
    if sorted(os.listdir(ckpt_dir)) != ["step_2"]:
        fail(f"{name}: run B changed the checkpoint directory")
    if b["ckpt"]["resumed_from"] != 2 or [r["step"] for r in b["rows"]] \
            != [3]:
        fail(f"{name}: run B resumed from {b['ckpt']['resumed_from']}, "
             f"trained steps {[r['step'] for r in b['rows']]}")
    b_loss = b["rows"][0]["loss"]
    b_sums = leaf_checksums(torch, b["state"]["params"])
    differ = [i for i, (x, y) in enumerate(zip(a_sums, b_sums)) if x != y]
    if b_loss != a_loss or differ or len(a_sums) != len(b_sums):
        fail(f"{name}: resumed step 3 loss {b_loss!r} vs uninterrupted "
             f"{a_loss!r}; {len(differ)} of {len(a_sums)} master-weight "
             f"leaves differ (leaves {differ[:8]})")
    print(f"{name}: step 3 loss {b_loss!r} resumed == {a_loss!r} "
          f"uninterrupted, bit for bit; all {len(a_sums)} master-weight "
          f"leaf checksums equal; one checkpoint on disk at a time "
          f"(step_2): {file_bytes} B in the file, {count} B of {arrays} "
          f"arrays by the count ({count / 1e9:.2f} GB against "
          f"{CKPT_STATE_GB} GB); save {save_s:.1f} s, restore "
          f"{b['ckpt']['restore_s']:.1f} s (a warm read: the file was "
          f"just written); peak host RSS {rss['gb']:.2f} GB ({rss_a:.2f} GB "
          f"through run A and its save); launches "
          f"{json.dumps(launches, sort_keys=True)} ({card})")
    del b
    torch.cuda.empty_cache()
    return launches, calls


def run_replan(torch, ops, train, protocol, fa, wc, card, work_dir):
    """Part (b) of the phase: ``RP_STEPS`` steps at --pipeline-k auto
    --virtual-stages 1 --wire-dtype int8 with the hints ``RP_HINTS`` and
    the bandwidth trace ``RP_TRACE``: the planned cell ``RP_PLAN``, one
    switch ``RP_SWITCH``, "2 cell compile(s)", finite losses, every step's
    hop bytes equal to its own cell's bill, the EF buffer created at the
    switch and live in exactly its slots.  Returns (launches, codec calls
    by shape)."""
    import io

    from repro_torch.analysis.autotune import Plan
    from repro_torch.parallel.pipeline import PipelineSpec
    name = f"{ARCH} replan"
    paths = {n: os.path.join(work_dir, f"{n}.json")
             for n in ("hints", "trace", "plan")}
    with open(paths["hints"], "w") as f:
        json.dump({"planner_hints": RP_HINTS}, f)
    with open(paths["trace"], "w") as f:
        json.dump(RP_TRACE, f)
    argv = ["--arch", ARCH, "--size", "full", "--pipeline-stages", "2",
            "--pipeline-k", "auto", "--virtual-stages", "1",
            "--wire-dtype", "int8", "--plan-hints", paths["hints"],
            "--replan", RP_SPEC, "--replan-trace", paths["trace"],
            "--plan-out", paths["plan"], "--batch", str(T_BATCH), "--seq",
            str(T_SEQ), "--steps", str(RP_STEPS), "--seed", str(SEED),
            "--log-every", "1"]
    _reset_counters(torch, ops, fa, wc)
    out = io.StringIO()
    with codec_calls(wc) as calls, contextlib.redirect_stdout(out):
        res = train.main(argv)
        torch.cuda.synchronize()
    print(out.getvalue(), end="")
    steps, old, new = RP_SWITCH
    launches = _check_run_launches(
        name, ops, fa, wc, {"int8": steps, TK_WIRE: RP_STEPS - steps}, calls,
        res["model"].cfg.d_model)
    with open(paths["plan"]) as f:
        doc = json.load(f)
    got = [(s["step"], Plan.from_json(s["old"]), Plan.from_json(s["new"]))
           for s in doc["replan"]["switches"]]
    if Plan.from_json(doc["plan_cell"]) != Plan(*RP_PLAN) or got != [
            (steps, Plan(*old), Plan(*new))]:
        fail(f"{name}: planned {doc['plan_cell']}, switches {got}; "
             f"expected {RP_PLAN} and {RP_SWITCH}")
    if "2 cell compile(s)" not in out.getvalue():
        fail(f"{name}: no '2 cell compile(s)' in the launcher's output")
    d, act = res["model"].cfg.d_model, res["model"].dtype.itemsize
    for row in res["rows"]:
        cell = Plan(*row["cell"])
        want = billed_step_bytes(protocol, PipelineSpec.from_plan(cell), d,
                                 act)
        if not math.isfinite(row["loss"]) or (
                row["hop_bytes_up"], row["hop_bytes_down"]) != want or \
                cell != Plan(*(old if row["step"] <= steps else new)):
            fail(f"{name} step {row['step']}: loss {row['loss']}, cell "
                 f"{cell}, hop bytes {row['hop_bytes_up']} / "
                 f"{row['hop_bytes_down']} != billed {want}")
    spec = res["pipeline"]
    live, ef_norm = check_ef_buffer(torch, name, res["state"]["wire_ef"],
                                    spec)
    sw = doc["replan"]["switches"][0]
    plan = doc["plan"]
    peak = max(r["peak_gb"] for r in res["rows"])
    print(f"{name}: planned {Plan(*RP_PLAN)} [{doc['k_source']}], modeled "
          f"{plan['wall_s'] * 1e3:.3f} ms/batch; switch at step {steps} "
          f"to {Plan(*new)}, modeled {sw['old_wall_s'] * 1e3:.3f} -> "
          f"{sw['new_wall_s'] * 1e3:.3f} ms/batch ({sw['gain']:.4f} gain); "
          f"losses {[round(r['loss'], 5) for r in res['rows']]}; hop bytes "
          f"a step {[(r['hop_bytes_up'], r['hop_bytes_down']) for r in res['rows']]}"
          f" == billed; EF buffer live in {live} slots, norm {ef_norm:.6e}; "
          f"step ms {[round(r['step_ms'], 1) for r in res['rows']]}; peak "
          f"{peak:.2f} GB; launches {json.dumps(launches, sort_keys=True)} "
          f"({card})")
    del res
    torch.cuda.empty_cache()
    return launches, calls


def run_ckpt_phase(torch, ops, train, protocol, card):
    """The phase "qwen1.5-4b checkpoint, resume and replan" (parts (a)
    and (b), their launches checked exactly, part (c)), in a directory
    of the checkout deleted at the end.  Returns (launches, codec calls
    by shape) of both parts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wire_codec as wc
    ckpt_dir = os.path.join(ROOT, "ckpts", "chip_smoke")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    try:
        a_launches, a_calls = run_ckpt_resume(torch, ops, train, fa, wc,
                                              card, ckpt_dir)
        shutil.rmtree(ckpt_dir)
        os.makedirs(ckpt_dir)
        b_launches, b_calls = run_replan(torch, ops, train, protocol, fa, wc,
                                         card, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return (dict(collections.Counter(a_launches)
                 + collections.Counter(b_launches)), a_calls + b_calls)


def run_c2p2sl(torch, dev):
    """One full-width make_c2p2sl_step with 2 UEs and a ragged shard_batch,
    its loss beside the pipelined (wire none) loss on the same weights and
    batch."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenTaskConfig, token_batches
    from repro_torch.models.lm import LM
    from repro_torch.parallel.pipeline import (PipelineSpec,
                                               make_pipelined_loss)
    from repro_torch.sl.c2p2sl import (init_sl_state, make_c2p2sl_step,
                                       shard_batch)
    from repro_torch.sl.split import lm_split
    from repro_torch.training.optim import adamw
    cfg = get_arch(T_ARCH).full
    model = LM(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        master=True)
    batch = {n: torch.as_tensor(a, device=dev) for n, a in next(
        token_batches(TokenTaskConfig(vocab=cfg.vocab), T_BATCH, T_SEQ,
                      seed=SEED)).items()}
    with torch.no_grad():
        pipe_loss, _ = make_pipelined_loss(
            model, PipelineSpec(num_stages=2, microbatches=T_K))(params,
                                                                  batch)
    spec = lm_split(model, cfg.num_layers // 2)
    opt = adamw(1e-4, grad_clip=1.0)
    st = init_sl_state(spec, params, opt)
    del params
    tree = {"ue_params": st.ue_params, "bs_params": st.bs_params,
            "opt_state_ue": st.opt_state_ue, "opt_state_bs": st.opt_state_bs,
            "step": st.step}
    del st
    xs, ys = shard_batch(batch["tokens"], batch["labels"], np.array([5, 3]),
                         T_K)
    sizes = [[int(x.shape[0]) for x in xi] for xi in xs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree, mets = make_c2p2sl_step(spec, opt, T_K)(tree, xs, ys)
    loss = float(mets["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(loss):
        fail(f"c2p2sl step loss {loss}")
    print(f"c2p2sl full width, 2 UEs b=[5, 3] k={T_K} micro-batch sizes "
          f"{sizes}: loss {loss:.6f} beside the pipelined none loss "
          f"{float(pipe_loss):.6f} on the same weights and batch (bf16, no "
          f"equality asked); step {ms:.1f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del tree
    torch.cuda.empty_cache()


def _max_dist(a, b, side):
    """Largest |a - b| over the leaves of one side of two parameter
    snapshots (lists of tensors by side)."""
    return max(float((u.detach() - v.detach().to(u.device)).abs().max())
               for u, v in zip(a[side], b[side]))


def run_wireless(torch, ops, dev, card):
    """The paper's Algorithm 1 on the Table I fleet, then ResNet-18 split
    training of all four schemes on the card from its plan (phase
    "wireless C2P2SL").  Returns the per-scheme rows."""
    try:
        import scipy
    except ImportError:
        fail("scipy is missing: the port's core/ao.py solves P3 and P5 "
             "with scipy.optimize")
    print(f"scipy {scipy.__version__}")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.resnet18_cifar10 import FULL, SMOKE
    from repro_torch.core import algorithm1, resnet18_profile
    from repro_torch.core.ao import feasible_l
    from repro_torch.launch import wireless_sl as wsl
    from repro_torch.models import resnet
    from repro_torch.sl.split import resnet_split
    from repro_torch.utils.trees import tree_leaves, tree_map
    from repro_torch.wireless import sample_fleet

    prof, fleet = resnet18_profile(), sample_fleet(W_UES, seed=SEED)
    t0 = time.perf_counter()
    res = algorithm1(prof, fleet, batch=FULL.batch)
    plan_s = time.perf_counter() - t0
    plan, frame = res.plan, fleet.channel.frame_s
    times = wsl.scheme_times(prof, fleet, plan, FULL.batch)
    first = wsl.scheme_times(prof, fleet, algorithm1(
        prof, fleet, batch=FULL.batch, max_iters=1).plan, FULL.batch)
    print(f"wireless plan ({plan_s:.2f} s host): l={plan.l} "
          f"({prof.layer_names[plan.l - 1]}), k={plan.k}, v={plan.v}, b="
          f"{plan.b.tolist()}, tau={plan.tau.tolist()}, bubble-rate history "
          f"{[round(h, 6) for h in res.history]}")
    print("wireless simulated batch seconds (the Table I system model, not "
          "the card): " + ", ".join(f"{n} {times[n]:.4f}" for n in W_SCHEMES)
          + f"; C2P2SL after AO's first iteration {first['C2P2SL']:.4f}")
    if not ((plan.b >= 0).all() and plan.b.sum() == FULL.batch
            and (plan.tau >= 0).all() and (plan.tau[plan.b > 0] > 0).all()
            and plan.tau.sum() <= frame * (1 + 1e-9)
            and plan.l in feasible_l(prof, fleet, plan.b)):
        fail(f"Algorithm 1's plan is infeasible: {plan}")
    # the bubble rate is not monotone over AO's iterations (0.0542 first,
    # 0.0784 last on this fleet); the simulated makespan it trades is
    if not times["C2P2SL"] <= first["C2P2SL"] * (1 + 1e-12) \
            or not times["C2P2SL"] < times["PSL"]:
        fail(f"the plan's simulated C2P2SL time {times['C2P2SL']} is above "
             f"its first iteration's {first['C2P2SL']} or PSL's "
             f"{times['PSL']}")

    alloc = wsl.integer_allocation(plan.b, FULL.batch)
    k = wsl.train_k(plan.k, alloc)
    print(f"wireless training: ResNet-18 f32, batch {FULL.batch} split "
          f"{alloc.tolist()}, cut {plan.l}, C2P2SL k={k}, {W_STEPS} steps a "
          f"scheme, SGD 0.05 / momentum 0.9")
    params = resnet.init_resnet18(
        torch.Generator(device=dev).manual_seed(SEED))
    init = dict(zip(("ue_params", "bs_params"), map(
        tree_leaves, resnet_split(plan.l).split_params(params))))
    rows, snaps, traced = {}, {}, {}
    ops.reset_launches()
    for scheme in W_SCHEMES:
        rows[scheme] = []
        steps = wsl.train_scheme(scheme, params, plan.l, alloc, k, FULL.batch,
                                 W_STEPS + 1, SEED, dev)
        for row, tree in itertools.islice(steps, W_STEPS):
            rows[scheme].append(row)
            if row["step"] in (1, W_STEPS):
                snaps[scheme, row["step"]] = {
                    side: [t.detach().clone() for t in tree_leaves(tree[side])]
                    for side in ("ue_params", "bs_params")}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            row, _ = next(steps)          # one more step, traced
        traced[scheme] = (prof, row["step_ms"])
        del steps
        last = snaps[scheme, W_STEPS]
        if min(float((a - b).abs().max()) for side in init
               for a, b in zip(last[side], init[side])) == 0.0:
            fail(f"{scheme}: a parameter tensor did not move in "
                 f"{W_STEPS} steps")
        del tree
    if ops.LAUNCHES:
        fail(f"the ResNet path has no hand-written kernel, yet launched "
             f"{dict(ops.LAUNCHES)}")
    eq = max(_max_dist(snaps["C2P2SL", 1], snaps["PSL", 1], s)
             for s in ("ue_params", "bs_params"))
    # at batch 512 one step of EPSL moves the UE side only ~1.7e-4 from
    # PSL's (lr 0.05); the 3 steps' momentum carries it past W_TOL
    epsl = [_max_dist(snaps["EPSL", n], snaps["PSL", n], "ue_params")
            for n in (1, W_STEPS)]
    print(f"wireless step 1: C2P2SL vs PSL max |diff| {eq:.3e} (tol {W_TOL})"
          f"; EPSL vs PSL UE side {epsl[0]:.3e} after step 1, {epsl[1]:.3e} "
          f"after step {W_STEPS} (must exceed {W_TOL})")
    if not eq <= W_TOL or not epsl[1] > W_TOL:
        fail(f"C2P2SL vs PSL {eq} (<= {W_TOL} asked), EPSL vs PSL {epsl[1]} "
             f"after step {W_STEPS} (> {W_TOL} asked)")

    small = wsl.integer_allocation(plan.b, SMOKE.batch)
    ks = wsl.train_k(plan.k, small)
    out = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        row, tree = next(wsl.train_scheme(
            "C2P2SL", tree_map(lambda t: t.to(where), params), plan.l, small,
            ks, SMOKE.batch, 1, SEED, where))
        out[name] = (row["loss"], {
            side: [t.detach().cpu() for t in tree_leaves(tree[side])]
            for side in ("ue_params", "bs_params")})
    gap = max(abs(out["card"][0] - out["cpu"][0]),
              *(_max_dist(out["card"][1], out["cpu"][1], s)
                for s in ("ue_params", "bs_params")))
    print(f"wireless SMOKE batch {SMOKE.batch} split {small.tolist()} k={ks}:"
          f" C2P2SL step 1 card vs CPU max |diff| {gap:.3e} (tol "
          f"{W_CARD_TOL})")
    if not gap <= W_CARD_TOL:
        fail(f"wireless card vs CPU {gap} > {W_CARD_TOL}")
    for scheme, rs in rows.items():
        for r in rs:
            print(f"main path wireless {scheme} step {r['step']}: loss "
                  f"{r['loss']:.5f}, {r['step_ms']:.1f} ms, peak "
                  f"{r['peak_gb']:.2f} GB ({card})")
    for scheme, (prof, wall) in traced.items():
        report_trace(prof, wall,
                     f"wireless {scheme} step {W_STEPS + 1} (traced)")
    del params, snaps
    torch.cuda.empty_cache()
    return rows


def run_streaming_path(torch, ops, serve, dev, wc, card, split_int8):
    """The streaming C2P2SL runtime training qwen1.5-4b at full width and
    depth, once the qwen training phases' state is freed: run (a) int8 on
    the unshaped loopback, run (b) ``TK_WIRE`` with the link shaped to
    ``S_BW`` both ways and a LinkEstimator as the re-planner (module
    constants above).  Each run: every round's loss finite and seen by
    every client, every parameter tensor moved from the seed's draw,
    every hop's measured payload bytes equal to its bill (``S_BILL_*``),
    exactly ``S_RUNS[wire]`` launches on route "mma" (flash) and
    "warp256" (decode), every codec call at [1024, 2560] bf16, the QoS
    snapshot's 3 rounds, 6 frames in and straggler rounds summing to 3.
    Run (b): each client's top-k residual finite and nonzero after every
    round, the estimator holding samples of both directions and never fed
    ``observe_bandwidth``.  Then the runtime's CLI at the reference's
    example (``S_CLI``) on the card, and split serving at cut 20 int8
    through a QoSMonitor and a LinkShaper at ``S_BW``: gen + 1 frames
    counted, the unshaped run's tokens (``split_int8``).  Returns
    (launches and codec calls of the two full runs, and the split run's
    launches and codec calls)."""
    import asyncio

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.lm import LM
    from repro_torch.runtime import bs as bs_mod
    from repro_torch.runtime import driver
    from repro_torch.runtime.qos import QoSMonitor
    from repro_torch.serving.infer import SplitDecode
    from repro_torch.training.replan import LinkEstimator
    from repro_torch.utils.trees import tree_leaves
    from repro_torch.wireless.channel import LinkShaper
    cfg = get_arch(ARCH).full
    launches_all, calls_all = collections.Counter(), collections.Counter()
    for wire, want in S_RUNS.items():
        shaped = wire == TK_WIRE
        name = f"streaming {ARCH} cut {S_CUT}, {S_CLIENTS} UEs, {wire}" + (
            f", shaped {S_BW:g} B/s" if shaped else ", unshaped")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        for routes in (fa.ROUTES, fa.BWD_ROUTES, wc.ROUTES):
            routes.clear()
        qos, stamps, efs, scripted = QoSMonitor(), [], [], []
        record_round = qos.record_round

        def stamp_round(straggler, record_round=record_round):
            stamps.append(time.perf_counter())
            record_round(straggler)
        qos.record_round = stamp_round
        est = LinkEstimator() if shaped else None
        if est is not None:
            observe_bw = est.observe_bandwidth
            est.observe_bandwidth = (
                lambda *a, f=observe_bw, **k: scripted.append(a) or f(*a, **k))
        grad_frame = bs_mod.BSDispatcher._grad_frame

        def watched(self, cid, step, g, loss):
            out = grad_frame(self, cid, step, g, loss)
            ef = self.ef.get(cid)
            if ef is not None:
                efs.append((step, cid, bool(torch.isfinite(ef).all()),
                            float(torch.linalg.vector_norm(ef))))
            return out
        bs_mod.BSDispatcher._grad_frame = watched
        t_start = []
        try:
            with codec_calls(wc) as calls:
                res = asyncio.run(driver.run_streaming(
                    cfg, cut=S_CUT, n_clients=S_CLIENTS, steps=S_ROUNDS,
                    batch_per_client=S_BPC, seq=T_SEQ, seed=SEED,
                    wire_dtype=wire, lr=S_LR,
                    shaper=LinkShaper(S_BW) if shaped else None,
                    replanner=est, qos=qos, device=dev,
                    on_started=lambda d, c: t_start.append(
                        time.perf_counter())))
        finally:
            bs_mod.BSDispatcher._grad_frame = grad_frame
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = dict(ops.LAUNCHES)
        round_ms = [(b - a) * 1e3 for a, b in zip(t_start + stamps, stamps)]
        if launches != want:
            fail(f"{name}: launches {launches} != {want}")
        if dict(fa.ROUTES) != {"mma": want["flash_attention"]} or dict(
                fa.BWD_ROUTES) != {"mma": want["flash_attention_bwd"]}:
            fail(f"{name}: flash routes {dict(fa.ROUTES)}, backward "
                 f"{dict(fa.BWD_ROUTES)}: not all on mma")
        check_codec_calls(wc, name, launches, calls, dict(wc.ROUTES))
        shape_calls = {(k, S_ROWS, cfg.d_model, cfg.dtype, "int8"):
                       want[k] for k in ("wire_encode", "wire_decode")}
        if dict(calls) != shape_calls:
            fail(f"{name}: codec calls {dict(calls)} != {shape_calls}")
        losses = res["losses"]
        if len(losses) != S_ROUNDS or not all(map(math.isfinite, losses)):
            fail(f"{name}: round losses {losses}")
        for cid, cl in res["client_losses"].items():
            if len(cl) != S_ROUNDS or not all(map(math.isfinite, cl)):
                fail(f"{name}: client {cid} saw losses {cl}")
        bills = {"uplink": S_BILL_INT8,
                 "downlink": S_BILL_TOPK if shaped else S_BILL_INT8}
        for direction, rows in res["wire_honesty"].items():
            got = [(r["measured_bytes"], r["billed_bytes"], r["ok"])
                   for r in rows]
            if got != [(bills[direction], bills[direction], True)]:
                fail(f"{name}: {direction} hops {got}, expected every one "
                     f"{bills[direction]} B measured == billed")
        q = res["qos"]
        stragglers = sum(c["straggler_rounds"] for c in q["clients"].values())
        if (q["rounds"], q["totals"]["frames_in"], stragglers) != (
                S_ROUNDS, S_CLIENT_ROUNDS, S_ROUNDS):
            fail(f"{name}: QoS rounds {q['rounds']}, frames in "
                 f"{q['totals']['frames_in']}, straggler rounds {stragglers}")
        if shaped:
            if len(efs) != S_CLIENT_ROUNDS or not all(
                    f and norm > 0 for _s, _c, f, norm in efs):
                fail(f"{name}: top-k residuals after each round {efs}")
            sizes = [b for b, _s in est.samples]
            if scripted or not (min(sizes) < S_BILL_INT8 <= max(sizes)):
                fail(f"{name}: estimator samples of {sorted(set(sizes))} B "
                     f"(both directions expected), observe_bandwidth "
                     f"called {len(scripted)} times")
        hop_s = {d: {c: [round(x, 4) for x in v] for c, v in per.items()}
                 for d, per in res["hop_seconds"].items()}
        ue, bs = res["params"]["ue"], res["params"]["bs"]
        del res
        gc.collect()
        fresh = LM(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        f_ue, f_bs = SplitDecode(LM(cfg, dev), S_CUT).split_params(fresh)
        pairs = list(zip(tree_leaves(ue) + tree_leaves(bs),
                         tree_leaves(f_ue) + tree_leaves(f_bs)))
        same = sum(bool(torch.equal(a, b)) for a, b in pairs)
        if same:
            fail(f"{name}: {same} of {len(pairs)} parameter tensors did not "
                 f"change")
        del fresh, f_ue, f_bs, pairs, ue, bs
        print(f"{name}: losses {[round(x, 5) for x in losses]}, every "
              f"client saw each round's loss, all parameter tensors moved; "
              f"hop bytes a client-hop up {bills['uplink']} down "
              f"{bills['downlink']} == billed; launches "
              f"{json.dumps(launches, sort_keys=True)}, flash routes mma, "
              f"decode routes {dict(wc.ROUTES)}; QoS {S_ROUNDS} rounds, "
              f"{S_CLIENT_ROUNDS} frames in, stragglers by client "
              f"{ {c: v['straggler_rounds'] for c, v in q['clients'].items()} }"
              f"; round ms {[round(x, 1) for x in round_ms]}; peak "
              f"{peak:.2f} GB ({held:.3f} GB held before the run) on {card}")
        print(f"{name}: hop seconds by client {json.dumps(hop_s)}")
        if shaped:
            print(f"{name}: top-k residual norms after each round "
                  f"{[(s, c, round(n, 6)) for s, c, _f, n in efs]}; "
                  f"LinkEstimator from {len(est.samples)} measured hops "
                  f"(sizes {sorted(set(int(b) for b in sizes))} B): bw "
                  f"{est.bw_Bps:.6g} B/s, overhead {est.overhead_s} s, "
                  f"beside the shaper's {S_BW:g} B/s; observe_bandwidth "
                  f"never called")
        launches_all.update(launches)
        calls_all.update(calls)

    ops.reset_launches()
    t0 = time.perf_counter()
    cli = driver.main(S_CLI)
    torch.cuda.synchronize()
    if not all(map(math.isfinite, cli["losses"])) or not all(
            r["ok"] for rows in cli["wire_honesty"].values() for r in rows):
        fail(f"streaming CLI {S_CLI}: losses {cli['losses']}, honesty "
             f"{cli['wire_honesty']}")
    print(f"streaming CLI {' '.join(S_CLI)} on {dev}: "
          f"{(time.perf_counter() - t0):.2f} s, launches "
          f"{json.dumps(dict(ops.LAUNCHES), sort_keys=True)}, link hints "
          f"{cli['link_hints']}")
    del cli

    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    wc.ROUTES.clear()
    with codec_calls(wc) as s_calls:
        split = serve.main(["--arch", ARCH, "--size", "full", "--batch",
                            str(BATCH), "--prompt-len", str(PROMPT),
                            "--gen", str(GEN), "--seed", str(SEED),
                            "--split-cut", str(CUT), "--wire-dtype", "int8",
                            "--bw-Bps", f"{S_BW:g}"])
    torch.cuda.synchronize()
    s_launches = dict(ops.LAUNCHES)
    check_codec_calls(wc, "shaped split serving", s_launches, s_calls,
                      dict(wc.ROUTES))
    frames = split["qos"]["clients"]["0"]["frames_in"]
    if frames != GEN + 1 or split["frames"] != GEN + 1 \
            or not split["rel"] <= 0.01:
        fail(f"shaped split serving: {frames} frames counted, "
             f"{split['frames']} audited, measured "
             f"{split['measured_payload_bytes']} B vs billed "
             f"{split['billed_payload_bytes']} B")
    if not torch.equal(split["tokens"], split_int8):
        fail("shaped split serving: tokens differ from the unshaped run's")
    print(f"split serving {ARCH} cut {CUT} int8 through a QoSMonitor and a "
          f"LinkShaper at {S_BW:g} B/s: {frames} frames counted (gen + 1), "
          f"the unshaped run's tokens, prefill {split['prefill_ms']:.2f} ms, "
          f"decode {split['decode_tok_s']:.1f} tok/s; QoS totals "
          f"{json.dumps(split['qos']['totals'], sort_keys=True)}")
    return launches_all, calls_all, s_launches, s_calls


def live_cuda_tensors(torch, label, top=8):
    """Print the CUDA tensors Python still reaches (gc), largest first,
    beside ``memory_allocated`` and the allocator's live blocks by stream:
    who holds memory between phases."""
    seen, rows = set(), []
    for obj in gc.get_objects():
        try:
            t = obj if isinstance(obj, torch.Tensor) else None
        except ReferenceError:
            continue
        if t is None or not t.is_cuda:
            continue
        key = (t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
        if key in seen:
            continue
        seen.add(key)
        rows.append((key[1], tuple(t.shape), str(t.dtype).split(".")[-1]))
    rows.sort(reverse=True)
    largest = [(f"{b / 1e6:.1f} MB", sh, dt) for b, sh, dt in rows[:top]]
    by_stream = collections.Counter()
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                by_stream[seg["stream"]] += blk["size"]
    print(f"{label}: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
          f"{sum(r[0] for r in rows) / 1e9:.3f} GB in {len(rows)} storages "
          f"Python reaches; largest {largest}; live blocks on "
          f"{len(by_stream)} streams, MB by stream "
          f"{sorted(round(b / 1e6, 1) for b in by_stream.values())}")


def profile_training_step(torch, res, watch, shape=(T_BATCH, T_SEQ),
                          microbatches=1):
    """Where a training step's time goes: one more step of the run (batch
    and sequence ``shape``, its pipeline or ``microbatches``) traced with
    torch.profiler; ``watch`` maps a label to a substring of kernel names,
    whose device time and launches are summed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import build_batch_iter
    from repro_torch.parallel.steps import make_lm_train_step
    from repro_torch.training.optim import adamw, cosine_schedule
    model, state = res["model"], res["state"]
    opt = adamw(cosine_schedule(3e-4, warmup=20, total=T_STEPS),
                grad_clip=1.0)
    step = make_lm_train_step(model, opt, pipeline=res["pipeline"],
                              microbatches=microbatches)
    batch = {n: torch.as_tensor(a, device=model.device) for n, a in next(
        build_batch_iter(model.cfg, *shape, seed=SEED + 1)).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, mets = step(state, batch)
        float(mets["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spec = res["pipeline"]
    how = (f"{spec.wire_dtype}, v {spec.virtual_stages}" if spec
           else f"k {microbatches}")
    report_trace(prof, wall, f"training step ({model.cfg.name}, {how}, "
                 "traced)", watch)


def report_trace(prof, wall, label, watch=None):
    """Print a traced step's wall, device busy time, idle share and top
    kernels; ``watch`` maps a label to a substring of kernel names, whose
    device time and launches are summed."""
    busy_us, rows, us = _kernel_us(prof.key_averages())
    found = {name: [e for e in rows if key in e.key]
             for name, key in (watch or {}).items()}
    print(f"profile {label}: wall {wall:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e3 / wall:.3f}"
          f", {sum(e.count for e in rows)} device operations"
          + "".join(f"; {name} kernels {sum(us(e) for e in es) / 1e3:.3f} "
                    f"ms in {sum(e.count for e in es)} launches"
                    for name, es in found.items()))
    seen = rows[:8]
    for e in seen + [e for es in found.values() for e in es
                     if e not in seen]:
        print(f"  {us(e) / 1e3:9.3f} ms/step  {e.count:6d} calls/step  "
              f"{e.key[:70]}")


def profile_serving(torch, dev, arch, decode_steps, watch=(), batch=BATCH,
                    prompt=PROMPT, gen=GEN):
    """Where the time of the static path goes: one prefill and
    ``decode_steps`` decode steps traced with torch.profiler; wall time
    (host clock, ends in a synchronise), device busy time (sum of kernel
    time) and the device's idle share, with the kernels that take the most
    time and those whose names hold a string of ``watch``.  An
    encoder-decoder's prefill encodes ``batch`` segments of random
    frames; a vlm's puts random patch embeddings before the prompt (the
    patch prefill)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    gc.collect()
    torch.cuda.empty_cache()
    model = LM(get_arch(arch).full, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    g = torch.Generator(device=dev).manual_seed(5)
    inputs = {"tokens": torch.randint(0, model.cfg.vocab, (batch, prompt),
                                      device=dev, generator=g)}
    if model.cfg.enc_layers:
        inputs["frames"] = torch.randn(
            (batch, model.cfg.enc_seq, model.cfg.d_model), device=dev,
            generator=g).to(model.dtype)
    prompts = inputs["tokens"]
    cache_len = prompt + gen
    if model.cfg.family == "vlm":
        inputs["patch_embeds"] = torch.randn(
            (batch, model.cfg.num_patches, model.cfg.d_model), device=dev,
            generator=g).to(model.dtype)
        cache_len += model.cfg.num_patches

    def prefill():
        return model.prefill_with_cache(params, inputs, cache_len,
                                        torch.float32)

    def decode(state, steps):
        cache, pos = state["cache"], state["position"]
        tok = prompts[:, -1:]
        for _ in range(steps):
            logits, cache = model.decode_step(params, tok, cache, pos)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
            pos += 1
        return tok

    with torch.inference_mode():
        _, state = prefill()
        decode(state, 2)                                     # warm
        for name, fn, steps in (
                ("prefill", prefill, 1),
                ("decode", lambda: decode(state, decode_steps),
                 decode_steps)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy_us, rows, us = _kernel_us(prof.key_averages())
            print(f"profile {arch} {name} ({steps} step"
                  f"{'s' * (steps > 1)}): wall "
                  f"{wall / steps:.3f} ms/step, device busy "
                  f"{busy_us / 1e3 / steps:.3f} ms/step, idle share "
                  f"{1 - busy_us / 1e3 / wall:.3f}")
            watched = [e for e in rows[6:] if any(w in e.key for w in watch)]
            for e in rows[:6] + watched:
                print(f"  {us(e) / 1e3 / steps:9.3f} ms/step  {e.count // steps:5d}"
                      f" calls/step  {e.key[:70]}")


# ------------------------------------------------------------------ phase 5


def codec_cells(serve_calls, train_calls):
    """The codec's shapes on the main paths, from the calls ``codec_calls``
    recorded: (row-name suffix, rows, activation dtype, wire timed, calls
    at that shape by (kernel, wire)).  The qwen split serving's prefill
    hop ([B * S, d] bf16, int8 and fp8) and decode steps ([B, d]); the
    training hop at the shape, dtype and wire the training path shipped."""
    hops = {(r, dt, w) for (k, r, _d, dt, w) in train_calls
            if k == "wire_decode"}
    if len(hops) != 1:
        fail(f"training hop shapes {sorted(hops)}: expected one")
    (hop_rows, hop_dt, hop_wire), = hops
    cells = []
    for suffix, rows, dt, wire, calls in (
            ("", BATCH * PROMPT, "bfloat16", "int8", serve_calls),
            ("_step", BATCH, "bfloat16", "int8", serve_calls),
            ("_hop", hop_rows, hop_dt, hop_wire, train_calls)):
        by = collections.Counter()
        for (kernel, r, _d, _dt, w), n in calls.items():
            if r == rows:
                by[(kernel, w)] += n
        cells.append((suffix, rows, dt, wire, by))
    return cells


def time_codec(torch, wc, dev, serve_calls, train_calls, grads_calls):
    """Encode and decode at each shape the main paths coded (``codec_cells``),
    int8: device time from cold data (``cold_ms``: the bound assumes
    device memory, and back-to-back calls at these sizes would find their
    data in L2), the plain version's, the bound (the payload, the
    activation and the scales moved once at 3.35 TB/s; ~7 f32 operations
    an element encoding, 2 decoding) and, for the int8 decode,
    ``torch.mul(q, s, out=o)`` (bit-equal to the decode: the library
    yardstick; fp8 has none, torch does not promote float8 with f32).
    ``launches`` counts every call at that shape, both wires; the max abs
    errors are measured on the row's inputs (bit-exact: 0).  The
    ``_grads`` rows time ``compress_grads``' largest call (``grads_calls``,
    f32 [n / 256, 256]: the embedding's and the head's), whose 1.6 GB
    input no L2 holds, back to back."""
    gen = torch.Generator(device=dev).manual_seed(4)
    d = 2560
    out = []
    for suffix, rows, dt_name, wire, by in codec_cells(serve_calls,
                                                       train_calls):
        dt = getattr(torch, dt_name)
        x = torch.randn((rows, d), generator=gen, device=dev).to(dt)
        q, s = wc.encode_cuda(x, wire)
        qp, sp = wc.encode_plain(x, wire)
        y, yp = wc.decode_cuda(q, s, dt), wc.decode_plain(q, s, dt)
        torch.cuda.synchronize()
        enc_err = max(float((q.float() - qp.float()).abs().max()),
                      float((s - sp).abs().max()))
        dec_err = float((y.float() - yp.float()).abs().max())
        n, nblk = rows * d, rows * d // wc.wire_block(d)
        io = n * (dt.itemsize + 1) + nblk * 4
        launches = {k: sum(v for (kern, _w), v in by.items() if kern == k)
                    for k in ("wire_encode", "wire_decode")}
        common = {"route": "cuda", "source": "src/repro_torch/csrc/wire_codec.cu",
                  "shape": [rows, d], "dtype": dt_name, "wire": wire}
        b_ms, b_by = bound(io, 7 * n, F32_OPS_S)
        out.append({
            "name": f"wire_encode{suffix}", **common,
            "replaces": "src/repro/kernels/wire_codec.py:90",
            "launches": launches["wire_encode"], "max_abs_err": enc_err,
            "ms": cold_ms(wc.encode_cuda, (x, wire), io),
            "plain_ms": device_ms(lambda: wc.encode_plain(x, wire)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        o = torch.empty(q.shape, dtype=dt, device=dev)
        b_ms, b_by = bound(io, 2 * n, F32_OPS_S)
        out.append({
            "name": f"wire_decode{suffix}", **common,
            "kernel_route": wc.decode_route(q.shape[-1], q.data_ptr(),
                                            y.data_ptr()),
            "replaces": "src/repro/kernels/wire_codec.py:118",
            "launches": launches["wire_decode"], "max_abs_err": dec_err,
            "ms": cold_ms(wc.decode_cuda, (q, s, dt), io),
            "plain_ms": device_ms(lambda: wc.decode_plain(q, s, dt)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cold_ms(lambda q_, s_, o_: torch.mul(q_, s_, out=o_),
                                  (q, s, o), io)
            if wire == "int8" else None})
        enc = lambda: wc.encode_cuda(x, wire)
        dec = lambda: wc.decode_cuda(q, s, dt)
        q8, s8 = wc.encode_cuda(x, "fp8")
        counts = ", ".join(f"{k} {w} {v}" for (k, w), v in sorted(by.items()))
        print(f"codec at [{rows}, {d}] {dt_name}/{wire} (launches: {counts}): "
              f"encode {out[-2]['ms']:.4f} ms on the device from cold data "
              f"({device_ms(enc):.4f} ms in L2), {cuda_ms(enc):.4f} ms "
              f"between events, {out[-2]['bound_ms'] / out[-2]['ms']:.3f} of "
              f"its bound; decode [{out[-1]['kernel_route']}] "
              f"{out[-1]['ms']:.4f} ms on the device from cold data "
              f"({device_ms(dec):.4f} ms in L2), {cuda_ms(dec):.4f} ms "
              f"between events, {out[-1]['bound_ms'] / out[-1]['ms']:.3f} of "
              f"its bound, torch.mul {out[-1]['library_ms']} ms; fp8 decode "
              f"{cold_ms(wc.decode_cuda, (q8, s8, dt), io):.4f} ms")
    out += time_codec_grads(torch, wc, dev, grads_calls)
    return out


def time_codec_grads(torch, wc, dev, grads_calls):
    """Encode and decode at the largest f32 [rows, 256] call of the
    gradient compression, int8, beside the plain versions, the bound
    (the f32 view, the payload and the scales moved once) and, for the
    decode, ``torch.mul``; launches are the calls at that shape."""
    rows = max(r for (_k, r, _d, _dt, _w) in grads_calls)
    by = {k[0]: v for k, v in grads_calls.items() if k[1] == rows}
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((rows, 256), generator=gen, device=dev)
    q, s = wc.encode_cuda(x, "int8")
    qp, sp = wc.encode_plain(x, "int8")
    y = wc.decode_cuda(q, s, torch.float32)
    yp = wc.decode_plain(q, s, torch.float32)
    torch.cuda.synchronize()
    enc_err = max(float((q.float() - qp.float()).abs().max()),
                  float((s - sp).abs().max()))
    dec_err = float((y - yp).abs().max())
    del qp, sp, yp
    n = rows * 256
    io = n * (4 + 1) + rows * 4
    common = {"route": "cuda", "source": "src/repro_torch/csrc/wire_codec.cu",
              "shape": [rows, 256], "dtype": "float32", "wire": "int8"}
    out = []
    b_ms, b_by = bound(io, 7 * n, F32_OPS_S)
    out.append({
        "name": "wire_encode_grads", **common,
        "replaces": "src/repro/kernels/wire_codec.py:90",
        "launches": by.get("wire_encode", 0), "max_abs_err": enc_err,
        "ms": device_ms(lambda: wc.encode_cuda(x, "int8"), iters=10),
        "plain_ms": device_ms(lambda: wc.encode_plain(x, "int8"), iters=3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    o = torch.empty(q.shape, dtype=torch.float32, device=dev)
    b_ms, b_by = bound(io, 2 * n, F32_OPS_S)
    out.append({
        "name": "wire_decode_grads", **common,
        "kernel_route": wc.decode_route(256, q.data_ptr(), y.data_ptr()),
        "replaces": "src/repro/kernels/wire_codec.py:118",
        "launches": by.get("wire_decode", 0), "max_abs_err": dec_err,
        "ms": device_ms(lambda: wc.decode_cuda(q, s, torch.float32),
                        iters=10),
        "plain_ms": device_ms(lambda: wc.decode_plain(q, s, torch.float32),
                              iters=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.mul(q, s, out=o), iters=10)})
    print(f"codec at [{rows}, 256] float32/int8 (compress_grads' largest "
          f"call; launches {by}): encode {out[0]['ms']:.4f} ms, "
          f"{out[0]['bound_ms'] / out[0]['ms']:.3f} of its bound; decode "
          f"[{out[1]['kernel_route']}] {out[1]['ms']:.4f} ms, "
          f"{out[1]['bound_ms'] / out[1]['ms']:.3f} of its bound, torch.mul "
          f"{out[1]['library_ms']:.4f} ms")
    del x, q, s, y, o
    torch.cuda.empty_cache()
    return out


def time_kernels(torch, wc, fa, rw, rg, dev, serve_launches, rg_launches,
                 train_launches, codec_calls_, flash_err, wkv_err, rglru_err,
                 ptxas):
    """Device time of every kernel at its main path's shape beside its
    plain version's, its bound and a library call where one exists.
    The codec rows take the qwen serving and the training paths' calls at
    their shape (``time_codec``); flash at dh 128 takes the qwen serving
    path's count, and its training call (with lse, a row of its own) the
    training paths'; ``launches`` sums each other kernel's count over the
    qwen serving and the training main paths (``train_launches``:
    rwkv6-3b's and qwen1.5-4b's); the recurrentgemma rows (the scan, and
    flash at head dim 256) take that path's counts."""
    import torch.nn.functional as F
    trained = collections.Counter()
    for counts in train_launches:
        trained.update(counts)
    launches = collections.Counter(serve_launches) + trained
    gen = torch.Generator(device=dev).manual_seed(4)
    out = time_codec(torch, wc, dev, *codec_calls_)

    h, dh = 20, 128
    qkv = [torch.randn((BATCH, PROMPT, h, dh), generator=gen,
                       device=dev).to(torch.bfloat16).transpose(1, 2)
           for _ in range(3)]
    pairs = BATCH * h * PROMPT * (PROMPT + 1) // 2      # causal (q, k) pairs
    b_ms, b_by = bound(4 * BATCH * h * PROMPT * dh * 2, 4 * dh * pairs,
                       BF16_OPS_S)
    contig = [t.contiguous() for t in qkv]
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": serve_launches.get("flash_attention", 0),
        "max_abs_err": flash_err[128],
        "ms": device_ms(lambda: fa.flash_attention_cuda(*qkv, causal=True)),
        "plain_ms": device_ms(lambda: fa.attention_plain(*qkv, causal=True),
                              iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            *contig, is_causal=True))})
    print(rate_line(out[-1], 4 * dh * pairs))
    out.append(time_flash_train(torch, fa, dev,
                                trained.get("flash_attention", 0)))
    out.append(time_flash_bwd(torch, fa, dev,
                              launches.get("flash_attention_bwd", 0),
                              flash_err["bwd"],
                              ptxas.get("flash_attention_bwd", [])))
    out += time_wkv6(torch, rw, dev, launches, wkv_err, ptxas.get("wkv6", []))
    out += time_hybrid(torch, fa, rg, dev, rg_launches, flash_err[256],
                       rglru_err, ptxas.get("rglru", []))
    return out


def time_flash_train(torch, fa, dev, launches):
    """The flash forward with lse at qwen1.5-4b's training call: [2, 20,
    512, 128] bf16, causal, q, k, v in the model layout, from cold data
    (``cold_ms``).  Bound: q, k, v read and O and lse written once at
    3.35 TB/s, against its two products (S and PV: 2 dh operations a
    causal (q, k) pair each) at the bf16 tensor-core rate.  The library
    yardstick is SDPA's forward on contiguous copies that require grad,
    under grad mode: the call that keeps its lse for the backward (timed
    here only).  The max abs error is over O and lse against
    ``attention_plain_lse`` on the row's inputs."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(15)
    b, h, s, dh = Q_TRAIN
    q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    fa.ROUTES.clear()
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    if dict(fa.ROUTES) != {"mma": 1}:
        fail(f"flash with lse at {list(Q_TRAIN)}: routes {dict(fa.ROUTES)}")
    o_p, lse_p = fa.attention_plain_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max(float((o.float() - o_p.float()).abs().max()),
              float((lse - lse_p).abs().max()))
    nbytes = 4 * b * h * s * dh * 2 + b * h * s * 4
    flops = 4 * dh * (b * h * s * (s + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, BF16_OPS_S)
    lib = [t.contiguous().requires_grad_(True) for t in (q, k, v)]
    fwd = lambda *a: fa.flash_attention_cuda(*a, causal=True, with_lse=True)
    row = {
        "name": "flash_attention_train", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "shape": [b, h, s, dh], "dtype": "bfloat16", "with_lse": True,
        "launches": launches, "max_abs_err": err,
        "ms": cold_ms(fwd, (q, k, v), nbytes),
        "plain_ms": device_ms(lambda: fa.attention_plain_lse(
            q, k, v, causal=True), iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            *lib, is_causal=True))}
    print(rate_line(row, flops))
    return row


def _q_off_16(torch, args):
    """A copy of the backward's arguments whose q is based 2 bytes off 16
    (the same values and strides): ``bwd_route`` sends it to "simt"."""
    q, *rest = args
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    # q is a transposed [B, S, H, dh] view: copy it in that layout
    base = buf[1:].view(q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    return (base.copy_(q.transpose(1, 2)).transpose(1, 2),
            *(a.clone() for a in rest))


def time_flash_bwd(torch, fa, dev, launches, err, ptxas):
    """The flash backward at qwen1.5-4b's training call: [2, 20, 512, 128]
    bf16, causal, q, k, v and dO in the model layout, from cold data
    (``cold_ms``), on the route the main path takes ("mma", from
    ``BWD_ROUTES``) and, as ``simt_ms``, on SIMT (the same values with q
    based 2 bytes off 16).  Bound: q, k, v, O, dO and lse read once and
    dq, dk, dv written once (~42 MB) at 3.35 TB/s, against its five
    products (S, dP, dV, dK, dQ: 2 dh operations a causal (q, k) pair
    each, ~6.7 GFLOP) at the bf16 tensor-core rate: the bytes bound it.
    The library yardstick is SDPA's backward, ``torch.autograd.grad``
    through ``F.scaled_dot_product_attention`` on contiguous copies (timed
    here only).  The row carries ptxas' registers and spills of the two
    tensor-core kernels at dh 128."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(14)
    b, h, s, dh = Q_TRAIN
    q, k, v, do = (torch.randn((b, s, h, dh), generator=gen, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    nbytes = 8 * b * h * s * dh * 2 + b * h * s * 4
    flops = 5 * 2 * dh * (b * h * s * (s + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, BF16_OPS_S)
    lib = [t.contiguous().requires_grad_(True) for t in (q, k, v)]
    lib_out, lib_do = F.scaled_dot_product_attention(*lib, is_causal=True), \
        do.contiguous()
    bwd = lambda *a: fa.flash_attention_bwd_cuda(*a, causal=True)
    args, simt_args = (q, k, v, o, lse, do), _q_off_16(torch, (q, k, v, o,
                                                                lse, do))
    routes = []
    for a in (args, simt_args):
        fa.BWD_ROUTES.clear()
        bwd(*a)
        routes.append(dict(fa.BWD_ROUTES))
    if routes != [{"mma": 1}, {"simt": 1}]:
        fail(f"flash_attention_bwd timing: routes {routes}, expected mma "
             f"and, with q 2 bytes off, simt")
    row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "kernel_route": next(iter(routes[0])),
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/common.py:88",   # no Pallas backward
        "shape": [b, h, s, dh], "dtype": "bfloat16",
        "launches": launches, "max_abs_err": err,
        "ms": cold_ms(bwd, args, nbytes),
        "simt_ms": cold_ms(bwd, simt_args, nbytes,
                           copy=lambda xs: _q_off_16(torch, xs)),
        "plain_ms": device_ms(lambda: fa.attention_bwd_plain(
            q, k, v, o, lse, do, causal=True), iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.autograd.grad(
            lib_out, lib, lib_do, retain_graph=True)),
        "ptxas": {n: f"{used}; {spill}" for n, used, spill in ptxas
                  if "_mma<128>" in n or "_mmaILi128E" in n}}
    print(rate_line(row, flops))
    print(f"flash_attention_bwd at {list(Q_TRAIN)} bf16: "
          f"{device_ms(lambda: bwd(*args)):.4f} ms back to back on one "
          f"input, {cuda_ms(lambda: bwd(*args)):.4f} ms between events; "
          f"SIMT route {row['simt_ms']:.4f} ms from cold data "
          f"({row['simt_ms'] / row['ms']:.2f}x); ptxas {row['ptxas']}")
    return row


def wkv6_products(b, s, h, dh=64, chunk=64, sub=16):
    """bf16 tensor-core operations of the chunked route per call, from its
    tiling (csrc/wkv6.cu, namespace chunked): (forward, backward).  Per
    chunk of one (b, h), with dense [64, 64] x [64, 64] products counted at
    2 * 64^3 and the triangular ones by their blocks:
    forward: the state update, A's blocks left of the diagonal, A v, and
    the state term; backward: both state updates, A's blocks and DV's, dr
    (the state term twice: S_in as hi + lo) and its blocks, dk likewise,
    and dv (A^T do and k_hat dS_out).  The pairwise diagonal blocks run on
    the f32 pipes and are not counted here."""
    n_sub = chunk // sub
    dense = 2 * chunk * dh * dh
    left = sum(2 * sub * sub * a * dh for a in range(n_sub))       # j < s_a
    upto = sum(2 * sub * sub * (a + 1) * dh for a in range(n_sub))  # j < e_a
    fwd = dense + left + upto + dense
    bwd = 2 * dense + left + upto + (2 * dense + left) \
        + (2 * dense + left) + (upto + dense)
    chunks = b * h * -(-s // chunk)
    return fwd * chunks, bwd * chunks


def time_wkv6(torch, rw, dev, launches, wkv_err, ptxas):
    """WKV6 forward and backward at one micro-batch's call of the training
    path: [2, 512, 40, 64], bf16 r/k/v, f32 log-decay from the model's
    init range, on the chunked route.  Bounds, for the chunked form: bytes
    read and written once at 3.35 TB/s (forward 32.8 MB, backward 57.7 MB)
    against its bf16 tensor-core products at 989 TFLOP/s
    (``wkv6_products``); both are bound by the bytes.  Also printed, in the
    same run and between CUDA events: the bf16 call and the f32 call,
    which takes the SIMT kernels."""
    gen = torch.Generator(device=dev).manual_seed(8)
    b, s, h, dh = WKV_SHAPE
    n = b * s * h * dh
    r, k, v = (torch.randn(WKV_SHAPE, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(torch.rand(WKV_SHAPE, generator=gen, device=dev)
                      * 6.5 - 6.0)
    u = torch.randn((h, dh), generator=gen, device=dev) * 0.2
    dout = torch.randn(WKV_SHAPE, generator=gen, device=dev).to(
        torch.bfloat16)
    state_bytes, u_bytes = b * h * dh * dh * 4, h * dh * 4
    fwd_bytes = 3 * n * 2 + n * 4 + u_bytes + n * 2 + state_bytes
    bwd_bytes = 3 * n * 2 + n * 4 + u_bytes + n * 2 + 3 * n * 2 + n * 4 \
        + u_bytes
    fwd_ops, bwd_ops = wkv6_products(b, s, h, dh)
    ins = [t.detach().clone().requires_grad_(True)
           for t in (r, k, v, logw, u)]
    op, _ = rw.wkv6_plain(*ins)
    if rw.route(r.dtype, dh) != "chunked":
        fail("the training call's WKV6 does not take the chunked route")
    ptx = {kern: f"{used}; {spill}" for kern, used, spill in ptxas
           if "chunked" in kern}
    out = []
    b_ms, b_by = bound(fwd_bytes, fwd_ops, BF16_OPS_S)
    out.append({
        "name": "wkv6", "route": "cuda", "kernel_route": "chunked",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:64",
        "launches": launches.get("wkv6", 0), "max_abs_err": wkv_err[0],
        "ms": device_ms(lambda: rw.wkv6_fwd_cuda(r, k, v, logw, u)),
        "plain_ms": device_ms(lambda: rw.wkv6_plain(r, k, v, logw, u),
                              iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ptxas": {n_: v_ for n_, v_ in ptx.items()
                  if "state" in n_ or "out_kernel" in n_}})
    b_ms, b_by = bound(bwd_bytes, bwd_ops, BF16_OPS_S)
    out.append({
        "name": "wkv6_bwd", "route": "cuda", "kernel_route": "chunked",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/models/rwkv.py:95",   # no Pallas backward
        "launches": launches.get("wkv6_bwd", 0), "max_abs_err": wkv_err[1],
        "ms": device_ms(lambda: rw.wkv6_bwd_cuda(r, k, v, logw, u, None,
                                                 dout)),
        "plain_ms": device_ms(lambda: torch.autograd.grad(
            op, ins, dout, retain_graph=True), iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ptxas": {n_: v_ for n_, v_ in ptx.items()
                  if "state" in n_ or "grad_kernel" in n_}})
    for row, ops_ in zip(out, (fwd_ops, bwd_ops)):
        print(f"kernel {row['name']} [chunked]: {row['ms']:.4f} ms, "
              f"{row['bound_ms'] / row['ms']:.3f} of its bound "
              f"({row['bound_ms']:.4f} ms, {row['bound_by']}; "
              f"{ops_ / 1e9:.3f} GFLOP of bf16 products), max abs err "
              f"{row['max_abs_err']:.3e}")
    # the f32 call (the SIMT kernels) in the same run, between CUDA events
    # (its calls are long enough to hide the host's launch time), beside
    # the bf16 call timed the same way
    rf, kf, vf, df = (t.float() for t in (r, k, v, dout))
    fwd = lambda *x: rw.wkv6_fwd_cuda(*x, logw, u)
    bwd = lambda *x: rw.wkv6_bwd_cuda(*x[:3], logw, u, None, x[3])
    both = lambda x: (cuda_ms(lambda: fwd(*x[:3])), cuda_ms(lambda: bwd(*x)))
    chunked = both((r, k, v, dout))
    f32 = both((rf, kf, vf, df))
    print(f"wkv6 at {WKV_SHAPE} between events: bf16 chunked forward "
          f"{chunked[0]:.4f} ms, backward {chunked[1]:.4f} ms; f32 (SIMT) "
          f"{f32[0]:.4f} / {f32[1]:.4f} ms")
    return out


def time_hybrid(torch, fa, rg, dev, launches, flash_err, rglru_err, ptxas):
    """The RG-LRU scan at recurrentgemma-2b prefill's call ([4, 512, 2560],
    f32 x and log a, no h0) and flash at its local layers' shape ([4, 10,
    512, 256] q, one kv head, bf16, causal, window 2048, which does not
    bite at S = 512).  Scan bound: x and log a read once, h and h_last
    written once, at 3.35 TB/s, against ~8 f32 operations an element
    (exp, a*a, 1 - , max, sqrt, two products and a sum).  The scan's time
    is taken from cold data (``cold_ms``) and includes the zeroing of its
    status buffer (one memset a call); its
    row carries the kernel's design ("lookback") and ptxas' registers and
    spills of its f32 instance."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(10)
    b, s, r = RG_SHAPE
    n = b * s * r
    x = torch.randn(RG_SHAPE, generator=gen, device=dev)
    la = -0.105 * torch.rand(RG_SHAPE, generator=gen, device=dev)
    b_ms, b_by = bound(3 * n * 4 + b * r * 4, 8 * n, F32_OPS_S)
    out = [{
        "name": "rglru_scan", "route": "cuda", "kernel_route": "lookback",
        "source": "src/repro_torch/csrc/rglru.cu",
        "replaces": "src/repro/kernels/rglru.py:56",
        "launches": launches.get("rglru_scan", 0), "max_abs_err": rglru_err,
        "ms": cold_ms(rg.rglru_cuda, (x, la), 3 * n * 4),
        "plain_ms": device_ms(lambda: rg.rglru_plain(x, la), iters=3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ptxas": {k: f"{used}; {spill}" for k, used, spill in ptxas
                  if "<float, float>" in k or "IffE" in k}}]
    print(f"kernel rglru_scan [lookback]: {out[0]['ms']:.4f} ms from cold "
          f"data ({device_ms(lambda: rg.rglru_cuda(x, la)):.4f} ms back to "
          f"back on one input), {b_ms / out[0]['ms']:.3f} of its bound "
          f"({b_ms:.4f} ms, {b_by}); ptxas {out[0]['ptxas']}")
    xb, lb = x.to(torch.bfloat16), la.to(torch.bfloat16)
    print(f"rglru at {RG_SHAPE}: f32 "
          f"{cuda_ms(lambda: rg.rglru_cuda(x, la)):.4f} ms between events; "
          f"bf16 x and log a "
          f"{device_ms(lambda: rg.rglru_cuda(xb, lb)):.4f} ms on the device, "
          f"{cuda_ms(lambda: rg.rglru_cuda(xb, lb)):.4f} ms between events "
          f"(bound {bound(3 * n * 2 + b * r * 2, 8 * n, F32_OPS_S)[0]:.4f} "
          f"ms)")

    hq, hkv, dh, window = RG_HEADS
    mk = lambda h: torch.randn((b, s, h, dh), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    q, k, v = mk(hq), mk(hkv), mk(hkv)
    pairs = b * hq * s * (s + 1) // 2           # causal; the window is wider
    b_ms, b_by = bound((2 * hq + 2 * hkv) * b * s * dh * 2, 4 * dh * pairs,
                       BF16_OPS_S)
    lib = [q.contiguous()] + [t.expand(b, hq, s, dh).contiguous()
                              for t in (k, v)]
    out.append({
        "name": "flash_attention_dh256", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": launches.get("flash_attention", 0),
        "max_abs_err": flash_err,
        "ms": device_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=True, window=window)),
        "plain_ms": device_ms(lambda: fa.attention_plain(
            q, k, v, causal=True, window=window), iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            *lib, is_causal=True))})
    print(rate_line(out[-1], 4 * dh * pairs))
    return out


def _gmm_row(torch, mg, dev, name, shape, launches, err, gen):
    """One moe_gmm row at [E, C, D] @ [E, D, F] in bf16.  Bound: h and w
    read once and the output written once at 3.35 TB/s, against 2 E C D F
    operations on the bf16 tensor cores."""
    e, c, d, f = shape
    h = torch.randn((e, c, d), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((e, d, f), generator=gen, device=dev)
         / math.sqrt(d)).to(torch.bfloat16)
    b_ms, b_by = bound((e * c * d + e * d * f + e * c * f) * 2,
                       2 * e * c * d * f, BF16_OPS_S)
    row = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:41",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: mg.moe_gmm_cuda(h, w)),
        "plain_ms": device_ms(lambda: mg.moe_gmm_plain(h, w), iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.bmm(h, w))}
    print(rate_line(row, 2 * e * c * d * f))
    return row


def time_moe(torch, mg, fa, dev, prefill_launches, run_launches, gmm_err,
             flash_err):
    """moe_gmm at granite-moe-3b-a800m prefill's w1 shape ([40, 512, 1536]
    @ [40, 1536, 512], bf16; launches: the prefill's) and at a decode
    step's ([40, 8, 1536] @ [40, 1536, 512]; launches: the decode steps'),
    with torch.bmm as the library yardstick; the w2 shape's time printed.
    Flash at granite's heads: [4, 24, 512, 64] q on 8 kv heads, bf16,
    causal (SDPA on the kv heads expanded to 24)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(12)
    n_pre = prefill_launches.get("moe_gmm", 0)
    out = [_gmm_row(torch, mg, dev, "moe_gmm", GR_GMM, n_pre,
                    gmm_err[GR_GMM], gen),
           _gmm_row(torch, mg, dev, "moe_gmm_decode", GR_GMM_DECODE,
                    run_launches.get("moe_gmm", 0) - n_pre,
                    gmm_err[GR_GMM_DECODE], gen)]
    e, c, d, f = GR_GMM
    h = torch.randn((e, c, f), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((e, f, d), generator=gen, device=dev).to(torch.bfloat16)
    w2_ms = device_ms(lambda: mg.moe_gmm_cuda(h, w))
    print(f"moe_gmm at the w2 shape [{e},{c},{f}] @ [{e},{f},{d}] bf16: "
          f"{w2_ms:.4f} ms on the device "
          f"({2 * e * c * d * f / w2_ms / 1e9:.1f} TFLOP/s), "
          f"{cuda_ms(lambda: mg.moe_gmm_cuda(h, w)):.4f} ms between events; "
          f"torch.bmm {device_ms(lambda: torch.bmm(h, w)):.4f} ms")

    hq, hkv, dh = GR_HEADS
    b, s = BATCH, PROMPT
    mk = lambda h_: torch.randn((b, s, h_, dh), generator=gen,
                                device=dev).to(torch.bfloat16).transpose(1, 2)
    q, k, v = mk(hq), mk(hkv), mk(hkv)
    pairs = b * hq * s * (s + 1) // 2
    b_ms, b_by = bound((2 * hq + 2 * hkv) * b * s * dh * 2, 4 * dh * pairs,
                       BF16_OPS_S)
    lib = [q.contiguous()] + [t.repeat_interleave(hq // hkv, dim=1)
                              .contiguous() for t in (k, v)]
    out.append({
        "name": "flash_attention_dh64", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": run_launches.get("flash_attention", 0),
        "max_abs_err": flash_err,
        "ms": device_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                        causal=True)),
        "plain_ms": device_ms(lambda: fa.attention_plain(q, k, v,
                                                         causal=True),
                              iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            *lib, is_causal=True))})
    print(rate_line(out[-1], 4 * dh * pairs))
    return out


def time_serving_shapes(torch, fa, mg, rw, dev, qm, rs, flash_err, gmm_err,
                        wkv_err):
    """The kernels at the shapes the qwen3-moe-30b-a3b and rwkv6-3b
    serving paths give them, each beside its plain version, its bound and
    a library call where one computes the same: flash at qwen3's prefill
    ([4, 32, 512, 128] q on 4 kv heads, bf16, causal; SDPA on the kv heads
    expanded to 32), moe_gmm at its prefill's w1 ([128, 160, 2048] @
    [128, 2048, 768]) and a decode step's ([128, 8, 2048] @ [128, 2048,
    768]; torch.bmm), and WKV6 at rwkv6's prefill ([4, 512, 40, 64] bf16,
    the final state written) and decode step ([4, 1, 40, 64] from a
    state; no library call).  Launches: those of the phases' CLI runs
    (static, split and the continuous run, its capture's warm-up steps
    included), the prefills' in the prefill rows and the decode steps' in
    the decode rows."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(13)
    total = lambda res, name: sum(n.get(name, 0) for n in res["launches"])
    q_flash = total(qm, "flash_attention")       # one a layer a prefill
    out = [_gmm_row(torch, mg, dev, "moe_gmm_e128", QM_GMM, 3 * q_flash,
                    gmm_err[QM_GMM], gen),
           _gmm_row(torch, mg, dev, "moe_gmm_e128_decode", QM_GMM_DECODE,
                    total(qm, "moe_gmm") - 3 * q_flash,
                    gmm_err[QM_GMM_DECODE], gen)]
    hq, hkv, dh = QM_HEADS
    b, s = BATCH, PROMPT
    mk = lambda h_: torch.randn((b, s, h_, dh), generator=gen,
                                device=dev).to(torch.bfloat16).transpose(1, 2)
    q, k, v = mk(hq), mk(hkv), mk(hkv)
    pairs = b * hq * s * (s + 1) // 2
    b_ms, b_by = bound((2 * hq + 2 * hkv) * b * s * dh * 2, 4 * dh * pairs,
                       BF16_OPS_S)
    lib = [q.contiguous()] + [t.repeat_interleave(hq // hkv, dim=1)
                              .contiguous() for t in (k, v)]
    out.append({
        "name": "flash_attention_gqa8", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": q_flash, "max_abs_err": flash_err["gqa8"],
        "ms": device_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                        causal=True)),
        "plain_ms": device_ms(lambda: fa.attention_plain(q, k, v,
                                                         causal=True),
                              iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            *lib, is_causal=True))})
    print(rate_line(out[-1], 4 * dh * pairs))

    r_pre = RS_LAYERS * (2 + rs["chunks"])
    for name, shape, with_s0, n, err in (
            ("wkv6_serve", (BATCH, PROMPT, 40, 64), False, r_pre, None),
            ("wkv6_decode", RS_DECODE, True, total(rs, "wkv6") - r_pre,
             wkv_err[2])):
        b, s, h, dh = shape
        nel = b * s * h * dh
        r, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        logw = -torch.exp(torch.rand(shape, generator=gen, device=dev)
                          * 6.5 - 6.0)
        u = torch.randn((h, dh), generator=gen, device=dev) * 0.2
        s0 = torch.randn((b, h, dh, dh), generator=gen,
                         device=dev) * 0.1 if with_s0 else None
        state = b * h * dh * dh * 4
        nbytes = 3 * nel * 2 + nel * 4 + h * dh * 4 + nel * 2 + state \
            + (state if with_s0 else 0)
        if with_s0:        # o = r (S + u k v^T), S' = w S + k v^T: f32
            b_ms, b_by = bound(nbytes, 5 * b * h * dh * dh * s, F32_OPS_S)
        else:
            b_ms, b_by = bound(nbytes, wkv6_products(b, s, h, dh)[0],
                               BF16_OPS_S)
        if rw.route(r.dtype, dh, [t.data_ptr() for t in (r, k, v, logw)]) \
                != "chunked":
            fail(f"{name}: the serving call does not take the chunked "
                 "route")
        if err is None:
            op, _ = rw.wkv6_plain(r, k, v, logw, u, s0)
            o, _ = rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)
            err = float((o.float() - op.float()).abs().max())
        out.append({
            "name": name, "route": "cuda", "kernel_route": "chunked",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:64",
            "launches": n, "max_abs_err": err,
            "ms": device_ms(lambda: rw.wkv6_fwd_cuda(r, k, v, logw, u, s0)),
            "plain_ms": device_ms(lambda: rw.wkv6_plain(r, k, v, logw, u,
                                                        s0), iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        print(f"kernel {name} [chunked] at {list(shape)}: "
              f"{out[-1]['ms']:.4f} ms, {b_ms / out[-1]['ms']:.3f} of its "
              f"bound ({b_ms:.4f} ms, {b_by}), plain "
              f"{out[-1]['plain_ms']:.4f} ms, max abs err {err:.3e}")
    return out


def time_whisper(torch, fa, dev, wh, flash_err):
    """The flash kernels at whisper-small's calls: the forward at serving's
    encoder, cross-attention and self-attention calls (``WH_FLASH``) and
    the backward at training's cross-attention and encoder calls
    (``WH_FLASH_BWD``), bf16 in the model layout.  The forward rows take
    torch.profiler's device time, the kernel's from cold data
    (``cold_ms``), as the other flash rows do, with both calls' times
    between CUDA events printed beside them; the backward rows take the
    kernel's and SDPA's backward between CUDA events (``cuda_ms``, calls
    back to back on one input: milliseconds a call, where the host's
    launches hide behind the device), since torch.profiler recorded a
    third of SDPA's backward in one call.  Launches: the
    phase's calls at that shape (the flash wrappers' calls counted by
    shape, ``flash_calls``).  Bounds: q, k, v
    and O (and for the backward dO read and dq, dk, dv written, and lse)
    once at 3.35 TB/s, against 4 dh operations a (q, k) pair forward and
    10 dh backward (S, PV; S, dP, dV, dK, dQ) at the bf16 tensor-core rate.
    The library yardstick: SDPA on contiguous copies (its backward through
    ``torch.autograd.grad``), timed here only.  A call slower than SDPA
    prints its factor."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []

    def inputs(b, h, sq, skv, dh, n):
        return [torch.randn((b, s, h, dh), generator=gen, device=dev)
                .to(torch.bfloat16).transpose(1, 2)
                for s in (sq, skv, skv, sq)[:n]]

    for name, (b, h, sq, skv, dh, causal) in WH_FLASH.items():
        q, k, v = inputs(b, h, sq, skv, dh, 3)
        pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
        nbytes = 2 * (2 * b * h * sq * dh + 2 * b * h * skv * dh)
        b_ms, b_by = bound(nbytes, 4 * dh * pairs, BF16_OPS_S)
        lib = [t.contiguous() for t in (q, k, v)]
        fwd = lambda *a, c=causal: fa.flash_attention_cuda(*a, causal=c)
        rows.append({
            "name": f"flash_attention_whisper_{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "shape": [b, h, sq, skv, dh], "causal": causal,
            "dtype": "bfloat16",
            "launches": wh["serve_calls"].get(
                ("flash_attention", b, h, sq, skv, dh, causal, "bfloat16",
                 0), 0),
            "max_abs_err": flash_err[f"whisper_{name}"],
            "ms": cold_ms(fwd, (q, k, v), nbytes),
            "plain_ms": device_ms(lambda c=causal: fa.attention_plain(
                q, k, v, causal=c), iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lambda c=causal, t=lib:
                                    F.scaled_dot_product_attention(
                                        *t, is_causal=c))})
        print(rate_line(rows[-1], 4 * dh * pairs))
        sdpa = lambda c=causal, t=lib: F.scaled_dot_product_attention(
            *t, is_causal=c)
        print(f"flash whisper {name} between CUDA events: kernel "
              f"{cuda_ms(lambda: fwd(q, k, v)):.4f} ms, SDPA "
              f"{cuda_ms(sdpa):.4f} ms")
        del q, k, v, lib
    for name, (b, h, sq, skv, dh, causal) in WH_FLASH_BWD.items():
        q, k, v, do = inputs(b, h, sq, skv, dh, 4)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         with_lse=True)
        pairs = b * h * sq * skv
        nbytes = 2 * (4 * b * h * sq * dh + 4 * b * h * skv * dh) \
            + 4 * b * h * sq
        b_ms, b_by = bound(nbytes, 10 * dh * pairs, BF16_OPS_S)
        lib = [t.contiguous().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, is_causal=causal)
        lib_do = do.contiguous()
        bwd = lambda *a, c=causal: fa.flash_attention_bwd_cuda(*a, causal=c)
        fa.BWD_ROUTES.clear()
        bwd(q, k, v, o, lse, do)
        if dict(fa.BWD_ROUTES) != {"mma": 1}:
            fail(f"flash_attention_bwd at whisper's {name} call: routes "
                 f"{dict(fa.BWD_ROUTES)}")
        rows.append({
            "name": f"flash_attention_bwd_whisper_{name}", "route": "cuda",
            "kernel_route": "mma",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/common.py:88",
            "shape": [b, h, sq, skv, dh], "causal": causal,
            "dtype": "bfloat16",
            "launches": wh["train_calls"].get(
                ("flash_attention_bwd", b, h, sq, skv, dh, causal,
                 "bfloat16", 0), 0),
            "max_abs_err": flash_err[f"bwd_whisper_{name}"],
            "ms": cuda_ms(lambda: bwd(q, k, v, o, lse, do)),
            "plain_ms": cuda_ms(lambda c=causal: fa.attention_bwd_plain(
                q, k, v, o, lse, do, causal=c), iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                lib_out, lib, lib_do, retain_graph=True))})
        print(rate_line(rows[-1], 10 * dh * pairs))
        del q, k, v, do, o, lse, lib, lib_out, lib_do
        torch.cuda.empty_cache()
    for r in rows:
        if r["ms"] > r["library_ms"]:
            print(f"kernel {r['name']}: {r['ms'] / r['library_ms']:.2f}x "
                  f"SDPA's time at {r['shape']} (ROADMAP Queue 2)")
    return rows


def prefix_pairs(s: int, prefix: int) -> int:
    """The (q, k) pairs one head sees under the causal mask with a
    bidirectional prefix: rows below the prefix see its keys, the rest
    their own and earlier keys (327,936 at S 768, prefix 256)."""
    p = min(prefix, s)
    return p * p + sum(q + 1 for q in range(p, s))


def time_paligemma(torch, fa, dev, pg, flash_err):
    """The flash kernels at paligemma-3b's prefix calls (``PG_FLASH``; 8 q
    heads on one kv head of 256, bf16, causal with the prefix 256, the
    model layout): the forward with lse at the training call and without
    at the patch prefill, and the backward at the training call, each
    timed between CUDA events (``cuda_ms``; calls back to back on one
    input), as are their plain versions and library calls, with its
    launches on the path (the flash wrappers' calls counted by shape and
    prefix, ``flash_calls``).  torch.profiler's reading of the forward
    from cold data (``cold_ms``) and of SDPA is printed beside: in a call
    of its first run it read the forward at 0.2637 ms where the traced
    training step gave 0.0674 ms a launch.
    Bounds: q, k, v and O (and lse; for the backward dO read and dq, dk,
    dv written) once at 3.35 TB/s, against 4 dh operations a seen (q, k)
    pair forward and 10 dh backward (``prefix_pairs``) at the bf16
    tensor-core rate.  The library yardstick: SDPA with the prefix mask
    as a boolean ``attn_mask`` on contiguous copies with the kv head
    expanded to 8 (under grad mode at the training call, its backward
    through ``torch.autograd.grad``), timed the row's way, and both
    between CUDA events printed beside the profiler's rows."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(31)
    rows = []
    for name, (b, hq, hkv, s, dh, prefix) in PG_FLASH.items():
        q, k, v, do = (torch.randn((b, s, h, dh), generator=gen, device=dev)
                       .to(torch.bfloat16).transpose(1, 2)
                       for h in (hq, hkv, hkv, hq))
        pairs = b * hq * prefix_pairs(s, prefix)
        train = name == "train"
        nbytes = 2 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh) \
            + (4 * b * hq * s if train else 0)
        b_ms, b_by = bound(nbytes, 4 * dh * pairs, BF16_OPS_S)
        mask = fa._mask(s, s, True, 0, dev, prefix)
        lib = [q.contiguous()] + [t.expand(b, hq, s, dh).contiguous()
                                  for t in (k, v)]
        if train:
            lib = [t.requires_grad_(True) for t in lib]
        fwd = lambda *a, t=train, p=prefix: fa.flash_attention_cuda(
            *a, causal=True, prefix_len=p, with_lse=t)
        sdpa = lambda t=lib, m=mask: F.scaled_dot_product_attention(
            *t, attn_mask=m)
        key = ("flash_attention", b, hq, s, s, dh, True, "bfloat16", prefix)
        calls = pg["train_calls" if train else "prefill_calls"]
        rows.append({
            "name": f"flash_attention_paligemma_{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "shape": [b, hq, hkv, s, dh], "prefix_len": prefix,
            "dtype": "bfloat16", "with_lse": train,
            "launches": calls.get(key, 0),
            "max_abs_err": flash_err[f"paligemma_{name}"],
            "ms": cuda_ms(lambda: fwd(q, k, v)),
            "plain_ms": cuda_ms(lambda: fa.attention_plain_lse(
                q, k, v, causal=True, prefix_len=prefix), iters=5,
                warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(sdpa)})
        print(rate_line(rows[-1], 4 * dh * pairs))
        print(f"flash paligemma {name} by torch.profiler: kernel "
              f"{cold_ms(fwd, (q, k, v), nbytes):.4f} ms from cold data, "
              f"SDPA with the mask {device_ms(sdpa):.4f} ms")
        if train:
            o, lse = fwd(q, k, v)
            nbytes = 2 * (4 * b * hq * s * dh + 4 * b * hkv * s * dh) \
                + 4 * b * hq * s
            b_ms, b_by = bound(nbytes, 10 * dh * pairs, BF16_OPS_S)
            lib_out = sdpa()
            lib_do = do.contiguous()
            bwd = lambda: fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=True, prefix_len=prefix)
            fa.BWD_ROUTES.clear()
            bwd()
            if dict(fa.BWD_ROUTES) != {"mma": 1}:
                fail(f"flash_attention_bwd at paligemma's {name} call: "
                     f"routes {dict(fa.BWD_ROUTES)}")
            rows.append({
                "name": f"flash_attention_bwd_paligemma_{name}",
                "route": "cuda", "kernel_route": "mma",
                "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                "replaces": "src/repro/models/common.py:88",
                "shape": [b, hq, hkv, s, dh], "prefix_len": prefix,
                "dtype": "bfloat16",
                "launches": calls.get(("flash_attention_bwd",) + key[1:],
                                      0),
                "max_abs_err": flash_err[f"bwd_paligemma_{name}"],
                "ms": cuda_ms(bwd),
                "plain_ms": cuda_ms(lambda: fa.attention_bwd_plain(
                    q, k, v, o, lse, do, causal=True, prefix_len=prefix),
                    iters=3, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(lambda: torch.autograd.grad(
                    lib_out, lib, lib_do, retain_graph=True))})
            print(rate_line(rows[-1], 10 * dh * pairs))
            print(f"flash_attention_bwd paligemma {name}: "
                  f"{device_ms(bwd, iters=10):.4f} ms by torch.profiler")
            del o, lse, lib_out, lib_do
        del q, k, v, do, lib, mask
        torch.cuda.empty_cache()
    for r in rows:
        if r["ms"] > r["library_ms"]:
            print(f"kernel {r['name']}: {r['ms'] / r['library_ms']:.2f}x "
                  f"SDPA's time with the mask at {r['shape']} (ROADMAP "
                  "Queue 2)")
    return rows


def _ptxas_of(ptxas, *keys):
    """ptxas' registers and spills of the kernels whose names hold one of
    ``keys`` (demangled or mangled spellings)."""
    return {n: f"{used}; {spill}" for n, used, spill in ptxas
            if any(k in n for k in keys)}


def _off_16(torch, t):
    """A copy of ``t`` (the same values and strides, dense) whose base is 2
    bytes off 16: the routes send it to "simt"."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].as_strided(t.shape, t.stride())
    return out.copy_(t)


def time_backwards(torch, rg, mg, fa, dev, gt_launches, rt_launches,
                   errs, ptxas):
    """The three backward kernels of the hybrid and MoE training paths at
    their calls, with their launches there:

    * ``rglru_scan_bwd`` at recurrentgemma-2b's [2, 4096, 2560] f32 (no
      h0, no gradient of h_last), from cold data.  Bound: x, log a, h and
      dh read and dx and dlog a written once at 3.35 TB/s, against ~20
      f32 operations an element; no library call computes it;
    * ``moe_gmm_bwd`` (dh and dw) at granite-moe-3b-a800m's w1 shape
      ([40, 256, 1536] @ [40, 1536, 512] bf16), between CUDA events, as
      are its plain and library times (torch.profiler dropped one of its
      two kernels in a call of its first runs), on the route the path
      takes ("wgmma", from ``BWD_ROUTES``) and, as ``simt_ms``, on SIMT
      (the same values with h based 2 bytes off 16).  Bound: h, w and
      dout read and dh and dw written once, against 4 E C D F operations
      at the bf16 tensor-core rate; the library yardstick is ``torch.bmm``
      twice;
    * ``flash_attention_bwd_dh256`` at recurrentgemma-2b's local layers
      ([2, 10, 4096, 256] q on one kv head, bf16, causal, window 2048, the
      model layout), timed between CUDA events (torch.profiler read 0.4
      of the training step's trace in a call of its first runs), on the
      path's route ("mma", from ``BWD_ROUTES``) and, as ``simt_ms``, on
      SIMT (q based 2 bytes off 16).  Bound: q, k, v, O, dO and lse
      read and
      dq, dk, dv written once, against five products of 2 dh operations a
      (q, k) pair inside the window at the bf16 tensor-core rate; the
      library yardstick is SDPA's backward with the window as a boolean
      mask, on the kv head expanded to 10."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(24)
    b, s, r = RT_SCAN
    n = b * s * r
    x = torch.randn(RT_SCAN, generator=gen, device=dev)
    la = -0.105 * torch.rand(RT_SCAN, generator=gen, device=dev)
    h, _ = rg.rglru_cuda(x, la)
    dh = torch.randn(RT_SCAN, generator=gen, device=dev)
    b_ms, b_by = bound(6 * n * 4, 20 * n, F32_OPS_S)
    out = [{
        "name": "rglru_scan_bwd", "route": "cuda", "kernel_route": "lookback",
        "source": "src/repro_torch/csrc/rglru.cu",
        "replaces": "src/repro/models/recurrent.py:50",   # no Pallas backward
        "shape": list(RT_SCAN), "dtype": "float32",
        "launches": rt_launches.get("rglru_scan_bwd", 0),
        "max_abs_err": errs["rglru_bwd"],
        "ms": cold_ms(lambda *a: rg.rglru_bwd_cuda(*a), (x, la, None, h, dh),
                      4 * n * 4),
        "plain_ms": device_ms(lambda: rg.rglru_bwd_plain(x, la, None, h, dh),
                              iters=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}]
    print(f"kernel rglru_scan_bwd: {out[0]['ms']:.4f} ms from cold data, "
          f"{b_ms / out[0]['ms']:.3f} of its bound ({b_ms:.4f} ms, {b_by}); "
          f"{cuda_ms(lambda: rg.rglru_bwd_cuda(x, la, None, h, dh)):.4f} ms "
          f"between events")
    del x, la, h, dh

    e, c, d, f = GT_GMM
    hh = torch.randn((e, c, d), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((e, d, f), generator=gen, device=dev)
         / math.sqrt(d)).to(torch.bfloat16)
    dout = torch.randn((e, c, f), generator=gen, device=dev).to(
        torch.bfloat16)
    ops_ = 4 * e * c * d * f
    b_ms, b_by = bound((2 * e * c * d + 2 * e * d * f + e * c * f) * 2, ops_,
                       BF16_OPS_S)
    out.append({
        "name": "moe_gmm_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "src/repro/models/moe.py:86",      # no Pallas backward
        "shape": list(GT_GMM), "dtype": "bfloat16",
        "launches": gt_launches.get("moe_gmm_bwd", 0),
        "max_abs_err": errs["moe_gmm_bwd"],
        "plain_ms": cuda_ms(lambda: mg.moe_gmm_bwd_plain(hh, w, dout),
                            iters=5),
        "bound_ms": b_ms, "bound_by": b_by})
    # the kernel and its yardstick in turns (kernel, bmm, bmm, kernel): the
    # card's clock drifts by a few percent within a call
    kern = lambda: mg.moe_gmm_bwd_cuda(hh, w, dout)
    lib = lambda: (torch.bmm(dout, w.transpose(1, 2)),
                   torch.bmm(hh.transpose(1, 2), dout))
    turns = [cuda_ms(fn) for fn in (kern, lib, lib, kern)]
    out[-1]["ms"] = (turns[0] + turns[3]) / 2
    out[-1]["library_ms"] = (turns[1] + turns[2]) / 2
    h_off = _off_16(torch, hh)
    routes = []
    for args in ((hh, w, dout), (h_off, w, dout)):
        mg.BWD_ROUTES.clear()
        mg.moe_gmm_bwd_cuda(*args)
        routes.append(dict(mg.BWD_ROUTES))
    if routes != [{"wgmma": 1}, {"simt": 1}]:
        fail(f"moe_gmm_bwd timing: routes {routes}, expected wgmma and, "
             f"with h 2 bytes off, simt")
    out[-1]["kernel_route"] = next(iter(routes[0]))
    out[-1]["simt_ms"] = cuda_ms(lambda: mg.moe_gmm_bwd_cuda(h_off, w, dout),
                                 iters=10)
    out[-1]["ptxas"] = _ptxas_of(ptxas, "gmm_wgmma<4,", "gmm_wgmmaILi4E")
    print(rate_line(out[-1], ops_))
    print(f"moe_gmm_bwd: {out[-1]['ms']:.4f} ms between CUDA events (the "
          f"row), {device_ms(lambda: mg.moe_gmm_bwd_cuda(hh, w, dout)):.4f} "
          f"ms by torch.profiler; SIMT route {out[-1]['simt_ms']:.4f} ms "
          f"({out[-1]['simt_ms'] / out[-1]['ms']:.2f}x); kernel, two bmm, "
          f"two bmm, kernel: {', '.join(f'{t:.4f}' for t in turns)} ms; "
          f"ptxas {out[-1]['ptxas']}")
    del hh, w, dout, h_off

    hq, hkv, dh_, window = RG_HEADS
    b = RT_BATCH // RT_K
    mk = lambda h_: torch.randn((b, s, h_, dh_), generator=gen,
                                device=dev).to(torch.bfloat16).transpose(1, 2)
    q, k, v, do = mk(hq), mk(hkv), mk(hkv), mk(hq)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=window,
                                     with_lse=True)
    pairs = b * hq * sum(min(i + 1, window) for i in range(s))
    ops_ = 5 * 2 * dh_ * pairs
    nbytes = (4 * hq + 4 * hkv) * b * s * dh_ * 2 + b * hq * s * 4
    b_ms, b_by = bound(nbytes, ops_, BF16_OPS_S)
    mask = fa._mask(s, s, True, window, dev)
    lib = [q.contiguous()] + [t.expand(b, hq, s, dh_).contiguous()
                              for t in (k, v)]
    lib = [t.requires_grad_(True) for t in lib]
    lib_out = F.scaled_dot_product_attention(*lib, attn_mask=mask)
    lib_do = do.contiguous()
    bwd = lambda *a: fa.flash_attention_bwd_cuda(*a, causal=True,
                                                 window=window)
    out.append({
        "name": "flash_attention_bwd_dh256", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/common.py:88",   # no Pallas backward
        "shape": [b, hq, s, dh_], "dtype": "bfloat16", "window": window,
        "launches": rt_launches.get("flash_attention_bwd", 0),
        "max_abs_err": errs["flash_bwd256"],
        "ms": cuda_ms(lambda: bwd(q, k, v, o, lse, do), iters=20, warmup=3),
        "plain_ms": device_ms(lambda: fa.attention_bwd_plain(
            q, k, v, o, lse, do, causal=True, window=window), iters=2,
            warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            lib_out, lib, lib_do, retain_graph=True), iters=5, warmup=1)})
    simt_args = _q_off_16(torch, (q, k, v, o, lse, do))
    routes = []
    for args in ((q, k, v, o, lse, do), simt_args):
        fa.BWD_ROUTES.clear()
        bwd(*args)
        routes.append(dict(fa.BWD_ROUTES))
    if routes != [{"mma": 1}, {"simt": 1}]:
        fail(f"flash_attention_bwd_dh256 timing: routes {routes}, expected "
             f"mma and, with q 2 bytes off, simt")
    out[-1]["kernel_route"] = next(iter(routes[0]))
    out[-1]["simt_ms"] = cuda_ms(lambda: bwd(*simt_args), iters=3, warmup=1)
    out[-1]["ptxas"] = _ptxas_of(ptxas, "mma256", "sum_groups")
    print(rate_line(out[-1], ops_))
    print(f"flash_attention_bwd_dh256: {out[-1]['ms']:.4f} ms between "
          f"CUDA events (the row), "
          f"{device_ms(lambda: bwd(q, k, v, o, lse, do), iters=5):.4f} ms "
          f"by torch.profiler; SIMT route {out[-1]['simt_ms']:.4f} ms "
          f"({out[-1]['simt_ms'] / out[-1]['ms']:.2f}x); SDPA's backward "
          f"{out[-1]['library_ms']:.4f} ms; ptxas {out[-1]['ptxas']}")
    return out


def main():
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs the card")
    sys.path.insert(0, SRC)
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    marks = [t_all]

    def phase(name):
        """Seconds since the previous phase ended (host clock), and the
        device memory still allocated at its end."""
        marks.append(time.perf_counter())
        gc.collect()
        torch.cuda.synchronize()
        print(f"phase {name}: {marks[-1] - marks[-2]:.1f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build, ops
    print(f"kernels ({len(ops.KERNELS)}): {', '.join(ops.KERNELS)}")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6 as rw
    from repro_torch.kernels import wire_codec as wc
    from repro_torch.launch import serve, train
    from repro_torch.runtime import protocol

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    ptxas = {name: ptxas_report(info["log"]) for name, info in built.items()}
    for name, rows in ptxas.items():
        for kernel, used, spill in rows:
            print(f"  ptxas {name}: {kernel}: {used}; {spill}")

    check_codec(torch, wc, dev)
    flash_err = check_flash(torch, fa, dev)
    flash_err["bwd"], bwd_whisper = check_flash_bwd(torch, fa, dev)
    flash_err.update({f"bwd_{k}": v for k, v in bwd_whisper.items()})
    flash_err.update(check_flash_prefix(torch, fa, dev))
    rglru_err = check_rglru(torch, rg, dev)
    wkv_err = check_wkv6(torch, rw, dev)
    gmm_err = check_moe_gmm(torch, mg, dev)
    bwd_errs = {"rglru_bwd": check_rglru_bwd(torch, rg, dev),
                "moe_gmm_bwd": check_moe_gmm_bwd(torch, mg, dev),
                "flash_bwd256": check_flash_bwd256(torch, fa, dev)}
    check_small_model(torch, dev)
    check_small_paligemma(torch, ops, dev)
    check_small_hybrid(torch, dev)
    check_small_moe(torch, dev)
    check_small_moe_split(torch, ops, serve)
    check_small_training(torch, ops, dev)
    check_small_engines(torch, dev)
    check_small_streaming(torch, ops, dev)
    phase("build and kernel checks")

    static, split, launches, serve_calls = run_main_path(torch, ops, serve,
                                                         wc)
    print(f"main path static: prefill {static['prefill_ms']:.2f} ms, "
          f"decode {static['decode_tok_s']:.1f} tok/s")
    for w, res in split.items():
        print(f"main path split {w}: prefill {res['prefill_ms']:.2f} ms, "
              f"decode {res['decode_tok_s']:.1f} tok/s, {res['frames']} "
              f"frames, {res['measured_payload_bytes']} B measured == billed")

    profile_serving(torch, dev, ARCH, 4)
    torch.cuda.empty_cache()
    phase(f"{ARCH} serving and profile")

    hybrid, rg_launches, rg_peak = run_hybrid_serving(torch, ops, serve)
    print(f"main path {RG_ARCH} static: prefill {hybrid['prefill_ms']:.2f} "
          f"ms, decode {hybrid['decode_tok_s']:.1f} tok/s, peak "
          f"{rg_peak:.2f} GB")
    del hybrid
    profile_serving(torch, dev, RG_ARCH, 1, watch=("rglru",))
    torch.cuda.empty_cache()
    phase(f"{RG_ARCH} serving and profile")

    moe_res, gr_launches, gr_peak = run_moe_serving(torch, ops, serve)
    gr_prefill = moe_res["prefill_launches"]
    print(f"main path {GR_ARCH} static: prefill {moe_res['prefill_ms']:.2f} "
          f"ms, decode {moe_res['decode_tok_s']:.1f} tok/s, peak "
          f"{gr_peak:.2f} GB")
    del moe_res
    profile_serving(torch, dev, GR_ARCH, 1)
    torch.cuda.empty_cache()
    phase(f"{GR_ARCH} serving and profile")

    cb, cb_profiles, cb_gap, cb_peak, _ = run_continuous(torch, ops, serve,
                                                         card)
    for name, r in cb.items():
        p = cb_profiles.get(name)
        print(f"main path continuous {ARCH} {name}: {r['tok_s']:.1f} tok/s"
              + (f"; decode step {p['busy_ms']:.3f} device ms, idle share "
                 f"{p['idle']:.3f} traced, {p['idle_untraced']:.3f} against "
                 f"the untraced {p['untraced_ms']:.3f} ms" if p else "")
              + f" ({card})")
    print(f"main path continuous {ARCH}: teacher-forced logit gap "
          f"{cb_gap:.4e} of the largest |logit| (tol {CB_TOL}); peak "
          f"{cb_peak:.2f} GB")
    phase("continuous serving")

    qm_serve = run_qwen3_serving(torch, ops, serve, card)
    profile_serving(torch, dev, QM_ARCH, 2)
    _serving_lines(QM_ARCH, qm_serve, card)
    phase(f"{QM_ARCH} serving")

    rs_serve = run_rwkv_serving(torch, ops, serve, card)
    profile_serving(torch, dev, T_ARCH, 4, watch=("wkv6",))
    _serving_lines(T_ARCH, rs_serve, card)
    phase(f"{T_ARCH} serving")

    rows, train_launches, train_calls = run_training_path(
        torch, ops, train, protocol, dev, wc,
        lambda res: profile_training_step(torch, res, {"WKV6": "wkv6"}))
    for wire, rs in rows.items():
        for r in rs:
            print(f"main path train {wire} step {r['step']}: loss "
                  f"{r['loss']:.5f}, {r['step_ms']:.1f} ms, "
                  f"{r['tokens_per_s']:.0f} tokens/s, peak "
                  f"{r['peak_gb']:.2f} GB, hop up {r['hop_bytes_up']} B, "
                  f"down {r['hop_bytes_down']} B")
    run_c2p2sl(torch, dev)
    phase(f"{T_ARCH} training, profile and c2p2sl step")

    run_wireless(torch, ops, dev, card)
    phase("wireless C2P2SL")
    live_cuda_tensors(torch, "before the qwen training phases")

    q_rows, q_launches, q_calls = run_qwen_training(torch, ops, train,
                                                    protocol, dev, wc, card)
    for r in q_rows:
        print(f"main path train {ARCH} int8 step {r['step']}: loss "
              f"{r['loss']:.5f}, {r['step_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} "
              f"GB, hop up {r['hop_bytes_up']} B, down "
              f"{r['hop_bytes_down']} B")
    phase(f"{ARCH} training and profile")

    tk_rows, tk_launches, tk_calls = run_qwen_topk_training(
        torch, ops, train, protocol, dev, wc, card, q_rows[0]["loss"])
    for r in tk_rows:
        print(f"main path train {ARCH} v {TK_V} {TK_WIRE} step {r['step']}: "
              f"loss {r['loss']:.5f}, {r['step_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} "
              f"GB, hop up {r['hop_bytes_up']} B, down "
              f"{r['hop_bytes_down']} B ({card})")
    tc_rows, tc_launches, tc_grads, tc_calls = run_qwen_compressed(
        torch, ops, protocol, dev, wc, card)
    phase(f"{ARCH} interleaved top-k and compressed training")

    st_launches, st_calls, ss_launches, ss_calls = run_streaming_path(
        torch, ops, serve, dev, wc, card, split["int8"]["tokens"])
    launches = dict(collections.Counter(launches) + collections.Counter(
        ss_launches))
    serve_calls = serve_calls + ss_calls
    phase("streaming C2P2SL")

    rp_launches, rp_calls = run_ckpt_phase(torch, ops, train, protocol, card)
    phase(f"{ARCH} checkpoint, resume and replan")

    gt_rows, gt_launches, _gt_calls = run_granite_training(
        torch, ops, train, protocol, dev, wc, card)
    for r in gt_rows:
        print(f"main path train {GR_ARCH} int8 step {r['step']}: loss "
              f"{r['loss']:.5f}, aux {r['aux']:.5f}, {r['step_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} "
              f"GB, hop up {r['hop_bytes_up']} B, down "
              f"{r['hop_bytes_down']} B ({card})")
    phase(f"{GR_ARCH} training and profile")

    rt_rows, rt_launches = run_hybrid_training(torch, ops, train, protocol,
                                               dev, card)
    for r in rt_rows:
        print(f"main path train {RG_ARCH} k {RT_K} step {r['step']}: loss "
              f"{r['loss']:.5f}, {r['step_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} "
              f"GB ({card})")
    phase(f"{RG_ARCH} training and profile")

    wh = run_whisper(torch, ops, serve, train, protocol, dev, wc, card)
    profile_serving(torch, dev, WH_ARCH, 4, batch=WH_BATCH, prompt=WH_PROMPT,
                    gen=WH_GEN)
    phase(f"{WH_ARCH} serving and training")

    pg = run_paligemma(torch, ops, serve, train, protocol, dev, wc, card)
    profile_serving(torch, dev, PG_ARCH, 4, prompt=PG_PROMPT, gen=PG_GEN)
    print(f"main path {PG_ARCH}: CLI token loop "
          f"{pg['cli']['decode_tok_s']:.1f} tok/s; patch prefill {pg['prefill_ms']:.2f} ms, decode "
          f"{pg['tok_s']:.1f} tok/s, peak {pg['prefill_peak']:.2f} GB; "
          f"training {[round(r['step_ms'], 1) for r in pg['train_rows']]} "
          f"ms a step, peak "
          f"{max(r['peak_gb'] for r in pg['train_rows']):.2f} GB ({card})")
    phase(f"{PG_ARCH} serving and training")

    rg_all = dict(collections.Counter(rg_launches) + collections.Counter(
        {k: v for k, v in rt_launches.items() if not k.endswith("_bwd")}))
    kernels = time_kernels(torch, wc, fa, rw, rg, dev, launches, rg_all,
                           (train_launches, q_launches, tk_launches,
                            tc_launches, st_launches, gt_launches,
                            rp_launches),
                           (serve_calls,
                            train_calls + q_calls + tk_calls + tc_calls
                            + st_calls + rp_calls, tc_grads),
                           flash_err, wkv_err, rglru_err, ptxas)
    gr_all = dict(collections.Counter(gr_launches) + collections.Counter(
        {"moe_gmm": gt_launches["moe_gmm"]}))
    kernels += time_moe(torch, mg, fa, dev, collections.Counter(gr_prefill)
                        + collections.Counter({"moe_gmm":
                                               gt_launches["moe_gmm"]}),
                        gr_all, gmm_err, flash_err[GR_HEADS[2]])
    kernels += time_backwards(torch, rg, mg, fa, dev, gt_launches,
                              rt_launches, bwd_errs,
                              [r for rows in ptxas.values() for r in rows])
    kernels += time_serving_shapes(torch, fa, mg, rw, dev, qm_serve,
                                   rs_serve, flash_err, gmm_err, wkv_err)
    kernels += time_whisper(torch, fa, dev, wh, flash_err)
    kernels += time_paligemma(torch, fa, dev, pg, flash_err)
    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), library {k['library_ms']}, "
              f"launches {k['launches']}")
    phase("kernel timings")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
