#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, offload (optimizer and parameter),
checkpoint and training-feature paths on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
torch + numpy; it imports nothing of JAX. Phases, in order; any failure exits
non-zero:

1. header: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel of ``deepspeed_tpu_torch/ops/csrc/``, one ``nvcc`` each,
   all at once;
3. kernel checks (``deepspeed_tpu_torch/ops/kernel_checks.py``): each kernel
   against its plain version on the card, with its time, the plain version's,
   one PyTorch library call's as a yardstick, and the bound (the dense and
   paged decode kernels also with the cluster size S their wrappers pick,
   and the paged kernel with K2 on the same rows);
4. main path: ``init_inference`` on GPT-2 125M (``bench.py``'s serving
   configuration, seeded random weights, bf16) and ``generate`` on 4 prompts
   of 512 tokens (one shortened to 384), 64 new tokens, greedy. The launch
   counts must show every prefill attention in the flash kernel and every
   decode attention in the decode kernel; the prefill logits must agree with
   the same engine run on the plain versions; one more ``generate`` is traced
   with torch.profiler to show where its device time goes, and K2's share
   of it (``dense_decode_split``);
5. serving path: ``ContinuousBatchingScheduler`` on the same GPT-2 125M
   engine, 16 slots, chunks of 8 steps, the paged KV pool (page 16, cap
   1024) with the prefix cache inserting at prefill, and 48 greedy requests
   from ``np.random.default_rng(0)``, all submitted up front: a shared
   250-token system prefix (not page-aligned, so hits copy their boundary
   page) and a user suffix of 8-256 tokens, ``max_new_tokens`` from {16, 32,
   64, 128}, drained by ``run()``. Every request must finish with exactly its
   budget; the launch counts must be exact (paged kernel = n_layer x
   chunk_size x chunks, dense decode 0, flash forward = n_layer x prefix
   misses); there must be prefix hits and copy-on-write copies; one mid-run
   decode step of the whole slot-batch, from a copy of the pool, must give
   logits within 0.1 of the same step on the plain versions on every live
   slot; one chunk of a second run is traced (the paged kernel's device time
   and launches). Then the same 48 requests run
   on an int8 weight-quantized engine of the same model: every request must
   finish with its budget, the dequant-GEMM must launch exactly 72 times (12
   layers x 6 projections) per forward pass the scheduler's telemetry counts
   (prefills and decode steps), the paged kernel as in the bf16 run; one
   chunk of a second int8 run is traced (the dequant-GEMM's and the paged
   kernel's device time and the launches of a decode step). Then
   speculative decoding (``[spec]``, ``ServingConfig(speculate=True,
   spec_k=4)``) on the same configuration: (a) the n-gram proposer (n-grams
   4 down to 1) on the 48 requests: every request finishes with its budget;
   launch counts exact (flash forward n_layer x prefix misses, the paged and
   the dense decode kernels 0: every decode chunk is one verify round); each
   request's tokens equal its ``[serve]`` tokens, or first differ where the
   ``[serve]`` stream's top-2 logit margin (a flash-kernel prefill of the
   prompt and the common prefix) is at most 0.2; the spec counters,
   requests/s, tokens/s and TPOT beside ``[serve]``'s; (b) after scheduler
   step 6 the pool is copied, one verify round runs on a copy and the same
   window tokens go one at a time through paged-kernel decode steps from a
   second copy: logits within 0.1 at every window position of every live
   slot, argmax equal wherever the step's top-2 margin exceeds 0.2; (c) a
   draft-model proposer (a second engine of the same seed, so the target's
   weights) on the first 8 requests, budgets capped at 32: budgets,
   divergences as in (a), acceptance >= 0.5, passes a token <= 0.5, the
   draft engine's flash forward (n_layer a ``generate``) and dense decode
   kernel (n_layer x (k - 1) a ``generate``) launch counts exact; (d) (a)'s
   traffic on the int8 engine: budgets, the dequant-GEMM 72 x (prefills +
   verify rounds), the paged kernel 0; (e) one traced verify round (device
   time, busy share, launches) and a second one with the device time of the
   page gather, of ``prefix_attention`` and of the window's cache write;
6. training path: ``initialize`` on GPT-2 125M at ``bench.py``'s training
   configuration (vocab 50304, seq 1024, micro-batch 24, bf16 AdamW lr 2e-4,
   weight decay 0.01, ZeRO stage 1, clipping 1.0; seeded random weights, no
   remat) and 3 warm-up plus 20 timed ``train_batch`` steps on one seeded
   batch. The launch counts over the timed steps must show every attention
   forward in the flash kernel and every attention backward in the two
   backward kernels (12 layers x 20 steps each); every loss must be finite and
   the last below the first; the loss and every parameter's gradient of one
   micro-batch of 4 must agree with the plain attention's; one more
   ``train_batch`` is traced with torch.profiler;
7. block-sparse training (``[sparse]``): the same model and training
   configuration with ``attention_impl=make_sparse_attention_impl(...)`` of
   the Fixed layout in ``kernel_checks.GPT2_SPARSE`` (block 16, 4 local
   blocks, 1 global block, 4 global patterns, unidirectional), 3 warm-up and
   20 timed ``train_batch`` steps on the same batch. The launch counts over
   the timed steps must show every attention in the three block-sparse
   kernels (12 x 20 each) and none in the flash kernels; losses finite and
   falling; the loss and every gradient of a micro-batch of 4 against the
   plain block-sparse versions; step ms, tokens/s and peak memory beside
   ``[train]``'s step; one traced ``train_batch`` with its device time in
   the three block-sparse kernels;
8. weight-quantized serving (``[wq]``): BLOOM-7B at full width and depth as
   ``bench.py --wq`` serves it on a TPU (vocab 250,880, n_embd 4,096, 30
   layers, 32 heads, ALiBi, tied head; seeded random weights, bf16), batch
   1, a 512-token prompt, greedy; three lanes built one after another on
   one seed: bf16, int8 and int4 (``weight_quant``, group 128). Each lane:
   warm-up, then 3 rounds of ``generate`` at 64 and at 16 new tokens (decode
   tokens/s by differencing the two, TTFT); launch counts exact in every
   call (dequant-GEMM 180 x new tokens in the quantized lanes, flash forward
   30, dense decode 0: BLOOM decode attends in plain PyTorch); greedy
   parity of int8 (>= 0.98) and int4 (reported) against bf16, teacher-forced
   on the bf16 lane's own tokens; 180 matrices quantized; modeled weight
   bytes reduced >= 1.9x (int8) and >= 3.5x (int4) on the quantized
   matrices; peak memory; one traced decode step (the dequant-GEMM's device
   time and the step's launches). The bf16 lane also
   quantizes layer 0's fc_in on the card and on the CPU, which must agree
   byte for byte, and with the quantized lanes' own;
9. MoE serving (``[moe]``): GPT-2 125M with every 2nd FFN a top-1 mixture of
   8 experts, as ``bench.py``'s MoE lane serves it (vocab 50304, 12 layers,
   width 768, ffn 3072; seeded random weights, bf16), batch 1, a 512-token
   prompt, greedy: warm-up, then 3 rounds of ``generate`` at 256 and at 64
   new tokens (decode tokens/s by differencing, TTFT); launch counts exact in
   every call (selected-expert FFN 6 x (new - 1), flash forward 12, dense
   decode 12 x (new - 1)); one decode step's logits on the kernel within 0.1
   of the plain FFN's; teacher-forced, the plain FFN's greedy tokens fed
   through the kernel and the plain FFN step by step (batch 1 over 64 steps,
   a batch of 16 over 8; the plain run's routing replayed in the kernel's):
   logits within 0.1 at every step, argmax equal wherever the plain top-2
   margin exceeds 0.2; one traced decode
   step (with K2's share); ``[serve]``'s 48 requests through the scheduler (every request
   finishes with its budget, selected-expert FFN 6 x 8 x chunks); the dense
   twin (no experts) on the same seed and traffic; a top-2 engine (16 new
   tokens); an int8 engine whose 12 expert stacks are quantized (the
   selected-expert FFN does not launch, the dequant-GEMM 60 x forwards);
10. head dims other than 64 and 128 (``[hd]``), at full width, seeded random
   weights, bf16: ``initialize`` must refuse a GPT-2 of head_dim 256 and
   ``init_inference`` one of head_dim 84 (ValueError naming it, no launch,
   nothing left on the card); GPT-2 2.7B (``gpt2-2.7b``, head_dim 80) and
   GPT-J-6B's shape (head_dim 256) each through ``generate`` as in 4 (64 and
   32 new tokens) and the scheduler as in 5 (16 and 8 requests), held to the
   same launch counts, logits, budgets and traces; GPT-2 760M
   (``gpt2-760m``, head_dim 96) trained as in 6 (micro-batch 8, 3 warm-up
   and 10 timed steps) and as in 7 (the same Fixed layout over 16 heads, 3
   and 3), launch counts, losses and micro-batch-4 gradients as there. The
   kernels run their 128-wide builds at head dims 80 and 96 and their
   256-wide ones (K1, K2, K5) at 256; ``[check]`` times them at these shapes
   (the cases of ``kernel_checks`` with an ``hd_run``). Each prefill also
   runs through the plain attention in f32 (the same weights, widened), and
   the kernel's bf16 logits must lie within 0.1 of those: at 28-32 layers a
   second bf16 run (the plain attention in bf16) carries rounding of its
   own as large as the kernel's, so both its distances, from f32 and from
   the kernel's logits, are printed beside;
11. training checkpoints (``[ckpt]``, right after ``[sparse]``): ``[train]``'s
   GPT-2 125M and configuration plus a WarmupLR schedule, seeded distinct
   batches a step, in a temporary directory it removes (free disk printed
   first). (a) Engine A takes steps 1-3, saves ``global_step3`` and takes
   4-6; A2 repeats A's run, to measure whether two identical runs agree bit
   for bit; engine B (another seed) loads ``latest``: every restored tensor
   (masters, both moments, Adam's step, the loss scaler, the step counters)
   and counter and the schedule equal to what was saved, bit for bit; B's
   steps 4-6 (losses and final masters) equal to A's, or, where A and A2
   differ, within their spread (the first differing tensor is printed); K1,
   K3 and K4 launch 12 times a step in every engine. (b) ``chip_smoke.py
   --ckpt-child DIR crash`` commits ``good`` after two steps, records step
   3's loss and dies by a ``kill`` fault inside a shard write of ``bad``;
   ``--ckpt-child DIR resume`` loads and takes step 3: SIGKILL, ``bad`` not
   visible, ``good`` validates strictly, the two losses equal. (c) SIGTERM to
   this process under ``CheckpointAutoSaver``: ``after_step`` saves, writes
   the marker and exits 143 (the one exit the phase expects); ``resume``
   into a third engine restores it and clears the marker. (d) The universal
   export read back with ``torch.load`` equals the masters and moments;
   ``zero_to_fp32`` equals ``export_fp32_state_dict``; ``global_step3`` served
   through ``zero_to_fp32`` -> ``convert_training_model`` ->
   ``init_inference`` (bf16; 4 prompts of 512 tokens, 32 new; K1 12 and K2 12
   x 31 exact), its logits within LOGITS_TOL of the training forward's on
   the same prompts and weights; a tag with the serving names through
   ``InferenceEngine.load_checkpoint`` gives the built engine's tokens. (e)
   Bytes written, save seconds (device-to-host, write, hash + fsync, commit),
   load seconds (validate, read, host-to-device), GB/s, free and peak disk
   beside the ``nvidia-smi`` line. (f) Peak device memory during the save
   and during the load at most 2 x the largest tensor (``wte`` in f32) above
   the level before;
12. activation checkpointing and the chunked-vocab loss (``[remat]``, right
   after ``[train]``, before ``[sparse]``): ``[train]``'s GPT-2 125M and
   configuration through the same ``train_run`` in five engines from one
   seed, 3 warm-up and 10 timed steps each: no remat, ``remat=True`` with
   ``remat_policy="full"``, ``"dots"``, ``"dots"`` with
   ``vocab_chunk=8192``, and ``"offload_dots"`` (dots' products in pinned
   host memory). Launch counts exact (the flash forward 24 a step under
   remat, 12 without; both backward kernels 12); every run's losses finite
   and falling; under full, dots and offload_dots the 13 losses and every
   final master equal to the no-remat engine's bit for bit, or within the
   spread of a second no-remat run; the chunked loss's first loss within
   1e-4 of dots', and on its final weights the loss and every gradient of a
   micro-batch of 4 against the full-logits loss's (the limit between two
   readings printed beside it: the full-logits loss against itself, and the
   chunked backward with its ``dwte`` planted at zero) and the kernels
   against their plain versions as in 6; peak memory full < dots < no
   remat, offload_dots < dots, and dots + chunk at least one f32 ``(b, t,
   V)`` buffer (4.61 GiB) below dots; step ms, tokens/s, MFU (model FLOPs,
   no recompute), peak memory and each step over the no-remat step; one
   traced full and one traced dots step, with the flash forward's device
   time beside ``[train]``'s. Then ``bench.py``'s long-sequence setting: seq
   32,768, micro-batch 1, ``remat_policy="full"``, ``vocab_chunk=8192``, 2 +
   3 steps: launch counts exact, losses finite and falling, peak memory at
   most 16 GiB, printed beside the peak predicted without the two knobs (not
   run).

13. ZeRO-Offload (``[offload]``, right after ``[remat]``): (A) GPT-2 1.3B as
   ``bench.py``'s 1.3B lane trains it (vocab 50304, seq 1024, width 2048, 24
   layers, 16 heads, remat ``dots``, micro-batch 4, bf16 AdamW lr 1e-4,
   weight decay 0.01, clip 1.0, ZeRO stage 3 with ``offload_optimizer:
   cpu``) on its seeded batch, 2 warm-up and 3 timed steps through
   ``train_run``, beside the same without offload: launch counts exact (K1
   48, K3 and K4 24 a step); losses finite and falling; the C++ Adam step
   within 1e-7 + 1e-6 |plain| of its plain version on every element of the
   first step; after 5 steps the per-tensor relative distance of the
   updates from the in-device engine's at most 5e-2 in the median over the
   tensors and 0.25 at the worst tensor, and a planted fault (the host
   moments never written) above both; the masters and moments pinned, the
   device parameters bf16; the offload engine's peak device memory at least
   8 bytes a parameter below the in-device engine's; step ms (mean, and
   median of 3 with a synchronise after each step), tokens/s,
   MFU, both peaks, the tier's host bytes; one traced offload step split
   into compute, copies each way and busy share, beside the tier's host
   times. (B) ``[train]``'s GPT-2 125M at micro-batch 8, stage 3 with
   offload, 3 steps: ``device: nvme`` under a temporary directory equal to
   ``cpu`` bit for bit (losses, masters, moments; the filesystem and whether
   O_DIRECT held printed); a save after step 2 resumed in a fresh engine,
   step 3 bit for bit, cpu and nvme; offload Adagrad's update within 5e-2
   of device Adagrad's for every tensor; fp16 with ``initial_scale_power``
   40 skips its first step and leaves the masters unchanged.

14. the training features (right after ``[ckpt]``), each through ``initialize``
   and ``train_batch``, launch counts exact and losses finite and falling in
   every run: ``[lm-train]``, ``causal_lm_model`` at seq 1024, micro-batch 4,
   bf16 AdamW, 3 + 5 steps: BLOOM-560M at its published widths (24 layers,
   width 1,024, 16 heads, vocab 250,880, ALiBi: K1, K3 and K4 24 a step with
   the slopes inside) and TinyLlama-1.1B's widths (GQA, 32 heads over 4, FFN
   5,632, vocab 32,000) cut to 4 layers, each held to the plain attention on
   one micro-batch as in 6; ``[moe-train]``, ``[moe]``'s GPT-2 125M + 8
   experts under ``GPT2MoEConfig``'s defaults (every 2nd layer, top-1,
   capacity 1.25, RSample, aux coefficient 0.01), micro-batch 8, 3 + 10
   steps, the aux loss and expert counts printed, then
   ``convert_training_model`` -> ``init_inference`` -> ``generate`` (K1 12,
   K2 12 x 15, K7 6 x 15) and the served prefill logits within LOGITS_TOL
   of the training forward in eval mode, its routing replayed; the served
   router's own choices differing on at most 4 % and on none with a gate
   margin above 0.05, a planted swapped-gate fault breaking both;
   ``[dropout]``, ``[train]``'s GPT-2 125M at dropout 0.1 through
   ``training_data``, micro-batch 8: no flash launch (attention dropout runs
   the plain attention), a second run from the seed, a remat-full run and a
   run resumed from a mid-run tag all bit for bit equal to the first;
   ``[optim]``, the same model at micro-batch 8 with LAMB, 1-bit Adam
   (``freeze_step`` 3), 0/1 Adam and 1-bit LAMB (``freeze_step`` 3), 3 + 5
   steps each: one update of six tensors on the card within 1e-6 + 1e-5
   |cpu| of the same update on CPU copies, and an fp16 overflow step that
   keeps every parameter and state tensor bit for bit.

15. ZeRO-3 parameter offload (``[param-offload]``, right after ``[offload]``):
   (A) GPT-2 1.3B's widths as ``bench.py:237-241`` sets them up (vocab
   50304, seq 1024, width 2048, 24 layers, 16 heads) through
   ``causal_lm_model(cfg, layers_per_group=1)``, bf16 AdamW lr 1e-4, weight
   decay 0.01, clip 1.0, micro-batch 4 on ``bench.py``'s batch: the resident
   engine (stage 3), then the streamed engine (``offload_param: cpu``, no
   byte on the card before its first step) from the resident engine's
   initial weights, 1 + 3 steps each. K1 144, K3 72, K4 72 in the 3 timed
   streamed steps (the forward stream and the recompute each run K1); every
   loss within 2e-2 of the resident one; the per-tensor update parity
   against the resident engine after 2 and 4 steps, with a planted fault
   (the embed segment pushed from the previous step's masters) outside the
   gate; every push of one step read back equal to its masters cast (the
   planted fault's not); the streamed peak at most 0.25 of the resident
   one; the window's
   ``peak_live_bytes`` equal to the largest adjacent pair of segments, from
   the shapes. Step ms, tokens/s, MFU, host bytes, bytes each way a step,
   the host split (push, accumulate, update) and one traced step's busy
   share printed. The trained masters served through ``init_inference``
   (K1 24, K2 24 x 15 in a 16-token ``generate``), prefill logits within
   LOGITS_TOL of ``apply_fn`` on the same masters in bf16. (A2) the same
   widths at 48 layers, streamed, 1 + 1 steps: launches exact, the same
   ``peak_live_bytes``, the peak at most lane A's plus the 24 extra boundary
   carries plus 0.25 GiB. (B) GPT-2 125M's widths through
   ``causal_lm_model``, micro-batch 8, gradient accumulation 2: ``nvme``
   equal to ``cpu`` bit for bit over 3 steps; a save after step 2 resumed
   in a fresh engine, step 3 bit for bit, cpu and nvme; an fp16 overflow
   skipped with every master kept; Adagrad's loss falling.

The last lines are a JSON line of the main paths' metrics, a JSON line on the
kernels, the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

import gc
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
N_NEW = 64
SERVE_REQUESTS, SERVE_PREFIX, SERVE_SLOTS, SERVE_CHUNK = 48, 250, 16, 8
SERVE_CHECK_STEP = 6   # the scheduler step after which the pool is copied for the check
# [spec]: draft tokens a verify window; the draft-model lane's requests and budget cap;
# the top-2 logit margin under which a greedy token may flip between two passes
SPEC_K, SPEC_DRAFT_REQUESTS, SPEC_DRAFT_BUDGET, SPEC_MARGIN = 4, 8, 32, 0.2
PROMPT = 512
SHORT_PROMPT = 384
LOGITS_TOL = 0.1   # bf16 prefill logits, kernel vs plain attention: see main_path()
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_MICRO, TRAIN_SEQ = 20, 3, 24, 1024
WQ_PROMPT, WQ_NEW, WQ_SHORT, WQ_ROUNDS = 512, 64, 16, 3
MOE_PROMPT, MOE_NEW, MOE_SHORT, MOE_ROUNDS, MOE_SMALL_NEW = 512, 256, 64, 3, 16
MOE_BLOCK_F = (16, 32, 64, 128)   # K7 f-block widths timed at the main-path shapes
MOE_TF_BATCH, MOE_TF_STEPS = 16, 8   # [moe]'s teacher-forced batch: n = 16 a MoE layer
WQ_PARITY_INT8 = 0.98   # bench.py's int8 acceptance: teacher-forced greedy parity vs bf16
WQ_REDUCTION = {8: 1.9, 4: 3.5}   # bench.py's modeled weight-byte reduction gates
GRAD_RTOL = 5e-2   # bf16 whole-model gradients, kernel vs plain attention: see train_path()
# [remat]: warm-up and timed steps of each engine, the vocab slice; the long
# sequence's length, warm-up and timed steps and its peak-memory limit
REMAT_WARMUP, REMAT_STEPS, REMAT_CHUNK = 3, 10, 8192
LONG_SEQ, LONG_WARMUP, LONG_STEPS, LONG_PEAK_GIB = 32768, 2, 3, 16.0
CHUNK_LOSS_TOL = 1e-4   # first loss, chunked vocab vs full logits (f32 summation order)
# chunked vs full-logits gradients (chunk_vs_full): on the H100 the worst tensor
# reads 3.7e-3 (dx rounded to bf16 a slice, against the full head's one rounding)
# and 0.71 with dwte planted at zero; 5e-2 lies near their geometric mean
CHUNK_GRAD_RTOL = 5e-2
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
# [offload]: bench.py's 1.3B lane (bench.py:237-272): preset, micro-batch, warm-up
# and timed steps, lr; lane B's micro-batch (GPT-2 125M)
OFFLOAD_PRESET, OFFLOAD_MICRO, OFFLOAD_WARMUP, OFFLOAD_STEPS, OFFLOAD_LR = (
    "gpt2-1.3b", 4, 2, 3, 1e-4)
OFFLOAD_B_MICRO = 8
# per tensor |dp_offload - dp_device| / |dp_device| after the steps: the CPU
# trajectory test's bf16 limit, on the median over the tensors, and on every
# tensor for lane B's Adagrad. Lane A's worst tensor has its own limit: on the
# H100 at GPT-2 1.3B, seed 0, offload reads median 5.7e-3 and max 8.0e-2
# (c_attn.weight, whose q/k gradients sit at the noise floor at init), the
# planted fault (host moments never written) median 0.66 and max 0.82; 0.25
# lies near the geometric mean of the two maxima
OFFLOAD_PARITY, OFFLOAD_PARITY_MAX = 5e-2, 0.25
# [param-offload]: warm-up and timed steps of lane A's engines; the streamed
# losses' distance from the resident ones; the streamed peak over the resident
# one; lane A2's depth and its peak's slack over lane A's plus the extra
# boundary carries; the served lane's new tokens; lane B's micro-batch
PARAM_OFFLOAD_WARMUP, PARAM_OFFLOAD_STEPS = 1, 3
PARAM_OFFLOAD_LOSS_TOL, PARAM_OFFLOAD_PEAK_RATIO = 2e-2, 0.25
PARAM_OFFLOAD_A2_LAYERS, PARAM_OFFLOAD_A2_SLACK = 48, 0.25 * 2**30
PARAM_OFFLOAD_SERVE_NEW, PARAM_OFFLOAD_B_MICRO = 16, 8
# per tensor |dp_streamed - dp_resident| / |dp_resident| (update_parity, the key
# biases left out): the median over the tensors and the worst tensor; every
# sound run within both, the planted fault (the embed segment pushed from the
# previous step's masters) outside them. The first step's gradients are the
# resident engine's bit for bit but wte's (its two contributions summed in bf16
# by autograd there, in f32 on the host here); bf16 rounding spreads that. On
# the H100 the sound runs read median 5.26e-3 (2 steps) and 5.58e-3 (4 steps),
# worst 4.60e-2 and 6.88e-2 (q/k projections); the fault 1.169e-2, worst
# 8.46e-2: 8e-3 lies near the geometric mean of 5.58e-3 and 1.169e-2, and the
# worst tensor's limit only catches a blow-up
PARAM_OFFLOAD_PARITY, PARAM_OFFLOAD_PARITY_MAX = 8e-3, 0.25
# the C++ Adam step against its plain version: it may contract a multiply and
# an add into one rounding, a few f32 ulps
HOST_RTOL, HOST_ATOL = 1e-6, 1e-7
SPIN_CYCLES = 2_000_000   # ~1.1 ms at the H100's 1.98 GHz boost: longer than any enqueue
# [hd]: GPT-2 2.7B's scheduler requests, GPT-J-6B's new tokens and requests,
# GPT-2 760M's training (micro-batch, warm-up and timed steps dense, then
# block-sparse)
HD_GPT2_REQUESTS, HD_GPTJ_NEW, HD_GPTJ_REQUESTS = 16, 32, 8
HD_MICRO, HD_WARMUP, HD_STEPS, HD_SPARSE_WARMUP, HD_SPARSE_STEPS = 8, 3, 10, 3, 3
# [lm-train]: micro-batch and timed steps (after TRAIN_WARMUP); TinyLlama's depth cut
LM_MICRO, LM_STEPS, LM_TINYLLAMA_LAYERS = 4, 5, 4
# [moe-train]: micro-batch, timed steps, new tokens of the served generate
MOE_TRAIN_MICRO, MOE_TRAIN_STEPS, MOE_TRAIN_NEW = 8, 10, 16
# [moe-train]'s served router against the training forward's choices (the
# latter replayed): the share of its own choices that may differ, and the
# recorded top-1 lead over the top-2 gate logit above which none may. On the
# H100 the sound router reads 0.72 % (89 of 12,288), its widest flipped
# margin 1.8e-2; the planted fault 23.3 %, 2,182 above 0.05; 0.04 lies near
# the geometric mean of the two shares
ROUTING_FLIP_LIMIT, ROUTER_MARGIN = 0.04, 0.05
# [dropout]: GPT-2's published dropout, micro-batch, steps of each engine
DROPOUT, DROPOUT_MICRO, DROPOUT_STEPS = 0.1, 8, 6
# [optim]: micro-batch, timed steps, each optimizer's extra keys, the fp16
# engine's steps before its overflow, the tensors updated on the card and the CPU
OPTIM_MICRO, OPTIM_STEPS, OPTIM_FP16_STEPS = 8, 5, 2
OPTIM_CASES = (("lamb", {}), ("onebitadam", {"freeze_step": 3}), ("zerooneadam", {}),
               ("onebitlamb", {"freeze_step": 3}))
OPTIM_CHECK_NAMES = ("wpe", "h.0.ln_1.weight", "h.0.c_attn.bias", "h.5.c_fc.weight",
                     "h.11.mlp_c_proj.bias", "ln_f.weight")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def expect(**counts) -> dict:
    """Expected launch counts: ``counts`` by kernel name, 0 for every other
    kernel of the port."""
    from deepspeed_tpu_torch.ops.kernel_checks import KERNEL_INFO
    unknown = set(counts) - set(KERNEL_INFO)
    if unknown:
        raise KeyError(f"no kernels named {sorted(unknown)}")
    return {name: counts.get(name, 0) for name in KERNEL_INFO}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times of the device work ``fn`` enqueues.
    The 50 MB L2 is flushed before each call, as a caller that streams other
    data in between would find it; then the card spins (``torch.cuda._sleep``)
    while the host enqueues ``fn``, so the time between the events is the
    device's and not the Python wrapper's."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_checks(device):
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    rows = {}
    for case in kc.CASES:
        res = kc.check(case, device, SEED)
        inp = kc.make_inputs(case, device, SEED)
        lib = kc.library_fn(case, inp)
        res.update(ms=time_ms(lambda: kc.run_kernel(case, inp)),
                   plain_ms=time_ms(lambda: kc.run_plain(case, inp), reps=5),
                   library_ms=None if lib is None else time_ms(lib))
        if case.kernel in ("decode_attention", "paged_decode_attention"):
            res["splits"] = kc.case_splits(case)
        if case.kernel == "paged_decode_attention":
            # for comparison only: K2 on the same rows laid out densely
            res["dense_decode_ms"] = time_ms(kc.dense_decode_fn(case, inp))
        if case.kernel == "moe_decode_ffn":
            # for comparison only: the gather path (w[idx] copies, cuBLAS bmm)
            res["gather_ms"] = time_ms(kc.moe_gather_fn(case, inp))
            if case.name.startswith("gpt2moe-") and case.dims["k"] == 1:
                res["block_f_ms"] = moe_block_f_sweep(case, inp)
        res["bound_ms"], res["bound_by"] = kc.bound_ms(case)
        shape = ("" if case.kernel == "quantized_matmul" else
                 f" causal={case.causal} layout={case.layout[0]}{case.layout[1]}"
                 if case.layout else
                 f" causal={case.causal} alibi={case.alibi} lens={case.lens}")
        print(f"[check] {case.kernel}/{case.name} {case.dims} {str(case.dtype)[6:]}{shape}: "
              f"max_abs_err={res['max_abs_err']:.3e} err/limit={res['err_ratio']:.3g} "
              f"(limit {res['atol']:g} + {res['rtol']:g}|plain|)"
              + (f" lse_err={res['lse_err']:.3e}" if "lse_err" in res else "")
              + f" | ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} library_ms="
              + ("null" if res["library_ms"] is None else f"{res['library_ms']:.4f}")
              + f" bound_ms={res['bound_ms']:.4f} ({res['bound_by']})"
              + (f" dense_decode_ms={res['dense_decode_ms']:.4f}"
                 if "dense_decode_ms" in res else "")
              + (f" splits={res['splits']}" if "splits" in res else "")
              + (f" gather_ms={res['gather_ms']:.4f}" if "gather_ms" in res else "")
              + (" block_f_ms={" + ", ".join(f"{bf}: {t:.4f}" for bf, t in
                                             res["block_f_ms"].items()) + "}"
                 if "block_f_ms" in res else ""), flush=True)
        if case.main_path:
            rows[case.kernel] = res
        if case.hd_run:
            rows.setdefault("hd", {}).setdefault(case.kernel, []).append((case, res))
        del inp
    return rows


def moe_block_f_sweep(case, inp):
    """K7 at each of ``MOE_BLOCK_F``'s f-block widths on one case's inputs (a
    width other than the plan's runs the slab kernel)."""
    from deepspeed_tpu_torch.ops.moe import moe_decode_ffn
    args = (inp["x"], inp["idx"], inp["w1"], inp["b1"], inp["w2"], inp["b2"], case.activation)
    return {bf: time_ms(lambda: moe_decode_ffn(*args, block_f=bf)) for bf in MOE_BLOCK_F}


def plain_moe():
    """Context manager: the MoE decode step's selected-expert FFN goes to its
    plain version on CUDA tensors too. Used only to make the reference run."""
    from unittest import mock

    from deepspeed_tpu_torch.models import causal_lm
    from deepspeed_tpu_torch.ops.moe import moe_decode_ffn_plain
    return mock.patch.object(causal_lm, "moe_decode_ffn", moe_decode_ffn_plain)


def plain_attention():
    """Context manager: the model's attention calls go to the plain versions
    on CUDA tensors too. Used only to make the reference run."""
    from contextlib import ExitStack
    from unittest import mock

    import numpy as np
    from deepspeed_tpu_torch.models import causal_lm
    from deepspeed_tpu_torch.ops.attention import flash
    from deepspeed_tpu_torch.ops.attention.decode import decode_attention_plain
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention_plain

    def flash_plain(q3, k3, v3, slopes=None, softmax_scale=None, causal=True, n_heads=1):
        scale = softmax_scale or 1.0 / float(np.sqrt(q3.shape[-1]))
        return flash.flash_fwd_plain(q3, k3, v3, slopes, scale, causal, n_heads)

    def bwd_plain(plain):
        def run(q3, k3, v3, do3, lse, delta, slopes=None, softmax_scale=None, causal=True,
                n_heads=1):
            scale = softmax_scale or 1.0 / float(np.sqrt(q3.shape[-1]))
            return plain(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads)
        return run

    def decode_plain(q, k_cache, v_cache, cache_len):
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      1.0 / float(np.sqrt(q.shape[-1])))

    def paged_plain(q, k_pages, v_pages, page_table, cache_len, cap):
        return paged_attention_plain(q, k_pages, v_pages, page_table, cache_len, cap,
                                     1.0 / float(np.sqrt(q.shape[-1])))

    stack = ExitStack()
    stack.enter_context(mock.patch.object(flash, "flash_fwd", flash_plain))
    stack.enter_context(mock.patch.object(flash, "flash_bwd_dq",
                                          bwd_plain(flash.flash_bwd_dq_plain)))
    stack.enter_context(mock.patch.object(flash, "flash_bwd_dkv",
                                          bwd_plain(flash.flash_bwd_dkv_plain)))
    stack.enter_context(mock.patch.object(causal_lm, "decode_attention", decode_plain))
    stack.enter_context(mock.patch.object(causal_lm, "paged_attention", paged_plain))
    return stack


def plain_sparse():
    """Context manager: block-sparse attention's three kernels go to their
    plain versions on CUDA tensors too. Used only to make the reference run."""
    from contextlib import ExitStack
    from unittest import mock

    import numpy as np
    from deepspeed_tpu_torch.ops.attention import block_sparse as bs

    def plain(fn, n_tensors):
        # the wrapper's signature: n_tensors tensors (tables included), then
        # block, softmax_scale, causal, n_heads
        def run(*args, **kw):
            opts = {"softmax_scale": None, "causal": False, "n_heads": 1,
                    **dict(zip(("block", "softmax_scale", "causal", "n_heads"),
                               args[n_tensors:])), **kw}
            scale = opts["softmax_scale"] or 1.0 / float(np.sqrt(args[0].shape[-1]))
            return fn(*args[:n_tensors], opts["block"], scale, opts["causal"],
                      opts["n_heads"])
        return run

    stack = ExitStack()
    for name, n_tensors in (("block_sparse_fwd", 5), ("block_sparse_bwd_dq", 8),
                            ("block_sparse_bwd_dkv", 8)):
        stack.enter_context(mock.patch.object(
            bs, name, plain(getattr(bs, f"{name}_plain"), n_tensors)))
    return stack


def profile_call(label: str, fn, top: int = 12):
    """Where a call's time goes: device time by kernel, summed over one traced
    call, and the device's busy share of the call's wall time (kernels run on
    one stream, so their times do not overlap). The call must end in a
    synchronise. The tracer slows the host, so the busy share reads low
    against an untraced run. Returns ``{"wall_us", "device_us", "launches",
    "by_kernel", "count_by_kernel", "kernels"}`` (device microseconds and
    launches by kernel name; each launch's name, start and end in
    microseconds, in order of start), or None when the tracer recorded no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return e.self_device_time_total

    # kernels only: a CPU operator's device time repeats its kernels' times
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    total = sum(device_us(e) for e in events)
    if total == 0:
        print(f"[profile] {label}: the tracer recorded no device time: not measured",
              flush=True)
        return None
    print(f"[profile] {label} traced: wall {wall_us / 1e3:.2f} ms, device "
          f"{total / 1e3:.2f} ms, busy share {total / wall_us:.3f}, "
          f"{sum(e.count for e in events)} kernel launches of {len(events)} names", flush=True)
    for e in sorted(events, key=device_us, reverse=True)[:top]:
        print(f"[profile]   {device_us(e) / 1e3:8.3f} ms  {e.count:6d} calls  {e.key[:90]}",
              flush=True)
    kernels = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == DeviceType.CUDA), key=lambda k: k[1])
    return {"wall_us": wall_us, "device_us": total, "launches": sum(e.count for e in events),
            "by_kernel": {e.key: device_us(e) for e in events},
            "count_by_kernel": {e.key: e.count for e in events},
            "kernels": kernels}


def k7_span_us(trace) -> float:
    """K7's time in a ``profile_call`` trace as the main path sees it: for
    each call, from its FFN kernel's start to its reduction's end, summed.
    The reduction may be launched as the FFN's programmatic dependent and
    then starts early and waits, so the sum of K7's kernel times counts
    that wait twice; the span does not."""
    total, start = 0.0, None
    for name, t0, t1 in trace["kernels"]:
        if "moe_ffn_mma" in name or "moe_ffn_slab" in name:
            start = t0
        elif "moe_ffn_reduce" in name and start is not None:
            total, start = total + t1 - start, None
    return total


def print_traced(phase: str, label: str, kernel: str, trace, out: dict, key: str) -> None:
    """One kernel's share of a ``profile_call`` trace, by the name its
    launches carry (``paged_decode_split`` for K5, ``dense_decode_split`` for
    K2: ``<T, D, G>`` instantiations), into ``out[key + "_ms"]`` and
    ``out[key + "_launches"]`` and printed."""
    mark = {"K5": "paged_decode_split", "K2": "dense_decode_split"}[kernel]
    keys = [k for k in trace["by_kernel"] if mark in k]
    ms = sum(trace["by_kernel"][k] for k in keys) / 1e3
    n = sum(trace["count_by_kernel"][k] for k in keys)
    out[f"{key}_ms"], out[f"{key}_launches"] = ms, n
    print(f"[{phase}] {label}: {kernel} {mark} {ms:.3f} ms in {n} launches "
          f"({1e3 * ms / max(n, 1):.2f} us a launch) of {trace['device_us'] / 1e3:.3f} ms "
          f"device ({ms / (trace['device_us'] / 1e3):.3f})", flush=True)


def gpt2_125m():
    from deepspeed_tpu_torch.models import gpt2_cfg
    return gpt2_cfg(vocab_size=50304, max_seq_len=1024, n_embd=768, n_layer=12, n_head=12)


def f32_prefill(engine, ids, lens, device):
    """The prefill logits of ``engine``'s model through the plain attention
    in f32: a second module of the same config in f32, its weights the
    engine's bf16 ones widened (exact), freed before returning."""
    import dataclasses

    import torch

    from deepspeed_tpu_torch.inference.decode_fns import prefill
    from deepspeed_tpu_torch.models import init_cache
    from deepspeed_tpu_torch.models.causal_lm import CausalLM

    cfg = dataclasses.replace(engine.model_config, dtype=torch.float32)
    ref = CausalLM(cfg, device=device)
    src = engine.module.state_dict()
    with torch.no_grad():
        for name, v in ref.state_dict().items():
            v.copy_(src[name])
    ref.requires_grad_(False).eval()
    with torch.inference_mode(), plain_attention():
        logits = prefill(ref, ids, init_cache(cfg, ids.shape[0], 1024, device=device), lens)
    del ref, src
    gc.collect()
    torch.cuda.empty_cache()
    return logits


def main_path(device, cfg=None, label: str = "main", n_new: int = N_NEW, engine=None,
              f32_witness: bool = False):
    """``init_inference`` (or the given ``engine`` of ``cfg``) and ``generate``
    on 4 prompts of 512 tokens (one shortened to 384), ``n_new`` new tokens:
    launch counts, prefill logits against the plain attention, greedy
    agreement, one traced ``generate``. ``cfg`` defaults to GPT-2 125M.
    With ``f32_witness`` the prefill also runs through the plain attention in
    f32, and LOGITS_TOL holds the kernel's logits to those; the plain bf16
    run's distances from them and from the kernel's are printed."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.decode_fns import prefill
    from deepspeed_tpu_torch.models import init_cache
    from deepspeed_tpu_torch.ops import op_builder

    if cfg is None:
        cfg = gpt2_125m()
    if engine is None:
        t0 = time.perf_counter()
        engine = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": 1024},
                                    device=device)
        torch.cuda.synchronize()
        print(f"[{label}] init_inference {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, size=(4, PROMPT)).astype(np.int64)
    lens = np.array([PROMPT, PROMPT, PROMPT, SHORT_PROMPT], np.int32)

    engine.generate(ids, max_new_tokens=4, prompt_lengths=lens)      # warm-up
    torch.cuda.reset_peak_memory_stats()
    op_builder.reset_launch_counts()
    out = engine.generate(ids, max_new_tokens=n_new, prompt_lengths=lens)
    launches = op_builder.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = out.shape[1] - PROMPT
    if out.shape != (4, PROMPT + n_new) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"generate returned shape {out.shape} or ids out of range")
    want = expect(flash_fwd=cfg.n_layer, decode_attention=cfg.n_layer * (n - 1))
    print(f"[{label}] launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"[{label}] launch counts {launches} != {want}")
    ttft, tpot, tps = engine.ttft, engine.tpot, engine.decode_tps

    # prefill logits: kernels vs plain attention, same engine, same inputs. bf16
    # activations through 12 layers, with P rounded at different points, move
    # logits of magnitude ~1 by a few bf16 ulp; LOGITS_TOL = 0.1 leaves room
    # for that and fails on any real disagreement.
    ids_dev = torch.from_numpy(ids).to(device)
    lens_dev = torch.from_numpy(lens).to(device)
    with torch.inference_mode():
        caches = init_cache(engine.model_config, 4, 1024, device=device)
        logits_k = prefill(engine.module, ids_dev, caches, lens_dev)
        with plain_attention():
            caches = init_cache(engine.model_config, 4, 1024, device=device)
            logits_p = prefill(engine.module, ids_dev, caches, lens_dev)
    if not bool(torch.isfinite(logits_k).all()) or logits_k.shape != (4, cfg.vocab_size):
        raise AssertionError(f"prefill logits non-finite or shaped {tuple(logits_k.shape)}")
    logit_err, witness = float((logits_k - logits_p).abs().max()), {}
    held, against, top = logit_err, "plain", float(logits_p.abs().max())
    if f32_witness:
        logits_32 = f32_prefill(engine, ids_dev, lens_dev, device)
        witness = {"kernel_vs_f32": float((logits_k - logits_32).abs().max()),
                   "plain_vs_f32": float((logits_p - logits_32).abs().max())}
        held, against = witness["kernel_vs_f32"], "the plain attention in f32"
        top = float(logits_32.abs().max())
        print(f"[{label}] prefill logits max_abs_err, not held: plain bf16 vs plain f32 "
              f"{witness['plain_vs_f32']:.4e}, kernel vs plain bf16 {logit_err:.4e}",
              flush=True)
        del logits_32
    print(f"[{label}] prefill logits max_abs_err kernel vs {against} {held:.4e} "
          f"(tol {LOGITS_TOL}, |logits| max {top:.3f})", flush=True)
    if not held <= LOGITS_TOL:
        raise AssertionError(f"[{label}] prefill logits differ by {held} > {LOGITS_TOL}")
    del caches, logits_k, logits_p
    with plain_attention():
        out_plain = engine.generate(ids, max_new_tokens=n_new, prompt_lengths=lens)
    agree = float((out_plain[:, PROMPT:] == out[:, PROMPT:]).mean())
    print(f"[{label}] greedy token agreement kernel vs plain: {agree:.4f} "
          "(not asserted: random-weight logits are near-ties)", flush=True)
    def traced_generate():
        engine.generate(ids, max_new_tokens=16, prompt_lengths=lens)
        torch.cuda.synchronize()

    result = {"ttft_ms": ttft * 1e3, "tpot_ms": tpot * 1e3, "decode_tokens_per_s": tps,
              "new_tokens": n, "launches": launches, "prefill_logit_err": logit_err,
              "token_agreement": agree, "peak_memory_bytes": peak,
              **{f"prefill_logit_err_{k}": v for k, v in witness.items()}}
    trace = profile_call(f"{label} generate(16 new)", traced_generate)
    if trace is not None:
        print_traced(label, "traced generate(16 new)", "K2", trace, result, "traced_k2")
    return result


def serve_step_logits(engine, snap, plain: bool):
    """One decode step of the whole slot-batch on a fresh copy of the pool
    state ``snap``: f32 logits ``(slots, V)``, through the kernels or, with
    ``plain``, through the plain versions."""
    import torch
    from contextlib import nullcontext
    pages = [{k: v.clone() for k, v in c.items()} for c in snap["caches"]]
    with torch.no_grad(), (plain_attention() if plain else nullcontext()):
        logits, _ = engine.module(snap["toks"], positions=snap["lens"][:, None], caches=pages,
                                  cache_lens=snap["lens"], page_table=snap["table"],
                                  kv_cap=snap["cap"])
    return logits[:, -1]


def serve_setup(cfg, n_requests: int = SERVE_REQUESTS):
    """The serving configuration (16 slots, chunks of 8, paged pool of page 16,
    prefix cache inserting at prefill) and ``n_requests`` (48) seeded requests:
    a shared 250-token prefix, a suffix of 8-256 tokens, budgets from {16, 32,
    64, 128}."""
    import numpy as np

    from deepspeed_tpu_torch.inference.serving import PrefixCacheConfig, ServingConfig
    config = ServingConfig(slots=SERVE_SLOTS, chunk_size=SERVE_CHUNK, max_queue=64,
                           max_seq_len=1024, kv_pool="paged", kv_page_size=16,
                           prefix_cache=PrefixCacheConfig(min_hit_tokens=8,
                                                          min_insert_tokens=8,
                                                          insert_on="prefill"))
    rng = np.random.default_rng(SEED)
    system = rng.integers(0, cfg.vocab_size, SERVE_PREFIX)
    requests = [(np.concatenate([system, rng.integers(0, cfg.vocab_size,
                                                      int(rng.integers(8, 257)))]),
                 int(rng.choice([16, 32, 64, 128]))) for _ in range(n_requests)]
    return config, requests


def serve_path(device, smi: str, cfg=None, engine=None, n_requests: int = SERVE_REQUESTS,
               label: str = "serve"):
    """``[serve]``: the scheduler on ``n_requests`` seeded requests (see the
    module's docstring). ``cfg`` defaults to GPT-2 125M; ``[hd]`` passes its
    own ``cfg`` and ``engine``."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
    from deepspeed_tpu_torch.ops import op_builder

    if cfg is None:
        cfg = gpt2_125m()
    if engine is None:
        engine = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": 1024},
                                    device=device)
    config, requests = serve_setup(cfg, n_requests)

    sched = ContinuousBatchingScheduler(engine, config)
    handles = [sched.submit(p, max_new_tokens=m) for p, m in requests]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    op_builder.reset_launch_counts()
    t0 = time.perf_counter()
    peak_pages, steps, snap = 0, 0, None
    while sched.busy:
        sched.step()
        steps += 1
        pool = sched.executor.pool
        peak_pages = max(peak_pages, pool.pages_in_use)
        if steps == SERVE_CHECK_STEP:
            # a copy of the mid-run slot-batch for the consistency check after the run
            snap = {"caches": [{k: v.clone() for k, v in c.items()} for c in pool.caches],
                    "table": torch.from_numpy(pool.page_table.copy()).to(device),
                    "toks": torch.from_numpy(sched._toks.copy()).to(device)[:, None],
                    "lens": torch.from_numpy(sched._lens.copy()).to(device),
                    "active": sched._active.copy(), "cap": sched.cap}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = op_builder.launch_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    tele = sched.telemetry.snapshot()

    bad = [(h.id, len(h.tokens), m, h.state.value) for h, (_, m) in zip(handles, requests)
           if len(h.tokens) != m or h.finish_reason != "length"]
    if bad:
        raise AssertionError(f"[{label}] requests that did not finish with their budget: {bad}")
    chunks, misses = tele["chunks"], tele["prefix_misses"]
    want = expect(flash_fwd=cfg.n_layer * misses,
                  paged_decode_attention=cfg.n_layer * SERVE_CHUNK * chunks)
    print(f"[{label}] launches {launches} (expected {want}: {chunks} chunks, {misses} prefix "
          f"misses)", flush=True)
    if launches != want:
        raise AssertionError(f"[{label}] launch counts {launches} != {want}")
    if not (tele["prefix_hits"] > 0 and tele["paged_cow_copies_total"] > 0):
        raise AssertionError(f"[{label}] no prefix hits or no copy-on-write copies: {tele}")

    live = torch.from_numpy(snap["active"]).to(device)
    logits_k = serve_step_logits(engine, snap, plain=False)
    logits_p = serve_step_logits(engine, snap, plain=True)
    if not bool(torch.isfinite(logits_k).all()) or logits_k.shape != (SERVE_SLOTS,
                                                                      cfg.vocab_size):
        raise AssertionError(f"serve step logits non-finite or shaped {tuple(logits_k.shape)}")
    step_err = float((logits_k[live] - logits_p[live]).abs().max())
    print(f"[{label}] mid-run decode step after scheduler step {SERVE_CHECK_STEP}, "
          f"{int(live.sum())} live slots of {SERVE_SLOTS}, lens "
          f"{snap['lens'][live].tolist()}: logits max_abs_err kernels vs plain "
          f"{step_err:.4e} (tol {LOGITS_TOL}, |logits| max "
          f"{float(logits_p[live].abs().max()):.3f})", flush=True)
    if not int(live.sum()) > 0 or not step_err <= LOGITS_TOL:
        raise AssertionError(f"[{label}] serve step logits differ by {step_err} > "
                             f"{LOGITS_TOL}")
    del snap, logits_k, logits_p

    tokens = sum(len(h.tokens) for h in handles)
    out = {"requests_per_s": n_requests / wall, "tokens_per_s": tokens / wall,
           "wall_s": wall, "generated_tokens": tokens,
           "ttft_ms_p50": tele["ttft_ms_p50"], "ttft_ms_p95": tele["ttft_ms_p95"],
           "tpot_ms_p50": tele["tpot_ms_p50"], "tpot_ms_p95": tele["tpot_ms_p95"],
           "chunk_ms_mean": sched.telemetry.decode_seconds / chunks * 1e3, "chunks": chunks,
           "prefix_hit_rate": tele["prefix_hit_rate"], "prefix_misses": misses,
           "cow_copies": tele["paged_cow_copies_total"], "peak_pages_in_use": peak_pages,
           "total_pages": tele["paged_total_pages"], "peak_memory_bytes": peak_mem,
           "step_logit_err": step_err, "launches": launches,
           "tokens": [h.result() for h in handles]}
    print(f"[{label}] {smi}: {n_requests} requests in {wall:.3f} s: "
          f"{out['requests_per_s']:.3f} requests/s, {out['tokens_per_s']:.1f} generated "
          f"tokens/s ({tokens} tokens); TTFT p50 {out['ttft_ms_p50']:.2f} ms p95 "
          f"{out['ttft_ms_p95']:.2f} ms; TPOT p50 {out['tpot_ms_p50']:.3f} ms p95 "
          f"{out['tpot_ms_p95']:.3f} ms; mean chunk {out['chunk_ms_mean']:.3f} ms over "
          f"{chunks} chunks of {SERVE_CHUNK} steps; prefix hit rate "
          f"{out['prefix_hit_rate']:.4f} ({misses} misses), {out['cow_copies']:.0f} COW copies; "
          f"peak pages in use {peak_pages} of {out['total_pages']:.0f}; peak memory "
          f"{peak_mem / 2**30:.2f} GiB", flush=True)

    # one chunk of a second run, 16 requests in flight, traced
    sched2 = ContinuousBatchingScheduler(engine, config)
    for p, m in requests[:SERVE_SLOTS]:
        sched2.submit(p, max_new_tokens=max(m, 2 * SERVE_CHUNK + 1))
    sched2.step()                   # admits all 16, runs one chunk

    def traced_chunk():
        sched2.step()
        torch.cuda.synchronize()

    trace = profile_call(f"{label} chunk ({SERVE_SLOTS} slots, {SERVE_CHUNK} steps)",
                         traced_chunk, top=15)
    if trace is not None:
        print_traced(label, "bf16 traced chunk", "K5", trace, out, "chunk_k5")
    sched2.run()
    del sched, sched2, engine
    gc.collect()
    return out


def serve_int8(device, smi: str, cfg, config, requests, bf16):
    """The same requests through an int8 weight-quantized engine of the same
    model: every projection of every forward pass in the dequant-GEMM."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
    from deepspeed_tpu_torch.ops import op_builder

    engine = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": 1024,
                                      "weight_quant": {"enabled": True, "bits": 8}},
                                device=device)
    n_q = sum(1 for e in engine.quant_audit if e["decision"] == "quantized")
    sched = ContinuousBatchingScheduler(engine, config)
    handles = [sched.submit(p, max_new_tokens=m) for p, m in requests]
    torch.cuda.synchronize()
    op_builder.reset_launch_counts()
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = op_builder.launch_counts()
    tele = sched.telemetry.snapshot()
    bad = [(h.id, len(h.tokens), m) for h, (_, m) in zip(handles, requests)
           if len(h.tokens) != m or h.finish_reason != "length"]
    if bad:
        raise AssertionError(f"int8 requests that did not finish with their budget: {bad}")
    chunks, hits, misses = tele["chunks"], tele["prefix_hits"], tele["prefix_misses"]
    forwards = hits + misses + SERVE_CHUNK * chunks
    per_forward = cfg.n_layer * 6
    want = expect(flash_fwd=cfg.n_layer * misses,
                  paged_decode_attention=cfg.n_layer * SERVE_CHUNK * chunks,
                  quantized_matmul=per_forward * forwards)
    print(f"[serve] int8: {n_q} matrices quantized; launches {launches} (expected {want}: "
          f"{forwards} forward passes = {hits + misses} prefills + {SERVE_CHUNK} x {chunks} "
          f"chunk steps)", flush=True)
    if launches != want or n_q != per_forward or hits + misses != len(requests):
        raise AssertionError(f"int8 launch counts {launches} != {want} or {n_q} matrices")
    tokens = sum(len(h.tokens) for h in handles)
    out = {"requests_per_s": len(requests) / wall, "tokens_per_s": tokens / wall,
           "wall_s": wall, "tpot_ms_p50": tele["tpot_ms_p50"], "tpot_ms_p95": tele["tpot_ms_p95"],
           "ttft_ms_p50": tele["ttft_ms_p50"], "chunks": chunks,
           "chunk_ms_mean": sched.telemetry.decode_seconds / chunks * 1e3,
           "launches": launches}
    print(f"[serve] {smi}: int8 {len(requests)} requests in {wall:.3f} s: "
          f"{out['requests_per_s']:.3f} requests/s (bf16 {bf16['requests_per_s']:.3f}), "
          f"{out['tokens_per_s']:.1f} generated tokens/s; TPOT p50 {out['tpot_ms_p50']:.3f} ms "
          f"p95 {out['tpot_ms_p95']:.3f} ms (bf16 {bf16['tpot_ms_p50']:.3f} / "
          f"{bf16['tpot_ms_p95']:.3f}); mean chunk {out['chunk_ms_mean']:.3f} ms over {chunks} "
          f"chunks", flush=True)

    # one chunk of a second run, 16 requests in flight, traced: the
    # dequant-GEMM's device time and the launches of a decode step
    sched2 = ContinuousBatchingScheduler(engine, config)
    for p, m in requests[:SERVE_SLOTS]:
        sched2.submit(p, max_new_tokens=max(m, 2 * SERVE_CHUNK + 1))
    sched2.step()

    def traced_chunk():
        sched2.step()
        torch.cuda.synchronize()

    prof = profile_call(f"int8 serve chunk ({SERVE_SLOTS} slots, {SERVE_CHUNK} steps)",
                        traced_chunk, top=15)
    sched2.run()
    if prof is not None:
        print_traced("serve", "int8 traced chunk", "K5", prof, out, "chunk_k5")
        out["chunk_qmm_ms"] = sum(v for key, v in prof["by_kernel"].items()
                                  if "qmm" in key) / 1e3
        out["step_launches"] = prof["launches"] / SERVE_CHUNK
        print(f"[serve] int8 traced chunk: dequant-GEMM {out['chunk_qmm_ms']:.3f} ms of "
              f"{prof['device_us'] / 1e3:.3f} ms device, {out['step_launches']:.1f} launches a "
              f"decode step", flush=True)
    del sched, sched2, engine
    gc.collect()
    return out


def spec_config(config, **kw):
    """``config`` with speculation on, ``SPEC_K`` draft tokens a window."""
    import dataclasses
    return dataclasses.replace(config, speculate=True, spec_k=SPEC_K, **kw)


def top2_margin(logits):
    """``(..., V)`` logits → the gap between their two largest values."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def spec_run(engine, config, requests, label: str, check_step=None):
    """The scheduler with ``config`` on ``requests``, launch counts from 0
    over the run; every request must finish with its budget. With
    ``check_step``, a copy of the pool and of the next round's windows
    (``_spec_windows``: the proposer is a pure function of the streams)
    after that scheduler step, for :func:`spec_verify_check`."""
    import torch

    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
    from deepspeed_tpu_torch.ops import op_builder

    device = engine.device
    sched = ContinuousBatchingScheduler(engine, config)
    handles = [sched.submit(p, max_new_tokens=m) for p, m in requests]
    torch.cuda.synchronize()
    op_builder.reset_launch_counts()
    t0 = time.perf_counter()
    steps, snap = 0, None
    while sched.busy:
        sched.step()
        steps += 1
        if steps == check_step:
            pool = sched.executor.pool
            proposals, spec_lens = sched._spec_windows()
            snap = {"caches": [{k: v.clone() for k, v in c.items()} for c in pool.caches],
                    "table": torch.from_numpy(pool.page_table.copy()).to(device),
                    "toks": sched._toks.copy(), "lens": sched._lens.copy(),
                    "active": sched._active.copy(), "cap": sched.cap,
                    "proposals": proposals, "spec_lens": spec_lens}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = op_builder.launch_counts()
    bad = [(h.id, len(h.tokens), m, h.state.value) for h, (_, m) in zip(handles, requests)
           if len(h.tokens) != m or h.finish_reason != "length"]
    if bad:
        raise AssertionError(f"[spec] {label}: requests that did not finish with their "
                             f"budget: {bad}")
    return sched, handles, launches, sched.telemetry.snapshot(), wall, snap


def spec_divergences(engine, requests, got, want, label: str) -> dict:
    """Each request's speculative tokens ``got`` against the non-speculative
    ``want``: where they first differ, the top-2 margin of the
    non-speculative stream there, from a flash-kernel prefill of the prompt
    and the common prefix, must be at most ``SPEC_MARGIN`` (a near-tie that
    the two passes' numerics may flip). Printed and returned."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.decode_fns import prefill
    from deepspeed_tpu_torch.models import init_cache

    device = engine.device
    identical, margins = 0, []
    for i, ((prompt, _), g, w) in enumerate(zip(requests, got, want)):
        d = next((j for j in range(len(g)) if g[j] != w[j]), None)
        if d is None:
            identical += 1
            continue
        ids = np.concatenate([prompt, w[:d]]).astype(np.int64)[None]
        with torch.inference_mode():
            caches = init_cache(engine.model_config, 1, ids.shape[1], device=device)
            logits = prefill(engine.module, torch.from_numpy(ids).to(device), caches,
                             torch.tensor([ids.shape[1]], dtype=torch.int32, device=device))
        margins.append({"request": i, "position": d, "margin": float(top2_margin(logits)[0])})
    print(f"[spec] {label}: {identical} of {len(requests)} requests identical to the "
          f"non-speculative [serve] tokens; first divergences (request, position, top-2 "
          f"margin): {[(m['request'], m['position'], round(m['margin'], 4)) for m in margins]}"
          f" (each must be <= {SPEC_MARGIN})", flush=True)
    over = [m for m in margins if not m["margin"] <= SPEC_MARGIN]
    if over:
        raise AssertionError(f"[spec] {label}: divergences where the non-speculative margin "
                             f"exceeds {SPEC_MARGIN}: {over}")
    return {"identical": identical, "divergences": margins}


def spec_verify_check(engine, snap) -> dict:
    """``[spec]`` (b): one verify round on a copy of the pool, then the same
    window tokens fed one at a time through paged-kernel decode steps from a
    second copy. At every window position of every live slot the verify
    logits must lie within LOGITS_TOL of the step's, and the argmax must
    agree wherever the step's top-2 margin exceeds SPEC_MARGIN."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.decode_fns import paged_spec_verify

    device = engine.device

    def dev(x):
        return torch.from_numpy(np.asarray(x)).to(device)

    ids = dev(np.concatenate([snap["toks"].reshape(-1, 1), snap["proposals"]], axis=1))
    lens, valid, active = dev(snap["lens"]), dev(snap["spec_lens"] + 1), dev(snap["active"])
    W = ids.shape[1]
    with torch.no_grad():
        pages = [{k: v.clone() for k, v in c.items()} for c in snap["caches"]]
        verify = paged_spec_verify(engine.module, ids, pages, snap["table"], lens, valid,
                                   active, snap["cap"])
        pages = [{k: v.clone() for k, v in c.items()} for c in snap["caches"]]
        steps = []
        for j in range(W):
            lj = lens + j
            logits, _ = engine.module(ids[:, j:j + 1], positions=lj[:, None], caches=pages,
                                      cache_lens=lj, page_table=snap["table"],
                                      kv_cap=snap["cap"])
            steps.append(logits[:, -1])
        step = torch.stack(steps, dim=1)
    live = active[:, None] & (torch.arange(W, device=device)[None] < valid[:, None])
    if not bool(torch.isfinite(verify[live]).all()):
        raise AssertionError("[spec] verify logits are not finite")
    err = float((verify - step).abs().amax(dim=-1)[live].max())
    sure = live & (top2_margin(step) > SPEC_MARGIN)
    flips = int((verify.argmax(-1) != step.argmax(-1))[sure].sum())
    out = {"positions": int(live.sum()), "live_slots": int(active.sum()),
           "drafted": int(snap["spec_lens"][snap["active"]].sum()), "max_abs_err": err,
           "argmax_checked": int(sure.sum()), "argmax_flips": flips}
    print(f"[spec] teacher-forced verify after scheduler step {SERVE_CHECK_STEP}: "
          f"{out['live_slots']} live slots, {out['positions']} window positions "
          f"({out['drafted']} drafted): verify logits vs paged-kernel steps max_abs_err "
          f"{err:.4e} (tol {LOGITS_TOL}); argmax differs at {flips} of {out['argmax_checked']} "
          f"positions with top-2 margin > {SPEC_MARGIN}", flush=True)
    if not out["live_slots"] > 0 or not err <= LOGITS_TOL or flips:
        raise AssertionError(f"[spec] teacher-forced verify check failed: {out}")
    return out


def range_device_ms(fn, targets: dict) -> dict:
    """Device milliseconds of the kernels that each target function launches
    in one traced call of ``fn``: ``targets`` maps a name to ``(module,
    attribute)``; each is wrapped in a ``record_function`` range of that
    name, whose host event sums its children's kernels. None where the
    tracer recorded no device time."""
    from contextlib import ExitStack
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(f, name):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return f(*args, **kwargs)
        return wrapped

    with ExitStack() as stack:
        for name, (mod, attr) in targets.items():
            stack.enter_context(mock.patch.object(mod, attr, ranged(getattr(mod, attr), name)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
    out = {}
    for name in targets:
        events = [e for e in prof.events()
                  if e.name == name and e.device_type == DeviceType.CPU]
        total = sum(e.device_time_total for e in events) / 1e3
        out[name] = {"ms": total if total > 0 else None, "calls": len(events)}
    return out


def spec_path(device, smi: str, serve: dict) -> dict:
    """``[spec]``: speculative decoding through the scheduler on ``[serve]``'s
    engine configuration and traffic (see the module's docstring): (a) the
    n-gram lane, (b) the teacher-forced verify check, (c) the draft-model
    lane, (d) the int8 lane, (e) one traced verify round."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import decode_fns
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
    from deepspeed_tpu_torch.models import causal_lm

    cfg = gpt2_125m()
    engine = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": 1024},
                                device=device)
    config, requests = serve_setup(cfg)
    out = {}

    def report(lane: str, tele: dict, wall: float, handles, beside: dict) -> dict:
        tokens = sum(len(h.tokens) for h in handles)
        res = {k: tele[k] for k in ("spec_rounds", "spec_proposed", "spec_accepted",
                                    "spec_acceptance_rate", "spec_passes_per_token",
                                    "tpot_ms_p50", "tpot_ms_p95", "ttft_ms_p50",
                                    "prefix_misses", "prefix_hits")}
        res.update(requests_per_s=len(handles) / wall, tokens_per_s=tokens / wall,
                   wall_s=wall, generated_tokens=tokens,
                   draft_ms_per_round=tele["spec_draft_s"] / tele["spec_rounds"] * 1e3,
                   verify_ms_per_round=tele["spec_verify_s"] / tele["spec_rounds"] * 1e3)
        print(f"[spec] {smi}: {lane}: {len(handles)} requests in {wall:.3f} s: "
              f"{res['requests_per_s']:.3f} requests/s, {res['tokens_per_s']:.1f} tokens/s, "
              f"TPOT p50 {res['tpot_ms_p50']:.3f} ms p95 {res['tpot_ms_p95']:.3f} ms; "
              f"{res['spec_rounds']} rounds, {res['spec_proposed']} proposed, "
              f"{res['spec_accepted']} accepted: acceptance "
              f"{res['spec_acceptance_rate']:.4f}, {res['spec_passes_per_token']:.4f} passes "
              f"a token; a round {res['draft_ms_per_round']:.3f} ms drafting + "
              f"{res['verify_ms_per_round']:.3f} ms verifying; non-speculative "
              f"{beside['label']}: "
              f"{beside['requests_per_s']:.3f} requests/s, {beside['tokens_per_s']:.1f} "
              f"tokens/s, TPOT p50 {beside['tpot_ms_p50']:.3f} ms p95 "
              f"{beside['tpot_ms_p95']:.3f} ms", flush=True)
        return res

    # (a) n-gram lane, with the pool copied for (b)
    sched, handles, launches, tele, wall, snap = spec_run(
        engine, spec_config(config, spec_ngram_max=4, spec_ngram_min=1), requests,
        "n-gram", check_step=SERVE_CHECK_STEP)
    misses = tele["prefix_misses"]
    want = expect(flash_fwd=cfg.n_layer * misses)
    print(f"[spec] n-gram launches {launches} (expected {want}: {misses} prefix misses, "
          f"{tele['spec_rounds']} verify rounds, no decode kernel)", flush=True)
    if launches != want:
        raise AssertionError(f"[spec] n-gram launch counts {launches} != {want}")
    out["ngram"] = report("n-gram", tele, wall, handles, {"label": "[serve] bf16", **serve})
    out["ngram"]["launches"] = launches
    out["ngram"].update(spec_divergences(engine, requests, [h.result() for h in handles],
                                         serve["tokens"], "n-gram"))
    del sched

    # (b) teacher-forced verify check on the copy
    out["verify_check"] = spec_verify_check(engine, snap)
    del snap
    gc.collect()

    # (c) draft-model lane: a second engine on the same seed, the target's weights
    draft = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": 1024},
                               device=device)
    reqs = [(p, min(m, SPEC_DRAFT_BUDGET)) for p, m in requests[:SPEC_DRAFT_REQUESTS]]
    sched, handles, launches, tele, wall, _ = spec_run(
        engine, spec_config(config, spec_proposer="draft_model", spec_draft_engine=draft),
        reqs, "draft-model")
    calls, misses, proposed = sched.proposer.calls, tele["prefix_misses"], tele["spec_proposed"]
    want = expect(flash_fwd=cfg.n_layer * (misses + calls),
                  decode_attention=cfg.n_layer * (proposed - calls))
    print(f"[spec] draft-model launches {launches} (expected {want}: {misses} target prefix "
          f"misses, {calls} draft generate calls of {proposed} proposed tokens)", flush=True)
    if launches != want:
        raise AssertionError(f"[spec] draft-model launch counts {launches} != {want}")
    out["draft"] = report("draft-model", tele, wall, handles,
                          {"label": "[serve] bf16 (48 requests)", **serve})
    out["draft"].update(launches=launches, draft_calls=calls)
    out["draft"].update(spec_divergences(
        engine, reqs, [h.result() for h in handles],
        [t[:m] for t, (_, m) in zip(serve["tokens"], reqs)], "draft-model"))
    if not (out["draft"]["spec_acceptance_rate"] >= 0.5
            and out["draft"]["spec_passes_per_token"] <= 0.5):
        raise AssertionError(f"[spec] draft-model acceptance "
                             f"{out['draft']['spec_acceptance_rate']} < 0.5 or passes a token "
                             f"{out['draft']['spec_passes_per_token']} > 0.5")
    del sched, draft
    gc.collect()

    # (e) one verify round of a second n-gram run, 16 requests in flight, traced
    sched2 = ContinuousBatchingScheduler(engine, spec_config(config))
    for p, m in requests[:SERVE_SLOTS]:
        sched2.submit(p, max_new_tokens=max(m, 2 * SERVE_CHUNK + 1))
    sched2.step()                   # admits all 16, runs one round

    def traced_round():
        sched2.step()
        torch.cuda.synchronize()

    trace = profile_call(f"spec verify round ({SERVE_SLOTS} slots, k {SPEC_K})", traced_round,
                         top=15)
    parts = range_device_ms(traced_round, {
        "page_gather": (decode_fns, "gather_kv_dense"),
        "prefix_attention": (causal_lm, "prefix_attention"),
        "write_rows": (causal_lm, "write_rows")})
    sched2.run()
    if trace is not None:
        out["round_trace"] = {"device_ms": trace["device_us"] / 1e3,
                              "wall_ms": trace["wall_us"] / 1e3,
                              "busy_share": trace["device_us"] / trace["wall_us"],
                              "launches": trace["launches"],
                              **{f"{k}_ms": v["ms"] for k, v in parts.items()},
                              **{f"{k}_calls": v["calls"] for k, v in parts.items()}}
        print(f"[spec] {smi}: traced verify round: device {out['round_trace']['device_ms']:.3f} "
              f"ms of {out['round_trace']['wall_ms']:.3f} ms wall (busy "
              f"{out['round_trace']['busy_share']:.3f}), {trace['launches']} launches; page "
              "gather " + ("not measured" if parts["page_gather"]["ms"] is None else
                           f"{parts['page_gather']['ms']:.3f} ms") +
              f" in {parts['page_gather']['calls']} calls, prefix_attention " +
              ("not measured" if parts["prefix_attention"]["ms"] is None else
               f"{parts['prefix_attention']['ms']:.3f} ms") +
              f" in {parts['prefix_attention']['calls']} calls, the window's cache write "
              "(write_rows) " + ("not measured" if parts["write_rows"]["ms"] is None else
                                 f"{parts['write_rows']['ms']:.3f} ms") +
              f" in {parts['write_rows']['calls']} calls (a second traced round)", flush=True)
    del sched2, engine
    gc.collect()

    # (d) int8 lane: (a)'s traffic on the int8 engine
    engine = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": 1024,
                                      "weight_quant": {"enabled": True, "bits": 8}},
                                device=device)
    sched, handles, launches, tele, wall, _ = spec_run(
        engine, spec_config(config), requests, "int8")
    hits, misses, rounds = tele["prefix_hits"], tele["prefix_misses"], tele["spec_rounds"]
    forwards = hits + misses + rounds
    want = expect(flash_fwd=cfg.n_layer * misses, quantized_matmul=cfg.n_layer * 6 * forwards)
    print(f"[spec] int8 launches {launches} (expected {want}: {forwards} forward passes = "
          f"{hits + misses} prefills + {rounds} verify rounds of m = {SERVE_SLOTS} x "
          f"{SPEC_K + 1} rows)", flush=True)
    if launches != want:
        raise AssertionError(f"[spec] int8 launch counts {launches} != {want}")
    out["int8"] = report("int8", tele, wall, handles,
                         {"label": "[serve] int8", **serve["int8"]})
    out["int8"]["launches"] = launches
    del sched, engine
    gc.collect()
    return out


def grads_of(engine, batch, loss_fn=None):
    """Loss and gradients of one micro-batch, from the engine's masters cast to
    the compute dtype, as a training step takes them (through ``loss_fn``,
    default the engine's model's)."""
    import torch
    names = list(engine.state.params)
    loss = (loss_fn or engine.module.loss_fn)({k: p.to(engine.compute_dtype)
                                               for k, p in engine.state.params.items()}, batch)
    grads = torch.autograd.grad(loss, [engine.state.params[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def train_run(device, smi: str, label: str, cfg, per_step: dict, check, beside=None,
              micro: int = TRAIN_MICRO, seq: int = TRAIN_SEQ, steps: int = TRAIN_STEPS,
              warmup: int = TRAIN_WARMUP, config=None, ids=None, setup=None,
              model=None, median: bool = False):
    """``initialize`` on the GPT-2 ``cfg`` (or ``model``) at ``bench.py``'s
    training configuration (``train_config(micro)``, or ``config``; seeded
    random weights), ``setup(engine)`` if given, then ``warmup`` warm-up and
    ``steps`` timed ``train_batch`` steps on one seeded ``(micro, seq)`` batch
    (or ``ids``); with ``median`` each timed step ends in a synchronise and
    the median step time is returned too. The launch counts over the timed steps
    must be ``per_step`` (kernel -> launches a step) times ``steps`` and 0
    for every other kernel; every loss, warm-up and timed, finite and the
    last below the first. Prints the step line, with ``beside(tokens_per_s)``
    appended, then adds what ``check(engine, ids)`` returns to the metrics
    (``plain_and_traced`` holds the kernels to their plain versions and
    traces one more step). Returns the losses, step ms, tokens/s, the peak
    memory over the timed steps, the memory held between steps and the
    launch counts."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2_model
    from deepspeed_tpu_torch.ops import op_builder

    t0 = time.perf_counter()
    engine, _, _, _ = dst.initialize(model=model or gpt2_model(cfg),
                                     config=config or train_config(micro), device=device)
    torch.cuda.synchronize()
    print(f"[{label}] initialize {time.perf_counter() - t0:.2f} s", flush=True)
    if ids is None:
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (micro, seq))
    batch = {"input_ids": ids}
    if setup is not None:
        setup(engine)

    losses = [engine.train_batch(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    op_builder.reset_launch_counts()
    t0 = time.perf_counter()
    marks = [t0]
    for _ in range(steps):
        losses.append(engine.train_batch(batch))
        if median:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = op_builder.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expect(**{name: n * steps for name, n in per_step.items()})
    print(f"[{label}] launches {nonzero(launches)} (expected {nonzero(want)})", flush=True)
    if launches != want:
        raise AssertionError(f"[{label}] launch counts {launches} != {want}")
    losses = [float(x) for x in losses]
    print(f"[{label}] losses {losses[0]:.6f} -> {losses[-1]:.6f} over {warmup} + {steps} "
          "steps", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{label}] losses not finite and falling: {losses}")
    step_ms = dt / steps * 1e3
    tokens_per_s = micro * seq * steps / dt
    print(f"[{label}] {smi}: step {step_ms:.2f} ms, {tokens_per_s:.1f} tokens/s"
          f"{beside(tokens_per_s) if beside else ''}, peak memory {peak / 2**30:.3f} GiB "
          f"(held between steps {held / 2**30:.3f} GiB; micro-batch {micro}, seq {seq})",
          flush=True)
    out = {"losses": losses, "step_ms": step_ms, "tokens_per_s": tokens_per_s,
           "peak_memory_bytes": peak, "held_bytes": held,
           "first_loss": losses[0], "last_loss": losses[-1], "launches": launches}
    if median:
        out["step_ms_median"] = 1e3 * statistics.median(b - a for a, b in zip(marks, marks[1:]))
    out.update(check(engine, ids))
    return out


def plain_and_traced(device, plain, label: str):
    """``train_run``'s check for ``[train]``, ``[sparse]`` and ``[hd]``: the
    loss and every gradient of one micro-batch of 4 through the kernels
    within ``GRAD_RTOL`` of the same under ``plain()`` (``kernels_vs_plain``),
    then one more ``train_batch`` traced."""
    import torch

    def check(engine, ids):
        loss_err, grad_err = kernels_vs_plain(engine, ids, device, plain, label)

        def traced_step():
            engine.train_batch({"input_ids": ids})
            torch.cuda.synchronize()

        return {"trace": profile_call(f"{label} train_batch", traced_step, top=30),
                "grad_rel_err_max": grad_err, "loss_err": loss_err}
    return check


def train_config(micro: int, lr: float = 2e-4, zero=None, optimizer: str = "AdamW",
                 precision=None) -> dict:
    """``bench.py``'s training configuration at micro-batch ``micro``: bf16
    AdamW lr 2e-4, weight decay 0.01, ZeRO stage 1, clipping 1.0; ``lr``,
    ``zero`` (the ``zero_optimization`` block), ``optimizer`` and
    ``precision`` (in place of the bf16 block) change it."""
    return {"train_batch_size": micro, "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": optimizer, "params": {"lr": lr, "weight_decay": 0.01}},
            **(precision or {"bf16": {"enabled": True}}),
            "zero_optimization": zero or {"stage": 1},
            "gradient_clipping": 1.0, "steps_per_print": 10**9}


def kernels_vs_plain(engine, ids, device, plain, label: str, exclude=None):
    """The whole model on one micro-batch of 4 (the first rows of ``ids``),
    same weights: the loss and every gradient through the kernels against
    the same under ``plain()``. bf16 activations through 12 layers, with
    rounding at other points in the kernels than in the plain versions, move
    each gradient by about 1% of its norm; GRAD_RTOL = 5e-2 leaves room for
    that and fails on any real disagreement (a dropped or misplaced attention
    gradient moves a tensor's gradient by its whole norm). Tensors for which
    ``exclude(name)`` holds (a gradient that is 0 in exact arithmetic, all
    rounding) are printed beside and not gated. Returns (loss |diff|, worst
    relative gradient error)."""
    import numpy as np
    import torch
    small = {"input_ids": torch.from_numpy(ids[:4]).to(device)}
    loss_k, grads_k = grads_of(engine, small)
    with plain():
        loss_p, grads_p = grads_of(engine, small)
    loss_err = abs(float(loss_k) - float(loss_p))
    rel = {k: float((grads_k[k].float() - g.float()).norm() / g.float().norm())
           for k, g in grads_p.items()}
    if exclude is not None:
        left_out = {k: rel.pop(k) for k in [k for k in rel if exclude(k)]}
        if left_out:
            print(f"[{label}] not gated (exact gradient 0): {len(left_out)} tensors, max "
                  f"relative error {max(left_out.values()):.3e}", flush=True)
    worst = max(rel, key=rel.get)
    print(f"[{label}] micro-batch 4, kernels vs plain versions: loss {float(loss_k):.6f} vs "
          f"{float(loss_p):.6f} (|diff| {loss_err:.3e}); gradients, relative error "
          f"|g_k - g_p| / |g_p| per tensor: max {rel[worst]:.3e} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.3e} over {len(rel)} tensors "
          f"(tol {GRAD_RTOL})", flush=True)
    if not loss_err <= 1e-2 or not rel[worst] <= GRAD_RTOL:
        raise AssertionError(f"[{label}] kernels vs plain: loss diff {loss_err}, gradient "
                             f"{worst} {rel[worst]}")
    return loss_err, rel[worst]


def flash_traced_ms(trace) -> dict:
    """K1's, K3's and K4's device time in a ``profile_call`` trace (their
    16-bit kernels are wgmma_fwd, wgmma_dq and wgmma_dkv, the f32 ones
    flash_fwd_kernel, flash_bwd_dq_kernel and flash_bwd_dkv_kernel)."""
    by_kernel = trace["by_kernel"]
    return {name: sum(us for key, us in by_kernel.items() if any(k in key for k in keys)) / 1e3
            for name, keys in (("flash_fwd", ("wgmma_fwd", "flash_fwd_kernel")),
                               ("flash_bwd_dq", ("wgmma_dq", "flash_bwd_dq_kernel")),
                               ("flash_bwd_dkv", ("wgmma_dkv", "flash_bwd_dkv_kernel")))}


def gpt2_train_cfg(**kw):
    """GPT-2 125M as ``bench.py`` trains it: vocab 50304, seq 1024, width 768,
    12 layers, 12 heads, no dropout (``kw`` overrides)."""
    from deepspeed_tpu_torch.models import GPT2Config
    return GPT2Config(vocab_size=50304, n_positions=TRAIN_SEQ, n_embd=768, n_layer=12,
                      n_head=12, **{"dropout": 0.0, **kw})


def train_path(device, smi: str):
    """``[train]``: dense attention, every layer in the flash kernels; MFU
    counts 6N + the dense attention FLOPs (``flops_per_token``)."""
    cfg = gpt2_train_cfg()
    n = cfg.n_layer

    def mfu(tokens_per_s):
        return tokens_per_s * cfg.flops_per_token() / PEAK_BF16_FLOPS

    out = train_run(device, smi, "train", cfg,
                    {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n},
                    plain_and_traced(device, plain_attention, "train"),
                    lambda tps: f", MFU {mfu(tps):.4f} (6N + attention FLOPs against 989 "
                                "TFLOP/s)")
    out["mfu"] = mfu(out["tokens_per_s"])
    if out["trace"] is not None:
        ms = flash_traced_ms(out["trace"])
        out["k1_traced_ms"] = ms["flash_fwd"]
        out["k1_k4_traced_ms"] = ms["flash_fwd"] + ms["flash_bwd_dkv"]
        out["k3_traced_ms"] = ms["flash_bwd_dq"]
        print(f"[train] traced step: K1 {ms['flash_fwd']:.3f} ms + K4 {ms['flash_bwd_dkv']:.3f} "
              f"ms = {out['k1_k4_traced_ms']:.3f} ms; K3 {ms['flash_bwd_dq']:.3f} ms of device "
              f"time", flush=True)
    return out


def sparse_path(device, smi: str, dense_step_ms: float):
    """``[sparse]``: the same training with block-sparse attention
    (``kernel_checks.GPT2_SPARSE``), every layer in the three block-sparse
    kernels and none in the flash kernels. No MFU: ``flops_per_token`` counts
    dense attention."""
    from deepspeed_tpu_torch.ops import sparse_attention
    from deepspeed_tpu_torch.ops.attention import make_sparse_attention_impl
    from deepspeed_tpu_torch.ops.kernel_checks import GPT2_SPARSE

    name, kw = GPT2_SPARSE
    cfg = gpt2_train_cfg(attention_impl=make_sparse_attention_impl(
        getattr(sparse_attention, name)(**kw)))
    n = cfg.n_layer
    out = train_run(device, smi, "sparse", cfg,
                    {"block_sparse_fwd": n, "block_sparse_bwd_dq": n, "block_sparse_bwd_dkv": n},
                    plain_and_traced(device, plain_sparse, "sparse"),
                    lambda _: f" (dense [train] step {dense_step_ms:.2f} ms)")
    out["dense_step_ms"] = dense_step_ms
    if out["trace"] is not None:
        # the traced step's device time in K8, K9 and K10 (their 16-bit
        # kernels are wgmma_bs_fwd, wgmma_bs_dq and wgmma_bs_dkv, their f32
        # ones block_sparse_fwd_kernel, block_sparse_bwd_dq_kernel and
        # block_sparse_bwd_dkv_kernel)
        by_kernel = out["trace"]["by_kernel"]
        ms = {name: sum(us for key, us in by_kernel.items() if any(k in key for k in keys)) / 1e3
              for name, keys in (("k8", ("wgmma_bs_fwd", "block_sparse_fwd_kernel")),
                                 ("k9", ("wgmma_bs_dq", "block_sparse_bwd_dq_kernel")),
                                 ("k10", ("wgmma_bs_dkv", "block_sparse_bwd_dkv_kernel")))}
        out.update({f"{name}_traced_ms": v for name, v in ms.items()})
        print(f"[sparse] traced step: K8 {ms['k8']:.3f} ms, K9 {ms['k9']:.3f} ms, K10 "
              f"{ms['k10']:.3f} ms of device time", flush=True)
    return out


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def remat_path(device, smi: str, train: dict) -> dict:
    """``[remat]``: activation checkpointing and the chunked-vocab loss on
    ``[train]``'s GPT-2 125M and configuration, each engine through
    ``train_run`` (launch counts exact: K1 24 a step under remat, since the
    backward runs every block's forward again, 12 without; K3 and K4 12;
    every loss finite and falling). (a) At ``[train]``'s shape, five engines
    from one seed, 3 + 10 steps each: no remat; ``remat=True`` under
    ``"full"``; ``"dots"``; ``"dots"`` with ``vocab_chunk`` 8192;
    ``"offload_dots"`` (dots' products in pinned host memory). Under full,
    dots and offload_dots the 13 losses and every final master equal the
    no-remat engine's bit for bit, or, where they do not, within the spread
    of a second no-remat run (the first differing tensor is printed). The
    chunked loss: its first loss within ``CHUNK_LOSS_TOL`` of dots'; on its
    final weights, the loss and every gradient of a micro-batch of 4 against
    the full-logits loss's (``chunk_vs_full``) and the kernels against their
    plain versions (``kernels_vs_plain``). Peak memory full < dots < no
    remat, offload_dots < dots, and dots + chunk at least one f32 ``(b, t,
    V)`` buffer below dots; one full and one dots step traced (K1 beside
    ``[train]``'s).
    (b) ``bench.py``'s long-sequence setting: seq 32768, micro-batch 1,
    ``remat_policy="full"``, ``vocab_chunk`` 8192, 2 + 3 steps: peak at most
    ``LONG_PEAK_GIB``; the peak without the two knobs is predicted from (a)
    (not run)."""
    import dataclasses

    import torch

    def collect():
        gc.collect()
        torch.cuda.empty_cache()

    def run(label, cfg, check=None, **kw):
        n = cfg.n_layer
        per_step = {"flash_fwd": (2 if cfg.remat else 1) * n, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n}
        kw = {"micro": TRAIN_MICRO, "seq": TRAIN_SEQ, "warmup": REMAT_WARMUP,
              "steps": REMAT_STEPS, **kw}
        out = train_run(device, smi, f"remat {label}", cfg, per_step, check or masters,
                        lambda tps: f", MFU {tps * cfg.flops_per_token() / PEAK_BF16_FLOPS:.4f}",
                        **kw)
        out["mfu"] = out["tokens_per_s"] * cfg.flops_per_token() / PEAK_BF16_FLOPS
        collect()
        return out

    def masters(engine, ids):
        return {"masters": {k: p.detach().to("cpu", copy=True)
                            for k, p in engine.state.params.items()}}

    def traced(label):
        def check(engine, ids):
            out = masters(engine, ids)

            def step():
                engine.train_batch({"input_ids": ids})
                torch.cuda.synchronize()
            out["trace"] = profile_call(f"remat {label} train_batch", step, top=30)
            return out
        return check

    base = gpt2_train_cfg()
    dots_cfg = dataclasses.replace(base, remat=True, remat_policy="dots")
    chunk_cfg = dataclasses.replace(dots_cfg, vocab_chunk=REMAT_CHUNK)
    ref = run("no remat", base)
    spread = {}

    def hold(label: str, got: dict) -> None:
        first, worst = first_difference(ref["masters"], got["masters"])
        loss_diff = max(abs(a - b) for a, b in zip(ref["losses"], got["losses"]))
        if first is None and loss_diff == 0.0:
            print(f"[remat] {label}: {len(got['losses'])} losses and {len(got['masters'])} "
                  "masters equal the no-remat run's bit for bit", flush=True)
            return
        if not spread:
            again = run("no remat, again", base)
            d_first, d_worst = first_difference(ref["masters"], again["masters"])
            spread.update(loss=max(abs(a - b) for a, b in zip(ref["losses"], again["losses"])),
                          master=d_worst, first=d_first)
            print(f"[remat] two identical no-remat runs: losses max |diff| {spread['loss']:.3e}, "
                  f"masters max |diff| {spread['master']:.3e}, first differing tensor "
                  f"{spread['first']}", flush=True)
        print(f"[remat] {label} vs no remat: losses max |diff| {loss_diff:.3e} (limit "
              f"{spread['loss']:.3e}), masters max |diff| {worst:.3e} (limit "
              f"{spread['master']:.3e}), first differing tensor {first}", flush=True)
        if not (loss_diff <= spread["loss"] and worst <= spread["master"]):
            raise AssertionError(f"[remat] {label}: outside the spread of two identical "
                                 f"no-remat runs; first differing tensor {first}")

    # full and dots each trace one step: device time and busy share side by side
    full = run("full", dataclasses.replace(base, remat=True), traced("full"))
    hold("full", full)
    dots = run("dots", dots_cfg, traced("dots"))
    hold("dots", dots)

    def chunk_checks(engine, ids):
        out = chunk_vs_full(engine, ids, device, dataclasses.replace(chunk_cfg, vocab_chunk=0))
        out["loss_err"], out["grad_rel_err_max"] = kernels_vs_plain(
            engine, ids, device, plain_attention, "remat")
        return out

    chunk = run(f"dots + vocab_chunk {REMAT_CHUNK}", chunk_cfg, chunk_checks)
    first_err = abs(chunk["losses"][0] - dots["losses"][0])
    print(f"[remat] chunked-vocab loss: first loss {chunk['losses'][0]:.7f} vs full logits "
          f"{dots['losses'][0]:.7f} (|diff| {first_err:.3e}, tol {CHUNK_LOSS_TOL}); 13 losses "
          f"max |diff| {max(abs(a - b) for a, b in zip(chunk['losses'], dots['losses'])):.3e}",
          flush=True)
    if not first_err <= CHUNK_LOSS_TOL:
        raise AssertionError(f"[remat] chunked loss: first |diff| {first_err}")

    offload = run("offload_dots", dataclasses.replace(base, remat=True,
                                                      remat_policy="offload_dots"))
    hold("offload_dots", offload)

    runs = {"none": ref, "full": full, "dots": dots, "dots_chunk": chunk,
            "offload_dots": offload}
    for name, res in runs.items():
        print(f"[remat] {smi}: {name:>12}: step {res['step_ms']:8.2f} ms "
              f"({res['step_ms'] / ref['step_ms']:.3f} x no remat), "
              f"{res['tokens_per_s']:9.1f} tokens/s, MFU {res['mfu']:.4f}, peak "
              f"{res['peak_memory_bytes'] / 2**30:7.3f} GiB", flush=True)
    peak = {name: res["peak_memory_bytes"] for name, res in runs.items()}
    logits_f32 = TRAIN_MICRO * TRAIN_SEQ * base.vocab_size * 4
    print(f"[remat] peaks: full < dots < no remat: {peak['full'] < peak['dots'] < peak['none']}; "
          f"offload_dots < dots: {peak['offload_dots'] < peak['dots']}; dots - dots + chunk "
          f"{(peak['dots'] - peak['dots_chunk']) / 2**30:.3f} GiB (at least one f32 (b, t, V) "
          f"buffer, {logits_f32 / 2**30:.3f} GiB)", flush=True)
    if not (peak["full"] < peak["dots"] < peak["none"] and peak["offload_dots"] < peak["dots"]
            and peak["dots"] - peak["dots_chunk"] >= logits_f32):
        raise AssertionError(f"[remat] peak memory out of order: {peak}")
    out = {name: {k: v for k, v in res.items() if k not in ("masters", "trace", "losses")}
           for name, res in runs.items()}
    for name, res in runs.items():
        out[name]["step_ratio"] = res["step_ms"] / ref["step_ms"]
    for name in ("full", "dots"):
        trace = runs[name]["trace"]
        if trace is None:
            continue
        k1 = flash_traced_ms(trace)["flash_fwd"]
        out[name].update(k1_traced_ms=k1, traced_device_ms=trace["device_us"] / 1e3,
                         traced_wall_ms=trace["wall_us"] / 1e3)
        print(f"[remat] traced {name} step: device {trace['device_us'] / 1e3:.2f} of "
              f"{trace['wall_us'] / 1e3:.2f} ms; K1 {k1:.3f} ms of device time ([train]'s "
              f"traced K1 {train.get('k1_traced_ms', float('nan')):.3f} ms, ratio "
              f"{k1 / train.get('k1_traced_ms', float('nan')):.3f})", flush=True)
    del runs, ref, full, dots, chunk, offload

    # (b) the long sequence
    long_cfg = dataclasses.replace(base, n_positions=LONG_SEQ, remat=True, remat_policy="full",
                                   vocab_chunk=REMAT_CHUNK)
    long = run(f"seq {LONG_SEQ}, full + vocab_chunk {REMAT_CHUNK}", long_cfg,
               lambda engine, ids: {}, micro=1, seq=LONG_SEQ, warmup=LONG_WARMUP,
               steps=LONG_STEPS)
    # without remat and vocab_chunk, memory above what is held between steps
    # grows with the tokens of a step (flash attention is linear in t)
    per_token = (out["none"]["peak_memory_bytes"] - out["none"]["held_bytes"]) / (
        TRAIN_MICRO * TRAIN_SEQ)
    predicted = long["held_bytes"] + per_token * LONG_SEQ
    print(f"[remat] seq {LONG_SEQ} {smi}: peak {long['peak_memory_bytes'] / 2**30:.3f} GiB "
          f"(limit {LONG_PEAK_GIB}); predicted without remat and vocab_chunk "
          f"{predicted / 2**30:.2f} GiB (not run)", flush=True)
    if not long["peak_memory_bytes"] <= LONG_PEAK_GIB * 2**30:
        raise AssertionError(f"[remat] seq {LONG_SEQ}: peak {long['peak_memory_bytes']}")
    out["long"] = {k: v for k, v in long.items() if k != "losses"}
    out["long"]["predicted_peak_without_knobs_bytes"] = predicted
    return out


def key_bias_cut(name: str, x, n_embd: int):
    """``x`` without the key bias's third of ``c_attn.bias``: its exact
    gradient is 0 (a softmax is blind to a constant added to a row), each run
    leaves rounding noise there, and Adam and Adagrad turn noise of either
    sign into full-size steps (as ``tests/test_torch_training.py`` leaves it
    out)."""
    if name.endswith("c_attn.bias"):
        x = x.clone()
        x[n_embd:2 * n_embd] = 0.0
    return x


def offload_masters(engine) -> dict:
    """An offload engine's f32 masters by name, as host copies."""
    return {n: m.clone() for n, m in engine._offload_tier.named_masters().items()}


def update_parity(start: dict, want: dict, got: dict, n_embd: int, device) -> dict:
    """Per tensor ``|dp_got - dp_want| / |dp_want|`` of the updates ``dp = p -
    start`` (key bias cut, ``key_bias_cut``), computed on ``device`` a tensor
    at a time, by name."""
    rel = {}
    for name, s in start.items():
        s = s.to(device)
        dw = key_bias_cut(name, want[name].to(device) - s, n_embd)
        dg = key_bias_cut(name, got[name].to(device) - s, n_embd)
        rel[name] = float((dg - dw).norm() / dw.norm())
    return rel


def hold_to_device(label: str, start: dict, dev: dict, got: dict, n_embd: int, device,
                   max_limit: float, fault=None) -> dict:
    """``[offload]``'s update parity (``update_parity``) of the masters ``got``
    against the in-device engine's (``dev``): the median over the tensors at
    most ``OFFLOAD_PARITY`` and the worst tensor at most ``max_limit``; a
    planted ``fault`` must exceed both limits. Returns the readings."""
    import numpy as np
    readings = {"": update_parity(start, dev, got, n_embd, device)}
    if fault is not None:
        readings["fault_"] = update_parity(start, dev, fault, n_embd, device)
    out = {}
    for key, rel in readings.items():
        worst = max(rel, key=rel.get)
        out.update({f"{key}parity_max": rel[worst], f"{key}parity_worst": worst,
                    f"{key}parity_median": float(np.median(list(rel.values())))})
    print(f"[offload] {label}: per tensor |dp - dp_device| / |dp_device| against the in-device "
          f"engine over {len(readings['']):,} tensors: median {out['parity_median']:.3e} (limit "
          f"{OFFLOAD_PARITY}), max {out['parity_max']:.3e} ({out['parity_worst']}; limit "
          f"{max_limit})", flush=True)
    ok = out["parity_median"] <= OFFLOAD_PARITY and out["parity_max"] <= max_limit
    if fault is not None:
        print(f"[offload] {label}: planted fault (the host moments never written): median "
              f"{out['fault_parity_median']:.3e}, max {out['fault_parity_max']:.3e} "
              f"({out['fault_parity_worst']}); each must exceed its limit", flush=True)
        ok = (ok and out["fault_parity_median"] > OFFLOAD_PARITY
              and out["fault_parity_max"] > max_limit)
    if not ok:
        raise AssertionError(f"[offload] {label}: update parity {out}")
    return out


def host_step_check(engine, out: dict, device):
    """``train_run``'s setup for ``[offload]``: over the engine's first step, each
    leaf's C++ Adam step (``cpu_adam.adam_step``) is held to its plain version
    on the same inputs, run on ``device`` (a tensor op a rounding, as on the
    host); ``out`` gets the elements outside ``HOST_ATOL + HOST_RTOL *
    |plain|``, the largest error over that limit and the elements compared.
    The C++ op is restored after the step's last leaf."""
    from deepspeed_tpu_torch.ops.adam import cpu_adam
    real, n_leaves = cpu_adam.adam_step, len(engine._offload_tier.masters)
    out.update(leaves=0, elements=0, outside=0, max_err_over_limit=0.0, max_abs_err=0.0,
               seconds=0.0)

    def checked(p, m, v, g, *args):
        t0 = time.perf_counter()
        plain = [t.to(device, copy=True) for t in (p, m, v)]
        g0 = g.to(device, copy=True)
        t1 = time.perf_counter()
        real(p, m, v, g, *args)
        t2 = time.perf_counter()
        cpu_adam.adam_step_plain(*plain, g0, *args)
        for got, want in zip((p, m, v), plain):
            err = (got.to(device) - want).abs()
            limit = HOST_ATOL + HOST_RTOL * want.abs()
            out["outside"] += int((err > limit).sum())
            out["max_err_over_limit"] = max(out["max_err_over_limit"],
                                            float((err / limit).max()))
            out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        out["seconds"] += time.perf_counter() - t0 - (t2 - t1)
        out["leaves"] += 1
        out["elements"] += p.numel()
        if out["leaves"] == n_leaves:
            cpu_adam.adam_step = real

    cpu_adam.adam_step = checked


def offload_lane_a(device, smi: str, seed: int = 0) -> dict:
    """``[offload]`` lane A, as ``bench.py:237-272`` trains: GPT-2 1.3B (vocab
    50304, seq 1024, width 2048, 24 layers, 16 heads), remat ``dots``,
    micro-batch 4, AdamW lr 1e-4 weight decay 0.01, bf16, clip 1.0, ZeRO
    stage 3 with ``offload_optimizer: cpu``, on ``bench.py``'s seeded batch
    (``seed`` 0; another ``seed`` draws the batch from it and the weights
    from 42 + ``seed``), 2 + 3 steps through ``train_run`` (K1 48, K3 24, K4
    24 a step, exact), beside the same configuration without offload. The
    C++ step is held to its plain version over the first step
    (``host_step_check``). After the 5 steps the updates are held to the
    in-device engine's, and a planted fault (the host moments never
    written) must fail the same gate (``hold_to_device``, worst tensor at
    ``OFFLOAD_PARITY_MAX``). The offload engine's peak device memory must
    lie at least 8 bytes a parameter below the in-device engine's. One more
    offload step is traced: device time, its copies each way and the busy
    share, beside the tier's host times of the last untraced step."""
    import dataclasses

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models import gpt2_model
    from deepspeed_tpu_torch.models.gpt2 import gpt2_config, init_params
    from deepspeed_tpu_torch.ops.adam import cpu_adam

    cfg = gpt2_config(OFFLOAD_PRESET, vocab_size=50304, n_positions=TRAIN_SEQ, dropout=0.0,
                      remat=True, remat_policy="dots")
    n = cfg.n_layer
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    # bench.py's batch: rng.integers(0, 50304, size=(micro, seq), dtype=np.int32)
    ids = np.random.default_rng(seed).integers(0, 50304, size=(OFFLOAD_MICRO, TRAIN_SEQ),
                                               dtype=np.int32)
    model = gpt2_model(cfg)
    model = dataclasses.replace(model, init_fn=lambda _, dev, init=model.init_fn: init(
        42 + seed, dev))
    offload = {"stage": 3, "offload_optimizer": {"device": "cpu"}}

    def mfu(tps):
        return tps * cfg.flops_per_token() / PEAK_BF16_FLOPS

    def run(label, zero, check, setup=None, median=False):
        res = train_run(device, smi, f"offload {label}", cfg, per_step, check,
                        lambda tps: f", MFU {mfu(tps):.4f}", micro=OFFLOAD_MICRO,
                        warmup=OFFLOAD_WARMUP, steps=OFFLOAD_STEPS, ids=ids, setup=setup,
                        config=train_config(OFFLOAD_MICRO, lr=OFFLOAD_LR, zero=zero),
                        model=model, median=median)
        res["mfu"] = mfu(res["tokens_per_s"])
        gc.collect()
        torch.cuda.empty_cache()
        return res

    def device_masters(engine, _):
        return {"masters": {k: p.detach().to("cpu", copy=True)
                            for k, p in engine.state.params.items()}}

    def offload_check(engine, _):
        tier = engine._offload_tier
        out = {"masters": offload_masters(engine), "host_bytes": tier.host_bytes(),
               "host_step_s": dict(tier.last_step_s), "n_params": sum(
                   m.numel() for m in tier.masters),
               "device_param_dtypes": sorted({str(p.dtype) for p in
                                              engine.state.params.values()}),
               "pinned": all(m.is_pinned() for m in tier.masters + tier.opt.m + tier.opt.v)}

        def step():
            engine.train_batch({"input_ids": ids})
            torch.cuda.synchronize()
        out["trace"] = profile_call("offload train_batch", step, top=20)
        out["traced_host_step_s"] = dict(tier.last_step_s)
        return out

    dev = run("in-device (stage 3, no offload)", {"stage": 3}, device_masters, median=True)
    check = {}
    off = run("stage 3 + offload_optimizer cpu", offload, offload_check,
              setup=lambda engine: host_step_check(engine, check, device), median=True)
    print(f"[offload] {smi}: the C++ step over the first step's gradients against its plain "
          f"version: {check['leaves']} leaves, {check['elements']:,} elements, "
          f"{check['outside']} outside {HOST_ATOL} + {HOST_RTOL} |plain| (max abs "
          f"{check['max_abs_err']:.3e}; the largest error {check['max_err_over_limit']:.3f} of "
          f"its limit; the plain version on the card, {check['seconds']:.1f} s of copies and "
          "checks)", flush=True)
    if check["leaves"] != len(off["masters"]) or check["outside"]:
        raise AssertionError(f"[offload] the C++ step vs its plain version: {check}")
    hs = off["host_step_s"]
    print(f"[offload] {smi}: the tier's host times in the last timed step: waiting on the "
          f"gradients {1e3 * hs['d2h_wait_s']:.1f} ms, host Adam + casts + pushes "
          f"{1e3 * hs['host_update_s']:.1f} ms; step {off['step_ms']:.1f} ms", flush=True)

    real = cpu_adam.adam_step

    def unwritten_moments(engine):
        # the planted fault: the C++ step writes its moments into copies
        cpu_adam.adam_step = lambda p, m, v, *a: real(p, m.clone(), v.clone(), *a)
    try:
        fault = run("planted fault: host moments unwritten", offload,
                    lambda engine, _: {"masters": offload_masters(engine)},
                    setup=unwritten_moments)
    finally:
        cpu_adam.adam_step = real

    start = {k: v.to("cpu") for k, v in init_params(cfg, 42 + seed, device).items()}
    torch.cuda.empty_cache()
    n_params = off["n_params"]
    parity = hold_to_device("offload", start, dev["masters"], off["masters"], cfg.n_embd,
                            device, OFFLOAD_PARITY_MAX, fault=fault["masters"])
    if not off["pinned"] or off["device_param_dtypes"] != ["torch.bfloat16"]:
        raise AssertionError(f"[offload] masters and moments pinned: {off['pinned']}; device "
                             f"parameters {off['device_param_dtypes']}")
    saved = dev["peak_memory_bytes"] - off["peak_memory_bytes"]
    print(f"[offload] {smi}: peak device memory in-device {dev['peak_memory_bytes'] / 2**30:.3f} "
          f"GiB, offload {off['peak_memory_bytes'] / 2**30:.3f} GiB: {saved / 2**30:.3f} GiB "
          f"less, {saved / n_params:.2f} B a parameter (gate >= 8 B x {n_params:,} = "
          f"{8 * n_params / 2**30:.3f} GiB); held between steps {dev['held_bytes'] / 2**30:.3f} "
          f"vs {off['held_bytes'] / 2**30:.3f} GiB; the tier's host memory "
          f"{off['host_bytes'] / 2**30:.3f} GiB (pinned)", flush=True)
    if not saved >= 8 * n_params:
        raise AssertionError(f"[offload] peak saved {saved} < 8 B x {n_params}")
    steps = {"in_device": dev, "offload": off}
    for name, res in steps.items():
        print(f"[offload] {smi}: {name:>9}: step {res['step_ms']:9.2f} ms (median of 3 "
              f"{res['step_ms_median']:9.2f}), {res['tokens_per_s']:9.1f} tokens/s, MFU "
              f"{res['mfu']:.4f}, peak {res['peak_memory_bytes'] / 2**30:7.3f} GiB", flush=True)
    out = {name: {k: v for k, v in res.items() if k not in ("masters", "trace", "losses")}
           for name, res in steps.items()}
    out["offload"].update(parity, host_step_check=check,
                          peak_saved_bytes=saved, peak_saved_per_param=saved / n_params)
    trace = off["trace"]
    if trace is not None:
        by = trace["by_kernel"]
        d2h = sum(us for k, us in by.items() if "DtoH" in k) / 1e3
        h2d = sum(us for k, us in by.items() if "HtoD" in k) / 1e3
        device_ms = trace["device_us"] / 1e3
        ths = off["traced_host_step_s"]
        out["offload"].update(traced_wall_ms=trace["wall_us"] / 1e3, traced_device_ms=device_ms,
                              traced_d2h_ms=d2h, traced_h2d_ms=h2d,
                              traced_compute_ms=device_ms - d2h - h2d,
                              traced_busy_share=trace["device_us"] / trace["wall_us"],
                              traced_host_update_s=ths["host_update_s"],
                              traced_d2h_wait_s=ths["d2h_wait_s"])
        print(f"[offload] {smi}: traced offload step: wall {trace['wall_us'] / 1e3:.2f} ms, "
              f"device {device_ms:.2f} ms (compute {device_ms - d2h - h2d:.2f}, D2H copies "
              f"{d2h:.2f}, H2D copies {h2d:.2f}), busy share "
              f"{trace['device_us'] / trace['wall_us']:.3f}; the tier's host times: waiting on "
              f"the gradients {1e3 * ths['d2h_wait_s']:.1f} ms, host Adam + casts + pushes "
              f"{1e3 * ths['host_update_s']:.1f} ms (untraced step: "
              f"{1e3 * hs['d2h_wait_s']:.1f} and {1e3 * hs['host_update_s']:.1f} ms)",
              flush=True)
    return out


def offload_lane_b(device, smi: str) -> dict:
    """``[offload]`` lane B, ``[train]``'s GPT-2 125M (micro-batch 8, cut from
    24 to save time) with ZeRO stage 3 and ``offload_optimizer``, a distinct
    seeded batch a step, in a temporary directory it removes: (a) ``device:
    nvme`` equal to ``cpu`` bit for bit over 3 steps (losses, masters,
    moments), with the filesystem's type and whether O_DIRECT held; (b) a
    save after step 2 resumed in a fresh engine: step 3 equal to the
    uninterrupted run bit for bit, for cpu and for nvme; (c) offload Adagrad
    held to device Adagrad over 3 steps (``hold_to_device``: every tensor's
    update within ``OFFLOAD_PARITY`` of the in-device engine's); (d) fp16
    with ``initial_scale_power`` 40: the first step skipped, the masters
    unchanged bit for bit. Every step launches K1, K3 and K4 12 times."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2_model
    from deepspeed_tpu_torch.ops import op_builder

    cfg = gpt2_train_cfg()
    root = tempfile.mkdtemp(prefix="ds-offload-")
    fs = subprocess.run(["stat", "-f", "-c", "%T", root], capture_output=True, text=True,
                        timeout=60).stdout.strip()
    out, launches = {"filesystem": fs}, {}

    def engine(zero, optimizer="AdamW", precision=None):
        return dst.initialize(model=gpt2_model(cfg), device=device, config=train_config(
            OFFLOAD_B_MICRO, zero=zero, optimizer=optimizer, precision=precision))[0]

    def batch(step):
        rng = np.random.default_rng(2000 + step)
        return {"input_ids": rng.integers(0, 50304, (OFFLOAD_B_MICRO, TRAIN_SEQ))}

    def steps(e, first, last, label):
        op_builder.reset_launch_counts()
        losses = [e.train_batch(batch(s)) for s in range(first, last + 1)]
        torch.cuda.synchronize()
        got, k = op_builder.launch_counts(), 12 * (last - first + 1)
        if got != expect(flash_fwd=k, flash_bwd_dq=k, flash_bwd_dkv=k):
            raise AssertionError(f"[offload] {label}: launch counts {nonzero(got)}")
        for name, v in got.items():
            launches[name] = launches.get(name, 0) + v
        return [float(x) for x in losses]

    def tier_state(e):
        sd = e._offload_tier.state_dict()
        return {f"{part}.{k}": v.clone() for part in ("masters", "m", "v") for k, v in
                sd[part].items()}

    def nvme(path):
        return {"stage": 3, "offload_optimizer": {"device": "nvme", "nvme_path": path}}

    cpu_zero = {"stage": 3, "offload_optimizer": {"device": "cpu"}}
    try:
        runs = {}
        for kind, zero in (("cpu", cpu_zero), ("nvme", nvme(os.path.join(root, "swap-a")))):
            e = engine(zero)
            losses = steps(e, 1, 2, f"{kind} steps 1-2")
            t0 = time.perf_counter()
            e.save_checkpoint(os.path.join(root, kind))
            save_s = time.perf_counter() - t0
            losses += steps(e, 3, 3, f"{kind} step 3")
            runs[kind] = {"losses": losses, "state": tier_state(e), "save_s": save_s}
            if kind == "nvme":
                handle = e._offload_tier.nvme.handle
                out["o_direct_held"] = handle.o_direct and not handle.direct_refused
            del e
            gc.collect()
        first, worst = first_difference(runs["cpu"]["state"], runs["nvme"]["state"])
        same = runs["cpu"]["losses"] == runs["nvme"]["losses"] and first is None
        print(f"[offload] nvme vs cpu over 3 steps ({fs} under {root}, O_DIRECT held: "
              f"{out['o_direct_held']}): losses {runs['nvme']['losses']} vs "
              f"{runs['cpu']['losses']}, {len(runs['cpu']['state'])} masters and moments "
              f"equal bit for bit: {same} (first differing {first}, max |diff| {worst:.3e}); "
              f"save {runs['cpu']['save_s']:.2f} s cpu, {runs['nvme']['save_s']:.2f} s nvme",
              flush=True)
        if not same:
            raise AssertionError(f"[offload] nvme differs from cpu: {first}")
        for kind, zero in (("cpu", cpu_zero), ("nvme", nvme(os.path.join(root, "swap-b")))):
            e = engine(zero)
            e.load_checkpoint(os.path.join(root, kind))
            loss = steps(e, 3, 3, f"{kind} resumed step 3")
            first, worst = first_difference(runs[kind]["state"], tier_state(e))
            print(f"[offload] {kind}: resumed from global_step2, step 3 loss {loss[0]:.6f} vs "
                  f"{runs[kind]['losses'][2]:.6f} uninterrupted; masters and moments equal bit "
                  f"for bit: {first is None} (first differing {first})", flush=True)
            if loss[0] != runs[kind]["losses"][2] or first is not None:
                raise AssertionError(f"[offload] {kind} resume differs: {first}")
            out[f"{kind}_resume_equal"] = True
            del e
            gc.collect()
        start = {k: v.to("cpu") for k, v in gpt2_model(cfg).init(42, device).items()}
        masters, ada_losses = {}, {}
        for kind, zero in (("offload", cpu_zero), ("device", {"stage": 3})):
            e = engine(zero, optimizer="Adagrad")
            ada_losses[kind] = steps(e, 1, 3, f"{kind} Adagrad")
            masters[kind] = (offload_masters(e) if kind == "offload" else
                             {k: p.detach().to("cpu", copy=True)
                              for k, p in e.state.params.items()})
            del e
            gc.collect()
        print(f"[offload] Adagrad over 3 steps, losses: offload {ada_losses['offload']}, "
              f"in-device {ada_losses['device']}", flush=True)
        out["adagrad"] = hold_to_device("Adagrad", start, masters["device"], masters["offload"],
                                        cfg.n_embd, device, OFFLOAD_PARITY)
        e = engine(cpu_zero, precision={"fp16": {"enabled": True, "initial_scale_power": 40}})
        before = offload_masters(e)
        loss = steps(e, 1, 1, "fp16 overflow")
        first, _ = first_difference(before, offload_masters(e))
        print(f"[offload] fp16, initial_scale_power 40: loss {loss[0]:.4f}, skipped steps "
              f"{e.skipped_steps}, host steps {e._offload_tier.step_count}, loss scale "
              f"{e.loss_scale():.0f}; masters unchanged bit for bit: {first is None}",
              flush=True)
        if e.skipped_steps != 1 or e._offload_tier.step_count != 0 or first is not None:
            raise AssertionError("[offload] the fp16 overflow step was not skipped cleanly")
        out.update(fp16_skipped=True, nvme_equal_cpu=True)
        del e
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    return out


def offload_path(device, smi: str) -> dict:
    """``[offload]``: the ZeRO-Offload optimizer tier, lanes A and B
    (``offload_lane_a``, ``offload_lane_b``)."""
    import torch
    t0 = time.perf_counter()
    out = {"lane_a": offload_lane_a(device, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    out["lane_b"] = offload_lane_b(device, smi)
    out["seconds"] = time.perf_counter() - t0
    print(f"[offload] phase {out['seconds']:.1f} s", flush=True)
    return out


def param_offload_cfg(n_layer: int = 24):
    """GPT-2 1.3B's widths as ``bench.py:237-241`` sets them up ("North-star
    config 3"): vocab 50304, seq 1024, width 2048, 16 heads, bf16, as a
    ``causal_lm_model`` (``n_layer`` layers)."""
    from deepspeed_tpu_torch.models import gpt2_cfg
    return gpt2_cfg(vocab_size=50304, max_seq_len=TRAIN_SEQ, n_embd=2048, n_layer=n_layer,
                    n_head=16)


def streamed_window_bytes(co) -> int:
    """The compute-dtype bytes of the largest pair of adjacent segments, from
    the coordinator's shapes: what its window holds at most."""
    import torch
    size = torch.tensor([], dtype=co.compute_dtype).element_size()
    seg = [size * sum(torch.Size(s).numel() for k in g.param_keys for s in co.key_shapes[k])
           for g in co.segments]
    return max(a + b for a, b in zip(seg, seg[1:]))


def param_offload_parity(label: str, start: dict, want: dict, got: dict, n_embd: int,
                         device) -> dict:
    """``update_parity`` of ``got`` against the resident engine's ``want`` over
    every tensor but the key projections' biases (their exact gradient is 0:
    each run's update there is rounding noise, ``[lm-train]`` reports them
    apart). Returns the median, the worst tensor and its reading."""
    import numpy as np
    names = [k for k in start if not k.endswith("k_proj.bias")]
    rel = update_parity({k: start[k] for k in names}, want, got, n_embd, device)
    worst = max(rel, key=rel.get)
    out = {"parity_median": float(np.median(list(rel.values()))), "parity_max": rel[worst],
           "parity_worst": worst}
    print(f"[param-offload] {label}: per tensor |dp - dp_resident| / |dp_resident| over "
          f"{len(rel):,} tensors: median {out['parity_median']:.3e}, max "
          f"{out['parity_max']:.3e} ({worst})", flush=True)
    return out


def witnessed_step(engine, batch) -> dict:
    """One ``train_batch`` of a streamed engine with every push checked: once
    a pushed key's copy has landed, each of its tensors is read back and
    compared on the host with its master cast as a push casts it
    (``cast_master_to``). Returns the loss, the keys checked and the names of
    the tensors that differ (a stale, torn or misplaced push)."""
    import torch

    from deepspeed_tpu_torch.runtime.zero.offload import cast_master_to
    co = engine._param_offload
    real, differ, keys = co.cache._push, set(), [0]

    def push(si):
        pushed = real(si)
        if pushed.event is not None:
            pushed.event.synchronize()
        for key, params in zip(co.segments[si].param_keys, pushed.params):
            for i, (name, t) in zip(co._leaf_index[key], params.items()):
                want = cast_master_to(co.masters[i], t.shape, co.compute_dtype)
                if not torch.equal(t.detach().cpu(), want):
                    differ.add(name)
            keys[0] += 1
        return pushed

    co.cache._push = push
    try:
        loss = float(engine.train_batch(batch))
    finally:
        co.cache._push = real
    return {"loss": loss, "keys_checked": keys[0], "differ": sorted(differ)}


def param_offload_lane_a(device, smi: str) -> dict:
    """``[param-offload]`` lane A: GPT-2 1.3B's widths at full depth
    (``param_offload_cfg``, one layer a segment), bf16 AdamW lr 1e-4 weight
    decay 0.01, clip 1.0, micro-batch 4 x seq 1024 on ``bench.py``'s batch;
    the resident engine (stage 3, 1 + 3 steps), then the streamed engine
    (``offload_param: cpu``) from the resident engine's initial weights
    (``load_full_params``), 1 + 3 steps. Gates: K1 144, K3 72, K4 72 in the
    3 timed streamed steps; every streamed loss within PARAM_OFFLOAD_LOSS_TOL
    of the resident one; the update parity after 2 and 4 steps within
    PARAM_OFFLOAD_PARITY (median) and PARAM_OFFLOAD_PARITY_MAX (worst), a
    planted fault (the embed segment pushed from the previous step's
    masters) outside them after 2 steps; every push of one step read back
    equal to its cast masters (``witnessed_step``), the planted fault's
    not; the streamed peak at most
    PARAM_OFFLOAD_PEAK_RATIO of the resident one; ``peak_live_bytes`` equal
    to ``streamed_window_bytes``. Printed: step ms, tokens/s, MFU, host
    bytes, bytes each way a step, the host split, one traced step's busy
    share. Then the trained masters served (``init_inference``): K1 24 and
    K2 24 x 15 in a 16-token ``generate``, prefill logits within LOGITS_TOL
    of ``apply_fn`` on the same masters in bf16."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import causal_lm_model
    from deepspeed_tpu_torch.ops import op_builder

    cfg = param_offload_cfg()
    n, n_params = cfg.n_layer, cfg.num_params()
    ids = np.random.default_rng(0).integers(0, 50304, size=(OFFLOAD_MICRO, TRAIN_SEQ),
                                            dtype=np.int32)
    batch = {"input_ids": ids}
    config = train_config(OFFLOAD_MICRO, lr=OFFLOAD_LR, zero={"stage": 3})
    streamed_config = train_config(OFFLOAD_MICRO, lr=OFFLOAD_LR, zero={
        "stage": 3, "offload_param": {"device": "cpu"}})
    steps = PARAM_OFFLOAD_WARMUP + PARAM_OFFLOAD_STEPS

    def host(params):
        return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in params.items()}

    def run(engine, label, masters_at=(), last=steps, timed=True):
        """Steps 1 .. ``last`` (the first PARAM_OFFLOAD_WARMUP untimed), each
        loss read on the host; host copies of the masters after the steps in
        ``masters_at`` (outside the timing); the launch counts and the peak
        over the timed steps; with ``timed`` the step time and, for a
        streamed engine, one more step traced."""
        co = engine._param_offload
        losses, masters, copy_s = [], {}, 0.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for step in range(1, last + 1):
            if step == PARAM_OFFLOAD_WARMUP + 1:
                op_builder.reset_launch_counts()
                t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            if step in masters_at:
                t1 = time.perf_counter()
                masters[step] = (co.full_params_host() if co is not None
                                 else host(engine.state.params))
                copy_s += time.perf_counter() - t1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - copy_s
        res = {"losses": losses, "masters": masters, "launches": op_builder.launch_counts(),
               "peak": torch.cuda.max_memory_allocated()}
        if co is not None:
            res.update(host_step_s=dict(co.last_step_s), step_bytes=dict(co.last_step_bytes))
        if not timed:
            return res
        n_timed = last - PARAM_OFFLOAD_WARMUP
        tps = OFFLOAD_MICRO * TRAIN_SEQ * n_timed / dt
        res.update(step_ms=1e3 * dt / n_timed, tokens_per_s=tps,
                   mfu=6 * n_params * tps / PEAK_BF16_FLOPS)
        print(f"[param-offload] {smi}: {label}: losses {', '.join(f'{x:.6f}' for x in losses)}; "
              f"step {res['step_ms']:.2f} ms, {tps:.1f} tokens/s, MFU {res['mfu']:.4f}, peak "
              f"{res['peak'] / 2**30:.3f} GiB; launches {nonzero(res['launches'])}", flush=True)

        if co is not None:
            def traced_step():
                engine.train_batch(batch)
                torch.cuda.synchronize()
            res["trace"] = profile_call(f"param-offload {label} train_batch", traced_step,
                                        top=20)
        return res

    t0 = time.perf_counter()
    engine = dst.initialize(model=causal_lm_model(cfg), config=config, device=device)[0]
    start = host(engine.state.params)
    print(f"[param-offload] resident engine: {n_params:,} parameters, initialize "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    resident = run(engine, "resident (stage 3)", masters_at=(2, steps))
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    def streamed_engine(layers: int = n):
        c = cfg if layers == n else param_offload_cfg(layers)
        t0 = time.perf_counter()
        e = dst.initialize(model=causal_lm_model(c, layers_per_group=1), config=streamed_config,
                           device=device)[0]
        print(f"[param-offload] streamed engine ({layers} layers): initialize "
              f"{time.perf_counter() - t0:.2f} s, {e._param_offload.host_bytes() / 2**30:.3f} "
              f"GiB of host memory", flush=True)
        return e

    before = torch.cuda.memory_allocated()
    engine = streamed_engine()
    co = engine._param_offload
    held = torch.cuda.memory_allocated() - before
    if held != 0 or engine.state is not None or engine.optimizer is not None:
        raise AssertionError(f"[param-offload] the streamed engine holds {held} bytes on the "
                             "card before its first step")
    co.load_full_params(start)
    streamed = run(engine, "streamed (offload_param cpu)", masters_at=(2, steps))
    witness = {"sound": witnessed_step(engine, batch)}
    # the readings now, so each run's host copies go before the next engine
    readings = {f"streamed after {k} steps": param_offload_parity(
        f"streamed after {k} steps", start,
        resident["masters"][k] if k == 2 else resident["masters"].pop(k),
        streamed["masters"].pop(k), cfg.n_embd, device) for k in (2, steps)}
    want = expect(flash_fwd=2 * n * PARAM_OFFLOAD_STEPS, flash_bwd_dq=n * PARAM_OFFLOAD_STEPS,
                  flash_bwd_dkv=n * PARAM_OFFLOAD_STEPS)
    if streamed["launches"] != want:
        raise AssertionError(f"[param-offload] launch counts {nonzero(streamed['launches'])} != "
                             f"{nonzero(want)}")
    loss_err = max(abs(a - b) for a, b in zip(streamed["losses"], resident["losses"]))
    print(f"[param-offload] streamed vs resident losses, max |diff| {loss_err:.3e} (tol "
          f"{PARAM_OFFLOAD_LOSS_TOL})", flush=True)
    if not loss_err <= PARAM_OFFLOAD_LOSS_TOL:
        raise AssertionError(f"[param-offload] losses {streamed['losses']} vs "
                             f"{resident['losses']}")
    out = {"n_layer": n, "n_params": n_params, "loss_err": loss_err,
           "host_bytes": co.host_bytes(), "host_step_s": streamed["host_step_s"],
           "step_bytes": streamed["step_bytes"], "peak_live_bytes": co.cache.peak_live_bytes,
           "window_bytes": streamed_window_bytes(co),
           "launches": streamed["launches"],
           **{f"resident_{k}": resident[k] for k in ("step_ms", "tokens_per_s", "mfu", "peak")},
           **{k: streamed[k] for k in ("step_ms", "tokens_per_s", "mfu", "peak")}}
    trace = streamed["trace"]
    if trace is not None:
        by = trace["by_kernel"]
        out.update(traced_wall_ms=trace["wall_us"] / 1e3, traced_device_ms=trace["device_us"] / 1e3,
                   traced_busy_share=trace["device_us"] / trace["wall_us"],
                   traced_h2d_ms=sum(us for k, us in by.items() if "HtoD" in k) / 1e3,
                   traced_d2h_ms=sum(us for k, us in by.items() if "DtoH" in k) / 1e3)
    hs, sb = out["host_step_s"], out["step_bytes"]
    print(f"[param-offload] {smi}: streamed step {out['step_ms']:.2f} ms against resident "
          f"{out['resident_step_ms']:.2f} ms; host: push {1e3 * hs['push_s']:.1f} ms, "
          f"accumulate {1e3 * hs['accumulate_s']:.1f} ms, update {1e3 * hs['update_s']:.1f} ms "
          f"(last untraced step); {sb['pushed'] / 1e9:.3f} GB pushed to the card, "
          f"{sb['pulled'] / 1e9:.3f} GB copied back a step; host memory "
          f"{out['host_bytes'] / 2**30:.3f} GiB"
          + (f"; traced step: wall {out['traced_wall_ms']:.2f} ms, device "
             f"{out['traced_device_ms']:.2f} ms (H2D {out['traced_h2d_ms']:.2f}, D2H "
             f"{out['traced_d2h_ms']:.2f}), busy share {out['traced_busy_share']:.3f}"
             if trace is not None else ""), flush=True)
    if out["peak_live_bytes"] != out["window_bytes"]:
        raise AssertionError(f"[param-offload] peak_live_bytes {out['peak_live_bytes']} != the "
                             f"largest adjacent pair {out['window_bytes']}")
    ratio = streamed["peak"] / resident["peak"]
    out["peak_ratio"] = ratio
    print(f"[param-offload] {smi}: peak device memory streamed {streamed['peak'] / 2**30:.3f} GiB, "
          f"resident {resident['peak'] / 2**30:.3f} GiB: {ratio:.4f} (gate <= "
          f"{PARAM_OFFLOAD_PEAK_RATIO}); window {out['peak_live_bytes'] / 2**20:.1f} MiB "
          f"(= the largest adjacent pair of segments)", flush=True)
    if not ratio <= PARAM_OFFLOAD_PEAK_RATIO:
        raise AssertionError(f"[param-offload] streamed peak {ratio:.4f} x the resident one")

    # ---- serving the trained masters
    masters = co.full_params_host()
    del engine, co
    gc.collect()
    torch.cuda.empty_cache()
    prompt = np.random.default_rng(SEED).integers(0, 50304, (1, PROMPT))
    served_engine = dst.init_inference((cfg, masters), {"dtype": "bfloat16",
                                                        "max_out_tokens": 1024}, device=device)
    op_builder.reset_launch_counts()
    tokens = served_engine.generate(prompt, max_new_tokens=PARAM_OFFLOAD_SERVE_NEW)
    serve_launches = op_builder.launch_counts()
    served = served_engine.forward(prompt)
    del served_engine
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        trained = causal_lm_model(cfg).apply_fn(
            {k: v.to(device, torch.bfloat16) for k, v in masters.items()},
            {"input_ids": torch.as_tensor(prompt, device=device)})
    serve_err = float((served.float() - trained.float()).abs().max())
    want = expect(flash_fwd=n, decode_attention=n * (PARAM_OFFLOAD_SERVE_NEW - 1))
    print(f"[param-offload] served the trained masters (init_inference bf16): 1 x {PROMPT} "
          f"prompt, {PARAM_OFFLOAD_SERVE_NEW} new, launches {nonzero(serve_launches)}; prefill "
          f"logits vs apply_fn on the masters in bf16 max |diff| {serve_err:.4e} (tol "
          f"{LOGITS_TOL})", flush=True)
    if serve_launches != want or not serve_err <= LOGITS_TOL \
            or tokens.shape != (1, PROMPT + PARAM_OFFLOAD_SERVE_NEW):
        raise AssertionError(f"[param-offload] serving: launches {nonzero(serve_launches)}, err "
                             f"{serve_err}, shape {tokens.shape}")
    out.update(serve_err=serve_err, serve_launches=serve_launches)
    del served, trained, masters
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the planted fault: the embed segment pushed from the previous step's masters
    engine = streamed_engine()
    co = engine._param_offload
    co.load_full_params(start)
    seg0 = [i for k in co.segments[0].param_keys for i in co._leaf_index[k]]
    stale, real_push, real_update = {}, co._push_segment, co._host_update

    def stale_push(si):
        """Segment 0 cast from the masters as they were before the last update."""
        if si != 0 or not stale:
            return real_push(si)
        fresh = {i: co.masters[i] for i in seg0}
        for i in seg0:
            co.masters[i] = stale[i]
        try:
            return real_push(si)
        finally:
            for i, t in fresh.items():
                co.masters[i] = t

    def keep_stale(*args):
        stale.update({i: co.masters[i].clone() for i in seg0})
        return real_update(*args)

    co.cache._push, co._host_update = stale_push, keep_stale
    run(engine, "planted fault", last=1, timed=False)
    witness["planted fault"] = witnessed_step(engine, batch)
    fault_masters = co.full_params_host()
    del engine, co
    gc.collect()
    torch.cuda.empty_cache()
    readings["planted fault after 2 steps"] = param_offload_parity(
        "planted fault after 2 steps", start, resident["masters"][2], fault_masters,
        cfg.n_embd, device)
    del fault_masters
    print(f"[param-offload] every push of one step read back against its cast masters: "
          f"sound run (step {steps + 2}) {witness['sound']['keys_checked']} keys, differing "
          f"{witness['sound']['differ']}; planted fault (step 2) "
          f"{witness['planted fault']['keys_checked']} keys, differing "
          f"{witness['planted fault']['differ']}", flush=True)
    if witness["sound"]["differ"] or not witness["sound"]["keys_checked"] \
            or not witness["planted fault"]["differ"]:
        raise AssertionError(f"[param-offload] push witness {witness}")
    out["push_witness"] = witness
    passes = {k: r["parity_median"] <= PARAM_OFFLOAD_PARITY
              and r["parity_max"] <= PARAM_OFFLOAD_PARITY_MAX for k, r in readings.items()}
    ok = all(v for k, v in passes.items() if not k.startswith("planted")) \
        and not passes["planted fault after 2 steps"]
    print(f"[param-offload] update parity gate (median <= {PARAM_OFFLOAD_PARITY}, worst <= "
          f"{PARAM_OFFLOAD_PARITY_MAX}): {passes}; the sound runs pass and the planted fault "
          f"fails: {ok}", flush=True)
    if not ok:
        raise AssertionError(f"[param-offload] update parity {readings}")
    out["parity"] = readings
    del resident, streamed, start
    gc.collect()
    return out


def param_offload_lane_a2(device, smi: str, lane_a: dict) -> dict:
    """``[param-offload]`` lane A2: lane A's widths at PARAM_OFFLOAD_A2_LAYERS
    layers, streamed only, 1 + 1 steps: K1, K3, K4 exact in the timed step;
    ``peak_live_bytes`` equal to lane A's; the peak at most lane A's plus the
    boundary carries of the extra layers (micro-batch x seq x width x 2 B
    each) plus PARAM_OFFLOAD_A2_SLACK: the card's memory does not grow with
    depth."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import causal_lm_model
    from deepspeed_tpu_torch.ops import op_builder

    cfg = param_offload_cfg(PARAM_OFFLOAD_A2_LAYERS)
    n = cfg.n_layer
    ids = np.random.default_rng(0).integers(0, 50304, size=(OFFLOAD_MICRO, TRAIN_SEQ),
                                            dtype=np.int32)
    t0 = time.perf_counter()
    engine = dst.initialize(model=causal_lm_model(cfg, layers_per_group=1), device=device,
                            config=train_config(OFFLOAD_MICRO, lr=OFFLOAD_LR, zero={
                                "stage": 3, "offload_param": {"device": "cpu"}}))[0]
    init_s = time.perf_counter() - t0
    co = engine._param_offload
    torch.cuda.reset_peak_memory_stats()
    losses = [float(engine.train_batch({"input_ids": ids}))]
    torch.cuda.synchronize()
    op_builder.reset_launch_counts()
    t0 = time.perf_counter()
    losses.append(float(engine.train_batch({"input_ids": ids})))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = op_builder.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    carries = (n - lane_a["n_layer"]) * OFFLOAD_MICRO * TRAIN_SEQ * cfg.n_embd * 2
    limit = lane_a["peak"] + carries + PARAM_OFFLOAD_A2_SLACK
    out = {"n_layer": n, "n_params": cfg.num_params(), "initialize_s": init_s,
           "step_ms": 1e3 * step_s, "peak": peak, "peak_limit": limit,
           "peak_live_bytes": co.cache.peak_live_bytes, "host_bytes": co.host_bytes(),
           "losses": losses, "launches": launches}
    print(f"[param-offload] {smi}: {n} layers ({cfg.num_params():,} parameters) streamed: "
          f"initialize {init_s:.2f} s, losses {losses}, step {1e3 * step_s:.2f} ms, peak "
          f"{peak / 2**30:.3f} GiB (lane A {lane_a['peak'] / 2**30:.3f} GiB + "
          f"{n - lane_a['n_layer']} carries "
          f"{carries / 2**30:.3f} GiB + slack {PARAM_OFFLOAD_A2_SLACK / 2**30:.2f} GiB = limit "
          f"{limit / 2**30:.3f} GiB), window {co.cache.peak_live_bytes:,} B (lane A "
          f"{lane_a['peak_live_bytes']:,} B), host memory {out['host_bytes'] / 2**30:.3f} GiB; "
          f"launches {nonzero(launches)}", flush=True)
    want = expect(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n)
    if launches != want or not peak <= limit \
            or co.cache.peak_live_bytes != lane_a["peak_live_bytes"] \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"[param-offload] lane A2: {out}")
    del engine, co
    gc.collect()
    torch.cuda.empty_cache()
    return out


def param_offload_lane_b(device, smi: str) -> dict:
    """``[param-offload]`` lane B, GPT-2 125M's widths through
    ``causal_lm_model`` (vocab 50304, width 768, 12 layers, micro-batch 8,
    seq 1024, bf16 AdamW), in a temporary directory it removes: (a)
    ``offload_param: nvme`` equal to ``cpu`` bit for bit over 3 steps with
    gradient accumulation 2 (losses, masters, moments); (b) a save after step
    2 resumed in a fresh engine: step 3 equal to the uninterrupted one bit for
    bit, cpu and nvme; (c) fp16 with ``initial_scale_power`` 40: the step
    skipped, every master unchanged; (d) Adagrad under ``cpu``: the loss
    falls over 3 steps on one batch. Every micro-batch launches K1 24, K3 and
    K4 12."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import causal_lm_model, gpt2_cfg
    from deepspeed_tpu_torch.ops import op_builder

    cfg = gpt2_cfg(vocab_size=50304, max_seq_len=TRAIN_SEQ, n_embd=768, n_layer=12, n_head=12)
    gas = 2
    root = tempfile.mkdtemp(prefix="ds-param-offload-")
    fs = subprocess.run(["stat", "-f", "-c", "%T", root], capture_output=True, text=True,
                        timeout=60).stdout.strip()
    out, launches = {"filesystem": fs}, {}

    def engine(offload, optimizer="AdamW", precision=None, micro_steps=gas):
        zero = {"stage": 3, "offload_param": offload}
        config = train_config(PARAM_OFFLOAD_B_MICRO, zero=zero, optimizer=optimizer,
                              precision=precision)
        config.update(train_batch_size=PARAM_OFFLOAD_B_MICRO * micro_steps,
                      gradient_accumulation_steps=micro_steps)
        return dst.initialize(model=causal_lm_model(cfg, layers_per_group=2), config=config,
                              device=device)[0]

    def batch(step, rows=PARAM_OFFLOAD_B_MICRO * gas):
        rng = np.random.default_rng(3000 + step)
        return {"input_ids": rng.integers(0, 50304, (rows, TRAIN_SEQ))}

    def steps(e, first, last, label, micro=gas, same=False):
        op_builder.reset_launch_counts()
        losses = [float(e.train_batch(batch(first if same else s, PARAM_OFFLOAD_B_MICRO * micro)))
                  for s in range(first, last + 1)]
        torch.cuda.synchronize()
        got, k = op_builder.launch_counts(), 12 * micro * (last - first + 1)
        if got != expect(flash_fwd=2 * k, flash_bwd_dq=k, flash_bwd_dkv=k):
            raise AssertionError(f"[param-offload] {label}: launch counts {nonzero(got)}")
        for name, v in got.items():
            launches[name] = launches.get(name, 0) + v
        return losses

    def state(e):
        sd = e._param_offload.state_dict()
        return {f"{part}.{k}": v.clone() for part in ("masters", "m", "v") for k, v in
                sd[part].items()}

    def nvme(path):
        return {"device": "nvme", "nvme_path": path}

    try:
        runs = {}
        for kind, offload in (("cpu", {"device": "cpu"}), ("nvme", nvme(os.path.join(root, "a")))):
            e = engine(offload)
            losses = steps(e, 1, 2, f"{kind} steps 1-2")
            t0 = time.perf_counter()
            e.save_checkpoint(os.path.join(root, kind))
            save_s = time.perf_counter() - t0
            losses += steps(e, 3, 3, f"{kind} step 3")
            runs[kind] = {"losses": losses, "state": state(e), "save_s": save_s,
                          "host_bytes": e._param_offload.host_bytes()}
            if kind == "nvme":
                handle = e._param_offload.param_tier.handle
                out["o_direct_held"] = handle.o_direct and not handle.direct_refused
            del e
            gc.collect()
        first, worst = first_difference(runs["cpu"]["state"], runs["nvme"]["state"])
        same = runs["cpu"]["losses"] == runs["nvme"]["losses"] and first is None
        print(f"[param-offload] nvme vs cpu over 3 steps, gradient accumulation {gas} ({fs} "
              f"under {root}, O_DIRECT held: {out['o_direct_held']}): losses "
              f"{runs['nvme']['losses']} vs {runs['cpu']['losses']}; "
              f"{len(runs['cpu']['state'])} masters and moments equal bit for bit: {same} "
              f"(first differing {first}, max |diff| {worst:.3e}); host memory cpu "
              f"{runs['cpu']['host_bytes'] / 2**30:.3f} GiB, nvme "
              f"{runs['nvme']['host_bytes'] / 2**30:.3f} GiB; save {runs['cpu']['save_s']:.2f} s "
              f"cpu, {runs['nvme']['save_s']:.2f} s nvme", flush=True)
        if not same:
            raise AssertionError(f"[param-offload] nvme differs from cpu: {first}")
        out.update(nvme_equal_cpu=True, host_bytes_cpu=runs["cpu"]["host_bytes"],
                   host_bytes_nvme=runs["nvme"]["host_bytes"])
        for kind, offload in (("cpu", {"device": "cpu"}), ("nvme", nvme(os.path.join(root, "b")))):
            e = engine(offload)
            e.load_checkpoint(os.path.join(root, kind))
            loss = steps(e, 3, 3, f"{kind} resumed step 3")
            first, _ = first_difference(runs[kind]["state"], state(e))
            print(f"[param-offload] {kind}: resumed from global_step2, step 3 loss {loss[0]:.6f} "
                  f"vs {runs[kind]['losses'][2]:.6f} uninterrupted; masters and moments equal "
                  f"bit for bit: {first is None} (first differing {first})", flush=True)
            if loss[0] != runs[kind]["losses"][2] or first is not None:
                raise AssertionError(f"[param-offload] {kind} resume differs: {first}")
            out[f"{kind}_resume_equal"] = True
            del e
            gc.collect()
        e = engine({"device": "cpu"}, precision={"fp16": {"enabled": True,
                                                          "initial_scale_power": 40}})
        before = e._param_offload.full_params_host()
        loss = steps(e, 1, 1, "fp16 overflow")
        first, _ = first_difference(before, e._param_offload.full_params_host())
        print(f"[param-offload] fp16, initial_scale_power 40: loss {loss[0]:.4f}, skipped steps "
              f"{e.skipped_steps}, host steps {e._param_offload.step_count}, loss scale "
              f"{e.loss_scale():.0f}; masters unchanged bit for bit: {first is None}", flush=True)
        if e.skipped_steps != 1 or e._param_offload.step_count != 0 or first is not None:
            raise AssertionError("[param-offload] the fp16 overflow step was not skipped cleanly")
        out["fp16_skipped"] = True
        del e, before
        gc.collect()
        e = engine({"device": "cpu"}, optimizer="Adagrad", micro_steps=1)
        ada = steps(e, 1, 3, "Adagrad", micro=1, same=True)
        print(f"[param-offload] Adagrad (offload_param cpu), one batch 3 times: losses {ada}",
              flush=True)
        if not all(np.isfinite(ada)) or not ada[-1] < ada[0]:
            raise AssertionError(f"[param-offload] Adagrad losses not falling: {ada}")
        out["adagrad_losses"] = ada
        del e
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    return out


def param_offload_path(device, smi: str) -> dict:
    """``[param-offload]``: ZeRO-3 parameter offload, lanes A, A2 and B."""
    import torch
    t0 = time.perf_counter()
    out = {"lane_a": param_offload_lane_a(device, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    out["lane_a2"] = param_offload_lane_a2(device, smi, out["lane_a"])
    gc.collect()
    torch.cuda.empty_cache()
    out["lane_b"] = param_offload_lane_b(device, smi)
    out["seconds"] = time.perf_counter() - t0
    print(f"[param-offload] phase {out['seconds']:.1f} s", flush=True)
    return out


def chunk_vs_full(engine, ids, device, full_cfg) -> dict:
    """The chunked-vocab loss's backward on the card: on the engine's
    weights, the loss and every gradient of one micro-batch of 4 (the first
    rows of ``ids``) through ``ChunkedVocabCrossEntropy`` against the same
    through the full ``(b, t, V)`` logits (``full_cfg``, the same model with
    ``vocab_chunk`` 0). Two readings frame the limit: the full-logits loss
    against itself (the run-to-run spread) and a planted fault, the
    chunked backward with its ``dwte`` left at zero (a fault that
    ``kernels_vs_plain`` cannot see, since both of its sides take the same
    chunked backward). The worst relative gradient error must be within
    ``CHUNK_GRAD_RTOL`` and the fault's above it."""
    import torch

    from deepspeed_tpu_torch.models import gpt2_model
    from deepspeed_tpu_torch.runtime.zero import tiling

    small = {"input_ids": torch.from_numpy(ids[:4]).to(device)}
    full_loss = gpt2_model(full_cfg).loss_fn

    def worst(a, b):
        rel = {k: float((a[1][k].float() - g.float()).norm() / g.float().norm())
               for k, g in b[1].items()}
        name = max(rel, key=rel.get)
        return abs(float(a[0]) - float(b[0])), rel[name], name

    want = grads_of(engine, small, full_loss)
    spread = worst(grads_of(engine, small, full_loss), want)
    got = worst(grads_of(engine, small), want)
    backward = tiling.ChunkedVocabCrossEntropy.backward

    def dwte_left_at_zero(ctx, grad):
        dx, dwte, *rest = backward(ctx, grad)
        return (dx, torch.zeros_like(dwte), *rest)

    tiling.ChunkedVocabCrossEntropy.backward = staticmethod(dwte_left_at_zero)
    try:
        fault = worst(grads_of(engine, small), want)
    finally:
        tiling.ChunkedVocabCrossEntropy.backward = staticmethod(backward)
    for what, (loss_diff, rel, name) in (("full logits twice", spread),
                                         ("chunked vs full logits", got),
                                         ("planted fault, dwte 0", fault)):
        print(f"[remat] micro-batch 4, {what}: loss |diff| {loss_diff:.3e}; gradients, "
              f"max relative error {rel:.3e} ({name}) (tol {CHUNK_GRAD_RTOL})", flush=True)
    if not (got[0] <= CHUNK_LOSS_TOL and got[1] <= CHUNK_GRAD_RTOL < fault[1]):
        raise AssertionError(f"[remat] chunked loss's backward: {got} against the full "
                             f"logits', planted fault {fault}, tol {CHUNK_GRAD_RTOL}")
    return {"chunk_loss_err": got[0], "chunk_grad_rel_err_max": got[1],
            "chunk_grad_spread": spread[1], "chunk_grad_fault": fault[1]}


def hd_refusals(device) -> dict:
    """``initialize`` refuses a GPT-2 whose head_dim, 256 (width 4096 over 16
    heads), the training kernels do not take, and ``init_inference`` one of
    head_dim 84 (not a multiple of 8): ValueError naming the head_dim, before
    any launch and before any weight reaches the card."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import GPT2Config, gpt2_cfg, gpt2_model
    from deepspeed_tpu_torch.ops import op_builder

    config = {"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 2e-4}},
              "bf16": {"enabled": True}}
    tries = (
        ("initialize", "head_dim 256", lambda: dst.initialize(
            model=gpt2_model(GPT2Config(vocab_size=50304, n_positions=TRAIN_SEQ, n_embd=4096,
                                        n_layer=2, n_head=16)), config=config, device=device)),
        ("init_inference", "head_dim 84", lambda: dst.init_inference(
            gpt2_cfg(vocab_size=50304, max_seq_len=1024, n_embd=336, n_layer=2, n_head=4),
            {"dtype": "bfloat16"}, device=device)))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    op_builder.reset_launch_counts()
    out = {}
    for name, mark, fn in tries:
        try:
            fn()
        except ValueError as e:
            if mark not in str(e):
                raise AssertionError(f"[hd] {name} refused without naming {mark}: {e}")
            out[name] = str(e)
            print(f"[hd] {name} refused: {e}", flush=True)
        else:
            raise AssertionError(f"[hd] {name} accepted a model of {mark}")
    launches, held = op_builder.launch_counts(), torch.cuda.memory_allocated() - before
    print(f"[hd] refusals: launches {launches}, {held} bytes more on the card", flush=True)
    if any(launches.values()) or held:
        raise AssertionError(f"[hd] a refused engine launched {launches} or holds {held} bytes")
    return out


def hd_serve(device, smi: str, label: str, cfg, n_new: int, n_requests: int) -> dict:
    """One ``[hd]`` serving model: ``generate`` as ``[main]`` (``n_new`` new
    tokens) and the scheduler as ``[serve]`` (``n_requests`` requests), on
    one engine."""
    import torch

    import deepspeed_tpu_torch as dst

    t0 = time.perf_counter()
    engine = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": 1024},
                                device=device)
    torch.cuda.synchronize()
    print(f"[{label}] init_inference {time.perf_counter() - t0:.2f} s "
          f"({cfg.num_params() / 1e9:.2f} B parameters, head_dim {cfg.head_dim})", flush=True)
    gen = main_path(device, cfg, label, n_new, engine, f32_witness=True)
    print(f"[{label}] {smi}: TTFT {gen['ttft_ms']:.3f} ms, TPOT {gen['tpot_ms']:.4f} ms, "
          f"decode {gen['decode_tokens_per_s']:.1f} tokens/s (batch 4, prompt {PROMPT}, "
          f"{gen['new_tokens']} new), peak memory {gen['peak_memory_bytes'] / 2**30:.2f} GiB",
          flush=True)
    serve = serve_path(device, smi, cfg, engine, n_requests, f"{label} serve")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"generate": gen, "serve": serve}


def hd_path(device, smi: str) -> dict:
    """``[hd]``: head dims other than 64 and 128 on the 128- and 256-wide
    kernel builds, at full width, seeded random weights, bf16. The refusals;
    GPT-2 2.7B (the port's preset ``gpt2-2.7b``: vocab 50304, 32 layers,
    width 2560, 32 heads, head_dim 80) through ``generate`` and the scheduler
    (K1, K2, K5 at d 80); GPT-J-6B's shape (EleutherAI's ``gpt-j-6b`` config:
    vocab 50400, 28 layers, width 4096, 16 heads, head_dim 256, rotary on 64
    dims, parallel residual, untied biased head, no qkv bias) the same way
    (K1, K2, K5 at d 256); GPT-2 760M (``gpt2-760m``: 24 layers, width 1536,
    16 heads, head_dim 96) trained as ``[train]`` (K1, K3, K4) and then as
    ``[sparse]`` with the same Fixed layout over 16 heads (K8, K9, K10)."""
    import torch

    from deepspeed_tpu_torch.models import GPT2Config, gpt2_cfg, gptj_cfg
    from deepspeed_tpu_torch.ops import sparse_attention
    from deepspeed_tpu_torch.ops.attention import make_sparse_attention_impl
    from deepspeed_tpu_torch.ops.kernel_checks import GPT2_760M_SPARSE

    out = {"refusals": hd_refusals(device)}
    out["gpt2_2.7b"] = hd_serve(
        device, smi, "hd gpt2-2.7b",
        gpt2_cfg(vocab_size=50304, max_seq_len=1024, n_embd=2560, n_layer=32, n_head=32),
        N_NEW, HD_GPT2_REQUESTS)
    out["gptj_6b"] = hd_serve(
        device, smi, "hd gptj-6b",
        gptj_cfg(vocab_size=50400, max_seq_len=2048, n_embd=4096, n_layer=28, n_head=16,
                 qkv_bias=False, tie_word_embeddings=False, lm_head_bias=True),
        HD_GPTJ_NEW, HD_GPTJ_REQUESTS)

    def gpt2_760m(**kw):
        return GPT2Config(vocab_size=50304, n_positions=TRAIN_SEQ, n_embd=1536, n_layer=24,
                          n_head=16, dropout=0.0, **kw)

    n = 24
    dense = train_run(device, smi, "hd gpt2-760m train", gpt2_760m(),
                      {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n},
                      plain_and_traced(device, plain_attention, "hd gpt2-760m train"),
                      micro=HD_MICRO, steps=HD_STEPS, warmup=HD_WARMUP)
    gc.collect()
    name, kw = GPT2_760M_SPARSE
    sparse = train_run(device, smi, "hd gpt2-760m sparse", gpt2_760m(
        attention_impl=make_sparse_attention_impl(getattr(sparse_attention, name)(**kw))),
        {"block_sparse_fwd": n, "block_sparse_bwd_dq": n, "block_sparse_bwd_dkv": n},
        plain_and_traced(device, plain_sparse, "hd gpt2-760m sparse"),
        lambda _: f" (dense step {dense['step_ms']:.2f} ms)", micro=HD_MICRO,
        steps=HD_SPARSE_STEPS, warmup=HD_SPARSE_WARMUP)
    out["gpt2_760m_train"], out["gpt2_760m_sparse"] = dense, sparse
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hd_launches(hd: dict, case) -> int:
    """A kernel's launches in the ``[hd]`` run its check case is shaped by
    (the case's ``hd_run``, a path into ``hd_path``'s results)."""
    run = hd
    for key in case.hd_run.split("/"):
        run = run[key]
    return run["launches"][case.kernel]


def wq_same_bytes(a, b) -> bool:
    """Two quant nodes hold the same keys, shapes, dtypes and bytes."""
    return set(a) == set(b) and all(
        a[k].shape == b[k].shape and a[k].dtype == b[k].dtype and
        a[k].cpu().numpy().tobytes() == b[k].cpu().numpy().tobytes() for k in a)


def wq_path(device, smi: str):
    """Weight-quantized serving of BLOOM-7B: bf16, int8 and int4 lanes, one
    after another (each engine is built in f32 first, ~28 GB), on one seed."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.decode_fns import prefill
    from deepspeed_tpu_torch.models import bloom_cfg, init_cache
    from deepspeed_tpu_torch.models.causal_lm import QuantDense
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.quantizer import quantize_with_audit

    cfg = bloom_cfg(vocab_size=250880, max_seq_len=WQ_PROMPT + WQ_NEW, n_embd=4096,
                    n_layer=30, n_head=32)
    lanes = {"bf16": None, "int8": 8, "int4": 4}
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, WQ_PROMPT))
    n_proj = cfg.n_layer * 6
    probe = {}                    # layer 0 fc_in quantized on the card and on the CPU
    out, full, ref = {}, None, None
    for name, bits in lanes.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        config = {"dtype": "bfloat16", "max_out_tokens": WQ_PROMPT + WQ_NEW}
        if bits:
            config["weight_quant"] = {"enabled": True, "bits": bits}
        t0 = time.perf_counter()
        engine = dst.init_inference(cfg, config, device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated()
        resident = torch.cuda.memory_allocated()
        lane = {"build_s": build_s, "build_peak_bytes": build_peak, "resident_bytes": resident}
        if bits is None:
            w = engine.module.layers[0].fc_in.weight.t()
            for b in (8, 4):
                on_card, _ = quantize_with_audit(w, bits=b, group_size=128, threshold=1.0,
                                                 name="layers_0/fc_in/kernel")
                on_cpu, _ = quantize_with_audit(w.cpu(), bits=b, group_size=128,
                                                threshold=1.0, name="layers_0/fc_in/kernel")
                same = wq_same_bytes(on_card, on_cpu)
                print(f"[wq] layers_0/fc_in int{b}: quantized on the card == on the CPU, byte "
                      f"for byte: {same}", flush=True)
                if not same:
                    raise AssertionError(f"int{b}: card and CPU quantization differ")
                probe[b] = {k: v.cpu() for k, v in on_cpu.items()}
                del on_card
            del w
        else:
            audit = engine.quant_audit
            n_q = sum(1 for e in audit if e["decision"] == "quantized")
            node = engine.module.layers[0].fc_in.node()
            same = wq_same_bytes(node, probe[bits])
            rep = engine.weight_stream_report()
            lane.update(matrices_quantized=n_q, matrices_kept_fp=len(audit) - n_q,
                        weight_stream=rep, node_matches_cpu=same)
            print(f"[wq] {name}: {n_q} matrices quantized, {len(audit) - n_q} kept fp; layer 0 "
                  f"fc_in == the CPU's quantization: {same}; modeled weight bytes a step "
                  f"{rep['modeled_step_bytes'] / 1e9:.4f} GB (bf16 equivalent "
                  f"{rep['bf16_equiv_step_bytes'] / 1e9:.4f} GB), reduction on the quantized "
                  f"matrices {rep['reduction_quantized_nodes']:.4f}x, total "
                  f"{rep['reduction_total']:.4f}x", flush=True)
            if n_q != n_proj or not same or \
                    not rep["reduction_quantized_nodes"] >= WQ_REDUCTION[bits] or \
                    sum(isinstance(m, QuantDense) for m in engine.module.modules()) != n_proj:
                raise AssertionError(f"{name}: {n_q} matrices, node match {same}, reduction "
                                     f"{rep['reduction_quantized_nodes']}")

        def counted(fn, new_tokens):
            op_builder.reset_launch_counts()
            res = fn()
            torch.cuda.synchronize()
            launches = op_builder.launch_counts()
            want = expect(flash_fwd=cfg.n_layer,
                          quantized_matmul=n_proj * new_tokens if bits else 0)
            if launches != want:
                raise AssertionError(f"{name}: launch counts {launches} != {want}")
            return res, launches

        for n in (WQ_SHORT, WQ_NEW):                     # warm-up
            counted(lambda: engine.generate(ids, max_new_tokens=n), n)
        samples = []
        for _ in range(WQ_ROUNDS):
            t0 = time.perf_counter()
            toks, launches = counted(lambda: engine.generate(ids, max_new_tokens=WQ_NEW), WQ_NEW)
            dt_long, ttft = time.perf_counter() - t0, engine.ttft
            t0 = time.perf_counter()
            counted(lambda: engine.generate(ids, max_new_tokens=WQ_SHORT), WQ_SHORT)
            dt_short = time.perf_counter() - t0
            per_token = (dt_long - dt_short) / (WQ_NEW - WQ_SHORT)
            samples.append((1.0 / per_token if per_token > 0 else None, ttft))
        if toks.shape != (1, WQ_PROMPT + WQ_NEW) or \
                not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{name}: generate returned {toks.shape} or ids out of range")
        tps = [t for t, _ in samples if t]
        lane.update(decode_tokens_per_s=statistics.median(tps) if tps else None,
                    ttft_ms=statistics.median(tt for _, tt in samples) * 1e3,
                    generate_launches=launches, peak_bytes=torch.cuda.max_memory_allocated())

        # teacher-forced greedy parity on the bf16 lane's own tokens
        with torch.inference_mode():
            if bits is None:
                full = toks
            logits, _ = counted(lambda: engine.forward(full), 1)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{name}: non-finite teacher-forced logits")
            am = logits[:, WQ_PROMPT - 1:-1].argmax(-1)
            del logits
        if bits is None:
            ref = am
        else:
            lane["greedy_parity_vs_bf16"] = float((am == ref).float().mean())

        # one decode step traced, at the prompt's end
        with torch.inference_mode():
            caches = init_cache(engine.model_config, 1, WQ_PROMPT + WQ_NEW, device=device)
            lens = torch.full((1,), WQ_PROMPT, dtype=torch.int32, device=device)
            tok = prefill(engine.module, torch.from_numpy(ids).to(device), caches,
                          lens).argmax(-1)[:, None]

            def step():
                engine.module(tok, positions=lens[:, None], caches=caches, cache_lens=lens)
                torch.cuda.synchronize()

            step()
            prof = profile_call(f"[wq] {name} decode step (BLOOM-7B, batch 1, row {WQ_PROMPT})",
                                step, top=10)
            del caches
        if prof is not None:
            # K6's kernels by name; the library's matrix products by the
            # substrings of cuBLAS/CUTLASS kernel names (in the quantized
            # lanes only the tied head's product is left)
            by = prof["by_kernel"]
            lane["decode_step_device_ms"] = prof["device_us"] / 1e3
            lane["decode_step_qmm_ms"] = sum(v for key, v in by.items() if "qmm" in key) / 1e3
            lane["decode_step_launches"] = prof["launches"]
            lane["decode_step_library_gemm_ms"] = sum(
                v for key, v in by.items()
                if any(t in key.lower() for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))
            ) / 1e3
            lane["decode_step_busy_share"] = prof["device_us"] / prof["wall_us"]
        print(f"[wq] {smi}: {name}: decode {lane['decode_tokens_per_s'] or 0:.2f} tokens/s, "
              f"TTFT {lane['ttft_ms']:.2f} ms (medians of {WQ_ROUNDS} rounds), build "
              f"{build_s:.1f} s (peak {build_peak / 2**30:.2f} GiB), resident "
              f"{resident / 2**30:.2f} GiB, peak {lane['peak_bytes'] / 2**30:.2f} GiB; "
              f"launches of a {WQ_NEW}-token generate {launches}"
              + (f"; greedy parity vs bf16 {lane['greedy_parity_vs_bf16']:.4f}" if bits else "")
              + (f"; traced decode step: device {lane['decode_step_device_ms']:.3f} ms, "
                 f"dequant-GEMM {lane['decode_step_qmm_ms']:.3f} ms, library GEMMs "
                 f"{lane['decode_step_library_gemm_ms']:.3f} ms, busy share "
                 f"{lane['decode_step_busy_share']:.3f}, {lane['decode_step_launches']} "
                 f"launches" if prof else ""), flush=True)
        out[name] = lane
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    if not out["int8"]["greedy_parity_vs_bf16"] >= WQ_PARITY_INT8:
        raise AssertionError(f"int8 greedy parity {out['int8']['greedy_parity_vs_bf16']} < "
                             f"{WQ_PARITY_INT8}")
    return out


def moe_path(device, smi: str):
    """MoE serving (``[moe]``): GPT-2 125M with every 2nd FFN a top-1 mixture
    of 8 experts, as ``bench.py``'s MoE lane serves it (BENCH_MOE_EXPERTS=8),
    bf16, batch 1, prompt 512, greedy. Decode tokens/s by differencing 256-
    and 64-token ``generate`` calls (median of 3 rounds), TTFT, launch counts
    exact in every call; one decode step's logits on K7 against the plain
    FFN, then teacher-forced steps (:func:`teacher_forced`) at batch 1 and
    16; the dense twin on the same seed and traffic; a traced decode step;
    a top-2 engine; the ``[serve]`` traffic through the scheduler; an int8
    engine with quantized expert stacks."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.decode_fns import prefill
    from deepspeed_tpu_torch.models import gpt2_cfg, init_cache
    from deepspeed_tpu_torch.ops import op_builder

    def model_cfg(**kw):
        return gpt2_cfg(vocab_size=50304, max_seq_len=2048, n_embd=768, n_layer=12,
                        n_head=12, **kw)

    cfg = model_cfg(num_experts=8)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layer))
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, MOE_PROMPT))
    config = {"dtype": "bfloat16", "max_out_tokens": MOE_PROMPT + MOE_NEW}

    def counted(fn, want):
        op_builder.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        launches = op_builder.launch_counts()
        if launches != want:
            raise AssertionError(f"[moe] launch counts {launches} != {want}")
        return res, launches

    def generate_want(model, new, moe_layers):
        return expect(flash_fwd=model.n_layer, decode_attention=model.n_layer * (new - 1),
                      moe_decode_ffn=moe_layers * (new - 1))

    def lane(engine, moe_layers):
        """Decode tokens/s by differencing, TTFT; launches exact in every call."""
        model = engine.model_config
        for n in (MOE_SHORT, MOE_NEW):                                  # warm-up
            counted(lambda: engine.generate(ids, max_new_tokens=n),
                    generate_want(model, n, moe_layers))
        samples = []
        for _ in range(MOE_ROUNDS):
            t0 = time.perf_counter()
            counted(lambda: engine.generate(ids, max_new_tokens=MOE_NEW),
                    generate_want(model, MOE_NEW, moe_layers))
            dt_long, ttft = time.perf_counter() - t0, engine.ttft
            t0 = time.perf_counter()
            toks, launches = counted(lambda: engine.generate(ids, max_new_tokens=MOE_SHORT),
                                     generate_want(model, MOE_SHORT, moe_layers))
            dt_short = time.perf_counter() - t0
            per_token = (dt_long - dt_short) / (MOE_NEW - MOE_SHORT)
            samples.append((1.0 / per_token if per_token > 0 else None, ttft))
        if toks.shape != (1, MOE_PROMPT + MOE_SHORT) or \
                not ((toks >= 0) & (toks < model.vocab_size)).all():
            raise AssertionError(f"[moe] generate returned {toks.shape} or ids out of range")
        tps = [t for t, _ in samples if t]
        return {"decode_tokens_per_s": statistics.median(tps) if tps else None,
                "ttft_ms": statistics.median(tt for _, tt in samples) * 1e3,
                "generate_launches": launches, "tokens": toks}

    t0 = time.perf_counter()
    engine = dst.init_inference(cfg, config, device=device)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "moe_layers": n_moe,
           "params": cfg.num_params()}
    main = lane(engine, n_moe)
    out.update(decode_tokens_per_s=main["decode_tokens_per_s"], ttft_ms=main["ttft_ms"],
               launches=main["generate_launches"])

    # one decode step's logits at the prompt's end: K7 against the plain FFN,
    # same engine, same cache. bf16 activations through 12 layers, where h's
    # rounding to bf16 can flip by an ulp between the two f32 sums, move
    # logits of magnitude ~1 by a few bf16 ulps; LOGITS_TOL = 0.1 leaves room
    # for that and fails on any real disagreement (a wrong expert, bias or
    # f-block moves a layer's FFN output by its whole size)
    lens = torch.full((1,), MOE_PROMPT, dtype=torch.int32, device=device)
    ids_dev = torch.from_numpy(ids).to(device)
    with torch.inference_mode():
        caches = init_cache(engine.model_config, 1, MOE_PROMPT + 8, device=device)
        tok = prefill(engine.module, ids_dev, caches, lens).argmax(-1)[:, None]
        base = [{k: v.clone() for k, v in c.items()} for c in caches]

        def step(plain=False):
            from contextlib import nullcontext
            pages = [{k: v.clone() for k, v in c.items()} for c in base]
            with plain_moe() if plain else nullcontext():
                logits, _ = engine.module(tok, positions=lens[:, None], caches=pages,
                                          cache_lens=lens)
            return logits[:, -1]

        (logits_k, _), (logits_p, _) = (
            counted(step, expect(decode_attention=cfg.n_layer, moe_decode_ffn=n_moe)),
            counted(lambda: step(plain=True), expect(decode_attention=cfg.n_layer)))
    if not bool(torch.isfinite(logits_k).all()) or logits_k.shape != (1, cfg.vocab_size):
        raise AssertionError(f"[moe] step logits non-finite or shaped {tuple(logits_k.shape)}")
    step_err = float((logits_k - logits_p).abs().max())
    print(f"[moe] decode step logits max_abs_err K7 vs plain FFN {step_err:.4e} (tol "
          f"{LOGITS_TOL}, |logits| max {float(logits_p.abs().max()):.3f})", flush=True)
    if not step_err <= LOGITS_TOL:
        raise AssertionError(f"[moe] K7 step logits differ by {step_err} > {LOGITS_TOL}")
    out["step_logit_err"] = step_err

    # teacher-forced: the plain FFN's greedy tokens, fed step by step through
    # K7 and through the plain FFN, each on its own cache from one prefill;
    # batch 1 over MOE_SHORT steps (K7 at n = 1), then a batch of
    # MOE_TF_BATCH (n = 16 a layer, the scheduler's) over MOE_TF_STEPS
    with plain_moe():
        toks_p = engine.generate(ids, max_new_tokens=MOE_SHORT)
    ids16 = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size,
                                                      (MOE_TF_BATCH, MOE_PROMPT))
    with plain_moe():
        toks16 = engine.generate(ids16, max_new_tokens=MOE_TF_STEPS)
    out["teacher_forced"] = {
        "batch1": teacher_forced(engine, ids, toks_p[:, MOE_PROMPT:], n_moe, counted),
        f"batch{MOE_TF_BATCH}": teacher_forced(engine, ids16, toks16[:, MOE_PROMPT:], n_moe,
                                                counted)}

    # one decode step traced
    with torch.inference_mode():
        def traced_step():
            step()
            torch.cuda.synchronize()

        traced_step()
        prof = profile_call(f"[moe] decode step (GPT-2 125M, 8 experts, batch 1, row "
                            f"{MOE_PROMPT})", traced_step, top=12)
    if prof is not None:
        print_traced("moe", "traced decode step", "K2", prof, out, "decode_step_k2")
        by = prof["by_kernel"]
        out.update(decode_step_device_ms=prof["device_us"] / 1e3,
                   decode_step_k7_ms=sum(v for key, v in by.items() if "moe_ffn" in key) / 1e3,
                   decode_step_k7_span_ms=k7_span_us(prof) / 1e3,
                   decode_step_busy_share=prof["device_us"] / prof["wall_us"])
    del caches, base, logits_k, logits_p

    # the scheduler: [serve]'s traffic on the MoE engine
    out["serve"] = moe_serve(engine, n_moe)
    del engine
    gc.collect()

    # the dense twin: same model without experts, same seed and traffic
    dense = dst.init_inference(model_cfg(), config, device=device)
    twin = lane(dense, 0)
    out.update(dense_decode_tokens_per_s=twin["decode_tokens_per_s"],
               dense_ttft_ms=twin["ttft_ms"])
    if out["decode_tokens_per_s"] and twin["decode_tokens_per_s"]:
        out["moe_over_dense_decode"] = out["decode_tokens_per_s"] / twin["decode_tokens_per_s"]
    del dense
    gc.collect()

    # top-2: K7 at n = 2, once a MoE layer a step
    top2 = dst.init_inference(model_cfg(num_experts=8, moe_top_k=2), config, device=device)
    toks, launches = counted(lambda: top2.generate(ids, max_new_tokens=MOE_SMALL_NEW),
                             generate_want(top2.model_config, MOE_SMALL_NEW, n_moe))
    if toks.shape != (1, MOE_PROMPT + MOE_SMALL_NEW):
        raise AssertionError(f"[moe] top-2 generate returned {toks.shape}")
    out["top2_launches"] = launches
    print(f"[moe] top-2: {MOE_SMALL_NEW} new tokens, launches {launches}", flush=True)
    del top2
    gc.collect()

    # int8 expert stacks: the quantized decode path gathers the selected
    # experts' payloads in plain tensor code (no K7); every projection in K6
    q8 = dst.init_inference(cfg, {**config, "weight_quant": {"enabled": True, "bits": 8}},
                            device=device)
    audit = q8.quant_audit
    n_q = sum(1 for e in audit if e["decision"] == "quantized")
    n_stacks = sum(1 for e in audit if e["decision"] == "quantized" and "moe_experts" in e["name"])
    n_proj = cfg.n_layer * 4 + (cfg.n_layer - n_moe) * 2
    toks, launches = counted(
        lambda: q8.generate(ids, max_new_tokens=MOE_SMALL_NEW),
        expect(flash_fwd=cfg.n_layer, decode_attention=cfg.n_layer * (MOE_SMALL_NEW - 1),
               quantized_matmul=n_proj * MOE_SMALL_NEW))
    rep = q8.weight_stream_report()
    print(f"[moe] int8: {n_q} of {len(audit)} matrices quantized ({n_stacks} expert stacks); "
          f"launches of a {MOE_SMALL_NEW}-token generate {launches}; modeled weight bytes a "
          f"step {rep['modeled_step_bytes'] / 1e9:.4f} GB (bf16 equivalent "
          f"{rep['bf16_equiv_step_bytes'] / 1e9:.4f} GB)", flush=True)
    if n_q != n_proj + 2 * n_moe or n_stacks != 2 * n_moe:
        raise AssertionError(f"[moe] int8: {n_q} matrices, {n_stacks} expert stacks quantized")
    out.update(int8_matrices_quantized=n_q, int8_expert_stacks=n_stacks,
               int8_launches=launches, int8_modeled_step_bytes=rep["modeled_step_bytes"])
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe] {smi}: decode {out['decode_tokens_per_s'] or 0:.2f} tokens/s, TTFT "
          f"{out['ttft_ms']:.2f} ms (medians of {MOE_ROUNDS} rounds; dense twin "
          f"{out['dense_decode_tokens_per_s'] or 0:.2f} tokens/s, TTFT "
          f"{out['dense_ttft_ms']:.2f} ms; MoE / dense decode "
          f"{out.get('moe_over_dense_decode', 0):.4f}); launches of a {MOE_SHORT}-token "
          f"generate {out['launches']}"
          + (f"; traced decode step: device {out['decode_step_device_ms']:.3f} ms, K7 "
             f"{out['decode_step_k7_ms']:.3f} ms (FFN start to reduction end "
             f"{out['decode_step_k7_span_ms']:.3f} ms), busy share "
             f"{out['decode_step_busy_share']:.3f}" if prof else ""), flush=True)
    return out


class replayed_routing:
    """Context manager over ``sharded_moe.choose_expert``, the call through
    which every gate of the port picks its experts (``top1gating``,
    ``top2gating``, ``topk_select``). Until :meth:`replay` each call records
    its choices; after it, each call is given the recorded choices of its rows
    in call order (a model whose calls split the same rows in chunks, as the
    serving prefill does, walks the same record), and the program's own gate
    builds everything else from them: weights, dispatch, combine, aux loss.
    Where the call's own choice differs it is counted (``flips`` of
    ``choices``), with the recorded top-1 lead over the top-2 score of each
    row (its margin). The router is not what a kernel-vs-plain or a
    served-vs-trained comparison holds: a gate near-tie flips on a bf16
    rounding in the layers below, and that token's FFN output then changes
    by its whole size."""

    def __enter__(self):
        from unittest import mock

        from deepspeed_tpu_torch.moe import sharded_moe
        self._own = sharded_moe.choose_expert
        self._routes, self._margins, self._flat, self._diffs = [], [], None, []
        self.recorded, self.choices, self._cursor = 0, 0, 0
        self._patch = mock.patch.object(sharded_moe, "choose_expert", self._call)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        return False

    def replay(self):
        """Replay the record from its start (again, if called again)."""
        import torch
        self._flat = torch.cat(self._routes)
        self._margin = torch.cat(self._margins)
        self._diffs, self.choices, self._cursor = [], 0, 0

    def _flipped(self):
        import torch
        return (torch.cat(self._diffs) if self._diffs else
                torch.zeros(0, dtype=torch.bool, device=self._flat.device))

    @property
    def flips(self) -> int:
        return int(self._flipped().sum())

    def flips_above(self, margin: float) -> int:
        """Flips of the replay where the recorded margin exceeds ``margin``."""
        return int((self._flipped() & (self._margin[:self._cursor] > margin)).sum())

    @property
    def max_flip_margin(self) -> float:
        """The largest recorded margin among the replay's flips (0 if none)."""
        m = self._margin[:self._cursor][self._flipped()]
        return float(m.max()) if m.numel() else 0.0

    def _call(self, scores):
        own = self._own(scores)
        if self._flat is None:
            top2 = scores.float().topk(2, dim=-1).values
            self._routes.append(own)
            self._margins.append(top2[:, 0] - top2[:, 1])
            self.recorded += own.shape[0]
            return own
        s = own.shape[0]
        idx = self._flat[self._cursor:self._cursor + s]
        if idx.shape[0] != s:
            raise AssertionError(f"routing replay: {self._cursor + s} rows asked of "
                                 f"{self.recorded} recorded")
        self._cursor += s
        self.choices += s
        self._diffs.append(own != idx)
        return idx


def teacher_forced(engine, prompts, forced, n_moe: int, counted):
    """``forced (b, steps)`` (the plain FFN's greedy tokens, the prefill's
    first) fed step by step through the decode step twice from one prefill
    of ``prompts``, each run on its own copy of the cache: first with the
    plain FFN, recording every MoE layer's routing, then with K7, given the
    plain run's routing at each layer. At every step the logits must lie
    within LOGITS_TOL of the plain ones, and their argmax must equal the
    plain argmax wherever the plain top-1 leads the top-2 by more than 2 x
    LOGITS_TOL (closer margins are near-ties of random weights, which a
    rounding may flip). The routing is forced because the router is not K7:
    a gate near-tie (top-1 margins of a few 1e-3 occur among the 768 choices
    of a 16-sequence run) flips on the bf16 rounding that two f32 sum orders
    leave in the layers below, the layer's FFN output then changes by its
    whole size, and the chains part for a reason that is no fault of either
    FFN; the K7 run's own choices are counted where they differ. Launch
    counts are exact on both runs."""
    from contextlib import nullcontext

    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.decode_fns import prefill
    from deepspeed_tpu_torch.models import init_cache

    cfg, device = engine.model_config, engine.device
    b, steps = forced.shape
    lens = torch.full((b,), prompts.shape[1], dtype=torch.int32, device=device)
    forced_dev = torch.from_numpy(np.ascontiguousarray(forced)).to(device)

    with torch.inference_mode():
        base = init_cache(cfg, b, prompts.shape[1] + steps, device=device)
        prefill(engine.module, torch.from_numpy(prompts).to(device), base, lens)

        def chain(plain):
            pages = [{k: v.clone() for k, v in c.items()} for c in base]
            logits = []
            with plain_moe() if plain else nullcontext():
                for s in range(steps):
                    out, _ = engine.module(forced_dev[:, s:s + 1], positions=(lens + s)[:, None],
                                           caches=pages, cache_lens=lens + s)
                    logits.append(out[:, -1])
            return torch.stack(logits, dim=1)                        # (b, steps, V)

        with replayed_routing() as routing:
            ref, _ = counted(lambda: chain(True), expect(decode_attention=cfg.n_layer * steps))
            routing.replay()
            k7, _ = counted(lambda: chain(False), expect(decode_attention=cfg.n_layer * steps,
                                                          moe_decode_ffn=n_moe * steps))
    if not routing.recorded == routing.choices == b * n_moe * steps:
        raise AssertionError(f"[moe] teacher-forced batch {b}: {routing.recorded} routings "
                             f"recorded, {routing.choices} replayed, for {b * n_moe * steps} "
                             "token x MoE layer steps")
    if not bool(torch.isfinite(k7).all()):
        raise AssertionError(f"[moe] teacher-forced batch {b}: non-finite K7 logits")
    err = (k7 - ref).abs().amax(dim=(0, 2))                          # (steps,)
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * LOGITS_TOL          # (b, steps)
    same = k7.argmax(-1) == ref.argmax(-1)
    res = {"steps": steps, "batch": b, "max_abs_err": float(err.max()),
           "worst_step": int(err.argmax()), "agreement": float(same.float().mean()),
           "excluded_by_margin": int((~decided).sum()), "positions": b * steps,
           "own_routing_differs": routing.flips,
           "routing_choices": b * n_moe * steps,
           "plain_vs_generate": float((ref.argmax(-1)[:, :-1] == forced_dev[:, 1:]).float()
                                      .mean()) if steps > 1 else 1.0}
    print(f"[moe] teacher-forced batch {b}, {steps} steps: logits max_abs_err K7 vs plain FFN "
          f"{res['max_abs_err']:.4e} (step {res['worst_step']}; tol {LOGITS_TOL} at every "
          f"step); argmax agreement {res['agreement']:.4f} over {res['positions']} positions, "
          f"{res['excluded_by_margin']} with a top-2 margin <= {2 * LOGITS_TOL} left out of "
          f"the assert; the K7 run's own router chose otherwise in "
          f"{res['own_routing_differs']} of {res['routing_choices']} choices; plain steps vs "
          f"plain generate {res['plain_vs_generate']:.4f}", flush=True)
    bad = [int(s) for s in torch.nonzero(err > LOGITS_TOL).flatten()]
    if bad or not bool(err.max() <= LOGITS_TOL):
        raise AssertionError(f"[moe] teacher-forced batch {b}: K7 logits differ by more than "
                             f"{LOGITS_TOL} at steps {bad} (max {res['max_abs_err']})")
    if not bool(same[decided].all()):
        where = [tuple(int(v) for v in p) for p in torch.nonzero(decided & ~same)][:8]
        raise AssertionError(f"[moe] teacher-forced batch {b}: K7 argmax differs where the "
                             f"plain margin exceeds {2 * LOGITS_TOL}: (row, step) {where}")
    return res


def moe_serve(engine, n_moe: int):
    """``[serve]``'s 48 requests through the scheduler on the MoE engine."""
    import torch

    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
    from deepspeed_tpu_torch.ops import op_builder

    cfg = engine.model_config
    config, requests = serve_setup(cfg)
    sched = ContinuousBatchingScheduler(engine, config)
    handles = [sched.submit(p, max_new_tokens=m) for p, m in requests]
    torch.cuda.synchronize()
    op_builder.reset_launch_counts()
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = op_builder.launch_counts()
    tele = sched.telemetry.snapshot()
    bad = [(h.id, len(h.tokens), m) for h, (_, m) in zip(handles, requests)
           if len(h.tokens) != m or h.finish_reason != "length"]
    if bad:
        raise AssertionError(f"[moe] scheduler requests that did not finish with their "
                             f"budget: {bad}")
    chunks, misses = tele["chunks"], tele["prefix_misses"]
    want = expect(flash_fwd=cfg.n_layer * misses,
                  paged_decode_attention=cfg.n_layer * SERVE_CHUNK * chunks,
                  moe_decode_ffn=n_moe * SERVE_CHUNK * chunks)
    print(f"[moe] scheduler launches {launches} (expected {want}: {chunks} chunks, {misses} "
          "prefix misses)", flush=True)
    if launches != want:
        raise AssertionError(f"[moe] scheduler launch counts {launches} != {want}")
    tokens = sum(len(h.tokens) for h in handles)
    out = {"requests_per_s": len(requests) / wall, "tokens_per_s": tokens / wall,
           "wall_s": wall, "tpot_ms_p50": tele["tpot_ms_p50"], "tpot_ms_p95": tele["tpot_ms_p95"],
           "ttft_ms_p50": tele["ttft_ms_p50"], "chunks": chunks,
           "chunk_ms_mean": sched.telemetry.decode_seconds / chunks * 1e3,
           "launches": launches}
    print(f"[moe] scheduler: {len(requests)} requests in {wall:.3f} s: "
          f"{out['requests_per_s']:.3f} requests/s, {out['tokens_per_s']:.1f} generated "
          f"tokens/s; TPOT p50 {out['tpot_ms_p50']:.3f} ms p95 {out['tpot_ms_p95']:.3f} ms; "
          f"mean chunk {out['chunk_ms_mean']:.3f} ms over {chunks} chunks", flush=True)
    del sched
    gc.collect()
    return out


def ckpt_train_config():
    """``[train]``'s configuration with a WarmupLR schedule (so the schedule's
    state must round-trip too)."""
    return {"train_batch_size": TRAIN_MICRO, "train_micro_batch_size_per_gpu": TRAIN_MICRO,
            "optimizer": {"type": "AdamW", "params": {"lr": 2e-4, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 2e-4,
                                     "warmup_num_steps": 10, "warmup_type": "linear"}},
            "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
            "gradient_clipping": 1.0, "steps_per_print": 10**9}


def ckpt_engine(device, seed: int):
    """``initialize`` on ``[train]``'s GPT-2 125M with weights from ``seed``."""
    import dataclasses

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2_model
    from deepspeed_tpu_torch.models.gpt2 import init_params

    cfg = gpt2_train_cfg()
    model = dataclasses.replace(gpt2_model(cfg),
                                init_fn=lambda _, dev: init_params(cfg, seed, dev))
    return dst.initialize(model=model, config=ckpt_train_config(), device=device)[0]


def ckpt_batch(step: int) -> dict:
    """The seeded batch of training step ``step`` (1-based): a distinct batch a
    step, so the data order matters."""
    import numpy as np
    rng = np.random.default_rng(1000 + step)
    return {"input_ids": rng.integers(0, 50304, (TRAIN_MICRO, TRAIN_SEQ))}


def ckpt_steps(engine, first: int, last: int, label: str):
    """``train_batch`` on the batches of steps ``first``..``last``: each step must
    launch K1, K3 and K4 exactly 12 times. Returns the losses."""
    import torch

    from deepspeed_tpu_torch.ops import op_builder

    op_builder.reset_launch_counts()
    losses = [engine.train_batch(ckpt_batch(s)) for s in range(first, last + 1)]
    torch.cuda.synchronize()
    launches = op_builder.launch_counts()
    n = 12 * (last - first + 1)
    want = expect(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n)
    if launches != want:
        raise AssertionError(f"[ckpt] {label}: launch counts {launches} != {want}")
    return [float(x) for x in losses], launches


def host_tree(engine) -> dict:
    """Every tensor of the engine's state, as host copies by dotted name."""
    from deepspeed_tpu_torch.runtime.engine import state_tree

    def flat(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: tree.detach().to("cpu", copy=True)}
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}.{key}" if prefix else key).items()}
    return flat(state_tree(engine.state))


def first_difference(a: dict, b: dict):
    """(the first name whose tensors differ, max |a - b| over all of them)."""
    import torch
    first, worst = None, 0.0
    for name in a:
        if not torch.equal(a[name], b[name]):
            first = first or name
            worst = max(worst, float((a[name].double() - b[name].double()).abs().max()))
    return first, worst


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def ckpt_child(argv) -> int:
    """``python3 chip_smoke.py --ckpt-child DIR crash|resume``, ``[ckpt]`` (b)'s
    two processes. ``crash``: steps 1 and 2, commit ``good``, write step 3's
    loss, then save ``bad`` with a SIGKILL armed inside its second shard write.
    ``resume``: another seed's engine loads ``latest`` and takes step 3."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.utils.fault_injection import FaultSpec, inject

    ckpt_dir, phase = argv
    device = torch.device("cuda", 0)
    if phase == "crash":
        engine = ckpt_engine(device, 0)
        ckpt_steps(engine, 1, 2, "crash child")
        engine.save_checkpoint(ckpt_dir, tag="good")
        loss, _ = ckpt_steps(engine, 3, 3, "crash child")
        with open(os.path.join(ckpt_dir, "expected.txt"), "w") as f:
            f.write(repr(loss[0]))
        with inject("ckpt.save.io", FaultSpec(kind="kill", after_n=1)):
            engine.save_checkpoint(ckpt_dir, tag="bad")
        return 7                                  # unreachable: the fault killed us
    engine = ckpt_engine(device, 1)
    path, _ = engine.load_checkpoint(ckpt_dir)
    if os.path.basename(path) != "good" or engine.global_steps != 2:
        raise AssertionError(f"resume child loaded {path} at step {engine.global_steps}")
    loss, _ = ckpt_steps(engine, 3, 3, "resume child")
    with open(os.path.join(ckpt_dir, "resumed.txt"), "w") as f:
        f.write(repr(loss[0]))
    return 0


def ckpt_path(device, smi: str) -> dict:
    """``[ckpt]``: training checkpoints of ``[train]``'s GPT-2 125M (plus
    WarmupLR) in a temporary directory it removes. (a) engine A takes steps
    1-3, saves ``global_step3``, takes 4-6; engine A2, the same run again,
    measures whether two identical runs agree bit for bit; engine B (another
    seed) loads ``latest`` (every restored tensor and counter equal to what
    was saved, bit for bit) and takes 4-6, its losses and final masters held
    to A's within A2's spread (bit for bit when that is 0). (b) a child dies
    by SIGKILL inside a shard write of ``bad`` after committing ``good``; a
    second resumes and takes step 3 at the first one's loss. (c) SIGTERM to
    this process under ``CheckpointAutoSaver``: ``after_step`` saves, marks,
    exits 143; ``resume`` into engine C. (d) the universal export read back
    with ``torch.load`` equals B's masters and moments; ``zero_to_fp32`` equals
    ``export_fp32_state_dict``; the tag served through ``convert_training_model``
    and ``init_inference`` (launches exact, prefill logits within LOGITS_TOL of
    the training forward) and through ``InferenceEngine.load_checkpoint``.
    (e) bytes, seconds and rates printed; (f) peak device memory of the save
    and of the load at most 2 x the largest tensor above the level before."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint import (export_fp32_state_dict,
                                                export_universal_checkpoint)
    from deepspeed_tpu_torch.models import gpt2_model
    from deepspeed_tpu_torch.module_inject import convert_training_model
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
        TorchCheckpointEngine, validate_manifest, write_latest_pointer)
    from deepspeed_tpu_torch.runtime.engine import CheckpointAutoSaver
    from deepspeed_tpu_torch.utils import zero_to_fp32

    root = tempfile.mkdtemp(prefix="ds-ckpt-")
    free0 = shutil.disk_usage(root).free
    print(f"[ckpt] {root}: {free0 / 1e9:.2f} GB free", flush=True)
    out, totals, peak_disk = {"disk_free_bytes": free0}, {}, [0]

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    def disk():
        peak_disk[0] = max(peak_disk[0], dir_bytes(root))

    try:
        # ---------------------------------------------------------------- (a)
        save_dir = os.path.join(root, "a")
        a = ckpt_engine(device, 0)
        losses_a, n = ckpt_steps(a, 1, 3, "A")
        add(n)
        saved, sched = host_tree(a), a.lr_scheduler.state_dict()
        largest = max(t.numel() * t.element_size() for t in saved.values())
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        path = a.save_checkpoint(save_dir, client_state={"phase": "ckpt"})
        save_s = time.perf_counter() - t0
        save_peak = torch.cuda.max_memory_allocated() - before
        save_t = dict(a.checkpoint_engine.timings)
        written = dir_bytes(path)
        disk()
        more, n = ckpt_steps(a, 4, 6, "A")
        add(n)
        losses_a += more
        final_a = {k: v.detach().to("cpu", copy=True) for k, v in a.state.params.items()}
        del a
        gc.collect()

        a2 = ckpt_engine(device, 0)
        losses_a2, n = ckpt_steps(a2, 1, 6, "A2")
        add(n)
        final_a2 = {k: v.detach().to("cpu", copy=True) for k, v in a2.state.params.items()}
        del a2
        gc.collect()
        det_first, det_master = first_difference(final_a, final_a2)
        det_loss = max(abs(x - y) for x, y in zip(losses_a, losses_a2))
        print(f"[ckpt] two identical runs (A, A2) over 6 steps: losses max |diff| "
              f"{det_loss:.3e}, masters max |diff| {det_master:.3e}, first differing "
              f"tensor {det_first}", flush=True)

        b = ckpt_engine(device, 1)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got_path, client = b.load_checkpoint(save_dir)
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() - before
        load_t = dict(b.checkpoint_engine.timings)
        restored = host_tree(b)
        wrong = [k for k in saved if not torch.equal(saved[k], restored[k])]
        counters = (b.global_steps, b.skipped_steps, b.micro_steps, b._host_steps)
        if got_path != path or client != {"phase": "ckpt"} or wrong or \
                counters != (3, 0, 3, 3) or b.lr_scheduler.state_dict() != sched:
            raise AssertionError(f"[ckpt] restore: path {got_path}, client {client}, "
                                 f"differing {wrong[:5]}, counters {counters}, "
                                 f"schedule {b.lr_scheduler.state_dict()} vs {sched}")
        print(f"[ckpt] restored {len(saved)} tensors bit for bit (masters, exp_avg, "
              f"exp_avg_sq, Adam step, scaler, global_step, skipped_steps), counters "
              f"{counters}, schedule {sched}", flush=True)

        # (d) the exports, from B as loaded (the tag's state)
        export_dir = os.path.join(root, "export")
        t0 = time.perf_counter()
        upath = export_universal_checkpoint(b, export_dir)
        fp32 = export_fp32_state_dict(b, os.path.join(export_dir, "pytorch_model.bin"))
        zpath = os.path.join(export_dir, "zero_to_fp32.bin")
        zsd = zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(save_dir, zpath)
        export_s = time.perf_counter() - t0
        disk()
        for pname in fp32:
            for fname, prefix in (("fp32", "params"), ("exp_avg", "opt_state.exp_avg"),
                                  ("exp_avg_sq", "opt_state.exp_avg_sq")):
                f = os.path.join(upath, "zero", pname, f"{fname}.pt")
                if not torch.equal(torch.load(f, weights_only=True)["param"],
                                   restored[f"{prefix}.{pname}"]):
                    raise AssertionError(f"[ckpt] universal export {f} differs")
        on_disk = torch.load(os.path.join(export_dir, "pytorch_model.bin"), weights_only=True)
        for k in fp32:
            if not (torch.equal(zsd[k], fp32[k]) and torch.equal(on_disk[k], fp32[k])):
                raise AssertionError(f"[ckpt] zero_to_fp32 and export_fp32_state_dict "
                                     f"differ at {k}")
        print(f"[ckpt] universal export ({dir_bytes(upath) / 1e9:.3f} GB, "
              f"{len(fp32)} params x 3 files) equals the masters and moments; "
              f"zero_to_fp32 equals export_fp32_state_dict; {export_s:.2f} s", flush=True)
        shutil.rmtree(export_dir)
        del on_disk, fp32

        losses_b, n = ckpt_steps(b, 4, 6, "B")
        add(n)
        final_b = {k: v.detach().to("cpu", copy=True) for k, v in b.state.params.items()}
        res_first, res_master = first_difference(final_a, final_b)
        res_loss = max(abs(x - y) for x, y in zip(losses_a[3:], losses_b))
        print(f"[ckpt] resumed B vs uninterrupted A, steps 4-6: losses {losses_b} vs "
              f"{losses_a[3:]}, max |diff| {res_loss:.3e} (limit, A vs A2: {det_loss:.3e}); "
              f"masters max |diff| {res_master:.3e} (limit {det_master:.3e}), first "
              f"differing tensor {res_first}", flush=True)
        if not (res_loss <= det_loss and res_master <= det_master):
            raise AssertionError(f"[ckpt] resumed run outside the determinism spread: "
                                 f"first differing tensor {res_first}")
        del final_a2

        # ---------------------------------------------------------------- (c)
        auto_dir = os.path.join(root, "auto")
        saved_b = host_tree(b)
        with CheckpointAutoSaver(b, auto_dir) as saver:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(200):
                if saver.preempted:
                    break
                time.sleep(0.01)
            try:
                saver.after_step()
                code = None
            except SystemExit as e:                  # the one expected exit
                code = e.code
        marker = os.path.join(auto_dir, CheckpointAutoSaver.PREEMPT_MARKER)
        with open(marker) as f:
            marked = f.read()
        disk()
        if code != 128 + signal.SIGTERM or marked != "global_step6":
            raise AssertionError(f"[ckpt] autosaver exit {code}, marker {marked!r}")
        del b
        gc.collect()
        c = ckpt_engine(device, 2)
        cpath, _ = CheckpointAutoSaver(c, auto_dir).resume()
        wrong = [k for k, v in host_tree(c).items() if not torch.equal(v, saved_b[k])]
        if os.path.basename(cpath) != "global_step6" or os.path.exists(marker) or wrong:
            raise AssertionError(f"[ckpt] autosaver resume: {cpath}, marker left "
                                 f"{os.path.exists(marker)}, differing {wrong[:5]}")
        print(f"[ckpt] autosaver: SIGTERM -> save global_step6 -> marker -> exit {code}; "
              "resume() restored it bit for bit and cleared the marker", flush=True)
        del c, saved_b
        gc.collect()
        shutil.rmtree(auto_dir)

        # ---------------------------------------------------------------- (b)
        kill_dir = os.path.join(root, "kill")
        os.makedirs(kill_dir)
        here = os.path.abspath(__file__)
        t0 = time.perf_counter()
        crash = subprocess.run([sys.executable, here, "--ckpt-child", kill_dir, "crash"],
                               capture_output=True, text=True, timeout=300)
        disk()
        if crash.returncode != -signal.SIGKILL:
            raise AssertionError(f"[ckpt] crash child exited {crash.returncode}, not by "
                                 f"SIGKILL:\n{crash.stdout[-3000:]}\n{crash.stderr[-3000:]}")
        with open(os.path.join(kill_dir, "latest")) as f:
            latest = f.read()
        if os.path.exists(os.path.join(kill_dir, "bad")) or latest != "good":
            raise AssertionError(f"[ckpt] after the kill: bad visible or latest {latest!r}")
        validate_manifest(os.path.join(kill_dir, "good"), strict=True)
        resume = subprocess.run([sys.executable, here, "--ckpt-child", kill_dir, "resume"],
                                capture_output=True, text=True, timeout=300)
        if resume.returncode != 0:
            raise AssertionError(f"[ckpt] resume child exited {resume.returncode}:\n"
                                 f"{resume.stdout[-3000:]}\n{resume.stderr[-3000:]}")
        with open(os.path.join(kill_dir, "expected.txt")) as f:
            expected = float(f.read())
        with open(os.path.join(kill_dir, "resumed.txt")) as f:
            resumed = float(f.read())
        print(f"[ckpt] kill mid-save: the child died by SIGKILL inside a shard write of "
              f"'bad' (staged {os.path.exists(os.path.join(kill_dir, 'bad.tmp'))}, not "
              f"visible), latest 'good' validates; step 3 loss {resumed!r} resumed vs "
              f"{expected!r} before the kill ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not abs(resumed - expected) <= det_loss:
            raise AssertionError(f"[ckpt] step 3 after the kill: {resumed} != {expected}")
        shutil.rmtree(kill_dir)

        # ---------------------------------------------------------------- (d) serving
        cfg = gpt2_train_cfg()
        masters = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(save_dir)
        scfg, sd = convert_training_model(cfg, masters)
        ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (4, PROMPT))
        serve_new = 32
        engine = dst.init_inference((scfg, sd), {"dtype": "bfloat16", "max_out_tokens": 1024},
                                    device=device)
        op_builder.reset_launch_counts()
        tokens = engine.generate(ids, max_new_tokens=serve_new)
        n_gen = op_builder.launch_counts()
        served = engine.forward(ids)
        n_fwd = op_builder.launch_counts()
        with torch.no_grad():
            params = {k: v.to(device, torch.bfloat16) for k, v in masters.items()}
            trained = gpt2_model(cfg).apply_fn(params, {"input_ids": torch.as_tensor(
                ids, device=device)})
        n_all = op_builder.launch_counts()
        want = [expect(flash_fwd=12, decode_attention=12 * (serve_new - 1)),
                expect(flash_fwd=24, decode_attention=12 * (serve_new - 1)),
                expect(flash_fwd=36, decode_attention=12 * (serve_new - 1))]
        if [n_gen, n_fwd, n_all] != want:
            raise AssertionError(f"[ckpt] serving launch counts {[n_gen, n_fwd, n_all]} != "
                                 f"{want}")
        add(n_all)
        serve_err = float((served - trained).abs().max())
        finite = bool(torch.isfinite(served).all())
        print(f"[ckpt] served global_step3 (zero_to_fp32 -> convert_training_model -> "
              f"init_inference bf16): 4 x {PROMPT} prompts, {serve_new} new, launches "
              f"{n_gen}; prefill logits vs the training forward max |diff| "
              f"{serve_err:.4e} (tol {LOGITS_TOL})", flush=True)
        if not finite or not serve_err <= LOGITS_TOL or tokens.shape != (4, PROMPT + serve_new):
            raise AssertionError(f"[ckpt] serving: finite {finite}, err {serve_err}, "
                                 f"shape {tokens.shape}")
        del served, trained, params
        serve_dir = os.path.join(root, "serve")
        writer = TorchCheckpointEngine()
        staged = writer.begin_tag(serve_dir, "serve")
        writer.save({"params": sd}, os.path.join(staged, "state"))
        writer.commit_tag(serve_dir, "serve")
        write_latest_pointer(serve_dir, "serve")
        disk()
        loaded = dst.init_inference(scfg, {"dtype": "bfloat16", "max_out_tokens": 1024},
                                    device=device)             # seeded random weights
        loaded.load_checkpoint(serve_dir)
        op_builder.reset_launch_counts()
        tokens2 = loaded.generate(ids, max_new_tokens=serve_new)
        n_load = op_builder.launch_counts()
        if n_load != want[0] or not np.array_equal(tokens, tokens2):
            raise AssertionError(f"[ckpt] InferenceEngine.load_checkpoint: launches {n_load}, "
                                 f"tokens equal {np.array_equal(tokens, tokens2)}")
        add(n_load)
        print("[ckpt] InferenceEngine.load_checkpoint of a tag with the serving names: "
              "tokens equal to the engine built from the same weights", flush=True)
        del engine, loaded, sd, masters
        gc.collect()
        torch.cuda.empty_cache()

        # ---------------------------------------------------------------- (e), (f)
        hashed = save_t.get("manifest_s", 0.0)
        print(f"[ckpt] {smi}: save {written / 1e9:.3f} GB in {save_s:.3f} s "
              f"({written / save_s / 1e9:.3f} GB/s): device-to-host "
              f"{save_t.get('d2h_s', 0.0):.3f} s, write {save_t.get('write_s', 0.0):.3f} s, "
              f"hash + fsync {hashed:.3f} s, commit {save_t.get('rename_s', 0.0):.3f} s; "
              f"load {load_s:.3f} s ({written / load_s / 1e9:.3f} GB/s): validate "
              f"{load_t.get('validate_s', 0.0):.3f} s, read {load_t.get('read_s', 0.0):.3f} s, "
              f"host-to-device {load_t.get('h2d_s', 0.0):.3f} s; disk free "
              f"{free0 / 1e9:.2f} GB, peak use {peak_disk[0] / 1e9:.3f} GB", flush=True)
        print(f"[ckpt] peak device memory above the level before: save "
              f"{save_peak / 1e6:.1f} MB, load {load_peak / 1e6:.1f} MB (limit 2 x the "
              f"largest tensor, {2 * largest / 1e6:.1f} MB)", flush=True)
        if not (save_peak <= 2 * largest and load_peak <= 2 * largest):
            raise AssertionError(f"[ckpt] device memory: save {save_peak}, load "
                                 f"{load_peak} > {2 * largest}")
        out.update({"bytes_written": written, "save_s": save_s, "load_s": load_s,
                    "save_gb_per_s": written / save_s / 1e9,
                    "load_gb_per_s": written / load_s / 1e9,
                    **{f"save_{k}": v for k, v in save_t.items()},
                    **{f"load_{k}": v for k, v in load_t.items()},
                    "save_peak_extra_bytes": save_peak, "load_peak_extra_bytes": load_peak,
                    "largest_tensor_bytes": largest, "disk_peak_bytes": peak_disk[0],
                    "det_loss_diff": det_loss, "det_master_diff": det_master,
                    "resume_loss_diff": res_loss, "resume_master_diff": res_master,
                    "losses_a": losses_a, "losses_b": losses_b,
                    "kill_loss": [expected, resumed], "serve_logit_err": serve_err,
                    "launches": totals})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------- training features
def bloom_560m_cfg():
    """BLOOM-560M at its published widths (``bigscience/bloom-560m``: 24 layers,
    width 1024, 16 heads, vocab 250,880, ALiBi, embedding LayerNorm, tied
    head), bf16."""
    from deepspeed_tpu_torch.models import bloom_cfg
    return bloom_cfg(vocab_size=250880, max_seq_len=2048, n_embd=1024, n_layer=24, n_head=16)


def tinyllama_cfg():
    """TinyLlama-1.1B's widths (width 2048, 32 heads over 4 KV heads, FFN 5632,
    vocab 32,000, RMSNorm, SwiGLU, rotary), cut from 22 layers to
    ``LM_TINYLLAMA_LAYERS`` for time, bf16."""
    from deepspeed_tpu_torch.models import llama_cfg
    return llama_cfg(vocab_size=32000, max_seq_len=2048, n_embd=2048, n_layer=LM_TINYLLAMA_LAYERS,
                     n_head=32, n_kv_head=4, d_ff=5632, ln_eps=1e-5)


def lm_train_path(device, smi: str) -> dict:
    """``[lm-train]``: ``causal_lm_model`` trained through ``train_run``
    (``train_config(LM_MICRO)``: bf16 AdamW, clip 1.0) at seq 1024,
    ``TRAIN_WARMUP`` + ``LM_STEPS`` steps: BLOOM-560M (K1, K3 and K4 with the
    ALiBi slopes, 24 a step each) and TinyLlama's widths at 4 layers (GQA,
    4 a step). Each is held to the plain attention on one micro-batch
    (``kernels_vs_plain``; the key projection's bias, whose exact gradient is
    0, reported beside)."""
    import torch

    from deepspeed_tpu_torch.models import causal_lm_model

    out = {}
    for label, cfg in (("bloom-560m", bloom_560m_cfg()), ("tinyllama-4l", tinyllama_cfg())):
        n = cfg.n_layer

        def check(engine, ids, label=label):
            loss_err, grad_err = kernels_vs_plain(engine, ids, device, plain_attention,
                                                  f"lm-train {label}",
                                                  exclude=lambda k: k.endswith("k_proj.bias"))
            return {"grad_rel_err_max": grad_err, "loss_err": loss_err}

        res = train_run(device, smi, f"lm-train {label}", cfg,
                        {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}, check,
                        lambda tps, cfg=cfg: f", {cfg.num_params() / 1e6:.1f} M parameters",
                        micro=LM_MICRO, seq=TRAIN_SEQ, steps=LM_STEPS, model=causal_lm_model(cfg),
                        config=train_config(LM_MICRO))
        out[label] = res
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_train_cfg(**kw):
    """``[moe]``'s GPT-2 125M with 8 experts, trained under ``GPT2MoEConfig``'s
    defaults: every 2nd layer, top-1, capacity 1.25, RSample, aux loss
    coefficient 0.01."""
    from deepspeed_tpu_torch.models import GPT2MoEConfig
    return GPT2MoEConfig(vocab_size=50304, n_positions=TRAIN_SEQ, n_embd=768, n_layer=12,
                         n_head=12, num_experts=8, **kw)


def moe_train_path(device, smi: str) -> dict:
    """``[moe-train]``: ``gpt2_moe_model`` through ``train_run`` (micro-batch
    ``MOE_TRAIN_MICRO``, seq 1024, ``TRAIN_WARMUP`` + ``MOE_TRAIN_STEPS``
    steps; K1, K3, K4 12 a step). Then the aux loss and the expert counts of
    one micro-batch (training gates, with their noise), and the trained
    masters served: ``convert_training_model`` -> ``init_inference`` (bf16)
    -> ``generate`` on 4 prompts of ``PROMPT`` tokens, ``MOE_TRAIN_NEW`` new
    (K1 12, K2 12 x (new - 1), K7 6 x (new - 1)); the prefill logits within
    LOGITS_TOL of the training forward in eval mode on the same weights
    (its eval capacity raised to the expert count so that no token drops, as
    serving never drops), the training forward's routing replayed in the
    served one (:class:`replayed_routing`), as ``[moe]``'s teacher-forced
    steps replay theirs. The served router's own choices are held too: at
    most ``ROUTING_FLIP_LIMIT`` of them may differ from the training
    forward's, and none where the recorded margin exceeds ``ROUTER_MARGIN``;
    a planted fault (the served gate's columns of experts 0 and 1 swapped)
    must break both."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2_moe_model
    from deepspeed_tpu_torch.models.gpt2_moe import moe_stats
    from deepspeed_tpu_torch.module_inject import convert_training_model
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.runtime import rng as rng_stream

    cfg = moe_train_cfg()
    n = cfg.n_layer
    n_moe = sum(cfg.is_moe_layer(i) for i in range(n))

    def check(engine, ids):
        masters = {k: p.detach() for k, p in engine.state.params.items()}
        cast = {k: p.to(engine.compute_dtype) for k, p in masters.items()}
        batch = {"input_ids": torch.as_tensor(ids, device=device)}
        aux, counts = moe_stats(cfg, cast, batch, rng_stream.root_key(SEED))
        counts = [c.to("cpu", torch.int64).tolist() for c in counts]
        tokens = ids.size
        cap = int(np.ceil(tokens / cfg.num_experts * cfg.capacity_factor))
        print(f"[moe-train] trained, one micro-batch with the training gates: sum of "
              f"l_aux {float(aux):.6f} over {n_moe} MoE layers (loss term "
              f"{cfg.moe_loss_coef * float(aux):.6f}); expert counts a layer (of {tokens} "
              f"tokens, capacity {cap}): {counts}", flush=True)
        scfg, sd = convert_training_model(cfg, masters)
        served_engine = dst.init_inference((scfg, sd), {"dtype": "bfloat16",
                                                         "max_out_tokens": 1024}, device=device)
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (4, PROMPT))
        op_builder.reset_launch_counts()
        out_tokens = served_engine.generate(prompts, max_new_tokens=MOE_TRAIN_NEW)
        torch.cuda.synchronize()
        launches = op_builder.launch_counts()
        want = expect(flash_fwd=n, decode_attention=n * (MOE_TRAIN_NEW - 1),
                      moe_decode_ffn=n_moe * (MOE_TRAIN_NEW - 1))
        if launches != want or out_tokens.shape != (4, PROMPT + MOE_TRAIN_NEW):
            raise AssertionError(f"[moe-train] serving: launches {launches} != {want} or "
                                 f"shape {out_tokens.shape}")
        eval_cfg = dataclasses.replace(cfg, eval_capacity_factor=float(cfg.num_experts))
        # the planted fault: the served gate's columns of experts 0 and 1 swapped
        swap = [1, 0, *range(2, cfg.num_experts)]
        fault_sd = {k: v[..., swap] if k.endswith("moe_gate") else v for k, v in sd.items()}
        with replayed_routing() as routing:
            with torch.no_grad():
                trained = gpt2_moe_model(eval_cfg).apply_fn(
                    cast, {"input_ids": torch.as_tensor(prompts, device=device)})
            routing.replay()
            served = served_engine.forward(prompts)
            flips, choices = routing.flips, routing.choices
            clear, widest = routing.flips_above(ROUTER_MARGIN), routing.max_flip_margin
            del served_engine
            gc.collect()
            faulty = dst.init_inference((scfg, fault_sd), {"dtype": "bfloat16",
                                                            "max_out_tokens": 1024}, device=device)
            routing.replay()
            faulty.forward(prompts)
            fault_flips, fault_clear = routing.flips, routing.flips_above(ROUTER_MARGIN)
            fault_choices = routing.choices
            del faulty, fault_sd
        err = float((served - trained).abs().max())
        finite = bool(torch.isfinite(served).all())
        rate, fault_rate = flips / max(choices, 1), fault_flips / max(fault_choices, 1)
        print(f"[moe-train] served (convert_training_model -> init_inference bf16): 4 x "
              f"{PROMPT} prompts, {MOE_TRAIN_NEW} new, launches {nonzero(launches)}; prefill "
              f"logits vs the training forward in eval mode, the training forward's routing "
              f"replayed, max |diff| {err:.4e} (tol {LOGITS_TOL}); the served router's own "
              f"choice differed in {flips} of {choices} tokens x MoE layers ({rate:.4%}, "
              f"limit {ROUTING_FLIP_LIMIT:.2%}), {clear} of them with a recorded margin above "
              f"{ROUTER_MARGIN} (must be 0; widest flipped margin {widest:.4e}); planted "
              f"fault (gate columns of experts 0 and 1 swapped): {fault_flips} of "
              f"{fault_choices} ({fault_rate:.4%}), {fault_clear} above the margin", flush=True)
        if not finite or not err <= LOGITS_TOL or not choices == fault_choices == \
                routing.recorded == n_moe * prompts.size:
            raise AssertionError(f"[moe-train] served logits: finite {finite}, err {err}, "
                                 f"{routing.recorded} routings recorded, {choices} and "
                                 f"{fault_choices} replayed")
        if not rate <= ROUTING_FLIP_LIMIT or clear:
            raise AssertionError(f"[moe-train] the served router chose otherwise on {rate:.4%} "
                                 f"of its choices (limit {ROUTING_FLIP_LIMIT:.2%}), {clear} "
                                 f"with a margin above {ROUTER_MARGIN}")
        if not (fault_rate > ROUTING_FLIP_LIMIT and fault_clear):
            raise AssertionError(f"[moe-train] the planted gate fault went unseen: "
                                 f"{fault_rate:.4%} flips, {fault_clear} above the margin")
        return {"aux_loss": float(aux), "expert_counts": counts, "serve_logit_err": err,
                "serve_launches": launches, "serve_routing_flips": flips,
                "serve_routing_choices": choices, "serve_routing_flips_above_margin": clear,
                "serve_routing_widest_flip_margin": widest,
                "fault_routing_flips": fault_flips, "fault_routing_flips_above_margin": fault_clear}

    return train_run(device, smi, "moe-train", cfg,
                     {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}, check,
                     micro=MOE_TRAIN_MICRO, seq=TRAIN_SEQ, steps=MOE_TRAIN_STEPS,
                     model=gpt2_moe_model(cfg),
                     config=train_config(MOE_TRAIN_MICRO))


def dropout_path(device, smi: str) -> dict:
    """``[dropout]``: ``[train]``'s GPT-2 125M with dropout ``DROPOUT`` (GPT-2's
    published ``resid/embd/attn_pdrop``), ``train_config(DROPOUT_MICRO)``,
    fed through ``training_data`` (one seeded batch of ``DROPOUT_MICRO``
    sequences of 1024 tokens, as ``[train]``'s, listed once a step;
    ``train_batch()`` draws them). Engine A
    (weights from seed 0) takes ``DROPOUT_STEPS`` steps and saves a tag after
    half of them; A2 repeats A; R is A under ``remat_policy="full"``; B
    (weights from seed 1) loads A's tag and takes the second half on the rest
    of the data. Gates: no flash kernel launches in any step (attention
    dropout goes to the plain attention: JAX's rule); A's losses finite and
    falling; A2, R and B equal to A bit for bit, every loss and every final
    master (two runs from one seed; remat's recompute redraws the same masks;
    the keys resume with the step counter)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2_model
    from deepspeed_tpu_torch.models.gpt2 import init_params
    from deepspeed_tpu_torch.ops import op_builder

    # one seeded batch repeated for every step, as [train] trains on one batch
    batch = np.random.default_rng(SEED).integers(0, 50304, (DROPOUT_MICRO, TRAIN_SEQ))
    data = [{"input_ids": batch[i % DROPOUT_MICRO]} for i in range(DROPOUT_STEPS * DROPOUT_MICRO)]
    half = DROPOUT_STEPS // 2
    root = tempfile.mkdtemp(prefix="ds-dropout-")
    runs = {}

    def engine(seed, training_data, **kw):
        cfg = gpt2_train_cfg(dropout=DROPOUT, **kw)
        model = dataclasses.replace(gpt2_model(cfg),
                                    init_fn=lambda _, dev: init_params(cfg, seed, dev))
        return dst.initialize(model=model, config=train_config(DROPOUT_MICRO),
                              training_data=training_data, device=device)[0]

    def run(label, e, first, last, save_at=None):
        """Steps ``first``..``last``; no flash launch (the counts kept in
        ``runs``); returns (losses, s)."""
        op_builder.reset_launch_counts()
        torch.cuda.synchronize()
        t0, spent, losses = time.perf_counter(), 0.0, []
        for step in range(first, last + 1):
            losses.append(e.train_batch())
            if step == save_at:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                e.save_checkpoint(root, tag="mid")
                spent += time.perf_counter() - t1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - spent
        launches = op_builder.launch_counts()
        if launches != expect():
            raise AssertionError(f"[dropout] {label}: launches {nonzero(launches)}, expected none")
        runs[label] = launches
        return [float(x) for x in losses], dt

    def masters(e):
        return {k: p.detach().to("cpu", copy=True) for k, p in e.state.params.items()}

    out = {}
    try:
        a = engine(SEED, data)
        losses_a, _ = run("A", a, 1, DROPOUT_STEPS, save_at=half)
        want = masters(a)
        del a
        print(f"[dropout] A: losses {losses_a[0]:.6f} -> {losses_a[-1]:.6f} over "
              f"{DROPOUT_STEPS} steps (tag saved after step {half}); no flash launch",
              flush=True)
        if not all(np.isfinite(losses_a)) or not losses_a[-1] < losses_a[0]:
            raise AssertionError(f"[dropout] losses not finite and falling: {losses_a}")
        torch.cuda.reset_peak_memory_stats()
        a2 = engine(SEED, data)
        losses_a2, dt = run("A2", a2, 1, DROPOUT_STEPS)
        peak = torch.cuda.max_memory_allocated()
        step_ms = dt / DROPOUT_STEPS * 1e3
        tps = DROPOUT_MICRO * TRAIN_SEQ * DROPOUT_STEPS / dt
        print(f"[dropout] {smi}: step {step_ms:.2f} ms, {tps:.1f} tokens/s, peak memory "
              f"{peak / 2**30:.3f} GiB (micro-batch {DROPOUT_MICRO}, seq {TRAIN_SEQ}, "
              f"attention on the plain path)", flush=True)
        checks = {"A2 (same seed)": (losses_a2, masters(a2))}
        del a2
        r = engine(SEED, data, remat=True, remat_policy="full")
        losses_r, _ = run("R", r, 1, DROPOUT_STEPS)
        checks["R (remat full)"] = (losses_r, masters(r))
        del r
        b = engine(SEED + 1, data[half * DROPOUT_MICRO:])
        b.load_checkpoint(root, tag="mid")
        losses_b, _ = run("B", b, half + 1, DROPOUT_STEPS)
        checks["B (resumed)"] = ([*losses_a[:half], *losses_b], masters(b))
        del b
        for label, (losses, got) in checks.items():
            first, worst = first_difference(want, got)
            print(f"[dropout] {label} vs A: losses equal {losses == losses_a}, masters "
                  f"first difference {first} (max |diff| {worst:.3e})", flush=True)
            if losses != losses_a or first is not None:
                raise AssertionError(f"[dropout] {label} is not A bit for bit: losses "
                                     f"{losses} vs {losses_a}, first difference {first}")
        out.update(launches=runs, losses=losses_a, step_ms=step_ms, tokens_per_s=tps,
                   peak_memory_bytes=peak, first_loss=losses_a[0], last_loss=losses_a[-1])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def state_slice(state, names, device):
    """The optimizer state of the parameters ``names`` (every per-parameter
    dict sliced, every counter copied) on ``device``, as its own tuple."""
    fields = {}
    for field, value in state._asdict().items():
        if isinstance(value, dict):
            fields[field] = {k: value[k].detach().to(device, copy=True) for k in names}
        else:
            fields[field] = value.detach().to(device, copy=True)
    return type(state)(**fields)


def optim_update_vs_cpu(engine, ids, device, label: str) -> float:
    """One update of ``OPTIM_CHECK_NAMES`` on the card (copies of their masters
    and state, the gradients of one micro-batch of 4) against the same update
    on CPU copies: every element of the parameters and of every state tensor
    within 1e-6 + 1e-5 |cpu|. Returns the worst |diff| / limit."""
    import torch
    _, grads = grads_of(engine, {"input_ids": torch.from_numpy(ids[:4]).to(device)})
    lr = engine.get_lr_value()
    runs = []
    for where in (device, torch.device("cpu")):
        params = {k: engine.state.params[k].detach().to(where, copy=True)
                  for k in OPTIM_CHECK_NAMES}
        state = state_slice(engine.state.opt_state, OPTIM_CHECK_NAMES, where)
        engine.optimizer.update({k: grads[k].to(where) for k in OPTIM_CHECK_NAMES}, state,
                                params, lr)
        flat = {f"params.{k}": v for k, v in params.items()}
        for field, value in state._asdict().items():
            items = value.items() if isinstance(value, dict) else [("", value)]
            flat.update({f"{field}.{k}".rstrip("."): v for k, v in items})
        runs.append({k: v.to("cpu").double() for k, v in flat.items()})
    card, host = runs
    worst, where_worst = 0.0, None
    for name, cpu in host.items():
        ratio = float(((card[name] - cpu).abs() / (1e-6 + 1e-5 * cpu.abs())).max())
        if ratio > worst:
            worst, where_worst = ratio, name
    step = int(engine.state.opt_state.step)
    print(f"[{label}] one update at step {step + 1} of {len(OPTIM_CHECK_NAMES)} tensors "
          f"({len(host)} parameter and state tensors), card vs CPU: worst |diff| / "
          f"(1e-6 + 1e-5 |cpu|) {worst:.3e} ({where_worst})", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"[{label}] card vs CPU update: {where_worst} {worst}")
    return worst


def optim_overflow_keeps_state(device, name: str, extra: dict, ids, label: str) -> int:
    """An fp16 engine of the optimizer takes ``OPTIM_FP16_STEPS`` steps at a
    small loss scale, then one at a scale of 2^40 (an overflow): the step is
    skipped and every parameter and optimizer state tensor keeps its bits.
    Returns the number of tensors compared."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2_model

    config = train_config(OPTIM_MICRO, optimizer=name,
                          precision={"fp16": {"enabled": True, "initial_scale_power": 8}})
    config["optimizer"]["params"].update(extra)
    engine = dst.initialize(model=gpt2_model(gpt2_train_cfg()), config=config,
                            device=device)[0]
    batch = {"input_ids": ids}
    for _ in range(OPTIM_FP16_STEPS):
        engine.train_batch(batch)
    skipped = engine.skipped_steps
    scaler = engine.state.scaler
    engine.state = engine.state._replace(scaler=scaler._replace(
        cur_scale=torch.full_like(scaler.cur_scale, 2.0 ** 40)))
    before = host_tree(engine)
    engine.train_batch(batch)
    after = host_tree(engine)
    kept = [k for k in before if k.startswith(("params.", "opt_state."))]
    changed = [k for k in kept if not torch.equal(before[k], after[k])]
    print(f"[{label}] fp16 overflow step (loss scale 2^40 after {OPTIM_FP16_STEPS} steps, "
          f"{skipped} skipped before): skipped {engine.skipped_steps - skipped}, "
          f"{len(kept) - len(changed)} of {len(kept)} parameter and state tensors kept bit for "
          f"bit", flush=True)
    if engine.skipped_steps != skipped + 1 or changed:
        raise AssertionError(f"[{label}] overflow step: skipped "
                             f"{engine.skipped_steps - skipped}, changed {changed[:8]}")
    return len(kept)


def optim_path(device, smi: str) -> dict:
    """``[optim]``: ``[train]``'s GPT-2 125M at micro-batch ``OPTIM_MICRO``
    through ``train_run`` (``TRAIN_WARMUP`` + ``OPTIM_STEPS`` steps; K1, K3,
    K4 12 a step) with each of ``OPTIM_CASES`` (the 1-bit Adam and 1-bit LAMB
    at ``freeze_step`` 3, so the compressed stage runs); then one update on
    the card against CPU copies (:func:`optim_update_vs_cpu`) and an fp16
    overflow step (:func:`optim_overflow_keeps_state`)."""
    cfg = gpt2_train_cfg()
    n = cfg.n_layer
    out = {}
    for name, extra in OPTIM_CASES:
        label = f"optim {name}"
        config = train_config(OPTIM_MICRO, optimizer=name)
        config["optimizer"]["params"].update(extra)

        def check(engine, ids, name=name, extra=extra, label=label):
            return {"update_vs_cpu": optim_update_vs_cpu(engine, ids, device, label),
                    "overflow_tensors_kept": optim_overflow_keeps_state(device, name, extra,
                                                                        ids, label)}

        out[name] = train_run(device, smi, label, cfg,
                              {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}, check,
                              micro=OPTIM_MICRO, seq=TRAIN_SEQ, steps=OPTIM_STEPS,
                              config=config)
        gc.collect()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops import op_builder

    smi = nvidia_smi_line()
    print(f"[header] {smi}")
    print(f"[header] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = op_builder.build(k.source for k in op_builder.KERNELS.values())
    print(f"[build] {time.perf_counter() - t0:.1f} s wall; per source {built}", flush=True)

    rows = kernel_checks(device)
    main = main_path(device)
    print(f"[main] {smi}: TTFT {main['ttft_ms']:.3f} ms, TPOT {main['tpot_ms']:.4f} ms, "
          f"decode {main['decode_tokens_per_s']:.1f} tokens/s (batch 4, prompt {PROMPT}, "
          f"{main['new_tokens']} new)", flush=True)
    serve = serve_path(device, smi)
    gc.collect()
    config, requests = serve_setup(gpt2_125m())
    serve["int8"] = serve_int8(device, smi, gpt2_125m(), config, requests, serve)
    gc.collect()
    spec = spec_path(device, smi, serve)
    # a scheduler holds itself through its prefix cache's page hooks: collect
    # the serving phases' pools before training measures its peak memory
    gc.collect()
    train = train_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    remat = remat_path(device, smi, train)
    gc.collect()
    torch.cuda.empty_cache()
    offload = offload_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    param_offload = param_offload_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    sparse = sparse_path(device, smi, train["step_ms"])
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = ckpt_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lm_train = lm_train_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = moe_train_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    dropout = dropout_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    optim = optim_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    wq = wq_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_path(device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    hd = hd_path(device, smi)

    # each kernel's launches on its own main path (the one its first check case
    # is shaped by): generate for the forward and decode kernels, the
    # scheduler for the paged kernel, training for the backward kernels, the
    # int8 lane's 64-token generate for the dequant-GEMM, the MoE lane's
    # 64-token generate for the selected-expert FFN, block-sparse training for
    # the three block-sparse kernels; the forward's serving and
    # training launches, the dequant-GEMM's in the int8 scheduler run and the
    # selected-expert FFN's in the MoE scheduler and top-2 runs ride beside
    kernels = []
    hd_rows = rows.pop("hd")
    for name, res in rows.items():
        path = (train if name in kc.BWD_KERNELS else
                sparse if name in kc.BS_KERNELS else
                serve if name == "paged_decode_attention" else
                {"launches": wq["int8"]["generate_launches"]} if name == "quantized_matmul" else
                moe if name == "moe_decode_ffn" else
                main)
        entry = {"name": name, "route": "cuda", **kc.KERNEL_INFO[name],
                 "launches": path["launches"][name],
                 "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                 "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                 "bound_by": res["bound_by"], "library_ms": res["library_ms"]}
        if name == "flash_fwd":
            entry["serve_launches"] = serve["launches"][name]
            entry["train_launches"] = train["launches"][name]
        # [remat]: each of its engines' timed steps
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            entry["remat_launches"] = {run: res["launches"][name] for run, res in remat.items()}
            # [offload]: lane A's offload engine's timed steps (GPT-2 1.3B,
            # remat dots) and every lane B step
            entry["offload_launches"] = offload["lane_a"]["offload"]["launches"][name]
            entry["offload_lane_b_launches"] = offload["lane_b"]["launches"][name]
            # [param-offload]: lane A's 3 timed streamed steps (GPT-2 1.3B's
            # widths, 24 layers: the forward stream and the recompute run K1)
            entry["param_offload_launches"] = param_offload["lane_a"]["launches"][name]
        # [param-offload]: the trained masters served (K1, K2)
        if name in ("flash_fwd", "decode_attention"):
            entry["param_offload_serve_launches"] = \
                param_offload["lane_a"]["serve_launches"][name]
        # [ckpt]: every training step of its engines (K1, K3, K4) and its
        # served generates and forwards (K1, K2), in this process
        if name in ("flash_fwd", "decode_attention", "flash_bwd_dq", "flash_bwd_dkv"):
            entry["ckpt_launches"] = ckpt["launches"][name]
        # [lm-train], [moe-train], [optim]: each run's timed steps; [dropout]:
        # every step of each run, none (attention dropout runs the plain
        # attention); [moe-train]'s served generate (K1, K2, K7)
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            entry["lm_train_launches"] = {run: res["launches"][name]
                                          for run, res in lm_train.items()}
            entry["moe_train_launches"] = moe_train["launches"][name]
            entry["optim_launches"] = {run: res["launches"][name] for run, res in optim.items()}
            entry["dropout_launches"] = {run: counts[name]
                                         for run, counts in dropout["launches"].items()}
        if name in ("flash_fwd", "decode_attention", "moe_decode_ffn"):
            entry["moe_train_serve_launches"] = moe_train["serve_launches"][name]
        # [spec]: the n-gram lane's target (K1; K5 none), the draft-model
        # lane's draft engine (K2), the int8 lane's verify rounds (K6)
        if name in ("flash_fwd", "paged_decode_attention"):
            entry["spec_launches"] = spec["ngram"]["launches"][name]
        if name == "decode_attention":
            entry["spec_draft_launches"] = spec["draft"]["launches"][name]
        if "dense_decode_ms" in res:
            entry["dense_decode_ms"] = res["dense_decode_ms"]
        if name == "quantized_matmul":
            entry["serve_int8_launches"] = serve["int8"]["launches"][name]
            entry["spec_int8_launches"] = spec["int8"]["launches"][name]
        if name == "moe_decode_ffn":
            entry.update(serve_launches=moe["serve"]["launches"][name],
                         top2_launches=moe["top2_launches"][name],
                         gather_ms=res["gather_ms"], block_f_ms=res["block_f_ms"])
        # the kernel at [hd]'s head dims, beside its main path
        if name in hd_rows:
            entry["hd"] = [{"case": case.name, "launches": hd_launches(hd, case),
                            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
                           for case, r in hd_rows[name]]
        kernels.append(entry)
    print(json.dumps({"main_path": {
        k: main[k] for k in ("ttft_ms", "tpot_ms", "decode_tokens_per_s",
                             "prefill_logit_err", "token_agreement")},
        "serve_path": {k: v for k, v in serve.items()
                       if k not in ("launches", "int8", "tokens")},
        "serve_int8": {k: v for k, v in serve["int8"].items() if k != "launches"},
        "spec_path": {lane: ({k: v for k, v in res.items() if k != "launches"}
                             if isinstance(res, dict) else res) for lane, res in spec.items()},
        "wq_path": {name: {k: v for k, v in lane.items() if k != "generate_launches"}
                    for name, lane in wq.items()},
        "moe_path": {k: v for k, v in moe.items()
                     if k not in ("launches", "top2_launches", "int8_launches", "serve")},
        "moe_serve": {k: v for k, v in moe["serve"].items() if k != "launches"},
        "train_path": {k: train[k] for k in ("step_ms", "tokens_per_s", "mfu",
                                             "peak_memory_bytes", "first_loss", "last_loss",
                                             "grad_rel_err_max", "loss_err",
                                             "k1_k4_traced_ms", "k3_traced_ms")
                       if k in train},
        "remat_path": {run: {k: v for k, v in res.items() if k != "launches"}
                       for run, res in remat.items()},
        "offload_path": {"lane_a": {run: {k: v for k, v in res.items() if k != "launches"}
                                    for run, res in offload["lane_a"].items()},
                         "lane_b": {k: v for k, v in offload["lane_b"].items()
                                    if k != "launches"},
                         "seconds": offload["seconds"]},
        "param_offload_path": {
            "lane_a": {k: v for k, v in param_offload["lane_a"].items()
                       if k not in ("launches", "serve_launches")},
            **{lane: {k: v for k, v in param_offload[lane].items() if k != "launches"}
               for lane in ("lane_a2", "lane_b")},
            "seconds": param_offload["seconds"]},
        "sparse_train_path": {k: v for k, v in sparse.items()
                              if k not in ("launches", "trace", "losses")},
        "ckpt_path": {k: v for k, v in ckpt.items() if k != "launches"},
        "lm_train_path": {run: {k: v for k, v in res.items() if k not in ("launches", "losses")}
                          for run, res in lm_train.items()},
        "moe_train_path": {k: v for k, v in moe_train.items()
                           if k not in ("launches", "losses", "serve_launches")},
        "dropout_path": {k: v for k, v in dropout.items() if k not in ("losses", "launches")},
        "optim_path": {run: {k: v for k, v in res.items() if k not in ("launches", "losses")}
                       for run, res in optim.items()},
        "hd_path": {
            "refusals": hd["refusals"],
            **{f"{m}_{part}": {k: v for k, v in hd[m][part].items()
                               if k not in ("launches", "int8", "tokens")}
               for m in ("gpt2_2.7b", "gptj_6b") for part in ("generate", "serve")},
            **{m: {k: v for k, v in hd[m].items() if k not in ("launches", "trace", "losses")}
               for m in ("gpt2_760m_train", "gpt2_760m_sparse")}}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ckpt-child"]:
        sys.exit(ckpt_child(sys.argv[2:]))
    sys.exit(main())
