#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA GPU, the
CUDA toolkit (nvcc) and PyTorch built for CUDA; it imports nothing of JAX
and nothing of the JAX package ``repro``.  Phases:

  1. the card's name and power limit; build every kernel from the
     checkout's sources (one nvcc per library, all started together: the
     kernels, K4b's planted-fault variant, and an empty kernel for the
     launch floor; K5 and its planted-fault variant too); K1 and K2 must
     compile with
     no stack frame (K1's register array stays in registers); K3 must
     compile with no spills; K4 must be the warp-specialised Hopper
     kernel: its ptxas report shows no spills and no ignored
     ``setmaxnreg`` (C7508), and its SASS (``cuobjdump -sass``) holds
     HGMMA and UTMALDG instructions; K4b (K4's backward) the same: no
     spills, no C7508, no C7518 (a wgmma serialised under a branch), and
     HGMMA and UTMALDG in its SASS;
  2. K1 (matcher) against its plain PyTorch versions on the card, bit for
     bit, in both forms, the fused first-match stage (with a fifth of the
     lanes not valid) and the (N, C) form: built-in and random rule
     tables (up to 8 contexts, word indices past the frame) over
     wire-correct and random frames, N = 64 and N = 65,536;
  3. K2 (DDT gather) against its plain version on the card, bit for bit:
     int32, float32 with -0.0 and NaN payloads, uint8, bfloat16, float64;
     random maps and piecewise-contiguous ones (runs at aligned and
     unaligned starts), holes, indices past the source, odd lengths,
     sources and index maps one element off 16-byte alignment; sources
     up to 4 MiB;
  3a. K3 (checksum) against its plain version, bit for bit: 64 ICMP echo
     frames (which verify to 0); edge lengths (negative, 0,
     around start, around the MTU and past it, 2**31 - 1) at N = 1, 15,
     16, 17, 64, 4,099 and 65,543 for start 0, 34 and 35; a row slice of
     a larger buffer; 65,536 and 262,144 random frames of random (odd and
     even) lengths with non-zero bytes past each length;
  3b. K4 (flash attention) against its plain version on the card, each
     case printing its max abs error and its row error (see K4_ROW_TOL),
     and the row log-sum-exp it writes for K4b against the plain lse
     (LSE_ATOL; the output must not change when lse is asked for):
     gemma3-1b's prefill shape (causal, window 0 and 512), a qwen3-1.7b
     shape, ragged Sq = Sk = 1,000, non-causal with a ragged Sk, and
     D = 64 in float32.  At gemma3-1b's shape, planted faults (the kernel
     run so that the rows from Sq / 2 on miss their 64 newest keys, or
     with the window one key tile short or long) must fail the check;
  4. the main path: ``SpinNIC.step`` at the NIC's full geometry (512 KiB
     L2, 16 MPQ entries, batches of 64 frames) receiving 16 concurrent
     Fig 9 datatype messages (count 1024) over SLMP, for the complex and
     the simple datatype; host memory is checked against the MPI unpack
     oracle and the final state against the same stream run on the CPU;
     one ICMP echo batch; K1 launches once per step;
  5. ``SpinIngest`` on the card (vocab 32000, batch 8, seq 4096: a
     ~128 KiB message of ~89 frames), tokens checked against the corpus,
     K1 once and K2 once per call; the Fig 10 overlap loops with a
     float32 matmul sized to outlast the ingest (R is printed, and only
     checked to lie in [0, 1]);
  5a. the checksum path: ``internet_checksum_batch`` over 64 ICMP echo
     requests and over the NIC's 64 replies to them (both must sum to 0);
     K3 twice;
  5b. the serving path at gemma3-1b's full width (26 layers, d_model
     1,152, vocab 262,144, weights drawn on the card from a seed): batch
     4, a 2,048-token prompt from ``prefill_batch_specs`` (seed 0), 32
     greedy tokens, run twice.  K4 runs 26 times per prefill and never in
     decode; the tokens lie in the vocab and agree between the runs; K4's
     output on the prompt's own q/k/v at layers 0 (local) and 5 (global)
     agrees with the plain version, and the planted faults fail there
     too.  Prints prefill ms, decode ms/token
     and tokens/s;
  5e. the moe, ssm and hybrid families at their published widths
     (qwen2-moe-a2.7b: 24 layers, 60 routed experts padded to 64, top-4,
     4 shared; recurrentgemma-9b: 12 periods of (rglru, rglru, local)
     and 2 tail rglru layers, window 2,048, MQA at head_dim 256;
     mamba2-780m: 48 SSD mixers), weights drawn on the card from seed 0,
     each freed before the next: batch 4, 32 greedy tokens, a 2,048-token
     prompt (recurrentgemma-9b's 4,096, so that its window cuts and the
     local ring wraps), twice.  K4 runs once per attn/local layer of the
     prefill (24, 12, 0) and never in decode, K5 twice a ssm layer in each
     decode step and never in the prefill; the tokens lie in the vocab
     and agree between the runs.  K4 on qwen2-moe's layer 0 (global, D
     128, H = KV = 16) and recurrentgemma's layer 2 (local, D 256, H 16
     over KV 1) agrees with its plain version, and the planted faults
     fail there.  Then each arch in float32 at full width and 2 or 3
     layers, batch 1, a 64-token prompt and 4 decode steps, on the card
     and on the CPU from the same weights: the MoE layers must choose the
     same experts, and the logits agree within FAMILY_LOGIT_ATOL.
     Prints parameters, bytes, peak device memory, prefill ms, prompt
     tokens/s and decode ms/token.  Last the published Qwen1.5-MoE-A2.7B
     (PUBLISHED_MOE, the qwen2-moe serving cell's model: dropless, top-4
     weights as they are, the gated shared expert) the same way, with K6
     launched twice a layer in each prefill and each decode step (48 and
     48) and never for the other archs;
  5f. the encdec and vlm families the same way (whisper-tiny: 4 encoder
     layers over 1,500 stubbed frames and 4 decoder layers with
     cross-attention, d_model 384, a 224-token decoder prompt; qwen2-vl-2b:
     28 layers, d_model 1,536, 1,024 stubbed image embeddings and 1,024
     text tokens, M-RoPE), every input of ``prefill_batch_specs`` passed to
     the engine.  K4 runs 12 times a whisper prefill (4 encoder layers,
     non-causal over 1,536 keys after the reference's zero pad; 4 causal
     self-attentions; 4 cross-attentions with kv_len) and 28 a qwen2-vl
     prefill, never in decode, in the order ``k4_calls`` gives.  K4 on
     whisper's encoder layer 0, its cross layer 0 (also with the ragged
     encoder lengths RAGGED_ENC_LEN, where the planted faults "kv_len
     ignored" and "kv_len + 64" must fail) and qwen2-vl's layer 0 (with
     the causal planted fault) agrees with its plain version.  Then each in
     float32 at 2 layers (whisper: 2 encoder + 2 decoder at enc_seq 1,500
     with RAGGED_ENC_LEN; qwen2-vl with M-RoPE components that differ),
     batch 4, on the card and on the CPU: logits within FAMILY_LOGIT_ATOL,
     greedy tokens equal;
  5c. the fabric and MPI path (``repro_torch.net``, ``repro_torch.mpi``)
     with its link and NIC states on the card: a 64 KiB SLMP transfer
     between two nodes at bench_fabric.py's configuration (window 4, loss
     0 and 0.05), a 2-rank MPI rendezvous of the Fig 9 complex datatype
     at count 512 whose unpack runs on the receiving NIC (loss 0.02), and
     an 8-rank allreduce of 4 MiB of int64 per rank (Rabenseifner, loss
     0).  The transfers' ticks, retransmits and link counters must equal
     the same runs on the port's CPU and the JAX package's counts
     (JAX_* below); the buffers must equal the message, the numpy
     dataloop oracle and numpy's sum; the allreduce's rounds, messages,
     wire bytes and ticks must equal the JAX package's.  K1 must launch
     once per NIC step, and nodes whose link delivered nothing must skip
     the step.  Prints wall time, ms a tick, NIC steps a tick and host
     reads (synchronisations) a NIC step;
  5d. the training path at gemma3-1b's full width through the port's
     ``launch/train.py`` (--spin-ingest, batch 4, sequence 1,024, 8 steps,
     lr 3e-3 and the launcher's schedule, weights from seed 0): the losses
     must be finite, and K1 and K2 must launch once per ingest call, K4
     twice and K4b once per layer and step (see K4_PER_LAYER_STEP).  Every
     batch that the launcher's ``SpinIngest`` delivered must equal the
     corpus's.  K4 on a global and a local layer's own q/k/v from the run
     agrees with its plain version, and K4's planted faults fail there.
     K4b on those layers' own q/k/v/o/dO and the lse their forward saved,
     on qwen3-1.7b's GQA shape at head_dim 128 and in float32 agrees with
     its plain version (K4B_REL, K4B_ROW_TOL), and planted faults (key
     tile 1 or the last key tile dropped from the dK/dV loop, Delta left
     out, each row's lse read from the next row) fail that check on the
     two layers and in float32.  Then
     ``run_with_restarts`` with a failure planted before step 3 must resume
     from the step-2 checkpoint (gemma3-1b cut to 6 layers and vocab
     16,384; the checkpoints are deleted after).  Prints ms a step,
     tokens/s and the overlap ratio R, and per step the Python collector's
     time and the caching allocator's device allocations, frees and
     retries.  Last, train steps under remat "dots" (the config's) and
     "none" in turns, host issue time and step time;
  5g. training the families that fit one card at their published widths
     through ``train/trainer.Trainer`` on ``shapes.train_batch_specs``
     batches (whisper-tiny: 448 decoder tokens beside 1,500 frames;
     qwen2-vl-2b: 1,024 image and 1,024 text positions; mamba2-780m:
     2,048 tokens), batch 4, bf16, remat "dots", 6 steps on one fixed
     batch: the loss must fall, K4 must launch 20 / 56 / 0 times a step
     and K4b 12 / 28 / 0 (see TRAIN_FAMILIES); prints ms a step, tokens/s
     and peak device memory (phase 7 profiles one step of each, last of
     its profiles).  K4b on the
     step's own inputs of whisper's cross layer 0 (also at RAGGED_ENC_LEN,
     where planted fault 4, ``kv_len`` ignored in the dK/dV walk, must
     fail), its encoder layer 0 (1,500 queries, 1,536 keys) and
     qwen2-vl's layer 0 agrees with its plain version, with exact zeros
     in the dK and dV rows past ``kv_len``, and the planted faults fail.
     Then whisper (ragged ``enc_len``) and qwen2-vl (M-RoPE components
     apart) in float32 at 2 layers: the loss and every gradient on the
     card against the CPU (FAMILY_LOSS_REL, FAMILY_GRAD_REL);
  5h. (run last, after phase 7) ``train/manual_dp.build``'s
     step (the int8 error-feedback gradient mean of
     ``parallel/compression.py``) at gemma3-1b's full width on a
     one-device NCCL group, phase 5d's batch shape, 4 steps: the loss must
     fall, and on one step the int8 codes read back give the mean and
     err' = g + err - mean bit for bit for every leaf; ms a step in turns
     with the plain ``Trainer`` step;
  5i. (run after phase 7's first profiles, where the earlier phases'
     models are freed) the Trainer's mesh branch: gemma3-1b at full
     width through
     ``Trainer(mesh=launch.mesh.make_host_mesh())`` with FSDP on a
     one-rank NCCL (data 1, model 1) mesh (every parameter, moment and
     batch entry a DTensor), phase 5d's batch shape, 6 steps in turns
     with the plain ``Trainer`` from the same weights on the same batch:
     every loss within MESH_LOSS_REL of the plain step's, the loss must
     fall, K4 must launch 52 and K4b 26 times a step (as on the plain
     step: a fallback to the plain attention would count 0), and every
     parameter and moment must be a DTensor with the rules' placements;
     ms a step, tokens/s and peak memory of both in turns, and one
     profiled step of each (kernels, busy ms, idle share), beside the
     card's name and power limit.  K4's and K4b's entries of the
     ``kernels`` line carry the mesh steps' launches (``mesh_launches``);
  5j. (run last, after 5h: 5i's trainers are freed) the dry run on the
     card: ``python -m repro_torch.launch.dryrun`` in two subprocesses,
     into a temporary directory, for DRYRUN_CELLS (a fake process group
     of 256 or 512 ranks, fake CUDA tensors): each row must be ``ok``
     with nonzero FLOPs, bytes and collective bytes; its terms and state
     GB a device are printed.  Then the grounding at phase 5d's shape
     (gemma3-1b, 4 x 1,024, remat "dots", the plain ``Trainer``): one
     real step counted under ``launch.roofline.CountingMode`` and the
     same step built on fake CUDA tensors must count the same FLOPs and
     bytes, with K4 and K4b counted 52 and 26 times; the roofline's
     max(compute, memory) term must not exceed the median of
     GROUND_STEPS timed steps (a floor above the time means a count is
     wrong); the terms, the time and the model-FLOPs share of the peak
     are printed beside the card's name and power limit;
  6. kernel timings on the card (CUDA events, median of 25 runs of 20
     back-to-back calls queued behind a GPU spin, so that the events see
     device time only; the host's cost to issue a call is printed beside
     it), the least time the card could take (bytes moved over
     3.35 TB/s, or operations over the bf16 tensor-core peak for K4), the
     plain version's time and, as a yardstick, ``torch.take``'s time for
     K2 and ``scaled_dot_product_attention``'s for K4 (the port never
     calls either); K4's entry of the ``kernels`` line holds the global
     layer's numbers and, as ``local_*``, the local layer's.  Beside
     them: the launch floor (an empty kernel); the matching stage as
     ``match_batch`` runs it (one launch) against the earlier stage (the
     (N, C) kernel and seven PyTorch ops), device and host time, with K1's
     bound counted in selected words and in 32-byte sectors; K2's vector
     body against its scalar body (the earlier kernel), at the ingest's
     one gather against its earlier two, on a Fig 9 complex map whose
     message is about 4 MiB and on a 4 MiB permutation; K3 through the
     wrapper and through the earlier wrapper in turns (new, earlier,
     earlier, new) at the path's 64 ICMP requests and at 65,536 and
     262,144 random frames, device time and the host's cost to issue a
     call, against its bound in live bytes and in the 32-byte sectors the
     live ranges touch.  K1's entry also carries its launches on the
     fabric path (``fabric_launches``).  K4b on phase 5d's own inputs of a
     global and a local layer against its plain version and SDPA's
     backward, with its bound (10 D operations per live pair over the
     bf16 peak), its TFLOP/s and its kernels one by one under the profiler;
     K4 on the serving path's layers with and without the lse output, on
     phase 5e's two layers (``family_shapes``, with their launches) and on
     phase 5f's calls (``modal_shapes``: whisper's encoder, its cross
     layer at the path's and the ragged enc_len, SDPA with a boolean mask
     there, and qwen2-vl's layer 0); K4b the same way on phase 5g's held
     calls (``train_shapes``, with its launches on the three train
     paths); K5 (mamba2's SSD decode mixer) at the serve cell's layer
     (batch 16, bfloat16) against its plain version over 4 steps, each of
     its planted faults failing that check, then timed beside its bytes
     bound and the plain version (``phase_k5``); K6 (the grouped expert
     kernel of dropless MoE) at qwen2-moe-a2.7b's decode (16 rows) and
     prefill (32,768 rows) shapes against its plain version, bit for bit
     twice, its planted faults failing, then timed beside its bound
     (decode: four layers' experts in turn) and the plain version
     (``phase_k6``);
     K1, K2 and K4 carry their launches on the training path
     (``train_launches``);
  7. one ``match_batch`` (must be one kernel), the earlier matching stage,
     one ``SpinIngest`` call, one NIC step, one serving prefill, one
     decode step, one tick of the 8-rank allreduce (restored from a
     checkpoint taken mid-run in 5c) and one gemma3-1b train step under
     torch.profiler: kernels per
     call, device busy time, the idle share it implies and the kernels
     with the most device time; for the train step also K4's and K4b's
     device time and share of the busy time, the host's time in CUDA
     runtime calls and in aten operators (self time), and the operators
     with the most of it.  Last, each of phase 5e's and 5f's archs drawn
     again at full width: one prefill and one decode step under the
     profiler.

Any failed check raises, so the script exits nonzero; it also exits
nonzero, printing no result, when CUDA is unavailable.  The last two lines
of standard output are the ``kernels`` JSON object and the result JSON.
"""
from __future__ import annotations

import itertools
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12             # non-tensor-core float32 peak, same sheet
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak, same sheet
FIG10_MSGS = 16                    # paper: 16 concurrent messages
FIG10_COUNT = 1024                 # Fig 9 datatypes at count 1024
NIC_BATCH = 64                     # SpinNIC default batch
SERVE_ARCH = "gemma3-1b"           # the serving CLI's default --arch
SERVE_BATCH = 4
SERVE_PROMPT = 2048
SERVE_GEN = 32
# K4 against its plain version, two limits that both must hold.  K4_ATOL,
# on the max abs error: bf16 is the limit the JAX package holds its own
# kernel to.  K4_ROW_TOL, on the row error (``ref.row_error``: a row's
# largest error over that row's RMS), is the one that sees a fault: a row
# that averages n keys has |o| ~ n**-0.5, about 0.06 at n = 2,048, so an
# absolute limit of 0.06 is as large as the values it compares.  A sound
# bf16 kernel differs by output rounding (one bf16 step, 2**-8 to 2**-7
# of a value of up to ~4 RMS) and by rounding P to bf16 before P.V, as
# the TPU kernel does: a few hundredths.  A kernel missing one key tile
# of 64 reads 1 or more (the planted faults below).  float32: exp and
# the sums over up to 2,048 keys run in another order.
K4_ATOL = {"bfloat16": 0.06, "float32": 1e-4}
K4_ROW_TOL = {"bfloat16": 0.1, "float32": 1e-4}
# K4's lse against the plain lse, max abs error over the rows with a live
# key (a row with none must be +inf in both): float32 sums of up to 2,048
# exponentials in another order, and in bfloat16 the special-function
# unit's exp2 and log2 (relative error about 2**-22), on values up to ~10:
# a few 1e-6.
LSE_ATOL = 1e-4
# Phase 5c.  SLMP transfer at benchmarks/bench_fabric.py's configuration
# (64 KiB message, batch 32, 1,024-byte payloads, timeout 12, latency 2,
# jitter 2, seed 11) at window 4; the MPI rendezvous of
# benchmarks/bench_mpi.py's overlap sweep (2 ranks, Fig 9 complex datatype
# at count 512, loss 0.02, latency 2, jitter 2, seed 7); its 8-rank
# allreduce at 4 MiB of int64 per rank (latency 1, loss 0, seed 31).
# Counts are logical fabric ticks, which do not depend on the platform.
# The JAX_* values are what the JAX package of this repository (repro.net,
# repro.mpi) gives for the same calls, read once on a CPU.
# BENCH_fabric.json, older than that code, records 101 ticks at loss 0
# and 124 at loss 0.05; BENCH_mpi.json records the allreduce's numbers.
FABRIC_WINDOW = 4
JAX_SLMP = {
    0.0: dict(ticks=100, retransmits=0, sent_frames=64, links=[
        (64, 0, 0, 0, 0, 64, 0), (64, 0, 0, 0, 0, 64, 0)]),
    0.05: dict(ticks=120, retransmits=7, sent_frames=71, links=[
        (70, 6, 0, 0, 0, 64, 0), (71, 1, 0, 0, 0, 70, 0)]),
}
JAX_RDV = dict(ticks=41, retransmits=[1, 0], links=[
    (64, 1, 0, 0, 0, 63, 0), (64, 0, 0, 0, 0, 64, 0)])
ALLREDUCE_RANKS = 8
ALLREDUCE_BYTES = 4 << 20
JAX_ALLREDUCE = dict(algorithm="allreduce_rab", rounds=6, msgs_total=896,
                     bytes_wire=58_720_256, ticks=468)
# Phase 5d.  Training at gemma3-1b's full width through the port's
# launch/train.py with --spin-ingest and the launcher's defaults for lr
# (3e-3) and schedule: batch 4, sequence 1,024 (4,096 tokens a step).  The
# spin-ingest loop takes its first batch before the loop, so TRAIN_FEEDS
# ingest calls feed TRAIN_FEEDS - 1 steps.  Under remat "dots" every layer
# launches K4 twice a step (its forward, and the recompute of the block
# before the backward: attention's output is not one of the saved matrix
# products) and K4b once.
TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_FEEDS = 9
K4_PER_LAYER_STEP = 2
K4B_PER_LAYER_STEP = 1
# the restart check: gemma3-1b cut to one period (6 layers) and a vocab of
# 16,384, so that a checkpoint of params and moments is about 1.8 GB
RESTART_LAYERS = 6
RESTART_VOCAB = 16384
# the caching allocator's counters printed per train step
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")
# K4b against its plain version: each of dq, dk, dv within a max abs error
# of K4B_REL times its largest |value| and a row error (``ref.row_error``
# with each row's RMS floored at K4B_ROW_FLOOR times the tensor's: a row of
# dQ can be 0 but for rounding, as query 0's is) of K4B_ROW_TOL.  bfloat16's
# floor is low, so that the small dK/dV rows of the last key tiles, which
# few queries see, are judged by their own RMS.  float32's limit is so
# tight that such a row dropped reads far beyond it at a floor of 1, while
# a lower floor would count the rounding noise of dQ's row 0 (~1e-5 of the
# tensor's RMS) as a fault.  A sound bfloat16 kernel
# differs by the rounding of its outputs (2**-8 of a value of up to ~4 RMS),
# by holding P and dS in its products as bfloat16 pairs (about 16 bits; one
# bfloat16, as PR 13's kernel held them, cost up to 0.2 of a row's RMS on
# whisper-tiny's cross layer in training, whose dS cancels over the keys)
# and by float32 sums in another order: a few hundredths.  A key tile dropped from the dK/dV
# loop leaves whole rows at 0 (row error 1 or more), and Delta left out
# moves every dS.  For bfloat16 the plain version runs in float64: on
# whisper-tiny's cross layer in training the float32 plain version is
# itself 0.097 of a row's RMS floor off the exact gradients, at the dK row
# of a batch row with one live key, which is 0 in exact arithmetic (and in
# the kernel, whose Delta is the same tensor-core sum as dP).
K4B_REL = {"bfloat16": 2e-2, "float32": 1e-5}
# K4b's planted faults, as ``ops.flash_attention_bwd_planted`` takes them
K4B_FAULTS = {
    "tile 1": (1, 1, "key tile 1 dropped from the dK/dV loop"),
    "last tile": (1, -1, "the last key tile dropped from the dK/dV loop"),
    "Delta": (2, 0, "Delta left out of dS"),
    "lse": (3, 0, "each row's lse read from the next row"),
    "kv_len": (4, 0, "kv_len ignored in the dK/dV walk"),
}
K4B_FAULTS_NO_KV_LEN = ("tile 1", "last tile", "Delta", "lse")
K4B_ROW_TOL = {"bfloat16": 0.1, "float32": 1e-4}
K4B_ROW_FLOOR = {"bfloat16": 0.05, "float32": 1.0}
# Phase 5e.  The moe, ssm and hybrid families served at their published
# widths through the same engine as 5b (batch SERVE_BATCH, SERVE_GEN
# greedy tokens, twice): per arch the prompt length, the layer whose
# q/k/v K4 is held (and timed, phase 6) on, and the depth of the float32
# card-against-CPU check.  recurrentgemma-9b's prompt is 4,096 so that
# its window of 2,048 cuts in the prefill and the local ring wraps.
FAMILIES = (  # arch, prompt, K4 layer, layers of the float32 check
    ("qwen2-moe-a2.7b", 2048, 0, 2),
    ("recurrentgemma-9b", 4096, 2, 3),
    ("mamba2-780m", 2048, None, 2),
)
# The published Qwen1.5-MoE-A2.7B, as the qwen2-moe serving cell runs it
# (bench/configs/qwen2-moe-a2.7b.json), served after FAMILIES through the
# same engine: the registry's qwen2-moe-a2.7b with q/k/v biases, one shared
# expert of 5,632 under its sigmoid gate, the top-4 weights kept as they
# are and no capacity (dropless: K6, two launches, once a MoE layer in a
# prefill and in each decode step).
PUBLISHED_MOE = ("qwen2-moe-a2.7b", 2048, dict(
    qkv_bias=True, n_shared_experts=1, d_ff_shared=5632,
    router_aux_coef=0.001, moe_dropless=True, moe_norm_topk=False,
    moe_shared_gate=True, remat="none"))
# The float32 check: batch 1, a 64-token prompt, 4 teacher-forced decode
# steps, weights drawn on the card and copied to the CPU.  Logits (standard
# deviation about 1) within FAMILY_LOGIT_ATOL: float32 sums in other
# orders (cuBLAS against the CPU's GEMMs, K4's float32 kernel against the
# plain softmax) through 2-3 layers at full width.
FAMILY_CHECK_PROMPT = 64
FAMILY_CHECK_STEPS = 4
FAMILY_LOGIT_ATOL = 1e-3
# Phase 5f.  The encdec and vlm families served at their published widths
# through the same engine (batch SERVE_BATCH, SERVE_GEN greedy tokens,
# twice): per arch the whole prompt and the K4 calls of a prefill whose
# q/k/v are held (and timed, phase 6), by their index in the prefill's
# calls.  whisper-tiny's prompt is 224 decoder tokens (its decoder context
# is 448; openai/whisper conditions on at most n_text_ctx // 2 - 1 previous
# tokens) beside 1,500 encoder frames; qwen2-vl-2b's 1,024 image and 1,024
# text tokens.  whisper's prefill calls K4 12 times: its 4 encoder layers
# (non-causal, 1,536 keys after the zero pad), then per decoder layer the
# causal self-attention and the cross-attention (kv_len).
MODAL_FAMILIES = (  # arch, prompt, {held call: its index in the prefill}
    ("whisper-tiny", 224, {"encoder layer 0": 0, "cross layer 0": 5}),
    ("qwen2-vl-2b", 2048, {"layer 0": 0}),
)
# whisper's cross layer is also held with ragged encoder lengths, and the
# float32 check runs with them: every key live, some keys cut in and past a
# 64-key tile, one key
RAGGED_ENC_LEN = (1500, 1200, 700, 1)
# Phase 5g.  The families that fit one card trained at their published
# widths through train/trainer.Trainer (mesh=None), not launch/train.py
# (both launchers feed only tokens and targets, ROADMAP.md §3), on
# batches from shapes.train_batch_specs (as the reference's dry-run builds
# them): batch TRAIN_BATCH, bf16, weights from seed 0, each config's own
# remat ("dots"), AdamW at the launcher's default lr (3e-3),
# TRAIN_FAMILY_STEPS steps on one fixed batch, which is memorised, so the
# loss falls.  whisper-tiny trains on 448 decoder tokens (its text
# context) beside 1,500 encoder frames; qwen2-vl-2b on 1,024 image and
# 1,024 text positions.  K4 runs once per attention call in the forward
# and again in the recompute of each checkpointed block, K4b once per
# call.  whisper calls attention 12 times a forward (4 encoder layers, 4
# decoder self-attentions, 4 cross-attentions), but its encoder's blocks
# are not checkpointed (the reference's _encode runs outside its remat),
# so K4 runs 12 + 8 = 20 times a step, not 24; qwen2-vl 28 + 28; mamba2
# has no attention.
# K4b is held on the named calls' own inputs with the planted faults given.
# The lse fault (each row's lse read from the next row) is left out on
# whisper's layers: with its stub frames at this initialisation their
# scores are flat, and consecutive rows' lse can be equal to the last bit
# (the cross layer's were: the fault changed no output).
TRAIN_FAMILIES = (  # arch, sequence, K4 a step, K4b a step, {held: faults}
    ("whisper-tiny", 448, 20, 12,
     {"cross layer 0": ("tile 1", "last tile", "Delta"),
      "encoder layer 0": ("tile 1", "last tile", "Delta")}),
    ("qwen2-vl-2b", 2048, 56, 28, {"layer 0": K4B_FAULTS_NO_KV_LEN}),
    ("mamba2-780m", 2048, 0, 0, {}),
)
TRAIN_FAMILY_STEPS = 6
# the float32 check at 2 layers and full width (whisper with
# RAGGED_ENC_LEN, qwen2-vl with M-RoPE components apart): loss within
# FAMILY_LOSS_REL relative, every gradient within FAMILY_GRAD_REL of its
# leaf's largest |value| (float32 sums in other orders: cuBLAS against the
# CPU's GEMMs, K4's and K4b's float32 kernels against the plain softmax)
FAMILY_LOSS_REL = 1e-5
FAMILY_GRAD_REL = 1e-4
# Phase 5h.  train/manual_dp.build's step (the int8 error-feedback mean)
# on a one-device NCCL group at phase 5d's width and batch: MANUAL_DP_STEPS
# steps, then steps in turns with phase 5d's plain Trainer step
MANUAL_DP_STEPS = 4
# Phase 5i.  The Trainer's mesh branch: gemma3-1b at phase 5d's width and
# batch through Trainer(mesh=make_host_mesh(), fsdp=True) on a one-rank
# NCCL (data 1, model 1) mesh, MESH_STEPS steps in turns with the plain
# Trainer from the same weights on the same batch; each step's loss
# within MESH_LOSS_REL relative of the plain step's (bfloat16: the same
# kernels, but the vocabulary's log-sum-exp and the gradient reductions
# in another order); K4 and K4b launched as on the plain step
# (K4_PER_LAYER_STEP, K4B_PER_LAYER_STEP a layer)
MESH_STEPS = 6
MESH_LOSS_REL = 2e-3
# phase 5j: the dry run's cells on the card (arch, shape, mesh), and the
# timed steps of the grounding step
DRYRUN_CELLS = (("gemma3-1b", "train_4k", "pod"),
                ("qwen2-moe-a2.7b", "decode_32k", "multipod"))
DRYRUN_TIMEOUT = 300
GROUND_STEPS = 5


def log(*a):
    print(*a, flush=True)


def bits(t):
    import torch
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


SLEEP_CYCLES = 100_000_000      # GPU spin queued ahead of timed calls
SLEEP_S = SLEEP_CYCLES / 1.98e9    # its least duration (H100 max SM clock)


def time_ms(fn, runs=25, per_run=20):
    """Time ``fn`` on the card.  Returns ``(device_ms, host_ms)`` per call.

    device_ms: median over ``runs`` of (end - start) / ``per_run``, CUDA
    events around ``per_run`` back-to-back calls.  A GPU spin queued first
    holds the events back until the host has queued every call, so the
    events bracket device work only, not the host's launch cost.
    host_ms: median host time to issue one call (the wrapper's cost).
    A run whose issuing took most of the spin (the queue could have run
    dry, and its device time would include host time) is discarded and
    taken again; raises after a third such run.
    """
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev, host, discarded = [], [], 0
    while len(dev) < runs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        ts = time.perf_counter()
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(per_run):
            fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        if t1 - ts > 0.8 * SLEEP_S:
            discarded += 1
            if discarded == 3:
                raise AssertionError("timing: issuing the calls outlasted "
                                     "the GPU spin in 3 runs")
            continue
        dev.append(a.elapsed_time(b) / per_run)
        host.append((t1 - t0) * 1e3 / per_run)
    return statistics.median(dev), statistics.median(host)


# ------------------------------------------------------------------ inputs
def wire_frames(n, seed):
    import numpy as np
    from repro_torch.core import packet as pkt
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(min(n, 256)):
        pay = rng.integers(0, 256, int(rng.integers(0, 200))).astype(np.uint8)
        frames.append([pkt.make_icmp_echo(pay, seq=i),
                       pkt.make_udp(pay, dport=9999),
                       pkt.make_slmp(i, 0, pkt.SLMP_FLAG_EOM, pay),
                       pkt.make_slmp(i, 1484, 0, pay, dport=9331),
                       pkt.make_udp(pay, dport=53)][i % 5])
    return np.resize(pkt.stack_frames_np(frames)[0], (n, pkt.MTU))


def rule_tables(seed):
    import numpy as np
    from repro_torch.core import matching as m
    from repro_torch.core import packet as pkt
    rs = [m.ruleset_icmp_echo(), m.ruleset_udp_pingpong(9999),
          m.ruleset_slmp(9330), m.ruleset_slmp(9331), m.ruleset_none()]
    yield "builtin", np.stack([r.as_array() for r in rs]), \
        np.array([r.mode for r in rs], np.int32)
    rng = np.random.default_rng(seed)
    rules = np.zeros((6, 4, 4), np.uint32)
    rules[..., 0] = rng.integers(0, pkt.WORDS, (6, 4))
    rules[..., 1] = rng.choice(np.array([0xFF, 0xFF00, 0xFFFF0000,
                                         0xFFFFFFFF, 0], np.uint32), (6, 4))
    rules[..., 2] = rng.integers(0, 2**31, (6, 4))
    rules[..., 3] = rules[..., 2] + rng.integers(0, 2**31, (6, 4))
    yield "random", rules, rng.integers(0, 2, 6).astype(np.int32)
    # 8 contexts, word indices up to W + 7 (clipped to W - 1), the
    # built-in ICMP and SLMP contexts at 1 and 2
    rules = np.zeros((8, 4, 4), np.uint32)
    rules[..., 0] = rng.integers(0, pkt.WORDS + 8, (8, 4))
    rules[..., 1] = rng.choice(np.array([0xFF, 0xFF00, 0xFFFF0000,
                                         0xFFFFFFFF, 0], np.uint32), (8, 4))
    rules[..., 2] = rng.integers(0, 2**31, (8, 4))
    rules[..., 3] = rules[..., 2] + rng.integers(0, 2**31, (8, 4))
    modes = rng.integers(0, 2, 8).astype(np.int32)
    for k, r in ((1, rs[0]), (2, rs[3])):
        rules[k], modes[k] = r.as_array(), r.mode
    yield "random8", rules, modes


def runs_map(s, i, rng):
    """A piecewise-contiguous index map of length ``i`` into a source of
    ``s`` elements, as a committed datatype gives: runs of 1-63
    consecutive indices from random (aligned or unaligned) starts, some of
    them holes (-1) or indices past the source; runs may cross S."""
    import numpy as np
    lens = rng.integers(1, 64, i // 16 + 2)
    starts = rng.integers(0, s, len(lens))
    kind = np.repeat(rng.random(len(lens)), lens)
    offs = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
    idx = np.repeat(starts, lens) + offs
    idx = np.where(kind < 0.05, -1, np.where(kind < 0.08, s + 5, idx))
    return np.resize(idx, i).astype(np.int32)


def offset_copy(t, offset):
    """``t`` copied into a card buffer ``offset`` elements in: a view that
    is not 16-byte aligned when ``offset`` is not a multiple of 16 bytes."""
    import torch
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:]
    view.copy_(t)
    return view


# An empty kernel, built beside the port's own, whose time in the timing
# harness is the launch floor.
EMPTY_CU = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int repro_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


# ------------------------------------------------------------------ phases
def phase_build():
    """Build every kernel and the empty one.  Returns the empty kernel's
    launcher, ``fn(blocks, threads, stream)``."""
    import ctypes
    import re
    import subprocess
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "empty_probe.cu"
    src.write_text(EMPTY_CU)
    lib = build.BUILD_DIR / "libempty_probe.so"
    probe = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                              str(lib), str(src)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    build.build_all()
    out, _ = probe.communicate()
    if probe.returncode:
        raise AssertionError(f"nvcc failed for the empty kernel:\n{out}")
    log(f"[1] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({len(build.SOURCES)} libraries and an empty kernel, parallel "
        f"nvcc)")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                log(f"[1]   {name}: {line.strip()}")
    for name in ("matcher", "ddt"):
        frames = [int(n) for n in re.findall(r"(\d+) bytes stack frame",
                                             build.build_logs[name])]
        if not frames or any(frames):
            raise AssertionError(f"{name}: ptxas reports stack frames "
                                 f"{frames} (arrays left registers)")
        log(f"[1] {name}: SASS instructions per kernel "
            f"{sass_sizes(build, name)}")
    check_k3_build(build)
    check_k4_build(build)
    check_k4b_build(build)
    empty = ctypes.CDLL(str(lib)).repro_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int
    return empty


def sass_sizes(build, name):
    """{kernel: SASS instruction count} of kernel library ``name``: at the
    sizes K1-K3 run, a kernel's time grows with its code."""
    import re
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled = fn.split("\n", 1)[0].strip()
        short = re.search(r"(\d+)([a-z_]+kernel)(I[^E]*E)?", mangled)
        key = short.group(2) + (short.group(3) or "") if short else mangled
        out[key] = len(re.findall(r"/\*[0-9a-f]{4}\*/", fn))
    return out


def check_k3_build(build):
    """K3 must compile with no spills.  Prints its registers, shared
    memory and spills, and its SASS size."""
    import re
    text = build.build_logs.get("checksum")
    if text is None:
        raise AssertionError("K3: no ptxas report (delete src/repro_torch/"
                             "kernels/_build and run again)")
    part = text.split("Compiling entry function")[1:]
    if len(part) != 1 or "checksum_kernel" not in part[0]:
        raise AssertionError(f"K3: ptxas reports {len(part)} kernels")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill "
                                         r"(?:stores|loads)", part[0])]
    regs = re.search(r"Used (\d+) registers", part[0])
    smem = re.search(r"(\d+) bytes smem", part[0])
    log(f"[1] K3 ptxas: {regs.group(1) if regs else '?'} registers, "
        f"{smem.group(1) if smem else 0} B static shared memory, spill "
        f"bytes {spills}; SASS instructions per kernel "
        f"{sass_sizes(build, 'checksum')}")
    if not spills or any(spills):
        raise AssertionError(f"K3: ptxas reports spills {spills}")


def check_k4_build(build):
    """K4 must be the warp-specialised Hopper kernel: ptxas reports no
    spills and does not ignore ``setmaxnreg`` (warning C7508), and its SASS
    holds warpgroup MMAs (HGMMA) and TMA loads (UTMALDG)."""
    import re
    import shutil
    import subprocess
    from repro_torch.kernels.flash_attention import ops as k4
    text = build.build_logs.get("flash_attention")
    if text is None:
        raise AssertionError("K4: no ptxas report (the library was built "
                             "without one; delete src/repro_torch/kernels/"
                             "_build and run again)")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                         text)]
    if not spills or any(spills):
        raise AssertionError(f"K4: ptxas reports spills {spills}")
    if "C7508" in text or "setmaxnreg ignored" in text:
        raise AssertionError("K4: ptxas ignored setmaxnreg (C7508)")
    regs = re.findall(r"Used (\d+) registers", text)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._lib_path(
        "flash_attention"))], capture_output=True, text=True,
        check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS")}
    setmax = sorted({" ".join(m.split()) for m in re.findall(
        r"USETMAXREG[^;]*", sass)})
    log(f"[1] K4 ptxas: registers at entry per kernel {regs}, spill bytes "
        f"{sum(spills)}, no C7508; dynamic shared memory per bf16 block "
        f"{ {d: k4.smem_bytes(d) for d in k4.HEAD_DIMS} } B; SASS: {counts}"
        f", register moves {setmax}")
    if not (counts["HGMMA"] and counts["UTMALDG"]):
        raise AssertionError(f"K4: no HGMMA or UTMALDG in the SASS {counts}")


def check_k4b_build(build):
    """K4b must be warp-specialised Hopper kernels too: 15 kernels (dQ and
    dK/dV for 3 head_dims x 2 dtypes, and the bfloat16 partial-sum
    reduction for 3 head_dims) with no spills (the dQ, dK and dV sums live in registers),
    no ignored ``setmaxnreg`` (C7508), no wgmma serialised (C7518), and
    HGMMA and UTMALDG instructions in the SASS."""
    import re
    import shutil
    import subprocess
    text = build.build_logs.get("flash_attention_bwd")
    if text is None:
        raise AssertionError("K4b: no ptxas report (delete src/repro_torch/"
                             "kernels/_build and run again)")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill "
                                         r"(?:stores|loads)", text)]
    regs = re.findall(r"Used (\d+) registers", text)
    for code in ("C7508", "C7518"):
        if code in text:
            raise AssertionError(f"K4b: ptxas warns {code}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._lib_path(
        "flash_attention_bwd"))], capture_output=True, text=True,
        check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "UTMALDG", "UBLKCP", "SYNCS")}
    log(f"[1] K4b ptxas: {len(regs)} kernels, registers at entry {regs}, "
        f"spill bytes {sum(spills)}, no C7508 or C7518; SASS: {counts}")
    if len(regs) != 15 or not spills or any(spills):
        raise AssertionError(f"K4b: ptxas reports {len(regs)} kernels, "
                             f"spills {spills}")
    if not (counts["HGMMA"] and counts["UTMALDG"]):
        raise AssertionError(f"K4b: no HGMMA or UTMALDG in the SASS {counts}")


def phase_k1(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.matcher import ops, ref
    for n in (64, 65536):
        valid = torch.as_tensor(np.random.default_rng(n).random(n) < 0.8,
                                device=dev)
        for kind in ("wire", "random"):
            data = wire_frames(n, n) if kind == "wire" else \
                np.random.default_rng(n).integers(0, 256, (n, 1536)
                                                  ).astype(np.uint8)
            d = torch.as_tensor(data, device=dev)
            for tname, rules, modes in rule_tables(n):
                r = torch.as_tensor(rules.astype(np.int64), device=dev)
                m = torch.as_tensor(modes, device=dev)
                got = ops.match(d, r, m)
                want = ref.match_ref(d, r, m)
                first = ops.match_first(d, r, m, valid)
                want_first = ref.match_first_ref(d, r, m, valid)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"K1 mismatch n={n} {kind} {tname}")
                if not (torch.equal(first[0], want_first[0])
                        and torch.equal(first[1], want_first[1])):
                    raise AssertionError(f"K1 first-match mismatch n={n} "
                                         f"{kind} {tname}")
                won = torch.bincount(first[0] + 1, minlength=r.shape[0] + 1)
                log(f"[2] K1 n={n} frames={kind} rules={tname} "
                    f"(C={r.shape[0]}): (N, C) form and first-match form "
                    f"bit-exact (matched {int(got[0].sum())}, eom "
                    f"{int(got[1].sum())}; lanes per winner, none first: "
                    f"{won.tolist()}, eom {int(first[1].sum())})")


def phase_k2(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.ddt import ops, ref
    rng = np.random.default_rng(7)
    cases = [  # dtype, S, I, map, src offset, idx offset (elements)
        ("int32", 1 << 20, 1 << 20, "random", 0, 0),
        ("float32", 1 << 20, 3 << 19, "random", 0, 0),
        ("uint8", 1 << 22, 1 << 21, "random", 0, 0),
        ("float32", 1000, 77777, "random", 0, 0),
        ("int32", 1, 10, "random", 0, 0),
        ("int32", 1 << 20, (1 << 20) + 3, "runs", 0, 0),    # odd I
        ("float32", 1 << 20, 777777, "runs", 1, 0),         # src unaligned
        ("float32", 1 << 20, 777777, "runs", 0, 1),         # idx unaligned
        ("uint8", 1 << 22, (1 << 21) + 5, "runs", 0, 0),
        ("uint8", 1 << 22, 99999, "runs", 3, 3),
        ("bfloat16", 1 << 20, 123457, "runs", 0, 0),
        ("float64", 1 << 19, 99999, "runs", 0, 0),
        ("float64", 1 << 19, 99999, "random", 1, 2),
        ("int32", 4099, 4099, "identity", 0, 0),            # one long run
    ]
    for dtype, s, i, kind, so, io in cases:
        if dtype in ("float32", "float64", "bfloat16"):
            npt = np.float64 if dtype == "float64" else np.float32
            src = torch.as_tensor(rng.normal(size=s).astype(npt)).to(
                getattr(torch, dtype))
            src[::5] = -0.0
            src[1::7] = float("nan")
            if dtype == "float32":                  # NaN payloads
                src.view(torch.int32)[1::7] = 0x7FC01234
            fill = -0.0
        elif dtype == "int32":
            src = torch.as_tensor(rng.integers(-2**31, 2**31, s).astype(
                np.int32))
            fill = -7
        else:
            src = torch.as_tensor(rng.integers(0, 256, s).astype(np.uint8))
            fill = 0xAB
        if kind == "random":
            idx = rng.integers(-1, s + s // 50 + 2, i).astype(np.int32)
        elif kind == "runs":
            idx = runs_map(s, i, rng)
        else:
            idx = np.arange(i, dtype=np.int32)
        ts = offset_copy(src.to(dev), so)
        ti = offset_copy(torch.as_tensor(idx, device=dev), io)
        got = ops.gather(ts, ti, fill=fill)
        want = ref.ddt_gather_ref(ts, ti, fill)
        torch.cuda.synchronize()
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"K2 mismatch {dtype} S={s} I={i} {kind} "
                                 f"offsets {so}, {io}")
        body = "vector" if (ti.data_ptr() | got.data_ptr()) % 16 == 0 \
            else "scalar"
        log(f"[3] K2 {dtype} S={s} ({s * src.element_size()} B) I={i} "
            f"{kind} map, src/idx {so}/{io} elements off ({body} body): "
            f"bit-exact (holes {int((idx < 0).sum())}, idx>=S "
            f"{int((idx >= s).sum())})")


def k3_random(dev, n, seed, start=34):
    """N random frames on the card: bytes in [1, 255] (so the byte after an
    odd length counts), lengths uniform in [0, 1536], the edge lengths
    (negative, 0, start - 1 .. start + 1, around the MTU and past it,
    2**31 - 1) first."""
    import torch
    from repro_torch.core import packet as pkt
    g = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randint(1, 256, (n, pkt.MTU), dtype=torch.uint8,
                         device=dev, generator=g)
    lengths = torch.randint(0, pkt.MTU + 1, (n,), dtype=torch.int32,
                            device=dev, generator=g)
    edge = [-7, -1, 0, start - 1, start, start + 1, pkt.MTU - 1, pkt.MTU,
            pkt.MTU + 7, 2**31 - 1][:n]
    lengths[:len(edge)] = torch.tensor(edge, dtype=torch.int32)
    return data, lengths


def k3_check(tag, d, ln, start):
    """K3 against the plain version, bit for bit.  Returns the checksums."""
    import torch
    from repro_torch.kernels.checksum import ops, ref
    want = ref.checksum_ref(d, ln, start)
    got = ops.internet_checksum(d, ln, start=start)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K3 mismatch at {tag} start={start}: "
                             f"{int((got != want).sum())} checksums")
    return want


def phase_k3(dev):
    import numpy as np
    import torch
    from repro_torch.core import packet as pkt
    rng = np.random.default_rng(3)
    icmp = pkt.stack_frames_np([pkt.make_icmp_echo(rng.integers(
        0, 256, int(rng.integers(0, 1400))).astype(np.uint8), seq=i)
        for i in range(64)])[:2]
    d, ln = (torch.as_tensor(x, device=dev) for x in icmp)
    if bool(k3_check("icmp", d, ln, pkt.L4_BASE).any()):
        raise AssertionError("K3: an ICMP echo request does not verify")
    log(f"[3a] K3 icmp N=64 start={pkt.L4_BASE}: bit-exact, all verify to 0 "
        f"({int((ln % 2).sum())} odd lengths)")
    # edge lengths at N around the kernel's 8-packet block and beyond, for
    # even and odd starts
    for start in (0, 34, 35):
        for n in (1, 15, 16, 17, 64, 4099, 65543):
            k3_check(f"N={n}", *k3_random(dev, n, n + start, start), start)
    log("[3a] K3 edge lengths (-7, -1, 0, start-1..start+1, 1535, 1536, "
        "1543, 2**31-1), N in {1, 15, 16, 17, 64, 4099, 65543}, start in "
        "{0, 34, 35}: bit-exact")
    # a row slice of a larger buffer: the data pointer 5 rows in
    d, ln = k3_random(dev, 3000, 1)
    k3_check("row slice", d[5:2905], ln[5:2905], 34)
    log("[3a] K3 a row slice (2,900 frames from row 5 of 3,000): bit-exact")
    for n in (65536, 262144):
        d, ln = k3_random(dev, n, n)
        got = k3_check(f"N={n}", d, ln, pkt.L4_BASE)
        log(f"[3a] K3 random N={n} start={pkt.L4_BASE}: bit-exact "
            f"({int((ln % 2).sum())} odd lengths, {int((got == 0).sum())} "
            f"zero sums)")


def k4_inputs(dev, b, sq, sk, h, kv, d, dtype, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, sq, h, d), device=dev, generator=g).to(dtype),
            torch.randn((b, sk, kv, d), device=dev, generator=g).to(dtype),
            torch.randn((b, sk, kv, d), device=dev, generator=g).to(dtype))


def k4_errors(got, want):
    """(max abs error, row error, whether both are within the limits)."""
    from repro_torch.kernels.flash_attention import ref
    err = (got.float() - want.float()).abs().max().item()
    row = ref.row_error(got, want)
    dt = str(want.dtype).split(".")[-1]
    return err, row, err <= K4_ATOL[dt] and row <= K4_ROW_TOL[dt]


def k4_check(tag, q, k, v, causal, window, kv_len=None):
    """K4 against its plain version on the same card tensors, and the lse
    it writes when asked (the training path's forward) against the plain
    lse.  Returns (max abs error, row error, the plain output); raises
    beyond K4_ATOL, K4_ROW_TOL or LSE_ATOL, or when asking for lse changes
    the output."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    got = ops.flash_attention(q, k, v, **kw)
    got2, lse = ops.flash_attention_with_lse(q, k, v, **kw)
    want, want_lse = ref.flash_attention_ref(q, k, v, **kw,
                                             return_lse=True)
    torch.cuda.synchronize()
    err, row, ok = k4_errors(got, want)
    live = torch.isfinite(want_lse)
    lse_err = ((lse[live] - want_lse[live]).abs().max().item()
               if live.any() else 0.0)
    dt = str(q.dtype).split(".")[-1]
    lens = "" if kv_len is None else f" kv_len={kv_len.tolist()}"
    log(f"{tag} q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype} causal="
        f"{causal} window={window}{lens}: max abs err {err:.3e} (limit "
        f"{K4_ATOL[dt]}), row error {row:.3e} (limit {K4_ROW_TOL[dt]}); "
        f"lse max abs err {lse_err:.3e} (limit {LSE_ATOL}), "
        f"{int((~live).sum())} rows with no live key")
    if not ok:
        raise AssertionError(f"K4 errors {err}, {row} beyond the limits")
    if not (lse_err <= LSE_ATOL and torch.equal(torch.isinf(lse), ~live)
            and torch.equal(got, got2)):
        raise AssertionError(f"K4 lse error {lse_err}, or the output "
                             f"changes with lse")
    return err, row, want


def k4_planted_faults(tag, q, k, v, window, want):
    """Run K4 so that it computes a wrong function near the right one and
    hold it to the plain version's ``want`` (causal, ``window``) with the
    check of ``k4_check``: every fault must fail it.  Global (window 0):
    the queries shifted by one key tile, so each row misses its 64 newest
    keys, held to the plain version only in the rows from Sq / 2 on, where
    each row averages 1,000 keys or more and its values are smallest.
    Local: the window one key tile short and one long."""
    from repro_torch.kernels.flash_attention import ops
    if window:
        faults = [(f"window {window - 64}", ops.flash_attention(
                      q, k, v, causal=True, window=window - 64), want),
                  (f"window {window + 64}", ops.flash_attention(
                      q, k, v, causal=True, window=window + 64), want)]
    else:
        half = q.shape[1] // 2
        faults = [(f"rows from {half} on miss their 64 newest keys",
                   ops.flash_attention(q[:, 64:], k, v, causal=True,
                                       window=0)[:, half - 64:],
                   want[:, half:])]
    for name, got, ref_out in faults:
        err, row, ok = k4_errors(got, ref_out)
        log(f"{tag} planted fault ({name}): max abs err {err:.3e}, row "
            f"error {row:.3e}: {'PASSES' if ok else 'fails'} the check")
        if ok:
            raise AssertionError(f"K4 check passes a planted fault: {name}")


def k4_kv_len_faults(tag, q, k, v, kv_len, want):
    """K4 with its key length planted wrong, held to the plain version's
    ``want`` (non-causal, ``kv_len``) with the check of ``k4_check``:
    ``kv_len`` ignored, and ``kv_len`` + 64 (at most Sk) must both fail."""
    from repro_torch.kernels.flash_attention import ops
    faults = [("kv_len ignored", ops.flash_attention(q, k, v, causal=False)),
              ("kv_len + 64", ops.flash_attention(
                  q, k, v, causal=False,
                  kv_len=(kv_len + 64).clamp(max=k.shape[1])))]
    for name, got in faults:
        err, row, ok = k4_errors(got, want)
        log(f"{tag} planted fault ({name}): max abs err {err:.3e}, row "
            f"error {row:.3e}: {'PASSES' if ok else 'fails'} the check")
        if ok:
            raise AssertionError(f"K4 check passes a planted fault: {name}")


def phase_k4(dev):
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # B, Sq, Sk, H, KV, D, dtype, causal, window
        (4, 2048, 2048, 4, 1, 256, bf, True, 0),      # gemma3-1b global
        (4, 2048, 2048, 4, 1, 256, bf, True, 512),    # gemma3-1b local
        (2, 2048, 2048, 16, 8, 128, bf, True, 0),     # qwen3-1.7b
        (2, 1000, 1000, 8, 2, 128, bf, True, 0),      # ragged
        (2, 512, 1000, 4, 4, 128, bf, False, 0),      # non-causal, ragged Sk
        (2, 777, 777, 4, 2, 64, f32, True, 100),      # float32, D 64
    ]
    for i, (b, sq, sk, h, kv, d, dt, causal, window) in enumerate(cases):
        q, k, v = k4_inputs(dev, b, sq, sk, h, kv, d, dt, seed=i)
        _, _, want = k4_check("[3b] K4", q, k, v, causal, window)
        if i < 2:                            # gemma3-1b's two layer kinds
            k4_planted_faults("[3b] K4", q, k, v, window, want)


def fig10_stream(kind, dev, seed=0):
    """16 messages of the Fig 9 datatype, interleaved one frame per
    message, through SpinNIC.step at full geometry.  Returns (nic, state,
    committed, msgs, egress rows per step, seconds per step)."""
    import numpy as np
    import torch
    from repro_torch.core import apps, ddt, packet as pkt, slmp, spin_nic
    base = ddt.complex_ddt() if kind == "complex" else ddt.simple_ddt()
    c = ddt.commit(base, count=FIG10_COUNT)
    rng = np.random.default_rng(seed)
    msgs = [ddt.pack_np(c, rng.integers(0, 256, c.mem_bytes
                                        ).astype(np.uint8))
            for _ in range(FIG10_MSGS)]
    cfg = slmp.SlmpSenderConfig(window=1, port=9331)
    lists = [slmp.segment_message(m, i, cfg) for i, m in enumerate(msgs)]
    frames = [f for grp in zip(*lists) for f in grp]
    ctx = apps.make_ddt_context(c, msgs_in_flight=FIG10_MSGS, device=dev)
    nic = spin_nic.SpinNIC([ctx], host_bytes=FIG10_MSGS * c.mem_bytes,
                           batch=NIC_BATCH, device=dev)
    st = nic.init_state()
    batches = [pkt.stack_frames_np(frames[k:k + NIC_BATCH], n=NIC_BATCH)
               for k in range(0, len(frames), NIC_BATCH)]
    egress, secs = [], []
    for b in batches:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, eg, _ = nic.step(st, pkt.PacketBatch.from_numpy(*b, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        egress.append(eg.numpy())
    return nic, st, c, msgs, egress, secs, len(frames)


def profile_step(step_fn, host=False):
    """One call of ``step_fn`` under torch.profiler.  Returns (device
    kernels, device busy us as the union of kernel intervals, wall us on
    the host clock, the three commonest kernel names, the three kernel
    names with the most device time and their us).  The profiler slows
    the host, so the idle share it implies is an upper estimate.  With
    ``host``, also logs the host's self time in CUDA runtime calls and in
    aten operators, and the operators with the most of it."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur:
        busy += cur[1] - cur[0]
    names = collections.Counter(e.name for e in evs).most_common(3)
    dev_us = collections.Counter()
    for e in evs:
        dev_us[e.name] += e.time_range.end - e.time_range.start
    if host:
        for kernel, parts in (("K4", ("flash_fwd_bf16",)),
                              ("K4b", ("dq_wgmma_kernel", "dkv_wgmma_kernel",
                                       "dkv_reduce_kernel"))):
            us = sum(t for n, t in dev_us.items()
                     if any(p in n for p in parts))
            log(f"[7]   {kernel} device time {us / 1e3:.3f} ms, "
                f"{us / busy * 100:.2f} % of the busy time")
        avg = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CPU]
        runtime = sorted((e for e in avg if e.key.startswith("cuda")),
                         key=lambda e: -e.count)
        ops = sorted((e for e in avg if e.key.startswith("aten::")),
                     key=lambda e: -e.self_cpu_time_total)
        log(f"[7]   host, self time: CUDA runtime calls "
            f"{sum(e.self_cpu_time_total for e in runtime) / 1e3:.3f} ms "
            f"({sum(e.count for e in runtime)} calls, most "
            f"{[(e.key, e.count) for e in runtime[:3]]}); aten operators "
            f"{sum(e.self_cpu_time_total for e in ops) / 1e3:.3f} ms "
            f"({sum(e.count for e in ops)} calls) of {wall / 1e3:.3f} ms "
            f"wall; most: {[(e.key, e.count, round(e.self_cpu_time_total / 1e3, 3)) for e in ops[:6]]}")
    return len(spans), busy, wall, names, dev_us.most_common(3)


def phase_main_path(dev):
    import numpy as np
    import torch
    from repro_torch.core import apps, ddt, packet as pkt, slmp, spin_nic
    from repro_torch.kernels.matcher import ops as k1
    steps_total = 0
    for kind in ("complex", "simple"):
        before = k1.launches
        nic, st, c, msgs, egress, secs, nframes = fig10_stream(kind, dev)
        steps = len(secs)
        if k1.launches - before != steps:
            raise AssertionError(f"K1 ran {k1.launches - before} times in "
                                 f"{steps} steps")
        steps_total += steps
        if kind == "complex":
            # kept to profile one more step at the end of the run
            replay = (nic, st.clone(), pkt.stack_frames(
                [f for grp in zip(*[slmp.segment_message(
                    m, i, slmp.SlmpSenderConfig(window=1, port=9331))
                    for i, m in enumerate(msgs)]) for f in grp][:NIC_BATCH],
                n=NIC_BATCH, device=dev))
        for i, m in enumerate(msgs):
            want = ddt.unpack_np(c, m, np.zeros(c.mem_bytes, np.uint8))
            got = nic.read_host(st, (i % FIG10_MSGS) * c.mem_bytes,
                                c.mem_bytes)
            if not np.array_equal(got, want):
                raise AssertionError(f"{kind}: host region {i} != unpack")
        acks = sum(len(slmp.parse_acks(e)) for e in egress)
        if acks != nframes:
            raise AssertionError(f"{kind}: {acks} ACKs for {nframes} frames")
        done, st = nic.pop_counters(st, slmp.COMPLETION_QUEUE)
        if sorted(done.tolist()) != list(range(FIG10_MSGS)):
            raise AssertionError(f"{kind}: completions {done.tolist()}")
        if int(st.dropped) or int(st.mpq.evictions):
            raise AssertionError(f"{kind}: drops or MPQ evictions")
        # the same stream on the CPU must end in a bitwise-equal state
        cnic, cst, *_, cegress, _, _ = fig10_stream(kind, torch.device("cpu"))
        _, cst = cnic.pop_counters(cst, slmp.COMPLETION_QUEUE)
        gd, cd = st.to_numpy(), cst.to_numpy()
        for key in cd:
            if not np.array_equal(gd[key], cd[key]):
                raise AssertionError(f"{kind}: CUDA/CPU state differs: {key}")
        for e1, e2 in zip(egress, cegress):
            for a, b in zip(e1, e2):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{kind}: CUDA/CPU egress differs")
        share = (len(secs) - 1) / len(secs)   # traffic after step 1
        log(f"[4] Fig10 {kind}: {FIG10_MSGS} msgs x {c.msg_bytes} B "
            f"({nframes} frames, {len(secs)} steps of {NIC_BATCH}): host "
            f"== unpack oracle, {acks} ACKs, CUDA state == CPU state; "
            f"step median {statistics.median(secs[1:]) * 1e3:.3f} ms, "
            f"first {secs[0] * 1e3:.1f} ms (host clock, synchronized); "
            f"{nframes * share / sum(secs[1:]):.0f} frames/s and "
            f"{FIG10_MSGS * c.msg_bytes * share / sum(secs[1:]) / 1e6:.2f} "
            f"MB/s of message after the first step")

    # one ICMP echo batch: the reply checksum must verify
    before = k1.launches
    nic = spin_nic.SpinNIC([apps.make_icmp_context(),
                            apps.make_udp_pingpong_context()],
                           batch=NIC_BATCH, device=dev)
    frames = [pkt.make_icmp_echo(np.arange(n, dtype=np.uint8) * 3, seq=n)
              for n in (1, 56, 63, 1000)]
    _, eg, _ = nic.step(nic.init_state(),
                        pkt.stack_frames(frames, n=NIC_BATCH, device=dev))
    data, length, valid = eg.numpy()
    if valid.sum() != len(frames):
        raise AssertionError("ICMP: missing replies")
    for f, ln in zip(data[valid], length[valid]):
        if f[pkt.ICMP_TYPE] != pkt.ICMP_ECHO_REPLY or \
                pkt.internet_checksum_np(f[pkt.L4_BASE:ln]) != 0:
            raise AssertionError("ICMP: bad reply")
    if k1.launches - before != 1:
        raise AssertionError("ICMP step did not launch K1 once")
    steps_total += 1
    log(f"[4] ICMP echo: {len(frames)} replies, checksums verify")
    return steps_total, replay


def phase_ingest(dev):
    """SpinIngest checks and the Fig 10 overlap loops.  Returns the
    ingest, one raw feed and the number of ingest calls made."""
    import numpy as np
    import torch
    from repro_torch.core import overlap
    from repro_torch.kernels.ddt import ops as k2
    from repro_torch.kernels.matcher import ops as k1
    from repro_torch.train import data as tdata
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = tdata.PacketizedPipeline(vocab=32000, batch=8, seq=4096)
    spin = tdata.SpinIngest(pipe, device=dev)
    calls = 0

    def ingest(raw):
        nonlocal calls
        calls += 1
        return spin(raw)

    feeds = [pipe.packets_for_step(i) for i in range(12)]
    m0, g0 = k1.launches, k2.launches
    for i in range(3):
        out = ingest(feeds[i])
        want = pipe.corpus.batch(i, pipe.batch, pipe.seq)
        if not (np.array_equal(out["tokens"].cpu().numpy(), want[:, :-1])
                and np.array_equal(out["targets"].cpu().numpy(),
                                   want[:, 1:])):
            raise AssertionError(f"SpinIngest tokens wrong at step {i}")
    if (k1.launches - m0, k2.launches - g0) != (3, 3):
        raise AssertionError(f"SpinIngest launches K1={k1.launches - m0} "
                             f"K2={k2.launches - g0} for 3 calls")
    log(f"[5] SpinIngest: message {pipe.msg_bytes} B in {pipe.n_packets} "
        f"frames -> tokens (8, 4096) == corpus; launches per call: K1 1, "
        f"K2 1")

    # size the compute to outlast the ingest (bench_ddt.py's method)
    t_ing = []
    for f in feeds[:5]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ingest(f)
        torch.cuda.synchronize()
        t_ing.append(time.perf_counter() - t0)
    t_ingest = statistics.median(t_ing)
    g = torch.Generator(device=dev).manual_seed(0)
    dim = 8192
    for cand in (512, 1024, 1536, 2048, 3072, 4096, 6144, 8192):
        a = torch.randn((cand, cand), device=dev, generator=g)
        a @ a
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a @ a
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= 1.2 * t_ingest:
            dim = cand
            break
    w = torch.randn((dim, dim), device=dev, generator=g)

    def compute(state, batch):
        return state @ w / dim

    s0 = torch.eye(dim, device=dev)
    _, seq = overlap.sequential_loop(ingest, compute, feeds, s0, device=dev)
    _, ovl = overlap.overlapped_loop(ingest, compute, feeds, s0, device=dev)
    for rep in (seq, ovl):
        if not 0.0 <= rep.overlap_ratio <= 1.0:
            raise AssertionError(f"R out of range: {rep.row()}")
    log(f"[5] ingest {t_ingest * 1e3:.3f} ms per call (host clock, incl. "
        f"H2D copy of the frames); compute: float32 matmul dim {dim}")
    log(f"[5] sequential: {seq.row()} wall={seq.wall_s * 1e3:.2f}ms")
    log(f"[5] overlapped: {ovl.row()} wall={ovl.wall_s * 1e3:.2f}ms")
    return spin, feeds[0], calls


def phase_checksum_path(dev):
    """``internet_checksum_batch`` over 64 ICMP echo requests and over the
    NIC's replies to them: a correct ICMP message sums to 0.  Returns the
    requests (the path's K3 input) and the number of batch calls."""
    import numpy as np
    import torch
    from repro_torch.core import apps, checksum, packet as pkt, spin_nic
    rng = np.random.default_rng(5)
    frames = [pkt.make_icmp_echo(rng.integers(0, 256, n).astype(np.uint8),
                                 seq=i)
              for i, n in enumerate(rng.integers(0, 1400, NIC_BATCH))]
    reqs = pkt.stack_frames(frames, n=NIC_BATCH, device=dev)
    sums = checksum.internet_checksum_batch(reqs.data, reqs.length,
                                            pkt.L4_BASE)
    nic = spin_nic.SpinNIC([apps.make_icmp_context()], batch=NIC_BATCH,
                           device=dev)
    _, eg, _ = nic.step(nic.init_state(), reqs)
    if int(eg.valid.sum()) != NIC_BATCH:
        raise AssertionError("checksum path: missing ICMP replies")
    # a receiver sees the frame's bytes only: zero what lies past length
    live = torch.arange(pkt.MTU, device=dev)[None, :] < eg.length[:, None]
    replies = torch.where(live, eg.data, 0).contiguous()
    reply_sums = checksum.internet_checksum_batch(replies, eg.length,
                                                  pkt.L4_BASE)
    if bool(sums.any()) or bool(reply_sums.any()):
        raise AssertionError("checksum path: a request or reply does not "
                             "verify")
    log(f"[5a] checksum path: {NIC_BATCH} ICMP echo requests "
        f"({int((reqs.length % 2).sum())} of odd length) and the NIC's "
        f"{NIC_BATCH} replies verify through internet_checksum_batch")
    return reqs, 2


def _link_tuples(stats):
    from repro_torch.net import link
    return [tuple(l[k] for k in link.COUNTERS) for l in stats]


def _assert_on(dev, fab):
    """The stacked link state and every NIC state live on ``dev``."""
    import dataclasses
    tensors = [getattr(fab._stack, f.name)
               for f in dataclasses.fields(fab._stack)]
    for node in fab.nodes:
        st = node.state
        tensors += [st.l2, st.host, st.msg_state, st.counters, st.expect,
                    st.alloc.small_fifo, st.mpq.key]
    bad = {str(t.device) for t in tensors if t.device.type != dev.type}
    if bad:
        raise AssertionError(f"fabric state on {bad}, not {dev}")


def _fabric_counts(fabs):
    """(NIC steps, host reads) over the fabrics' nodes and the fabrics."""
    steps = sum(n.steps for f in fabs for n in f.nodes)
    reads = sum(n.host_reads for f in fabs for n in f.nodes) + sum(
        f.host_reads for f in fabs)
    return steps, reads


def slmp_transfer(dev, loss):
    """One SLMP transfer on a two-node fabric; returns the run's counts."""
    import numpy as np
    from repro_torch.core import apps, packet as pkt, slmp
    from repro_torch.net import Fabric, LinkConfig, Node, SlmpSenderEngine
    msg = np.random.default_rng(0).integers(0, 256, 1 << 16).astype(np.uint8)
    cfg = slmp.SlmpSenderConfig(
        window=FABRIC_WINDOW, mtu_payload=1024, timeout=12, max_retries=64,
        src_mac=pkt.node_mac(0), dst_mac=pkt.node_mac(1))
    sender = SlmpSenderEngine(msg, msg_id=1, cfg=cfg)
    tx = Node("tx", pkt.node_mac(0), [apps.make_null_context()], batch=32,
              engines=[sender], device=dev)
    rx = Node("rx", pkt.node_mac(1), [slmp.make_slmp_context()], batch=32,
              host_bytes=1 << 17, device=dev)
    fab = Fabric([tx, rx], link_cfg=LinkConfig(loss=loss, latency=2,
                                               jitter=2),
                 seed=11, device=dev)
    _assert_on(dev, fab)
    t0 = time.perf_counter()
    ticks = fab.run(max_ticks=50_000)
    secs = time.perf_counter() - t0
    _assert_on(dev, fab)
    if not (sender.done and not sender.failed) or not np.array_equal(
            rx.read_host(0, len(msg)), msg):
        raise AssertionError(f"SLMP loss {loss} on {dev}: message not "
                             "delivered intact")
    return dict(ticks=ticks, retransmits=sender.sender.retransmits,
                sent_frames=sender.sender.sent_frames,
                links=_link_tuples(fab.link_stats()),
                stats=fab.stats()), secs, fab


def mpi_rendezvous(dev):
    """bench_mpi.py's overlap transfer: a typed rendezvous whose unpack
    runs on the receiving NIC.  Returns the counts and the buffer."""
    import numpy as np
    from repro_torch import mpi
    from repro_torch.core import ddt
    from repro_torch.net import LinkConfig
    reg = mpi.DatatypeRegistry()
    reg.register(ddt.simple_ddt(), count=1024, name="simple")
    cid = reg.register(ddt.complex_ddt(), count=512, name="complex")
    comm = mpi.Communicator(2, registry=reg, seed=0, device=dev)
    comm.rewire(link_cfg=LinkConfig(loss=0.02, latency=2, jitter=2), seed=7)
    _assert_on(dev, comm.fabric)
    c = reg.committed(cid)
    mem = np.random.default_rng(0).integers(0, 256, c.mem_bytes).astype(
        np.uint8)
    buf = np.zeros(c.mem_bytes, np.uint8)
    t0 = time.perf_counter()
    r = comm.irecv(1, buf, source=0, tag=1)
    s = comm.isend(0, 1, mem, tag=1, datatype=cid)
    comm.wait(r, s, max_ticks=200_000)
    secs = time.perf_counter() - t0
    oracle = ddt.unpack_np(c, ddt.pack_np(c, mem),
                           np.zeros(c.mem_bytes, np.uint8))
    if not np.array_equal(buf, oracle):
        raise AssertionError(f"rendezvous on {dev}: buffer != oracle")
    if comm.engines[0].stats["rdv_sent"] != 1:
        raise AssertionError("rendezvous: the message went eager")
    return dict(ticks=comm.now,
                retransmits=[e.stats["retransmits"] for e in comm.engines],
                links=_link_tuples(comm.link_stats())), buf, c, secs, comm


def phase_fabric(dev):
    """Phase 5c: the fabric and MPI path on the card, each run held to the
    same run on the port's CPU (where it is cheap) and to the JAX
    package's counts.  Returns the fabrics that ran on the card, the
    8-rank communicator, a checkpoint of it mid-allreduce (phase 7
    profiles the tick after it) and the wall time of the phase."""
    import numpy as np
    import torch
    from repro_torch import mpi
    from repro_torch.net import LinkConfig
    cpu = torch.device("cpu")
    fabs, t_phase = [], time.perf_counter()
    for loss in (0.0, 0.05):
        got, secs, fab = slmp_transfer(dev, loss)
        fabs.append(fab)
        want, _, _ = slmp_transfer(cpu, loss)
        if got != want:
            raise AssertionError(f"SLMP loss {loss}: card {got} != CPU "
                                 f"{want}")
        jax = JAX_SLMP[loss]
        if [got[k] for k in jax] != list(jax.values()):
            raise AssertionError(f"SLMP loss {loss}: {got} != the JAX "
                                 f"package's {jax}")
        steps, reads = _fabric_counts([fab])
        log(f"[5c] SLMP 64 KiB, window {FABRIC_WINDOW}, loss {loss}: "
            f"{got['ticks']} ticks, {got['retransmits']} retransmits, links "
            f"{got['links']} (= port CPU = JAX package); {secs:.3f} s, "
            f"{secs / got['ticks'] * 1e3:.3f} ms a tick, "
            f"{steps / got['ticks']:.3f} NIC steps a tick, "
            f"{reads / steps:.2f} host reads a NIC step")

    got, buf, c, secs, comm = mpi_rendezvous(dev)
    fabs.append(comm.fabric)
    want, cbuf, *_ = mpi_rendezvous(cpu)
    if got != want or not np.array_equal(buf, cbuf):
        raise AssertionError(f"rendezvous: card {got} != CPU {want}")
    if got != JAX_RDV:
        raise AssertionError(f"rendezvous: {got} != the JAX package's "
                             f"{JAX_RDV}")
    steps, reads = _fabric_counts([comm.fabric])
    log(f"[5c] MPI rendezvous, Fig 9 complex x 512 ({c.msg_bytes} B), "
        f"loss 0.02: buffer == oracle == port CPU; {got['ticks']} ticks, "
        f"retransmits {got['retransmits']} (= JAX package); {secs:.3f} s, "
        f"{secs / got['ticks'] * 1e3:.3f} ms a tick, "
        f"{steps / got['ticks']:.3f} NIC steps a tick, "
        f"{reads / steps:.2f} host reads a NIC step")

    cfg = mpi.MpiConfig(batch=32, slmp_window=64, mtu_payload=1408,
                        n_rdv_slots=8, coll_seg_bytes=128 << 10)
    comm = mpi.Communicator(ALLREDUCE_RANKS, seed=0, cfg=cfg,
                            link_cfg=LinkConfig(latency=1), device=dev)
    rng = np.random.default_rng(21)
    vals = [rng.integers(0, 1 << 20, ALLREDUCE_BYTES // 8).astype(np.int64)
            for _ in range(ALLREDUCE_RANKS)]
    ref = np.sum(np.stack(vals), axis=0)
    comm.rewire(link_cfg=LinkConfig(loss=0.0, latency=1), seed=31)
    _assert_on(dev, comm.fabric)
    t0 = time.perf_counter()
    h = mpi.iallreduce(comm, vals, algorithm="auto")
    mid = JAX_ALLREDUCE["ticks"] // 2
    comm.progress(mid)
    snap = comm.checkpoint()
    comm.wait(h, max_ticks=4_000_000)
    secs = time.perf_counter() - t0
    _assert_on(dev, comm.fabric)
    fabs.append(comm.fabric)
    if not all(np.array_equal(o, ref) for o in h.result):
        raise AssertionError("8-rank allreduce != numpy's sum")
    got = dict(algorithm=h.algorithm, rounds=h.rounds,
               msgs_total=h.msgs_total, bytes_wire=h.bytes_wire,
               ticks=comm.now)
    if got != JAX_ALLREDUCE:
        raise AssertionError(f"allreduce: {got} != the JAX package's "
                             f"{JAX_ALLREDUCE}")
    steps, reads = _fabric_counts([comm.fabric])
    log(f"[5c] allreduce, {ALLREDUCE_RANKS} ranks x 4 MiB int64, loss 0: "
        f"{h.algorithm}, == numpy's sum; rounds {h.rounds}, messages "
        f"{h.msgs_total}, {h.bytes_wire} bytes on the wire, {comm.now} "
        f"ticks (= JAX package); {secs:.3f} s with one checkpoint at tick "
        f"{mid}, {secs / comm.now * 1e3:.3f} ms a tick, "
        f"{steps / comm.now:.3f} NIC steps a tick, "
        f"{reads / steps:.2f} host reads a NIC step; stats "
        f"{ {k: v for k, v in comm.fabric.stats().items() if k != 'links'} }")
    return fabs, comm, snap, time.perf_counter() - t_phase


def phase_serve(dev):
    """The serving path at full width, twice.  Returns what phase 6 times
    K4 on: the prompt's q/k/v at layers 0 (local) and 5 (global)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = configs.get_config(SERVE_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_local = cfg.pattern_layers.count("local")
    log(f"[5b] {cfg.name}: {cfg.n_layers} layers ({n_local} local, window "
        f"{cfg.window}), d_model {cfg.d_model}, "
        f"H {cfg.n_heads}, KV {cfg.n_kv_heads}, head_dim {cfg.head_dim}, "
        f"vocab {cfg.vocab}: {n_params} parameters in {cfg.dtype} drawn on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    max_len = SERVE_PROMPT + SERVE_GEN + 8
    engine = ServeEngine(model, params, max_len=max_len)
    tokens = shapes.prefill_batch_specs(cfg, SERVE_PROMPT, SERVE_BATCH,
                                        rng=np.random.default_rng(0))
    batch = {"tokens": torch.as_tensor(tokens["tokens"], device=dev)}
    captured, outs = {}, []
    plain_call = k4.flash_attention
    for run in range(2):
        calls = []

        def recording(q, k, v, **kw):       # the layer's own K4 call
            out = plain_call(q, k, v, **kw)
            if len(calls) in (0, 5):
                captured[len(calls)] = (q, k, v, kw, out)
            calls.append(kw)
            return out

        if run == 1:
            k4.flash_attention = recording
        try:
            before = k4.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = engine.prefill(batch)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            n_pre = k4.launches - before
            t0 = time.perf_counter()
            toks, state = engine.generate(state, SERVE_GEN)
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
            n_dec = k4.launches - before - n_pre
        finally:
            k4.flash_attention = plain_call
        if (n_pre, n_dec) != (cfg.n_layers, 0):
            raise AssertionError(f"serve: K4 ran {n_pre} times in prefill "
                                 f"and {n_dec} in decode")
        toks = toks.cpu()
        if toks.shape != (SERVE_BATCH, SERVE_GEN) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"serve: bad tokens {toks.shape}")
        steps = SERVE_GEN - 1
        log(f"[5b] run {run}: prefill {t_pre * 1e3:.3f} ms "
            f"({SERVE_BATCH} x {SERVE_PROMPT} tokens, "
            f"{SERVE_BATCH * SERVE_PROMPT / t_pre:.0f} prompt tokens/s); "
            f"decode {t_dec / steps * 1e3:.3f} ms/token over {steps} steps "
            f"({SERVE_BATCH * steps / t_dec:.1f} tokens/s at batch "
            f"{SERVE_BATCH}); K4 launches {n_pre} in prefill, {n_dec} in "
            f"decode (host clock, synchronized)")
        outs.append(toks)
    launched = k4.launches                  # the path's; checks follow
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("serve: two runs gave different tokens")
    if [c["window"] for c in calls] != [
            cfg.window if kind == "local" else 0
            for kind in cfg.pattern_layers]:
        raise AssertionError("serve: K4 windows do not follow the pattern")
    errs = {}
    for layer, (q, k, v, kw, out) in sorted(captured.items()):
        kind = cfg.pattern_layers[layer]
        tag = f"[5b] K4 layer {layer} ({kind}), the prompt's q/k/v:"
        errs[layer], _, want = k4_check(tag, q, k, v, **kw)
        k4_planted_faults(tag, q, k, v, kw["window"], want)
        got = k4.flash_attention(q, k, v, **kw)
        if not torch.equal(got, out):
            raise AssertionError("serve: K4 is not deterministic")
    log(f"[5b] tokens[0][:8] = {outs[0][0, :8].tolist()}; two runs agree")
    return captured, errs, launched, (engine, batch)


def family_engine(dev, arch, prompt, overrides=None):
    """The full-width model of ``arch`` (its config with ``overrides``)
    with weights drawn on the card from seed 0, its engine and a prompt
    batch: every input that ``prefill_batch_specs`` draws (tokens, and
    encdec's ``enc_frames`` and ``enc_len`` or vlm's ``img_embeds`` and
    ``positions``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(configs.get_config(arch), **(overrides or {}))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             shapes.prefill_batch_specs(cfg, prompt, SERVE_BATCH,
                                        rng=np.random.default_rng(0)
                                        ).items()}
    return model, params, ServeEngine(model, params,
                                      max_len=prompt + SERVE_GEN + 8), batch


def k4_calls(model):
    """The K4 calls of one prefill of ``model``, in order, as (causal,
    window, with kv_len): the encoder's layers (encdec: non-causal), then
    per attn/local layer its self-attention and, for encdec, its
    cross-attention (non-causal, with kv_len)."""
    cfg = model.cfg
    encdec = cfg.family == "encdec"
    calls = [(False, 0, False)] * (cfg.enc_layers if encdec else 0)
    for kind in model.kinds:
        if kind in ("attn", "local"):
            calls.append((True, cfg.window if kind == "local" else 0, False))
            if encdec:
                calls.append((False, 0, True))
    return calls


def serve_family(dev, arch, prompt, capture, phase="5e", overrides=None):
    """Phase 5e or 5f for one arch at full width (its config with
    ``overrides``): serve twice, with K4, K5 and K6 counted per prefill and
    decode and K4's calls checked against ``k4_calls``; the K4 calls named
    in ``capture`` ({name: index in the prefill's calls}) held to the plain
    version on their own q/k/v.  Returns (K4 launches, {name: (q, k, v,
    kw)}, {name: K4's max abs error})."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.kernels.moe_experts import ops as k6
    from repro_torch.kernels.ssm_decode import ops as k5
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # what earlier phases hold
    t0 = time.perf_counter()
    model, params, engine, batch = family_engine(dev, arch, prompt,
                                                 overrides)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    n_attn = sum(kind in ("attn", "local") for kind in model.kinds)
    want_calls = k4_calls(model)
    if overrides:
        arch = f"{arch} (published: dropless {cfg.moe_dropless})"
    log(f"[{phase}] {arch} ({cfg.family}): {cfg.n_layers} layers "
        f"({n_attn} attn/local, kinds {sorted(set(model.kinds))}; encoder "
        f"layers {cfg.enc_layers if cfg.family == 'encdec' else 0}), "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}: {n_params} parameters, "
        f"{n_bytes} B in {cfg.dtype} (float32 leaves kept), drawn on the "
        f"card in {time.perf_counter() - t0:.2f} s; prompt batch "
        f"{ {k: tuple(v.shape) for k, v in batch.items()} }; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, of "
        f"which earlier phases hold {held} B")
    captured, outs, launched = {}, [], 0
    plain_call = k4.flash_attention
    for run in range(2):
        calls = []

        def recording(q, k, v, **kw):       # the layers' own K4 calls
            out = plain_call(q, k, v, **kw)
            for name, index in capture.items():
                if len(calls) == index:
                    captured[name] = (q, k, v, kw)
            calls.append(kw)
            return out

        if run == 1:
            k4.flash_attention = recording
        try:
            k4.launches = k5.launches = k6.launches = 0
            request = {k: t.clone() for k, t in batch.items()}  # as new
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = engine.prefill(request)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            n_pre, k5_pre, k6_pre = k4.launches, k5.launches, k6.launches
            t0 = time.perf_counter()
            toks, state = engine.generate(state, SERVE_GEN)
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
            n_dec, k5_dec = k4.launches - n_pre, k5.launches - k5_pre
            k6_dec = k6.launches - k6_pre
            launched += k4.launches
        finally:
            k4.flash_attention = plain_call
        if (n_pre, n_dec) != (len(want_calls), 0):
            raise AssertionError(f"{arch}: K4 ran {n_pre} times in prefill "
                                 f"and {n_dec} in decode, not "
                                 f"{len(want_calls)} and 0")
        # K5: twice a ssm layer in each decode step, never in the prefill
        want_k5 = 2 * (SERVE_GEN - 1) * model.kinds.count("ssm")
        if (k5_pre, k5_dec) != (0, want_k5):
            raise AssertionError(f"{arch}: K5 ran {k5_pre} times in prefill "
                                 f"and {k5_dec} in decode, not 0 and "
                                 f"{want_k5}")
        # K6: two launches a MoE layer in a prefill and in each decode step
        # of a dropless config, none otherwise
        n_moe = (cfg.n_layers - cfg.first_k_dense
                 if cfg.family == "moe" and cfg.moe_dropless else 0)
        want_k6 = (2 * n_moe, 2 * n_moe * (SERVE_GEN - 1))
        if (k6_pre, k6_dec) != want_k6:
            raise AssertionError(f"{arch}: K6 launched {k6_pre} times in "
                                 f"prefill and {k6_dec} in decode, not "
                                 f"{want_k6}")
        toks = toks.cpu()
        if toks.shape != (SERVE_BATCH, SERVE_GEN) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"{arch}: bad tokens {toks.shape}")
        steps = SERVE_GEN - 1
        peak = torch.cuda.max_memory_allocated()
        log(f"[{phase}] {arch} run {run}: prefill {t_pre * 1e3:.3f} ms "
            f"({SERVE_BATCH} x {prompt} tokens, "
            f"{SERVE_BATCH * prompt / t_pre:.0f} prompt tokens/s); decode "
            f"{t_dec / steps * 1e3:.3f} ms/token over {steps} steps "
            f"({SERVE_BATCH * steps / t_dec:.1f} tokens/s at batch "
            f"{SERVE_BATCH}); K5 launches {k5_dec} in decode; K6 launches "
            f"{k6_pre} in prefill, {k6_dec / steps:g} a decode step; K4 "
            f"launches {n_pre} in prefill, {n_dec} in "
            f"decode (host clock, synchronized); max_memory_allocated "
            f"{peak} B, {(peak - held) / 1e9:.2f} GB above what earlier "
            f"phases hold")
        outs.append(toks)
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{arch}: two runs gave different tokens")
    log(f"[{phase}] {arch} tokens[0][:8] = {outs[0][0, :8].tolist()}; two "
        f"runs agree")
    got_calls = [(kw["causal"], kw["window"], kw.get("kv_len") is not None)
                 for kw in calls]
    if got_calls != want_calls:
        raise AssertionError(f"{arch}: K4 calls {got_calls} do not follow "
                             f"the layers {want_calls}")
    errs = {}
    for name, (q, k, v, kw) in captured.items():
        tag = f"[{phase}] K4 {arch} {name}, the prompt's q/k/v:"
        errs[name], _, want = k4_check(tag, q, k, v, **kw)
        if kw["causal"]:
            k4_planted_faults(tag, q, k, v, kw["window"], want)
        if kw.get("kv_len") is not None:
            # the same layer with ragged encoder lengths, and its faults
            kv_len = torch.tensor(RAGGED_ENC_LEN, device=dev)
            tag = f"[{phase}] K4 {arch} {name}, ragged kv_len:"
            err, _, want = k4_check(tag, q, k, v, **dict(kw, kv_len=kv_len))
            k4_kv_len_faults(tag, q, k, v, kv_len, want)
            errs[name] = max(errs[name], err)
        del want
    del model, params, engine, batch, state
    torch.cuda.empty_cache()
    return launched, captured, errs


def family_card_vs_cpu(dev, arch, n_layers):
    """Phase 5e's float32 check of ``arch`` at full width and ``n_layers``:
    the same prefill and teacher-forced decode steps on the card and on
    the CPU from the same weights (drawn on the card, copied).  MoE layers
    must choose the same experts, call by call; logits within
    FAMILY_LOGIT_ATOL.  Raises on any difference."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=n_layers,
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    cpu_params = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (
        1, FAMILY_CHECK_PROMPT + FAMILY_CHECK_STEPS)))
    runs = {}
    plain_route = moe.route
    for where, p in (("card", params), ("cpu", cpu_params)):
        d = dev if where == "card" else torch.device("cpu")
        chosen = []

        def recording(*a, **kw):
            out = plain_route(*a, **kw)
            chosen.append(out[2].cpu())
            return out

        moe.route = recording
        try:
            with torch.inference_mode():
                logits, cache = model.prefill(
                    p, {"tokens": prompt[:, :FAMILY_CHECK_PROMPT].to(d)},
                    FAMILY_CHECK_PROMPT + FAMILY_CHECK_STEPS)
                out = [logits.cpu()]
                for i in range(FAMILY_CHECK_STEPS):
                    pos = FAMILY_CHECK_PROMPT + i
                    logits, cache = model.decode_step(
                        p, prompt[:, pos:pos + 1].to(d), cache, pos)
                    out.append(logits.cpu())
        finally:
            moe.route = plain_route
        runs[where] = (out, chosen)
    moe_layers = [i for i in range(cfg.n_layers) if cfg.moe_layer(i)]
    card, cpu = runs["card"][1], runs["cpu"][1]
    if len(card) != len(cpu):
        raise AssertionError(f"{arch}: {len(card)} router calls on the "
                             f"card, {len(cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(card, cpu)):
        if not torch.equal(a, b):
            step, j = divmod(i, len(moe_layers))
            raise AssertionError(
                f"{arch}: layer {moe_layers[j]} chose other experts on the "
                f"card than on the CPU in "
                f"{'the prefill' if step == 0 else 'decode step %d' % step}"
                f" ({int((a != b).sum())} of {a.numel()} choices)")
    errs = [(x - y).abs().max().item() for x, y in zip(*(
        runs[w][0] for w in ("card", "cpu")))]
    log(f"[5e] {arch} float32 at full width, {n_layers} layers, batch 1, "
        f"{FAMILY_CHECK_PROMPT}-token prompt + {FAMILY_CHECK_STEPS} decode "
        f"steps, card against CPU: logits max abs err "
        f"{[f'{e:.3e}' for e in errs]} (limit {FAMILY_LOGIT_ATOL}; logits "
        f"std {runs['cpu'][0][0].std().item():.3f}); router calls "
        f"{len(card)}, the same experts in each")
    if not max(errs) <= FAMILY_LOGIT_ATOL:
        raise AssertionError(f"{arch}: card against CPU logits {errs}")
    del params, cpu_params, cache
    torch.cuda.empty_cache()
    return max(errs)


def modal_card_vs_cpu(dev, arch):
    """Phase 5f's float32 check of ``arch`` at full width and 2 layers
    (whisper: 2 encoder and 2 decoder layers, ``enc_seq`` left at 1,500 so
    that the encoder's zero pad is live, with RAGGED_ENC_LEN; qwen2-vl:
    M-RoPE components that differ, 32 image and 32 text tokens): the same
    prefill and teacher-forced decode steps on the card and on the CPU
    from the same weights (drawn on the card, copied), batch 4.  Logits
    within FAMILY_LOGIT_ATOL and their greedy tokens equal; raises on any
    difference."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.models.model import build_model
    over = dict(n_layers=2, dtype="float32")
    if configs.get_config(arch).family == "encdec":
        over["enc_layers"] = 2
    cfg = dataclasses.replace(configs.get_config(arch), **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    cpu_params = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(2)
    nb = shapes.prefill_batch_specs(cfg, FAMILY_CHECK_PROMPT, SERVE_BATCH,
                                    rng=rng)
    if cfg.family == "encdec":
        nb["enc_len"] = np.array(RAGGED_ENC_LEN, np.int32)
    else:
        i = np.arange(FAMILY_CHECK_PROMPT)
        nb["positions"] = np.stack([
            np.broadcast_to(c, (SERVE_BATCH, FAMILY_CHECK_PROMPT))
            for c in (i, i // 8, i % 8)]).astype(np.int32)
    s = FAMILY_CHECK_PROMPT
    forced = rng.integers(0, cfg.vocab, (SERVE_BATCH, FAMILY_CHECK_STEPS))
    runs = {}
    for where, p in (("card", params), ("cpu", cpu_params)):
        d = dev if where == "card" else torch.device("cpu")
        batch = {k: torch.as_tensor(v, device=d) for k, v in nb.items()}
        with torch.inference_mode():
            logits, cache = model.prefill(p, batch, s + FAMILY_CHECK_STEPS)
            out = [logits.cpu()]
            for i in range(FAMILY_CHECK_STEPS):
                logits, cache = model.decode_step(
                    p, torch.as_tensor(forced[:, i:i + 1], device=d), cache,
                    s + i)
                out.append(logits.cpu())
        runs[where] = out
    errs = [(x - y).abs().max().item() for x, y in zip(runs["card"],
                                                       runs["cpu"])]
    same = all(torch.equal(x.argmax(-1), y.argmax(-1))
               for x, y in zip(runs["card"], runs["cpu"]))
    what = (f"+2 encoder layers, enc_len {RAGGED_ENC_LEN}"
            if cfg.family == "encdec" else "M-RoPE components apart")
    log(f"[5f] {arch} float32 at full width, 2 layers ({what})"
        f", batch {SERVE_BATCH}, {s}-token prompt + {FAMILY_CHECK_STEPS} "
        f"decode steps, card against CPU: logits max abs err "
        f"{[f'{e:.3e}' for e in errs]} (limit {FAMILY_LOGIT_ATOL}; logits "
        f"std {runs['cpu'][0].std().item():.3f}); greedy tokens "
        f"{'equal' if same else 'DIFFER'}")
    if not (max(errs) <= FAMILY_LOGIT_ATOL and same):
        raise AssertionError(f"{arch}: card against CPU logits {errs}, "
                             f"tokens equal {same}")
    del params, cpu_params, cache
    torch.cuda.empty_cache()
    return max(errs)


def profile_family(dev, arch, prompt):
    """Phase 7 for one of phase 5e's or 5f's archs: its full-width model drawn
    again, one warm prefill and one decode step under the profiler."""
    import torch
    model, params, engine, batch = family_engine(dev, arch, prompt)
    state = engine.prefill(batch)
    for what, fn in (("prefill", lambda: engine.prefill(batch)),
                     ("decode step", lambda: engine.step(state))):
        n_k, busy, wall, names, top = profile_step(fn)
        log(f"[7] profiled {arch} {what} (batch {SERVE_BATCH}, prompt "
            f"{prompt}): {n_k} device kernels, device busy {busy:.1f} us "
            f"of {wall:.1f} us wall (idle share {1 - busy / wall:.3f}, "
            f"profiler on); commonest {[(n[:60], c) for n, c in names]}; "
            f"most device time {[(n[:60], round(us, 1)) for n, us in top]}")
    del model, params, engine, batch, state
    torch.cuda.empty_cache()


def phase_families(dev):
    """Phase 5e: the moe, ssm and hybrid families.  Returns {arch: K4
    launches over both runs} and {arch: (layer, q, k, v, kw, K4 error)}
    for phase 6."""
    from repro_torch import configs
    from repro_torch.models.model import build_model
    launches, captured = {}, {}
    for arch, prompt, layer, depth in FAMILIES:
        if layer is None:
            n, _, _ = serve_family(dev, arch, prompt, {})
        else:
            kinds = build_model(configs.get_config(arch)).kinds[:layer]
            name = f"layer {layer}"
            n, cap, err = serve_family(dev, arch, prompt, {
                name: kinds.count("attn") + kinds.count("local")})
            captured[arch] = (layer,) + cap[name] + (err[name],)
        launches[arch] = n
        family_card_vs_cpu(dev, arch, depth)
    arch, prompt, overrides = PUBLISHED_MOE
    launches[f"{arch} (published)"], _, _ = serve_family(
        dev, arch, prompt, {}, overrides=overrides)
    return launches, captured


def phase_modal(dev):
    """Phase 5f: the encdec and vlm families.  Returns {arch: K4 launches
    over both runs} and [(arch, call name, q, k, v, kw, K4 error)] for
    phase 6."""
    launches, captured = {}, []
    for arch, prompt, capture in MODAL_FAMILIES:
        n, cap, errs = serve_family(dev, arch, prompt, capture, phase="5f")
        launches[arch] = n
        captured += [(arch, name) + cap[name] + (errs[name],)
                     for name in capture]
        modal_card_vs_cpu(dev, arch)
    return launches, captured


def k4b_errors(got, want):
    """(max abs error over the largest |value|, row error) of the worst of
    dq, dk, dv, and whether both are within the limits."""
    from repro_torch.kernels.flash_attention import ref
    dt = str(want[0].dtype).split(".")[-1]
    rel = row = 0.0
    for a, w in zip(got, want):
        top = w.float().abs().max().item()
        rel = max(rel, (a.float() - w.float()).abs().max().item()
                  / max(top, 1e-30))
        row = max(row, ref.row_error(a, w, floor=K4B_ROW_FLOOR[dt]))
    return rel, row, rel <= K4B_REL[dt] and row <= K4B_ROW_TOL[dt]


def plain_bwd_exact(q, k, v, o, do, **kw):
    """K4b's plain version on (q, k, v, o, dO): for bfloat16 inputs computed
    in float64 and rounded to bfloat16 (the exact gradients of those
    inputs, as near as bfloat16 holds them), else in the inputs' dtype."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    if q.dtype != torch.bfloat16:
        return ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    return tuple(g.to(q.dtype) for g in ref.flash_attention_bwd_ref(
        *(t.double() for t in (q, k, v, o, do)), **kw))


def k4b_check(tag, q, k, v, o, do, causal, window, faults=(), lse=None,
              kv_len=None):
    """K4b against its plain version on the same card tensors, from the
    forward's ``lse`` (the wrapper has K4 write it when it is None), with
    ``kv_len`` if given (the dK and dV rows past it must be exactly 0);
    the kernel with each planted fault named in ``faults`` (keys of
    K4B_FAULTS) must fail the check.  Returns the largest max abs error of
    dq, dk, dv."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    # bfloat16 inputs: the plain version in float64, rounded to bfloat16
    # as the kernel's outputs are (see K4B_REL)
    want = plain_bwd_exact(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    rel, row, ok = k4b_errors(got, want)
    err = max((a.float() - w.float()).abs().max().item()
              for a, w in zip(got, want))
    dt = str(q.dtype).split(".")[-1]
    lens = None if kv_len is None else kv_len.tolist()
    log(f"{tag} q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype} causal="
        f"{causal} window={window} kv_len={lens}: max abs err {err:.3e} "
        f"({rel:.3e} of the largest value, limit {K4B_REL[dt]}), row error "
        f"{row:.3e} (limit {K4B_ROW_TOL[dt]})")
    if not ok:
        raise AssertionError(f"K4b errors {rel}, {row} beyond the limits")
    for b, n in enumerate(lens or ()):
        if any(g[b, n:].count_nonzero().item() for g in got[1:]):
            raise AssertionError(f"K4b: dk or dv rows of batch {b} past "
                                 f"kv_len {n} are not 0")
    again = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K4b is not deterministic")
    for fault, tile, name in (K4B_FAULTS[f] for f in faults):
        bad = ops.flash_attention_bwd_planted(
            q, k, v, o, do, fault=fault, tile=tile, lse=lse, **kw)
        rel, row, ok = k4b_errors(bad, want)
        log(f"{tag} planted fault ({name}): {rel:.3e} of the largest "
            f"value, row error {row:.3e}: "
            f"{'PASSES' if ok else 'fails'} the check")
        if ok:
            raise AssertionError(f"K4b check passes a planted fault: "
                                 f"{name}")
    return err


def phase_train(dev):
    """Training at full width through launch/train.py (phase 5d).  Returns
    the layers' own K4b inputs (one global, one local), the launches of
    K1, K2, K4 and K4b, the largest K4b error on them, and a function that
    runs one more train step (remat "dots"), for phase 7."""
    import gc
    import math
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels.ddt import ops as k2
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.kernels.matcher import ops as k1
    from repro_torch.launch import train
    cfg = configs.get_config(TRAIN_ARCH)
    steps = TRAIN_FEEDS - 1
    captured, delivered, marks = {}, [], []
    plain_bwd = k4.flash_attention_bwd
    plain_ingest = train.datalib.SpinIngest
    gc_clock = [0.0, 0.0, 0]     # start of a collection, ms in all, gen 2

    def recording(q, k, v, o, do, kv_len=None, **kw):  # the layers' own
        if kv_len is not None:                  # K4b calls, with their lse
            raise AssertionError("train: gemma3-1b's K4b got a kv_len")
        kind = "local" if kw["window"] else "global"
        if kind not in captured:
            captured[kind] = (q, k, v, o, do, kw)
        return plain_bwd(q, k, v, o, do, **kw)

    class RecordingIngest(plain_ingest):     # the launcher's own ingest
        def __call__(self, raw):
            st = torch.cuda.memory_stats()
            marks.append((time.perf_counter(), gc_clock[1], gc_clock[2],
                          *(st.get(key, -1) for key in ALLOC_KEYS)))
            out = super().__call__(raw)
            delivered.append((self.pl, out))
            return out

    def on_gc(phase, info):
        if phase == "start":
            gc_clock[0] = time.perf_counter()
        else:
            gc_clock[1] += (time.perf_counter() - gc_clock[0]) * 1e3
            gc_clock[2] += info["generation"] == 2

    k1.launches = k2.launches = k4.launches = k4.bwd_launches = 0
    k4.flash_attention_bwd = recording
    train.datalib.SpinIngest = RecordingIngest
    gc.callbacks.append(on_gc)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        res = train.main(["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH),
                          "--seq", str(TRAIN_SEQ), "--steps",
                          str(TRAIN_FEEDS), "--spin-ingest", "--ckpt-every",
                          "0", "--seed", "0", "--device", "cuda"])
        wall = time.perf_counter() - t0
    finally:
        k4.flash_attention_bwd = plain_bwd
        train.datalib.SpinIngest = plain_ingest
        gc.callbacks.remove(on_gc)
    launches = {"match": k1.launches, "ddt_gather": k2.launches,
                "flash_attention": k4.launches,
                "flash_attention_bwd": k4.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in res["history"]]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    want = {"match": TRAIN_FEEDS, "ddt_gather": TRAIN_FEEDS,
            "flash_attention": K4_PER_LAYER_STEP * cfg.n_layers * steps,
            "flash_attention_bwd": K4B_PER_LAYER_STEP * cfg.n_layers * steps}
    log(f"[5d] launches: K1 {launches['match']}, K2 "
        f"{launches['ddt_gather']} (= {TRAIN_FEEDS} ingest calls), K4 "
        f"{launches['flash_attention']} (= {K4_PER_LAYER_STEP} x "
        f"{cfg.n_layers} layers x {steps} steps: forward and remat "
        f"recompute), K4b {launches['flash_attention_bwd']} (= "
        f"{K4B_PER_LAYER_STEP} x {cfg.n_layers} x {steps})")
    if launches != want:
        raise AssertionError(f"train launches {launches}, want {want}")
    if len(delivered) != TRAIN_FEEDS:
        raise AssertionError(f"train: {len(delivered)} ingest calls")
    for i, (pipe, out) in enumerate(delivered):
        corpus = pipe.corpus.batch(i, TRAIN_BATCH, TRAIN_SEQ)
        if not (np.array_equal(out["tokens"].cpu().numpy(), corpus[:, :-1])
                and np.array_equal(out["targets"].cpu().numpy(),
                                   corpus[:, 1:])):
            raise AssertionError(f"train: SpinIngest batch {i} is not the "
                                 f"corpus's")
    log(f"[5d] SpinIngest delivered {len(delivered)} batches of "
        f"{tuple(delivered[0][1]['tokens'].shape)} tokens; each equals the "
        f"corpus's batch (tokens and targets)")
    del delivered
    secs = res["step_secs"]
    warm = statistics.median(secs[1:])
    log(f"[5d] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}, remat "
        f"{cfg.remat}), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"--spin-ingest, {steps} steps in {wall:.2f} s (with set-up): "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"[5d] step (host clock, issue to both syncs) "
        f"{[round(x * 1e3, 3) for x in secs]} ms; median after the first "
        f"{warm * 1e3:.3f} ms, {TRAIN_BATCH * TRAIN_SEQ / warm:.0f} "
        f"tokens/s; overlap R = {res['overlap_ratio']:.4f} (T_MM "
        f"{res['t_train_s'] * 1e3:.3f} ms, T_Poll {res['t_poll_s'] * 1e3:.3f}"
        f" ms over the run); peak device memory {peak:.2f} GB")
    # from one ingest call to the next: the wait on step s - 1 and the
    # issue of step s (the launcher calls the ingest right after issuing)
    gaps = [[(b[0] - a[0]) * 1e3] + [b[j] - a[j] for j in range(1, len(a))]
            for a, b in zip(marks, marks[1:])]
    log(f"[5d] per step, from one ingest call to the next (ms; the "
        f"collector's ms and gen-2 collections; the allocator's "
        f"{', '.join(ALLOC_KEYS)}): "
        f"{[[round(x, 3) for x in g] for g in gaps]}")
    errs = []
    with torch.no_grad():
        for kind in ("global", "local"):
            q, k, v, o, do, kw = captured[kind]
            tag = f"[5d] K4, a {kind} layer's own q/k/v:"
            _, _, want_o = k4_check(tag, q, k, v, causal=kw["causal"],
                                    window=kw["window"])
            k4_planted_faults(tag, q, k, v, kw["window"], want_o)
            errs.append(k4b_check(f"[5d] K4b, a {kind} layer's own "
                                  f"inputs:", q, k, v, o, do,
                                  faults=K4B_FAULTS_NO_KV_LEN,
                                  **kw))
    bf, f32 = torch.bfloat16, torch.float32
    for i, (b, s, h, kv, d, dt, w) in enumerate((
            (2, 1024, 16, 8, 128, bf, 0),     # qwen3-1.7b's GQA, head_dim 128
            (2, 777, 4, 2, 64, f32, 100))):   # float32, ragged, window
        q, k, v = k4_inputs(dev, b, s, s, h, kv, d, dt, seed=40 + i)
        do = k4_inputs(dev, b, s, s, h, kv, d, dt, seed=50 + i)[0]
        o, lse = k4.flash_attention_with_lse(q, k, v, causal=True, window=w)
        k4b_check("[5d] K4b", q, k, v, o, do, causal=True, window=w,
                  faults=K4B_FAULTS_NO_KV_LEN if dt == f32 else (), lse=lse)
    train_restarts(dev)
    runs = train_remat_steps(dev)
    return captured, launches, max(errs), runs["dots"]


def train_remat_steps(dev):
    """gemma3-1b train steps at phase 5d's width and batch, under remat
    "dots" (the config's) and "none", on one set of params (seed 1), run
    in turns: host issue time and step time of each.  Returns {remat: a
    function that runs one more step}."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = configs.get_config(TRAIN_ARCH)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(1))
    ost = [opt.init(params.tree())]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             shapes.train_batch_specs(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                      rng=np.random.default_rng(1)).items()}
    runs = {}
    for remat in ("dots", "none"):
        step = Trainer(build_model(dataclasses.replace(cfg, remat=remat)),
                       opt.OptConfig(lr=3e-3, warmup_steps=1,
                                     total_steps=20),
                       TrainerConfig()).build_step()

        def run(step=step):
            _, ost[0], m = step(params, ost[0], batch)
            return m["loss"]
        runs[remat] = run
    times = {r: ([], []) for r in runs}
    for r in runs:                       # warm-up, not timed
        runs[r]()
    torch.cuda.synchronize()
    peak = dict.fromkeys(runs, 0.0)
    for r in ("dots", "none", "none", "dots") * 2:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs[r]()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        times[r][0].append((t1 - t0) * 1e3)
        times[r][1].append((time.perf_counter() - t0) * 1e3)
        peak[r] = max(peak[r], torch.cuda.max_memory_allocated() / 1e9)
    for r, (issue, total) in times.items():
        log(f"[5d] remat {r!r}: host issue {statistics.median(issue):.3f} "
            f"ms, step {statistics.median(total):.3f} ms (medians of "
            f"{len(total)} steps in turns; issue {[round(x, 3) for x in issue]}"
            f", step {[round(x, 3) for x in total]}); peak device memory "
            f"{peak[r]:.2f} GB")
    return runs


def train_restarts(dev):
    """run_with_restarts with a planted failure: the second attempt resumes
    from the first's checkpoint (gemma3-1b cut to RESTART_LAYERS layers
    and a vocab of RESTART_VOCAB; the checkpoints are deleted after)."""
    import dataclasses
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.launch import faults
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              n_layers=RESTART_LAYERS, vocab=RESTART_VOCAB)
    model = build_model(cfg)
    corpus = tdata.SyntheticCorpus(cfg.vocab, seed=0)
    d = tempfile.mkdtemp(prefix=".ckpt-", dir=ROOT)
    armed, first_steps = [True], []
    try:
        def make_state():
            p = model.init(torch.Generator(device=dev).manual_seed(0))
            return p, opt.init(p.tree())

        def run(state, attempt):
            params, ost = state
            tr = Trainer(model, opt.OptConfig(lr=3e-3, warmup_steps=1,
                                              total_steps=8),
                         TrainerConfig(steps=3, log_every=1, ckpt_every=2,
                                       ckpt_dir=d))

            def batches():
                for i in range(3):
                    if armed[0] and i == 2:
                        armed[0] = False
                        raise RuntimeError("planted failure before step 3")
                    toks = torch.as_tensor(corpus.batch(
                        i, TRAIN_BATCH, TRAIN_SEQ), device=dev)
                    yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
            out = tr.fit(params, ost, batches(), resume=True)
            first_steps.append(out[2][0]["step"])
            return out

        t0 = time.perf_counter()
        result, report = faults.run_with_restarts(make_state, run,
                                                  max_restarts=2)
        secs = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                      if f.is_file())
        steps = sorted(p.name for p in Path(d).glob("step-*"))
        losses = [h["loss"] for h in result[2]] if result else []
        log(f"[5d] restarts ({cfg.name} cut to {cfg.n_layers} layers and "
            f"vocab {cfg.vocab}): {report.restarts} restart(s), errors "
            f"{report.errors}; the second attempt resumed at step "
            f"{first_steps[0] - 1} and ran steps {first_steps[0]}-"
            f"{result[2][-1]['step'] if result else '?'} (losses "
            f"{[round(x, 4) for x in losses]}); checkpoints {steps}, "
            f"{on_disk / 1e9:.2f} GB on disk, {secs:.1f} s")
        if not (report.succeeded and report.restarts == 1
                and report.errors == ["RuntimeError: planted failure "
                                      "before step 3"]
                and first_steps == [3]
                and ckpt.latest_step(d) == 4
                and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"restarts: {report}, {first_steps}, "
                                 f"{steps}")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def family_k4b_call(kw):
    """The name of a K4b call of phase 5g's models by its keywords: the
    backward runs the layers last to first, so the last call of a kind is
    layer 0's.  With kv_len a cross-attention, not causal an encoder
    layer, causal a decoder or vlm layer."""
    if kw.get("kv_len") is not None:
        return "cross layer 0"
    return "layer 0" if kw["causal"] else "encoder layer 0"


def train_family(dev, arch, seq, k4_step, k4b_step, held):
    """Phase 5g for one arch: train at full width, check the losses and
    launches, hold K4b on the calls named in ``held``
    ({name: planted faults}) on their own inputs (whisper's cross layer
    also at RAGGED_ENC_LEN, with the kv_len fault).  Returns (launches
    (K4, K4b), [(call name, q, k, v, o, do, kw, K4b max abs error)])."""
    import itertools
    import math
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    cfg = configs.get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ost = opt.init(params.tree())
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             shapes.train_batch_specs(cfg, seq, TRAIN_BATCH,
                                      rng=np.random.default_rng(0)).items()}
    n_params = sum(p.numel() for p in params.parameters())
    tr = Trainer(model, opt.OptConfig(lr=3e-3, warmup_steps=1,
                                      total_steps=TRAIN_FAMILY_STEPS),
                 TrainerConfig(steps=TRAIN_FAMILY_STEPS, log_every=1))
    k4.launches = k4.bwd_launches = 0
    t0 = time.perf_counter()
    params, ost, hist = tr.fit(params, ost, itertools.repeat(batch),
                               resume=False)
    wall = time.perf_counter() - t0
    launches = (k4.launches, k4.bwd_launches)
    losses = [h["loss"] for h in hist]
    secs = [h["sec_per_step"] for h in hist]
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * seq
    warm = statistics.median(secs[1:])
    log(f"[5g] {arch} ({cfg.family}) at full width: {cfg.n_layers} layers"
        f"{' + %d encoder layers' % cfg.enc_layers if cfg.family == 'encdec' else ''}"
        f", d_model {cfg.d_model}, {n_params} parameters in {cfg.dtype}, "
        f"remat {cfg.remat}; batch {TRAIN_BATCH} x {seq} positions "
        f"{ {k: tuple(v.shape) for k, v in batch.items()} }; "
        f"{TRAIN_FAMILY_STEPS} steps in {wall:.2f} s: losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"[5g] {arch} step (host clock, synchronized) "
        f"{[round(x * 1e3, 3) for x in secs]} ms; median after the first "
        f"{warm * 1e3:.3f} ms, {tokens / warm:.0f} tokens/s; peak device "
        f"memory {peak / 1e9:.2f} GB ({(peak - held_before) / 1e9:.2f} GB "
        f"above what earlier phases hold); K4 {launches[0]} (= "
        f"{TRAIN_FAMILY_STEPS} x {k4_step}), K4b {launches[1]} (= "
        f"{TRAIN_FAMILY_STEPS} x {k4b_step})")
    if len(losses) != TRAIN_FAMILY_STEPS or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: losses {losses} do not fall")
    if launches != (TRAIN_FAMILY_STEPS * k4_step,
                    TRAIN_FAMILY_STEPS * k4b_step):
        raise AssertionError(f"{arch}: K4, K4b launches {launches}")
    step = tr._step_fn
    captured, out = {}, []
    if held:
        plain_bwd = k4.flash_attention_bwd

        def recording(q, k, v, o, do, **kw):    # the layers' own K4b calls
            captured[family_k4b_call(kw)] = (q, k, v, o, do, kw)
            return plain_bwd(q, k, v, o, do, **kw)
        k4.flash_attention_bwd = recording
        try:
            step(params, ost, batch)
        finally:
            k4.flash_attention_bwd = plain_bwd
    del tr, step, params, ost, batch, model
    for name, faults in held.items():
        q, k, v, o, do, kw = captured[name]
        tag = f"[5g] K4b {arch} {name}, the step's own inputs:"
        err = k4b_check(tag, q, k, v, o, do, faults=faults, **kw)
        out.append((name, q, k, v, o, do, kw, err))
        if kw.get("kv_len") is not None:
            # the same layer's q/k/v/dO with ragged encoder lengths, its
            # output and lse from K4 at those lengths
            kv_len = torch.tensor(RAGGED_ENC_LEN, dtype=torch.int32,
                                  device=dev)
            o, lse = k4.flash_attention_with_lse(q, k, v, causal=False,
                                                 kv_len=kv_len)
            ragged = dict(kw, lse=lse, kv_len=kv_len)
            tag = f"[5g] K4b {arch} {name}, ragged kv_len:"
            err = k4b_check(tag, q, k, v, o, do,
                            faults=faults + ("kv_len",), **ragged)
            out.append((f"{name}, ragged kv_len", q, k, v, o, do, ragged,
                        err))
    torch.cuda.empty_cache()
    return launches, out


def profile_train_family(dev, arch, seq):
    """Phase 7 for one of phase 5g's archs: its full-width model drawn
    again, two train steps, then one under the profiler.  Last of the
    profiled phases: after the profiler had traced mamba2-780m's step
    (30,000 kernels) it saw no device kernel in this process."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = configs.get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ost = opt.init(params.tree())
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             shapes.train_batch_specs(cfg, seq, TRAIN_BATCH,
                                      rng=np.random.default_rng(0)).items()}
    step = Trainer(model, opt.OptConfig(lr=3e-3, warmup_steps=1,
                                        total_steps=TRAIN_FAMILY_STEPS),
                   TrainerConfig()).build_step()
    for _ in range(2):
        step(params, ost, batch)
    n_k, busy, wall, names, top = profile_step(
        lambda: step(params, ost, batch))
    log(f"[7] profiled {arch} train step (batch {TRAIN_BATCH} x {seq}): "
        f"{n_k} device kernels, device busy {busy:.1f} us of {wall:.1f} us "
        f"wall (idle share {1 - busy / wall:.3f}, profiler on); commonest "
        f"{[(n[:60], c) for n, c in names]}; most device time "
        f"{[(n[:60], round(us, 1)) for n, us in top]}")
    del model, params, ost, batch, step
    torch.cuda.empty_cache()


def train_family_card_vs_cpu(dev, arch):
    """Phase 5g's float32 check of ``arch`` at full width and 2 layers
    (whisper: 2 encoder and 2 decoder layers over 1,500 frames with
    RAGGED_ENC_LEN; qwen2-vl: M-RoPE components apart): ``loss_fn`` and
    every gradient on the card (K4 and K4b's float32 kernels) and on the
    CPU from the same weights and batch.  Raises beyond FAMILY_LOSS_REL or
    FAMILY_GRAD_REL."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.models.model import build_model
    from repro_torch.train import tree as T
    over = dict(n_layers=2, dtype="float32")
    if configs.get_config(arch).family == "encdec":
        over["enc_layers"] = 2
    cfg = dataclasses.replace(configs.get_config(arch), **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    cpu_params = copy.deepcopy(params).to("cpu")
    nb = shapes.train_batch_specs(cfg, FAMILY_CHECK_PROMPT, TRAIN_BATCH,
                                  rng=np.random.default_rng(2))
    if cfg.family == "encdec":
        nb["enc_len"] = np.array(RAGGED_ENC_LEN, np.int32)
    else:
        i = np.arange(FAMILY_CHECK_PROMPT)
        nb["positions"] = np.stack([
            np.broadcast_to(c, (TRAIN_BATCH, FAMILY_CHECK_PROMPT))
            for c in (i, i // 8, i % 8)]).astype(np.int32)
    runs = {}
    before = (k4.launches, k4.bwd_launches)
    for where, p in (("card", params), ("cpu", cpu_params)):
        d = dev if where == "card" else torch.device("cpu")
        batch = {k: torch.as_tensor(v, device=d) for k, v in nb.items()}
        leaves = T.leaves(p.tree())
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = model.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, leaves)
        runs[where] = (loss.item(), [g.cpu() for g in grads])
    k4_calls = (k4.launches - before[0], k4.bwd_launches - before[1])
    names = [n for n, _ in T.flatten_with_names(params.tree())]
    loss_rel = abs(runs["card"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    worst, where = 0.0, None
    for name, a, b in zip(names, runs["card"][1], runs["cpu"][1]):
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, name
    log(f"[5g] {arch} float32 at full width, 2 layers "
        f"({'+2 encoder layers, enc_len %s' % (RAGGED_ENC_LEN,) if cfg.family == 'encdec' else 'M-RoPE components apart'}"
        f"), batch {TRAIN_BATCH} x {FAMILY_CHECK_PROMPT}, card against CPU: "
        f"loss {runs['cpu'][0]:.6f}, relative error {loss_rel:.3e} (limit "
        f"{FAMILY_LOSS_REL}); {len(names)} gradients, the worst "
        f"{worst:.3e} of its leaf's largest value at {where} (limit "
        f"{FAMILY_GRAD_REL}); K4, K4b launched {k4_calls} on the card")
    if not (loss_rel <= FAMILY_LOSS_REL and worst <= FAMILY_GRAD_REL):
        raise AssertionError(f"{arch}: float32 card against CPU: loss "
                             f"{loss_rel}, gradient {worst} at {where}")
    del params, cpu_params
    torch.cuda.empty_cache()


def phase_train_families(dev):
    """Phase 5g.  Returns {arch: (K4, K4b) launches} and [(arch, call
    name, q, k, v, o, do, kw, K4b error)] for phase 6."""
    launches, captured = {}, []
    for arch, seq, k4_step, k4b_step, held in TRAIN_FAMILIES:
        launches[arch], calls = train_family(dev, arch, seq, k4_step,
                                             k4b_step, held)
        captured += [(arch,) + c for c in calls]
        if held:
            train_family_card_vs_cpu(dev, arch)
    return launches, captured


def phase_manual_dp(dev):
    """Phase 5h: ``manual_dp.build``'s step at gemma3-1b's full width on a
    one-device NCCL group (world size 1, an in-process store), phase 5d's
    batch shape: the loss falls over MANUAL_DP_STEPS steps; on one step,
    for every leaf, the int8 codes read back (``quantize``) give the mean
    (code x scale) and the error-feedback identity err' = g + err - mean
    holds bit for bit on the card; then ms a step in turns with phase
    5d's plain ``Trainer`` step."""
    import math
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.models.model import build_model
    from repro_torch.parallel import compression as comp
    from repro_torch.train import manual_dp
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = configs.get_config(TRAIN_ARCH)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(1))
        ost = opt.init(params.tree())
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 shapes.train_batch_specs(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                          rng=np.random.default_rng(1)
                                          ).items()}
        ocfg = opt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=20)
        step, places = manual_dp.build(model, mesh, ocfg, batch)
        err = manual_dp.error_state_init(params.tree(), 1, device=dev)
        seen, codes = {}, []
        plain_pmean, plain_quantize = comp.compressed_pmean, comp.quantize

        def quantize(g32, gmax, n):            # the codes, read back
            out = plain_quantize(g32, gmax, n)
            codes.append(out)
            return out

        def pmean(grads, errs, groups, scale_of=None):
            # checked before the step writes the new error state over errs
            comp.quantize = quantize
            try:
                means, new_err = plain_pmean(grads, errs, groups, scale_of)
            finally:
                comp.quantize = plain_quantize
            bad = []
            for i, (g, e, m, ne, (q, sc)) in enumerate(zip(
                    grads, errs, means, new_err, codes)):
                g32 = g.to(torch.float32) + e
                if not (q.dtype == torch.int8
                        and torch.equal(m, q.to(torch.float32) * sc)
                        and torch.equal(ne, g32 - m)):
                    bad.append(i)
            seen.update(leaves=len(grads), codes=len(codes), bad=bad,
                        elements=sum(g.numel() for g in grads))
            codes.clear()
            return means, new_err
        losses, secs = [], []
        for i in range(MANUAL_DP_STEPS):
            if i == 1:        # a step whose error state is not zero
                comp.compressed_pmean = pmean
            try:
                t0 = time.perf_counter()
                params, ost, err, loss = step(params, ost, err, batch)
                losses.append(loss.item())
                secs.append(time.perf_counter() - t0)
            finally:
                comp.compressed_pmean = plain_pmean
        peak = torch.cuda.max_memory_allocated()
        log(f"[5h] manual_dp.build on a one-device NCCL group (mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}), {cfg.name} at "
            f"full width, batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
            f"{[round(x, 4) for x in losses]}; step 2's {seen['leaves']} "
            f"leaves ({seen['elements']} elements, as many int8 bytes on "
            f"the wire): codes x scale = mean and err' = g + err - mean "
            f"bit for bit on {seen['leaves'] - len(seen['bad'])} of "
            f"{seen['leaves']} leaves; error-state placements of "
            f"['embed']['tok'] {places[2]['embed']['tok']}; peak device "
            f"memory {peak / 1e9:.2f} GB")
        if seen["codes"] != seen["leaves"] or seen["bad"]:
            raise AssertionError(f"manual_dp: identity fails on leaves "
                                 f"{seen['bad'][:8]} ({seen['codes']} "
                                 f"codes)")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"manual_dp: losses {losses}")
        plain = Trainer(model, ocfg, TrainerConfig()).build_step()
        runs = {"manual_dp": lambda: step(params, ost, err, batch)[3],
                "Trainer": lambda: plain(params, ost, batch)[2]["loss"]}
        times = {r: [] for r in runs}
        for r in ("manual_dp", "Trainer", "Trainer", "manual_dp") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[r]()
            torch.cuda.synchronize()
            times[r].append((time.perf_counter() - t0) * 1e3)
        log(f"[5h] ms a step in turns (host clock, synchronized): "
            + "; ".join(f"{r} median {statistics.median(t):.3f} "
                        f"{[round(x, 3) for x in t]}"
                        for r, t in times.items())
            + f"; the first {MANUAL_DP_STEPS} manual_dp steps "
            f"{[round(x * 1e3, 3) for x in secs]} ms")
        del params, ost, err, batch, step, plain, runs
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def phase_mesh_trainer(dev):
    """Phase 5i: gemma3-1b at full width through ``Trainer(mesh=...)`` (the
    mesh from ``launch/mesh.make_host_mesh`` on a one-rank NCCL group with
    an in-process store, FSDP on: every parameter, moment and batch entry
    a DTensor), phase 5d's shape, MESH_STEPS steps on one
    ``train_batch_specs`` batch in turns with the plain ``Trainer`` from
    the same weights.  Fails unless every step's loss is within
    MESH_LOSS_REL of the plain step's, the loss falls, K4 and K4b launch
    as on the plain step (counted with the counters zeroed before each
    mesh step and read after it), and every parameter and moment is a
    DTensor with the rules' placements.  Then ms a step, tokens/s and peak
    memory of both in turns, and one profiled step of each.  Returns the
    mesh steps' (K4, K4b) launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import card_line, configs
    from repro_torch.configs import shapes
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as T
    from repro_torch.train.trainer import Trainer, TrainerConfig
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        torch.cuda.empty_cache()
        mesh = make_host_mesh()
        cfg = configs.get_config(TRAIN_ARCH)
        model = build_model(cfg)
        ocfg = opt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=20)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 shapes.train_batch_specs(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                          rng=np.random.default_rng(2)
                                          ).items()}
        state = {}
        for name in ("mesh", "plain"):
            params = model.init(torch.Generator(device=dev).manual_seed(2))
            state[name] = [params, opt.init(params.tree())]
        tr = Trainer(model, ocfg, TrainerConfig(fsdp=True), mesh=mesh)
        steps = {"mesh": tr.build_step(batch),
                 "plain": Trainer(model, ocfg, TrainerConfig()).build_step()}

        def run(name):
            params, ost, m = steps[name](*state[name], batch)
            state[name] = [params, ost]
            return m
        losses = {"mesh": [], "plain": []}
        counts = {"mesh": [], "plain": []}
        for _ in range(MESH_STEPS):
            for name in ("mesh", "plain"):
                k4.launches = k4.bwd_launches = 0
                m = run(name)
                torch.cuda.synchronize()
                counts[name].append((k4.launches, k4.bwd_launches))
                losses[name].append(float(m["loss"]))
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["mesh"],
                                                   losses["plain"])]
        want = (K4_PER_LAYER_STEP * cfg.n_layers,
                K4B_PER_LAYER_STEP * cfg.n_layers)
        places = dict(zip((n for n, _ in T.flatten_with_names(
            state["mesh"][0].tree())), T.leaves_like(
                tr.param_placements(), state["mesh"][0].tree())))
        ost = state["mesh"][1]
        misplaced = [n for key, tree in (("params", state["mesh"][0].tree()),
                                         ("mu", ost.mu), ("nu", ost.nu))
                     for n, v in T.flatten_with_names(tree)
                     if not (isinstance(v, DTensor)
                             and list(v.placements) == list(places[n]))]
        log(f"[5i] Trainer(mesh=make_host_mesh()) on one NCCL rank (mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, fsdp), "
            f"{cfg.name} at full width, batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
            f"losses {[round(x, 5) for x in losses['mesh']]}, plain "
            f"{[round(x, 5) for x in losses['plain']]}; largest relative "
            f"difference {max(rel):.3e} (limit {MESH_LOSS_REL}); (K4, K4b) "
            f"a step {counts['mesh']} (plain {counts['plain']}, want "
            f"{want}); {len(places) * 3 - len(misplaced)} of "
            f"{len(places) * 3} parameters and moments DTensors with the "
            f"rules' placements")
        if max(rel) > MESH_LOSS_REL or not losses["mesh"][-1] < \
                losses["mesh"][0]:
            raise AssertionError(f"mesh trainer losses {losses}")
        if any(c != want for c in counts["mesh"] + counts["plain"]):
            raise AssertionError(f"mesh trainer launches {counts}")
        if misplaced:
            raise AssertionError(f"mesh trainer placements: {misplaced[:5]}")
        card = card_line()
        times = {"mesh": [], "plain": []}
        peaks = {"mesh": [], "plain": []}
        for name in ("mesh", "plain", "plain", "mesh") * 2:
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run(name)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            peaks[name].append((peak, peak - start))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        for name in ("mesh", "plain"):
            med = statistics.median(times[name])
            log(f"[5i] {name} step ({card}): median {med:.3f} ms "
                f"{[round(x, 3) for x in times[name]]}, "
                f"{tokens / med * 1e3:.0f} tokens/s; peak "
                f"{max(p for p, _ in peaks[name]) / 1e9:.2f} GB allocated "
                f"(both trainers' state resident), "
                f"{max(a for _, a in peaks[name]) / 1e9:.2f} GB above the "
                f"step's start")
        for name in ("mesh", "plain"):
            n_k, busy, wall, names, top = profile_step(lambda: run(name))
            log(f"[5i] profiled {name} step ({card}): {n_k} device kernels, "
                f"busy {busy / 1e3:.3f} ms of {wall / 1e3:.3f} ms wall "
                f"(idle share {1 - busy / wall:.3f}, profiler on); most "
                f"device time {[(n[:50], round(us, 1)) for n, us in top]}")
        del state, steps, tr, batch
        total = tuple(sum(c[i] for c in counts["mesh"]) for i in (0, 1))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return total


def match_batch_earlier(batch, tables):
    """The matching stage as it ran before the first-match form: the
    (N, C) kernel, then seven PyTorch ops (mask by valid, any, cast,
    argmax, where, gather, and), each its own launch."""
    import torch
    from repro_torch.kernels.matcher import ops as k1
    matched, eom = k1.match(batch.data, tables.rules, tables.modes)
    matched = matched & batch.valid[:, None]
    any_match = matched.any(dim=1)
    first = matched.to(torch.uint8).argmax(dim=1)
    ctx_id = torch.where(any_match, first.to(torch.int32), -1)
    eom_hit = eom.gather(1, first[:, None])[:, 0]
    return ctx_id, any_match & eom_hit


def k2_bytes(idx, s, esize=4):
    """Bytes a gather by ``idx`` from ``s`` elements must move: each index
    read, each output written, each source element it references read
    once."""
    import torch
    used = torch.unique(idx[idx >= 0].clamp(max=s - 1)).numel()
    return idx.numel() * (4 + esize) + used * esize


def time_k2(tag, src, idx):
    """K2 by ``idx`` on the card: the vector body, the scalar body (the
    same map off 16-byte alignment), the plain version and torch.take,
    with the bound.  Checks the bodies against the plain version first.
    Returns (vector ms, plain ms, torch.take ms, bound ms, scalar ms)."""
    import torch
    from repro_torch.kernels.ddt import ops as k2, ref as k2ref
    off = offset_copy(idx, 1)
    want = k2ref.ddt_gather_ref(src, idx)
    for body, i in (("vector", idx), ("scalar", off)):
        if not torch.equal(bits(k2.gather(src, i)), bits(want)):
            raise AssertionError(f"K2 {body} body mismatch at {tag}")
    safe = idx.clamp(0, src.numel() - 1).to(torch.int64)  # take wants int64
    ms, host = time_ms(lambda: k2.gather(src, idx))
    scalar, _ = time_ms(lambda: k2.gather(src, off))
    plain, phost = time_ms(lambda: k2ref.ddt_gather_ref(src, idx))
    lib, _ = time_ms(lambda: torch.take(src, safe))
    nbytes = k2_bytes(idx, src.numel(), src.element_size())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[6] K2 {tag} S={src.numel()} I={idx.numel()}: vector body "
        f"{ms * 1e3:.3f} us (wrapper issues a call in {host * 1e3:.2f} us), "
        f"scalar body {scalar * 1e3:.3f} us, plain {plain * 1e3:.3f} us "
        f"(issued in {phost * 1e3:.2f} us), torch.take {lib * 1e3:.3f} us, "
        f"bound {bound * 1e3:.3f} us ({nbytes} B; vector body at "
        f"{bound / ms * 100:.1f} % of it)")
    return ms, plain, lib, bound, scalar


def k3_earlier_wrapper(data, lengths, *, start):
    """K3's earlier wrapper (the library looked up and its argument types
    tested on every call, the checks one by one): the "before" of the
    wrapper's host cost."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    if data.dim() != 2 or data.dtype != torch.uint8 or data.shape[1] % 2:
        raise ValueError("internet_checksum: data must be (N, W) uint8")
    if lengths.shape != data.shape[:1] or lengths.dtype != torch.int32:
        raise ValueError("internet_checksum: lengths must be (N,) int32")
    if start < 0:
        raise ValueError("internet_checksum: start must be >= 0")
    if data.device != lengths.device:
        raise ValueError("internet_checksum: different devices")
    if data.device.type == "cpu":
        raise ValueError("internet_checksum: CUDA only here")
    if data.device.type != "cuda":
        raise ValueError("internet_checksum: unsupported device")
    if not (data.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("internet_checksum: not contiguous")
    if data.shape[1] % 16 or data.data_ptr() % 16:
        raise ValueError("internet_checksum: rows must be 16-byte aligned")
    out = torch.empty(data.shape[:1], dtype=torch.int64, device=data.device)
    if data.shape[0] == 0:
        return out
    fn = build.load("checksum").repro_checksum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    err = fn(data.data_ptr(), lengths.data_ptr(), data.shape[0],
             data.shape[1], start, out.data_ptr(),
             torch.cuda.current_stream(data.device).cuda_stream)
    if err:
        raise RuntimeError(f"internet_checksum: launch failed ({err})")
    return out


def k3_bytes(ln, start, width):
    """(live bytes, sector bytes) K3 must move for lengths ``ln``: the live
    words (2 B each), or the 32-byte sectors their rounded-out ranges touch
    (``ref.live_byte_ranges``), plus each length read (4 B) and each
    checksum written (8 B)."""
    import torch
    from repro_torch.kernels.checksum import ref
    words = ((torch.div(ln.long() + 1, 2, rounding_mode="floor")
              .clamp(0, width // 2) - start // 2).clamp(min=0))
    lo, hi = ref.live_byte_ranges(ln, start, width)
    sectors = torch.where(hi > lo, (hi + 31) // 32 - lo // 32, 0)
    fixed = ln.numel() * (4 + 8)
    return int(words.sum()) * 2 + fixed, int(sectors.sum()) * 32 + fixed


def time_k3(dev, launches, reqs):
    """K3 at the path's 64 ICMP echo requests and at 65,536 and 262,144
    random frames.  Returns the ``kernels`` entry (the path's shape, with
    the larger shapes as extra keys)."""
    import torch
    from repro_torch.core import packet as pkt
    from repro_torch.kernels.checksum import ops as k3, ref as k3ref
    start = pkt.L4_BASE
    entry = dict(name="checksum", route="cuda",
                 source="src/repro_torch/kernels/checksum/checksum.cu",
                 replaces="src/repro/kernels/checksum/checksum.py:48",
                 launches=launches["checksum"])
    shapes = (("path", (reqs.data, reqs.length)),
              ("random", k3_random(dev, 65536, 13)),
              ("random", k3_random(dev, 262144, 14)))
    for tag, (d, ln) in shapes:
        n = ln.numel()
        want = k3ref.checksum_ref(d, ln, start)
        got = k3.internet_checksum(d, ln, start=start)
        err = int((got - want).abs().max())
        if err or not torch.equal(k3_earlier_wrapper(d, ln, start=start),
                                  want):
            raise AssertionError(f"K3 mismatch at the timed shape N={n}")
        nbytes, sbytes = k3_bytes(ln, start, pkt.MTU)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        sbound = sbytes / HBM_BYTES_PER_S * 1e3

        def new():
            return k3.internet_checksum(d, ln, start=start)

        def old():
            return k3_earlier_wrapper(d, ln, start=start)

        # in turns: new, earlier, earlier, new
        ms, host = time_ms(new)
        old_ms, old_h = time_ms(old)
        old_ms2, old_h2 = time_ms(old)
        ms2, host2 = time_ms(new)
        small = n <= 65536
        plain, phost = time_ms(lambda: k3ref.checksum_ref(d, ln, start),
                               runs=25 if small else 5,
                               per_run=20 if small else 4)
        log(f"[6] K3 {tag} N={n}: device {ms * 1e3:.3f} / {ms2 * 1e3:.3f} "
            f"us, issued in {host * 1e3:.2f} / {host2 * 1e3:.2f} us; the "
            f"earlier wrapper {old_ms * 1e3:.3f} / {old_ms2 * 1e3:.3f} us, "
            f"issued in {old_h * 1e3:.2f} / {old_h2 * 1e3:.2f} us (in turns: "
            f"new, earlier, earlier, new); bound {bound * 1e3:.3f} us by "
            f"live bytes ({nbytes} B, {bound / ms * 100:.1f} %), "
            f"{sbound * 1e3:.3f} us by sectors ({sbytes} B, "
            f"{sbound / ms * 100:.1f} %); plain {plain * 1e3:.3f} us "
            f"(issued in {phost * 1e3:.2f} us)")
        if tag == "path":
            entry.update(max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by="bytes", library_ms=None,
                         sector_bound_ms=sbound, host_ms=host,
                         earlier_wrapper_host_ms=old_h)
        else:
            entry.update({f"ms_{n}": ms, f"bound_ms_{n}": bound,
                          f"sector_bound_ms_{n}": sbound,
                          f"plain_ms_{n}": plain})
    return entry


def time_k4(tag, dev, q, k, v, kw, with_lse=False):
    """K4 on (q, k, v) at ``kw``'s mask (causal, window, kv_len): device
    time, the plain version's and SDPA's (the yardstick) in the same call,
    and the bound (4 D operations per live (query, key) pair over the bf16
    peak, or q read, the live rows of k and v read and the output written
    over the HBM rate).  With ``with_lse``, K4 with and without the lse
    output in turns.  Logs and returns the numbers."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from repro_torch.kernels.flash_attention import ops as k4, ref as k4ref
    b, sq, h, d = q.shape
    sk = k.shape[1]
    w, causal, kv_len = kw["window"], kw["causal"], kw.get("kv_len")
    lens = [sk] * b if kv_len is None else kv_len.tolist()
    n_ops = 4 * d * h * live_pairs(sq, lens, causal, w)
    nbytes = (2 * q.numel() + 2 * sum(lens) * k.shape[2] * d) \
        * q.element_size()
    bound = max(n_ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    by = "operations" if n_ops / BF16_OPS_PER_S > \
        nbytes / HBM_BYTES_PER_S else "bytes"
    ms, host = time_ms(lambda: k4.flash_attention(q, k, v, **kw))
    lse_note, ms_lse = "", None
    if with_lse:
        # without lse (the serving path) and with it (training), in turns
        ms_lse, _ = time_ms(lambda: k4.flash_attention_with_lse(q, k, v,
                                                                **kw))
        ms2, _ = time_ms(lambda: k4.flash_attention(q, k, v, **kw))
        ms_lse2, _ = time_ms(lambda: k4.flash_attention_with_lse(q, k, v,
                                                                 **kw))
        lse_note = (f"; in turns without and with the lse output: "
                    f"{ms * 1e3:.3f}, {ms_lse * 1e3:.3f}, {ms2 * 1e3:.3f}, "
                    f"{ms_lse2 * 1e3:.3f} us")
    plain, _ = time_ms(lambda: k4ref.flash_attention_ref(q, k, v, **kw),
                       runs=5, per_run=4)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    jj = torch.arange(sk, device=dev)[None, :]
    if w:
        ii = torch.arange(sq, device=dev)[:, None]
        sdpa = dict(attn_mask=(jj <= ii) & (jj > ii - w), enable_gqa=True)
    elif kv_len is not None:                   # (B, 1, 1, Sk), not causal
        sdpa = dict(attn_mask=(jj < kv_len[:, None])[:, None, None],
                    enable_gqa=True)
    else:
        sdpa = dict(is_causal=causal, enable_gqa=True)
    lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **sdpa))
    lib_err = (F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
               .transpose(1, 2).float() - k4.flash_attention(
                   q, k, v, **kw).float()).abs().max().item()
    choice = torch._fused_sdp_choice(
        qt, kt, vt, sdpa.get("attn_mask"), 0.0,
        sdpa.get("is_causal", False), enable_gqa=True)
    mask = f"window {w}" if causal else (
        "not causal" + ("" if kv_len is None else f", kv_len {lens}"))
    log(f"{tag} q{tuple(q.shape)} k{tuple(k.shape)} {mask}: device "
        f"{ms * 1e3:.3f} us (issued in {host * 1e3:.2f} us), plain device "
        f"{plain * 1e3:.3f} us, SDPA ({SDPBackend(choice).name}) "
        f"{lib * 1e3:.3f} us (differs from K4 by {lib_err:.3e}), bound "
        f"{bound * 1e3:.3f} us by {by} ({n_ops} ops, {nbytes} B; "
        f"{n_ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{bound / ms * 100:.1f} % of the bound){lse_note}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, lse_ms=ms_lse)


def live_pairs(sq, lens, causal, window):
    """The live (query, key) pairs of one head: over the batch rows' key
    lengths ``lens``, query i sees keys [max(0, i - window + 1), min(i,
    n - 1)] (causal) or [that, n - 1] (not)."""
    import torch
    i = torch.arange(sq)
    lo = (i - window + 1).clamp(min=0) if window else torch.zeros_like(i)
    return sum(int(((i.clamp(max=n - 1) if causal else
                     torch.full_like(i, n - 1)) - lo + 1).clamp(min=0).sum())
               for n in lens)


def time_k4b(tag, dev, q, k, v, o, do, kw):
    """K4b on (q, k, v, o, dO) at ``kw``'s mask (causal, window, kv_len,
    lse): device time, the plain version's and SDPA's backward
    (``torch.autograd.grad`` of ``scaled_dot_product_attention`` with a
    boolean mask for a window or kv_len; the yardstick) in the same call,
    and the bound: 10 D operations per live (query, key) pair (S, dP, dV,
    dQ, dK; the dQ kernel's recompute of S and dP adds 4 D, which the
    bound does not count) over the bf16 peak, or q, o, dO and the live
    rows of k and v read and dq, dk, dv written over the HBM rate.  Logs
    and returns the numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as k4, ref as k4ref
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    w, causal, kv_len = kw["window"], kw["causal"], kw.get("kv_len")
    lens = [sk] * b if kv_len is None else kv_len.tolist()
    n_ops = 10 * d * h * live_pairs(sq, lens, causal, w)
    nbytes = (4 * q.numel() + 2 * sum(lens) * kvh * d + 2 * k.numel()) \
        * q.element_size()
    bound = max(n_ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    by = "operations" if n_ops / BF16_OPS_PER_S > \
        nbytes / HBM_BYTES_PER_S else "bytes"
    ms, host = time_ms(lambda: k4.flash_attention_bwd(q, k, v, o, do, **kw))
    plain_kw = {key: kw.get(key) for key in ("causal", "window", "kv_len")}
    plain, _ = time_ms(lambda: k4ref.flash_attention_bwd_ref(
        q, k, v, o, do, **plain_kw), runs=5, per_run=4)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    jj = torch.arange(sk, device=dev)[None, :]
    if w:
        ii = torch.arange(sq, device=dev)[:, None]
        sdpa = dict(attn_mask=(jj <= ii) & (jj > ii - w), enable_gqa=True)
    elif kv_len is not None:                   # (B, 1, 1, Sk), not causal
        sdpa = dict(attn_mask=(jj < kv_len[:, None])[:, None, None],
                    enable_gqa=True)
    else:
        sdpa = dict(is_causal=causal, enable_gqa=True)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
    dot = do.transpose(1, 2)
    lib, _ = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    lib_grads = torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                    retain_graph=True)
    lib_err = max((a.transpose(1, 2).float() - g.float()).abs().max()
                  .item() for a, g in zip(lib_grads, k4.flash_attention_bwd(
                      q, k, v, o, do, **kw)))
    mask = f"window {w}" if w else ("causal" if causal else "not causal")
    if kv_len is not None:
        mask += f", kv_len {lens}"
    log(f"{tag} ({mask}) q{tuple(q.shape)} k{tuple(k.shape)}: device "
        f"{ms * 1e3:.3f} us (issued in {host * 1e3:.2f} us), plain device "
        f"{plain * 1e3:.3f} us, SDPA backward {lib * 1e3:.3f} us (its "
        f"gradients differ from K4b's by {lib_err:.3e}), bound "
        f"{bound * 1e3:.3f} us by {by} ({n_ops} ops, {nbytes} B; "
        f"{n_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{bound / ms * 100:.2f} % of the bound)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib)


def phase_kernels(dev, launches, spin, reqs, captured, k4_errs, empty,
                  captured_bwd, k4b_err, fam_captured, modal_captured,
                  family_captured):
    """Time the launch floor, K1-K4 and K4b at their paths' shapes.
    Returns the entries of the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.core import ddt, matching, packet as pkt
    from repro_torch.kernels.ddt import ops as k2, ref as k2ref
    from repro_torch.kernels.matcher import ops as k1, ref as k1ref
    out = []

    # the launch floor: an empty kernel through ctypes, as the port's are
    for blocks, threads in ((1, 32), (512, 128)):
        def call():
            if empty(blocks, threads, torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("empty kernel: launch failed")
        ms, host = time_ms(call)
        log(f"[6] launch floor: an empty kernel of {blocks} x {threads} "
            f"threads takes {ms * 1e3:.3f} us on the device (issued in "
            f"{host * 1e3:.2f} us)")

    # K1: the matching stage at the main path's shape (a batch of 64
    # frames, the Fig 10 NIC's single context) and at 65,536 frames of
    # three contexts; match_batch (one launch) against the earlier stage.
    # Bytes: the table, the modes, valid, ctx_id and eom, and per frame the
    # distinct selected words (4 B each) or the 32-byte sectors they lie in.
    for n, ctxs in ((NIC_BATCH, [matching.ruleset_slmp(9331)]),
                    (65536, [matching.ruleset_icmp_echo(),
                             matching.ruleset_udp_pingpong(),
                             matching.ruleset_slmp(9330)])):
        tables = matching.MatchTables.build(ctxs, device=dev)
        d = torch.as_tensor(wire_frames(n, n + 1), device=dev)
        batch = pkt.PacketBatch(
            d, torch.full((n,), pkt.MTU, dtype=torch.int32, device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev))
        nctx = tables.n_ctx
        idx = torch.clamp(tables.rules[:, :, 0], 0, pkt.WORDS - 1)
        words = torch.unique(idx).numel()
        sectors = torch.unique(idx // 8).numel()
        fixed = tables.rules.numel() * 8 + nctx * 4 + n * (1 + 4 + 1)
        nbytes = n * words * 4 + fixed
        sbytes = n * sectors * 32 + fixed
        n_ops = n * nctx * 4 * 4         # per rule: mask, 2 compares, combine
        got = matching.match_batch(batch, tables)
        old = match_batch_earlier(batch, tables)
        want = k1ref.match_first_ref(d, tables.rules, tables.modes,
                                     batch.valid)
        err = sum(int((g[i] != want[i]).sum()) for g in (got, old)
                  for i in (0, 1))
        if err:
            raise AssertionError("K1 mismatch at the timed shape")
        # in turns: the stage, the earlier stage twice, the stage again
        ms, host = time_ms(lambda: matching.match_batch(batch, tables))
        old_ms, old_host = time_ms(lambda: match_batch_earlier(batch,
                                                               tables))
        old_ms2, old_host2 = time_ms(lambda: match_batch_earlier(batch,
                                                                 tables))
        ms2, host2 = time_ms(lambda: matching.match_batch(batch, tables))
        nc_ms, nc_host = time_ms(lambda: k1.match(d, tables.rules,
                                                  tables.modes))
        plain, phost = time_ms(lambda: k1ref.match_first_ref(
            d, tables.rules, tables.modes, batch.valid))
        bound = max(nbytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3
        sbound = max(sbytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3
        log(f"[6] K1 N={n} C={nctx}: match_batch (first-match kernel) "
            f"device {ms * 1e3:.3f} / {ms2 * 1e3:.3f} us, issued in "
            f"{host * 1e3:.2f} / {host2 * 1e3:.2f} us; earlier stage ((N, "
            f"C) kernel + 7 ops) device {old_ms * 1e3:.3f} / "
            f"{old_ms2 * 1e3:.3f} us, issued in {old_host * 1e3:.2f} / "
            f"{old_host2 * 1e3:.2f} us (in turns: new, earlier, earlier, "
            f"new); "
            f"(N, C) kernel alone {nc_ms * 1e3:.3f} us (issued in "
            f"{nc_host * 1e3:.2f} us); plain {plain * 1e3:.3f} us (issued "
            f"in {phost * 1e3:.2f} us); bound {bound * 1e6:.2f} ns by words "
            f"({nbytes} B, {words} words a frame), {sbound * 1e6:.2f} ns by "
            f"sectors ({sbytes} B, {sectors} sectors a frame), {n_ops} int "
            f"ops")
        if n == NIC_BATCH:
            out.append(dict(
                name="match", route="cuda",
                source="src/repro_torch/kernels/matcher/matcher.cu",
                replaces="src/repro/kernels/matcher/matcher.py:62",
                launches=launches["match"], max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=None, sector_bound_ms=sbound,
                earlier_stage_ms=old_ms, host_ms=host,
                earlier_stage_host_ms=old_host,
                fabric_launches=launches["match_fabric"],
                train_launches=launches["train"]["match"]))

    # K2 at the ingest's shape: the one gather by the composed map (message
    # elements -> tokens) against the earlier two (message -> application
    # buffer -> tokens) with the scalar body, as they ran before
    rng = np.random.default_rng(11)
    pl = spin.pl
    msg = torch.as_tensor(rng.integers(-2**31, 2**31, pl.msg_bytes // 4)
                          .astype(np.int32), device=dev)
    n_tok = pl.batch * (pl.seq + 1)
    unpack = offset_copy(torch.as_tensor(pl.unpack_idx, device=dev), 1)
    pack = offset_copy(torch.as_tensor(pl.pack_idx, device=dev), 1)

    def two_gathers():
        return k2.gather(k2.gather(msg, unpack), pack)[:n_tok]

    if not torch.equal(two_gathers(), k2.gather(msg, spin.tok_idx)):
        raise AssertionError("K2: one gather != the earlier two")
    # in turns: one gather, the earlier two twice, one gather again
    ms, plain, lib, bound, scalar = time_k2("ingest, one gather",
                                            msg, spin.tok_idx)
    old_ms, old_host = time_ms(two_gathers)
    old_ms2, old_host2 = time_ms(two_gathers)
    ms2, host2 = time_ms(lambda: k2.gather(msg, spin.tok_idx))
    old_bound = (k2_bytes(unpack, msg.numel())
                 + k2_bytes(pack, unpack.numel())) / HBM_BYTES_PER_S * 1e3
    log(f"[6] K2 ingest, earlier two gathers (scalar body, the application "
        f"buffer between them): device {old_ms * 1e3:.3f} / "
        f"{old_ms2 * 1e3:.3f} us, issued in {old_host * 1e3:.2f} / "
        f"{old_host2 * 1e3:.2f} us, their bound {old_bound * 1e3:.3f} us; "
        f"one gather again {ms2 * 1e3:.3f} us (issued in "
        f"{host2 * 1e3:.2f} us)")
    out.append(dict(
        name="ddt_gather", route="cuda",
        source="src/repro_torch/kernels/ddt/ddt_gather.cu",
        replaces="src/repro/kernels/ddt/ddt.py:71",
        launches=launches["ddt_gather"], max_abs_err=0, ms=ms,
        plain_ms=plain, bound_ms=bound, bound_by="bytes", library_ms=lib,
        scalar_body_ms=scalar, earlier_two_gathers_ms=old_ms,
        train_launches=launches["train"]["ddt_gather"]))
    # a Fig 9 complex datatype at count 32,768 (a message of about 4 MiB),
    # pack and unpack maps, and a 4 MiB int32 permutation
    c = ddt.commit(ddt.complex_ddt(), count=32768)
    p_idx, u_idx = ddt.element_maps(c, 4)
    mem = torch.as_tensor(rng.integers(-2**31, 2**31, c.mem_bytes // 4)
                          .astype(np.int32), device=dev)
    msg4 = torch.as_tensor(rng.integers(-2**31, 2**31, c.msg_bytes // 4)
                           .astype(np.int32), device=dev)
    time_k2(f"Fig 9 complex x 32768 pack ({c.msg_bytes} B message)", mem,
            torch.as_tensor(p_idx, device=dev))
    time_k2(f"Fig 9 complex x 32768 unpack ({c.mem_bytes} B buffer)", msg4,
            torch.as_tensor(u_idx, device=dev))
    time_k2("permutation int32", torch.arange(1 << 20, dtype=torch.int32,
                                              device=dev),
            torch.randperm(1 << 20, device=dev).to(torch.int32))

    # K3 at the checksum path's shape (64 ICMP echo requests) and at
    # 65,536 and 262,144 random frames (the last four times the L2): the
    # wrapper against the earlier wrapper in turns, the plain version, and
    # two bounds.
    out.append(time_k3(dev, launches, reqs))

    # K4 on the prompt's own q/k/v of a global and a local layer of the
    # serving path; SDPA on the same tensors as the yardstick.  The entry's
    # main numbers are the global layer's; local_* are the local layer's;
    # family_shapes holds phase 5e's two shapes.
    from repro_torch.kernels.flash_attention import ops as k4
    k4_entry = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:100",
        launches=launches["flash_attention"],
        train_launches=launches["train"]["flash_attention"],
        max_abs_err=max(k4_errs.values()))
    for layer in sorted(captured, reverse=True):          # global first
        q, k, v, kw, _ = captured[layer]
        w = kw["window"]
        t = time_k4(f"[6] K4 layer {layer} "
                    f"({'local, window %d' % w if w else 'global'})",
                    dev, q, k, v, kw, with_lse=True)
        if w:
            k4_entry.update(local_ms=t["ms"], local_plain_ms=t["plain_ms"],
                            local_bound_ms=t["bound_ms"],
                            local_library_ms=t["library_ms"],
                            local_lse_ms=t["lse_ms"])
        else:
            k4_entry.update(ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                            library_ms=t["library_ms"], lse_ms=t["lse_ms"])
    # the two shapes of phase 5e, on their layers' own q/k/v
    k4_entry["family_shapes"] = []
    for arch, (layer, q, k, v, kw, err) in fam_captured.items():
        t = time_k4(f"[6] K4 {arch} layer {layer}", dev, q, k, v, kw)
        k4_entry["family_shapes"].append(dict(
            arch=arch, layer=layer, q=list(q.shape), k=list(k.shape),
            window=kw["window"],
            launches=launches["families"][arch], max_abs_err=err,
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}))
    k4_entry["family_launches"] = launches["families"]
    # phase 5f's calls on their own q/k/v: whisper's encoder layer 0 (1,536
    # keys after the zero pad), its cross layer 0 at the path's enc_len and
    # at RAGGED_ENC_LEN (SDPA with a boolean mask), qwen2-vl's layer 0
    k4_entry["modal_shapes"] = []
    for arch, name, q, k, v, kw, err in modal_captured:
        variants = [(name, kw)]
        if kw.get("kv_len") is not None:
            variants.append((f"{name}, ragged kv_len", dict(
                kw, kv_len=torch.tensor(RAGGED_ENC_LEN, dtype=torch.int32,
                                        device=dev))))
        for call, kwv in variants:
            t = time_k4(f"[6] K4 {arch} {call}", dev, q, k, v, kwv)
            kv_len = kwv.get("kv_len")
            k4_entry["modal_shapes"].append(dict(
                arch=arch, call=call, q=list(q.shape), k=list(k.shape),
                causal=kwv["causal"],
                kv_len=None if kv_len is None else kv_len.tolist(),
                launches=launches["modal"][arch], max_abs_err=err,
                **{key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}))
    k4_entry["modal_launches"] = launches["modal"]
    # Not kernels (plain PyTorch, no TPU kernel behind them): the two
    # recurrences of phase 5e's prefills at their shapes, candidates for a
    # later kernel: the rglru scan (B 4, S 4,096, width 4,096, float32; 26
    # layers a recurrentgemma-9b prefill), and mamba2's SSD (B 4, S 2,048,
    # 48 heads of 64, state 128, chunk 128; 48 layers a prefill) with its
    # 16-step chunk loop alone
    from repro_torch import configs
    from repro_torch.models import rglru, ssm
    g = torch.Generator(device=dev).manual_seed(5)
    rg = configs.get_config("recurrentgemma-9b")
    a = torch.rand((4, 4096, rg.lru_width), device=dev, generator=g)
    b = torch.randn((4, 4096, rg.lru_width), device=dev, generator=g)
    scan_ms, scan_host = time_ms(lambda: rglru.linear_scan(a, b), runs=5,
                                 per_run=4)
    n_rg = sum(kind == "rglru" for kind in
               build_model(rg).kinds)
    del a, b
    mb = configs.get_config("mamba2-780m")
    bb, s, h, p, n = 4, 2048, mb.ssm_heads, mb.ssm_head_dim, mb.ssm_state
    xh = torch.randn((bb, s, h, p), device=dev, generator=g
                     ).to(torch.bfloat16)
    dt = torch.rand((bb, s, h), device=dev, generator=g) * 0.1
    am = -torch.linspace(1.0, 16.0, h, device=dev)
    bm, cm = (torch.randn((bb, s, n), device=dev, generator=g)
              for _ in range(2))
    ssd_ms, ssd_host = time_ms(lambda: ssm.ssd_chunked(
        xh, dt, am, bm, cm, mb.ssm_chunk), runs=5, per_run=4)
    nc = s // mb.ssm_chunk
    dec = torch.rand((bb, nc, h), device=dev, generator=g)
    loc = torch.randn((bb, nc, h, n, p), device=dev, generator=g)
    loop_ms, loop_host = time_ms(lambda: ssm.chunk_states(dec, loc),
                                 runs=5, per_run=4)
    log(f"[6] plain PyTorch, not kernels: rglru linear_scan at "
        f"(4, 4096, {rg.lru_width}) float32: {scan_ms:.3f} ms on the "
        f"device (issued in {scan_host:.3f} ms) a layer, "
        f"{scan_ms * n_rg:.3f} ms over the {n_rg} rglru layers of a "
        f"prefill; mamba2 ssd_chunked at ({bb}, {s}, {h}, {p}), state {n}, "
        f"chunk {mb.ssm_chunk}: {ssd_ms:.3f} ms (issued in "
        f"{ssd_host:.3f} ms) a layer, {ssd_ms * mb.n_layers:.3f} ms over "
        f"{mb.n_layers} layers; its {nc}-step chunk loop alone "
        f"{loop_ms:.3f} ms (issued in {loop_host:.3f} ms) a layer, "
        f"{loop_ms * mb.n_layers:.3f} ms a prefill")
    del xh, dt, bm, cm, dec, loc
    out.append(k4_entry)

    # K4b on the training run's own inputs of a global and a local layer,
    # from the lse their forward saved, and on phase 5g's held calls (its
    # three train paths' shapes); SDPA's backward as the yardstick.
    k4b_entry = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/"
               "flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:94",
        launches=launches["train"]["flash_attention_bwd"],
        max_abs_err=max([k4b_err] + [c[-1] for c in family_captured]))
    for kind in ("global", "local"):
        q, k, v, o, do, kw = captured_bwd[kind]
        t = time_k4b(f"[6] K4b {kind} layer", dev, q, k, v, o, do, kw)
        if kw["window"]:
            k4b_entry.update(local_ms=t["ms"], local_plain_ms=t["plain_ms"],
                             local_bound_ms=t["bound_ms"],
                             local_library_ms=t["library_ms"])
        else:
            k4b_entry.update(**{key: t[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    k4b_entry["train_shapes"] = []
    for arch, call, q, k, v, o, do, kw, err in family_captured:
        t = time_k4b(f"[6] K4b {arch} {call}", dev, q, k, v, o, do, kw)
        kv_len = kw.get("kv_len")
        k4b_entry["train_shapes"].append(dict(
            arch=arch, call=call, q=list(q.shape), k=list(k.shape),
            causal=kw["causal"],
            kv_len=None if kv_len is None else kv_len.tolist(),
            launches=launches["train_families"][arch][1], max_abs_err=err,
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}))
    k4b_entry["train_family_launches"] = {
        arch: n[1] for arch, n in launches["train_families"].items()}
    # K4b's kernels one by one, under the profiler (after every timing)
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for kind in ("global", "local"):
        q, k, v, o, do, kw = captured_bwd[kind]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k4.flash_attention_bwd(q, k, v, o, do, **kw)
            torch.cuda.synchronize()
        parts = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"(\w+_kernel)(<[^>]*>)?", e.name)
                key = m.group(1) + (m.group(2) or "") if m else e.name[:40]
                parts[key] = round(parts.get(key, 0.0) + e.time_range.end
                                   - e.time_range.start, 1)
        log(f"[6] K4b {kind} layer, its kernels under the profiler (us): "
            f"{parts}")
        k4b_entry["local_parts_us" if kind == "local" else "parts_us"] = \
            parts
    out.append(k4b_entry)
    return out


# Phase 6, K5: mamba2's SSD decode mixer at the serve cell's shapes
# (mamba2-780m at batch 16, bfloat16; the benchmark's eps), on a layer
# drawn on the card from seed 0 with caches holding a random window and
# state.  The check, over K5_STEPS steps that carry the state from the
# same caches, holds the kernel to its plain version on the card as
# tests/test_torch_cuda.py does (the window exact; the output by row error
# within K5_ROW_TOL; the state within K5_STATE_REL of its largest |value|:
# bfloat16 roundings that the sums' order moves by one step), and each
# planted fault of ``ssm_decode_faults`` must fail it.
K5_BATCH = 16
K5_EPS = 1e-5
K5_STEPS = 4
K5_LAYERS = 4          # layers' caches timed in turn: 100 MB, twice the L2
K5_ROW_TOL = 0.1
K5_STATE_REL = 1e-2


def phase_k5(dev):
    """Phase 6, K5: held to its plain version with planted faults, then
    timed at the serve cell's shapes beside its bytes bound and the plain
    version.  Returns its entry of the ``kernels`` line."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ref import row_error
    from repro_torch.kernels.ssm_decode import ops as k5, ref as k5ref
    from repro_torch.models import ssm
    cfg = configs.get_config("mamba2-780m")
    b, nh, ns, hd = K5_BATCH, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    di, k, ch = cfg.d_inner, cfg.conv_width, cfg.d_inner + 2 * ns
    g = torch.Generator(device=dev).manual_seed(0)
    p = ssm.ssm_init(g, cfg)
    cache = ssm.ssm_decode_init(cfg, b, torch.bfloat16, dev)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=g,
                                    device=dev))
    cache["ssd"].copy_(0.5 * torch.randn(cache["ssd"].shape, generator=g,
                                         device=dev))
    projs = [(torch.randn((b, 1, cfg.d_model), generator=g, device=dev,
                          dtype=torch.bfloat16) @ p["in_proj"])[:, 0]
             for _ in range(K5_STEPS)]
    params = [p[n] for n in ("conv_w", "conv_b", "dt_bias", "a_log",
                             "d_skip", "norm")]

    def steps(mixer):
        c = {n: t.clone() for n, t in cache.items()}
        out = []
        for proj in projs:
            y = mixer(proj, c["conv"], c["ssd"], *params, K5_EPS)
            out.append((y, c["conv"].clone(), c["ssd"].clone()))
        return out

    def errors(got, want):
        return [(row_error(x[0], w[0]), torch.equal(x[1], w[1]),
                 ((x[2] - w[2]).abs().max() / w[2].abs().max()).item())
                for x, w in zip(got, want)]

    want = steps(k5ref.ssm_decode_mixer_ref)
    before = k5.launches
    errs = errors(steps(k5.ssm_decode_mixer), want)
    torch.cuda.synchronize()
    if k5.launches - before != 2 * K5_STEPS:
        raise AssertionError(f"K5: {k5.launches - before} launches over "
                             f"{K5_STEPS} steps")
    row = max(e[0] for e in errs)
    state = max(e[2] for e in errs)
    log(f"[6] K5 (B {b}, H {nh}, N {ns}, P {hd}, bfloat16) against its "
        f"plain version over {K5_STEPS} steps: row error "
        f"{[round(e[0], 5) for e in errs]} (limit {K5_ROW_TOL}), window "
        f"equal {[e[1] for e in errs]}, state error "
        f"{[f'{e[2]:.2e}' for e in errs]} (limit {K5_STATE_REL})")
    if not all(e[1] for e in errs) or row > K5_ROW_TOL \
            or state > K5_STATE_REL:
        raise AssertionError(f"K5 against its plain version: {errs}")
    faults = {}
    for fault in (1, 2, 3):
        fe = errors(steps(lambda *a: k5.ssm_decode_mixer_planted(
            *a, fault=fault)), want)
        caught = (max(e[0] for e in fe) > K5_ROW_TOL
                  or not all(e[1] for e in fe)
                  or max(e[2] for e in fe) > K5_STATE_REL)
        faults[fault] = (max(e[0] for e in fe), all(e[1] for e in fe),
                         max(e[2] for e in fe))
        log(f"[6] K5 planted fault {fault}: row error {faults[fault][0]:.4f}, "
            f"window equal {faults[fault][1]}, state error "
            f"{faults[fault][2]:.2e}: {'caught' if caught else 'MISSED'}")
        if not caught:
            raise AssertionError(f"K5 planted fault {fault} passed the check")

    # timing on cold state, as a decode step meets it (48 layers' state,
    # 1.2 GB, pass through the 50 MB L2): K5_LAYERS layers' caches in
    # turn.  Bytes: each input read once, each output written once, the
    # state read and written
    nbytes = (2 * b * nh * ns * hd * 4                 # state
              + b * (di + ch + nh) * 2                 # proj
              + 2 * b * (k - 1) * ch * 2               # conv window
              + (k * ch + ch + di) * 2 + 3 * nh * 4    # parameters
              + b * di * 2)                            # output
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    layers = [{n: t.clone() for n, t in cache.items()}
              for _ in range(K5_LAYERS)]
    turn = itertools.count()

    def in_turn(mixer):
        def call():
            c = layers[next(turn) % K5_LAYERS]
            return mixer(projs[0], c["conv"], c["ssd"], *params, K5_EPS)
        return call

    ms, host = time_ms(in_turn(k5.ssm_decode_mixer), per_run=48)
    plain, phost = time_ms(in_turn(k5ref.ssm_decode_mixer_ref), runs=11,
                           per_run=8)
    ms2, host2 = time_ms(in_turn(k5.ssm_decode_mixer), per_run=48)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call = in_turn(k5.ssm_decode_mixer)
        for _ in range(4 * K5_LAYERS):
            call()
        torch.cuda.synchronize()
    split = {e.key.split("<")[0].split()[-1]: e.device_time_total / e.count
             for e in prof.key_averages()
             if e.count and "_kernel" in e.key}
    log(f"[6] K5 at the serve cell's layer, state cold ({K5_LAYERS} layers' "
        f"caches in turn): {ms * 1e3:.3f} / {ms2 * 1e3:.3f} us (issued in "
        f"{host * 1e3:.2f} / {host2 * 1e3:.2f} us, two launches); under "
        f"the profiler {({n: round(us, 2) for n, us in split.items()})} "
        f"us; bound {bound * 1e3:.3f} us by bytes ({nbytes} B, "
        f"{bound / ms * 100:.1f} %); plain {plain * 1e3:.3f} us (issued in "
        f"{phost * 1e3:.2f} us)")
    return dict(name="ssm_decode", route="cuda",
                source="src/repro_torch/kernels/ssm_decode/ssm_decode.cu",
                replaces=None, max_row_err=row, max_state_err=state,
                ms=ms, ms_again=ms2, plain_ms=plain, bound_ms=bound,
                bound_by="bytes", library_ms=None, host_ms=host,
                plain_host_ms=phost, kernel_us=split, planted_faults=faults)


K6_ARCH = "qwen2-moe-a2.7b"
K6_SHAPES = (("decode", 4), ("prefill", 4 * 2048))   # tokens at the cell's
K6_LAYERS = 4          # layers' experts timed in turn in decode: 4.4 GB
K6_ROW_TOL = 0.1


def phase_k6(dev):
    """Phase 6, K6: held to its plain version with planted faults, then
    timed at the MoE serving cell's decode (4 tokens, 16 rows) and
    prefill (8,192 tokens, 32,768 rows) shapes beside its bound and the
    plain version.  Returns its entry of the ``kernels`` line."""
    import re
    import torch
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ref import row_error
    from repro_torch.kernels.moe_experts import ops as k6, ref as k6ref
    from repro_torch.models import moe
    build.build_all(["moe_experts", "moe_experts_faults"])
    report = build.build_logs["moe_experts"]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill "
                                         r"(?:stores|loads)", report)]
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
    log(f"[6] K6 ptxas: {len(regs)} kernels, registers {regs}, spill "
        f"bytes {sorted(set(spills))}")
    if not spills or any(spills):
        raise AssertionError(f"K6: ptxas reports spills {spills}")
    cfg = configs.get_config(K6_ARCH)
    d, ff, e, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
    e_pad = moe.padded_experts(e)
    g = torch.Generator(device=dev).manual_seed(0)
    layers = [moe.moe_init(g, cfg) for _ in range(K6_LAYERS)]
    weights = [(p["gate"], p["up"], p["down"]) for p in layers]
    out = {}
    for shape, tokens in K6_SHAPES:
        x = torch.randn((tokens, d), generator=g, device=dev
                        ).to(torch.bfloat16)
        _, _, top_e = moe.route(layers[0], cfg, x)
        se, order = torch.sort(top_e.reshape(-1), stable=True)
        off = torch.searchsorted(se, torch.arange(e_pad + 1, device=dev))
        rows = x[order // k]
        r, active = rows.shape[0], int((off[1:] > off[:-1]).sum())
        want = k6ref.moe_experts_ref(rows, off, *weights[0])
        got = k6.moe_experts(rows, off, *weights[0])
        again = k6.moe_experts(rows, off, *weights[0])
        err = row_error(got, want)
        log(f"[6] K6 {shape} ({r} rows, {active} experts with rows, bf16) "
            f"against its plain version: row error {err:.5f} (limit "
            f"{K6_ROW_TOL}), bit equal twice {torch.equal(got, again)}")
        if err > K6_ROW_TOL or not torch.equal(got, again):
            raise AssertionError(f"K6 {shape} against its plain version")
        faults = {}
        for fault in (1, 2, 3):
            faults[fault] = row_error(k6.moe_experts_planted(
                rows, off, *weights[0], fault=fault), want)
            log(f"[6] K6 {shape} planted fault {fault}: row error "
                f"{faults[fault]:.4f}: "
                f"{'caught' if faults[fault] > K6_ROW_TOL else 'MISSED'}")
            if faults[fault] <= K6_ROW_TOL:
                raise AssertionError(f"K6 planted fault {fault} passed")
        turn = itertools.count()

        def in_turn(fn):
            # decode meets each layer's experts cold: layers in turn
            def call():
                w = weights[next(turn) % K6_LAYERS] if shape == "decode" \
                    else weights[0]
                return fn(rows, off, *w)
            return call

        ms, host = time_ms(in_turn(k6.moe_experts),
                           per_run=48 if shape == "decode" else 8)
        # the plain loop reads the offsets on the host: timed with a
        # synchronise on each side of 4 calls
        plain_call = in_turn(k6ref.moe_experts_ref)
        plain_call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            plain_call()
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3 / 4
        nbytes = active * 3 * d * ff * 2 + 2 * r * d * 2
        nflops = 6 * r * d * ff
        bound = max(nbytes / HBM_BYTES_PER_S, nflops / BF16_OPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S > nflops / BF16_OPS_PER_S \
            else "operations"
        log(f"[6] K6 {shape}: {ms * 1e3:.3f} us (issued in "
            f"{host * 1e3:.2f} us, two launches), {nflops / ms / 1e9:.1f} "
            f"TFLOP/s; bound {bound * 1e3:.3f} us by {by} ({nbytes} B, "
            f"{nflops} FLOP; {bound / ms * 100:.1f} %); plain "
            f"{plain * 1e3:.3f} us (host clock, synchronised)")
        out[shape] = dict(rows=r, active=active, ms=ms, host_ms=host,
                          bound_ms=bound, bound_by=by, plain_ms=plain,
                          row_err=err, planted_faults=faults)
    del layers, weights
    return dict(name="moe_experts", route="cuda",
                source="src/repro_torch/kernels/moe_experts/moe_experts.cu",
                replaces=None, library_ms=None, **{
                    f"{shape}_{key}": v for shape, o in out.items()
                    for key, v in o.items()})


def phase_dryrun(dev):
    """Phase 5j: the dry run's cells on the card, then one train step's
    counts, real against fake, and its roofline floor against its time
    (module docstring)."""
    import os
    import subprocess
    import tempfile

    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch import card_line, configs
    from repro_torch.configs import shapes
    from repro_torch.launch import dryrun, roofline as rf
    from repro_torch.train import tree as T
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    card = card_line()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as out:
        procs = [(cell, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cell[0], "--shape", cell[1], "--mesh", cell[2], "--out", out],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for cell in DRYRUN_CELLS]
        for (arch, shape, mesh), proc in procs:
            try:
                text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
            finally:
                proc.kill()
            if proc.returncode:
                raise AssertionError(f"dry run {arch} {shape} {mesh}: rc "
                                     f"{proc.returncode}: {text[-3000:]}")
            with open(os.path.join(out, f"{arch}__{shape}__{mesh}.json")) \
                    as f:
                row = json.load(f)
            t, coll = row["roofline"], row["collectives"]
            log(f"[5j] dry run {arch} x {shape} x {mesh} ({row['chips']} "
                f"fake ranks, {row['device']}): {row['status']}, trace "
                f"{row['trace_s']} s; a rank: {t['hlo_flops']:.6e} FLOPs, "
                f"{t['hlo_bytes']:.6e} bytes, collectives {coll}; terms "
                f"compute {t['compute_s']:.6e} s, memory "
                f"{t['memory_s']:.6e} s, collective {t['collective_s']:.6e}"
                f" s ({t['bottleneck']}); state "
                f"{row['analytic_state_bytes_per_device'] / 1e9:.6f} GB a "
                f"device; K4/K4b {row['kernels']}; constants for {card}")
            if row["status"] != "ok" or not (
                    t["hlo_flops"] > 0 and t["hlo_bytes"] > 0
                    and coll["total"] > 0):
                raise AssertionError(f"dry run row {row}")
    # the grounding: phase 5d's step, real and fake
    cfg = configs.get_config(TRAIN_ARCH)
    model = build_model(cfg)
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=20)
    spec = shapes.train_batch_specs(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                    rng=np.random.default_rng(2))
    counts = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = dryrun.fake_params(model, "cuda")
        ost = opt.init(params.tree())
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                device="cuda") for k, v in spec.items()}
        step = Trainer(model, ocfg, TrainerConfig()).build_step()
        step(params, ost, batch)           # as the real step, warm
        with rf.CountingMode() as m:
            step(params, ost, batch)
        counts["fake"] = m
    del params, ost, batch
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    ost = opt.init(params.tree())
    batch = {k: torch.as_tensor(v, device=dev) for k, v in spec.items()}
    step = Trainer(model, ocfg, TrainerConfig()).build_step()
    params, ost, _ = step(params, ost, batch)          # warm up
    torch.cuda.synchronize()
    with rf.CountingMode() as m:
        params, ost, met = step(params, ost, batch)
    torch.cuda.synchronize()
    counts["real"] = m
    if any(isinstance(t, FakeTensor) for t in (met["loss"],
                                               *T.leaves(params.tree()))):
        raise AssertionError("grounding: the real step met a fake tensor")
    times = []
    for _ in range(GROUND_STEPS):
        t0 = time.perf_counter()
        params, ost, _ = step(params, ost, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del params, ost, batch, step
    torch.cuda.empty_cache()
    med = float(np.median(times))
    real, fake = counts["real"], counts["fake"]
    k = [(c.calls.get("repro::flash_attention", 0),
          c.calls.get("repro::flash_attention_bwd", 0)) for c in (real, fake)]
    compute_s, memory_s = real.flops / rf.PEAK_FLOPS, real.bytes / rf.HBM_BW
    floor = max(compute_s, memory_s)
    mf = rf.model_flops(cfg, TRAIN_BATCH * TRAIN_SEQ)
    log(f"[5j] grounding, {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ}, remat "
        f"{cfg.remat}, plain Trainer: real step {real.flops} FLOPs, "
        f"{real.bytes} bytes, collectives {real.collectives['total']}; "
        f"fake CUDA step {fake.flops} FLOPs, {fake.bytes} bytes; K4/K4b "
        f"counted (real, fake) {k}; terms compute {compute_s * 1e3:.3f} "
        f"ms, memory {memory_s * 1e3:.3f} ms (floor {floor * 1e3:.3f} ms); "
        f"measured step median {med * 1e3:.3f} ms of "
        f"{[round(x * 1e3, 3) for x in times]}; model FLOPs {mf:.6e}, "
        f"{mf / med / rf.PEAK_FLOPS:.4f} of the bf16 peak; floor / time "
        f"{floor / med:.4f}; {card}")
    want = (K4_PER_LAYER_STEP * cfg.n_layers,
            K4B_PER_LAYER_STEP * cfg.n_layers)
    if (real.flops, real.bytes) != (fake.flops, fake.bytes) or \
            k != [want, want]:
        raise AssertionError(f"grounding: real and fake counts differ, or "
                             f"K4/K4b (real, fake) {k} are not {want}")
    if floor > med:
        raise AssertionError(f"grounding: the roofline floor "
                             f"{floor * 1e3:.3f} ms exceeds the measured "
                             f"{med * 1e3:.3f} ms: a count is wrong")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels.ddt import ops as k2   # fails outside a checkout
    from repro_torch.kernels.checksum import ops as k3
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.kernels.matcher import ops as k1
    from repro_torch import card_line, configs
    from repro_torch.core import matching
    from repro_torch.models.model import build_model
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain versions
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    empty = phase_build()
    phase_k1(dev)
    phase_k2(dev)
    phase_k3(dev)
    phase_k4(dev)
    # the main path: launches are counted from here to the end of phase 5
    k1.launches = k2.launches = 0
    steps, replay = phase_main_path(dev)
    spin, raw, calls = phase_ingest(dev)
    launches = {"match": k1.launches, "ddt_gather": k2.launches}
    log(f"[5] main-path launches: K1 {launches['match']} (= {steps} NIC "
        f"steps + {calls} ingest calls), K2 {launches['ddt_gather']} "
        f"(= {calls} ingest calls)")
    if launches != {"match": steps + calls, "ddt_gather": calls}:
        raise AssertionError(f"main path launches {launches}")
    # the checksum path and the serving path, each counted on its own
    k3.launches = 0
    reqs, ck_calls = phase_checksum_path(dev)
    launches["checksum"] = k3.launches
    k4.launches = 0
    captured, k4_errs, launches["flash_attention"], serve = phase_serve(dev)
    n_layers = configs.get_config(SERVE_ARCH).n_layers
    log(f"[5b] path launches: K3 {launches['checksum']} (= {ck_calls} "
        f"batch calls), K4 {launches['flash_attention']} (= 2 prefills x "
        f"{n_layers} layers)")
    if (launches["checksum"], launches["flash_attention"]) != (
            ck_calls, 2 * n_layers):
        raise AssertionError(f"path launches {launches}")
    # the moe, ssm and hybrid families, each arch's serving counted on its
    # own (serve_family zeroes K4's count before each prefill)
    launches["families"], fam_captured = phase_families(dev)
    want = {arch: 2 * len(k4_calls(build_model(configs.get_config(arch))))
            for arch, _, _, _ in FAMILIES}
    want[f"{PUBLISHED_MOE[0]} (published)"] = 2 * configs.get_config(
        PUBLISHED_MOE[0]).n_layers
    log(f"[5e] path launches: K4 {launches['families']} (= 2 prefills x "
        f"the attn/local layers, {want})")
    if launches["families"] != want:
        raise AssertionError(f"family path launches {launches['families']}")
    # the encdec and vlm families, each arch's serving counted on its own
    launches["modal"], modal_captured = phase_modal(dev)
    want = {arch: 2 * len(k4_calls(build_model(configs.get_config(arch))))
            for arch, _, _ in MODAL_FAMILIES}
    log(f"[5f] path launches: K4 {launches['modal']} (= 2 prefills x the "
        f"K4 calls of a prefill, {want})")
    if launches["modal"] != want:
        raise AssertionError(f"modal path launches {launches['modal']}")
    # the fabric and MPI path, counted on its own: K1 once per NIC step,
    # and a node steps only on ticks its link delivered frames
    k1.launches = 0
    fabs, comm, snap, fabric_secs = phase_fabric(dev)
    launches["match_fabric"] = k1.launches
    steps, reads = _fabric_counts(fabs)
    ticks = sum(f.now for f in fabs)
    node_ticks = sum(f.now * len(f.nodes) for f in fabs)
    log(f"[5c] path launches: K1 {launches['match_fabric']} (= {steps} NIC "
        f"steps, the busy node-ticks of {node_ticks} node-ticks over "
        f"{ticks} ticks on the card); {reads} host reads, "
        f"{reads / steps:.2f} a busy node-tick; phase {fabric_secs:.1f} s")
    if launches["match_fabric"] != steps or not 0 < steps < node_ticks:
        raise AssertionError(f"fabric path: K1 {launches['match_fabric']}, "
                             f"{steps} NIC steps, {node_ticks} node-ticks")
    # the training path, counted on its own
    captured_bwd, launches["train"], k4b_err, train_step = phase_train(dev)
    # the families that fit one card, each arch's training counted on its
    # own (train_family zeroes K4's and K4b's counts before its steps)
    launches["train_families"], family_captured = phase_train_families(dev)
    log(f"[5g] path launches (K4, K4b): {launches['train_families']} (= "
        f"{TRAIN_FAMILY_STEPS} steps x "
        f"{ {a: (f, b) for a, _, f, b, _ in TRAIN_FAMILIES} })")
    kernels = phase_kernels(dev, launches, spin, reqs, captured, k4_errs,
                            empty, captured_bwd, k4b_err, fam_captured,
                            modal_captured, family_captured)
    kernels.append(phase_k5(dev))
    kernels.append(phase_k6(dev))
    del captured_bwd, fam_captured, modal_captured, family_captured
    # last, because the profiler's tracing may slow later launches: the
    # matching stage in both forms, one ingest call, one Fig 10 step (the
    # complex stream's first batch, replayed), a prefill and a decode step
    nic, st, batch = replay
    engine, prompt = serve
    state = engine.prefill(prompt)
    comm.restore(snap)          # the allreduce at its mid-run checkpoint
    steps0 = sum(n.steps for n in comm.nodes)
    for what, fn in (("match_batch", lambda: matching.match_batch(
                          batch, nic.tables)),
                     ("earlier matching stage", lambda: match_batch_earlier(
                         batch, nic.tables)),
                     ("SpinIngest call", lambda: spin(raw)),
                     ("NIC step", lambda: nic.step(st, batch)),
                     ("serving prefill", lambda: engine.prefill(prompt)),
                     ("serving decode step", lambda: engine.step(state)),
                     (f"train step ({TRAIN_ARCH}, {TRAIN_BATCH} x "
                      f"{TRAIN_SEQ} tokens)", train_step),
                     (f"allreduce tick {snap['fabric']['now']} ("
                      f"{ALLREDUCE_RANKS} ranks)",
                      lambda: comm.progress(1))):
        n_k, busy, wall, names, top = profile_step(
            fn, host=what.startswith("train step"))
        if what == "match_batch" and n_k != 1:
            raise AssertionError(f"match_batch ran {n_k} device kernels")
        log(f"[7] profiled {what}: {n_k} device kernels, device busy "
            f"{busy:.1f} us of {wall:.1f} us wall (idle share "
            f"{1 - busy / wall:.3f}, profiler on); commonest "
            f"{[(n[:60], c) for n, c in names]}; most device time "
            f"{[(n[:60], round(us, 1)) for n, us in top]}")
    log(f"[7] the profiled allreduce tick ran "
        f"{sum(n.steps for n in comm.nodes) - steps0} NIC steps")
    del engine, prompt, state, train_step
    # the Trainer's mesh branch, counted on its own (the counters zeroed
    # before each of its steps): here, where the earlier phases' models
    # are freed (two gemma3-1b trainers' state and a step's activations
    # need about 50 GB), and before the profiler has traced the largest
    # steps (after mamba2-780m's it saw no kernel)
    mesh = dict(zip(("flash_attention", "flash_attention_bwd"),
                    phase_mesh_trainer(dev)))
    for entry in kernels:
        if entry["name"] in mesh:
            entry["mesh_launches"] = mesh[entry["name"]]
    for arch, prompt_len, _, _ in FAMILIES:
        profile_family(dev, arch, prompt_len)
    for arch, prompt_len, _ in MODAL_FAMILIES:
        profile_family(dev, arch, prompt_len)
    for arch, seq, _, _, _ in TRAIN_FAMILIES:
        profile_train_family(dev, arch, seq)
    # last, after every profile
    phase_manual_dp(dev)
    phase_dryrun(dev)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
