#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught to carry on):

1. card    — name and power limit, as nvidia-smi reports them.
2. build   — every CUDA kernel of the port, compiled from ``csrc/`` with
             one nvcc per source, all started together.
3. kernels — each kernel against its plain PyTorch version on the card at
             the shapes the main path gives it; kernel, plain-version and
             library-call times (CUDA events, median of 20 after warm-up)
             beside the bound (the kernel's cost function: bytes moved at
             3.35 TB/s, f32 flops at 67 TFLOP/s; ``launch.hw``'s H100 SXM
             data-sheet peaks); each result
             repeats bit for bit; at the fc1_w leaf (SFL and classical)
             the call's device time apart from its host work (``queued_ms``:
             CUDA events around 20 calls queued behind a spin of the card),
             and the library call's the same way.
   conv    — the im2col kernel (the CNN's patch gather) against
             ``F.unfold`` bit for bit at a 16-client chunk's, eval's and one
             client's shapes, one launch a call; its time, device time,
             bound, plain-version and ``F.unfold`` times. Then one vmapped
             SGD step of 16 full-width clients with the port's convolution
             (the kernel's patches + f32 matmul), with the ``F.unfold``
             form it replaced and with cuDNN's ``F.conv2d``: gradient error
             against float64 on the CPU, times; the port's step (and 2
             local SGD steps) equal to the ``F.unfold`` form's bit for bit.
4. slice   — the port's main path through its user entry point,
             ``repro_torch.launch.femnist.run``: the paper topology
             (16 ONUs × 20 clients, N = 128, 8 local steps) on the
             full-width FEMNIST CNN, 3 rounds each of sfl_two_step and
             classical. Kernel launch counts are zeroed just before and
             read just after: agg_reduce 8 a trained round, im2col 2 a
             chunk-step and 2 an eval; the upstream accounting is checked.
5. parity  — one round on the card and on the CPU, at reduced width and
             at full width: the same involvement, parameters within
             atol 1e-4 after 1 local step (the gap after 8 is printed).
6. compression kernels — quantize, dequantize and the top-k mask (row
             forms) bit for bit against their plain versions, the fused
             aggregate + quantize (its θ bit for bit segment_agg_reduce's,
             its q within one level of the plain version), at the shapes
             the compressed rounds give them; times as in phase 3, the
             fused form's device time by ``queued_ms``, and
             torch.topk's threshold time on its own line.
7. compressed slice — launch.run at full width, 3 rounds each of
             sfl_two_step int8 (the fused route), sfl_two_step int4 with
             error feedback and classical top-k (1%); every kernel's count
             zeroed before each run and checked against the routing table
             after it; the upstream billed at the compressed wire size.
8. compressed parity — one round of H = 1 at reduced width on the card
             and on the CPU, sfl_two_step int8 and classical top-k, the
             same noise fed to both: equal involvement, parameters within
             one quantization level (or top-k threshold) of each other.

9. lm kernels — flash attention, the RG-LRU scan and the RWKV6 scan
             against their plain versions at the shapes the serve path
             gives them (recurrentgemma-9b's windowed MQA prefill, its
             ragged P + 1 prefill and a window-free case on the bf16
             tensor-core route, the windowed prefill in f32 on the
             CUDA-core route; the RG-LRU prefill and decode shapes; the
             RWKV6 prefill with and without an initial state on the
             chunked route and its decode step on the decode route); times
             as in phase 3, bounds at the card's bf16 tensor-core rate (989
             TFLOP/s) for bf16 attention and its f32 rate for f32
             attention; the RWKV6 bound is the bytes or the chunked form's
             matrix products at the TF32 rate (495 TFLOP/s), whichever is
             larger; ``scaled_dot_product_attention`` as
             flash's library call; a torch.profiler breakdown of the RWKV6
             prefill's three launches and of its decode step, the RG-LRU
             scan's device time (``queued_ms``) at both shapes and its
             decode call's wall time on the host clock. Flash also at the
             prefill shapes of phase 10b's models (GQA 32 -> 4 at hd 64,
             MHA 32 at hd 64, GQA 64 -> 8 at hd 128), SDPA ``is_causal``
             beside it.
10. serve  — ``repro_torch.launch.serve.run`` at full width for
             recurrentgemma-9b and rwkv6-3b: batch 4, a 4096-token prompt,
             32 greedy decode steps, twice (cold, then warm on the same
             weights and prompt); launch counts zeroed before each run and
             checked against the routing table after it, route by route
             (bf16 prefill attention on the tensor-core flash route, RWKV6
             prefill on the chunked route and every decode step on the
             decode route); a torch.profiler breakdown of one warm
             prefill (device time by kernel, busy share); every logit
             finite; [prefill(P) then decode(token P)] against prefill(P + 1)
             within 5% of the largest logit, and within 1e-4 of it with the
             same weights upcast to f32 (rounding is all that differs).
10b. family serve — the same for the families of the MoE block, the
             frame frontend and cross-attention: qwen3-moe-30b-a3b (128
             experts top-8, 30.1e9 parameters) and musicgen-large (a fresh
             frame at every decode step) at full width and depth,
             llama-3.2-vision-90b at full width cut to one unit (4 self- and
             1 cross-attention layers; 1024 media tokens at prefill and
             every decode step); the memory reckoned beside the measured
             peak. The MoE consistency check runs on the model's first 4
             layers at capacity factor n_experts / top_k (no drops) and
             decodes from prefill(P + 1)'s own cache; a row whose router
             top-k set at position P differs between the two routes is
             printed and not held in bf16 (every row must agree in f32).
11. lm parity — reduced width, card against CPU on the same weights and
             tokens: prefill logits and caches and 3 teacher-forced decode
             steps, f32 within 1e-4 and bf16 within 0.08 (qwen3-moe in f32
             only: bf16 rounding splits router near ties).

12. train kernels — the forward kernels' per-row log-sum-exp on both
             routes against the plain version's (torch.logsumexp of its
             masked scores), and flash attention's backward kernel against
             autograd of the plain version and against its plain version at
             qwen2-0.5b's, olmo-1b's and qwen3-moe-30b-a3b's train shapes
             (8 × 2048 tokens, the bf16 wgmma route), olmo-100m's (the
             training example's, 8 × 256, MHA 8 heads), recurrentgemma-9b's
             windowed MQA shape (hd 256, the CUDA-core route), a ragged S
             and an f32 case; two
             calls on the same inputs give the same bits; times as in phase
             3, the bound at the bf16 tensor-core rate (10·hd flops a
             visible pair) or the bytes, the backward of
             ``scaled_dot_product_attention`` as the library call; at both
             train shapes the forward's time with and without the
             log-sum-exp beside the forward of
             ``scaled_dot_product_attention(is_causal=True)``.
   scan bwd kernels — the RG-LRU backward kernel at recurrentgemma-9b's
             train shape (8, 2048, 4096), with and without h0 and dh_last,
             bit for bit against its plain version; the RWKV6 backward at
             rwkv6-3b's (8, 48, 2048, 64) bf16, with and without s0 and
             dS_final, a ragged S and an f32 case, against its plain version
             (2e-3·|plain| + 1e-3·max of each gradient; bf16 dr, dk, dv
             2^-7·|plain|); both against autograd of the plain forwards
             (the RG-LRU's within 1e-5·|a| + 1e-6·max); two calls give the
             same bits; times as in phase 3 beside the forward's at the same
             shape, the bound the bytes (the RWKV6 backward's products at
             the TF32 rate beside them).
13. train  — ``repro_torch.launch.train.run`` at full width as a user
             calls it (batch 8, seq 2048, lr 3e-4): qwen2-0.5b (adamw) 4
             steps with --micro 1, checkpointing every 2 steps; a second
             run resumes at step 2 (its losses printed beside the first
             run's, held within 1e-2 relative: nothing makes the card's sums
             repeat their order between runs); 4 steps with --micro
             2; olmo-1b (adamw) 3 steps; rwkv6-3b (sgdm, 32 layers) 3 steps;
             recurrentgemma-9b (sgdm) at full width with its depth cut to 5
             layers (one unit and the tail), 3 steps; qwen3-moe-30b-a3b
             (sgdm) at full width cut to 4 layers, 3 steps. Launch counts zeroed
             before each run and checked after it against the routing table
             (each layer's forward once a micro-batch in the tail and twice
             in a unit, remat's recompute; each attention, RG-LRU and RWKV6
             layer's backward once: flash's three launches by route, the
             RG-LRU's one, the RWKV6's three); every loss and gradient norm
             finite; the state reckoned at the update, step s cold and warm,
             tokens/s, peak memory; a torch.profiler breakdown of one warm
             step of each run that neither checkpoints nor resumes.
14. train parity — reduced width, card against CPU: one train step (sgd
             and adamw) of qwen2-0.5b, olmo-1b, rwkv6-3b,
             recurrentgemma-9b and qwen3-moe-30b-a3b (f32 only) from the same
             weights and tokens, loss and
             every parameter within 1e-4 in f32 and 0.08 in bf16; on the
             card each backward kernel launched as the routing table says.

15. collectives — the SFL aggregation's collective forms on NCCL, a world
             of one (init_process_group("nccl") through a file rendezvous, a
             (1, 1) ("pod", "data") mesh on the card; no gloo): the
             one-row quantize and dequantize at qwen2-0.5b's largest gradient
             leaf (the 151,936 x 896 embedding) against their plain versions;
             make_weighted_gradient_aggregator on qwen2-0.5b's full-width
             gradient shapes (499,540,864 elements, bf16): two_step and
             classical equal local / K bit for bit (every collective the
             identity), two_step int8 within one level of it, one quantize
             launch a leaf; the median of 20 CUDA-event timings of each mode;
             then qwen2-0.5b at full width, batch 8 x 2048, adamw, seed 0, 3
             steps with mesh=None, with gspmd on the mesh (its losses the
             mesh=None losses bit for bit) and with two_step_int8 on the mesh
             (its step-0 loss gspmd's to f32 rounding, the later ones within
             1e-2; one quantize and one dequantize launch a gradient leaf and
             step): warm step times, peak memory, and the int8 transport's
             added ms a step from 6 more steps of each mesh run in turns.

16. transport — the event-simulator transport and the strategies that
             ride it, through ``launch.femnist.run`` at full width (the
             FEMNIST CNN, H = 8, batch 10, lr 0.06, seed 0, N = 128): (a)
             the paper's PON of 16 ONUs × 20 clients with ``fl_priority``
             grants, 2 wavelengths and background load 0.3, 3 rounds each
             of sfl_two_step and classical, then one round of each under
             fifo, tdma and ipact; the transport columns (involved,
             upstream_mbits, uplink_models, grant_delay_s, n_fl_grants,
             bg_mbits_served) equal, exactly, a run of the same config on
             the CPU at reduced width. (b) The forest of 4 PONs × 16 ONUs ×
             20 clients (1,280 clients, 64 ONUs), the same transport
             knobs: 3 rounds each of hier_sfl, sfl_two_step and classical,
             then hier_sfl with int8 tiers; per-segment Mbits against the
             closed-form budget (hier_sfl's trunk one model, its wire size
             when compressed); launches against the routing table (24 a
             trained hier_sfl round: θ, Φ and Ψ on every leaf; under int8
             the fused θ route and the Φ and Ψ row quantizers); one round of
             H = 1 at reduced width card vs CPU (1e-4; int8 within one
             level of every row it sums, the same noise on both). (c) The
             fast and hybrid engines: hier_sfl's forest round under each
             (fast equal to the event engine exactly), and the forest's
             transport alone for each strategy and engine, each engine's
             host ms a round beside the rounds' wall_s, train_host_s and
             aggregate_host_s. (d) agg_reduce at the forest's shapes at the
             fc1_w leaf: θ (128 rows, 64 segments), Φ (64 rows, 4), Ψ (4
             rows, 1), beside ``torch.mm`` by the segment matrix; the fused
             form at θ, quantize and dequantize at Φ and Ψ (dequantize at θ
             too). ``femnist.generate`` of 320 and 1,280 clients is timed
             on the host and each population made once.

17. runtime — the event-driven runtime (``runtime.Orchestrator``) through
             ``launch.femnist_async.run`` at full width (the FEMNIST CNN,
             H = 8, batch 10, lr 0.06, seed 0, N = 128): (a) 3 rounds of
             phase 4's setting through the sync policy and through the
             RoundLoop (twice: whether the card repeats itself bit for bit
             is printed; if it does, every column but the host-time keys
             and the parameters equal, else the transport columns equal and
             the rest within twice the two loops' spread); t_s 25 s a
             round. (b) The paper PON under fl_priority, 2 wavelengths, load
             0.3: semi_sync 3 windows of sfl_two_step and classical; fedbuff
             (buffer 8, N in flight) to 10 updates of sfl_two_step, fedopt
             (yogi) and sfl_two_step int8; fedbuff hier_sfl over phase 16's
             forest. (c) Each run's transport columns and upstream total
             equal a run of the same config on the CPU at reduced width.
             (d) Launches against the routing table: 8 agg_reduce an update
             with an arrival (24 under hier_sfl; int8 the fused route and
             dequantize_rows). (e) fedbuff to 3 updates at reduced width,
             H = 1, card vs CPU, uncompressed and int8 with the same noise:
             parameters within 1e-4. (f) fedbuff under the fluid engine
             (``sim_engine="fast"``), card = CPU, beside the event engine's.
             (g) ``launch.train.run`` with the runtime driver against the
             loop driver: qwen2-0.5b at full width, batch 8 × 2048, adamw, 2
             steps, transport columns equal and losses within 1e-2
             relative. (h) ms a dispatch and an ``apply_updates`` (host
             clock, card synchronised), the simulator's host ms an update,
             simulated against wall seconds, peak memory; agg_reduce at fc1_w
             for 8 rows into 16, 64 and 1 segments beside its bound,
             ``torch.mm`` by the segment matrix and its plain version.

18. obs    — observability (``repro_torch.obs``) on the main paths: (a)
             phase 4's setting (3 rounds each of sfl_two_step and
             classical) untraced twice, then traced with a live session
             (trace, metrics, run bundle, health): the History against the
             untraced rows (bit for bit where the card repeats itself, else
             the transport exact and the rest within the loops' spread), the
             launches equal, the ``pon.upstream_mbits`` totals the rows' sums,
             one grant span per served FL job. (b) One classical round on
             phase 16's loaded paper PON and on its forest, untraced and
             traced in turns: the span count and the host ms tracing adds a
             round (the row's wall_s, card synchronised, and the transport's
             own host time). (c) fedbuff to 10 updates traced: the registry
             total equals the untraced run's. (d) A run bundle from the card
             and one from the CPU at reduced width (H = 1, 2 rounds), held
             by the port's ``diff_bundles`` (config hash, transport metrics,
             spans; the History at rtol 1e-4). (e) One torch.profiler window,
             in a process of its own, over one call of each kernel wrapper: each ``kernels.<name>``
             range once a call, the counters stepped as the calls launch,
             every device kernel of the port launched inside its range; the
             host cost at the RWKV6 and RG-LRU decode calls of the wrappers'
             test for a profiler and of an open range. (f)
             ``launch.train``'s CLI with qwen2-0.5b at full width, 2 steps,
             ``--report-out``: the bundle's ``backend.train_step_s`` count 2.
19. cost   — the H100 cost model (``launch.roofline``, ``launch.hw``, each
             kernel's cost function) against the card: (c) every kernel's
             cost function at its PERF.md §6 row's shape reproduces that
             row's Bound ms; (a) one warm qwen2-0.5b train step (batch 8 ×
             2048, adamw, remat full, as phase 13) and one rwkv6-3b
             prefill (4 × 4096) counted on the card equal the dry run's
             count on ``meta`` (flops by type and bytes, exactly), the
             kernels' reported launches their launch counters; (b) the
             compute term at most the measured warm time (flops at peak are
             a floor), mfu and the share of the roofline printed, the
             reckoned peak memory within 25% of ``max_memory_allocated``.
20. examples — each ``examples_torch/*.py`` through its ``main(argv)``
             in this process: train_femnist_sfl at full width (N = 128, 2
             rounds; then 1 round with ``--compress int8``),
             train_femnist_hier at full width (2 PONs, 1 round),
             train_femnist_async (the reduced CNN, fedbuff, 2 windows),
             quickstart, train_lm (olmo-100m at full width, 10 steps, a
             checkpoint under a temporary directory) and serve_lm
             (recurrentgemma-9b ``--smoke``); each example's wall time and
             launches by kernel, each kernel it must reach launched, every
             kernel it launched held against its plain version on the
             inputs of its first call at each signature the example gave it
             (``HeldCalls``: shapes, strides, types and scalar arguments),
             its output checked (rows and accuracy, the classical benchmark
             involving no more clients than SFL, finite losses, the
             checkpoint, the tokens' shape).
21. fsdp   — FSDP over "data" and MoE over data ranks on NCCL with a
             world of one (a ("pod", "data", "model") mesh of (1, 1, 1),
             phase 15's file rendezvous): qwen3-moe-30b-a3b at full width
             cut to 4 layers (phase 13's setting: bf16, remat full, batch
             8 × 2048, sgdm, lr 3e-4), 2 steps each with mesh=None, under
             the FSDP rules (every gather and reduce-scatter a copy on one
             rank) and with ``transport="two_step_int8"`` three ways: on
             full replicas over "data", under FSDP, and under TP + FSDP:
             FSDP's losses and parameters against mesh=None's (bit for bit
             or by how much), the int8 step-0 loss within 1e-6 of FSDP's,
             each sharded int8 way's losses and parameters against the
             replica int8 way's, the router's all-reduced statistics against
             the local ones; each way's warm step s, peak memory, and the
             bytes the gathers moved a step; flash attention (forward and
             backward), quantize_rows and dequantize_rows launched and held
             against their plain versions at the path's shapes
             (``HeldCalls``: the int8 hop's blocks).
22. tp     — tensor and expert parallelism over "model" on NCCL with a
             world of one (mesh ("data" 1, "model" 1)): qwen3-moe-30b-a3b
             cut to 4 layers and qwen2-0.5b, 4 steps each with mesh=None,
             TP and TP + FSDP, against mesh=None (bit for bit or by how
             much), the region's bytes a step; then flash attention and the
             two scans, forward and backward, at a 16-way rank's train
             shapes.
23. serve tp — serving over "model" on NCCL with a world of one (mesh
             ("data" 1, "model" 1), the reference's rules: FSDP over
             "data", tensor and expert parallelism over "model"):
             recurrentgemma-9b and rwkv6-3b at full width and depth,
             qwen3-moe-30b-a3b cut to 4 layers (capacity factor n_experts /
             top_k), each prefilling 4 × 4096 into a cache of 8192 and
             decoding 8 steps, greedy with mesh=None and fed those tokens
             through ``specs.make_prefill_step`` / ``make_serve_step`` on
             the mesh: logits against mesh=None's (bit for bit or by how
             much, within 0.08), launches against the routing table, every
             kernel call held against its plain version (``HeldCalls``);
             every mesh=None decode attention call against the same cache
             split into 16 sequence shards in one process
             (``layers.partial_decode_attention`` and the combine; within
             0.08): the sequence layout, which a world of one never takes;
             then flash attention and the two scans at a 16-way serving
             rank's shapes, prefill and decode.

Every bound (phases 3-23) comes from the kernels' cost functions
(``kernels.*_cost``) at ``launch.hw``'s peaks. Phases 4, 7, 10, 10b, 13,
15, 16, 17, 18, 20, 21, 22 and 23 are the main paths (the FEMNIST
round uncompressed and compressed, LM serving, LM training, the LM gradient
exchange, the event-simulator transport and hier_sfl, the event-driven
runtime, the traced runs, the examples, FSDP and MoE over data ranks,
training and serving over "model"). The last lines are the
``kernels`` JSON object and then ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.

A ``device_ms`` in the kernels line is always ``queued_ms``'s; the
torch.profiler breakdowns (phases 9, 10 and 13) only print, and fail the
run if they miss a launch of the port's kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# f32 sums in another order: the error scales with Σ|w·x| of each output,
# not with the (possibly cancelled) sum itself; one dropped or doubled row
# of 128 would be ~1e-2 of it
RTOL_OF_ABS_SUM, ATOL = 1e-4, 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, calls: int = 1000) -> float:
    """Host-clock time of one call over ``calls`` back-to-back calls, the
    card synchronised at both ends: the wall time of a call whose host work
    outlasts its device work (a decode step's)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def queued_ms(fn, calls: int = 20) -> float:
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls queued behind a ~50 ms spin of the card, so the host's work to
    enqueue them stays out of the window; fails if the card finished the
    spin before the host had queued them all."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    check(not start.query(), "queued_ms: the host queued the calls slower than the spin")
    end.synchronize()
    return start.elapsed_time(end) / calls


QUEUED = "CUDA events around 20 calls queued behind a spin of the card"


def _device_ms(row: dict, label: str, fn) -> None:
    """Add ``fn``'s device time a call (``queued_ms``) to its kernels-line
    row, and print it beside the call's time."""
    row["device_ms"], row["device_ms_by"] = queued_ms(fn), QUEUED
    print(f"device {label}: {row['device_ms']:.4f} ms a call of {row['ms']:.4f} ({QUEUED})")


def _card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_card() -> str:
    card = _card_name()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {sorted(build.SOURCES)} in {time.perf_counter() - t0:.2f} s "
          f"(into {build.BUILD_DIR.relative_to(ROOT)})")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_kernels():
    """agg_reduce against its plain version; returns the main case's row."""
    from repro_torch.kernels.agg_reduce import (agg_reduce_cost, segment_agg_reduce,
                                                segment_agg_reduce_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_fc1 = 3136 * 2048                      # fc1_w of the full-width CNN
    # On the main path SFL aggregates ~126 involved clients padded to 128
    # rows (client_chunk = 16) over 16 ONUs; classical ~8 involved clients
    # padded to 16 rows, one segment. The last three cases are off the path.
    cases = [  # (what, C, N, n_seg, dtype, split: device time apart, rows 1 and 1′)
        ("fc1_w, SFL step 1 (16 ONUs)", 128, n_fc1, 16, torch.float32, True),
        ("fc2_b, SFL step 1, scalar path", 128, 62, 16, torch.float32, False),
        ("fc1_w, classical (16 rows, 1 segment)", 16, n_fc1, 1, torch.float32, True),
        ("fc2_b, classical, scalar path", 16, 62, 1, torch.float32, False),
        ("off path: fc1_w, 128 rows, 1 segment", 128, n_fc1, 1, torch.float32, False),
        ("off path: fc1_w, bf16 input", 128, n_fc1, 16, torch.bfloat16, False),
        ("off path: odd N, scalar path", 128, 100_003, 16, torch.float32, False),
    ]
    main = None
    for what, C, N, n_seg, dtype, split in cases:
        x = torch.randn((C, N), generator=gen, device="cuda", dtype=dtype)
        keep = (torch.rand(C, generator=gen, device="cuda") > 0.2).float()
        wm = (torch.rand(C, generator=gen, device="cuda") * 400 * keep).contiguous()
        seg = np.random.default_rng(C + N).integers(0, n_seg, C)   # unsorted
        got = segment_agg_reduce(x, wm, seg, n_seg)
        want = segment_agg_reduce_plain(x, wm, seg, n_seg)
        abs_sum = segment_agg_reduce_plain(x.abs(), wm.abs(), seg, n_seg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= ATOL + RTOL_OF_ABS_SUM * abs_sum).all())
        del abs_sum
        ms = time_ms(lambda: segment_agg_reduce(x, wm, seg, n_seg))
        plain_ms = time_ms(lambda: segment_agg_reduce_plain(x, wm, seg, n_seg))
        library_ms = library_call = None
        if dtype == torch.float32:
            if n_seg == 1:
                library_call = lambda: torch.mv(x.t(), wm)   # noqa: E731
            else:
                S = torch.zeros((n_seg, C), device="cuda")
                S[torch.as_tensor(seg, device="cuda"), torch.arange(C, device="cuda")] = wm
                library_call = lambda: torch.mm(S, x)   # noqa: E731
            library_ms = time_ms(library_call)
        bound_ms, bound_by = agg_reduce_cost(C, N, n_seg, x.element_size()).bound()
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"kernel agg_reduce [{what}] C={C} N={N} n_seg={n_seg} "
              f"{str(dtype).split('.')[-1]}: max_abs_err {err:.3e} "
              f"(<= {ATOL} + {RTOL_OF_ABS_SUM}·Σ|w·x|) {'ok' if ok else 'FAIL'}; "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
              f"bound_ms {bound_ms:.4f} ({bound_by}, {100 * bound_ms / ms:.1f}% of bound)")
        check(ok, f"agg_reduce disagrees with its plain version [{what}]: {err}")
        check(torch.equal(got, segment_agg_reduce(x, wm, seg, n_seg)),
              f"agg_reduce does not repeat bit for bit [{what}]")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
        if split:   # the call's device time apart from its host work, and
            # the library call's the same way
            _device_ms(row, f"agg_reduce [{what}]", lambda: segment_agg_reduce(x, wm, seg, n_seg))
            print(f"device library [{what}]: {queued_ms(library_call):.4f} ms a call "
                  f"of {library_ms:.4f} ({QUEUED})")
        if main is None:
            main = row
        del x, got, want
        torch.cuda.empty_cache()
    for C, N in ((0, 1000), (128, 0)):        # the zero-length guards
        before = segment_agg_reduce.launches
        z = segment_agg_reduce(torch.zeros((C, N), device="cuda"),
                               torch.ones(C, device="cuda"), np.zeros(C, np.int64), 16)
        check(z.shape == (16, N) and not z.any()
              and segment_agg_reduce.launches == before,
              f"zero-length guard C={C} N={N}")
        print(f"kernel agg_reduce [guard] C={C} N={N}: zeros, no launch ok")
    return main


@contextlib.contextmanager
def _unfold_form():
    """While open, ``conv5_same`` gathers its patches with ``F.unfold``
    (ATen's im2col, one launch a sample): the form the port replaced."""
    import types

    import torch.nn.functional as F
    from repro_torch.models import femnist_cnn

    real = femnist_cnn.Im2colFn
    femnist_cnn.Im2colFn = types.SimpleNamespace(apply=lambda x: F.unfold(x, 5, padding=2))
    try:
        yield
    finally:
        femnist_cnn.Im2colFn = real


# (what, (B, C, H, W)): the im2col kernel's shapes on the main path; the
# first two are a 16-client chunk's (the kernels-line row is conv2's)
IM2COL_SHAPES = (("conv1, a 16-client chunk", (160, 1, 28, 28)),
                 ("conv2, a 16-client chunk", (160, 32, 14, 14)),
                 ("conv1, eval's batch", (496, 1, 28, 28)),
                 ("conv2, eval's batch", (496, 32, 14, 14)),
                 ("conv1, one client's batch", (10, 1, 28, 28)),
                 ("conv2, one client's batch", (10, 32, 14, 14)))


def _im2col_kernel() -> dict:
    """The im2col kernel against ``F.unfold`` (its plain version and the
    library call) bit for bit at ``IM2COL_SHAPES``, one launch a call;
    times and bounds. Returns the kernels-line row (conv2's chunk shape,
    the others under ``shapes``)."""
    import importlib

    import torch.nn.functional as F

    ki = importlib.import_module("repro_torch.kernels.im2col")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for what, shape in IM2COL_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        before = ki.im2col.launches
        got = ki.im2col(x)
        want = F.unfold(x, 5, padding=2)
        torch.cuda.synchronize()
        check(ki.im2col.launches == before + 1, f"im2col [{what}] launched "
              f"{ki.im2col.launches - before} times")
        check(torch.equal(got, want), f"im2col [{what}] differs from F.unfold")
        del got, want
        row = dict(ms=time_ms(lambda: ki.im2col(x)),
                   plain_ms=time_ms(lambda: ki.im2col_plain(x)),
                   library_ms=time_ms(lambda: F.unfold(x, 5, padding=2)))
        row["device_ms"], row["device_ms_by"] = queued_ms(lambda: ki.im2col(x)), QUEUED
        row["bound_ms"], row["bound_by"] = ki.im2col_cost(*shape).bound()
        row["tiling"] = ki.tiling(*shape, ki._sms(0))._asdict()
        print(f"kernel im2col [{what}] {shape}: equal to F.unfold bit for bit, one launch; "
              f"ms {row['ms']:.4f} device {row['device_ms']:.4f} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} (F.unfold) "
              f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}, "
              f"{100 * row['bound_ms'] / row['device_ms']:.1f}% of bound by device); "
              f"tiling {row['tiling']}")
        rows[what] = row
        del x
    main = dict(rows.pop("conv2, a 16-client chunk"), shapes=rows)
    check(main["bound_ms"] >= 0.5 * main["device_ms"],
          f"im2col at conv2's chunk shape: {main['device_ms']:.4f} ms, under half its "
          f"bound's rate ({main['bound_ms']:.4f} ms)")
    return main


def phase_conv() -> dict:
    """The CNN's convolutions as the path runs them. The im2col kernel
    against ``F.unfold`` at its shapes (``_im2col_kernel``). Then, 16
    clients under ``vmap``: the port's form (the kernel's patches + f32
    matmul), the ``F.unfold`` form it replaced and cuDNN's ``F.conv2d``,
    each layer alone on random inputs (no pooling, whose ties would route
    a gradient differently in f32 and f64): input and weight gradients
    against float64 on the CPU. Then a vmap'd local step of the full-width
    CNN (the gradients, and 2 SGD steps through ``core.fedavg.local_sgd``)
    with the port's form equal to the ``F.unfold`` form's bit for bit, and
    each form's step timed. Returns the kernels-line row of im2col."""
    import torch.nn.functional as F
    from torch.func import grad, grad_and_value, vmap

    from repro_torch import configs
    from repro_torch.core import fedavg
    from repro_torch.data import femnist
    from repro_torch.models import femnist_cnn

    row = _im2col_kernel()

    def cudnn_conv(x, w, b):
        return F.conv2d(x, w, b, padding=2)

    def conv_grads(conv, x, w, b, gy):
        return vmap(grad(lambda xi, wi, bi, gi: (conv(xi, wi, bi) * gi).sum(),
                         argnums=(0, 1)))(x, w, b, gy)

    def rel(a, ref):
        return float((a.double().cpu() - ref).abs().max()) / float(ref.abs().max())

    port_conv = femnist_cnn.conv5_same
    forms = (("im2col kernel + matmul (the port)", port_conv, contextlib.nullcontext),
             ("F.unfold + matmul (ATen im2col)", port_conv, _unfold_form),
             ("cuDNN F.conv2d", cudnn_conv, contextlib.nullcontext))
    gen = torch.Generator().manual_seed(1)
    for layer, c_in, hw, c_out in (("conv1", 1, 28, 32), ("conv2", 32, 14, 64)):
        ts = (torch.randn((16, 10, c_in, hw, hw), generator=gen),
              0.4 * torch.randn((16, c_out, c_in, 5, 5), generator=gen),
              torch.zeros((16, c_out)),
              torch.randn((16, 10, c_out, hw, hw), generator=gen))
        ref_x, ref_w = conv_grads(cudnn_conv, *(t.double() for t in ts))
        for name, conv, form in forms:
            with form():
                gx, gw = conv_grads(conv, *(t.cuda() for t in ts))
            ex, ew = rel(gx, ref_x), rel(gw, ref_w)
            print(f"conv [{name}] {layer} x16 clients: max error of the input "
                  f"gradient {ex:.3e}, of the weight gradient {ew:.3e} "
                  f"(of the largest entry; f64 reference)")
            if conv is port_conv:
                check(max(ex, ew) <= 1e-5,
                      f"the port's {layer} gradient errs by {max(ex, ew)} ({name})")

    cfg = configs.get("femnist_cnn")
    pc = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    clients, _ = femnist.generate(femnist.FemnistConfig(n_clients=16, seed=7))
    rng = np.random.default_rng(0)
    mbs = [femnist.client_minibatches(rng, c, 2, 10) for c in clients]
    b2 = {k: torch.from_numpy(np.stack([b[k] for b in mbs])).cuda() for k in mbs[0]}
    bc = {k: v[:, 0] for k, v in b2.items()}

    def step():
        return vmap(lambda bi: grad_and_value(lambda q: femnist_cnn.loss_fn(q, bi)[0])(pc))(bc)

    def local():
        return vmap(lambda bi: fedavg.local_sgd(pc, bi, femnist_cnn.loss_fn, 0.01, 2))(b2)

    (g1, l1), (p1, m1) = step(), local()
    with _unfold_form():
        (g0, l0), (p0, m0) = step(), local()
    torch.cuda.synchronize()
    check(torch.equal(l1, l0) and torch.equal(m1, m0), "conv: the vmap'd step's loss differs "
          "from the F.unfold form's")
    for k in pc:
        check(torch.equal(g1[k], g0[k]) and torch.equal(p1[k], p0[k]),
              f"conv: {k}'s gradient or 2-step parameters differ from the F.unfold form's")
    print("conv: a vmap'd step of 16 full-width clients (loss, every gradient) and 2 local "
          "SGD steps (loss, every parameter) equal the F.unfold form's bit for bit")
    for name, conv, form in forms:
        femnist_cnn.conv5_same = conv
        try:
            with form():
                ms = time_ms(step)
        finally:
            femnist_cnn.conv5_same = port_conv
        print(f"conv [{name}]: one SGD step of 16 full-width clients, ms {ms:.4f}")
    return row


def phase_slice():
    """The main path at full width; returns (launches by kernel: agg_reduce
    and im2col, classical's involvement)."""
    from repro_torch.kernels.agg_reduce import segment_agg_reduce
    from repro_torch.kernels.im2col import im2col
    from repro_torch.launch import femnist as launch
    from repro_torch.pon import MODEL_UPDATE_MBITS, PonConfig

    modes = ("sfl_two_step", "classical")
    n_sel, n_onus = 128, 16
    torch.cuda.reset_peak_memory_stats()
    segment_agg_reduce.launches = im2col.launches = 0
    t0 = time.perf_counter()
    res = launch.run(n_rounds=3, n_selected=n_sel, full=True, seed=0, modes=modes,
                     pon=PonConfig(n_onus=n_onus, clients_per_onu=20),
                     device="cuda")
    wall = time.perf_counter() - t0
    launches, gathers = segment_agg_reduce.launches, im2col.launches
    trained = chunk_steps = 0
    for mode in modes:
        loop = res[mode]["loop"]
        fc = loop.backend.fl
        for r in loop.history:
            print(f"slice {mode} round {r['round']}: involved {r['involved']:.0f}/"
                  f"{r['n_selected']} upstream_mbits {r['upstream_mbits']:.3f} "
                  f"uplink_models {r.get('uplink_models', 0):.0f} "
                  f"acc {r['acc']:.4f} eval_loss {r.get('eval_loss', float('nan')):.4f} "
                  f"wall_s {r['wall_s']:.3f} train_host_s {r.get('train_host_s', 0):.3f} "
                  f"aggregate_host_s {r.get('aggregate_host_s', 0):.4f}")
            check(0.0 <= r["acc"] <= 1.0, f"{mode} acc {r['acc']}")
            check("wire_mbits" not in r and "compress" not in r,
                  f"{mode}: an uncompressed row carries wire keys")
            if r["involved"] == 0:
                continue
            trained += 1
            chunk_steps += -(-int(r["involved"]) // fc.client_chunk) * fc.local_steps
            check(math.isfinite(r["eval_loss"]), f"{mode} eval_loss {r['eval_loss']}")
            if mode == "sfl_two_step":
                # one θ per active ONU crosses the PON, whatever N is
                check(r["upstream_mbits"] == r["uplink_models"] * MODEL_UPDATE_MBITS
                      and r["uplink_models"] <= n_onus,
                      f"SFL upstream {r['upstream_mbits']} vs "
                      f"{r['uplink_models']} active ONUs")
            else:
                # every selected client's model rides the slice
                check(r["upstream_mbits"] == n_sel * MODEL_UPDATE_MBITS
                      and r["uplink_models"] == r["involved"],
                      f"classical upstream {r['upstream_mbits']}")
        params = loop.backend.params
        check(all(bool(torch.isfinite(v).all()) for v in params.values()),
              f"{mode} params not finite")
        check(tuple(params["fc1_w"].shape) == (3136, 2048), "not the full-width CNN")
    print(f"slice: {trained} trained rounds, {launches} agg_reduce launches "
          f"(8 leaves per trained round), {gathers} im2col launches ({chunk_steps} "
          f"chunk-steps and {trained} evals, 2 each), wall {wall:.2f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches > 0 and launches == 8 * trained,
          f"agg_reduce launched {launches} times for {trained} trained rounds")
    check(gathers > 0 and gathers == 2 * (chunk_steps + trained),
          f"im2col launched {gathers} times for {chunk_steps} chunk-steps and "
          f"{trained} evals")
    return dict(agg_reduce=launches, im2col=gathers), res["classical"]["involved"]


def phase_parity() -> None:
    """One round on the card and on the CPU from the same initial
    parameters: at reduced width with N = 10, and at full width with N = 4
    (padded to 16 rows), where the CPU side stays a few seconds long.

    Held to atol 1e-4 after H = 1 local step. With the paper's H = 8 the
    gap is printed and not held: from this init the first step overshoots
    (loss ~80), and from the second step on some clients' trajectories
    amplify f32 rounding, up to past 1e-3 on any device, the CPU against
    float64 included."""
    from repro_torch import configs
    from repro_torch.bridge import params_to_jax
    from repro_torch.launch import femnist as launch
    from repro_torch.models import femnist_cnn
    from repro_torch.pon import PonConfig

    for width, full, n_sel in (("reduced", False, 10), ("full-width", True, 4)):
        cfg = configs.get("femnist_cnn")
        cfg = cfg if full else cfg.reduced()
        p0 = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        for steps in (1, 8):
            kw = dict(n_rounds=1, n_selected=n_sel, full=full, seed=0,
                      modes=("sfl_two_step",), local_steps=steps,
                      pon=PonConfig(n_onus=4, clients_per_onu=5), params=p0)
            card = launch.run(**kw, device="cuda")["sfl_two_step"]["loop"]
            cpu = launch.run(**kw, device="cpu")["sfl_two_step"]["loop"]
            check(card.history.column("involved") == cpu.history.column("involved"),
                  f"{width}: involvement differs between card and CPU")
            a = params_to_jax(card.backend.params)
            b = params_to_jax(cpu.backend.params)
            check(a["fc1_w"].shape == p0["fc1_w"].shape, f"{width}: fc1_w shape")
            diff = max(float(np.abs(a[k] - b[k]).max()) for k in a)
            held = steps == 1
            print(f"parity: {width} round, H={steps}, card vs CPU: involved "
                  f"{card.history.column('involved')} equal, params max |diff| "
                  f"{diff:.3e} ({'atol 1e-4' if held else 'not held'}), eval_loss "
                  f"{card.history.last()['eval_loss']:.6f} vs "
                  f"{cpu.history.last()['eval_loss']:.6f}")
            if held:
                check(diff <= 1e-4, f"{width}: card and CPU params differ by {diff}")


def _row_inputs(gen, R, N):
    x = torch.randn((R, N), generator=gen, device="cuda") * 1e-2
    u = torch.rand((R, N), generator=gen, device="cuda")
    m = (torch.arange(R, device="cuda") % 5 != 0).float()     # silent rows
    return x, u, m


def _report(name, what, err, ms, plain_ms, library_ms, bound_ms, bound_by, note=""):
    lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
    print(f"kernel {name} [{what}]: max_abs_err {err:.3e}{note}; ms {ms:.4f} "
          f"plain_ms {plain_ms:.4f} library_ms {lib} bound_ms {bound_ms:.4f} "
          f"({bound_by}, {100 * bound_ms / ms:.1f}% of bound)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_compression_kernels():
    """quantize / dequantize / top-k mask / fused agg + quantize against
    their plain versions; returns each kernel's row at its main shape."""
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels.agg_reduce import (agg_reduce_quant_cost, segment_agg_reduce,
                                                segment_agg_reduce_absmax,
                                                segment_agg_reduce_quant,
                                                segment_agg_reduce_quant_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_fc1 = 3136 * 2048
    k_fc1 = kq.topk_k(n_fc1, 0.01)
    main = {}
    # SFL θ: 16 ONU rows; classical top-k: ~127 involved clients padded to
    # 128 rows. fc2_b (N = 62) and an odd N take the scalar path.
    for what, R, N, is_main in (("fc1_w, SFL θ (16 ONUs)", 16, n_fc1, True),
                                ("fc2_b, SFL θ, scalar path", 16, 62, False),
                                ("odd N, scalar path", 16, 100_003, False)):
        x, u, m = _row_inputs(gen, R, N)
        for bits in (8, 4):
            qmax = float(2 ** (bits - 1) - 1)
            s = x.abs().amax(1).clamp_min(1e-12) / qmax
            q = kq.quantize_rows(x, u, s, qmax)
            qp = kq.quantize_rows_plain(x, u, s, qmax)
            torch.cuda.synchronize()
            check(torch.equal(q, qp), f"quantize_rows int{bits} differs [{what}]")
            ms = time_ms(lambda: kq.quantize_rows(x, u, s, qmax))
            plain_ms = time_ms(lambda: kq.quantize_rows_plain(x, u, s, qmax))
            row = _report("quantize_rows", f"{what} R={R} N={N} int{bits}", 0.0, ms,
                          plain_ms, None, *kq.quantize_cost(R, N, x.element_size()).bound(),
                          note=" (bit for bit)")
            if is_main and bits == 4:        # the int4 + EF run launches it
                main["quantize_rows"] = row
        xd = kq.dequantize_rows(q, s, m)
        check(torch.equal(xd, kq.dequantize_rows_plain(q, s, m)),
              f"dequantize_rows differs [{what}]")
        check(torch.equal(kq.dequantize_rows(q, s), kq.dequantize_rows_plain(q, s)),
              f"dequantize_rows without a mask differs [{what}]")
        ms = time_ms(lambda: kq.dequantize_rows(q, s, m))
        plain_ms = time_ms(lambda: kq.dequantize_rows_plain(q, s, m))
        library_ms = time_ms(lambda: torch.mul(q, s[:, None]))
        row = _report("dequantize_rows", f"{what} R={R} N={N}", 0.0, ms, plain_ms,
                      library_ms, *kq.dequantize_cost(R, N, True).bound(),
                      note=" (bit for bit; library: torch.mul(q, s), no row mask)")
        if is_main:
            main["dequantize_rows"] = row
        t = kq.topk_thresholds(x, kq.topk_k(N, 0.01))
        check(torch.equal(kq.topk_mask_rows(x, t, m), kq.topk_mask_rows_plain(x, t, m)),
              f"topk_mask_rows differs [{what}]")
        ms = time_ms(lambda: kq.topk_mask_rows(x, t, m))
        plain_ms = time_ms(lambda: kq.topk_mask_rows_plain(x, t, m))
        _report("topk_mask_rows", f"{what} R={R} N={N}", 0.0, ms, plain_ms, None,
                *kq.topk_mask_cost(R, N, x.element_size(), True).bound(), note=" (bit for bit)")
        if is_main:
            topk_ms = time_ms(lambda: kq.topk_thresholds(x, k_fc1))
            print(f"torch.topk threshold [fc1_w, R=16 N={N} k={k_fc1}]: ms {topk_ms:.4f}")
        del x, u, m, q, qp, xd
        torch.cuda.empty_cache()

    x, _, m = _row_inputs(gen, 128, n_fc1)
    t = kq.topk_thresholds(x, k_fc1)
    got, want = kq.topk_mask_rows(x, t, m), kq.topk_mask_rows_plain(x, t, m)
    check(torch.equal(got, want), "topk_mask_rows differs [classical fc1_w]")
    del got, want
    ms = time_ms(lambda: kq.topk_mask_rows(x, t, m))
    plain_ms = time_ms(lambda: kq.topk_mask_rows_plain(x, t, m))
    main["topk_mask_rows"] = _report(
        "topk_mask_rows", f"fc1_w, classical client δ R=128 N={n_fc1}", 0.0, ms,
        plain_ms, None, *kq.topk_mask_cost(128, n_fc1, x.element_size(), True).bound(),
        note=" (bit for bit)")
    topk_ms = time_ms(lambda: kq.topk_thresholds(x, k_fc1), reps=5, warmup=1)
    print(f"torch.topk threshold [fc1_w, classical R=128 N={n_fc1} k={k_fc1}]: "
          f"ms {topk_ms:.4f} (outside the kernel, per leaf per round)")
    del x, m, t
    torch.cuda.empty_cache()

    for what, C, N, n_seg in (("fc1_w, SFL (128 rows, 16 ONUs)", 128, n_fc1, 16),
                              ("fc2_b, SFL, scalar path", 128, 62, 16),
                              ("odd N, scalar path", 128, 100_003, 16)):
        x = torch.randn((C, N), generator=gen, device="cuda")
        keep = (torch.rand(C, generator=gen, device="cuda") > 0.2).float()
        wm = (torch.rand(C, generator=gen, device="cuda") * 400 * keep).contiguous()
        seg = np.random.default_rng(C + N).integers(0, n_seg, C)
        u = torch.rand((n_seg, N), generator=gen, device="cuda")
        theta, _ = segment_agg_reduce_absmax(x, wm, seg, n_seg)
        check(torch.equal(theta, segment_agg_reduce(x, wm, seg, n_seg)),
              f"fused pass A θ differs from segment_agg_reduce [{what}]")
        q, s = segment_agg_reduce_quant(x, wm, seg, n_seg, u, 8)
        qp, sp = segment_agg_reduce_quant_plain(x, wm, seg, n_seg, u, 8)
        s_theta = theta.abs().amax(1).clamp_min(1e-12) / 127.0
        check(torch.equal(s, s_theta)
              and torch.equal(q, kq.quantize_rows_plain(theta, u, s_theta, 127.0)),
              f"fused q differs from the unfused port route [{what}]")
        lvl = int((q.int() - qp.int()).abs().max())
        srel = float(((s - sp).abs() / sp).max())
        check(lvl <= 1 and srel <= 1e-5,
              f"fused q off by {lvl} levels, scales by {srel} [{what}]")
        del theta, qp
        ms = time_ms(lambda: segment_agg_reduce_quant(x, wm, seg, n_seg, u, 8))
        plain_ms = time_ms(lambda: segment_agg_reduce_quant_plain(x, wm, seg, n_seg, u, 8))
        row = _report("agg_reduce_quant", f"{what} C={C} N={N} n_seg={n_seg} int8",
                      float(lvl), ms, plain_ms, None,
                      *agg_reduce_quant_cost(C, N, n_seg, x.element_size()).bound(),
                      note=f" levels (θ bit for bit; scales rel {srel:.1e})")
        if "agg_reduce_quant" not in main:
            _device_ms(row, f"agg_reduce_quant [{what}]",
                       lambda: segment_agg_reduce_quant(x, wm, seg, n_seg, u, 8))
            main["agg_reduce_quant"] = row
        del x, u, q
        torch.cuda.empty_cache()
    return main


def _counters():
    from repro_torch.kernels import (dequantize_rows, quantize_rows,
                                     segment_agg_reduce, segment_agg_reduce_quant,
                                     topk_mask_rows)
    return {"agg_reduce": segment_agg_reduce, "agg_reduce_quant": segment_agg_reduce_quant,
            "quantize_rows": quantize_rows, "dequantize_rows": dequantize_rows,
            "topk_mask_rows": topk_mask_rows}


def phase_compressed_slice(classical_involved):
    """The compressed main path at full width; returns launches by kernel."""
    from repro_torch.fl.backends import backend_wire_scale
    from repro_torch.launch import femnist as launch
    from repro_torch.pon import MODEL_UPDATE_MBITS, PonConfig

    counters = _counters()
    runs = (  # (mode, compression, launches per trained round: the routing table)
        ("sfl_two_step", dict(compress="int8"),
         {"agg_reduce_quant": 8, "dequantize_rows": 8}),
        ("sfl_two_step", dict(compress="int4", error_feedback=True),
         {"agg_reduce": 8, "quantize_rows": 8, "dequantize_rows": 8}),
        ("classical", dict(compress="topk", topk_frac=0.01),
         {"topk_mask_rows": 8, "agg_reduce": 8}),
    )
    wire_want = {"int8": MODEL_UPDATE_MBITS / 4, "int4": MODEL_UPDATE_MBITS / 8}
    totals = dict.fromkeys(counters, 0)
    for mode, kw, per_round in runs:
        tag = f"{mode} {kw['compress']}" + (" + EF" if kw.get("error_feedback") else "")
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = launch.run(n_rounds=3, n_selected=128, full=True, seed=0, modes=(mode,),
                         pon=PonConfig(n_onus=16, clients_per_onu=20), device="cuda",
                         **kw)
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        loop = res[mode]["loop"]
        wire = MODEL_UPDATE_MBITS * backend_wire_scale(loop.backend)
        trained = 0
        for r in loop.history:
            print(f"compressed {tag} round {r['round']}: involved {r['involved']:.0f}/"
                  f"{r['n_selected']} wire_mbits {r['wire_mbits']} upstream_mbits "
                  f"{r['upstream_mbits']:.3f} uplink_models {r.get('uplink_models', 0):.0f} "
                  f"acc {r['acc']:.4f} eval_loss {r.get('eval_loss', float('nan')):.4f} "
                  f"wall_s {r['wall_s']:.3f} train_host_s {r.get('train_host_s', 0):.3f} "
                  f"aggregate_host_s {r.get('aggregate_host_s', 0):.4f}")
            check(r["compress"] == kw["compress"] and r["wire_mbits"] == wire,
                  f"{tag}: row wire {r['wire_mbits']} vs {wire}")
            check(wire == wire_want.get(kw["compress"], wire),
                  f"{tag}: wire_mbits {wire}")
            if mode == "sfl_two_step":
                check(r["upstream_mbits"] == r.get("uplink_models", 0) * wire,
                      f"{tag}: upstream {r['upstream_mbits']} vs "
                      f"{r.get('uplink_models')} θ × {wire}")
            else:
                check(r["upstream_mbits"] == r["n_selected"] * wire,
                      f"{tag}: upstream {r['upstream_mbits']} vs {r['n_selected']} × {wire}")
            if r["involved"] == 0:
                continue
            trained += 1
            check(math.isfinite(r["eval_loss"]), f"{tag} eval_loss {r['eval_loss']}")
        params = loop.backend.params
        check(all(bool(torch.isfinite(v).all()) for v in params.values()),
              f"{tag} params not finite")
        want = {k: per_round.get(k, 0) * trained for k in counters}
        print(f"compressed {tag}: {trained} trained rounds, launches {counts} "
              f"(routing table: {want}), wall {wall:.2f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(trained > 0 and counts == want, f"{tag}: launches {counts}, want {want}")
        if mode == "classical":
            inv = loop.history.column("involved")
            print(f"compressed {tag}: involvement {inv} against {classical_involved} "
                  "uncompressed (phase 4)")
            check(min(inv) > max(classical_involved),
                  f"{tag}: involvement {inv} did not rise over {classical_involved}")
        for k in totals:
            totals[k] += counts[k]
    return totals


class _Levels:
    """Records, while active, the per-row scales (or top-k thresholds) the
    compressed round dequantizes with, and the round's K and weights: one
    quantization level of an aggregated element is Σ_r level_r · w_r / K."""

    def __enter__(self):
        from repro_torch.core import compression, fedavg
        self.mods = (compression, fedavg)
        self.saved = (compression._dequantize_kernel, compression.topk_mask_rows,
                      fedavg.aggregate)
        self.rows, self.seen = [], {}
        real_dq, real_tk, real_agg = self.saved

        def dq(q, s, mask=None):
            self.rows.append(s.detach().double().cpu())
            return real_dq(q, s, mask)

        def tk(x, t, mask=None):
            self.rows.append(t.detach().double().cpu())
            return real_tk(x, t, mask)

        def agg(deltas, weights, mask, onu_ids, n_onus, mode, **kw):
            out, stats = real_agg(deltas, weights, mask, onu_ids, n_onus, mode, **kw)
            self.seen.setdefault("K", float(stats["K"]))
            self.seen.setdefault("w", np.asarray(weights, np.float64))
            self.seen.setdefault("names", sorted(deltas))
            self.seen.setdefault("mode", mode)
            return out, stats

        compression._dequantize_kernel, compression.topk_mask_rows = dq, tk
        fedavg.aggregate = agg
        return self

    def __exit__(self, *exc):
        compression, fedavg = self.mods
        (compression._dequantize_kernel, compression.topk_mask_rows,
         fedavg.aggregate) = self.saved

    def bounds(self):
        w = self.seen["w"] if self.seen["mode"] == "classical" else None
        out = {}
        for name, lv in zip(self.seen["names"], self.rows):
            lv = lv.numpy()
            out[name] = float((lv * (w[:len(lv)] if w is not None else 1.0)).sum()) / self.seen["K"]
        return out


def phase_compressed_parity() -> None:
    """One compressed round of H = 1 at reduced width on the card and on
    the CPU, the same noise (drawn on the CPU per call) fed to both.
    θ or a client's δ is summed in another order on each device, so an
    element within an ulp of a rounding or threshold boundary may land on
    the other side: each element is held to one level of every row it sums
    (``_Levels``) plus 1e-5, and at most 0.1% of a leaf (at least one
    element) may be off by more than 1e-5."""
    from repro_torch import configs
    from repro_torch.bridge import params_to_jax
    from repro_torch.core import compression
    from repro_torch.launch import femnist as launch
    from repro_torch.models import femnist_cnn
    from repro_torch.pon import PonConfig

    def cpu_noise(self, call, shapes):
        g = torch.Generator().manual_seed(1000 + call)
        return [torch.rand(tuple(s), generator=g).to(self.device) for s in shapes]

    cfg = configs.get("femnist_cnn").reduced()
    p0 = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    saved = compression.CompressionState.uniform_noise
    compression.CompressionState.uniform_noise = cpu_noise
    try:
        for mode, kw in (("sfl_two_step", dict(compress="int8")),
                         ("classical", dict(compress="topk", topk_frac=0.01))):
            run_kw = dict(n_rounds=1, n_selected=10, seed=0, modes=(mode,), local_steps=1,
                          pon=PonConfig(n_onus=4, clients_per_onu=5), params=p0, **kw)
            card = launch.run(**run_kw, device="cuda")[mode]["loop"]
            with _Levels() as levels:
                cpu = launch.run(**run_kw, device="cpu")[mode]["loop"]
            check(card.history.column("involved") == cpu.history.column("involved"),
                  f"compressed parity {mode}: involvement differs")
            a, b = params_to_jax(card.backend.params), params_to_jax(cpu.backend.params)
            worst, flips = 0.0, 0
            for k, lvl in levels.bounds().items():
                diff = np.abs(a[k] - b[k])
                off = int((diff > 1e-5).sum())
                check(float(diff.max()) <= lvl + 1e-5
                      and off <= max(1, math.floor(1e-3 * diff.size)),
                      f"compressed parity {mode} {kw['compress']} {k}: max |diff| "
                      f"{float(diff.max())} vs one level {lvl}, {off} elements off")
                worst, flips = max(worst, float(diff.max())), flips + off
            print(f"compressed parity: {mode} {kw['compress']}, reduced, H=1, card vs "
                  f"CPU: involved {card.history.column('involved')} equal, params max "
                  f"|diff| {worst:.3e}, {flips} elements past 1e-5 (each within one "
                  "level)")
    finally:
        compression.CompressionState.uniform_noise = saved


# ---------------------------------------------------------------------------
# language-model serving: recurrentgemma-9b (flash attention + RG-LRU) and
# rwkv6-3b (RWKV6)
# ---------------------------------------------------------------------------

LM_ARCHS = ("recurrentgemma-9b", "rwkv6-3b")
SERVE = dict(batch=4, prompt_len=4096, gen=32)
# the model families of phase 10b, (config, its cut): qwen3-moe-30b-a3b and
# musicgen-large at full width and depth, llama-3.2-vision-90b at full width
# cut to one unit (4 self-attention layers and 1 cross-attention layer; its
# 100 layers would need ≈ 175 GB)
FAMILIES = (("qwen3-moe-30b-a3b", {}), ("musicgen-large", {}),
            ("llama-3.2-vision-90b", {"n_layers": 5}))
# serving's consistency check of an MoE model runs on its first layers at a
# capacity that drops nothing (see _serve_checks)
MOE_CHECK_LAYERS = 4


def _kernel_name(key: str) -> str:
    """A profiler key without its return type, namespace and arguments."""
    key = key.replace("(anonymous namespace)::", "")
    return (key[5:] if key.startswith("void ") else key).split("(")[0].strip()[:70]


PROFILE_MARGIN_S = 0.05   # idle card time at each end of a profiler session


def _device_profile(label: str, fn, kernels, calls: int = 1, top: int = 6) -> None:
    """Print the device time of ``calls`` calls of ``fn`` by kernel
    (torch.profiler's CUDA activity) beside the host clock's wall time:
    their ratio is the card's busy share over the calls. ``kernels`` lists
    the port's kernels as (names, wrapper, counter): the profiler must
    record one launch of the named kernels for each step of the wrapper's
    counter over the calls, or the run fails, since a session that misses
    launches reads too little device time.

    The profiler keeps only the device activity that falls inside its
    capture window, from its start to its stop on the host's clock, with
    the card's timestamps converted to that clock. Where the two clocks
    disagree by more than the idle time at either end of the window, the
    first or last launches are dropped: a session of short calls (the
    RWKV6 decode step) recorded 14 of its 20 launches late in a run on the
    H100. So the card idles ``PROFILE_MARGIN_S`` inside the window before
    the first call and after the last; the wall time excludes both, and
    the line printed gives where the device activity lies in the session
    beside where the calls ran on the host's clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    before = [getattr(wrapper, counter) for _, wrapper, counter in kernels]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_in = time.perf_counter()
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        time.sleep(PROFILE_MARGIN_S)
    wall = 1e3 * (t1 - t0) / calls
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    placed = (f"device activity {min(a for a, _ in spans) / 1e3:.3f}-"
              f"{max(b for _, b in spans) / 1e3:.3f} ms into the session"
              if spans else "no device activity")
    placed += f", the calls {1e3 * (t0 - t_in):.3f}-{1e3 * (t1 - t_in):.3f} ms on the host"
    # the wrappers' kernels.* ranges are annotations, not device work
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and not e.key.startswith("kernels.")]
    made = 0
    for (names, wrapper, counter), was in zip(kernels, before):
        want = getattr(wrapper, counter) - was
        seen = sum(e.count for e in events
                   if _kernel_name(e.key).split("<")[0] in names)
        check(seen == want, f"profile {label}: {seen} launches of {'/'.join(names)} "
                            f"recorded, {want} made ({placed})")
        made += want
    check(made > 0, f"profile {label}: none of the port's kernels launched")
    rows = sorted(((e.self_device_time_total / 1e3 / calls, e.count / calls,
                    _kernel_name(e.key)) for e in events), reverse=True)
    device = sum(ms for ms, _, _ in rows)
    print(f"profile {label}: device {device:.4f} ms of wall {wall:.4f} ms a call "
          f"({100 * device / wall:.1f}% busy; {placed}); top kernels: "
          + "; ".join(f"{name} {ms:.4f} ms x{n:g}" for ms, n, name in rows[:top]))


def _within(got, want, rtol, atol):
    """(max |got − want|, all within atol + rtol·|want|), in f32."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= atol + rtol * want.float().abs()).all())


def phase_lm_kernels():
    """flash_attention, rglru_scan and rwkv6_scan against their plain
    versions at the serve path's shapes; returns each kernel's main row."""
    import torch.nn.functional as F

    from repro_torch.kernels import (flash_attention, flash_attention_plain, rglru_scan,
                                     rglru_scan_plain, rwkv6_scan, rwkv6_scan_plain)
    from repro_torch.kernels.flash_attention import flash_attention_cost
    from repro_torch.kernels.rglru_scan import rglru_scan_cost
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cost
    gen = torch.Generator(device="cuda").manual_seed(2)
    main = {}
    B, H, KV, hd, win = 4, 16, 1, 256, 2048            # recurrentgemma-9b attention
    # kernel and plain version both compute in f32 and round the output to
    # the input type once: at most one bf16 step (2^-8 of the value) apart,
    # twice that across a binade boundary
    for what, S, window, dtype, is_main in (
            ("recurrentgemma-9b prefill, P = 4096", 4096, win, torch.bfloat16, True),
            ("ragged S: the P + 1 prefill", 4097, win, torch.bfloat16, False),
            ("no window", 4096, 0, torch.bfloat16, False),
            ("f32 route (the upcast model)", 4096, win, torch.float32, False)):
        # the serve path hands the kernel (B, S, heads, hd) activations transposed
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype).transpose(1, 2)
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype).transpose(1, 2)
        v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype).transpose(1, 2)
        counter = "launches_tc" if dtype == torch.bfloat16 else "launches_f32"
        before = getattr(flash_attention, counter)
        got = flash_attention(q, k, v, window=window)
        want = flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        check(getattr(flash_attention, counter) == before + 1,
              f"flash_attention [{what}] did not take its {counter} route")
        # bf16: both compute in f32 (the kernel's P in two bf16 halves) and
        # round to bf16 once; f32: the sums' order alone differs
        err, ok = (_within(got, want, 2.0 ** -7, 1e-5) if dtype == torch.bfloat16
                   else _within(got, want, 2e-5, 2e-5))
        check(ok, f"flash_attention disagrees with its plain version [{what}]: {err}")
        del got, want
        ms = time_ms(lambda: flash_attention(q, k, v, window=window))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, window=window),
                           reps=5, warmup=1)
        kx, vx = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
        if window:
            idx = torch.arange(S, device="cuda")
            mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None] - window)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                                        attn_mask=mask))
            del mask
        else:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                                        is_causal=True))
        del kx, vx
        row = _report("flash_attention", f"{what} B={B} H={H} KV={KV} S={S} hd={hd} "
                      f"window={window} {str(dtype).split('.')[-1]}, {counter[9:]} route",
                      err, ms, plain_ms, library_ms,
                      *flash_attention_cost(B, H, KV, S, hd, dtype, window).bound(),
                      note=(" (<= 2^-7·|plain|" if dtype == torch.bfloat16
                            else " (<= 2e-5 + 2e-5·|plain|")
                      + "; library: scaled_dot_product_attention, boolean window mask or "
                        "is_causal, KV expanded)")
        if is_main:
            main["flash_attention"] = row
        del q, k, v
        torch.cuda.empty_cache()
    main["flash_attention"]["family_shapes"] = _flash_family_shapes(gen)

    C = 4096                                            # recurrentgemma-9b rnn_width
    for what, S, is_main in (("prefill, P = 4096", 4096, True), ("decode step", 1, False)):
        a = torch.rand((B, S, C), generator=gen, device="cuda")
        b = torch.randn((B, S, C), generator=gen, device="cuda")
        h0 = torch.randn((B, C), generator=gen, device="cuda")
        out, h = rglru_scan(a, b, h0)
        want_o, want_h = rglru_scan_plain(a, b, h0)
        torch.cuda.synchronize()
        check(torch.equal(out, want_o) and torch.equal(h, want_h),
              f"rglru_scan differs from its plain version [{what}]")
        ms = time_ms(lambda: rglru_scan(a, b, h0))
        plain_ms = time_ms(lambda: rglru_scan_plain(a, b, h0), reps=5, warmup=1)
        row = _report("rglru_scan", f"{what} B={B} S={S} C={C} with h0", 0.0, ms, plain_ms,
                      None, *rglru_scan_cost(B, S, C, with_h0=True).bound(),
                      note=" (bit for bit)")
        # the call's device time apart from its host work
        _device_ms(row, f"rglru_scan {what}", lambda: rglru_scan(a, b, h0))
        if S == 1:
            print(f"rglru_scan decode step: call wall "
                  f"{host_ms(lambda: rglru_scan(a, b, h0)):.4f} ms (host clock, 1000 calls)")
        if is_main:
            main["rglru_scan"] = row
        del a, b, h0, out, want_o
        torch.cuda.empty_cache()

    Hp, hd, W = 48, 64, 64                              # rwkv6-3b: 40 heads padded to 48
    for what, S, with_s0, is_main in (("prefill, P = 4096", 4096, False, True),
                                      ("prefill from a state", 4096, True, False),
                                      ("decode step", 1, True, False)):
        r, k, v = (torch.randn((B, S, Hp, hd), generator=gen, device="cuda").bfloat16()
                   .transpose(1, 2) for _ in range(3))
        logw = -torch.exp(0.5 * torch.randn((B, S, Hp, hd), generator=gen, device="cuda")
                          ).transpose(1, 2)
        u = 0.5 * torch.randn((Hp, hd), generator=gen, device="cuda")
        s0 = torch.randn((B, Hp, hd, hd), generator=gen, device="cuda") if with_s0 else None
        counter = "launches_decode" if S == 1 else "launches_chunked"
        before = getattr(rwkv6_scan, counter)
        o, s = rwkv6_scan(r, k, v, logw, u, chunk=W, s0=s0)
        want_o, want_s = rwkv6_scan_plain(r, k, v, logw, u, chunk=W, s0=s0)
        torch.cuda.synchronize()
        check(getattr(rwkv6_scan, counter) == before + 1,
              f"rwkv6_scan [{what}] did not take its {counter} route")
        err_o, ok_o = _within(o, want_o, 2e-3, 2e-3)
        err_s, ok_s = _within(s, want_s, 2e-3, 2e-3)
        check(ok_o and ok_s, f"rwkv6_scan disagrees with its plain version [{what}]: "
                             f"o {err_o}, state {err_s}")
        del o, s, want_o, want_s
        ms = time_ms(lambda: rwkv6_scan(r, k, v, logw, u, chunk=W, s0=s0))
        plain_ms = time_ms(lambda: rwkv6_scan_plain(r, k, v, logw, u, chunk=W, s0=s0),
                           reps=5, warmup=1)
        row = _report("rwkv6_scan", f"{what} B={B} H={Hp} S={S} hd={hd} W={W} bf16 "
                      f"r/k/v{', from s0' if with_s0 else ''}, {counter[9:]} route",
                      max(err_o, err_s), ms, plain_ms, None,
                      *rwkv6_scan_cost(B, Hp, S, hd, W, r.dtype, with_s0).bound(),
                      note=" (<= 2e-3 + 2e-3·|plain|, o and state)")
        if is_main:
            main["rwkv6_scan"] = row
            _device_profile("rwkv6_scan prefill (its three launches)",
                            lambda: rwkv6_scan(r, k, v, logw, u, chunk=W, s0=s0),
                            _lm_kernels(), calls=3)
        elif S == 1:   # the decode route: its device time apart from the host's
            _device_profile("rwkv6_scan decode step",
                            lambda: rwkv6_scan(r, k, v, logw, u, chunk=W, s0=s0),
                            _lm_kernels(), calls=20)
        del r, k, v, logw
        torch.cuda.empty_cache()
    return main


# the prefill attention of phase 10b's models: (model, B, H, KV, S, hd), causal
# without a window, bf16 on the tensor-core route
FAMILY_FLASH = (("qwen3-moe-30b-a3b", 4, 32, 4, 4096, 64),
                ("musicgen-large", 4, 32, 32, 4096, 64),
                ("llama-3.2-vision-90b", 4, 64, 8, 4096, 128))


def _flash_family_shapes(gen) -> dict:
    """Flash attention against its plain version at the prefill shapes of
    phase 10b's models (GQA 32 -> 4 and 64 -> 8, MHA at 32 heads), as at
    the recurrentgemma-9b shapes; returns each shape's times and bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_cost
    out = {}
    for model, B, H, KV, S, hd in FAMILY_FLASH:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16().transpose(1, 2)
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").bfloat16().transpose(1, 2)
        v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").bfloat16().transpose(1, 2)
        before = flash_attention.launches_tc
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        check(flash_attention.launches_tc == before + 1,
              f"flash_attention [{model}] did not take its tensor-core route")
        err, ok = _within(got, want, 2.0 ** -7, 1e-5)
        check(ok, f"flash_attention disagrees with its plain version [{model}]: {err}")
        del got, want
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), reps=5, warmup=1)
        kx, vx = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True))
        del kx, vx
        row = _report("flash_attention", f"{model} prefill B={B} H={H} KV={KV} S={S} hd={hd} "
                      "window=0 bfloat16, tc route", err, ms, plain_ms, library_ms,
                      *flash_attention_cost(B, H, KV, S, hd, q.dtype).bound(),
                      note=" (<= 2^-7·|plain|; library: scaled_dot_product_attention "
                           "is_causal, KV expanded)")
        out[model] = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                          "bound_ms")}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def _lm_counters():
    from repro_torch.kernels import flash_attention, rglru_scan, rwkv6_scan
    return {"flash_attention": flash_attention, "rglru_scan": rglru_scan,
            "rwkv6_scan": rwkv6_scan}


def _lm_kernels():
    """The LM kernels for ``_device_profile``: (kernel names, wrapper,
    counter), one launch of a named kernel for each step of the counter."""
    c = _lm_counters()
    rwkv = c["rwkv6_scan"]
    return [(("flash_wgmma", "flash_fwd"), c["flash_attention"], "launches"),
            (("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_dkdv_wgmma",
              "flash_bwd_dq_wgmma"), c["flash_attention"], "launches_bwd"),
            (("rglru_ring", "rglru_scalar"), c["rglru_scan"], "launches"),
            (("rglru_bwd_ring", "rglru_bwd_scalar"), c["rglru_scan"], "launches_bwd"),
            (("rwkv6_states",), rwkv, "launches_chunked"),
            (("rwkv6_state_scan",), rwkv, "launches_chunked"),
            (("rwkv6_outputs",), rwkv, "launches_chunked"),
            (("rwkv6_decode",), rwkv, "launches_decode"),
            (("rwkv6_bwd_states", "rwkv6_bwd_state_scan", "rwkv6_bwd_grads"), rwkv,
             "launches_bwd")]


def _zero_launches(fn) -> None:
    """Zero a wrapper's launch count and its per-route counts."""
    for name in vars(fn):
        if name.startswith("launches"):
            setattr(fn, name, 0)


def _route_counts(fn) -> dict:
    return {name: getattr(fn, name) for name in sorted(vars(fn))
            if name.startswith("launches_")}


def _routing(cfg, gen: int):
    """Launches of one serve run: each attention layer's prefill goes through
    flash attention (decode attention is plain torch, as the reference's),
    each RG-LRU and RWKV6 layer through its scan in prefill and every step."""
    layers = list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern)
    return {"flash_attention": layers.count("attn"),
            "rglru_scan": layers.count("rglru") * (1 + gen),
            "rwkv6_scan": layers.count("rwkv") * (1 + gen)}


def _route_table(cfg, gen: int):
    """The same run by route: bf16 attention on the tensor-core route, the
    RWKV6 prefill on the chunked route and each decode step on the decode
    route."""
    layers = list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern)
    tc = cfg.dtype == "bfloat16"
    return {"flash_attention": {"launches_bwd": 0, "launches_bwd_fma": 0, "launches_bwd_tc": 0,
                                "launches_f32": 0 if tc else layers.count("attn"),
                                "launches_tc": layers.count("attn") if tc else 0},
            "rwkv6_scan": {"launches_bwd": 0, "launches_chunked": layers.count("rwkv"),
                           "launches_decode": layers.count("rwkv") * gen}}


def _serve_cfg(name: str, cut: dict, smoke: bool):
    """A served model's config: the named config, at reduced width with
    ``smoke``, its depth cut by ``cut``."""
    from repro_torch import configs
    cfg = configs.get_smoke(name) if smoke else configs.get(name)
    return dataclasses.replace(cfg, **cut) if cut else cfg


def _param_count(cfg) -> int:
    from repro_torch.models import transformer
    return sum(t.numel() for t in _leaves(transformer._build_params(cfg, None,
                                                                    torch.device("meta"))))


def _serve_reckoned_gib(cfg, B: int, P: int, gen: int) -> float:
    """Memory a serve run needs at its peak, reckoned: the weights, the
    attention layers' K/V caches (P + gen positions) twice (prefill's
    per-layer caches and the unit's stacked copy of them), four (B, P, d)
    activations and the largest transient of one prefill layer — the MoE
    slot grid of one sequence chunk (the experts' input and output at d,
    gate, up and product at d_ff), the dense MLP's gate, up, product and its
    f32 gate, or the cross-attention's f32 scores and probabilities of one
    query block."""
    from repro_torch.models import moe
    size = 2 if cfg.dtype == "bfloat16" else 4
    layers = list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern)
    kv = 2 * layers.count("attn") * 2 * B * (P + gen) * cfg.n_kv_heads * cfg.head_dim * size
    if cfg.n_experts:
        nc = max(1, min(cfg.moe_seq_chunks, P))
        while P % nc:
            nc -= 1
        slots = cfg.n_experts * B * moe.capacity(cfg, P // nc)
        transient = slots * (2 * cfg.d_model + 3 * cfg.d_ff) * size
    else:
        transient = B * P * cfg.d_ff * (3 * size + 4)
    if "cross" in layers:
        Hp = -(-cfg.n_heads // 16) * 16
        transient = max(transient, 2 * 4 * B * Hp * min(cfg.q_chunk, P) * cfg.n_frontend_tokens)
    acts = 4 * B * P * cfg.d_model * size
    return (_param_count(cfg) * size + kv + transient + acts) / 2**30


def _serve_inputs(res, cfg, nxt):
    """The served prompt with one more position — the token ``nxt`` (B, 1),
    or for the frame frontend the frame ``nxt`` (B, 1, d) — as a prefill
    batch, the media beside it."""
    if cfg.frontend == "frames":
        frames = torch.cat([res["frames"], nxt], 1)
        batch = {"frames": frames, "labels": torch.zeros(frames.shape[:2], dtype=torch.int32,
                                                          device=frames.device)}
    else:
        batch = {"tokens": torch.cat([res["prompt"], nxt], 1)}
    if cfg.frontend == "patches":
        batch["patches"] = res["media"]
    return batch


def _serve_one(name: str, cut: dict, device: str, smoke: bool, shape: dict, counters: dict,
               totals: dict) -> None:
    """One served model: a cold and a warm ``serve.run`` (the warm on the
    cold run's weights and inputs), launch counts zeroed before each and
    checked against the routing table after it, then the traced warm
    prefill and the consistency checks."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = _serve_cfg(name, cut, smoke)
    arch = cfg if cut else name
    B, P, gen = shape["batch"], shape["prompt_len"], shape["gen"]
    reckoned = _serve_reckoned_gib(cfg, B, P, gen)
    if device == "cuda":
        total = torch.cuda.get_device_properties(0).total_memory / 2**30
        check(reckoned < total, f"serve {name}: reckoned {reckoned:.2f} GiB of the card's "
                                f"{total:.2f}")
    label = f"{name}{' ' + str(cut) if cut else ''}"
    res = None
    for run in ("cold", "warm"):
        reuse = {} if res is None else {k: res[k] for k in ("params", "prompt", "frames",
                                                            "media")}
        res = None
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            _zero_launches(fn)
        t0 = time.perf_counter()
        res = serve.run(arch, smoke=smoke, seed=0, device=device, **shape, **reuse)
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        routes = {k: _route_counts(counters[k]) for k in ("flash_attention", "rwkv6_scan")}
        want = _routing(cfg, gen)
        want_routes = _route_table(cfg, gen)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"serve {label} {run}: prefill {B}x{P} {res['prefill_s']:.3f} s "
              f"({B * P / res['prefill_s']:.0f} tok/s), decode {gen} steps "
              f"{res['decode_s']:.3f} s ({1e3 * res['decode_s'] / gen:.2f} ms/step, "
              f"{B * gen / res['decode_s']:.1f} tok/s), wall with init {wall:.2f} s, "
              f"peak device memory {peak:.2f} GiB (reckoned {reckoned:.2f}); launches "
              f"{counts} (routing table {want}); by route {routes}; tokens[0] "
              f"{res['tokens'][0, :8].tolist()}")
        check(counts == want, f"serve {label} {run}: launches {counts}, want {want}")
        check(routes == want_routes,
              f"serve {label} {run}: launches by route {routes}, want {want_routes}")
        check(tuple(res["tokens"].shape) == (B, gen + 1)
              and int(res["tokens"].min()) >= 0
              and int(res["tokens"].max()) < cfg.vocab_size, f"serve {label}: tokens")
        for key in ("prefill_logits", "logits"):
            lg = res[key]
            check(tuple(lg.shape) == (B, cfg.vocab_size)
                  and bool(torch.isfinite(lg.float()).all()),
                  f"serve {label} {run}: {key} not finite or misshapen")
        for k in totals:
            totals[k] += counts[k]
    params = res["params"]
    print(f"serve {label}: {sum(t.numel() for t in _leaves(params)):,} parameters "
          f"({cfg.dtype}), d_model {cfg.d_model}, {cfg.n_layers} layers "
          f"{list(cfg.block_pattern)} x {cfg.n_units} + {list(cfg.tail_pattern)}, vocab "
          f"{cfg.vocab_size}, frontend {cfg.frontend}")
    # serving's own consistency: [prefill(P), decode(position P)] against the
    # last logits of prefill(P + 1), both through the kernels; position P is
    # the next token, or for frames a fresh frame
    if cfg.frontend == "frames":
        nxt = serve.decode_frames(1, P, B, cfg.d_model, params["embed"].device)
    else:
        nxt = res["tokens"][:, :1].to(params["embed"].device)
    batch = _serve_inputs(res, cfg, nxt)
    del res, reuse
    torch.cuda.empty_cache()
    if device == "cuda":
        head = _head(batch, cfg, P)
        _device_profile(f"serve {label} warm prefill {B}x{P}",
                        lambda: transformer.prefill(params, head, cfg, P + 1), _lm_kernels())
        del head
    if cfg.n_experts:
        # the check's copy of the first layers; the full model goes
        n = min(MOE_CHECK_LAYERS, cfg.n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n, capacity_factor=cfg.n_experts / cfg.top_k)
        params = dict(params, unit=_tree_map(lambda t: t[:n].clone(), params["unit"]))
        label += f" (first {n} layers, capacity factor {cfg.capacity_factor:g})"
        torch.cuda.empty_cache()
    _serve_checks(label, params, batch, cfg)


def _head(batch, cfg, P: int):
    """The first P positions of a prefill batch."""
    key = "frames" if cfg.frontend == "frames" else "tokens"
    return {k: (v[:, :P] if k in (key, "labels") else v) for k, v in batch.items()}


def _serve_checks(label, params, batch, cfg) -> None:
    """The consistency check in bf16 (within 5% of the largest logit), then
    with the weights upcast to f32 in place (within 1e-4: rounding is all
    that differs). An MoE model comes cut to its first ``MOE_CHECK_LAYERS``
    layers (a copy; the full model is let go) at capacity factor
    n_experts / top_k, where no expert can drop a token: at the config's
    factor prefill(P + 1) may drop its last token, which is last in every
    expert's queue, while decode (S = 1, C = 8) never does. The f32 upcast
    of the whole of qwen3-moe-30b-a3b would need ≈ 120 GB."""
    key = "frames" if cfg.frontend == "frames" else "tokens"
    B, P = batch[key].shape[0], batch[key].shape[1] - 1
    for dtype, rel_tol in (("bfloat16", 5e-2), ("float32", 1e-4)):
        if dtype == "float32":
            # the same weights in f32 (upcast leaf by leaf in place): the two
            # routes then differ only by f32 rounding, which the network
            # amplifies as it does bf16's
            _upcast(params)
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(cfg, dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        _consistency(f"{label} {'bf16' if dtype == 'bfloat16' else 'upcast to f32'}", params,
                     batch, cfg, rel_tol)
        print(f"serve {label} {dtype} check: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (reckoned "
              f"{_serve_reckoned_gib(cfg, B, P + 1, 0):.2f})")
    del params
    torch.cuda.empty_cache()


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def phase_serve(device: str = "cuda", smoke: bool = False, **shape):
    """The LM serving path at full width (recurrentgemma-9b, rwkv6-3b);
    returns launches by kernel."""
    shape = shape or SERVE
    counters = _lm_counters()
    totals = dict.fromkeys(counters, 0)
    for arch in LM_ARCHS:
        _serve_one(arch, {}, device, smoke, shape, counters, totals)
    return totals


def phase_family_serve(device: str = "cuda", smoke: bool = False, **shape):
    """Serving of the MoE, frame-frontend and cross-attention families
    (``FAMILIES``); returns launches by kernel."""
    shape = shape or SERVE
    counters = _lm_counters()
    totals = dict.fromkeys(counters, 0)
    for name, cut in FAMILIES:
        _serve_one(name, cut, device, smoke, shape, counters, totals)
    return totals


def _upcast(tree) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _upcast(v)
        else:
            tree[k] = v.float()


def _set_pos(cache, pos: int) -> None:
    """Set every attention cache's position to ``pos`` (in place)."""
    for v in cache.values():
        if isinstance(v, dict):
            if "k" in v:
                v["pos"].fill_(pos)
            else:
                _set_pos(v, pos)


def _consistency(tag, params, batch, cfg, rel_tol):
    """decode(position P) against the last logits of prefill(P + 1), held
    to ``rel_tol`` of the largest logit; ``batch`` holds the P + 1
    positions (tokens or frames, and the media). The decode step starts
    from prefill(P)'s cache, or for an MoE model from prefill(P + 1)'s own
    cache set back to position P: prefill(P) and prefill(P + 1) run their
    projections at other shapes, so their f32 rounding differs, and among
    the 4 × 4096 earlier tokens a router near tie then splits in some layer
    (two such splits are expected in f32), which moves that token's K/V
    and so the last logits by ~1/4096 of a token's weight: more than
    rounding. For an MoE model the router's top-k set at position P is
    also recorded in both runs, layer by layer: a row whose sets differ
    anywhere is printed and not held (after such a split the expert
    outputs legitimately differ); every other row is, and in f32 (rel_tol
    under 1e-3) every row must route alike."""
    from repro_torch.models import moe, transformer
    key = "frames" if cfg.frontend == "frames" else "tokens"
    B, P = batch[key].shape[0], batch[key].shape[1] - 1
    step = {key: batch[key][:, P:], "pos": torch.full((B, 1), P, dtype=torch.int32,
                                                      device=batch[key].device)}
    if "patches" in batch:
        step["media"] = batch["patches"]
    runs = {"decode": [], "prefill": [], "prefill(P)": []}
    real_route = moe._route

    def recording(into):
        def route(x, p, c, group=None):
            topv, topi, aux = real_route(x, p, c, group)
            into.append(topi.sort(-1).values)       # every position's set
            return topv, topi, aux
        return route
    try:
        moe._route = recording(runs["prefill"])
        want, cache = transformer.prefill(params, batch, cfg, P + 1)
        if cfg.n_experts:
            _set_pos(cache, P)
            # printed only: how many earlier positions the two prefills route apart
            moe._route = recording(runs["prefill(P)"])
            transformer.prefill(params, _head(batch, cfg, P), cfg, P + 1)
        else:
            del cache
            _, cache = transformer.prefill(params, _head(batch, cfg, P), cfg, P + 1)
        moe._route = recording(runs["decode"])
        got, _ = transformer.decode_step(params, step, cache, cfg)
        del cache
    finally:
        moe._route = real_route
    # one set of calls a layer (a layer's sequence chunks come one after
    # another): each layer's sets over the whole sequence
    n = len(runs["decode"])
    by_layer = {k: [torch.cat(v[i * len(v) // n:(i + 1) * len(v) // n], 1) for i in range(n)]
                for k, v in runs.items()}
    held = torch.ones(B, dtype=torch.bool)
    for a, b in zip(by_layer["decode"], by_layer["prefill"]):
        held &= (a[:, -1] == b[:, -1]).all(-1).cpu()
    earlier = sum(int((~(a == b[:, :P]).all(-1)).sum())
                  for a, b in zip(by_layer["prefill(P)"], by_layer["prefill"]))
    diff_rows = (got.float() - want.float()).abs().amax(-1).cpu()
    scale = float(want.float().abs().max())
    diff = float(diff_rows[held].max()) if bool(held.any()) else float("nan")
    start = "prefill(P + 1)'s own cache" if cfg.n_experts else f"prefill({P})"
    flips = "" if not n else (
        f"; router top-{cfg.top_k} sets at position {P} equal in "
        f"{int(held.sum())}/{B} rows over {n} layers"
        + ("" if bool(held.all()) else
           f" (rows with a differing set, not held: max |diff| "
           f"{[round(float(d), 4) for d in diff_rows[~held]]})")
        + f"; prefill({P}) and prefill({P + 1}) route {earlier} of the {B * P * n} earlier "
          f"(row, position, layer) sets apart")
    print(f"serve {tag}: decode(position {P}) from {start} vs prefill({P + 1}): "
          f"max |diff| {diff:.4e} of max |logit| {scale:.4e} ({diff / scale:.2e}, held to "
          f"{rel_tol:g}); argmax equal in {int((got.argmax(-1) == want.argmax(-1)).sum())}"
          f"/{B} rows{flips}")
    check(bool(held.all()) if rel_tol < 1e-3 else bool(held.any()),
          f"serve {tag}: the router's top-{cfg.top_k} sets at position {P} differ in "
          f"{int((~held).sum())}/{B} rows")
    check(bool(torch.isfinite(got.float()).all()) and diff <= rel_tol * scale,
          f"serve {tag}: decode vs prefill(P + 1) differ by {diff} (scale {scale})")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _lm_tree_close(a, b, tol, where):
    for k in b:
        if isinstance(b[k], dict):
            _lm_tree_close(a[k], b[k], tol, f"{where}/{k}")
            continue
        if not b[k].is_floating_point():
            check(torch.equal(a[k].cpu(), b[k].cpu()), f"{where}/{k} differs")
            continue
        err, ok = _within(a[k].cpu(), b[k].cpu(), tol, tol)
        check(ok, f"{where}/{k}: card vs CPU {err} > {tol}")


def phase_lm_parity(devices=("cuda", "cpu")) -> None:
    """Reduced width, card against CPU: the same weights (made on the CPU)
    and tokens, prefill then 3 teacher-forced decode steps; logits and
    caches within 1e-4 (f32) or 0.08 (bf16, the reference's own bound).
    qwen3-moe-30b-a3b in f32 only: in bf16 the two devices' rounding may
    break a near tie of the router apart, and a token then goes to another
    expert (a different result, not a rounding of the same one)."""
    from repro_torch import configs
    from repro_torch.models import transformer

    both = (("float32", 1e-4), ("bfloat16", 0.08))
    cases = (("recurrentgemma-9b", dict(n_layers=5, window=8), 16, both),
             ("rwkv6-3b", dict(rwkv_chunk=8), 13, both),
             ("qwen2-0.5b", dict(), 16, both),
             ("qwen3-moe-30b-a3b", dict(), 16, both[:1]))
    for arch, kw, P, dtypes in cases:
        for dtype, tol in dtypes:
            cfg = configs.get_smoke(arch, dtype=dtype, **kw)
            p_cpu = transformer.init_params(cfg, torch.Generator().manual_seed(P),
                                            device="cpu")
            toks = torch.from_numpy(np.random.default_rng(P).integers(
                0, cfg.vocab_size, (2, P + 3)))
            runs = []
            for dev in devices:
                params = _to(p_cpu, dev)
                logits, cache = transformer.prefill(params, {"tokens": toks[:, :P].to(dev)},
                                                    cfg, P + 3)
                out = [(logits.cpu(), _to(cache, "cpu"))]
                for i in range(3):
                    step = {"tokens": toks[:, P + i:P + i + 1].to(dev),
                            "pos": torch.full((2, 1), P + i, dtype=torch.int32, device=dev)}
                    logits, cache = transformer.decode_step(params, step, cache, cfg)
                    out.append((logits.cpu(), _to(cache, "cpu")))
                runs.append(out)
            worst = 0.0
            for i, ((la, ca), (lb, cb)) in enumerate(zip(*runs)):
                err, ok = _within(la, lb, tol, tol)
                worst = max(worst, err)
                check(ok, f"lm parity {arch} {dtype} step {i}: logits differ by {err}")
                _lm_tree_close(ca, cb, tol, f"lm parity {arch} {dtype} step {i} cache")
            print(f"lm parity: {arch} reduced {kw} P={P} {dtype}, card vs CPU: prefill + 3 "
                  f"decode steps, logits max |diff| {worst:.3e} (<= {tol} + {tol}·|CPU|), "
                  "caches within the same bound")


def _to(tree, dev):
    """A copy of ``tree`` on ``dev`` (a copy also on the same device: the
    decode steps update their cache in place)."""
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
            for k, v in tree.items()}


TRAIN = dict(batch=8, seq=2048, lr=3e-4)
# (config, its cut, micro-batches, steps, optimizer): the train runs of phase
# 13. recurrentgemma-9b keeps its full width with the depth cut to one
# (rglru, rglru, attn) unit and the (rglru, rglru) tail, qwen3-moe-30b-a3b
# its full width (128 experts top-8) with the depth cut to 4 layers; sgdm
# where AdamW's old and new moments would not fit the card beside the weights
TRAIN_RUNS = (("qwen2-0.5b", {}, 1, 4, "adamw"), ("qwen2-0.5b", {}, 2, 4, "adamw"),
              ("olmo-1b", {}, 1, 3, "adamw"), ("rwkv6-3b", {}, 1, 3, "sgdm"),
              ("recurrentgemma-9b", {"n_layers": 5}, 1, 3, "sgdm"),
              ("qwen3-moe-30b-a3b", {"n_layers": 4}, 1, 3, "sgdm"))


def phase_train_kernels():
    """The forward kernels' log-sum-exp on both routes, and the backward
    kernel against autograd of the plain version and against its plain
    version, at the train path's shapes; returns the backward's row at
    qwen2-0.5b's shape (the three train shapes' times under
    "train_shapes": qwen2-0.5b, olmo-1b and recurrentgemma-9b's hd-256
    MQA, whose window of 2048 covers the whole sequence) and the forward's
    times at the train shapes."""
    import importlib

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_attention_bwd_plain, \
        flash_attention_plain
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {"train_shapes": {}, "forward_train": {}}
    for what, B, H, KV, S, hd, window, dtype, train in (
            ("qwen2-0.5b train, GQA 14 -> 2", 8, 14, 2, 2048, 64, 0, torch.bfloat16,
             "qwen2-0.5b"),
            ("olmo-1b train, MHA", 8, 16, 16, 2048, 128, 0, torch.bfloat16, "olmo-1b"),
            ("recurrentgemma-9b train, MQA, hd 256, window 2048", 8, 16, 1, 2048, 256, 2048,
             torch.bfloat16, "recurrentgemma-9b"),
            ("qwen3-moe-30b-a3b train, GQA 32 -> 4", 8, 32, 4, 2048, 64, 0, torch.bfloat16,
             "qwen3-moe-30b-a3b"),
            ("olmo-100m train (the training example), MHA", 8, 8, 8, 256, 64, 0,
             torch.bfloat16, "olmo-100m"),
            ("recurrentgemma-9b shape: MQA, hd 256, window 2048", 1, 16, 1, 4096, 256, 2048,
             torch.bfloat16, None),
            ("ragged S", 4, 14, 2, 1999, 64, 0, torch.bfloat16, None),
            ("f32, the CUDA-core forward route", 2, 4, 2, 300, 64, 0, torch.float32, None)):
        q, k, v, do = (torch.randn((B, S, n, hd), generator=gen, device="cuda").to(dtype)
                       .transpose(1, 2) for n in (H, KV, KV, H))
        scale = 1.0 / math.sqrt(hd)
        counter = "launches_tc" if dtype == torch.bfloat16 else "launches_f32"
        before = getattr(flash_attention, counter)
        o, lse = fa._forward(q, k, v, True, window, scale, 0.0, with_lse=True)
        po, plse = flash_attention_plain(q, k, v, window=window, return_lse=True)
        torch.cuda.synchronize()
        check(getattr(flash_attention, counter) == before + 1,
              f"flash forward [{what}] did not take its {counter} route")
        # the plain version's lse is torch.logsumexp of its masked f32 scores
        err_l, ok_l = _within(lse, plse, 1e-5, 1e-5)
        err_o, ok_o = (_within(o, po, 2.0 ** -7, 1e-5) if dtype == torch.bfloat16
                       else _within(o, po, 2e-5, 2e-5))
        check(ok_l and ok_o, f"flash forward with lse [{what}]: o {err_o}, lse {err_l}")
        del po, plse
        bwd_counter = "launches_bwd_tc" if dtype == torch.bfloat16 else "launches_bwd_fma"
        before = getattr(flash_attention, bwd_counter)
        got = fa._backward(q, k, v, o, lse, do, True, window, scale, 0.0)
        again = fa._backward(q, k, v, o, lse, do, True, window, scale, 0.0)
        torch.cuda.synchronize()
        check(getattr(flash_attention, bwd_counter) == before + 6,
              f"flash backward [{what}] did not take its {bwd_counter} route")
        # every sum in one block, in a fixed order: the same bits each call
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash backward [{what}]: two calls on the same inputs differ")
        del again
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
        qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
        auto = torch.autograd.grad(flash_attention_plain(qa, ka, va, window=window),
                                   (qa, ka, va), do)
        del qa, ka, va
        # bf16: one rounding of an f32 result apart from the plain version;
        # from autograd, also D = rowsum(dO ∘ O) read from the rounded o
        tol = ((2.0 ** -7, 1e-4, 2.0 ** -6, 1e-2) if dtype == torch.bfloat16
               else (1e-4, 1e-4, 1e-4, 1e-4))
        errs = []
        for name, g, w, a in zip(("dq", "dk", "dv"), got, want, auto):
            m = float(w.float().abs().max())
            err_p, ok_p = _within(g, w, tol[0], tol[1] * m)
            err_a, ok_a = _within(g, a, tol[2], tol[3] * m)
            check(ok_p and ok_a, f"flash backward [{what}] {name}: {err_p} from the plain "
                                 f"version, {err_a} from autograd (max |grad| {m})")
            errs.append((name, err_p, err_a, m))
        del got, want, auto
        torch.cuda.empty_cache()
        print(f"flash backward [{what}]: " + "; ".join(
            f"{n} max_abs_err {p:.3e} vs plain, {a:.3e} vs autograd (max {m:.3e})"
            for n, p, a, m in errs)
            + f" (<= {tol[0]:g}·|plain| + {tol[1]:g}·max, autograd {tol[2]:g}·|a| + "
              f"{tol[3]:g}·max); lse max_abs_err {err_l:.3e}; two calls bit for bit")
        ms = time_ms(lambda: fa._backward(q, k, v, o, lse, do, True, window, scale, 0.0))
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                              window=window), reps=5, warmup=1)
        qx = q.detach().requires_grad_()
        kx, vx = (t.repeat_interleave(H // KV, 1).detach().requires_grad_() for t in (k, v))
        if 0 < window < S:
            idx = torch.arange(S, device="cuda")
            mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None] - window)
            out = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask)
        else:   # no window, or one that covers every row's keys: causal
            out = F.scaled_dot_product_attention(qx, kx, vx, is_causal=True)
        library_ms = time_ms(lambda: torch.autograd.grad(out, (qx, kx, vx), do,
                                                         retain_graph=True))
        del out, qx, kx, vx
        row = _report("flash_attention_bwd", f"{what} B={B} H={H} KV={KV} S={S} hd={hd} "
                      f"window={window} {str(dtype).split('.')[-1]}, {bwd_counter[13:]} route",
                      max(e[1] for e in errs), ms, plain_ms, library_ms,
                      *fa.flash_attention_bwd_cost(B, H, KV, S, hd, dtype, window).bound(),
                      note=" (vs the plain version; library: the backward of "
                           "scaled_dot_product_attention, is_causal or the boolean window "
                           "mask, KV expanded)")
        print(f"flash backward [{what}]: {ms:.4f} ms, {ms / library_ms:.2f}x the library's "
              f"{library_ms:.4f} ms, {100 * row['bound_ms'] / ms:.1f}% of its bound "
              f"{row['bound_ms']:.4f} ms ({bwd_counter[13:]} route)")
        if train:
            rows["train_shapes"][train] = {k: row[k] for k in ("ms", "library_ms", "bound_ms")}
            rows.setdefault("flash_attention_bwd", row)
            fwd_lse = time_ms(lambda: fa._forward(q, k, v, True, 0, scale, 0.0, True))
            fwd = time_ms(lambda: fa._forward(q, k, v, True, 0, scale, 0.0, False))
            kx, vx = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True))
            del kx, vx
            fwd_bound = fa.flash_attention_cost(B, H, KV, S, hd, q.dtype).bound()[0]
            rows["forward_train"][train] = {"ms": fwd_lse, "ms_without_lse": fwd,
                                            "library_ms": sdpa,
                                            "bound_ms": fwd_bound}
            print(f"flash forward [{what}]: with lse {fwd_lse:.4f} ms, without {fwd:.4f} ms, "
                  f"scaled_dot_product_attention(is_causal=True, KV expanded) {sdpa:.4f} ms "
                  f"(bound {fwd_bound:.4f} ms)")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def _grads_close(tag, got, want, names, rtol, atol_of_max):
    """Each gradient within rtol·|want| + atol_of_max·max|want|; returns the
    largest |got − want| and the largest such difference over its
    gradient's max|want|."""
    worst = ratio = 0.0
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        m = float(w.float().abs().max())
        err, ok = _within(g, w, rtol, atol_of_max * m)
        check(ok, f"{tag} {name}: max |diff| {err} (max |grad| {m})")
        worst, ratio = max(worst, err), max(ratio, err / m if m else 0.0)
    return worst, ratio


def phase_scan_bwd_kernels():
    """The RG-LRU and RWKV6 backward kernels against their plain versions
    and against autograd of the plain forwards at the train path's shapes;
    two calls give the same bits; times beside the forward's at the same
    shape. Returns each kernel's row at its main shape."""
    import importlib

    from repro_torch.kernels import (rglru_scan, rglru_scan_bwd_plain, rglru_scan_plain,
                                     rwkv6_scan, rwkv6_scan_bwd_plain, rwkv6_scan_plain)
    rg = importlib.import_module("repro_torch.kernels.rglru_scan")
    rw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {}
    B, S, C = 8, 2048, 4096                             # recurrentgemma-9b's train shape
    for what, with_h0, with_dl in (("train shape, no h0, no dh_last", False, False),
                                   ("train shape, h0 and dh_last", True, True)):
        a = torch.rand((B, S, C), generator=gen, device="cuda")
        b = torch.randn((B, S, C), generator=gen, device="cuda")
        h0 = torch.randn((B, C), generator=gen, device="cuda") if with_h0 else None
        dout = torch.randn((B, S, C), generator=gen, device="cuda")
        dl = torch.randn((B, C), generator=gen, device="cuda") if with_dl else None
        out, _ = rg._forward(a, b, h0, share=False)
        before = rglru_scan.launches_bwd
        got = rg._backward(a, out, h0, dout, dl)
        again = rg._backward(a, out, h0, dout, dl)
        torch.cuda.synchronize()
        check(rglru_scan.launches_bwd == before + 2, f"rglru backward [{what}] did not launch")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"rglru backward [{what}]: two calls on the same inputs differ")
        want = rglru_scan_bwd_plain(a, out, h0, dout, dl)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"rglru backward [{what}] differs from its plain version")
        ins = [t.detach().requires_grad_() for t in (a, b) + ((h0,) if with_h0 else ())]
        o_p, h_p = rglru_scan_plain(*ins)
        auto = torch.autograd.grad((o_p, h_p) if with_dl else (o_p,), ins,
                                   (dout, dl) if with_dl else (dout,))
        # autograd sums the same terms, in another order where two meet
        err_a, _ = _grads_close(f"rglru backward [{what}] vs autograd", got, auto,
                                ("da", "db", "dh0"), 1e-5, 1e-6)
        del ins, o_p, h_p, auto, want, again
        ms = time_ms(lambda: rg._backward(a, out, h0, dout, dl))
        plain_ms = time_ms(lambda: rglru_scan_bwd_plain(a, out, h0, dout, dl), reps=3, warmup=1)
        fwd_ms = time_ms(lambda: rg._forward(a, b, h0, share=False))
        row = _report("rglru_scan_bwd", f"{what} B={B} S={S} C={C}", 0.0, ms, plain_ms, None,
                      *rg.rglru_scan_bwd_cost(B, S, C, with_h0, with_dl).bound(),
                      note=f" (bit for bit the plain version, two calls bit for bit; "
                           f"autograd of the plain forward within 1e-5·|a| + 1e-6·max: "
                           f"{err_a:.3e}; the forward {fwd_ms:.4f} ms)")
        row["forward_ms"] = fwd_ms
        rows.setdefault("rglru_scan_bwd", row)
        del a, b, h0, dout, dl, out, got
        torch.cuda.empty_cache()

    # the kernel's products are 3 × TF32 (about 21 bits an operand) and its
    # exponentials ex2.approx: 2e-3·|plain| + 1e-3·max|plain| of each
    # gradient; dr, dk, dv in bf16 are one rounding apart (2^-7·|plain|)
    names = ("dr", "dk", "dv", "dlogw", "du", "ds0")
    for what, B, H, S, hd, W, dtype, with_s0, with_df, strong in (
            ("rwkv6-3b train shape", 8, 48, 2048, 64, 64, torch.bfloat16, False, False, False),
            ("from s0, with dS_final", 8, 48, 2048, 64, 64, torch.bfloat16, True, True, False),
            ("ragged S, strong decays", 4, 48, 1999, 64, 64, torch.bfloat16, False, True, True),
            ("f32", 2, 8, 300, 64, 64, torch.float32, True, True, True)):
        r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
                   .transpose(1, 2) for _ in range(3))
        x = (torch.rand((B, S, H, hd), generator=gen, device="cuda") * 11 - 8 if strong
             else 0.5 * torch.randn((B, S, H, hd), generator=gen, device="cuda"))
        logw = -torch.exp(x).transpose(1, 2)
        del x
        u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
        s0 = torch.randn((B, H, hd, hd), generator=gen, device="cuda") if with_s0 else None
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda").transpose(1, 2)
        df = torch.randn((B, H, hd, hd), generator=gen, device="cuda") if with_df else None
        o, s_out, scratch = rw._forward(r, k, v, logw, u, W, s0, "chunked")
        before = rwkv6_scan.launches_bwd
        got = rw._backward(r, k, v, logw, u, s_out, scratch, do, df, W)
        again = rw._backward(r, k, v, logw, u, s_out, scratch, do, df, W)
        torch.cuda.synchronize()
        check(rwkv6_scan.launches_bwd == before + 6, f"rwkv6 backward [{what}] did not launch")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"rwkv6 backward [{what}]: two calls on the same inputs differ")
        del again
        bf16 = dtype == torch.bfloat16
        want = rwkv6_scan_bwd_plain(r, k, v, logw, u, do, chunk=W, s0=s0, ds_final=df)
        errs = [_grads_close(f"rwkv6 backward [{what}] vs plain", got[:3], want[:3], names,
                             2.0 ** -7 if bf16 else 2e-3, 1e-3),
                _grads_close(f"rwkv6 backward [{what}] vs plain", got[3:], want[3:], names[3:],
                             2e-3, 1e-3)]
        del want
        ins = [t.detach().requires_grad_() for t in (r, k, v, logw, u)]
        s0a = s0.detach().requires_grad_() if with_s0 else None
        o_p, s_p = rwkv6_scan_plain(*ins, chunk=W, s0=s0a)
        auto = torch.autograd.grad((o_p, s_p) if with_df else (o_p,),
                                   ins + ([s0a] if with_s0 else []),
                                   (do, df) if with_df else (do,))
        del ins, s0a, o_p, s_p
        torch.cuda.empty_cache()
        errs_a = [_grads_close(f"rwkv6 backward [{what}] vs autograd", got[:3], auto[:3],
                               names, 2.0 ** -7 if bf16 else 2e-3, 1e-3),
                  _grads_close(f"rwkv6 backward [{what}] vs autograd", got[3:],
                               auto[3:] + ((None,) if not with_s0 else ()), names[3:], 2e-3,
                               1e-3)]
        del auto, got
        torch.cuda.empty_cache()
        ms = time_ms(lambda: rw._backward(r, k, v, logw, u, s_out, scratch, do, df, W))
        plain_ms = time_ms(lambda: rwkv6_scan_bwd_plain(r, k, v, logw, u, do, chunk=W, s0=s0,
                                                        ds_final=df), reps=3, warmup=1)
        fwd_ms = time_ms(lambda: rw._forward(r, k, v, logw, u, W, s0, "chunked"))
        row = _report("rwkv6_scan_bwd", f"{what} B={B} H={H} S={S} hd={hd} W={W} "
                      f"{str(dtype).split('.')[-1]} r/k/v{', s0' if with_s0 else ''}"
                      f"{', dS_final' if with_df else ''}", max(e for e, _ in errs), ms,
                      plain_ms, None,
                      *rw.rwkv6_scan_bwd_cost(B, H, S, hd, W, dtype, with_df).bound(),
                      note=f" (vs the plain version, {max(r for _, r in errs):.2e} of the "
                           f"gradient's max |plain|; <= {'2^-7' if bf16 else '2e-3'}·|plain| "
                           f"+ 1e-3·max for dr/dk/dv, 2e-3·|plain| + 1e-3·max for dlogw, du, "
                           f"ds0; autograd of the plain forward {max(e for e, _ in errs_a):.3e}"
                           f", {max(r for _, r in errs_a):.2e} of max, same bounds; two calls "
                           f"bit for bit; the forward {fwd_ms:.4f} ms)")
        row["forward_ms"] = fwd_ms
        print(f"rwkv6 backward [{what}]: {ms:.4f} ms, {ms / fwd_ms:.2f}x its forward's "
              f"{fwd_ms:.4f} ms, {100 * row['bound_ms'] / ms:.1f}% of its bound "
              f"{row['bound_ms']:.4f} ms")
        rows.setdefault("rwkv6_scan_bwd", row)
        del r, k, v, logw, do, o, s_out, scratch
        torch.cuda.empty_cache()
    return rows


def _train_routing(cfg, steps: int, micro: int):
    """Launches of a train run, per micro-batch and step: each layer of a
    unit runs its forward twice (the forward and remat's recompute), each
    tail layer once (the tail stays outside the checkpoint); each attention,
    RG-LRU and RWKV6 layer runs its backward once: flash's three launches
    (bf16 on the tensor cores, hd 256 too; f32 on the CUDA cores), the
    RG-LRU scan's one, the RWKV6 scan's three (its forward on the chunked
    route)."""
    n = steps * micro
    unit, tail = list(cfg.block_pattern) * cfg.n_units, list(cfg.tail_pattern)
    fwd = {kind: n * (2 * unit.count(kind) + tail.count(kind)) for kind in ("attn", "rglru", "rwkv")}
    bwd = {kind: n * (unit + tail).count(kind) for kind in ("attn", "rglru", "rwkv")}
    tc = cfg.dtype == "bfloat16"
    return {"flash_attention": {"launches": fwd["attn"], "launches_tc": fwd["attn"] if tc else 0,
                                "launches_f32": 0 if tc else fwd["attn"],
                                "launches_bwd": 3 * bwd["attn"],
                                "launches_bwd_tc": 3 * bwd["attn"] if tc else 0,
                                "launches_bwd_fma": 0 if tc else 3 * bwd["attn"]},
            "rglru_scan": {"launches": fwd["rglru"], "launches_bwd": bwd["rglru"]},
            "rwkv6_scan": {"launches": fwd["rwkv"], "launches_chunked": fwd["rwkv"],
                           "launches_decode": 0, "launches_bwd": 3 * bwd["rwkv"]}}


def _train_counts():
    return {k: {"launches": fn.launches, **_route_counts(fn)}
            for k, fn in _lm_counters().items()}


def _train_arch(name: str, cut: dict, smoke: bool):
    """A run's model: the config's name as a user passes it, or the named
    config with its depth cut (a ``ModelConfig``, at full or reduced width)."""
    if not cut:
        return name
    from repro_torch import configs
    return configs.get_smoke(name, **cut) if smoke else dataclasses.replace(configs.get(name),
                                                                           **cut)


def _reckoned_gib(cfg, opt: str) -> float:
    """The state alive at the optimizer's update, which returns new trees:
    parameters, gradients and new parameters in the model's type, the old
    and the new optimizer state in f32 (sgdm: one tree, adamw: two)."""
    from repro_torch.models import transformer
    params = transformer._build_params(cfg, None, torch.device("meta"))
    n = sum(t.numel() for t in _leaves(params))
    size = 2 if cfg.dtype == "bfloat16" else 4
    trees = {"sgd": 0, "sgdm": 1, "adamw": 2, "yogi": 2}[opt]
    return n * (3 * size + 2 * trees * 4) / 2**30


def phase_train(device: str = "cuda", smoke: bool = False, **shape):
    """The LM gradient regime at full width through launch.train.run;
    returns the launches of each kernel (backwards apart)."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.data import lm as lm_data
    from repro_torch.launch import train

    shape = shape or TRAIN
    totals = dict.fromkeys(("flash_attention", "flash_attention_bwd", "rglru_scan",
                            "rglru_scan_bwd", "rwkv6_scan", "rwkv6_scan_bwd"), 0)
    uninterrupted = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        # the first run checkpoints, the second resumes from its step 2
        runs = [run + ("ckpt" if i == 0 else None,) for i, run in enumerate(TRAIN_RUNS)]
        runs.insert(1, TRAIN_RUNS[0] + ("resume",))
        for name, cut, micro, steps, opt, role in runs:
            arch = _train_arch(name, cut, smoke)
            for fn in _lm_counters().values():
                _zero_launches(fn)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            if role != "resume":
                cfg = arch if cut else (configs.get_smoke(arch) if smoke else configs.get(arch))
                print(f"train {name}{' ' + str(cut) if cut else ''} {opt}: reckoned at the update "
                      f"{_reckoned_gib(cfg, opt):.2f} GiB (parameters, gradients, new "
                      f"parameters, old and new optimizer state), activations apart")
            t0 = time.perf_counter()
            res = train.run(arch, smoke=smoke, steps=steps, micro=micro, seed=0, log_every=1,
                            ckpt=ckdir if role else "", ckpt_every=2, device=device, opt=opt,
                            **shape)
            wall = time.perf_counter() - t0
            counts = _train_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            hist, cfg = list(res["history"]), res["cfg"]
            ran = len(hist)
            want = _train_routing(cfg, ran, micro)
            dts = [r["dt"] for r in hist]
            warm = statistics.median(dts[1:]) if ran > 1 else dts[0]
            tokens = shape["batch"] * shape["seq"]
            label = (f"{name}{' ' + str(cut) if cut else ''} {opt} micro {micro}"
                     + (" resumed at step 2" if role == "resume" else ""))
            print(f"train {label}: {ran} steps from step {res['start_step']}, step s cold "
                  f"{dts[0]:.3f} warm {warm:.3f} ({tokens / warm:.0f} tokens/s); wall with init "
                  f"{wall:.2f} s; peak device memory {peak:.2f} GiB; losses "
                  f"{[round(r['loss'], 5) for r in hist]}; grad norms "
                  f"{[round(r['grad_norm'], 4) for r in hist]}; launches {counts}")
            check(counts == want, f"train {label}: launches {counts}, want {want}")
            fl = counts["flash_attention"]
            if cfg.dtype == "bfloat16" and fl["launches_bwd"]:
                # every bf16 backward, hd 256 too, on the tensor-core route
                check(fl["launches_bwd_tc"] == fl["launches_bwd"] and not fl["launches_bwd_fma"],
                      f"train {label}: flash backward launches {fl}, want all on launches_bwd_tc")
            check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                      for r in hist), f"train {label}: a loss or gradient norm is not finite")
            for kernel in ("flash_attention", "rglru_scan", "rwkv6_scan"):
                totals[kernel] += counts[kernel]["launches"]
                totals[kernel + "_bwd"] += counts[kernel]["launches_bwd"]
            backend = res["backend"]
            if role == "ckpt":
                uninterrupted = hist
                n_params = sum(t.numel() for t in _leaves(backend.params))
                print(f"train {name}: {n_params:,} parameters ({cfg.dtype}), checkpoints "
                      f"{sorted(os.listdir(ckdir))}")
                shutil.rmtree(os.path.join(ckdir, "step_4"))
            elif role == "resume":
                check(res["start_step"] == 2 and ran == 2, f"train {label}: did not resume")
                for r, u in zip(hist, uninterrupted[2:]):
                    rel = abs(r["loss"] - u["loss"]) / abs(u["loss"])
                    print(f"train resume: step {r['round']} loss {r['loss']:.6f}, "
                          f"uninterrupted {u['loss']:.6f} (rel {rel:.2e}, held to 1e-2)")
                    check(r["involved"] == u["involved"] and rel <= 1e-2,
                          f"train resume: step {r['round']} differs")
            else:
                n_params = sum(t.numel() for t in _leaves(backend.params))
                print(f"train {name}: {n_params:,} parameters ({cfg.dtype}), {cfg.n_layers} "
                      f"layers {list(cfg.block_pattern)} x {cfg.n_units} + "
                      f"{list(cfg.tail_pattern)}, d_model {cfg.d_model}, vocab {cfg.vocab_size}")
            if device == "cuda" and not role:
                # one warm step of the same backend, traced
                toks = next(lm_data.lm_batches(99, 1, shape["batch"], shape["seq"],
                                               cfg.vocab_size))["tokens"]
                batch = {"tokens": torch.from_numpy(toks).to(device),
                         "client_weight": torch.ones(shape["batch"], device=device)}

                def step():
                    backend.params, backend.opt_state, _ = backend.train_step(
                        backend.params, backend.opt_state, batch)
                _device_profile(f"train {label} warm step", step, _lm_kernels(), top=8)
            del res, backend
    return totals


def phase_train_parity(devices=("cuda", "cpu")) -> None:
    """Reduced width, card against CPU: one train step from the same weights
    (made on the CPU) and tokens, a client_weight with zero rows; loss and
    every updated parameter within 1e-4 (f32) or 0.08 (bf16); qwen3-moe-30b-a3b
    in f32 only, as in phase 11."""
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.models import transformer
    from repro_torch.optim import make_optimizer

    toks = torch.from_numpy(np.random.default_rng(14).integers(0, 256, (4, 32)))
    w = torch.tensor([120.0, 0.0, 37.0, 250.0])
    both = (("float32", 1e-4), ("bfloat16", 0.08))
    for arch, dtypes in (("qwen2-0.5b", both), ("olmo-1b", both), ("rwkv6-3b", both),
                         ("recurrentgemma-9b", both), ("qwen3-moe-30b-a3b", both[:1])):
        for dtype, tol in dtypes:
            cfg = configs.get_smoke(arch, dtype=dtype)
            p_cpu = transformer.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
            want_bwd = {k: v["launches_bwd"] for k, v in _train_routing(cfg, 1, 1).items()}
            for opt_name, lr in (("sgd", 0.5), ("adamw", 3e-4)):
                out = []
                for dev in devices:
                    before = {k: fn.launches_bwd for k, fn in _lm_counters().items()}
                    params = _to(p_cpu, dev)
                    step = specs.make_train_step(cfg, opt_name, lr)
                    new, state, loss = step(params, make_optimizer(opt_name).init(params),
                                            {"tokens": toks.to(dev), "client_weight": w.to(dev)})
                    out.append((float(loss), _to(new, "cpu")))
                    if dev == "cuda":
                        ran = {k: fn.launches_bwd - before[k] for k, fn in _lm_counters().items()}
                        check(ran == want_bwd, f"train parity {arch}: backward launches {ran}, "
                                               f"want {want_bwd}")
                (la, pa), (lb, pb) = out
                check(abs(la - lb) <= tol + tol * abs(lb),
                      f"train parity {arch} {dtype} {opt_name}: loss {la} vs {lb}")
                worst = max(_within(a, b, tol, tol)[0] for a, b in
                            zip(_leaves(pa), _leaves(pb)))
                _lm_tree_close(pa, pb, tol, f"train parity {arch} {dtype} {opt_name}")
                print(f"train parity: {arch} reduced {dtype} {opt_name} lr {lr}, card vs CPU: "
                      f"loss {la:.6f} vs {lb:.6f}, parameters max |diff| {worst:.3e} "
                      f"(<= {tol} + {tol}·|CPU|)")


def _leaf_shapes(cfg):
    """The shapes of ``cfg``'s parameters (its gradient leaves), on the meta device."""
    from repro_torch.common.tree import flatten
    from repro_torch.models import transformer
    return [tuple(t.shape) for t in flatten(transformer._build_params(cfg, None,
                                                                      torch.device("meta")))]


def _lm_gradient_leaf_kernels(N: int):
    """The one-row quantize and dequantize at the LM gradient path's largest
    leaf (N elements), against their plain versions; returns their rows."""
    from repro_torch.kernels import quantize as kq
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((1, N), generator=gen, device="cuda") * 1e-3
    u = torch.rand((1, N), generator=gen, device="cuda")
    s = x.abs().amax(1).clamp_min(1e-12) / 127.0
    q = kq.quantize_rows(x, u, s, 127.0)
    check(torch.equal(q, kq.quantize_rows_plain(x, u, s, 127.0)),
          "quantize_rows differs [LM gradient leaf]")
    what = f"qwen2-0.5b embedding gradient, one row N={N} int8"
    rows = {"quantize_rows": _report(
        "quantize_rows", what, 0.0, time_ms(lambda: kq.quantize_rows(x, u, s, 127.0)),
        time_ms(lambda: kq.quantize_rows_plain(x, u, s, 127.0)), None,
        *kq.quantize_cost(1, N, x.element_size()).bound(), note=" (bit for bit)")}
    check(torch.equal(kq.dequantize_rows(q, s), kq.dequantize_rows_plain(q, s)),
          "dequantize_rows differs [LM gradient leaf]")
    rows["dequantize_rows"] = _report(
        "dequantize_rows", what, 0.0, time_ms(lambda: kq.dequantize_rows(q, s)),
        time_ms(lambda: kq.dequantize_rows_plain(q, s)),
        time_ms(lambda: torch.mul(q, s[:, None])), *kq.dequantize_cost(1, N, False).bound(),
        note=" (bit for bit; library: torch.mul(q, s))")
    del x, u, q
    torch.cuda.empty_cache()
    return rows


def _collective_aggregator(mesh, shapes) -> None:
    """make_weighted_gradient_aggregator at full width on a world of one."""
    from repro_torch.core import aggregation
    from repro_torch.kernels import dequantize_rows, quantize_rows
    gen = torch.Generator(device="cuda").manual_seed(16)
    local = {f"{i:03d}": torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
             for i, s in enumerate(shapes)}
    K = 12345.0
    want = {k: x.float() / torch.tensor(K, device="cuda") for k, x in local.items()}
    for mode, comp in (("two_step", None), ("classical", None), ("two_step", "int8")):
        agg = aggregation.make_weighted_gradient_aggregator(mesh, mode, comp)
        noise = torch.Generator(device="cuda").manual_seed(17) if comp else None
        before = (quantize_rows.launches, dequantize_rows.launches)
        mean, k = agg(local, K, noise)
        torch.cuda.synchronize()
        check(float(k) == K, f"aggregator {mode} {comp}: K {float(k)}, want {K}")
        label = f"aggregator {mode}{' int8' if comp else ''}"
        if comp:
            ran = (quantize_rows.launches - before[0], dequantize_rows.launches - before[1])
            check(ran == (len(local), len(local)),
                  f"{label}: quantize, dequantize launches {ran}, want {len(local)} each")
            worst = 0.0
            for key, x in local.items():
                level = float(x.float().abs().max()) / 127.0 / K
                err = float((mean[key] - want[key]).abs().max())
                check(err <= level * (1 + 1e-5), f"{label}: leaf {key} off by {err:.3e}, "
                                                 f"one level {level:.3e}")
                worst = max(worst, err / level)
            note = f"within {worst:.3f} of one level of local / K"
        else:
            check(all(torch.equal(mean[key], want[key]) for key in local),
                  f"{label}: not local / K bit for bit")
            note = "local / K bit for bit"
        del mean
        ms = time_ms(lambda: agg(local, K, noise))
        print(f"{label} [qwen2-0.5b gradient shapes, {len(local)} bf16 leaves, "
              f"{sum(math.prod(s) for s in shapes):,} elements, NCCL world of one]: {note}; "
              f"ms {ms:.4f} (median of 20, CUDA events)")
    del local, want
    torch.cuda.empty_cache()


def _collective_train(mesh):
    """qwen2-0.5b at full width, 3 adamw steps three ways; returns the
    quantize and dequantize launches of the two_step_int8 run."""
    from repro_torch import configs
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import dequantize_rows, quantize_rows
    from repro_torch.launch import specs
    from repro_torch.models import transformer
    from repro_torch.optim import make_optimizer
    cfg = configs.get("qwen2-0.5b")
    B, S, steps = TRAIN["batch"], TRAIN["seq"], 3
    weights = torch.from_numpy(
        np.random.default_rng(0).integers(50, 400, B).astype(np.float32)).cuda()
    batches = [{"tokens": torch.from_numpy(b["tokens"]).cuda(), "client_weight": weights}
               for b in lm_data.lm_batches(0, steps, B, S, cfg.vocab_size)]
    ways = {"mesh=None": {}, "gspmd on the mesh": {"mesh": mesh},
            "two_step_int8 on the mesh": {"mesh": mesh, "transport": "two_step_int8"}}

    def start(kw):
        params = transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                         "cuda")
        return [params, make_optimizer("adamw").init(params),
                specs.make_train_step(cfg, "adamw", TRAIN["lr"], seed=0, **kw)]

    runs = {}
    for label, kw in ways.items():
        params, state, step = start(kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        quantize_rows.launches = dequantize_rows.launches = 0
        losses, dts = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        runs[label] = dict(losses=losses, warm=statistics.median(dts[1:]),
                           launches=(quantize_rows.launches, dequantize_rows.launches),
                           peak=torch.cuda.max_memory_allocated() / 2**30)
        r = runs[label]
        print(f"collectives train qwen2-0.5b {label}: losses {losses}; step s cold "
              f"{dts[0]:.3f} warm {r['warm']:.4f} ({B * S / r['warm']:.0f} tokens/s); peak "
              f"{r['peak']:.2f} GiB; quantize, dequantize launches {r['launches']}")
        check(all(math.isfinite(x) for x in losses), f"collectives train {label}: a loss "
                                                     "is not finite")
        del params, state, step
    # the int8 transport's added time: the two mesh ways afresh, one step
    # each to warm up, then 6 steps each in turns (gspmd, int8, int8, gspmd, ...)
    order = list(ways)[1:]
    live = {label: start(ways[label]) for label in order}
    turns = {label: [] for label in order}
    for i, label in enumerate(order + (order + order[::-1]) * 3):
        params, state, step = live[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live[label][:2] = step(params, state, batches[i % steps])[:2]
        torch.cuda.synchronize()
        if i >= len(order):
            turns[label].append(time.perf_counter() - t0)
    del live, params, state, step
    n_leaves = len(_leaf_shapes(cfg))
    base, gspmd, int8 = (runs[k] for k in runs)
    check(gspmd["losses"] == base["losses"],
          f"gspmd on a world of one: losses {gspmd['losses']}, mesh=None {base['losses']}")
    check(base["launches"] == gspmd["launches"] == (0, 0),
          "the gspmd step launched a quantize kernel")
    check(int8["launches"] == (steps * n_leaves,) * 2,
          f"two_step_int8: quantize, dequantize launches {int8['launches']}, want "
          f"{steps * n_leaves} each ({n_leaves} leaves x {steps} steps)")
    rel0 = abs(int8["losses"][0] - gspmd["losses"][0]) / abs(gspmd["losses"][0])
    check(rel0 <= 1e-6, f"two_step_int8 step 0 loss rel {rel0:.2e} from gspmd's")
    for i, (a, b) in enumerate(zip(int8["losses"], gspmd["losses"])):
        check(abs(a - b) <= 1e-2 * abs(b), f"two_step_int8 step {i} loss {a} vs gspmd {b}")
    g_ms, i_ms = ([round(1e3 * t, 2) for t in ts] for ts in turns.values())
    print(f"collectives train: two_step_int8 adds "
          f"{statistics.median(i_ms) - statistics.median(g_ms):.2f} ms a warm step to gspmd's "
          f"({statistics.median(g_ms):.2f} ms; medians of 6 steps each in turns: gspmd {g_ms}, "
          f"two_step_int8 {i_ms} ms); step-0 loss rel "
          f"{rel0:.2e}, later losses rel "
          f"{[f'{abs(a - b) / abs(b):.2e}' for a, b in zip(int8['losses'], gspmd['losses'])]}"
          " (held to 1e-2)")
    return int8["launches"]


def phase_collectives():
    """Phase 15: the collective forms on NCCL with a world of one; returns
    the quantize and dequantize rows at the LM gradient leaf and their
    launches on the two_step_int8 train path."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    shapes = _leaf_shapes(configs.get("qwen2-0.5b"))
    rows = _lm_gradient_leaf_kernels(max(math.prod(s) for s in shapes))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(d, "rendezvous"),
                                rank=0, world_size=1)
        try:
            mesh = mesh_mod.make_test_mesh((1, 1), ("pod", "data"), "cuda")
            backends = {dist.get_backend(), *(dist.get_backend(mesh.get_group(a))
                                              for a in ("pod", "data"))}
            check(backends == {"nccl"}, f"collectives: backends {backends}, want nccl alone")
            print(f"collectives: NCCL world of one, mesh {mesh_mod.mesh_shape(mesh)} on "
                  f"{torch.cuda.get_device_name(0)}")
            _collective_aggregator(mesh, shapes)
            launches = _collective_train(mesh)
        finally:
            dist.destroy_process_group()
    return rows, launches


# ---------------------------------------------------------------------------
# phase 16: the event-simulator transport and the strategies that ride it
# ---------------------------------------------------------------------------

N_FC1 = 3136 * 2048                    # fc1_w of the full-width CNN
PAPER_PON = dict(n_onus=16, clients_per_onu=20)
LOADED = dict(dba="fl_priority", n_wavelengths=2, background_load=0.3)
FOREST = dict(n_pons=4, **PAPER_PON)   # 1,280 clients, 64 ONUs
# transport columns held card = CPU: the History row's, then the transport's own
ROW_COLUMNS = ("involved", "upstream_mbits", "uplink_models", "sim_engine", "metro_mbits",
               "trunk_mbits", "pon_mbits_max", "metro_mbits_max", "n_pons")
RT_COLUMNS = ("grant_delay_s", "n_fl_grants", "bg_mbits_served")


class _TransportTap:
    """While active, records every round's transport dict and its host time
    (the simulator's share of the round) by wrapping the RoundLoop's
    ``round_transport``."""

    def __enter__(self):
        from repro_torch.fl import loop
        self.loop, self.saved = loop, loop.round_transport
        self.rts, self.ms = [], []

        def tapped(*args, **kw):
            t = time.perf_counter()
            rt = self.saved(*args, **kw)
            self.ms.append(1e3 * (time.perf_counter() - t))
            self.rts.append(rt)
            return rt

        loop.round_transport = tapped
        return self

    def __exit__(self, *exc):
        self.loop.round_transport = self.saved


def _columns(res, modes, tap):
    """Per mode, per round: the transport columns of the row and of the
    transport's dict (rounds in run order, as the tap saw them)."""
    out, i = {}, 0
    for mode in modes:
        rows = list(res[mode]["loop"].history)
        out[mode] = [tuple(r.get(k) for k in ROW_COLUMNS)
                     + tuple(rt[k] for k in RT_COLUMNS)
                     for r, rt in zip(rows, tap.rts[i:i + len(rows)], strict=True)]
        i += len(rows)
    return out


def _zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def _run_both(label, kw, modes, data):
    """launch.run at full width on the card and at reduced width on the CPU
    from the same data and seed; the card's launches by kernel, both
    runs' transport columns held equal. Returns (card result, tap, counts)."""
    from repro_torch.launch import femnist as launch
    counters = _counters()
    _zero(counters)
    with _TransportTap() as tap:
        t0 = time.perf_counter()
        res = launch.run(**kw, modes=modes, full=True, device="cuda", data=data)
        wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    with _TransportTap() as cpu_tap:
        cpu = launch.run(**kw, modes=modes, full=False, device="cpu", data=data)
    got, want = _columns(res, modes, tap), _columns(cpu, modes, cpu_tap)
    for mode in modes:
        check(got[mode] == want[mode],
              f"transport [{label} {mode}]: card {got[mode]} vs CPU {want[mode]}")
    print(f"transport [{label}]: {' '.join(modes)}, card full width vs CPU reduced width: "
          f"transport columns equal ({sum(len(v) for v in got.values())} rounds), "
          f"wall {wall:.2f} s on the card")
    return res, tap, counts


def _print_rounds(label, res, modes, tap):
    i = 0
    for mode in modes:
        for r in res[mode]["loop"].history:
            rt, ms = tap.rts[i], tap.ms[i]
            i += 1
            seg = "".join(f" {k} {r[k]:.3f}" for k in ("metro_mbits", "trunk_mbits") if k in r)
            print(f"transport [{label}] {mode} round {r['round']}: involved "
                  f"{r['involved']:.0f}/{r['n_selected']} upstream_mbits "
                  f"{r['upstream_mbits']:.3f}{seg} uplink_models "
                  f"{r.get('uplink_models', 0):.0f} grant_delay_s {rt['grant_delay_s']:.6f} "
                  f"n_fl_grants {rt['n_fl_grants']} bg_mbits_served "
                  f"{rt['bg_mbits_served']:.3f} acc {r['acc']:.4f} wall_s {r['wall_s']:.3f} "
                  f"train_host_s {r.get('train_host_s', 0):.3f} aggregate_host_s "
                  f"{r.get('aggregate_host_s', 0):.4f} simulator host ms {ms:.2f}")
            check(0.0 <= r["acc"] <= 1.0, f"{label} {mode} acc {r['acc']}")
            if r["involved"] > 0:
                check(math.isfinite(r["eval_loss"]), f"{label} {mode} eval_loss")
        params = res[mode]["loop"].backend.params
        check(all(bool(torch.isfinite(v).all()) for v in params.values()),
              f"{label} {mode} params not finite")


def _trained(res, mode) -> int:
    return sum(1 for r in res[mode]["loop"].history if r["involved"] > 0)


def _check_launches(label, counts, want) -> None:
    want = {k: want.get(k, 0) for k in counts}
    print(f"transport [{label}]: launches {counts} (routing table: {want})")
    check(counts == want, f"{label}: launches {counts}, want {want}")


def _check_segments(label, res, mode, tap, start, wire) -> None:
    """Each round's per-segment Mbits against the closed-form budget
    (pon.expected_segment_mbits): hier_sfl's trunk is one model."""
    from repro_torch.pon import expected_segment_mbits
    transport = {"hier_sfl": "hier", "sfl_two_step": "sfl", "classical": "classical"}[mode]
    for r, rt in zip(res[mode]["loop"].history, tap.rts[start:], strict=False):
        want = expected_segment_mbits(transport, wire, r["n_selected"], rt["n_fl_jobs"],
                                      rt["n_metro_jobs"])
        got = {"pon": r["upstream_mbits"], "metro": r["metro_mbits"], "trunk": r["trunk_mbits"]}
        if transport == "hier" and r["trunk_mbits"] == 0.0:
            want["trunk"] = 0.0         # no Φ reached the metro node in time
        check(got == want, f"{label} {mode} round {r['round']}: segments {got} vs {want}")
        if transport == "hier":
            check(r["trunk_mbits"] in (0.0, wire) and r["n_pons"] == FOREST["n_pons"],
                  f"{label}: hier trunk {r['trunk_mbits']}, wire {wire}")


class _HierLevels:
    """While active, records the scales each tier's dequantize uses and
    each round's K: one quantization level of an aggregated element is
    Σ over the θ, Φ and Ψ rows of its leaf of the row's scale, / K."""

    def __enter__(self):
        from repro_torch.core import aggregation, compression
        self.mods = (compression, aggregation)
        self.saved = (compression._dequantize_kernel, aggregation.hier_aggregate)
        self.rows, self.K = [], []
        real_dq, real_hier = self.saved

        def dq(q, s, mask=None):
            self.rows.append(float(s.double().sum()))
            return real_dq(q, s, mask)

        def hier(*args, **kw):
            out = real_hier(*args, **kw)
            self.K.append(float(out[1]))
            return out

        compression._dequantize_kernel, aggregation.hier_aggregate = dq, hier
        return self

    def __exit__(self, *exc):
        compression, aggregation = self.mods
        compression._dequantize_kernel, aggregation.hier_aggregate = self.saved

    def bounds(self, names):
        n = len(names)
        return {name: sum(self.rows[t * n + i] for t in range(3)) / self.K[0]
                for i, name in enumerate(sorted(names))}


def _forest_parity(data) -> None:
    """One hier_sfl round of H = 1 over the forest at reduced width, card
    against CPU: uncompressed within 1e-4; int8 with the same noise on both
    (drawn on the CPU per call) within one level of every θ, Φ and Ψ row it
    sums, at most 0.1% of a leaf (at least one element) past 1e-5."""
    from repro_torch import configs
    from repro_torch.bridge import params_to_jax
    from repro_torch.core import compression
    from repro_torch.launch import femnist as launch
    from repro_torch.models import femnist_cnn
    from repro_torch.pon import PonConfig

    def cpu_noise(self, call, shapes):
        g = torch.Generator().manual_seed(2000 + call)
        return [torch.rand(tuple(s), generator=g).to(self.device) for s in shapes]

    p0 = femnist_cnn.init_params(configs.get("femnist_cnn").reduced(),
                                 torch.Generator().manual_seed(0), device="cpu")
    saved = compression.CompressionState.uniform_noise
    compression.CompressionState.uniform_noise = cpu_noise
    try:
        for compress in ("none", "int8"):
            kw = dict(n_rounds=1, n_selected=128, seed=0, modes=("hier_sfl",), local_steps=1,
                      pon=PonConfig(**FOREST, **LOADED), params=p0, data=data,
                      strategy_kwargs={"n_pons": FOREST["n_pons"]}, compress=compress)
            card = launch.run(**kw, device="cuda")["hier_sfl"]["loop"]
            with _HierLevels() as levels:
                cpu = launch.run(**kw, device="cpu")["hier_sfl"]["loop"]
            check(card.history.column("involved") == cpu.history.column("involved"),
                  f"forest parity {compress}: involvement differs")
            a, b = params_to_jax(card.backend.params), params_to_jax(cpu.backend.params)
            bounds = (levels.bounds(list(a)) if compress == "int8"
                      else dict.fromkeys(a, 1e-4 - 1e-5))
            worst, flips = 0.0, 0
            for k, lvl in bounds.items():
                diff = np.abs(a[k] - b[k])
                off = int((diff > 1e-5).sum())
                check(float(diff.max()) <= lvl + 1e-5
                      and (compress == "none" or off <= max(1, math.floor(1e-3 * diff.size))),
                      f"forest parity {compress} {k}: max |diff| {float(diff.max())} vs "
                      f"{lvl}, {off} elements past 1e-5")
                worst, flips = max(worst, float(diff.max())), flips + off
            print(f"transport [forest parity]: hier_sfl {compress}, reduced, H=1, card vs CPU: "
                  f"involved {card.history.column('involved')} equal, params max |diff| "
                  f"{worst:.3e} ({'atol 1e-4' if compress == 'none' else 'each within one level'}"
                  f"), {flips} elements past 1e-5")
    finally:
        compression.CompressionState.uniform_noise = saved


def _engine_sweep(data) -> None:
    """The forest's transport alone (no model) under each engine, 3 rounds
    of each strategy from one seed: fast equals event exactly, hybrid's
    difference printed; each engine's host ms a round."""
    from repro_torch import fl
    from repro_torch.core.fedavg import FLConfig
    from repro_torch.data import femnist
    from repro_torch.pon import PonConfig
    counts = femnist.sample_counts(data[0])
    onu = np.arange(len(counts)) // FOREST["clients_per_onu"]
    for mode in ("hier_sfl", "sfl_two_step", "classical"):
        rows, ms = {}, {}
        for engine in ("event", "fast", "hybrid"):
            pon = PonConfig(**FOREST, **LOADED, sim_engine=engine)
            exp = fl.ExperimentConfig(fl=FLConfig(n_selected=128, pon=pon, **FOREST), seed=0)
            skw = fl.filter_strategy_kwargs(mode, {"n_pons": FOREST["n_pons"]})
            loop = fl.RoundLoop(exp, fl.TransportBackend(fl.make_strategy(mode, **skw),
                                                         counts, onu))
            with _TransportTap() as tap:
                loop.run(3)
            rows[engine] = [(tuple(r.get(k) for k in ROW_COLUMNS if k != "sim_engine")
                             + tuple(rt[k] for k in RT_COLUMNS)
                             + (tuple(rt["t_done"]),))
                            for r, rt in zip(loop.history, tap.rts, strict=True)]
            ms[engine] = tap.ms
            check(loop.history.column("sim_engine") == [engine] * 3, f"{engine} stamp")
        check(rows["fast"] == rows["event"], f"engines [{mode}]: fast differs from event")
        diff = [sum(a != b for a, b in zip(h, e)) for h, e in zip(rows["hybrid"], rows["event"])]
        inv = [(h[0], e[0]) for h, e in zip(rows["hybrid"], rows["event"])]
        print(f"transport [engines] {mode}: fast == event exactly; hybrid differs from event "
              f"in {diff} of {len(ROW_COLUMNS) + len(RT_COLUMNS)} columns a round (involved "
              f"hybrid/event {inv}); host ms a round: "
              + ", ".join(f"{e} {' '.join(f'{t:.2f}' for t in ms[e])}" for e in ms))


def _forest_kernels(gen):
    """agg_reduce, the fused aggregate + quantize, quantize and dequantize at
    the forest's shapes at the fc1_w leaf: θ (128 rows, 64 segments), Φ (64
    θ rows, 4 segments, unit weights), Ψ (4 Φ rows, 1 segment); against
    their plain versions, timed, beside their bounds and ``torch.mm`` by the
    segment matrix. Returns each kernel's rows by shape."""
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels.agg_reduce import (agg_reduce_cost, agg_reduce_quant_cost,
                                                segment_agg_reduce, segment_agg_reduce_plain,
                                                segment_agg_reduce_quant,
                                                segment_agg_reduce_quant_plain)
    N = N_FC1
    out = {k: {} for k in ("agg_reduce", "agg_reduce_quant", "quantize_rows",
                           "dequantize_rows")}
    rng = np.random.default_rng(16)
    for tier, C, n_seg in (("θ", 128, 64), ("Φ", 64, 4), ("Ψ", 4, 1)):
        x = torch.randn((C, N), generator=gen, device="cuda") * 1e-2
        if tier == "θ":
            keep = (torch.rand(C, generator=gen, device="cuda") > 0.2).float()
            wm = (torch.rand(C, generator=gen, device="cuda") * 400 * keep).contiguous()
            seg = rng.integers(0, n_seg, C)                  # selection order
        else:
            wm = torch.ones(C, device="cuda")
            seg = np.arange(C) // (C // n_seg)               # θ rows by PON, Φ rows
        what = f"fc1_w, hier {tier} tier C={C} N={N} n_seg={n_seg}"
        got = segment_agg_reduce(x, wm, seg, n_seg)
        want = segment_agg_reduce_plain(x, wm, seg, n_seg)
        abs_sum = segment_agg_reduce_plain(x.abs(), wm.abs(), seg, n_seg)
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= ATOL + RTOL_OF_ABS_SUM * abs_sum).all()),
              f"agg_reduce disagrees with its plain version [{what}]: {err}")
        check(torch.equal(got, segment_agg_reduce(x, wm, seg, n_seg)),
              f"agg_reduce does not repeat bit for bit [{what}]")
        del abs_sum, want
        S = torch.zeros((n_seg, C), device="cuda")
        S[torch.as_tensor(seg, device="cuda"), torch.arange(C, device="cuda")] = wm
        out["agg_reduce"][tier] = _report(
            "agg_reduce", what, err, time_ms(lambda: segment_agg_reduce(x, wm, seg, n_seg)),
            time_ms(lambda: segment_agg_reduce_plain(x, wm, seg, n_seg)),
            time_ms(lambda: torch.mm(S, x)), *agg_reduce_cost(C, N, n_seg, 4).bound(),
            note=f" (<= {ATOL} + {RTOL_OF_ABS_SUM}·Σ|w·x|; library: torch.mm by the "
                 f"{n_seg}×{C} segment matrix)")
        if tier == "θ":
            u = torch.rand((n_seg, N), generator=gen, device="cuda")
            q, s = segment_agg_reduce_quant(x, wm, seg, n_seg, u, 8)
            qp, _ = segment_agg_reduce_quant_plain(x, wm, seg, n_seg, u, 8)
            s_theta = got.abs().amax(1).clamp_min(1e-12) / 127.0
            check(torch.equal(s, s_theta)
                  and torch.equal(q, kq.quantize_rows_plain(got, u, s_theta, 127.0)),
                  f"fused q differs from the unfused port route [{what}]")
            lvl = int((q.int() - qp.int()).abs().max())
            check(lvl <= 1, f"fused q off by {lvl} levels [{what}]")
            out["agg_reduce_quant"][tier] = _report(
                "agg_reduce_quant", what + " int8", float(lvl),
                time_ms(lambda: segment_agg_reduce_quant(x, wm, seg, n_seg, u, 8)),
                time_ms(lambda: segment_agg_reduce_quant_plain(x, wm, seg, n_seg, u, 8)), None,
                *agg_reduce_quant_cost(C, N, n_seg, 4).bound(), note=" levels (θ bit for bit)")
            m = (torch.arange(n_seg, device="cuda") % 7 != 0).float()   # silent ONUs
            del qp, u
        else:
            m = None
            u = torch.rand(got.shape, generator=gen, device="cuda")
            s = got.abs().amax(1).clamp_min(1e-12) / 127.0
            q = kq.quantize_rows(got, u, s, 127.0)
            check(torch.equal(q, kq.quantize_rows_plain(got, u, s, 127.0)),
                  f"quantize_rows differs [{what}]")
            R = got.shape[0]
            out["quantize_rows"][tier] = _report(
                "quantize_rows", f"fc1_w, hier {tier} rows R={R} N={N} int8", 0.0,
                time_ms(lambda: kq.quantize_rows(got, u, s, 127.0)),
                time_ms(lambda: kq.quantize_rows_plain(got, u, s, 127.0)), None,
                *kq.quantize_cost(R, N, 4).bound(), note=" (bit for bit)")
            del u
        R = q.shape[0]
        check(torch.equal(kq.dequantize_rows(q, s, m), kq.dequantize_rows_plain(q, s, m)),
              f"dequantize_rows differs [{tier}]")
        out["dequantize_rows"][tier] = _report(
            "dequantize_rows", f"fc1_w, hier {tier} rows R={R} N={N}", 0.0,
            time_ms(lambda: kq.dequantize_rows(q, s, m)),
            time_ms(lambda: kq.dequantize_rows_plain(q, s, m)),
            time_ms(lambda: torch.mul(q, s[:, None])), *kq.dequantize_cost(R, N, m is not None).bound(),
            note=" (bit for bit; library: torch.mul(q, s))")
        del x, got, q, S
        torch.cuda.empty_cache()
    return out


def phase_transport():
    """Phase 16; returns (the kernels' rows at the forest's shapes, the
    main path's launches by kernel)."""
    from repro_torch.pon import MODEL_UPDATE_MBITS, PonConfig

    launches = dict.fromkeys(_counters(), 0)
    paper, forest = _population(320), _population(1280)

    # (a) the paper's PON under the event simulator, then one round a DBA
    kw = dict(n_rounds=3, n_selected=128, seed=0, pon=PonConfig(**PAPER_PON, **LOADED))
    modes = ("sfl_two_step", "classical")
    res, tap, counts = _run_both("paper PON fl_priority", kw, modes, paper)
    _print_rounds("paper PON fl_priority", res, modes, tap)
    _check_launches("paper PON fl_priority", counts,
                    {"agg_reduce": 8 * sum(_trained(res, m) for m in modes)})
    launches["agg_reduce"] += counts["agg_reduce"]
    for dba in ("fifo", "tdma", "ipact"):
        kw = dict(n_rounds=1, n_selected=128, seed=0,
                  pon=PonConfig(**PAPER_PON, **dict(LOADED, dba=dba)))
        res, tap, counts = _run_both(f"paper PON {dba}", kw, modes, paper)
        _print_rounds(f"paper PON {dba}", res, modes, tap)
        launches["agg_reduce"] += counts["agg_reduce"]

    # (b) the forest: hier_sfl against the flat strategies, then int8 tiers
    from repro_torch.launch import femnist as launch
    pon = PonConfig(**FOREST, **LOADED)
    skw = {"n_pons": FOREST["n_pons"]}
    modes = ("hier_sfl", "sfl_two_step", "classical")
    counters = _counters()
    _zero(counters)
    with _TransportTap() as tap:
        t = time.perf_counter()
        res = launch.run(n_rounds=3, n_selected=128, full=True, seed=0, modes=modes, pon=pon,
                         device="cuda", data=forest, strategy_kwargs=skw)
        wall = time.perf_counter() - t
    counts = {k: fn.launches for k, fn in counters.items()}
    _print_rounds("forest", res, modes, tap)
    for i, mode in enumerate(modes):
        _check_segments("forest", res, mode, tap, 3 * i, MODEL_UPDATE_MBITS)
    trained = {m: _trained(res, m) for m in modes}
    print(f"transport [forest]: 4 PONs x 16 ONUs x 20 clients, wall {wall:.2f} s, trained "
          f"rounds {trained}")
    _check_launches("forest", counts, {"agg_reduce": 8 * (3 * trained["hier_sfl"]
                                                          + trained["sfl_two_step"]
                                                          + trained["classical"])})
    check(trained["hier_sfl"] > 0, "forest: hier_sfl never trained")
    for k in launches:
        launches[k] += counts[k]
    event_rows = [tuple(r.get(k) for k in ROW_COLUMNS if k != "sim_engine")
                  for r in res["hier_sfl"]["loop"].history]
    _zero(counters)
    with _TransportTap() as tap:
        res = launch.run(n_rounds=3, n_selected=128, full=True, seed=0, modes=("hier_sfl",),
                         pon=pon, device="cuda", data=forest, strategy_kwargs=skw,
                         compress="int8")
    counts = {k: fn.launches for k, fn in counters.items()}
    _print_rounds("forest int8", res, ("hier_sfl",), tap)
    wire = MODEL_UPDATE_MBITS / 4
    _check_segments("forest int8", res, "hier_sfl", tap, 0, wire)
    n = _trained(res, "hier_sfl")
    _check_launches("forest int8", counts, {"agg_reduce_quant": 8 * n, "agg_reduce": 16 * n,
                                            "quantize_rows": 16 * n, "dequantize_rows": 24 * n})
    check(n > 0 and all(r["wire_mbits"] == wire for r in res["hier_sfl"]["loop"].history),
          "forest int8: wire")
    for k in launches:
        launches[k] += counts[k]
    _forest_parity(forest)

    # (c) the engines: the forest's hier_sfl round under fast and hybrid
    for engine in ("fast", "hybrid"):
        with _TransportTap() as tap:
            res = launch.run(n_rounds=3, n_selected=128, full=True, seed=0,
                             modes=("hier_sfl",), device="cuda", data=forest,
                             pon=PonConfig(**FOREST, **LOADED, sim_engine=engine),
                             strategy_kwargs=skw)
        _print_rounds(f"forest {engine}", res, ("hier_sfl",), tap)
        rows = [tuple(r.get(k) for k in ROW_COLUMNS if k != "sim_engine")
                for r in res["hier_sfl"]["loop"].history]
        check(engine == "hybrid" or rows == event_rows,
              f"forest {engine}: transport {rows} vs event {event_rows}")
        print(f"transport [forest {engine}]: hier_sfl transport columns "
              f"{'equal' if rows == event_rows else 'differ from'} the event engine's")
    _engine_sweep(forest)

    # (d) the kernels at the forest's shapes
    rows = _forest_kernels(torch.Generator(device="cuda").manual_seed(16))
    return rows, launches


# ---------------------------------------------------------------------------
# phase 17: the event-driven runtime
# ---------------------------------------------------------------------------

# the columns of a runtime row held card = CPU, and its host-time keys
RUNTIME_COLUMNS = ("t_s", "version", "involved", "upstream_mbits", "metro_mbits",
                   "staleness_mean", "staleness_max", "in_flight", "n_selected", "wire_mbits")
HOST_KEYS = ("wall_s", "dispatch_host_s", "train_host_s", "aggregate_host_s")
_POPULATIONS: dict = {}


def _population(n_clients: int):
    """``femnist.generate`` of ``n_clients`` at seed 7, made once a process
    (1,280 clients take seconds on the host)."""
    from repro_torch.data import femnist
    if n_clients not in _POPULATIONS:
        t = time.perf_counter()
        _POPULATIONS[n_clients] = femnist.generate(
            femnist.FemnistConfig(n_clients=n_clients, seed=7))
        print(f"femnist.generate of {n_clients} clients on the host: "
              f"{time.perf_counter() - t:.2f} s")
    return _POPULATIONS[n_clients]


def _runtime_exp(policy, mode, pon_kw, skw=None, compress="none", local_steps=8, **pon_extra):
    """The paper's FL setting (N = 128, batch 10, lr 0.06, seed 0) under
    ``policy`` (fedbuff: buffer_k 8, concurrency 0 = N)."""
    from repro_torch import fl
    from repro_torch.core.fedavg import FLConfig
    from repro_torch.pon import PonConfig
    skw = dict(skw or {}, **({"compress": compress} if compress != "none" else {}))
    topo = {k: pon_kw[k] for k in ("n_onus", "clients_per_onu", "n_pons") if k in pon_kw}
    flc = FLConfig(n_selected=128, local_steps=local_steps, local_lr=0.06,
                   pon=PonConfig(**pon_kw, **pon_extra), **topo)
    return fl.ExperimentConfig(fl=flc, strategy=mode, strategy_kwargs=tuple(sorted(skw.items())),
                               policy=policy, buffer_k=8, concurrency=0, seed=0)


class _SeamTap:
    """While active, counts and times (host clock, card synchronised) every
    ``client_update`` and ``apply_updates`` of the client-stacked backend."""

    def __enter__(self):
        from repro_torch.device import timed
        from repro_torch.fl.backends import ClientStackedBackend as B
        self.cls, self.saved = B, (B.client_update, B.apply_updates)
        self.dispatch_ms, self.apply_ms = [], []
        cu, au = self.saved

        def client_update(backend, *a):
            out, dt = timed(cu, backend, *a)
            self.dispatch_ms.append(1e3 * dt)
            return out

        def apply_updates(backend, *a):
            out, dt = timed(au, backend, *a)
            self.apply_ms.append(1e3 * dt)
            return out

        B.client_update, B.apply_updates = client_update, apply_updates
        return self

    def __exit__(self, *exc):
        self.cls.client_update, self.cls.apply_updates = self.saved


def _runtime_columns(hist):
    return [tuple(r.get(k) for k in RUNTIME_COLUMNS) for r in hist]


def _runtime_run(label, exp, n_updates, data, per_update, full=True):
    """femnist_async.run on the card at full width: launches against the
    routing table (``per_update`` launches for each update with an
    arrival), the times, every value finite; then the same experiment on
    the CPU at reduced width, its transport columns and upstream total held
    equal. Returns (history, orchestrator, launches)."""
    from repro_torch.launch import femnist_async
    counters = _counters()
    _zero(counters)
    gc.collect()                # the last run's orchestrator (a cycle) and its deltas
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _SeamTap() as tap:
        t0 = time.perf_counter()
        hist, orch = femnist_async.run(exp, full=full, n_updates=n_updates, data=data,
                                       device="cuda")
        wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    updated = sum(1 for r in hist if r["involved"] > 0)
    want = {k: per_update.get(k, 0) * updated for k in counters}
    rows = list(hist)
    sim_ms = [1e3 * (r["wall_s"] - r["dispatch_host_s"]) - a for r, a in zip(rows, tap.apply_ms)]
    for r, sim in zip(rows, sim_ms):
        print(f"runtime [{label}] update {r['round']}: t_s {r['t_s']:.3f} version "
              f"{r['version']} involved {r['involved']:.0f} in_flight {r.get('in_flight')} "
              f"upstream_mbits {r['upstream_mbits']:.3f}"
              + (f" metro_mbits {r['metro_mbits']:.3f}" if "metro_mbits" in r else "")
              + f" staleness {r['staleness_mean']:.3f}/{r['staleness_max']:.0f} acc "
              f"{r.get('acc', 0.0):.4f} wall_s {r['wall_s']:.3f} dispatch_host_s "
              f"{r['dispatch_host_s']:.3f} aggregate_host_s {r.get('aggregate_host_s', 0.0):.4f} "
              f"simulator host ms {sim:.2f}")
        if r["involved"] > 0:
            check(math.isfinite(r["eval_loss"]) and 0.0 <= r["acc"] <= 1.0,
                  f"runtime [{label}] update {r['round']}: eval {r.get('eval_loss')}")
    check(all(bool(torch.isfinite(v).all()) for v in orch.backend.params.values()),
          f"runtime [{label}]: params not finite")
    n_disp = len(tap.dispatch_ms)
    print(f"runtime [{label}]: {len(rows)} rows, {updated} updates with arrivals, {n_disp} "
          f"dispatches, ms a dispatch median {statistics.median(tap.dispatch_ms):.2f} (min "
          f"{min(tap.dispatch_ms):.2f}, max {max(tap.dispatch_ms):.2f}), apply_updates ms "
          f"median {statistics.median(tap.apply_ms):.2f}, simulator host ms an update median "
          f"{statistics.median(sim_ms):.2f}; simulated {rows[-1]['t_s']:.1f} s in {wall:.2f} "
          f"s of wall; peak device memory {peak:.2f} GiB; upstream total "
          f"{orch.total_upstream_mbits:.3f} Mb")
    print(f"runtime [{label}]: launches {counts} (routing table: {want})")
    check(updated > 0 and counts == want, f"runtime [{label}]: launches {counts}, want {want}")
    cpu_hist, cpu_orch = femnist_async.run(exp, full=False, n_updates=n_updates, data=data,
                                           device="cpu")
    got, ref = _runtime_columns(hist), _runtime_columns(cpu_hist)
    check(got == ref and orch.total_upstream_mbits == cpu_orch.total_upstream_mbits,
          f"runtime [{label}]: card {got} vs CPU {ref}; totals {orch.total_upstream_mbits} vs "
          f"{cpu_orch.total_upstream_mbits}")
    print(f"runtime [{label}]: card full width vs CPU reduced width: transport columns equal "
          f"({len(got)} rows), upstream totals equal")
    return hist, orch, counts


def _sync_vs_loop(data) -> None:
    """(a) 3 rounds of phase 4's setting through the RoundLoop twice and the
    sync policy once, on the card."""
    from repro_torch.launch import femnist as launch
    from repro_torch.launch import femnist_async
    from repro_torch.pon import PonConfig
    kw = dict(n_rounds=3, n_selected=128, full=True, seed=0, modes=("sfl_two_step",),
              pon=PonConfig(**PAPER_PON), device="cuda", data=data)
    a, b = (launch.run(**kw)["sfl_two_step"]["loop"] for _ in range(2))
    hist, orch = femnist_async.run(_runtime_exp("sync", "sfl_two_step", PAPER_PON), full=True,
                                   n_updates=3, data=data, device="cuda")

    def rows(h, drop=()):
        return [{k: v for k, v in r.items() if k not in HOST_KEYS + drop} for r in h]
    same = rows(a.history) == rows(b.history) and all(
        torch.equal(a.backend.params[k], b.backend.params[k]) for k in a.backend.params)
    print(f"runtime [sync]: the RoundLoop repeats itself bit for bit on the card: {same}")
    got = rows(hist, ("t_s", "policy", "version"))
    check(hist.column("t_s") == [25.0 * (i + 1) for i in range(3)],
          f"runtime [sync]: t_s {hist.column('t_s')}")
    if same:
        check(got == rows(a.history) and all(
            torch.equal(orch.backend.params[k], a.backend.params[k]) for k in a.backend.params),
              "runtime [sync]: the sync policy differs from the RoundLoop")
        print("runtime [sync]: 3 rounds, every column but the host-time keys and the "
              "parameters equal the RoundLoop's bit for bit")
        return
    transport = ("round", "n_selected", "sim_engine", "involved", "upstream_mbits",
                 "uplink_models")
    for g, r in zip(got, rows(a.history), strict=True):
        check({k: g[k] for k in transport} == {k: r[k] for k in transport},
              f"runtime [sync]: transport {g} vs {r}")
    for key in ("acc", "eval_loss"):
        spread = max(abs(x - y) for x, y in zip(a.history.column(key), b.history.column(key)))
        off = max(abs(x - y) for x, y in zip(hist.column(key), a.history.column(key)))
        print(f"runtime [sync]: {key} |sync − loop| {off:.3e}, spread of two loops {spread:.3e}")
        check(off <= 2 * spread, f"runtime [sync]: {key} off {off} vs spread {spread}")
    spread = max(float((a.backend.params[k] - b.backend.params[k]).abs().max())
                 for k in a.backend.params)
    off = max(float((orch.backend.params[k] - a.backend.params[k]).abs().max())
              for k in a.backend.params)
    print(f"runtime [sync]: params |sync − loop| {off:.3e}, spread of two loops {spread:.3e}")
    check(off <= 2 * spread, f"runtime [sync]: params off {off} vs spread {spread}")


def _runtime_parity() -> None:
    """(e) fedbuff to 3 updates at reduced width, H = 1, card against CPU:
    sfl_two_step, and int8 with the same noise on both (drawn on the CPU per
    call): parameters within 1e-4."""
    from repro_torch import configs
    from repro_torch.core import compression
    from repro_torch.launch import femnist_async
    from repro_torch.models import femnist_cnn

    def cpu_noise(self, call, shapes):
        g = torch.Generator().manual_seed(3000 + call)
        return [torch.rand(tuple(s), generator=g).to(self.device) for s in shapes]

    p0 = femnist_cnn.init_params(configs.get("femnist_cnn").reduced(),
                                 torch.Generator().manual_seed(0), device="cpu")
    saved = compression.CompressionState.uniform_noise
    compression.CompressionState.uniform_noise = cpu_noise
    try:
        for compress in ("none", "int8"):
            exp = _runtime_exp("fedbuff", "sfl_two_step", dict(**PAPER_PON, **LOADED),
                               compress=compress, local_steps=1)
            out = [femnist_async.run(exp, n_updates=3, params=p0, device=dev,
                                     data=_population(320))
                   for dev in ("cuda", "cpu")]
            (h, o), (hc, oc) = out
            check(_runtime_columns(h) == _runtime_columns(hc),
                  f"runtime parity {compress}: transport columns differ")
            diffs = [(o.backend.params[k].cpu() - oc.backend.params[k]).abs() for k in p0]
            worst = max(float(d.max()) for d in diffs)
            off = sum(int((d > 1e-5).sum()) for d in diffs)
            print(f"runtime [parity]: fedbuff sfl_two_step {compress}, reduced, H=1, 3 updates, "
                  f"card vs CPU: params max |diff| {worst:.3e} (held to 1e-4), {off} of "
                  f"{sum(d.numel() for d in diffs)} elements past 1e-5")
            check(worst <= 1e-4, f"runtime parity {compress}: params differ by {worst}")
    finally:
        compression.CompressionState.uniform_noise = saved


def _runtime_lm() -> dict:
    """(g) launch.train.run with the runtime driver against the loop driver:
    qwen2-0.5b at full width, batch 8 × 2048, adamw, 2 steps. Returns the
    runtime run's launches by kernel."""
    from repro_torch.launch import train
    res, counts = {}, {}
    for driver in ("loop", "runtime"):
        for fn in _lm_counters().values():
            _zero_launches(fn)
        torch.cuda.empty_cache()
        res[driver] = train.run("qwen2-0.5b", steps=2, opt="adamw", seed=0, log_every=1,
                                device="cuda", driver=driver, **TRAIN)
        counts[driver] = _train_counts()
        want = _train_routing(res[driver]["cfg"], 2, 1)
        check(counts[driver] == want, f"runtime [lm {driver}]: launches {counts[driver]}, "
                                      f"want {want}")
    keys = ("round", "n_selected", "sim_engine", "involved", "upstream_mbits")
    for r, lp in zip(res["runtime"]["history"], res["loop"]["history"], strict=True):
        rel = abs(r["loss"] - lp["loss"]) / abs(lp["loss"])
        print(f"runtime [lm]: step {r['round']} t_s {r['t_s']} loss {r['loss']:.6f}, loop "
              f"{lp['loss']:.6f} (rel {rel:.2e}, held to 1e-2); dt {r['dt']:.3f} s, loop "
              f"{lp['dt']:.3f} s")
        check({k: r[k] for k in keys} == {k: lp[k] for k in keys} and rel <= 1e-2
              and math.isfinite(r["grad_norm"]), f"runtime [lm]: step {r['round']} differs")
    del res
    torch.cuda.empty_cache()
    return {"flash_attention": counts["runtime"]["flash_attention"]["launches"],
            "flash_attention_bwd": counts["runtime"]["flash_attention"]["launches_bwd"]}


def _runtime_kernels(gen):
    """(h) agg_reduce at fc1_w at the runtime's shapes: 8 rows (a fedbuff
    buffer) into 16 ONU segments, 64 (the forest) and one (classical)."""
    from repro_torch.kernels.agg_reduce import (agg_reduce_cost, segment_agg_reduce,
                                                segment_agg_reduce_plain)
    N, C, out = N_FC1, 8, {}
    rng = np.random.default_rng(17)
    x = torch.randn((C, N), generator=gen, device="cuda") * 1e-2
    wm = (torch.rand(C, generator=gen, device="cuda") * 400).contiguous()
    for n_seg in (16, 64, 1):
        seg = rng.integers(0, n_seg, C)
        what = f"fc1_w, runtime buffer C={C} N={N} n_seg={n_seg}"
        got = segment_agg_reduce(x, wm, seg, n_seg)
        want = segment_agg_reduce_plain(x, wm, seg, n_seg)
        abs_sum = segment_agg_reduce_plain(x.abs(), wm.abs(), seg, n_seg)
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= ATOL + RTOL_OF_ABS_SUM * abs_sum).all()),
              f"agg_reduce disagrees with its plain version [{what}]: {err}")
        check(torch.equal(got, segment_agg_reduce(x, wm, seg, n_seg)),
              f"agg_reduce does not repeat bit for bit [{what}]")
        S = torch.zeros((n_seg, C), device="cuda")
        S[torch.as_tensor(seg, device="cuda"), torch.arange(C, device="cuda")] = wm
        out[f"{C}x{n_seg}"] = _report(
            "agg_reduce", what, err, time_ms(lambda: segment_agg_reduce(x, wm, seg, n_seg)),
            time_ms(lambda: segment_agg_reduce_plain(x, wm, seg, n_seg)),
            time_ms(lambda: torch.mm(S, x)), *agg_reduce_cost(C, N, n_seg, 4).bound(),
            note=f" (library: torch.mm by the {n_seg}×{C} segment matrix)")
        del got, want, abs_sum, S
    return out


def phase_runtime():
    """Phase 17; returns (the kernel's rows at the runtime's shapes, the
    main path's launches by kernel)."""
    from repro_torch.pon import MODEL_UPDATE_MBITS
    from repro_torch.pon.fast import orchestrator_engine

    paper, forest = _population(320), _population(1280)
    launches = dict.fromkeys(_counters(), 0)
    _sync_vs_loop(paper)

    loaded = dict(**PAPER_PON, **LOADED)
    runs = (  # (label, experiment, updates, data, launches an update: the routing table)
        ("semi_sync sfl_two_step", _runtime_exp("semi_sync", "sfl_two_step", loaded), 3, paper,
         {"agg_reduce": 8}),
        ("semi_sync classical", _runtime_exp("semi_sync", "classical", loaded), 3, paper,
         {"agg_reduce": 8}),
        ("fedbuff sfl_two_step", _runtime_exp("fedbuff", "sfl_two_step", loaded), 10, paper,
         {"agg_reduce": 8}),
        ("fedbuff fedopt yogi", _runtime_exp("fedbuff", "fedopt", loaded,
                                             {"server_opt": "yogi"}), 10, paper,
         {"agg_reduce": 8}),
        ("fedbuff sfl_two_step int8", _runtime_exp("fedbuff", "sfl_two_step", loaded,
                                                   compress="int8"), 10, paper,
         {"agg_reduce_quant": 8, "dequantize_rows": 8}),
        ("fedbuff hier_sfl forest", _runtime_exp("fedbuff", "hier_sfl", dict(**FOREST, **LOADED),
                                                 {"n_pons": FOREST["n_pons"]}), 10, forest,
         {"agg_reduce": 24}),
    )
    hists = {}
    for label, exp, n, data, per_update in runs:
        hist, orch, counts = _runtime_run(label, exp, n, data, per_update)
        hists[label] = hist
        for k in launches:
            launches[k] += counts[k]
        if "int8" in label:
            check(all(r["wire_mbits"] == MODEL_UPDATE_MBITS / 4 and r["compress"] == "int8"
                      for r in hist), f"runtime [{label}]: wire")
        if label.startswith("semi_sync"):
            check(hist.column("t_s") == [25.0 * (i + 1) for i in range(3)],
                  f"runtime [{label}]: t_s {hist.column('t_s')}")
        else:
            check(hist.last()["version"] == n, f"runtime [{label}]: {hist.last()['version']} "
                                               f"updates")
        if "forest" in label:       # whole Φs on the metro segment, ≤ one a PON an update
            phis = [r["metro_mbits"] / MODEL_UPDATE_MBITS for r in hist]
            check(all(abs(k - round(k)) < 1e-9 for k in phis) and sum(phis) > 0,
                  f"runtime [{label}]: metro Φs {phis}")
        del orch
    check(any(r["staleness_max"] >= 1.0 for r in hists["semi_sync sfl_two_step"]),
          "runtime: semi_sync carried no straggler")
    _runtime_parity()

    # (f) the fluid engine
    exp = _runtime_exp("fedbuff", "sfl_two_step", loaded, sim_engine="fast")
    check(orchestrator_engine(exp.fl.pon_config(), "sfl") == "fluid",
          "runtime [fluid]: the engine is not fluid")
    hist, _, counts = _runtime_run("fedbuff sfl_two_step fluid", exp, 10, paper,
                                   {"agg_reduce": 8})
    for k in launches:
        launches[k] += counts[k]
    differ = _runtime_columns(hist) != _runtime_columns(hists["fedbuff sfl_two_step"])
    print(f"runtime [fluid]: transport columns {'differ from' if differ else 'equal'} the event "
          "engine's")

    lm = _runtime_lm()
    rows = _runtime_kernels(torch.Generator(device="cuda").manual_seed(17))
    return rows, launches, lm


# ---------------------------------------------------------------------------
# phase 18: observability
# ---------------------------------------------------------------------------

OBS_KEYS = HOST_KEYS + ("incidents",)   # a traced row's keys the untraced lacks


def _obs_rows(hist):
    return [{k: v for k, v in r.items() if k not in OBS_KEYS} for r in hist]


def _obs_session(tmp, name):
    """A live session writing every artifact under ``tmp``: the trace, the
    merged metrics, the run bundle, the incidents (health on)."""
    from repro_torch import obs
    base = os.path.join(tmp, name)
    return obs.session(trace_out=base + ".trace.json", metrics_out=base + ".metrics.jsonl",
                       report_out=base + ".report.json", incidents_out=base + ".inc.jsonl",
                       health=True, driver="round_loop")


def _grant_spans(tracer) -> int:
    """Grant spans of FL jobs (θs, classical uploads), background excluded."""
    return sum(1 for s in tracer.spans if s.cat == "grant" and s.name in ("theta", "fl"))


def _obs_slice(data, tmp) -> dict:
    """(a) Phase 4's setting untraced twice and traced once (trace, metrics,
    bundle, health): the History, parameters and launches against the
    untraced runs, the registry against the rows, one grant span per served
    FL job. Returns the traced run's launches."""
    from repro_torch.launch import femnist as launch
    from repro_torch.obs.audit import RunReport
    from repro_torch.pon import PonConfig
    modes = ("sfl_two_step", "classical")
    kw = dict(n_rounds=3, n_selected=128, full=True, seed=0, modes=modes,
              pon=PonConfig(**PAPER_PON), device="cuda", data=data)
    counters = _counters()
    runs = []
    for traced in (False, False, True):
        _zero(counters)
        sess = _obs_session(tmp, "slice") if traced else None
        try:
            with _TransportTap() as tap:
                res = launch.run(**kw)
        finally:
            if sess is not None:
                last = res[modes[-1]]["loop"]
                sess.finish(quiet=True, cfg=last.cfg, history=last.history)
        runs.append((res, tap, {k: fn.launches for k, fn in counters.items()}))
    (a, _, ca), (b, _, _), (t, tap, ct) = runs
    check(ct == ca, f"obs [slice]: traced launches {ct}, untraced {ca}")
    same = all(_obs_rows(a[m]["loop"].history) == _obs_rows(b[m]["loop"].history) and all(
        torch.equal(a[m]["loop"].backend.params[k], b[m]["loop"].backend.params[k])
        for k in a[m]["loop"].backend.params) for m in modes)
    print(f"obs [slice]: the untraced RoundLoop repeats itself bit for bit on the card: {same}")
    transport = ("round", "n_selected", "sim_engine", "involved", "upstream_mbits",
                 "uplink_models")
    for m in modes:
        la, lb, lt = (r[m]["loop"] for r in (a, b, t))
        if same:
            check(_obs_rows(lt.history) == _obs_rows(la.history) and all(
                torch.equal(lt.backend.params[k], la.backend.params[k])
                for k in la.backend.params), f"obs [slice {m}]: traced differs from untraced")
            continue
        for g, r in zip(_obs_rows(lt.history), _obs_rows(la.history), strict=True):
            check({k: g[k] for k in transport} == {k: r[k] for k in transport},
                  f"obs [slice {m}]: transport {g} vs {r}")
        for key in ("acc", "eval_loss"):
            spread = max(abs(x - y) for x, y in zip(la.history.column(key),
                                                    lb.history.column(key)))
            off = max(abs(x - y) for x, y in zip(lt.history.column(key), la.history.column(key)))
            check(off <= 2 * spread, f"obs [slice {m}]: {key} off {off} vs spread {spread}")
    # the registry is the accounting: each loop's total is its rows' sum
    totals = []
    for m in modes:
        loop = t[m]["loop"]
        rows = loop.history.column("upstream_mbits")
        check(loop.total_upstream_mbits == sum(rows),
              f"obs [slice {m}]: registry {loop.total_upstream_mbits} vs rows {sum(rows)}")
        totals.append(loop.total_upstream_mbits)
    rep = RunReport.load(os.path.join(tmp, "slice.report.json"))
    (merged,) = [r["total"] for r in rep.metrics if r["name"] == "pon.upstream_mbits"]
    check(merged == totals[0] + totals[1], f"obs [slice]: merged {merged} vs {totals}")
    with open(os.path.join(tmp, "slice.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = sum(1 for e in events if e["ph"] == "X")
    served = sum(rt["n_fl_grants"] for rt in tap.rts)
    grants = sum(1 for e in events if e["ph"] == "X" and e.get("cat") == "grant"
                 and e["name"] in ("theta", "fl"))
    check(grants == served > 0, f"obs [slice]: {grants} grant spans, {served} served FL jobs")
    hist_rows = {(r["kind"], r["name"]): r for r in rep.metrics}
    trained = sum(1 for m in modes for r in t[m]["loop"].history if r["involved"] > 0)
    check(hist_rows[("histogram", "backend.train_s")]["count"] == trained,
          f"obs [slice]: backend.train_s {hist_rows[('histogram', 'backend.train_s')]}")
    print(f"obs [slice]: 3 rounds each of {' and '.join(modes)} traced with health: History "
          f"{'bit for bit' if same else 'transport exact, the rest within the spread'} the "
          f"untraced run's, launches {ct} = untraced; pon.upstream_mbits {merged:.3f} = the rows' "
          f"sum; {grants} grant spans = {served} served FL jobs; {spans} spans, "
          f"{len(rep.incidents)} incidents, bundle cfg {rep.config_hash}, trace "
          f"{os.path.getsize(os.path.join(tmp, 'slice.trace.json')) / 1e3:.1f} kB; "
          f"backend.train_s count {trained}")
    return ct


def _obs_transport_cost(paper, forest, tmp) -> dict:
    """(b) One classical round on phase 16's loaded paper PON and on its
    forest, untraced and traced in turns (3 pairs): the rows equal, the span
    count, and the host ms tracing adds a round (the row's wall_s, card
    synchronised); then the round's transport alone, 10 pairs in turns, for
    the simulator's share. Returns the traced rounds' launches."""
    from repro_torch import obs
    from repro_torch.core import selection
    from repro_torch.core.fedavg import FLConfig, onu_of_client, round_transport
    from repro_torch.data import femnist
    from repro_torch.launch import femnist as launch
    from repro_torch.pon import PonConfig
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    for label, topo, data in (("paper PON", PAPER_PON, paper), ("forest", FOREST, forest)):
        pon = PonConfig(**topo, **LOADED)
        walls, spans, rows = {False: [], True: []}, [], []
        for traced in (False, True) * 3:
            _zero(counters)
            sess = obs.session(trace_out=os.path.join(tmp, "cost.trace.json")) if traced else None
            try:
                with _TransportTap() as tap:
                    res = launch.run(n_rounds=1, n_selected=128, full=True, seed=0,
                                     modes=("classical",), pon=pon, device="cuda", data=data)
            finally:
                if sess is not None:
                    spans.append(len(sess.tracer.spans))
                    sess.finish(quiet=True)
            r = res["classical"]["loop"].history.last()
            walls[traced].append(1e3 * r["wall_s"])
            rows.append({k: r.get(k) for k in ROW_COLUMNS} | {k: tap.rts[0][k]
                                                             for k in RT_COLUMNS})
            if traced:
                for k, fn in counters.items():
                    launches[k] += fn.launches
        check(all(x == rows[0] for x in rows) and len(set(spans)) == 1,
              f"obs [{label}]: traced rounds differ: {rows}, spans {spans}")
        # the transport alone: one selection, the round's draws from seed 1
        flc = FLConfig(n_selected=128, pon=pon, **topo)
        counts, onu = femnist.sample_counts(data[0]), onu_of_client(flc)
        sel = selection.select_clients(np.random.default_rng(0), flc.n_clients, 128, 0.0)
        sims = {False: [], True: []}
        for traced in (False, True) * 10:
            o = obs.Obs.enabled_tracing() if traced else obs.Obs()
            t = time.perf_counter()
            round_transport(flc, np.random.default_rng(1), sel, counts, onu, mode="classical",
                            obs=o)
            sims[traced].append(1e3 * (time.perf_counter() - t))
        add_wall = statistics.median(walls[True]) - statistics.median(walls[False])
        add_sim = statistics.median(sims[True]) - statistics.median(sims[False])
        q = lambda xs: statistics.quantiles(xs, n=4)  # noqa: E731
        print(f"obs [{label} classical]: {spans[0]} spans a traced round. The round's wall: "
              f"untraced {', '.join(f'{x:.2f}' for x in walls[False])} ms, traced "
              f"{', '.join(f'{x:.2f}' for x in walls[True])} ms (medians' difference "
              f"{add_wall:.2f} ms). The transport alone, 10 pairs: untraced median "
              f"{statistics.median(sims[False]):.2f} ms (quartiles {q(sims[False])[0]:.2f}-"
              f"{q(sims[False])[2]:.2f}), traced {statistics.median(sims[True]):.2f} ms "
              f"({q(sims[True])[0]:.2f}-{q(sims[True])[2]:.2f}): tracing adds {add_sim:.2f} ms "
              f"a round; rows equal")
    return launches


def _obs_fedbuff(paper, tmp) -> dict:
    """(c) fedbuff to 10 updates on the loaded paper PON, untraced and
    traced: the registry totals and the transport columns equal. Returns the
    traced run's launches."""
    from repro_torch import obs
    from repro_torch.launch import femnist_async
    exp = _runtime_exp("fedbuff", "sfl_two_step", dict(**PAPER_PON, **LOADED))
    counters = _counters()
    out = []
    for traced in (False, True):
        _zero(counters)
        sess = obs.session(trace_out=os.path.join(tmp, "fedbuff.trace.json"),
                           health=True) if traced else None
        t0 = time.perf_counter()
        try:
            hist, orch = femnist_async.run(exp, full=True, n_updates=10, data=paper,
                                           device="cuda")
        finally:
            n_spans = len(sess.tracer.spans) if sess is not None else 0
            if sess is not None:
                sess.finish(quiet=True)
        out.append((hist, orch, time.perf_counter() - t0, n_spans,
                    {k: fn.launches for k, fn in counters.items()}))
    (h0, o0, w0, _, c0), (h1, o1, w1, n_spans, c1) = out
    reg = o1.metrics.counter("pon.upstream_mbits")
    check(_runtime_columns(h0) == _runtime_columns(h1) and c0 == c1
          and o0.total_upstream_mbits == o1.total_upstream_mbits == reg.total,
          f"obs [fedbuff]: traced {o1.total_upstream_mbits} vs {o0.total_upstream_mbits}")
    print(f"obs [fedbuff]: 10 updates, traced {n_spans} spans; registry total "
          f"{reg.total:.3f} Mb = the untraced run's, transport columns and launches equal; "
          f"wall {w0:.2f} s untraced, {w1:.2f} s traced; fl.staleness count "
          f"{o1.metrics.histogram('fl.staleness').count}")
    del o0, o1
    return c1


def _obs_bundles(paper, tmp) -> None:
    """(d) A run bundle from the card and one from the CPU, the same config
    at reduced width (H = 1, 2 rounds, one init), compared with the port's
    diff engine: no hard diff but the backend timings' host seconds."""
    from repro_torch import configs, obs
    from repro_torch.launch import femnist as launch
    from repro_torch.models import femnist_cnn
    from repro_torch.obs.audit import RunReport, diff_bundles
    from repro_torch.pon import PonConfig
    p0 = femnist_cnn.init_params(configs.get("femnist_cnn").reduced(),
                                 torch.Generator().manual_seed(0), device="cpu")
    reports = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(tmp, f"bundle_{dev}.json")
        sess = obs.session(report_out=path, health=True, driver="round_loop")
        try:
            loop = launch.run(n_rounds=2, n_selected=128, seed=0, modes=("sfl_two_step",),
                              pon=PonConfig(**PAPER_PON), params=p0, device=dev, data=paper,
                              local_steps=1)["sfl_two_step"]["loop"]
        finally:
            sess.finish(quiet=True, cfg=loop.cfg, history=loop.history)
        reports[dev] = RunReport.load(path)
    card, cpu = reports["cuda"], reports["cpu"]
    d = diff_bundles(card, cpu, rtol=1e-4)
    hard = [e for e in d.entries if e.status != "warn"]
    timing = [e for e in hard if e.section == "metrics" and e.key.startswith("histogram:backend.")
              and not e.key.endswith((".count", ".n"))]
    check(card.config_hash == cpu.config_hash and not d.config_delta and hard == timing,
          "obs [bundles]: card vs CPU: " + "; ".join(e.line() for e in hard if e not in timing))
    check(bool(card.env.get("device")), f"obs [bundles]: env {card.env}")
    print(f"obs [bundles]: card ({card.env.get('device')}) vs CPU at reduced width, H = 1, 2 rounds: "
          f"config hash {card.config_hash} both; history (rtol 1e-4), transport metrics, "
          f"incidents and {len(card.trace.get('traceEvents', []))} trace events without a hard "
          f"diff; {len(timing)} host-time fields of backend.*_s differ (the reference's names "
          f"match no warn fragment), {d.n_warns} warnings")


def _obs_ranges() -> None:
    """(e) in a process of its own, whose profiler session is its first:
    late sessions in one process miss device activity (a full run's
    thirteenth recorded 8 of these 25 launches). The kernels are built."""
    sys.stdout.flush()
    code = (f"import sys; sys.path[:0] = {[ROOT, os.path.join(ROOT, 'src')]!r}; "
            "import chip_smoke; chip_smoke._obs_ranges_window()")
    check(subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0,
          "obs [ranges]: the profiler window's process failed")


def _obs_ranges_window() -> None:
    """One torch.profiler window over one call of each kernel wrapper:
    each ``kernels.<name>`` range once a call, its counter stepped as the
    call's launches, every device kernel of the port launched inside its
    range; then what a range costs on the host at the decode calls."""
    import importlib
    from repro_torch import device
    device.resolve("cuda")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    agg = importlib.import_module("repro_torch.kernels.agg_reduce")
    qz = importlib.import_module("repro_torch.kernels.quantize")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rg = importlib.import_module("repro_torch.kernels.rglru_scan")
    rw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    g = torch.Generator(device="cuda").manual_seed(18)
    N, C = N_FC1, 16
    x, u, m = _row_inputs(g, C, N)
    wm = (torch.rand(C, generator=g, device="cuda") * 400).contiguous()
    ones = torch.ones(C, device="cuda")
    seg = np.arange(C) % 4
    q8 = qz.quantize_rows(x, u, ones, 127.0)
    th = qz.topk_thresholds(x, qz.topk_k(N, 0.01))
    bf = torch.bfloat16
    qh, kh = (torch.randn(s, generator=g, device="cuda").to(bf)
              for s in ((1, 16, 1024, 128), (1, 2, 1024, 128)))
    a = torch.rand((1, 256, 4096), generator=g, device="cuda")
    b = torch.randn((1, 256, 4096), generator=g, device="cuda")
    r = torch.randn((1, 8, 256, 64), generator=g, device="cuda").to(bf)
    lw = -torch.rand((1, 8, 256, 64), generator=g, device="cuda")
    uu = torch.randn((8, 64), generator=g, device="cuda")
    r1, lw1 = r[:, :, :1].contiguous(), lw[:, :, :1].contiguous()
    # the backwards' inputs: their forwards under grad, outside the window
    qg, kg = (t.detach().requires_grad_() for t in (qh, kh))
    ag, rf = a.detach().requires_grad_(), r.detach().float().requires_grad_()
    fo = fa.flash_attention(qg, kg, kg)
    ro = rg.rglru_scan(ag, b)[0]
    wo = rw.rwkv6_scan(rf, rf, rf, lw, uu)[0]
    torch.cuda.synchronize()
    agg_k, q_k = ("segment_agg",), ("quantize_vec4", "quantize_scalar")
    dq_k, tk_k = ("dequantize_vec4", "dequantize_scalar"), ("topk_mask_vec4", "topk_mask_scalar")
    calls = (  # (range, call, wrapper, its counter and steps a call, device kernels a call)
        ("kernels.agg_reduce", lambda: agg.segment_agg_reduce(x, wm, seg, 4),
         agg.segment_agg_reduce, "launches", 1, agg_k, 1),
        ("kernels.agg_reduce", lambda: agg.agg_reduce(x, wm, m),
         agg.segment_agg_reduce, "launches", 1, agg_k, 1),
        ("kernels.agg_reduce_quant", lambda: agg.segment_agg_reduce_quant(x, wm, seg, 4, u[:4]),
         agg.segment_agg_reduce_quant, "launches", 1, agg_k + q_k, 2),
        ("kernels.agg_reduce_quant", lambda: agg.agg_reduce_quant(x, wm, m, u[0]),
         agg.segment_agg_reduce_quant, "launches", 1, agg_k + q_k, 2),
        ("kernels.quantize_int8", lambda: qz.quantize_rows(x, u, ones, 127.0),
         qz.quantize_rows, "launches", 1, q_k, 1),
        ("kernels.quantize_int4", lambda: qz.quantize_int4(x[0], u[0]),
         qz.quantize_rows, "launches", 1, q_k, 1),
        ("kernels.dequantize_int8", lambda: qz.dequantize_rows(q8, wm, m),
         qz.dequantize_rows, "launches", 1, dq_k, 1),
        ("kernels.dequantize_int8", lambda: qz.dequantize_int8(q8[0], wm[0]),
         qz.dequantize_rows, "launches", 1, dq_k, 1),
        ("kernels.topk_sparsify", lambda: qz.topk_mask_rows(x, th, m),
         qz.topk_mask_rows, "launches", 1, tk_k, 1),
        ("kernels.topk_sparsify", lambda: qz.topk_mask(x[0], th[0]),
         qz.topk_mask_rows, "launches", 1, tk_k, 1),
        ("kernels.flash_attention", lambda: fa.flash_attention(qh, kh, kh),
         fa.flash_attention, "launches", 1, ("flash_wgmma", "flash_fwd"), 1),
        ("kernels.flash_attention_bwd", lambda: fo.sum().backward(),
         fa.flash_attention, "launches_bwd", 3,
         ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_dkdv_wgmma",
          "flash_bwd_dq_wgmma"), 3),
        ("kernels.rglru_scan", lambda: rg.rglru_scan(a, b),
         rg.rglru_scan, "launches", 1, ("rglru_ring", "rglru_scalar"), 1),
        ("kernels.rglru_scan_bwd", lambda: ro.sum().backward(),
         rg.rglru_scan, "launches_bwd", 1, ("rglru_bwd_ring", "rglru_bwd_scalar"), 1),
        ("kernels.rwkv6_scan", lambda: rw.rwkv6_scan(r, r, r, lw, uu),
         rw.rwkv6_scan, "launches", 1, ("rwkv6_states", "rwkv6_state_scan", "rwkv6_outputs"), 3),
        ("kernels.rwkv6_scan", lambda: rw.rwkv6_scan(r1, r1, r1, lw1, uu),
         rw.rwkv6_scan, "launches", 1, ("rwkv6_decode",), 1),
        ("kernels.rwkv6_scan_bwd", lambda: wo.sum().backward(),
         rw.rwkv6_scan, "launches_bwd", 3,
         ("rwkv6_bwd_states", "rwkv6_bwd_state_scan", "rwkv6_bwd_grads"), 3),
    )
    wrappers = {(c[2].__name__, c[3]): c[2] for c in calls}
    before = {key: getattr(fn, key[1]) for key, fn in wrappers.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for c in calls:
            c[1]()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    want = {}
    for c in calls:
        want[(c[2].__name__, c[3])] = want.get((c[2].__name__, c[3]), 0) + c[4]
    for key, n in want.items():
        got = getattr(wrappers[key], key[1]) - before[key]
        check(got == n, f"obs [ranges]: {key[0]}.{key[1]} stepped {got}, want {n}")
    events = prof.events()
    kname = lambda name: _kernel_name(name).split("<")[0]  # noqa: E731
    ranges = [e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("kernels.")]
    annotations = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.name.startswith("kernels.")]
    ours = {n for c in calls for n in c[5]}
    port = [e for e in events if e.device_type == DeviceType.CUDA and kname(e.name) in ours]
    check(len(port) == sum(c[6] for c in calls),
          f"obs [ranges]: {len(port)} of the port's {sum(c[6] for c in calls)} device kernels "
          "recorded")
    lines = []
    for name in sorted({c[0] for c in calls}):
        mine = [c for c in calls if c[0] == name]
        names, launched = {n for c in mine for n in c[5]}, sum(c[6] for c in mine)
        n_ranges = sum(1 for e in ranges if e.name == name)
        check(n_ranges == len(mine), f"obs [ranges]: {n_ranges} {name} ranges, {len(mine)} calls")
        # the range's device kernels: attached to it by the profiler's launch
        # correlation, or inside its span on the card's timeline
        attached = sum(1 for e in ranges if e.name == name for k in e.kernels
                       if kname(k.name) in names)
        spans = [(e.time_range.start, e.time_range.end) for e in annotations if e.name == name]
        inside = sum(1 for e in port if kname(e.name) in names
                     and any(s <= e.time_range.start and e.time_range.end <= t for s, t in spans))
        lines.append(f"{name} x{n_ranges}: {launched} device kernels, {attached} attached to "
                     f"the range, {inside} inside its {len(spans)} device spans")
        check(attached == launched or inside == launched, f"obs [ranges]: {lines[-1]}")
    print("obs [ranges]: one profiler window, one call a wrapper: " + "; ".join(lines))
    # what a range costs on the host at the serve path's most frequent
    # launches, the decode calls of rwkv6-3b and recurrentgemma-9b: the
    # wrapper as the serve path calls it (no profiler: the range's test
    # alone), and the bare call inside an open range
    rd = torch.randn((4, 48, 1, 64), generator=g, device="cuda").to(bf)
    wd, ud = -torch.rand((4, 48, 1, 64), generator=g, device="cuda"), uu.new_zeros((48, 64))
    ad, bd = (torch.rand((4, 1, 4096), generator=g, device="cuda") for _ in range(2))
    hd = torch.zeros((4, 4096), device="cuda")

    def ranged(fn):
        with record_function("kernels.probe"):
            fn()
    for label, scoped, bare in (
            ("rwkv6_scan decode (4, 48, 1, 64)", lambda: rw.rwkv6_scan(rd, rd, rd, wd, ud),
             lambda: rw.rwkv6_scan.__wrapped__(rd, rd, rd, wd, ud)),
            ("rglru_scan decode (4, 1, 4096)", lambda: rg.rglru_scan(ad, bd, hd),
             lambda: rg.rglru_scan.__wrapped__(ad, bd, hd))):
        runs = [(host_ms(bare), host_ms(scoped), host_ms(lambda: ranged(bare)))
                for _ in range(3)]
        test = [1e3 * (s - b) for b, s, _ in runs]
        open_ = [1e3 * (o - b) for b, _, o in runs]
        print(f"obs [ranges]: a {label} call {1e3 * statistics.median(b for b, _, _ in runs):.2f}"
              f" us bare; the wrapper's range test adds {statistics.median(test):.2f} us "
              f"({', '.join(f'{c:.2f}' for c in test)}), an open range "
              f"{statistics.median(open_):.2f} us ({', '.join(f'{c:.2f}' for c in open_)}; host "
              "clock over 1000 calls, 3 runs each)")


def _obs_train(tmp) -> None:
    """(f) launch.train's CLI: qwen2-0.5b at full width, 2 steps, batch 8 ×
    2048, adamw, ``--report-out``: the bundle holds backend.train_step_s
    with count 2."""
    from repro_torch.launch import train
    from repro_torch.obs.audit import RunReport
    path = os.path.join(tmp, "train.report.json")
    torch.cuda.empty_cache()
    train.main(["--arch", "qwen2-0.5b", "--steps", "2", "--batch", str(TRAIN["batch"]),
                "--seq", str(TRAIN["seq"]), "--lr", str(TRAIN["lr"]), "--log-every", "1",
                "--report-out", path, "--health"])
    rep = RunReport.load(path)
    (h,) = [r for r in rep.metrics if r["name"] == "backend.train_step_s"]
    check(h["count"] == 2 and len(rep.history) == 2 and rep.driver == "round_loop",
          f"obs [train]: {h}")
    print(f"obs [train]: qwen2-0.5b bundle cfg {rep.config_hash}: backend.train_step_s count "
          f"{h['count']}, mean {h['mean']:.3f} s, max {h['max']:.3f} s; "
          f"{len(rep.trace.get('traceEvents', []))} trace events, {len(rep.incidents)} incidents")
    torch.cuda.empty_cache()


def phase_obs() -> dict:
    """Phase 18; returns the main path's launches by kernel (the traced
    runs of (a)-(c))."""
    import tempfile
    paper, forest = _population(320), _population(1280)
    launches = dict.fromkeys(_counters(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for counts in (_obs_slice(paper, tmp), _obs_transport_cost(paper, forest, tmp),
                       _obs_fedbuff(paper, tmp)):
            for k in launches:
                launches[k] += counts[k]
        _obs_bundles(paper, tmp)
        _obs_ranges()
        _obs_train(tmp)
    return launches


# ---------------------------------------------------------------------------
# phase 19: the cost model against the card
# ---------------------------------------------------------------------------

def cost_rows():
    """(kernel, its cost function at the shape of its PERF.md §6 row, that
    row's Bound ms)."""
    import importlib
    ag, kq, fa, rg, rw, ic = (importlib.import_module(f"repro_torch.kernels.{m}") for m in
                              ("agg_reduce", "quantize", "flash_attention", "rglru_scan",
                               "rwkv6_scan", "im2col"))
    bf16 = torch.bfloat16
    return (("agg_reduce", ag.agg_reduce_cost(128, N_FC1, 16, 4), 1.1043),
            ("agg_reduce, classical (1')", ag.agg_reduce_cost(16, N_FC1, 1, 4), 0.1304),
            ("agg_reduce_quant", ag.agg_reduce_quant_cost(128, N_FC1, 16, 4), 1.1350),
            ("quantize_intb", kq.quantize_cost(16, N_FC1, 4), 0.2761),
            ("dequantize_int8", kq.dequantize_cost(16, N_FC1, True), 0.1534),
            ("topk_mask", kq.topk_mask_cost(128, N_FC1, 4, True), 1.9632),
            ("flash_attention", fa.flash_attention_cost(4, 16, 1, 4096, 256, bf16, 2048),
             0.4170),
            ("rglru_scan", rg.rglru_scan_cost(4, 4096, 4096, True), 0.2404),
            ("rwkv6_scan", rw.rwkv6_scan_cost(4, 48, 4096, 64, 64, bf16), 0.2113),
            ("flash backward", fa.flash_attention_bwd_cost(8, 14, 2, 2048, 64, bf16), 0.1521),
            ("rglru_scan backward", rg.rglru_scan_bwd_cost(8, 2048, 4096, False, False),
             0.4007),
            ("rwkv6_scan backward", rw.rwkv6_scan_bwd_cost(8, 48, 2048, 64, 64, bf16),
             0.4244),
            ("im2col", ic.im2col_cost(160, 32, 14, 14), 0.0312))


# the cells phase 19 measures: phase 13's qwen2-0.5b step (batch 8 × 2048,
# adamw, remat full) and phase 10's rwkv6-3b prefill (4 × 4096)
COST_CELLS = (("qwen2-0.5b", ("train_8x2048", 2048, 8, "train"), "adamw"),
              ("rwkv6-3b", ("prefill_4x4096", 4096, 4, "prefill"), "adamw"))
# launch counters a kernel's reports are held to: (wrapper, counter)
COST_COUNTERS = {"flash_attention": ("flash_attention", "launches"),
                 "flash_attention_bwd": ("flash_attention", "launches_bwd"),
                 "rglru_scan": ("rglru_scan", "launches"),
                 "rglru_scan_bwd": ("rglru_scan", "launches_bwd"),
                 "rwkv6_scan": ("rwkv6_scan", "launches"),
                 "rwkv6_scan_bwd": ("rwkv6_scan", "launches_bwd")}


def _card_args(meta_args, cfg, opt_name: str, gen):
    """The cell's arguments on the card, leaf for leaf the shapes and types
    of ``meta_args``: parameters from the port's init, the optimizer's own
    state, random tokens and unit client weights."""
    from repro_torch.models import transformer
    from repro_torch.optim import make_optimizer
    params = transformer.init_params(cfg, device="cuda")
    args = [params]
    if len(meta_args) == 3:
        args.append(make_optimizer(opt_name).init(params))
    batch = {}
    for k, t in meta_args[-1].items():
        if k == "tokens":
            batch[k] = torch.randint(0, cfg.vocab_size, tuple(t.shape), generator=gen,
                                     device="cuda", dtype=t.dtype)
        else:
            batch[k] = torch.ones(tuple(t.shape), dtype=t.dtype, device="cuda")
    args.append(batch)
    got = [(tuple(t.shape), t.dtype) for t in _leaves_of(args)]
    want = [(tuple(t.shape), t.dtype) for t in _leaves_of(meta_args)]
    check(got == want, f"phase 19: the card's arguments differ from the dry run's for {cfg.name}")
    return args


def _leaves_of(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves_of(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _by_op_diff(a, b) -> str:
    keys = sorted(set(a.by_op) | set(b.by_op))
    return ", ".join(f"{k}: card {a.by_op.get(k, 0):.0f} meta {b.by_op.get(k, 0):.0f}"
                     for k in keys if a.by_op.get(k, 0) != b.by_op.get(k, 0))


def phase_cost() -> None:
    """Phase 19: (c) every kernel's cost function at its PERF.md §6 row's
    shape gives that row's Bound ms; (a) one warm step of each cell counted
    on the card equals the dry run's count on ``meta`` (flops by type and
    bytes exactly), the kernels' reported launches equal their counters;
    (b) the compute term does not exceed the measured warm time, the
    reckoned peak memory lies within 25% of the measured one."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, rglru_scan, rwkv6_scan
    from repro_torch.launch import hw, roofline, specs
    from repro_torch.models.config import ShapeConfig

    card = _card_name()
    for name, work, want in cost_rows():
        ms, by = work.bound()
        print(f"cost [{card}]: {name} bound {ms:.4f} ms ({by}), PERF.md §6 {want:.4f}")
        check(round(ms, 4) == want, f"cost function of {name}: {ms:.4f} ms, want {want}")

    wrappers = {"flash_attention": flash_attention, "rglru_scan": rglru_scan,
                "rwkv6_scan": rwkv6_scan}
    gen = torch.Generator(device="cuda").manual_seed(19)
    for arch, shape, opt_name in COST_CELLS:
        cfg, shp = configs.get(arch), ShapeConfig(*shape)
        label = f"{arch} {shp.kind} {shp.global_batch}x{shp.seq_len}"
        t0 = time.perf_counter()
        fn, meta_args = specs.input_specs(cfg, shp, None, None, opt_name)
        with roofline.Counter() as meta:
            fn(*meta_args)
        meta_s = time.perf_counter() - t0
        # earlier phases' objects in reference cycles, collected now rather
        # than inside the measured steps (their memory would leave the base)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        state = _card_args(meta_args, cfg, opt_name, gen)
        train = shp.kind == "train"

        def step():
            out = fn(*state)
            if train:
                state[0], state[1] = out[0], out[1]
            return out

        step()                     # cold
        step()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        warm = statistics.median(walls)
        peak = torch.cuda.max_memory_allocated() - base
        for w in wrappers.values():
            _zero_launches(w)
        with roofline.Counter() as c:
            step()
            torch.cuda.synchronize()
        if c.flops != meta.flops or c.bytes != meta.bytes:
            print(f"cost {label}: card {c.flops} {c.bytes:.0f} B, meta {meta.flops} "
                  f"{meta.bytes:.0f} B; by operator: {_by_op_diff(c, meta)}")
        check(c.flops == meta.flops, f"cost {label}: flops on the card {c.flops} != meta "
                                     f"{meta.flops}")
        check(c.bytes == meta.bytes, f"cost {label}: bytes on the card {c.bytes:.0f} != meta "
                                     f"{meta.bytes:.0f}")
        launched = {k: getattr(wrappers[w], attr) for k, (w, attr) in COST_COUNTERS.items()}
        reported = {k: v["launches"] for k, v in c.kernels.items()}
        check(reported == {k: n for k, n in launched.items() if n},
              f"cost {label}: reported launches {reported}, counters {launched}")
        check(c.kernels == meta.kernels, f"cost {label}: the card's kernel reports differ "
                                         "from the dry run's")
        compute_s = roofline.compute_seconds(c.flops)
        memory_s = c.bytes / hw.HBM_BW
        n_params = sum(t.numel() for t in _leaves_of(meta_args[0]))
        tokens = shp.global_batch * shp.seq_len
        model_flops = (6 if train else 2) * n_params * tokens
        mfu = model_flops / (warm * hw.PEAK_FLOPS_BF16)
        reckoned = roofline.tree_bytes(meta_args) + meta.peak
        err = (reckoned - peak) / peak
        print(f"cost [{card}] {label}: warm {warm:.4f} s (host clock, card synchronised, "
              f"median of 3; {', '.join(f'{w:.4f}' for w in walls)}); flops "
              f"{ {k: f'{v:.4e}' for k, v in c.flops.items()} } = meta's, bytes "
              f"{c.bytes:.4e} = meta's; compute_s {compute_s:.4f} "
              f"({100 * compute_s / warm:.1f}% of warm), memory_s {memory_s:.4f} (unfused, "
              f"not held), roofline max {max(compute_s, memory_s):.4f} s = "
              f"{100 * max(compute_s, memory_s) / warm:.1f}% of warm; model flops "
              f"{model_flops:.4e} ({'6' if train else '2'}·N·D, N {n_params:,}), mfu "
              f"{100 * mfu:.2f}%; peak reckoned {reckoned / 2**30:.2f} GiB (arguments "
              f"{roofline.tree_bytes(meta_args) / 2**30:.2f} + live {meta.peak / 2**30:.2f}) "
              f"vs max_memory_allocated {peak / 2**30:.2f} GiB above the {base / 2**30:.2f} "
              f"GiB held before ({100 * err:+.1f}%, "
              f"{'over' if err > 0 else 'under'}); kernels {reported}; meta count "
              f"{meta_s:.1f} s")
        check(compute_s <= warm, f"cost {label}: compute term {compute_s:.4f} s exceeds the "
                                 f"measured {warm:.4f} s: a miscount")
        check(abs(err) <= 0.25, f"cost {label}: reckoned peak {reckoned / 2**30:.2f} GiB vs "
                                f"measured {peak / 2**30:.2f} GiB ({100 * err:+.1f}%)")
        del state, fn, meta_args
        torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# phase 20: the examples
# ---------------------------------------------------------------------------

# (example, its argv, the kernels its run must launch); the FEMNIST ones
# at the full width but for async and quickstart (the reference's reduced
# CNN), train_lm at olmo-100m's full width cut to 10 steps
EXAMPLES = (
    ("train_femnist_sfl", ["--full", "--rounds", "2", "--n-selected", "128"],
     ("agg_reduce",)),
    ("train_femnist_sfl", ["--full", "--rounds", "1", "--n-selected", "128",
                           "--compress", "int8"],
     ("agg_reduce_quant", "quantize_rows", "dequantize_rows", "agg_reduce")),
    ("train_femnist_hier", ["--full", "--rounds", "1", "--n-pons", "2"], ("agg_reduce",)),
    ("train_femnist_async", ["--rounds", "2"], ("agg_reduce",)),
    ("quickstart", [], ("agg_reduce",)),
    ("train_lm", ["--steps", "10"], ("flash_attention", "flash_attention_bwd")),
    ("serve_lm", [], ("flash_attention", "rglru_scan")),
)


def _example(name: str):
    """``examples_torch/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(ROOT, "examples_torch", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clone(v):
    """A copy of a kernel's argument: a tensor with its own strides (a view
    into a wider tensor keeps its layout, a broadcast dimension stays
    one), a numpy array, a tuple of them."""
    if isinstance(v, torch.Tensor):
        base = v
        for d, st in enumerate(v.stride()):
            if st == 0:
                base = base.narrow(d, 0, min(1, v.shape[d]))
        out = torch.empty_strided(base.size(), base.stride(), dtype=v.dtype, device=v.device)
        return out.copy_(base).expand(v.shape)
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, tuple):
        return tuple(_clone(x) for x in v)
    return v


def _extent(t: torch.Tensor) -> int:
    """The bytes ``_clone`` allocates for ``t``."""
    if t.numel() == 0:
        return 0
    return (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) * t.element_size()


def _signature(v):
    if isinstance(v, torch.Tensor):
        return ("tensor", tuple(v.shape), tuple(v.stride()), str(v.dtype))
    if isinstance(v, np.ndarray):
        return ("array", v.shape)
    if isinstance(v, tuple):
        return tuple(_signature(x) for x in v)
    return repr(v)


def _held_flash(orig, a):
    from repro_torch.kernels import flash_attention_plain
    o, lse = orig(**a)
    po, plse = flash_attention_plain(a["q"], a["k"], a["v"], causal=a["causal"],
                                     window=a["window"], scale=a["scale"],
                                     softcap=a["softcap"], return_lse=True)
    err, ok = (_within(o, po, 2.0 ** -7, 1e-5) if a["q"].dtype == torch.bfloat16
               else _within(o, po, 2e-5, 2e-5))
    if lse is not None:
        err_l, ok_l = _within(lse, plse, 1e-5, 1e-5)
        ok = ok and ok_l
    return err, ok


def _held_flash_bwd(orig, a):
    from repro_torch.kernels import flash_attention_bwd_plain
    got = orig(**a)
    want = flash_attention_bwd_plain(*(a[k] for k in ("q", "k", "v", "o", "lse", "do")),
                                     causal=a["causal"], window=a["window"],
                                     scale=a["scale"], softcap=a["softcap"])
    tol = (2.0 ** -7, 1e-4) if a["q"].dtype == torch.bfloat16 else (1e-4, 1e-4)
    worst, ok = 0.0, True
    for g, w in zip(got, want):
        err, ok_g = _within(g, w, tol[0], tol[1] * float(w.float().abs().max()))
        worst, ok = max(worst, err), ok and ok_g
    return worst, ok


def _held_rglru(orig, a):
    from repro_torch.kernels import rglru_scan_plain
    got = orig(**a)
    want = rglru_scan_plain(a["a"], a["b"], a["h0"])
    return (max(float((g - w).abs().max()) for g, w in zip(got, want)),
            all(torch.equal(g, w) for g, w in zip(got, want)))


def _held_rglru_bwd(orig, a):
    from repro_torch.kernels import rglru_scan_bwd_plain
    got = orig(**a)
    dout = a["dout"] if a["dout"] is not None else torch.zeros_like(a["out"])
    want = rglru_scan_bwd_plain(a["a"], a["out"], a["h0"], dout, a["dh_last"])
    return (max(float((g - w).abs().max()) for g, w in zip(got, want)),
            all(torch.equal(g, w) for g, w in zip(got, want)))


def _held_rwkv6(orig, a):
    from repro_torch.kernels import rwkv6_scan_plain
    o, s_out, _ = orig(**a)
    po, ps = rwkv6_scan_plain(a["r"], a["k"], a["v"], a["logw"], a["u"], chunk=a["chunk"],
                              s0=a["s0"])
    err_o, ok_o = _within(o, po, 2e-3, 2e-3)
    err_s, ok_s = _within(s_out, ps, 2e-3, 2e-3)
    return max(err_o, err_s), ok_o and ok_s


def _held_agg(orig, a):
    from repro_torch.kernels import segment_agg_reduce_plain
    x, wm, seg, n_seg = a["x"], a["wm"], a["seg"], a["n_seg"]
    amax = None if a["amax"] is None else torch.empty_like(a["amax"])
    got = orig(x, wm, seg, n_seg, amax)
    want = segment_agg_reduce_plain(x, wm, seg, n_seg)
    abs_sum = segment_agg_reduce_plain(x.abs(), wm.abs(), seg, n_seg)
    ok = bool(((got - want).abs() <= ATOL + RTOL_OF_ABS_SUM * abs_sum).all())
    if amax is not None:      # the fused form's pass A: each segment's max|θ|
        ok = ok and torch.equal(amax.amax(1), got.abs().amax(1))
    return float((got - want).abs().max()), ok


def _held_quantize(orig, a):
    from repro_torch.kernels import quantize_rows_plain
    got = orig(**a)
    want = quantize_rows_plain(a["x"], a["noise"], a["scales"], a["qmax"])
    return float((got.float() - want.float()).abs().max()), torch.equal(got, want)


def _held_dequantize(orig, a):
    from repro_torch.kernels import dequantize_rows, dequantize_rows_plain
    q, (scales, mask) = a["x"], a["row_args"]
    got, want = dequantize_rows(q, scales, mask), dequantize_rows_plain(q, scales, mask)
    return float((got - want).abs().max()), torch.equal(got, want)


class HeldCalls:
    """While open, the first call of each kernel at each signature (shapes,
    strides, types, scalar arguments) that the path gives it, with its
    inputs copied; ``hold()`` then runs the kernel again on those inputs
    and holds it against its plain version, at the tolerances of the
    phases that hold it at their own shapes (flash attention as phases 9
    and 12, the RG-LRU scans and quantize bit for bit, agg_reduce within
    ATOL + RTOL_OF_ABS_SUM·Σ|w·x|, the RWKV6 scan's output and state
    within 2e-3 + 2e-3·|plain| as phase 9). Recorded where each wrapper
    launches:
    its module's launch function, the one its counter steps beside."""

    # (module, function, kernel of the kernels line, its check)
    SITES = (("flash_attention", "_forward", "flash_attention", _held_flash),
             ("flash_attention", "_backward", "flash_attention_bwd", _held_flash_bwd),
             ("rglru_scan", "_forward", "rglru_scan", _held_rglru),
             ("rglru_scan", "_backward", "rglru_scan_bwd", _held_rglru_bwd),
             ("rwkv6_scan", "_forward", "rwkv6_scan", _held_rwkv6),
             ("agg_reduce", "_launch", "agg_reduce", _held_agg),
             ("agg_reduce", "launch_quantize", "quantize_rows", _held_quantize),
             ("quantize", "launch_quantize", "quantize_rows", _held_quantize),
             # dequantize_rows launches through raw pointers: its tensors are
             # seen where it checks them, first thing in the wrapper
             ("quantize", "_check_rows", "dequantize_rows", _held_dequantize))
    MAX_BYTES = 16 << 30          # copies kept at once; later signatures go unheld

    def __enter__(self):
        import importlib
        import inspect
        self.calls, self.saved, self.nbytes, self.skipped = {}, [], 0, 0
        for mod_name, fn_name, kernel, check_fn in self.SITES:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            orig = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, self._recording(orig, inspect.signature(orig), kernel,
                                                  check_fn))
        return self

    def _recording(self, orig, sig, kernel, check_fn):
        def recorded(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            a = dict(a.arguments)
            if kernel == "dequantize_rows" and a["name"] != "dequantize_rows":
                return orig(*args, **kwargs)
            name = "agg_reduce_quant" if kernel == "agg_reduce" and a["amax"] is not None \
                else kernel
            tensors = [v for v in a.values() if isinstance(v, torch.Tensor)]
            key = (name, _signature(tuple(a.values())))
            if tensors and tensors[0].is_cuda and key not in self.calls:
                size = sum(_extent(t) for t in tensors)
                if self.nbytes + size <= self.MAX_BYTES:
                    self.nbytes += size
                    self.calls[key] = (orig, check_fn, {k: _clone(v) for k, v in a.items()})
                else:
                    self.skipped += 1
            return orig(*args, **kwargs)
        return recorded

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)

    def hold(self, label: str) -> dict:
        """Each recorded call run again and held; returns {kernel: (calls
        held, the largest |kernel − plain|)}."""
        out = {}
        for (name, _), (orig, check_fn, a) in self.calls.items():
            err, ok = check_fn(orig, a)
            check(ok, f"{label}: {name} disagrees with its plain version at the path's "
                      f"shapes {[tuple(v.shape) for v in a.values() if torch.is_tensor(v)]}"
                      f" (max |diff| {err})")
            n, worst = out.get(name, (0, 0.0))
            out[name] = (n + 1, max(worst, err))
        self.calls.clear()
        torch.cuda.synchronize()
        return out


def _all_counters() -> dict:
    """Every kernel of the kernels line: (wrapper, its counter)."""
    out = {k: (fn, "launches") for k, fn in _counters().items()}
    for k, fn in _lm_counters().items():
        out[k], out[k + "_bwd"] = (fn, "launches"), (fn, "launches_bwd")
    return out


def _check_example(name: str, argv, out, tmp: str) -> None:
    """What each example's return must show on the card."""
    if name.startswith("train_femnist_") and name != "train_femnist_async":
        modes = [k[:-len("_acc")] for k in out[0] if k.endswith("_acc")]
        check(len(out) == int(argv[argv.index("--rounds") + 1]) and len(modes) == 2,
              f"{name}: {len(out)} rows of {modes}")
        for r in out:
            check(all(0.0 <= r[f"{m}_acc"] <= 1.0 for m in modes), f"{name}: acc {r}")
            # the classical benchmark involves fewer clients than SFL
            check(r["classical_involved"] <= r[f"{modes[1]}_involved"], f"{name}: {r}")
    elif name == "train_femnist_async":
        check(len(out) > 0 and all(math.isfinite(r.get("acc", 0.0)) for r in out),
              f"{name}: {len(out)} rows")
        check(out[-1]["t_s"] <= 2 * 25.0, f"{name}: t_s {out[-1]['t_s']} past the budget")
    elif name == "quickstart":
        check(out["classical"]["involved"] < out["sfl"]["involved"], f"{name}: {out}")
        check(out["sfl"]["upstream_mbits"] < out["classical"]["upstream_mbits"],
              f"{name}: {out}")
        check(0.0 <= out["sfl"]["acc"] <= 1.0 and out["sfl"]["uplink_models"] > 0,
              f"{name}: {out}")
    elif name == "train_lm":
        losses = out["history"].column("loss")
        check(len(losses) == 10 and all(math.isfinite(x) for x in losses),
              f"{name}: losses {losses}")
        check(os.path.isdir(os.path.join(tmp, "ck", "step_10")), f"{name}: no checkpoint")
        print(f"example {name}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"checkpoint {sorted(os.listdir(os.path.join(tmp, 'ck')))}")
    elif name == "serve_lm":
        check(tuple(out["tokens"].shape) == (4, 33), f"{name}: tokens {out['tokens'].shape}")
        check(bool(torch.isfinite(out["logits"].float()).all()), f"{name}: logits not finite")


def phase_examples() -> dict:
    """Phase 20: every ``examples_torch/*.py`` through its ``main(argv)`` on
    the card, in this process (the wrappers' counters see each launch):
    each example's wall time and launches by kernel, each kernel it must
    reach launched, every kernel it launched held against its plain
    version at the shapes it gave it (``HeldCalls``), its output checked.
    Returns the launches by kernel."""
    import tempfile
    counters = _all_counters()
    launches = dict.fromkeys(counters, 0)
    card = _card_name()
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, must in EXAMPLES:
            argv = argv + (["--ckpt", os.path.join(tmp, "ck")] if name == "train_lm" else [])
            mod = _example(name)
            for fn, _ in counters.values():
                _zero_launches(fn)
            torch.cuda.synchronize()
            with HeldCalls() as held:
                t0 = time.perf_counter()
                out = mod.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
            label = f"example {name} {' '.join(argv).replace(tmp, '<tmp>')}"
            print(f"{label}: {wall:.1f} s [{card}]; launches "
                  f"{ {k: n for k, n in counts.items() if n} }")
            for k in must:
                check(counts[k] > 0, f"example {name}: {k} never launched")
            # every kernel the run launched, held against its plain version
            # on the inputs of its first call at each signature
            t0 = time.perf_counter()
            n_skipped, by_kernel = held.skipped, held.hold(label)
            for k, n in counts.items():
                check(n == 0 or k in by_kernel, f"{label}: {k} launched but never held")
            print(f"{label}: held at the path's shapes (calls, max |kernel - plain|) "
                  f"{by_kernel}, {n_skipped} signatures past the copy budget, "
                  f"{time.perf_counter() - t0:.1f} s")
            _check_example(name, argv, out, tmp)
            for k, n in counts.items():
                launches[k] += n
            del out
            gc.collect()
            torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 21: FSDP over "data" and MoE over data ranks
# ---------------------------------------------------------------------------

FSDP_RUN = ("qwen3-moe-30b-a3b", {"n_layers": 4}, "sgdm", 2)   # phase 13's cut


class _GatherTap:
    """While open, the bytes each kind of collective reported (the
    all-gathers' outputs, the reduce-scatters' inputs)."""

    def __enter__(self):
        from repro_torch.core import aggregation
        self.mod, self.orig, self.bytes = aggregation, aggregation._report, {}

        def report(kind, nbytes, group):
            self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
            return self.orig(kind, nbytes, group)
        aggregation._report = report
        return self

    def __exit__(self, *exc):
        self.mod._report = self.orig


def _fsdp_router_check(cfg, params, group) -> None:
    """The router of unit 0 on a (8, 2048, d) input: its statistics
    all-reduced over a group of one against the local ones."""
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((TRAIN["batch"], TRAIN["seq"], cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    p = {"router": params["unit"]["0_attn"]["moe"]["router"][0]}
    with torch.no_grad():
        lv, li, laux = moe._route(x, p, cfg)
        gv, gi, gaux = moe._route(x, p, cfg, group)
    same = torch.equal(laux, gaux)
    rel = abs(float(gaux) - float(laux)) / abs(float(laux))
    print(f"fsdp: router load-balance loss all-reduced {float(gaux):.9f}, local "
          f"{float(laux):.9f} ({'bit for bit' if same else f'rel {rel:.2e}'}); top-k "
          f"{'equal' if torch.equal(li, gi) and torch.equal(lv, gv) else 'DIFFER'}")
    check(torch.equal(li, gi) and torch.equal(lv, gv) and rel <= 1e-6,
          "fsdp: the router's all-reduced statistics differ from the local ones")


def phase_fsdp() -> dict:
    """Phase 21: FSDP over "data" and MoE over data ranks on NCCL with a
    world of one; returns the launches of each kernel on its main path."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import dequantize_rows, quantize_rows
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.launch.train import build_rules
    from repro_torch.models import transformer
    from repro_torch.optim import make_optimizer

    name, cut, opt, steps = FSDP_RUN
    cfg = dataclasses.replace(configs.get(name), **cut)
    B, S = TRAIN["batch"], TRAIN["seq"]
    weights = torch.from_numpy(
        np.random.default_rng(0).integers(50, 400, B).astype(np.float32)).cuda()
    batches = [{"tokens": torch.from_numpy(b["tokens"]).cuda(), "client_weight": weights}
               for b in lm_data.lm_batches(0, steps, B, S, cfg.vocab_size)]
    counters = dict(_lm_counters(), quantize_rows=quantize_rows,
                    dequantize_rows=dequantize_rows)
    launches = dict.fromkeys(("flash_attention", "flash_attention_bwd", "quantize_rows",
                              "dequantize_rows"), 0)
    card = _card_name()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(d, "rendezvous"),
                                rank=0, world_size=1)
        try:
            mesh = mesh_mod.make_test_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
            sfl = build_rules(mesh, "sfl")
            int8 = {"mesh": mesh, "transport": "two_step_int8"}
            # the int8 transport on full replicas over "data" (and the TP
            # region over "model"), under FSDP, and under TP + FSDP
            ways = {"mesh=None": {}, "fsdp": {"mesh": mesh, "rules": sfl},
                    "two_step_int8": dict(int8, rules=build_rules(mesh, "classical")),
                    "two_step_int8 fsdp": dict(int8, rules=sfl.with_(tensor=None, expert=None)),
                    "two_step_int8 tp+fsdp": dict(int8, rules=sfl)}
            runs = {}
            for label, kw in ways.items():
                params = transformer.init_params(
                    cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
                step = specs.make_train_step(cfg, opt, TRAIN["lr"], seed=0, **kw)
                fsdp = step.layout is not None and step.layout.group is not None
                check(fsdp == label.endswith("fsdp"),
                      f"fsdp: {label} holds {'shards' if fsdp else 'full replicas'}")
                if step.layout is not None:
                    params = step.layout.shard(params)
                state = make_optimizer(opt).init(params)
                for fn in counters.values():
                    _zero_launches(fn)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                losses, dts = [], []
                with HeldCalls() as held, _GatherTap() as tap:
                    for i, batch in enumerate(batches):
                        # sgdm keeps no step counter: the int8 hop's noise a step
                        noise = ({"noise": torch.Generator(device="cuda").manual_seed(i)}
                                 if label.startswith("two_step_int8") else {})
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        params, state, loss = step(params, state, batch, **noise)
                        losses.append(float(loss))
                        torch.cuda.synchronize()
                        dts.append(time.perf_counter() - t0)
                peak = torch.cuda.max_memory_allocated() / 2**30
                counts = {"flash_attention": counters["flash_attention"].launches,
                          "flash_attention_bwd": counters["flash_attention"].launches_bwd,
                          "quantize_rows": quantize_rows.launches,
                          "dequantize_rows": dequantize_rows.launches}
                gathered = tap.bytes.get("all-gather", 0) / steps
                print(f"fsdp {name} {cut} {opt} {label}: losses {losses}; step s cold "
                      f"{dts[0]:.3f} warm {dts[-1]:.3f} ({B * S / dts[-1]:.0f} tokens/s); "
                      f"peak {peak:.2f} GiB; all-gathered {gathered / 2**30:.3f} GiB a step, "
                      f"reduce-scattered {tap.bytes.get('reduce-scatter', 0) / steps / 2**30:.3f}"
                      f" GiB [{card}]; launches {counts}")
                check(all(math.isfinite(x) for x in losses), f"fsdp {label}: a loss is not "
                                                             "finite")
                must = ["flash_attention", "flash_attention_bwd"] + (
                    ["quantize_rows", "dequantize_rows"] if label.startswith("two_step_int8")
                    else [])
                for k in must:
                    check(counts[k] > 0, f"fsdp {label}: {k} never launched")
                if fsdp:
                    check(gathered > 0, f"fsdp: no all-gather on the {label} path")
                by_kernel = held.hold(f"fsdp {label}")
                for k, n in counts.items():
                    check(n == 0 or k in by_kernel, f"fsdp {label}: {k} launched, never held")
                print(f"fsdp {label}: held at the path's shapes (calls, max |kernel - plain|) "
                      f"{by_kernel}, {held.skipped} signatures past the copy budget")
                for k, n in counts.items():
                    launches[k] += n
                if step.layout is not None:
                    params = step.layout.gather(params)
                if label == "fsdp":
                    _fsdp_router_check(cfg, params, mesh_mod.axes_group(mesh, ("pod", "data")))
                if label.startswith("two_step_int8 "):
                    # each sharded way against the replica int8 way
                    rep = runs["two_step_int8"]
                    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, rep["losses"]))
                    print(f"fsdp {label} vs two_step_int8 on replicas: losses "
                          f"{'bit for bit' if losses == rep['losses'] else f'rel {rel:.2e}'}; "
                          f"parameters {_tp_compare(label, params, rep['params'])}")
                    check(rel <= 1e-6, f"fsdp {label}: losses differ from the replica int8 "
                                       "way's")
                    runs[label] = dict(losses=losses)
                else:
                    runs[label] = dict(losses=losses, params={k: v.cpu() for k, v in
                                                              _named_leaves(params)})
                del params, state, step
            _fsdp_compare(runs)
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _named_leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{pre}{k}/")
        else:
            yield pre + k, v


def _fsdp_compare(runs) -> None:
    """FSDP against mesh=None (losses, parameters) and the int8 step-0 loss
    against FSDP's."""
    one, fsdp, int8 = runs["mesh=None"], runs["fsdp"], runs["two_step_int8"]
    same, worst, worst_rel, n_diff, n = True, 0.0, 0.0, 0, 0
    for k, v in one["params"].items():
        v, got = v.cuda(), fsdp["params"][k].cuda()
        same = same and torch.equal(got, v)
        diff = (got.float() - v.float()).abs()
        worst = max(worst, float(diff.max()))
        worst_rel = max(worst_rel, float(diff.max()) / max(float(v.float().abs().max()), 1e-30))
        n_diff += int((diff > 0).sum())
        n += v.numel()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fsdp["losses"], one["losses"]))
    print(f"fsdp vs mesh=None: losses {fsdp['losses']} vs {one['losses']} (rel {loss_rel:.2e}); "
          f"parameters {'bit for bit' if same else f'{n_diff:,} of {n:,} elements differ, max |diff| {worst:.3e} ({worst_rel:.2e} of the leaf max)'}")
    check(loss_rel <= 1e-5, "fsdp: losses differ from mesh=None's")
    # an element may land one bf16 rounding apart where the sums' order differs
    check(worst_rel <= 2.0 ** -7, "fsdp: parameters differ from mesh=None's past a bf16 step")
    rel0 = abs(int8["losses"][0] - fsdp["losses"][0]) / abs(fsdp["losses"][0])
    print(f"fsdp: two_step_int8 step-0 loss {int8['losses'][0]!r}, gspmd (FSDP) "
          f"{fsdp['losses'][0]!r} (rel {rel0:.2e}, held to 1e-6)")
    check(rel0 <= 1e-6, "fsdp: the int8 step-0 loss differs from gspmd's")


# ---------------------------------------------------------------------------
# phase 22: tensor and expert parallelism over "model"
# ---------------------------------------------------------------------------

# (config, its cut, optimizer): phase 21's qwen3-moe-30b-a3b cut, and
# qwen2-0.5b at full width and depth
TP_RUNS = (("qwen3-moe-30b-a3b", {"n_layers": 4}, "sgdm"), ("qwen2-0.5b", {}, "adamw"))
TP_STEPS = 4       # the warm step is the median of steps 2-4: one is noisy


class _RegionTap:
    """While open, the bytes the tensor-parallel region's collectives
    reported (the all-reduces' operands, the all-gathers' outputs, the
    reduce-scatters' inputs): those called from ``core.tensor_parallel``.
    On a world of one every axis's group is the same communicator, so a
    tap on the group would count the "data" collectives too."""

    NAMES = ("all_reduce", "gather_dim", "scatter_dim")

    def __enter__(self):
        from repro_torch.core import aggregation, tensor_parallel
        self.bytes, self.depth = 0, 0
        self.saved = [(aggregation, "_report", aggregation._report)] + [
            (tensor_parallel, n, getattr(tensor_parallel, n)) for n in self.NAMES]
        orig_report = aggregation._report

        def report(kind, nbytes, group):
            if self.depth:
                self.bytes += nbytes
            return orig_report(kind, nbytes, group)
        aggregation._report = report
        for _, name, orig in self.saved[1:]:
            def inside(*args, _orig=orig, **kwargs):
                self.depth += 1
                try:
                    return _orig(*args, **kwargs)
                finally:
                    self.depth -= 1
            setattr(tensor_parallel, name, inside)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def _tp_run(cfg, opt, batches, step, counters):
    """``TP_STEPS`` steps from the seed-0 parameters (the layout's shards
    where the step holds a layout): (losses, the updated parameters
    gathered, warm step s (the median after the first), peak GiB, the tensor-parallel region's
    collective bytes a step, launches, the kernels held at the path's
    shapes)."""
    from repro_torch.models import transformer
    from repro_torch.optim import make_optimizer
    params = transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    lay = step.layout
    if lay is not None:
        params = lay.shard(params)
    state = make_optimizer(opt).init(params)
    for fn in counters.values():
        _zero_launches(fn)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, dts = [], []
    with HeldCalls() as held, _RegionTap() as tap:
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
    counts = {"flash_attention": counters["flash_attention"].launches,
              "flash_attention_bwd": counters["flash_attention"].launches_bwd}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    if lay is not None:
        params = lay.gather(params)
    return (losses, params, statistics.median(dts[1:]), peak, tap.bytes / len(batches),
            counts, held.hold("tp"))


def _tp_compare(label, got, want) -> str:
    """A way's parameters against mesh=None's (``want``: its leaves on the
    host, by name, so no way's peak holds them): "bit for bit", else the
    differing elements, held within one bf16 rounding of each leaf's max."""
    same, worst_rel, n_diff, n = True, 0.0, 0, 0
    for k, g in _named_leaves(got):
        v = want[k].cuda()
        same = same and torch.equal(g, v)
        diff = (g.float() - v.float()).abs()
        worst_rel = max(worst_rel, float(diff.max()) / max(float(v.float().abs().max()), 1e-30))
        n_diff += int((diff > 0).sum())
        n += v.numel()
    check(worst_rel <= 2.0 ** -7, f"tp {label}: parameters differ from mesh=None's past a "
                                   "bf16 step")
    return "bit for bit" if same else (f"{n_diff:,} of {n:,} elements differ, at most "
                                       f"{worst_rel:.2e} of the leaf max")


def _tp_kernels() -> dict:
    """Flash attention (forward with the log-sum-exp, backward), the RWKV6
    scan and the RG-LRU scan (each forward and backward) against their plain
    versions at the shapes a rank of the 16-way "model" axis gives them in
    the train step (B 8, S 2048): qwen2-0.5b's one local head of its 14 (KV
    expanded by the global map: 7 query heads share a KV head, so no rank's
    block is a whole group) and rank 0's 8 heads at a 2-way split (heads
    0-7: KV heads 0 ×7, 1); 3 of rwkv6-3b's 48 padded heads; 256 of
    recurrentgemma-9b's 4096 RG-LRU channels. Returns each kernel's rows,
    keyed by shape. Launches here are the comparison's, not the main
    path's."""
    import importlib

    import torch.nn.functional as F

    from repro_torch.kernels import (flash_attention_bwd_plain, flash_attention_plain,
                                     rglru_scan_bwd_plain, rglru_scan_plain,
                                     rwkv6_scan_bwd_plain, rwkv6_scan_plain)
    from repro_torch.models import layers
    fa, rg, rw = (importlib.import_module(f"repro_torch.kernels.{m}")
                  for m in ("flash_attention", "rglru_scan", "rwkv6_scan"))
    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = {}
    B, S, hd, H, KV = 8, 2048, 64, 14, 2
    for what, lo, Hl in (("qwen2-0.5b, 16-way: rank 0's 1 head", 0, 1),
                         ("qwen2-0.5b, 2-way: rank 0's 8 heads", 0, 8)):
        n = min(H - lo, Hl)
        q, do = (torch.randn((B, S, n, hd), generator=gen, device="cuda").to(torch.bfloat16)
                 .transpose(1, 2) for _ in range(2))
        k, v = (layers._expand_kv(torch.randn((B, S, KV, hd), generator=gen, device="cuda")
                                  .to(torch.bfloat16), n, H, KV, lo).transpose(1, 2)
                for _ in range(2))
        scale = 1.0 / math.sqrt(hd)
        o, lse = fa._forward(q, k, v, True, 0, scale, 0.0, with_lse=True)
        po, plse = flash_attention_plain(q, k, v, return_lse=True)
        err_o, ok_o = _within(o, po, 2.0 ** -7, 1e-5)
        err_l, ok_l = _within(lse, plse, 1e-5, 1e-5)
        check(ok_o and ok_l, f"tp flash forward [{what}]: o {err_o}, lse {err_l}")
        got = fa._backward(q, k, v, o, lse, do, True, 0, scale, 0.0)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do)
        err_b, ratio_b = _grads_close(f"tp flash backward [{what}]", got, want,
                                      ("dq", "dk", "dv"), 2.0 ** -7, 1e-4)
        del got, want, po, plse
        ms = time_ms(lambda: fa._forward(q, k, v, True, 0, scale, 0.0, with_lse=True))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, return_lse=True), reps=5,
                           warmup=1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        rows.setdefault("flash_attention", {})[what] = _report(
            "flash_attention", f"{what} B={B} H={n} KV={n} (expanded) S={S} hd={hd} bf16",
            err_o, ms, plain_ms, lib,
            *fa.flash_attention_cost(B, n, n, S, hd, q.dtype, with_lse=True).bound(),
            note=" (o within 2^-7·|plain| + 1e-5; library: scaled_dot_product_attention, "
                 "is_causal)")
        bms = time_ms(lambda: fa._backward(q, k, v, o, lse, do, True, 0, scale, 0.0))
        bplain = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), reps=3,
                         warmup=1)
        qx, kx, vx = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qx, kx, vx, is_causal=True)
        blib = time_ms(lambda: torch.autograd.grad(out, (qx, kx, vx), do, retain_graph=True))
        del out, qx, kx, vx
        rows.setdefault("flash_attention_bwd", {})[what] = _report(
            "flash_attention_bwd", f"{what} B={B} H={n} KV={n} S={S} hd={hd} bf16", err_b,
            bms, bplain, blib, *fa.flash_attention_bwd_cost(B, n, n, S, hd, q.dtype).bound(),
            note=f" ({ratio_b:.2e} of the gradient's max; <= 2^-7·|plain| + 1e-4·max; "
                 "library: the backward of scaled_dot_product_attention, is_causal)")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

    what, Hl, W = "rwkv6-3b, 16-way: 3 of 48 heads", 3, 64
    r, k, v = (torch.randn((B, S, Hl, hd), generator=gen, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    logw = -torch.exp(0.5 * torch.randn((B, S, Hl, hd), generator=gen, device="cuda")
                      ).transpose(1, 2)
    u = 0.5 * torch.randn((Hl, hd), generator=gen, device="cuda")
    do = torch.randn((B, S, Hl, hd), generator=gen, device="cuda").transpose(1, 2)
    o, s_out, scratch = rw._forward(r, k, v, logw, u, W, None, "chunked")
    po, ps = rwkv6_scan_plain(r, k, v, logw, u, chunk=W)
    err_f, ratio_f = _grads_close(f"tp rwkv6 forward [{what}]", (o, s_out), (po, ps),
                                  ("o", "S"), 2e-3, 1e-3)
    got = rw._backward(r, k, v, logw, u, s_out, scratch, do, None, W)
    want = rwkv6_scan_bwd_plain(r, k, v, logw, u, do, chunk=W)
    err_b = max(_grads_close(f"tp rwkv6 backward [{what}]", got[:3], want[:3],
                             ("dr", "dk", "dv"), 2.0 ** -7, 1e-3)[0],
                _grads_close(f"tp rwkv6 backward [{what}]", got[3:5], want[3:5],
                             ("dlogw", "du"), 2e-3, 1e-3)[0])
    del got, want, po, ps
    rows["rwkv6_scan"] = {what: _report(
        "rwkv6_scan", f"{what} B={B} H={Hl} S={S} hd={hd} W={W} bf16", err_f,
        time_ms(lambda: rw._forward(r, k, v, logw, u, W, None, "chunked")),
        time_ms(lambda: rwkv6_scan_plain(r, k, v, logw, u, chunk=W), reps=3, warmup=1), None,
        *rw.rwkv6_scan_cost(B, Hl, S, hd, W, torch.bfloat16, chunk_states=True).bound(),
        note=f" ({ratio_f:.2e} of max; <= 2e-3·|plain| + 1e-3·max)")}
    rows["rwkv6_scan_bwd"] = {what: _report(
        "rwkv6_scan_bwd", f"{what} B={B} H={Hl} S={S} hd={hd} W={W} bf16", err_b,
        time_ms(lambda: rw._backward(r, k, v, logw, u, s_out, scratch, do, None, W)),
        time_ms(lambda: rwkv6_scan_bwd_plain(r, k, v, logw, u, do, chunk=W), reps=3,
                warmup=1), None,
        *rw.rwkv6_scan_bwd_cost(B, Hl, S, hd, W, torch.bfloat16, False).bound(),
        note=" (dr, dk, dv within 2^-7·|plain| + 1e-3·max, dlogw, du 2e-3·|plain| + "
             "1e-3·max)")}
    del r, k, v, logw, u, do, o, s_out, scratch

    what, C = "recurrentgemma-9b, 16-way: 256 of 4096 channels", 256
    a = torch.rand((B, S, C), generator=gen, device="cuda")
    b = torch.randn((B, S, C), generator=gen, device="cuda")
    dout = torch.randn((B, S, C), generator=gen, device="cuda")
    out, last = rg._forward(a, b, None, share=False)
    check(all(torch.equal(x, y) for x, y in zip((out, last), rglru_scan_plain(a, b))),
          f"tp rglru forward [{what}] differs from its plain version")
    got = rg._backward(a, out, None, dout, None)
    check(all(torch.equal(x, y) for x, y in
              zip(got, rglru_scan_bwd_plain(a, out, None, dout, None)) if x is not None),
          f"tp rglru backward [{what}] differs from its plain version")
    rows["rglru_scan"] = {what: _report(
        "rglru_scan", f"{what} B={B} S={S} C={C} f32", 0.0,
        time_ms(lambda: rg._forward(a, b, None, share=False)),
        time_ms(lambda: rglru_scan_plain(a, b), reps=3, warmup=1), None,
        *rg.rglru_scan_cost(B, S, C, with_h0=False).bound(), note=" (bit for bit)")}
    rows["rglru_scan_bwd"] = {what: _report(
        "rglru_scan_bwd", f"{what} B={B} S={S} C={C} f32", 0.0,
        time_ms(lambda: rg._backward(a, out, None, dout, None)),
        time_ms(lambda: rglru_scan_bwd_plain(a, out, None, dout, None), reps=3, warmup=1),
        None, *rg.rglru_scan_bwd_cost(B, S, C, with_h0=False, with_dh_last=False).bound(),
        note=" (bit for bit)")}
    del a, b, dout, out, last, got
    torch.cuda.empty_cache()
    return rows


def phase_tp():
    """Phase 22: tensor and expert parallelism over "model" on NCCL with a
    world of one, mesh ("data" 1, "model" 1), ``TP_STEPS`` steps of each
    ``TP_RUNS`` model three ways: the TP code path with every
    "model" collective on a group of one, against mesh=None; then each
    kernel the path launches at a 16-way model rank's shapes. Returns (the
    main path's launches, the kernels' rows)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import lm as lm_data
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.launch.train import build_rules

    B, S = TRAIN["batch"], TRAIN["seq"]
    weights = torch.from_numpy(
        np.random.default_rng(0).integers(50, 400, B).astype(np.float32)).cuda()
    counters = _lm_counters()
    launches = dict.fromkeys(("flash_attention", "flash_attention_bwd"), 0)
    card = _card_name()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as d:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(d, "rendezvous"),
                                rank=0, world_size=1)
        try:
            mesh = mesh_mod.make_test_mesh((1, 1), ("data", "model"), "cuda")
            ways = {"mesh=None": {}, "tp": {"mesh": mesh, "rules": build_rules(mesh, "classical")},
                    "tp+fsdp": {"mesh": mesh, "rules": build_rules(mesh, "sfl")}}
            for name, cut, opt in TP_RUNS:
                cfg = dataclasses.replace(configs.get(name), **cut)
                batches = [{"tokens": torch.from_numpy(b["tokens"]).cuda(),
                            "client_weight": weights}
                           for b in lm_data.lm_batches(0, TP_STEPS, B, S, cfg.vocab_size)]
                base = None
                for label, kw in ways.items():
                    step = specs.make_train_step(cfg, opt, TRAIN["lr"], seed=0, **kw)
                    lay = step.layout
                    tp_on = lay is not None and lay.tp is not None
                    fsdp_on = lay is not None and lay.group is not None
                    check(tp_on == (label != "mesh=None"),
                          f"tp {label}: the tensor-parallel path {'' if tp_on else 'not '}taken")
                    check(fsdp_on == (label == "tp+fsdp"),
                          f"tp {label}: FSDP {'on' if fsdp_on else 'off'}")
                    losses, params, warm, peak, per_step, counts, held = _tp_run(
                        cfg, opt, batches, step, counters)
                    tag = f"tp {name} {cut} {opt} {label}"
                    check(all(math.isfinite(x) for x in losses), f"{tag}: a loss is not finite")
                    if base is None:
                        base = (losses, {k: v.cpu() for k, v in _named_leaves(params)})
                        same = "the reference run"
                    else:
                        for k in launches:
                            check(counts[k] > 0, f"{tag}: {k} never launched")
                            launches[k] += counts[k]
                        check(per_step > 0, f"{tag}: no collective over 'model'")
                        check(losses == base[0] or max(
                            abs(a - b) / abs(b) for a, b in zip(losses, base[0])) <= 1e-5,
                            f"{tag}: losses {losses} vs mesh=None's {base[0]}")
                        same = (f"losses {'bit for bit' if losses == base[0] else 'within 1e-5'}"
                                f"; parameters {_tp_compare(label, params, base[1])}")
                    print(f"{tag}: losses {losses}; warm step {warm:.3f} s "
                          f"({B * S / warm:.0f} tokens/s); peak {peak:.2f} GiB; 'model' "
                          f"collectives {per_step / 2**30:.3f} GiB a step [{card}; one card: "
                          f"nothing crosses a link]; launches {counts}; held {held}; vs "
                          f"mesh=None: {same}")
                    del params, step
                del base
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    rows = _tp_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rows


# ---------------------------------------------------------------------------
# phase 23: serving over "model"
# ---------------------------------------------------------------------------

# (config, its cut): recurrentgemma-9b (windowed MQA ring, RG-LRU state) and
# rwkv6-3b (RWKV6 state, 40 heads padded to 48) at full width and depth,
# qwen3-moe-30b-a3b (expert-parallel decode) cut to 4 layers
SERVE_TP_RUNS = (("recurrentgemma-9b", {}), ("rwkv6-3b", {}),
                 ("qwen3-moe-30b-a3b", {"n_layers": 4}))
SERVE_TP = dict(batch=4, prompt_len=4096, gen=8)
SPLIT_SHARDS = 16          # the sequence layout's shards at a 16-way "model" axis
SERVE_TOL = 0.08           # the serve path's bf16 tolerance (phase 10)


def _split_decode(q, k, v, valid, softcap, n):
    """The decode attention of ``q`` over a cache split into ``n`` sequence
    shards in one process: each shard's partial softmax, then the combine
    (a max and a sum over the stacked shards)."""
    from repro_torch.models import layers
    S = k.shape[1]
    parts = [layers.partial_decode_attention(q, k[:, i * S // n:(i + 1) * S // n],
                                             v[:, i * S // n:(i + 1) * S // n],
                                             valid[i * S // n:(i + 1) * S // n], softcap)
             for i in range(n)]
    o, lse = (torch.stack(t) for t in zip(*parts))
    return layers.combine_partial_attention(o, lse, lambda t: t.amax(0), lambda t: t.sum(0))


class _SplitTap:
    """While open, each decode attention call's output held against the same
    cache split into ``SPLIT_SHARDS`` sequence shards in one process
    (``_split_decode``): the sequence layout's arithmetic on the card,
    where a world of one always holds its cache by heads. Records the
    largest |split − unsplit| and the calls held."""

    def __enter__(self):
        from repro_torch.models import layers
        self.mod, self.orig, self.worst, self.calls, self.empty = (
            layers, layers._decode_attention, 0.0, 0, 0)

        def tapped(q, k_new, v_new, cache, cfg, window, *args, **kw):
            pos = int(cache["pos"])
            o, new = self.orig(q, k_new, v_new, cache, cfg, window, *args, **kw)
            kc, vc = cache["k"], cache["v"]
            Smax, Hl = kc.shape[1], q.shape[2]
            valid = layers.decode_valid(torch.arange(Smax, device=q.device), pos, Smax, window)
            H, KV = cfg.n_heads, cfg.n_kv_heads
            got = _split_decode(q, layers._expand_kv(kc, Hl, H, KV),
                                layers._expand_kv(vc, Hl, H, KV), valid, cfg.logit_softcap,
                                SPLIT_SHARDS)
            self.worst = max(self.worst, float((got - o.float()).abs().max()))
            self.empty += int((~valid.view(SPLIT_SHARDS, -1).any(1)).sum())
            self.calls += 1
            return o, new
        layers._decode_attention = tapped
        return self

    def __exit__(self, *exc):
        self.mod._decode_attention = self.orig


def _serve_tp_run(cfg, params, prompt, cache_len, gen, mesh=None, rules=None, fed=None):
    """Prefill the prompt, then ``gen`` decode steps through the serve
    steps of ``mesh`` and ``rules``: greedy, or fed the tokens ``fed``.
    Returns (the prefill's and every step's logits (gen + 1, B, V) f32, the
    tokens fed, prefill s, the median decode step s, the cache's bytes)."""
    from repro_torch.launch import specs
    B, P = prompt.shape
    prefill = specs.make_prefill_step(cfg, cache_len, mesh, rules)
    serve = specs.make_serve_step(cfg, mesh, rules)
    if prefill.layout is not None:
        params = prefill.layout.shard(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
    out, tokens, dts = [logits.float()], [], []
    for t in range(gen):
        nxt = logits.argmax(-1) if fed is None else fed[t]
        tokens.append(nxt)
        batch = {"tokens": nxt[:, None],
                 "pos": torch.full((B, 1), P + t, dtype=torch.int32, device="cuda")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = serve(params, batch, cache)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        out.append(logits.float())
    del cache
    return torch.stack(out), tokens, prefill_s, statistics.median(dts), cache_bytes


def _serve_tp_kernels() -> dict:
    """Flash attention, the RG-LRU scan and the RWKV6 scan against their
    plain versions at the shapes a rank of a 16-way "model" axis gives them
    in serving (batch 4, prompt 4096): recurrentgemma-9b's one head of 16
    (MQA, hd 256, window 2048) and qwen3-moe-30b-a3b rank 0's 2 heads of 32
    (both read KV head 0 of 4: expanded, one a query head), 256 of
    recurrentgemma-9b's 4096 RG-LRU channels and 3 of rwkv6-3b's 48 padded
    heads, in prefill and at a decode step (from a state; the RWKV6 decode
    route). Launches here are the comparison's, not the main path's."""
    import torch.nn.functional as F

    from repro_torch.kernels import (flash_attention, flash_attention_plain, rglru_scan,
                                     rglru_scan_plain, rwkv6_scan, rwkv6_scan_plain)
    from repro_torch.kernels.flash_attention import flash_attention_cost
    from repro_torch.kernels.rglru_scan import rglru_scan_cost
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cost
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    B, S = SERVE_TP["batch"], SERVE_TP["prompt_len"]
    for what, H, hd, window in (("recurrentgemma-9b prefill, 16-way: 1 of 16 heads", 1, 256,
                                 2048),
                                ("qwen3-moe-30b-a3b prefill, 16-way: rank 0's 2 of 32 heads",
                                 2, 128, 0)):
        q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        got, want = flash_attention(q, k, v, window=window), flash_attention_plain(
            q, k, v, window=window)
        err, ok = _within(got, want, 2.0 ** -7, 1e-5)
        check(ok, f"serve tp flash [{what}] disagrees with its plain version: {err}")
        del got, want
        if window:
            idx = torch.arange(S, device="cuda")
            mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None] - window)
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            del mask
        else:
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        rows.setdefault("flash_attention", {})[what] = _report(
            "flash_attention", f"{what} B={B} H={H} KV={H} S={S} hd={hd} window={window} bf16",
            err, time_ms(lambda: flash_attention(q, k, v, window=window)),
            time_ms(lambda: flash_attention_plain(q, k, v, window=window), reps=5, warmup=1),
            lib, *flash_attention_cost(B, H, H, S, hd, torch.bfloat16, window).bound(),
            note=" (<= 2^-7·|plain|; library: scaled_dot_product_attention, boolean window "
                 "mask or is_causal)")
        del q, k, v

    C = 4096 // 16
    for what, n in (("recurrentgemma-9b prefill, 16-way: 256 of 4096 channels", S),
                    ("recurrentgemma-9b decode step, 16-way: 256 of 4096 channels", 1)):
        a = torch.rand((B, n, C), generator=gen, device="cuda")
        b = torch.randn((B, n, C), generator=gen, device="cuda")
        h0 = None if n > 1 else torch.randn((B, C), generator=gen, device="cuda")
        check(all(torch.equal(x, y) for x, y in zip(rglru_scan(a, b, h0),
                                                    rglru_scan_plain(a, b, h0))),
              f"serve tp rglru [{what}] differs from its plain version")
        rows.setdefault("rglru_scan", {})[what] = _report(
            "rglru_scan", f"{what} B={B} S={n} C={C} f32", 0.0,
            time_ms(lambda: rglru_scan(a, b, h0)),
            time_ms(lambda: rglru_scan_plain(a, b, h0), reps=5, warmup=1), None,
            *rglru_scan_cost(B, n, C, with_h0=h0 is not None).bound(), note=" (bit for bit)")
        del a, b, h0

    Hl, hd, W = 48 // 16, 64, 64
    for what, n in (("rwkv6-3b prefill, 16-way: 3 of 48 heads, chunked route", S),
                    ("rwkv6-3b decode step, 16-way: 3 of 48 heads, decode route", 1)):
        r, k, v = (torch.randn((B, n, Hl, hd), generator=gen, device="cuda").bfloat16()
                   .transpose(1, 2) for _ in range(3))
        logw = -torch.exp(0.5 * torch.randn((B, n, Hl, hd), generator=gen, device="cuda")
                          ).transpose(1, 2)
        u = 0.5 * torch.randn((Hl, hd), generator=gen, device="cuda")
        s0 = None if n > 1 else torch.randn((B, Hl, hd, hd), generator=gen, device="cuda")
        counter = "launches_decode" if n == 1 else "launches_chunked"
        before = getattr(rwkv6_scan, counter)
        o, st = rwkv6_scan(r, k, v, logw, u, chunk=W, s0=s0)
        check(getattr(rwkv6_scan, counter) == before + 1,
              f"serve tp rwkv6 [{what}] did not take its {counter} route")
        po, ps = rwkv6_scan_plain(r, k, v, logw, u, chunk=W, s0=s0)
        err_o, ok_o = _within(o, po, 2e-3, 2e-3)
        err_s, ok_s = _within(st, ps, 2e-3, 2e-3)
        check(ok_o and ok_s, f"serve tp rwkv6 [{what}]: o {err_o}, state {err_s}")
        rows.setdefault("rwkv6_scan", {})[what] = _report(
            "rwkv6_scan", f"{what} B={B} H={Hl} S={n} hd={hd} W={W} bf16", max(err_o, err_s),
            time_ms(lambda: rwkv6_scan(r, k, v, logw, u, chunk=W, s0=s0)),
            time_ms(lambda: rwkv6_scan_plain(r, k, v, logw, u, chunk=W, s0=s0), reps=5,
                    warmup=1), None,
            *rwkv6_scan_cost(B, Hl, n, hd, W, torch.bfloat16, s0 is not None).bound(),
            note=" (<= 2e-3 + 2e-3·|plain|, o and state)")
        del r, k, v, logw, u, s0, o, st, po, ps
    torch.cuda.empty_cache()
    return rows


def phase_serve_tp():
    """Phase 23: serving over "model" on NCCL with a world of one, mesh
    ("data" 1, "model" 1), the reference's rules (FSDP over "data", tensor
    and expert parallelism over "model"): each ``SERVE_TP_RUNS`` model
    prefills 4 × 4096 and decodes 8 steps, greedy the first time with
    mesh=None and fed those tokens after: cold, mesh=None and TP + FSDP;
    warm, mesh=None, TP on full replicas and TP + FSDP (the main path:
    launches counted, kernels held, its peak), every "model" and "data"
    collective on a group of one; logits against mesh=None's. Then a
    mesh=None run whose decode attention calls are each held against the
    same cache split into 16 sequence shards in one process
    (``_SplitTap``), and the kernels at a 16-way serving rank's shapes.
    Returns (the main path's launches, the kernels' rows)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import build_rules
    from repro_torch.models import transformer

    B, P, G = SERVE_TP["batch"], SERVE_TP["prompt_len"], SERVE_TP["gen"]
    counters = _lm_counters()
    launches = dict.fromkeys(counters, 0)
    card = _card_name()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_tp_") as d:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(d, "rendezvous"),
                                rank=0, world_size=1)
        try:
            mesh = mesh_mod.make_test_mesh((1, 1), ("data", "model"), "cuda")
            # cold, then warm; the warm round adds TP on full replicas over
            # "data", which parts the region's cost from the FSDP gathers'
            rounds = (("cold", {"mesh=None": (None, None),
                                "tp+fsdp": (mesh, build_rules(mesh, "sfl"))}),
                      ("warm", {"mesh=None": (None, None),
                                "tp": (mesh, build_rules(mesh, "classical")),
                                "tp+fsdp": (mesh, build_rules(mesh, "sfl"))}))
            for name, cut in SERVE_TP_RUNS:
                cfg = dataclasses.replace(configs.get(name), **cut)
                if cfg.n_experts:      # no drops: near ties split by bf16 rounding elsewhere
                    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
                tag = f"serve tp {name}{' ' + str(cut) if cut else ''}"
                gen = torch.Generator(device="cuda").manual_seed(23)
                params = transformer.init_params(cfg, gen, "cuda")
                prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
                # twice the prompt: the shards past it start empty in the split check
                cache_len = 2 * P
                fed, want, times = None, None, []
                for rnd, ways in rounds:
                    for label, (m, r) in ways.items():
                        main = rnd == "warm" and label == "tp+fsdp"
                        gc.collect()
                        torch.cuda.empty_cache()
                        if main:       # the main path: counted, held, its peak
                            for fn in counters.values():
                                _zero_launches(fn)
                            torch.cuda.reset_peak_memory_stats()
                        with HeldCalls() if main else contextlib.nullcontext() as held:
                            got, toks, pre_s, dec_s, cache_bytes = _serve_tp_run(
                                cfg, params, prompt, cache_len, G, m, r, fed)
                        fed = fed or toks
                        times.append(f"{rnd} {label} {pre_s:.3f} s, {1e3 * dec_s:.2f} ms/step")
                        check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (
                            G + 1, B, cfg.vocab_size), f"{tag} {label}: logits not finite or "
                                                       "misshapen")
                        if want is None:
                            want, want_bytes = got, cache_bytes
                            continue
                        scale = max(1.0, float(want.abs().max()))
                        diff = float((got - want).abs().max())
                        print(f"{tag} {rnd} {label}: logits vs mesh=None "
                              f"{'bit for bit' if torch.equal(got, want) else f'max |diff| {diff:.3e} of {scale:.3e}'}")
                        check(diff <= SERVE_TOL * scale, f"{tag} {label}: logits {diff} from "
                                                         "mesh=None's")
                        check(cache_bytes == want_bytes,
                              f"{tag} {label}: a world of one holds the whole cache")
                        if main:
                            counts = {k: fn.launches for k, fn in counters.items()}
                            routes = {k: _route_counts(counters[k])
                                      for k in ("flash_attention", "rwkv6_scan")}
                            peak = torch.cuda.max_memory_allocated() / 2**30
                            by_kernel = held.hold(tag)
                        del got
                print(f"{tag} (batch {B}, prompt {P}, {G} steps; prefill s, decode ms/step): "
                      f"{'; '.join(times)}; cache {want_bytes / 2**30:.3f} GiB; peak "
                      f"{peak:.2f} GiB (tp+fsdp, warm) [{card}]; launches {counts}, by route "
                      f"{routes}; held {by_kernel}")
                want_counts = _routing(cfg, G)
                check(counts == want_counts, f"{tag}: launches {counts}, want {want_counts}")
                for k, n in counts.items():
                    check(n == 0 or k in by_kernel, f"{tag}: {k} launched, never held")
                    launches[k] += n
                if "attn" in list(cfg.block_pattern) + list(cfg.tail_pattern):
                    with _SplitTap() as split:
                        _serve_tp_run(cfg, params, prompt, cache_len, G, fed=fed)
                    print(f"{tag}: {split.calls} decode attention calls split into "
                          f"{SPLIT_SHARDS} sequence shards ({split.empty} shard calls with no "
                          f"valid slot): max |split - unsplit| {split.worst:.3e}, held to "
                          f"{SERVE_TOL}")
                    check(split.calls > 0 and split.worst <= SERVE_TOL,
                          f"{tag}: the split-softmax decode is {split.worst} from the unsplit")
                del params, prompt, want, fed
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    rows = _serve_tp_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    from repro_torch import device as device_mod
    device_mod.resolve("cuda")                 # f32 numerics, as the port runs
    t0 = time.perf_counter()

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    phase(phase_card)
    phase(phase_build)
    main_case = phase(phase_kernels)
    im2col_row = phase(phase_conv)
    slice_launches, classical_involved = phase(phase_slice)
    phase(phase_parity)
    rows = phase(phase_compression_kernels)
    rows["agg_reduce"] = main_case
    compressed = phase(phase_compressed_slice, classical_involved)
    compressed["agg_reduce"] += slice_launches["agg_reduce"]
    phase(phase_compressed_parity)
    rows.update(phase(phase_lm_kernels))
    launches = dict(compressed, **phase(phase_serve))
    for name, n in phase(phase_family_serve).items():
        launches[name] += n
    phase(phase_lm_parity)
    train_rows = phase(phase_train_kernels)
    rows["flash_attention_bwd"] = dict(train_rows["flash_attention_bwd"],
                                       train_shapes=train_rows["train_shapes"])
    rows["flash_attention"]["train_forward"] = train_rows["forward_train"]
    rows.update(phase(phase_scan_bwd_kernels))
    trained = phase(phase_train)
    for name in ("flash_attention", "rglru_scan", "rwkv6_scan"):
        launches[name] += trained[name]
        launches[name + "_bwd"] = trained[name + "_bwd"]
    phase(phase_train_parity)
    lm_rows, (n_quantize, n_dequantize) = phase(phase_collectives)
    for name, n in (("quantize_rows", n_quantize), ("dequantize_rows", n_dequantize)):
        rows[name]["lm_gradient_leaf"] = dict(lm_rows[name], launches=n)
        launches[name] += n
    forest_rows, transport_launches = phase(phase_transport)
    for name, by_tier in forest_rows.items():
        rows[name]["forest_shapes"] = by_tier
    for name, n in transport_launches.items():
        launches[name] += n
    runtime_rows, runtime_launches, lm_launches = phase(phase_runtime)
    rows["agg_reduce"]["runtime_shapes"] = runtime_rows
    for name, n in dict(runtime_launches, **lm_launches).items():
        launches[name] += n
    for name, n in phase(phase_obs).items():
        launches[name] += n
    phase(phase_cost)
    for name, n in phase(phase_examples).items():
        launches[name] += n
    for name, n in phase(phase_fsdp).items():
        launches[name] += n
    tp_launches, tp_rows = phase(phase_tp)
    for name, n in tp_launches.items():
        launches[name] += n
    for name, by_shape in tp_rows.items():
        rows[name]["tp_shapes"] = by_shape
    serve_tp_launches, serve_tp_rows = phase(phase_serve_tp)
    for name, n in serve_tp_launches.items():
        launches[name] += n
    for name, by_shape in serve_tp_rows.items():
        rows[name]["serve_tp_shapes"] = by_shape
    rows["im2col"], launches["im2col"] = im2col_row, slice_launches["im2col"]
    print(f"total {time.perf_counter() - t0:.1f} s")
    csrc = "src/repro_torch/kernels/csrc/"
    table = (("agg_reduce", csrc + "agg_reduce.cu", "src/repro/kernels/agg_reduce.py:60"),
             ("agg_reduce_quant", csrc + "agg_reduce.cu",
              "src/repro/kernels/agg_reduce.py:85"),
             ("quantize_rows", csrc + "quantize.cu", "src/repro/kernels/quantize.py:55"),
             ("dequantize_rows", csrc + "quantize.cu", "src/repro/kernels/quantize.py:92"),
             ("topk_mask_rows", csrc + "quantize.cu", "src/repro/kernels/quantize.py:130"),
             ("flash_attention", csrc + "flash_attention_wgmma.cu",
              "src/repro/kernels/flash_attention.py:78"),
             ("flash_attention_bwd", csrc + "flash_attention_bwd.cu",
              "src/repro/kernels/flash_attention.py:78"),
             ("rglru_scan", csrc + "rglru_scan.cu", "src/repro/kernels/rglru_scan.py:49"),
             ("rwkv6_scan", csrc + "rwkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:79"),
             ("rglru_scan_bwd", csrc + "rglru_scan.cu", "src/repro/kernels/rglru_scan.py:49"),
             ("rwkv6_scan_bwd", csrc + "rwkv6_scan_bwd.cu", "src/repro/kernels/rwkv6_scan.py:79"),
             ("im2col", csrc + "im2col.cu", "none: the reference convolves with XLA"))
    # the design of each route ("route" itself stays "cuda", the build route)
    designs = {"agg_reduce": "no CSR for one segment, else a CSR copied from pinned memory "
                             "without blocking the host; 4 row loads a batch",
               "flash_attention": "wgmma, TMA-fed K/V ring (bf16); CUDA-core FMAs (f32: "
                                  + csrc + "flash_attention.cu)",
               "flash_attention_bwd": "the gradient of the row above, which the TPU kernel "
                                      "lacks (the reference differentiates its jnp "
                                      "attention): dK/dV by key tile over the GQA group, "
                                      "then dQ by query tile; bf16 on wgmma fed by a TMA "
                                      "ring (P, dS as bf16 hi + lo; at hd 256 64-row blocks "
                                      "whose two warpgroups split the head's columns and "
                                      "both compute the tile's scores); f32 on CUDA-core "
                                      "FMAs",
               "rglru_scan": "one-warp blocks of 32 channels, a 4-stage cp.async ring of "
                             "32 time steps feeding the in-order chain",
               "rwkv6_scan": "chunk-parallel, mma.sync 3xTF32; decode route for S = 1",
               "rglru_scan_bwd": "the gradient of the row rglru_scan, which the TPU kernel "
                                 "lacks (the reference differentiates its associative scan): "
                                 "the forward's cp.async ring run backwards in time",
               "rwkv6_scan_bwd": "the gradient of the row rwkv6_scan, which the TPU kernel "
                                 "lacks (the reference differentiates its jnp chunk body): "
                                 "the forward's three launches in reverse from its saved chunk "
                                 "states; products mma.sync 3xTF32; the pair sums factored "
                                 "over 16-token sub-chunks as the forward's, off-diagonal "
                                 "blocks as products, per-pair exponentials only on the "
                                 "diagonal blocks; 95 KB of shared memory, two blocks an SM",
               "im2col": "added for the CNN's patch gather (ATen's im2col launches once a "
                         "sample): one launch a call; a block stages a band of a plane with "
                         "its halo in shared memory and writes its kernel rows with 16-byte "
                         "stores"}
    for name, _, _ in table:
        check(launches[name] > 0, f"{name} never launched on the main path")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **rows[name],
         **({"design": designs[name]} if name in designs else {})}
        for name, source, replaces in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
