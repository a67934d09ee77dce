#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero; nothing is caught and
ignored):

1. Device: the card's name and power limit.
2. Build: the CUDA kernels from ``src/repro_torch/csrc`` with nvcc
   for sm_90a (one nvcc per source, started together).
3. Kernels: first the decoder layer's fused glue (``phase_glue``):
   ``add_rmsnorm``, ``gated_act``, ``rope`` and ``rope_cache_write``
   against their plain versions at yi-9b's serving shapes (decode at B
   1 and 8 over a 1024-slot ring, prefill at [1, 256] and [8, 256]), in
   f32 and, timed, in bf16 (``add_rmsnorm`` and ``gated_act`` within one
   bf16 step, the rotations within 1e-2), one row each with its device
   time, bytes bound, host time per call and the plain version's, and
   the launches of its kernel over phase 4's yi-9b run (a ``glue`` JSON
   line), and again at deepseek-moe-16b's (D 2048; decode at B 1 and 8
   over a 4096-slot ring, prefill at [1, 1024] and [8, 1024];
   ``gated_act`` at the dense layer's 10944 and the shared experts' 2816;
   launches from phase 9's run); the MoE layer's kernels (``moe_route``,
   ``moe_permute``, ``moe_combine``) against their plain versions at
   deepseek-moe-16b's shapes (D 2048, E 64, top 6; T 1, 8, 1024 and 8192) in
   f32 and, timed, in bf16, one row each with its device time, bound and
   the plain version's time (a ``moe_kernels`` JSON line, launches from
   phase 9's run; ``phase_moe_kernels``); then full-width yi-9b's prefill and
   decode step at B 1 and 8 with the glue fused and eager: launch calls (profiler), host and
   device time, and the logits of the two held together.  Then each attention
   and recurrence kernel against its plain PyTorch version at its path's
   shapes, in bf16 and f32 inputs, plus its time, the plain version's
   time, one PyTorch call's time where one computes the same function
   (``scaled_dot_product_attention`` for the attention kernels, timed
   only; none for the recurrences) and the least time the card could
   take (the bound).  For all four kernels (and SDPA) also the device
   work alone (``device_ms``, see ``time_ms``) and the host time per
   call.  yi-9b: H=32, K=4, hd=128; decode B=4 over a
   1024-slot ring cache with empty -1 slots, flash B=4, S=256.  gemma2-
   9b (H=16, K=8, hd=256, softcap 50, scale 1/16): flash [1, 16, 8192,
   256] causal at a local layer (window 4096) and a global one (no
   window), both on the ping-pong instance (asserted); decode B=4 over
   a 4096-slot ring that has wrapped (``phase_gemma2_kernels``); SDPA has no
   softcap, so these rows' ``library_ms`` is null and SDPA's time
   without the softcap is recorded beside it (the window and causality
   as a mask, and at the global layer also ``is_causal=True``).  rwkv6-
   1.6b: wkv6 at r/k/v/w [4, 256, 32, 64].  recurrentgemma-2b:
   rglru_scan at [4, 256, 2560].  Asserts that flash ran its tensor-core
   (``wgmma``) instance in bf16 and its SIMT instance in f32, that the
   recurrences ran their split instances at their f32 path shapes (wkv6:
   tiles of 4 x 4 of S, 16 lanes a column group, cp.async staging;
   rglru_scan: clusters of 2 blocks of 4 warps along T, staged), and
   prints decode's split count.  Both attention kernels also at arctic-
   480b's group of 7 (H=56, K=8, hd=128; the same shapes otherwise), in
   rows of their own.  Beside the recurrence kernels, the plain path's
   forms (not kernels; what training and the dry-run run) against the
   same sequential oracles on the same f32 inputs, with their times:
   ``wkv_chunked`` at [4, 256, 32, 64] and ``associative_scan`` on RG-
   LRU's combine at [4, 256, 2560] (``plain_form:`` lines).  yi-9b's
   flash also at phase 11's eval shape [4, 32, 1024, 128], a row of its
   own whose launches are the eval step's.  deepseek-moe-16b's MHA (H=K=16,
   group 1) at its benchmark cell's shapes: decode over a 4096-slot ring
   filled with a 1024-token prompt and its steps, flash at [B, 16, 1024,
   128], at B 1 and 8, rows of their own (``deepseek_attention_rows``;
   launches from phase 9's run).
4. Paths: gemma2-9b (42 layers), yi-9b (48), rwkv6-1.6b (24) and
   recurrentgemma-2b (26) at full width and depth in bf16 with
   ``use_kernels=True``, random
   weights from a seeded generator, each a prefill + 8 decode
   ``ModelOp`` cascade through ``Dataflow`` -> ``compile_flow`` ->
   ``Runtime`` on the card, answering 4 prompts of 256 tokens (cache
   1024) three times, with every launch counter set to 0 just before and
   read just after.  Checks: each kernel's launches against the chain's
   dispatch counters (and 0 for the kernels off the path), zero
   re-traces on the repeat calls, fused tokens equal to the unfused loop,
   and, on the same params at full depth, the kernel path against the
   plain path: the kernels launched as the path needs them (none on the
   plain side), the recurrent state leaves of the prefill caches compared
   in f32, and the logits (prefill and first decode) within rel 0.05;
   rwkv6 amplifies last-bit differences with depth, so its full-depth
   gap is held to twice the plain path's own gap under a last-bit change
   of its f32 weights, and the 0.05 bar to 4 layers (see ``PATHS``);
   recurrentgemma's decay is about 0 under the reference's init, so it
   is held to the bar again with ``lam`` negated (see ``_negate_lam``).
   Then float32 at reduced depth (gemma2-9b, yi-9b and rwkv6 4 layers,
   recurrentgemma 6): the kernel path's greedy tokens equal the plain
   path's.  gemma2-9b's flash launches with a window are counted apart
   (its local layers) for the two gemma2 flash rows.  gemma2-9b adds
   (``phase_gemma2``): one 8192-token prompt (cache 8200, 8 decode steps)
   through the cascade, its time printed, its token held to the unfused
   loop and its logits to the plain path's within rel 0.05, and the
   flash time of one such prefill under ``torch.profiler``;
   the reference's ring defect printed (4160 tokens) beside an aligned
   control (4096); and ``kv_quant=True`` through the 4 x 256 cascade.
5. Serving: the serving runtime (request batching, admission and
   deadlines, fault tolerance, tracing) answering concurrent requests of
   phase 4's bf16 48-layer yi-9b model and params (prompts of 256
   tokens, cache 1024, 8 decode steps) on ``Runtime(n_gpu=2,
   max_batch=8, batch_wait_ms=50)`` with every trace kept, in five parts
   (see ``phase_serving``): 16 requests at once with ``batching=True``
   (tokens held to the unfused loop over each request's own batch,
   padded as the chain pads; kernel launches per batch, not per
   request) against the same 16 one request per dispatch, then both
   again on one GPU worker (measured beside the two); a
   ``[prefill, decode]`` batched chain whose DeviceTable is demuxed on
   the card for 7 pinned decode steps per request; a rate-limited gate
   shedding typed ``Overloaded`` and a deadline expiring typed in a
   queue without launching; a crash and a transient fault recovered; and
   every request's trace, its attribution and a Perfetto export under
   ``build/``.  The detector's ``hang_timeout_s`` is set above phase 4's
   measured first call, and no run that injects no hang shows a wedge.
6. Compile: the compile-time half of the system on phase 4's bf16
   48-layer yi-9b model and params (see ``phase_compile``).  The static
   verifier passes the cascade (``compile_flow(fusion=True, verify=True)``
   with a sample request) with zero errors, its launch-rule check (CF103)
   having checked both attention kernels at yi-9b's shapes, while the
   card's allocated bytes and every launch counter stay where they were;
   the CF301 footprint of the largest bucket is printed beside the growth
   of the peak allocation over the first warm at that bucket, and a
   budget below the footprint is refused (CF301) before anything runs.
   A flash step whose head_dim breaks the CUDA rule is refused by CF103
   and, compiled unverified, raises ``KernelError`` on the card; one that
   keeps the rule passes and launches.  Competitive execution: the
   cascade as two replicas on two GPU workers under a hang fault (8
   requests, one at a time) against the same 8 without replicas, tokens
   equal to the unfused loop, no wedge, p50/p99 of both and the races
   each replica won.  Locality: the recommender with ``fusion=
   locality=True`` answers as numpy does and runs every lookup on an
   executor caching its key; medians of it and the naive flow.  Then
   ``python -m repro_torch.check src/repro_torch/examples`` exits 0.
7. Plan: the measure -> model -> plan -> replan loop on phase 4's bf16
   48-layer yi-9b model and params (see ``phase_plan``), on
   ``Runtime(n_gpu=1, max_batch=8, batch_wait_ms=50)``.  ``profile_plan``
   sweeps the compiled cascade at 1, 2, 4 and 8 rows (its bytes held to
   the shapes, its launches to its dispatches) and the stages' cost
   hooks seed the same sizes; ``propose`` plans at 0.5 req/s and at phase
   5's one-worker rate for an SLO of twice the 1-row steady latency, and
   each config compiles off the serving path with its buckets and
   lowering; the admission gate's estimator p99 is printed beside phase
   5's measured p99, and a burst above its capacity is shed typed with
   its reasons while the admitted requests' tokens hold; the SLO
   controller, ticked by hand after sparse traffic and a burst, hot-
   applies batcher knobs without building an executable; a blue/green
   replan to a new bucket set under one-row traffic drops nothing,
   passes its canary and builds nothing on the 8 requests after the swap
   (times, memory growth and p99 printed); a green with one weight
   changed fails its canary and leaves blue serving and the card's
   allocated bytes where they were; ``auto_deploy`` plans and serves the
   cascade from a 1-row sample.
8. Families (see ``phase_families``), after yi-9b's weights are
   released: full-width llama-3.2-vision-11b in bf16 through
   ``ServingEngine.generate`` with media (4 prompts x 256 tokens, 1601
   media tokens, 8 new; cross gates set to 0.5), kernel launches, the
   media's effect and the kernel path within rel 0.05 of the plain path;
   the paper's video pipeline on it (6 frames against the 1 s budget,
   one SLO-controller tick); f32 tokens at 5 layers; peak memory.
9. Families II (``FAMILIES2``): full-width arctic-480b (depth cut to 2
   layers) and llama4-maverick-400b-a17b (one block: a dense layer, then
   a MoE layer with its shared expert) through phase 4's checks
   (``phase_path``), the kernel-vs-plain logits held on the token rows
   whose routes the two paths share (``moe_kernel_vs_plain``); the
   served MoE layer against the masked combine on the card at the
   prefill's and a decode step's token counts, with times and the expert
   bytes each reads (``moe_layer_check``, bf16 and f32); the int8
   experts through the cascade (``phase_expert_quant``); f32 tokens at 1
   layer (arctic) and 2 (llama4).  whisper-medium at full depth (24 + 24
   layers): the cascade over zero frames launching no kernel,
   ``ServingEngine.generate`` with seeded frames, the frames' effect on
   the logits, the cross K/V passed on uncopied (``phase_frames``), f32
   tokens at full depth.  deepseek-moe-16b at full width and depth (28
   layers: a dense one, then 27 of 64 routed experts, top 6, and the
   shared experts) through the same checks, f32 tokens at 2 layers.
   On every MoE path the MoE kernels' launches are one each a MoE call
   and every call takes them (``expected_moe``, ``.fused`` == ``.calls``),
   ``gated_act`` counts the experts' activations, and one bf16 MoE call
   is exactly ``moe_call_launches`` launch calls (profiler).  Then, on
   full-width deepseek-moe-16b, a prefill of 1024 tokens and a decode
   step at B 1 and 8 with the MoE kernels and with the MoE eager
   (``_moe_step``: launch calls, host, device and event ms; a
   ``moe_step:`` JSON line), and its reference check
   (``phase_deepseek_reference``): 4 prompts of
   1024 tokens, a prefill and 16 greedy decode steps through a 4096-slot
   cache against the plain float32 reference at every served position,
   each over a tolerance only where a route lies within the bf16 rounding
   of the router's input, and the reference's float8 control over one at
   some position (a ``deepseek_reference:`` JSON line).
10. Entry points (see ``phase_entry``), after phase 7 on phase 4's
   yi-9b weights, everything at full width: ``serve_batched.run`` over
   ``launch.serve.build_flow`` (12 requests at once, ``max_batch=8``,
   ``batch_wait_ms=20``, 8 new tokens, cache 128; ``generate`` on two
   CPU executors calling the engine at once): req/s, p50/p99, batch
   sizes, each completion equal to ``ServingEngine.generate`` on its
   prompt, the launch counters exact; the quickstart ensemble (yi-9b,
   glm4-9b and gemma2-9b, the other two drawn from their seeds): two
   urls, each answer's label and confidence held to the plain path on
   the same weights, ms per request; the image cascade (yi-9b, then
   granite-34b at 48 of its 88 layers, width full): 6 images one a
   request (per-row path) and all in one request (one batched dispatch
   of the escalation chain, no per-row fallback), labels held to the
   plain path, escalations and the median ms; then the roofline of
   phase 4's steady yi-9b cascade (``roofline.flops.estimate`` over its
   calls: the lower bound and MFU beside the measured call, each share
   at most 1) and ``from_counted``'s FLOPs of one prefill beside
   ``estimate``'s.  Phase 3 has flash rows at the phase's shapes
   (glm4-9b [1, 32, 16, 128] K 2, granite-34b [8, 48, 16, 128] K 1);
   their launches are the ones the wrapper counted at those heads
   (``flash_attention.launches_by_heads``) in the quickstart's run and
   in the cascade's batched run.
11. Training (see ``phase_training``), after phase 9, with nothing of
   the earlier phases held: yi-9b at full width, 8 of its 48 layers,
   bf16, AdamW, ``SyntheticLM`` seed 0 at B 4 x S 1024, remat
   ``nothing``, 30 steps: every loss and grad norm finite, the last 5
   steps' mean loss below the first 5's, no kernel launched by a train
   step (the counters read before and after), s/step, tokens/s, peak
   allocated and the MFU (``estimate``'s ``model_flops`` over the step
   at the bf16 peak) printed as a ``training:`` JSON line; the eval step
   on a ``use_kernels=True`` model at the trained params launches flash
   once a layer and its loss is within rel 0.05 of the plain one; the
   state is saved under ``build/`` and restored into a fresh template,
   every leaf equal bit for bit, and one step from each copy gives the
   same loss within rel 1e-3.  Then the f32 loss and every gradient leaf
   of full-width yi-9b (2 layers, B 1 x S 256) on the card against the
   CPU from the same params (loss rel 1e-5, each leaf max |d| <= 1e-3 x
   max |cpu leaf|, TF32 off); the giant MoEs' optimizer path at yi-9b's
   width (Adafactor, 4 microbatches accumulated in bf16, global batch 8
   x 1024, 10 steps; the first step's loss within rel 1e-2 of a one-
   microbatch step on the same params and batch); whisper-medium at full
   depth (zero frames, B 4 x S 256, 10 steps); and the entry points
   ``launch.train --arch yi-9b --tiny --steps 50`` (default device) and
   ``train_small`` with its defaults (its checkpoint under ``build/``).
   Then rwkv6-1.6b (24 layers) and recurrentgemma-2b (26; again with
   ``lam`` negated) at full width and depth, bf16, AdamW, B 4 x S 1024,
   10 steps on the plain path (``wkv_chunked``, ``associative_scan``),
   checked and reported as yi-9b's; the eval step with the kernels on
   the trained params launches ``wkv6`` 24 times and ``rglru_scan`` 18
   (once a recurrent layer) and gives the plain loss within rel 0.05;
   and each family's 2-layer f32 gradients on the card against the CPU
   under yi-9b's bounds (recurrentgemma with ``lam`` negated).
   Every time is printed beside the card's name and power limit.
   Phase 12 (``phase_mesh``) serves yi-9b and arctic-480b under a (1, 1)
   NCCL mesh while ``MESH_DRYRUNS`` trace in subprocesses (rwkv6-1.6b
   ``train_4k`` at 16x16 among them).
12. The last line: ``{"ok": true, "device": {...}}``; before it a
   ``kernels`` JSON line (with gemma2-9b's, arctic-480b's, glm4-9b's,
   granite-34b's and deepseek-moe-16b's attention rows), the ``glue`` and
   ``moe_kernels`` lines and the nvidia-smi line.  Each phase
   prints its seconds.

Exits non-zero with no result when CUDA is unavailable or the port's
package is missing.
"""
import dataclasses
import gc
import json
import contextlib
import math
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SEED = 0
BF16_REL, F32_REL = 0.05, 1e-4       # the reference's kernel bars
SPIN_CYCLES = 500_000                # ~0.3 ms at the H100's clocks
KERNELS = ("decode_attention", "flash_attention", "wkv6", "rglru_scan")
#: the decoder layer's fused glue (``kernels/glue.py``): their counters are
#: set to 0 with the kernels' and read where a path's glue is checked
GLUE = ("add_rmsnorm", "rope", "rope_cache_write", "gated_act")
#: the MoE layer's kernels (``kernels/moe.py``): their counters, and the
#: served MoE layer's own (``.calls``, ``.pairs``, ``.fused``), are set to
#: 0 with the kernels' and read where a MoE path is checked
MOE_KERNELS = ("moe_route", "moe_permute", "moe_combine")
#: phase 11's eval step: yi-9b's flash at [TRAIN_B, 32, TRAIN_S, 128]
TRAIN_EVAL_FLASH = "flash_attention[yi-9b train eval]"
#: the kernels JSON line's rows: each kernel at its served path's shapes,
#: and the attention kernels again at gemma2-9b's and arctic-480b's
#: deepseek-moe-16b at its benchmark cell's shapes: 1024-token prompts, 16
#: decode steps, a 4096-slot ring; decode at one row a dispatch (what the
#: cell's arrivals give) and at a full bucket of 8, each row's ring filled
#: with its prompt and the steps so far
DS_ARCH = "deepseek-moe-16b"
DS_SEQ, DS_STEPS, DS_CACHE = 1024, 16, 4096
DS_FILLED = (1040, 1025, 1032, 1036, 1028, 1039, 1026, 1033)
#: the MoE kernels' rows: a decode step at one row and at a full bucket
#: of 8, a 1024-token prefill and a bucket of 8 such prefills
DS_MOE_TOKENS = (1, 8, DS_SEQ, 8 * DS_SEQ)
#: the reference phase: prompts, the reference's blocks of prompts, and
#: the served tokens' gap limit (the benchmark cell's ``gap_limit``)
DS_PROMPTS, DS_BLOCK = 4, 2
DS_GAP_TOL = 0.34
KERNEL_ROWS = ("decode_attention", "flash_attention",
               "decode_attention[gemma2-9b]", "flash_attention[gemma2-9b]",
               "flash_attention[gemma2-9b global]", "wkv6", "rglru_scan",
               "decode_attention[arctic-480b]",
               "flash_attention[arctic-480b]", "flash_attention[glm4-9b]",
               "flash_attention[granite-34b]", TRAIN_EVAL_FLASH,
               f"decode_attention[{DS_ARCH}]", f"flash_attention[{DS_ARCH}]",
               f"decode_attention[{DS_ARCH} B 8]",
               f"flash_attention[{DS_ARCH} B 8]")
T_START = time.perf_counter()
#: per path: arch, depth of the f32 token check, depth at which the bf16
#: logits of the kernel path are held to the 0.05 bar (None: full).
#: Random-weight rwkv6 amplifies last-bit differences layer by layer (the
#: reference package's own model does too: tests/test_torch_recurrent.py,
#: ``test_rwkv6_depth_amplifies_a_last_bit_change``), so its bar applies
#: at 4 layers, and at full depth its gap is held to twice the plain
#: path's own gap when its f32 weights are scaled by 1 + 2^-20.
#: gemma2-9b runs first, before yi-9b's weights are kept for phases 5-7:
#: its 8192-token prompt needs the room (see ``phase_gemma2``).
PATHS = (("gemma2-9b", 4, None), ("yi-9b", 4, None), ("rwkv6-1.6b", 4, 4),
         ("recurrentgemma-2b", 6, None))
CONTROL_FACTOR = 2.0
STEPS, PROMPTS, SEQ, CACHE = 8, 4, 256, 1024
#: the wedge detector's limit for phase 4's runtimes: far above any call
#: seen there (yi-9b's first call, the slowest, took 1.3-1.9 s); phase 5
#: sets its own from phase 4's measured first call
PATH_HANG_TIMEOUT_S = 60.0
SERVE_REQUESTS, SERVE_BATCH, SERVE_WAIT_MS = 16, 8, 50.0
#: phase 6: requests of the competitive burst, replicas, the hang fault
COMPETE_REQUESTS, COMPETE_REPLICAS = 8, 2
HANG_RATE, HANG_S = 0.25, 2.0
#: phase 7: the profile's sweep, the sparse rate (req/s), the prompts
#: served one at a time, the blue/green proposal's buckets (a set no
#: proposal of the optimizer makes, so the swap always recompiles) and
#: how far the card's allocated bytes may stay above their value before
#: an aborted replan
PLAN_SWEEP = (1, 2, 4, 8)
PLAN_SPARSE_RATE = 0.5
PLAN_PROMPTS = 4
PLAN_GREEN_BUCKETS = (1, 4, 8)
PLAN_DRILL_SLACK = 64 << 20
#: phase 7: the SLO controller's rate window, in 1-row latencies (three
#: requests one at a time must fall inside it), and the admission gate's
#: rate window (s), long enough that a burst's rate climbs one request
#: at a time through the estimator's feasible range
PLAN_RATE_WINDOWS = 4.0
PLAN_GATE_WINDOW_S = 10.0
#: phase 10: the entry points' prompt length (the launcher's tokenizer,
#: the quickstart's and the cascade's inputs are 16 tokens); the serving
#: burst (requests, new tokens, and the engine cache ``launch.serve``
#: builds with); the cascade's images and
#: granite-34b's depth (48 of 88 layers: 37 GB beside yi-9b's 17.1 GB);
#: the flash rows at the phase's shapes: (arch, batch), glm4-9b one url a
#: request in the quickstart, granite-34b the cascade's 6 images padded
#: to a bucket of 8
ENTRY_SEQ = 16
ENTRY_REQUESTS, ENTRY_NEW, ENTRY_CACHE = 12, 8, 128
CASCADE_IMAGES, GRANITE_LAYERS = 6, 48
ENTRY_FLASH = (("glm4-9b", 1), ("granite-34b", 8))


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)
    print(f"  ok: {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def time_ms(torch, fn, iters=30, warmup=3, flush=None, spin=False):
    """Mean time of ``fn`` in ms over ``iters`` launches, each timed with
    CUDA events after ``flush`` evicted the L2 cache (the main path meets
    every layer's cache and weights cold).  The events bracket what the
    card sees of one call: its kernels, and any gap while the host is
    still enqueueing them (the kernel table's ``ms`` since it began).
    With ``spin`` the device first spins for ``SPIN_CYCLES``, so the host
    has enqueued all of ``fn``'s kernels when the start event fires: the
    events then bracket the device's work only (``device_ms``)."""
    for _ in range(warmup):
        fn()
    total = 0.0
    events = []
    for _ in range(iters):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    for start, end in events:
        total += start.elapsed_time(end)
    return total / iters


def spans(torch, fn, lib, flush, iters=30):
    """``fn``'s and the library call ``lib``'s times under both spans of
    :func:`time_ms` and their host time per call (:func:`host_ms`);
    ``lib`` None (no PyTorch call computes the function) times none."""
    out = {"ms": time_ms(torch, fn, iters=iters, flush=flush),
           "device_ms": time_ms(torch, fn, iters=iters, flush=flush,
                                spin=True),
           "library_ms": None, "host": (host_ms(torch, fn, iters), None)}
    if lib is not None:
        out.update(library_ms=time_ms(torch, lib, iters=iters, flush=flush),
                   library_device_ms=time_ms(torch, lib, iters=iters,
                                             flush=flush, spin=True),
                   host=(out["host"][0], host_ms(torch, lib, iters)))
    return out


def host_ms(torch, fn, iters=30):
    """Mean host time of one call of ``fn`` in ms: what it costs the
    host to check the inputs and enqueue the work, with the device left
    to catch up after the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def _attention_rows(torch, dev, g, flush, suffix, H, K,
                    filled=(1024, 700, 300, 5), W=1024, S=256):
    """Decode attention over a ``W``-slot ring with -1 slots (row b holds
    positions 0 .. ``filled[b]`` - 1, its query the last) and flash
    attention at [B, H, S, 128] (B = len(filled), K kv heads, causal)
    against their plain versions in f32 and bf16; the bf16 runs are timed
    and give the rows ``decode_attention<suffix>`` and
    ``flash_attention<suffix>``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import decode_attention_plain

    B, hd = len(filled), 128
    results = {}
    where = f"B {B}, H {H}, K {K} (group {H // K})"

    # -- decode attention over a [B, W, K, hd] ring cache ------------------
    kpos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    for b, n in enumerate(filled):
        kpos[b, :n] = torch.arange(n, dtype=torch.int32, device=dev)
    qpos = torch.tensor([n - 1 for n in filled], dtype=torch.int32,
                        device=dev)
    for dtype, bar in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
        kc = torch.randn((B, W, K, hd), generator=g, device=dev).to(
            dtype).transpose(1, 2)
        vc = torch.randn((B, W, K, hd), generator=g, device=dev).to(
            dtype).transpose(1, 2)
        got = kops.decode_attention(q, kc, vc, kpos, qpos)
        want = decode_attention_plain(q, kc, vc, kpos, qpos)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and err < bar,
              f"decode_attention {dtype} at {where}: rel err {err} < {bar} "
              f"(max abs {abs_err})")
        splits = kops.decode_attention.last_splits
        print(f"  decode_attention {dtype} at {where}: {splits} splits of "
              f"the {W}-slot ring per (b, kv head), {B * K * splits} "
              f"blocks", flush=True)
        if dtype != torch.bfloat16:
            continue
        valid = int(((kpos >= 0) & (kpos <= qpos[:, None])).sum())
        el = q.element_size()
        nbytes = (q.numel() * el * 2            # q read, out written
                  + 2 * valid * K * hd * el     # the K and V rows needed
                  + valid * 4 + B * 4)          # positions needed
        flops = 2 * 2 * valid * H * hd          # q.k and p.v per head
        qs = q[:, :, None]                                # [B,H,1,hd]
        mask = ((kpos >= 0) & (kpos <= qpos[:, None]))[:, None, None, :]
        results["decode_attention" + suffix] = {
            "name": "decode_attention" + suffix, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:88",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: decode_attention_plain(
                q, kc, vc, kpos, qpos), flush=flush),
            **_bound(nbytes, flops, "bfloat16"),
            **spans(torch, lambda: kops.decode_attention(
                q, kc, vc, kpos, qpos),
                lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=mask, enable_gqa=True), flush),
            "instance": f"split-S x{splits}",
        }

    results.update(_flash_rows(torch, dev, g, flush, suffix, B, H, K, S))
    return results


def _flash_rows(torch, dev, g, flush, suffix, B, H, K, S, hd=128):
    """Flash attention at [B, H, S, hd] (K kv heads, causal) against its
    plain version in f32 and bf16; the bf16 run is timed and gives the
    row ``flash_attention<suffix>``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    results = {}
    where = f"H {H}, K {K} (group {H // K})"
    for dtype, bar in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev).to(
            dtype).transpose(1, 2) for n in (H, K, K))   # model's views
        got = kops.flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and err < bar,
              f"flash_attention {dtype} at [{B}, {H}, {S}, {hd}], {where}: "
              f"rel err {err} < {bar} (max abs {abs_err})")
        instance = kops.flash_attention.last_instance
        want_instance = "wgmma" if dtype == torch.bfloat16 else "simt"
        check(instance == want_instance, f"flash_attention {dtype} at "
              f"[{B}, {H}, {S}, {hd}], {where}, ran the {instance} instance")
        if dtype != torch.bfloat16:
            continue
        el = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * el
        pairs = B * H * S * (S + 1) // 2        # causal (q, k) pairs
        flops = 2 * 2 * pairs * hd              # q.k and p.v
        results["flash_attention" + suffix] = {
            "name": "flash_attention" + suffix, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                q, k, v), flush=flush),
            **_bound(nbytes, flops, "bfloat16"),
            **spans(torch, lambda: kops.flash_attention(q, k, v),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), flush),
        }
        # the instance of the timed launches (the choice depends only on
        # dtype and head_dim, so the last one stands for all)
        results["flash_attention" + suffix]["instance"] = \
            kops.flash_attention.last_instance
    return results


def phase_kernels(torch, dev, flush):
    from repro_torch.configs import get_config

    g = torch.Generator(device=dev).manual_seed(SEED)
    # yi-9b's shapes (H 32, K 4: group 4) give the base rows
    results = _attention_rows(torch, dev, g, flush, "", 32, 4)
    results.update(phase_gemma2_kernels(torch, dev, g, flush))
    results.update(phase_recurrent_kernels(torch, dev, g, flush))
    # arctic-480b's (H 56, K 8: group 7, not a power of two), drawn from
    # a generator of their own so the rows above keep their inputs
    g7 = torch.Generator(device=dev).manual_seed(SEED + 7)
    results.update(_attention_rows(torch, dev, g7, flush, "[arctic-480b]",
                                   56, 8))
    # the entry points' prompts (phase 10): glm4-9b's and granite-34b's
    # flash at their batches, each from a generator of its own
    for arch, B in ENTRY_FLASH:
        cfg = get_config(arch)
        H, K = cfg.num_heads, cfg.num_kv_heads
        gi = torch.Generator(device=dev).manual_seed(SEED + H // K)
        row = _flash_rows(torch, dev, gi, flush, f"[{arch}]", B, H, K,
                          ENTRY_SEQ)[f"flash_attention[{arch}]"]
        row["shape"] = (f"{arch}: [{B}, {H}, {ENTRY_SEQ}, 128], K {K} "
                        f"(group {H // K}), causal")
        results[row["name"]] = row
    # yi-9b's flash at phase 11's eval shape (B 4 x S 1024)
    gt = torch.Generator(device=dev).manual_seed(SEED + TRAIN_S)
    row = _flash_rows(torch, dev, gt, flush, " train eval", TRAIN_B, 32, 4,
                      TRAIN_S)["flash_attention train eval"]
    row["name"] = TRAIN_EVAL_FLASH
    row["shape"] = f"yi-9b: [{TRAIN_B}, 32, {TRAIN_S}, 128], K 4, causal"
    results[TRAIN_EVAL_FLASH] = row
    results.update(deepseek_attention_rows(torch, dev, flush))
    for r in results.values():
        lib = r["library_ms"]
        lib_text = r.get("library_note") or (
            "none" if lib is None else f"{lib:.4f} ms")
        print(f"  {r['name']}"
              f"{' (' + r['instance'] + ')' if 'instance' in r else ''}: "
              f"kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib_text}, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
        if "sdpa_no_softcap_ms" in r:
            print(f"    SDPA on the same shapes WITHOUT the softcap (not the "
                  f"same function): {r['sdpa_no_softcap_ms']:.4f} ms, device"
                  f" work {r['sdpa_no_softcap_device_ms']:.4f} ms",
                  flush=True)
        if "sdpa_causal_no_softcap_ms" in r:
            print(f"    the same with is_causal=True instead of the mask: "
                  f"{r['sdpa_causal_no_softcap_ms']:.4f} ms, device work "
                  f"{r['sdpa_causal_no_softcap_device_ms']:.4f} ms",
                  flush=True)
        if "no_softcap_ms" in r:
            print(f"    the kernel WITHOUT the softcap (SDPA's function): "
                  f"{r['no_softcap_ms']:.4f} ms", flush=True)
        lib_dev, lib_host = "", ""
        if lib is not None:
            lib_dev = f", library {r['library_device_ms']:.4f} ms"
            lib_host = f", library {r['host'][1]:.4f} ms"
        print(f"    device work only: kernel {r['device_ms']:.4f} ms"
              f"{lib_dev}; host time per call: kernel {r['host'][0]:.4f} "
              f"ms{lib_host}", flush=True)
    return results


#: gemma2-9b's attention at full width: H 16, K 8, head_dim 256, softcap
#: 50, scale 1/16, window 4096 on the local layers; the prefill row is a
#: local layer of an 8192-token prompt, the decode row a 4096-slot ring
#: that has wrapped
G2_H, G2_K, G2_HD, G2_CAP, G2_WINDOW = 16, 8, 256, 50.0, 4096
G2_LONG = 8192
#: calls timed at gemma2's prefill shape of the plain version and SDPA
#: with a mask (tens of ms a call)
G2_PLAIN_ITERS = 5
G2_NOTE = "— (SDPA has no softcap)"


def gemma2_ring(torch, dev, B=4):
    """The decode row's ring: slot s holds position 4096 + s (a ring of
    4096 slots after 8192 tokens); the query positions make row 0 see
    every slot, row 1 lose slot 0 to the window, row 2 lose the slots
    past it to causality and row 3 lose half the ring to the window."""
    W = G2_WINDOW
    kpos = (W + torch.arange(W, dtype=torch.int32, device=dev)).expand(
        B, W).contiguous()
    qpos = torch.tensor([8191, 8192, 8000, 10000][:B], dtype=torch.int32,
                        device=dev)
    return kpos, qpos


def deepseek_attention_rows(torch, dev, flush):
    """Both attention kernels at deepseek-moe-16b's heads (H 16, K 16:
    MHA, group 1) and its cell's shapes: decode over a ``DS_CACHE``-slot
    ring filled as ``DS_FILLED`` says and flash at [B, 16, ``DS_SEQ``,
    128], at B 1 (rows ``<kernel>[deepseek-moe-16b]``) and B 8 (``... B
    8]``), from a generator of their own."""
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    rows = {}
    for suffix, filled in (("", DS_FILLED[:1]), (" B 8", DS_FILLED)):
        B = len(filled)
        got = _attention_rows(torch, dev, g, flush, f"[{DS_ARCH}{suffix}]",
                              16, 16, filled=filled, W=DS_CACHE, S=DS_SEQ)
        got[f"decode_attention[{DS_ARCH}{suffix}]"]["shape"] = (
            f"{DS_ARCH}: B {B}, H 16, K 16 (group 1), hd 128, {DS_CACHE} "
            f"slots, {min(filled)}-{max(filled)} filled")
        got[f"flash_attention[{DS_ARCH}{suffix}]"]["shape"] = (
            f"{DS_ARCH}: [{B}, 16, {DS_SEQ}, 128], K 16 (group 1), causal")
        rows.update(got)
    return rows


def phase_gemma2_kernels(torch, dev, g, flush):
    """Both attention kernels at gemma2-9b's shapes (see ``G2_*``) against
    their plain versions, in bf16 (the path's dtype): flash at a local
    and a global layer of the 8192-token prompt on the ping-pong instance
    (asserted); decode over the wrapped ring.  SDPA has no
    softcap, so the rows' ``library_ms`` is null; SDPA's time on the same
    shapes without the softcap (window and causality as a boolean mask)
    is recorded beside it under its own name, and at the global layer
    also with ``is_causal=True``, which may take its flash backend; the
    flash rows also time the kernel without the softcap
    (``no_softcap_ms``), SDPA's function."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    H, K, hd, W = G2_H, G2_K, G2_HD, G2_WINDOW
    scale = 1.0 / 16
    kw = dict(window=W, softcap=G2_CAP, scale=scale)
    dt = torch.bfloat16
    results = {}

    # -- decode over the wrapped ring --------------------------------------
    B = 4
    kpos, qpos = gemma2_ring(torch, dev, B)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
    kc = torch.randn((B, W, K, hd), generator=g, device=dev).to(
        dt).transpose(1, 2)
    vc = torch.randn((B, W, K, hd), generator=g, device=dev).to(
        dt).transpose(1, 2)
    got = kops.decode_attention(q, kc, vc, kpos, qpos, **kw)
    want = decode_attention_plain(q, kc, vc, kpos, qpos, **kw)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()) and err < BF16_REL,
          f"decode_attention at gemma2-9b's shape (hd {hd}, window {W}, "
          f"softcap {G2_CAP}, wrapped {W}-slot ring): rel err {err} < "
          f"{BF16_REL} (max abs {abs_err})")
    splits = kops.decode_attention.last_splits
    valid = ((kpos >= 0) & (kpos <= qpos[:, None])
             & (qpos[:, None] - kpos < W))
    n_valid = int(valid.sum())
    el = q.element_size()
    nbytes = (q.numel() * el * 2 + 2 * n_valid * K * hd * el
              + n_valid * 4 + B * 4)
    mask = valid[:, None, None, :]
    results["decode_attention[gemma2-9b]"] = {
        "name": "decode_attention[gemma2-9b]", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:88",
        "shape": f"gemma2-9b: B {B}, H {H}, K {K}, hd {hd}, {W}-slot ring "
                 f"wrapped, {n_valid} valid slots, window {W}, softcap "
                 f"{G2_CAP}",
        "max_abs_err": abs_err,
        "plain_ms": time_ms(torch, lambda: decode_attention_plain(
            q, kc, vc, kpos, qpos, **kw), flush=flush),
        **_bound(nbytes, 2 * 2 * n_valid * H * hd, "bfloat16"),
        **spans(torch, lambda: kops.decode_attention(
            q, kc, vc, kpos, qpos, **kw), None, flush),
        "library_note": G2_NOTE,
        "sdpa_no_softcap_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask, scale=scale,
            enable_gqa=True), flush=flush),
        "sdpa_no_softcap_device_ms": time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, scale=scale,
                enable_gqa=True), flush=flush, spin=True),
        "instance": f"split-S x{splits}",
    }
    del q, kc, vc

    # -- flash, a local and a global layer of the 8192-token prompt --------
    B, S = 1, G2_LONG
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev).to(
        dt).transpose(1, 2) for n in (H, K, K))          # model's views
    qp = torch.arange(S, device=dev)[:, None]
    kp = torch.arange(S, device=dev)[None, :]
    el = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * el
    for name, window in (("flash_attention[gemma2-9b]", W),
                         ("flash_attention[gemma2-9b global]", 0)):
        fkw = dict(causal=True, window=window, softcap=G2_CAP, scale=scale)
        got = kops.flash_attention(q, k, v, **fkw)
        want = flash_attention_plain(q, k, v, **fkw)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got.float() - want.float()).abs().max())
        finite = bool(torch.isfinite(got).all())
        del got, want
        where = (f"gemma2-9b's {'local' if window else 'global'} prefill "
                 f"shape ([{B}, {H}, {S}, {hd}], K {K}, window {window}, "
                 f"softcap {G2_CAP})")
        check(finite and err < BF16_REL,
              f"flash_attention at {where}: rel err {err} < {BF16_REL} "
              f"(max abs {abs_err})")
        instance = kops.flash_attention.last_instance
        check(instance == "pingpong", f"flash_attention at {where} ran the "
              f"{instance} instance")
        # causal (q, k) pairs, in the window when there is one
        pairs = B * H * sum(min(i + 1, window or S) for i in range(S))
        mask = (kp <= qp) & (qp - kp < (window or S))

        def masked():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)

        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "shape": f"gemma2-9b: [{B}, {H}, {S}, {hd}], K {K}, causal, "
                     f"window {window}, softcap {G2_CAP}, scale 1/16",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                q, k, v, **fkw), iters=G2_PLAIN_ITERS, warmup=1,
                flush=flush),
            **_bound(nbytes, 2 * 2 * pairs * hd, "bfloat16"),
            **spans(torch, lambda: kops.flash_attention(q, k, v, **fkw),
                    None, flush),
            "library_note": G2_NOTE,
            "sdpa_no_softcap_ms": time_ms(torch, masked, iters=G2_PLAIN_ITERS,
                                          flush=flush),
            "sdpa_no_softcap_device_ms": time_ms(
                torch, masked, iters=G2_PLAIN_ITERS, flush=flush, spin=True),
            "instance": instance,
        }
        if not window:
            def causal():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=scale, enable_gqa=True)

            row["sdpa_causal_no_softcap_ms"] = time_ms(torch, causal,
                                                       flush=flush)
            row["sdpa_causal_no_softcap_device_ms"] = time_ms(
                torch, causal, flush=flush, spin=True)
        # the kernel on SDPA's function (no softcap), beside SDPA's times
        row["no_softcap_ms"] = time_ms(torch, lambda: kops.flash_attention(
            q, k, v, causal=True, window=window, scale=scale), flush=flush)
        results[name] = row
    return results


def _bound(nbytes, flops, peak):
    """The least time of the work on the card (ms) and what bounds it: its
    bytes over HBM bandwidth or its operations over the peak of their type
    (the H100's data-sheet constants of ``repro_torch.roofline.hw``, the
    same ones the roofline line reads)."""
    from repro_torch.roofline import hw

    peaks = {"bfloat16": hw.PEAK_FLOPS_BF16, "float32": hw.PEAK_FLOPS_F32}
    bound_bytes = nbytes / hw.HBM_BW * 1e3
    bound_ops = flops / peaks[peak] * 1e3
    return {"bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations"}


def phase_recurrent_kernels(torch, dev, g, flush):
    """wkv6 (rwkv6-1.6b prefill) and rglru_scan (recurrentgemma-2b
    prefill) against their plain versions.  No single PyTorch call
    computes either recurrence, so ``library_ms`` is null."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.rglru_scan import rglru_scan_plain
    from repro_torch.kernels.wkv6 import wkv6_plain
    from repro_torch.models import rglru
    from repro_torch.models.rwkv6 import wkv_chunked
    from repro_torch.models.scan import associative_scan

    results = {}
    # -- wkv6 at r/k/v/w [B, T, H, hd], f32 u, with the final state ----------
    B, T, H, hd = PROMPTS, SEQ, 32, 64
    u = torch.rand((H, hd), generator=g, device=dev) - 0.5
    for dtype, bar in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        r, k, v = (0.3 * torch.randn((B, T, H, hd), generator=g,
                                     device=dev) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((B, T, H, hd), generator=g,
                                             device=dev) - 0.5))
        r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
        y, S = kops.wkv6(r, k, v, w, u, return_state=True)
        want_y, want_S = wkv6_plain(r, k, v, w, u, return_state=True)
        torch.cuda.synchronize()
        err = max(rel_err(y, want_y), rel_err(S, want_S))
        abs_err = float(max((y - want_y).abs().max(),
                            (S - want_S).abs().max()))
        check(bool(torch.isfinite(y).all() and torch.isfinite(S).all())
              and err < bar,
              f"wkv6 {dtype}: rel err {err} < {bar} (max abs {abs_err})")
        if dtype != torch.float32:     # the path feeds it f32
            continue
        instance = kops.wkv6.last_instance
        check(instance == "16 lanes of 4 rows x 4 columns, cp.async "
              "staging",
              f"wkv6 at rwkv6-1.6b's prefill shape ran {instance!r}")
        el = r.element_size()
        nbytes = (4 * r.numel() * el + u.numel() * 4     # r, k, v, w, u
                  + y.numel() * 4 + S.numel() * 4)       # y, final S
        # per (i, j) and step: r.S (FMA, 2), k*v (1), w*S + kv (FMA, 2);
        # q = r*u*k and its sum are per i (3 hd), v*sum(q) per j (2 hd)
        flops = B * T * H * (5 * hd * hd + 5 * hd)
        results["wkv6"] = {
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:59",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: wkv6_plain(
                r, k, v, w, u, return_state=True), iters=3, flush=flush),
            **_bound(nbytes, flops, "float32"),
            **spans(torch, lambda: kops.wkv6(
                r, k, v, w, u, return_state=True), None, flush),
            "instance": instance,
        }
        _plain_form_row(torch, "wkv_chunked", lambda: wkv_chunked(
            r, k, v, w, u), (want_y, want_S), results["wkv6"]["plain_ms"],
            (B, T, H, hd), flush)

    # -- rglru_scan at a, x [B, T, R], zero initial state ------------------
    R = 2560
    for dtype, bar in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        a = torch.sigmoid(torch.randn((B, T, R), generator=g, device=dev)
                          + 3.0).to(dtype)
        x = (0.3 * torch.randn((B, T, R), generator=g, device=dev)).to(dtype)
        got = kops.rglru_scan(a, x)
        want = rglru_scan_plain(a, x)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err < bar,
              f"rglru_scan {dtype}: rel err {err} < {bar} "
              f"(max abs {abs_err})")
        if dtype != torch.float32:     # the path feeds it f32
            continue
        instance = kops.rglru_scan.last_instance
        check(instance == "cluster 2 x 4 warps, staged",
              f"rglru_scan at recurrentgemma-2b's prefill shape ran "
              f"{instance!r}")
        nbytes = 2 * a.numel() * a.element_size() + got.numel() * 4
        flops = 2 * a.numel()
        results["rglru_scan"] = {
            "name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:51",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: rglru_scan_plain(a, x),
                                iters=5, flush=flush),
            **_bound(nbytes, flops, "float32"),
            **spans(torch, lambda: kops.rglru_scan(a, x), None, flush),
            "instance": instance,
        }
        _plain_form_row(torch, "associative_scan", lambda: associative_scan(
            rglru._combine, (a, x), dim=1)[1], (want,),
            results["rglru_scan"]["plain_ms"], (B, T, R), flush)
    return results


def _plain_form_row(torch, name, fn, want, sequential_ms, shape, flush):
    """The plain path's form of a recurrence (what training, the dry-run
    and the CPU run; not a kernel) against the sequential oracle its
    kernel is held to, on the same f32 inputs: max abs error, held to the
    f32 bar, and its time beside the oracle's.  For the record only: no
    yardstick for the kernels."""
    got = fn()
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    err = max(rel_err(g, w) for g, w in zip(got, want))
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(bool(torch.isfinite(g).all()) for g in got) and err < F32_REL,
          f"{name} (plain path) at {list(shape)} f32 against the "
          f"sequential oracle: rel err {err} < {F32_REL} (max abs "
          f"{abs_err})")
    ms = time_ms(torch, fn, iters=5, flush=flush)
    print(f"  {name} (the plain path's form, not a kernel) at "
          f"{list(shape)} f32: max abs err {abs_err} against the "
          f"sequential oracle, {ms:.4f} ms beside the oracle's "
          f"{sequential_ms:.4f} ms", flush=True)
    print("plain_form: " + json.dumps({
        "name": name, "shape": list(shape), "max_abs_err": abs_err,
        "rel_err": err, "ms": ms, "sequential_ms": sequential_ms}),
        flush=True)


# -- phase 3, the decoder layer's fused glue (kernels/glue.py) ---------------

#: yi-9b's serving shapes for the glue rows: decode at these batches (one
#: token a row, a 1024-slot ring), prefill at these [B, S]
GLUE_DECODE_B = (1, 8)
GLUE_PREFILL = ((1, 256), (8, 256))
GLUE_ROPE_BAR = 1e-2         # max abs error of the rotated q and k (bf16)
#: decode steps timed for the step line, after as many warm ones
GLUE_STEPS = 20


def _bf16_ulps(torch, got, want):
    """The largest distance between two bf16 tensors in steps of the last
    bit (0 and -0 alike; a sign change counts the steps through 0)."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(got) - key(want)).abs().max())


def _glue_row(torch, flush, name, shape, fn, plain, nbytes, err,
              flops=0, replaces="no TPU kernel (XLA fuses this glue in the "
                                "reference)"):
    """A glue kernel's row: its error against the plain version, both
    timings of :func:`spans`, the plain version's (the eager composition
    it replaces, on the card: event time and host enqueue time) and the
    least time by bytes (or by ``flops`` on the float32 units)."""
    row = {"name": name, "route": "cuda", "shape": shape,
           "source": f"src/repro_torch/csrc/{name.split('[')[0]}.cu",
           "replaces": replaces,
           **err, **_bound(nbytes, flops, "float32"),
           **spans(torch, fn, None, flush),
           "plain_ms": time_ms(torch, plain, flush=flush),
           "plain_device_ms": time_ms(torch, plain, flush=flush, spin=True),
           "plain_host_ms": host_ms(torch, plain)}
    print(f"  {name} at {shape}: {err}; device {row['device_ms']:.4f} ms "
          f"(bound {row['bound_ms']:.5f} ms by {row['bound_by']}), events "
          f"{row['ms']:.4f} ms, host {row['host'][0]:.4f} ms a call; plain "
          f"device {row['plain_device_ms']:.4f} ms, events "
          f"{row['plain_ms']:.4f} ms, host {row['plain_host_ms']:.4f} ms",
          flush=True)
    return row


def phase_glue_kernels(torch, dev, flush, arch="yi-9b", widths=None,
                       decode_b=GLUE_DECODE_B, prefill=GLUE_PREFILL,
                       W=CACHE):
    """The four fused glue kernels against their plain versions (the
    eager composition they replace) at ``arch``'s serving shapes (decode
    at ``decode_b`` rows over a ``W``-slot ring, prefill at each [B, S] of
    ``prefill``; ``gated_act`` at each of ``widths``, the MLP's d_ff when
    None): in f32 (rel err < the f32 bar) and, timed, in bf16:
    ``add_rmsnorm`` and ``gated_act`` within one bf16 step of the plain
    output, the rotated q and k within GLUE_ROPE_BAR, the ring written
    where the plain write writes and nowhere else.  Returns the bf16 rows
    by name: ``<kernel>[<where>]`` at yi-9b's shapes,
    ``<kernel>[<arch> <where>]`` at another's, ``gated_act`` with ``F <width>``
    before ``<where>`` where there are two widths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import glue
    from repro_torch.models import transformer

    cfg = get_config(arch)
    D, H, K, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim)
    widths = widths or (cfg.d_ff,)
    tag = "" if arch == "yi-9b" else f"{arch} "
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    freqs = transformer.rope_table(hd, cfg.rope_theta, dev)
    rows = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def abs_err(got, want):
        return float((got.float() - want.float()).abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.empty((), dtype=dtype).element_size()
        f32 = dtype == torch.float32
        sizes = [(f"decode B {B}", (B, 1)) for B in decode_b] + [
            (f"prefill [{B}, {S}]", (B, S)) for B, S in prefill]
        for where, (B, S) in sizes:
            T = B * S
            # -- add_rmsnorm: the residual add and the norm after it
            x, d = randn((B, S, D), dtype), randn((B, S, D), dtype)
            scale = randn((D,), dtype) * 0.1
            got = glue.add_rmsnorm(x, d, scale)
            want = glue.add_rmsnorm_plain(x, d, scale)
            bare = glue.add_rmsnorm(x, None, scale)[1]
            bare_want = glue.add_rmsnorm_plain(x, None, scale)[1]
            torch.cuda.synchronize()
            if f32:
                err = max(rel_err(a, b) for a, b in
                          zip((*got, bare), (*want, bare_want)))
                check(err < F32_REL, f"add_rmsnorm f32 at {where}: rel err "
                      f"{err} < {F32_REL}")
            else:
                ulps = [_bf16_ulps(torch, a, b) for a, b in
                        zip((*got, bare), (*want, bare_want))]
                check(max(ulps) <= 1, f"add_rmsnorm bf16 at {where}: x' "
                      f"{ulps[0]}, h {ulps[1]}, h without delta {ulps[2]} "
                      "bf16 steps from the plain version (<= 1)")
                name = f"add_rmsnorm[{tag}{where}]"
                rows[name] = _glue_row(
                    torch, flush, name, f"[{B}, {S}, {D}] with delta",
                    lambda: glue.add_rmsnorm(x, d, scale),
                    lambda: glue.add_rmsnorm_plain(x, d, scale),
                    (4 * T * D + D) * el,
                    {"max_abs_err": abs_err(got[1], want[1]),
                     "max_ulps": max(ulps[:2])})
            # -- gated_act: act(gate) * up at the MLP's widths
            for F in widths:
                _gated_act_row(torch, flush, rows, dtype, where, (B, S, F),
                               randn, abs_err, tag + (
                                   f"F {F} " if len(widths) > 1 else ""))
            if S > 1:
                # -- rope: the prefill's q and k at positions 0..S-1
                q = randn((B, S, H * hd), dtype).view(B, S, H, hd)
                k = randn((B, S, K * hd), dtype).view(B, S, K, hd)
                positions = torch.arange(S, dtype=torch.int32, device=dev)
                got = glue.rope(q, k, positions, freqs)
                want = glue.rope_plain(q, k, positions, freqs)
                torch.cuda.synchronize()
                err = max(abs_err(a, b) for a, b in zip(got, want))
                bar = F32_REL if f32 else GLUE_ROPE_BAR
                check(err <= bar, f"rope {dtype} at {where}: max abs err "
                      f"{err} <= {bar}")
                if not f32:
                    name = f"rope[{tag}{where}]"
                    rows[name] = _glue_row(
                        torch, flush, name, f"q [{B}, {S}, {H}, {hd}], "
                        f"k [{B}, {S}, {K}, {hd}]",
                        lambda: glue.rope(q, k, positions, freqs),
                        lambda: glue.rope_plain(q, k, positions, freqs),
                        2 * (q.numel() + k.numel()) * el + S * 4 + hd * 2,
                        {"max_abs_err": err})
                continue
            # -- rope_cache_write: a decode step into a ring that has
            # wrapped in row 0 (pos >= W) and not in the others
            q = randn((B, 1, H * hd), dtype).view(B, 1, H, hd)
            k = randn((B, 1, K * hd), dtype).view(B, 1, K, hd)
            v = randn((B, 1, K * hd), dtype).view(B, 1, K, hd)
            pos = torch.tensor([W + 37] + [300 + 61 * b for b in
                                           range(1, B)],
                               dtype=torch.int32, device=dev)
            ring = [randn((B, W, K, hd), dtype) for _ in range(2)] + [
                torch.randint(-1, W, (B, W), generator=g, device=dev,
                              dtype=torch.int32)]
            mine = [t.clone() for t in ring]
            theirs = [t.clone() for t in ring]
            got = glue.rope_cache_write(q, k, v, pos, *mine, freqs)
            want = glue.rope_cache_write_plain(q, k, v, pos, *theirs, freqs)
            torch.cuda.synchronize()
            err = max(abs_err(a, b) for a, b in
                      zip((got, mine[0], mine[1]),
                          (want, theirs[0], theirs[1])))
            same_pos = bool(torch.equal(mine[2], theirs[2]))
            same_v = bool(torch.equal(mine[1], theirs[1]))
            bar = F32_REL if f32 else GLUE_ROPE_BAR
            check(err <= bar and same_pos and same_v,
                  f"rope_cache_write {dtype} at {where}: max abs err {err} "
                  f"<= {bar} (q and the ring), v and positions written "
                  "exactly")
            if not f32:
                name = f"rope_cache_write[{tag}{where}]"
                rows[name] = _glue_row(
                    torch, flush, name, f"q [{B}, 1, {H}, {hd}], ring "
                    f"[{B}, {W}, {K}, {hd}]",
                    lambda: glue.rope_cache_write(q, k, v, pos, *mine,
                                                  freqs),
                    lambda: glue.rope_cache_write_plain(q, k, v, pos,
                                                        *theirs, freqs),
                    (2 * q.numel() + 4 * k.numel()) * el + 8 * B + hd * 2,
                    {"max_abs_err": err})
    for row in rows.values():
        row["model"] = arch
    return rows


def _gated_act_row(torch, flush, rows, dtype, where, shape, randn, abs_err,
                   tag):
    """``gated_act`` at ``shape`` [B, S, F] against its plain version, silu
    and gelu: rel err in f32; in bf16 within one bf16 step, and the silu
    launch timed as the row ``gated_act[<tag><where>]``."""
    from repro_torch.kernels import glue

    B, S, F = shape
    gate, up = randn(shape, dtype), randn(shape, dtype)
    errs = {}
    for act in ("silu", "gelu"):
        got = glue.gated_act(gate, up, act)
        want = glue.gated_act_plain(gate, up, act)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            err = rel_err(got, want)
            check(err < F32_REL, f"gated_act {act} f32 at {where}, F {F}: "
                  f"rel err {err} < {F32_REL}")
            continue
        errs[act] = (abs_err(got, want), _bf16_ulps(torch, got, want))
        check(errs[act][1] <= 1, f"gated_act {act} bf16 at {where}, F {F}: "
              f"{errs[act][1]} bf16 steps from the plain version (<= 1)")
    if dtype == torch.float32:
        return
    name = f"gated_act[{tag}{where}]"
    rows[name] = _glue_row(
        torch, flush, name, f"[{B}, {S}, {F}] silu",
        lambda: glue.gated_act(gate, up, "silu"),
        lambda: glue.gated_act_plain(gate, up, "silu"),
        3 * B * S * F * gate.element_size(),
        {"max_abs_err": errs["silu"][0], "max_ulps": errs["silu"][1],
         "gelu_max_abs_err": errs["gelu"][0],
         "gelu_max_ulps": errs["gelu"][1]})


def _profile_call(torch, fn):
    """One ``fn()`` under ``torch.profiler``: its kernel launch calls on
    the host, as the benchmark counts them (``perfbench/lib/profile.py``:
    the ``cudaLaunchKernel`` and ``cuLaunchKernel`` families), and the
    device's busy ms (the kernels' and copies' own device time, summed)."""
    from torch.profiler import ProfilerActivity, profile

    calls = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
             "cuLaunchKernelEx")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events() if e.name in calls)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    return launches, busy_us / 1e3


def deepseek_glue_rows(torch, dev, flush):
    """The glue rows at deepseek-moe-16b's shapes (D 2048, 16 heads of
    128): decode at B 1 and 8 over a ``DS_CACHE``-slot ring, prefill at
    [1, ``DS_SEQ``] and [8, ``DS_SEQ``], ``gated_act`` at the dense
    layer's width (10944) and the shared experts' (2816)."""
    from repro_torch.configs import get_config

    cfg = get_config(DS_ARCH)
    return phase_glue_kernels(
        torch, dev, flush, DS_ARCH, widths=(cfg.d_ff, cfg.aux_ff),
        decode_b=(1, 8), prefill=((1, DS_SEQ), (8, DS_SEQ)), W=DS_CACHE)


def phase_glue(torch, dev, smi):
    """Phase 3's glue part: the rows of :func:`phase_glue_kernels` at
    yi-9b's and deepseek-moe-16b's shapes as the ``glue`` JSON line's
    object (each row's ``launches`` are filled in from its model's run in
    phase 4 or 9), then :func:`phase_glue_step`."""
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = phase_glue_kernels(torch, dev, flush=scratch.zero_)
    rows.update(deepseek_glue_rows(torch, dev, flush=scratch.zero_))
    del scratch
    _release(torch)
    phase_glue_step(torch, dev, smi)
    _release(torch)
    return {"glue": list(rows.values()), "device": smi}


def phase_moe_kernels(torch, dev, smi):
    """Phase 3's MoE part: ``moe_route``, ``moe_permute`` and
    ``moe_combine`` against their plain versions (the eager composition
    they replace) at deepseek-moe-16b's shapes (D 2048, E 64, top 6, not
    renormalised; T of ``DS_MOE_TOKENS``), in f32 and, timed, in bf16:
    the experts alike but where the float64 router scores the two
    choices within rel 1e-5 (a tie either f32 version may break); the
    weights as close to the float64 router's as the plain version's
    (within twice its gap, or 2e-6: its f32 product and softmax round
    too); the aux loss within rel ``MOE_AUX_REL``; on the kernel's own
    routes ``ends``, ``pos`` and the gathered rows equal, and the combine
    within one bf16 step (8 f32 steps) at each row's largest magnitude.
    Returns the ``moe_kernels`` JSON line's object (each row's
    ``launches`` filled in from phase 9's run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe as kmoe

    cfg = get_config(DS_ARCH)
    D, E, k = cfg.d_model, cfg.num_experts, cfg.num_experts_per_tok
    renorm = cfg.norm_topk_prob
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    router = torch.randn((D, E), generator=g, device=dev) / math.sqrt(D)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    replaces = ("no TPU kernel (the reference routes, sorts and combines "
                "with XLA ops)")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        el = torch.empty((), dtype=dtype).element_size()
        for T in DS_MOE_TOKENS:
            xf = torch.randn((T, D), generator=g, device=dev).to(dtype)
            r = kmoe.moe_route(xf, router, k, renorm)
            rp = kmoe.moe_route_plain(xf, router, k, renorm)
            # the placement and the combine on the kernel's own routes
            order, ends = kmoe.sort_pairs_plain(r.top_i, E)
            mine = r._replace(order=order, work=None)
            rows_k, pos = kmoe.moe_permute(xf, r)
            rows_p, pos_p = kmoe.moe_permute_plain(xf, mine)
            out_rows = torch.randn(rows_k.shape, generator=g,
                                   device=dev).to(dtype)
            y = kmoe.moe_combine(out_rows, r, pos)
            y_p = kmoe.moe_combine_plain(out_rows, mine, pos_p)
            torch.cuda.synchronize()
            # each version's weights against the float64 router's; where
            # the experts differ, how close the float64 router scores them
            probs = torch.softmax(xf.double() @ router.double(), dim=-1)

            def gap(top_w, top_i):
                exact = probs.gather(1, top_i)
                if renorm:
                    exact = exact / exact.sum(-1, keepdim=True)
                return float(((top_w.double() - exact).abs() / exact).max())

            w_err, w_err_plain = gap(r.top_w, r.top_i), gap(rp.top_w,
                                                             rp.top_i)
            differ = (r.top_i != rp.top_i).any(-1)
            pk = probs[differ].gather(1, r.top_i[differ])
            pp = probs[differ].gather(1, rp.top_i[differ])
            tie = float(((pk - pp).abs() / pp).max()) if differ.any() \
                else 0.0
            aux_err = rel_err(r.aux, rp.aux)
            check(tie <= 1e-5 and torch.equal(r.ends, ends)
                  and w_err <= max(2e-6, 2 * w_err_plain)
                  and aux_err <= MOE_AUX_REL,
                  f"moe_route {dtype} T {T}: {int(differ.sum())} tokens' "
                  f"experts differ from the plain version's, where the "
                  f"float64 router scores them within rel {tie} <= 1e-5; "
                  f"ends equal the kernel routes' counts; weights within "
                  f"rel {w_err} of the float64 router's <= 2e-6 or twice "
                  f"the plain version's {w_err_plain}; aux rel {aux_err} "
                  f"<= {MOE_AUX_REL}")
            check(torch.equal(pos, pos_p) and torch.equal(rows_k, rows_p),
                  f"moe_permute {dtype} T {T}: places and rows equal")
            steps = _row_steps(torch, y, y_p, dtype)
            check(steps <= (1 if dtype == torch.bfloat16 else 8),
                  f"moe_combine {dtype} T {T}: {steps} steps of the dtype "
                  f"at each row's largest magnitude from the plain version "
                  f"on the same gates (<= 1 in bf16, 8 in f32)")
            if dtype == torch.float32:
                continue
            c_err = {"max_steps": steps}
            where = f"{DS_ARCH} T {T}"
            rows[f"moe_route[{where}]"] = _glue_row(
                torch, flush, f"moe_route[{where}]", f"[{T}, {D}] x [{D}, "
                f"{E}], top {k}",
                lambda: kmoe.moe_route(xf, router, k, renorm),
                lambda: kmoe.moe_route_plain(xf, router, k, renorm),
                T * D * el + D * E * 4 + T * k * 12,
                {"weights_rel_err": w_err, "plain_weights_rel_err":
                 w_err_plain, "aux_rel_err": aux_err,
                 "tokens_at_ties": int(differ.sum())},
                flops=2 * T * D * E, replaces=replaces)
            rows[f"moe_permute[{where}]"] = _glue_row(
                torch, flush, f"moe_permute[{where}]", f"[{T}, {D}] to "
                f"[{T * k}, {D}]", lambda: kmoe.moe_permute(xf, r),
                lambda: kmoe.moe_permute_plain(xf, rp),
                (T + T * k) * D * el + T * k * 12, {"equal": True},
                replaces=replaces)
            rows[f"moe_combine[{where}]"] = _glue_row(
                torch, flush, f"moe_combine[{where}]", f"[{T * k}, {D}] to "
                f"[{T}, {D}]", lambda: kmoe.moe_combine(out_rows, r, pos),
                lambda: kmoe.moe_combine_plain(out_rows, mine, pos_p),
                (T * k + T) * D * el + T * k * 8, c_err, replaces=replaces)
            for row in list(rows.values())[-3:]:
                row["model"] = DS_ARCH
    del scratch
    _release(torch)
    return {"moe_kernels": list(rows.values()), "device": smi}


def _row_steps(torch, got, want, dtype):
    """The largest gap between two [T, D] tensors in steps of ``dtype``
    (its last place), each row's step taken at its largest |want|: a sum
    of k terms taken in another f32 order moves a small element by as
    much as a large one."""
    scale = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    bits = 7 if dtype == torch.bfloat16 else 23
    step = torch.exp2(torch.floor(torch.log2(scale)) - bits)
    return float(((got.float() - want.float()).abs() / step).max())


@contextlib.contextmanager
def _plain(fields):
    """Within the block every layer's record (``layer_ops.layer_ops``)
    gives ``fields`` their plain versions, the rest as served: the glue
    (``layer_ops.GLUE``) or the MoE (``layer_ops.MOE``) eager beside the
    other kernels.  With no fields nothing is replaced."""
    from repro_torch.models import layer_ops

    choose = layer_ops.layer_ops
    if fields:
        layer_ops.layer_ops = layer_ops.with_plain(fields)
    try:
        yield
    finally:
        layer_ops.layer_ops = choose


def phase_glue_step(torch, dev, smi):
    """Full-width bf16 yi-9b: one prefill of [1, SEQ] tokens and a decode
    step at B 1 and B 8, each with the layers' glue fused (the path) and
    with it eager (:func:`_plain` of the glue's fields, everything else
    alike): launch calls and the device's busy ms per call
    (profiler), the host's enqueue ms and the event ms per call, and the
    logits of the two against each other."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, layer_ops

    cfg = dataclasses.replace(get_config("yi-9b"), use_kernels=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {}
    for B in (1, 8):
        toks = torch.randint(0, cfg.vocab_size, (B, SEQ), generator=g,
                             device=dev, dtype=torch.int32)
        logits, cache = model.prefill(params, {"tokens": toks}, CACHE)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((B,), SEQ, dtype=torch.int32, device=dev)
        calls = {"prefill": lambda: model.prefill(
                     params, {"tokens": toks}, CACHE),
                 "decode": lambda: model.decode_step(params, tok, pos,
                                                     cache)}
        for what, fn in calls.items():
            res = {}
            for mode in ("eager glue", "fused glue"):
                with _plain(layer_ops.GLUE if mode == "eager glue" else ()):
                    first = fn()
                    torch.cuda.synchronize()
                    launches, busy = _profile_call(torch, fn)
                    host = host_ms(torch, fn, iters=GLUE_STEPS)
                    ev_ms = time_ms(torch, fn, iters=GLUE_STEPS, warmup=1)
                res[mode] = {"launch_calls": launches, "host_ms": host,
                             "device_busy_ms": busy, "ms": ev_ms,
                             "logits": first[0][:, -1].float()}
            gap = rel_err(res["fused glue"]["logits"],
                          res["eager glue"]["logits"])
            check(gap < BF16_REL, f"yi-9b {what} B {B}: fused glue's "
                  f"logits within rel {BF16_REL} of the eager glue's "
                  f"({gap})")
            for mode, r in res.items():
                r.pop("logits")
                print(f"  yi-9b {what} B {B}, {mode}: {r['launch_calls']} "
                      f"launch calls, host {r['host_ms']:.3f} ms, device "
                      f"busy {r['device_busy_ms']:.3f} ms, events "
                      f"{r['ms']:.3f} ms", flush=True)
            out[f"{what} B {B}"] = {**res, "logit_rel_gap": gap}
    print("glue_step: " + json.dumps({"device": smi, "calls": out}),
          flush=True)
    del model, params, cache


def serve(torch, dev, cfg, calls=3, params=None, ax=None):
    """Compile the cascade for ``cfg`` on a card Runtime and answer the
    same ``PROMPTS`` x ``SEQ`` batch ``calls`` times, with every kernel's
    launch counter set to 0 just before; ``params`` (drawn from the seed
    when None) are the weights.  Returns (model, params, tokens,
    greedy tokens, per-call latencies, per-call re-traces, the chain's
    (batched, per-row) dispatches, launches).  Nothing returned holds the
    chain, whose steps close over the params.  With ``ax`` (a mesh's
    axes) the model is built under the mesh and ``params`` are DTensors
    placed on it; the stages place their inputs and unplace their
    outputs (``Model.placed``)."""
    from repro_torch.core.lowering import EXECUTABLE_CACHE
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.models import build_model

    prompts, seq, cache_len, steps = PROMPTS, SEQ, CACHE, STEPS
    model = build_model(cfg, device=dev, ax=ax)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    toks = torch.randint(0, cfg.vocab_size, (prompts, seq),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 1))
    table = Table([("tokens", torch.Tensor)],
                  [(toks[i],) for i in range(prompts)])
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    hang_timeout_s=PATH_HANG_TIMEOUT_S, device=dev)
    try:
        pre, dec = dc.build_ops(model, params, cache_len=cache_len,
                                name=cfg.name)
        dep = dc.build(rt, pre, dec, steps=steps, name=f"smoke-{cfg.name}")
        chain = dep.plan.ops[-1].op
        print(dep.explain(), flush=True)
        lats, retraces, out = [], [], None
        _zero_launches()
        for _ in range(calls):
            tr0 = EXECUTABLE_CACHE.traces()
            t0 = time.perf_counter()
            out = dep.execute(table).result(600)
            lats.append(time.perf_counter() - t0)
            retraces.append(EXECUTABLE_CACHE.traces() - tr0)
        launches = _launches()
        dispatches = (chain.batch_dispatches, chain.row_dispatches)
        check(rt.pool.fault_counts["wedge"] == 0,
              f"no wedge detected ({rt.pool.fault_counts})")
    finally:
        rt.stop()
    got = [int(r.values[0]) for r in out.rows]
    return (model, params, toks.to(dev), got, lats, retraces, dispatches,
            launches)


def expected_launches(cfg, prefills, steps):
    """Launches of each kernel over ``prefills`` dispatches of the
    cascade: the dense and moe paths run flash attention per layer and
    prefill and decode attention per layer and step; rwkv6 runs wkv6 per
    layer and prefill; recurrentgemma runs rglru_scan per recurrent layer
    and prefill (its local attention stays plain, as in the reference);
    whisper runs none (its attention stays plain, as in the
    reference)."""
    from repro_torch.models import rglru

    want = dict.fromkeys(KERNELS, 0)
    L = cfg.num_layers
    if cfg.family in ("dense", "moe"):
        want["flash_attention"] = L * prefills
        want["decode_attention"] = L * steps * prefills
    elif cfg.family == "ssm":
        want["wkv6"] = L * prefills
    elif cfg.family == "hybrid":
        want["rglru_scan"] = rglru.layer_types(cfg).count("rec") * prefills
    return want


def expected_glue(cfg, prefills, steps, ax=None):
    """Launches of each fused glue kernel over ``prefills`` dispatches of
    the cascade (a prefill and ``steps`` decode steps each): where the
    layers' record holds the glue kernels (a transformer family,
    ``layer_ops.layer_ops``), a prefill and
    a decode step each run ``add_rmsnorm`` at every norm (two a layer,
    four with post norms, and the final one) and ``gated_act`` at every
    gated MLP (a layer's own, a MoE layer's ``aux_mlp``), a prefill one
    ``rope`` a layer and a decode step one ``rope_cache_write``; the other
    families, and a transformer under a mesh, run none.  Besides, a gated
    MoE layer on the MoE kernels' path (``expected_moe``) runs
    ``gated_act`` once a call, between its grouped products."""
    from repro_torch.kernels import glue
    from repro_torch.models import layer_ops, transformer

    want = dict.fromkeys(GLUE, 0)
    if cfg.family not in ("dense", "moe", "vlm"):
        return want
    slots = transformer.layer_slots(cfg)
    calls = prefills * (1 + steps)
    if cfg.gated_mlp:
        want["gated_act"] = expected_moe(cfg, prefills, steps,
                                         ax)["moe_route"]
    if layer_ops.layer_ops(cfg, ax).add_norm is not glue.add_rmsnorm:
        return want
    L = sum(n for _, _, n in slots)
    want["add_rmsnorm"] = ((4 if cfg.post_norms else 2) * L + 1) * calls
    if cfg.gated_mlp:
        want["gated_act"] += sum(n for _, sp, n in slots
                                 if not sp.is_moe or sp.aux_mlp) * calls
    want["rope"] = L * prefills
    want["rope_cache_write"] = L * steps * prefills
    return want


def expected_moe(cfg, prefills, steps, ax=None):
    """Launches of each MoE kernel over ``prefills`` dispatches of the
    cascade (a prefill and ``steps`` decode steps each): every MoE layer
    call runs each once where the layers' record holds the MoE kernels
    (``layer_ops.layer_ops``: ``use_kernels`` and no mesh), and none
    elsewhere."""
    from repro_torch.kernels import moe as kmoe
    from repro_torch.models import layer_ops, transformer

    want = dict.fromkeys(MOE_KERNELS, 0)
    if (cfg.family not in ("dense", "moe", "vlm") or not cfg.num_experts
            or layer_ops.layer_ops(cfg, ax).moe_route is not kmoe.moe_route):
        return want
    n_moe = sum(n for _, sp, n in transformer.layer_slots(cfg) if sp.is_moe)
    return dict.fromkeys(MOE_KERNELS, n_moe * prefills * (1 + steps))


def moe_call_launches(cfg):
    """The launch calls of one MoE layer call on the kernels' path:
    ``moe_route``'s two kernels, ``moe_permute``, each grouped product
    with its data-preparation launch, the activation (``gated_act``, or
    the eager one of an ungated MLP) and ``moe_combine``."""
    return 2 + 1 + 2 * (3 if cfg.gated_mlp else 2) + 1 + 1


def phase_path(torch, dev, arch, f32_layers, logits_layers, keep=False,
               layers=None):
    """Serve ``arch`` at full width and depth (or ``layers`` deep, a cut
    that is printed) in bf16 through the kernels and check it; then at f32
    and ``f32_layers`` layers check the kernel path's greedy tokens
    against the plain path's.  The kernel path's logits are held to the
    plain path's within 0.05 at full depth, or at ``logits_layers`` where
    that is set, and then at full depth to the plain path's own gap under
    a last-bit change; a MoE model holds the bar on the token rows whose
    routes the two paths share (``moe_kernel_vs_plain``).  Returns the
    bf16 run's launches, its fused glue kernels' launches, its flash
    launches with a window (the local layers) and, with ``keep``, (its model, params, first-call latency in
    s, and the steady call in s) for the serving phases, else None."""
    from repro_torch.configs import get_config
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.examples.depth_gap import nudge_f32
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model, transformer

    cfg = dataclasses.replace(get_config(arch), use_kernels=True)
    cut = ""
    if layers is not None:
        cut = (f" (depth cut from {cfg.num_layers} to {layers} layers to "
               f"fit one card; width full)")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    L = cfg.num_layers
    print(f"-- {cfg.name}: {L} layers{cut}, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.family}, {cfg.dtype}",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    model, params, toks, got, lats, retraces, dispatches, launches = serve(
        torch, dev, cfg)
    glue_n = _glue_launches()        # set to 0 with the kernels' by serve
    windowed = kops.flash_attention.windowed_launches
    nparams = sum(t.numel() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  weights: {nparams} params, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(params))}"
          f" bytes; peak device memory {peak} bytes, {peak - held} above "
          f"the {held} bytes held before this path", flush=True)
    runs = sum(dispatches)
    print(f"  chain dispatches: {dispatches[0]} batched, {dispatches[1]} "
          f"per-row; launches {launches}", flush=True)
    want = expected_launches(cfg, runs, STEPS)
    check(runs > 0 and launches == want,
          f"launches {launches} == {want} for {runs} prefill dispatches "
          f"x {STEPS} decode steps")
    want = expected_glue(cfg, runs, STEPS)
    print(f"  fused glue launches {glue_n}", flush=True)
    check(glue_n == want, f"fused glue launches {glue_n} == {want} for "
          f"{runs} prefill dispatches x {STEPS} decode steps")
    moe_n = _moe_launches()
    want = expected_moe(cfg, runs, STEPS)
    print(f"  MoE kernel launches {moe_n}", flush=True)
    check({n: moe_n[n] for n in MOE_KERNELS} == want
          and moe_n["fused"] == (moe_n["calls"] if want["moe_route"] else 0),
          f"MoE kernel launches {moe_n} == {want} for {runs} prefill "
          f"dispatches x {STEPS} decode steps, every MoE call (or none) on "
          f"the kernels' path")
    PATH_MOE_LAUNCHES[cfg.name] = moe_n
    PATH_DISPATCHES[cfg.name] = runs
    if cfg.family == "dense":
        specs, blocks = transformer.block_layout(cfg)
        local = blocks * sum(1 for sp in specs if sp.window) * runs
        check(windowed == local, f"flash launches with a window {windowed}"
              f" == {local} (the local layers)")
    check(retraces[1:] == [0, 0], f"re-traces per call {retraces}")
    check(len(got) == PROMPTS and all(0 <= t < cfg.vocab_size for t in got),
          f"{PROMPTS} greedy tokens in range: {got}")
    ref = dc.reference_decode(model, params, toks, steps=STEPS,
                              cache_len=CACHE)
    check(got == ref, f"fused cascade tokens == unfused loop {ref}")
    PATH_TOKENS[cfg.name] = got
    print(f"  {cfg.dtype} {L}-layer {cfg.name} latency: first "
          f"{lats[0] * 1e3} ms, steady {min(lats) * 1e3} ms ({PROMPTS} "
          f"prompts x {SEQ} tokens, {STEPS} decode steps)", flush=True)

    # kernel path vs plain path, same params, on the card
    if cfg.family == "moe":
        e_pre, e_dec = moe_kernel_vs_plain(torch, dev, cfg, params, toks)
    else:
        e_pre, e_dec = kernel_vs_plain(torch, dev, cfg, params, toks)
    print(f"  {L}-layer logits rel err, kernel path vs plain path: "
          f"prefill {e_pre}, first decode {e_dec}", flush=True)
    if logits_layers is None:
        worst = max(e for e in (e_pre, e_dec) if e is not None)
        check(worst < BF16_REL, f"{L}-layer logits rel err {worst} < 0.05")
    else:
        # the model amplifies the last-bit differences of any two correct
        # runs with depth: hold the full depth to the plain path's own gap
        # under a last-bit change, and the bar where depth does not rule
        plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                            device=dev)
        control = rel_err(*(plain.prefill(p, {"tokens": toks}, CACHE)[0]
                            for p in (nudge_f32(params), params)))
        del plain
        check(0 < control and e_pre <= CONTROL_FACTOR * control,
              f"{L}-layer prefill logits rel err {e_pre} <= "
              f"{CONTROL_FACTOR} x {control}, the plain path's own gap "
              f"with its f32 weights scaled by 1 + 2^-20")
        cut = dataclasses.replace(cfg, num_layers=min(logits_layers, L))
        e_cut = max(kernel_vs_plain(torch, dev, cut, params, toks))
        check(e_cut < BF16_REL, f"{cut.num_layers}-layer logits rel err "
              f"{e_cut} < 0.05 (prefill and first decode)")
    if cfg.local_global_pattern:
        launches_long = phase_gemma2(torch, dev, cfg, model, params)
        print(f"  gemma2 extras' launches (long prompt, ring defect, "
              f"kv_quant): {launches_long}", flush=True)
    if cfg.family == "moe":
        moe_layer_check(torch, dev, cfg, params, BF16_REL)
    if cfg.family == "audio":
        phase_frames(torch, dev, cfg, model, params, toks)
    if cfg.family == "hybrid":
        # the reference's init gives a = sigmoid(-lam)^4 < 3e-8, so a*h
        # is below half an ulp of x and h_t = x_t on both paths to the
        # last bit; with lam negated (a = sigmoid(lam)^4 in (0.949,
        # 0.9995), the range the reference's comment names) the
        # recurrence carries state and the paths' roundings differ
        e_live = max(kernel_vs_plain(torch, dev, cfg, _negate_lam(params),
                                     toks))
        check(e_live < BF16_REL, f"{L}-layer logits rel err {e_live} < 0.05 "
              "with lam negated (prefill and first decode)")
    served = (model, params, lats[0], min(lats)) if keep else None
    del model, params
    _release(torch)
    if cfg.family == "moe":
        phase_expert_quant(torch, dev, cfg)

    # float32 at reduced depth, full width: greedy tokens must be identical
    torch.cuda.reset_peak_memory_stats(dev)
    cfg32 = dataclasses.replace(cfg, num_layers=f32_layers, dtype="float32")
    model, params, toks, got32, lats32, retraces32, _, _ = serve(
        torch, dev, cfg32)
    plain32 = build_model(dataclasses.replace(cfg32, use_kernels=False),
                          device=dev)
    ref32 = dc.reference_decode(plain32, params, toks, steps=STEPS,
                                cache_len=CACHE)
    check(got32 == ref32, f"f32 {f32_layers}-layer kernel-path tokens "
          f"{got32} == plain-path tokens {ref32}")
    check(retraces32[1:] == [0, 0], f"f32 re-traces per call {retraces32}")
    print(f"  f32 {f32_layers}-layer latency: first {lats32[0] * 1e3} ms, "
          f"steady {min(lats32) * 1e3} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    if cfg.family == "moe":
        moe_layer_check(torch, dev, cfg32, params, MOE_F32_REL)
    del model, params, plain32
    _release(torch)
    return launches, glue_n, windowed, served


# -- phase 4, gemma2-9b: the long prompt, the ring defect, the int8 cache ----

#: gemma2's long prompt: the window binds in the prefill, the local ring
#: is aligned (8192 % 4096 = 0) and wraps in decode
G2_LONG_CACHE = 8200
#: the reference's ring defect: prompts of 4160 tokens (4160 % 4096 = 64:
#: the first decode step overwrites position 128, still in the window)
#: and of 4096 (aligned: the control)
G2_RING_SEQS = (4160, 4096)
#: depth of the ring check at f32 (two blocks), where the bf16 rounding
#: of the full depth does not hide the defect
G2_RING_F32_LAYERS = 4


def _greedy_loop(torch, model, params, toks, cache_len, steps):
    """The unfused loop (``decode_cascade.reference_decode``) keeping the
    prefill's last-position logits and the first decode step's logits:
    returns (final greedy tokens, prefill logits [B, V], first decode
    logits [B, V]).  The prefill's all-position logits are dropped at
    once (8.4 GB at 8192 tokens of gemma2's vocabulary)."""
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len)
    first = logits[:, -1].clone()
    del logits
    tok = torch.argmax(first, dim=-1).to(torch.int32)
    pos = torch.full(toks.shape[:1], toks.shape[1], dtype=torch.int32,
                     device=toks.device)
    step = None
    for _ in range(steps):
        lg, cache = model.decode_step(params, tok[:, None], pos, cache)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        step = lg[:, -1] if step is None else step
        pos = pos + 1
    return [int(x) for x in tok], first, step


def _flash_profile(torch, model, params, toks, cache_len, top=6):
    """One prefill of ``toks`` on ``model``'s kernel path under
    ``torch.profiler``: (flash kernels run, their summed device ms, every
    kernel's summed device ms, the prefill's host ms ending in a
    synchronise).  Prints the ``top`` kernel names by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks}, cache_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del logits, cache
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    flash = [e.device_time for e in events if "flash_" in e.name]
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:10.3f} ms  {name[:90]}", flush=True)
    return (len(flash), sum(flash) / 1e3,
            sum(e.device_time for e in events) / 1e3, wall * 1e3)


def _ring_gaps(torch, dev, cfg, params, toks):
    """Print, for each prompt length of ``G2_RING_SEQS``, how far the
    first decode step's logits after a prefill stand off the full
    forward's at the same position, on the kernel and the plain path."""
    from repro_torch.models import transformer

    for S2 in G2_RING_SEQS:
        p2 = toks[:, :S2]
        nxt = None
        for side, kernels in (("kernel", True), ("plain", False)):
            c = dataclasses.replace(cfg, use_kernels=kernels)
            # the plain path's chunked attention needs chunks that divide
            # S: one chunk of the whole prompt
            logits, cache = transformer.forward(
                params, p2, c, build_cache=True, cache_len=S2 + 8,
                chunk=S2)
            if nxt is None:
                nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            del logits
            pos = torch.full((1,), S2, dtype=torch.int32, device=dev)
            step, _ = transformer.decode_step(params, nxt[:, None], pos,
                                              cache, c)
            del cache
            full = transformer.forward(
                params, torch.cat([p2, nxt[:, None]], dim=1), c,
                chunk=S2 + 1)[:, S2]
            gap = float((step[:, 0] - full).abs().max())
            kind = "defect" if S2 % cfg.sliding_window else "control"
            print(f"  ring {kind} ({cfg.dtype}, {cfg.num_layers} layers, "
                  f"{S2} tokens, window "
                  f"{cfg.sliding_window}), {side} path: first decode logits"
                  f" vs the full forward's at position {S2}: max abs {gap},"
                  f" rel {rel_err(step[:, 0], full)}", flush=True)
            del step, full


def phase_gemma2(torch, dev, cfg, model, params):
    """gemma2-9b's checks beyond the cascade, on phase 4's bf16 weights.

    1. One 8192-token prompt (cache ``G2_LONG_CACHE``, ``STEPS`` decode
       steps) through the cascade: its token equals the unfused loop's on
       the kernel path, and the kernel path's logits (prefill and first
       decode) are the plain path's within rel 0.05.  One more prefill of
       the prompt under ``torch.profiler`` gives the flash kernels' device
       time beside all kernels'.
    2. The reference's ring defect: after a prompt of S tokens, the first
       decode step's logits against the full forward's at position S, on
       the kernel and the plain path, for S = 4160 (the defect) and 4096
       (aligned), in bf16 at full depth and at f32 on two blocks.
       Printed, not asserted: it is the reference's behaviour.
    3. ``kv_quant=True`` through the 4 x 256 cascade: tokens equal its
       unfused loop, logits within 0.05 of its plain path.

    Returns the launches of part 1's cascade run."""
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.models import build_model

    torch.cuda.reset_peak_memory_stats(dev)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=dev)
    S, C = G2_LONG, G2_LONG_CACHE
    toks = torch.randint(0, cfg.vocab_size, (1, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 2))
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    hang_timeout_s=PATH_HANG_TIMEOUT_S, device=dev)
    try:
        pre, dec = dc.build_ops(model, params, seq_len=S, cache_len=C,
                                name=cfg.name, measure=False)
        dep = dc.build(rt, pre, dec, steps=STEPS, name="smoke-gemma2-long")
        _zero_launches()
        t0 = time.perf_counter()
        out = dep.execute(Table([("tokens", torch.Tensor)],
                                [(toks[0],)])).result(600)
        lat = time.perf_counter() - t0
        launches = _launches()
        check(rt.pool.fault_counts["wedge"] == 0,
              f"no wedge on the long prompt ({rt.pool.fault_counts})")
    finally:
        rt.stop()
    got = int(out.rows[0].values[0])
    want = expected_launches(cfg, 1, STEPS)
    check(launches == want, f"{S}-token prompt: launches {launches} == "
          f"{want}")
    toks = toks.to(dev)
    ref, k_pre, k_dec = _greedy_loop(torch, model, params, toks, C, STEPS)
    check([got] == ref, f"{S}-token prompt, cache {C}, {STEPS} decode "
          f"steps: cascade token {got} == unfused loop {ref}")
    _, p_pre, p_dec = _greedy_loop(torch, plain, params, toks, C, 1)
    e_pre, e_dec = rel_err(k_pre, p_pre), rel_err(k_dec, p_dec)
    check(max(e_pre, e_dec) < BF16_REL, f"{S}-token prompt: logits rel err "
          f"kernel vs plain path {e_pre} (prefill), {e_dec} (first decode) "
          f"< {BF16_REL}")
    print(f"  {S}-token prompt latency through the cascade: {lat * 1e3} ms;"
          f" peak device memory {torch.cuda.max_memory_allocated(dev)} "
          f"bytes", flush=True)
    n_flash, flash_ms, kernel_ms, wall_ms = _flash_profile(
        torch, model, params, toks, C)
    check(n_flash == cfg.num_layers, f"{S}-token prefill under "
          f"torch.profiler: {n_flash} flash kernels, one a layer")
    print(f"  {S}-token prefill on the kernel path under torch.profiler: "
          f"flash {flash_ms} ms over its {n_flash} launches, of {kernel_ms}"
          f" ms of device kernel time in {wall_ms} ms", flush=True)

    # the ring defect, shown on the card: at full depth in bf16, and at
    # f32 on two blocks, where rounding no longer hides it
    _ring_gaps(torch, dev, cfg, params, toks)
    del plain
    _release(torch)
    c32 = dataclasses.replace(cfg, num_layers=G2_RING_F32_LAYERS,
                              dtype="float32")
    p32 = build_model(c32, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    _ring_gaps(torch, dev, c32, p32, toks)
    del p32
    _release(torch)

    # the int8 KV cache through the same cascade
    cq = dataclasses.replace(cfg, kv_quant=True)
    model_q, _, toks_q, got_q, lats_q, retraces_q, disp_q, launches_q = \
        serve(torch, dev, cq, params=params)
    runs = sum(disp_q)
    want = expected_launches(cq, runs, STEPS)
    check(runs > 0 and launches_q == want, f"kv_quant: launches "
          f"{launches_q} == {want} for {runs} prefill dispatches")
    check(retraces_q[1:] == [0, 0], f"kv_quant re-traces per call "
          f"{retraces_q}")
    ref_q = dc.reference_decode(model_q, params, toks_q, steps=STEPS,
                                cache_len=CACHE)
    check(got_q == ref_q, f"kv_quant: fused cascade tokens {got_q} == "
          f"unfused loop {ref_q}")
    e_q = kernel_vs_plain(torch, dev, cq, params, toks_q)
    check(max(e_q) < BF16_REL, f"kv_quant: logits rel err kernel vs plain "
          f"path {e_q} (prefill, first decode) < {BF16_REL}")
    print(f"  kv_quant latency: first {lats_q[0] * 1e3} ms, steady "
          f"{min(lats_q) * 1e3} ms ({PROMPTS} prompts x {SEQ} tokens, "
          f"{STEPS} decode steps); peak device memory since the long "
          f"prompt {torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    del model_q
    _release(torch)
    return launches


# -- phase 5: the serving runtime on full-width yi-9b ------------------------

def _launches():
    from repro_torch.kernels import ops as kops

    return {name: getattr(kops, name).launches for name in KERNELS}


def _glue_launches():
    from repro_torch.kernels import glue

    return {name: getattr(glue, name).launches for name in GLUE}


def _moe_launches():
    """The MoE kernels' launches and the served MoE layer's calls, and of
    them those on the kernel path (``fused``)."""
    from repro_torch.kernels import moe as kmoe
    from repro_torch.models import moe

    out = {name: getattr(kmoe, name).launches for name in MOE_KERNELS}
    out.update(calls=moe.moe_apply_grouped.calls,
               fused=moe.moe_apply_grouped.fused)
    return out


def _zero_launches():
    from repro_torch.kernels import glue, moe as kmoe, ops as kops
    from repro_torch.models import moe

    for name in KERNELS:
        getattr(kops, name).launches = 0
    for name in GLUE:
        getattr(glue, name).launches = 0
    for name in MOE_KERNELS:
        getattr(kmoe, name).launches = 0
    moe.moe_apply_grouped.calls = moe.moe_apply_grouped.pairs = 0
    moe.moe_apply_grouped.fused = 0
    kops.flash_attention.windowed_launches = 0
    kops.flash_attention.launches_by_heads = {}


def _flash_by_heads():
    """The flash launches since the last :func:`_zero_launches`, by
    ``(B, H, K)``."""
    from repro_torch.kernels import ops as kops

    return dict(kops.flash_attention.launches_by_heads)


def _burst(dep, toks, idx, **call_kw):
    """Submit one request per prompt row in ``idx`` at once.  Returns
    (futures, submit times, done times, call_dag times), all on the host
    clock; a done time is taken in the future's callback."""
    import torch

    from repro_torch.core.table import Table

    futs, t_sub, t_call = [], [], []
    done = [None] * len(idx)
    for j, i in enumerate(idx):
        table = Table([("tokens", torch.Tensor)], [(toks[i],)])
        t0 = time.perf_counter()
        f = dep.runtime.call_dag(dep.dag.name, table, **call_kw)
        t_call.append(time.perf_counter() - t0)
        t_sub.append(t0)

        def note(_f, j=j):
            done[j] = time.perf_counter()
        f.add_done_callback(note)
        futs.append(f)
    return futs, t_sub, done, t_call


def _wait_for(cond, what):
    deadline = time.perf_counter() + 60.0
    while not cond():
        if time.perf_counter() > deadline:
            raise SmokeFailure(f"timed out waiting: {what}")
        time.sleep(0.001)


def _tokens(futs):
    return [int(f.result(600).rows[0].values[0]) for f in futs]


def _traces(tracer, dag, n):
    """The ``n`` kept traces of ``dag`` in arrival order (trace ids count
    up as ``call_dag`` is called).  A trace is finished in the future's
    own callback, which may still be running when ``result()`` returns:
    wait for it."""
    _wait_for(lambda: len(tracer.kept(dag)) >= n,
              f"{n} traces of {dag} finished")
    traces = sorted(tracer.kept(dag), key=lambda t: t.trace_id)
    if len(traces) != n:
        raise SmokeFailure(f"{len(traces)} kept traces of {dag}, not {n}")
    return traces


def _batches(tracer, traces, node):
    """How the burst was cut, read from the tracer: [(batch id, member
    request indices in batch order)], in dispatch order, each checked
    against its batch span's size.  The batcher keeps arrival order
    within a batch (no member carries a deadline, so no EDF reorder)."""
    groups = {}
    for i, tr in enumerate(traces):
        (ex,) = [s for s in tr.spans if s.name == f"exec@{node}"]
        if ex.link is None:
            raise SmokeFailure(f"request {i}'s exec@ span links to no "
                               "batch")
        groups.setdefault(ex.link, []).append(i)
    spans = {s.link: s for s in tracer.batch_spans(set(groups))}
    out = sorted(groups.items(), key=lambda kv: spans[kv[0]].t0)
    for bid, members in out:
        if spans[bid].attrs["size"] != len(members):
            raise SmokeFailure(f"batch {bid} size {spans[bid].attrs['size']}"
                               f" != its {len(members)} members")
    return out


def _padded(torch, rows):
    """The rows as the chain runs them: row 0 repeated up to the row
    count's bucket (``DeviceTable.from_columns`` and ``take`` pad so)."""
    from repro_torch.core.lowering import bucket_rows

    k = rows.shape[0]
    b = bucket_rows(k)
    return torch.cat([rows, rows[:1].expand(b - k, -1)]) if b > k else rows


def _batch_oracle(torch, model, params, toks, members):
    """The unfused loop over one batch's rows in batch order, padded as
    the chain pads, so every GEMM has the chain's shape (in bf16, tokens
    are held only to an oracle of the same shapes)."""
    from repro_torch.examples import decode_cascade as dc

    rows = _padded(torch, toks[members].to(model.device))
    return dc.reference_decode(model, params, rows, steps=STEPS,
                               cache_len=CACHE)[:len(members)]


def _check_batched_tokens(torch, model, params, toks, idx, got, batches,
                          what):
    for bid, members in batches:
        want = _batch_oracle(torch, model, params, toks,
                             [idx[m] for m in members])
        have = [got[m] for m in members]
        if have != want:
            raise SmokeFailure(f"{what}: batch {bid} tokens {have} != the "
                               f"unfused loop's over its padded rows {want}")
    check(True, f"{what}: every request's tokens == the unfused loop over "
          f"its own batch, padded as the chain pads "
          f"({[len(m) for _, m in batches]} requests per batch)")


def _stats(t_sub, done, n_launch, wall):
    import numpy as np

    lat = np.array([d - s for s, d in zip(t_sub, done)])
    p50, p99 = np.percentile(lat, [50, 99])
    return {"req_per_s": len(lat) / wall, "p50_ms": float(p50) * 1e3,
            "p99_ms": float(p99) * 1e3,
            "launches_per_request": n_launch / len(lat)}


def _serve_burst(dep, toks, idx):
    """One measured burst with the launch counters zeroed just before:
    (tokens, stats, launches, the chain's (batched, per-row) dispatch
    counts before and after, submit times, done times)."""
    chain = dep.plan.ops[-1].op
    d0 = (chain.batch_dispatches, chain.row_dispatches)
    _zero_launches()
    t0 = time.perf_counter()
    futs, t_sub, done, _ = _burst(dep, toks, idx)
    got = _tokens(futs)
    # the last done-callback may still be running
    _wait_for(lambda: None not in done, "done callbacks")
    wall = max(done) - t0
    launches = _launches()
    d1 = (chain.batch_dispatches, chain.row_dispatches)
    stats = _stats(t_sub, done, launches["flash_attention"], wall)
    return got, stats, launches, (d0, d1), t_sub, done


def _serve_modes(torch, rt, model, params, toks, alone):
    """Part 1 on ``rt``: the burst of ``SERVE_REQUESTS`` one-prompt
    requests through a cascade with the ``batching`` hint (tokens held to
    the unfused loop over each request's own batch, launches per batch),
    then the same requests one per dispatch (tokens held to ``alone``,
    the unfused loop on each prompt alone).  Each burst is measured after
    a warm-up.  Returns (the batched deployment, the numbers, its burst's
    traces, submit times, done times)."""
    from repro_torch.examples import decode_cascade as dc

    L = model.cfg.num_layers
    everyone = list(range(SERVE_REQUESTS))
    pre, dec = dc.build_ops(model, params, cache_len=CACHE,
                            name=model.cfg.name)
    dep = dc.build(rt, pre, dec, steps=STEPS, name="serve-batched",
                   batching=True)
    node = dep.function_names[0]
    _tokens(_burst(dep, toks, everyone)[0])              # warm the shapes
    rt.tracer.clear()
    got, b_stats, launches, (d0, d1), t_sub, done = _serve_burst(
        dep, toks, everyone)
    traces = _traces(rt.tracer, dep.dag.name, SERVE_REQUESTS)
    batches = _batches(rt.tracer, traces, node)
    sizes = [len(m) for _, m in batches]
    nb = len(batches)
    check(sum(sizes) == SERVE_REQUESTS and max(sizes) > 1,
          f"batch sizes {sizes} sum to {SERVE_REQUESTS}, one holds more "
          f"than one request")
    check(d1[0] - d0[0] + d1[1] - d0[1] == nb
          and d1[0] - d0[0] == sum(1 for k in sizes if k > 1),
          f"the chain dispatched once per batch: {d1[0] - d0[0]} batched "
          f"+ {d1[1] - d0[1]} per-row (batches of one) == {nb} batches")
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=L * nb, decode_attention=L * STEPS * nb)
    check(launches == want, f"launches over the burst {launches} == {L} x "
          f"{nb} batches (flash), {L} x {STEPS} x {nb} (decode): per "
          f"batch, not per request")
    _check_batched_tokens(torch, model, params, toks, everyone, got,
                          batches, "batched burst")

    pre_u, dec_u = dc.build_ops(model, params, cache_len=CACHE,
                                name=model.cfg.name)
    dep_u = dc.build(rt, pre_u, dec_u, steps=STEPS, name="serve-unbatched",
                     batching=False)
    _tokens(_burst(dep_u, toks, [0])[0])                  # warm
    got_u, u_stats, launches_u, _, _, _ = _serve_burst(
        dep_u, toks, everyone)
    check(launches_u["flash_attention"] == L * SERVE_REQUESTS
          and launches_u["decode_attention"] == L * STEPS * SERVE_REQUESTS,
          f"one request per dispatch: launches {launches_u}")
    check(got_u == alone, "unbatched tokens == the unfused loop on each "
          "prompt alone")
    # service time per dispatch, as the executor measured it (exec_s of
    # each exec@ span; a batch's members share one)
    b_stats["exec_s"] = [
        next(s for s in traces[m[0]].spans if s.name == f"exec@{node}")
        .attrs["exec_s"] for _, m in batches]
    u_node = dep_u.function_names[0]
    u_stats["exec_s"] = sorted(
        next(s for s in tr.spans if s.name == f"exec@{u_node}")
        .attrs["exec_s"] for tr in _traces(
            rt.tracer, dep_u.dag.name, SERVE_REQUESTS + 1)[1:])
    stats = {"gpu_workers": len(rt.pool.by_class("gpu")),
             "requests": SERVE_REQUESTS, "batch_sizes": sizes,
             "batched": b_stats, "unbatched": u_stats}
    return dep, stats, traces, t_sub, done


def phase_serving(torch, dev, model, params, first_s, smi):
    """Phase 5 (see the module docstring), on phase 4's yi-9b model and
    params.  Parts: 1 batched against one request per dispatch, on two
    GPU workers and again on one; 5 tracing of part 1's requests; 2 the
    device-resident demux; 3 admission and deadlines; 4 faults.  Returns
    part 1's numbers on one GPU worker."""
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.obs.trace import Tracer

    toks = torch.randint(0, model.cfg.vocab_size, (SERVE_REQUESTS, SEQ),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 2))
    # the wedge detector: far above the slowest call this card showed (a
    # batch of 8 holds twice phase 4's rows; two batches share the card)
    hang = max(30.0, 20.0 * first_s)

    def runtime(n_gpu):
        return dc.Runtime(n_cpu=1, n_gpu=n_gpu, net=dc.NetModel(scale=0.0),
                          max_batch=SERVE_BATCH,
                          batch_wait_ms=SERVE_WAIT_MS, hang_timeout_s=hang,
                          tracer=Tracer(sample_rate=1.0), device=dev)

    rt = runtime(2)
    print(f"  Runtime(n_gpu=2, max_batch={SERVE_BATCH}, batch_wait_ms="
          f"{SERVE_WAIT_MS}, hang_timeout_s={hang}): phase 4's first "
          f"call took {first_s} s", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    try:
        # part 1: batched against one request per dispatch
        alone = [dc.reference_decode(model, params, toks[i:i + 1].to(dev),
                                     steps=STEPS, cache_len=CACHE)[0]
                 for i in range(SERVE_REQUESTS)]
        dep, stats, traces, t_sub, done = _serve_modes(
            torch, rt, model, params, toks, alone)
        print(f"  serving: {json.dumps(dict(card=smi, **stats))}",
              flush=True)
        # the same on one GPU worker: does the second host thread help?
        rt1 = runtime(1)
        try:
            stats1 = _serve_modes(torch, rt1, model, params, toks, alone)[1]
            check(rt1.pool.fault_counts["wedge"] == 0,
                  f"no wedge on one worker ({rt1.pool.fault_counts})")
        finally:
            rt1.stop()
        print(f"  serving on one GPU worker: "
              f"{json.dumps(dict(card=smi, **stats1))}", flush=True)
        _part_tracing(dep, traces, t_sub, done)
        _part_demux(torch, dev, rt, model, params, toks)
        _part_admission(torch, rt, dep, model, params, toks)
        _part_faults(torch, rt, dep, model, params, toks)
        check(rt.pool.fault_counts["wedge"] == 0,
              f"no wedge in the serving phase ({rt.pool.fault_counts})")
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"  peak device memory {peak} bytes ({peak - held} above the "
              f"{held} held before the phase)", flush=True)
    finally:
        rt.stop()
    return stats1


def _part_tracing(dep, traces, t_sub, done):
    """Part 5, on part 1's batched burst: every request's kept trace has
    the spans admission, queue@, exec@ (linked to its batch), the
    dispatch's upload@ and one step@ a chain step, demux@ in order, and
    its attributed components cover at least 90% of its latency as the
    caller measured it; the traces go to a Perfetto file under
    ``build/``."""
    from repro_torch.obs import attribute, export_chrome

    node = dep.function_names[0]
    steps = len(dep.plan.ops[-1].op.ops)
    row = [f"upload@{node}", *[f"step@{node}"] * steps]
    for i, tr in enumerate(traces):
        got_names = [s.name for s in tr.spans]
        # a batch the router sent per row uploads and steps once a row
        rows = max(1, got_names.count(f"upload@{node}"))
        names = ["admission", f"queue@{node}", f"exec@{node}", *row * rows,
                 f"demux@{node}"]
        if got_names != names:
            raise SmokeFailure(f"request {i} spans {got_names} != {names}")
        total = sum(b.total_s for b in attribute([tr]).nodes.values())
        lat = done[i] - t_sub[i]
        if total < 0.9 * lat:
            raise SmokeFailure(f"request {i}: attributed {total} s < 90% "
                               f"of its measured {lat} s")
    check(True, f"{len(traces)} kept traces, spans admission, queue@, "
          f"exec@ (linked to its batch), upload@, {steps} step@, demux@ "
          f"of the chain in order; "
          f"components >= 90% of each request's measured latency")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    path = os.path.join(HERE, "build", "serving_trace.json")
    n_ev = export_chrome(dep.runtime.tracer, path, dag=dep.dag.name)
    print(f"  Perfetto trace: {n_ev} events in {path}", flush=True)
    print(attribute(traces).table(), flush=True)


def _part_demux(torch, dev, rt, model, params, toks):
    """Part 2: 4 requests through ``[prefill, decode]`` merged across
    requests, then 7 decode steps per request pinned to the producer's
    worker; tokens held to the split plain loop, the parts crossing the
    edge are DeviceTables on the card, and no copy crosses it."""
    from repro_torch.examples import decode_cascade as dc

    L = model.cfg.num_layers
    pre, dec_b = dc.build_ops(model, params, cache_len=CACHE,
                              name=model.cfg.name)
    _, dec = dc.build_ops(model, params, cache_len=CACHE,
                          name=model.cfg.name)
    dep = _split_deploy(rt, pre, dec_b, dec)
    n1, n2 = dep.function_names
    node2 = dep.dag.nodes[n2]
    check(dep.dag.nodes[n1].emits_device and not node2.batching,
          "split cascade: the batching [prefill, decode] chain emits a "
          "DeviceTable to the 7-step chain")
    seen = []
    inner = node2.fn

    def spy(tables, ctx):
        dt = getattr(tables[0], "device", None)
        seen.append((type(tables[0]).__name__, getattr(dt, "type", dt)))
        return inner(tables, ctx)

    node2.fn = spy
    four = list(range(4))
    rt.tracer.clear()
    _zero_launches()
    got = _tokens(_burst(dep, toks, four)[0])
    launches = _launches()
    traces = _traces(rt.tracer, dep.dag.name, 4)
    batches = _batches(rt.tracer, traces, n1)
    nb = len(batches)
    for bid, members in batches:
        want = _split_oracle(torch, model, params, toks, members)
        check([got[m] for m in members] == want,
              f"split batch {bid}: tokens == prefill + 1 step over the "
              f"padded batch, then 7 steps per row from its slice {want}")
    check(launches["flash_attention"] == L * nb
          and launches["decode_attention"] == L * (nb + (STEPS - 1) * 4),
          f"split launches {launches}: {nb} batched prefills and steps, "
          f"then {STEPS - 1} steps per request")
    check(seen == [("DeviceTable", dev.type)] * 4,
          f"the parts handed to the 7-step chain are DeviceTables on the "
          f"card: {seen}")
    for i, tr in enumerate(traces):
        e1, e2 = (next(s for s in tr.spans if s.name == f"exec@{n}")
                  for n in (n1, n2))
        c1, c2 = e1.attrs.get("copies", {}), e2.attrs.get("copies", {})
        if "gathers" in c1 or "stacks" in c2 or \
                e1.attrs["executor"] != e2.attrs["executor"]:
            raise SmokeFailure(
                f"request {i}: first node copies {c1} (want no "
                f"device->host), second {c2} (want no host->device), "
                f"executors {e1.attrs['executor']} and "
                f"{e2.attrs['executor']} (want one)")
    ex1, ex2 = ([next(s for s in tr.spans if s.name == f"exec@{n}")
                 .attrs.get("exec_s") for tr in traces] for n in (n1, n2))
    check(True, "no device->host copy at the demuxed edge; each part ran "
          "on its producer's worker")
    print(f"  device-resident edge: first node exec_s {ex1} (closes at "
          f"launch), second node exec_s {ex2} (holds the device time)",
          flush=True)


def _part_admission(torch, rt, dep, model, params, toks):
    """Part 3: a rate-limited gate admits the first 4 of a burst of 12
    and sheds 8 typed in under 5 ms each; then, with the gate cleared, a
    lone request whose deadline is far below one batch's time, sent
    while both GPU workers are busy, expires typed in a queue and its
    batch never launches."""
    from repro_torch.serving import (AdmissionController, ClassPolicy,
                                     DeadlineExceeded, Overloaded)

    L = model.cfg.num_layers
    name, node = dep.dag.name, dep.function_names[0]
    tracer = rt.tracer
    rt.set_admission(name, AdmissionController(classes={
        "interactive": ClassPolicy("interactive", priority=2, rate=1.0,
                                   burst=4)}))
    shed0 = len(rt.metrics_snapshot().get(f"dag/{name}/shed_t", []))
    tracer.clear()
    twelve = list(range(12))
    t_b = time.perf_counter()
    futs, _, _, t_call = _burst(dep, toks, twelve)
    t_b = time.perf_counter() - t_b
    ok, shed = [], []
    for j, f in enumerate(futs):
        e = f.exception(600)
        if e is None:
            ok.append(j)
        elif isinstance(e, Overloaded) and e.reason == "rate_limit" \
                and not isinstance(e, DeadlineExceeded):
            shed.append(j)
        else:
            raise e
    check(t_b < 1.0 and ok == [0, 1, 2, 3] and shed == twelve[4:],
          f"12 requests in {t_b} s: the first 4 admitted, 8 shed typed "
          f"(Overloaded, rate_limit)")
    check(max(t_call[j] for j in shed) < 5e-3,
          f"each shed call_dag returned in < 5 ms (max "
          f"{max(t_call[j] for j in shed)} s)")
    n_shed = len(rt.metrics_snapshot().get(f"dag/{name}/shed_t", []))
    check(n_shed - shed0 == 8, f"dag/{name}/shed_t counts 8")
    got = _tokens([futs[j] for j in ok])
    admitted = [t for t in _traces(tracer, name, 12) if not t.shed]
    _check_batched_tokens(torch, model, params, toks, ok, got,
                          _batches(tracer, admitted, node),
                          "admitted requests")
    rt.set_admission(name, None)

    chain = dep.plan.ops[-1].op
    c0 = chain.batch_dispatches + chain.row_dispatches
    exp0 = len(rt.metrics_snapshot().get(f"dag/{name}/expired_t", []))
    batch_s = float(min(s.duration_s for s in tracer.batch_spans()))
    tracer.clear()
    _zero_launches()
    fill, _, _, _ = _burst(dep, toks, list(range(SERVE_REQUESTS)))
    gpus = rt.pool.by_class("gpu")
    _wait_for(lambda: len(gpus) == 2 and all(e.busy for e in gpus),
              "both GPU workers busy with the filler burst")
    budget = batch_s / 20.0
    late, _, _, _ = _burst(dep, toks, [0], deadline_s=budget)
    err = late[0].exception(600)
    check(isinstance(err, DeadlineExceeded),
          f"a lone request with deadline_s={budget} (a batch takes "
          f"{batch_s} s) behind two busy workers fails typed: {err!r}")
    _tokens(fill)
    traces = _traces(tracer, name, SERVE_REQUESTS + 1)
    nb = len(_batches(tracer, traces[:SERVE_REQUESTS], node))
    ran = chain.batch_dispatches + chain.row_dispatches - c0
    launches = _launches()
    check(ran == nb and launches["flash_attention"] == L * nb
          and launches["decode_attention"] == L * STEPS * nb,
          f"its batch never launched: {ran} dispatches, launches "
          f"{launches} == the filler's {nb} batches")
    n_exp = len(rt.metrics_snapshot().get(f"dag/{name}/expired_t", []))
    check(n_exp - exp0 == 1, f"dag/{name}/expired_t counts 1; its spans "
          f"{[s.kind for s in traces[-1].spans]}")


def _part_faults(torch, rt, dep, model, params, toks):
    """Part 4: a crash of a GPU worker (detected, requeued, replaced) and
    then a transient fault (retried once), each on a burst of 8 requests
    whose tokens stay held to the same-shape oracle."""
    from repro_torch.serving import FaultPlan

    name, node = dep.dag.name, dep.function_names[0]
    eight = list(range(8))
    fc0 = dict(rt.pool.fault_counts)
    rt.set_fault_plan(FaultPlan(seed=7).crash(rate=1.0, limit=1,
                                              classes=("gpu",)))
    rt.tracer.clear()
    got = _tokens(_burst(dep, toks, eight)[0])
    rt.set_fault_plan(None)
    fc = {k: rt.pool.fault_counts[k] - fc0[k] for k in fc0}
    check(fc["crash"] == 1 and fc["requeued"] >= 1 and fc["replaced"] == 1
          and fc["wedge"] == 0,
          f"a crash of a GPU worker detected, requeued and replaced: {fc}")
    _check_batched_tokens(torch, model, params, toks, eight, got,
                          _batches(rt.tracer, _traces(rt.tracer, name, 8),
                                   node), "crash recovery")
    r0 = len(rt.metrics_snapshot().get(f"dag/{name}/retry_t", []))
    rt.set_fault_plan(FaultPlan(seed=7).transient(rate=1.0, limit=1))
    rt.tracer.clear()
    got = _tokens(_burst(dep, toks, eight)[0])
    rt.set_fault_plan(None)
    n_retry = len(rt.metrics_snapshot().get(f"dag/{name}/retry_t", []))
    check(n_retry - r0 == 1, f"a transient fault retried once "
          f"(dag/{name}/retry_t +{n_retry - r0})")
    _check_batched_tokens(torch, model, params, toks, eight, got,
                          _batches(rt.tracer, _traces(rt.tracer, name, 8),
                                   node), "transient recovery")


def _split_deploy(rt, pre, dec_batched, dec):
    """``[prefill, decode]`` with the batching hint (one chain, merged
    across requests), then ``STEPS - 1`` decode steps without it:
    ``FuseChainsPass`` splits the chain at the change of hint, so the
    first chain's DeviceTable is demuxed on the card and each request's
    steps run pinned to the producer's worker.  The hint lives on the op,
    so the batched decode step is an op instance of its own."""
    import torch

    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.dataflow import Dataflow

    fl = Dataflow([("tokens", torch.Tensor)])
    node = fl.apply_op(pre, gpu=True, batching=True).apply_op(
        dec_batched, gpu=True, batching=True)
    for _ in range(STEPS - 1):
        node = node.apply_op(dec, gpu=True)
    fl.output = node
    return compile_flow(fl, rt, fusion=True, name="serve-split")


def _split_oracle(torch, model, params, toks, members):
    """The split cascade's plain loop: prefill and one step over the
    batch's rows padded as the chain pads, then ``STEPS - 1`` steps per
    row from that row's slice of the cache (``take`` hands each request
    its own one-row cache)."""
    from repro_torch.models import registry

    rows = _padded(torch, toks[members].to(model.device))
    logits, cache = model.prefill(params, {"tokens": rows}, CACHE)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    pos = torch.full((rows.shape[0],), SEQ, dtype=torch.int32,
                     device=rows.device)
    lg, cache = model.decode_step(params, tok[:, None], pos, cache)
    tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
    pos = pos + 1
    paths, axes, _ = registry._cache_layout(model, CACHE)
    out = []
    for p in range(len(members)):
        idx = torch.tensor([p], device=rows.device)
        c = registry._unflatten(paths, [
            leaf.index_select(ax, idx) for (_, leaf), ax
            in zip(registry._flatten(cache), axes)])
        t, q = tok[p:p + 1], pos[p:p + 1]
        for _ in range(STEPS - 1):
            lg, c = model.decode_step(params, t[:, None], q, c)
            t = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
            q = q + 1
        out.append(int(t[0]))
    return out


# -- phase 6: the compile-time half on full-width yi-9b ----------------------

def phase_compile(torch, dev, model, params, first_s, smi):
    """Phase 6 (see the module docstring), on phase 4's yi-9b model and
    params.  Parts: the verifier at full width; the verifier against the
    card's KernelError; competitive execution under a hang fault;
    locality; the linter over the port's examples."""
    hang = max(30.0, 20.0 * first_s)
    out = {"card": smi}
    out["verify"] = _part_verify(torch, dev, model, params, hang)
    _part_launch_rules(torch, dev)
    out["competitive"] = _part_competitive(torch, dev, model, params, hang)
    out["locality"] = _part_locality(torch, dev)
    _part_check_cli()
    print(f"  compile: {json.dumps(out)}", flush=True)


def _sample(torch, toks, i):
    from repro_torch.core.table import Table

    return Table([("tokens", torch.Tensor)], [(toks[i],)])


def _part_verify(torch, dev, model, params, hang):
    """The cascade compiled with ``verify=True`` and a sample request:
    zero errors, CF103 run on both attention kernels at yi-9b's shapes,
    nothing allocated and nothing launched across the compile; the CF301
    footprint of the largest bucket beside the growth of the peak
    allocation over the first warm at that bucket; a budget below the
    footprint refused with CF301 before anything runs."""
    from repro_torch.analysis import VerificationError
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc

    toks = torch.randint(0, model.cfg.vocab_size, (64, SEQ),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 3))
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    hang_timeout_s=hang, device=dev)
    try:
        pre, dec = dc.build_ops(model, params, cache_len=CACHE,
                                name=model.cfg.name)
        budget = torch.cuda.mem_get_info(dev)[0]
        gc.collect()     # no earlier garbage may be freed inside the compile
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        _zero_launches()
        t0 = time.perf_counter()
        dep = dc.build(rt, pre, dec, steps=STEPS, name="verified",
                       verify=True, verify_input=_sample(torch, toks, 0),
                       verify_budget_bytes=budget)
        verify_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        rep = dep.verification
        check(rep.ok and not rep.errors(),
              f"verify at full width: {len(rep.errors())} errors, "
              f"{len(rep.warnings())} warnings in {verify_s} s\n"
              f"{rep.table()}")
        check(torch.cuda.memory_allocated(dev) == held
              and _launches() == dict.fromkeys(KERNELS, 0),
              f"the verified compile allocated nothing on the card "
              f"({torch.cuda.memory_allocated(dev)} == {held} bytes) and "
              f"launched nothing ({_launches()})")
        H, K, hd = (model.cfg.num_heads, model.cfg.num_kv_heads,
                    model.cfg.head_dim)
        want = {("flash_attention", (1, H, SEQ, hd)),
                ("decode_attention", (1, H, hd))}
        seen = {(k, shapes[0]) for _op, k, shapes in rep.kernel_checks}
        check(want <= seen, f"CF103 checked both attention kernels at "
              f"yi-9b's shapes: {sorted(seen)}")
        (op_id, (peak, per_row, cap)), = rep.footprint.items()
        rows = [(toks[i],) for i in range(cap)]
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        res = dep.execute(Table([("tokens", torch.Tensor)], rows)).result(
            600)
        warm_s = time.perf_counter() - t0
        grew = torch.cuda.max_memory_allocated(dev) - held
        got = [int(r.values[0]) for r in res.rows]
        check(len(got) == cap
              and all(0 <= t < model.cfg.vocab_size for t in got),
              f"the first warm at bucket {cap}: {cap} tokens in range "
              f"in {warm_s} s")
        print(f"  CF301 static footprint at bucket {cap}: {peak} bytes "
              f"({per_row} a row); peak allocation grew {grew} bytes over "
              f"the first warm at that bucket", flush=True)
        gc.collect()
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        _zero_launches()
        t0 = time.perf_counter()
        try:
            dc.build(rt, pre, dec, steps=STEPS, name="over-budget",
                     verify=True, verify_input=_sample(torch, toks, 0),
                     verify_budget_bytes=peak - 1)
            raise SmokeFailure("a budget below the footprint compiled")
        except VerificationError as e:
            codes = sorted({d.code for d in e.report.errors()})
        reject_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        check(codes == ["CF301"] and "over-budget" not in rt.dags
              and torch.cuda.memory_allocated(dev) == held
              and _launches() == dict.fromkeys(KERNELS, 0),
              f"budget {peak - 1} bytes (the footprint less one) refused "
              f"with {codes} in {reject_s} s: not registered, nothing "
              f"allocated, nothing launched")
        return {"verify_s": verify_s, "reject_s": reject_s,
                "footprint_bytes": peak, "bucket": cap,
                "bytes_per_row": per_row, "warm_peak_growth_bytes": grew,
                "warm_s": warm_s, "budget_bytes": budget,
                "kernels_checked": sorted(seen)}
    finally:
        rt.stop()


def _flash_flow(torch):
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.kernels import ops as kops

    def scale(o: torch.Tensor) -> torch.Tensor:
        return o * 2

    fl = Dataflow([("q", torch.Tensor), ("k", torch.Tensor),
                   ("v", torch.Tensor)])
    fl.output = fl.map(kops.kernel_step("flash_attention", causal=True),
                       names=["o"], gpu=True).map(scale, names=["o"],
                                                  gpu=True)
    return fl


def _part_launch_rules(torch, dev):
    """The verifier agrees with the card: a flash step at head_dim 12
    (the CUDA kernel needs a multiple of 8) is refused by CF103, and
    compiled unverified it raises KernelError at its first call; at
    yi-9b's head_dim 128 it passes and launches."""
    from repro_torch.analysis import VerificationError
    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.kernels.build import KernelError

    def sample(hd):
        g = torch.Generator().manual_seed(SEED + 4)
        t = torch.randn(32, SEQ, hd, generator=g).to(torch.bfloat16)
        return Table([("q", torch.Tensor), ("k", torch.Tensor),
                      ("v", torch.Tensor)], [(t, t, t), (t, t, t)])

    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    device=dev)
    try:
        try:
            compile_flow(_flash_flow(torch), rt, fusion=True, verify=True,
                         verify_input=sample(12), name="hd12")
            raise SmokeFailure("CF103 passed head_dim 12")
        except VerificationError as e:
            codes = sorted({d.code for d in e.report.errors()})
        check(codes == ["CF103"], f"head_dim 12 refused by the verifier "
              f"with {codes}")
        dep = compile_flow(_flash_flow(torch), rt, fusion=True,
                           name="hd12-unverified")
        _zero_launches()
        err = dep.execute(sample(12)).exception(600)
        check(isinstance(err, KernelError) and _launches()[
            "flash_attention"] == 0,
              f"compiled unverified, the card refuses it: {err!r}")
        dep = compile_flow(_flash_flow(torch), rt, fusion=True, verify=True,
                           verify_input=sample(128), name="hd128")
        out = dep.execute(sample(128)).result(600)
        torch.cuda.synchronize(dev)
        check(dep.verification.ok and _launches()["flash_attention"] == 1
              and len(out.rows) == 2,
              "head_dim 128 verified clean and launched once for its "
              "2-row batch")
    finally:
        rt.stop()


def _part_competitive(torch, dev, model, params, hang):
    """The cascade as ``COMPETE_REPLICAS`` replicas racing on two GPU
    workers under a hang fault on the GPU class, against the same
    requests without replicas: tokens equal the unfused loop on each
    prompt alone, no wedge; p50/p99 of both modes and the races each
    replica won (no gain asserted: the replicas share one card)."""
    import numpy as np

    from repro_torch.analysis import analyze, device_edge_info
    from repro_torch.core.lowering import BatchedJittedFuse
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import FaultPlan

    n = COMPETE_REQUESTS
    toks = torch.randint(0, model.cfg.vocab_size, (n, SEQ),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 5))
    alone = [dc.reference_decode(model, params, toks[i:i + 1].to(dev),
                                 steps=STEPS, cache_len=CACHE)[0]
             for i in range(n)]
    rt = dc.Runtime(n_cpu=1, n_gpu=2, net=dc.NetModel(scale=0.0),
                    hang_timeout_s=hang, tracer=Tracer(sample_rate=1.0),
                    device=dev)
    try:
        pre, dec = dc.build_ops(model, params, cache_len=CACHE,
                                name=model.cfg.name)
        comp = dc.build(rt, pre, dec, steps=STEPS, name="competitive",
                        competitive=COMPETE_REPLICAS)
        plan = comp.plan
        anyof = plan.op(plan.output_id)
        reps = [plan.op(i) for i in anyof.inputs]
        check(len(plan.ops) == COMPETE_REPLICAS + 1 and anyof.wait_any
              and anyof.placement == "cpu"
              and len(reps) == COMPETE_REPLICAS
              and all(isinstance(r.op, BatchedJittedFuse)
                      and r.placement == "gpu" for r in reps),
              f"CompetitivePass: {COMPETE_REPLICAS} lowered copies on "
              f"gpu and one anyof on cpu")
        info = device_edge_info(plan)
        fanout = {o.op_id: sum(o.op_id in c.inputs for c in plan.ops)
                  for o in plan.ops}
        donating = {i for i, (_e, d) in info.items() if d and fanout[i] > 1}
        cf201 = {d.op_id for d in analyze(plan).by_code("CF201")}
        check(donating == cf201 == set() and not any(
            e for e, _d in info.values()),
              f"no fan-out edge donates and no replica emits to the card "
              f"(device_edge_info {info}; CF201 {sorted(cf201)})")
        plain = dc.build(rt, pre, dec, steps=STEPS, name="no-replicas")
        for dep in (comp, plain):                           # warm
            dep.execute(_sample(torch, toks, 0)).result(600)
        stats = {}
        for mode, dep in (("competitive", comp), ("no_replicas", plain)):
            inj = rt.set_fault_plan(FaultPlan(seed=SEED + 6).hang(
                rate=HANG_RATE, hang_s=HANG_S, classes=("gpu",)))
            rt.tracer.clear()
            lats, got = [], []
            for i in range(n):
                t0 = time.perf_counter()
                res = dep.execute(_sample(torch, toks, i)).result(600)
                lats.append(time.perf_counter() - t0)
                got.append(int(res.rows[0].values[0]))
            rt.set_fault_plan(None)
            check(got == alone, f"{mode}: tokens under the hang fault == "
                  f"the unfused loop on each prompt alone {alone}")
            p50, p99 = np.percentile(np.array(lats) * 1e3, [50, 99])
            stats[mode] = {"p50_ms": float(p50), "p99_ms": float(p99),
                           "hangs": inj.counts["hang"]}
            if mode == "competitive":
                stats[mode].update(_races(rt.tracer, comp, n))
        # the losers still running must not be taken for wedges
        _wait_for(lambda: all(not e.busy for e in rt.pool.by_class("gpu")),
                  "the GPU workers idle")
        check(rt.pool.fault_counts["wedge"] == 0,
              f"no wedge ({rt.pool.fault_counts})")
        return stats
    finally:
        rt.stop()


def _races(tracer, dep, n):
    """Per replica node: how many of the ``n`` requests it won (its
    ``exec@`` span closed first; a loser's span closes after the request
    finished, and its trace may no longer take it) and the executor of
    each win."""
    names = list(dep.dag.nodes[dep.dag.output].deps)
    won = {nm: [] for nm in names}
    for tr in _traces(tracer, dep.dag.name, n):
        first = min((s for s in tr.spans if s.name.startswith("exec@")
                     and s.name[len("exec@"):] in won),
                    key=lambda s: s.t1)
        won[first.name[len("exec@"):]].append(first.attrs.get("executor"))
    return {"won": [len(w) for w in won.values()],
            "won_on": list(won.values())}


def _part_locality(torch, dev):
    """The port's recommender on the card: the category matrices are
    tensors on the card in the KVS; with ``fusion=locality=True`` the
    answers equal numpy's and every lookup after the warm-up runs on an
    executor caching its key; the naive flow's answers too.  Medians of
    both (host clock, one request at a time)."""
    from repro_torch.examples import recommender as rec

    want = rec.numpy_scores()
    out = {}
    for mode, optimized in (("naive", False), ("optimized", True)):
        r = rec.run(optimized, device=dev)
        ok = all(a[0] == w[0] and abs(a[1] - w[1]) <= 1e-9 * abs(w[1])
                 for a, w in zip(r["answers"], want))
        check(ok and len(r["answers"]) == len(want),
              f"recommender {mode}: {len(want)} answers == numpy's "
              f"(product, score) for the same users")
        local = sum(ex in where for _k, ex, where in r["dispatch"])
        out[mode] = {"median_ms": r["median_s"] * 1e3,
                     "lookups_on_a_caching_executor": local}
    check(out["optimized"]["lookups_on_a_caching_executor"] == len(want),
          f"every optimized lookup ran on an executor caching its key "
          f"(naive: {out['naive']['lookups_on_a_caching_executor']} of "
          f"{len(want)})")
    return out


def _part_check_cli():
    """``python -m repro_torch.check src/repro_torch/examples`` exits 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.check",
         os.path.join("src", "repro_torch", "examples")],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    last = (res.stdout.strip().splitlines() or [""])[-1]
    check(res.returncode == 0, f"python -m repro_torch.check "
          f"src/repro_torch/examples exits {res.returncode}: {last}"
          + ("" if res.returncode == 0 else f"\n{res.stdout}{res.stderr}"))


# -- phase 7: profile, plan and replan full-width yi-9b ----------------------

def phase_plan(torch, dev, model, params, first_s, served, smi):
    """Phase 7 (see the module docstring), on phase 4's yi-9b model and
    params and phase 5's one-worker batched numbers (``served``).  Parts:
    the offline profile and the cost hooks' seed; ``propose`` at a sparse
    and at phase 5's rate; the admission gate's estimator; the SLO
    controller ticked by hand; a blue/green replan under one-row
    traffic; a canary drill on a green with one weight changed; the
    cost-based planner."""
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.obs.trace import Tracer

    hang = max(30.0, 20.0 * first_s)
    toks = torch.randint(0, model.cfg.vocab_size, (SERVE_REQUESTS, SEQ),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 7))
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    max_batch=SERVE_BATCH, batch_wait_ms=SERVE_WAIT_MS,
                    hang_timeout_s=hang, tracer=Tracer(sample_rate=1.0),
                    device=dev)
    print(f"  Runtime(n_gpu=1, max_batch={SERVE_BATCH}, batch_wait_ms="
          f"{SERVE_WAIT_MS}, hang_timeout_s={hang})", flush=True)
    out = {"card": smi}
    try:
        pre, dec = dc.build_ops(model, params, seq_len=SEQ, cache_len=CACHE,
                                name=model.cfg.name)
        dep = dc.build(rt, pre, dec, steps=STEPS, name="plan", batching=True)
        alone = [dc.reference_decode(model, params, toks[i:i + 1].to(dev),
                                     steps=STEPS, cache_len=CACHE)[0]
                 for i in range(PLAN_PROMPTS)]
        lats, got = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            got.append(_tokens([dep.execute(_sample(torch, toks, 0))])[0])
            lats.append(time.perf_counter() - t0)
        one_row_s = min(lats[1:])
        check(got == [alone[0]] * 3, f"1-row requests: tokens {got} == the "
              f"unfused loop's {alone[0]}; steady latency {one_row_s} s "
              f"(first {lats[0]} s)")
        out["one_row_s"] = one_row_s
        fp, out["profile"] = _plan_profile(torch, dev, dep, model,
                                           _sample(torch, toks, 0))
        slo = 2.0 * one_row_s
        rate = served["batched"]["req_per_s"]
        out["slo_s"], out["rate"] = slo, rate
        out["propose"] = _plan_propose(dep, fp, slo, rate)
        out["admission"] = _plan_admission(torch, rt, dep, model, params,
                                           toks, fp, served)
        out["controller"] = _plan_controller(torch, rt, dep, model, params,
                                             toks, fp, slo, one_row_s)
        out["blue_green"], blue_tok = _plan_blue_green(torch, dev, rt, dep,
                                                       toks, alone)
        out["canary_drill"] = _plan_drill(torch, dev, rt, dep, model, params,
                                          toks, blue_tok)
        out["planner"] = _plan_planner(torch, dev, rt, model, params, toks,
                                       alone)
        check(rt.pool.fault_counts["wedge"] == 0,
              f"no wedge in the plan phase ({rt.pool.fault_counts})")
    finally:
        rt.stop()
    print(f"  plan: {json.dumps(out)}", flush=True)


def _chain_op_id(dep):
    (node,) = dep.dag.nodes.values()
    return node, node.plan_op_id


def _plan_profile(torch, dev, dep, model, sample):
    """Part 1: ``profile_plan`` over the compiled cascade and the cost
    hooks' seed at ``PLAN_SWEEP``; bytes held to the shapes, launches to
    the dispatches."""
    from repro_torch.models import registry
    from repro_torch.profiling import profile_plan
    from repro_torch.profiling.profiler import seed_from_model_ops

    L = model.cfg.num_layers
    _, op_id = _chain_op_id(dep)
    chain = dep.plan.op(op_id).op
    d0 = (chain.batch_dispatches, chain.row_dispatches)
    _zero_launches()
    t0 = time.perf_counter()
    fp = profile_plan(dep.plan, sample, batch_sizes=PLAN_SWEEP, runs=3,
                      warmup=1)
    sweep_s = time.perf_counter() - t0
    launches = _launches()
    d1 = (chain.batch_dispatches, chain.row_dispatches)
    batched, rows = d1[0] - d0[0], d1[1] - d0[1]
    want = expected_launches(model.cfg, batched + rows, STEPS)
    check(launches == want, f"profile sweep {PLAN_SWEEP} x (1 warm-up + 3 "
          f"runs) in {sweep_s} s: {batched} batched + {rows} per-row "
          f"dispatches, launches {launches} == {want}")
    curve = fp.curves[op_id]
    _, _, leaves = registry._cache_layout(model, CACHE)
    row_bytes = 8 + sum(t.numel() * t.element_size() for t in leaves)
    check({b: st.out_bytes for b, st in curve.buckets.items()}
          == {b: b * row_bytes + 64 for b in PLAN_SWEEP},
          f"profiled out_bytes == rows x {row_bytes} bytes (tok, pos and the "
          f"cache leaves, from their shapes) + 64 per table")
    _zero_launches()
    t0 = time.perf_counter()
    seed = seed_from_model_ops(dep.plan, batch_sizes=PLAN_SWEEP)
    seed_s = time.perf_counter() - t0
    launches = _launches()
    calls = 4 * len(PLAN_SWEEP)          # 1 warm-up + 3 runs per size
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=L * calls,
                decode_attention=L * STEPS * calls)
    check(launches == want, f"cost-hook seed in {seed_s} s: launches "
          f"{launches} == {want} (the prefill hook and {STEPS} decode hooks "
          f"per size)")
    sc = seed.curves[op_id]
    check({b: st.out_bytes for b, st in sc.buckets.items()}
          == {b: b * row_bytes for b in PLAN_SWEEP},
          "seeded out_bytes == rows x the decode stage's output bytes")
    buckets = {b: {"mean_s": st.mean_s, "p99_s": st.p99_s, "cv": st.cv,
                   "out_bytes": st.out_bytes,
                   "seeded_mean_s": sc.buckets[b].mean_s,
                   "chain_over_seeded": st.mean_s / sc.buckets[b].mean_s}
               for b, st in sorted(curve.buckets.items())}
    res = {"sweep_s": sweep_s, "seed_s": seed_s, "buckets": buckets,
           "per_row_s": curve.per_row_s,
           "crossover_rows": curve.crossover_rows(),
           "dispatches": {"batched": batched, "per_row": rows}}
    for b, st in buckets.items():
        print(f"  bucket {b}: mean {st['mean_s']} s, p99 {st['p99_s']} s, cv "
              f"{st['cv']}, out_bytes {st['out_bytes']}; seeded stages "
              f"{st['seeded_mean_s']} s, chain / seeded "
              f"{st['chain_over_seeded']}", flush=True)
    print(f"  per_row_s {curve.per_row_s}, crossover_rows "
          f"{curve.crossover_rows()}", flush=True)
    return fp, res


def _plan_propose(dep, fp, slo, rate):
    """Part 2: ``propose`` at a sparse rate and at phase 5's, each
    compiled off the serving path; its bucket and lowering overrides
    reach the compiled plan."""
    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.lowering import BatchedJittedFuse
    from repro_torch.profiling import propose

    rt = dep.runtime
    _, op_id = _chain_op_id(dep)
    res = {}
    for label, lam in (("sparse", PLAN_SPARSE_RATE), ("dense", rate)):
        cfg = propose(dep.plan, slo, lam, profile=fp, net=rt.net)
        print(f"  PlanConfig at {lam} req/s, SLO {slo} s: "
              f"{json.dumps(cfg.to_dict())}", flush=True)
        green = compile_flow(dep.flow, rt, plan_config=cfg,
                             name=f"plan-{label}", register=False,
                             **dep.compile_flags)
        o, nc = green.plan.op(op_id), cfg.node(op_id)
        batched = isinstance(o.op, BatchedJittedFuse)
        check(batched == nc.batched_lowering and o.batchable == batched
              and (not batched or (o.batch_buckets == nc.batch_buckets
                                   == tuple(o.op.bucket_sizes))),
              f"{label}: the compiled plan carries the config's lowering "
              f"({'batched' if batched else 'per-row'}) and buckets "
              f"{o.batch_buckets}")
        rt.discard_dag(green.dag)
        res[label] = cfg.to_dict()
    return res


def _plan_admission(torch, rt, dep, model, params, toks, fp, served):
    """Part 3: the estimator's p99 at phase 5's rate for one and two GPU
    workers beside phase 5's measured p99; then a burst above the
    estimated capacity at a gate holding the plan and the profile: sheds
    typed with the estimator's reason, admitted tokens held to a padded
    oracle of their own batch."""
    from repro_torch.profiling import NodeConfig, PlanConfig
    from repro_torch.serving import (AdmissionController, DeadlineExceeded,
                                     Overloaded)

    name = dep.dag.name
    node, op_id = _chain_op_id(dep)
    rate = served["batched"]["req_per_s"]

    def config(c):
        return PlanConfig(nodes={op_id: NodeConfig(
            max_batch=SERVE_BATCH, batch_buckets=tuple(dep.plan.op(op_id)
                                                       .batch_buckets),
            batch_wait_ms=SERVE_WAIT_MS, target_replicas=c)})

    est = {c: AdmissionController(dep.plan, fp, config(c), net=rt.net)
           ._estimate_p99(rate) for c in (1, 2)}
    capacity = {c: _modeled_capacity(dep.plan, fp, config(c), rt.net)
                for c in (1, 2)}
    print(f"  estimator p99 at {rate} req/s: one GPU worker {est[1]} s, two "
          f"{est[2]} s; phase 5 measured p99 {served['batched']['p99_ms']} "
          f"ms (one worker); the estimator's capacity {capacity[1]} and "
          f"{capacity[2]} req/s", flush=True)
    gate = AdmissionController(dep.plan, fp, config(1), net=rt.net,
                               window_s=PLAN_GATE_WINDOW_S)
    # the first request of the burst sees one arrival in the window
    deadline = 2.0 * gate._estimate_p99(1.0 / gate.window_s)
    # twice what the estimator says one window can take
    n = max(SERVE_REQUESTS, int(2 * capacity[1] * gate.window_s) + 1)
    rt.set_admission(name, gate)
    rt.tracer.clear()
    idx = [j % len(toks) for j in range(n)]
    futs, _, _, t_call = _burst(dep, toks, idx, deadline_s=deadline)
    ok, shed = [], []
    for j, f in enumerate(futs):
        e = f.exception(600)
        if e is None:
            ok.append(j)
        elif isinstance(e, Overloaded) and not isinstance(
                e, DeadlineExceeded) and e.estimate_s is not None \
                and e.reason in ("deadline_risk", "queue_depth"):
            shed.append((j, e.reason, e.estimate_s))
        else:
            raise e
    rt.set_admission(name, None)
    check(ok and shed and ok == list(range(len(ok)))
          and any(r == "deadline_risk" for _, r, _ in shed),
          f"a burst of {n} (the estimated capacity is {capacity[1]} req/s "
          f"over a {gate.window_s} s window), deadline {deadline} s "
          f"(twice the estimate at one arrival in the window): "
          f"{len(ok)} admitted, {len(shed)} shed typed (Overloaded) with "
          f"the estimator's reasons {sorted({r for _, r, _ in shed})}")
    got = _tokens([futs[j] for j in ok])
    admitted = [t for t in _traces(rt.tracer, name, n) if not t.shed]
    _check_batched_tokens(torch, model, params, toks, [idx[j] for j in ok],
                          got,
                          _batches(rt.tracer, admitted, node.name),
                          "admitted requests")
    return {"estimate_p99_s": {"1": est[1], "2": est[2]},
            "measured_p99_s": served["batched"]["p99_ms"] / 1e3,
            "capacity_req_s": {"1": capacity[1], "2": capacity[2]},
            "deadline_s": deadline,
            "burst": n, "admitted": len(ok),
            "shed": [[j, r, e] for j, r, e in shed],
            "shed_call_s_max": max(t_call[j] for j, _, _ in shed)}


def _modeled_capacity(plan, fp, config, net):
    """The largest arrival rate (req/s, in steps of 0.01 up to 100) below
    the first one the estimator calls saturated for ``config``."""
    from repro_torch.profiling import LatencyEstimator, Workload

    est = LatencyEstimator(fp, net=net)
    ok = 0.0
    for k in range(1, 10001):
        lam = k / 100.0
        if not est.estimate(plan, config, Workload(lam)).feasible:
            break
        ok = lam
    return ok


def _plan_controller(torch, rt, dep, model, params, toks, fp, slo,
                     one_row_s):
    """Part 4: ``SLOController`` ticked by hand after a sparse phase (one
    request at a time) and right after a burst of ``SERVE_REQUESTS``; a
    hot-apply reaches the live batcher and builds no executable."""
    from repro_torch.core.lowering import EXECUTABLE_CACHE
    from repro_torch.profiling import SLOController

    name = dep.dag.name
    node, op_id = _chain_op_id(dep)
    window = PLAN_RATE_WINDOWS * one_row_s
    ctl = SLOController(rt, dep, slo, profile=fp, window_s=window)
    events = []

    def tick(what):
        tr0 = EXECUTABLE_CACHE.traces()
        ev = ctl.tick()
        built = EXECUTABLE_CACHE.traces() - tr0
        b = rt.batcher_for(name, node.name)
        nc = ctl.applied.node(op_id) if ctl.applied else None
        rec = {"after": what, "kind": ev.kind, "rate": ev.arrival_rate,
               "applied": ev.detail.get("applied"),
               "predicted_p99_ms": ev.detail.get("predicted_p99_ms"),
               "current_p99_ms": ev.detail.get("current_p99_ms"),
               "slo_ok": ev.detail.get("slo_ok"),
               "config": nc and {"max_batch": nc.max_batch,
                                 "batch_wait_ms": nc.batch_wait_ms,
                                 "batch_buckets": list(nc.batch_buckets),
                                 "batched_lowering": nc.batched_lowering,
                                 "target_replicas": nc.target_replicas},
               "batcher": b and [b.max_batch, b.max_wait * 1e3],
               "executables_built": built}
        print(f"  controller event: {json.dumps(rec)}", flush=True)
        check(built == 0, f"tick after {what}: no executable built")
        if ev.kind == "apply":
            check(b is not None and b.max_batch == nc.max_batch
                  and abs(b.max_wait * 1e3 - nc.batch_wait_ms) < 1e-9,
                  f"the hot-apply reached the live batcher: max_batch "
                  f"{b.max_batch}, window {b.max_wait * 1e3} ms")
        events.append(rec)

    for i in range(3):
        _tokens([dep.execute(_sample(torch, toks, i))])
    tick("3 requests one at a time")
    # the sparse arrivals leave the controller's window before the burst
    time.sleep(window)
    rt.tracer.clear()
    idx = list(range(SERVE_REQUESTS))
    futs = _burst(dep, toks, idx)[0]
    tick(f"a burst of {SERVE_REQUESTS} (in flight)")
    got = _tokens(futs)
    _check_batched_tokens(torch, model, params, toks, idx, got,
                          _batches(rt.tracer, _traces(
                              rt.tracer, name, SERVE_REQUESTS), node.name),
                          "the burst across the ticks")
    check(any(e["kind"] == "apply" for e in events),
          f"a hot-apply among the events {[e['kind'] for e in events]}")
    return events


def _plan_blue_green(torch, dev, rt, dep, toks, alone):
    """Part 5: a blue/green replan to a bucket set the live chain lacks
    while a thread keeps sending one-row requests; no request fails, the
    canary passes, the first 8 requests after the swap build nothing and
    answer as blue did.  Returns the numbers and blue's tokens."""
    import numpy as np

    from repro_torch.core.lowering import EXECUTABLE_CACHE
    from repro_torch.profiling import (BlueGreenReplanner, NodeConfig,
                                       PlanConfig, replan)

    node, op_id = _chain_op_id(dep)
    proposal = PlanConfig(nodes={op_id: NodeConfig(
        max_batch=SERVE_BATCH, batch_buckets=PLAN_GREEN_BUCKETS,
        batch_wait_ms=SERVE_WAIT_MS, batched_lowering=True)})
    check(tuple(dep.plan.op(op_id).op.bucket_sizes) != PLAN_GREEN_BUCKETS,
          f"the proposal's buckets {PLAN_GREEN_BUCKETS} differ from the live "
          f"chain's {tuple(dep.plan.op(op_id).op.bucket_sizes)}: a recompile")
    n = PLAN_PROMPTS
    blue_tok, blue_lat = [], []
    for i in range(n):
        t0 = time.perf_counter()
        blue_tok.append(_tokens([dep.execute(_sample(torch, toks, i))])[0])
        blue_lat.append(time.perf_counter() - t0)
    check(blue_tok == alone, f"blue's one-row tokens == the unfused loop's "
          f"{alone}")
    stop, log, errors = threading.Event(), [], []

    def sender():
        i = 0
        while not stop.is_set():
            t0 = time.perf_counter()
            f = dep.execute(_sample(torch, toks, i % n))
            try:
                tok = int(f.result(600).rows[0].values[0])
            except Exception as e:      # reported, and fails the check
                errors.append(repr(e))
                tok = None
            log.append((t0, time.perf_counter(), i % n, tok))
            i += 1

    mem = {}
    inner = replan.warm_deployment

    def measured_warm(*a, **k):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        try:
            return inner(*a, **k)
        finally:
            torch.cuda.synchronize(dev)
            mem["warm_allocated_growth"] = \
                torch.cuda.memory_allocated(dev) - held
            mem["warm_peak_growth"] = \
                torch.cuda.max_memory_allocated(dev) - held

    blue_dag = dep.dag
    th = threading.Thread(target=sender, daemon=True)
    th.start()
    _wait_for(lambda: len(log) >= 2, "two requests before the replan")
    replan.warm_deployment = measured_warm
    try:
        t_r0 = time.perf_counter()
        rep = BlueGreenReplanner(rt, dep,
                                 sample=_sample(torch, toks, 0)).replan(
            proposal)
        t_r1 = time.perf_counter()
    finally:
        replan.warm_deployment = inner
    _wait_for(lambda: any(t0 > t_r1 for t0, _, _, _ in log),
              "a request after the swap")
    stop.set()
    th.join(600)
    check(not th.is_alive(), "the sending thread ended")
    check(rep.ok and rep.canary.get("ok") is True and dep.dag is not blue_dag
          and rt.dags[dep.dag.name] is dep.dag,
          f"replan {rep.phase}: canary {rep.canary}, swap to generation "
          f"{rep.green_generation} (blue {rep.blue_generation}); warm "
          f"{rep.warm.get('buckets')}, {rep.warm.get('fresh_traces')} "
          f"executables built")
    wrong = [(i, tok) for _, _, i, tok in log if tok != alone[i]]
    check(not errors and not wrong, f"{len(log)} one-row requests across "
          f"the replan: none failed ({errors}), none answered wrong "
          f"({wrong})")
    before = [t1 - t0 for t0, t1, _, _ in log if t1 <= t_r0]
    during = [t1 - t0 for t0, t1, _, _ in log if t1 > t_r0 and t0 < t_r1]
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    tr0 = EXECUTABLE_CACHE.traces()
    post_tok, post_lat = [], []
    for i in range(8):
        t0 = time.perf_counter()
        post_tok.append(_tokens([dep.execute(
            _sample(torch, toks, i % n))])[0])
        post_lat.append(time.perf_counter() - t0)
        if i == 0:
            gc.collect()        # the request's result sits in a cycle
            torch.cuda.synchronize(dev)
            first_alloc = torch.cuda.memory_allocated(dev) - held
            first_peak = torch.cuda.max_memory_allocated(dev) - held
    built = EXECUTABLE_CACHE.traces() - tr0
    check(built == 0, "fresh_traces == 0 over 8 post-swap requests")
    want = [blue_tok[i % n] for i in range(8)]
    if post_tok != want:
        raise SmokeFailure(f"post-swap tokens {post_tok} != blue's {want}")
    check(True, f"post-swap tokens == blue's for the same prompts {want}")

    def p99(x):
        return float(np.percentile(np.array(x), 99)) if x else None

    res = {"timings_s": rep.timings_s, "warm": rep.warm, **mem,
           "first_post_swap": {"latency_s": post_lat[0],
                               "allocated_growth": first_alloc,
                               "peak_growth": first_peak},
           "post_swap_latency_s": post_lat,
           "blue_steady_latency_s": min(blue_lat[1:]),
           "requests_across": len(log),
           "p99_before_s": p99(before), "p99_during_s": p99(during),
           "during": len(during)}
    print(f"  blue/green: compile {rep.timings_s.get('compile')} s, warm "
          f"{rep.timings_s.get('warm')} s, canary "
          f"{rep.timings_s.get('canary')} s; warm grew allocated "
          f"{mem.get('warm_allocated_growth')} and peak "
          f"{mem.get('warm_peak_growth')} bytes (one-row requests ran "
          f"beside it); first post-swap request {post_lat[0]} s against "
          f"blue's steady {min(blue_lat[1:])} s, grew allocated "
          f"{first_alloc} and peak {first_peak} bytes; live p99 "
          f"{p99(during)} s during the replan ({len(during)} requests) "
          f"against {p99(before)} s before ({len(before)})", flush=True)
    return res, blue_tok


def _one_weight_changed(params):
    """The params with the first element of layer 0's key projection
    scaled by 1.5; only that leaf is copied."""
    blocks = dict(params["blocks"])
    b0 = dict(blocks["0"])
    attn = dict(b0["attn"])
    attn["wk"] = attn["wk"].clone()
    attn["wk"].view(-1)[0] *= 1.5
    b0["attn"] = attn
    blocks["0"] = b0
    return dict(params, blocks=blocks)


def _plan_drill(torch, dev, rt, dep, model, params, toks, blue_tok):
    """Part 6: a green whose decode op holds params with one weight
    changed: the canary aborts the replan with a mismatch, blue keeps
    answering as before, green's batchers are closed and the card's
    allocated bytes return to within ``PLAN_DRILL_SLACK`` of their value
    before the attempt."""
    import copy

    from repro_torch.examples import decode_cascade as dc
    from repro_torch.profiling import (BlueGreenReplanner, NodeConfig,
                                       PlanConfig)

    name = dep.dag.name
    _, op_id = _chain_op_id(dep)
    pre, _ = dc.build_ops(model, params, seq_len=SEQ, cache_len=CACHE,
                          name=model.cfg.name, measure=False)
    _, bad_dec = dc.build_ops(model, _one_weight_changed(params),
                              seq_len=SEQ, cache_len=CACHE,
                              name=model.cfg.name, measure=False)
    drill = copy.copy(dep)
    drill.flow = dc.build_flow(pre, bad_dec, steps=STEPS, batching=True)
    blue_dag = dep.dag
    gc.collect()
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    rep = BlueGreenReplanner(rt, drill, sample=_sample(torch, toks, 0)) \
        .replan(PlanConfig(nodes={op_id: NodeConfig(
            max_batch=SERVE_BATCH, batch_buckets=PLAN_SWEEP,
            batch_wait_ms=SERVE_WAIT_MS, batched_lowering=True)}))
    drill_s = time.perf_counter() - t0
    err = str(rep.canary.get("error"))
    check(not rep.ok and rep.phase == "canary" and "mismatch" in err,
          f"the replan aborted in {drill_s} s: {rep.reason}")
    check(dep.dag is blue_dag and rt.dags[name] is blue_dag
          and _tokens([dep.execute(_sample(torch, toks, 1))])[0]
          == blue_tok[1], "blue stays live and answers as before")
    _wait_for(lambda: rt.sweep_retired() == 0, "green's batchers drained")
    with rt._batchers_lock:
        gens = {k[1] for k in rt._batchers if k[0] == name}
    check(rep.green_generation not in gens and not rt._retired_batchers,
          f"green's batchers (generation {rep.green_generation}) closed; "
          f"live generations {sorted(gens)}")
    gc.collect()
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    check(abs(after - held) <= PLAN_DRILL_SLACK,
          f"discard_dag: allocated {after} bytes within "
          f"{PLAN_DRILL_SLACK} of the {held} before the attempt")
    return {"seconds": drill_s, "error": err, "timings_s": rep.timings_s,
            "allocated_before": held, "allocated_after": after}


def _plan_planner(torch, dev, rt, model, params, toks, alone):
    """Part 7: ``auto_deploy`` of the cascade flow with a 1-row sample on
    the card: the plan's flags, notes and per-node cv (the profile keeps
    the reference's ``warmup=0``), and the deployed flow's tokens."""
    from repro_torch.core.planner import auto_deploy
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc

    pre, dec = dc.build_ops(model, params, seq_len=SEQ, cache_len=CACHE,
                            name=model.cfg.name, measure=False)
    fl = dc.build_flow(pre, dec, steps=STEPS)
    sample = Table([("tokens", torch.Tensor)], [(toks[0].to(dev),)])
    t0 = time.perf_counter()
    dep, plan = auto_deploy(fl, rt, sample, runs=3)
    plan_s = time.perf_counter() - t0
    profiles = {str(k): {"mean_s": p.mean_s, "cv": p.cv,
                         "out_bytes": p.out_bytes}
                for k, p in sorted(plan.profiles.items())}
    print(f"  planner in {plan_s} s: flags {json.dumps(plan.flags)}; notes "
          f"{json.dumps(plan.notes)}; profiles {json.dumps(profiles)}",
          flush=True)
    t0 = time.perf_counter()
    got = _tokens([dep.execute(sample)])
    serve_s = time.perf_counter() - t0
    check(got == [alone[0]], f"auto-deployed cascade ({len(dep.plan.ops)} "
          f"ops) answers {got} == the unfused loop's [{alone[0]}] in "
          f"{serve_s} s")
    return {"seconds": plan_s, "flags": plan.flags, "notes": plan.notes,
            "replicas": {str(k): v for k, v in plan.replicas.items()},
            "profiles": profiles, "ops": len(dep.plan.ops),
            "serve_s": serve_s}


# -- phase 8: llama-3.2-vision-11b through ServingEngine, the video pipeline --

VLM = "llama-3.2-vision-11b"
#: the cross gates' value for the media check: the reference initialises
#: them to 0, and tanh(0) = 0 would hide the media
VLM_GATE = 0.5
#: depth of the vlm's f32 token check: one block, four plain layers and
#: one cross layer
VLM_F32_LAYERS = 5
VIDEO_FRAMES = 6


def _open_gates(params, value):
    for blk in params["blocks"].values():
        if "cross" in blk:
            blk["cross"]["gate"].fill_(value)


def _vlm_batch(torch, dev, cfg, dtype):
    """4 prompts of 256 tokens and 1601 media tokens of seeded randn x 0.1
    (the stub vision frontend's patch embeddings)."""
    toks = torch.randint(0, cfg.vocab_size, (PROMPTS, SEQ), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 1))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    media = 0.1 * torch.randn((PROMPTS, cfg.num_media_tokens, cfg.d_model),
                              generator=g, device=dev)
    return {"tokens": toks.to(dev), "media": media.to(dtype)}


def phase_families(torch, dev, smi):
    """Phase 8: full-width llama-3.2-vision-11b (bf16, both kernels, its
    cross gates set to ``VLM_GATE``) through ``ServingEngine.generate``
    with media (4 prompts x 256 tokens, 1601 media tokens, ``STEPS`` new
    tokens): the kernels launched as the engine needs them, the media
    move the logits, the kernel path's logits (prefill and first decode)
    within rel 0.05 of the plain path's; the paper's video pipeline on
    the same weights (``VIDEO_FRAMES`` frames, per-frame latency beside
    the 1 s budget, labels per frame, one SLO-controller tick); then at
    f32 and ``VLM_F32_LAYERS`` layers the kernel path's greedy tokens
    equal the plain path's.  Prints each part's peak allocation."""
    from repro_torch.configs import get_config
    from repro_torch.examples import video_pipeline as vp
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_config(VLM), use_kernels=True)
    L = cfg.num_layers
    print(f"-- {cfg.name}: {L} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, cross every "
          f"{cfg.cross_attn_period}, {cfg.num_media_tokens} media tokens, "
          f"{cfg.dtype}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    _open_gates(params, VLM_GATE)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    batch = _vlm_batch(torch, dev, cfg, torch.bfloat16)
    engine = ServingEngine(model, cache_len=CACHE)
    engine.generate(params, batch, STEPS)                  # warm
    _zero_launches()
    t0 = time.perf_counter()
    got = engine.generate(params, batch, STEPS)
    gen_s = time.perf_counter() - t0
    launches = _launches()
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=L, decode_attention=L * STEPS)
    check(launches == want, f"generate with media: launches {launches} == "
          f"{want} (one prefill, {STEPS} decode steps)")
    check(got.shape == (PROMPTS, STEPS) and 0 <= got.min()
          and got.max() < cfg.vocab_size,
          f"generate: {got.shape} tokens in range: {got.tolist()}")

    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=dev)
    side, nxt = {}, None
    for name, m in (("kernel", model), ("plain", plain)):
        logits, cache = m.prefill(params, batch, CACHE)
        if nxt is None:          # both paths decode the kernel path's token
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full((PROMPTS,), SEQ, dtype=torch.int32, device=dev)
        step, _ = m.decode_step(params, nxt[:, None], pos, cache)
        side[name] = (logits[:, -1].clone(), step[:, -1].clone())
        del logits, cache, step
    # the media's effect, read on one path: the same prefill again, with
    # the media and without
    again, _ = model.prefill(params, batch, CACHE)
    text, _ = model.prefill(params, {"tokens": batch["tokens"]}, CACHE)
    e_pre = rel_err(side["kernel"][0], side["plain"][0])
    e_dec = rel_err(side["kernel"][1], side["plain"][1])
    e_repeat = rel_err(again[:, -1], side["kernel"][0])
    e_media = rel_err(text[:, -1], side["kernel"][0])
    check(max(e_pre, e_dec) < BF16_REL, f"{L}-layer logits with media, "
          f"kernel vs plain path: rel err {e_pre} (prefill), {e_dec} "
          f"(first decode) < {BF16_REL}")
    check(e_media > max(100 * e_repeat, 1e-3),
          f"the media move the logits on the kernel path: rel {e_media} "
          f"against text alone, where the same prefill repeated moves them "
          f"by {e_repeat}")
    del plain, text, again
    gen_peak = torch.cuda.max_memory_allocated(dev)
    print(f"  {cfg.name}: {nbytes} bytes of weights; generate ({PROMPTS} x "
          f"{SEQ} tokens with media, {STEPS} new) {gen_s * 1e3} ms; peak "
          f"device memory {gen_peak} bytes, {gen_peak - held} above the "
          f"{held} held before", flush=True)

    # the paper's video pipeline on the full-width detector
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    r = vp.run(frames=VIDEO_FRAMES, arch=VLM, tiny=False, device=dev,
               params=params, hang_timeout_s=PATH_HANG_TIMEOUT_S)
    v_launch = _launches()
    video_peak = torch.cuda.max_memory_allocated(dev)
    for i, (ms, c) in enumerate(zip(r["frame_ms"], r["counts"])):
        print(f"  video frame {i}: {ms} ms (budget {vp.BUDGET_MS} ms) "
              f"{c}", flush=True)
    print(f"  video: median {r['median_ms']} ms, p99 {r['p99_ms']} ms "
          f"against the paper's {vp.BUDGET_MS} ms budget; "
          f"labels_per_frame {r['labels_per_frame']}; controller "
          f"{r['controller']} {r['controller_detail']}; launches "
          f"{v_launch}; peak device memory {video_peak} bytes", flush=True)
    check(r["frames"] == VIDEO_FRAMES and r["labels_per_frame"] > 0
          and all(sum(d["count"] for d in c) == 2 for c in r["counts"]),
          f"video: {VIDEO_FRAMES} frames, each one person and one vehicle "
          f"label")
    check(v_launch["flash_attention"] > 0
          and v_launch["flash_attention"] % L == 0
          and v_launch["decode_attention"] == 0,
          f"video: the detector ran flash attention per layer "
          f"({v_launch})")
    del model, params, engine
    _release(torch)

    # float32 at one block: greedy tokens equal
    cfg32 = dataclasses.replace(cfg, num_layers=VLM_F32_LAYERS,
                                dtype="float32")
    model32 = build_model(cfg32, device=dev)
    params32 = model32.init(torch.Generator(device=dev).manual_seed(SEED))
    _open_gates(params32, VLM_GATE)
    batch32 = _vlm_batch(torch, dev, cfg32, torch.float32)
    got32 = ServingEngine(model32, cache_len=CACHE).generate(
        params32, batch32, STEPS)
    plain32 = build_model(dataclasses.replace(cfg32, use_kernels=False),
                          device=dev)
    want32 = ServingEngine(plain32, cache_len=CACHE).generate(
        params32, batch32, STEPS)
    check((got32 == want32).all(), f"f32 {VLM_F32_LAYERS}-layer kernel-path "
          f"tokens {got32.tolist()} == plain-path tokens {want32.tolist()}")
    del model32, params32, plain32
    print("families: " + json.dumps({
        "model": cfg.name, "generate_ms": gen_s * 1e3,
        "logits_rel_err": [e_pre, e_dec], "media_rel": e_media,
        "repeat_rel": e_repeat,
        "peak_bytes": {"generate": gen_peak, "video": video_peak},
        "video": {k: r[k] for k in ("frames", "median_ms", "p99_ms",
                                    "frame_ms", "labels_per_frame",
                                    "controller")},
        "smi": smi}), flush=True)


# -- phase 9: the MoE family and whisper at full width ------------------------

#: per arch: the bf16 path's depth (None: full), the f32 token check's
#: depth.  One arctic layer is 27.2 GB in bf16 (its experts 26.8 GB), so
#: two fit the card, and one in f32 (55.4 GB); one llama4 block (a dense
#: layer, then a MoE layer with its shared expert) is 35.0 GB in bf16 and
#: 70.1 GB in f32.  whisper-medium runs at full depth (24 + 24 layers).
FAMILIES2 = (("arctic-480b", 2, 1), ("llama4-maverick-400b-a17b", 2, 2),
             ("whisper-medium", None, 24), (DS_ARCH, None, 2))
#: the served MoE layer against the masked combine in f32
MOE_F32_REL = 1e-5
#: the MoE kernels' load-balance loss against the eager router's: the
#: same sums of probabilities and products, taken in other orders
MOE_AUX_REL = 1e-5


def _routes(torch, fn):
    """Call ``fn`` with every MoE router call recorded: (its result, the
    experts each token took at each MoE layer, in call order, each
    [tokens, k] sorted)."""
    from repro_torch.models import moe

    with moe.recorded_routes() as seen:
        out = fn()
    return out, [torch.sort(e, dim=-1).values for e in seen]


def _held_rows(torch, fwd, dec):
    """The token rows whose logits depend only on routes the two paths
    share.  ``fwd`` and ``dec`` are (kernel, plain) lists of the experts
    each token took at each MoE layer, in layer order, for the forward
    over the prompts and for a decode step after it.  A row depends on its
    own token's routes at every MoE layer and, through the attention of
    the layers after, on the routes of the earlier tokens of its prompt at
    every MoE layer but the last.  Returns (forward rows held [B*S],
    decode rows held [B], (token, layer) routes that differ, routes in
    all)."""
    def same(a, b):
        return torch.stack([(x == y).all(-1) for x, y in zip(a, b)])

    f = same(*fwd).reshape(len(fwd[0]), PROMPTS, -1)     # [layers, B, S]
    d = same(*dec)                                        # [layers, B]
    early = f[:-1].all(0)             # all True with a single MoE layer
    prefix = torch.cummin(early.int(), dim=1).values.bool()
    fwd_held = (f.all(0) & prefix).reshape(-1)
    dec_held = d.all(0) & early.all(1)
    differ = int((~f).sum()) + int((~d).sum())
    return fwd_held, dec_held, differ, f.numel() + d.numel()


def moe_kernel_vs_plain(torch, dev, cfg, params, toks):
    """The kernel path's logits against the plain path's on a MoE model,
    the same params and prompts: every position's logits of the full
    forward, and the first decode step's.  A top-k route is
    discontinuous, so a last-bit difference in a hidden state can send a
    token to another expert; the rel 0.05 bar holds on the token rows
    whose logits depend only on routes both paths share
    (``_held_rows``: the token's own routes at every MoE layer, and the
    earlier tokens' at every MoE layer but the last), and the other rows
    and the differing routes are printed (the forward must hold some
    rows; a decode row may hold none).  Checks the launches (flash per
    layer for the forward and the prefill, decode per layer for the step;
    none on the plain side).  Returns the held rows' rel err (forward,
    first decode; None where no row is held)."""
    from repro_torch.models import build_model

    model = build_model(cfg, device=dev)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=dev)
    L = cfg.num_layers
    nxt = None
    pos = torch.full((PROMPTS,), SEQ, dtype=torch.int32, device=dev)
    out = {}
    for side, m in (("plain", plain), ("kernel", model)):
        _zero_launches()
        logits, r_fwd = _routes(
            torch, lambda: m.logits(params, {"tokens": toks}))
        first, cache = m.prefill(params, {"tokens": toks}, CACHE)
        if nxt is None:          # both paths decode the plain path's token
            nxt = first[:, -1].argmax(-1).to(torch.int32)[:, None]
        (step, _), r_dec = _routes(
            torch, lambda: m.decode_step(params, nxt, pos, cache))
        out[side] = (logits.reshape(-1, logits.shape[-1]), step[:, -1],
                     r_fwd, r_dec, _launches())
        del logits, first, cache, step
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=2 * L, decode_attention=L)
    check(out["kernel"][4] == want
          and out["plain"][4] == dict.fromkeys(KERNELS, 0),
          f"{L} layers, a forward, a prefill and a decode step: kernel side "
          f"launches {out['kernel'][4]} == {want}, plain side none")
    held = _held_rows(torch, (out["kernel"][2], out["plain"][2]),
                      (out["kernel"][3], out["plain"][3]))
    print(f"  routes: {held[2]} of {held[3]} (token, MoE layer) routes "
          f"differ between the paths (the forward and a decode step)",
          flush=True)
    errs = []
    for what, i in (("forward", 0), ("first decode", 1)):
        rows, k_rows, p_rows = held[i], out["kernel"][i], out["plain"][i]
        n = int(rows.sum())
        e = rel_err(k_rows[rows], p_rows[rows]) if n else None
        rest = (rel_err(k_rows[~rows], p_rows[~rows])
                if n < rows.numel() else None)
        print(f"  {what}: {n} of {rows.numel()} token rows held (their "
              f"logits depend only on routes both paths share): rel err "
              f"{e}; the other rows {rest}", flush=True)
        if what == "forward":
            check(n > 0, f"{what}: {n} rows held")
        errs.append(e)
    return tuple(errs)


def moe_layer_check(torch, dev, cfg, params, bar):
    """The MoE layer on the card at full width: the served ``moe_apply``
    against the plain ``moe_apply_reference`` on the same seeded hidden
    states (the first MoE layer's params of ``params``), at the prefill's
    ``PROMPTS * SEQ`` tokens and a decode step's ``PROMPTS``: rel err
    within ``bar``, the aux loss equal (within ``MOE_AUX_REL`` where the
    served layer takes the MoE kernels, which sum it in other orders);
    on the kernels' path, one call's launch calls exactly
    ``moe_call_launches``; prints each one's time (CUDA events) and the
    bytes of expert weights each reads (the served path only its routed
    experts', the masked combine all E)."""
    from repro_torch.interop import torch_dtype
    from repro_torch.kernels import moe as kmoe
    from repro_torch.models import layer_ops, moe, transformer

    blk = str(next(key for key, sp, _ in transformer.layer_slots(cfg)
                   if sp.is_moe))
    lp = {k: v[0] for k, v in params["blocks"][blk]["moe"].items()}
    per_expert = sum(w[0].numel() * w.element_size()
                     for name, w in lp.items() if name != "router")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    dt = torch_dtype(cfg.dtype)
    rows = {}
    for label, S in (("prefill", SEQ), ("decode", 1)):
        x = torch.randn((PROMPTS, S, cfg.d_model), generator=g,
                        device=dev).to(dt)
        got, aux = moe.moe_apply(x, lp, cfg)
        want, aux_ref = moe.moe_apply_reference(x, lp, cfg)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        T = PROMPTS * S
        fused = layer_ops.layer_ops(cfg, None).moe_route is kmoe.moe_route
        aux_ok = (rel_err(aux, aux_ref) <= MOE_AUX_REL if fused
                  else torch.equal(aux, aux_ref))
        check(bool(torch.isfinite(got).all()) and err <= bar and aux_ok,
              f"{cfg.name} {cfg.dtype} MoE layer, T {T}: served moe_apply "
              f"vs moe_apply_reference rel err {err} <= {bar}, aux "
              f"{float(aux)} against {float(aux_ref)}")
        if fused:
            # the eager composition on the same input, for its own gap
            with _plain(layer_ops.MOE):
                eager_err = rel_err(moe.moe_apply(x, lp, cfg)[0], want)
            n, _ = _profile_call(torch, lambda: moe.moe_apply(x, lp, cfg))
            # in bf16 each grouped product is one CUTLASS kernel and its
            # data launch; in f32 torch runs it expert by expert
            if cfg.dtype == "bfloat16":
                check(n == moe_call_launches(cfg),
                      f"{cfg.name} {cfg.dtype} MoE layer, T {T}: {n} launch "
                      f"calls a call on the kernels' path == "
                      f"{moe_call_launches(cfg)}")
            print(f"  MoE layer {label}: {n} launch calls a call; the eager "
                  f"composition's rel err against moe_apply_reference on "
                  f"the same input {eager_err}", flush=True)
        used = int(torch.unique(moe._router(
            x.reshape(-1, cfg.d_model), lp["router"],
            cfg.num_experts_per_tok)[1]).numel())
        served_ms = time_ms(torch, lambda: moe.moe_apply(x, lp, cfg),
                            iters=5, warmup=1)
        ref_ms = time_ms(torch, lambda: moe.moe_apply_reference(x, lp, cfg),
                         iters=2, warmup=1)
        rows[label] = {"T": T, "rel_err": err, "served_ms": served_ms,
                       "reference_ms": ref_ms, "experts_used": used,
                       "served_expert_bytes": used * per_expert,
                       "reference_expert_bytes":
                           cfg.num_experts * per_expert}
        print(f"  MoE layer {label} (T {T}, {cfg.dtype}): served "
              f"{served_ms} ms reading {used} of {cfg.num_experts} experts,"
              f" {used * per_expert} bytes; masked combine {ref_ms} ms "
              f"reading {cfg.num_experts * per_expert} bytes", flush=True)
    print("moe_layer: " + json.dumps({"model": cfg.name, "dtype": cfg.dtype,
                                      **rows}), flush=True)
    return rows


def phase_expert_quant(torch, dev, cfg):
    """``expert_quant``: the same model drawn from the seed with its expert
    stacks in int8 (``init`` quantizes each stack as it is drawn), served
    through the cascade: launches as the path needs them, no re-trace on
    the repeat calls, fused tokens equal to the unfused loop."""
    from repro_torch.examples import decode_cascade as dc

    torch.cuda.reset_peak_memory_stats(dev)
    cfg_q = dataclasses.replace(cfg, expert_quant=True)
    model, params, toks, got, lats, retraces, dispatches, launches = serve(
        torch, dev, cfg_q)
    int8 = sum(t.numel() for t in _leaves(params) if t.dtype == torch.int8)
    want = expected_launches(cfg_q, sum(dispatches), STEPS)
    check(launches == want, f"expert_quant: launches {launches} == {want}")
    check(retraces[1:] == [0, 0], f"expert_quant: re-traces per call "
          f"{retraces}")
    ref = dc.reference_decode(model, params, toks, steps=STEPS,
                              cache_len=CACHE)
    check(got == ref, f"expert_quant: fused cascade tokens == unfused loop "
          f"{ref}")
    print(f"  expert_quant: {int8} bytes of int8 experts; latency first "
          f"{lats[0] * 1e3} ms, steady {min(lats) * 1e3} ms; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev)} bytes",
          flush=True)
    del model, params
    _release(torch)


def _ds_serve(torch, model, params, prompts, steps, cache_len):
    """Logits [N, steps + 1, V] (f32), greedy tokens [N, steps + 1] and
    each MoE call's routes (experts [T, k]) of a prefill and ``steps``
    decode steps: the functions the cascade's stages call
    (``Model.prefill``, ``Model.decode_step``), each step's token the
    argmax of the last logits."""
    from repro_torch.models import moe

    with moe.recorded_routes() as routes:
        lg, cache = model.prefill(params, {"tokens": prompts}, cache_len)
        logits = [lg[:, -1].float()]
        pos = torch.full((prompts.shape[0],), prompts.shape[1],
                         dtype=torch.int32, device=prompts.device)
        for _ in range(steps):
            tok = logits[-1].argmax(-1).to(torch.int32)[:, None]
            lg, cache = model.decode_step(params, tok, pos, cache)
            logits.append(lg[:, -1].float())
            pos = pos + 1
    logits = torch.stack(logits, 1)
    return logits, logits.argmax(-1).to(torch.int32), routes


def _ds_reference(torch, params, cfg, seq, positions, quant=None):
    """The plain reference's logits at ``positions`` of each sequence of
    ``seq``, ``DS_BLOCK`` sequences at a time, and with ``quant`` None
    each block's MoE layers' (experts, probabilities, router input)."""
    from repro_torch.reference import deepseek_moe as ref

    out, info = [], []
    for i in range(0, seq.shape[0], DS_BLOCK):
        routes = [] if quant is None else None
        out.append(ref.logits_at(params, cfg, seq[i:i + DS_BLOCK],
                                 positions, quant=quant, routes=routes))
        if routes is not None:
            info.append(routes)
    return torch.cat(out), info


def _moe_step(torch, dev, model, params, cfg, smi):
    """Full-width deepseek-moe-16b: a prefill of [B, ``DS_SEQ``] tokens
    and a decode step after it at B 1 and 8, each with the MoE layers on
    their kernels (the path) and eager (:func:`_plain` of the MoE's
    fields, everything else alike): launch calls and the device's busy ms
    per call (profiler), the host's enqueue ms and the event ms per call,
    and the logits' rel gap between the two (printed; the reference check
    after holds the path to the float32 reference)."""
    from repro_torch.models import layer_ops

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = {}
    for B in (1, 8):
        toks = torch.randint(0, cfg.vocab_size, (B, DS_SEQ), generator=g,
                             device=dev, dtype=torch.int32)
        logits, cache = model.prefill(params, {"tokens": toks}, DS_CACHE)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((B,), DS_SEQ, dtype=torch.int32, device=dev)
        del logits
        calls = {"prefill": lambda: model.prefill(
                     params, {"tokens": toks}, DS_CACHE)[0][:, -1],
                 "decode": lambda: model.decode_step(params, tok, pos,
                                                     cache)[0][:, -1]}
        for what, fn in calls.items():
            res = {}
            for mode in ("eager MoE", "MoE kernels"):
                with _plain(layer_ops.MOE if mode == "eager MoE" else ()):
                    first = fn().float()
                    torch.cuda.synchronize()
                    launches, busy = _profile_call(torch, fn)
                    iters = 3 if what == "prefill" else 10
                    host = host_ms(torch, fn, iters=iters)
                    ev_ms = time_ms(torch, fn, iters=iters, warmup=1)
                res[mode] = {"launch_calls": launches, "host_ms": host,
                             "device_busy_ms": busy, "ms": ev_ms,
                             "logits": first}
            gap = rel_err(res["MoE kernels"]["logits"],
                          res["eager MoE"]["logits"])
            for mode, r in res.items():
                r.pop("logits")
                print(f"  {DS_ARCH} {what} B {B}, {mode}: "
                      f"{r['launch_calls']} launch calls, host "
                      f"{r['host_ms']:.3f} ms, device busy "
                      f"{r['device_busy_ms']:.3f} ms, events "
                      f"{r['ms']:.3f} ms", flush=True)
            out[f"{what} B {B}"] = {**res, "logit_rel_gap": gap}
        del cache
    print("moe_step: " + json.dumps({"device": smi, "calls": out}),
          flush=True)


def phase_deepseek_reference(torch, dev, smi):
    """deepseek-moe-16b at full width and depth against its plain float32
    reference (``repro_torch.reference.deepseek_moe``) at its cell's
    shapes: ``DS_PROMPTS`` random prompts of ``DS_SEQ`` tokens, a prefill
    and ``DS_STEPS`` greedy decode steps through a ``DS_CACHE``-slot cache
    (bf16, kernels on), then the reference over each prompt and its served
    tokens in float32 and on float8 operands (the control).  First, on
    the same model, the MoE kernels against the eager MoE in a prefill and
    a decode step (``_moe_step``).  At each
    served position: ``rel``, the logits' max |served - reference| over
    max |reference|, held to BF16_REL (the reference package's bar for
    bfloat16); ``gap``, the reference's best logit less the served
    token's, held to DS_GAP_TOL; the same two of the control; the share of
    the position's routes that the served path took as the reference did;
    and the reference's smallest router margin over the MoE layers (its
    k-th largest logit less its (k+1)-th) beside ``bf16_round``, the
    largest change of a router logit that rounding the router's input to
    bfloat16 makes there.  Checks: a position over a tolerance only where
    that margin lies within the rounding (a route that rounding alone can
    flip), and the control over a tolerance at some position.  Prints a
    ``deepseek_reference:`` JSON line."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(DS_ARCH), use_kernels=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    _moe_step(torch, dev, model, params, cfg, smi)
    N, S, steps, k = DS_PROMPTS, DS_SEQ, DS_STEPS, cfg.num_experts_per_tok
    prompts = torch.randint(0, cfg.vocab_size, (N, S), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(
                                SEED + 1)).to(dev)
    t = time.perf_counter()
    got, toks, routes = _ds_serve(torch, model, params, prompts, steps,
                                  DS_CACHE)
    serve_s = time.perf_counter() - t
    seq = torch.cat([prompts, toks[:, :-1]], 1)
    c = dataclasses.asdict(cfg)
    positions = range(S - 1, S + steps)
    t = time.perf_counter()
    want, info = _ds_reference(torch, params, c, seq, positions)
    ctl, _ = _ds_reference(torch, params, c, seq, positions,
                           quant="fp8")
    ref_s = time.perf_counter() - t
    n_moe = cfg.num_layers - cfg.first_k_dense
    router_w = params["blocks"]["1"]["moe"]["router"]
    rows = []
    for n in range(N):
        blk, r = divmod(n, DS_BLOCK)
        for s in range(steps + 1):
            p = S - 1 + s                     # the position in seq
            g, w, q = got[n, s], want[n, s], ctl[n, s]
            same, margin, rnd = 0.0, float("inf"), 0.0
            for layer in range(n_moe):
                top_i, probs, u = info[blk][layer]
                t_ref = r * seq.shape[1] + p
                served = (routes[layer].reshape(N, S, k)[n, p] if s == 0
                          else routes[n_moe * s + layer][n])
                same += float(torch.equal(torch.sort(served).values,
                                          torch.sort(top_i[t_ref]).values))
                z = torch.log(probs[t_ref]).sort(descending=True).values
                margin = min(margin, float(z[k - 1] - z[k]))
                d = (u[t_ref].to(torch.bfloat16).float() - u[t_ref]) \
                    @ router_w[layer].float()
                rnd = max(rnd, 2 * float(d.abs().max()))
            row = {"prompt": n, "step": s, "rel": rel_err(g, w),
                   "gap": float(w.max() - w[int(g.argmax())]),
                   "ctl_rel": rel_err(q, w),
                   "ctl_gap": float(w.max() - w[int(q.argmax())]),
                   "routes": same / n_moe, "margin": margin,
                   "bf16_round": rnd}
            rows.append(row)
            print("  " + json.dumps(row), flush=True)
    over = [r for r in rows if r["rel"] > BF16_REL or r["gap"] > DS_GAP_TOL]
    unexplained = [(r["prompt"], r["step"]) for r in over
                   if r["margin"] > r["bf16_round"]]
    ctl_over = [r for r in rows if r["ctl_rel"] > BF16_REL
                or r["ctl_gap"] > DS_GAP_TOL]
    summary = {
        "model": DS_ARCH, "positions": len(rows),
        "max_rel": max(r["rel"] for r in rows),
        "max_gap": max(r["gap"] for r in rows),
        "ctl_max_rel": max(r["ctl_rel"] for r in rows),
        "ctl_max_gap": max(r["ctl_gap"] for r in rows),
        "over": [(r["prompt"], r["step"]) for r in over],
        "unexplained": unexplained, "ctl_over": len(ctl_over),
        "min_route_agreement": min(r["routes"] for r in rows),
        "serve_s": serve_s, "reference_s": ref_s, "device": smi}
    print("deepseek_reference: " + json.dumps(summary), flush=True)
    check(not unexplained, f"{DS_ARCH}: {len(over)} of {len(rows)} positions "
          f"over rel {BF16_REL} or gap {DS_GAP_TOL}, each where the "
          f"reference's router margin lies within the bf16 rounding of its "
          f"input (unexplained: {unexplained})")
    check(ctl_over, f"{DS_ARCH}: the float8 control over a tolerance at "
          f"{len(ctl_over)} of {len(rows)} positions (rel up to "
          f"{summary['ctl_max_rel']}, gap up to {summary['ctl_max_gap']})")
    del model, params
    _release(torch)
    return summary


def phase_frames(torch, dev, cfg, model, params, toks):
    """whisper with frames: ``ServingEngine.generate`` with seeded stub
    frames [PROMPTS, encoder_seq, D] (randn x 0.1) gives tokens in range,
    and the frames move the logits (the same forward repeated does not);
    each decode step passes the cross K/V on without a copy (the bytes a
    clone of them would add are printed)."""
    from repro_torch.serving import ServingEngine

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    frames = (0.1 * torch.randn((PROMPTS, cfg.encoder_seq, cfg.d_model),
                                generator=g, device=dev)).to(torch.bfloat16)
    batch = {"tokens": toks, "frames": frames}
    engine = ServingEngine(model, cache_len=CACHE)
    engine.generate(params, batch, STEPS)                  # warm
    _zero_launches()
    t0 = time.perf_counter()
    got = engine.generate(params, batch, STEPS)
    gen_s = time.perf_counter() - t0
    check(_launches() == dict.fromkeys(KERNELS, 0),
          f"generate with frames launched no kernel ({_launches()})")
    check(got.shape == (PROMPTS, STEPS) and 0 <= got.min()
          and got.max() < cfg.vocab_size,
          f"generate with frames: {got.shape} tokens in range: "
          f"{got.tolist()}")
    with_frames = model.logits(params, batch)[:, -1]
    again = model.logits(params, batch)[:, -1]
    zeros = model.logits(params, {"tokens": toks})[:, -1]
    e_frames, e_repeat = rel_err(zeros, with_frames), rel_err(again,
                                                               with_frames)
    check(e_frames > max(100 * e_repeat, 1e-3),
          f"the frames move the logits: rel {e_frames} against zero frames,"
          f" where the same forward repeated moves them by {e_repeat}")
    _, cache = model.prefill(params, batch, CACHE)
    pos = torch.full((PROMPTS,), SEQ, dtype=torch.int32, device=dev)
    _, new = model.decode_step(params, toks[:, -1:], pos, cache)
    cross = sum(cache[n].numel() * cache[n].element_size()
                for n in ("ck", "cv"))
    cloned = sum(cache[n].numel() * cache[n].element_size()
                 for n in ("k", "v", "pos"))
    check(all(new[n].data_ptr() == cache[n].data_ptr() for n in ("ck", "cv")),
          f"a decode step passes ck/cv ({cross} bytes at B {PROMPTS}) on "
          f"without a copy; it clones k/v/pos ({cloned} bytes)")
    print(f"  {cfg.name}: generate ({PROMPTS} x {SEQ} tokens with frames, "
          f"{STEPS} new) {gen_s * 1e3} ms; a clone of ck/cv would add "
          f"{cross} bytes a step", flush=True)


# -- phase 10: the serving launcher, the quickstart and the image cascade ---

def phase_entry(torch, dev, model, params, steady_s):
    """Phase 10 (see the module docstring), on phase 4's yi-9b model and
    params; ``steady_s`` is phase 4's steady cascade call.  Returns the
    flash launches of the phase's glm4-9b and granite-34b rows."""
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _part_serve_batched(torch, dev, model, params)
    glm4 = _part_quickstart(torch, dev, params)
    _release(torch)
    granite = _part_cascade(torch, dev, params)
    _release(torch)
    _part_roofline(torch, dev, model, params, steady_s)
    print(f"  entry points: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes, with the "
          f"{held} bytes of yi-9b held before the phase", flush=True)
    return {"flash_attention[glm4-9b]": glm4,
            "flash_attention[granite-34b]": granite}


def _part_serve_batched(torch, dev, model, params):
    """``serve_batched.run`` over ``launch.serve.build_flow`` at full
    width: a burst of ``ENTRY_REQUESTS`` requests on two CPU executors
    (both call the engine on the card at once), each completion held to
    ``ServingEngine.generate`` on its own prompt (a runtime batch reaches
    ``generate`` one row at a time, so its members run alone at B 1, the
    oracle's shape), and the launch counters moved by exactly what those
    calls need (the counters take a lock: a lost update would show)."""
    import numpy as np

    from repro_torch.examples import serve_batched as sb
    from repro_torch.serving import ServingEngine

    L = model.cfg.num_layers
    _zero_launches()
    r = sb.run(ENTRY_REQUESTS, arch="yi-9b", tiny=False, device=dev,
               params=params, new_tokens=ENTRY_NEW,
               hang_timeout_s=PATH_HANG_TIMEOUT_S)
    launches = _launches()
    print(f"  serve_batched (full-width {model.cfg.name}, {ENTRY_REQUESTS} "
          f"requests at once, max_batch {sb.MAX_BATCH}, batch_wait_ms "
          f"{sb.BATCH_WAIT_MS}, {ENTRY_NEW} new tokens, cache "
          f"{ENTRY_CACHE}): {r['req_per_s']} req/s, p50 {r['p50_ms']} ms, "
          f"p99 {r['p99_ms']} ms, batch sizes {r['batch_sizes']}, "
          f"launches {launches}", flush=True)
    check(r["wedges"] == 0 and sum(r["batch_sizes"]) == ENTRY_REQUESTS,
          f"serve_batched: no wedge, {ENTRY_REQUESTS} requests in batches "
          f"{r['batch_sizes']}")
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = L * ENTRY_REQUESTS
    want["decode_attention"] = L * ENTRY_NEW * ENTRY_REQUESTS
    check(launches == want, f"serve_batched launches {launches} == {want} "
          f"(a prefill and {ENTRY_NEW} decode steps a request, counted "
          f"from two executor threads)")
    engine = ServingEngine(model, cache_len=ENTRY_CACHE)
    for i, got in enumerate(r["completions"]):
        text = f"request {i}".encode()[:ENTRY_SEQ].ljust(ENTRY_SEQ)
        toks = torch.as_tensor(np.frombuffer(text, np.uint8).astype(
            np.int32) % model.cfg.vocab_size, device=dev)[None]
        want_toks = engine.generate(params, {"tokens": toks}, ENTRY_NEW)[0]
        if got != " ".join(str(int(t)) for t in want_toks):
            raise SmokeFailure(f"serve_batched request {i}: {got!r} != "
                               f"generate's {want_toks.tolist()}")
    check(True, f"serve_batched: all {ENTRY_REQUESTS} completions == "
          "ServingEngine.generate on each prompt alone")


def _near_tie(plain_logits, top, other, noise):
    """Is class ``other`` within ``noise`` of class ``top`` in one row of
    the plain path's logits (so that the two paths may order them
    either way)?"""
    return float(plain_logits[top] - plain_logits[other]) <= noise


def _logits_pair(torch, dev, cfg, params, toks):
    """The last position's logits of the kernel path and the plain path
    on the same params and prompts (one call each, at the prompts' batch),
    and the largest absolute difference between the two."""
    from repro_torch.models import build_model

    out = []
    for kernels in (True, False):
        m = build_model(dataclasses.replace(cfg, use_kernels=kernels),
                        device=dev)
        with torch.no_grad():
            out.append(m.logits(params, {"tokens": toks})[:, -1].float())
    return out[0], out[1], float((out[0] - out[1]).abs().max())


def _part_quickstart(torch, dev, yi_params):
    """The Figure-1 ensemble at full width: yi-9b (phase 4's weights),
    glm4-9b and gemma2-9b (drawn from their seeds on the card).  Each
    answer (the flow keeps only the winning confidence) is held to the
    members' kernel-path logits and to the plain path on the same
    weights: the winning member's label equal (or, where the plain path
    itself puts the two classes within the kernel path's measured logits
    gap, a near tie, printed), its confidence within rel 0.05.  Returns
    glm4-9b's flash launches in the served run, counted by its heads."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart as qs
    from repro_torch.models import build_model

    params = {qs.MODELS[0][0]: yi_params}
    for arch, seed in qs.MODELS[1:]:
        m = build_model(qs.model_config(arch, tiny=False), device=dev)
        params[arch] = m.init(torch.Generator(device=dev).manual_seed(seed))
    sizes = {a: sum(t.numel() * t.element_size() for t in _leaves(p))
             for a, p in params.items()}
    print(f"  quickstart weights (bytes): {sizes}, "
          f"{torch.cuda.memory_allocated(dev)} allocated", flush=True)
    _zero_launches()
    r = qs.run(tiny=False, device=dev, params=params)
    launches, by_heads = _launches(), _flash_by_heads()
    cfgs = {a: get_config(a) for a, _ in qs.MODELS}
    heads = {a: (1, c.num_heads, c.num_kv_heads) for a, c in cfgs.items()}
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = len(qs.URLS) * sum(c.num_layers
                                                 for c in cfgs.values())
    want_heads = {heads[a]: len(qs.URLS) * c.num_layers
                  for a, c in cfgs.items()}
    print(f"  quickstart launches {launches}, flash by (B, H, K) "
          f"{by_heads}", flush=True)
    check(launches == want and by_heads == want_heads,
          f"quickstart launches {launches} == {want}, by (B, H, K) "
          f"{by_heads} == {want_heads} (one prefill of every member a "
          f"request, {len(qs.URLS)} requests)")
    toks = torch.as_tensor(np.stack([qs.preproc(u) for u in qs.URLS]),
                           device=dev)
    kern, plain, gap = {}, {}, {}
    for arch, _ in qs.MODELS:
        cfg = qs.model_config(arch, tiny=False)
        # one url a call, at B 1 as the flow scores them
        pairs = [_logits_pair(torch, dev, cfg, params[arch], toks[u:u + 1])
                 for u in range(len(qs.URLS))]
        kern[arch] = torch.cat([k for k, _, _ in pairs])
        plain[arch] = torch.cat([p for _, p, _ in pairs])
        gap[arch] = max(g for _, _, g in pairs)
        e = rel_err(kern[arch], plain[arch])
        check(e < BF16_REL, f"quickstart {arch}: last-position logits rel "
              f"err {e} < {BF16_REL} (max abs {gap[arch]})")
    for u, (url, answer) in enumerate(zip(qs.URLS, r["answers"])):
        # the members as the flow scores them: the softmax of the last
        # position in the model's dtype, the most confident one winning
        kprobs = {a: torch.softmax(kern[a][u].to(torch.bfloat16), dim=-1)
                  for a in kern}
        arch = max(kprobs, key=lambda a: float(kprobs[a].max()))
        kconf = float(kprobs[arch].max())
        cls = int(torch.argmax(kprobs[arch]))
        label = f"{arch}:class{cls}"
        e = abs(answer["max"] - kconf) / kconf
        check(e < BF16_REL, f"{url}: the flow's answer {answer['max']} is "
              f"the kernel path's best member confidence {kconf} ({label}; "
              f"rel {e} < {BF16_REL})")
        probs = {a: torch.softmax(plain[a][u].to(torch.bfloat16), dim=-1)
                 for a in plain}
        best = max(plain, key=lambda a: float(probs[a].max()))
        conf = float(probs[best].max())
        want_label = f"{best}:class{int(torch.argmax(probs[best]))}"
        e = abs(answer["max"] - conf) / conf
        tie = label != want_label and _near_tie(
            plain[arch][u], int(torch.argmax(plain[arch][u])), cls,
            gap[arch]) and float(probs[arch][cls]) >= (1 - BF16_REL) * conf
        check((label == want_label or tie) and e < BF16_REL,
              f"{url}: {label} conf {answer['max']} ({r['ms'][u]} ms); "
              f"plain path {want_label} conf {conf} (rel {e} < "
              f"{BF16_REL}){' a NEAR TIE' if tie else ''}")
    print(f"  quickstart: ms per request {r['ms']} (full width, three "
          f"members)", flush=True)
    return by_heads[heads["glm4-9b"]]


def _part_cascade(torch, dev, yi_params):
    """The paper's image cascade: yi-9b (phase 4's weights) answers,
    granite-34b at ``GRANITE_LAYERS`` of its 88 layers (full width, drawn
    from its seed) takes the escalations.  ``CASCADE_IMAGES`` images one
    a request (the per-row path) and all in one request (the batched
    path: one dispatch of the escalation chain, its filter a mask
    column, no per-row fallback).  Labels are held to the plain path on
    the same weights (equal, or a near tie as in the quickstart).
    Returns granite-34b's flash launches on the batched path, counted by
    its heads."""
    from repro_torch.core.lowering import bucket_rows
    from repro_torch.examples import image_cascade as ic
    from repro_torch.models import build_model

    gcfg = ic.stage_config(ic.COMPLEX[0], tiny=False,
                           num_layers=GRANITE_LAYERS)
    gparams = build_model(gcfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(ic.COMPLEX[1]))
    print(f"  cascade: {gcfg.name} at {GRANITE_LAYERS} of 88 layers (depth "
          f"cut to fit beside yi-9b; width full), "
          f"{sum(t.numel() * t.element_size() for t in _leaves(gparams))} "
          f"bytes", flush=True)
    params = {ic.SIMPLE[0]: yi_params, ic.COMPLEX[0]: gparams}
    ycfg = ic.stage_config(ic.SIMPLE[0], tiny=False)
    runs, by_heads = {}, {}
    B = bucket_rows(CASCADE_IMAGES)
    for per in (1, CASCADE_IMAGES):
        _zero_launches()
        runs[per] = ic.run(CASCADE_IMAGES, tiny=False, device=dev,
                           per_request=per, params=params,
                           complex_layers=GRANITE_LAYERS,
                           hang_timeout_s=PATH_HANG_TIMEOUT_S)
        launches, by_heads[per] = _launches(), _flash_by_heads()
        # every chain call runs both stages (the filter is a mask): one
        # call a row at B 1 on the per-row path, one for the whole batch
        # at its padded bucket on the other
        calls, b = (CASCADE_IMAGES, 1) if per == 1 else (1, B)
        want = dict.fromkeys(KERNELS, 0)
        want["flash_attention"] = calls * (ycfg.num_layers + GRANITE_LAYERS)
        want_heads = {
            (b, c.num_heads, c.num_kv_heads): calls * c.num_layers
            for c in (ycfg, gcfg)}
        print(f"  cascade, {per} image(s) a request: launches {launches}, "
              f"flash by (B, H, K) {by_heads[per]}", flush=True)
        check(launches == want and by_heads[per] == want_heads,
              f"cascade, {per} image(s) a request: launches {launches} == "
              f"{want}, by (B, H, K) {by_heads[per]} == {want_heads}")
    one, batched = runs[1], runs[CASCADE_IMAGES]
    check((one["row_dispatches"], one["batch_dispatches"]) ==
          (CASCADE_IMAGES, 0) and (batched["batch_dispatches"],
                                   batched["row_dispatches"]) == (1, 0)
          and not (batched["vmap_fallback"] or batched["fallback"]
                   or one["vmap_fallback"] or one["fallback"]),
          f"escalation chain: {CASCADE_IMAGES} per-row dispatches one image "
          f"a request; ONE batched dispatch for {CASCADE_IMAGES} images "
          f"(no per-row fallback)")
    toks = torch.stack(ic.draw_images(CASCADE_IMAGES, dev))
    stages = {}
    for cfg, (arch, _, temp) in ((ycfg, ic.SIMPLE), (gcfg, ic.COMPLEX)):
        kern, plain, gap = _logits_pair(torch, dev, cfg, params[arch], toks)
        e = rel_err(kern, plain)
        check(e < BF16_REL, f"cascade {arch}: last-position logits rel err "
              f"{e} < {BF16_REL} (max abs {gap})")
        stages[arch] = (plain, gap, torch.softmax(plain / temp, dim=-1))
    want_labels, escalations = [], 0
    (sp, sgap, sprob), (cp, cgap, cprob) = stages.values()
    for i in range(CASCADE_IMAGES):
        label, conf = f"class{int(torch.argmax(sprob[i]))}", sprob[i].max()
        if conf < ic.THRESHOLD:
            escalations += 1
            if cprob[i].max() > conf:
                label = f"class{int(torch.argmax(cprob[i]))}"
        want_labels.append(label)
    for per, r in runs.items():
        ties = 0
        for i, (got, want_label) in enumerate(zip(r["labels"], want_labels)):
            if got == want_label:
                continue
            cls = int(got[len("class"):])
            tie = any(cls < p.shape[-1] and _near_tie(
                p[i], int(torch.argmax(p[i])), cls, gap)
                for p, gap in ((sp, sgap), (cp, cgap)))
            if not tie:
                raise SmokeFailure(f"cascade, {per} a request, image {i}: "
                                   f"{got} != the plain path's {want_label}")
            ties += 1
        check(True, f"cascade, {per} image(s) a request: labels "
              f"{r['labels']} == the plain path's {want_labels} "
              f"({ties} near ties); {escalations} of {CASCADE_IMAGES} "
              f"escalated on the plain path; confident answers "
              f"{r['escalated']}; median {r['median_ms']} ms a request")
    return by_heads[CASCADE_IMAGES][(B, gcfg.num_heads, gcfg.num_kv_heads)]


def _part_roofline(torch, dev, model, params, steady_s):
    """The roofline of phase 4's steady yi-9b cascade (4 x 256 prefill,
    8 decode steps over 1024 slots): ``flops.estimate`` summed over its
    calls (the reference's implementation count), its lower bound and MFU
    beside the measured steady call; and ``from_counted``'s FLOPs of one
    prefill (the plain path under a fake mode: nothing allocated) beside
    ``estimate``'s.  Fails if a share exceeds 1."""
    from repro_torch.configs import InputShape
    from repro_torch.models import build_model
    from repro_torch.roofline import analysis, flops, hw

    cfg = model.cfg
    pre = flops.estimate(cfg, InputShape("cascade_prefill", SEQ, PROMPTS,
                                         "prefill"), chips=1, mp=1)
    dec = flops.estimate(cfg, InputShape("cascade_decode", CACHE, PROMPTS,
                                         "decode"), chips=1, mp=1)
    r = analysis.Roofline(
        flops=pre.step_flops + STEPS * dec.step_flops,
        hbm_bytes=pre.hbm_bytes_per_chip + STEPS * dec.hbm_bytes_per_chip,
        coll_bytes=0.0, model_flops=pre.model_flops
        + STEPS * dec.model_flops, chips=1)
    share = r.step_time_lower_bound / steady_s
    mfu = r.model_flops / (steady_s * hw.PEAK_FLOPS_BF16)
    print("roofline: " + json.dumps({
        "cell": f"{cfg.name} cascade {PROMPTS} x {SEQ} + {STEPS} decode "
                f"steps over {CACHE} slots", **r.to_dict(),
        "step_time_lower_bound_s": r.step_time_lower_bound,
        "measured_steady_s": steady_s, "bound_share": share, "mfu": mfu}),
        flush=True)
    check(0 < share <= 1.0 and 0 < mfu <= 1.0,
          f"roofline: bound {r.step_time_lower_bound * 1e3} ms "
          f"({r.bottleneck}) is {share} of the measured steady "
          f"{steady_s * 1e3} ms; MFU {mfu}")
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=dev)
    toks = torch.zeros((PROMPTS, SEQ), dtype=torch.int32, device=dev)
    before = torch.cuda.memory_allocated(dev)
    counted = analysis.from_counted(
        lambda t: plain.prefill(params, {"tokens": t}, CACHE), toks,
        model_flops=pre.model_flops, chips=1)
    ratio = counted.flops / pre.fwd_flops
    print(f"  from_counted, one prefill: {counted.flops} FLOPs ("
          f"{ratio} of estimate's fwd_flops {pre.fwd_flops}), "
          f"{counted.hbm_bytes} bytes (estimate {pre.hbm_bytes_per_chip}), "
          f"bound {counted.step_time_lower_bound * 1e3} ms "
          f"({counted.bottleneck}), useful ratio {counted.useful_ratio}",
          flush=True)
    check(abs(ratio - 1) < 1e-6 and torch.cuda.memory_allocated(dev)
          == before, f"from_counted FLOPs of one prefill == estimate's "
          f"(ratio {ratio}); the count allocated nothing")


# -- phase 11: training at full width ---------------------------------------

#: yi-9b's training run: depth (of 48), batch, sequence, steps, optimizer
#: settings; the card-against-CPU gradient (f32): depth, batch, sequence;
#: the giant MoEs' optimizer path at yi-9b's width (arctic's and llama4's
#: training fields: Adafactor, bf16 accumulation): global batch, micro-
#: batches, steps; whisper-medium at full depth: batch, sequence, steps.
#: The short runs warm up over 2 steps, so their loss can fall in 10.
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 4, 1024, 30
TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 10}
SHORT_OPT = {"lr": 3e-4, "warmup_steps": 2}
GRAD_LAYERS, GRAD_B, GRAD_S = 2, 1, 256
ACCUM_B, ACCUM_N, ACCUM_STEPS = 8, 4, 10
WHISPER_B, WHISPER_S, WHISPER_STEPS = 4, 256, 10
#: the recurrent families at full width and depth, B 4 x S 1024 (arch,
#: RG-LRU ``lam`` negated): recurrentgemma's decay is about 0 under the
#: reference's init, so it trains again with a live recurrence; and the
#: card-vs-CPU gradients of their 2-layer f32 models
RECURRENT_TRAIN = (("rwkv6-1.6b", False), ("recurrentgemma-2b", False),
                   ("recurrentgemma-2b", True))
RECURRENT_STEPS = 10
RECURRENT_GRAD = (("rwkv6-1.6b", False), ("recurrentgemma-2b", True))
TRAIN_CKPT = os.path.join(HERE, "build", "train_ckpt")


def _lm_batches(torch, dev, vocab, B, S, extras=None):
    """An endless stream of ``SyntheticLM(seed 0)`` batches on ``dev``."""
    from repro_torch.training.data import DataConfig, SyntheticLM

    src = SyntheticLM(DataConfig(vocab_size=vocab, seq_len=S, batch_size=B,
                                 seed=SEED))
    while True:
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in src.batch().items()}
        batch.update(extras or {})
        yield batch


def _train_steps(torch, dev, step_fn, state, batches, n, smi, what):
    """Run ``n`` steps; returns (losses, grad norms, seconds a step after
    the first two, peak GB).  Each step ends in a synchronise; every loss
    and grad norm must be finite, and no kernel may launch."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    losses, norms, secs = [], [], []
    for _ in range(n):
        batch = next(batches)
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launched = _launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steady = sorted(secs[2:])[len(secs[2:]) // 2] if n > 2 else secs[-1]
    print(f"  {what}: losses {losses}", flush=True)
    print(f"  {what}: grad norms {norms}", flush=True)
    print(f"  {what}: first step {secs[0]:.3f} s, median step after two "
          f"{steady:.4f} s, peak {peak_gb:.2f} GB ({smi})", flush=True)
    check(all(math.isfinite(x) for x in losses + norms),
          f"{what}: every loss and grad norm finite")
    check(sum(launched.values()) == 0,
          f"{what}: no kernel launched in the train steps ({launched})")
    half = min(5, n // 2)
    first, last = sum(losses[:half]) / half, sum(losses[-half:]) / half
    check(last < first, f"{what}: the mean loss of the last {half} steps "
          f"({last:.4f}) is below that of the first {half} ({first:.4f})")
    return losses, norms, steady, peak_gb


def _train_report(cfg, B, S, steady, peak_gb, smi, what):
    """The ``training:`` line: s/step, tokens/s, peak GB and the MFU of a
    step (``estimate``'s ``model_flops`` over the step at the bf16 peak)."""
    from repro_torch.configs import InputShape
    from repro_torch.roofline import flops, hw

    est = flops.estimate(cfg, InputShape("train", S, B, "train"), chips=1,
                         mp=1)
    mfu = est.model_flops / (steady * hw.PEAK_FLOPS_BF16)
    print("training: " + json.dumps({
        "cell": what, "params": cfg.param_count(), "batch": B, "seq": S,
        "s_per_step": steady, "tokens_per_s": B * S / steady,
        "peak_allocated_gb": peak_gb, "model_flops": est.model_flops,
        "mfu": mfu, "card": smi}), flush=True)
    check(0 < mfu <= 1.0, f"{what}: MFU {mfu} in (0, 1]")


def _same_bits(torch, a, b):
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.detach().view(as_int), b.detach().view(as_int)
    return bool(torch.equal(a, b))


def phase_training(torch, dev, smi):
    """Phase 11 (see the module docstring).  Returns the flash launches
    of yi-9b's eval step."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=TRAIN_LAYERS)
    eval_flash = _train_yi(torch, dev, cfg, smi)
    _release(torch)
    _train_grad_vs_cpu(torch, dev, smi, "yi-9b")
    _release(torch)
    for arch, negate in RECURRENT_TRAIN:
        _train_recurrent(torch, dev, arch, negate, smi)
        _release(torch)
    for arch, negate in RECURRENT_GRAD:
        _train_grad_vs_cpu(torch, dev, smi, arch, negate)
        _release(torch)
    _train_accum(torch, dev, cfg, smi)
    _release(torch)
    _train_whisper(torch, dev, smi)
    _release(torch)
    _train_entry_points(torch, dev, smi)
    return eval_flash


def _train_yi(torch, dev, cfg, smi):
    """yi-9b at full width, 8 layers, bf16, AdamW: 30 steps; the eval
    step with the kernels on the trained params; the state's checkpoint
    round trip and one step from each copy."""
    from repro_torch.models import build_model
    from repro_torch.training import optim, train_step

    model = build_model(cfg, dev)
    opt = optim.OptConfig(**TRAIN_OPT)
    state = train_step.init_train_state(
        model, torch.Generator(device=dev).manual_seed(SEED), opt)
    n_params = sum(p.numel() for p in optim.leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size()
                   for t in optim.leaves(state)) / 1e9
    print(f"  yi-9b, {TRAIN_LAYERS} of 48 layers at full width: "
          f"{n_params} params, train state {state_gb:.2f} GB (bf16 params,"
          f" f32 AdamW m and v)", flush=True)
    step_fn = train_step.make_train_step(model, opt)
    batches = _lm_batches(torch, dev, cfg.vocab_size, TRAIN_B, TRAIN_S)
    _, _, steady, peak = _train_steps(torch, dev, step_fn, state, batches,
                                      TRAIN_STEPS, smi, "yi-9b AdamW")
    _train_report(cfg, TRAIN_B, TRAIN_S, steady, peak, smi,
                  f"yi-9b {TRAIN_LAYERS}L AdamW bf16 remat=nothing")

    # the eval step: the kernel path (no grad) against the plain path
    batch = next(batches)
    kern = build_model(dataclasses.replace(cfg, use_kernels=True), dev)
    _zero_launches()
    got = train_step.make_eval_step(kern)(state["params"], batch)
    torch.cuda.synchronize(dev)
    launched = _launches()
    want = train_step.make_eval_step(model)(state["params"], batch)
    rel = abs(float(got["loss"]) - float(want["loss"])) / abs(
        float(want["loss"]))
    check(launched == {**{k: 0 for k in KERNELS},
                       "flash_attention": TRAIN_LAYERS},
          f"eval step with use_kernels=True launched flash once a layer "
          f"({launched})")
    check(rel <= BF16_REL, f"eval loss on the kernel path "
          f"{float(got['loss'])} vs plain {float(want['loss'])}: rel {rel}"
          f" <= {BF16_REL}")
    _train_checkpoint(torch, dev, step_fn, state, batches, smi)
    return launched["flash_attention"]


def _train_recurrent(torch, dev, arch, negate, smi):
    """``arch`` at full width and depth, bf16, AdamW: ``RECURRENT_STEPS``
    steps on the plain path (``wkv_chunked`` / ``associative_scan``),
    then the eval step with the kernels on the trained params, which
    launches the family's recurrence kernel once a recurrent layer and
    gives the plain eval loss within the bf16 bar.  ``negate``: every
    RG-LRU ``lam`` negated first (a live recurrence)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, rglru
    from repro_torch.training import optim, train_step

    cfg = get_config(arch)
    what = f"{arch}{' lam negated' if negate else ''}"
    model = build_model(cfg, dev)
    opt = optim.OptConfig(**SHORT_OPT)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    if negate:
        params = _negate_lam(params)
    state = train_step.init_train_state(model, opt_cfg=opt, params=params)
    del params
    n_params = sum(p.numel() for p in optim.leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size()
                   for t in optim.leaves(state)) / 1e9
    logits_gb = TRAIN_B * TRAIN_S * cfg.padded_vocab * 4 / 1e9
    print(f"  {what}, {cfg.num_layers} layers at full width: {n_params} "
          f"params, train state {state_gb:.2f} GB (bf16 params, f32 AdamW "
          f"m and v; with bf16 grads {state_gb + 2 * n_params / 1e9:.2f}),"
          f" f32 logits {logits_gb:.2f} GB", flush=True)
    check(state_gb + 2 * n_params / 1e9 + 3 * logits_gb < 75,
          f"{what}: state, grads and three f32 logits' worth fit the card")
    step_fn = train_step.make_train_step(model, opt)
    batches = _lm_batches(torch, dev, cfg.vocab_size, TRAIN_B, TRAIN_S)
    _, _, steady, peak = _train_steps(torch, dev, step_fn, state, batches,
                                      RECURRENT_STEPS, smi, f"{what} AdamW")
    _train_report(cfg, TRAIN_B, TRAIN_S, steady, peak, smi,
                  f"{what} {cfg.num_layers}L AdamW bf16 remat=nothing")

    batch = next(batches)
    kern = build_model(dataclasses.replace(cfg, use_kernels=True), dev)
    _zero_launches()
    got = train_step.make_eval_step(kern)(state["params"], batch)
    torch.cuda.synchronize(dev)
    launched = _launches()
    want = train_step.make_eval_step(model)(state["params"], batch)
    rel = abs(float(got["loss"]) - float(want["loss"])) / abs(
        float(want["loss"]))
    kernel = {"ssm": "wkv6", "hybrid": "rglru_scan"}[cfg.family]
    n_rec = (cfg.num_layers if cfg.family == "ssm" else
             rglru.layer_types(cfg).count("rec"))
    check(launched == {**{k: 0 for k in KERNELS}, kernel: n_rec},
          f"{what} eval step with use_kernels=True launched {kernel} once "
          f"a recurrent layer, {n_rec} times ({launched})")
    check(rel <= BF16_REL, f"{what} eval loss on the kernel path "
          f"{float(got['loss'])} vs plain {float(want['loss'])}: rel {rel}"
          f" <= {BF16_REL}")


def _train_checkpoint(torch, dev, step_fn, state, batches, smi):
    """Save the full-width state under ``build/``, restore it into a fresh
    template (every leaf equal, bit for bit), then one step from the live
    state and one from the restored copy: the same loss within 1e-3."""
    import shutil

    from repro_torch.training import checkpoint, optim, train_step

    nbytes = sum(t.numel() * t.element_size() for t in optim.leaves(state))
    os.makedirs(TRAIN_CKPT, exist_ok=True)
    free = shutil.disk_usage(TRAIN_CKPT).free
    check(free > 1.1 * nbytes, f"checkpoint: {free / 1e9:.1f} GB free for "
          f"a {nbytes / 1e9:.2f} GB state")
    try:
        t = time.perf_counter()
        path = checkpoint.save(TRAIN_CKPT, state, int(state["opt"]["step"]))
        save_s = time.perf_counter() - t
        template = optim.tree_map(torch.empty_like, state)
        t = time.perf_counter()
        restored = checkpoint.restore(TRAIN_CKPT, template)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(TRAIN_CKPT)
    del template
    print(f"  checkpoint: {size / 1e9:.2f} GB written in {save_s:.1f} s, "
          f"restored in {restore_s:.1f} s ({smi})", flush=True)
    pairs = list(zip(optim.leaves(state), optim.leaves(restored)))
    check(all(_same_bits(torch, a, b) for a, b in pairs),
          f"checkpoint: all {len(pairs)} leaves of the restored state equal"
          " the saved ones, bit for bit")
    del pairs
    batch = next(batches)
    _, live = step_fn(state, batch)
    live_loss = float(live["loss"])
    train_step.trainable(restored["params"])
    _, again = step_fn(restored, batch)
    rel = abs(float(again["loss"]) - live_loss) / abs(live_loss)
    check(rel <= 1e-3, f"checkpoint: a step from the restored state "
          f"{float(again['loss'])} vs from the live state {live_loss}: "
          f"rel {rel} <= 1e-3")


def _train_grad_vs_cpu(torch, dev, smi, arch, negate=False):
    """The same port code in f32 at full width (2 layers, B 1 x S 256):
    loss and every gradient leaf on the card against the CPU, from params
    drawn once on the CPU and copied to the card (``negate``: every RG-LRU
    ``lam`` negated)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import optim, train_step

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 products on the card run without TF32")
    cfg = dataclasses.replace(get_config(arch), num_layers=GRAD_LAYERS,
                              dtype="float32")
    cpu_model = build_model(cfg, "cpu")
    params = cpu_model.init(torch.Generator().manual_seed(SEED))
    cpu_params = train_step.trainable(_negate_lam(params) if negate
                                      else params)
    dev_params = train_step.trainable(optim.tree_map(
        lambda t: t.detach().to(dev), cpu_params))
    batch = next(_lm_batches(torch, "cpu", cfg.vocab_size, GRAD_B, GRAD_S))
    t = time.perf_counter()
    d_loss, _, d_grads = train_step.value_and_grad(
        build_model(cfg, dev), dev_params,
        {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    c_loss, _, c_grads = train_step.value_and_grad(cpu_model, cpu_params,
                                                   batch)
    cpu_s = time.perf_counter() - t
    rel = abs(float(d_loss) - float(c_loss)) / abs(float(c_loss))
    # (a 2-layer recurrentgemma has no blocks: its block leaves are empty)
    ratios = [float((a.cpu() - b).abs().max()) / float(b.abs().max())
              for a, b in zip(optim.leaves(d_grads), optim.leaves(c_grads))
              if b.numel()]
    print(f"  {arch}{' lam negated' if negate else ''} grad on the card "
          f"vs the CPU: {cfg.param_count()} params, "
          f"card {card_s:.2f} s, CPU {cpu_s:.2f} s ({smi}); worst leaf "
          f"max|d| / max|cpu| {max(ratios):.3e}", flush=True)
    check(rel <= 1e-5, f"f32 loss on the card {float(d_loss)} vs the CPU "
          f"{float(c_loss)}: rel {rel} <= 1e-5")
    check(max(ratios) <= 1e-3, f"every one of {len(ratios)} gradient "
          f"leaves within 1e-3 of its CPU leaf's max (worst "
          f"{max(ratios):.3e})")


def _train_accum(torch, dev, cfg, smi):
    """The giant MoEs' optimizer path (Adafactor, 4 microbatches
    accumulated in bf16) at yi-9b's width: the first step's loss against a
    one-microbatch step on the same params and batch, then 10 steps."""
    from repro_torch.models import build_model
    from repro_torch.training import optim, train_step

    cfg = dataclasses.replace(cfg, optimizer="adafactor", grad_accum=ACCUM_N,
                              accum_dtype="bfloat16")
    opt = optim.OptConfig(name="adafactor", **SHORT_OPT)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    batches = _lm_batches(torch, dev, cfg.vocab_size, ACCUM_B, TRAIN_S)
    first = next(batches)
    one = build_model(dataclasses.replace(cfg, grad_accum=1), dev)
    state1 = train_step.init_train_state(
        one, opt_cfg=opt, params=optim.tree_map(torch.clone, params))
    _, m1 = train_step.make_train_step(one, opt)(state1, first)
    loss1 = float(m1["loss"])
    del state1
    _release(torch)
    state = train_step.init_train_state(model, opt_cfg=opt, params=params)

    def replay():
        yield first
        yield from batches

    losses, _, steady, peak = _train_steps(
        torch, dev, train_step.make_train_step(model, opt), state, replay(),
        ACCUM_STEPS, smi, f"yi-9b Adafactor, {ACCUM_N} microbatches in bf16")
    rel = abs(losses[0] - loss1) / abs(loss1)
    check(rel <= 1e-2, f"accumulated first-step loss {losses[0]} vs one "
          f"microbatch {loss1}: rel {rel} <= 1e-2")
    _train_report(cfg, ACCUM_B, TRAIN_S, steady, peak, smi,
                  f"yi-9b {TRAIN_LAYERS}L Adafactor grad_accum={ACCUM_N} "
                  "bf16 accumulation")


def _train_whisper(torch, dev, smi):
    """whisper-medium at full depth (24 + 24 layers), AdamW, zero frames
    as in ``launch/train.py``: 10 steps."""
    from repro_torch.configs import get_config
    from repro_torch.interop import torch_dtype
    from repro_torch.models import build_model
    from repro_torch.training import optim, train_step

    cfg = get_config("whisper-medium")
    model = build_model(cfg, dev)
    opt = optim.OptConfig(**SHORT_OPT)
    state = train_step.init_train_state(
        model, torch.Generator(device=dev).manual_seed(SEED), opt)
    frames = torch.zeros((WHISPER_B, cfg.encoder_seq, cfg.d_model),
                         dtype=torch_dtype(cfg.dtype), device=dev)
    batches = _lm_batches(torch, dev, cfg.vocab_size, WHISPER_B, WHISPER_S,
                       {"frames": frames})
    _, _, steady, peak = _train_steps(
        torch, dev, train_step.make_train_step(model, opt), state, batches,
        WHISPER_STEPS, smi, "whisper-medium AdamW")
    _train_report(cfg, WHISPER_B, WHISPER_S, steady, peak, smi,
                  "whisper-medium 24+24L AdamW bf16, zero frames")


def _train_entry_points(torch, dev, smi):
    """``python -m repro_torch.launch.train --arch yi-9b --tiny --steps 50``
    (in this process, default device) and ``train_small`` with its
    defaults (its checkpoint under ``build/``), which asserts learning and
    the round trip."""
    import contextlib
    import io

    from repro_torch.examples import train_small
    from repro_torch.launch import train as launch_train

    t = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = launch_train.main(["--arch", "yi-9b", "--tiny", "--steps",
                                    "50"])
    print(f"  launch.train --arch yi-9b --tiny --steps 50: "
          f"{out.getvalue().strip().splitlines()[-1]} in "
          f"{time.perf_counter() - t:.1f} s ({smi})", flush=True)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "launch.train: finite losses, the last below the first")
    t = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train_small.main(["--ckpt-dir", os.path.join(
            HERE, "build", "train_small")])
    print("  train_small: " + " | ".join(
        out.getvalue().strip().splitlines()[-2:])
        + f" in {time.perf_counter() - t:.1f} s ({smi})", flush=True)
    check(losses[-1] < losses[0] - 1.0, "train_small learned (its own "
          "assertions: the loss fell by more than 1.0, the checkpoint "
          "round-tripped)")


def kernel_vs_plain(torch, dev, cfg, params, toks):
    """Logits rel err of the kernel path against the plain path on the
    same params and prompts: (prefill, first decode step).  Checks that
    the kernel side launched the kernels its path needs and the plain side
    none, and prints how far the prefill caches' f32 leaves (the
    recurrent states) of the two sides are apart."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model, registry

    model = build_model(cfg, device=dev)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=dev)
    nxt = pos = None
    out = {}
    for side, m in (("plain", plain), ("kernel", model)):
        for name in KERNELS:
            getattr(kops, name).launches = 0
        logits, cache = m.prefill(params, {"tokens": toks}, CACHE)
        if nxt is None:
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            pos = torch.full((PROMPTS,), SEQ, dtype=torch.int32, device=dev)
        step, _ = m.decode_step(params, nxt, pos, cache)
        launches = {name: getattr(kops, name).launches for name in KERNELS}
        out[side] = (logits, cache, step, launches)
    want = expected_launches(cfg, 1, 1)
    check(out["kernel"][3] == want
          and out["plain"][3] == dict.fromkeys(KERNELS, 0),
          f"{cfg.num_layers} layers, one prefill and one decode step: "
          f"kernel side launches {out['kernel'][3]} == {want}, plain side "
          f"none")
    leaves = zip(registry._flatten(out["kernel"][1]),
                 registry._flatten(out["plain"][1]))
    for (name, ck), (_, cp) in leaves:
        if ck.dtype == torch.float32:
            diff = (ck - cp).abs()
            print(f"  prefill cache {name} (f32 {tuple(ck.shape)}), kernel "
                  f"vs plain: max abs diff {float(diff.max())}, "
                  f"{int((diff > 0).sum())} of {diff.numel()} values differ;"
                  f" [0] max abs diff {float(diff[0].max())}", flush=True)
    return (rel_err(out["kernel"][0], out["plain"][0]),
            rel_err(out["kernel"][2], out["plain"][2]))


def _negate_lam(tree):
    """recurrentgemma params with every RG-LRU ``lam`` negated."""
    if not isinstance(tree, dict):
        return tree
    return {k: -v if k == "lam" else _negate_lam(v) for k, v in tree.items()}


# -- phase 12, the mesh -----------------------------------------------------

#: greedy tokens of each bf16 path served at full width (phases 4 and 9),
#: held for phase 12's meshed runs
PATH_TOKENS = {}
#: prefill dispatches of each bf16 path's run (phases 4 and 9)
PATH_DISPATCHES = {}
#: each MoE path's MoE kernel launches and calls (phase 9)
PATH_MOE_LAUNCHES = {}
#: phase 12: the dry-run combinations, each traced in its own process on
#: the fake group while the card serves: (arch, shape, multi-pod)
MESH_DRYRUNS = (("yi-9b", "train_4k", False),
                ("arctic-480b", "decode_32k", True),
                ("gemma2-9b", "long_500k", False),
                ("whisper-medium", "prefill_32k", False),
                ("rwkv6-1.6b", "train_4k", False))
DRYRUN_TIMEOUT_S = 600
#: phase 12: arctic-480b's depth (as phase 9 serves it) and the capacity
#: factors of ``moe_apply_ep`` at mp 1 (8: nothing drops; the config's)
MESH_ARCTIC_LAYERS = 2
EP_FACTORS = (8.0, 1.25)


def _start_dryruns():
    """Start every ``MESH_DRYRUNS`` combination as ``python -m
    repro_torch.launch.dryrun`` in its own process: CPU work on the fake
    group, which runs while the card serves."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = []
    for arch, shape, multi in MESH_DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + (["--multipod"] if multi else [])
        procs.append(((arch, shape), subprocess.Popen(
            cmd, env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _finish_dryruns(procs, smi):
    """Wait for the dry-runs; each must exit 0 with CUDA never
    initialised.  Prints each one's per-rank bytes beside the card's HBM,
    its lower time and its collective bytes."""
    rows = {}
    try:
        for (arch, shape), p in procs:
            out, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            if p.returncode != 0:
                raise SmokeFailure(f"dry-run {arch} {shape} exit "
                                   f"{p.returncode}: {err[:1500]} ... "
                                   f"{err[-3000:]}")
            r = json.loads(out[out.index("{"):])
            check(r["cuda_initialized"] is False,
                  f"dry-run {arch} {shape}: CUDA never initialised")
            mem, roof = r["memory"], r["roofline_counted"]
            lower = max(roof["t_compute_s"], roof["t_memory_s"],
                        roof["t_collective_s"])
            row = {"mesh": r["mesh"], "trace_s": r["trace_s"],
                   "argument_bytes": mem["argument_bytes"],
                   "peak_est_bytes": mem["peak_est_bytes"],
                   "hbm_per_chip": mem["hbm_per_chip"],
                   "lower_s": lower, "bottleneck": roof["bottleneck"],
                   "collective_bytes": r["collectives"]["total"],
                   "cuda_initialized": r["cuda_initialized"]}
            rows[f"{arch} {shape}"] = row
            print(f"  dry-run {arch} {shape} at {r['mesh']}: per rank "
                  f"argument {mem['argument_bytes']} bytes, peak "
                  f"{mem['peak_est_bytes']} bytes beside the H100's "
                  f"{mem['hbm_per_chip']:.0f}; lower time {lower} s "
                  f"({roof['bottleneck']}); collectives "
                  f"{r['collectives']['total']:.0f} bytes; traced in "
                  f"{r['trace_s']} s; CUDA initialised in the subprocess: "
                  f"{r['cuda_initialized']}", flush=True)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rows


def _mesh_serve(torch, dev, cfg, ax, mode, smi):
    """``cfg`` served through the cascade from the same seeded weights:
    without a mesh, then with ``ax`` and the params placed by
    ``param_pspecs(mode=mode)`` (the same tensors: views, no copy).  The
    tokens, the launches and the peak above the held weights are checked
    equal (the peak within 1%).  Under the mesh the layers keep the eager
    glue (``layer_ops.layer_ops`` gives it there), whose norms sum in
    another order than ``add_rmsnorm``: the run without a mesh that the
    mesh run is held to keeps it too (and the MoE layers' eager
    composition, as under the mesh: :func:`_plain`), and a
    third run, without a mesh and with the glue and the MoE kernels as
    served, gives the path's own tokens and glue launches.
    Returns (the served path's tokens, the mesh run's launches, params)."""
    from repro_torch.launch import sharding as sh

    from repro_torch.models import build_model, layer_ops

    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    held = torch.cuda.memory_allocated(dev)
    _, _, _, served, _, _, disp, _ = serve(torch, dev, cfg, params=params)
    glue_n = _glue_launches()
    want_glue = expected_glue(cfg, sum(disp), STEPS)
    check(glue_n == want_glue, f"{cfg.name} without a mesh: fused glue "
          f"launches {glue_n} == {want_glue}")
    torch.cuda.reset_peak_memory_stats(dev)
    with _plain(layer_ops.GLUE + layer_ops.MOE):
        _, _, _, want, lats, _, disp, launches = serve(torch, dev, cfg,
                                                       params=params)
    peak0 = torch.cuda.max_memory_allocated(dev) - held
    want_launches = expected_launches(cfg, sum(disp), STEPS)
    check(launches == want_launches
          and _glue_launches() == dict.fromkeys(GLUE, 0)
          and _moe_launches()["fused"] == 0,
          f"{cfg.name} without a mesh, the glue and the MoE eager: launches "
          f"{launches} == {want_launches}, no glue launch "
          f"({_glue_launches()}), no MoE kernel ({_moe_launches()})")
    dparams = sh.distribute(params, ax.mesh, sh.param_pspecs(
        params, cfg, ax, mode=mode))
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, _, got, lats1, _, disp1, launches1 = serve(
        torch, dev, cfg, params=dparams, ax=ax)
    glue1, moe1 = _glue_launches(), _moe_launches()
    peak1 = torch.cuda.max_memory_allocated(dev) - held
    want1 = expected_launches(cfg, sum(disp1), STEPS)
    check(glue1 == dict.fromkeys(GLUE, 0) and moe1["fused"] == 0,
          f"{cfg.name} under a (1, 1) mesh: no fused glue launch ({glue1}) "
          f"and no MoE kernel ({moe1}): the layers keep the DTensor "
          f"composition")
    check(got == want, f"{cfg.name} under a (1, 1) mesh: tokens {got} == "
          f"the run without a mesh, the glue eager, {want}")
    check(launches1 == want1, f"{cfg.name} under a (1, 1) mesh: launches "
          f"{launches1} == {want1}")
    check(peak1 <= 1.01 * peak0, f"{cfg.name} under a (1, 1) mesh: peak "
          f"{peak1} bytes within 1% of {peak0} (no copies held)")
    print(f"  {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}, params "
          f"{mode} specs): tokens {got}; launches {launches1}; peak above "
          f"the {held} bytes held (the weights among them) {peak1} bytes "
          f"under the mesh, {peak0} without; steady "
          f"{min(lats1) * 1e3} ms under the mesh, {min(lats) * 1e3} ms "
          f"without; the served path's tokens {served}; {smi}", flush=True)
    return served, launches1, params


def _ep_rows(torch, dev, cfg, params, ax, smi):
    """``moe_apply_ep`` at mp 1 on arctic's full-width MoE layer (the
    first layer's params of ``params``), for seq-sharded and decode
    tokens x ``all_to_all`` and ``allgather``, at a decode batch (B 4)
    and a prefill (B 4 x 256): at capacity factor 8 nothing drops and
    the output is within the bf16 bar of ``moe_apply_reference``; at the
    config's factor the share of dropped pairs and the time are printed
    beside the served ``moe_apply``'s, with the bytes bound of reading
    every expert's weights (the capacity buckets give each expert a row
    at mp 1)."""
    from repro_torch.interop import torch_dtype
    from repro_torch.launch import sharding as sh
    from repro_torch.models import moe
    from repro_torch.models.partition import P, place, unplace
    from repro_torch.roofline import hw

    lp = {k: v[0] for k, v in params["blocks"]["0"]["moe"].items()}
    dlp = sh.distribute(lp, ax.mesh, {
        k: P(*([None] * v.dim())) if k == "router" else P("model", None, None)
        for k, v in lp.items()})
    expert_bytes = sum(w.numel() * w.element_size()
                       for k, w in lp.items() if k != "router")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    dt = torch_dtype(cfg.dtype)
    rows = {}
    for label, S in (("decode", 1), ("prefill", SEQ)):
        x = torch.randn((PROMPTS, S, cfg.d_model), generator=g,
                        device=dev).to(dt)
        dx = place(x, ax.mesh, P(ax.batch, None, None))
        want, _ = moe.moe_apply_reference(x, lp, cfg)
        T = PROMPTS * S
        flat_e = moe._router(x.reshape(-1, cfg.d_model), lp["router"],
                             cfg.num_experts_per_tok)[1].reshape(-1)
        ranks = moe.bucket_ranks(flat_e, cfg.num_experts)
        served_ms = time_ms(torch, lambda: moe.moe_apply(x, lp, cfg),
                            iters=5, warmup=1)
        for factor in EP_FACTORS:
            c = dataclasses.replace(cfg, capacity_factor=factor)
            C = moe._capacity(T, cfg.num_experts_per_tok, cfg.num_experts,
                              factor)
            dropped = float((ranks >= C).float().mean())
            for seq_sharded in (True, False):
                for disp in ("all_to_all", "allgather"):
                    def call():
                        return moe.moe_apply_ep(dx, dlp, c, ax,
                                                seq_sharded=seq_sharded,
                                                dispatch=disp)
                    y = unplace(call()[0])
                    err = rel_err(y, want)
                    key = (f"{label} cf {factor} "
                           f"{'seq' if seq_sharded else 'decode'} {disp}")
                    if factor == 8.0:
                        check(dropped == 0 and err < BF16_REL,
                              f"moe_apply_ep {key}: {dropped} of the pairs "
                              f"dropped, rel err {err} < {BF16_REL} vs "
                              f"moe_apply_reference")
                    ms = time_ms(torch, call, iters=5, warmup=1)
                    bound = expert_bytes / hw.HBM_BW * 1e3
                    rows[key] = {"T": T, "capacity": C, "dropped": dropped,
                                 "rel_err": err, "ms": ms,
                                 "served_moe_apply_ms": served_ms,
                                 "expert_bytes": expert_bytes,
                                 "bound_ms": bound}
                    print(f"  moe_apply_ep {key}: C {C}, {dropped} of the "
                          f"pairs dropped, rel err {err} vs the masked "
                          f"combine; {ms} ms (reads all {cfg.num_experts} "
                          f"experts, {expert_bytes} bytes: bound {bound} "
                          f"ms) beside the served moe_apply's {served_ms} "
                          f"ms; {smi}", flush=True)
    return rows


def phase_mesh(torch, dev, smi):
    """NCCL at world size 1 and a (1, 1) mesh on the card: full-width
    yi-9b (48 layers, bf16) served through the cascade with its params
    placed by ``param_pspecs(mode="serve")`` and its cache by
    ``cache_pspecs``, the flash and decode kernels launched inside the
    attention's ``local_map`` regions: tokens equal to the run without a
    mesh and with the glue eager, as the mesh keeps it, launches as
    ``expected_launches`` and no glue launch, the peak within 1%; the
    served path (no mesh, the glue fused) gives phase 4's tokens.
    arctic-480b at full width and 2 layers with
    ``param_pspecs(mode="train")``: the same, its served path phase 9's
    tokens.
    ``moe_apply_ep`` at mp 1 on arctic's MoE layer (``_ep_rows``).  The
    five ``MESH_DRYRUNS`` traced in subprocesses meanwhile.  Returns the
    yi-9b mesh run's launches of the two attention kernels."""
    import socket

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M

    procs = _start_dryruns()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = M.make_host_mesh((1, 1))
        ax = M.make_axis_info(mesh)
        cfg = dataclasses.replace(get_config("yi-9b"), use_kernels=True)
        got, launches, _ = _mesh_serve(torch, dev, cfg, ax, "serve", smi)
        check(got == PATH_TOKENS["yi-9b"], f"yi-9b's served path in phase "
              f"12: tokens {got} == phase 4's {PATH_TOKENS['yi-9b']}")
        _release(torch)
        cfg = dataclasses.replace(get_config("arctic-480b"), use_kernels=True,
                                  num_layers=MESH_ARCTIC_LAYERS)
        got_a, _, params = _mesh_serve(torch, dev, cfg, ax, "train", smi)
        check(got_a == PATH_TOKENS["arctic-480b"], f"arctic-480b's served "
              f"path in phase 12: tokens {got_a} == phase 9's "
              f"{PATH_TOKENS['arctic-480b']}")
        ep = _ep_rows(torch, dev, cfg, params, ax, smi)
        del params
        _release(torch)
        dry = _finish_dryruns(procs, smi)
        print("mesh: " + json.dumps({"ep": ep, "dryrun": dry}), flush=True)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        dist.destroy_process_group()
    return {"flash_attention": launches["flash_attention"],
            "decode_attention": launches["decode_attention"]}


def _release(torch):
    """Free a path's weights: the process-wide executable cache holds the
    chain's step functions, and they close over the params."""
    from repro_torch.core.lowering import EXECUTABLE_CACHE

    EXECUTABLE_CACHE.clear()
    gc.collect()                 # chains and closures form cycles
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _phase(name, t_prev=None):
    """Close the running phase (its seconds) and open ``name``; returns
    the new phase's start."""
    now = time.perf_counter()
    if t_prev is not None:
        print(f"  (phase seconds: {now - t_prev:.1f})", flush=True)
    if name is not None:
        print(f"== {name}", flush=True)
    return now


def _glue_row_launches(glue_line, arch, glue_n):
    """Give ``arch``'s glue rows the launches of its kernels in its path's
    run (phase 4 or 9)."""
    for row in glue_line["glue"]:
        if row["model"] == arch:
            row["launches"] = glue_n[row["name"].split("[")[0]]
            row["launches_per"] = (
                f"{PATH_DISPATCHES[arch]} dispatches of full-depth {arch}'s"
                f" cascade, a prefill and {STEPS} decode steps each; "
                "gated_act at all its widths")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the port first: without it (a checkout missing src/) fail before
    # printing anything
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    print("== device", flush=True)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"  {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}", flush=True)

    t0 = _phase("build")
    secs = build.build(verbose=True)   # ptxas: registers, smem, spills
    print(f"  built {secs} in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("kernels")
    glue_line = phase_glue(torch, dev, smi)
    moe_line = phase_moe_kernels(torch, dev, smi)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = phase_kernels(torch, dev, flush=scratch.zero_)
    del scratch

    t0 = _phase("paths", t0)
    served = {}
    for arch, f32_layers, logits_layers in PATHS:
        _release(torch)          # nothing of the last path stays allocated
        # each kernel's launches come from the run of the path it is on:
        # yi-9b's for the base rows, gemma2-9b's for its own
        launches, glue_n, windowed, kept = phase_path(
            torch, dev, arch, f32_layers, logits_layers, keep=arch == "yi-9b")
        if kept is not None:
            served[arch] = kept  # phase 5 serves yi-9b's weights
        _glue_row_launches(glue_line, arch, glue_n)
        suffix = f"[{arch}]" if f"flash_attention[{arch}]" in kernels else ""
        for name, n in launches.items():
            if n:
                kernels[name + suffix]["launches"] = n
        if f"flash_attention[{arch} global]" in kernels:
            # the local layers' launches carry a window, the global ones not
            kernels[f"flash_attention[{arch}]"]["launches"] = windowed
            kernels[f"flash_attention[{arch} global]"]["launches"] = \
                launches["flash_attention"] - windowed

    t0 = _phase("serving", t0)
    _release(torch)
    *yi, steady_s = served.pop("yi-9b")
    one_worker = phase_serving(torch, dev, *yi, smi=smi)
    _release(torch)

    t0 = _phase("compile", t0)
    phase_compile(torch, dev, *yi, smi=smi)
    _release(torch)

    t0 = _phase("plan", t0)
    phase_plan(torch, dev, *yi, served=one_worker, smi=smi)
    _release(torch)

    t0 = _phase("entry points", t0)
    for name, n in phase_entry(torch, dev, *yi[:2], steady_s).items():
        kernels[name]["launches"] = n
    del yi
    _release(torch)

    t0 = _phase("families", t0)
    phase_families(torch, dev, smi)
    _release(torch)

    t0 = _phase("families II", t0)
    for arch, layers, f32_layers in FAMILIES2:
        _release(torch)
        launches, glue_n, _, _ = phase_path(torch, dev, arch, f32_layers,
                                            None, layers=layers)
        if f"flash_attention[{arch}]" in kernels:
            for name, n in launches.items():
                if n:
                    kernels[f"{name}[{arch}]"]["launches"] = n
        _glue_row_launches(glue_line, arch, glue_n)
    for row in moe_line["moe_kernels"]:
        row["launches"] = PATH_MOE_LAUNCHES[DS_ARCH][row["name"].split("[")[0]]
        row["launches_per"] = (f"{PATH_DISPATCHES[DS_ARCH]} dispatches of "
                               f"full-depth {DS_ARCH}'s cascade, a prefill "
                               f"and {STEPS} decode steps each")

    t0 = _phase("deepseek reference", t0)
    _release(torch)
    phase_deepseek_reference(torch, dev, smi)

    t0 = _phase("training", t0)
    _release(torch)
    kernels[TRAIN_EVAL_FLASH]["launches"] = phase_training(torch, dev, smi)
    _release(torch)

    t0 = _phase("mesh", t0)
    for name, n in phase_mesh(torch, dev, smi).items():
        kernels[name]["mesh_launches"] = n
    _release(torch)
    _phase(None, t0)
    print(f"  chip_smoke total: {time.perf_counter() - T_START:.1f} s",
          flush=True)
    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    extra = ["device_ms", "library_device_ms", "instance", "shape",
             "library_note", "sdpa_no_softcap_ms",
             "sdpa_no_softcap_device_ms", "sdpa_causal_no_softcap_ms",
             "sdpa_causal_no_softcap_device_ms", "no_softcap_ms",
             "mesh_launches"]
    line = {"kernels": [{k: kernels[n][k] for k in keys + extra
                         if k in kernels[n]} for n in KERNEL_ROWS]}
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps(glue_line), flush=True)
    print(json.dumps(moe_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
