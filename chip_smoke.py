#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: every hand-written kernel, from the sources in this checkout,
   one nvcc per source started together;
3. kernels: the flash forward and the fused flash backward
   (flash_bwd_cuda), bf16 and exact f32, against their plain PyTorch
   versions on the card, at the main paths' shape and at edge shapes
   (head dims 4 and 12 through the padded route; the f32 kernels' tile
   edges; two launches bit-equal in six forward and eight backward
   cases), with the kernel's device time (the forward without and with
   the lse), its plain version's time, one PyTorch library call's time
   as a yardstick (scaled_dot_product_attention; its backward, also
   against the port's whole backward: delta, scratch, kernel), and its
   bound (least time for the same work on this card); then the exact-f32
   forward and fused backward (the route a float32 graph takes) at the
   flagship shape against their plain versions, timed beside their
   bounds, their registers and spills, and scaled_dot_product_attention's
   float32 forward and backward; then _contrib_FlashAttention at
   __graft_entry__'s GQA shape (head dim 4) forward and backward, card
   against CPU, f32 and bf16;
4. serve path: the flagship transformer LM (vocab 32768, seq 2048, 4
   layers, 16 heads, dim 2048, bf16, random weights from a numpy seed)
   served through ServeEngine -> Predictor -> Symbol graph, 8 concurrent
   requests; every response is checked, and the kernels' launch counts
   show the path went through them; plus a small f32 model whose card
   forward must agree with the CPU reference forward;
5. train path: the same LM trained as bench.py trains it (Adam, bf16
   compute, Xavier init, batch 8 of random tokens) through
   make_train_step -> init_state -> step: 2 warm steps (one profiled)
   and 10 timed ones, a finite and falling loss, and 4 launches of
   flash_fwd_cuda and of flash_bwd_cuda and one of the multi-tensor
   update per step; plus a small f32 LM whose one-step parameters
   on the card must match the same step on the CPU;
6. executor/eager path: the same LM bound in float32, 339.9 M
   parameters, batch 8 of random tokens, weights from a numpy seed,
   through Symbol.simple_bind -> copy_params_from -> forward(is_train=
   True) -> backward() (2 warm, 5 timed, one profiled), through the
   eager walk (mx.nd node by node under autograd.record(), parameters
   attach_grad'ed, loss.backward(); 1 warm, 3 timed) and through
   TrainStep._grads: gradients equal across the three (or within rtol
   1e-5 + atol 1e-6 x max|g|), a finite loss, 4 launches of each
   exact-f32 flash kernel per forward-and-backward on both routes and
   no bf16 one (the profiled step ran flash_fwd_f32 and flash_bwd_f32
   and no other flash kernel); plus, card against CPU, a small f32 LM
   and a small f32 ResNet on the BatchNorm kernels through the Executor
   (gradients and moving stats) and the eager MLP recipe of the verify
   notes;
7. BatchNorm kernels: each of the four (stats, apply, backward reduce,
   dx) against its plain version on the card at the 12 BatchNorm shapes
   of a ResNet-50 step at batch 128 and at edge shapes, timed at
   ResNet-50's stage-2 shape beside its bound and F.batch_norm's
   forward and backward as the pair yardsticks;
8. ResNet path: the ``entry()`` twin (ResNet-50 inference, card against
   CPU), a small f32 ResNet's SGD step on the BatchNorm kernels (card
   against CPU, parameters and moving stats), then bench.py's ResNet-50
   step (batch 128 x 3x224x224, bf16 compute, SGD momentum with wd)
   through make_train_step with ``MXNET_BN_PALLAS=1`` (50 launches of
   each BatchNorm kernel per step) and with it off (none);
9. NMS kernel (one thread-block cluster an image): greedy NMS against
   its plain version on the card, keep masks equal flag for flag, at
   SSD300's 8732 anchors (batch 8, every row valid and the path's top
   400), at edge cases, with valid rows scattered, past the default
   shared memory, at MAX_ANCHORS and at batch 32; timed (device time of
   every kernel of the call) beside its bound at both shapes, with the
   cluster size and the SMs it runs on;
10. SSD path: SSD300 (VGG16-reduced, 21 classes, f32, random Xavier
   weights) served through ServeEngine -> Predictor -> Symbol graph ->
   MultiBoxDetection on the NMS kernel, 8 concurrent requests; every
   response checked against MultiBoxDetection's rules and the Predictor
   alone, one batch's detections equal on the kernel and dense NMS
   routes, one kernel launch per forward; plus a small f32 SSD300 whose
   card heads and detections must agree with the CPU's;
11. PRNG: the threefry hash's known-answer vectors on the card; raw bits
   (8/16/32/64) and bernoulli(0.5) masks on the card equal to the
   port's CPU draws at (512, 4096), (70001,) and 0-d; PRNG_DIGESTS
   (JAX's own draws, recomputed from JAX by tests/test_torch_random.py)
   reproduced; one mask's device time and launches;
12. AlexNet path: bench.py's alexnet workload (batch 512, 3x224x224,
   1000 classes, bf16 compute, SGD momentum 0.9, wd 1e-4, rescale
   1/512, Xavier from mx.random.seed(0), PRNGKey(0) each step) through
   make_train_step: 2 warm steps (one profiled) and 10 timed ones, a
   finite NLL whose lowest timed value is under 0.75x the first, fc6's
   Dropout output equal to its input times 2 where the CPU's mask for
   fold_in(PRNGKey(0), uid) keeps and 0 elsewhere; before it, AlexNet at batch 4, card against CPU (the
   Dropouts' masks, float64 gradients); the LRN and Dropout ops and a
   mask timed alone;
13. multi-tensor kernels (csrc/multi_tensor.cu): the optimizer update
   (adam_update, sgd_mom_update; float32 and bfloat16) bit-equal to its
   plain version (the registry op parameter by parameter) in
   MT_UPDATE_CASES (lists of more than MAX_TENSORS tensors among them)
   and on the flagship LM's Adam list in both dtypes; the gradient
   reduction's finite flag exact (NaN and Inf planted) and its sum of
   squares within MT_SUM_RTOL, in MT_NORM_CASES and on the LM's
   gradients and bf16 outputs; each wrapper's count equal to the kernels
   it launched (one a MAX_TENSORS tensors, plus the reduction's pass
   over its partials); the update with its lr read on the device (a
   captured step's) bit-equal and timed; each timed beside its bound,
   its plain version
   and the nearest library call (torch._fused_adam_, torch._fused_sgd_,
   torch._foreach_norm: not the same functions), with a 1 GiB copy_'s
   rate for scale; the update launches once a step on the train, fit,
   ResNet and AlexNet paths, the reduction twice a guarded (fit) step
   and never on the unguarded ones;
14. fit path: the flagship LM through make_train_step -> fit(NDArrayIter)
   at full width (Adam, bf16, CosineScheduler, the fused
   Perplexity(ignore_label=-1), the guardrail at its default,
   MXNET_FAULT_SPEC=nan@6): the masked step leaves every parameter and
   Adam state bit-equal, the last epoch's perplexity equals the host
   recomputation over its unmasked batches within 1e-3, at most one
   blocking host sync a step plus one a metric.get(), step ms, tokens/s,
   peak memory; save_state -> load_state at full width bit for bit in a
   temporary directory; at 2 layers under
   torch.use_deterministic_algorithms(True), a fit cut by sigterm@4 and
   resumed lands on the uninterrupted run's weights bit for bit;
15. module path: bench.py's ResNet-50 in float32 on the BatchNorm
   kernels through Module.fit (kvstore local, the default guardrail,
   "acc", one epoch of 4 seeded batches, then score): after 3 updates the
   Module's parameters and moving stats equal a float32 TrainStep's bit
   for bit (deterministic algorithms), a module_checkpoint loads back bit
   for bit; step ms, img/s, the peak memory of each step (flat from step
   2), busy share and launches of a profiled step, each BatchNorm kernel
   50 launches a step; the float32 step without cuDNN beside it (ROADMAP
   Queue C item 8);
16. compiled step: ResNet-50's bf16 kernel-route step through
   TrainStep.export -> CompiledTrainStep: the capturing step and 10 CUDA
   graph replays, each with its own lr, equal 11 direct steps bit for
   bit; one profiled replay launches each BatchNorm kernel 50 times and
   the multi-tensor update once; the replay's ms by events, step()'s ms,
   the capture's time and memory, beside the direct step in this call;
   then AlexNet's replays with seeds 0, 1, 2 equal direct steps with
   PRNGKey(seed), Dropout masks included;
17. LM options: bench.py's flagship training step (Adam, bf16, batch 8 x
   2048) in three configurations through make_train_step: (a) the
   chunked-CE head (loss_chunk=2048), (b) RoPE, (c) the hybrid stack
   (attention, ssm, attention, ssm) with RoPE; 2 warm steps (one
   profiled) and 5 timed each, a finite loss whose lowest timed value is
   under the first, each flash kernel once an attention layer a step and
   the multi-tensor update once a step; step ms, tokens/s, peak memory
   ((a)'s beside the train phase's dense head), busy share; before them
   each configuration small and f32, card against CPU after one step, and
   one SSM layer's scan at full width (its memory kept for the backward,
   its forward and backward ms);
18. generation: bench.py bench_decode's workload (the flagship LM with
   learned positions, max_len 384, batch 8, prompt 128, 256 new tokens,
   bf16, Xavier): greedy and seeded generate_on_device (the decode step
   captured as one CUDA graph) equal generate; ms a step by bench.py's
   difference of runs at 256 and 32 tokens, tokens/s, prefill ms, KV
   bytes, peak memory, beside the decode bound (decode_bound); one replay
   and one eager step profiled and timed by events; the last decode
   step's logits against a prefill of the same sequence; int8 weights,
   int8 caches, beam 4 on the device (its step captured; equal to the
   host loop) and speculative decoding with bench.py's draft (its round
   captured; equal to generate in float32; bf16 agreement reported),
   timed briefly; configuration (c)'s trained hybrid decoded on both
   loops; a width-1 ssm_chunk_scan equal to ssm_recurrent_step bit for
   bit on the card; a small f32 hybrid RoPE LM card against CPU;
19. serve_decode: bench_decode's model through ContinuousDecoder (8
   slots, max_len 384): 24 float32 requests (greedy, seeded, streamed; 4
   speculative over truncated_draft(1); MXNET_PREFILL_CHUNK=64) each equal
   to generate of its prompt alone, stream frames equal to their rows,
   one captured step graph after the turnover; the bf16 rows that agree;
   64 bf16 requests timed: tokens/s, ms a step by events and by the host
   clock, busy share, TTFT and inter-token p50/p99, slot fill, beside
   generate_on_device's rate;
20. serve_fleet: a ServeRouter over two decode replicas and a prefill
   replica on 127.0.0.1 (float32), 8 ServeClient threads, 32
   disaggregated requests (greedy, seeded, streamed, speculative), one
   decode replica recycled mid-run (its sessions evacuate and resume):
   one response a request, each equal to generate, no decode-side
   prefill; requests/s, tokens/s, blob bytes and ms, evacuation ms;
21. compiled_serve: Predictor.export_buckets -> ServeEngine.from_export
   for the flagship LM (bf16) and SSD300 (float32), buckets 1, 2, 4, 8,
   each bucket's forward one captured CUDA graph: each replay bit-equal
   to the eager forward, flash_fwd_bf16 x4 and nms_cluster_kernel x1 in
   a profiled replay, replay ms beside the eager forward's, 8 concurrent
   requests served and checked;
22. one JSON line of every ported kernel (a device time under its byte
   bound fails the run: the timing lost work), then the result line.

It imports nothing of JAX or of ``mxnet_tpu``. Without CUDA, or run
outside the repository, it fails before printing any result.
``--only=PHASE,...`` runs the named phases alone after the build
(``PARTIAL``; ``generate`` needs ``lm_options`` before it) and prints no
result line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

# the flagship LM (bench.py _TLM), served and trained in bf16
VOCAB, SEQ, LAYERS, HEADS, DIM = 32768, 2048, 4, 16, 2048
BUCKETS = (1, 2, 4, 8)
REQUEST_ROWS = (1, 2, 1, 2, 2, 1, 2, 1)   # 8 concurrent requests, 12 rows
TRAIN_BATCH, TRAIN_LR = 8, 1e-4           # bench.py bench_transformer
WARM_STEPS, TIMED_STEPS = 2, 10

TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),
       "float32": dict(atol=1e-5, rtol=1e-4)}
# the flash forward's own limit: its worst bf16 error over FLASH_CASES was
# 0.0039 (this script on an H100, PERF.md): atol 8e-3 is twice that,
# and rtol 8e-3 about one bf16 ulp (2^-7) of |o| on top
FWD_TOL = {"bfloat16": dict(atol=8e-3, rtol=8e-3), "float32": TOL["float32"]}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output:
    its name (template argument included), registers and spills."""
    import re
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(flash_(?:fwd|bwd|dq|dkv)_"
                      r"(?:bf16|f32)|bn_(?:stats|apply|bwd_reduce|bwd_dx)_"
                      r"(?:bf16|f32)|bn_finalize|"
                      r"nms_(?:cluster_|phases_)?kernel|"
                      r"mt_(?:update_kernel|norm_kernel|norm_finalize))"
                      r"(?:ILi(\d+)E(f|13__nv_bfloat16)?)?",
                      line)
        if m:   # the mangled name: ...<name>[ILi<DP>E[<type>]]...
            args = [{"f": "float", "13__nv_bfloat16": "bf16"}.get(a, a)
                    for a in m.group(2, 3) if a]
            fn = m.group(1) + ("<%s>" % ", ".join(args) if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = "%s/%s bytes spilled (stores/loads)" % m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append("%s: %s registers, %s" % (fn, m.group(1), spill))
    return out


def ptxas_warnings(log):
    """ptxas's wgmma serialization warnings (C75xx) in nvcc's output."""
    import re
    return sorted(set(m.strip() for m in re.findall(r"\(C75\d\d\)[^'\n]*",
                                                    log)))


def time_ms(fn, reps=20, warmup=3):
    """Median device time of one call, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_ms(fn, kernel, reps=20, tries=3):
    """Device time of one call's kernels whose name holds ``kernel`` (all
    of the call's kernels when ``kernel`` is empty): a torch.profiler
    trace of ``reps`` warm calls, each after a marker kernel
    (``torch.cuda._sleep(1)``), so the kernels between two markers are
    one call's; the median over the calls of their kernel time (without
    the host's time to enqueue a call, which CUDA events around a short
    call include). The profiler can lose records at the start of a
    trace: on the H100 it dropped the first kernel of every trace, and
    once every marker of a short trace. So each trace opens with an
    unmarked call and a synchronize, a trace that holds no call whole is
    taken again (``tries`` traces in all), and only calls with the most
    common number of kernels count; that number is left in
    ``device_ms.launches``, the calls left out in ``device_ms.lost``."""
    import torch
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        calls, markers, n_events = _traced_calls(fn, kernel, reps)
        if calls:
            break
        say("device_ms: trace %d of %d for %r held %d device records and "
            "%d markers of %d, no call whole" % (
                attempt, tries, kernel, n_events, markers, reps + 1))
    else:
        fail("device_ms: no call of %r traced whole in %d traces"
             % (kernel, tries))
    count = statistics.mode(len(c) for c in calls)
    whole = [sum(c) for c in calls if len(c) == count]
    device_ms.launches = count
    device_ms.lost = reps - len(whole)
    return statistics.median(whole) / 1e3


def _traced_calls(fn, kernel, reps):
    """One trace for ``device_ms``: the kernel times (us) of each marked
    call, the number of markers recorded and of device records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()   # unmarked: takes what the trace loses at its start
        torch.cuda.synchronize()
        for _ in range(reps):
            torch.cuda._sleep(1)
            fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    calls, cur, markers = [], None, 0
    for e in events:
        if "spin_kernel" in e.name:
            markers += 1
            if cur is not None:
                calls.append(cur)
            cur = []
        elif cur is not None and kernel in e.name:
            cur.append(e.time_range.elapsed_us())
    return calls, markers, len(events)


device_ms.launches = 0
device_ms.lost = 0


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# (label, BH, T, Tk, D, dtype, causal, window, band_offset, lse)
FLASH_CASES = [
    ("flagship", 128, 2048, 2048, 128, "bfloat16", True, 0, 0, False),
    ("f32", 4, 256, 256, 64, "float32", True, 0, 0, True),
    ("noncausal", 8, 512, 512, 128, "bfloat16", False, 0, 0, False),
    ("ragged", 6, 200, 333, 64, "bfloat16", True, 0, 0, True),
    ("ragged_f32", 6, 200, 333, 64, "float32", True, 0, 0, True),
    ("window", 8, 512, 512, 128, "bfloat16", True, 64, 0, False),
    ("band_offset", 4, 256, 320, 64, "float32", True, 128, 64, True),
    ("band_offset_neg", 4, 256, 256, 128, "bfloat16", True, 0, -40, True),
    ("lse", 16, 1024, 1024, 128, "bfloat16", True, 0, 0, True),
    ("d16", 8, 300, 300, 16, "bfloat16", True, 0, 0, True),
    ("d64", 8, 512, 512, 64, "bfloat16", True, 0, 0, False),
    ("d16_f32", 4, 130, 97, 16, "float32", False, 0, 0, True),
    ("d128_f32", 4, 128, 128, 128, "float32", True, 0, 0, False),
    ("d32", 8, 300, 300, 32, "bfloat16", True, 0, 0, True),
    ("d4", 8, 256, 256, 4, "bfloat16", True, 0, 0, True),
    ("d12", 8, 300, 333, 12, "bfloat16", True, 0, 0, False),
    ("d12_f32", 4, 130, 97, 12, "float32", True, 0, 0, True),
    ("window_tiles", 8, 1000, 1000, 128, "bfloat16", True, 200, 0, True),
    ("band_offset_pos", 4, 256, 320, 128, "bfloat16", True, 100, 64, True),
    # the exact-f32 kernel's tile edges (64-row q tiles, 64-key tiles)
    ("f32_t_gt_tk", 3, 333, 200, 128, "float32", True, 0, 0, True),
    ("f32_t_lt_tk", 3, 130, 300, 128, "float32", True, 0, 0, True),
    ("f32_short", 4, 40, 40, 128, "float32", True, 0, 0, True),
    ("f32_window_ragged", 4, 300, 300, 128, "float32", True, 100, 0, True),
    ("f32_offset_neg", 4, 256, 256, 64, "float32", True, 0, -40, True),
    ("f32_d4", 4, 256, 256, 4, "float32", True, 0, 0, True),
]

# the forward cases whose two launches must give the same bits
FWD_DETERMINISM_CASES = ("flagship", "window", "band_offset_neg",
                         "ragged_f32", "f32_window_ragged", "f32_offset_neg")


def flash_bound(kind, T, Tk, D, BH, causal, window, band_offset, dtype):
    """(bound_ms, bound_by) for one flash kernel call: each input read
    once and each output written once, against the matrix flops it does
    for every (row, col) pair the mask keeps (the work this run's mask
    needs, not the dense T*Tk): 4*D per pair for the forward (q.k, p.v),
    10*D for the fused one-pass backward (q.k, do.v, p.do, ds.q, ds.k).
    Inputs and outputs: fwd q k v -> o; fused q k v do lse delta ->
    dq dk dv."""
    from mxnet_tpu_torch.ops.attention import _band_mask
    pairs = int(_band_mask(T, Tk, causal, window, band_offset,
                           "cuda").sum().item())
    elt = 2 if dtype == "bfloat16" else 4
    per_pair, rows_q, rows_k, stats = {
        "fwd": (4, 2, 2, 0), "fused": (10, 3, 4, 2)}[kind]
    nbytes = elt * BH * D * (rows_q * T + rows_k * Tk) + 4 * BH * T * stats
    flops = float(per_pair) * BH * D * pairs
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_close(what, got, want, tol):
    """Fail unless ``got`` is finite and within tol of ``want``
    (compared in f32); returns the max abs error."""
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail("%s: non-finite output" % what)
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    max_err = float(err.max().item())
    if bad.any():
        fail("%s: %d elements beyond atol %g rtol %g (max abs err %g)"
             % (what, int(bad.sum()), tol["atol"], tol["rtol"], max_err))
    return max_err


def kernel_phase():
    import torch
    from mxnet_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(20261016)
    record = None
    for (label, BH, T, Tk, D, dt, causal, window, off,
         want_lse) in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((BH, T, D), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        k = torch.randn((BH, Tk, D), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        v = torch.randn((BH, Tk, D), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        scale = D ** -0.5
        o, lse = att.flash_fwd_cuda(q, k, v, scale, causal, window, off,
                                    want_lse=want_lse)
        torch.cuda.synchronize()
        ro, rlse = att._flash_fwd_reference(q, k, v, scale, causal,
                                            window, off)
        max_err = check_close("flash_fwd %s" % label, o, ro, FWD_TOL[dt])
        lse_err = None
        if want_lse:
            le = (lse - rlse).abs()
            lse_err = float(le.max().item())
            if (le > LSE_TOL["atol"] + LSE_TOL["rtol"] * rlse.abs()).any():
                fail("flash_fwd %s: lse max abs err %g" % (label, lse_err))
        same = ""
        if label in FWD_DETERMINISM_CASES:
            o2, lse2 = att.flash_fwd_cuda(q, k, v, scale, causal, window,
                                          off, want_lse=want_lse)
            torch.cuda.synchronize()
            if not torch.equal(o, o2) or (want_lse
                                          and not torch.equal(lse, lse2)):
                fail("flash_fwd %s: two launches differ" % label)
            same = ", two launches bit-equal"
            del o2, lse2
        say("kernel flash_fwd %-16s BH=%d T=%d Tk=%d D=%d %s causal=%s "
            "window=%d offset=%d: max_abs_err %.3g%s%s" % (
                label, BH, T, Tk, D, dt, causal, window, off, max_err,
                "" if lse_err is None else ", lse %.3g" % lse_err, same))
        if label == "flagship":
            record = fwd_flagship_timing(q, k, v, scale, max_err)
        del q, k, v, o, lse, ro, rlse
    torch.cuda.empty_cache()
    return [record]


def fwd_flagship_timing(q, k, v, scale, max_err):
    """The flash_fwd record at the flagship shape: the kernel's device
    time (torch.profiler, by kernel name) without the lse (the serving
    call) and with it (the training call), CUDA events around each call
    beside them, the plain version's time, scaled_dot_product_attention's
    as the yardstick (``library_ms`` its device time, every kernel of the
    call, as ``ms`` is; ``library_call_ms`` by events, as ``call_ms``
    is), and the bound."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as att

    BH, T, D = q.shape
    dt = str(q.dtype).replace("torch.", "")

    def serve():
        return att.flash_fwd_cuda(q, k, v, scale, True)

    def train():
        return att.flash_fwd_cuda(q, k, v, scale, True, want_lse=True)

    ms = device_ms(serve, "flash_fwd_bf16")
    ms_lse = device_ms(train, "flash_fwd_bf16")
    call_ms, call_ms_lse = time_ms(serve), time_ms(train)
    plain_ms = time_ms(lambda: att._flash_fwd_reference(q, k, v, scale,
                                                        True), reps=5)
    q4, k4, v4 = (x.view(1, BH, -1, D) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              scale=scale)

    lib_ms, lib_call_ms = device_ms(library, ""), time_ms(library)
    bound, by = flash_bound("fwd", T, k.shape[1], D, BH, True, 0, 0, dt)
    say("kernel flash_fwd flagship timing: kernel %.4f ms without lse, "
        "%.4f ms with lse (device time; %.4f, %.4f ms by events around "
        "the call), plain %.4f ms, library (scaled_dot_product_attention) "
        "%.4f ms device time, %.4f ms by events; bound %.4f ms (%s); "
        "%.1f%% of the bf16 peak; against the library %.3fx by device "
        "time, %.3fx by events" % (
            ms, ms_lse, call_ms, call_ms_lse, plain_ms, lib_ms, lib_call_ms,
            bound, by, 100 * bound / ms, ms / lib_ms,
            call_ms / lib_call_ms))
    return {"name": "flash_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "mxnet_tpu/ops/attention.py:38",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "ms_with_lse": ms_lse,
            "call_ms": call_ms, "call_ms_with_lse": call_ms_lse,
            "library_call_ms": lib_call_ms}


# (label, BH, T, Tk, D, dtype, causal, window, band_offset, dlse)
BWD_CASES = [
    ("flagship", 128, 2048, 2048, 128, "bfloat16", True, 0, 0, False),
    ("f32", 4, 256, 256, 64, "float32", True, 0, 0, False),
    ("noncausal", 8, 512, 512, 128, "bfloat16", False, 0, 0, False),
    ("ragged", 6, 200, 333, 64, "bfloat16", True, 0, 0, False),
    ("ragged_f32", 6, 200, 333, 64, "float32", True, 0, 0, True),
    ("window", 8, 512, 512, 128, "bfloat16", True, 64, 0, False),
    ("band_offset", 4, 256, 320, 64, "float32", True, 128, 64, True),
    ("band_offset_bf16", 4, 256, 320, 128, "bfloat16", True, 100, 64,
     True),
    ("band_offset_neg", 4, 256, 256, 128, "bfloat16", True, 0, -40, False),
    ("dlse", 16, 1024, 1024, 128, "bfloat16", True, 0, 0, True),
    ("d16", 8, 300, 300, 16, "bfloat16", True, 0, 0, True),
    ("d64", 8, 512, 512, 64, "bfloat16", True, 0, 0, False),
    ("d16_f32", 4, 130, 97, 16, "float32", False, 0, 0, True),
    ("d128_f32", 4, 128, 128, 128, "float32", True, 0, 0, False),
    # the exact-f32 kernel's tile edges (64-row q tiles, 64-key tiles)
    ("f32_t_gt_tk", 3, 333, 200, 128, "float32", True, 0, 0, True),
    ("f32_t_lt_tk", 3, 130, 300, 128, "float32", True, 0, 0, False),
    ("f32_short", 4, 40, 40, 128, "float32", True, 0, 0, False),
    ("f32_window_ragged", 4, 300, 300, 128, "float32", True, 100, 0, True),
    ("f32_offset_neg", 4, 256, 256, 64, "float32", True, 0, -40, False),
    ("f32_d4", 4, 256, 256, 4, "float32", True, 0, 0, True),
]


# the cases whose two launches must give the same bits
DETERMINISM_CASES = ("flagship", "window", "band_offset_bf16",
                     "band_offset_neg", "noncausal", "ragged_f32",
                     "f32_window_ragged", "f32_offset_neg")


def bwd_kernel_phase():
    """flash_bwd_cuda against both plain versions (_flash_dq_reference,
    _flash_dkv_reference) on the same inputs: q, k, v, do random; o and
    lse from the forward kernel; delta = rowsum(do * o), minus a random
    lse cotangent where the case says so. Two launches bit-equal in
    DETERMINISM_CASES. At the flagship shape: the kernel's device time
    beside the fused bound, the plain versions' time, the library's
    backward, and the port's whole backward (delta, scratch, kernel)
    against the library's by the same CUDA events."""
    import torch
    from mxnet_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(20261017)
    records = []
    for (label, BH, T, Tk, D, dt, causal, window, off,
         dlse) in BWD_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((BH, n, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for n in (T, Tk, Tk))
        do = torch.randn((BH, T, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(dtype)
        scale = D ** -0.5
        o, lse = att.flash_fwd_cuda(q, k, v, scale, causal, window, off,
                                    want_lse=True)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        if dlse:
            delta = delta - torch.randn((BH, T), generator=gen,
                                        device="cuda")
        args = (q, k, v, do, lse, delta, scale, causal, window, off)
        dq, dk, dv = att.flash_bwd_cuda(*args)
        torch.cuda.synchronize()
        errs = {"dq": check_close("flash_bwd %s dq" % label, dq,
                                  att._flash_dq_reference(*args), TOL[dt])}
        rdk, rdv = att._flash_dkv_reference(*args)
        errs["dk"] = check_close("flash_bwd %s dk" % label, dk, rdk,
                                 TOL[dt])
        errs["dv"] = check_close("flash_bwd %s dv" % label, dv, rdv,
                                 TOL[dt])
        del rdk, rdv
        same = ""
        if label in DETERMINISM_CASES:
            again = att.flash_bwd_cuda(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
                if not torch.equal(a, b):
                    fail("flash_bwd %s: two launches differ in %s (%d "
                         "elements)" % (label, name, int((a != b).sum())))
            same = ", two launches bit-equal"
            del again
        say("kernel flash_bwd %-16s BH=%d T=%d Tk=%d D=%d %s causal=%s "
            "window=%d offset=%d dlse=%s: max_abs_err dq %.3g dk %.3g "
            "dv %.3g%s" % (label, BH, T, Tk, D, dt, causal, window, off,
                           dlse, errs["dq"], errs["dk"], errs["dv"], same))
        if label == "flagship":
            records.append(bwd_flagship_timing(args, o, max(errs.values())))
        del q, k, v, do, o, lse, delta, dq, dk, dv, args
    torch.cuda.empty_cache()
    return records


def bwd_flagship_timing(args, o, max_err):
    """The flash_bwd record at the flagship shape: the kernel's device
    time (torch.profiler, by kernel name), its plain versions' time, the
    library's backward (scaled_dot_product_attention's dq, dk, dv, by
    CUDA events), the fused bound; and the port's whole backward
    (_flash_backward: delta, scratch, kernel) beside the library's by
    the same events."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as att

    q, k, v, do, lse, delta, scale, causal, window, off = args
    BH, T, D = q.shape
    Tk = k.shape[1]
    dt = str(q.dtype).replace("torch.", "")
    q4, k4, v4 = (x.view(1, BH, -1, D).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                         scale=scale)
    do4 = do.view(1, BH, T, D)

    def library():
        return torch.autograd.grad(out, (q4, k4, v4), do4,
                                   retain_graph=True)

    def whole():
        return att._flash_backward(q, k, v, o, lse, do, scale, causal,
                                   window, off)

    ms = device_ms(lambda: att.flash_bwd_cuda(*args), "flash_bwd_bf16")
    call_ms = time_ms(lambda: att.flash_bwd_cuda(*args))
    lib_ms = device_ms(library, "")
    # whole backward and library by events, in turns: library, port,
    # port, library
    lib_a, whole_a = time_ms(library), time_ms(whole)
    whole_b, lib_b = time_ms(whole), time_ms(library)
    lib_call_ms = statistics.median([lib_a, lib_b])
    whole_ms = statistics.median([whole_a, whole_b])
    del out, q4, k4, v4
    plain_ms = time_ms(lambda: (att._flash_dq_reference(*args),
                                att._flash_dkv_reference(*args)), reps=5)
    bound, by = flash_bound("fused", T, Tk, D, BH, causal, window, off, dt)
    say("kernel flash_bwd flagship timing: kernel %.4f ms (device time; "
        "%.4f ms by events around the call, zeroed dq and counters "
        "included), plain %.4f ms, library (scaled_dot_product_attention "
        "backward: dq, dk, dv) %.4f ms device time, every kernel of the "
        "call (%.4f ms by events: %.4f, %.4f), fused bound %.4f ms (%s); "
        "%.1f%% of the bf16 peak; kernel against the library %.3fx by "
        "device time" % (
            ms, call_ms, plain_ms, lib_ms, lib_call_ms, lib_a, lib_b, bound,
            by, 100 * bound / ms, ms / lib_ms))
    say("kernel flash_bwd whole backward (delta, scratch, kernel) %.4f ms "
        "(%.4f, %.4f) against the library's %.4f ms, both by events: "
        "%.2fx" % (whole_ms, whole_a, whole_b, lib_call_ms,
                   whole_ms / lib_call_ms))
    return {"name": "flash_bwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "mxnet_tpu/ops/attention.py:279, :331",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "call_ms": call_ms,
            "library_call_ms": lib_call_ms, "whole_backward_ms": whole_ms}


# the grouped-query config of __graft_entry__.py's dryrun
# (transformer.get_symbol(32, 16, num_layers=1, num_heads=4, dim=16,
# num_kv_heads=2)): head dim 4, which the kernels take padded to 8
GQA_B, GQA_HEADS, GQA_KV_HEADS, GQA_T, GQA_D = 2, 4, 2, 16, 4


def gqa_phase():
    """_contrib_FlashAttention at the GQA config's shape: one forward and
    one backward on the card (the flash kernels, one launch each) in
    float32 and bf16, against the same op on the CPU (their plain
    versions), outputs and gradients."""
    import torch
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops.registry import canon_attrs, get_op

    op = get_op("_contrib_FlashAttention")
    attrs = canon_attrs(op, {"causal": True})
    B, H, HKV, T, D = GQA_B, GQA_HEADS, GQA_KV_HEADS, GQA_T, GQA_D
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(shape, np.float32) for shape in (
        (B, H, T, D), (B, HKV, T, D), (B, HKV, T, D), (B, H, T, D))]
    for dt in ("float32", "bfloat16"):
        outs = {}
        for dev in ("cuda", "cpu"):
            q, k, v = (torch.from_numpy(a).to(dev, getattr(torch, dt))
                       .requires_grad_() for a in arrays[:3])
            cot = torch.from_numpy(arrays[3]).to(dev)
            before = (att.flash_fwd_cuda.launches,
                      att.flash_bwd_cuda.launches)
            out = op.fn(q, k, v, **attrs)
            grads = torch.autograd.grad((out.float() * cot).sum(),
                                        (q, k, v))
            if dev == "cuda":
                torch.cuda.synchronize()
                after = (att.flash_fwd_cuda.launches,
                         att.flash_bwd_cuda.launches)
                if after != (before[0] + 1, before[1] + 1):
                    fail("gqa %s: kernel launches %r -> %r, not one each"
                         % (dt, before, after))
            outs[dev] = [x.detach().float().cpu() for x in (out, *grads)]
        errs = [check_close("gqa %s %s" % (dt, name), got, want, TOL[dt])
                for name, got, want in zip(("o", "dq", "dk", "dv"),
                                           outs["cuda"], outs["cpu"])]
        say("gqa: _contrib_FlashAttention B=%d H=%d Hkv=%d T=%d D=%d %s, "
            "card against CPU: max abs err o %.3g dq %.3g dk %.3g dv %.3g"
            % (B, H, HKV, T, D, dt, *errs))


# ---------------------------------------------------------------------------
# path phase
# ---------------------------------------------------------------------------

def random_params(sym, batch_shape, seed):
    """Scaled-normal weights from a numpy seed: N(0, 0.02) matrices and
    embeddings, LayerNorm gamma 1 and beta 0, zero biases."""
    shapes, _, _ = sym.infer_shape(data=batch_shape,
                                   softmax_label=batch_shape)
    rng = np.random.default_rng(seed)
    params = {}
    for name, shp in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shp, np.float32)
        elif name.endswith("_beta") or name.endswith("_bias"):
            params[name] = np.zeros(shp, np.float32)
        else:
            params[name] = rng.standard_normal(shp, np.float32) * 0.02
    return params


class RowAligned:
    """The serving model: the LM's (B*T, V) probabilities reshaped to
    (B, T, V), so ServeEngine can slice rows back per request."""

    def __init__(self, pred, seq):
        self.pred, self.seq = pred, seq

    def forward(self, data, label):
        out = self.pred.forward(data, label)[0].handle
        return [out.reshape(-1, self.seq, out.shape[-1])]


def reference_check():
    """A small f32 LM: the card forward (flash kernel) must agree with
    the CPU forward (the kernel's plain version) from the same weights."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import params_from_jax
    from mxnet_tpu_torch.models import transformer

    T, V = 64, 100
    sym = transformer.get_symbol(V, T, num_layers=2, num_heads=4, dim=64)
    params = random_params(sym, (2, T), seed=7)
    toks = np.random.default_rng(8).integers(0, V, (2, T)).astype(
        np.float32)
    lab = np.zeros((2, T), np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        pred = mx.Predictor(sym, params_from_jax(params, ctx.torch_device()),
                            data_names=("data", "softmax_label"), ctx=ctx)
        outs.append(pred.forward(toks, lab)[0].asnumpy())
    err = float(np.abs(outs[0] - outs[1]).max())
    if not np.allclose(outs[0], outs[1], rtol=1e-4, atol=1e-6):
        fail("small f32 LM: card vs CPU reference max abs err %g" % err)
    say("path reference: small f32 LM card vs CPU max abs err %.3g "
        "(rtol 1e-4, atol 1e-6)" % err)


def eager_walk(sym, args, aux):
    """Evaluate ``sym``'s graph eagerly: ``mx.nd.<op>`` called node by
    node on NDArrays (``args``, ``aux``: name -> NDArray; the aux arrays
    take BatchNorm's writebacks), each node's outputs dropped after their
    last consumer. Under ``autograd.record()`` this is the eager route of
    the graph. Returns the graph's output NDArrays."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.symbol.symbol import _topo_order

    order = _topo_order(sym._entries)
    last = {}
    for pos, node in enumerate(order):
        for m, _i in node.inputs:
            last[id(m)] = pos
    for n, _i in sym._entries:
        last[id(n)] = len(order)
    env = {}
    for pos, node in enumerate(order):
        if node.op is None:
            env[id(node)] = [(aux if node.is_aux else args)[node.name]]
        else:
            out = getattr(mx.nd, node.op.name)(
                *[env[id(m)][i] for m, i in node.inputs], **node.attrs)
            env[id(node)] = out if isinstance(out, list) else [out]
        for m, _i in node.inputs:
            if last.get(id(m)) == pos:
                env.pop(id(m), None)
    return [env[id(n)][i] for n, i in sym._entries]


# kernel-name substrings -> the kind of work, for the profile summary
# (first match wins)
PROFILE_GROUPS = (
    ("flash kernels (this port)", ("flash_fwd", "flash_bwd")),
    ("NMS kernel (this port)", ("nms_cluster_kernel", "nms_kernel")),
    ("BatchNorm kernels (this port)", ("bn_stats", "bn_apply",
                                       "bn_bwd_reduce", "bn_bwd_dx",
                                       "bn_finalize")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "cudnn",
                             "implicit_gemm", "nchwToNhwc", "nhwcToNchw",
                             "conv2d", "Conv", "fft",
                             "pointwise_mult_and_sum_complex")),
    ("pooling", ("pool", "Pool")),
    ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("softmax", ("SoftMax", "softmax")),
    ("reductions", ("reduce_kernel",)),
    ("sort", ("sort", "Sort", "radix")),
    ("embedding scatter/gather", ("index", "scatter", "gather", "cub")),
    ("multi-tensor kernels (this port)", ("mt_update_kernel",
                                          "mt_norm_kernel",
                                          "mt_norm_finalize")),
    ("elementwise", ("elementwise", "Functor", "copy_kernel")),
)


def profile(what, fn, top=8):
    """Where one call's device time goes: a torch.profiler trace of one
    (warm) call, summed by CUDA kernel name, and the share of the wall
    time the card was busy (one stream, so kernels never overlap). The
    kernel names of the call are left in ``profile.names``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        # a marker first: it takes what the trace loses at its start
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    profile.names = set(by_name)
    profile.counts = {name: n for name, (_, n) in by_name.items()}
    profile.busy = busy_ms / wall_ms
    profile.busy_ms = busy_ms
    say("profile: %s: %.2f ms of kernels in %.2f ms wall (device busy "
        "%.1f%%), %d kernel launches" % (
            what, busy_ms, wall_ms, 100 * busy_ms / wall_ms,
            sum(n for _, n in by_name.values())))
    groups = {}
    for name, (ms, n) in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(key in name for key in keys)), "other")
        gms, gn = groups.get(group, (0.0, 0))
        groups[group] = (gms + ms, gn + n)
    say("profile:   by kind: %s" % "; ".join(
        "%s %.3f ms x%d" % (g, ms, n) for g, (ms, n) in
        sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        say("profile:   %7.3f ms %5.1f%% x%-3d %s" % (
            ms, 100 * ms / busy_ms, n, name[:90]))
    return out


profile.names = set()
profile.counts = {}
profile.busy = 0.0
profile.busy_ms = 0.0


def kernel_counts(counts, keys):
    """{key: launches of the kernels whose name holds key} from
    ``profile.counts``."""
    return {k: sum(n for name, n in counts.items() if k in name)
            for k in keys}


def path_phase(counters):
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import params_from_jax
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import ServeEngine

    reference_check()

    t0 = time.perf_counter()
    sym = transformer.get_symbol(VOCAB, SEQ, num_layers=LAYERS,
                                 num_heads=HEADS, dim=DIM)
    params = random_params(sym, (1, SEQ), seed=0)
    nparam = sum(p.size for p in params.values())
    device = mx.current_context().torch_device()
    pred = mx.Predictor(sym, params_from_jax(params, device,
                                             dtype="bfloat16"),
                        data_names=("data", "softmax_label"))
    del params
    say("path: flagship LM %d params (%.1f M) in bf16 on %s, set up in "
        "%.1f s" % (nparam, nparam / 1e6, pred.device,
                    time.perf_counter() - t0))
    model = RowAligned(pred, SEQ)
    rng = np.random.default_rng(1)

    # forward time per bucket, outside the engine (device time of the
    # whole forward: host clock around work that ends in a synchronize)
    for b in BUCKETS:
        toks = rng.integers(0, VOCAB, (b, SEQ)).astype(np.float32)
        lab = np.zeros((b, SEQ), np.float32)
        model.forward(toks, lab)
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            t = time.perf_counter()
            model.forward(toks, lab)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        say("path: forward bucket %d: %.2f ms (median of 3)"
            % (b, statistics.median(ts)))
    profile("bucket %d forward" % toks.shape[0],
            lambda: model.forward(toks, lab))

    engine = ServeEngine(model, buckets=BUCKETS, max_wait_ms=200.0,
                         feature_shapes=[(SEQ,), (SEQ,)])
    requests = [rng.integers(0, VOCAB, (r, SEQ)).astype(np.float32)
                for r in REQUEST_ROWS]
    results = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def client(i):
        barrier.wait()
        results[i] = engine.infer(
            requests[i], np.zeros_like(requests[i]), timeout=600)

    for c in counters:
        c.launches = 0
    fwd0 = engine.stats()["forwards"]
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    t_serve = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    serve_s = time.perf_counter() - t_serve
    launches = {c.__name__: c.launches for c in counters}
    stats = engine.stats()
    engine.close()
    forwards = stats["forwards"] - fwd0
    if any(r is None for r in results) or any(th.is_alive()
                                              for th in threads):
        fail("path: not every request got a response")
    say("path: %d requests (%d rows) in %d engine forwards, %.3f s: "
        "%.2f requests/s; mean fill %.2f" % (
            len(requests), sum(REQUEST_ROWS), forwards, serve_s,
            len(requests) / serve_s, stats["mean_fill"]))
    for name, n in launches.items():
        if n == 0:
            fail("path: kernel %s was not launched on the main path" % name)
    if launches["flash_fwd_cuda"] != LAYERS * forwards:
        fail("path: flash_fwd launches %d != %d layers x %d forwards"
             % (launches["flash_fwd_cuda"], LAYERS, forwards))

    worst = 0.0
    for i, (toks, res) in enumerate(zip(requests, results)):
        probs = res[0]
        if probs.shape != (toks.shape[0], SEQ, VOCAB):
            fail("path: response %d shape %r" % (i, probs.shape))
        if not np.isfinite(probs).all():
            fail("path: response %d has non-finite values" % i)
        sums = probs.sum(axis=-1, dtype=np.float64)
        if np.abs(sums - 1.0).max() > 1e-2:
            fail("path: response %d rows sum to %g..%g"
                 % (i, sums.min(), sums.max()))
        alone = model.forward(toks, np.zeros_like(toks))[0]
        alone = alone.float().cpu().numpy()
        diff = float(np.abs(probs - alone).max())
        scale = float(np.abs(alone).max())
        worst = max(worst, diff / scale)
        if diff > 2e-2 * scale:
            fail("path: response %d differs from the predictor alone by "
                 "%g (max prob %g)" % (i, diff, scale))
    say("path: every response checked: shape, finite, rows sum to 1 "
        "within 1e-2, equal to the predictor alone within 2e-2 of the "
        "max prob (worst %.3g)" % worst)
    return launches


# ---------------------------------------------------------------------------
# SSD300 (VGG16-reduced): the detection slice's model
# ---------------------------------------------------------------------------

# upstream MXNet example/ssd: symbol_factory.get_config('vgg16_reduced',
# 300) -> symbol_builder.get_symbol over vgg16_reduced.get_symbol and
# common.multi_layer_feature / multibox_layer
SSD_FROM_LAYERS = ("relu4_3", "relu7", "", "", "", "")
SSD_NUM_FILTERS = (512, -1, 512, 256, 256, 256)
SSD_STRIDES = (-1, -1, 2, 2, 1, 1)
SSD_PADS = (-1, -1, 1, 1, 0, 0)
SSD_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
             (.88, .961))
SSD_RATIOS = ((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5, 3, 1. / 3),
              (1, 2, .5, 3, 1. / 3), (1, 2, .5), (1, 2, .5))
SSD_NORMALIZATIONS = (20, -1, -1, -1, -1, -1)
SSD_STEPS = tuple(x / 300.0 for x in (8, 16, 32, 64, 100, 300))
SSD_ANCHORS = 8732      # 38^2*4 + 19^2*6 + 10^2*6 + 5^2*6 + 3^2*4 + 1*4
SSD_NMS = dict(nms_threshold=0.45, nms_topk=400, force_suppress=False,
               variances=(0.1, 0.1, 0.2, 0.2))


def ssd300_symbol(S, num_classes=20, width_div=1, impl="auto",
                  heads=False):
    """SSD300 inference over the VGG16-reduced body, written once against
    the MXNet symbol API both packages share: ``S`` is ``mxnet_tpu.sym``
    or ``mxnet_tpu_torch.sym``. Output (B, 8732, 6) detections [class,
    score, x1, y1, x2, y2] from a (B, 3, 300, 300) ``data``; with
    ``heads``, instead the detection op's three inputs (cls_prob
    (B, C, 8732), loc_preds (B, 8732*4), anchors (1, 8732, 4)).
    ``width_div`` divides every convolution's width (small models for
    the CPU tests); ``impl`` is MultiBoxDetection's NMS route."""

    def conv(x, name, nf, kernel=(3, 3), pad=(1, 1), stride=(1, 1),
             dilate=(1, 1)):
        return S.Convolution(x, kernel=kernel, pad=pad, stride=stride,
                             dilate=dilate, num_filter=max(1, nf // width_div),
                             name=name)

    def relu(x, name):
        return S.Activation(x, act_type="relu", name=name)

    # vgg16_reduced.py, up to relu7
    x = S.Variable("data")
    layers = {}
    for g, (n_conv, nf) in enumerate(((2, 64), (2, 128), (3, 256),
                                      (3, 512), (3, 512)), 1):
        for i in range(1, n_conv + 1):
            x = relu(conv(x, "conv%d_%d" % (g, i), nf), "relu%d_%d" % (g, i))
        layers["relu%d_%d" % (g, n_conv)] = x
        if g == 5:
            x = S.Pooling(x, pool_type="max", kernel=(3, 3), stride=(1, 1),
                          pad=(1, 1), name="pool5")
        else:
            x = S.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                          pooling_convention="full" if g == 3 else "valid",
                          name="pool%d" % g)
    x = relu(conv(x, "fc6", 1024, pad=(6, 6), dilate=(6, 6)), "relu6")
    layers["relu7"] = relu(conv(x, "fc7", 1024, kernel=(1, 1), pad=(0, 0)),
                           "relu7")

    # common.multi_layer_feature (min_filter 128)
    feats = []
    for k, (src, nf, s, p) in enumerate(zip(SSD_FROM_LAYERS, SSD_NUM_FILTERS,
                                            SSD_STRIDES, SSD_PADS)):
        if src:
            feats.append((src, layers[src]))
            continue
        name = "multi_feat_%d_conv" % k
        x = relu(conv(feats[-1][1], name + "_1x1_conv", max(128, nf // 2),
                      kernel=(1, 1), pad=(0, 0)), name + "_1x1_relu")
        x = relu(conv(x, name + "_3x3_conv", nf, pad=(p, p), stride=(s, s)),
                 name + "_3x3_relu")
        feats.append((name + "_3x3_relu", x))

    # common.multibox_layer (clip=False, interm_layer=0)
    C = num_classes + 1
    locs, clss, anchors = [], [], []
    for k, (name, x) in enumerate(feats):
        if SSD_NORMALIZATIONS[k] > 0:
            x = S.L2Normalization(x, mode="channel", name=name + "_norm")
            scale = S.Variable(name + "_scale", shape=(
                1, max(1, SSD_NUM_FILTERS[k] // width_div), 1, 1))
            x = S.broadcast_mul(scale, x)
        n_anchor = len(SSD_SIZES[k]) - 1 + len(SSD_RATIOS[k])
        for out, width in ((locs, 4), (clss, C)):
            head = S.Convolution(x, kernel=(3, 3), pad=(1, 1),
                                 num_filter=n_anchor * width,
                                 name="%s_%s_pred_conv" % (
                                     name, "loc" if width == 4 else "cls"))
            out.append(S.Flatten(S.transpose(head, axes=(0, 2, 3, 1))))
        anchors.append(S.Flatten(S.contrib.MultiBoxPrior(
            x, sizes=SSD_SIZES[k], ratios=SSD_RATIOS[k], clip=False,
            steps=(SSD_STEPS[k], SSD_STEPS[k]), name=name + "_anchors")))
    loc_preds = S.Concat(*locs, num_args=len(locs), dim=1,
                         name="multibox_loc_pred")
    cls_preds = S.transpose(S.reshape(S.Concat(*clss, num_args=len(clss),
                                               dim=1), shape=(0, -1, C)),
                            axes=(0, 2, 1), name="multibox_cls_pred")
    anchor_boxes = S.reshape(S.Concat(*anchors, num_args=len(anchors),
                                      dim=1), shape=(0, -1, 4),
                             name="multibox_anchors")
    cls_prob = S.SoftmaxActivation(cls_preds, mode="channel",
                                   name="cls_prob")
    if heads:
        return S.Group([cls_prob, loc_preds, anchor_boxes])
    return S.contrib.MultiBoxDetection(cls_prob, loc_preds, anchor_boxes,
                                       name="detection", impl=impl,
                                       **SSD_NMS)


# ---------------------------------------------------------------------------
# train path
# ---------------------------------------------------------------------------

def mean_nll(probs, labels):
    """Mean NLL of (rows, classes) probabilities on the card at the
    labels that are not -1 (the LM's (B*T, V) rows, ResNet's (B, 1000))."""
    import torch
    lab = labels.reshape(-1).long()
    valid = lab >= 0
    p = probs.gather(1, lab.clamp_min(0)[:, None])[:, 0].float()
    return float(-torch.log(p.clamp_min(1e-9))[valid].mean().item())


def train_reference_check():
    """A small f32 LM: one SGD-momentum step on the card (f32 flash
    kernels forward and backward) must give the parameters the same step
    gives on the CPU (the kernels' plain versions), from one seeded
    Xavier init."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step

    T, V, B = 64, 100, 2
    sym = transformer.get_symbol(V, T, num_layers=2, num_heads=4, dim=64)
    rng = np.random.RandomState(9)
    toks = rng.randint(0, V, (B, T)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    after = []
    for ctx in (mx.gpu(0), mx.cpu()):
        step = make_train_step(sym, optimizer="sgd", ctx=ctx,
                               optimizer_params={"momentum": 0.9})
        mx.random.seed(7)
        state = step.init_state(Xavier(), {"data": (B, T),
                                           "softmax_label": (B, T)})
        state, _ = step(state, {"data": toks, "softmax_label": labels},
                        0.1, 0)
        after.append({n: v.cpu().numpy() for n, v in state[0].items()})
    worst = 0.0
    for n, w in after[0].items():
        worst = max(worst, float(np.abs(w - after[1][n]).max()))
        if not np.allclose(w, after[1][n], rtol=1e-4, atol=1e-6):
            fail("small f32 LM train step: %s on the card differs from "
                 "the CPU by %g" % (n, np.abs(w - after[1][n]).max()))
    say("train reference: small f32 LM one-step parameters, card vs CPU "
        "max abs err %.3g (rtol 1e-4, atol 1e-6)" % worst)


def train_phase(counters):
    """The flagship LM trained exactly as bench.py's bench_transformer
    builds it, through make_train_step -> init_state(Xavier()) -> step.
    Returns the kernels' launch counts over the run."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step

    train_reference_check()

    B = TRAIN_BATCH
    t0 = time.perf_counter()
    sym = transformer.get_symbol(VOCAB, SEQ, num_layers=LAYERS,
                                 num_heads=HEADS, dim=DIM,
                                 ffn_hidden=4 * DIM)
    step = make_train_step(sym, optimizer="adam",
                           optimizer_params={"rescale_grad": 1.0 / B},
                           compute_dtype="bfloat16")
    rng_np = np.random.RandomState(0)
    toks = rng_np.randint(0, VOCAB, (B, SEQ)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    mx.random.seed(0)
    state = step.init_state(Xavier(), {"data": (B, SEQ),
                                       "softmax_label": (B, SEQ)})
    batch = step.place_batch({"data": toks, "softmax_label": labels})
    nparam = sum(v.numel() for v in state[0].values())
    say("train: flagship LM %d params (%.1f M), batch %d x %d, Adam lr %g, "
        "bf16 compute, on %s, set up in %.1f s" % (
            nparam, nparam / 1e6, B, SEQ, TRAIN_LR, step.device,
            time.perf_counter() - t0))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    reset_mt_counts()
    nlls, times = [], []
    for i in range(WARM_STEPS + TIMED_STEPS):
        t = time.perf_counter()
        if i == 1:   # the second warm step, under the profiler
            state, outs = profile("train step (warm)", lambda: step(
                state, batch, TRAIN_LR, i), top=14)
        else:
            state, outs = step(state, batch, TRAIN_LR, i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        nlls.append(mean_nll(outs[0], batch["softmax_label"]))
        del outs
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    TRAIN_PEAK_GB["dense"] = peak_gb
    steps = WARM_STEPS + TIMED_STEPS
    step_ms = statistics.median(times[WARM_STEPS:])
    say("train: NLL per step %s" % " ".join("%.4f" % x for x in nlls))
    say("train: step %.2f ms (median of %d timed steps; all: %s), %.0f "
        "tokens/s, peak device memory %.2f GB" % (
            step_ms, TIMED_STEPS, " ".join("%.1f" % x for x in times),
            B * SEQ / step_ms * 1e3, peak_gb))
    if not all(np.isfinite(nlls)):
        fail("train: non-finite loss %r" % (nlls,))
    if not nlls[-1] < nlls[0]:
        fail("train: NLL did not fall: first %g, last %g"
             % (nlls[0], nlls[-1]))
    for name, n in launches.items():
        if n != LAYERS * steps:
            fail("train: %s launched %d times, not %d layers x %d steps"
                 % (name, n, LAYERS, steps))
    launches.update(check_mt_counts("train", steps, len(state[0])))
    say("train: launches %s (%d layers x %d steps each; the multi-tensor "
        "update once a step (under 256 parameters), the reduction never: no "
        "guard, no clip_norm)"
        % (", ".join("%s %d" % kv for kv in sorted(launches.items())),
           LAYERS, steps))
    del state, batch, step
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the exact-f32 flash kernels at the flagship shape
# ---------------------------------------------------------------------------

F32_SHAPE = (128, 2048, 128)     # BH, T, D of the flagship LM, causal


def f32_kernel_phase(ptxas=()):
    """The exact-f32 flash kernels (the route a float32 graph takes) at
    the flagship shape, causal: the forward (flash_fwd_f32) against
    _flash_fwd_reference (o and lse), the fused backward (flash_bwd_f32)
    against _flash_dq_reference/_flash_dkv_reference, each kernel's device
    time (torch.profiler, by name) beside its bound (flash_bound in
    float32; the backward's the fused count) and its share of the FFMA
    peak, its registers and spills (the build's ``ptxas`` lines), the
    plain versions' times, and scaled_dot_product_attention's float32
    forward and backward as the library yardsticks."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as att

    BH, T, D = F32_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(20261018)
    q, k, v, do = (torch.randn((BH, T, D), generator=gen, device="cuda")
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = att.flash_fwd_cuda(q, k, v, scale, True, want_lse=True)
    torch.cuda.synchronize()
    ro, rlse = att._flash_fwd_reference(q, k, v, scale, True)
    fwd_err = check_close("flash_fwd f32 flagship", o, ro, FWD_TOL["float32"])
    lse_err = float((lse - rlse).abs().max().item())
    if lse_err > LSE_TOL["atol"] + LSE_TOL["rtol"] * float(
            rlse.abs().max().item()):
        fail("flash_fwd f32 flagship: lse max abs err %g" % lse_err)
    del ro, rlse
    delta = torch.sum(do * o, dim=-1)
    args = (q, k, v, do, lse, delta, scale, True, 0, 0)
    dq, dk, dv = att.flash_bwd_cuda(*args)
    torch.cuda.synchronize()
    errs = [check_close("flash_bwd f32 flagship dq", dq,
                        att._flash_dq_reference(*args), TOL["float32"])]
    rdk, rdv = att._flash_dkv_reference(*args)
    errs += [check_close("flash_bwd f32 flagship dk", dk, rdk,
                         TOL["float32"]),
             check_close("flash_bwd f32 flagship dv", dv, rdv,
                         TOL["float32"])]
    del rdk, rdv, dq, dk, dv
    torch.cuda.empty_cache()

    def fwd():
        return att.flash_fwd_cuda(q, k, v, scale, True, want_lse=True)

    def bwd():
        return att.flash_bwd_cuda(*args)

    fwd_ms = device_ms(fwd, "flash_fwd_f32", reps=5)
    bwd_ms = device_ms(bwd, "flash_bwd_f32", reps=5)
    fwd_call, bwd_call = time_ms(fwd, reps=5, warmup=1), \
        time_ms(bwd, reps=5, warmup=1)
    plain_fwd = time_ms(lambda: att._flash_fwd_reference(q, k, v, scale,
                                                         True), reps=3,
                        warmup=1)
    plain_bwd = time_ms(lambda: (att._flash_dq_reference(*args),
                                 att._flash_dkv_reference(*args)), reps=3,
                        warmup=1)
    q4, k4, v4 = (x.view(1, BH, T, D).detach().requires_grad_()
                  for x in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              scale=scale)

    out = lib_fwd()
    do4 = do.view(1, BH, T, D)

    def lib_bwd():
        return torch.autograd.grad(out, (q4, k4, v4), do4,
                                   retain_graph=True)

    lib_fwd_ms, lib_bwd_ms = device_ms(lib_fwd, "", reps=5), \
        device_ms(lib_bwd, "", reps=5)
    del out, q4, k4, v4
    b_fwd, by_fwd = flash_bound("fwd", T, T, D, BH, True, 0, 0, "float32")
    b_bwd, by_bwd = flash_bound("fused", T, T, D, BH, True, 0, 0, "float32")
    regs = {name: next((line.split(": ", 1)[1] for line in ptxas
                        if line.startswith(name + "<%d>" % D)),
                       "not in this run's build log")
            for name in ("flash_fwd_f32", "flash_bwd_f32")}
    say("kernel flash f32 flagship BH=%d T=%d D=%d causal: forward "
        "flash_fwd_f32 %.4f ms device time (%.4f by events; bound %.4f ms, "
        "%s; %.1f%% of the f32 FFMA peak; %s), lse err %.3g, max abs err "
        "%.3g; backward flash_bwd_f32 %.4f ms device time (%.4f by events; "
        "fused bound %.4f ms, %s; %.1f%% of the FFMA peak; %s), max abs err "
        "dq %.3g dk %.3g dv %.3g; plain forward %.4f ms, backward %.4f ms; "
        "library (scaled_dot_product_attention, f32) forward %.4f ms, "
        "backward %.4f ms device time; kernel against library %.3fx "
        "forward, %.3fx backward" % (
            BH, T, D, fwd_ms, fwd_call, b_fwd, by_fwd, 100 * b_fwd / fwd_ms,
            regs["flash_fwd_f32"], lse_err, fwd_err, bwd_ms, bwd_call, b_bwd,
            by_bwd, 100 * b_bwd / bwd_ms, regs["flash_bwd_f32"], *errs,
            plain_fwd, plain_bwd, lib_fwd_ms, lib_bwd_ms,
            fwd_ms / lib_fwd_ms, bwd_ms / lib_bwd_ms))
    del q, k, v, do, o, lse, delta, args
    torch.cuda.empty_cache()
    return [{"name": "flash_fwd_f32", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "mxnet_tpu/ops/attention.py:38",
             "launches": None, "max_abs_err": fwd_err, "ms": fwd_ms,
             "plain_ms": plain_fwd, "bound_ms": b_fwd, "bound_by": by_fwd,
             "library_ms": lib_fwd_ms, "call_ms": fwd_call,
             "ffma_peak_share": b_fwd / fwd_ms,
             "registers": regs["flash_fwd_f32"]},
            {"name": "flash_bwd_f32", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "mxnet_tpu/ops/attention.py:279, :331",
             "launches": None, "max_abs_err": max(errs), "ms": bwd_ms,
             "plain_ms": plain_bwd, "bound_ms": b_bwd, "bound_by": by_bwd,
             "library_ms": lib_bwd_ms, "call_ms": bwd_call,
             "ffma_peak_share": b_bwd / bwd_ms,
             "registers": regs["flash_bwd_f32"]}]


# ---------------------------------------------------------------------------
# executor/eager phase: the flagship LM bound in float32
# ---------------------------------------------------------------------------

EXEC_BATCH = 8
EXEC_WARM, EXEC_TIMED = 2, 5
EAGER_WARM, EAGER_TIMED = 1, 3
# gradients of two routes that run the same functions: equal, or within
# rtol 1e-5 and atol 1e-6 * max|g| where cuBLAS's choices differ
GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-6


def _flash_counters():
    from mxnet_tpu_torch.ops import attention as att
    return att.flash_fwd_cuda, att.flash_bwd_cuda


def _reset_flash_counts():
    for c in _flash_counters():
        c.launches = c.launches_f32 = 0


def _flash_counts(what, runs):
    """Launch counts of the last ``runs`` forward-and-backwards, keyed as
    the kernels line reads them: the exact-f32 kernels, and the bf16
    kernels (which must be 0 on a float32 path). Fails unless each f32
    kernel ran once a layer a run."""
    fwd, bwd = _flash_counters()
    counts = {"flash_fwd_f32_cuda": fwd.launches_f32,
              "flash_bwd_f32_cuda": bwd.launches_f32,
              "flash_fwd_cuda": fwd.launches - fwd.launches_f32,
              "flash_bwd_cuda": bwd.launches - bwd.launches_f32}
    for name in ("flash_fwd_f32_cuda", "flash_bwd_f32_cuda"):
        if counts[name] != LAYERS * runs:
            fail("%s: %s launched %d times, not %d layers x %d runs"
                 % (what, name, counts[name], LAYERS, runs))
    for name in ("flash_fwd_cuda", "flash_bwd_cuda"):
        if counts[name]:
            fail("%s: the bf16 kernel of %s launched %d times on a float32 "
                 "path" % (what, name, counts[name]))
    return counts


def _check_f32_flash_names(what, names):
    """The profiled float32 step ran the exact-f32 forward and the fused
    f32 backward, and no other flash kernel (neither bf16 nor the two-pass
    f32 backward that the fused one replaced)."""
    flash = {n for n in names if "flash_" in n}
    for kernel in ("flash_fwd_f32", "flash_bwd_f32"):
        if not any(kernel in n for n in flash):
            fail("%s: the profiled step ran no %s" % (what, kernel))
    stray = [n for n in flash if not ("flash_fwd_f32" in n
                                      or "flash_bwd_f32" in n)]
    if stray:
        fail("%s: the profiled float32 step ran other flash kernels: %s"
             % (what, ", ".join(sorted(stray))))


def compare_grads(what, got, want):
    """Fail unless every gradient of ``got`` equals ``want``'s, or lies
    within GRAD_RTOL and GRAD_ATOL_REL * max|g|; returns (number equal
    bit for bit, worst abs difference, worst relative to max|g|)."""
    import torch
    equal, worst, worst_rel = 0, 0.0, 0.0
    for n, w in want.items():
        g = got[n]
        if torch.equal(g, w):
            equal += 1
            continue
        diff = float((g - w).abs().max().item())
        scale = float(w.abs().max().item())
        worst, worst_rel = max(worst, diff), max(worst_rel,
                                                 diff / max(scale, 1e-30))
        bad = (g - w).abs() > GRAD_ATOL_REL * scale + GRAD_RTOL * w.abs()
        if not torch.isfinite(g).all() or bad.any():
            fail("%s: gradient %s differs by %g (max|g| %g)"
                 % (what, n, diff, scale))
    return equal, worst, worst_rel


def _small_lm_executor(ctx, sym, params, feed):
    exe = sym.simple_bind(ctx=ctx, data=feed["data"].shape,
                          softmax_label=feed["softmax_label"].shape)
    exe.copy_params_from(params)
    exe.forward(is_train=True, **feed)
    exe.backward()
    return {"out": exe.outputs[0].asnumpy(),
            **{n: g.asnumpy() for n, g in exe.grad_dict.items()
               if n in params}}


def executor_reference_checks():
    """Card against CPU, small and untimed: a 2-layer narrow f32 LM
    through the Executor (outputs and gradients); a small f32 ResNet
    through the Executor on the BatchNorm kernels (the moving stats
    written back and the gradients, against the CPU's float64 run); the
    eager MLP recipe (numpy init, autograd.record, sgd_update(out=p))
    with a falling loss."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.models import resnet, transformer
    from mxnet_tpu_torch.ops import bn_kernels as bnk

    T, V, B = 64, 100, 2
    sym = transformer.get_symbol(V, T, num_layers=2, num_heads=4, dim=64)
    params = random_params(sym, (B, T), seed=12)
    rng = np.random.RandomState(13)
    toks = rng.randint(0, V, (B, T)).astype(np.float32)
    lab = np.roll(toks, -1, axis=1)
    lab[:, -1] = -1
    feed = {"data": toks, "softmax_label": lab}
    card, host = (_small_lm_executor(ctx, sym, params, feed)
                  for ctx in (mx.gpu(0), mx.cpu()))
    worst = 0.0
    for n, want in host.items():
        worst = max(worst, float(np.abs(card[n] - want).max()))
        if not np.allclose(card[n], want, rtol=1e-4, atol=1e-6):
            fail("small f32 LM executor: %s on the card differs from the "
                 "CPU by %g" % (n, np.abs(card[n] - want).max()))
    say("executor reference: small f32 LM (2 layers, dim 64) forward and "
        "backward through the Executor, card vs CPU, %d gradients: max abs "
        "err %.3g (rtol 1e-4, atol 1e-6)" % (len(host) - 1, worst))

    S = SMALL_IMAGE
    rsym = resnet.get_symbol(num_classes=10, num_layers=SMALL_LAYERS,
                             image_shape=(3, S, S))
    shapes = {"data": (SMALL_BATCH, 3, S, S), "softmax_label": (SMALL_BATCH,)}
    arg_shapes, _, aux_shapes = rsym.infer_shape(**shapes)
    rng = np.random.RandomState(14)
    rparams = {n: (rng.standard_normal(s) * (0.1 if len(s) > 1 else 0.05)
                   + (1.0 if n.endswith("gamma") else 0.0)).astype(
                       np.float32)
               for n, s in zip(rsym.list_arguments(), arg_shapes)
               if n not in shapes}
    raux = {n: (rng.rand(*s) + 0.5 if n.endswith("var") else
                rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in zip(rsym.list_auxiliary_states(), aux_shapes)}
    rfeed = {"data": rng.standard_normal(shapes["data"]).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (SMALL_BATCH,)).astype(
                 np.float32)}
    # the card on the BatchNorm kernels, with cuDNN's convolutions (as
    # the model runs) and with PyTorch's native ones (float32-exact); the
    # CPU in float64, the reference
    import torch
    results = {}
    for key, ctx, dt, cudnn in (("card", mx.gpu(0), "float32", True),
                                ("card_native_conv", mx.gpu(0), "float32",
                                 False),
                                ("cpu64", mx.cpu(), "float64", True)):
        config.set_override("MXNET_BN_PALLAS", dt == "float32")
        before = bnk.bn_stats_cuda.launches
        # the switch alone: cudnn.flags() would also reset allow_tf32
        torch.backends.cudnn.enabled = cudnn
        exe = rsym.simple_bind(ctx=ctx, type_dict={"data": dt}, **shapes)
        exe.copy_params_from(rparams, raux)
        exe.forward(is_train=True, **rfeed)
        exe.backward()
        torch.backends.cudnn.enabled = True
        results[key] = (
            {n: exe.grad_dict[n].asnumpy().astype(np.float64)
             for n in rparams},
            {n: a.asnumpy() for n, a in exe.aux_dict.items()})
        if ctx.device_type == "gpu" and bnk.bn_stats_cuda.launches == before:
            fail("small ResNet executor: the BatchNorm kernels did not run")
    config.set_override("MXNET_BN_PALLAS", None)
    g64, aux64 = results["cpu64"]
    norm64 = float(np.sqrt(sum(np.sum(g ** 2) for g in g64.values())))
    def rel_dist(got, want):
        return float(np.sqrt(sum(np.sum((got[n] - want[n]) ** 2)
                                 for n in want)) / np.sqrt(
            sum(np.sum(w.astype(np.float64) ** 2) for w in want.values())))

    dists, aux_dists, worst_aux = {}, {}, 0.0
    for key in ("card", "card_native_conv"):
        grads, aux = results[key]
        if not all(np.isfinite(x).all() for x in list(grads.values())
                   + list(aux.values())):
            fail("small ResNet executor (%s): non-finite values" % key)
        if sum(not np.array_equal(aux[n], v) for n, v in raux.items()) \
                != len(raux):
            fail("small ResNet executor (%s): not every moving stat was "
                 "written back" % key)
        dists[key], aux_dists[key] = rel_dist(grads, g64), rel_dist(aux,
                                                                    aux64)
    for n, want in aux64.items():
        got = results["card_native_conv"][1][n]
        worst_aux = max(worst_aux, float(np.abs(got - want).max()))
        if not np.allclose(got, want, **SMALL_TOL):
            fail("small ResNet executor: moving stat %s differs from the "
                 "CPU's by %g" % (n, np.abs(got - want).max()))
    # a relu or max-pool input within rounding of a tie flips the
    # gradient's path, so the float32 gradients of a deep ResNet hang on
    # the convolutions' rounding: cuDNN's algorithms (TF32 off; Winograd
    # and FFT ones among them) round each convolution to ~1e-6 relative
    # against PyTorch's own kernels' ~2e-7 (tools/conv_precision.py),
    # which put these gradients 3.5% (in norm) from float64, against
    # 6e-6 (the script on an H100). So: with PyTorch's convolutions the
    # gradients are held to the float64 ones within 1e-4 (relative, in
    # norm) and the moving stats elementwise; with cuDNN's, within 10%
    # and 1e-3
    if not (dists["card_native_conv"] <= 1e-4 and dists["card"] <= 0.1
            and aux_dists["card"] <= 1e-3):
        fail("small ResNet executor: gradients %.3g (native convolutions) "
             "and %.3g (cuDNN), moving stats %.3g (cuDNN) from the CPU's "
             "float64 ones, relative in norm" % (
                 dists["card_native_conv"], dists["card"],
                 aux_dists["card"]))
    say("executor reference: small f32 ResNet-%d forward and backward "
        "through the Executor on the BatchNorm kernels, card vs CPU "
        "float64, with PyTorch's convolutions: %d moving stats all written "
        "back, max abs err %.3g (rtol %g, atol %g), %d gradients %.3g from "
        "the float64 ones (relative, in norm; limit 1e-4); with cuDNN's: "
        "gradients %.3g (limit 0.1), moving stats %.3g (limit 1e-3)" % (
            SMALL_LAYERS, len(raux), worst_aux, SMALL_TOL["rtol"],
            SMALL_TOL["atol"], len(rparams), dists["card_native_conv"],
            dists["card"], aux_dists["card"]))

    losses = [eager_mlp_recipe(ctx) for ctx in (mx.gpu(0), mx.cpu())]
    if not np.allclose(losses[0], losses[1], rtol=1e-4, atol=1e-6):
        fail("eager MLP recipe: card losses %r differ from the CPU's %r"
             % (losses[0][-3:], losses[1][-3:]))
    if not losses[0][-1] < 0.5 * losses[0][0]:
        fail("eager MLP recipe: loss did not fall (%g -> %g)"
             % (losses[0][0], losses[0][-1]))
    say("executor reference: eager MLP recipe on gpu(0): loss per sample "
        "%.4f -> %.4f over %d epochs, card vs CPU max abs diff %.3g"
        % (losses[0][0], losses[0][-1], len(losses[0]),
           float(np.abs(np.array(losses[0]) - np.array(losses[1])).max())))


def eager_mlp_recipe(ctx, epochs=60):
    """The imperative recipe of the repository's verify notes, with numpy
    initialisation, on ``ctx``: the loss per sample after each epoch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    rng = np.random.RandomState(0)
    N = 256
    X = rng.randn(N, 20).astype(np.float32)
    y = (X @ rng.randn(20, 1).astype(np.float32) > 0).astype(
        np.float32).ravel()
    with ctx:
        w1, b1 = nd.array(rng.randn(64, 20) * .1), nd.zeros((64,))
        w2, b2 = nd.array(rng.randn(2, 64) * .1), nd.zeros((2,))
        ps = [w1, b1, w2, b2]
        for p in ps:
            p.attach_grad()
        d, lab = nd.array(X), nd.array(y)
        losses = []
        for _ in range(epochs):
            with autograd.record():
                h = nd.relu(nd.FullyConnected(d, w1, b1, num_hidden=64))
                loss = nd.softmax_cross_entropy(
                    nd.FullyConnected(h, w2, b2, num_hidden=2), lab)
            loss.backward()
            for p in ps:
                nd.sgd_update(p, p.grad, lr=.1, rescale_grad=1. / N, out=p)
            losses.append(float(loss.asscalar()) / N)
    return losses


def eager_dispatch_us():
    """Host time of one eager op call (``invoke_eager``) on the card, a
    tiny input so the device time is negligible: (outside record, under
    record with a variable), microseconds a call."""
    import torch
    import mxnet_tpu_torch as mx
    x = mx.nd.ones((4,), ctx=mx.gpu(0))
    x.attach_grad()
    out = []
    for recording in (False, True):
        with mx.autograd.record() if recording else mx.autograd.pause():
            for _ in range(50):
                mx.nd.relu(x)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(1000):
                mx.nd.relu(x)
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def executor_phase():
    """The flagship LM bound in float32 through the Executor
    (simple_bind -> copy_params_from -> forward(is_train=True) ->
    backward()), through the eager walk (mx.nd node by node under
    autograd.record(), parameters attach_grad'ed, loss.backward()) and
    through TrainStep._grads, from one set of weights and one batch.
    Returns {"executor": counts, "eager": counts}."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step
    from mxnet_tpu_torch.symbol.symbol import _topo_order

    executor_reference_checks()

    B = EXEC_BATCH
    t0 = time.perf_counter()
    sym = transformer.get_symbol(VOCAB, SEQ, num_layers=LAYERS,
                                 num_heads=HEADS, dim=DIM,
                                 ffn_hidden=4 * DIM)
    params = random_params(sym, (B, SEQ), seed=0)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, VOCAB, (B, SEQ)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    feed = {"data": toks, "softmax_label": labels}
    nparam = sum(p.size for p in params.values())
    say("executor: flagship LM %d params (%.1f M), batch %d x %d, float32, "
        "weights from a numpy seed, set up in %.1f s" % (
            nparam, nparam / 1e6, B, SEQ, time.perf_counter() - t0))
    lab_t = torch.from_numpy(labels).cuda()

    # -- route 1: the Executor ----------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    exe = sym.simple_bind(ctx=mx.gpu(0), data=(B, SEQ),
                          softmax_label=(B, SEQ))
    exe.copy_params_from(params)
    for k, v in feed.items():
        exe.arg_dict[k][:] = v
    bound_gb = torch.cuda.memory_allocated() / 1e9

    def exec_step():
        exe.forward(is_train=True)
        exe.backward()

    _reset_flash_counts()
    times = []
    for i in range(EXEC_WARM + EXEC_TIMED):
        t = time.perf_counter()
        if i == 1:
            profile("executor forward+backward (warm), float32", exec_step,
                    top=12)
            _check_f32_flash_names("executor", profile.names)
        else:
            exec_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    exec_counts = _flash_counts("executor", EXEC_WARM + EXEC_TIMED)
    exec_peak = torch.cuda.max_memory_allocated() / 1e9
    held = torch.cuda.memory_allocated()
    nll = mean_nll(exe.outputs[0].handle, lab_t)
    exec_ms = statistics.median(times[EXEC_WARM:])
    names = list(params)
    exec_grads = {n: exe.grad_dict[n].handle for n in names}
    # a second backward() on the kept graph gives the same gradients
    t = time.perf_counter()
    exe.backward()
    torch.cuda.synchronize()
    again_ms = (time.perf_counter() - t) * 1e3
    again = compare_grads("executor backward twice",
                          {n: exe.grad_dict[n].handle for n in names},
                          exec_grads)
    exe._graph = None          # what the next forward would drop
    graph_gb = (held - torch.cuda.memory_allocated()) / 1e9
    del exe
    torch.cuda.empty_cache()
    if not np.isfinite(nll):
        fail("executor: non-finite loss %r" % nll)
    say("executor: forward+backward %.2f ms (median of %d timed; all: %s), "
        "%.0f tokens/s; loss (mean NLL) %.4f; peak device memory %.2f GB "
        "(bound arrays %.2f GB); the graph kept for a repeat backward() "
        "holds %.2f GB after backward(); a second backward() %.2f ms, "
        "gradients %d of %d bit-equal (worst diff %.3g)" % (
            exec_ms, EXEC_TIMED, " ".join("%.1f" % x for x in times),
            B * SEQ / exec_ms * 1e3, nll, exec_peak, bound_gb, graph_gb,
            again_ms, again[0], len(names), again[1]))
    say("executor: launches %s" % ", ".join(
        "%s %d" % kv for kv in sorted(exec_counts.items())))

    # -- route 2: the eager walk --------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    args = {n: mx.nd.array(v, ctx=mx.gpu(0)) for n, v in params.items()}
    for a in args.values():
        a.attach_grad()
    args.update({k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in feed.items()})
    n_ops = sum(1 for n in _topo_order(sym._entries) if n.op is not None)

    def eager_step():
        with mx.autograd.record():
            outs = eager_walk(sym, args, {})
        outs[0].backward()
        return outs

    _reset_flash_counts()
    times = []
    for i in range(EAGER_WARM + EAGER_TIMED):
        t = time.perf_counter()
        outs = eager_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        eager_nll = mean_nll(outs[0].handle, lab_t)
        del outs
    eager_counts = _flash_counts("eager", EAGER_WARM + EAGER_TIMED)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    eager_ms = statistics.median(times[EAGER_WARM:])
    eager_grads = {n: args[n].grad.handle for n in names}
    del args
    torch.cuda.empty_cache()
    us_plain, us_rec = eager_dispatch_us()
    say("eager: forward+backward %.2f ms (median of %d timed; all: %s), "
        "%d op calls a forward; loss %.4f; peak device memory %.2f GB; "
        "host time of one eager op call %.1f us (%.1f us recording)" % (
            eager_ms, EAGER_TIMED, " ".join("%.1f" % x for x in times),
            n_ops, eager_nll, eager_peak, us_plain, us_rec))
    say("eager: launches %s" % ", ".join(
        "%s %d" % kv for kv in sorted(eager_counts.items())))
    if not abs(eager_nll - nll) <= 1e-5 * abs(nll):
        fail("eager: loss %r differs from the executor's %r"
             % (eager_nll, nll))

    # -- route 3: TrainStep._grads ------------------------------------------
    step = make_train_step(sym, optimizer="sgd")
    p = {n: torch.from_numpy(v).cuda() for n, v in params.items()}
    batch = step.place_batch(feed)
    _reset_flash_counts()
    _outs, _aux, step_grads = step._grads(p, {}, batch, 0)
    torch.cuda.synchronize()
    _flash_counts("TrainStep._grads", 1)
    del _outs, _aux, p, batch, step
    vs_step = compare_grads("executor against TrainStep._grads", exec_grads,
                            step_grads)
    vs_eager = compare_grads("eager walk against the executor", eager_grads,
                             exec_grads)
    say("executor: gradients of %d parameters: executor vs TrainStep._grads "
        "%d bit-equal (worst abs diff %.3g, %.3g of max|g|); eager walk vs "
        "executor %d bit-equal (worst abs diff %.3g, %.3g of max|g|); "
        "limit rtol %g + atol %g x max|g|" % (
            len(names), vs_step[0], vs_step[1], vs_step[2], vs_eager[0],
            vs_eager[1], vs_eager[2], GRAD_RTOL, GRAD_ATOL_REL))
    del exec_grads, eager_grads, step_grads
    torch.cuda.empty_cache()
    return {"executor": exec_counts, "eager": eager_counts}


# ---------------------------------------------------------------------------
# BatchNorm kernel phase
# ---------------------------------------------------------------------------

# ResNet-50's stage-2 BatchNorm input, bf16 (benchmark/bench_bn.py SHAPES):
# the shape the BatchNorm kernels are timed at
BN_SHAPE = (128, 256, 56, 56)
# (C, H*W) of the BatchNorms of a ResNet-50 v2 step at 3x224x224
RESNET50_BN_SHAPES = ((64, 112 * 112), (64, 56 * 56), (256, 56 * 56),
                      (128, 56 * 56), (128, 28 * 28), (512, 28 * 28),
                      (256, 28 * 28), (256, 14 * 14), (1024, 14 * 14),
                      (512, 14 * 14), (512, 7 * 7), (2048, 7 * 7))
# (label, N, C, HW, dtype, shift): those shapes at batch 128 in bf16, two
# of them in f32, and edge shapes: N = 1; HW = 1; HW = 49 with C = 3;
# |mean| / std = 1e3 (unit-variance data about `shift`)
BN_CASES = ([("r50_c%d_hw%d" % (c, hw), 128, c, hw, "bfloat16", 0.0)
             for c, hw in RESNET50_BN_SHAPES]
            + [("f32_c256_hw3136", 128, 256, 3136, "float32", 0.0),
               ("f32_c2048_hw49", 128, 2048, 49, "float32", 0.0),
               ("n1", 1, 256, 3136, "bfloat16", 0.0),
               ("hw1", 128, 2048, 1, "bfloat16", 0.0),
               ("hw49_c3", 16, 3, 49, "bfloat16", 0.0),
               ("large_mean_f32", 32, 64, 196, "float32", 1e3),
               ("large_mean_bf16", 32, 64, 196, "bfloat16", 1e3)])
# per-channel sums (stats, backward reduce) against the plain version's:
# within this share of the sum of the terms' magnitudes (f32 sums taken
# in another order). The elementwise passes (apply, dx) round the same
# f32 arithmetic once: within BN_ELT_TOL (bf16: about two steps of its
# 8-bit significand). The large-mean cases' variance, from the kernel's
# shifted sums, within BN_VAR_RTOL of the float64 variance of the data.
BN_SUM_RTOL = 1e-4
BN_ELT_TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2),
              "float32": dict(atol=1e-6, rtol=1e-6)}
BN_VAR_RTOL = 1e-3
# kernel -> (TPU kernel's line in bn_pallas.py, elements read or written
# per element of x, (C,) f32 vectors read or written, f32 ops per element)
BN_KERNELS = {"bn_stats": (50, 1, 3, 4),        # x; c, s1, s2; sub add mul add
              "bn_apply": (66, 2, 2, 2),        # x, y; a, b; mul add
              "bn_bwd_reduce": (72, 2, 3, 4),   # dy, x; mean, db, dxc
              "bn_bwd_dx": (88, 3, 4, 5)}       # dy, x, dx; a, c2, b, mean


def bn_bound(kernel, N, C, HW, dtype):
    """(bound_ms, bound_by) of one BatchNorm kernel call: each input read
    once and each output written once, against its f32 arithmetic on the
    CUDA cores."""
    _, tensors, chans, ops = BN_KERNELS[kernel]
    elt = 2 if dtype == "bfloat16" else 4
    n = N * C * HW
    t_bytes = (tensors * elt * n + 4 * C * chans) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops * n / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode_bound(gen):
    """(bound_ms, bytes) of one (B, 1) decode step: each weight other than
    the token and position tables read once (int8 weights as int8, with
    their scales) and every layer's caches whole (the step reads all Tmax
    columns, as the op does), over the memory rate; the products' flops
    (2 a weight a row) are far under it."""
    nbytes = sum(t.numel() * t.element_size() for n, t in gen._params.items()
                 if n not in ("tok_embed_weight", "pos_embed_weight"))
    nbytes += gen.kv_cache_bytes()
    return nbytes / PEAK_BYTES_PER_S * 1e3, nbytes


def check_sums(what, got, want, magnitude):
    """Fail unless every per-channel sum in ``got`` is finite and within
    BN_SUM_RTOL of its terms' magnitude of ``want``; returns the max abs
    error."""
    import torch
    worst = 0.0
    for g, w, m in zip(got, want, magnitude):
        if not torch.isfinite(g).all():
            fail("%s: non-finite sum" % what)
        err = (g - w).abs()
        worst = max(worst, float(err.max().item()))
        if (err > BN_SUM_RTOL * m + 1e-6).any():
            fail("%s: a per-channel sum beyond %g of its terms' magnitude "
                 "(max abs err %g)" % (what, BN_SUM_RTOL, worst))
    return worst


def bn_kernel_phase():
    """The four BatchNorm kernels against their plain versions on the
    same card inputs (x, dy and the per-channel coefficients random; the
    shift c the first sample's channel mean and `mean` the batch's, as
    bn_train_kernels gives them), then timed at BN_SHAPE."""
    import torch
    from mxnet_tpu_torch.ops import bn_kernels as bnk

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    records = []
    for label, N, C, HW, dt, shift in BN_CASES:
        dtype = getattr(torch, dt)
        x = (torch.randn((N, C, HW), generator=gen, device="cuda")
             + shift).to(dtype)
        dy = torch.randn((N, C, HW), generator=gen, device="cuda").to(dtype)
        a, b, c2 = (torch.randn(C, generator=gen, device="cuda")
                    for _ in range(3))
        c = x[0].float().mean(dim=1)
        mean = x.float().mean(dim=(0, 2))
        s = bnk.bn_stats_cuda(x, c)
        y = bnk.bn_apply_cuda(x, a, b)
        r = bnk.bn_bwd_reduce_cuda(dy, x, mean)
        dx = bnk.bn_bwd_dx_cuda(dy, x, a, c2, b, mean)
        torch.cuda.synchronize()
        err = {}
        xc = x.float() - c[None, :, None]
        err["bn_stats"] = check_sums(
            "bn_stats %s" % label, s, bnk._stats_reference(x, c),
            (xc.abs().sum(dim=(0, 2)), (xc * xc).sum(dim=(0, 2))))
        del xc
        dyf, xm = dy.float(), x.float() - mean[None, :, None]
        err["bn_bwd_reduce"] = check_sums(
            "bn_bwd_reduce %s" % label, r,
            bnk._bwd_reduce_reference(dy, x, mean),
            (dyf.abs().sum(dim=(0, 2)), (dyf * xm).abs().sum(dim=(0, 2))))
        del dyf, xm
        err["bn_apply"] = check_close("bn_apply %s" % label, y,
                                      bnk._apply_reference(x, a, b),
                                      BN_ELT_TOL[dt])
        err["bn_bwd_dx"] = check_close(
            "bn_bwd_dx %s" % label, dx,
            bnk._bwd_dx_reference(dy, x, a, c2, b, mean), BN_ELT_TOL[dt])
        if dx.dtype != dtype or y.dtype != dtype:
            fail("bn %s: y %s and dx %s, not %s" % (label, y.dtype,
                                                    dx.dtype, dtype))
        var_note = ""
        if shift:
            m = N * HW
            mean_s = s[0] / m
            var = (s[1] / m - mean_s * mean_s).double()
            var64 = x.double().var(dim=(0, 2), unbiased=False)
            rel = float(((var - var64).abs() / var64).max().item())
            if rel > BN_VAR_RTOL:
                fail("bn_stats %s: variance from the shifted sums %g off "
                     "the float64 variance (relative)" % (label, rel))
            var_note = ", variance vs float64 %.3g (relative)" % rel
        say("kernel bn %-17s N=%d C=%d HW=%d %s: max_abs_err stats %.3g "
            "apply %.3g bwd_reduce %.3g bwd_dx %.3g%s" % (
                label, N, C, HW, dt, err["bn_stats"], err["bn_apply"],
                err["bn_bwd_reduce"], err["bn_bwd_dx"], var_note))
        if (N, C, HW, dt) == (BN_SHAPE[0], BN_SHAPE[1],
                              BN_SHAPE[2] * BN_SHAPE[3], "bfloat16"):
            records = bn_timing(x, dy, a, b, c2, c, mean, err)
        del x, dy, y, dx, s, r
    torch.cuda.empty_cache()
    return records


def bn_timing(x, dy, a, b, c2, c, mean, err):
    """Each BatchNorm kernel's time at BN_SHAPE beside its plain
    version's and its bound; F.batch_norm(training=True)'s forward is
    the library yardstick of the stats + apply pair, its backward (dx,
    dgamma, dbeta) that of the bwd_reduce + bwd_dx pair."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import bn_kernels as bnk

    N, C, HW = x.shape
    calls = {
        "bn_stats": (lambda: bnk.bn_stats_cuda(x, c),
                     lambda: bnk._stats_reference(x, c)),
        "bn_apply": (lambda: bnk.bn_apply_cuda(x, a, b),
                     lambda: bnk._apply_reference(x, a, b)),
        "bn_bwd_reduce": (lambda: bnk.bn_bwd_reduce_cuda(dy, x, mean),
                          lambda: bnk._bwd_reduce_reference(dy, x, mean)),
        "bn_bwd_dx": (lambda: bnk.bn_bwd_dx_cuda(dy, x, a, c2, b, mean),
                      lambda: bnk._bwd_dx_reference(dy, x, a, c2, b,
                                                    mean)),
    }
    x4 = x.view(BN_SHAPE).detach().requires_grad_()
    g4 = torch.ones(C, device="cuda", requires_grad=True)
    b4 = torch.zeros(C, device="cuda", requires_grad=True)
    lib_fwd = time_ms(lambda: F.batch_norm(x4, None, None, g4, b4,
                                           training=True, eps=2e-5))
    out = F.batch_norm(x4, None, None, g4, b4, training=True, eps=2e-5)
    dy4 = dy.view(BN_SHAPE)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, (x4, g4, b4), dy4,
                                                  retain_graph=True))
    del out, x4
    records = []
    for name, (kernel, plain) in calls.items():
        ms = time_ms(kernel)
        # every kernel and memset of the call, without the host's enqueue
        # time that events around a call this short include
        dev_ms = device_ms(kernel, "")
        plain_ms = time_ms(plain)
        bound, by = bn_bound(name, N, C, HW, "bfloat16")
        pair_lib = lib_fwd if name in ("bn_stats", "bn_apply") else lib_bwd
        records.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/bn_train.cu",
            "replaces": "mxnet_tpu/ops/bn_pallas.py:%d" % BN_KERNELS[name][0],
            "launches": None, "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "pair_library_ms": pair_lib,
            "device_ms": dev_ms})
        say("kernel %s %s timing: kernel %.4f ms (by events; %.4f ms device "
            "time), plain %.4f ms, bound %.4f ms (%s)" % (
                name, "x".join(map(str, BN_SHAPE)), ms, dev_ms, plain_ms,
                bound, by))
    t = {r["name"]: r["ms"] for r in records}
    say("kernel bn pairs at %s bf16: stats + apply %.4f ms (library "
        "F.batch_norm forward %.4f ms); bwd_reduce + bwd_dx %.4f ms "
        "(library F.batch_norm backward %.4f ms)" % (
            "x".join(map(str, BN_SHAPE)), t["bn_stats"] + t["bn_apply"],
            lib_fwd, t["bn_bwd_reduce"] + t["bn_bwd_dx"], lib_bwd))
    return records


# ---------------------------------------------------------------------------
# ResNet path
# ---------------------------------------------------------------------------

# bench.py's ResNet-50 step (bench_image, --network resnet-50, bf16)
RESNET_LAYERS, RESNET_IMAGE, RESNET_BATCH, RESNET_LR = 50, 224, 128, 0.1
RESNET_CLASSES = 1000
# the entry() twin (__graft_entry__.entry: ResNet-50, 3x96x96, batch 8)
ENTRY_LAYERS, ENTRY_IMAGE, ENTRY_BATCH = 50, 96, 8
ENTRY_TOL = dict(rtol=1e-4, atol=1e-6)
# the small f32 ResNet whose one step on the card is held to the CPU's
SMALL_LAYERS, SMALL_IMAGE, SMALL_BATCH = 18, 64, 4
SMALL_TOL = dict(rtol=1e-4, atol=1e-5)


def resnet_entry_twin():
    """__graft_entry__.entry()'s forward in the port: ResNet-50 (1000
    classes, 3x96x96, batch 8, f32, Xavier() from mx.random.seed(0)),
    inference through _graph_eval_fn(is_train=False) on the card and on
    the CPU from the same state. entry() feeds zeros; seeded normals
    here make the comparison see the data."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import _graph_eval_fn
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import make_train_step

    B, S = ENTRY_BATCH, ENTRY_IMAGE
    sym = resnet.get_symbol(num_classes=1000, num_layers=ENTRY_LAYERS,
                            image_shape=(3, S, S))
    eval_fn = _graph_eval_fn(sym)
    feed = {"data": np.random.RandomState(10).standard_normal(
        (B, 3, S, S)).astype(np.float32),
        "softmax_label": np.zeros((B,), np.float32)}
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        step = make_train_step(sym, ctx=ctx)
        mx.random.seed(0)
        params, _, aux = step.init_state(Xavier(), {
            "data": (B, 3, S, S), "softmax_label": (B,)})
        with torch.no_grad():
            probs = eval_fn({**params, **step.place_batch(feed)}, aux, 0,
                            False)[0][0]
        outs.append(probs.float().cpu().numpy())
    card, host = outs
    if card.shape != (B, 1000) or not np.isfinite(card).all():
        fail("entry() twin: card probabilities of shape %r, finite %s"
             % (card.shape, np.isfinite(card).all()))
    sums = card.sum(axis=1, dtype=np.float64)
    err = float(np.abs(card - host).max())
    if np.abs(sums - 1).max() > 1e-4 or not np.allclose(card, host,
                                                        **ENTRY_TOL):
        fail("entry() twin: card vs CPU max abs err %g (rows sum to "
             "%g..%g)" % (err, sums.min(), sums.max()))
    say("resnet reference: entry() twin (ResNet-%d, %dx3x%dx%d, f32) card "
        "vs CPU probabilities max abs err %.3g (rtol %g, atol %g); top "
        "probability %.3g" % (ENTRY_LAYERS, B, S, S, err, ENTRY_TOL["rtol"],
                              ENTRY_TOL["atol"], float(card.max())))


def resnet_train_reference_check():
    """A small f32 ResNet (v2, SMALL_LAYERS deep) on the BatchNorm
    kernels: one SGD-momentum step with wd on the card must give the
    parameters and moving stats the same step gives on the CPU (the
    kernels' plain versions), from one seeded init."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import make_train_step

    B, S = SMALL_BATCH, SMALL_IMAGE
    sym = resnet.get_symbol(num_classes=10, num_layers=SMALL_LAYERS,
                            image_shape=(3, S, S))
    rng = np.random.RandomState(11)
    batch = {"data": rng.standard_normal((B, 3, S, S)).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (B,)).astype(np.float32)}
    # the BatchNorm op reads the knob at each call
    config.set_override("MXNET_BN_PALLAS", True)
    after = []
    for ctx in (mx.gpu(0), mx.cpu()):
        step = make_train_step(sym, optimizer="sgd", ctx=ctx,
                               optimizer_params={"momentum": 0.9,
                                                 "wd": 1e-4})
        mx.random.seed(7)
        state = step.init_state(Xavier(factor_type="in", magnitude=2.0),
                                {"data": (B, 3, S, S),
                                 "softmax_label": (B,)})
        (params, _, aux), _ = step(state, batch, 0.1, 0)
        after.append({**{n: v.cpu().numpy() for n, v in params.items()},
                      **{"aux " + n: v.cpu().numpy()
                         for n, v in aux.items()}})
    config.set_override("MXNET_BN_PALLAS", None)
    worst = 0.0
    for n, w in after[0].items():
        worst = max(worst, float(np.abs(w - after[1][n]).max()))
        if not np.isfinite(w).all() or not np.allclose(w, after[1][n],
                                                       **SMALL_TOL):
            fail("small f32 ResNet step: %s on the card differs from the "
                 "CPU by %g" % (n, np.abs(w - after[1][n]).max()))
    say("resnet reference: small f32 ResNet-%d (%dx3x%dx%d) one SGD step on "
        "the BatchNorm kernels, card vs CPU, %d parameters and moving "
        "stats: max abs err %.3g (rtol %g, atol %g)" % (
            SMALL_LAYERS, B, S, S, len(after[0]), worst, SMALL_TOL["rtol"],
            SMALL_TOL["atol"]))


def resnet_train_run(kernels, counters):
    """bench.py's ResNet-50 step through make_train_step -> init_state ->
    step, with MXNET_BN_PALLAS on (``kernels``) or off: 2 warm steps (the
    second profiled) and 10 timed ones on the same batch. Fails unless
    the NLL at the labels is finite and falls, the moving stats stay
    finite, and each BatchNorm kernel ran once per BatchNorm per step
    (kernel route) or never (default route). Returns the launch counts."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import make_train_step

    route = "kernel route" if kernels else "default route"
    B, S = RESNET_BATCH, RESNET_IMAGE
    t0 = time.perf_counter()
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, image_shape=(3, S, S))
    n_bn = sum(n["op"] == "BatchNorm"
               for n in json.loads(sym.tojson())["nodes"])
    step = make_train_step(sym, optimizer="sgd",
                           optimizer_params={"momentum": 0.9, "wd": 1e-4,
                                             "rescale_grad": 1.0 / B},
                           compute_dtype="bfloat16")
    x = np.random.RandomState(0).standard_normal((B, 3, S, S)).astype(
        np.float32)
    y = np.random.RandomState(1).randint(0, RESNET_CLASSES, (B,)).astype(
        np.float32)
    mx.random.seed(0)
    state = step.init_state(Xavier(factor_type="in", magnitude=2.0),
                            {"data": (B, 3, S, S), "softmax_label": (B,)})
    batch = step.place_batch({"data": x, "softmax_label": y})
    nparam = sum(v.numel() for v in state[0].values())
    say("resnet %s: ResNet-%d v2 %d params (%.1f M), %d BatchNorms, batch "
        "%d x 3x%dx%d, SGD momentum 0.9 wd 1e-4 lr %g, bf16 compute, "
        "MXNET_BN_PALLAS=%d, on %s, set up in %.1f s" % (
            route, RESNET_LAYERS, nparam, nparam / 1e6, n_bn, B, S, S,
            RESNET_LR, int(kernels), step.device, time.perf_counter() - t0))

    config.set_override("MXNET_BN_PALLAS", kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    reset_mt_counts()
    nlls, times = [], []
    for i in range(WARM_STEPS + TIMED_STEPS):
        t = time.perf_counter()
        if i == 1:   # the second warm step, under the profiler
            state, outs = profile("resnet step, %s (warm)" % route,
                                  lambda: step(state, batch, RESNET_LR, i),
                                  top=14)
        else:
            state, outs = step(state, batch, RESNET_LR, i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        nlls.append(mean_nll(outs[0], batch["softmax_label"]))
        del outs
    launches = {c.__name__: c.launches for c in counters}
    config.set_override("MXNET_BN_PALLAS", None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = WARM_STEPS + TIMED_STEPS
    step_ms = statistics.median(times[WARM_STEPS:])
    say("resnet %s: NLL per step %s" % (route, " ".join("%.4f" % v
                                                        for v in nlls)))
    say("resnet %s: step %.2f ms (median of %d timed steps; all: %s), %.1f "
        "img/s, peak device memory %.2f GB" % (
            route, step_ms, TIMED_STEPS, " ".join("%.1f" % v for v in times),
            B / step_ms * 1e3, peak_gb))
    if not all(np.isfinite(nlls)):
        fail("resnet %s: non-finite NLL %r" % (route, nlls))
    if not nlls[-1] < nlls[0]:
        fail("resnet %s: NLL did not fall: first %g, last %g"
             % (route, nlls[0], nlls[-1]))
    bad = [n for n, v in state[2].items() if not torch.isfinite(v).all()]
    if bad:
        fail("resnet %s: non-finite moving stats %s" % (route, bad[:4]))
    want = n_bn * steps if kernels else 0
    for name, n in launches.items():
        if n != want:
            fail("resnet %s: %s launched %d times, not %d" % (
                route, name, n, want))
    launches.update(check_mt_counts("resnet %s" % route, steps,
                                    len(state[0])))
    say("resnet %s: launches %s (%d BatchNorms x %d steps each on the "
        "kernel route, none on the default route); %d moving stats "
        "finite" % (route, ", ".join("%s %d" % kv for kv in
                                     sorted(launches.items())),
                    n_bn, steps, len(state[2])))
    del state, batch, step
    torch.cuda.empty_cache()
    return launches


def resnet_phase(counters):
    """The ResNet path: the entry() twin and the small step's card-vs-CPU
    check, then bench.py's ResNet-50 step on the BatchNorm kernels and
    on the default two-pass BatchNorm. Returns each run's launch counts
    by path."""
    resnet_entry_twin()
    resnet_train_reference_check()
    return {"resnet": resnet_train_run(True, counters),
            "resnet_default": resnet_train_run(False, counters)}


# ---------------------------------------------------------------------------
# NMS kernel phase
# ---------------------------------------------------------------------------

NMS_IOU_OPS = 14        # IoU test: 8 min/max/sub, mul, add and sub, the
                        # union guard, div, >= (areas are per row)
NMS_CLASS_OPS = 1       # the class test that settles a pair of two classes
NMS_BYTES_PER_ROW = 2   # valid 1 read, keep 1 written: every row
NMS_BYTES_PER_VALID = 20  # boxes 16, class 4 read: valid rows only
# (label, B, A, valid rows, force_suppress, kind): SSD300 at batch 8 with
# every row valid and no top-k (the worst case) and with the path's top
# 400; A not a multiple of 128, A < 128, no valid row, zero-area and
# inverted boxes, identical boxes, an IoU exactly at the threshold; valid
# rows scattered over the image instead of a prefix; A past the 48 KB
# default shared memory and at MAX_ANCHORS (rows past the kernel's
# shared-memory cache of boxes); a batch of 32 (more clusters than fit on
# the card at once)
NMS_CASES = [
    ("ssd300_all", 8, SSD_ANCHORS, SSD_ANCHORS, False, "ssd"),
    ("ssd300_all_force", 8, SSD_ANCHORS, SSD_ANCHORS, True, "ssd"),
    ("ssd300_top400", 8, SSD_ANCHORS, 400, False, "ssd"),
    ("ssd300_top400_force", 8, SSD_ANCHORS, 400, True, "ssd"),
    ("a300", 3, 300, 300, False, "ssd"),
    ("a300_force", 3, 300, 250, True, "ssd"),
    ("a129", 2, 129, 129, False, "ssd"),
    ("a7", 4, 7, 7, False, "ssd"),
    ("a1", 2, 1, 1, False, "ssd"),
    ("no_valid", 2, 300, 0, False, "ssd"),
    ("degenerate", 2, 256, 256, False, "degenerate"),
    ("degenerate_force", 2, 256, 256, True, "degenerate"),
    ("identical", 2, 200, 200, False, "identical"),
    ("identical_force", 2, 200, 200, True, "identical"),
    ("at_threshold", 1, 2, 2, False, "at_threshold"),
    ("scattered", 4, SSD_ANCHORS, 1000, False, "scattered"),
    ("scattered_force", 2, 3000, 2500, True, "scattered"),
    ("a60000", 1, 60000, 3000, False, "ssd"),
    ("a60000_scattered", 1, 60000, 3000, False, "scattered"),
    ("max_anchors", 1, 200000, 1000, False, "scattered"),
    ("batch32", 32, SSD_ANCHORS, 400, False, "ssd"),
]


def ssd_anchors():
    """SSD300's (8732, 4) anchors, as the graph's MultiBoxPrior layers
    build them (on the host)."""
    import torch
    from mxnet_tpu_torch.ops.detection_ops import _multibox_prior
    return torch.cat([_multibox_prior(
        torch.empty((1, 1, n, n), device="cpu"), sizes=SSD_SIZES[k],
        ratios=SSD_RATIOS[k], steps=(SSD_STEPS[k], SSD_STEPS[k]))[0]
        for k, n in enumerate((38, 19, 10, 5, 3, 1))])


def nms_inputs(B, A, n_valid, kind, gen):
    """Score-sorted corner boxes, class ids and valid flags on the card, as
    MultiBoxDetection hands them to NMS: SSD300's anchors (cycled to A
    rows) decoded from random offsets in a random score order per image,
    20 random classes, the first ``n_valid`` rows valid (``n_valid`` rows
    at random places in each image for the kind ``scattered``); or the
    edge cases' boxes."""
    import torch
    from mxnet_tpu_torch.ops.detection_ops import _decode_boxes
    dev = "cuda"
    anchors = ssd_anchors().to(dev)
    anchors = anchors[torch.arange(A, device=dev) % anchors.shape[0]]
    loc = torch.randn((B, A, 4), generator=gen, device=dev)
    boxes = _decode_boxes(anchors, loc, SSD_NMS["variances"], True)
    order = torch.argsort(torch.rand((B, A), generator=gen, device=dev),
                          dim=1)
    boxes = torch.gather(boxes, 1, order[..., None].expand(B, A, 4))
    cls = torch.randint(0, 20, (B, A), generator=gen, device=dev).float()
    if kind == "degenerate":
        # zero width, zero height, inverted, and all-zero boxes among the
        # real ones: union <= 0 for some pairs
        boxes[:, 0::4, 2] = boxes[:, 0::4, 0]
        boxes[:, 1::4, 3] = boxes[:, 1::4, 1]
        boxes[:, 2::4, :2], boxes[:, 2::4, 2:] = (boxes[:, 2::4, 2:].clone(),
                                                 boxes[:, 2::4, :2].clone())
        boxes[:, 3::8] = 0.0
    elif kind == "identical":
        boxes[:] = torch.tensor([0.1, 0.2, 0.5, 0.6], device=dev)
        cls = torch.randint(0, 3, (B, A), generator=gen, device=dev).float()
    elif kind == "at_threshold":
        # IoU([0,0,1,1], [0,0,1,0.5]) = 0.5 exactly, at threshold 0.5
        boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 0.5]]],
                             device=dev)
        cls = torch.zeros((1, 2), device=dev)
    valid = (torch.arange(A, device=dev) < n_valid).expand(B, A)
    if kind == "scattered":
        valid = torch.argsort(torch.rand((B, A), generator=gen, device=dev),
                              dim=1) < n_valid
    return boxes.contiguous(), cls.contiguous(), valid.contiguous()


def _pairs_after(rows, later):
    """Per batch, the count of pairs (i, j), i < j, with rows[i] and
    later[j] both true."""
    import torch
    later = later.to(torch.int64)
    after = later.flip(1).cumsum(1).flip(1) - later
    return int((after * rows).sum())


def nms_bound(cls, valid, keep, force):
    """(bound_ms, bound_by, counts) of one NMS call over a batch, from
    this run's inputs and its keep mask. Bytes: 2 a row (valid read,
    keep written), 20 more a valid row (box and class read). Operations:
    greedy NMS tests a later valid row only against the rows kept before
    it; such a pair costs an IoU test (14 f32 operations) under
    force_suppress, else one class test, and the IoU test too where the
    classes are equal."""
    import torch
    B, A = valid.shape
    pairs = _pairs_after(keep, valid)
    if force:
        same = pairs
    else:
        same = sum(_pairs_after(keep & (cls == c), valid & (cls == c))
                   for c in torch.unique(cls[valid]).tolist())
    ops = NMS_IOU_OPS * same + (0 if force else NMS_CLASS_OPS * pairs)
    nbytes = NMS_BYTES_PER_ROW * B * A + NMS_BYTES_PER_VALID * int(
        valid.sum())
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    counts = {"kept_valid_pairs": pairs, "iou_tests": same,
              "operations": ops, "bytes": nbytes}
    if t_ops >= t_bytes:
        return t_ops, "operations", counts
    return t_bytes, "bytes", counts


def nms_kernel_phase():
    """nms_keep_cuda against its plain version (_nms_reference, on the
    card) in every NMS_CASES case: the keep masks must be equal, flag for
    flag. Timed at SSD300's worst case and at the path's shape."""
    import torch
    from mxnet_tpu_torch.ops import nms_kernels as nmsk

    gen = torch.Generator(device="cuda").manual_seed(20261019)
    timing = {}
    thr = SSD_NMS["nms_threshold"]
    max_diff = 0
    for label, B, A, n_valid, force, kind in NMS_CASES:
        boxes, cls, valid = nms_inputs(B, A, n_valid, kind, gen)
        t = 0.5 if kind == "at_threshold" else thr
        keep = nmsk.nms_keep_cuda(boxes, cls, valid, t, force)
        torch.cuda.synchronize()
        ref = nmsk._nms_reference(boxes, cls, valid, t, force)
        if keep.shape != (B, A):
            fail("nms_keep %s: keep shape %s, want %s" % (
                label, tuple(keep.shape), (B, A)))
        diff = int((keep != ref).sum())
        max_diff = max(max_diff, diff)
        if diff:
            fail("nms_keep %s: %d of %d keep flags differ from the plain "
                 "version" % (label, diff, B * A))
        if kind == "at_threshold" and keep.tolist() != [[True, False]]:
            fail("nms_keep at_threshold: IoU 0.5 at threshold 0.5 must "
                 "suppress, got %r" % keep.tolist())
        say("kernel nms_keep %-20s B=%d A=%d valid=%d force=%s: keep equal "
            "to the plain version (%d kept of %d)" % (
                label, B, A, n_valid, force, int(keep.sum()), B * A))
        if label in ("ssd300_all", "ssd300_top400"):
            args = (boxes, cls, valid, thr, force)
            worst = label == "ssd300_all"
            # every kernel and memset the call launches
            ms = device_ms(lambda: nmsk.nms_keep_cuda(*args), "")
            call_ms = time_ms(lambda: nmsk.nms_keep_cuda(*args))
            plain_ms = time_ms(lambda: nmsk._nms_reference(*args),
                               reps=5 if worst else 20,
                               warmup=1 if worst else 3)
            bound, by, counts = nms_bound(cls, valid, ref, force)
            timing[label] = (ms, call_ms, plain_ms, bound, by, counts)
            say("kernel nms_keep %s timing: kernel %.4f ms on the device "
                "(%.4f ms by events around the call, host enqueue "
                "included), plain %.4f ms, bound %.6f ms (%s; %s); "
                "library: none (no single PyTorch call computes greedy "
                "NMS)" % (label, ms, call_ms, plain_ms, bound, by,
                          json.dumps(counts)))
        del boxes, cls, valid, keep, ref
    ms, call_ms, plain_ms, bound, by, counts = timing["ssd300_top400"]
    w_ms, w_call, w_plain, w_bound, w_by, w_counts = timing["ssd300_all"]
    shape = nmsk.launch_shape(SSD_ANCHORS)
    path_batch = next(c[1] for c in NMS_CASES if c[0] == "ssd300_top400")
    say("kernel nms_keep launch at A=%d: a cluster of %d CTAs an image "
        "(%d SMs at batch %d), %d bytes of dynamic shared memory and %d "
        "cached rows a CTA, at most %d such clusters at once on this card"
        % (SSD_ANCHORS, shape["cluster"], path_batch * shape["cluster"],
           path_batch, shape["smem_bytes"], shape["cached_rows"],
           shape["max_active_clusters"]))
    # max_abs_err: the most keep flags that differed from the plain
    # version in one case
    return [{"name": "nms_keep", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/nms.cu",
             "replaces": "mxnet_tpu/ops/nms_pallas.py:49",
             "launches": None, "max_abs_err": max_diff, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": None,
             "library_note": "no single PyTorch call computes greedy NMS",
             "shape": "B 8, A 8732, top 400 valid", "call_ms": call_ms,
             "sms": path_batch * shape["cluster"],
             "cluster": shape["cluster"],
             "max_active_clusters": shape["max_active_clusters"],
             "bound_counts": counts,
             "worst_case": {"shape": "B 8, A 8732, all valid", "ms": w_ms,
                            "call_ms": w_call, "plain_ms": w_plain,
                            "bound_ms": w_bound, "bound_by": w_by,
                            "bound_counts": w_counts}}]


# ---------------------------------------------------------------------------
# SSD path
# ---------------------------------------------------------------------------

SSD_IMAGE, SSD_CLASSES = 300, 20
SSD_WIDTH_DIV = 1        # the served SSD300 at its published widths
SSD_SMALL_DIV = 16       # the small SSD300 held card against CPU


def ssd_params(sym, seed=0):
    """SSD300's weights as numpy arrays: Xavier(factor_type="in",
    magnitude=2.0) from mx.random.seed(seed), zero biases, and each
    ``*_scale`` 20 (upstream's Constant(20))."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import InitDesc, Xavier

    shapes, _, _ = sym.infer_shape(data=(1, 3, SSD_IMAGE, SSD_IMAGE))
    init = Xavier(factor_type="in", magnitude=2.0)
    mx.random.seed(seed)
    params = {}
    for name, shp in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        if name.endswith("_scale"):
            params[name] = np.full(shp, 20.0, np.float32)
            continue
        arr = mx.nd.zeros(shp, ctx=mx.cpu())
        init(InitDesc(name), arr)
        params[name] = arr.asnumpy()
    return params


def detect(heads, impl="auto"):
    """MultiBoxDetection with SSD300's attributes over (cls_prob,
    loc_preds, anchors) tensors, on their device."""
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op("_contrib_MultiBoxDetection")
    return op.fn(*heads, **{**op.defaults, **SSD_NMS, "impl": impl})


def ssd_reference_check():
    """A small f32 SSD300 (every width / SSD_SMALL_DIV, 21 classes): its
    heads on the card agree with the CPU's within TOL["float32"], and the
    detection op on the card (the kernel route), fed the CPU's heads,
    gives the CPU's detections (the dense route): class ids and kept rows
    equal, values within 1e-6."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import params_from_jax

    sym = ssd300_symbol(mx.sym, SSD_CLASSES, SSD_SMALL_DIV, heads=True)
    params = ssd_params(sym, seed=3)
    x = np.random.RandomState(12).standard_normal(
        (2, 3, SSD_IMAGE, SSD_IMAGE)).astype(np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        pred = mx.Predictor(sym, params_from_jax(params, ctx.torch_device()),
                            data_names=("data",), ctx=ctx)
        outs.append([h.handle for h in pred.forward(x)])
    errs = [check_close("small SSD300 head %d card vs CPU" % i, c.cpu(),
                        h, TOL["float32"])
            for i, (c, h) in enumerate(zip(*outs))]
    cpu_heads = outs[1]
    on_cpu = detect(cpu_heads).numpy()
    on_card = detect([h.cuda() for h in cpu_heads]).cpu().numpy()
    if not (np.array_equal(on_cpu[..., 0], on_card[..., 0])
            and np.allclose(on_card, on_cpu, rtol=0, atol=1e-6)):
        fail("small SSD300: the card's detections from the CPU's heads "
             "differ from the CPU's (max abs err %g)"
             % np.abs(on_card - on_cpu).max())
    say("ssd reference: small SSD300 (widths / %d, f32) heads card vs CPU "
        "max abs err %s (rtol %g, atol %g); detections from the CPU's heads, "
        "card (kernel route) vs CPU (dense route): max abs err %.3g, %d "
        "rows kept" % (SSD_SMALL_DIV, " ".join("%.3g" % e for e in errs),
                       TOL["float32"]["rtol"], TOL["float32"]["atol"],
                       float(np.abs(on_card - on_cpu).max()),
                       int((on_cpu[..., 0] >= 0).sum())))


class Recording:
    """The serving model: the Predictor, with every engine forward's
    padded batch and output kept, so each response can be held to the
    Predictor's own output for the batch it rode in."""

    def __init__(self, pred):
        self.pred, self.batches = pred, []

    def forward(self, data):
        outs = self.pred.forward(data)
        self.batches.append((np.array(data), outs[0].asnumpy()))
        return outs


def check_detections(what, det):
    """Fail unless (rows, A, 6) detections follow MultiBoxDetection's
    rules for SSD300: kept rows first-come in descending score, classes
    in [0, 20), scores >= 0.01, boxes in [0, 1], at most nms_topk kept an
    image, every other row -1. Returns the kept count per image."""
    kept = []
    if det.shape[1:] != (SSD_ANCHORS, 6) or not np.isfinite(det).all():
        fail("%s: detections of shape %r, finite %s" % (
            what, det.shape, np.isfinite(det).all()))
    for r, rows in enumerate(det):
        live = rows[:, 0] >= 0
        k = rows[live]
        if not (rows[~live] == -1).all():
            fail("%s image %d: a suppressed row is not all -1" % (what, r))
        if len(k) > SSD_NMS["nms_topk"]:
            fail("%s image %d: %d rows kept" % (what, r, len(k)))
        if not ((k[:, 0] == np.round(k[:, 0])).all() and k[:, 0].max() < 20
                and (k[:, 1] >= np.float32(0.01)).all()
                and (np.diff(k[:, 1]) <= 0).all()
                and (k[:, 2:] >= 0).all() and (k[:, 2:] <= 1).all()):
            fail("%s image %d: kept rows break the class / score order / "
                 "box rules" % (what, r))
        kept.append(len(k))
    return kept


def ssd_phase(counters):
    """SSD300 (VGG16-reduced, 21 classes, f32, random weights) served
    through ServeEngine -> Predictor -> Symbol graph -> MultiBoxDetection
    on the NMS kernel. Returns the kernel's launch counts over the served
    run."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import params_from_jax
    from mxnet_tpu_torch.serve import ServeEngine

    ssd_reference_check()

    t0 = time.perf_counter()
    sym = ssd300_symbol(mx.sym, SSD_CLASSES, SSD_WIDTH_DIV)
    params = ssd_params(sym, seed=0)
    nparam = sum(p.size for p in params.values())
    weights = params_from_jax(params, mx.current_context().torch_device())
    del params
    pred = mx.Predictor(sym, weights, data_names=("data",))
    heads = mx.Predictor(ssd300_symbol(mx.sym, SSD_CLASSES, SSD_WIDTH_DIV,
                                       heads=True),
                         weights, data_names=("data",))
    say("ssd: SSD300 VGG16-reduced, %d classes + background, %d anchors, "
        "%d params (%.1f M), f32, on %s, set up in %.1f s" % (
            SSD_CLASSES, SSD_ANCHORS, nparam, nparam / 1e6, pred.device,
            time.perf_counter() - t0))
    rs = np.random.RandomState(0)
    images = rs.standard_normal((max(BUCKETS), 3, SSD_IMAGE, SSD_IMAGE)
                                ).astype(np.float32)

    for b in BUCKETS:
        x = images[:b]
        pred.forward(x)
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            pred.forward(x)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        say("ssd: forward bucket %d: %.2f ms (median of 5; all: %s)" % (
            b, statistics.median(ts), " ".join("%.2f" % v for v in ts)))
    profile("ssd300 bucket %d forward" % len(x), lambda: pred.forward(x),
            top=10)

    # one bucket-8 batch: the same heads through both NMS routes
    hs = [h.handle for h in heads.forward(x)]
    full = pred.forward(x)[0].handle
    by_kernel, by_dense = detect(hs, "pallas"), detect(hs, "xla")
    if not (torch.equal(by_kernel, by_dense) and torch.equal(by_kernel,
                                                             full)):
        fail("ssd: bucket-8 detections, kernel route vs dense route vs the "
             "graph: max abs err %g / %g" % (
                 float((by_kernel - by_dense).abs().max()),
                 float((by_kernel - full).abs().max())))
    op_ms = time_ms(lambda: detect(hs, "pallas"))
    dense_ms = time_ms(lambda: detect(hs, "xla"), reps=3, warmup=1)
    say("ssd: bucket-8 detections equal bit for bit on the kernel route, "
        "the dense route and the whole graph; MultiBoxDetection op %.4f ms "
        "on the kernel route, %.2f ms on the dense route" % (op_ms,
                                                             dense_ms))
    del hs, full, by_kernel, by_dense

    rec = Recording(pred)
    engine = ServeEngine(rec, buckets=BUCKETS, max_wait_ms=200.0,
                         feature_shapes=[(3, SSD_IMAGE, SSD_IMAGE)])
    requests = [rs.standard_normal((r, 3, SSD_IMAGE, SSD_IMAGE)).astype(
        np.float32) for r in REQUEST_ROWS]
    results = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def client(i):
        barrier.wait()
        results[i] = engine.infer(requests[i], timeout=600)

    for c in counters:
        c.launches = 0
    fwd0 = engine.stats()["forwards"]
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    t_serve = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    serve_s = time.perf_counter() - t_serve
    launches = {c.__name__: c.launches for c in counters}
    stats = engine.stats()
    engine.close()
    forwards = stats["forwards"] - fwd0
    if any(r is None for r in results) or any(th.is_alive()
                                              for th in threads):
        fail("ssd: not every request got a response")
    say("ssd: %d requests (%d images) in %d engine forwards, %.3f s: %.2f "
        "requests/s; mean fill %.2f" % (
            len(requests), sum(REQUEST_ROWS), forwards, serve_s,
            len(requests) / serve_s, stats["mean_fill"]))
    if launches["nms_keep_cuda"] != forwards:
        fail("ssd: nms_keep_cuda launched %d times, not once per each of "
             "%d forwards" % (launches["nms_keep_cuda"], forwards))

    kept = []
    for i, (imgs, res) in enumerate(zip(requests, results)):
        det = res[0]
        if det.shape[0] != imgs.shape[0]:
            fail("ssd: response %d has %d rows for %d images"
                 % (i, det.shape[0], imgs.shape[0]))
        kept += check_detections("ssd response %d" % i, det)
        hit = [(feed, out, j) for feed, out in rec.batches
               for j in range(len(feed) - len(imgs) + 1)
               if np.array_equal(feed[j:j + len(imgs)], imgs)]
        if len(hit) != 1 or not np.array_equal(
                det, hit[0][1][hit[0][2]:hit[0][2] + len(imgs)]):
            fail("ssd: response %d is not its rows of the batch it rode in"
                 % i)
    if sum(kept) == 0:
        fail("ssd: no detection kept in any response")
    for feed, out in rec.batches:
        if not np.array_equal(pred.forward(feed)[0].asnumpy(), out):
            fail("ssd: the Predictor alone gives another output for a "
                 "served batch")
    say("ssd: every response checked: (rows, %d, 6), kept rows in "
        "descending score with classes in [0, 20) and scores >= 0.01, at "
        "most %d an image (kept per image: %s), equal bit for bit to the "
        "Predictor alone on the batch it rode in" % (
            SSD_ANCHORS, SSD_NMS["nms_topk"], " ".join(map(str, kept))))
    del pred, heads, weights, rec
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# PRNG phase: the threefry stream on the card
# ---------------------------------------------------------------------------

# sha256 of JAX's own draws (jax 0.9, threefry2x32, partitionable bits),
# recomputed from JAX by tests/test_torch_random.py: the uint32 bytes of
# bits(PRNGKey(0), (1000,)); np.packbits of bernoulli(fold_in(PRNGKey(0),
# 17), 0.5, (512, 4096)); the float32 bytes of mx.nd.uniform(shape=(1000,))
# after mx.random.seed(7)
PRNG_DIGESTS = {
    "bits_key0_1000":
        "93070a12a19702329476a3c27d4168bc259d91ecd4abb64f220fd8d5ae59b0aa",
    "bernoulli_fold17_512x4096":
        "a44d8b00e11bdcb347abe60e53b4e473bae932ed9486adb1159f1fbcb25c0906",
    "seed7_nd_uniform_1000":
        "147801db0370e2573ebc6c0cba76f50e895c61c36e7147cafde4418401659456",
}
# the Random123 known-answer vectors: (key, counter, hash)
THREEFRY_KAT = (
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
     (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0)))


def _sha256(a):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def prng_digests(mx, ctx):
    """PRNG_DIGESTS' three draws made by the port on ``ctx``."""
    from mxnet_tpu_torch import _threefry as tf
    dev = ctx.torch_device()
    key0 = tf.PRNGKey(0)
    bits = tf.random_bits(key0, (1000,), 32, dev).cpu().numpy()
    mask = tf.bernoulli(tf.fold_in(key0, 17), 0.5, (512, 4096), dev)
    mx.random.seed(7)
    with ctx:
        u = mx.nd.uniform(shape=(1000,))
    return {"bits_key0_1000": _sha256(bits.astype(np.uint32)),
            "bernoulli_fold17_512x4096": _sha256(np.packbits(
                mask.cpu().numpy())),
            "seed7_nd_uniform_1000": _sha256(u.asnumpy().astype(
                np.float32))}


def prng_phase():
    """The threefry PRNG on the card: the known-answer vectors, raw bits
    and a bernoulli(0.5) mask bit-equal to the port's CPU draws at
    AlexNet's fc6 shape (512, 4096), at an odd size and at 0-d, and
    PRNG_DIGESTS (JAX's own draws) reproduced; the cost of one mask."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _threefry as tf

    dev = torch.device("cuda")
    for key, ctr, want in THREEFRY_KAT:
        got = tf.threefry2x32(*key, torch.tensor([ctr[0]], device=dev),
                              torch.tensor([ctr[1]], device=dev))
        got = (int(got[0][0]), int(got[1][0]))
        if got != want:
            fail("threefry on the card: key %r counter %r gave %r, not %r"
                 % (key, ctr, tuple(map(hex, got)), tuple(map(hex, want))))
    key = tf.fold_in(tf.PRNGKey(0), 17)
    for shape in ((512, 4096), (70001,), ()):
        for width in (8, 16, 32, 64):
            card = tf.random_bits(key, shape, width, dev).cpu()
            if not torch.equal(card, tf.random_bits(key, shape, width,
                                                    "cpu")):
                fail("random_bits(%d) at %r: the card's bits differ from "
                     "the CPU's" % (width, shape))
        card = tf.bernoulli(key, 0.5, shape, dev).cpu()
        if not torch.equal(card, tf.bernoulli(key, 0.5, shape, "cpu")):
            fail("bernoulli(0.5) at %r: the card's mask differs from the "
                 "CPU's" % (shape,))
    got = prng_digests(mx, mx.gpu(0))
    for name, want in PRNG_DIGESTS.items():
        if got[name] != want:
            fail("PRNG digest %s on the card: %s, JAX's %s"
                 % (name, got[name], want))
    ms = device_ms(lambda: tf.bernoulli(key, 0.5, (512, 4096), dev), "",
                   reps=5)
    launches = device_ms.launches
    say("prng: threefry known answers, random_bits (8/16/32/64) and "
        "bernoulli(0.5) at (512, 4096), (70001,) and () equal to the CPU's "
        "bit for bit, %d JAX digests reproduced; one (512, 4096) "
        "bernoulli mask: %.4f ms device time in %d kernel launches "
        "(int64 lanes)" % (len(PRNG_DIGESTS), ms, launches))
    return ms, launches


# ---------------------------------------------------------------------------
# AlexNet phase: bench.py's alexnet workload
# ---------------------------------------------------------------------------

# bench.py _IMAGE_NETS["alexnet"] and bench_image: batch 512, 3x224x224,
# 1000 classes, bf16 compute, SGD momentum 0.9, wd 1e-4, rescale 1/B
ALEX_BATCH, ALEX_IMAGE, ALEX_CLASSES, ALEX_LR = 512, 224, 1000, 0.1
ALEX_SMALL_BATCH = 4
ALEX_KEEP = 0.5          # both Dropouts: p 0.5
ALEX_NLL_FALL = 0.75     # the lowest timed NLL below this x the first


def _dropout_nodes(sym):
    """[(uid, Dropout node name, name of the node feeding it)] in the
    graph evaluator's topological order (uid = position, as
    ``_graph_eval_fn`` folds it into the run's key)."""
    from mxnet_tpu_torch.symbol.symbol import _topo_order
    order = _topo_order(sym._entries)
    return [(uid, n.name, n.inputs[0][0].name)
            for uid, n in enumerate(order)
            if n.op is not None and n.op.name == "Dropout"]


def _capture_into(store, names):
    def capture(name, outs):
        if name in names:
            store[name] = outs[0].detach()
    return capture


def check_dropout(what, inp, out, mask):
    """Fail unless ``out`` is ``inp / keep`` where ``mask`` (the CPU's
    draw) keeps and 0 elsewhere, bit for bit."""
    import torch
    want = torch.where(mask.to(inp.device), inp / ALEX_KEEP, 0.0).to(
        inp.dtype)
    if not torch.equal(out, want):
        bad = int((out != want).sum().item())
        fail("%s: the Dropout output differs from the CPU mask's in %d of "
             "%d elements" % (what, bad, out.numel()))


def alexnet_reference_check():
    """Small and untimed: AlexNet (224x224, 1000 classes) at batch 4, one
    forward-and-backward of TrainStep._grads from one seeded init and
    PRNGKey(0), on the card and on the CPU: every run's two Dropouts keep
    exactly the elements of the CPU mask for fold_in(PRNGKey(0), uid),
    and the card's float64 gradients agree with the CPU's within
    compare_grads' tolerance. In float32 the card's gradients are held
    in norm only: a max-pool window whose two largest inputs lie within
    rounding of each other sends its gradient to either, and cuDNN's or
    PyTorch's CUDA rounding flips some of the conv1/conv2 windows (4.5e-3
    and 1.5e-3 of those gradients, in norm, on an H100), as it does the
    ResNet's in the executor phase."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _threefry as tf
    from mxnet_tpu_torch.executor import _graph_eval_fn
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import alexnet
    from mxnet_tpu_torch.parallel import make_train_step

    B, S = ALEX_SMALL_BATCH, ALEX_IMAGE
    sym = alexnet.get_symbol(num_classes=ALEX_CLASSES)
    drops = _dropout_nodes(sym)
    rng = np.random.RandomState(15)
    batch = {"data": rng.standard_normal((B, 3, S, S)).astype(np.float32),
             "softmax_label": rng.randint(0, ALEX_CLASSES, (B,)).astype(
                 np.float32)}
    key = tf.PRNGKey(0)
    runs = {}
    for tag, ctx, dt in (("card64", mx.gpu(0), "float64"),
                         ("cpu64", mx.cpu(), "float64"),
                         ("card32", mx.gpu(0), "float32")):
        step = make_train_step(sym, optimizer="sgd", ctx=ctx)
        mx.random.seed(0)
        params, _, aux = step.init_state(
            Xavier(factor_type="in", magnitude=2.0),
            {"data": (B, 3, S, S), "softmax_label": (B,)}, dtype=dt)
        seen = {}
        step._eval_fn = _graph_eval_fn(sym, capture=_capture_into(
            seen, {n for d in drops for n in d[1:]}))
        feed = step.place_batch(batch)
        feed["data"] = feed["data"].to(params["conv1_weight"].dtype)
        outs, _, grads = step._grads(params, aux, feed, key)
        for uid, name, src in drops:
            check_dropout("small AlexNet (%s) %s" % (tag, name), seen[src],
                          seen[name], tf.bernoulli(tf.fold_in(key, uid),
                                                   ALEX_KEEP,
                                                   tuple(seen[src].shape),
                                                   "cpu"))
        runs[tag] = ({n: g.double().cpu() for n, g in grads.items()},
                     outs[0].double().cpu())
    g64, p64 = runs["cpu64"]
    equal, worst, worst_rel = compare_grads("small AlexNet float64, card "
                                            "vs CPU", runs["card64"][0], g64)
    perr = float((runs["card64"][1] - p64).abs().max())
    g32, p32 = runs["card32"]
    num = sum(float(((g32[n] - g) ** 2).sum()) for n, g in g64.items())
    den = sum(float((g ** 2).sum()) for g in g64.values())
    dist32 = (num / den) ** 0.5
    perr32 = float((p32 - p64).abs().max())
    # SoftmaxOutput computes its probabilities in float32 whatever the
    # input dtype, so they carry float32 rounding in both runs
    if not (perr <= 1e-7 and perr32 <= 1e-7 and dist32 <= 1e-2 and all(
            torch.isfinite(g).all() for g in g32.values())):
        fail("small AlexNet: probabilities max abs err %.3g (float64) and "
             "%.3g (float32) from the CPU's (limit 1e-7), float32 gradients "
             "%.3g from the float64 ones (relative, in norm; limit 1e-2)"
             % (perr, perr32, dist32))
    say("alexnet reference: AlexNet (%dx3x%dx%d, %d classes) "
        "TrainStep._grads with PRNGKey(0): both Dropouts (uids %s) keep "
        "exactly the CPU mask's elements on the card (float64, float32) and "
        "the CPU (float64); float64 card vs CPU: %d of %d gradients equal "
        "bit for bit, worst %.3g (%.3g of max|g|; rtol %g, atol %g x "
        "max|g|), probabilities max abs err %.3g; float32 card: gradients "
        "%.3g from the float64 ones (relative, in norm), probabilities "
        "%.3g" % (B, S, S, ALEX_CLASSES, [d[0] for d in drops], equal,
                  len(g64), worst, worst_rel, GRAD_RTOL, GRAD_ATOL_REL,
                  perr, dist32, perr32))


def alexnet_phase():
    """bench.py's AlexNet workload through make_train_step -> init_state
    -> step, PRNGKey(0) every step as bench.py passes it: 2 warm steps
    (the second profiled) and 10 timed ones. Fails unless the NLL is
    finite, its lowest timed value under ALEX_NLL_FALL x the first, and
    fc6's Dropout output (read through the graph
    evaluator's capture hook, the Executor's monitor path, in one more
    forward-and-backward of the step) keeps exactly the elements of the
    CPU mask for fold_in(PRNGKey(0), uid), scaled by 2. Times the LRN and
    Dropout ops and a mask at the step's shapes."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _threefry as tf
    from mxnet_tpu_torch.executor import _graph_eval_fn
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import alexnet
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.parallel import make_train_step

    alexnet_reference_check()
    B, S = ALEX_BATCH, ALEX_IMAGE
    t0 = time.perf_counter()
    sym = alexnet.get_symbol(num_classes=ALEX_CLASSES)
    drops = _dropout_nodes(sym)
    step = make_train_step(sym, optimizer="sgd",
                           optimizer_params={"momentum": 0.9, "wd": 1e-4,
                                             "rescale_grad": 1.0 / B},
                           compute_dtype="bfloat16")
    x = np.random.RandomState(0).standard_normal((B, 3, S, S)).astype(
        np.float32)
    y = np.random.RandomState(1).randint(0, ALEX_CLASSES, (B,)).astype(
        np.float32)
    mx.random.seed(0)
    state = step.init_state(Xavier(factor_type="in", magnitude=2.0),
                            {"data": (B, 3, S, S), "softmax_label": (B,)})
    batch = step.place_batch({"data": x, "softmax_label": y})
    key = tf.PRNGKey(0)
    nparam = sum(v.numel() for v in state[0].values())
    say("alexnet: AlexNet %d params (%.1f M), batch %d x 3x%dx%d, %d "
        "classes, SGD momentum 0.9 wd 1e-4 lr %g rescale 1/%d, bf16 "
        "compute, Dropouts at uids %s, on %s, set up in %.1f s" % (
            nparam, nparam / 1e6, B, S, S, ALEX_CLASSES, ALEX_LR, B,
            [d[0] for d in drops], step.device, time.perf_counter() - t0))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_mt_counts()
    nlls, times = [], []
    for i in range(WARM_STEPS + TIMED_STEPS):
        t = time.perf_counter()
        if i == 1:   # the second warm step, under the profiler
            state, outs = profile("alexnet step (warm)",
                                  lambda: step(state, batch, ALEX_LR, key),
                                  top=14)
        else:
            state, outs = step(state, batch, ALEX_LR, key)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        nlls.append(mean_nll(outs[0], batch["softmax_label"]))
        del outs
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = check_mt_counts("alexnet", WARM_STEPS + TIMED_STEPS,
                               len(state[0]))
    step_ms = statistics.median(times[WARM_STEPS:])
    say("alexnet: NLL per step %s" % " ".join("%.4f" % v for v in nlls))
    say("alexnet: step %.2f ms (median of %d timed steps; all: %s), %.1f "
        "img/s, peak device memory %.2f GB" % (
            step_ms, TIMED_STEPS, " ".join("%.1f" % v for v in times),
            B / step_ms * 1e3, peak_gb))
    if not all(np.isfinite(nlls)):
        fail("alexnet: non-finite NLL %r" % (nlls,))
    # at bench.py's lr 0.1 on one repeated batch the NLL falls and climbs
    # back (the JAX package's too: tests/test_torch_models.py), so the
    # lowest timed NLL is held a quarter below the first step's
    low = min(nlls[WARM_STEPS:])
    if not low < ALEX_NLL_FALL * nlls[0]:
        fail("alexnet: NLL did not fall: first %g, lowest timed %g (limit "
             "%g x first), last %g" % (nlls[0], low, ALEX_NLL_FALL,
                                       nlls[-1]))

    # fc6's Dropout in one more forward-and-backward of the step's own
    # path, its input and output captured
    uid, name, src = drops[0]
    seen = {}
    step._eval_fn = _graph_eval_fn(sym, capture=_capture_into(
        seen, {name, src}))
    step._grads(state[0], state[2], batch, key)
    mask = tf.bernoulli(tf.fold_in(key, uid), ALEX_KEEP,
                        tuple(seen[src].shape), "cpu")
    check_dropout("alexnet fc6 (%s, uid %d)" % (name, uid), seen[src],
                  seen[name], mask)
    kept = float(mask.float().mean())
    say("alexnet: fc6's Dropout (%s, uid %d, %r %s) keeps exactly the CPU "
        "mask of fold_in(PRNGKey(0), %d), scaled by 2 (%.4f kept)" % (
            name, uid, tuple(seen[name].shape), seen[name].dtype, uid,
            kept))
    del state, seen
    torch.cuda.empty_cache()

    # the new ops alone at the step's shapes (bf16), device time
    lrn, dropout = get_op("LRN").fn, get_op("Dropout").fn
    gen = torch.Generator(device="cuda").manual_seed(2)
    ops = {}
    for label, shape in (("LRN conv1", (B, 96, 55, 55)),
                         ("LRN conv2", (B, 256, 27, 27))):
        a = torch.randn(shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        ops[label] = (device_ms(lambda: lrn(a, alpha=1e-4, beta=0.75,
                                            knorm=2, nsize=5), "", reps=5),
                      device_ms.launches)
    a = torch.randn((B, 4096), device="cuda", generator=gen).to(
        torch.bfloat16)
    ops["Dropout fc6"] = (device_ms(lambda: dropout(
        a, p=0.5, is_train=True, rng=key), "", reps=5), device_ms.launches)
    ops["mask fc6"] = (device_ms(lambda: tf.bernoulli(
        key, ALEX_KEEP, (B, 4096), a.device), "", reps=5),
        device_ms.launches)
    say("alexnet: forward device time alone (bf16): %s" % "; ".join(
        "%s %.4f ms in %d launches" % (k, ms, n)
        for k, (ms, n) in ops.items()))
    del a
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the multi-tensor optimizer kernels (csrc/multi_tensor.cu)
# ---------------------------------------------------------------------------

def mt_ragged(n, big=None, seed=0):
    """``n`` ragged tensor sizes (1 to 3000 elements) from a seeded
    stream, with ``big`` (index, size) put in; lists of more than
    MAX_TENSORS tensors take several launches."""
    sizes = [int(x) for x in
             np.random.RandomState(seed).randint(1, 3001, size=n)]
    if big is not None:
        sizes[big[0]] = big[1]
    return tuple(sizes)


# (id, op, sizes, attrs, flag, gscale, inv_scale, donate, dtype); shared
# with tests/test_torch_kernels.py. A flag of False must leave every bit.
MT_UPDATE_CASES = [
    ("adam_ragged", "adam_update", (1, 2 ** 20 + 3, 7, 4096, 33), {}, None,
     None, None, True, "float32"),
    ("adam_wd_clip", "adam_update", (1000, 5, 2 ** 16 + 1),
     {"wd": 1e-2, "clip_gradient": 0.05, "rescale_grad": 0.125}, True,
     0.73, 0.25, True, "float32"),
    ("adam_masked", "adam_update", (1, 300, 4099), {"wd": 1e-2}, False,
     0.5, 0.5, True, "float32"),
    ("adam_masked_fresh", "adam_update", (1, 300, 4099), {}, False, None,
     None, False, "float32"),
    ("adam_fresh", "adam_update", (17, 2 ** 20 + 3),
     {"beta1": 0.8, "beta2": 0.95, "epsilon": 1e-6}, True, None, None,
     False, "float32"),
    ("sgd_mom", "sgd_mom_update", (1, 2 ** 20 + 3, 9),
     {"momentum": 0.9, "wd": 1e-4, "rescale_grad": 1 / 512}, None, None,
     None, True, "float32"),
    ("sgd_plain_clip", "sgd_mom_update", (4096, 3),
     {"clip_gradient": 0.01}, True, 0.9, None, True, "float32"),
    ("sgd_masked", "sgd_mom_update", (64, 65), {"momentum": 0.9}, False,
     None, None, True, "float32"),
    # more than MAX_TENSORS tensors: several launches
    ("adam_many", "adam_update", mt_ragged(300, (280, 2 ** 16 + 5)),
     {"wd": 1e-3, "clip_gradient": 0.5}, True, 0.9, 0.5, True, "float32"),
    ("sgd_many_masked_fresh", "sgd_mom_update", mt_ragged(520, seed=1),
     {"momentum": 0.9}, False, None, None, False, "float32"),
    # bfloat16 weights, gradients and states (init_state(dtype=...))
    ("adam_bf16", "adam_update", (1, 2 ** 20 + 3, 7, 33),
     {"wd": 1e-2, "clip_gradient": 0.3, "rescale_grad": 0.125}, True,
     0.73, 0.25, True, "bfloat16"),
    ("adam_bf16_fresh", "adam_update", (4099, 5),
     {"beta1": 0.8, "epsilon": 1e-6}, None, None, None, False, "bfloat16"),
    ("adam_bf16_masked", "adam_update", (300, 9), {}, False, 0.5, 0.5,
     True, "bfloat16"),
    ("sgd_mom_bf16", "sgd_mom_update", (2 ** 16 + 1, 3),
     {"momentum": 0.9, "wd": 1e-4, "clip_gradient": 0.01}, True, 0.9,
     None, True, "bfloat16"),
    ("sgd_mom_bf16_many", "sgd_mom_update", mt_ragged(270, seed=2),
     {"momentum": 0.9, "rescale_grad": 1 / 64}, None, None, 0.125, False,
     "bfloat16"),
]

# (id, grad sizes, outputs: ((shape, dtype), ...), planted (where, value)
# in the last gradient or output, inject, inv_scale, clip_norm); the flag
# is exact, the sum within MT_SUM_RTOL of the plain version's
MT_NORM_CASES = [
    ("ragged", (1, 2 ** 20 + 3, 7, 4096), (), None, 1.0, None, None),
    ("outs_bf16_clip", (5000, 3), (((2048, 33), "bfloat16"),), None, 1.0,
     None, 0.5),
    ("scaled", (70000, 1), (((100,), "float32"),), None, 1.0, 2.0 ** -10,
     1.0),
    ("nan_grad", (1000, 2 ** 20 + 3), (), ("grad", float("nan")), 1.0,
     None, None),
    ("inf_grad", (1000, 77), (), ("grad", float("inf")), 1.0, None, 2.0),
    ("inf_out", (1000,), (((64, 65), "bfloat16"),), ("out", float("-inf")),
     1.0, None, None),
    ("injected_nan", (300, 4), (), None, float("nan"), None, 1.0),
    # more than MAX_TENSORS tensors: several launches, the outputs after
    # the gradients, straddling a launch boundary
    ("many_grads", mt_ragged(600, (500, 2 ** 20 + 3), seed=3), (), None,
     1.0, 2.0 ** -8, 1.0),
    ("many_grads_nan", mt_ragged(300, seed=4),
     (((64, 65), "bfloat16"), ((7,), "float32")), ("grad", float("nan")),
     1.0, None, None),
    ("outs_straddle", mt_ragged(250, seed=5),
     tuple(((100 + i,), ("float32", "bfloat16")[i % 2]) for i in range(10)),
     None, 1.0, 0.5, 2.0),
    ("outs_straddle_inf", mt_ragged(250, seed=5),
     tuple(((100 + i,), ("float32", "bfloat16")[i % 2]) for i in range(10)),
     ("out", float("inf")), 1.0, None, None),
]
MT_SUM_RTOL = 1e-6
MT_LR = 0.0123


def mt_operands(op, sizes, device, seed=0, dtype="float32"):
    """(weights, grads, state tuples) of ``dtype`` from a seeded CPU
    generator, on ``device``."""
    import torch
    from mxnet_tpu_torch.ops import optimizer_kernels as mt
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(n, scale=1.0):
        return (torch.randn(n, generator=gen) * scale).to(
            getattr(torch, dtype)).to(device)
    ws = [rnd(n) for n in sizes]
    gs = [rnd(n, 3.0) for n in sizes]
    if mt.MT_OPS[op][1] == 2:
        ss = [(rnd(n, 0.1), rnd(n).abs()) for n in sizes]
    else:
        ss = [(rnd(n, 0.1),) for n in sizes]
    return ws, gs, ss


def mt_scalars(device, flag, gscale, inv):
    """The update's device scalars (bool flag, float32 gscale and
    inv_scale) as 0-d tensors, None where not given."""
    import torch

    def t(v, dtype):
        return None if v is None else torch.tensor(v, dtype=dtype,
                                                   device=device)
    return (t(flag, torch.bool), t(gscale, torch.float32),
            t(inv, torch.float32))


def mt_norm_operands(case, device):
    """(grads, outs, inv_scale tensor) of a MT_NORM_CASES case, the
    planted value in place."""
    import torch
    _, sizes, outs, plant, _, inv, _ = case
    gen = torch.Generator(device="cpu").manual_seed(2)
    grads = [torch.randn(n, generator=gen).to(device) for n in sizes]
    out_t = [torch.rand(shape, generator=gen).to(getattr(torch, dtype)).to(
        device) for shape, dtype in outs]
    if plant is not None:
        where, value = plant
        target = grads[-1] if where == "grad" else out_t[-1]
        target.view(-1)[target.numel() // 2] = value
    inv_t = None if inv is None else torch.tensor(
        inv, dtype=torch.float32, device=device)
    return grads, out_t, inv_t


def _int_bits(t):
    """The tensor's bits, for a comparison that tells -0 from 0 and NaNs
    apart."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def mt_launches(n_tensors, reduction=False):
    """Kernels one call of a multi-tensor wrapper launches over
    ``n_tensors`` non-empty tensors: one a MAX_TENSORS tensors, and the
    reduction's pass over the partials."""
    from mxnet_tpu_torch.ops import optimizer_kernels as mt
    k = -(-n_tensors // mt.MAX_TENSORS)
    return k + 1 if reduction else k


def mt_update_check(what, op, ws, gs, ss, attrs, scalars, donate, lr):
    """The update kernel against its plain version on copies of the same
    operands: every weight and state bit-equal. Returns the worst
    |kernel - plain| (0.0)."""
    import torch
    from mxnet_tpu_torch.ops import optimizer_kernels as mt
    fl, gsc, inv = scalars
    ref = ([t.clone() for t in ws], [t.clone() for t in gs],
           [tuple(x.clone() for x in s) for s in ss])
    before = mt.multi_tensor_opt_update_cuda.launches
    kw, ks = mt.multi_tensor_opt_update_cuda(
        op, ws, gs, ss, lr, attrs, flag=fl, gscale=gsc, inv_scale=inv,
        donate=donate)
    launched = mt.multi_tensor_opt_update_cuda.launches - before
    if launched != mt_launches(len(ws)):
        fail("%s: the update counted %d launches over %d tensors, not %d"
             % (what, launched, len(ws), mt_launches(len(ws))))
    rw, rs = mt._opt_update_reference(op, *ref, lr, attrs, flag=fl,
                                      gscale=gsc, inv_scale=inv,
                                      donate=donate)
    torch.cuda.synchronize()
    pairs = list(zip(kw, rw)) + [(a, b) for sa, sb in zip(ks, rs)
                                 for a, b in zip(sa, sb)]
    for a, b in pairs:
        if not torch.equal(_int_bits(a), _int_bits(b)):
            fail("%s: the update kernel differs from its plain version by "
                 "%g (max abs)" % (what, float((a - b).abs().max())))
    return 0.0


def mt_norm_check(what, grads, outs, inject, inv, rescale, clip):
    """The reduction against its plain version: the flag exact, the sum
    of squares and gscale within MT_SUM_RTOL. Returns (|dS|, dS/S)."""
    import torch
    from mxnet_tpu_torch.ops import optimizer_kernels as mt
    before = mt.multi_tensor_norm_finite_cuda.launches
    s, ok, gs = mt.multi_tensor_norm_finite_cuda(
        grads, outs, inject=inject, inv_scale=inv, rescale=rescale,
        clip_norm=clip)
    launched = mt.multi_tensor_norm_finite_cuda.launches - before
    want = mt_launches(len(grads) + len(outs), reduction=True)
    if launched != want:
        fail("%s: the reduction counted %d launches over %d tensors, not %d"
             % (what, launched, len(grads) + len(outs), want))
    rs, rok, rgs = mt._norm_finite_reference(
        grads, outs, inject=inject, inv_scale=inv, rescale=rescale,
        clip_norm=clip)
    torch.cuda.synchronize()
    if bool(ok) != bool(rok):
        fail("%s: the reduction's finite flag %s, its plain version's %s"
             % (what, bool(ok), bool(rok)))
    if not bool(rok):
        return 0.0, 0.0
    err = abs(float(s) - float(rs))
    rel = err / abs(float(rs)) if float(rs) else err
    gerr = abs(float(gs) - float(rgs)) / abs(float(rgs))
    if rel > MT_SUM_RTOL or gerr > MT_SUM_RTOL:
        fail("%s: sum of squares %r against %r (rel %.3g), gscale %r "
             "against %r (limit %g)" % (what, float(s), float(rs), rel,
                                        float(gs), float(rgs),
                                        MT_SUM_RTOL))
    return err, rel


def param_shapes(sym, data_shapes):
    """The parameters' shapes of a symbol at these input shapes."""
    arg_shapes, _, _ = sym.infer_shape(**data_shapes)
    inputs = set(data_shapes)
    return [tuple(s) for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in inputs]


def mt_kernel_phase():
    """The two multi-tensor kernels against their plain versions on the
    card (the update bit for bit at MT_UPDATE_CASES and on the flagship
    LM's 339.9 M-parameter Adam list; the reduction's flag exact with a
    NaN and an Inf planted, its sum within MT_SUM_RTOL, at
    MT_NORM_CASES and on the LM's gradients and outputs), then each
    timed at the LM's shapes beside its bound, its plain version and the
    nearest library call (not the same function: torch._fused_adam_
    applies a bias correction adam_update does not; torch._foreach_norm
    returns one norm a tensor and no flag), and the SGD-momentum update
    at AlexNet's and ResNet-50's lists (torch._fused_sgd_)."""
    import torch
    from mxnet_tpu_torch.models import alexnet, resnet, transformer
    from mxnet_tpu_torch.ops import optimizer_kernels as mt

    dev = torch.device("cuda", 0)
    for case in MT_UPDATE_CASES:
        name, op, sizes, attrs, flag, gscale, inv, donate, dtype = case
        ws, gs, ss = mt_operands(op, sizes, dev, dtype=dtype)
        mt_update_check("multi_tensor update %s" % name, op, ws, gs, ss,
                        attrs, mt_scalars(dev, flag, gscale, inv), donate,
                        MT_LR)
    worst_rel = 0.0
    for case in MT_NORM_CASES:
        grads, outs, inv = mt_norm_operands(case, dev)
        _, rel = mt_norm_check("multi_tensor norm %s" % case[0], grads,
                               outs, case[4], inv, 0.125, case[6])
        worst_rel = max(worst_rel, rel)
    say("kernel multi_tensor: the update bit-equal to its plain version in "
        "%d cases (1 to 2^20+3 elements, wd, clip_gradient, gscale, "
        "1/scale, a false flag, in place and fresh); the reduction's flag "
        "exact and its sum within %.3g relative in %d cases (NaN and Inf "
        "planted, the nan@N multiplier)" % (
            len(MT_UPDATE_CASES), worst_rel, len(MT_NORM_CASES)))

    # the flagship LM's parameter list (Adam, bench.py's step)
    sym = transformer.get_symbol(VOCAB, SEQ, num_layers=LAYERS,
                                 num_heads=HEADS, dim=DIM,
                                 ffn_hidden=4 * DIM)
    shapes = param_shapes(sym, {"data": (TRAIN_BATCH, SEQ),
                                "softmax_label": (TRAIN_BATCH, SEQ)})
    sizes = [int(np.prod(s)) for s in shapes]
    N = sum(sizes)
    attrs = {"rescale_grad": 1.0 / TRAIN_BATCH}
    ws, gs, ss = mt_operands("adam_update", sizes, dev, seed=5)
    err = mt_update_check("multi_tensor update, LM (%d tensors)"
                          % len(sizes), "adam_update", ws, gs, ss, attrs,
                          (None, None, None), False, TRAIN_LR)
    outs = torch.rand((TRAIN_BATCH * SEQ, VOCAB), device=dev).to(
        torch.bfloat16)
    s_err, s_rel = mt_norm_check("multi_tensor norm, LM", gs, [outs], 1.0,
                                 None, 1.0 / TRAIN_BATCH, 1.0)

    # what the card's memory delivers to a plain copy, for scale beside
    # the bounds' published 3.35 TB/s: 1 GiB read and 1 GiB written
    src = torch.empty(2 ** 28, device=dev)
    dst = torch.empty_like(src)
    copy_ms = device_ms(lambda: dst.copy_(src), "", reps=10)
    copy_rate = 2 * 2 ** 30 / copy_ms / 1e9
    say("kernel multi_tensor: a 1 GiB float32 copy_ takes %.4f ms: %.3f "
        "TB/s read + written (%d of 10 traced calls lost a record)" % (
            copy_ms, copy_rate, device_ms.lost))
    del src, dst

    upd = lambda: mt.multi_tensor_opt_update_cuda(  # noqa: E731
        "adam_update", ws, gs, ss, TRAIN_LR, attrs)
    upd_ms = device_ms(upd, "", reps=10)
    upd_launches, upd_lost = device_ms.launches, device_ms.lost
    # the lr read on the device (a captured step's): bit-equal, and timed
    lr_dev = torch.full((), TRAIN_LR, dtype=torch.float32, device=dev)
    mt_update_check("multi_tensor update, LM, lr on the device",
                    "adam_update", ws, gs, ss, attrs, (None, None, None),
                    False, lr_dev)
    upd_dev_ms = device_ms(lambda: mt.multi_tensor_opt_update_cuda(
        "adam_update", ws, gs, ss, lr_dev, attrs), "", reps=10)
    if upd_launches != mt_launches(len(sizes)):
        fail("multi_tensor update, LM: %g kernels a call traced, not %d"
             % (upd_launches, mt_launches(len(sizes))))
    plain_ms = device_ms(lambda: mt._opt_update_reference(
        "adam_update", ws, gs, ss, TRAIN_LR, attrs), "", reps=3)
    plain_launches = device_ms.launches
    means = [s[0] for s in ss]
    variances = [s[1] for s in ss]
    steps = [torch.ones((), device=dev) for _ in ws]
    lib_ms = device_ms(lambda: torch._fused_adam_(
        ws, gs, means, variances, [], steps, lr=TRAIN_LR, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
        maximize=False), "", reps=10)
    upd_bound = 28 * N / PEAK_BYTES_PER_S * 1e3
    say("kernel multi_tensor_opt_update (adam, LM %d tensors, %d params): "
        "%.4f ms device time in %g launches (%d of 10 traced calls lost a "
        "record), bound %.4f ms (bytes, 28 B a parameter): %.3f TB/s, "
        "%.1f%% of the copy_'s rate; with the lr read on the device "
        "%.4f ms, bit-equal; plain per-parameter route %.4f ms in "
        "%g launches, library torch._fused_adam_ %.4f ms (bias-corrected: "
        "not the same function)" % (
            len(sizes), N, upd_ms, upd_launches, upd_lost, upd_bound,
            28 * N / upd_ms / 1e9, 100 * 28 * N / upd_ms / 1e9 / copy_rate,
            upd_dev_ms, plain_ms, plain_launches, lib_ms))

    norm = lambda: mt.multi_tensor_norm_finite_cuda(  # noqa: E731
        gs, [outs], rescale=1.0 / TRAIN_BATCH, clip_norm=1.0)
    norm_ms = device_ms(norm, "", reps=10)
    norm_launches, norm_lost = device_ms.launches, device_ms.lost
    if norm_launches != mt_launches(len(gs) + 1, reduction=True):
        fail("multi_tensor norm, LM: %g kernels a call traced, not %d"
             % (norm_launches, mt_launches(len(gs) + 1, reduction=True)))
    norm_plain = device_ms(lambda: mt._norm_finite_reference(
        gs, [outs], rescale=1.0 / TRAIN_BATCH, clip_norm=1.0), "", reps=3)
    norm_lib = device_ms(lambda: torch._foreach_norm(gs), "", reps=10)
    norm_bytes = 4 * N + 2 * outs.numel()
    norm_bound = norm_bytes / PEAK_BYTES_PER_S * 1e3
    say("kernel multi_tensor_norm_finite (LM gradients %d params + the "
        "bf16 outputs %r): %.4f ms device time in %g launches (%d of 10 "
        "traced calls lost a record), bound %.4f ms (bytes: %.3f GB): "
        "%.3f TB/s read; plain %.4f ms, library torch._foreach_norm %.4f "
        "ms (per-tensor norms, no flag); sum of squares |err| %.3g (rel "
        "%.3g)" % (
            N, tuple(outs.shape), norm_ms, norm_launches, norm_lost,
            norm_bound, norm_bytes / 1e9, norm_bytes / norm_ms / 1e9,
            norm_plain, norm_lib, s_err, s_rel))
    del ws, gs, ss, means, variances, steps, outs
    torch.cuda.empty_cache()

    # the LM's list in bfloat16 (init_state(dtype="bfloat16")): 14 B a
    # parameter
    ws, gs, ss = mt_operands("adam_update", sizes, dev, seed=7,
                             dtype="bfloat16")
    mt_update_check("multi_tensor update, LM bf16", "adam_update", ws, gs,
                    ss, attrs, (None, None, None), False, TRAIN_LR)
    bf16_ms = device_ms(lambda: mt.multi_tensor_opt_update_cuda(
        "adam_update", ws, gs, ss, TRAIN_LR, attrs), "", reps=10)
    bf16_plain = device_ms(lambda: mt._opt_update_reference(
        "adam_update", ws, gs, ss, TRAIN_LR, attrs), "", reps=3)
    bf16_bound = 14 * N / PEAK_BYTES_PER_S * 1e3
    say("kernel multi_tensor_opt_update (adam, LM, bfloat16): %.4f ms "
        "device time, bound %.4f ms (bytes, 14 B a parameter), plain %.4f "
        "ms" % (bf16_ms, bf16_bound, bf16_plain))
    del ws, gs, ss
    torch.cuda.empty_cache()

    # SGD with momentum at the image models' lists (bench.py's steps)
    sgd = {}
    for label, net, shape in (
            ("alexnet", alexnet.get_symbol(num_classes=ALEX_CLASSES),
             (ALEX_BATCH, 3, ALEX_IMAGE, ALEX_IMAGE)),
            ("resnet-%d" % RESNET_LAYERS, resnet.get_symbol(
                num_classes=RESNET_CLASSES, num_layers=RESNET_LAYERS,
                image_shape=(3, RESNET_IMAGE, RESNET_IMAGE)),
             (RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE))):
        sizes = [int(np.prod(s)) for s in param_shapes(
            net, {"data": shape, "softmax_label": (shape[0],)})]
        n = sum(sizes)
        a = {"momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0 / shape[0]}
        ws, gs, ss = mt_operands("sgd_mom_update", sizes, dev, seed=6)
        mt_update_check("multi_tensor update, %s sgd" % label,
                        "sgd_mom_update", ws, gs, ss, a,
                        (None, None, None), False, 0.1)
        k_ms = device_ms(lambda: mt.multi_tensor_opt_update_cuda(
            "sgd_mom_update", ws, gs, ss, 0.1, a), "", reps=10)
        lr_dev = torch.full((), 0.1, dtype=torch.float32, device=dev)
        mt_update_check("multi_tensor update, %s sgd, lr on the device"
                        % label, "sgd_mom_update", ws, gs, ss, a,
                        (None, None, None), False, lr_dev)
        kd_ms = device_ms(lambda: mt.multi_tensor_opt_update_cuda(
            "sgd_mom_update", ws, gs, ss, lr_dev, a), "", reps=10)
        p_ms = device_ms(lambda: mt._opt_update_reference(
            "sgd_mom_update", ws, gs, ss, 0.1, a), "", reps=3)
        moms = [s[0] for s in ss]
        l_ms = device_ms(lambda: torch._fused_sgd_(
            ws, gs, moms, weight_decay=1e-4, momentum=0.9, lr=0.1,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), "", reps=10)
        sgd[label] = (len(sizes), n, k_ms, 20 * n / PEAK_BYTES_PER_S * 1e3,
                      p_ms, l_ms, kd_ms)
        say("kernel multi_tensor_opt_update (sgd momentum, %s %d tensors, "
            "%d params): %.4f ms device time (the lr read on the device: "
            "%.4f ms, bit-equal), bound %.4f ms (bytes, 20 B a parameter), "
            "plain %.4f ms, library torch._fused_sgd_ %.4f ms"
            % (label, len(sizes), n, k_ms, kd_ms, sgd[label][3], p_ms, l_ms))
        del ws, gs, ss, moms
        torch.cuda.empty_cache()

    return [
        {"name": "multi_tensor_opt_update", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/multi_tensor.cu",
         "replaces": "mxnet_tpu/parallel/trainer.py:1076",
         "launches": None, "max_abs_err": err, "ms": upd_ms,
         "plain_ms": plain_ms, "bound_ms": upd_bound, "bound_by": "bytes",
         "library_ms": lib_ms, "library": "torch._fused_adam_",
         "shape": "LM Adam, %d params" % N, "lr_device_ms": upd_dev_ms,
         "bf16": {"ms": bf16_ms, "bound_ms": bf16_bound,
                  "plain_ms": bf16_plain},
         "sgd": {k: {"tensors": v[0], "params": v[1], "ms": v[2],
                     "bound_ms": v[3], "plain_ms": v[4], "library_ms": v[5],
                     "lr_device_ms": v[6]}
                 for k, v in sgd.items()}},
        {"name": "multi_tensor_norm_finite", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/multi_tensor.cu",
         "replaces": "mxnet_tpu/parallel/trainer.py:1043",
         "launches": None, "max_abs_err": s_err, "max_rel_err": s_rel,
         "ms": norm_ms, "plain_ms": norm_plain, "bound_ms": norm_bound,
         "bound_by": "bytes", "library_ms": norm_lib,
         "library": "torch._foreach_norm",
         "shape": "LM gradients %d params + outputs %dx%d bf16" % (
             N, TRAIN_BATCH * SEQ, VOCAB)},
    ]


def mt_counters():
    from mxnet_tpu_torch.ops import optimizer_kernels as mt
    return mt.multi_tensor_opt_update_cuda, mt.multi_tensor_norm_finite_cuda


def reset_mt_counts():
    for c in mt_counters():
        c.launches = 0


def check_mt_counts(what, steps, n_params, n_outs=None):
    """Fail unless the multi-tensor update launched mt_launches(n_params)
    kernels a step, and the reduction over the gradients and the
    ``n_outs`` outputs mt_launches(n_params + n_outs, reduction=True) a
    guarded step (``n_outs`` given) and none otherwise; their counts."""
    upd, norm = mt_counters()
    guarded = n_outs is not None
    want = {upd.__name__: steps * mt_launches(n_params),
            norm.__name__: steps * mt_launches(n_params + n_outs, True)
            if guarded else 0}
    got = {upd.__name__: upd.launches, norm.__name__: norm.launches}
    if got != want:
        fail("%s: multi-tensor launches %r, not %r (%d steps)"
             % (what, got, want, steps))
    return got


# ---------------------------------------------------------------------------
# fit path: TrainStep.fit on the flagship LM
# ---------------------------------------------------------------------------

FIT_BATCHES, FIT_EPOCHS = 4, 2     # batches an epoch, epochs
FIT_NAN_STEP = 6                    # MXNET_FAULT_SPEC nan@6: epoch 1's 2nd
PPL_RTOL = 1e-3
RESUME_LAYERS, RESUME_BATCHES, RESUME_SIGTERM = 2, 3, 4


def lm_tokens(n_batches, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, VOCAB, (n_batches * TRAIN_BATCH, SEQ)).astype(
        np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def batch_nll(outs, placed):
    """(sum of -log p at the labels that are not -1, their count) of one
    batch, on the card in float32, as Perplexity sums it."""
    import torch
    lab = placed["softmax_label"].reshape(-1).long()
    valid = lab >= 0
    p = outs[0].reshape(-1, outs[0].shape[-1])[
        torch.arange(lab.numel(), device=lab.device), lab].float()
    p = torch.where(valid, p, torch.ones_like(p))
    return (-torch.log(torch.clamp(p, min=1e-10)).sum(),
            valid.sum().float())


def fit_phase():
    """The flagship LM through make_train_step -> fit(NDArrayIter) at
    full width: Adam, bf16 compute, rescale 1/8, a CosineScheduler, the
    fused Perplexity(ignore_label=-1), the guardrail at its default and
    MXNET_FAULT_SPEC=nan@FIT_NAN_STEP. A checked run: the masked step
    leaves every parameter and Adam state bit-equal (read through the
    batch-end callback's locals), guard_report counts one masked step,
    and the last epoch's perplexity equals the host recomputation over
    its unmasked batches within PPL_RTOL, with the masked batch out of
    the metric's count. A timed run (no callback work): at most one
    blocking host sync a step plus one a metric.get(), step ms (median,
    boundary to boundary), tokens/s, peak memory, and the launch counts.
    Then save_state -> load_state at full width, bit for bit, in a
    temporary directory; and, at depth RESUME_LAYERS under
    torch.use_deterministic_algorithms(True), a fit cut by
    sigterm@RESUME_SIGTERM exits at its boundary checkpoint and the
    resumed fit lands on the uninterrupted run's weights bit for bit.
    Returns the timed run's launch counts."""
    import shutil
    import tempfile

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io, lr_scheduler, metric, profiler
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.parallel import make_train_step
    from mxnet_tpu_torch.parallel import resilience

    B = TRAIN_BATCH
    steps = FIT_BATCHES * FIT_EPOCHS
    t0 = time.perf_counter()
    sym = transformer.get_symbol(VOCAB, SEQ, num_layers=LAYERS,
                                 num_heads=HEADS, dim=DIM,
                                 ffn_hidden=4 * DIM)
    step = make_train_step(sym, optimizer="adam",
                           optimizer_params={"rescale_grad": 1.0 / B},
                           compute_dtype="bfloat16")
    toks, labels = lm_tokens(FIT_BATCHES, seed=3)
    train = io.NDArrayIter(toks, labels, batch_size=B)
    mx.random.seed(0)
    state = step.init_state(Xavier(), {"data": (B, SEQ),
                                       "softmax_label": (B, SEQ)})

    def sched():
        return lr_scheduler.CosineScheduler(
            max_update=2 * steps, base_lr=TRAIN_LR, final_lr=TRAIN_LR / 10,
            warmup_steps=2, warmup_begin_lr=TRAIN_LR / 2)

    say("fit: flagship LM, %d batches x %d epochs of %d x %d random tokens "
        "through NDArrayIter, Adam + CosineScheduler, bf16 compute, "
        "Perplexity(ignore_label=-1) fused, guardrail %s, "
        "MXNET_FAULT_SPEC=nan@%d, set up in %.1f s" % (
            FIT_BATCHES, FIT_EPOCHS, B, SEQ,
            "on" if mx.config.get("MXNET_GUARDRAIL") else "OFF",
            FIT_NAN_STEP, time.perf_counter() - t0))
    if not mx.config.get("MXNET_GUARDRAIL"):
        fail("fit: MXNET_GUARDRAIL is off; the phase runs fit's default")

    # -- the checked run -------------------------------------------------
    resilience.install_fault_injector(None)
    os.environ["MXNET_FAULT_SPEC"] = "nan@%d" % FIT_NAN_STEP
    seen = {"n": 0, "nll": [], "snap": None, "masked_equal": None}

    def snap(state):
        p, o, _ = state
        return ({k: v.clone() for k, v in p.items()},
                {k: tuple(s.clone() for s in v) for k, v in o.items()})

    def check_cb(param):
        seen["n"] += 1
        n = seen["n"]
        loc = param.locals
        if param.epoch == FIT_EPOCHS - 1:
            seen["nll"].append((n, batch_nll(loc["outs"], loc["placed"])))
        if n == FIT_NAN_STEP - 1:
            seen["snap"] = snap(loc["state"])
        elif n == FIT_NAN_STEP:
            before, (p, o, _) = seen["snap"], loc["state"]
            seen["masked_equal"] = (
                all(torch.equal(p[k], before[0][k]) for k in p) and
                all(torch.equal(a, b) for k in o
                    for a, b in zip(o[k], before[1][k])))
            seen["snap"] = None
    ppl = metric.Perplexity(ignore_label=-1)
    state, val = step.fit(train, num_epoch=FIT_EPOCHS, state=state,
                          lr_scheduler=sched(), eval_metric=ppl,
                          batch_end_callback=check_cb)
    del os.environ["MXNET_FAULT_SPEC"]
    report = dict(step.guard_report)
    if report.get("masked_steps") != 1:
        fail("fit: guard_report %r, not one masked step" % (report,))
    if not seen["masked_equal"]:
        fail("fit: the masked step %d changed the parameters or the Adam "
             "state" % FIT_NAN_STEP)
    kept = [(float(s), float(c)) for n, (s, c) in seen["nll"]
            if n != FIT_NAN_STEP]
    want = float(np.exp(sum(s for s, _ in kept) / sum(c for _, c in kept)))
    num = float(ppl._dev_stats["num"])
    if num != sum(c for _, c in kept):
        fail("fit: the perplexity counts %g tokens, the unmasked batches "
             "hold %g" % (num, sum(c for _, c in kept)))
    if not np.isfinite(val) or abs(val - want) > PPL_RTOL * want:
        fail("fit: last epoch's perplexity %r, host recomputation over "
             "the unmasked batches %r (rtol %g)" % (val, want, PPL_RTOL))
    say("fit: checked run: guard_report %r; the masked step %d left every "
        "parameter and Adam state bit-equal; last epoch's perplexity %.4f "
        "= host recomputation over its %d unmasked batches %.4f (%d "
        "tokens, the masked batch out)" % (
            report, FIT_NAN_STEP, val, len(kept), want, int(num)))
    del seen

    # -- the timed run -----------------------------------------------------
    counters = (att.flash_fwd_cuda, att.flash_bwd_cuda) + mt_counters()
    for c in counters:
        c.launches = 0
    marks = []
    resilience.install_fault_injector(
        resilience.FaultInjector("nan@%d" % FIT_NAN_STEP))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = profiler.host_sync_count()
    t = time.perf_counter()
    # PyTorch's own record of the stream syncs its ops make (a D2H read,
    # a blocking H2D copy): the fit loop's are the metric's reads
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, val2 = step.fit(
                train, num_epoch=FIT_EPOCHS, state=state,
                lr_scheduler=sched(),
                eval_metric=metric.Perplexity(ignore_label=-1),
                batch_end_callback=lambda p: marks.append(
                    time.perf_counter()))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    syncs = profiler.host_sync_count() - base
    flagged = [str(w.message).splitlines()[0] for w in flagged
               if "called a synchronizing CUDA operation"
               in str(w.message)]
    say("fit: timed run: PyTorch's sync debug mode flagged %d "
        "synchronizing operations (limit: the %d epochs' metric reads)"
        % (len(flagged), FIT_EPOCHS))
    if len(flagged) > FIT_EPOCHS:
        fail("fit: %d stream syncs in the timed run: %s" % (
            len(flagged), "; ".join(sorted(set(flagged))[:4])))
    resilience.install_fault_injector(None)
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    fit_ms = statistics.median(gaps)
    say("fit: timed run: step %.2f ms (median boundary to boundary; all: "
        "%s), %.0f tokens/s, %d steps in %.2f s, peak device memory %.2f "
        "GB, perplexity %.4f, %d blocking host syncs (limit %d steps + %d "
        "metric reads), guard_report %r" % (
            fit_ms, " ".join("%.1f" % g for g in gaps), B * SEQ / fit_ms * 1e3,
            steps, wall, peak_gb, val2, syncs, steps, FIT_EPOCHS,
            step.guard_report))
    if syncs > steps + FIT_EPOCHS:
        fail("fit: %d blocking host syncs for %d steps and %d metric "
             "reads" % (syncs, steps, FIT_EPOCHS))
    if step.guard_report.get("masked_steps") != 1 or not np.isfinite(val2):
        fail("fit: timed run guard_report %r, perplexity %r"
             % (step.guard_report, val2))
    for name in (att.flash_fwd_cuda.__name__, att.flash_bwd_cuda.__name__):
        if launches[name] != LAYERS * steps:
            fail("fit: %s launched %d times, not %d layers x %d steps"
                 % (name, launches[name], LAYERS, steps))
    check_mt_counts("fit", steps, len(state[0]),
                    len(step.symbol.list_outputs()))
    say("fit: launches %s" % ", ".join("%s %d" % kv for kv in
                                       sorted(launches.items())))

    # -- save_state -> load_state at full width ----------------------------
    need = sum(v.numel() * v.element_size() for v in state[0].values())
    need += sum(s.numel() * s.element_size() for v in state[1].values()
                for s in v)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < 1.2 * need:
            fail("fit: %.2f GB free under %s, the full-width checkpoint "
                 "needs %.2f GB" % (free / 1e9, tmp, need / 1e9))
        t = time.perf_counter()
        path = step.save_state(os.path.join(tmp, "lm"), state)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = step.load_state(os.path.join(tmp, "lm"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        size = os.path.getsize(path)
        same = (set(loaded[0]) == set(state[0]) and all(
            torch.equal(loaded[0][k], state[0][k]) for k in state[0]) and
            all(torch.equal(a, b) for k in state[1]
                for a, b in zip(loaded[1][k], state[1][k])))
        if not same:
            fail("fit: save_state -> load_state is not bit for bit")
        say("fit: save_state %.2f GB in %.1f s, load_state in %.1f s, "
            "params and Adam state bit-equal" % (size / 1e9, save_s,
                                                 load_s))
        del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del state, step
    torch.cuda.empty_cache()
    resume_check()
    return launches


def resume_check():
    """At depth RESUME_LAYERS, full width, under
    torch.use_deterministic_algorithms(True): an uninterrupted fit
    (RESUME_BATCHES x 2 epochs) against one cut by sigterm@RESUME_SIGTERM
    (SystemExit(EXIT_PREEMPTED) with the boundary checkpoint written) and
    resumed by the same call: the weights and Adam state bit-equal."""
    import shutil
    import tempfile

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import guardrail, io, metric
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step
    from mxnet_tpu_torch.parallel import resilience

    B = TRAIN_BATCH
    sym = transformer.get_symbol(VOCAB, SEQ, num_layers=RESUME_LAYERS,
                                 num_heads=HEADS, dim=DIM,
                                 ffn_hidden=4 * DIM)
    toks, labels = lm_tokens(RESUME_BATCHES, seed=4)

    def make():
        return make_train_step(sym, optimizer="adam",
                               optimizer_params={"rescale_grad": 1.0 / B},
                               compute_dtype="bfloat16")
    mx.random.seed(1)
    host = {k: v.cpu() for k, v in make().init_state(
        Xavier(), {"data": (B, SEQ), "softmax_label": (B, SEQ)})[0].items()}

    def run(prefix=None):
        return make().fit(io.NDArrayIter(toks, labels, batch_size=B),
                          num_epoch=2, arg_params=host, lr=TRAIN_LR,
                          eval_metric=metric.Perplexity(ignore_label=-1),
                          checkpoint_prefix=prefix, checkpoint_period=10)

    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        t = time.perf_counter()
        ref, _ = run()
        prefix = os.path.join(tmp, "ck")
        resilience.install_fault_injector(
            resilience.FaultInjector("sigterm@%d" % RESUME_SIGTERM))
        code = None
        try:
            run(prefix)
        except SystemExit as e:
            code = e.code
        resilience.install_fault_injector(None)
        if code != guardrail.EXIT_PREEMPTED:
            fail("resume: sigterm@%d ended fit with %r, not SystemExit(%d)"
                 % (RESUME_SIGTERM, code, guardrail.EXIT_PREEMPTED))
        with open(prefix + "_0001.meta.json") as f:
            meta = json.load(f)
        want = {"n_update": RESUME_SIGTERM - 1, "epoch": 1, "nbatch": 0}
        if meta != want:
            fail("resume: boundary checkpoint meta %r, not %r" % (meta,
                                                                   want))
        got, _ = run(prefix)
        torch.cuda.synchronize()
        worst = max(float((got[0][k].float() - ref[0][k].float()).abs()
                          .max()) for k in ref[0])
        same = all(torch.equal(got[0][k], ref[0][k]) for k in ref[0]) and \
            all(torch.equal(a, b) for k in ref[1]
                for a, b in zip(got[1][k], ref[1][k]))
        if not same:
            fail("resume: the resumed fit's state differs from the "
                 "uninterrupted run's (max |dw| %g) under "
                 "use_deterministic_algorithms(True)" % worst)
        say("resume: %d layers, %d x 2 steps: sigterm@%d exited %d at the "
            "boundary checkpoint %r; the resumed fit's weights and Adam "
            "state bit-equal to the uninterrupted run's (deterministic "
            "algorithms on), %.1f s" % (
                RESUME_LAYERS, RESUME_BATCHES, RESUME_SIGTERM, code, meta,
                time.perf_counter() - t))
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Module path (path A) and the compiled step (paths B and C)
# ---------------------------------------------------------------------------

MODULE_BATCHES = 4        # one epoch of 4 distinct seeded batches
MODULE_CHECK_UPDATES = 3  # the updates held to TrainStep's bit for bit
MODULE_PEAK_RTOL = 0.02   # steps 2..4's peak memory within 2% of step 2's
NATIVE_CONV_LIMIT_S = 5.0  # a float32 step without cuDNN over this: batch 32
NATIVE_CONV_SMALL_BATCH = 32
COMPILED_REPLAYS = 10     # path B: replays after the capturing step
ALEX_SEEDS = (0, 0, 1, 2)  # path C: the capturing step, then 3 replays
BN_KERNEL_KEYS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")


def _bn_counters():
    from mxnet_tpu_torch.ops import bn_kernels as bnk
    return (bnk.bn_stats_cuda, bnk.bn_apply_cuda, bnk.bn_bwd_reduce_cuda,
            bnk.bn_bwd_dx_cuda)


def _reset_counts(counters):
    for c in counters:
        c.launches = 0


def _state_equal(a, b):
    """(equal, worst |a - b|) over two (params, opt_state, aux) tuples."""
    import torch
    same, worst = True, 0.0
    for da, db in zip(a, b):
        for k in db:
            xs = da[k] if isinstance(da[k], tuple) else (da[k],)
            ys = db[k] if isinstance(db[k], tuple) else (db[k],)
            for x, y in zip(xs, ys):
                if not torch.equal(x, y):
                    same = False
                    worst = max(worst, float((x.float() - y.float())
                                             .abs().max()))
    return same, worst


def _clone_state(state):
    params, opt_state, aux = state
    return ({k: v.clone() for k, v in params.items()},
            {k: tuple(s.clone() for s in v) for k, v in opt_state.items()},
            {k: v.clone() for k, v in aux.items()})


class _deterministic:
    """torch.use_deterministic_algorithms(True) (with the cuBLAS workspace
    it needs) for the duration of a block."""

    def __enter__(self):
        import torch
        self.cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        import torch
        torch.use_deterministic_algorithms(False)
        if self.cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self.cublas
        return False


def module_phase():
    """Path A: bench.py's ResNet-50 in float32 (the dtype the Module binds
    its Executor in) on the BatchNorm kernels through Module.fit: kvstore
    "local" (None on one device), the default guardrail, eval_metric
    "acc", one epoch over an NDArrayIter of MODULE_BATCHES distinct
    seeded batches, then score on one. SGD momentum 0.9, wd 1e-4 on every
    parameter (TrainStep's rule: the optimizer's wd_mult set to 1), lr
    0.1, rescale 1/128, initial weights from TrainStep.init_state. A
    checked run under torch.use_deterministic_algorithms(True): after
    MODULE_CHECK_UPDATES updates the Module's parameters and moving stats
    equal a float32 TrainStep's bit for bit; a module_checkpoint written
    at the epoch's end loads back bit for bit. A timed run: step ms
    (boundary to boundary of the batch-end callbacks), img/s, the peak
    memory of each step (flat from step 2: a training forward drops the
    previous step's graph), the launches a step of each BatchNorm kernel
    and of the guardrail's reduction, one profiled step's busy share and
    launches. Then the float32 step with cuDNN off (PyTorch's own
    convolutions), beside the cuDNN step at the same batch. Returns the
    timed run's launch counts."""
    import gc
    import shutil
    import tempfile

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import callback, config, io, optimizer as opt
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import optimizer_kernels as mt
    from mxnet_tpu_torch.parallel import make_train_step

    B, S, K = RESNET_BATCH, RESNET_IMAGE, MODULE_BATCHES
    t0 = time.perf_counter()
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, image_shape=(3, S, S))
    n_bn = sum(n["op"] == "BatchNorm"
               for n in json.loads(sym.tojson())["nodes"])
    rng = np.random.RandomState(20)
    X = rng.standard_normal((K * B, 3, S, S)).astype(np.float32)
    Y = rng.randint(0, RESNET_CLASSES, (K * B,)).astype(np.float32)
    optp = {"momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0 / B}
    ref = make_train_step(sym, optimizer="sgd", optimizer_params=optp)
    shapes = {"data": (B, 3, S, S), "softmax_label": (B,)}
    mx.random.seed(0)
    init = ref.init_state(Xavier(factor_type="in", magnitude=2.0), shapes)
    host_args = {k: v.cpu() for k, v in init[0].items()}
    host_aux = {k: v.cpu() for k, v in init[2].items()}
    del init
    names = list(ref.param_names)

    def nd_params():
        with mx.cpu():
            return ({k: mx.nd.array(v) for k, v in host_args.items()},
                    {k: mx.nd.array(v) for k, v in host_aux.items()})

    def make_opt():
        o = opt.create("sgd", learning_rate=RESNET_LR,
                       param_idx2name=dict(enumerate(names)), **optp)
        o.set_wd_mult({n: 1.0 for n in names})
        return o

    def batches():
        return io.NDArrayIter(X, Y, batch_size=B)

    nparam = sum(v.numel() for v in host_args.values())
    say("module: ResNet-%d v2 %d params (%.1f M), %d BatchNorms, %d "
        "batches of %d x 3x%dx%d, float32, MXNET_BN_PALLAS=1, SGD momentum "
        "0.9 wd 1e-4 lr %g rescale 1/%d, kvstore local, guardrail %s, "
        "set up in %.1f s" % (
            RESNET_LAYERS, nparam, nparam / 1e6, n_bn, K, B, S, S,
            RESNET_LR, B, "on" if mx.config.get("MXNET_GUARDRAIL")
            else "OFF", time.perf_counter() - t0))
    if not mx.config.get("MXNET_GUARDRAIL"):
        fail("module: MXNET_GUARDRAIL is off; the phase runs fit's default")

    config.set_override("MXNET_BN_PALLAS", True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_module_")
    try:
        # -- the checked run -------------------------------------------
        snap = {}
        with _deterministic():
            mod = mx.mod.Module(sym, context=mx.gpu(0))

            def check_cb(param):
                if param.nbatch == MODULE_CHECK_UPDATES - 1:
                    exe = mod._exec_group.execs[0]
                    snap["params"] = {n: exe.arg_dict[n]._data.clone()
                                      for n in names}
                    snap["aux"] = {n: a._data.clone()
                                   for n, a in exe.aux_dict.items()}
            prefix = os.path.join(tmp, "resnet")
            args, auxs = nd_params()
            t = time.perf_counter()
            mod.fit(batches(), num_epoch=1, optimizer=make_opt(),
                    eval_metric="acc", kvstore="local", arg_params=args,
                    aux_params=auxs, batch_end_callback=check_cb,
                    epoch_end_callback=callback.module_checkpoint(
                        mod, prefix))
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t
            state = ref.init_state(None, shapes, arg_params=host_args,
                                   aux_params=host_aux)
            for i in range(MODULE_CHECK_UPDATES):
                state, _ = ref(state, {"data": X[i * B:(i + 1) * B],
                                       "softmax_label": Y[i * B:(i + 1) * B]},
                               RESNET_LR, i)
            torch.cuda.synchronize()
        same, worst = _state_equal(
            (snap["params"], snap["aux"]), (state[0], state[2]))
        if not same:
            fail("module: after %d updates the Module's parameters or "
                 "moving stats differ from TrainStep's (max |d| %g)"
                 % (MODULE_CHECK_UPDATES, worst))
        del state, snap
        args_now, aux_now = mod.get_params()
        _, ck_args, ck_aux = mx.model.load_checkpoint(prefix, 1)
        ck_same = sorted(ck_args) == sorted(args_now) and all(
            torch.equal(ck_args[k]._data.cpu(), args_now[k]._data.cpu())
            for k in args_now) and all(
            torch.equal(ck_aux[k]._data.cpu(), aux_now[k]._data.cpu())
            for k in aux_now)
        if not ck_same:
            fail("module: the module_checkpoint %s-0001.params does not "
                 "load back bit for bit" % prefix)
        say("module: checked run (deterministic algorithms, %.1f s): after "
            "%d updates the Module's %d parameters and %d moving stats "
            "bit-equal to a float32 TrainStep's; module_checkpoint "
            "%s-0001.params (%.1f MB) loads back bit for bit" % (
                fit_s, MODULE_CHECK_UPDATES, len(names), len(aux_now),
                os.path.basename(prefix),
                os.path.getsize(prefix + "-0001.params") / 1e6))
        del mod, args_now, aux_now, ck_args, ck_aux
        # the checked Module holds its last step's graph (float32
        # activations); when this is the process's first Module, frames of
        # its bind stay in a cycle with torch's lazy import of its
        # compiler stack (on the first elementwise op on meta tensors), so
        # only the cycle collector frees it
        gc.collect()
        torch.cuda.empty_cache()

        # -- the timed run ---------------------------------------------
        counters = _bn_counters() + mt_counters()
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        marks, peaks = [], []

        def timed_cb(param):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        args, auxs = nd_params()
        it = batches()
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(None, arg_params=args, aux_params=auxs)
        mod.init_optimizer(kvstore="local", optimizer=make_opt())
        torch.cuda.synchronize()
        _reset_counts(counters)
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        marks.append(t)
        mod.fit(it, num_epoch=1, eval_metric="acc", kvstore="local",
                batch_end_callback=timed_cb)
        launches = {c.__name__: c.launches for c in counters}
        gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        step_ms = statistics.median(gaps[1:])
        for c in _bn_counters():
            if launches[c.__name__] != n_bn * K:
                fail("module: %s launched %d times in %d steps, not %d "
                     "BatchNorms a step" % (c.__name__, launches[c.__name__],
                                            K, n_bn))
        want = K * mt_launches(len(names) + 1, reduction=True)
        if launches[mt.multi_tensor_norm_finite_cuda.__name__] != want or \
                launches[mt.multi_tensor_opt_update_cuda.__name__] != 0:
            fail("module: multi-tensor launches %r, want the guardrail's "
                 "reduction %d times and no multi-tensor update (the "
                 "Updater runs the registry op)" % (launches, want))
        if max(peaks[1:]) > (1 + MODULE_PEAK_RTOL) * peaks[1]:
            fail("module: peak memory grows after step 2 (%s GB): a "
                 "previous step's graph is kept" % " ".join(
                     "%.2f" % (p / 1e9) for p in peaks))
        score = mod.score(io.NDArrayIter(X[:B], Y[:B], batch_size=B), "acc")
        acc = score[0][1]
        if not 0.0 <= acc <= 1.0:
            fail("module: score %r" % (score,))
        batch = next(iter(batches()))

        def one_step():
            mod.forward_backward(batch)
            mod.update()
        profile("module step (ResNet-50, float32, BatchNorm kernels)",
                one_step, top=10)
        prof_launches = sum(profile.counts.values())
        busy = profile.busy
        say("module: timed run: step %.2f ms (median of steps 2..%d, "
            "boundary to boundary; all: %s), %.1f img/s, peak device "
            "memory a step %s GB (flat from step 2; %.2f GB allocated "
            "before the run: the module, its data and optimizer state), "
            "busy %.1f%% and %d "
            "launches in a profiled step, each BatchNorm kernel %d "
            "launches a step, the guardrail's reduction %d; score "
            "accuracy %.4f" % (
                step_ms, K, " ".join("%.1f" % g for g in gaps),
                B / step_ms * 1e3, " ".join("%.2f" % (p / 1e9)
                                            for p in peaks), base_gb,
                100 * busy, prof_launches, n_bn,
                mt_launches(len(names) + 1, reduction=True), acc))

        # -- the float32 step with PyTorch's own convolutions -----------
        native_conv_check(mod, X, Y, step_ms)
        del mod, batch
    finally:
        config.set_override("MXNET_BN_PALLAS", None)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say("module: %.2f GB still allocated on the card after the "
        "phase" % (torch.cuda.memory_allocated() / 1e9))
    return launches


def native_conv_check(mod, X, Y, cudnn_ms):
    """ROADMAP Queue C item 8's measurement: path A's float32 step (the
    Module's forward_backward + update) with torch.backends.cudnn.enabled
    False, so PyTorch's own convolutions run, one warm and one timed
    step at batch NATIVE_CONV_SMALL_BATCH (the Module reshapes) beside
    the cuDNN step at that batch; then at the full batch when the small
    one's time scaled to it stays under NATIVE_CONV_LIMIT_S."""
    import torch
    from mxnet_tpu_torch import io

    def timed(b, reps):
        batch = io.DataBatch(data=[X[:b]], label=[Y[:b]])
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return out[-1]

    small = NATIVE_CONV_SMALL_BATCH
    cudnn_small = timed(small, 3)
    torch.backends.cudnn.enabled = False
    try:
        native_small = timed(small, 2)
        native_full = None
        if native_small * RESNET_BATCH / small < NATIVE_CONV_LIMIT_S * 1e3:
            native_full = timed(RESNET_BATCH, 2)
    finally:
        torch.backends.cudnn.enabled = True
    say("module: float32 step without cuDNN (PyTorch's own "
        "convolutions): batch %d %.1f ms against cuDNN's %.1f ms (%.2fx); "
        "batch %d %s against cuDNN's %.2f ms" % (
            small, native_small, cudnn_small, native_small / cudnn_small,
            RESNET_BATCH, "%.1f ms" % native_full if native_full is not None
            else "not timed (batch %d's time scaled past %.0f s)" % (
                small, NATIVE_CONV_LIMIT_S), cudnn_ms))


def compiled_resnet_phase():
    """Path B: bench.py's ResNet-50 step (bf16 compute, the kernel route,
    MXNET_BN_PALLAS=1) through TrainStep.export ->
    CompiledTrainStep.load -> step. A checked run under
    torch.use_deterministic_algorithms(True): the first step warms up and
    captures the CUDA graph, then COMPILED_REPLAYS replays, each with its
    own lr (a cosine over them) and the default seed; the state equals as
    many direct TrainStep steps with the same lrs and keys, bit for bit
    (a frozen lr would show). A timed run from a fresh load: one replay
    profiled (each BatchNorm kernel launched once per BatchNorm, the
    multi-tensor update once; busy share), the replay's ms by events,
    step()'s ms (its batch copied in, its outputs out), the capture time
    and the memory the capture took, beside the direct step's ms and busy
    share in this call. Returns the launch counts of the wrappers (the
    warm-up step and the capture, which records each launch once)."""
    import shutil
    import tempfile

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import make_train_step
    from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep

    B, S = RESNET_BATCH, RESNET_IMAGE
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, image_shape=(3, S, S))
    n_bn = sum(n["op"] == "BatchNorm"
               for n in json.loads(sym.tojson())["nodes"])
    step = make_train_step(sym, optimizer="sgd",
                           optimizer_params={"momentum": 0.9, "wd": 1e-4,
                                             "rescale_grad": 1.0 / B},
                           compute_dtype="bfloat16")
    batch = {"data": np.random.RandomState(0).standard_normal(
        (B, 3, S, S)).astype(np.float32),
        "softmax_label": np.random.RandomState(1).randint(
            0, RESNET_CLASSES, (B,)).astype(np.float32)}
    mx.random.seed(0)
    init = step.init_state(Xavier(factor_type="in", magnitude=2.0),
                           {"data": (B, 3, S, S), "softmax_label": (B,)})
    lrs = [RESNET_LR] + [
        RESNET_LR * (0.55 + 0.45 * np.cos(np.pi * i / COMPILED_REPLAYS))
        for i in range(1, COMPILED_REPLAYS + 1)]
    counters = _bn_counters() + mt_counters()
    config.set_override("MXNET_BN_PALLAS", True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_compiled_")
    try:
        prefix = os.path.join(tmp, "resnet")
        t = time.perf_counter()
        step.export(prefix, init, batch)
        export_s = time.perf_counter() - t

        # -- the checked run -------------------------------------------
        with _deterministic():
            t = time.perf_counter()
            ct = CompiledTrainStep.load(prefix)
            load_s = time.perf_counter() - t
            _reset_counts(counters)
            got = [ct.step(batch, lr) for lr in lrs]
            launches = {c.__name__: c.launches for c in counters}
            state = _clone_state(init)
            want = []
            for i, lr in enumerate(lrs):
                state, outs = step(state, batch, lr, mx.random.PRNGKey(i))
                want.append(outs[0].float().cpu().numpy())
            torch.cuda.synchronize()
        same, worst = _state_equal(ct._unflat(), state)
        outs_same = all(np.array_equal(a[0], b) for a, b in zip(got, want))
        if not same or not outs_same:
            fail("compiled resnet: after the capturing step and %d replays "
                 "with lrs %s the state (max |d| %g) or outputs (%s) differ "
                 "from the direct steps'" % (
                     COMPILED_REPLAYS, ["%.5f" % v for v in lrs], worst,
                     "equal" if outs_same else "differ"))
        for c in _bn_counters():
            if launches[c.__name__] != 2 * n_bn:
                fail("compiled resnet: %s launched %d times in the warm-up "
                     "and the capture, not 2 x %d" % (
                         c.__name__, launches[c.__name__], n_bn))
        nlls = [mean_nll(torch.from_numpy(g[0]),
                         torch.from_numpy(batch["softmax_label"]))
                for g in got]
        say("compiled resnet: checked run (deterministic algorithms): "
            "export %.1f s, load %.1f s; the capturing step and %d replays "
            "with lrs %s equal %d direct TrainStep steps bit for bit (every "
            "parameter, momentum and moving stat, and the outputs); NLL %s"
            % (export_s, load_s, COMPILED_REPLAYS,
               " ".join("%.4f" % v for v in lrs), len(lrs),
               " ".join("%.4f" % v for v in nlls)))
        del ct, state, got, want
        torch.cuda.empty_cache()

        # -- the timed run ---------------------------------------------
        ct = CompiledTrainStep.load(prefix)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        ct.step(batch, RESNET_LR)
        torch.cuda.synchronize()
        # what stays reserved once the warm-up's blocks are released: the
        # graph's private pool and its static inputs
        torch.cuda.empty_cache()
        graph_gb = (torch.cuda.memory_reserved() - mem0) / 1e9
        profile("compiled resnet replay (one CUDA graph)", ct._graph.replay,
                top=8)
        counts = kernel_counts(profile.counts, BN_KERNEL_KEYS +
                               ("mt_update_kernel",))
        replay_busy, replay_launches = profile.busy, \
            sum(profile.counts.values())
        for k in BN_KERNEL_KEYS:
            if counts[k] != n_bn:
                fail("compiled resnet: one replay launched %s %d times, "
                     "not %d" % (k, counts[k], n_bn))
        if counts["mt_update_kernel"] != 1:
            fail("compiled resnet: one replay launched the multi-tensor "
                 "update %d times" % counts["mt_update_kernel"])
        replay_ms = time_ms(ct._graph.replay, reps=10, warmup=2)
        step_times = []
        for _ in range(5):
            t = time.perf_counter()
            ct.step(batch, RESNET_LR)
            step_times.append((time.perf_counter() - t) * 1e3)
        call_ms = statistics.median(step_times)
        capture_ms = ct.capture_ms
        del ct
        torch.cuda.empty_cache()

        state = _clone_state(init)
        placed = step.place_batch(batch)
        direct = []
        for i in range(WARM_STEPS + 5):
            t = time.perf_counter()
            if i == 1:
                state, _ = profile("compiled resnet: the direct step",
                                   lambda: step(state, placed, RESNET_LR,
                                                i), top=4)
            else:
                state, _ = step(state, placed, RESNET_LR, i)
            torch.cuda.synchronize()
            direct.append((time.perf_counter() - t) * 1e3)
        direct_ms = statistics.median(direct[WARM_STEPS:])
        direct_busy = profile.busy
        direct_launches = sum(profile.counts.values())
        say("compiled resnet: timed run: one replay %.2f ms by events "
            "(%.1f img/s), busy %.1f%%, %d launches (each BatchNorm kernel "
            "%d, the multi-tensor update 1); step() %.2f ms with its batch "
            "copied in and its outputs out (all: %s); capture %.1f ms, the "
            "graph's pool and static inputs %.2f GB; the direct step in this call %.2f ms "
            "(all: %s), busy %.1f%%, %d launches: the replay %.2fx faster" % (
                replay_ms, B / replay_ms * 1e3, 100 * replay_busy,
                replay_launches, n_bn, call_ms,
                " ".join("%.1f" % v for v in step_times), capture_ms,
                graph_gb, direct_ms, " ".join("%.1f" % v for v in direct),
                100 * direct_busy, direct_launches, direct_ms / replay_ms))
        del state, placed, init
    finally:
        config.set_override("MXNET_BN_PALLAS", None)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say("compiled resnet: %.2f GB still allocated on the card after the "
        "phase" % (torch.cuda.memory_allocated() / 1e9))
    return launches


def compiled_alexnet_phase():
    """Path C: bench.py's AlexNet (batch 512, two Dropouts, bf16, SGD
    momentum) through TrainStep.export -> CompiledTrainStep, under
    torch.use_deterministic_algorithms(True): the capturing step with
    seed 0, then replays with seeds 0, 1, 2 (ALEX_SEEDS), the key built
    from the seed inside the graph; every step's outputs and the final
    state equal direct steps with PRNGKey(seed) bit for bit, so each
    replay's Dropout masks are the direct step's. Returns the wrappers'
    launch counts (the multi-tensor update: the warm-up and the
    capture)."""
    import shutil
    import tempfile

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import alexnet
    from mxnet_tpu_torch.parallel import make_train_step
    from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep

    B, S = ALEX_BATCH, ALEX_IMAGE
    sym = alexnet.get_symbol(num_classes=ALEX_CLASSES)
    step = make_train_step(sym, optimizer="sgd",
                           optimizer_params={"momentum": 0.9, "wd": 1e-4,
                                             "rescale_grad": 1.0 / B},
                           compute_dtype="bfloat16")
    batch = {"data": np.random.RandomState(0).standard_normal(
        (B, 3, S, S)).astype(np.float32),
        "softmax_label": np.random.RandomState(1).randint(
            0, ALEX_CLASSES, (B,)).astype(np.float32)}
    mx.random.seed(0)
    init = step.init_state(Xavier(factor_type="in", magnitude=2.0),
                           {"data": (B, 3, S, S), "softmax_label": (B,)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_alexnet_")
    try:
        prefix = os.path.join(tmp, "alexnet")
        step.export(prefix, init, batch)
        with _deterministic():
            ct = CompiledTrainStep.load(prefix)
            reset_mt_counts()
            got = [ct.step(batch, ALEX_LR, seed=s) for s in ALEX_SEEDS]
            launches = {c.__name__: c.launches for c in mt_counters()}
            state = _clone_state(init)
            want = []
            for s in ALEX_SEEDS:
                state, outs = step(state, batch, ALEX_LR,
                                   mx.random.PRNGKey(s))
                want.append(outs[0].float().cpu().numpy())
            torch.cuda.synchronize()
        same, worst = _state_equal(ct._unflat(), state)
        outs_same = [np.array_equal(a[0], b) for a, b in zip(got, want)]
        if not same or not all(outs_same):
            fail("compiled alexnet: seeds %s: outputs equal %s, state equal "
                 "%s (max |d| %g) against the direct steps with "
                 "PRNGKey(seed)" % (ALEX_SEEDS, outs_same, same, worst))
        if np.array_equal(got[1][0], got[2][0]):
            fail("compiled alexnet: seeds 0 and 1 gave the same outputs")
        say("compiled alexnet: the capturing step (seed %d) and replays "
            "with seeds %s, the key built from the seed inside the graph: "
            "outputs and state (the Dropout masks with them) bit-equal to "
            "direct steps with PRNGKey(seed) (deterministic algorithms); "
            "capture %.1f ms" % (ALEX_SEEDS[0], list(ALEX_SEEDS[1:]),
                                 ct.capture_ms))
        del ct, state, got, want, init
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say("compiled alexnet: %.2f GB still allocated on the card after the "
        "phase" % (torch.cuda.memory_allocated() / 1e9))
    return launches


# ---------------------------------------------------------------------------
# LM options: the chunked-CE head, RoPE, the hybrid attention/SSM stack
# ---------------------------------------------------------------------------

LMO_WARM, LMO_TIMED = 2, 5
# (label, get_symbol options): bench.py's BENCH_TLM_LOSS_CHUNK=2048,
# pos_encoding="rope", and the hybrid stack with RoPE
HYBRID_BLOCKS = ("attention", "ssm", "attention", "ssm")
LMO_CONFIGS = (
    ("loss_chunk", dict(loss_chunk=2048)),
    ("rope", dict(pos_encoding="rope")),
    ("hybrid", dict(block_type=HYBRID_BLOCKS, pos_encoding="rope")),
)
# filled by the phases: the dense head's peak (train phase) and
# configuration (c)'s trained parameters (lm_options), which the
# generate phase decodes
TRAIN_PEAK_GB = {}
HYBRID_PARAMS = {}


def lm_nll(outs, labels, chunked):
    """Mean NLL of a step's output: the (B*T, V) probabilities, or the
    chunked head's per-token losses (already divided by the valid count,
    so their sum)."""
    if chunked:
        return float(outs[0].float().sum().item())
    return mean_nll(outs[0], labels)


def lm_options_reference_check():
    """Each configuration at small width in float32: one SGD-momentum step
    on the card (f32 flash kernels, the SSM scan's products without TF32)
    against the same step on the CPU, from one seeded Xavier init: every
    parameter within TOL["float32"]."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step

    T, V, B = 64, 100, 2
    rng = np.random.RandomState(9)
    toks = rng.randint(0, V, (B, T)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    for label, kw in LMO_CONFIGS:
        kw = dict(kw)
        if "loss_chunk" in kw:
            kw["loss_chunk"] = 48          # a ragged last chunk
        if "block_type" in kw:
            kw["block_type"] = ("attention", "ssm")
        sym = transformer.get_symbol(V, T, num_layers=2, num_heads=4,
                                     dim=64, **kw)
        after = []
        for ctx in (mx.gpu(0), mx.cpu()):
            step = make_train_step(sym, optimizer="sgd", ctx=ctx,
                                   optimizer_params={"momentum": 0.9})
            mx.random.seed(7)
            state = step.init_state(Xavier(), {"data": (B, T),
                                               "softmax_label": (B, T)})
            state, _ = step(state, {"data": toks, "softmax_label": labels},
                            0.1, 0)
            after.append({n: v for n, v in state[0].items()})
        worst = 0.0
        for n, w in after[0].items():
            worst = max(worst, check_close(
                "lm_options reference %s: %s" % (label, n), w.cpu(),
                after[1][n], TOL["float32"]))
        say("lm_options reference: small f32 %s LM one-step parameters, "
            "card vs CPU max abs err %.3g (atol %g, rtol %g)" % (
                label, worst, TOL["float32"]["atol"],
                TOL["float32"]["rtol"]))


def ssm_scan_memory():
    """One SSM layer's chunked scan at the flagship's training shape
    (batch 8, 16 heads, T 2048, head dim 128, bf16 q/k/v, chunk 64) under
    autograd: the memory its forward keeps for the backward, and its
    forward and forward + backward times by events."""
    import torch
    from mxnet_tpu_torch.ops.ssm import ssm_chunk_scan

    gen = torch.Generator(device="cuda").manual_seed(17)
    shape = (TRAIN_BATCH, HEADS, SEQ, DIM // HEADS)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    g = torch.randn(shape[:3], generator=gen, device="cuda",
                    requires_grad=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out, _ = ssm_chunk_scan(q, k, v, g, chunk=64)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before - out.numel() * 2
    del out
    fwd_ms = time_ms(lambda: ssm_chunk_scan(q, k, v, g, chunk=64), reps=5,
                     warmup=1)

    def fwd_bwd():
        o, _ = ssm_chunk_scan(q, k, v, g, chunk=64)
        torch.autograd.grad(o, (q, k, v, g), torch.ones_like(o))

    both_ms = time_ms(fwd_bwd, reps=5, warmup=1)
    say("lm_options: one SSM layer's scan at %s bf16, chunk 64: %.3f GB "
        "kept for the backward (%d chunks), forward %.2f ms, forward + "
        "backward %.2f ms (events)" % (shape, kept / 1e9, SEQ // 64, fwd_ms,
                                       both_ms))


def lm_options_phase():
    """The flagship LM's training step (bench.py's settings: Adam lr 1e-4,
    rescale 1/8, bf16 compute, Xavier, batch 8 x 2048) through
    make_train_step -> init_state -> step in three configurations: (a)
    the chunked-CE head (loss_chunk=2048), (b) RoPE, (c) the hybrid stack
    (attention, ssm, attention, ssm) with RoPE. Each: 2 warm steps (one
    profiled) and 5 timed; a finite loss whose lowest timed value is under
    the first; flash_fwd_cuda and flash_bwd_cuda once an attention layer a
    step and the multi-tensor update once a step; step ms, tokens/s, peak
    memory, busy share. Before them, each configuration small and f32,
    card against CPU. Keeps (c)'s parameters for the generate phase.
    Returns the launch counts over the three runs."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step

    lm_options_reference_check()
    ssm_scan_memory()
    fwd, bwd = _flash_counters()
    B = TRAIN_BATCH
    steps = LMO_WARM + LMO_TIMED
    rng_np = np.random.RandomState(0)
    toks = rng_np.randint(0, VOCAB, (B, SEQ)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    total = {}
    for label, kw in LMO_CONFIGS:
        t0 = time.perf_counter()
        sym = transformer.get_symbol(VOCAB, SEQ, num_layers=LAYERS,
                                     num_heads=HEADS, dim=DIM,
                                     ffn_hidden=4 * DIM, **kw)
        step = make_train_step(sym, optimizer="adam",
                               optimizer_params={"rescale_grad": 1.0 / B},
                               compute_dtype="bfloat16")
        mx.random.seed(0)
        state = step.init_state(Xavier(), {"data": (B, SEQ),
                                           "softmax_label": (B, SEQ)})
        batch = step.place_batch({"data": toks, "softmax_label": labels})
        n_attn = list(kw.get("block_type", ("attention",) * LAYERS)).count(
            "attention")
        chunked = "loss_chunk" in kw
        say("lm_options %s: %s, %.1f M params, set up in %.1f s" % (
            label, kw, sum(v.numel() for v in state[0].values()) / 1e6,
            time.perf_counter() - t0))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_flash_counts()
        reset_mt_counts()
        nlls, times = [], []
        for i in range(steps):
            t = time.perf_counter()
            if i == 1:
                state, outs = profile("lm_options %s step (warm)" % label,
                                      lambda: step(state, batch, TRAIN_LR,
                                                   i), top=10)
                busy = profile.busy
            else:
                state, outs = step(state, batch, TRAIN_LR, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            nlls.append(lm_nll(outs, batch["softmax_label"], chunked))
            del outs
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_ms = statistics.median(times[LMO_WARM:])
        say("lm_options %s: NLL per step %s" % (
            label, " ".join("%.4f" % x for x in nlls)))
        say("lm_options %s: step %.2f ms (median of %d timed; all: %s), "
            "%.0f tokens/s, peak device memory %.2f GB, busy %.1f%%" % (
                label, step_ms, LMO_TIMED,
                " ".join("%.1f" % x for x in times),
                B * SEQ / step_ms * 1e3, peak_gb, 100 * busy))
        if chunked:
            dense = TRAIN_PEAK_GB.get("dense")
            say("lm_options %s: peak %.2f GB beside the dense head's %s "
                "(train phase)" % (label, peak_gb, "%.2f GB" % dense
                                   if dense is not None else "(not run)"))
        if not all(np.isfinite(nlls)):
            fail("lm_options %s: non-finite loss %r" % (label, nlls))
        if not min(nlls[LMO_WARM:]) < nlls[0]:
            fail("lm_options %s: the lowest timed NLL %g is not under the "
                 "first %g" % (label, min(nlls[LMO_WARM:]), nlls[0]))
        launches = {"flash_fwd_cuda": fwd.launches,
                    "flash_bwd_cuda": bwd.launches}
        for name, n in launches.items():
            if n != n_attn * steps:
                fail("lm_options %s: %s launched %d times, not %d attention "
                     "layers x %d steps" % (label, name, n, n_attn, steps))
        launches.update(check_mt_counts("lm_options %s" % label, steps,
                                        len(state[0])))
        say("lm_options %s: launches %s" % (label, ", ".join(
            "%s %d" % kv for kv in sorted(launches.items()))))
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        if label == "hybrid":
            HYBRID_PARAMS.update(state[0])
        del state, batch, step
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# generation: bench.py bench_decode's workload
# ---------------------------------------------------------------------------

GEN_MAX_LEN, GEN_PROMPT, GEN_NEW = 384, 128, 256   # bench.py bench_decode
GEN_SHORT = GEN_NEW // 8          # bench.py's N_SHORT: the difference run
GEN_ITERS = 3
GEN_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1)
GEN_VARIANT_NEW = 64              # beam and speculative, timed briefly
GEN_BEAM = 4
SPEC_LOOKAHEAD = 4


def decode_speed(label, gen, prompt):
    """bench.py's marginal decode rate: generate_on_device at GEN_NEW and
    at GEN_SHORT tokens (each captured before the timing), GEN_ITERS runs
    each; ms a step = the difference over the tokens between them.
    Returns (ms a step, tokens/s, ms of the long run)."""
    B = gen.batch_size
    gen.generate_on_device(prompt, GEN_NEW, seed=0)
    gen.generate_on_device(prompt, GEN_SHORT, seed=0)

    def timed(n):
        t = time.perf_counter()
        for i in range(GEN_ITERS):
            gen.generate_on_device(prompt, n, seed=i)  # ends in a host read
        return (time.perf_counter() - t) / GEN_ITERS

    dt_long = timed(GEN_NEW)
    dt_short = timed(GEN_SHORT)
    dt = max(dt_long - dt_short, 1e-9)
    ms_tok = dt / (GEN_NEW - GEN_SHORT) * 1e3
    tok_s = B * (GEN_NEW - GEN_SHORT) / dt
    bound, nbytes = decode_bound(gen)
    say("generate %s: %.4f ms a step (%.0f tokens/s; bound %.4f ms, %.1f MB "
        "a step: %.2fx), %.1f ms for %d tokens end to end" % (
            label, ms_tok, tok_s, bound, nbytes / 1e6, ms_tok / bound,
            dt_long * 1e3, GEN_NEW))
    return ms_tok, tok_s, dt_long * 1e3


def check_tokens_equal(what, got, want):
    if got.shape != want.shape or not (got == want).all():
        rows = (got != want).any(axis=1) if got.shape == want.shape else None
        fail("%s: tokens differ (shapes %r / %r; rows differing %s)" % (
            what, got.shape, want.shape,
            None if rows is None else np.nonzero(rows)[0].tolist()))


def ssm_state_bit_check():
    """On the card, at the decode path's shape (batch 8, 16 heads, head
    dim 128, bf16 q/k/v, a float32 state): a width-1 ssm_chunk_scan's
    output and exit state equal ssm_recurrent_step's bit for bit, one
    token and a chain of 5."""
    import torch
    from mxnet_tpu_torch.ops.ssm import ssm_chunk_scan, ssm_recurrent_step

    gen = torch.Generator(device="cuda").manual_seed(13)
    shape = (TRAIN_BATCH, HEADS, 5, DIM // HEADS)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    g = torch.randn(shape[:3], generator=gen, device="cuda")
    s0 = torch.randn(shape[:2] + (shape[3], shape[3]), generator=gen,
                     device="cuda")
    out_c, st_c = ssm_chunk_scan(q, k, v, g, state=s0, chunk=1)
    st_r, outs = s0, []
    for t in range(shape[2]):
        o, st_r = ssm_recurrent_step(q[:, :, t:t + 1], k[:, :, t:t + 1],
                                     v[:, :, t:t + 1], g[:, :, t:t + 1],
                                     st_r)
        outs.append(o)
    out_r = torch.cat(outs, dim=2)
    if not (torch.equal(out_c, out_r) and torch.equal(st_c, st_r)):
        fail("generate: a width-1 ssm_chunk_scan differs from the recurrent "
             "step on the card (out %g, state %g)" % (
                 float((out_c.float() - out_r.float()).abs().max()),
                 float((st_c - st_r).abs().max())))
    say("generate: width-1 ssm_chunk_scan == ssm_recurrent_step bit for bit "
        "on the card (B %d, H %d, hd %d, 5 tokens: outputs and states)"
        % (shape[0], shape[1], shape[3]))


def generate_reference_check():
    """A small f32 hybrid (attention, ssm) RoPE LM, card against CPU:
    greedy generate's tokens equal, and the prefill logits within
    TOL["float32"]."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.generation import Generator
    from mxnet_tpu_torch.models import transformer

    V, T, B = 100, 48, 2
    kw = dict(num_layers=2, num_heads=4, dim=64,
              block_type=("attention", "ssm"), pos_encoding="rope")
    sym = transformer.get_symbol(V, T, **kw)
    params = random_params(sym, (B, T), seed=11)
    for name in params:            # large enough to make the logits differ
        if name.endswith("_weight"):
            params[name] *= 10.0
    prompt = np.random.RandomState(12).randint(0, V, (B, 8))
    toks, logits = [], []
    for ctx in (mx.gpu(0), mx.cpu()):
        gen = Generator(params, V, T, batch_size=B, ctx=ctx, **kw)
        toks.append(gen.generate(prompt, 24))
        logits.append(gen._forward(gen._fresh_aux(), prompt, 0)[0].cpu())
    check_tokens_equal("generate reference: small f32 hybrid RoPE LM, card "
                       "vs CPU greedy", toks[0], toks[1])
    err = check_close("generate reference: prefill logits card vs CPU",
                      logits[0], logits[1], TOL["float32"])
    say("generate reference: small f32 hybrid RoPE LM, card vs CPU: 24 "
        "greedy tokens equal, prefill logits max abs err %.3g" % err)


def generate_phase():
    """bench.py bench_decode's workload at full width: the flagship LM
    (learned positions, max_len 384), batch 8, prompt 128 from
    RandomState(0), 256 new tokens, bf16, parameters from init_state
    (Xavier()). Greedy and seeded-sampled generate_on_device (the decode
    step captured as one CUDA graph) equal generate (eager, a host read a
    token); ms a step by bench.py's difference of runs, tokens/s, prefill
    ms, KV bytes, peak memory, beside the decode bound; one replay and one
    eager step profiled and timed by events; the last decode step's
    logits against a full prefill (teacher forcing); int8 weights, int8
    caches, beam search on the device (equal to the host loop) and
    speculative decoding on the device with bench.py's draft (equal to
    generate, greedy and seeded), each timed briefly. Then configuration
    (c)'s trained hybrid decoded greedily (device loop equal to the host
    loop), the SSM state bit check and a small f32 hybrid card vs CPU.
    No hand-written kernel runs on this path: returns {}."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.generation import Generator
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step

    if not HYBRID_PARAMS:
        fail("generate: run after lm_options (it decodes configuration "
             "(c)'s trained parameters)")
    generate_reference_check()
    ssm_state_bit_check()

    B, P, N, ML = TRAIN_BATCH, GEN_PROMPT, GEN_NEW, GEN_MAX_LEN
    t0 = time.perf_counter()
    arch = dict(num_layers=LAYERS, num_heads=HEADS, dim=DIM,
                ffn_hidden=4 * DIM)
    sym = transformer.get_symbol(VOCAB, ML, **arch)
    mx.random.seed(0)
    state = make_train_step(sym, optimizer="sgd").init_state(
        Xavier(), {"data": (B, ML), "softmax_label": (B, ML)})
    params = state[0]
    del state
    gen = Generator(params, VOCAB, ML, batch_size=B, dtype="bfloat16", **arch)
    prompt = np.random.RandomState(0).randint(0, VOCAB, (B, P))
    say("generate: flagship LM %.1f M params, bf16, max_len %d, batch %d, "
        "prompt %d, %d new tokens; KV caches %.1f MB; set up in %.1f s" % (
            sum(t.numel() for t in params.values()) / 1e6, ML, B, P, N,
            gen.kv_cache_bytes() / 1e6, time.perf_counter() - t0))

    # -- equality: the captured loop against the eager one ---------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eager = gen.generate(prompt, N)
    eager_s = time.perf_counter() - t
    t = time.perf_counter()
    dev = gen.generate_on_device(prompt, N)
    first_s = time.perf_counter() - t
    check_tokens_equal("generate: greedy generate_on_device vs generate",
                       dev, eager)
    loop = gen._loop_cache[(P, N, 0.0, 0, 0.0, None)]
    # teacher forcing: the last decode step's logits (loop.last, from the
    # forward of token P + N - 2) against a prefill of the same sequence
    # (bf16 rounds every layer's activations, at its own points in each:
    # held within TOL["bfloat16"] of the logits' largest magnitude)
    full, _ = gen._forward(gen._fresh_aux(), dev[:, :P + N - 1], 0)
    want = full[:, -1].float()
    tf_err = float((loop.last - want).abs().max())
    tf_scale = float(want.abs().max())
    tol = TOL["bfloat16"]
    if not np.isfinite(tf_err) or tf_err > tol["atol"] + tol["rtol"] * \
            tf_scale:
        fail("generate: last decode step vs prefill logits: max abs err %g "
             "beyond atol %g + rtol %g x max|logit| %g" % (
                 tf_err, tol["atol"], tol["rtol"], tf_scale))
    del full, want
    nv = GEN_VARIANT_NEW
    sampled = gen.generate(prompt, nv, **GEN_SAMPLED)
    check_tokens_equal("generate: sampled generate_on_device vs generate",
                       gen.generate_on_device(prompt, nv, **GEN_SAMPLED),
                       sampled)
    say("generate: greedy (%d tokens a row) and sampled (%s, %d) "
        "generate_on_device == generate; eager loop %.2f s, first device "
        "run (capture "
        "%s ms) %.2f s; teacher forcing: last step vs prefill logits max "
        "abs err %.3g, max|logit| %.3g (atol %g + rtol %g x max|logit|)" % (
            N, GEN_SAMPLED, nv, eager_s, loop.capture_ms, first_s, tf_err,
            tf_scale, tol["atol"], tol["rtol"]))

    # -- speed --------------------------------------------------------------
    ms_tok, tok_s, long_ms = decode_speed("bf16", gen, prompt)
    prefill_ms = time_ms(lambda: gen._forward(gen._fresh_aux(), prompt, 0),
                         reps=5, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # (the profiled call's wall holds the profiler's own time; the busy
    # share is the kernels' time over the step's time by events)
    loop.i.fill_(0)
    profile("decode step, one replay of the captured graph",
            loop.graph.replay, top=8)
    replay_kern, replay_n = profile.busy_ms, sum(profile.counts.values())
    loop.i.fill_(0)
    replay_ms = time_ms(loop.graph.replay, reps=20, warmup=3)
    loop.i.fill_(0)
    profile("decode step, eager", loop._step, top=8)
    eager_kern, eager_n = profile.busy_ms, sum(profile.counts.values())
    loop.i.fill_(0)
    eager_ms = time_ms(loop._step, reps=20, warmup=3)
    bound, _ = decode_bound(gen)
    say("generate bf16: prefill %.2f ms (%d tokens x %d rows), KV caches %d "
        "bytes, peak %.2f GB; a step by events: replay %.4f ms (%.4f ms of "
        "kernels: busy %.1f%%, %d launches), eager %.4f ms (%.4f ms of "
        "kernels: busy %.1f%%, %d launches): %.2fx; bound %.4f ms" % (
            prefill_ms, P, B, gen.kv_cache_bytes(), peak_gb, replay_ms,
            replay_kern, 100 * replay_kern / replay_ms, replay_n, eager_ms,
            eager_kern, 100 * eager_kern / eager_ms, eager_n,
            eager_ms / replay_ms, bound))

    # -- variants -----------------------------------------------------------
    for label, kw in (("int8", dict(quantize="int8")),
                      ("kv8", dict(quantize_kv=True))):
        t = time.perf_counter()
        var = Generator(params, VOCAB, ML, batch_size=B, dtype="bfloat16",
                        **arch, **kw)
        check_tokens_equal(
            "generate %s: greedy generate_on_device vs generate" % label,
            var.generate_on_device(prompt, GEN_SHORT),
            var.generate(prompt, GEN_SHORT))
        say("generate %s: built in %.1f s; %d greedy tokens equal on both "
            "loops; KV caches %d bytes" % (label, time.perf_counter() - t,
                                           GEN_SHORT, var.kv_cache_bytes()))
        decode_speed(label, var, prompt)
        del var
        torch.cuda.empty_cache()

    host = gen.beam_search(prompt, nv, beam_size=GEN_BEAM)
    beam = gen.beam_search_on_device(prompt, nv, beam_size=GEN_BEAM)
    # (the first device run captured the beam step)
    check_tokens_equal("generate beam: beam_search_on_device vs beam_search",
                       beam, host)
    t = time.perf_counter()
    gen.beam_search_on_device(prompt, nv, beam_size=GEN_BEAM)
    beam_ms = (time.perf_counter() - t) * 1e3
    say("generate beam %d: on-device == host loop, %d tokens; %.1f ms a "
        "run (%.3f ms a token)" % (GEN_BEAM, nv, beam_ms, beam_ms / nv))

    # bench.py's draft: a quarter of the layers, half the width, its own
    # Xavier init
    dL, dD, dH = max(1, LAYERS // 4), DIM // 2, max(1, HEADS // 2)
    dsym = transformer.get_symbol(VOCAB, ML, num_layers=dL, num_heads=dH,
                                  dim=dD, ffn_hidden=4 * dD)
    mx.random.seed(1)
    dparams = make_train_step(dsym, optimizer="sgd").init_state(
        Xavier(), {"data": (B, ML), "softmax_label": (B, ML)})[0]
    # the greedy run timed in bf16; the token-for-token checks in float32
    # (the same weights, no cast): the verify forward scores g + 1 tokens
    # in one pass and a one-token step scores one, so their bf16 roundings
    # differ and can flip a pick at a bf16 near-tie (the JAX package's
    # docstring states the same caveat); float32 leaves no such tie in
    # reach. The bf16 rows that agree are reported.
    for dt, cases in (("bfloat16", (("greedy", {}, nv),)),
                      (None, (("greedy", {}, nv),
                              ("sampled", GEN_SAMPLED, GEN_SHORT)))):
        target = gen if dt else Generator(params, VOCAB, ML, batch_size=B,
                                          **arch)
        draft = Generator(dparams, VOCAB, ML, num_layers=dL, num_heads=dH,
                          dim=dD, ffn_hidden=4 * dD, batch_size=B, dtype=dt)
        for what, kw, n_spec in cases:
            want = target.generate(prompt, n_spec, **kw)
            got, rounds = target.generate_speculative_on_device(
                draft, prompt, n_spec, lookahead=SPEC_LOOKAHEAD,
                return_rounds=True, **kw)       # captures the round
            t = time.perf_counter()
            target.generate_speculative_on_device(
                draft, prompt, n_spec, lookahead=SPEC_LOOKAHEAD, **kw)
            spec_ms = (time.perf_counter() - t) * 1e3
            agree = int((got == want).all(axis=1).sum())
            if dt is None:
                check_tokens_equal("generate speculative %s float32: "
                                   "on-device vs generate" % what, got, want)
            say("generate speculative %s %s (lookahead %d): %d of %d rows "
                "equal to generate%s, %d tokens in %d rounds (%.2f accepted "
                "a round); %.1f ms a run (%.3f ms a token)" % (
                    dt or "float32", what, SPEC_LOOKAHEAD, agree, B,
                    " (checked)" if dt is None else "", n_spec, rounds,
                    n_spec / rounds - 1, spec_ms, spec_ms / n_spec))
        del target, draft
    del dparams, gen, params, loop
    torch.cuda.empty_cache()

    # -- configuration (c)'s trained hybrid ----------------------------------
    hyb = Generator(dict(HYBRID_PARAMS), VOCAB, ML, batch_size=B,
                    dtype="bfloat16", block_type=HYBRID_BLOCKS,
                    pos_encoding="rope", **arch)
    check_tokens_equal("generate hybrid: greedy generate_on_device vs "
                       "generate", hyb.generate_on_device(prompt, nv),
                       hyb.generate(prompt, nv))
    say("generate hybrid: configuration (c)'s trained weights (attention, "
        "ssm, attention, ssm; RoPE), %d greedy tokens equal on both loops; "
        "decode state %d bytes" % (nv, hyb.kv_cache_bytes()))
    decode_speed("hybrid", hyb, prompt)
    del hyb
    HYBRID_PARAMS.clear()
    torch.cuda.empty_cache()
    return {}


# ---------------------------------------------------------------------------
# the serving stack: the continuous decoder, the fleet, compiled buckets
# ---------------------------------------------------------------------------

SD_REQUESTS = 24                  # serve_decode's checked requests
SD_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SD_CHUNK = 64                     # MXNET_PREFILL_CHUNK for the checked run
SD_SPEC = (0, 1, 3, 4)            # speculative requests (2 greedy, 2 seeded)
SD_TIMED = 64                     # the timed closed loop's requests
FLIP_RTOL = 1e-5                  # an accepted flip's top-two logit gap
FLEET_REQUESTS, FLEET_CLIENTS = 32, 8
FLEET_EVACUATE_AFTER = 12         # completed requests before the recycle

_DECODE_PARAMS = {}


def decode_params():
    """bench_decode's flagship LM parameters (learned positions, max_len
    384, init_state(Xavier()) after mx.random.seed(0)), float32 on the
    card, built once for serve_decode and serve_fleet."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step

    if not _DECODE_PARAMS:
        B, ML = TRAIN_BATCH, GEN_MAX_LEN
        sym = transformer.get_symbol(VOCAB, ML, **decode_arch())
        mx.random.seed(0)
        _DECODE_PARAMS.update(make_train_step(sym, optimizer="sgd")
                              .init_state(Xavier(), {
                                  "data": (B, ML),
                                  "softmax_label": (B, ML)})[0])
    return _DECODE_PARAMS


def decode_arch():
    return dict(num_layers=LAYERS, num_heads=HEADS, dim=DIM,
                ffn_hidden=4 * DIM)


def decode_gen(batch_size, dtype=None):
    from mxnet_tpu_torch.generation import Generator
    return Generator(decode_params(), VOCAB, GEN_MAX_LEN,
                     batch_size=batch_size, dtype=dtype, **decode_arch())


def oracle_rows(what, reqs, rows, dtype=None, check=True):
    """Each served row against ``Generator.generate`` of its request alone
    (batch 1, the same seed). A row that differs is rerun at the pool's
    batch (the prompt in all 8 rows, row 0: the products see the same M,
    and threefry's partitionable draws give row 0 the batch-1 noise). A
    row that still differs is accepted only where the oracle's top two
    float32 logits at the first differing position lie within FLIP_RTOL x
    max|logit|, and in at most one row; anything else fails when
    ``check``. Returns (rows equal to the batch-1 oracle, notes)."""
    g1, g8 = decode_gen(1, dtype), None
    equal, notes, flips = 0, [], []
    for i, ((p, n, kw), row) in enumerate(zip(reqs, rows)):
        want = g1.generate(p[None], n, **kw)[0]
        if np.array_equal(row, want):
            equal += 1
            continue
        if not check:
            continue
        g8 = g8 or decode_gen(TRAIN_BATCH, dtype)
        want8 = g8.generate(np.repeat(p[None], TRAIN_BATCH, 0), n, **kw)[0]
        if np.array_equal(row, want8):
            notes.append("request %d equals the pool-batch oracle" % i)
            continue
        j = int(np.nonzero(row != want)[0][0]) if row.shape == want.shape \
            else len(p)
        lg = g1._forward(g1._fresh_aux(), want[None, :j], 0)[0][0, -1]
        top = torch_topk2(lg)
        scale = float(lg.float().abs().max())
        rel = (top[0] - top[1]) / scale
        flips.append((i, j - len(p), rel))
        say("%s: request %d differs from generate at token %d: the "
            "oracle's top two logits %.9g, %.9g (gap %.3g of max|logit| "
            "%.6g)" % (what, i, j - len(p), top[0], top[1], rel, scale))
        if rel >= FLIP_RTOL:
            fail("%s: request %d differs from generate at token %d, the "
                 "oracle's top-two gap %.3g x max|logit| >= %g"
                 % (what, i, j - len(p), rel, FLIP_RTOL))
    if len(flips) > 1:
        fail("%s: %d rows flipped at near-ties %s (at most one accepted)"
             % (what, len(flips), flips))
    notes += ["request %d: an accepted near-tie flip at token %d (gap %.3g "
              "x max|logit|)" % f for f in flips]
    return equal, notes


def torch_topk2(logits):
    import torch
    v = torch.topk(logits.float(), 2).values.cpu().numpy()
    return float(v[0]), float(v[1])


def serve_decode_phase():
    """bench_decode's workload through ContinuousDecoder at full width:
    the flagship LM (vocab 32768, dim 2048, 4 layers, 16 heads, learned
    positions, max_len 384, 8 slots). (1) Correctness in float32: 24
    requests (prompts 16-128, max_new 8-200 from RandomState(0)), a third
    greedy, a third seeded (temperature 0.8, top_k 50, top_p 0.95), a
    third streamed (handle_generate_stream), 4 of them speculative
    (truncated_draft(num_layers=1), lookahead 4), MXNET_PREFILL_CHUNK=64:
    every row equals generate of its prompt alone (oracle_rows), each
    stream's frames equal its row, one captured step graph (and one draft
    step graph) after all the turnover. (2) The same requests in bf16:
    the rows that agree with bf16 generate, reported. (3) Timing in bf16:
    64 greedy requests (prompt 128, max_new 32-256 from RandomState(0))
    submitted at once: tokens/s, ms a step by events (one replay of the
    captured step) and by the host clock (the decode loop's whole step,
    the logits' read and the picks included), the busy share of 16
    profiled live steps, TTFT and inter-token p50/p99 from the decoder's
    histograms, slot fill; beside generate_on_device's rate for the same
    model in this call. No hand-written kernel runs here: returns {}."""
    import torch
    from mxnet_tpu_torch import config, telemetry
    from mxnet_tpu_torch.serve import ContinuousDecoder

    B = TRAIN_BATCH
    t0 = time.perf_counter()
    decode_params()
    rs = np.random.RandomState(0)
    lens = rs.randint(16, 129, SD_REQUESTS)
    news = rs.randint(8, 201, SD_REQUESTS)
    reqs, kinds = [], []
    for i, (p, n) in enumerate(zip(lens, news)):
        kind = ("greedy", "seeded", "streamed")[i % 3]
        seeded = kind == "seeded" or (kind == "streamed" and (i // 3) % 2)
        kw = dict(SD_SAMPLED, seed=100 + i) if seeded else {}
        reqs.append((rs.randint(0, VOCAB, (int(p),)), int(n), kw))
        kinds.append(kind)
    n_long = int((lens > SD_CHUNK).sum())
    if n_long < 2:
        fail("serve_decode: %d prompts past the chunk width" % n_long)
    say("serve_decode: %d requests (%s), prompts %d-%d (%d past the "
        "%d-token prefill chunk), max_new %d-%d, %d speculative; set up "
        "in %.1f s" % (SD_REQUESTS, ", ".join(
            "%d %s" % (kinds.count(k), k) for k in ("greedy", "seeded",
                                                    "streamed")),
            lens.min(), lens.max(), n_long, SD_CHUNK, news.min(),
            news.max(), len(SD_SPEC), time.perf_counter() - t0))

    def run(dtype):
        gen = decode_gen(B, dtype)
        config.set_override("MXNET_PREFILL_CHUNK", SD_CHUNK)
        dec = ContinuousDecoder(gen, draft=gen.truncated_draft(num_layers=1),
                                lookahead=SPEC_LOOKAHEAD, queue_cap=64)
        rows = [None] * len(reqs)
        frames = {}
        try:
            t = time.perf_counter()
            futs, threads = {}, []
            for i, (p, n, kw) in enumerate(reqs):
                spec = i in SD_SPEC
                if kinds[i] == "streamed":
                    frames[i] = []

                    def stream(i=i, p=p, n=n, kw=kw, spec=spec):
                        rows[i] = dec.handle_generate_stream(
                            dict(prompt=p, max_new_tokens=n,
                                 speculative=spec, **kw),
                            lambda toks, off, i=i: frames[i].append(
                                (off, list(toks))))
                    th = threading.Thread(target=stream)
                    th.start()
                    threads.append(th)
                else:
                    futs[i] = dec.submit(p, n, speculative=spec, **kw)
            for i, f in futs.items():
                rows[i] = f.result(600)
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t
            st = dec.stats()
            graphs = (dec._row.programs, dec._drow.programs,
                      telemetry.gauge("serve.decode.jit_cache_size").value)
        finally:
            dec.close()
            config.clear_override("MXNET_PREFILL_CHUNK")
        if any(r is None for r in rows):
            fail("serve_decode %s: a request got no response" % dtype)
        for i, fr in frames.items():
            toks = [t for _, chunk in fr for t in chunk]
            offs = [o for o, _ in fr]
            want_offs = list(np.cumsum([0] + [len(c) for _, c in fr])[:-1])
            if toks != rows[i][len(reqs[i][0]):].tolist() or \
                    offs != want_offs:
                fail("serve_decode %s: request %d's stream frames differ "
                     "from its row" % (dtype, i))
        if graphs != (1, 1, 1.0):
            fail("serve_decode %s: step graphs (target, draft, gauge) %r, "
                 "not one each after the turnover" % (dtype, graphs))
        return rows, st, wall, gen

    rows, st, wall, gen = run(None)
    equal, notes = oracle_rows("serve_decode float32", reqs, rows)
    say("serve_decode float32: %d requests in %.2f s, %d steps (%d spec "
        "rounds, %d of %d proposals accepted), %d prefills, %d prefill "
        "chunks' worth of long prompts, %d finished; %d of %d rows equal "
        "to the batch-1 oracle%s; stream frames equal their rows; one "
        "captured step graph and one draft graph after the turnover" % (
            len(reqs), wall, st["steps"], st["spec_rounds"],
            st["spec_accepted"], st["spec_proposed"], st["prefills"],
            n_long, st["finished"], equal, len(reqs),
            "" if not notes else " (" + "; ".join(notes) + ")"))
    del gen
    rows16, st16, wall16, gen16 = run("bfloat16")
    agree, _ = oracle_rows("serve_decode bf16", reqs, rows16,
                           dtype="bfloat16", check=False)
    say("serve_decode bf16: the same requests in %.2f s; %d of %d rows "
        "equal to bf16 generate of the request alone (ROADMAP Queue C "
        "item 9: bf16 near-ties)" % (wall16, agree, len(reqs)))
    del gen16
    torch.cuda.empty_cache()

    # -- timing, bf16 ------------------------------------------------------
    rs = np.random.RandomState(0)
    treqs = [(rs.randint(0, VOCAB, (GEN_PROMPT,)), int(rs.randint(32, 257)))
             for _ in range(SD_TIMED)]
    reg = telemetry.registry()
    for name in ("serve.ttft_ms", "serve.inter_token_ms",
                 "serve.decode.slot_fill"):
        reg._metrics.pop(name, None)       # fresh histograms for this run
    gen = decode_gen(B, "bfloat16")
    dec = ContinuousDecoder(gen, queue_cap=SD_TIMED)
    host_ms, profiling = [], [False]
    step = dec._step

    def timed_step():
        t = time.perf_counter()
        step()
        if not profiling[0]:
            host_ms.append((time.perf_counter() - t) * 1e3)

    dec._step = timed_step
    left = [SD_TIMED - B]
    try:
        t = time.perf_counter()
        futs = [dec.submit(p, n) for p, n in treqs]
        for f in futs:
            f.result(900)
            left[0] -= 1
            if left[0] == SD_TIMED // 2:
                profiling[0] = True
                s0 = dec._steps

                def window():
                    while dec._steps < s0 + 16:
                        time.sleep(0.0002)
                profile("serve_decode: 16 live decode steps (8 slots, the "
                        "queue non-empty)", window, top=6)
                profiling[0] = False
                busy = profile.busy
        wall = time.perf_counter() - t
        st = dec.stats()
        row = dec._row
        replay_ms = time_ms(row.graph.replay, reps=20, warmup=3)
        capture_ms = row.capture_ms
    finally:
        dec.close()
    toks = sum(n for _, n in treqs)
    ttft = telemetry.histogram("serve.ttft_ms")
    itl = telemetry.histogram("serve.inter_token_ms")
    fill = telemetry.histogram("serve.decode.slot_fill")
    say("serve_decode bf16 timed: %d requests (prompt %d, max_new 32-256), "
        "%d tokens in %.3f s: %.1f tokens/s; %d steps; a step %.4f ms by "
        "events (one replay of the captured step; capture %.1f ms), %.4f ms "
        "by the host clock (median; mean %.4f, p99 %.4f: the replay, the "
        "logits' read and the picks); busy %.1f%% over 16 profiled steps; "
        "TTFT p50 %.2f ms p99 %.2f ms; inter-token p50 %.3f ms p99 %.3f "
        "ms; slot fill %.2f of %d" % (
            SD_TIMED, GEN_PROMPT, toks, wall, toks / wall, st["steps"],
            replay_ms, capture_ms, statistics.median(host_ms),
            statistics.mean(host_ms), float(np.percentile(host_ms, 99)),
            100 * busy, ttft.quantile(0.5), ttft.quantile(0.99),
            itl.quantile(0.5), itl.quantile(0.99), fill.sum / fill.count,
            B))
    prompt = np.stack([p for p, _ in treqs[:B]])
    decode_speed("serve_decode baseline (generate_on_device, the same "
                 "bf16 model)", gen, prompt)
    del gen, dec, row
    torch.cuda.empty_cache()
    return {}


def serve_fleet_phase():
    """The fleet in float32 on 127.0.0.1: a ServeRouter over two
    ServeServer(ContinuousDecoder) replicas (each with a truncated draft,
    lookahead 4) and one ServeServer(PrefillEngine), all in this process,
    each over its own Generator of the same weights. 8 ServeClient threads
    send 32 requests through a ServeServer fronting the router: greedy,
    seeded, streamed and speculative, every one disaggregated (prefill
    replica -> KV blob -> decode replica). After 12 responses one decode
    replica is recycled (its sessions evacuate and resume on the other,
    and the router readmits it). Every request resolves to exactly one
    response equal to the in-process generate oracle, the decode replicas'
    prefills stat stays 0, and the run reports requests/s, tokens/s, the
    handoff's blob bytes and ms and the evacuation's ms. Returns {}."""
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import (ContinuousDecoder, PrefillEngine,
                                       ServeClient, ServeRouter, ServeServer)

    B = TRAIN_BATCH
    reg = telemetry.registry()
    for name in ("serve.prefill.blob_bytes", "serve.prefill.ms",
                 "serve.decode.import_ms"):
        reg._metrics.pop(name, None)
    decs = []
    for _ in range(2):
        g = decode_gen(B)
        decs.append(ContinuousDecoder(g, draft=g.truncated_draft(1),
                                      lookahead=SPEC_LOOKAHEAD))
    pre = PrefillEngine(decode_gen(1))
    # each pool captures its step graphs before the fleet's traffic
    for d in decs:
        d.submit(np.arange(1, 9), 2).result(120)
        d.submit(np.arange(1, 9), 2, speculative=True).result(120)
    prefills0 = [d.stats()["prefills"] for d in decs]
    servers = [ServeServer(d) for d in decs] + [ServeServer(pre)]
    router = ServeRouter()
    for name, s in zip(("d0", "d1", "p0"), servers):
        router.add_replica(s.host, s.port, name=name)
    router.poll_now()
    front = ServeServer(router)

    rs = np.random.RandomState(1)
    reqs = []
    for i in range(FLEET_REQUESTS):
        p = rs.randint(0, VOCAB, (int(rs.randint(16, 129)),))
        n = int(rs.randint(8, 121))
        kind = ("greedy", "seeded", "streamed", "speculative")[i % 4]
        kw = dict(SD_SAMPLED, seed=200 + i) if i % 8 in (1, 6, 7) else {}
        reqs.append((p, n, kw, kind))
    results = [None] * len(reqs)
    streamed = {}
    errors = []
    finished = threading.Condition()
    n_done = [0]

    def client(c):
        cli = ServeClient(front.host, front.port)
        try:
            for i in range(c, len(reqs), FLEET_CLIENTS):
                p, n, kw, kind = reqs[i]
                extra = {}
                if kind == "streamed":
                    streamed[i] = []
                    extra["on_token"] = streamed[i].append
                if kind == "speculative":
                    extra["speculative"] = True
                try:
                    results[i] = cli.generate(p, n, **kw, **extra)
                except Exception as exc:     # noqa: BLE001 — reported
                    errors.append((i, exc))
                with finished:
                    n_done[0] += 1
                    finished.notify_all()
        finally:
            cli.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(FLEET_CLIENTS)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    with finished:
        finished.wait_for(lambda: n_done[0] >= FLEET_EVACUATE_AFTER, 600)
    active = decs[0].stats()["active"]
    te = time.perf_counter()
    router.recycle("d0")
    evac_ms = (time.perf_counter() - te) * 1e3
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - t
    stats = [d.stats() for d in decs]
    front.close()
    router.close()
    for s in servers:
        s.close()
    for d in decs:
        d.close()
    pre.close()
    if errors or any(r is None for r in results):
        fail("serve_fleet: requests without one response: %r"
             % (errors or [i for i, r in enumerate(results) if r is None]))
    for i, toks in streamed.items():
        if toks != results[i][len(reqs[i][0]):].tolist():
            fail("serve_fleet: request %d's streamed tokens differ from its "
                 "row" % i)
    prefills = [s["prefills"] - p0 for s, p0 in zip(stats, prefills0)]
    if any(prefills):
        fail("serve_fleet: a decode replica ran a prefill for a handoff: %r"
             % prefills)
    if stats[0]["evacuated"] < 1 or sum(s["resumed"] for s in stats) < 1:
        fail("serve_fleet: the recycle of d0 (%d active) migrated no session"
             " (evacuated %d, resumed %d)" % (
                 active, stats[0]["evacuated"],
                 sum(s["resumed"] for s in stats)))
    equal, notes = oracle_rows("serve_fleet", [r[:3] for r in reqs],
                               results)
    toks = sum(len(r) - len(q[0]) for r, q in zip(results, reqs))
    blob = telemetry.histogram("serve.prefill.blob_bytes")
    pms = telemetry.histogram("serve.prefill.ms")
    ims = telemetry.histogram("serve.decode.import_ms")
    say("serve_fleet: %d requests from %d clients through the router (2 "
        "decode replicas with drafts, 1 prefill replica) in %.3f s: %.2f "
        "requests/s, %.1f tokens/s; every one disaggregated: blob %.0f "
        "bytes a request (mean), prefill p50 %.2f ms, import p50 %.3f ms; "
        "recycle of d0 with %d active sessions (evacuate, resume on d1, "
        "readmit) %.1f ms; evacuated %d, resumed %d, imported %d, decode "
        "prefills %d; %d of %d rows equal to the batch-1 oracle%s" % (
            len(reqs), FLEET_CLIENTS, wall, len(reqs) / wall, toks / wall,
            blob.sum / blob.count, pms.quantile(0.5), ims.quantile(0.5),
            active, evac_ms, stats[0]["evacuated"],
            sum(s["resumed"] for s in stats),
            sum(s["imported"] for s in stats), sum(prefills), equal,
            len(reqs),
            "" if not notes else " (" + "; ".join(notes) + ")"))
    _DECODE_PARAMS.clear()
    torch.cuda.empty_cache()
    return {}


def compiled_serve_phase(counters):
    """Predictor.export_buckets -> ServeEngine.from_export, each bucket's
    forward captured as one CUDA graph (CompiledPredictor): the flagship
    LM in bf16 (seq 2048, buckets 1, 2, 4, 8; phase 4's weights, its
    probabilities reshaped to (B, T, V)) and SSD300 in float32 (phase
    10's). Each bucket's replay equals the eager Predictor's forward bit
    for bit; one profiled replay launches flash_fwd_bf16 4 times (the LM)
    and nms_cluster_kernel once (SSD300); each bucket's replay ms by
    events beside the eager forward's; 8 concurrent requests served from
    the export (the LM's within 2e-2 of the predictor alone, as phase 4;
    SSD300's equal bit for bit to the compiled forward of the batch they
    rode in); SSD300 bucket 8's wall ms and busy share, compiled and
    eager. Returns the wrappers' launch counts over the exports' loads
    (each bucket's warm-up and capture; a replay does not pass through
    the wrapper)."""
    import shutil
    import tempfile

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import params_from_jax
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import ServeEngine

    dev = mx.current_context().torch_device()
    tmp = tempfile.mkdtemp(prefix="compiled_serve_")
    launches = {c.__name__: 0 for c in counters}
    try:
        base = transformer.get_symbol(VOCAB, SEQ, num_layers=LAYERS,
                                      num_heads=HEADS, dim=DIM)
        params = params_from_jax(random_params(base, (1, SEQ), seed=0), dev,
                                 dtype="bfloat16")
        lm = mx.sym.reshape(base, shape=(-1, SEQ, VOCAB))
        lm_pred = mx.Predictor(lm, params, data_names=("data",
                                                       "softmax_label"))
        rng = np.random.default_rng(1)

        def lm_inputs(b):
            toks = rng.integers(0, VOCAB, (b, SEQ)).astype(np.float32)
            return [toks, np.zeros_like(toks)]

        ssd = ssd300_symbol(mx.sym, SSD_CLASSES, SSD_WIDTH_DIV)
        ssd_pred = mx.Predictor(ssd, params_from_jax(ssd_params(ssd, seed=0),
                                                     dev),
                                data_names=("data",))
        rs = np.random.RandomState(0)

        def ssd_inputs(b):
            return [rs.standard_normal((b, 3, SSD_IMAGE, SSD_IMAGE))
                    .astype(np.float32)]

        for label, pred, feats, inputs, key, per_fwd in (
                ("lm", lm_pred, [(SEQ,), (SEQ,)], lm_inputs,
                 "flash_fwd_bf16", LAYERS),
                ("ssd", ssd_pred, [(3, SSD_IMAGE, SSD_IMAGE)], ssd_inputs,
                 "nms_cluster_kernel", 1)):
            prefix = os.path.join(tmp, label)
            t = time.perf_counter()
            manifest = pred.export_buckets(prefix, feats, buckets=BUCKETS)
            export_s = time.perf_counter() - t
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            t = time.perf_counter()
            engine = ServeEngine.from_export(prefix, buckets=BUCKETS,
                                             max_wait_ms=200.0,
                                             install_sigterm=False)
            load_s = time.perf_counter() - t
            graph_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
            for c in counters:
                launches[c.__name__] += c.launches
            with open(manifest) as f:
                model_id = json.load(f)["model_id"]
            say("compiled_serve %s: export_buckets %.1f s (model_id %s), "
                "from_export (rebuild, warm-up and capture of %d buckets) "
                "%.1f s, %.2f GB on the card" % (
                    label, export_s, model_id, len(BUCKETS), load_s,
                    graph_gb))
            for b in BUCKETS:
                cp = engine._by_bucket[b]
                xs = inputs(b)
                got = cp.forward(*xs)[0].handle
                want = pred.forward(*xs)[0].handle
                if not torch.equal(got, want):
                    fail("compiled_serve %s bucket %d: the replay differs "
                         "from the eager forward (max abs err %g)" % (
                             label, b, float((got.float() - want.float())
                                             .abs().max())))
                static = cp._static[0]

                def eager(static=static):
                    with torch.no_grad():
                        pred._fwd(*static)
                rep_ms = time_ms(cp._graph.replay, reps=10, warmup=2)
                eager_ms = time_ms(eager, reps=5, warmup=1)
                say("compiled_serve %s bucket %d: replay equal to the eager "
                    "forward bit for bit; %.3f ms a replay by events, eager "
                    "forward %.3f ms (%.2fx)" % (label, b, rep_ms, eager_ms,
                                                 eager_ms / rep_ms))
            profile("compiled_serve %s bucket %d, one replay" % (label, b),
                    cp._graph.replay, top=6)
            n = kernel_counts(profile.counts, [key])[key]
            if n != per_fwd:
                fail("compiled_serve %s: one replay launched %s %d times, "
                     "not %d" % (label, key, n, per_fwd))
            if label == "ssd":
                rep_busy = profile.busy

                def host_replay():
                    cp.forward(*xs)
                    torch.cuda.synchronize()

                def host_eager():
                    pred.forward(*xs)
                    torch.cuda.synchronize()
                walls = {}
                for what, fn in (("compiled", host_replay),
                                 ("eager", host_eager)):
                    fn()
                    ts = []
                    for _ in range(5):
                        t = time.perf_counter()
                        fn()
                        ts.append((time.perf_counter() - t) * 1e3)
                    walls[what] = statistics.median(ts)
                profile("ssd300 bucket 8, eager forward", host_eager, top=4)
                say("compiled_serve ssd bucket 8: wall %.2f ms compiled "
                    "(inputs copied in, one replay, outputs copied; busy "
                    "%.1f%% in the replay) vs %.2f ms eager (busy %.1f%%)" % (
                        walls["compiled"], 100 * rep_busy, walls["eager"],
                        100 * profile.busy))
            # 8 concurrent requests through the engine
            rec = {}
            if label == "ssd":
                engine._by_bucket = {b: Recording(m) for b, m in
                                     engine._by_bucket.items()}
            requests = [inputs(r) for r in REQUEST_ROWS]
            results = [None] * len(requests)
            barrier = threading.Barrier(len(requests))

            def client(i):
                barrier.wait()
                results[i] = engine.infer(*requests[i], timeout=600)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(requests))]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            serve_s = time.perf_counter() - t
            stats = engine.stats()
            if label == "ssd":
                rec = engine._by_bucket
            engine.close()
            if any(r is None for r in results):
                fail("compiled_serve %s: not every request got a response"
                     % label)
            worst = 0.0
            for i, (xs, res) in enumerate(zip(requests, results)):
                out = res[0]
                if label == "lm":
                    if out.shape != (xs[0].shape[0], SEQ, VOCAB) or \
                            not np.isfinite(out).all():
                        fail("compiled_serve lm: response %d shape %r or "
                             "non-finite" % (i, out.shape))
                    alone = pred.forward(*xs)[0].handle.float().cpu().numpy()
                    diff = float(np.abs(out - alone).max())
                    worst = max(worst, diff)
                    if diff > 2e-2 * float(np.abs(alone).max()):
                        fail("compiled_serve lm: response %d differs from "
                             "the predictor alone by %g" % (i, diff))
                else:
                    check_detections("compiled_serve ssd response %d" % i,
                                     out)
                    hit = [(feed, o, j) for m in rec.values()
                           for feed, o in m.batches
                           for j in range(len(feed) - len(xs[0]) + 1)
                           if np.array_equal(feed[j:j + len(xs[0])], xs[0])]
                    if len(hit) != 1 or not np.array_equal(
                            out, hit[0][1][hit[0][2]:hit[0][2] +
                                           len(xs[0])]):
                        fail("compiled_serve ssd: response %d is not its "
                             "rows of the compiled batch it rode in" % i)
                    alone = pred.forward(hit[0][0])[0].asnumpy()
                    if not np.array_equal(alone, hit[0][1]):
                        fail("compiled_serve ssd: the eager Predictor gives "
                             "another output for a served batch")
            say("compiled_serve %s: %d requests (%d rows) in %d engine "
                "forwards, %.3f s: %.2f requests/s; every response checked "
                "(%s)" % (
                    label, len(requests), sum(REQUEST_ROWS),
                    stats["forwards"], serve_s, len(requests) / serve_s,
                    "within 2e-2 of the predictor alone, worst %.3g" % worst
                    if label == "lm" else
                    "detections' rules; equal bit for bit to the compiled "
                    "and the eager forward of the batch it rode in"))
            del engine, rec, results, requests
            torch.cuda.empty_cache()
        del lm_pred, ssd_pred, params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isdir(os.path.join(HERE, "mxnet_tpu_torch")):
        fail("run from a checkout of the repository: mxnet_tpu_torch/ "
             "is not beside this script")
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch  # noqa: F401
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import bn_kernels as bnk
    from mxnet_tpu_torch.ops import nms_kernels as nmsk

    only = []
    for arg in sys.argv[1:]:
        if not arg.startswith("--only="):
            fail("unknown argument %r (the one option: --only=PHASE,...; "
                 "phases %s)" % (arg, ", ".join(sorted(PARTIAL))))
        only = arg[len("--only="):].split(",")
        unknown = sorted(set(only) - set(PARTIAL))
        if unknown:
            fail("unknown phases %s (phases %s)"
                 % (unknown, ", ".join(sorted(PARTIAL))))

    t_start = time.perf_counter()
    smi = smi_line()
    say("env: python %s, torch %s, CUDA %s, device %s x%d"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0), torch.cuda.device_count()))
    say("env: nvidia-smi: %s" % smi)

    t0 = time.perf_counter()
    built = _kernels.build()
    say("build: %s in %.1f s" % (", ".join(sorted(built)),
                                 time.perf_counter() - t0))
    ptxas = []
    for name, info in sorted(built.items()):
        for line in ptxas_summary(info["log"]):
            say("build: %s: %s" % (name, line))
            ptxas.append(line)
    warnings = [w for info in built.values()
                for w in ptxas_warnings(info["log"])]
    say("build: wgmma serialization warnings: %s"
        % ("; ".join(warnings) if warnings else "none"))

    if only:
        for name in only:
            PARTIAL[name]()
        say("partial run (%s) done in %.1f s: no result line" % (
            ",".join(only), time.perf_counter() - t_start))
        return

    records = kernel_phase() + bwd_kernel_phase() + f32_kernel_phase(ptxas)
    gqa_phase()
    records += bn_kernel_phase() + nms_kernel_phase() + mt_kernel_phase()
    prng_phase()
    by_path = {"serve": path_phase([att.flash_fwd_cuda]),
               "train": train_phase([att.flash_fwd_cuda,
                                     att.flash_bwd_cuda]),
               "fit": fit_phase(),
               **executor_phase(),
               **resnet_phase([bnk.bn_stats_cuda, bnk.bn_apply_cuda,
                               bnk.bn_bwd_reduce_cuda, bnk.bn_bwd_dx_cuda]),
               "ssd": ssd_phase([nmsk.nms_keep_cuda]),
               "alexnet": alexnet_phase(),
               "module": module_phase(),
               "compiled_resnet": compiled_resnet_phase(),
               "compiled_alexnet": compiled_alexnet_phase(),
               "lm_options": lm_options_phase(),
               "generate": generate_phase(),
               "serve_decode": serve_decode_phase(),
               "serve_fleet": serve_fleet_phase(),
               "compiled_serve": compiled_serve_phase(
                   [att.flash_fwd_cuda, nmsk.nms_keep_cuda])}
    for rec in records:
        # no kernel moves its bytes faster than the memory can: a time
        # under the byte bound means the timing lost work
        timed = [rec] + list(rec.get("sgd", {}).values()) + (
            [rec["bf16"]] if "bf16" in rec else [])
        if rec["bound_by"] == "bytes" and any(
                t["ms"] < t["bound_ms"] for t in timed):
            fail("%s: a device time under its byte bound: %r"
                 % (rec["name"], [(t["ms"], t["bound_ms"]) for t in timed]))
        counts = {path: launches[rec["name"] + "_cuda"]
                  for path, launches in by_path.items()
                  if rec["name"] + "_cuda" in launches}
        rec["launches"] = sum(counts.values())
        rec["launches_by_path"] = counts
    say("done in %.1f s" % (time.perf_counter() - t_start))
    say(smi)
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# the phases ``--only=`` runs alone (a partial run prints no result line)
PARTIAL = {"mt": mt_kernel_phase, "bn": bn_kernel_phase,
           "alexnet": alexnet_phase, "module": module_phase,
           "compiled": lambda: (compiled_resnet_phase(),
                                compiled_alexnet_phase()),
           "lm_options": lm_options_phase, "generate": generate_phase,
           "serve_decode": serve_decode_phase,
           "serve_fleet": serve_fleet_phase,
           "compiled_serve": lambda: compiled_serve_phase(_serve_counters())}


def _serve_counters():
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import nms_kernels as nmsk
    return [att.flash_fwd_cuda, nmsk.nms_keep_cuda]


if __name__ == "__main__":
    main()
