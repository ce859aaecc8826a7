#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: every hand-written kernel, from the sources in this checkout,
   one nvcc per source started together;
3. kernels: each kernel (flash forward, dq, dk/dv) against its plain
   PyTorch version on the card, at the main paths' shape and at edge
   shapes, with its time, its plain version's time, one PyTorch library
   call's time as a yardstick (the forward; the dq + dk/dv pair through
   the backward of scaled_dot_product_attention), and its bound (least
   time for the same work on this card);
4. serve path: the flagship transformer LM (vocab 32768, seq 2048, 4
   layers, 16 heads, dim 2048, bf16, random weights from a numpy seed)
   served through ServeEngine -> Predictor -> Symbol graph, 8 concurrent
   requests; every response is checked, and the kernels' launch counts
   show the path went through them; plus a small f32 model whose card
   forward must agree with the CPU reference forward;
5. train path: the same LM trained as bench.py trains it (Adam, bf16
   compute, Xavier init, batch 8 of random tokens) through
   make_train_step -> init_state -> step: 2 warm steps (one profiled)
   and 10 timed ones, a finite and falling loss, and 4 launches of each
   flash kernel per step; plus a small f32 LM whose one-step parameters
   on the card must match the same step on the CPU;
6. one JSON line of every ported kernel, then the result line.

It imports nothing of JAX or of ``mxnet_tpu``. Without CUDA, or run
outside the repository, it fails before printing any result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

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
        m = re.search(r"Compiling entry function '\S*?(flash_(?:fwd|dq|dkv)_"
                      r"(?:bf16|f32))(?:ILi(\d+)E)?", line)
        if m:   # the mangled name: ...<name>[ILi<DP>E]...
            fn = m.group(1) + ("<%s>" % m.group(2) if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = "%s/%s bytes spilled (stores/loads)" % m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append("%s: %s registers, %s" % (fn, m.group(1), spill))
    return out


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
]


def flash_bound(kind, T, Tk, D, BH, causal, window, band_offset, dtype):
    """(bound_ms, bound_by) for one flash kernel call: each input read
    once and each output written once, against the matrix flops it does
    for every (row, col) pair the mask keeps (the work this run's mask
    needs, not the dense T*Tk): 4*D per pair for the forward (q.k, p.v),
    6*D for dq (q.k, do.v, ds.k), 8*D for dk/dv (k.q, v.do, p.do, ds.q),
    10*D for a fused one-pass backward (q.k, do.v, p.do, ds.q, ds.k).
    Inputs and outputs: fwd q k v -> o; dq q k v do lse delta -> dq;
    dkv q k v do lse delta -> dk dv; fused, all of those -> dq dk dv."""
    from mxnet_tpu_torch.ops.attention import _band_mask
    pairs = int(_band_mask(T, Tk, causal, window, band_offset,
                           "cuda").sum().item())
    elt = 2 if dtype == "bfloat16" else 4
    per_pair, rows_q, rows_k, stats = {
        "fwd": (4, 2, 2, 0), "dq": (6, 3, 2, 2), "dkv": (8, 2, 4, 2),
        "fused": (10, 3, 4, 2)}[kind]
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
    import torch.nn.functional as F
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
        max_err = check_close("flash_fwd %s" % label, o, ro, TOL[dt])
        lse_err = None
        if want_lse:
            le = (lse - rlse).abs()
            lse_err = float(le.max().item())
            if (le > LSE_TOL["atol"] + LSE_TOL["rtol"] * rlse.abs()).any():
                fail("flash_fwd %s: lse max abs err %g" % (label, lse_err))
        say("kernel flash_fwd %-16s BH=%d T=%d Tk=%d D=%d %s causal=%s "
            "window=%d offset=%d: max_abs_err %.3g%s" % (
                label, BH, T, Tk, D, dt, causal, window, off, max_err,
                "" if lse_err is None else ", lse %.3g" % lse_err))
        if label == "flagship":
            ms = time_ms(lambda: att.flash_fwd_cuda(q, k, v, scale, True))
            plain_ms = time_ms(lambda: att._flash_fwd_reference(
                q, k, v, scale, True))
            q4, k4, v4 = (x.view(1, BH, -1, D) for x in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, scale=scale))
            bound, by = flash_bound("fwd", T, Tk, D, BH, causal, window,
                                    off, dt)
            record = {"name": "flash_fwd", "route": "cuda",
                      "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
                      "replaces": "mxnet_tpu/ops/attention.py:38",
                      "launches": None, "max_abs_err": max_err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": lib_ms}
            say("kernel flash_fwd flagship timing: kernel %.4f ms, plain "
                "%.4f ms, library (scaled_dot_product_attention) %.4f ms, "
                "bound %.4f ms (%s)" % (ms, plain_ms, lib_ms, bound, by))
        del q, k, v, o, lse, ro, rlse
    torch.cuda.empty_cache()
    return [record]


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
]


def bwd_kernel_phase():
    """flash_dq_cuda and flash_dkv_cuda against their plain versions on
    the same inputs: q, k, v, do random; o and lse from the forward
    kernel; delta = rowsum(do * o), minus a random lse cotangent where
    the case says so."""
    import torch
    import torch.nn.functional as F
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
        dq = att.flash_dq_cuda(*args)
        dk, dv = att.flash_dkv_cuda(*args)
        torch.cuda.synchronize()
        errs = {"dq": check_close("flash_dq %s" % label, dq,
                                  att._flash_dq_reference(*args), TOL[dt])}
        rdk, rdv = att._flash_dkv_reference(*args)
        errs["dk"] = check_close("flash_dkv %s dk" % label, dk, rdk,
                                 TOL[dt])
        errs["dv"] = check_close("flash_dkv %s dv" % label, dv, rdv,
                                 TOL[dt])
        del rdk, rdv
        say("kernel flash_dq/dkv %-16s BH=%d T=%d Tk=%d D=%d %s causal=%s "
            "window=%d offset=%d dlse=%s: max_abs_err dq %.3g dk %.3g "
            "dv %.3g" % (label, BH, T, Tk, D, dt, causal, window, off,
                         dlse, errs["dq"], errs["dk"], errs["dv"]))
        if label == "flagship":
            q4, k4, v4 = (x.view(1, BH, -1, D).detach().requires_grad_()
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                 scale=scale)
            do4 = do.view(1, BH, T, D)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                out, (q4, k4, v4), do4, retain_graph=True))
            del out, q4, k4, v4
            for name, kernel, plain, kind, err in (
                    ("flash_dq", att.flash_dq_cuda, att._flash_dq_reference,
                     "dq", errs["dq"]),
                    ("flash_dkv", att.flash_dkv_cuda,
                     att._flash_dkv_reference, "dkv",
                     max(errs["dk"], errs["dv"]))):
                ms = time_ms(lambda: kernel(*args))
                plain_ms = time_ms(lambda: plain(*args))
                bound, by = flash_bound(kind, T, Tk, D, BH, causal, window,
                                        off, dt)
                records.append({
                    "name": name, "route": "cuda",
                    "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
                    "replaces": "mxnet_tpu/ops/attention.py:%d"
                                % (279 if kind == "dq" else 331),
                    "launches": None, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": None,
                    "pair_library_ms": lib_ms})
                say("kernel %s flagship timing: kernel %.4f ms, plain %.4f "
                    "ms, bound %.4f ms (%s)" % (name, ms, plain_ms, bound,
                                                by))
            bound_of = {kind: flash_bound(kind, T, Tk, D, BH, causal,
                                          window, off, dt)[0]
                        for kind in ("dq", "dkv", "fused")}
            say("kernel flash backward pair flagship: dq + dkv %.4f ms, "
                "bound %.4f ms; library (scaled_dot_product_attention "
                "backward, dq dk dv together) %.4f ms; a fused one-pass "
                "design's bound %.4f ms" % (
                    records[-2]["ms"] + records[-1]["ms"],
                    bound_of["dq"] + bound_of["dkv"], lib_ms,
                    bound_of["fused"]))
        del q, k, v, do, o, lse, delta, dq, dk, dv, args
    torch.cuda.empty_cache()
    return records


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


# kernel-name substrings -> the kind of work, for the profile summary
PROFILE_GROUPS = (
    ("flash kernels (this port)", ("flash_fwd", "flash_dq", "flash_dkv")),
    ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("softmax", ("SoftMax", "softmax")),
    ("reductions", ("reduce_kernel",)),
    ("embedding scatter/gather", ("index", "scatter", "gather", "sort",
                                  "Sort", "radix", "cub")),
    ("elementwise", ("elementwise", "Functor", "copy_kernel")),
)


def profile(what, fn, top=8):
    """Where one call's device time goes: a torch.profiler trace of one
    (warm) call, summed by CUDA kernel name, and the share of the wall
    time the card was busy (one stream, so kernels never overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
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
# bounds of the TPU kernels not ported yet (PERF.md's kernel table)
# ---------------------------------------------------------------------------

# ResNet-50's stage-2 BatchNorm input, bf16 (benchmark/bench_bn.py SHAPES)
BN_SHAPE = (128, 256, 56, 56)
# SSD's anchors per image (mxnet_tpu/ops/nms_pallas.py), f32 corner boxes
NMS_ANCHORS = 8732
NMS_OPS_PER_PAIR = 15   # IoU (8 min/max/sub, mul, 2 add/sub, div), >=,
                        # the class test and its mask


def pending_bounds():
    """The least time on this card of each TPU kernel still to port, at
    the shape its caller gives it: the BatchNorm kernels move x (and dy,
    dx) once each in bf16, so they are bound by bytes; greedy NMS over A
    boxes reads 4 f32 coordinates, a class and a keep flag per box and
    evaluates at least A(A-1)/2 IoU tests on the f32 CUDA cores."""
    x_bytes = 2 * int(np.prod(BN_SHAPE))
    for name, line, tensors in (("_stats_kernel", 50, 1),
                                ("_apply_kernel", 66, 2),
                                ("_bwd_reduce_kernel", 72, 2),
                                ("_bwd_dx_kernel", 88, 3)):
        say("bound (not ported): mxnet_tpu/ops/bn_pallas.py:%d %s at %s "
            "bf16: %.4f ms (bytes: %d tensors of %.1f MB)" % (
                line, name, "x".join(map(str, BN_SHAPE)),
                tensors * x_bytes / PEAK_BYTES_PER_S * 1e3, tensors,
                x_bytes / 1e6))
    A = NMS_ANCHORS
    t_ops = NMS_OPS_PER_PAIR * A * (A - 1) / 2 / PEAK_F32_FLOPS * 1e3
    t_bytes = 4 * A * (4 + 1 + 1 + 1) / PEAK_BYTES_PER_S * 1e3
    say("bound (not ported): mxnet_tpu/ops/nms_pallas.py:49 _nms_kernel at "
        "%d boxes: %.4f ms (%s; bytes alone %.6f ms)" % (
            A, max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", t_bytes))


# ---------------------------------------------------------------------------
# train path
# ---------------------------------------------------------------------------

def lm_nll(probs, labels):
    """Mean next-token NLL of (B*T, V) probabilities on the card, over
    the labels that are not -1."""
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
        nlls.append(lm_nll(outs[0], batch["softmax_label"]))
        del outs
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
    say("train: launches %s (%d layers x %d steps each)" % (
        ", ".join("%s %d" % kv for kv in sorted(launches.items())),
        LAYERS, steps))
    del state, batch, step
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
    for name, info in sorted(built.items()):
        for line in ptxas_summary(info["log"]):
            say("build: %s: %s" % (name, line))

    records = kernel_phase() + bwd_kernel_phase()
    pending_bounds()
    by_path = {"serve": path_phase([att.flash_fwd_cuda]),
               "train": train_phase([att.flash_fwd_cuda, att.flash_dq_cuda,
                                     att.flash_dkv_cuda])}
    for rec in records:
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


if __name__ == "__main__":
    main()
