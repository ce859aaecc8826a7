#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: every hand-written kernel, from the sources in this checkout,
   one nvcc per source started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shape and at edge shapes, with its time, its plain
   version's time, one PyTorch library call's time as a yardstick, and
   its bound (least time for the same work on this card);
4. path: the flagship transformer LM (vocab 32768, seq 2048, 4 layers,
   16 heads, dim 2048, bf16, random weights from a numpy seed) served
   through ServeEngine -> Predictor -> Symbol graph, 8 concurrent
   requests; every response is checked, and the kernels' launch counts
   show the path went through them; plus a small f32 model whose card
   forward must agree with the CPU reference forward;
5. one JSON line of every ported kernel, then the result line.

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

# the flagship LM (bench.py _TLM), served in bf16
VOCAB, SEQ, LAYERS, HEADS, DIM = 32768, 2048, 4, 16, 2048
BUCKETS = (1, 2, 4, 8)
REQUEST_ROWS = (1, 2, 1, 2, 2, 1, 2, 1)   # 8 concurrent requests, 12 rows

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


def flash_work(T, Tk, D, BH, causal, window, band_offset, dtype):
    """(bound_ms, bound_by) for one flash forward: q/k/v read once and o
    written once, against 4*D flops for every (row, col) the mask keeps
    (the work this run's mask needs, not the dense T*Tk)."""
    from mxnet_tpu_torch.ops.attention import _band_mask
    pairs = int(_band_mask(T, Tk, causal, window, band_offset,
                           "cuda").sum().item())
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * BH * D * (2 * T + 2 * Tk)
    flops = 4.0 * BH * D * pairs
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
        err = (o.float() - ro.float()).abs()
        max_err = float(err.max().item())
        tol = TOL[dt]
        bad = err > tol["atol"] + tol["rtol"] * ro.float().abs()
        if not torch.isfinite(o.float()).all():
            fail("flash_fwd %s: non-finite output" % label)
        if bad.any():
            fail("flash_fwd %s: %d elements beyond atol %g rtol %g "
                 "(max abs err %g)" % (label, int(bad.sum()), tol["atol"],
                                       tol["rtol"], max_err))
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
            bound, by = flash_work(T, Tk, D, BH, causal, window, off, dt)
            record = {"name": "flash_fwd", "route": "cuda",
                      "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
                      "replaces": "mxnet_tpu/ops/attention.py:38",
                      "launches": None, "max_abs_err": max_err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": lib_ms}
            say("kernel flash_fwd flagship timing: kernel %.4f ms, plain "
                "%.4f ms, library (scaled_dot_product_attention) %.4f ms, "
                "bound %.4f ms (%s)" % (ms, plain_ms, lib_ms, bound, by))
        del q, k, v, o, lse, ro, rlse, err
    torch.cuda.empty_cache()
    return [record]


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


def profile_forward(model, toks, lab, top=8):
    """Where one forward's device time goes: a torch.profiler trace of
    one (warm) forward, summed by CUDA kernel name, and the share of the
    wall time the card was busy (one stream, so kernels never overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.forward(toks, lab)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    say("profile: bucket %d forward: %.2f ms of kernels in %.2f ms wall "
        "(device busy %.1f%%), %d kernel launches" % (
            toks.shape[0], busy_ms, wall_ms, 100 * busy_ms / wall_ms,
            sum(n for _, n in by_name.values())))
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        say("profile:   %7.3f ms %5.1f%% x%-3d %s" % (
            ms, 100 * ms / busy_ms, n, name[:90]))


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
    profile_forward(model, toks, lab)

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
        for line in info["log"].splitlines():
            if "Used" in line or "spill" in line:
                say("build: %s: %s" % (name, line.strip()))

    records = kernel_phase()
    launches = path_phase([att.flash_fwd_cuda])
    for rec in records:
        rec["launches"] = launches[rec["name"] + "_cuda"]
    say("done in %.1f s" % (time.perf_counter() - t_start))
    say(smi)
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
