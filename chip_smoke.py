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
   and 5 timed ones, a finite and falling loss, and 4 launches of
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
   make_train_step: 2 warm steps (one profiled) and 5 timed ones, a
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
   peak memory; at 2 layers under
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
   slots, max_len 384): 12 float32 requests (greedy, seeded, streamed; 4
   speculative over truncated_draft(1); MXNET_PREFILL_CHUNK=64) each equal
   to generate of its prompt alone, stream frames equal to their rows,
   one captured step graph after the turnover; the bf16 rows that agree;
   64 bf16 requests timed: tokens/s, ms a step by events and by the host
   clock, busy share, TTFT and inter-token p50/p99, slot fill, beside
   generate_on_device's rate;
20. serve_fleet: a ServeRouter over two decode replicas and a prefill
   replica on 127.0.0.1 (float32), 8 ServeClient threads, 24
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
22. moe_lm: the MoE flagship of bench_scaling.py --full-size
   --expert-parallel at its 4-device row, one device's share (the flagship
   LM with 8 experts, capacity factor 1.25, its depth cut to MOE_LAYERS =
   2 of 4; batch 8, bf16, SGD momentum 0.9) trained 3 steps through make_train_step (the
   expert axis has one rank: dense_moe): ms a step, tokens/s, peak memory,
   a profile by kernel kind with the flash kernels' counts; then
   bench_decode's settings through Generator(num_experts=8) with the
   trained weights: float32 generate_on_device (the route, dispatch and
   combine inside the captured step) equal to generate, bf16 ms a step
   and one replay by events; before them a small float32 MoE LM at 2
   layers, card against CPU;
23. mesh2: two ranks of this script sharing the card over gloo (named
   explicitly; ``--mesh-rank=`` runs one), after the windowed ring's
   visiting block (band offset 1024) held against the plain versions in
   this process: the ring at the flagship attention
   shape (T 2048 split 1024 + 1024), causal and window 512, forward and
   backward, f32 against a one-rank flash call (bf16 reported); moe_ffn
   at expert=2 against its per-rank rule; one step of the flagship LM at 1
   layer in float32 over data=2 with and without zero1 (bit-equal), sp=2
   and expert=2, each against the one-rank step; pipeline_from_symbol at
   pipe=2 against the sequential stages; ms and staged bytes of each;
24. gspmd2: two ranks of this script sharing the card over gloo
   (``--gspmd-rank=`` runs one): bench_scaling.py --full-size's GSPMD row
   at n = 2 (the flagship LM at 2 layers, data=1 x fsdp=2, SpecLayout,
   Adam zero1, bf16, batch 8 a rank; a warm step and 2 timed: ms, the
   loss, the parameters and Adam state at 1/2 a rank, the launches) and
   its float32 parity step against one rank; the same LM over tp=2
   (column-parallel qkv/proj/fc1/fc2) against one rank; ResNet-50 under
   data=2 on the BatchNorm kernels (batch 16 a rank, f32) against one
   rank; Generator over model=2 (bench_decode's model at 2 layers, f32) against the
   one-rank generate;
25. kvdist2: bench.py's ResNet-50 (float32, the BatchNorm kernels, batch
   64 a worker) through Module.fit on two workers of this script sharing
   the card over gloo (``--kv-rank=`` runs one): (a) kvstore='dist_sync',
   a warm step and 2 timed (ms, staged bytes, pushes and pulls a step, peak
   memory, BatchNorm launches), the workers' parameters after 2 steps equal
   to each other and to one process's rank-ordered sum of the same
   gradients; (b) kvstore='dist_async' against a parameter-server process
   started as tools/launch.py starts one (``--kv-server``: DMLC_ROLE=server
   through the package's import hook), 2 steps a worker, every push
   applied once, the final pulls equal to the server's store, then one
   worker alone against the same Module on a 'local' store;
26. profiler: mx.profiler over torch.profiler: two steps of kvdist2's
   Module in mode 'symbolic' (executor events only; a whole step of the
   device trace names each BatchNorm kernel once a BatchNorm), two bf16
   steps of the flagship LM in mode 'all' (each bf16 flash kernel once a
   layer a step; the step markers), and the eager op call's host time
   with the profiler stopped against the same call without the dispatch
   site's check;
27. gluon: (a) model_zoo resnet18_v1 (10 classes, 3x32x32, batch 8, f32,
   MXNET_BN_PALLAS=1) from one seed on the CPU and the card, hybridized:
   one record -> SoftmaxCrossEntropyLoss -> backward -> Trainer('sgd',
   momentum 0.9, wd 1e-4).step, the card's loss, gradients, updates and
   running stats held to the CPU's by executor_reference_checks' cuDNN
   rule, and the eager step on the card equal to the hybridized one; (b)
   model_zoo resnet50_v1 at bench.py's image step (batch 128 x 3x224x224,
   SGD momentum 0.9, wd 1e-4, lr 0.1, Xavier gaussian in 2), float32,
   hybridized, on the BatchNorm kernels, batches from a DataLoader over a
   seeded ArrayDataset: 2 warm steps (one profiled) and 5 timed, step ms,
   img/s, peak memory, busy share, each BatchNorm kernel once a BatchNorm
   (53) a step, then the same net eager; (c) upstream
   example/gluon/word_language_model's RNNModel at its largest setting
   (2-layer LSTM at 1500, dropout 0.65, tied, vocab 10000, batch 32 x bptt
   35, clip_global_norm, SGD lr 1): step ms and tokens/s, after the same
   model at width 64 card against CPU;
28. rnn: the symbolic RNN toolkit, the fused RNN op and CTCLoss. (a)
   upstream example/rnn/cudnn_lstm_bucketing.py's net (Embedding ->
   FusedRNNCell lstm -> FullyConnected -> SoftmaxOutput) at 2 x 1500,
   embed 1500, vocab 10000, dropout 0.65, batch 32, buckets 10..60,
   trained through BucketingModule.fit over BucketSentenceIter (seeded
   Zipf sentences filling every bucket): step ms, tokens/s, peak memory,
   launches and busy share of each bucket, a falling loss, the
   save_rnn_checkpoint -> load_rnn_checkpoint round trip bit for bit;
   the op's cuDNN route against _rnn_reference at bucket 60 (outputs,
   data and blob gradients), its time beside the plain loop's and
   torch.nn.LSTM's over flattened weights (the weight copy); the net
   unfused (SequentialRNNCell of LSTMCells) against the fused one at p
   0, and the unfused step's time; (b) upstream
   example/warpctc/lstm_ocr.py's LSTM + CTC (2 x 100, 80 frames of 30,
   4-digit labels, 11 classes, batch 32): card against CPU, a few
   Module.fit steps with a falling loss, the CTCLoss op's time beside
   torch.nn.functional.ctc_loss's;
29. detect: (a) SSD300 (VGG16-reduced, 21 classes, 300 px, f32) trained at
   full width through Module.fit over upstream's get_symbol_train graph
   (MultiBoxTarget, SoftmaxOutput, the smooth_l1 MakeLoss, and
   MultiBoxDetection on the NMS kernel under MakeLoss grad_scale 0): batch
   32, SGD lr 0.002 momentum 0.9 wd 5e-4, seeded batches of 1..8 boxes an
   image; step ms, img/s, peak memory, a profiled step, the target op
   alone by events; a finite, falling loss, the targets' rules, one NMS
   launch a training forward; before it the graph at widths / 16, batch
   2, one Module step card against CPU; (b) examples/rcnn_train.py's
   Faster R-CNN (its Custom AnchorTarget and ProposalTarget,
   _contrib_Proposal, ROIPooling): one Module step card against CPU, a
   few Module.fit steps on the card, the captures refused; Proposal and
   ROIPooling timed at upstream example/rcnn's VGG16 shapes; (c) the
   warp ops, linalg, fft/ifft, count_sketch and quantize/dequantize card
   against CPU; ROIPooling's gradient bit-equal across two card runs;
30. zoo: the rest of the symbolic catalog (lenet and mlp at
   train_mnist.py's 1x28x28 batch 64; mobilenet, resnext-50 32x4d and
   googlenet at 3x224x224, inception-v4 and inception-resnet-v2 at
   3x299x299, batch 128, train_imagenet.py's SGD) through Module.fit,
   float32, MXNET_BN_PALLAS=1: a warm-up and 2 timed steps each, step
   ms, img/s, peak memory, launches, each BatchNorm kernel once a
   BatchNorm a step, finite losses, the four BatchNorm kernels against
   their plain versions at every BatchNorm input shape of the timed
   batch, a batch-2 forward card against CPU from the initial weights
   and (its logits) from the fitted ones, beside the CPU's float64;
31. sparse: (a) linear classification over CSR at LIBSVM avazu-app's
   shape (1,000,000 features, 15 a row, seeded), LibSVMIter batches of
   8192 through row_sparse_pull, the csr dot, the transposed csr dot cast
   to row-sparse and a lazy SGD push on a 'local' KVStore: step ms,
   rows/s, launches, host syncs, the iterator's host ms, one step card
   against CPU, the weights bit-equal across two runs, sparse.dot beside
   torch.sparse.mm; (b) the row-sparse embedding recipe (take, take_grad,
   lazy Adam) at MovieLens-20M's counts against the dense route, rows
   outside the batches untouched bit for bit;
32. image: the data plane (image/*, the mmap'd RecordIO reader, the
   batched JPEG decoder, all host code) on seeded 500 x 375 JPEGs packed
   at quality 95 into .rec/.idx files: (a) bench.py's ResNet-50 (float32,
   MXNET_BN_PALLAS=1, the module phase's SGD and initialisation) through
   Module.fit over mx.io.ImageRecordIter at upstream train_imagenet.py's
   settings (batch 128, 3x224x224, shuffle, rand_crop, rand_mirror,
   ImageNet mean/std, 4 threads; prefetched, batches on the card): a
   warm-up and 4 timed steps, each BatchNorm kernel once a BatchNorm a
   step, every batch through the native reader and decoder; the step
   beside the same Module over those batches resident on the card, the
   step's wait for the iterator, the iterator alone on the host (ms a
   batch, images/s), one batch made for the CPU bit-equal to the one
   made for the card; (b) detect (a)'s SSD300 step through Module.fit
   over mx.io.ImageDetRecordIter at upstream example/ssd/train.py's
   settings (batch 32, 300 px, mean 123/117/104, crop, mirror; 1-3 boxes
   an image over VOC's 20 classes): a warm-up and 4 timed steps, the
   iterator's ms a batch beside the step's, one NMS launch a training
   forward; the seconds of each part;
33. capi: the C ABI (mxnet_tpu_torch/_native/predict_shim.cc, built by g++
   into build/native/ after a probe of this machine's Python) under the
   unchanged hosts of examples/c_predict/ (predict.c, train.c), each a
   child process embedding the interpreter: (a) compiled_serve's SSD300
   exported at batch 8 and served by predict.c, its printed outputs equal
   to the in-process CompiledPredictor's, each C call's ms (the shim's
   MXNET_CAPI_TIMING) beside the in-process forward's; (b) bench.py's
   ResNet-50 step (bf16, MXNET_BN_PALLAS=1) exported and trained 3 steps by
   train.c, the softmax output and fc1_bias within CAPI_TRAIN_RTOL of 3
   in-process CompiledTrainStep steps (two in-process loads beside it), a
   step's ms through the ABI beside step()'s; (c) a bad prefix, an unknown
   input, a wrong size and prefixes in the JAX package's layout each end
   the host with rc 1 and the message. The children's kernel launches are
   their own processes' and are not counted here;
34. surface: mx.rtc sources (torch ops, and a @triton.jit kernel) on card
   tensors against their plain results, mx.viz.print_summary's count for
   ResNet-50, test_utils.check_speed against time_ms on ResNet-50's
   forward, LogMetricsCallback's event file on a Module.fit read back;
35. a line of the seconds each phase took, one JSON line of every
   ported kernel (a device time under its byte bound fails the run: the
   timing lost work), then the result line.

It imports nothing of JAX or of ``mxnet_tpu``. Without CUDA, or run
outside the repository, it fails before printing any result.
``--only=PHASE,...`` runs the named phases alone after the build
(``PARTIAL``; ``generate`` needs ``lm_options`` before it) and prints no
result line.
"""
from __future__ import annotations

import faulthandler
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
WARM_STEPS, TIMED_STEPS = 2, 5

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
    ("RNN (cuDNN)", ("RNN", "LSTM", "rnn_", "elemWise", "Persist")),
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


PROFILE_TRIES = 3      # traces of one call before a kernel count is refused


def _tracer():
    from torch.profiler import ProfilerActivity, profile as tprofile
    return tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profile(what, fn, top=8):
    """Where one call's device time goes: a torch.profiler trace of one
    (warm) call, summed by CUDA kernel name, and the share of the wall
    time the card was busy (one stream, so kernels never overlap). The
    kernel names of the call are left in ``profile.names``."""
    import torch
    with _tracer() as prof:
        # a marker first: it takes what the trace loses at its start
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    profile_report(what, prof, wall_ms, top)
    return out


def profile_report(what, prof, wall_ms, top=8):
    """``profile``'s summary of a finished trace over ``wall_ms``."""
    from torch.autograd import DeviceType
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
            spans.append((e.time_range.start, e.time_range.end))
    busy_ms = sum(ms for ms, _ in by_name.values())
    # the time some kernel ran: kernels on several streams (cuDNN's RNN)
    # overlap, and their sum then exceeds the wall
    covered, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            covered += end - start
            reach = end
        elif end > reach:
            covered += end - reach
            reach = end
    covered_ms = covered / 1e3
    profile.names = set(by_name)
    profile.counts = {name: n for name, (_, n) in by_name.items()}
    profile.busy = covered_ms / wall_ms
    profile.busy_ms = busy_ms
    say("profile: %s: %.2f ms of kernels in %.2f ms wall (device busy "
        "%.1f%%%s), %d kernel launches" % (
            what, busy_ms, wall_ms, 100 * profile.busy,
            "" if covered_ms > busy_ms - 1e-3 else
            ": kernels overlap, %.2f ms covered" % covered_ms,
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
# upstream example/ssd/symbol/symbol_builder.py get_symbol_train
SSD_TARGET = dict(overlap_threshold=0.5, ignore_label=-1,
                  negative_mining_ratio=3, negative_mining_thresh=0.5,
                  minimum_negative_samples=0, variances=(0.1, 0.1, 0.2, 0.2))


def ssd300_symbol(S, num_classes=20, width_div=1, impl="auto",
                  heads=False, train=False):
    """SSD300 over the VGG16-reduced body, written once against the MXNet
    symbol API both packages share: ``S`` is ``mxnet_tpu.sym`` or
    ``mxnet_tpu_torch.sym``. Output (B, 8732, 6) detections [class,
    score, x1, y1, x2, y2] from a (B, 3, 300, 300) ``data``; with
    ``heads``, instead the detection op's three inputs (cls_prob
    (B, C, 8732), loc_preds (B, 8732*4), anchors (1, 8732, 4)); with
    ``train``, upstream symbol_builder.get_symbol_train's four outputs
    over a (B, L, 6) ``label`` (SSD_TARGET's MultiBoxTarget; cls_prob,
    the SoftmaxOutput over the targets; loc_loss, smooth_l1 of the masked
    offsets under MakeLoss; cls_label, the targets under MakeLoss
    grad_scale 0; det_out, MultiBoxDetection over cls_prob under MakeLoss
    grad_scale 0). ``width_div`` divides every convolution's width (small
    models for the CPU tests); ``impl`` is MultiBoxDetection's NMS
    route."""

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
    if train:
        label = S.Variable("label")
        tgt = S.contrib.MultiBoxTarget(anchor_boxes, label, cls_preds,
                                       name="multibox_target", **SSD_TARGET)
        loc_target, loc_mask, cls_target = tgt[0], tgt[1], tgt[2]
        cls_prob = S.SoftmaxOutput(cls_preds, cls_target, ignore_label=-1,
                                   use_ignore=True, grad_scale=1.0,
                                   multi_output=True, normalization="valid",
                                   name="cls_prob")
        loc_loss = S.MakeLoss(S.smooth_l1(loc_mask * (loc_preds - loc_target),
                                          scalar=1.0, name="loc_loss_"),
                              grad_scale=1.0, normalization="valid",
                              name="loc_loss")
        cls_label = S.MakeLoss(cls_target, grad_scale=0, name="cls_label")
        det = S.contrib.MultiBoxDetection(cls_prob, loc_preds, anchor_boxes,
                                          name="detection", impl=impl,
                                          **SSD_NMS)
        return S.Group([cls_prob, loc_loss, cls_label,
                        S.MakeLoss(det, grad_scale=0, name="det_out")])
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


def eager_site_ab():
    """eager_dispatch_us's plain figure in turns through invoke_eager (the
    profiler's dispatch site, stopped) and through its body without the
    site's check (registry._invoke_eager, the code before the site
    existed): {"site": [us, ...], "bare": [us, ...]}."""
    from mxnet_tpu_torch.ops import registry
    site = registry.invoke_eager
    runs = {"site": [], "bare": []}
    try:
        for kind in ("site", "bare", "bare", "site") * 2:
            registry.invoke_eager = site if kind == "site" else \
                registry._invoke_eager
            runs[kind].append(eager_dispatch_us()[0])
    finally:
        registry.invoke_eager = site
    return runs


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
    EAGER_US["executor"] = (us_plain, us_rec)
    # the profiler phase's comparison, measured beside this figure
    EAGER_US["ab"] = eager_site_ab()
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


def bn_check_case(label, N, C, HW, dt, shift, gen):
    """The four BatchNorm kernels on one (N, C, HW) input against their
    plain versions on the same card inputs (x, dy and the per-channel
    coefficients random; the shift c the first sample's channel mean and
    `mean` the batch's, as bn_train_kernels gives them): fails beyond
    BN_SUM_RTOL / BN_ELT_TOL; returns ({kernel: max abs err}, the note on
    the variance, the inputs)."""
    import torch
    from mxnet_tpu_torch.ops import bn_kernels as bnk

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
    return err, var_note, (x, dy, a, b, c2, c, mean)


def bn_kernel_phase():
    """The four BatchNorm kernels against their plain versions at
    BN_CASES (bn_check_case), then timed at BN_SHAPE."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    records = []
    for label, N, C, HW, dt, shift in BN_CASES:
        err, var_note, inputs = bn_check_case(label, N, C, HW, dt, shift,
                                              gen)
        say("kernel bn %-17s N=%d C=%d HW=%d %s: max_abs_err stats %.3g "
            "apply %.3g bwd_reduce %.3g bwd_dx %.3g%s" % (
                label, N, C, HW, dt, err["bn_stats"], err["bn_apply"],
                err["bn_bwd_reduce"], err["bn_bwd_dx"], var_note))
        if (N, C, HW, dt) == (BN_SHAPE[0], BN_SHAPE[1],
                              BN_SHAPE[2] * BN_SHAPE[3], "bfloat16"):
            records = bn_timing(*inputs, err)
        del inputs
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
    second profiled) and TIMED_STEPS timed ones on the same batch. Fails unless
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
    (the second profiled) and TIMED_STEPS timed ones. Fails unless the NLL is
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
    Then, at depth RESUME_LAYERS under
    torch.use_deterministic_algorithms(True), a fit cut by
    sigterm@RESUME_SIGTERM exits at its boundary checkpoint (save_state)
    and the resumed fit (load_state) lands on the uninterrupted run's
    weights bit for bit: the checkpoint's round trip at that depth (the
    full-width round trip, 4.08 GB written and read in 16 s, was cut to
    pay for the capi phase).
    Returns the timed run's launch counts."""
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
        # a trace short of a count (a lost record) is taken again, up to
        # PROFILE_TRIES, as compiled_serve's
        want = {**{k: n_bn for k in BN_KERNEL_KEYS}, "mt_update_kernel": 1}
        for attempt in range(1, PROFILE_TRIES + 1):
            profile("compiled resnet replay (one CUDA graph)",
                    ct._graph.replay, top=8)
            counts = kernel_counts(profile.counts, tuple(want))
            if all(counts[k] >= n for k, n in want.items()):
                break
            say("compiled resnet: trace %d of %d short of a count (%r): "
                "traced again" % (attempt, PROFILE_TRIES, counts))
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
GEN_ITERS = 2
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

SD_REQUESTS = 12                  # serve_decode's checked requests
SD_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SD_CHUNK = 64                     # MXNET_PREFILL_CHUNK for the checked run
SD_SPEC = (0, 1, 3, 4)            # speculative requests (2 greedy, 2 seeded)
SD_TIMED = 64                     # the timed closed loop's requests
SD_WINDOW_S = 60                  # the profiled window's longest wait
SD_HANG_S = 600                   # the timed run's limit (it takes ~40 s)
FLIP_RTOL = 1e-5                  # an accepted flip's top-two logit gap
FLEET_REQUESTS, FLEET_CLIENTS = 24, 8
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
    # the 16 profiled steps: the trace opens and closes while the
    # decoder's thread waits at a step boundary (a trace opened while that
    # thread was launching work hung two full smokes)
    held, go, traced, resume = (threading.Event() for _ in range(4))
    window = {"n": 0}

    def timed_step():
        if profiling[0] and not go.is_set():
            held.set()
            go.wait(SD_WINDOW_S)
        t = time.perf_counter()
        step()
        if go.is_set() and not traced.is_set():
            window["n"] += 1
            if window["n"] == 16:
                traced.set()
                resume.wait(SD_WINDOW_S)
        elif not profiling[0]:
            host_ms.append((time.perf_counter() - t) * 1e3)

    dec._step = timed_step
    left = [SD_TIMED - B]
    # a hang anywhere in the timed run fails it with every thread's stack
    faulthandler.dump_traceback_later(SD_HANG_S, exit=True)
    try:
        t = time.perf_counter()
        futs = [dec.submit(p, n) for p, n in treqs]
        for f in futs:
            f.result(900)
            left[0] -= 1
            if left[0] == SD_TIMED // 2:
                profiling[0] = True
                if not held.wait(SD_WINDOW_S):
                    fail("serve_decode: the decoder reached no step in %d s "
                         "with requests queued" % SD_WINDOW_S)
                with _tracer() as prof:
                    torch.cuda._sleep(1)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    go.set()
                    ok = traced.wait(SD_WINDOW_S)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                profiling[0] = False
                resume.set()
                if not ok:
                    fail("serve_decode: the decoder made %d of 16 steps in "
                         "%d s with requests queued" % (window["n"],
                                                        SD_WINDOW_S))
                profile_report("serve_decode: 16 live decode steps (8 "
                               "slots, the queue non-empty)", prof, wall_ms,
                               top=6)
                busy = profile.busy
        wall = time.perf_counter() - t
        st = dec.stats()
        row = dec._row
        replay_ms = time_ms(row.graph.replay, reps=20, warmup=3)
        capture_ms = row.capture_ms
    finally:
        dec.close()
        faulthandler.cancel_dump_traceback_later()
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
    send 24 requests through a ServeServer fronting the router: greedy,
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
    # the router places new sessions by polled free slots, so d0 can be
    # idle at that moment: recycle once it decodes two sessions (one in
    # the last wave), or the recycle would have nothing to migrate
    deadline = time.monotonic() + 600
    while True:
        active = decs[0].stats()["active"]
        if active >= 2 or (active >= 1 and n_done[0] >= len(reqs)
                           - FLEET_CLIENTS) or n_done[0] >= len(reqs) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.005)
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
            # torch.profiler can drop a kernel's record from a trace
            # (device_ms): a trace short of the count is taken again, up
            # to PROFILE_TRIES; more than the count fails at once
            for attempt in range(1, PROFILE_TRIES + 1):
                profile("compiled_serve %s bucket %d, one replay" % (
                    label, b), cp._graph.replay, top=6)
                n = kernel_counts(profile.counts, [key])[key]
                if n >= per_fwd:
                    break
                say("compiled_serve %s: trace %d of %d holds %d records of "
                    "%s, not %d: traced again" % (label, attempt,
                                                  PROFILE_TRIES, n, key,
                                                  per_fwd))
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


# ---------------------------------------------------------------------------
# moe_lm: the MoE flagship on one rank (bench_scaling.py --full-size
# --expert-parallel at its 4-device row, one device's share)
# ---------------------------------------------------------------------------

MOE_EXPERTS, MOE_CF = 8, 1.25     # 2 experts a device x 4 devices
MOE_STEPS, MOE_LR = 3, 0.1        # bench_scaling.py: SGD momentum 0.9, lr 0.1
MOE_LAYERS = 2                    # the flagship's 4 layers cut to 2
MOE_SMALL = dict(T=64, V=100, layers=2, heads=4, dim=64, experts=4)


def moe_reference_check():
    """A small float32 MoE LM at 2 layers (4 experts, capacity 1.25: tokens
    drop): one SGD-momentum step on the card (f32 flash kernels, the
    route, dispatch and combine on the device) against the same step on
    the CPU, from one seeded Xavier init; the step's probabilities and
    parameters within rtol 1e-4, atol 1e-6."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import make_train_step

    c = MOE_SMALL
    B = 2
    sym = transformer.get_symbol(c["V"], c["T"], num_layers=c["layers"],
                                 num_heads=c["heads"], dim=c["dim"],
                                 num_experts=c["experts"],
                                 moe_capacity_factor=MOE_CF)
    rng = np.random.RandomState(11)
    toks = rng.randint(0, c["V"], (B, c["T"])).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    after, probs = [], []
    for ctx in (mx.gpu(0), mx.cpu()):
        step = make_train_step(sym, optimizer="sgd", ctx=ctx,
                               optimizer_params={"momentum": 0.9})
        mx.random.seed(7)
        state = step.init_state(Xavier(), {"data": (B, c["T"]),
                                           "softmax_label": (B, c["T"])})
        state, outs = step(state, {"data": toks, "softmax_label": labels},
                           0.1, 0)
        after.append({n: v.cpu().numpy() for n, v in state[0].items()})
        probs.append(outs[0].detach().cpu().numpy())
    worst = float(np.abs(probs[0] - probs[1]).max())
    if not np.allclose(probs[0], probs[1], rtol=1e-4, atol=1e-6):
        fail("moe_lm reference: the small f32 MoE LM's probabilities on the "
             "card differ from the CPU by %g" % worst)
    for n, w in after[0].items():
        worst = max(worst, float(np.abs(w - after[1][n]).max()))
        if not np.allclose(w, after[1][n], rtol=1e-4, atol=1e-6):
            fail("moe_lm reference: %s on the card differs from the CPU by "
                 "%g" % (n, np.abs(w - after[1][n]).max()))
    say("moe_lm reference: small f32 MoE LM (2 layers, %d experts) one step, "
        "card vs CPU: probabilities and parameters max abs err %.3g (rtol "
        "1e-4, atol 1e-6)" % (c["experts"], worst))


def moe_lm_phase():
    """The MoE flagship LM at full width on one rank: vocab 32768, seq
    2048, MOE_LAYERS layers (the flagship's 4 cut to 2 to pay for the capi
    phase), 16 heads, dim 2048, ffn 8192, 8 experts at capacity
    1.25 (dense_moe: the expert axis has one rank), batch 8, bf16 compute,
    SGD momentum 0.9, Xavier from mx.random.seed(0). MOE_STEPS TrainStep
    steps (the second profiled): ms a step, tokens/s, peak memory, the
    flash kernels once a layer a step and the multi-tensor update once a
    step. Then bench_decode's settings (batch 8, prompt 128, 256 new
    tokens, max_len 384) through Generator(num_experts=8) with the trained
    weights: float32 generate_on_device (the decode step, route, dispatch
    and combine included, captured as one CUDA graph) equal to the eager
    generate token for token; bf16 ms a step (bench.py's difference of
    runs) and one replay by events. Returns the launch counts."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.generation import Generator
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.parallel import make_train_step

    moe_reference_check()

    B = TRAIN_BATCH
    t0 = time.perf_counter()
    arch = dict(num_layers=MOE_LAYERS, num_heads=HEADS, dim=DIM,
                ffn_hidden=4 * DIM, num_experts=MOE_EXPERTS)
    sym = transformer.get_symbol(VOCAB, SEQ, moe_capacity_factor=MOE_CF,
                                 **arch)
    step = make_train_step(sym, optimizer="sgd",
                           optimizer_params={"momentum": 0.9},
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
    say("moe_lm: MoE flagship %d params (%.1f M; %d experts, capacity "
        "factor %g), batch %d x %d, SGD momentum 0.9 lr %g, bf16 compute, "
        "on %s, set up in %.1f s" % (
            nparam, nparam / 1e6, MOE_EXPERTS, MOE_CF, B, SEQ, MOE_LR,
            step.device, time.perf_counter() - t0))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (att.flash_fwd_cuda, att.flash_bwd_cuda)
    for c in counters:
        c.launches = 0
    reset_mt_counts()
    nlls, times = [], []
    for i in range(MOE_STEPS):
        t = time.perf_counter()
        if i == 1:
            state, outs = profile("moe_lm train step (warm)", lambda: step(
                state, batch, MOE_LR, i), top=14)
            flash = kernel_counts(profile.counts, ("flash_fwd_bf16",
                                                   "flash_bwd_bf16"))
        else:
            state, outs = step(state, batch, MOE_LR, i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        nlls.append(mean_nll(outs[0], batch["softmax_label"]))
        del outs
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = times[-1]
    say("moe_lm: NLL per step %s" % " ".join("%.4f" % x for x in nlls))
    say("moe_lm: step %.2f ms (the last of %d; all: %s), %.0f tokens/s, "
        "peak device memory %.2f GB; the profiled step's flash kernel "
        "records %s (the wrappers' counts below are the check)" % (
            step_ms, MOE_STEPS, " ".join("%.1f" % x for x in times),
            B * SEQ / step_ms * 1e3, peak_gb, flash))
    if not all(np.isfinite(nlls)):
        fail("moe_lm: non-finite loss %r" % (nlls,))
    for name, n in launches.items():
        if n != MOE_LAYERS * MOE_STEPS:
            fail("moe_lm: %s launched %d times, not %d layers x %d steps"
                 % (name, n, MOE_LAYERS, MOE_STEPS))
    launches.update(check_mt_counts("moe_lm", MOE_STEPS, len(state[0])))
    params = {n: v for n, v in state[0].items()}
    del state, batch, step
    torch.cuda.empty_cache()

    # -- decode: bench_decode's settings with the trained weights ---------
    P, N, ML = GEN_PROMPT, GEN_NEW, GEN_MAX_LEN
    params["pos_embed_weight"] = params["pos_embed_weight"][:ML]
    prompt = np.random.RandomState(0).randint(0, VOCAB, (B, P))
    t = time.perf_counter()
    gen32 = Generator(params, VOCAB, ML, batch_size=B, **arch)
    eager = gen32.generate(prompt, N)
    check_tokens_equal("moe_lm decode: float32 greedy generate_on_device vs "
                       "generate", gen32.generate_on_device(prompt, N), eager)
    say("moe_lm decode: float32, %d new tokens a row x %d rows: the captured "
        "loop equals the eager one token for token (%.1f s with the capture)"
        % (N, B, time.perf_counter() - t))
    del gen32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = Generator(params, VOCAB, ML, batch_size=B, dtype="bfloat16", **arch)
    del params
    ms_tok, tok_s, _ = decode_speed("moe_lm bf16", gen, prompt)
    loop = next(iter(gen._loop_cache.values()))
    loop.i.fill_(0)
    profile("moe_lm decode step, one replay of the captured graph",
            loop.graph.replay, top=8)
    loop.i.fill_(0)
    replay_ms = time_ms(loop.graph.replay, reps=20, warmup=3)
    bound, nbytes = decode_bound(gen)
    say("moe_lm decode bf16: %.4f ms a step (%.0f tokens/s); one replay "
        "%.4f ms by events (%.4f ms of kernels, busy %.1f%%); bound %.4f ms "
        "(%.1f MB a step); peak %.2f GB" % (
            ms_tok, tok_s, replay_ms, profile.busy_ms,
            100 * profile.busy_ms / replay_ms, bound, nbytes / 1e6,
            torch.cuda.max_memory_allocated() / 1e9))
    del gen, loop
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# mesh2: two ranks that share the card, backend gloo
# ---------------------------------------------------------------------------

# the ring at the flagship attention shape (B, H, T, D), T split over 2
MESH_RING = (8, 16, 2048, 128)
MESH_WINDOW = 512
MESH_MOE = dict(tokens=8192, dim=2048, hidden=8192, experts=4)
MESH_TRAIN = dict(layers=1, batch=2, lr=0.1)  # 2 layers until the capi phase
MESH_PIPE = dict(micro=4, mb=2)
MESH_RANK_TIMEOUT_S = 900
RING_F32_RTOL = 1e-5              # the merge reorders sums
TRAIN_TOL = dict(rtol=2e-4, atol=1e-5)
MESH_TINY = dict(ring=(1, 2, 16, 8), window=5, moe=dict(
    tokens=32, dim=8, hidden=16, experts=4), vocab=64, seq=16, heads=2,
    dim=16, pipe_dim=16, pipe_seq=8)


def _rel_err(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


class Laps:
    """Wall seconds of a run's consecutive sections: ``laps(name)`` ends
    the current section; ``laps.seconds`` maps each to its seconds (where
    a two-process phase's time goes, for the smoke's budget)."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def __call__(self, name):
        t = time.perf_counter()
        self.seconds[name] = round(t - self.t, 1)
        self.t = t


def _mesh_rank(rank, world, port, out, device, tiny):
    """One rank of mesh2 (run as ``chip_smoke.py --mesh-rank=...``): every
    case on the same seeded inputs, results to ``out/rank<r>.json``."""
    import torch
    torch.set_num_threads(4)
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import optimizer_kernels as mt
    from mxnet_tpu_torch.parallel import (_comm, dist, make_mesh,
                                          make_train_step, moe_ffn,
                                          pipeline_from_symbol,
                                          ring_attention)
    from mxnet_tpu_torch.parallel.moe import _route, moe_ffn_reference

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init("127.0.0.1:%d" % port, world, rank, backend="gloo",
              timeout=300)
    ctx = mx.gpu(0) if dev.type == "cuda" else mx.cpu()
    res = {}
    laps = Laps()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def randn(shape, seed, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen(seed), device=dev)
                * scale).to(dtype)

    for c in (att.flash_fwd_cuda, att.flash_bwd_cuda):
        c.launches = c.launches_f32 = 0
    for c in (mt.multi_tensor_opt_update_cuda,
              mt.multi_tensor_norm_finite_cuda):
        c.launches = 0
    staged0 = telemetry.counter(_comm.STAGED_BYTES).value

    def kcounts():
        """The flash forward, flash backward and multi-tensor update
        wrappers' launches so far (a case's own are a difference)."""
        return [att.flash_fwd_cuda.launches, att.flash_bwd_cuda.launches,
                mt.multi_tensor_opt_update_cuda.launches]

    def since(c0):
        return [a - b for a, b in zip(kcounts(), c0)]

    # -- the ring at the flagship attention shape --------------------------
    B, H, T, D = MESH_TINY["ring"] if tiny else MESH_RING
    window = MESH_TINY["window"] if tiny else MESH_WINDOW
    mesh = make_mesh({"sp": world})
    for dtype in (torch.float32, torch.bfloat16):
        for win in (0, window):
            tag = "ring_%s_%s" % ("f32" if dtype == torch.float32 else "bf16",
                                  "w%d" % win if win else "causal")
            q, k, v = (randn((B, H, T, D), s, 1.0, dtype).requires_grad_()
                       for s in (1, 2, 3))
            cot = randn((B, H, T, D), 4, 1.0, dtype)

            def run():
                o = ring_attention(q, k, v, mesh, "sp", causal=True,
                                   window=win)
                return o, torch.autograd.grad(o, (q, k, v), cot)

            run()                     # the case's first call: warm-up
            sync()
            c0 = kcounts()
            t = time.perf_counter()
            o, grads = run()
            sync()
            ms = (time.perf_counter() - t) * 1e3
            calls = since(c0)[:2]
            q1, k1, v1 = (x.detach().reshape(B * H, T, D).requires_grad_()
                          for x in (q, k, v))
            o1, _ = att.flash_attention_with_lse(q1, k1, v1, causal=True,
                                                 window=win)
            want = torch.autograd.grad(o1, (q1, k1, v1),
                                       cot.reshape(B * H, T, D))
            res[tag] = {"ms": ms, "o": _rel_err(o.reshape(B * H, T, D), o1),
                        "kernel_calls": calls}
            for n, g, w in zip("qkv", grads, want):
                res[tag]["d" + n] = _rel_err(g.reshape(B * H, T, D), w)
            del q, k, v, o, grads, q1, k1, v1, o1, want

    laps("ring")

    # -- moe_ffn at expert=2 against its plain per-rank rule ---------------
    cfg = MESH_TINY["moe"] if tiny else MESH_MOE
    mesh = make_mesh({"expert": world})
    E, Dm, Hh, Tt = cfg["experts"], cfg["dim"], cfg["hidden"], cfg["tokens"]
    x = randn((Tt, Dm), 5)
    gw = randn((Dm, E), 6, 0.5 / Dm ** 0.5)
    w1 = randn((E, Dm, Hh), 7, 1.0 / Dm ** 0.5)
    w2 = randn((E, Hh, Dm), 8, 1.0 / Hh ** 0.5)
    sync()
    t = time.perf_counter()
    o = moe_ffn(x, gw, w1, w2, mesh)
    sync()
    ms = (time.perf_counter() - t) * 1e3
    want = moe_ffn_reference(x, gw, w1, w2, world)
    mine = x.chunk(world)[rank]
    ids = _route(_comm.scatter_to_axis(x, mesh, "expert", 0), gw, E, 1)[0]
    ids_ref = _route(mine, gw, E, 1)[0]
    res["moe_ffn"] = {"ms": ms, "o": _rel_err(o, want),
                      "ids_equal": bool(torch.equal(ids, ids_ref)),
                      "kept": int((o.abs().sum(-1) > 0).sum())}
    del x, w1, w2, o, want

    laps("moe_ffn")

    # -- training steps at 2 layers against the one-rank step -------------
    V, S = (MESH_TINY["vocab"], MESH_TINY["seq"]) if tiny else (VOCAB, SEQ)
    heads = MESH_TINY["heads"] if tiny else HEADS
    dim = MESH_TINY["dim"] if tiny else DIM
    Bt = MESH_TRAIN["batch"]
    rng = np.random.RandomState(3)
    toks = rng.randint(0, V, (Bt, S)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    feed = {"data": toks, "softmax_label": labels}
    shapes = {k: v.shape for k, v in feed.items()}

    def params_for(sym):
        arg_shapes, _, _ = sym.infer_shape(**shapes)
        out = {}
        for i, (n, s) in enumerate(zip(sym.list_arguments(), arg_shapes)):
            if n in shapes:
                continue
            if n.endswith("_gamma"):
                out[n] = torch.ones(s, device=dev)
            elif n.endswith("_beta") or n.endswith("_bias"):
                out[n] = torch.zeros(s, device=dev)
            else:
                out[n] = randn(tuple(s), 100 + i, 0.02)
        return out

    def one_step(sym, mesh, zero=None):
        step = make_train_step(sym, optimizer="sgd", ctx=ctx, mesh=mesh,
                               optimizer_params={"momentum": 0.9},
                               optimizer_sharding=zero)
        state = step.init_state(None, shapes, arg_params=params_for(sym))
        placed = step.place_batch(feed)
        sync()
        c0 = kcounts()
        t = time.perf_counter()
        state, _ = step(state, placed, MESH_TRAIN["lr"], 0)
        sync()
        ms = (time.perf_counter() - t) * 1e3
        calls = since(c0)
        full = step._global_state(state)[0]
        return ({n: v.detach().cpu() for n, v in full.items()}, ms,
                calls, len(full))

    arch = dict(num_layers=MESH_TRAIN["layers"], num_heads=heads, dim=dim)
    dense = transformer.get_symbol(V, S, **arch)
    cases = (("data2", dense, {"data": world}, None),
             ("data2_zero1", dense, {"data": world}, "zero1"),
             ("sp2", transformer.get_symbol(V, S, seq_axis="sp", **arch),
              {"sp": world}, None),
             # capacity factor = E: no token drops in either form, so the
             # per-rank and the one-rank routing compute the same function
             ("expert2", transformer.get_symbol(
                 V, S, num_experts=4, expert_axis="expert",
                 moe_capacity_factor=4.0, **arch), {"expert": world}, None))
    after = {}
    for name, sym, axes, zero in cases:
        staged = telemetry.counter(_comm.STAGED_BYTES).value
        after[name], ms, calls, n_params = one_step(sym, make_mesh(axes),
                                                    zero)
        res[name] = {"ms": ms, "staged": telemetry.counter(
            _comm.STAGED_BYTES).value - staged, "kernel_calls": calls,
            "n_params": n_params}
    res["data2_zero1"]["bit_equal"] = all(
        torch.equal(after["data2"][n], after["data2_zero1"][n])
        for n in after["data2"])
    # the one-rank step of the same global batch (no collective): rank 0
    # the dense graph's (data2, data2_zero1), rank 1 the others', at once
    single = {}
    for name, sym, _, _ in cases:
        if rank != (0 if sym is dense else 1):
            continue
        key = id(sym)
        if key not in single:
            single[key] = one_step(sym, None)[0]
        want = single[key]
        res[name]["max_abs_err"] = max(
            float((after[name][n] - want[n]).abs().max()) for n in want)
        res[name]["within"] = all(
            bool(torch.allclose(after[name][n], want[n], **TRAIN_TOL))
            for n in want)
    del after

    laps("train")

    # -- pipeline_from_symbol at pipe=2 over get_stage_symbol --------------
    pd = MESH_TINY["pipe_dim"] if tiny else DIM
    ps = MESH_TINY["pipe_seq"] if tiny else SEQ
    stage = transformer.get_stage_symbol(num_heads=heads, dim=pd)
    arg_shapes, _, _ = stage.infer_shape(data=(MESH_PIPE["mb"], ps, pd))
    stacked = {n: randn((world,) + tuple(s), 200 + i, 0.02)
               for i, (n, s) in enumerate(zip(stage.list_arguments(),
                                              arg_shapes)) if n != "data"}
    stream = randn((MESH_PIPE["micro"], MESH_PIPE["mb"], ps, pd), 9)
    mesh = make_mesh({"pipe": world})
    sync()
    c0 = kcounts()
    t = time.perf_counter()
    o = pipeline_from_symbol(stage, stacked, stream, mesh)
    sync()
    ms = (time.perf_counter() - t) * 1e3
    calls = since(c0)[:2]
    from mxnet_tpu_torch.executor import _graph_eval_fn
    fn = _graph_eval_fn(stage)
    want = []
    for m in range(stream.shape[0]):
        h = stream[m]
        for s in range(world):
            h = fn({**{n: p[s] for n, p in stacked.items()}, "data": h}, {},
                   0, False)[0][0]
        want.append(h)
    res["pipe2"] = {"ms": ms, "o": _rel_err(o, torch.stack(want)),
                    "kernel_calls": calls}

    laps("pipe")
    res["seconds"] = laps.seconds
    res["staged_bytes"] = telemetry.counter(_comm.STAGED_BYTES).value - \
        staged0
    fwd, bwd = att.flash_fwd_cuda, att.flash_bwd_cuda
    res["launches"] = {
        "flash_fwd_cuda": fwd.launches - fwd.launches_f32,
        "flash_bwd_cuda": bwd.launches - bwd.launches_f32,
        "flash_fwd_f32_cuda": fwd.launches_f32,
        "flash_bwd_f32_cuda": bwd.launches_f32,
        "multi_tensor_opt_update_cuda":
            mt.multi_tensor_opt_update_cuda.launches,
        "multi_tensor_norm_finite_cuda":
            mt.multi_tensor_norm_finite_cuda.launches}
    with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_ranks(flag, args_of, world, limit_s):
    """Start ``world`` ranks of this script (``--<flag>=...``) together;
    kill them all at the time limit. Returns their exit codes and logs."""
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--%s=%s" % (flag, args_of(r))], cwd=HERE,
            env=dict(os.environ, OMP_NUM_THREADS="4"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + limit_s
    logs, rcs = [], []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=max(1, deadline - time.time()))
            rcs.append(p.returncode)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            rcs.append("timeout after %d s" % limit_s)
        logs.append(log)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return rcs, logs


def mesh_block_check():
    """The windowed ring's visiting block on the card at the flagship
    shape, in this process: rank 1's queries (rows 1024..2047) against
    rank 0's keys (band offset 1024, window 512: rows past the window
    fully masked), both kernels, bf16 and f32, against their plain
    versions, the backward with an lse cotangent."""
    import torch
    from mxnet_tpu_torch.ops import attention as att
    B, H, T, D = MESH_RING
    Tb = T // 2
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((B * H, Tb, D), generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        attrs = (D ** -0.5, True, MESH_WINDOW, Tb)
        o, lse = att.flash_fwd_cuda(q, k, v, *attrs, want_lse=True)
        ro, rlse = att._flash_fwd_reference(q, k, v, *attrs)
        dlse = torch.randn((B * H, Tb), generator=g, device=dev)
        delta = torch.sum(do.float() * ro.float(), dim=-1) - dlse
        grads = att.flash_bwd_cuda(q, k, v, do, rlse, delta, *attrs)
        want = (att._flash_dq_reference(q, k, v, do, rlse, delta, *attrs),
                *att._flash_dkv_reference(q, k, v, do, rlse, delta, *attrs))
        tol = TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for what, got, ref, t in (("o", o, ro, tol), ("lse", lse, rlse,
                                                      LSE_TOL),
                                  ("dq", grads[0], want[0], tol),
                                  ("dk", grads[1], want[1], tol),
                                  ("dv", grads[2], want[2], tol)):
            err = float((got.float() - ref.float()).abs().max())
            check_close("mesh2 visiting block %s %s (band offset %d, window "
                        "%d)" % (name, what, Tb, MESH_WINDOW), got.float(),
                        ref.float(), t)
            out.append("%s %s %.3g" % (name, what, err))
        masked = int((rlse < -1e29).sum())
        out.append("%s rows fully masked %d" % (name, masked))
    say("mesh2: the windowed ring's visiting block (band offset %d, window "
        "%d) on the card against the plain versions: %s" % (
            Tb, MESH_WINDOW, "; ".join(out)))


def mesh2_phase(device="cuda", tiny=False):
    """Two ranks sharing the card, backend gloo named explicitly, one
    launch with every case:
    the ring at the flagship attention shape (B 8, H 16, T 2048 split
    1024 + 1024, D 128), causal and windowed (512), forward and backward,
    f32 against a one-rank flash call within RING_F32_RTOL of the largest
    magnitude (bf16 reported); moe_ffn at expert=2 (E 4, dim 2048, hidden
    8192, 8192 tokens, f32) against its plain per-rank rule
    (moe_ffn_reference) with the same expert ids; one SGD-momentum step of
    the flagship LM at MESH_TRAIN's 1 layer, float32, batch 2, over data=2 with and
    without zero1 (bit-equal), sp=2 and expert=2 (capacity factor 4: no
    drops), each against the one-rank step of the same global batch within
    TRAIN_TOL; pipeline_from_symbol at pipe=2 over get_stage_symbol (dim
    2048) against the sequential stages. Reports each case's ms and the
    bytes staged through host memory (gloo is no deployment transport).
    Returns the launch counts of both ranks."""
    import tempfile
    out = tempfile.mkdtemp(prefix="mesh2_")
    if device == "cuda":
        mesh_block_check()
    port = _free_port()
    t = time.perf_counter()
    rcs, logs = _launch_ranks(
        "mesh-rank", lambda r: "%d,2,%d,%s,%s,%d" % (
            r, port, out, device, int(tiny)), 2, MESH_RANK_TIMEOUT_S)
    launch_s = time.perf_counter() - t
    if rcs != [0, 0]:
        for r, log in enumerate(logs):
            sys.stderr.write("mesh2 rank %d log (tail):\n%s\n"
                             % (r, log[-6000:]))
        fail("mesh2: the ranks exited %r" % (rcs,))
    res = []
    for r in range(2):
        with open(os.path.join(out, "rank%d.json" % r)) as f:
            res.append(json.load(f))
    r0 = res[0]
    for r, rr in enumerate(res):
        for tag in ("ring_f32_causal", "ring_f32_w%d" % (
                MESH_TINY["window"] if tiny else MESH_WINDOW)):
            bad = {k: v for k, v in rr[tag].items()
                   if k not in ("ms", "kernel_calls") and v > RING_F32_RTOL}
            if bad:
                fail("mesh2 rank %d %s: relative errors %r over %g"
                     % (r, tag, bad, RING_F32_RTOL))
        if rr["moe_ffn"]["o"] > RING_F32_RTOL or \
                not rr["moe_ffn"]["ids_equal"]:
            fail("mesh2 rank %d moe_ffn: %r" % (r, rr["moe_ffn"]))
        if rr["pipe2"]["o"] > RING_F32_RTOL:
            fail("mesh2 rank %d pipe2: relative error %g"
                 % (r, rr["pipe2"]["o"]))
        if not rr["data2_zero1"]["bit_equal"]:
            fail("mesh2 rank %d: zero1 is not bit-equal to the replicated "
                 "update" % r)
    if device == "cuda":
        # each rank's launches by case, from the schedules: the ring (one
        # rotation, causal or window 512) runs rank r's r + 1 visiting
        # blocks, a forward and a backward each; a training step a
        # forward and a backward a layer (the ring's r + 1 a layer under
        # sp) and one multi-tensor update; the pipeline its M + S - 1
        # ticks, a stage forward each
        L = MESH_TRAIN["layers"]
        for r, rr in enumerate(res):
            want = {tag: [r + 1, r + 1] for tag in rr
                    if tag.startswith("ring_")}
            for name in ("data2", "data2_zero1", "sp2", "expert2"):
                per = L * (r + 1 if name == "sp2" else 1)
                want[name] = [per, per, mt_launches(rr[name]["n_params"])]
            want["pipe2"] = [MESH_PIPE["micro"] + 2 - 1, 0]
            got = {k: rr[k]["kernel_calls"] for k in want}
            if got != want:
                fail("mesh2 rank %d: launches by case %r, not %r"
                     % (r, got, want))
            say("mesh2 rank %d: launches by case (flash forward, flash "
                "backward[, multi-tensor update]) %s, as the schedules "
                "give" % (r, json.dumps(got, sort_keys=True)))
    for name in ("sp2", "expert2"):       # checked on rank 1
        for key in ("max_abs_err", "within"):
            r0[name][key] = res[1][name][key]
    for name in ("data2", "data2_zero1", "sp2", "expert2"):
        if not r0[name]["within"]:
            fail("mesh2 %s: the step's parameters differ from the one-rank "
                 "step's by %g (beyond %r)" % (name, r0[name]["max_abs_err"],
                                               TRAIN_TOL))
    for tag in sorted(k for k in r0 if k.startswith("ring_")):
        say("mesh2 %s: %.1f ms forward + backward (rank 0, after a warm-up "
            "call); relative errors against a one-rank flash call: o %.3g, "
            "dq %.3g, dk %.3g, dv %.3g (rank 1: o %.3g); flash forward and "
            "backward launches rank 0 %s, rank 1 %s" % (
                tag, r0[tag]["ms"], r0[tag]["o"], r0[tag]["dq"],
                r0[tag]["dk"], r0[tag]["dv"], res[1][tag]["o"],
                r0[tag]["kernel_calls"], res[1][tag]["kernel_calls"]))
    say("mesh2 moe_ffn (expert=2, %r): %.1f ms; relative error against the "
        "per-rank rule %.3g, expert ids equal, %d of the tokens kept" % (MESH_TINY["moe"] if tiny else MESH_MOE, r0["moe_ffn"]["ms"],
                  r0["moe_ffn"]["o"], r0["moe_ffn"]["kept"]))
    for name in ("data2", "data2_zero1", "sp2", "expert2"):
        say("mesh2 train %s: one step %.1f ms (rank 0), %.1f MB staged; "
            "parameters against the one-rank step max abs err %.3g%s" % (
                name, r0[name]["ms"], r0[name]["staged"] / 1e6,
                r0[name]["max_abs_err"],
                "; bit-equal to data2" if name == "data2_zero1" else ""))
    say("mesh2 pipe2: %.1f ms, relative error against the sequential "
        "stages %.3g" % (r0["pipe2"]["ms"], r0["pipe2"]["o"]))
    say("mesh2: parallel.comm.staged_bytes %d (rank 0), %d (rank 1); the "
        "launch took %.1f s (seconds by section: rank 0 %s, rank 1 %s)" % (
            r0["staged_bytes"], res[1]["staged_bytes"], launch_s,
            r0["seconds"], res[1]["seconds"]))
    launches = {k: r0["launches"][k] + res[1]["launches"][k]
                for k in r0["launches"]}
    say("mesh2: launches of both ranks %s" % ", ".join(
        "%s %d" % kv for kv in sorted(launches.items())))
    if device == "cuda":
        for name in ("flash_fwd_cuda", "flash_bwd_cuda",
                     "flash_fwd_f32_cuda", "flash_bwd_f32_cuda",
                     "multi_tensor_opt_update_cuda"):
            if not launches[name]:
                fail("mesh2: %s was not launched on the mesh path" % name)
    return launches



GSPMD_LAYERS = 2                  # the flagship LM cut to 2 layers
GSPMD_BATCH = 8                   # bench_scaling.py's per-device batch
GSPMD_F32_BATCH = 2               # the float32 parity check, a rank
GSPMD_F32_LR = 0.1                # SGD momentum 0.9 (Queue C 19: not Adam)
GSPMD_RESNET_BATCH = 16           # a rank (bench.py's 128, cut)
GSPMD_GEN_NEW = 8
GSPMD_GEN_BATCH = 8
GSPMD_GEN_LAYERS = 2              # (d): bench_decode's 4 layers cut to 2
GSPMD_LOGIT_TOL = 1e-4            # the near-tie rule of Queue C 9 and 15
RESNET_FLOOR_X = 2.0              # (c): L2 distance against the reorder floor
GSPMD_TP_RULES = (("*_qkv_weight", "tp,None"), ("*_proj_weight", "tp,None"),
                  ("*_fc1_weight", "tp,None"), ("*_fc2_weight", "tp,None"))
GSPMD_TINY = dict(vocab=64, seq=16, heads=2, dim=32, batch=2, resnet=(
    18, 32, 2, 10), gen=(4, 32, 8, 8))


def _gspmd_rank(rank, world, port, out, device, tiny):
    """One rank of gspmd2 (run as ``chip_smoke.py --gspmd-rank=...``):
    (a) bench_scaling.py's GSPMD row at n = 2 and its float32 parity
    check, (b) the tensor-parallel LM, (c) ResNet-50 under data=2 on the
    BatchNorm kernels, (d) Generator over a model axis; results to
    ``out/rank<r>.json``."""
    import torch
    torch.set_num_threads(4)
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config, telemetry
    from mxnet_tpu_torch.generation import Generator
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet, transformer
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import bn_kernels as bnk
    from mxnet_tpu_torch.ops import optimizer_kernels as mt
    from mxnet_tpu_torch.parallel import (SpecLayout, _comm, dist, make_mesh,
                                          make_train_step)

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    dist.init("127.0.0.1:%d" % port, world, rank, backend="gloo",
              timeout=600)
    ctx = mx.gpu(0) if dev.type == "cuda" else mx.cpu()
    T = GSPMD_TINY if tiny else None
    V, S, H, Dm = (T["vocab"], T["seq"], T["heads"], T["dim"]) if tiny \
        else (VOCAB, SEQ, HEADS, DIM)
    L = GSPMD_LAYERS
    fwd, bwd = att.flash_fwd_cuda, att.flash_bwd_cuda
    bn = (bnk.bn_stats_cuda, bnk.bn_apply_cuda, bnk.bn_bwd_reduce_cuda,
          bnk.bn_bwd_dx_cuda)
    mtu, mtn = mt.multi_tensor_opt_update_cuda, \
        mt.multi_tensor_norm_finite_cuda
    for c in (fwd, bwd):
        c.launches = c.launches_f32 = 0
    for c in (mtu, mtn) + bn:
        c.launches = 0
    keys = ("flash_fwd_cuda", "flash_bwd_cuda", "flash_fwd_f32_cuda",
            "flash_bwd_f32_cuda", "multi_tensor_opt_update_cuda",
            "multi_tensor_norm_finite_cuda") + tuple(
                c.__name__ for c in bn)

    def kcounts():
        return dict(zip(keys, (
            fwd.launches - fwd.launches_f32, bwd.launches - bwd.launches_f32,
            fwd.launches_f32, bwd.launches_f32, mtu.launches, mtn.launches)
            + tuple(c.launches for c in bn)))

    path = dict.fromkeys(keys, 0)     # the mesh runs' launches

    def since(c0, on_path=True):
        d = {k: v - c0[k] for k, v in kcounts().items()}
        if on_path:
            for k, v in d.items():
                path[k] += v
        return d

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def staged():
        return telemetry.counter(_comm.STAGED_BYTES).value

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def host(params):
        return {n: v.detach().float().cpu() for n, v in params.items()}

    def compare(got, want):
        """(worst |got - want|, the parameter it is in, all within
        TRAIN_TOL)."""
        err = {n: float((got[n] - want[n]).abs().max()) for n in want}
        worst = max(err, key=err.get)
        within = all(bool(torch.allclose(got[n], want[n], **TRAIN_TOL))
                     for n in want)
        return err[worst], worst, within

    res = {"n_rank": world}
    staged0 = staged()
    laps = Laps()

    # -- (a) bench_scaling.py's GSPMD row at n = 2 -------------------------
    sym = transformer.get_symbol(V, S, num_layers=L, num_heads=H, dim=Dm)
    Bt = T["batch"] if tiny else GSPMD_BATCH
    rng = np.random.RandomState(3)
    toks = rng.randint(0, V, (Bt * world, S)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    feed = {"data": toks, "softmax_label": labels}
    shapes = {k: v.shape for k, v in feed.items()}
    params = random_params(sym, (Bt * world, S), 5)
    n_elems = sum(int(np.prod(v.shape)) for v in params.values())
    mesh = make_mesh({"data": 1, "fsdp": world})
    step = make_train_step(sym, optimizer="adam", ctx=ctx,
                           layout=SpecLayout(mesh),
                           optimizer_sharding="zero1",
                           compute_dtype="bfloat16")
    state = step.init_state(None, shapes, arg_params=params)
    placed = step.place_batch(feed)
    st0 = staged()
    c0 = kcounts()
    state, outs = step(state, placed, TRAIN_LR, 0)          # warm-up
    sync()
    c1 = kcounts()
    t = time.perf_counter()
    for i in range(2):
        state, outs = step(state, placed, TRAIN_LR, i + 1)
    sync()
    ms = (time.perf_counter() - t) / 2 * 1e3
    timed = {k: v - c1[k] for k, v in kcounts().items()}
    since(c0)
    nll, cnt = batch_nll(outs, placed)
    res["row"] = {
        "ms": ms, "tokens_s": Bt * world * S / ms * 1e3,
        "nll": float(nll / cnt), "staged": staged() - st0,
        "timed_calls": timed, "n_params": len(params),
        "param_bytes": sum(v.numel() * v.element_size()
                           for v in state[0].values()),
        "param_bytes_whole": 4 * n_elems,
        "opt_bytes": telemetry.gauge("gspmd.opt_state_bytes_per_dev").value,
        "opt_bytes_whole": 2 * 4 * n_elems,
        "sharded_params": telemetry.gauge("gspmd.sharded_params").value,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9
        if dev.type == "cuda" else 0.0}
    del step, state, outs, placed
    free()

    # the float32 parity check: data x fsdp with zero1 against one rank
    B2 = GSPMD_F32_BATCH * world
    feed2 = {k: v[:B2] for k, v in feed.items()}
    shapes2 = {k: v.shape for k, v in feed2.items()}
    sgd = dict(optimizer="sgd", optimizer_params={"momentum": 0.9}, ctx=ctx)
    step = make_train_step(sym, layout=SpecLayout(mesh),
                           optimizer_sharding="zero1", **sgd)
    state = step.init_state(None, shapes2, arg_params=params)
    st0, c0 = staged(), kcounts()
    state, _ = step(state, step.place_batch(feed2), GSPMD_F32_LR, 0)
    sync()
    calls = since(c0)
    got = host(step._global_state(state)[0])
    res["f32"] = {"calls": calls, "staged": staged() - st0,
                  "opt_local": sum(s.numel() for ss in state[1].values()
                                   for s in ss), "opt_whole": n_elems}
    del step, state
    one = None
    if rank == 0:
        step = make_train_step(sym, **sgd)
        state = step.init_state(None, shapes2, arg_params=params)
        c0 = kcounts()
        state, _ = step(state, feed2, GSPMD_F32_LR, 0)
        sync()
        since(c0, on_path=False)
        one = host(state[0])
        del step, state
        res["f32"]["max_abs_err"], res["f32"]["worst"], \
            res["f32"]["within"] = compare(got, one)
    del got
    free()

    laps("a")

    # -- (b) tensor parallelism: the same float32 LM over tp ---------------
    tp_mesh = make_mesh({"tp": world})
    step = make_train_step(sym, layout=SpecLayout(tp_mesh,
                                                  rules=GSPMD_TP_RULES),
                           **sgd)
    state = step.init_state(None, shapes2, arg_params=params)
    st0, c0 = staged(), kcounts()
    t = time.perf_counter()
    state, _ = step(state, step.place_batch(feed2), GSPMD_F32_LR, 0)
    sync()
    res["tp"] = {"ms": (time.perf_counter() - t) * 1e3, "calls": since(c0),
                 "staged": staged() - st0,
                 "halved": all(
                     state[0][n].shape[0] * world == params[n].shape[0]
                     for n in params if any(
                         n.endswith(r[0][1:]) for r in GSPMD_TP_RULES))}
    got = host(step._global_state(state)[0])
    del step, state
    if rank == 0:
        res["tp"]["max_abs_err"], res["tp"]["worst"], \
            res["tp"]["within"] = compare(got, one)
    del got, one, params
    free()

    laps("b")

    # -- (c) ResNet-50 under data=2 on the BatchNorm kernels ---------------
    rl, img, rb, ncls = T["resnet"] if tiny else (
        50, RESNET_IMAGE, GSPMD_RESNET_BATCH, RESNET_CLASSES)
    rsym = resnet.get_symbol(num_classes=ncls, num_layers=rl,
                             image_shape=(3, img, img))
    n_bn = sum(1 for n in json.loads(rsym.tojson())["nodes"]
               if n["op"] == "BatchNorm")
    rng = np.random.RandomState(11)
    rfeed = {"data": rng.standard_normal((rb * world, 3, img, img))
             .astype(np.float32),
             "softmax_label": rng.randint(0, ncls, (rb * world,))
             .astype(np.float32)}
    rshapes = {k: v.shape for k, v in rfeed.items()}
    config.set_override("MXNET_BN_PALLAS", True)
    # a float32 ResNet-50 step does not reproduce its parameters to
    # TRAIN_TOL when its own rows are reordered (from Xavier at lr 0.1 the
    # first step moves conv0 by up to 0.36: BatchNorm sums rounded in
    # another order flip relu and max-pool near-ties, ~1e-3 in conv0);
    # its moving stats (the forward alone) do. So the moving stats are
    # held to TRAIN_TOL, and the parameters' L2 distance from the one-rank
    # step to RESNET_FLOOR_X times the one-rank step's own distance from
    # the same step on its rows with the halves swapped. The check runs
    # PyTorch's own convolutions (per-sample GEMMs, the same for any
    # batch); cuDNN's, whose algorithms follow the batch size, is reported
    swap = np.concatenate([np.arange(rb, 2 * rb), np.arange(rb)]) \
        if world == 2 else np.arange(rb * world)
    for conv in ("native", "cudnn"):
        torch.backends.cudnn.enabled = conv == "cudnn"
        after = []
        runs = [(make_mesh({"data": world}), rfeed)]
        if rank == 0:
            runs.append((None, rfeed))
            if conv == "native":
                runs.append((None, {k: v[swap] for k, v in rfeed.items()}))
        for mesh_r, batch in runs:
            step = make_train_step(rsym, mesh=mesh_r, **sgd)
            mx.random.seed(7)
            state = step.init_state(Xavier(factor_type="in", magnitude=2.0),
                                    rshapes)
            st0, c0 = staged(), kcounts()
            t = time.perf_counter()
            state, _ = step(state, step.place_batch(batch), RESNET_LR, 0)
            sync()
            ms = (time.perf_counter() - t) * 1e3
            calls = since(c0, on_path=mesh_r is not None)
            full = step._global_state(state)
            after.append({**host(full[0]), **{
                "aux " + n: v for n, v in host(full[2]).items()}})
            if mesh_r is not None:
                res["resnet_" + conv] = {"ms": ms, "calls": calls,
                                         "n_bn": n_bn,
                                         "staged": staged() - st0}
            del step, state, full
            free()
        if rank == 0:
            r = res["resnet_" + conv]
            r["max_abs_err"], r["worst"], r["within"] = compare(after[0],
                                                               after[1])
            if conv == "native":
                params_ = [n for n in after[1] if not n.startswith("aux ")]

                def l2(a, b):
                    return float(torch.sqrt(sum(
                        ((a[n] - b[n]).double() ** 2).sum()
                        for n in params_)))
                r["l2"] = l2(after[0], after[1])
                r["floor_l2"] = l2(after[2], after[1])
                r["floor_max"], r["floor_worst"], _ = compare(after[2],
                                                              after[1])
                r["over_tol"] = sum(1 for n in params_ if not torch.allclose(
                    after[0][n], after[1][n], **TRAIN_TOL))
                r["floor_over_tol"] = sum(
                    1 for n in params_ if not torch.allclose(
                        after[2][n], after[1][n], **TRAIN_TOL))
                r["n_params"] = len(params_)
                r["aux_within"] = all(
                    torch.allclose(after[0][n], after[1][n], **TRAIN_TOL)
                    for n in after[1] if n.startswith("aux "))
                r["within"] = r["aux_within"] and \
                    r["l2"] <= RESNET_FLOOR_X * r["floor_l2"]
        del after
    torch.backends.cudnn.enabled = True
    config.set_override("MXNET_BN_PALLAS", None)
    free()

    laps("c")

    # -- (d) Generator over a model axis ---------------------------------
    gl, ml, gb, gp = T["gen"] if tiny else (
        GSPMD_GEN_LAYERS, GEN_MAX_LEN, GSPMD_GEN_BATCH, GEN_PROMPT)
    arch = dict(num_layers=gl, num_heads=H, dim=Dm, ffn_hidden=4 * Dm)
    gsym = transformer.get_symbol(V, ml, **arch)
    mx.random.seed(0)
    gparams = make_train_step(gsym, optimizer="sgd", ctx=ctx).init_state(
        Xavier(), {"data": (gb, ml), "softmax_label": (gb, ml)})[0]
    new = T["gen"][3] if tiny else GSPMD_GEN_NEW
    prompt = np.random.RandomState(13).randint(0, V, (gb, gp))
    gen = Generator(gparams, V, ml, batch_size=gb, ctx=ctx,
                    mesh=make_mesh({"model": world}), **arch)
    one = Generator(gparams, V, ml, batch_size=gb, ctx=ctx, **arch)
    gen.generate(prompt, 2)                                   # warm-up
    sync()
    st0 = staged()
    t = time.perf_counter()
    toks = gen.generate(prompt, new)
    sync()
    ms = (time.perf_counter() - t) * 1e3
    st1 = staged()
    want = one.generate(prompt, new)
    rows = [int(r) for r in np.nonzero((toks != want).any(axis=1))[0]]
    worst = 0.0
    for r in rows:
        i = int(np.nonzero(toks[r] != want[r])[0][0])
        prefix = toks[:, :i]
        lg = gen._forward(gen._fresh_aux(), prefix, 0)[0][r, -1]
        lo = one._forward(one._fresh_aux(), prefix, 0)[0][r, -1]
        worst = max(worst, float((lg.float() - lo.float()).abs().max()))
    res["gen"] = {"ms": ms, "ms_token": ms / new, "rows_equal": gb - len(rows),
                  "rows": gb, "logit_err": worst, "staged": st1 - st0,
                  "qkv_local": list(gen._params["layer0_qkv_weight"].shape),
                  "cache": list(next(iter(gen._fresh_aux().values()))
                                .shape)}
    del gen, one, gparams
    free()

    laps("d")
    res["seconds"] = laps.seconds
    res["staged_bytes"] = staged() - staged0
    res["launches"] = path
    with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


def gspmd2_phase(device="cuda", tiny=False):
    """Two ranks sharing the card, backend gloo named explicitly, one
    launch with every case (rank 0's figures; the ranks' launch counts
    from the kernel wrappers' counters):
    (a) bench_scaling.py --full-size's GSPMD row at n = 2: the flagship
    LM at full width cut to 2 layers, make_mesh({'data': 1, 'fsdp': 2}),
    SpecLayout(mesh) at the default MXNET_FSDP_MIN_SIZE, Adam with
    optimizer_sharding='zero1', bf16, batch 8 a rank: one warm step and 2
    timed; a finite loss, parameters and Adam state at 1/2 a rank, the
    flash kernels twice and the multi-tensor update once a rank a step;
    then in float32 at batch 2 a rank one SGD-momentum step against the
    one-rank step of the same 4 rows within TRAIN_TOL (the exact-f32
    flash kernels); (b) the same float32 LM under make_mesh({'tp': 2})
    with the qkv/proj/fc1/fc2 weights 'tp,None' (column-parallel): one
    step against the one-rank step, each rank holding half of those
    weights; (c) ResNet-50 under data=2 with MXNET_BN_PALLAS=1, float32,
    batch 16 a rank: parameters and moving stats after one SGD-momentum
    step against the one-rank step of the 32 rows, each BatchNorm kernel
    once a BatchNorm a rank; (d) Generator(mesh=make_mesh({'model': 2}))
    on bench_decode's model in float32: generate of 32 tokens equal to
    the one-rank generate, or within GSPMD_LOGIT_TOL of its logits at the
    first differing step (a near-tie), and ms a token. The times measure
    gloo over host memory, not a deployment. Returns the launch counts of
    both ranks."""
    import tempfile
    out = tempfile.mkdtemp(prefix="gspmd2_")
    port = _free_port()
    t = time.perf_counter()
    rcs, logs = _launch_ranks(
        "gspmd-rank", lambda r: "%d,2,%d,%s,%s,%d" % (
            r, port, out, device, int(tiny)), 2, MESH_RANK_TIMEOUT_S)
    launch_s = time.perf_counter() - t
    if rcs != [0, 0]:
        for r, log in enumerate(logs):
            sys.stderr.write("gspmd2 rank %d log (tail):\n%s\n"
                             % (r, log[-6000:]))
        fail("gspmd2: the ranks exited %r" % (rcs,))
    res = []
    for r in range(2):
        with open(os.path.join(out, "rank%d.json" % r)) as f:
            res.append(json.load(f))
    r0 = res[0]
    row = r0["row"]
    gen = r0["gen"]
    say("gspmd2 (a) GSPMD row (flagship LM, %d layers, data=1 x fsdp=2, "
        "SpecLayout, Adam zero1, bf16, batch %d a rank): %.1f ms a step "
        "(rank 0, 2 timed steps after a warm-up), %.0f tokens/s over both "
        "ranks, loss %.4f, parameters %d of %d bytes a rank, Adam state %d "
        "of %d bytes a rank, %d sharded parameters, %.1f MB staged a "
        "step, peak %.2f GB" % (
            GSPMD_LAYERS, GSPMD_TINY["batch"] if tiny else GSPMD_BATCH,
            row["ms"],
            row["tokens_s"], row["nll"], row["param_bytes"],
            row["param_bytes_whole"], row["opt_bytes"],
            row["opt_bytes_whole"], row["sharded_params"],
            row["staged"] / 3e6, row["peak_gb"]))
    say("gspmd2 (a) float32 parity (batch %d a rank, SGD momentum, zero1: "
        "%d of %d state elements a rank): max abs err %.3g (%s) against "
        "the one-rank step" % (GSPMD_F32_BATCH, r0["f32"]["opt_local"],
                               r0["f32"]["opt_whole"],
                               r0["f32"]["max_abs_err"], r0["f32"]["worst"]))
    say("gspmd2 (b) tp=2 (qkv/proj/fc1/fc2 column-parallel): one step %.1f "
        "ms, %.1f MB staged, max abs err %.3g (%s) against the one-rank "
        "step" % (r0["tp"]["ms"], r0["tp"]["staged"] / 1e6,
                  r0["tp"]["max_abs_err"], r0["tp"]["worst"]))
    for conv in ("native", "cudnn"):
        rr = r0["resnet_" + conv]
        say("gspmd2 (c) ResNet-50 data=2 on the BatchNorm kernels (batch %d "
            "a rank, f32, %s convolutions): one step %.1f ms, %.1f MB "
            "staged, max abs err %.3g (%s) against the one-rank step "
            "(parameters and moving stats)%s" % (
                GSPMD_TINY["resnet"][2] if tiny else GSPMD_RESNET_BATCH,
                conv, rr["ms"], rr["staged"] / 1e6, rr["max_abs_err"],
                rr["worst"], "; L2 over the parameters %.4g, %d of %d "
                "beyond %r; the one-rank step on its rows with the halves "
                "swapped: max %.3g (%s), L2 %.4g, %d beyond; the moving "
                "stats within: %s" % (
                    rr["l2"], rr["over_tol"], rr["n_params"], TRAIN_TOL,
                    rr["floor_max"], rr["floor_worst"], rr["floor_l2"],
                    rr["floor_over_tol"], rr["aux_within"])
                if conv == "native" else " (reported: cuDNN's algorithms "
                "differ by batch size)"))
    say("gspmd2 (d) Generator model=2 (bench_decode's model at %d layers, "
        "f32, batch %d):"
        " %d new tokens in %.1f ms (%.2f ms a token, prefill included), "
        "%d of %d rows equal to the one-rank generate (logits at the first "
        "differing step within %.3g), %.1f MB staged; qkv weight a rank %r,"
        " a cache a rank %r" % (
            GSPMD_GEN_LAYERS if not tiny else GSPMD_TINY["gen"][0],
            gen["rows"], GSPMD_GEN_NEW if not tiny else GSPMD_TINY["gen"][3],
            gen["ms"], gen["ms_token"], gen["rows_equal"], gen["rows"],
            gen["logit_err"], gen["staged"] / 1e6, gen["qkv_local"],
            gen["cache"]))
    say("gspmd2: parallel.comm.staged_bytes %d (rank 0), %d (rank 1); the "
        "launch took %.1f s (seconds by section: rank 0 %s, rank 1 %s)" % (
            r0["staged_bytes"], res[1]["staged_bytes"], launch_s,
            r0["seconds"], res[1]["seconds"]))
    if not np.isfinite(row["nll"]):
        fail("gspmd2 (a): the loss is not finite: %r" % row["nll"])
    for what, got, whole in (("parameter", row["param_bytes"],
                              row["param_bytes_whole"]),
                             ("Adam state", row["opt_bytes"],
                              row["opt_bytes_whole"])):
        # at full width every parameter has over MXNET_FSDP_MIN_SIZE
        # elements and an even dim (the toy sizes keep small ones whole)
        if got * 2 != whole and not tiny:
            fail("gspmd2 (a): each rank holds %d %s bytes, not 1/2 of %d"
                 % (got, what, whole))
    for name in ("f32", "tp", "resnet_native"):
        if not r0[name]["within"]:
            fail("gspmd2 %s: the step's parameters differ from the one-rank "
                 "step's by %g in %s (beyond %r%s)" % (
                     name, r0[name]["max_abs_err"], r0[name]["worst"],
                     TRAIN_TOL, "" if name != "resnet_native" else
                     "; or the moving stats beyond it, or the parameters' "
                     "L2 distance beyond %g x the one-rank step's own under "
                     "a reordering of its rows" % RESNET_FLOOR_X))
    if not r0["tp"]["halved"]:
        fail("gspmd2 (b): a rank does not hold half of each tp weight")
    if gen["rows_equal"] < gen["rows"] and \
            not gen["logit_err"] <= GSPMD_LOGIT_TOL:
        fail("gspmd2 (d): %d of %d rows differ from the one-rank generate, "
             "with logits %g apart at the first differing step (beyond %g)"
             % (gen["rows"] - gen["rows_equal"], gen["rows"],
                gen["logit_err"], GSPMD_LOGIT_TOL))
    if device == "cuda":
        L = GSPMD_LAYERS
        for r, rr in enumerate(res):
            want = {"row": [2 * L, 2 * L, 2 * mt_launches(
                rr["row"]["n_params"])],
                "f32": [L, L], "tp": [L, L],
                "resnet": [rr["resnet_native"]["n_bn"]] * 8}
            got = {"row": [rr["row"]["timed_calls"][k] for k in (
                "flash_fwd_cuda", "flash_bwd_cuda",
                "multi_tensor_opt_update_cuda")],
                "f32": [rr["f32"]["calls"][k] for k in (
                    "flash_fwd_f32_cuda", "flash_bwd_f32_cuda")],
                "tp": [rr["tp"]["calls"][k] for k in (
                    "flash_fwd_f32_cuda", "flash_bwd_f32_cuda")],
                "resnet": [rr["resnet_" + conv]["calls"][k]
                           for conv in ("native", "cudnn") for k in (
                               "bn_stats_cuda", "bn_apply_cuda",
                               "bn_bwd_reduce_cuda", "bn_bwd_dx_cuda")]}
            if got != want:
                fail("gspmd2 rank %d: launches by case %r, not %r"
                     % (r, got, want))
            say("gspmd2 rank %d: launches by case (row: 2 timed steps' "
                "flash forward, backward, multi-tensor update; f32 and tp: "
                "exact-f32 flash forward, backward; resnet: the four "
                "BatchNorm kernels) %s, as the schedules give"
                % (r, json.dumps(got, sort_keys=True)))
    launches = {k: r0["launches"][k] + res[1]["launches"][k]
                for k in r0["launches"]}
    say("gspmd2: launches of both ranks %s" % ", ".join(
        "%s %d" % kv for kv in sorted(launches.items())))
    if device == "cuda":
        for name in ("flash_fwd_cuda", "flash_bwd_cuda",
                     "flash_fwd_f32_cuda", "flash_bwd_f32_cuda",
                     "multi_tensor_opt_update_cuda", "bn_stats_cuda",
                     "bn_apply_cuda", "bn_bwd_reduce_cuda",
                     "bn_bwd_dx_cuda"):
            if not launches[name]:
                fail("gspmd2: %s was not launched on the path" % name)
    return launches


# ---------------------------------------------------------------------------
# kvdist2: the distributed KVStores on ResNet-50's Module.fit
# ---------------------------------------------------------------------------

KV_BATCH = 64                     # a worker's rows: bench.py's 128, split
KV_SYNC_STEPS = 3                 # (a): a warm step and 2 timed
KV_SYNC_CHECK = 2                 # (a): the parameters held after 2 steps
KV_ASYNC_STEPS = 2                # (b): steps a worker
KV_ALONE_STEPS = 1                # (b): one worker alone, deterministic
KV_TINY = dict(layers=18, image=32, batch=2, classes=10)
# (a) against the one-process rank-ordered sum: the same gradients summed
# in the same order and the same update, so bit-equal is expected; held
# to TRAIN_TOL. (b)'s lone worker against kvstore 'local': the server's
# update on the host against the store's on the card, float32
KV_ALONE_TOL = TOL["float32"]
EAGER_US = {}                     # the executor phase's eager_dispatch_us


def _kv_sizes(tiny):
    """(layers, image, a worker's batch, classes)."""
    if tiny:
        return (KV_TINY["layers"], KV_TINY["image"], KV_TINY["batch"],
                KV_TINY["classes"])
    return RESNET_LAYERS, RESNET_IMAGE, KV_BATCH, RESNET_CLASSES


def _kv_optimizer(names, rescale):
    """SGD momentum 0.9, wd 1e-4 on every parameter (TrainStep's rule, so
    the server's updater, which sees hashed keys, applies the same wd),
    lr RESNET_LR."""
    from mxnet_tpu_torch import optimizer as opt
    o = opt.create("sgd", learning_rate=RESNET_LR,
                   param_idx2name=dict(enumerate(names)), momentum=0.9,
                   wd=1e-4, rescale_grad=rescale)
    o.set_wd_mult({n: 1.0 for n in names})
    return o


def _kv_module(mx, sym, ctx, out, B, S):
    """A Module bound at a worker's batch (B x 3 x S x S) with the phase's
    initial weights (out/init-0000.params)."""
    _, args, auxs = mx.model.load_checkpoint(os.path.join(out, "init"), 0)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (B, 3, S, S))], [("softmax_label", (B,))])
    mod.init_params(None, arg_params=args, aux_params=auxs)
    return mod


def _kv_rows(out, rank, B, steps):
    """A worker's rows of the phase's first ``steps`` global batches."""
    X = np.load(os.path.join(out, "X.npy"), mmap_mode="r")
    Y = np.load(os.path.join(out, "Y.npy"))
    rows = slice(rank * B, (rank + 1) * B)
    return (np.ascontiguousarray(X[:steps, rows]).reshape(
        (steps * B,) + X.shape[2:]), Y[:steps, rows].reshape(-1))


def _kv_rank(rank, world, port, ps_port, out, device, tiny):
    """One worker of kvdist2 (``chip_smoke.py --kv-rank=...``): (a)
    Module.fit(kvstore='dist_sync') over a gloo group, then (b)
    Module.fit(kvstore='dist_async') against the phase's server; results
    to out/kv<r>.json and out/sync<r>.npz."""
    import gc
    import torch
    torch.set_num_threads(4)
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config, io, telemetry
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import _comm, dist

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    ctx = mx.gpu(0) if cuda else mx.cpu()
    dist.init("127.0.0.1:%d" % port, world, rank, backend="gloo",
              timeout=600)
    layers, S, B, classes = _kv_sizes(tiny)
    sym = resnet.get_symbol(num_classes=classes, num_layers=layers,
                            image_shape=(3, S, S))
    counters = _bn_counters()
    res = {"rank": rank}
    laps = Laps()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def count(name):
        return telemetry.counter(name).value

    config.set_override("MXNET_BN_PALLAS", True)
    torch.backends.cudnn.deterministic = True
    # -- (a) dist_sync ---------------------------------------------------
    X, Y = _kv_rows(out, rank, B, KV_SYNC_STEPS)
    with _deterministic(), ctx:
        mod = _kv_module(mx, sym, ctx, out, B, S)
        names = list(mod._param_names)
        mod.init_optimizer(kvstore="dist_sync",
                           optimizer=_kv_optimizer(names, 1.0 / (B * world)))
        kv = mod._kvstore
        if kv.type != "dist_sync" or kv.num_workers != world or \
                kv.rank != rank or not mod._update_on_kvstore:
            raise RuntimeError("kvdist2 (a): store %s, %d workers, rank %d"
                               % (kv.type, kv.num_workers, kv.rank))
        exe = mod._exec_group.execs[0]
        marks, snap = [], {}

        def cb(param):
            sync()
            if param.nbatch == KV_SYNC_CHECK - 1:
                snap.update({n: exe.arg_dict[n]._data.detach().cpu()
                             .numpy().copy() for n in names})
            marks.append(time.perf_counter())
        sync()
        _reset_counts(counters)
        c0 = {k: count(k) for k in (_comm.STAGED_BYTES, "kvstore.pushes",
                                    "kvstore.pulls", "kvstore.push_bytes")}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        mod.fit(io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore="dist_sync", eval_metric="acc",
                batch_end_callback=cb)
        sync()
        n = KV_SYNC_STEPS
        gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        res["sync"] = {
            "ms": statistics.median(gaps), "all_ms": gaps,
            "staged": (count(_comm.STAGED_BYTES) -
                       c0[_comm.STAGED_BYTES]) / n,
            "pushes": (count("kvstore.pushes") - c0["kvstore.pushes"]) / n,
            "pulls": (count("kvstore.pulls") - c0["kvstore.pulls"]) / n,
            "push_bytes": (count("kvstore.push_bytes") -
                           c0["kvstore.push_bytes"]) / n,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
            else 0.0,
            "bn": {c.__name__: c.launches / n for c in counters},
            "keys": len(names)}
        np.savez(os.path.join(out, "sync%d.npz" % rank), **snap)
        del mod, exe, kv, snap
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    laps("a")

    # -- (b) dist_async --------------------------------------------------
    os.environ.update({"DMLC_PS_ROOT_URI": "127.0.0.1",
                       "DMLC_PS_ROOT_PORT": str(ps_port),
                       "DMLC_NUM_WORKER": str(world),
                       "DMLC_WORKER_ID": str(rank)})
    X, Y = _kv_rows(out, rank, B, KV_ASYNC_STEPS)
    with ctx:
        mod = _kv_module(mx, sym, ctx, out, B, S)
        names = list(mod._param_names)
        mod.init_optimizer(kvstore="dist_async",
                           optimizer=_kv_optimizer(names, 1.0 / B))
        kv = mod._kvstore
        if kv._async_client is None or kv.num_workers != world or \
                kv.rank != rank:
            raise RuntimeError("kvdist2 (b): not a parameter-server client")
        exe = mod._exec_group.execs[0]
        marks = []

        def cb_async(param):
            sync()
            marks.append(time.perf_counter())
        sync()
        _reset_counts(counters)
        c0 = {k: count(k) for k in ("kvstore.push_bytes",
                                    "kvstore.pull_bytes")}
        t = time.perf_counter()
        mod.fit(io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore="dist_async", eval_metric="acc",
                batch_end_callback=cb_async)
        marks.insert(0, t)
        n = KV_ASYNC_STEPS
        probs = exe.outputs[0]._data
        nll = mean_nll(probs, torch.as_tensor(Y[-B:], device=probs.device))
        gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        res["async"] = {
            "ms": statistics.median(gaps), "all_ms": gaps, "nll": nll,
            "push_bytes": (count("kvstore.push_bytes") -
                           c0["kvstore.push_bytes"]) / n,
            "pull_bytes": (count("kvstore.pull_bytes") -
                           c0["kvstore.pull_bytes"]) / n,
            "bn": {c.__name__: c.launches / n for c in counters},
            "op_ms": {op: telemetry.histogram("ps.op_ms." + op).snapshot()
                      for op in ("push", "pull")}}
        # after the last barrier every worker pulls the server's store
        kv.barrier()
        same, digest = True, 0.0
        for name in names:
            raw = np.asarray(kv._async_client.pull(name))
            kv.pull(name, out=exe.arg_dict[name])
            got = exe.arg_dict[name]._data.detach().cpu().numpy()
            same = same and np.array_equal(got, raw)
            digest += float(np.abs(raw.astype(np.float64)).sum())
        res["async"].update(pulled_equal=bool(same), digest=digest)
        kv.close()
    config.set_override("MXNET_BN_PALLAS", None)
    laps("b")
    res["seconds"] = laps.seconds
    with open(os.path.join(out, "kv%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


def _kv_server(out, ps_port, n_workers, tag):
    """A parameter-server process started as tools/launch.py starts one:
    this script under DMLC_ROLE=server, whose import of the package
    re-execs into ps_async.serve_forever (spans into out/<tag>_trace)."""
    env = dict(os.environ, DMLC_ROLE="server", DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(ps_port),
               DMLC_NUM_WORKER=str(n_workers),
               MXNET_KVSTORE_TYPE="dist_async",
               MXNET_TRACE=os.path.join(out, tag + "_trace"),
               OMP_NUM_THREADS="4")
    log = open(os.path.join(out, tag + ".log"), "w")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--kv-server"],
        cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT), log


def _kv_server_done(proc, log, what):
    """Wait for a server to leave (it exits once every worker has); its
    handler spans by name, replays apart."""
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "still serving 120 s after its workers left"
    log.close()
    if rc != 0:
        with open(log.name) as f:
            sys.stderr.write("%s log (tail):\n%s\n" % (what, f.read()[-6000:]))
        fail("kvdist2: %s exited %r" % (what, rc))
    spans = {}
    d = log.name[:-len(".log")] + "_trace"
    for fn in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        with open(os.path.join(d, fn)) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") != "span":
                    continue
                key = rec["name"] + (" (replayed)" if (rec.get("attrs") or
                                                       {}).get("replay")
                                     else "")
                spans[key] = spans.get(key, 0) + 1
    return spans


def _kv_reference(mx, sym, ctx, out, B, S, names, steps):
    """The one-process rank-ordered sum: the same Module's gradients on
    rank 0's rows and on rank 1's, added in rank order, then the same
    update on a 'local' store; the parameters after ``steps``."""
    import torch
    from mxnet_tpu_torch.ndarray import NDArray
    X, Y = (np.load(os.path.join(out, f)) for f in ("X.npy", "Y.npy"))
    mod = _kv_module(mx, sym, ctx, out, B, S)
    exe = mod._exec_group.execs[0]
    kv = mx.kv.create("local")
    kv.set_optimizer(_kv_optimizer(names, 1.0 / (2 * B)))
    for n in names:
        kv.init(n, exe.arg_dict[n])
    from mxnet_tpu_torch import io
    for s in range(steps):
        grads = []
        for r in range(2):
            rows = slice(r * B, (r + 1) * B)
            mod.forward_backward(io.DataBatch(
                data=[mx.nd.array(X[s, rows])],
                label=[mx.nd.array(Y[s, rows])]))
            grads.append({n: exe.grad_dict[n]._data.clone() for n in names})
        for n in names:
            kv.push(n, NDArray(grads[0][n] + grads[1][n]))
            kv.pull(n, out=exe.arg_dict[n])
        del grads
    got = {n: exe.arg_dict[n]._data.detach().cpu().numpy() for n in names}
    del mod, exe, kv
    if ctx.device_type == "gpu":
        torch.cuda.empty_cache()
    return got


def _kv_alone(mx, sym, ctx, out, B, S, ps_port):
    """(b)'s lone worker: ``KV_ALONE_STEPS`` steps of rank 0's rows through
    dist_async against its own server, then the same Module on a 'local'
    store (update on the store); both parameter sets."""
    from mxnet_tpu_torch import io
    X, Y = _kv_rows(out, 0, B, KV_ALONE_STEPS)

    def run(kind):
        mod = _kv_module(mx, sym, ctx, out, B, S)
        names = list(mod._param_names)
        kv = mx.kv.create(kind)
        mod.init_optimizer(kvstore=kv,
                           optimizer=_kv_optimizer(names, 1.0 / B))
        mod.fit(io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore=kv, eval_metric="acc")
        exe = mod._exec_group.execs[0]
        got = {n: exe.arg_dict[n]._data.detach().cpu().numpy()
               for n in names}
        kv.close()
        return got

    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(ps_port),
           "DMLC_NUM_WORKER": "1", "DMLC_WORKER_ID": "0"}
    keep = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        got_async = run("dist_async")
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return got_async, run("local")


def _max_err(got, want):
    """(max |got - want|, its parameter, within TRAIN_TOL, bit-equal)."""
    worst, where, within, same = 0.0, None, True, True
    for n, w in want.items():
        g = got[n]
        same = same and np.array_equal(g, w)
        d = float(np.abs(g.astype(np.float64) - w).max()) if g.size else 0.0
        if d > worst:
            worst, where = d, n
        within = within and np.allclose(g, w, **TRAIN_TOL)
    return worst, where, within, same


def kvdist2_phase(device="cuda", tiny=False):
    """bench.py's ResNet-50 (full width, float32, MXNET_BN_PALLAS=1, SGD
    momentum 0.9, wd 1e-4, lr RESNET_LR) through Module.fit on two worker
    processes of this script sharing the card over gloo (``--kv-rank=``),
    bench.py's batch 128 split 64 + 64, each worker's BatchNorm over its
    own rows; the weights from one seeded init, the batches seeded.
    (a) kvstore='dist_sync': a warm step and 2 timed (ms a step, staged
    bytes, the store's pushes and pulls, peak memory, each BatchNorm
    kernel's launches a step); after 2 steps both workers' parameters
    equal each other and, within TRAIN_TOL (bit-equal expected), one
    process's rank-ordered sum of the same two gradients under the same
    update (deterministic algorithms, cudnn.deterministic). (b)
    kvstore='dist_async' against a server process started as
    tools/launch.py starts one (DMLC_ROLE=server through the package's
    import hook; the host-side apply): 2 steps a worker, every push
    applied once (the server's ps.handle.push spans = workers x steps x
    keys), the final pulls equal to the server's store on both workers,
    a finite loss; ms a step, push and pull bytes a step, the server's
    spans; then one worker alone against a second server, 2 steps,
    against the same Module on a 'local' store within KV_ALONE_TOL.
    Returns both workers' kernel launches."""
    import gc
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet

    cuda = device == "cuda"
    ctx = mx.gpu(0) if cuda else mx.cpu()
    out = tempfile.mkdtemp(prefix="kvdist2_")
    layers, S, B, classes = _kv_sizes(tiny)
    t0 = time.perf_counter()
    sym = resnet.get_symbol(num_classes=classes, num_layers=layers,
                            image_shape=(3, S, S))
    with ctx:
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind([("data", (B, 3, S, S))], [("softmax_label", (B,))])
        mx.random.seed(0)
        mod.init_params(Xavier(factor_type="in", magnitude=2.0))
        args, auxs = mod.get_params()
        mx.model.save_checkpoint(os.path.join(out, "init"), 0, sym, args,
                                 auxs)
        names = list(mod._param_names)
        nparam = sum(int(np.prod(a.shape)) for a in args.values())
        del mod, args, auxs
    rng = np.random.RandomState(30)
    steps = max(KV_SYNC_STEPS, KV_ASYNC_STEPS)
    np.save(os.path.join(out, "X.npy"), rng.standard_normal(
        (steps, 2 * B, 3, S, S)).astype(np.float32))
    np.save(os.path.join(out, "Y.npy"), rng.randint(
        0, classes, (steps, 2 * B)).astype(np.float32))
    say("kvdist2: ResNet-%d %d params (%.1f M, %d keys), float32, "
        "MXNET_BN_PALLAS=1, SGD momentum 0.9 wd 1e-4 lr %g, batch %d a "
        "worker x 2 workers sharing the card over gloo; set up in %.1f s"
        % (layers, nparam, nparam / 1e6, len(names), RESNET_LR, B,
           time.perf_counter() - t0))

    servers = []
    try:
        port, ps_port, ps_alone = _free_port(), _free_port(), _free_port()
        server, slog = _kv_server(out, ps_port, 2, "server")
        servers.append(server)
        t = time.perf_counter()
        rcs, logs = _launch_ranks(
            "kv-rank", lambda r: "%d,2,%d,%d,%s,%s,%d" % (
                r, port, ps_port, out, device, int(tiny)), 2,
            MESH_RANK_TIMEOUT_S)
        launch_s = time.perf_counter() - t
        if rcs != [0, 0]:
            for r, log in enumerate(logs):
                sys.stderr.write("kvdist2 worker %d log (tail):\n%s\n"
                                 % (r, log[-6000:]))
            fail("kvdist2: the workers exited %r" % (rcs,))
        spans = _kv_server_done(server, slog, "the dist_async server")
        res = []
        for r in range(2):
            with open(os.path.join(out, "kv%d.json" % r)) as f:
                res.append(json.load(f))
        snaps = []
        for r in range(2):
            with np.load(os.path.join(out, "sync%d.npz" % r)) as f:
                snaps.append({k: f[k] for k in f.files})

        # -- (a)'s checks --------------------------------------------------
        config.set_override("MXNET_BN_PALLAS", True)
        t = time.perf_counter()
        with _deterministic(), ctx:
            torch.backends.cudnn.deterministic = True
            want = _kv_reference(mx, sym, ctx, out, B, S, names,
                                 KV_SYNC_CHECK)
        ref_s = time.perf_counter() - t
        workers_same = all(np.array_equal(snaps[0][n], snaps[1][n])
                           for n in names)
        err, where, within, same = _max_err(snaps[0], want)
        s0 = res[0]["sync"]
        say("kvdist2 (a) dist_sync: %.1f ms a step (rank 0, median of %d "
            "timed after a warm step; all %s; rank 1 %.1f), %.1f MB staged "
            "a step, %.0f pushes and %.0f pulls a step (%d keys), %.1f MB "
            "pushed a step, peak %.2f GB (rank 1 %.2f); BatchNorm kernels a "
            "worker step %s" % (
                s0["ms"], KV_SYNC_STEPS - 1,
                " ".join("%.1f" % g for g in s0["all_ms"]),
                res[1]["sync"]["ms"], s0["staged"] / 1e6, s0["pushes"],
                s0["pulls"], s0["keys"], s0["push_bytes"] / 1e6,
                s0["peak_gb"], res[1]["sync"]["peak_gb"],
                json.dumps(s0["bn"], sort_keys=True)))
        say("kvdist2 (a): after %d steps the two workers' %d parameters "
            "%s; against the one-process rank-ordered sum: max abs err %.3g "
            "(%s), %s" % (
                KV_SYNC_CHECK, len(names),
                "are equal" if workers_same else "DIFFER", err, where,
                "bit-equal" if same else "within %r: %s" % (TRAIN_TOL,
                                                            within)))
        if not workers_same:
            fail("kvdist2 (a): the workers' parameters differ after %d "
                 "dist_sync steps" % KV_SYNC_CHECK)
        if not within:
            fail("kvdist2 (a): the workers' parameters differ from the "
                 "one-process rank-ordered sum by %g in %s (beyond %r)"
                 % (err, where, TRAIN_TOL))
        del want, snaps
        gc.collect()

        # -- (b)'s checks --------------------------------------------------
        a0, a1 = res[0]["async"], res[1]["async"]
        applied = spans.get("ps.handle.push", 0)
        want_pushes = 2 * KV_ASYNC_STEPS * len(names)
        say("kvdist2 (b) dist_async: %.1f ms a step (rank 0, %d steps; all "
            "%s; rank 1 %.1f), %.1f MB pushed and %.1f MB pulled a step a "
            "worker, loss %.4f / %.4f; push p50 %s ms, pull p50 %s ms; the "
            "server's spans %s; the launch took %.1f s (seconds by section: "
            "worker 0 %s, worker 1 %s)" % (
                a0["ms"], KV_ASYNC_STEPS, " ".join("%.1f" % g
                                                   for g in a0["all_ms"]),
                a1["ms"], a0["push_bytes"] / 1e6, a0["pull_bytes"] / 1e6,
                a0["nll"], a1["nll"], a0["op_ms"]["push"].get("p50"),
                a0["op_ms"]["pull"].get("p50"),
                json.dumps(spans, sort_keys=True), launch_s,
                res[0]["seconds"], res[1]["seconds"]))
        if applied != want_pushes or spans.get("ps.handle.push (replayed)"):
            fail("kvdist2 (b): the server applied %d pushes (%d replays "
                 "served), not %d workers x %d steps x %d keys"
                 % (applied, spans.get("ps.handle.push (replayed)", 0), 2,
                    KV_ASYNC_STEPS, len(names)))
        if not (a0["pulled_equal"] and a1["pulled_equal"]) or \
                a0["digest"] != a1["digest"]:
            fail("kvdist2 (b): after the final barrier the workers' pulls "
                 "differ from the server's store or from each other (%r, "
                 "%r, digests %r %r)" % (a0["pulled_equal"],
                                         a1["pulled_equal"], a0["digest"],
                                         a1["digest"]))
        if not (np.isfinite(a0["nll"]) and np.isfinite(a1["nll"])):
            fail("kvdist2 (b): the loss is not finite: %r %r"
                 % (a0["nll"], a1["nll"]))
        t = time.perf_counter()
        alone, alog = _kv_server(out, ps_alone, 1, "alone")
        servers.append(alone)
        with _deterministic(), ctx:
            torch.backends.cudnn.deterministic = True
            got_async, got_local = _kv_alone(mx, sym, ctx, out, B, S,
                                             ps_alone)
        alone_spans = _kv_server_done(alone, alog, "the lone worker's "
                                      "server")
        alone_s = time.perf_counter() - t
        worst, where = 0.0, None
        for n, w in got_local.items():
            d = float(np.abs(got_async[n].astype(np.float64) - w).max())
            if d > worst:
                worst, where = d, n
        ok = all(np.allclose(got_async[n], w, **KV_ALONE_TOL)
                 for n, w in got_local.items())
        say("kvdist2 (b): one worker alone against a server, steps: %d "
            "(deterministic): max abs err %.3g (%s) against the same Module "
            "on a 'local' store (update on the store), %s %r; the server's "
            "pushes %d; %.1f s (the one-process reference of (a) %.1f s)" % (
                KV_ALONE_STEPS, worst, where, "within" if ok else "BEYOND",
                KV_ALONE_TOL, alone_spans.get("ps.handle.push", 0), alone_s,
                ref_s))
        if not ok:
            fail("kvdist2 (b): the lone dist_async worker lands %g from "
                 "kvstore 'local' in %s (beyond %r)"
                 % (worst, where, KV_ALONE_TOL))
    finally:
        for proc in servers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        config.set_override("MXNET_BN_PALLAS", None)
        torch.backends.cudnn.deterministic = False
        import shutil
        shutil.rmtree(out, ignore_errors=True)
    launches = {}
    for rr in res:
        for part in ("sync", "async"):
            steps_ = KV_SYNC_STEPS if part == "sync" else KV_ASYNC_STEPS
            for k, v in rr[part]["bn"].items():
                launches[k] = launches.get(k, 0) + int(round(v * steps_))
    if cuda:
        n_bn = sum(n["op"] == "BatchNorm"
                   for n in json.loads(sym.tojson())["nodes"])
        for r, rr in enumerate(res):
            for part in ("sync", "async"):
                if any(v != n_bn for v in rr[part]["bn"].values()):
                    fail("kvdist2 rank %d (%s): BatchNorm kernel launches a "
                         "step %r, not %d" % (r, part, rr[part]["bn"], n_bn))
    say("kvdist2: launches of both workers %s" % ", ".join(
        "%s %d" % kv for kv in sorted(launches.items())))
    return launches


# ---------------------------------------------------------------------------
# profiler: mx.profiler over torch.profiler on the card
# ---------------------------------------------------------------------------

PROFILE_BN = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")
PROFILE_STEPS = 2                 # traced steps, each between two markers
PROFILE_FLASH = ("flash_fwd_bf16", "flash_bwd_bf16")


def _device_kernels(path, keys):
    """The kernel records of a Chrome trace that profiler_set_state wrote,
    split at the marker kernels (torch.cuda._sleep) the phase launches
    around each traced step: ([{key: kernels of the step whose name holds
    it}, ...], kernel records in all). bn_finalize, the stats kernels'
    second launch, is left out. The profiler can lose records at the
    start of a trace, so a step counts only between two markers."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    kernels = sorted((e for e in evs if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    steps, cur = [], None
    for e in kernels:
        name = e.get("name", "")
        if "spin_kernel" in name:
            if cur is not None:
                steps.append(cur)
            cur = {k: 0 for k in keys}
        elif cur is not None:
            for k in keys:
                cur[k] += k in name and "finalize" not in name
    return steps, len(kernels)


def profiler_phase(device="cuda", tiny=False):
    """mx.profiler on the card, each case traced for PROFILE_STEPS steps
    with a marker kernel around each (a step counts in the device trace
    only between two markers: the profiler can lose records at a trace's
    start): (a) kvdist2 (a)'s Module step (ResNet-50, float32, batch 64,
    the BatchNorm kernels) under profiler_set_config(mode='symbolic',
    xplane_dir=...): the host dump holds the Executor's forward and
    backward events and no operator event, a whole step of the device
    trace names the four BatchNorm kernels once a BatchNorm each, and
    their counters count as much a step; (b) the flagship LM's bf16 step
    (TrainStep, 4 layers, batch 8 x 2048) under mode='all': a whole step
    names flash_fwd_bf16 and flash_bwd_bf16 once a layer each, as their
    counters count, and the host dump holds the step markers; (c) the
    eager host us an op call with the profiler stopped against the same
    call without the dispatch site's check, in turns (eager_site_ab,
    measured by the executor phase beside its eager_dispatch_us, or here
    in a partial run). Returns the profiled steps' launches."""
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config, io, profiler
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet, transformer
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.parallel import make_train_step

    cuda = device == "cuda"
    ctx = mx.gpu(0) if cuda else mx.cpu()
    tmp = tempfile.mkdtemp(prefix="profiler_")
    launches = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run(what, mode, fn):
        """fn twice under the profiler, a marker kernel before, between
        and after (the first takes what the trace loses at its start);
        (host events, device trace)."""
        xdir = os.path.join(tmp, what)
        profiler.profiler_set_config(mode=mode, xplane_dir=xdir,
                                     filename=os.path.join(tmp, what +
                                                           ".json"))
        profiler.profiler_set_state("run")
        try:
            for _ in range(PROFILE_STEPS):
                if cuda:
                    torch.cuda._sleep(1)
                sync()
                fn()
                sync()
            if cuda:
                torch.cuda._sleep(1)
            sync()
        finally:
            profiler.profiler_set_state("stop")
        with open(profiler.dump_profile()) as f:
            host = json.load(f)
        if sorted(host) != ["displayTimeUnit", "telemetry", "traceEvents"]:
            fail("profiler %s: the dump's keys %r" % (what, sorted(host)))
        return host["traceEvents"], profiler._P.device_traces[-1]

    try:
        # -- (a) the Module step, symbolic ---------------------------------
        layers, S, B, classes = _kv_sizes(tiny)
        sym = resnet.get_symbol(num_classes=classes, num_layers=layers,
                                image_shape=(3, S, S))
        n_bn = sum(n["op"] == "BatchNorm"
                   for n in json.loads(sym.tojson())["nodes"])
        config.set_override("MXNET_BN_PALLAS", True)
        rng = np.random.RandomState(31)
        with ctx:
            mod = mx.mod.Module(sym, context=ctx)
            mod.bind([("data", (B, 3, S, S))], [("softmax_label", (B,))])
            mx.random.seed(0)
            mod.init_params(Xavier(factor_type="in", magnitude=2.0))
            names = list(mod._param_names)
            mod.init_optimizer(kvstore=None,
                               optimizer=_kv_optimizer(names, 1.0 / B))
            batch = io.DataBatch(
                data=[mx.nd.array(rng.standard_normal(
                    (B, 3, S, S)).astype(np.float32))],
                label=[mx.nd.array(rng.randint(0, classes, B).astype(
                    np.float32))])

            def module_step():
                with profiler.step_scope(0):
                    mod.forward_backward(batch)
                    mod.update()
            module_step()                               # warm
            sync()
            _reset_counts(_bn_counters())
            host, trace = run("module", "symbolic", module_step)
        counts = {c.__name__: c.launches for c in _bn_counters()}
        config.set_override("MXNET_BN_PALLAS", None)
        names_ = [e["name"] for e in host]
        cats = {e["cat"] for e in host}
        dev, n_kernels = _device_kernels(trace, PROFILE_BN)
        say("profiler (a) Module step (ResNet-%d, float32, batch %d), mode "
            "symbolic, %d steps traced: host events %s; device trace %s: %d "
            "kernel records, by whole step %s; the kernels' counters %s" % (
                layers, B, PROFILE_STEPS, json.dumps(sorted(set(names_))),
                os.path.basename(trace), n_kernels,
                json.dumps(dev, sort_keys=True),
                json.dumps(counts, sort_keys=True)))
        for want in ("executor_forward_train", "executor_backward",
                     "train_step#0"):
            if want not in names_:
                fail("profiler (a): the host dump has no %r event (%r)"
                     % (want, names_))
        if "operator" in cats:
            fail("profiler (a): mode 'symbolic' recorded operator events")
        if cuda:
            whole = {k: n_bn for k in PROFILE_BN}
            if whole not in dev or any(
                    counts[k + "_cuda"] != PROFILE_STEPS * n_bn
                    for k in PROFILE_BN):
                fail("profiler (a): no traced step names each BatchNorm "
                     "kernel %d times (%r), or the counters %r are not %d "
                     "a step" % (n_bn, dev, counts, n_bn))
        launches.update(counts)
        del mod, batch
        if cuda:
            torch.cuda.empty_cache()

        # -- (b) the flagship LM's bf16 step, all ------------------------
        if tiny:
            V, T, L, H, D, Bt = 64, 16, 2, 2, 32, 2
        else:
            V, T, L, H, D, Bt = VOCAB, SEQ, LAYERS, HEADS, DIM, TRAIN_BATCH
        lm = transformer.get_symbol(V, T, num_layers=L, num_heads=H, dim=D,
                                    ffn_hidden=4 * D)
        step = make_train_step(lm, optimizer="adam",
                               optimizer_params={"rescale_grad": 1.0 / Bt},
                               compute_dtype="bfloat16", ctx=ctx)
        toks = rng.randint(0, V, (Bt, T)).astype(np.float32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        mx.random.seed(0)
        state = [step.init_state(Xavier(), {"data": (Bt, T),
                                            "softmax_label": (Bt, T)})]
        placed = step.place_batch({"data": toks, "softmax_label": labels})
        outs = []

        def lm_step():
            with profiler.step_scope(len(outs)):
                state[0], o = step(state[0], placed, TRAIN_LR, len(outs))
            outs.append(mean_nll(o[0], placed["softmax_label"]))
        lm_step()                                       # warm
        sync()
        _reset_flash_counts()
        host, trace = run("lm", "all", lm_step)
        counts = {c.__name__: c.launches for c in _flash_counters()}
        dev, n_kernels = _device_kernels(trace, PROFILE_FLASH)
        names_ = [e["name"] for e in host]
        say("profiler (b) flagship LM bf16 step (%d layers, batch %d x %d), "
            "mode all, %d steps traced: %d host events (%s); device trace "
            "%s: %d kernel records, by whole step %s; the kernels' counters "
            "%s; loss %.4f" % (
                L, Bt, T, PROFILE_STEPS, len(host),
                json.dumps(sorted(set(names_))[:12]),
                os.path.basename(trace), n_kernels,
                json.dumps(dev, sort_keys=True),
                json.dumps(counts, sort_keys=True), outs[-1]))
        if "train_step#2" not in names_:
            fail("profiler (b): the host dump has no step marker (%r)"
                 % names_)
        if not np.isfinite(outs[-1]):
            fail("profiler (b): the loss is not finite: %r" % outs)
        if cuda:
            if {k: L for k in PROFILE_FLASH} not in dev or any(
                    counts[c.__name__] != PROFILE_STEPS * L
                    for c in _flash_counters()):
                fail("profiler (b): no traced step names each bf16 flash "
                     "kernel %d times (%r), or the counters %r are not %d "
                     "a step" % (L, dev, counts, L))
        launches.update(counts)
        del step, state, placed
        if cuda:
            torch.cuda.empty_cache()
    finally:
        config.set_override("MXNET_BN_PALLAS", None)
        profiler.profiler_set_config(mode="symbolic", xplane_dir=None)
        shutil.rmtree(tmp, ignore_errors=True)

    # -- (c) the stopped profiler's cost at the eager dispatch site -------
    if cuda:
        ref = EAGER_US.get("executor")
        runs = EAGER_US.get("ab") or eager_site_ab()
        med = {k: statistics.median(v) for k, v in runs.items()}
        spread = max(runs["bare"]) - min(runs["bare"])
        say("profiler (c): eager host time of one op call with the profiler "
            "stopped %.2f us (median of %d runs: %s), without the dispatch "
            "site's check %.2f us (%s; spread %.2f us), in turns %s; the "
            "executor phase's eager_dispatch_us %s" % (
                med["site"], len(runs["site"]),
                " ".join("%.2f" % u for u in runs["site"]), med["bare"],
                " ".join("%.2f" % u for u in runs["bare"]), spread,
                "right after the executor phase's figure" if "ab" in EAGER_US
                else "in this phase",
                "%.2f us (%.2f recording), %s the site's runs" % (
                    ref[0], ref[1], "within" if min(runs["site"]) <= ref[0]
                    <= max(runs["site"]) else "outside")
                if ref else "not measured in this run"))
        if med["site"] - med["bare"] > spread + 1.0:
            fail("profiler (c): the stopped profiler's check adds %.2f us "
                 "an eager op call, beyond the run-to-run spread %.2f us"
                 % (med["site"] - med["bare"], spread))
    return launches


# ---------------------------------------------------------------------------
# Gluon path
# ---------------------------------------------------------------------------

# (a) the small net held card against CPU
GLUON_SMALL = dict(model="resnet18_v1", classes=10, image=32, batch=8)
# (b) bench.py's image step through Gluon, as upstream MXNet's
# example/gluon/image_classification.py --model resnet50_v1 trains it
GLUON_MODEL, GLUON_BATCH, GLUON_IMAGE, GLUON_CLASSES = ("resnet50_v1", 128,
                                                        224, 1000)
GLUON_LR = 0.1
# resnet50_v1 as the model zoo builds it: 16 bottlenecks x 3, 4
# downsamples and the stem
GLUON_BATCHNORMS = 53
GLUON_WARM, GLUON_TIMED, GLUON_EAGER = 2, 5, 3
# (c) upstream example/gluon/word_language_model at its README's largest
# setting (--emsize 1500 --nhid 1500 --dropout 0.65 --tied), PTB's vocabulary
WLM = dict(vocab=10000, width=1500, layers=2, dropout=0.65, batch=32,
           bptt=35, lr=1.0, clip=0.2)
WLM_SMALL_WIDTH = 64
GLUON_UPDATE_RTOL = 0.1    # (a): cuDNN's float32 rounding (Queue C 8)
GLUON_STAT_RTOL = 1e-3
GLUON_LOSS_RTOL = 1e-4


def _gluon_blocks(block):
    """``block`` and every block under it."""
    yield block
    for child in block._children:
        yield from _gluon_blocks(child)


def _gluon_step(mx, net, loss_fn, trainer, x, y):
    """One Gluon training step: record, loss, backward, Trainer.step."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def _rel_norm(got, want):
    """||got - want|| / ||want|| over the arrays of two dicts (float64)."""
    num = sum(np.sum((got[n].astype(np.float64) - want[n]) ** 2)
              for n in want)
    den = sum(np.sum(want[n].astype(np.float64) ** 2) for n in want)
    return float(np.sqrt(num / max(den, 1e-300)))


def gluon_reference_check():
    """(a) GLUON_SMALL's model from one seed on the CPU and on the card
    (hybridized; and eager on the card), MXNET_BN_PALLAS=1: one forward to
    finish the deferred init, then one step of record -> SoftmaxCE ->
    backward -> Trainer('sgd', momentum 0.9, wd 1e-4).step. The card's
    loss within GLUON_LOSS_RTOL of the CPU's, its gradients and
    parameter updates within GLUON_UPDATE_RTOL and its running stats
    within GLUON_STAT_RTOL (relative, in norm): executor_reference_checks'
    rule for cuDNN's float32 convolutions. The eager step on the card
    equal to the hybridized one (deterministic algorithms) within
    compare_grads' float32 rounding."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config, gluon
    from mxnet_tpu_torch.ops import bn_kernels as bnk

    c = GLUON_SMALL
    B, S = c["batch"], c["image"]
    rng = np.random.RandomState(30)
    x = rng.standard_normal((B, 3, S, S)).astype(np.float32)
    y = rng.randint(0, c["classes"], (B,)).astype(np.float32)

    def run(ctx, hybrid):
        mx.random.seed(3)
        net = gluon.model_zoo.vision.get_model(c["model"],
                                               classes=c["classes"])
        net.initialize(mx.init.Xavier(rnd_type="gaussian",
                                      factor_type="in", magnitude=2),
                       ctx=ctx)
        if hybrid:
            net.hybridize()
        with ctx:
            X, Y = mx.nd.array(x), mx.nd.array(y)
        net(X)      # predict mode: finishes the deferred init
        params = net.collect_params()
        # each net has its own prefix (resnetv10_, resnetv11_ ...): key
        # the parameters by the rest of their names
        k = len(net.prefix)
        before = {n[k:]: p.data().asnumpy() for n, p in params.items()}
        trainer = gluon.Trainer(params, "sgd", {
            "learning_rate": GLUON_LR, "momentum": 0.9, "wd": 1e-4})
        loss = _gluon_step(mx, net, gluon.loss.SoftmaxCrossEntropyLoss(),
                           trainer, X, Y)
        grads = {n[k:]: p.grad().asnumpy() for n, p in params.items()
                 if p.grad_req != "null"}
        after = {n[k:]: p.data().asnumpy() for n, p in params.items()}
        return {"loss": loss.asnumpy(), "grads": grads,
                "updates": {n: after[n] - before[n] for n in grads},
                "stats": {n: after[n] for n in after if n not in grads},
                "after": after}

    config.set_override("MXNET_BN_PALLAS", True)
    before_launches = bnk.bn_stats_cuda.launches
    host = run(mx.cpu(), True)
    with _deterministic():
        card = run(mx.gpu(0), True)
        eager = run(mx.gpu(0), False)
    config.set_override("MXNET_BN_PALLAS", None)
    if bnk.bn_stats_cuda.launches == before_launches:
        fail("gluon (a): the BatchNorm kernels did not run on the card")
    for what, res in (("hybridized", card), ("eager", eager)):
        arrays = [res["loss"]] + list(res["grads"].values()) + list(
            res["after"].values())
        if not all(np.isfinite(a).all() for a in arrays):
            fail("gluon (a): non-finite values on the card (%s)" % what)
    loss_err = float(np.abs(card["loss"] - host["loss"]).max()
                     / np.abs(host["loss"]).max())
    dist = {k: _rel_norm(card[k], host[k])
            for k in ("grads", "updates", "stats")}
    if not (loss_err <= GLUON_LOSS_RTOL and
            dist["grads"] <= GLUON_UPDATE_RTOL and
            dist["updates"] <= GLUON_UPDATE_RTOL and
            dist["stats"] <= GLUON_STAT_RTOL):
        fail("gluon (a): card vs CPU: loss %.3g (limit %g), gradients "
             "%.3g and updates %.3g (limit %g), running stats %.3g (limit "
             "%g), relative" % (loss_err, GLUON_LOSS_RTOL, dist["grads"],
                                dist["updates"], GLUON_UPDATE_RTOL,
                                dist["stats"], GLUON_STAT_RTOL))
    def to_t(arrays):
        return {n: torch.from_numpy(v) for n, v in arrays.items()}
    if not np.allclose(eager["loss"], card["loss"], rtol=GRAD_RTOL,
                       atol=0):
        fail("gluon (a): eager loss %r, hybridized %r" % (
            eager["loss"][:4], card["loss"][:4]))
    n_eq, worst, _ = compare_grads("gluon (a) eager vs hybridized",
                                   to_t(eager["grads"]),
                                   to_t(card["grads"]))
    n_eq_p, worst_p, _ = compare_grads("gluon (a) eager vs hybridized "
                                       "parameters", to_t(eager["after"]),
                                       to_t(card["after"]))
    say("gluon (a): %s (classes %d) %dx3x%dx%d f32, MXNET_BN_PALLAS=1, one "
        "SGD step (momentum 0.9, wd 1e-4): card (cuDNN) vs CPU: loss %.3g "
        "(limit %g), %d gradients %.3g and updates %.3g (limit %g), %d "
        "running stats %.3g (limit %g), relative in norm; eager vs "
        "hybridized on the card: %d/%d gradients and %d/%d parameters "
        "bit-equal, worst abs diff %.3g / %.3g" % (
            c["model"], c["classes"], B, S, S, loss_err, GLUON_LOSS_RTOL,
            len(host["grads"]), dist["grads"], dist["updates"],
            GLUON_UPDATE_RTOL, len(host["stats"]), dist["stats"],
            GLUON_STAT_RTOL, n_eq, len(card["grads"]), n_eq_p,
            len(card["after"]), worst, worst_p))


def gluon_train_run(counters):
    """(b) model_zoo resnet50_v1 at bench.py's image step (batch 128 x
    3x224x224, 1000 classes, SGD momentum 0.9 wd 1e-4 lr 0.1, Xavier
    gaussian in 2), float32, hybridized, MXNET_BN_PALLAS=1, batches from a
    DataLoader over a seeded ArrayDataset: GLUON_WARM steps (the second
    profiled) and GLUON_TIMED timed; then GLUON_EAGER + 1 steps of the
    same net eager. Fails unless each BatchNorm kernel launched once a
    BatchNorm a step on both, the loss is finite and the parameters
    moved. Returns the hybridized run's launch counts."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config, gluon

    B, S, K = GLUON_BATCH, GLUON_IMAGE, GLUON_CLASSES
    t0 = time.perf_counter()
    rng = np.random.RandomState(31)
    X = rng.standard_normal((2 * B, 3, S, S)).astype(np.float32)
    Y = rng.randint(0, K, (2 * B,)).astype(np.float32)
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(X, Y),
                                   batch_size=B, last_batch="discard")
    mx.random.seed(0)
    net = gluon.model_zoo.vision.get_model(GLUON_MODEL, classes=K)
    n_bn = sum(isinstance(b, gluon.nn.BatchNorm) for b in _gluon_blocks(net))
    if n_bn != GLUON_BATCHNORMS:
        fail("gluon (b): %s has %d BatchNorms, not %d"
             % (GLUON_MODEL, n_bn, GLUON_BATCHNORMS))
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": GLUON_LR, "momentum": 0.9, "wd": 1e-4})
    batches = iter(())

    def next_batch():
        nonlocal batches
        batch = next(batches, None)
        if batch is None:
            batches = iter(loader)
            batch = next(batches)
        return batch

    config.set_override("MXNET_BN_PALLAS", True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cnt in counters:
        cnt.launches = 0
    losses, times, load_ms = [], [], []
    first = None
    for i in range(GLUON_WARM + GLUON_TIMED):
        t = time.perf_counter()
        x, y = next_batch()
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        if i == 1:    # the second warm step, under the profiler
            loss = profile("gluon %s step, hybridized (warm)" % GLUON_MODEL,
                           lambda: _gluon_step(mx, net, loss_fn, trainer,
                                               x, y), top=14)
        else:
            loss = _gluon_step(mx, net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss.mean().asscalar()))
        if i == 0:
            params = net.collect_params()
            nparam = sum(p.data().size for p in params.values()
                         if p.grad_req != "null")
            first = {n: p.data()._data.clone() for n, p in params.items()
                     if p.grad_req != "null"}
            say("gluon (b): %s, %d trainable parameters (%.1f M) in %d "
                "arrays, %d in all, %d BatchNorms, batch %d x 3x%dx%d, "
                "float32, hybridized, MXNET_BN_PALLAS=1, SGD momentum 0.9 "
                "wd 1e-4 lr %g, on %s, set up and first step in %.1f s" % (
                    GLUON_MODEL, nparam, nparam / 1e6, len(first),
                    len(params.keys()), n_bn, B, S, S, GLUON_LR,
                    torch.cuda.get_device_name(0),
                    time.perf_counter() - t0))
    launches = {cnt.__name__: cnt.launches for cnt in counters}
    busy, kernel_ms = profile.busy, profile.busy_ms
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = GLUON_WARM + GLUON_TIMED
    step_ms = statistics.median(times[GLUON_WARM:])
    say("gluon (b): loss per step %s" % " ".join("%.4f" % v
                                                 for v in losses))
    # the profiled step's wall time carries the profiler's own cost: its
    # kernel time over the timed steps' median is the steady busy share
    say("gluon (b): hybridized step %.2f ms (median of %d timed steps; "
        "all: %s), %.1f img/s, peak device memory %.2f GB, device busy "
        "%.1f%% of the profiled step (its %.2f ms of kernels are %.1f%% of "
        "the timed step); DataLoader batch %.1f ms (median)"
        % (step_ms, GLUON_TIMED, " ".join("%.1f" % v for v in times),
           B / step_ms * 1e3, peak_gb, 100 * busy, kernel_ms,
           100 * kernel_ms / step_ms, statistics.median(load_ms)))
    if not all(np.isfinite(losses)):
        fail("gluon (b): non-finite loss %r" % losses)
    moved = sum(not torch.equal(p.data()._data, first[n])
                for n, p in net.collect_params().items() if n in first)
    if moved != len(first):
        fail("gluon (b): %d of %d parameters moved after step 1"
             % (moved, len(first)))
    for name, n in launches.items():
        if n != n_bn * steps:
            fail("gluon (b): %s launched %d times in %d steps, not %d a "
                 "step (one a BatchNorm)" % (name, n, steps, n_bn))

    # the same net eager: one warm step, then GLUON_EAGER timed
    net.hybridize(False)
    for cnt in counters:
        cnt.launches = 0
    eager = []
    for i in range(GLUON_EAGER + 1):
        x, y = next_batch()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = _gluon_step(mx, net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss.mean().asscalar()))
    config.set_override("MXNET_BN_PALLAS", None)
    eager_launches = {cnt.__name__: cnt.launches for cnt in counters}
    if any(n != n_bn * (GLUON_EAGER + 1) for n in eager_launches.values()):
        fail("gluon (b) eager: launches %r, not %d each" % (
            eager_launches, n_bn * (GLUON_EAGER + 1)))
    if not all(np.isfinite(losses)):
        fail("gluon (b) eager: non-finite loss %r" % losses[-4:])
    eager_ms = statistics.median(eager[1:])
    say("gluon (b): eager step %.2f ms (median of %d after a warm one; "
        "all: %s), %.1f img/s, %.3fx the hybridized step; launches a "
        "step: %s (hybridized and eager)" % (
            eager_ms, GLUON_EAGER, " ".join("%.1f" % v for v in eager),
            B / eager_ms * 1e3, eager_ms / step_ms,
            ", ".join("%s %d" % (n, v // steps)
                      for n, v in sorted(launches.items()))))
    del net, trainer, loader, X
    torch.cuda.empty_cache()
    return launches


def _word_lm(mx, width, tied=True):
    """The RNNModel of upstream example/gluon/word_language_model: an
    Embedding, WLM's LSTM layers at ``width`` with Dropout between them,
    Dropout on both sides, and a Dense decoder tied to the embedding."""
    from mxnet_tpu_torch import gluon
    V, L, p = WLM["vocab"], WLM["layers"], WLM["dropout"]

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(p)
                self.encoder = gluon.nn.Embedding(
                    V, width, weight_initializer=mx.init.Uniform(0.1))
                self.rnn = gluon.rnn.LSTM(width, L, dropout=p,
                                          input_size=width)
                self.decoder = gluon.nn.Dense(
                    V, in_units=width,
                    params=self.encoder.params if tied else None)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, width))), hidden

    return RNNModel()


def _wlm_step(mx, model, loss_fn, trainer, params, data, target, hidden):
    """One step of the example's train(): detached hidden, record,
    backward, clip_global_norm at clip x bptt x batch, Trainer.step."""
    from mxnet_tpu_torch import gluon
    hidden = [h.detach() for h in hidden]
    with mx.autograd.record():
        output, hidden = model(data, hidden)
        loss = loss_fn(output, target)
    loss.backward()
    grads = [p.grad() for p in params.values() if p.grad_req != "null"]
    gluon.utils.clip_global_norm(grads, WLM["clip"] * WLM["bptt"]
                                 * WLM["batch"])
    trainer.step(WLM["batch"])
    return loss, hidden


def wlm_phase():
    """(c) the word LM: card against CPU at WLM_SMALL_WIDTH (one recorded
    forward and backward from one seed: the loss, the outputs and the
    gradients, Dropout's masks equal on both), then WLM's full width on
    the card: GLUON_WARM steps (the second profiled) and GLUON_TIMED
    timed over seeded tokens."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    T, B, V = WLM["bptt"], WLM["batch"], WLM["vocab"]
    rng = np.random.RandomState(32)
    steps = GLUON_WARM + GLUON_TIMED
    corpus = rng.randint(0, V, (steps * T + 1, B)).astype(np.float32)

    def batch(i, ctx):
        with ctx:
            return (mx.nd.array(corpus[i * T:(i + 1) * T]),
                    mx.nd.array(corpus[i * T + 1:(i + 1) * T + 1]
                                .reshape(-1)))

    small = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mx.random.seed(4)
        model = _word_lm(mx, WLM_SMALL_WIDTH)
        model.collect_params().initialize(mx.init.Xavier(), ctx=ctx)
        data, target = batch(0, ctx)
        hidden = model.rnn.begin_state(func=mx.nd.zeros, batch_size=B,
                                       ctx=ctx)
        with mx.autograd.record():
            output, _ = model(data, hidden)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(output, target)
        loss.backward()
        k = len(model.prefix)
        small.append((output.asnumpy(), loss.asnumpy(),
                      {n[k:]: p.grad().asnumpy() for n, p in
                       model.collect_params().items()}))
    (o_c, l_c, g_c), (o_h, l_h, g_h) = small
    out_err = float(np.abs(o_c - o_h).max())
    grad_dist = _rel_norm(g_c, g_h)
    if not (np.allclose(o_c, o_h, **TOL["float32"]) and
            np.allclose(l_c, l_h, **TOL["float32"]) and grad_dist <= 1e-4):
        fail("gluon (c): word LM at width %d card vs CPU: outputs %.3g, "
             "gradients %.3g (relative, in norm)" % (
                 WLM_SMALL_WIDTH, out_err, grad_dist))
    say("gluon (c): word LM (%d-layer LSTM, width %d, vocab %d, dropout "
        "%g, tied) recorded forward and backward, card vs CPU: outputs max "
        "abs err %.3g (rtol %g, atol %g), %d gradients %.3g from the CPU's "
        "(relative, in norm; limit 1e-4)" % (
            WLM["layers"], WLM_SMALL_WIDTH, V, WLM["dropout"], out_err,
            TOL["float32"]["rtol"], TOL["float32"]["atol"], len(g_h),
            grad_dist))

    t0 = time.perf_counter()
    mx.random.seed(5)
    ctx = mx.gpu(0)
    model = _word_lm(mx, WLM["width"])
    params = model.collect_params()
    params.initialize(mx.init.Xavier(), ctx=ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": WLM["lr"],
                                            "momentum": 0, "wd": 0})
    hidden = model.rnn.begin_state(func=mx.nd.zeros, batch_size=B, ctx=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(steps):
        data, target = batch(i, ctx)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 1:
            loss, hidden = profile(
                "gluon word LM step (warm)", lambda: _wlm_step(
                    mx, model, loss_fn, trainer, params, data, target,
                    hidden), top=10)
            launches = sum(profile.counts.values())
            busy, kernel_ms = profile.busy, profile.busy_ms
        else:
            loss, hidden = _wlm_step(mx, model, loss_fn, trainer, params,
                                     data, target, hidden)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss.mean().asscalar()))
    nparam = sum(p.data().size for p in params.values())
    step_ms = statistics.median(times[GLUON_WARM:])
    if not all(np.isfinite(losses)):
        fail("gluon (c): non-finite loss %r" % losses)
    say("gluon (c): word LM %d-layer LSTM width %d, vocab %d, tied "
        "(%d parameter arrays, %.1f M), batch %d x bptt %d, dropout %g, "
        "clip_global_norm %g, SGD lr %g: loss per step %s; step %.2f ms "
        "(median of %d; all: %s), %.0f tokens/s, %d kernel launches in the "
        "profiled step (device busy %.1f%%; its %.2f ms of kernels are "
        "%.1f%% of the timed step), peak device memory %.2f GB, set up and "
        "run in %.1f s" % (
            WLM["layers"], WLM["width"], V, len(params.keys()),
            nparam / 1e6, B, T, WLM["dropout"], WLM["clip"] * T * B,
            WLM["lr"], " ".join("%.4f" % v for v in losses), step_ms,
            GLUON_TIMED, " ".join("%.1f" % v for v in times),
            B * T / step_ms * 1e3, launches, 100 * busy, kernel_ms,
            100 * kernel_ms / step_ms,
            torch.cuda.max_memory_allocated() / 1e9,
            time.perf_counter() - t0))
    del model, trainer, params
    torch.cuda.empty_cache()


def gluon_phase(counters):
    """The Gluon path: (a) card against CPU, small; (b) model_zoo
    resnet50_v1 trained through gluon.Trainer at full width on the
    BatchNorm kernels; (c) the word LM at its published width. Returns
    (b)'s launch counts."""
    t0 = time.perf_counter()
    gluon_reference_check()
    launches = gluon_train_run(counters)
    wlm_phase()
    say("gluon: phase done in %.1f s" % (time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# RNN phase: the symbolic RNN toolkit, the fused RNN op and CTCLoss
# ---------------------------------------------------------------------------

# (a) upstream example/rnn/cudnn_lstm_bucketing.py's net (Embedding ->
# FusedRNNCell(lstm) -> FullyConnected -> SoftmaxOutput, SGD, Xavier
# factor_type "in" magnitude 2.34, wd 1e-5, invalid label 0) at the widest
# LSTM of the repo, the Gluon word LM's largest setting (2 x 1500, embed
# 1500, PTB's 10,000 words, dropout 0.65, batch 32); lstm_bucketing.py's
# buckets
RNN_LM = dict(vocab=10000, width=1500, layers=2, dropout=0.65, batch=32,
              lr=0.01, wd=1e-5)
RNN_BUCKETS = (10, 20, 30, 40, 50, 60)
RNN_BATCHES = 3            # batches a bucket an epoch
RNN_EPOCHS = 4             # upstream's SGD lr 0.01 is noisy over the first two
RNN_UNFUSED_STEPS = 4      # timed unfused steps at the largest bucket
RNN_GRAD_RTOL = 1e-4       # gradients, relative in norm (float32, no TF32)
# (b) upstream example/warpctc/lstm_ocr.py: 2 unrolled LSTMCell layers of
# 100, 80 frames of 30 features, 4-digit labels, 10 digits + the blank
# (first), batch 32
OCR = dict(frames=80, feat=30, hidden=100, layers=2, label=4, digits=10,
           batch=32, batches=4, epochs=3, lr=1e-3)


def _lm_sentences(seed):
    """RNN_BATCHES * batch sentences a bucket, lengths drawn in
    (previous bucket, bucket], words from a Zipf law over 1..vocab-1 (0
    is the padding label) — every bucket fills."""
    rng = np.random.RandomState(seed)
    V, n = RNN_LM["vocab"], RNN_BATCHES * RNN_LM["batch"]
    p = 1.0 / np.arange(1, V)
    p /= p.sum()
    sents, lo = [], 0
    for b in RNN_BUCKETS:
        lengths = rng.randint(lo + 1, b + 1, n)
        words = rng.choice(np.arange(1, V), size=int(lengths.sum()), p=p)
        sents += [list(map(int, w)) for w in
                  np.split(words, np.cumsum(lengths)[:-1])]
        lo = b
    return sents


def _lm_sym_gen(mx, cell_of):
    """cudnn_lstm_bucketing.py's sym_gen over the cell ``cell_of()``."""
    V, W = RNN_LM["vocab"], RNN_LM["width"]

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=V, output_dim=W,
                                 name="embed")
        output, _ = cell_of().unroll(seq_len, inputs=embed,
                                     merge_outputs=True, layout="NTC")
        pred = mx.sym.Reshape(output, shape=(-1, W))
        pred = mx.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, label, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _fused_cell(mx, dropout):
    return mx.rnn.FusedRNNCell(RNN_LM["width"], RNN_LM["layers"],
                               mode="lstm", dropout=dropout,
                               prefix="lstm_")


def _batch_nll(mod, batch):
    """The step's mean NLL over every label (SoftmaxOutput's loss)."""
    import torch
    probs = mod.get_outputs()[0]._data
    lab = batch.label[0]._data.reshape(-1).long()
    return float(-torch.log(probs.gather(1, lab[:, None]).clamp_min(
        1e-30)).mean())


def rnn_route_check(blob):
    """The fused route (cuDNN over views of the blob) against
    _rnn_reference on the card at the largest bucket, p = 0: outputs and
    the gradients of the data and the blob; then the route's forward +
    backward time beside the plain loop's and beside torch.nn.LSTM over
    the same weights flattened into cuDNN's own buffer (the weight copy
    the blob's layout costs)."""
    import torch
    from mxnet_tpu_torch.ops import rnn_op
    T, B, W, L = max(RNN_BUCKETS), RNN_LM["batch"], RNN_LM["width"], \
        RNN_LM["layers"]
    dev = blob.device
    g = torch.Generator(device="cpu").manual_seed(61)
    x = torch.randn(T, B, W, generator=g).to(dev)
    cot = torch.randn(T, B, W, generator=g).to(dev)
    h0 = torch.zeros(L, 1, W, device=dev)
    attrs = dict(state_size=W, num_layers=L, mode="lstm")
    runs = {}
    for name, fn in (("route", rnn_op._rnn_op),
                     ("plain", rnn_op._rnn_reference)):
        xs = x.clone().requires_grad_()
        bs = blob.detach().clone().requires_grad_()
        out = fn(xs, bs, h0, h0, **attrs)
        out.backward(cot)
        runs[name] = (out.detach(), xs.grad, bs.grad)
    (o_r, dx_r, db_r), (o_p, dx_p, db_p) = runs["route"], runs["plain"]
    out_err = float((o_r - o_p).abs().max())
    rel = [float((a - b).norm() / b.norm()) for a, b in
           ((dx_r, dx_p), (db_r, db_p))]
    if not (torch.allclose(o_r, o_p, **TOL["float32"])
            and max(rel) <= RNN_GRAD_RTOL):
        fail("rnn (a): the cuDNN route against _rnn_reference at %d x %d x "
             "%d: outputs max abs err %.3g (rtol %g, atol %g), data and "
             "blob gradients %.3g, %.3g from the loop's (relative, in "
             "norm; limit %g)" % (T, B, W, out_err, TOL["float32"]["rtol"],
                                  TOL["float32"]["atol"], rel[0], rel[1],
                                  RNN_GRAD_RTOL))

    lstm = torch.nn.LSTM(W, W, L).to(dev)
    views = rnn_op._unpack_params(blob.detach(), "lstm", W, W, L, False)
    with torch.no_grad():
        for layer in range(L):
            for kind, key in (("w_i2h", "weight_ih"), ("w_h2h", "weight_hh"),
                              ("b_i2h", "bias_ih"), ("b_h2h", "bias_hh")):
                getattr(lstm, "%s_l%d" % (key, layer)).copy_(
                    views[(layer, 0)][kind])
    lstm.flatten_parameters()
    hx = (torch.zeros(L, B, W, device=dev), torch.zeros(L, B, W, device=dev))
    with torch.no_grad():
        flat_err = float((lstm(x, hx)[0] - o_r).abs().max())
    xs = x.clone().requires_grad_()
    bs = blob.detach().clone().requires_grad_()

    def route_step():
        rnn_op._rnn_op(xs, bs, h0, h0, **attrs).backward(cot)

    def flat_step():
        lstm(xs, hx)[0].backward(cot)

    def plain_step():
        rnn_op._rnn_reference(xs, bs, h0, h0, **attrs).backward(cot)
    t_route, t_flat = time_ms(route_step, reps=10), time_ms(flat_step,
                                                           reps=10)
    t_route2, t_plain = time_ms(route_step, reps=10), time_ms(plain_step,
                                                             reps=3,
                                                             warmup=1)
    profile("RNN op forward + backward (%d x %d, T %d, batch %d, "
            "cuDNN over the blob's views)" % (L, W, T, B), route_step, top=6)
    say("rnn (a): the RNN op's cuDNN route against _rnn_reference on the "
        "card (T %d, batch %d, 2 x %d, p 0, torch.backends.cudnn.allow_tf32"
        "=%s): outputs max abs err %.3g (rtol %g, atol %g), data and blob "
        "gradients %.3g and %.3g from the loop's (relative, in norm; limit "
        "%g); torch.nn.LSTM over the same weights flattened in cuDNN's "
        "buffer: outputs max abs err %.3g from the route's" % (
            T, B, W, torch.backends.cudnn.allow_tf32, out_err,
            TOL["float32"]["rtol"], TOL["float32"]["atol"], rel[0], rel[1],
            RNN_GRAD_RTOL, flat_err))
    say("rnn (a): forward + backward of the RNN op at T %d: the route "
        "(weights as views of the blob, copied by cuDNN each call) %.3f / "
        "%.3f ms, torch.nn.LSTM with flattened weights %.3f ms (the copy: "
        "%.3f ms a call), the plain loop %.3f ms (events; %d launches in "
        "the route's profiled call)" % (
            T, t_route, t_route2, t_flat,
            statistics.mean([t_route, t_route2]) - t_flat, t_plain,
            sum(profile.counts.values())))
    del lstm, runs, xs, bs
    torch.cuda.empty_cache()


def rnn_unfused_check(mx, mod, batch, fused_ms):
    """The same net unfused (FusedRNNCell.unfuse() -> SequentialRNNCell of
    LSTMCells, weights through unpack_weights / pack_weights) against
    the fused net, both at p = 0, one forward + backward at the largest
    bucket from the trained weights: outputs and every gradient (the
    cells' packed back into the blob); then the unfused step's time, the
    upstream --stack-rnn route."""
    import torch
    T, B = max(RNN_BUCKETS), RNN_LM["batch"]
    args, aux = mod.get_params()
    fused = _fused_cell(mx, 0.0)
    stack = fused.unfuse()
    with mx.cpu():
        cell_args = stack.pack_weights(fused.unpack_weights(
            {k: mx.nd.array(v.asnumpy()) for k, v in args.items()}))
    shapes = dict(data_shapes=[("data", (B, T))],
                  label_shapes=[("softmax_label", (B, T))])
    outs = {}
    mods = {}
    for name, cell_of, params in (
            ("fused", lambda: _fused_cell(mx, 0.0), args),
            ("unfused", lambda: fused.unfuse(), cell_args)):
        sym, dn, ln = _lm_sym_gen(mx, cell_of)(T)
        m = mx.mod.Module(sym, dn, ln, context=mx.gpu(0))
        m.bind(**shapes)
        m.init_params(None, arg_params=params, aux_params=aux)
        m.forward_backward(batch)
        exe = m._exec_group.execs[0]
        grads = {k: v.asnumpy() for k, v in exe.grad_dict.items()
                 if v is not None}
        outs[name] = (m.get_outputs()[0].asnumpy(), grads)
        mods[name] = m
    (o_f, g_f), (o_u, g_u) = outs["fused"], outs["unfused"]
    with mx.cpu():
        g_u = {k: (v.asnumpy() if hasattr(v, "asnumpy") else v)
               for k, v in fused.pack_weights(stack.unpack_weights(
                   {k: mx.nd.array(v) for k, v in g_u.items()})).items()}
    out_err = float(np.abs(o_f - o_u).max())
    grad_rel = _rel_norm(g_u, g_f)
    if sorted(g_u) != sorted(g_f) or not (
            np.allclose(o_u, o_f, **TOL["float32"])
            and grad_rel <= RNN_GRAD_RTOL):
        fail("rnn (a): unfused against fused at p 0: outputs max abs err "
             "%.3g, gradients %s vs %s, %.3g (relative, in norm)" % (
                 out_err, sorted(g_u), sorted(g_f), grad_rel))
    m = mods["unfused"]
    m.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RNN_LM["lr"], "wd": RNN_LM["wd"]})
    times = []
    for _ in range(RNN_UNFUSED_STEPS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m.forward_backward(batch)
        m.update()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    unfused_ms = statistics.median(times[1:])
    say("rnn (a): unfused (SequentialRNNCell of %d LSTMCells, %d steps "
        "unrolled) against fused at p 0, bucket %d: outputs max abs err "
        "%.3g (rtol %g, atol %g), %d gradients %.3g from the fused net's "
        "(relative, in norm; limit %g); unfused step %.2f ms (median of "
        "%d; all: %s) against the fused %.2f ms: %.2fx" % (
            RNN_LM["layers"], T, T, out_err, TOL["float32"]["rtol"],
            TOL["float32"]["atol"], len(g_f), grad_rel, RNN_GRAD_RTOL,
            unfused_ms, RNN_UNFUSED_STEPS, " ".join("%.1f" % v
                                                    for v in times),
            fused_ms, unfused_ms / fused_ms))
    del mods, m
    torch.cuda.empty_cache()


def rnn_lm_phase():
    """(a) the bucketed word LM through BucketingModule.fit over
    BucketSentenceIter on the card: step ms, tokens/s, peak memory of
    each bucket, one profiled step a bucket (launches, busy share), a
    falling loss, the save_rnn_checkpoint -> load_rnn_checkpoint round
    trip bit for bit, then rnn_route_check and rnn_unfused_check. Returns
    the launch counts of the port's kernels in the fit."""
    import random
    import shutil
    import tempfile

    import torch
    import mxnet_tpu_torch as mx

    V, W, B = RNN_LM["vocab"], RNN_LM["width"], RNN_LM["batch"]
    t0 = time.perf_counter()
    sents = _lm_sentences(19)
    random.seed(19)
    np.random.seed(19)
    mx.random.seed(19)
    with mx.gpu(0):
        it = mx.rnn.BucketSentenceIter(sents, B, buckets=list(RNN_BUCKETS),
                                       invalid_label=0)
    sym_gen = _lm_sym_gen(mx, lambda: _fused_cell(mx, RNN_LM["dropout"]))
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0))
    counters = mt_counters()
    _reset_counts(counters)
    marks, steps = [time.perf_counter()], []

    def timed_cb(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        batch = param.locals["batch"]
        peak = torch.cuda.max_memory_allocated()
        steps.append(dict(bucket=batch.bucket_key, ms=(now - marks[-1]) * 1e3,
                          epoch=param.epoch, nbatch=param.nbatch,
                          peak=peak, nll=_batch_nll(mod, batch)))
        torch.cuda.reset_peak_memory_stats()
        marks.append(time.perf_counter())
    torch.cuda.reset_peak_memory_stats()
    mod.fit(it, num_epoch=RNN_EPOCHS, eval_metric=mx.metric.Perplexity(0),
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            optimizer="sgd", optimizer_params={"learning_rate": RNN_LM["lr"],
                                               "wd": RNN_LM["wd"]},
            batch_end_callback=timed_cb)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    held_gb = torch.cuda.memory_allocated() / 1e9
    launches = {c.__name__: c.launches for c in counters}
    args, aux = mod.get_params()
    nparam = sum(v.size for v in args.values())
    nll = [s["nll"] for s in steps]
    per_epoch = [statistics.mean(s["nll"] for s in steps if s["epoch"] == e)
                 for e in range(RNN_EPOCHS)]
    if not all(np.isfinite(nll)) or not per_epoch[-1] < per_epoch[0]:
        fail("rnn (a): the loss does not fall: epochs %r, steps %r"
             % (per_epoch, nll))
    say("rnn (a): upstream cudnn_lstm_bucketing's net, FusedRNNCell lstm "
        "%d x %d, embed %d, vocab %d, dropout %g (%d parameter arrays, "
        "%.1f M: embed %.1f M, LSTM %.1f M, head %.1f M), batch %d, buckets "
        "%s, %d batches a bucket, %d epochs through BucketingModule.fit "
        "(SGD lr %g wd %g, Xavier in 2.34, float32, allow_tf32=%s) in %.1f "
        "s, %.2f GB allocated after it; the NLL a step (every label, the "
        "padding included): %s" % (
            RNN_LM["layers"], W, W, V, RNN_LM["dropout"], len(args),
            nparam / 1e6, args["embed_weight"].size / 1e6,
            args["lstm_parameters"].size / 1e6,
            (args["pred_weight"].size + args["pred_bias"].size) / 1e6, B,
            list(RNN_BUCKETS), RNN_BATCHES, RNN_EPOCHS, RNN_LM["lr"],
            RNN_LM["wd"], torch.backends.cudnn.allow_tf32, fit_s, held_gb,
            " ".join("%.3f" % v for v in nll)))
    say("rnn (a): the mean NLL of each epoch: %s" % " ".join(
        "%.3f" % v for v in per_epoch))

    # per bucket: the steps after its first (bind, cuDNN plans), not first
    # in an epoch, and not just before another bucket's first step (fit
    # prepares the next batch, binding its bucket, inside the step before
    # it); one profiled step each
    first, seen = set(), set()
    for i, s in enumerate(steps):
        if s["bucket"] not in seen:
            first.add(i)
        seen.add(s["bucket"])
    rows = {}
    for i, s in enumerate(steps):
        if not ({i, i + 1} & first) and s["nbatch"] > 0:
            rows.setdefault(s["bucket"], []).append(s)
    batches = {}
    it.reset()
    for b in it:
        batches.setdefault(b.bucket_key, b)
    for bucket in RNN_BUCKETS:
        got = rows.get(bucket, [])
        if not got:
            fail("rnn (a): bucket %d has no timed step" % bucket)
        ms = statistics.median(s["ms"] for s in got)
        batch = batches[bucket]

        def one_step(batch=batch):
            mod.forward_backward(batch)
            mod.update()
        profile("rnn (a) step, bucket %d" % bucket, one_step,
                top=8 if bucket == max(RNN_BUCKETS) else 2)
        say("rnn (a): bucket %d: step %.2f ms (median of %d; all: %s), "
            "%.0f tokens/s (padding included), peak device memory a step "
            "%.2f GB, %d launches and device busy %.1f%% in a profiled "
            "step" % (bucket, ms, len(got), " ".join(
                "%.1f" % s["ms"] for s in got), B * bucket / ms * 1e3,
                max(s["peak"] for s in got) / 1e9,
                sum(profile.counts.values()), 100 * profile.busy))
        rows[bucket] = ms
    fused_ms = rows[max(RNN_BUCKETS)]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rnn_")
    try:
        prefix = os.path.join(tmp, "lm")
        cell = _fused_cell(mx, RNN_LM["dropout"])
        t = time.perf_counter()
        mx.rnn.save_rnn_checkpoint(cell, prefix, RNN_EPOCHS,
                                   sym_gen(max(RNN_BUCKETS))[0], args, aux)
        _, ck_args, ck_aux = mx.rnn.load_rnn_checkpoint(cell, prefix,
                                                        RNN_EPOCHS)
        ck_s = time.perf_counter() - t
        size = os.path.getsize("%s-%04d.params" % (prefix, RNN_EPOCHS))
        saved = sorted(mx.nd.load("%s-%04d.params" % (prefix, RNN_EPOCHS)))
        same = sorted(ck_args) == sorted(args) and all(
            torch.equal(ck_args[n]._data.cpu(), args[n]._data.cpu())
            for n in args)
        if not same or "arg:lstm_l1_h2h_o_weight" not in saved:
            fail("rnn (a): the rnn checkpoint round trip is not bit-equal "
                 "(saved %s)" % saved[:6])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("rnn (a): save_rnn_checkpoint -> load_rnn_checkpoint (%d arrays "
        "saved, the blob as %d per-gate arrays; %.1f MB, %.1f s): the "
        "fused blob and every parameter bit-equal" % (
            len(saved), sum("lstm_l" in n for n in saved), size / 1e6, ck_s))

    rnn_route_check(args["lstm_parameters"]._data)
    rnn_unfused_check(mx, mod, batches[max(RNN_BUCKETS)], fused_ms)
    del mod, args, aux, ck_args, ck_aux
    torch.cuda.empty_cache()
    return launches


def _ocr_batch(seed, n):
    """lstm_ocr.py's task rendered as the JAX package's
    examples/ctc_ocr.py renders it: each digit lights its own band of 3
    features over 8 consecutive frames of noise; labels 1..10 (0 is the
    blank)."""
    rng = np.random.RandomState(seed)
    F, D = OCR["frames"], OCR["digits"]
    labels = rng.randint(1, D + 1, (n, OCR["label"])).astype(np.float32)
    x = rng.randn(n, F, OCR["feat"]).astype(np.float32) * 0.3
    step = F // OCR["label"]
    for i, seq in enumerate(labels):
        for j, d in enumerate(seq):
            lo = 4 + j * step
            x[i, lo:lo + 8, (int(d) - 1) * 3:int(d) * 3] += 2.0
    return x, labels


def _ocr_net(mx):
    """lstm_ocr.py's net: OCR["layers"] unrolled LSTMCells, a per-frame
    classifier over digits + blank, MakeLoss(CTCLoss) over (T, N, C)."""
    F, Hd, C = OCR["frames"], OCR["hidden"], OCR["digits"] + 1
    stack = mx.rnn.SequentialRNNCell()
    for i in range(OCR["layers"]):
        stack.add(mx.rnn.LSTMCell(Hd, prefix="l%d_" % i))
    outs, _ = stack.unroll(F, mx.sym.Variable("data"), merge_outputs=True)
    pred = mx.sym.FullyConnected(mx.sym.Reshape(outs, shape=(-1, Hd)),
                                 num_hidden=C, name="pred")
    act = mx.sym.transpose(mx.sym.Reshape(pred, shape=(-1, F, C)),
                           axes=(1, 0, 2))
    return mx.sym.MakeLoss(mx.sym.CTCLoss(act, mx.sym.Variable("label"),
                                          name="ctc"))


def rnn_ctc_phase():
    """(b) LSTM + CTC at lstm_ocr.py's sizes: one forward + backward from
    one seed on the CPU and the card (the loss and every gradient), then
    OCR["epochs"] epochs of Module.fit on the card (Adam) with a falling
    loss; and the CTCLoss op's forward + backward time beside
    torch.nn.functional.ctc_loss's (a different function: inf on an
    impossible alignment) at these shapes."""
    import torch
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import ctc

    B, T, C = OCR["batch"], OCR["frames"], OCR["digits"] + 1
    x, labels = _ocr_batch(23, OCR["batch"] * OCR["batches"])
    net = _ocr_net(mx)
    shapes = dict(data_shapes=[("data", (B, T, OCR["feat"]))],
                  label_shapes=[("label", (B, OCR["label"]))])
    res = []
    params = None
    for ctx in (mx.cpu(), mx.gpu(0)):
        m = mx.mod.Module(net, ("data",), ("label",), context=ctx)
        m.bind(**shapes)
        if params is None:
            mx.random.seed(23)
            m.init_params(mx.init.Xavier())
            params = m.get_params()
        else:
            m.init_params(None, arg_params=params[0], aux_params=params[1])
        with ctx:
            batch = mx.io.DataBatch([mx.nd.array(x[:B])],
                                    [mx.nd.array(labels[:B])])
        t = time.perf_counter()
        m.forward_backward(batch)
        loss = m.get_outputs()[0].asnumpy()
        ms = (time.perf_counter() - t) * 1e3
        exe = m._exec_group.execs[0]
        res.append((loss, {k: v.asnumpy() for k, v in exe.grad_dict.items()
                           if v is not None}, ms))
    (l_c, g_c, ms_c), (l_g, g_g, ms_g) = res
    loss_err = float(np.abs(l_g - l_c).max() / np.abs(l_c).max())
    grad_rel = _rel_norm(g_g, g_c)
    if not (np.all(np.isfinite(l_g)) and loss_err <= TOL["float32"]["rtol"]
            and grad_rel <= RNN_GRAD_RTOL):
        fail("rnn (b): LSTM + CTC card vs CPU: loss %.3g, gradients %.3g "
             "(relative)" % (loss_err, grad_rel))
    say("rnn (b): upstream lstm_ocr's net (%d LSTMCell layers of %d "
        "unrolled over %d frames of %d features, %d classes with the blank "
        "first, %d-digit labels, batch %d) one forward + backward, card vs "
        "CPU: the loss %.3g apart (relative to its largest; limit %g), %d "
        "gradients %.3g (relative, in norm; limit %g); the card's first "
        "call %.1f ms, the CPU's %.1f ms" % (
            OCR["layers"], OCR["hidden"], T, OCR["feat"], C, OCR["label"],
            B, loss_err, TOL["float32"]["rtol"], len(g_g), grad_rel,
            RNN_GRAD_RTOL, ms_g, ms_c))

    mx.random.seed(23)
    np.random.seed(23)
    with mx.gpu(0):
        it = mx.io.NDArrayIter({"data": x}, {"label": labels},
                               batch_size=B, shuffle=True, label_name="label")
    m = mx.mod.Module(net, ("data",), ("label",), context=mx.gpu(0))
    losses, marks = [], [time.perf_counter()]

    def cb(param):
        losses.append(float(m.get_outputs()[0].asnumpy().mean()))
        marks.append(time.perf_counter())
    m.fit(it, num_epoch=OCR["epochs"], eval_metric=mx.metric.Loss(),
          arg_params=params[0], aux_params=params[1], optimizer="adam",
          optimizer_params={"learning_rate": OCR["lr"]},
          batch_end_callback=cb)
    n = OCR["batches"]
    if not (all(np.isfinite(losses))
            and np.mean(losses[-n:]) < np.mean(losses[:n])):
        fail("rnn (b): the CTC loss does not fall: %r" % losses)
    gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    dev = mx.gpu(0).torch_device()
    g = torch.Generator(device="cpu").manual_seed(29)
    act = torch.randn(T, B, C, generator=g).to(dev).requires_grad_()
    lab = torch.tensor(labels[:B], device=dev)
    lens = torch.full((B,), T, dtype=torch.long, device=dev)
    llens = torch.full((B,), OCR["label"], dtype=torch.long, device=dev)

    def op_step():
        ctc._ctc_loss(act, lab).sum().backward()

    def lib_step():
        F.ctc_loss(act.log_softmax(-1), lab.long(), lens, llens, blank=0,
                   reduction="sum").backward()
    with torch.no_grad():
        lib_loss = F.ctc_loss(act.log_softmax(-1), lab.long(), lens, llens,
                              blank=0, reduction="none")
        op_loss = ctc._ctc_loss(act, lab)
    lib_gap = float((lib_loss - op_loss).abs().max() / op_loss.abs().max())
    t_op, t_lib = time_ms(op_step, reps=10), time_ms(lib_step, reps=10)
    profile("CTCLoss op forward + backward (T %d, batch %d, %d classes)"
            % (T, B, C), op_step, top=3)
    say("rnn (b): Module.fit, %d epochs of %d batches (Adam lr %g): the "
        "loss a step %s, a step %.1f ms (median; all: %s); the CTCLoss op's "
        "forward + backward %.3f ms (%d launches), "
        "torch.nn.functional.ctc_loss's %.3f ms (a different function; "
        "their losses %.3g apart here, relative)" % (
            OCR["epochs"], n, OCR["lr"], " ".join("%.3f" % v for v in losses),
            statistics.median(gaps[1:]), " ".join("%.1f" % v for v in gaps),
            t_op, sum(profile.counts.values()), t_lib, lib_gap))
    del m
    torch.cuda.empty_cache()


def rnn_phase():
    """The symbolic RNN toolkit on the card: (a) the bucketed 2 x 1500 LSTM
    LM, (b) LSTM + CTC. Returns (a)'s launch counts of the port's
    kernels."""
    t0 = time.perf_counter()
    launches = rnn_lm_phase()
    rnn_ctc_phase()
    say("rnn: phase done in %.1f s" % (time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# detect phase: SSD300 training, Faster R-CNN, the rest of the op catalog
# ---------------------------------------------------------------------------

# upstream example/ssd/train.py: batch 32, SGD lr 0.002, momentum 0.9, wd
# 5e-4 (rescale 1: the losses normalize by the valid anchors); 21 classes
# at 300 px, float32; labels (B, SSD_LABEL_ROWS, 6) padded with -1 rows
SSD_TRAIN = dict(batch=32, lr=0.002, momentum=0.9, wd=5e-4)
SSD_LABEL_ROWS = 12          # every image holds 1..8 boxes, so all pad
SSD_TRAIN_STEPS = 8          # Module.fit steps: a warm-up and 7 timed
SSD_SMALL_SEED = 0           # the small graph's weights (card vs CPU)
SSD_SMALL_DATA_SEED = 1      # its batch: 8+ ulps at every target decision
TARGET_MARGIN_ULPS = 8
SSD_SMALL_TOL = dict(rtol=1e-4, atol=1e-5)   # outputs, card vs CPU
SSD_UPDATE_RTOL = 1e-2       # a step's update, relative in norm (cuDNN)


def ssd_train_batch(n, seed, rows=SSD_LABEL_ROWS, classes=SSD_CLASSES):
    """n seeded images (standard normal, 3x300x300) and their labels
    (n, rows, 6) [class, x1, y1, x2, y2, difficult] in [0, 1] image
    coordinates: 1..8 boxes an image, each side 0.1..0.6, the rest -1."""
    rs = np.random.RandomState(seed)
    X = rs.standard_normal((n, 3, SSD_IMAGE, SSD_IMAGE)).astype(np.float32)
    Y = -np.ones((n, rows, 6), np.float32)
    for i in range(n):
        for k in range(rs.randint(1, 9)):
            w, h = rs.uniform(0.1, 0.6, 2)
            x, y = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            Y[i, k] = (rs.randint(0, classes), x, y, x + w, y + h, 0)
    return X, Y


def target_margin_ulps(prob_bg, cls_target):
    """Per image, how far (in ulps of the larger) the hard-negative cut is
    from a tie: the lowest background probability left out (ignored)
    against the highest taken (negative); inf where every candidate was
    taken. The targets agree across summation orders when this is large
    in both."""
    out = []
    for p, t in zip(prob_bg, cls_target):
        taken, left = p[t == 0], p[t == -1]
        if not len(taken) or not len(left):
            out.append(np.inf)
            continue
        hi = np.float32(taken.max())
        out.append(float((np.float32(left.min()) - hi) / np.spacing(hi)))
    return out


def check_ssd_targets(what, anchors, labels, loc_target, loc_mask,
                      cls_target):
    """Fail unless MultiBoxTarget's outputs (numpy) follow SSD_TARGET's
    rules: classes in {-1, 0, 1..20}; the mask set exactly at the
    positives; min(3 P, A - P) negatives an image; every valid gt box the
    decoded target of some positive anchor (each gt matched). Returns
    the positives and negatives of each image."""
    B, A = cls_target.shape
    if not (np.isin(cls_target, np.arange(-1, SSD_CLASSES + 1)).all()):
        fail("%s: cls_target outside {-1, 0, 1..%d}" % (what, SSD_CLASSES))
    pos = cls_target > 0
    mask = loc_mask.reshape(B, A, 4)
    if not (np.array_equal(mask, np.repeat(pos[..., None], 4, -1)
                           .astype(mask.dtype))):
        fail("%s: loc_mask is not set exactly at the positives" % what)
    stats = []
    vx, vy, vw, vh = SSD_TARGET["variances"]
    a = anchors.reshape(-1, 4).astype(np.float64)
    aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    ax, ay = (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2
    for b in range(B):
        P = int(pos[b].sum())
        neg = int((cls_target[b] == 0).sum())
        if neg != min(3 * P, A - P):
            fail("%s image %d: %d negatives for %d positives, want %d"
                 % (what, b, neg, P, min(3 * P, A - P)))
        t = loc_target.reshape(B, A, 4)[b][pos[b]].astype(np.float64)
        cx = t[:, 0] * vx * aw[pos[b]] + ax[pos[b]]
        cy = t[:, 1] * vy * ah[pos[b]] + ay[pos[b]]
        w = np.exp(t[:, 2] * vw) * aw[pos[b]]
        h = np.exp(t[:, 3] * vh) * ah[pos[b]]
        dec = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
        for k, row in enumerate(labels[b]):
            if row[0] < 0:
                break
            hit = np.abs(dec - row[1:5]).max(axis=1) < 1e-4
            if not hit.any() or not (cls_target[b][pos[b]][hit] ==
                                     row[0] + 1).any():
                fail("%s image %d: gt %d (%s) is no positive anchor's "
                     "target" % (what, b, k, row[:5]))
        stats.append((P, neg))
    return stats


def ssd_loss(outs):
    """The training loss of SSD300's outputs (NDArrays), on their device
    with one host read: the mean cross entropy of cls_prob at the valid
    targets plus the summed loc_loss over the positives (upstream's
    MultiBoxMetric, CrossEntropy + SmoothL1)."""
    import torch
    cls_prob, loc_loss, cls_label = (o._data for o in outs[:3])
    valid = cls_label >= 0
    t = cls_label.clamp_min(0).long()
    p = torch.gather(cls_prob, 1, t[:, None])[:, 0]
    ce = -(torch.log(p.clamp_min(1e-12)) * valid).sum() / valid.sum()
    sl1 = loc_loss.sum() / (cls_label > 0).sum().clamp_min(1)
    return float(ce + sl1)


def ssd_module(mx, sym, ctx, params, X, Y):
    """A Module over the SSD300 training graph on ``ctx``, bound to X, Y's
    shapes, with ``params`` (numpy) and upstream's SGD."""
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=ctx)
    mod.bind(data_shapes=[("data", X.shape)],
             label_shapes=[("label", Y.shape)])
    with ctx:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in params.items()},
                        aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": SSD_TRAIN["lr"], "momentum": SSD_TRAIN["momentum"],
        "wd": SSD_TRAIN["wd"]})
    return mod


def ssd_train_reference_check():
    """A small SSD300 training graph (every width / SSD_SMALL_DIV, batch
    2) from one set of weights on the card and on the CPU: one Module
    step each. The targets (cls_label) equal exactly, on a batch whose
    hard-negative cut is TARGET_MARGIN_ULPS or more from a tie on both
    devices (the IoUs, from the same anchors and labels, are bit-equal);
    the outputs agree within SSD_SMALL_TOL, and each parameter's update
    within SSD_UPDATE_RTOL relative in norm (cuDNN's float32
    convolutions round at about 1e-6, ROADMAP Queue C 8)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io

    sym = ssd300_symbol(mx.sym, SSD_CLASSES, SSD_SMALL_DIV, train=True)
    params = ssd_params(ssd300_symbol(mx.sym, SSD_CLASSES, SSD_SMALL_DIV,
                                      heads=True), seed=SSD_SMALL_SEED)
    X, Y = ssd_train_batch(2, SSD_SMALL_DATA_SEED)
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = ssd_module(mx, sym, ctx, params, X, Y)
        with ctx:
            batch = io.DataBatch([mx.nd.array(X)], [mx.nd.array(Y)])
        mod.forward(batch, is_train=True)
        outs = [o.asnumpy() for o in mod.get_outputs()]
        mod.backward()
        mod.update()
        after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        res.append((outs, after))
    (card, card_p), (cpu, cpu_p) = res
    margins = [min(target_margin_ulps(o[0][:, 0], o[2])) for o in (card, cpu)]
    if min(margins) < TARGET_MARGIN_ULPS:
        fail("detect: the small SSD300 batch's hard-negative cut is %s ulps "
             "from a tie (card, CPU): pick another SSD_SMALL_DATA_SEED"
             % margins)
    if not np.array_equal(card[2], cpu[2]):
        fail("detect: small SSD300 targets differ card vs CPU in %d anchors"
             % int((card[2] != cpu[2]).sum()))
    errs = [check_close("small SSD300 train output %d card vs CPU" % i,
                        torch.from_numpy(c), torch.from_numpy(h),
                        SSD_SMALL_TOL)
            for i, (c, h) in enumerate(zip(card[:2], cpu[:2]))]
    upd = max(_rel_norm({"u": card_p[k] - params[k]},
                        {"u": cpu_p[k] - params[k]}) for k in params)
    if not upd <= SSD_UPDATE_RTOL:
        fail("detect: small SSD300 one step's update card vs CPU %.3g "
             "relative in norm (limit %g)" % (upd, SSD_UPDATE_RTOL))
    say("detect: small SSD300 train graph (widths / %d, batch 2, f32) one "
        "Module step card vs CPU: cls_label equal (positives %s, negatives "
        "%s; the hard-negative cut %s ulps from a tie on card, CPU), "
        "cls_prob and loc_loss max abs err %s, largest parameter update "
        "error %.3g relative in norm" % (
            SSD_SMALL_DIV, (cpu[2] > 0).sum(1).tolist(),
            (cpu[2] == 0).sum(1).tolist(),
            ", ".join("%.0f" % m for m in margins),
            " ".join("%.3g" % e for e in errs), upd))


def ssd_train_phase():
    """SSD300 (VGG16-reduced, 21 classes, 300 px, f32, TF32 off) trained
    at full width through Module.fit: batch 32, upstream's SGD, seeded
    batches with 1..8 boxes an image. Step ms, img/s, peak memory, a
    profiled step's device time by kind, launches and busy share, the
    target op alone; a finite, falling loss; the targets' rules; one NMS
    launch a training forward. Returns the fit's launch counts."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io
    from mxnet_tpu_torch.ops import nms_kernels as nmsk
    from mxnet_tpu_torch.ops.registry import get_op

    ssd_train_reference_check()
    B, K = SSD_TRAIN["batch"], SSD_TRAIN_STEPS
    t0 = time.perf_counter()
    sym = ssd300_symbol(mx.sym, SSD_CLASSES, SSD_WIDTH_DIV, train=True)
    heads_sym = ssd300_symbol(mx.sym, SSD_CLASSES, SSD_WIDTH_DIV, heads=True)
    params = ssd_params(heads_sym, seed=0)
    X, Y = ssd_train_batch(K * B, seed=5)
    nparam = sum(p.size for p in params.values())
    counters = [nmsk.nms_keep_cuda] + list(mt_counters())
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=mx.gpu(0))
    with mx.cpu():
        args = {k: mx.nd.array(v) for k, v in params.items()}
    losses, marks, peaks = [], [], []

    class Loss(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("ssd_loss")

        def update(self, labels, preds):
            losses.append(ssd_loss(preds))

    def timed_cb(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    say("detect: SSD300 train graph, %d classes + background, %d anchors, "
        "%d params (%.1f M), batch %d x 3x%dx%d, labels (%d, %d, 6), f32 "
        "(MXNET_MATMUL_PRECISION=%s), SGD lr %g momentum %g wd %g, set up "
        "in %.1f s" % (SSD_CLASSES, SSD_ANCHORS, nparam, nparam / 1e6, B,
                       SSD_IMAGE, SSD_IMAGE, B, SSD_LABEL_ROWS,
                       mx.config.get("MXNET_MATMUL_PRECISION"),
                       SSD_TRAIN["lr"], SSD_TRAIN["momentum"],
                       SSD_TRAIN["wd"], time.perf_counter() - t0))
    it = io.NDArrayIter(X, Y, batch_size=B, label_name="label")
    torch.cuda.synchronize()
    _reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    marks.append(time.perf_counter())
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params={
        "learning_rate": SSD_TRAIN["lr"], "momentum": SSD_TRAIN["momentum"],
        "wd": SSD_TRAIN["wd"]}, eval_metric=Loss(), arg_params=args,
        aux_params={}, batch_end_callback=timed_cb)
    launches = {c.__name__: c.launches for c in counters}
    arg1, aux1 = mod.get_params()
    fitted = ({k: v._data for k, v in arg1.items()},
              {k: v._data for k, v in aux1.items()})
    gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    step_ms = statistics.median(gaps[1:])
    if launches["nms_keep_cuda"] != K:
        fail("detect: nms_keep_cuda launched %d times in %d training "
             "forwards" % (launches["nms_keep_cuda"], K))
    if len(losses) != K or not np.isfinite(losses).all() or \
            not min(losses[1:]) < losses[0]:
        fail("detect: SSD300 losses %s: not finite, or none under the "
             "first" % losses)
    say("detect: SSD300 Module.fit, %d steps: step %.2f ms (median of steps "
        "2..%d, boundary to boundary; all: %s), %.1f img/s, peak device "
        "memory a step %s GB, loss %s, nms_keep_cuda %d launches (one a "
        "training forward)" % (
            K, step_ms, K, " ".join("%.1f" % g for g in gaps),
            B / step_ms * 1e3, " ".join("%.2f" % (p / 1e9) for p in peaks),
            " ".join("%.4f" % v for v in losses), launches["nms_keep_cuda"]))

    with mx.gpu(0):
        batch = io.DataBatch([mx.nd.array(X[:B])], [mx.nd.array(Y[:B])])

    def one_step():
        mod.forward_backward(batch)
        mod.update()
    profile("SSD300 training step (batch %d, f32)" % B, one_step, top=12)
    step_launches = sum(profile.counts.values())
    nms_n = kernel_counts(profile.counts, ("nms_cluster_kernel",))
    say("detect: profiled step: %d launches, busy %.1f%%, NMS kernel x%d"
        % (step_launches, 100 * profile.busy, nms_n["nms_cluster_kernel"]))

    # the target op alone, at the step's shapes, and its rules
    heads = mx.Predictor(heads_sym, {k: v._data for k, v in
                                     mod.get_params()[0].items()},
                         data_names=("data",), ctx=mx.gpu(0))
    cls_prob, _loc, anchors = (h.handle for h in heads.forward(X[:B]))
    logits = torch.log(cls_prob)
    labels = torch.from_numpy(Y[:B]).cuda()
    op = get_op("_contrib_MultiBoxTarget")
    attrs = {**op.defaults, **SSD_TARGET}

    def target():
        return op.fn(anchors, labels, logits, **attrs)
    outs = [o.cpu().numpy() for o in target()]
    stats = check_ssd_targets("detect: SSD300 targets", anchors.cpu().numpy(),
                              Y[:B], *outs)
    tgt_ms = time_ms(target, reps=10, warmup=2)
    tgt_dev = device_ms(target, "", reps=10)
    say("detect: MultiBoxTarget at batch %d x %d anchors x %d label rows: "
        "%.3f ms by events, %.3f ms of kernels (%d launches); every valid "
        "gt matched, min(3P, A-P) negatives, mask at the positives "
        "(positives a image %d..%d, negatives %d..%d)" % (
            B, SSD_ANCHORS, SSD_LABEL_ROWS, tgt_ms, tgt_dev,
            device_ms.launches, min(p for p, _ in stats),
            max(p for p, _ in stats), min(n for _, n in stats),
            max(n for _, n in stats)))
    del mod, heads, cls_prob, logits, anchors, labels, batch, args
    torch.cuda.empty_cache()
    return launches


# examples/rcnn_train.py's Faster R-CNN (its 64x64 images: the repo's one
# Faster R-CNN): two stride-2 convolutions to a 16x16 map, anchors of
# sides 8/16/32 px, 2 foreground classes, 8 proposals an image
RCNN = dict(image=64, stride=4, scales=(2, 4, 8), ratios=(1.0,), classes=2,
            post=8, batch=4, lr=0.02, steps=6)
RCNN_TOL = dict(rtol=1e-4, atol=1e-5)
# upstream example/rcnn's end-to-end VGG16 setting: 600x1000 at stride 16
RCNN_VGG = dict(feat=(38, 63), stride=16, scales=(8, 16, 32),
                ratios=(0.5, 1, 2), channels=512, threshold=0.7,
                min_size=16, test=(6000, 300), train=(12000, 2000))
ROI_COUNTS = (128, 300)
# forward + backward ms by events with the earlier backward, which added
# by index_put_ accumulate (PERF.md §6; H100 80GB HBM3, 700 W)
ROI_ACCUMULATING_MS = {128: 6.562, 300: 15.156}
PROPOSAL_TOL = dict(rtol=1e-6, atol=1e-4)    # boxes up to 1000 px
# the gradient's sums over up to a few hundred rois a cell, card against
# CPU (one order of adds on both; the shares' rounding may differ)
ROI_GRAD_TOL = dict(rtol=1e-5, atol=1e-4)


def _rcnn_anchors(mx):
    import importlib
    rc = importlib.import_module(mx.__name__ + ".ops.rcnn_ops")
    feat = RCNN["image"] // RCNN["stride"]
    return rc._shifted_anchors(feat, feat, RCNN["stride"], RCNN["scales"],
                               RCNN["ratios"])


def _rcnn_iou(boxes, gt):
    """boxes (N,4), gt (4,) -> (N,) IoU with +1 widths (proposal.cc)."""
    ix1 = np.maximum(boxes[:, 0], gt[0])
    iy1 = np.maximum(boxes[:, 1], gt[1])
    ix2 = np.minimum(boxes[:, 2], gt[2])
    iy2 = np.minimum(boxes[:, 3], gt[3])
    inter = np.maximum(ix2 - ix1 + 1, 0) * np.maximum(iy2 - iy1 + 1, 0)
    area = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    garea = (gt[2] - gt[0] + 1) * (gt[3] - gt[1] + 1)
    return inter / np.maximum(area + garea - inter, 1e-9)


def _rcnn_encode(anchors, gt):
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + 0.5 * (aw - 1)
    ay = anchors[:, 1] + 0.5 * (ah - 1)
    gw = gt[2] - gt[0] + 1.0
    gh = gt[3] - gt[1] + 1.0
    gx = gt[0] + 0.5 * (gw - 1)
    gy = gt[1] + 0.5 * (gh - 1)
    return np.stack([(gx - ax) / aw, (gy - ay) / ah,
                     np.log(gw / aw), np.log(gh / ah)], axis=1)


def rcnn_register(mx):
    """Register examples/rcnn_train.py's two target ops (AnchorTarget,
    ProposalTarget) as Custom ops of ``mx`` (either package); registering
    again makes fresh operators. Returns the list the ops append their
    input's context to, a call."""
    A = len(RCNN["scales"]) * len(RCNN["ratios"])
    feat = RCNN["image"] // RCNN["stride"]
    seen = []

    class AnchorTargetOp(mx.operator.CustomOp):
        def __init__(self):
            super().__init__()
            self._rng = np.random.RandomState(11)

        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append(str(in_data[0].context))
            gt = in_data[0].asnumpy()
            B = gt.shape[0]
            anchors = _rcnn_anchors(mx)
            label = np.full((B, A * feat * feat), -1, np.float32)
            tgt = np.zeros((B, A * 4, feat, feat), np.float32)
            wgt = np.zeros((B, A * 4, feat, feat), np.float32)
            hh, ww, aa = np.meshgrid(np.arange(feat), np.arange(feat),
                                     np.arange(A), indexing="ij")
            lab_idx = (aa * feat * feat + hh * feat + ww).reshape(-1)
            for b in range(B):
                iou = _rcnn_iou(anchors, gt[b, 1:])
                pos = iou > 0.5
                pos[np.argmax(iou)] = True
                neg_idx = np.nonzero((iou < 0.3) & ~pos)[0]
                keep_n = min(len(neg_idx), max(16, 8 * int(pos.sum())))
                neg_keep = self._rng.choice(neg_idx, keep_n, replace=False)
                label[b, lab_idx[pos]] = 1.0
                label[b, lab_idx[neg_keep]] = 0.0
                deltas = _rcnn_encode(anchors[pos], gt[b, 1:])
                ph, pw, pa = (v.reshape(-1)[pos] for v in (hh, ww, aa))
                for c in range(4):
                    tgt[b, pa * 4 + c, ph, pw] = deltas[:, c]
                    wgt[b, pa * 4 + c, ph, pw] = 1.0
            self.assign(out_data[0], req[0], label)
            self.assign(out_data[1], req[1], tgt)
            self.assign(out_data[2], req[2], wgt)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 0.0)

    @mx.operator.register("rcnn_anchor_target")
    class AnchorTargetProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["gt_boxes"]

        def list_outputs(self):
            return ["label", "bbox_target", "bbox_weight"]

        def infer_shape(self, in_shape):
            B = in_shape[0][0]
            return ([in_shape[0]],
                    [(B, A * feat * feat), (B, A * 4, feat, feat),
                     (B, A * 4, feat, feat)], [])

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return AnchorTargetOp()

    class ProposalTargetOp(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append(str(in_data[0].context))
            rois = in_data[0].asnumpy()
            gt = in_data[1].asnumpy()
            R = rois.shape[0]
            label = np.zeros((R,), np.float32)
            tgt = np.zeros((R, 4), np.float32)
            wgt = np.zeros((R, 4), np.float32)
            for r in range(R):
                b = int(rois[r, 0])
                if _rcnn_iou(rois[r:r + 1, 1:], gt[b, 1:])[0] > 0.5:
                    label[r] = gt[b, 0]
                    tgt[r] = _rcnn_encode(rois[r:r + 1, 1:], gt[b, 1:])[0]
                    wgt[r] = 1.0
            self.assign(out_data[0], req[0], rois)
            self.assign(out_data[1], req[1], label)
            self.assign(out_data[2], req[2], tgt)
            self.assign(out_data[3], req[3], wgt)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 0.0)
            self.assign(in_grad[1], req[1], 0.0)

    @mx.operator.register("rcnn_proposal_target")
    class ProposalTargetProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["rois", "gt_boxes"]

        def list_outputs(self):
            return ["rois_out", "label", "bbox_target", "bbox_weight"]

        def infer_shape(self, in_shape):
            R = in_shape[0][0]
            return (in_shape, [(R, 5), (R,), (R, 4), (R, 4)], [])

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ProposalTargetOp()

    return seen


def faster_rcnn_symbol(mx):
    """examples/rcnn_train.py's graph, written against ``mx`` (either
    package, after ``rcnn_register(mx)``): the RPN over two stride-2
    convolutions, AnchorTarget's labels under SoftmaxOutput and its box
    targets under smooth_l1, _contrib_Proposal, ProposalTarget,
    ROIPooling over BlockGrad(body), the FC head's two losses."""
    S = mx.sym
    A = len(RCNN["scales"]) * len(RCNN["ratios"])
    feat, post = RCNN["image"] // RCNN["stride"], RCNN["post"]
    data, im_info, gt_boxes = (S.Variable(n) for n in
                               ("data", "im_info", "gt_boxes"))
    body = S.Activation(S.Convolution(
        data, kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=16,
        name="conv1"), act_type="relu")
    body = S.Activation(S.Convolution(
        body, kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=32,
        name="conv2"), act_type="relu")
    rpn = S.Activation(S.Convolution(
        body, kernel=(3, 3), pad=(1, 1), num_filter=32, name="rpn_conv"),
        act_type="relu")
    rpn_cls = S.Convolution(rpn, kernel=(1, 1), num_filter=2 * A,
                            name="rpn_cls")
    rpn_bbox = S.Convolution(rpn, kernel=(1, 1), num_filter=4 * A,
                             name="rpn_bbox")
    tgt = S.Custom(gt_boxes=gt_boxes, name="anchor_target",
                   op_type="rcnn_anchor_target")
    rpn_cls_2 = S.Reshape(rpn_cls, shape=(0, 2, -1))
    rpn_cls_prob = S.SoftmaxOutput(
        rpn_cls_2, tgt[0], multi_output=True, use_ignore=True,
        ignore_label=-1, normalization="valid", name="rpn_cls_prob")
    rpn_bbox_loss = S.MakeLoss(
        S.smooth_l1(tgt[2] * (rpn_bbox - tgt[1]), scalar=3.0),
        grad_scale=1.0 / (A * feat * feat), name="rpn_bbox_loss")
    score = S.Reshape(S.SoftmaxActivation(rpn_cls_2, mode="channel"),
                      shape=(0, 2 * A, feat, feat))
    rois = S.Custom(
        rois=S._contrib_Proposal(
            S.BlockGrad(score), S.BlockGrad(rpn_bbox), im_info,
            rpn_pre_nms_top_n=64, rpn_post_nms_top_n=post, threshold=0.7,
            rpn_min_size=4, scales=RCNN["scales"], ratios=RCNN["ratios"],
            feature_stride=RCNN["stride"], name="proposal"),
        gt_boxes=gt_boxes, name="proposal_target",
        op_type="rcnn_proposal_target")
    pooled = S.ROIPooling(S.BlockGrad(body), rois[0], pooled_size=(4, 4),
                          spatial_scale=1.0 / RCNN["stride"],
                          name="roi_pool")
    fc = S.Activation(S.FullyConnected(S.Flatten(pooled), num_hidden=64,
                                       name="fc6"), act_type="relu")
    head_cls = S.FullyConnected(fc, num_hidden=RCNN["classes"] + 1,
                                name="head_cls")
    head_bbox = S.FullyConnected(fc, num_hidden=4, name="head_bbox")
    head_cls_prob = S.SoftmaxOutput(head_cls, rois[1],
                                    normalization="valid",
                                    name="head_cls_prob")
    head_bbox_loss = S.MakeLoss(
        S.smooth_l1(rois[3] * (head_bbox - rois[2]), scalar=1.0),
        grad_scale=1.0 / post, name="head_bbox_loss")
    return S.Group([rpn_cls_prob, rpn_bbox_loss, head_cls_prob,
                    head_bbox_loss, S.BlockGrad(rois[0]),
                    S.BlockGrad(rois[1])])


def rcnn_dataset(n, seed):
    """examples/rcnn_train.py's make_dataset: one bright object a 64x64
    image (class 1 a square of 14..21 px, class 2 a 26..33 x 10..13
    rectangle); gt (n, 5) [class, x1, y1, x2, y2]."""
    rng = np.random.RandomState(seed)
    im = RCNN["image"]
    X = rng.uniform(0, 0.15, (n, 3, im, im)).astype(np.float32)
    gt = np.zeros((n, 5), np.float32)
    for i in range(n):
        cls = 1 + (i % 2)
        if cls == 1:
            w = h = rng.randint(14, 22)
        else:
            w = rng.randint(26, 34)
            h = rng.randint(10, 14)
        x1 = rng.randint(2, im - w - 2)
        y1 = rng.randint(2, im - h - 2)
        X[i, cls - 1, y1:y1 + h, x1:x1 + w] += 0.9
        X[i, 2, y1:y1 + h, x1:x1 + w] += 0.4
        gt[i] = (cls, x1, y1, x1 + w - 1, y1 + h - 1)
    return X, gt


def rcnn_params(mx, sym, seed):
    """The Faster R-CNN's weights as numpy arrays: Xavier from
    mx.random.seed(seed), zero biases."""
    from mxnet_tpu_torch.initializer import InitDesc, Xavier
    B, im = RCNN["batch"], RCNN["image"]
    shapes, _, _ = sym.infer_shape(data=(B, 3, im, im), im_info=(B, 3),
                                   gt_boxes=(B, 5))
    init = Xavier()
    mx.random.seed(seed)
    params = {}
    for name, shp in zip(sym.list_arguments(), shapes):
        if name in ("data", "im_info", "gt_boxes"):
            continue
        arr = mx.nd.zeros(shp, ctx=mx.cpu())
        init(InitDesc(name), arr)
        params[name] = arr.asnumpy()
    return params


def rcnn_module(mx, sym, ctx, params):
    B = RCNN["batch"]
    mod = mx.mod.Module(sym, data_names=("data", "im_info"),
                        label_names=("gt_boxes",), context=ctx)
    im = RCNN["image"]
    mod.bind(data_shapes=[("data", (B, 3, im, im)), ("im_info", (B, 3))],
             label_shapes=[("gt_boxes", (B, 5))])
    with ctx:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in params.items()},
                        aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RCNN["lr"], "momentum": 0.9,
        "rescale_grad": 1.0 / B})
    return mod


def rcnn_phase():
    """(b) examples/rcnn_train.py's Faster R-CNN through Module: one step
    card against CPU from one set of weights (outputs within RCNN_TOL,
    updates within SSD_UPDATE_RTOL in norm), a few Module.fit steps on
    the card with finite losses, the Custom ops run on the card and
    refused by every capture; then _contrib_Proposal and ROIPooling
    timed alone at upstream example/rcnn's VGG16 shapes."""
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import make_train_step

    B, im = RCNN["batch"], RCNN["image"]
    rcnn_register(mx)
    sym = faster_rcnn_symbol(mx)
    params = rcnn_params(mx, sym, seed=0)
    X, gt = rcnn_dataset(48, seed=0)
    info = np.tile(np.array([im, im, 1.0], np.float32), (B, 1))
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        seen = rcnn_register(mx)         # fresh operators (their rng)
        mod = rcnn_module(mx, sym, ctx, params)
        with ctx:
            batch = io.DataBatch([mx.nd.array(X[:B]), mx.nd.array(info)],
                                 [mx.nd.array(gt[:B])])
        mod.forward(batch, is_train=True)
        outs = [o.asnumpy() for o in mod.get_outputs()]
        mod.backward()
        mod.update()
        after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        res.append((outs, after, set(seen)))
    (card, card_p, card_seen), (cpu, cpu_p, cpu_seen) = res
    if card_seen != {str(mx.gpu(0))} or cpu_seen != {str(mx.cpu())}:
        fail("detect: the Custom ops ran on %s (card run) and %s (CPU run)"
             % (sorted(card_seen), sorted(cpu_seen)))
    errs = [check_close("Faster R-CNN output %d card vs CPU" % i,
                        torch.from_numpy(c), torch.from_numpy(h), RCNN_TOL)
            for i, (c, h) in enumerate(zip(card, cpu))]
    upd = max(_rel_norm({"u": card_p[k] - params[k]},
                        {"u": cpu_p[k] - params[k]}) for k in params)
    if not upd <= SSD_UPDATE_RTOL:
        fail("detect: Faster R-CNN one step's update card vs CPU %.3g "
             "relative in norm" % upd)
    say("detect: Faster R-CNN (examples/rcnn_train.py, batch %d x 3x%dx%d) "
        "one Module step card vs CPU: outputs (the proposals fifth) max "
        "abs err %s (rtol %g, atol %g), largest update error %.3g relative "
        "in norm;"
        " the Custom ops ran on gpu(0) and cpu(0)" % (
            B, im, im, " ".join("%.3g" % e for e in errs),
            RCNN_TOL["rtol"], RCNN_TOL["atol"], upd))

    # a few Module.fit steps on the card
    seen = rcnn_register(mx)
    losses = []

    class Loss(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("rcnn_loss")

        def update(self, labels, preds):
            losses.append([float(p._data.float().sum()) for p in preds[:4]])
    K = RCNN["steps"]
    it = io.NDArrayIter({"data": X[:K * B], "im_info": np.tile(
        info[:1], (K * B, 1))}, {"gt_boxes": gt[:K * B]}, batch_size=B)
    mod = mx.mod.Module(sym, data_names=("data", "im_info"),
                        label_names=("gt_boxes",), context=mx.gpu(0))
    with mx.cpu():
        args = {k: mx.nd.array(v) for k, v in params.items()}
    t = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params={
        "learning_rate": RCNN["lr"], "momentum": 0.9,
        "rescale_grad": 1.0 / B}, eval_metric=Loss(), arg_params=args,
        aux_params={})
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    if len(losses) != K or not np.isfinite(losses).all():
        fail("detect: Faster R-CNN fit outputs %s" % losses)
    if set(seen) != {str(mx.gpu(0))}:
        fail("detect: the fit's Custom ops ran on %s" % sorted(set(seen)))
    refused = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rcnn_")
    for what, call in (
            ("TrainStep.export", lambda: make_train_step(
                sym, optimizer="sgd").export(os.path.join(tmp, "s"), None,
                                             None)),
            ("Predictor.export_buckets", lambda: mx.Predictor(
                sym, {k: v._data for k, v in mod.get_params()[0].items()},
                data_names=("data", "im_info", "gt_boxes")).export_buckets(
                    os.path.join(tmp, "p"), [(3, im, im), (3,), (5,)]))):
        try:
            call()
        except MXNetError as e:
            if "anchor_target" not in str(e) or \
                    "proposal_target" not in str(e):
                fail("detect: %s refused without naming the Custom nodes: "
                     "%s" % (what, e))
            refused.append(what)
        else:
            fail("detect: %s of a graph with Custom nodes did not raise"
                 % what)
    shutil.rmtree(tmp, ignore_errors=True)
    say("detect: Faster R-CNN Module.fit %d steps on the card in %.2f s: "
        "the four heads' outputs finite (their sums at the last step %s); "
        "the Custom ops ran on "
        "gpu(0); %s refused, naming the Custom nodes" % (
            K, fit_s, " ".join("%.4g" % v for v in losses[-1]),
            " and ".join(refused)))
    del mod
    proposal_timing()
    roi_pooling_timing()


def proposal_timing():
    """_contrib_Proposal at upstream example/rcnn's VGG16 end-to-end
    setting (batch 1, a 38x63 map, 9 anchors a cell: 21,546), test (pre
    6000, post 300) and train (pre 12000, post 2000): ms by events, the
    fixed-point walk's sweeps and ms alone, card equal to the CPU, and
    the walk's keep mask equal to the sequential loop's flag for flag."""
    import torch
    from mxnet_tpu_torch.ops import rcnn_ops
    from mxnet_tpu_torch.ops.registry import get_op

    cfg = RCNN_VGG
    H, W = cfg["feat"]
    A = len(cfg["scales"]) * len(cfg["ratios"])
    rs = np.random.RandomState(3)
    fg = rs.uniform(0, 1, (1, A, H, W)).astype(np.float32)
    prob = np.concatenate([1 - fg, fg], 1)
    deltas = (rs.standard_normal((1, 4 * A, H, W)) * 0.1).astype(np.float32)
    info = np.array([[H * cfg["stride"], W * cfg["stride"], 1.0]],
                    np.float32)
    op = get_op("_contrib_Proposal")
    for mode in ("test", "train"):
        pre, post = cfg[mode]
        attrs = {**op.defaults, "rpn_pre_nms_top_n": pre,
                 "rpn_post_nms_top_n": post, "threshold": cfg["threshold"],
                 "rpn_min_size": cfg["min_size"], "scales": cfg["scales"],
                 "ratios": cfg["ratios"], "feature_stride": cfg["stride"],
                 "output_score": True}
        card_in = [torch.from_numpy(a).cuda() for a in (prob, deltas, info)]
        rois, scores = op.fn(*card_in, **attrs)
        c_rois, c_scores = op.fn(*[torch.from_numpy(a) for a in
                                   (prob, deltas, info)], **attrs)
        # exp rounds in its last bit on one device and not the other
        err = check_close("Proposal (%s) rois card vs CPU" % mode,
                          rois.cpu(), c_rois, PROPOSAL_TOL)
        if not torch.equal(scores.cpu(), c_scores):
            fail("detect: Proposal (%s) card vs CPU: the scores differ"
                 % mode)
        ms = time_ms(lambda: op.fn(*card_in, **attrs), reps=5, warmup=1)
        # the walk alone, and against the sequential loop, on the card
        boxes, score = rcnn_ops._candidates(
            *card_in, pre, cfg["min_size"], cfg["scales"], cfg["ratios"],
            cfg["stride"])
        sup = rcnn_ops._suppression(boxes, cfg["threshold"])
        valid = score > float("-inf")
        keep, n_sw = rcnn_ops._sweep_keep(sup, valid)
        dense = rcnn_ops._dense_keep(sup, valid)
        if not torch.equal(keep, dense):
            fail("detect: the fixed-point walk's keep mask differs from the "
                 "sequential loop's (%s, %d rows)" % (mode, pre))
        walk_ms = time_ms(lambda: rcnn_ops._sweep_keep(sup, valid), reps=5,
                          warmup=1)
        say("detect: Proposal %s (pre %d, post %d, %d anchors, %dx%d): "
            "%.3f ms by events, %d fixed-point sweeps; scores equal to the "
            "CPU's, rois within %.3g; the walk alone over %d candidates (%d "
            "kept) %.3f ms by events, its keep mask equal to the sequential "
            "loop's flag for flag" % (mode, pre, post, A * H * W, H, W, ms,
                                      n_sw, err, pre, int(keep.sum()),
                                      walk_ms))
        del sup, keep, dense, card_in, rois
    torch.cuda.empty_cache()


def roi_pooling_timing():
    """ROIPooling at the VGG16 map (1, 512, 38, 63), 7x7, spatial scale
    1/16, with ROI_COUNTS rois in a 600x1000 image: forward and backward
    ms by events; the forward equal to the CPU's, the gradient within
    ROI_GRAD_TOL of it and equal bit for bit across two card runs (the
    backward adds by the fixed-order segment sum, ROADMAP Queue C 21)."""
    import torch
    from mxnet_tpu_torch.ops.registry import get_op

    H, W = RCNN_VGG["feat"]
    op = get_op("ROIPooling")
    rs = np.random.RandomState(4)
    data = np.maximum(rs.standard_normal(
        (1, RCNN_VGG["channels"], H, W)), 0).astype(np.float32)
    for R in ROI_COUNTS:
        xy = rs.uniform(0, [1000, 600], (R, 2))
        wh = rs.uniform(16, 400, (R, 2))
        rois = np.concatenate([np.zeros((R, 1)), xy, np.minimum(
            xy + wh, [999, 599])], 1).astype(np.float32)
        dy = rs.standard_normal((R, RCNN_VGG["channels"], 7, 7)).astype(
            np.float32)
        outs = []
        for dev in ("cuda", "cuda", "cpu"):
            x = torch.from_numpy(data).to(dev).requires_grad_()
            y = op.fn(x, torch.from_numpy(rois).to(dev), pooled_size=(7, 7),
                      spatial_scale=1.0 / RCNN_VGG["stride"])
            g, = torch.autograd.grad(y, x, torch.from_numpy(dy).to(dev))
            outs.append((y.detach().cpu(), g.cpu()))
        if not torch.equal(outs[0][0], outs[2][0]):
            fail("detect: ROIPooling forward card vs CPU differs (%d rois)"
                 % R)
        if not torch.equal(outs[0][1], outs[1][1]):
            fail("detect: ROIPooling gradient differs between two card runs "
                 "(%d rois): max |a - b| %g" % (R, float(
                     (outs[0][1] - outs[1][1]).abs().max())))
        gerr = check_close("ROIPooling gradient card vs CPU (%d rois)" % R,
                           outs[0][1], outs[2][1], ROI_GRAD_TOL)
        x = torch.from_numpy(data).cuda().requires_grad_()
        r = torch.from_numpy(rois).cuda()
        g_out = torch.from_numpy(dy).cuda()
        fwd = time_ms(lambda: op.fn(x.detach(), r, pooled_size=(7, 7),
                                    spatial_scale=1.0 / 16), reps=10)

        def fwd_bwd():
            y = op.fn(x, r, pooled_size=(7, 7), spatial_scale=1.0 / 16)
            torch.autograd.grad(y, x, g_out)
        both = time_ms(fwd_bwd, reps=10)
        say("detect: ROIPooling (1, %d, %d, %d), %d rois, 7x7, 1/16: forward "
            "%.3f ms, forward + backward %.3f ms by events (the "
            "accumulating index_put_ backward: %s ms); forward equal to "
            "the CPU's, gradient max abs err %.3g, bit-equal across two "
            "card runs" % (
                RCNN_VGG["channels"], H, W, R, fwd, both,
                ROI_ACCUMULATING_MS.get(R, "not measured"), gerr))
    torch.cuda.empty_cache()


def other_ops_cases():
    """(c)'s ops at one small shape each: (op name, inputs, attrs)."""
    rs = np.random.RandomState(6)

    def f(*shape):
        return rs.standard_normal(shape).astype(np.float32)
    spd = f(5, 5)
    spd = spd @ spd.T + 5 * np.eye(5, dtype=np.float32)
    tri = np.tril(f(5, 5)) + 3 * np.eye(5, dtype=np.float32)
    lo, hi = np.array([-1.5], np.float32), np.array([2.0], np.float32)
    return [
        ("GridGenerator", [f(2, 6) * 0.3], {"transform_type": "affine",
                                            "target_shape": (6, 7)}),
        ("GridGenerator", [f(2, 2, 6, 7)], {"transform_type": "warp"}),
        ("BilinearSampler", [f(2, 3, 8, 9), f(2, 2, 6, 7) * 0.8], {}),
        ("SpatialTransformer", [f(2, 3, 8, 9), np.tile(np.array(
            [[0.9, 0.1, 0.05, -0.1, 0.8, 0.1]], np.float32), (2, 1))],
         {"target_shape": (6, 7)}),
        ("Correlation", [f(2, 4, 9, 10), f(2, 4, 9, 10)],
         {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
          "pad_size": 3}),
        ("_linalg_gemm", [f(2, 3, 4), f(2, 4, 5), f(2, 3, 5)],
         {"alpha": 0.5, "beta": 2.0}),
        ("_linalg_gemm2", [f(4, 3), f(4, 5)], {"transpose_a": True}),
        ("_linalg_potrf", [spd], {}),
        ("_linalg_potri", [tri], {}),
        ("_linalg_trmm", [tri, f(5, 3)], {"transpose": True}),
        ("_linalg_trsm", [tri, f(3, 5)], {"rightside": True,
                                          "alpha": 0.5}),
        ("_linalg_syrk", [f(3, 5)], {}),
        ("_linalg_sumlogdiag", [tri], {}),
        ("khatri_rao", [f(2, 3), f(4, 3)], {}),
        ("_contrib_fft", [f(4, 16)], {}),
        ("_contrib_ifft", [f(4, 32)], {}),
        ("_contrib_count_sketch", [f(6, 40), rs.randint(
            0, 12, (1, 40)).astype(np.float32), np.where(
            f(1, 40) > 0, 1, -1).astype(np.float32)], {"out_dim": 12}),
        ("_contrib_quantize", [f(6, 7), lo, hi], {}),
        ("_contrib_dequantize", [rs.randint(0, 256, (6, 7)).astype(
            np.uint8), lo, hi], {}),
    ]


OTHER_TOL = dict(rtol=1e-5, atol=1e-5)   # cuBLAS/cuSOLVER/cuFFT vs CPU


def other_ops_phase():
    """(c) the warp ops, linalg, fft/ifft, count_sketch and the quantize
    pair on the card against the port's CPU at one small shape each,
    within OTHER_TOL (integer outputs equal); gelqf by its invariants
    (L.Q = A, Q.Q^T = I, |diag L| as the CPU's), since Q and L are unique
    only up to row signs."""
    import torch
    from mxnet_tpu_torch.ops.registry import canon_attrs, get_op

    worst = {}
    for name, inputs, attrs in other_ops_cases():
        op = get_op(name)
        a = canon_attrs(op, attrs)
        outs = []
        for dev in ("cuda", "cpu"):
            o = op.fn(*[torch.from_numpy(x).to(dev) for x in inputs], **a)
            outs.append([t.cpu() for t in (o if isinstance(o, (tuple, list))
                                           else [o])])
        for c, h in zip(*outs):
            if c.dtype.is_floating_point:
                err = check_close("%s card vs CPU" % name, c, h, OTHER_TOL)
            elif not torch.equal(c, h):
                fail("detect: %s card vs CPU: integer outputs differ" % name)
            else:
                err = 0.0
            worst[name] = max(worst.get(name, 0.0), err)
    A = np.random.RandomState(7).standard_normal((3, 5)).astype(np.float32)
    op = get_op("_linalg_gelqf")
    q, l = (t.double().cpu() for t in op.fn(torch.from_numpy(A).cuda()))
    _q, cl = op.fn(torch.from_numpy(A))
    a64 = torch.from_numpy(A).double()
    lq = float((l @ q - a64).abs().max())
    orth = float((q @ q.T - torch.eye(3, dtype=torch.float64)).abs().max())
    diag = float((l.diagonal().abs() - cl.double().diagonal().abs())
                 .abs().max())
    if max(lq, orth, diag) > 1e-5:
        fail("detect: gelqf on the card: |LQ - A| %g, |QQ^T - I| %g, "
             "||diag L| - CPU's| %g" % (lq, orth, diag))
    say("detect: other ops card vs CPU (rtol %g, atol %g): %s; gelqf |LQ - "
        "A| %.3g, |QQ^T - I| %.3g, |diag L| against the CPU's %.3g" % (
            OTHER_TOL["rtol"], OTHER_TOL["atol"], ", ".join(
                "%s %.3g" % kv for kv in worst.items()), lq, orth, diag))


def detect_phase():
    """Detection training and the rest of the op catalog on the card: (a)
    SSD300 trained at full width through Module.fit, (b) Faster R-CNN
    with its Custom target ops, Proposal and ROIPooling at VGG16's
    shapes, (c) the other ops card against CPU. Returns (a)'s launch
    counts of the port's kernels."""
    t0 = time.perf_counter()
    launches = ssd_train_phase()
    rcnn_phase()
    other_ops_phase()
    say("detect: phase done in %.1f s" % (time.perf_counter() - t0))
    return launches


# sparse (a): linear classification over CSR at LIBSVM's avazu-app shape
# (1,000,000 features, 15 non-zeros a row: one hashed categorical value
# in each of 15 fields, value 1), synthesised from a seed since the
# dataset is not here; examples/linear_svm_sparse.py's hinge loop with
# the weight in a 'local' KVStore
AVAZU = dict(features=1_000_000, fields=15, batch=8192, batches=16, lr=0.1,
             zipf=1.3)
SPARSE_STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# sparse (b): the row-sparse embedding recipe at MovieLens-20M's counts
MOVIELENS = dict(users=138_493, items=27_278, rank=64, batch=8192, steps=6,
                 lr=0.01)


def avazu_libsvm(path, seed=0):
    """AVAZU's batches of seeded LibSVM rows at ``path``: each field's
    value drawn Zipf-skewed within its slice of the columns (hashed
    categorical features are skewed), label 1 where a hidden linear
    model of the row is positive. Returns the row count."""
    F, nf = AVAZU["features"], AVAZU["fields"]
    n = AVAZU["batch"] * AVAZU["batches"]
    width = F // nf
    rng = np.random.RandomState(seed)
    rank = np.minimum(rng.zipf(AVAZU["zipf"], (n, nf)), width) - 1
    cols = rank + np.arange(nf) * width            # sorted within a row
    hidden = rng.standard_normal(F).astype(np.float32)
    labels = (hidden[cols].sum(1) > 0).astype(int)
    with open(path, "w") as f:
        f.writelines("%d %s\n" % (lab, " ".join("%d:1" % c for c in row))
                     for lab, row in zip(labels, cols))
    return n


def avazu_step(mx, kv, X, y):
    """One step of the sparse linear SVM: the batch's weight rows by
    row_sparse_pull, the csr dot, the hinge subgradient through the
    transposed csr dot cast to row-sparse, and its push (the store's SGD
    updates only those rows). Returns the logits."""
    w = mx.nd.sparse.zeros("row_sparse", (AVAZU["features"], 1),
                           ctx=X.context)
    kv.row_sparse_pull("w", out=w, row_ids=X.indices)
    logits = mx.nd.dot(X, w.tostype("default"))
    sign = y.reshape((-1, 1)) * 2 - 1
    g = mx.nd.where(logits * sign < 1, -sign, mx.nd.zeros_like(sign))
    kv.push("w", mx.nd.dot(X, g, transpose_a=True).tostype("row_sparse"))
    return logits


def avazu_store(mx, ctx, w0):
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=AVAZU["lr"],
                                      rescale_grad=1.0 / AVAZU["batch"]))
    kv.init("w", mx.nd.array(w0, ctx=ctx))
    return kv


def avazu_run(mx, it, w0):
    """AVAZU's batches through avazu_step on the card from ``w0``: (final
    weight tensor, events ms, wall ms, host ms a batch, host syncs)."""
    import torch
    from mxnet_tpu_torch import profiler
    kv = avazu_store(mx, mx.gpu(0), w0)
    it.reset()
    ev, wall, host = [], [], []
    syncs = profiler.host_sync_count()
    while True:
        t = time.perf_counter()
        with mx.gpu(0):
            batch = next(it, None)
        if batch is None:
            break
        host.append((time.perf_counter() - t) * 1e3)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        a.record()
        avazu_step(mx, kv, batch.data[0], batch.label[0])
        b.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
        ev.append(a.elapsed_time(b))
    syncs = profiler.host_sync_count() - syncs
    out = mx.nd.zeros((AVAZU["features"], 1))
    kv.pull("w", out=out)
    return out._data, ev, wall, host, syncs


def sparse_dot_timing(mx, X, w_full, g):
    """sparse.dot forward and transposed on one batch's CSR beside
    torch.sparse.mm over the same CSR (cuSPARSE), with each one's byte
    bound: the CSR, the rhs rows it reads and the output, once each."""
    import torch
    vals, cols, ptr = X._data, X._indices, X._indptr
    B, F = X.shape
    with warnings.catch_warnings():      # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        lib = torch.sparse_csr_tensor(ptr, cols, vals, (B, F))
        lib_t = lib.to_sparse_coo().t().coalesce().to_sparse_csr()
    wnd, gnd = mx.nd.NDArray(w_full), mx.nd.NDArray(g)
    csr_bytes = (vals.numel() + cols.numel() + ptr.numel()) * 4
    touched = int(torch.unique(cols).numel())
    rows = []
    for what, ours, theirs, nbytes in (
            ("forward", lambda: mx.nd.dot(X, wnd),
             lambda: torch.sparse.mm(lib, w_full),
             csr_bytes + touched * 4 + B * 4),
            ("transposed", lambda: mx.nd.dot(X, gnd, transpose_a=True),
             lambda: torch.sparse.mm(lib_t, g), csr_bytes + B * 4 + F * 4)):
        check_close("sparse (a): sparse.dot %s against torch.sparse.mm"
                    % what, ours()._data, theirs(), SPARSE_STEP_TOL)
        rows.append("%s %.4f ms (torch.sparse.mm %.4f ms; bound %.5f ms, "
                    "%.2f MB)" % (what, time_ms(ours), time_ms(theirs),
                                  nbytes / PEAK_BYTES_PER_S * 1e3,
                                  nbytes / 1e6))
    say("sparse (a): sparse.dot at batch %d x %d, %d non-zeros (%d columns "
        "touched), by events: %s" % (B, F, vals.numel(), touched,
                                     "; ".join(rows)))


def sparse_linear_phase():
    """(a) the sparse linear SVM over LibSVMIter batches at AVAZU's shape
    on the card: step ms (events, wall), rows/s, peak memory, a profiled
    step's launches, host syncs a step, the iterator's host ms a batch;
    one step card against CPU within SPARSE_STEP_TOL; the weights after
    every step bit-equal across two runs."""
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io

    B, F = AVAZU["batch"], AVAZU["features"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "avazu.libsvm")
        n = avazu_libsvm(path)
        t1 = time.perf_counter()
        it = io.LibSVMIter(data_libsvm=path, data_shape=(F,), batch_size=B)
    t2 = time.perf_counter()
    w0 = (np.random.RandomState(1).standard_normal((F, 1)) * 0.01).astype(
        np.float32)
    say("sparse (a): LibSVM file of %d rows x %d features (%d a row) "
        "written in %.1f s, parsed by LibSVMIter in %.1f s" % (
            n, F, AVAZU["fields"], t1 - t0, t2 - t1))

    # one step card against CPU, from the same weight and batch
    with mx.gpu(0):
        batch = next(it)
    it.reset()
    X, y = batch.data[0], batch.label[0]
    got = []
    for ctx in (mx.gpu(0), mx.cpu()):
        kv = avazu_store(mx, ctx, w0)
        logits = avazu_step(mx, kv, X.as_in_context(ctx),
                            y.as_in_context(ctx))
        out = mx.nd.zeros((F, 1), ctx=ctx)
        kv.pull("w", out=out)
        got.append((logits._data.cpu(), out._data.cpu()))
    lerr = check_close("sparse (a): logits card vs CPU", got[0][0],
                       got[1][0], SPARSE_STEP_TOL)
    werr = check_close("sparse (a): weights after a step card vs CPU",
                       got[0][1], got[1][1], SPARSE_STEP_TOL)
    moved = int((got[0][1] != torch.from_numpy(w0)).sum())
    if not 0 < moved < F // 2:
        fail("sparse (a): %d of %d weight rows moved in one lazy step"
             % (moved, F))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w_a, ev, wall, host, syncs = avazu_run(mx, it, w0)
    peak = torch.cuda.max_memory_allocated()
    w_b = avazu_run(mx, it, w0)[0]
    if not torch.equal(w_a, w_b):
        fail("sparse (a): the weights after %d steps differ between two "
             "card runs (max |a - b| %g)" % (len(ev), float(
                 (w_a - w_b).abs().max())))
    kv = avazu_store(mx, mx.gpu(0), w0)
    profile("sparse (a) step (batch %d, %d features)" % (B, F),
            lambda: avazu_step(mx, kv, X, y))
    step_ev, step_wall = statistics.median(ev[1:]), statistics.median(
        wall[1:])
    say("sparse (a): %d steps of batch %d: %.3f ms a step by events, %.3f "
        "ms wall (medians of steps 2..%d), %.0f rows/s, peak %.3f GB, %d "
        "launches a profiled step, %.1f host syncs a step, LibSVMIter %.3f "
        "ms of host a batch (median); one step card vs CPU: logits %.3g, "
        "weights %.3g (%d rows moved); the weights after every step "
        "bit-equal across two card runs" % (
            len(ev), B, step_ev, step_wall, len(ev), B / step_wall * 1e3,
            peak / 1e9, sum(profile.counts.values()), syncs / len(ev),
            statistics.median(host), lerr, werr, moved))
    g = torch.from_numpy(np.random.RandomState(3).choice(
        [-1.0, 1.0], (B, 1)).astype(np.float32)).cuda()
    sparse_dot_timing(mx, X, w_a, g)
    return step_ev


def movielens_batches(seed=0):
    """MOVIELENS's seeded ratings: per step (user ids, item ids, ratings)
    with ids Zipf-skewed as the dataset's popular items and users are."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(MOVIELENS["steps"]):
        ids = [np.minimum(rng.zipf(1.2, MOVIELENS["batch"]),
                          MOVIELENS[k]) - 1 for k in ("users", "items")]
        out.append(ids + [rng.randint(1, 11, MOVIELENS["batch"]).astype(
            np.float32) / 2])
    return out


def movielens_step(mx, tables, states, batch, lazy):
    """take forward, the squared error's row gradients, take_grad, and
    Adam: lazy on the row-sparse gradients, or dense over every row of
    the densified gradients. Returns the row-sparse gradients."""
    from mxnet_tpu_torch.ndarray import sparse
    uid, iid, r = batch
    u = mx.nd.take(tables[0], mx.nd.array(uid))
    v = mx.nd.take(tables[1], mx.nd.array(iid))
    err = ((u * v).sum(axis=1) - mx.nd.array(r)).reshape((-1, 1)) * 2
    grads = [sparse.take_grad(uid, err * v, MOVIELENS["users"]),
             sparse.take_grad(iid, err * u, MOVIELENS["items"])]
    for w, (m, s2), g in zip(tables, states, grads):
        mx.nd.adam_update(w, g if lazy else g.tostype("default"), m, s2,
                          out=w, lr=MOVIELENS["lr"])
    return grads


def sparse_embedding_phase():
    """(b) the row-sparse embedding recipe at MOVIELENS's counts on the
    card: ms a step lazy against dense; the rows outside the batches and
    their Adam state unchanged bit for bit; the gradient's bytes
    O(nnz)."""
    import torch
    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(2)
    init = [(rs.standard_normal((MOVIELENS[k], MOVIELENS["rank"])) * 0.1
             ).astype(np.float32) for k in ("users", "items")]
    batches = movielens_batches()
    ms, grads = {}, None
    with mx.gpu(0):
        for lazy in (True, False):
            tables = [mx.nd.array(t) for t in init]
            states = [(mx.nd.zeros(t.shape), mx.nd.zeros(t.shape))
                      for t in init]
            times = []
            for batch in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                g = movielens_step(mx, tables, states, batch, lazy)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            ms[lazy] = statistics.median(times[1:])
            if lazy:
                grads = g
                for k, (w, (m, s2)) in enumerate(zip(tables, states)):
                    seen = np.unique(np.concatenate([b[k] for b in batches]))
                    rest = np.setdiff1d(np.arange(len(init[k])), seen)
                    w, m, s2 = (a.asnumpy() for a in (w, m, s2))
                    if not (np.array_equal(w[rest], init[k][rest])
                            and not m[rest].any() and not s2[rest].any()):
                        fail("sparse (b): a row outside the batches, or its "
                             "Adam state, moved in the lazy update")
                    if np.array_equal(w[seen], init[k][seen]):
                        fail("sparse (b): the lazy update moved no row")
    gbytes = sum(g._data.numel() * g._data.element_size()
                 + g._indices.numel() * 4 for g in grads)
    dense_bytes = sum(t.nbytes for t in init)
    nnz = sum(g.nnz for g in grads)
    if gbytes != nnz * (MOVIELENS["rank"] + 1) * 4:
        fail("sparse (b): the row-sparse gradients hold %d bytes for %d "
             "rows" % (gbytes, nnz))
    say("sparse (b): embedding recipe (%d users, %d items, rank %d, batch "
        "%d ratings): %.3f ms a step lazy (take, take_grad, row-sparse "
        "Adam) against %.3f ms dense (the (vocab, %d) gradients, Adam "
        "over every row), medians of steps 2..%d by wall; the last step's "
        "gradients %d rows, %.3f MB (dense %.1f MB); rows outside the "
        "batches and their Adam state unchanged bit for bit" % (
            MOVIELENS["users"], MOVIELENS["items"], MOVIELENS["rank"],
            MOVIELENS["batch"], ms[True], ms[False], MOVIELENS["rank"],
            MOVIELENS["steps"], nnz, gbytes / 1e6, dense_bytes / 1e6))


def sparse_phase():
    """Sparse storage on the card: (a) the sparse linear SVM at Avazu's
    shape, (b) the row-sparse embedding recipe at MovieLens-20M's
    counts."""
    t0 = time.perf_counter()
    sparse_linear_phase()
    sparse_embedding_phase()
    say("sparse: phase done in %.1f s" % (time.perf_counter() - t0))


# zoo: the rest of the symbolic catalog through Module.fit at upstream's
# train_mnist.py (batch 64, lr 0.05) and train_imagenet.py (batch 128, lr
# 0.1) settings: (catalog name, image, batch, classes, lr). GoogLeNet has
# no BatchNorm: at lr 0.1 its loss went from 11.2 to NaN within three
# steps on the card (seeded data, Xavier gaussian in 2), so it takes 0.01
ZOO_NETS = (("lenet", (1, 28, 28), 64, 10, 0.05),
            ("mlp", (1, 28, 28), 64, 10, 0.05),
            ("mobilenet", (3, 224, 224), 128, 1000, 0.1),
            ("resnext", (3, 224, 224), 128, 1000, 0.1),
            ("googlenet", (3, 224, 224), 128, 1000, 0.01),
            ("inception-v4", (3, 299, 299), 128, 1000, 0.1),
            ("inception-resnet-v2", (3, 299, 299), 128, 1000, 0.1))
ZOO_STEPS = 3                  # one warm-up step, then 2 timed
ZOO_SGD = {"momentum": 0.9, "wd": 1e-4}
ZOO_SMALL_TOL = dict(rtol=1e-4, atol=1e-5)    # batch 2 forward, card vs CPU
# the logits of that forward from the weights after the fit (the fit on
# random labels can saturate the softmax), each divided by the largest
# |logit| of the CPU's float64 forward, held as tightly: the card with
# cuDNN and without it read within 1.6e-6 of the CPU there, and each as
# far from float64 as the other (float32's own rounding, not cuDNN's)
ZOO_FITTED_TOL = dict(rtol=1e-4, atol=1e-5)


def zoo_forward(mx, sym, shape, classes, arg, aux, dev, dtype=None):
    """One inference forward at batch 2 of seeded data on ``dev`` (the
    parameters cast to ``dtype`` if given): the first output on the
    CPU."""
    import torch
    from mxnet_tpu_torch.executor import _graph_eval_fn
    rs = np.random.RandomState(5)
    feed = {"data": rs.standard_normal((2,) + shape).astype(np.float32),
            "softmax_label": rs.randint(0, classes, 2).astype(np.float32)}
    names = set(sym.list_arguments())

    def put(t):
        t = t.to(dev)
        return t if dtype is None else t.to(dtype)
    with torch.no_grad():
        args = {k: put(v) for k, v in arg.items() if k in names}
        args.update({k: put(torch.from_numpy(v)) for k, v in feed.items()
                     if k in names})
        return _graph_eval_fn(sym)(args, {k: put(v) for k, v in aux.items()},
                                   mx.random.PRNGKey(0), False)[0][0].cpu()


def zoo_logits(sym):
    """The symbol of the network's logits: the input of its
    SoftmaxOutput."""
    import json as _json
    nodes = _json.loads(sym.tojson())["nodes"]
    head = [n for n in nodes if n["op"] == "SoftmaxOutput"][-1]
    return sym.get_internals()[nodes[head["inputs"][0][0]]["name"]
                               + "_output"]


def zoo_forward_checks(mx, name, sym, shape, classes, init, fitted):
    """The batch-2 inference forward card against CPU: its softmax from
    the initial weights (ZOO_SMALL_TOL) and its logits from the weights
    after the fit (ZOO_FITTED_TOL, relative to the largest). For the
    fitted weights also each route's distance from the CPU's float64
    logits, the card's with cuDNN and without it (torch's own CUDA
    convolutions), which tells cuDNN's rounding (ROADMAP Queue C 8) from
    float32's own. Returns the two max abs errors (the second relative
    to the largest logit) and that note."""
    import torch
    card, cpu = (zoo_forward(mx, sym, shape, classes, *init, dev)
                 for dev in ("cuda", "cpu"))
    err0 = check_close("zoo: %s batch-2 forward card vs CPU, initial "
                       "weights" % name, card, cpu, ZOO_SMALL_TOL)
    logits = zoo_logits(sym)
    card, cpu = (zoo_forward(mx, logits, shape, classes, *fitted, dev)
                 for dev in ("cuda", "cpu"))
    torch.backends.cudnn.enabled = False
    try:
        no_cudnn = zoo_forward(mx, logits, shape, classes, *fitted, "cuda")
    finally:
        torch.backends.cudnn.enabled = True
    f64 = zoo_forward(mx, logits, shape, classes, *fitted, "cpu",
                      torch.float64)
    scale = float(f64.abs().max())
    err1 = check_close("zoo: %s batch-2 logits card vs CPU, fitted weights, "
                       "over the largest |logit| %g" % (name, scale),
                       card / scale, cpu / scale, ZOO_FITTED_TOL)
    note = ("fitted-weight logits against the CPU's float64, over the "
            "largest |logit| %.4g: card %.3g, card without cuDNN %.3g, CPU "
            "float32 %.3g" % tuple([scale] + [
                float((t.double() - f64).abs().max()) / scale
                for t in (card, no_cudnn, cpu)]))
    return err0, err1, note


def zoo_bn_shapes(sym, B, shape):
    """The distinct (C, H*W) of the network's BatchNorm inputs at batch
    B, from the symbol's inferred shapes (a BatchNorm's output has its
    input's shape)."""
    import json as _json
    bns = [n["name"] for n in _json.loads(sym.tojson())["nodes"]
           if n["op"] == "BatchNorm"]
    internals = sym.get_internals()
    _, out_shapes, _ = internals.infer_shape(data=(B,) + shape,
                                             softmax_label=(B,))
    by_name = dict(zip(internals.list_outputs(), out_shapes))
    return sorted({(s[1], int(np.prod(s[2:])))
                   for s in (by_name[b + "_output"] for b in bns)})


def zoo_bn_check(name, sym, shape, B):
    """The four BatchNorm kernels against their plain versions at each
    distinct BatchNorm input of the network's timed batch, in float32
    (bn_check_case): (shapes checked, {kernel: max abs err})."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(20261019)
    worst = dict.fromkeys(BN_KERNEL_KEYS, 0.0)
    shapes = zoo_bn_shapes(sym, B, shape)
    for C, HW in shapes:
        err, _, inputs = bn_check_case("zoo %s C=%d HW=%d" % (name, C, HW),
                                       B, C, HW, "float32", 0.0, gen)
        del inputs
        for k, v in err.items():
            worst[k] = max(worst[k], v)
    torch.cuda.empty_cache()
    return len(shapes), worst


def zoo_fit(mx, name, shape, B, classes, lr, counters):
    """The network through Module.fit over ZOO_STEPS seeded batches on the
    card, then one profiled step: (symbol, step gaps ms, peak bytes,
    losses, launch counts, the initial and the fitted (parameters, aux
    states))."""
    import torch
    from mxnet_tpu_torch import io, models
    sym = models.get_symbol(name, num_classes=classes)
    rs = np.random.RandomState(6)
    X = rs.standard_normal((ZOO_STEPS * B,) + shape).astype(np.float32)
    Y = rs.randint(0, classes, ZOO_STEPS * B).astype(np.float32)
    with mx.gpu(0):
        it = io.NDArrayIter(X, Y, batch_size=B, label_name="softmax_label")
    del X
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(0)
    mod.init_params(initializer=mx.init.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2))
    arg0, aux0 = mod.get_params()
    # the initial weights' tensors (a tensor is never written in place)
    init = ({k: v._data for k, v in arg0.items()},
            {k: v._data for k, v in aux0.items()})
    losses, marks, peaks = [], [], []

    class NLL(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("nll")

        def update(self, labels, preds):
            p = preds[0]._data.float()
            lab = labels[0]._data.long()
            losses.append(float(-torch.log(p[torch.arange(len(lab)), lab]
                                           .clamp_min(1e-30)).mean()))

    def timed_cb(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated())

    torch.cuda.synchronize()
    _reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    marks.append(time.perf_counter())
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(ZOO_SGD, learning_rate=lr,
                                  rescale_grad=1.0 / B),
            arg_params=arg0, aux_params=aux0, force_init=True,
            eval_metric=NLL(), batch_end_callback=timed_cb)
    launches = {c.__name__: c.launches for c in counters}
    arg1, aux1 = mod.get_params()
    fitted = ({k: v._data for k, v in arg1.items()},
              {k: v._data for k, v in aux1.items()})
    gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    with mx.gpu(0):
        batch = io.DataBatch([mx.nd.array(np.random.RandomState(7)
                                          .standard_normal((B,) + shape)
                                          .astype(np.float32))],
                             [mx.nd.array(Y[:B])])

    def one_step():
        mod.forward_backward(batch)
        mod.update()
    profile("zoo %s step (batch %d, f32)" % (name, B), one_step, top=6)
    return sym, gaps, max(peaks), losses, launches, init, fitted


def zoo_phase(counters):
    """The seven networks through Module.fit on the card, float32 (TF32
    off), MXNET_BN_PALLAS=1: step ms (median of the timed steps), img/s,
    peak memory, a profiled step's launches, the BatchNorm kernels'
    launches (each once a BatchNorm a step), finite losses, the four
    BatchNorm kernels against their plain versions at every BatchNorm
    input shape of the timed batch, and a batch-2 inference forward card
    against CPU from the initial and from the fitted weights. Returns
    the kernels' launch counts over the seven fits."""
    import json as _json
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config

    t0 = time.perf_counter()
    total = {c.__name__: 0 for c in counters}
    config.set_override("MXNET_BN_PALLAS", True)
    try:
        for name, shape, B, classes, lr in ZOO_NETS:
            t = time.perf_counter()
            sym, gaps, peak, losses, launches, init, fitted = zoo_fit(
                mx, name, shape, B, classes, lr, counters)
            n_bn = sum(n["op"] == "BatchNorm"
                       for n in _json.loads(sym.tojson())["nodes"])
            for c in counters:
                total[c.__name__] += launches[c.__name__]
                if launches[c.__name__] != n_bn * ZOO_STEPS:
                    fail("zoo: %s: %s launched %d times in %d steps of %d "
                         "BatchNorms" % (name, c.__name__,
                                         launches[c.__name__], ZOO_STEPS,
                                         n_bn))
            if len(losses) != ZOO_STEPS or not np.isfinite(losses).all():
                fail("zoo: %s: losses %s" % (name, losses))
            bn_note = ""
            if n_bn:
                n_shapes, worst = zoo_bn_check(name, sym, shape, B)
                bn_note = ("; the BatchNorm kernels at its %d BatchNorm "
                           "input shapes against their plain versions, max "
                           "abs err %s" % (n_shapes, " ".join(
                               "%s %.3g" % kv for kv in worst.items())))
            err0, err1, note = zoo_forward_checks(mx, name, sym, shape,
                                                  classes, init, fitted)
            step = statistics.median(gaps[1:])
            nparam = sum(v.numel() for v in init[0].values())
            say("zoo: %s, %s x %d, %d classes, lr %g, %.1f M parameters, "
                "%d BatchNorms: %.2f ms a step (median of steps 2..%d; all: "
                "%s), %.1f img/s, peak %.2f GB, %d launches a profiled step "
                "(busy %.1f%%), BatchNorm kernels %d launches each; NLL %s; "
                "batch-2 forward card vs CPU max abs err %.3g (initial "
                "weights' softmax), %.3g (fitted weights' logits over the "
                "largest; %s)%s; %.1f s" % (
                    name, "x".join(map(str, shape)), B, classes, lr,
                    nparam / 1e6, n_bn, step, ZOO_STEPS,
                    " ".join("%.1f" % g for g in gaps), B / step * 1e3,
                    peak / 1e9, sum(profile.counts.values()),
                    100 * profile.busy, launches[counters[0].__name__],
                    " ".join("%.4f" % v for v in losses), err0, err1, note,
                    bn_note, time.perf_counter() - t))
            del init, fitted
            torch.cuda.empty_cache()
    finally:
        config.set_override("MXNET_BN_PALLAS", None)
    say("zoo: phase done in %.1f s" % (time.perf_counter() - t0))
    return total



# ---------------------------------------------------------------------------
# image phase: the data plane (image/*, the native reader and decoder)
# feeding ResNet-50 and SSD300 training from packed .rec files
# ---------------------------------------------------------------------------

# upstream example/image-classification/train_imagenet.py with
# common/data.py's ImageRecordIter settings, as far as the factory takes
# them; the files packed as im2rec packs them (JPEG quality 95)
IMAGE_SRC_HW = (375, 500)    # a seeded photo-sized JPEG, 500 x 375
IMAGE_RN = dict(count=1024, data_shape=(3, 224, 224), batch=128,
                mean=(123.68, 116.779, 103.939), std=(58.395, 57.12, 57.375),
                threads=4)
# upstream example/ssd/train.py (config/config.py's cfg.train) through
# ImageDetRecordIter: mean_pixels 123 / 117 / 104, rand_mirror_prob 0.5,
# the five crop samplers (crop probability 5/6; scales 0.3..1, so areas
# 0.09..1; aspect ratios 0.5..2; 25 trials), rand_pad_prob 0.5 (taken and
# ignored by the factory: it makes no pad augmenter)
IMAGE_SSD = dict(count=256, data_shape=(3, 300, 300), batch=32,
                 mean=(123, 117, 104), crop=5 / 6, pad=0.5,
                 min_object_covered=0.1, aspect_ratio_range=(0.5, 2.0),
                 area_range=(0.09, 1.0), max_attempts=25)
IMAGE_STEPS = 5              # Module.fit steps: a warm-up and 4 timed
IMAGE_ALONE_BATCHES = 3      # the iterator timed alone on the host
IMAGE_SEED = 23


def image_jpegs(mx, path, n, seed, labels):
    """n seeded photo-like JPEGs (IMAGE_SRC_HW; smooth waves under a
    little noise, so they compress as photos do) packed at quality 95
    into path.rec / path.idx with labels[i]; the .rec file's bytes."""
    from concurrent.futures import ThreadPoolExecutor
    h, w = IMAGE_SRC_HW
    x, y = np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)

    def one(i):
        rs = np.random.RandomState(seed * 100003 + i)
        f = rs.uniform(0.004, 0.05, (3, 2)).astype(np.float32)
        ph = rs.uniform(0, 6.28, 3).astype(np.float32)
        img = rs.randint(-6, 7, (h, w, 3)).astype(np.float32) + 128
        for c in range(3):
            # 90 sin(fx x + fy y + ph), separated into outer products
            ax, ay = f[c, 0] * x, f[c, 1] * y + ph[c]
            img[:, :, c] += 90 * np.outer(np.cos(ay), np.sin(ax))
            img[:, :, c] += 90 * np.outer(np.sin(ay), np.cos(ax))
        return mx.recordio.pack_img(
            (0, labels[i], i, 0), np.clip(img, 0, 255).astype(np.uint8),
            quality=95, img_fmt=".jpg")
    with ThreadPoolExecutor(4) as pool:
        recs = list(pool.map(one, range(n)))
    w = mx.recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i, rec in enumerate(recs):
        w.write_idx(i, rec)
    w.close()
    return os.path.getsize(path + ".rec")


def image_tap(mx, inner, steps):
    """A DataIter over ``inner`` that ends after ``steps`` batches, times
    each inner ``next()`` (the consumer's wait for a batch: ``waits``)
    and keeps the batches it handed out (``kept``)."""
    class Tap(mx.io.DataIter):
        def __init__(self):
            super().__init__(inner.batch_size)
            self.provide_data = inner.provide_data
            self.provide_label = inner.provide_label
            self.waits, self.kept, self.left = [], [], steps

        def reset(self):
            self.left = steps

        def next(self):
            if self.left == 0:
                raise StopIteration
            self.left -= 1
            t = time.perf_counter()
            batch = inner.next()
            self.waits.append((time.perf_counter() - t) * 1e3)
            self.kept.append(batch)
            return batch
    return Tap()


def image_fit(mx, mod, it, steps, **fit_kw):
    """Module.fit over ``steps`` batches of ``it``: the boundary-to-boundary
    ms of each step, the consumer's wait for each batch, the batches."""
    import torch
    tap = image_tap(mx, it, steps)
    marks = []

    def cb(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    mod.fit(tap, num_epoch=1, batch_end_callback=cb, **fit_kw)
    gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    if len(gaps) != steps:
        fail("image: Module.fit ran %d steps, not %d" % (len(gaps), steps))
    return gaps, tap.waits, tap.kept


def image_resnet(mx, rec, counters):
    """(a) bench.py's ResNet-50, float32, MXNET_BN_PALLAS=1, through
    Module.fit over mx.io.ImageRecordIter (native reader and decoder,
    prefetched, batches on the card) with the module phase's SGD and
    initialisation: a warm-up and IMAGE_STEPS - 1 timed steps; then the
    same Module over those batches resident on the card; the iterator
    alone on the host; one batch made for the CPU against the same batch
    made for the card, bit for bit."""
    import random
    import torch
    from mxnet_tpu_torch import config, optimizer as opt
    from mxnet_tpu_torch.image import native_decode
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import make_train_step

    c, S, _ = IMAGE_RN["data_shape"]
    B = IMAGE_RN["batch"]
    kw = dict(path_imgrec=rec, data_shape=IMAGE_RN["data_shape"],
              batch_size=B, shuffle=True, rand_crop=True, rand_mirror=True,
              preprocess_threads=IMAGE_RN["threads"],
              **{"mean_" + k: v for k, v in zip("rgb", IMAGE_RN["mean"])},
              **{"std_" + k: v for k, v in zip("rgb", IMAGE_RN["std"])})
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, image_shape=(c, S, S))
    n_bn = sum(n["op"] == "BatchNorm"
               for n in json.loads(sym.tojson())["nodes"])
    optp = {"momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0 / B}
    ref = make_train_step(sym, optimizer="sgd", optimizer_params=optp)
    mx.random.seed(0)
    init = ref.init_state(Xavier(factor_type="in", magnitude=2.0),
                          {"data": (B, c, S, S), "softmax_label": (B,)})
    with mx.cpu():
        args = {k: mx.nd.array(v.cpu()) for k, v in init[0].items()}
        auxs = {k: mx.nd.array(v.cpu()) for k, v in init[2].items()}
    names = list(ref.param_names)
    del init, ref
    o = opt.create("sgd", learning_rate=RESNET_LR,
                   param_idx2name=dict(enumerate(names)), **optp)
    o.set_wd_mult({n: 1.0 for n in names})

    config.set_override("MXNET_BN_PALLAS", True)
    try:
        random.seed(IMAGE_SEED)
        np.random.seed(IMAGE_SEED)
        it = mx.io.ImageRecordIter(**kw)
        inner = it.iters[0]
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        _reset_counts(counters)
        t = time.perf_counter()
        gaps, waits, kept = image_fit(mx, mod, it, IMAGE_STEPS, optimizer=o,
                                      eval_metric="acc", kvstore="local",
                                      arg_params=args, aux_params=auxs)
        fit_s = time.perf_counter() - t
        launches = {f.__name__: f.launches for f in counters}
        for f in counters:
            if launches[f.__name__] != n_bn * IMAGE_STEPS:
                fail("image (a): %s launched %d times in %d steps of %d "
                     "BatchNorms" % (f.__name__, launches[f.__name__],
                                     IMAGE_STEPS, n_bn))
        routes = dict(inner.batches_by_route)
        if inner._native is None or routes["pil"] or \
                routes["native"] < IMAGE_STEPS:
            fail("image (a): the batches' routes %r (native plan %s): every "
                 "batch must take the native decoder" % (
                     routes, "on" if inner._native else "OFF: the native "
                     "decoder did not build or load"))
        if inner.imgrec._native is None:
            fail("image (a): the native RecordIO reader is not in use")
        on_card = all(b.data[0].context == mx.gpu(0) and
                      b.label[0].context == mx.gpu(0) for b in kept)
        if not on_card:
            fail("image (a): ImageRecordIter's batches are not on the card")
        # the same Module over the same batches resident on the card
        rgaps, _, _ = image_fit(mx, mod, _replay(mx, kept), len(kept),
                                eval_metric="acc", kvstore="local")
    finally:
        config.set_override("MXNET_BN_PALLAS", None)
    del mod, kept, it
    step, rstep = statistics.median(gaps[1:]), statistics.median(rgaps[1:])
    wait = statistics.median(waits[1:])

    def image_iter():
        """The factory's ImageIter without its prefetcher (whose worker
        would go on drawing from the random streams)."""
        return mx.image.ImageIter(
            B, IMAGE_RN["data_shape"], path_imgrec=rec, shuffle=True,
            rand_crop=True, rand_mirror=True, mean=list(IMAGE_RN["mean"]),
            std=list(IMAGE_RN["std"]), num_threads=IMAGE_RN["threads"])
    # the iterator alone on the host (its decode pool, no copy to the card)
    with mx.cpu():
        alone = image_iter()
        alone.next()
        t = time.perf_counter()
        for _ in range(IMAGE_ALONE_BATCHES):
            alone.next()
        host_ms = (time.perf_counter() - t) * 1e3 / IMAGE_ALONE_BATCHES
        # where a batch's host time goes: the decode call alone (224 x 224
        # crops), then with the rects, normalise and transpose
        samples = [alone.next_sample() for _ in range(B)]
        rects = np.tile(np.array([0, 0, S, S], np.float32), (B, 1))
        t = time.perf_counter()
        native_decode.decode_batch([raw for _, raw in samples], rects,
                                   np.zeros(B, np.uint8), (S, S),
                                   n_threads=IMAGE_RN["threads"])
        decode_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        alone._native_batch(samples)
        plan_ms = (time.perf_counter() - t) * 1e3
    # one batch made for the CPU against the same batch made for the card
    made = []
    for ctx in (mx.gpu(0), mx.cpu()):
        random.seed(IMAGE_SEED + 1)
        np.random.seed(IMAGE_SEED + 1)
        with ctx:
            b = image_iter().next()
        made.append((b.data[0], b.label[0]))
    (cd, cl), (hd, hl) = made
    same = cd.context == mx.gpu(0) and hd.context == mx.cpu() and \
        torch.equal(cd._data.cpu(), hd._data) and \
        torch.equal(cl._data.cpu(), hl._data)
    if not same:
        fail("image (a): the batch made for the CPU differs from the batch "
             "made for the card")
    say("image (a): ResNet-%d float32 on the BatchNorm kernels through "
        "Module.fit over mx.io.ImageRecordIter (%d x %s, shuffle, rand_crop, "
        "rand_mirror, mean %s, std %s, %d threads): step %.2f ms fed by the "
        "iterator (median of steps 2..%d; all: %s) against %.2f ms over the "
        "same batches resident on the card (all: %s); the step waits %.2f ms "
        "a batch for the iterator (median; all: %s): %s; the iterator alone "
        "%.1f ms of host a batch, %.0f decoded images/s (the decode call "
        "%.1f ms, with the crops' draws, normalise and transpose %.1f ms, "
        "the rest reading records and the batch's NDArray); each BatchNorm "
        "kernel %d launches a step (%d BatchNorms); routes %s, the native "
        "reader in use; a batch made for the CPU bit-equal to the one made "
        "for the card; fit %.1f s" % (
            RESNET_LAYERS, B, "x".join(map(str, IMAGE_RN["data_shape"])),
            "/".join(map(str, IMAGE_RN["mean"])),
            "/".join(map(str, IMAGE_RN["std"])), IMAGE_RN["threads"], step,
            IMAGE_STEPS, " ".join("%.1f" % g for g in gaps), rstep,
            " ".join("%.1f" % g for g in rgaps), wait,
            " ".join("%.1f" % w for w in waits),
            "waits" if wait > 0.05 * rstep else "does not wait",
            host_ms, B / host_ms * 1e3, decode_ms, plan_ms,
            launches[counters[0].__name__] //
            IMAGE_STEPS, n_bn, json.dumps(routes, sort_keys=True), fit_s))
    return launches


def _replay(mx, batches):
    """A DataIter over kept batches, in order (one epoch)."""
    class Replay(mx.io.DataIter):
        def __init__(self):
            super().__init__(batches[0].data[0].shape[0])
            self.provide_data = [mx.io.DataDesc("data", batches[0].data[0]
                                                .shape)]
            self.provide_label = [mx.io.DataDesc(
                "softmax_label", batches[0].label[0].shape)]
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self):
            if self.i == len(batches):
                raise StopIteration
            self.i += 1
            return batches[self.i - 1]
    return Replay()


def image_ssd(mx, rec, counters):
    """(b) detect (a)'s SSD300 training step (upstream example/ssd/train.py,
    batch 32, f32) through Module.fit over mx.io.ImageDetRecordIter at
    IMAGE_SSD's settings: a warm-up and IMAGE_STEPS - 1 timed steps; the
    iterator's ms a batch (the consumer's wait: the factory does not
    prefetch), the step's ms, the NMS kernel once a training forward."""
    import random
    import torch
    from mxnet_tpu_torch.ops import nms_kernels as nmsk

    B = IMAGE_SSD["batch"]
    sym = ssd300_symbol(mx.sym, SSD_CLASSES, SSD_WIDTH_DIV, train=True)
    params = ssd_params(ssd300_symbol(mx.sym, SSD_CLASSES, SSD_WIDTH_DIV,
                                      heads=True), seed=0)
    with mx.cpu():
        args = {k: mx.nd.array(v) for k, v in params.items()}
    losses = []

    class Loss(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("ssd_loss")

        def update(self, labels, preds):
            losses.append(ssd_loss(preds))

    random.seed(IMAGE_SEED + 2)
    np.random.seed(IMAGE_SEED + 2)
    it = mx.io.ImageDetRecordIter(
        path_imgrec=rec, data_shape=IMAGE_SSD["data_shape"], batch_size=B,
        shuffle=True, mean=np.array(IMAGE_SSD["mean"]),
        rand_crop=IMAGE_SSD["crop"], rand_pad=IMAGE_SSD["pad"],
        rand_mirror=True, min_object_covered=IMAGE_SSD["min_object_covered"],
        aspect_ratio_range=IMAGE_SSD["aspect_ratio_range"],
        area_range=IMAGE_SSD["area_range"],
        max_attempts=IMAGE_SSD["max_attempts"], preprocess_threads=4)
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=mx.gpu(0))
    _reset_counts(counters)
    t = time.perf_counter()
    gaps, waits, _ = image_fit(mx, mod, it, IMAGE_STEPS, optimizer="sgd",
                               optimizer_params={
                                   "learning_rate": SSD_TRAIN["lr"],
                                   "momentum": SSD_TRAIN["momentum"],
                                   "wd": SSD_TRAIN["wd"]},
                               eval_metric=Loss(), arg_params=args,
                               aux_params={})
    fit_s = time.perf_counter() - t
    launches = {f.__name__: f.launches for f in counters}
    if launches[nmsk.nms_keep_cuda.__name__] != IMAGE_STEPS:
        fail("image (b): nms_keep_cuda launched %d times in %d training "
             "forwards" % (launches[nmsk.nms_keep_cuda.__name__],
                           IMAGE_STEPS))
    if len(losses) != IMAGE_STEPS or not np.isfinite(losses).all():
        fail("image (b): SSD300 losses %s" % losses)
    if it.batches_by_route != {"native": 0, "pil": IMAGE_STEPS}:
        fail("image (b): the batches' routes %r: ImageDetIter decodes "
             "through PIL" % (it.batches_by_route,))
    label = mod._exec_group.execs[0].arg_dict["label"]
    step, wait = statistics.median(gaps[1:]), statistics.median(waits[1:])
    say("image (b): SSD300 (f32) through Module.fit over "
        "mx.io.ImageDetRecordIter (%d x %s, labels %s, mean %s, crop %.3f, "
        "mirror, pad %.1f taken and ignored by the factory; PIL on 4 "
        "threads, not prefetched): step %.2f ms (median of steps 2..%d; "
        "all: %s), the iterator %.2f ms a batch inside it (median; all: "
        "%s); loss %s; nms_keep_cuda %d launches (one a training forward); "
        "fit %.1f s" % (
            B, "x".join(map(str, IMAGE_SSD["data_shape"])),
            "x".join(map(str, label.shape)),
            "/".join(map(str, IMAGE_SSD["mean"])), IMAGE_SSD["crop"],
            IMAGE_SSD["pad"], step, IMAGE_STEPS,
            " ".join("%.1f" % g for g in gaps), wait,
            " ".join("%.1f" % w for w in waits),
            " ".join("%.4f" % v for v in losses),
            launches[nmsk.nms_keep_cuda.__name__], fit_s))
    del mod, it, args
    torch.cuda.empty_cache()
    return launches


def image_phase():
    """The image data plane on the card: seeded 500 x 375 JPEGs packed into
    .rec/.idx files in a temporary directory, then (a) ResNet-50 fed by
    ImageRecordIter and (b) SSD300 fed by ImageDetRecordIter. Returns
    the launches of the BatchNorm kernels (a) and the NMS kernel (b)."""
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.ops import nms_kernels as nmsk

    t0 = time.perf_counter()
    reader, dec = (_native.load(name) for name in ("recordio", "imgdecode"))
    route = "NOT BUILT" if dec is None else "built with the system's " \
        "libjpeg/libpng" if dec._name == str(_native._candidates(
            "imgdecode")[0][0]) else "built against the libjpeg/libpng in " \
        "Pillow's wheel, declared by _native/compat"
    say("image: native reader %s; native decoder %s: %s; %.1f s" % (
        os.path.basename(reader._name) if reader else "NOT BUILT",
        os.path.basename(dec._name) if dec else "-", route,
        time.perf_counter() - t0))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_image_")
    try:
        t = time.perf_counter()
        n = IMAGE_RN["count"]
        rn_bytes = image_jpegs(mx, os.path.join(tmp, "imagenet"), n,
                               IMAGE_SEED, [float(i % 1000) for i in range(n)])
        rs = np.random.RandomState(IMAGE_SEED)
        labels = []
        for _ in range(IMAGE_SSD["count"]):
            lab = [2.0, 5.0]
            for _ in range(rs.randint(1, 4)):
                w, h = rs.uniform(0.1, 0.6, 2)
                x, y = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
                lab += [float(rs.randint(0, SSD_CLASSES)), x, y, x + w,
                        y + h]
            labels.append(np.array(lab, np.float32))
        ssd_bytes = image_jpegs(mx, os.path.join(tmp, "voc"),
                                IMAGE_SSD["count"], IMAGE_SEED + 1, labels)
        say("image: packed %d + %d seeded %dx%d JPEGs (quality 95) into .rec "
            "and .idx: %.1f MB (%.1f KB an image) and %.1f MB, in %.1f s" % (
                n, IMAGE_SSD["count"], IMAGE_SRC_HW[1], IMAGE_SRC_HW[0],
                rn_bytes / 1e6, rn_bytes / n / 1e3, ssd_bytes / 1e6,
                time.perf_counter() - t))
        r = mx.recordio.MXIndexedRecordIO(os.path.join(tmp, "imagenet.idx"),
                                          os.path.join(tmp, "imagenet.rec"),
                                          "r")
        raw = mx.recordio.unpack(r.read_idx(0))[1]
        r.close()
        decoded = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                decoded.append(mx.image.imdecode(raw))
        card, host = decoded
        if not (card.dtype == host.dtype == np.uint8 and card.context ==
                mx.gpu(0) and np.array_equal(card.asnumpy(),
                                             host.asnumpy())):
            fail("image: imdecode on the card gave %s %s, on the CPU %s %s "
                 "(uint8 and equal expected)" % (card.dtype, card.context,
                                                 host.dtype, host.context))
        say("image: imdecode gives a uint8 %s NDArray on the card, equal to "
            "the CPU's" % ("x".join(map(str, card.shape)),))
        t = time.perf_counter()
        launches = image_resnet(mx, os.path.join(tmp, "imagenet.rec"),
                                _bn_counters())
        torch.cuda.empty_cache()
        say("image (a): %.1f s" % (time.perf_counter() - t))
        t = time.perf_counter()
        launches.update(image_ssd(mx, os.path.join(tmp, "voc.rec"),
                                  [nmsk.nms_keep_cuda]))
        say("image (b): %.1f s" % (time.perf_counter() - t))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("image: phase done in %.1f s" % (time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# capi: the C ABI (_native/predict_shim.cc) driven by the unchanged C hosts
# of examples/c_predict/; surface: mx.rtc, mx.viz, test_utils' speed check
# and the TensorBoard bridge on the card
# ---------------------------------------------------------------------------

CAPI_SSD_BATCH = 8              # compiled_serve's largest bucket
CAPI_TRAIN_STEPS = 3
# the C-hosted ResNet-50 steps against the in-process ones: the softmax
# output and fc1_bias after 3 bf16 steps, each relative in norm. The C
# host's interpreter runs without torch.use_deterministic_algorithms, as
# the in-process loads do here; two in-process loads of one export are
# printed beside it as the run-to-run floor
CAPI_TRAIN_RTOL = 1e-2
CAPI_HOST_TIMEOUT_S = 600
SURFACE_SPEED_RTOL = 0.2        # check_speed against time_ms, one forward
SURFACE_TRITON_TOL = dict(rtol=1e-6, atol=1e-6)   # a*x+y may fuse to an FMA


def capi_hosts(so, tmp):
    """examples/c_predict/predict.c and train.c, unchanged, built against
    the shim (both gcc's at once): {name: executable}."""
    src = os.path.join(HERE, "examples", "c_predict")
    procs = {}
    for name in ("predict", "train"):
        out = os.path.join(tmp, name)
        procs[name] = (out, subprocess.Popen(
            ["gcc", os.path.join(src, name + ".c"), "-o", out, so,
             "-Wl,-rpath,%s" % os.path.dirname(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (out, p) in procs.items():
        log = p.communicate(timeout=120)[0]
        if p.returncode != 0:
            fail("capi: building %s.c against the shim failed: %s"
                 % (name, log))
    return {name: out for name, (out, _) in procs.items()}


def capi_run(argv_by_case, **env):
    """C host processes run together on the card, MXNET_CAPI_TIMING on:
    {case: (rc, stdout, stderr, {exported function: [ms, ...]})}. A host
    past CAPI_HOST_TIMEOUT_S fails the run after every host is killed."""
    from mxnet_tpu_torch import _native
    procs = {case: subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_native.host_env(device="gpu", MXNET_CAPI_TIMING="1", **env))
        for case, argv in argv_by_case.items()}
    results = {}
    try:
        for case, p in procs.items():
            out, err = p.communicate(timeout=CAPI_HOST_TIMEOUT_S)
            calls = {}
            for line in err.splitlines():
                if line.startswith("capi: ") and line.endswith(" ms"):
                    fn, ms = line[len("capi: "):-len(" ms")].rsplit(" ", 1)
                    calls.setdefault(fn, []).append(float(ms))
            results[case] = (p.returncode, out, err, calls)
    except subprocess.TimeoutExpired:
        fail("capi: a C host ran past %d s" % CAPI_HOST_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def capi_printed(lines, at):
    """(shape, the printed values, next line) of one ``<what> shape d0
    d1 ...`` block of a C host's output."""
    shape = tuple(int(v) for v in lines[at].split("shape")[1].split())
    n = int(np.prod(shape))
    return shape, lines[at + 1:at + 1 + n], at + 1 + n


def capi_serve(mx, hosts, tmp):
    """(a): SSD300 (compiled_serve's: 21 classes, float32, the NMS kernel)
    exported at batch 8 and served by predict.c: its printed outputs
    equal the in-process CompiledPredictor's forward to the printed
    precision (%.8g), and the C calls' ms beside the in-process
    forward's."""
    import torch
    from mxnet_tpu_torch.convert import params_from_jax
    from mxnet_tpu_torch.predictor import CompiledPredictor

    B, S = CAPI_SSD_BATCH, SSD_IMAGE
    sym = ssd300_symbol(mx.sym, SSD_CLASSES, SSD_WIDTH_DIV)
    prefix = os.path.join(tmp, "ssd300")
    t = time.perf_counter()
    mx.Predictor(sym, params_from_jax(ssd_params(sym, seed=0),
                                      mx.gpu(0).torch_device()),
                 data_names=("data",)).export(prefix, {"data": (B, 3, S, S)})
    export_s = time.perf_counter() - t
    x = np.random.RandomState(8).standard_normal((B, 3, S, S)).astype(
        np.float32)
    raw = os.path.join(tmp, "ssd300_input.f32")
    x.tofile(raw)
    t = time.perf_counter()
    cp = CompiledPredictor.load(prefix)
    load_s = time.perf_counter() - t
    walls, want = [], None
    for _ in range(6):
        t = time.perf_counter()
        got = cp.forward(x)[0].asnumpy()
        walls.append((time.perf_counter() - t) * 1e3)
        if want is not None and not np.array_equal(got, want):
            fail("capi (a): two in-process forwards of one input differ")
        want = got
    del cp
    torch.cuda.empty_cache()
    kept = check_detections("capi (a) in-process", want)
    t = time.perf_counter()
    rc, out, err, calls = capi_run(
        {"a": [hosts["predict"], prefix, raw, str(x.size)]})["a"]
    child_s = time.perf_counter() - t
    if rc != 0:
        fail("capi (a): predict exited with %d: %s" % (rc, err[-3000:]))
    lines = out.splitlines()
    shape, printed, end = capi_printed(lines, 0)
    if shape != want.shape or end != len(lines):
        fail("capi (a): predict printed shape %s and %d lines; the "
             "in-process output is %s" % (shape, len(lines), want.shape))
    expect = ["%.8g" % v for v in want.ravel()]
    if printed != expect:
        fail("capi (a): %d of %d printed values differ from the in-process "
             "forward's (first: %r against %r)" % (
                 sum(a != b for a, b in zip(printed, expect)), len(expect),
                 *next((a, b) for a, b in zip(printed, expect) if a != b)))
    names = ("MXTpuPredCreate", "MXTpuPredSetInput", "MXTpuPredForward",
             "MXTpuPredGetOutput")
    ms = {n: calls[n][0] for n in names}
    call_ms = sum(ms[n] for n in names[1:]) + calls[
        "MXTpuPredGetOutputShape"][0]
    say("capi (a): SSD300 at batch %d (export %.1f s) served by predict.c "
        "through MXTpuPred*: %d values (%s) equal to the in-process "
        "CompiledPredictor forward's to %%.8g, detections kept an image %s; "
        "the C calls: Create (load, warm-up, capture) %.1f ms, SetInput "
        "%.2f, Forward %.2f, GetOutputShape %.2f, GetOutput %.2f: %.2f ms "
        "a request against the in-process forward + asnumpy %.2f ms first "
        "after load (load %.1f s), %.2f median of the next 5; the host "
        "process %.1f s" % (
            B, export_s, want.size, "x".join(map(str, shape)), kept,
            ms["MXTpuPredCreate"], ms["MXTpuPredSetInput"],
            ms["MXTpuPredForward"], calls["MXTpuPredGetOutputShape"][0],
            ms["MXTpuPredGetOutput"], call_ms, walls[0], load_s,
            statistics.median(walls[1:]), child_s))


def capi_train(mx, hosts, tmp):
    """(b): bench.py's ResNet-50 step (compiled_resnet's: batch 128, SGD
    momentum 0.9, wd 1e-4, bf16, MXNET_BN_PALLAS=1) exported and trained
    3 steps by train.c: the softmax output and fc1_bias within
    CAPI_TRAIN_RTOL of 3 in-process CompiledTrainStep steps on the same
    batch and lr (two in-process loads give the floor), and the ms of a
    step through the ABI beside step()'s."""
    import torch
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import make_train_step
    from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep

    B, S = RESNET_BATCH, RESNET_IMAGE
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, image_shape=(3, S, S))
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
    prefix = os.path.join(tmp, "resnet50")
    t = time.perf_counter()
    step.export(prefix, init, batch)
    export_s = time.perf_counter() - t
    del init, step
    files = {}
    for name, arr in batch.items():
        files[name] = os.path.join(tmp, name + ".f32")
        arr.tofile(files[name])
    runs = []
    config.set_override("MXNET_BN_PALLAS", True)
    try:
        for _ in range(2):
            ct = CompiledTrainStep.load(prefix)
            ms = []
            for _ in range(CAPI_TRAIN_STEPS):
                t = time.perf_counter()
                outs = ct.step(batch, RESNET_LR)
                ms.append((time.perf_counter() - t) * 1e3)
            runs.append({"output": outs[0], "fc1_bias":
                         ct.get_params()["fc1_bias"], "ms": ms})
            del ct
            torch.cuda.empty_cache()
    finally:
        config.set_override("MXNET_BN_PALLAS", None)
    t = time.perf_counter()
    rc, out, err, calls = capi_run({"b": [
        hosts["train"], prefix, files["data"], str(batch["data"].size),
        files["softmax_label"], str(batch["softmax_label"].size),
        str(CAPI_TRAIN_STEPS), repr(RESNET_LR), "fc1_bias"]},
        MXNET_BN_PALLAS="1")["b"]
    child_s = time.perf_counter() - t
    if rc != 0:
        fail("capi (b): train exited with %d: %s" % (rc, err[-3000:]))
    lines = out.splitlines()
    oshape, oprinted, at = capi_printed(lines, 0)
    if not lines[at].startswith("param fc1_bias shape"):
        fail("capi (b): train printed %r where fc1_bias belongs" % lines[at])
    pshape, pprinted, _ = capi_printed(lines, at)
    c = {"output": np.array(oprinted, np.float64).reshape(oshape),
         "fc1_bias": np.array(pprinted, np.float64).reshape(pshape)}
    ref, again = runs
    if oshape != ref["output"].shape or pshape != ref["fc1_bias"].shape:
        fail("capi (b): shapes %s, %s against %s, %s" % (
            oshape, pshape, ref["output"].shape, ref["fc1_bias"].shape))
    dist = {k: _rel_norm({k: c[k]}, {k: ref[k].astype(np.float64)})
            for k in c}
    floor = {k: _rel_norm({k: again[k]}, {k: ref[k].astype(np.float64)})
             for k in c}
    if not all(np.isfinite(c[k]).all() for k in c) or \
            max(dist.values()) > CAPI_TRAIN_RTOL:
        fail("capi (b): the C host's output and fc1_bias lie %s from the "
             "in-process steps' (tolerance %g; two in-process loads %s)"
             % (dist, CAPI_TRAIN_RTOL, floor))
    labels = torch.from_numpy(batch["softmax_label"])
    nll = [mean_nll(torch.from_numpy(r["output"]), labels)
           for r in (ref, again)] + [
        mean_nll(torch.from_numpy(c["output"].astype(np.float32)), labels)]
    steps = calls["MXTpuTrainStep"]
    say("capi (b): ResNet-50 (batch %d, bf16, MXNET_BN_PALLAS=1; export "
        "%.1f s) trained %d steps by train.c through MXTpuTrain*: the "
        "softmax output and fc1_bias %.3g and %.3g from the in-process "
        "CompiledTrainStep's, relative in norm (tolerance %g; two "
        "in-process loads %.3g and %.3g); NLL after %d steps %.5f C, "
        "%.5f / %.5f in-process; the C calls: Create %.1f ms, SetBatch "
        "%s ms (data, label), Step %s ms (the first warms up and "
        "captures), GetOutput %.2f, GetParamShape %.2f, GetParam %.2f "
        "(all parameters to the host, once a step); in-process step() %s "
        "ms; a replayed step through the ABI %.2f ms against %.2f "
        "in-process; the host process %.1f s" % (
            B, export_s, CAPI_TRAIN_STEPS, dist["output"], dist["fc1_bias"],
            CAPI_TRAIN_RTOL, floor["output"], floor["fc1_bias"],
            CAPI_TRAIN_STEPS, nll[2], nll[0], nll[1],
            calls["MXTpuTrainCreate"][0],
            " ".join("%.2f" % v for v in calls["MXTpuTrainSetBatch"]),
            " ".join("%.2f" % v for v in steps),
            calls["MXTpuTrainGetOutput"][0],
            calls["MXTpuTrainGetParamShape"][0],
            calls["MXTpuTrainGetParam"][0],
            " ".join("%.2f" % v for v in ref["ms"]),
            statistics.median(steps[1:]), statistics.median(ref["ms"][1:]),
            child_s))


def capi_errors(mx, hosts, tmp):
    """(c): a bad prefix, an unknown input name, a wrong input size and a
    prefix in the JAX package's layout (a forward and a training step:
    its meta keys and a .stablehlo beside them; this machine has no JAX
    to export one) each end the C host with rc 1 and
    MXTpuGetLastError's message."""
    def tiny(data):
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable(data), num_hidden=4, name="fc"), name="softmax")
        rs = np.random.RandomState(0)
        prefix = os.path.join(tmp, "tiny_" + data)
        mx.Predictor(net, {"fc_weight": rs.randn(4, 8).astype(np.float32),
                           "fc_bias": np.zeros(4, np.float32)},
                     data_names=(data,)).export(prefix, {data: (2, 8)})
        return prefix

    raw = os.path.join(tmp, "tiny_input.f32")
    np.ones(16, np.float32).tofile(raw)
    jax_fwd = os.path.join(tmp, "jax_forward")
    with open(jax_fwd + ".meta.json", "w") as f:
        json.dump({"data_names": ["data"], "output_names": ["softmax_output"],
                   "data_shapes": {"data": [2, 8]}, "dtype": "float32"}, f)
    open(jax_fwd + ".stablehlo", "wb").close()
    jax_train = os.path.join(tmp, "jax_train")
    with open(jax_train + ".train.meta.json", "w") as f:
        json.dump({"param_names": ["fc_bias", "fc_weight"], "n_opt_slots": 1,
                   "aux_names": [], "batch_names": ["data", "softmax_label"],
                   "batch_shapes": {"data": [2, 8], "softmax_label": [2]},
                   "batch_dtypes": {"data": "float32",
                                    "softmax_label": "float32"},
                   "n_state_leaves": 4, "n_outputs": 1,
                   "output_names": ["softmax_output"]}, f)
    open(jax_train + ".train.stablehlo", "wb").close()
    cases = {
        "bad prefix": ([hosts["predict"], os.path.join(tmp, "nope"), raw,
                        "16"], "create", "No such file or directory"),
        "unknown input": ([hosts["predict"], tiny("x"), raw, "16"],
                          "set_input", "unknown input 'data'; model inputs: "
                                       "['x']"),
        "wrong size": ([hosts["predict"], tiny("data"), raw, "15"],
                       "set_input", "input 'data': got 15 floats, shape "
                                    "[2, 8] needs 16"),
        "JAX forward": ([hosts["predict"], jax_fwd, raw, "16"], "create",
                        "holds a forward exported by the JAX package"),
        "JAX training step": ([hosts["train"], jax_train, raw, "16", raw,
                               "2", "1", "0.1", "fc_weight"], "create",
                              "holds a training step exported by the JAX "
                              "package"),
    }
    t = time.perf_counter()
    results = capi_run({k: v[0] for k, v in cases.items()})
    for case, (_argv, where, message) in cases.items():
        rc, out, err, _ = results[case]
        last = (err.strip().splitlines() or [""])[-1]
        if rc != 1 or out or not last.startswith(where + ": ") or \
                message not in last:
            fail("capi (c) %s: rc %d, stdout %r, last stderr line %r "
                 "(rc 1 and %r after %r expected)" % (
                     case, rc, out[:200], last, message, where))
        say("capi (c) %s: rc 1, %r" % (case, last[:240]))
    say("capi (c): the five hosts together %.1f s" % (
        time.perf_counter() - t))


def capi_phase():
    """The C ABI on the card: the probe of this machine's Python (can it
    be embedded: Python.h, a shared libpython); the port's shim built by
    g++ into build/native/; examples/c_predict/predict.c and train.c
    built unchanged against it and run as child processes that embed
    the interpreter: (a) SSD300 served (capi_serve), (b) ResNet-50
    trained (capi_train), (c) the error surface (capi_errors). Each child
    exits 0 ((a), (b)) or 1 with the message ((c)). The children's kernel
    launches (NMS in (a), the BatchNorm kernels and the multi-tensor
    update in (b)) happen in their own processes, so this process's
    wrappers do not count them: the phase adds nothing to the kernels
    line. Where this machine's Python cannot be embedded, the phase
    prints why and runs none of (a)-(c)."""
    import shutil
    import sysconfig
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native

    t0 = time.perf_counter()
    v = sysconfig.get_config_var
    inc = sysconfig.get_paths()["include"]
    say("capi: probe: Python %s (%s), Py_ENABLE_SHARED %s, LDLIBRARY %s, "
        "INSTSONAME %s, LIBDIR %s, %s/Python.h %s" % (
            sys.version.split()[0], sys.executable, v("Py_ENABLE_SHARED"),
            v("LDLIBRARY"), v("INSTSONAME"), v("LIBDIR"), inc,
            "present" if os.path.exists(os.path.join(inc, "Python.h"))
            else "MISSING"))
    try:
        link = _native.python_link()
    except RuntimeError as e:
        say("capi: this machine cannot embed its Python (%s): (a)-(c) not "
            "run" % e)
        return
    t = time.perf_counter()
    so = _native.build_predict_shim()
    build_s = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="chip_smoke_capi_")
    try:
        t = time.perf_counter()
        hosts = capi_hosts(so, tmp)
        say("capi: the shim %s built by g++ in %.1f s (%s); predict.c and "
            "train.c built against it in %.1f s" % (
                os.path.basename(so), build_s, " ".join(link),
                time.perf_counter() - t))
        with mx.gpu(0):
            for part in (capi_serve, capi_train, capi_errors):
                t = time.perf_counter()
                part(mx, hosts, tmp)
                say("capi: %s %.1f s" % (part.__name__,
                                          time.perf_counter() - t))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say("capi: phase done in %.1f s" % (time.perf_counter() - t0))


SURFACE_RTC = {
    "saxpy": ("""
def saxpy(x, y):
    return 2.5 * x + y
""", ["x", "y"], ["out"]),
    "squares": ("""
def squares(x):
    return x * x, x + x
""", ["x"], ["a", "b"]),
    "saxpy_triton": ("""
@triton.jit
def _saxpy_kernel(x_ptr, y_ptr, out_ptr, a, n, BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    x = tl.load(x_ptr + i, mask=m)
    y = tl.load(y_ptr + i, mask=m)
    tl.store(out_ptr + i, a * x + y, mask=m)


def saxpy_triton(x, y):
    out = torch.empty_like(x)
    n = x.numel()
    _saxpy_kernel[(triton.cdiv(n, 1024),)](x, y, out, 2.5, n, BLOCK=1024)
    return out
""", ["x", "y"], ["out"]),
}


def tb_scalars(path):
    """(tag, step, value) of each scalar in a TensorBoard event file: its
    TFRecord frames (length, masked CRC of the length, payload, masked
    CRC of the payload; both CRCs checked) and the Event protos' wire
    fields (step 2, summary 5 -> value 1 -> tag 1, simple_value 2)."""
    import struct
    from mxnet_tpu_torch.contrib.tensorboard import _masked_crc

    def varint(buf, i):
        n = shift = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n, i

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            wire = key & 7
            if wire == 0:
                v, i = varint(buf, i)
            elif wire in (1, 5):
                width = 8 if wire == 1 else 4
                v, i = buf[i:i + width], i + width
            else:
                n, i = varint(buf, i)
                v, i = buf[i:i + n], i + n
            yield key >> 3, v

    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        payload = data[i + 12:i + 12 + n]
        if struct.unpack("<I", data[i + 8:i + 12])[0] != _masked_crc(head) \
                or struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] != \
                _masked_crc(payload):
            fail("tb_scalars: a bad CRC at byte %d of %s" % (i, path))
        i += 16 + n
        ev = dict(fields(payload))
        for num, value in fields(ev.get(5, b"")):
            v = dict(fields(value))
            out.append((v[1].decode(), ev.get(2, 0),
                        struct.unpack("<f", v[2])[0]))
    return out


def surface_phase():
    """Item 10.6's surface on the card: (a) mx.rtc runs the JAX test's
    saxpy and two-output sources on card tensors, equal to their plain
    results, and a source that defines a @triton.jit kernel and launches
    it, within SURFACE_TRITON_TOL; (b) mx.viz.print_summary of ResNet-50
    gives its parameter count (the learned parameters and the moving
    statistics of its inferred shapes); (c) test_utils.check_speed of
    ResNet-50's inference forward (batch 128, float32) within
    SURFACE_SPEED_RTOL of time_ms of the same forward; (d) contrib.
    tensorboard's LogMetricsCallback on a short Module.fit on the card
    writes values that read back equal to the
    metric's (read by tb_scalars). Triton's cache goes under build/triton
    in the checkout."""
    import contextlib
    import glob
    import io as _io
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import test_utils
    from mxnet_tpu_torch.contrib.tensorboard import LogMetricsCallback
    from mxnet_tpu_torch.models import resnet

    t0 = time.perf_counter()
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(HERE, "build", "triton"))
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(1 << 22, device="cuda", generator=gen)
    y = torch.randn(1 << 22, device="cuda", generator=gen)
    plain = {"saxpy": [2.5 * x + y], "squares": [x * x, x + x],
             "saxpy_triton": [2.5 * x + y]}
    with mx.gpu(0):
        for name, (src, ins, outs) in SURFACE_RTC.items():
            t = time.perf_counter()
            rtc = mx.rtc.Rtc(name, ins, outs, src)
            arrs = [mx.nd.zeros(tuple(x.shape)) for _ in outs]
            rtc.push([mx.nd.NDArray(x), mx.nd.NDArray(y)][:len(ins)], arrs)
            first_s = time.perf_counter() - t
            errs = []
            for got, want in zip(arrs, plain[name]):
                if got.handle.device != want.device:
                    fail("surface (a) %s: an output on %s" % (
                        name, got.handle.device))
                if name == "saxpy_triton":
                    errs.append(check_close("surface (a) %s" % name,
                                            got.handle, want,
                                            SURFACE_TRITON_TOL))
                elif not torch.equal(got.handle, want):
                    fail("surface (a) %s: differs from its plain result"
                         % name)
                else:
                    errs.append(0.0)
            ms = time_ms(lambda: rtc.push([mx.nd.NDArray(x),
                                           mx.nd.NDArray(y)][:len(ins)],
                                          arrs), reps=10)
            say("surface (a): mx.rtc %s over %d floats on the card: max abs "
                "err %s against the plain result (%s); first push %.2f s "
                "(compile included), %.4f ms a push by events" % (
                    name, x.numel(), " ".join("%.3g" % e for e in errs),
                    "within %r" % (SURFACE_TRITON_TOL,)
                    if name == "saxpy_triton" else "equal", first_s, ms))

    S, B = RESNET_IMAGE, RESNET_BATCH
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, image_shape=(3, S, S))
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = mx.viz.print_summary(sym, shape={"data": (1, 3, S, S)})
    args, _, aux = sym.infer_shape(data=(1, 3, S, S))
    count = sum(int(np.prod(s)) for n, s in zip(sym.list_arguments(), args)
                if n not in ("data", "softmax_label")) + \
        sum(int(np.prod(s)) for s in aux)
    if total != count:
        fail("surface (b): print_summary counts %d parameters, the inferred "
             "shapes %d" % (total, count))
    say("surface (b): mx.viz.print_summary of ResNet-50: %d rows, total "
        "params %d (learned and moving statistics)" % (
            len(buf.getvalue().splitlines()), total))

    with mx.gpu(0):
        exe = sym.simple_bind(mx.gpu(0), grad_req="null",
                              data=(B, 3, S, S), softmax_label=(B,))
        rs = np.random.RandomState(3)
        for name, arr in exe.arg_dict.items():
            arr[:] = rs.standard_normal(arr.shape).astype(np.float32) * 0.01

        def fwd():
            return exe.forward(is_train=False)
        speed_ms = test_utils.check_speed(f=fwd, N=10) * 1e3
        ev_ms = time_ms(fwd, reps=10, warmup=2)
    if abs(speed_ms - ev_ms) > SURFACE_SPEED_RTOL * ev_ms:
        fail("surface (c): check_speed %.2f ms against time_ms %.2f ms"
             % (speed_ms, ev_ms))
    say("surface (c): test_utils.check_speed of ResNet-50's forward (batch "
        "%d, float32): %.2f ms a run, time_ms %.2f ms (%.3fx)" % (
            B, speed_ms, ev_ms, speed_ms / ev_ms))
    del exe
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tb_")
    try:
        rs = np.random.RandomState(5)
        X = rs.standard_normal((256, 32)).astype(np.float32)
        Y = (X[:, :8].sum(axis=1) > 0).astype(np.float32)
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
            mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=64,
                                  name="fc1"), act_type="relu"),
            num_hidden=2, name="fc2"), name="softmax")
        with mx.gpu(0):
            it = mx.io.NDArrayIter(X, Y, batch_size=64)
        seen = []

        def record(param):
            seen.append([(n, float(v)) for n, v in
                         param.eval_metric.get_name_value()])
        cb = LogMetricsCallback(tmp, prefix="train")
        mod = mx.mod.Module(net, context=mx.gpu(0))
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                eval_metric=["acc", "ce"], batch_end_callback=[record, cb])
        cb.close()
        files = glob.glob(os.path.join(tmp, "events.out.tfevents.*"))
        read = tb_scalars(files[0])
        want = [("train/" + n, i + 1, float(np.float32(val)))
                for i, pairs in enumerate(seen) for n, val in pairs]
        if len(files) != 1 or read != want:
            fail("surface (d): the event file reads back %r, the metric "
                 "gave %r" % (read[:6], want[:6]))
        say("surface (d): LogMetricsCallback on Module.fit on the card (%d "
            "batches): %d scalars read back equal to the metric's (last: "
            "%s)" % (
                len(seen), len(read), read[-2:]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("surface: phase done in %.1f s" % (time.perf_counter() - t0))


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

    seconds, by_path = {}, {}

    def run(name, fn, *args, path=True, merge=False):
        """One phase, timed; a path's launch counts kept under ``name``
        (or its dict of paths merged)."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        if merge:
            by_path.update(out)
        elif path:
            by_path[name] = out
        return out

    bn = [bnk.bn_stats_cuda, bnk.bn_apply_cuda, bnk.bn_bwd_reduce_cuda,
          bnk.bn_bwd_dx_cuda]
    records = run("kernels", lambda: kernel_phase() + bwd_kernel_phase() +
                  f32_kernel_phase(ptxas), path=False)
    run("gqa", gqa_phase, path=False)
    records += run("kernels2", lambda: bn_kernel_phase() +
                   nms_kernel_phase() + mt_kernel_phase(), path=False)
    run("prng", prng_phase, path=False)
    run("serve", path_phase, [att.flash_fwd_cuda])
    run("train", train_phase, [att.flash_fwd_cuda, att.flash_bwd_cuda])
    run("fit", fit_phase)
    run("executor", executor_phase, merge=True)
    run("resnet", resnet_phase, bn, merge=True)
    run("ssd", ssd_phase, [nmsk.nms_keep_cuda])
    for name, fn in (("alexnet", alexnet_phase), ("module", module_phase),
                     ("compiled_resnet", compiled_resnet_phase),
                     ("compiled_alexnet", compiled_alexnet_phase),
                     ("lm_options", lm_options_phase),
                     ("generate", generate_phase),
                     ("serve_decode", serve_decode_phase),
                     ("serve_fleet", serve_fleet_phase)):
        run(name, fn)
    run("compiled_serve", compiled_serve_phase,
        [att.flash_fwd_cuda, nmsk.nms_keep_cuda])
    for name, fn in (("moe_lm", moe_lm_phase), ("mesh2", mesh2_phase),
                     ("gspmd2", gspmd2_phase), ("kvdist2", kvdist2_phase),
                     ("profiler", profiler_phase)):
        run(name, fn)
    run("gluon", gluon_phase, bn)
    run("rnn", rnn_phase)
    run("detect", detect_phase)
    run("zoo", zoo_phase, bn)
    run("sparse", sparse_phase, path=False)
    run("image", image_phase)
    run("capi", capi_phase, path=False)
    run("surface", surface_phase, path=False)
    say("phases (s): %s" % json.dumps(seconds))
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
           "compiled_serve": lambda: compiled_serve_phase(_serve_counters()),
           "moe_lm": moe_lm_phase, "mesh2": mesh2_phase,
           "gspmd2": gspmd2_phase, "kvdist2": kvdist2_phase,
           "profiler": profiler_phase,
           "gluon": lambda: gluon_phase(_bn_counters()),
           "rnn": rnn_phase, "detect": detect_phase,
           "sparse": sparse_phase,
           "zoo": lambda: zoo_phase(list(_bn_counters())),
           "image": image_phase, "capi": capi_phase,
           "surface": surface_phase}


def _serve_counters():
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import nms_kernels as nmsk
    return [att.flash_fwd_cuda, nmsk.nms_keep_cuda]


if __name__ == "__main__":
    if sys.argv[1:] == ["--kv-server"]:
        # kvdist2's parameter server: the package's import takes the
        # server role from DMLC_ROLE=server and never returns here
        sys.path.insert(0, HERE)
        import mxnet_tpu_torch  # noqa: F401
        fail("kvdist2: the server role returned into the script")
    elif len(sys.argv) == 2 and sys.argv[1].startswith("--kv-rank="):
        r, w, p, ps, d, device, tiny = sys.argv[1].split("=", 1)[1].split(",")
        _kv_rank(int(r), int(w), int(p), int(ps), d, device, bool(int(tiny)))
    elif len(sys.argv) == 2 and sys.argv[1].startswith(("--mesh-rank=",
                                                        "--gspmd-rank=")):
        # one rank of the mesh2 or gspmd2 phase (started by the phase)
        r, w, p, d, device, tiny = sys.argv[1].split("=", 1)[1].split(",")
        rank_main = _mesh_rank if sys.argv[1].startswith("--mesh") \
            else _gspmd_rank
        rank_main(int(r), int(w), int(p), d, device, bool(int(tiny)))
    else:
        main()
