#!/usr/bin/env python3
"""How far the port's own float32 training step of each BatchNorm network
of the symbolic catalog moves when its input is perturbed at the scale of
f32's rounding (x * (1 + 1e-7 * N(0, 1)), three draws), on the CPU at the
sizes of tests/test_torch_zoo.py: the training output and the update
(w - w'), relative in norm. Also the distance between the port's two
BatchNorm routes (MXNET_BN_PALLAS=1 against 0) on the unperturbed step.

    python3 tools/zoo_step_sensitivity.py [--batch B] [name ...]

tests/test_torch_zoo.py's BN_STEP_TOL is 4x these readings.
"""
import argparse
import copy
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import config, models  # noqa: E402
from mxnet_tpu_torch.initializer import Xavier  # noqa: E402
from mxnet_tpu_torch.parallel import make_train_step  # noqa: E402

# (catalog name, image side) as tests/test_torch_zoo.py runs them
NETS = (("mobilenet", 128), ("resnext", 128), ("inception-v4", 139),
        ("inception-resnet-v2", 139))
CLASSES, LR, SEEDS = 10, 0.1, (9, 10, 11)


def rel(got, want):
    """||got - want|| / ||want|| over dicts of arrays."""
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    return np.sqrt(num / den)


def step(sym, state, feed, bn_kernels):
    """(training output, update) of one SGD step from a copy of
    ``state`` (the step updates its state in place)."""
    state = copy.deepcopy(state)
    w0 = {n: w.numpy().copy() for n, w in state[0].items()}
    opt = {"momentum": 0.9, "wd": 1e-4,
           "rescale_grad": 1.0 / len(feed["softmax_label"])}
    config.set_override("MXNET_BN_PALLAS", bn_kernels)
    try:
        new, outs = make_train_step(
            sym, optimizer="sgd", optimizer_params=opt, ctx=mx.cpu())(
                state, feed, LR, mx.random.PRNGKey(3))
    finally:
        config.clear_override("MXNET_BN_PALLAS")
    return ({0: outs[0].numpy()},
            {n: w - new[0][n].numpy() for n, w in w0.items()})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("names", nargs="*")
    a = ap.parse_args()
    for name, image in NETS:
        if a.names and name not in a.names:
            continue
        with mx.name.NameManager():
            sym = models.get_symbol(name, num_classes=CLASSES)
        shapes = {"data": (a.batch, 3, image, image),
                  "softmax_label": (a.batch,)}
        mx.random.seed(1)
        state = make_train_step(sym, optimizer="sgd",
                                ctx=mx.cpu()).init_state(
            Xavier(rnd_type="gaussian", factor_type="in", magnitude=2.0),
            shapes)
        rng = np.random.RandomState(2)
        x = rng.standard_normal(shapes["data"]).astype(np.float32)
        label = rng.randint(0, CLASSES, (a.batch,)).astype(np.float32)
        out0, w0 = step(sym, state, {"data": x, "softmax_label": label},
                        False)
        moves = []
        for seed in SEEDS:
            xp = (x * (1 + 1e-7 * np.random.RandomState(seed)
                       .standard_normal(x.shape))).astype(np.float32)
            out, w = step(sym, state, {"data": xp, "softmax_label": label},
                          False)
            moves.append((rel(out, out0), rel(w, w0)))
        out1, w1 = step(sym, state, {"data": x, "softmax_label": label},
                        True)
        print("%s %dx%d batch %d: perturbed output %s, update %s; "
              "BatchNorm routes output %.3g, update %.3g" % (
                  name, image, image, a.batch,
                  " ".join("%.3g" % m[0] for m in moves),
                  " ".join("%.3g" % m[1] for m in moves),
                  rel(out1, out0), rel(w1, w0)), flush=True)


if __name__ == "__main__":
    main()
