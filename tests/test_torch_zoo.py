"""The rest of the symbolic catalog in the port against the JAX package,
on the CPU: LeNet, MLP, MobileNet, ResNeXt-50, GoogLeNet, Inception-v4
and Inception-ResNet-v2 (their JSON and shapes are held in
``tests/test_torch_models.py``).

Each network runs one inference forward (under ``jax.jit`` on the JAX
side) within F32 and one ``make_train_step`` step of upstream
train_imagenet.py's SGD (momentum 0.9, wd 1e-4, rescale 1/B, lr 0.1,
Xavier gaussian in 2) from one state and key in both packages. Without
BatchNorm the step's outputs and weights are held within F32. With
BatchNorm a training step from random weights is sensitive to f32's
rounding itself: a 1e-7 relative perturbation of the input moves the
port's own step as far as the JAX package's step is from it, at every
batch and image size a CPU test can afford (relu and max-pool
near-ties flip, and each BatchNorm in training mode passes the relative
error on undamped). So each of its BatchNorm routes is held against JAX,
relative in norm, within the fixed bounds of ``BN_STEP_TOL``.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.executor import _graph_eval_fn as jeval_fn
from mxnet_tpu.parallel import make_train_step as jmake_train_step

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import state_from_jax
from mxnet_tpu_torch.executor import _graph_eval_fn as teval_fn
from mxnet_tpu_torch.initializer import Xavier
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step

F32 = dict(rtol=1e-4, atol=1e-6)
ZOO_CLASSES, LR = 10, 0.1


def _build(name, **kwargs):
    """Both packages' symbols, each in a fresh name scope."""
    with jmx.name.NameManager():
        jsym = jmodels.get_symbol(name, **kwargs)
    with tmx.name.NameManager():
        tsym = tmodels.get_symbol(name, **kwargs)
    return jsym, tsym


# (catalog name, image side, batch): MNIST's 28 for LeNet and the MLP;
# for the BatchNorm networks the least side at which their last
# BatchNorm normalises over more than one value a channel and batch row
ZOO = [("lenet", 28, 2), ("mlp", 28, 2), ("mobilenet", 128, 2),
       ("resnext", 128, 2), ("googlenet", 64, 2), ("inception-v4", 139, 2),
       ("inception-resnet-v2", 139, 2)]
# (training output, update) relative in norm against JAX for the
# BatchNorm networks: 4x, rounded up, the largest move of the port's own
# step (route MXNET_BN_PALLAS=0) under three draws of a 1e-7 relative
# perturbation of the input (ROADMAP Queue C 25): mobilenet 5.7e-6 and
# 3.2e-3, resnext 2.4e-5 and 3.6e-2, inception-v4 1.0e-3 and 0.12,
# inception-resnet-v2 4.9e-6 and 1.3e-2
BN_STEP_TOL = {"mobilenet": (3e-5, 0.015), "resnext": (1e-4, 0.15),
               "inception-v4": (4e-3, 0.5),
               "inception-resnet-v2": (2e-5, 0.06)}
TRAIN_IMAGENET_SGD = {"momentum": 0.9, "wd": 1e-4}


def _rel(got, want):
    """||got - want|| / ||want|| over dicts of arrays (or two arrays)."""
    if not isinstance(want, dict):
        got, want = {0: got}, {0: want}
    num = sum(float(np.sum((np.asarray(got[k], np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum(np.asarray(want[k], np.float64) ** 2))
              for k in want)
    return np.sqrt(num / den)


@pytest.mark.parametrize("name,image,batch", ZOO, ids=[z[0] for z in ZOO])
def test_zoo_forward_and_step_match_jax(name, image, batch):
    jsym, tsym = _build(name, num_classes=ZOO_CLASSES)
    chans = 1 if name in ("lenet", "mlp") else 3
    shapes = {"data": (batch, chans, image, image),
              "softmax_label": (batch,)}
    opt = dict(TRAIN_IMAGENET_SGD, rescale_grad=1.0 / batch)
    # the starting state from the port's initializer (the same draws as
    # the JAX package's), as numpy for both packages
    tmx.random.seed(1)
    state0 = jax.tree_util.tree_map(
        lambda t: t.numpy(), tmake_train_step(
            tsym, optimizer="sgd", optimizer_params=opt,
            ctx=tmx.cpu()).init_state(Xavier(
                rnd_type="gaussian", factor_type="in", magnitude=2.0),
                shapes))
    jstep = jmake_train_step(jsym, optimizer="sgd", optimizer_params=opt,
                             donate=False)
    rng = np.random.RandomState(2)
    feed = {"data": rng.standard_normal(shapes["data"]).astype(np.float32),
            "softmax_label": rng.randint(0, ZOO_CLASSES, (batch,)).astype(
                np.float32)}

    # the inference forward (moving statistics), JAX under jit
    args = {**state0[0], **feed}
    jfwd = jax.jit(lambda a, x: jeval_fn(jsym)(a, x, jax.random.PRNGKey(0),
                                                False)[0])
    jout = np.asarray(jfwd(args, state0[2])[0])
    with torch.no_grad():
        tout = teval_fn(tsym)(
            {k: torch.from_numpy(v.copy()) for k, v in args.items()},
            {k: torch.from_numpy(v.copy()) for k, v in state0[2].items()},
            tmx.random.PRNGKey(0), False)[0][0].numpy()
    np.testing.assert_allclose(tout, jout, err_msg="inference", **F32)

    # one training step from the same state and key
    key = jax.random.PRNGKey(3)
    jstate, jouts = jstep(state0, jstep.place_batch(feed), LR, key)
    jw = {n: w - np.asarray(jstate[0][n]) for n, w in state0[0].items()}
    for bn_kernels in ((False, True) if name in BN_STEP_TOL else (None,)):
        tconfig.set_override("MXNET_BN_PALLAS", bn_kernels)
        try:
            tstate, touts = tmake_train_step(
                tsym, optimizer="sgd", optimizer_params=opt,
                ctx=tmx.cpu())(state_from_jax(state0, "cpu"), feed,
                               LR, np.asarray(key))
        finally:
            tconfig.clear_override("MXNET_BN_PALLAS")
        tout = touts[0].numpy()
        assert np.isfinite(tout).all()
        if name not in BN_STEP_TOL:
            np.testing.assert_allclose(tout, np.asarray(jouts[0]), **F32)
            for n in state0[0]:
                np.testing.assert_allclose(tstate[0][n].numpy(),
                                           np.asarray(jstate[0][n]),
                                           err_msg=n, **F32)
            continue
        tol_out, tol_w = BN_STEP_TOL[name]
        tw = {n: w - tstate[0][n].numpy() for n, w in state0[0].items()}
        assert _rel(tout, np.asarray(jouts[0])) <= tol_out, bn_kernels
        assert _rel(tw, jw) <= tol_w, (bn_kernels, _rel(tw, jw))
        for n, v in state0[2].items():
            assert not np.array_equal(tstate[2][n].numpy(), v), n
