"""The port's image builders (AlexNet, VGG, Inception-BN, Inception-v3)
against the JAX package's, and one AlexNet training step against the
JAX ``TrainStep``, on the CPU.

Each builder's graph must serialise to the same JSON as the JAX
builder's and infer the same shapes. AlexNet (its graph; 67x67 images
and 10 classes keep the CPU run small) trains one SGD step at batch 2
from one state and one key in both packages, and six steps of bench.py's
SGD (momentum 0.9, wd 1e-4, lr 0.1) whose outputs, NLL, weights and
momenta follow the JAX package's step by step; the two Dropouts'
outputs, read through each graph evaluator's capture hook, must be
equal bit for bit in their zeros (the masks) and within rtol 1e-4 in
their values, as the outputs and the gradients (float32; summation
order differs).

The rest of the symbolic catalog (LeNet, MLP, MobileNet, ResNeXt,
GoogLeNet, Inception-v4, Inception-ResNet-v2) builds the JAX package's
JSON and shapes here; ``tests/test_torch_zoo.py`` runs each network's
forward and training step against the JAX package.
"""
import json

import numpy as np
import pytest

import jax
import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.executor import _graph_eval_fn as jeval_fn
from mxnet_tpu.initializer import Xavier as JXavier
from mxnet_tpu.parallel import make_train_step as jmake_train_step

import torch
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import state_from_jax
from mxnet_tpu_torch.executor import _graph_eval_fn as teval_fn
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step

F32 = dict(rtol=1e-4, atol=1e-6)

# (case id, catalog name, builder kwargs, data shape)
BUILDERS = [
    ("alexnet", "alexnet", {}, (2, 3, 224, 224)),
    ("alexnet_10", "alexnet", {"num_classes": 10}, (2, 3, 67, 67)),
    ("vgg11", "vgg", {"num_layers": 11}, (1, 3, 224, 224)),
    ("vgg16_bn", "vgg", {"num_layers": 16, "batch_norm": True},
     (1, 3, 224, 224)),
    ("inception_bn", "inception-bn", {}, (1, 3, 224, 224)),
    ("inception_bn_alias", "inception_bn", {"num_classes": 10},
     (1, 3, 224, 224)),
    ("inception_v3", "inception-v3", {}, (1, 3, 299, 299)),
    ("inception_v3_alias", "inception_v3", {"num_classes": 10},
     (1, 3, 299, 299)),
    ("lenet", "lenet", {}, (64, 1, 28, 28)),
    ("mlp", "mlp", {}, (64, 1, 28, 28)),
    ("mobilenet", "mobilenet", {}, (1, 3, 224, 224)),
    ("mobilenet_half", "mobilenet", {"multiplier": 0.5, "num_classes": 10},
     (1, 3, 224, 224)),
    ("resnext50", "resnext", {}, (1, 3, 224, 224)),
    ("resnext101_64x4d", "resnext", {"num_layers": 101, "cardinality": 64,
                                     "num_classes": 10}, (1, 3, 224, 224)),
    ("googlenet", "googlenet", {}, (1, 3, 224, 224)),
    ("inception_v4", "inception-v4", {}, (1, 3, 299, 299)),
    ("inception_v4_alias", "inception_v4", {"num_classes": 10},
     (1, 3, 299, 299)),
    ("inception_resnet_v2", "inception-resnet-v2", {}, (1, 3, 299, 299)),
    ("inception_resnet_v2_alias", "inception_resnet_v2",
     {"num_classes": 10}, (1, 3, 299, 299)),
]


def _build(name, **kwargs):
    """Both packages' symbols, each in a fresh name scope (the automatic
    names of unnamed nodes count per scope)."""
    with jmx.name.NameManager():
        jsym = jmodels.get_symbol(name, **kwargs)
    with tmx.name.NameManager():
        tsym = tmodels.get_symbol(name, **kwargs)
    return jsym, tsym


@pytest.mark.parametrize("name,kwargs,shape", [c[1:] for c in BUILDERS],
                         ids=[c[0] for c in BUILDERS])
def test_builder_json_and_shapes_match_jax(name, kwargs, shape):
    jsym, tsym = _build(name, **kwargs)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    shapes = {"data": shape, "softmax_label": (shape[0],)}
    assert tsym.infer_shape(**shapes) == tuple(
        [tuple(s) for s in part] for part in jsym.infer_shape(**shapes))
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()


B, IMAGE, CLASSES = 2, 67, 10
SHAPES = {"data": (B, 3, IMAGE, IMAGE), "softmax_label": (B,)}
SGD = {"momentum": 0.0}


@pytest.fixture(scope="module")
def alexnet():
    """(JAX symbol, port symbol, JAX state as numpy, batch)."""
    jsym, tsym = _build("alexnet", num_classes=CLASSES)
    jmx.random.seed(4)
    state = jmake_train_step(jsym, optimizer="sgd",
                             optimizer_params=SGD).init_state(
        JXavier(factor_type="in", magnitude=2.0), SHAPES)
    rng = np.random.RandomState(5)
    batch = {"data": rng.standard_normal(SHAPES["data"]).astype(np.float32),
             "softmax_label": rng.randint(0, CLASSES, (B,)).astype(
                 np.float32)}
    return jsym, tsym, jax.tree_util.tree_map(np.asarray, state), batch


def _dropouts(sym):
    """Names of the Dropout nodes and of the nodes feeding them."""
    nodes = json.loads(sym.tojson())["nodes"]
    return {n["name"]: nodes[n["inputs"][0][0]]["name"] for n in nodes
            if n["op"] == "Dropout"}


@pytest.mark.parametrize("key", ["jax_key", "int_seed"])
def test_alexnet_train_step_matches_jax(alexnet, key):
    """One SGD step (momentum 0, lr 1, so w - w' is the rescaled
    gradient) from one state and key: the port takes the JAX key's
    uint32[2], or the int seed as PRNGKey(seed)."""
    jsym, tsym, state0, batch = alexnet
    jstep = jmake_train_step(jsym, optimizer="sgd", optimizer_params=SGD,
                             donate=False)
    tstep = tmake_train_step(tsym, optimizer="sgd", optimizer_params=SGD,
                             ctx=tmx.cpu())
    jkey = jax.random.PRNGKey(3)
    jstate, jouts = jstep(state0, jstep.place_batch(batch), 1.0, jkey)
    tstate, touts = tstep(state_from_jax(state0, "cpu"), batch, 1.0,
                          np.asarray(jkey) if key == "jax_key" else 3)
    np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]),
                               **F32)
    for n, w in state0[0].items():
        np.testing.assert_allclose(w - tstate[0][n].numpy(),
                                   w - np.asarray(jstate[0][n]),
                                   err_msg=n, **F32)


# bench.py's optimizer (bench_image) and lr (_timed_loop)
BENCH_LR, BENCH_STEPS = 0.1, 6


def _nll(probs, labels):
    p = np.asarray(probs, np.float64)[np.arange(len(labels)),
                                      labels.astype(int)]
    return float(-np.log(np.maximum(p, 1e-30)).mean())


def _bench_steps(jsym, tsym, params, batch, steps, compute_dtype=None):
    """bench.py's SGD (momentum 0.9, wd 1e-4, rescale 1/B, lr 0.1) on one
    batch with PRNGKey(0) every step, in both packages from the same
    weights: yields (JAX outputs, port outputs, JAX state, port state)
    after each step."""
    opt = {"momentum": 0.9, "wd": 1e-4,
           "rescale_grad": 1.0 / len(batch["softmax_label"])}
    jstep = jmake_train_step(jsym, optimizer="sgd", optimizer_params=opt,
                             compute_dtype=compute_dtype, donate=False)
    tstep = tmake_train_step(tsym, optimizer="sgd", optimizer_params=opt,
                             compute_dtype=compute_dtype, ctx=tmx.cpu())
    shapes = {k: v.shape for k, v in batch.items()}
    jstate = jstep.init_state(JXavier(), shapes, arg_params=params)
    tstate = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                            "cpu")
    jbatch = jstep.place_batch(batch)
    key = jax.random.PRNGKey(0)
    for _ in range(steps):
        jstate, jouts = jstep(jstate, jbatch, BENCH_LR, key)
        tstate, touts = tstep(tstate, batch, BENCH_LR, np.asarray(key))
        yield jouts, touts, jstate, tstate


def test_alexnet_bench_optimizer_trajectory_matches_jax(alexnet):
    """Six steps of bench.py's SGD on one batch with PRNGKey(0) every
    step, as bench.py and chip_smoke.py's AlexNet phase run it: each
    step's outputs and NLL, and the last weights and momenta, follow the
    JAX package's."""
    jsym, tsym, state0, batch = alexnet
    labels = batch["softmax_label"]
    jnll, tnll = [], []
    for i, (jouts, touts, jstate, tstate) in enumerate(_bench_steps(
            jsym, tsym, state0[0], batch, BENCH_STEPS)):
        np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]),
                                   err_msg="step %d" % i, **F32)
        jnll.append(_nll(jouts[0], labels))
        tnll.append(_nll(touts[0].numpy(), labels))
    np.testing.assert_allclose(tnll, jnll, rtol=1e-4, atol=1e-5)
    assert tnll[-1] < tnll[0]
    for n in state0[0]:
        np.testing.assert_allclose(tstate[0][n].numpy(),
                                   np.asarray(jstate[0][n]),
                                   err_msg=n, **F32)
        for tm, jm in zip(tstate[1][n], jstate[1][n]):
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm),
                                       err_msg=n + " momentum", **F32)


def test_alexnet_dropout_masks_equal_jax(alexnet):
    """The training forward of the graph with one key: each Dropout's
    output (a function of fold_in(key, uid)) has the JAX package's zeros
    exactly, its kept values scaled by 2."""
    jsym, tsym, state0, batch = alexnet
    drops = _dropouts(tsym)
    assert len(drops) == 2 and drops == _dropouts(jsym)
    seen = {"jax": {}, "port": {}}

    def grab(store):
        def capture(name, outs):
            if name in drops or name in drops.values():
                store[name] = np.asarray(
                    outs[0].detach() if hasattr(outs[0], "detach")
                    else outs[0], np.float32)
        return capture
    args = {**state0[0], **batch}
    jeval_fn(jsym, capture=grab(seen["jax"]))(
        {k: jax.numpy.asarray(v) for k, v in args.items()}, {},
        jax.random.PRNGKey(9), True)
    with torch.no_grad():
        teval_fn(tsym, capture=grab(seen["port"]))(
            {k: torch.from_numpy(v.copy()) for k, v in args.items()}, {},
            tmx.random.PRNGKey(9), True)
    for name, src in drops.items():
        j, t = seen["jax"][name], seen["port"][name]
        inp = seen["port"][src]
        np.testing.assert_array_equal(t == 0, j == 0, err_msg=name)
        kept = t != 0
        assert 0.4 < kept.mean() < 0.6 or (inp == 0).mean() > 0.3
        np.testing.assert_array_equal(t[kept], inp[kept] * 2)
        np.testing.assert_allclose(t, j, err_msg=name, **F32)


def main(argv=None):
    """Print both packages' NLL per step of bench.py's AlexNet workload
    cut to ``--batch`` (bench.py's init and data), on the CPU."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--dtype", default="bfloat16")
    a = ap.parse_args(argv)
    jsym, tsym = _build("alexnet", num_classes=a.classes)
    shapes = {"data": (a.batch, 3, a.image, a.image),
              "softmax_label": (a.batch,)}
    jmx.random.seed(0)
    params = jax.tree_util.tree_map(np.asarray, jmake_train_step(
        jsym, optimizer="sgd").init_state(
            JXavier(factor_type="in", magnitude=2.0), shapes)[0])
    batch = {"data": np.random.RandomState(0).standard_normal(
        shapes["data"]).astype(np.float32),
             "softmax_label": np.random.RandomState(1).randint(
                 0, a.classes, (a.batch,)).astype(np.float32)}
    cdt = None if a.dtype == "float32" else a.dtype
    rows = {"jax": [], "port": []}
    for jouts, touts, _, _ in _bench_steps(jsym, tsym, params, batch,
                                           a.steps, cdt):
        rows["jax"].append(_nll(jouts[0], batch["softmax_label"]))
        rows["port"].append(_nll(touts[0].float().numpy(),
                                 batch["softmax_label"]))
    print("AlexNet %s, batch %d, %dx%d, %d classes, lr %g: NLL per step"
          % (a.dtype, a.batch, a.image, a.image, a.classes, BENCH_LR))
    for name, row in rows.items():
        print("%-4s %s" % (name, " ".join("%.4f" % v for v in row)))


if __name__ == "__main__":
    main()
