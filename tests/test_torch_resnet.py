"""The port's ResNet against the JAX package's, on the CPU.

* Symbols: v1 and v2 at depths 18 and 50 (3x224x224) and the CIFAR
  depth 8 (3x8x8) list the same arguments, aux states and inferred
  shapes, and each package loads the other's JSON to the same graph.
* Inference: from one set of f32 parameters and moving stats, the
  probabilities of resnet-18 (2x3x64x64) and resnet-50 (1x3x64x64)
  agree within rtol 1e-5 / atol 1e-7 (summation order only).
* Training: a small ResNet (v2, ImageNet stem with its max pool, two
  stages of widths 8 and 16, 3x40x40, batch 4) starts in both packages
  from one JAX ``init_state`` (``convert.state_from_jax``) and takes 3
  SGD-momentum steps with wd, on the default BatchNorm route and with
  ``MXNET_BN_PALLAS=1`` (the JAX package's Pallas kernels in interpret
  mode, the port's plain versions): parameters, momenta and moving
  stats within rtol 1e-4 / atol 1e-5 (f32; summation order only, grown
  over 3 steps). Under bf16 compute each package is held to its own f32
  run, as in ``tests/test_torch_train.py`` (bounds in
  ``test_bf16_step_is_held_to_f32``).
* Checkpoints: JAX ``save_checkpoint`` -> port ``load_checkpoint``
  gives the same probabilities, and the reverse.
"""
import json

import numpy as np
import pytest

import jax
import mxnet_tpu as jmx
from mxnet_tpu import model as jmodel
from mxnet_tpu.executor import _graph_eval_fn as jeval_fn
from mxnet_tpu.initializer import Xavier as JXavier
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.parallel import make_train_step as jmake_train_step

import torch
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import params_from_jax, state_from_jax
from mxnet_tpu_torch.executor import _graph_eval_fn as teval_fn
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step

F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("num_layers,image,version", [
    (18, (3, 224, 224), 1), (18, (3, 224, 224), 2),
    (50, (3, 224, 224), 1), (50, (3, 224, 224), 2),
    (8, (3, 8, 8), 1), (8, (3, 8, 8), 2),
])
def test_symbol_matches_jax(num_layers, image, version):
    js = jresnet.get_symbol(1000, num_layers, image, version=version)
    ts = tresnet.get_symbol(1000, num_layers, image, version=version)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    shape = (2,) + image
    for a, b in zip(ts.infer_shape(data=shape), js.infer_shape(data=shape)):
        assert [tuple(x) for x in a] == [tuple(x) for x in b]
    # each package loads the other's JSON to the same graph
    for loaded, orig in ((tmx.sym.load_json(js.tojson()), js),
                         (jmx.sym.load_json(ts.tojson()), ts)):
        assert loaded.list_arguments() == orig.list_arguments()
        assert loaded.list_auxiliary_states() == \
            orig.list_auxiliary_states()
        assert [tuple(x) for x in loaded.infer_shape(data=shape)[0]] == \
            [tuple(x) for x in orig.infer_shape(data=shape)[0]]
    # node by node the same ops (auto-generated names such as
    # "pooling0" count per package and process, so they are not compared)
    assert _ops(ts) == _ops(js)


def _ops(sym):
    return [n["op"] for n in json.loads(sym.tojson())["nodes"]]


def _random_state(sym, shape, seed):
    """f32 parameters and moving stats from a numpy seed, scaled so the
    activations stay O(1) through the net."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            args[n] = (1 + 0.1 * rng.randn(*s)).astype(np.float32)
        elif n.endswith("_beta") or n.endswith("_bias"):
            args[n] = (0.1 * rng.randn(*s)).astype(np.float32)
        else:
            fan_in = np.prod(s[1:])
            args[n] = (rng.randn(*s) / np.sqrt(fan_in)).astype(np.float32)
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = (np.abs(1 + 0.2 * rng.randn(*s)) if n.endswith("var")
                  else 0.1 * rng.randn(*s)).astype(np.float32)
    return args, aux


def _forward_both(jsym, tsym, args, aux, x):
    y = np.zeros((x.shape[0],), np.float32)
    jout, _ = jeval_fn(jsym)({**args, "data": x, "softmax_label": y}, aux,
                             jax.random.PRNGKey(0), False)
    tout, _ = teval_fn(tsym)(
        {**params_from_jax(args, "cpu"), "data": torch.from_numpy(x),
         "softmax_label": torch.from_numpy(y)},
        params_from_jax(aux, "cpu"), 0, False)
    return np.asarray(jout[0]), tout[0].numpy()


@pytest.mark.parametrize("num_layers,batch", [(18, 2), (50, 1)])
def test_inference_forward_matches_jax(num_layers, batch):
    image = (3, 64, 64)
    jsym = jresnet.get_symbol(10, num_layers, image)
    tsym = tresnet.get_symbol(10, num_layers, image)
    args, aux = _random_state(jsym, (batch,) + image, seed=num_layers)
    x = np.random.RandomState(1).randn(batch, *image).astype(np.float32)
    j, t = _forward_both(jsym, tsym, args, aux, x)
    assert t.shape == j.shape == (batch, 10)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

B, IMAGE = 4, (3, 40, 40)
SHAPES = {"data": (B,) + IMAGE, "softmax_label": (B,)}
SGD = {"momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0 / B}


def _small_resnet(pkg):
    """v2 ResNet with the ImageNet stem (7x7/2 conv, BN, relu, 3x3/2 max
    pool), one unit in each of two stages of widths 8 and 16."""
    return pkg.resnet(units=[1, 1], num_stages=2, filter_list=[8, 8, 16],
                      num_classes=10, image_shape=IMAGE, bottle_neck=False)


@pytest.fixture(scope="module")
def small():
    """(JAX symbol, port symbol, initial JAX state as numpy, batch)."""
    jsym, tsym = _small_resnet(jresnet), _small_resnet(tresnet)
    jmx.random.seed(5)
    state = jmake_train_step(jsym, optimizer="sgd",
                             optimizer_params=SGD).init_state(
        JXavier(factor_type="in", magnitude=2.0), SHAPES)
    rng = np.random.RandomState(6)
    batch = {"data": rng.standard_normal((B,) + IMAGE).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (B,)).astype(np.float32)}
    return jsym, tsym, jax.tree_util.tree_map(np.asarray, state), batch


def test_init_state_is_bit_identical_to_jax(small):
    """Xavier(factor_type="in", magnitude=2) on the 4-D conv weights,
    gamma 1 / beta 0, moving mean 0 / var 1: one seed, the same bits."""
    _, tsym, state0, _ = small
    tmx.random.seed(5)
    params, opt, aux = tmake_train_step(
        tsym, optimizer="sgd", optimizer_params=SGD,
        ctx=tmx.cpu()).init_state(
        tmx.initializer.Xavier(factor_type="in", magnitude=2.0), SHAPES)
    assert sorted(params) == sorted(state0[0])
    assert sorted(aux) == sorted(state0[2])
    for got, want in ((params, state0[0]), (aux, state0[2])):
        for n, v in got.items():
            assert v.dtype == torch.float32, n
            np.testing.assert_array_equal(v.numpy(), want[n], err_msg=n)


def _np_state(state):
    def conv(x):       # a copy: the port's donated step updates in place
        if hasattr(x, "detach"):
            return x.detach().float().numpy().copy()
        return np.array(x, np.float32)
    params, opt, aux = state
    return ({k: conv(v) for k, v in params.items()},
            {k: tuple(conv(s) for s in v) for k, v in opt.items()},
            {k: conv(v) for k, v in aux.items()})


def _run_both(small, steps, lr, compute_dtype=None, opt=SGD):
    jsym, tsym, state0, batch = small
    kw = dict(optimizer="sgd", optimizer_params=dict(opt),
              compute_dtype=compute_dtype)
    jstep = jmake_train_step(jsym, donate=False, **kw)
    tstep = tmake_train_step(tsym, ctx=tmx.cpu(), **kw)
    jstate = state0
    tstate = state_from_jax(state0, "cpu")
    jb = jstep.place_batch(batch)
    js, ts = [_np_state(state0)], [_np_state(state0)]
    for i in range(steps):
        jstate, _ = jstep(jstate, jb, lr, jax.random.PRNGKey(i))
        tstate, _ = tstep(tstate, batch, lr, i)
        js.append(_np_state(jstate))
        ts.append(_np_state(tstate))
    return js, ts


@pytest.mark.parametrize("knob", ["0", "1"], ids=["two_pass", "kernels"])
def test_sgd_momentum_trajectory_matches_jax(small, knob, monkeypatch):
    monkeypatch.setenv("MXNET_BN_PALLAS", knob)
    js, ts = _run_both(small, 3, 0.1)
    assert sorted(ts[0][2]) == sorted(js[0][2]) and len(ts[0][2]) == 12
    for step in (1, 2, 3):
        for n in js[0][0]:
            np.testing.assert_allclose(ts[step][0][n], js[step][0][n],
                                       err_msg="%s step %d" % (n, step),
                                       **F32)
            np.testing.assert_allclose(ts[step][1][n][0], js[step][1][n][0],
                                       err_msg="mom %s step %d" % (n, step),
                                       **F32)
        for n in js[0][2]:
            np.testing.assert_allclose(ts[step][2][n], js[step][2][n],
                                       err_msg="%s step %d" % (n, step),
                                       **F32)
            assert not np.array_equal(ts[step][2][n], ts[step - 1][2][n])


def _distances(w0, bf16, f32):
    """Per parameter and over all parameters: the distance of the bf16
    step's update from the f32 step's, relative to the f32 update's
    norm (lr 1, no momentum or wd: the update is the rescaled
    gradient)."""
    per, num, den = {}, 0.0, 0.0
    for n, w in w0.items():
        ref = w - f32[n]
        err = np.linalg.norm((w - bf16[n]) - ref)
        per[n] = (err / np.linalg.norm(ref), np.linalg.norm(ref))
        num, den = num + err ** 2, den + np.linalg.norm(ref) ** 2
    return per, np.sqrt(num / den)


def test_bf16_step_is_held_to_f32(small, monkeypatch):
    """bf16 compute against each package's own f32 step, on both
    BatchNorm routes. bf16 rounds the activations and their gradients,
    so on this batch-4 net each update is 5-25% (in norm) from the f32
    update. Held: every run's whole update within 25% of its f32
    update; on the kernel route (the same rounding points in both
    packages) the port's per-parameter distance within 1.25x + 1e-3 of
    the JAX package's, for every parameter whose f32 update is above
    1e-3 of the largest (bn0_gamma's, ~3e-6, is rounding noise); on the
    two-pass route, where XLA's CPU fusions keep some bf16 intermediates
    in f32 and so come closer to f32, the port's whole update within
    1.25x of the JAX package's larger distance over the two routes."""
    plain = dict(SGD, momentum=0.0, wd=0.0)
    f32_j, f32_t = _run_both(small, 1, 1.0, None, plain)
    w0 = f32_j[0][0]
    got = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("MXNET_BN_PALLAS", knob)
        js, ts = _run_both(small, 1, 1.0, "bfloat16", plain)
        got[knob] = (_distances(w0, js[1][0], f32_j[1][0]),
                     _distances(w0, ts[1][0], f32_t[1][0]))
        for n, v in ts[1][2].items():       # moving stats, f32 masters
            np.testing.assert_allclose(v, f32_t[1][2][n], rtol=2e-2,
                                       atol=2e-2, err_msg=n)
    for knob, ((_, jd), (_, td)) in got.items():
        assert jd < 0.25 and td < 0.25, (knob, jd, td)
    (jper, _), (tper, _) = got["1"]
    top = max(norm for _, norm in jper.values())
    for n, (jd, norm) in jper.items():
        if norm > 1e-3 * top:
            assert tper[n][0] <= 1.25 * jd + 1e-3, (n, jd, tper[n][0])
    assert got["0"][1][1] <= 1.25 * max(got["0"][0][1], got["1"][0][1])


def test_bf16_state_keeps_f32_and_gamma_gets_gradients(small):
    """Under bf16 compute the state stays f32 (the moving stats
    included), and BatchNorm's gamma and beta move."""
    _, tsym, state0, batch = small
    step = tmake_train_step(tsym, optimizer="sgd", optimizer_params=SGD,
                            compute_dtype="bfloat16", ctx=tmx.cpu())
    state = state_from_jax(state0, "cpu")
    before = _np_state(state)
    state, outs = step(state, batch, 0.1, 0)
    assert outs[0].dtype == torch.bfloat16
    for group in state:
        for v in group.values():
            for t in (v if isinstance(v, tuple) else (v,)):
                assert t.dtype == torch.float32
    for n in ("bn0_gamma", "bn0_beta", "stage2_unit1_bn1_gamma", "bn1_beta"):
        assert not np.array_equal(state[0][n].numpy(), before[0][n]), n


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_checkpoints_load_across_packages(tmp_path):
    image = (3, 32, 32)
    jsym = jresnet.get_symbol(10, 8, (3, 8, 8))   # CIFAR stem
    tsym = tresnet.get_symbol(10, 8, (3, 8, 8))
    args, aux = _random_state(jsym, (2,) + image, seed=3)
    x = np.random.RandomState(4).randn(2, *image).astype(np.float32)
    want, _ = _forward_both(jsym, tsym, args, aux, x)
    y = np.zeros((2,), np.float32)

    # JAX writes, the port reads
    jmodel.save_checkpoint(str(tmp_path / "jax"), 3, jsym,
                           {k: jmx.nd.array(v) for k, v in args.items()},
                           {k: jmx.nd.array(v) for k, v in aux.items()})
    with tmx.cpu():
        sym, targs, taux = tmodel.load_checkpoint(str(tmp_path / "jax"), 3)
    assert sorted(targs) == sorted(args) and sorted(taux) == sorted(aux)
    out, _ = teval_fn(sym)(
        {**{k: v.handle for k, v in targs.items()},
         "data": torch.from_numpy(x), "softmax_label": torch.from_numpy(y)},
        {k: v.handle for k, v in taux.items()}, 0, False)
    np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-5, atol=1e-7)

    # the port writes (tensors or NDArrays), JAX reads
    tmodel.save_checkpoint(str(tmp_path / "port"), 7, tsym,
                           {k: v.handle for k, v in targs.items()}, taux)
    assert not list(tmp_path.glob("*.tmp"))
    sym, jargs, jaux = jmodel.load_checkpoint(str(tmp_path / "port"), 7)
    out, _ = jeval_fn(sym)(
        {**{k: v._data for k, v in jargs.items()}, "data": x,
         "softmax_label": y}, {k: v._data for k, v in jaux.items()},
        jax.random.PRNGKey(0), False)
    np.testing.assert_allclose(np.asarray(out[0]), want, rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the model catalog
# ---------------------------------------------------------------------------

def test_catalog_builds_resnet_and_names_what_is_not_ported():
    """resnet and its aliases build the port's own builder; every other
    catalog name of the JAX package builds too (the rest of the catalog
    is held to the JAX builders in test_torch_models.py); an unknown name
    raises ValueError."""
    a = tmodels.get_symbol("resnet", num_classes=10, num_layers=18,
                           image_shape="3,64,64")
    b = tmodels.get_symbol("resnet-v1", num_classes=10, num_layers=18,
                           image_shape=(3, 64, 64))
    for got, version in ((a, 2), (b, 1), (tmodels.get_symbol(
            "resnet_v1", num_classes=10, num_layers=18,
            image_shape=(3, 64, 64)), 1)):
        want = tresnet.get_symbol(10, 18, (3, 64, 64), version=version)
        assert got.list_arguments() == want.list_arguments()
        assert _ops(got) == _ops(want)
    assert a.list_arguments() != b.list_arguments()
    assert tmodels.get_symbol("transformer", vocab_size=10,
                              seq_len=4).list_arguments()[0] == "data"
    for name in ("lenet", "mlp", "googlenet", "inception-v4", "resnext",
                 "mobilenet", "inception_resnet_v2"):
        sym = tmodels.get_symbol(name, num_classes=10)
        assert sym.list_outputs() == ["softmax_output"], name
    with pytest.raises(ValueError, match="unknown network"):
        tmodels.get_symbol("resnet-9000")
