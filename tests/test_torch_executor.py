"""The port's ``Executor`` (``Symbol.bind``/``simple_bind`` -> ``forward``
-> ``backward``) against the JAX package's, on the CPU.

Three graphs go through both packages from the same numpy weights and
inputs: ``tests/test_executor_features.py``'s MLP, a 2-layer narrow
transformer LM (the JAX flash kernel in Pallas interpret mode, the port's
plain twin through the same autograd Functions the card uses) and a small
ResNet with BatchNorm, whose moving stats the training forward writes
back. Outputs, gradients and aux states must agree within rtol 1e-4 /
atol 1e-6 (float32; summation order differs, and the LM and ResNet
gradients sum over many more terms than the ops of the sweep).
Also: grad_req write/add/null in its three spellings, explicit
``out_grads``, a repeated ``backward()``, ``reshape``, ``get_internals``,
``infer_type``, the Monitor hook; the eager walk (``mx.nd`` node by node
under ``autograd.record()``) equal to the Executor, and the Executor's
gradients equal to ``TrainStep._grads``'s — bit for bit, since all three
run the same functions.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.models import transformer as ttransformer

from chip_smoke import eager_walk, random_params

TOL = dict(rtol=1e-4, atol=1e-6)


def _mlp(S):
    x = S.Variable("data")
    h = S.FullyConnected(x, name="fc1", num_hidden=16)
    a = S.Activation(h, name="act1", act_type="relu")
    o = S.FullyConnected(a, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(o, name="softmax")


def _mlp_case():
    rng = np.random.RandomState(0)
    params = {"fc1_weight": rng.randn(16, 10).astype(np.float32) * 0.3,
              "fc1_bias": rng.randn(16).astype(np.float32) * 0.1,
              "fc2_weight": rng.randn(4, 16).astype(np.float32) * 0.3,
              "fc2_bias": rng.randn(4).astype(np.float32) * 0.1}
    feed = {"data": rng.randn(8, 10).astype(np.float32),
            "softmax_label": rng.randint(0, 4, 8).astype(np.float32)}
    return _mlp(jmx.sym), _mlp(tmx.sym), params, {}, feed


LM_V, LM_T, LM_B = 40, 16, 2


def _lm_case():
    kw = dict(num_layers=2, num_heads=2, dim=16)
    jsym = jtransformer.get_symbol(LM_V, LM_T, **kw)
    tsym = ttransformer.get_symbol(LM_V, LM_T, **kw)
    params = random_params(tsym, (LM_B, LM_T), seed=3)
    # larger than the LM's 0.02 init, so the gradients are not all tiny
    params = {k: v * 10 if v.ndim > 1 else v for k, v in params.items()}
    rng = np.random.RandomState(4)
    toks = rng.randint(0, LM_V, (LM_B, LM_T)).astype(np.float32)
    lab = np.roll(toks, -1, axis=1)
    lab[:, -1] = -1
    return jsym, tsym, params, {}, {"data": toks, "softmax_label": lab}


RN_IMAGE = (3, 16, 16)


def _resnet_case():
    def build(pkg):
        return pkg.resnet(units=[1, 1], num_stages=2, filter_list=[4, 4, 8],
                          num_classes=5, image_shape=RN_IMAGE,
                          bottle_neck=False)
    jsym, tsym = build(jresnet), build(tresnet)
    shapes = {"data": (4,) + RN_IMAGE, "softmax_label": (4,)}
    arg_shapes, _, aux_shapes = tsym.infer_shape(**shapes)
    rng = np.random.RandomState(7)
    params = {n: (rng.randn(*s) * (0.3 if len(s) > 1 else 0.1)).astype(
        np.float32) + (1.0 if n.endswith("gamma") else 0.0)
        for n, s in zip(tsym.list_arguments(), arg_shapes)
        if n not in shapes}
    aux = {n: (rng.rand(*s).astype(np.float32) + 0.5 if n.endswith("var")
               else rng.randn(*s).astype(np.float32) * 0.1)
           for n, s in zip(tsym.list_auxiliary_states(), aux_shapes)}
    feed = {"data": rng.randn(*shapes["data"]).astype(np.float32),
            "softmax_label": rng.randint(0, 5, 4).astype(np.float32)}
    return jsym, tsym, params, aux, feed


CASES = {"mlp": _mlp_case, "lm": _lm_case, "resnet_bn": _resnet_case}


def _shapes(feed):
    return {k: v.shape for k, v in feed.items()}


def _run_jax(jsym, params, aux, feed, out_grads=None, grad_req="write"):
    exe = jsym.simple_bind(ctx=jmx.cpu(), grad_req=grad_req,
                           **_shapes(feed))
    exe.copy_params_from(params, aux)
    exe.forward(is_train=True, **feed)
    exe.backward(out_grads=out_grads)
    return exe


def _run_port(tsym, params, aux, feed, out_grads=None, grad_req="write"):
    exe = tsym.simple_bind(ctx=tmx.cpu(), grad_req=grad_req,
                           **_shapes(feed))
    exe.copy_params_from(params, aux)
    exe.forward(is_train=True, **feed)
    exe.backward(out_grads=out_grads)
    return exe


def _check_exes(jexe, texe, grads_too=True):
    for j, t in zip(jexe.outputs, texe.outputs):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    if grads_too:
        for n, jg in jexe.grad_dict.items():
            tg = texe.grad_dict[n]
            assert (jg is None) == (tg is None), n
            if jg is not None:
                np.testing.assert_allclose(tg.asnumpy(), jg.asnumpy(),
                                           err_msg=n, **TOL)
    for n, ja in jexe.aux_dict.items():
        np.testing.assert_allclose(texe.aux_dict[n].asnumpy(), ja.asnumpy(),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_simple_bind_forward_backward_matches_jax(case):
    jsym, tsym, params, aux, feed = CASES[case]()
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    jexe = _run_jax(jsym, params, aux, feed)
    texe = _run_port(tsym, params, aux, feed)
    _check_exes(jexe, texe)
    if aux:                          # the train forward wrote the aux back
        n = sorted(aux)[0]
        assert not np.array_equal(texe.aux_dict[n].asnumpy(), aux[n])
    # an inference forward moves no aux state and matches too
    before = {n: a.asnumpy() for n, a in texe.aux_dict.items()}
    jexe.forward(is_train=False)
    texe.forward(is_train=False)
    _check_exes(jexe, texe, grads_too=False)
    for n, a in texe.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), before[n])


def test_bind_with_explicit_arrays_matches_jax():
    jsym, tsym, params, _aux, feed = _mlp_case()
    args = {**params, **feed}
    jgrads = {k: jmx.nd.zeros(v.shape) for k, v in params.items()}
    with tmx.cpu():
        tgrads = {k: tmx.nd.zeros(v.shape) for k, v in params.items()}
        texe = tsym.bind(tmx.cpu(), {k: tmx.nd.array(v)
                                     for k, v in args.items()},
                         args_grad=tgrads)
    jexe = jsym.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in
                                 args.items()}, args_grad=jgrads)
    for exe in (jexe, texe):
        exe.forward(is_train=True)
        exe.backward()
    _check_exes(jexe, texe)
    # gradients land in the buffers given; args without one get none
    np.testing.assert_array_equal(tgrads["fc1_weight"].asnumpy(),
                                  texe.grad_dict["fc1_weight"].asnumpy())
    assert texe.grad_dict["data"] is None
    assert texe.output_dict.keys() == {"softmax_output"}


@pytest.mark.parametrize("spelling", ["dict", "list", "string"])
def test_grad_req_write_add_null(spelling):
    jsym, tsym, params, _aux, feed = _mlp_case()
    names = tsym.list_arguments()
    reqs = {"fc1_weight": "add", "fc1_bias": "null", "fc2_weight": "write",
            "fc2_bias": "add"}
    if spelling == "string":
        reqs = {n: "add" for n in params}
    req = {"dict": reqs, "string": "add",
           "list": [reqs.get(n, "null") for n in names]}[spelling]
    out = []
    for sym, pkg in ((jsym, jmx), (tsym, tmx)):
        exe = (_run_jax if pkg is jmx else _run_port)(sym, params, {}, feed,
                                                      grad_req=req)
        exe.forward(is_train=True, **feed)
        exe.backward()                # add: twice the gradient
        out.append({n: (g.asnumpy() if g is not None else None)
                    for n, g in exe.grad_dict.items()})
    jg, tg = out
    once = _run_port(tsym, params, {}, feed).grad_dict
    for n in params:
        if reqs.get(n, "null") == "null":
            assert tg[n] is None and jg[n] is None, n
            continue
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)
        times = 2 if reqs[n] == "add" else 1
        np.testing.assert_allclose(tg[n], times * once[n].asnumpy(),
                                   err_msg=n, **TOL)
    if spelling != "string":
        assert tg["data"] is None


def test_explicit_out_grads_match_jax():
    """A MakeLoss head over a sum: backward(out_grads=c) scales the
    gradients by c in both packages."""
    def build(S):
        x = S.Variable("data")
        h = S.Activation(S.FullyConnected(x, num_hidden=8, name="fc1"),
                         act_type="tanh")
        return S.MakeLoss(S.sum(S.FullyConnected(h, num_hidden=1,
                                                 name="fc2")))
    rng = np.random.RandomState(1)
    params = {"fc1_weight": rng.randn(8, 3).astype(np.float32),
              "fc1_bias": np.zeros(8, np.float32),
              "fc2_weight": rng.randn(1, 8).astype(np.float32),
              "fc2_bias": np.zeros(1, np.float32)}
    feed = {"data": rng.randn(4, 3).astype(np.float32)}
    cot = np.array([2.5], np.float32)
    jexe = _run_jax(build(jmx.sym), params, {}, feed,
                    out_grads=[jmx.nd.array(cot)])
    texe = _run_port(build(tmx.sym), params, {}, feed,
                     out_grads=[tmx.nd.array(cot, ctx=tmx.cpu())])
    _check_exes(jexe, texe)
    ones = _run_port(build(tmx.sym), params, {}, feed)
    np.testing.assert_allclose(texe.grad_dict["fc1_weight"].asnumpy(),
                               2.5 * ones.grad_dict["fc1_weight"].asnumpy(),
                               **TOL)


def test_backward_twice_and_without_train_forward():
    _jsym, tsym, params, _aux, feed = _mlp_case()
    exe = _run_port(tsym, params, {}, feed)
    first = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None}
    exe.backward()                      # the reference allows it
    for n, g in first.items():
        np.testing.assert_array_equal(exe.grad_dict[n].asnumpy(), g)
    exe.forward(is_train=False)         # drops the graph
    with pytest.raises(tmx.MXNetError, match="forward\\(is_train=True\\)"):
        exe.backward()


def test_reshape_matches_jax():
    jsym, tsym, params, _aux, feed = _mlp_case()
    small = {"data": feed["data"][:4], "softmax_label":
             feed["softmax_label"][:4]}
    jexe = _run_jax(jsym, params, {}, feed).reshape(data=(4, 10),
                                                    softmax_label=(4,))
    texe = _run_port(tsym, params, {}, feed).reshape(data=(4, 10),
                                                     softmax_label=(4,))
    assert texe.arg_dict["data"].shape == (4, 10)
    # the parameters are shared with the old executor
    np.testing.assert_array_equal(texe.arg_dict["fc1_weight"].asnumpy(),
                                  params["fc1_weight"])
    for exe in (jexe, texe):
        exe.forward(is_train=True, **small)
        exe.backward()
    _check_exes(jexe, texe)


def test_get_internals_and_infer_type_match_jax():
    jsym, tsym = _mlp(jmx.sym), _mlp(tmx.sym)
    ji, ti = jsym.get_internals(), tsym.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    assert ti["fc1_output"].list_outputs() == ["fc1_output"]
    assert [s.name for s in [tsym.get_children()]] == \
        [s.name for s in [jsym.get_children()]]
    assert tsym.get_children().list_outputs() == \
        jsym.get_children().list_outputs()
    assert tmx.sym.Variable("x").get_children() is None
    for kw in ({}, {"data": "float16"}):
        jt = jsym.infer_type(**kw)
        tt = tsym.infer_type(**kw)
        assert [[str(t) for t in part] for part in tt] == \
            [[str(t) for t in part] for part in jt]
    c = tmx.sym.Cast(tmx.sym.Variable("x"), dtype="int32")
    assert c.infer_type(x="float32")[1] == [np.dtype("int32")]
    # simple_bind allocates through infer_type
    exe = tsym.simple_bind(ctx=tmx.cpu(), type_dict={"data": "float16"},
                           data=(2, 10), softmax_label=(2,))
    assert exe.arg_dict["fc1_weight"].dtype == np.float16
    # an internal output binds and evaluates like the JAX one
    feat = {"data": np.random.RandomState(2).randn(2, 10).astype(
        np.float32), "fc1_weight": np.ones((16, 10), np.float32),
        "fc1_bias": np.zeros(16, np.float32)}
    jout = ji["act1_output"].eval(jmx.cpu(), **{
        k: jmx.nd.array(v) for k, v in feat.items()})[0].asnumpy()
    with tmx.cpu():
        tout = ti["act1_output"].eval(tmx.cpu(), **{
            k: tmx.nd.array(v) for k, v in feat.items()})[0].asnumpy()
    np.testing.assert_allclose(tout, jout, **TOL)
    assert "Op:FullyConnected, Name=fc1" in tsym.debug_str()


def test_monitor_callback_sees_intermediate_outputs():
    _jsym, tsym, params, _aux, feed = _mlp_case()
    exe = tsym.simple_bind(ctx=tmx.cpu(), **_shapes(feed))
    exe.copy_params_from(params)
    seen = []
    exe.set_monitor_callback(lambda name, arr: seen.append(name))
    exe.forward(is_train=True, **feed)
    assert {"fc1", "act1", "fc2", "softmax"} <= set(seen)
    assert "fc1_weight" not in seen
    seen.clear()
    exe.set_monitor_callback(lambda name, arr: seen.append(name),
                             monitor_all=True)
    exe.forward(is_train=False, **feed)
    assert "fc1_weight" in seen
    with pytest.raises(tmx.MXNetError, match="not in arguments"):
        exe.copy_params_from({"nope": np.zeros(1, np.float32)})
    exe.copy_params_from({"nope": np.zeros(1, np.float32)},
                         allow_extra_params=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_walk_equals_executor(case):
    """mx.nd node by node under autograd.record(), parameters
    attach_grad'ed, loss.backward(): the Executor's outputs, gradients
    and aux writebacks, bit for bit (the same functions in the same
    order on the CPU)."""
    _jsym, tsym, params, aux, feed = CASES[case]()
    texe = _run_port(tsym, params, aux, feed)
    with tmx.cpu():
        args = {k: tmx.nd.array(v) for k, v in {**params, **feed}.items()}
        auxs = {k: tmx.nd.array(v) for k, v in aux.items()}
        for k in params:
            args[k].attach_grad()
        with tmx.autograd.record():
            outs = eager_walk(tsym, args, auxs)
        tmx.autograd.backward(outs)
    for e, x in zip(outs, texe.outputs):
        np.testing.assert_array_equal(e.asnumpy(), x.asnumpy())
    for k in params:
        np.testing.assert_array_equal(args[k].grad.asnumpy(),
                                      texe.grad_dict[k].asnumpy(),
                                      err_msg=k)
    for k in aux:
        np.testing.assert_array_equal(auxs[k].asnumpy(),
                                      texe.aux_dict[k].asnumpy(), err_msg=k)


@pytest.mark.parametrize("case", ["lm", "resnet_bn"])
def test_executor_grads_equal_train_step_grads(case):
    """TrainStep._grads runs the Executor's forward-and-backward: the same
    gradients, outputs and aux, bit for bit."""
    from mxnet_tpu_torch.parallel import make_train_step
    _jsym, tsym, params, aux, feed = CASES[case]()
    texe = _run_port(tsym, params, aux, feed)
    step = make_train_step(tsym, optimizer="sgd", ctx=tmx.cpu())
    t = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    a = {k: torch.from_numpy(v.copy()) for k, v in aux.items()}
    outs, new_aux, grads = step._grads(t, a, step.place_batch(feed), 0)
    for o, x in zip(outs, texe.outputs):
        np.testing.assert_array_equal(o.numpy(), x.asnumpy())
    for k, g in grads.items():
        np.testing.assert_array_equal(g.numpy(),
                                      texe.grad_dict[k].asnumpy(), err_msg=k)
    for k, v in new_aux.items():
        np.testing.assert_array_equal(v.numpy(), texe.aux_dict[k].asnumpy(),
                                      err_msg=k)


def _dropout_mlp(S):
    x = S.Variable("data")
    h = S.FullyConnected(x, name="fc1", num_hidden=16)
    a = S.Activation(h, name="act1", act_type="relu")
    d = S.Dropout(a, name="drop1", p=0.4)
    o = S.FullyConnected(d, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(o, name="softmax")


@pytest.mark.parametrize("seed", [0, 21])
def test_executor_dropout_after_seed_matches_jax(seed):
    """mx.random.seed(s), then bind -> forward(is_train=True) ->
    backward twice: each forward draws its key from the global stream
    (next_key) and the Dropout node folds its uid into it, so both
    forwards' masks, outputs and gradients are the JAX package's; an
    inference forward drops nothing."""
    _j, _t, params, _aux, feed = _mlp_case()
    jsym, tsym = _dropout_mlp(jmx.sym), _dropout_mlp(tmx.sym)
    jmx.random.seed(seed)
    tmx.random.seed(seed)
    jexe = jsym.simple_bind(ctx=jmx.cpu(), **_shapes(feed))
    texe = tsym.simple_bind(ctx=tmx.cpu(), **_shapes(feed))
    for exe in (jexe, texe):
        exe.copy_params_from(params, {})
    captured = []
    for _ in range(2):
        seen = {}
        texe.set_monitor_callback(
            lambda name, arr: seen.setdefault(name, arr.asnumpy()))
        for exe in (jexe, texe):
            exe.forward(is_train=True, **feed)
            exe.backward()
        _check_exes(jexe, texe)
        captured.append(seen["drop1"])
    masks = [c != 0 for c in captured]
    assert not np.array_equal(masks[0], masks[1])
    jexe.forward(is_train=False)
    texe.forward(is_train=False)
    _check_exes(jexe, texe, grads_too=False)
    # the stream advanced alike in both packages
    np.testing.assert_array_equal(tmx.random.next_key(),
                                  np.asarray(jmx.random.next_key()))
