"""``mx.operator`` and the ``Custom`` op in the port against the JAX
package, on the CPU — the cases of ``tests/test_custom_op.py`` (the
reference's numpy-ops softmax and a scale op), run through both packages
from the same numpy inputs:

* eager forward, backward through ``autograd.record()``, a Custom op
  chained with native ops, keyword inputs in ``list_arguments`` order:
  outputs and gradients within rtol 1e-6 / atol 1e-7 (the user's numpy
  code is the same arithmetic in both);
* symbolic: the label auto-created and its shape inferred, an Executor
  forward, one Module step (parameters within rtol 1e-6 / atol 1e-7) and
  Module.fit to the accuracy gate;
* the registry's refusals (unknown type, auxiliary states), an error in
  the user's forward naming the op type, one CustomOp made a (prop,
  shapes, dtypes, device) and kept, a two-output op whose unused output
  sends a zero gradient;
* a graph with a Custom node refused by every export that a CUDA graph
  would capture (TrainStep.export, Predictor.export and export_buckets),
  the error naming the node.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import custom as tcustom
from mxnet_tpu_torch.parallel import make_train_step

TOL = dict(rtol=1e-6, atol=1e-7)


def _register(mx):
    """The test props of tests/test_custom_op.py, plus a two-output split
    and a failing op, registered in ``mx``."""
    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lbl = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy()
            y[np.arange(lbl.shape[0]), lbl] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y / y.shape[0]))

    @mx.operator.register("t_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return ([in_shape[0], (in_shape[0][0],)], [in_shape[0]], [])

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Scale(mx.operator.CustomOp):
        def __init__(self, factor):
            self.factor = factor

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * self.factor)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self.factor)

    @mx.operator.register("t_scale")
    class ScaleProp(mx.operator.CustomOpProp):
        def __init__(self, factor="2.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, shapes, dtypes):
            return Scale(self.factor)

    class Split(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], mx.nd.array(x * 2))
            self.assign(out_data[1], req[1], mx.nd.array(x + 1))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            g = out_grad[0].asnumpy() * 2 + out_grad[1].asnumpy()
            self.assign(in_grad[0], req[0], mx.nd.array(g))

    @mx.operator.register("t_split")
    class SplitProp(mx.operator.CustomOpProp):
        def list_outputs(self):
            return ["twice", "plus_one"]

        def create_operator(self, ctx, shapes, dtypes):
            return Split()

    class Boom(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            raise ValueError("no forward here")

    @mx.operator.register("t_boom")
    class BoomProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Boom()


_register(jmx)
_register(tmx)


def _x(seed=0, shape=(4, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LABEL = np.array([0, 1, 2, 0], np.float32)


def _eager(mx, nd_of, case):
    """One eager case in package ``mx``: (outputs, gradients) as numpy."""
    x = nd_of(_x(1, (5,)) if case == "chain" else _x())
    lbl = nd_of(LABEL)
    x.attach_grad()
    with mx.autograd.record():
        if case == "forward_backward":
            y = mx.nd.Custom(x, lbl, op_type="t_softmax")
            head = y
        elif case == "kwargs":
            y = mx.nd.Custom(label=lbl, data=x, op_type="t_softmax")
            head = y
        elif case == "chain":
            y = mx.nd.Custom(x, op_type="t_scale", factor="3.0")
            head = (y * y).sum()
        else:                                # split
            a, b = mx.nd.Custom(x, op_type="t_split")
            y = a
            head = a.sum() * 3
    head.backward()
    return np.asarray(y.asnumpy()), np.asarray(x.grad.asnumpy())


@pytest.mark.parametrize("case", ["forward_backward", "kwargs", "chain",
                                  "split"])
def test_eager_custom_matches_jax(case):
    jy, jg = _eager(jmx, jmx.nd.array, case)
    with tmx.cpu():
        ty, tg = _eager(tmx, tmx.nd.array, case)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    if case == "forward_backward":
        np.testing.assert_allclose(ty.sum(1), np.ones(4), rtol=1e-5)
        np.testing.assert_allclose(tg.sum(1), np.zeros(4), atol=1e-6)
    if case == "chain":
        np.testing.assert_allclose(tg, 2 * 9 * _x(1, (5,)), rtol=1e-5)
    if case == "split":                      # plus_one's gradient is 0
        np.testing.assert_allclose(tg, np.full((4, 3), 6.0))


def test_symbolic_label_and_shapes():
    for mx in (jmx, tmx):
        net = mx.sym.Custom(data=mx.sym.Variable("data"), name="sm",
                            op_type="t_softmax")
        assert net.list_arguments() == ["data", "sm_label"]
        args, outs, _ = net.infer_shape(data=(4, 3))
        assert [tuple(a) for a in args] == [(4, 3), (4,)]
        assert [tuple(o) for o in outs] == [(4, 3)]
        pos = mx.sym.Custom(mx.sym.Variable("data"), name="sm",
                            op_type="t_softmax")
        assert pos.list_arguments() == ["data", "sm_label"]
        split = mx.sym.Custom(mx.sym.Variable("data"), op_type="t_split")
        assert len(split.list_outputs()) == 2


def test_executor_forward_matches_jax():
    outs = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": tmx.cpu()})):
        net = mx.sym.Custom(data=mx.sym.Variable("data"), name="sm",
                            op_type="t_softmax")
        ex = net.simple_bind(data=(4, 3), **kw)
        outs.append(np.asarray(ex.forward(data=_x(), sm_label=LABEL)[0]
                               .asnumpy()))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def _mlp(mx):
    fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                               name="fc")
    return mx.sym.Custom(data=fc, name="softmax", op_type="t_softmax")


def test_module_step_matches_jax():
    X = _x(2, (8, 6))
    Y = (X[:, 0] > 0).astype(np.float32)
    w = _x(3, (2, 6)) * 0.3
    res = []
    for mx, kw, of in ((jmx, {}, jmx.nd.array),
                       (tmx, {"context": tmx.cpu()},
                        lambda v: tmx.nd.array(v, ctx=tmx.cpu()))):
        mod = mx.mod.Module(_mlp(mx), ("data",), ("softmax_label",), **kw)
        mod.bind(data_shapes=[("data", X.shape)],
                 label_shapes=[("softmax_label", Y.shape)])
        mod.init_params(arg_params={"fc_weight": of(w),
                                    "fc_bias": of(np.zeros(2, np.float32))})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        mod.forward(mx.io.DataBatch([of(X)], [of(Y)]), is_train=True)
        mod.backward()
        mod.update()
        res.append({k: np.asarray(v.asnumpy())
                    for k, v in mod.get_params()[0].items()})
    for k in res[0]:
        np.testing.assert_allclose(res[1][k], res[0][k], **TOL)


def test_module_fit_learns():
    """tests/test_custom_op.py's accuracy gate, on the port."""
    np.random.seed(0)
    tmx.random.seed(0)
    X = np.random.randn(128, 8).astype("float32")
    ylab = (X @ np.random.randn(8) > 0).astype("float32")
    with tmx.cpu():
        train = tmx.io.NDArrayIter(X, ylab, batch_size=32, shuffle=True,
                                   label_name="softmax_label")
        mod = tmx.mod.Module(_mlp(tmx), ("data",), ("softmax_label",),
                             context=tmx.cpu())
        mod.fit(train, num_epoch=6, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5})
        assert mod.score(train, "acc")[0][1] > 0.9


def test_registry_refusals_and_listing():
    with tmx.cpu():
        with pytest.raises(KeyError):
            tmx.nd.Custom(tmx.nd.zeros((2,)), op_type="no_such_op")

        @tmx.operator.register("t_auxful")
        class AuxProp(tmx.operator.CustomOpProp):
            def list_auxiliary_states(self):
                return ["counter"]

            def infer_shape(self, in_shape):
                return [in_shape[0]], [in_shape[0]], [(1,)]

        with pytest.raises(NotImplementedError):
            tmx.nd.Custom(tmx.nd.zeros((2,)), op_type="t_auxful")
    assert {"t_softmax", "t_scale", "t_split"} <= set(
        tmx.operator.get_all_registered())


def test_forward_error_names_the_op_type():
    with tmx.cpu():
        with pytest.raises(MXNetError, match="t_boom.*no forward here"):
            tmx.nd.Custom(tmx.nd.zeros((2, 3)), op_type="t_boom")


def test_one_operator_per_shape_and_device():
    made = []

    class Count(tmx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0])

    @tmx.operator.register("t_count")
    class CountProp(tmx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            made.append((str(ctx), tuple(map(tuple, shapes))))
            return Count()

    with tmx.cpu():
        for shape in ((2, 3), (2, 3), (4,), (2, 3)):
            tmx.nd.Custom(tmx.nd.zeros(shape), op_type="t_count")
    assert made == [("cpu(0)", ((2, 3),)), ("cpu(0)", ((4,),))]
    assert tcustom.create_prop("t_count", {}) is \
        tcustom.create_prop("t_count", {})


def test_captures_refuse_custom_nodes(tmp_path):
    sym = _mlp(tmx)
    params = {"fc_weight": torch.zeros(2, 6), "fc_bias": torch.zeros(2)}
    step = make_train_step(sym, optimizer="sgd", ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="'softmax'.*t_softmax"):
        step.export(str(tmp_path / "step"), None, None)
    pred = tmx.Predictor(sym, params, data_names=("data",), ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="Predictor.export.*'softmax'"):
        pred.export(str(tmp_path / "fwd"), {"data": (2, 6)})
    with pytest.raises(MXNetError, match="'softmax'"):
        pred.export_buckets(str(tmp_path / "srv"), [(6,)], buckets=[1, 2])
