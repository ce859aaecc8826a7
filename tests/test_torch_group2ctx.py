"""``Executor(group2ctx=...)`` of the PyTorch port against the JAX package
(after tests/test_executor_features.py's ``__shard__`` cases).

A group's spec value under a mesh is read as the same ``__shard__``
attribute on the group's nodes (validated on each output's global
shape: an axis the mesh lacks raises); a Context value (the reference's
device placement) changes nothing, as in the JAX package, which has no
single-program analogue either. ``Symbol.bind``, ``simple_bind`` and
``Executor.reshape`` carry ``group2ctx``. Outputs and gradients equal
the JAX Executor's within TOL from the same weights.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)


def _net(mx, attr=None):
    """fc1 -> relu inside ctx_group 'dev1' (or with ``attr`` set on
    those nodes), then fc2 -> softmax."""
    x = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="dev1"):
        h = mx.sym.FullyConnected(x, name="fc1", num_hidden=8)
        a = mx.sym.Activation(h, name="act1", act_type="relu")
    if attr:
        h._set_attr(**attr)
        a._set_attr(**attr)
    o = mx.sym.FullyConnected(a, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(o, name="softmax")


def _weights(sym):
    shapes, _, _ = sym.infer_shape(data=(4, 10), softmax_label=(4,))
    rng = np.random.RandomState(5)
    vals = {n: rng.randn(*s).astype(np.float32) * 0.5
            for n, s in zip(sym.list_arguments(), shapes)}
    vals["softmax_label"] = np.array([0, 3, 1, 2], np.float32)
    return vals


def _run(mx, sym, group2ctx=None, mesh=None, bind="bind"):
    vals = _weights(sym)
    with mx.cpu():
        if bind == "simple_bind":
            ex = sym.simple_bind(mx.cpu(), data=(4, 10),
                                 softmax_label=(4,), group2ctx=group2ctx)
            for n, v in vals.items():
                ex.arg_dict[n][:] = v
        elif mesh is not None:
            ex = mx.executor.Executor(
                sym, mx.cpu(), args={n: mx.nd.array(v)
                                     for n, v in vals.items()},
                group2ctx=group2ctx, mesh=mesh)
        else:
            ex = sym.bind(mx.cpu(), {n: mx.nd.array(v)
                                     for n, v in vals.items()},
                          group2ctx=group2ctx)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()
                 if g is not None}
    return ex, out, grads


def _close(a, b):
    np.testing.assert_allclose(a[1], b[1], **TOL)
    for n in b[2]:
        np.testing.assert_allclose(a[2][n], b[2][n], err_msg=n, **TOL)


@pytest.mark.parametrize("bind", ["bind", "simple_bind"])
def test_context_values_change_nothing(bind):
    plain = _run(tmx, _net(tmx), bind=bind)
    placed = _run(tmx, _net(tmx), {"dev1": tmx.cpu(1), "dev2": tmx.gpu(3)},
                  bind=bind)
    assert placed[0]._group2ctx["dev1"] == tmx.cpu(1)
    np.testing.assert_array_equal(placed[1], plain[1])
    for n in plain[2]:
        np.testing.assert_array_equal(placed[2][n], plain[2][n])
    _close(placed, _run(jmx, _net(jmx), {"dev1": jmx.cpu(1)}, bind=bind))
    with tmx.cpu():
        re = placed[0].reshape(data=(6, 10), softmax_label=(6,))
    assert re._group2ctx == placed[0]._group2ctx
    assert tuple(re.arg_dict["data"].shape) == (6, 10)


def test_spec_values_read_as_shard_attributes():
    """Under a mesh, group2ctx={'dev1': spec} equals the same
    ``__shard__`` on the group's nodes: the same outputs, and an axis
    the mesh lacks raises the same error."""
    from jax.sharding import Mesh
    import jax
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 1, "model": 1})
    by_group = _run(tmx, _net(tmx), {"dev1": "None,model"}, mesh=mesh)
    by_attr = _run(tmx, _net(tmx, {"__shard__": "None,model"}), mesh=mesh)
    plain = _run(tmx, _net(tmx))
    for got in (by_group, by_attr):
        np.testing.assert_array_equal(got[1], plain[1])
        for n in plain[2]:
            np.testing.assert_array_equal(got[2][n], plain[2][n])
    for bad in ({"group2ctx": {"dev1": "None,bogus"}},
                {"attr": {"__shard__": "None,bogus"}}):
        sym = _net(tmx, bad.get("attr"))
        with pytest.raises(MXNetError, match="not in mesh axes"):
            _run(tmx, sym, bad.get("group2ctx"), mesh=mesh)
    # the JAX package's constraint over two devices changes no number
    jmesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                 ("data", "model"))
    _close(by_group, _run(jmx, _net(jmx), {"dev1": "None,model"},
                          mesh=jmesh))
