"""Testing helpers — the PyTorch twin of ``mxnet_tpu/test_utils.py``
(reference python/mxnet/test_utils.py): assert_almost_equal, numeric
gradient checking, random arrays (dense, row-sparse and csr), the
symbolic forward/backward checks and the device consistency check.

``check_consistency`` is the reference's CPU-vs-GPU check: the function
run on its inputs as given (on the card, say), then again on CPU copies
of them (and in each of ``dtypes``), the outputs held to the first run.
"""
from __future__ import annotations

import numpy as np
import torch

from .ndarray.ndarray import NDArray, array

_rng = np.random.RandomState(0)


def default_context():
    from .context import current_context
    return current_context()


def set_default_context(ctx):
    from .context import Context
    Context._default_ctx.value = ctx


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg="%s vs %s" % names)


def almost_equal(a, b, rtol=1e-5, atol=1e-20):
    return np.allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def rand_ndarray(shape, stype="default", density=None, dtype=np.float32):
    """Uniform(-1, 1) draws of ``_rng``; a sparse ``stype`` keeps each
    row with probability ``density`` (one more draw a row), as the JAX
    package draws them."""
    data = _rng.uniform(-1, 1, size=shape).astype(dtype)
    if stype == "default":
        return array(data)
    if density is not None:
        mask = _rng.uniform(0, 1, size=(shape[0],) + (1,) * (len(shape) - 1))
        data = np.where(mask < density, data, 0).astype(dtype)
    from .ndarray import sparse
    if stype == "row_sparse":
        return sparse.row_sparse_array(data)
    if stype == "csr":
        return sparse.csr_matrix(data)
    raise ValueError(stype)


def rand_shape_2d(dim0=10, dim1=10):
    return (_rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1))


def rand_shape_nd(ndim, dim=10):
    return tuple(_rng.randint(1, dim + 1, size=ndim))


def check_numeric_gradient(f, inputs, grads=None, eps=1e-3, rtol=1e-2,
                           atol=1e-4):
    """Finite-difference check of an eager differentiable function.

    f: callable(list of NDArray) -> scalar-able NDArray (loss)
    inputs: list of NDArray leaves (will have grads attached)
    """
    from . import autograd

    for x in inputs:
        x.attach_grad()
    with autograd.record():
        out = f(inputs)
        out.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]

    for xi, x in enumerate(inputs):
        base_np = np.ascontiguousarray(x.asnumpy(), dtype=np.float64)
        num = np.zeros_like(base_np)
        device = x._data.device

        def put(values):
            x._set_data(torch.from_numpy(values.astype(np.float32)).to(
                device))
        for idx in np.ndindex(*base_np.shape):
            orig = base_np[idx]
            base_np[idx] = orig + eps
            put(base_np)
            fp = float(f(inputs).asnumpy().sum())
            base_np[idx] = orig - eps
            put(base_np)
            fm = float(f(inputs).asnumpy().sum())
            base_np[idx] = orig
            put(base_np)
            num[idx] = (fp - fm) / (2 * eps)
        np.testing.assert_allclose(analytic[xi], num, rtol=rtol, atol=atol,
                                   err_msg="gradient mismatch for input %d"
                                   % xi)


# default tolerance per compute dtype for the consistency grid (the
# reference's ctx_list matrix keyed tolerances by dtype)
_DTYPE_RTOL = {"float64": 1e-6, "float32": 1e-5, "bfloat16": 4e-2,
               "float16": 1e-2}


def check_consistency(fn, inputs, rtol=1e-4, atol=1e-6, dtypes=None):
    """The reference's CPU-vs-GPU consistency check: ``fn(*inputs)`` as
    given is the baseline; ``fn`` run again on CPU copies of the inputs
    must match it within rtol/atol, and with float inputs cast to each
    of ``dtypes`` within that dtype's tolerance. Returns the baseline
    output."""
    from .context import cpu
    eager = fn(*inputs)
    base = _np(eager)

    def on_cpu(x, dt=None):
        if not isinstance(x, NDArray):
            return x
        y = x.as_in_context(cpu())
        if dt is not None and y._data.is_floating_point():
            y = y.astype(dt)
        return y

    np.testing.assert_allclose(
        base, _np(fn(*[on_cpu(x) for x in inputs])),
        rtol=rtol, atol=atol, err_msg="inconsistent on the CPU")
    for dname in dtypes or ():
        out = fn(*[on_cpu(x, dname) for x in inputs])
        tol = _DTYPE_RTOL.get(dname, 1e-2)
        np.testing.assert_allclose(
            base.astype(np.float64), _np(out).astype(np.float64),
            rtol=tol, atol=max(atol, tol),
            err_msg="inconsistent vs %s baseline at dtype %s"
                    % (base.dtype, dname))
    return eager


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    ctx = ctx or default_context()
    arrays = {k: v if isinstance(v, NDArray) else array(v, ctx=ctx)
              for k, v in inputs.items()}
    exe = sym.bind(ctx, arrays)
    outs = [o.asnumpy() for o in exe.forward(is_train=is_train)]
    return outs[0] if len(outs) == 1 else outs


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-5,
                           aux_states=None, ctx=None):
    """Bind ``sym`` with ``location`` (list or dict of arrays) and check
    each output against ``expected`` (reference
    test_utils.py:check_symbolic_forward)."""
    ctx = ctx or default_context()
    args = _as_arg_dict(sym, location, ctx)
    exe = sym.bind(ctx, args,
                   aux_states={k: array(v, ctx=ctx) for k, v in
                               (aux_states or {}).items()})
    outs = exe.forward(is_train=False)
    expected = expected if isinstance(expected, (list, tuple)) \
        else [expected]
    if len(outs) != len(expected):
        raise AssertionError("symbol has %d outputs, %d expectations given"
                             % (len(outs), len(expected)))
    for o, e in zip(outs, expected):
        np.testing.assert_allclose(o.asnumpy(), np.asarray(e),
                                   rtol=rtol, atol=atol)
    return [o.asnumpy() for o in outs]


def check_symbolic_backward(sym, location, out_grads, expected,
                            rtol=1e-4, atol=1e-5, grad_req="write",
                            aux_states=None, ctx=None):
    """Bind, run forward and backward with ``out_grads`` as head
    gradients, check the input gradients named in ``expected``
    (reference test_utils.py:check_symbolic_backward)."""
    ctx = ctx or default_context()
    args = _as_arg_dict(sym, location, ctx)
    grad_arrays = {k: array(np.zeros_like(v.asnumpy()), ctx=ctx)
                   for k, v in args.items()}
    exe = sym.bind(ctx, args, args_grad=grad_arrays, grad_req=grad_req,
                   aux_states={k: array(v, ctx=ctx) for k, v in
                               (aux_states or {}).items()})
    exe.forward(is_train=True)
    ogs = [g if isinstance(g, NDArray) else array(g, ctx=ctx)
           for g in (out_grads if isinstance(out_grads, (list, tuple))
                     else [out_grads])]
    exe.backward(ogs)
    if isinstance(expected, dict):
        items = expected.items()
    else:
        names = sym.list_arguments()
        if len(expected) != len(names):
            raise AssertionError("%d expected grads for %d arguments"
                                 % (len(expected), len(names)))
        items = zip(names, expected)
    for name, e in items:
        if e is None:
            continue
        np.testing.assert_allclose(
            exe.grad_dict[name].asnumpy(), np.asarray(e),
            rtol=rtol, atol=atol, err_msg="grad of %s" % name)
    return {k: v.asnumpy() for k, v in exe.grad_dict.items()}


def _as_arg_dict(sym, location, ctx):
    if isinstance(location, dict):
        items = location.items()
    else:
        items = zip(sym.list_arguments(), location)
    return {k: v if isinstance(v, NDArray) else array(v, ctx=ctx)
            for k, v in items}


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))
