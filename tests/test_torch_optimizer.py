"""The port's ``optimizer.py`` and ``lr_scheduler.py`` against the JAX
package's, on the CPU, and the multi-tensor update's plain versions
against the registry's per-parameter update ops.

Every optimizer runs through ``Updater`` for four steps from the same
numpy weights and gradients in both packages (two parameters, one with
weight decay by its ``_weight`` name, one a bias without): weights and
states within rtol 1e-5 / atol 5e-6 (float32). The port rounds every
operation of a fused update op on its own, as eager JAX does; the JAX
package's ops run jitted, and XLA's CPU fusion contracts ``a * b + c``
into FMAs (``adam_update`` jitted differs from eager JAX in 5-29% of
elements by an ulp), so over four steps a weight near 0 moves apart by
about 1e-6; LAMB's norms also sum in another order. SGLD
draws its noise from ``mx.random.next_key()`` in both packages after the
same ``mx.random.seed``: the threefry normal, within a few ulps (ROADMAP
Queue C item 6), so it is held to the same tolerance. The schedulers
return the same floats exactly over 0..300 updates. The plain versions
of the multi-tensor kernels equal the registry ops applied parameter by
parameter bit for bit, and keep every bit under a false finite flag.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import optimizer_kernels as tmt
from mxnet_tpu_torch.ops.registry import get_op

TOL = dict(rtol=1e-5, atol=5e-6)
IDX2NAME = {0: "fc_weight", 1: "fc_bias"}

# (id, registry name, constructor kwargs)
OPTIMIZERS = [
    ("sgd", "sgd", {}),
    ("sgd_momentum", "sgd", {"momentum": 0.9}),
    ("signum", "signum", {}),
    ("signsgd", "signum", {"momentum": 0.0}),
    ("dcasgd", "dcasgd", {"momentum": 0.9}),
    ("dcasgd_plain", "dcasgd", {}),
    ("nag", "nag", {"momentum": 0.9}),
    ("sgld", "sgld", {}),
    ("ccsgd", "ccsgd", {"momentum": 0.5}),
    ("adam", "adam", {}),
    ("adagrad", "adagrad", {}),
    ("rmsprop", "rmsprop", {}),
    ("rmsprop_centered", "rmsprop", {"centered": True,
                                     "clip_weights": 2.0}),
    ("adadelta", "adadelta", {}),
    ("ftrl", "ftrl", {}),
    ("adamax", "adamax", {}),
    ("nadam", "nadam", {}),
    ("lamb", "lamb", {}),
    ("test", "test", {}),
]


def _values(x):
    """An NDArray (or a state tuple of them) of either package as numpy."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return [_values(v) for v in x]
    return np.asarray(x.asnumpy(), np.float32)


def _run(mx, opt_mod, name, kwargs, common, steps, shapes, seed, ctx=None):
    rng = np.random.RandomState(seed)
    weights = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    mx.random.seed(5)
    o = opt_mod.create(name, param_idx2name=dict(IDX2NAME), **common,
                       **kwargs)
    up = opt_mod.get_updater(o)
    ws = [mx.nd.array(w, ctx=ctx) for w in weights]
    for step in grads:
        for i, (w, g) in enumerate(zip(ws, step)):
            up(i, mx.nd.array(g, ctx=ctx), w)
    return [_values(w) for w in ws], [_values(up.states[i])
                                      for i in range(len(ws))]


@pytest.mark.parametrize("name,kwargs", [c[1:] for c in OPTIMIZERS],
                         ids=[c[0] for c in OPTIMIZERS])
@pytest.mark.parametrize("common", [
    {"learning_rate": 0.05, "wd": 1e-2, "rescale_grad": 0.5},
    {"learning_rate": 0.05, "clip_gradient": 0.3},
], ids=["wd_rescale", "clip"])
def test_every_optimizer_matches_jax(name, kwargs, common):
    shapes = [(6, 5), (5,)]
    jw, js = _run(jmx, jopt, name, kwargs, common, 4, shapes, seed=1)
    tw, ts = _run(tmx, topt, name, kwargs, common, 4, shapes, seed=1,
                  ctx=tmx.cpu())
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, **TOL)

    def flat(s):
        if s is None:
            return []
        if isinstance(s, list):
            return [x for v in s for x in flat(v)]
        return [s]
    for a, b in zip(ts, js):
        fa, fb = flat(a), flat(b)
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            np.testing.assert_allclose(x, y, **TOL)


def test_registry_and_create():
    assert set(jopt.Optimizer.opt_registry) <= set(
        topt.Optimizer.opt_registry)
    o = topt.create("Adam", learning_rate=0.1)
    assert isinstance(o, topt.Adam) and o.lr == 0.1
    with pytest.raises(ValueError, match="no optimizer"):
        topt.create("nope")


def test_lr_wd_mult_and_symbol_attrs():
    """lr_mult by name, wd_mult 0 for names not ending in _weight/_gamma,
    and ``__lr_mult__`` / ``__wd_mult__`` symbol attributes, as the JAX
    package resolves them."""
    def run(mx, opt_mod, ctx=None):
        data = mx.sym.Variable("data")
        w = mx.sym.Variable("fc_weight", attr={"__lr_mult__": "0.5"})
        b = mx.sym.Variable("fc_bias", attr={"__wd_mult__": "2"})
        sym = mx.sym.FullyConnected(data, weight=w, bias=b, num_hidden=3,
                                    name="fc")
        o = opt_mod.SGD(learning_rate=1.0, wd=0.1, sym=sym,
                        param_idx2name={0: "fc_weight", 1: "fc_bias",
                                        2: "other"})
        o.set_lr_mult({"other": 0.0})
        out = []
        for i, shape in enumerate([(3, 4), (3,), (2,)]):
            arr = mx.nd.ones(shape, ctx=ctx)
            o.update(i, arr, mx.nd.ones(shape, ctx=ctx),
                     o.create_state(i, arr))
            out.append(arr.asnumpy())
        return out, (o._get_lr(0), o._get_wd(0), o._get_lr(1),
                     o._get_wd(1), o._get_wd(2))
    jo, jk = run(jmx, jopt)
    to, tk = run(tmx, topt, tmx.cpu())
    assert jk == tk
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **TOL)


def test_updater_states_roundtrip_and_multi_precision():
    with tmx.cpu():
        u = topt.get_updater(topt.SGD(momentum=0.9, learning_rate=0.1))
        w = tmx.nd.ones((3,))
        u(0, tmx.nd.ones((3,)), w)
        blob = u.get_states(dump_optimizer=True)
        u2 = topt.get_updater(topt.SGD(momentum=0.9, learning_rate=0.1))
        u2.set_states(blob)
        assert isinstance(u2.optimizer, topt.SGD)
        w2 = w.copy()
        u(0, tmx.nd.ones((3,)), w)
        u2(0, tmx.nd.ones((3,)), w2)
        np.testing.assert_array_equal(w.asnumpy(), w2.asnumpy())
        # float16 weights keep a float32 master copy under multi_precision
        o = topt.SGD(momentum=0.9, learning_rate=0.1, multi_precision=True)
        w16 = tmx.nd.array(np.ones(4, np.float16), dtype="float16")
        state = o.create_state_multi_precision(0, w16)
        assert state[1].dtype == np.float32
        o.update_multi_precision(0, w16, tmx.nd.array(
            np.ones(4, np.float16), dtype="float16"), state)
        assert w16.dtype == np.float16
        np.testing.assert_allclose(w16.asnumpy(), 0.9, rtol=1e-3)
        assert pickle.loads(pickle.dumps(o)).momentum == 0.9


def test_optimizer_state_follows_the_weight_device():
    o = topt.Adam()
    with tmx.cpu():
        w = tmx.nd.ones((2, 2))
    mean, var = o.create_state(0, w)
    assert mean.context == w.context and var.context == w.context


# ---------------------------------------------------------------------------
# lr schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = [
    ("factor", lambda m: m.FactorScheduler(step=10, factor=0.5,
                                           stop_factor_lr=1e-3), 1.0),
    ("multifactor", lambda m: m.MultiFactorScheduler(step=[5, 15, 40],
                                                     factor=0.1), 0.3),
    ("poly", lambda m: m.PolyScheduler(max_update=100, base_lr=0.1,
                                       pwr=2), None),
    ("cosine", lambda m: m.CosineScheduler(max_update=120, base_lr=0.1,
                                           final_lr=1e-3, warmup_steps=10,
                                           warmup_begin_lr=0.01), None),
]


@pytest.mark.parametrize("make,base", [s[1:] for s in SCHEDULERS],
                         ids=[s[0] for s in SCHEDULERS])
def test_scheduler_matches_jax_exactly(make, base):
    js, ts = make(jls), make(tls)
    if base is not None:
        js.base_lr = ts.base_lr = base
    got = [ts(n) for n in range(301)]
    want = [js(n) for n in range(301)]
    assert got == want
    # closed form: the same value out of order (a resumed run)
    assert [ts(n) for n in (250, 3, 77)] == [want[250], want[3], want[77]]


def test_scheduler_argument_checks():
    with pytest.raises(ValueError):
        tls.FactorScheduler(step=0)
    with pytest.raises(ValueError):
        tls.MultiFactorScheduler(step=[5, 3])
    with pytest.raises(ValueError):
        tls.PolyScheduler(max_update=0)
    o = topt.SGD(learning_rate=0.2, lr_scheduler=tls.FactorScheduler(
        step=2, factor=0.5))
    assert o.lr_scheduler.base_lr == 0.2
    with pytest.raises(UserWarning):
        o.set_learning_rate(0.1)


# ---------------------------------------------------------------------------
# the multi-tensor kernels' plain versions
# ---------------------------------------------------------------------------

UPDATE_OPS = [
    ("adam_update", {"wd": 1e-2, "clip_gradient": 0.4,
                     "rescale_grad": 0.25}),
    ("sgd_mom_update", {"momentum": 0.9, "wd": 1e-4}),
    ("sgd_mom_update", {}),
    ("rmsprop_update", {"gamma1": 0.9}),
    ("ftrl_update", {"lamda1": 0.02}),
    ("signsgd_update", {"wd": 1e-3}),
]


def _operands(op, sizes, seed=0):
    rng = np.random.RandomState(seed)
    n_state = get_op(op).num_state
    ws = [torch.from_numpy(rng.randn(n).astype(np.float32)) for n in sizes]
    gs = [torch.from_numpy(rng.randn(n).astype(np.float32) * 3)
          for n in sizes]
    ss = [tuple(torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32))
                for _ in range(n_state)) for n in sizes]
    return ws, gs, ss


def _bits(t):
    return t.detach().numpy().view(np.int32)


@pytest.mark.parametrize("op,attrs", UPDATE_OPS,
                         ids=["%s_%d" % (o, i) for i, (o, _)
                              in enumerate(UPDATE_OPS)])
@pytest.mark.parametrize("donate", [True, False])
def test_plain_update_equals_registry_ops(op, attrs, donate):
    """``opt_update`` on CPU tensors (the multi-tensor kernel's plain
    version) is the registry op applied parameter by parameter, bit for
    bit, after the gradient's unscale and clip; a false flag keeps every
    bit; ``donate`` decides whether the given tensors are written."""
    sizes = (1, 1000, 37)
    ws, gs, ss = _operands(op, sizes)
    want = []
    inv = torch.tensor(0.5)
    gscale = torch.tensor(0.8125)
    for w, g, s in zip(ws, gs, ss):
        gg = ((g * inv) * gscale)
        res = get_op(op).fn(w.clone(), gg, *[x.clone() for x in s],
                            lr=0.03, **attrs)
        want.append(res if isinstance(res, tuple) else (res,))
    before = [(w.clone(), tuple(x.clone() for x in s))
              for w, s in zip(ws, ss)]
    nw, ns = tmt.opt_update(op, ws, gs, ss, 0.03, attrs,
                            flag=torch.tensor(True), gscale=gscale,
                            inv_scale=inv, donate=donate)
    for i, res in enumerate(want):
        assert np.array_equal(_bits(nw[i]), _bits(res[0]))
        for a, b in zip(ns[i], res[1:]):
            assert np.array_equal(_bits(a), _bits(b))
        assert (nw[i] is ws[i]) == donate
        if not donate:
            assert torch.equal(ws[i], before[i][0])
    # a false flag: nothing moves
    ws, gs, ss = _operands(op, sizes, seed=3)
    before = [(w.clone(), tuple(x.clone() for x in s))
              for w, s in zip(ws, ss)]
    gs[0][0] = float("nan")
    nw, ns = tmt.opt_update(op, ws, gs, ss, 0.03, attrs,
                            flag=torch.tensor(False), donate=donate)
    for i, (w0, s0) in enumerate(before):
        assert np.array_equal(_bits(nw[i]), _bits(w0))
        for a, b in zip(ns[i], s0):
            assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("plant", [None, "nan", "inf", "out_inf",
                                   "inject"])
def test_plain_norm_finite(plant):
    """``norm_finite`` on CPU tensors: the sum of squares of the unscaled
    gradients within 1e-6 of a float64 sum, the flag false exactly when a
    NaN or Inf is planted (or the nan@N multiplier injected), and the
    clip scale min(1, clip / max(rescale * norm, 1e-12))."""
    rng = np.random.RandomState(4)
    grads = [rng.randn(n).astype(np.float32) for n in (1, 5000, 33)]
    outs = [rng.rand(16, 9).astype(np.float32)]
    if plant in ("nan", "inf"):
        grads[1][7] = np.nan if plant == "nan" else np.inf
    if plant == "out_inf":
        outs[0][3, 3] = -np.inf
    inject = float("nan") if plant == "inject" else 1.0
    s, ok, gs = tmt.norm_finite(
        [torch.from_numpy(g) for g in grads],
        [torch.from_numpy(o).to(torch.bfloat16) for o in outs],
        inject=inject, inv_scale=torch.tensor(0.25), rescale=0.5,
        clip_norm=1.0)
    assert bool(ok) == (plant is None)
    if plant is None:
        want = sum(float(np.sum((g.astype(np.float64) * 0.25) ** 2))
                   for g in grads)
        assert float(s) == pytest.approx(want, rel=1e-6)
        clip = min(1.0, 1.0 / max(0.5 * np.sqrt(want), 1e-12))
        assert float(gs) == pytest.approx(clip, rel=1e-6)
    s, ok, gs = tmt.norm_finite([torch.zeros(3)], clip_norm=None)
    assert float(s) == 0.0 and bool(ok) and float(gs) == 1.0
