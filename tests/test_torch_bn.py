"""The port's BatchNorm against the JAX package's, on the CPU.

* The four kernels' plain versions (``ops/bn_kernels.py``) against the
  JAX package's Pallas wrappers ``_stats``, ``_apply``, ``_bwd_reduce``
  and ``_bwd_dx`` in interpret mode, on the same numpy-seeded inputs:
  f32 within rtol 1e-5 / atol 1e-5 (summation order differs); bf16
  outputs within rtol 1e-2 (one bf16 step: both round one f32 value,
  which may differ in its last bit), bf16 inputs' f32 sums within
  rtol 1e-5 / atol 1e-4.
* ``bn_train_kernels`` against ``bn_train_pallas``: y, mean and var
  within rtol/atol 1e-5, the gradients of x, gamma and beta through a
  loss that also weights mean and var within 1e-4.
* The ``BatchNorm`` op on every route (two-pass default,
  ``MXNET_BN_STATS=dot|auto``, ``MXNET_BN_IMPL=onepass``,
  ``MXNET_BN_PALLAS=1``) and mode (fix_gamma, use_global_stats,
  inference, output_mean_var, axis) against the JAX op with the same
  knobs set for both: outputs and new moving stats within 1e-5, every
  gradient within 1e-4 (f32).
* Meta tensors give shapes; the CUDA launchers reject what the kernels
  do not take before any build or launch.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import bn_pallas as jbn
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch  # noqa: F401  (populates the port's registry)
from mxnet_tpu_torch.ops import bn_kernels as tbn
from mxnet_tpu_torch.ops import registry as treg

KNOBS = ("MXNET_BN_PALLAS", "MXNET_BN_IMPL", "MXNET_BN_STATS")


def _rand(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _j(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _t(x, dtype):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)),
                               **tol)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's Pallas wrappers
# ---------------------------------------------------------------------------

SHAPES = [(3, 5, 24), (1, 4, 7), (4, 3, 1)]    # (N, C, HW): N = 1, HW = 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["N3C5HW24", "N1C4HW7",
                                               "N4C3HW1"])
@pytest.mark.parametrize("kernel", ["stats", "apply", "bwd_reduce",
                                    "bwd_dx"])
def test_plain_version_matches_pallas_wrapper(kernel, shape, dtype):
    N, C, HW = shape
    x = _rand(shape, 0, 2.0, 0.5)
    dy = _rand(shape, 1)
    chan = [_rand((C,), 2 + i) for i in range(4)]
    j_chan = [jnp.asarray(v) for v in chan]
    t_chan = [torch.from_numpy(v) for v in chan]
    jx, tx = _j(x, dtype), _t(x, dtype)
    jdy, tdy = _j(dy, dtype), _t(dy, dtype)
    f32 = dict(rtol=1e-5, atol=1e-5)
    sums = f32 if dtype == "f32" else dict(rtol=1e-5, atol=1e-4)
    out_tol = f32 if dtype == "f32" else dict(rtol=1e-2, atol=1e-6)
    if kernel == "stats":
        for t, j in zip(tbn._stats_reference(tx, t_chan[0]),
                        jbn._stats(jx, j_chan[0])):
            assert t.dtype == torch.float32 and t.shape == (C,)
            _close(t, j, **sums)
    elif kernel == "bwd_reduce":
        for t, j in zip(tbn._bwd_reduce_reference(tdy, tx, t_chan[0]),
                        jbn._bwd_reduce(jdy, jx, j_chan[0])):
            assert t.dtype == torch.float32 and t.shape == (C,)
            _close(t, j, **sums)
    elif kernel == "apply":
        t = tbn._apply_reference(tx, *t_chan[:2])
        assert t.dtype == tx.dtype and t.shape == shape
        _close(t, jbn._apply(jx, *j_chan[:2]), **out_tol)
    else:
        t = tbn._bwd_dx_reference(tdy, tx, *t_chan)
        assert t.dtype == tx.dtype and t.shape == shape
        _close(t, jbn._bwd_dx(jdy, jx, *j_chan, jx.dtype), **out_tol)


# ---------------------------------------------------------------------------
# bn_train_kernels against bn_train_pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale,shift,y_atol", [
    ((3, 5, 4, 6), 2.0, 1.0, 1e-5),
    ((1, 3, 7, 7), 1.0, 0.0, 1e-5),          # N = 1, HW = 49, odd C
    # |mean| / std = 1e3: y = x * a + b with x * a and b near 1e3, each
    # rounded in f32 to ~6e-5 (and one package may fuse the
    # multiply-add), so y carries ~1e-4 of rounding in both
    ((4, 2, 5, 5), 1e-2, 10.0, 2e-4),
], ids=["N3C5", "N1C3HW49", "large_mean"])
def test_bn_train_kernels_match_bn_train_pallas(shape, scale, shift, y_atol):
    C = shape[1]
    eps = 1e-3
    x = _rand(shape, 11, scale, shift)
    gamma = np.abs(_rand((C,), 12)) + 0.5
    beta = _rand((C,), 13)
    w_y, w_m, w_v = _rand(shape, 14), _rand((C,), 15), _rand((C,), 16)

    def jloss(x_, g_, b_):
        y, mean, var = jbn.bn_train_pallas(x_, g_, b_, eps)
        return (jnp.sum(y * w_y) + jnp.sum(mean * w_m)
                + jnp.sum(var * w_v)), (y, mean, var)

    (_, jouts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (torch.from_numpy(v).requires_grad_()
                  for v in (x, gamma, beta))
    touts = tbn.bn_train_kernels(tx, tg, tb, eps)
    loss = ((touts[0] * torch.from_numpy(w_y)).sum()
            + (touts[1] * torch.from_numpy(w_m)).sum()
            + (touts[2] * torch.from_numpy(w_v)).sum())
    tgrads = torch.autograd.grad(loss, (tx, tg, tb))
    for t, j, name in zip(touts, jouts, ("y", "mean", "var")):
        # var's absolute scale is std^2
        atol = {"y": y_atol, "mean": 1e-5, "var": 1e-5 * scale * scale}[name]
        _close(t.detach(), j, rtol=1e-5, atol=atol, err_msg=name)
    for t, j, name in zip(tgrads, jgrads, ("dx", "dgamma", "dbeta")):
        _close(t, j, rtol=1e-4, atol=1e-4, err_msg=name)


def test_bn_train_kernels_bf16_keeps_dtypes_and_matches_pallas():
    """bf16 x: y and dx in bf16, mean/var f32, dgamma/dbeta in gamma's
    and beta's dtype (bf16 here, rounded as in JAX); values within one
    bf16 step of the JAX package's."""
    shape = (2, 4, 3, 5)
    x = _rand(shape, 21)
    gamma, beta = np.abs(_rand((4,), 22)) + 0.5, _rand((4,), 23)
    dy = _rand(shape, 24)
    jx, jg, jb = (_j(v, "bf16") for v in (x, gamma, beta))
    (jy, jm, jv), vjp = jax.vjp(lambda a, b, c: jbn.bn_train_pallas(
        a, b, c, 1e-3), jx, jg, jb)
    jgr = vjp((_j(dy, "bf16"), jnp.zeros(4), jnp.zeros(4)))
    tx, tg, tb = (_t(v, "bf16").requires_grad_() for v in (x, gamma, beta))
    ty, tm, tv = tbn.bn_train_kernels(tx, tg, tb, 1e-3)
    tgr = torch.autograd.grad(ty, (tx, tg, tb), _t(dy, "bf16"))
    assert ty.dtype == torch.bfloat16
    assert tm.dtype == tv.dtype == torch.float32
    assert [g.dtype for g in tgr] == [torch.bfloat16] * 3
    _close(ty.detach(), jy, rtol=1e-2, atol=1e-2)
    _close(tm, jm, rtol=1e-5, atol=1e-5)
    _close(tv, jv, rtol=1e-5, atol=1e-5)
    for t, j in zip(tgr, jgr):
        _close(t, j, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# the BatchNorm op: every route and mode against the JAX op
# ---------------------------------------------------------------------------

ROUTES = {
    "default": {},
    "stats_dot": {"MXNET_BN_STATS": "dot"},
    "stats_auto": {"MXNET_BN_STATS": "auto"},
    "onepass": {"MXNET_BN_IMPL": "onepass"},
    "kernels": {"MXNET_BN_PALLAS": "1"},
}

MODES = {
    "train": dict(is_train=True, fix_gamma=False),
    "train_fix_gamma": dict(is_train=True, fix_gamma=True),
    "train_mean_var": dict(is_train=True, fix_gamma=False,
                           output_mean_var=True, momentum=0.8),
    "train_axis3": dict(is_train=True, fix_gamma=False, axis=3),
    "global_stats": dict(is_train=True, fix_gamma=False,
                         use_global_stats=True),
    "inference": dict(is_train=False, fix_gamma=False, eps=2e-5),
    "inference_mean_var": dict(is_train=False, output_mean_var=True),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_batchnorm_op_matches_jax(route, mode, monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    attrs = dict(MODES[mode])
    is_train = attrs.pop("is_train")
    # stats_auto applies its contractions only where C >= 2*H*W and
    # H*W >= 128: a shape inside that class
    shape = (2, 256, 8, 16) if route == "stats_auto" else (3, 4, 5, 6)
    axis = attrs.get("axis", 1)
    C = shape[axis]
    x = _rand(shape, 31, 1.5, 0.3)
    gamma, beta = np.abs(_rand((C,), 32)) + 0.5, _rand((C,), 33)
    mm, mv = _rand((C,), 34), np.abs(_rand((C,), 35)) + 0.5
    jop, top = jreg.get_op("BatchNorm"), treg.get_op("BatchNorm")
    jattrs = {**jreg.canon_attrs(jop, attrs), "is_train": is_train}
    tattrs = {**treg.canon_attrs(top, attrs), "is_train": is_train}

    jouts, vjp = jax.vjp(lambda a, g, b: jop.fn(
        a, g, b, jnp.asarray(mm), jnp.asarray(mv), **jattrs),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (torch.from_numpy(v.copy()).requires_grad_()
                  for v in (x, gamma, beta))
    touts = top.fn(tx, tg, tb, torch.from_numpy(mm), torch.from_numpy(mv),
                   **tattrs)
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert tuple(t.shape) == j.shape, i
        _close(t.detach(), j, rtol=1e-5, atol=1e-5, err_msg="output %d" % i)
    # the new moving stats leave the graph, as lax.stop_gradient
    assert not touts[-1].requires_grad and not touts[-2].requires_grad
    # cotangents on every differentiable output (y, and mean / inv_std
    # when they are outputs); the moving stats get zero, as their
    # stop_gradient makes them
    n_vis = len(touts) - 2
    cots = [_rand(tuple(j.shape), 40 + i) for i, j in enumerate(jouts)]
    jgrads = vjp(tuple(jnp.asarray(c) if i < n_vis else jnp.zeros(j.shape)
                       for i, (c, j) in enumerate(zip(cots, jouts))))
    heads = [t for t in touts[:n_vis] if t.requires_grad]
    tgrads = torch.autograd.grad(
        heads, (tx, tg, tb), [torch.from_numpy(c) for c, t in
                              zip(cots, touts[:n_vis]) if t.requires_grad],
        allow_unused=True)
    for t, j, name in zip(tgrads, jgrads, ("dx", "dgamma", "dbeta")):
        t = torch.zeros(j.shape) if t is None else t
        _close(t, j, rtol=1e-4, atol=1e-4, err_msg=name)


def test_kernel_route_reaches_bn_train_kernels(monkeypatch):
    """MXNET_BN_PALLAS=1 routes a 4-D axis-1 training BatchNorm through
    bn_train_kernels (read at call time); other axes and inference do
    not go there."""
    from mxnet_tpu_torch.ops import nn as tnn
    calls = []
    real = tnn.bn_train_kernels
    monkeypatch.setattr(tnn, "bn_train_kernels",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.from_numpy(_rand((2, 3, 4, 5), 50))
    args = (torch.ones(3), torch.zeros(3), torch.zeros(3), torch.ones(3))
    monkeypatch.setenv("MXNET_BN_PALLAS", "0")
    tnn._batch_norm(x, *args, is_train=True)
    assert not calls
    monkeypatch.setenv("MXNET_BN_PALLAS", "1")
    tnn._batch_norm(x, *args, is_train=True)
    tnn._batch_norm(x, *args, is_train=False)
    tnn._batch_norm(x.transpose(1, 3).contiguous(), *args, axis=3,
                    is_train=True)
    assert calls == [(2, 3, 4, 5)]


# ---------------------------------------------------------------------------
# meta tensors and the launchers' checks
# ---------------------------------------------------------------------------

def test_meta_tensors_give_shapes():
    x = torch.empty((2, 6, 10), device="meta", dtype=torch.bfloat16)
    c = torch.empty(6, device="meta")
    s1, s2 = tbn.bn_stats(x, c)
    assert s1.shape == s2.shape == (6,) and s1.dtype == torch.float32
    y = tbn.bn_apply(x, c, c)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    db, dxc = tbn.bn_bwd_reduce(x, x, c)
    assert db.shape == (6,)
    assert tbn.bn_bwd_dx(x, x, c, c, c, c).shape == x.shape
    x4 = torch.empty((2, 6, 2, 5), device="meta", dtype=torch.bfloat16)
    y, mean, var = tbn.bn_train_kernels(x4, torch.empty(6, device="meta"),
                                        torch.empty(6, device="meta"), 1e-3)
    assert y.shape == x4.shape and mean.shape == var.shape == (6,)


@pytest.mark.parametrize("bad,exc,match", [
    ("dtype", TypeError, "float32 or bfloat16"),
    ("rank", ValueError, r"\(N, C, HW\)"),
    ("cpu", ValueError, "CUDA device"),
    ("dy_dtype", TypeError, "dy must match x"),
    ("dy_shape", ValueError, "dy must match x"),
    ("chan_dtype", ValueError, "must be float32 of shape"),
    ("chan_shape", ValueError, "must be float32 of shape"),
])
def test_launchers_validate_inputs(bad, exc, match):
    """Every launcher raises on what its kernel does not take, before
    any build or launch, so this runs without a card. (The CPU tensors
    here are refused for their device last: the checks run in order.)"""
    x = torch.zeros((2, 3, 4), dtype=torch.float16 if bad == "dtype"
                    else torch.float32)
    if bad == "rank":
        x = torch.zeros((2, 3, 4, 1))
    dy = x
    if bad == "dy_dtype":
        dy = x.to(torch.bfloat16)
    elif bad == "dy_shape":
        dy = torch.zeros((2, 3, 5))
    c = torch.zeros(3)
    if bad == "chan_dtype":
        c = torch.zeros(3, dtype=torch.float64)
    elif bad == "chan_shape":
        c = torch.zeros(4)
    if bad in ("dy_dtype", "dy_shape", "chan_dtype", "chan_shape"):
        # reach the later checks: pretend x is on a CUDA device
        with pytest.raises(exc, match=match):
            tbn._check_operands("bn_bwd_dx_cuda", _OnCuda(x),
                                same=(("dy", _OnCuda(dy)),),
                                chans=(("c2", _OnCuda(c)),))
        return
    for fn, args in ((tbn.bn_stats_cuda, (x, c)),
                     (tbn.bn_apply_cuda, (x, c, c)),
                     (tbn.bn_bwd_reduce_cuda, (dy, x, c)),
                     (tbn.bn_bwd_dx_cuda, (dy, x, c, c, c, c))):
        with pytest.raises(exc, match=match):
            fn(*args)


class _OnCuda:
    """A CPU tensor that reports a CUDA device, to reach the launchers'
    later checks on a machine without a card."""

    def __init__(self, t):
        self._t = t
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return self._t.dim()

    def numel(self):
        return self._t.numel()


def test_other_devices_raise():
    x = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="no implementation for device"):
        tbn._dispatch(tbn.bn_stats_cuda, tbn._stats_reference,
                      torch.device("xpu"), x, torch.zeros(2))
