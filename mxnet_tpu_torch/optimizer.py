"""Optimizers — the PyTorch twin of ``mxnet_tpu/optimizer.py``
(reference: python/mxnet/optimizer.py).

The same surface: the registry and ``create``, per-parameter lr/wd
multipliers, ``create_state``, ``update``, ``Updater`` for a KVStore and
``get_updater``. Each class computes what the JAX package's does, over
the port's ``mx.nd`` ops: the fused update ops of
``ops/optimizer_ops.py`` where the class calls one, ``mx.nd``
arithmetic elsewhere. State lives on the weight's device. SGLD's noise
is the threefry normal of ``mx.random.next_key()``, the JAX package's
draw. Multi-precision (mp_*) keeps a float32 master copy beside float16
weights.
"""
from __future__ import annotations

import logging
import math
import pickle
import threading
import warnings

import numpy as np

from . import _threefry
from .ndarray import NDArray, op as _op
from .ndarray.ndarray import array as _array, zeros as _nd_zeros

__all__ = ["Optimizer", "SGD", "Signum", "NAG", "SGLD", "DCASGD", "ccSGD",
           "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax",
           "Nadam", "LAMB", "Test", "Updater", "get_updater", "create",
           "register", "opt_registry"]


class Optimizer:
    """Base optimizer (reference optimizer.py:Optimizer)."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        """Register an optimizer class by (lowercased) name."""
        if not isinstance(klass, type):
            raise TypeError("can only register classes")
        name = klass.__name__.lower()
        prev = Optimizer.opt_registry.get(name)
        if prev is not None:
            warnings.warn("optimizer name %r: %s replaces %s"
                          % (name, klass, prev))
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        """Instantiate by registered name (reference
        optimizer.py:create_optimizer)."""
        try:
            klass = Optimizer.opt_registry[name.lower()]
        except KeyError:
            raise ValueError("no optimizer registered under %r" % name)
        return klass(**kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate

        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self._count_lock = threading.Lock()
        self.clip_gradient = clip_gradient
        self.multi_precision = False

        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            "param_idx2name should be a dict of param indexes to names."
        self.idx2name = param_idx2name.copy()
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}

        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        """Create optimizer state (momentum etc.) for one weight."""
        return None

    def create_state_multi_precision(self, index, weight):
        """State incl. the float32 master weight when multi-precision is on
        (reference optimizer.py:create_state_multi_precision)."""
        weight_master_copy = None
        if self.multi_precision and weight.dtype == np.float16:
            weight_master_copy = weight.astype(np.float32)
            return (weight_master_copy, self.create_state(index,
                                                          weight_master_copy))
        if weight.dtype == np.float16 and not self.multi_precision:
            warnings.warn("float16 optimizer state accumulates rounding "
                          "error (poor accuracy / slow convergence); pass "
                          "multi_precision=True to keep float32 master "
                          "weights")
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """Apply one update. Subclasses override."""
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight.dtype == np.float16:
            weight_master_copy, original_state = state
            grad32 = grad.astype(np.float32)
            self.update(index, weight_master_copy, grad32, original_state)
            weight[:] = weight_master_copy.astype(weight.dtype)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                "this optimizer's learning rate is driven by an "
                "LRScheduler; set_learning_rate would be overridden on "
                "the next update. Adjust the scheduler instead (or "
                "create the optimizer without one).")
        self.lr = lr

    def set_lr_scale(self, args_lrscale):  # pragma: no cover - deprecated
        raise DeprecationWarning("Use set_lr_mult instead.")

    def _sym_attr_mults(self, attr_key):
        """Collect __lr_mult__/__wd_mult__ symbol attrs into a dict."""
        if not self.sym_info:
            return {}
        attr, arg_names = self.sym_info
        return {n: float(attr[n][attr_key]) for n in arg_names
                if attr_key in attr.get(n, {})}

    def __getstate__(self):
        # optimizers travel by pickle (dist_async set_optimizer ships
        # them to the server); locks don't pickle — recreated on load
        d = self.__dict__.copy()
        d.pop("_count_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._count_lock = threading.Lock()

    def set_lr_mult(self, args_lr_mult):
        """Per-param lr multipliers; also pulls ``__lr_mult__`` symbol attrs
        (reference optimizer.py:set_lr_mult)."""
        self.lr_mult = {**self._sym_attr_mults("__lr_mult__"),
                        **args_lr_mult}

    def set_wd_mult(self, args_wd_mult):
        """Per-param wd multipliers. As in the reference, params whose name
        does not end in _weight or _gamma default to wd_mult=0 (no decay
        on biases/betas)."""
        no_decay = {n: 0.0 for n in self.idx2name.values()
                    if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult = {**no_decay, **self._sym_attr_mults("__wd_mult__"),
                        **args_wd_mult}

    def _update_count(self, index):
        # lock: the async PS applies distinct-key updates from
        # concurrent handler threads (parallel/ps_async.py per-key lock
        # table); per-index state is disjoint there, but num_update is
        # a SHARED scalar whose read-modify-write must not interleave
        # (a stale max would rewind lr schedules / bias correction)
        with self._count_lock:
            count = self._index_update_count.get(
                index, self.begin_num_update) + 1
            self._index_update_count[index] = count
            self.num_update = max(count, self.num_update)

    def _mult_for(self, index, mults, attr):
        """Resolve the per-param multiplier: param_dict beats explicit
        index entries beats name-keyed entries."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in mults:
            return mults[index]
        return mults.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index):
        base = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return base * self._mult_for(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult_for(index, self.wd_mult, "wd_mult")

    # -- shared per-update preamble (the reference repeats these four
    #    lines in every optimizer's update body; factored here) ----------
    def _hypers(self, index):
        """Count this update and return (lr, wd) for the param."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def _scaled(self, grad):
        """Rescale + clip a gradient for non-fused update math. Fused
        registry ops take rescale_grad/clip_gradient as attrs instead."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = _op.clip(g, -self.clip_gradient, self.clip_gradient)
        return g

def zeros(shape, dtype=None, like=None):
    """Zero state on ``like``'s device (the weight's)."""
    return _nd_zeros(shape, ctx=like.context, dtype=dtype)


register = Optimizer.register
create = Optimizer.create_optimizer
opt_registry = Optimizer.opt_registry


def _clip_attr(clip_gradient):
    return -1.0 if clip_gradient is None else clip_gradient


@register
class SGD(Optimizer):
    """SGD with momentum + optional multi-precision
    (reference optimizer.py:SGD; fused kernels sgd_update/sgd_mom_update/
    mp_sgd_* from src/operator/optimizer_op.cc)."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, dtype=weight.dtype, like=weight)

    def create_state_multi_precision(self, index, weight):
        weight_master_copy = None
        if self.multi_precision and weight.dtype == np.float16:
            weight_master_copy = weight.astype(np.float32)
            return (self.create_state(index, weight_master_copy),
                    weight_master_copy)
        if weight.dtype == np.float16 and not self.multi_precision:
            warnings.warn("float16 optimizer state accumulates rounding "
                          "error (poor accuracy / slow convergence); pass "
                          "multi_precision=True to the SGD optimizer to "
                          "keep float32 master weights")
        return self.create_state(index, weight)

    def _update_impl(self, index, weight, grad, state, multi_precision=False):
        lr, wd = self._hypers(index)

        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=_clip_attr(self.clip_gradient))
        if not multi_precision:
            if state is not None:
                _op.sgd_mom_update(weight, grad, state, out=weight,
                                   momentum=self.momentum, **kwargs)
            else:
                _op.sgd_update(weight, grad, out=weight, **kwargs)
        else:
            if state[0] is not None:
                _op.mp_sgd_mom_update(weight, grad, state[0], state[1],
                                      out=weight, momentum=self.momentum,
                                      **kwargs)
            else:
                _op.mp_sgd_update(weight, grad, state[1], out=weight,
                                  **kwargs)

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, multi_precision=False)

    def update_multi_precision(self, index, weight, grad, state):
        use_mp = self.multi_precision and weight.dtype == np.float16
        self._update_impl(index, weight, grad, state,
                          multi_precision=use_mp)


@register
class Signum(Optimizer):
    """SignSGD / Signum (fused signsgd_update; later-reference optimizer
    kept because the fused kernel exists here)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return zeros(weight.shape, dtype=weight.dtype, like=weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        if state is not None:
            g = grad * self.rescale_grad
            if self.clip_gradient is not None:
                g = _op.clip(g, -self.clip_gradient, self.clip_gradient)
            state[:] = self.momentum * state - (1 - self.momentum) * \
                (g + wd * weight)
            weight[:] = weight + lr * _op.sign(state) - \
                lr * self.wd_lh * weight
        else:
            _op.signsgd_update(weight, grad, out=weight, lr=lr, wd=wd,
                               rescale_grad=self.rescale_grad,
                               clip_gradient=_clip_attr(self.clip_gradient))


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference optimizer.py:DCASGD)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (zeros(weight.shape, dtype=weight.dtype, like=weight), weight.copy())

    def update(self, index, weight, grad, state):
        lr, wd = self._hypers(index)
        grad = self._scaled(grad)

        mom, previous_weight = state
        if mom is not None:
            mom[:] *= self.momentum
            mom[:] += -lr * (grad + wd * weight + self.lamda *
                             grad * grad * (weight - previous_weight))
        else:
            assert self.momentum == 0.0
            mom = -lr * (grad + wd * weight + self.lamda *
                         grad * grad * (weight - previous_weight))
            state = (None, previous_weight)
        previous_weight[:] = weight
        weight[:] += mom


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference optimizer.py:NAG)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def update(self, index, weight, grad, state):
        lr, wd = self._hypers(index)
        grad = self._scaled(grad)

        if state is not None:
            mom = state
            mom[:] *= self.momentum
            grad += wd * weight
            mom[:] += grad
            grad[:] += self.momentum * mom
            weight[:] += -lr * grad
        else:
            assert self.momentum == 0.0
            weight[:] += -lr * (grad + wd * weight)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (reference
    optimizer.py:SGLD)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        lr, wd = self._hypers(index)
        grad = self._scaled(grad)
        from . import random as _rnd
        noise = _array(_threefry.normal(
            _rnd.next_key(), weight.shape,
            device=weight.context.torch_device()) * math.sqrt(lr),
            ctx=weight.context)
        weight[:] += -lr / 2 * (grad + wd * weight) + noise


@register
class ccSGD(SGD):  # pylint: disable=invalid-name
    """Deprecated alias of SGD (reference optimizer.py:ccSGD)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)


@register
class Adam(Optimizer):
    """Adam (reference optimizer.py:Adam; fused adam_update)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, dtype=weight.dtype, like=weight),   # mean
                zeros(weight.shape, dtype=weight.dtype, like=weight))   # variance

    def update(self, index, weight, grad, state):
        lr, wd = self._hypers(index)

        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1

        mean, var = state
        _op.adam_update(weight, grad, mean, var, out=weight, lr=lr, wd=wd,
                        beta1=self.beta1, beta2=self.beta2,
                        epsilon=self.epsilon,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=_clip_attr(self.clip_gradient))


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference optimizer.py:AdaGrad)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, dtype=weight.dtype, like=weight)  # history

    def update(self, index, weight, grad, state):
        lr, wd = self._hypers(index)
        grad = self._scaled(grad)
        history = state
        history[:] += grad * grad
        weight[:] += -lr * (grad / _op.sqrt(history + self.float_stable_eps)
                            + wd * weight)


@register
class RMSProp(Optimizer):
    """RMSProp, Tieleman (centered=False) / Graves (centered=True) variants
    (reference optimizer.py:RMSProp; fused rmsprop/rmspropalex kernels)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (zeros(weight.shape, dtype=weight.dtype, like=weight),  # n
                    zeros(weight.shape, dtype=weight.dtype, like=weight),  # g
                    zeros(weight.shape, dtype=weight.dtype, like=weight))  # delta
        return (zeros(weight.shape, dtype=weight.dtype, like=weight),)     # n

    def update(self, index, weight, grad, state):
        lr, wd = self._hypers(index)

        kwargs = dict(lr=lr, wd=wd, gamma1=self.gamma1,
                      epsilon=self.epsilon,
                      rescale_grad=self.rescale_grad,
                      clip_gradient=_clip_attr(self.clip_gradient),
                      clip_weights=(self.clip_weights
                                    if self.clip_weights else -1.0))
        if not self.centered:
            (n,) = state
            _op.rmsprop_update(weight, grad, n, out=weight, **kwargs)
        else:
            n, g, delta = state
            _op.rmspropalex_update(weight, grad, n, g, delta, out=weight,
                                   gamma2=self.gamma2, **kwargs)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference optimizer.py:AdaDelta)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, dtype=weight.dtype, like=weight),  # E[g^2]
                zeros(weight.shape, dtype=weight.dtype, like=weight))  # E[dx^2]

    def update(self, index, weight, grad, state):
        _, wd = self._hypers(index)
        grad = self._scaled(grad)

        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1. - self.rho) * grad * grad
        current_delta = (_op.sqrt(acc_delta + self.epsilon) /
                         _op.sqrt(acc_g + self.epsilon)) * grad
        acc_delta[:] = self.rho * acc_delta + \
            (1. - self.rho) * current_delta * current_delta
        weight[:] -= current_delta + wd * weight


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference optimizer.py:Ftrl; fused ftrl_update)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(**kwargs)
        self.lamda1 = lamda1
        self.beta = beta
        self.lr = learning_rate

    def create_state(self, index, weight):
        return (zeros(weight.shape, dtype=weight.dtype, like=weight),  # z
                zeros(weight.shape, dtype=weight.dtype, like=weight))  # n

    def update(self, index, weight, grad, state):
        assert isinstance(weight, NDArray)
        assert isinstance(grad, NDArray)
        self._update_count(index)
        wd = self._get_wd(index)
        lr = self._get_lr(index)

        z, n = state
        _op.ftrl_update(weight, grad, z, n, out=weight, lr=lr, wd=wd,
                        lamda1=self.lamda1, beta=self.beta,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=_clip_attr(self.clip_gradient))


@register
class Adamax(Optimizer):
    """AdaMax, infinity-norm Adam variant (reference
    optimizer.py:Adamax)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (zeros(weight.shape, dtype=weight.dtype, like=weight),  # mean
                zeros(weight.shape, dtype=weight.dtype, like=weight))  # variance

    def update(self, index, weight, grad, state):
        lr, wd = self._hypers(index)

        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)

        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = _op.clip(grad, -self.clip_gradient, self.clip_gradient)

        m_t, u_t = state
        m_t[:] = self.beta1 * m_t + (1. - self.beta1) * grad
        u_t[:] = _op.maximum(self.beta2 * u_t, _op.abs(grad))
        weight[:] -= lr * m_t / u_t


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference optimizer.py:Nadam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (zeros(weight.shape, dtype=weight.dtype, like=weight),  # mean
                zeros(weight.shape, dtype=weight.dtype, like=weight))  # variance

    def update(self, index, weight, grad, state):
        lr, wd = self._hypers(index)

        t = self._index_update_count[index]

        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = _op.clip(grad, -self.clip_gradient, self.clip_gradient)

        momentum_t = self.beta1 * (1. - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1

        m_t, v_t = state
        m_t[:] = self.beta1 * m_t + (1. - self.beta1) * grad
        v_t[:] = self.beta2 * v_t + (1. - self.beta2) * grad * grad

        grad_prime = grad / (1. - self.m_schedule)
        m_t_prime = m_t / (1. - m_schedule_next)
        v_t_prime = v_t / (1. - self.beta2 ** t)
        m_t_bar = (1. - momentum_t) * grad_prime + \
            momentum_t_1 * m_t_prime

        weight[:] -= lr * m_t_bar / (_op.sqrt(v_t_prime) + self.epsilon)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive Adam for large-batch training (extension: the
    reference predates LAMB; You et al. 2019)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=1e-3, upper_bound=10.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def create_state(self, index, weight):
        return (zeros(weight.shape, dtype=weight.dtype, like=weight),
                zeros(weight.shape, dtype=weight.dtype, like=weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]

        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = _op.clip(grad, -self.clip_gradient, self.clip_gradient)

        m, v = state
        m[:] = self.beta1 * m + (1. - self.beta1) * grad
        v[:] = self.beta2 * v + (1. - self.beta2) * grad * grad
        m_hat = m / (1. - self.beta1 ** t)
        v_hat = v / (1. - self.beta2 ** t)
        update = m_hat / (_op.sqrt(v_hat) + self.epsilon) + wd * weight
        # trust ratio computed on the device: no host sync in the update
        w_norm = _op.norm(weight)
        u_norm = _op.norm(update)
        ratio = _op.where(w_norm * u_norm > 0,
                          _op.clip(w_norm / (u_norm + 1e-30),
                                   self.lower_bound, self.upper_bound),
                          _op.ones_like(w_norm))
        weight[:] -= lr * ratio * update


@register
class Test(Optimizer):
    """Mock optimizer for update-path tests (reference
    optimizer.py:1002)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def create_state(self, index, weight):
        return zeros(weight.shape, dtype=weight.dtype, like=weight)

    def update(self, index, weight, grad, state):
        weight[:] += grad * self.rescale_grad
        state[:] = weight


class Updater:
    """KVStore updater closure over an Optimizer (reference
    optimizer.py:1019 get_updater/Updater): lazily creates per-key state on
    first update; states picklable via get_states/set_states."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = \
                self.sync_state_context(self.states[index], weight.context)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def sync_state_context(self, state, context):
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, np.ndarray):  # revived from get_states pickle
            return _array(state, ctx=context)
        if isinstance(state, (tuple, list)):
            return type(state)(
                self.sync_state_context(i, context) for i in state)
        return state

    def set_states(self, states):
        """Load pickled states (reference Updater.set_states)."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """Pickle states (+ optionally the optimizer itself)."""
        def to_np(s):
            if isinstance(s, NDArray):
                return s.asnumpy()
            if isinstance(s, (tuple, list)):
                return type(s)(to_np(i) for i in s)
            return s
        states = {k: to_np(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)


def get_updater(optimizer):
    """Wrap an optimizer as a kvstore updater fn (reference
    optimizer.py:get_updater)."""
    return Updater(optimizer)
