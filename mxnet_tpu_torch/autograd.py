"""Imperative autograd over torch's own graph — the PyTorch twin of
``mxnet_tpu/autograd.py`` (reference: python/mxnet/autograd.py).

The JAX package records a tape of per-op vjp closures. Here torch's
autograd graph is the tape: under ``record()`` the registry runs each
differentiable op with grad enabled (``ops.registry.invoke_eager``), so
an op's output tensor carries its ``grad_fn``; outside it nothing is
recorded, even for arrays that carry ``attach_grad``. MXNet's semantics
live in this module:

- a marked variable (``attach_grad``/``mark_variables``) holds a leaf
  tensor that requires grad; an in-place write to it (``x += 1``,
  ``out=``, ``x[:] = ...``) gives it a fresh leaf, never mutating one
  that a graph saved;
- ``backward`` walks the heads' graph to the leaves of marked variables
  (the leaves an array had before a write count too) and takes their
  gradients with ``torch.autograd.grad``, then applies ``grad_req``:
  ``write`` overwrites the buffer, summing within one call; ``add``
  adds; ``null`` leaves it. A variable the heads do not reach keeps its
  buffer;
- a graph can be backpropagated again, as the reference's closures can:
  every backward keeps it (``retain_graph``), and it lives as long as its
  head arrays do;
- ``Function`` is a ``torch.autograd.Function`` underneath, with MXNet's
  ``forward``/``backward`` on NDArrays.

Scopes are thread-local, as in the reference.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    prev = _st().recording
    _state.recording = bool(is_record)
    return prev


def set_training(train_mode_):
    prev = _st().training
    _state.training = bool(train_mode_)
    return prev


class _Scope:
    def __init__(self, recording=None, training=None):
        self._recording = recording
        self._training = training

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._recording is not None:
            st.recording = self._recording
        if self._training is not None:
            st.training = self._training
        return self

    def __exit__(self, *a):
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode=True):  # noqa: D401  (reference autograd.py:121)
    """Scope: operations are recorded for differentiation."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode=False):
    """Scope: recording suspended (reference autograd.py:141)."""
    return _Scope(recording=False, training=train_mode)


def train_mode():
    return _Scope(training=True)


def predict_mode():
    return _Scope(training=False)


# ---------------------------------------------------------------------------
# variables: NDArrays whose leaf tensors take gradients
# ---------------------------------------------------------------------------

def _leaf_for(var, data):
    """A fresh leaf tensor for marked variable ``var`` holding ``data``,
    tagged with its owner so that ``backward`` finds it in a graph."""
    leaf = data.detach()
    if leaf.is_floating_point():
        leaf.requires_grad_(True)
        leaf._mx_owner = weakref.ref(var)
    return leaf


def _is_variable(x):
    return getattr(x, "_grad", None) is not None and x._grad_req != "null"


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers (reference autograd.py:196)."""
    from .ndarray.ndarray import NDArray
    variables = [variables] if isinstance(variables, NDArray) \
        else list(variables)
    gradients = [gradients] if isinstance(gradients, NDArray) \
        else list(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad = g
        v._grad_req = req
        v._data = _leaf_for(v, v._data)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _graph_leaves(roots):
    """Every leaf tensor (requiring grad) the graphs of ``roots`` reach."""
    leaves, seen = [], set()
    stack = []
    for r in roots:
        if r.grad_fn is not None:
            stack.append(r.grad_fn)
        elif r.requires_grad:
            leaves.append(r)
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            leaves.append(var)
        stack.extend(n for n, _i in fn.next_functions if n is not None)
    return leaves


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    heads = [heads] if isinstance(heads, NDArray) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, (NDArray, np.ndarray, torch.Tensor)):
        head_grads = [head_grads]
    outs, cots = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue
        if hg is None:
            g = torch.ones_like(t)
        elif isinstance(hg, NDArray):
            g = hg._data
        else:
            g = torch.as_tensor(np.asarray(hg))
        outs.append(t)
        cots.append(g.to(device=t.device, dtype=t.dtype).reshape(t.shape))
    if not outs:
        raise ValueError("cannot differentiate: no head is attached to the "
                         "recorded graph (did you call backward outside "
                         "autograd.record()?)")
    return outs, cots


def _variable_grads(heads, head_grads, owners_of, extra=(),
                    create_graph=False):
    """{id(var): (var, summed gradient)} over the variables that
    ``owners_of(leaf)`` names for the leaves the heads reach, and over
    the (var, tensor) pairs of ``extra``."""
    outs, cots = _heads(heads, head_grads)
    pairs = [(v, t) for v, t in extra if t.requires_grad]
    seen = {id(t) for _v, t in pairs}
    for leaf in _graph_leaves(outs):
        var = owners_of(leaf)
        if var is not None and id(leaf) not in seen:
            seen.add(id(leaf))
            pairs.append((var, leaf))
    if not pairs:
        return {}
    grads = torch.autograd.grad(outs, [t for _v, t in pairs], cots,
                                retain_graph=True, create_graph=create_graph,
                                allow_unused=True)
    out = {}
    for (var, _t), g in zip(pairs, grads):
        if g is None:
            continue
        key = id(var)
        out[key] = (var, g if key not in out else out[key][1] + g)
    return out


def _marked_owner(leaf):
    ref = getattr(leaf, "_mx_owner", None)
    var = ref() if ref is not None else None
    return var if var is not None and _is_variable(var) else None


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the buffers of the marked variables
    they reach (reference autograd.py:227). The graph is kept for a
    later backward, as the reference's tape is (``retain_graph`` is
    accepted for the signature)."""
    for var, g in _variable_grads(heads, head_grads,
                                  _marked_owner).values():
        _flush_var(var, g)


def _flush_var(var, g):
    gbuf = var._grad
    g = g.detach().to(gbuf._data.dtype).reshape(gbuf.shape)
    gbuf._set_data(gbuf._data + g if var._grad_req == "add" else g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """New gradient arrays of ``heads`` with respect to ``variables``
    (reference autograd.py ``grad``); the variables' own buffers are left
    as they were. Zeros for a variable the heads do not reach."""
    from .ndarray.ndarray import NDArray, _wrap
    variables = [variables] if isinstance(variables, NDArray) \
        else list(variables)
    want = {id(v) for v in variables}

    def owners_of(leaf):
        ref = getattr(leaf, "_mx_owner", None)
        var = ref() if ref is not None else None
        return var if var is not None and id(var) in want else None

    found = _variable_grads(heads, head_grads, owners_of,
                            extra=[(v, v._data) for v in variables],
                            create_graph=create_graph)
    out = []
    for v in variables:
        g = found.get(id(v), (None, None))[1]
        if g is None:
            g = torch.zeros_like(v._data)
        elif not create_graph:
            g = g.detach()
        out.append(_wrap(g.to(v._data.dtype).reshape(v.shape)))
    return out


def get_symbol(x):
    """The reference returns the recorded graph as a Symbol; torch's graph
    has no symbolic form here, as the JAX package's tape has none."""
    raise NotImplementedError(
        "get_symbol is not supported: the autograd tape is torch's graph "
        "of backward functions, not a symbolic graph. Build the graph "
        "with mx.sym instead.")


# ---------------------------------------------------------------------------
# user-defined functions
# ---------------------------------------------------------------------------

class Function:
    """User-defined differentiable function (reference autograd.py:309).

    Subclass and implement forward(self, *inputs) and
    backward(self, *output_grads) on NDArrays; call the instance on
    NDArrays. Under ``record()`` the call is one node of torch's graph
    (a ``torch.autograd.Function``) whose backward calls yours."""

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, _wrap
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        func = self
        box = {}

        class _Node(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *xs):
                with pause():
                    outs = func.forward(*inputs)
                box["single"] = not isinstance(outs, (tuple, list))
                outs = [outs] if box["single"] else list(outs)
                # an output that is an input, as is, must be a new
                # tensor for the node's graph
                return tuple(o._data.clone()
                             if any(o._data is x for x in xs) else o._data
                             for o in outs)

            @staticmethod
            def backward(ctx, *cts):
                with pause():
                    in_grads = func.backward(*[_wrap(c) for c in cts])
                if not isinstance(in_grads, (tuple, list)):
                    in_grads = (in_grads,)
                return tuple(g._data if isinstance(g, NDArray) else g
                             for g in in_grads)

        outs = [_wrap(t) for t in _Node.apply(*[x._data for x in inputs])]
        return outs[0] if box["single"] else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
