"""Gluon Block / HybridBlock / SymbolBlock — the PyTorch twin of
``mxnet_tpu/gluon/block.py`` (reference: python/mxnet/gluon/block.py,
452+ LoC).

Hybridize: the reference's ``_build_cache`` traces hybrid_forward with
symbol proxies and wraps the graph in a native CachedOp that re-invokes
each op imperatively (block.py:380-382 -> MXCreateCachedOp). The JAX
package compiles that traced graph with ``jax.jit``. Here ``_CachedGraph``
runs it through ``executor._graph_eval_fn``, the walk the Executor and
``TrainStep`` share: one pass over the graph's nodes, each op's registry
function on torch tensors, intermediates freed after their last use.
Under ``autograd.record()`` the walk runs with torch's grad mode on and
the parameters' leaf tensors as the graph's arguments, so ``backward``
reaches them through torch's graph as it does from eager ops. There is
no whole-graph compile and no CUDA-graph capture here: a hybridized
forward dispatches op by op, as the eager one does.
"""
from __future__ import annotations

import copy
import threading

import torch

from .. import autograd
from .. import ndarray as nd
from .. import symbol as sym_mod
from ..executor import _graph_eval_fn
from ..ndarray import NDArray
from ..ndarray.ndarray import _wrap
from ..symbol import Symbol
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_naming = threading.local()


class _BlockScope:
    """Name scope manager for Blocks (reference block.py:_BlockScope)."""

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def _current():
        return getattr(_naming, "scope", None)

    @staticmethod
    def create(prefix, params, hint):
        """Resolve the (prefix, ParameterDict) for a new Block: auto-name
        from `hint` counters when no prefix is given; wrap an explicitly
        shared dict; otherwise mint a fresh dict under the full prefix."""
        scope = _BlockScope._current()
        if prefix is None:
            if scope is None:
                prefix = _global_count(hint) + "_"
            else:
                n = scope._counter[hint] = scope._counter.get(hint, 0) + 1
                prefix = "%s%d_" % (hint, n - 1)
        full = prefix if scope is None else scope._block.prefix + prefix
        if params is not None:
            return full, ParameterDict(params.prefix, params)
        if scope is None:
            return full, ParameterDict(full)
        parent = scope._block.params
        return full, ParameterDict(parent.prefix + prefix, parent._shared)

    def __enter__(self):
        self._old_scope = _BlockScope._current()
        _naming.scope = self
        from .. import name as name_mod
        self._name_scope = name_mod.Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _naming.scope = self._old_scope


_global_counters = {}


def _global_count(hint):
    count = _global_counters.get(hint, 0)
    _global_counters[hint] = count + 1
    return "%s%d" % (hint, count)


def _flatten(args):
    """Flatten a nested list/tuple of arrays into (leaves, treedef).
    The treedef is an int for a leaf (0 = single array, n>1 = a Symbol
    with n outputs) or a list of child treedefs."""
    if isinstance(args, NDArray):
        return [args], 0
    if isinstance(args, Symbol):
        n = len(args.list_outputs())
        return [args], (n if n > 1 else 0)
    if not isinstance(args, (list, tuple)):
        raise TypeError("HybridBlock i/o must nest only Symbol/NDArray "
                        "in lists/tuples, found %s" % type(args))
    parts = [_flatten(a) for a in args]
    return [leaf for leaves, _ in parts for leaf in leaves], \
        [fmt for _, fmt in parts]


def _regroup(args, fmt):
    """Inverse of _flatten: consume leaves from `args` per the treedef,
    returning (structure, leftover_leaves)."""
    if isinstance(fmt, int):
        return (args[0], args[1:]) if fmt == 0 else (args[:fmt], args[fmt:])
    if not isinstance(args, (list, tuple)):
        raise TypeError("expected a sequence of outputs, got %s"
                        % type(args))
    out = []
    for child in fmt:
        piece, args = _regroup(args, child)
        out.append(piece)
    return out, args


class Block:
    """Base building block (reference block.py:Block)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join(
            ["  ({key}): {block}".format(
                key=key, block=repr(block).replace("\n", "\n  "))
             for key, block in self.__dict__.items()
             if isinstance(block, Block)])
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        """Registers parameters and child blocks (reference
        block.py:__setattr__)."""
        existing = getattr(self, name, None)
        if isinstance(existing, (Parameter, Block)) and \
                not isinstance(value, type(existing)):
            raise TypeError(
                "attribute %s holds a %s; refusing to replace it with a %s"
                % (name, type(existing).__name__, type(value).__name__))
        if isinstance(existing, Block):
            # in-place swap keeps the child's position stable
            self._children = [value if c is existing else c
                              for c in self._children]
        elif isinstance(value, Block):
            self.register_child(value)
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """Name scope context manager (reference block.py:name_scope)."""
        return self._scope

    @property
    def params(self):
        """This block's own ParameterDict (NOT including children;
        reference block.py:params)."""
        return self._params

    def collect_params(self):
        """All parameters incl. children (reference
        block.py:collect_params)."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for cld in self._children:
            ret.update(cld.collect_params())
        return ret

    def save_params(self, filename):
        """Save parameters (reference block.py:save_params:235)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Load parameters (reference block.py:load_params:243)."""
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, self.prefix)

    def register_child(self, block):
        """Register a child block (reference
        block.py:register_child)."""
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize all parameters (reference block.py:initialize)."""
        from ..initializer import Uniform
        if init is None:
            init = Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True):
        """Activate hybrid (compiled) execution for all HybridBlocks
        (reference block.py:hybridize)."""
        for cld in self._children:
            cld.hybridize(active)

    def cast(self, dtype):
        """Cast params + computation dtype (reference block.py:cast)."""
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class _CachedGraph:
    """The graph behind hybridize (reference: the native CachedOp,
    src/c_api/c_api_ndarray.cc:633-738): the traced Symbol walked by
    ``_graph_eval_fn`` on the inputs' device."""

    def __init__(self, symbol, input_names):
        self._input_names = input_names
        self._eval = _graph_eval_fn(symbol)
        self._aux_names = symbol.list_auxiliary_states()

    def __call__(self, inputs, params, aux_params, is_train, rng):
        arg_vals = {n: x._data for n, x in zip(self._input_names, inputs)}
        # a parameter's tensor is its leaf: recorded, the walk's graph
        # reaches it as an eager op's does
        arg_vals.update((n, p._data) for n, p in params.items())
        aux_vals = {n: a._data for n, a in aux_params.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, new_aux = self._eval(arg_vals, aux_vals, rng,
                                       bool(is_train))
        for n in self._aux_names:
            aux_params[n]._set_data(new_aux[n].detach())
        return [_wrap(o) for o in outs]


class HybridBlock(Block):
    """Block that supports symbolic tracing + compiled execution
    (reference block.py:HybridBlock:119-452)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._reg_params = {}
        self._cached_graph = ()
        self._cached_op = None
        self._active = False

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()
        if isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed. " \
                "If you want to share parameters between blocks, please " \
                "set 'params' at Block construction instead." % name
            self._reg_params[name] = value

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (
                    str(block), str(type(block))))
        super().register_child(block)
        self._clear_cached_op()

    def hybridize(self, active=True):
        self._active = active
        self._clear_cached_op()
        super().hybridize(active)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_op = None

    def _get_graph(self, *args):
        """Trace hybrid_forward with symbol proxies (reference
        block.py:_get_graph)."""
        if not self._cached_graph:
            args, self._in_format = _flatten(args)
            if len(args) > 1:
                inputs = [sym_mod.var("data%d" % i)
                          for i in range(len(args))]
            else:
                inputs = [sym_mod.var("data")]
            grouped_inputs = _regroup(inputs, self._in_format)[0]

            params = {i: j.var() for i, j in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(sym_mod, *grouped_inputs,
                                          **params)
            out, self._out_format = _flatten(out)
            self._cached_graph = (inputs,
                                  sym_mod.Group(out) if len(out) > 1
                                  else out[0])
        return self._cached_graph

    def infer_shape(self, *args):
        """Infer + set parameter shapes from inputs (reference
        block.py:infer_shape)."""
        inputs, out = self._get_graph(*args)
        args, _ = _flatten(args)
        arg_shapes, _, aux_shapes = out.infer_shape(
            **{i.list_outputs()[0]: j.shape
               for i, j in zip(inputs, args)})
        sdict = {i: j for i, j in zip(out.list_arguments(), arg_shapes)}
        sdict.update({name: shape for name, shape in
                      zip(out.list_auxiliary_states(), aux_shapes)})
        for _, v in self.collect_params().items():
            if v.name in sdict:
                v.shape = tuple(sdict[v.name])

    def _build_cache(self, *args):
        inputs, out = self._get_graph(*args)
        input_names = [i.list_outputs()[0] for i in inputs]
        all_params = {p.name: p for p in
                      self.collect_params().values()}
        param_names = [n for n in out.list_arguments()
                       if n not in input_names and n in all_params]
        self._cached_op = _CachedGraph(out, input_names)
        self._cached_params = {n: all_params[n] for n in param_names}
        self._cached_aux = {n: all_params[n]
                            for n in out.list_auxiliary_states()
                            if n in all_params}

    def _call_cached_op(self, *args):
        if self._cached_op is None:
            self._build_cache(*args)
        flat_args, fmt = _flatten(args)
        if fmt != self._in_format:
            raise ValueError("the inputs nest as %r, the traced graph as %r"
                             % (fmt, self._in_format))
        from .. import random as mx_random
        params = {n: p.data() for n, p in self._cached_params.items()}
        aux = {n: p.data() for n, p in self._cached_aux.items()}
        out = self._cached_op(flat_args, params, aux,
                              autograd.is_training(),
                              mx_random.next_key())
        return _regroup(out, self._out_format)[0]

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` + ``path-NNNN.params`` — the
        checkpoint layout of ``model.save_checkpoint`` (reference
        block.py:HybridBlock.export) — so a gluon-built network crosses
        to every symbolic surface: ``model.load_checkpoint`` →
        Module / Predictor / CompiledPredictor / ``parallel.TrainStep``
        (compose a loss head on the loaded symbol for training).

        Requires a completed hybrid trace: call ``hybridize()`` and run
        one forward first so the graph and parameter shapes exist."""
        if not self._cached_graph:
            raise RuntimeError(
                "export needs the traced graph: call hybridize() and "
                "run a forward pass first")
        from ..model import save_checkpoint
        sym = self._cached_graph[1]
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        all_params = self.collect_params().values()
        save_checkpoint(
            path, epoch, sym,
            {p.name: p.data() for p in all_params
             if p.name in arg_names},
            {p.name: p.data() for p in all_params
             if p.name in aux_names})
        return path

    def forward(self, x, *args):
        """Dispatch: hybrid path uses the cached compiled graph; eager
        path calls hybrid_forward with the ndarray namespace (reference
        block.py:HybridBlock.forward)."""
        if isinstance(x, NDArray):
            if self._active:
                try:
                    return self._call_cached_op(x, *args)
                except DeferredInitializationError:
                    self.infer_shape(x, *args)
                    for _, v in self.collect_params().items():
                        v._finish_deferred_init()
                    return self._call_cached_op(x, *args)
            try:
                params = {i: j.data() for i, j in
                          self._reg_params.items()}
            except DeferredInitializationError:
                self.infer_shape(x, *args)
                for _, v in self.collect_params().items():
                    v._finish_deferred_init()
                params = {i: j.data() for i, j in
                          self._reg_params.items()}
            return self.hybrid_forward(nd, x, *args, **params)

        assert isinstance(x, Symbol), \
            "HybridBlock requires the first argument to forward be " \
            "either Symbol or NDArray, but got %s" % type(x)
        params = {i: j.var() for i, j in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(sym_mod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Override: computation using namespace F (nd or sym)."""
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """Wrap a Symbol (e.g. loaded from JSON) as a Block (reference
    block.py:SymbolBlock)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, (Symbol,)) and \
                len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)

        syms, self._in_format = _flatten(inputs)
        out, self._out_format = _flatten(outputs)
        out = sym_mod.Group(out) if len(out) > 1 else out[0]

        input_names = set()
        for i in syms:
            assert len(i.list_outputs()) == 1, \
                "Input symbols must be variable, but %s is an output of " \
                "operators" % str(i)
            input_names.add(i.list_outputs()[0])

        for i in out.list_arguments():
            if i not in input_names:
                self.params.get(i, allow_deferred_init=True)
        for i in out.list_auxiliary_states():
            if i not in input_names:
                self.params.get(i, grad_req="null",
                                allow_deferred_init=True)

        self._cached_graph = (syms, out)
        self._build_cache_from_graph()

    def _build_cache_from_graph(self):
        inputs, out = self._cached_graph
        input_names = [i.list_outputs()[0] for i in inputs]
        all_params = {p.name: p for p in self.params.values()}
        param_names = [n for n in out.list_arguments()
                       if n not in input_names and n in all_params]
        self._cached_op = _CachedGraph(out, input_names)
        self._cached_params = {n: all_params[n] for n in param_names}
        self._cached_aux = {n: all_params[n]
                            for n in out.list_auxiliary_states()
                            if n in all_params}

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                return self._call_cached_op(x, *args)
            except DeferredInitializationError:
                # shapes come from the wrapped symbol itself, not a
                # hybrid trace — infer and finish init, then retry
                self._infer_param_shapes(x, *args)
                return self._call_cached_op(x, *args)
        assert isinstance(x, Symbol)
        # compose the wrapped graph onto the incoming symbols so a
        # SymbolBlock nests inside a hybridized parent (reference
        # SymbolBlock forward composes the cached graph)
        ret = copy.copy(self._cached_graph[1])
        names = [s.list_outputs()[0] for s in self._cached_graph[0]]
        ret._compose(**dict(zip(names, (x,) + args)))
        return ret

    def _infer_param_shapes(self, *inputs):
        syms, out = self._cached_graph
        feed = {s.list_outputs()[0]: tuple(i.shape)
                for s, i in zip(syms, inputs)}
        arg_shapes, _, aux_shapes = out.infer_shape(**feed)
        known = dict(zip(out.list_arguments(), arg_shapes))
        known.update(zip(out.list_auxiliary_states(), aux_shapes))
        for name, p in self.params.items():
            shape = known.get(name)
            if shape and (not p.shape or 0 in p.shape):
                p.shape = tuple(shape)
            p._finish_deferred_init()

    def _clear_cached_op(self):
        # a SymbolBlock's graph IS its definition (not re-derivable by
        # tracing): parent hybridize/cast cache clears must only drop
        # the compiled op, never the wrapped symbol
        graph = getattr(self, "_cached_graph", ())
        super()._clear_cached_op()
        self._cached_graph = graph

    def _call_cached_op(self, *args):
        if self._cached_op is None:
            self._build_cache_from_graph()
        return super()._call_cached_op(*args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
