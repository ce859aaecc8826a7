"""Symbol — the deferred computation graph; the PyTorch twin of
``mxnet_tpu/symbol/symbol.py``.

A Symbol is a lightweight DAG of registry ops. Graph building,
``list_arguments`` / ``list_outputs`` / ``list_auxiliary_states``, shape
inference and the JSON format are those of the JAX package, so a graph
saved by either package loads in the other. Shape inference runs each
node on ``meta`` tensors (shapes without storage) after the per-op
backward hooks fill parameter shapes — the role ``jax.eval_shape`` plays
there. The graph runs through ``executor._graph_eval_fn``, and binds
into an ``executor.Executor`` (``bind``/``simple_bind``, which allocates
through ``infer_shape`` and ``infer_type``). ``sym(...)`` composes: it
binds a copy's free variables to other symbols; ``load_json`` upgrades
the reference's pre-0.9 saves as it reads them.
"""
from __future__ import annotations

import ast
import json

import torch

from .. import attribute, name as _name_mod
from ..base import MXNetError, np_dtype, numeric_types, torch_dtype
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _Node:
    """One graph node: an op application or a variable (op is None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "is_aux", "misc_attrs",
                 "__weakref__")

    def __init__(self, op, name, attrs=None, inputs=(), is_aux=False,
                 misc_attrs=None):
        self.op = op                # OpDef | None (variable)
        self.name = name
        self.attrs = dict(attrs or {})        # canonical op attrs
        self.inputs = list(inputs)            # list[(node, out_idx)]
        self.is_aux = is_aux                  # variable feeding a state slot
        self.misc_attrs = dict(misc_attrs or {})  # user attrs (__ctx_group__…)

    def num_outputs(self):
        if self.op is None:
            return 1
        return _num_outputs(self.op, self.attrs)


def _num_outputs(opdef, attrs):
    """Visible output count for an op under given attrs (reference:
    nnvm num_outputs/num_visible_outputs registration)."""
    if opdef.name == "SliceChannel":
        return int(attrs.get("num_outputs", 1))
    if opdef.name == "topk" and attrs.get("ret_typ") == "both":
        return 2
    if opdef.name in ("BatchNorm", "LayerNorm"):
        return 3 if attrs.get("output_mean_var") else 1
    if opdef.name == "RNN":
        if not attrs.get("state_outputs"):
            return 1
        return 3 if attrs.get("mode", "lstm") == "lstm" else 2
    if opdef.name == "CTCLoss":
        return 1
    if opdef.name == "_linalg_gelqf":
        return 2
    if opdef.name == "Custom":
        from ..ops.custom import custom_num_outputs
        return custom_num_outputs(attrs)
    if opdef.num_visible is not None:
        return opdef.num_visible
    return 1


def _topo_order(entries):
    """Post-order DFS over the graph feeding `entries` (deterministic)."""
    order, seen = [], set()
    stack = [(e[0], False) for e in reversed(entries)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        for (n, _i) in reversed(node.inputs):
            if id(n) not in seen:
                stack.append((n, False))
    return order


class Symbol:
    """Symbol is the basic building block of the deferred graph."""

    __slots__ = ("_entries", "__weakref__")

    def __init__(self, entries):
        self._entries = list(entries)

    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def __repr__(self):
        if len(self._entries) == 1:
            return "<Symbol %s>" % self._entries[0][0].name
        return "<Symbol group [%s]>" % ", ".join(
            e[0].name for e in self._entries)

    def attr(self, key):
        """A single-output symbol's user attribute ``key``, else None."""
        if len(self._entries) == 1:
            return self._entries[0][0].misc_attrs.get(key)
        return None

    def attr_dict(self):
        """{node name: {attr: str value}} over the graph: user attrs
        (``__lr_mult__``, ``__wd_mult__``, ...) and op attrs."""
        out = {}
        for node in _topo_order(self._entries):
            d = dict(node.misc_attrs)
            if node.op is not None:
                d.update({k: str(v) for k, v in node.attrs.items()})
            if d:
                out[node.name] = d
        return out

    def _set_attr(self, **kwargs):
        if len(self._entries) != 1:
            raise ValueError("_set_attr only supports single-output symbols")
        self._entries[0][0].misc_attrs.update(kwargs)

    # -- introspection -------------------------------------------------------
    def list_arguments(self):
        return [n.name for n in _topo_order(self._entries)
                if n.op is None and not n.is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in _topo_order(self._entries)
                if n.op is None and n.is_aux]

    def get_internals(self):
        """Every output of every node of the graph, in topological order
        (reference symbol.py:232)."""
        entries = []
        for node in _topo_order(self._entries):
            for i in range(node.num_outputs()):
                entries.append((node, i))
        return Symbol(entries)

    def get_children(self):
        """The inputs of this symbol's nodes, or None for a variable."""
        children = []
        for e in self._entries:
            children.extend(e[0].inputs)
        return Symbol(children) if children else None

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError("no output named %r (outputs %r)"
                                 % (index, names))
            index = names.index(index)
        return Symbol([self._entries[index]])

    def __call__(self, *args, **kwargs):
        """Compose: bind this symbol's free variables to other symbols
        (reference symbol.py Symbol.__call__/_compose), on a copy."""
        s = self._deepcopy()
        s._compose(*args, **kwargs)
        return s

    def _deepcopy(self):
        mapping = {}
        for node in _topo_order(self._entries):
            new = _Node(node.op, node.name, node.attrs,
                        [(mapping[id(n)], i) for (n, i) in node.inputs],
                        node.is_aux, node.misc_attrs)
            mapping[id(node)] = new
        return Symbol([(mapping[id(n)], i) for (n, i) in self._entries])

    def __copy__(self):
        return self._deepcopy()

    def __deepcopy__(self, memo):
        return self._deepcopy()

    def _compose(self, *args, **kwargs):
        """Replace free variables in place: positional symbols take the
        free variables in topological order, keyword ones by name."""
        kwargs.pop("name", None)
        order = _topo_order(self._entries)
        by_name = {n.name: n for n in order if n.op is None}
        if args and kwargs:
            raise TypeError("compose only accepts input Symbols "
                            "either as positional or keyword arguments")
        if args:
            free = [n for n in order if n.op is None]
            if len(args) > len(free):
                raise TypeError("too many positional compose args")
            kwargs = {n.name: a for n, a in zip(free, args)}
        replace = {}
        for k, v in kwargs.items():
            if not isinstance(v, Symbol) or len(v._entries) != 1:
                raise TypeError("compose expects single-output Symbols")
            if k not in by_name:
                raise ValueError("no variable named %r in symbol" % k)
            replace[id(by_name[k])] = v._entries[0]
        for node in order:
            node.inputs = [replace.get(id(n), (n, i)) for (n, i) in
                           node.inputs]
        self._entries = [replace.get(id(n), (n, i)) for (n, i) in
                         self._entries]

    def list_outputs(self):
        outs = []
        for (node, idx) in self._entries:
            n_out = node.num_outputs()
            if node.op is None:
                outs.append(node.name)
            elif n_out == 1:
                outs.append(node.name + "_output")
            else:
                outs.append("%s_output%d" % (node.name, idx))
        return outs

    # -- shape inference -----------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        res = self._infer_shape_impl(False, *args, **kwargs)
        if res[0] is not None and any(
                s is None for s in res[0]):
            unknown = [n for n, s in zip(self.list_arguments(), res[0])
                       if s is None]
            raise MXNetError("cannot infer shapes for arguments %r — provide "
                             "their shapes" % (unknown,))
        return res

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        if args:
            arg_names = self.list_arguments()
            kwargs = dict(kwargs)
            for n, s in zip(arg_names, args):
                if s is not None:
                    kwargs[n] = s
        known = {k: tuple(int(d) for d in v) for k, v in kwargs.items()
                 if v is not None}
        shapes = _infer_graph(self._entries, known, partial=partial)
        arg_shapes = [shapes["var", n] for n in self.list_arguments()]
        aux_shapes = [shapes["var", n] for n in self.list_auxiliary_states()]
        out_shapes = [shapes["out", id(nd), i] for (nd, i) in self._entries]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """Same-dtype propagation through the graph (reference: the
        InferType pass; the JAX package's rule): dtype flows forward (the
        first known input dtype wins, Cast sets its own), then fills
        unknown variables backward; float32 where nothing is known.
        Returns numpy dtypes (``torch.bfloat16`` for bf16)."""
        if args:
            for n, t in zip(self.list_arguments(), args):
                if t is not None:
                    kwargs[n] = t
        known_t = {k: np_dtype(v) for k, v in kwargs.items() if v is not None}
        order = _topo_order(self._entries)
        dt = {}
        for node in order:
            if node.op is None:
                d = known_t.get(node.name)
                if d is None and node.misc_attrs.get("__dtype__"):
                    d = np_dtype(node.misc_attrs["__dtype__"])
                dt[id(node)] = d
        for _ in range(2):  # forward then backward fill, then re-forward
            for node in order:
                if node.op is None:
                    continue
                in_dts = [dt.get(id(m)) for (m, _i) in node.inputs]
                base = next((d for d in in_dts if d is not None), None)
                if node.op.name == "Cast":
                    dt[id(node)] = np_dtype(node.attrs.get("dtype",
                                                           "float32"))
                elif base is not None:
                    dt[id(node)] = base
                if base is not None:
                    for (m, _i) in node.inputs:
                        if dt.get(id(m)) is None:
                            dt[id(m)] = base
        default = np_dtype("float32")
        name2node = {n.name: n for n in order if n.op is None}
        arg_t = [dt.get(id(name2node[n])) or default
                 for n in self.list_arguments()]
        aux_t = [dt.get(id(name2node[n])) or default
                 for n in self.list_auxiliary_states()]
        out_t = [dt.get(id(nd)) or default for (nd, _i) in self._entries]
        return arg_t, out_t, aux_t

    def debug_str(self):
        lines = []
        for n in _topo_order(self._entries):
            if n.op is None:
                lines.append("Variable:%s" % n.name)
            else:
                ins = ", ".join("%s[%d]" % (m.name, i) for m, i in n.inputs)
                lines.append("Op:%s, Name=%s\nInputs:\n\t%s"
                             % (n.op.name, n.name, ins))
        return "\n".join(lines)

    # -- binding (reference symbol.py:366-383) -------------------------------
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor
        return Executor(self, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_arg_names=None, shared_exec=None,
                    shared_buffer=None, **kwargs):
        """Bind with zero arrays allocated from the shapes given (and the
        ones ``infer_shape`` derives) and ``infer_type``'s dtypes."""
        from ..executor import Executor
        return Executor._simple_bind(self, ctx, grad_req=grad_req,
                                     type_dict=type_dict,
                                     group2ctx=group2ctx, **kwargs)

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx, kwargs, grad_req="null")
        return ex.forward()

    # -- serialization -------------------------------------------------------
    def tojson(self):
        nodes = _topo_order(self._entries)
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        arg_nodes = []
        for i, n in enumerate(nodes):
            if n.op is None:
                arg_nodes.append(i)
                entry = {"op": "null", "name": n.name, "inputs": []}
                if n.is_aux:
                    entry.setdefault("attrs", {})["__is_aux__"] = "True"
            else:
                entry = {"op": n.op.name, "name": n.name,
                         "inputs": [[nid[id(m)], oi, 0]
                                    for (m, oi) in n.inputs]}
                if n.attrs:
                    entry["attrs"] = {k: json.dumps(v) if not
                                      isinstance(v, str) else v
                                      for k, v in n.attrs.items()}
            if n.misc_attrs:
                entry.setdefault("attrs", {}).update(
                    {k: str(v) for k, v in n.misc_attrs.items()})
            jnodes.append(entry)
        heads = [[nid[id(nd)], i, 0] for (nd, i) in self._entries]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 1100]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        return _sym_binary("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _sym_binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _sym_scalar("_rminus_scalar", self, other)

    def __mul__(self, other):
        return _sym_binary("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _sym_binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _sym_scalar("_rdiv_scalar", self, other)

    def __mod__(self, other):
        return _sym_binary("broadcast_mod", "_mod_scalar", self, other)

    def __pow__(self, other):
        return _sym_binary("broadcast_power", "_power_scalar", self, other)

    def __neg__(self):
        return _sym_invoke(_reg.get_op("negative"), [self], {}, None)

    def __abs__(self):
        return _sym_invoke(_reg.get_op("abs"), [self], {}, None)

    def __eq__(self, other):
        return _sym_binary("broadcast_equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        return _sym_binary("broadcast_not_equal", "_not_equal_scalar", self,
                           other)

    def __gt__(self, other):
        return _sym_binary("broadcast_greater", "_greater_scalar", self,
                           other)

    def __ge__(self, other):
        return _sym_binary("broadcast_greater_equal",
                           "_greater_equal_scalar", self, other)

    def __lt__(self, other):
        return _sym_binary("broadcast_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _sym_binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                           self, other)

    def __hash__(self):
        return id(self)


# ---------------------------------------------------------------------------
# composition internals
# ---------------------------------------------------------------------------

def _sym_binary(tensor_op, scalar_op, lhs, rhs):
    if isinstance(rhs, Symbol):
        return _sym_invoke(_reg.get_op(tensor_op), [lhs, rhs], {}, None)
    if isinstance(rhs, numeric_types):
        return _sym_invoke(_reg.get_op(scalar_op), [lhs],
                           {"scalar": float(rhs)}, None)
    raise TypeError("unsupported operand type %s" % type(rhs))


def _sym_scalar(scalar_op, lhs, rhs):
    if isinstance(rhs, numeric_types):
        return _sym_invoke(_reg.get_op(scalar_op), [lhs],
                           {"scalar": float(rhs)}, None)
    raise TypeError("unsupported operand type %s" % type(rhs))


def _sym_invoke(opdef, inputs, attrs, name, kw_inputs=None):
    """Create a graph node applying `opdef`, auto-creating variables for
    missing parameter inputs (reference: compose with auto var creation)."""
    attrs = _reg.canon_attrs(opdef, attrs)
    hint = opdef.name.lower().lstrip("_")
    name = _name_mod.current().get(name, hint)
    misc = attribute.current().get(None)

    entries = []
    if opdef.arg_names is None:
        for s in inputs:
            if len(s._entries) != 1:
                entries.extend(s._entries)
            else:
                entries.append(s._entries[0])
    else:
        active = list(opdef.active_args(attrs))
        kw_inputs = kw_inputs or {}
        for k in kw_inputs:
            if k not in active:
                raise TypeError(
                    "%s: input %r is not active under attrs %r (active "
                    "args: %r)" % (opdef.name, k, attrs, active))
        provided = list(inputs)
        full_names = list(opdef.arg_names)
        aux_idx = set(opdef.state_inputs)
        slot_syms = {}
        pos = 0
        for an in active:
            if an in kw_inputs:
                slot_syms[an] = kw_inputs[an]
            elif pos < len(provided):
                slot_syms[an] = provided[pos]
                pos += 1
            else:
                slot_syms[an] = None
        if pos < len(provided):
            raise TypeError("%s: too many symbol inputs (%d given, active "
                            "args %r)" % (opdef.name, len(provided), active))
        for an in active:
            s = slot_syms[an]
            if s is None:
                is_aux = full_names.index(an) in aux_idx
                node = _Node(None, "%s_%s" % (name, an), is_aux=is_aux,
                             misc_attrs=misc)
                entries.append((node, 0))
            else:
                if not isinstance(s, Symbol):
                    raise TypeError("%s: input %r must be a Symbol, got %s"
                                    % (opdef.name, an, type(s)))
                if len(s._entries) != 1:
                    raise TypeError("%s: input %r must be single-output"
                                    % (opdef.name, an))
                ent = s._entries[0]
                if ent[0].op is None and full_names.index(an) in aux_idx:
                    ent[0].is_aux = True
                entries.append(ent)

    node = _Node(opdef, name, attrs, entries, misc_attrs=misc)
    n_out = node.num_outputs()
    return Symbol([(node, i) for i in range(n_out)]) if n_out > 1 \
        else Symbol([(node, 0)])


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """Create a symbolic variable (reference symbol.py `var`); ``shape``
    rides the graph as the ``__shape__`` attribute shape inference reads,
    and dtype / lr_mult / wd_mult / init (an initializer, stored as its
    ``dumps()``) and any ``__dunder__`` keyword as their attributes, as
    the JAX package writes them."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    misc = attribute.current().get(attr or {})
    if shape is not None:
        misc["__shape__"] = str(tuple(shape))
    if dtype is not None:
        misc["__dtype__"] = str(np_dtype(dtype).name if dtype else "")
    if lr_mult is not None:
        misc["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        misc["__wd_mult__"] = str(wd_mult)
    if init is not None:
        misc["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            misc[k] = str(v)
    return Symbol([(_Node(None, name, misc_attrs=misc), 0)])


var = Variable


def Group(symbols):
    """One symbol whose outputs are those of ``symbols``, in order."""
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


# pre-0.9 checkpoints store these per-node without the __dunder__ wrapping
# (reference: kHiddenKeys, src/nnvm/legacy_json_util.cc:24)
_LEGACY_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                       "mirror_stage")


def load_json(json_str):
    """Parse a symbol JSON as ``tojson`` (of either package) writes it,
    upgrading pre-0.9 saves on the fly (reference: the UpgradeJSON_*
    passes, src/nnvm/legacy_json_util.cc): ``param`` dicts become attrs,
    bare hidden keys (lr_mult, ctx_group, ...) become ``__dunder__``
    attrs, and layer nodes saved without their parameter inputs get
    their variables (v0.8 graphs stored only data edges)."""
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attrs = dict(jn.get("attrs", jn.get("param", {})) or {})
        for key in _LEGACY_HIDDEN_KEYS:
            if key in attrs:
                attrs["__%s__" % key] = attrs.pop(key)
        misc = {k: v for k, v in attrs.items()
                if k.startswith("__") and k.endswith("__")}
        op_attrs = {k: v for k, v in attrs.items() if k not in misc}
        if jn["op"] == "null":
            node = _Node(None, jn["name"],
                         is_aux=misc.pop("__is_aux__", "False") == "True",
                         misc_attrs=misc)
        else:
            opdef = _reg.get_op(jn["op"])
            canon = _reg.canon_attrs(opdef, op_attrs)
            inputs = [(nodes[i], oi) for (i, oi, *_v) in jn["inputs"]]
            expected = opdef.active_args(canon)
            if expected is not None and len(inputs) < len(expected):
                # v0.8 upgrade (UpgradeJSON_000800_000900): the missing
                # parameter inputs as new variables, kept out of `nodes`
                # (JSON ids index the original table); state slots (BN
                # moving stats) become aux variables
                aux_slots = set(opdef.state_inputs)
                inputs += [
                    (_Node(None, "%s_%s" % (jn["name"], arg),
                           is_aux=expected.index(arg) in aux_slots), 0)
                    for arg in expected[len(inputs):]]
            node = _Node(opdef, jn["name"], canon, inputs, misc_attrs=misc)
        nodes.append(node)
    heads = data.get("heads") or [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[i], oi) for (i, oi, *_v) in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------------------
# shape inference over the graph
# ---------------------------------------------------------------------------

def _var_dtype(node):
    dt = node.misc_attrs.get("__dtype__")
    return torch_dtype(dt) if dt else None


def _infer_graph(entries, known_shapes, partial=False):
    """Propagate shapes through the graph. Returns a dict mapping
    ("var", name) and ("out", id(node), i) to tuples (None if unknown)."""
    shapes = {}
    dtypes = {}
    for node in _topo_order(entries):
        if node.op is None:
            shp = known_shapes.get(node.name)
            if shp is None and "__shape__" in node.misc_attrs:
                shp = tuple(ast.literal_eval(node.misc_attrs["__shape__"]))
            if shp is not None and any(int(d) == 0 for d in shp):
                # reference convention: 0 dims mean unknown (gluon
                # deferred init) — let the param_shapes hooks fill them
                shp = None
            shapes["var", node.name] = shp
            shapes["out", id(node), 0] = shp
            dtypes["out", id(node), 0] = _var_dtype(node)
            continue

        in_shapes = [shapes.get(("out", id(m), i)) for (m, i) in node.inputs]
        if node.op.param_shapes is not None and any(
                s is None for s in in_shapes):
            try:
                filled = node.op.param_shapes(list(in_shapes), node.attrs)
            except Exception:
                filled = in_shapes
            for (m, i), s_old, s_new in zip(node.inputs, in_shapes, filled):
                if s_old is None and s_new is not None:
                    s_new = tuple(int(d) for d in s_new)
                    shapes["out", id(m), i] = s_new
                    if m.op is None:
                        shapes["var", m.name] = s_new
            in_shapes = [shapes.get(("out", id(m), i))
                         for (m, i) in node.inputs]

        if any(s is None for s in in_shapes):
            if not partial:
                missing = [m.name for (m, _i), s in
                           zip(node.inputs, in_shapes) if s is None]
                raise MXNetError(
                    "infer_shape: inputs %r of op %s(%s) have unknown "
                    "shapes" % (missing, node.op.name, node.name))
            for i in range(node.num_outputs()):
                shapes["out", id(node), i] = None
            continue

        # abstract evaluation of this single node on meta tensors
        in_dtypes = [dtypes.get(("out", id(m), i)) for (m, i) in node.inputs]
        base_dt = next((d for d in in_dtypes if d is not None),
                       torch.float32)
        metas = [torch.empty(s, dtype=d or base_dt, device="meta")
                 for s, d in zip(in_shapes, in_dtypes)]
        attrs = dict(node.attrs)
        if node.op.takes_is_train:
            attrs["is_train"] = True
        if node.op.needs_rng:
            attrs["rng"] = None       # meta tensors draw no random bits
        if not metas:
            attrs["device"] = "meta"  # a creation op
        try:
            out = node.op.fn(*metas, **attrs)
        except Exception as e:
            raise MXNetError(
                "infer_shape failed at op %s(%s) with input shapes %r: %s"
                % (node.op.name, node.name, in_shapes, e)) from None
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if node.op.num_state:
            outs = outs[:-node.op.num_state]
        for i, o in enumerate(outs):
            shapes["out", id(node), i] = tuple(o.shape)
            dtypes["out", id(node), i] = o.dtype
    return shapes
