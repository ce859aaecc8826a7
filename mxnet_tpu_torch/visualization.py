"""Network visualization (``mx.viz``) — the PyTorch twin of
``mxnet_tpu/visualization.py`` (reference: python/mxnet/visualization.py,
print_summary and the graphviz plot_network), over the port's ``Symbol``.
``graphviz`` is imported only by ``plot_network``.
"""
from __future__ import annotations

from .symbol.symbol import Symbol, _topo_order

__all__ = ["print_summary", "plot_network"]


def _prod(t):
    out = 1
    for x in t:
        out *= int(x)
    return out


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Layer-table summary with per-layer output shapes and parameter
    counts (reference visualization.py:print_summary)."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    positions = [int(line_length * p) for p in positions]

    shapes = {}
    param_shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        shapes = dict(zip(internals.list_outputs(), out_shapes))
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
        param_shapes = dict(zip(symbol.list_arguments(), arg_shapes))
        param_shapes.update(zip(symbol.list_auxiliary_states(),
                                aux_shapes))

    heads = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def row(fields):
        line = ""
        for f, pos in zip(fields, positions):
            line = (line + str(f))[:pos - 1].ljust(pos)
        print(line.rstrip())

    print("=" * line_length)
    row(heads)
    print("=" * line_length)

    total = 0
    data_like = set(shape or ())
    for node in _topo_order(symbol._entries):
        if node.op is None:
            if node.name in data_like:
                row(["%s (null)" % node.name,
                     shapes.get(node.name + "_output",
                                (shape or {}).get(node.name, "")), 0, ""])
            continue
        out_shape = shapes.get("%s_output" % node.name) or \
            shapes.get("%s_output0" % node.name) or ""
        n_params = sum(
            _prod(param_shapes[m.name]) for (m, _i) in node.inputs
            if m.op is None and m.name not in data_like
            and "label" not in m.name and m.name in param_shapes)
        prev = ",".join(m.name for (m, _i) in node.inputs
                        if not (m.op is None and m.name not in data_like))
        row(["%s (%s)" % (node.name, node.op.name), out_shape,
             n_params, prev])
        total += n_params
    print("=" * line_length)
    print("Total params: %d" % total)
    print("=" * line_length)
    return total


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """graphviz Digraph of the symbol (reference
    visualization.py:plot_network). Requires the ``graphviz`` package."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError(
            "plot_network requires the graphviz python package") from e

    shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        shapes = dict(zip(internals.list_outputs(), out_shapes))

    node_attrs = dict({"shape": "box", "fixedsize": "false"},
                      **(node_attrs or {}))
    dot = Digraph(name=title, format=save_format)
    palette = {"Convolution": "#fb8072", "FullyConnected": "#fb8072",
               "BatchNorm": "#bebada", "Activation": "#ffffb3",
               "Pooling": "#80b1d3", "SoftmaxOutput": "#fccde5"}

    data_like = set(shape or ())
    for node in _topo_order(symbol._entries):
        if node.op is None:
            if node.name in data_like or not hide_weights:
                dot.node(node.name, node.name,
                         _attributes=dict(node_attrs,
                                          fillcolor="#8dd3c7",
                                          style="filled"))
            continue
        label = "%s\n%s" % (node.name, node.op.name)
        out_shape = shapes.get("%s_output" % node.name)
        if out_shape:
            label += "\n%s" % (tuple(out_shape),)
        dot.node(node.name, label,
                 _attributes=dict(node_attrs, style="filled",
                                  fillcolor=palette.get(node.op.name,
                                                        "#d9d9d9")))
        for (m, _i) in node.inputs:
            if m.op is None and hide_weights and m.name not in data_like:
                continue
            dot.edge(m.name, node.name)
    return dot
