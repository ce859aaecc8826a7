"""Symbolic-composition hooks for the ported ops: which tensor args an op
exposes under given attrs, and backward shape inference for parameter
(and aux) variables. The rules are those of
``mxnet_tpu/ops/shape_hooks.py``; the hooks of ops not ported yet
(RNN, the deformable and quantized contrib ops, the decode caches)
arrive with their ops.
"""
from __future__ import annotations

from .registry import set_arg_select, set_param_shapes


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


# -- FullyConnected ---------------------------------------------------------

set_arg_select("FullyConnected", lambda a: (
    ("data", "weight") if a.get("no_bias") else ("data", "weight", "bias")))


def _fc_shapes(shapes, attrs):
    data = shapes[0]
    nh = int(attrs.get("num_hidden", 0))
    if data is None:
        return shapes
    in_dim = _prod(data[1:]) if attrs.get("flatten", True) else data[-1]
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (nh, in_dim)
    if len(out) > 2 and out[2] is None:
        out[2] = (nh,)
    return out


set_param_shapes("FullyConnected", _fc_shapes)


# -- Convolution ------------------------------------------------------------

set_arg_select("Convolution", lambda a: (
    ("data", "weight") if a.get("no_bias") else ("data", "weight", "bias")))


def _conv_shapes(shapes, attrs):
    data = shapes[0]
    if data is None:
        return shapes
    kernel = tuple(int(k) for k in attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (nf, data[1] // ng) + kernel
    if len(out) > 2 and out[2] is None:
        out[2] = (nf,)
    return out


set_param_shapes("Convolution", _conv_shapes)

set_arg_select("Deconvolution", lambda a: (
    ("data", "weight") if a.get("no_bias", True)
    else ("data", "weight", "bias")))


def _deconv_shapes(shapes, attrs):
    data = shapes[0]
    if data is None:
        return shapes
    kernel = tuple(int(k) for k in attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        # reference layout: (in_channels, num_filter/g, kh, kw)
        out[1] = (data[1], nf // ng) + kernel
    if len(out) > 2 and out[2] is None:
        out[2] = (nf,)
    return out


set_param_shapes("Deconvolution", _deconv_shapes)


# -- BatchNorm: gamma, beta and the aux moving stats are (C,) ---------------

def _bn_shapes(shapes, attrs):
    data = shapes[0]
    if data is None:
        return shapes
    axis = int(attrs.get("axis", 1)) % len(data)
    c = (data[axis],)
    return [data] + [c if s is None else s for s in shapes[1:]]


set_param_shapes("BatchNorm", _bn_shapes)
set_param_shapes("InstanceNorm", _bn_shapes)


# -- LayerNorm --------------------------------------------------------------

def _ln_shapes(shapes, attrs):
    data = shapes[0]
    if data is None:
        return shapes
    axis = int(attrs.get("axis", -1)) % len(data)
    c = (data[axis],)
    return [data] + [c if s is None else s for s in shapes[1:]]


set_param_shapes("LayerNorm", _ln_shapes)


# -- Embedding --------------------------------------------------------------

def _embedding_shapes(shapes, attrs):
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (int(attrs.get("input_dim", 0)),
                  int(attrs.get("output_dim", 0)))
    return out


set_param_shapes("Embedding", _embedding_shapes)


# -- LeakyReLU (gamma only for prelu) ---------------------------------------

set_arg_select("LeakyReLU", lambda a: (
    ("data", "gamma") if a.get("act_type") == "prelu" else ("data",)))


def _prelu_shapes(shapes, attrs):
    data = shapes[0]
    out = list(shapes)
    if len(out) > 1 and out[1] is None and data is not None:
        out[1] = (data[1] if len(data) > 1 else 1,)
    return out


set_param_shapes("LeakyReLU", _prelu_shapes)


# -- Sequence ops: sequence_length only when enabled ------------------------

for _name in ("SequenceMask", "SequenceLast", "SequenceReverse"):
    set_arg_select(_name, lambda a: (
        ("data", "sequence_length") if a.get("use_sequence_length")
        else ("data",)))


# -- SoftmaxOutput: label shape from data shape -----------------------------
# (reference: SoftmaxOutputProp::InferShape — label = data shape minus the
# class axis)

def _softmax_label_shapes(shapes, attrs):
    data = shapes[0]
    out = list(shapes)
    if data is not None and len(out) > 1 and out[1] is None:
        if attrs.get("multi_output"):
            out[1] = (data[0],) + tuple(data[2:])
        elif attrs.get("preserve_shape"):
            out[1] = tuple(data[:-1])
        else:
            out[1] = (data[0],) if len(data) <= 2 else tuple(data[:-1])
    return out


set_param_shapes("SoftmaxOutput", _softmax_label_shapes)
set_param_shapes("SVMOutput", _softmax_label_shapes)


# -- regression heads: label shape = data shape -----------------------------

def _regression_label_shapes(shapes, attrs):
    data = shapes[0]
    out = list(shapes)
    if data is not None and len(out) > 1 and out[1] is None:
        out[1] = tuple(data)
    return out


for _name in ("LinearRegressionOutput", "MAERegressionOutput",
              "LogisticRegressionOutput"):
    set_param_shapes(_name, _regression_label_shapes)
