"""Gluon convolution/pooling layers — the PyTorch twin of
``mxnet_tpu/gluon/nn/conv_layers.py`` (reference:
python/mxnet/gluon/nn/conv_layers.py, 1011 LoC)."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """Base conv layer (reference conv_layers.py:_Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution",
                 adj=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            dim = len(kernel_size)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides,
                "dilate": dilation, "pad": padding,
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj

            # a grouped weight holds 1/groups of the other side's
            # channels (reference conv_layers.py:_Conv); 0 stays unknown
            if op_name == "Convolution":
                wshape = [channels, in_channels // groups] + \
                    list(kernel_size)
            else:  # Deconvolution: weight is (in, out / groups, *k)
                wshape = [in_channels, channels // groups] + \
                    list(kernel_size)
            self.weight = self.params.get(
                "weight", shape=tuple(wshape), init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, **self._kwargs)
        else:
            act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride})"
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(
                            self._in_channels if self._in_channels
                            else None, self._channels),
                        **self._kwargs)


class Conv1D(_Conv):
    """1D conv (reference conv_layers.py:Conv1D)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _tuple(kernel_size, 1)
        super().__init__(channels, kernel_size, _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    """2D conv (reference conv_layers.py:Conv2D)."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _tuple(kernel_size, 2)
        super().__init__(channels, kernel_size, _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    """3D conv (reference conv_layers.py:Conv3D)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _tuple(kernel_size, 3)
        super().__init__(channels, kernel_size, _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    """1D transposed conv (reference
    conv_layers.py:Conv1DTranspose)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _tuple(kernel_size, 1)
        super().__init__(channels, kernel_size, _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    """2D transposed conv (reference
    conv_layers.py:Conv2DTranspose)."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _tuple(kernel_size, 2)
        super().__init__(channels, kernel_size, _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    """3D transposed conv (reference
    conv_layers.py:Conv3DTranspose)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _tuple(kernel_size, 3)
        super().__init__(channels, kernel_size, _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """Base pooling layer (reference conv_layers.py:_Pooling)."""

    def __init__(self, pool_size, strides, padding, ceil_mode,
                 global_pool, pool_type, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        s = "{name}(size={kernel}, stride={stride}, padding={pad}, " \
            "ceil_mode={ceil_mode})"
        return s.format(
            name=self.__class__.__name__,
            ceil_mode=self._kwargs["pooling_convention"] == "full",
            **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 layout="NCW", ceil_mode=False, **kwargs):
        assert layout == "NCW", "Only supports NCW layout for now"
        super().__init__(_tuple(pool_size, 1), strides, padding,
                         ceil_mode, False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout == "NCHW", "Only supports NCHW layout for now"
        super().__init__(_tuple(pool_size, 2), strides, padding,
                         ceil_mode, False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        assert layout == "NCDHW", "Only supports NCDHW layout for now"
        super().__init__(_tuple(pool_size, 3), strides, padding,
                         ceil_mode, False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 layout="NCW", ceil_mode=False, **kwargs):
        assert layout == "NCW", "Only supports NCW layout for now"
        super().__init__(_tuple(pool_size, 1), strides, padding,
                         ceil_mode, False, "avg", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout == "NCHW", "Only supports NCHW layout for now"
        super().__init__(_tuple(pool_size, 2), strides, padding,
                         ceil_mode, False, "avg", **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        assert layout == "NCDHW", "Only supports NCDHW layout for now"
        super().__init__(_tuple(pool_size, 3), strides, padding,
                         ceil_mode, False, "avg", **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "max", **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "avg", **kwargs)
