"""The PyTorch port's ops against the JAX package's registry functions.

One parametrised forward sweep: the same numpy-seeded inputs go through
``mxnet_tpu``'s op and ``mxnet_tpu_torch``'s op of the same name, with
attrs canonicalized by each package's registry; float32 outputs must
agree within rtol 1e-5 / atol 1e-6 (different summation orders on the
CPU), integer outputs exactly. An op that draws random numbers gets each
package's threefry key of one seed, so Dropout's masks and the samplers'
draws are compared as any output; the rejection samplers (gamma,
poisson, the negative binomials) by their means and the share of draws
within tolerance (``DRAW_MOMENT_TOL``). The loss heads' custom backward
passes are held against ``jax.vjp`` of the JAX ops with the same
cotangent (float32 within the same tolerance; bf16 within rtol 1e-2 /
atol 1e-6 relative to the gradient, one bf16 rounding step), and the
initializers after one ``mx.random.seed`` must fill bit-identical
values.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx  # (populates the port's registry)
from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.ops import loss as tloss
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids(shape, hi, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(
        np.float32)


# (case id, op name, inputs, attrs)
CASES = [
    ("broadcast_add", "broadcast_add",
     [_f32(2, 3, 4), _f32(3, 1, seed=1)], {}),
    ("broadcast_add_alias_plus", "_plus",
     [_f32(5, 1), _f32(1, 6, seed=1)], {}),
    ("elemwise_add", "elemwise_add", [_f32(4, 3), _f32(4, 3, seed=1)], {}),
    ("broadcast_add_int", "broadcast_add",
     [np.arange(6, dtype=np.int32).reshape(2, 3),
      np.arange(3, dtype=np.int32)], {}),
    ("plus_scalar", "_plus_scalar", [_f32(3, 4)], {"scalar": 1.5}),
    ("plus_scalar_int", "_plus_scalar",
     [np.arange(6, dtype=np.int32)], {"scalar": 2.7}),
    ("plus_scalar_string_attr", "_PlusScalar", [_f32(2, 2)],
     {"scalar": "-0.25"}),
    ("broadcast_mul", "broadcast_mul",
     [_f32(2, 3, 4), _f32(3, 1, seed=1)], {}),
    ("broadcast_mul_channel_scale", "broadcast_mul",
     [_f32(1, 4, 1, 1), _f32(2, 4, 3, 3, seed=1)], {}),
    ("elemwise_mul", "elemwise_mul", [_f32(4, 3), _f32(4, 3, seed=1)], {}),
    ("mul_alias", "_Mul", [_f32(5, 1), _f32(1, 6, seed=1)], {}),
    ("mul_scalar", "_mul_scalar", [_f32(3, 4)], {"scalar": 20.0}),
    ("mul_scalar_int", "_MulScalar", [np.arange(6, dtype=np.int32)],
     {"scalar": 2.7}),
    ("concat", "Concat",
     [_f32(2, 3, 4), _f32(2, 5, 4, seed=1), _f32(2, 1, 4, seed=2)],
     {"dim": 1, "num_args": 3}),
    ("concat_dim0", "concat", [_f32(2, 3), _f32(4, 3, seed=1)],
     {"dim": 0, "num_args": 2}),
    ("l2norm_instance", "L2Normalization", [_f32(2, 3, 4, 5)], {}),
    ("l2norm_channel", "L2Normalization", [_f32(2, 3, 4, 5)],
     {"mode": "channel"}),
    ("l2norm_spatial", "L2Normalization", [_f32(2, 3, 4, 5)],
     {"mode": "spatial", "eps": 1e-6}),
    ("softmax", "softmax", [_f32(3, 7) * 3], {}),
    ("softmax_axis_temperature", "softmax", [_f32(2, 5, 4)],
     {"axis": 1, "temperature": 2.0}),
    ("softmax_activation", "SoftmaxActivation", [_f32(2, 3, 4)], {}),
    ("softmax_activation_channel", "SoftmaxActivation", [_f32(2, 5, 3, 3)],
     {"mode": "channel"}),
    ("multibox_prior", "_contrib_MultiBoxPrior", [_f32(1, 2, 5, 6)],
     {"sizes": (0.2, 0.4), "ratios": (1, 2, 0.5)}),
    ("multibox_prior_steps_offsets_clip", "MultiBoxPrior", [_f32(2, 3, 4, 4)],
     {"sizes": (0.5, 0.9), "ratios": (1, 3), "steps": (0.3, 0.25),
      "offsets": (0.4, 0.6), "clip": True}),
    ("multibox_detection", "_contrib_MultiBoxDetection",
     [np.abs(_f32(2, 4, 40)) / 2, _f32(2, 160, seed=1) * 0.1,
      np.sort(np.random.RandomState(2).rand(1, 40, 2, 2).astype(
          np.float32), axis=2).transpose(0, 1, 3, 2).reshape(1, 40, 4)],
     {"nms_threshold": 0.3, "threshold": 0.1, "impl": "xla"}),
    ("reshape_copy_infer", "reshape", [_f32(2, 3, 4)], {"shape": (0, -1)}),
    ("reshape_copy_rest", "reshape", [_f32(2, 3, 4)],
     {"shape": (-2,)}),
    ("reshape_merge", "reshape", [_f32(2, 3, 4)], {"shape": (-3, -2)}),
    ("reshape_merge_all", "reshape", [_f32(2, 3, 4)], {"shape": (-3, 0)}),
    ("reshape_split", "reshape", [_f32(6, 4)], {"shape": (-4, 2, -1, 0)}),
    ("reshape_split_infer_first", "reshape", [_f32(6, 4)],
     {"shape": (-4, -1, 3, -2)}),
    ("reshape_literal", "reshape", [_f32(2, 3, 4)], {"shape": (4, 6)}),
    ("reshape_heads", "reshape", [_f32(2, 5, 12)],
     {"shape": (0, 0, 3, 4)}),
    ("reshape_flat", "reshape", [_f32(2, 3, 4)], {"shape": (-1,)}),
    ("reshape_reverse", "Reshape", [_f32(10, 5, 4)],
     {"shape": (-1, 0), "reverse": True}),
    ("reshape_empty_shape", "reshape", [_f32(2, 3)], {}),
    ("transpose_axes", "transpose", [_f32(2, 3, 4, 5)],
     {"axes": (0, 2, 1, 3)}),
    ("transpose_default", "transpose", [_f32(2, 3, 4)], {}),
    ("expand_dims_0", "expand_dims", [_f32(3, 4)], {"axis": 0}),
    ("expand_dims_neg", "expand_dims", [_f32(3, 4)], {"axis": -1}),
    ("expand_dims_mid", "expand_dims", [_f32(3, 4)], {"axis": 1}),
    ("slice_axis", "slice_axis", [_f32(2, 5, 9)],
     {"axis": 2, "begin": 1, "end": 6}),
    ("slice_axis_end_none", "slice_axis", [_f32(7, 3)],
     {"axis": 0, "begin": 2, "end": None}),
    ("slice_axis_negative", "slice_axis", [_f32(7, 3)],
     {"axis": 0, "begin": -4, "end": -1}),
    ("embedding", "Embedding", [_ids((2, 5), 10), _f32(10, 6)],
     {"input_dim": 10, "output_dim": 6}),
    ("embedding_float_ids", "Embedding",
     [np.array([[0.0, 2.7], [9.2, 3.0]], np.float32), _f32(10, 4)],
     {"input_dim": 10, "output_dim": 4}),
    ("embedding_out_of_range", "Embedding",
     [np.array([1.0, 10.0, -1.0, 3.0], np.float32), _f32(10, 4)],
     {"input_dim": 10, "output_dim": 4}),
    ("take_clip", "take", [_f32(6, 3), np.array([0.0, 5.0, 9.0, -2.0],
                                                np.float32)], {}),
    ("take_wrap", "take", [_f32(6, 3), np.array([[1.0, 7.0], [-1.0, 4.0]],
                                                np.float32)],
     {"mode": "wrap"}),
    ("take_axis1", "take", [_f32(4, 5, 2), np.array([4.0, 0.0], np.float32)],
     {"axis": 1}),
    ("fc_flatten", "FullyConnected",
     [_f32(3, 2, 4, 5), _f32(7, 40, seed=1), _f32(7, seed=2)],
     {"num_hidden": 7}),
    ("fc_no_flatten", "FullyConnected",
     [_f32(2, 5, 8), _f32(6, 8, seed=1), _f32(6, seed=2)],
     {"num_hidden": 6, "flatten": False}),
    ("fc_no_bias", "FullyConnected", [_f32(4, 8), _f32(3, 8, seed=1)],
     {"num_hidden": 3, "no_bias": True}),
    ("layernorm", "LayerNorm",
     [_f32(2, 5, 8), _f32(8, seed=1), _f32(8, seed=2)], {}),
    ("layernorm_axis1", "LayerNorm",
     [_f32(3, 6, 4), _f32(6, seed=1), _f32(6, seed=2)],
     {"axis": 1, "eps": 1e-3}),
    ("layernorm_mean_var", "LayerNorm",
     [_f32(4, 7), _f32(7, seed=1), _f32(7, seed=2)],
     {"output_mean_var": True}),
    ("act_relu", "Activation", [_f32(3, 5)], {"act_type": "relu"}),
    ("act_sigmoid", "Activation", [_f32(3, 5)], {"act_type": "sigmoid"}),
    ("act_tanh", "Activation", [_f32(3, 5)], {"act_type": "tanh"}),
    ("act_softrelu", "Activation", [_f32(3, 5) * 10],
     {"act_type": "softrelu"}),
    ("act_softsign", "Activation", [_f32(3, 5)], {"act_type": "softsign"}),
    ("identity", "identity", [_f32(3, 4)], {}),
    ("copy", "_copy", [_f32(2, 3, 2)], {}),
    ("flatten", "Flatten", [_f32(2, 3, 4, 5)], {}),
    ("flatten_alias", "flatten", [_f32(3, 7)], {}),
    ("conv2d", "Convolution", [_f32(2, 3, 9, 8), _f32(4, 3, 3, 3, seed=1),
                               _f32(4, seed=2)],
     {"kernel": (3, 3), "num_filter": 4}),
    ("conv2d_stride_pad_no_bias", "Convolution",
     [_f32(2, 3, 11, 10), _f32(5, 3, 3, 3, seed=1)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "num_filter": 5,
      "no_bias": True}),
    ("conv2d_stem", "Convolution", [_f32(1, 3, 20, 20),
                                    _f32(4, 3, 7, 7, seed=1)],
     {"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3), "num_filter": 4,
      "no_bias": True}),
    ("conv2d_dilate_group", "Convolution",
     [_f32(2, 4, 10, 9), _f32(6, 2, 3, 3, seed=1), _f32(6, seed=2)],
     {"kernel": (3, 3), "dilate": (2, 1), "num_group": 2, "num_filter": 6}),
    ("conv1d", "Convolution", [_f32(2, 3, 12), _f32(4, 3, 3, seed=1),
                               _f32(4, seed=2)],
     {"kernel": (3,), "stride": (2,), "pad": (1,), "num_filter": 4}),
    ("conv3d", "Convolution", [_f32(1, 2, 5, 6, 5),
                               _f32(3, 2, 2, 3, 2, seed=1), _f32(3, seed=2)],
     {"kernel": (2, 3, 2), "stride": (1, 2, 1), "num_filter": 3}),
    ("conv_v1_string_attrs", "Convolution_v1",
     [_f32(1, 2, 6, 6), _f32(3, 2, 1, 1, seed=1)],
     {"kernel": "(1, 1)", "num_filter": "3", "no_bias": "True"}),
    ("pool_max", "Pooling", [_f32(2, 3, 9, 8)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
    ("pool_max_full", "Pooling", [_f32(2, 3, 10, 9)],
     {"kernel": (3, 3), "stride": (2, 2), "pooling_convention": "full"}),
    ("pool_max_big_pad", "Pooling", [_f32(1, 2, 7, 7)],
     {"kernel": (2, 2), "stride": (1, 1), "pad": (2, 1)}),
    ("pool_avg_pad", "Pooling", [_f32(2, 3, 7, 6)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
      "pool_type": "avg"}),
    ("pool_avg_full", "Pooling", [_f32(1, 2, 8, 7)],
     {"kernel": (3, 2), "stride": (2, 2), "pool_type": "avg",
      "pooling_convention": "full"}),
    ("pool_sum", "Pooling", [_f32(2, 3, 6, 6)],
     {"kernel": (2, 2), "stride": (2, 1), "pool_type": "sum"}),
    ("pool_global_avg", "Pooling", [_f32(2, 5, 7, 7)],
     {"global_pool": True, "kernel": (7, 7), "pool_type": "avg"}),
    ("pool_global_max", "Pooling_v1", [_f32(2, 5, 4, 3)],
     {"global_pool": True, "pool_type": "max"}),
    ("pool_1d", "Pooling", [_f32(2, 3, 11)],
     {"kernel": (3,), "stride": (2,), "pad": (1,), "pool_type": "avg"}),
    ("pool_3d", "Pooling", [_f32(1, 2, 5, 6, 5)],
     {"kernel": (2, 2, 2), "stride": (2, 2, 2), "pool_type": "max"}),
    ("batchnorm_inference", "BatchNorm",
     [_f32(2, 3, 4, 5), _f32(3, seed=1), _f32(3, seed=2), _f32(3, seed=3),
      np.abs(_f32(3, seed=4)) + 0.5], {"fix_gamma": False}),
    ("batchnorm_v1_mean_var", "BatchNorm_v1",
     [_f32(2, 3, 4), _f32(3, seed=1), _f32(3, seed=2), _f32(3, seed=3),
      np.abs(_f32(3, seed=4)) + 0.5], {"output_mean_var": True}),
    ("softmax_output", "SoftmaxOutput", [_f32(6, 10) * 3, _ids((6,), 10)],
     {}),
    ("softmax_output_multi", "SoftmaxOutput",
     [_f32(2, 5, 3), _ids((2, 3), 5)], {"multi_output": True}),
    ("softmax_alias", "Softmax", [_f32(4, 9), _ids((4,), 9)],
     {"use_ignore": True, "normalization": "valid"}),
    ("flash_attention_op", "_contrib_FlashAttention",
     [_f32(1, 2, 24, 8), _f32(1, 2, 24, 8, seed=1),
      _f32(1, 2, 24, 8, seed=2)],
     {"causal": True, "block_q": 8, "block_k": 8}),
    ("make_loss", "MakeLoss", [_f32(3, 4)], {"grad_scale": 2.0}),
    ("linear_regression", "LinearRegressionOutput",
     [_f32(4, 3), _f32(4, 3, seed=1)], {}),
    ("mae_regression", "MAERegressionOutput",
     [_f32(4, 3), _f32(4, 3, seed=1)], {"grad_scale": 0.5}),
    ("logistic_regression", "LogisticRegressionOutput",
     [_f32(4, 3), _f32(4, 3, seed=1)], {}),
    # fused optimizer updates: weight, grad, state slots
    ("sgd_update", "sgd_update", [_f32(5, 4), _f32(5, 4, seed=1)],
     {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}),
    ("sgd_update_clip", "sgd_update", [_f32(5, 4), _f32(5, 4, seed=1) * 4],
     {"lr": 0.1, "clip_gradient": 1.0}),
    ("sgd_mom_update", "sgd_mom_update",
     [_f32(5, 4), _f32(5, 4, seed=1), _f32(5, 4, seed=2)],
     {"lr": 0.1, "momentum": 0.9, "wd": 1e-3, "rescale_grad": 0.25,
      "clip_gradient": 0.3}),
    ("mp_sgd_update", "mp_sgd_update",
     [_f32(5, 4), _f32(5, 4, seed=1), _f32(5, 4, seed=2)],
     {"lr": 0.2, "wd": 1e-2}),
    ("mp_sgd_mom_update", "mp_sgd_mom_update",
     [_f32(5, 4), _f32(5, 4, seed=1), _f32(5, 4, seed=2),
      _f32(5, 4, seed=3)],
     {"lr": 0.2, "momentum": 0.8, "clip_gradient": 0.5}),
    ("adam_update", "adam_update",
     [_f32(5, 4), _f32(5, 4, seed=1), _f32(5, 4, seed=2) * 0.1,
      np.abs(_f32(5, 4, seed=3)) * 0.01],
     {"lr": 1e-3, "wd": 1e-2, "rescale_grad": 0.125}),
    ("adam_update_clip", "adam_update",
     [_f32(5, 4), _f32(5, 4, seed=1) * 3, np.zeros((5, 4), np.float32),
      np.zeros((5, 4), np.float32)],
     {"lr": 1e-2, "beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6,
      "clip_gradient": 1.0}),
    ("rmsprop_update", "rmsprop_update",
     [_f32(5, 4), _f32(5, 4, seed=1), np.abs(_f32(5, 4, seed=2))],
     {"lr": 1e-2, "gamma1": 0.9, "clip_weights": 0.5}),
    ("rmspropalex_update", "rmspropalex_update",
     [_f32(5, 4), _f32(5, 4, seed=1), np.abs(_f32(5, 4, seed=2)) + 1,
      _f32(5, 4, seed=3) * 0.1, _f32(5, 4, seed=4) * 0.01],
     {"lr": 1e-2, "gamma1": 0.9, "gamma2": 0.8, "wd": 1e-3}),
    ("ftrl_update", "ftrl_update",
     [_f32(5, 4), _f32(5, 4, seed=1), _f32(5, 4, seed=2),
      np.abs(_f32(5, 4, seed=3))],
     {"lr": 0.1, "lamda1": 0.5, "beta": 1.5, "wd": 1e-2}),
    ("signsgd_update", "signsgd_update", [_f32(5, 4), _f32(5, 4, seed=1)],
     {"lr": 0.05, "wd": 0.1}),
]
_N_EARLIER = len(CASES)



def _pos(*shape, seed=0):
    """Positive inputs, away from 0: |N(0, 1)| + 0.5."""
    return np.abs(_f32(*shape, seed=seed)) + 0.5


def _unit(*shape, seed=0):
    """Inputs inside (-0.9, 0.9)."""
    return (np.tanh(_f32(*shape, seed=seed)) * 0.9).astype(np.float32)


def _ties(*shape, seed=0):
    """Rounded inputs: many exact ties, exact zeros and halves."""
    return (np.round(_f32(*shape, seed=seed) * 2) / 2).astype(np.float32)


def _i32(*shape, lo=-5, hi=6, seed=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int32)


class BF16:
    """An input given to both packages as bfloat16."""

    def __init__(self, a):
        self.a = np.asarray(a, np.float32)


# the eager surface's ops (elemwise, reduce, matrix, init, indexing):
# every case below also runs the gradient check when its op is
# differentiable (EAGER_NO_GRAD lists the few whose inputs are chosen for
# the forward alone)
_UNARY = [("abs", _f32), ("sign", _ties), ("negative", _f32),
          ("reciprocal", _pos), ("rcbrt", _pos), ("cbrt", _f32),
          ("sqrt", _pos), ("rsqrt", _pos), ("square", _f32), ("exp", _f32),
          ("expm1", _f32), ("log", _pos), ("log10", _pos), ("log1p", _pos),
          ("log2", _pos), ("sin", _f32), ("cos", _f32), ("tan", _unit),
          ("sinh", _f32), ("cosh", _f32), ("tanh", _f32), ("arcsin", _unit),
          ("arccos", _unit), ("arctan", _f32), ("arcsinh", _f32),
          ("arccosh", lambda *s: _pos(*s) + 1.0), ("arctanh", _unit),
          ("degrees", _f32), ("radians", _f32), ("gamma", _pos),
          ("gammaln", _pos), ("relu", _ties), ("sigmoid", _f32),
          ("softsign", _f32), ("ceil", _ties), ("floor", _ties),
          ("rint", _ties), ("round", _ties), ("fix", _ties),
          ("trunc", _ties), ("erf", _f32), ("logical_not", _ties)]

_BINARY = [("broadcast_sub", _f32, _f32), ("elemwise_sub", _f32, _f32),
           ("_minus", _f32, _f32), ("broadcast_div", _f32, _pos),
           ("_div", _f32, _pos), ("broadcast_mod", _f32, _pos),
           ("broadcast_power", _pos, _f32), ("pow", _pos, _unit),
           ("broadcast_maximum", _ties, _ties), ("maximum", _f32, _f32),
           ("broadcast_minimum", _ties, _ties), ("minimum", _f32, _f32),
           ("broadcast_hypot", _f32, _f32), ("hypot", _f32, _pos),
           ("_grad_add", _f32, _f32), ("broadcast_equal", _ties, _ties),
           ("equal", _ties, _ties), ("broadcast_not_equal", _ties, _ties),
           ("broadcast_greater", _ties, _ties),
           ("broadcast_greater_equal", _ties, _ties),
           ("broadcast_lesser", _ties, _ties),
           ("broadcast_lesser_equal", _ties, _ties),
           ("lesser_equal", _ties, _ties),
           ("broadcast_logical_and", _ties, _ties),
           ("broadcast_logical_or", _ties, _ties),
           ("broadcast_logical_xor", _ties, _ties)]

_SCALAR = [("_plus_scalar", _f32, 1.5), ("_minus_scalar", _f32, 0.75),
           ("_MinusScalar", _f32, "2"), ("_rminus_scalar", _f32, 3.0),
           ("_div_scalar", _f32, 4.0), ("_rdiv_scalar", _pos, 2.0),
           ("_mod_scalar", _f32, 0.7), ("_rmod_scalar", _pos, 2.5),
           ("_power_scalar", _pos, 2.5), ("_power_scalar", _f32, 2.0),
           ("_rpower_scalar", _f32, 1.7), ("_maximum_scalar", _ties, 0.5),
           ("_minimum_scalar", _ties, -0.5), ("_hypot_scalar", _f32, 1.5),
           ("_equal_scalar", _ties, 0.5),
           ("_not_equal_scalar", _ties, 0.5),
           ("_greater_scalar", _ties, 0.5),
           ("_greater_equal_scalar", _ties, 0.5),
           ("_lesser_scalar", _ties, 0.5),
           ("_lesser_equal_scalar", _ties, 0.5)]

CASES += (
    [("u_%s" % n, n, [g(3, 5)], {}) for n, g in _UNARY]
    + [("u_round_halves", "round",
        [np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.3, -2.5], np.float32)], {}),
       ("u_relu_int", "relu", [_i32(2, 5)], {}),
       ("u_reciprocal_int", "reciprocal", [_i32(2, 5, lo=1)], {}),
       ("u_abs_int", "abs", [_i32(2, 5)], {}),
       ("b_%s" % "add_n", "add_n",
        [_f32(3, 4), _f32(3, 4, seed=1), _f32(3, 4, seed=2)], {}),
       ("b_elementwise_sum", "ElementWiseSum",
        [_f32(2, 3), _f32(2, 3, seed=1)], {}),
       ("blockgrad", "BlockGrad", [_f32(3, 4)], {}),
       ("stop_gradient", "stop_gradient", [_f32(3, 4)], {}),
       ("make_loss_lower", "make_loss", [_f32(3, 4)], {}),
       ("identity_like_rhs", "_identity_with_attr_like_rhs",
        [_f32(3, 4), _f32(3, 4, seed=1)], {}),
       ("cast_f16", "Cast", [_f32(3, 4)], {"dtype": "float16"}),
       ("cast_int32", "cast", [_f32(3, 4) * 3], {"dtype": "int32"}),
       ("cast_int_to_f32", "Cast", [_i32(3, 4)], {"dtype": "float32"})]
    + [("b_%s" % n, n, [gl(2, 3, 4), gr(3, 1, seed=1)], {})
       for n, gl, gr in _BINARY]
    + [("b_mod_zero_divisor", "broadcast_mod",
        [_f32(2, 5), np.array([0.0, 1.5, 0.0, -2.0, 3.0], np.float32)], {}),
       ("b_mod_int", "broadcast_mod",
        [_i32(3, 4), np.array([3, 0, -2, 5], np.int32)], {}),
       ("b_power_int", "broadcast_power",
        [_i32(3, 4, lo=0, hi=4), _i32(3, 4, lo=0, hi=3, seed=1)], {}),
       ("b_equal_int", "broadcast_equal",
        [_i32(3, 4), _i32(3, 4, seed=1)], {}),
       ("b_sub_int", "broadcast_sub", [_i32(3, 4), _i32(1, 4, seed=1)], {}),
       ("b_div_int", "broadcast_div",
        [_i32(3, 4), _i32(1, 4, lo=1, seed=1)], {})]
    + [("s%d_%s" % (i, n), n, [g(3, 4)], {"scalar": v})
       for i, (n, g, v) in enumerate(_SCALAR)]
    + [("s_div_int", "_div_scalar", [_i32(3, 4)], {"scalar": 2.7}),
       ("s_rdiv_int", "_rdiv_scalar", [_i32(3, 4, lo=1)], {"scalar": 7.0}),
       ("s_power_int", "_power_scalar", [_i32(3, 4)], {"scalar": 2.7}),
       ("s_mod_int", "_mod_scalar", [_i32(3, 4)], {"scalar": 3}),
       ("s_greater_int", "_greater_scalar", [_i32(3, 4)], {"scalar": 0.5}),
       ("s_power_bf16", "_power_scalar", [BF16(_pos(3, 4))],
        {"scalar": 0.5}),
       ("s_plus_bf16", "_plus_scalar", [BF16(_f32(3, 4))],
        {"scalar": 0.1}),
       ("s_rdiv_bf16", "_rdiv_scalar", [BF16(_pos(3, 4))],
        {"scalar": 3.0}),
       ("clip", "clip", [_ties(4, 5)], {"a_min": 0.0, "a_max": 1.0}),
       ("clip_wide", "clip", [_f32(4, 5) * 3], {"a_min": -2.5,
                                                "a_max": 1.25}),
       ("clip_int", "clip", [_i32(4, 5)], {"a_min": -2.0, "a_max": 3.0}),
       ("clip_bf16", "clip", [BF16(_f32(4, 5))], {"a_min": -0.3,
                                                  "a_max": 0.7}),
       ("smooth_l1", "smooth_l1", [_f32(4, 5) * 2], {}),
       ("smooth_l1_scalar", "smooth_l1", [_f32(4, 5)], {"scalar": 3.0})]
    # reductions
    + [("r_sum_all", "sum", [_f32(2, 3, 4)], {}),
       ("r_sum_axis", "sum", [_f32(2, 3, 4)], {"axis": 1}),
       ("r_sum_axes_keep", "sum", [_f32(2, 3, 4)],
        {"axis": (0, 2), "keepdims": True}),
       ("r_sum_exclude", "sum", [_f32(2, 3, 4)],
        {"axis": 1, "exclude": True}),
       ("r_sum_keep_all", "sum", [_f32(2, 3)], {"keepdims": True}),
       ("r_sum_int", "sum", [_i32(3, 4)], {"axis": 0}),
       ("r_sum_axis_alias", "sum_axis", [_f32(3, 4)], {"axis": -1}),
       ("r_mean", "mean", [_f32(2, 3, 4)], {"axis": (1, 2)}),
       ("r_mean_all", "mean", [_f32(5, 4)], {}),
       ("r_prod", "prod", [_pos(3, 4)], {"axis": 1}),
       ("r_prod_all_int", "prod", [_i32(2, 3, lo=1, hi=4)], {}),
       ("r_nansum", "nansum",
        [np.where(_f32(3, 4) > 1, np.nan, _f32(3, 4, seed=1)).astype(
            np.float32)], {"axis": 0}),
       ("r_nanprod", "nanprod",
        [np.where(_f32(3, 4) > 1, np.nan, _pos(3, 4, seed=1)).astype(
            np.float32)], {"axis": 1}),
       ("r_max", "max", [_ties(3, 5)], {"axis": 1}),
       ("r_max_all", "max", [_ties(3, 5)], {}),
       ("r_max_axis_alias", "max_axis", [_f32(3, 5)],
        {"axis": 0, "keepdims": True}),
       ("r_min", "min", [_ties(3, 5)], {"axis": (0, 1)}),
       ("r_min_axis_alias", "min_axis", [_f32(3, 5)], {"axis": 1}),
       ("r_argmax_all", "argmax", [_ties(3, 5)], {}),
       ("r_argmax_axis", "argmax", [_ties(3, 5)], {"axis": 1}),
       ("r_argmax_keep", "argmax", [_f32(3, 5)],
        {"axis": 0, "keepdims": True}),
       ("r_argmin", "argmin", [_ties(3, 5)], {"axis": 1}),
       ("r_argmin_all", "argmin", [_f32(3, 5)], {}),
       ("r_argmax_channel", "argmax_channel", [_f32(2, 3, 5)], {}),
       ("r_norm", "norm", [_f32(3, 4)], {}),
       ("r_norm_axis", "norm", [_f32(3, 4)], {"axis": 1}),
       ("r_norm_ord1_keep", "norm", [_f32(3, 4)],
        {"ord": 1, "axis": 0, "keepdims": True}),
       ("r_broadcast_axis", "broadcast_axis", [_f32(3, 1, 2)],
        {"axis": 1, "size": 4}),
       ("r_broadcast_axes", "broadcast_axes", [_f32(1, 1, 2)],
        {"axis": (0, 1), "size": (2, 3)}),
       ("r_broadcast_to", "broadcast_to", [_f32(3, 1)],
        {"shape": (0, 4)}),
       ("r_broadcast_like", "broadcast_like",
        [_f32(1, 4), _f32(3, 4, seed=1)], {}),
       ("r_log_softmax", "log_softmax", [_f32(3, 6) * 3], {}),
       ("r_log_softmax_axis_t", "log_softmax", [_f32(2, 5, 3)],
        {"axis": 1, "temperature": 2.0}),
       ("r_softmax_xent", "softmax_cross_entropy",
        [_f32(5, 7) * 2, _ids((5,), 7)], {})]
    # shape and matrix ops
    + [("m_swapaxis", "SwapAxis", [_f32(2, 3, 4)], {"dim1": 0, "dim2": 2}),
       ("m_swapaxes", "swapaxes", [_f32(2, 3, 4)], {"dim1": 1, "dim2": 2}),
       ("m_squeeze", "squeeze", [_f32(2, 1, 3, 1)], {}),
       ("m_squeeze_axis", "squeeze", [_f32(2, 1, 3, 1)], {"axis": 1}),
       ("m_squeeze_axes", "squeeze", [_f32(1, 3, 1)], {"axis": (0, 2)}),
       ("m_slice", "slice", [_f32(4, 5, 6)],
        {"begin": (1, 0), "end": (3, 4)}),
       ("m_slice_step", "slice", [_f32(6, 7)],
        {"begin": (0, 1), "end": (6, 7), "step": (2, 3)}),
       ("m_slice_neg_step", "slice", [_f32(6, 7)],
        {"begin": (None, 5), "end": (None, 0), "step": (-1, -2)}),
       ("m_slice_none", "crop", [_f32(4, 5)],
        {"begin": (None, 2), "end": (3, None)}),
       ("m_slice_like", "slice_like", [_f32(4, 5, 6), _f32(2, 3, 9, seed=1)],
        {}),
       ("m_slice_like_axes", "slice_like",
        [_f32(4, 5, 6), _f32(2, 3, 4, seed=1)], {"axes": (0, 2)}),
       ("m_index_int", "_index", [_f32(3, 4, 5)], {"index": 1}),
       ("m_index_tuple", "_index", [_f32(3, 4, 5)],
        {"index": (slice(None), 2, slice(1, 4))}),
       ("m_index_neg_step", "_index", [_f32(3, 4, 5)],
        {"index": (slice(None, None, -1), Ellipsis, slice(4, 0, -2))}),
       ("m_index_newaxis", "_index", [_f32(3, 4)],
        {"index": (None, slice(1, 3), -1)}),
       ("m_slice_assign", "_slice_assign", [_f32(4, 5), _f32(2, 3, seed=1)],
        {"begin": (1, 2), "end": (3, 5)}),
       ("m_crop_assign_scalar", "_crop_assign_scalar", [_f32(4, 5)],
        {"begin": (0, 1), "end": (2, 3), "scalar": 7.5}),
       ("m_repeat", "repeat", [_f32(2, 3)], {"repeats": 2}),
       ("m_repeat_axis", "repeat", [_f32(2, 3)], {"repeats": 3, "axis": 1}),
       ("m_tile", "tile", [_f32(2, 3)], {"reps": (2, 1, 2)}),
       ("m_reverse", "reverse", [_f32(2, 3, 4)], {"axis": 1}),
       ("m_flip_axes", "flip", [_f32(2, 3, 4)], {"axis": (0, 2)}),
       ("m_stack", "stack", [_f32(2, 3), _f32(2, 3, seed=1)],
        {"axis": 1, "num_args": 2}),
       ("m_split", "SliceChannel", [_f32(2, 6, 3)], {"num_outputs": 3}),
       ("m_split_squeeze", "split", [_f32(2, 3, 4)],
        {"num_outputs": 3, "axis": 1, "squeeze_axis": True}),
       ("m_where", "where",
        [(_f32(3, 4) > 0).astype(np.float32), _f32(3, 4, seed=1),
         _f32(3, 4, seed=2)], {}),
       ("m_where_rows", "where",
        [np.array([1.0, 0.0, 2.0], np.float32), _f32(3, 4, seed=1),
         _f32(3, 4, seed=2)], {}),
       ("m_pad_constant", "Pad", [_f32(1, 2, 3, 4)],
        {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
         "constant_value": 1.5}),
       ("m_pad_edge", "pad", [_f32(1, 2, 3, 4)],
        {"mode": "edge", "pad_width": (0, 0, 1, 0, 2, 2, 0, 3)}),
       ("m_pad_reflect", "Pad", [_f32(1, 2, 4, 5)],
        {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 3, 2)}),
       ("m_dot", "dot", [_f32(3, 4), _f32(4, 5, seed=1)], {}),
       ("m_dot_transposes", "dot", [_f32(4, 3), _f32(5, 4, seed=1)],
        {"transpose_a": True, "transpose_b": True}),
       ("m_dot_vectors", "dot", [_f32(6), _f32(6, seed=1)], {}),
       ("m_dot_3d", "dot", [_f32(2, 3, 4), _f32(4, 5, seed=1)], {}),
       ("m_batch_dot", "batch_dot", [_f32(2, 3, 4), _f32(2, 4, 5, seed=1)],
        {}),
       ("m_batch_dot_t", "batch_dot", [_f32(2, 4, 3), _f32(2, 5, 4, seed=1)],
        {"transpose_a": True, "transpose_b": True}),
       ("m_topk", "topk", [_ties(3, 6)], {"k": 3}),
       ("m_topk_value_axis0", "topk", [_f32(5, 3)],
        {"axis": 0, "k": 2, "ret_typ": "value"}),
       ("m_topk_both_ascend", "topk", [_ties(3, 6)],
        {"k": 2, "ret_typ": "both", "is_ascend": True}),
       ("m_topk_mask", "topk", [_f32(3, 6)], {"k": 2, "ret_typ": "mask"}),
       ("m_sort", "sort", [_ties(3, 6)], {}),
       ("m_sort_desc_axis0", "sort", [_f32(4, 3)],
        {"axis": 0, "is_ascend": False}),
       ("m_argsort", "argsort", [_ties(3, 6)], {}),
       ("m_argsort_desc", "argsort", [_ties(3, 6)], {"is_ascend": False})]
    # creation ops
    + [("i_zeros", "_zeros", [], {"shape": (2, 3)}),
       ("i_zeros_int", "_zeros", [], {"shape": 4, "dtype": "int32"}),
       ("i_ones", "_ones", [], {"shape": (3, 2)}),
       ("i_full", "_full", [], {"shape": (2, 2), "value": 3.25}),
       ("i_arange", "_arange", [], {"start": 0.1, "stop": 2.0,
                                    "step": 0.3}),
       ("i_arange_stop_none_repeat", "_arange", [],
        {"start": 5, "repeat": 2}),
       ("i_arange_int", "_arange", [], {"start": 2, "stop": 11, "step": 3,
                                        "dtype": "int32"}),
       ("i_eye", "_eye", [], {"N": 3}),
       ("i_eye_rect_k", "_eye", [], {"N": 3, "M": 5, "k": 1}),
       ("i_zeros_like", "zeros_like", [_f32(2, 3)], {}),
       ("i_ones_like", "ones_like", [_i32(2, 3)], {})]
    # indexing ops
    + [("x_batch_take", "batch_take",
        [_f32(4, 5), np.array([0.0, 4.0, 2.0, 1.0], np.float32)], {}),
       ("x_batch_take_wrap_fill", "batch_take",
        [_f32(3, 5), np.array([-1.0, 7.0, 2.0], np.float32)], {}),
       ("x_pick", "pick", [_f32(3, 5), np.array([0, 4, 2], np.float32)],
        {}),
       ("x_pick_axis0_keep", "pick",
        [_f32(3, 5), np.array([0, 2, 1, 1, 0], np.float32)],
        {"axis": 0, "keepdims": True}),
       ("x_one_hot", "one_hot", [np.array([0, 2, 1, 5, -1], np.float32)],
        {"depth": 4}),
       ("x_one_hot_values", "one_hot",
        [np.array([[1, 0], [2, 2]], np.float32)],
        {"depth": 3, "on_value": 2.5, "off_value": -1.0}),
       ("x_one_hot_int", "one_hot", [np.array([0, 2], np.float32)],
        {"depth": 3, "dtype": "int32"}),
       ("x_gather_nd", "gather_nd",
        [_f32(3, 4, 2), np.array([[0, 2, 1], [3, 0, -1]], np.float32)], {}),
       ("x_gather_nd_full", "gather_nd",
        [_f32(3, 4), np.array([[0, 2], [3, 1]], np.float32)], {}),
       ("x_scatter_nd", "scatter_nd",
        [_f32(3, 2), np.array([[0, 2, 1], [3, 0, -1]], np.float32)],
        {"shape": (3, 4, 2)}),
       ("x_scatter_nd_drop", "scatter_nd",
        [_f32(3), np.array([[0, 5, 2], [1, 1, 9]], np.float32)],
        {"shape": (3, 4)})]
)

# the rest of nn.py and loss.py, and random_ops.py. An "rng" attr is a
# seed: each package gets its own threefry PRNGKey of it, so the draws
# (Dropout's mask, rrelu's slopes, the samplers) are compared exactly
_LENS = np.array([2, 5, 1], np.float32)
CASES += [
    ("n_deconv2d", "Deconvolution",
     [_f32(2, 4, 5, 5), _f32(4, 3, 3, 3, seed=1), _f32(3, seed=2)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
      "num_filter": 3, "no_bias": False}),
    ("n_deconv2d_group_dilate", "Deconvolution",
     [_f32(2, 4, 6, 6), _f32(4, 2, 3, 3, seed=1)],
     {"kernel": (3, 3), "dilate": (2, 2), "num_group": 2, "num_filter": 4}),
    ("n_deconv3d", "Deconvolution",
     [_f32(1, 2, 3, 4, 3), _f32(2, 3, 2, 2, 2, seed=1)],
     {"kernel": (2, 2, 2), "stride": (2, 1, 2), "num_filter": 3}),
    ("n_instance_norm", "InstanceNorm",
     [_f32(2, 3, 4, 5), _pos(3, seed=1), _f32(3, seed=2)], {"eps": 1e-3}),
    ("n_leaky", "LeakyReLU", [_f32(3, 4)],
     {"act_type": "leaky", "slope": 0.1}),
    ("n_elu", "LeakyReLU", [_f32(3, 4)], {"act_type": "elu", "slope": 0.5}),
    ("n_prelu", "LeakyReLU", [_f32(2, 3, 4), _f32(3, seed=1)],
     {"act_type": "prelu"}),
    ("n_rrelu_train", "LeakyReLU", [_f32(4, 6)],
     {"act_type": "rrelu", "is_train": True, "rng": 3}),
    ("n_rrelu_bf16_train", "LeakyReLU", [BF16(_f32(4, 6))],
     {"act_type": "rrelu", "is_train": True, "rng": 3}),
    ("n_rrelu_infer", "LeakyReLU", [_f32(4, 6)],
     {"act_type": "rrelu", "rng": 3}),
    ("n_dropout_train", "Dropout", [_f32(16, 33)],
     {"p": 0.3, "is_train": True, "rng": 5}),
    ("n_dropout_always", "Dropout", [_f32(5, 7)],
     {"p": 0.5, "mode": "always", "rng": 6}),
    ("n_dropout_infer", "Dropout", [_f32(5, 7)], {"p": 0.5, "rng": 6}),
    ("n_dropout_p0", "Dropout", [_f32(5, 7)],
     {"p": 0.0, "is_train": True, "rng": 6}),
    ("n_dropout_bf16_train", "Dropout", [BF16(_f32(8, 9))],
     {"p": 0.5, "is_train": True, "rng": 7}),
    ("n_lrn", "LRN", [_f32(2, 7, 4, 4)],
     {"nsize": 5, "alpha": 1e-2, "beta": 0.75, "knorm": 2.0}),
    ("n_lrn_3", "LRN", [_f32(2, 6, 3)], {"nsize": 3}),
    ("n_upsampling_nearest", "UpSampling", [_f32(2, 3, 4, 5)],
     {"scale": 2, "sample_type": "nearest", "num_args": 1}),
    ("n_upsampling_concat", "UpSampling",
     [_f32(1, 2, 3, 3), _f32(1, 3, 3, 3, seed=1)],
     {"scale": 2, "num_args": 2}),
    ("n_upsampling_sum", "UpSampling",
     [_f32(1, 2, 3, 3), _f32(1, 2, 3, 3, seed=1)],
     {"scale": 3, "num_args": 2, "multi_input_mode": "sum"}),
    ("n_upsampling_bilinear", "UpSampling", [_f32(2, 3, 4, 5)],
     {"scale": 2, "sample_type": "bilinear", "num_args": 1}),
    ("n_crop_hw", "Crop", [_f32(2, 3, 8, 9)],
     {"offset": (1, 2), "h_w": (4, 5)}),
    ("n_crop_like_center", "Crop", [_f32(2, 3, 8, 9), _f32(2, 3, 5, 4, 1)],
     {"num_args": 2, "center_crop": True}),
    ("n_seq_mask", "SequenceMask", [_f32(5, 3, 2), _LENS],
     {"use_sequence_length": True, "value": -1.0}),
    ("n_seq_mask_axis1", "SequenceMask", [_f32(3, 5, 2), _LENS],
     {"use_sequence_length": True, "axis": 1}),
    ("n_seq_mask_off", "SequenceMask", [_f32(5, 3, 2)], {}),
    ("n_seq_last", "SequenceLast", [_f32(5, 3, 2), _LENS],
     {"use_sequence_length": True}),
    ("n_seq_last_axis1", "SequenceLast", [_f32(3, 5, 2), _LENS],
     {"use_sequence_length": True, "axis": 1}),
    ("n_seq_last_off", "SequenceLast", [_f32(5, 3, 2)], {}),
    ("n_seq_reverse", "SequenceReverse", [_f32(5, 3, 2), _LENS],
     {"use_sequence_length": True}),
    ("n_seq_reverse_off", "SequenceReverse", [_f32(5, 3, 2)], {}),
    ("l_svm_output", "SVMOutput",
     [_f32(4, 5), np.array([0, 3, 1, 4], np.float32)], {}),
    ("l_svm_output_linear", "SVMOutput",
     [_f32(4, 5), np.array([2, 2, 0, 1], np.float32)],
     {"use_linear": True, "margin": 0.5,
      "regularization_coefficient": 0.5}),
    ("l_identity_kl", "IdentityAttachKLSparseReg", [_f32(3, 4)], {}),
    ("l_chunked_ce", "_contrib_ChunkedSoftmaxCE",
     [_f32(10, 6), _f32(7, 6, seed=1), _f32(7, seed=2), _ids((10,), 7)],
     {"chunk": 4}),
    ("l_chunked_ce_ignore_batch", "_contrib_ChunkedSoftmaxCE",
     [_f32(9, 6), _f32(5, 6, seed=1), _f32(5, seed=2),
      np.array([0, -1, 4, 2, -1, 1, 3, 0, 4], np.float32)],
     {"chunk": 3, "use_ignore": True, "normalization": "batch",
      "grad_scale": 2.0}),
    ("r_uniform", "_random_uniform", [],
     {"shape": (4, 5), "low": -1.0, "high": 2.0, "rng": 1}),
    ("r_uniform_alias", "uniform", [], {"shape": (3,), "rng": 2}),
    ("r_normal", "_random_normal", [],
     {"shape": (50,), "loc": 1.0, "scale": 2.0, "rng": 3}),
    ("r_randn", "randn", [], {"shape": (2, 3), "rng": 4}),
    ("r_exponential", "_random_exponential", [],
     {"shape": (40,), "lam": 2.0, "rng": 5}),
    ("r_gamma", "_random_gamma", [],
     {"shape": (4000,), "alpha": 2.0, "beta": 1.0, "rng": 6}),
    ("r_poisson", "_random_poisson", [],
     {"shape": (4000,), "lam": 3.0, "rng": 7}),
    ("r_poisson_large", "poisson", [],
     {"shape": (4000,), "lam": 30.0, "rng": 7}),
    ("r_negative_binomial", "_random_negative_binomial", [],
     {"shape": (4000,), "k": 4, "p": 0.5, "rng": 8}),
    ("r_generalized_negative_binomial",
     "_random_generalized_negative_binomial", [],
     {"shape": (4000,), "mu": 2.0, "alpha": 0.3, "rng": 9}),
    ("r_sample_uniform", "_sample_uniform",
     [np.array([0.0, 1.0], np.float32), np.array([1.0, 3.0], np.float32)],
     {"shape": (5,), "rng": 10}),
    ("r_sample_normal", "_sample_normal",
     [np.array([0.0, 2.0], np.float32), np.array([1.0, 0.5], np.float32)],
     {"shape": (6,), "rng": 11}),
    ("r_sample_exponential", "_sample_exponential",
     [np.array([1.0, 4.0], np.float32)], {"shape": (7,), "rng": 12}),
    ("r_sample_gamma", "_sample_gamma",
     [np.array([2.0, 3.0], np.float32), np.array([1.0, 2.0], np.float32)],
     {"shape": (3000,), "rng": 13}),
    ("r_sample_poisson", "_sample_poisson",
     [np.array([2.0, 5.0], np.float32)], {"shape": (3000,), "rng": 14}),
    ("r_sample_negative_binomial", "_sample_negative_binomial",
     [np.array([4.0, 2.0], np.float32), np.array([0.5, 0.5], np.float32)],
     {"shape": (3000,), "rng": 15}),
    ("r_sample_generalized_negative_binomial",
     "_sample_generalized_negative_binomial",
     [np.array([2.0, 3.0], np.float32), np.array([0.3, 0.5], np.float32)],
     {"shape": (3000,), "rng": 16}),
    ("r_multinomial", "sample_multinomial",
     [np.array([[0.8, 0.1, 0.1], [0.1, 0.1, 0.8]], np.float32)],
     {"shape": (50,), "rng": 17}),
    ("r_multinomial_1d_prob", "_sample_multinomial",
     [np.array([0.2, 0.5, 0.3], np.float32)],
     {"get_prob": True, "rng": 18}),
    ("r_multinomial_2d_prob", "sample_multinomial",
     [np.array([[0.8, 0.2], [0.3, 0.7]], np.float32)],
     {"shape": (4,), "get_prob": True, "rng": 19}),
    ("r_shuffle", "shuffle", [_f32(6, 3)], {"rng": 20}),
    ("r_shuffle_1d", "_shuffle", [_f32(9)], {"rng": 21}),
]

# the LM options' and the decode path's ops: RoPE and the SSM scan (their
# gradients too), the cache ops (the caches they write in place are
# outputs, the int8 rows and scales compared exactly) and the weight-only
# int8 ops
_I8 = np.int8
CASES += [
    ("c_rope", "_contrib_RoPE",
     [_f32(2, 3, 5, 8), np.arange(5, dtype=np.float32)], {}),
    ("c_rope_per_row_base", "_contrib_RoPE",
     [_f32(2, 3, 4, 6), _ids((2, 4), 100)], {"base": 500.0}),
    ("c_ssm_scan", "_contrib_SSMScan",
     [_f32(1, 2, 5, 4), _f32(1, 2, 5, 4, seed=1), _f32(1, 2, 5, 4, seed=2),
      _f32(1, 2, 5, seed=3)], {"chunk": 2}),
    ("c_ssm_cached_prefill", "_contrib_SSMCached",
     [_f32(1, 2, 5, 4), _f32(1, 2, 5, 4, seed=1), _f32(1, 2, 5, 4, seed=2),
      _f32(1, 2, 5, seed=3), _f32(1, 2, 4, 4, seed=4),
      np.zeros((1,), np.float32)], {"chunk": 2}),
    ("c_ssm_cached_step", "_contrib_SSMCached",
     [_f32(1, 2, 1, 4), _f32(1, 2, 1, 4, seed=1), _f32(1, 2, 1, 4, seed=2),
      _f32(1, 2, 1, seed=3), _f32(1, 2, 4, 4, seed=4),
      np.full((1,), 5.0, np.float32)], {"gate_bias": 2.0}),
    ("c_cached_attention_gqa_window", "_contrib_CachedAttention",
     [_f32(2, 4, 3, 4), _f32(2, 2, 3, 4, seed=1), _f32(2, 2, 3, 4, seed=2),
      _f32(2, 2, 6, 4, seed=3), _f32(2, 2, 6, 4, seed=4),
      np.array([2.0], np.float32)], {"window": 2, "max_len": 6}),
    ("c_cached_attention_per_row", "_contrib_CachedAttention",
     [_f32(2, 2, 1, 4), _f32(2, 2, 1, 4, seed=1), _f32(2, 2, 1, 4, seed=2),
      _f32(2, 2, 6, 4, seed=3), _f32(2, 2, 6, 4, seed=4),
      np.array([0.0, 4.0], np.float32)], {}),
    ("c_rolling_cached_attention", "_contrib_RollingCachedAttention",
     [_f32(2, 2, 1, 4), _f32(2, 2, 1, 4, seed=1), _f32(2, 2, 1, 4, seed=2),
      _f32(2, 2, 4, 4, seed=3), _f32(2, 2, 4, 4, seed=4),
      np.array([5.0], np.float32)], {"window": 3, "max_len": 4}),
    ("c_cached_attention_q8", "_contrib_CachedAttentionQ8",
     [_f32(2, 2, 2, 4), _f32(2, 2, 2, 4, seed=1), _f32(2, 2, 2, 4, seed=2),
      np.zeros((2, 2, 5, 4), _I8), np.zeros((2, 2, 5, 4), _I8),
      np.zeros((2, 2, 5), np.float32), np.zeros((2, 2, 5), np.float32),
      np.array([1.0], np.float32)], {"window": 2}),
    ("c_quantized_fc", "_contrib_QuantizedFullyConnected",
     [_f32(3, 6), np.random.RandomState(5).randint(-127, 128, (4, 6)).astype(
         _I8), np.abs(_f32(4, seed=1)) / 50, _f32(4, seed=2)],
     {"num_hidden": 4}),
    ("c_quantized_embedding", "_contrib_QuantizedEmbedding",
     [_ids((2, 3), 5), np.random.RandomState(6).randint(
         -127, 128, (5, 6)).astype(_I8), np.abs(_f32(5, seed=1)) / 50],
     {"input_dim": 5, "output_dim": 6}),
    # Switch MoE (dense form, no mesh): 12 tokens over 4 experts at
    # capacity ceil(12 * 1.25 / 4) = 4, so some tokens drop
    ("c_moe_ffn", "_contrib_MoEFFN",
     [_f32(2, 6, 8), _f32(8, 4, seed=1) * 0.5, _f32(4, 8, 16, seed=2) * 0.2,
      _f32(4, 16, 8, seed=3) * 0.2], {"capacity_factor": 1.25}),
    ("c_moe_ffn_alias", "_contrib_moe_ffn",
     [_f32(10, 8, seed=4), _f32(8, 4, seed=5) * 0.5,
      _f32(4, 8, 16, seed=6) * 0.2, _f32(4, 16, 8, seed=7) * 0.2],
     {"capacity_factor": 2.0}),
]

# the symbolic RNN toolkit's ops: the fused RNN (two bidirectional lstm
# layers with inter-layer dropout, states of batch 1; one gru layer) and
# CTCLoss (blank first; blank last with both length inputs, by alias)
CASES += [
    ("r_rnn_lstm_dropout", "RNN",
     [_f32(5, 3, 4), _f32(rnn_param_size("lstm", 4, 6, 2, True), seed=1)
      * 0.3, _f32(4, 1, 6, seed=2), _f32(4, 1, 6, seed=3)],
     {"state_size": 6, "num_layers": 2, "bidirectional": True,
      "mode": "lstm", "p": 0.3, "state_outputs": True, "is_train": True,
      "rng": 5}),
    ("r_rnn_gru", "RNN",
     [_f32(5, 3, 4), _f32(rnn_param_size("gru", 4, 6, 1, False), seed=1)
      * 0.3, _f32(1, 3, 6, seed=2)],
     {"state_size": 6, "mode": "gru"}),
    ("r_ctc_loss", "CTCLoss",
     [_f32(6, 2, 5), np.array([[1, 3, 3], [4, 2, 0]], np.float32)], {}),
    ("r_ctc_loss_lengths_alias", "_contrib_ctc_loss",
     [_f32(6, 2, 5), np.array([[0, 3, 3], [2, 1, -1]], np.float32),
      np.array([6, 4], np.float32), np.array([3, 1], np.float32)],
     {"use_data_lengths": True, "use_label_lengths": True,
      "blank_label": "last"}),
]

# detection training and the rest of the op catalog: MultiBoxTarget,
# ROIPooling (rounded relu features: tied maxima and all-zero bins), the
# R-CNN family, the warp ops, linalg, fft/quantize and Custom (a scale
# op registered in both packages)


def _register_sweep_scale(mx):
    class _ScaleOp(mx.operator.CustomOp):
        def __init__(self, factor):
            self.factor = factor

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * self.factor)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self.factor)

    @mx.operator.register("sweep_scale")
    class _ScaleProp(mx.operator.CustomOpProp):
        def __init__(self, factor="2.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, shapes, dtypes):
            return _ScaleOp(self.factor)


for _mx in (jmx, tmx):
    _register_sweep_scale(_mx)


def _corner_boxes(shape, seed, lo=0.05, hi=0.4):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 0.6, shape + (2,))
    return np.concatenate([xy, xy + rs.uniform(lo, hi, shape + (2,))],
                          -1).astype(np.float32)


def _det_labels(counts, L, seed):
    """(B, L, 6) [class, x1, y1, x2, y2, difficult] with counts[b] valid
    rows, padded with -1."""
    lab = -np.ones((len(counts), L, 6), np.float32)
    rs = np.random.RandomState(seed)
    for b, n in enumerate(counts):
        lab[b, :n, 0] = rs.randint(0, 3, n)
        lab[b, :n, 1:5] = _corner_boxes((n,), seed + 1 + b)
        lab[b, :n, 5] = 0
    return lab


def _proposal_inputs(B, A, H, W, seed):
    rs = np.random.RandomState(seed)
    prob = rs.uniform(0, 1, (B, 2 * A, H, W)).astype(np.float32)
    deltas = (rs.randn(B, 4 * A, H, W) * 0.2).astype(np.float32)
    info = np.tile(np.array([[4 * H, 4 * W, 1.0]], np.float32), (B, 1))
    return [prob, deltas, info]


_SPD = (lambda m: (m @ m.T + 4 * np.eye(4)).astype(np.float32))(
    _f32(4, 4, seed=7))
_TRI = np.tril(_f32(4, 4, seed=8)) + 3 * np.eye(4, dtype=np.float32)
_PROP_ATTRS = {"rpn_pre_nms_top_n": 30, "rpn_post_nms_top_n": 8,
               "threshold": 0.6, "rpn_min_size": 2, "scales": (2, 4),
               "ratios": (0.5, 1, 2), "feature_stride": 4}
# the dense compute paths of the sparse ops (ndarray/sparse.py routes
# sparse inputs; tests/test_torch_sparse.py holds those)
CASES += [
    ("s_cast_storage", "cast_storage", [_f32(3, 4)], {"stype": "default"}),
    ("s_sparse_retain", "_sparse_retain",
     [_f32(5, 3), np.array([0, 3, -1, 7], np.float32)], {}),
    ("s_square_sum_all", "_square_sum", [_f32(3, 4)], {}),
    ("s_square_sum_axis", "_square_sum", [_f32(3, 4, 2)],
     {"axis": 1, "keepdims": True}),
]

CASES += [
    ("d_multibox_target", "_contrib_MultiBoxTarget",
     [_corner_boxes((1, 30), 1), _det_labels((2, 0), 3, 2),
      _f32(2, 3, 30, seed=3)],
     {"negative_mining_ratio": 3.0, "minimum_negative_samples": 2}),
    ("d_roi_pooling_ties", "ROIPooling",
     [np.maximum(np.round(_f32(2, 2, 7, 9, seed=2) * 2), 0),
      np.array([[0, 0, 0, 6, 6], [1, 2.3, 1.6, 8.2, 5.7], [0, 4, 3, 3, 2]],
               np.float32)],
     {"pooled_size": (2, 3), "spatial_scale": 0.5}),
    ("d_proposal", "_contrib_Proposal", _proposal_inputs(1, 6, 3, 3, 1),
     {**_PROP_ATTRS, "output_score": True}),
    ("d_multi_proposal", "_contrib_MultiProposal",
     _proposal_inputs(2, 6, 3, 3, 3), _PROP_ATTRS),
    ("d_psroi_pooling", "_contrib_PSROIPooling",
     [_f32(1, 2 * 4, 6, 6), np.array([[0, 1, 1, 20, 18]], np.float32)],
     {"spatial_scale": 0.25, "output_dim": 2, "pooled_size": 2}),
    ("d_deformable_psroi_pooling", "_contrib_DeformablePSROIPooling",
     [_f32(1, 4, 6, 6), np.array([[0, 1, 1, 20, 18]], np.float32),
      _f32(1, 2, 2, 2, seed=4)],
     {"spatial_scale": 0.25, "output_dim": 1, "pooled_size": 2,
      "sample_per_part": 2, "trans_std": 0.1}),
    ("d_deformable_conv", "_contrib_DeformableConvolution",
     [_f32(1, 2, 4, 4), _f32(1, 2 * 4, 3, 3, seed=1) * 0.7,
      _f32(3, 2, 2, 2, seed=2), _f32(3, seed=3)],
     {"kernel": (2, 2), "num_filter": 3}),
    ("w_grid_affine", "GridGenerator", [_f32(2, 6) * 0.3],
     {"transform_type": "affine", "target_shape": (4, 5)}),
    ("w_grid_warp", "GridGenerator", [_f32(2, 2, 4, 5)],
     {"transform_type": "warp"}),
    ("w_bilinear_sampler", "BilinearSampler",
     [_f32(2, 3, 6, 7), _f32(2, 2, 4, 5, seed=1) * 0.8], {}),
    ("w_spatial_transformer", "SpatialTransformer",
     [_f32(2, 3, 6, 7), np.array([[0.9, 0.1, 0.05, -0.1, 0.8, 0.1],
                                  [0.7, -0.2, -0.1, 0.3, 1.1, 0.0]],
                                 np.float32)],
     {"target_shape": (5, 4)}),
    ("w_correlation_abs_k3", "Correlation", [_f32(1, 2, 6, 6),
                                             _f32(1, 2, 6, 6, seed=1)],
     {"kernel_size": 3, "max_displacement": 1, "stride1": 2,
      "pad_size": 2, "is_multiply": False}),
    ("l_gemm", "_linalg_gemm", [_f32(2, 3, 4), _f32(2, 5, 4, seed=1),
                                _f32(2, 3, 5, seed=2)],
     {"transpose_b": True, "alpha": 0.5, "beta": 2.0}),
    ("l_gemm2", "_linalg_gemm2", [_f32(4, 3), _f32(4, 5, seed=1)],
     {"transpose_a": True, "alpha": 1.5}),
    ("l_potrf", "_linalg_potrf", [_SPD], {}),
    ("l_potri", "_linalg_potri", [_TRI], {}),
    ("l_trmm_right", "_linalg_trmm", [_TRI, _f32(3, 4, seed=1)],
     {"rightside": True, "alpha": 2.0}),
    ("l_trsm", "_linalg_trsm", [_TRI, _f32(4, 3, seed=2)],
     {"transpose": True, "alpha": 0.5}),
    ("l_syrk", "_linalg_syrk", [_f32(3, 5)], {"transpose": True,
                                               "alpha": 0.5}),
    ("l_gelqf", "_linalg_gelqf", [_f32(3, 5)], {}),
    ("l_sumlogdiag", "_linalg_sumlogdiag", [_TRI], {}),
    ("l_khatri_rao", "khatri_rao", [_f32(2, 3), _f32(4, 3, seed=1),
                                    _f32(2, 3, seed=2)], {}),
    ("c_fft", "_contrib_fft", [_f32(3, 8)], {}),
    ("c_ifft", "_contrib_ifft", [_f32(2, 3, 12)], {}),
    ("c_count_sketch", "_contrib_count_sketch",
     [_f32(3, 10), _ids((1, 10), 6, seed=1),
      np.where(_f32(1, 10, seed=2) > 0, 1, -1).astype(np.float32)],
     {"out_dim": 6}),
    ("c_quantize_int8", "_contrib_quantize",
     [_f32(4, 5), np.array([-1.5], np.float32), np.array([2.0], np.float32)],
     {"out_type": "int8"}),
    ("c_dequantize", "_contrib_dequantize",
     [np.arange(20, dtype=np.uint8).reshape(4, 5) * 12,
      np.array([-1.5], np.float32), np.array([2.0], np.float32)], {}),
    ("x_custom", "Custom", [_f32(3, 4)],
     {"op_type": "sweep_scale", "factor": "3.0"}),
]

# the rejection samplers (jax random.py's gamma and poisson loops, and
# the negative binomials over them): the same algorithms on the same
# per-element keys, but an accept test can flip on the last bit of a
# log or lgamma (ROADMAP Queue C), so these are held by their mean, to
# test_op_sweep.py's RANDOM_MOMENTS bounds (3 estimator sds), against
# the JAX package's own draw. name -> sd of the mean estimator
DRAW_MOMENT_TOL = {
    "_random_gamma": 0.15, "_random_poisson": 0.15,
    "_random_negative_binomial": 0.3,
    "_random_generalized_negative_binomial": 0.3,
    "_sample_gamma": 0.15, "_sample_poisson": 0.15,
    "_sample_negative_binomial": 0.3,
    "_sample_generalized_negative_binomial": 0.3}

# cases whose inputs suit the forward only: the divisor 0 (jax's
# gradient there is NaN), ties at clip's bounds are kept (both packages
# split them), and the int inputs have no gradient
EAGER_NO_GRAD = {"b_mod_zero_divisor"}

def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _jax_in(x):
    return jnp.asarray(x.a, jnp.bfloat16) if isinstance(x, BF16) \
        else jnp.asarray(x)


def _torch_in(x):
    return torch.from_numpy(x.a.copy()).to(torch.bfloat16) \
        if isinstance(x, BF16) else torch.from_numpy(x.copy())


def _check_same(t, j, what=""):
    """A port output against the JAX one: same shape and dtype; floats
    within RTOL/ATOL (bf16 within one bf16 rounding, rtol 1e-2), ints
    and bools equal."""
    j = np.asarray(j.astype(jnp.float32)) if j.dtype == jnp.bfloat16 \
        else np.asarray(j)
    if t.dtype == torch.bfloat16:
        assert j.dtype == np.float32, (what, j.dtype)
        np.testing.assert_allclose(t.detach().float().numpy(), j,
                                   rtol=1e-2,
                                   atol=1e-6, err_msg=what)
        return
    t = t.detach().numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, \
        (what, j.shape, t.shape, j.dtype, t.dtype)
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


def _attrs(reg, op, attrs, key_of):
    """``reg.canon_attrs`` of the case's attrs, its "rng" seed turned
    into that package's threefry key."""
    attrs = dict(attrs)
    seed = attrs.pop("rng", None)
    out = reg.canon_attrs(op, attrs)
    if seed is not None:
        out["rng"] = key_of(seed)
    return out


def _jattrs(jop, attrs):
    return _attrs(jreg, jop, attrs, jax.random.PRNGKey)


def _tattrs(top, attrs):
    return _attrs(treg, top, attrs, tmx.random.PRNGKey)


def _check_moments(name, t, j):
    """Same shape and dtype; the mean of each row of draws within 3
    estimator sds (DRAW_MOMENT_TOL) of the JAX package's, and 99% of the
    draws within RTOL/ATOL of JAX's (all of them in 12000 draws of each
    op, the gamma draws 86-89% bit for bit)."""
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (name, j.shape,
                                                       t.shape)
    assert np.isclose(t, j, rtol=RTOL, atol=ATOL).mean() >= 0.99, name
    tol = DRAW_MOMENT_TOL[name]
    np.testing.assert_allclose(t.reshape(-1, t.shape[-1]).mean(-1),
                               j.reshape(-1, j.shape[-1]).mean(-1),
                               rtol=0, atol=3 * tol, err_msg=name)


@pytest.mark.parametrize("name,inputs,attrs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_op_forward_matches_jax(name, inputs, attrs):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert jop.name == top.name
    j_out = _as_list(jop.fn(*[_jax_in(x) for x in inputs],
                            **_jattrs(jop, attrs)))
    with tmx.cpu():       # ops without tensor inputs make theirs here
        t_out = _as_list(top.fn(*[_torch_in(x) for x in inputs],
                                **_tattrs(top, attrs)))
    assert len(j_out) == len(t_out)
    for j, t in zip(j_out, t_out):
        if top.name in DRAW_MOMENT_TOL:
            _check_moments(top.name, t, j)
        else:
            _check_same(t, j)


def _relu_grid(shape, seed=0):
    """Rounded relu outputs: many exact zeros and tied maxima."""
    return np.maximum(np.round(_f32(*shape, seed=seed) * 2), 0)


# (case id, op name, inputs, attrs, env) — forward AND gradient of every
# float input against jax.vjp with one random cotangent
GRAD_CASES = [
    ("square_sum", "_square_sum", [_f32(3, 4)], {"axis": 1}, {}),
    ("sparse_retain", "_sparse_retain",
     [_f32(5, 3), np.array([1, 3], np.float32)], {}, {}),
    ("conv2d", "Convolution", [_f32(2, 3, 9, 8), _f32(4, 3, 3, 3, seed=1),
                               _f32(4, seed=2)],
     {"kernel": (3, 3), "stride": (2, 1), "pad": (1, 0), "num_filter": 4},
     {}),
    ("conv2d_group_dilate", "Convolution",
     [_f32(2, 4, 8, 8), _f32(4, 2, 3, 3, seed=1)],
     {"kernel": (3, 3), "dilate": (2, 2), "num_group": 2, "num_filter": 4,
      "no_bias": True}, {}),
    ("conv1d", "Convolution", [_f32(2, 3, 12), _f32(4, 3, 3, seed=1),
                               _f32(4, seed=2)],
     {"kernel": (3,), "pad": (1,), "num_filter": 4}, {}),
    ("pool_max_stem", "Pooling", [_f32(2, 3, 9, 9)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}, {}),
    # ties: the default backward gives each window's FIRST maximum the
    # whole gradient, in both packages
    ("pool_max_ties", "Pooling", [_relu_grid((2, 3, 9, 9))],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}, {}),
    ("pool_max_all_zero", "Pooling", [np.zeros((1, 2, 5, 5), np.float32)],
     {"kernel": (3, 3), "stride": (2, 2)}, {}),
    ("pool_max_full", "Pooling", [_relu_grid((2, 2, 10, 9), seed=3)],
     {"kernel": (3, 3), "stride": (2, 2), "pooling_convention": "full"},
     {}),
    ("pool_max_big_pad", "Pooling", [_f32(1, 2, 7, 7)],
     {"kernel": (2, 2), "stride": (1, 1), "pad": (2, 1)}, {}),
    # MXNET_POOL_DENSE_BWD=1: ties split the gradient (dy / count each)
    ("pool_max_dense_bwd_ties", "Pooling", [_relu_grid((2, 3, 9, 9))],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)},
     {"MXNET_POOL_DENSE_BWD": "1"}),
    ("pool_max_dense_bwd_full", "Pooling", [_relu_grid((1, 2, 8, 7), 4)],
     {"kernel": (2, 3), "stride": (2, 2), "pooling_convention": "full"},
     {"MXNET_POOL_DENSE_BWD": "1"}),
    ("pool_avg_pad", "Pooling", [_f32(2, 3, 7, 6)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
      "pool_type": "avg"}, {}),
    ("pool_sum_full", "Pooling", [_f32(1, 2, 8, 7)],
     {"kernel": (3, 3), "stride": (2, 2), "pool_type": "sum",
      "pooling_convention": "full"}, {}),
    ("pool_global_avg", "Pooling", [_f32(2, 5, 7, 7)],
     {"global_pool": True, "kernel": (7, 7), "pool_type": "avg"}, {}),
    ("flatten", "Flatten", [_f32(2, 3, 4, 5)], {}, {}),
    ("identity", "identity", [_f32(3, 4)], {}, {}),
    ("relu_ties", "Activation", [_relu_grid((4, 6)) - 1.0],
     {"act_type": "relu"}, {}),
]


def _is_float(x):
    return isinstance(x, BF16) or np.issubdtype(x.dtype, np.floating)


# the eager surface's differentiable ops, from their forward cases
GRAD_CASES += [(c[0], c[1], c[2], c[3], {}) for c in CASES[_N_EARLIER:]
               if treg.get_op(c[1]).differentiable
               and c[0] not in EAGER_NO_GRAD
               and any(_is_float(x) for i, x in enumerate(c[2])
                       if i not in treg.get_op(c[1]).nondiff_inputs)]


@pytest.mark.parametrize("name,inputs,attrs,env",
                         [c[1:] for c in GRAD_CASES],
                         ids=[c[0] for c in GRAD_CASES])
def test_op_gradient_matches_jax(name, inputs, attrs, env, monkeypatch):
    """Forward and the gradient of every float input the op differentiates
    (not its nondiff_inputs) against jax.vjp, one random cotangent an
    output; an output the port leaves without a graph (BlockGrad) must
    have a zero JAX gradient."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jop, top = jreg.get_op(name), treg.get_op(name)
    jattrs, tattrs = _jattrs(jop, attrs), _tattrs(top, attrs)
    wrt = [i for i, x in enumerate(inputs)
           if _is_float(x) and i not in top.nondiff_inputs]
    jxs = [_jax_in(x) for x in inputs]

    def jfn(*dx):
        xs = list(jxs)
        for i, v in zip(wrt, dx):
            xs[i] = v
        return jop.fn(*xs, **jattrs)

    jout, vjp = jax.vjp(jfn, *[jxs[i] for i in wrt])
    txs = [_torch_in(x) for x in inputs]
    for i in wrt:
        txs[i].requires_grad_()
    touts = _as_list(top.fn(*txs, **tattrs))
    jouts = _as_list(jout)
    for t, j in zip(touts, jouts):
        _check_same(t, j)
    cots = [np.asarray(np.random.RandomState(9 + n).randn(*j.shape),
                       np.float32) for n, j in enumerate(jouts)]
    jgrads = vjp(type(jout)(jnp.asarray(c, j.dtype) for c, j in
                            zip(cots, jouts))
                 if isinstance(jout, (tuple, list))
                 else jnp.asarray(cots[0], jout.dtype))
    live = [(t, torch.from_numpy(c).to(t.dtype))
            for t, c in zip(touts, cots) if t.requires_grad]
    tgrads = torch.autograd.grad(
        [t for t, _ in live], [txs[i] for i in wrt],
        [c for _, c in live], allow_unused=True) if live else \
        [None] * len(wrt)
    for n, (i, t, j) in enumerate(zip(wrt, tgrads, jgrads)):
        j = np.asarray(jnp.asarray(j, jnp.float32))
        t = np.zeros_like(j) if t is None else t.float().numpy()
        tol = dict(rtol=1e-2, atol=1e-2 * np.abs(j).max()) \
            if isinstance(inputs[i], BF16) else dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t, j, err_msg="input %d" % i, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_gradient_at_exact_zero_matches_jax(dtype):
    """jnp.maximum(x, 0) passes half the gradient to each side of a tie:
    0.5 at an exact 0, in f32 and bf16 (torch.clamp_min would pass 1)."""
    x = np.array([0.0, 1.0, -1.0, 0.0, -0.0, 2.5], np.float32)
    cot = np.array([1.0, 2.0, 3.0, 4.0, 0.5, -1.0], np.float32)
    jop, top = jreg.get_op("Activation"), treg.get_op("Activation")
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda v: jop.fn(v, act_type="relu"),
                     jnp.asarray(x, jdt))
    (jg,) = vjp(jnp.asarray(cot, jdt))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    (tg,) = torch.autograd.grad(top.fn(tx, act_type="relu"), tx,
                                torch.from_numpy(cot).to(tdt))
    assert tg.dtype == tdt
    np.testing.assert_array_equal(tg.float().numpy(),
                                  np.asarray(jg.astype(jnp.float32)))
    assert tg[0].item() == 0.5 and tg[3].item() == 2.0


def test_sweep_covers_every_ported_op():
    """Every op the port registers is swept, and each one's OpDef
    carries the JAX package's registration (arity, state slots,
    defaults — the symbol JSON depends on the defaults' order)."""
    swept = {treg.get_op(c[1]).name for c in CASES}
    ported = {treg.get_op(n).name for n in treg.list_ops()}
    assert ported == swept
    for name in ported:
        jop, top = jreg.get_op(name), treg.get_op(name)
        for field in ("arg_names", "differentiable", "needs_rng",
                      "takes_is_train", "num_visible", "state_inputs",
                      "nondiff_inputs", "aliases", "traced_attrs"):
            assert getattr(top, field) == getattr(jop, field), (name, field)
        assert list(top.defaults.items()) == list(jop.defaults.items())
        assert (top.arg_select is None) == (jop.arg_select is None)
        assert (top.param_shapes is None) == (jop.param_shapes is None)


# ---------------------------------------------------------------------------
# loss heads: the custom backward against jax.vjp of the JAX op
# ---------------------------------------------------------------------------

def _labels_with_ignored(shape, nclass, n_ignored, seed=0):
    lab = _ids(shape, nclass, seed=seed).reshape(-1)
    lab[:n_ignored] = -1
    return lab.reshape(shape)


# (case id, op name, data, label or None, attrs, cotangent, dtype)
BACKWARD_CASES = [
    ("softmax_null", "SoftmaxOutput", _f32(6, 10) * 3, _ids((6,), 10), {},
     1.0, "f32"),
    ("softmax_ignore_valid", "SoftmaxOutput", _f32(8, 7) * 2,
     _labels_with_ignored((8,), 7, 3),
     {"use_ignore": True, "normalization": "valid"}, 1.0, "f32"),
    ("softmax_batch_grad_scale", "SoftmaxOutput", _f32(5, 6),
     _ids((5,), 6), {"normalization": "batch", "grad_scale": 0.5}, 1.0,
     "f32"),
    ("softmax_valid_no_ignore", "SoftmaxOutput", _f32(5, 6), _ids((5,), 6),
     {"normalization": "valid"}, 1.0, "f32"),
    ("softmax_smooth_alpha", "SoftmaxOutput", _f32(6, 5), _ids((6,), 5),
     {"smooth_alpha": 0.1}, 1.0, "f32"),
    ("softmax_multi_output", "SoftmaxOutput", _f32(2, 5, 3),
     _labels_with_ignored((2, 3), 5, 1),
     {"multi_output": True, "use_ignore": True, "normalization": "valid"},
     1.0, "f32"),
    ("softmax_cotangent_4", "SoftmaxOutput", _f32(6, 10), _ids((6,), 10),
     {"use_ignore": True, "normalization": "valid"}, 4.0, "f32"),
    ("softmax_3d_label", "SoftmaxOutput", _f32(2, 3, 4),
     _ids((2, 3), 4), {"use_ignore": True, "normalization": "valid"},
     1.0, "f32"),
    # bf16: the valid count is a bf16 sum (297 valid rows count as 296)
    ("softmax_bf16_valid", "SoftmaxOutput", _f32(300, 8),
     _labels_with_ignored((300,), 8, 3),
     {"use_ignore": True, "normalization": "valid"}, 1.0, "bf16"),
    ("make_loss_null", "MakeLoss", _f32(3, 4), None, {"grad_scale": 2.0},
     4.0, "f32"),
    ("make_loss_batch", "MakeLoss", _f32(3, 4), None,
     {"normalization": "batch"}, 1.0, "f32"),
    ("make_loss_valid", "MakeLoss", _f32(3, 4), None,
     {"normalization": "valid", "valid_thresh": 0.1}, 1.0, "f32"),
    ("linear_regression", "LinearRegressionOutput", _f32(4, 3),
     _f32(4, 3, seed=1), {"grad_scale": 2.0}, 4.0, "f32"),
    ("linear_regression_flat_label", "LinearRegressionOutput", _f32(4, 1),
     _f32(4, seed=1), {}, 1.0, "f32"),
    ("mae_regression", "MAERegressionOutput", _f32(4, 3),
     _f32(4, 3, seed=1), {"grad_scale": 0.5}, 4.0, "f32"),
    ("logistic_regression", "LogisticRegressionOutput", _f32(4, 3),
     (_f32(4, 3, seed=1) > 0).astype(np.float32), {}, 4.0, "f32"),
]


@pytest.mark.parametrize("name,data,label,attrs,cot,dtype",
                         [c[1:] for c in BACKWARD_CASES],
                         ids=[c[0] for c in BACKWARD_CASES])
def test_loss_head_backward_matches_jax(name, data, label, attrs, cot,
                                        dtype):
    """The head's emitted gradient, scaled by the incoming cotangent,
    matches the JAX op's custom VJP; the label gets no gradient."""
    jop, top = jreg.get_op(name), treg.get_op(name)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jattrs, tattrs = _jattrs(jop, attrs), _tattrs(top, attrs)
    jd = jnp.asarray(data, jdt)
    td = torch.from_numpy(data.copy()).to(tdt).requires_grad_()
    if label is None:
        out, vjp = jax.vjp(lambda d: jop.fn(d, **jattrs), jd)
        tout = top.fn(td, **tattrs)
    else:
        tl = torch.from_numpy(label.copy())
        out, vjp = jax.vjp(lambda d: jop.fn(d, jnp.asarray(label),
                                            **jattrs), jd)
        tout = top.fn(td, tl, **tattrs)
        assert not tl.requires_grad
    (jg,) = vjp(jnp.full(out.shape, cot, out.dtype))
    (tg,) = torch.autograd.grad(tout, td, torch.full(tout.shape, cot,
                                                     dtype=tout.dtype))
    assert tg.dtype == tdt
    jg = np.asarray(jnp.asarray(jg, jnp.float32))
    tg = tg.float().numpy()
    if dtype == "bf16":
        np.testing.assert_allclose(tg, jg, rtol=1e-2,
                                   atol=1e-6 * np.abs(jg).max())
    else:
        np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


def test_valid_count_is_a_bf16_sum_as_in_jax():
    """Under bf16 the valid count is the mask's bf16 sum: 16376 valid
    tokens (the flagship batch's 16384 minus one ignored label per row)
    count as 16384, in both packages."""
    from mxnet_tpu.ops import loss as jloss
    lab = np.zeros(16384, np.float32)
    keep = np.ones(16376, np.float32)
    j = jloss._norm_factor("valid", jnp.asarray(lab),
                           jnp.asarray(keep, jnp.bfloat16))
    t = tloss._norm_factor("valid", torch.from_numpy(lab),
                           torch.from_numpy(keep).to(torch.bfloat16))
    assert t.dtype == torch.bfloat16 and float(t) == 16384.0
    assert float(j) == float(t)


# ---------------------------------------------------------------------------
# initializers: one seed, the same bits in both packages
# ---------------------------------------------------------------------------

# (case id, initializer class name, kwargs, parameter name, shape)
INIT_CASES = [
    ("xavier_uniform_avg", "Xavier", {}, "fc_weight", (16, 24)),
    ("xavier_gaussian_in", "Xavier",
     {"rnd_type": "gaussian", "factor_type": "in", "magnitude": 2},
     "conv_weight", (8, 3, 3, 3)),
    ("xavier_out", "Xavier", {"factor_type": "out"}, "w_weight", (5, 7)),
    ("msra_prelu", "MSRAPrelu", {"slope": 0.1}, "c_weight", (6, 4, 2, 2)),
    ("uniform", "Uniform", {"scale": 0.3}, "fc_weight", (9, 5)),
    ("normal", "Normal", {"sigma": 0.5}, "emb_weight", (11, 4)),
    ("constant", "Constant", {"value": 0.7}, "x_weight", (3, 3)),
    ("one", "One", {}, "x_weight", (2, 5)),
    ("zero", "Zero", {}, "x_weight", (2, 5)),
    ("orthogonal", "Orthogonal", {}, "rnn_weight", (6, 10)),
    ("orthogonal_normal", "Orthogonal", {"rand_type": "normal"},
     "rnn_weight", (10, 6)),
    ("bilinear", "Bilinear", {}, "up_weight", (2, 1, 4, 4)),
    ("lstm_bias", "LSTMBias", {"forget_bias": 2.0}, "lstm_weight", (16,)),
    ("bias_suffix", "Xavier", {}, "fc_bias", (7,)),
    ("gamma_suffix", "Xavier", {}, "ln_gamma", (7,)),
    ("beta_suffix", "Xavier", {}, "ln_beta", (7,)),
]


@pytest.mark.parametrize("cls,kwargs,pname,shape",
                         [c[1:] for c in INIT_CASES],
                         ids=[c[0] for c in INIT_CASES])
def test_initializer_matches_jax_bit_for_bit(cls, kwargs, pname, shape):
    out = []
    for mx, init in ((jmx, jinit), (tmx, tinit)):
        mx.random.seed(42)
        kw = {"ctx": tmx.cpu()} if mx is tmx else {}
        arr = mx.nd.zeros(shape, **kw)
        getattr(init, cls)(**kwargs)(init.InitDesc(pname), arr)
        out.append(arr.asnumpy())
    assert out[0].dtype == out[1].dtype == np.float32
    np.testing.assert_array_equal(out[1], out[0])


def test_initializer_registry_and_dumps_match_jax():
    for spec in ("xavier", "zeros", '["normal", {"sigma": 0.2}]',
                 {"initializer": "uniform", "scale": 0.5}):
        j, t = jinit.create(spec), tinit.create(spec)
        assert type(t).__name__ == type(j).__name__
        assert t.dumps() == j.dumps()
    assert tinit.create("xavier", magnitude=2).magnitude == 2.0
    with pytest.raises(ValueError, match="Unknown initialization"):
        tinit.Xavier()(tinit.InitDesc("mystery"), tmx.nd.zeros(
            (2, 2), ctx=tmx.cpu()))
