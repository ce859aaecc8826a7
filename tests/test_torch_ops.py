"""The PyTorch port's ops against the JAX package's registry functions.

One parametrised forward sweep: the same numpy-seeded inputs go through
``mxnet_tpu``'s op and ``mxnet_tpu_torch``'s op of the same name, with
attrs canonicalized by each package's registry; float32 outputs must
agree within rtol 1e-5 / atol 1e-6 (different summation orders on the
CPU), integer outputs exactly. The loss heads' custom backward passes
are held against ``jax.vjp`` of the JAX ops with the same cotangent
(float32 within the same tolerance; bf16 within rtol 1e-2 / atol 1e-6
relative to the gradient, one bf16 rounding step), and the initializers
after one ``mx.random.seed`` must fill bit-identical values.
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


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,inputs,attrs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_op_forward_matches_jax(name, inputs, attrs):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert jop.name == top.name
    j_out = _as_list(jop.fn(*[jnp.asarray(x) for x in inputs],
                            **jreg.canon_attrs(jop, attrs)))
    t_out = _as_list(top.fn(*[torch.from_numpy(x.copy()) for x in inputs],
                            **treg.canon_attrs(top, attrs)))
    assert len(j_out) == len(t_out)
    for j, t in zip(j_out, t_out):
        j = np.asarray(j)
        t = t.numpy()
        assert j.shape == t.shape and j.dtype == t.dtype, \
            (j.shape, t.shape, j.dtype, t.dtype)
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(t, j)


def _relu_grid(shape, seed=0):
    """Rounded relu outputs: many exact zeros and tied maxima."""
    return np.maximum(np.round(_f32(*shape, seed=seed) * 2), 0)


# (case id, op name, inputs, attrs, env) — forward AND gradient of every
# float input against jax.vjp with one random cotangent
GRAD_CASES = [
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


@pytest.mark.parametrize("name,inputs,attrs,env",
                         [c[1:] for c in GRAD_CASES],
                         ids=[c[0] for c in GRAD_CASES])
def test_op_gradient_matches_jax(name, inputs, attrs, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jop, top = jreg.get_op(name), treg.get_op(name)
    jattrs, tattrs = jreg.canon_attrs(jop, attrs), treg.canon_attrs(top,
                                                                    attrs)
    jout, vjp = jax.vjp(lambda *xs: jop.fn(*xs, **jattrs),
                        *[jnp.asarray(x) for x in inputs])
    txs = [torch.from_numpy(x.copy()).requires_grad_() for x in inputs]
    tout = top.fn(*txs, **tattrs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    cot = _f32(*jout.shape, seed=9)
    jgrads = vjp(jnp.asarray(cot))
    tgrads = torch.autograd.grad(tout, txs, torch.from_numpy(cot))
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5, err_msg="input %d" % i)


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
    jattrs, tattrs = jreg.canon_attrs(jop, attrs), treg.canon_attrs(top,
                                                                    attrs)
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
