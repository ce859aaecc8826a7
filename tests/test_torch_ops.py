"""The PyTorch port's ops against the JAX package's registry functions.

One parametrised forward sweep: the same numpy-seeded inputs go through
``mxnet_tpu``'s op and ``mxnet_tpu_torch``'s op of the same name, with
attrs canonicalized by each package's registry; float32 outputs must
agree within rtol 1e-5 / atol 1e-6 (different summation orders on the
CPU), integer outputs exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch  # noqa: F401  (populates the port's registry)
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
