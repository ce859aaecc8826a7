"""The port's ``TrainStep.export`` -> ``CompiledTrainStep`` against the
JAX package's, on the CPU (after ``tests/test_parallel.py``
``test_train_step_export_compiled_roundtrip``).

Both packages export the same step (an MLP with SGD momentum, and one
with a Dropout, whose masks follow the seed) from one state; the port's
meta equals the JAX meta on every key the JAX export writes, and the
``.state.npz`` arrays are equal. Then 40 steps of each
``CompiledTrainStep`` from the same batches, lrs and default seeds land
within rtol 1e-5 / atol 1e-6 of each other (float32; only summation
order differs); the port's compiled step equals its direct
``TrainStep`` steps with ``PRNGKey(seed)`` bit for bit. ``save_state``
round-trips, shape errors are loud, and a prefix holding only the JAX
package's StableHLO program raises a ValueError that says why.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.initializer import Xavier as JXavier
from mxnet_tpu.parallel import make_train_step as jmake_train_step
from mxnet_tpu.parallel.trainer import CompiledTrainStep as JCompiled

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step
from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep

B, D, STEPS = 32, 8, 40
TOL = dict(rtol=1e-5, atol=1e-6)


def _net(mx, dropout):
    h = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=16, name="fc1"),
        act_type="relu")
    if dropout:
        h = mx.sym.Dropout(h, p=0.5, name="drop")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        h, num_hidden=2, name="fc2"), name="softmax")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((B, D)).astype(np.float32)
    y = (X @ rng.standard_normal(D) > 0).astype(np.float32)
    return {"data": X, "softmax_label": y}


OPT = {"momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0 / B}


def _export_both(tmp_path, dropout):
    """(jax prefix, port prefix, the JAX state as numpy) from one JAX
    init_state, the port's step adopting it."""
    batch = _data()
    jstep = jmake_train_step(_net(jmx, dropout), optimizer="sgd",
                             optimizer_params=OPT)
    jmx.random.seed(3)
    jstate = jstep.init_state(JXavier(), {"data": (B, D),
                                          "softmax_label": (B,)})
    jprefix = str(tmp_path / "jax")
    jstep.export(jprefix, jstate, jstep.place_batch(batch))
    params = {k: np.asarray(v) for k, v in jstate[0].items()}
    tstep = tmake_train_step(_net(tmx, dropout), optimizer="sgd",
                             optimizer_params=OPT, ctx=tmx.cpu())
    tstate = tstep.init_state(None, {"data": (B, D), "softmax_label": (B,)},
                              arg_params=params)
    tprefix = str(tmp_path / "port")
    path = tstep.export(tprefix, tstate, batch)
    assert path == tprefix + ".train.meta.json"
    return jprefix, tprefix, tstep, tstate


@pytest.mark.parametrize("dropout", [False, True])
def test_export_meta_and_state_match_jax(tmp_path, dropout):
    jprefix, tprefix, _, _ = _export_both(tmp_path, dropout)
    with open(jprefix + ".train.meta.json") as f:
        jmeta = json.load(f)
    with open(tprefix + ".train.meta.json") as f:
        tmeta = json.load(f)
    assert set(tmeta) == set(jmeta) | {"torch_step"}
    for k in jmeta:
        assert tmeta[k] == jmeta[k], k
    rebuild = tmeta["torch_step"]
    assert rebuild["optimizer"] == "sgd" and rebuild["remat"] is False
    assert rebuild["optimizer_params"] == OPT
    assert rebuild["data_names"] == ["data"]
    assert rebuild["label_names"] == ["softmax_label"]
    assert rebuild["compute_dtype"] is None and rebuild["clip_norm"] is None
    with np.load(jprefix + ".state.npz") as j, \
            np.load(tprefix + ".state.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def _lr(i):
    return 0.05 * (1.0 + np.cos(np.pi * i / STEPS)) / 2 + 1e-3


@pytest.mark.parametrize("dropout", [False, True])
def test_compiled_steps_track_jax_compiled_steps(tmp_path, dropout):
    """40 steps with a new lr each and the default seeds (0, 1, ...):
    the port's CompiledTrainStep within TOL of the JAX one, and bit for
    bit its own direct TrainStep with PRNGKey(i)."""
    jprefix, tprefix, tstep, tstate = _export_both(tmp_path, dropout)
    jct = JCompiled.load(jprefix)
    with tmx.cpu():
        tct = CompiledTrainStep.load(tprefix)
    assert tct.batch_names == jct.batch_names == ["data", "softmax_label"]
    assert tct.batch_shapes == jct.batch_shapes
    assert tct.device.type == "cpu"
    batches = [_data(seed) for seed in range(4)]
    for i in range(STEPS):
        b = batches[i % 4]
        touts = tct.step(b, lr=_lr(i))
        jouts = jct.step(b, lr=_lr(i))
        np.testing.assert_allclose(touts[0], np.asarray(jouts[0]), **TOL)
    tp, jp = tct.get_params(), jct.get_params()
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), err_msg=k,
                                   **TOL)
    state = tstate
    for i in range(STEPS):
        state, _ = tstep(state, batches[i % 4], _lr(i),
                         tmx.random.PRNGKey(i))
    for k, v in state[0].items():
        np.testing.assert_array_equal(tp[k], v.numpy(), err_msg=k)


def test_dropout_seed_moves_the_mask(tmp_path):
    """Seeds 0 and 1 give the compiled step different masks, so
    different outputs from one state; seed 0 twice gives the same."""
    _, tprefix, _, _ = _export_both(tmp_path, True)
    b = _data()
    with tmx.cpu():
        outs = [CompiledTrainStep.load(tprefix).step(b, 0.0, seed=s)[0]
                for s in (0, 1, 0)]
    assert not np.array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_save_state_round_trip_and_loud_errors(tmp_path):
    _, tprefix, _, _ = _export_both(tmp_path, True)
    b = _data()
    with tmx.cpu():
        ct = CompiledTrainStep.load(tprefix)
        for i in range(3):
            ct.step(b, 0.01)
        ct.save_state(tprefix)
        ct2 = CompiledTrainStep.load(tprefix)
    assert ct2._step_count == 3
    for k, v in ct.get_params().items():
        np.testing.assert_array_equal(ct2.get_params()[k], v, err_msg=k)
    assert ct2.get_param_shape("fc1_weight") == (16, D)
    with pytest.raises(KeyError, match="unknown param"):
        ct2.get_param_shape("nope")
    # the reloaded step continues the default seeds: its next step
    # equals the first step's fourth
    np.testing.assert_array_equal(ct2.step(b, 0.01)[0], ct.step(b, 0.01)[0])
    with pytest.raises(ValueError, match="shape"):
        ct.step({"data": b["data"][:8], "softmax_label": b["softmax_label"][:8]},
                0.01)
    with pytest.raises(ValueError, match="missing"):
        ct.step({"data": b["data"]}, 0.01)


def test_jax_only_prefix_raises(tmp_path):
    """A prefix the JAX package exported (a StableHLO program and a meta
    without the port's entry) says why it cannot load."""
    jprefix, _, _, _ = _export_both(tmp_path, False)
    with pytest.raises(ValueError, match="StableHLO"):
        CompiledTrainStep.load(jprefix)
    with pytest.raises(ValueError, match="no exported training step"):
        CompiledTrainStep.load(str(tmp_path / "nothing"))


def test_device_keys_draw_the_host_keys_bits():
    """A key built from a seed tensor (what the captured step builds from
    its static seed) draws the host key's bits: PRNGKey, fold_in,
    random_bits and a Dropout mask; the key stays a tensor throughout."""
    import torch
    from mxnet_tpu_torch import _threefry as tf

    for seed in (0, 1, 7, 2 ** 32 + 5):
        dev_key = tf.PRNGKey(torch.tensor(seed))
        assert isinstance(dev_key, torch.Tensor)
        np.testing.assert_array_equal(dev_key.numpy(), tf.PRNGKey(seed))
        for uid in (0, 3, 11):
            dk = tf.fold_in(dev_key, uid)
            hk = tf.fold_in(tf.PRNGKey(seed), uid)
            np.testing.assert_array_equal(dk.numpy(), hk)
            for width in (8, 32, 64):
                assert torch.equal(tf.random_bits(dk, (5, 7), width, "cpu"),
                                   tf.random_bits(hk, (5, 7), width, "cpu"))
            assert torch.equal(tf.bernoulli(dk, 0.5, (64,), "cpu"),
                               tf.bernoulli(hk, 0.5, (64,), "cpu"))
    assert tf.as_key(dev_key) is dev_key
    with pytest.raises(ValueError, match="uint32"):
        tf.as_key(torch.zeros(3, dtype=torch.int64))


def test_capture_refuses_an_update_that_reads_lr_on_the_host(tmp_path):
    """Only the multi-tensor update (sgd, adam) reads the lr on the
    device; a step with another optimizer would replay its first lr
    forever, so its capture raises before anything is recorded."""
    tstep = tmake_train_step(_net(tmx, False), optimizer="rmsprop",
                             ctx=tmx.cpu())
    state = tstep.init_state(tmx.initializer.Xavier(),
                             {"data": (B, D), "softmax_label": (B,)})
    prefix = str(tmp_path / "rms")
    tstep.export(prefix, state, _data())
    with tmx.cpu():
        ct = CompiledTrainStep.load(prefix)
        assert ct.step(_data(), 0.01)[0].shape == (B, 2)
        with pytest.raises(ValueError, match="lr on the device"):
            ct._capture(ct._feed(_data()), 0.01, 0)
