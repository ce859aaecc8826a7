"""The transformer LM's options in the port against the JAX package, on
the CPU: RoPE (``_contrib_RoPE``), SSM layers (``block_type``) and the
chunked-CE head (``loss_chunk``).

The same numpy inputs and the JAX ``init_state`` (carried across by
``convert.state_from_jax``) go through both packages. Tolerances:

* RoPE in float32: within 2 ulps of the largest output (torch's ``pow``,
  ``cos`` and ``sin`` differ from XLA's CPU ones in the last bits; the
  worst seen is 1 ulp at that scale); in bf16 equal;
* one SGD step (momentum 0, lr 1, so w - w' is the gradient): rtol 1e-4 /
  atol 1e-5 (float32 sums in another order; the SSM scan's log-sigmoid);
* one Adam step (the hybrid stack): atol 3 * lr (Adam moves each weight
  by about lr whatever the size of g, so a g near 0 can change sign on
  rounding alone);
* the chunked head against the dense head inside the port: parameters
  after one SGD step within rtol 2e-5 / atol 2e-5, as
  ``tests/test_transformer.py`` holds the JAX package's.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as jmx
from mxnet_tpu.initializer import Xavier as JXavier
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.parallel import make_train_step as jmake_train_step

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch.convert import state_from_jax
from mxnet_tpu_torch.initializer import Xavier as TXavier
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step

V, T, LAYERS, HEADS, DIM, B = 40, 24, 2, 4, 32, 2
SHAPES = {"data": (B, T), "softmax_label": (B, T)}
SGD = dict(rtol=1e-4, atol=1e-5)

CONFIGS = {
    "rope": dict(pos_encoding="rope"),
    "ssm": dict(block_type="ssm"),
    "hybrid": dict(block_type=("attention", "ssm"), pos_encoding="rope"),
    "loss_chunk": dict(loss_chunk=16),
}


def _symbols(**kw):
    with jmx.name.NameManager():
        jsym = jtransformer.get_symbol(V, T, num_layers=LAYERS,
                                       num_heads=HEADS, dim=DIM, **kw)
    with tmx.name.NameManager():
        tsym = ttransformer.get_symbol(V, T, num_layers=LAYERS,
                                       num_heads=HEADS, dim=DIM, **kw)
    return jsym, tsym


def _batch(seed=0, ignored=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (B, T)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :ignored] = -1
    return {"data": toks, "softmax_label": labels}


def _rope_case(per_row, dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 3, 17, 16) * 3).astype(np.float32)
    pos = rng.randint(0, 5000, (2, 17)) if per_row else np.arange(17) * 37
    return x, pos.astype(np.float32)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_rope_op_matches_jax(per_row):
    """(T,) and (B, T) positions: float32 within 2 ulps of the largest
    output, bf16 equal; the half-split pairing of the JAX op."""
    x, pos = _rope_case(per_row, "float32")
    j = np.asarray(jatt._rope_op(jnp.asarray(x), jnp.asarray(pos)))
    t = tatt._rope_op(torch.tensor(x), torch.tensor(pos)).numpy()
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=2 * np.spacing(np.abs(j).max()))
    jb = jatt._rope_op(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    tb = tatt._rope_op(torch.tensor(x).bfloat16(), torch.tensor(pos))
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb.astype(jnp.float32)))
    # half-split: dim i pairs with i + hd/2 (position 0 rotates nothing)
    zero = tatt.rope(torch.tensor(x[:, :, :1]), torch.zeros(1))
    np.testing.assert_array_equal(zero.numpy(), x[:, :, :1])


def test_rope_gradient_matches_jax():
    x, pos = _rope_case(False, "float32")
    cot = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jatt.rope(a, jnp.asarray(pos)) * cot))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (tg,) = torch.autograd.grad(tatt.rope(tx, torch.tensor(pos)), tx,
                                torch.tensor(cot))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=4 * np.spacing(np.abs(cot).max()))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_equals_jax(name):
    """The same JSON, arguments, aux states and inferred shapes (the
    chunked head's output is the per-token loss (B, T))."""
    jsym, tsym = _symbols(**CONFIGS[name])
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert tsym.infer_shape(**SHAPES) == jsym.infer_shape(**SHAPES)
    if name == "loss_chunk":
        assert tsym.infer_shape(**SHAPES)[1] == [(B, T)]


@pytest.mark.parametrize("kw,match", [
    (dict(pos_encoding="alibi"), "'learned' or 'rope'"),
    (dict(pos_encoding="rope", dim=36, num_heads=4), "even head_dim"),
    (dict(block_type=("ssm",)), "names each layer"),
    (dict(block_type="mamba"), "'attention' or 'ssm'"),
    (dict(block_type="ssm", attention_window=4), "attention layer"),
], ids=["pos", "odd_head", "count", "kind", "window"])
def test_option_refusals_match_jax(kw, match):
    kw = dict(dict(num_layers=LAYERS, num_heads=HEADS, dim=DIM), **kw)
    with pytest.raises(ValueError, match=match):
        jtransformer.get_symbol(V, T, **kw)
    with pytest.raises(ValueError, match=match):
        ttransformer.get_symbol(V, T, **kw)


@pytest.mark.parametrize("kw", [dict(num_experts=4), dict(seq_axis="sp")],
                         ids=["moe", "seq_axis"])
def test_parallel_options_raise_naming_item_9(kw):
    """Item 9a ported these options: the graphs equal the JAX package's
    (MoE in the decode graph too), and seq_axis keeps the JAX refusal
    with SSM layers."""
    jsym, tsym = _symbols(**kw)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    if "num_experts" in kw:
        with jmx.name.NameManager():
            jdec = jtransformer.get_decode_symbol(V, T, **kw)
        with tmx.name.NameManager():
            tdec = ttransformer.get_decode_symbol(V, T, **kw)
        assert json.loads(tdec.tojson()) == json.loads(jdec.tojson())
    else:
        with pytest.raises(ValueError, match="ssm"):
            ttransformer.get_symbol(V, T, block_type="ssm", **kw)


def _np(x):
    if hasattr(x, "detach"):
        return x.detach().float().numpy().copy()
    return np.array(x, np.float32)


def _one_step(kw, optimizer, lr, opt_params=None):
    """One step of each package's TrainStep from the JAX init: (JAX
    params, port params, JAX outputs, port outputs) as numpy."""
    jsym, tsym = _symbols(**kw)
    opt_params = dict(opt_params or {})
    jstep = jmake_train_step(jsym, optimizer=optimizer,
                             optimizer_params=opt_params)
    jmx.random.seed(3)
    jstate = jstep.init_state(JXavier(), SHAPES)
    start = jax.tree_util.tree_map(np.asarray, jstate)
    batch = _batch(ignored=5)
    jstate, jouts = jstep(jstate, jstep.place_batch(batch), lr,
                          jax.random.PRNGKey(0))
    tstep = tmake_train_step(tsym, optimizer=optimizer, ctx=tmx.cpu(),
                             optimizer_params=opt_params)
    tstate, touts = tstep(state_from_jax(start, "cpu"), batch, lr, 0)
    return ({k: _np(v) for k, v in jstate[0].items()},
            {k: _np(v) for k, v in tstate[0].items()},
            [_np(o) for o in jouts], [_np(o) for o in touts])


@pytest.mark.parametrize("name,optimizer", [("rope", "sgd"),
                                            ("hybrid", "adam")])
def test_train_step_matches_jax(name, optimizer):
    """One TrainStep step from the JAX init. SGD at lr 1, no momentum:
    w - w' is the gradient, so the parameters after the step hold every
    parameter's gradient (rtol 1e-4 / atol 1e-5). Adam at lr 1e-3:
    within 3 * lr. The outputs (probabilities, or the chunked head's
    per-token losses) within rtol 1e-5."""
    lr = 1.0 if optimizer == "sgd" else 1e-3
    jp, tp, jo, to = _one_step(CONFIGS[name], optimizer, lr)
    assert sorted(jp) == sorted(tp)
    tol = SGD if optimizer == "sgd" else dict(rtol=0, atol=3 * lr)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], err_msg=k, **tol)
    for a, b in zip(to, jo):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_chunked_head_matches_dense_head():
    """Inside the port, the chunked head's parameter gradients equal the
    dense head's (one SGD step from one init, a chunk that does not
    divide B*T, ignored labels): its output is the per-token loss (B, T),
    zero where the label is ignored, and the ones head cotangent makes
    its gradient SoftmaxOutput's."""
    batch = _batch(seed=1, ignored=7)
    results = {}
    for tag, kw in (("dense", {}), ("chunk", {"loss_chunk": 7})):
        sym = ttransformer.get_symbol(V, T, num_layers=1, num_heads=2,
                                      dim=16, **kw)
        step = tmake_train_step(sym, optimizer="sgd", ctx=tmx.cpu())
        tmx.random.seed(3)
        state = step.init_state(TXavier(), SHAPES)
        state, outs = step(state, batch, 0.1, 0)
        results[tag] = ({k: v.numpy() for k, v in state[0].items()},
                        outs[0].numpy())
    dense, _ = results["dense"]
    chunk, loss = results["chunk"]
    assert loss.shape == (B, T) and np.isfinite(loss).all()
    assert np.abs(loss[batch["softmax_label"] == -1]).max() == 0.0
    for k in dense:
        np.testing.assert_allclose(chunk[k], dense[k], rtol=2e-5, atol=2e-5,
                                   err_msg=k)


def test_chunked_head_fit_takes_the_loss_output():
    """fit takes the chunked head's output as TrainStep does (the step
    itself is held against the JAX step above): one epoch of two batches
    through NDArrayIter with the Loss metric lands on the parameters of
    two direct steps bit for bit, and the metric is the mean of the
    per-token losses the two steps returned."""
    sym = ttransformer.get_symbol(V, T, num_layers=1, num_heads=2, dim=16,
                                  **CONFIGS["loss_chunk"])
    b0, b1 = _batch(seed=0, ignored=3), _batch(seed=1)
    runs = []
    for via_fit in (True, False):
        step = tmake_train_step(sym, optimizer="sgd", ctx=tmx.cpu())
        tmx.random.seed(3)
        state = step.init_state(TXavier(), SHAPES)
        if via_fit:
            with tmx.cpu():
                it = tio.NDArrayIter(
                    np.concatenate([b0["data"], b1["data"]]),
                    np.concatenate([b0["softmax_label"],
                                    b1["softmax_label"]]), batch_size=B)
            state, val = step.fit(it, num_epoch=1, state=state, lr=0.5,
                                  eval_metric=tmetric.Loss())
        else:
            losses = []
            for i, b in enumerate((b0, b1)):
                state, outs = step(state, b, 0.5, i)
                losses.append(outs[0].numpy())
            val = float(np.mean(losses))
        runs.append(({k: v.numpy().copy() for k, v in state[0].items()},
                     val))
    for k, v in runs[1][0].items():
        np.testing.assert_array_equal(runs[0][0][k], v, err_msg=k)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-6)
