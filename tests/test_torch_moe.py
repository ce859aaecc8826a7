"""The MoE FFN, the parallel options of the transformer and MoE
generation in the port against the JAX package, in one process on the
CPU.

The same numpy inputs (and the JAX ``init_state``, carried across by
``convert.state_from_jax``) go through both packages. Tolerances:
symbol JSON equal; routing (expert ids, slots, kept tokens) equal, the
router's gate within rtol 1e-6; the MoE FFN's outputs rtol 1e-5 / atol
1e-6 and its gradients rtol 1e-5 / atol 1e-6 of the gradient's largest
magnitude; one SGD step at lr 1 (w - w' is the gradient) rtol 1e-4 /
atol 1e-5 (``tests/test_torch_lm_options.py``'s); generated tokens equal
token for token in float32.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as jmx
from mxnet_tpu.generation import Generator as JGenerator
from mxnet_tpu.initializer import Xavier as JXavier
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.parallel import make_train_step as jmake_train_step
from mxnet_tpu.parallel import moe as jmoe

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import generation as tgen
from mxnet_tpu_torch.convert import state_from_jax
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step
from mxnet_tpu_torch.parallel import moe as tmoe

V, T, B, E = 40, 16, 2, 4
OUT = dict(rtol=1e-5, atol=1e-6)


def _f32(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _moe_args(N=24, D=8, H=16, seed=0):
    return [_f32((N, D), seed), _f32((D, E), seed + 1, 0.5),
            _f32((E, D, H), seed + 2, 0.2), _f32((E, H, D), seed + 3, 0.2)]


GRAPHS = {
    "moe": ("get_symbol", dict(vocab_size=V, seq_len=T, num_layers=2,
                               num_heads=2, dim=16, num_experts=E)),
    "moe_axes_dropout": ("get_symbol", dict(
        vocab_size=V, seq_len=T, num_layers=2, num_heads=2, dim=16,
        num_experts=E, expert_axis="expert", seq_axis="sp",
        moe_capacity_factor=2.0, dropout=0.1)),
    "seq_axis_gqa_window": ("get_symbol", dict(
        vocab_size=V, seq_len=T, num_layers=1, num_heads=4, dim=16,
        num_kv_heads=2, attention_window=4, seq_axis="sp")),
    "decode_moe": ("get_decode_symbol", dict(
        vocab_size=V, max_len=24, num_layers=2, num_heads=2, dim=16,
        num_experts=E)),
    "decode_moe_int8_per_row": ("get_decode_symbol", dict(
        vocab_size=V, max_len=24, num_layers=1, num_heads=2, dim=16,
        num_experts=E, quantized=True, per_row_pos=True)),
    "stage": ("get_stage_symbol", dict(num_heads=2, dim=16)),
    "stage_rope_window_sp": ("get_stage_symbol", dict(
        num_heads=2, dim=16, pos_encoding="rope", seq_len=8,
        attention_window=4, seq_axis="sp")),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_equals_jax(name):
    fn, kw = GRAPHS[name]
    with jmx.name.NameManager():
        jsym = getattr(jtransformer, fn)(**kw)
    with tmx.name.NameManager():
        tsym = getattr(ttransformer, fn)(**kw)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())


def test_option_refusals_match_jax():
    for mod, exc in ((jtransformer, ValueError), (ttransformer, ValueError)):
        with pytest.raises(exc, match="ssm"):
            mod.get_symbol(V, T, block_type="ssm", seq_axis="sp")
        with pytest.raises(exc, match="seq_len"):
            mod.get_stage_symbol(num_heads=2, dim=16, pos_encoding="rope")


@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
def test_route_matches_jax(cf):
    """The expert ids, slots and kept tokens equal (first come, first
    served through the cumsum; argmax on float32), the gate within rtol
    1e-6."""
    x, gw, _, _ = _moe_args(N=40)
    cap = tmoe._capacity(40, cf, E)
    jr = jmoe._route(jnp.asarray(x), jnp.asarray(gw), E, cap)
    tr = tmoe._route(torch.tensor(x), torch.tensor(gw), E, cap)
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
    np.testing.assert_array_equal(tr[1].clamp(0, cap - 1).numpy(),
                                  np.asarray(jr[1]))
    np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
    np.testing.assert_allclose(tr[3].numpy(), np.asarray(jr[3]), rtol=1e-6)
    assert 0 < int(tr[2].sum()) <= 40


def _assert_grad(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-5,
        atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_dense_moe_matches_jax(cf):
    """dense_moe's output and the gradients of sum(out * cot) in every
    input."""
    args = _moe_args()
    cot = _f32((24, 8), 9)
    jout, vjp = jax.vjp(lambda *a: jmoe.dense_moe(*a, capacity_factor=cf),
                        *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tmoe.dense_moe(*targs, capacity_factor=cf)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **OUT)
    tgrads = torch.autograd.grad(tout, targs, torch.tensor(cot))
    for i, (t, j) in enumerate(zip(tgrads, vjp(jnp.asarray(cot)))):
        _assert_grad(t.numpy(), j, str(i))


def test_per_rank_reference_matches_jax_moe_ffn():
    """``moe_ffn_reference`` (the plain one-process version of moe_ffn's
    per-rank rule, which chip_smoke holds the card's ranks against)
    equals the JAX moe_ffn over a 2-device expert mesh."""
    from jax.sharding import Mesh
    args = _moe_args(N=32)
    mesh = Mesh(np.array(jax.devices()[:2]), ("expert",))
    want = jax.jit(lambda *a: jmoe.moe_ffn(*a, mesh=mesh))(
        *map(jnp.asarray, args))
    got = tmoe.moe_ffn_reference(*map(torch.tensor, args), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


def test_moe_ffn_on_one_rank_is_dense_moe():
    """Off a mesh (or on a one-rank axis) moe_ffn routes the whole token
    set: dense_moe's result."""
    args = [torch.tensor(a) for a in _moe_args()]
    np.testing.assert_array_equal(tmoe.moe_ffn(*args, mesh=None).numpy(),
                                  tmoe.dense_moe(*args).numpy())


def test_moe_lm_step_matches_jax():
    """The MoE LM (num_experts=4, capacity factor 1.25: tokens drop), one
    SGD step at lr 1 from the JAX init: every parameter's gradient and
    the probabilities."""
    kw = dict(num_layers=2, num_heads=2, dim=16, num_experts=E)
    with jmx.name.NameManager():
        jsym = jtransformer.get_symbol(V, T, **kw)
    with tmx.name.NameManager():
        tsym = ttransformer.get_symbol(V, T, **kw)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    jstep = jmake_train_step(jsym, optimizer="sgd")
    jmx.random.seed(3)
    jstate = jstep.init_state(JXavier(), shapes)
    start = jax.tree_util.tree_map(np.asarray, jstate)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, V, (B, T)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"data": toks, "softmax_label": labels}
    jstate, jouts = jstep(jstate, jstep.place_batch(batch), 1.0,
                          jax.random.PRNGKey(0))
    tstep = tmake_train_step(tsym, optimizer="sgd", ctx=tmx.cpu())
    tstate, touts = tstep(state_from_jax(start, "cpu"), batch, 1.0, 0)
    for k, v in jstate[0].items():
        np.testing.assert_allclose(tstate[0][k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(touts[0].detach().numpy(),
                               np.asarray(jouts[0]), **OUT)


def _moe_params():
    sym = jtransformer.get_symbol(V, 16, num_layers=2, num_heads=4, dim=32,
                                  max_len=24, num_experts=E)
    shapes, _, _ = sym.infer_shape(data=(B, 16), softmax_label=(B, 16))
    rng = np.random.RandomState(0)
    return {n: (np.ones(s, np.float32) if n.endswith("_gamma") else
                (rng.randn(*s) * 0.5).astype(np.float32))
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def test_moe_generate_matches_jax():
    """Generator(num_experts=4): greedy and seeded sampling token for
    token against the JAX Generator; generate_on_device (the captured
    step on the card, the same step uncaptured here) equals generate;
    log_likelihood within 1e-5."""
    p = _moe_params()
    kw = dict(num_layers=2, num_heads=4, dim=32, batch_size=B,
              num_experts=E)
    j = JGenerator(p, V, 24, **kw)
    t = tgen.Generator(p, V, 24, ctx=tmx.cpu(), **kw)
    prompt = np.random.RandomState(1).randint(0, V, (B, 5))
    for skw in ({}, dict(temperature=0.8, top_k=10, seed=4)):
        want = j.generate(prompt, 8, **skw)
        got = t.generate(prompt, 8, **skw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            t.generate_on_device(prompt, 8, **skw), got)
    np.testing.assert_allclose(t.log_likelihood(prompt),
                               j.log_likelihood(prompt), rtol=0, atol=1e-5)
    with pytest.raises(TypeError, match="make_mesh"):
        tgen.Generator(p, V, 24, ctx=tmx.cpu(), mesh=object(), **kw)


def test_moe_ops_no_host_read():
    """The route, dispatch and combine on a device tensor read nothing
    back to the host (a captured decode step holds them): they run under
    a meta device, which has no values to read."""
    args = [torch.empty(a.shape, device="meta") for a in _moe_args()]
    out = tmoe.dense_moe(*args, capacity_factor=E)
    assert out.shape == (24, 8) and out.device.type == "meta"
