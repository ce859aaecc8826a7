"""The PyTorch port's ``TrainStep`` against the JAX package's, on the CPU.

A small transformer LM (vocab 50, T 32, 2 layers, 4 heads, dim 64) starts
in both packages from one state: the JAX ``init_state`` under one seed,
carried across with ``convert.state_from_jax``. The JAX step runs its
Pallas flash kernels in interpret mode; the port runs the kernels' plain
versions through the same autograd Functions the card uses. Tolerances:

* gradients (one SGD step, momentum 0, lr 1, wd 0, so w - w' is the
  rescaled gradient) and a 3-step SGD-momentum trajectory: rtol 1e-4 /
  atol 1e-6 (float32; only summation order differs);
* a 3-step Adam trajectory: atol 3 * lr on the weights. Adam's first
  steps move every weight by about +-lr whatever the size of g, so a g
  near 0 can change sign on rounding alone;
* bf16 compute: the step's outputs (probabilities) within 2e-2. The bf16
  gradients cannot agree elementwise at 2e-2: each package rounds to
  bf16 at its own points, which puts either one a few percent (in norm)
  from the float32 gradient and as far from the other. So the test holds
  the port's bf16 gradient to be as close to the float32 gradient as the
  JAX package's is (within 1.25x + 1e-3 of its distance, and under 10%).
"""
import numpy as np
import pytest

import jax
import mxnet_tpu as jmx
from mxnet_tpu.initializer import Xavier as JXavier
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.parallel import make_train_step as jmake_train_step

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import state_from_jax
from mxnet_tpu_torch.initializer import Xavier as TXavier
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.parallel import make_train_step as tmake_train_step

from tests._lm_utils import arith_corpus, lm_nll

V, T, LAYERS, HEADS, DIM, B = 50, 32, 2, 4, 64, 4
SHAPES = {"data": (B, T), "softmax_label": (B, T)}
F32 = dict(rtol=1e-4, atol=1e-6)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (B, T)).astype(np.float32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"data": toks, "softmax_label": labels}


@pytest.fixture(scope="module")
def lm():
    """(JAX symbol, port symbol, initial JAX state as numpy, batch)."""
    jsym = jtransformer.get_symbol(V, T, num_layers=LAYERS,
                                   num_heads=HEADS, dim=DIM)
    tsym = ttransformer.get_symbol(V, T, num_layers=LAYERS,
                                   num_heads=HEADS, dim=DIM)
    jmx.random.seed(3)
    state = jmake_train_step(jsym, optimizer="sgd").init_state(
        JXavier(), SHAPES)
    return jsym, tsym, jax.tree_util.tree_map(np.asarray, state), _batch()


def _np_state(state):
    """A (params, opt_state, aux) state of either package as numpy."""
    def conv(x):       # a copy: the port's donated step updates in place
        if hasattr(x, "detach"):
            return x.detach().float().numpy().copy()
        return np.array(x, np.float32)
    params, opt, aux = state
    return ({k: conv(v) for k, v in params.items()},
            {k: tuple(conv(s) for s in v) for k, v in opt.items()},
            {k: conv(v) for k, v in aux.items()})


def _run_both(lm, optimizer, opt_params, lr, steps, compute_dtype=None,
              clip_norm=None):
    """Train ``steps`` steps in each package from the shared state;
    returns (JAX states, port states, JAX outputs, port outputs), the
    states as numpy, one per step after the initial one."""
    jsym, tsym, state0, batch = lm
    kw = dict(optimizer=optimizer, optimizer_params=dict(opt_params),
              compute_dtype=compute_dtype, clip_norm=clip_norm)
    jstep = jmake_train_step(jsym, donate=False, **kw)
    tstep = tmake_train_step(tsym, ctx=tmx.cpu(), **kw)
    # the shared weights, with this optimizer's zero state slots
    jstate = jstep.init_state(JXavier(), SHAPES, arg_params=state0[0])
    state0 = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = state_from_jax(state0, "cpu")
    jb = jstep.place_batch(batch)
    jstates, tstates = [_np_state(state0)], [_np_state(state0)]
    for i in range(steps):
        jstate, jouts = jstep(jstate, jb, lr, jax.random.PRNGKey(i))
        tstate, touts = tstep(tstate, batch, lr, i)
        jstates.append(_np_state(jstate))
        tstates.append(_np_state(tstate))
    return jstates, tstates, np.asarray(jouts[0], np.float32), \
        touts[0].float().numpy()


def test_one_sgd_step_gives_the_jax_gradients(lm):
    js, ts, jo, to = _run_both(lm, "sgd", {"momentum": 0.0}, 1.0, 1)
    np.testing.assert_allclose(to, jo, **F32)
    for n, w in js[0][0].items():
        np.testing.assert_allclose(w - ts[1][0][n], w - js[1][0][n],
                                   err_msg=n, **F32)


def test_sgd_momentum_trajectory_matches_jax(lm):
    js, ts, _, _ = _run_both(lm, "sgd", {"momentum": 0.9, "wd": 1e-4},
                             0.5, 3)
    for step in (1, 2, 3):
        for n in js[0][0]:
            np.testing.assert_allclose(ts[step][0][n], js[step][0][n],
                                       err_msg="%s step %d" % (n, step),
                                       **F32)
            np.testing.assert_allclose(ts[step][1][n][0], js[step][1][n][0],
                                       err_msg="mom %s" % n, **F32)


def test_adam_trajectory_matches_jax(lm):
    lr = 1e-3
    js, ts, _, _ = _run_both(lm, "adam", {}, lr, 3)
    for step in (1, 2, 3):
        for n in js[0][0]:
            np.testing.assert_allclose(ts[step][0][n], js[step][0][n],
                                       rtol=0, atol=3 * lr,
                                       err_msg="%s step %d" % (n, step))


def test_clip_norm_matches_jax(lm):
    """A global-norm clip small enough to engage on every gradient."""
    js, ts, _, _ = _run_both(lm, "sgd", {"momentum": 0.0}, 1.0, 1,
                             clip_norm=0.05)
    total = np.sqrt(sum(np.sum(np.square(w - js[1][0][n]))
                        for n, w in js[0][0].items()))
    assert total == pytest.approx(0.05, rel=1e-4)
    for n, w in js[0][0].items():
        np.testing.assert_allclose(w - ts[1][0][n], w - js[1][0][n],
                                   err_msg=n, **F32)


def test_bf16_step_matches_jax_within_bf16_noise(lm):
    js, ts, jo, to = _run_both(lm, "sgd", {"momentum": 0.0}, 1.0, 1,
                               compute_dtype="bfloat16")
    f32, _, _, _ = _run_both(lm, "sgd", {"momentum": 0.0}, 1.0, 1)
    np.testing.assert_allclose(to, jo, rtol=0, atol=2e-2)
    for n, w in js[0][0].items():
        ref = w - f32[1][0][n]
        jd = np.linalg.norm((w - js[1][0][n]) - ref) / np.linalg.norm(ref)
        td = np.linalg.norm((w - ts[1][0][n]) - ref) / np.linalg.norm(ref)
        assert jd < 0.1 and td < 0.1, (n, jd, td)
        assert td <= 1.25 * jd + 1e-3, (n, jd, td)


def test_init_state_is_bit_identical_to_jax(lm):
    """Host-side Xavier draws from np.random.default_rng(seed) in both
    packages, so one seed gives the same float32 bits."""
    _, tsym, state0, _ = lm
    tmx.random.seed(3)
    params, opt, aux = tmake_train_step(
        tsym, optimizer="sgd", ctx=tmx.cpu()).init_state(TXavier(), SHAPES)
    assert sorted(params) == sorted(state0[0]) and aux == {}
    for n, v in params.items():
        assert v.dtype == tmx.base.torch_dtype("float32")
        np.testing.assert_array_equal(v.numpy(), state0[0][n], err_msg=n)
        assert len(opt[n]) == 1 and not opt[n][0].any()


def test_donate_updates_in_place_and_no_donate_leaves_inputs(lm):
    _, tsym, state0, batch = lm
    for donate in (True, False):
        step = tmake_train_step(tsym, optimizer="sgd", donate=donate,
                                optimizer_params={"momentum": 0.9},
                                ctx=tmx.cpu())
        state = state_from_jax(state0, "cpu")
        before = {n: v.clone() for n, v in state[0].items()}
        new, _ = step(state, batch, 0.1, 0)
        for n, v in state[0].items():
            assert (new[0][n] is v) == donate
            assert torch_equal(v, before[n]) != donate, n
            assert torch_equal(new[0][n], v) == donate


def torch_equal(a, b):
    return bool((a == b).all())


@pytest.mark.parametrize("kw,match", [
    ({"mesh": object()}, "Queue A item 9"),
    ({"layout": object()}, "Queue A item 9"),
    ({"optimizer_sharding": "zero1"}, "Queue A item 9"),
])
def test_unported_options_raise(lm, kw, match):
    """mesh= takes the port's mesh (``parallel.sharding.make_mesh``) and
    layout= its ``SpecLayout`` (both ported with ``match``'s item 9b);
    any other object raises TypeError naming what to pass. zero1 without
    a 'data' axis raises the JAX package's ValueError."""
    if kw.get("optimizer_sharding") == "zero1":
        with pytest.raises(ValueError, match="replica axis"):
            tmake_train_step(lm[1], ctx=tmx.cpu(), **kw)
        return
    with pytest.raises(TypeError, match="make_mesh|SpecLayout"):
        tmake_train_step(lm[1], ctx=tmx.cpu(), **kw)


def test_compute_dtype_leaves_ids_and_labels_uncast(lm):
    """Embedding-fed data is found from the graph and keeps float32 ids
    (bf16 would alias ids >= 256); labels are never cast."""
    step = tmake_train_step(lm[1], compute_dtype="bfloat16", ctx=tmx.cpu())
    assert step._id_inputs == {"data"}


def test_lm_loss_gate():
    """The port's seeded transformer LM (learned positions): NLL must
    drop below half its initial value within 30 Adam steps — the JAX
    package's gate (tests/test_train_gates.py) on the port."""
    vocab, seq, batch = 32, 16, 16
    toks, labels = arith_corpus(batch, seq, vocab)
    sym = ttransformer.get_symbol(vocab, seq, num_layers=1, num_heads=2,
                                  dim=32)
    step = tmake_train_step(sym, optimizer="adam", ctx=tmx.cpu())
    tmx.random.seed(11)
    np.random.seed(11)
    state = step.init_state(TXavier(), {"data": (batch, seq),
                                        "softmax_label": (batch, seq)})
    feed = step.place_batch({"data": toks, "softmax_label": labels})
    state, outs = step(state, feed, 3e-3, 0)
    first = lm_nll([outs[0].numpy()], labels, vocab)
    for _ in range(30):
        state, outs = step(state, feed, 3e-3, 0)
    final = lm_nll([outs[0].numpy()], labels, vocab)
    assert final < first / 2, (first, final)


@pytest.mark.parametrize("key", ["jax_key", "int_seed"])
def test_dropout_lm_step_matches_jax(lm, key):
    """The LM with dropout=0.1 (a Dropout on every FFN output) trained
    one SGD step from the same weights and key: the masks are the JAX
    package's bits (fold_in(key, uid) per Dropout node), so the
    outputs and the gradients agree in float32. The port takes the JAX
    key's uint32[2], or the int seed as PRNGKey(seed)."""
    _jsym, _tsym, state0, batch = lm
    kw = dict(num_layers=LAYERS, num_heads=HEADS, dim=DIM, dropout=0.1)
    jsym = jtransformer.get_symbol(V, T, **kw)
    tsym = ttransformer.get_symbol(V, T, **kw)
    assert sum(n.startswith("dropout") for n in
               tsym.get_internals().list_outputs()) == LAYERS
    opt = dict(optimizer="sgd", optimizer_params={"momentum": 0.0})
    jstep = jmake_train_step(jsym, donate=False, **opt)
    tstep = tmake_train_step(tsym, ctx=tmx.cpu(), **opt)
    jkey = jax.random.PRNGKey(11)
    jstate, jouts = jstep(state0, jstep.place_batch(batch), 1.0, jkey)
    tstate, touts = tstep(state_from_jax(state0, "cpu"), batch, 1.0,
                          np.asarray(jkey) if key == "jax_key" else 11)
    np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]),
                               **F32)
    for n, w in state0[0].items():
        np.testing.assert_allclose(w - tstate[0][n].numpy(),
                                   w - np.asarray(jstate[0][n]),
                                   err_msg=n, **F32)
    # another key draws other masks: the step's output moves
    other, _ = tstep(state_from_jax(state0, "cpu"), batch, 1.0, 12)
    assert not np.array_equal(other[0]["lm_head_weight"].numpy(),
                              tstate[0]["lm_head_weight"].numpy())
