"""The port's SSM ops (``mxnet_tpu_torch/ops/ssm.py``) against the JAX
package's (``mxnet_tpu/ops/ssm.py``), on the CPU.

The same numpy inputs go through both. Tolerances: the chunked scan's
forward and the gradient of every input within rtol 1e-5 (atol 1e-5 on
the outputs, 1e-4 on the gradients, whose magnitudes reach ~10): torch's
``F.logsigmoid`` and float32 sums differ from XLA's in the last ulps. The
width-1 chunk against the recurrent step is held bit for bit inside the
port (the state hand-off rule), as the JAX package holds it under jit.
The arithmetic-corpus gate of ``tests/test_ssm.py`` runs on the port's
pure SSM stack at that test's settings.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import ssm as jssm
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.initializer import Xavier
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import ssm as tssm
from mxnet_tpu_torch.parallel import make_train_step

from tests._lm_utils import arith_corpus, lm_nll

B_, H_, D_ = 2, 3, 8
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-5, atol=1e-4)


def _inputs(T, seed=0, state=False):
    rng = np.random.RandomState(seed)
    out = [rng.randn(B_, H_, T, D_).astype(np.float32) for _ in range(3)]
    out.append(rng.randn(B_, H_, T).astype(np.float32))
    if state:
        out.append(rng.randn(B_, H_, D_, D_).astype(np.float32) * 0.3)
    return out


def _t(xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


SCAN_CASES = ((13, 1), (29, 8), (70, 64))     # (T, chunk): ragged T


@pytest.fixture(scope="module")
def jax_scans():
    """(inputs, cotangent, JAX output, JAX gradients) of each SCAN_CASES
    entry, all under one jax.jit (one compile)."""
    cases = []
    for T, chunk in SCAN_CASES:
        cot = np.random.RandomState(7).randn(B_, H_, T, D_).astype(
            np.float32)
        cases.append((chunk, _inputs(T, seed=T + chunk), cot))

    def run(args):
        res = []
        for (chunk, _, _), (xs, cot) in zip(cases, args):
            def f(*a):
                return jssm._ssm_scan_op(*a, chunk=chunk)
            out, vjp = jax.vjp(f, *xs)
            res.append((out, vjp(cot)))
        return res

    res = jax.jit(run)([(list(map(jnp.asarray, xs)), jnp.asarray(cot))
                        for _, xs, cot in cases])
    return {case: (xs, cot, np.asarray(out), [np.asarray(g) for g in grads])
            for case, (_, xs, cot), (out, grads)
            in zip(SCAN_CASES, cases, res)}


@pytest.mark.parametrize("T,chunk", SCAN_CASES)
def test_scan_forward_and_gradients_match_jax(T, chunk, jax_scans):
    """_contrib_SSMScan at ragged T (not a multiple of the chunk) and
    chunks 1, 8, 64: the output, and the gradient of q, k, v and the gate
    under one cotangent."""
    xs, cot, jout, jgrads = jax_scans[(T, chunk)]
    ts = _t(xs, grad=True)
    top = treg.get_op("_contrib_SSMScan")
    tout = top.fn(*ts, chunk=chunk)
    np.testing.assert_allclose(tout.detach().numpy(), jout, **FWD)
    tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(cot))
    for name, tg, jg in zip("qkvg", tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), jg, err_msg=name, **GRAD)


def test_carried_state_scan_matches_jax():
    q, k, v, g, s = _inputs(11, seed=3, state=True)
    jo, js = jssm.ssm_chunk_scan(*map(jnp.asarray, (q, k, v, g)),
                                 state=jnp.asarray(s), chunk=4)
    to, ts = tssm.ssm_chunk_scan(*_t((q, k, v, g)), state=torch.tensor(s),
                                 chunk=4)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FWD)


def test_width1_chunk_is_bitwise_the_recurrent_step():
    """Inside the port, a width-1 chunk scan and a chain of recurrent
    steps give the same outputs and exit state bit for bit (the hand-off
    rule), from a carried state, in float32 and from bf16 q/k/v."""
    q, k, v, g, s = _inputs(9, seed=5, state=True)
    for dt in (torch.float32, torch.bfloat16):
        tq, tk, tv = (torch.tensor(x).to(dt) for x in (q, k, v))
        tg, st = torch.tensor(g), torch.tensor(s)
        out_c, st_c = tssm.ssm_chunk_scan(tq, tk, tv, tg, state=st,
                                          chunk=1)
        outs = []
        for t in range(q.shape[2]):
            o, st = tssm.ssm_recurrent_step(
                tq[:, :, t:t + 1], tk[:, :, t:t + 1], tv[:, :, t:t + 1],
                tg[:, :, t:t + 1], st)
            outs.append(o)
        assert torch.equal(out_c, torch.cat(outs, dim=2)), dt
        assert torch.equal(st_c, st), dt


def test_cached_op_prefill_then_steps_matches_jax():
    """_contrib_SSMCached: a 7-token prefill (the chunked scan from the
    carried state) then 4 one-token steps (the recurrent form), against
    the JAX op; the state is written in place and returned."""
    q, k, v, g = _inputs(11, seed=9)
    pos = np.zeros((1,), np.float32)
    jst = jnp.zeros((B_, H_, D_, D_), jnp.float32)
    tst = torch.zeros((B_, H_, D_, D_))
    top = treg.get_op("_contrib_SSMCached")
    for a, b in ((0, 7), (7, 8), (8, 9), (9, 10), (10, 11)):
        sl = [x[:, :, a:b] for x in (q, k, v, g)]
        jo, jst = jssm._ssm_cached_op(*map(jnp.asarray, sl), jst,
                                      jnp.asarray(pos), chunk=4)
        to, new = top.fn(*_t(sl), tst, torch.tensor(pos), chunk=4)
        assert new is tst
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **FWD)


def test_cached_op_ignores_pos_and_dispatches_on_tnew():
    q, k, v, g, s = _inputs(1, seed=2, state=True)
    top = treg.get_op("_contrib_SSMCached")
    outs = []
    for pos in (np.zeros((1,), np.float32), np.full((2,), 5, np.float32)):
        st = torch.tensor(s)
        o, st = top.fn(*_t((q, k, v, g)), st, torch.tensor(pos))
        outs.append((o, st))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    o_r, st_r = tssm.ssm_recurrent_step(*_t((q, k, v, g)), torch.tensor(s))
    assert torch.equal(outs[0][0], o_r) and torch.equal(outs[0][1], st_r)


def test_shape_errors_match_jax():
    q, k, v, g, s = _t(_inputs(6, state=True))
    with pytest.raises(ValueError, match="single-token"):
        tssm.ssm_recurrent_step(q, k, v, g, s)
    with pytest.raises(ValueError, match="share one"):
        tssm.ssm_chunk_scan(q, k[:, :, :5], v, g)
    with pytest.raises(ValueError, match="gate must be"):
        tssm.ssm_chunk_scan(q, k, v, g[:, :1])
    with pytest.raises(ValueError, match="state must be"):
        tssm.ssm_chunk_scan(q, k, v, g, state=s[:, :, :2])


def test_log_decay_matches_jax_within_an_ulp():
    g = np.linspace(-30, 30, 4001).astype(np.float32)
    j = np.asarray(jssm._log_decay(jnp.asarray(g), 4.0))
    t = tssm._log_decay(torch.tensor(g), 4.0).numpy()
    np.testing.assert_allclose(t, j, rtol=2.5e-7, atol=0)


# tests/test_ssm.py's gate settings
V, H, DIM, ML = 31, 2, 32, 20


def test_ssm_stack_learns_the_arithmetic_corpus():
    """The convergence gate of tests/test_ssm.py on the port: a pure-SSM
    stack (2 layers) trained 60 Adam steps at lr 3e-3 on the arithmetic
    corpus drives the next-token NLL under 0.2."""
    Tn = 12
    toks, labels = arith_corpus(8, Tn, V)
    sym = transformer.get_symbol(V, Tn, num_layers=2, num_heads=H, dim=DIM,
                                 max_len=ML, block_type="ssm")
    step = make_train_step(sym, optimizer="adam", ctx=tmx.cpu(),
                           optimizer_params={"learning_rate": 3e-3})
    tmx.random.seed(0)
    state = step.init_state(Xavier(), {"data": (8, Tn),
                                       "softmax_label": (8, Tn)})
    batch = {"data": toks, "softmax_label": labels}
    nll0 = None
    for _ in range(60):
        state, outs = step(state, batch, 3e-3, 0)
        if nll0 is None:
            nll0 = lm_nll([outs[0].numpy()], labels, V)
    nll = lm_nll([outs[0].numpy()], labels, V)
    assert nll < 0.2 < nll0
