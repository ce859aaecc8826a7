"""The port's ``test_utils`` against the JAX package's, on the CPU: the
same checks pass (and fail) on the same graphs and functions in both
packages, and the seeded helpers draw the same shapes and arrays."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import test_utils as jtu
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import test_utils as ttu


def _mlp(S):
    x = S.Variable("data")
    h = S.FullyConnected(x, name="fc1", num_hidden=3)
    return S.LRN(S.Activation(h, act_type="tanh"), nsize=3, alpha=0.1)


def _location():
    rng = np.random.RandomState(0)
    return {"data": rng.randn(2, 4).astype(np.float32),
            "fc1_weight": rng.randn(3, 4).astype(np.float32),
            "fc1_bias": rng.randn(3).astype(np.float32)}


def test_symbolic_forward_and_backward_agree_with_jax():
    """The JAX package's outputs and gradients pass the port's checks,
    and the port's pass the JAX package's."""
    loc = _location()
    og = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    jout = [jtu.simple_forward(_mlp(jmx.sym), **loc)]
    jgrads = jtu.check_symbolic_backward(_mlp(jmx.sym), loc, [og],
                                         {"data": None})
    with tmx.cpu():
        tout = ttu.check_symbolic_forward(_mlp(tmx.sym), loc, jout)
        tgrads = ttu.check_symbolic_backward(
            _mlp(tmx.sym), loc, [og], {k: jgrads[k] for k in loc})
        assert ttu.simple_forward(_mlp(tmx.sym), **loc).shape == (2, 3)
        with pytest.raises(AssertionError):
            ttu.check_symbolic_forward(_mlp(tmx.sym), loc,
                                       [jout[0] + 1e-2])
    jtu.check_symbolic_forward(_mlp(jmx.sym), loc, tout)
    jtu.check_symbolic_backward(_mlp(jmx.sym), loc, [og],
                                {k: tgrads[k] for k in loc})


def test_numeric_gradient_check_passes_and_catches_a_wrong_gradient():
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    with tmx.cpu():
        ttu.check_numeric_gradient(
            lambda xs: tmx.nd.sum(tmx.nd.LeakyReLU(xs[0], act_type="elu")
                                  * xs[0]), [tmx.nd.array(x)])

        class Wrong(tmx.autograd.Function):
            def forward(self, a):
                return a * 2

            def backward(self, dy):
                return dy * 3
        with pytest.raises(AssertionError, match="gradient mismatch"):
            ttu.check_numeric_gradient(
                lambda xs: tmx.nd.sum(Wrong()(xs[0])), [tmx.nd.array(x)])


def test_consistency_across_contexts_and_dtypes():
    x = np.random.RandomState(3).randn(4, 5).astype(np.float32)
    with tmx.cpu():
        out = ttu.check_consistency(
            lambda a: tmx.nd.LRN(tmx.nd.expand_dims(a, axis=0), nsize=3),
            [tmx.nd.array(x)], dtypes=["bfloat16", "float64"])
    jlrn = jreg.get_op("LRN")
    want = jtu.check_consistency(
        lambda a: jlrn.fn(a[None], **jreg.canon_attrs(jlrn, {"nsize": 3})),
        [x])
    ttu.assert_almost_equal(out, want, rtol=1e-5, atol=1e-6)
    assert ttu.almost_equal(out, want, rtol=1e-5, atol=1e-6)


def test_seeded_helpers_match_jax():
    ttu._rng.seed(5)
    jtu._rng.seed(5)
    assert ttu.rand_shape_2d() == jtu.rand_shape_2d()
    assert ttu.rand_shape_nd(3) == jtu.rand_shape_nd(3)
    with tmx.cpu():
        a = ttu.rand_ndarray((2, 3)).asnumpy()
    np.testing.assert_array_equal(a, jtu.rand_ndarray((2, 3)).asnumpy())
    assert ttu.same(a, a.copy()) and not ttu.same(a, a + 1)
    with tmx.cpu():
        c = ttu.rand_ndarray((4, 3), stype="csr", density=0.5)
        r = ttu.rand_ndarray((4, 3), stype="row_sparse")
    jc = jtu.rand_ndarray((4, 3), stype="csr", density=0.5)
    jr = jtu.rand_ndarray((4, 3), stype="row_sparse")
    assert (c.stype, r.stype) == ("csr", "row_sparse")
    np.testing.assert_array_equal(c.asnumpy(), jc.asnumpy())
    np.testing.assert_array_equal(r.asnumpy(), jr.asnumpy())


def _fc_location():
    rng = np.random.RandomState(4)
    return {"data": rng.randn(4, 6).astype(np.float32),
            "fc_weight": rng.randn(3, 6).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32)}


def _fc(S):
    return S.FullyConnected(S.Variable("data"), name="fc", num_hidden=3)


@pytest.mark.parametrize("typ", ["forward", "whole"])
def test_check_speed_times_a_bound_symbol_and_a_callable(typ):
    """Both packages time the same symbol and callable: a positive time a
    run, the output read back after the last run; a bad typ raises."""
    loc = _fc_location()
    jt = jtu.check_speed(_fc(jmx.sym), location=loc, N=3, typ=typ)
    with tmx.cpu():
        tt = ttu.check_speed(_fc(tmx.sym), location=loc, N=3, typ=typ)
        calls = []

        def f():
            calls.append(1)
            return [tmx.nd.array(loc["data"]) * 2]
        ft = ttu.check_speed(f=f, N=4)
        with pytest.raises(ValueError, match="typ"):
            ttu.check_speed(_fc(tmx.sym), location=loc, typ="backward")
    with pytest.raises(ValueError, match="typ"):
        jtu.check_speed(_fc(jmx.sym), location=loc, typ="backward")
    assert jt > 0 and tt > 0 and ft > 0
    assert len(calls) == 5            # the warm-up run and N timed runs


def test_discard_stderr_silences_the_stderr_descriptor(tmp_path,
                                                       monkeypatch):
    """Both packages send sys.stderr's file descriptor to /dev/null for
    the block and give it back after: writes to the descriptor itself
    and through sys.stderr are dropped inside, kept outside."""
    import os
    import sys
    path = tmp_path / "stderr.txt"
    with open(path, "w") as f:
        monkeypatch.setattr(sys, "stderr", f)
        for tu in (ttu, jtu):
            with tu.discard_stderr():
                os.write(f.fileno(), b"hidden by fd\n")
                print("hidden by sys.stderr", file=sys.stderr, flush=True)
            print("shown", file=sys.stderr, flush=True)
    assert path.read_text() == "shown\nshown\n"


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_rand_sparse_ndarray_draws_as_jax(stype):
    ttu._rng.seed(11)
    jtu._rng.seed(11)
    with tmx.cpu():
        t, tparts = ttu.rand_sparse_ndarray((6, 5), stype, density=0.4)
    j, jparts = jtu.rand_sparse_ndarray((6, 5), stype, density=0.4)
    assert t.stype == j.stype == stype
    assert len(tparts) == len(jparts) == (3 if stype == "csr" else 2)
    for a, b in zip(tparts, jparts):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
