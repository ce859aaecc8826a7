"""The ``dist_sync`` KVStore of the PyTorch port over ``torch.distributed``
against the JAX package.

One launch through ``tools/launch.py -n 2 --launcher local`` starts two
port workers (gloo, CPU) that join one process group from the DMLC_*
environment the launcher sets. Each rank checks the value semantics of
tests/test_dist_multiprocess.py (rank 0's init wins, push sums across
workers exactly, device copies merge first), the rank-ordered sum, the
barrier, the updater on the store and that a sparse push raises; then
both run ``Module.fit(kvstore='dist_sync')`` for two steps on a small
conv-BatchNorm net, each over its own rows. Here, in pytest, the JAX
package computes the same arithmetic — its Executor's gradients on each
rank's rows, summed in rank order, then its updater — and both ranks'
parameters (and each rank's BatchNorm moving stats) must equal it
within FIT_RTOL.
"""
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
ROWS = 4                    # a rank's rows a step
STEPS = 2
FIT_RTOL, FIT_ATOL = 1e-5, 1e-6
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
LAUNCH_TIMEOUT_S = 240


def _net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=6, kernel=(3, 3), pad=(1, 1),
                             name="conv0")
    net = mx.sym.BatchNorm(net, name="bn0", fix_gamma=False)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=4,
                                name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _inputs(d):
    """Seeded initial parameters, moving stats and the global batches."""
    import mxnet_tpu as jmx
    sym = _net(jmx)
    shapes, _, aux_shapes = sym.infer_shape(data=(ROWS, 3, 8, 8),
                                            softmax_label=(ROWS,))
    rng = np.random.RandomState(0)
    blob = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        blob["p:" + n] = (1.0 + 0.1 * rng.randn(*s) if n.endswith("gamma")
                          else 0.3 * rng.randn(*s)).astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        blob["a:" + n] = (np.ones(s) if "var" in n else
                          np.zeros(s)).astype(np.float32)
    blob["X"] = rng.randn(STEPS, WORLD * ROWS, 3, 8, 8).astype(np.float32)
    blob["Y"] = rng.randint(0, 4, (STEPS, WORLD * ROWS)).astype(np.float32)
    np.savez(os.path.join(d, "inputs.npz"), **blob)
    return blob


# ---------------------------------------------------------------------------
# one rank (run by tools/launch.py)
# ---------------------------------------------------------------------------

def _rank_checks(mx, kv, rank, n, d):
    import torch
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.parallel import _comm
    assert kv.type == "dist_sync" and kv.num_workers == n and \
        kv.rank == rank, (kv.num_workers, kv.rank)
    out = mx.nd.zeros((3, 2))
    kv.init("w", mx.nd.ones((3, 2)) * (100 + rank))  # ranks disagree
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), 100.0)     # rank 0 won
    kv.push("w", mx.nd.ones((3, 2)) * (rank + 1))
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), n * (n + 1) / 2.0)
    # a key's device copies merge before the sum across workers
    kv.init("m", mx.nd.zeros((4,)))
    kv.push("m", [mx.nd.ones((4,)) * (rank + 1), mx.nd.ones((4,)) * 10])
    m = mx.nd.zeros((4,))
    kv.pull("m", out=m)
    np.testing.assert_array_equal(m.asnumpy(), n * (n + 1) / 2.0 + 10 * n)
    # the sum is gathered, then added in rank order
    vals = [np.random.RandomState(r).randn(64).astype(np.float32) * 10 ** r
            for r in range(n)]
    stacked = _comm.world_gather(torch.from_numpy(vals[rank]))
    for r in range(n):
        np.testing.assert_array_equal(stacked[r].numpy(), vals[r])
    want = vals[0].copy()
    for r in range(1, n):
        want += vals[r]
    got = kv._cross_process_sum(mx.nd.array(vals[rank]))
    np.testing.assert_array_equal(got.asnumpy(), want)
    # the updater runs on the store after the sum
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5,
                                      rescale_grad=1.0))
    kv.init("u", mx.nd.ones((2,)))
    kv.push("u", mx.nd.ones((2,)) * (rank + 1))
    u = mx.nd.zeros((2,))
    kv.pull("u", out=u)
    np.testing.assert_array_equal(u.asnumpy(), 1.0 - 0.5 * n * (n + 1) / 2)
    # barrier: rank 1 arrives late, having written a file first
    flag = os.path.join(d, "barrier.flag")
    if rank == 1:
        time.sleep(0.5)
        open(flag, "w").close()
    kv.barrier()
    assert os.path.exists(flag), "rank 0 left the barrier first"
    # sparse values stay item 10: refused on every rank alike
    sparse = NDArray(torch.ones((3, 2)).to_sparse())
    try:
        kv.push("w", sparse)
    except NotImplementedError as e:
        assert "sparse" in str(e)
    else:
        raise AssertionError("a sparse push through dist_sync went through")
    kv.barrier()


def _rank_fit(mx, rank, d):
    from mxnet_tpu_torch import io
    with np.load(os.path.join(d, "inputs.npz")) as f:
        blob = {k: f[k] for k in f.files}
    rows = slice(rank * ROWS, (rank + 1) * ROWS)
    X = blob["X"][:, rows].reshape(STEPS * ROWS, 3, 8, 8)
    Y = blob["Y"][:, rows].reshape(STEPS * ROWS)
    args = {k[2:]: mx.nd.array(v) for k, v in blob.items()
            if k.startswith("p:")}
    auxs = {k[2:]: mx.nd.array(v) for k, v in blob.items()
            if k.startswith("a:")}
    mod = mx.mod.Module(_net(mx), context=mx.cpu())
    mod.fit(io.NDArrayIter(X, Y, batch_size=ROWS), num_epoch=1,
            kvstore="dist_sync", optimizer="sgd", optimizer_params=OPT,
            arg_params=args, aux_params=auxs)
    kv = mod._kvstore
    assert kv.type == "dist_sync" and mod._update_on_kvstore
    assert mod._optimizer.rescale_grad == 1.0 / (ROWS * WORLD)
    arg, aux = mod.get_params()
    np.savez(os.path.join(d, "fit.r%d.npz" % rank),
             **{"p:" + k: v.asnumpy() for k, v in arg.items()},
             **{"a:" + k: v.asnumpy() for k, v in aux.items()})


def _rank_main(d):
    rank = int(os.environ["DMLC_WORKER_ID"])
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.parallel import dist
        dist.init()
        assert dist.size() == WORLD and dist.rank() == rank
        with mx.cpu():
            _rank_checks(mx, mx.kv.create("dist_sync"), rank, WORLD, d)
            _rank_fit(mx, rank, d)
        assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
        with open(os.path.join(d, "ok.r%d.json" % rank), "w") as f:
            json.dump({"rank": rank}, f)
        dist.shutdown()
    except BaseException:
        with open(os.path.join(d, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# pytest: the launch and the JAX arithmetic
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_kvstore_dist"))
    blob = _inputs(d)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", MXNET_DIST_BACKEND="gloo")
    env.pop("DMLC_PS_ROOT_URI", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
         str(WORLD), "--launcher", "local", sys.executable,
         os.path.abspath(__file__), d],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    errs = [open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))
            if f.endswith(".err")]
    assert out.returncode == 0 and not errs, "launch rc %r:\n%s\n%s" % (
        out.returncode, "\n".join(errs), out.stdout[-2000:] +
        out.stderr[-3000:])
    return d, blob


def test_launch_py_starts_two_port_workers_in_one_group(launched):
    d, _ = launched
    assert sorted(f for f in os.listdir(d) if f.startswith("ok.")) == \
        ["ok.r%d.json" % r for r in range(WORLD)]


def _jax_fit(blob):
    """The JAX package's arithmetic of the two-worker step: each rank's
    gradients from its own Executor (its own moving stats), summed in
    rank order, then the updater on the store (a local KVStore with the
    Module's optimizer)."""
    import mxnet_tpu as jmx
    sym = _net(jmx)
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    opt = jmx.optimizer.create(
        "sgd", sym=sym, param_idx2name=dict(enumerate(names)),
        rescale_grad=1.0 / (ROWS * WORLD), **OPT)
    kv = jmx.kv.create("local")
    kv.set_optimizer(opt)
    weights = {n: jmx.nd.array(blob["p:" + n]) for n in names}
    for n in names:
        kv.init(n, weights[n])
    exes = []
    for _ in range(WORLD):
        ex = sym.simple_bind(jmx.cpu(), data=(ROWS, 3, 8, 8),
                             softmax_label=(ROWS,))
        for n, a in ex.aux_dict.items():
            a[:] = blob["a:" + n]
        exes.append(ex)
    for step in range(STEPS):
        grads = []
        for r, ex in enumerate(exes):
            for n in names:
                ex.arg_dict[n][:] = weights[n].asnumpy()
            rows = slice(r * ROWS, (r + 1) * ROWS)
            ex.forward(is_train=True, data=blob["X"][step, rows],
                       softmax_label=blob["Y"][step, rows])
            ex.backward()
            grads.append({n: ex.grad_dict[n].copy() for n in names})
        for n in names:
            kv.push(n, grads[0][n] + grads[1][n])
            kv.pull(n, out=weights[n])
    return ({n: w.asnumpy() for n, w in weights.items()},
            [{n: a.asnumpy() for n, a in ex.aux_dict.items()}
             for ex in exes])


def test_fit_dist_sync_matches_jax_arithmetic(launched):
    d, blob = launched
    want, want_aux = _jax_fit(blob)
    got = []
    for r in range(WORLD):
        with np.load(os.path.join(d, "fit.r%d.npz" % r)) as f:
            got.append({k: f[k] for k in f.files})
    for n, w in want.items():
        # a convolution's bias ahead of BatchNorm has no gradient
        assert np.allclose(w, blob["p:" + n]) == (n == "conv0_bias"), n
        np.testing.assert_array_equal(got[1]["p:" + n], got[0]["p:" + n],
                                      err_msg=n)
        np.testing.assert_allclose(got[0]["p:" + n], w, rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=n)
    for r in range(WORLD):
        for n, a in want_aux[r].items():
            np.testing.assert_allclose(got[r]["a:" + n], a, rtol=FIT_RTOL,
                                       atol=FIT_ATOL,
                                       err_msg="rank %d %s" % (r, n))
    # each rank's BatchNorm saw only its own rows
    assert not np.allclose(got[0]["a:bn0_moving_mean"],
                           got[1]["a:bn0_moving_mean"])


def test_dist_types_without_a_group_are_local():
    """Outside a process group a dist store has one worker and behaves
    as local (the reference's tests run it so), dist_async without
    DMLC_PS_ROOT_URI included."""
    import mxnet_tpu_torch as mx
    with mx.cpu():
        for kind in ("dist_sync", "dist_device_sync", "dist", "dist_async"):
            kv = mx.kv.create(kind)
            assert kv.type == kind and kv.rank == 0 and \
                kv.num_workers == 1
            kv.init(3, mx.nd.ones((2,)))
            kv.push(3, [mx.nd.ones((2,)), mx.nd.ones((2,)) * 2])
            out = mx.nd.zeros((2,))
            kv.pull(3, out=out)
            np.testing.assert_array_equal(out.asnumpy(), 3.0)
            kv.barrier()
        with pytest.raises(ValueError, match="Unknown KVStore"):
            mx.kv.create("dist_bogus")


if __name__ == "__main__":
    _rank_main(sys.argv[1])
