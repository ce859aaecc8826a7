"""The port's ``contrib.tensorboard`` against the JAX package's, on the
CPU (after ``tests/test_tensorboard.py``): with the clock, the host name
and the pid fixed, both writers produce the same event file, name and
bytes (whose format ``tests/test_tensorboard.py`` holds to tensorboard's
own reader); ``LogMetricsCallback`` through the port's ``Module.fit``
writes the scalars (tags, steps, values within 1e-6) that the JAX
package's callback writes through its ``Module.fit`` from the same
weights and batches, read back by ``chip_smoke.tb_scalars`` (the card
smoke's reader, which checks every frame's CRCs)."""
import glob
import os

import numpy as np

from chip_smoke import tb_scalars

import mxnet_tpu as jmx
from mxnet_tpu.contrib import tensorboard as jtb
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import tensorboard as ttb


def _fixed(monkeypatch):
    clock = iter(1700000000.25 + 0.5 * i for i in range(1000))
    monkeypatch.setattr("time.time", lambda: next(clock))
    monkeypatch.setattr("socket.gethostname", lambda: "host-a")
    monkeypatch.setattr("os.getpid", lambda: 4242)


def _write(tb, logdir):
    with tb.SummaryWriter(logdir, filename_suffix=".v2") as w:
        w.add_scalar("loss", 1.5, global_step=1)
        w.add_scalar("loss", 0.75, global_step=2)
        w.add_scalar("acc/top1", 0.5, global_step=2)
        w.add_scalar("big", 3.0e38, global_step=2 ** 40)
        return w.path


def test_writers_write_the_same_bytes(tmp_path, monkeypatch):
    _fixed(monkeypatch)
    jpath = _write(jtb, str(tmp_path / "jax"))
    _fixed(monkeypatch)
    tpath = _write(ttb, str(tmp_path / "port"))
    assert os.path.basename(tpath) == os.path.basename(jpath) == \
        "events.out.tfevents.1700000000.host-a.4242.v2"
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert g.read() == f.read()
    assert tb_scalars(tpath) == [("loss", 1, 1.5), ("loss", 2, 0.75),
                                 ("acc/top1", 2, 0.5),
                                 ("big", 2 ** 40, float(np.float32(3.0e38)))]
    assert tmx.contrib.tensorboard is ttb


def _scalars(logdir):
    files = sorted(glob.glob(os.path.join(logdir, "events.out.*")))
    assert len(files) == 1
    return tb_scalars(files[0])


def _fit(mx, logdir, weights, X, y):
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=2, name="fc"), name="softmax")
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    mod = mx.mod.Module(net, context=mx.cpu())
    tb = jtb if mx is jmx else ttb
    cb = tb.LogMetricsCallback(logdir, prefix="train")
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5},
            eval_metric=["acc", "ce"], batch_end_callback=cb,
            arg_params={k: mx.nd.array(v) for k, v in weights.items()})
    cb.close()
    return _scalars(logdir)


def test_callback_through_module_fit_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    weights = {"fc_weight": rng.randn(2, 8).astype(np.float32) * 0.1,
               "fc_bias": np.zeros(2, np.float32)}
    want = _fit(jmx, str(tmp_path / "jax"), weights, X, y)
    with tmx.cpu():
        got = _fit(tmx, str(tmp_path / "port"), weights, X, y)
    assert len(got) == len(want) == 16     # 4 batches x 2 epochs x 2
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert {g[0] for g in got} == {"train/accuracy", "train/cross-entropy"}
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-6, atol=1e-6)
