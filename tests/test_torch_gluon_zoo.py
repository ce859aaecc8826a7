"""The port's ``gluon.model_zoo`` against the JAX package's, on the CPU:
every constructor's parameter names and shapes through ``infer_shape``
(no forward), the forward and backward of resnet18_v1, resnet18_v2 and
squeezenet1_1 at small sizes in training mode, ``pretrained=True`` from
a local file, and the model store's root resolution."""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_gluon import run_block

CTORS = [n for n in jmx.gluon.model_zoo.vision.__all__
         if n[0].islower() and n != "get_model"]


def _shapes(mx, name):
    with mx.cpu():
        net = getattr(mx.gluon.model_zoo.vision, name)(classes=17)
        size = 299 if name.startswith("inception") else 224
        net.infer_shape(mx.nd.zeros((1, 3, size, size)))
        k = len(net.prefix)
        return {n[k:]: (tuple(p.shape), p.grad_req)
                for n, p in net.collect_params().items()}


@pytest.mark.parametrize("name", CTORS)
def test_constructor_parameters_match_jax(name):
    want = _shapes(jmx, name)
    got = _shapes(tmx, name)
    assert list(got) == list(want)
    assert got == want
    assert all(0 not in s for s, _ in got.values())


@pytest.mark.parametrize("name,size", [("resnet18_v1", 32),
                                       ("resnet18_v2", 32),
                                       ("squeezenet1_1", 64)])
@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_forward_backward_match_jax(name, size, hybrid):
    """Training mode from one seed, batch 8: outputs, input and parameter
    gradients, and the parameters after (running stats). Outputs within
    rtol 1e-4 / atol 1e-4, gradients within rtol 1e-4 + 1e-4 x max|g| of
    each array: up to 21 convolutions and batch-statistics BatchNorms
    summed in another order compound float32 rounding (the JAX package's
    own eager and jitted forwards of resnet18_v1 differ by 2e-5 at
    outputs of 4; the port's gradients sit within 3e-5 x max|g|)."""
    x = np.random.RandomState(0).randn(8, 3, size, size).astype(np.float32)

    def make(mx):
        return getattr(mx.gluon.model_zoo.vision, name)(classes=10)
    j = run_block(jmx, make, [x], hybrid)
    t = run_block(tmx, make, [x], hybrid)

    def close(got, want, what):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=what)
    np.testing.assert_allclose(t[0][0], j[0][0], rtol=1e-4, atol=1e-4)
    close(t[1][0], j[1][0], "input gradient")
    assert sorted(t[2]) == sorted(j[2])
    for n in j[2]:
        close(t[2][n], j[2][n], n)
    for n in j[3]:
        np.testing.assert_allclose(t[3][n], j[3][n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_pretrained_loads_a_local_file(tmp_path, monkeypatch):
    """pretrained=True reads <MXNET_HOME>/models/<name>.params, a file
    the JAX package wrote; the two nets then agree."""
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    os.makedirs(tmp_path / "models")
    x = jmx.nd.array(np.random.RandomState(1).randn(1, 3, 32, 32)
                     .astype(np.float32))
    with jmx.cpu():
        jmx.random.seed(0)
        src = jmx.gluon.model_zoo.vision.resnet18_v2(classes=10)
        src.initialize(jmx.init.Xavier())
        want = src(x).asnumpy()
        src.save_params(str(tmp_path / "models" / "resnet18_v2.params"))
    with tmx.cpu():
        net = tmx.gluon.model_zoo.vision.resnet18_v2(classes=10,
                                                     pretrained=True,
                                                     ctx=tmx.cpu())
        got = net(tmx.nd.array(x.asnumpy())).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(FileNotFoundError, match="resnet34_v2"):
        tmx.gluon.model_zoo.vision.resnet34_v2(pretrained=True)


def test_model_store_root_resolution(tmp_path, monkeypatch):
    stores = (jmx.gluon.model_zoo.model_store,
              tmx.gluon.model_zoo.model_store)
    monkeypatch.delenv("MXNET_HOME", raising=False)
    roots = [s.model_store_root() for s in stores]
    assert roots[0] == roots[1] == os.path.expanduser(
        os.path.join("~", ".mxnet", "models"))
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    assert [s.model_store_root() for s in stores] == [
        str(tmp_path / "models")] * 2
    assert [s.model_store_root("~/w") for s in stores] == [
        os.path.expanduser("~/w")] * 2
    (tmp_path / "a.params").write_bytes(b"")
    assert [s.get_model_file("a", str(tmp_path)) for s in stores] == [
        str(tmp_path / "a.params")] * 2
