"""The port's ``metric.py`` against the JAX package's, on the CPU: every
metric on the host path and, where it has one, on the device path, from
the same numpy labels and predictions over three batches.

Host path: the same numpy arithmetic, so equal within 1e-12 relative
(float64 sums). Device path: float32 sums on each package's device, so
within 1e-5 relative, the contract of ``tests/test_hotloop.py``. The
guardrail's ``ok`` mask drops a batch from both ``sum`` and ``num``, and
``update_device`` never reads the device: ``get()`` is the one counted
host sync.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import metric as jmetric

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import profiler as tprofiler

# (id, name or factory, kwargs, kind of data)
METRICS = [
    ("acc", "acc", {}, "probs"),
    ("acc_labels", "acc", {}, "labels"),
    ("top_k", "top_k_accuracy", {"top_k": 3}, "probs"),
    ("f1", "f1", {}, "binary"),
    ("perplexity", "perplexity", {"ignore_label": 1}, "probs"),
    ("perplexity_none", "perplexity", {"ignore_label": None}, "probs"),
    ("mae", "mae", {}, "regression"),
    ("mse", "mse", {}, "regression"),
    ("rmse", "rmse", {}, "regression"),
    ("ce", "ce", {}, "probs"),
    ("nll_loss", "nll_loss", {}, "probs"),
    ("pearsonr", "pearsonr", {}, "regression"),
    ("loss", "loss", {}, "loss"),
    ("torch", "torch", {}, "loss"),
    ("caffe", "caffe", {}, "loss"),
    ("composite", ["acc", "ce"], {}, "probs"),
]


def _batches(kind, n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "regression":
            out.append((rng.randn(16).astype(np.float32),
                        rng.randn(16).astype(np.float32)))
        elif kind == "binary":
            p = rng.rand(16, 2).astype(np.float32)
            out.append((rng.randint(0, 2, 16).astype(np.float32),
                        p / p.sum(1, keepdims=True)))
        elif kind == "labels":
            out.append((rng.randint(0, 5, 16).astype(np.float32),
                        rng.randint(0, 5, 16).astype(np.float32)))
        elif kind == "loss":
            out.append((np.zeros(4, np.float32),
                        rng.rand(4, 3).astype(np.float32)))
        else:
            p = rng.rand(16, 10).astype(np.float32) + 1e-3
            out.append((rng.randint(0, 10, 16).astype(np.float32),
                        p / p.sum(1, keepdims=True)))
    return out


def _feed(mx, m, batches, device, ctx=None):
    for label, pred in batches:
        args = ([mx.nd.array(label, ctx=ctx)], [mx.nd.array(pred, ctx=ctx)])
        if device:
            m.update_device(*args)
        else:
            m.update(*args)
    return m.get()


@pytest.mark.parametrize("name,kwargs,kind", [m[1:] for m in METRICS],
                         ids=[m[0] for m in METRICS])
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_metric_matches_jax(name, kwargs, kind, device):
    batches = _batches(kind)
    jm = jmetric.create(name, **kwargs)
    tm = tmetric.create(name, **kwargs)
    assert tm.supports_device_update == jm.supports_device_update
    jn, jv = _feed(jmx, jm, batches, device)
    tn, tv = _feed(tmx, tm, batches, device, ctx=tmx.cpu())
    assert tn == jn
    rel = 1e-5 if device and tm.supports_device_update else 1e-12
    np.testing.assert_allclose(tv, jv, rtol=rel, atol=0)
    assert tm.get_name_value() == list(zip(
        tn if isinstance(tn, list) else [tn],
        tv if isinstance(tv, list) else [tv]))


def test_custom_metric_and_np():
    def feval(label, pred):
        return float(np.abs(label - pred).sum()), label.size
    batches = _batches("regression")
    for mx, mod, ctx in ((jmx, jmetric, None), (tmx, tmetric, tmx.cpu())):
        m = mod.create(feval)
        assert m.name == "feval"
        _feed(mx, m, batches, False, ctx)
    jv = _feed(jmx, jmetric.np(feval), batches, False)[1]
    tv = _feed(tmx, tmetric.np(feval), batches, False, tmx.cpu())[1]
    assert tv == pytest.approx(jv, rel=1e-12)
    with pytest.raises(NotImplementedError):
        tmetric.create(feval).get_config()


def test_device_ok_mask_excludes_the_batch():
    """The guardrail's finite flag masks a batch's device stats out of
    both sum and num (``tests/test_guardrail.py``'s ok-mask contract)."""
    with tmx.cpu():
        m = tmetric.create("acc")
        pred = tmx.nd.array(np.eye(4, dtype=np.float32))
        label = tmx.nd.array(np.arange(4, dtype=np.float32))
        m.update_device([label], [pred], ok=torch.tensor(True))
        m.update_device([label], [pred], ok=torch.tensor(False))
        assert float(m._dev_stats["num"]) == 4.0
        assert float(m._dev_stats["sum"]) == 4.0
        comp = tmetric.create(["acc", "ce"])
        comp.update_dict({"softmax_label": label}, {"softmax_output": pred},
                         device=True, ok=torch.tensor(False))
        assert all(float(c._dev_stats["num"]) == 0.0 for c in comp.metrics)


def test_update_device_never_syncs_get_is_one_sync():
    with tmx.cpu():
        m = tmetric.create("acc")
        pred = tmx.nd.array(np.random.RandomState(0).rand(8, 4))
        label = tmx.nd.array(np.zeros(8))
        base = tprofiler.host_sync_count()
        for _ in range(10):
            m.update_device([label], [pred])
        assert tprofiler.host_sync_count() == base
        m.get()
        assert tprofiler.host_sync_count() == base + 1


def test_registry_config_and_fallback():
    m = tmetric.create("perplexity", ignore_label=-1)
    cfg = m.get_config()
    assert cfg["metric"] == "Perplexity" and cfg["ignore_label"] == -1
    assert tmetric.create("f1").supports_device_update is False
    mixed = tmetric.create(["acc", "f1"])
    assert not mixed.supports_device_update
    with tmx.cpu():
        mixed.update_device([tmx.nd.array([1.0, 0.0])],
                            [tmx.nd.array([[0.2, 0.8], [0.7, 0.3]])])
    assert mixed.get()[1][0] == 1.0
    assert np.isnan(tmetric.create("acc").get()[1])
