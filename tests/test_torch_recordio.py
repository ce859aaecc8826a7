"""The port's data path against the JAX package's, on the CPU: RecordIO
files, MNISTIter and CSVIter, and the in-process KVStore.

- Record files (plain, indexed, with payloads that hold the aligned
  magic word, so split across parts) written by either package are the
  same bytes and read back record for record in the other; ``pack`` /
  ``unpack`` and ``pack_img`` / ``unpack_img`` agree.
- MNISTIter (idx-ubyte files, plain and gzipped) and CSVIter yield the
  JAX package's batches exactly, with the same padding.
- KVStore: init, push of a list (summed), pull into several outs, the
  updater and the optimizer on the store (the JAX store's weights within
  rtol 1e-6), the optimizer states' file round trip, and the types the
  port does not run (dist, sparse) raising with their ROADMAP item.
"""
import gzip
import logging
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec

MAGIC = struct.pack("<I", 0xced7230a)


def _payloads():
    rng = np.random.RandomState(0)
    out = [b"", b"a", b"abc" * 7, rng.bytes(1001),
           MAGIC + b"xyz!" + MAGIC,            # the magic at aligned offsets
           b"1234" + MAGIC + b"5678" + MAGIC + MAGIC + b"9",
           b"12" + MAGIC + b"34"]              # unaligned: not split
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_record_files_are_byte_equal_and_read_both_ways(tmp_path, writer):
    files = {}
    for name, rec in (("jax", jrec), ("port", trec)):
        path = str(tmp_path / ("%s.rec" % name))
        w = rec.MXRecordIO(path, "w")
        for p in _payloads():
            w.write(p)
        w.close()
        files[name] = path
    with open(files["jax"], "rb") as a, open(files["port"], "rb") as b:
        assert a.read() == b.read()
    for rec in (jrec, trec):
        r = rec.MXRecordIO(files[writer], "r")
        got = [r.read() for _ in _payloads()]
        assert got == _payloads()
        assert r.read() is None
        r.reset()
        assert r.read() == _payloads()[0]
        r.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_indexed_record_files_read_both_ways(tmp_path, writer):
    paths = {}
    for name, rec in (("jax", jrec), ("port", trec)):
        idx = str(tmp_path / ("%s.idx" % name))
        path = str(tmp_path / ("%s.rec" % name))
        w = rec.MXIndexedRecordIO(idx, path, "w")
        for i, p in enumerate(_payloads()):
            w.write_idx(i * 3, rec.pack(rec.IRHeader(0, float(i), i, 0), p))
        w.close()
        paths[name] = (idx, path)
    for k in (0, 1):
        with open(paths["jax"][k], "rb") as a, \
                open(paths["port"][k], "rb") as b:
            assert a.read() == b.read()
    for rec in (jrec, trec):
        r = rec.MXIndexedRecordIO(*paths[writer], "r")
        assert r.keys == [i * 3 for i in range(len(_payloads()))]
        for i in reversed(range(len(_payloads()))):
            header, payload = rec.unpack(r.read_idx(i * 3))
            assert payload == _payloads()[i]
            assert header.label == float(i) and header.id == i
        r.close()


def test_pack_unpack_match_jax():
    for label in (3.0, [1.0, 2.5, -4.0]):
        h = (0, label, 7, 9)
        packed = trec.pack(h, b"payload")
        assert packed == jrec.pack(h, b"payload")
        th, ts = trec.unpack(packed)
        jh, js = jrec.unpack(packed)
        assert ts == js == b"payload"
        np.testing.assert_array_equal(th.label, jh.label)
        assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    img = (np.arange(8 * 6 * 3) % 251).astype(np.uint8).reshape(8, 6, 3)
    for fmt in (".png", ".jpg"):
        packed = trec.pack_img((0, 1.0, 0, 0), img, img_fmt=fmt)
        assert packed == jrec.pack_img((0, 1.0, 0, 0), img, img_fmt=fmt)
        _, timg = trec.unpack_img(packed, iscolor=1)
        _, jimg = jrec.unpack_img(packed, iscolor=1)
        np.testing.assert_array_equal(timg, jimg)
    np.testing.assert_array_equal(
        trec.unpack_img(trec.pack_img((0, 1.0, 0, 0), img, img_fmt=".png"))
        [1], img)


def test_native_reader_knob_is_noted_once(tmp_path, caplog):
    """MXNET_NATIVE_RECORDIO (default on, as in the JAX package) selects
    the native mmap reader where it builds, off the Python reader; both
    read the same records and nothing is logged about the knob."""
    path = str(tmp_path / "a.rec")
    w = trec.MXRecordIO(path, "w")
    for p in _payloads():
        w.write(p)
    w.close()
    from mxnet_tpu_torch import _native
    assert tconfig.get("MXNET_NATIVE_RECORDIO") is True
    built = _native.load("recordio") is not None
    try:
        with caplog.at_level(logging.WARNING):
            for knob in (True, False):
                tconfig.set_override("MXNET_NATIVE_RECORDIO", knob)
                r = trec.MXRecordIO(path, "r")
                assert (r._native is not None) == (knob and built)
                assert [r.read() for _ in _payloads()] == _payloads()
                assert r.read() is None
                r.close()
    finally:
        tconfig.clear_override("MXNET_NATIVE_RECORDIO")
    assert not [m for m in caplog.messages if "MXNET_NATIVE_RECORDIO" in m]


def _write_mnist(tmp_path, n=70, rows=5, cols=4, zipped=False):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (n, rows, cols)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if zipped else open
    ext = ".gz" if zipped else ""
    ip, lp = str(tmp_path / "img"), str(tmp_path / "lab")
    with opener(ip + ext, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols) + img.tobytes())
    with opener(lp + ext, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())
    return ip, lp


def _batches(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [lb.asnumpy() for lb in b.label], b.pad))
    return out


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for (ad, al, ap), (bd, bl, bp) in zip(a, b):
        assert ap == bp
        for x, y in zip(ad + al, bd + bl):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("zipped,flat,shuffle", [
    (False, False, True), (True, True, False), (False, True, True)])
def test_mnist_iter_yields_the_jax_batches(tmp_path, zipped, flat, shuffle):
    ip, lp = _write_mnist(tmp_path, zipped=zipped)
    kw = dict(image=ip, label=lp, batch_size=16, flat=flat, shuffle=shuffle,
              seed=3)
    j = _batches(jio.MNISTIter(**kw))
    with tmx.cpu():
        it = tio.MNISTIter(**kw)
        t = _batches(it)
    assert len(t) == 4                 # 70 // 16, the rest discarded
    _assert_same_batches(t, j)
    assert [d.name for d in it.provide_data] == ["data"]
    with pytest.raises(IOError, match="not found"):
        tio.MNISTIter(image=str(tmp_path / "none"), label=lp)


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_yields_the_jax_batches(tmp_path, round_batch):
    rng = np.random.RandomState(2)
    data = rng.standard_normal((23, 6)).astype(np.float32)
    label = rng.randint(0, 3, 23).astype(np.float32)
    dp, lp = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dp, data, delimiter=",")
    np.savetxt(lp, label, delimiter=",")
    kw = dict(data_csv=dp, data_shape=(2, 3), label_csv=lp, batch_size=5,
              round_batch=round_batch)
    j = _batches(jio.CSVIter(**kw))
    with tmx.cpu():
        t = _batches(tio.CSVIter(**kw))
    assert len(t) == (5 if round_batch else 4)
    _assert_same_batches(t, j)


@pytest.mark.parametrize("name", ["ImageRecordIter", "ImageDetRecordIter"])
def test_iterators_not_ported_raise_naming_item_10(tmp_path, name):
    """The two image factories are ported (``image``): each reads a
    packed file into batches of the declared shapes on the context it was
    made in (the image tests hold them to the JAX package)."""
    idx, path = str(tmp_path / "a.idx"), str(tmp_path / "a.rec")
    w = trec.MXIndexedRecordIO(idx, path, "w")
    rng = np.random.RandomState(0)
    for i in range(6):
        img = rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
        label = [2, 5, i % 3, 0.1, 0.2, 0.6, 0.7] \
            if name == "ImageDetRecordIter" else float(i)
        w.write_idx(i, trec.pack_img((0, label, i, 0), img))
    w.close()
    with tmx.cpu():
        it = getattr(tio, name)(path_imgrec=path, data_shape=(3, 32, 32),
                                batch_size=3)
        batch = next(iter(it))
    assert batch.data[0].shape == (3, 3, 32, 32)
    assert batch.data[0].context == tmx.cpu()
    assert batch.label[0].shape == ((3, 16, 5) if name == "ImageDetRecordIter"
                                    else (3,))


def test_kvstore_push_pull_matches_jax():
    """reference tests/python/unittest/test_kvstore.py semantics, in both
    packages."""
    res = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        with ctx:
            kv = mx.kv.create("local")
            kv.init(3, mx.nd.ones((2, 3)))
            out = mx.nd.zeros((2, 3))
            kv.pull(3, out=out)
            first = out.asnumpy()
            kv.push(3, [mx.nd.ones((2, 3))] * 4)       # a list: summed
            outs = [mx.nd.zeros((2, 3)), mx.nd.zeros((2, 3))]
            kv.pull(3, out=outs)
            kv.init(["a", "b"], [mx.nd.ones((2,)), mx.nd.zeros((2,))])
            kv.push(["a", "b"], [[mx.nd.ones((2,))] * 2,
                                 mx.nd.array([3.0, 4.0])])
            ab = [mx.nd.zeros((2,)), mx.nd.zeros((2,))]
            kv.pull(["a", "b"], out=ab)

            kv2 = mx.kv.create("device")
            kv2.init("w", mx.nd.zeros((2,)))

            def updater(key, grad, weight):
                weight += grad * 2
            kv2.set_updater(updater)
            kv2.push("w", mx.nd.ones((2,)))
            o = mx.nd.zeros((2,))
            kv2.pull("w", out=o)
            res.append((first, [x.asnumpy() for x in outs],
                        [x.asnumpy() for x in ab], o.asnumpy(),
                        kv.rank, kv.num_workers, kv.type))
    j, t = res
    np.testing.assert_array_equal(t[0], np.ones((2, 3)))
    for x in t[1]:
        np.testing.assert_array_equal(x, 4 * np.ones((2, 3)))
    np.testing.assert_array_equal(t[3], [2.0, 2.0])
    for a, b in zip(t[:4], j[:4]):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            np.testing.assert_array_equal(x, y)
    assert t[4:] == (0, 1, "local") and j[6] == "local"


def test_kvstore_optimizer_on_the_store_matches_jax(tmp_path):
    """set_optimizer: each push runs the optimizer on the stored weight
    (SGD momentum, wd); five pushes land within rtol 1e-6 of the JAX
    store's; the optimizer states written by save_optimizer_states load
    back."""
    rng = np.random.RandomState(3)
    w0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32)
             for _ in range(5)]
    res = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        with ctx:
            kv = mx.kv.create("local")
            kv.set_optimizer(mx.optimizer.create(
                "sgd", learning_rate=0.1, momentum=0.9, wd=0.01,
                rescale_grad=0.5))
            kv.init(0, mx.nd.array(w0))
            for g in grads:
                kv.push(0, [mx.nd.array(g), mx.nd.array(g)])
            out = mx.nd.zeros((4, 5))
            kv.pull(0, out=out)
            res.append(out.asnumpy())
            if mx is tmx:
                fname = str(tmp_path / "states")
                kv.save_optimizer_states(fname)
                kv2 = mx.kv.create("local")
                kv2.set_optimizer(mx.optimizer.create(
                    "sgd", learning_rate=0.1, momentum=0.9))
                kv2.load_optimizer_states(fname)
                mom = kv2._updater.states[0]
                mom = mom.asnumpy() if hasattr(mom, "asnumpy") else \
                    np.asarray(mom)
                assert mom.shape == (4, 5) and np.abs(mom).sum() > 0
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6, atol=1e-7)


def test_kvstore_errors():
    # a dist store outside a process group is one worker (no error)
    dkv = tmx.kv.create("dist_sync")
    assert (dkv.type, dkv.rank, dkv.num_workers) == ("dist_sync", 0, 1)
    with pytest.raises(ValueError, match="Unknown KVStore"):
        tmx.kv.create("nope")
    with tmx.cpu():
        kv = tmx.kv.create()
        with pytest.raises(KeyError):
            kv.push("missing", tmx.nd.ones((1,)))
        kv.init(1, tmx.nd.ones((1,)))
        with pytest.raises(ValueError, match="duplicate"):
            kv.init(1, tmx.nd.ones((1,)))
        out = tmx.nd.zeros((1,))
        kv.row_sparse_pull(1, out=out, row_ids=tmx.nd.zeros((1,)))
        assert out.asnumpy().tolist() == [1.0]
        kv.barrier()
