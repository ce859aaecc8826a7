"""The port's symbolic RNN toolkit (``mxnet_tpu_torch/rnn``) against the JAX
package's (``mxnet_tpu/rnn``), on the CPU: every cell class unrolled in
NTC and TNC, merged and per-step, outputs, final states and every
gradient from one numpy seed (Dropout and Zoneout masks are the threefry
stream in both packages, so they agree bit for bit); fused against
unfused; ``pack_weights`` / ``unpack_weights``; ``FusedRNN``
initialization bit for bit; checkpoints written by one package loaded by
the other; ``BucketSentenceIter`` batches equal; and a bucketed 2-layer
fused LSTM LM trained through ``BucketingModule.fit`` to the JAX
package's parameters. Forward rtol 1e-5 / atol 1e-6; gradients rtol
1e-4 / atol 1e-6; the trained parameters rtol 1e-4 / atol 1e-5."""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
T, N, C, H = 4, 2, 3, 5


def _ctx(mx):
    return {"ctx": tmx.cpu()} if mx is tmx else {}


def _scope(mx):
    return tmx.cpu() if mx is tmx else jmx.cpu()


def _stack(mx):
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(H, prefix="a_"))
    stack.add(mx.rnn.DropoutCell(0.5, prefix="d_"))
    stack.add(mx.rnn.GRUCell(H, prefix="b_"))
    return stack


CELLS = {
    "rnn_tanh": lambda mx: mx.rnn.RNNCell(H, prefix="r_"),
    "rnn_relu": lambda mx: mx.rnn.RNNCell(H, activation="relu",
                                          prefix="r_"),
    "lstm": lambda mx: mx.rnn.LSTMCell(H, prefix="l_", forget_bias=2.0),
    "gru": lambda mx: mx.rnn.GRUCell(H, prefix="g_"),
    "fused_lstm": lambda mx: mx.rnn.FusedRNNCell(
        H, num_layers=2, mode="lstm", bidirectional=True, dropout=0.4,
        get_next_state=True, prefix="f_"),
    "fused_gru": lambda mx: mx.rnn.FusedRNNCell(
        H, num_layers=2, mode="gru", get_next_state=True, prefix="f_"),
    "fused_relu": lambda mx: mx.rnn.FusedRNNCell(
        H, mode="rnn_relu", bidirectional=True, prefix="f_"),
    "sequential": _stack,
    "dropout": lambda mx: mx.rnn.DropoutCell(0.3),
    "zoneout": lambda mx: mx.rnn.ZoneoutCell(
        mx.rnn.RNNCell(H, prefix="z_"), 0.3, 0.3),
    "residual": lambda mx: mx.rnn.ResidualCell(mx.rnn.GRUCell(
        C, prefix="res_")),
    "bidirectional": lambda mx: mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(H, prefix="bl_"), mx.rnn.GRUCell(H, prefix="br_")),
    "shared_params": lambda mx: _shared(mx),
}


def _shared(mx):
    """Two LSTM layers drawing their weights from one RNNParams pool."""
    params = mx.rnn.RNNParams("shared_")
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(C, prefix="shared_", params=params))
    stack.add(mx.rnn.LSTMCell(C, prefix="shared_", params=params))
    return stack


def _unroll(mx, make, layout, merge, is_train=True):
    """Unroll, bind, fill every argument from one seed, run forward and
    backward (ones into every output); returns outputs, gradients and
    the argument names."""
    cell = make(mx)
    out, states = cell.unroll(T, mx.sym.Variable("data"), layout=layout,
                              merge_outputs=merge)
    outs = list(out) if isinstance(out, list) else [out]
    net = mx.sym.Group(outs + list(states))
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    ex = net.simple_bind(data=shape, **_ctx(mx))
    rng = np.random.RandomState(1)
    feed = {name: rng.uniform(-0.5, 0.5, ex.arg_dict[name].shape)
            .astype(np.float32) for name in sorted(ex.arg_dict)}
    mx.random.seed(3)
    res = ex.forward(is_train=is_train, **feed)
    ex.backward([mx.nd.ones(o.shape, **_ctx(mx)) for o in res])
    grads = {k: v.asnumpy() for k, v in ex.grad_dict.items()
             if v is not None}
    return [o.asnumpy() for o in res], grads, net.list_arguments()


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(name, layout, merge):
    (o_j, g_j, a_j), (o_t, g_t, a_t) = (
        _unroll(mx, CELLS[name], layout, merge) for mx in (jmx, tmx))
    assert a_t == a_j
    assert len(o_t) == len(o_j)
    for a, b in zip(o_t, o_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **FWD)
    assert sorted(g_t) == sorted(g_j)
    for k in g_j:
        np.testing.assert_allclose(g_t[k], g_j[k], **GRAD)


def test_cell_classes_and_state_info_match_jax():
    """The eleven classes are exported; modifier cells are ModifierCells;
    state_info and begin_state (zeros of batch 1) agree."""
    names = ("BaseRNNCell", "RNNParams", "RNNCell", "LSTMCell", "GRUCell",
             "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
             "ModifierCell", "ZoneoutCell", "ResidualCell",
             "BidirectionalCell")
    for n in names:
        assert hasattr(tmx.rnn, n), n
    assert issubclass(tmx.rnn.ZoneoutCell, tmx.rnn.ModifierCell)
    assert issubclass(tmx.rnn.ResidualCell, tmx.rnn.ModifierCell)
    for name in sorted(CELLS):
        jc, tc = CELLS[name](jmx), CELLS[name](tmx)
        assert tc.state_info == jc.state_info, name
        js, ts = jc.begin_state(), tc.begin_state()
        assert [s.list_outputs() for s in ts] == \
            [s.list_outputs() for s in js]
        assert [s.infer_shape()[1] for s in ts] == \
            [s.infer_shape()[1] for s in js]
    with pytest.raises(NotImplementedError):
        tmx.rnn.FusedRNNCell(H)(tmx.sym.Variable("x"), [])


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", False),
                                        ("rnn_tanh", False),
                                        ("rnn_relu", True), ("lstm", True),
                                        ("gru", True)])
def test_fused_matches_unfused(mode, bidir):
    """The fused net and its unfuse() stack (weights through
    unpack_weights + pack_weights) give the same outputs, and both give
    the JAX package's fused outputs."""
    x = np.random.RandomState(0).randn(N, T, C).astype(np.float32)
    outs = []
    for mx in (tmx, jmx):
        fused = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                    bidirectional=bidir, prefix="f_")
        fo, _ = fused.unroll(T, mx.sym.Variable("data"), layout="NTC",
                             merge_outputs=True)
        ex = fo.simple_bind(data=(N, T, C), **_ctx(mx))
        blob = np.random.RandomState(2).uniform(
            -0.5, 0.5, ex.arg_dict["f_parameters"].shape).astype(np.float32)
        outs.append(ex.forward(data=x, f_parameters=blob)[0].asnumpy())
        if mx is jmx:
            continue
        stack = fused.unfuse()
        uo, _ = stack.unroll(T, mx.sym.Variable("data"), layout="NTC",
                             merge_outputs=True)
        with _scope(mx):
            cellargs = stack.pack_weights(fused.unpack_weights(
                {"f_parameters": mx.nd.array(blob)}))
        ex2 = uo.simple_bind(data=(N, T, C), **_ctx(mx))
        y = ex2.forward(data=x, **{k: v.asnumpy()
                                   for k, v in cellargs.items()})[0]
        np.testing.assert_allclose(y.asnumpy(), outs[0], **FWD)
    np.testing.assert_allclose(outs[0], outs[1], **FWD)


def test_unfuse_matches_jax():
    for mode, bidir, p in (("lstm", True, 0.3), ("gru", False, 0.0)):
        stacks = [mx.rnn.FusedRNNCell(H, num_layers=3, mode=mode,
                                      bidirectional=bidir, dropout=p,
                                      forget_bias=2.5, prefix="u_").unfuse()
                  for mx in (jmx, tmx)]
        names = [[type(c).__name__ for c in s._cells] for s in stacks]
        assert names[1] == names[0]
        assert stacks[1].state_info == stacks[0].state_info
        assert sorted(stacks[1].params._pool) == \
            sorted(stacks[0].params._pool)
        if mode == "lstm":
            cell = stacks[1]._cells[0]._cells[0]
            assert cell._iB.attr("__init__") == \
                stacks[0]._cells[0]._cells[0]._iB.attr("__init__")


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_pack_unpack_weights_match_jax(mode):
    size = tmx.ops.rnn_op.rnn_param_size(mode, 7, 5, 3, True)
    blob = np.random.RandomState(4).randn(size).astype(np.float32)
    res = []
    for mx in (jmx, tmx):
        fused = mx.rnn.FusedRNNCell(5, num_layers=3, mode=mode,
                                    bidirectional=True, prefix="p_")
        with _scope(mx):
            unpacked = fused.unpack_weights(
                {"p_parameters": mx.nd.array(blob)})
            repacked = fused.pack_weights(unpacked)
            # the single cells' concatenated gates, split and joined back
            stack = fused.unfuse()
            cellwise = stack.pack_weights(dict(unpacked))
            again = stack.unpack_weights(cellwise)
        np.testing.assert_array_equal(
            repacked["p_parameters"].asnumpy(), blob)
        res.append(({k: v.asnumpy() for k, v in unpacked.items()},
                    {k: v.asnumpy() for k, v in cellwise.items()},
                    {k: v.asnumpy() for k, v in again.items()}))
    for j, t in zip(*res):
        assert list(t) == list(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("mode,bidir,init", [
    ("lstm", False, None), ("lstm", True, "xavier"), ("gru", True, None),
    ("rnn_relu", False, "uniform")])
def test_fused_rnn_initializer_matches_jax_bit_for_bit(mode, bidir, init):
    size = tmx.ops.rnn_op.rnn_param_size(mode, 6, 4, 2, bidir)
    out = []
    for mx in (jmx, tmx):
        mx.random.seed(42)
        inner = None if init is None else mx.init.create(init)
        arr = mx.nd.zeros((size,), **_ctx(mx))
        fused = mx.init.FusedRNN(inner, 4, 2, mode, bidir, forget_bias=1.5)
        # the Module's route: the variable's __init__ attribute
        mx.init.Xavier(magnitude=2.0)(mx.init.InitDesc(
            "x_parameters", {"__init__": fused.dumps()}), arr)
        out.append(arr.asnumpy())
    assert out[1].std() > 0
    np.testing.assert_array_equal(out[1], out[0])


def test_module_init_fused_blob_matches_jax():
    """Module.init_params routes the fused blob through the FusedRNN
    initializer (the variable's __init__ attribute), baking the lstm
    forget bias; the blob equals the JAX package's bit for bit."""
    blobs = []
    for mx in (jmx, tmx):
        fused = mx.rnn.FusedRNNCell(4, num_layers=2, mode="lstm",
                                    prefix="f_")
        out, _ = fused.unroll(2, mx.sym.Variable("data"),
                              merge_outputs=True)
        mod = mx.mod.Module(mx.sym.MakeLoss(mx.sym.sum(out)), ("data",),
                            None, **({"context": tmx.cpu()}
                                     if mx is tmx else {}))
        mod.bind([mx.io.DataDesc("data", (2, 2, 3))], None)
        mx.random.seed(9)
        mod.init_params(mx.init.Xavier())
        blob = mod.get_params()[0]["f_parameters"]
        with _scope(mx):
            unp = fused.unpack_weights({"f_parameters": blob})
        np.testing.assert_array_equal(unp["f_l1_i2h_f_bias"].asnumpy(),
                                      np.ones(4, np.float32))
        np.testing.assert_array_equal(unp["f_l1_h2h_f_bias"].asnumpy(),
                                      np.zeros(4, np.float32))
        blobs.append(blob.asnumpy())
    np.testing.assert_array_equal(blobs[1], blobs[0])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_rnn_checkpoints_load_across_packages(tmp_path, writer, reader):
    """save_rnn_checkpoint writes the fused blob as per-gate arrays; the
    other package's load_rnn_checkpoint repacks them into the fused
    layout bit for bit, and into an unfused stack; do_rnn_checkpoint
    writes every period-th epoch."""
    pkg = {"jax": jmx, "torch": tmx}
    prefix = str(tmp_path / "lm")
    size = tmx.ops.rnn_op.rnn_param_size("lstm", 4, 6, 2, False)
    blob = np.random.RandomState(0).uniform(-0.5, 0.5, size).astype(
        np.float32)
    fc = np.random.RandomState(1).randn(3, 6).astype(np.float32)
    mx = pkg[writer]
    with _scope(mx):
        fused = mx.rnn.FusedRNNCell(6, num_layers=2, mode="lstm",
                                    prefix="ck_")
        out, _ = fused.unroll(3, mx.sym.Variable("data"),
                              merge_outputs=True)
        args = {"ck_parameters": mx.nd.array(blob),
                "fc_weight": mx.nd.array(fc)}
        mx.rnn.save_rnn_checkpoint(fused, prefix, 1, out, args, {})
        cb = mx.rnn.do_rnn_checkpoint(fused, prefix, period=2)
        cb(0, out, args, {})
        cb(1, out, args, {})
    mx = pkg[reader]
    with _scope(mx):
        fused = mx.rnn.FusedRNNCell(6, num_layers=2, mode="lstm",
                                    prefix="ck_")
        sym, args2, aux = mx.rnn.load_rnn_checkpoint(fused, prefix, 1)
        _, args3, _ = mx.rnn.load_rnn_checkpoint(fused.unfuse(), prefix, 2)
    np.testing.assert_array_equal(args2["ck_parameters"].asnumpy(), blob)
    np.testing.assert_array_equal(args2["fc_weight"].asnumpy(), fc)
    assert aux == {} and "ck_l1_h2h_weight" in args3
    assert sym.list_arguments() == out.list_arguments()
    assert not (tmp_path / "lm-0001.params.tmp").exists()
    assert not (tmp_path / "lm-0003.params").exists()


def _sentences(seed, n=200, vocab=20, longest=12):
    rng = np.random.RandomState(seed)
    return [[int(w) for w in rng.randint(1, vocab, size=rng.randint(
        1, longest + 3))] for _ in range(n)]


@pytest.mark.parametrize("layout,buckets", [("NT", [4, 8, 12]),
                                            ("TN", None)])
def test_bucket_sentence_iter_matches_jax(layout, buckets):
    """encode_sentences and BucketSentenceIter: the same vocab, batches,
    labels, bucket keys and descriptors over two epochs under the same
    random and numpy seeds."""
    words = [["w%d" % w for w in s] for s in _sentences(0)]
    runs = []
    for mx in (jmx, tmx):
        enc, vocab = mx.rnn.encode_sentences(words, invalid_label=0,
                                             start_label=1)
        random.seed(5)
        np.random.seed(5)
        with _scope(mx):
            it = mx.rnn.BucketSentenceIter(enc, batch_size=4,
                                           buckets=buckets,
                                           invalid_label=0, layout=layout)
        seen = []
        for _epoch in range(2):
            it.reset()
            for b in it:
                seen.append((b.bucket_key, b.data[0].asnumpy(),
                             b.label[0].asnumpy(),
                             [tuple(d) for d in b.provide_data],
                             [tuple(d) for d in b.provide_label]))
        runs.append((enc, vocab, it.buckets, it.default_bucket_key,
                     [tuple(d) for d in it.provide_data], seen))
    (je, jv, jb, jk, jp, js), (te, tv, tb, tk, tp, ts) = runs
    assert (te, tv, tb, tk, tp) == (je, jv, jb, jk, jp)
    assert len(ts) == len(js) > 4
    for a, b in zip(ts, js):
        assert a[0] == b[0] and a[3:] == b[3:]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    with pytest.raises(ValueError, match="not in provided vocab"):
        tmx.rnn.encode_sentences([["zz"]], vocab=tv)


V, E, HID = 24, 8, 10


def _lm_sym_gen(mx, dropout):
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=V, output_dim=E,
                                 name="embed")
        cell = mx.rnn.FusedRNNCell(HID, num_layers=2, mode="lstm",
                                   dropout=dropout, prefix="lstm_")
        outputs, _ = cell.unroll(seq_len, embed, layout="NTC",
                                 merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, HID))
        pred = mx.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, label, use_ignore=True,
                                     ignore_label=0, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_bucketing_module_fit_matches_jax(dropout):
    """Two epochs of BucketingModule.fit over BucketSentenceIter (buckets
    4, 8, 12; SGD momentum; the fused 2-layer LSTM with inter-layer
    dropout when p > 0; the padding ignored): the trained parameters
    within rtol 1e-4 / atol 1e-5 of the JAX package's, the perplexity
    after every batch within rtol 1e-4, and the second epoch's below
    the first's."""
    # learnable sentences: each word is the one before it plus one
    rng = np.random.RandomState(1)
    sents = [[(start + i) % (V - 1) + 1 for i in range(length)]
             for start, length in zip(rng.randint(0, V, 120),
                                      rng.randint(2, 13, 120))]
    res = []
    for mx in (jmx, tmx):
        random.seed(7)
        np.random.seed(7)
        mx.random.seed(7)
        with _scope(mx):
            it = mx.rnn.BucketSentenceIter(sents, batch_size=8,
                                           buckets=[4, 8, 12],
                                           invalid_label=0)
        mod = mx.mod.BucketingModule(
            _lm_sym_gen(mx, dropout), default_bucket_key=it.
            default_bucket_key, **({"context": tmx.cpu()}
                                   if mx is tmx else {}))
        perps = []

        def log(param, perps=perps):
            perps.append(param.eval_metric.get()[1])
        mod.fit(it, num_epoch=2, eval_metric=mx.metric.Perplexity(0),
                initializer=mx.init.Xavier(), optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                batch_end_callback=log)
        res.append(({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                    perps))
    (pj, perp_j), (pt, perp_t) = res
    assert sorted(pt) == sorted(pj) == ["embed_weight", "lstm_parameters",
                                        "pred_bias", "pred_weight"]
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(perp_t, perp_j, rtol=1e-4)
    # each epoch's perplexity, read after its last batch
    assert perp_t[-1] < 0.8 * perp_t[len(perp_t) // 2 - 1], perp_t
