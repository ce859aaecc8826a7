"""The port's ``mx.viz`` and ``mx.rtc`` against the JAX package's, on the
CPU (after ``tests/test_viz_rtc.py``): ``print_summary`` prints the same
table and total for the JAX test's LeNet and for ResNet-50,
``plot_network`` gives the same graphviz source, and ``Rtc`` runs the JAX
test's sources (Python over torch tensors here, over jax arrays there) to
the same results, refusing a source without its function and wrong
arities alike."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu_torch.models import resnet as tresnet


def _lenet(mx):
    data = mx.sym.Variable("data")
    c1 = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                            name="conv1")
    a1 = mx.sym.Activation(c1, act_type="relu", name="relu1")
    p1 = mx.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2),
                        pool_type="max", name="pool1")
    fc = mx.sym.FullyConnected(mx.sym.Flatten(p1), num_hidden=10,
                               name="fc1")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def _resnet50(mx, models):
    return models.get_symbol(num_classes=1000, num_layers=50,
                             image_shape=(3, 224, 224))


NETS = {"lenet": (lambda mx, _m: _lenet(mx), (1, 1, 28, 28)),
        "resnet50": (_resnet50, (1, 3, 224, 224))}


def _build(mx, models, net):
    with mx.name.NameManager():
        return NETS[net][0](mx, models)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("with_shape", [True, False])
def test_print_summary_matches_jax(capsys, net, with_shape):
    shape = {"data": NETS[net][1]} if with_shape else None
    jtotal = jmx.viz.print_summary(_build(jmx, jresnet, net), shape=shape)
    jtext = capsys.readouterr().out
    ttotal = tmx.viz.print_summary(_build(tmx, tresnet, net), shape=shape)
    ttext = capsys.readouterr().out
    assert ttext == jtext
    assert ttotal == jtotal
    assert "Total params: %d" % ttotal in ttext
    if net == "lenet" and with_shape:
        assert ttotal == (8 * 9 + 8) + (10 * 8 * 13 * 13 + 10)
    if net == "resnet50" and with_shape:
        # 25,549,480 learned parameters and 45,568 moving statistics
        assert ttotal == 25_595_048, ttotal
    with pytest.raises(TypeError):
        tmx.viz.print_summary("not a symbol")


def test_plot_network_matches_jax():
    pytest.importorskip("graphviz")
    shape = {"data": (1, 1, 28, 28)}
    for hide in (True, False):
        jdot = jmx.viz.plot_network(_build(jmx, jresnet, "lenet"),
                                    shape=shape, hide_weights=hide)
        tdot = tmx.viz.plot_network(_build(tmx, tresnet, "lenet"),
                                    shape=shape, hide_weights=hide)
        assert tdot.source == jdot.source
        assert "conv1" in tdot.source and "softmax" in tdot.source
    assert tmx.visualization is tmx.viz


SAXPY = """
def saxpy(x, y):
    return 2.5 * x + y
"""
SQUARES = """
def squares(x):
    return x * x, x + x
"""


def test_rtc_saxpy_matches_jax():
    x = np.arange(6, dtype="float32")
    y = np.ones(6, "float32")
    jout = jmx.nd.zeros((6,))
    jmx.rtc.Rtc("saxpy", ["x", "y"], ["out"], SAXPY).push(
        [jmx.nd.array(x), jmx.nd.array(y)], [jout])
    with tmx.cpu():
        tout = tmx.nd.zeros((6,))
        got = tmx.rtc.Rtc("saxpy", ["x", "y"], ["out"], SAXPY).push(
            [tmx.nd.array(x), tmx.nd.array(y)], [tout], (1, 1, 1), (6, 1, 1))
    assert got == [tout]
    np.testing.assert_array_equal(tout.asnumpy(), jout.asnumpy())
    np.testing.assert_allclose(tout.asnumpy(), 2.5 * x + 1, rtol=1e-6)


def test_rtc_two_outputs_cast_to_each_output_dtype():
    x = np.array([1.5, 2.0, -3.25], "float32")
    ja, jb = jmx.nd.zeros((3,)), jmx.nd.zeros((3,), dtype="int32")
    jmx.rtc.Rtc("squares", ["x"], ["a", "b"], SQUARES).push(
        [jmx.nd.array(x)], [ja, jb])
    with tmx.cpu():
        ta, tb = tmx.nd.zeros((3,)), tmx.nd.zeros((3,), dtype="int32")
        tmx.rtc.Rtc("squares", ["x"], ["a", "b"], SQUARES).push(
            [tmx.nd.array(x)], [ta, tb])
    assert tb.dtype == jb.dtype == np.int32
    np.testing.assert_array_equal(ta.asnumpy(), ja.asnumpy())
    np.testing.assert_array_equal(tb.asnumpy(), jb.asnumpy())


def test_rtc_source_sees_torch_and_inspect_finds_it():
    """The namespace binds torch; the source is readable through
    ``inspect`` (``triton.jit`` reads its kernel's source)."""
    import inspect
    src = """
def cumsum(x):
    return torch.cumsum(x, dim=0)
"""
    rtc = tmx.rtc.Rtc("cumsum", ["x"], ["y"], src)
    with tmx.cpu():
        out = tmx.nd.zeros((4,))
        rtc.push([tmx.nd.array(np.arange(4, dtype="float32"))], [out])
    np.testing.assert_array_equal(out.asnumpy(), [0, 1, 3, 6])
    assert inspect.getsource(rtc._fn) == src.lstrip("\n")


def test_rtc_refusals_match_jax():
    for mx in (jmx, tmx):
        with pytest.raises(ValueError, match="named 'f'"):
            mx.rtc.Rtc("f", ["x"], ["y"], "g = 3")
        with pytest.raises(ValueError, match="named 'f'"):
            mx.rtc.Rtc("f", ["x"], ["y"], "f = 3")
    with tmx.cpu():
        rtc = tmx.rtc.Rtc("squares", ["x"], ["a", "b"], SQUARES)
        x = tmx.nd.ones((2,))
        with pytest.raises(ValueError, match="expected 1 inputs"):
            rtc.push([x, x], [tmx.nd.zeros((2,))] * 2)
        with pytest.raises(ValueError, match="returned 2 outputs, "
                                             "expected 1"):
            rtc.push([x], [tmx.nd.zeros((2,))])
