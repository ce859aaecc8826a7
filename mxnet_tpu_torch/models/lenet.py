"""LeNet symbol — the PyTorch twin of ``mxnet_tpu/models/lenet.py`` (same
graph and names; reference: example/image-classification/symbols/lenet.py),
the MNIST workload of BASELINE config #1."""
from .. import symbol as sym


def get_symbol(num_classes=10, **kwargs):
    data = sym.Variable("data")
    # first conv
    conv1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=20)
    tanh1 = sym.Activation(data=conv1, act_type="tanh")
    pool1 = sym.Pooling(data=tanh1, pool_type="max", kernel=(2, 2),
                        stride=(2, 2))
    # second conv
    conv2 = sym.Convolution(data=pool1, kernel=(5, 5), num_filter=50)
    tanh2 = sym.Activation(data=conv2, act_type="tanh")
    pool2 = sym.Pooling(data=tanh2, pool_type="max", kernel=(2, 2),
                        stride=(2, 2))
    # first fullc
    flatten = sym.Flatten(data=pool2)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=500)
    tanh3 = sym.Activation(data=fc1, act_type="tanh")
    # second fullc
    fc2 = sym.FullyConnected(data=tanh3, num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc2, name="softmax")
