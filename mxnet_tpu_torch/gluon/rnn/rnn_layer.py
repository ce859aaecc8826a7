"""Gluon RNN/LSTM/GRU layers — the PyTorch twin of
``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference:
python/mxnet/gluon/rnn/rnn_layer.py, 526 LoC).

The reference backs these with the fused cuDNN RNN op (rnn-inl.h:124).
Here, as in the JAX package, the layer unrolls its cells: each step is
the cells' FullyConnected and elementwise ops, so the layer's parameters
keep the cells' names and shapes."""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block
from .rnn_cell import (BidirectionalCell, LSTMCell, GRUCell, RNNCell,
                       SequentialRNNCell, DropoutCell)

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(Block):
    """Base multi-layer (bi)RNN (reference rnn_layer.py:_RNNLayer)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, prefix=None,
                 params=None, **cell_kwargs):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size

        def make_cell(layer, suffix=""):
            kw = dict(cell_kwargs)
            kw["input_size"] = input_size if layer == 0 else \
                hidden_size * self._dir
            if mode == "rnn_relu":
                return RNNCell(hidden_size, activation="relu",
                               prefix="l%d%s_" % (layer, suffix), **kw)
            if mode == "rnn_tanh":
                return RNNCell(hidden_size, activation="tanh",
                               prefix="l%d%s_" % (layer, suffix), **kw)
            if mode == "lstm":
                return LSTMCell(hidden_size,
                                prefix="l%d%s_" % (layer, suffix), **kw)
            if mode == "gru":
                return GRUCell(hidden_size,
                               prefix="l%d%s_" % (layer, suffix), **kw)
            raise ValueError("unknown mode %s" % mode)

        with self.name_scope():
            self._unfused = SequentialRNNCell(prefix="", params=None)
            for i in range(num_layers):
                if bidirectional:
                    self._unfused.add(BidirectionalCell(
                        make_cell(i), make_cell(i, "r"),
                        output_prefix="bi_%s_%d" % (mode, i)))
                else:
                    self._unfused.add(make_cell(i))
                if dropout and i < num_layers - 1:
                    self._unfused.add(DropoutCell(dropout))

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states for this layer (reference
        rnn_layer.py:begin_state)."""
        return self._unfused.begin_state(batch_size=batch_size, func=func,
                                         **kwargs)

    def forward(self, inputs, states=None):
        """Unrolled forward (reference rnn_layer.py:forward)."""
        axis = self._layout.find("T")
        batch_size = inputs.shape[self._layout.find("N")]
        length = inputs.shape[axis]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size)
        if isinstance(states, nd.NDArray):
            states = [states]
        outputs, states = self._unfused.unroll(
            length, inputs, begin_state=states, layout=self._layout,
            merge_outputs=True)
        if skip_states:
            return outputs
        return outputs, states

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        mapping = "{0} -> {1}".format(
            self._input_size if self._input_size else None,
            self._hidden_size)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (reference rnn_layer.py:RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py:LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py:GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
