"""Gluon recurrent layers (reference: python/mxnet/gluon/rnn/)."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell,
                       LSTMCell, GRUCell, SequentialRNNCell, DropoutCell,
                       ModifierCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU
