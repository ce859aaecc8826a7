"""Symbolic RNN toolkit — the PyTorch twin of ``mxnet_tpu/rnn`` (reference:
python/mxnet/rnn/)."""
from . import rnn_cell
from .rnn_cell import (BaseRNNCell, RNNParams, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ModifierCell, ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint, rnn_unroll)
