"""Symbolic RNN cells for explicit unrolling with the Module/Bucketing API
— the PyTorch twin of ``mxnet_tpu/rnn/rnn_cell.py``.

Capability parity with the reference toolkit
(python/mxnet/rnn/rnn_cell.py:362-1339): RNN/LSTM/GRU cells, the fused
multi-layer cell, stacking/bidirectional/dropout/zoneout/residual
combinators, and fused<->unfused weight repacking.

Design notes:
- Initial states default to zeros with a broadcast batch dim of 1; the
  graph's elementwise ops broadcast them against the real batch at the
  first time step (the ``RNN`` op expands them), which replaces the
  reference's deferred (0, hidden) shape machinery.
- ``FusedRNNCell`` lowers to the single ``RNN`` op (ops/rnn_op.py: torch's
  fused recurrence, cuDNN on CUDA); explicit cells unroll to a static
  graph of per-step ops.
"""
from __future__ import annotations

import numpy as np

from .. import initializer as init
from .. import ndarray as nd
from ..ops.rnn_op import _layer_param_sizes, rnn_param_size
from ..symbol import Symbol, Variable
from ..symbol import op as _op

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


class RNNParams(object):
    """Lazily-created pool of weight variables shared between cells
    (reference rnn_cell.py:RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._pool = {}

    def get(self, name, **kwargs):
        """Return (creating on first use) the variable ``prefix + name``."""
        full = self._prefix + name
        if full not in self._pool:
            self._pool[full] = Variable(full, **kwargs)
        return self._pool[full]


def _time_axis(layout):
    axis = layout.find("T")
    if axis < 0:
        raise ValueError("invalid RNN layout %r (needs a T axis)" % layout)
    return axis


def _split_inputs(length, inputs, layout):
    """Normalize ``inputs`` to a list of per-step symbols.

    Returns (steps, was_merged): a single-output Symbol is a merged
    sequence tensor and is split along the layout's time axis."""
    if isinstance(inputs, Symbol) and len(inputs) == 1:
        steps = list(_op.SliceChannel(inputs, num_outputs=length,
                                      axis=_time_axis(layout),
                                      squeeze_axis=True))
        return steps, True
    steps = list(inputs)
    if len(steps) != length:
        raise ValueError("unroll length %d != %d provided inputs"
                         % (length, len(steps)))
    return steps, False


def _merge_outputs(outputs, layout):
    """Stack per-step symbols back into one sequence tensor."""
    axis = _time_axis(layout)
    expanded = [_op.expand_dims(o, axis=axis) for o in outputs]
    return _op.Concat(*expanded, dim=axis)


class BaseRNNCell(object):
    """Abstract cell: a symbolic state-transition function plus weight
    bookkeeping (reference rnn_cell.py:BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        """Restart step/state naming counters before a fresh unroll."""
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        """Apply one step: (step_input, states) -> (output, new_states)."""
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        """Per-state dicts with 'shape' (0 = batch) and '__layout__'."""
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info.get("shape") if info else None
                for info in self.state_info]

    @property
    def _gate_names(self):
        """Gate suffixes, in the order gates are packed along the leading
        weight axis ('' for single-gate cells)."""
        return ("",)

    def begin_state(self, func=None, **kwargs):
        """Initial-state symbols. Default: broadcastable zeros (batch dim
        1); pass ``func`` (e.g. ``mx.sym.Variable``-returning) to
        customize."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            shape = tuple(1 if int(d) == 0 else int(d)
                          for d in (info or {}).get("shape", ()))
            if func is None:
                states.append(_op._zeros(shape=shape, name=name, **kwargs))
            else:
                states.append(func(name=name, shape=shape, **kwargs))
        return states

    # -- fused<->unfused weight layout --------------------------------------
    def _iter_packed(self):
        """(packed_key, gated_keys, n_gates) triples covered by this cell."""
        gates = self._gate_names
        for group in ("i2h", "h2h"):
            for wb in ("weight", "bias"):
                packed = "%s%s_%s" % (self._prefix, group, wb)
                split = ["%s%s%s_%s" % (self._prefix, group,
                                        ("_" + g) if g else "", wb)
                         for g in gates]
                yield packed, split, len(gates)

    def unpack_weights(self, args):
        """Split concatenated-gate weights into per-gate arrays."""
        args = dict(args)
        for packed, split, n in self._iter_packed():
            if n == 1 or packed not in args:
                continue
            arr = args.pop(packed)
            step = arr.shape[0] // n
            for i, key in enumerate(split):
                args[key] = arr[i * step:(i + 1) * step].copy()
        return args

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights`."""
        args = dict(args)
        for packed, split, n in self._iter_packed():
            if n == 1 or not all(k in args for k in split):
                continue
            pieces = [args.pop(k) for k in split]
            args[packed] = nd.Concat(*pieces, dim=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell for ``length`` steps.

        Returns (outputs, final_states); outputs is one merged tensor when
        ``merge_outputs`` is True (default: merged iff the input was)."""
        self.reset()
        steps, was_merged = _split_inputs(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for x in steps:
            out, states = self(x, states)
            outputs.append(out)
        if merge_outputs is None:
            merge_outputs = was_merged
        if merge_outputs:
            outputs = _merge_outputs(outputs, layout)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return _op.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla Elman cell: h' = act(W_x x + b_x + W_h h + b_h)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super(RNNCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = _op.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name="%si2h" % name)
        h2h = _op.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden,
                                 name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order [i, f, c, o] along the packed weight axis
    (matches ops/rnn_op.py so fused checkpoints repack losslessly)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super(LSTMCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init=init.LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("i", "f", "c", "o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = _op.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=4 * self._num_hidden,
                                 name="%si2h" % name)
        h2h = _op.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=4 * self._num_hidden,
                                 name="%sh2h" % name)
        gates = _op.SliceChannel(i2h + h2h, num_outputs=4, axis=-1,
                                 name="%sslice" % name)
        in_gate = _op.Activation(gates[0], act_type="sigmoid")
        forget_gate = _op.Activation(gates[1], act_type="sigmoid")
        in_trans = _op.Activation(gates[2], act_type="tanh")
        out_gate = _op.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * _op.Activation(next_c, act_type="tanh",
                                           name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order [r, z, o] (reset, update, transform)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super(GRUCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("r", "z", "o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = _op.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=3 * self._num_hidden,
                                 name="%si2h" % name)
        h2h = _op.FullyConnected(data=prev_h, weight=self._hW, bias=self._hB,
                                 num_hidden=3 * self._num_hidden,
                                 name="%sh2h" % name)
        xr, xz, xo = _op.SliceChannel(i2h, num_outputs=3, axis=-1,
                                      name="%si2h_slice" % name)
        hr, hz, ho = _op.SliceChannel(h2h, num_outputs=3, axis=-1,
                                      name="%sh2h_slice" % name)
        reset = _op.Activation(xr + hr, act_type="sigmoid")
        update = _op.Activation(xz + hz, act_type="sigmoid")
        cand = _op.Activation(xo + reset * ho, act_type="tanh")
        next_h = (1.0 - update) * cand + update * prev_h
        return next_h, [next_h]


_FUSED_BASE = {
    "rnn_relu": lambda h, p, pa, fb: RNNCell(h, "relu", p, pa),
    "rnn_tanh": lambda h, p, pa, fb: RNNCell(h, "tanh", p, pa),
    "lstm": lambda h, p, pa, fb: LSTMCell(h, p, pa, forget_bias=fb),
    "gru": lambda h, p, pa, fb: GRUCell(h, p, pa)}


class FusedRNNCell(BaseRNNCell):
    """Multi-layer (optionally bidirectional) recurrence lowered to the
    fused ``RNN`` op (reference rnn_cell.py:FusedRNNCell,
    src/operator/rnn-inl.h)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super(FusedRNNCell, self).__init__(prefix=prefix, params=params)
        if mode not in _FUSED_BASE:
            raise ValueError("unknown RNN mode %r" % mode)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameter = self.params.get(
            "parameters", init=init.FusedRNN(
                None, num_hidden, num_layers, mode, bidirectional,
                forget_bias))

    @property
    def _dirs(self):
        return 2 if self._bidirectional else 1

    @property
    def state_info(self):
        shape = (self._num_layers * self._dirs, 0, self._num_hidden)
        info = [{"shape": shape, "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append({"shape": shape, "__layout__": "LNC"})
        return info

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("i", "f", "c", "o"),
                "gru": ("r", "z", "o")}[self._mode]

    def _cell_prefix(self, layer, direction):
        return "%s%s%d_" % (self._prefix,
                            "r" if direction else "l", layer)

    def _blob_slices(self, input_size):
        """Yield (key_name, flat_slice, shape) over the packed blob, using
        the per-(layer, direction) layout shared with ops/rnn_op.py."""
        sizes = _layer_param_sizes(self._mode, input_size, self._num_hidden,
                                   self._num_layers, self._bidirectional)
        n_gates = len(self._gate_names)
        per_ld = 2  # w_i2h, w_h2h in the weight section
        pos = 0
        entries = []
        for idx, (kind, size, shape) in enumerate(sizes):
            if kind.startswith("w"):
                ld = idx // per_ld
            else:
                ld = (idx - self._num_layers * self._dirs * per_ld) // per_ld
            layer, d = divmod(ld, self._dirs)
            group = "i2h" if kind.endswith("i2h") else "h2h"
            wb = "weight" if kind.startswith("w") else "bias"
            gate_rows = shape[0] // n_gates
            for gi, g in enumerate(self._gate_names):
                key = "%s%s%s_%s" % (self._cell_prefix(layer, d), group,
                                     ("_" + g) if g else "", wb)
                gsize = size // n_gates
                gshape = (gate_rows,) + tuple(shape[1:])
                entries.append((key, slice(pos + gi * gsize,
                                           pos + (gi + 1) * gsize), gshape))
            pos += size
        return entries, pos

    def _infer_input_size(self, blob_len):
        """Recover input_size from the packed blob length (closed form:
        the blob is linear in input_size)."""
        base = rnn_param_size(self._mode, 0, self._num_hidden,
                              self._num_layers, self._bidirectional)
        slope = rnn_param_size(self._mode, 1, self._num_hidden,
                               self._num_layers, self._bidirectional) - base
        input_size, rem = divmod(blob_len - base, slope)
        if rem:
            raise ValueError("parameter blob of length %d does not match "
                             "this cell's geometry" % blob_len)
        return int(input_size)

    def unpack_weights(self, args):
        """The blob split into per-gate arrays, on the blob's context (the
        current one for a host array)."""
        args = dict(args)
        blob = args.pop(self._prefix + "parameters")
        ctx = getattr(blob, "context", None)
        arr = blob.asnumpy() if hasattr(blob, "asnumpy") else np.asarray(blob)
        entries, total = self._blob_slices(self._infer_input_size(arr.size))
        assert total == arr.size
        for key, sl, shape in entries:
            args[key] = nd.array(arr[sl].reshape(shape), ctx=ctx)
        return args

    def pack_weights(self, args):
        """The per-gate arrays packed into the blob, on their context (the
        current one for host arrays)."""
        args = dict(args)
        probe = args["%si2h%s_weight" % (
            self._cell_prefix(0, 0),
            ("_" + self._gate_names[0]) if self._gate_names[0] else "")]
        ctx = getattr(probe, "context", None)
        input_size = probe.shape[1]
        entries, total = self._blob_slices(input_size)
        blob = np.zeros(total, dtype="float32")
        for key, sl, shape in entries:
            piece = args.pop(key)
            piece = piece.asnumpy() if hasattr(piece, "asnumpy") \
                else np.asarray(piece)
            blob[sl] = piece.reshape(-1)
        args[self._prefix + "parameters"] = nd.array(blob, ctx=ctx)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped one symbol at a time; "
            "use unroll() (or unfuse() for explicit cells)")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if not (isinstance(inputs, Symbol) and len(inputs) == 1):
            was_merged = False
            inputs = _merge_outputs(list(inputs), layout)
        else:
            was_merged = True
        data = inputs if layout.startswith("T") else \
            _op.SwapAxis(inputs, dim1=0, dim2=1)

        if begin_state is None:
            begin_state = self.begin_state()
        kw = {"state": begin_state[0]}
        if self._mode == "lstm":
            kw["state_cell"] = begin_state[1]
        rnn = _op.RNN(data=data, parameters=self._parameter,
                      state_size=self._num_hidden,
                      num_layers=self._num_layers,
                      bidirectional=self._bidirectional,
                      p=self._dropout, mode=self._mode,
                      state_outputs=self._get_next_state,
                      name="%srnn" % self._prefix, **kw)
        if self._get_next_state:
            outputs = rnn[0]
            states = [rnn[1], rnn[2]] if self._mode == "lstm" else [rnn[1]]
        else:
            outputs, states = rnn, []
        if not layout.startswith("T"):
            outputs = _op.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is None:
            merge_outputs = was_merged
        if not merge_outputs:
            outputs = list(_op.SliceChannel(
                outputs, num_outputs=length, axis=_time_axis(layout),
                squeeze_axis=True))
        return outputs, states

    def unfuse(self):
        """Equivalent stack of explicit cells sharing this cell's unpacked
        weight names (for stepping / debugging)."""
        stack = SequentialRNNCell()
        make = _FUSED_BASE[self._mode]
        fb = self._forget_bias
        for layer in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make(self._num_hidden,
                         self._cell_prefix(layer, 0), None, fb),
                    make(self._num_hidden,
                         self._cell_prefix(layer, 1), None, fb),
                    output_prefix="%sbi_%d_" % (self._prefix, layer)))
            else:
                stack.add(make(self._num_hidden,
                               self._cell_prefix(layer, 0), None, fb))
            if self._dropout > 0 and layer != self._num_layers - 1:
                stack.add(DropoutCell(
                    self._dropout, prefix="%s_dropout%d_" % (self._prefix,
                                                             layer)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Vertical stack of cells: each layer's outputs feed the next."""

    def __init__(self, params=None):
        super(SequentialRNNCell, self).__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child " \
                "cells, not both."
            cell.params._pool.update(self.params._pool)
        self.params._pool.update(cell.params._pool)

    def reset(self):
        super(SequentialRNNCell, self).reset()
        for cell in getattr(self, "_cells", []):
            cell.reset()

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum((c.begin_state(**kwargs) for c in self._cells), [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def _split_states(self, states):
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info)
            yield cell, states[pos:pos + n]
            pos += n

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        for cell, sub in self._split_states(states):
            inputs, new = cell(inputs, sub)
            next_states.extend(new)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        next_states = []
        num = len(self._cells)
        for i, (cell, sub) in enumerate(self._split_states(begin_state)):
            merge = merge_outputs if i == num - 1 else None
            inputs, states = cell.unroll(length, inputs, begin_state=sub,
                                         layout=layout, merge_outputs=merge)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout layer usable inside a cell stack."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super(DropoutCell, self).__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = _op.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if isinstance(inputs, Symbol) and len(inputs) == 1:
            out, _ = self(inputs, [])
            if merge_outputs is False:
                out = list(_op.SliceChannel(out, num_outputs=length,
                                            axis=_time_axis(layout),
                                            squeeze_axis=True))
            return out, []
        return super(DropoutCell, self).unroll(
            length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """Wraps a cell to tweak its step function while borrowing its
    weights (reference rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        super(ModifierCell, self).__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization: randomly hold states/outputs at their
    previous value (Krueger et al. 2016)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse() first"
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell does not support zoneout; wrap the cells " \
            "underneath instead"
        super(ZoneoutCell, self).__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super(ZoneoutCell, self).reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        new_output, new_states = self.base_cell(inputs, states)

        def keep_mask(rate, like):
            return _op.Dropout(_op.ones_like(like), p=rate)

        output = new_output
        if self.zoneout_outputs > 0.:
            prev = self.prev_output
            if prev is None:
                prev = _op.zeros_like(new_output)
            output = _op.where(keep_mask(self.zoneout_outputs, new_output),
                               new_output, prev)
        if self.zoneout_states > 0.:
            new_states = [
                _op.where(keep_mask(self.zoneout_states, new_s), new_s,
                          old_s)
                for new_s, old_s in zip(new_states, states)]
        self.prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds the step input to the base cell's output (He et al. 2015)."""

    def __init__(self, base_cell):
        super(ResidualCell, self).__init__(base_cell)

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return _op.elemwise_add(output, inputs), states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        if isinstance(outputs, Symbol) and len(outputs) == 1:
            if not (isinstance(inputs, Symbol) and len(inputs) == 1):
                inputs = _merge_outputs(list(inputs), layout)
            outputs = _op.elemwise_add(outputs, inputs)
        else:
            steps, _ = _split_inputs(length, inputs, layout)
            outputs = [_op.elemwise_add(o, x)
                       for o, x in zip(outputs, steps)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Runs one cell forward and one backward over the sequence and
    concatenates their per-step outputs on the feature axis."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super(BidirectionalCell, self).__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params, \
                "Either specify params for BidirectionalCell or child " \
                "cells, not both."
            l_cell.params._pool.update(self.params._pool)
            r_cell.params._pool.update(self.params._pool)
        self.params._pool.update(l_cell.params._pool)
        self.params._pool.update(r_cell.params._pool)
        self._cells = [l_cell, r_cell]

    def reset(self):
        super(BidirectionalCell, self).reset()
        for cell in getattr(self, "_cells", []):
            cell.reset()

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum((c.begin_state(**kwargs) for c in self._cells), [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell needs the whole sequence; use unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, was_merged = _split_inputs(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_out, l_states = l_cell.unroll(length, steps,
                                        begin_state=begin_state[:n_l],
                                        layout=layout, merge_outputs=False)
        r_out, r_states = r_cell.unroll(length, list(reversed(steps)),
                                        begin_state=begin_state[n_l:],
                                        layout=layout, merge_outputs=False)
        r_out = list(reversed(r_out))
        outputs = [_op.Concat(l, r, dim=1,
                              name="%st%d" % (self._output_prefix, i))
                   for i, (l, r) in enumerate(zip(l_out, r_out))]
        if merge_outputs is None:
            merge_outputs = was_merged
        if merge_outputs:
            outputs = _merge_outputs(outputs, layout)
        return outputs, l_states + r_states
