"""Gluon recurrent cells (reference: python/mxnet/gluon/rnn/rnn_cell.py,
805 LoC)."""
from __future__ import annotations

from contextlib import contextmanager

from ... import ndarray as nd
from ... import symbol as sym_mod
from ...base import string_types
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return [info for c in cells for info in c.state_info(batch_size)]


def _cells_begin_state(cells, **kwargs):
    return [s for c in cells for s in c.begin_state(**kwargs)]


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    """Default zero initial states when the caller supplied none."""
    return begin_state if begin_state is not None else \
        cell.begin_state(func=F.zeros, batch_size=batch_size)


@contextmanager
def _unmodified(cell):
    """Temporarily lift a cell's modified flag so its own
    begin_state/unroll can be called from the modifier wrapping it."""
    cell._modified = False
    try:
        yield cell
    finally:
        cell._modified = True


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Bring ``inputs`` into the form ``unroll`` wants.

    Source forms: a per-step list, or one time-merged Symbol/NDArray
    (time axis taken from ``in_layout`` when it differs from ``layout``).
    Targets: ``merge=True`` -> one array stacked on ``layout``'s time
    axis; ``False`` -> per-step list; ``None`` -> keep the source form
    (merged arrays are still re-laid-out to ``layout``).

    Returns ``(converted, time_axis, F, batch_size)`` — F is the
    sym/nd namespace the data lives in, batch_size is 0 for symbols
    (unknown until binding). Capability parity with reference
    rnn_cell.py:_format_sequence; the conversion logic is organised by
    source form rather than by namespace.
    """
    if inputs is None:
        raise ValueError("unroll(inputs=None) is not supported; pass the "
                         "sequence (shape inference happens at bind)")
    t_axis = layout.find("T")
    n_axis = layout.find("N")
    src_t = in_layout.find("T") if in_layout is not None else t_axis

    if isinstance(inputs, (list, tuple)):
        # per-step list: every element one timestep, no layout ambiguity
        assert length is None or len(inputs) == length
        F = sym_mod if isinstance(inputs[0], sym_mod.Symbol) else nd
        batch_size = 0 if F is sym_mod else inputs[0].shape[n_axis]
        if merge is not True:
            return list(inputs), t_axis, F, batch_size
        merged = F.concat(*[F.expand_dims(s, axis=t_axis)
                            for s in inputs], dim=t_axis)
        return merged, t_axis, F, batch_size

    # one merged array, time on src_t
    F = sym_mod if isinstance(inputs, sym_mod.Symbol) else nd
    batch_size = 0 if F is sym_mod else inputs.shape[n_axis]
    if merge is False:
        if F is nd:
            assert length is None or length == inputs.shape[src_t]
            n_steps = inputs.shape[src_t]
        else:
            n_steps = length   # symbols need the static step count
        pieces = F.SliceChannel(inputs, axis=src_t, num_outputs=n_steps,
                                squeeze_axis=1)
        if not isinstance(pieces, (list, tuple)):
            pieces = [pieces]
        return list(pieces), t_axis, F, batch_size
    if src_t != t_axis:
        inputs = F.SwapAxis(inputs, dim1=t_axis, dim2=src_t)
    return inputs, t_axis, F, batch_size


class RecurrentCell(Block):
    """Abstract recurrent cell (reference
    rnn_cell.py:RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset step counters (reference rnn_cell.py:reset)."""
        self._init_counter = -1
        self._counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (reference rnn_cell.py:begin_state)."""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell " \
            "instead."
        if func is None:
            func = nd.zeros

        def _make(info):
            self._init_counter += 1
            spec = {**(info or {}), **kwargs}
            spec.pop("__layout__", None)
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            try:
                return func(name=name, **spec)
            except TypeError:
                # ndarray creators take positional shape, no name
                return func(spec.pop("shape"), **spec)

        return [_make(info) for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll for `length` steps (reference
        rnn_cell.py:unroll)."""
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        outputs, states = [], begin_state
        for step_in in inputs[:length]:
            step_out, states = self(step_in, states)
            outputs.append(step_out)
        outputs, _, _, _ = _format_sequence(length, outputs, layout,
                                            merge_outputs)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, string_types):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Hybridizable recurrent cell (reference
    rnn_cell.py:HybridRecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """Shared machinery for the i2h/h2h gate cells (RNN/LSTM/GRU):
    parameter declaration, NC state descriptors, and the two fused
    gate projections. Parameter names/shapes match the reference
    (i2h_weight is (ngates*hidden, input) etc., rnn_cell.py) so
    checkpoints interoperate; the class factoring is this repo's own."""

    _NGATES = 1
    _NSTATES = 1

    def __init__(self, hidden_size, input_size, inits, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        rows = self._NGATES * hidden_size
        for pname, shape, init in (
                ("i2h_weight", (rows, input_size), inits[0]),
                ("h2h_weight", (rows, hidden_size), inits[1]),
                ("i2h_bias", (rows,), inits[2]),
                ("h2h_bias", (rows,), inits[3])):
            setattr(self, pname, self.params.get(
                pname, shape=shape, init=init,
                allow_deferred_init=True))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * self._NSTATES

    def _projections(self, F, inputs, h_prev, i2h_weight, h2h_weight,
                     i2h_bias, h2h_bias):
        rows = self._NGATES * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=rows),
                F.FullyConnected(h_prev, h2h_weight, h2h_bias,
                                 num_hidden=rows))


class RNNCell(_GatedCell):
    """Elman RNN cell (reference rnn_cell.py:RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gate order [i, f, c, o] (reference
    rnn_cell.py:LSTMCell)."""

    _NGATES = 4
    _NSTATES = 2

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         prefix, params)

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h_prev, c_prev = states
        i2h, h2h = self._projections(F, inputs, h_prev, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        gi, gf, gc, go = F.SliceChannel(i2h + h2h, num_outputs=4)
        sigmoid = lambda g: F.Activation(g, act_type="sigmoid")  # noqa: E731
        next_c = sigmoid(gf) * c_prev + \
            sigmoid(gi) * F.Activation(gc, act_type="tanh")
        next_h = sigmoid(go) * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gate order [r, z, o] (reference
    rnn_cell.py:GRUCell)."""

    _NGATES = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         prefix, params)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h_prev = states[0]
        i2h, h2h = self._projections(F, inputs, h_prev, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        ir, iz, ic = F.SliceChannel(i2h, num_outputs=3)
        hr, hz, hc = F.SliceChannel(h2h, num_outputs=3)
        reset = F.Activation(ir + hr, act_type="sigmoid")
        update = F.Activation(iz + hz, act_type="sigmoid")
        cand = F.Activation(ic + reset * hc, act_type="tanh")
        next_h = update * h_prev + (1. - update) * cand
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells (reference rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def _split_states(self, states):
        """Carve the flat state list into per-child slices."""
        it = iter(states)
        return [[next(it) for _ in cell.state_info()]
                for cell in self._children]

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        for cell, sub in zip(self._children, self._split_states(states)):
            assert not isinstance(cell, BidirectionalCell)
            inputs, sub = cell(inputs, sub)
            next_states += sub
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                    None)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        next_states = []
        last = len(self._children) - 1
        for i, (cell, sub) in enumerate(
                zip(self._children, self._split_states(begin_state))):
            # intermediate layers keep whatever form is cheapest
            # (merge=None); only the last honors merge_outputs
            inputs, sub = cell.unroll(
                length, inputs=inputs, begin_state=sub, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            next_states += sub
        return inputs, next_states

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on non-state output (reference
    rnn_cell.py:DropoutCell)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, float)
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if isinstance(inputs, (nd.NDArray, sym_mod.Symbol)):
            return self.hybrid_forward(F, inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(HybridRecurrentCell):
    """Base for cells that modify another cell (reference
    rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified " \
            "twice" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        with _unmodified(self.base_cell) as base:
            return base.begin_state(func=func or nd.zeros, **kwargs)

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def zone(p, new, old):
            # inverted-dropout mask: where it fires take the fresh
            # value, elsewhere the zoned-out carry sticks
            if p == 0.:
                return new
            return F.where(F.Dropout(F.ones_like(new), p=p), new, old)

        carry = self._prev_output
        output = zone(self.zoneout_outputs, next_output,
                      F.zeros_like(next_output) if carry is None
                      else carry)
        new_states = [zone(self.zoneout_states, n, o)
                      for n, o in zip(next_states, states)]
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """output = base(input) + input (reference
    rnn_cell.py:ResidualCell)."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        with _unmodified(self.base_cell) as base:
            outputs, states = base.unroll(
                length, inputs=inputs, begin_state=begin_state,
                layout=layout, merge_outputs=merge_outputs)

        # add the skip connection in whatever form the base returned
        if merge_outputs is None:
            merge_outputs = not isinstance(outputs, (list, tuple))
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if merge_outputs:
            return outputs + inputs, states
        return [o + x for o, x in zip(outputs, inputs)], states


class BidirectionalCell(HybridRecurrentCell):
    """Forward + backward cells over a sequence (reference
    rnn_cell.py:BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, _, F, batch_size = _format_sequence(length, inputs,
                                                   layout, False)
        begin_state = _get_begin_state(self, F, begin_state, steps,
                                       batch_size)

        fwd_cell, bwd_cell = self._children
        n_fwd = len(fwd_cell.state_info())
        fwd_out, fwd_states = fwd_cell.unroll(
            length, inputs=steps, begin_state=begin_state[:n_fwd],
            layout=layout, merge_outputs=merge_outputs)
        # run the reverse direction on the flipped sequence, then flip
        # its per-step outputs back into forward time order
        bwd_out, bwd_states = bwd_cell.unroll(
            length, inputs=steps[::-1], begin_state=begin_state[n_fwd:],
            layout=layout, merge_outputs=False)
        bwd_out = bwd_out[::-1]

        if merge_outputs is None:
            merge_outputs = not isinstance(fwd_out, (list, tuple))
            fwd_out, _, _, _ = _format_sequence(None, fwd_out, layout,
                                                merge_outputs)
        bwd_out, _, _, _ = _format_sequence(None, bwd_out, layout,
                                            merge_outputs)

        if merge_outputs:
            joined = F.concat(fwd_out, bwd_out, dim=2)
        else:
            joined = [F.concat(f, b, dim=1)
                      for f, b in zip(fwd_out, bwd_out)]
        return joined, fwd_states + bwd_states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError
