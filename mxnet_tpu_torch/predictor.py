"""Deploy-time inference: the predict-only API and its export — the
PyTorch twin of ``mxnet_tpu/predictor.py``.

Reference: src/c_api/c_predict_api.cc (MXPredCreate/SetInput/Forward/
GetOutput — load a symbol JSON + param blob, run forward-only).

``Predictor.export`` / ``export_buckets`` write the JAX package's files
under the same names and keys (``prefix.meta.json``; per bucket
``prefix.b<K>.meta.json`` and a ``prefix.serve.json`` manifest). The JAX
package's artifact is a StableHLO program, which runs only under JAX; the
port's meta carries a ``torch_forward`` entry instead (the symbol's JSON
and a parameter ``.npz``), from which :class:`CompiledPredictor` rebuilds
the forward and, on the card, captures it as one CUDA graph at the
exported shapes. ``ServeEngine.from_export`` serves the bucket set.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np
import torch

from . import telemetry as _telemetry
from .base import gc_paused, torch_dtype
from .context import current_context
from .executor import _graph_eval_fn
from .ndarray import NDArray, _wrap
from .ndarray.ndarray import _from_numpy, _to_numpy_exact
from .ops.custom import refuse_capture

__all__ = ["Predictor", "CompiledPredictor", "load_checkpoint_predictor"]

# the meta entry that rebuilds the forward (the JAX package's meta has the
# StableHLO program beside it instead)
_REBUILD_KEY = "torch_forward"


def _as_tensor(x, device):
    if isinstance(x, NDArray):
        x = x.handle
    elif not isinstance(x, torch.Tensor):
        x = _from_numpy(np.asarray(x))
    return x.to(device)


class Predictor:
    """Forward-only executor with its parameters held on one device
    (reference MXAPIPredictor). Inputs are positional by ``data_names``
    or keyword; outputs are NDArrays on that device.

    ctx: the device (default: the current context, which is gpu(0)
    unless a ``with mx.cpu():`` scope says otherwise). Without CUDA,
    a gpu context raises; pass ``ctx=mx.cpu()`` to run on the CPU.

    Loss-head label variables that feed the loss DIRECTLY are
    zero-filled via shape inference; labels that pass through reshaping
    ops first are not inferable from data alone — declare them in
    ``data_names`` and feed dummy arrays (loss heads ignore labels
    outside training)."""

    def __init__(self, symbol, arg_params, aux_params=None,
                 data_names=("data",), ctx=None):
        self._symbol = symbol
        self._data_names = list(data_names)
        self._output_names = symbol.list_outputs()
        self._device = (ctx or current_context()).torch_device()
        dev = self._device
        self._params = {k: _as_tensor(v, dev) for k, v in arg_params.items()}
        self._auxs = {k: _as_tensor(v, dev)
                      for k, v in (aux_params or {}).items()}
        self._missing = [n for n in symbol.list_arguments()
                         if n not in self._params
                         and n not in self._data_names]
        not_labels = [n for n in self._missing if "label" not in n]
        if not_labels:
            raise ValueError("predictor missing parameters %r"
                             % not_labels)
        self._eval_fn = _graph_eval_fn(symbol)
        self._outputs = None

    @property
    def device(self):
        return self._device

    def _fwd(self, *data):
        arg_vals = dict(self._params)
        arg_vals.update(zip(self._data_names, data))
        if self._missing:
            # loss-layer labels are dead at inference; zero-fill with
            # inferred shapes (reference: MXPredCreate binds provided
            # args only — loss heads ignore labels when not training)
            shapes, _o, _a = self._symbol.infer_shape_partial(
                **{n: tuple(arg_vals[n].shape) for n in self._data_names})
            for n, s in zip(self._symbol.list_arguments(), shapes):
                if n in self._missing and s is not None:
                    arg_vals[n] = torch.zeros(s, dtype=data[0].dtype,
                                              device=self._device)
        outs, _aux = self._eval_fn(arg_vals, dict(self._auxs), 0, False)
        return outs

    def forward(self, *args, **kwargs):
        """Run inference; accepts arrays positionally (data_names order)
        or by name (reference MXPredSetInput + MXPredForward)."""
        if kwargs:
            args = [kwargs[n] for n in self._data_names]
        with torch.inference_mode():
            self._outputs = self._fwd(
                *[_as_tensor(a, self._device) for a in args])
        return [_wrap(o) for o in self._outputs]

    def get_output(self, index):
        if self._outputs is None:
            raise RuntimeError("run forward() first")
        return _wrap(self._outputs[index])

    @property
    def output_names(self):
        return list(self._output_names)

    # -- export ------------------------------------------------------------
    def export(self, prefix, data_shapes, dtype="float32", _params=None):
        """Write the forward for :meth:`CompiledPredictor.load`:
        ``prefix.meta.json`` with the JAX package's keys (data_names,
        output_names, data_shapes, dtype) plus ``torch_forward`` (the
        symbol's JSON and the parameter file's name), and the parameters
        in ``prefix.params.npz`` (``arg:``/``aux:`` keys, bf16 as raw
        2-byte words). Returns the meta's path."""
        refuse_capture(self._symbol, "Predictor.export")
        shapes = dict(data_shapes)
        missing = [n for n in self._data_names if n not in shapes]
        if missing:
            raise ValueError("data_shapes missing inputs %r" % missing)
        params_file = _params or self._write_params(prefix + ".params.npz")
        meta = {"data_names": self._data_names,
                "output_names": self._output_names,
                "data_shapes": {n: [int(d) for d in shapes[n]]
                                for n in self._data_names},
                "dtype": str(dtype),
                _REBUILD_KEY: {"symbol": self._symbol.tojson(),
                               "params": os.path.basename(params_file)}}
        path = prefix + ".meta.json"
        with open(path, "w") as f:
            json.dump(meta, f)
        return path

    def _write_params(self, path, digest=None):
        """The parameters into ``path`` (an ``.npz``); ``digest`` (a
        hashlib object) takes each array's name, dtype, shape and
        bytes."""
        arrays = {"arg:" + k: _to_numpy_exact(v)
                  for k, v in self._params.items()}
        arrays.update({"aux:" + k: _to_numpy_exact(v)
                       for k, v in self._auxs.items()})
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        if digest is not None:
            for k in sorted(arrays):
                a = np.ascontiguousarray(arrays[k])
                digest.update(("%s %s %s\n" % (k, a.dtype.str, a.shape))
                              .encode())
                digest.update(a.tobytes())
        return path

    def export_buckets(self, prefix, feature_shapes, buckets=None,
                       dtype="float32", model_id=None):
        """Serve-ready export: one meta per batch bucket
        (``prefix.b<K>.meta.json``, sharing one ``prefix.params.npz``)
        plus the ``prefix.serve.json`` manifest (buckets, data_names,
        feature_shapes, dtype, model_id — the JAX package's keys), for
        :meth:`~mxnet_tpu_torch.serve.ServeEngine.from_export`.

        feature_shapes: one per-input shape WITHOUT the batch axis, in
        ``data_names`` order. buckets: ascending batch sizes (default
        ``MXNET_SERVE_BUCKETS``). model_id: the generation stamp replicas
        report in their ``hello`` frame; default a content hash
        ``gen-<hash12>`` over the parameters and the bucket metas, so
        re-exporting identical weights yields the same stamp. It hashes
        the port's artifact, so it differs from the JAX package's stamp
        (a hash of its StableHLO programs) for the same weights (ROADMAP
        Queue C). Returns the manifest path."""
        from . import config as _config
        refuse_capture(self._symbol, "Predictor.export_buckets")
        if buckets is None:
            from .serve.engine import _parse_buckets
            buckets = _parse_buckets(_config.get("MXNET_SERVE_BUCKETS"))
        buckets = sorted(int(b) for b in buckets)
        feats = [tuple(int(d) for d in s) for s in feature_shapes]
        if len(feats) != len(self._data_names):
            raise ValueError(
                "feature_shapes must have one entry per data input %r"
                % (self._data_names,))
        # the stamp hashes the parameters and each bucket's meta (without
        # the parameter file's name, which carries the prefix)
        digest = hashlib.sha256()
        params_file = self._write_params(prefix + ".params.npz", digest)
        for b in buckets:
            path = self.export(
                "%s.b%d" % (prefix, b),
                {n: (b,) + s for n, s in zip(self._data_names, feats)},
                dtype=dtype, _params=params_file)
            with open(path) as f:
                meta = json.load(f)
            meta[_REBUILD_KEY].pop("params")
            digest.update(json.dumps(meta, sort_keys=True).encode())
        if model_id is None:
            model_id = "gen-" + digest.hexdigest()[:12]
        manifest = prefix + ".serve.json"
        with open(manifest, "w") as f:
            json.dump({"buckets": buckets,
                       "data_names": self._data_names,
                       "feature_shapes": [list(s) for s in feats],
                       "dtype": dtype,
                       "model_id": str(model_id)}, f)
        return manifest


class CompiledPredictor:
    """Runs an exported forward, rebuilt from its files alone (the meta
    and the parameter file): no symbol or parameters are passed in.

    On the card the forward at the exported shapes runs once on a side
    stream (the warm-up), then is captured as one ``torch.cuda.CUDAGraph``
    over static input tensors; every ``forward`` copies its inputs in,
    replays the graph and returns copies of the outputs. A capture that
    fails raises: nothing falls back to the eager forward. On the CPU
    (``ctx=mx.cpu()``) the forward runs directly, each call."""

    def __init__(self, predictor, meta):
        self._pred = predictor
        self._meta = meta
        self._data_names = list(meta["data_names"])
        self._shapes = [tuple(meta["data_shapes"][n])
                        for n in self._data_names]
        self._dtype = torch_dtype(meta.get("dtype", "float32"))
        self._outputs = None
        self._lock = threading.Lock()
        self._graph = None
        self._static = None          # (inputs, outputs) of the graph
        self.capture_ms = None
        if predictor.device.type == "cuda":
            self._capture()

    @classmethod
    def load(cls, prefix, ctx=None):
        """Rebuild the forward exported under ``prefix`` on ``ctx``
        (default: the current context, gpu(0) unless a ``with
        mx.cpu():`` scope says otherwise)."""
        from .symbol import load_json
        meta_path = prefix + ".meta.json"
        with open(meta_path) as f:
            meta = json.load(f)
        if _REBUILD_KEY not in meta:
            if os.path.exists(prefix + ".stablehlo"):
                raise ValueError(
                    "%s holds a forward exported by the JAX package (a "
                    "StableHLO program, which runs only under JAX) and no "
                    "%r entry in its meta; export it with the PyTorch "
                    "package's Predictor.export" % (prefix, _REBUILD_KEY))
            raise ValueError("%s is no exported forward: %s has no %r "
                             "entry" % (prefix, meta_path, _REBUILD_KEY))
        spec = meta[_REBUILD_KEY]
        path = os.path.join(os.path.dirname(meta_path), spec["params"])
        arg_params, aux_params = {}, {}
        with np.load(path, allow_pickle=False) as blob:
            for key in blob.files:
                kind, name = key.split(":", 1)
                (arg_params if kind == "arg" else aux_params)[name] = \
                    _from_numpy(blob[key])
        pred = Predictor(load_json(spec["symbol"]), arg_params, aux_params,
                         data_names=meta["data_names"], ctx=ctx)
        return cls(pred, meta)

    @property
    def device(self):
        return self._pred.device

    def _capture(self):
        """Warm up on a side stream, then capture the forward into one
        CUDA graph over static inputs."""
        dev = self.device
        inputs = [torch.zeros(s, dtype=self._dtype, device=dev)
                  for s in self._shapes]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad():
            self._pred._fwd(*inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = _telemetry.now_ms()
        with torch.no_grad(), gc_paused(), torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            outs = self._pred._fwd(*inputs)
        torch.cuda.synchronize(dev)
        self.capture_ms = _telemetry.now_ms() - t0
        self._graph = graph
        self._static = (inputs, list(outs))

    def _check(self, args):
        if len(args) != len(self._data_names):
            raise ValueError("forward takes %d inputs %r, got %d"
                             % (len(self._data_names), self._data_names,
                                len(args)))
        feed = []
        for n, a, shape in zip(self._data_names, args, self._shapes):
            t = a.handle if isinstance(a, NDArray) else a
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.ascontiguousarray(t))
            if tuple(t.shape) != shape:
                raise ValueError("input %r: shape %s, exported %s"
                                 % (n, tuple(t.shape), shape))
            feed.append(t)
        return feed

    def forward(self, *args, **kwargs):
        if kwargs:
            args = [kwargs[n] for n in self._data_names]
        feed = self._check(args)
        if self._graph is None:
            with torch.inference_mode():
                outs = self._pred._fwd(*[t.to(self.device, self._dtype)
                                         for t in feed])
        else:
            with self._lock:
                inputs, static_outs = self._static
                for dst, t in zip(inputs, feed):
                    dst.copy_(t)
                self._graph.replay()
                outs = [o.clone() for o in static_outs]
        self._outputs = outs
        return [_wrap(o) for o in outs]

    def get_output(self, index):
        if self._outputs is None:
            raise RuntimeError("run forward() first")
        return _wrap(self._outputs[index])

    @property
    def output_names(self):
        return list(self._meta["output_names"])


def load_checkpoint_predictor(prefix, epoch, data_names=("data",),
                              ctx=None):
    """Build a Predictor straight from ``model.save_checkpoint`` files
    (reference MXPredCreate loading prefix-symbol.json + .params)."""
    from .model import load_checkpoint
    sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
    return Predictor(sym, arg_params, aux_params, data_names=data_names,
                     ctx=ctx)
