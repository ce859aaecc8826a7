"""Autoregressive generation — KV-cache decoding for the transformer LM;
the PyTorch twin of ``mxnet_tpu/generation.py``.

``Generator`` drives ``models.transformer.get_decode_symbol``'s graph with
the parameters of a trained ``get_symbol`` checkpoint (the same names).
The caches (KV rows, int8 rows and scales, SSM states) are aux tensors
the cache ops write in place. Prefill runs the (B, P) graph eagerly;
``generate`` then runs one eager (B, 1) forward a token and reads each
token back, while ``generate_on_device`` keeps the whole loop on the
device: the decode step (pick a token, then the forward) reads its token,
position, cache position, PRNG key and step counter from static device
buffers, writes its token into a static (B, n) buffer, and is captured
once as a CUDA graph and replayed, with one host read at the end (and,
with ``eos_id``, one every 16 steps). A capture that fails raises;
nothing falls back to the eager loop. On the CPU (the caller asked for it
with ``ctx=mx.cpu()``) the same step runs uncaptured.

Sampling follows the JAX package's key discipline bit for bit
(``_threefry``): ``key = PRNGKey(seed)`` and one ``split`` a drawn token
(``replay_key``); ``categorical`` draws the same tokens from the same
logits. ``beam_search_on_device`` and ``generate_speculative_on_device``
capture their step (a beam step, a speculative round) the same way.

``serving_decoder`` returns the continuous-batching decoder
(``serve/decode.py``). The mesh (``mesh=``, ROADMAP Queue A item 9) is not
ported yet and raises.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _threefry
from . import telemetry as _telemetry
from .base import torch_dtype
from .context import current_context
from .executor import _graph_eval_fn
from .models import transformer
from .ndarray.ndarray import _from_numpy, _to_numpy_exact

__all__ = ["Generator", "kv_blob_nbytes", "replay_key"]

def kv_blob_nbytes(blob):
    """Payload bytes of an :meth:`Generator.export_kv_rows` blob: the
    cache-row arrays only."""
    return sum(int(a.nbytes) for a in blob["rows"].values())


def _param_tensor(v, device):
    """A parameter (port NDArray, tensor, numpy or JAX array) as a tensor
    on ``device``."""
    data = getattr(v, "_data", v)
    if isinstance(data, torch.Tensor):
        return data.detach().to(device)
    return _from_numpy(np.asarray(data)).to(device)


def _host_ids(x):
    """Token ids (numpy, list or tensor) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _log_softmax_last(logits):
    """float32 log-softmax of the last position's logits (B, V)."""
    return torch.log_softmax(logits[:, -1].float(), dim=-1)


class Generator:
    """Drives ``transformer.get_decode_symbol`` with the parameters of a
    trained ``transformer.get_symbol`` checkpoint (same names).

    arg_params: name -> array (NDArray of either package, tensor, numpy).
    vocab_size, num_layers, num_heads, dim, ffn_hidden, pos_encoding,
    attention_window, num_kv_heads, block_type: the architecture, as
    trained. max_len: cache capacity (prompt + generated tokens).
    batch_size: rows decoded together. dtype: compute dtype of the
    parameters and caches (e.g. "bfloat16"). quantize="int8": weight-only
    int8 layers; quantize_kv: int8 KV caches; rolling_cache: circular
    caches of one window. ctx: where it runs (default: the current
    context, gpu(0) unless a ``with mx.cpu():`` scope says otherwise)."""

    def __init__(self, arg_params, vocab_size, max_len, num_layers=2,
                 num_heads=4, dim=128, ffn_hidden=None, batch_size=1,
                 dtype=None, num_experts=0, mesh=None, quantize=None,
                 pos_encoding="learned", attention_window=0,
                 rolling_cache=False, num_kv_heads=None,
                 quantize_kv=False, block_type="attention", ctx=None):
        if mesh is not None:
            raise NotImplementedError(
                "Generator(mesh=...) needs the parallel axes, not ported "
                "to the PyTorch package yet (ROADMAP Queue A item 9)")
        if quantize not in (None, "int8"):
            raise ValueError("quantize must be None or 'int8', got %r"
                             % (quantize,))
        if quantize_kv and rolling_cache:
            raise ValueError("quantize_kv is not supported with "
                             "rolling_cache")
        self.vocab_size = int(vocab_size)
        if self.vocab_size > 2 ** 24:
            # token ids ride the float32 "data" input convention
            raise ValueError(
                "vocab_size=%d exceeds the float32-exact id range (2^24); "
                "larger vocabularies need integer id plumbing"
                % self.vocab_size)
        self.max_len = int(max_len)
        self.batch_size = int(batch_size)
        self.num_layers = int(num_layers)
        self.ctx = ctx if ctx is not None else current_context()
        self.device = self.ctx.torch_device()
        self._window = int(attention_window or 0)
        self._rolling = bool(rolling_cache)
        head_dim = dim // num_heads
        kv_heads = int(num_kv_heads or num_heads)
        self._btypes = transformer._canon_block_types(block_type,
                                                      num_layers)
        self._has_ssm = "ssm" in self._btypes
        self._decode_opts = dict(
            vocab_size=vocab_size, max_len=max_len, num_layers=num_layers,
            num_heads=num_heads, dim=dim, ffn_hidden=ffn_hidden,
            num_experts=num_experts, quantized=quantize is not None,
            compute_dtype=str(torch_dtype(dtype)).replace("torch.", "")
            if dtype else None,
            pos_encoding=pos_encoding, attention_window=attention_window,
            rolling_cache=rolling_cache, num_kv_heads=num_kv_heads,
            kv_quantize=quantize_kv, block_type=block_type)
        sym = transformer.get_decode_symbol(**self._decode_opts)
        if quantize:
            arg_params = _quantize_weights(arg_params, sym.list_arguments())
        self._sym = sym
        self._eval_fn = _graph_eval_fn(sym)
        self._loop_cache = {}

        cdt = torch_dtype(dtype) if dtype else None
        wanted = set(sym.list_arguments())
        self._params = {}
        for k, v in arg_params.items():
            if k not in wanted:
                continue
            t = _param_tensor(v, self.device)
            # int8 weights and their f32 scales keep their dtypes
            if cdt is not None and t.is_floating_point() and \
                    not k.endswith("_scale"):
                t = t.to(cdt)
            self._params[k] = t
        missing = wanted - set(self._params) - {"data", "positions",
                                                 "cache_pos"}
        if missing:
            raise ValueError("Generator missing parameters: %s"
                             % sorted(missing))
        self._pos_rows = None
        if pos_encoding == "learned":
            self._pos_rows = int(self._params["pos_embed_weight"].shape[0])
            if not self._rolling and self._pos_rows < self.max_len:
                # the decode graph's position lookup clips
                raise ValueError(
                    "max_len=%d exceeds the trained position table (%d "
                    "rows) — generation past it would silently clip"
                    % (self.max_len, self._pos_rows))
        # the cache dtype follows the FLOAT params (an int8 cache would
        # truncate k/v under quantize="int8")
        self._cache_dtype = cdt if cdt is not None else next(
            v.dtype for v in self._params.values() if v.is_floating_point())
        self._cache_shape = (self.batch_size, kv_heads, self.max_len,
                             head_dim)
        # SSM layers: one (B, H, hd, hd) float32 state each, whatever the
        # compute dtype (the bit-identical state rule is stated in f32)
        self._state_shape = (self.batch_size, int(num_heads), head_dim,
                             head_dim)
        self._quantize_kv = bool(quantize_kv)
        _telemetry.gauge("serve.decode.kv_bytes_per_slot").set(
            self.state_bytes_per_slot())

    # -- decode state ------------------------------------------------------

    def _aux_spec(self, name):
        """(shape, torch dtype) of one decode-state aux: THE one rule the
        allocation, the sizing and the export read."""
        if name.endswith("_state"):
            return self._state_shape, torch.float32
        if name.endswith(("_k_scale", "_v_scale")):
            return self._cache_shape[:3], torch.float32
        if self._quantize_kv:
            return self._cache_shape, torch.int8
        return self._cache_shape, self._cache_dtype

    def _aux_row_shape(self, name, pos):
        """Shape of one batch row's exported state for aux ``name`` at
        position ``pos``: a length-indexed cache ships its ``[:, :pos]``
        prefix, an SSM state whole."""
        shape, _ = self._aux_spec(name)
        if name.endswith("_state"):
            return tuple(shape[1:])
        return (shape[1], pos) + tuple(shape[3:])

    def kv_cache_bytes(self):
        """Bytes of the whole decode-state aux at (batch_size, max_len),
        from shapes and dtypes alone."""
        total = 0
        for name in self._sym.list_auxiliary_states():
            shape, dtype = self._aux_spec(name)
            n = 1
            for d in shape:
                n *= int(d)
            total += n * dtype.itemsize
        return total

    def state_bytes_per_slot(self):
        """Bytes of decode state one batch row (one serving slot) owns:
        the ``serve.decode.kv_bytes_per_slot`` gauge."""
        return self.kv_cache_bytes() // self.batch_size

    def export_kv_rows(self, aux, row, pos):
        """One sequence's decode state out of an aux dict: each
        length-indexed cache's ``[row, :, :pos]`` prefix (int8 rows and
        their f32 scales under quantize_kv), each SSM state's ``[row]``
        whole, as numpy in the device dtype bit for bit (bf16 as raw
        2-byte words, as the JAX package saves it). The rows are copied
        before they leave, so later in-place cache writes do not reach
        the blob. Returns ``{"v": 1, "pos": pos, "rows": {name: array}}``."""
        if self._rolling:
            raise ValueError(
                "export_kv_rows does not support rolling caches (a "
                "circular buffer's rows are not position-aligned, so a "
                "prefix slice is not the sequence's state)")
        row, pos = int(row), int(pos)
        if not 0 <= row < self.batch_size:
            raise ValueError("row %d out of range for batch_size=%d"
                             % (row, self.batch_size))
        if not 1 <= pos <= self.max_len:
            raise ValueError("pos %d out of range for max_len=%d"
                             % (pos, self.max_len))
        wanted = set(self._sym.list_auxiliary_states())
        if set(aux) != wanted:
            raise ValueError(
                "aux pytree names %s do not match this Generator's caches "
                "%s" % (sorted(aux), sorted(wanted)))
        rows = {}
        for name in sorted(wanted):
            _, dtype = self._aux_spec(name)
            want = self._aux_row_shape(name, pos)
            full = aux[name][row]
            part = full if name.endswith("_state") else full[:, :pos]
            if part.dtype != dtype or tuple(part.shape) != want:
                raise ValueError(
                    "cache %r is %s%r, expected %s%r — the aux pytree does "
                    "not belong to this Generator"
                    % (name, part.dtype, tuple(part.shape), dtype, want))
            rows[name] = _to_numpy_exact(part.clone())
        return {"v": 1, "pos": pos, "rows": rows}

    @staticmethod
    def _check_sampling(temperature, top_k, top_p):
        """top_k/top_p act only on the sampled path: refuse them at
        temperature <= 0 instead of ignoring them."""
        if (top_k or top_p) and not (temperature
                                     and float(temperature) > 0):
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature<=0 "
                "decodes greedily and would silently ignore them)")

    def _check_prompt(self, prompt, max_new_tokens):
        prompt = _host_ids(prompt)
        if prompt.ndim != 2 or prompt.shape[0] != self.batch_size:
            raise ValueError("prompt must be (batch_size, P), got %r"
                             % (prompt.shape,))
        P = prompt.shape[1]
        if self._rolling:
            if self._window + P - 1 > self.max_len:
                raise ValueError(
                    "rolling cache capacity max_len=%d must be >= window "
                    "(%d) + prompt (%d) - 1" % (self.max_len, self._window,
                                                P))
            if self._pos_rows is not None and \
                    P + max_new_tokens > self._pos_rows:
                raise ValueError(
                    "learned positions cap total length at the table (%d "
                    "rows); use pos_encoding='rope' for unbounded rolling "
                    "generation" % self._pos_rows)
        elif P + max_new_tokens > self.max_len:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds the cache "
                "capacity max_len=%d" % (P, max_new_tokens, self.max_len))
        return prompt, P

    def _fresh_aux(self, rows=None):
        """Zeroed decode state, ``rows`` batch rows (default batch_size)."""
        aux = {}
        for name in self._sym.list_auxiliary_states():
            shape, dtype = self._aux_spec(name)
            if rows is not None:
                shape = (rows,) + tuple(shape[1:])
            aux[name] = torch.zeros(shape, dtype=dtype, device=self.device)
        return aux

    def _run(self, args, aux):
        """The decode graph over ``args`` (data, positions, cache_pos
        beside the parameters); the caches are written in place. Returns
        (logits (B, Tnew, V), aux)."""
        with torch.no_grad():
            outs, new_aux = self._eval_fn(args, aux, 0, False)
        return outs[0], new_aux

    def _forward(self, aux, tokens, pos):
        """tokens: (B, Tnew) ids (host or device); pos: a Python int.
        Returns (logits (B, Tnew, V), aux), the caches written in place."""
        tn = tokens.shape[1]
        if pos + tn > 2 ** 24:
            # positions ride the float32 input convention
            raise ValueError(
                "position %d exceeds the float32-exact range (2^24); "
                "longer rolling generation needs integer position "
                "plumbing" % (pos + tn))
        dev = self.device
        args = dict(self._params)
        if isinstance(tokens, torch.Tensor):
            args["data"] = tokens.to(device=dev, dtype=torch.float32)
        else:
            args["data"] = torch.from_numpy(
                np.asarray(tokens, dtype=np.float32)).to(dev)
        args["positions"] = torch.arange(pos, pos + tn, dtype=torch.float32,
                                         device=dev)
        args["cache_pos"] = torch.full((1,), pos, dtype=torch.float32,
                                       device=dev)
        return self._run(args, aux)

    def log_likelihood(self, tokens):
        """Teacher-forcing score: per-row sum of log P(t_{i+1} | t_<=i)
        over the sequence, through one prefill. tokens: (B, Tseq), Tseq <=
        max_len; returns (B,) float64."""
        tokens = _host_ids(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != self.batch_size:
            raise ValueError("tokens must be (batch_size, T), got %r"
                             % (tokens.shape,))
        if tokens.shape[1] > self.max_len:
            raise ValueError("sequence length %d exceeds max_len=%d"
                             % (tokens.shape[1], self.max_len))
        if self._pos_rows is not None and tokens.shape[1] > self._pos_rows:
            raise ValueError(
                "sequence length %d exceeds the trained position table (%d "
                "rows) — scoring would silently clip"
                % (tokens.shape[1], self._pos_rows))
        logits, _ = self._forward(self._fresh_aux(), tokens, 0)
        logp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
        nxt = tokens[:, 1:].astype(np.int64)
        rows = np.arange(self.batch_size)[:, None]
        cols = np.arange(tokens.shape[1] - 1)[None, :]
        return logp[rows, cols, nxt].sum(axis=1).astype(np.float64)

    # -- beam search -------------------------------------------------------

    def beam_search(self, prompt, max_new_tokens, beam_size=4,
                    length_penalty=0.0, eos_id=None):
        """Beam decoding over the same KV-cache graph: beams fold into the
        batch (caches at B*W), and after each step the caches are
        reordered by the surviving beams' parents. Returns (B, P + n) ids,
        the best beam per row by score / (generated length) **
        length_penalty (the top-k a stable sort: ties to the lower
        index). eos_id freezes a beam (only eos continues it, at
        no cost); search stops early when every beam is frozen."""
        prompt, P = self._check_prompt(prompt, max_new_tokens)
        B, W, V = self.batch_size, int(beam_size), self.vocab_size
        if W < 1:
            raise ValueError("beam_size must be >= 1")
        logits, aux = self._forward(self._fresh_aux(), prompt, 0)
        aux = {k: v.repeat_interleave(W, dim=0) for k, v in aux.items()}
        last = np.repeat(_log_softmax_last(logits).cpu().numpy(), W, axis=0)
        # all but beam 0 start at -inf, so step 1 picks W distinct tokens
        scores = np.full((B, W), -np.inf)
        scores[:, 0] = 0.0
        tokens = np.zeros((B, W, 0), np.int64)
        frozen = np.zeros((B, W), bool)
        for t in range(max_new_tokens):
            logp = last.reshape(B, W, V).copy()
            if eos_id is not None:
                logp[frozen] = -np.inf
                logp[frozen, eos_id] = 0.0
            cand = scores[:, :, None] + logp
            flat = cand.reshape(B, W * V)
            top = np.argsort(-flat, axis=1, kind="stable")[:, :W]
            parent = top // V
            tok = top % V
            scores = np.take_along_axis(flat, top, axis=1)
            tokens = np.concatenate(
                [np.take_along_axis(tokens, parent[:, :, None], axis=1),
                 tok[:, :, None]], axis=2)
            if eos_id is not None:
                frozen = np.take_along_axis(frozen, parent, axis=1) \
                    | (tok == eos_id)
                if frozen.all():
                    break
            if t + 1 == max_new_tokens:
                break
            flat_idx = torch.from_numpy(
                (np.arange(B)[:, None] * W + parent).reshape(-1)).to(
                    self.device)
            aux = {k: v.index_select(0, flat_idx) for k, v in aux.items()}
            logits, aux = self._forward(aux, tok.reshape(-1, 1), P + t)
            last = _log_softmax_last(logits).cpu().numpy()
        return np.concatenate([prompt.astype(np.int64),
                               _best_beam(tokens, scores, length_penalty,
                                          eos_id)], axis=1)

    def beam_search_on_device(self, prompt, max_new_tokens, beam_size=4,
                              length_penalty=0.0, eos_id=None):
        """beam_search with its loop on the device: each step (the (W*V)
        top-k, the reorder of the token history and the caches, the next
        forward) runs on static tensors, captured once as a CUDA graph on
        the card (``_BeamLoop``); the tokens and scores come back once at
        the end. Fixed trip count (frozen beams extend with free eos
        tokens), so the output is always P + n long. The scores are
        float64 and the top-k a stable sort (ties to the lower index), as
        the host loop's, so both pick the same beams from the same logits.
        Each (P, max_new_tokens, beam_size, eos_id) keeps its own captured
        step. Returns (B, P + n) ids."""
        prompt, P = self._check_prompt(prompt, max_new_tokens)
        W = int(beam_size)
        if W < 1:
            raise ValueError("beam_size must be >= 1")
        n = int(max_new_tokens)
        if n == 0:
            return np.asarray(prompt, np.int64)
        key_ = ("beam", P, n, W, -1 if eos_id is None else int(eos_id))
        loop = self._loop_cache.get(key_)
        if loop is None:
            loop = self._loop_cache[key_] = _BeamLoop(self, *key_[1:])
        tokens, scores = loop.run(prompt)
        return np.concatenate([prompt.astype(np.int64), _best_beam(
            tokens, scores, length_penalty, eos_id)], axis=1)

    # -- speculative decoding ----------------------------------------------

    def _check_draft(self, draft):
        if draft.vocab_size != self.vocab_size or \
                draft.batch_size != self.batch_size:
            raise ValueError("draft must share vocab_size/batch_size with "
                             "the target")
        if self._rolling or getattr(draft, "_rolling", False):
            raise ValueError("speculative decoding is not supported with "
                             "rolling caches")
        if self._has_ssm or getattr(draft, "_has_ssm", False):
            raise ValueError(
                "speculative decoding is not supported with ssm blocks: "
                "the recurrent state has no per-position entries to "
                "overwrite, so rejected proposals would corrupt it (use "
                "attention blocks for speculative serving)")

    def generate_speculative(self, draft, prompt, max_new_tokens,
                             lookahead=4, temperature=0.0, top_k=None,
                             top_p=None, seed=0):
        """Speculative decoding: ``draft`` (a smaller Generator over the
        same vocab and batch) proposes ``lookahead`` tokens a round, this
        model verifies them in one forward and keeps the longest agreeing
        prefix plus its own next token. With common random numbers (the
        draft proposes with the same ``sub_j`` the target picks with) the
        output is this model's own ``generate`` continuation, token for
        token. Rejected cache entries are overwritten by the next round's
        writes and never attended. Batch rows advance in lockstep.
        Returns (B, P + max_new_tokens) ids."""
        self._check_draft(draft)
        self._check_sampling(temperature, top_k, top_p)
        prompt, P = self._check_prompt(prompt, max_new_tokens)
        if P + max_new_tokens > draft.max_len:
            raise ValueError("draft max_len=%d too small for %d tokens"
                             % (draft.max_len, P + max_new_tokens))
        gamma = max(1, int(lookahead))
        sampled = bool(temperature and float(temperature) > 0)
        key = _threefry.PRNGKey(int(seed or 0)) if sampled else None

        # invariant: before each round both caches hold a valid prefix
        # over [0, len(out) - 1)
        t_aux = self._fresh_aux()
        d_aux = draft._fresh_aux()
        if P > 1:
            _, t_aux = self._forward(t_aux, prompt[:, :P - 1], 0)
            _, d_aux = draft._forward(d_aux, prompt[:, :P - 1], 0)
        out = prompt.astype(np.int64)
        while out.shape[1] - P < max_new_tokens:
            pos = out.shape[1]
            budget = max_new_tokens - (pos - P)
            g = min(gamma, budget - 1)      # room for the bonus token
            subs, k = [], key
            if sampled:
                for _ in range(g + 1):
                    k, sub = _threefry.split(k)
                    subs.append(sub)
            cur = out[:, -1]
            props = []
            for i in range(g):
                dl, d_aux = draft._forward(d_aux, cur[:, None], pos - 1 + i)
                cur = _pick_token(dl[:, -1], temperature, top_k,
                                  subs[i] if sampled else None,
                                  top_p).cpu().numpy()
                props.append(cur)
            chunk = np.concatenate([out[:, -1:]]
                                   + [p[:, None] for p in props], axis=1)
            tl, t_aux = self._forward(t_aux, chunk, pos - 1)
            picks = np.stack(
                [_pick_token(tl[:, c], temperature, top_k,
                             subs[c] if sampled else None,
                             top_p).cpu().numpy()
                 for c in range(g + 1)], axis=1)          # (B, g+1)
            acc = 0
            while acc < g and bool((props[acc] == picks[:, acc]).all()):
                acc += 1
            out = np.concatenate([out, picks[:, :acc + 1]], axis=1)
            if sampled:
                for _ in range(acc + 1):
                    key, _ = _threefry.split(key)
            if acc == g and g > 0 and out.shape[1] - P < max_new_tokens:
                # full acceptance: the draft has not ingested its last
                # proposal yet
                _, d_aux = draft._forward(d_aux, props[-1][:, None],
                                          pos + g - 1)
        return out[:, :P + max_new_tokens]

    def truncated_draft(self, num_layers=1, batch_size=None, max_len=None):
        """A draft Generator running only the FIRST ``num_layers`` blocks
        of this model, sharing its weights (a shallower decode graph's
        argument names are a subset of the full stack's)."""
        o = self._decode_opts
        if o["quantized"]:
            raise ValueError(
                "truncated_draft is not supported on a quantize='int8' "
                "Generator (its stored weights are already int8; build the "
                "draft from the float checkpoint instead)")
        if self._rolling:
            raise ValueError("truncated_draft is not supported with "
                             "rolling caches (speculative decoding rejects "
                             "rolling models outright)")
        if self._has_ssm:
            raise ValueError(
                "truncated_draft is not supported with ssm blocks "
                "(speculative decoding rejects SSM models outright — the "
                "recurrent state has no rollback)")
        nl = int(num_layers)
        if not 1 <= nl <= self.num_layers:
            raise ValueError("truncated_draft num_layers=%d out of range "
                             "1..%d" % (nl, self.num_layers))
        return Generator(
            self._params, o["vocab_size"],
            int(max_len) if max_len else o["max_len"], num_layers=nl,
            num_heads=o["num_heads"], dim=o["dim"],
            ffn_hidden=o["ffn_hidden"],
            batch_size=int(batch_size) if batch_size else self.batch_size,
            dtype=o["compute_dtype"], num_experts=o["num_experts"],
            pos_encoding=o["pos_encoding"],
            attention_window=o["attention_window"],
            num_kv_heads=o["num_kv_heads"], quantize_kv=o["kv_quantize"],
            ctx=self.ctx)

    def generate_speculative_on_device(self, draft, prompt, max_new_tokens,
                                       lookahead=4, return_rounds=False,
                                       temperature=0.0, top_k=None,
                                       top_p=None, seed=0):
        """generate_speculative with its rounds on the device, the JAX
        package's ``_spec_loop`` (``_SpecLoop``): each round proposes the
        FULL lookahead with the draft, verifies with one target forward and
        emits up to acc + 1 tokens clamped to the budget, on static
        tensors, captured once as a CUDA graph on the card. The host reads
        back whether the budget is spent every few rounds (a round after
        it emits nothing) and the tokens once at the end. Both caches need
        max_len >= P + n + lookahead. Returns the ids, and with
        ``return_rounds`` the rounds that emitted tokens."""
        self._check_draft(draft)
        self._check_sampling(temperature, top_k, top_p)
        prompt, P = self._check_prompt(prompt, max_new_tokens)
        n = int(max_new_tokens)
        if n == 0:
            toks = np.asarray(prompt, np.int64)
            return (toks, 0) if return_rounds else toks
        g = max(1, int(lookahead))
        need = P + n + g
        for which, who in (("target", self), ("draft", draft)):
            if need > who.max_len:
                raise ValueError(
                    "%s max_len=%d too small: on-device speculative needs "
                    "prompt (%d) + max_new_tokens (%d) + lookahead (%d) "
                    "headroom (fixed-shape rounds may overrun the budget "
                    "by up to lookahead)" % (which, who.max_len, P, n, g))
        key_ = ("spec", P, n, g, float(temperature or 0.0),
                int(top_k) if top_k else 0, float(top_p) if top_p else 0.0,
                id(draft))
        loop = self._loop_cache.get(key_)
        if loop is None:        # (the loop holds the draft: id stays valid)
            loop = self._loop_cache[key_] = _SpecLoop(self, draft,
                                                      *key_[1:7])
        toks, rounds = loop.run(prompt, seed)
        return (toks, rounds) if return_rounds else toks

    # -- sampling loops ----------------------------------------------------

    def generate_on_device(self, prompt, max_new_tokens, temperature=0.0,
                           top_k=None, top_p=None, eos_id=None, seed=0):
        """Prefill, then the decode loop on the device: the (B, 1) step is
        captured once as a CUDA graph (on the card) and replayed, with no
        host read inside the loop. Same tokens as generate(). With eos_id
        the loop stops once every row has emitted eos (checked every 16
        steps); the output keeps the static (B, P +
        max_new_tokens) shape with finished rows padded by eos. Each
        (P, max_new_tokens, temperature, top_k, top_p, eos_id) keeps its
        own captured step. Returns (B, P + n) ids."""
        self._check_sampling(temperature, top_k, top_p)
        prompt, P = self._check_prompt(prompt, max_new_tokens)
        n = int(max_new_tokens)
        if n == 0:
            return np.asarray(prompt, np.int64)
        key_ = (P, n, float(temperature or 0.0), int(top_k) if top_k else 0,
                float(top_p) if top_p else 0.0,
                None if eos_id is None else int(eos_id))
        loop = self._loop_cache.get(key_)
        if loop is None:
            loop = self._loop_cache[key_] = _DecodeLoop(self, *key_)
        toks = loop.run(prompt, seed)
        return np.concatenate([prompt.astype(np.int64), toks], axis=1)

    def serving_decoder(self, **kwargs):
        """A continuous-batching decoder over this Generator's decode
        state (``serve.ContinuousDecoder``): a fixed slot pool of width
        batch_size where finished sequences free their slot and queued
        prompts are admitted the following step, the (B, 1) per-row step
        one captured CUDA graph on the card. kwargs go to its
        constructor."""
        from .serve.decode import ContinuousDecoder
        return ContinuousDecoder(self, **kwargs)

    def generate(self, prompt, max_new_tokens, temperature=0.0, top_k=None,
                 top_p=None, eos_id=None, seed=0, on_token=None):
        """Greedy (temperature 0) or sampled continuation, one eager
        forward and one host read a token. prompt: (B, P) ids. Returns
        (B, P + n) ids as numpy (n <= max_new_tokens: generation stops
        early only when every row has emitted eos_id). ``on_token`` gets
        each step's (B,) tokens as soon as they are picked."""
        self._check_sampling(temperature, top_k, top_p)
        prompt, P = self._check_prompt(prompt, max_new_tokens)
        key = _threefry.PRNGKey(seed)
        logits, aux = self._forward(self._fresh_aux(), prompt, 0)
        ids = [prompt.astype(np.int64)]
        done = np.zeros((self.batch_size,), bool)
        last = logits[:, -1]
        for i in range(max_new_tokens):
            key, sub = _threefry.split(key)
            nxt = _pick_token(last, temperature, top_k, sub,
                              top_p).cpu().numpy().astype(np.int64)
            if eos_id is not None:
                nxt = np.where(done, eos_id, nxt)
                done |= nxt == eos_id
            ids.append(nxt[:, None])
            if on_token is not None:
                on_token(nxt.copy())
            if eos_id is not None and done.all():
                break
            if i + 1 < max_new_tokens:
                logits, aux = self._forward(aux, nxt[:, None], P + i)
                last = logits[:, -1]
        return np.concatenate(ids, axis=1)


class _CapturedLoop:
    """A loop body (``_step``) over static device tensors: on the card
    its first run is a warm-up on a side stream, after which it is
    captured once as a CUDA graph and replayed; elsewhere it runs
    directly. A capture that fails raises."""

    # with a stop condition, the host reads it back every this many steps
    check_every = 16

    def __init__(self, device):
        self.device = device
        self.graph = None
        self.capture_ms = None

    def _capture(self):
        """Run one step for real on a side stream (the warm-up), then
        capture the step into one CUDA graph."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = _telemetry.now_ms()
        # on its own stream, thread_local: a serving process captures on
        # its decode thread while other threads (replicas, prefill) keep
        # using the card (torch.cuda.graph's default capture stream is
        # shared by every capture of the process)
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self._step()
        torch.cuda.synchronize(dev)
        self.capture_ms = _telemetry.now_ms() - t0
        self.graph = graph

    def _steps(self, count, stop=None):
        """Up to ``count`` steps: replays of the captured step on the card
        (the first call's first step is the capture's warm-up), the step
        itself elsewhere; ``stop`` (a device bool) ends them early, read
        every ``check_every`` steps."""
        done = 0
        if self.device.type == "cuda" and self.graph is None and count:
            self._capture()
            done = 1
        while done < count:
            if stop is not None and done and \
                    done % self.check_every == 0 and bool(stop()):
                break
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()
            done += 1

    @staticmethod
    def _prefill_into(gen, aux, tokens):
        """Prefill ``tokens`` from position 0 into the static ``aux``
        (zeroed first); returns the logits."""
        for a in aux.values():
            a.zero_()
        logits, out = gen._forward(aux, tokens, 0)
        if any(out[k] is not v for k, v in aux.items()):
            raise RuntimeError("a cache op returned a new tensor: the "
                               "captured step needs its caches in place")
        return logits


def _decode_args(gen, rows, tn):
    """The decode graph's static arguments: the parameters, and zeroed
    (rows, tn) data, (tn,) positions and (1,) cache_pos."""
    args = dict(gen._params)
    dev = gen.device
    args["data"] = torch.zeros((rows, tn), dtype=torch.float32, device=dev)
    args["positions"] = torch.zeros((tn,), dtype=torch.float32, device=dev)
    args["cache_pos"] = torch.zeros((1,), dtype=torch.float32, device=dev)
    return args


def _set_positions(args, start):
    """positions = start + arange(tn), cache_pos = start, from a 0-d
    device int64 ``start``."""
    pos = args["positions"]
    steps = torch.arange(pos.shape[0], device=pos.device)
    pos.copy_((start + steps).to(torch.float32))
    args["cache_pos"].copy_(start.to(torch.float32).reshape(1))


class _DecodeLoop(_CapturedLoop):
    """generate_on_device's loop for one (P, n, temperature, top_k, top_p,
    eos_id): the caches, the last logits, the key, the step counter, the
    done flags and the (B, n) tokens in static device tensors."""

    def __init__(self, gen, P, n, temperature, top_k, top_p, eos_id):
        super().__init__(gen.device)
        dev = gen.device
        B = gen.batch_size
        self.gen, self.P, self.n = gen, P, n
        self.sampling = (temperature, top_k or None, top_p or None)
        self.sampled = temperature > 0
        self.eos = eos_id
        self.aux = gen._fresh_aux()
        self.last = torch.zeros((B, gen.vocab_size), dtype=torch.float32,
                                device=dev)
        self.key = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.out = torch.zeros((B, n), dtype=torch.int64, device=dev)
        self.args = _decode_args(gen, B, 1)

    def _pick(self):
        """Sample column i of ``out`` from ``last`` (one key split when
        sampling); with eos, finished rows keep emitting eos."""
        sub = None
        if self.sampled:
            ks = _threefry.split(self.key)
            self.key.copy_(ks[0])
            sub = ks[1]
        tok = _pick_token(self.last, *self.sampling[:2], sub,
                          self.sampling[2])
        if self.eos is not None:
            tok = torch.where(self.done, self.eos, tok)
            self.done |= tok == self.eos
        self.out.index_copy_(1, self.i.reshape(1), tok[:, None])
        return tok

    def _step(self):
        """One decode step on the static tensors: pick token i, then the
        forward of that token at position P + i."""
        tok = self._pick()
        self.args["data"].copy_(tok[:, None])
        _set_positions(self.args, self.i + self.P)
        logits, _ = self.gen._run(self.args, self.aux)
        self.last.copy_(logits[:, -1])
        self.i += 1

    def run(self, prompt, seed):
        """Tokens (B, n) as numpy: prefill into the static caches, reset
        the buffers, run the steps, one read at the end (and, with eos,
        one every ``check_every`` steps)."""
        logits = self._prefill_into(self.gen, self.aux, prompt)
        self.last.copy_(logits[:, -1])
        self.key.copy_(torch.from_numpy(
            _threefry.PRNGKey(seed).astype(np.int64)))
        self.i.zero_()
        self.done.zero_()
        self.out.fill_(0 if self.eos is None else self.eos)
        with torch.no_grad():
            if self.eos is None:
                # n - 1 forwards; the last token is picked after them
                self._steps(self.n - 1)
                self._pick()
            else:
                self._steps(self.n, stop=self.done.all)
        return self.out.cpu().numpy()


class _BeamLoop(_CapturedLoop):
    """beam_search_on_device's loop for one (P, n, W, eos): the B*W-row
    caches, the last log-probabilities, the float64 scores, the token
    history, the frozen flags and the step counter in static tensors; a
    step selects the W best of W*V candidates a row, reorders the history
    and the caches by the beams' parents and runs the next forward."""

    def __init__(self, gen, P, n, W, eos):
        super().__init__(gen.device)
        dev = gen.device
        B, V = gen.batch_size, gen.vocab_size
        self.gen, self.P, self.n, self.W, self.eos = gen, P, n, W, eos
        self.aux = gen._fresh_aux(rows=B * W)
        self.logp = torch.zeros((B, W, V), dtype=torch.float32, device=dev)
        self.scores = torch.zeros((B, W), dtype=torch.float64, device=dev)
        self.tokens = torch.zeros((B, W, n), dtype=torch.int64, device=dev)
        self.frozen = torch.zeros((B, W), dtype=torch.bool, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        # a frozen beam continues with eos only, at no cost
        self.free = torch.full((V,), -float("inf"), device=dev)
        if eos >= 0:
            self.free[eos] = 0.0
        self.base = torch.arange(B, device=dev)[:, None] * W
        self.args = _decode_args(gen, B * W, 1)

    def _select(self):
        """Column i of the history: the W best candidates a row."""
        B, W, n = self.tokens.shape
        V = self.logp.shape[-1]
        logp = self.logp
        if self.eos >= 0:
            logp = torch.where(self.frozen[:, :, None], self.free, logp)
        flat = (self.scores[:, :, None] + logp.double()).reshape(B, W * V)
        vals, top = torch.sort(flat, dim=1, descending=True, stable=True)
        top = top[:, :W]
        self.scores.copy_(vals[:, :W])
        parent, tok = top // V, top % V
        self.tokens.copy_(torch.gather(self.tokens, 1,
                                       parent[:, :, None].expand(B, W, n)))
        self.tokens.index_copy_(2, self.i.reshape(1), tok[:, :, None])
        if self.eos >= 0:
            self.frozen.copy_(torch.gather(self.frozen, 1, parent)
                              | (tok == self.eos))
        return parent, tok

    def _step(self):
        parent, tok = self._select()
        rows = (self.base + parent).reshape(-1)
        for v in self.aux.values():
            v.copy_(v.index_select(0, rows))
        self.args["data"].copy_(tok.reshape(-1, 1))
        _set_positions(self.args, self.i + self.P)
        logits, _ = self.gen._run(self.args, self.aux)
        self.logp.copy_(_log_softmax_last(logits).reshape(self.logp.shape))
        self.i += 1

    def run(self, prompt):
        """(tokens (B, W, n), scores (B, W)) as numpy: the prefill at
        batch B tiled to the W beams (all but beam 0 at -inf, so step 1
        picks W distinct tokens), n - 1 steps and the last selection."""
        gen, W = self.gen, self.W
        logits, aux = gen._forward(gen._fresh_aux(), prompt, 0)
        for k, v in aux.items():
            self.aux[k].copy_(v.repeat_interleave(W, dim=0))
        self.logp.copy_(_log_softmax_last(logits).repeat_interleave(
            W, dim=0).reshape(self.logp.shape))
        self.scores.fill_(-float("inf"))
        self.scores[:, 0] = 0.0
        self.tokens.zero_()
        self.frozen.zero_()
        self.i.zero_()
        with torch.no_grad():
            self._steps(self.n - 1)
            self._select()
        return self.tokens.cpu().numpy(), self.scores.cpu().numpy()


class _SpecLoop(_CapturedLoop):
    """generate_speculative_on_device's loop for one (P, n, lookahead,
    temperature, top_k, top_p) and draft: both models' caches, the token
    buffer, the key, the emitted count and the round count in static
    tensors; a step is one round (the draft's lookahead proposals, the
    target's verify forward, the acceptance and the emission, clamped to
    the budget: a round after it emits nothing)."""

    check_every = 4

    def __init__(self, target, draft, P, n, g, temperature, top_k, top_p):
        super().__init__(target.device)
        dev = target.device
        B = target.batch_size
        self.target, self.draft = target, draft
        self.P, self.n, self.g = P, n, g
        self.sampling = (temperature, top_k or None, top_p or None)
        self.sampled = temperature > 0
        self.t_aux, self.d_aux = target._fresh_aux(), draft._fresh_aux()
        self.buf = torch.zeros((B, P + n + g + 1), dtype=torch.int64,
                               device=dev)
        self.key = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.emitted = torch.zeros((), dtype=torch.int64, device=dev)
        self.rounds = torch.zeros((), dtype=torch.int64, device=dev)
        self.cols = torch.arange(g + 1, device=dev)
        self.t_args = _decode_args(target, B, g + 1)
        self.d_args = _decode_args(draft, B, 1)

    def _pick(self, logits, sub):
        temperature, top_k, top_p = self.sampling
        return _pick_token(logits, temperature, top_k, sub, top_p)

    def _step(self):
        g = self.g
        pos = self.emitted + self.P
        last = self.buf.index_select(1, (pos - 1).reshape(1))[:, 0]
        subs = [None] * (g + 1)
        if self.sampled:
            # the round's g + 1 subs, peeked: the key advances only by the
            # tokens emitted (keys_after[t]: the key after t emissions)
            ks, subs, k = [self.key], [], self.key
            for _ in range(g + 1):
                k, sub = _threefry.split(k)
                ks.append(k)
                subs.append(sub)
            keys_after = torch.stack(ks)
        cur, props = last, []
        for i in range(g):
            self.d_args["data"].copy_(cur[:, None])
            _set_positions(self.d_args, pos - 1 + i)
            dl, _ = self.draft._run(self.d_args, self.d_aux)
            cur = self._pick(dl[:, -1], subs[i])
            props.append(cur)
        props = torch.stack(props, dim=1)                      # (B, g)
        self.t_args["data"].copy_(torch.cat([last[:, None], props], dim=1))
        _set_positions(self.t_args, pos - 1)
        tl, _ = self.target._run(self.t_args, self.t_aux)
        picks = torch.stack([self._pick(tl[:, c], subs[c])
                             for c in range(g + 1)], dim=1)    # (B, g+1)
        match = (props == picks[:, :g]).all(dim=0)             # (g,)
        acc = torch.cumprod(match.to(torch.int64), dim=0).sum()
        take = torch.minimum(acc + 1, self.n - self.emitted)
        self.buf.index_copy_(1, pos + self.cols, picks)
        if self.sampled:
            self.key.copy_(keys_after.index_select(0, take.reshape(1))[0])
        self.rounds += (take > 0).to(torch.int64)
        self.emitted += take

    def run(self, prompt, seed):
        """(tokens (B, P + n) as numpy, rounds): both models prefill the
        prompt but its last token (each round's feeds start at the last
        emitted token), then rounds until the budget is spent."""
        P = self.P
        if P > 1:
            self._prefill_into(self.target, self.t_aux, prompt[:, :P - 1])
            self._prefill_into(self.draft, self.d_aux, prompt[:, :P - 1])
        else:
            for a in list(self.t_aux.values()) + list(self.d_aux.values()):
                a.zero_()
        self.buf.zero_()
        self.buf[:, :P] = torch.from_numpy(prompt.astype(np.int64))
        self.key.copy_(torch.from_numpy(
            _threefry.PRNGKey(int(seed or 0)).astype(np.int64)))
        self.emitted.zero_()
        self.rounds.zero_()
        with torch.no_grad():
            # a round emits at least one token until the budget is spent
            self._steps(self.n, stop=lambda: self.emitted >= self.n)
        return self.buf[:, :P + self.n].cpu().numpy(), int(self.rounds)


def _best_beam(tokens, scores, length_penalty, eos_id):
    """(B, n) ids of each row's best beam: scores over (generated length,
    up to the first eos) ** length_penalty."""
    B, W, gen_len = tokens.shape
    if length_penalty:
        lens = np.full((B, W), gen_len, np.float64)
        if eos_id is not None:
            is_eos = tokens == eos_id
            has = is_eos.any(axis=2)
            lens[has] = is_eos.argmax(axis=2)[has] + 1
        norm = scores / np.maximum(1.0, lens) ** float(length_penalty)
    else:
        norm = scores
    best = norm.argmax(axis=1)
    return tokens[np.arange(B), best].astype(np.int64)


def _quantize_weights(arg_params, decode_args):
    """Weight-only int8: for each quantized layer of the decode graph
    (marked by its "<name>_scale" argument) the float "<name>_weight"
    becomes per-output-channel symmetric int8 plus a float32 scale; other
    parameters pass through."""
    out = dict(arg_params)
    for arg in decode_args:
        if not arg.endswith("_scale"):
            continue
        wname = arg[:-len("_scale")] + "_weight"
        if wname not in out:
            continue
        w = out[wname]
        w = getattr(w, "_data", w)
        w = w.detach().float().cpu().numpy() if isinstance(
            w, torch.Tensor) else np.asarray(w, np.float32)
        scale = np.maximum(np.abs(w).max(axis=1), 1e-12) / 127.0
        out[wname] = np.clip(np.rint(w / scale[:, None]),
                             -127, 127).astype(np.int8)
        out[arg] = scale.astype(np.float32)
    return out


def replay_key(seed, picks):
    """The PRNG key after ``picks`` tokens have been drawn from the stream
    seeded by ``seed``: ``PRNGKey(seed)`` then one split a token."""
    key = _threefry.PRNGKey(int(seed or 0))
    for _ in range(int(picks)):
        key, _ = _threefry.split(key)
    return key


def _pick_token(logits, temperature, top_k, key, top_p=None):
    """logits (B, V) -> (B,) int64 token ids on the logits' device:
    argmax at temperature <= 0 (the first index at a tie), else a
    categorical draw with ``key`` from the tempered logits, cut to the
    top_k largest and to the top_p nucleus (the smallest prefix of the
    sorted probabilities whose mass reaches top_p, the first token past
    it included)."""
    logits = logits.float()
    if not (temperature and float(temperature) > 0):
        return torch.argmax(logits, dim=-1)
    dev = logits.device
    # a device scalar: a true division (CUDA multiplies by the reciprocal
    # of a host scalar)
    logits = logits / torch.full((), float(temperature),
                                 dtype=torch.float32, device=dev)
    neg_inf = torch.full((), -float("inf"), device=dev)
    if top_k:
        kth = torch.topk(logits, int(top_k), dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p and float(top_p) < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        mass = torch.cumsum(probs, dim=-1)
        keep = mass - probs < float(top_p)
        cut = torch.where(keep, srt, -neg_inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cut, neg_inf, logits)
    return _threefry.categorical(key, logits, axis=-1)
