"""Decoder-only transformer language model — the PyTorch twin of
``mxnet_tpu/models/transformer.py``'s ``get_symbol`` and
``get_decode_symbol``.

Same graphs, same parameter names and packing (``_qkv_heads``' [q | k | v]
and ``_ssm_qkvg``'s [q | k | v | gate] layouts along the projection's
output dim), so a checkpoint of either package binds in the other, and a
training checkpoint binds the decode graph. Training attention runs
through ``_contrib_FlashAttention`` over the hand-written Hopper flash
kernels; the options are ported: learned or rotary positions
(``pos_encoding="rope"``), GQA, a sliding window, SSM layers
(``block_type``, uniform or per layer), Dropout, the chunked-CE head
(``loss_chunk``), the Switch MoE FFN (``num_experts``, with
``expert_axis`` for expert parallelism) and ring attention over a mesh
axis (``seq_axis``). The decode twin (``get_decode_symbol``) threads KV
caches (plain, rolling, int8) and SSM states as aux and takes the
weight-only int8 layers and the MoE FFN; ``generation.Generator`` drives
it. ``get_stage_symbol`` is one block, the stage of
``parallel.pipeline_from_symbol``.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol", "get_decode_symbol", "get_stage_symbol"]


def _fc(x, num_hidden, name, quantized=False):
    """FullyConnected or its weight-only-int8 twin: the same
    "<name>_weight" binding, plus "<name>_scale" (per output channel) when
    quantized. Decode only; training uses the float op."""
    if quantized:
        return sym.contrib.QuantizedFullyConnected(
            x, num_hidden=num_hidden, flatten=False, name=name)
    return sym.FullyConnected(x, num_hidden=num_hidden, flatten=False,
                              name=name)


def _qkv_heads(x, num_heads, dim, prefix, quantized=False,
               num_kv_heads=None):
    """Shared qkv projection + head split: (B, T, C) -> q (B, H, T, hd)
    and k/v (B, Hkv, T, hd), packed [q | k | v] along the output dim. The
    training and decode attention blocks both use it, so their packing
    cannot drift."""
    Hkv = int(num_kv_heads or num_heads)
    head_dim = dim // num_heads
    kv_dim = Hkv * head_dim
    qkv = _fc(x, dim + 2 * kv_dim, prefix + "qkv", quantized)

    def cut(begin, end, heads):
        part = sym.slice_axis(qkv, axis=2, begin=begin, end=end)
        part = sym.reshape(part, shape=(0, 0, heads, head_dim))
        return sym.transpose(part, axes=(0, 2, 1, 3))  # (B, H, T, hd)

    return (cut(0, dim, num_heads),
            cut(dim, dim + kv_dim, Hkv),
            cut(dim + kv_dim, dim + 2 * kv_dim, Hkv))


def _merge_heads_proj(att, dim, prefix, quantized=False):
    """(B, H, T, hd) attention output -> (B, T, C) through the shared
    output projection."""
    att = sym.transpose(att, axes=(0, 2, 1, 3))       # (B, T, H, hd)
    att = sym.reshape(att, shape=(0, 0, -3))          # (B, T, C)
    return _fc(att, dim, prefix + "proj", quantized)


def _attention_block(x, num_heads, dim, prefix, seq_axis=None,
                     rope_positions=None, window=0, num_kv_heads=None):
    """x: (B, T, C) -> (B, T, C); causal flash attention (ring attention
    over ``seq_axis`` when the graph runs on a mesh carrying that axis).
    rope_positions: a (T,) position-id symbol — q and k rotate (RoPE)
    when given."""
    q, k, v = _qkv_heads(x, num_heads, dim, prefix,
                         num_kv_heads=num_kv_heads)
    if rope_positions is not None:
        q = sym.contrib.RoPE(q, rope_positions)
        k = sym.contrib.RoPE(k, rope_positions)
    att = sym.contrib.FlashAttention(q, k, v, causal=True,
                                     seq_axis=seq_axis, window=window,
                                     name=prefix + "attn")
    return _merge_heads_proj(att, dim, prefix)


def _ssm_qkvg(x, num_heads, dim, prefix, quantized=False):
    """Fused q/k/v/gate projection of the SSM block: (B, T, C) -> q/k/v
    (B, H, T, hd) plus a per-head per-token decay-gate logit (B, H, T).
    One FullyConnected of width 3*dim + num_heads named "<prefix>qkvg",
    shared by the training and decode forms."""
    head_dim = dim // num_heads
    qkvg = _fc(x, 3 * dim + num_heads, prefix + "qkvg", quantized)

    def cut(begin, end):
        part = sym.slice_axis(qkvg, axis=2, begin=begin, end=end)
        part = sym.reshape(part, shape=(0, 0, num_heads, head_dim))
        return sym.transpose(part, axes=(0, 2, 1, 3))  # (B, H, T, hd)

    gate = sym.slice_axis(qkvg, axis=2, begin=3 * dim,
                          end=3 * dim + num_heads)      # (B, T, H)
    gate = sym.transpose(gate, axes=(0, 2, 1))          # (B, H, T)
    return (cut(0, dim), cut(dim, 2 * dim), cut(2 * dim, 3 * dim),
            gate)


def _ssm_block(x, num_heads, dim, prefix):
    """x: (B, T, C) -> (B, T, C); gated linear-attention (SSM) block in
    its chunked-scan training form (ops/ssm.py). No positions enter: the
    recurrence is ordered by construction."""
    q, k, v, g = _ssm_qkvg(x, num_heads, dim, prefix)
    out = sym.contrib.SSMScan(q, k, v, g, name=prefix + "ssm")
    return _merge_heads_proj(out, dim, prefix)


def _ffn_block(x, dim, hidden, prefix, quantized=False):
    h = _fc(x, hidden, prefix + "fc1", quantized)
    h = sym.Activation(h, act_type="relu")
    return _fc(h, dim, prefix + "fc2", quantized)


def _moe_block(x, dim, hidden, num_experts, prefix, expert_axis=None,
               capacity_factor=1.25):
    """Switch-style MoE FFN (the residual around it lives in the layer
    loop, so capacity-dropped tokens pass through unchanged).

    The 3D expert weights carry explicit per-expert Xavier bounds:
    suffix-dispatched Xavier would read (E, D, H) as a conv kernel and
    scale by the D*H "receptive field" — ~sqrt(hidden) too small."""
    from .. import initializer as init_mod

    def xavier(fan_in, fan_out):
        return init_mod.Uniform(scale=(6.0 / (fan_in + fan_out)) ** 0.5)

    gate = sym.Variable(prefix + "gate_weight", shape=(dim, num_experts))
    w1 = sym.Variable(prefix + "experts_w1_weight",
                      shape=(num_experts, dim, hidden),
                      init=xavier(dim, hidden))
    w2 = sym.Variable(prefix + "experts_w2_weight",
                      shape=(num_experts, hidden, dim),
                      init=xavier(hidden, dim))
    return sym.contrib.MoEFFN(x, gate, w1, w2, expert_axis=expert_axis,
                              capacity_factor=capacity_factor,
                              name=prefix + "moe")


def _check_kv_heads(num_heads, num_kv_heads):
    if num_kv_heads and num_heads % int(num_kv_heads):
        raise ValueError(
            "num_heads (%d) must be a multiple of num_kv_heads (%d) "
            "for grouped-query attention" % (num_heads, num_kv_heads))


def _canon_block_types(block_type, num_layers):
    """block_type as a per-layer tuple: "attention" | "ssm" for a uniform
    stack, or a sequence naming each layer's kind."""
    if isinstance(block_type, str):
        kinds = (block_type,) * num_layers
    else:
        kinds = tuple(block_type)
        if len(kinds) != num_layers:
            raise ValueError(
                "block_type sequence names each layer: got %d entries "
                "for num_layers=%d" % (len(kinds), num_layers))
    for b in kinds:
        if b not in ("attention", "ssm"):
            raise ValueError("block_type entries must be 'attention' or "
                             "'ssm', got %r" % (b,))
    return kinds


def _check_pos_encoding(pos_encoding, dim, num_heads):
    if pos_encoding not in ("learned", "rope"):
        raise ValueError("pos_encoding must be 'learned' or 'rope', "
                         "got %r" % (pos_encoding,))
    if pos_encoding == "rope" and (dim // num_heads) % 2:
        raise ValueError("pos_encoding='rope' needs an even head_dim, "
                         "got %d" % (dim // num_heads))


def _layer_block(x, num_heads, dim, ffn_hidden, prefix, seq_axis=None,
                 num_experts=0, expert_axis=None, dropout=0.0,
                 moe_capacity_factor=1.25, rope_positions=None, window=0,
                 num_kv_heads=None, block_type="attention"):
    """One pre-LN transformer block: the mixing residual (attention or
    SSM, by block_type) + the FFN or MoE residual (its output through
    Dropout when dropout > 0). Shared by get_symbol's layer loop and
    get_stage_symbol, so the two cannot drift."""
    a = sym.LayerNorm(x, name=prefix + "ln1")
    if block_type == "ssm":
        x = x + _ssm_block(a, num_heads, dim, prefix)
    else:
        x = x + _attention_block(a, num_heads, dim, prefix,
                                 seq_axis=seq_axis,
                                 rope_positions=rope_positions,
                                 window=window, num_kv_heads=num_kv_heads)
    f = sym.LayerNorm(x, name=prefix + "ln2")
    ff = _moe_block(f, dim, ffn_hidden, num_experts, prefix,
                    expert_axis=expert_axis,
                    capacity_factor=moe_capacity_factor) \
        if num_experts else _ffn_block(f, dim, ffn_hidden, prefix)
    if dropout > 0:
        ff = sym.Dropout(ff, p=dropout)
    out = x + ff
    if seq_axis:
        # the JAX package's lenient sharding hint on the residual stream;
        # this port's mesh keeps activations replicated and reads it
        # nowhere, but the symbol JSON stays the JAX package's
        out._set_attr(__shard_hint__="None,%s,None" % seq_axis)
    return out


def get_stage_symbol(num_heads=4, dim=128, ffn_hidden=None,
                     seq_axis=None, pos_encoding="learned",
                     seq_len=None, attention_window=0):
    """One transformer block as a standalone symbol: data (mb, T, C) ->
    (mb, T, C). The pipeline-parallel stage for
    ``parallel.pipeline_from_symbol``: stack L layers' params on a
    leading stage dim and stream microbatches through a ``pipe`` mesh
    axis. Pre-LN and aux-free by construction, as the GPipe schedule
    requires.

    pos_encoding: "learned" means position information enters before
    stage 0, so the stage itself is position-free; "rope" rotates inside
    every attention layer, so a rope stage needs ``seq_len``."""
    ffn_hidden = ffn_hidden or 4 * dim
    if dim % num_heads:
        raise ValueError("dim (%d) must be divisible by num_heads (%d)"
                         % (dim, num_heads))
    _check_pos_encoding(pos_encoding, dim, num_heads)
    rope_positions = None
    if pos_encoding == "rope":
        if not seq_len:
            raise ValueError("pos_encoding='rope' stages need seq_len "
                             "(RoPE applies inside each layer)")
        rope_positions = sym.arange(start=0, stop=seq_len)
    return _layer_block(sym.Variable("data"), num_heads, dim,
                        ffn_hidden, "", seq_axis=seq_axis,
                        rope_positions=rope_positions,
                        window=attention_window)


def _decode_attention_block(x, num_heads, dim, prefix, max_len, pos,
                            quantized=False, rope_positions=None,
                            window=0, rolling=False, num_kv_heads=None,
                            kv_quantize=False):
    """Incremental twin of _attention_block over the same qkv/proj
    helpers, through _contrib_CachedAttention (k/v cache aux states
    "<prefix>attn_k_cache"/"_v_cache"), its rolling form, or its int8
    form (plus "_k_scale"/"_v_scale"). Keys rotate BEFORE they are
    cached, so a step rotates only the new tokens."""
    q, k, v = _qkv_heads(x, num_heads, dim, prefix, quantized,
                         num_kv_heads=num_kv_heads)
    if rope_positions is not None:
        q = sym.contrib.RoPE(q, rope_positions)
        k = sym.contrib.RoPE(k, rope_positions)
    if rolling:
        att = sym.contrib.RollingCachedAttention(
            q, k, v, pos=pos, max_len=max_len, window=window,
            name=prefix + "attn")
    elif kv_quantize:
        att = sym.contrib.CachedAttentionQ8(
            q, k, v, pos=pos, max_len=max_len, window=window,
            name=prefix + "attn")
    else:
        att = sym.contrib.CachedAttention(q, k, v, pos=pos,
                                          max_len=max_len, window=window,
                                          name=prefix + "attn")
    return _merge_heads_proj(att, dim, prefix, quantized)


def _decode_ssm_block(x, num_heads, dim, prefix, max_len, pos,
                      quantized=False):
    """Incremental twin of _ssm_block over the same qkvg/proj helpers,
    through _contrib_SSMCached with one (B, H, hd, hd) float32 state aux
    ("<prefix>ssm_state"); the op ignores pos."""
    q, k, v, g = _ssm_qkvg(x, num_heads, dim, prefix, quantized)
    out = sym.contrib.SSMCached(q, k, v, g, pos=pos, max_len=max_len,
                                name=prefix + "ssm")
    return _merge_heads_proj(out, dim, prefix, quantized)


def get_decode_symbol(vocab_size, max_len, num_layers=2, num_heads=4,
                      dim=128, ffn_hidden=None, num_experts=0,
                      quantized=False, compute_dtype=None,
                      pos_encoding="learned", attention_window=0,
                      rolling_cache=False, num_kv_heads=None,
                      kv_quantize=False, per_row_pos=False,
                      block_type="attention"):
    """Autoregressive-decode twin of get_symbol.

    Inputs: data (B, Tnew) token ids being appended (the prompt at
    prefill, one a step after), positions (Tnew,) absolute ids, cache_pos
    (1,) tokens already cached. Output: logits (B, Tnew, vocab). The KV
    caches are aux states (B, Hkv, max_len, head_dim). per_row_pos=True
    is the continuous-batching variant: positions (B, Tnew), cache_pos
    (B,). block_type as in get_symbol: SSM layers hold one (B, H, hd, hd)
    float32 state aux ("layerN_ssm_state") instead of KV rows.

    Knob composition, as in the JAX package: rolling_cache needs
    attention_window and refuses kv_quantize, per_row_pos and SSM layers;
    kv_quantize and attention_window need an attention layer;
    quantized=True swaps in the weight-only int8 layers. num_experts > 0
    swaps each FFN for the MoE FFN with capacity_factor = num_experts, so
    that a decode step drops no token (the expert weights stay float)."""
    if dim % num_heads:
        raise ValueError("dim (%d) must be divisible by num_heads (%d)"
                         % (dim, num_heads))
    ffn_hidden = ffn_hidden or 4 * dim
    _check_kv_heads(num_heads, num_kv_heads)
    btypes = _canon_block_types(block_type, num_layers)
    has_ssm = "ssm" in btypes
    has_attn = "attention" in btypes
    if rolling_cache and not attention_window:
        raise ValueError("rolling_cache needs attention_window > 0 "
                         "(the circular capacity covers one window)")
    if kv_quantize and rolling_cache:
        raise ValueError("kv_quantize is not supported with rolling_cache "
                         "(no int8 variant of the circular-buffer op)")
    if per_row_pos and rolling_cache:
        raise ValueError("per_row_pos is not supported with rolling_cache "
                         "(the circular-buffer op has no per-row-position "
                         "variant)")
    if rolling_cache and has_ssm:
        raise ValueError(
            "rolling_cache is not supported with ssm blocks: the SSM state "
            "is already O(1) in sequence length — there is no KV window "
            "to roll (use block_type='attention' for rolling caches, or "
            "drop rolling_cache)")
    if kv_quantize and not has_attn:
        raise ValueError(
            "kv_quantize needs at least one attention layer: a pure-SSM "
            "stack has no KV cache to quantize (its (H, hd, hd) f32 state "
            "is already O(1); mixed attention/ssm stacks compose — the "
            "attention layers quantize)")
    if attention_window and not has_attn:
        raise ValueError(
            "attention_window needs at least one attention layer: SSM "
            "layers have no attention window (their state decays "
            "continuously; mixed stacks compose — the window applies to "
            "the attention layers)")
    data = sym.Variable("data")
    positions = sym.Variable("positions")
    cache_pos = sym.Variable("cache_pos") if per_row_pos \
        else sym.Variable("cache_pos", shape=(1,))

    if quantized:
        x = sym.contrib.QuantizedEmbedding(
            data, input_dim=vocab_size, output_dim=dim,
            dtype=compute_dtype or "float32", name="tok_embed")
    else:
        x = sym.Embedding(data, input_dim=vocab_size, output_dim=dim,
                          name="tok_embed")
    rope_positions = None
    if pos_encoding == "rope":
        rope_positions = positions
    elif pos_encoding == "learned":
        pos_table = sym.Variable("pos_embed_weight", shape=(max_len, dim))
        if per_row_pos:
            x = sym.broadcast_add(x, sym.take(pos_table, positions))
        else:
            pos_vec = sym.take(pos_table, positions)  # (Tnew, dim)
            x = sym.broadcast_add(x, sym.expand_dims(pos_vec, axis=0))
    else:
        raise ValueError("pos_encoding must be 'learned' or 'rope', "
                         "got %r" % (pos_encoding,))

    for i in range(num_layers):
        prefix = "layer%d_" % i
        a = sym.LayerNorm(x, name=prefix + "ln1")
        if btypes[i] == "ssm":
            x = x + _decode_ssm_block(a, num_heads, dim, prefix, max_len,
                                      cache_pos, quantized=quantized)
        else:
            x = x + _decode_attention_block(
                a, num_heads, dim, prefix, max_len, cache_pos,
                num_kv_heads=num_kv_heads, quantized=quantized,
                rope_positions=rope_positions, window=attention_window,
                rolling=rolling_cache, kv_quantize=kv_quantize)
        f = sym.LayerNorm(x, name=prefix + "ln2")
        # inference never capacity-drops: the factor is E, so the
        # capacity is the token count
        ff = _moe_block(f, dim, ffn_hidden, num_experts, prefix,
                        capacity_factor=num_experts) \
            if num_experts else _ffn_block(f, dim, ffn_hidden, prefix,
                                           quantized=quantized)
        x = x + ff

    x = sym.LayerNorm(x, name="ln_f")
    return _fc(x, vocab_size, "lm_head", quantized)


def get_symbol(vocab_size, seq_len, num_layers=2, num_heads=4, dim=128,
               ffn_hidden=None, dropout=0.0, max_len=None,
               num_experts=0, seq_axis=None, expert_axis=None,
               moe_capacity_factor=1.25, pos_encoding="learned",
               attention_window=0, num_kv_heads=None, loss_chunk=0,
               block_type="attention"):
    """GPT-style causal LM symbol.

    data: (B, T) token ids; softmax_label: (B, T) next-token targets
    (ignore index -1). Output: softmax over vocab per position, shaped
    (B*T, vocab) — or, with loss_chunk > 0, the per-token loss (B, T) in
    SoftmaxOutput's gradient scaling from the fused chunked-CE head
    (``_contrib_ChunkedSoftmaxCE``; the same parameter names, so
    checkpoints interchange, and the same parameter gradients).

    max_len: position-table capacity (>= seq_len); the graph slices the
    first seq_len rows. pos_encoding: "learned" (the table) or "rope"
    (q/k rotate in every attention layer; no position parameters).
    attention_window: sliding-window width of every attention layer (0 =
    full causal). num_kv_heads < num_heads is grouped-query attention.
    block_type: "attention", "ssm", or a per-layer sequence.

    num_experts > 0 swaps each FFN for the Switch top-1 MoE FFN
    (``_contrib_MoEFFN``, capacity factor ``moe_capacity_factor``);
    expert_axis names a mesh axis over which the experts split (tokens
    exchange through all_to_all). seq_axis names a mesh axis for ring
    attention in every attention layer (refused with SSM layers, whose
    scan is sequential over the sequence). Both are inert without a mesh
    carrying the axis."""
    ffn_hidden = ffn_hidden or 4 * dim
    max_len = max_len or seq_len
    if max_len < seq_len:
        raise ValueError("max_len (%d) must be >= seq_len (%d)"
                         % (max_len, seq_len))
    if dim % num_heads:
        raise ValueError("dim (%d) must be divisible by num_heads (%d)"
                         % (dim, num_heads))
    _check_kv_heads(num_heads, num_kv_heads)
    _check_pos_encoding(pos_encoding, dim, num_heads)
    btypes = _canon_block_types(block_type, num_layers)
    if seq_axis and "ssm" in btypes:
        raise ValueError(
            "seq_axis (ring sequence parallelism) is not supported with "
            "ssm blocks — the chunked scan is sequential over the "
            "sequence; shard batch/tensor axes instead")
    if attention_window and "attention" not in btypes:
        raise ValueError("attention_window needs at least one attention "
                         "layer (SSM layers have no attention window)")
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")

    x = sym.Embedding(data, input_dim=vocab_size, output_dim=dim,
                      name="tok_embed")
    rope_positions = None
    if pos_encoding == "rope":
        rope_positions = sym.arange(start=0, stop=seq_len)
    else:
        pos_table = sym.Variable("pos_embed_weight", shape=(max_len, dim))
        pos = sym.slice_axis(pos_table, axis=0, begin=0, end=seq_len)
        x = sym.broadcast_add(x, sym.expand_dims(pos, axis=0))

    for i in range(num_layers):
        x = _layer_block(x, num_heads, dim, ffn_hidden, "layer%d_" % i,
                         seq_axis=seq_axis, num_experts=num_experts,
                         expert_axis=expert_axis, dropout=dropout,
                         moe_capacity_factor=moe_capacity_factor,
                         rope_positions=rope_positions,
                         window=attention_window,
                         num_kv_heads=num_kv_heads, block_type=btypes[i])

    x = sym.LayerNorm(x, name="ln_f")
    if loss_chunk:
        # the fused head never holds the (B*T, V) logits; output: the
        # per-token loss (B, T)
        w_head = sym.Variable("lm_head_weight", shape=(vocab_size, dim))
        b_head = sym.Variable("lm_head_bias", shape=(vocab_size,))
        x2 = sym.reshape(x, shape=(-3, -2))           # (B*T, D)
        label_r = sym.reshape(label, shape=(-1,))
        loss = sym._contrib_ChunkedSoftmaxCE(
            x2, w_head, b_head, label_r, chunk=int(loss_chunk),
            use_ignore=True, ignore_label=-1.0, normalization="valid",
            name="softmax")
        return sym.reshape(loss, shape=(-1, seq_len))
    logits = sym.FullyConnected(x, num_hidden=vocab_size, flatten=False,
                                name="lm_head")
    logits = sym.reshape(logits, shape=(-3, -2))      # (B*T, V)
    label_r = sym.reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(logits, label_r, use_ignore=True,
                             ignore_label=-1.0, normalization="valid",
                             name="softmax")
