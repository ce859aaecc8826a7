"""Decoder-only transformer language model — the PyTorch twin of
``mxnet_tpu/models/transformer.py``'s ``get_symbol``.

Same graph, same parameter names and packing (``_qkv_heads``' [q | k | v]
layout along the projection's output dim), so a checkpoint of either
package binds in the other. Attention runs through
``_contrib_FlashAttention`` over the hand-written Hopper flash kernel.

Options whose ops are not ported yet raise ``NotImplementedError`` naming
the ROADMAP item that brings them, instead of building another graph.
The decode twin (``get_decode_symbol``) and the pipeline stage
(``get_stage_symbol``) come with generation (Queue A item 7) and the
parallel axes (Queue A item 9).
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol"]


def _fc(x, num_hidden, name):
    return sym.FullyConnected(x, num_hidden=num_hidden, flatten=False,
                              name=name)


def _qkv_heads(x, num_heads, dim, prefix, num_kv_heads=None):
    """Shared qkv projection + head split: (B, T, C) -> q (B, H, T, hd)
    and k/v (B, Hkv, T, hd), packed [q | k | v] along the output dim."""
    Hkv = int(num_kv_heads or num_heads)
    head_dim = dim // num_heads
    kv_dim = Hkv * head_dim
    qkv = _fc(x, dim + 2 * kv_dim, prefix + "qkv")

    def cut(begin, end, heads):
        part = sym.slice_axis(qkv, axis=2, begin=begin, end=end)
        part = sym.reshape(part, shape=(0, 0, heads, head_dim))
        return sym.transpose(part, axes=(0, 2, 1, 3))  # (B, H, T, hd)

    return (cut(0, dim, num_heads),
            cut(dim, dim + kv_dim, Hkv),
            cut(dim + kv_dim, dim + 2 * kv_dim, Hkv))


def _merge_heads_proj(att, dim, prefix):
    """(B, H, T, hd) attention output -> (B, T, C) through the shared
    output projection."""
    att = sym.transpose(att, axes=(0, 2, 1, 3))       # (B, T, H, hd)
    att = sym.reshape(att, shape=(0, 0, -3))          # (B, T, C)
    return _fc(att, dim, prefix + "proj")


def _attention_block(x, num_heads, dim, prefix, window=0,
                     num_kv_heads=None):
    """x: (B, T, C) -> (B, T, C); causal flash attention."""
    q, k, v = _qkv_heads(x, num_heads, dim, prefix,
                         num_kv_heads=num_kv_heads)
    att = sym.contrib.FlashAttention(q, k, v, causal=True, seq_axis=None,
                                     window=window, name=prefix + "attn")
    return _merge_heads_proj(att, dim, prefix)


def _ffn_block(x, dim, hidden, prefix):
    h = _fc(x, hidden, prefix + "fc1")
    h = sym.Activation(h, act_type="relu")
    return _fc(h, dim, prefix + "fc2")


def _layer_block(x, num_heads, dim, ffn_hidden, prefix, window=0,
                 num_kv_heads=None, dropout=0.0):
    """One pre-LN transformer block: attention residual + FFN residual
    (the FFN's output through Dropout when dropout > 0)."""
    a = sym.LayerNorm(x, name=prefix + "ln1")
    x = x + _attention_block(a, num_heads, dim, prefix, window=window,
                             num_kv_heads=num_kv_heads)
    f = sym.LayerNorm(x, name=prefix + "ln2")
    ff = _ffn_block(f, dim, ffn_hidden, prefix)
    if dropout > 0:
        ff = sym.Dropout(ff, p=dropout)
    return x + ff


def _not_ported(option, item):
    raise NotImplementedError(
        "transformer.get_symbol(%s) needs ops not ported to the PyTorch "
        "package yet (ROADMAP %s)" % (option, item))


def get_symbol(vocab_size, seq_len, num_layers=2, num_heads=4, dim=128,
               ffn_hidden=None, dropout=0.0, max_len=None,
               num_experts=0, seq_axis=None, expert_axis=None,
               moe_capacity_factor=1.25, pos_encoding="learned",
               attention_window=0, num_kv_heads=None, loss_chunk=0,
               block_type="attention"):
    """GPT-style causal LM symbol.

    data: (B, T) token ids; softmax_label: (B, T) next-token targets
    (ignore index -1). Output: softmax over vocab per position, shaped
    (B*T, vocab).

    max_len: position-table capacity (>= seq_len); the graph slices the
    first seq_len rows. attention_window: sliding-window width of every
    attention layer (0 = full causal). num_kv_heads < num_heads is
    grouped-query attention."""
    if block_type != "attention":
        _not_ported("block_type=%r" % (block_type,),
                    "Queue A item 6, the SSM scan")
    if num_experts:
        _not_ported("num_experts=%r" % (num_experts,),
                    "Queue A item 9, the MoE FFN")
    if pos_encoding != "learned":
        _not_ported("pos_encoding=%r" % (pos_encoding,),
                    "Queue A item 6, RoPE")
    if loss_chunk:
        _not_ported("loss_chunk=%r" % (loss_chunk,),
                    "Queue A item 6, the chunked CE head")
    if seq_axis:
        _not_ported("seq_axis=%r" % (seq_axis,),
                    "Queue A item 9, ring attention")
    ffn_hidden = ffn_hidden or 4 * dim
    max_len = max_len or seq_len
    if max_len < seq_len:
        raise ValueError("max_len (%d) must be >= seq_len (%d)"
                         % (max_len, seq_len))
    if dim % num_heads:
        raise ValueError("dim (%d) must be divisible by num_heads (%d)"
                         % (dim, num_heads))
    if num_kv_heads and num_heads % int(num_kv_heads):
        raise ValueError(
            "num_heads (%d) must be a multiple of num_kv_heads (%d) "
            "for grouped-query attention" % (num_heads, num_kv_heads))
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")

    x = sym.Embedding(data, input_dim=vocab_size, output_dim=dim,
                      name="tok_embed")
    pos_table = sym.Variable("pos_embed_weight", shape=(max_len, dim))
    pos = sym.slice_axis(pos_table, axis=0, begin=0, end=seq_len)
    x = sym.broadcast_add(x, sym.expand_dims(pos, axis=0))

    for i in range(num_layers):
        x = _layer_block(x, num_heads, dim, ffn_hidden, "layer%d_" % i,
                         window=attention_window,
                         num_kv_heads=num_kv_heads, dropout=dropout)

    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(x, num_hidden=vocab_size, flatten=False,
                                name="lm_head")
    logits = sym.reshape(logits, shape=(-3, -2))      # (B*T, V)
    label_r = sym.reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(logits, label_r, use_ignore=True,
                             ignore_label=-1.0, normalization="valid",
                             name="softmax")
