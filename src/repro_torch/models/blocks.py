"""Per-layer blocks: init, full-sequence apply, prefill and decode.

Port of the six kinds of the JAX package's ``models/blocks.py``; each but
``"enc"`` has its full-sequence apply, its prefill and its decode:
  * ``"attn"``  — global causal attention;
  * ``"local"`` — sliding-window causal attention, its decode cache a ring
    buffer of the last ``min(window, cache_len)`` tokens (recurrentgemma);
  * ``"rglru"`` — the Griffin recurrent block (conv1d + RG-LRU), its
    decode state ``{"h", "conv"}`` in f32;
  * ``"rwkv"``  — RWKV6 time-mix + channel-mix, its decode state the WKV
    state ``"s"`` [B, H, dh, dh] in f32 and the two token shifts
    ``"shift_t"`` / ``"shift_c"`` [B, D] at the cache dtype;
  * ``"xattn"`` — whisper's decoder layer: causal self-attention with
    RoPE, then ``lnx`` and cross-attention over the encoder memory
    ``enc_out`` [B, Se, D] (non-causal, no RoPE, no bias: the reference
    draws ``cross.qb/kb/vb/ob`` and never adds them); its decode state
    the self K/V cache and the cross K/V ``"ck"`` / ``"cv"``
    [B, Se, kv, hd], filled at prefill (or by ``LM.fill_cross_kv``);
  * ``"enc"``   — whisper's encoder layer: non-causal self-attention
    without RoPE (full sequence only: the encoder is never decoded).
The second half of an ``"attn"`` or ``"local"`` block of an MoE config is
the mixture of experts (``models/moe.py``), of the others a dense MLP.

Parameters keep the reference's layout (``x @ W`` with ``W`` shaped
``[d_in, d_out]``, norm weights in f32) so that ``bridge.py`` is a plain
copy.  Every use casts a matmul weight to the compute dtype, as the
reference does.

Decode state is updated IN PLACE: the K/V cache tensors a block is given
are written at ``position`` (or its ring slot), the recurrent states are
overwritten (the reference returns new buffers; the port saves the copy
of the whole cache per token).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (activation, apply_norm, apply_rope,
                                       chunked_attention, decode_attention,
                                       dense_init, init_norm)
from repro_torch.models.config import LMConfig
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.recurrent import (apply_recurrent,
                                          apply_recurrent_decode,
                                          init_recurrent,
                                          init_recurrent_state)
from repro_torch.models.rwkv import (apply_rwkv_channel, apply_rwkv_time,
                                     init_rwkv_channel, init_rwkv_time)
from repro_torch.utils.trees import tree_map

# kinds with a decode state (prefill and decode)
SERVE_KINDS = ("attn", "local", "rglru", "rwkv", "xattn")
# every ported kind: the serving kinds and the encoder's full-sequence one
BLOCK_KINDS = SERVE_KINDS + ("enc",)


def _require(kind: str, kinds=BLOCK_KINDS):
    if kind not in kinds:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (have {kinds})")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _stacked(fn, layers):
    """``fn()`` once, or ``layers`` draws (tensors or trees) stacked on a
    leading axis.

    Each ``[layers, ...]`` leaf is allocated once, from the first draw's
    shape and dtype, and layer ``i``'s draw is copied into slot ``i`` and
    dropped: the peak is the stack plus one layer's draw (qwen3-moe's
    experts: 58 GB stacked, 1.2 GB a layer), where stacking a list of
    draws held both whole.  The generator sees the calls of
    ``torch.stack([fn() for _ in range(layers)])`` in the same order,
    so the values are the same bits."""
    if layers is None:
        return fn()
    first = fn()
    out = tree_map(lambda t: t.new_empty((layers,) + tuple(t.shape)), first)
    tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, layers):
        tree_map(lambda o, t, i=i: o[i].copy_(t), out, fn())
    return out


def _zeros(n, layers, device):
    shape = (n,) if layers is None else (layers, n)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def init_block(generator: torch.Generator, cfg: LMConfig, kind: str, *,
               device, weight_dtype=torch.float32, layers: int | None = None):
    """One layer's parameters, or ``layers`` of them stacked ``[L, ...]``
    (the reference's scan layout).  Matmul weights are drawn in f32 and
    stored at ``weight_dtype``; norms and biases stay f32."""
    d, f = cfg.d_model, cfg.d_ff

    def norm():
        n = init_norm(d, cfg.norm, device=device)
        if layers is None:
            return n
        return {k: torch.stack([v] * layers) for k, v in n.items()}

    if kind == "rwkv":
        kw = dict(device=device, weight_dtype=weight_dtype, layers=layers)
        return {"ln1": norm(),
                "time": init_rwkv_time(generator, d, cfg.rwkv_head_dim,
                                       cfg.rwkv_lora, **kw),
                "ln2": norm(),
                "channel": init_rwkv_channel(generator, d, f, **kw)}
    _require(kind)

    def dense(d_in, d_out):
        return _stacked(lambda: dense_init(generator, d_in, d_out,
                                           device=device, dtype=weight_dtype),
                        layers)

    def attn():
        hd = cfg.hd
        a = {"q": dense(d, cfg.n_heads * hd),
             "k": dense(d, cfg.n_kv * hd),
             "v": dense(d, cfg.n_kv * hd),
             "o": dense(cfg.n_heads * hd, d)}
        if cfg.qkv_bias or cfg.mlp_bias:
            a["qb"] = _zeros(cfg.n_heads * hd, layers, device)
            a["kb"] = _zeros(cfg.n_kv * hd, layers, device)
            a["vb"] = _zeros(cfg.n_kv * hd, layers, device)
        if cfg.mlp_bias:
            a["ob"] = _zeros(d, layers, device)
        return a

    p = {"ln1": norm(), "ln2": norm()}
    if kind == "rglru":
        p["rec"] = _stacked(lambda: init_recurrent(
            generator, d, cfg.r_width, cfg.conv_width, device=device,
            weight_dtype=weight_dtype), layers)
    else:
        p["attn"] = attn()
    if cfg.is_moe and kind in ("attn", "local"):
        p["moe"] = _stacked(lambda: init_moe(
            generator, d, f, cfg.moe_experts, device=device,
            weight_dtype=weight_dtype), layers)
        return p
    mlp = {"w1": dense(d, f), "w2": dense(f, d)}
    if cfg.mlp_gated:
        mlp["w3"] = dense(d, f)
    if cfg.mlp_bias:
        mlp["b1"] = _zeros(f, layers, device)
        mlp["b2"] = _zeros(d, layers, device)
    p["mlp"] = mlp
    if kind == "xattn":
        # drawn last, so every other kind draws what it drew before
        p["lnx"] = norm()
        p["cross"] = attn()
    return p


def init_block_state(cfg: LMConfig, kind: str, batch: int, cache_len: int,
                     dtype=torch.bfloat16, *, device, layers: int | None = None):
    """Zeroed decode state of one layer (``[L, ...]`` when ``layers`` is
    given): a K/V cache ``[B, cache_len, n_kv, hd]`` ("attn"), a ring of
    ``min(window, cache_len)`` slots ("local"), the recurrent state
    ``{"h": [B, R], "conv": [B, W-1, R]}`` in f32 ("rglru"), the WKV
    state ``{"s": [B, H, dh, dh]}`` in f32 with the token shifts
    ``"shift_t"`` and ``"shift_c"`` [B, D] at ``dtype`` ("rwkv"), or the
    K/V cache with the cross K/V ``"ck"`` / ``"cv"`` [B, enc_seq, n_kv,
    hd] ("xattn")."""
    _require(kind, SERVE_KINDS)
    lead = () if layers is None else (layers,)
    if kind == "rwkv":
        dh = cfg.rwkv_head_dim
        shift = lead + (batch, cfg.d_model)
        return {"s": torch.zeros(lead + (batch, cfg.d_model // dh, dh, dh),
                                 dtype=torch.float32, device=device),
                "shift_t": torch.zeros(shift, dtype=dtype, device=device),
                "shift_c": torch.zeros(shift, dtype=dtype, device=device)}
    if kind == "rglru":
        st = init_recurrent_state(batch, cfg.r_width, cfg.conv_width,
                                  device=device)
        return {k: v.expand(lead + v.shape).clone() for k, v in st.items()}
    slots = cache_len
    if kind == "local":
        slots = min(cfg.window, cache_len) or cache_len
    shape = lead + (batch, slots, cfg.n_kv, cfg.hd)
    state = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "xattn":
        cross = lead + (batch, cfg.enc_seq, cfg.n_kv, cfg.hd)
        state["ck"] = torch.zeros(cross, dtype=dtype, device=device)
        state["cv"] = torch.zeros(cross, dtype=dtype, device=device)
    return state


# --------------------------------------------------------------------------
# pieces
# --------------------------------------------------------------------------

def _proj_qkv(p, h, cfg: LMConfig, dt):
    b, s, _ = h.shape
    hd = cfg.hd
    q = h @ p["q"].to(dt)
    k = h @ p["k"].to(dt)
    v = h @ p["v"].to(dt)
    if "qb" in p:
        q = q + p["qb"].to(dt)
        k = k + p["kb"].to(dt)
        v = v + p["vb"].to(dt)
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv, hd),
            v.reshape(b, s, cfg.n_kv, hd))


def _mlp(p, h, cfg: LMConfig, dt):
    a = h @ p["w1"].to(dt)
    if "b1" in p:
        a = a + p["b1"].to(dt)
    a = activation(a, cfg.act)
    if cfg.mlp_gated:
        a = a * (h @ p["w3"].to(dt))
    out = a @ p["w2"].to(dt)
    if "b2" in p:
        out = out + p["b2"].to(dt)
    return out


def _ffn(p, x, cfg: LMConfig, dt, dropless: bool = False):
    """Second half-block: norm + (MoE | MLP) with residual.  -> (x, the
    MoE's aux loss, or None for a dense MLP).  ``dropless``: the MoE's
    capacity covers every token (``apply_moe``)."""
    h = apply_norm(x, p["ln2"], cfg.norm)
    if "moe" in p:
        out, aux = apply_moe(p["moe"], h, topk=cfg.moe_topk,
                             cap_factor=cfg.moe_capacity, act=cfg.act,
                             dropless=dropless)
        return x + out, aux
    return x + _mlp(p["mlp"], h, cfg, dt), None


def _attn_out(p, att, x, cfg: LMConfig, dt):
    b, s = att.shape[0], att.shape[1]
    out = att.reshape(b, s, cfg.n_heads * cfg.hd) @ p["o"].to(dt)
    if "ob" in p:
        out = out + p["ob"].to(dt)
    return x + out


def cross_kv(p, enc_out, cfg: LMConfig, dt):
    """The cross-attention K/V of the encoder memory enc_out [B, Se, D]:
    two [B, Se, kv, hd] projections, without bias."""
    b, se, _ = enc_out.shape
    return ((enc_out @ p["k"].to(dt)).reshape(b, se, cfg.n_kv, cfg.hd),
            (enc_out @ p["v"].to(dt)).reshape(b, se, cfg.n_kv, cfg.hd))


def _cross(p, x, cfg: LMConfig, dt, enc_out=None, state=None):
    """An "xattn" block's cross-attention with its residual: ``lnx``, q
    from x [B, S, D], K/V from ``enc_out`` (and written into ``state``'s
    ``"ck"`` / ``"cv"`` when a state is given), non-causal attention over
    all Se keys, the output projection.  No bias and no RoPE, as in the
    reference."""
    h = apply_norm(x, p["lnx"], cfg.norm)
    b, s, _ = h.shape
    c = p["cross"]
    q = (h @ c["q"].to(dt)).reshape(b, s, cfg.n_heads, cfg.hd)
    ck, cv = cross_kv(c, enc_out, cfg, dt)
    if state is not None:
        state["ck"].copy_(ck)
        state["cv"].copy_(cv)
    att = chunked_attention(q, ck, cv, causal=False)
    return x + att.reshape(b, s, cfg.n_heads * cfg.hd) @ c["o"].to(dt)


def _rwkv(p, x, cfg: LMConfig, dt, state=None):
    """An RWKV block: time-mix and channel-mix, each with its residual,
    from ``state``'s token shifts and WKV state (zeros when None).
    -> (x, the state after x's last token: {"s", "shift_t", "shift_c"})."""
    past = (lambda name: None) if state is None else state.get
    h = apply_norm(x, p["ln1"], cfg.norm)
    t_out, (shift_t, s) = apply_rwkv_time(
        p["time"], h, cfg.rwkv_head_dim, shift_in=past("shift_t"),
        state_in=past("s"), dt=dt)
    x = x + t_out
    h = apply_norm(x, p["ln2"], cfg.norm)
    c_out, shift_c = apply_rwkv_channel(p["channel"], h,
                                        shift_in=past("shift_c"), dt=dt)
    return x + c_out, {"s": s, "shift_t": shift_t, "shift_c": shift_c}


def _kv_into_cache(k, v, state, ring: bool = False):
    """Write full-sequence K/V [B, S, kv, hd] into the layer's decode
    cache [B, C, kv, hd] in place, cast to the cache dtype.  Global
    attention: zero-padded past S.  Local attention (``ring``): the ring
    buffer of the last ``min(C, S)`` tokens at slots ``t % C``, as
    ``apply_block_decode`` indexes it."""
    s, slots = k.shape[1], state["k"].shape[1]
    if ring:
        take = min(slots, s)
        idx = torch.arange(s - take, s, device=k.device) % slots
        for name, t in (("k", k), ("v", v)):
            state[name].zero_()
            state[name][:, idx] = t[:, s - take:].to(state[name].dtype)
        return state
    if s > slots:
        raise ValueError(f"prompt of {s} tokens exceeds cache_len {slots}")
    for name, t in (("k", k), ("v", v)):
        state[name][:, :s].copy_(t)
        state[name][:, s:].zero_()
    return state


# --------------------------------------------------------------------------
# apply (full sequence)
# --------------------------------------------------------------------------

def apply_block(p, x, cfg: LMConfig, kind: str, *, positions=None,
                enc_out=None, prefix_len: int = 0):
    """x: [B, S, D] -> ([B, S, D], aux loss).  The full-sequence forward
    that training runs; positions are 0..S-1 (RWKV and the encoder use
    none).  An attention or recurrent block is the prefill without a
    state to fill; its aux loss is the MoE's, or 0.  An "xattn" block
    attends to the encoder memory ``enc_out`` [B, Se, D]; ``prefix_len``
    is the self-attention's bidirectional prefix (``chunked_attention``)."""
    if positions is None and kind not in ("rwkv", "enc"):
        positions = torch.arange(x.shape[1], device=x.device)
    x, aux = apply_block_prefill(p, x, cfg, kind, positions=positions,
                                 state=None, enc_out=enc_out,
                                 prefix_len=prefix_len)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# --------------------------------------------------------------------------
# prefill: full-sequence forward that also fills the decode state
# --------------------------------------------------------------------------

def apply_block_prefill(p, x, cfg: LMConfig, kind: str, *, positions, state,
                        enc_out=None, prefix_len: int = 0):
    """x: [B, S, D] -> ([B, S, D], the MoE's aux loss or None); fills
    ``state`` (this layer's decode state) in place, unless it is None.
    An RWKV block takes no positions: it is causal by its recurrence.  An
    "enc" block is non-causal and takes no RoPE (and no state); an
    "xattn" block also fills the cross K/V of ``enc_out``.  The first
    ``prefix_len`` positions attend bidirectionally (the vlm family's
    patch prefix); decode needs no such mask, since every cached key
    then lies at or below the decoding position."""
    _require(kind, SERVE_KINDS if state is not None else BLOCK_KINDS)
    dt = x.dtype
    if kind == "rwkv":
        x, new = _rwkv(p, x, cfg, dt)
        if state is not None:
            for name, t in new.items():
                state[name].copy_(t)
        return x, None
    h = apply_norm(x, p["ln1"], cfg.norm)
    if kind == "rglru":
        out, st = apply_recurrent(p["rec"], h, dt=dt, return_state=True)
        if state is not None:
            for name in ("h", "conv"):
                state[name].copy_(st[name])
        return _ffn(p, x + out, cfg, dt)
    q, k, v = _proj_qkv(p["attn"], h, cfg, dt)
    if kind != "enc":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" else 0
    att = chunked_attention(q, k, v, causal=kind != "enc", window=window,
                            prefix_len=prefix_len)
    if state is not None:
        _kv_into_cache(k, v, state, ring=kind == "local")
    x = _attn_out(p["attn"], att, x, cfg, dt)
    if kind == "xattn":
        x = _cross(p, x, cfg, dt, enc_out, state)
    return _ffn(p, x, cfg, dt)


# --------------------------------------------------------------------------
# decode (single token with state)
# --------------------------------------------------------------------------

def _lanes(mask, new, old):
    """``new`` in the rows of the active lanes (``mask`` [B] bool, None
    for all), ``old`` in the rest."""
    if mask is None:
        return new
    return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def apply_block_decode(p, x, state, cfg: LMConfig, kind: str, *,
                       position, active=None, enc_out=None):
    """x: [B, 1, D] -> [B, 1, D]; updates ``state`` in place: this token's
    K/V at ``position`` ("attn", "xattn") or at its ring slot
    ``position % C`` ("local"), or the recurrent state ("rglru", and
    "rwkv", which reads no position: its WKV state and token shifts carry
    the past).  An "xattn" block then attends to the cross K/V of its
    state, cast to the compute dtype, or, where the state holds none, to
    those of ``enc_out`` computed anew (the reference's two branches).

    ``position`` is an ``int`` for the whole batch (the static path), or
    an int64 tensor [B] with one position per row: each row is then one
    of the continuous-batching engine's lanes, as the reference's
    vmapped batch-1 step computes it.  A lane's K/V goes to its own
    index (a gather/scatter over the rows, no host round trip), its MoE
    routes dropless (as a lone token does), and ``active`` [B] bool keeps
    the inactive lanes inert: the rows they would write keep their old
    values bit for bit.  An inactive lane's position may be
    ``cache_len`` (a finished request), so its write index is clamped."""
    _require(kind, SERVE_KINDS)
    lanes = torch.is_tensor(position)
    if active is not None and not lanes:
        raise ValueError("active lanes need a tensor of positions")
    dt = x.dtype
    if kind == "rwkv":
        x, new = _rwkv(p, x, cfg, dt, state)
        for name, t in new.items():
            state[name].copy_(_lanes(active, t.to(state[name].dtype),
                                     state[name]))
        return x
    h = apply_norm(x, p["ln1"], cfg.norm)
    if kind == "rglru":
        out, st = apply_recurrent_decode(p["rec"], h, state, dt=dt)
        for name in ("h", "conv"):
            state[name].copy_(_lanes(active, st[name], state[name]))
        return _ffn(p, x + out, cfg, dt, dropless=lanes)[0]
    q, k, v = _proj_qkv(p["attn"], h, cfg, dt)
    pos_arr = (position[:, None] if lanes
               else torch.full((1,), position, device=x.device))
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    slots = state["k"].shape[1]
    # the ring holds every token of the window once warm, so the local
    # layer masks only the slots not yet written (the reference's rule)
    if not lanes:
        idx, last = ((position % slots, min(position, slots - 1))
                     if kind == "local" else (position, position))
        state["k"][:, idx] = k[:, 0].to(state["k"].dtype)
        state["v"][:, idx] = v[:, 0].to(state["v"].dtype)
    else:
        if kind == "local":
            idx, last = position % slots, position.clamp(max=slots - 1)
        else:
            idx, last = position.clamp(max=slots - 1), position
        rows = torch.arange(x.shape[0], device=x.device)
        for name, t in (("k", k), ("v", v)):
            cache = state[name]
            cache[rows, idx] = _lanes(active, t[:, 0].to(cache.dtype),
                                      cache[rows, idx])
    att = decode_attention(q, state["k"], state["v"], position=last)
    x = _attn_out(p["attn"], att, x, cfg, dt)
    if kind == "xattn":
        x = _cross_decode(p, x, state, cfg, dt, enc_out)
    return _ffn(p, x, cfg, dt, dropless=lanes)[0]


def _cross_decode(p, x, state, cfg: LMConfig, dt, enc_out=None):
    """One token's cross-attention with its residual, over all Se cached
    (or recomputed) keys."""
    h = apply_norm(x, p["lnx"], cfg.norm)
    b = h.shape[0]
    c = p["cross"]
    q = (h @ c["q"].to(dt)).reshape(b, 1, cfg.n_heads, cfg.hd)
    if "ck" in state:
        ck, cv = state["ck"].to(dt), state["cv"].to(dt)
    else:
        ck, cv = cross_kv(c, enc_out, cfg, dt)
    att = decode_attention(q, ck, cv, position=ck.shape[1] - 1)
    return x + att.reshape(b, 1, cfg.n_heads * cfg.hd) @ c["o"].to(dt)
