"""Whisper-style encoder-decoder backbone (audio front end stubbed), as in
the reference.

``frames`` are precomputed conv/mel frame embeddings (B, F, d): the front
end is a stub. The transformer encoder runs over them and the decoder
(self- then cross-attention) over the tokens, with learned positions as
in Whisper. Like the reference, every self-attention (the encoder's
non-causal one included) also applies RoPE, and the decoder's learned
positions index ``dec_pos`` modulo ``max_target_positions`` while the
rotary positions do not wrap.

Routes: the encoder's attention and the cross-attention are non-causal,
so they take the plain ``sdpa`` on every route (the flash kernel is
causal only). The decoder's causal self-attention takes
``kernels/flash_attention`` under ``use_kernels=True`` and the plain,
differentiable ``sdpa`` otherwise (the actor update). Decode goes through
``attention.attend_decode``, so both the self cache and the cross cache
go through ``kernels/decode_attention``.

Layer stacks keep the reference's tree: ``enc_blocks`` and ``dec_blocks``
carry a leading layer axis and are walked by a Python loop.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (_Gather, dtype_of, embed,
                                       init_embedding, init_mlp, init_norm,
                                       mlp, norm, normal_init, unembed)
from repro_torch.models.transformer import _layer


def _init_enc_block(gen, cfg, layers):
    dt, dev = dtype_of(cfg.param_dtype), gen.device
    return {"ln1": init_norm(cfg.norm, cfg.d_model, dt, dev, layers=layers),
            "attn": attn.init_attention(gen, cfg, dt, layers=layers),
            "ln2": init_norm(cfg.norm, cfg.d_model, dt, dev, layers=layers),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                            layers=layers)}


def _init_dec_block(gen, cfg, layers):
    dt, dev = dtype_of(cfg.param_dtype), gen.device
    p = _init_enc_block(gen, cfg, layers)
    p["ln_x"] = init_norm(cfg.norm, cfg.d_model, dt, dev, layers=layers)
    p["cross"] = attn.init_attention(gen, cfg, dt, layers=layers)
    return p


def init_encdec(gen, cfg):
    """Parameters drawn on ``gen``'s device at the reference's scales."""
    dt = dtype_of(cfg.param_dtype)
    return {
        "enc_pos": normal_init(gen, (cfg.encoder_frames, cfg.d_model), 0.02,
                               dt),
        "enc_blocks": _init_enc_block(gen, cfg, (cfg.encoder_layers,)),
        "enc_norm": init_norm(cfg.norm, cfg.d_model, dt, gen.device),
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "dec_pos": normal_init(gen, (cfg.max_target_positions, cfg.d_model),
                               0.02, dt),
        "dec_blocks": _init_dec_block(gen, cfg, (cfg.num_layers,)),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dt, gen.device),
    }


def _positions(params, idx, cd):
    """Rows ``idx % max_target_positions`` of the learned decoder
    positions, in ``cd`` (a gather with the sorted backward)."""
    pos_tab = params["dec_pos"]
    return _Gather.apply(pos_tab, idx % pos_tab.shape[0]).to(cd)


def encode(params, cfg, frames):
    """frames: (B, F, d) stubbed front-end embeddings -> (B, F, d)
    memory."""
    cd = dtype_of(cfg.compute_dtype)
    x = frames.to(cd) + params["enc_pos"][None, :frames.shape[1]].to(cd)
    for i in range(cfg.encoder_layers):
        blk = _layer(params["enc_blocks"], i)
        x = x + attn.attend_full(blk["attn"], norm(blk["ln1"], x), cfg,
                                 causal=False)
        x = x + mlp(blk["ffn"], norm(blk["ln2"], x), cfg.activation, cd)
    return norm(params["enc_norm"], x)


def decode_train(params, cfg, memory, tokens, *, use_kernels=True):
    """Teacher-forced decoder forward. Returns (logits, 0.0, None), as the
    reference does."""
    cd = dtype_of(cfg.compute_dtype)
    S = tokens.shape[1]
    idx = torch.arange(S, device=tokens.device)
    x = embed(params["embed"], tokens, cd) + _positions(params, idx, cd)[None]
    for i in range(cfg.num_layers):
        blk = _layer(params["dec_blocks"], i)
        x = x + attn.attend_full(blk["attn"], norm(blk["ln1"], x), cfg,
                                 use_kernels=use_kernels)
        kv = attn.project_cross_kv(blk["cross"], memory, cfg)
        x = x + attn.attend_full(blk["cross"], norm(blk["ln_x"], x), cfg,
                                 cross_kv=kv)
        x = x + mlp(blk["ffn"], norm(blk["ln2"], x), cfg.activation, cd)
    x = norm(params["final_norm"], x)
    return unembed(params["embed"], x, cd), 0.0, None


def init_dec_cache(cfg, batch, length, dtype=torch.bfloat16, device=None):
    """The decoder's self-attention KV cache (``length`` keys) and the
    cross K/V slots (``encoder_frames`` keys), all stacked over layers."""
    shape = (cfg.num_layers, batch, cfg.encoder_frames, cfg.num_kv_heads,
             cfg.head_dim)
    return {"self": attn.init_kv_cache(cfg, batch, length, dtype,
                                       device=device),
            "cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def precompute_cross_kv(params, cfg, memory, cache):
    """Fill the cross K/V slots once after encoding, in place. Returns the
    cache."""
    for i in range(cfg.num_layers):
        k, v = attn.project_cross_kv(
            _layer(params["dec_blocks"]["cross"], i), memory, cfg)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
    return cache


def decode_step(params, cfg, cache, token, pos):
    """One decoder token. token/pos: (B,). Returns (logits (B, V), cache);
    the self cache is updated in place. The cross-attention reads the
    whole cross cache (``write=False``) at position ``F - 1``, as the
    reference does."""
    cd = dtype_of(cfg.compute_dtype)
    x = embed(params["embed"], token[:, None], cd) \
        + _positions(params, pos, cd)[:, None]
    cross_pos = torch.full_like(pos, cache["cross_k"].shape[2] - 1)
    for i in range(cfg.num_layers):
        blk = _layer(params["dec_blocks"], i)
        y, _ = attn.attend_decode(blk["attn"], norm(blk["ln1"], x),
                                  _layer(cache["self"], i), pos, cfg)
        x = x + y
        y, _ = attn.attend_decode(
            blk["cross"], norm(blk["ln_x"], x),
            {"k": cache["cross_k"][i], "v": cache["cross_v"][i]}, cross_pos,
            cfg, write=False)
        x = x + y
        x = x + mlp(blk["ffn"], norm(blk["ln2"], x), cfg.activation, cd)
    x = norm(params["final_norm"], x)
    return unembed(params["embed"], x, cd)[:, 0], cache
