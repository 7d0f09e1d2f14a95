"""Unified model facade, as in the reference:

    params = init_params(seed, cfg, device="cuda")
    logits, aux = forward(params, cfg, batch)              # train/prefill
    logits, cache = decode_step(params, cfg, cache, token, pos)

``batch`` is a dict holding tokens (B,S), plus ``vision_embeds`` (B,T,d)
for the vlm family: projected patch embeddings prepended to the tokens
(the vision encoder is a stub, as in the reference), or ``frames``
(B,F,d) for the audio family: the encoder's stubbed conv/mel frame
embeddings (``models/encdec.py``; fill its cross cache with
``encdec.precompute_cross_kv`` before decoding). Every family of the
reference is ported: dense, moe, vlm, ssm, hybrid and audio, with GQA or
MLA attention (MiniCPM3, DeepSeek-V2).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.tree import tree_leaves


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``. The init helpers
    make each tensor on ``gen.device`` and draw into it with ``gen``, and a
    draw into a meta tensor takes a CPU generator and makes no values: a
    tree of meta tensors of the params' shapes and dtypes, nothing
    allocated."""
    device = torch.device("meta")


def init_params(seed: int, cfg, *, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``cuda`` unless the caller passes another); on ``meta``,
    their shapes and dtypes alone (``launch/specs.py``)."""
    dev = resolve_device(device)
    gen = _MetaGenerator() if dev.type == "meta" else torch.Generator(
        device=dev)
    gen.manual_seed(int(seed))
    if cfg.arch_type == "audio":
        return encdec.init_encdec(gen, cfg)
    return transformer.init_lm(gen, cfg)


def forward(params, cfg, batch, *, window=0, use_kernels=True,
            return_cache=False):
    """Full-sequence forward. Returns (logits, aux[, cache]).

    ``use_kernels`` chooses the route, as the reference's ``use_pallas``
    does: True (serving, prefill, reference inference) takes the
    forward-only kernels, ``kernels/flash_attention`` for causal attention,
    ``kernels/mamba_scan`` for the ssm scan and ``kernels/rglru_scan`` for
    the RG-LRU; False (the actor update) takes the plain, differentiable
    ``sdpa`` and scans. MLA attention runs no kernel on any route: the
    reference computes it with einsums outside any Pallas kernel
    (``models/mla.py``). A vlm's logits cover its T vision positions too.
    The audio family's encoder and cross-attention are non-causal and take
    the plain ``sdpa`` on every route; its cache is None, as in the
    reference, and ``window`` does not reach it."""
    if cfg.arch_type == "audio":
        memory = encdec.encode(params, cfg, batch["frames"])
        logits, aux, cache = encdec.decode_train(
            params, cfg, memory, batch["tokens"], use_kernels=use_kernels)
        return (logits, aux, cache) if return_cache else (logits, aux)
    extra = batch.get("vision_embeds") if cfg.arch_type == "vlm" else None
    logits, aux, cache = transformer.forward_lm(
        params, cfg, batch["tokens"], extra_embeds=extra, window=window,
        return_cache=return_cache, use_kernels=use_kernels)
    if return_cache:
        return logits, aux, cache
    return logits, aux


def init_cache(cfg, batch_size, length, dtype=torch.bfloat16, *,
               device=None):
    if cfg.arch_type == "audio":
        return encdec.init_dec_cache(cfg, batch_size, length, dtype,
                                     device=resolve_device(device))
    return transformer.init_cache(cfg, batch_size, length, dtype,
                                  device=resolve_device(device))


def decode_step(params, cfg, cache, token, pos, *, ring=False, mesh=None):
    """One-token decode. token/pos: (B,). Returns (logits (B,V), cache);
    the cache is updated in place. ``mesh`` (a ``DeviceMesh`` with a
    ``"model"`` axis) routes the dense, moe and vlm GQA decode attention
    through ``distributed/flash_decode``'s sharded partial-softmax combine
    in place of ``kernels/decode_attention``; the other families ignore
    it, as the reference's do. The audio family ignores ``ring`` too."""
    if cfg.arch_type == "audio":
        return encdec.decode_step(params, cfg, cache, token, pos)
    return transformer.decode_lm(params, cfg, cache, token, pos, ring=ring,
                                 mesh=mesh)


def decode_window(cfg, shape_name: str) -> tuple[int, bool]:
    """(cache length, ring?) policy for a decode input shape.

    long_500k on dense archs uses the sliding-window variant
    (cfg.long_context_window ring buffer).
    """
    from repro_torch.configs.base import INPUT_SHAPES
    shp = INPUT_SHAPES[shape_name]
    if cfg.arch_type == "ssm":
        return 1, False  # state caches carry no seq dim; length unused
    if shp.name == "long_500k" and cfg.arch_type not in ("hybrid",):
        return cfg.long_context_window, True
    return shp.seq_len, False


def count_params(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))
