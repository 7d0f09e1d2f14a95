"""Autoregressive rollout generation with a KV cache (the fixed backend),
and the counter-keyed categorical draw both rollout backends share.

The rollout engine's inner loop: batched prompt feed (teacher-forced
decode steps, sharing the exact production serve path) followed by
temperature sampling of up to ``max_new_tokens``, collecting per-token
behavior logprobs — what the actor-update step needs as ``old_logprob``.
The reference's ``jax.lax.scan`` is a Python loop here; while tracing is
on (``core/obs/tracing.py``) each step is a ``fixed.step`` span with
``forward`` and ``sample`` children.

Sampling: the reference keys each draw with threefry
``fold_in(fold_in(key, uid), pos)``, which torch cannot reproduce. Here
row ``i`` draws its Gumbel noise from a ``torch.Generator`` seeded with a
64-bit mix of ``(seed, uid_i, pos_i)``, so a token depends only on those
three numbers and its logits — never on the slot or the rest of the batch.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.obs.tracing import span
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_seed(seed: int, uid: int, pos: int) -> int:
    """64-bit counter key of draw ``pos`` of sequence ``uid``."""
    return _splitmix64(_splitmix64(_splitmix64(int(seed) & _M64)
                                   ^ (int(uid) & _M64)) ^ (int(pos) & _M64))


def categorical(logits, keys: Sequence[int]):
    """Gumbel-max draw per row: logits (B, V) fp32, one 64-bit key per
    row. Returns (B,) int64 on the logits' device."""
    B, V = logits.shape
    noise = torch.empty((B, V), dtype=torch.float32, device=logits.device)
    gen = torch.Generator(device=logits.device)
    for i, key in enumerate(keys):
        gen.manual_seed(int(key))
        noise[i].uniform_(generator=gen)
    gumbel = -torch.log(-torch.log(noise.clamp_min(1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def require_token_model(cfg, what: str):
    """Refuse the audio family: its decoder attends to encoder frames,
    while the reference's generation runs from prompt tokens alone (over
    a cross cache it never fills), and its reference stage and actor
    update read ``frames`` that no rollout row carries. So no engine
    generates for audio; the model facade serves it (``forward``,
    ``encdec.precompute_cross_kv``, ``decode_step``)."""
    if cfg.arch_type == "audio":
        raise ValueError(
            f"{what}: {cfg.name} is an audio encoder-decoder; the "
            "reference generates from prompt tokens alone, so there is no "
            "audio generation engine (serve it through the model facade: "
            "forward, encdec.precompute_cross_kv, decode_step)")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@torch.no_grad()
def _generate_loop(params, cfg, prompt_tokens, prompt_lens, rng_seed, *,
                   max_new: int, temperature: float, device):
    """prompt_tokens: (B, Lp) right-padded; prompt_lens: (B,).
    Returns (tokens (B, Lp+max_new), logprobs (B, Lp+max_new), resp_mask)
    as numpy arrays."""
    B, Lp = prompt_tokens.shape
    total = Lp + max_new
    cache = init_cache(cfg, B, total, device=device)
    toks = torch.as_tensor(prompt_tokens, dtype=torch.long, device=device)
    lens = torch.as_tensor(prompt_lens, dtype=torch.long, device=device)
    out_toks = torch.zeros((B, total), dtype=torch.long, device=device)
    out_toks[:, 0] = toks[:, 0]
    out_lps = torch.zeros((B, total), dtype=torch.float32, device=device)
    cur = toks[:, 0]
    for t in range(total - 1):
        with span("fixed.step"):
            with span("forward"):
                logits, cache = decode_step(
                    params, cfg, cache, cur,
                    torch.full((B,), t, dtype=torch.long, device=device))
            with span("sample"):
                logits = logits.float() / max(temperature, 1e-6)
                logp = torch.log_softmax(logits, dim=-1)
                sampled = categorical(logits, [fold_seed(rng_seed, i, t + 1)
                                               for i in range(B)])
                # during the prompt: next token is forced; after: sampled
                in_prompt = (t + 1) < lens
                forced = toks[:, min(t + 1, Lp - 1)]
                nxt = torch.where(in_prompt, forced, sampled)
                out_toks[:, t + 1] = nxt
                out_lps[:, t + 1] = logp.gather(1, nxt[:, None])[:, 0]
                cur = nxt
    pos = torch.arange(total, device=device)[None, :]
    resp_mask = (pos >= lens[:, None]).float()
    return (out_toks.cpu().numpy().astype(np.int32), out_lps.cpu().numpy(),
            resp_mask.cpu().numpy())


def generate(params, cfg, prompts: List[np.ndarray], rng_seed: int, *,
             max_new_tokens: int = 16, temperature: float = 1.0,
             eos_id: int = ByteTokenizer.eos_id, bucket: bool = True,
             device=None):
    """Returns list of dicts per prompt: tokens, logprobs, response_mask,
    response_ids (trimmed at EOS), prompt_len. ``params`` must live on
    ``device`` (``cuda`` unless the caller passes another).

    bucket=True pads the batch dim to a power of two and the prompt length
    to a multiple of 8, as the reference does to reuse one compilation
    (continuous-batching engines do the same bucketing). Refuses the
    audio family (``require_token_model``)."""
    require_token_model(cfg, "generate")
    dev = resolve_device(device)
    tok = ByteTokenizer()
    n_real = len(prompts)
    prompts = list(prompts)
    if bucket:
        target_b = _next_pow2(n_real)
        prompts += [prompts[-1]] * (target_b - n_real)
        max_len = max(len(p) for p in prompts)
        pad_len = ((max_len + 7) // 8) * 8
        toks, mask = tok.pad_batch(prompts, length=pad_len)
    else:
        toks, mask = tok.pad_batch(prompts)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    out_toks, out_lps, resp_mask = _generate_loop(
        params, cfg, toks, lens, rng_seed, max_new=max_new_tokens,
        temperature=temperature, device=dev)

    rows = []
    for i in range(n_real):
        lp_len = int(lens[i])
        resp = out_toks[i, lp_len:]
        cut = np.where(resp == eos_id)[0]
        n_resp = int(cut[0]) + 1 if len(cut) else len(resp)
        m = resp_mask[i].copy()
        m[lp_len + n_resp:] = 0.0
        rows.append(dict(tokens=out_toks[i], logprobs=out_lps[i],
                         response_mask=m, response_ids=resp[:n_resp],
                         prompt_len=lp_len))
    return rows
