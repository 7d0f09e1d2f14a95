"""The reference model of a configuration, chosen by its family, and the
quantities the comparisons read from it.

A family's reference is the module ``perfbench/reference/<arch_type>.py``
(``layout`` and ``forward``), found by name, so that a configuration of a
new family brings its reference as a file of its own."""
from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np
import torch

from perfbench.core.weights import make


def family(c: dict):
    name = c["arch_type"]
    if not (Path(__file__).parent / f"{name}.py").is_file():
        raise ValueError(f"the reference has no {name!r} family")
    return importlib.import_module(f"perfbench.reference.{name}")


def layout(c: dict):
    return family(c).layout(c)


def forward(params, tokens, c: dict, prec):
    return family(c).forward(params, tokens, c, prec)


@torch.no_grad()
def token_logprobs(params, c: dict, prec, tokens, start: int,
                   temperature: float = 1.0):
    """Logprobs (float32, on the host) of ``tokens[start:]`` for one
    sequence, each under the logits of the position before it."""
    t = torch.as_tensor(tokens, dtype=torch.long,
                        device=params["embed"]["table"].device)[None]
    logits = forward(params, t, c, prec)[0, start - 1:-1]
    lp = torch.log_softmax(logits / temperature, dim=-1)
    return lp.gather(1, t[0, start:, None])[:, 0].cpu()


def altered_gap(c: dict, seed: int, rows, device, prec) -> float:
    """The widest gap between the reference's logprob of a sampled token
    and of the token put in its place (the next id), each row's
    (tokens, prompt length, logprobs) altered in the middle of its
    response: what a token altered after its logprob was taken reads."""
    params = make(layout(c), seed, device)
    worst = 0.0
    for tokens, P, lps in rows:
        tokens = np.asarray(tokens, np.int64).copy()
        pos = P + (len(tokens) - P) // 2
        tokens[pos] = (tokens[pos] + 1) % c["vocab_size"]
        alt = token_logprobs(params, c, prec, tokens, pos)[0]
        worst = max(worst, abs(float(alt) - float(lps[pos])))
    del params
    return worst
