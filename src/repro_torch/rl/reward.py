"""Rule-based verifiable reward (DeepScaleR-style answer checking)."""
from __future__ import annotations

import re

from repro_torch.data.tokenizer import ByteTokenizer

_tok = ByteTokenizer()


def math_reward(answer: int, response_ids) -> float:
    """+1 exact integer match, +0.2 if the answer appears anywhere,
    -0.1 otherwise (mild penalty keeps logits moving early on)."""
    text = _tok.decode(response_ids)
    m = re.match(r"\s*(-?\d+)", text)
    if m is not None and int(m.group(1)) == answer:
        return 1.0
    if re.search(rf"(?<!\d)-?{abs(answer)}(?!\d)", text):
        return 0.2
    return -0.1


def math_reward_shaped(answer: int, response_ids) -> float:
    """Dense-signal variant for small-scale runs: exact match 1.0, else
    partial credit for digit density and answer presence. The GRPO group
    advantage needs within-group reward variance to produce gradient; the
    shaped reward provides it from step 0 (used by the Fig.-12 stability
    benchmark — both sync and async modes use the same reward, so the
    comparison is unaffected)."""
    text = _tok.decode(response_ids)
    m = re.match(r"\s*(-?\d+)", text)
    if m is not None and int(m.group(1)) == answer:
        return 1.0
    r = -0.1
    if text:
        digit_frac = sum(c.isdigit() for c in text) / len(text)
        r += 0.4 * digit_frac
    if re.search(rf"(?<!\d)-?{abs(answer)}(?!\d)", text):
        r += 0.3
    return r


def length_penalty(response_len: int, max_len: int, coef: float = 0.0) -> float:
    return -coef * max(0, response_len - max_len) / max(1, max_len)
