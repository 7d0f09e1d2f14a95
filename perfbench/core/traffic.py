"""The one generator every traffic mix is read by.

A mix is a JSON file under ``perfbench/traffic/``: lengths, counts, group
sizes, the reward rule and the settings of the entry it drives, with the
source of its shape and what was cut from it. From a mix and ``--seed``
this module makes the prompts and, where the mix draws them, each
request's response length: all the program receives. Every seed gets the
same multiset of lengths in each block (quantiles of the mix's length
distributions), in an order and with contents drawn from the seed, so
that two seeds ask for the same amount of work.
"""
from __future__ import annotations

import hashlib
import math
import statistics
from typing import List

import numpy as np

BOS = 1          # the port's byte tokenizer: ids = byte + 3, BOS 1, EOS 2
BYTE_BASE = 3


def stream_seed(seed: int, *salt) -> int:
    """A 63-bit seed for one stream of the run (a block of prompts, a
    weight leaf), from the run's seed and a salt; any integer seed."""
    h = hashlib.sha256(repr((int(seed),) + tuple(salt)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def block_lengths(dist: dict, n: int) -> List[int]:
    """The ``n`` lengths of one block: the (i + 1/2)/n quantiles of the
    mix's distribution, ``uniform`` or ``loguniform`` over [min, max], or
    ``lognormal`` of the given ``mean`` and log-space ``sigma``, held to
    [min, max]."""
    lo, hi = float(dist["min"]), float(dist["max"])
    qs = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "uniform":
        vals = [lo + (hi - lo) * q for q in qs]
    elif dist["dist"] == "loguniform":
        vals = [math.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * q)
                for q in qs]
    elif dist["dist"] == "lognormal":
        sigma = float(dist["sigma"])
        nd = statistics.NormalDist(math.log(dist["mean"]) - sigma ** 2 / 2,
                                   sigma)
        vals = [min(max(math.exp(nd.inv_cdf(q)), lo), hi) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [int(round(v)) for v in vals]


def max_new(mix: dict) -> int:
    """The most new tokens a request of the mix asks for."""
    if "response_len" in mix:
        return int(mix["response_len"]["max"])
    return int(mix["new_tokens"])


def encode(text: str) -> List[int]:
    return [b + BYTE_BASE for b in text.encode()]


class Prompts:
    """Prompt ``k`` of block ``b`` of a mix under one seed. Each prompt is
    a BOS, filler ids drawn from the seed over the whole vocabulary, and a
    short arithmetic problem whose answer the reward rule checks. Where
    the mix has ``response_len``, each prompt also carries the response
    lengths of its group's ``group_size`` requests (``new_tokens``)."""

    def __init__(self, mix: dict, seed: int, vocab: int, block: int):
        self.mix, self.seed, self.vocab, self.block = mix, seed, vocab, block

    def make_block(self, b: int) -> List[dict]:
        mix = self.mix
        rng = np.random.default_rng(stream_seed(self.seed, "prompts", b))
        lens = block_lengths(mix["prompt_len"], self.block)
        lens = [lens[i] for i in rng.permutation(self.block)]
        top = int(mix.get("problem", {}).get("max_operand", 99))
        out = []
        for L in lens:
            a, c = (int(x) for x in rng.integers(0, top + 1, size=2))
            problem = encode(f"{a}+{c}=")
            n_fill = L - 1 - len(problem)
            if n_fill < 0:
                raise ValueError(f"prompt length {L} holds no problem")
            fill = rng.integers(BYTE_BASE, self.vocab, size=n_fill)
            toks = np.asarray([BOS, *fill.tolist(), *problem], np.int32)
            out.append({"tokens": toks, "answer": a + c,
                        "text": f"{a}+{c}="})
        if "response_len" in mix:
            G = int(mix["group_size"])
            rng = np.random.default_rng(
                stream_seed(self.seed, "responses", b))
            resp = block_lengths(mix["response_len"], self.block * G)
            resp = [resp[i] for i in rng.permutation(len(resp))]
            for k, p in enumerate(out):
                p["new_tokens"] = resp[k * G:(k + 1) * G]
        return out


def reward(rule: dict, answer: int, response_ids) -> float:
    """The mix's verifiable reward of one response.

    ``residue``: the share of response tokens whose id is congruent to the
    answer modulo ``modulus``. Random weights meet it at about 1/modulus
    with a spread across a group, so GRPO's group advantages are not zero
    (an exact-match reward would give every sample of random weights the
    same reward, every advantage 0 and no policy gradient)."""
    ids = np.asarray(response_ids, np.int64)
    if rule["kind"] == "residue":
        if ids.size == 0:
            return 0.0
        m = int(rule["modulus"])
        return float(np.mean(ids % m == int(answer) % m))
    raise ValueError(f"unknown reward rule {rule['kind']!r}")


def group_advantages(rewards, eps: float = 1e-6) -> np.ndarray:
    """GRPO's group-relative advantage in float32, population std."""
    r = np.asarray(rewards, np.float32)
    return (r - r.mean()) / (r.std() + eps)

