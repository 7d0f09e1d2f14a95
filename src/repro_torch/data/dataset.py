"""Synthetic DeepScaleR-like dataset: verifiable math QA.

The paper trains on DeepScaleR (AIME/AMC math problems with checkable
answers). Offline, we generate arithmetic problems with exact integer
answers — the same *system shape*: prompt -> sampled response ->
rule-verifiable reward.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


@dataclasses.dataclass
class MathSample:
    prompt: str
    answer: int


class MathDataset:
    """Streaming arithmetic problems: ``a <op> b =``."""

    def __init__(self, seed: int = 0, max_operand: int = 9,
                 ops: str = "+-"):
        self.rng = np.random.default_rng(seed)
        self.max_operand = max_operand
        self.ops = ops

    def sample(self) -> MathSample:
        a = int(self.rng.integers(0, self.max_operand + 1))
        b = int(self.rng.integers(0, self.max_operand + 1))
        op = self.ops[int(self.rng.integers(0, len(self.ops)))]
        ans = a + b if op == "+" else a - b
        return MathSample(prompt=f"{a}{op}{b}=", answer=ans)

    def batch(self, n: int) -> List[MathSample]:
        return [self.sample() for _ in range(n)]

    def __iter__(self) -> Iterator[MathSample]:
        while True:
            yield self.sample()


class PromptDataset:
    """Tokenized prompt stream for the RL runner."""

    def __init__(self, tokenizer: ByteTokenizer | None = None, seed: int = 0,
                 max_operand: int = 9):
        self.tok = tokenizer or ByteTokenizer()
        self.ds = MathDataset(seed, max_operand)

    def prompts_for_step(self, step: int, n: int) -> List[dict]:
        # deterministic per step for reproducibility across workflow modes
        ds = MathDataset(seed=step * 7919 + 13, max_operand=self.ds.max_operand)
        out = []
        for s in ds.batch(n):
            out.append({"tokens": self.tok.encode(s.prompt),
                        "text": s.prompt, "answer": s.answer})
        return out
