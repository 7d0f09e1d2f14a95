"""Byte-level tokenizer with a few specials — self-contained (offline)."""
from __future__ import annotations

from typing import List

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_SPECIALS = 3


class ByteTokenizer:
    """ids = byte value + N_SPECIALS; vocab_size = 256 + 3."""

    vocab_size = 256 + N_SPECIALS
    pad_id, bos_id, eos_id = PAD, BOS, EOS

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> np.ndarray:
        ids = [b + N_SPECIALS for b in text.encode("utf-8")]
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        """Bytes of the byte ids; specials, and ids past the byte range
        that a model with a wider vocab (Qwen2.5's 152,064) samples, decode
        to nothing. The reference raises on the latter."""
        bs = bytes(int(i) - N_SPECIALS for i in ids
                   if N_SPECIALS <= int(i) < self.vocab_size)
        return bs.decode("utf-8", errors="replace")

    def pad_batch(self, seqs: List[np.ndarray], length: int | None = None,
                  left: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Returns (tokens (B, L), mask (B, L))."""
        L = length or max(len(s) for s in seqs)
        B = len(seqs)
        out = np.full((B, L), PAD, np.int32)
        mask = np.zeros((B, L), np.float32)
        for i, s in enumerate(seqs):
            s = s[:L]
            if left:
                out[i, L - len(s):] = s
                mask[i, L - len(s):] = 1
            else:
                out[i, :len(s)] = s
                mask[i, :len(s)] = 1
        return out, mask
