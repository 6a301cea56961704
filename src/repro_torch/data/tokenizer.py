"""A small, dependency-free byte-level tokenizer for the examples/tests.

Deterministic and reversible: token = byte value (0..255); specials above.
Real deployments plug in their own vocab — the pipeline only needs ids.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258
    vocab_size = 259

    def encode(self, text: str, bos: bool = True, eos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")

    def stream(self, texts: Iterable[str]) -> Iterator[int]:
        for t in texts:
            yield from self.encode(t)
