"""Dependency-free UTF-8 byte tokenizer (copy of the JAX package's
``ByteTokenizer``): ids 0=pad, 1=bos, 2=eos, bytes at 3..258."""

from __future__ import annotations


class ByteTokenizer:
    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    vocab_size = 259

    @property
    def bos_id(self) -> int:
        return self.BOS

    @property
    def eos_id(self) -> int:
        return self.EOS

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids: list[int]) -> str:
        # Ids beyond the byte range can appear when a model's vocab is larger
        # than 259 (e.g. random-init weights); skip them like specials.
        data = bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")
