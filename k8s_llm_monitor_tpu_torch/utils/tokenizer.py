"""Tokenizers.

Two implementations behind one duck-typed interface (encode/decode/bos/eos):
  - ``HFTokenizer``: wraps a local HuggingFace tokenizer directory for real
    Llama/Qwen checkpoints.
  - ``ByteTokenizer``: dependency-free UTF-8 byte fallback used by tests,
    benchmarks, and any deployment without downloaded tokenizer files.
    ids: 0=pad, 1=bos, 2=eos, bytes at 3..258.
"""

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
        # than 259 (e.g. random-init dev weights); skip them like specials.
        data = bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    @property
    def bos_id(self) -> int:
        return self._tok.bos_token_id

    @property
    def eos_id(self) -> int:
        return self._tok.eos_token_id

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(path: str | None):
    if path:
        return HFTokenizer(path)
    return ByteTokenizer()
