"""Tokenizer for the CLI: the asset-free byte tokenizer of the JAX
package's ``data/text.py`` (UTF-8 bytes plus pad/eos/mask specials)."""

from __future__ import annotations


class ByteTokenizer:
    vocab_size = 259
    pad_id = 256
    eos_id = 257
    mask_id = 258

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")
