"""CLIP BPE tokenizer (host side).

The reference uses clip's ``_Tokenizer`` (``text_encoder.py:63``, and the
filtration scripts call ``clip.tokenize``). Same algorithm here: byte→
unicode table, lowercase + whitespace cleanup, BPE over a merges list with
the ``</w>`` end-of-word convention, SOT/EOT wrapping, pad/truncate to the
context length. The merges/vocab file (bpe_simple_vocab_16e6.txt.gz) is
supplied by path — no network access.
"""
from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None,
                 merges: Optional[List[Tuple[str, str]]] = None):
        self.byte_encoder = bytes_to_unicode()
        if merges is None:
            assert bpe_path and os.path.exists(bpe_path), (
                "provide bpe_simple_vocab_16e6.txt.gz via bpe_path or explicit merges"
            )
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if False
            else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(
                self.encoder[t] for t in self.bpe(tok).split(" ") if t in self.encoder
            )
        return tokens

    def tokenize(self, texts: Sequence[str], context_length: int = 77,
                 pad_id: int = 0) -> np.ndarray:
        """clip.tokenize parity: SOT + bpe + EOT, truncate (keeping EOT),
        pad with ``pad_id``, (B, context_length) int32.

        pad_id=0 is the openai-clip/OpenCLIP convention (SDXL tokenizer_2);
        SDXL's first tokenizer (CLIP-L, diffusers) pads with the EOT id —
        padded positions feed the UNet conditioning, so the convention
        matters for output parity."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out
