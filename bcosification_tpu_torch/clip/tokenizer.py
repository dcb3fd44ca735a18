"""CLIP BPE tokenizer (the port's copy of ``bcosification_tpu/clip/tokenizer.py``;
numpy and gzip only).

OpenAI CLIP's byte-level BPE with the bundled 16e6 merge table
(``data/assets/bpe_simple_vocab_16e6.txt.gz``), lower-cased,
<|startoftext|>/<|endoftext|> wrapping, context length 77 with truncation
keeping the EOT token. ftfy text fixing is applied when it is installed
(prompt templates are clean ASCII).
"""
from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from pathlib import Path
from typing import List, Union

import numpy as np

try:
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

__all__ = ["SimpleTokenizer", "tokenize"]

DEFAULT_BPE_PATH = Path(__file__).parents[1] / "data" / "assets" / "bpe_simple_vocab_16e6.txt.gz"


@lru_cache()
def bytes_to_unicode():
    """Byte -> printable unicode char mapping (reversible, avoids whitespace)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


try:  # looked up once: a failing import per text dominated the tokenizer's time
    import ftfy
except ImportError:
    ftfy = None


def basic_clean(text: str) -> str:
    if ftfy is not None:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: Union[str, Path, None] = None):
        bpe_path = bpe_path or os.getenv("CLIP_BPE_PATH") or DEFAULT_BPE_PATH
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if re.__name__ == "regex"
            else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
            re.IGNORECASE,
        )

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
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


_tokenizer = None


def _get_tokenizer() -> SimpleTokenizer:
    global _tokenizer
    if _tokenizer is None:
        _tokenizer = SimpleTokenizer()
    return _tokenizer


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = 77,
    truncate: bool = True,
) -> np.ndarray:
    """clip.tokenize (CLIP/clip/clip.py:205): [N, context_length] int32."""
    if isinstance(texts, str):
        texts = [texts]
    tok = _get_tokenizer()
    sot = tok.encoder["<|startoftext|>"]
    eot = tok.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tok.encode(text) + [eot]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = eot
            else:
                raise RuntimeError(f"Input too long for context length: {text!r}")
        result[i, : len(tokens)] = tokens
    return result
