"""CLIP byte-pair-encoding tokenizer (pure Python, host-side).

Counterpart of ``tair_tpu/models/tokenizer.py``: lower-cased, whitespace
normalised BPE over byte-to-unicode text, SOT/EOT framing, 77-token context
with EOT-preserving truncation. The merge table is the JAX package's asset
(``tair_tpu/assets/bpe_simple_vocab_16e6.txt.gz``), read as a data file.

The JAX module splits text with the third-party ``regex`` package's
``\\p{L}`` / ``\\p{N}`` classes, which the standard ``re`` cannot express
(``\\d`` is only ``Nd``: ``²``, ``½`` and ``Ⅻ`` are ``No`` and ``Nl``). Here
the same pre-tokenizer is a scanner over ``unicodedata.category``: at each
position, in the order of the JAX pattern's alternatives, the special tokens,
the contractions (case-insensitive), a run of letters, one number character,
or a run of anything that is neither whitespace, letter nor number.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Iterable, List, Union

import numpy as np

DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tair_tpu", "assets", "bpe_simple_vocab_16e6.txt.gz",
)

CONTEXT_LENGTH = 77

_SPECIAL = ("<start_of_text>", "<end_of_text>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def _bytes_to_unicode():
    """Reversible mapping from bytes to printable unicode chars (GPT-2 style)."""
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


def _get_pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _matches_at(text: str, i: int, literal: str, ignore_case: bool) -> bool:
    piece = text[i : i + len(literal)]
    if len(piece) != len(literal):
        return False
    if not ignore_case:
        return piece == literal
    # simple case folding, character by character, as the regex engine's
    # IGNORECASE compares (so the long s "ſ" matches "s")
    return all(a == b or a.upper() == b.upper() for a, b in zip(piece, literal))


def pre_tokenize(text: str) -> List[str]:
    """The JAX tokenizer's ``regex.findall`` over `text`, without ``regex``."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        literal = next(
            (lit for lit in _SPECIAL + _CONTRACTIONS if _matches_at(text, i, lit, True)),
            None,
        )
        if literal is not None:
            j = i + len(literal)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        elif not ch.isspace():
            j = i + 1
            while j < n and not (
                text[j].isspace() or _is_letter(text[j]) or _is_number(text[j])
            ):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(_SPECIAL)

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {tok: tok for tok in _SPECIAL}
        self.sot_token = self.encoder["<start_of_text>"]
        self.eot_token = self.encoder["<end_of_text>"]
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in pre_tokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


@functools.lru_cache(maxsize=1)
def get_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(
    texts: Union[str, List[str]], context_length: int = CONTEXT_LENGTH
) -> np.ndarray:
    """Tokenize prompt(s) -> int32 [batch, context_length] with SOT/EOT framing.
    Over-long prompts are truncated with EOT forced into the last slot."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(ids) > context_length:
            ids = ids[:context_length]
            ids[-1] = tok.eot_token
        result[i, : len(ids)] = ids
    return result


def empty_tokens(batch: int, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Empty-prompt token batch ([SOT, EOT, 0...])."""
    tok = get_tokenizer()
    out = np.zeros((batch, context_length), np.int32)
    out[:, 0] = tok.sot_token
    out[:, 1] = tok.eot_token
    return out
