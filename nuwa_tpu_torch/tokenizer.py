"""CLIP-style byte-level BPE tokenizer.

Counterpart of ``nuwa_tpu/tokenizer.py``, the same code in numpy: byte-level
BPE over a CLIP merges file (vocab 49408: 256 byte symbols + 256 word-final
variants + merges + 2 specials), with ``encode`` / ``decode`` / fixed-context
``tokenize`` and a module-level default ``tokenizer``, built on first use.

The port keeps its own byte-identical copy of the public OpenAI CLIP merges
file (``nuwa_tpu_torch/data/bpe_simple_vocab_16e6.txt.gz``, Apache-licensed
upstream data from openai/CLIP) and uses it by default. Pass ``bpe_path`` to
substitute any CLIP-format merges file (plain or gzipped), or
``bpe_path=False`` for a pure byte-level vocab (514 symbols).
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from pathlib import Path

import numpy as np


@lru_cache()
def bytes_to_unicode():
    """Invertible byte -> printable-unicode map (GPT-2/CLIP standard)."""
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


def get_pairs(word):
    return {(a, b) for a, b in zip(word, word[1:])}


def basic_clean(text):
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:  # optional dependency
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text):
    return re.sub(r"\s+", " ", text).strip()


try:  # CLIP's exact unicode word pattern needs the `regex` module
    import regex as _re

    _TOKEN_PATTERN = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _re.IGNORECASE,
    )
except ImportError:  # ASCII fallback
    _TOKEN_PATTERN = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )


def default_bpe_path():
    """The vendored CLIP merges asset, or None if absent from the install."""
    p = Path(__file__).parent / "data" / "bpe_simple_vocab_16e6.txt.gz"
    return p if p.exists() else None


class SimpleTokenizer:
    def __init__(self, bpe_path=None, special_tokens=("<|startoftext|>", "<|endoftext|>")):
        if bpe_path is None:
            bpe_path = default_bpe_path()
        elif bpe_path is False:
            bpe_path = None
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        base = list(self.byte_encoder.values())
        vocab = base + [c + "</w>" for c in base]

        merges = []
        if bpe_path is not None:
            bpe_path = Path(bpe_path)
            raw = (
                gzip.open(bpe_path, "rt", encoding="utf-8").read()
                if bpe_path.suffix == ".gz"
                else bpe_path.read_text(encoding="utf-8")
            )
            lines = raw.split("\n")
            # CLIP format: header line, then merges; reference slices
            # [1:49152-256-2+1]
            merges = [
                tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]
                if len(line.split()) == 2
            ]
            vocab.extend("".join(m) for m in merges)

        vocab.extend(special_tokens)
        self.vocab = vocab
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.special_tokens = special_tokens
        self.cache = {t: t for t in special_tokens}

    @property
    def vocab_size(self):
        return len(self.vocab)

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out
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

    def encode(self, text):
        tokens = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _TOKEN_PATTERN.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def decode(self, token_ids, remove_start_end=True, pad_tokens=frozenset()):
        token_ids = [int(t) for t in np.asarray(token_ids).reshape(-1)]
        if remove_start_end:
            specials = {self.encoder.get(s) for s in self.special_tokens}
            token_ids = [t for t in token_ids if t not in specials and t != 0]
        token_ids = [t for t in token_ids if t not in pad_tokens]
        text = "".join(self.decoder.get(t, "") for t in token_ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts, context_length=256, truncate_text=False):
        if isinstance(texts, str):
            texts = [texts]
        all_tokens = [self.encode(t) for t in texts]
        out = np.zeros((len(all_tokens), context_length), dtype=np.int64)
        for i, toks in enumerate(all_tokens):
            if len(toks) > context_length:
                if truncate_text:
                    toks = toks[:context_length]
                else:
                    raise RuntimeError(
                        f"input {texts[i]} too long for context length {context_length}"
                    )
            out[i, : len(toks)] = toks
        return out


# module-level singleton: CLIP vocab 49408 out of the box (vendored merges),
# byte-level fallback only if the data asset is missing from the install.
# Built lazily on first attribute access (PEP 562): parsing the 1.3 MB
# gzipped merges file (49k-entry BPE table) is too costly to pay at
# ``import nuwa_tpu`` for code paths that never tokenize text.
_tokenizer_singleton = None


def _get_tokenizer():
    global _tokenizer_singleton
    if _tokenizer_singleton is None:
        _tokenizer_singleton = SimpleTokenizer()
    return _tokenizer_singleton


def __getattr__(name):
    if name == "tokenizer":
        return _get_tokenizer()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
