"""Port parity for the tokenizer: nuwa_tpu_torch.tokenizer against
nuwa_tpu.tokenizer, which it copies.

``encode``, ``decode`` and fixed-context ``tokenize`` give equal ids and
text for ASCII, accents, emoji, html entities, extra whitespace and
over-long text (``truncate_text`` on, and off, where both raise), with the
CLIP merges (vocab 49,408) and with ``bpe_path=False`` (514 byte symbols).
The port reads its own copy of the merges file, byte-identical to the JAX
package's.
"""
import importlib
from pathlib import Path

import numpy as np
import pytest

from nuwa_tpu import tokenizer as jtok

ttok = importlib.import_module("nuwa_tpu_torch.tokenizer")
REPO = Path(__file__).resolve().parents[1]
TEXTS = [
    "a red square slides to the right",
    "Café crème brûlée, naïve façade — déjà vu",
    "fireworks 🎆 over the sea 🌊 at night 🌙",
    "cats &amp; dogs &lt;3 &quot;running&quot; &#39;fast&#39;",
    "  lots   of\twhite \n\n space   ",
    "it's the end, isn't it? 12,345 frames!",
    "",
]
LONG = " ".join(["the quick brown fox jumps over the lazy dog"] * 8)


@pytest.fixture(scope="module", params=["clip", "bytes"])
def pair(request):
    kw = {} if request.param == "clip" else dict(bpe_path=False)
    return jtok.SimpleTokenizer(**kw), ttok.SimpleTokenizer(**kw)


def test_merges_file_is_a_byte_identical_copy():
    ported = REPO / "nuwa_tpu_torch" / "data" / "bpe_simple_vocab_16e6.txt.gz"
    assert ttok.default_bpe_path() == ported
    assert ported.read_bytes() == (REPO / "nuwa_tpu" / "data" / ported.name).read_bytes()


def test_vocab_sizes(pair):
    j, t = pair
    assert t.vocab_size == j.vocab_size
    assert t.vocab_size in (49408, 514)
    assert ttok.tokenizer.vocab_size == 49408
    import nuwa_tpu_torch

    assert nuwa_tpu_torch.tokenizer is ttok.tokenizer


def test_encode_and_decode_match(pair):
    j, t = pair
    for text in TEXTS + [LONG]:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids), text
        padded = np.array(ids + [0, 0, 0])
        assert t.decode(padded) == j.decode(padded)


def test_tokenize_matches(pair):
    j, t = pair
    for width in (8, 77):
        got = t.tokenize(TEXTS, context_length=width, truncate_text=True)
        np.testing.assert_array_equal(got, j.tokenize(TEXTS, context_length=width,
                                                      truncate_text=True))
        assert got.dtype == np.int64 and got.shape == (len(TEXTS), width)
    np.testing.assert_array_equal(t.tokenize(LONG, 16, truncate_text=True),
                                  j.tokenize(LONG, 16, truncate_text=True))
    for tok in (t, j):
        with pytest.raises(RuntimeError):
            tok.tokenize(LONG, 16, truncate_text=False)
