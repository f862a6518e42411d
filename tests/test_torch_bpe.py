"""The port's byte-level BPE (``eda_tpu_torch.data.bpe``) against the JAX package's.

* ids, masks, offsets, ``char_to_token`` and lengths equal to
  ``eda_tpu.models.bpe.BPETokenizer``'s, with a char-level vocabulary, the
  fabricated vocabulary of ``real_data_fixtures.write_bpe_vocab`` and a vocabulary
  trained here with ``tokenizers``, at ``max_len`` 256 and a truncating 16, on
  EDA-style utterances and non-ASCII text; ``tokenizer.json`` loads too;
* the pre-tokenizer, ``re`` with spelled-out classes, splits arbitrary Unicode
  text as ``regex.findall(_GPT2_PAT, s)`` does (hypothesis), and its class
  table equals the ``regex`` module's classes over every code point;
* the module builds and encodes with ``regex`` unimportable;
* ``make_tokenizer`` picks the BPE, then HF, then the hash tokenizer, as JAX's does.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import regex
from hypothesis import given, settings, strategies as st

import real_data_fixtures
from eda_tpu.models import bpe as jax_bpe
from eda_tpu.models.tokenizer import make_tokenizer as jax_make_tokenizer
from eda_tpu_torch.data import bpe, unicode_classes
from eda_tpu_torch.data.tokenizer import SimpleTokenizer, make_tokenizer

ROOT = Path(__file__).resolve().parents[1]

CORPUS = [
    "this is a brown wooden chair. it is next to the table. . not mentioned",
    "the black office chair on the left of the desk near the window.",
    "it's the couch that is farthest from the kitchen counter",
    "the monitor on the desk. there are 2 monitors, pick the left one.",
    "chair . table . window . door . couch . bed . sofa . desk",
    "the    chair   with   extra   spaces",
    "  leading and trailing  ",
    "tab\tseparated\nand newline\r\n",
    "café au lait décor naïve Ⅻ ² ½ ٣ 中文字 ﬁ x́  nbsp 　ideo",
    "don't can't won't it's we're you'll i'd they've i'm 'S 'LL",
    "123 4567 12.5 meters 2nd 3rd",
    "!!! ??? ... --- ,,, \x1c\x1f",
    "",
    " ",
    "the round table near the whiteboard easel is off-white in color.",
    "this is a long utterance " * 20,
]


def class_ranges(pattern: str):
    """(first, last) code-point runs that ``regex`` puts in ``pattern``'s class."""
    compiled = regex.compile(pattern)
    out, start = [], None
    for cp in range(0x110001):
        inside = cp < 0x110000 and bool(compiled.match(chr(cp)))
        if inside and start is None:
            start = cp
        if not inside and start is not None:
            out.append((start, cp - 1))
            start = None
    return tuple(out)


def test_class_table_equals_regex():
    """The committed table is the ``regex`` module's classes (regenerate it with
    ``class_ranges`` on a newer Unicode version)."""
    assert unicode_classes.LETTER == class_ranges(r"\p{L}")
    assert unicode_classes.NUMBER == class_ranges(r"\p{N}")
    assert unicode_classes.SPACE == class_ranges(r"\s")


CATEGORIES = ("Lu", "Ll", "Lo", "Lm", "Nd", "Nl", "No", "Mn", "Mc", "Zs", "Zl", "Zp", "Cc",
              "Pd", "Po", "Sm", "So", "Cn", "Co")
pieces = st.one_of(
    st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", " ", "  ", "\t", "\n",
                     "\x1c", "\x85", " ", " ", "　", "²", "Ⅻ", "x́"]),
    st.characters(categories=CATEGORIES),
    st.characters(),
)


@settings(max_examples=600, deadline=None)
@given(st.lists(pieces, max_size=24).map("".join))
def test_pre_tokenizer_equals_regex(text):
    got = bpe.pre_tokenizer().findall(text)
    assert got == regex.findall(jax_bpe._GPT2_PAT, text)
    assert "".join(got) == text


def char_vocab(d: Path) -> Path:
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in sorted(bpe._bytes_to_unicode().values()):
        vocab[ch] = len(vocab)
    vocab["<mask>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return d


def trained_vocab(d: Path) -> Path:
    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer(tokenizers.models.BPE(unk_token=None))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=600, special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet(), show_progress=False)
    tok.train_from_iterator(CORPUS * 50, trainer)
    model = json.loads(tok.to_str())["model"]
    (d / "vocab.json").write_text(json.dumps(model["vocab"]))
    merges = [m if isinstance(m, str) else " ".join(m) for m in model["merges"]]
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    tok.save(str(d / "tokenizer.json"))
    return d


def fixture_vocab(d: Path) -> Path:
    real_data_fixtures.write_bpe_vocab(d, real_data_fixtures.fixture_corpus() + CORPUS)
    return d


VOCABS = {"char": char_vocab, "fixture": fixture_vocab, "trained": trained_vocab}


@pytest.fixture(params=sorted(VOCABS), scope="module")
def vocab_dir(request, tmp_path_factory):
    return VOCABS[request.param](tmp_path_factory.mktemp(f"bpe_{request.param}"))


@pytest.mark.parametrize("max_len", [16, 256])
def test_encode_batch_equals_jax(vocab_dir, max_len):
    got = bpe.BPETokenizer.from_pretrained(str(vocab_dir)).encode_batch(CORPUS, max_len=max_len)
    want = jax_bpe.BPETokenizer.from_pretrained(str(vocab_dir)).encode_batch(CORPUS,
                                                                             max_len=max_len)
    for name in ("input_ids", "attention_mask", "lengths"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.offsets == want.offsets
    for b, text in enumerate(CORPUS):
        for c in range(-1, len(text) + 1):
            assert got.char_to_token(b, c) == want.char_to_token(b, c)
    if max_len == 16:
        assert (got.lengths == 16).any()  # the long utterances truncate


def test_tokenizer_json_loads_as_jax(tmp_path):
    d = trained_vocab(tmp_path)
    (d / "vocab.json").unlink()
    got = bpe.BPETokenizer.from_pretrained(str(d)).encode_batch(CORPUS)
    want = jax_bpe.BPETokenizer.from_pretrained(str(d)).encode_batch(CORPUS)
    assert np.array_equal(got.input_ids, want.input_ids) and got.offsets == want.offsets
    assert bpe.load_bpe(str(tmp_path / "missing")) is None


def test_make_tokenizer_prefers_bpe_then_hash(tmp_path):
    d = char_vocab(tmp_path)
    assert isinstance(make_tokenizer(str(d)), bpe.BPETokenizer)
    assert type(jax_make_tokenizer(str(d))).__name__ == "BPETokenizer"
    empty = tmp_path / "empty"
    empty.mkdir()
    assert isinstance(make_tokenizer(str(empty), vocab_size=512), SimpleTokenizer)
    assert type(jax_make_tokenizer(str(empty), vocab_size=512)).__name__ == "SimpleTokenizer"
    assert isinstance(make_tokenizer(None), SimpleTokenizer)


def test_bpe_needs_no_regex(tmp_path):
    """Built and used with ``regex``, ``transformers`` and ``tokenizers`` unimportable."""
    d = fixture_vocab(tmp_path)
    want = jax_bpe.BPETokenizer.from_pretrained(str(d)).encode_batch(CORPUS)
    code = (
        "import sys, json\n"
        "for name in ('regex', 'transformers', 'tokenizers'):\n"
        "    sys.modules[name] = None\n"
        "from eda_tpu_torch.data.tokenizer import make_tokenizer\n"
        f"tok = make_tokenizer({str(d)!r})\n"
        f"out = tok.encode_batch(json.loads({json.dumps(json.dumps(CORPUS))}))\n"
        "print(type(tok).__name__, json.dumps(out.input_ids.tolist()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    name, ids = out.stdout.split(" ", 1)
    assert name == "BPETokenizer"
    assert np.array_equal(np.array(json.loads(ids), np.int32), want.input_ids)
