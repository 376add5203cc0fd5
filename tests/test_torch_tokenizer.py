"""The port's byte-level BPE (deepdfa_tpu_torch/data/bpe.py behind
``data/text.load_bpe_tokenizer``) against HuggingFace ``tokenizers``, as
the JAX package's ``load_bpe_tokenizer`` drives it.

Assets come from the JAX package's ``etl/tokenizer_train.train_bpe``
(the ``<prefix>-vocab.json`` + ``<prefix>-merges.txt`` pair) and from a
trained ``ByteLevelBPETokenizer`` saved as ``tokenizer.json`` with added
tokens (``lstrip``/``rstrip``, special and normalized). Hypothesis
draws code-like and Unicode text: letters and marks, CJK and
Arabic-Indic numerals (``str.isalpha`` and ``isnumeric`` disagree with
the pattern's ``\\p{L}``/``\\p{N}`` on some), whitespace runs of every
kind, contractions, and added tokens inside the text. Tokens and ids
must be equal, and ``encode_dataset`` byte for byte.
"""

import json
import os

import pytest

pytest.importorskip("jax")
pytest.importorskip("tokenizers")
torch = pytest.importorskip("torch")
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.etl.tokenizer_train import train_bpe
from deepdfa_tpu_torch.core.config import FeatureSpec
from deepdfa_tpu_torch.data import bpe
from deepdfa_tpu_torch.data import text as ptext
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul

# Text pieces the corpus and the drawn strings share, so merges apply.
PIECES = [
    "int", " x", " = ", "0x1F", "->", "buf", "[i]", ";", "\n", "\t", "  ",
    "   ", "\r\n", "'s", "'ll", "'re", "'d", "'t", "'ve", "'m", "'x",
    "strcpy(", "memcpy", "é", "ñ", "Ω", "ß", "é", "一二三", "〇",
    "٣٤", "½", "²", "Ⅻ", "变量", "　", "\xa0", " ", "\x85",
    "🙂", "$", "#", "...", "__", "a1", "1a", "12.5", " ", "<s>", "</s>",
    "<pad>", "<mask>", "<unk>", "ok", "zz",
]
TEXT = st.one_of(
    st.lists(st.sampled_from(PIECES), max_size=24).map("".join),
    st.text(alphabet=st.characters(
        blacklist_categories=("Cs",), max_codepoint=0x2FFFF), max_size=40),
)


def _corpus(d):
    exs = ptext.attach_synthetic_text(
        synthetic_bigvul(60, FeatureSpec(limit_all=30), seed=0), seed=0)
    path = os.path.join(d, "corpus.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(ex["code"] for ex in exs))
        f.write("\n" + " ".join(PIECES) * 3)
    return path, exs


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(pair dir, tokenizer.json path, synthetic examples)."""
    from tokenizers import AddedToken, ByteLevelBPETokenizer

    d = str(tmp_path_factory.mktemp("bpe"))
    corpus, exs = _corpus(d)
    pair = os.path.join(d, "pair")
    train_bpe([corpus], pair, prefix="codet5", vocab_size=600,
              min_frequency=2)
    tok = ByteLevelBPETokenizer()
    tok.train([corpus], vocab_size=600, min_frequency=2, special_tokens=[
        "<s>", "<pad>", "</s>", "<unk>",
        AddedToken("<mask>", lstrip=True, special=True)])
    tok.add_tokens(["ok", AddedToken("zz", rstrip=True)])
    tj = os.path.join(d, "tokenizer.json")
    tok.save(tj)
    return pair, tj, exs


def _both(path):
    return jtext.load_bpe_tokenizer(path), ptext.load_bpe_tokenizer(path)


def _assert_same(j, p, text):
    jt, pt = j.tokenize(text), p.tokenize(text)
    assert pt == jt, (text, jt, pt)
    assert p.convert_tokens_to_ids(pt) == j.convert_tokens_to_ids(jt)


def test_special_ids_and_vocab_size_match(assets):
    pair, tj, _ = assets
    for path in (pair, tj):
        j, p = _both(path)
        for attr in ("vocab_size", "pad_token_id", "cls_token_id",
                     "sep_token_id", "bos_token_id", "eos_token_id",
                     "unk_token_id"):
            assert getattr(p, attr) == getattr(j, attr), (path, attr)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_pair_assets_match_tokenizers(assets, text):
    j, p = _both(assets[0])
    _assert_same(j, p, text)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_tokenizer_json_matches_tokenizers(assets, text):
    j, p = _both(assets[1])
    _assert_same(j, p, text)


@pytest.mark.parametrize("text", [
    "", " ", "  leading", "trailing  ", "a  b", "a\t\tb", " <mask> x<mask>",
    "<s></s><pad>", "okzz  q ok", "x zz\n\ny", "it's we'll they're",
    "  ", "〇一二三四", "x́́", "\r\n\r\n  int",
])
def test_edge_cases_match_tokenizers(assets, text):
    for path in assets[:2]:
        j, p = _both(path)
        _assert_same(j, p, text)


def test_string_merges_read_as_list_merges(assets, tmp_path):
    """Older ``tokenizers`` write merges as "a b" strings, newer as
    two-element lists; both read the same."""
    with open(assets[1], encoding="utf-8") as f:
        doc = json.load(f)
    assert isinstance(doc["model"]["merges"][0], list)
    doc["model"]["merges"] = [" ".join(m) for m in doc["model"]["merges"]]
    old = tmp_path / "tokenizer.json"
    old.write_text(json.dumps(doc), encoding="utf-8")
    j, p = _both(str(old))
    new = ptext.load_bpe_tokenizer(assets[1])
    for text in ("int main(void) { return 0; }", "ok <mask> zz  é"):
        _assert_same(j, p, text)
        assert p.tokenize(text) == new.tokenize(text)


def test_encode_dataset_matches_jax(assets):
    for path in assets[:2]:
        j, p = _both(path)
        exs = assets[2]
        want = jtext.encode_dataset(exs, j, block_size=64)
        got = ptext.encode_dataset(exs, p, block_size=64)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (path, k)


def test_decode_matches_jax(assets):
    for path in assets[:2]:
        j, p = _both(path)
        text = "int x = strcpy(buf, é一); <mask> ok"
        ids = j.convert_tokens_to_ids(j.tokenize(text))
        assert p.decode(ids) == j.decode(ids)


def test_asset_refusals_match_jax(assets, tmp_path):
    pair = assets[0]
    two = tmp_path / "two"
    two.mkdir()
    for name in os.listdir(pair):
        with open(os.path.join(pair, name), "rb") as f:
            data = f.read()
        for prefix in ("a", "b"):
            (two / name.replace("codet5", prefix)).write_bytes(data)
    for path, err in ((str(two), ValueError),
                      (str(tmp_path / "none"), FileNotFoundError)):
        (tmp_path / "none").mkdir(exist_ok=True)
        with pytest.raises(err) as want:
            jtext.load_bpe_tokenizer(path)
        with pytest.raises(err) as got:
            ptext.load_bpe_tokenizer(path)
        assert str(got.value) == str(want.value)


def test_check_tok_vocab_matches_jax(assets):
    """The reference's SPECIAL_TOKENS order puts <pad> at 0, which a
    codebert model (pad id 1) refuses; roberta-order assets pass."""
    j, p = _both(assets[0])
    assert p.pad_token_id == 0
    for kw in (dict(vocab=50265, pad_id=1), dict(vocab=10, pad_id=0),
               dict(vocab=50265, pad_id=0, eos_id=7),
               dict(vocab=50265, pad_id=0, eos_id=2)):
        outcome = []
        for mod, tok in ((jtext, j), (ptext, p)):
            try:
                mod.check_tok_vocab(tok, **kw)
                outcome.append("ok")
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], kw
    pt = ptext.load_bpe_tokenizer(assets[1])
    assert pt.pad_token_id == 1
    ptext.check_tok_vocab(pt, 50265, pad_id=1)


def test_bytes_to_unicode_is_gpt2s():
    table = bpe.bytes_to_unicode()
    assert len(table) == len(set(table.values())) == 256
    assert table[ord("A")] == "A" and table[ord(" ")] == "Ġ"
    assert table[ord("\n")] == "Ċ"


def test_per_word_cache_keeps_words_once(assets):
    p = ptext.load_bpe_tokenizer(assets[1])
    text = " ".join(["strcpy(buf, src);"] * 200)
    first = p.tokenize(text)
    cached = len(p._cache)
    assert p.tokenize(text) == first
    assert len(p._cache) == cached <= 8


def test_unsupported_assets_raise(tmp_path, assets):
    with open(assets[1], encoding="utf-8") as f:
        doc = json.load(f)
    for key, value in (("normalizer", {"type": "Lowercase"}),
                       ("pre_tokenizer", {"type": "Whitespace"})):
        bad = dict(doc, **{key: value})
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps(bad), encoding="utf-8")
        with pytest.raises(ValueError, match="not"):
            ptext.load_bpe_tokenizer(str(path))
