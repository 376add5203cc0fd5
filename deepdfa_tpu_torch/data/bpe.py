"""A byte-level BPE tokenizer in plain Python.

It reads the assets that HuggingFace's ``tokenizers`` writes and encodes
text to the same tokens and ids as ``Tokenizer.encode(text,
add_special_tokens=False)`` (tests/test_torch_tokenizer.py holds the two
equal), so the port needs no ``tokenizers``, ``transformers`` or
``regex`` package. The pipeline is that of a ``ByteLevelBPETokenizer``:

1. **Added tokens** (a ``tokenizer.json``'s ``added_tokens``) are cut out
   of the text first, leftmost-longest, the ones matched on raw text
   before the ``normalized`` ones, with their ``lstrip``/``rstrip``
   whitespace.
2. **The ByteLevel pre-tokenizer** splits each remaining piece with
   GPT-2's pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
   ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, matched here by hand: letters and
   numbers are classified by ``unicodedata.category`` (L*, N*), not by
   ``str.isalpha``/``isnumeric`` (CJK numerals are both), and ``\\s`` is
   Unicode's White_Space. Each word's UTF-8 bytes map to GPT-2's
   byte-to-unicode alphabet.
3. **BPE** merges each word as ``tokenizers`` does: a queue ordered by
   (merge rank, position), re-checked as neighbours merge. A per-word
   cache keeps a Big-Vul-sized corpus from paying for a word twice.

Settings of a ``tokenizer.json`` that this pipeline does not compute (a
normalizer, another pre-tokenizer, ``use_regex`` off, continuing-subword
prefixes, ``ignore_merges``, dropout, ``single_word`` added tokens)
raise.
"""

from __future__ import annotations

import heapq
import json
import unicodedata
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

# Unicode White_Space (Rust's char::is_whitespace; Oniguruma's \s for
# UTF-8 is the same set).
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's table: each byte to a printable character (printable
    Latin-1 bytes to themselves, the rest to U+0100 onwards)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_CHARS = bytes_to_unicode()
_CHAR_BYTES = {c: b for b, c in _BYTE_CHARS.items()}

# Character classes of the pattern: "L" letter, "N" number, "S" space,
# "O" anything else.
_CLASS_CACHE: Dict[str, str] = {}


def _char_class(ch: str) -> str:
    cls = _CLASS_CACHE.get(ch)
    if cls is None:
        if ch in _WHITESPACE:
            cls = "S"
        else:
            cat = unicodedata.category(ch)[0]
            cls = cat if cat in ("L", "N") else "O"
        _CLASS_CACHE[ch] = cls
    return cls


def _run(classes: Sequence[str], i: int, cls: str) -> int:
    """End of the run of ``cls`` characters from ``i``."""
    while i < len(classes) and classes[i] == cls:
        i += 1
    return i


def split_words(text: str) -> List[str]:
    """GPT-2's pre-tokenizer pattern over ``text``: the matches, in
    order (they cover the text)."""
    classes = [_char_class(c) for c in text]
    n = len(text)
    out: List[str] = []
    i = 0
    while i < n:
        end = 0
        if text[i] == "'":
            for c in _CONTRACTIONS:
                if text.startswith(c, i):
                    end = i + len(c)
                    break
        if not end:
            for cls in ("L", "N", "O"):
                start = i + 1 if (text[i] == " " and i + 1 < n
                                  and classes[i + 1] == cls) else i
                if classes[start] == cls:
                    end = _run(classes, start, cls)
                    break
        if not end:
            # \s+(?!\S), else \s+: a whitespace run followed by a
            # non-space gives its last character to the next word.
            run = _run(classes, i, "S")
            end = run if run == n or run - i == 1 else run - 1
        out.append(text[i:end])
        i = end
    return out


class ByteLevelBPE:
    """The BPE model, the added tokens and the ByteLevel pre-tokenizer
    of one asset set (see the module docstring), behind the port's
    tokenizer protocol: ``tokenize``, ``convert_tokens_to_ids``,
    ``vocab_size`` and the special-token ids, which come from the
    assets' roberta (``<pad>``) or bert (``[PAD]``) names."""

    def __init__(self, vocab: Mapping[str, int],
                 merges: Iterable[Tuple[str, str]],
                 added_tokens: Sequence[Mapping] = (),
                 add_prefix_space: bool = False,
                 unk_token: Optional[str] = None):
        self.vocab = {str(k): int(v) for k, v in vocab.items()}
        self.unk_token = unk_token
        self.add_prefix_space = add_prefix_space
        # (left id, right id) -> (rank, merged id)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            for part in (a, b, a + b):
                if part not in self.vocab:
                    raise ValueError(f"merge {a!r} {b!r}: {part!r} is not "
                                     "in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (
                rank, self.vocab[a + b])
        self.added = [dict(t) for t in added_tokens]
        self.added_ids = {t["content"]: int(t["id"]) for t in self.added}
        self.special = {t["content"] for t in self.added if t.get("special")}
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added_ids.items()})
        self._cache: Dict[str, Tuple[str, ...]] = {}
        self.vocab_size = len(set(self.vocab) | set(self.added_ids))

        def tid(*names, default):
            for n in names:
                i = self._token_id(n)
                if i is not None:
                    return i
            return default

        self.pad_token_id = tid("<pad>", "[PAD]", default=0)
        self.bos_token_id = self.cls_token_id = tid("<s>", "[CLS]", default=1)
        self.eos_token_id = self.sep_token_id = tid("</s>", "[SEP]", default=2)
        self.unk_token_id = tid("<unk>", "[UNK]", default=None)

    @classmethod
    def from_pair(cls, vocab_path: str, merges_path: str) -> "ByteLevelBPE":
        """A ``<prefix>-vocab.json`` + ``<prefix>-merges.txt`` pair, as
        ``ByteLevelBPETokenizer(vocab, merges)`` reads it (no added
        tokens)."""
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                if line.startswith("#version"):
                    continue
                line = line.rstrip("\r\n")
                if not line:
                    continue
                parts = line.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"{merges_path}:{n}: a merge is two "
                                     f"tokens, got {line!r}")
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "ByteLevelBPE":
        """A ``tokenizer.json`` of a byte-level BPE (its ``model.vocab``,
        ``model.merges`` and ``added_tokens``)."""
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        model = doc.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"{path}: model type {model.get('type')!r}, "
                             "not BPE")
        if doc.get("normalizer") is not None:
            raise ValueError(f"{path}: normalizers are not supported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix",
                    "dropout", "ignore_merges"):
            if model.get(key):
                raise ValueError(f"{path}: {key} is not supported")
        pre = doc.get("pre_tokenizer") or {}
        if pre.get("type") == "Sequence" and len(pre["pretokenizers"]) == 1:
            pre = pre["pretokenizers"][0]
        if pre.get("type") != "ByteLevel" or not pre.get("use_regex", True):
            raise ValueError(f"{path}: pre-tokenizer {pre}, not ByteLevel "
                             "with its regex")
        added = doc.get("added_tokens") or ()
        if any(t.get("single_word") for t in added):
            raise ValueError(f"{path}: single_word added tokens are not "
                             "supported")
        merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" "))
                  for m in model.get("merges", [])]
        if any(len(m) != 2 for m in merges):
            raise ValueError(f"{path}: a merge is two tokens")
        return cls(model["vocab"], merges, added,
                   add_prefix_space=bool(pre.get("add_prefix_space", False)),
                   unk_token=model.get("unk_token"))

    # -- the tokenizer protocol ------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        """The tokens of ``text``, as ``Tokenizer.encode(text,
        add_special_tokens=False)`` gives them: no template specials
        (``encode_function`` adds <s>/</s> itself)."""
        out: List[str] = []
        for piece, is_added in self._split_added(str(text)):
            if is_added:
                out.append(piece)
            elif piece:
                out.extend(self._encode_piece(piece))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        out = []
        for t in tokens:
            i = self._token_id(t)
            if i is None:
                if self.unk_token_id is None:
                    raise ValueError(
                        f"token {t!r} is not in the vocabulary and the "
                        "assets define no unk token")
                i = self.unk_token_id
            out.append(i)
        return out

    def decode(self, ids: Sequence[int]) -> str:
        """Ids -> text, special tokens skipped."""
        data = bytearray()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None or tok in self.special:
                continue
            if tok in self.added_ids:
                data += tok.encode("utf-8")
                continue
            for ch in tok:
                b = _CHAR_BYTES.get(ch)
                data += (bytes([b]) if b is not None
                         else ch.encode("utf-8"))
        return data.decode("utf-8", errors="replace")

    # -- the pipeline ----------------------------------------------------

    def _token_id(self, token: str) -> Optional[int]:
        if token in self.added_ids:
            return self.added_ids[token]
        return self.vocab.get(token)

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """``text`` cut into (piece, is_added_token): the tokens matched
        on raw text first, then the normalized ones in the gaps."""
        pieces = [(text, False)]
        for normalized in (False, True):
            group = [t for t in self.added
                     if bool(t.get("normalized", not t.get("special")))
                     == normalized]
            if not group:
                continue
            cut: List[Tuple[str, bool]] = []
            for piece, is_added in pieces:
                cut.extend([(piece, True)] if is_added
                           else self._match_added(piece, group))
            pieces = cut
        return pieces

    @staticmethod
    def _match_added(text: str, group: Sequence[Mapping]
                     ) -> List[Tuple[str, bool]]:
        by_first: Dict[str, List[Mapping]] = {}
        for t in sorted(group, key=lambda t: -len(t["content"])):
            if t["content"]:
                by_first.setdefault(t["content"][0], []).append(t)
        out: List[Tuple[str, bool]] = []
        start = i = 0
        n = len(text)
        while i < n:
            hit = None
            for t in by_first.get(text[i], ()):
                if text.startswith(t["content"], i):
                    hit = t
                    break
            if hit is None:
                i += 1
                continue
            lo, hi = i, i + len(hit["content"])
            if hit.get("lstrip"):
                while lo > start and text[lo - 1] in _WHITESPACE:
                    lo -= 1
            if hit.get("rstrip"):
                while hi < n and text[hi] in _WHITESPACE:
                    hi += 1
            if lo > start:
                out.append((text[start:lo], False))
            # The token is the span as cut, stripped whitespace included
            # (what ``Encoding.tokens`` reports).
            out.append((text[lo:hi], True))
            start = i = hi
        if start < n:
            out.append((text[start:], False))
        return out

    def _encode_piece(self, piece: str) -> List[str]:
        if self.add_prefix_space and not piece.startswith(" "):
            piece = " " + piece
        out: List[str] = []
        for word in split_words(piece):
            mapped = "".join(_BYTE_CHARS[b] for b in word.encode("utf-8"))
            toks = self._cache.get(mapped)
            if toks is None:
                toks = self._bpe(mapped)
                self._cache[mapped] = toks
            out.extend(toks)
        return out

    def _bpe(self, word: str) -> Tuple[str, ...]:
        ids: List[int] = []
        for ch in word:
            i = self.vocab.get(ch)
            if i is None:
                if self.unk_token is None or self.unk_token not in self.vocab:
                    continue  # tokenizers drops it without an unk token
                i = self.vocab[self.unk_token]
            ids.append(i)
        n = len(ids)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        queue = []
        for p in range(n - 1):
            m = self.merges.get((ids[p], ids[p + 1]))
            if m is not None:
                queue.append((m[0], p, m[1]))
        heapq.heapify(queue)
        while queue:
            rank, p, new_id = heapq.heappop(queue)
            if not alive[p] or nxt[p] >= n:
                continue
            q = nxt[p]
            m = self.merges.get((ids[p], ids[q]))
            if m is None or m[1] != new_id:
                continue  # an entry that a neighbour's merge outdated
            ids[p] = new_id
            alive[q] = False
            nxt[p] = nxt[q]
            if nxt[q] < n:
                prv[nxt[q]] = p
            if prv[p] >= 0:
                m = self.merges.get((ids[prv[p]], ids[p]))
                if m is not None:
                    heapq.heappush(queue, (m[0], prv[p], m[1]))
            if nxt[p] < n:
                m = self.merges.get((ids[p], ids[nxt[p]]))
                if m is not None:
                    heapq.heappush(queue, (m[0], p, m[1]))
        return tuple(self.id_to_token[ids[p]] for p in range(n) if alive[p])
