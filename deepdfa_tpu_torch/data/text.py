"""Text pipeline for the transformer models (port of
``deepdfa_tpu/data/text.py``, the parts the LineVul path runs).

Reference semantics: tokenize the function, truncate to
``block_size - 2`` tokens, wrap with <s>/</s>, pad with the pad id to
``block_size``; the attention mask is ``ids != pad``. Tokenizers:
``data/bpe.py``'s :class:`ByteLevelBPE` over trained byte-level BPE
assets, in plain Python (``load_bpe_tokenizer``: a ``tokenizer.json``, or
a ``<prefix>-vocab.json`` + ``<prefix>-merges.txt`` pair); or :class:`HashingCodeTokenizer` (identifier, number and operator
tokens hashed into a fixed vocabulary), the reference's sample mode. The
CodeT5 encoding waits for its slice.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from deepdfa_tpu_torch.data.bpe import ByteLevelBPE

# RoBERTa special-token convention (codebert/unixcoder share it).
CLS_ID = 0
PAD_ID = 1
SEP_ID = 2
UNK_ID = 3
_N_SPECIAL = 4

_TOKEN_RE = re.compile(
    r"[A-Za-z_]\w*|0x[0-9a-fA-F]+|\d+\.?\d*|->|<<|>>|[^\sA-Za-z0-9_]")


class HashingCodeTokenizer:
    """Deterministic, vocabulary-free code tokenizer."""

    cls_token_id = CLS_ID
    sep_token_id = SEP_ID
    pad_token_id = PAD_ID
    _n_special = _N_SPECIAL  # ids below this are the special tokens

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size

    def tokenize(self, text: str) -> List[str]:
        return _TOKEN_RE.findall(text)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        out = []
        for t in tokens:
            h = int.from_bytes(hashlib.blake2s(t.encode(),
                                               digest_size=4).digest(),
                               "little")
            out.append(self._n_special + h % (self.vocab_size
                                              - self._n_special))
        return out


# The reference's name for its tokenizer over BPE assets.
BPETokenizerAdapter = ByteLevelBPE


def check_tok_vocab(tok, vocab: int, pad_id=None, eos_id=None) -> None:
    """Tokenizer/model compatibility: the ids must fit the embedding
    table and the special-token conventions agree (rows are padded with
    the tokenizer's pad id but masked with the model's)."""
    if tok is None:
        return
    if tok.vocab_size > vocab:
        raise ValueError(
            f"tokenizer vocab {tok.vocab_size} exceeds the model's "
            f"embedding table ({vocab}) — ids would index out of bounds")
    if pad_id is not None and tok.pad_token_id != pad_id:
        raise ValueError(
            f"tokenizer pad id {tok.pad_token_id} != model pad id {pad_id}")
    if eos_id is not None and tok.eos_token_id != eos_id:
        raise ValueError(
            f"tokenizer eos id {tok.eos_token_id} != model eos id {eos_id}")


def load_bpe_tokenizer(path: str) -> ByteLevelBPE:
    """Trained tokenizer assets: a ``tokenizer.json`` file, a directory
    holding one, or a directory with one ``<prefix>-vocab.json`` +
    ``<prefix>-merges.txt`` pair (two pairs are ambiguous and raise)."""
    import glob
    import os

    if os.path.isfile(path):
        return ByteLevelBPE.from_tokenizer_json(path)
    tj = os.path.join(path, "tokenizer.json")
    if os.path.exists(tj):
        return ByteLevelBPE.from_tokenizer_json(tj)

    def prefix(p, suffix):
        return os.path.basename(p)[: -len(suffix)]

    vocabs = {prefix(p, "vocab.json"): p
              for p in glob.glob(os.path.join(path, "*vocab.json"))}
    merges = {prefix(p, "merges.txt"): p
              for p in glob.glob(os.path.join(path, "*merges.txt"))}
    pairs = sorted(set(vocabs) & set(merges))
    if len(pairs) > 1:
        raise ValueError(
            f"ambiguous tokenizer assets under {path!r}: prefixes {pairs}")
    if pairs:
        return ByteLevelBPE.from_pair(vocabs[pairs[0]], merges[pairs[0]])
    raise FileNotFoundError(
        f"no tokenizer assets under {path!r} (want tokenizer.json or a "
        "matching *vocab.json + *merges.txt pair)")


def encode_function(code: str, tokenizer, block_size: int = 512) -> np.ndarray:
    """<s> + tokens[:block_size - 2] + </s>, padded to ``block_size``."""
    tokens = tokenizer.tokenize(str(code))[: block_size - 2]
    ids = ([tokenizer.cls_token_id] + tokenizer.convert_tokens_to_ids(tokens)
           + [tokenizer.sep_token_id])
    ids = ids + [tokenizer.pad_token_id] * (block_size - len(ids))
    return np.asarray(ids, np.int32)


def encode_dataset(examples: Sequence[Mapping], tokenizer,
                   block_size: int = 512) -> Dict[str, np.ndarray]:
    """Batch-encode ``ex["code"]`` in the roberta style to
    ``{input_ids [N, block], labels [N], index [N]}``."""
    ids = np.stack([encode_function(ex["code"], tokenizer, block_size)
                    for ex in examples])
    labels = np.asarray([int(ex["label"]) for ex in examples], np.int32)
    index = np.asarray([int(ex["id"]) for ex in examples], np.int64)
    return {"input_ids": ids, "labels": labels, "index": index}


_VULN_CALLS = ["strcpy", "memcpy", "sprintf", "gets", "system"]
_SAFE_CALLS = ["strncpy", "snprintf", "fgets", "calloc", "strnlen"]


def synthetic_function_text(ex: Mapping,
                            rng: Optional[np.random.Generator] = None) -> str:
    """A C-like function whose text correlates with the planted graph
    label: a learnable sample-mode signal for the text models."""
    rng = rng or np.random.default_rng(int(ex["id"]))
    n = int(ex["num_nodes"])
    calls = _VULN_CALLS if ex["label"] else _SAFE_CALLS
    body = []
    for i in range(min(n, 12)):
        v = f"v{i}"
        kind = rng.integers(0, 3)
        if kind == 0:
            body.append(f"  int {v} = {int(rng.integers(0, 100))};")
        elif kind == 1:
            body.append(f"  {v} = {calls[int(rng.integers(0, len(calls)))]}"
                        "(buf, src);")
        else:
            body.append(f"  if ({v} > {int(rng.integers(1, 64))}) "
                        f"return {v};")
    name = f"func_{int(ex['id'])}"
    return ("int " + name + "(char *buf, char *src) {\n" + "\n".join(body)
            + "\n  return 0;\n}")


def attach_synthetic_text(examples: List[Dict], seed: int = 0) -> List[Dict]:
    for ex in examples:
        ex["code"] = synthetic_function_text(
            ex, np.random.default_rng((seed, int(ex["id"]))))
    return examples
