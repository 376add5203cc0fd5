"""Text pipeline for the transformer models (port of
``deepdfa_tpu/data/text.py``, the parts the LineVul path runs).

Reference semantics: tokenize the function, truncate to
``block_size - 2`` tokens, wrap with <s>/</s>, pad with the pad id to
``block_size``; the attention mask is ``ids != pad``. The port has no
pretrained vocabulary yet, so :class:`HashingCodeTokenizer` (identifier,
number and operator tokens hashed into a fixed vocabulary) stands in, as
it does in the reference's sample mode. The BPE adapter and the CodeT5
encoding wait for their slices.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

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
