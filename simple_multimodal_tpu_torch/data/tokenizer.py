"""Host-side text tokenization (port of simple_multimodal_tpu/data/tokenizer.py).

``HashTokenizer`` gives the same ids as the JAX package's: DeBERTa-v2/v3 id
conventions (PAD=0 CLS=1 SEP=2 UNK=3, vocab 128100), words lowercased, split
on non-alphanumeric boundaries and hashed with blake2b into
[100, vocab_size). The device only sees fixed-shape [B, max_length] int32
buffers.
"""
import hashlib
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
_NUM_SPECIAL = 100  # reserve low ids like sentencepiece does

_WORD_RE = re.compile(r"[a-z0-9]+|[^a-z0-9\s]")


class HashTokenizer:
    """Deterministic hashing tokenizer with a DeBERTa-style interface,
    stable across processes and platforms."""

    def __init__(self, vocab_size: int = 128100, model_max_length: int = 512):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.pad_token_id = PAD_ID
        self.cls_token_id = CLS_ID
        self.sep_token_id = SEP_ID
        self.unk_token_id = UNK_ID
        self._cache: Dict[str, int] = {}

    def _word_id(self, word: str) -> int:
        wid = self._cache.get(word)
        if wid is None:
            h = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
            span = self.vocab_size - _NUM_SPECIAL
            wid = _NUM_SPECIAL + int.from_bytes(h, "little") % span
            self._cache[word] = wid
        return wid

    def encode(self, text: str) -> List[int]:
        words = _WORD_RE.findall(str(text).lower())
        return [self._word_id(w) for w in words]

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        truncation: bool = True,
        padding: str = "max_length",
        max_length: Optional[int] = None,
        return_tensors: str = "np",
    ) -> Dict[str, np.ndarray]:
        texts = [text] if isinstance(text, str) else list(text)
        max_length = max_length or self.model_max_length
        input_ids = np.full((len(texts), max_length), PAD_ID, dtype=np.int32)
        attention_mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            if truncation:
                ids = ids[: max_length - 2]
            seq = [CLS_ID] + ids + [SEP_ID]
            input_ids[i, : len(seq)] = seq
            attention_mask[i, : len(seq)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def get_tokenizer(model_name: str, max_length: int = 512,
                  spm_path: Optional[str] = None):
    """The port's tokenizer: ``HashTokenizer``. The sentencepiece reader is
    not ported yet (ROADMAP Queue 1, 'Host data path'), so an explicit
    ``spm_path`` raises instead of silently giving other ids."""
    if spm_path:
        raise NotImplementedError(
            "SpmTokenizer is not ported yet (ROADMAP Queue 1, 'Host data "
            "path'); drop spm_model_path to use HashTokenizer")
    return HashTokenizer(model_max_length=max_length)
