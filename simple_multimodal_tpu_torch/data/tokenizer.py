"""Host-side text tokenization (port of simple_multimodal_tpu/data/tokenizer.py).

``HashTokenizer`` gives the same ids as the JAX package's: DeBERTa-v2/v3 id
conventions (PAD=0 CLS=1 SEP=2 UNK=3, vocab 128100), words lowercased, split
on non-alphanumeric boundaries and hashed with blake2b into
[100, vocab_size). ``SpmTokenizer`` reads a local sentencepiece unigram
model (``data/spm.py``) under the same conventions. ``get_tokenizer``
resolves as the JAX function does, and warns once, loudly, when it falls
back to ``HashTokenizer``: its ids are not a pretrained DeBERTa's. The
device only sees fixed-shape [B, max_length] int32 buffers.
"""
import hashlib
import os
import re
import sys
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


class SpmTokenizer:
    """DeBERTa-v2/v3-convention tokenizer over a local sentencepiece model:
    [PAD]=0 [CLS]=1 [SEP]=2 [UNK]=3, piece ids used directly, as HF's
    DebertaV2Tokenizer applies them."""

    def __init__(self, spm_path: str, model_max_length: int = 512):
        from .spm import SentencePieceUnigram

        self.sp = SentencePieceUnigram.from_file(spm_path)
        self.vocab_size = max(self.sp.vocab_size, 4)
        self.model_max_length = model_max_length
        self.pad_token_id = PAD_ID
        self.cls_token_id = CLS_ID
        self.sep_token_id = SEP_ID
        self.unk_token_id = UNK_ID

    def encode(self, text: str) -> List[int]:
        return self.sp.encode(text)

    __call__ = HashTokenizer.__call__  # same batching/padding/CLS-SEP framing


def _find_spm_model(spm_path: Optional[str]) -> Optional[str]:
    for c in (spm_path, os.environ.get("SMM_SPM_MODEL")):
        if c and os.path.isfile(c):
            return c
    return None


def _hf_local(model_name: str) -> bool:
    """Whether ``model_name`` is a local directory or has an entry in a
    local HF hub cache: where neither holds, the HF tokenizer cannot load
    offline."""
    if os.path.isdir(model_name):
        return True
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache"), "huggingface")
    roots = [os.environ.get("HF_HUB_CACHE"), os.environ.get("TRANSFORMERS_CACHE"),
             os.path.join(home, "hub")]
    entry = "models--" + model_name.replace("/", "--")
    return any(r and os.path.isdir(os.path.join(r, entry)) for r in roots)


_warned_fallback = False


def _warn_fallback(model_name: str) -> None:
    global _warned_fallback
    if _warned_fallback:
        return
    _warned_fallback = True
    print(f"WARNING: no local tokenizer for {model_name!r} (no HF cache, no spm_model_path, "
          "no SMM_SPM_MODEL): text is tokenized by HashTokenizer, whose ids are not the "
          "pretrained model's", file=sys.stderr, flush=True)


def get_tokenizer(model_name: str, max_length: int = 512,
                  spm_path: Optional[str] = None):
    """The best locally available tokenizer, never touching the network,
    in the JAX package's order: (1) an HF tokenizer for ``model_name`` in a
    local cache; (2) a sentencepiece unigram model file (``spm_path`` or
    ``$SMM_SPM_MODEL``); (3) ``HashTokenizer``, with a warning printed once
    per process."""
    try:  # pragma: no cover - exercised only when a local HF cache exists
        if not _hf_local(model_name):
            raise FileNotFoundError(model_name)  # skips importing transformers (seconds)
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)

        class _HFWrapper:
            vocab_size = tok.vocab_size
            pad_token_id = tok.pad_token_id or 0

            def __call__(self, text, truncation=True, padding="max_length",
                         max_length=max_length, return_tensors="np"):
                enc = tok(list(text) if not isinstance(text, str) else text,
                          truncation=truncation, padding=padding,
                          max_length=max_length, return_tensors="np")
                return {"input_ids": enc["input_ids"].astype(np.int32),
                        "attention_mask": enc["attention_mask"].astype(np.int32)}

        return _HFWrapper()
    except Exception:
        pass
    found = _find_spm_model(spm_path)
    if found:
        try:
            return SpmTokenizer(found, model_max_length=max_length)
        except Exception as e:
            print(f"Warning: could not read spm model {found}: {e}")
    _warn_fallback(model_name)
    return HashTokenizer(model_max_length=max_length)
