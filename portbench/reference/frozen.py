"""Frozen copies of the conventions the reference has to share with the
system under test, so that it imports nothing of the program:

- the fused kernels' stateless dropout hash (a murmur3 finaliser over
  seed, head, query and key, in uint32 arithmetic carried in int64);
- DeBERTa's log-bucketed relative positions;
- the packed yuv420 video wire format (BT.601 full range);
- the hashing tokenizer (DeBERTa-v2 id conventions, blake2b word ids).

Each is data or a convention of the model's inputs, not a computation the
benchmark judges.
"""
import hashlib
import re

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_C1, _C2, _C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _mul(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_u32(seed, head, q, k):
    x = (_mul(q, _C1) + _mul(k, _C2)) & MASK32
    x = (x + _mul(head, _C3) + seed) & MASK32
    x = x ^ (x >> 16)
    x = _mul(x, _C2)
    x = x ^ (x >> 13)
    x = _mul(x, _C3)
    return x ^ (x >> 16)


def threshold(rate):
    return int(min(max(rate, 0.0), 1.0) * 4294967296.0) & MASK32


def _seed(seed, device):
    return torch.as_tensor(seed, device=device).reshape(()).to(torch.int64) & MASK32


def attention_keep(seed, B, H, Sq, Sk, rate, device):
    """Keep mask [B, H, Sq, Sk] of attention-probability dropout: head = b·H + h."""
    i64 = torch.int64
    b = torch.arange(B, dtype=i64, device=device)[:, None, None, None]
    h = torch.arange(H, dtype=i64, device=device)[None, :, None, None]
    q = torch.arange(Sq, dtype=i64, device=device)[None, None, :, None]
    k = torch.arange(Sk, dtype=i64, device=device)[None, None, None, :]
    return hash_u32(_seed(seed, device), b * H + h, q, k) >= threshold(rate)


def ffn_keep(seed, salt, B, S, C, rate, device):
    """Keep mask [B, S, C] of an FFN dropout (salt 1 after the GELU, 2 on the output)."""
    i64 = torch.int64
    b = torch.arange(B, dtype=i64, device=device)[:, None, None]
    s = torch.arange(S, dtype=i64, device=device)[None, :, None]
    c = torch.arange(C, dtype=i64, device=device)[None, None, :]
    return hash_u32((_seed(seed, device) + salt) & MASK32, b, s, c) >= threshold(rate)


def log_bucket(rel, bucket_size, max_position):
    mid = bucket_size // 2
    sign = np.sign(rel)
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
    with np.errstate(divide="ignore", invalid="ignore"):
        log_pos = (np.ceil(np.log(abs_pos / mid) / np.log((max_position - 1) / mid) * (mid - 1))
                   + mid)
    return np.where(abs_pos <= mid, rel.astype(np.float64), log_pos * sign).astype(np.int64)


def rel_tables(S, span, max_position):
    """Table rows [S, S] of the content-to-position term (row q, column k:
    bucket of q − k) and the position-to-content term (row k, column q:
    the negated bucket of k − q)."""
    pos = np.arange(S)
    rel = pos[:, None] - pos[None, :]
    c2p = np.clip(log_bucket(rel, span, max_position) + span, 0, 2 * span - 1)
    p2c = np.clip(-log_bucket(rel, span, max_position) + span, 0, 2 * span - 1)
    return c2p, p2c


_KR, _KG, _KB = 0.299, 0.587, 0.114


def unpack_yuv420(packed):
    """uint8 [..., H·3/2, W] → RGB in [0, 1], f32 [..., H, W, 3]."""
    *lead, hp, w = packed.shape
    h = hp * 2 // 3
    p = packed.float()
    y = p[..., :h, :]
    u = p[..., h:h + h // 4, :].reshape(*lead, h // 2, w // 2)
    v = p[..., h + h // 4:, :].reshape(*lead, h // 2, w // 2)
    u = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0
    v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0
    r = y + 2.0 * (1.0 - _KR) * v
    b = y + 2.0 * (1.0 - _KB) * u
    g = (y - _KR * r - _KB * b) / _KG
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0) / 255.0


_WORD_RE = re.compile(r"[a-z0-9]+|[^a-z0-9\s]")


def tokenize(text, max_length, vocab_size=128100):
    """(input_ids, attention_mask) int64 [max_length]: [CLS] words [SEP], padded with 0."""
    ids = []
    for word in _WORD_RE.findall(str(text).lower()):
        h = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
        ids.append(100 + int.from_bytes(h, "little") % (vocab_size - 100))
    seq = [1] + ids[:max_length - 2] + [2]
    out = np.zeros((2, max_length), np.int64)
    out[0, :len(seq)] = seq
    out[1, :len(seq)] = 1
    return out[0], out[1]
