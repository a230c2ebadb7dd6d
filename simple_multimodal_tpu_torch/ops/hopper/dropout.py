"""The stateless dropout hash of the fused kernels, as plain torch ops.

Port of ``_hash_keep`` (simple_multimodal_tpu/ops/pallas/deberta_attention.py):
a murmur3-finalizer over (seed, head, q, k) in uint32 arithmetic; an element
is kept iff its hash is >= ``threshold(rate)``. Forward and backward
regenerate the same mask from the same indices, so no mask is stored. The
CUDA side is ``smm::hash_keep`` in ``csrc/common.cuh``, on native
``uint32_t``.

torch's CPU ``uint32`` supports few ops, so the arithmetic runs in int64
with ``& 0xFFFFFFFF`` after every multiply and add; each multiply is split
into 16-bit halves so no int64 product overflows. The result is bit-equal
to the JAX function.

Three index schemes call it:
- attention (``attention_block``, ``deberta_attention``): head = b·H + h,
  q and k the query and key positions;
- FFN: seed + salt (1 for the post-GELU mask, 2 for the output mask),
  "head" = the batch index b, q = the row s within the sequence, k = the
  column.
"""
import torch

MASK32 = 0xFFFFFFFF
_C1, _C2, _C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
SALT_MID, SALT_OUT = 1, 2


def threshold(rate: float) -> int:
    """uint32 keep threshold, exactly as ``_hash_keep`` forms it."""
    return int(min(max(rate, 0.0), 1.0) * 4294967296.0) & MASK32


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_u32(seed, head, q, k) -> torch.Tensor:
    """The finalizer's uint32 value (as int64) for broadcastable int64
    index tensors; ``seed`` is an int or an integer tensor."""
    x = (_mul(q, _C1) + _mul(k, _C2)) & MASK32
    x = (x + _mul(head, _C3) + seed) & MASK32
    x = x ^ (x >> 16)
    x = _mul(x, _C2)
    x = x ^ (x >> 13)
    x = _mul(x, _C3)
    return x ^ (x >> 16)


def _seed(seed, device) -> torch.Tensor:
    return torch.as_tensor(seed, device=device).reshape(()).to(torch.int64) & MASK32


def attention_keep(seed, B: int, H: int, Sq: int, Sk: int, rate: float,
                   device=None) -> torch.Tensor:
    """Keep mask [B, H, Sq, Sk] of attention-probability dropout."""
    i64 = torch.int64
    b = torch.arange(B, dtype=i64, device=device)[:, None, None, None]
    h = torch.arange(H, dtype=i64, device=device)[None, :, None, None]
    q = torch.arange(Sq, dtype=i64, device=device)[None, None, :, None]
    k = torch.arange(Sk, dtype=i64, device=device)[None, None, None, :]
    return hash_u32(_seed(seed, device), b * H + h, q, k) >= threshold(rate)


def ffn_keep(seed, salt: int, B: int, S: int, C: int, rate: float,
             device=None) -> torch.Tensor:
    """Keep mask [B, S, C] of the FFN's hidden dropout (salt 1: post-GELU,
    salt 2: output)."""
    i64 = torch.int64
    b = torch.arange(B, dtype=i64, device=device)[:, None, None]
    s = torch.arange(S, dtype=i64, device=device)[None, :, None]
    c = torch.arange(C, dtype=i64, device=device)[None, None, :]
    seed = (_seed(seed, device) + salt) & MASK32
    return hash_u32(seed, b, s, c) >= threshold(rate)


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """keep ? x / (1 − rate) : 0, in x's dtype."""
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))
