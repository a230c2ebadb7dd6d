"""The reference's draws as a data-parallel step makes them, for a global
batch split into equal blocks of rows, one a rank.

The program draws every random tensor with a batch axis at the global
batch's size from a generator that every rank holds alike, and each rank
keeps its rows: the reference, drawing once for the whole batch, makes the
same draws. The fused kernels' hash dropout is the exception: rank r hashes
its own rows' local indices (0…n−1) under the step's seed plus
r · 1000003. ``ranks(d)`` makes the reference's hash masks so, block by
block, for as long as it is open.
"""
import torch

from . import frozen

KERNEL_SEED_STRIDE = 1000003


def _rank_seed(seed, r):
    return torch.as_tensor(seed).reshape(()).long() + r * KERNEL_SEED_STRIDE


class ranks:
    """Inside ``with ranks(d):`` ``frozen.attention_keep`` and
    ``frozen.ffn_keep`` give, for a batch of B rows, the d blocks of B/d
    rows each hashed as rank r hashes its own."""

    def __init__(self, d):
        self.d = d

    def __enter__(self):
        d = self.d
        self.saved = attention_keep, ffn_keep = frozen.attention_keep, frozen.ffn_keep

        def ranked_attention_keep(seed, B, *rest):
            return torch.cat([attention_keep(_rank_seed(seed, r), B // d, *rest)
                              for r in range(d)])

        def ranked_ffn_keep(seed, salt, B, *rest):
            return torch.cat([ffn_keep(_rank_seed(seed, r), salt, B // d, *rest)
                              for r in range(d)])

        frozen.attention_keep, frozen.ffn_keep = ranked_attention_keep, ranked_ffn_keep
        return self

    def __exit__(self, *exc):
        frozen.attention_keep, frozen.ffn_keep = self.saved
