"""Exact checks of the Hopper building blocks in ``csrc/hopper.cuh``
(``csrc/hopper_selftest.cu``): the wgmma wrappers with both shared-memory
descriptor forms, the accumulator-to-A-register packing, TMA loads and the
swizzle helper. ``chip_smoke.py`` and the GPU tests run ``hopper_selftest``;
no model path does. Needs a CUDA device.
"""
import torch

from . import _build

WIDTHS = (64, 96, 128)  # the wgmma N for which wrappers exist
SWIZZLES = (32, 64, 128)  # bytes


def _ints(gen, *shape, device):
    """Small integers in bf16: products and sums of 64 of them stay exact."""
    return torch.randint(-2, 3, shape, generator=gen, device=device).to(torch.bfloat16)


def hopper_selftest(device="cuda") -> dict:
    """Run every check; raise ``AssertionError`` on the first mismatch.
    Returns {check name: True}."""
    device = torch.device(device)
    lib = _build.library()
    p, stream = _build.ptr, torch.cuda.current_stream(device).cuda_stream
    gen = torch.Generator(device=device).manual_seed(0)
    done = {}
    for n in WIDTHS:
        k2 = 64
        a, bt = _ints(gen, 64, 64, device=device), _ints(gen, n, 64, device=device)
        v = _ints(gen, k2, n, device=device)
        c = torch.full((64, n), float("nan"), device=device)
        o = torch.full((64, n), float("nan"), device=device)
        _build.check(lib, lib.smm_hopper_selftest_mma(n, p(a), p(bt), p(v), p(c), p(o), stream),
                     "hopper_selftest_mma")
        torch.cuda.synchronize(device)
        want_c = a.float() @ bt.float().T
        want_o = want_c[:, :k2].to(torch.bfloat16).float() @ v.float()
        if not torch.equal(c, want_c):
            raise AssertionError(f"wgmma_ss m64n{n}k16 (K-major A and B through TMA, 64-byte "
                                 f"swizzle): max error {float((c - want_c).abs().max())}")
        if not torch.equal(o, want_o):
            raise AssertionError(f"wgmma_rs m64n{n}k16 (accumulator packed as A, MN-major B): "
                                 f"max error {float((o - want_o).abs().max())}")
        done[f"wgmma_ss_n{n}"] = done[f"wgmma_rs_n{n}"] = True
    rows, cols = 100, 136
    src = torch.randn(rows, cols, generator=gen, device=device).to(torch.bfloat16)
    for sw in SWIZZLES:
        width = sw // 2
        for r0, c0 in ((0, 0), (8, width), (60, cols - width // 2)):  # the last hangs over both edges
            out = torch.full((64, width), float("nan"), device=device, dtype=torch.bfloat16)
            _build.check(lib, lib.smm_hopper_selftest_swizzle(sw, p(src), p(out), rows, cols, r0,
                                                              c0, stream),
                         "hopper_selftest_swizzle")
            torch.cuda.synchronize(device)
            want = torch.zeros(64, width, device=device, dtype=torch.bfloat16)
            part = src[r0:r0 + 64, c0:c0 + width]
            want[:part.shape[0], :part.shape[1]] = part
            if not torch.equal(out, want):
                raise AssertionError(f"TMA box at ({r0}, {c0}) read through "
                                     f"swizzle_offset<{sw}> differs from the source")
        done[f"tma_swizzle_{sw}"] = True
    return done
