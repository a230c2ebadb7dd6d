"""Fused wav2vec2 front end: conv_0 (K taps, stride s, 1 → C channels, no
bias) → per-channel GroupNorm over time → GELU, waveform [B, T] → frames
[B, T1, C] with T1 = (T − K)//s + 1, and its backward.

Replaces the TPU kernels of simple_multimodal_tpu/ops/pallas/wav_frontend.py:
pass 1 (``_stats_kernel`` via ``_fused_call``), pass 2 (``_apply_kernel``
via ``_apply_call``) and the custom VJP ``_frontend_bwd`` (``jax.vjp`` of
``_xla_reference``). On a CUDA tensor the wrapper runs ``WavFrontendFn``:
its forward launches pass 1, the device fold of the statistics and pass 2
of ``csrc/wav_frontend.cu``; its backward launches that file's two backward
passes and their folds. On a CPU tensor it runs ``wav_frontend_plain``, the
port of ``_xla_reference``; ``wav_frontend_bwd_plain`` is the backward's
closed form, which the checks on the card hold the kernel against. Bounds
and design of the CUDA version are noted in the .cu source.
"""
import functools
import math

import torch
import torch.nn.functional as F

from . import _build

WAV_TILE = 128      # frames per tile of every pass (csrc/wav_frontend.cu: kTile)
TAPS = 10           # the tap count the kernels are built for
MAX_STRIDE = 5      # the waveform span a thread stages per tile (csrc/wav_frontend.cu: kPre)
MAX_C = 512         # one 64-channel slice for each of a block's eight warps
BLOCKS_PER_SM = 2   # resident 256-thread blocks the passes are built for


def row_blocks(batch: int, ntiles: int, sms: int) -> int:
    """Blocks per batch row of the persistent passes: about BLOCKS_PER_SM
    blocks on each SM over the whole batch, never more than the row's tiles.
    Block x of a row takes tiles x, x + nb, ... and leaves one partial."""
    return max(1, min(ntiles, -(-BLOCKS_PER_SM * sms // batch)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wav_frontend_plain(wav, kernel, gn_scale, gn_bias, stride: int, eps: float = 1e-5):
    """Plain PyTorch version: the unfused composition, the same math as the
    JAX ``_xla_reference``. The conv runs in the kernel's dtype, the
    GroupNorm statistics (two-pass variance) and the GELU in f32; tanh GELU
    for bf16, erf for f32."""
    cd = kernel.dtype
    y = F.conv1d(wav.to(cd)[:, None, :], kernel, stride=stride)
    yf = y.float()  # [B, C, T1]
    mean = yf.mean(dim=-1, keepdim=True)
    var = ((yf - mean) ** 2).mean(dim=-1, keepdim=True)
    z = (yf - mean) * torch.rsqrt(var + eps)
    z = z * gn_scale.float()[:, None] + gn_bias.float()[:, None]
    z = F.gelu(z, approximate="tanh" if cd == torch.bfloat16 else "none")
    return z.to(cd).transpose(1, 2)


def gelu_grad(z, tanh: bool):
    """d/dz of the GELU in f32: the tanh form or the erf form."""
    if tanh:
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (z + 0.044715 * z ** 3))
        return 0.5 * (1 + t) + 0.5 * z * (1 - t * t) * c * (1 + 3 * 0.044715 * z * z)
    return 0.5 * (1 + torch.erf(z * math.sqrt(0.5))) + z * torch.exp(-0.5 * z * z) / math.sqrt(
        2 * math.pi)


def wav_frontend_bwd_plain(gy, wav, kernel, gn_scale, gn_bias, mean, rstd, stride: int):
    """The backward's closed form in PyTorch: (dwav, dkernel, dgamma, dbeta)
    for the cotangent ``gy`` [B, T1, C] of ``wav_frontend_plain``, from the
    forward's per-(b, c) ``mean`` and ``rstd`` [B, C]. With y the conv
    rounded to the kernel's dtype, xhat = (y − mean)·rstd, z = γ·xhat + β,
    dz = gy·gelu′(z): dβ = Σ dz, dγ = Σ dz·xhat, and
    dy = rstd·γ·(dz − mean_t dz − xhat·mean_t(dz·xhat)), rounded to the
    kernel's dtype as autograd of the conv sees it; dkernel and dwav are the
    conv's two transposed products of dy, in f32. Gradients come back in the
    inputs' dtypes."""
    cd = kernel.dtype
    x = wav.to(cd)[:, None, :].float()
    y = F.conv1d(wav.to(cd)[:, None, :], kernel, stride=stride).float()  # [B, C, T1]
    mu, r = mean.float()[..., None], rstd.float()[..., None]
    g, b = gn_scale.float()[:, None], gn_bias.float()[:, None]
    xhat = (y - mu) * r
    dz = gy.float().transpose(1, 2) * gelu_grad(xhat * g + b, cd == torch.bfloat16)
    dbeta, dgamma = dz.sum(dim=(0, 2)), (dz * xhat).sum(dim=(0, 2))
    m1 = dz.mean(dim=-1, keepdim=True)
    m2 = (dz * xhat).mean(dim=-1, keepdim=True)
    dy = (r * g * (dz - m1 - xhat * m2)).to(cd).float()
    dw = torch.nn.grad.conv1d_weight(x, kernel.shape, dy, stride=stride)
    dx = torch.nn.grad.conv1d_input(x.shape, kernel.float(), dy, stride=stride)
    return (dx[:, 0].to(wav.dtype), dw.to(cd), dgamma.to(gn_scale.dtype),
            dbeta.to(gn_bias.dtype))


def stats_partials_plain(y, nb: int):
    """What pass 1 leaves for a conv output y [B, T1, C] (f32, already
    rounded): part [B, nb, 2, C], block x of a row summing y and y² over the
    frames of tiles x, x + nb, ... (``row_blocks``' assignment)."""
    B, T1, C = y.shape
    ntiles = -(-T1 // WAV_TILE)
    tiles = F.pad(y, (0, 0, 0, ntiles * WAV_TILE - T1)).reshape(B, ntiles, WAV_TILE, C)
    part = y.new_zeros(B, nb, 2, C)
    for t in range(ntiles):
        part[:, t % nb, 0] += tiles[:, t].sum(dim=1)
        part[:, t % nb, 1] += (tiles[:, t] ** 2).sum(dim=1)
    return part


def fold_stats_plain(part, T1: int, gn_scale, gn_bias, eps: float = 1e-5):
    """``wav_fold_stats_kernel`` in PyTorch: pass 1's partials [B, nb, 2, C]
    → coef [4, B, C] = mean, rstd, rstd·γ, β − mean·rstd·γ, the variance as
    Σy²/n − mean² clamped at 0 (the JAX kernel's form)."""
    s = part.sum(dim=1)
    mean = s[:, 0] / T1
    rstd = torch.rsqrt((s[:, 1] / T1 - mean * mean).clamp_min(0.0) + eps)
    scale = rstd * gn_scale.float()
    return torch.stack([mean, rstd, scale, gn_bias.float() - mean * scale])


def _forward(wav, kernel, gn_scale, gn_bias, stride, eps):
    """Launch pass 1, the fold and pass 2: (out, coef [4, B, C] = mean, rstd,
    scale, shift; the blocks per batch row)."""
    C, _, K = kernel.shape
    B, T = wav.shape
    T1 = (T - K) // stride + 1
    dev = wav.device
    nb = row_blocks(B, -(-T1 // WAV_TILE), _sm_count(dev.index or 0))
    lib = _build.library()
    x = _wave(wav)
    w = _taps(kernel)
    g, b = gn_scale.float().contiguous(), gn_bias.float().contiguous()
    scratch = torch.empty(4 * B * C + B * nb * 2 * C, dtype=torch.float32, device=dev)
    coef, part = scratch[:4 * B * C].view(4, B, C), scratch[4 * B * C:]  # part [B, nb, 2, C]
    out = torch.empty((B, T1, C), dtype=kernel.dtype, device=dev)
    p = _build.ptr
    err = lib.smm_wav_frontend_fwd(_build.dtype_code(w), p(x), p(w), p(g), p(b), p(part),
                                   p(coef), p(out), B, T, C, K, stride, nb, eps,
                                   _build.stream_ptr(wav))
    _build.check(lib, err, "wav_frontend")
    wav_frontend.launches += 1
    return out, coef, nb


class WavFrontendFn(torch.autograd.Function):
    """Both CUDA passes and the fold forward; the backward kernels backward."""

    @staticmethod
    def forward(ctx, wav, kernel, gn_scale, gn_bias, stride, eps):
        out, coef, nb = _forward(wav, kernel, gn_scale, gn_bias, stride, eps)
        ctx.save_for_backward(wav, kernel, gn_scale, gn_bias, coef)
        ctx.cfg = (stride, nb)
        return out

    @staticmethod
    def backward(ctx, gy):
        wav, kernel, gn_scale, gn_bias, coef = ctx.saved_tensors
        stride, nb = ctx.cfg
        C, _, K = kernel.shape
        B, T = wav.shape
        T1 = (T - K) // stride + 1
        ntiles = -(-T1 // WAV_TILE)
        dev, f32 = wav.device, torch.float32
        lib = _build.library()
        x = _wave(wav)
        w = _taps(kernel)
        g, b = gn_scale.float().contiguous(), gn_bias.float().contiguous()
        gy = gy.to(kernel.dtype).contiguous()
        # one f32 scratch: dgb [2, C] (dgamma, dbeta), co [3, B, C], part_a [B, nb, 2, C],
        # part_b [B, nb, K, C]
        sizes = (2 * C, 3 * B * C, B * nb * 2 * C, B * nb * K * C)
        dgb, co, part_a, part_b = torch.empty(sum(sizes), dtype=f32, device=dev).split(sizes)
        dgb = dgb.view(2, C)
        dw = torch.empty((K, C), dtype=kernel.dtype, device=dev)  # the kernels' tap-major order
        dxt = dwav = None
        if ctx.needs_input_grad[0]:
            dxt = torch.empty((B, ntiles, WAV_TILE * stride + K), dtype=f32, device=dev)
            dwav = torch.empty((B, T), dtype=f32, device=dev)
        p = _build.ptr
        err = lib.smm_wav_frontend_bwd(_build.dtype_code(w), p(x), p(w), p(g), p(b), p(coef),
                                       p(gy), p(part_a), p(co), p(dgb), p(part_b), p(dw), p(dxt),
                                       p(dwav), B, T, C, K, stride, nb, _build.stream_ptr(wav))
        _build.check(lib, err, "wav_frontend backward")
        wav_frontend_bwd.launches += 1
        needs = ctx.needs_input_grad
        return (None if dwav is None else dwav.to(wav.dtype),
                dw.t()[:, None] if needs[1] else None,
                dgb[0].to(gn_scale.dtype) if needs[2] else None,
                dgb[1].to(gn_bias.dtype) if needs[3] else None, None, None)


def _wave(wav):
    """The waveform as the kernels read it: f32, contiguous (the kernels
    round it to the compute type as they stage it)."""
    return wav.float().contiguous()


def _taps(kernel):
    """The conv weight [C, 1, K] as the kernels read it: tap-major [K, C]."""
    return kernel[:, 0].t().contiguous()


def wav_frontend(wav, kernel, gn_scale, gn_bias, stride: int, eps: float = 1e-5):
    """Fused conv_0 → GroupNorm(C groups) → GELU over a waveform [B, T].

    ``kernel`` is the conv weight [C, 1, K] (torch ``nn.Conv1d`` layout),
    ``gn_scale``/``gn_bias`` the GroupNorm affine [C]. Returns NWC frames
    [B, T1, C] in the kernel's dtype. CPU tensors run the plain version; CUDA tensors launch the
    kernels (K = 10 taps, a stride up to 5 that divides K, C = 8·2ⁿ up to
    512), forward and backward, or raise. With no gradient to record the
    forward launches without the autograd.Function around it.
    """
    if wav.device.type == "cpu":
        return wav_frontend_plain(wav, kernel, gn_scale, gn_bias, stride, eps)
    if wav.device.type != "cuda":
        raise RuntimeError(f"wav_frontend: no kernel for device {wav.device}")
    if wav.dim() != 2 or kernel.dim() != 3 or kernel.shape[1] != 1:
        raise ValueError("wav_frontend: wav [B, T] and kernel [C, 1, K]")
    C, _, K = kernel.shape
    if K != TAPS or not 1 <= stride <= MAX_STRIDE or K % stride:
        raise ValueError(f"wav_frontend: the kernel takes K = {TAPS} taps and a stride "
                         f"up to {MAX_STRIDE} that divides K, got K = {K}, stride = {stride}")
    if C < 8 or C > MAX_C or C & (C - 1):
        raise ValueError(f"wav_frontend: C = {C} is not 8·2ⁿ up to {MAX_C}")
    if wav.shape[1] < K:
        raise ValueError(f"wav_frontend: {wav.shape[1]} samples are fewer than K = {K}")
    _build.dtype_code(kernel)
    for t in (kernel, gn_scale, gn_bias):
        if t.device != wav.device:
            raise ValueError("wav_frontend: every input must be on the waveform's device")
    if gn_scale.shape != (C,) or gn_bias.shape != (C,):
        raise ValueError(f"wav_frontend: the GroupNorm affine must be [{C}]")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (wav, kernel, gn_scale,
                                                                        gn_bias))):
        return _forward(wav, kernel, gn_scale, gn_bias, int(stride), float(eps))[0]
    return WavFrontendFn.apply(wav, kernel, gn_scale, gn_bias, int(stride), float(eps))


def wav_frontend_bwd():
    """Launch counter of ``WavFrontendFn``'s backward kernels (one per
    backward call)."""


wav_frontend.launches = 0
wav_frontend_bwd.launches = 0
