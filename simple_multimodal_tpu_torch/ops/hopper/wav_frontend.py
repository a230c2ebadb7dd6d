"""Fused wav2vec2 front end: conv_0 (K taps, stride s, 1 → C channels, no
bias) → per-channel GroupNorm over time → GELU, waveform [B, T] → frames
[B, T1, C] with T1 = (T − K)//s + 1.

Replaces the TPU kernels of simple_multimodal_tpu/ops/pallas/wav_frontend.py:
pass 1 (``_stats_kernel`` via ``_fused_call``) and pass 2 (``_apply_kernel``
via ``_apply_call``). On a CUDA tensor the wrapper runs ``WavFrontendFn``,
whose forward launches both passes of ``csrc/wav_frontend.cu`` and whose
backward is ``torch.autograd`` of the plain version on the saved inputs, as
the JAX custom VJP differentiates its reference (the JAX package has no
backward kernel here); on a CPU tensor it runs ``wav_frontend_plain``, the
port of that file's ``_xla_reference``. Bounds and design of the CUDA
version are noted in the .cu source.
"""
import torch
import torch.nn.functional as F

from . import _build

WAV_TILE = 128  # frames per block of both passes (csrc/wav_frontend.cu: kTile)
TAPS = 10       # the tap count the kernel is instantiated for


def wav_frontend_plain(wav, kernel, gn_scale, gn_bias, stride: int, eps: float = 1e-5):
    """Plain PyTorch version: the unfused composition, the same math as the
    JAX ``_xla_reference``. The conv runs in the kernel's dtype, the
    GroupNorm statistics (two-pass variance) and the GELU in f32; tanh GELU
    for bf16, erf for f32."""
    cd = kernel.dtype
    y = F.conv1d(wav.to(cd)[:, None, :], kernel.permute(2, 1, 0), stride=stride)
    yf = y.float()  # [B, C, T1]
    mean = yf.mean(dim=-1, keepdim=True)
    var = ((yf - mean) ** 2).mean(dim=-1, keepdim=True)
    z = (yf - mean) * torch.rsqrt(var + eps)
    z = z * gn_scale.float()[:, None] + gn_bias.float()[:, None]
    z = F.gelu(z, approximate="tanh" if cd == torch.bfloat16 else "none")
    return z.to(cd).transpose(1, 2)


class WavFrontendFn(torch.autograd.Function):
    """Both CUDA passes forward; the backward differentiates the plain
    version on the saved inputs."""

    @staticmethod
    def forward(ctx, wav, kernel, gn_scale, gn_bias, stride, eps):
        K, _, C = kernel.shape
        B, T = wav.shape
        T1 = (T - K) // stride + 1
        dev, f32 = wav.device, torch.float32
        lib = _build.library()
        x = wav.to(kernel.dtype).contiguous()
        w = kernel.reshape(K, C).contiguous()
        blocks = -(-T1 // WAV_TILE)
        part = torch.empty((B, blocks, 2, C), dtype=f32, device=dev)
        p = _build.ptr
        code, st = _build.dtype_code(w), _build.stream_ptr(wav)
        err = lib.smm_wav_frontend_stats(code, p(x), p(w), p(part), B, T, T1, C, K, stride, st)
        _build.check(lib, err, "wav_frontend (pass 1)")
        sums = part.sum(dim=1)  # [B, 2, C]: the blocks' partials in a fixed order
        mean = sums[:, 0] / T1
        var = (sums[:, 1] / T1 - mean * mean).clamp_min(0.0)
        mean, rstd = mean.contiguous(), torch.rsqrt(var + eps).contiguous()
        g, b = gn_scale.float().contiguous(), gn_bias.float().contiguous()
        out = torch.empty((B, T1, C), dtype=kernel.dtype, device=dev)
        err = lib.smm_wav_frontend_apply(code, p(x), p(w), p(mean), p(rstd), p(g), p(b),
                                         p(out), B, T, T1, C, K, stride, st)
        _build.check(lib, err, "wav_frontend (pass 2)")
        wav_frontend.launches += 1
        ctx.save_for_backward(wav, kernel, gn_scale, gn_bias)
        ctx.cfg = (stride, eps)
        return out

    @staticmethod
    def backward(ctx, gy):
        stride, eps = ctx.cfg
        needs = ctx.needs_input_grad[:4]
        ins = [t.detach().requires_grad_(n and t.is_floating_point())
               for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = wav_frontend_plain(*ins, stride, eps)
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, gy.to(out.dtype)))
        return tuple(next(grads) if t.requires_grad else None for t in ins) + (None, None)


def wav_frontend(wav, kernel, gn_scale, gn_bias, stride: int, eps: float = 1e-5):
    """Fused conv_0 → GroupNorm(C groups) → GELU over a waveform [B, T]; the
    JAX ``wav_frontend``'s arguments and layouts.

    ``kernel`` is the conv weight [K, 1, C], ``gn_scale``/``gn_bias`` the
    GroupNorm affine [C]. Returns NWC frames [B, T1, C] in the kernel's
    dtype. CPU tensors run the plain version; CUDA tensors launch the
    kernel (K = 10 taps, K a multiple of the stride, C = 8·2ⁿ up to 2048)
    or raise.
    """
    if wav.device.type == "cpu":
        return wav_frontend_plain(wav, kernel, gn_scale, gn_bias, stride, eps)
    if wav.device.type != "cuda":
        raise RuntimeError(f"wav_frontend: no kernel for device {wav.device}")
    if wav.dim() != 2 or kernel.dim() != 3 or kernel.shape[1] != 1:
        raise ValueError("wav_frontend: wav [B, T] and kernel [K, 1, C]")
    K, _, C = kernel.shape
    if K != TAPS or stride < 1 or K % stride:
        raise ValueError(f"wav_frontend: the kernel takes K = {TAPS} taps and a stride "
                         f"that divides K, got K = {K}, stride = {stride}")
    if C < 8 or C > 2048 or C & (C - 1):
        raise ValueError(f"wav_frontend: C = {C} is not 8·2ⁿ up to 2048")
    if wav.shape[1] < K:
        raise ValueError(f"wav_frontend: {wav.shape[1]} samples are fewer than K = {K}")
    _build.dtype_code(kernel)
    for t in (kernel, gn_scale, gn_bias):
        if t.device != wav.device:
            raise ValueError("wav_frontend: every input must be on the waveform's device")
    if gn_scale.shape != (C,) or gn_bias.shape != (C,):
        raise ValueError(f"wav_frontend: the GroupNorm affine must be [{C}]")
    return WavFrontendFn.apply(wav, kernel, gn_scale, gn_bias, int(stride), float(eps))


wav_frontend.launches = 0
