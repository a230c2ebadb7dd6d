"""The reference train step: the recipe's input path (int16 audio scaled,
yuv420 video decoded, the batch augmented), the model in training mode, the
composite loss, gradients by autograd and the AdamW chain, in float32 (or,
for the control, float8 products).

The step's three generators are drawn from the run's host generator as the
recipe draws them, so the reference drops, masks and augments exactly
where the program did.
"""
import torch

from . import frozen
from . import model as ref


def step_generators(host, device):
    """(augment, dropout, missing-modality) generators of one step."""
    seeds = torch.randint(0, 2 ** 62, (3,), generator=host).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def time_stretch(wav, factor):
    """Linear interpolation (align_corners=False) of each row to
    floor(L·factor) samples, zero-padded or cut back to L."""
    L = wav.shape[-1]
    new_len = torch.floor(L * factor)[:, None]
    j = torch.arange(L, dtype=torch.float32, device=wav.device)[None]
    src = (j + 0.5) * (L / torch.clamp(new_len, min=1.0)) - 0.5
    lo = torch.clamp(torch.floor(src), 0, L - 1).long()
    hi = torch.clamp(lo + 1, 0, L - 1)
    frac = torch.clamp(src - lo.float(), 0.0, 1.0)
    out = wav.gather(1, lo) * (1.0 - frac) + wav.gather(1, hi) * frac
    return torch.where(j < new_len, out, torch.zeros((), device=wav.device))


def inputs(batch, g):
    """(wav [B, T], frames [B, F, H, W, 3]) in f32 from a wire batch, augmented
    per sample: noise (p 0.3), time stretch U[0.8, 1.2] (p 0.3), brightness
    U[0.8, 1.2] (p 0.3), horizontal flip (p 0.5)."""
    dev = batch["audio"].device
    wav = batch["audio"].float() / 32768.0
    frames = frozen.unpack_yuv420(batch["video"])
    B = wav.shape[0]
    noisy = torch.rand((B, 1), generator=g, device=dev) < 0.3
    wav = torch.where(noisy, wav + 0.01 * torch.randn(wav.shape, generator=g, device=dev), wav)
    stretch = torch.rand((B, 1), generator=g, device=dev) < 0.3
    factor = 0.8 + torch.rand((B,), generator=g, device=dev) * 0.4
    wav = torch.where(stretch, time_stretch(wav, factor), wav)
    shape = (B,) + (1,) * (frames.dim() - 1)
    bright = torch.rand(shape, generator=g, device=dev) < 0.3
    factor = 0.8 + torch.rand(shape, generator=g, device=dev) * 0.4
    frames = torch.where(bright, torch.clamp(frames * factor, 0.0, 1.0), frames)
    flip = torch.rand(shape, generator=g, device=dev) < 0.5
    return wav, torch.where(flip, frames.flip(3), frames)


def train(cfg, P, batches, host, precision="f32", rows=None, gains=None):
    """Follows ``len(batches)`` steps from the weights ``P`` (updated in
    place). Returns {"loss": [per step], "grad": {name: ‖clipped gradient‖ of
    the first step}, "raw_grad": {name: ‖unclipped‖}}. ``rows``: keep only
    these rows of every batch; ``gains``: {name: factor} on these leaves'
    update at every step (planted faults)."""
    names = list(P)
    params = [P[n].requires_grad_() for n in names]
    opt = ref.AdamW(names, params, cfg)
    out = {"loss": []}
    for i, batch in enumerate(batches):
        g_aug, g_drop, _ = step_generators(host, params[0].device)
        if rows is not None:
            batch = {k: ({kk: vv[rows] for kk, vv in v.items()} if isinstance(v, dict) else v[rows])
                     for k, v in batch.items()}
        wav, frames = inputs(batch, g_aug)
        run = ref.Run(train=True, gen=g_drop, precision=precision, checkpoint_frames=True)
        o = ref.forward(run, P, cfg, batch["text"]["input_ids"].long(),
                        batch["text"]["attention_mask"].long(), wav, frames, contrastive=True)
        loss = ref.loss(o, batch["emotion"].long())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        del o
        before = {n: P[n].detach().clone() for n in gains or {}}
        clipped = opt.update(grads)
        with torch.no_grad():
            for n, gain in (gains or {}).items():
                P[n].copy_(before[n] + gain * (P[n] - before[n]))
        out["loss"].append(loss.item())
        if i == 0:
            out["grad"] = dict(zip(names, ref.leaf_norms(clipped)))
            out["raw_grad"] = dict(zip(names, ref.leaf_norms(
                [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])))
        del grads, clipped, loss
    for p in params:
        p.requires_grad_(False)
    return out
