#!/usr/bin/env python
"""How far one bf16 rounding change inside DeBERTa moves the base model's
first train step, in one process on the card.

Runs the base hierarchical model (seed 0, B=8, dropout and augmentation
off, the contrastive loss on, TF32 off, cuDNN deterministic) twice as it
is, then once with DeBERTa's attention output projection computed from the
same bf16 operands in f32 and rounded once (what a projection split over
processes and summed in f32 computes). Prints the eval logits' distance,
the first step's loss and gradient norm, and the parameters whose gradient
moved most. A step on a mesh can only be held to one process as closely as
this run moves.

    python tools/bf16_rounding_sensitivity_torch.py   # from the checkout root, one GPU
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from simple_multimodal_tpu_torch.models import deberta
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_eval_step, make_train_step

    if not torch.cuda.is_available():
        print("bf16_rounding_sensitivity_torch: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.set_tf32(False)
    torch.backends.cudnn.deterministic = True
    cfg = cs._base_config(tempfile.mkdtemp())
    model = cs._dp_model(cfg, dev)
    batch = cs._dp_batch(cfg, dev)

    def run():
        logits = make_eval_step(model)(batch)["logits"].float()
        opt = make_optimizer(cfg, model, total_steps=100)
        grads = {}

        def keep(gs):  # the step's gradients, no update
            grads.update({n: g.detach().float().clone() for n, g in zip(opt.names, gs)
                          if g is not None})
            return torch.zeros((), device=dev)

        opt.update = keep
        step = make_train_step(model, opt, cfg, augment=False, compute_contrastive_loss=True)
        _, parts = step(TrainState.create(0), batch)
        return logits, grads, float(parts["total_loss"])

    def norm(grads):
        return float(torch.stack([g.norm() for g in grads.values()]).norm())

    base, again = run(), run()
    print(f"as is, twice: logits {float((again[0] - base[0]).abs().max()):.3e} apart, "
          f"gradients bit-equal {all(torch.equal(base[1][n], again[1][n]) for n in base[1])}")
    linear = deberta.linear

    outputs = {id(layer.attention.output.dense) for layer in model.text_encoder.model.encoder.layer}

    def f32_rounded_once(x, layer, dtype):
        if id(layer) not in outputs:
            return linear(x, layer, dtype)
        return (F.linear(x.float(), layer.weight.to(dtype).float())
                + layer.bias.to(dtype).float()).to(dtype)

    deberta.linear = f32_rounded_once
    try:
        logits, grads, loss = run()
    finally:
        deberta.linear = linear
    n0, n1 = norm(base[1]), norm(grads)
    print(f"attention output in f32: logits {float((logits - base[0]).abs().max()):.3e} apart "
          f"(largest {float(base[0].abs().max()):.3e}); loss {loss!r} vs {base[2]!r}; gradient "
          f"norm {n1!r} vs {n0!r} ({(n1 - n0) / n0:.3e} relative)")
    moved = sorted(((float((grads[n] - base[1][n]).norm() / (base[1][n].norm() + 1e-30)),
                     float(grads[n].norm() ** 2 - base[1][n].norm() ** 2), n) for n in base[1]),
                   key=lambda t: -abs(t[1]))
    for rel, dsq, name in moved[:8]:
        print(f"  {name}: |g|² {dsq:+.3e}, |Δg|/|g| {rel:.3e}")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
