"""Plain PyTorch reference of the recogniser with Moonlight-16B-A3B's decoder
(DeepSeek-V3's layer equations, ``modeling_deepseek.py`` published beside
its ``config.json``) as the text tower, the rest as ``model.py`` has it.

The tower, for hidden state x at positions 0…S−1, in float32:
- h = x + MLA(RMSNorm(x)), x' = h + FFN(RMSNorm(h)); RMSNorm with its weight;
- MLA: q = q_proj(x) split into nope and rope parts per head;
  kv_a_proj_with_mqa(x) = [c (kv_lora_rank), k_rope (one, shared by the
  heads)]; kv_b_proj(RMSNorm(c)) = [k_nope, v] per head; RoPE (θ
  ``rope_theta``) on q_rope and k_rope after the published de-interleave
  (each vector viewed as [d/2, 2], transposed, flattened; then
  rotate_half); softmax(q·kᵀ/√(nope + rope) + causal mask)·v; o_proj;
- the first ``first_k_dense_replace`` layers' FFN dense,
  down(silu(gate(x)) ⊙ up(x)); the others a mixture of experts: f32
  router logits, sigmoid scores s, the top ``num_experts_per_tok`` of
  s + ``e_score_correction_bias`` chosen, weights the chosen s over their
  sum (+1e-20) × ``routed_scaling_factor``; output = the shared experts
  (one FFN of ``n_shared_experts`` expert widths) + Σ weight · expert(x)
  over the token's chosen experts that are held;
- final RMSNorm; the text feature is the mean over the attention mask's
  rows (no 'bert' in ``deepseek_v3``: the recogniser's mean, not CLS).

Departures from the published model, as the configuration states them:
the depth cut (``num_hidden_layers`` of the file, not 27); the expert
share (only the ``n_routed_experts`` experts held here, the block
``expert_share`` = [index, count] of the router's ``router_experts``; a
chosen expert held elsewhere adds nothing); no LM head; the correction
bias is a fixed input, not trained.

The layers are recomputed in the backward (``torch.utils.checkpoint``; they
draw nothing random), so the tower's f32 activations fit on the card.
``forward`` and ``train`` are ``model.forward`` and ``step.train`` with the
text tower as an argument; wav2vec2, ViT + biLSTM, the fusion, the loss and
the AdamW chain are ``model.py``'s. ``Run.round_in`` / ``round_grad`` give
the float8 control its products (the router stays f32, as the program's).
"""
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as ref
from .step import inputs, step_generators

PREFIX = "text_encoder.model."
TOWER_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
              "num_hidden_layers", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "n_routed_experts", "num_experts_per_tok",
              "n_shared_experts", "first_k_dense_replace", "routed_scaling_factor",
              "rms_norm_eps", "rope_theta", "router_experts", "expert_share",
              "initializer_range")


def tower_config(cfg):
    """The tower's numbers: the configuration file's top level."""
    return {k: cfg[k] for k in TOWER_KEYS}


def held(c):
    """The global indices of the experts held here."""
    index, _ = c["expert_share"]
    n = c["n_routed_experts"]
    return range(index * n, (index + 1) * n)


# ------------------------------------------------------------------ tower

def rms(P, name, x, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * P[name + ".weight"]


def rope(x, theta):
    """x [B, S, H, d] → RoPE after DeepSeek's de-interleave."""
    B, S, H, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    freqs = torch.outer(torch.arange(S, dtype=torch.float32, device=x.device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    x = x.reshape(B, S, H, d // 2, 2).transpose(-1, -2).reshape(B, S, H, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


def mla(run, P, c, lp, x):
    B, S, _ = x.shape
    H, nope, rp, dv = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                       c["v_head_dim"])
    q = ref.lin(run, P, lp + "q_proj", x).reshape(B, S, H, nope + rp)
    c_kv, k_rope = ref.lin(run, P, lp + "kv_a_proj_with_mqa", x).split(
        [c["kv_lora_rank"], rp], dim=-1)
    kv = ref.lin(run, P, lp + "kv_b_proj", rms(P, lp + "kv_a_layernorm", c_kv, c["rms_norm_eps"]))
    k_nope, v = kv.reshape(B, S, H, nope + dv).split([nope, dv], dim=-1)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], dim=-1)
    k_rope = rope(k_rope[:, :, None], c["rope_theta"]).expand(B, S, H, rp)
    k = torch.cat([k_nope, k_rope], dim=-1)
    s = ref.mm(run, "bqhd,bkhd->bhqk", q, k) / math.sqrt(nope + rp)
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
    out = ref.mm(run, "bhqk,bkhd->bqhd", p, v).reshape(B, S, H * dv)
    return ref.lin(run, P, lp + "o_proj", out)


def ffn(run, P, name, x):
    g = ref.lin(run, P, name + ".gate_proj", x)
    return ref.lin(run, P, name + ".down_proj", F.silu(g) * ref.lin(run, P, name + ".up_proj", x))


def route(c, logits, bias):
    """(choice [T, k], weights [T, k]) from router logits [T, experts]."""
    scores = torch.sigmoid(logits)
    choice = torch.topk(scores.detach() + bias, c["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, choice)
    return choice, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]


def moe(run, P, c, lp, x, record=None):
    B, S, E = x.shape
    h = x.reshape(-1, E)
    choice, w = route(c, F.linear(h, P[lp + "gate.weight"]), P[lp + "gate.e_score_correction_bias"])
    if record is not None:  # the first pass's (a recomputation chooses the same)
        record.setdefault(lp, choice.detach())
    out = ffn(run, P, lp + "shared_experts", h)
    for j in held(c):
        tokens, slots = (choice == j).nonzero(as_tuple=True)
        if len(tokens):
            y = ffn(run, P, f"{lp}experts.{j}", h[tokens])
            out = out.index_add(0, tokens, w[tokens, slots, None] * y)
    return out.reshape(B, S, E)


def layer(run, P, c, i, x, record=None):
    lp = f"{PREFIX}layers.{i}."
    eps = c["rms_norm_eps"]
    x = x + mla(run, P, c, lp + "self_attn.", rms(P, lp + "input_layernorm", x, eps))
    h = rms(P, lp + "post_attention_layernorm", x, eps)
    if i < c["first_k_dense_replace"]:
        return x + ffn(run, P, lp + "mlp", h)
    return x + moe(run, P, c, lp + "mlp.", h, record)


def tower(run, P, c, ids, record=None):
    """ids [B, S] → the final-normed hidden states [B, S, E]. ``record``: a
    dict that gains each MoE layer's choice [B·S, k] under the layer's
    name prefix."""
    x = P[PREFIX + "embed_tokens.weight"][ids]
    for i in range(c["num_hidden_layers"]):
        if torch.is_grad_enabled():
            x = checkpoint(layer, run, P, c, i, x, record, use_reentrant=False)
        else:
            x = layer(run, P, c, i, x, record)
    return rms(P, PREFIX + "norm", x, c["rms_norm_eps"])


def moonlight_text(run, P, cfg, ids, mask, record=None):
    """The tower's masked mean: the text feature before the projection."""
    h = tower(run, P, tower_config(cfg), ids, record)
    m = mask[..., None].float()
    return (h * m).sum(1) / m.sum(1).clamp_min(1e-9)


def deberta_text(run, P, cfg, ids, mask):
    """``model.py``'s DeBERTa CLS row."""
    return ref.deberta(run, P, cfg["text"], ids, mask)[:, 0]


# ------------------------------------------------------------------ model

def replayed(run, fn, *args):
    """``fn(run, *args)`` recomputed in the backward (``checkpoint``) with the
    same random draws: the generator's state is put back first."""
    if run.gen is None or not torch.is_grad_enabled():
        return fn(run, *args)
    state = run.gen.get_state()

    def again(*a):
        run.gen.set_state(state)
        return fn(run, *a)

    return checkpoint(again, *args, use_reentrant=False)


def forward(run, P, cfg, ids, mask, wav, frames, contrastive=False, text=moonlight_text,
            replay=False):
    """``model.forward`` with ``text(run, P, cfg, ids, mask)`` as the text
    tower's feature; the same draws in the same order. ``replay``: the text
    tower and wav2vec2 are recomputed in the backward (``replayed``), so a
    large batch fits."""
    pc = cfg["program"]
    run.gelu_tanh = pc["mixed_precision"] and pc["compute_dtype"] == "bfloat16"
    p = pc["fusion_dropout"]
    call = (lambda fn, *a: replayed(run, fn, *a)) if replay else (lambda fn, *a: fn(run, *a))
    t = run.drop(ref.lin(run, P, "text_encoder.projection", call(text, P, cfg, ids, mask)), p)
    s = call(ref.wav2vec2, P, cfg["audio"], wav)
    s = ref.mha(run, P, "audio_encoder.temporal_attention", s, s, s, 8, p)
    a = run.drop(ref.lin(run, P, "audio_encoder.projection", s.mean(1)), p)
    B, T = frames.shape[:2]
    cls = ref.vit_cls(run, P, cfg["video"], frames.reshape((B * T,) + frames.shape[2:]))
    seq = ref.lstm(run, P, "video_encoder.temporal_lstm", cls.reshape(B, T, -1), 2, p)
    seq = ref.mha(run, P, "video_encoder.facial_attention", seq, seq, seq, 8, p)
    v = run.drop(ref.lin(run, P, "video_encoder.projection", seq.mean(1)), p)
    if run.train:
        keep = torch.rand((B, 3), generator=run.gen, device=t.device) > 0.1
        revive = F.one_hot(torch.randint(0, 3, (B,), generator=run.gen, device=t.device), 3).bool()
        keep = torch.where(keep.any(dim=1, keepdim=True), keep, revive).float()
        t, a, v = t * keep[:, 0:1], a * keep[:, 1:2], v * keep[:, 2:3]
    fused, losses = ref.hierarchical(run, P, pc, t, a, v, contrastive)
    h = run.drop(torch.relu(ref.lin(run, P, "classifier.classifier.0", fused)), p)
    logits = ref.lin(run, P, "classifier.classifier.3", h)
    return {"logits": logits, "probs": torch.softmax(logits, dim=-1),
            "valence": ref.lin(run, P, "valence_regressor", fused)[:, 0],
            "arousal": ref.lin(run, P, "arousal_regressor", fused)[:, 0],
            "contrastive": losses}


def train(cfg, P, batches, host, precision="f32", rows=None, text=moonlight_text,
          record=None, replay=False):
    """``step.train`` over ``forward`` with ``text`` as the text tower:
    follows the steps from ``P`` (updated in place), training every entry
    but the routers' correction biases. Returns {"loss", "grad",
    "raw_grad"}; ``record`` (a dict; moonlight_text only) gains the first
    step's choices, a layer at a time; ``replay`` as ``forward``'s."""
    names = [n for n in P if not n.endswith("e_score_correction_bias")]
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
        tx = text
        if record is not None and i == 0:
            tx = lambda *a: text(*a, record=record)  # noqa: E731
        o = forward(run, P, cfg, batch["text"]["input_ids"].long(),
                    batch["text"]["attention_mask"].long(), wav, frames, contrastive=True,
                    text=tx, replay=replay)
        loss = ref.loss(o, batch["emotion"].long())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        del o
        clipped = opt.update(grads)
        out["loss"].append(loss.item())
        if i == 0:
            out["grad"] = dict(zip(names, ref.leaf_norms(clipped)))
            out["raw_grad"] = dict(zip(names, ref.leaf_norms(
                [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])))
        del grads, clipped, loss
    for p in params:
        p.requires_grad_(False)
    return out


# ------------------------------------------------------------- parameters

def tower_spec(c):
    """[(name, shape, init)] of the tower: every product N(0, initializer_range),
    norms 1, the correction biases U(±0.05) (a spread like the scores', so
    that they change choices)."""
    E, H, std = c["hidden_size"], c["num_attention_heads"], c["initializer_range"]
    nope, rp, dv, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                          c["kv_lora_rank"])
    out = [(PREFIX + "embed_tokens.weight", (c["vocab_size"], E), ("normal", std))]

    def linear(name, i, o):
        out.append((name + ".weight", (o, i), ("normal", std)))

    def norm(name, n):
        out.append((name + ".weight", (n,), ("ones",)))

    def mlp(name, width):
        linear(name + ".gate_proj", E, width)
        linear(name + ".up_proj", E, width)
        linear(name + ".down_proj", width, E)

    for i in range(c["num_hidden_layers"]):
        lp = f"{PREFIX}layers.{i}."
        norm(lp + "input_layernorm", E)
        linear(lp + "self_attn.q_proj", E, H * (nope + rp))
        linear(lp + "self_attn.kv_a_proj_with_mqa", E, rank + rp)
        norm(lp + "self_attn.kv_a_layernorm", rank)
        linear(lp + "self_attn.kv_b_proj", rank, H * (nope + dv))
        linear(lp + "self_attn.o_proj", H * dv, E)
        norm(lp + "post_attention_layernorm", E)
        if i < c["first_k_dense_replace"]:
            mlp(lp + "mlp", c["intermediate_size"])
            continue
        linear(lp + "mlp.gate", E, c["router_experts"])
        out.append((lp + "mlp.gate.e_score_correction_bias", (c["router_experts"],),
                    ("uniform", -0.05, 0.05)))
        for j in held(c):
            mlp(f"{lp}mlp.experts.{j}", c["moe_intermediate_size"])
        mlp(lp + "mlp.shared_experts", c["moe_intermediate_size"] * c["n_shared_experts"])
    norm(PREFIX + "norm", E)
    return out


def rest_config(cfg):
    """The configuration as ``model.spec`` and ``flops.forward`` read it,
    with an empty DeBERTa of the tower's width in the text slot: its
    projection is the tower's, its layers none."""
    text = {"vocab_size": 0, "hidden_size": cfg["hidden_size"], "num_hidden_layers": 0,
            "intermediate_size": 0, "position_buckets": 0}
    return dict(cfg, text=text)


def spec(cfg):
    """Every parameter of the model: the tower's, then ``model.spec``'s
    without DeBERTa."""
    rest = [e for e in ref.spec(rest_config(cfg)) if not e[0].startswith(PREFIX)]
    return tower_spec(tower_config(cfg)) + rest
