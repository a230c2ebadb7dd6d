"""Plain PyTorch reference of the multimodal emotion recogniser: DeBERTa-v3
(disentangled relative attention), wav2vec2 (conv feature encoder,
positional conv, post-LN layers, SpecAugment), ViT-B/16 per frame with a
biLSTM and attention over frames, the hierarchical fusion (early, MulT,
dense GAT, contrastive, adaptive, meta), the heads, the composite loss and
the AdamW chain of the recipe.

It is written from the architectures' published equations as functions of
a parameter dict whose names are the checkpoints' (HF names for the
backbones), in float32, with no kernel, cache or batching of the program's:
it imports nothing of the program. Where training draws randomness, it
draws it as the recipe does, in the same order and from the same
generators: dropout masks by ``torch.rand`` on the step's generator, the
fused blocks' dropout by the stateless hash of a seed drawn there
(``frozen.py``), SpecAugment and the modality dropout. So a training step
given the same generators drops the same elements as the program.

``Run.round_in`` / ``Run.round_grad`` round every product's inputs (and, in
training, the gradient that enters a product's backward): the identity for
the reference itself, per-tensor scaled float8 for the control.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import frozen

BACKBONES = (("text_encoder", "model"), ("audio_encoder", "model"), ("video_encoder", "vit"))
MODALITIES = ("text", "audio", "video")
PAIRS = ("text_to_audio", "text_to_video", "audio_to_text", "audio_to_video",
         "video_to_text", "video_to_audio")


# ------------------------------------------------------------ precision

def _fp8(x):
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _RoundIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Run:
    """How one forward runs. ``precision``: "f32" (the reference) or "fp8"
    (the control: float8 e4m3 products, per-tensor scales)."""

    def __init__(self, train=False, gen=None, precision="f32", checkpoint_frames=False):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.train, self.gen = train, gen
        self.gelu_tanh = False
        self.fp8 = precision == "fp8"
        self.checkpoint_frames = checkpoint_frames

    def round_in(self, x):
        return _RoundIn.apply(x) if self.fp8 else x

    def round_grad(self, y):
        return _RoundGrad.apply(y) if self.fp8 and torch.is_grad_enabled() else y

    def gelu(self, x):
        return F.gelu(x, approximate="tanh" if self.gelu_tanh else "none")

    def drop(self, x, rate):
        if not self.train or not rate:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))

    def kernel_seed(self, rate, device):
        if not self.train or not rate:
            return None
        return torch.randint(0, 2 ** 31 - 1, (1,), generator=self.gen, device=device,
                             dtype=torch.int32)


def mm(run, eq, a, b):
    return run.round_grad(torch.einsum(eq, run.round_in(a), run.round_in(b)))


def lin(run, P, name, x):
    w, b = P[name + ".weight"], P.get(name + ".bias")
    return run.round_grad(F.linear(run.round_in(x), run.round_in(w), b))


def ln(P, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], eps)


def softmax_attention(run, q, k, v, scale, keep=None, rate=0.0):
    """q [B, Q, H, D], k/v [B, K, H, D] → [B, Q, H, D]; ``keep``: the hash
    dropout's mask of the probabilities."""
    p = torch.softmax(mm(run, "bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - rate), torch.zeros((), device=p.device))
    return mm(run, "bhqk,bkhd->bqhd", p, v)


def mha(run, P, name, query, key, value, heads, rate):
    """torch ``nn.MultiheadAttention`` parameters; probabilities drop at ``rate``
    in training (a ``torch.rand`` mask)."""
    E = query.shape[-1]
    D = E // heads
    w, b = P[name + ".in_proj_weight"], P[name + ".in_proj_bias"]

    def proj(x, i):
        y = F.linear(run.round_in(x), run.round_in(w[i * E:(i + 1) * E]), b[i * E:(i + 1) * E])
        return run.round_grad(y).reshape(x.shape[0], x.shape[1], heads, D)

    q, k, v = proj(query, 0), proj(key, 1), proj(value, 2)
    s = mm(run, "bqhd,bkhd->bhqk", q, k) * D ** -0.5
    p = run.drop(torch.softmax(s, dim=-1), rate)
    out = mm(run, "bhqk,bkhd->bqhd", p, v).reshape(query.shape)
    return lin(run, P, name + ".out_proj", out)


def ffn(run, P, w1, w2, x, rate_mid, rate_out, seed):
    """GELU MLP with the fused blocks' hash dropout (salt 1 after the GELU,
    2 on the output)."""
    B, S, E = x.shape
    h = run.gelu(lin(run, P, w1, x))
    if rate_mid:
        keep = frozen.ffn_keep(seed, 1, B, S, h.shape[-1], rate_mid, x.device)
        h = torch.where(keep, h / (1.0 - rate_mid), torch.zeros((), device=x.device))
    y = lin(run, P, w2, h)
    if rate_out:
        keep = frozen.ffn_keep(seed, 2, B, S, E, rate_out, x.device)
        y = torch.where(keep, y / (1.0 - rate_out), torch.zeros((), device=x.device))
    return y


# ---------------------------------------------------------------- DeBERTa

def deberta(run, P, c, ids, mask):
    p = "text_encoder.model."
    E, H, eps = c["hidden_size"], c["num_attention_heads"], c["layer_norm_eps"]
    D = E // H
    B, S = ids.shape
    span, hd, ad = c["position_buckets"], c["hidden_dropout_prob"], c["attention_probs_dropout_prob"]
    c2p, p2c = (torch.from_numpy(t).to(ids.device)
                for t in frozen.rel_tables(S, span, c["max_position_embeddings"]))
    h = ln(P, p + "embeddings.LayerNorm", P[p + "embeddings.word_embeddings.weight"][ids], eps)
    h = run.drop(h * mask[..., None].float(), hd)
    rel = ln(P, p + "encoder.LayerNorm", P[p + "encoder.rel_embeddings.weight"], eps)
    for i in range(c["num_hidden_layers"]):
        lp = f"{p}encoder.layer.{i}."
        r = run.drop(rel, hd)
        q = lin(run, P, lp + "attention.self.query_proj", h).reshape(B, S, H, D)
        k = lin(run, P, lp + "attention.self.key_proj", h).reshape(B, S, H, D)
        v = lin(run, P, lp + "attention.self.value_proj", h).reshape(B, S, H, D)
        pos_k = lin(run, P, lp + "attention.self.key_proj", r).reshape(2 * span, H, D)
        pos_q = lin(run, P, lp + "attention.self.query_proj", r).reshape(2 * span, H, D)
        seed = run.kernel_seed(ad, ids.device)
        # content·content + content→position (rows q) + position→content (rows k)
        s = mm(run, "bqhd,bkhd->bhqk", q, k)
        qp = mm(run, "bqhd,phd->bhqp", q, pos_k)
        s = s + torch.gather(qp, 3, c2p.expand(B, H, S, S))
        kp = mm(run, "bkhd,phd->bhkp", k, pos_q)
        s = s + torch.gather(kp, 3, p2c.expand(B, H, S, S)).transpose(2, 3)
        s = torch.where(mask[:, None, None, :] > 0, s / math.sqrt(3.0 * D),
                        torch.full_like(s, -1e30))
        prob = torch.softmax(s, dim=-1)
        if seed is not None:
            keep = frozen.attention_keep(seed, B, H, S, S, ad, ids.device)
            prob = torch.where(keep, prob / (1.0 - ad), torch.zeros((), device=s.device))
        ctx = mm(run, "bhqk,bkhd->bqhd", prob, v).reshape(B, S, E)
        a = run.drop(lin(run, P, lp + "attention.output.dense", ctx), hd)
        h = ln(P, lp + "attention.output.LayerNorm", a + h, eps)
        seed = run.kernel_seed(hd, ids.device)
        y = ffn(run, P, lp + "intermediate.dense", lp + "output.dense", h, 0.0,
                hd if seed is not None else 0.0, seed)
        h = ln(P, lp + "output.LayerNorm", y + h, eps)
    return h


# --------------------------------------------------------------- wav2vec2

def wav2vec2(run, P, c, wav):
    p = "audio_encoder.model."
    E, H, eps = c["hidden_size"], c["num_attention_heads"], c["layer_norm_eps"]
    D = E // H
    x = wav[:, None, :]
    for i, (dim, stride) in enumerate(zip(c["conv_dim"], c["conv_stride"])):
        w = P[f"{p}feature_extractor.conv_layers.{i}.conv.weight"]
        x = run.round_grad(F.conv1d(run.round_in(x), run.round_in(w), stride=stride))
        if i == 0:
            gn = f"{p}feature_extractor.conv_layers.0.layer_norm"
            x = F.group_norm(x, dim, P[gn + ".weight"], P[gn + ".bias"], 1e-5)
        x = run.gelu(x)
    x = ln(P, p + "feature_projection.layer_norm", x.transpose(1, 2), eps)
    x = run.drop(lin(run, P, p + "feature_projection.projection", x), c["feat_proj_dropout"])
    B, S, _ = x.shape
    if run.train and c["mask_time_prob"] > 0:
        starts = (torch.rand((B, S), generator=run.gen, device=x.device)
                  < c["mask_time_prob"]).to(torch.int32)
        # frame t is masked when a span of mask_time_length started at t' in (t − L, t]
        run_ = starts.cumsum(dim=1)
        before = F.pad(run_, (c["mask_time_length"], 0))[:, :S]
        x = torch.where((run_ - before > 0)[..., None], P[p + "masked_spec_embed"], x)
    K, G = c["num_conv_pos_embeddings"], c["num_conv_pos_embedding_groups"]
    pc = p + "encoder.pos_conv_embed.conv."
    wv = P[pc + "weight_v"]
    w = P[pc + "weight_g"] * wv / wv.pow(2).sum(dim=(0, 1), keepdim=True).sqrt().clamp_min(1e-12)
    pos = run.round_grad(F.conv1d(run.round_in(x.transpose(1, 2)), run.round_in(w),
                                  P[pc + "bias"], padding=K // 2, groups=G))
    if K % 2 == 0:
        pos = pos[..., :-1]
    x = ln(P, p + "encoder.layer_norm", x + run.gelu(pos).transpose(1, 2), eps)
    x = run.drop(x, c["hidden_dropout"])
    for i in range(c["num_hidden_layers"]):
        lp = f"{p}encoder.layers.{i}."
        ar = c["attention_dropout"]
        seed = run.kernel_seed(ar, x.device)
        q, k, v = (lin(run, P, lp + f"attention.{n}_proj", x).reshape(B, S, H, D)
                   for n in ("q", "k", "v"))
        keep = None if seed is None else frozen.attention_keep(seed, B, H, S, S, ar, x.device)
        a = softmax_attention(run, q, k, v, D ** -0.5, keep=keep, rate=ar).reshape(B, S, E)
        a = run.drop(lin(run, P, lp + "attention.out_proj", a), c["hidden_dropout"])
        x = ln(P, lp + "layer_norm", x + a, eps)
        hr = c["hidden_dropout"]
        seed = run.kernel_seed(hr, x.device)
        rate = hr if seed is not None else 0.0
        y = ffn(run, P, lp + "feed_forward.intermediate_dense", lp + "feed_forward.output_dense",
                x, rate, rate, seed)
        x = ln(P, lp + "final_layer_norm", y + x, eps)
    return x


# -------------------------------------------------------------------- ViT

def _vit_layer(run, P, c, lp, x):
    E, H, eps = c["hidden_size"], c["num_attention_heads"], c["layer_norm_eps"]
    D = E // H
    N, S, _ = x.shape
    xn = ln(P, lp + "layernorm_before", x, eps)
    q, k, v = (lin(run, P, lp + f"attention.attention.{n}", xn).reshape(N, S, H, D)
               for n in ("query", "key", "value"))
    x = x + lin(run, P, lp + "attention.output.dense",
                softmax_attention(run, q, k, v, D ** -0.5).reshape(N, S, E))
    y = run.gelu(lin(run, P, lp + "intermediate.dense", ln(P, lp + "layernorm_after", x, eps)))
    return x + lin(run, P, lp + "output.dense", y)


def _vit_cls_layer(run, P, c, lp, x):
    """The last layer needs only the CLS row: its query against every key."""
    E, H, eps = c["hidden_size"], c["num_attention_heads"], c["layer_norm_eps"]
    D = E // H
    N, S, _ = x.shape
    xn = ln(P, lp + "layernorm_before", x, eps)
    q = lin(run, P, lp + "attention.attention.query", xn[:, :1]).reshape(N, 1, H, D)
    k, v = (lin(run, P, lp + f"attention.attention.{n}", xn).reshape(N, S, H, D)
            for n in ("key", "value"))
    h = x[:, :1] + lin(run, P, lp + "attention.output.dense",
                       softmax_attention(run, q, k, v, D ** -0.5).reshape(N, 1, E))
    y = run.gelu(lin(run, P, lp + "intermediate.dense", ln(P, lp + "layernorm_after", h, eps)))
    return h + lin(run, P, lp + "output.dense", y)


def vit_cls(run, P, c, frames):
    """frames [N, H, W, 3] in [0, 1] → the final-normed CLS vector [N, E]."""
    if c["hidden_dropout_prob"] or c["attention_probs_dropout_prob"]:
        raise NotImplementedError("the reference covers ViT without dropout, as configured")
    p = "video_encoder.vit."
    pe = p + "embeddings."
    w = P[pe + "patch_embeddings.projection.weight"]
    x = run.round_grad(F.conv2d(run.round_in(frames.permute(0, 3, 1, 2)), run.round_in(w),
                                P[pe + "patch_embeddings.projection.bias"],
                                stride=c["patch_size"]))
    x = x.flatten(2).transpose(1, 2)
    cls = P[pe + "cls_token"].expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + P[pe + "position_embeddings"]
    L = c["num_hidden_layers"]
    for i in range(L - 1):
        lp = f"{p}encoder.layer.{i}."
        if run.checkpoint_frames:  # no random draw inside: recomputing is exact
            x = checkpoint(_vit_layer, run, P, c, lp, x, use_reentrant=False)
        else:
            x = _vit_layer(run, P, c, lp, x)
    x = _vit_cls_layer(run, P, c, f"{p}encoder.layer.{L - 1}.", x)
    return ln(P, p + "layernorm", x, c["layer_norm_eps"])[:, 0]


def lstm(run, P, name, x, layers, rate):
    """Bidirectional LSTM, gates i, f, g, o; dropout between layers."""
    out = x
    for layer in range(layers):
        dirs = []
        for suffix in ("", "_reverse"):
            w_ih, w_hh = P[f"{name}.weight_ih_l{layer}{suffix}"], P[f"{name}.weight_hh_l{layer}{suffix}"]
            b = P[f"{name}.bias_ih_l{layer}{suffix}"] + P[f"{name}.bias_hh_l{layer}{suffix}"]
            xs = run.round_grad(F.linear(run.round_in(out), run.round_in(w_ih), b))
            Hh = w_hh.shape[1]
            h = c = out.new_zeros(out.shape[0], Hh)
            steps = range(out.shape[1] - 1, -1, -1) if suffix else range(out.shape[1])
            hs = [None] * out.shape[1]
            for t in steps:
                gates = xs[:, t] + run.round_grad(F.linear(run.round_in(h), run.round_in(w_hh)))
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs[t] = h
            dirs.append(torch.stack(hs, dim=1))
        out = torch.cat(dirs, dim=-1)
        if layer < layers - 1:
            out = run.drop(out, rate)
    return out


# ----------------------------------------------------------------- fusion

def info_nce(z1, z2, temperature):
    sim = (z1 @ z2.t()) / temperature
    labels = torch.arange(z1.shape[0], device=z1.device)
    return 0.5 * (F.cross_entropy(sim, labels) + F.cross_entropy(sim.t(), labels))


def hierarchical(run, P, pc, t, a, v, contrastive):
    f = "fusion_layer."
    p = pc["fusion_dropout"]
    relu = torch.relu
    # early
    x = run.drop(relu(lin(run, P, f + "early_fusion.fusion_layers.0", torch.cat([t, a, v], -1))), p)
    early = run.drop(relu(lin(run, P, f + "early_fusion.fusion_layers.3", x)), p)
    # MulT over length-1 sequences
    seq = {m: x[:, None, :] for m, x in zip(MODALITIES, (t, a, v))}
    heads = pc["fusion_num_heads"]

    def cross(name, q, kv):
        cp = f + "mult_fusion." + name
        x = ln(P, cp + ".norm1", q + mha(run, P, cp + ".attention", q, kv, kv, heads, p), 1e-6)
        h = run.drop(relu(lin(run, P, cp + ".ffn.0", x)), p)
        return ln(P, cp + ".norm2", x + lin(run, P, cp + ".ffn.3", h), 1e-6)

    enh = {}
    for m in MODALITIES:
        o1, o2 = (n for n in MODALITIES if n != m)
        enh[m] = seq[m] + cross(f"{m}_to_{o1}", seq[m], seq[o1]) + cross(f"{m}_to_{o2}", seq[m], seq[o2])
    att = [mha(run, P, f"{f}mult_fusion.{m}_self_attn", enh[m], enh[m], enh[m], heads, p).mean(1)
           for m in MODALITIES]
    mult = run.drop(relu(lin(run, P, f + "mult_fusion.final_fusion.0", torch.cat(att, -1))), p)
    # dense GAT over the three modality nodes
    gp = f + "graph_fusion."
    x = torch.stack([t, a, v], dim=1) + P[gp + "node_type_embedding.weight"]
    for i in range(pc["graph_num_layers"]):
        lp = f"{gp}gcn_layers.{i}."
        src, dst = P[lp + "att_src"], P[lp + "att_dst"]
        Hh, C = src.shape[1], src.shape[2]
        B, N, _ = x.shape
        xp = lin(run, P, lp + "lin", x).reshape(B, N, Hh, C)
        s = (xp * src).sum(-1)
        d = (xp * dst).sum(-1)
        e = F.leaky_relu(d[:, :, None, :] + s[:, None, :, :], 0.2)
        alpha = run.drop(torch.softmax(e, dim=2), pc["graph_dropout"])
        x = relu(mm(run, "bijh,bjhc->bihc", alpha, xp).mean(dim=2) + P[lp + "bias"])
    graph = lin(run, P, gp + "output_projection", x.mean(dim=1))
    # contrastive
    cp = f + "contrastive_fusion."
    proj = []
    for m, x in zip(MODALITIES, (t, a, v)):
        h = lin(run, P, f"{cp}{m}_projector.2", relu(lin(run, P, f"{cp}{m}_projector.0", x)))
        proj.append(h * torch.rsqrt(h.pow(2).sum(-1, keepdim=True) + 1e-12))
    losses = []
    if contrastive:
        T = pc["contrastive_temperature"]
        losses = [info_nce(proj[0], proj[1], T), info_nce(proj[0], proj[2], T),
                  info_nce(proj[1], proj[2], T)]
    contr = run.drop(relu(lin(run, P, cp + "fusion_layer.0", torch.cat([t, a, v], -1))), p)
    # adaptive
    ap = f + "adaptive_fusion."
    stacked = torch.stack([lin(run, P, f"{ap}{m}_transform", x)
                           for m, x in zip(MODALITIES, (t, a, v))], dim=1)
    attended = mha(run, P, ap + "attention", stacked, stacked, stacked, heads, p)
    w = relu(lin(run, P, ap + "weight_predictor.0", torch.cat([t, a, v], -1)))
    w = torch.softmax(lin(run, P, ap + "weight_predictor.2", w), dim=-1)
    adaptive = run.drop(relu(lin(run, P, ap + "fusion_layer.0", (attended * w[..., None]).sum(1))), p)
    # meta
    h = run.drop(relu(lin(run, P, f + "meta_fusion.0",
                          torch.cat([early, mult, graph, contr, adaptive], -1))), p)
    return lin(run, P, f + "meta_fusion.3", h), losses


# ------------------------------------------------------------------ model

def forward(run, P, cfg, ids, mask, wav, frames, contrastive=False):
    """ids/mask [B, S] int64, wav [B, T] f32, frames [B, T, H, W, 3] in [0, 1]
    → dict of logits, probabilities, valence, arousal and the contrastive losses."""
    pc = cfg["program"]
    # the configuration's GELU: its tanh form where it computes in bf16
    run.gelu_tanh = pc["mixed_precision"] and pc["compute_dtype"] == "bfloat16"
    p = pc["fusion_dropout"]
    t = deberta(run, P, cfg["text"], ids, mask)[:, 0]  # 'bert' in deberta-v2: the CLS row
    t = run.drop(lin(run, P, "text_encoder.projection", t), p)
    s = wav2vec2(run, P, cfg["audio"], wav)
    s = mha(run, P, "audio_encoder.temporal_attention", s, s, s, 8, p)
    a = run.drop(lin(run, P, "audio_encoder.projection", s.mean(1)), p)
    B, T = frames.shape[:2]
    cls = vit_cls(run, P, cfg["video"], frames.reshape((B * T,) + frames.shape[2:]))
    seq = lstm(run, P, "video_encoder.temporal_lstm", cls.reshape(B, T, -1), 2, p)
    seq = mha(run, P, "video_encoder.facial_attention", seq, seq, seq, 8, p)
    v = run.drop(lin(run, P, "video_encoder.projection", seq.mean(1)), p)
    if run.train:  # modality dropout: per sample, at least one modality kept
        keep = torch.rand((B, 3), generator=run.gen, device=t.device) > 0.1
        revive = F.one_hot(torch.randint(0, 3, (B,), generator=run.gen, device=t.device), 3).bool()
        keep = torch.where(keep.any(dim=1, keepdim=True), keep, revive).float()
        t, a, v = t * keep[:, 0:1], a * keep[:, 1:2], v * keep[:, 2:3]
    fused, losses = hierarchical(run, P, pc, t, a, v, contrastive)
    h = run.drop(torch.relu(lin(run, P, "classifier.classifier.0", fused)), p)
    logits = lin(run, P, "classifier.classifier.3", h)
    return {"logits": logits, "probs": torch.softmax(logits, dim=-1),
            "valence": lin(run, P, "valence_regressor", fused)[:, 0],
            "arousal": lin(run, P, "arousal_regressor", fused)[:, 0],
            "contrastive": losses}


def loss(out, labels, smoothing=0.1, contrastive_weight=0.1):
    logp = torch.log_softmax(out["logits"], dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    main = ((1.0 - smoothing) * nll + smoothing * -logp.mean(dim=-1)).mean()
    return main + contrastive_weight * sum(out["contrastive"], torch.zeros((), device=main.device))


# ------------------------------------------------------------- parameters

def spec(cfg):
    """[(name, shape, init)] of every parameter. init: ("normal", std),
    ("uniform", lo, hi), ("ones",) or ("zeros",)."""
    pc, tc, ac, vc = cfg["program"], cfg["text"], cfg["audio"], cfg["video"]
    F_, G, n_emo = pc["fusion_hidden_size"], pc["graph_hidden_size"], pc["num_emotions"]
    out = []

    def linear(name, i, o, bias=True):
        out.append((name + ".weight", (o, i), ("normal", i ** -0.5)))
        if bias:
            out.append((name + ".bias", (o,), ("zeros",)))

    def norm(name, n):
        out.append((name + ".weight", (n,), ("ones",)))
        out.append((name + ".bias", (n,), ("zeros",)))

    def attn(name, e):
        out.append((name + ".in_proj_weight", (3 * e, e), ("normal", e ** -0.5)))
        out.append((name + ".in_proj_bias", (3 * e,), ("zeros",)))
        linear(name + ".out_proj", e, e)

    # DeBERTa
    p, E, Fd = "text_encoder.model.", tc["hidden_size"], tc["intermediate_size"]
    out.append((p + "embeddings.word_embeddings.weight", (tc["vocab_size"], E), ("normal", 0.02)))
    norm(p + "embeddings.LayerNorm", E)
    out.append((p + "encoder.rel_embeddings.weight", (2 * tc["position_buckets"], E), ("normal", 0.02)))
    norm(p + "encoder.LayerNorm", E)
    for i in range(tc["num_hidden_layers"]):
        lp = f"{p}encoder.layer.{i}."
        for n in ("query_proj", "key_proj", "value_proj"):
            linear(lp + "attention.self." + n, E, E)
        linear(lp + "attention.output.dense", E, E)
        norm(lp + "attention.output.LayerNorm", E)
        linear(lp + "intermediate.dense", E, Fd)
        linear(lp + "output.dense", Fd, E)
        norm(lp + "output.LayerNorm", E)
    linear("text_encoder.projection", E, F_)
    # wav2vec2
    p, E, Fd = "audio_encoder.model.", ac["hidden_size"], ac["intermediate_size"]
    cin = 1
    for i, (dim, k) in enumerate(zip(ac["conv_dim"], ac["conv_kernel"])):
        out.append((f"{p}feature_extractor.conv_layers.{i}.conv.weight", (dim, cin, k),
                    ("normal", (cin * k) ** -0.5)))
        if i == 0:
            norm(f"{p}feature_extractor.conv_layers.0.layer_norm", dim)
        cin = dim
    norm(p + "feature_projection.layer_norm", cin)
    linear(p + "feature_projection.projection", cin, E)
    K, Gr = ac["num_conv_pos_embeddings"], ac["num_conv_pos_embedding_groups"]
    out.append((p + "encoder.pos_conv_embed.conv.weight_g", (1, 1, K), ("ones",)))
    out.append((p + "encoder.pos_conv_embed.conv.weight_v", (E, E // Gr, K), ("normal", 0.02)))
    out.append((p + "encoder.pos_conv_embed.conv.bias", (E,), ("zeros",)))
    norm(p + "encoder.layer_norm", E)
    for i in range(ac["num_hidden_layers"]):
        lp = f"{p}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(lp + "attention." + n, E, E)
        norm(lp + "layer_norm", E)
        linear(lp + "feed_forward.intermediate_dense", E, Fd)
        linear(lp + "feed_forward.output_dense", Fd, E)
        norm(lp + "final_layer_norm", E)
    out.append((p + "masked_spec_embed", (E,), ("uniform", 0.0, 1.0)))
    attn("audio_encoder.temporal_attention", E)
    linear("audio_encoder.projection", E, F_)
    # ViT + biLSTM + facial attention
    p, E, Fd = "video_encoder.vit.", vc["hidden_size"], vc["intermediate_size"]
    P_ = vc["patch_size"]
    n_patch = (vc["image_size"] // P_) ** 2
    out.append((p + "embeddings.cls_token", (1, 1, E), ("normal", 0.02)))
    out.append((p + "embeddings.position_embeddings", (1, 1 + n_patch, E), ("normal", 0.02)))
    out.append((p + "embeddings.patch_embeddings.projection.weight", (E, 3, P_, P_),
                ("normal", (3 * P_ * P_) ** -0.5)))
    out.append((p + "embeddings.patch_embeddings.projection.bias", (E,), ("zeros",)))
    for i in range(vc["num_hidden_layers"]):
        lp = f"{p}encoder.layer.{i}."
        norm(lp + "layernorm_before", E)
        for n in ("query", "key", "value"):
            linear(lp + "attention.attention." + n, E, E)
        linear(lp + "attention.output.dense", E, E)
        norm(lp + "layernorm_after", E)
        linear(lp + "intermediate.dense", E, Fd)
        linear(lp + "output.dense", Fd, E)
    norm(p + "layernorm", E)
    Hh = E // 2
    bound = Hh ** -0.5
    for layer in range(2):
        for suffix in ("", "_reverse"):
            lp = "video_encoder.temporal_lstm."
            inp = E if layer == 0 else 2 * Hh
            out.append((f"{lp}weight_ih_l{layer}{suffix}", (4 * Hh, inp), ("uniform", -bound, bound)))
            out.append((f"{lp}weight_hh_l{layer}{suffix}", (4 * Hh, Hh), ("uniform", -bound, bound)))
            out.append((f"{lp}bias_ih_l{layer}{suffix}", (4 * Hh,), ("uniform", -bound, bound)))
            out.append((f"{lp}bias_hh_l{layer}{suffix}", (4 * Hh,), ("uniform", -bound, bound)))
    attn("video_encoder.facial_attention", E)
    linear("video_encoder.projection", E, F_)
    # fusion
    f = "fusion_layer."
    linear(f + "early_fusion.fusion_layers.0", 3 * F_, 2 * F_)
    linear(f + "early_fusion.fusion_layers.3", 2 * F_, F_)
    for name in PAIRS:
        cp = f + "mult_fusion." + name
        attn(cp + ".attention", F_)
        norm(cp + ".norm1", F_)
        norm(cp + ".norm2", F_)
        linear(cp + ".ffn.0", F_, 4 * F_)
        linear(cp + ".ffn.3", 4 * F_, F_)
    for m in MODALITIES:
        attn(f"{f}mult_fusion.{m}_self_attn", F_)
    linear(f + "mult_fusion.final_fusion.0", 3 * F_, F_)
    heads = 4
    for i in range(pc["graph_num_layers"]):
        lp = f"{f}graph_fusion.gcn_layers.{i}."
        glorot = math.sqrt(6.0 / (heads + G))
        out.append((lp + "att_src", (1, heads, G), ("uniform", -glorot, glorot)))
        out.append((lp + "att_dst", (1, heads, G), ("uniform", -glorot, glorot)))
        out.append((lp + "bias", (G,), ("zeros",)))
        linear(lp + "lin", F_ if i == 0 else G, heads * G, bias=False)
    out.append((f + "graph_fusion.node_type_embedding.weight", (3, F_), ("normal", 0.02)))
    linear(f + "graph_fusion.output_projection", G, F_)
    for m in MODALITIES:
        linear(f"{f}contrastive_fusion.{m}_projector.0", F_, F_)
        linear(f"{f}contrastive_fusion.{m}_projector.2", F_, F_ // 2)
    linear(f + "contrastive_fusion.fusion_layer.0", 3 * F_, F_)
    attn(f + "adaptive_fusion.attention", F_)
    for m in MODALITIES:
        linear(f"{f}adaptive_fusion.{m}_transform", F_, F_)
    linear(f + "adaptive_fusion.weight_predictor.0", 3 * F_, F_)
    linear(f + "adaptive_fusion.weight_predictor.2", F_, 3)
    linear(f + "adaptive_fusion.fusion_layer.0", F_, F_)
    linear(f + "meta_fusion.0", 5 * F_, 2 * F_)
    linear(f + "meta_fusion.3", 2 * F_, F_)
    # heads
    linear("classifier.classifier.0", F_, F_ // 2)
    linear("classifier.classifier.3", F_ // 2, n_emo)
    linear("classifier.sentiment_classifier", F_, 3)
    linear("classifier.positive_classifier", F_, 2)
    linear("classifier.negative_classifier", F_, 4)
    linear("valence_regressor", F_, 1)
    linear("arousal_regressor", F_, 1)
    linear("uncertainty_head", F_, n_emo)
    return out


def is_backbone(name):
    keys = name.split(".")
    return any((a, b) in BACKBONES for a, b in zip(keys, keys[1:]))


# -------------------------------------------------------------- optimizer

def schedule(lr, total_steps, count, pct_start=0.1):
    """OneCycle (cos): linear warm-up from lr/25 over round(pct·total) steps,
    then cosine decay to lr/25/1e4."""
    total = max(total_steps, 2)
    warm = min(max(int(round(total * pct_start)), 1), total - 1)
    init = lr / 25.0
    if count < warm:
        return (init - lr) * (1.0 - count / warm) + lr
    alpha = init / 1e4 / lr
    c = min(count - warm, total - warm)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / (total - warm))) + alpha)


class AdamW:
    """Clip by global norm (scale max/‖g‖ when ‖g‖ ≥ max), Adam (0.9, 0.999,
    ε 1e-8 outside the root, bias-corrected), + wd·p, ×0.1 on the backbones,
    ×(−lr(step))."""

    def __init__(self, names, params, cfg, backbone_scale=0.1, b1=0.9, b2=0.999, eps=1e-8):
        pc = cfg["program"]
        self.names, self.params = names, params
        self.lr, self.wd, self.clip = pc["learning_rate"], pc["weight_decay"], pc["gradient_clip_norm"]
        self.total = cfg["total_steps"]
        self.scale = [backbone_scale if is_backbone(n) else 1.0 for n in names]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads):
        """Applies one step; returns the clipped gradients."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        coef = 1.0 if norm < self.clip else self.clip / norm
        grads = [g * coef for g in grads]
        lr = schedule(self.lr, self.total, self.count)
        self.count += 1
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.m[i].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[i].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = self.m[i] / (1 - self.b1 ** self.count)
            vh = self.v[i] / (1 - self.b2 ** self.count)
            upd = mh / (vh.sqrt() + self.eps) + self.wd * p
            p.add_(upd * self.scale[i], alpha=-lr)
        return grads


def leaf_norms(tensors):
    return np.array([float(t.double().norm()) for t in tensors])
