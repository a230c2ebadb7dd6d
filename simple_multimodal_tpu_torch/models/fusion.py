"""Multimodal fusion (port of simple_multimodal_tpu/models/fusion.py): the
seven strategies (early, late, MulT, dense 3-node GAT, contrastive,
adaptive, and ``HierarchicalFusion`` over five of them), with the
reference's state-dict names (Sequential indices such as
``fusion_layers.0``).

As in the JAX package, GraphFusion is a dense graph-attention network over
the three fully connected modality nodes, and the GAT stack maps
fusion_hidden → graph_hidden in its first layer and graph_hidden →
graph_hidden after it.

In training mode every ``fusion_dropout`` site of the JAX modules runs
(the ``nn.Dropout`` entries of the Sequentials hold that rate, so the
state-dict names keep the reference's indices), the attention
probabilities take dropout inside each MultiHeadAttention, and the GAT
coefficients at ``graph_dropout``; masks come from the caller's generator.
The contrastive loss takes its negatives from the global batch under a
data-parallel mesh (``info_nce``).
"""
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import MultiHeadAttention, dropout, layer_norm, linear
from ..parallel.mesh import gather_rows


class EarlyFusion(nn.Module):
    """Concat → MLP."""

    def __init__(self, config):
        super().__init__()
        Fh, p = config.fusion_hidden_size, config.fusion_dropout
        self.fusion_layers = nn.Sequential(
            nn.Linear(3 * Fh, 2 * Fh), nn.ReLU(), nn.Dropout(p),
            nn.Linear(2 * Fh, Fh), nn.ReLU(), nn.Dropout(p))

    def forward(self, text, audio, video, dtype, gen=None):
        layers, train = self.fusion_layers, self.training
        x = torch.cat([text, audio, video], dim=-1)
        x = dropout(torch.relu(linear(x, layers[0], dtype)), layers[2].p, gen, train)
        return dropout(torch.relu(linear(x, layers[3], dtype)), layers[5].p, gen, train)


class LateFusion(nn.Module):
    """One classifier per modality, their logits mixed by the softmax of a
    learned 3-vector (initialised to 1/3 each). As in the JAX module the
    softmax runs on the f32 parameter and the mix is f32: JAX promotes the
    compute-dtype logits against the f32 weights."""

    def __init__(self, config):
        super().__init__()
        Fh, n = config.fusion_hidden_size, config.num_emotions
        self.text_classifier = nn.Linear(Fh, n)
        self.audio_classifier = nn.Linear(Fh, n)
        self.video_classifier = nn.Linear(Fh, n)
        self.fusion_weights = nn.Parameter(torch.ones(3) / 3.0)

    def forward(self, text, audio, video, dtype, gen=None) -> Dict[str, torch.Tensor]:
        logits = [linear(x, c, dtype) for x, c in ((text, self.text_classifier),
                                                    (audio, self.audio_classifier),
                                                    (video, self.video_classifier))]
        w = torch.softmax(self.fusion_weights.float(), dim=0)
        fused = sum(w[i] * lg.float() for i, lg in enumerate(logits))
        return {"fused_logits": fused, "text_logits": logits[0], "audio_logits": logits[1],
                "video_logits": logits[2], "fusion_weights": w}


class CrossModalTransformer(nn.Module):
    """MHA + add&norm + FFN + add&norm."""

    def __init__(self, config):
        super().__init__()
        Fh, p = config.fusion_hidden_size, config.fusion_dropout
        self.attention = MultiHeadAttention(Fh, config.fusion_num_heads, p)
        self.norm1 = nn.LayerNorm(Fh, eps=1e-6)
        self.norm2 = nn.LayerNorm(Fh, eps=1e-6)
        self.ffn = nn.Sequential(nn.Linear(Fh, 4 * Fh), nn.ReLU(), nn.Dropout(p),
                                 nn.Linear(4 * Fh, Fh))

    def forward(self, query, key_value, dtype, gen=None):
        attn, _ = self.attention(query, key_value, key_value, dtype, need_weights=False,
                                 gen=gen)
        x = layer_norm(query + attn, self.norm1, dtype)
        h = torch.relu(linear(x, self.ffn[0], dtype))
        h = dropout(h, self.ffn[2].p, gen, self.training)
        return layer_norm(x + linear(h, self.ffn[3], dtype), self.norm2, dtype)


class MultimodalTransformer(nn.Module):
    """MulT: six directed cross-modal blocks + per-modality self-attention."""

    PAIRS = ("text_to_audio", "text_to_video", "audio_to_text",
             "audio_to_video", "video_to_text", "video_to_audio")

    def __init__(self, config):
        super().__init__()
        Fh, p = config.fusion_hidden_size, config.fusion_dropout
        for name in self.PAIRS:
            setattr(self, name, CrossModalTransformer(config))
        for m in ("text", "audio", "video"):
            setattr(self, f"{m}_self_attn",
                    MultiHeadAttention(Fh, config.fusion_num_heads, p))
        self.final_fusion = nn.Sequential(nn.Linear(3 * Fh, Fh), nn.ReLU(), nn.Dropout(p))

    def forward(self, text, audio, video, dtype, gen=None) -> Dict[str, torch.Tensor]:
        # pooled [B, E] features are length-1 sequences
        t, a, v = (x[:, None, :] for x in (text, audio, video))
        enh_t = t + self.text_to_audio(t, a, dtype, gen) + self.text_to_video(t, v, dtype, gen)
        enh_a = a + self.audio_to_text(a, t, dtype, gen) + self.audio_to_video(a, v, dtype, gen)
        enh_v = v + self.video_to_text(v, t, dtype, gen) + self.video_to_audio(v, a, dtype, gen)

        def self_attn(mod, x):
            return mod(x, x, x, dtype, need_weights=False, gen=gen)[0].mean(dim=1)

        t_att = self_attn(self.text_self_attn, enh_t)
        a_att = self_attn(self.audio_self_attn, enh_a)
        v_att = self_attn(self.video_self_attn, enh_v)
        fused = torch.relu(linear(torch.cat([t_att, a_att, v_att], dim=-1),
                                  self.final_fusion[0], dtype))
        fused = dropout(fused, self.final_fusion[2].p, gen, self.training)
        return {"fused_features": fused, "text_features": t_att,
                "audio_features": a_att, "video_features": v_att}


class DenseGATLayer(nn.Module):
    """One GAT layer (torch_geometric ``GATConv(heads, concat=False)`` with
    self-loops) over a dense graph: per-head logits
    LeakyReLU(a_src·Wx_j + a_dst·Wx_i) softmaxed over sources j, output
    averaged over heads, plus bias."""

    def __init__(self, in_features: int, out_features: int, heads: int = 4,
                 negative_slope: float = 0.2, dropout: float = 0.1):
        super().__init__()
        self.heads, self.out_features, self.negative_slope = heads, out_features, negative_slope
        self.dropout = dropout
        self.lin = nn.Linear(in_features, heads * out_features, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, out_features))
        self.att_dst = nn.Parameter(torch.empty(1, heads, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x, dtype, gen=None):
        B, N, _ = x.shape
        H, C = self.heads, self.out_features
        xp = linear(x, self.lin, dtype).reshape(B, N, H, C)
        s = torch.einsum("bnhc,ohc->bnh", xp, self.att_src.to(dtype))
        d = torch.einsum("bnhc,ohc->bnh", xp, self.att_dst.to(dtype))
        e = F.leaky_relu(d[:, :, None, :] + s[:, None, :, :], self.negative_slope)
        alpha = torch.softmax(e.float(), dim=2).to(dtype)  # over sources j
        alpha = dropout(alpha, self.dropout, gen, self.training)
        out = torch.einsum("bijh,bjhc->bihc", alpha.float(), xp.float()).to(dtype)
        return out.mean(dim=2) + self.bias.to(dtype)


class GraphFusion(nn.Module):
    def __init__(self, config):
        super().__init__()
        Fh, G = config.fusion_hidden_size, config.graph_hidden_size
        self.gcn_layers = nn.ModuleList(
            DenseGATLayer(Fh if i == 0 else G, G, dropout=config.graph_dropout)
            for i in range(config.graph_num_layers))
        self.node_type_embedding = nn.Embedding(3, Fh)
        self.output_projection = nn.Linear(G, Fh)

    def forward(self, text, audio, video, dtype, gen=None):
        x = torch.stack([text, audio, video], dim=1) + self.node_type_embedding.weight.to(dtype)
        for layer in self.gcn_layers:
            x = torch.relu(layer(x, dtype, gen))
        return linear(x.mean(dim=1), self.output_projection, dtype)


def info_nce(z1: torch.Tensor, z2: torch.Tensor, temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch pairs. Under a data-parallel mesh the
    negatives are the global batch, as under the JAX mesh: every rank
    gathers all ranks' rows (``gather_rows``, the gradient reaching the rank
    that owns each row) and computes the same global loss."""
    z1, z2 = gather_rows(z1), gather_rows(z2)
    sim = (z1.float() @ z2.float().t()) / temperature
    labels = torch.arange(z1.shape[0], device=z1.device)
    return 0.5 * (F.cross_entropy(sim, labels) + F.cross_entropy(sim.t(), labels))


class ContrastiveFusion(nn.Module):
    def __init__(self, config):
        super().__init__()
        Fh = config.fusion_hidden_size
        self.temperature = config.contrastive_temperature
        for m in ("text", "audio", "video"):
            setattr(self, f"{m}_projector",
                    nn.Sequential(nn.Linear(Fh, Fh), nn.ReLU(), nn.Linear(Fh, Fh // 2)))
        self.fusion_layer = nn.Sequential(nn.Linear(3 * Fh, Fh), nn.ReLU(),
                                          nn.Dropout(config.fusion_dropout))

    def _project(self, proj, x, dtype):
        h = linear(torch.relu(linear(x, proj[0], dtype)), proj[2], dtype)
        # smooth L2 normalisation: a zero vector (a missing modality) stays finite
        sq = h.float().pow(2).sum(dim=-1, keepdim=True)
        return h * torch.rsqrt(sq + 1e-12).to(dtype)

    def forward(self, text, audio, video, dtype, compute_contrastive_loss: bool = False,
                gen=None):
        tp = self._project(self.text_projector, text, dtype)
        ap = self._project(self.audio_projector, audio, dtype)
        vp = self._project(self.video_projector, video, dtype)
        losses = {}
        if compute_contrastive_loss:
            t = self.temperature
            losses = {"text_audio": info_nce(tp, ap, t), "text_video": info_nce(tp, vp, t),
                      "audio_video": info_nce(ap, vp, t)}
        fused = torch.relu(linear(torch.cat([text, audio, video], dim=-1),
                                  self.fusion_layer[0], dtype))
        fused = dropout(fused, self.fusion_layer[2].p, gen, self.training)
        return {"fused_features": fused, "text_proj": tp, "audio_proj": ap,
                "video_proj": vp, "contrastive_losses": losses}


class AdaptiveFusion(nn.Module):
    def __init__(self, config):
        super().__init__()
        Fh, p = config.fusion_hidden_size, config.fusion_dropout
        self.attention = MultiHeadAttention(Fh, config.fusion_num_heads, p)
        self.text_transform = nn.Linear(Fh, Fh)
        self.audio_transform = nn.Linear(Fh, Fh)
        self.video_transform = nn.Linear(Fh, Fh)
        self.weight_predictor = nn.Sequential(nn.Linear(3 * Fh, Fh), nn.ReLU(),
                                              nn.Linear(Fh, 3))
        self.fusion_layer = nn.Sequential(nn.Linear(Fh, Fh), nn.ReLU(), nn.Dropout(p))

    def forward(self, text, audio, video, dtype, gen=None):
        stacked = torch.stack([linear(text, self.text_transform, dtype),
                               linear(audio, self.audio_transform, dtype),
                               linear(video, self.video_transform, dtype)], dim=1)
        attended, attention_weights = self.attention(stacked, stacked, stacked, dtype, gen=gen)
        w = torch.relu(linear(torch.cat([text, audio, video], dim=-1),
                              self.weight_predictor[0], dtype))
        adaptive_weights = torch.softmax(
            linear(w, self.weight_predictor[2], dtype).float(), dim=-1).to(dtype)
        weighted = (attended * adaptive_weights[..., None]).sum(dim=1)
        out = torch.relu(linear(weighted, self.fusion_layer[0], dtype))
        out = dropout(out, self.fusion_layer[2].p, gen, self.training)
        return {"fused_features": out, "attention_weights": attention_weights,
                "adaptive_weights": adaptive_weights}


class HierarchicalFusion(nn.Module):
    """Meta-fusion over early + MulT + graph + contrastive + adaptive."""

    def __init__(self, config):
        super().__init__()
        Fh = config.fusion_hidden_size
        self.early_fusion = EarlyFusion(config)
        self.mult_fusion = MultimodalTransformer(config)
        self.graph_fusion = GraphFusion(config)
        self.contrastive_fusion = ContrastiveFusion(config)
        self.adaptive_fusion = AdaptiveFusion(config)
        self.meta_fusion = nn.Sequential(nn.Linear(5 * Fh, 2 * Fh), nn.ReLU(),
                                         nn.Dropout(config.fusion_dropout),
                                         nn.Linear(2 * Fh, Fh))

    def forward(self, text, audio, video, dtype, compute_contrastive_loss: bool = False,
                gen=None):
        early = self.early_fusion(text, audio, video, dtype, gen)
        mult = self.mult_fusion(text, audio, video, dtype, gen)
        graph = self.graph_fusion(text, audio, video, dtype, gen)
        contrastive = self.contrastive_fusion(text, audio, video, dtype,
                                              compute_contrastive_loss, gen)
        adaptive = self.adaptive_fusion(text, audio, video, dtype, gen)
        all_features = torch.cat([early, mult["fused_features"], graph,
                                  contrastive["fused_features"],
                                  adaptive["fused_features"]], dim=-1)
        h = torch.relu(linear(all_features, self.meta_fusion[0], dtype))
        h = dropout(h, self.meta_fusion[2].p, gen, self.training)
        final = linear(h, self.meta_fusion[3], dtype)
        return {
            "fused_features": final,
            "early_features": early,
            "mult_features": mult["fused_features"],
            "graph_features": graph,
            "contrastive_features": contrastive["fused_features"],
            "adaptive_features": adaptive["fused_features"],
            "contrastive_losses": contrastive["contrastive_losses"],
            "attention_weights": adaptive["attention_weights"],
            "adaptive_weights": adaptive["adaptive_weights"],
        }
