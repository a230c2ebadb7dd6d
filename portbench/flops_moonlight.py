"""The work of the Moonlight configuration, counted from its file as
``flops.py`` counts the rest of the model (a multiply-add is 2, products
only, where the architecture puts them).

The text tower, per token of the padded length S and per layer:
- ``linear``: MLA's q_proj, kv_a_proj_with_mqa, kv_b_proj and o_proj; the
  dense FFN (three products) in the first ``first_k_dense_replace`` layers;
  in each MoE layer the router, the shared experts (three products of
  ``n_shared_experts`` expert widths) and the routed experts at their
  expected share: ``num_experts_per_tok`` · held / ``router_experts`` of a
  token's six go to an expert held here, each three products;
- ``attention``: q·kᵀ over nope + rope and p·v over the value width,
  causal, so half the square S².

The rest (wav2vec2, ViT + biLSTM, fusion, heads, the text projection from
the tower's width) is ``flops.forward`` on ``reference/moonlight.rest_config``.
A train step is forward once and backward twice (``flops.TRAIN_FACTOR``).
"""
from portbench import flops
from portbench.reference import moonlight as ml


def expert_products(cfg, rows):
    """FLOP of ``rows`` rows through one routed expert (three products), forward."""
    c = ml.tower_config(cfg)
    return rows * 3 * 2 * c["hidden_size"] * c["moe_intermediate_size"]


def tower_forward(cfg, batch):
    """{"linear", "attention", "experts"} FLOP of the tower's forward on
    ``batch`` clips (``experts``: the routed experts' part of ``linear``)."""
    c = ml.tower_config(cfg)
    S = cfg["program"]["text_max_length"]
    E, H, rank = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    L, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    mla = 2 * (E * H * (nope + rp) + E * (rank + rp) + rank * H * (nope + dv) + H * dv * E)
    ffn = 3 * 2 * E * c["intermediate_size"]
    shared = 3 * 2 * E * c["moe_intermediate_size"] * c["n_shared_experts"]
    router = 2 * E * c["router_experts"]
    share = c["num_experts_per_tok"] * c["n_routed_experts"] / c["router_experts"]
    experts = (L - dense) * share * expert_products(cfg, 1)
    per_token = L * mla + dense * ffn + (L - dense) * (shared + router) + experts
    tokens = batch * S
    return {"linear": tokens * per_token,
            "attention": batch * L * (S * S / 2) * H * 2 * ((nope + rp) + dv),
            "experts": tokens * experts}


def train_step(cfg, batch):
    """{"total", "linear", "conv"} FLOP of one train step, as ``flops.train_step``."""
    rest = flops.train_step(ml.rest_config(cfg), batch)
    t = tower_forward(cfg, batch)
    k = flops.TRAIN_FACTOR
    return {"total": rest["total"] + k * (t["linear"] + t["attention"]),
            "linear": rest["linear"] + k * t["linear"], "conv": rest["conv"]}
