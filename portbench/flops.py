"""The model's work, counted from its configuration: floating-point
operations of one clip's forward (a multiply-add is 2), by kind of product.

Counted where a product of the architecture lies, whatever kernel computes
it, so that replacing a kernel by a library call, or the reverse, leaves the
count alone. Elementwise work (norms, activations, softmax) is not counted.

- ``linear``: every dense projection (the encoders' q/k/v/out and FFNs,
  DeBERTa's projections of its relative-position table, once a batch, the biLSTM's
  input and recurrent products, the fusion and the heads);
- ``attention``: score and value products (DeBERTa's two relative terms
  included);
- ``conv``: wav2vec2's feature encoder and positional conv, ViT's patch
  embedding.

A train step is forward once and backward twice (``TRAIN_FACTOR``); the
recomputation a program may do is not counted.
"""
PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet), at 700 W
TRAIN_FACTOR = 3


def audio_frames(ac, samples):
    """wav2vec2 frame counts after each conv layer of the feature encoder."""
    out, n = [], samples
    for k, s in zip(ac["conv_kernel"], ac["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def _mha(n_q, n_k, E):
    """torch MultiheadAttention on n_q queries against n_k keys: (linear, attention)."""
    return 2 * E * E * (2 * n_q + 2 * n_k), 4 * n_q * n_k * E


def forward(cfg, samples=None, batch=1):
    """{"linear", "attention", "conv", "total"} FLOP of the forward of
    ``batch`` clips of ``samples`` audio samples (default: the configured
    length), text padded to ``text_max_length``."""
    pc, tc, ac, vc = cfg["program"], cfg["text"], cfg["audio"], cfg["video"]
    samples = samples or pc["audio_max_length"]
    lin = att = conv = 0
    # DeBERTa; its position table's projections are made once a batch
    S, E, Fd, L = pc["text_max_length"], tc["hidden_size"], tc["intermediate_size"], tc["num_hidden_layers"]
    P = 2 * tc["position_buckets"]
    per_batch = L * 2 * P * E * E * 2
    lin += L * (2 * S * E * E * 4 + 2 * S * E * Fd * 2)
    att += L * (2 * S * S * E * 2 + 2 * S * P * E * 2)
    Ff = pc["fusion_hidden_size"]
    lin += 2 * E * Ff
    # wav2vec2
    frames = audio_frames(ac, samples)
    cin = 1
    for n, c, k in zip(frames, ac["conv_dim"], ac["conv_kernel"]):
        conv += 2 * n * c * cin * k
        cin = c
    T, E, Fd, L = frames[-1], ac["hidden_size"], ac["intermediate_size"], ac["num_hidden_layers"]
    K, G = ac["num_conv_pos_embeddings"], ac["num_conv_pos_embedding_groups"]
    lin += 2 * T * cin * E
    conv += 2 * (T + 1 - K % 2) * E * (E // G) * K  # 'same' padding: one extra output for even K
    lin += L * (2 * T * E * E * 4 + 2 * T * E * Fd * 2)
    att += L * 4 * T * T * E
    m_lin, m_att = _mha(T, T, E)
    lin, att = lin + m_lin + 2 * E * Ff, att + m_att
    # ViT per frame, the last layer on the CLS row only; biLSTM; attention over frames
    nf, E, Fd, L = pc["video_max_frames"], vc["hidden_size"], vc["intermediate_size"], vc["num_hidden_layers"]
    p = vc["patch_size"]
    N = 1 + (vc["image_size"] // p) ** 2
    conv += nf * 2 * (N - 1) * E * 3 * p * p
    lin += nf * (L - 1) * (2 * N * E * E * 4 + 2 * N * E * Fd * 2)
    att += nf * (L - 1) * 4 * N * N * E
    lin += nf * (2 * E * E * 2 + 2 * N * E * E * 2 + 2 * E * Fd * 2)
    att += nf * 4 * N * E
    H = E // 2
    for layer in range(2):
        inp = E if layer == 0 else 2 * H
        lin += 2 * nf * 2 * 4 * H * (inp + H)
    m_lin, m_att = _mha(nf, nf, E)
    lin, att = lin + m_lin + 2 * E * Ff, att + m_att
    # hierarchical fusion and heads
    F_, G_ = Ff, pc["graph_hidden_size"]
    lin += 2 * (3 * F_ * 2 * F_ + 2 * F_ * F_)                         # early
    m_lin, m_att = _mha(1, 1, F_)
    lin += 6 * (m_lin + 2 * 2 * F_ * 4 * F_) + 3 * m_lin + 2 * 3 * F_ * F_  # MulT
    att += 9 * m_att
    heads = 4
    for i in range(pc["graph_num_layers"]):                            # GAT over 3 nodes
        lin += 3 * 2 * (F_ if i == 0 else G_) * heads * G_
        att += 2 * 3 * heads * G_ * 2 + 2 * 3 * 3 * heads * G_
    lin += 2 * G_ * F_
    lin += 3 * (2 * F_ * F_ + 2 * F_ * F_ // 2) + 2 * 3 * F_ * F_    # contrastive
    m_lin, m_att = _mha(3, 3, F_)
    lin += 3 * 2 * F_ * F_ + m_lin + 2 * 3 * F_ * F_ + 2 * F_ * 3 + 2 * F_ * F_  # adaptive
    att += m_att
    lin += 2 * 5 * F_ * 2 * F_ + 2 * 2 * F_ * F_                       # meta
    n_emo = pc["num_emotions"]
    lin += 2 * F_ * F_ // 2 + 2 * F_ // 2 * n_emo + 2 * F_ * (2 + n_emo)  # heads
    out = {"linear": lin * batch + per_batch, "attention": att * batch, "conv": conv * batch}
    out["total"] = sum(out.values())
    return out


def contrastive(cfg, batch):
    """The InfoNCE similarity products of one batch (three pairs)."""
    return 3 * 2 * batch * batch * cfg["program"]["fusion_hidden_size"] // 2


def train_step(cfg, batch):
    """{"total", "linear", "conv"} FLOP of one train step: the model's
    products forward once, backward twice; the first conv of each input
    (audio, frames) needs no input gradient, so its backward is once."""
    f = forward(cfg, batch=batch)
    first = forward_first_convs(cfg) * batch
    total = TRAIN_FACTOR * (f["total"] + contrastive(cfg, batch))
    return {"total": total, "linear": TRAIN_FACTOR * f["linear"],
            "conv": TRAIN_FACTOR * f["conv"] - first}


def forward_first_convs(cfg):
    """FLOP of wav2vec2's first conv and ViT's patch embedding, one clip."""
    pc, ac, vc = cfg["program"], cfg["audio"], cfg["video"]
    n = audio_frames(ac, pc["audio_max_length"])[0]
    p = vc["patch_size"]
    patches = (vc["image_size"] // p) ** 2
    return (2 * n * ac["conv_dim"][0] * ac["conv_kernel"][0]
            + pc["video_max_frames"] * 2 * patches * vc["hidden_size"] * 3 * p * p)
