"""JAX parameters → the port's ``state_dict``: the inverse of
simple_multimodal_tpu/models/convert_full.py ``convert_multimodal_model``.

Takes the JAX ``MultimodalEmotionModel`` param tree as numpy arrays (with or
without the top-level "params" key) and returns torch tensors under the
port's (= the reference's) names: Dense kernels transposed, MHA q/k/v
re-packed into ``in_proj_*``, ``[L, ...]`` layer stacks un-stacked, conv
kernels back to [out, in, *k], and each LSTM bias (the converter sums
``bias_ih + bias_hh``) put whole into ``bias_ih`` with zeros in ``bias_hh``.
Loading orbax checkpoints needs jax and is not done here.
"""
from typing import Dict

import numpy as np
import torch


def _dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _mha(sd, prefix, p):
    sd[f"{prefix}.in_proj_weight"] = np.concatenate(
        [np.asarray(p[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")])
    sd[f"{prefix}.in_proj_bias"] = np.concatenate(
        [np.asarray(p[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
    _dense(sd, f"{prefix}.out_proj", p["out_proj"])


def _layer(tree, i):
    """Layer ``i`` of a [L, ...]-stacked param subtree."""
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def _num_layers(tree) -> int:
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(np.asarray(leaf).shape[0])


def _vit(sd, pre, p):
    # flax conv kernel [kh, kw, in, out] → torch [out, in, kh, kw]
    sd[f"{pre}.embeddings.patch_embeddings.projection.weight"] = np.asarray(
        p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{pre}.embeddings.patch_embeddings.projection.bias"] = np.asarray(
        p["patch_embed"]["bias"])
    sd[f"{pre}.embeddings.cls_token"] = np.asarray(p["cls_token"])
    sd[f"{pre}.embeddings.position_embeddings"] = np.asarray(p["position_embeddings"])
    _ln(sd, f"{pre}.layernorm", p["layernorm"])
    layers = p["layers"]
    for i in range(_num_layers(layers)):
        li, lp = f"{pre}.encoder.layer.{i}", _layer(layers, i)
        _ln(sd, f"{li}.layernorm_before", lp["layernorm_before"])
        _ln(sd, f"{li}.layernorm_after", lp["layernorm_after"])
        for n in ("query", "key", "value"):
            _dense(sd, f"{li}.attention.attention.{n}", lp[n])
        _dense(sd, f"{li}.attention.output.dense", lp["attn_output"])
        _dense(sd, f"{li}.intermediate.dense", lp["intermediate_dense"])
        _dense(sd, f"{li}.output.dense", lp["output_dense"])


def _deberta(sd, pre, p):
    sd[f"{pre}.embeddings.word_embeddings.weight"] = np.asarray(
        p["word_embeddings"]["embedding"])
    _ln(sd, f"{pre}.embeddings.LayerNorm", p["emb_ln"])
    sd[f"{pre}.encoder.rel_embeddings.weight"] = np.asarray(p["rel_embeddings"])
    _ln(sd, f"{pre}.encoder.LayerNorm", p["rel_ln"])
    layers = p["layers"]
    for i in range(_num_layers(layers)):
        li, lp = f"{pre}.encoder.layer.{i}", _layer(layers, i)
        for n in ("query_proj", "key_proj", "value_proj"):
            _dense(sd, f"{li}.attention.self.{n}", lp["self"][n])
        _dense(sd, f"{li}.attention.output.dense", lp["attn_out_dense"])
        _ln(sd, f"{li}.attention.output.LayerNorm", lp["attn_out_ln"])
        _dense(sd, f"{li}.intermediate.dense", lp["intermediate_dense"])
        _dense(sd, f"{li}.output.dense", lp["output_dense"])
        _ln(sd, f"{li}.output.LayerNorm", lp["output_ln"])


def _wav2vec2(sd, pre, p):
    fe = p["feature_encoder"]
    i = 0
    while f"conv_{i}" in fe:
        # flax [k, in, out] → torch [out, in, k]
        sd[f"{pre}.feature_extractor.conv_layers.{i}.conv.weight"] = np.asarray(
            fe[f"conv_{i}"]["kernel"]).transpose(2, 1, 0)
        i += 1
    _ln(sd, f"{pre}.feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])
    _ln(sd, f"{pre}.feature_projection.layer_norm", p["fp_layer_norm"])
    _dense(sd, f"{pre}.feature_projection.projection", p["fp_projection"])
    pc = p["pos_conv"]
    conv = f"{pre}.encoder.pos_conv_embed.conv"
    sd[f"{conv}.weight_v"] = np.asarray(pc["weight_v"]).transpose(2, 1, 0)
    sd[f"{conv}.weight_g"] = np.asarray(pc["weight_g"]).transpose(2, 1, 0)
    sd[f"{conv}.bias"] = np.asarray(pc["bias"])
    _ln(sd, f"{pre}.encoder.layer_norm", p["encoder_layer_norm"])
    sd[f"{pre}.masked_spec_embed"] = np.asarray(p["masked_spec_embed"])
    layers = p["layers"]
    for i in range(_num_layers(layers)):
        li, lp = f"{pre}.encoder.layers.{i}", _layer(layers, i)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{li}.attention.{n}", lp[n])
        _ln(sd, f"{li}.layer_norm", lp["layer_norm"])
        _dense(sd, f"{li}.feed_forward.intermediate_dense", lp["intermediate_dense"])
        _dense(sd, f"{li}.feed_forward.output_dense", lp["output_dense"])
        _ln(sd, f"{li}.final_layer_norm", lp["final_layer_norm"])


def _lstm(sd, pre, p):
    layer = 0
    while f"w_ih_l{layer}" in p:
        for sfx in ("", "_reverse"):
            name = f"l{layer}{sfx}"
            if f"w_ih_{name}" not in p:
                continue
            sd[f"{pre}.weight_ih_{name}"] = np.asarray(p[f"w_ih_{name}"]).T
            sd[f"{pre}.weight_hh_{name}"] = np.asarray(p[f"w_hh_{name}"]).T
            bias = np.asarray(p[f"bias_{name}"])
            sd[f"{pre}.bias_ih_{name}"] = bias
            sd[f"{pre}.bias_hh_{name}"] = np.zeros_like(bias)
        layer += 1


def _gat(sd, pre, p):
    sd[f"{pre}.lin.weight"] = np.asarray(p["lin"]["kernel"]).T
    sd[f"{pre}.att_src"] = np.asarray(p["att_src"]).reshape(1, *np.shape(p["att_src"])[-2:])
    sd[f"{pre}.att_dst"] = np.asarray(p["att_dst"]).reshape(1, *np.shape(p["att_dst"])[-2:])
    sd[f"{pre}.bias"] = np.asarray(p["bias"])


def _cross_modal(sd, pre, p):
    _mha(sd, f"{pre}.attention", p["attention"])
    _ln(sd, f"{pre}.norm1", p["norm1"])
    _ln(sd, f"{pre}.norm2", p["norm2"])
    _dense(sd, f"{pre}.ffn.0", p["ffn_0"])
    _dense(sd, f"{pre}.ffn.3", p["ffn_3"])


def _fusion(sd, pre, p, fusion_type, config):
    if fusion_type == "early":
        _dense(sd, f"{pre}.fusion_layers.0", p["0"])
        _dense(sd, f"{pre}.fusion_layers.3", p["3"])
    elif fusion_type == "mult":
        for name in ("text_to_audio", "text_to_video", "audio_to_text",
                     "audio_to_video", "video_to_text", "video_to_audio"):
            _cross_modal(sd, f"{pre}.{name}", p[name])
        for name in ("text_self_attn", "audio_self_attn", "video_self_attn"):
            _mha(sd, f"{pre}.{name}", p[name])
        _dense(sd, f"{pre}.final_fusion.0", p["final_fusion_0"])
    elif fusion_type == "graph":
        sd[f"{pre}.node_type_embedding.weight"] = np.asarray(
            p["node_type_embedding"]["embedding"])
        _dense(sd, f"{pre}.output_projection", p["output_projection"])
        for i in range(config.graph_num_layers):
            _gat(sd, f"{pre}.gcn_layers.{i}", p[f"gcn_layers_{i}"])
    elif fusion_type == "contrastive":
        for m in ("text", "audio", "video"):
            _dense(sd, f"{pre}.{m}_projector.0", p[f"{m}_projector_0"])
            _dense(sd, f"{pre}.{m}_projector.2", p[f"{m}_projector_2"])
        _dense(sd, f"{pre}.fusion_layer.0", p["fusion_layer_0"])
    elif fusion_type == "adaptive":
        _mha(sd, f"{pre}.attention", p["attention"])
        for n in ("text_transform", "audio_transform", "video_transform"):
            _dense(sd, f"{pre}.{n}", p[n])
        _dense(sd, f"{pre}.weight_predictor.0", p["weight_predictor_0"])
        _dense(sd, f"{pre}.weight_predictor.2", p["weight_predictor_2"])
        _dense(sd, f"{pre}.fusion_layer.0", p["fusion_layer_0"])
    elif fusion_type == "hierarchical":
        for sub in ("early", "mult", "graph", "contrastive", "adaptive"):
            _fusion(sd, f"{pre}.{sub}_fusion", p[f"{sub}_fusion"], sub, config)
        _dense(sd, f"{pre}.meta_fusion.0", p["meta_fusion_0"])
        _dense(sd, f"{pre}.meta_fusion.3", p["meta_fusion_3"])
    else:
        raise NotImplementedError(f"fusion type {fusion_type!r} is not ported yet")


def state_dict_from_jax(params: Dict, config) -> Dict[str, torch.Tensor]:
    """JAX ``MultimodalEmotionModel`` params (numpy) → the port's state_dict."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    te, ae, ve = p["text_encoder"], p["audio_encoder"], p["video_encoder"]
    _deberta(sd, "text_encoder.model", te["model"])
    _dense(sd, "text_encoder.projection", te["projection"])
    _wav2vec2(sd, "audio_encoder.model", ae["model"])
    _mha(sd, "audio_encoder.temporal_attention", ae["temporal_attention"])
    _dense(sd, "audio_encoder.projection", ae["projection"])
    _vit(sd, "video_encoder.vit", ve["vit"])
    _lstm(sd, "video_encoder.temporal_lstm", ve["temporal_lstm"])
    _mha(sd, "video_encoder.facial_attention", ve["facial_attention"])
    _dense(sd, "video_encoder.projection", ve["projection"])
    _fusion(sd, "fusion_layer", p["fusion_layer"],
            getattr(config, "fusion_type", "hierarchical"), config)
    cl = p["classifier"]
    _dense(sd, "classifier.classifier.0", cl["classifier_0"])
    _dense(sd, "classifier.classifier.3", cl["classifier_3"])
    for n in ("sentiment_classifier", "positive_classifier", "negative_classifier"):
        _dense(sd, f"classifier.{n}", cl[n])
    for n in ("valence_regressor", "arousal_regressor", "uncertainty_head"):
        _dense(sd, n, p[n])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
