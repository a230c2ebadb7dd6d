"""A tiny configuration of the Moonlight cell for CPU tests: ``tiny.py``'s
model with the port's ``tiny`` DeepSeek tower (``DeepseekConfig.tiny()``
with the hashing tokenizer's vocabulary) as its text tower."""
from portbench.tests.tiny import tiny_config

TOWER = {"vocab_size": 128100, "hidden_size": 64, "intermediate_size": 128,
         "moe_intermediate_size": 32, "num_hidden_layers": 3, "num_attention_heads": 2,
         "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "num_experts_per_tok": 4, "n_shared_experts": 1, "first_k_dense_replace": 1,
         "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-05, "rope_theta": 50000,
         "router_experts": 16, "initializer_range": 0.02}


def tiny_moonlight_config(share=(0, 1), layers=3):
    """The configuration with ``layers`` tower layers and this process's
    ``share`` = (index, count) of the 16 experts."""
    cfg = tiny_config()
    cfg["name"] = "tiny_moonlight"
    cfg.update(TOWER, num_hidden_layers=layers, n_routed_experts=16 // share[1],
               expert_share=list(share))
    cfg["program"].update(text_model_name="moonshotai/Moonlight-16B-A3B",
                          text_num_layers=layers, text_expert_share=list(share))
    return cfg
