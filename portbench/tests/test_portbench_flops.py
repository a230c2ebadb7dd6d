"""flops.py counts what torch's FlopCounterMode counts over the port's CPU
forward at the tiny preset (every product but the biLSTM's, which runs in
one fused op the counter does not see, counted apart here)."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, weights
from portbench.reference import model as ref
from portbench.tests.tiny import tiny_config


def test_forward_flops_match_the_counter(tmp_path):
    from simple_multimodal_tpu_torch.config import ModelConfig
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model

    cfg = tiny_config()
    pc = dict(cfg["program"])
    fusion = pc.pop("fusion_type")
    config = ModelConfig(**pc, data_path=str(tmp_path / "d"), save_path=str(tmp_path / "s"),
                         log_path=str(tmp_path / "l"))
    config.fusion_type = fusion
    model = create_model(config, "standard", device="cpu")
    model.load_state_dict(weights.make(ref.spec(cfg), 7, "cpu"))
    B, S, T = 2, pc["text_max_length"], pc["audio_max_length"]
    frames, (H, W) = pc["video_max_frames"], pc["video_frame_size"]
    text = {"input_ids": torch.randint(100, 1000, (B, S)), "attention_mask": torch.ones(B, S)}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(text, torch.randn(B, T), torch.rand(B, frames, H, W, 3))
    E = cfg["video"]["hidden_size"]
    lstm = sum(2 * B * frames * 2 * 4 * (E // 2) * (inp + E // 2) for inp in (E, E))
    counted = counter.get_total_flops()
    want = flops.forward(cfg, batch=B)["total"]
    assert abs(counted + lstm - want) <= 1e-3 * want, (counted, lstm, want)


def test_train_step_counts_three_passes():
    cfg = tiny_config()
    f = flops.forward(cfg, batch=8)
    t = flops.train_step(cfg, 8)
    assert t["linear"] == 3 * f["linear"]
    assert 2 * f["conv"] < t["conv"] < 3 * f["conv"]
    assert t["total"] == 3 * (f["total"] + flops.contrastive(cfg, 8))
