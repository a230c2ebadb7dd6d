"""A tiny configuration of the benchmark's model for CPU tests: the port's
``tiny`` encoder preset, short media, a narrow fusion."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_config():
    cfg = json.loads((ROOT / "portbench/configs/mer_base.json").read_text())
    cfg["name"] = "tiny"
    cfg["program"].update(encoder_preset="tiny", text_max_length=16, audio_max_length=3200,
                          video_max_frames=4, video_frame_size=[32, 32], fusion_hidden_size=32,
                          fusion_num_heads=4, graph_hidden_size=16, mixed_precision=False)
    cfg["text"].update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=64, max_position_embeddings=64, position_buckets=16)
    cfg["audio"].update(conv_dim=[16] * 7, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64, num_conv_pos_embeddings=8,
                        num_conv_pos_embedding_groups=2)
    cfg["video"].update(image_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64)
    return cfg


# The serving cell is not in BENCHMARK.json yet (PERF.md, Open questions);
# its loop, traffic, limits and metric readers are kept, and the tests
# drive them through these entries.
SERVE_CELL = {"name": "base.serve", "config": "mer_base", "traffic": "serve", "chips": 1}
SERVE_METRICS = {
    "end_to_end": [{"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["base.serve"]}],
    "per_layer": [
        {"name": "idle_pct.serve", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device (H100)", "moves": "serve_p95_ms", "workloads": ["base.serve"]},
        {"name": "mfu.serve", "unit": "%", "better": "higher", "source": "host_clock",
         "layer": "model step", "moves": "serve_p95_ms", "workloads": ["base.serve"]},
        {"name": "host_ms.serve", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "serving", "moves": "serve_p95_ms", "workloads": ["base.serve"]}]}


def with_serve(bench):
    """The manifest with the serving cell and its metrics added."""
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append(dict(SERVE_CELL))
    for key, entries in SERVE_METRICS.items():
        bench[key] += entries
    return bench


def tiny_bench(tmp_path, cfg=None):
    """BENCHMARK.json, with the serving cell, and every configuration file
    replaced by the tiny one."""
    bench = with_serve(json.loads((ROOT / "BENCHMARK.json").read_text()))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg or tiny_config()))
    for c in bench["configs"]:
        c["file"] = str(path)
    return bench
