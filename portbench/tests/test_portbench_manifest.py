"""BENCHMARK.json parses, keeps the rules for names and units, and every
cell's files are where the harness looks for them."""
import json
import re
from pathlib import Path

import pytest

from portbench.tests.tiny import SERVE_METRICS, with_serve

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all((ROOT / p).is_dir() for p in BENCH["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert all(set(m.get("workloads", cells)) <= cells for m in METRICS)


@pytest.mark.parametrize("entry", BENCH["configs"] + with_serve(BENCH)["workloads"] + METRICS
                         + [m for ms in SERVE_METRICS.values() for m in ms],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", with_serve(BENCH)["workloads"], ids=lambda c: c["name"])
def test_cell_files_found(cell):
    import sys

    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    bench = with_serve(BENCH)
    _, cfg, traffic, limits = run.cell_files(bench, cell["name"])
    assert (ROOT / "portbench" / "loops" / f"{traffic['loop']}.py").is_file()
    assert limits and all(v > 0 for v in limits.values())
    reported = run.metrics_of(bench, cell["name"], 0) + run.metrics_of(bench, cell["name"], 1)
    assert {"setup_s"} < {m["name"] for m in run.metrics_of(bench, cell["name"], 0)}
    assert run.metrics_of(bench, cell["name"], 1)
    for m in reported:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    assert cfg["name"] == cell["config"]


def test_configurations_match_the_port_presets():
    """The configuration files' widths are what the port builds at its preset."""
    from simple_multimodal_tpu_torch.models.encoders import resolve_backbone_configs

    class Cfg:
        encoder_preset = "base"
        video_frame_size = (224, 224)

    text, audio, vit = resolve_backbone_configs(Cfg)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        t, a, v = cfg["text"], cfg["audio"], cfg["video"]
        assert (t["hidden_size"], t["num_hidden_layers"], t["num_attention_heads"],
                t["intermediate_size"], t["position_buckets"], t["vocab_size"]) == (
            text.hidden_size, text.num_layers, text.num_heads, text.intermediate_size,
            text.position_buckets, text.vocab_size)
        assert (tuple(a["conv_dim"]), tuple(a["conv_kernel"]), a["hidden_size"],
                a["num_hidden_layers"], a["num_conv_pos_embeddings"]) == (
            audio.conv_dims, audio.conv_kernels, audio.hidden_size, audio.num_layers,
            audio.pos_conv_kernel)
        assert (v["hidden_size"], v["num_hidden_layers"], v["patch_size"]) == (
            vit.hidden_size, vit.num_layers, vit.patch_size)
