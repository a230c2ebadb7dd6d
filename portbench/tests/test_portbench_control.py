"""The control, the reference computed with float8 products put in the
program's place, fails each cell's limits; so does each planted fault of a
train step: half of its batch left out and, where the cell compares the
parameters' change, every LayerNorm bias left unchanged and the emotion
head's update doubled. At the tiny preset on the
CPU; ``calibrate.py`` takes the same readings on the card at cell size."""
import json

import pytest
import torch

from portbench import calibrate
from portbench.tests.tiny import ROOT, tiny_config, with_serve

BENCH = with_serve(json.loads((ROOT / "BENCHMARK.json").read_text()))


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails(cell):
    import sys

    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    _, _, traffic, limits = run.cell_files(BENCH, cell)
    cfg = tiny_config()
    cfg["program"]["mixed_precision"] = True  # the reference's GELU as the cell computes it
    if traffic["loop"] == "train_step":
        r = calibrate.train_readings(cfg, traffic, 5, torch.device("cpu"))
        assert _fails(r["half_batch"], limits)
        if "update_gap" in limits:  # the small-leaf faults show only in the parameters' change
            for fault in ("norm_bias_frozen", "head_gain"):
                assert _fails(r[fault], limits), fault
    else:
        r = calibrate.serve_readings(cfg, traffic, 5, torch.device("cpu"))
    assert _fails(r["control"], limits)
