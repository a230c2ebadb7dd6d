"""The reference agrees with the port on the CPU at the tiny preset, in
f32, whole runs of each loop through run.main (the look for a chip
skipped); and each planted fault of the timed path turns ``correct`` false."""
import sys
from pathlib import Path

import pytest
import torch

from portbench.tests.tiny import tiny_bench

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run  # noqa: E402


def drive(tmp_path, cell, patch=None, seconds="0.5", trace="0"):
    torch.manual_seed(0)
    return run.main(["--workload", cell, "--seed", "2147483701", "--seconds", seconds,
                     "--trace", trace], need_cuda=False, device="cpu", patch=patch,
                    bench=tiny_bench(tmp_path))


@pytest.mark.parametrize("cell", ["base.train", "long.train"])
def test_train_agrees(tmp_path, capsys, cell):
    res = drive(tmp_path, cell)
    assert res["correct"]
    assert set(res["checks"]) == set(run.cell_files(run.json.loads(
        (run.ROOT / "BENCHMARK.json").read_text()), cell)[3])
    # every number, compared or only printed ("<name> <value> (not compared ...")
    numbers = {k: v["value"] for k, v in res["checks"].items()}
    for line in capsys.readouterr().err.splitlines():
        if line.endswith("(not compared in this cell)"):
            numbers[line.split()[0]] = float(line.split()[1])
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["update_gap"] < 1e-3
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "train_clips_per_s"}


def test_serve_agrees_and_traces(tmp_path):
    res = drive(tmp_path, "base.serve", trace="1")
    assert res["correct"]
    assert res["checks"]["prob_gap"]["value"] < 1e-5
    assert set(res["metrics"]) == {"mfu.serve", "host_ms.serve"}  # no device trace on the CPU
    assert list(res)[-1] == "checks"


def _unchanged(kind, obj):
    """A step that leaves the parameters and the optimizer's state as they were."""
    if kind == "optimizer":
        obj.update = lambda grads: torch.zeros(())
    return obj


def _half_batch(kind, obj):
    """Half of each batch left out, the mean taken over the rest."""
    if kind != "step":
        return obj

    def step(state, batch):
        half = {k: ({kk: vv[: len(vv) // 2] for kk, vv in v.items()} if isinstance(v, dict)
                    else v[: len(v) // 2]) for k, v in batch.items()}
        return obj(state, half)

    return step


def _altered_answer(kind, obj):
    """An answer altered where the demo produces it."""
    if kind == "demo":
        predict = obj.predict

        def altered(*args):
            a = predict(*args)
            first = next(iter(a["emotion_distribution"]))
            a["emotion_distribution"][first] += 0.05
            return a

        obj.predict = altered
    return obj


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=lambda f: f.__name__)
def test_planted_train_faults_fail(tmp_path, fault):
    assert not drive(tmp_path, "base.train", patch=fault)["correct"]


def test_planted_serve_fault_fails(tmp_path):
    assert not drive(tmp_path, "base.serve", patch=_altered_answer)["correct"]
