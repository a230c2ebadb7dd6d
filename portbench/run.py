"""Runs one benchmark cell once and prints its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration file, which may set the
program's environment switches (``env``) and the host's torch thread count
(``torch_threads``), and a traffic mix; the mix
(``portbench/traffic/<name>.json``) names the loop that runs it
(``portbench/loops/<loop>.py``) and the cell's limits live in
``portbench/limits/<cell>.json``. Each metric is read by its own file,
``portbench/metrics/<name>.py``. A cell, a configuration, a mix or a metric
is added by adding files and entries, not by editing these.

Set-up (imports, the kernels' build into the checkout's ``build/hopper``
on a first run, the model, its weights, the traffic, warm-up and the cell's
checked first steps) is timed as ``setup_s``; then the loop measures for
``--seconds``; then the program's state is freed and the plain reference in
``portbench/reference`` judges what the timed path produced. With
``--trace 1`` the loop then traces a few more steps or requests, and the
per-layer metrics are printed instead of the end-to-end ones.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "simple_multimodal_tpu")


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(bench, workload):
    """(cell, config, traffic, limits) of a workload name, or raise."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return cell, cfg, traffic, limits


def metrics_of(bench, workload, trace):
    """The metric entries this cell reports: end-to-end ones without
    ``--trace``, per-layer ones with it."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, need_cuda=True, device=None, patch=None, bench=None):
    """One run; returns the result dict it prints. ``need_cuda``, ``device``,
    ``patch`` (called with the loop's optimizer, step or demo, it returns
    what the loop uses) and ``bench`` (the manifest) let the tests drive a
    run on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, traffic, limits = cell_files(bench, args.workload)
    # The program's switches, as the configuration file states them, before
    # anything of the port is imported; USE_FLAX=0 keeps transformers from
    # loading flax (and so JAX).
    os.environ.update({k: str(v) for k, v in cfg.get("env", {}).items()})
    os.environ["USE_FLAX"] = "0"

    import torch

    if cfg.get("torch_threads"):
        torch.set_num_threads(int(cfg["torch_threads"]))
    if need_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    ctx = harness.Context(args=args, cell=cell, cfg=cfg, traffic=traffic, limits=limits,
                          start=START, device=torch.device(device or "cuda"), root=ROOT,
                          patch=patch)
    loop = load_file(HERE / "loops" / f"{traffic['loop']}.py", f"portbench_loop_{traffic['loop']}")
    loop.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        sys.exit(3)
    values = {}
    for m in metrics_of(bench, args.workload, args.trace):
        reader = load_file(HERE / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": ctx.correct, "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": values, "device": ctx.device_info()}
    if args.trace and ctx.trace is not None:
        from portbench import trace

        result["breakdown"] = trace.breakdown(ctx.trace)
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in ctx.checks.items()}
    for line in ctx.info:
        print(line, file=sys.stderr)
    for name, (v, lim) in ctx.checks.items():
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
