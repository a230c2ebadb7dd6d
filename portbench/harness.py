"""What a loop and the metric readers share within one run."""
import dataclasses
import gc
import subprocess
import time

import torch


@dataclasses.dataclass
class Context:
    args: object
    cell: dict
    cfg: dict
    traffic: dict
    limits: dict
    start: float
    device: torch.device
    root: object = None          # the checkout
    patch: object = None
    # filled by the loop
    setup_s: float = None
    window_s: float = None
    attempted: int = 0
    failed: int = 0
    correct: bool = False
    clips: int = 0               # clips of the completed steps in the window
    flops_done: float = 0.0      # model FLOP of the window's completed work
    latencies: list = None       # seconds from due to answered, every request of the window
    service: list = None         # seconds from started to answered
    trace: dict = None           # trace.summarize() of the traced segment
    traced_units: int = 0        # steps or requests inside the traced segment
    memory_peak: int = 0
    work: dict = None            # model FLOP of one step or request, by kind
    checks: dict = dataclasses.field(default_factory=dict)
    info: list = dataclasses.field(default_factory=list)

    @property
    def seed(self):
        return self.args.seed

    @property
    def seconds(self):
        return self.args.seconds

    @property
    def tracing(self):
        return bool(self.args.trace)

    @property
    def cuda(self):
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def program_config(self):
        """The program's ModelConfig from the configuration file, its
        directories inside the checkout's build tree."""
        from simple_multimodal_tpu_torch.config import ModelConfig

        pc = dict(self.cfg["program"])
        fusion = pc.pop("fusion_type")
        base = self.root / "build" / "portbench"
        config = ModelConfig(**pc, data_path=str(base / "data"), save_path=str(base / "ckpt"),
                             log_path=str(base / "logs"))
        config.fusion_type = fusion
        return config

    def setup_done(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.start

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self):
        if self.cuda:
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        """Return the freed program state's memory before the reference runs."""
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, name, value):
        """A compared number and its limit (``limits/<cell>.json``); a number
        the cell's limits do not name is printed and not compared."""
        if name not in self.limits:
            self.info.append(f"{name} {float(value)!r} (not compared in this cell)")
            return
        self.checks[name] = (float(value), float(self.limits[name]))

    def decide(self):
        self.correct = bool(self.checks) and all(v <= lim for v, lim in self.checks.values())

    def device_info(self):
        info = {"platform": "gpu" if self.cuda else "cpu",
                "kind": torch.cuda.get_device_name(self.device) if self.cuda else "cpu",
                "count": self.cell["chips"], "memory_peak_bytes": self.memory_peak}
        if self.tracing and self.trace is not None:
            info["busy_s"] = self.trace["busy_s"]
            info["window_s"] = self.trace["window_s"]
        return info

    def card_line(self):
        """The card's name and power limit, beside every number."""
        if not self.cuda:
            return
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            out = f"nvidia-smi: {e}"
        self.info.append(f"card {out}")


def profile_segment(ctx, run_one, units):
    """Traces ``units`` calls of ``run_one`` (after one untraced-in-window
    call under the profiler, which absorbs its start-up) and stores the
    summary in ``ctx.trace``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.cuda else [])
    with profile(activities=acts) as prof:
        run_one()
        ctx.sync()
        with record_function(trace.WINDOW):
            for _ in range(units):
                run_one()
            ctx.sync()
    ctx.trace = trace.from_profiler(prof)
    ctx.traced_units = units
    fam = ctx.trace["by_family"]
    total = sum(fam.values()) or 1.0
    ctx.info.append("traced device time by family (s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in sorted(fam.items(), key=lambda kv: -kv[1])))
    other = sorted(((s, n) for n, s in ctx.trace["by_name"].items() if trace.family(n) == "other"),
                   reverse=True)
    ctx.info.append(f"traced kernel time in family 'other': {100 * fam.get('other', 0.0) / total:.3f}%"
                    f" of {total:.6f} s, {len(other)} kernel names; the longest: "
                    + "; ".join(f"{n[:100]} {s:.6f}" for s, n in other[:12]))
