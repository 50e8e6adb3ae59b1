"""One run of one cell: set-up, the measured window, the traced window's
reading, and the check against the plain reference.

Everything that belongs to one configuration, mix, task or per-layer
metric is found by name (see README.md): ``configs/<config>.json`` names
its ``task``, which selects ``datagen/<task>.py``, ``tasks/<task>.py`` and
``reference/<task>.py``; ``mixes/<traffic>.json`` names the task and the
questions; ``metrics/<metric>.py`` reads one per-layer metric.
"""

from __future__ import annotations

import importlib
import json
import random
import statistics
import sys
import time
import traceback
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import check, trace

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cudf_tpu", "benchmarks")
GIB = float(1 << 30)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    task: object
    datagen: object
    reference: object
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    """A cell of BENCHMARK.json (or ``spec``), its configuration and mix
    files and its task's modules, found by name."""
    spec = spec if spec is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
    if (mix["loop"], mix["clients"], mix["order"]) != ("closed", 1, "round robin"):
        raise SystemExit(f"portbench: mix {w['traffic']}: only a closed loop of 1 client, "
                         "round robin, is driven")
    if mix["task"] != config["task"]:
        raise SystemExit(f"portbench: mix {w['traffic']} is of task {mix['task']}, "
                         f"configuration {w['config']} of {config['task']}")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if m["moves"] in names
             and name in m.get("workloads", [name])]
    task = config["task"]
    return Cell(name, int(w["chips"]), config, mix,
                importlib.import_module(f"portbench.tasks.{task}"),
                importlib.import_module(f"portbench.datagen.{task}"),
                importlib.import_module(f"portbench.reference.{task}"), e2e, layer)


def port_frames(data) -> Dict[str, object]:
    """The port's DataFrames over the generated tensors, built through its
    public constructors (a category: ``Column.from_dictionary`` over a
    STRING column of the generated keys)."""
    import cudf_tpu_torch as ct

    frames = {}
    for frame, cols in data.tables.items():
        dicts = data.dicts.get(frame, {})
        out = {}
        for name, t in cols.items():
            d = dicts.get(name)
            if d is None:
                out[name] = t
            else:
                keys = ct.Column(ct.dtype("str"), d.offsets.numel() - 1, d.chars, None,
                                 d.offsets)
                out[name] = ct.Column.from_dictionary(t, keys)
        frames[frame] = ct.DataFrame(out)
    return frames


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    seconds: float = 0.0
    latencies: List[float] = field(default_factory=list)
    rows: int = 0
    attempted: int = 0
    failed: int = 0
    held: Dict[str, list] = field(default_factory=dict)   # question -> answer columns
    result_rows: List[int] = field(default_factory=list)
    peak_bytes: int = 0             # the device's peak, less the answers held for the check


class Run:
    """Set-up, window and check of one cell from one seed on one device."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.questions = list(cell.mix["questions"])
        self.data = None
        self.frames = None
        self.phases: Dict[str, float] = {}

    def fn(self, q):
        return self.cell.task.QUESTIONS[q]

    def input_rows(self, q) -> int:
        return sum(self.data.rows(f) for f in self.cell.task.INPUTS[q])

    def setup(self) -> float:
        """Generate the data, build the port's frames and warm every
        question of the mix once; returns one warm round's seconds.
        ``phases`` holds each part's seconds."""
        t0 = time.perf_counter()
        self.data = self.cell.datagen.generate(self.cell.config, self.seed, self.device)
        sync(self.device)
        t1 = time.perf_counter()
        self.frames = port_frames(self.data)
        sync(self.device)
        t2 = time.perf_counter()
        for q in self.questions:
            res = self.fn(q)(self.frames)
            sync(self.device)
            len(res)
            del res
        t3 = time.perf_counter()
        self.phases.update(generate=t1 - t0, frames=t2 - t1, warm=t3 - t2)
        return t3 - t2

    def count_syncs(self) -> Dict[str, int]:
        """Host syncs of one pass of the mix, by question, as torch's sync
        debug mode reports them (a warning each)."""
        out = {}
        for q in self.questions:
            sync(self.device)
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = self.fn(q)(self.frames)
                    len(res)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            out[q] = sum("synchroniz" in str(w.message) for w in seen)
            del res
        return out

    def sample(self, round_seconds: float, seconds: float) -> Dict[str, int]:
        """The round, drawn from the seed, whose answer to each question
        the check keeps: within the first half of the rounds the window
        is expected to hold."""
        rounds = max(1, int(seconds / max(round_seconds, 1e-6) / 2))
        rng = random.Random(self.seed)
        return {q: rng.randrange(rounds) for q in self.questions}

    def window(self, seconds: float, keep: Dict[str, int], profiled: bool = False) -> Window:
        """The closed loop: one client sends the mix's questions round robin,
        the next once the last answer is complete on the device and its row
        count is on the host, until ``seconds`` have passed and every kept
        answer is taken.  A kept answer stays on the device; the bytes it
        holds are left out of the window's peak."""
        from torch.profiler import record_function

        w = Window()
        rng = record_function if profiled else (lambda name: nullcontext())
        on_cuda = self.device.type == "cuda"
        pending, held_bytes, rnd = dict(keep), 0, 0
        start = time.perf_counter()
        while True:
            for q in self.questions:
                w.attempted += 1
                if on_cuda:
                    before = torch.cuda.memory_allocated(self.device)
                    torch.cuda.reset_peak_memory_stats(self.device)
                t0 = time.perf_counter()
                try:
                    with rng(trace.QUERY_PREFIX + q):
                        res = self.fn(q)(self.frames)
                        sync(self.device)
                        n = len(res)
                except Exception:                       # a failed query counts, the loop goes on
                    w.failed += 1
                    pending.pop(q, None)                # its answer is missing from the check
                    traceback.print_exc(file=sys.stderr)
                    continue
                w.latencies.append(time.perf_counter() - t0)
                w.rows += self.input_rows(q)
                w.result_rows.append(n)
                if on_cuda:
                    w.peak_bytes = max(w.peak_bytes, torch.cuda.max_memory_allocated(
                        self.device) - held_bytes)
                if pending.get(q) == rnd:
                    w.held[q] = check.columns(res, getattr(
                        self.cell.task, "ANSWER_INDEX", {}).get(q, 0))
                    del pending[q]
                    if on_cuda:
                        held_bytes += torch.cuda.memory_allocated(self.device) - before
                del res
            rnd += 1
            elapsed = time.perf_counter() - start
            if elapsed >= seconds and not pending:
                w.seconds = elapsed
                return w

    def check(self, held: Dict[str, list], real=torch.float64) -> Dict[str, float]:
        """Each kept answer against the plain reference: {number: value}."""
        numbers, cache = {}, {}
        for q, h in held.items():
            numbers.update(check.compare(q, self.cell.reference.expected(q, self.data, real),
                                         h, self.device, cache))
        return numbers

    def control(self, real=torch.float32) -> Dict[str, float]:
        """The reference computed in ``real`` put in the program's place."""
        held = {}
        for q in self.questions:
            exp = self.cell.reference.expected(q, self.data, real)
            held[q] = [(name, v() if callable(v) else v) for name, v in exp.items()]
        return self.check(held)

    def limits(self) -> Dict[str, float]:
        return {k: v for k, v in self.cell.task.LIMITS.items()
                if k.split(".")[0] in self.questions}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18] if len(values) > 1 \
        else values[0]


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """One run: the result's fields, the numbers compared and their limits,
    and the metrics of the cell for ``traced`` 0 or 1."""
    on_cuda = torch.device(device).type == "cuda"
    r = Run(cell, seed, device)
    start_s = time.perf_counter() - t_start      # all before set-up: imports, CUDA context
    round_s = r.setup()
    keep = r.sample(round_s, seconds)
    syncs = r.count_syncs() if traced and on_cuda else {}
    setup_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        w = r.window(seconds, keep, profiled=traced)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    out = {"attempted": w.attempted, "failed": w.failed,
           "memory_peak_bytes": max(setup_peak, w.peak_bytes),
           "setup_phases": dict(start=start_s, **r.phases, total=setup_s)}
    metrics: Dict[str, float] = {}
    if traced:
        t = trace.from_profile(prof)
        del prof
        t.syncs = syncs
        for q, n in zip(t.queries, w.result_rows):
            q.least_bytes = cell.task.least_bytes(q.question, r.data, n)
        for m in cell.per_layer:
            value = importlib.import_module(f"portbench.metrics.{m['name']}").read(t)
            if value is not None:
                metrics[m["name"]] = value
        out["busy_s"] = trace.length(t.busy()) / 1e6
        out["window_s"] = trace.length(t.window()) / 1e6
        out["breakdown"] = trace.breakdown(t)
    else:
        values = {"rows_per_s": w.rows / w.seconds,
                  "query_p95_ms": p95(w.latencies) * 1e3 if w.latencies else float("inf"),
                  "peak_device_gib": w.peak_bytes / GIB, "setup_s": setup_s}
        metrics = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    out["metrics"] = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
                      for m in (cell.per_layer if traced else cell.end_to_end)
                      if m["name"] in metrics}
    r.frames = None
    if on_cuda:
        torch.cuda.empty_cache()
    numbers = r.check(w.held)
    ok, shown = check.judge(numbers, r.limits())
    missing = [q for q in r.questions if q not in w.held]
    out["correct"] = ok and w.failed == 0 and not missing
    out["checks"] = shown
    return out
