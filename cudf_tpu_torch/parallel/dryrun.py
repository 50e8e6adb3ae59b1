"""The multi-rank dry run on the CPU: a q5-shaped plan (scan, filter,
shuffle join, shuffle groupby, distributed sort) over ``n`` gloo processes,
held to the in-memory executor (the port's counterpart of the reference's
``__graft_entry__.dryrun_multichip``, which runs over an n-device CPU
mesh).

    python -m cudf_tpu_torch.parallel.dryrun 4

prints one JSON line a rank (its rows, the answer's rows, its collectives)
and exits 0 when every rank's answer equals the in-memory one.  Under
torchrun each process is one rank, its group formed from torchrun's
environment (``bootstrap.initialize``), as ranks on several cards would
be launched (there with NCCL, without ``--cpu``):

    torchrun --standalone --nproc-per-node=2 -m cudf_tpu_torch.parallel.dryrun --torchrun --cpu

``RankPool`` starts the ranks (spawned processes, one gloo group over a
file store in a temporary directory) and runs picklable tasks on every
rank at once; the CPU tests use it too.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch


def _rank_main(rank: int, size: int, store: str, inbox, outbox, timeout_s: float) -> None:
    from cudf_tpu_torch.parallel import bootstrap

    torch.set_num_threads(1)
    try:
        bootstrap.initialize(rank, size, f"file://{store}", device="cpu", timeout_s=timeout_s)
        outbox.put((rank, "ready", None))
    except Exception:
        outbox.put((rank, "error", traceback.format_exc()))
        return
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            fn, args = task
            try:
                outbox.put((rank, "ok", fn(*args)))
            except Exception:
                outbox.put((rank, "error", traceback.format_exc()))
    finally:
        bootstrap.shutdown()


class RankPool:
    """``size`` CPU processes in one gloo group, each rank running every
    task ``run`` sends: ``run(fn, *args)`` calls ``fn(*args)`` on every rank
    (``fn`` importable by name, as a spawned process unpickles it) and
    returns the results in rank order.  A task that fails on a rank
    stops the pool and raises its traceback.  Use as a context manager."""

    def __init__(self, size: int, timeout_s: float = 120.0):
        ctx = torch.multiprocessing.get_context("spawn")
        self.size = int(size)
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="rank_pool_")
        store = os.path.join(self._dir, "store")
        self._inboxes = [ctx.Queue() for _ in range(self.size)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, self.size, store, self._inboxes[r], self._outbox,
                                         timeout_s))
                       for r in range(self.size)]
        for p in self._procs:
            p.start()
        self._ready = False

    def wait(self) -> "RankPool":
        """Block until every rank has joined the group (``run`` does)."""
        if not self._ready:
            self._collect("ready")
            self._ready = True
        return self

    def _collect(self, what: str) -> list:
        out = [None] * self.size
        deadline = time.monotonic() + self.timeout_s * 2
        for _ in range(self.size):
            while True:
                try:
                    rank, status, value = self._outbox.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in self._procs if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close()
                        raise RuntimeError(f"no {what} answer from every rank: "
                                           f"{len(dead)} exited ({dead})")
            if status == "error":
                self.close()
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return out

    def run(self, fn, *args) -> list:
        self.wait()
        for box in self._inboxes:
            box.put((fn, args))
        return self._collect(getattr(fn, "__name__", "task"))

    def close(self) -> None:
        for box, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                try:
                    box.put(None)
                except (OSError, ValueError):
                    pass
        while True:                 # drain what a rank wrote before joining it
            try:
                self._outbox.get(timeout=0.1)
            except queue.Empty:
                break
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ----------------------------------------------------------------------
# the q5-shaped plan
# ----------------------------------------------------------------------

def q5_frames(n_fact: int = 4000, n_dim: int = 256, n_nation: int = 5, seed: int = 21,
              device="cpu"):
    """(fact, dim) as the reference's dry run and ``tests/test_spmd_engine.py``
    draw them: fact (suppkey, price, qty), dim (suppkey, nation)."""
    import numpy as np

    from cudf_tpu_torch.frame.dataframe import DataFrame

    rng = np.random.default_rng(seed)
    fact = DataFrame({
        "suppkey": torch.from_numpy(rng.integers(0, n_dim, n_fact)).to(device),
        "price": torch.from_numpy(rng.integers(1, 1000, n_fact).astype(np.float64)).to(device),
        "qty": torch.from_numpy(rng.integers(1, 50, n_fact)).to(device)})
    dim = DataFrame({"suppkey": torch.arange(n_dim, dtype=torch.int64, device=device),
                     "nation": torch.from_numpy(rng.integers(0, n_nation, n_dim)).to(device)})
    return fact, dim


def q5_plan(fact, dim):
    """scan, filter, join, groupby, sort: revenue by nation."""
    from cudf_tpu_torch.engine import col, from_dataframe

    return (from_dataframe(fact).filter(col("qty") < 25)
            .join(from_dataframe(dim), on="suppkey", how="inner")
            .group_by("nation").agg(col("price").sum().alias("revenue"))
            .sort("revenue", descending=True))


def q5_rank(n_fact: int = 4000, n_dim: int = 256, device="cpu") -> dict:
    """One rank's run of the q5-shaped plan over every rank (the join and
    the groupby shuffled: ``executor.broadcast_limit`` 0), beside the
    in-memory ``collect()``; on ``device`` (None: this rank's card)."""
    from cudf_tpu_torch.engine import get_fallback_stats, reset_fallback_stats
    from cudf_tpu_torch.parallel.mesh import (collective_stats, make_mesh,
                                              reset_collective_stats)
    from cudf_tpu_torch.utils.config import option_context

    mesh = make_mesh(device=device)
    fact, dim = q5_frames(n_fact, n_dim, device=mesh.device)
    plan = q5_plan(fact, dim)
    reset_fallback_stats()
    reset_collective_stats()
    with option_context("executor.broadcast_limit", 0):
        got = plan.collect(mesh=mesh)
    exp = plan.collect()
    g, e = got._table, exp._table
    same = list(g.names) == list(e.names) and g.num_rows == e.num_rows and all(
        torch.equal(g[n].data, e[n].data) if not g[n].dtype.is_float
        else torch.allclose(g[n].data, e[n].data, rtol=1e-12, atol=0.0) for n in e.names)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "cudf_tpu", "pandas", "pyarrow"))
    return {"rank": mesh.rank, "ranks": mesh.size, "rows_out": g.num_rows,
            "equal_to_memory": bool(same), "fallbacks": get_fallback_stats()["count"],
            "nations": g["nation"].data.tolist(), "collectives": collective_stats(),
            "foreign_modules": foreign}


def dryrun(n: int) -> list:
    """The q5-shaped plan over ``n`` gloo ranks: each rank's report."""
    with RankPool(n) as pool:
        return pool.run(q5_rank)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--torchrun" in argv:
        from cudf_tpu_torch.parallel import bootstrap

        bootstrap.initialize(device="cpu" if "--cpu" in argv else None)
        try:
            report = q5_rank(device="cpu" if "--cpu" in argv else None)
        finally:
            bootstrap.shutdown()
        print(json.dumps(report), flush=True)
        return 0 if report["equal_to_memory"] and report["fallbacks"] == 0 else 1
    n = int(argv[0]) if argv else 4
    reports = dryrun(n)
    for r in reports:
        print(json.dumps(r), flush=True)
    ok = all(r["equal_to_memory"] and r["fallbacks"] == 0 and not r["foreign_modules"]
             for r in reports)
    print(json.dumps({"ok": ok, "ranks": n}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
