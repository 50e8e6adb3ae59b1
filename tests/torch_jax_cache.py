"""JAX's persistent compilation cache for one test run, shared by its
xdist workers.

The port's tests hold the port to the reference, and the reference
compiles the same programs again and again: a Pallas kernel in
interpret mode at the shapes ``tests/test_radix.py`` also compiles, the
same TPC-H plan in several files, a jitted closure rebuilt by every call.
JAX keys a compiled program by its HLO and compile options, so with a
persistent cache each repeat, in any worker of the run, reads the program
instead of compiling it again.  Nothing a test computes changes.

Importing this module (every port test module that calls the reference
does) points JAX at one directory a run, under the temp dir and named by
xdist's run id, which every worker of a run shares and no other run
has: nothing carries over from one run to the next.  Without xdist the
directory is the process's own.  Every compile is written, however short.
The directories of runs older than a day are removed.  The setting is
process-wide, so the reference's own tests in the same worker share the
cache too, and it is exported to the environment, so a process a test
starts shares it as well.
"""

import os
import shutil
import tempfile
import time

import jax

ROOT = os.path.join(tempfile.gettempdir(), "cudf_tpu_torch_jax_cache")
DAY_S = 86400


def enable() -> str:
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
    path = os.path.join(ROOT, run)
    os.makedirs(path, exist_ok=True)
    now = time.time()
    for old in os.scandir(ROOT):
        if old.path != path and now - old.stat().st_mtime > DAY_S:
            shutil.rmtree(old.path, ignore_errors=True)
    settings = {"jax_compilation_cache_dir": path,
                "jax_persistent_cache_min_compile_time_secs": 0.0,
                "jax_persistent_cache_min_entry_size_bytes": 0}
    for name, value in settings.items():
        jax.config.update(name, value)
        os.environ[name.upper()] = str(value)         # for the processes tests start
    return path


PATH = enable()
