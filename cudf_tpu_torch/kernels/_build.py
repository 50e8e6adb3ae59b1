"""Build and bind the port's CUDA kernels (counterpart of
``cudf_tpu/native.py``).

``cudf_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and link into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, from the package's sources only, into
``build/cudf_tpu_torch/`` beside the package; the library's file name
carries a hash of the sources and flags, so a changed source is rebuilt
and a stale library is never loaded.  Nothing here runs at import time:
the package imports where there is no CUDA and no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from cudf_tpu_torch.utils import tracing

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "cudf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# value kinds the kernels take (csrc/common.cuh ValueKind)
VALUE_KINDS = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}


class BuildError(RuntimeError):
    """The kernels did not build: nvcc is missing or failed."""


class LaunchError(RuntimeError):
    """A kernel's C entry point returned a CUDA error."""


class _Library:
    def __init__(self, path: Path):
        self.path = path
        self._cdll = ctypes.CDLL(str(path))
        self._cdll.cudf_error_string.argtypes = [ctypes.c_int]
        self._cdll.cudf_error_string.restype = ctypes.c_char_p
        self._functions: Dict[str, ctypes._CFuncPtr] = {}

    def function(self, name: str, argtypes: Sequence):
        fn = self._functions.get(name)
        if fn is None:
            fn = getattr(self._cdll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            self._functions[name] = fn
        return fn

    def error_string(self, err: int) -> str:
        return self._cdll.cudf_error_string(err).decode()


_library: Optional[_Library] = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found: the CUDA kernels need the CUDA "
                         "toolkit (set CUDA_HOME)")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the library unless a build of the same
    sources exists; return its path.  Each source compiles in its own
    nvcc process, all at once; then one nvcc links them.  Raises with
    nvcc's output on a failed build."""
    out = BUILD_DIR / f"libcudf_tpu_torch_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for obj, proc in jobs:               # wait for every process, failed or not
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{obj.name}: nvcc exit {proc.returncode}\n{log}")
    objs = [str(obj) for obj, _ in jobs]
    try:
        if failed:
            raise BuildError("nvcc failed:\n" + "\n".join(failed))
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc link failed ({proc.returncode}):\n"
                             f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    return out


def ptxas_report(source: Path) -> List[str]:
    """ptxas's report (``-Xptxas -v``) on one source compiled with the
    build's flags: each kernel's registers, stack frame and spills.  The
    object is discarded.  Raises with nvcc's output on a failed compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = BUILD_DIR / f"ptxas.{Path(source).stem}.{os.getpid()}.o"
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                               str(source)], capture_output=True, text=True)
    finally:
        obj.unlink(missing_ok=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise BuildError(f"nvcc -Xptxas -v {source}: exit {proc.returncode}\n{log}")
    return [line.strip() for line in log.splitlines() if line.strip()]


def sass_opcodes(source: Path, prefix: str) -> Dict[str, Dict[str, int]]:
    """{kernel: {opcode: count}} of the SASS opcodes starting with
    ``prefix`` (e.g. "ATOMS") in each kernel of one source, compiled with
    the build's flags and disassembled by ``cuobjdump -sass``.  Raises
    with the tools' output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cubin = BUILD_DIR / f"sass.{Path(source).stem}.{os.getpid()}.cubin"
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-cubin", "-o", str(cubin), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc -cubin {source}: exit {proc.returncode}\n"
                             f"{proc.stdout}{proc.stderr}")
        proc = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True)
    finally:
        cubin.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise BuildError(f"cuobjdump -sass {source}: exit {proc.returncode}\n{proc.stderr}")
    out: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            out[kernel] = {}
            continue
        for word in line.replace(";", " ").split():
            if kernel is not None and word.startswith(prefix):
                out[kernel][word] = out[kernel].get(word, 0) + 1
    return out


def library() -> _Library:
    """The loaded kernel library, built at first use."""
    global _library
    if _library is None:
        _library = _Library(build())
    return _library


def launch(name: str, argtypes: Sequence, device: torch.device, *args,
           counter=None, nbytes: int = 0) -> None:
    """Call C entry point ``name`` on ``device``'s current stream (passed
    as the last argument) and raise if it returns a CUDA error.  A kernel
    launch names its wrapper, ``counter``, whose ``launches`` it counts,
    and its least bytes (each operand read once, each output written
    once, at its element width): the call is then a "kernel" span of
    ``utils/tracing.py`` while spans are recorded."""
    lib = library()
    fn = lib.function(name, list(argtypes) + [ctypes.c_void_p])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if counter is None:
            err = fn(*args, stream)
        else:
            err = tracing.kernel(name, nbytes, fn, *args, stream)
    if err != 0:
        raise LaunchError(f"{name}: CUDA error {err}: {lib.error_string(err)}")
    if counter is not None:
        counter.launches += 1


def kernel_values(vals: torch.Tensor):
    """(vals in a kernel value type, its kind, the sum dtype).

    int32/int64/float32/float64 go to the kernels as they are; narrower
    ints and bool widen to int32 and uint32 to int64.  Integer values sum
    exactly in int64, floats in float64."""
    if vals.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8, torch.uint16):
        vals = vals.to(torch.int32)
    elif vals.dtype == torch.uint32:
        vals = vals.to(torch.int64)
    if vals.dtype not in VALUE_KINDS:
        raise TypeError(f"kernel values of dtype {vals.dtype} are not supported")
    acc = torch.float64 if vals.dtype.is_floating_point else torch.int64
    return vals.contiguous(), VALUE_KINDS[vals.dtype], acc


def check_vector(name: str, t: torch.Tensor, dtype: torch.dtype, n: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous 1-D ``dtype`` tensor of length n
    on ``device``."""
    if t.dtype != dtype or t.shape != (n,) or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype}[{n}] on {device}, got "
                         f"{t.dtype}{list(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes of the tensors at their element widths (None counts 0): a
    launch's least bytes, each operand read once and each output written
    once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# payload columns that move with the keys in one partition or sort launch
# (csrc/common.cuh Columns: the keys and up to four more)
MAX_PAYLOADS = 4


def check_keys(keys: torch.Tensor) -> int:
    """n after checking contiguous int32 keys [n], n < 2^31, on the CPU or
    a CUDA device."""
    n = keys.shape[0]
    check_vector("keys", keys, torch.int32, n, keys.device)
    if n >= 1 << 31:
        raise ValueError("the kernels address rows with int32: n < 2^31")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    return n


def check_columns(keys: torch.Tensor, columns: Sequence[torch.Tensor]) -> int:
    """n after checking the keys and at most MAX_PAYLOADS 4- or 8-byte
    columns [n] on the keys' device."""
    n = check_keys(keys)
    if len(columns) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads move with one launch")
    for c in columns:
        check_vector("payload", c, c.dtype, n, keys.device)
        if c.element_size() not in (4, 8):
            raise ValueError(f"payload dtype {c.dtype}: 4 or 8 bytes per element")
    return n


def column_arrays(columns: Sequence[torch.Tensor], outs: Sequence[torch.Tensor]):
    """(src, dst, widths): host arrays of the columns' and outputs' device
    pointers and element widths, as the kernels take them (pass each with
    ctypes.addressof; keep them alive over the launch)."""
    src = (ctypes.c_void_p * MAX_PAYLOADS)(*[c.data_ptr() for c in columns])
    dst = (ctypes.c_void_p * MAX_PAYLOADS)(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * MAX_PAYLOADS)(*[c.element_size() for c in columns])
    return src, dst, widths
