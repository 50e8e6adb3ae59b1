"""Process-group bootstrap (port of ``cudf_tpu/parallel/bootstrap.py``).

The reference starts ``jax.distributed`` (one process a host, every chip
of the pod one device set).  Here one process drives one card, and the
processes form a ``torch.distributed`` group: NCCL between cards, gloo
between CPU processes (the tests, the dry run).

Under torchrun (``torchrun --nproc-per-node=N script.py``) every argument
comes from its environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``.  One process with none of them set
forms a group of one over an in-memory store, so the same script runs on
one card and on many:

    from cudf_tpu_torch.parallel import bootstrap, make_mesh
    bootstrap.initialize()            # NCCL on this rank's card
    mesh = make_mesh()                # every rank
    ... cudf_tpu_torch.parallel ops, or lf.collect(mesh=mesh) ...
    bootstrap.shutdown()
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None, *, device=None, store=None,
               local_rank: Optional[int] = None, timeout_s: float = 600.0) -> None:
    """Join (or form) the default process group.

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method`` to
    ``tcp://MASTER_ADDR:MASTER_PORT`` when those are set.  The backend is
    NCCL on the card ``cuda:local_rank`` (made current), unless ``device``
    is the CPU: then gloo.  With no rank, world size, store or address
    given anywhere, one process forms a group of one over a ``HashStore``.
    A group already formed is left as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    local_rank = local_rank if local_rank is not None else (_env_int("LOCAL_RANK") or 0)
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    kwargs = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if not cpu:
        torch.cuda.set_device(local_rank)
        kwargs["device_id"] = torch.device("cuda", local_rank)
    if init_method is None and store is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if init_method is None and store is None:
        if (world_size or 1) > 1:
            raise ValueError(f"a group of {world_size} ranks needs an address or a store")
        store, rank, world_size = dist.HashStore(), 0, 1
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method
    dist.init_process_group(backend, rank=rank if rank is not None else 0,
                            world_size=world_size if world_size is not None else 1, **kwargs)


def shutdown() -> None:
    """Destroy the default group (what ``initialize`` formed, or any)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> dict:
    """This process's place in the group, for logs."""
    import torch.distributed as dist

    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "platform": "gpu" if torch.cuda.is_available() else "cpu",
    }


def global_mesh(axis_names=("x",), shape=None, device=None):
    """The mesh of every rank: 1-D over the group, or 2-D
    ``global_mesh(("dcn", "x"), (slices, per_slice))``."""
    from cudf_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh

    if len(axis_names) == 1:
        return make_mesh(axis=axis_names[0], device=device)
    if shape is None or len(shape) != 2:
        raise ValueError("shape (slices, per_slice) required for a 2-D mesh")
    return make_multislice_mesh(shape[0], shape[1], dcn_axis=axis_names[0],
                                ici_axis=axis_names[1], device=device)


def host_local_slice(n_rows: int) -> slice:
    """This process's rows of ``n_rows`` (an even split by rank): what it
    loads of a source every rank names."""
    import torch.distributed as dist

    from cudf_tpu_torch.parallel.mesh import row_range

    up = dist.is_initialized()
    lo, hi = row_range(n_rows, dist.get_rank() if up else 0, dist.get_world_size() if up else 1)
    return slice(lo, hi)
