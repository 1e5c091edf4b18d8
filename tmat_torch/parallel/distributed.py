"""Multi-process runs of the tools on ``torch.distributed``.

Counterpart of ``tmat_tpu/parallel/distributed.py``. The tools scale out
by striping their work list over processes: each process reads, computes
and writes its own share, and the rows of the shared CSVs are gathered
to the primary process, which writes them. Only host objects cross
processes (rows, error strings, listings), so the channel is a gloo
process group on the CPU: no tensor is exchanged, NCCL is not needed, and
several processes can share one card.

A run is multi-process when torchrun's environment is set (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), where
the JAX package reads ``TMAT_TPU_COORDINATOR`` and its companions::

    torchrun --nproc-per-node 2 -m tmat_torch.cli compute_inv_depth IN OUT

Each process then takes card ``LOCAL_RANK % torch.cuda.device_count()``
(``parallel/mesh.py``). Every process must call the collectives below in
the same order; a process that catches a failure passes it through
``merge_striped_rows`` (or ``gather_objects``) instead of exiting alone,
so that every process sees it and all exit together. With the
environment set, a failed initialisation raises: nothing falls back to
one process.
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from tmat_torch.parallel.mesh import process_card

# how long a collective waits for its slowest process (a peer still
# computing its stripe) before it raises
TIMEOUT = timedelta(minutes=30)


def initialize() -> None:
    """Join the gloo process group of torchrun's environment (``RANK`` of
    ``WORLD_SIZE``, meeting at ``MASTER_ADDR:MASTER_PORT``) and take this
    process's card. Idempotent; a group that cannot form raises."""
    if dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT)
    atexit.register(_destroy)
    if torch.cuda.is_available():
        torch.cuda.set_device(process_card())


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def maybe_initialize_from_env() -> bool:
    """Join the process group iff torchrun's environment asks for it.
    Tool mains call this first: without ``WORLD_SIZE`` it does nothing,
    so one process runs as before. Returns True when it joined."""
    if "WORLD_SIZE" not in os.environ:
        return False
    initialize()
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the one process that writes the shared outputs."""
    return process_index() == 0


def sync_processes(name: str = "barrier") -> None:
    """Barrier over every process (no-op in one process). ``name`` says
    what is waited for, in the error of a barrier that times out."""
    if not is_multiprocess():
        return
    try:
        dist.barrier()
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {name!r}: {exc}") from exc


def stripe(items) -> list:
    """This process's round-robin share of a work list (``items[i::P]``).
    Every process must pass the same ordered list. One process: all."""
    seq = list(items)
    if not is_multiprocess():
        return seq
    return seq[process_index()::process_count()]


def gather_objects(obj) -> list:
    """``[obj of process 0, ..., obj of process P-1]`` on every process
    (one process: ``[obj]``). Objects are pickled; their sizes may differ."""
    if not is_multiprocess():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def merge_striped_rows(rows: list, error: Optional[str] = None):
    """Every process's ``(global_index, ...)`` rows, sorted by global index
    (stably: rows of one item keep their order), and every error string a
    process caught, as ``(merged_rows, errors)``, on every process. A
    non-empty ``errors`` is a failure of the whole run."""
    parts = gather_objects({"rows": list(rows), "error": error})
    errors = [p["error"] for p in parts if p["error"]]
    merged = sorted((r for p in parts for r in p["rows"]), key=lambda r: r[0])
    return merged, errors
