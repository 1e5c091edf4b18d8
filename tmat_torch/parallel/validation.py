"""Multi-process validation: a tiny demo plate and the worker launcher.

Counterpart of ``tmat_tpu/parallel/validation.py``. ``make_demo_plate``
gives textured vessel crosses; with the identity segmentor (whose tiled
blend gives its input back) the crosses reach the Morse stage, so every
well has branches and a striping fault that drops or reorders wells
shows as a different result, not as zeros equal to zeros.

``run_coordinated_workers`` is the one spawn-and-reap loop of every
multi-process run of the port (tests, ``chip_smoke.py``): N processes
with torchrun's environment over a free localhost port.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np

from tmat_torch.device import DeviceLike, resolve_device


def make_demo_plate(n_wells: int, z: int = 3, hw: int = 48, seed: int = 0
                    ) -> Tuple[np.ndarray, List[str]]:
    """(n_wells, z, hw, hw) uint8 plate of textured vessel crosses, and
    the well ids. The noise gives the Morse graph its saddle and maximum
    pairs (a flat ridge has none)."""
    rng = np.random.RandomState(seed)
    plate = (rng.rand(n_wells, z, hw, hw) * 30).astype(np.uint8)
    mid, hwid = hw // 2, 3
    bar = slice(mid - hwid, mid + hwid)
    vessel = np.zeros((hw, hw), bool)
    vessel[bar, 4:-4] = True
    vessel[4:-4, bar] = True
    for i in range(n_wells):
        tex = (160 + rng.rand(hw, hw) * 90).astype(np.uint8)
        plate[i, 1][vessel] = tex[vessel]
    return plate, [f"W{i}" for i in range(n_wells)]


def identity_segmentor(patch_size: int = 16, device: DeviceLike = None) -> SimpleNamespace:
    """What the plate uses of a patch segmentor, with the identity as its
    forward."""
    return SimpleNamespace(device=resolve_device(device), patch_size=patch_size, channels=1,
                           ds_ratio=1.0, tta=8, _pred_fn=lambda batch: batch)


def run_demo_plate(n_wells: int, seed: int = 0, device: DeviceLike = None) -> dict:
    """The demo plate through ``run_plate``, each process on its stripe of
    the wells, merged in well order on every process; deterministic in
    ``(n_wells, seed)``, so runs at any process count compare."""
    from tmat_torch.parallel.distributed import stripe
    from tmat_torch.tools.plate_pipeline import merge_plate_results, run_plate

    plate, ids = make_demo_plate(n_wells, seed=seed)
    mine = stripe(range(n_wells))
    res = run_plate(plate[mine], [ids[i] for i in mine], identity_segmentor(device=device),
                    {"image_width_microns": 800.0}, sd_coef=-1.0, device=device)
    res.pop("_timer")
    merged, errors = merge_plate_results(res, mine)
    if errors:
        raise RuntimeError(f"demo plate failed: {errors}")
    return merged


def worker_env(rank: int, n_processes: int, port: int) -> dict:
    """torchrun's environment for one of ``n_processes`` on this host,
    joined over ``localhost:port``, with this checkout first on the path."""
    env = os.environ.copy()
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n_processes),
               LOCAL_WORLD_SIZE=str(n_processes), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    repo_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class InfraFailure(RuntimeError):
    """Workers that failed to meet (a port taken between the probe and
    the bind, a timeout), not on their own work: worth one retry."""


# stderr of a rendezvous that could not bind its port
_INFRA_MARKERS = ("Address already in use", "EADDRINUSE")


def run_coordinated_workers(argv_tail: List[str], n_processes: int, extra_env: Optional[dict] = None,
                            timeout: float = 900.0) -> List[str]:
    """Run ``[sys.executable, *argv_tail]`` as ``n_processes`` processes of
    one job over a free localhost port; returns their stdouts, in rank
    order. Every process is reaped before this returns or raises. A worker
    that exits non-zero raises RuntimeError (``InfraFailure`` when the
    rendezvous failed, or on the timeout)."""
    port = _free_port()
    procs = []
    for rank in range(n_processes):
        env = worker_env(rank, n_processes, port)
        env.update(extra_env or {})
        procs.append(subprocess.Popen([sys.executable, *argv_tail], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outcomes, timed_out = [], False
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            for p in procs:
                p.kill()
            out, err = proc.communicate()
        outcomes.append((proc.returncode, out, err))
    if timed_out:
        raise InfraFailure(f"coordinated workers timed out after {timeout}s; stderr tails:\n"
                           + "\n".join(err[-500:] for _, _, err in outcomes))
    for rank, (rc, out, err) in enumerate(outcomes):
        if rc != 0:
            msg = f"coordinated worker {rank} failed (rc={rc}); stderr tail:\n{err[-3000:]}"
            if any(m in err for m in _INFRA_MARKERS):
                raise InfraFailure(msg)
            raise RuntimeError(msg)
    return [out for _, out, _ in outcomes]


def run_with_retry(argv_tail: List[str], n_processes: int, **kwargs) -> List[str]:
    """``run_coordinated_workers``, once more on a fresh port after an
    ``InfraFailure``; a worker that failed on its own work is not retried."""
    try:
        return run_coordinated_workers(argv_tail, n_processes, **kwargs)
    except InfraFailure:
        return run_coordinated_workers(argv_tail, n_processes, **kwargs)


def launch_multihost_workers(n_processes: int, n_wells: Optional[int] = None, check_local: bool = False,
                             device: str = "cuda", timeout: float = 900.0) -> List[dict]:
    """The demo plate over ``n_processes`` workers
    (``parallel/_multihost_worker.py``) on ``device``; asserts that every
    process reports the same result and returns them, one per process."""
    argv_tail = ["-m", "tmat_torch.parallel._multihost_worker", "--device", device]
    if n_wells is not None:
        argv_tail += ["--wells", str(n_wells)]
    if check_local:
        argv_tail.append("--check-local")
    outs = run_with_retry(argv_tail, n_processes, timeout=timeout)
    results = []
    for rank, out in enumerate(outs):
        lines = [line for line in out.splitlines() if line.startswith("WORKER_RESULT ")]
        if not lines:
            raise RuntimeError(f"worker {rank} printed no result:\n{out[-1000:]}")
        results.append(json.loads(lines[-1].split(" ", 1)[1]))
    if any(r != results[0] for r in results[1:]):
        raise AssertionError(f"processes disagree: {results}")
    return results
