"""The port's multi-process helpers (``tmat_torch/parallel``) on the CPU.

Mirrors ``tests/test_distributed.py``: one process passes everything
through, the environment alone decides whether a process group is
joined, and the striping, merging, discovery check, padding and demo
plate follow the JAX package's. Two real processes under gloo: objects
of unequal sizes gather in rank order, and the demo plate striped over
two processes equals the whole plate in each.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tmat_tpu.parallel import distributed as jdist, mesh as jmesh, validation as jval
from tmat_tpu.tools import args as jargs
from tmat_torch.parallel import distributed as dist, mesh, validation
from tmat_torch.tools import args as su

REPO = Path(__file__).resolve().parent.parent


def test_single_process_passthrough():
    assert dist.process_index() == 0 and dist.process_count() == 1
    assert dist.is_primary() and not dist.is_multiprocess()
    assert dist.stripe(iter([1, 2, 3])) == [1, 2, 3]
    assert dist.gather_objects({"a": 1}) == [{"a": 1}]
    rows = [(2, "b"), (0, "a"), (2, "c")]
    assert dist.merge_striped_rows(rows, "boom") == ([(0, "a"), (2, "b"), (2, "c")], ["boom"])
    assert dist.merge_striped_rows(rows) == jdist.merge_striped_rows(rows)
    dist.sync_processes()
    su.check_striped_discovery(["a", "b"])


def test_maybe_initialize_noop_without_env(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert dist.maybe_initialize_from_env() is False
    assert dist.process_count() == 1


@pytest.mark.parametrize("n_processes", [1, 2, 3, 4])
@pytest.mark.parametrize("n_items", [0, 1, 5, 9])
def test_stripe_matches_jax(n_processes, n_items, monkeypatch):
    items = [f"img{i}" for i in range(n_items)]
    stripes = []
    for rank in range(n_processes):
        monkeypatch.setattr(dist, "process_index", lambda r=rank: r)
        monkeypatch.setattr(dist, "process_count", lambda: n_processes)
        monkeypatch.setattr(jdist, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jdist, "process_count", lambda: n_processes)
        stripes.append(dist.stripe(items))
        assert stripes[-1] == jdist.stripe(items)
    assert sorted(x for s in stripes for x in s) == sorted(items)
    assert max(map(len, stripes)) - min(map(len, stripes)) <= 1


def test_check_striped_discovery_exits_1_on_divergent_listings(monkeypatch, capsys):
    """Both packages' checks, each given two processes' listings."""
    for m in (dist, jdist):
        monkeypatch.setattr(m, "is_multiprocess", lambda: True)
        monkeypatch.setattr(m, "gather_objects", lambda ids: [["a", "b"], ["a"]])
    for check in (su.check_striped_discovery, jargs.check_striped_discovery):
        with pytest.raises(SystemExit) as exc:
            check(["a", "b"])
        assert exc.value.code == 1
    assert "Input discovery differs" in capsys.readouterr().out
    monkeypatch.setattr(dist, "gather_objects", lambda ids: [list(ids)] * 2)
    su.check_striped_discovery(["a", "b"])  # the same listing everywhere passes


@pytest.mark.parametrize("n,multiple", [(5, 8), (8, 8), (3, 2), (1, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, n_valid = mesh.pad_to_multiple(arr, multiple)
    ref, ref_valid = jmesh.pad_to_multiple(arr, multiple)
    assert n_valid == ref_valid == n
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_process_card():
    assert [mesh.process_card(r, 1) for r in range(3)] == [0, 0, 0]
    assert [mesh.process_card(r, 4) for r in range(6)] == [0, 1, 2, 3, 0, 1]
    with pytest.raises(RuntimeError):
        mesh.process_card(0, 0)


def test_demo_plate_equals_jax():
    for n_wells, seed in ((3, 0), (5, 7)):
        plate, ids = validation.make_demo_plate(n_wells, seed=seed)
        ref, ref_ids = jval.make_demo_plate(n_wells, seed=seed)
        np.testing.assert_array_equal(plate, ref)
        assert ids == ref_ids


def test_demo_plate_one_process_has_branches():
    res = validation.run_demo_plate(3, device="cpu")
    assert res["well_id"] == ["W0", "W1", "W2"]
    assert all(n > 0 for n in res["total_branches"])
    assert all(0 < a < 100 for a in res["area_pct"])


def _busy_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    s.listen(1)
    return s


def test_failed_initialisation_raises(tmp_path):
    """With torchrun's environment set, a process group that cannot form is
    an error: the tool does not run as one process."""
    with _busy_port() as s:
        env = {**validation.worker_env(0, 2, s.getsockname()[1]), "TMAT_TPU_BASE_DIR": str(tmp_path)}
        code = ("from tmat_torch.tools import compute_cell_area as t\n"
                f"t.main(argv=[{str(tmp_path)!r}, {str(tmp_path / 'out')!r}], device='cpu')\n")
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                              timeout=300)
    assert proc.returncode != 0
    assert "address already in use" in proc.stderr.lower(), proc.stderr[-2000:]
    assert not (tmp_path / "out").exists()


def test_two_process_gather_objects_unequal_sizes():
    code = ("from tmat_torch.parallel import distributed as d\n"
            "assert d.maybe_initialize_from_env()\n"
            "pid = d.process_index()\n"
            "got = d.gather_objects({'pid': pid, 'blob': 'x' * (10 if pid == 0 else 100_000)})\n"
            "assert [g['pid'] for g in got] == [0, 1], got\n"
            "assert len(got[0]['blob']) == 10 and len(got[1]['blob']) == 100_000\n"
            "d.sync_processes('done')\n"
            "print('GATHER_OK', d.is_primary())\n")
    outs = validation.run_with_retry(["-c", code], 2, timeout=180)
    assert [o.split()[-2:] for o in outs] == [["GATHER_OK", "True"], ["GATHER_OK", "False"]]


def test_two_process_demo_plate_matches_one_process():
    """Five wells over two processes (3 + 2): each process's merged result
    equals the whole plate run in that process alone (``--check-local``)
    and the one-process run here."""
    results = validation.launch_multihost_workers(2, n_wells=5, check_local=True, device="cpu",
                                                  timeout=300)
    assert len(results) == 2
    assert results[0] == validation.run_demo_plate(5, device="cpu")


def test_worker_refuses_without_env():
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "tmat_torch.parallel._multihost_worker", "--device", "cpu"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "does not ask for several processes" in proc.stderr


def test_a_dead_peer_fails_the_other_process():
    """A process that dies before a collective does not leave its peer
    waiting: gloo loses the connection and the peer raises too."""
    code = ("from tmat_torch.parallel import distributed as d\n"
            "assert d.maybe_initialize_from_env()\n"
            "if d.process_index() == 1:\n"
            "    raise SystemExit(3)\n"
            "d.gather_objects(1)\n")
    with pytest.raises(RuntimeError) as exc_info:
        validation.run_with_retry(["-c", code], 2, timeout=120)
    assert not isinstance(exc_info.value, validation.InfraFailure), exc_info.value
    assert "worker 0 failed" in str(exc_info.value) and "all_gather_object" in str(exc_info.value)
