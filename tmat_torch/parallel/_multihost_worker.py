"""One process of an N-process demo-plate run.

Launched as ``python -m tmat_torch.parallel._multihost_worker`` by
``validation.launch_multihost_workers`` with torchrun's environment. Joins
the process group, runs its stripe of the demo plate, and prints the
merged results as one ``WORKER_RESULT`` JSON line. ``--check-local`` also
runs the whole plate in this process alone and requires the same result,
so the run tells a striping fault from a run that merely did not crash.
"""

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--wells", type=int, default=None, help="default: two per process")
    p.add_argument("--check-local", action="store_true")
    args = p.parse_args(argv)

    from tmat_torch.parallel import distributed as dist_
    from tmat_torch.parallel.validation import run_demo_plate

    if not dist_.maybe_initialize_from_env():
        raise SystemExit("the worker's environment does not ask for several processes")
    n_processes = int(os.environ["WORLD_SIZE"])
    if dist_.process_count() != n_processes or dist_.is_primary() != (int(os.environ["RANK"]) == 0):
        raise SystemExit(f"process group of {dist_.process_count()}, expected {n_processes}")
    n_wells = args.wells if args.wells is not None else 2 * n_processes
    res = run_demo_plate(n_wells, device=args.device)

    if args.check_local:
        alone = run_demo_plate_alone(n_wells, args.device)
        if res != alone:
            raise SystemExit(f"the striped plate differs from the whole plate:\n{res}\n{alone}")
        if not all(n > 0 for n in res["total_branches"]):
            raise SystemExit(f"a demo well has no branch: {res['total_branches']}")
    print("WORKER_RESULT " + json.dumps(res), flush=True)
    return 0


def run_demo_plate_alone(n_wells: int, device: str) -> dict:
    """The whole demo plate in this process, outside the stripes."""
    from tmat_torch.parallel.validation import identity_segmentor, make_demo_plate
    from tmat_torch.tools.plate_pipeline import run_plate

    plate, ids = make_demo_plate(n_wells)
    res = run_plate(plate, ids, identity_segmentor(device=device), {"image_width_microns": 800.0},
                    sd_coef=-1.0, device=device)
    res.pop("_timer")
    return res


if __name__ == "__main__":
    sys.exit(main())
