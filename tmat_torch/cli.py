"""Command-line interface of the port: ``tmat-torch``.

Counterpart of ``tmat_tpu/cli.py``: the subcommand ``configure`` and the
five tools, an interactive numbered menu when no subcommand is given,
and the base directory configured first when it is missing. Each tool
runs in this process through its ``main``, on ``device`` (None = CUDA).
"""

from __future__ import annotations

import sys

from tmat_torch.configure import configure
from tmat_torch.core import defs
from tmat_torch.core.log import SFM
from tmat_torch.device import DeviceLike

USAGE = f"""Usage: tmat-torch [SUBCOMMAND] [OPTIONS]

If no subcommand is given, the interactive mode will be used.

Available subcommands:
    configure: Set the location of the base directory for configs and models.
    compute_zproj: Compute Z projections from image stacks.
    compute_cell_area: Compute cell coverage area.
    compute_inv_depth: Predict depth of invasion.
    compute_branches: Analyze microvessel branching.
    process_plate: Run a whole plate end-to-end (zproj + cell area + branches).

Get available options:
    -h, --help: Show this help message and exit.
    [SUBCOMMAND] -h: Show help for a particular subcommand.

Examples:
{SFM.highlight('''
    tmat-torch configure ~/tmat_data
    tmat-torch compute_zproj ./stacks ./out -m fs
    tmat-torch compute_inv_depth ./stacks ./out
    tmat-torch compute_branches ./images ./out --image-width-microns 1200
''')}
"""


def _tool_modules():
    from tmat_torch.tools import (
        compute_branches,
        compute_cell_area,
        compute_inv_depth,
        compute_zproj,
        plate_pipeline,
    )

    return {
        "compute_zproj": compute_zproj,
        "compute_cell_area": compute_cell_area,
        "compute_inv_depth": compute_inv_depth,
        "compute_branches": compute_branches,
        "process_plate": plate_pipeline,
    }


def _descriptions(tools):
    descs = [
        ("help", f"Show usage information for {SFM.highlight('tmat-torch')}"),
        ("configure", "Set the base directory for the package"),
    ]
    for name, mod in tools.items():
        doc = (mod.__doc__ or "No description found.").strip().split("\n")[0]
        descs.append((name, doc))
    return descs


def main(argv=None, device: DeviceLike = None) -> int:
    """Run one subcommand; returns its exit code. ``device`` goes to the
    tool (None = CUDA)."""
    argv = sys.argv[1:] if argv is None else argv

    if argv and argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0

    tools = _tool_modules()
    commands = ["help", "configure"] + list(tools)

    command = argv[0] if argv else None
    command_args = argv[1:] if argv else []

    if command is None:
        print("Command options:")
        for i, (cmd, desc) in enumerate(_descriptions(tools)):
            print(SFM.highlight(f"  {i + 1}. {cmd}") + f": {desc}")
        prompt = f"Enter a command option by number or enter {SFM.highlight('q')} to quit: "
        while True:
            choice = input(prompt)
            if choice == "q":
                print("Exiting...")
                return 0
            try:
                num = int(choice)
            except ValueError:
                num = commands.index(choice) + 1 if choice in commands else -1
            if num < 1 or num > len(commands):
                print(f"Invalid command option: {choice}")
            elif commands[num - 1] == "help":
                print(USAGE)
            else:
                command = commands[num - 1]
                break
        if command != "configure":
            raw = input(f"Arguments, if any (or {SFM.highlight('-h')} to list options): ")
            command_args = raw.split()

    if command not in commands:
        print(f"{SFM.failure} Unknown subcommand: {command}")
        print(USAGE)
        return 1

    if command == "help":
        print(USAGE)
        return 0

    if command == "configure":
        target = command_args[0] if command_args else ""
        configure(target_base_dir=target)
        return 0

    required = [defs.BASE_DIR, defs.SCRIPT_CONFIG_DIR, defs.MODEL_TRAINING_DIR]
    if any(not d.is_dir() for d in required):
        print("Base directory not fully configured. Running configure...")
        configure()

    try:
        tools[command].main(argv=command_args, device=device)
    except SystemExit as exc:
        return exc.code or 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
