"""Create / relocate the user base directory.

Counterpart of ``tmat_tpu/configure.py``: prompts for a target when run
interactively with no argument, warns about shell-mangled Windows
drive-letter paths, MOVES an existing base dir to the new target (rename)
rather than abandoning it, copies the default configs shipped in the repo
into <base_dir>/config, creates model_training/ and output/, and records
the base dir in ``package.cfg`` with a ~-relative path when under the
user's home. It writes the same ``package.cfg`` (``core/defs.py::
PKG_CFG_PATH``) that both packages read, so one base dir serves both.
"""

from __future__ import annotations

import configparser
import os
import re
import shutil
import sys
from pathlib import Path

from tmat_torch.core import defs
from tmat_torch.core.log import SFM


def _warn_mangled_windows_path(target: str) -> None:
    """Drive letter with no slashes: likely backslashes eaten by a unix
    shell on Windows. Confirm before proceeding."""
    if not (re.search("^[A-Z]:", target) and "\\" not in target and "/" not in target):
        return
    print(
        f"\nWARNING: Path received from the command line may be invalid: {target}\n"
        "If you are using a unix-style shell on Windows like Git Bash, enclose\n"
        "the path in quotes, use forward slashes, or double the backslashes.",
        flush=True,
    )
    answer = input(f"Use the path '{target}'? [y/n]: ")
    if answer.strip().lower() != "y":
        print("Exiting...", flush=True)
        sys.exit(1)


def _recorded_base_dir() -> Path | None:
    """The base dir a previous `configure` recorded in package.cfg.

    Only a dir recorded there is safe to MOVE on reconfigure: defs.BASE_DIR
    can also come from the TMAT_TPU_BASE_DIR env var, which may point at an
    arbitrary directory (even a source checkout) that was never created by
    configure and must not be relocated.
    """
    cfg = configparser.ConfigParser()
    try:
        cfg.read(defs.PKG_CFG_PATH)
        base = cfg[defs.PKG_NAME]["base_dir"]
    except KeyError:
        return None
    if base.startswith("~"):
        return Path.home().resolve() / base[2:]
    return Path(base)


def configure(target_base_dir: str = "") -> Path:
    """Materialise (or relocate) the user base dir; record in package.cfg.

    When the base dir comes purely from the TMAT_TPU_BASE_DIR env var
    (no explicit target, no interactive choice), the dirs are
    materialised but package.cfg is NOT written: the env var is a
    session-scoped override (tests, benchmarks, CI point it at temp
    dirs), and persisting it would redirect every later process that
    lacks the var to a possibly-deleted path.
    """
    explicit = bool(target_base_dir)
    if target_base_dir:
        _warn_mangled_windows_path(target_base_dir)
    elif sys.stdin is not None and sys.stdin.isatty():
        # interactive prompt
        default = str(defs.BASE_DIR)
        print(
            f"\nEnter the preferred base directory location for {defs.PKG_NAME}.\n"
            "If it does not exist, it will be created. "
            "Leave empty to use the default.",
            flush=True,
        )
        target_base_dir = input(f"Base directory [{default}]: ") or default
        explicit = True  # interactive choice (typed or accepted default)

    base_dir = (
        Path(target_base_dir).expanduser() if target_base_dir else defs.BASE_DIR
    )
    # A session-scoped env override must be decided BEFORE the create-or-move
    # branch: it must never relocate the previously recorded base dir (user
    # models/configs/outputs) into an ephemeral temp path — especially since
    # the override path also skips recording, which would leave package.cfg
    # pointing at the renamed-away location.
    session_override = not explicit and bool(os.environ.get("TMAT_TPU_BASE_DIR"))
    prev_base_dir = None if session_override else _recorded_base_dir()

    if not base_dir.parent.is_dir():
        print(
            f"{SFM.failure} Parent directory does not exist: {base_dir.parent}",
            flush=True,
        )
        sys.exit(1)

    # Create-or-move: an existing base dir relocates with all user
    # artifacts; a fresh target is simply created.
    if base_dir.exists():
        pass
    elif (
        prev_base_dir is not None
        and prev_base_dir.is_dir()
        and prev_base_dir.resolve() != base_dir.resolve()
    ):
        print(
            f"Moving base directory from {prev_base_dir} to {base_dir}", flush=True
        )
        try:
            prev_base_dir.rename(base_dir)
        except (PermissionError, OSError) as e:
            print(
                f"{SFM.failure} Cannot move directory {prev_base_dir} to "
                f"{base_dir}: {e}",
                flush=True,
            )
            sys.exit(1)
    base_dir.mkdir(parents=True, exist_ok=True)

    config_dir = base_dir / "config"
    config_dir.mkdir(exist_ok=True)
    if defs.PKG_CONFIG_DIR.is_dir():
        for cfg in defs.PKG_CONFIG_DIR.glob("*.json"):
            dest = config_dir / cfg.name
            if not dest.exists():
                shutil.copy(cfg, dest)

    (base_dir / "model_training").mkdir(exist_ok=True)
    (base_dir / "output").mkdir(exist_ok=True)

    if session_override:
        # session-scoped env override (docstring above): dirs exist now,
        # but nothing is recorded in the package tree
        print(
            f"{SFM.success} Base directory materialised at {base_dir} "
            "(TMAT_TPU_BASE_DIR session override; not recorded in "
            "package.cfg)",
            flush=True,
        )
        return base_dir

    cfg = configparser.ConfigParser()
    cfg["metadata"] = {"name": defs.PKG_NAME}
    home = str(Path.home().resolve())
    base_str = str(base_dir.resolve())
    if base_str.startswith(home):
        base_str = "~" + base_str[len(home):]
    cfg[defs.PKG_NAME] = {"base_dir": base_str}
    with open(defs.PKG_CFG_PATH, "w") as fp:
        cfg.write(fp)

    print(f"{SFM.success} Base directory configured at {base_dir}", flush=True)
    return base_dir
