"""Tabbed desktop GUI of the port's tools.

Counterpart of ``tmat_tpu/gui.py``: the four tool tabs ("Analyze
Microvessels" / "Z Project" / "Estimate Cell Coverage Area" / "Predict
Depth of Invasion") and the batch plate tab, shared in_root/out_root
directory pickers plus --channel/--time, tool-specific options; each run
goes to ``tmat_torch.tools.<tool>.main(args=namespace, device=...)`` in
this process, on a worker thread. ``tkinter`` is imported only by
``main``, so the rest imports where there is no Tk.

Run with: python -m tmat_torch.gui
"""

from __future__ import annotations

import argparse
import importlib
import threading
import traceback
from dataclasses import dataclass, field
from typing import Dict, List

from tmat_torch.device import DeviceLike


@dataclass
class Field:
    """One GUI option mapping to an argparse attribute."""

    name: str  # argparse attribute name
    label: str
    kind: str = "str"  # str | int | float | bool | dir | floats
    default: object = None
    help: str = ""


@dataclass
class ToolTab:
    title: str
    tool: str  # module name under tmat_torch.tools
    fields: List[Field] = field(default_factory=list)


_COMMON = [
    Field("in_root", "Input folder", "dir"),
    Field("out_root", "Output folder", "dir"),
    Field("channel", "Color channel index", "int"),
    Field("time", "Time index", "int"),
]

TABS: List[ToolTab] = [
    ToolTab(
        "Analyze Microvessels",
        "compute_branches",
        _COMMON
        + [
            Field("image_width_microns", "Image width (microns)", "float"),
            Field("detect_well", "Detect well boundary", "bool", False),
            Field("graph_thresh_1", "Graph threshold 1", "floats"),
            Field("graph_thresh_2", "Graph threshold 2", "floats"),
            Field("min_branch_length", "Min branch length (µm)", "float"),
            Field("max_branch_length", "Max branch length (µm)", "float"),
            Field("graph_smoothing_window", "Smoothing window (µm)", "float"),
            Field("remove_isolated_branches", "Remove isolated branches", "bool", False),
            Field("model_cfg_path", "Model config path", "str"),
            Field("tta", "TTA variants (8/4/1; 8 = reference parity)", "int"),
            Field("config", "Config file", "str"),
        ],
    ),
    ToolTab(
        "Z Project",
        "compute_zproj",
        _COMMON
        + [
            Field("method", "Projection method (min/max/med/avg/fs)", "str", "max"),
            Field("area", "Compute cell area after projection", "bool", False),
        ],
    ),
    ToolTab(
        "Estimate Cell Coverage Area",
        "compute_cell_area",
        _COMMON
        + [
            Field("detect_well", "Detect well boundary", "bool", False),
            Field("sd_coef", "SD coefficient", "float"),
            Field("config", "Config file", "str"),
        ],
    ),
    ToolTab(
        "Predict Depth of Invasion",
        "compute_inv_depth",
        _COMMON + [Field("config", "Config file", "str")],
    ),
    # whole-plate zproj -> area -> branches in one streamed run
    ToolTab(
        "Process Plate (batch)",
        "plate_pipeline",
        [
            Field("in_root", "Plate folder", "dir"),
            Field("out_root", "Output folder", "dir"),
            Field("image_width_microns", "Image width (microns)", "float"),
            Field("method", "Projection method (min/max/med/avg/fs)", "str", "max"),
            Field("detect_well", "Detect well boundary", "bool", False),
            Field("sd_coef", "SD coefficient", "float"),
            Field("model_cfg", "Model config path", "str"),
            Field("tta", "TTA variants (8/4/1; 8 = reference parity)", "int"),
        ],
    ),
]


def build_namespace(tab: ToolTab, values: Dict[str, object]) -> argparse.Namespace:
    """Convert GUI field values into the argparse Namespace a tool expects."""
    ns = argparse.Namespace()
    for f in tab.fields:
        raw = values.get(f.name, f.default)
        if raw in ("", None):
            val = f.default if f.kind == "bool" else None
        elif f.kind == "int":
            val = int(raw)
        elif f.kind == "float":
            val = float(raw)
        elif f.kind == "floats":
            val = [float(v) for v in str(raw).split()]
        elif f.kind == "bool":
            val = bool(raw)
        else:
            val = str(raw)
        setattr(ns, f.name, val)
    return ns


def run_tool(tab: ToolTab, ns: argparse.Namespace, device: DeviceLike = None) -> None:
    """Run the tab's tool in this process: ``main(args=ns, device=device)``."""
    module = importlib.import_module(f"tmat_torch.tools.{tab.tool}")
    module.main(args=ns, device=device)


class TabController:
    """The Run-button behavior of one tab, independent of tkinter.

    Holds the tab's value sources (tk.Variable in the real app; any
    object with ``get()`` in tests) and runs the tool on a worker thread,
    on ``device`` (None = CUDA). ``status_set`` receives the
    Running/finished/exited/failed updates the status bar shows.
    """

    def __init__(self, tab: ToolTab, variables: Dict[str, object], status_set,
                 device: DeviceLike = None):
        self.tab = tab
        self.variables = variables
        self.status_set = status_set
        self.device = device

    def namespace(self) -> argparse.Namespace:
        values = {k: v.get() for k, v in self.variables.items()}
        return build_namespace(self.tab, values)

    def launch(self, join: bool = False):
        ns = self.namespace()
        self.status_set(f"Running {self.tab.title}...")

        def work():
            try:
                run_tool(self.tab, ns, self.device)
                self.status_set(f"{self.tab.title} finished.")
            except SystemExit as exc:
                self.status_set(f"{self.tab.title} exited with code {exc.code}.")
            except Exception:
                traceback.print_exc()
                self.status_set(f"{self.tab.title} failed (see terminal).")

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        if join:
            thread.join()
        return thread


def build_tab_widgets(frame, tab: ToolTab, ttk_mod, tk_mod, filedialog_mod):
    """Create one tab's labeled entry/checkbox rows; returns its variables.

    Shared by ``build_app`` and the tests, so a widget-kind or field
    rename breaks a test, not just the live app.
    """
    variables: Dict[str, object] = {}
    for row, f in enumerate(tab.fields):
        ttk_mod.Label(frame, text=f.label).grid(
            row=row, column=0, sticky="w", padx=4, pady=2
        )
        if f.kind == "bool":
            var = tk_mod.BooleanVar(value=bool(f.default))
            ttk_mod.Checkbutton(frame, variable=var).grid(
                row=row, column=1, sticky="w"
            )
        else:
            var = tk_mod.StringVar(value="" if f.default is None else str(f.default))
            entry = ttk_mod.Entry(frame, textvariable=var, width=48)
            entry.grid(row=row, column=1, sticky="we", padx=4)
            if f.kind == "dir":

                def browse(v=var):
                    path = filedialog_mod.askdirectory()
                    if path:
                        v.set(path)

                ttk_mod.Button(frame, text="Browse", command=browse).grid(
                    row=row, column=2, padx=2
                )
        variables[f.name] = var
    return variables


def build_app(root, tk_mod, ttk_mod, filedialog_mod, device: DeviceLike = None):
    """Assemble the full notebook UI; returns (status_var, controllers).

    ``controllers`` maps tab title -> TabController, so a test holding a
    real Tk root can set widget variables and press Run programmatically.
    """
    root.title("Tissue Model Analysis Tools (PyTorch/CUDA)")
    notebook = ttk_mod.Notebook(root)
    notebook.pack(fill="both", expand=True)
    status = tk_mod.StringVar(value="Ready.")

    controllers: Dict[str, TabController] = {}
    for tab in TABS:
        frame = ttk_mod.Frame(notebook)
        notebook.add(frame, text=tab.title)
        variables = build_tab_widgets(frame, tab, ttk_mod, tk_mod, filedialog_mod)
        controller = TabController(tab, variables, status.set, device)
        controllers[tab.title] = controller
        ttk_mod.Button(frame, text="Run", command=controller.launch).grid(
            row=len(tab.fields), column=1, pady=8
        )

    ttk_mod.Label(root, textvariable=status).pack(fill="x", padx=4, pady=2)
    return status, controllers


def main():  # pragma: no cover - interactive
    import tkinter as tk
    from tkinter import filedialog, ttk

    root = tk.Tk()
    build_app(root, tk, ttk, filedialog)
    root.mainloop()


if __name__ == "__main__":
    main()
