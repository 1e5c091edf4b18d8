"""The port's public surface against the JAX package's, module by module.

Every ``tmat_tpu/**/*.py`` and its ``tmat_torch/`` twin are parsed with
``ast``; neither package is imported. Each public top-level name of the JAX
module (a function, class or assignment whose name has no leading
underscore) must be defined or imported by the port's module, and each
parameter of a function that both modules define must be a parameter of
the port's, unless the module, name or parameter stands below with the
reason the port does without it. An exception that no longer excuses
anything fails too, so the list cannot outlive what it excuses.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "tmat_tpu", ROOT / "tmat_torch"
JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))

# JAX modules with no twin file, and where the port does their work
MODULES_BY_DESIGN = {
    "core/aot_cache.py": "XLA's ahead-of-time executables; the port's native builds are cached by "
                         "tmat_torch/build.py",
    "core/compile_cache.py": "XLA's persistent compilation cache; see tmat_torch/build.py",
    "ops/pallas_unet.py": "the Pallas down block: tmat_torch/csrc/down_block.cu via ops/down_block.py, "
                          "its weights from models/params_io.py::from_flax_variables, its forward "
                          "models/unet.py::UNetXception, which takes it on every CUDA forward",
    "ops/pallas_zproj.py": "the Pallas focus kernel: tmat_torch/csrc/focus_stack.cu via "
                           "ops/focus_stack.py::focus_stack",
}

_MESH = "the XLA device mesh: the port runs on one device and stripes wells over processes"
_MULTIHOST = "JAX's multi-controller runtime: the port's processes join torchrun's gloo group"
_ENSEMBLE = "a vmap over stacked member pytrees: the port runs members in turn (resnet.ensemble_forward)"
_FALLBACK = "a fallback for a failed native build: in the port a failed build raises"
_MODULE_STATE = "the port's TrainState holds the nn.Module, whose weights the steps update in place"

# (JAX module, public name) -> why the port has no such name
NAMES_BY_DESIGN = {
    ("core/defs.py", "PKG_BASE_DIR"): "the port's REPO_DIR and PKG_CFG_PATH take its place",
    ("models/quant.py", "DN"): "lax.conv_general_dilated's dimension numbers; the port's convs are NCHW "
                               "views of NHWC tensors",
    ("models/resnet.py", "stack_ensemble_variables"): _ENSEMBLE,
    ("models/resnet.py", "make_ensemble_apply"): _ENSEMBLE,
    ("models/resnet.py", "make_ensemble_predict_fused"): _ENSEMBLE,
    ("ops/tiled.py", "PredFuncJitCache"): "a cache of jitted programs per predictor; PyTorch runs eagerly",
    ("parallel/_multihost_worker.py", "n_processes"): "the JAX worker's script globals; the port's "
                                                     "worker keeps them in main()",
    ("parallel/_multihost_worker.py", "n_devices"): "the JAX worker's script globals (see n_processes)",
    ("parallel/_multihost_worker.py", "n_wells"): "the JAX worker's script globals (see n_processes)",
    ("parallel/_multihost_worker.py", "res"): "the JAX worker's script globals (see n_processes)",
    ("parallel/_multihost_worker.py", "local"): "the JAX worker's script globals (see n_processes)",
    ("parallel/_multihost_worker.py", "res_local"): "the JAX worker's script globals (see n_processes)",
    ("parallel/distributed.py", "put_global"): _MULTIHOST,
    ("parallel/distributed.py", "fetch"): _MULTIHOST,
    ("parallel/mesh.py", "make_mesh"): _MESH,
    ("parallel/mesh.py", "replicated"): _MESH,
    ("parallel/mesh.py", "shard_leading"): _MESH,
    ("parallel/validation.py", "multihost_worker_env"): _MULTIHOST,
    ("topo/dmtgraph.py", "compute_dmt_graph_numpy"): _FALLBACK,
    ("topo/labeling_native.py", "available"): _FALLBACK,
}

# a parameter no port function has
PARAMS_EVERYWHERE = {
    "mesh": _MESH,
    "aot_key": "the AOT executable cache's key; see core/aot_cache.py above",
}
# (JAX module, function, parameter) -> why the port's function does without it
PARAMS_BY_DESIGN = {
    ("models/train.py", "init_train_state", "variables"): _MODULE_STATE,
    ("models/train.py", "make_unet_train_step", "model"): _MODULE_STATE,
    ("models/train.py", "make_unet_eval_step", "model"): _MODULE_STATE,
    ("models/train.py", "make_tl_optimizer", "params"): _MODULE_STATE,
    ("models/train.py", "make_classifier_train_step", "model"): _MODULE_STATE,
    ("models/train.py", "fit", "model"): _MODULE_STATE,
    ("models/train.py", "two_stage_tl_fit", "variables"): _MODULE_STATE,
    ("models/train.py", "two_stage_tl_fit", "model"): "the port takes the nn.Module as `module`",
    ("ops/tiled.py", "predict_img_with_smooth_windowing", "channels"): "unused by the JAX function: "
                                                                       "the image's shape gives it",
    ("parallel/distributed.py", "initialize", "coordinator_address"): _MULTIHOST,
    ("parallel/distributed.py", "initialize", "num_processes"): _MULTIHOST,
    ("parallel/distributed.py", "initialize", "process_id"): _MULTIHOST,
    ("parallel/distributed.py", "initialize", "local_device_ids"): _MULTIHOST,
    ("parallel/validation.py", "run_coordinated_workers", "n_local"): "XLA's virtual CPU devices per "
                                                                     "process; a port process drives one",
    ("parallel/validation.py", "launch_multihost_workers", "n_local"): "XLA's virtual CPU devices per "
                                                                      "process (see run_coordinated_workers)",
    ("parallel/validation.py", "run_coordinated_workers", "per_pid_env"): "a per-process XLA environment "
                                                                         "for the multi-host worker; "
                                                                         "worker_env sets each rank's",
}


def _top_level(tree: ast.Module):
    """The statements run at import: the module's body, with the bodies of
    top-level ``if``/``try`` blocks."""
    stack = list(tree.body)
    while stack:
        node = stack.pop(0)
        if isinstance(node, ast.If):
            stack[:0] = node.body + node.orelse
        elif isinstance(node, ast.Try):
            stack[:0] = node.body + node.orelse + node.finalbody + [s for h in node.handlers for s in h.body]
        else:
            yield node


def surface(path: Path):
    """(defined: name -> node, imported names) of a module's top level."""
    defined, imported = {}, set()
    for node in _top_level(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        defined[n.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return defined, imported


def params(fn: ast.FunctionDef) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def gaps(module: str):
    """The JAX module's public names that the port lacks, and the (function,
    parameter) pairs of shared functions whose port lacks the parameter."""
    jax_defs, _ = surface(JAX_PKG / module)
    port_defs, port_imports = surface(PORT_PKG / module)
    names, missing_params = [], []
    for name, node in jax_defs.items():
        if name.startswith("_"):
            continue
        if name not in port_defs and name not in port_imports:
            names.append(name)
        elif isinstance(node, ast.FunctionDef) and isinstance(port_defs.get(name), ast.FunctionDef):
            have = set(params(port_defs[name]))
            missing_params += [(name, p) for p in params(node) if p not in have]
    return names, missing_params


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_the_jax_module_surface(module):
    if module in MODULES_BY_DESIGN:
        assert not (PORT_PKG / module).exists(), f"{module} has a twin now: drop it from MODULES_BY_DESIGN"
        return
    assert (PORT_PKG / module).is_file(), f"tmat_torch/{module} is missing"
    names, missing_params = gaps(module)
    unexcused = [n for n in names if (module, n) not in NAMES_BY_DESIGN]
    assert not unexcused, f"tmat_torch/{module} lacks {unexcused}"
    unexcused = [(f, p) for f, p in missing_params
                 if p not in PARAMS_EVERYWHERE and (module, f, p) not in PARAMS_BY_DESIGN]
    assert not unexcused, f"tmat_torch/{module}: functions lack parameters {unexcused}"
    # every exception of this module still excuses something
    stale = [n for m, n in NAMES_BY_DESIGN if m == module and n not in names]
    stale += [(f, p) for m, f, p in PARAMS_BY_DESIGN if m == module and (f, p) not in missing_params]
    assert not stale, f"exceptions for {module} that excuse nothing: {stale}"


def test_exceptions_name_jax_modules_and_give_reasons():
    modules = set(JAX_MODULES)
    keyed = list(MODULES_BY_DESIGN) + [m for m, _ in NAMES_BY_DESIGN] + [m for m, _, _ in PARAMS_BY_DESIGN]
    assert set(keyed) <= modules
    reasons = (list(MODULES_BY_DESIGN.values()) + list(NAMES_BY_DESIGN.values())
               + list(PARAMS_EVERYWHERE.values()) + list(PARAMS_BY_DESIGN.values()))
    assert all(isinstance(r, str) and len(r) > 20 and "\n" not in r for r in reasons)
