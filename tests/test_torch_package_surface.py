"""The port's package-level names against `curl_tpu`'s.

Every public name that a `curl_tpu` package `__init__` binds must be an
attribute of the port's package of the same path and, unless it is a
submodule, in its `__all__`; and it must be the very object of the port's
counterpart module, re-exported, not a second copy. Both sides are read with
`ast`, so the JAX package is never imported. The exceptions are the named
renames and omissions below, each with its reason.
"""

import ast
import importlib
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "curl_tpu"

# curl_tpu module path -> the port's counterpart.
MODULE_RENAMES = {
    "curl_tpu.ops.pallas": "curl_tpu_torch.ops.kernels",  # hand-written CUDA, not Pallas
    "curl_tpu.ops.pallas.curve_kernel": "curl_tpu_torch.ops.kernels.curve_kernel",
    "curl_tpu.ops.pallas.trispace_kernel": "curl_tpu_torch.ops.kernels.trispace_kernel",
    # torch.export takes StableHLO's role.
    "curl_tpu.export.stablehlo": "curl_tpu_torch.export.torch_export",
}
# (curl_tpu package, name) -> the port's name for it, with the reason.
NAME_RENAMES = {
    ("curl_tpu.export", "stablehlo_text"): (
        "program_text", "a torch.export program's text is not StableHLO"),
}
# (curl_tpu package, name) -> why the port's package does not export it.
OMITTED = {
    ("curl_tpu.data", "shard_batch"): (
        "a jax.Array placement over a device mesh; the port's ranks each load their own "
        "shard (parallel/, data.pipeline.to_device)"),
    ("curl_tpu.parallel", "local_mesh_cpu"): (
        "virtual XLA CPU devices; the port's CPU ranks are gloo processes "
        "(parallel/launch.py)"),
    ("curl_tpu.parallel", "shard_pytree"): (
        "places a pytree on a mesh; the port replicates a module on each rank and reduces "
        "its gradients in one flat all-reduce (train/state.py)"),
    ("curl_tpu.train", "create_train_state"): (
        "flax/optax state construction; the port's is TrainState(model, optimizer)"),
    ("curl_tpu.export", "export_trispace_state_dict"): (
        "the flax side of the weight bridge: it writes a flax model out as a timm state "
        "dict, which the port loads (tests/test_torch_model.py)"),
    ("curl_tpu.export", "timm_key_shapes"): (
        "the flax side of the bridge; the port's key names are checked against "
        "tests/fixtures/timm_efficientnetv2_rw_*_keys.json"),
}

INITS = sorted(JAX_ROOT.rglob("__init__.py"))


def _package(init: Path) -> str:
    return ".".join(init.parent.relative_to(REPO).parts)


def _port_module(module: str) -> str:
    for old, new in sorted(MODULE_RENAMES.items(), key=lambda kv: -len(kv[0])):
        if module == old or module.startswith(old + "."):
            return new + module[len(old):]
    return "curl_tpu_torch" + module[len("curl_tpu"):]


def _bindings(init: Path) -> dict:
    """Public name -> (module, attribute) of each `from M import a [as n]`
    at an `__init__`'s top level, with attribute None where `M.a` is a
    submodule; a public name bound any other way maps to None."""
    out = {}
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                path = REPO / Path(*node.module.split("."), alias.name)
                is_module = path.with_suffix(".py").exists() or (path / "__init__.py").exists()
                out[alias.asname or alias.name] = (
                    (f"{node.module}.{alias.name}", None) if is_module
                    else (node.module, alias.name))
        elif isinstance(node, (ast.Assign, ast.FunctionDef, ast.ClassDef)):
            for target in getattr(node, "targets", [node]):
                name = getattr(target, "id", getattr(target, "name", None))
                if name:
                    out[name] = None
    return {k: v for k, v in out.items() if not k.startswith("_")}


@pytest.mark.parametrize("init", INITS, ids=lambda p: str(p.parent.relative_to(REPO)))
def test_package_reexports_curl_tpu_names(init):
    jax_package = _package(init)
    port_package = _port_module(jax_package)
    port = importlib.import_module(port_package)
    port_init = Path(port.__file__)
    assert port_init.name == "__init__.py", port_init
    port_bindings = _bindings(port_init)
    exported = set(getattr(port, "__all__", ()))
    names = _bindings(init)
    assert names or jax_package == "curl_tpu.cli", f"no public names read from {init}"
    for name, where in names.items():
        if (jax_package, name) in OMITTED:
            assert name not in exported, f"{port_package}.{name} is exported: drop it from OMITTED"
            continue
        port_name = NAME_RENAMES.get((jax_package, name), (name,))[0]
        what = f"{port_package}.{port_name} (curl_tpu's {jax_package}.{name})"
        assert hasattr(port, port_name), f"{what} is missing"
        obj = getattr(port, port_name)
        if where is not None and where[1] is None:
            assert isinstance(obj, types.ModuleType), what
            assert obj is importlib.import_module(_port_module(where[0])), what
            continue
        assert port_name in exported, f"{what} is not in __all__"
        # Re-exported from the counterpart of the JAX package's module, as
        # the object itself.
        assert port_bindings.get(port_name) is not None, f"{what} is not a re-export"
        module, attr = port_bindings[port_name]
        if where is not None:
            assert module == _port_module(where[0]), (what, module, where)
        assert obj is getattr(importlib.import_module(module), attr), what


def test_allowlist_names_exist_in_curl_tpu():
    """Each rename and omission names a public binding of that `curl_tpu`
    package `__init__`, so the allowlist holds no stale entry."""
    bound = {(_package(i), n) for i in INITS for n in _bindings(i)}
    assert set(OMITTED) <= bound, set(OMITTED) - bound
    assert set(NAME_RENAMES) <= bound, set(NAME_RENAMES) - bound
    for jax_module in MODULE_RENAMES:
        assert (REPO / Path(*jax_module.split("."))).with_suffix(".py").exists() or (
            REPO / Path(*jax_module.split(".")) / "__init__.py").exists(), jax_module
