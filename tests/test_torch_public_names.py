"""Every public name of the JAX package has its counterpart in the port.

Walks each Python module of `neo_mpc_planner2_tpu` that declares
`__all__` and requires the module of the same path under
`neo_mpc_planner2_tpu_torch` to export each name (in its own `__all__`,
bound in the module). The one listed exception: `ops.pallas_kernels`,
whose one name, `footprint_cost_batch_pallas`, is the TPU kernel that the
port's `ops.footprint.footprint_cost_batch` launches as CUDA kernel K3.
"""

import importlib
import pkgutil

import neo_mpc_planner2_tpu

# JAX module -> (its names with no counterpart of the same path, where
# each one's counterpart lives).
EXCEPTIONS = {
    "neo_mpc_planner2_tpu.ops.pallas_kernels": (
        {"footprint_cost_batch_pallas"},
        "neo_mpc_planner2_tpu_torch.ops.footprint.footprint_cost_batch"),
}


def _jax_modules():
    """The package and its Python submodules (not the built host library,
    which has no Python source)."""
    yield neo_mpc_planner2_tpu.__name__
    for info in pkgutil.walk_packages(neo_mpc_planner2_tpu.__path__,
                                      neo_mpc_planner2_tpu.__name__ + "."):
        spec = importlib.util.find_spec(info.name)
        if spec.origin and spec.origin.endswith(".py"):
            yield info.name


def test_every_jax_module_name_has_a_port_counterpart():
    missing, walked = {}, 0
    for name in _jax_modules():
        names = getattr(importlib.import_module(name), "__all__", None)
        if not names:
            continue
        walked += 1
        skip, counterpart = EXCEPTIONS.get(name, (set(), None))
        if counterpart is not None:
            mod, attr = counterpart.rsplit(".", 1)
            assert hasattr(importlib.import_module(mod), attr), counterpart
        todo = [n for n in names if n not in skip]
        if not todo:
            continue
        port = importlib.import_module(
            name.replace("neo_mpc_planner2_tpu", "neo_mpc_planner2_tpu_torch",
                         1))
        exported = set(getattr(port, "__all__", ()))
        gone = [n for n in todo if n not in exported or not hasattr(port, n)]
        if gone:
            missing[name] = gone
    assert walked > 20
    assert not missing, missing
