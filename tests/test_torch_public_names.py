"""Every public name of the JAX package has its counterpart in the port.

Walks each Python module of `neo_mpc_planner2_tpu` that declares
`__all__` and requires the module of the same path under
`neo_mpc_planner2_tpu_torch` to export each name (in its own `__all__`,
bound in the module). The one listed exception: `ops.pallas_kernels`,
whose one name, `footprint_cost_batch_pallas`, is the TPU kernel that the
port's `ops.footprint.footprint_cost_batch` launches as CUDA kernel K3.

Below module level: each exported class has every public member of its
JAX twin, and each function, method and constructor takes every
parameter of its twin by the same name; a parameter only the port has
(such as `device`) has a default, so a call written for JAX runs. The
members and parameters that differ on purpose are listed in
MEMBER_DIVERGENCES, each with its line under ROADMAP.md's deliberate
divergences.

The console scripts: every `[project.scripts]` entry of pyproject.toml
that points into the JAX package has a `<name>-torch` twin pointing at the
port's function of the same path.
"""

import importlib
import inspect
import pathlib
import pkgutil
import shutil
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu
import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops import costmap as jcm
from neo_mpc_planner2_tpu.ops import footprint as jfp
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch.native import host
from neo_mpc_planner2_tpu_torch.ops import costmap as tcm
from neo_mpc_planner2_tpu_torch.ops import footprint as tfp

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


def _scripts() -> dict:
    pyproject = pathlib.Path(__file__).resolve().parent.parent / "pyproject.toml"
    with open(pyproject, "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def _jax_scripts():
    return sorted(name for name, target in _scripts().items()
                  if target.startswith("neo_mpc_planner2_tpu."))


def test_the_jax_package_has_console_scripts():
    assert _jax_scripts() == ["neo-mpc-bench", "neo-mpc-server"]


@pytest.mark.parametrize("name", _jax_scripts())
def test_every_jax_console_script_has_a_torch_twin(name):
    """`<name>-torch` points at the port's module of the same path, and
    the function it names exists there and takes argv as JAX's does."""
    scripts = _scripts()
    assert f"{name}-torch" in scripts, name
    target = scripts[f"{name}-torch"]
    assert target == scripts[name].replace(
        "neo_mpc_planner2_tpu.", "neo_mpc_planner2_tpu_torch.", 1)
    mod, fn = target.split(":")
    jmod, jfn = scripts[name].split(":")
    port_fn = getattr(importlib.import_module(mod), fn)
    assert callable(port_fn)
    assert not _signature_gap(getattr(importlib.import_module(jmod), jfn),
                              port_fn)


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


# "module.Class.member" or "module.function" -> why the port differs
# (each a line under ROADMAP.md's deliberate divergences). Empty: every
# member and parameter of the JAX package has its counterpart.
MEMBER_DIVERGENCES: dict = {}


def _params(fn):
    """The named parameters of fn (no self, no *args/**kwargs), or None
    where it has no readable signature."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters.values()
            if p.name != "self"
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _signature_gap(jfn, tfn):
    """What a JAX-style call of tfn lacks: JAX's parameters missing from
    the port's, and the port's parameters that JAX has not and that have
    no default."""
    a, b = _params(jfn), _params(tfn)
    if a is None or b is None:
        return []
    names = {p.name for p in a}
    ported = {p.name for p in b}
    return ([f"missing {p.name}" for p in a if p.name not in ported]
            + [f"requires {p.name}" for p in b if p.name not in names
               and p.default is p.empty])


def _exported_pairs():
    """(qualified JAX name, JAX object, port object) of every exported
    name with a counterpart of the same path, each object once."""
    seen = set()
    for name in _jax_modules():
        names = getattr(importlib.import_module(name), "__all__", None)
        skip, _ = EXCEPTIONS.get(name, (set(), None))
        if not names or not set(names) - skip:
            continue
        mod = importlib.import_module(name)
        port = importlib.import_module(
            name.replace("neo_mpc_planner2_tpu", "neo_mpc_planner2_tpu_torch",
                         1))
        for n in names:
            obj = getattr(mod, n, None)
            if n in skip or obj is None or id(obj) in seen:
                continue
            seen.add(id(obj))
            yield f"{name}.{n}", obj, getattr(port, n)


def test_every_jax_class_member_and_signature_has_a_port_counterpart():
    gaps, classes, functions = {}, 0, 0
    for qual, obj, twin in _exported_pairs():
        if inspect.isclass(obj):
            classes += 1
            members = {m for m in dir(obj) if not m.startswith("_")}
            for m in sorted(members):
                key = f"{qual}.{m}"
                if key in MEMBER_DIVERGENCES:
                    continue
                if not hasattr(twin, m):
                    gaps[key] = ["missing member"]
                    continue
                jm, tm = getattr(obj, m), getattr(twin, m)
                if callable(jm) and callable(tm):
                    gap = _signature_gap(jm, tm)
                    if gap:
                        gaps[key] = gap
            gap = _signature_gap(obj, twin)
            if gap and qual not in MEMBER_DIVERGENCES:
                gaps[f"{qual}()"] = gap
        elif inspect.isfunction(obj):
            functions += 1
            gap = _signature_gap(obj, twin)
            if gap and qual not in MEMBER_DIVERGENCES:
                gaps[qual] = gap
    assert classes > 20 and functions > 80, (classes, functions)
    assert not gaps, gaps


# ---- the members that the walk above found missing, against JAX -------------

def test_maps_on_device_matches_the_host_path():
    """make_scenario_batch(maps_on_device=True) against the host path (the
    port's and JAX's, which are bit-equal): maps within 1e-5 (JAX's own
    tolerance, tests/test_simulation.py), exact-lethal cells the same,
    plans, poses and origins identical."""
    kw = dict(batch=8, seed=11, map_size=64, n_obstacles=6, plan_points=64,
              lethal_threshold=0.8, plan_length_range=(0.7, 1.1),
              clear_corridor_m=0.55, center_on="plan")
    jcfg = mpc.default_config()
    cfg = tp.default_config()
    want = jax.tree.map(np.asarray, jmake(jcfg, **kw))
    host = tp.make_scenario_batch(cfg, device="cpu", **kw)
    dev = tp.make_scenario_batch(cfg, maps_on_device=True, device="cpu", **kw)
    np.testing.assert_array_equal(host.costmap.data.numpy(),
                                  want.costmap.data)
    np.testing.assert_allclose(dev.costmap.data.numpy(), want.costmap.data,
                               atol=1e-5, rtol=0)
    assert ((dev.costmap.data.numpy() == 1.0)
            == (want.costmap.data == 1.0)).all()
    for got in (host, dev):
        np.testing.assert_array_equal(got.costmap.origin.numpy(),
                                      want.costmap.origin)
        np.testing.assert_array_equal(got.plan.px.numpy(), want.plan.px)
        np.testing.assert_array_equal(got.robot_pose.numpy(),
                                      want.robot_pose)


def test_footprint_cost_sample_fn_matches_jax():
    """footprint_cost(sample_fn=...) reads the boundary through the
    override (here a map offset by 0.25, clipped), as JAX's does; exact
    mode ignores it."""
    rng = np.random.default_rng(4)
    data = rng.uniform(0, 0.8, (32, 32)).astype(np.float32)
    verts = rng.uniform(-0.7, 0.7, (6, 8, 2)).astype(np.float32)
    nv = rng.integers(1, 9, 6).astype(np.int32)
    jmap = jcm.Costmap.create(data, (-0.8, -0.8), 0.05)
    tmap = tcm.Costmap.create(data, (-0.8, -0.8), 0.05, device="cpu")
    jfn = lambda wx, wy: jnp.minimum(jcm.cost_at_world(jmap, wx, wy) + 0.25,
                                     1.0)
    tfn = lambda wx, wy: torch.clamp_max(
        tcm.cost_at_world(tmap, wx, wy) + 0.25, 1.0)
    fp = tfp.Footprint(torch.as_tensor(verts), torch.as_tensor(nv))
    for mode in ("gather", "exact"):
        want = jax.vmap(lambda v, n: jfp.footprint_cost(
            jmap, jfp.Footprint(v, n), 12, mode, sample_fn=jfn))(
            jnp.asarray(verts), jnp.asarray(nv))
        got = tfp.footprint_cost(tmap, fp, 12, mode, sample_fn=tfn)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = tfp.footprint_cost(tmap, fp, 12)
    assert bool((tfp.footprint_cost(tmap, fp, 12, sample_fn=tfn)
                 >= plain).all())


def test_native_host_available_and_plan_replace(monkeypatch):
    """NativeHost.available(): the library is built, or g++ can build it
    (what constructing one needs); Plan.replace as JAX's."""
    assert host.NativeHost.available() == (
        host.library_path().exists() or shutil.which("g++") is not None)
    monkeypatch.setattr(host, "library_path",
                        lambda: host.BUILD_DIR / "no_such_library.so")
    monkeypatch.setattr(host.shutil, "which", lambda name: None)
    assert host.NativeHost.available() is False
    plan = tp.Plan.create([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], max_points=4,
                          device="cpu")
    moved = plan.replace(px=plan.px + 1.0)
    assert torch.equal(moved.px, plan.px + 1.0)
    assert moved.py is plan.py and int(moved.n_valid) == 2
