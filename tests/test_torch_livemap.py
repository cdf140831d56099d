"""The port's live-map regimes against the JAX package on the same inputs.

- The rolling view's index math (world_to_map, grid_bounds, extent_world)
  and its samplers (nearest, bilinear, the solver's flat and u8 gathers, the
  footprint cost through K3's plain version with the cell shift) equal the
  JAX package's exactly, with samples on the window's cell boundaries; the
  view reads exactly what the port's materialized window reads.
- `update_window` and `extract_window` equal the JAX package's
  (`jax.vmap(Costmap.update_window)`, `extract_window_onehot`) exactly.
- Each regime of `batch_simulate` matches the JAX package's within the gates
  of tests/test_golden.py: commands atol 1e-4, goal distance atol 1e-3,
  `lethal` and `collisions` equal. The JAX dynamic regime runs under
  `jax.jit`: called eagerly it reaches an `np` that its module never
  imports (the port raises ValueError on mixed resolutions instead).
- The regimes' checks raise with the JAX package's messages; a chained pair
  of update segments equals one run; the caller's maps are never written.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu import simulation as jsim
from neo_mpc_planner2_tpu.ops import costmap as jcm
from neo_mpc_planner2_tpu.ops import footprint as jfp
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch import simulation as tsim
from neo_mpc_planner2_tpu_torch.ops import costmap as tcm
from neo_mpc_planner2_tpu_torch.ops import footprint as tfp

from test_torch_slice import _fleet_cfg, _from_jax, _product_cfg, _tcfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
T = lambda a: torch.as_tensor(np.array(a))
N = np.asarray
RES = np.float32(0.05)


def _worlds(rng, B=3, H=96, W=80, u8_grid=False):
    data = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    if u8_grid:
        data = (np.round(data * 255) / 255.0).astype(np.float32)
    data[:, H // 3, :] = 1.0
    origin = rng.uniform(-2.5, -0.5, (B, 2)).astype(np.float32)
    res = np.full((B,), RES, np.float32)
    jc = mpc.Costmap(data=jnp.asarray(data), origin=jnp.asarray(origin),
                     resolution=jnp.asarray(res))
    return jc, tcm.Costmap(data=T(data), origin=T(origin), resolution=T(res))


def _poses(jc, rng):
    """Robot poses at the world's centre, near each corner and off it, so
    that some windows are clamped inside the world."""
    B = jc.data.shape[0]
    o = N(jc.origin)
    span = np.asarray(jc.data.shape[-1:-3:-1], np.float32) * RES
    picks = [0.5, 0.03, 0.97, 1.6]
    frac = np.asarray([[picks[(b + k) % 4] for k in (0, 1)]
                       for b in range(B)], np.float32)
    xy = o + frac * span
    return np.concatenate([xy, rng.uniform(-3, 3, (B, 1))], -1).astype(
        np.float32)


def _views(jc, tc, poses, cells):
    jview = jax.vmap(jsim.rolling_view, in_axes=(0, 0, None))(
        jc, jnp.asarray(poses), cells)
    tview = tsim.rolling_view(tc, T(poses), cells)
    return jview, tview


def _window_boundary_points(jview, cells):
    """Per lane: points on the window-local cell boundaries and centres,
    from two cells below the window to two past it, and in the band just
    below the window's origin."""
    ox, oy = (N(v) for v in jax.vmap(jcm.grid_origin)(jview))
    k = np.arange(-2, cells + 2, dtype=np.float32)
    band = RES * np.linspace(0.01, 0.99, 5, dtype=np.float32)
    out = []
    for o in (ox, oy):
        lane = [np.concatenate([ob + k * RES, ob + (k + np.float32(0.5)) * RES,
                                ob - band]) for ob in o]
        out.append(np.stack(lane).astype(np.float32))
    gx = np.repeat(out[0], out[1].shape[1], axis=1)
    gy = np.tile(out[1], (1, out[0].shape[1]))
    return gx, gy


def test_view_index_math_matches_jax():
    rng = np.random.default_rng(0)
    jc, tc = _worlds(rng)
    cells = 32
    jview, tview = _views(jc, tc, _poses(jc, rng), cells)
    np.testing.assert_array_equal(tview.win_lo.numpy(), N(jview.win_lo))
    assert tview.win_lo.dtype == torch.int32 and tview.win_cells == cells
    np.testing.assert_array_equal(tview.extent_world().numpy(),
                                  N(jax.vmap(lambda c: c.extent_world())(
                                      jview)))
    for got, want in zip(tcm.grid_bounds(tview),
                         jax.vmap(jcm.grid_bounds)(jview)):
        np.testing.assert_array_equal(got.numpy(), N(want))
    for got, want in zip(tcm.grid_origin(tview),
                         jax.vmap(jcm.grid_origin)(jview)):
        np.testing.assert_array_equal(got.numpy(), N(want))
    wx, wy = _window_boundary_points(jview, cells)
    jmx, jmy = jax.vmap(jcm.world_to_map)(jview, wx, wy)
    tmx, tmy = tcm.world_to_map(tview, T(wx), T(wy))
    np.testing.assert_array_equal(tmx.numpy(), N(jmx))
    np.testing.assert_array_equal(tmy.numpy(), N(jmy))
    lo = N(jview.win_lo)[:, None]
    assert ((N(jmx) < lo[..., 0]).any() and (N(jmx) >= lo[..., 0] + cells)
            .any())
    for tfn, jfn in ((tcm.cost_at_world, jcm.cost_at_world),
                     (tcm.cost_at_world_bilinear,
                      jcm.cost_at_world_bilinear)):
        want = N(jax.vmap(jfn)(jview, wx, wy))
        np.testing.assert_array_equal(tfn(tview, T(wx), T(wy)).numpy(), want)
        assert (want == 1.0).any() and (want < 1.0).any()


@pytest.mark.parametrize("u8", [False, True])
def test_view_point_sampler_matches_jax(u8):
    """The solver's hoisted gather (flat, or the u8 source) on a view."""
    rng = np.random.default_rng(1)
    jc, tc = _worlds(rng, u8_grid=u8)
    jview, tview = _views(jc.with_flat(u8=u8), tc.with_flat(u8=u8),
                          _poses(jc, rng), 40)
    wx, wy = _window_boundary_points(jview, 40)
    cx = jnp.zeros(3)
    want = jax.vmap(lambda c, x, y: jcm.make_point_sampler(c, 0.0, 0.0, 0)(
        x, y))(jview, wx, wy)
    got = tcm.make_point_sampler(tview)(T(wx), T(wy))
    np.testing.assert_array_equal(got.numpy(), N(want))
    with pytest.raises(ValueError, match="rolling-window"):
        tcm.make_point_sampler(tview, T(N(cx)), T(N(cx)), 5)


def test_view_reads_what_the_window_reads():
    """The port's view against the port's materialized window (which equals
    JAX's rolling_window): nearest, bilinear and footprint reads, in, out
    of the window and off the world."""
    rng = np.random.default_rng(2)
    jc, tc = _worlds(rng)
    poses = _poses(jc, rng)
    jwin = jax.vmap(jsim.rolling_window, in_axes=(0, 0, None))(
        jc, jnp.asarray(poses), 32)
    twin = tsim.rolling_window(tc, T(poses), 32)
    np.testing.assert_array_equal(twin.data.numpy(), N(jwin.data))
    np.testing.assert_array_equal(twin.origin.numpy(), N(jwin.origin))
    tview = tsim.rolling_view(tc, T(poses), 32)
    wx = T(rng.uniform(-3.0, 3.0, (3, 256)).astype(np.float32))
    wy = T(rng.uniform(-3.0, 3.0, (3, 256)).astype(np.float32))
    for fn in (tcm.cost_at_world, tcm.cost_at_world_bilinear):
        assert torch.equal(fn(tview, wx, wy), fn(twin, wx, wy))
    fp = tfp.transform_footprint(
        T(np.concatenate([N(wx[:, :21, None]), N(wy[:, :21, None]),
                          rng.uniform(-3, 3, (3, 21, 1))], -1).astype(
            np.float32)),
        tp.Footprint.rectangle(0.6, 0.4, device="cpu"))
    assert torch.equal(tfp.footprint_cost(tview, fp, 16),
                       tfp.footprint_cost(twin, fp, 16))


def _view_polygons(jview, rng, R):
    """(B, R, 8, 2) polygons: window-local grid-aligned rectangles (samples
    on cell boundaries) straddling the window's edges, and placed
    rectangles anywhere around the window; padded slots hold garbage."""
    ox, oy = (N(v) for v in jax.vmap(jcm.grid_origin)(jview))
    B = ox.shape[0]
    verts = rng.uniform(50, 90, (B, R, 8, 2)).astype(np.float32)
    nv = np.full((B, R), 4, np.int32)
    for b in range(B):
        o = np.asarray([ox[b], oy[b]], np.float32)
        for r in range(R):
            if r % 2 == 0:
                k = rng.integers(-3, 35, 2)
                e = rng.integers(1, 6, 2)
                lo = o + k.astype(np.float32) * RES
                hi = o + (k + e).astype(np.float32) * RES
                quad = [[hi[0], hi[1]], [lo[0], hi[1]], [lo[0], lo[1]],
                        [hi[0], lo[1]]]
            else:
                c = o + rng.uniform(-0.3, 1.9, 2)
                quad = c + rng.uniform(-0.3, 0.3, (4, 2))
            verts[b, r, :4] = np.asarray(quad, np.float32)
            if r % 3 == 2:
                nv[b, r] = 3
    return verts, nv


@pytest.mark.parametrize("R,samples", [(1, 16), (7, 8)])
def test_footprint_cost_on_a_view_matches_jax(R, samples):
    """K3's plain version with the cell shift (through footprint_cost on the
    port's view) against jax.vmap(footprint_cost) on JAX's view."""
    rng = np.random.default_rng(3 + R)
    jc, tc = _worlds(rng)
    jview, tview = _views(jc, tc, _poses(jc, rng), 32)
    verts, nv = _view_polygons(jview, rng, R)
    want = jax.vmap(lambda c, vs, ns: jax.vmap(lambda v, n: jfp.footprint_cost(
        c, mpc.Footprint(vertices=v, n_valid=n), samples))(vs, ns))(
        jview, jnp.asarray(verts), jnp.asarray(nv))
    tfp.footprint_cost_batch.launches = 0
    got = tfp.footprint_cost(tview, tfp.Footprint(T(verts), T(nv)), samples)
    np.testing.assert_array_equal(got.numpy(), N(want))
    assert tfp.footprint_cost_batch.launches == 0
    assert (N(want) == 1.0).any() and (N(want) < 1.0).any()
    # The plain version called with the view's arguments directly.
    origin, bounds, shift = tfp.kernel_map_arguments(tview)
    direct = tfp.footprint_cost_batch_plain(
        tview.data, origin, tview.resolution, bounds, T(verts), T(nv),
        tfp.edge_parameters(samples, "cpu"), shift)
    np.testing.assert_array_equal(direct.numpy(), N(want))
    with pytest.raises(ValueError, match="view"):
        tfp.footprint_cost(tview, tfp.Footprint(T(verts), T(nv)), samples,
                           bounds=bounds)


@pytest.mark.parametrize("case", ["inside", "clamped", "nonfinite",
                                  "wide_block"])
def test_update_window_matches_jax(case):
    rng = np.random.default_rng({"inside": 4, "clamped": 5, "nonfinite": 6,
                                 "wide_block": 7}[case])
    B, H, W = 4, 24, 30
    jc, tc = _worlds(rng, B, H, W)
    jc, tc = jc.with_flat(u8=True), tc.with_flat(u8=True)
    hc, wc = (5, 9) if case == "wide_block" else (7, 7)
    cells = rng.uniform(0, 1, (B, hc, wc)).astype(np.float32)
    if case == "nonfinite":
        cells[:, 0, 0] = np.nan
        cells[:, 1, 2] = np.inf
        cells[:, 3, 3] = -np.inf
    lo = rng.integers(0, min(H - hc, W - wc), (B, 2)).astype(np.int32)
    if case == "clamped":
        lo = np.asarray([[-4, 3], [W - 2, -1], [W + 9, H + 9], [2, H - 3]],
                        np.int32)
    before = [x.clone() for x in (tc.data, tc.flat_u8)]
    want = jax.vmap(lambda c, b, l: c.update_window(b, l))(
        jc, jnp.asarray(cells), jnp.asarray(lo))
    got = tc.update_window(T(cells), T(lo))
    for name in ("data", "flat", "flat_u8"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      N(getattr(want, name)), err_msg=name)
    assert torch.equal(got.flat, got.data.reshape(B, -1))
    assert torch.equal(tc.data, before[0]) and torch.equal(tc.flat_u8,
                                                           before[1])
    assert not torch.equal(got.data, tc.data)
    with pytest.raises(ValueError, match="exceeds the map"):
        tc.update_window(torch.zeros(B, H + 1, 3), T(lo))
    with pytest.raises(ValueError):
        jax.vmap(lambda c, b, l: c.update_window(b, l))(
            jc, jnp.zeros((B, H + 1, 3)), jnp.asarray(lo))


def test_extract_window_matches_jax_onehot():
    """Corners inside, negative (wrapping from the end, as
    lax.dynamic_slice does) and past the end (clamped)."""
    rng = np.random.default_rng(8)
    B, H, W = 6, 20, 26
    data = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    rows = np.asarray([0, 5, -3, -25, H + 4, H - 6], np.int32)
    cols = np.asarray([7, -1, W + 2, 0, -30, W - 9], np.int32)
    for hc, wc in ((6, 9), (1, 1), (H, W)):
        want = jax.vmap(lambda d, r, c: jcm.extract_window_onehot(
            d, r, c, hc, wc))(jnp.asarray(data), jnp.asarray(rows),
                              jnp.asarray(cols))
        got = tcm.extract_window(T(data), T(rows), T(cols), hc, wc)
        np.testing.assert_array_equal(got.numpy(), N(want))


def _dyn_obstacles(B, map_size, n, seed):
    rng = np.random.default_rng(seed)
    half = map_size * 0.05 / 2
    return tuple(np.asarray(a, np.float32) for a in (
        rng.uniform(-half + 0.8, half - 0.3, (B, n, 2)),
        rng.uniform(0.3, 0.95, (B, n)),
        rng.uniform(-0.25, 0.25, (B, n, 2))))


def _updates(B, map_size, seed, amp=None):
    rng = np.random.default_rng(seed)
    half = map_size * 0.05 / 2
    c = rng.uniform(-half + 0.8, half - 0.3, (B, 2))
    a = rng.uniform(0.3, 0.95, (B,)) if amp is None else np.full((B,), amp)
    v = rng.uniform(-0.25, 0.25, (B, 2))
    # The first lanes' obstacles sit on their robots' starts.
    c[: B // 2] = rng.uniform(-0.2, 0.2, (B // 2, 2))
    return tuple(np.asarray(x, np.float32) for x in (c, a, v))


REGIMES = {
    # name: (map side, config overrides, batch_simulate options)
    "rolling": (96, {}, dict(window_cells=48)),
    "rolling_slice": (96, {}, dict(window_cells=48, window_view=False)),
    "rolling_u8_auto": (128, dict(solver_costmap_u8="auto", w_costmap=5.0),
                        dict(window_cells=48)),
    "dynamic": (48, dict(w_costmap=0.5), dict(obstacles=6,
                                              obstacle_lethal_threshold=0.6)),
    "updates": (48, dict(w_costmap=0.5),
                dict(updates=True, update_cells=12,
                     obstacle_lethal_threshold=0.5)),
    "updates_rolling": (96, dict(w_costmap=0.5),
                        dict(updates=True, update_cells=12,
                             window_cells=48)),
}


def _regime_args(name, B):
    """The JAX and port keyword arguments of one regime, same values."""
    map_size, _, opts = REGIMES[name]
    opts = dict(opts)
    jkw, tkw = {}, {}
    n = opts.pop("obstacles", None)
    if n is not None:
        arrs = _dyn_obstacles(B, map_size, n, 3)
        jkw["dynamic_obstacles"] = tuple(map(jnp.asarray, arrs))
        tkw["dynamic_obstacles"] = tuple(map(T, arrs))
    if opts.pop("updates", False):
        arrs = _updates(B, map_size, 4)
        jkw["costmap_updates"] = tuple(map(jnp.asarray, arrs))
        tkw["costmap_updates"] = tuple(map(T, arrs))
    jkw.update(opts)
    tkw.update(opts)
    return jkw, tkw


def _assert_gates(got, want):
    """The golden gates (tests/test_golden.py)."""
    np.testing.assert_allclose(got.cmds.numpy(), N(want.cmds), atol=1e-4)
    np.testing.assert_allclose(got.goal_dist.numpy(), N(want.goal_dist),
                               atol=1e-3)
    np.testing.assert_array_equal(got.lethal.numpy(), N(want.lethal))
    np.testing.assert_array_equal(got.collisions.numpy(),
                                  N(want.collisions))


@pytest.mark.parametrize("name", list(REGIMES))
def test_batch_simulate_regime_matches_jax(name):
    map_size, over, _ = REGIMES[name]
    B, ticks = (4, 3) if map_size == 128 else (8, 5)
    cfg = _fleet_cfg().replace(footprint_edge_samples=8, **over)
    sb = jmake(cfg, B, seed=9, map_size=map_size, plan_points=64,
               plan_length_range=(1.5, 2.2), lethal_threshold=0.9)
    jkw, tkw = _regime_args(name, B)
    want = jax.jit(lambda b: jsim.batch_simulate(cfg, b, ticks, **jkw))(sb)
    tsb = _from_jax(sb)
    before = tsb.costmap.data.clone()
    got = tsim.batch_simulate(_tcfg(cfg), tsb, ticks, **tkw)
    _assert_gates(got, want)
    assert torch.equal(tsb.costmap.data, before)       # never written
    if "costmap_updates" in tkw:
        np.testing.assert_allclose(got.final_costmap.data.numpy(),
                                   N(want.final_costmap.data), atol=1e-6)
        assert not torch.equal(got.final_costmap.data, before)
        assert torch.equal(got.final_costmap.flat,
                           got.final_costmap.data.reshape(B, -1))
    else:
        assert got.final_costmap is None and want.final_costmap is None
    if name == "rolling_u8_auto":
        # 128² world cells: "auto" turns the u8 source on for the view.
        assert tcm.u8_source_enabled("auto", map_size * map_size)


def test_dynamic_maps_match_jax_blob_maps():
    """The dynamic regime's map at a tick: the port's synthesis against
    the JAX package's blob_maps at the same centres, within 1e-6 (the two
    frameworks' exp differ in the last ulp)."""
    from neo_mpc_planner2_tpu.scenarios import blob_maps as jblob

    B, size = 6, 48
    cfg = _fleet_cfg()
    sb = jmake(cfg, B, seed=0, map_size=size, plan_points=64)
    c, a, v = _dyn_obstacles(B, size, 6, 3)
    dt = np.float32(cfg.control_interval)
    for t in (0, 7):
        ct = jnp.asarray(c) + (np.float32(t) * dt) * jnp.asarray(v)
        want = jblob(ct, jnp.asarray(a), size, sb.costmap.resolution[0], 0.6,
                     origin=sb.costmap.origin)
        got = tsim.dynamic_obstacle_map(_from_jax(sb).costmap,
                                        tuple(map(T, (c, a, v))), t,
                                        cfg.control_interval, 0.6, u8=True)
        np.testing.assert_allclose(got.data.numpy(), N(want), rtol=0,
                                   atol=1e-6)
        assert torch.equal(got.flat, got.data.reshape(B, -1))
        assert got.flat_u8 is not None


def test_chained_update_segments_equal_one_run():
    """Two update segments chained through (init=, init_costmap=, advanced
    centres) equal one run of their length, and neither the scenario's map
    nor the resume handle passed in is written."""
    cfg = _tcfg(_fleet_cfg().replace(footprint_edge_samples=8,
                                     w_costmap=0.5))
    B = 4
    sb = tp.make_scenario_batch(cfg, B, seed=42, map_size=48, plan_points=24,
                                plan_length_range=(0.7, 1.0), device="cpu")
    c = torch.tensor([[0.45, -0.3]]).repeat(B, 1)
    a = torch.full((B,), 0.9)
    v = torch.tensor([[0.25, 0.2]]).repeat(B, 1)
    base = sb.costmap.data.clone()
    full = tsim.batch_simulate(cfg, sb, 6, costmap_updates=(c, a, v),
                               update_cells=12)
    first = tsim.batch_simulate(cfg, sb, 3, costmap_updates=(c, a, v),
                                update_cells=12)
    handle = first.final_costmap.data.clone()
    dt = cfg.control_interval
    second = tsim.batch_simulate(
        cfg, sb, 3, costmap_updates=(c + 3 * dt * v, a, v), update_cells=12,
        init_costmap=first.final_costmap,
        init=(first.final_state, first.poses[:, -1], first.cmds[:, -1]))
    np.testing.assert_allclose(
        torch.cat([first.cmds, second.cmds], dim=1).numpy(),
        full.cmds.numpy(), atol=1e-6)
    np.testing.assert_allclose(second.final_costmap.data.numpy(),
                               full.final_costmap.data.numpy(), atol=1e-6)
    assert torch.equal(sb.costmap.data, base)
    assert torch.equal(first.final_costmap.data, handle)
    assert not torch.equal(full.final_costmap.data, base)


def _error_cases(B):
    z2, z1 = np.zeros((B, 2), np.float32), np.zeros((B,), np.float32)
    dyn = (np.zeros((B, 1, 2), np.float32), np.zeros((B, 1), np.float32),
           np.zeros((B, 1, 2), np.float32))
    return {
        "dynamic_and_window": (dict(dynamic_obstacles=dyn, window_cells=16),
                               "dynamic_obstacles and window_cells are "
                               "mutually exclusive"),
        "dynamic_and_updates": (dict(dynamic_obstacles=dyn,
                                     costmap_updates=(z2, z1, z2)),
                                "dynamic_obstacles and costmap_updates are "
                                "mutually exclusive"),
        "updates_on_a_slice": (dict(costmap_updates=(z2, z1, z2),
                                    window_cells=16, window_view=False),
                               "costmap_updates needs the zero-copy window "
                               "view"),
        "updates_too_large": (dict(costmap_updates=(z2, z1, z2),
                                   update_cells=49),
                              "update_cells exceeds the map"),
        "init_costmap_alone": (dict(init_costmap=True),
                               "init_costmap is only meaningful with "
                               "costmap_updates"),
        "init_costmap_shape": (dict(costmap_updates=(z2, z1, z2),
                                    init_costmap="small"),
                               "init_costmap shape"),
    }


@pytest.mark.parametrize("case", list(_error_cases(2)))
def test_regime_checks_raise_the_jax_messages(case):
    B = 2
    cfg = _fleet_cfg().replace(footprint_edge_samples=8)
    sb = jmake(cfg, B, seed=1, map_size=48, plan_points=64)
    kw, msg = _error_cases(B)[case]
    jkw, tkw = dict(kw), dict(kw)
    tsb = _from_jax(sb)
    for key in ("dynamic_obstacles", "costmap_updates"):
        if key in kw:
            jkw[key] = tuple(map(jnp.asarray, kw[key]))
            tkw[key] = tuple(map(T, kw[key]))
    if "init_costmap" in kw:
        jcmap, tcmap = sb.costmap, tsb.costmap
        if kw["init_costmap"] == "small":
            jcmap = jcmap.replace(data=jcmap.data[:, :40])
            tcmap = tcmap.replace(data=tcmap.data[:, :40])
        jkw["init_costmap"], tkw["init_costmap"] = jcmap, tcmap
    with pytest.raises(ValueError, match=msg) as jerr:
        jsim.batch_simulate(cfg, sb, 1, **jkw)
    with pytest.raises(ValueError) as terr:
        tsim.batch_simulate(_tcfg(cfg), tsb, 1, **tkw)
    assert str(terr.value) == str(jerr.value)


def test_dynamic_obstacles_check_the_grid_and_the_resolution():
    """A non-square grid raises with the JAX message; mixed resolutions
    raise ValueError (the JAX check reaches an undefined `np` when called
    eagerly and is skipped under jit)."""
    cfg = _tcfg(_fleet_cfg())
    sb = tp.make_scenario_batch(cfg, 2, seed=1, map_size=32, plan_points=64,
                                device="cpu")
    dyn = (torch.zeros(2, 1, 2), torch.zeros(2, 1), torch.zeros(2, 1, 2))
    wide = sb._replace(costmap=sb.costmap.replace(
        data=torch.zeros(2, 32, 40)))
    with pytest.raises(ValueError, match="dynamic_obstacles needs a square "
                                         "grid"):
        tsim.batch_simulate(cfg, wide, 1, dynamic_obstacles=dyn)
    mixed = sb._replace(costmap=sb.costmap.replace(
        resolution=torch.tensor([0.05, 0.04])))
    with pytest.raises(ValueError, match="one shared resolution"):
        tsim.batch_simulate(cfg, mixed, 1, dynamic_obstacles=dyn)


def test_product_sqp_on_a_view_matches_jax():
    """The product SQP with solver_costmap_patch > 0 on a view falls back to
    the whole-map objective read through the window, as the JAX package
    does, and matches it."""
    cfg = _product_cfg().replace(footprint_edge_samples=8)
    assert cfg.solver_costmap_patch > 0
    B, ticks = 6, 4
    sb = jmake(cfg, B, seed=5, map_size=96, plan_points=64)
    want = jax.jit(lambda b: jsim.batch_simulate(
        cfg, b, ticks, parity=False, window_cells=48))(sb)
    got = tsim.batch_simulate(_tcfg(cfg), _from_jax(sb), ticks, parity=False,
                              window_cells=48)
    _assert_gates(got, want)


def test_simulate_follow_path_on_a_rolling_window_matches_jax():
    """One robot on a plan longer than its window (the JAX package's
    rolling-window test case, cut to a 96² world and a 48-cell window)."""
    cfg = _fleet_cfg().replace(footprint_edge_samples=8)
    poses = np.stack([np.linspace(0, 2.4, 64), np.zeros(64), np.zeros(64)],
                     1).astype(np.float32)
    rng = np.random.default_rng(10)
    world = rng.uniform(0, 0.4, (96, 96)).astype(np.float32)
    jplan = mpc.Plan.create(poses, max_points=cfg.max_plan_points)
    jworld = mpc.Costmap.create(world, origin=(-1.2, -2.4), resolution=0.05)
    jfp1 = mpc.Footprint.rectangle(0.6, 0.4)
    want = jax.jit(lambda: jsim.simulate_follow_path(
        cfg, jplan, jworld, jfp1, jnp.zeros(3), jnp.zeros(3), 6,
        window_cells=48))()
    numpy = lambda t: jax.tree.map(np.asarray, t)
    got = tsim.simulate_follow_path(
        _tcfg(cfg), interop.plan_from_numpy(numpy(jplan), device="cpu"),
        interop.costmap_from_numpy(numpy(jworld), device="cpu"),
        interop.footprint_from_numpy(numpy(jfp1), device="cpu"),
        np.zeros(3), np.zeros(3), 6, window_cells=48)
    assert got.cmds.shape == (6, 3)
    np.testing.assert_allclose(got.cmds.numpy(), N(want.cmds), atol=1e-4)
    np.testing.assert_allclose(got.goal_dist.numpy(), N(want.goal_dist),
                               atol=1e-3)
    np.testing.assert_array_equal(got.lethal.numpy(), N(want.lethal))


def test_mpc_engine_step_on_a_view_matches_jax():
    """MpcEngine.step (one robot) on a view carried over from JAX through
    interop, against the JAX engine's step on the same view."""
    cfg = _fleet_cfg().replace(footprint_edge_samples=8)
    sb = jmake(cfg, 1, seed=2, map_size=96, plan_points=64)
    one = jax.tree.map(lambda x: x[0], sb)
    jview = jsim.rolling_view(one.costmap.with_flat(), one.robot_pose, 48)
    tview = interop.costmap_from_numpy(jax.tree.map(np.asarray, jview),
                                       device="cpu")
    assert tview.win_cells == 48 and tview.win_lo.dtype == torch.int32
    tone = _from_jax(one)
    jeng, teng = mpc.MpcEngine(cfg), tp.MpcEngine(_tcfg(cfg), device="cpu")
    jo = jeng.step(jeng.init_state(), one.plan, one.robot_pose,
                   one.current_vel, jview, one.footprint, 1.0 / 30)
    to = teng.step(teng.init_state(), tone.plan, tone.robot_pose,
                   tone.current_vel, tview, tone.footprint, 1.0 / 30)
    np.testing.assert_allclose(to.cmd_vel.numpy(), N(jo.cmd_vel), atol=1e-4)
    assert bool(to.lethal) == bool(jo.lethal)


@pytest.mark.parametrize("name", ["rolling", "dynamic", "updates"])
def test_the_live_map_slices_match_the_chip_smoke(name):
    """chip_smoke.py's live-map slices: the fleet point and bench.py's
    inputs (the scenario seed and size, the window, the obstacles drawn
    from default_rng(3) / default_rng(4), the update block)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B = 8
    cfg, sb, run = chip_smoke.slice_inputs(name, B, "cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_tcfg(_fleet_cfg()))
    assert run["parity"] is True and run["solver_batch"] is None
    live = chip_smoke.LIVE_MAPS[name]
    want_sb = jmake(_fleet_cfg(), B, seed=live["seed"],
                    map_size=live["map_size"], plan_points=64)
    np.testing.assert_array_equal(sb.plan.px.numpy(), N(want_sb.plan.px))
    assert sb.costmap.data.shape == (B, live["map_size"], live["map_size"])
    half = live["map_size"] * 0.05 / 2
    if name == "rolling":
        assert (live["seed"], live["map_size"]) == (2, 128)
        assert run["window_cells"] == 64
        return
    rng = np.random.default_rng({"dynamic": 3, "updates": 4}[name])
    per = (6,) if name == "dynamic" else ()
    want = (rng.uniform(-half + 0.8, half - 0.3, (B,) + per + (2,)),
            rng.uniform(0.3, 0.95, (B,) + per),
            rng.uniform(-0.25, 0.25, (B,) + per + (2,)))
    got = run["dynamic_obstacles" if name == "dynamic" else "costmap_updates"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.float32))
    assert live["map_size"] == 64 and live["seed"] == 0
    if name == "updates":
        assert run["update_cells"] == 16
