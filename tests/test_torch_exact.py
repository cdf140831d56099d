"""The port's exact footprint mode (the Amanatides-Woo cell walk) against
the JAX package's.

- The walk (`line_cost_exact`) equals JAX's, op for op, exactly on random
  segments and on the edge cases of tests/test_footprint_exact.py
  (axis-aligned, zero-length and diagonal segments, segments that end on
  cell boundaries or off the map), on a whole grid and through a
  rolling-window view.
- `footprint_cost(mode="exact")` equals JAX's exactly on placed polygons,
  one map a lane.
- `batch_simulate` with `footprint_exact=True` matches JAX's within the
  golden gate (commands atol 1e-4), in parity and in product mode; the
  product run takes the patch sampler, whose footprint reads exact mode
  drops (objective.py: the walk reads the whole map).

On the CPU the port runs the plain walk; K3's walk mode is held to it on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops import footprint as jfp
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake
from neo_mpc_planner2_tpu.simulation import batch_simulate as jsimulate

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch.ops import footprint as tfp
from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

RES = 0.05
ORIGIN = (-1.0, -0.8)


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**{f: getattr(jc.compat, f)
                                for f in jc.compat.__dataclass_fields__})
    return tp.MpcConfig(compat=compat, **kw)


def _map(rng, H=36, W=40):
    data = rng.uniform(0.0, 0.9, (H, W)).astype(np.float32)
    data[rng.integers(0, H, 6), rng.integers(0, W, 6)] = 1.0
    return data


def _maps(data, view):
    """The JAX and the port's costmap of `data`, or a 24-cell view of it at
    (col, row) = (7, 5)."""
    jc = mpc.Costmap.create(data, origin=ORIGIN, resolution=RES)
    tc = tp.Costmap.create(data, origin=ORIGIN, resolution=RES, device="cpu")
    if view:
        lo = np.array([7, 5], np.int32)
        jc = jc.replace(win_lo=jnp.asarray(lo), win_cells=24)
        tc = tc.replace(win_lo=torch.as_tensor(lo), win_cells=24)
    return jc, tc


def _segments(rng, n=400):
    """(n + edge cases, 4) float32 segments x0, y0, x1, y1: random ones over
    and beyond the map, axis-aligned, zero-length, diagonal, ending on cell
    boundaries, and off the map."""
    H, W = 36, 40
    ox, oy = ORIGIN
    lo = np.array([ox - 0.3, oy - 0.3, ox - 0.3, oy - 0.3])
    hi = np.array([ox + W * RES + 0.3, oy + H * RES + 0.3] * 2)
    seg = rng.uniform(lo, hi, (n, 4))
    k = rng.integers(0, 36, (60, 4)).astype(np.float64)
    on_grid = np.asarray(ORIGIN * 2) + k * RES        # cell corners
    cx, cy = ox + 10.5 * RES, oy + 12.5 * RES          # a cell centre
    cases = [
        [cx, cy, cx, cy],                              # zero length
        [cx, cy, cx + 0.6, cy], [cx, cy, cx - 0.6, cy],  # horizontal
        [cx, cy, cx, cy + 0.6], [cx, cy, cx, cy - 0.6],  # vertical
        [cx, cy, cx + 0.5, cy + 0.5], [cx, cy, cx - 0.4, cy + 0.4],
        [ox, oy, ox + 1.0, oy + 1.0],                  # through corners
        [ox + 0.5, oy + 0.5, ox + 2.5, oy + 0.5],      # leaves the map
        [ox - 0.5, oy + 0.5, ox + 0.5, oy + 0.5],      # starts off it
        [ox - 0.5, oy - 0.5, ox - 0.1, oy - 0.2],      # wholly off it
        [ox - 0.02, oy + 0.3, ox + 0.3, oy + 0.3],     # in the -1 band
    ]
    return np.concatenate([seg, on_grid, cases]).astype(np.float32)


@pytest.mark.parametrize("view", [False, True], ids=["grid", "view"])
def test_walk_matches_jax_line_cost_exact(view):
    rng = np.random.default_rng(0)
    jc, tc = _maps(_map(rng), view)
    seg = _segments(rng)
    # JAX's walk op by op, as written (eagerly): under jit, XLA on the CPU
    # contracts the boundary o + k·res into one FMA (and, for a map closed
    # over as a constant, divides by res as a multiply by its reciprocal),
    # which moves a segment that starts on a cell boundary by one crossing.
    # The port rounds every op as the expression is written, as K3's
    # sampled mode does; the closed loop below holds it to jitted JAX.
    want = np.asarray(jfp.line_cost_exact(
        jc, seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3]))
    s = torch.as_tensor(seg)
    got = tfp.line_cost_exact(tc, s[:, 0], s[:, 1], s[:, 2], s[:, 3])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 1.0).any() and (want < 1.0).any()


def test_walk_degenerate_and_axis_aligned():
    """tests/test_footprint_exact.py's cases on the port."""
    data = np.zeros((10, 10), np.float32)
    data[5, 5] = 0.7
    cm = tp.Costmap.create(data, origin=(0.0, 0.0), resolution=0.1,
                           device="cpu")
    walk = lambda *p: float(tfp.line_cost_exact(cm, *p))
    assert walk(0.55, 0.55, 0.55, 0.55) == pytest.approx(0.7)
    assert walk(0.05, 0.55, 0.95, 0.55) == pytest.approx(0.7)
    assert walk(0.25, 0.05, 0.25, 0.95) == 0.0
    assert walk(0.5, 0.5, 1.5, 0.5) == 1.0
    assert walk(-0.5, 0.5, 0.5, 0.5) == 1.0


def _polygons(rng, B, R):
    """(B, R, 8, 2) placed polygons of three kinds in turn: MPO-700-sized
    rectangles, long-edge boxes, padded triangles; and the valid counts."""
    n = B * R
    centre = rng.uniform(-0.9, 1.3, (n, 2))
    yaw = rng.uniform(-np.pi, np.pi, n)
    half = np.where((np.arange(n) % 3 == 1)[:, None], [0.6, 0.3],
                    [0.365, 0.275])
    box = np.stack([half * [1, 1], half * [-1, 1], half * [-1, -1],
                    half * [1, -1]], 1)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    quad = centre[:, None] + np.stack(
        [box[..., 0] * c - box[..., 1] * s, box[..., 0] * s + box[..., 1] * c],
        -1)
    verts = rng.uniform(-5, 5, (n, 8, 2))
    verts[:, :4] = quad
    nv = np.where(np.arange(n) % 3 == 2, 3, 4).astype(np.int32)
    return (verts.reshape(B, R, 8, 2).astype(np.float32),
            nv.reshape(B, R))


@pytest.mark.parametrize("view", [False, True], ids=["grid", "view"])
def test_footprint_cost_exact_matches_jax(view):
    rng = np.random.default_rng(1)
    B, R = 5, 7
    data = np.stack([_map(rng) for _ in range(B)])
    verts, nv = _polygons(rng, B, R)
    jc = mpc.Costmap.create(data, origin=ORIGIN, resolution=RES)
    jc = jc.replace(origin=jnp.broadcast_to(jc.origin, (B, 2)),
                    resolution=jnp.full((B,), RES, jnp.float32))
    tc = interop.costmap_from_numpy(jax.tree.map(np.asarray, jc),
                                    device="cpu")
    if view:
        lo = rng.integers(0, 12, (B, 2)).astype(np.int32)
        jc = jc.replace(win_lo=jnp.asarray(lo), win_cells=24)
        tc = tc.replace(win_lo=torch.as_tensor(lo), win_cells=24)

    def lane(c, v, n):
        return jax.vmap(lambda vv, nn: jfp.footprint_cost(
            c, jfp.Footprint(vertices=vv, n_valid=nn), mode="exact"))(v, n)

    want = jax.jit(jax.vmap(lane))(jc, jnp.asarray(verts), jnp.asarray(nv))
    got = tfp.footprint_cost(tc, tfp.Footprint(torch.as_tensor(verts),
                                               torch.as_tensor(nv)),
                             mode="exact")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exact_mode_takes_no_bounds():
    cm = tp.Costmap.create(np.zeros((2, 8, 8)), origin=[[0.0, 0.0]] * 2,
                           resolution=[0.1, 0.1], device="cpu")
    fp = tp.Footprint.rectangle(0.3, 0.2, device="cpu")
    fp = fp.replace(vertices=fp.vertices.expand(2, 8, 2),
                    n_valid=fp.n_valid.expand(2))
    with pytest.raises(ValueError, match="no bounds"):
        tfp.footprint_cost(cm, fp, mode="exact",
                           bounds=torch.zeros(2, 4, dtype=torch.int32))


def test_required_edge_samples_matches_jax():
    for pts, res in (([[0.0, 0.0], [1.8, 0.0], [1.8, 0.5], [0.0, 0.5]], 0.025),
                     ([[0, 0], [0.1, 0], [0, 0.1]], 0.05),
                     ([[0.365, 0.275], [-0.365, 0.275], [-0.365, -0.275],
                       [0.365, -0.275]], 0.05)):
        assert (tfp.required_edge_samples(pts, res)
                == jfp.required_edge_samples(pts, res))


def _exact_cfg(product: bool):
    """The fleet benchmark's overrides (tests/test_torch_slice.py) with
    footprint_exact; product: bench.py's product-SQP flips and the patch
    sampler as well."""
    from neo_mpc_planner2_tpu.ops.costmap import (
        required_product_patch_halfwidth)

    cfg = mpc.fleet_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        max_plan_points=32, solver_compact_adaptive=False,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0, solver_costmap_u8=False,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4, footprint_exact=True)
    if not product:
        return cfg
    cfg = cfg.replace(
        parallel_line_search=True, solver_ls_quad_interp=False,
        solver_patch_exact_picks=False,
        compat=dataclasses.replace(
            cfg.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
            lethal_1000x=False, unsquared_control_cost=False,
            no_angle_wrap=False))
    return cfg.replace(solver_costmap_patch=required_product_patch_halfwidth(
        cfg, 0.05, 0.46))


@pytest.mark.parametrize("product", [False, True], ids=["parity", "product"])
def test_exact_closed_loop_matches_jax(product):
    cfg = _exact_cfg(product)
    sb = jmake(cfg, 6, seed=4, map_size=32, plan_points=32,
               lethal_threshold=0.8)
    want = jax.jit(lambda: jsimulate(cfg, sb, 5, parity=not product))()
    got = batch_simulate(_tcfg(cfg), interop.scenario_batch_from_numpy(
        jax.tree.map(np.asarray, sb), device="cpu"), 5, parity=not product)
    np.testing.assert_allclose(got.cmds.numpy(), np.asarray(want.cmds),
                               atol=1e-4)
    np.testing.assert_array_equal(got.lethal.numpy(), np.asarray(want.lethal))
    np.testing.assert_array_equal(got.collisions.numpy(),
                                  np.asarray(want.collisions))
    assert np.abs(got.cmds.numpy()).max() > 0.0
