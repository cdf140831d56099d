"""Edge-of-envelope configurations and randomized inputs through the port,
on the CPU (the twins of tests/test_edge_configs.py and tests/test_fuzz.py),
and the CPU side of K3's widened envelope.

- Degenerate weights, asymmetric bounds (against the port's scipy oracle,
  objective within 1e-4 as the JAX file holds JAX), the MPO-500 and tiny
  and non-square maps: nothing is non-finite or out of bounds.
- The fuzz: random configurations, CompatConfig subsets, degenerate
  footprints in both footprint modes (the sampled one also equal to JAX),
  plan-length bounds, the resolution guard, the server's refusal of
  non-finite input, window writes against a numpy restage, the rolling
  view against the window it stands for, and the product patch sampler
  against the full map.
- Footprints and sample counts past K3's earlier caps (16 vertices, 64
  samples an edge): 20- and 40-vertex polygons at S = 68 and 101 through
  `footprint_cost` exactly as JAX's, and closed-loop ticks of an MPO-500 on
  0.015 m and 0.01 m maps (the controller raises the samples to 68 and
  101) and of a 20-vertex footprint, within 1e-4 of JAX (the golden gate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops import footprint as jfp
from neo_mpc_planner2_tpu.scenarios import mpo500_footprint as jmpo500

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch.ops import costmap as tcm
from neo_mpc_planner2_tpu_torch.ops import footprint as tfp
from neo_mpc_planner2_tpu_torch.oracle import (NpCostmap, NpScenario,
                                               OracleServer)
from neo_mpc_planner2_tpu_torch.scenarios import mpo500_footprint
from neo_mpc_planner2_tpu_torch.serving import OptimizerSession
from neo_mpc_planner2_tpu_torch.simulation import rolling_view, rolling_window

CPU = "cpu"
ATOL = 1e-4


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw)


def _empty():
    return tp.Costmap.create(np.zeros((40, 40)), origin=(-1.0, -1.0),
                             resolution=0.05, device=CPU)


def _rect():
    return tp.Footprint.rectangle(0.6, 0.4, device=CPU)


def _solve(cfg, scen):
    solver = tp.make_sqp_solver(cfg, tp.make_objective(cfg), ftol=1e-8,
                                max_iters=300)
    return solver(torch.zeros(3 * cfg.control_steps), scen)


def _line(n, length):
    return np.stack([np.linspace(0, length, n), np.zeros(n), np.zeros(n)], 1)


def _step(cfg, cm, fp, plan, vel, pose=(0.0, 0.0, 0.0)):
    eng = tp.MpcEngine(cfg, device=CPU)
    return eng.step(eng.init_state(), plan, torch.tensor(pose),
                    torch.tensor(vel), cm, fp, 0.033)


# ---- tests/test_edge_configs.py ----------------------------------------------

def test_all_zero_weights(cfg):
    z = _tcfg(cfg).replace(w_trans=0.0, w_orient=0.0, w_control=0.0,
                           w_terminal=0.0, w_costmap=0.0, w_footprint=0.0)
    scen = tp.Scenario.create([0, 0, 0], [0.4, 0.1, 0.2], [1, 0.5, 0.3],
                              [0.3, 0, 0], _rect(), _empty())
    res = _solve(z, scen)
    assert bool(torch.isfinite(res.x).all())
    assert float(res.fun) == 0.0


def test_huge_control_weight_pins_to_velocity(cfg):
    z = _tcfg(cfg).replace(w_control=100.0)
    v = [0.2, -0.1, 0.05]
    scen = tp.Scenario.create([0, 0, 0], [0.4, 0.1, 0.2], [1, 0.5, 0.3], v,
                              _rect(), _empty())
    res = _solve(z, scen)
    np.testing.assert_allclose(res.x.numpy().reshape(-1, 3),
                               np.tile(v, (cfg.control_steps, 1)), atol=5e-3)


def test_forward_only_robot_matches_oracle(cfg, footprint_np):
    """min_vel_x = 0: the bounds hold and the solve is within 1e-4 of the
    oracle's objective."""
    c = _tcfg(cfg).replace(min_vel_x=0.0, min_vel_y=-0.2, max_vel_y=0.2,
                           opt_tolerance=1e-8)
    scen = tp.Scenario.create([0, 0, 0], [-0.5, 0.1, 0.0], [1, 0, 0],
                              [0.1, 0, 0], _rect(), _empty())
    res = _solve(c, scen)
    u = res.x.numpy().reshape(-1, 3)
    assert np.all(u[:, 0] >= -1e-6)
    assert np.all(np.abs(u[:, 1]) <= 0.2 + 1e-5)
    nps = NpScenario(np.zeros(3), np.array([-0.5, 0.1, 0.0]),
                     np.array([1.0, 0, 0]), np.array([0.1, 0, 0]),
                     footprint_np, NpCostmap(np.zeros((40, 40)),
                                             np.array([-1.0, -1.0]), 0.05))
    _, diag = OracleServer(c).solve(nps, 0.033)
    assert float(res.fun) - diag["fun"] < 1e-4


def test_mpo500_step_is_finite(cfg):
    tcfg = _tcfg(cfg)
    plan = tp.Plan.create(_line(40, 2.0), max_points=tcfg.max_plan_points,
                          device=CPU)
    out = _step(tcfg, _empty(), mpo500_footprint(device=CPU), plan,
                [0.3, 0, 0])
    assert bool(torch.isfinite(out.cmd_vel).all())


def test_tiny_map_reads_lethal_off_the_map(cfg):
    tcfg = _tcfg(cfg)
    cm = tp.Costmap.create(np.zeros((8, 8)), origin=(-0.2, -0.2),
                           resolution=0.05, device=CPU)
    plan = tp.Plan.create(_line(10, 0.3), max_points=tcfg.max_plan_points,
                          device=CPU)
    out = _step(tcfg, cm, _rect(), plan, [0.0, 0, 0])
    assert bool(out.lethal) or bool(out.collision_footprint)


def test_nonsquare_map(cfg):
    tcfg = _tcfg(cfg)
    cm = tp.Costmap.create(np.zeros((30, 90)), origin=(-0.5, -0.75),
                           resolution=0.05, device=CPU)
    plan = tp.Plan.create(_line(40, 2.0), max_points=tcfg.max_plan_points,
                          device=CPU)
    out = _step(tcfg, cm, _rect(), plan, [0.2, 0, 0])
    assert bool(torch.isfinite(out.cmd_vel).all())
    assert float(out.cmd_vel[0]) > 0


# ---- tests/test_fuzz.py ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_fuzz(seed):
    """tests/test_fuzz.py's random configurations and inputs: five ticks,
    every command finite and either zero or inside the bounds."""
    rng = np.random.default_rng(seed)
    cfg = tp.default_config().replace(
        prediction_horizon=float(rng.uniform(0.3, 1.5)),
        control_steps=int(rng.integers(1, 6)),
        opt_tolerance=float(10 ** rng.uniform(-8, -2)),
        footprint_edge_samples=8, max_plan_points=32,
        solver_max_iters=int(rng.integers(5, 40)),
        low_pass_gain=float(rng.uniform(0.05, 1.0)),
        acc_x_limit=float(rng.uniform(0.3, 4.0)),
        acc_y_limit=float(rng.uniform(0.3, 4.0)),
        acc_theta_limit=float(rng.uniform(0.3, 4.0)),
        min_vel_x=float(rng.uniform(-1.0, 0.0)),
        min_vel_y=float(rng.uniform(-1.0, -0.1)),
        min_vel_theta=float(rng.uniform(-1.5, -0.1)),
        max_vel_x=float(rng.uniform(0.2, 1.2)),
        max_vel_y=float(rng.uniform(0.1, 1.2)),
        max_vel_trans=float(rng.uniform(0.2, 1.2)),
        max_vel_theta=float(rng.uniform(0.1, 1.5)),
        w_trans=float(rng.uniform(0, 2)), w_orient=float(rng.uniform(0, 2)),
        w_control=float(rng.uniform(0, 1)),
        w_terminal=float(rng.uniform(0, 1)),
        w_costmap=float(rng.uniform(0, 2)),
        w_footprint=float(rng.choice([0.0, 100.0, 2000.0])),
        lookahead_dist_min=float(rng.uniform(0.1, 0.6)),
        lookahead_dist_max=float(rng.uniform(0.2, 0.8)),
        lookahead_dist_close_to_goal=float(rng.uniform(0.1, 0.6)),
        solver_max_backtracks=int(rng.choice([7, 10, 16])),
        solver_ls_coarse_after=int(rng.choice([0, 2])),
        solver_ls_coarse_factor=float(rng.choice([0.0625, 0.125, 0.25])),
        solver_ls_warm_alpha=bool(rng.choice([False, True])))
    eng = tp.MpcEngine(cfg, device=CPU)
    state = eng.init_state()
    data = rng.uniform(0, 1, (40, 40))
    data[rng.integers(0, 40, 15), rng.integers(0, 40, 15)] = 1.0
    cm = tp.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05,
                           device=CPU)
    n = int(rng.integers(2, 30))
    plan = tp.Plan.create(
        np.cumsum(rng.uniform(-0.1, 0.15, (n, 3)) * [1, 1, 0.5], axis=0),
        max_points=cfg.max_plan_points, device=CPU)
    fp = tp.Footprint.rectangle(float(rng.uniform(0.2, 1.0)),
                                float(rng.uniform(0.2, 0.8)), device=CPU)
    pose = torch.as_tensor(rng.uniform(-0.3, 0.3, 3), dtype=torch.float32)
    vel = torch.as_tensor(rng.uniform(-0.5, 0.5, 3), dtype=torch.float32)
    for _ in range(5):
        out = eng.step(state, plan, pose, vel, cm, fp,
                       float(rng.uniform(0.01, 1.0)))
        state = out.state
        cmd = out.cmd_vel.numpy()
        assert np.all(np.isfinite(cmd)), (seed, cmd)
        if np.any(cmd != 0.0):
            assert cfg.min_vel_x - 1e-4 <= cmd[0] <= cfg.max_vel_x + 1e-4
            assert abs(cmd[2]) <= max(abs(cfg.min_vel_theta),
                                      cfg.max_vel_theta) + 1e-4
        vel = out.cmd_vel
        pose = tp.rollout(out.cmd_vel[None, :], 0.033, pose)[0]


def _tick_once(cfg, fp, pose=(0.0, 0.0, 0.0)):
    plan = tp.Plan.create([[0, 0, 0], [0.4, 0.05, 0.1], [0.8, 0.1, 0.2]],
                          max_points=cfg.max_plan_points, device=CPU)
    return _step(cfg, _empty(), fp, plan, [0.2, 0.0, 0.0], pose)


@pytest.mark.parametrize("seed", [10, 11, 12, 13])
def test_compat_flag_combinations(seed):
    rng = np.random.default_rng(seed)
    base = tp.default_config().replace(
        max_plan_points=16, w_trans=0.82, w_orient=0.5, w_control=0.05,
        w_terminal=0.05, w_costmap=0.5, w_footprint=100.0,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7)
    flags = {f.name: bool(rng.integers(0, 2))
             for f in dataclasses.fields(type(base.compat))}
    cfg = base.replace(compat=dataclasses.replace(base.compat, **flags))
    cmd = _tick_once(cfg, _rect()).cmd_vel.numpy()
    assert np.all(np.isfinite(cmd)), (flags, cmd)
    assert np.linalg.norm(cmd[:2]) <= cfg.max_vel_trans + 1e-5, (flags, cmd)
    assert abs(cmd[2]) <= cfg.max_vel_theta + 1e-5, (flags, cmd)


DEGENERATE = [
    [[0.3, 0.0], [0.0, 0.0], [-0.3, 0.0]],                 # collinear
    [[0.3, 0.2], [0.3, 0.2], [-0.3, -0.2], [-0.3, -0.2]],  # duplicates
    [[0.2, 0.1], [-0.2, 0.1]],                             # two vertices
    [[0.15, 0.05]],                                        # one vertex
]


def test_degenerate_footprints():
    """Zero-length edges in both footprint modes: finite commands; the
    sampled mode's tick within 1e-4 of JAX's."""
    jcfg = mpc.default_config().replace(max_plan_points=16, w_footprint=100.0,
                                        w_trans=0.82, w_control=0.05)
    cfg = _tcfg(jcfg)
    jeng = mpc.MpcEngine(jcfg)
    jplan = mpc.Plan.create([[0, 0, 0], [0.4, 0.05, 0.1], [0.8, 0.1, 0.2]],
                            max_points=16)
    jcm = mpc.Costmap.create(np.zeros((40, 40)), origin=(-1.0, -1.0),
                             resolution=0.05)
    for verts in DEGENERATE:
        fp = tp.Footprint.create(verts, max_vertices=8, device=CPU)
        got = _tick_once(cfg, fp).cmd_vel.numpy()
        want = jeng.step(jeng.init_state(), jplan, jnp.zeros(3, jnp.float32),
                         jnp.asarray([0.2, 0.0, 0.0]), jcm,
                         mpc.Footprint.create(verts, max_vertices=8), 1 / 30)
        np.testing.assert_allclose(got, np.asarray(want.cmd_vel), rtol=0,
                                   atol=ATOL, err_msg=str(verts))
        out = _tick_once(cfg.replace(footprint_exact=True), fp)
        assert bool(torch.isfinite(out.cmd_vel).all()), verts


def test_plan_length_boundaries():
    pts = np.cumsum(np.full((8, 3), 0.05), axis=0)
    assert int(tp.Plan.create(pts, max_points=8, device=CPU).n_valid) == 8
    with pytest.raises(ValueError, match="> max"):
        tp.Plan.create(np.zeros((9, 3)), max_points=8, device=CPU)
    with pytest.raises(ValueError, match="zero length"):
        tp.Plan.create(np.zeros((0, 3)), max_points=8, device=CPU)


def test_costmap_resolution_guard():
    for bad in (0.0, -0.05):
        with pytest.raises(ValueError, match="resolution"):
            tp.Costmap.create(np.zeros((4, 4)), resolution=bad, device=CPU)


def _rect_points():
    return [[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2], [0.3, -0.2]]


def test_serving_rejects_nonfinite_and_bad_geometry():
    """The server refuses a non-finite cell, a zero resolution, a
    non-finite footprint and a NaN pose, and the refused request leaves the
    robot's slot as it was."""
    s = OptimizerSession(tp.default_config(), device=CPU)
    bad = np.zeros((8, 8))
    bad[2, 2] = np.nan
    assert "error" in s.handle({"op": "set_costmap", "data": bad.tolist()})
    assert "error" in s.handle({"op": "set_costmap",
                                "data": np.zeros((8, 8)).tolist(),
                                "resolution": 0.0})
    assert "error" in s.handle({"op": "set_footprint",
                                "points": [[np.inf, 0.0], [0, 0], [1, 1]]})
    s.handle({"op": "set_costmap", "data": np.zeros((40, 40)).tolist(),
              "origin": [-1, -1], "resolution": 0.05})
    s.handle({"op": "set_footprint", "points": _rect_points()})
    req = {"op": "optimizer", "carrot_pose": [0.4, 0, 0],
           "goal_pose": [1, 0, 0], "delta_t": 0.033}
    assert "error" in s.handle(dict(req, current_pose=[np.nan, 0, 0],
                                    current_vel=[0, 0, 0]))
    ok = s.handle(dict(req, current_pose=[0, 0, 0], current_vel=[0.2, 0, 0]))
    assert "output_vel" in ok and np.all(np.isfinite(ok["output_vel"]))


def test_library_nan_input_does_not_crash():
    out = _tick_once(tp.default_config().replace(max_plan_points=16),
                     _rect(), pose=(float("nan"), 0.0, 0.0))
    assert tuple(out.cmd_vel.shape) == (3,)


@pytest.mark.parametrize("seed", [20, 21])
def test_random_plan_lengths_through_serving(seed):
    rng = np.random.default_rng(seed)
    s = OptimizerSession(tp.default_config().replace(
        max_plan_points=32, w_trans=0.82, w_control=0.05), device=CPU)
    s.handle({"op": "set_costmap", "data": np.zeros((40, 40)).tolist(),
              "origin": [-1, -1], "resolution": 0.05})
    s.handle({"op": "set_footprint", "points": _rect_points()})
    for n in [1, int(rng.integers(2, 31)), 32]:
        poses = np.cumsum(rng.uniform(0, 0.08, (n, 3)), axis=0)
        assert s.handle({"op": "set_plan", "poses": poses.tolist()})["ok"]
        r = s.handle({"op": "tick", "pose": [0, 0, 0], "vel": [0, 0, 0],
                      "delta_t": 0.033})
        assert "output_vel" in r and np.all(np.isfinite(r["output_vel"]))
    assert "error" in s.handle({"op": "set_plan",
                                "poses": np.zeros((33, 3)).tolist()})


@pytest.mark.parametrize("seed", [20, 21])
def test_update_window_fuzz(seed):
    """Random shapes, blocks and corners (clamped onto the grid), with and
    without the u8 view: the write equals a numpy restage on the data and
    every cached view, bit for bit."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        H, W = int(rng.integers(9, 70)), int(rng.integers(9, 70))
        hc, wc = int(rng.integers(1, H + 1)), int(rng.integers(1, W + 1))
        u8 = bool(rng.integers(0, 2))
        data = rng.uniform(0, 1, (H, W)).astype(np.float32)
        cm = tp.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05,
                               device=CPU).with_flat(u8=u8)
        block = rng.uniform(0, 1, (hc, wc)).astype(np.float32)
        lo = (int(rng.integers(-3, W + 3)), int(rng.integers(-3, H + 3)))
        out = cm.update_window(torch.as_tensor(block), torch.tensor(lo))
        col, row = np.clip(lo[0], 0, W - wc), np.clip(lo[1], 0, H - hc)
        want = data.copy()
        want[row:row + hc, col:col + wc] = block
        np.testing.assert_array_equal(out.data.numpy(), want)
        np.testing.assert_array_equal(out.flat.numpy(), want.reshape(-1))
        if u8:
            np.testing.assert_array_equal(
                out.flat_u8.numpy(),
                np.clip(np.round(want * 255.0), 0, 255).astype(
                    np.uint8).reshape(-1))


@pytest.mark.parametrize("seed", [10, 11])
def test_rolling_view_fuzz(seed):
    """Random worlds and windows: the view samples bit-identically to the
    materialized window, at points in it, in the band outside it, below
    the origin and off the world, through every sampler and the walk."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        H, W = int(rng.integers(20, 90)), int(rng.integers(20, 90))
        res = float(rng.choice([0.025, 0.05, 0.1]))
        origin = rng.uniform(-4, 2, 2)
        cells = int(rng.integers(8, min(H, W) + 1))
        world = tp.Costmap.create(rng.random((H, W)), origin=tuple(origin),
                                  resolution=res, device=CPU).with_flat()
        span_x = (origin[0] - 2.0, origin[0] + W * res + 2.0)
        span_y = (origin[1] - 2.0, origin[1] + H * res + 2.0)
        pose = torch.tensor([rng.uniform(*span_x), rng.uniform(*span_y), 0.0],
                            dtype=torch.float32)
        win = rolling_window(world, pose, cells)
        view = rolling_view(world, pose, cells)
        wx = torch.as_tensor(rng.uniform(*span_x, 128), dtype=torch.float32)
        wy = torch.as_tensor(rng.uniform(*span_y, 128), dtype=torch.float32)
        for fn in (tcm.cost_at_world, tcm.cost_at_world_onehot,
                   tcm.cost_at_world_bilinear):
            assert torch.equal(fn(view, wx, wy), fn(win, wx, wy)), (
                fn.__name__, H, W, cells)
        assert torch.equal(
            tfp.line_cost_exact(view, wx[:16], wy[:16], wx[16:32], wy[16:32]),
            tfp.line_cost_exact(win, wx[:16], wy[:16], wx[16:32], wy[16:32]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_product_patch_sampler_fuzz(seed):
    """Inside the patch's guaranteed cover the patch reads equal the full
    map's bit for bit (with exact= either way); far outside they read
    lethal."""
    rng = np.random.default_rng(100 + seed)
    H, W = int(rng.integers(24, 96)), int(rng.integers(24, 96))
    res = float(rng.uniform(0.03, 0.1))
    ox, oy = float(rng.uniform(-2, 0)), float(rng.uniform(-2, 0))
    cm = tp.Costmap.create(rng.uniform(0, 1, (H, W)).astype(np.float32),
                           origin=(ox, oy), resolution=res, device=CPU)
    h = int(rng.integers(6, 20))
    cx = float(rng.uniform(ox - 0.3, ox + W * res + 0.3))
    cy = float(rng.uniform(oy - 0.3, oy + H * res + 0.3))
    r = (h - 2) * res
    wx = torch.as_tensor(rng.uniform(cx - r, cx + r, 128), dtype=torch.float32)
    wy = torch.as_tensor(rng.uniform(cy - r, cy + r, 128), dtype=torch.float32)
    fx = torch.as_tensor(cx + (h + 10) * res + rng.uniform(0, 1, 16),
                         dtype=torch.float32)
    fy = torch.full((16,), cy, dtype=torch.float32)
    for exact in (True, False):
        s = tcm.ProductPatchSampler(cm, torch.tensor(cx), torch.tensor(cy), h,
                                    exact=exact)
        assert torch.equal(s.bilinear(wx, wy),
                           tcm.cost_at_world_bilinear(cm, wx, wy))
        assert torch.equal(s.nearest(wx, wy), tcm.cost_at_world(cm, wx, wy))
        assert bool((s.nearest(fx, fy) == 1.0).all())


# ---- K3's widened envelope, on the CPU ---------------------------------------

def _gons(rng, P, V):
    """P regular polygons of V // 2 + 1 .. V vertices (padded to V), radius
    0.2-0.6 m, around a 3 m map; some cross its edge."""
    verts = rng.uniform(-0.1, 0.1, (P, V, 2)).astype(np.float32)
    nv = rng.integers(V // 2 + 1, V + 1, P).astype(np.int32)
    for p in range(P):
        a = rng.uniform(-np.pi, np.pi) + 2 * np.pi * np.arange(nv[p]) / nv[p]
        verts[p, :nv[p]] = (rng.uniform(-1.4, 1.4, 2)
                            + rng.uniform(0.2, 0.6) * np.stack(
                                [np.cos(a), np.sin(a)], -1))
    return verts, nv


@pytest.mark.parametrize("V,S", [(20, 32), (8, 68), (8, 101), (40, 12),
                                 (20, 100)])
def test_footprint_cost_past_the_old_caps_matches_jax(V, S):
    """footprint_cost at V vertices and S samples an edge (and in exact
    mode) equals JAX's on the same polygons, exactly: the costs are picked
    map values."""
    rng = np.random.default_rng(V * 1000 + S)
    data = rng.uniform(0, 0.95, (64, 64)).astype(np.float32)
    data[rng.integers(0, 64, 20), rng.integers(0, 64, 20)] = 1.0
    res = 0.05 if S < 68 else 3.2 / (S - 2)
    jcm = mpc.Costmap.create(data, origin=(-1.6, -1.6), resolution=res)
    cm = tp.Costmap.create(data, origin=(-1.6, -1.6), resolution=res,
                           device=CPU)
    verts, nv = _gons(rng, 24, V)
    for mode in ("gather", "exact"):
        want = jax.vmap(lambda v, n: jfp.footprint_cost(
            jcm, jfp.Footprint(v, n), S, mode))(jnp.asarray(verts),
                                                jnp.asarray(nv))
        got = tfp.footprint_cost(cm, tfp.Footprint(torch.as_tensor(verts),
                                                   torch.as_tensor(nv)),
                                 S, mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), mode)


def _jax_tick(jcfg, jcm, jfp_, plan):
    eng = mpc.MpcEngine(jcfg)
    out = eng.step(eng.init_state(), mpc.Plan.create(plan, max_points=16),
                   jnp.zeros(3, jnp.float32),
                   jnp.asarray([0.2, 0.0, 0.0], jnp.float32), jcm, jfp_,
                   1 / 30)
    return np.asarray(out.cmd_vel)


@pytest.mark.parametrize("res,samples", [(0.015, 68), (0.01, 101)])
def test_mpo500_tick_on_a_fine_map_matches_jax(cfg, res, samples):
    """An MPO-500 on a fine map: required_edge_samples gives 68 (0.015 m)
    and 101 (0.01 m) samples an edge, past K3's earlier cap of 64; one
    tick through the engine within 1e-4 of JAX's."""
    points = np.asarray([[0.495, 0.335], [-0.495, 0.335], [-0.495, -0.335],
                         [0.495, -0.335]])
    S = tfp.required_edge_samples(points, res)
    assert S == samples
    jcfg = cfg.replace(footprint_edge_samples=S, max_plan_points=16)
    n = int(round(1.5 / res))
    rng = np.random.default_rng(S)
    data = np.zeros((n, n), np.float32)
    data[rng.integers(0, n, 40), rng.integers(n // 2 + 10, n, 40)] = 0.9
    origin = (-0.75, -0.75)
    plan = _line(10, 0.6)
    want = _jax_tick(jcfg, mpc.Costmap.create(data, origin, res),
                     jmpo500(), plan)
    tcfg = _tcfg(jcfg)
    got = _step(tcfg, tp.Costmap.create(data, origin, res, device=CPU),
                mpo500_footprint(device=CPU),
                tp.Plan.create(plan, max_points=16, device=CPU), [0.2, 0, 0])
    np.testing.assert_allclose(got.cmd_vel.numpy(), want, rtol=0, atol=ATOL)


def test_twenty_vertex_footprint_tick_matches_jax(cfg):
    """A 20-gon footprint (max_footprint_vertices = 20, past K3's earlier
    cap of 16): one tick within 1e-4 of JAX's (its walk in exact mode is
    held against JAX's above)."""
    a = 2 * np.pi * np.arange(20) / 20
    points = 0.3 * np.stack([np.cos(a), np.sin(a)], -1)
    data = np.zeros((40, 40), np.float32)
    data[:, 30:] = 0.6
    plan = _line(10, 0.6)
    jcfg = cfg.replace(max_footprint_vertices=20, max_plan_points=16,
                       footprint_edge_samples=16)
    want = _jax_tick(jcfg, mpc.Costmap.create(data, (-1.0, -1.0), 0.05),
                     mpc.Footprint.create(points, max_vertices=20), plan)
    got = _step(_tcfg(jcfg),
                tp.Costmap.create(data, (-1.0, -1.0), 0.05, device=CPU),
                tp.Footprint.create(points, max_vertices=20, device=CPU),
                tp.Plan.create(plan, max_points=16, device=CPU), [0.2, 0, 0])
    np.testing.assert_allclose(got.cmd_vel.numpy(), want, rtol=0, atol=ATOL)
