"""The port's ops against the JAX package's on the same numpy inputs.

Exact (assert_array_equal) unless a tolerance is stated: index math, cell
picks, gates and footprint costs must agree bit for bit; values that pass
through sin/cos/atan2 carry atol 1e-6 (the two frameworks' CPU
transcendentals may differ in the last ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops import costmap as jcm
from neo_mpc_planner2_tpu.ops import footprint as jfp
from neo_mpc_planner2_tpu.ops import objective as jobj
from neo_mpc_planner2_tpu.ops import pursuit as jpu
from neo_mpc_planner2_tpu.ops import rollout as jro
from neo_mpc_planner2_tpu.ops import se2 as jse2
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch.ops import costmap as tcm
from neo_mpc_planner2_tpu_torch.ops import footprint as tfp
from neo_mpc_planner2_tpu_torch.ops import objective as tobj
from neo_mpc_planner2_tpu_torch.ops import pursuit as tpu
from neo_mpc_planner2_tpu_torch.ops import rollout as tro
from neo_mpc_planner2_tpu_torch.ops import se2 as tse2

T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a)


def _tcfg(jc):
    """The port's twin of a JAX MpcConfig."""
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**{f: getattr(jc.compat, f)
                                for f in jc.compat.__dataclass_fields__})
    return tp.MpcConfig(compat=compat, **kw)


def _cfg():
    return mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=8, max_plan_points=32,
        acc_x_limit=2.5, acc_y_limit=2.5, acc_theta_limit=3.0,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


# --- se2 and rollout (atol 1e-6) -------------------------------------------

def test_se2_matches():
    rng = np.random.default_rng(0)
    a = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    pts = rng.uniform(-1, 1, (64, 5, 2)).astype(np.float32)
    ang = rng.uniform(-20, 20, 256).astype(np.float32)
    q = jse2.quat_from_yaw(jnp.asarray(a[:, 2]))
    pairs = [
        (jse2.se2_apply(a[:, None, :], pts), tse2.se2_apply(T(a)[:, None, :],
                                                            T(pts))),
        (jse2.se2_inverse(a), tse2.se2_inverse(T(a))),
        (jse2.se2_compose(a, b), tse2.se2_compose(T(a), T(b))),
        (jse2.world_to_body(a, b), tse2.world_to_body(T(a), T(b))),
        (jse2.body_to_world(a, b), tse2.body_to_world(T(a), T(b))),
        (jse2.wrap_angle(ang), tse2.wrap_angle(T(ang))),
        (q, tse2.quat_from_yaw(T(a[:, 2]))),
        (jse2.yaw_from_quat(q), tse2.yaw_from_quat(T(N(q)))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), N(want), rtol=0, atol=1e-6)
    # floor-mod: a negative angle wraps into [-pi, pi), never stays below.
    assert float(tse2.wrap_angle(torch.tensor(-7.0))) > -np.pi


def test_rollout_matches():
    rng = np.random.default_rng(1)
    cmd = rng.uniform(-0.7, 0.7, (32, 5, 3)).astype(np.float32)
    init = rng.uniform(-2, 2, (32, 3)).astype(np.float32)
    dt = np.float32(0.8 / 5)
    want = jax.vmap(lambda c, p: jro.rollout(c, dt, p))(cmd, init)
    got = tro.rollout(T(cmd), float(dt), T(init))
    np.testing.assert_allclose(got.numpy(), N(want), rtol=0, atol=1e-6)


# --- costmap ---------------------------------------------------------------

def _maps(rng, B=4, H=24, W=40, u8_grid=False):
    data = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    if u8_grid:
        data = (np.round(data * 255) / 255.0).astype(np.float32)
    origin = rng.uniform(-2, 0, (B, 2)).astype(np.float32)
    res = np.full((B,), 0.05, np.float32)
    jc = mpc.Costmap(data=jnp.asarray(data), origin=jnp.asarray(origin),
                     resolution=jnp.asarray(res))
    return jc, tcm.Costmap(data=T(data), origin=T(origin), resolution=T(res))


def _boundary_points(origin, res, H, W):
    """Points on cell boundaries, at cell centres, and in the
    (origin - res, origin) band below the grid, per lane."""
    k = np.arange(-2, max(H, W) + 2, dtype=np.float32)
    f = np.float32
    xs = [origin[0] + k * f(res), origin[0] + (k + f(0.5)) * f(res),
          origin[0] - f(res) * np.linspace(0.01, 0.99, 7, dtype=np.float32)]
    ys = [origin[1] + k * f(res), origin[1] + (k + f(0.5)) * f(res),
          origin[1] - f(res) * np.linspace(0.01, 0.99, 7, dtype=np.float32)]
    wx = np.concatenate(xs).astype(np.float32)
    wy = np.concatenate(ys).astype(np.float32)
    gx, gy = np.meshgrid(wx, wy)
    return gx.reshape(-1), gy.reshape(-1)


def test_world_to_map_and_cost_at_world_on_boundaries():
    rng = np.random.default_rng(2)
    jc, tc = _maps(rng)
    H, W = 24, 40
    pts = [_boundary_points(N(jc.origin[b]), 0.05, H, W) for b in range(4)]
    wx = np.stack([p[0] for p in pts])
    wy = np.stack([p[1] for p in pts])
    jmx, jmy = jax.vmap(jcm.world_to_map)(jc, wx, wy)
    tmx, tmy = tcm.world_to_map(tc, T(wx), T(wy))
    np.testing.assert_array_equal(tmx.numpy(), N(jmx))
    np.testing.assert_array_equal(tmy.numpy(), N(jmy))
    assert (N(jmx) == -1).any() and (N(jmx) >= W).any()
    np.testing.assert_array_equal(
        tcm.cost_at_world(tc, T(wx), T(wy)).numpy(),
        N(jax.vmap(jcm.cost_at_world)(jc, wx, wy)))


def test_onehot_sampling_matches_jax_onehot():
    rng = np.random.default_rng(3)
    jc, tc = _maps(rng)
    wx = rng.uniform(-2.5, 1.0, (4, 7, 9)).astype(np.float32)
    wy = rng.uniform(-2.5, 1.0, (4, 7, 9)).astype(np.float32)
    want = jax.vmap(jcm.cost_at_world_onehot)(jc, wx, wy)
    got = tcm.cost_at_world_onehot(tc, T(wx), T(wy))
    np.testing.assert_array_equal(got.numpy(), N(want))
    np.testing.assert_array_equal(
        got.numpy(), N(jax.vmap(jcm.cost_at_world)(jc, wx, wy)))


@pytest.mark.parametrize("u8", [False, True])
def test_point_sampler_and_u8_decode(u8):
    rng = np.random.default_rng(4)
    jc, tc = _maps(rng, u8_grid=True)
    jc, tc = jc.with_flat(u8=u8), tc.with_flat(u8=u8)
    if u8:
        np.testing.assert_array_equal(tc.flat_u8.numpy(), N(jc.flat_u8))
    wx = rng.uniform(-2.5, 1.0, (4, 50)).astype(np.float32)
    wy = rng.uniform(-2.5, 1.0, (4, 50)).astype(np.float32)
    want = jax.vmap(lambda c, x, y: jcm.make_point_sampler(c, 0.0, 0.0, 0)(
        x, y))(jc, wx, wy)
    got = tcm.make_point_sampler(tc, None, None, 0)(T(wx), T(wy))
    np.testing.assert_array_equal(got.numpy(), N(want))


# --- footprint -------------------------------------------------------------

@pytest.mark.parametrize("samples", [1, 2, 8, 16, 32, 33])
def test_edge_parameters_bit_equal_to_jnp_linspace(samples):
    np.testing.assert_array_equal(
        tfp.edge_parameters(samples, "cpu").numpy(),
        N(jnp.linspace(0.0, 1.0, samples)))


def _placed(fp1, poses):
    B = poses.shape[0]
    jfps = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), fp1)
    jplaced = jax.vmap(jfp.transform_footprint)(jnp.asarray(poses), jfps)
    tfps = interop.footprint_from_numpy(jax.tree.map(np.asarray, jfps),
                                        device="cpu")
    tplaced = tfp.transform_footprint(T(poses), tfps)
    return jplaced, tplaced


def _cm_pair(data, origin=(-1.6, -1.6)):
    B = data.shape[0]
    o = np.tile(np.asarray(origin, np.float32), (B, 1))
    r = np.full((B,), 0.05, np.float32)
    return (mpc.Costmap(data=jnp.asarray(data), origin=jnp.asarray(o),
                        resolution=jnp.asarray(r)),
            tcm.Costmap(data=T(data), origin=T(o), resolution=T(r)))


@pytest.mark.parametrize("mode", ["gather", "onehot"])
@pytest.mark.parametrize("case", ["plain", "lethal", "triangle", "oob"])
def test_footprint_cost_matches(mode, case):
    rng = np.random.default_rng(5)
    B = 4
    data = rng.uniform(0, 0.95, (B, 64, 128)).astype(np.float32)
    poses = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    fp1 = mpc.Footprint.rectangle(0.63, 0.41)
    if case == "lethal":
        data[:, 32, :] = 1.0
    elif case == "triangle":
        fp1 = mpc.Footprint.create([[0.21, 0.11], [-0.19, 0.11],
                                    [0.01, -0.16]], max_vertices=8)
    elif case == "oob":
        data[:] = 0.0
        poses[0] = [10.0, 10.0, 0.0]
    jc, tc = _cm_pair(data)
    jplaced, tplaced = _placed(fp1, poses)
    np.testing.assert_allclose(tplaced.vertices.numpy(),
                               N(jplaced.vertices), rtol=0, atol=1e-6)
    # Cell picks are compared on the same placed polygon.
    tplaced = tplaced.replace(vertices=T(N(jplaced.vertices)))
    want = jax.vmap(lambda c, f: jfp.footprint_cost(c, f, 16, mode))(
        jc, jplaced)
    got = tfp.footprint_cost(tc, tplaced, 16, mode)
    np.testing.assert_array_equal(got.numpy(), N(want))
    if case == "oob":
        assert float(got[0]) == 1.0 and float(got[1]) == 0.0


def test_footprint_cost_at_pose_matches():
    rng = np.random.default_rng(6)
    data = rng.uniform(0, 1, (8, 48, 48)).astype(np.float32)
    data[data > 0.9] = 1.0
    jc, tc = _cm_pair(data, origin=(-1.2, -1.2))
    poses = rng.uniform(-0.5, 0.5, (8, 3)).astype(np.float32)
    fp1 = mpc.Footprint.rectangle(0.73, 0.55)
    fps = jax.tree.map(lambda x: jnp.broadcast_to(x, (8,) + x.shape), fp1)
    want = jax.vmap(lambda c, f, p: jfp.footprint_cost_at_pose(
        c, f, p, 8, "gather"))(jc, fps, jnp.asarray(poses))
    got = tfp.footprint_cost_at_pose(
        tc, interop.footprint_from_numpy(jax.tree.map(np.asarray, fps),
                                         device="cpu"),
        T(poses), 8, "gather")
    np.testing.assert_array_equal(got.numpy(), N(want))


# --- pursuit ---------------------------------------------------------------

def _golden_batch(B=8, jitter=0.45, lethal=0.85):
    cfg = _cfg()
    sb = make_scenario_batch(cfg, B, seed=2026, map_size=48, plan_points=32,
                             lethal_threshold=lethal, pose_jitter=jitter)
    return cfg, sb, interop.scenario_batch_from_numpy(
        jax.tree.map(np.asarray, sb), device="cpu")


@pytest.mark.parametrize("slow_down", [False, True])
def test_pursuit_tick_matches(slow_down):
    cfg, sb, tb = _golden_batch()
    B = 8
    rng = np.random.default_rng(7)
    start = rng.integers(0, 12, B).astype(np.int32)
    slow = np.full(B, slow_down)
    # Spread the robots along and off their plans.
    pose = (N(sb.plan.poses)[np.arange(B), rng.integers(0, 32, B)]
            + rng.uniform(-0.2, 0.2, (B, 3))).astype(np.float32)
    want = jax.vmap(lambda p, s, sd, rp, cm, fp: jpu.pursuit_tick(
        cfg, p, s, sd, rp, cm, fp))(sb.plan, jnp.asarray(start),
                                    jnp.asarray(slow), jnp.asarray(pose),
                                    sb.costmap, sb.footprint)
    got = tpu.pursuit_tick(_tcfg(cfg), tb.plan, T(start), T(slow), T(pose),
                           tb.costmap, tb.footprint)
    for name in tpu.PursuitResult._fields:
        w, g = N(getattr(want, name)), getattr(got, name).numpy()
        if name == "carrot_pose":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# --- objective (rtol 1e-5) -------------------------------------------------

def _scenarios(cfg, sb, tb, rng):
    B = sb.robot_pose.shape[0]
    carrot = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    goal = rng.uniform(-1.5, 1.5, (B, 3)).astype(np.float32)
    js = mpc.Scenario.create(sb.robot_pose, carrot, goal, sb.current_vel,
                             sb.footprint, sb.costmap,
                             switch_opt=jnp.zeros(B, bool))
    ts = tobj.Scenario(current_pose=tb.robot_pose, carrot_pose=T(carrot),
                       goal_pose=T(goal), current_vel=tb.current_vel,
                       footprint=tb.footprint, costmap=tb.costmap,
                       switch_opt=torch.zeros(B, dtype=torch.bool))
    return js, ts


@pytest.mark.parametrize("variant", ["parity", "squared_wrapped"])
def test_objective_parity_value_and_grad(variant):
    cfg, sb, tb = _golden_batch(jitter=0.45)
    if variant == "squared_wrapped":
        cfg = cfg.replace(compat=cfg.compat.__class__(
            unsquared_control_cost=False, no_angle_wrap=False,
            buggy_odom_yaw=False, lethal_1000x=False))
    rng = np.random.default_rng(8)
    js, ts = _scenarios(cfg, sb, tb, rng)
    x = rng.uniform(-0.7, 0.7, (8, 9)).astype(np.float32)
    x[0, :3] = N(sb.current_vel[0])  # the control-cost kink: zero gradient
    jf = jobj.make_objective(cfg)
    want_v, want_g = jax.vmap(jax.value_and_grad(lambda u, s: jf(u, s)))(
        jnp.asarray(x), js)
    tf = tobj.make_objective(_tcfg(cfg))
    xt = T(x).requires_grad_(True)
    val = tf(xt, ts)
    (grad,) = torch.autograd.grad(val.sum(), xt)
    np.testing.assert_allclose(val.detach().numpy(), N(want_v), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), N(want_g), rtol=1e-5, atol=1e-6)
    assert np.isfinite(grad.numpy()).all()


# --- product half: bilinear, patch samplers, objective_product -------------

def test_bilinear_value_and_grad():
    rng = np.random.default_rng(13)
    jc, tc = _maps(rng)
    wx = rng.uniform(-2.5, 1.0, (4, 40)).astype(np.float32)
    wy = rng.uniform(-2.5, 1.0, (4, 40)).astype(np.float32)
    # Cell centres, where a weight is exactly 0.
    wx[:, :5] = N(jc.origin[:, :1]) + (np.arange(5) + 0.5) * 0.05
    total = lambda c, x, y: jnp.sum(jcm.cost_at_world_bilinear(c, x, y))
    want = jax.vmap(jcm.cost_at_world_bilinear)(jc, wx, wy)
    want_gx, want_gy = jax.vmap(jax.grad(total, argnums=(1, 2)))(jc, wx, wy)
    xt, yt = T(wx).requires_grad_(True), T(wy).requires_grad_(True)
    got = tcm.cost_at_world_bilinear(tc, xt, yt)
    gx, gy = torch.autograd.grad(got.sum(), (xt, yt))
    np.testing.assert_allclose(got.detach().numpy(), N(want), rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), N(want_gx), rtol=1e-6)
    np.testing.assert_allclose(gy.numpy(), N(want_gy), rtol=1e-6)
    assert (N(want) == 1.0).any() and (np.abs(N(want_gx)) > 0).any()


@pytest.mark.parametrize("exact", [True, False])
def test_patch_samplers_match_jax(exact):
    """The product sampler (JAX: extract_patch_onehot, picks at either
    precision, both exact on the CPU) and the parity patch of
    make_point_sampler (JAX: extract_patch) against JAX's, exactly: centres
    inside, at the edge and off the map; points inside and outside the
    window."""
    rng = np.random.default_rng(14)
    jc, tc = _maps(rng, H=40, W=40)
    org = N(jc.origin)
    cx = (org[:, 0] + np.asarray([1.0, 0.02, 1.9, 4.0])).astype(np.float32)
    cy = (org[:, 1] + np.asarray([1.0, 1.2, 1.95, -3.0])).astype(np.float32)
    px = (cx[:, None] + rng.uniform(-0.8, 0.8, (4, 60))).astype(np.float32)
    py = (cy[:, None] + rng.uniform(-0.8, 0.8, (4, 60))).astype(np.float32)
    h = 12

    def jax_reads(c, x, y, qx, qy):
        s = jcm.ProductPatchSampler(c, x, y, h, exact=exact)
        return (s.bilinear(qx, qy), s.nearest(qx, qy),
                jcm.make_point_sampler(c, x, y, h)(qx, qy))

    want = jax.vmap(jax_reads)(jc, cx, cy, px, py)
    s = tcm.ProductPatchSampler(tc, T(cx), T(cy), h)
    got = (s.bilinear(T(px), T(py)), s.nearest(T(px), T(py)),
           tcm.make_point_sampler(tc, T(cx), T(cy), h)(T(px), T(py)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), N(w))
        assert (N(w) == 1.0).any() and (N(w) < 1.0).any()


def _product_cfg():
    import dataclasses

    base = _cfg()
    return base.replace(compat=dataclasses.replace(
        base.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
        lethal_1000x=False, unsquared_control_cost=False,
        no_angle_wrap=False))


@pytest.mark.parametrize("sampler,weights", [
    (False, False), (True, False), (True, True)],
    ids=["full_map", "patch", "patch_lane_weights"])
def test_objective_product_value_and_grad(sampler, weights):
    cfg = _product_cfg()
    _, sb, tb = _golden_batch(jitter=0.45)
    rng = np.random.default_rng(15)
    js, ts = _scenarios(cfg, sb, tb, rng)
    if weights:
        w = rng.uniform(0.05, 2.0, (6, 8)).astype(np.float32)
        js = js.replace(weights=mpc.Weights(*map(jnp.asarray, w)))
        ts = ts.replace(weights=tobj.Weights(*map(T, w)))
    x = rng.uniform(-0.7, 0.7, (8, 9)).astype(np.float32)
    h = jcm.required_product_patch_halfwidth(cfg, 0.05, 0.46)
    assert h == tcm.required_product_patch_halfwidth(_tcfg(cfg), 0.05, 0.46)
    jf = jobj.make_objective(cfg, parity=False)

    def jlane(u, s):
        ps = (jcm.ProductPatchSampler(s.costmap, s.current_pose[0],
                                      s.current_pose[1], h)
              if sampler else None)
        return jf(u, s, point_sampler=ps)

    want_v, want_g = jax.vmap(jax.value_and_grad(jlane))(jnp.asarray(x), js)
    tf = tobj.make_objective(_tcfg(cfg), parity=False)
    ps = (tcm.ProductPatchSampler(ts.costmap, ts.current_pose[:, 0],
                                  ts.current_pose[:, 1], h)
          if sampler else None)
    xt = T(x).requires_grad_(True)
    val = tf(xt, ts, point_sampler=ps)
    (grad,) = torch.autograd.grad(val.sum(), xt)
    np.testing.assert_allclose(val.detach().numpy(), N(want_v), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), N(want_g), rtol=1e-5,
                               atol=1e-6)
    # Every lane's predicted footprint touches nonzero cost: the term is in
    # the value and contributes no gradient, in both frameworks.
    fp = tfp.transform_footprint(ts.current_pose, ts.footprint)
    assert (tfp.footprint_cost(ts.costmap, fp, cfg.footprint_edge_samples)
            > 0).all()
    # The candidate axis: K candidates against the (B, ...) scenario give
    # each candidate's own value, bit for bit.
    cands = T(rng.uniform(-0.7, 0.7, (8, 3, 9)).astype(np.float32))
    wave = tf(cands, ts, point_sampler=ps)
    assert wave.shape == (8, 3)
    for k in range(3):
        np.testing.assert_array_equal(
            wave[:, k].numpy(),
            tf(cands[:, k].contiguous(), ts, point_sampler=ps).numpy())
