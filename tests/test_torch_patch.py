"""The JAX package's costmap patch names in the port (`CostmapPatch`,
`extract_patch`, `extract_patch_onehot`, `patch_cost_at_cells`,
`patch_cost_at_world`, `patch_cost_at_world_bilinear`, the `*_onehot`
aliases) and `se2.rot2`: the port's twin of tests/test_patch.py, and each
name against the JAX package's on the same numpy inputs, exactly (a patch
holds picked map values; the reads are picks).

The port's solver reads through a patch's bounds rectangle
(ops.costmap.patch_bounds) and never builds a window; these names give
callers of the JAX package's public API the window itself, as gathers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops import costmap as jcm
from neo_mpc_planner2_tpu.ops import se2 as jse2

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch.ops import costmap as tcm
from neo_mpc_planner2_tpu_torch.ops import se2 as tse2


def _maps(seed=0, size=48, origin=(-1.2, -1.2)):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, 1, (size, size)).astype(np.float32)
    return (mpc.Costmap.create(data, origin=origin, resolution=0.05),
            tp.Costmap.create(data, origin=origin, resolution=0.05,
                              device="cpu"))


# --- the twin of tests/test_patch.py -----------------------------------------

def test_bit_identical_within_bound():
    """Centres anywhere, off the map included; samples within the
    physics reach (h - 1 cells): the patch read equals the full-map read."""
    _, cm = _maps()
    rng = np.random.default_rng(0)
    h = 12
    for _ in range(50):
        cx, cy = rng.uniform(-2.0, 2.0, 2)
        patch = tcm.extract_patch(cm, torch.tensor(cx, dtype=torch.float32),
                                  torch.tensor(cy, dtype=torch.float32), h)
        r = (h - 1) * 0.05
        pts = rng.uniform(-r, r, (16, 2)) + [cx, cy]
        wx = torch.as_tensor(pts[:, 0], dtype=torch.float32)
        wy = torch.as_tensor(pts[:, 1], dtype=torch.float32)
        got = tcm.patch_cost_at_world(cm, patch, wx, wy)
        assert torch.equal(got, tcm.cost_at_world(cm, wx, wy))


def test_lethal_preserved_exactly():
    data = np.zeros((32, 32), np.float32)
    data[10, 10] = 1.0
    cm = tp.Costmap.create(data, origin=(0.0, 0.0), resolution=0.1,
                           device="cpu")
    patch = tcm.extract_patch(cm, torch.tensor(1.0), torch.tensor(1.0), 8)
    v = tcm.patch_cost_at_world(cm, patch, torch.tensor([1.05]),
                                torch.tensor([1.05]))
    assert float(v[0]) == 1.0


def test_required_halfwidth(cfg):
    # sqrt(0.7² + 0.7²) * 0.8 / 0.05 = 15.84 -> 16 + 1
    assert tcm.required_patch_halfwidth(cfg, 0.05) == 17


# --- against the JAX package ------------------------------------------------

CENTRES = [(0.0, 0.0), (-1.19, -1.19), (1.1, 0.3), (5.0, 5.0), (-1.23, 0.1),
           (0.4, -0.6), (-3.0, 0.2)]


@pytest.mark.parametrize("extractor", ["extract_patch",
                                       "extract_patch_onehot"])
def test_patches_match_jax(extractor):
    """Each extractor's window and corner, for centres inside, at the
    edges, in the band below the origin and off the map, batched over the
    centres (the port's leading dims) against JAX's, one centre at a
    time."""
    jc, tc = _maps(seed=1)
    h = 9
    cx = np.asarray([c[0] for c in CENTRES], np.float32)
    cy = np.asarray([c[1] for c in CENTRES], np.float32)
    B = len(CENTRES)
    tcb = tp.Costmap(data=tc.data.expand(B, 48, 48),
                     origin=tc.origin.expand(B, 2),
                     resolution=tc.resolution.expand(B))
    got = getattr(tcm, extractor)(tcb, torch.as_tensor(cx),
                                  torch.as_tensor(cy), h)
    assert isinstance(got, tcm.CostmapPatch)
    assert got.data.shape == (B, 2 * h + 1, 2 * h + 1)
    assert got.cell0.dtype == torch.int32
    for b in range(B):
        want = getattr(jcm, extractor)(jc, jnp.float32(cx[b]),
                                       jnp.float32(cy[b]), h)
        np.testing.assert_array_equal(got.data[b].numpy(),
                                      np.asarray(want.data))
        np.testing.assert_array_equal(got.cell0[b].numpy(),
                                      np.asarray(want.cell0))


@pytest.mark.parametrize("exact", [True, False])
def test_patch_reads_match_jax(exact):
    """patch_cost_at_cells (cells inside, outside and around the patch),
    patch_cost_at_world and patch_cost_at_world_bilinear against JAX's, on
    both extractors' patches."""
    jc, tc = _maps(seed=2)
    rng = np.random.default_rng(3)
    h = 7
    for extractor in ("extract_patch", "extract_patch_onehot"):
        for cx, cy in CENTRES:
            jp = getattr(jcm, extractor)(jc, jnp.float32(cx),
                                         jnp.float32(cy), h)
            tpch = getattr(tcm, extractor)(tc, torch.tensor(cx),
                                           torch.tensor(cy), h)
            mx = rng.integers(-30, 80, 64).astype(np.int32)
            my = rng.integers(-30, 80, 64).astype(np.int32)
            np.testing.assert_array_equal(
                tcm.patch_cost_at_cells(tpch, torch.as_tensor(mx),
                                        torch.as_tensor(my),
                                        exact=exact).numpy(),
                np.asarray(jcm.patch_cost_at_cells(jp, mx, my, exact=True)))
            pts = (rng.uniform(-0.5, 0.5, (32, 2)) + [cx, cy]).astype(
                np.float32)
            wx, wy = pts[:, 0], pts[:, 1]
            tw, tv = torch.as_tensor(wx), torch.as_tensor(wy)
            np.testing.assert_array_equal(
                tcm.patch_cost_at_world(tc, tpch, tw, tv).numpy(),
                np.asarray(jcm.patch_cost_at_world(jc, jp, wx, wy)))
            np.testing.assert_array_equal(
                tcm.patch_cost_at_world_bilinear(tc, tpch, tw, tv,
                                                 exact=exact).numpy(),
                np.asarray(jcm.patch_cost_at_world_bilinear(jc, jp, wx, wy)))


def test_onehot_aliases_match_jax():
    """cost_at_cells_onehot and extract_window_onehot (the JAX package's
    one-hot contractions) are the port's gathers: the same picks, the
    window's corner canonicalized as lax.dynamic_slice does."""
    jc, tc = _maps(seed=4)
    rng = np.random.default_rng(5)
    mx = rng.integers(-5, 55, 200).astype(np.int32)
    my = rng.integers(-5, 55, 200).astype(np.int32)
    np.testing.assert_array_equal(
        tcm.cost_at_cells_onehot(tc, torch.as_tensor(mx),
                                 torch.as_tensor(my)).numpy(),
        np.asarray(jcm.cost_at_cells_onehot(jc, mx, my)))
    for row, col in ((0, 0), (5, 40), (-3, 7), (47, 47), (30, -50)):
        np.testing.assert_array_equal(
            tcm.extract_window_onehot(tc.data, row, col, 16, 12).numpy(),
            np.asarray(jcm.extract_window_onehot(jc.data, row, col, 16, 12)))


def test_rot2_matches_jax():
    theta = np.random.default_rng(6).uniform(-7, 7, (4, 5)).astype(
        np.float32)
    got = tse2.rot2(torch.as_tensor(theta))
    assert got.shape == (4, 5, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jse2.rot2(theta)),
                               rtol=0, atol=1e-7)


def test_patched_solve_identical_through_the_port(cfg):
    """tests/test_patch.py's TestPatchedSolveParity through the port: the
    solve with solver_costmap_patch = required_patch_halfwidth equals the
    full-map solve (x, commands and iterations), 8 lanes, and a robot off
    the map reads lethal on both paths."""
    h = tcm.required_patch_halfwidth(cfg, 0.05)
    from test_torch_horizons import _tcfg

    base, patched = _tcfg(cfg), _tcfg(cfg.replace(solver_costmap_patch=h))
    outs = []
    for c in (base, patched):
        sb = tp.make_scenario_batch(c, 8, seed=5, map_size=48, plan_points=24,
                                    lethal_threshold=0.8, pose_jitter=0.4,
                                    device="cpu")
        step = tp.make_batched_controller_step(c)
        outs.append(step(sb.state, sb.plan, sb.robot_pose, sb.current_vel,
                         sb.costmap, sb.footprint, sb.delta_t))
    for name in ("raw_solution", "cmd_vel", "solver_iters"):
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name))
    # Off the map: every sample lethal through either path.
    cm = tp.Costmap.create(np.zeros((1, 40, 40), np.float32),
                           origin=[[-1.0, -1.0]], resolution=[0.05],
                           device="cpu")
    patch = tcm.extract_patch(cm, torch.tensor([5.0]), torch.tensor([5.0]), h)
    wx = torch.full((1, 9), 5.0) + torch.linspace(-0.3, 0.3, 9)
    assert bool((tcm.patch_cost_at_world(cm, patch, wx, wx) == 1.0).all())
    assert bool((tcm.cost_at_world(cm, wx, wx) == 1.0).all())
