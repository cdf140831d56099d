"""The port's copy of the scipy oracle against the JAX package's, and the
MPO-700 suite gate through the port (`parity.run_suite`) on the CPU.

Both oracles are the same numpy/scipy code over configs with the same
fields, so on the same inputs `oracle_objective` and `OracleServer.solve`
must agree exactly. The suite gate is tests/test_mpo700_suite.py's
(matched fraction >= 0.9 at 1e-2 m/s, worst objective gap < 5e-4), at
n = 16 here; chip_smoke.py runs it at n = 64 with the solve on the card.
"""

import dataclasses

import numpy as np
import pytest

from neo_mpc_planner2_tpu import oracle as joracle

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import oracle as toracle
from neo_mpc_planner2_tpu_torch import parity


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw)


def _scenario(mod, rng, fp_np, exact=False):
    data = rng.uniform(0.0, 0.6, (40, 40))
    data[12:16, 20:26] = 1.0
    cm = mod.NpCostmap(data, np.array([-1.0, -1.0]), 0.05)
    return mod.NpScenario(rng.uniform(-0.2, 0.2, 3), rng.uniform(-0.5, 0.5, 3),
                          rng.uniform(-1.0, 1.0, 3), rng.uniform(-0.3, 0.3, 3),
                          fp_np, cm, switch_opt=bool(rng.integers(2)),
                          control_interval=1 / 30)


@pytest.mark.parametrize("exact", [False, True], ids=["sampled", "exact"])
def test_oracle_matches_jax_oracle(cfg, footprint_np, exact):
    jc = cfg.replace(w_footprint=2000.0, footprint_exact=exact)
    tc = _tcfg(jc)
    for seed in range(3):
        js = _scenario(joracle, np.random.default_rng(seed), footprint_np)
        ts = _scenario(toracle, np.random.default_rng(seed), footprint_np)
        x = np.random.default_rng(10 + seed).uniform(-0.5, 0.5, 9)
        assert (toracle.oracle_objective(x, ts, tc)
                == joracle.oracle_objective(x, js, jc))
        j_srv, t_srv = joracle.OracleServer(jc), toracle.OracleServer(tc)
        for _ in range(2):       # the second solve reads the carried state
            want, jd = j_srv.solve(js, 1 / 30)
            got, td = t_srv.solve(ts, 1 / 30)
            np.testing.assert_array_equal(got, want)
            assert td.keys() == jd.keys()
            for k in jd:
                np.testing.assert_array_equal(td[k], jd[k], k)


def test_suite_gate_through_the_port():
    """The north-star gate on 16 suite scenarios, the port's solve on the
    CPU: tests/test_mpo700_suite.py's thresholds."""
    report = parity.run_suite(parity.suite_config(), 16, seed=123,
                              device="cpu")
    assert report["checked"] >= 12, report
    assert report["frac"] >= parity.MATCH_FRAC_GATE, report
    assert report["worst_gap"] < parity.UNMATCHED_GAP_TOL, report
    assert report["footprint_disagree"] == 0, report
    assert report["passed"], report


def test_suite_config_matches_jax():
    import neo_mpc_planner2_tpu as mpc

    want = mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-8,
        footprint_edge_samples=8, max_plan_points=64,
        acc_x_limit=2.5, acc_y_limit=2.5, acc_theta_limit=3.0,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=0.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)
    assert parity.suite_config() == _tcfg(want)
