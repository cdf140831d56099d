"""The yardstick's arithmetic on small inputs: the copied roofline counts,
the event readers on a synthetic trace, the window's statistics, and the
client's carrot rule and plant."""

import math

import numpy as np
import pytest

from portbench.lib import bounds, pursuit, stats, trace
from portbench.lib import cells


@pytest.mark.parametrize("B,m,iters", [(4096, 9, 60), (1, 3, 10),
                                       (64, 36, 60)])
def test_qp_admm_work_is_the_ports(B, m, iters):
    from neo_mpc_planner2_tpu_torch.kernels import bounds as port

    assert bounds.qp_admm_work(B, m, iters) == port.qp_admm_work(B, m, iters)
    assert bounds.bound(1e9, 1e6) == port.bound(1e9, 1e6)


def test_bound_picks_the_larger_time():
    b = bounds.bound(67e9, 1.0)
    assert b["bound_by"] == "operations" and math.isclose(b["bound_ms"], 1.0)
    b = bounds.bound(1.0, 3.35e9)
    assert b["bound_by"] == "bytes" and math.isclose(b["bound_ms"], 1.0)


def _events():
    """Two ticks on one thread: an op that launches two kernels, a sync,
    and a copy; the device runs 10 + 10 µs of kernels and a 5 µs copy
    inside a 100 µs window."""
    ev = []
    add = lambda **e: ev.append({"ph": "X", "tid": 1, **e})
    add(cat="cpu_op", name="aten::mul", ts=0.0, dur=30.0)
    add(cat="cuda_runtime", name="cudaLaunchKernel", ts=5.0, dur=2.0,
        args={"correlation": 1})
    add(cat="cuda_runtime", name="cudaLaunchKernel", ts=15.0, dur=2.0,
        args={"correlation": 2})
    add(cat="cpu_op", name="aten::add", ts=40.0, dur=20.0)
    add(cat="cuda_driver", name="cuLaunchKernel", ts=45.0, dur=2.0,
        args={"correlation": 3})
    add(cat="cuda_runtime", name="cudaStreamSynchronize", ts=70.0, dur=5.0)
    add(cat="cuda_runtime", name="cudaMemcpyAsync", ts=80.0, dur=5.0)
    add(cat="kernel", name="qp_admm_kernel<9>", ts=10.0, dur=10.0,
        args={"correlation": 1})
    add(cat="kernel", name="mul_kernel", ts=15.0, dur=10.0,
        args={"correlation": 2})
    add(cat="kernel", name="add_kernel", ts=60.0, dur=5.0,
        args={"correlation": 3})
    add(cat="gpu_memcpy", name="Memcpy DtoH", ts=95.0, dur=5.0)
    add(cat="cpu_op", name="tail", ts=0.0, dur=100.0, tid=2)
    return ev


def test_launch_sync_and_busy_readers():
    ev = _events()
    assert trace.count_launches(ev) == 3
    assert trace.count_syncs(ev) == 1
    assert trace.busy_us(ev) == 15.0 + 5.0 + 5.0
    assert trace.kernel_durations_us(ev, "qp_admm") == [10.0]
    ops = trace.launch_ops(ev)
    assert ops == {1: "aten::mul", 2: "aten::mul", 3: "aten::add"}


def test_breakdown_names_the_gaps_by_host_op():
    b = trace.breakdown(_events())
    assert b["device_ops"][0][0] in ("qp_admm_kernel<9>", "mul_kernel")
    gaps = dict(b["idle_gaps"])
    assert math.isclose(gaps["aten::add"], 35e-6)
    assert math.isclose(gaps["(device op without a launch)"], 30e-6)


def test_layer_readers_on_the_synthetic_trace():
    ctx = {"kind": "fleet", "events": _events(), "ticks": 2,
           "window_s": 100e-6, "lanes": 4096, "m": 9, "qp_iters": 60,
           "mean_iters": 6.5}
    assert cells.reader("engine.launches_per_tick")(ctx) == 1.5
    assert cells.reader("engine.syncs_per_tick")(ctx) == 0.5
    assert cells.reader("sqp.mean_iters")(ctx) == 6.5
    assert math.isclose(cells.reader("device.idle_share.fleet")(ctx), 75.0)
    least = bounds.qp_admm_work(4096, 9, 60)["bound_ms"] * 1e3
    assert math.isclose(cells.reader("qp_admm_roofline")(ctx),
                        100 * least / 10.0)
    assert cells.reader("serving.launches_per_request")(ctx) is None
    serve = dict(ctx, kind="serve", requests=3)
    assert cells.reader("serving.launches_per_request")(serve) == 1.0
    assert math.isclose(cells.reader("device.idle_share.serve")(serve), 75.0)
    assert cells.reader("engine.launches_per_tick")(serve) is None
    empty = dict(ctx, events=None)
    assert cells.reader("qp_admm_roofline")(empty) is None
    assert cells.reader("device.idle_share.fleet")(empty) is None


def test_rate_counts_every_whole_segment_over_the_window():
    assert stats.solves_per_s(4096, 30, 7, 32.0) == 4096 * 30 * 7 / 32.0


def test_percentiles_are_over_every_request():
    lat = np.arange(1, 201) / 1e3            # 1 .. 200 ms
    got = stats.latency_ms(lat)
    assert math.isclose(got["request_ms_p50"], 100.5)
    assert math.isclose(got["request_ms_p95"], 190.05)


def test_carrot_on_a_straight_plan():
    plan = np.stack([np.linspace(0, 2, 41), np.zeros(41), np.zeros(41)], -1)
    pose = np.array([0.5, 0.1, 0.0])
    carrot, start, closer = pursuit.carrot(plan, 0, pose, 1.6, 0.4)
    # The closest pose is x = 0.5; the first at >= 0.4 m is x = 0.9 (0.41 m
    # away with the 0.1 m offset).
    assert start == 10 and not closer
    np.testing.assert_allclose(carrot, [0.4, -0.1, 0.0], atol=1e-12)
    # Past the half extent the window ends; near the goal it is closer.
    carrot, start, closer = pursuit.carrot(plan, 10, np.array([1.8, 0, 0]),
                                           1.6, 0.4)
    assert closer and start == 36
    np.testing.assert_allclose(carrot, [0.2, 0.0, 0.0], atol=1e-12)


def test_plant_turns_first_then_moves():
    p = pursuit.plant(np.zeros(3), np.array([1.0, 0.0, math.pi / 2]), 1.0)
    np.testing.assert_allclose(p, [0.0, 1.0, math.pi / 2], atol=1e-12)


def test_the_serve_judge_splits_requests_where_the_goal_changes():
    from portbench.lib import judge

    g = lambda x: {"goal_pose": [x, 0.0, 0.0]}
    reqs = [g(1.0), g(1.0), g(2.0), g(2.0), g(2.0), g(1.0)]
    assert judge.chains(reqs) == [(0, 2), (2, 5), (5, 6)]


def test_verdict_holds_every_number_to_its_limit():
    from portbench.lib import judge

    ok, checks = judge.verdict({"a": 0.05}, 0, {"a": 0.1})
    assert ok and checks == {"a": {"value": 0.05, "limit": 0.1},
                             "failed": {"value": 0, "limit": 0}}
    assert not judge.verdict({"a": float("nan")}, 0, {"a": 0.1})[0]
    assert not judge.verdict({"a": 0.05}, 1, {"a": 0.1})[0]
