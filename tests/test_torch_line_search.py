"""The parity line search's kernel (csrc/parity_line_search.cu), on the
CPU: where the solver engages it, what it is handed, and its source's
arithmetic.

- The rule (`sqp._fused_line_search_rule`) is a function of what the code
  can observe: CUDA operands, the sequential branch, the parity objective,
  its flat gather. CPU operands, the product objective, the fused wave,
  the K-wide wave, the parity patch, a rolling-window view and a horizon
  past the kernel's cap keep the masked loop; on the CPU no solve builds
  the kernel, so the sequential branch's CPU tests run the masked loop as
  before.
- The per-lane table holds each lane's poses, velocity, weights (per lane
  or the configuration's), cone radius, footprint term, map origin and
  resolution in `binding.PARITY_LS_LANE_COLUMNS` order, and the launcher
  hands the C function its arguments in order (a stub library).
- The kernel's source, built for the CPU with g++ (each CUDA intrinsic a
  host function with the same rounding), run through the solver's own
  plumbing on a closed loop, takes the masked loop's steps: the same
  acceptances, the two-phase factor's alphas exactly, the objective within
  1e-6. Bit-equality is the card's test (tests/test_torch_line_search_cuda
  .py): on the CPU, PyTorch's sine, cosine, sums and scalar divisions
  round otherwise than on the card and than this build.
"""

import ctypes
import dataclasses
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import sqp
from neo_mpc_planner2_tpu_torch.kernels import binding, build
from neo_mpc_planner2_tpu_torch.ops.costmap import Costmap
from neo_mpc_planner2_tpu_torch.ops.objective import (Limits, Weights,
                                                       make_objective)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CUDA = torch.device("cuda")


def _parity():
    return dataclasses.replace(tp.fleet_config(), opt_tolerance=1e-3)


def _map(win_cells=None, dtype=torch.float32):
    cm = Costmap.create(torch.zeros(2, 32, 32), origin=torch.zeros(2, 2),
                        resolution=torch.full((2,), 0.05), device="cpu")
    cm = cm.replace(data=cm.data.to(dtype))
    if win_cells is not None:
        cm = cm.replace(win_lo=torch.zeros(2, 2, dtype=torch.int32),
                        win_cells=win_cells)
    return cm


# (case, config change, objective's parity, map's window, device, fused
# wave, engaged)
RULE_CASES = [
    ("parity_sequential_flat_cuda", {}, True, None, CUDA, False, True),
    ("two_phase", dict(solver_ls_quad_interp=False), True, None, CUDA,
     False, True),
    ("quirks_off", dict(compat=tp.CompatConfig(
        buggy_odom_yaw=False, footprint_alias_noop=False,
        lethal_1000x=False, unsquared_control_cost=False,
        no_angle_wrap=False)), True, None, CUDA, False, True),
    ("u8_source", dict(solver_costmap_u8=True), True, None, CUDA, False,
     True),
    ("cpu_operands", {}, True, None, torch.device("cpu"), False, False),
    ("product_objective", dict(solver_ls_quad_interp=False), False, None,
     CUDA, False, False),
    ("parallel_line_search", dict(solver_ls_quad_interp=False), True, None,
     CUDA, True, False),
    ("k_wide_wave", dict(solver_ls_quad_interp=False, solver_ls_wave=2),
     True, None, CUDA, False, False),
    ("parity_patch", dict(solver_costmap_patch=8), True, None, CUDA, False,
     False),
    ("rolling_view", {}, True, 16, CUDA, False, False),
    ("past_the_cap", dict(control_steps=binding.PARITY_LS_MAX_STEPS + 1),
     True, None, CUDA, False, False),
]


@pytest.mark.parametrize("case,change,parity,win,device,wave,engaged",
                         RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_the_rule_engages_the_kernel_only_where_it_holds(
        case, change, parity, win, device, wave, engaged):
    cfg = _parity().replace(**change)
    objective = make_objective(cfg, parity=parity)
    assert sqp._fused_line_search_rule(cfg, objective, _map(win), device,
                                       wave) is engaged


def test_an_objective_that_is_not_make_objectives_keeps_the_loop():
    cfg = _parity()
    plain = lambda u, scen, fp_term=None, point_sampler=None: u.sum(-1)
    assert not sqp._fused_line_search_rule(cfg, plain, _map(), CUDA, False)
    other = make_objective(cfg.replace(control_steps=4))
    assert not sqp._fused_line_search_rule(cfg, other, _map(), CUDA, False)


def test_a_map_that_is_not_float32_keeps_the_loop():
    cfg = _parity()
    assert not sqp._fused_line_search_rule(
        cfg, make_objective(cfg), _map(dtype=torch.float64), CUDA, False)


def test_cpu_solves_build_no_kernel_and_run_the_masked_loop(monkeypatch):
    """On CPU operands the solver builds no kernel (the rule is false), so
    the parity sequential branch runs `_masked_armijo`, as before."""
    built, loops = [], []
    factory, loop = sqp._fused_line_search, sqp._masked_armijo
    monkeypatch.setattr(sqp, "_fused_line_search", lambda *a: built.append(
        factory(*a)) or built[-1])
    monkeypatch.setattr(sqp, "_masked_armijo", lambda *a, **kw: loops.append(
        1) or loop(*a, **kw))
    launches = sqp.parity_line_search.launches
    cfg = _parity()
    sb = tp.make_scenario_batch(cfg, 4, seed=1, map_size=32, plan_points=32,
                                device="cpu")
    tp.batch_simulate(cfg, sb, 2)
    assert built and all(ls is None for ls in built)
    assert loops and sqp.parity_line_search.launches == launches


def _scens(B=5, weights=True, limits=True):
    """A batch of parity solve requests with per-lane weights and limits
    (or the configuration's), on the CPU."""
    cfg = _parity()
    g = torch.Generator().manual_seed(3)
    u = lambda *s: torch.rand(*s, generator=g)
    sb = tp.make_scenario_batch(cfg, B, seed=2, map_size=32, plan_points=32,
                                device="cpu")
    scen = tp.Scenario(
        current_pose=u(B, 3), carrot_pose=u(B, 3), goal_pose=u(B, 3),
        current_vel=u(B, 3), footprint=sb.footprint, costmap=sb.costmap,
        switch_opt=torch.zeros(B, dtype=torch.bool),
        weights=Weights(*(u(B) for _ in range(6))) if weights else None,
        limits=(Limits.from_config(cfg, B, "cpu").replace(
            max_vel_trans=0.3 + u(B)) if limits else None))
    return cfg, scen


@pytest.mark.parametrize("per_lane", [True, False], ids=["per_lane",
                                                         "config"])
def test_lane_table_holds_each_lanes_row_in_column_order(per_lane):
    cfg, scen = _scens(weights=per_lane, limits=per_lane)
    fp = torch.arange(5, dtype=torch.float32)
    table = sqp._parity_lane_table(cfg, make_objective(cfg), scen, fp)
    names = [n for n, _ in binding.PARITY_LS_LANE_COLUMNS]
    assert table.shape == (5, 22) and sum(
        k for _, k in binding.PARITY_LS_LANE_COLUMNS) == 22
    cols = dict(zip(names, table.split(
        [k for _, k in binding.PARITY_LS_LANE_COLUMNS], dim=1)))
    for name in ("current_pose", "carrot_pose", "goal_pose", "current_vel"):
        assert torch.equal(cols[name], getattr(scen, name))
    for name in ("w_trans", "w_orient", "w_control", "w_terminal",
                 "w_costmap"):
        want = (getattr(scen.weights, name) if per_lane else
                torch.full((5,), getattr(cfg, name)))
        assert torch.equal(cols[name][:, 0], want)
    want = (scen.limits.max_vel_trans if per_lane
            else torch.full((5,), cfg.max_vel_trans))
    assert torch.equal(cols["max_vel_trans"][:, 0], want)
    assert torch.equal(cols["fp_term"][:, 0], fp)
    assert torch.equal(cols["origin"], scen.costmap.origin)
    assert torch.equal(cols["resolution"][:, 0], scen.costmap.resolution)


class _StubLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


@pytest.mark.parametrize("u8", [False, True])
def test_launcher_hands_the_c_function_its_arguments_in_order(monkeypatch,
                                                              u8):
    """_fused_line_search (the rule made to hold for CPU tensors) builds
    its table once and hands neo_parity_line_search_f32 the sizes, the
    sum width, the quirk bits, the schedule, the map (and its u8
    companion), the table, the trip's operands and three outputs, in the
    order of its parameters."""
    lib = _StubLibrary()
    monkeypatch.setattr(binding, "load_library", lambda: lib)
    monkeypatch.setattr(binding, "_stream", lambda device: 1234)
    rule = sqp._fused_line_search_rule
    monkeypatch.setattr(sqp, "_fused_line_search_rule",
                        lambda c, o, cm, dev, w: rule(c, o, cm, CUDA, w))
    cfg, scen = _scens()
    cfg = cfg.replace(compat=dataclasses.replace(cfg.compat,
                                                 lethal_1000x=False))
    if u8:
        scen = scen.replace(costmap=scen.costmap.with_flat(u8=True))
    fp = torch.zeros(5)
    ls = sqp._fused_line_search(cfg, make_objective(cfg), scen, fp, False)
    m = 3 * cfg.control_steps
    ops = [torch.rand(5, m), torch.rand(5, m)] + [torch.rand(5)
                                                  for _ in range(5)]
    flags = [torch.zeros(5, dtype=torch.bool), torch.ones(5, dtype=torch.bool)]
    before = sqp.parity_line_search.launches
    alpha, f_ls, ok = ls(*ops, *flags, max_backtracks=7, quad_interp=True,
                         backtrack=0.5, coarse_after=2, coarse=0.0625)
    assert sqp.parity_line_search.launches == before + 1
    (name, args), = lib.calls
    assert name == "neo_parity_line_search_f32"
    restype, argtypes = build.SIGNATURES[name]
    assert len(args) == len(argtypes) == 29
    H, W = scen.costmap.data.shape[-2:]
    quirks = 1 | 2 | 8 | 16           # every quirk but the lethal x1000
    assert args[:10] == (5, 3, binding.parity_ls_sum_width(3, 5), quirks, 7,
                         1, 2, H, W, 5)
    assert args[10] == pytest.approx(cfg.dt) and args[11:13] == (0.5, 0.0625)
    cm = scen.costmap
    assert args[13] == cm._flat().data_ptr()
    assert args[14] == (cm.flat_u8.data_ptr() if u8 else None)
    assert args[16:25] == tuple(t.data_ptr() for t in ops + flags)
    assert args[25:28] == (alpha.data_ptr(), f_ls.data_ptr(), ok.data_ptr())
    assert args[28] == 1234
    assert alpha.dtype == f_ls.dtype == torch.float32
    assert ok.dtype == torch.bool and ok.shape == (5,)


@pytest.mark.parametrize("n,rows,width", [
    (1, 4096, 1), (2, 4096, 2), (3, 4096, 2), (3, 1, 2), (4, 9, 4),
    (31, 4096, 16), (32, 1, 32), (63, 1, 32), (64, 4096, 32), (64, 16, 32),
    (64, 15, 64), (79, 1, 64)])
def test_sum_width_is_pytorchs_reduction_split(n, rows, width):
    """binding.parity_ls_sum_width: the largest power of two in the row, at
    most a warp, widened past a warp (to 64) only where fewer than 16 rows
    leave a block room."""
    assert binding.parity_ls_sum_width(n, rows) == width


# --- the kernel's source on the CPU -----------------------------------------

SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
using std::max; using std::min; using std::signbit;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct Idx { int x = 0; };
static Idx blockIdx, threadIdx, blockDim;
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
template <class T> inline T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
"""

HOST_LOOP = r"""
extern "C" void host_line_search(
    int B, int n, int sum_width, int quirks, int max_backtracks,
    int quad_interp, int coarse_after, int H, int W, int map_lanes,
    float dt, float backtrack, float coarse, const float* map,
    const uint8_t* map_u8, const float* lane, const float* x,
    const float* d, const float* alpha, const float* phi0,
    const float* dphi, const float* mu, const float* f, const bool* done,
    const bool* active, float* alpha_out, float* f_out, bool* ok_out) {
  neo_mpc::Scalars S;
  S.n = n; S.sum_width = sum_width; S.quirks = quirks; S.dt = dt;
  S.inv_n = 1.f / static_cast<float>(n);
  const long long stride = map_lanes == 1 ? 0 : (long long)H * W;
  blockDim.x = 1;
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    neo_mpc::parity_line_search_kernel(
        B, S, max_backtracks, quad_interp, coarse_after, backtrack, coarse,
        H, W, stride, map, map_u8, lane, x, d, alpha, phi0, dphi, mu, f,
        done, active, alpha_out, f_out, ok_out);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's source compiled for the CPU by g++ (no FMA
    contraction), with a host loop that runs its threads one after
    another."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel's source for the CPU"
    src = (build.CSRC / "parity_line_search.cu").read_text()
    body = src[:src.index('extern "C"')].replace("#include <cuda_runtime.h>",
                                                 '#include "shim.h"')
    out = tmp_path_factory.mktemp("host_kernel")
    (out / "shim.h").write_text(SHIM)
    (out / "kernel.cpp").write_text(body + HOST_LOOP)
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(out), "-o", str(out / "k.so"),
                    str(out / "kernel.cpp")], check=True)
    lib = ctypes.CDLL(str(out / "k.so"))
    fn = lib.host_line_search
    fn.argtypes = list(build.SIGNATURES["neo_parity_line_search_f32"][1])[:-1]
    return fn


def _host_launch(fn):
    def launch(flat, flat_u8, H, W, lane, x, d, alpha, phi0, dphi, mu, f,
               done, active, *, n, dt, quirks, max_backtracks, quad_interp,
               backtrack, coarse_after, coarse):
        B = x.shape[0]
        outs = (torch.empty_like(alpha), torch.empty_like(f),
                torch.empty_like(done))
        ops = [t.contiguous() for t in (lane, x, d, alpha, phi0, dphi, mu, f,
                                        done, active)]
        fn(B, n, binding.parity_ls_sum_width(n, B), quirks, max_backtracks,
           int(quad_interp), coarse_after, H, W,
           1 if flat.dim() == 1 else flat.shape[0], dt, backtrack, coarse,
           flat.data_ptr(), None if flat_u8 is None else flat_u8.data_ptr(),
           *(t.data_ptr() for t in ops + list(outs)))
        return outs
    return launch


HOST_CASES = {
    "quad_interp": {},
    "two_phase": dict(solver_ls_quad_interp=False),
    "u8_source": dict(solver_costmap_u8=True),
    "quirks_off": dict(compat=tp.CompatConfig(
        buggy_odom_yaw=False, footprint_alias_noop=False, lethal_1000x=False,
        unsquared_control_cost=False, no_angle_wrap=False)),
}


def _objective_at_first_alpha(trip):
    """The kernel's f at each lane's first alpha of a recorded trip (every
    lane active, phi0 = +inf so that the first candidate is accepted) and
    the masked loop's merit's f there."""
    x, d, alpha, phi0, dphi, mu, f, done, active = trip["args"]
    schedule = dict(trip["schedule"], max_backtracks=1)
    _, got, ok = trip["line_search"](
        x, d, alpha, torch.full_like(phi0, float("inf")),
        torch.zeros_like(dphi), mu, f, torch.zeros_like(done),
        torch.ones_like(active), **schedule)
    assert bool(ok.all())
    return got, trip["merit"](x + alpha[:, None] * d, mu)[1]


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_kernel_source_takes_the_masked_loops_steps(case, host_kernel,
                                                    monkeypatch):
    """The kernel's source on the CPU, handed each trip's operands by the
    solver's own plumbing over a 64-lane parity closed loop of 3 ticks
    (the trips go on with the masked loop's result): at each trip's first
    alpha its objective is the merit's within 1e-6 in every lane; every
    lane accepts as the loop does, but for at most one Armijo tie in a
    thousand lane-trips; the two-phase factor's alphas are the loop's; f at
    the accepted candidate agrees within 1e-6 and the interpolated alphas
    (in (0, 1]) within 5e-3 (the CPU's sine, cosine, sums and divisions by
    N round otherwise, and the quadratic's denominator phi - phi0 -
    dphi·alpha cancels where the merit is flat along d: 1.1e-3 apart at
    most here, at an f 1e-6 apart)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rule = sqp._fused_line_search_rule
    monkeypatch.setattr(sqp, "_fused_line_search_rule",
                        lambda c, o, cm, dev, w: rule(c, o, cm, CUDA, w))
    monkeypatch.setattr(binding, "launch_parity_line_search",
                        _host_launch(host_kernel))
    cfg = _parity().replace(**HOST_CASES[case])
    sb = tp.make_scenario_batch(cfg, 64, seed=4, map_size=48, plan_points=64,
                                device="cpu")
    with chip_smoke.ParityLsRecorder() as rec:
        tp.batch_simulate(cfg, sb, 3)
    assert len(rec.trips) >= 6
    lane_trips = ties = 0
    for trip in rec.trips:
        torch.testing.assert_close(*_objective_at_first_alpha(trip),
                                   rtol=1e-6, atol=1e-7)
        (a, f, ok), (a0, f0, ok0) = trip["kernel"], trip["loop"]
        lane_trips += ok.numel()
        ties += int((ok != ok0).sum())
        same = ok == ok0
        if not HOST_CASES[case].get("solver_ls_quad_interp", True):
            assert torch.equal(a[same], a0[same])
        torch.testing.assert_close(a[same], a0[same], rtol=0, atol=5e-3)
        torch.testing.assert_close(f[same], f0[same], rtol=1e-6, atol=1e-7)
    assert ties * 1000 <= lane_trips, (ties, lane_trips)
