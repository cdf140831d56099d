"""Single-robot controller facade — the nav2_core::Controller API surface
(port of `controller.py`).

The reference's deployment unit is the `NeoMpcPlanner` plugin, whose public
interface is the nav2_core::Controller virtual API (include/NeoMpcPlanner.h:
72-122): configure / activate / deactivate / cleanup / setPlan /
computeVelocityCommands / setSpeedLimit. This class offers the same
lifecycle and per-tick API over the engine so a reference user can port
call sites 1:1, without ROS and without the plugin→DDS→scipy round trip.

Two routes, as in the JAX package:
- fused (default): `MpcEngine.step` at batch 1 runs the whole tick on the
  controller's device: pursuit, the footprint gate, the SQP, the post-solve.
- `native_geometry=True`: the C++ host library (`native/`, built with g++
  at first use) runs the pursuit geometry on the host, and only the solve
  (`engine.solve_step` with a single-lane SQP built once) runs on the
  device.

The controller's tensors live on `device`: the card unless the caller asks
for the CPU (device="cpu"). Each tick reads three results back to the host,
in this order: the empty-window flag, the lethal flag, the command.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from .config import MpcConfig, config_from_ros_params, default_config
from .engine import MpcEngine, StepResult, solve_step
from .ops.costmap import Costmap
from .ops.footprint import Footprint, required_edge_samples
from .ops.objective import Limits, Scenario, make_objective
from .ops.pursuit import Plan
from .sqp import make_sqp_solver
from .utils.viz import (carrot_msg, local_plan_msg, plan_msg,
                        predicted_footprint_msg)

__all__ = ["NeoMpcController", "ControllerException"]


class ControllerException(RuntimeError):
    """Raised like nav2_core::ControllerException (cpp:70, :76, :131, :235)."""


class NeoMpcController:
    """Lifecycle + tick API mirroring the reference plugin.

    >>> ctrl = NeoMpcController()            # device="cpu" for the CPU
    >>> ctrl.configure(params, costmap, footprint)
    >>> ctrl.activate()
    >>> ctrl.set_plan(plan_xyyaw)
    >>> cmd = ctrl.compute_velocity_commands(pose, velocity)
    """

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self.cfg: Optional[MpcConfig] = None
        self._engine: Optional[MpcEngine] = None
        self._state = None
        self._plan: Optional[Plan] = None
        self._costmap: Optional[Costmap] = None
        self._footprint: Optional[Footprint] = None
        self._active = False
        # 0.0 baseline is REFERENCE PARITY (py:138): the first tick's
        # wall-clock delta_t is epoch-sized, so a collision latched on the
        # very first tick has its 3 s stuck-wait instantly expired — the
        # reference does exactly this. Don't "fix" by stamping at configure;
        # pass delta_t explicitly for deterministic behavior.
        self._last_time = 0.0
        self._native = None
        self._native_solver = None
        self._limits = None
        self.last_result: Optional[StepResult] = None
        self._last_pose = None       # robot pose of the last tick (map frame)
        self._last_window = None     # (begin, end) plan indices of the last tick

    def _check_device(self, what: str, t: torch.Tensor) -> None:
        dev = self.device
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(f"the {what} is on {t.device}, the controller "
                             f"on {dev}")

    # ---- lifecycle (h:72-90) ----
    def configure(self, params=None, costmap: Optional[Costmap] = None,
                  footprint: Optional[Footprint] = None,
                  parity: bool = True, native_geometry: bool = False) -> None:
        """configure() equivalent (cpp:290-334). params: MpcConfig or a dict
        of reference ROS parameter names. Raises RuntimeError on a
        controller for the card when there is none, ValueError when the
        costmap or footprint lies on another device.

        native_geometry=True routes the pursuit geometry (plan pruning,
        carrot selection, hysteresis, lethal gate) through the C++ host
        library (native/, the reference's Layer A in native code, built at
        first use) and only the solve runs on the device — the two-layer
        deployment shape with no TCP hop.
        """
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the controller runs on the "
                               "card unless it is asked for the CPU "
                               "(device='cpu')")
        if costmap is not None:
            self._check_device("costmap", costmap.data)
        if footprint is not None:
            self._check_device("footprint", footprint.vertices)
        if isinstance(params, MpcConfig):
            self.cfg = params
        elif params is not None:
            self.cfg = config_from_ros_params(params)
        else:
            self.cfg = default_config()
        if costmap is not None:
            self._costmap = costmap
        if footprint is not None:
            self._footprint = footprint
        self._parity = parity
        self._native_geometry = native_geometry
        self._limits = None
        self._ensure_footprint_sampling()
        self._build_engine()
        self._state = self._engine.init_state()
        # Speed limits scale from the configured maxima (cpp setSpeedLimit
        # doc: "percentage from maximum robot speed"), not compounding.
        self._base_cfg = self.cfg

    def _build_engine(self) -> None:
        self._engine = MpcEngine(self.cfg, parity=self._parity,
                                 device=self.device)
        self._native = None
        self._native_solver = None
        if self._native_geometry:
            from .native.host import NativeHost

            self._native = NativeHost(
                lookahead_dist_min=self.cfg.lookahead_dist_min,
                lookahead_dist_max=self.cfg.lookahead_dist_max,
                lookahead_dist_close_to_goal=self.cfg.lookahead_dist_close_to_goal,
                controller_frequency=self.cfg.controller_frequency,
            )
            # Built once here, never per tick.
            self._native_solver = make_sqp_solver(
                self.cfg, make_objective(self.cfg, parity=self._parity))

    def _ensure_footprint_sampling(self) -> None:
        """Guarantee the uniform edge sampling cannot skip costmap cells: bump
        footprint_edge_samples to ceil(max_edge/resolution)+2 when the
        configured count would space samples wider than a cell. Exact-
        traversal mode needs no count at all."""
        if (self.cfg is None or self.cfg.footprint_exact
                or self._costmap is None or self._footprint is None):
            return
        nv = int(self._footprint.n_valid)
        need = required_edge_samples(
            self._footprint.vertices[:nv].cpu().numpy(),
            float(self._costmap.resolution))
        if need > self.cfg.footprint_edge_samples:
            # Auto-corrected, safe by construction: logged (not warned) so
            # routine configure() calls with the default count stay quiet;
            # the count is visible on self.cfg either way.
            logging.getLogger(__name__).info(
                "footprint_edge_samples=%d spaces samples wider than the "
                "%g m map resolution for this footprint; raising to %d",
                self.cfg.footprint_edge_samples,
                float(self._costmap.resolution), need)
            self.cfg = self.cfg.replace(footprint_edge_samples=need)
            if self._engine is not None:
                self._build_engine()

    def activate(self) -> None:
        if self.cfg is None:
            raise ControllerException("configure() before activate()")
        self._active = True

    def deactivate(self) -> None:
        self._active = False

    def cleanup(self) -> None:
        self._engine = None
        self._state = None
        self._plan = None

    # ---- inputs ----
    def set_costmap(self, costmap: Costmap) -> None:
        self._check_device("costmap", costmap.data)
        self._costmap = costmap
        self._ensure_footprint_sampling()

    def set_footprint(self, footprint: Footprint) -> None:
        self._check_device("footprint", footprint.vertices)
        self._footprint = footprint
        self._ensure_footprint_sampling()

    def set_plan(self, plan) -> None:
        """setPlan (cpp:274-281): stores the plan; goal-change handling (the
        slow-down latch and warm-start reset) happens in-engine via the
        old_goal comparison, like the server side of the reference."""
        if self.cfg is None:
            raise ControllerException("configure() first")
        if not isinstance(plan, Plan):
            plan = Plan.create(np.asarray(plan, np.float32),
                               max_points=self.cfg.max_plan_points,
                               device=self.device)
        self._check_device("plan", plan.px)
        if int(plan.n_valid) == 0:
            raise ControllerException("Received plan with zero length")  # cpp:70
        # Goal change latches slow-down (cpp:277-279) so the next tick uses
        # the conservative lookahead until the hysteresis clears it.
        new_goal = plan.goal().cpu().numpy()
        goal_changed = (self._plan is None or
                        not np.array_equal(self._plan.goal().cpu().numpy(),
                                           new_goal))
        self._plan = plan
        # The last tick's window indices refer to the OLD plan — slicing the
        # new one with them would publish garbage.
        self._last_window = None
        # New plan: reset the consumed-prefix index (the reference keeps a
        # fresh copy of the plan, cpp:276).
        self._state = self._state.replace(
            plan_start=torch.tensor(0, dtype=torch.int32, device=self.device),
            slow_down=torch.tensor(
                bool(goal_changed) or bool(self._state.slow_down),
                device=self.device),
        )
        if self._native is not None:
            nv = int(plan.n_valid)
            self._native.set_plan(plan.poses[:nv].cpu().numpy())

    def set_speed_limit(self, speed_limit: float, percentage: bool) -> None:
        """setSpeedLimit (h:122, cpp:283-288). The reference leaves this
        EMPTY — a silent no-op. Kept functional here (scales max_vel_trans /
        box bounds) because a no-op speed limiter on a real robot is a
        safety bug, not a quirk worth preserving.

        Nothing is rebuilt: the scaled bounds ride one lane's runtime
        Limits into the engine's cached step."""
        if self.cfg is None:
            raise ControllerException("configure() first")
        base = self._base_cfg
        scale = (speed_limit / 100.0 if percentage
                 else speed_limit / base.max_vel_trans)
        scale = float(np.clip(scale, 1e-3, 1.0))
        # cfg mirrors the effective bounds for introspection. Scale the
        # velocity fields from BASE (so repeated speed-limit calls don't
        # compound) but apply them onto the CURRENT cfg: replacing cfg
        # wholesale from base would revert later auto-corrections (e.g. the
        # footprint_edge_samples bump from set_costmap), which the next
        # set_costmap would then re-apply with a full engine rebuild.
        self.cfg = self.cfg.replace(
            max_vel_trans=base.max_vel_trans * scale,
            max_vel_x=base.max_vel_x * scale, min_vel_x=base.min_vel_x * scale,
            max_vel_y=base.max_vel_y * scale, min_vel_y=base.min_vel_y * scale,
        )
        # One lane, no batch dim: the engine adds the lane dim itself.
        self._limits = Limits.from_config(base, device=self.device).scaled(
            scale)

    # ---- the tick (cpp:202-254) ----
    def compute_velocity_commands(self, pose, velocity,
                                  delta_t: Optional[float] = None) -> np.ndarray:
        """One control tick. Raises ControllerException on the lethal gate
        (cpp:234-236 'MPC detected collision!') and on missing inputs."""
        if not self._active:
            raise ControllerException("controller not activated")
        if self._plan is None:
            raise ControllerException("Received plan with zero length")
        if self._costmap is None or self._footprint is None:
            raise ControllerException("costmap/footprint not set")

        if delta_t is None:
            now = time.time()
            delta_t = now - self._last_time  # py:369-371 semantics
            self._last_time = now

        self._last_pose = np.asarray(pose, float)
        if self._native is not None:
            return self._tick_native(pose, velocity, float(delta_t))

        # Pose and velocity cross to the device as one array.
        pv = torch.as_tensor(np.concatenate([
            np.asarray(pose, np.float32).reshape(3),
            np.asarray(velocity, np.float32).reshape(3)])).to(self.device)
        out = self._engine.step(
            self._state, self._plan, pv[:3], pv[3:],
            self._costmap, self._footprint, float(delta_t),
            limits=self._limits,
        )
        self._state = out.state
        self.last_result = out
        # Device tensors, not read here: transformed_plan() reads them when
        # it is asked.
        self._last_window = (out.plan_window_begin, out.plan_window_end)
        if bool(out.plan_empty):
            raise ControllerException("Resulting plan has 0 poses in it.")  # cpp:131
        if bool(out.lethal):
            raise ControllerException("MPC detected collision!")  # cpp:235
        return out.cmd_vel.cpu().numpy()

    def _tick_native(self, pose, velocity, delta_t: float) -> np.ndarray:
        """C++ geometry + device solve (the reference's two-layer split,
        minus the transport)."""
        from .native.host import (NMP_ERR_EMPTY_PLAN, NMP_ERR_LETHAL,
                                  NMP_ERR_NO_WINDOW, NMP_OK)

        nv = int(self._footprint.n_valid)
        fp_np = self._footprint.vertices[:nv].cpu().numpy()
        status, req = self._native.tick(
            np.asarray(pose, float), np.asarray(velocity, float),
            self._costmap.data.cpu().numpy(),
            self._costmap.origin.cpu().numpy(),
            float(self._costmap.resolution), fp_np)
        if status == NMP_ERR_EMPTY_PLAN:
            raise ControllerException("Received plan with zero length")
        if status == NMP_ERR_NO_WINDOW:
            raise ControllerException("Resulting plan has 0 poses in it.")
        if status == NMP_ERR_LETHAL:
            raise ControllerException("MPC detected collision!")
        if status != NMP_OK:
            raise ControllerException(f"native host status {status}")

        # The request's poses, velocity, control interval and switch flag
        # cross to the device as one float32 array.
        packed = torch.as_tensor(np.concatenate([
            req.current_pose, req.carrot_pose, req.goal_pose,
            req.current_vel,
            [req.control_interval, float(req.switch_opt)]]).astype(
                np.float32)).to(self.device)
        scen = Scenario(
            current_pose=packed[0:3], carrot_pose=packed[3:6],
            goal_pose=packed[6:9], current_vel=packed[9:12],
            footprint=self._footprint, costmap=self._costmap,
            switch_opt=packed[13] != 0, control_interval=packed[12],
            limits=self._limits)
        out = solve_step(self.cfg, self._state, scen, delta_t,
                         solver=self._native_solver)
        self._state = out.state
        self.last_result = out
        self._last_window = (req.window_begin, req.window_end)
        return out.cmd_vel.cpu().numpy()

    # ---- debug artifacts (A6/B7 parity) ----
    def transformed_plan(self) -> np.ndarray:
        """The last tick's transformed-plan window in the base frame — the
        poses the reference publishes as `received_global_plan` every tick
        (NeoMpcPlanner.cpp:109-128). (K, 3) x/y/yaw; empty (0, 3) before the
        first tick."""
        if (self._last_window is None or self._last_pose is None
                or self._plan is None):
            return np.zeros((0, 3))
        b, e = (int(self._last_window[0]), int(self._last_window[1]))
        poses = self._plan.poses.cpu().numpy()[b:e]
        r = self._last_pose
        c, s = np.cos(r[2]), np.sin(r[2])
        dx, dy = poses[:, 0] - r[0], poses[:, 1] - r[1]
        return np.stack(
            [dx * c + dy * s, -dx * s + dy * c, poses[:, 2] - r[2]], axis=-1)

    def debug_msgs(self) -> dict:
        if self.last_result is None:
            return {}
        local_plan = self.last_result.local_plan.cpu().numpy()
        msgs = {
            "lookahead_point": carrot_msg(
                self.last_result.carrot_pose.cpu().numpy()),
            "local_plan": local_plan_msg(local_plan),
        }
        window = self.transformed_plan()
        msgs["received_global_plan"] = plan_msg(window, len(window))
        if self._footprint is not None:
            nv = int(self._footprint.n_valid)
            msgs["predicted_footprint"] = predicted_footprint_msg(
                self._footprint.vertices[:nv].cpu().numpy(), local_plan[-1])
        return msgs
