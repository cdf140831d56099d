"""Visualization parity helpers.

The reference publishes three debug artifacts (SURVEY.md §5 observability row):
`local_plan` (Path re-integrated from the solution, mpc_optimization_server.py
:271-310), `received_global_plan` (NeoMpcPlanner.cpp:128), and
`/lookahead_point` (cpp:191-200, z = 0.01). Here they become plain dicts
(ROS-message-shaped, JSON-serializable) derived from StepResult — transport is
the caller's business.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .se2_np import quat_from_yaw_np

__all__ = ["local_plan_msg", "carrot_msg", "plan_msg", "predicted_footprint_msg"]


def _pose_dict(x: float, y: float, yaw: float) -> Dict[str, Any]:
    qx, qy, qz, qw = quat_from_yaw_np(yaw)
    return {
        "position": {"x": float(x), "y": float(y), "z": 0.0},
        "orientation": {"x": qx, "y": qy, "z": qz, "w": qw},
    }


def local_plan_msg(local_plan: np.ndarray, frame_id: str = "map") -> Dict[str, Any]:
    """Path-shaped dict from the (N, 3) predicted trajectory
    (publishLocalPlan equivalent, py:271-310)."""
    poses = [
        {"header": {"frame_id": frame_id}, "pose": _pose_dict(*np.asarray(p))}
        for p in np.asarray(local_plan)
    ]
    return {"header": {"frame_id": frame_id}, "poses": poses}


def carrot_msg(carrot_pose: np.ndarray, frame_id: str = "base_link") -> Dict[str, Any]:
    """PointStamped-shaped dict for the lookahead point (createCarrotMsg,
    cpp:191-200 — z = 0.01 'to stand out')."""
    c = np.asarray(carrot_pose)
    return {"header": {"frame_id": frame_id},
            "point": {"x": float(c[0]), "y": float(c[1]), "z": 0.01}}


def predicted_footprint_msg(footprint_vertices: np.ndarray,
                            terminal_pose: np.ndarray,
                            frame_id: str = "map") -> Dict[str, Any]:
    """PolygonStamped-shaped dict: the footprint placed at the predicted
    terminal pose. The reference creates this publisher but never publishes to
    it (mpc_optimization_server.py:108, SURVEY.md §5 observability row) — here
    it actually carries the predicted footprint."""
    x, y, yaw = [float(v) for v in np.asarray(terminal_pose)]
    c, s = np.cos(yaw), np.sin(yaw)
    pts = [{"x": x + float(px) * c - float(py) * s,
            "y": y + float(px) * s + float(py) * c, "z": 0.0}
           for px, py in np.asarray(footprint_vertices)]
    return {"header": {"frame_id": frame_id}, "polygon": {"points": pts}}


def plan_msg(poses: np.ndarray, n_valid: int, frame_id: str = "base_link") -> Dict[str, Any]:
    """Path-shaped dict for the transformed plan window
    (received_global_plan, cpp:119-128)."""
    arr = np.asarray(poses)[: int(n_valid)]
    return {"header": {"frame_id": frame_id},
            "poses": [{"header": {"frame_id": frame_id},
                       "pose": _pose_dict(*p)} for p in arr]}
