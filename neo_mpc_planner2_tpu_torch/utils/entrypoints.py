"""What the port's runnable entry points (`examples/`, `scripts/`,
`bench.py`) share: the device flag and its rule, the device barrier, a free TCP port
and the README's sample parameters.

Every one runs on the card unless it is asked for the CPU
(`--device cpu`); given "cuda" on a machine without one it raises before
it runs anything.
"""

from __future__ import annotations

import socket

import torch

__all__ = ["SAMPLE_PARAMS", "add_device_arg", "resolve_device", "sync",
           "free_port"]

# README.md:51-84's sample values, as the JAX demos pass them to
# config_from_ros_params (follow_path, rolling_window, dynamic_obstacle).
SAMPLE_PARAMS = {
    "acc_x_limit": 2.5, "acc_y_limit": 2.5, "acc_theta_limit": 3.0,
    "min_vel_x": -0.7, "min_vel_y": -0.7, "min_vel_theta": -0.7,
    "max_vel_x": 0.7, "max_vel_y": 0.7, "max_vel_trans": 0.7,
    "max_vel_theta": 0.7, "w_trans": 0.82, "w_orient": 0.5,
    "w_control": 0.05, "w_terminal": 0.05, "w_costmap": 0.05,
    "w_footprint": 0.0, "low_pass_gain": 0.5, "opt_tolerance": 1e-3,
    "prediction_horizon": 0.8, "control_steps": 3,
    "lookahead_dist_min": 0.4, "lookahead_dist_max": 0.4,
    "lookahead_dist_close_to_goal": 0.4, "controller_frequency": 30.0,
}


def add_device_arg(ap) -> None:
    """The entry points' --device flag (default: cuda, the current
    card)."""
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, the current card; "
                         "cuda:k for card k; cpu only when asked)")


def resolve_device(name) -> torch.device:
    """The run's device; a CUDA name without a card raises, and "cuda"
    becomes the current card (made current for the run)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: this runs on the card "
                               "unless it is asked for the CPU "
                               "(--device cpu)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]
