"""Console entry points of the port (port of `cli.py`).

- neo-mpc-server-torch: the standalone optimization server
  (`ros2 run neo_mpc_planner2 mpc_optimization_server.py --ros-args
  --params-file …` analogue, README.md:92) with --params-file support for
  the reference's navigation.yaml layout, and --device: "cuda" (the
  default) shards the fleet ops over every visible card, "cuda:k" serves
  on that card, "cpu" on the CPU.
- neo-mpc-bench-torch: the benchmark (`bench.main`, also
  `python -m neo_mpc_planner2_tpu_torch.bench`), the counterpart of the
  JAX package's `neo-mpc-bench`: every pass of the repository's bench.py,
  its flags and its one JSON line, on one card (--device, default "cuda";
  "cpu" only when asked).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Mapping

# The H100 reading behind --fleet-chunk's default (PERF.md, serving).
_FLEET_CHUNK_HELP = (
    "max lanes per device dispatch for the fleet ops; larger shards run as "
    "sequential chunks of at most this many lanes. 0 (default) = always one "
    "dispatch: at 8192 robots on an NVIDIA H100 80GB HBM3 at a 700 W power "
    "limit, chunks of 4096 were 1.20x slower than one dispatch (PERF.md)")


def _load_params_file(path: str) -> Mapping[str, Any]:
    """Read a ROS-style params file. Accepts either a flat JSON/YAML dict of
    parameter names or the full navigation.yaml layout
    (mpc_optimization_server: ros__parameters: {...} — README.md:51-84)."""
    with open(path) as f:
        text = f.read()
    data = None
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml  # type: ignore

            data = yaml.safe_load(text)
        except ImportError:
            raise SystemExit("params file is not JSON and PyYAML is unavailable")
    if not isinstance(data, dict):
        raise SystemExit("params file must contain a mapping")
    params: dict = {}
    # Merge both the server and plugin sections when the full layout is given.
    node = data.get("mpc_optimization_server", {})
    if isinstance(node, dict):
        params.update(node.get("ros__parameters", {}))
    ctrl = data.get("controller_server", {})
    if isinstance(ctrl, dict):
        rp = ctrl.get("ros__parameters", {})
        params.setdefault("controller_frequency", rp.get("controller_frequency", 30.0))
        fp = rp.get("FollowPath", {})
        if isinstance(fp, dict):
            for k in ("lookahead_dist_min", "lookahead_dist_max",
                      "lookahead_dist_close_to_goal"):
                if k in fp:
                    params[k] = fp[k]
    if not params:
        params = data  # flat dict
    return params


def server_main(argv=None) -> None:
    """Parse the arguments and serve until interrupted."""
    from .config import config_from_ros_params, default_config
    from .serving import serve

    ap = argparse.ArgumentParser(prog="neo-mpc-server-torch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7180)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the session (default: cuda, "
                         "the fleet ops sharded over every visible card; "
                         "cuda:k for one card; without a card the server "
                         "refuses to start unless given --device cpu)")
    ap.add_argument("--params-file", default=None)
    ap.add_argument("--pipelined", action="store_true",
                    help="advanced-step mode: reply with the previous tick's "
                         "command (the first reply is a zero warm-up)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="enable the save_state/load_state ops, confined to "
                         "this directory (disabled when unset); a name "
                         "ending in .npz is one file either package reads, "
                         "any other a torch.distributed.checkpoint "
                         "directory")
    ap.add_argument("--max-slots", type=int, default=1024,
                    help="hard LRU cap on per-robot session slots")
    ap.add_argument("--slot-ttl", type=float, default=None,
                    help="expire robot slots idle longer than this many "
                         "seconds (default: no TTL, LRU cap only)")
    ap.add_argument("--fleet-chunk", type=int, default=0,
                    help=_FLEET_CHUNK_HELP)
    ap.add_argument("--product", action="store_true",
                    help="serve PRODUCT mode: the smooth bilinear objective "
                         "+ true predicted footprint through the same SQP "
                         "(config.product_config base — quirks off, fused "
                         "line-search wave; --params-file values overlay "
                         "it). Default: reference-parity mode")
    args = ap.parse_args(argv)

    if args.product:
        from .config import product_config

        base = product_config()
    else:
        base = default_config()
    cfg = (config_from_ros_params(_load_params_file(args.params_file),
                                  base=base)
           if args.params_file else base)
    print(f"[neo-mpc-server-torch] listening on {args.host}:{args.port} "
          f"({args.device})" + (" (product mode)" if args.product else ""),
          file=sys.stderr)
    serve(args.host, args.port, cfg, pipelined=args.pipelined,
          checkpoint_dir=args.checkpoint_dir, max_slots=args.max_slots,
          slot_ttl=args.slot_ttl, parity=not args.product,
          fleet_chunk=args.fleet_chunk, device=args.device)


def bench_main(argv=None) -> None:
    """Run the port's benchmark (`bench.main`) with these arguments."""
    from .bench import main

    main(argv)
