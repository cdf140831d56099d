"""The port's runnable demos, one module for each of the repository's
`examples/*.py` (which drive the JAX package), of the same name:

    python -m neo_mpc_planner2_tpu_torch.examples.<name> [--device cpu]

Each builds its scene in numpy from the JAX demo's constants and seeds,
has `run(..., ticks=None, device="cuda")`, which returns the numbers the
demo prints as numpy, and `main(argv=None)`, which prints the JAX demo's
lines. They run on the card unless they are given `--device cpu`.
"""

NAMES = ("follow_path_demo", "fleet_demo", "serving_demo",
         "live_costmap_demo", "rolling_window_demo",
         "dynamic_obstacle_demo", "product_mode_demo")
