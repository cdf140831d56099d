"""The port's studies, one module for each study of the repository's
`scripts/` (which drive the JAX package), of the same name:

    python -m neo_mpc_planner2_tpu_torch.scripts.<name> [--device cpu]

Each takes its JAX twin's flags and defaults plus --device and prints its
JSON lines (or text) with the same keys. They run on the card unless they
are given `--device cpu`.
"""

NAMES = ("iters_hist", "trace_headline", "dyn_decompose", "scaling_bench",
         "product_decompose", "parity_study")
