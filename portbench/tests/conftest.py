"""The benchmark's own tests: CPU only, small sizes; the port is driven on
the CPU (`--device cpu`). Nothing here imports JAX."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
