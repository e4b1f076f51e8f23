"""Caps PyTorch's intra-op threads in a pytest-xdist worker at its share
of the machine's cores, ceil(cores / workers).

Each worker of a parallel run would otherwise start one torch thread per
core next to XLA's own pool, so the run keeps several times more busy
threads than the machine has cores. The port's test files import this
module; a run without xdist keeps torch's default.
"""

import math
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, math.ceil((os.cpu_count() or 1) / _WORKERS)))
