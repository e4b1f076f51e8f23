"""The benchmark's tests: its layout, its yardstick and its judge, on the
CPU at small sizes (``python -m pytest benchmark/tests``)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
