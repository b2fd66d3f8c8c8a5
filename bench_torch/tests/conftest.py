"""The benchmark's own tests import its modules as run.py does: from
bench_torch/ on sys.path (the repository root after it)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
