"""The benchmark's CPU tests: python -m pytest portbench/tests -q (from the
repository's root). They put the benchmark's folder and the repository's
root on the path, as ``python3 portbench/run.py`` does."""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
