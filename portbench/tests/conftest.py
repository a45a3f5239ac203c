"""The benchmark's own tests run on the CPU: ``python -m pytest
portbench/tests -q`` from the root of the checkout."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]
