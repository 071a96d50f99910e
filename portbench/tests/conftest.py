"""The benchmark's own tests: on the CPU, with the program's plain
kernels. Run from the checkout's root:

    python3 -m pytest portbench/tests -q

Tests marked `cuda` need the card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
