"""The benchmark's CPU tests: `python -m pytest bench/tests` from the root of
the repository. Tests marked `cuda` run the benchmark on a card and skip
without one."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "bench" / "tests", REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
