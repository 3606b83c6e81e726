"""Puts the checkout's root, `src/` and `bench/` on sys.path, as `bench/run.py`
does, so that the tests import the harness, the reference and the port."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "bench", ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
