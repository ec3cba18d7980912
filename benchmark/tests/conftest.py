"""The benchmark's own tests: `python -m pytest benchmark/tests -q`.

They import the benchmark's modules by path and the port from the
checkout; none imports JAX."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))
