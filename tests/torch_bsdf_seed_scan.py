"""Runs tests/test_torch_bsdf.py's `test_bsdf_kind_parity` over a range of
input seeds and counts the failures.

The test seeds each case's inputs with a stable hash of its name
(`_case_seed`), so every run of the suite sees the same seed per case. This
scan replaces that seed by each seed of a range in turn:

    JAX_PLATFORMS=cpu python tests/torch_bsdf_seed_scan.py [first] [count]

It prints one line per failing (seed, case) and then the number of failing
seeds; about 0.1 s per seed and case on the CPU.
"""

import contextlib
import io
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import test_torch_bsdf as tb  # noqa: E402


class _Capsys:
    """Stands in for pytest's capsys fixture."""

    @contextlib.contextmanager
    def disabled(self):
        yield


def main(first=5000, count=300):
    failing = set()
    for seed in range(first, first + count):
        tb._case_seed = lambda name, seed=seed: seed
        for name in sorted(tb.CASES):
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    tb.test_bsdf_kind_parity(name, _Capsys())
            except AssertionError as e:
                failing.add(seed)
                print(f"seed {seed} {name}: {str(e).splitlines()[0]}", flush=True)
    print(f"{len(failing)} of {count} seeds fail a case")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
