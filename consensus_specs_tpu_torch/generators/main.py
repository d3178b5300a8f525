"""Master generator CLI: run one or all of the port's vector runners
(the `make generate_tests` / `make gen_<name>` equivalent, ref Makefile:89,167-197).

Usage:
  python -m consensus_specs_tpu_torch.generators.main -o out/ --bls-defer    # every runner, on the card
  python -m consensus_specs_tpu_torch.generators.main -o out/ --runners ssz_static
  ... plus any gen_runner flags (-f force, -l preset filter, -c collect,
  --device cpu for the kernels' plain versions, --device host for the
  host oracle: the reference BLS and hashlib)
"""
from __future__ import annotations

import argparse
import importlib
import sys

# the runners ported so far; the JAX package's others are listed in ROADMAP.md
RUNNERS = [
    "operations",
    "ssz_static",
]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="generate-tests")
    parser.add_argument("--runners", nargs="*", default=None,
                        help=f"runners to generate (default: all of {RUNNERS})")
    ns, rest = parser.parse_known_args(argv)

    names = ns.runners if ns.runners else RUNNERS
    unknown = [n for n in names if n not in RUNNERS]
    if unknown:
        raise SystemExit(f"unknown runner(s) {unknown}; have {RUNNERS}")
    failures = []
    for name in names:
        mod = importlib.import_module(f"consensus_specs_tpu_torch.generators.runners.{name}")
        print(f"\n=== runner: {name} ===")
        try:
            mod.run(args=rest)
        except SystemExit as e:
            if e.code not in (0, None):
                failures.append(name)
    if failures:
        print(f"FAILED runners: {failures}")
        sys.exit(1)


if __name__ == "__main__":
    main()
