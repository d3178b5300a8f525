"""Generator datatypes (ref: gen_helpers/gen_base/gen_typing.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Tuple

# (name, kind, data) where kind in {"meta", "data", "ssz"}
TestCasePart = Tuple[str, str, Any]


@dataclass
class TestCase:
    """One generated vector case.

    Re-runnability contract: ``case_fn`` MUST be deterministic and free of
    cross-case shared mutable state (seed your RNGs; no module-level
    caches that change results between invocations). Deferred-BLS mode
    (gen_runner --bls-defer) relies on this — a case whose optimistic
    signature answers were wrong is executed a SECOND time under
    ``bls.replaying`` and the replayed parts are committed; a case_fn
    that diverges between runs would silently emit different vectors.
    tests/test_torch_generators.py holds the deferred runs' bytes against
    the JAX package's.
    """

    fork_name: str
    preset_name: str
    runner_name: str
    handler_name: str
    suite_name: str
    case_name: str
    case_fn: Callable[[], Iterable[TestCasePart]]

    def dir_path(self) -> str:
        return (
            f"{self.preset_name}/{self.fork_name}/{self.runner_name}/"
            f"{self.handler_name}/{self.suite_name}/{self.case_name}"
        )


@dataclass
class TestProvider:
    # run once before making the cases (e.g. select a BLS backend)
    prepare: Callable[[], None]
    make_cases: Callable[[], Iterable[TestCase]]
