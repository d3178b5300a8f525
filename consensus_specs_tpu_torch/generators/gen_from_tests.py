"""Reflection bridge: re-run the dual-mode test cases (``cases/``) in
generator mode and emit their yielded parts as vectors (ref:
gen_helpers/gen_from_tests/gen.py)."""
from __future__ import annotations

import importlib
import inspect
from typing import Dict, Iterable, Optional

from consensus_specs_tpu_torch.exceptions import SkippedTest

from .gen_runner import run_generator
from .gen_typing import TestCase, TestProvider


def generate_from_tests(runner_name: str, handler_name: str, src, fork_name: str,
                        preset_name: str, bls_active: bool = True,
                        phase: Optional[str] = None) -> Iterable[TestCase]:
    """One TestCase per test_* function in module ``src``
    (ref gen.py:13-56)."""
    fn_names = [
        name for (name, _) in inspect.getmembers(src, inspect.isfunction)
        if name.startswith("test_")
    ]
    if phase is None:
        phase = fork_name
    print(f"generating tests with preset '{preset_name}' for {runner_name}/{handler_name} ({len(fn_names)} tests)")
    for name in fn_names:
        case_name = name
        tfn = getattr(src, name)

        def case_fn(tfn=tfn, generator_mode=True, phase=phase, preset=preset_name, bls_active=bls_active):
            parts = tfn(generator_mode=generator_mode, phase=phase, preset=preset,
                        bls_active=bls_active)
            if parts is None:
                # fork-matrix decorator filtered this phase out: designed skip
                raise SkippedTest(f"not applicable to phase {phase}")
            return parts

        yield TestCase(
            fork_name=fork_name,
            preset_name=preset_name,
            runner_name=runner_name,
            handler_name=handler_name,
            suite_name=getattr(tfn, "suite_name", "pyspec_tests"),
            case_name=case_name if case_name.startswith("test_") is False else case_name[len("test_"):],
            case_fn=case_fn,
        )


def get_provider(create_provider_fn, fork_name: str, preset_name: str, all_mods) -> Iterable[TestProvider]:
    for handler_name, mod_name in all_mods[fork_name].items():
        yield create_provider_fn(
            fork_name=fork_name, preset_name=preset_name,
            handler_name=handler_name, tests_src_mod_name=mod_name,
        )


def get_create_provider_fn(runner_name: str):
    def prepare_fn() -> None:
        # the backends are the entry point's (gen_runner --device):
        # nothing is swapped in behind the caller's back
        return None

    def create_provider(fork_name: str, preset_name: str, handler_name: str,
                        tests_src_mod_name: str) -> TestProvider:
        def cases_fn() -> Iterable[TestCase]:
            tests_src = importlib.import_module(tests_src_mod_name)
            yield from generate_from_tests(
                runner_name=runner_name,
                handler_name=handler_name,
                src=tests_src,
                fork_name=fork_name,
                preset_name=preset_name,
            )

        return TestProvider(prepare=prepare_fn, make_cases=cases_fn)

    return create_provider


def run_state_test_generators(runner_name: str, all_mods: Dict[str, Dict[str, str]],
                              presets=("minimal", "mainnet"), args=None) -> Dict[str, int]:
    """Loop presets × forks over the module map and write vectors
    (ref gen.py:96-132)."""
    create_provider = get_create_provider_fn(runner_name)
    providers = [
        provider
        for preset_name in presets
        for fork_name in all_mods
        for provider in get_provider(create_provider, fork_name, preset_name, all_mods)
    ]
    return run_generator(runner_name, providers, args=args)

