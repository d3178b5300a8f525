"""`ssz_static` runner: randomized container round-trip vectors per
fork x preset x mode (ref: tests/generators/ssz_static/main.py)."""
from random import Random

from consensus_specs_tpu_torch.debug.encode import encode
from consensus_specs_tpu_torch.debug.random_value import RandomizationMode, get_random_ssz_object
from consensus_specs_tpu_torch.specs import available_forks, build_spec
from consensus_specs_tpu_torch.ssz.types import Container

from ..gen_runner import run_generator
from ..gen_typing import TestCase, TestProvider

MAX_BYTES_LENGTH = 1000
MAX_LIST_LENGTH = 10


def create_test_case(rng: Random, typ, mode: RandomizationMode, chaos: bool):
    value = get_random_ssz_object(rng, typ, MAX_BYTES_LENGTH, MAX_LIST_LENGTH, mode, chaos)
    yield "value", "data", encode(value)
    yield "serialized", "ssz", value.encode_bytes()
    yield "roots", "data", {"root": "0x" + bytes(value.hash_tree_root()).hex()}


def get_spec_ssz_types(spec):
    return [
        (name, value) for (name, value) in spec.__dict__.items()
        if isinstance(value, type) and issubclass(value, Container)
        and value is not Container
        and value.__module__ != "consensus_specs_tpu_torch.ssz.types"
        and len(value.fields()) > 0
    ]


def ssz_static_cases(fork_name: str, preset_name: str, seed: int, mode: RandomizationMode,
                     chaos: bool, count: int):
    spec = build_spec(fork_name, preset_name)
    random_mode_name = mode.to_name()
    for (name, ssz_type) in get_spec_ssz_types(spec):
        for i in range(count):
            # deterministic: derive the rng from (seed, type, index) textually
            rng = Random(f"{seed}:{name}:{i}")
            yield TestCase(
                fork_name=fork_name,
                preset_name=preset_name,
                runner_name="ssz_static",
                handler_name=name,
                suite_name=f"ssz_{random_mode_name}{'_chaos' if chaos else ''}",
                case_name=f"case_{i}",
                case_fn=lambda rng=rng, t=ssz_type, m=mode, c=chaos: create_test_case(rng, t, m, c),
            )


def create_provider(fork_name, preset_name, seed, mode, chaos, count):
    return TestProvider(
        prepare=lambda: None,
        make_cases=lambda: ssz_static_cases(fork_name, preset_name, seed, mode, chaos, count),
    )


def run(args=None):
    # reference-scale matrix (ref ssz_static/main.py:74-84): every
    # randomization mode on minimal at count 30, a chaos setting at 30,
    # and a mainnet random slice at 5; non-changing modes (zero/max/
    # nil/one/lengthy-with-fixed-shapes) collapse to a single case
    settings = []
    seed = 1
    for mode in RandomizationMode:
        settings.append((seed, "minimal", mode, False, 30))
        seed += 1
    settings.append((seed, "minimal", RandomizationMode.mode_random, True, 30))
    seed += 1
    settings.append((seed, "mainnet", RandomizationMode.mode_random, False, 5))
    seed += 1

    providers = []
    for fork in available_forks():
        for (seed, preset, mode, chaos, cases_if_random) in settings:
            count = cases_if_random if chaos or mode.is_changing() else 1
            providers.append(create_provider(fork, preset, seed, mode, chaos, count))
    run_generator("ssz_static", providers, args=args)


if __name__ == "__main__":
    run()
