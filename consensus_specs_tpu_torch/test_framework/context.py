"""Decorator DSL + state factories (ref: test/context.py).

Composition mirrors the reference: ``spec_state_test = spec_test(
with_state(single_phase(fn)))``; fork matrix decorators
(`with_phases`/`with_all_phases`/...) expand a test over spec targets, and
the BLS tri-state (`always_bls`/`never_bls`/bls-switch) toggles the
facade's kill-switch around each run (ref context.py:236-334).
"""
from __future__ import annotations

import random
from typing import Any, Dict, Optional, Sequence

from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.specs import build_spec
from .constants import ALL_PHASES, MINIMAL, PHASE0, ALTAIR, BELLATRIX, CAPELLA  # noqa: F401
from .genesis import create_genesis_state
from .meta import copy_meta
from .utils import vector_test, with_meta_tags

# Defaults where a caller passes none (the generator passes the preset and
# bls_active of every case; ref conftest.py:30-93 sets them from flags)
DEFAULT_PRESET = MINIMAL
DEFAULT_BLS_ACTIVE = False
ALLOWED_FORKS = None  # a fork filter: None = all implemented forks


def get_spec(fork: str, preset: str, config_overrides: Optional[Dict[str, Any]] = None):
    return build_spec(fork, preset, config_overrides)


# ---------------------------------------------------------------------------
# State factories (ref context.py:96-220)
# ---------------------------------------------------------------------------

_state_cache: Dict[tuple, bytes] = {}


def default_activation_threshold(spec):
    return spec.MAX_EFFECTIVE_BALANCE


def zero_activation_threshold(spec):
    return 0


def default_balances(spec):
    num_validators = spec.SLOTS_PER_EPOCH * 8
    return [spec.MAX_EFFECTIVE_BALANCE] * num_validators


def scaled_churn_balances(spec):
    """Enough validators that churn limit exceeds the min
    (ref context.py:168-178)."""
    num_validators = spec.config.CHURN_LIMIT_QUOTIENT * (2 + spec.config.MIN_PER_EPOCH_CHURN_LIMIT)
    return [spec.MAX_EFFECTIVE_BALANCE] * num_validators


def low_balances(spec):
    num_validators = spec.SLOTS_PER_EPOCH * 8
    low_balance = 18 * 10**9
    return [low_balance] * num_validators


def misc_balances(spec):
    num_validators = spec.SLOTS_PER_EPOCH * 8
    balances = [spec.MAX_EFFECTIVE_BALANCE * 2 * i // num_validators for i in range(num_validators)]
    rng = random.Random(3456)
    rng.shuffle(balances)
    return balances


def misc_balances_in_default_range_with_many_validators(spec):
    num_validators = spec.SLOTS_PER_EPOCH * 8 * 2
    floor = spec.config.EJECTION_BALANCE + spec.EFFECTIVE_BALANCE_INCREMENT
    balances = [
        max(spec.MAX_EFFECTIVE_BALANCE * 2 * i // num_validators, floor) for i in range(num_validators)
    ]
    rng = random.Random(1234)
    rng.shuffle(balances)
    return balances


def low_single_balance(spec):
    return [1]


def large_validator_set(spec):
    num_validators = 2 * spec.SLOTS_PER_EPOCH * spec.MAX_COMMITTEES_PER_SLOT * spec.TARGET_COMMITTEE_SIZE
    return [spec.MAX_EFFECTIVE_BALANCE] * num_validators


def _prepare_state(balances_fn, threshold_fn, spec):
    # spec.__name__ is unique per (fork, preset) AND per config-override
    # build, so an overridden spec can never hit a default-config state.
    key = (spec.__name__, balances_fn.__name__, threshold_fn.__name__)
    serialized = _state_cache.get(key)
    if serialized is None:
        state = create_genesis_state(spec, balances_fn(spec), threshold_fn(spec))
        serialized = state.encode_bytes()
        if len(_state_cache) < 32:
            _state_cache[key] = serialized
    return spec.BeaconState.decode_bytes(serialized)


def with_custom_state(balances_fn, threshold_fn):
    def deco(fn):
        def entry(*args, spec, phases=None, **kw):
            state = _prepare_state(balances_fn, threshold_fn, spec)
            # forward `phases` unconditionally; single_phase pops it for
            # single-fork tests (ref context.py:246-255)
            return fn(*args, spec=spec, state=state, phases=phases, **kw)

        return copy_meta(entry, fn)

    return deco


def with_state(fn):
    return with_custom_state(default_balances, default_activation_threshold)(fn)


# ---------------------------------------------------------------------------
# BLS tri-state (ref context.py:236-334)
# ---------------------------------------------------------------------------

def _bls_wrap(fn, force: Optional[bool]):
    # Generator wrapper: the toggle must span the *iteration* of the wrapped
    # test (tests are generators evaluated lazily), not just its creation —
    # same shape as ref context.py:294-306.
    def entry(*args, **kw):
        setting = kw.pop("bls_active", None)
        active = force if force is not None else (
            setting if setting is not None else DEFAULT_BLS_ACTIVE
        )
        old = bls.bls_active
        bls.bls_active = active
        try:
            res = fn(*args, **kw)
            if res is not None:
                yield from res
        finally:
            bls.bls_active = old

    return copy_meta(entry, fn)


def always_bls(fn):
    """Force real BLS on (ref context.py:308)."""
    return with_meta_tags({"bls_setting": 1})(_bls_wrap(fn, True))


def never_bls(fn):
    """Force BLS off (ref context.py:317)."""
    return with_meta_tags({"bls_setting": 2})(_bls_wrap(fn, False))


def bls_switch(fn):
    return _bls_wrap(fn, None)


# ---------------------------------------------------------------------------
# Core composition (ref context.py:258-291)
# ---------------------------------------------------------------------------

def single_phase(fn):
    """Drop the `phases` kwarg for tests that only need one fork
    (ref context.py:246-255)."""

    def entry(*args, **kw):
        kw.pop("phases", None)
        return fn(*args, **kw)

    return copy_meta(entry, fn)


def spec_test(fn):
    return vector_test()(bls_switch(fn))


def spec_state_test(fn):
    return spec_test(with_state(single_phase(fn)))


def spec_configured_state_test(conf_overrides):
    """spec_state_test against a config-overridden spec copy
    (ref context.py:492-551)."""

    def deco(fn):
        return spec_test(with_config_overrides(conf_overrides)(with_state(single_phase(fn))))

    return deco


def expect_assertion_error(fn):
    """Run fn expecting a spec validation failure (ref context.py:280-291).
    ValueError covers SSZ range/limit violations that remerkleable surfaces
    differently."""
    bad = False
    try:
        fn()
        bad = True
    except (AssertionError, IndexError, ValueError):
        pass
    if bad:
        raise AssertionError("expected an assertion error, but got none.")


# ---------------------------------------------------------------------------
# Fork / preset matrix (ref context.py:355-551)
# ---------------------------------------------------------------------------

def with_phases(phases: Sequence[str], other_phases: Optional[Sequence[str]] = None):
    """Expand the test over the given forks. In pytest mode all selected
    (and implemented) forks run in sequence; generator mode pins one via
    the `phase` kwarg (ref context.py:355-456)."""

    def deco(fn):
        def entry(*args, **kw):
            from consensus_specs_tpu_torch.specs.build import available_forks

            implemented = set(available_forks())
            # --fork narrows which PRIMARY phases run; auxiliary specs
            # (other_phases, e.g. a transition test's post fork) must stay
            # buildable from any implemented fork or cross-fork tests
            # break under per-fork CI slices
            have = implemented
            if ALLOWED_FORKS is not None:
                have = implemented & set(ALLOWED_FORKS)
            run_phases = [p for p in phases if p in have]
            phase = kw.pop("phase", None)
            if phase is not None:
                if phase not in phases or phase not in have:
                    return None
                run_phases = [phase]
            elif not run_phases:
                # pytest mode with no implemented fork: skip loudly rather
                # than report a vacuous pass
                import pytest

                pytest.skip(f"no implemented fork among {list(phases)}")
            preset = kw.pop("preset", DEFAULT_PRESET)
            targets = {
                f: get_spec(f, preset)
                for f in set(run_phases + [p for p in (other_phases or []) if p in implemented])
            }
            ret = None
            for p in run_phases:
                ret = fn(*args, spec=targets[p], phases=targets, **kw)
            return ret

        entry.fork_matrix = list(phases)
        return copy_meta(entry, fn)

    return deco


def with_all_phases(fn):
    return with_phases(ALL_PHASES)(fn)


def with_all_phases_except(exclusions):
    def deco(fn):
        return with_phases([p for p in ALL_PHASES if p not in exclusions])(fn)

    return deco


def with_altair_and_later(fn):
    return with_phases([p for p in ALL_PHASES if p != PHASE0])(fn)


def with_bellatrix_and_later(fn):
    return with_phases([BELLATRIX, CAPELLA])(fn)


def with_capella_and_later(fn):
    return with_phases([CAPELLA])(fn)


def with_presets(preset_names: Sequence[str], reason: Optional[str] = None):
    """Skip unless the active preset is in the set (ref context.py:459).
    Reads the preset off the already-resolved spec (the `preset` kwarg is
    consumed earlier by with_phases) and raises SkippedTest — pytest mode
    converts it to a pytest.skip, generator mode counts it as skipped."""

    def deco(fn):
        def entry(*args, **kw):
            spec = kw.get("spec")
            preset = spec.preset_base if spec is not None else DEFAULT_PRESET
            if preset not in preset_names:
                from consensus_specs_tpu_torch.exceptions import SkippedTest

                raise SkippedTest(reason or f"preset {preset} not supported")
            return fn(*args, **kw)

        return copy_meta(entry, fn)

    return deco


def with_config_overrides(conf_overrides: Dict[str, Any]):
    """Swap in a config-overridden spec copy; in generator mode the
    modified config is emitted as part of the vectors
    (ref context.py:492-534)."""

    def deco(fn):
        def entry(*args, spec, **kw):
            spec = build_spec(spec.fork, spec.preset_base, conf_overrides)
            return fn(*args, spec=spec, **kw)

        return copy_meta(entry, fn)

    return deco


def only_generator(reason):
    def deco(fn):
        def entry(*args, **kw):
            if not kw.get("generator_mode", False):
                import pytest

                pytest.skip(reason)
            return fn(*args, **kw)

        return copy_meta(entry, fn)

    return deco


def dump_skipping_message(reason: str) -> None:
    import pytest

    pytest.skip(f"[Skipped test] {reason}")
