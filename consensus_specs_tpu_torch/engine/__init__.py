"""Vectorized state-transition engine: structure-of-arrays epoch
processing behind the compiled spec modules.

The port's copy of the JAX package's engine, for the forks the port
builds (phase0, altair, bellatrix and capella). The crypto plane (BLS,
SHA-256) runs as batched kernels on the card; this subsystem is the
protocol plane's batching layer:

- :mod:`plane` — ``StatePlane``, the SoA mirror of BeaconState's
  registry-axis columns, with exact (overflow-guarded) uint64 helpers
  and sparse write-back that preserves SSZ dirty-tracking.
- :mod:`stages` — vectorized ``process_*`` implementations of the hot
  epoch sub-transitions across the production fork families (phase0 /
  altair / bellatrix / capella, with capella's full-withdrawals sweep).
- :mod:`attestations` — committee resolution in array form, plus the
  batched block-path ``process_attestations_batch`` installed by
  :func:`use_batched_attestations` (sequentially exact, incl.
  rejection order — the chain simulator's hot loop, docs/SIM.md).
- :mod:`backend` / :mod:`ops_torch` — the NumPy-always / torch-opt-in
  backend hook, the ``ops/`` convention applied to protocol math: the
  altair flag deltas as K10 ``flag_deltas`` on the card.
- :mod:`crosscheck` — the differential harness that holds every stage
  to hash_tree_root bit-identity against the interpreted oracle on
  randomized states (epoch processing on the host reference path is the
  oracle here, exactly as ``crypto/`` is the oracle for ``ops/``).

Install model: ``use_vectorized_epoch()`` swaps the stage functions in
every built (and every future) spec module via the specs.build module
hook — the same switchable-backend shape as ``use_device_hasher()`` and
``bls.use_backend("torch")``. Wrappers keep the interpreted function on
``__wrapped__`` and preserve ``__name__`` so ``epoch_process_steps()``
staging, generators, and the replayer see the same public surface
either way. ``use_interpreted_epoch()`` restores the originals. Unlike
the JAX package's, these wrappers open no observability spans.
"""
from __future__ import annotations

from typing import Dict

from ..specs import build as _build
from . import stages
from .backend import active as backend_name  # noqa: F401  (public surface)
from .backend import use_backend

__all__ = [
    "use_vectorized_epoch",
    "use_interpreted_epoch",
    "use_batched_attestations",
    "use_direct_attestations",
    "use_backend",
    "backend_name",
    "STAGE_NAMES",
    "SUPPORTED_FORKS",
]

# The hot registry-axis sub-transitions with SoA implementations.
# process_full_withdrawals exists only on the capella family; _install_on
# skips the name on spec modules that lack it.
STAGE_NAMES = (
    "process_justification_and_finalization",
    "process_rewards_and_penalties",
    "process_inactivity_updates",
    "process_effective_balance_updates",
    "process_registry_updates",
    "process_slashings",
    "process_full_withdrawals",
)

# The forks the port builds (its specs/build.FORK_ORDER).
SUPPORTED_FORKS = ("phase0", "altair", "bellatrix", "capella")

def _wrap_stage(spec, name: str):
    impl = getattr(stages, f"vectorized_{name}")
    interpreted = getattr(spec, name)

    def wrapped(state):
        return impl(spec, state)

    wrapped.__name__ = name
    wrapped.__qualname__ = f"engine.{name}[{spec.fork}]"
    wrapped.__doc__ = interpreted.__doc__
    wrapped.__wrapped__ = interpreted
    wrapped.engine_vectorized = True
    return wrapped


def _install_on(spec) -> None:
    """specs.build module hook: swap stage functions on one module."""
    if getattr(spec, "fork", None) not in SUPPORTED_FORKS:
        return
    for name in STAGE_NAMES:
        current = getattr(spec, name, None)
        if current is None or getattr(current, "engine_vectorized", False):
            continue
        setattr(spec, name, _wrap_stage(spec, name))


def _uninstall_from(spec) -> None:
    for name in STAGE_NAMES:
        current = getattr(spec, name, None)
        if current is not None and getattr(current, "engine_vectorized", False):
            setattr(spec, name, current.__wrapped__)


def use_vectorized_epoch() -> None:
    """Route the hot epoch stages of every built (and future) spec module
    through the SoA engine. Idempotent."""
    _build.register_module_hook(_install_on)


def use_interpreted_epoch() -> None:
    """Restore the interpreted spec functions everywhere. Idempotent."""
    _build.unregister_module_hook(_install_on)
    for mod in _build.cached_modules():
        _uninstall_from(mod)


# ---------------------------------------------------------------------------
# Batched block-path attestations (engine/attestations.py)
# ---------------------------------------------------------------------------

def _wrap_process_operations(spec):
    from .attestations import process_attestations_batch

    interpreted = spec.process_operations

    def wrapped(state, body):
        # the fork modules share this operation ORDER (capella appends
        # one op family); the attestation sweep is the batched path
        assert len(body.deposits) == min(
            spec.MAX_DEPOSITS,
            state.eth1_data.deposit_count - state.eth1_deposit_index,
        )
        for op in body.proposer_slashings:
            spec.process_proposer_slashing(state, op)
        for op in body.attester_slashings:
            spec.process_attester_slashing(state, op)
        process_attestations_batch(spec, state, body.attestations)
        for op in body.deposits:
            spec.process_deposit(state, op)
        for op in body.voluntary_exits:
            spec.process_voluntary_exit(state, op)
        if hasattr(body, "bls_to_execution_changes"):  # capella family
            for op in body.bls_to_execution_changes:
                spec.process_bls_to_execution_change(state, op)

    wrapped.__name__ = "process_operations"
    wrapped.__qualname__ = f"engine.process_operations[{spec.fork}]"
    wrapped.__doc__ = interpreted.__doc__
    wrapped.__wrapped__ = interpreted
    wrapped.engine_batched_atts = True
    return wrapped


def _install_batched_atts_on(spec) -> None:
    if getattr(spec, "fork", None) not in SUPPORTED_FORKS:
        return
    current = getattr(spec, "process_operations", None)
    if current is None or getattr(current, "engine_batched_atts", False):
        return
    spec.process_operations = _wrap_process_operations(spec)


def use_batched_attestations() -> None:
    """Route every built (and future) spec module's block-body
    attestation sweep through the batched committee-cached path
    (engine/attestations.process_attestations_batch). Idempotent."""
    _build.register_module_hook(_install_batched_atts_on)


def use_direct_attestations() -> None:
    """Restore the interpreted per-attestation loop everywhere."""
    _build.unregister_module_hook(_install_batched_atts_on)
    for mod in _build.cached_modules():
        current = getattr(mod, "process_operations", None)
        if current is not None and getattr(current, "engine_batched_atts", False):
            mod.process_operations = current.__wrapped__


def stage_status(spec) -> Dict[str, bool]:
    """{stage name: engine-installed?} for one spec module (diagnostics)."""
    return {
        name: getattr(getattr(spec, name, None), "engine_vectorized", False)
        for name in STAGE_NAMES
        if hasattr(spec, name)
    }
