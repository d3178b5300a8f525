"""Differential cross-check harness: the interpreted spec is the oracle
for the vectorized engine, exactly as ``crypto/`` is the oracle for
``ops/``.

For every vectorized stage, randomized registry states are run through
BOTH implementations and the post-states must be bit-identical under
``hash_tree_root`` — not "close", not "same balances": the same Merkle
root. The state factory synthesizes registries directly (deterministic
fake pubkeys — epoch processing never opens them), so it is fast enough
for tier-1 CI and independent of the BLS key table.

Randomization deliberately covers the nasty rows: slashed validators at
the exact slashing-penalty epoch, sub-ejection effective balances,
pending activation queues crossing the churn limit, inactivity scores
large enough to overflow a naive uint64 product, leak and non-leak
finality gaps, and (phase0) pending attestations with mixed
target/head matches and duplicate-index inclusion delays.

Run directly for a manual sweep:
    python -m consensus_specs_tpu_torch.engine.crosscheck
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import STAGE_NAMES, SUPPORTED_FORKS, stages
from ..specs import build_spec

MIN_EPOCHS_FOR_REWARDS = 2  # justification/rewards short-circuit below this


def _fake_pubkey(i: int) -> bytes:
    # 48 deterministic bytes; never fed to BLS (epoch stages don't verify)
    return bytes([0xAA]) + i.to_bytes(8, "little") * 5 + bytes(7)


def _random_validator(spec, rng, i: int, current_epoch: int):
    incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    max_eff = int(spec.MAX_EFFECTIVE_BALANCE)
    far = int(spec.FAR_FUTURE_EPOCH)
    epsv = int(spec.EPOCHS_PER_SLASHINGS_VECTOR)

    roll = rng.random()
    if roll < 0.6:
        effective_balance = max_eff
    elif roll < 0.8:
        effective_balance = incr * int(rng.integers(1, max_eff // incr + 1))
    else:  # at/below ejection balance — feeds the exit queue
        effective_balance = incr * int(rng.integers(0, int(spec.config.EJECTION_BALANCE) // incr + 1))

    slashed = bool(rng.random() < 0.15)

    r = rng.random()
    if r < 0.70:
        activation_epoch, eligibility = 0, 0
    elif r < 0.85:  # pending in the activation queue
        activation_epoch = far
        eligibility = far if rng.random() < 0.4 else int(rng.integers(0, current_epoch + 2))
    else:  # scheduled future activation
        activation_epoch = current_epoch + int(rng.integers(1, 6))
        eligibility = int(rng.integers(0, current_epoch + 1))

    r = rng.random()
    if r < 0.70:
        exit_epoch: int = far
        withdrawable = far
    elif r < 0.85:
        exit_epoch = int(rng.integers(max(1, current_epoch - 2), current_epoch + 8))
        withdrawable = exit_epoch + int(spec.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)
    else:
        # long-exited and ALREADY withdrawable — the rows capella's
        # full-withdrawals sweep must actually withdraw
        exit_epoch = int(rng.integers(0, max(1, current_epoch)))
        withdrawable = int(rng.integers(exit_epoch, current_epoch + 1))
    if slashed and rng.random() < 0.5:
        # land exactly on the proportional-penalty epoch
        withdrawable = current_epoch + epsv // 2

    fields = dict(
        pubkey=_fake_pubkey(i),
        withdrawal_credentials=(
            bytes(spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX) + bytes(11) + i.to_bytes(20, "little")
            if rng.random() < 0.5
            else bytes(spec.BLS_WITHDRAWAL_PREFIX) + bytes(31)
        ),
        effective_balance=effective_balance,
        slashed=slashed,
        activation_eligibility_epoch=eligibility,
        activation_epoch=activation_epoch,
        exit_epoch=exit_epoch,
        withdrawable_epoch=withdrawable,
    )
    if "fully_withdrawn_epoch" in spec.Validator._fields:  # capella
        fields["fully_withdrawn_epoch"] = far
    return spec.Validator(**fields)


def _phase0_pending_attestations(spec, state, rng, epoch: int) -> List:
    """Pending attestations with valid committee geometry and a mix of
    target/head matches; bits sized to the real committees."""
    atts = []
    committees_per_slot = int(spec.get_committee_count_per_slot(state, spec.Epoch(epoch)))
    start = int(spec.compute_start_slot_at_epoch(spec.Epoch(epoch)))
    spe = int(spec.SLOTS_PER_EPOCH)
    n = len(state.validators)
    for slot in range(start, min(start + spe, int(state.slot))):
        for index in range(committees_per_slot):
            if rng.random() < 0.3:
                continue
            committee = spec.get_beacon_committee(
                state, spec.Slot(slot), spec.CommitteeIndex(index)
            )
            bits = [bool(rng.random() < 0.6) for _ in committee]
            target_root = (
                spec.get_block_root(state, spec.Epoch(epoch))
                if rng.random() < 0.7
                else bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            )
            head_root = (
                spec.get_block_root_at_slot(state, spec.Slot(slot))
                if rng.random() < 0.7
                else bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            )
            atts.append(
                spec.PendingAttestation(
                    aggregation_bits=spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE](bits),
                    data=spec.AttestationData(
                        slot=slot,
                        index=index,
                        beacon_block_root=head_root,
                        source=state.previous_justified_checkpoint,
                        target=spec.Checkpoint(epoch=epoch, root=target_root),
                    ),
                    inclusion_delay=int(rng.integers(1, spe + 1)),
                    proposer_index=int(rng.integers(0, n)),
                )
            )
    return atts


def random_epoch_state(spec, seed: int = 0, n_validators: int = 80, epoch: int = 3,
                       leak: Optional[bool] = None):
    """A randomized BeaconState positioned at the last slot of ``epoch``
    (where process_epoch fires), registry-axis fields fuzzed."""
    rng = np.random.default_rng(seed)
    spe = int(spec.SLOTS_PER_EPOCH)
    slot = epoch * spe + spe - 1

    state = spec.BeaconState(
        genesis_time=0,
        slot=slot,
        fork=spec.Fork(
            previous_version=spec.config.GENESIS_FORK_VERSION,
            current_version=spec.config.GENESIS_FORK_VERSION,
            epoch=0,
        ),
        latest_block_header=spec.BeaconBlockHeader(
            body_root=spec.hash_tree_root(spec.BeaconBlockBody())
        ),
    )

    for i in range(int(spec.SLOTS_PER_HISTORICAL_ROOT)):
        state.block_roots[i] = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        state.state_roots[i] = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    for i in range(int(spec.EPOCHS_PER_HISTORICAL_VECTOR)):
        state.randao_mixes[i] = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    for i in range(int(spec.EPOCHS_PER_SLASHINGS_VECTOR)):
        if rng.random() < 0.3:
            state.slashings[i] = int(rng.integers(0, 64)) * int(spec.EFFECTIVE_BALANCE_INCREMENT)

    incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    for i in range(n_validators):
        v = _random_validator(spec, rng, i, epoch)
        state.validators.append(v)
        state.balances.append(
            min(int(v.effective_balance) + int(rng.integers(0, 2 * incr)), 2**62)
        )

    # Finality plumbing: leak=True opens the inactivity-leak gap wide,
    # leak=False keeps finality fresh, None randomizes.
    if leak is True:
        finalized_epoch = 0
    elif leak is False:
        finalized_epoch = max(0, epoch - 2)
    else:
        finalized_epoch = int(rng.integers(0, max(1, epoch - 1)))
    root_of = lambda e: spec.get_block_root(state, spec.Epoch(e)) if e < epoch else b"\x00" * 32  # noqa: E731
    state.finalized_checkpoint = spec.Checkpoint(
        epoch=finalized_epoch, root=root_of(finalized_epoch)
    )
    pj = int(rng.integers(finalized_epoch, epoch))
    cj = int(rng.integers(pj, epoch))
    state.previous_justified_checkpoint = spec.Checkpoint(epoch=pj, root=root_of(pj))
    state.current_justified_checkpoint = spec.Checkpoint(epoch=cj, root=root_of(cj))
    for i in range(int(spec.JUSTIFICATION_BITS_LENGTH)):
        state.justification_bits[i] = bool(rng.random() < 0.5)

    if hasattr(state, "previous_epoch_participation"):  # altair family
        flags = rng.integers(0, 8, n_validators, dtype=np.uint8)
        state.previous_epoch_participation = [int(f) for f in flags]
        flags = rng.integers(0, 8, n_validators, dtype=np.uint8)
        state.current_epoch_participation = [int(f) for f in flags]
        scores = rng.integers(0, 1 << 20, n_validators).astype(object)
        # a few rows large enough that effective_balance * score wraps a
        # naive uint64 product (forcing the guarded-multiply fallback)
        # while the resulting PENALTY still fits Gwei — scores past that
        # make the interpreted oracle itself raise, i.e. unreachable states
        for i in rng.choice(n_validators, size=max(1, n_validators // 16), replace=False):
            scores[i] = int(rng.integers(1 << 34, 1 << 40))
        state.inactivity_scores = [int(s) for s in scores]
    else:  # phase0: pending attestations drive the accounting
        state.previous_epoch_attestations = _phase0_pending_attestations(
            spec, state, rng, epoch - 1
        )
        state.current_epoch_attestations = _phase0_pending_attestations(
            spec, state, rng, epoch
        )
    return state


def stages_for(spec) -> List[str]:
    return [n for n in STAGE_NAMES if hasattr(spec, n)]


def crosscheck_stage(spec, name: str, state) -> Tuple[bool, str, str]:
    """(identical?, interpreted root, vectorized root) for one stage on
    one state. Unwraps an installed engine so the oracle side is always
    the interpreted spec function."""
    current = getattr(spec, name)
    interpreted = getattr(current, "__wrapped__", current)
    vectorized = getattr(stages, f"vectorized_{name}")
    a, b = state.copy(), state.copy()
    interpreted(a)
    vectorized(spec, b)
    ra, rb = bytes(a.hash_tree_root()), bytes(b.hash_tree_root())
    return ra == rb, ra.hex(), rb.hex()


def run_crosscheck(forks: Sequence[str] = SUPPORTED_FORKS, preset: str = "minimal",
                   seeds: Sequence[int] = (0, 1), n_validators: int = 80,
                   epochs: Sequence[int] = (3, 6)) -> Dict:
    """Sweep every stage x fork x seed x epoch; returns a report with any
    divergences under ``failures``."""
    checked, failures = 0, []
    for fork in forks:
        spec = build_spec(fork, preset)
        for seed in seeds:
            for epoch in epochs:
                for leak in (False, True):
                    state = random_epoch_state(
                        spec, seed=seed, n_validators=n_validators, epoch=epoch, leak=leak
                    )
                    for name in stages_for(spec):
                        same, ra, rb = crosscheck_stage(spec, name, state)
                        checked += 1
                        if not same:
                            failures.append(
                                {"fork": fork, "stage": name, "seed": seed,
                                 "epoch": epoch, "leak": leak,
                                 "interpreted": ra, "vectorized": rb}
                            )
    return {"checked": checked, "failures": failures}


def main() -> int:
    report = run_crosscheck()
    print(f"crosscheck: {report['checked']} stage runs, "
          f"{len(report['failures'])} divergences")
    for f in report["failures"]:
        print(f"DIVERGED {f['fork']}/{f['stage']} seed={f['seed']} epoch={f['epoch']} "
              f"leak={f['leak']}: {f['interpreted']} != {f['vectorized']}")
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
