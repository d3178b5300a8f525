"""States and blocks to drive the phase0 state transition with.

The port's own copy of what it needs from the JAX package's test framework
(``test_framework/{genesis,block,attestations,state}.py``): a genesis
state, the block of the next slot with every committee of the previous slot
attesting in full, and that block with its ``state_root`` filled in.

Keys follow the test framework's convention, privkey(i) = i + 1. Deriving
the public keys from them is pure-Python elliptic-curve work, which does
not scale to a mainnet registry; ``synthetic_pubkeys=True`` draws them from
a seeded ``torch.Generator`` instead. Such a state can only be driven with
``bls.bls_active = False``.
"""
from __future__ import annotations

import torch

from .crypto import bls


def _pubkeys(n: int, synthetic: bool, seed: int) -> list:
    if not synthetic:
        return [bls.SkToPk(i + 1) for i in range(n)]
    g = torch.Generator().manual_seed(seed)
    raw = torch.randint(0, 256, (n, 48), dtype=torch.uint8, generator=g).numpy().tobytes()
    return [raw[48 * i : 48 * i + 48] for i in range(n)]


def genesis(spec, n_validators: int, synthetic_pubkeys: bool = False, seed: int = 0):
    """A genesis state of ``n_validators`` active validators at the maximum
    effective balance, laid out as the test framework's
    ``create_genesis_state`` lays it out (ref: test/helpers/genesis.py).

    No list root is left cached in the state: the first ``hash_tree_root``
    of it hashes the whole registry."""
    deposit_root = b"\x42" * 32
    eth1_block_hash = b"\xda" * 32
    balance = spec.MAX_EFFECTIVE_BALANCE
    validators = [
        spec.Validator(
            pubkey=pk,
            withdrawal_credentials=bytes(spec.BLS_WITHDRAWAL_PREFIX) + spec.hash(pk)[1:],
            activation_eligibility_epoch=spec.GENESIS_EPOCH,
            activation_epoch=spec.GENESIS_EPOCH,
            exit_epoch=spec.FAR_FUTURE_EPOCH,
            withdrawable_epoch=spec.FAR_FUTURE_EPOCH,
            effective_balance=balance,
        )
        for pk in _pubkeys(n_validators, synthetic_pubkeys, seed)
    ]
    state = spec.BeaconState(
        genesis_time=0,
        eth1_deposit_index=n_validators,
        eth1_data=spec.Eth1Data(
            deposit_root=deposit_root, deposit_count=n_validators, block_hash=eth1_block_hash
        ),
        fork=spec.Fork(
            previous_version=spec.config.GENESIS_FORK_VERSION,
            current_version=spec.config.GENESIS_FORK_VERSION,
            epoch=spec.GENESIS_EPOCH,
        ),
        latest_block_header=spec.BeaconBlockHeader(body_root=spec.hash_tree_root(spec.BeaconBlockBody())),
        randao_mixes=[eth1_block_hash] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
        validators=validators,
        balances=[balance] * n_validators,
    )
    # root a copy, so the state's own registry keeps no cached root
    state.genesis_validators_root = spec.hash_tree_root(state.validators.copy())
    return state


def attestations_for_slot(spec, state, slot: int) -> list:
    """Unsigned attestations of every committee of ``slot``, every member
    attesting; ``state`` is past ``slot`` (ref: attestations.py:88-230)."""
    assert state.slot > slot
    epoch = spec.compute_epoch_at_slot(slot)
    block_root = spec.get_block_root_at_slot(state, slot)
    epoch_start = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state))
    if slot < epoch_start:
        source = state.previous_justified_checkpoint
        target_root = spec.get_block_root(state, spec.get_previous_epoch(state))
    else:
        source = state.current_justified_checkpoint
        target_root = block_root if slot == epoch_start else spec.get_block_root(state, spec.get_current_epoch(state))
    out = []
    for index in range(spec.get_committee_count_per_slot(state, epoch)):
        committee = spec.get_beacon_committee(state, slot, index)
        data = spec.AttestationData(
            slot=slot,
            index=index,
            beacon_block_root=block_root,
            source=spec.Checkpoint(epoch=source.epoch, root=source.root),
            target=spec.Checkpoint(epoch=epoch, root=target_root),
        )
        bits = spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE]([1] * len(committee))
        out.append(spec.Attestation(aggregation_bits=bits, data=data))
    return out


def next_block(spec, state, attest: bool = True):
    """Advance ``state`` to the next slot and apply a block there that
    carries the previous slot's attestations (up to ``MAX_ATTESTATIONS``).
    Returns the ``SignedBeaconBlock``, ``state_root`` filled in; ``state``
    ends as its post-state. Signatures are those of privkey(i) = i + 1."""
    slot = state.slot + 1
    spec.process_slots(state, slot)
    proposer = spec.get_beacon_proposer_index(state)
    block = spec.BeaconBlock(
        slot=slot,
        proposer_index=proposer,
        parent_root=spec.hash_tree_root(state.latest_block_header),
    )
    block.body.eth1_data.deposit_count = state.eth1_deposit_index
    block.body.randao_reveal = spec.get_epoch_signature(state, block, proposer + 1)
    if attest:
        for att in attestations_for_slot(spec, state, slot - 1)[: spec.MAX_ATTESTATIONS]:
            block.body.attestations.append(att)
    spec.process_block(state, block)
    block.state_root = spec.hash_tree_root(state)
    return spec.SignedBeaconBlock(message=block, signature=spec.get_block_signature(state, block, proposer + 1))
