"""States and blocks to drive the phase0, altair, bellatrix and capella
state transitions with.

The port's own copy of what it needs from the JAX package's test framework
(``test_framework/{genesis,block,attestations,state,multi_operations,
bls_to_execution_changes}.py``; its execution payloads come from the
port's ``test_framework/execution_payload.py``): a genesis state (altair
and later: with its participation columns, inactivity scores and both sync
committees; bellatrix and later: an execution payload header, the default
one or, ``post_merge``, that of an empty payload, as after the merge), a
withdrawing set of exited validators on eth1 credentials drawn from a seed
(capella), the block of the next slot with every committee of the previous
slot attesting (altair and later: and the sync committee's aggregate;
bellatrix and later: an empty execution payload, on capella carrying the
expected withdrawals; capella: signed BLS-to-execution changes), and that
block with its ``state_root`` filled in; participation columns drawn from a
seed; a runner that applies a block with its signature checks deferred
into one batched flush (the vector generator's ``--bls-defer`` pattern);
and, for the R&D forks, KZG commitments and proofs made from the
development setup's public secret.

Keys follow the test framework's convention, privkey(i) = i + 1, so
pubkey(i) = (i + 1) G1. ``pubkeys(n)`` derives them at registry scale by
batched affine additions on the host (a few microseconds a key, where
``SkToPk`` costs a scalar multiplication) and keeps them under
``build/keys/``. ``synthetic_pubkeys=True`` draws random bytes instead, for
states driven with ``bls.bls_active = False``.

Signed blocks (``sign=True``) carry real signatures: the proposer's and
the randao reveal, each BLS-to-execution change by its validator's key,
and each attestation signed once by the sum of its members' secret keys
mod r, which gives the same bytes as ``Aggregate`` of the members'
signatures (a signature is linear in the key) at the cost of one ``Sign``;
the sync aggregate likewise, by the sum over its participating seats (a
validator sampled into two seats counts twice, as it does in
``FastAggregateVerify``).
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .crypto import bls, fr, kzg
from .crypto.bls import ciphersuite
from .crypto.bls.curve import G1_X, G1_Y, DeserializationError, g1_from_bytes, g1_generator, g1_to_bytes
from .crypto.bls.fields import P, R
from .test_framework.execution_payload import build_empty_execution_payload, get_execution_payload_header

KEY_DIR = Path(__file__).resolve().parents[1] / "build" / "keys"
_TABLE = 1024  # keys per run of the batched additions


def _affine_add(p1, p2):
    """Affine sum of two non-opposite points (host ints)."""
    (x1, y1), (x2, y2) = p1, p2
    if p1 == p2:
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _compress(x: int, y: int) -> bytes:
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if y > (P - 1) // 2 else 0)
    return bytes(out)


def _derive_pubkeys(n: int) -> bytes:
    """(i + 1) G1 for i < n, compressed and concatenated. With T = 1024,
    (k T + j) G = (k T) G + j G: the j G and k T G tables are successive
    additions, and every other key is one addition whose inversion is
    shared across the batch (Montgomery's trick)."""
    g = (int(G1_X), int(G1_Y))
    small = [g]  # j G for j = 1..T
    for _ in range(_TABLE - 1):
        small.append(_affine_add(small[-1], g))
    big = [None, small[-1]]  # k T G
    for _ in range(2, n // _TABLE + 1):
        big.append(_affine_add(big[-1], small[-1]))
    pts = list(small[: min(n, _TABLE)])
    pairs = [(big[(i + 1) // _TABLE], small[(i + 1) % _TABLE - 1]) for i in range(_TABLE, n)]
    # a key index (i + 1) that is a multiple of T is exactly k T G
    exact = [(i + 1) % _TABLE == 0 for i in range(_TABLE, n)]
    dens = [1 if e else (q[0] - b[0]) % P for (b, q), e in zip(pairs, exact)]
    prefix, acc = [], 1
    for d in dens:
        prefix.append(acc)
        acc = acc * d % P
    inv = pow(acc, -1, P)
    invs = [0] * len(dens)
    for i in range(len(dens) - 1, -1, -1):
        invs[i] = inv * prefix[i] % P
        inv = inv * dens[i] % P
    for (b, q), e, dinv, i in zip(pairs, exact, invs, range(_TABLE, n)):
        if e:
            pts.append(big[(i + 1) // _TABLE])
            continue
        lam = (q[1] - b[1]) * dinv % P
        x3 = (lam * lam - b[0] - q[0]) % P
        pts.append((x3, (lam * (b[0] - x3) - b[1]) % P))
    return b"".join(_compress(x, y) for x, y in pts)


def pubkeys(n: int) -> list:
    """The compressed pubkeys of privkeys 1..n, derived once and kept
    under ``build/keys/``."""
    path = KEY_DIR / f"pubkeys_{n}.bin"
    if path.exists() and path.stat().st_size == 48 * n:
        raw = path.read_bytes()
    else:
        raw = _derive_pubkeys(n)
        KEY_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")  # concurrent writers each rename a whole file
        tmp.write_bytes(raw)
        tmp.replace(path)
    return [raw[48 * i : 48 * i + 48] for i in range(n)]


def _pubkeys(n: int, synthetic: bool, seed: int) -> list:
    if not synthetic:
        return pubkeys(n)
    g = torch.Generator().manual_seed(seed)
    raw = torch.randint(0, 256, (n, 48), dtype=torch.uint8, generator=g).numpy().tobytes()
    return [raw[48 * i : 48 * i + 48] for i in range(n)]


def _fork_versions(spec) -> tuple:
    """(previous_version, current_version) of a test genesis state of the
    spec's fork (ref: test/helpers/genesis.py:20-40)."""
    cfg = spec.config
    return {"phase0": (cfg.GENESIS_FORK_VERSION, cfg.GENESIS_FORK_VERSION),
            "altair": (cfg.GENESIS_FORK_VERSION, cfg.ALTAIR_FORK_VERSION),
            "bellatrix": (cfg.ALTAIR_FORK_VERSION, cfg.BELLATRIX_FORK_VERSION),
            "capella": (cfg.BELLATRIX_FORK_VERSION, cfg.CAPELLA_FORK_VERSION)}[spec.fork]


def genesis(spec, n_validators: int, synthetic_pubkeys: bool = False, seed: int = 0, post_merge: bool = False):
    """A genesis state of ``n_validators`` active validators at the maximum
    effective balance, laid out as the test framework's
    ``create_genesis_state`` lays it out (ref: test/helpers/genesis.py).

    phase0: no list root is left cached in the state, so the first
    ``hash_tree_root`` of it hashes the whole registry. altair and later:
    empty participation columns and inactivity scores, and both sync
    committees from the spec's ``get_next_sync_committee`` (its keys
    aggregated by ``eth_aggregate_pubkeys``, which needs real keys); it
    roots the registry, as the committee's active set does. bellatrix and
    later: the default execution payload header, or with ``post_merge``
    the header of an empty payload on it, so that the merge is complete
    (ref: execution_payload.py ``build_state_with_complete_transition``).
    capella: every ``fully_withdrawn_epoch`` at FAR_FUTURE_EPOCH."""
    deposit_root = b"\x42" * 32
    eth1_block_hash = b"\xda" * 32
    balance = spec.MAX_EFFECTIVE_BALANCE
    capella = {"fully_withdrawn_epoch": spec.FAR_FUTURE_EPOCH} if hasattr(spec, "Withdrawal") else {}
    validators = [
        spec.Validator(
            pubkey=pk,
            withdrawal_credentials=bytes(spec.BLS_WITHDRAWAL_PREFIX) + spec.hash(pk)[1:],
            activation_eligibility_epoch=spec.GENESIS_EPOCH,
            activation_epoch=spec.GENESIS_EPOCH,
            exit_epoch=spec.FAR_FUTURE_EPOCH,
            withdrawable_epoch=spec.FAR_FUTURE_EPOCH,
            effective_balance=balance,
            **capella,
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
            previous_version=_fork_versions(spec)[0],
            current_version=_fork_versions(spec)[1],
            epoch=spec.GENESIS_EPOCH,
        ),
        latest_block_header=spec.BeaconBlockHeader(body_root=spec.hash_tree_root(spec.BeaconBlockBody())),
        randao_mixes=[eth1_block_hash] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
        validators=validators,
        balances=[balance] * n_validators,
    )
    # root a copy, so the state's own registry keeps no cached root
    state.genesis_validators_root = spec.hash_tree_root(state.validators.copy())
    if hasattr(state, "inactivity_scores"):
        state.previous_epoch_participation = [0] * n_validators
        state.current_epoch_participation = [0] * n_validators
        state.inactivity_scores = [0] * n_validators
        state.current_sync_committee = spec.get_next_sync_committee(state)
        # the state has not changed, so the spec's second call gives the same committee
        state.next_sync_committee = state.current_sync_committee.copy()
    if post_merge:
        state.latest_execution_payload_header = get_execution_payload_header(
            spec, build_empty_execution_payload(spec, state))
    return state


def draw_withdrawing(spec, state, seed: int, count: int, epoch: int) -> list:
    """Make ``count`` validators, drawn from ``seed``, a withdrawal backlog
    (capella): 0x01 (eth1-address) credentials, an exit at ``epoch`` and
    withdrawable from it, so that capella's full-withdrawals sweep takes
    them at the end of ``epoch`` (``withdrawable_epoch <= epoch``) and not
    before. The spec's delay from exit to withdrawability
    (``MIN_VALIDATOR_WITHDRAWABILITY_DELAY`` epochs) is not kept, so that a
    chain from genesis reaches the sweep. Returns their indices, ascending."""
    rng = np.random.default_rng([seed, 2])
    indices = sorted(int(i) for i in rng.choice(len(state.validators), size=count, replace=False))
    for i in indices:
        validator = state.validators[i]
        validator.withdrawal_credentials = (
            bytes(spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX) + b"\x00" * 11 + i.to_bytes(20, "little"))
        validator.exit_epoch = epoch
        validator.withdrawable_epoch = epoch
    return indices


def address_change(spec, state, index: int, sign: bool = False):
    """The ``SignedBLSToExecutionChange`` of validator ``index`` (capella),
    whose withdrawal credentials are still those of its own key (0x00 and
    the hash of ``pubkey(index)``): to the address 0x42..42, signed with
    privkey index + 1 (ref: bls_to_execution_changes.py
    ``get_signed_address_change``). With ``sign`` a real signature;
    otherwise ``bls.Sign``'s, zeros while BLS is off."""
    change = spec.BLSToExecutionChange(
        validator_index=index, from_bls_pubkey=state.validators[index].pubkey, to_execution_address=b"\x42" * 20)
    root = spec.compute_signing_root(change, spec.get_domain(state, spec.DOMAIN_BLS_TO_EXECUTION_CHANGE))
    signature = ciphersuite.Sign(index + 1, root) if sign else bls.Sign(index + 1, root)
    return spec.SignedBLSToExecutionChange(message=change, signature=signature)


def address_changers(spec, state, seed: int, count: int) -> list:
    """``count`` distinct validators, drawn from ``seed`` and the slot,
    whose credentials are still BLS ones (0x00): those that may send a
    BLS-to-execution change. Draws and checks a validator at a time, not a
    pass over the registry."""
    rng = np.random.default_rng([seed, int(state.slot), 3])
    prefix = bytes(spec.BLS_WITHDRAWAL_PREFIX)
    chosen: list = []
    n = len(state.validators)
    for _ in range(64 * count + 64):
        if len(chosen) == count:
            break
        i = int(rng.integers(n))
        if i not in chosen and bytes(state.validators[i].withdrawal_credentials)[:1] == prefix:
            chosen.append(i)
    assert len(chosen) == count, f"found {len(chosen)} of {count} validators on BLS credentials"
    return chosen


def draw_participation(spec, state, seed: int, rate: float = 0.95) -> None:
    """Set both epochs' participation columns from ``seed``: each of a
    validator's three flags independently with probability ``rate``."""
    rng = np.random.default_rng([seed, int(state.slot)])
    n = len(state.validators)
    for name in ("previous_epoch_participation", "current_epoch_participation"):
        flags = sum((rng.random(n) < rate).astype(np.uint8) << f for f in range(3))
        setattr(state, name, flags.tolist())


def _first_indices(state) -> dict:
    """pubkey -> its first index in the registry."""
    first: dict = {}
    for index, validator in enumerate(state.validators):
        first.setdefault(bytes(validator.pubkey), index)
    return first


def sync_aggregate_for_slot(spec, state, seed: int, sign: bool = True, message=None):
    """The ``SyncAggregate`` of a block at ``state.slot``: the current sync
    committee's seats, a ~1/16 of them (drawn from ``seed`` and the slot)
    left off, as a healthy mainnet committee shows, signing the previous
    slot's block root. With ``sign`` one ``Sign`` by the sum of the
    participating seats' secret keys (``message``: over that instead of the
    signing root); otherwise the infinity point."""
    rng = np.random.default_rng([seed, int(state.slot), 1])
    bits = (rng.random(int(spec.SYNC_COMMITTEE_SIZE)) >= 1 / 16).tolist()
    signature = spec.G2_POINT_AT_INFINITY
    if sign and any(bits):
        previous_slot = max(int(state.slot), 1) - 1
        domain = spec.get_domain(state, spec.DOMAIN_SYNC_COMMITTEE, spec.compute_epoch_at_slot(previous_slot))
        root = spec.compute_signing_root(spec.get_block_root_at_slot(state, previous_slot), domain)
        first = _first_indices(state)
        key = sum(first[bytes(pk)] + 1 for pk, bit in zip(state.current_sync_committee.pubkeys, bits) if bit)
        signature = ciphersuite.Sign(key % R, root if message is None else message)
    return spec.SyncAggregate(sync_committee_bits=bits, sync_committee_signature=signature)


def attestations_for_slot(spec, state, slot: int, split: bool = False, sign: bool = False) -> list:
    """Attestations of every committee of ``slot``, every member attesting;
    ``state`` is past ``slot`` (ref: attestations.py:88-230). ``split``
    makes two aggregates of each committee, of its disjoint halves;
    ``sign`` signs each with the sum of its members' keys."""
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
        n = len(committee)
        halves = [(0, n // 2), (n // 2, n)] if split and n > 1 else [(0, n)]
        root = spec.compute_signing_root(data, spec.get_domain(state, spec.DOMAIN_BEACON_ATTESTER, epoch)) \
            if sign else None
        for lo, hi in halves:
            bits = spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE]([lo <= i < hi for i in range(n)])
            att = spec.Attestation(aggregation_bits=bits, data=data)
            if sign:
                att.signature = ciphersuite.Sign(sum(int(committee[i]) + 1 for i in range(lo, hi)) % R, root)
            out.append(att)
    return out


def next_block(spec, state, attest: bool = True, split: bool = False, sign: bool = False, seed: int = 0,
               changes=None):
    """Advance ``state`` to the next slot and apply a block there that
    carries the previous slot's attestations (up to ``MAX_ATTESTATIONS``;
    ``split``: two per committee) and, on altair and later, the sync
    aggregate of ``sync_aggregate_for_slot`` (its bits from ``seed``); on
    bellatrix and later ``build_empty_execution_payload``; on capella ``changes``
    BLS-to-execution changes (default ``MAX_BLS_TO_EXECUTION_CHANGES``) of
    the validators ``address_changers`` draws from ``seed``. Returns the
    ``SignedBeaconBlock``, ``state_root`` filled in; ``state`` ends as its
    post-state.

    With ``sign`` every signature is real (privkey(i) = i + 1), made with
    the host ciphersuite whatever ``bls.bls_active`` says; otherwise the
    signatures come from ``bls.Sign``, zeros while BLS is off."""
    slot = state.slot + 1
    spec.process_slots(state, slot)
    proposer = spec.get_beacon_proposer_index(state)
    block = spec.BeaconBlock(
        slot=slot,
        proposer_index=proposer,
        parent_root=spec.hash_tree_root(state.latest_block_header),
    )
    block.body.eth1_data.deposit_count = state.eth1_deposit_index
    epoch = spec.compute_epoch_at_slot(slot)
    if sign:
        domain = spec.get_domain(state, spec.DOMAIN_RANDAO, epoch)
        block.body.randao_reveal = ciphersuite.Sign(proposer + 1, spec.compute_signing_root(spec.uint64(epoch), domain))
    else:
        block.body.randao_reveal = spec.get_epoch_signature(state, block, proposer + 1)
    if attest:
        for att in attestations_for_slot(spec, state, slot - 1, split, sign)[: spec.MAX_ATTESTATIONS]:
            block.body.attestations.append(att)
    if hasattr(block.body, "sync_aggregate"):
        block.body.sync_aggregate = sync_aggregate_for_slot(spec, state, seed, sign)
    if hasattr(block.body, "execution_payload"):
        block.body.execution_payload = build_empty_execution_payload(spec, state)
    if hasattr(block.body, "bls_to_execution_changes"):
        count = spec.MAX_BLS_TO_EXECUTION_CHANGES if changes is None else changes
        for i in address_changers(spec, state, seed, count):
            block.body.bls_to_execution_changes.append(address_change(spec, state, i, sign))
    with _checks_off():
        spec.process_block(state, block)
    block.state_root = spec.hash_tree_root(state)
    if sign:
        return sign_block(spec, state, block)
    return spec.SignedBeaconBlock(message=block, signature=spec.get_block_signature(state, block, proposer + 1))


def sign_block(spec, state, block):
    """The block with its proposer's real signature; ``state`` is at the
    block's epoch."""
    domain = spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER, spec.compute_epoch_at_slot(block.slot))
    signature = ciphersuite.Sign(int(block.proposer_index) + 1, spec.compute_signing_root(block, domain))
    return spec.SignedBeaconBlock(message=block, signature=signature)


def tampered_copy(spec, post_state, signed_block, index: int, message: bytes = b"\x42" * 32):
    """A copy of a signed block whose attestation ``index`` is signed by
    the same keys over another ``message``, with its ``state_root`` and
    proposer signature made anew: of its signature checks exactly that
    attestation's fails. ``post_state`` is the block's post-state; the
    copy's differs from it only in the block header's body root."""
    block = signed_block.message.copy()
    att = block.body.attestations[index]
    members = spec.get_attesting_indices(post_state, att.data, att.aggregation_bits)
    att.signature = ciphersuite.Sign(sum(int(i) + 1 for i in members) % R, message)
    return _resealed(spec, post_state, signed_block, block)


def tampered_sync_copy(spec, post_state, signed_block, seed: int, message: bytes = b"\x42" * 32):
    """The same for the block's sync aggregate (altair): the same seats
    (``seed`` as the block was built with) signing ``message``."""
    block = signed_block.message.copy()
    header = post_state.latest_block_header
    assert header.slot == block.slot
    block.body.sync_aggregate = sync_aggregate_for_slot(spec, post_state, seed, message=message)
    assert block.body.sync_aggregate.sync_committee_bits == signed_block.message.body.sync_aggregate.sync_committee_bits
    return _resealed(spec, post_state, signed_block, block)


def tampered_change_copy(spec, post_state, signed_block, index: int, message: bytes = b"\x42" * 32):
    """The same for the block's BLS-to-execution change ``index`` (capella):
    signed by its validator's key over ``message``."""
    block = signed_block.message.copy()
    change = block.body.bls_to_execution_changes[index]
    change.signature = ciphersuite.Sign(int(change.message.validator_index) + 1, message)
    return _resealed(spec, post_state, signed_block, block)


def _resealed(spec, post_state, signed_block, block):
    """``block`` (a changed body of ``signed_block``'s, with the same effect
    on the state) with its ``state_root`` and proposer signature made anew."""
    header = post_state.latest_block_header
    body_root = header.body_root
    header.body_root = spec.hash_tree_root(block.body)
    block.state_root = spec.hash_tree_root(post_state)
    header.body_root = body_root
    assert spec.hash_tree_root(post_state) == signed_block.message.state_root
    return sign_block(spec, post_state, block)


class _checks_off:
    """Build blocks without verifying their signatures (the caller signed
    them): ``bls.bls_active`` off for the duration."""

    def __enter__(self):
        self.prev, bls.bls_active = bls.bls_active, False

    def __exit__(self, *exc):
        bls.bls_active = self.prev


def apply_block_deferred(spec, state, signed_block, pre_state=None, verifier=None) -> "bls.DeferredVerifier":
    """``state_transition`` with every signature check deferred, then ONE
    flush through the active BLS backend (of ``verifier``, when given: the
    checks an earlier flush of it resolved are not sent again). Returns
    the verifier when every check of this block holds; ``state`` is then
    the post-state.

    When a check fails, the block is invalid and this raises: with
    ``pre_state`` (a copy of the state before the block) the transition
    is replayed there with the true answers, so that the spec itself
    raises where the failing check sits; without it, AssertionError.
    ``state`` is left part-way either way."""
    verifier = verifier if verifier is not None else bls.DeferredVerifier()
    start = verifier.mark()
    with bls.deferring(verifier):
        spec.state_transition(state, signed_block, validate_result=True)
    verifier.flush()
    if verifier.all_true(start, verifier.mark()):
        return verifier
    if pre_state is not None:
        with bls.replaying(verifier.table()):
            spec.state_transition(pre_state, signed_block, validate_result=True)
        raise AssertionError("a signature check failed, but the replayed transition accepted the block")
    raise AssertionError(f"{verifier.results[start:].count(False)} signature check(s) failed")


# -- KZG fixtures (the R&D forks) ----------------------------------------------
#
# Commitments and proofs from the development setup's public secret s
# (crypto/kzg._INSECURE_SECRET), one G1 scalar multiplication each: the same
# points that crypto/kzg's commit / open_single / open_multi build with a
# whole MSM over [s^i]G1, since that MSM is [p(s)]G1 for any polynomial p.

def _g1_at(value: int) -> bytes:
    return g1_to_bytes(g1_generator().mul(value % fr.MODULUS))


def kzg_secret() -> int:
    return kzg._INSECURE_SECRET


def random_polynomial(rng: np.random.Generator, degree_bound: int) -> list:
    """``degree_bound`` random coefficients of Fr, lowest first."""
    return [int.from_bytes(rng.bytes(32), "big") % fr.MODULUS for _ in range(degree_bound)]


def kzg_commitment(coeffs) -> bytes:
    """[p(s)]G1: ``kzg.commit(coeffs, setup)``'s bytes."""
    return _g1_at(fr.poly_eval(coeffs, kzg_secret()))


def kzg_single_proof(coeffs, x: int) -> tuple:
    """(y, proof) with y = p(x) and proof [(p(s) - y) / (s - x)]G1:
    ``kzg.open_single(coeffs, x, setup)``."""
    s, x = kzg_secret(), x % fr.MODULUS
    assert x != s, "the opened point is the setup's secret"
    y = fr.poly_eval(coeffs, x)
    return y, _g1_at((fr.poly_eval(coeffs, s) - y) * pow(s - x, fr.MODULUS - 2, fr.MODULUS))


def kzg_coset_proof(coeffs, xs) -> tuple:
    """(ys, proof) opening p at every x of ``xs``: proof [(p(s) - I(s)) /
    Z(s)]G1, I interpolating (xs, ys) and Z vanishing on xs:
    ``kzg.open_multi(coeffs, xs, setup)``."""
    s = kzg_secret()
    ys = [fr.poly_eval(coeffs, x) for x in xs]
    z = 1
    for x in xs:
        z = z * (s - x) % fr.MODULUS
    assert z != 0, "the setup's secret is in the opened domain"
    i_at_s = fr.poly_eval(fr.interpolate_on_domain(list(xs), ys), s)
    return ys, _g1_at((fr.poly_eval(coeffs, s) - i_at_s) * pow(z, fr.MODULUS - 2, fr.MODULUS))


def degree_proof(coeffs, points_count: int, setup_size: int) -> bytes:
    """The sharding degree proof of a polynomial B of fewer than
    ``points_count`` coefficients: [B(s) s^(setup_size - points_count)]G1,
    which pairs with G2_SETUP[-points_count] as the commitment does with
    G2_SETUP[0] (specs/sharding.py ``verify_degree_proof``)."""
    s = kzg_secret()
    return _g1_at(fr.poly_eval(coeffs, s) * pow(s, setup_size - points_count, fr.MODULUS))


def off_curve_g1_bytes(start: int = 1) -> bytes:
    """A compressed G1 encoding, flags valid and x below p, whose x is no
    point's: x^3 + 4 is not a square (the first such x from ``start``)."""
    x = start
    while True:
        data = bytes([0x80 | (x >> 376)]) + (x % (1 << 376)).to_bytes(47, "big")
        try:
            g1_from_bytes(data)
        except DeserializationError:
            return data
        x += 1
