"""The port's epoch engine (consensus_specs_tpu_torch/engine/) against the
JAX package's engine and the interpreted spec: the same seeded random
states in both packages, every stage bit-identical under hash_tree_root,
and the flag-delta arithmetic of the torch backend (K10's plain version on
the CPU) equal to ``ops_jax.flag_deltas`` (JAX on the CPU, x64) and to the
numpy branch, column for column. K10 itself runs only on the card
(tests/test_torch_cuda.py)."""
import importlib.util
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import consensus_specs_tpu
from consensus_specs_tpu import engine as jengine
from consensus_specs_tpu.engine import crosscheck as jcross
from consensus_specs_tpu.engine import stages as jstages
from consensus_specs_tpu.specs import build_spec as jbuild
from consensus_specs_tpu_torch import engine
from consensus_specs_tpu_torch.engine import backend, crosscheck, ops_torch, stages
from consensus_specs_tpu_torch.engine import delta_checks as dc
from consensus_specs_tpu_torch.specs import build_spec as tbuild

FORKS = ("phase0", "altair", "bellatrix", "capella")
U64_MAX, I64_MAX = 2**64 - 1, 2**63 - 1


def _load_ops_jax():
    """The JAX package's ``engine/ops_jax.py``, its source unchanged. It
    imports ``jax.experimental.enable_x64``, which this jax (0.9) has as
    ``jax.enable_x64``: the module is loaded under a private name with that
    one name supplied for the import, so that ``consensus_specs_tpu.engine.ops_jax``
    itself stays as the JAX package's own tests find it."""
    path = Path(consensus_specs_tpu.__file__).parent / "engine" / "ops_jax.py"
    spec = importlib.util.spec_from_file_location("_ops_jax_reference", path)
    module = importlib.util.module_from_spec(spec)
    had = hasattr(jax.experimental, "enable_x64")
    if not had:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    try:
        spec.loader.exec_module(module)
    finally:
        if not had:
            del jax.experimental.enable_x64
    return module


ops_jax = _load_ops_jax()


@pytest.fixture(autouse=True)
def _engines_off():
    """Each test starts and ends with both packages' engines uninstalled
    and on numpy, and one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    engine.use_interpreted_epoch()
    yield
    for eng in (engine, jengine):
        eng.use_interpreted_epoch()
        eng.use_direct_attestations()
        eng.use_backend("numpy")
    torch.set_num_threads(threads)


def _torch_cpu_backend(monkeypatch):
    """The torch backend on the CPU, dispatching at any registry size."""
    engine.use_backend("torch", device="cpu")
    monkeypatch.setattr(backend, "DEVICE_MIN_ROWS", 1)


def _root(state) -> bytes:
    return bytes(state.hash_tree_root())


@pytest.mark.parametrize("fork", FORKS)
def test_random_epoch_state_is_the_same_in_both_packages(fork):
    jspec, tspec = jbuild(fork, "minimal"), tbuild(fork, "minimal")
    for seed in (0, 1):
        jstate = jcross.random_epoch_state(jspec, seed=seed, n_validators=64, epoch=3)
        tstate = crosscheck.random_epoch_state(tspec, seed=seed, n_validators=64, epoch=3)
        assert _root(tstate) == _root(jstate)
        assert tstate.encode_bytes() == jstate.encode_bytes()


@pytest.mark.parametrize("fork", FORKS)
@pytest.mark.parametrize("leak", [False, True], ids=["finalizing", "leaking"])
def test_every_stage_matches_the_jax_engine_and_the_interpreted_spec(fork, leak, monkeypatch):
    jspec, tspec = jbuild(fork, "minimal"), tbuild(fork, "minimal")
    epoch = 6 if leak else 3
    names = crosscheck.stages_for(tspec)
    assert names == jcross.stages_for(jspec) and "process_rewards_and_penalties" in names
    calls = []
    real = ops_torch.flag_deltas
    monkeypatch.setattr(ops_torch, "flag_deltas", lambda *a, **k: calls.append(1) or real(*a, **k))
    for seed in (0, 1):
        jstate = jcross.random_epoch_state(jspec, seed=seed, n_validators=64, epoch=epoch, leak=leak)
        tstate = crosscheck.random_epoch_state(tspec, seed=seed, n_validators=64, epoch=epoch, leak=leak)
        for name in names:
            interpreted, port_numpy, port_torch, jax_engine = tstate.copy(), tstate.copy(), tstate.copy(), jstate.copy()
            getattr(tspec, name)(interpreted)
            engine.use_backend("numpy")
            getattr(stages, f"vectorized_{name}")(tspec, port_numpy)
            _torch_cpu_backend(monkeypatch)
            getattr(stages, f"vectorized_{name}")(tspec, port_torch)
            getattr(jstages, f"vectorized_{name}")(jspec, jax_engine)
            want = _root(interpreted)
            if name == "process_full_withdrawals":  # the sweep withdraws the rows crosscheck made withdrawable
                assert len(interpreted.withdrawals_queue) > len(tstate.withdrawals_queue), seed
            assert _root(port_numpy) == want, (name, seed)
            assert _root(port_torch) == want, (name, seed)
            assert _root(jax_engine) == want, (name, seed)
    # every fork after phase0 takes the flag deltas through the torch backend, 3 flags a state
    assert len(calls) == (0 if fork == "phase0" else 6)


@pytest.mark.parametrize("fork", FORKS[1:])
def test_penalty_families_follow_the_fork(fork):
    """altair's inactivity quotient and slashing multiplier on altair,
    bellatrix's on bellatrix and capella, in both packages' engines."""
    jspec, tspec = jbuild(fork, "minimal"), tbuild(fork, "minimal")
    family = "ALTAIR" if fork == "altair" else "BELLATRIX"
    want = (int(getattr(tspec, f"INACTIVITY_PENALTY_QUOTIENT_{family}")),
            int(getattr(tspec, f"PROPORTIONAL_SLASHING_MULTIPLIER_{family}")))
    assert (stages._inactivity_quotient(tspec), stages._slashings_multiplier(tspec)) == want
    assert (jstages._inactivity_quotient(jspec), jstages._slashings_multiplier(jspec)) == want


@pytest.mark.parametrize("leak", [False, True], ids=["finalizing", "leaking"])
@pytest.mark.parametrize("penalize", [True, False], ids=["penalize", "no-penalty"])
def test_flag_deltas_plain_matches_jax_and_the_numpy_branch(leak, penalize):
    for seed, scalars in enumerate(dc.SCALARS):
        increments, in_mask, eligible = dc.columns(4096, seed)
        args = (increments, in_mask, eligible, *scalars, leak, penalize)
        assert int(increments.max()) * scalars[0] * scalars[1] * max(scalars[2], 1) <= I64_MAX
        want = ops_jax.flag_deltas(*args)
        engine.use_backend("numpy")
        numpy_branch = stages._flag_deltas(*args)
        port = ops_torch.flag_deltas(*args, device="cpu")
        plain = ops_torch.flag_deltas_plain(
            torch.from_numpy(increments.view(np.int64)), torch.from_numpy(in_mask), torch.from_numpy(eligible),
            *scalars, leak, penalize)
        for got in (numpy_branch, port, tuple(t.numpy().view(np.uint64) for t in plain)):
            for a, b in zip(got, want):
                assert a.dtype == np.uint64 and np.array_equal(a, b)
        assert [w.tolist() for w in want] == list(dc.python_deltas(*args))
        assert (want[0].any() != leak or scalars[2] == 0) and want[1].any() == penalize


def test_a_numerator_past_int64_takes_the_exact_branch_on_the_cpu(monkeypatch):
    """Between 2^63 and 2^64 the plain version would wrap: the engine's
    guard sends the column to the numpy branch on the CPU, which equals
    the JAX kernel (exact in uint64 there) and Python integers."""
    increments, in_mask, eligible = dc.columns(4096, 7)
    scalars = dc.SCALARS_PAST_INT64
    top = int(increments.max()) * scalars[0] * scalars[1] * scalars[2]
    assert I64_MAX < top <= U64_MAX
    args = (increments, in_mask, eligible, *scalars, False, True)
    _torch_cpu_backend(monkeypatch)
    assert backend.exact_max() == I64_MAX
    monkeypatch.setattr(ops_torch, "flag_deltas", lambda *a, **k: pytest.fail("dispatched past the exact range"))
    got = stages._flag_deltas(*args)
    want = ops_jax.flag_deltas(*args)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    ints = dc.python_deltas(*args)
    assert [g.tolist() for g in got] == list(ints) and max(ints[0]) > 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="int64 range"):
        ops_torch.flag_deltas(*args, device="cpu")


@pytest.mark.parametrize("fork", FORKS)
def test_process_epoch_on_the_torch_backend_matches_the_jax_package(fork, monkeypatch):
    jspec, tspec = jbuild(fork, "minimal"), tbuild(fork, "minimal")
    jstate = jcross.random_epoch_state(jspec, seed=5, n_validators=64, epoch=4, leak=False)
    tstate = crosscheck.random_epoch_state(tspec, seed=5, n_validators=64, epoch=4, leak=False)
    jspec.process_epoch(jstate)
    engine.use_vectorized_epoch()
    assert all(engine.stage_status(tspec).values())
    _torch_cpu_backend(monkeypatch)
    tspec.process_epoch(tstate)
    assert tstate.encode_bytes() == jstate.encode_bytes()


def test_install_is_idempotent_reversible_and_reaches_future_builds():
    spec = tbuild("altair", "minimal")
    original = spec.process_slashings
    engine.use_vectorized_epoch()
    engine.use_vectorized_epoch()  # double-install must not double-wrap
    wrapped = spec.process_slashings
    assert wrapped.engine_vectorized and wrapped.__wrapped__ is original
    assert wrapped.__name__ == "process_slashings"
    fresh = tbuild("altair", "minimal", {"INACTIVITY_SCORE_BIAS": 5})
    assert engine.stage_status(fresh)["process_rewards_and_penalties"]
    engine.use_batched_attestations()
    assert spec.process_operations.engine_batched_atts and fresh.process_operations.engine_batched_atts
    engine.use_interpreted_epoch()
    engine.use_direct_attestations()
    assert spec.process_slashings is original and not any(engine.stage_status(fresh).values())
    assert not getattr(spec.process_operations, "engine_batched_atts", False)
    assert engine.SUPPORTED_FORKS == ("phase0", "altair", "bellatrix", "capella")


def test_torch_backend_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.use_backend("torch")
    assert engine.backend_name() == "numpy" and backend.delta_kernel() is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops_torch.flag_deltas(*dc.columns(8, 0), *dc.SCALARS[0], False, True)
    assert engine.use_backend("torch", device="cpu") == "torch"
    with pytest.raises(ValueError, match="no kernel"):
        engine.use_backend("torch", device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops_torch.flag_deltas_cuda(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.bool),
                                   torch.zeros(4, dtype=torch.bool), *dc.SCALARS[0], False, True)
    assert ops_torch.launches["flag_deltas"] == 0
