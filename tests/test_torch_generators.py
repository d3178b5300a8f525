"""The port's vector factory against the JAX package's: the same providers
on the same seeds write the same files, byte for byte, and the same digest
journal.

- ssz_static on the four forks at minimal, every randomization mode at
  count 1 and one chaos setting, through both packages' ``run_generator``
  (the port on the host oracle: the reference BLS and hashlib);
- operations/attestation at phase0 minimal with ``--bls-defer`` through
  both, the invalid-signature cases among them (their rows False, the
  cases replayed);
- three of those cases through the port's torch BLS backend and device
  hasher on the CPU (the kernels' plain versions), equal to the same bytes;
- the YAML writer against ``yaml.safe_dump(..., default_flow_style=None)``
  and the reader against ``yaml.safe_load`` on edge values;
- the journal's structural check parses the YAML it admits.
"""
import contextlib
import io
from pathlib import Path
from random import Random

import pytest
import yaml

from consensus_specs_tpu.debug.random_value import RandomizationMode as JMode
from consensus_specs_tpu.generators import gen_from_tests as jgen_from_tests
from consensus_specs_tpu.generators.gen_runner import run_generator as jrun
from consensus_specs_tpu.generators.runners import ssz_static as jssz
from consensus_specs_tpu.resilience.journal import CaseJournal as JJournal
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.debug.encode import encode
from consensus_specs_tpu_torch.debug.random_value import RandomizationMode, get_random_ssz_object
from consensus_specs_tpu_torch.generators import gen_from_tests, gen_typing
from consensus_specs_tpu_torch.generators.gen_runner import run_generator
from consensus_specs_tpu_torch.generators.runners import ssz_static
from consensus_specs_tpu_torch.resilience import CaseJournal, events
from consensus_specs_tpu_torch.resilience.journal import verify_outputs
from consensus_specs_tpu_torch.specs import build_spec
from consensus_specs_tpu_torch.ssz import hashing
from consensus_specs_tpu_torch.utils import yaml_emit

FORKS = ["phase0", "altair", "bellatrix", "capella"]
HOST = ["--device", "host"]  # the port's host oracle: reference BLS, hashlib
ATTESTATION_CASES = "consensus_specs_tpu_torch.cases.operations_attestation"
INVALID_SIGNATURE_CASES = {"invalid_attestation_signature", "wrong_index_for_committee_signature"}


def tree(root: Path) -> dict:
    """Every file under ``root`` (the journal included), by relative path."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def ssz_settings():
    """The ssz_static runner's settings (seed, mode, chaos), every mode at
    count 1 and the chaos setting."""
    settings = [(seed, mode, False) for seed, mode in enumerate(RandomizationMode, start=1)]
    settings.append((len(settings) + 1, RandomizationMode.mode_random, True))
    return settings


@pytest.mark.parametrize("fork", FORKS)
def test_ssz_static_equals_the_jax_package(fork, tmp_path):
    port = [ssz_static.create_provider(fork, "minimal", seed, mode, chaos, 1)
            for seed, mode, chaos in ssz_settings()]
    jax = [jssz.create_provider(fork, "minimal", seed, JMode(mode.value), chaos, 1)
           for seed, mode, chaos in ssz_settings()]
    counts = quiet(run_generator, "ssz_static", port, ["-o", str(tmp_path / "port"), *HOST])
    quiet(jrun, "ssz_static", jax, ["-o", str(tmp_path / "jax"), "--workers", "0"])
    ours, theirs = tree(tmp_path / "port"), tree(tmp_path / "jax")
    types = ssz_static.get_spec_ssz_types(build_spec(fork, "minimal"))
    assert counts == {"generated": len(types) * len(ssz_settings()), "skipped": 0, "failed": 0}
    assert ours.keys() == theirs.keys()
    assert [name for name in ours if ours[name] != theirs[name]] == []
    assert any(name.endswith("ssz_random_chaos/case_0/value.yaml") for name in ours)
    assert CaseJournal(tmp_path / "port").entries() == JJournal(tmp_path / "jax").entries()


def attestation_provider(fork="phase0", preset="minimal", only=None):
    provider = gen_from_tests.get_create_provider_fn("operations")(fork, preset, "attestation", ATTESTATION_CASES)
    if only is None:
        return provider
    return gen_typing.TestProvider(
        prepare=provider.prepare,
        make_cases=lambda: (c for c in provider.make_cases() if c.case_name in only))


@pytest.fixture(scope="module")
def attestation_runs(tmp_path_factory):
    """operations/attestation at phase0 minimal with --bls-defer: the port
    on the host oracle, and the JAX package."""
    root = tmp_path_factory.mktemp("attestation")
    log: list = []
    events(clear=True)
    counts = quiet(run_generator, "operations", [attestation_provider()],
                   ["-o", str(root / "port"), *HOST, "--bls-defer"], flush_log=log)
    retried = [e for e in events() if e["event"] == "retry"]
    jax = jgen_from_tests.get_create_provider_fn("operations")(
        "phase0", "minimal", "attestation", "tests.spec.test_operations_attestation")
    quiet(jrun, "operations", [jax], ["-o", str(root / "jax"), "--bls-defer", "--workers", "0"])
    return {"root": root, "counts": counts, "log": log, "retried": retried}


def test_operations_attestation_equals_the_jax_package(attestation_runs):
    root = attestation_runs["root"]
    ours, theirs = tree(root / "port"), tree(root / "jax")
    assert attestation_runs["counts"] == {"generated": 20, "skipped": 0, "failed": 0}
    assert attestation_runs["retried"] == []
    assert ours.keys() == theirs.keys()
    assert [name for name in ours if ours[name] != theirs[name]] == []
    assert CaseJournal(root / "port").entries() == JJournal(root / "jax").entries()


def test_invalid_signature_cases_are_replayed(attestation_runs):
    (flush,) = attestation_runs["log"]
    base = "minimal/phase0/operations/attestation/pyspec_tests/"
    false_rows = {case[len(base):] for case, rows in flush["rows"].items() if not all(rows)}
    assert false_rows == INVALID_SIGNATURE_CASES
    assert {case[len(base):] for case in flush["replayed"]} == INVALID_SIGNATURE_CASES
    tree_ = tree(attestation_runs["root"] / "port")
    for case in INVALID_SIGNATURE_CASES:  # an invalid case writes no post state
        assert base + case + "/pre.ssz_snappy" in tree_ and base + case + "/post.ssz_snappy" not in tree_


def test_torch_backends_on_the_cpu_write_the_same_bytes(attestation_runs, tmp_path, monkeypatch):
    """Three cases, one of them an invalid signature, through the torch
    BLS backend and the device hasher on the CPU. Lower thresholds than
    the card's send the minimal states' larger trees (whole roots too)
    through the device hasher's plain versions."""
    only = {"success", "invalid_attestation_signature", "success_previous_epoch"}
    monkeypatch.setattr(hashing, "DEVICE_MIN_BLOCKS", 16)
    monkeypatch.setattr(hashing, "FUSED_ROOT_MIN_CHUNKS", 32)
    provider = attestation_provider(only=only)
    seen = []

    def prepare():  # the backends the run installed before its first provider
        seen.append((bls.backend_name(), hashing.backend_name()))
        provider.prepare()

    log: list = []
    counts = quiet(run_generator, "operations", [gen_typing.TestProvider(prepare, provider.make_cases)],
                   ["-o", str(tmp_path), "--device", "cpu", "--bls-defer"], flush_log=log)
    assert seen == [("torch", "torch-cpu")]
    assert (bls.backend_name(), hashing.backend_name()) == ("reference", "hashlib")  # restored
    assert counts == {"generated": 3, "skipped": 0, "failed": 0}
    assert [r for rows in log[0]["rows"].values() for r in rows].count(False) == 1
    ours, theirs = tree(tmp_path), tree(attestation_runs["root"] / "port")
    ours.pop(".gen_journal.jsonl")
    assert ours and all(ours[name] == theirs[name] for name in ours)


def test_a_transient_fault_is_retried_and_recorded(tmp_path):
    """The supervisor retries a case whose first try meets a transient
    fault, and its event record shows it: the record the smoke reads to
    require that a card run retried nothing."""
    tries = []

    def case_fn():
        tries.append(1)
        if len(tries) == 1:
            raise OSError("an I/O flake")
        return [("meta_only", "meta", 1)]

    case = gen_typing.TestCase("phase0", "minimal", "r", "h", "s", "c", case_fn)
    events(clear=True)
    counts = quiet(run_generator, "r", [gen_typing.TestProvider(lambda: None, lambda: [case])],
                   ["-o", str(tmp_path), *HOST])
    assert counts == {"generated": 1, "skipped": 0, "failed": 0} and len(tries) == 2
    assert [(e["event"], e["domain"]) for e in events()] == [("retry", "generator")]
    assert (tmp_path / "minimal/phase0/r/h/s/c/meta.yaml").read_text() == "{meta_only: 1}\n"


@pytest.mark.parametrize("flag", [["--workers", "2"], ["--profile"]])
def test_flags_left_out_raise(flag, tmp_path):
    with pytest.raises(ValueError, match="not available"):
        run_generator("ssz_static", [], ["-o", str(tmp_path), *HOST, *flag])


def test_journal_parses_the_yaml_it_admits(tmp_path):
    """A case written before the journal existed is admitted on its
    structure: its YAML must parse, so a truncated file is regenerated."""
    provider = ssz_static.create_provider("phase0", "minimal", 1, RandomizationMode.mode_random, False, 1)
    quiet(run_generator, "ssz_static", [provider], ["-o", str(tmp_path), *HOST, "--no-journal"])
    case = tmp_path / "minimal/phase0/ssz_static/BeaconState/ssz_random/case_0"
    assert verify_outputs(case) is None
    value = case / "value.yaml"
    text = value.read_text()
    value.write_text(text[: text.index("[") + 40])  # cut inside a flow list
    assert "malformed yaml" in verify_outputs(case)
    journal = CaseJournal(tmp_path)
    assert not journal.admit(str(case.relative_to(tmp_path)), case)


# -- the YAML writer and reader --------------------------------------------------------

EDGE_VALUES = {
    "long flow list of ints": list(range(120)),
    "long flow list of roots": ["0x" + bytes([i]).hex() * 32 for i in range(6)],
    "uint64 max, folding": [2**64 - 1] * 12,
    "uint256 max": {"a": 2**256 - 1, "b": [2**256 - 1, 0]},
    "uint256 as a string": [str(2**256 - 1), str(2**128)],
    "nested leaf mappings": {"a": {"b": {"c": 1, "d": [1, 2]}, "e": {"f": "0x"}}, "g": [{"h": 1}, {"i": []}]},
    "block sequences": {"a": [[1, 2], [[3], []], {"b": [4]}], "c": [{"d": {"e": 5}}]},
    "empty collections": {"a": [], "b": {}, "c": [[]], "d": [{}], "e": {"f": {}}},
    "empty list": [],
    "empty mapping": {},
    "0x": "0x",
    "0x07": "0x07",
    "null-like strings": ["null", "Null", "NULL", "~", ""],
    "bool-like strings": ["true", "False", "yes", "NO", "on", "Off", "y", "n"],
    "int-like strings": ["123", "-5", "+7", "0b101", "017", "0x1F", "1_000", "1:30", "0"],
    "float-like strings": ["1.5", ".inf", "-.Inf", ".nan", "1e3", "6.8e+3"],
    "indicator strings": ["- a", "? a", ": a", "a: b", "a #b", "#a", "[a]", "a,b", "'q'", "&a", "*a", "---", "..."],
    "scalars at the root": [5, "a", None, True, False],
    "root int": 2**64 - 1,
    "root string": "phase0",
    "root null": None,
    "long strings with spaces": {"plain": " ".join(["word"] * 40), "quoted": "1 " + " ".join(["x" * 9] * 20)},
    "meta": {"bls_setting": 1, "blocks_count": 3},
    "roots": {"root": "0x" + "ab" * 32},
    "mixed": {"slot": 0, "ok": True, "none": None, "hex": "0xff", "list": [True, None, "0x", 3]},
}


@pytest.mark.parametrize("name", sorted(EDGE_VALUES))
def test_yaml_dump_equals_pyyaml(name):
    value = EDGE_VALUES[name]
    assert yaml_emit.dump(value) == yaml.safe_dump(value, default_flow_style=None)


@pytest.mark.parametrize("name", sorted(EDGE_VALUES))
def test_yaml_parse_equals_pyyaml(name):
    text = yaml.safe_dump(EDGE_VALUES[name], default_flow_style=None)
    assert yaml_emit.parse(text) == yaml.safe_load(text)


@pytest.mark.parametrize("fork", FORKS)
def test_yaml_dump_of_random_states(fork):
    """Every container of the fork, random values as debug/encode writes them."""
    spec = build_spec(fork, "minimal")
    for name, typ in ssz_static.get_spec_ssz_types(spec):
        value = encode(get_random_ssz_object(Random(name), typ, 100, 4, RandomizationMode.mode_random, True))
        text = yaml_emit.dump(value)
        assert text == yaml.safe_dump(value, default_flow_style=None), name
        assert yaml_emit.parse(text) == value, name


@pytest.mark.parametrize("value", [1.5, b"\x00", {1: 2}, "tab\there", "line\nbreak", "café", {"k" * 128: 1}])
def test_yaml_dump_refuses_values_outside_the_subset(value):
    with pytest.raises((TypeError, ValueError)):
        yaml_emit.dump(value)


def test_yaml_dump_refuses_a_shared_collection():
    shared = [1, 2]
    with pytest.raises(ValueError, match="alias"):
        yaml_emit.dump({"a": shared, "b": shared})


@pytest.mark.parametrize("text", ["[1, 2", "a: [1, 2\n", "'abc", "a: 'x\n", "{a: 1", "a: 1\n a: 2\n", "[1, 2]]\n",
                                  "a: b: c\n"])
def test_yaml_parse_refuses_malformed_text(text):
    with pytest.raises(Exception):
        yaml.safe_load(text)
    with pytest.raises(ValueError):
        yaml_emit.parse(text)
