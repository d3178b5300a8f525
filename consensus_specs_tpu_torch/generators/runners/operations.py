"""`operations` runner: per-fork block-operation handlers
(ref: tests/generators/operations/main.py). The port carries the
``attestation`` handler on every production fork; the JAX package's other
handlers are listed in ROADMAP.md."""
from ..gen_from_tests import run_state_test_generators

_cases = "consensus_specs_tpu_torch.cases.operations_"

phase_0_mods = {
    "attestation": _cases + "attestation",
}
altair_mods = phase_0_mods
bellatrix_mods = altair_mods
capella_mods = bellatrix_mods

all_mods = {
    "phase0": phase_0_mods,
    "altair": altair_mods,
    "bellatrix": bellatrix_mods,
    "capella": capella_mods,
}


def run(args=None):
    run_state_test_generators(runner_name="operations", all_mods=all_mods, args=args)


if __name__ == "__main__":
    run()
