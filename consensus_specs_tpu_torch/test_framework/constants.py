"""Fork / preset registry (ref: test/helpers/constants.py)."""

PHASE0 = "phase0"
ALTAIR = "altair"
BELLATRIX = "bellatrix"
CAPELLA = "capella"

# In dependency order
ALL_PHASES = (PHASE0, ALTAIR, BELLATRIX, CAPELLA)
# Forks with enabled vector generation (ref constants.py:19-22)
TESTGEN_FORKS = (PHASE0, ALTAIR, BELLATRIX)

MAINNET = "mainnet"
MINIMAL = "minimal"
ALL_PRESETS = (MAINNET, MINIMAL)

PREVIOUS_FORK_OF = {
    PHASE0: None,
    ALTAIR: PHASE0,
    BELLATRIX: ALTAIR,
    CAPELLA: BELLATRIX,
}

ALL_FORK_UPGRADES = {fr: to for to, fr in PREVIOUS_FORK_OF.items() if fr is not None}


def is_post_altair(spec) -> bool:
    return spec.fork not in (PHASE0,)


def is_post_bellatrix(spec) -> bool:
    return spec.fork not in (PHASE0, ALTAIR)


def is_post_capella(spec) -> bool:
    return spec.fork == CAPELLA
