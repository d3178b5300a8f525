"""Runtime configuration (ref: configs/{mainnet,minimal}.yaml and
eth2spec/config/config_util.py:6-63).

A built spec module carries a mutable ``Config`` instance named ``config``;
spec functions read fork epochs/versions etc. through it, so a client (or a
test, via with_config_overrides) can re-point a compiled spec at a custom
config without rebuilding.
"""
from __future__ import annotations

from typing import Any, Dict

UINT64_MAX = 2**64 - 1

MAINNET_CONFIG: Dict[str, Any] = dict(
    PRESET_BASE="mainnet",
    CONFIG_NAME="mainnet",
    # Transition (configs/mainnet.yaml:9-14)
    TERMINAL_TOTAL_DIFFICULTY=2**256 - 2**10,
    TERMINAL_BLOCK_HASH=bytes(32),
    TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH=UINT64_MAX,
    # Genesis
    MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=2**14,
    MIN_GENESIS_TIME=1606824000,
    GENESIS_FORK_VERSION=bytes.fromhex("00000000"),
    GENESIS_DELAY=604800,
    # Forking
    ALTAIR_FORK_VERSION=bytes.fromhex("01000000"),
    ALTAIR_FORK_EPOCH=74240,
    BELLATRIX_FORK_VERSION=bytes.fromhex("02000000"),
    BELLATRIX_FORK_EPOCH=UINT64_MAX,
    CAPELLA_FORK_VERSION=bytes.fromhex("03000000"),
    CAPELLA_FORK_EPOCH=UINT64_MAX,
    SHARDING_FORK_VERSION=bytes.fromhex("04000000"),
    SHARDING_FORK_EPOCH=UINT64_MAX,
    # Time parameters
    SECONDS_PER_SLOT=12,
    SECONDS_PER_ETH1_BLOCK=14,
    MIN_VALIDATOR_WITHDRAWABILITY_DELAY=2**8,
    SHARD_COMMITTEE_PERIOD=2**8,
    ETH1_FOLLOW_DISTANCE=2**11,
    # Validator cycling
    INACTIVITY_SCORE_BIAS=4,
    INACTIVITY_SCORE_RECOVERY_RATE=16,
    EJECTION_BALANCE=16 * 10**9,
    MIN_PER_EPOCH_CHURN_LIMIT=4,
    CHURN_LIMIT_QUOTIENT=2**16,
    # Fork choice
    PROPOSER_SCORE_BOOST=40,
    # Deposit contract
    DEPOSIT_CHAIN_ID=1,
    DEPOSIT_NETWORK_ID=1,
    DEPOSIT_CONTRACT_ADDRESS=bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa"),
)

MINIMAL_CONFIG: Dict[str, Any] = dict(
    MAINNET_CONFIG,
    PRESET_BASE="minimal",
    CONFIG_NAME="minimal",
    MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=64,
    MIN_GENESIS_TIME=1578009600,
    GENESIS_FORK_VERSION=bytes.fromhex("00000001"),
    GENESIS_DELAY=300,
    ALTAIR_FORK_VERSION=bytes.fromhex("01000001"),
    ALTAIR_FORK_EPOCH=UINT64_MAX,
    BELLATRIX_FORK_VERSION=bytes.fromhex("02000001"),
    CAPELLA_FORK_VERSION=bytes.fromhex("03000001"),
    SHARDING_FORK_VERSION=bytes.fromhex("04000001"),
    SECONDS_PER_SLOT=6,
    SHARD_COMMITTEE_PERIOD=64,
    ETH1_FOLLOW_DISTANCE=16,
    CHURN_LIMIT_QUOTIENT=32,
    DEPOSIT_CHAIN_ID=5,
    DEPOSIT_NETWORK_ID=5,
    DEPOSIT_CONTRACT_ADDRESS=bytes.fromhex("1234567890123456789012345678901234567890"),
)

CONFIGS: Dict[str, Dict[str, Any]] = {
    "mainnet": MAINNET_CONFIG,
    "minimal": MINIMAL_CONFIG,
}


class Config:
    """Mutable attribute bag a spec module reads runtime vars through
    (the reference's regenerated `config` NamedTuple, setup.py:632-639,
    made mutable so overrides don't require module re-import)."""

    def __init__(self, values: Dict[str, Any]):
        self.__dict__.update(values)

    def asdict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def update(self, overrides: Dict[str, Any]) -> None:
        for k, v in overrides.items():
            if k not in self.__dict__:
                raise KeyError(f"unknown config var {k!r}")
            self.__dict__[k] = v

    def copy(self) -> "Config":
        return Config(self.asdict())

    def __repr__(self):
        return f"Config({self.__dict__.get('CONFIG_NAME', '?')})"


def config_for(name: str) -> Config:
    return Config(CONFIGS[name])


def parse_config_var(value: str) -> Any:
    """Parse one textual config value (config_util.py:14-24): 0x-hex →
    bytes, decimal → int, else kept as string."""
    value = value.strip().strip("'\"")
    if value.startswith("0x"):
        return bytes.fromhex(value[2:])
    try:
        return int(value)
    except ValueError:
        return value


def load_config_file(path) -> Dict[str, Any]:
    """Load a client-style YAML config of flat `KEY: value` pairs
    (config_util.py:25-35). A tiny line parser keeps this dependency-free;
    comments and blank lines are ignored."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, value = line.split(":", 1)
            out[key.strip()] = parse_config_var(value)
    return out
