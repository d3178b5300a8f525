"""Spec builder: fork-delta sources → flat (fork, preset) modules.

The equivalent of the reference's markdown→Python compiler
(setup.py:168-264,580-678 and the SpecBuilder inheritance chain :328-573).
Forks are deltas: building fork F executes the sources of every fork up to
F *into one namespace*, so later definitions override earlier ones and all
references late-bind to the final namespace — the same semantics the
reference gets by emitting one flat module per (fork, preset).

This package carries the production forks phase0, altair, bellatrix and
capella, and the R&D forks that branch off bellatrix: sharding, with
custody_game and das on it, and eip4844.
Built modules register as ``consensus_specs_tpu_torch.specs.<fork>_<preset>``
so they never collide in ``sys.modules`` with the JAX package's modules of
the same fork and preset.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from ..config import config_for, preset_for

FORK_ORDER = ["phase0", "altair", "bellatrix", "capella"]

# R&D forks branch off the production chain rather than extending its tip
# (ref: setup.py's builder hierarchy — sharding extends bellatrix,
# custody_game and das extend sharding, eip4844 extends bellatrix)
RND_FORK_CHAINS = {
    "sharding": ["phase0", "altair", "bellatrix", "sharding"],
    "custody_game": ["phase0", "altair", "bellatrix", "sharding", "custody_game"],
    "das": ["phase0", "altair", "bellatrix", "sharding", "das"],
    "eip4844": ["phase0", "altair", "bellatrix", "eip4844"],
}

# Previous fork mapping (linear chain for the production forks)
PREVIOUS_FORK = {
    "phase0": None,
    "altair": "phase0",
    "bellatrix": "altair",
    "capella": "bellatrix",
    "sharding": "bellatrix",
    "custody_game": "sharding",
    "das": "sharding",
    "eip4844": "bellatrix",
}

_SOURCE_DIR = Path(__file__).resolve().parent
_cache: Dict[Tuple, types.ModuleType] = {}
_code_cache: Dict[str, Any] = {}

# Module hooks: installed-backend shims (e.g. engine.use_vectorized_epoch)
# run over every built module — retroactively on registration, and on each
# future build — so a backend switch applies to every (fork, preset)
# module no matter when it was compiled relative to the switch.
_module_hooks: list = []


def register_module_hook(hook) -> None:
    """Register ``hook(module)`` to run on every spec module, existing and
    future. Idempotent per hook object."""
    if hook not in _module_hooks:
        _module_hooks.append(hook)
    for mod in list(_cache.values()):
        hook(mod)


def unregister_module_hook(hook) -> None:
    """Stop applying ``hook`` to future builds (does not undo its effect
    on already-built modules — the owner restores those)."""
    if hook in _module_hooks:
        _module_hooks.remove(hook)


def cached_modules():
    """Every spec module built so far (hook owners restore through this)."""
    return list(_cache.values())


def available_forks():
    """Production forks whose spec source exists on disk, in dependency
    order: the forks the generators iterate."""
    return [f for f in FORK_ORDER if (_SOURCE_DIR / f"{f}.py").exists()]


def available_rnd_forks():
    """R&D branch forks with spec sources — selectable only by explicit
    name, never by generators."""
    return [f for f in RND_FORK_CHAINS if (_SOURCE_DIR / f"{f}.py").exists()]


def _fork_chain(fork: str):
    if fork in RND_FORK_CHAINS:
        return RND_FORK_CHAINS[fork]
    if fork not in FORK_ORDER:
        raise ValueError(f"unknown fork {fork!r} (have {FORK_ORDER + sorted(RND_FORK_CHAINS)})")
    return FORK_ORDER[: FORK_ORDER.index(fork) + 1]


def _compiled(fork: str):
    code = _code_cache.get(fork)
    if code is None:
        path = _SOURCE_DIR / f"{fork}.py"
        # dont_inherit: this file's own __future__ imports (e.g. PEP 563
        # string annotations) must NOT leak into spec sources — SSZ Container
        # field collection needs real type objects in __annotations__.
        code = compile(path.read_text(), str(path), "exec", dont_inherit=True)
        _code_cache[fork] = code
    return code


def build_spec(
    fork: str,
    preset_name: str,
    config_overrides: Optional[Dict[str, Any]] = None,
) -> types.ModuleType:
    """Build (or fetch cached) the flat spec module for (fork, preset).

    With ``config_overrides`` a fresh module is built whose ``config`` has
    the overrides applied — the with_config_overrides mechanism
    (ref: test/context.py:492-534) without re-importing files.
    """
    if config_overrides is None:
        cache_key = (fork, preset_name)
        suffix = ""
    else:
        # Value-keyed cache: identical overrides share one module.
        items = tuple(sorted(config_overrides.items()))
        cache_key = (fork, preset_name, items)
        suffix = f"_o{abs(hash(items)):x}"
    if cache_key in _cache:
        return _cache[cache_key]

    chain = _fork_chain(fork)
    mod = types.ModuleType(f"consensus_specs_tpu_torch.specs.{fork}_{preset_name}{suffix}")
    mod.__file__ = str(_SOURCE_DIR / f"{fork}.py")
    ns = mod.__dict__
    # dataclass/typing machinery resolves cls.__module__ through sys.modules
    sys.modules[mod.__name__] = mod

    ns.update(preset_for(preset_name, chain))
    cfg = config_for(preset_name)
    if config_overrides:
        cfg.update(config_overrides)
    ns["config"] = cfg
    for f in chain:
        exec(_compiled(f), ns)
    ns["fork"] = fork
    ns["preset_base"] = preset_name
    for hook in _module_hooks:
        hook(mod)

    _cache[cache_key] = mod
    return mod
