"""Three-tier constants model (ref: presets/*/*.yaml, configs/*.yaml,
setup.py:218-247,782-806 and eth2spec/config/config_util.py).

- *constants*: never change; baked into the fork spec sources.
- *presets*: compile-time bundles ("mainnet"/"minimal") that size SSZ
  containers; a spec module is built per (fork, preset).
- *configs*: runtime-swappable variables exposed as attributes of a
  mutable ``Config`` object inside each built spec module.
"""
from .presets import PRESETS, preset_for
from .runtime import CONFIGS, Config, config_for, load_config_file, parse_config_var

__all__ = [
    "PRESETS",
    "preset_for",
    "CONFIGS",
    "Config",
    "config_for",
    "load_config_file",
    "parse_config_var",
]
