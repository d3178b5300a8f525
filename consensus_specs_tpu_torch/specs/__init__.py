"""Fork spec sources (deltas) + builder.

Each ``<fork>.py`` file in this package is a *spec source*: a Python
delta over its parent fork, written against names that the builder
injects (preset constants, the ``config`` object, and every definition
of the parent forks). They are executed by ``build.build_spec`` into
flat per-(fork, preset) modules. Do not import the source files directly.
"""
from .build import FORK_ORDER, available_forks, available_rnd_forks, build_spec

__all__ = ["build_spec", "available_forks", "available_rnd_forks", "FORK_ORDER"]
