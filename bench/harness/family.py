"""A configuration's model family and its plain reference, found by name.

A configuration file names its family (``"family": "<family>"``): the
module ``bench/families/<family>.py``, which knows the model's shape.  It
gives

- ``sizes(config)``: the configuration's sizes under the family's own
  names, ``vocab`` among them;
- ``shapes(sizes)``: every leaf of the stacked parameter tree, by path,
  with its shape and how ``weights.draw`` draws it;
- ``program_config(config, sizes, section, **extra)``: the port's
  ``ModelConfig`` for the configuration's ``serving`` or ``training``
  section;
- the model's operation and byte counts, and its attention layers
  (``attention_layers``), which the per-layer readers take from their
  context's ``family``; the least time of one launch is ``arith``'s.

The configuration's ``reference`` key names its plain reference by path
(``"bench/reference/<file>.py"``), which gives ``served_logits``,
``grads``, ``adamw`` and ``exact_fp32``.  A new family is new files under
``bench/families/`` and ``bench/reference/``, and no edit here.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict


def of(config: Dict) -> ModuleType:
    """The module of the configuration's model family."""
    if "family" not in config:
        raise KeyError(f"bench: configuration {config.get('name')!r} "
                       f"names no family")
    return _module(f"bench/families/{config['family']}.py")


def reference(config: Dict) -> ModuleType:
    """The plain reference that the configuration's ``reference`` names."""
    return _module(config["reference"])


def _module(path: str) -> ModuleType:
    """The module at ``path``, relative to the checkout's root and inside
    ``bench/``, imported as a module of the ``bench`` package."""
    if not path.startswith("bench/") or not path.endswith(".py") \
            or ".." in path.split("/"):
        raise ValueError(f"bench: {path!r} is no module path under bench/")
    name = path[:-3].replace("/", ".")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        # the module or a package on its way is missing, not something
        # that it imports
        if e.name is None or not (name + ".").startswith(e.name + "."):
            raise
        raise FileNotFoundError(f"bench: no {path}") from None
