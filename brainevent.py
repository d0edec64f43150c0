# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Drop-in module alias: ``import brainevent`` -> :mod:`brainevent_tpu`.

Code written against the reference package imports ``brainevent``; this shim
makes that import work unchanged (including the PEP 562 deprecation hooks).
"""

import sys as _sys

import brainevent_tpu as _impl
from brainevent_tpu import *  # noqa: F401,F403

__version__ = _impl.__version__
__all__ = _impl.__all__


def __getattr__(name):
    return getattr(_impl, name)


def __dir__():
    return dir(_impl)


# submodule aliases so `import brainevent.config` style access works
for _sub in ('config', 'events', 'csr', 'dense', 'fcn', 'jitc', 'rng',
             'ops', 'models', 'parallel'):
    _sys.modules.setdefault(f'brainevent.{_sub}', getattr(_impl, _sub, None)
                            or __import__(f'brainevent_tpu.{_sub}',
                                          fromlist=['_']))
