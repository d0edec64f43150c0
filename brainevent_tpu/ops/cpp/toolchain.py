# Copyright 2026 The brainevent-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
# ==============================================================================

"""Native toolchain discovery (reference ``brainevent/_op/kernix_toolchain.py``).

Finds a host C++ compiler and the XLA FFI headers shipped with jaxlib; no
CUDA machinery — the native path is CPU-only.
Respects the ``CXX`` environment variable.
"""

import dataclasses
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

from ..._error import HeaderNotFoundError, HostCompilerNotFoundError

__all__ = ['CppToolchain', 'detect_cpp_toolchain', 'collect_toolchain_diagnostics']


@dataclasses.dataclass(frozen=True)
class CppToolchain:
    """Resolved host compiler + include paths."""
    cxx: str
    xla_include: str
    be_include: str
    version: str

    def compile_command(self, src: Path, out: Path,
                        extra_cflags: Optional[List[str]] = None) -> List[str]:
        return [
            self.cxx, '-std=c++17', '-O2', '-fPIC', '-shared',
            f'-I{self.xla_include}', f'-I{self.be_include}',
            *(extra_cflags or []),
            str(src), '-o', str(out),
        ]


_cached: Optional[CppToolchain] = None


def _be_include_dir() -> str:
    return str(Path(__file__).resolve().parents[2] / 'include')


def detect_cpp_toolchain() -> CppToolchain:
    """Locate g++/clang++ and the jaxlib XLA FFI headers (cached)."""
    global _cached
    if _cached is not None:
        return _cached

    candidates = [os.environ.get('CXX'), 'g++', 'clang++', 'c++']
    cxx = None
    for cand in candidates:
        if cand and shutil.which(cand):
            cxx = shutil.which(cand)
            break
    if cxx is None:
        raise HostCompilerNotFoundError(
            'No host C++ compiler found (tried $CXX, g++, clang++, c++). '
            'Install g++ or set the CXX environment variable.'
        )

    import jax.ffi
    xla_include = jax.ffi.include_dir()
    ffi_header = Path(xla_include) / 'xla' / 'ffi' / 'api' / 'ffi.h'
    if not ffi_header.exists():
        raise HeaderNotFoundError(
            f'XLA FFI header not found at {ffi_header}; the installed jaxlib '
            f'does not ship FFI headers.'
        )

    try:
        version = subprocess.run(
            [cxx, '--version'], capture_output=True, text=True, timeout=10
        ).stdout.splitlines()[0]
    except (subprocess.SubprocessError, IndexError):
        version = 'unknown'

    _cached = CppToolchain(cxx=cxx, xla_include=xla_include,
                           be_include=_be_include_dir(), version=version)
    return _cached


def collect_toolchain_diagnostics() -> Dict[str, str]:
    """Human-readable toolchain snapshot (reference
    ``kernix_toolchain.py:575``)."""
    try:
        tc = detect_cpp_toolchain()
        return {
            'cxx': tc.cxx,
            'cxx_version': tc.version,
            'xla_include': tc.xla_include,
            'brainevent_include': tc.be_include,
        }
    except Exception as exc:  # pragma: no cover
        return {'error': f'{type(exc).__name__}: {exc}'}
