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

"""Persistent XLA compilation cache rules.

Importing the package changes no JAX configuration. The repository's entry
points use ``config.entry_point_cache``: where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX reads it and nothing else is set; otherwise the cache goes to
the entry point's fixed directory (``<repo>/.jax_cache``). The
cross-*process* test proves a second process gets a real cache hit (via
jax's ``/jax/compilation_cache/cache_hits`` monitoring event) on the
program the first process compiled and persisted — the counterpart of the
reference's kernix artifact cache (``brainevent/_op/kernix_cache.py:41``).
"""

import os
import subprocess
import sys
import textwrap

import pytest

import brainevent_tpu as be

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(prog: str, **env_extra):
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['PYTHONPATH'] = _REPO + os.pathsep + env.get('PYTHONPATH', '')
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    env.update(env_extra)
    return subprocess.run([sys.executable, '-c', prog], capture_output=True,
                          text=True, env=env, timeout=240)


@pytest.mark.parametrize('env_dir', [None, 'set'])
def test_import_changes_no_jax_config(tmp_path, env_dir):
    extra = {} if env_dir is None else {
        'JAX_COMPILATION_CACHE_DIR': str(tmp_path / 'from_env')}
    r = _run(
        "import jax; keys = ('jax_compilation_cache_dir', "
        "'jax_persistent_cache_min_compile_time_secs', 'jax_platforms'); "
        "before = {k: getattr(jax.config, k) for k in keys}; "
        "import brainevent_tpu as be; "
        "after = {k: getattr(jax.config, k) for k in keys}; "
        "assert before == after, (before, after); "
        "assert be.config.get_compilation_cache() is None; print('OK')",
        **extra)
    assert r.returncode == 0 and 'OK' in r.stdout, r.stderr


def test_entry_cache_uses_env_dir_and_sets_nothing(tmp_path):
    env_dir = str(tmp_path / 'from_env')
    default = str(tmp_path / 'default')
    r = _run(
        "import os, jax; from brainevent_tpu import config; "
        f"got = config.entry_point_cache({default!r}); "
        f"assert got == {env_dir!r}, got; "
        f"assert jax.config.jax_compilation_cache_dir == {env_dir!r}; "
        "assert config.get_compilation_cache() is None; "
        f"assert not os.path.exists({default!r}); print('OK')",
        JAX_COMPILATION_CACHE_DIR=env_dir)
    assert r.returncode == 0 and 'OK' in r.stdout, r.stderr


def test_entry_cache_defaults_to_fixed_dir(tmp_path):
    default = str(tmp_path / 'repo' / '.jax_cache')
    r = _run(
        "import os, jax; from brainevent_tpu import config; "
        f"got = config.entry_point_cache({default!r}); "
        f"assert got == {default!r}, got; "
        f"assert jax.config.jax_compilation_cache_dir == {default!r}; "
        f"assert os.path.isdir({default!r}); print('OK')")
    assert r.returncode == 0 and 'OK' in r.stdout, r.stderr


def test_entry_points_use_repo_jax_cache():
    # bench.py, chip_smoke.py and the examples all key the cache on the
    # repository's own .jax_cache directory
    for rel in ('bench.py', 'chip_smoke.py', 'examples/COBA_2005.py',
                'examples/CUBA_2005.py'):
        with open(os.path.join(_REPO, rel)) as f:
            src = f.read()
        assert 'entry_point_cache(' in src and "'.jax_cache'" in src, rel


def test_set_none_disables():
    prev = be.config.get_compilation_cache()
    try:
        be.config.set_compilation_cache(None)
        assert be.config.get_compilation_cache() is None
    finally:
        if prev is not None:
            be.config.set_compilation_cache(prev)


@pytest.mark.slow
def test_second_process_hits_cache(tmp_path):
    """Process 1 compiles + persists; process 2 must get a cache HIT."""
    d = str(tmp_path / 'xc')
    prog = textwrap.dedent("""
        import os, sys
        import brainevent_tpu as be
        be.config.set_compilation_cache(os.environ['BE_TEST_CACHE'],
                                        min_compile_time_secs=0.0)
        import jax, jax.monitoring, numpy as np, jax.numpy as jnp
        hits = []
        jax.monitoring.register_event_listener(
            lambda event, **kw: hits.append(event)
            if 'compilation_cache/cache_hits' in event else None)
        x = np.ones((256, 256), np.float32)
        csr = be.CSR.fromdense(jnp.where(x * np.random.default_rng(0)
                                         .random((256, 256)) > .99, x, 0.))
        f = jax.jit(lambda v: csr @ v)
        f(np.ones(256, np.float32)).block_until_ready()
        print('HITS', len(hits))
    """)
    r1 = _run(prog, BE_TEST_CACHE=d)
    assert r1.returncode == 0, r1.stderr
    assert os.path.isdir(d) and len(os.listdir(d)) >= 1, (
        'first process persisted nothing', r1.stdout, r1.stderr)
    r2 = _run(prog, BE_TEST_CACHE=d)
    assert r2.returncode == 0, r2.stderr
    n_hits = int(r2.stdout.strip().rsplit('HITS', 1)[1])
    assert n_hits >= 1, ('second process missed the cache',
                         r2.stdout, r2.stderr)


def test_entry_cache_treats_empty_env_as_unset(tmp_path):
    default = str(tmp_path / '.jax_cache')
    r = _run(
        "import jax; from brainevent_tpu import config; "
        f"got = config.entry_point_cache({default!r}); "
        f"assert got == {default!r}, got; print('OK')",
        JAX_COMPILATION_CACHE_DIR='')
    assert r.returncode == 0 and 'OK' in r.stdout, r.stderr
