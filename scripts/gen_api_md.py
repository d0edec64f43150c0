# Regenerate docs/api.md: every public name of brainevent_tpu (plus the
# parallel / models / training / scatter surfaces),
# grouped by kind, with call signatures, first docstring lines,
# per-class method tables, and per-primitive backend availability.
import inspect

import brainevent_tpu as be
from brainevent_tpu.ops.core import XLACustomKernel

HEADER = """# API reference (generated)

Every public name of `brainevent_tpu` (and the `brainevent` drop-in
alias), grouped by kind, plus the `parallel`, `models`,
`models.training` and `ops.scatter` surfaces. Regenerate with
`python scripts/gen_api_md.py`.

Primitives marked `[prim]` are `XLACustomKernel` instances
(multi-backend, jit/grad/vmap-capable); their available backends per
platform are listed inline. Functions show their call signature; classes
list their public methods.
"""


def first_line(obj):
    doc = inspect.getdoc(obj) or ''
    return doc.split('\n')[0].strip()


def sig_of(obj):
    try:
        s = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return ''
    if len(s) > 110:
        s = s[:107] + '...)'
    return s


def prim_backends(p):
    """Render a primitive's per-platform backend table in one line."""
    parts = []
    for plat in ('cpu', 'gpu'):
        backends = p.available_backends(plat)
        if backends:
            parts.append(f'{plat}: {", ".join(backends)}')
    return '; '.join(parts)


def row(mod, n, prefix='', methods=False):
    try:
        obj = getattr(mod, n)
    except Exception:
        return []
    d = first_line(obj)
    if isinstance(obj, XLACustomKernel):
        line = f'- **`{prefix}{n}`** `[prim]`'
        if d:
            line += f' — {d}'
        bk = prim_backends(obj)
        if bk:
            line += f'\n  - backends: {bk}'
        return [line]
    if inspect.isclass(obj):
        line = f'- **`{prefix}{n}`** `[class]`'
        if d:
            line += f' — {d}'
        out = [line]
        if methods:
            for mn, mo in sorted(vars(obj).items()):
                if mn.startswith('_') or not callable(mo):
                    continue
                md = first_line(mo)
                ms = sig_of(mo)
                out.append(f'  - `.{mn}{ms}`' + (f' — {md}' if md else ''))
        return out
    if callable(obj):
        line = f'- **`{prefix}{n}{sig_of(obj)}`**'
        if d:
            line += f' — {d}'
        return [line]
    line = f'- **`{prefix}{n}`**'
    if d:
        line += f' — {d}'
    return [line]


def rows(mod, names, prefix='', methods=False):
    out = []
    for n in sorted(names, key=str.lower):
        out += row(mod, n, prefix, methods=methods)
    return out


from brainevent_tpu._deprecation import DEPRECATED_RENAMES  # noqa: E402

top = [n for n in dir(be)
       if not n.startswith('_') and n not in DEPRECATED_RENAMES]
top += ['__version__']
prims = [n for n in top if isinstance(getattr(be, n, None), XLACustomKernel)]
classes = [n for n in top
           if inspect.isclass(getattr(be, n, None))
           and not issubclass(getattr(be, n), Exception)]
errors = [n for n in top
          if inspect.isclass(getattr(be, n, None))
          and issubclass(getattr(be, n), Exception)]
rest = [n for n in top if n not in set(prims) | set(classes) | set(errors)]

lines = [HEADER]
lines.append('\n## Data structures and user-facing classes\n')
lines += rows(be, classes, methods=True)
lines.append('\n## Functions, config and tooling\n')
lines += rows(be, rest)
lines.append('\n## Registered primitives\n')
lines += rows(be, prims)
lines.append('\n## Error taxonomy\n')
lines += rows(be, errors)

for path in ('parallel', 'models', 'models.training', 'ops.scatter'):
    mod = be
    try:
        for part in path.split('.'):
            got = getattr(mod, part, None)
            mod = got if got is not None else __import__(
                f'brainevent_tpu.{path}', fromlist=[part])
    except Exception:
        continue
    pub = getattr(mod, '__all__', None) or [
        n for n in dir(mod) if not n.startswith('_')]
    lines.append(f'\n## `brainevent_tpu.{path}`\n')
    lines += rows(mod, pub, methods=(path in ('parallel', 'models',
                                              'models.training')))

with open('docs/api.md', 'w') as f:
    f.write('\n'.join(lines) + '\n')
print('wrote docs/api.md,', len(lines), 'lines')


# ---------------------------------------------------------------------------
# Per-module API pages (docs/api/<module>.md): the same rows, split by the
# subpackage each top-level name is defined in, so every package has its
# own reference page (reference parity: the reference's Sphinx per-module
# apidoc tree, docs/apis/).
# ---------------------------------------------------------------------------
import os

os.makedirs('docs/api', exist_ok=True)

MODULE_PAGES = {
    'events': 'Event representations (BinaryArray, BitPackedBinary, '
              'CompactBinary) and the 8 compact-encoder primitives.',
    'csr': 'Compressed sparse row/column matrices and their event/float/'
           'plasticity/dt2t primitives.',
    'dense': 'Dense matrices with event-driven products and plasticity.',
    'fcn': 'Fixed-number (ELL) connectivity classes and primitives.',
    'jitc': 'Just-in-time regenerated (implicit) connectivity: three '
            'weight families sharing one walk engine.',
    'rng': 'Counter-based and LFSR RNGs in pure uint32 JAX.',
    'ops': 'Operator dispatch core, benchmark harness, numba/C++ '
           'bridges and the event scatter-add.',
    'config': 'Global configuration knobs.',
    '_error': 'Error taxonomy.',
    '_misc': 'Index conversion helpers.',
    '_sddmm': 'Sampled dense-dense products.',
    '_registry': 'Primitive registry.',
}


def defining_module(n):
    obj = getattr(be, n, None)
    m = getattr(obj, '__module__', '') or ''
    if isinstance(obj, XLACustomKernel):
        # primitives carry no __module__; look them up via the registry
        import sys as _sys
        for mod_name, mod in list(_sys.modules.items()):
            if not mod_name.startswith('brainevent_tpu.'):
                continue
            if getattr(mod, n, None) is obj and not mod_name.endswith(
                    '__init__'):
                m = mod_name
                break
    if not m.startswith('brainevent_tpu'):
        return None
    parts = m.split('.')
    return parts[1] if len(parts) > 1 else None


by_mod = {}
for n in top:
    key = defining_module(n)
    if key is None:
        key = 'toplevel'
    by_mod.setdefault(key, []).append(n)

index_lines = ['# Per-module API reference\n',
               'Generated by `python scripts/gen_api_md.py`; one page per '
               'subpackage. The flat index lives in [`../api.md`](../api.md).\n']
for key in sorted(by_mod):
    page_names = by_mod[key]
    title = key.lstrip('_')
    blurb = MODULE_PAGES.get(key, '')
    body = [f'# `brainevent_tpu.{key}`\n']
    if blurb:
        body.append(blurb + '\n')
    mod_prims = [n for n in page_names
                 if isinstance(getattr(be, n, None), XLACustomKernel)]
    mod_classes = [n for n in page_names
                   if inspect.isclass(getattr(be, n, None))]
    mod_rest = [n for n in page_names
                if n not in set(mod_prims) | set(mod_classes)]
    if mod_classes:
        body.append('## Classes\n')
        body += rows(be, mod_classes, methods=True)
    if mod_rest:
        body.append('\n## Functions\n')
        body += rows(be, mod_rest)
    if mod_prims:
        body.append('\n## Primitives\n')
        body += rows(be, mod_prims)
    fname = f'docs/api/{title}.md'
    with open(fname, 'w') as f:
        f.write('\n'.join(body) + '\n')
    index_lines.append(f'- [`brainevent_tpu.{key}`]({title}.md) — '
                       f'{len(page_names)} public names')
    print('wrote', fname)

# submodule surfaces get their own pages too
for path in ('parallel', 'models', 'models.training', 'ops.scatter',
             'ops.cpp'):
    try:
        mod = __import__(f'brainevent_tpu.{path}',
                         fromlist=[path.split('.')[-1]])
    except Exception:
        continue
    pub = getattr(mod, '__all__', None) or [
        n for n in dir(mod) if not n.startswith('_')]
    body = [f'# `brainevent_tpu.{path}`\n']
    doc = inspect.getdoc(mod)
    if doc:
        body.append(doc.split('\n\n')[0] + '\n')
    body += rows(mod, pub, methods=True)
    fname = f'docs/api/{path.replace(".", "_")}.md'
    with open(fname, 'w') as f:
        f.write('\n'.join(body) + '\n')
    index_lines.append(f'- [`brainevent_tpu.{path}`]'
                       f'({path.replace(".", "_")}.md) — '
                       f'{len(pub)} public names')
    print('wrote', fname)

with open('docs/api/index.md', 'w') as f:
    f.write('\n'.join(index_lines) + '\n')
print('wrote docs/api/index.md')
