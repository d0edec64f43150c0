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

"""Command-line interface (reference ``brainevent/_cli.py``).

``brainevent-tpu benchmark-performance --platform gpu --data csr binary``
runs every registered primitive matching the given tags over its
benchmark-data grid and prints/saves the results.
"""

import argparse
import json
import sys
from typing import List, Optional

__all__ = ['main']


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='brainevent-tpu',
        description='brainevent-tpu: event-driven sparse operators for JAX.',
    )
    sub = parser.add_subparsers(dest='command')

    bench = sub.add_parser(
        'benchmark-performance',
        help='Benchmark registered primitives filtered by tags.',
    )
    bench.add_argument('--platform', default=None,
                       choices=['cpu', 'gpu'],
                       help='Platform to benchmark (default: current).')
    bench.add_argument('--data', nargs='*', default=[],
                       help='Tag filter, e.g. --data csr binary.')
    bench.add_argument('--output', default=None,
                       help='Write results as JSON to this path.')
    bench.add_argument('--n-runs', type=int, default=10)
    bench.add_argument('--n-warmup', type=int, default=3)
    bench.add_argument('--iterations', type=int, default=1,
                       help='Op applications fused per device call '
                            '(amortises the per-call dispatch).')
    bench.add_argument('--max-configs', type=int, default=0,
                       help='Bench at most N configs per primitive '
                            '(0 = all).')

    lst = sub.add_parser('list-primitives',
                         help='List registered primitives and their tags.')
    lst.add_argument('--data', nargs='*', default=[], help='Tag filter.')

    return parser


def _run_benchmark(args) -> int:
    import brainevent_tpu as be  # populates the registry
    from brainevent_tpu._error import BenchmarkDataFnNotProvidedError

    prims = be.get_primitives_by_tags(set(args.data))
    if not prims:
        print(f'No primitives match tags {args.data}; registered: '
              f'{be.get_all_primitive_names()}', file=sys.stderr)
        return 1
    all_records = []
    for name in sorted(prims):
        prim = prims[name]
        try:
            result = prim.benchmark(platform=args.platform,
                                    n_runs=args.n_runs,
                                    n_warmup=args.n_warmup,
                                    iterations=args.iterations,
                                    max_configs=args.max_configs)
        except BenchmarkDataFnNotProvidedError:
            continue
        except Exception as e:  # noqa: BLE001 - sweep must survive one kernel
            print(f'{name}: FAILED {type(e).__name__}: {str(e)[:200]}',
                  file=sys.stderr)
            all_records.append({'name': name, 'error': str(e)[:500]})
            continue
        all_records.extend(r.to_dict() for r in result.records)
    if args.output:
        with open(args.output, 'w') as f:
            json.dump(all_records, f, indent=2)
        print(f'Wrote {len(all_records)} records to {args.output}')
    return 0


def _list_primitives(args) -> int:
    import brainevent_tpu as be
    prims = be.get_primitives_by_tags(set(args.data))
    for name in sorted(prims):
        prim = prims[name]
        backends = {p: prim.available_backends(p) for p in ('cpu', 'gpu')}
        print(f'{name:<40s} tags={sorted(prim.tags)} backends={backends}')
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.command == 'benchmark-performance':
        return _run_benchmark(args)
    if args.command == 'list-primitives':
        return _list_primitives(args)
    parser.print_help()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
