"""Variant expansion (ray parity: python/ray/tune/search/variant_generator.py).

Walks a nested param_space, expands every ``grid_search`` marker into a
cartesian product, and resolves Domain objects by sampling.
"""

from __future__ import annotations

import copy
import itertools
import random
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.tune.search.sample import Domain, Function


def _is_grid(value: Any) -> bool:
    return isinstance(value, dict) and set(value.keys()) == {"grid_search"}


def _walk(spec: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(spec, dict) and not _is_grid(spec):
        for k, v in spec.items():
            yield from _walk(v, path + (k,))
    elif isinstance(spec, (list, tuple)) and not isinstance(spec, str):
        for i, v in enumerate(spec):
            yield from _walk(v, path + (i,))
    else:
        yield path, spec


def _get(spec, path):
    for p in path:
        spec = spec[p]
    return spec


def _set(spec, path, value):
    for p in path[:-1]:
        spec = spec[p]
    spec[path[-1]] = value


def count_variants(spec: Dict) -> int:
    n = 1
    for _, v in _walk(spec):
        if _is_grid(v):
            n *= len(v["grid_search"])
    return n


def generate_variants(
    spec: Dict,
    rng: Optional[random.Random] = None,
) -> Iterator[Tuple[Dict, Dict]]:
    """Yield (resolved_param_str_map, config) per variant.

    Grid values enumerate; Domains sample fresh per variant per call.
    """
    grid_paths: List[Tuple] = []
    grid_values: List[List] = []
    for path, v in _walk(spec):
        if _is_grid(v):
            grid_paths.append(path)
            grid_values.append(v["grid_search"])

    combos = itertools.product(*grid_values) if grid_paths else [()]
    for combo in combos:
        config = copy.deepcopy(spec)
        resolved: Dict[str, Any] = {}
        for path, value in zip(grid_paths, combo):
            _set(config, path, value)
            resolved["/".join(str(p) for p in path)] = value
        # Sample every Domain leaf. Function domains see the partial spec so
        # sample_from can reference other parameters.
        for path, v in list(_walk(config)):
            if isinstance(v, Function):
                _set(config, path, v.sample(rng, spec=config))
                resolved["/".join(str(p) for p in path)] = _get(config, path)
            elif isinstance(v, Domain):
                _set(config, path, v.sample(rng))
                resolved["/".join(str(p) for p in path)] = _get(config, path)
        yield resolved, config


def format_vars(resolved: Dict[str, Any]) -> str:
    parts = []
    for k in sorted(resolved):
        v = resolved[k]
        short = k.split("/")[-1]
        if isinstance(v, float):
            parts.append(f"{short}={v:.4g}")
        else:
            parts.append(f"{short}={v}")
    return ",".join(parts)
