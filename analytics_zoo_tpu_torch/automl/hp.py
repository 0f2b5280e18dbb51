"""Hyper-parameter search-space primitives: the port's copy.

A copy of ``analytics_zoo_tpu/automl/hp.py`` (numpy and the standard
library only), pinned to it by ``tests/test_torch_serving_pins.py``: the
samplers ``choice``, ``uniform``, ``quniform``, ``loguniform`` and
``randint``, ``grid_search``, and ``sample_config``/``grid_configs``,
which draw the same configs as the reference for a seed.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Sequence

import numpy as np


class Sampler:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError


class choice(Sampler):
    def __init__(self, options: Sequence[Any]):
        self.options = list(options)

    def sample(self, rng):
        return self.options[int(rng.integers(len(self.options)))]


class uniform(Sampler):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = float(lower), float(upper)

    def sample(self, rng):
        return float(rng.uniform(self.lower, self.upper))


class quniform(Sampler):
    def __init__(self, lower: float, upper: float, q: float = 1.0):
        self.lower, self.upper, self.q = float(lower), float(upper), float(q)

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        return float(np.clip(round(v / self.q) * self.q,
                             self.lower, self.upper))


class loguniform(Sampler):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = float(lower), float(upper)

    def sample(self, rng):
        return float(math.exp(rng.uniform(math.log(self.lower),
                                          math.log(self.upper))))


class randint(Sampler):
    """Uniform integer in [lower, upper) — ray.tune semantics."""

    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = int(lower), int(upper)

    def sample(self, rng):
        return int(rng.integers(self.lower, self.upper))


class grid_search:
    """Exhaustive leaf: every value appears in the trial grid."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def _walk(space: Dict, prefix=()):
    for k, v in space.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(cfg: Dict, path, value):
    for k in path[:-1]:
        cfg = cfg.setdefault(k, {})
    cfg[path[-1]] = value


def sample_config(space: Dict, rng: np.random.Generator) -> Dict:
    """One concrete config: samplers sampled, grid leaves ignored here."""
    cfg: Dict = {}
    for path, v in _walk(space):
        if isinstance(v, Sampler):
            _set(cfg, path, v.sample(rng))
        elif isinstance(v, grid_search):
            continue
        else:
            _set(cfg, path, v)
    return cfg


def grid_configs(space: Dict) -> List[Dict]:
    """Cartesian product over all grid_search leaves (non-grid samplers are
    sampled later per trial; constants pass through). Returns [{}] when the
    space has no grid leaves."""
    grids = [(p, v.values) for p, v in _walk(space)
             if isinstance(v, grid_search)]
    if not grids:
        return [{}]
    out = []
    for combo in itertools.product(*[vals for _, vals in grids]):
        cfg: Dict = {}
        for (path, _), val in zip(grids, combo):
            _set(cfg, path, val)
        out.append(cfg)
    return out


def _merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out
