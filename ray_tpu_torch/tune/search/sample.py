"""Search-space domains (ray parity: python/ray/tune/search/sample.py).

Domains are declarative distributions placed in ``param_space``; the variant
generator resolves them per trial. ``grid_search`` is a dict marker (parity
with the reference's ``{"grid_search": [...]}``).
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, List, Optional, Sequence


class Domain:
    """A sampleable parameter domain."""

    sampler: Optional["Domain"] = None

    def sample(self, rng: Optional[random.Random] = None) -> Any:
        raise NotImplementedError

    def uniform(self) -> "Domain":
        return self

    def __repr__(self):
        return f"{type(self).__name__}()"


class Float(Domain):
    def __init__(self, lower: float, upper: float):
        self.lower = float(lower)
        self.upper = float(upper)

    def sample(self, rng=None):
        rng = rng or random
        return rng.uniform(self.lower, self.upper)

    def quantized(self, q: float) -> "Quantized":
        return Quantized(self, q)

    def loguniform(self) -> "LogUniform":
        return LogUniform(self.lower, self.upper)

    def __repr__(self):
        return f"Float({self.lower}, {self.upper})"


class LogUniform(Float):
    def __init__(self, lower: float, upper: float, base: float = 10.0):
        super().__init__(lower, upper)
        if lower <= 0 or upper <= 0:
            raise ValueError("loguniform requires positive bounds")
        self.base = base

    def sample(self, rng=None):
        rng = rng or random
        lo, hi = math.log(self.lower), math.log(self.upper)
        return math.exp(rng.uniform(lo, hi))

    def __repr__(self):
        return f"LogUniform({self.lower}, {self.upper})"


class Normal(Domain):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean = mean
        self.sd = sd

    def sample(self, rng=None):
        rng = rng or random
        return rng.gauss(self.mean, self.sd)


class Integer(Domain):
    """Uniform integer in [lower, upper) — half-open, matching the reference."""

    def __init__(self, lower: int, upper: int):
        self.lower = int(lower)
        self.upper = int(upper)

    def sample(self, rng=None):
        rng = rng or random
        return rng.randrange(self.lower, self.upper)

    def __repr__(self):
        return f"Integer({self.lower}, {self.upper})"


class LogInteger(Integer):
    def __init__(self, lower: int, upper: int, base: float = 10.0):
        super().__init__(lower, upper)
        if lower <= 0:
            raise ValueError("lograndint requires positive bounds")
        self.base = base

    def sample(self, rng=None):
        rng = rng or random
        lo, hi = math.log(self.lower), math.log(self.upper)
        return int(math.exp(rng.uniform(lo, hi)))


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng=None):
        rng = rng or random
        return rng.choice(self.categories)

    def grid(self) -> dict:
        return grid_search(self.categories)

    def __len__(self):
        return len(self.categories)

    def __repr__(self):
        return f"Categorical({self.categories})"


class Function(Domain):
    """``sample_from`` — arbitrary callable of the (partial) spec."""

    def __init__(self, func: Callable):
        self.func = func

    def sample(self, rng=None, spec: Optional[dict] = None):
        try:
            return self.func(spec)
        except TypeError:
            return self.func()


class Quantized(Domain):
    def __init__(self, base: Domain, q: float):
        self.base_domain = base
        self.q = q

    def sample(self, rng=None):
        v = self.base_domain.sample(rng)
        quantized = round(v / self.q) * self.q
        if isinstance(self.q, int) or float(self.q).is_integer():
            quantized = int(quantized)
        return quantized


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Quantized:
    return Quantized(Float(lower, upper), q)


def loguniform(lower: float, upper: float, base: float = 10.0) -> LogUniform:
    return LogUniform(lower, upper, base)


def qloguniform(lower: float, upper: float, q: float) -> Quantized:
    return Quantized(LogUniform(lower, upper), q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def qrandn(mean: float, sd: float, q: float) -> Quantized:
    return Quantized(Normal(mean, sd), q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Quantized:
    return Quantized(Integer(lower, upper), q)


def lograndint(lower: int, upper: int, base: float = 10.0) -> LogInteger:
    return LogInteger(lower, upper, base)


def qlograndint(lower: int, upper: int, q: int) -> Quantized:
    return Quantized(LogInteger(lower, upper), q)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(func: Callable) -> Function:
    return Function(func)


def grid_search(values: List[Any]) -> dict:
    """Marker resolved exhaustively by the variant generator."""
    return {"grid_search": list(values)}
