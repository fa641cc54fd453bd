"""Property-testing front-end: hypothesis when installed, a deterministic
fallback otherwise.

Copy-port of ``repro.testing.property`` (numpy): the port keeps its own
copy so that it imports nothing of the JAX package.

The test suite is property-based where the paper states laws (monotonicity,
composition, limits). CI and dev machines install the real ``hypothesis``
via ``pip install -e .[dev]``; hermetic containers without it still collect
and run every test through this shim, which samples each strategy with a
seeded generator and always includes the boundary points (min/max of every
range), so degenerate cases are never missed even at small example counts.

Usage (drop-in subset of the hypothesis API used by this repo)::

    from repro_torch.testing import given, settings, st

    @given(n=st.integers(1, 64), eta=st.floats(1e-4, 0.5))
    @settings(max_examples=50)
    def test_property(n, eta): ...
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

try:  # pragma: no cover - exercised only when hypothesis is installed
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

    import numpy as np

    _DEFAULT_MAX_EXAMPLES = 30

    class _Strategy:
        """A sampleable value range with explicit boundary examples."""

        def __init__(self, sample: Callable[[np.random.Generator], Any], boundaries: Sequence[Any] = ()):
            self._sample = sample
            self.boundaries = tuple(boundaries)

        def sample(self, rng: np.random.Generator) -> Any:
            return self._sample(rng)

    class _Strategies:
        @staticmethod
        def integers(min_value: int, max_value: int) -> _Strategy:
            return _Strategy(
                lambda rng: int(rng.integers(min_value, max_value + 1)),
                boundaries=(min_value, max_value),
            )

        @staticmethod
        def floats(min_value: float, max_value: float, **_kw) -> _Strategy:
            return _Strategy(
                lambda rng: float(rng.uniform(min_value, max_value)),
                boundaries=(min_value, max_value),
            )

        @staticmethod
        def booleans() -> _Strategy:
            return _Strategy(lambda rng: bool(rng.integers(0, 2)), boundaries=(False, True))

        @staticmethod
        def sampled_from(options: Sequence[Any]) -> _Strategy:
            opts = list(options)
            return _Strategy(lambda rng: opts[int(rng.integers(len(opts)))], boundaries=opts[:2])

        @staticmethod
        def lists(elements: _Strategy, *, min_size: int = 0, max_size: int = 10) -> _Strategy:
            def sample(rng: np.random.Generator):
                size = int(rng.integers(min_size, max_size + 1))
                return [elements.sample(rng) for _ in range(size)]

            # boundary must be hashable (dedup via dict.fromkeys) -> tuple
            return _Strategy(sample, boundaries=(tuple([elements.boundaries[0]] * max(min_size, 1)),))

    st = _Strategies()

    def settings(max_examples: int = _DEFAULT_MAX_EXAMPLES, **_kw):
        """Accepts (a subset of) hypothesis.settings kwargs; others ignored."""

        def deco(fn):
            fn._prop_max_examples = max_examples
            return fn

        return deco

    import inspect

    def given(**strategies: _Strategy):
        """Run the test on boundary combinations first, then seeded samples."""

        def deco(fn):
            def wrapper(*args, **kwargs):
                max_examples = getattr(fn, "_prop_max_examples", _DEFAULT_MAX_EXAMPLES)
                names = list(strategies)
                # boundary pass: all-min, all-max, plus each argument at its
                # other extreme one at a time — every strategy's min AND max
                # is exercised with O(k) combos, however many arguments
                grids = [strategies[n].boundaries or () for n in names]
                combos = []
                if all(grids):
                    lo = tuple(g[0] for g in grids)
                    hi = tuple(g[-1] for g in grids)
                    combos = [lo, hi]
                    for i in range(len(names)):
                        combos.append(lo[:i] + (hi[i],) + lo[i + 1:])
                        combos.append(hi[:i] + (lo[i],) + hi[i + 1:])
                for combo in dict.fromkeys(combos):
                    fn(*args, **dict(kwargs, **dict(zip(names, combo))))
                rng = np.random.default_rng(0)
                for _ in range(max_examples):
                    drawn: Dict[str, Any] = {n: strategies[n].sample(rng) for n in names}
                    fn(*args, **dict(kwargs, **drawn))

            # expose only the non-strategy params (e.g. pytest fixtures) so
            # the test collector doesn't look for fixtures named after them
            sig = inspect.signature(fn)
            keep = [p for name, p in sig.parameters.items() if name not in strategies]
            wrapper.__signature__ = sig.replace(parameters=keep)
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco


__all__ = ["HAVE_HYPOTHESIS", "given", "settings", "st"]
