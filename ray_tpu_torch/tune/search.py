"""Search spaces + searchers.

ray: python/ray/tune/search/ — sample.py (Domain/grid_search/choice/uniform/
loguniform/randint), basic_variant.py (BasicVariantGenerator: grid
cross-product x num_samples random draws).  Optuna/hyperopt adapters are out
of scope (external deps); the Searcher ABC gives the same plug-in seam.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Callable, Dict, Iterator, List, Optional


# -- domains ----------------------------------------------------------------


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        assert low > 0 and high > low
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


class Randint(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class SampleFrom(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> Randint:
    return Randint(low, high)


def sample_from(fn) -> SampleFrom:
    return SampleFrom(fn)


# -- variant generation -----------------------------------------------------


def _split_spec(spec: Dict) -> tuple:
    """Walk a (possibly nested) param space; return (grid_paths, sample_paths)."""
    grids: List[tuple] = []
    samples: List[tuple] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, GridSearch):
            grids.append((path, node))
        elif isinstance(node, Domain):
            samples.append((path, node))

    walk(spec, ())
    return grids, samples


def _set_path(d: Dict, path: tuple, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _copy_spec(node):
    if isinstance(node, dict):
        return {k: _copy_spec(v) for k, v in node.items()}
    return node


class Searcher:
    """ray: python/ray/tune/search/searcher.py — the plug-in seam."""

    def set_search_properties(self, metric: Optional[str], mode: Optional[str]):
        self.metric, self.mode = metric, mode

    def suggest(self, trial_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict):
        pass

    def on_trial_complete(self, trial_id: str, result: Optional[Dict], error: bool):
        pass

    def save_state(self) -> Dict:
        return {}

    def restore_state(self, state: Dict):
        pass


class BasicVariantGenerator(Searcher):
    """Grid cross-product x num_samples random draws
    (ray: tune/search/basic_variant.py)."""

    def __init__(self, param_space: Dict, num_samples: int = 1, seed: Optional[int] = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._variants = list(self._generate())
        self._next = 0

    def _generate(self) -> Iterator[Dict]:
        grids, samples = _split_spec(self.param_space)
        grid_axes = [
            [(path, v) for v in gs.values] for path, gs in grids
        ] or [[]]
        for _ in range(self.num_samples):
            for combo in itertools.product(*grid_axes) if grids else [()]:
                cfg = _copy_spec(self.param_space)
                for path, value in combo:
                    _set_path(cfg, path, value)
                for path, dom in samples:
                    _set_path(cfg, path, dom.sample(self.rng))
                # strip any leftover Domain objects (fixed values pass through)
                yield cfg

    def total(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg

    def save_state(self) -> Dict:
        return {"next": self._next, "rng": self.rng.getstate()}

    def restore_state(self, state: Dict):
        self._next = state["next"]
        self.rng.setstate(state["rng"])


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator — the model-based search algorithm
    behind optuna/hyperopt (ray: tune/search/optuna/optuna_search.py and
    search/hyperopt/ adapt external implementations; here the estimator is
    native, so model-based search needs no extra dependency).

    After `n_initial` random trials, observations split into good/bad by
    the `gamma` quantile; each dimension gets a Parzen (kernel-density)
    estimator per group, candidates are drawn from the good-group density
    and ranked by the density ratio l(x)/g(x) (dimensions treated
    independently, as in the original TPE formulation).
    """

    def __init__(
        self,
        param_space: Dict,
        num_samples: int = 32,
        n_initial: int = 8,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        self.param_space = param_space
        self.num_samples = num_samples
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self.metric: Optional[str] = None
        self.mode: str = "max"
        self._suggested = 0
        self._obs: List[tuple] = []  # (flat_values dict, score: higher=better)
        grids, samples = _split_spec(param_space)
        # Grid values participate as categorical dims (TPE has no notion
        # of exhaustive sweeps).
        self._dims: Dict[tuple, Domain] = {p: d for p, d in samples}
        for p, gs in grids:
            self._dims[p] = Categorical(gs.values)

    # -- per-dimension density machinery --------------------------------
    def _to_internal(self, dom: Domain, v):
        if isinstance(dom, LogUniform):
            return math.log(v)
        return v

    def _from_internal(self, dom: Domain, v):
        if isinstance(dom, LogUniform):
            return math.exp(v)
        if isinstance(dom, Randint):
            return int(min(dom.high - 1, max(dom.low, round(v))))
        return v

    def _bounds(self, dom: Domain):
        if isinstance(dom, LogUniform):
            return math.log(dom.low), math.log(dom.high)
        if isinstance(dom, (Uniform, Randint)):
            return dom.low, dom.high
        return None

    def _kde_logpdf(self, xs: List[float], lo: float, hi: float, x: float) -> float:
        """Parzen estimator: Gaussian kernels at each observation, plus a
        uniform prior kernel over the bounds (hyperopt's regularization)."""
        width = max(hi - lo, 1e-12)
        bw = max(width / max(math.sqrt(len(xs)), 1.0), 1e-3 * width)
        total = 1.0 / width  # the prior kernel
        for c in xs:
            z = (x - c) / bw
            total += math.exp(-0.5 * z * z) / (bw * math.sqrt(2 * math.pi))
        return math.log(total / (len(xs) + 1))

    def _cat_logp(self, vals: List, categories: List, v) -> float:
        n = len(vals)
        k = len(categories)
        count = sum(1 for x in vals if x == v)
        return math.log((count + 1.0) / (n + k))

    # -- Searcher interface ----------------------------------------------
    def set_search_properties(self, metric, mode):
        self.metric, self.mode = metric, mode or "max"

    def _random_config(self) -> Dict:
        cfg = _copy_spec(self.param_space)
        for path, dom in self._dims.items():
            _set_path(cfg, path, dom.sample(self.rng))
        return cfg

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        if len(self._obs) < self.n_initial:
            return self._random_config()

        ranked = sorted(self._obs, key=lambda o: o[1], reverse=True)
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        good, bad = ranked[:n_good], ranked[n_good:] or ranked[-1:]

        cfg = _copy_spec(self.param_space)
        for path, dom in self._dims.items():
            gvals = [o[0][path] for o in good if path in o[0]]
            bvals = [o[0][path] for o in bad if path in o[0]]
            if isinstance(dom, Categorical):
                cands = [self.rng.choice(dom.categories) for _ in range(self.n_candidates)]
                best = max(
                    cands,
                    key=lambda v: self._cat_logp(gvals, dom.categories, v)
                    - self._cat_logp(bvals, dom.categories, v),
                )
                _set_path(cfg, path, best)
                continue
            bounds = self._bounds(dom)
            if bounds is None or not gvals:
                _set_path(cfg, path, dom.sample(self.rng))
                continue
            lo, hi = bounds
            g_int = [self._to_internal(dom, v) for v in gvals]
            b_int = [self._to_internal(dom, v) for v in bvals]
            width = max(hi - lo, 1e-12)
            bw = max(width / max(math.sqrt(len(g_int)), 1.0), 1e-3 * width)
            cands = []
            for _ in range(self.n_candidates):
                center = self.rng.choice(g_int)
                x = min(hi, max(lo, self.rng.gauss(center, bw)))
                cands.append(x)
            best = max(
                cands,
                key=lambda x: self._kde_logpdf(g_int, lo, hi, x)
                - self._kde_logpdf(b_int, lo, hi, x),
            )
            _set_path(cfg, path, self._from_internal(dom, best))
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[Dict], error: bool):
        if error or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        flat = {}
        # Record the dims actually suggested (walk the result's config).
        cfg = result.get("config") or {}
        for path in self._dims:
            node = cfg
            ok = True
            for k in path:
                if not isinstance(node, dict) or k not in node:
                    ok = False
                    break
                node = node[k]
            if ok:
                flat[path] = node
        if flat:
            self._obs.append((flat, score))

    def save_state(self) -> Dict:
        return {
            "suggested": self._suggested,
            "obs": list(self._obs),
            "rng": self.rng.getstate(),
        }

    def restore_state(self, state: Dict):
        self._suggested = state["suggested"]
        self._obs = list(state["obs"])
        self.rng.setstate(state["rng"])
