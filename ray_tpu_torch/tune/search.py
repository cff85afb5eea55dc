"""Search spaces + variant generation. Port of ray_tpu/tune/search.py.

Parity: reference python/ray/tune/search/ — sample spaces
(tune.uniform/loguniform/choice/randint), grid_search, and
BasicVariantGenerator (search/basic_variant.py) expanding param_space
dicts into trial configs.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Domain:
    sampler: Callable[[random.Random], Any]
    # Bounds metadata (None when the domain isn't an ordered range) — lets
    # model-based searchers keep resampled candidates inside the space.
    low: float | None = None
    high: float | None = None
    integer: bool = False
    # Scale/shape metadata for external optimizers (OptunaSearch maps
    # log -> suggest_float(log=True), options -> suggest_categorical).
    log: bool = False
    options: list | None = None

    def sample(self, rng: random.Random):
        return self.sampler(rng)

    def clamp(self, value):
        """Project a (possibly out-of-range) candidate back into bounds."""
        if self.low is not None:
            value = max(self.low, min(self.high, value))
        if self.integer:
            value = int(round(value))
            if self.high is not None:
                # randint's high is exclusive, matching the sampler.
                value = min(value, int(self.high) - 1)
        return value


def uniform(low: float, high: float) -> Domain:
    return Domain(lambda rng: rng.uniform(low, high), low=low, high=high)


def loguniform(low: float, high: float) -> Domain:
    return Domain(
        lambda rng: math.exp(rng.uniform(math.log(low), math.log(high))),
        low=low, high=high, log=True)


def randint(low: int, high: int) -> Domain:
    return Domain(lambda rng: rng.randrange(low, high), low=low, high=high,
                  integer=True)


def choice(options: list) -> Domain:
    opts = list(options)
    return Domain(lambda rng: rng.choice(opts), options=opts)


def quniform(low: float, high: float, q: float) -> Domain:
    return Domain(lambda rng: round(rng.uniform(low, high) / q) * q,
                  low=low, high=high)


@dataclass
class GridSearch:
    values: list


def grid_search(values: list) -> GridSearch:
    return GridSearch(list(values))


def generate_variants(param_space: dict, num_samples: int = 1,
                      seed: int | None = None) -> list[dict]:
    """Expand grid axes (cross product) × num_samples random draws.

    Matches the reference semantics: num_samples multiplies the grid
    (basic_variant.py)."""
    rng = random.Random(seed)
    grid_axes: list[tuple[str, list]] = []

    def find_grids(prefix: str, node):
        if isinstance(node, GridSearch):
            grid_axes.append((prefix, node.values))
        elif isinstance(node, dict):
            for k, v in node.items():
                find_grids(f"{prefix}.{k}" if prefix else k, v)

    find_grids("", param_space)

    def grid_combos(axes):
        if not axes:
            return [{}]
        key, values = axes[0]
        rest = grid_combos(axes[1:])
        return [{**r, key: v} for v in values for r in rest]

    def resolve(node, overrides: dict, prefix: str = ""):
        if isinstance(node, GridSearch):
            return overrides[prefix]
        if isinstance(node, Domain):
            return node.sample(rng)
        if isinstance(node, dict):
            return {k: resolve(v, overrides, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if callable(node) and not isinstance(node, type):
            return node()
        return node

    variants = []
    for _ in range(num_samples):
        for combo in grid_combos(grid_axes):
            variants.append(resolve(param_space, combo))
    return variants


# ---------------------------------------------------------------------------
# Searchers: sequential config suggestion informed by completed trials
# (parity: reference tune/search/searcher.py protocol + the model-based
# algorithms wired through it — Optuna/HyperOpt/BOHB. Those engines aren't
# vendored; TPESearcher below is a native tree-structured-Parzen-style
# implementation of the same suggest/observe contract.)
# ---------------------------------------------------------------------------


def _flatten(space: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in space.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


class Searcher:
    """Suggest/observe protocol (reference: tune/search/searcher.py)."""

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, config: dict,
                          metric_value: float | None) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Random/grid sampling through the Searcher protocol (reference:
    tune/search/basic_variant.py)."""

    def __init__(self, param_space: dict, num_samples: int = 1,
                 seed: int | None = None):
        self._variants = generate_variants(param_space, num_samples, seed)
        self._next = 0

    def suggest(self, trial_id: str) -> dict | None:
        if self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg


class TPESearcher(Searcher):
    """Tree-structured Parzen estimator over Domain leaves (Bergstra et
    al. 2011 — the model behind HyperOpt/BOHB): completed trials split
    into good/bad by metric quantile; candidates are drawn from a kernel
    density around good points and ranked by the good/bad density ratio.
    Non-Domain leaves pass through as constants."""

    def __init__(self, param_space: dict, *, metric: str, mode: str = "max",
                 num_samples: int = 32, n_initial: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: int | None = None):
        assert mode in ("max", "min")
        self.space = _flatten(param_space)
        self.metric = metric
        self.mode = mode
        self.max_suggestions = num_samples
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._suggested = 0
        # (flat_config, signed_metric) for completed trials
        self.observations: list[tuple[dict, float]] = []

    # -- observation --

    def on_trial_complete(self, trial_id: str, config: dict,
                          metric_value: float | None) -> None:
        if metric_value is None:
            return
        sign = metric_value if self.mode == "max" else -metric_value
        self.observations.append((_flatten(config), sign))

    # -- suggestion --

    def _random_flat(self) -> dict:
        out = {}
        for k, v in self.space.items():
            if isinstance(v, Domain):
                out[k] = v.sample(self.rng)
            elif isinstance(v, GridSearch):
                out[k] = self.rng.choice(v.values)
            else:
                out[k] = v
        return out

    def _kde_logpdf(self, points: list[float], x: float, bw: float) -> float:
        if not points:
            return -1e9
        acc = 0.0
        for p in points:
            acc += math.exp(-0.5 * ((x - p) / bw) ** 2)
        return math.log(acc / len(points) + 1e-12)

    def suggest(self, trial_id: str) -> dict | None:
        if self._suggested >= self.max_suggestions:
            return None
        self._suggested += 1
        if len(self.observations) < self.n_initial:
            return _unflatten(self._random_flat())

        ranked = sorted(self.observations, key=lambda o: o[1], reverse=True)
        n_good = max(1, int(len(ranked) * self.gamma))
        good, bad = ranked[:n_good], ranked[n_good:]

        numeric = [k for k, v in self.space.items()
                   if isinstance(v, Domain)
                   and isinstance(good[0][0].get(k), (int, float))
                   and not isinstance(good[0][0].get(k), bool)]
        best_cfg, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand = self._random_flat()
            # Resample numeric dims around good observations (Parzen draw),
            # projected back into the Domain's bounds (a gauss draw around
            # a small loguniform anchor would otherwise go negative).
            for k in numeric:
                vals = [o[0][k] for o in good if k in o[0]]
                if vals:
                    anchor = self.rng.choice(vals)
                    spread = (max(vals) - min(vals)) or abs(anchor) or 1.0
                    draw = self.rng.gauss(anchor, 0.3 * spread) \
                        if isinstance(vals[0], float) \
                        else self.rng.gauss(anchor, max(1.0, 0.3 * spread))
                    dom = self.space[k]
                    cand[k] = type(vals[0])(dom.clamp(draw))
            score = 0.0
            for k in numeric:
                g = [o[0][k] for o in good if k in o[0]]
                b = [o[0][k] for o in bad if k in o[0]]
                bw = ((max(g) - min(g)) or abs(g[0]) or 1.0) * 0.3 \
                    if g else 1.0
                score += self._kde_logpdf(g, cand[k], bw) \
                    - self._kde_logpdf(b, cand[k], bw)
            if score > best_score:
                best_score, best_cfg = score, cand
        return _unflatten(best_cfg)


class ExternalSearcher(Searcher):
    """Adapter surface for third-party ask/tell optimizers (reference:
    tune/search/ wraps Optuna/HyperOpt/Ax behind Searcher). Any object
    pair (ask() -> config | None, tell(config, value)) plugs in; the
    Tuner only ever sees the Searcher protocol."""

    def __init__(self, ask, tell=None):
        self._ask = ask
        self._tell = tell

    def suggest(self, trial_id: str) -> dict | None:
        return self._ask()

    def on_trial_complete(self, trial_id: str, config: dict,
                          metric_value: float | None) -> None:
        if self._tell is not None and metric_value is not None:
            self._tell(config, metric_value)


class OptunaSearch(ExternalSearcher):
    """Optuna-backed searcher (reference: tune/search/optuna/). Requires
    the optuna package; this image does not bundle it, so construction
    raises ImportError with a clear message when absent."""

    def __init__(self, param_space: dict, *, metric: str, mode: str = "max",
                 num_samples: int = 32, seed: int | None = None):
        try:
            import optuna
        except ImportError as e:  # pragma: no cover - dep not in image
            raise ImportError(
                "OptunaSearch requires the 'optuna' package") from e
        space = _flatten(param_space)
        study = optuna.create_study(
            direction="maximize" if mode == "max" else "minimize",
            sampler=optuna.samplers.TPESampler(seed=seed))
        self._budget = num_samples
        self._asked = 0
        self._rng = random.Random(seed)
        self._trials: dict[int, Any] = {}

        def ask():
            if self._asked >= self._budget:
                return None
            self._asked += 1
            t = study.ask()
            cfg = {}
            for k, v in space.items():
                if isinstance(v, Domain) and v.options is not None:
                    cfg[k] = t.suggest_categorical(k, v.options)
                elif isinstance(v, Domain) and v.low is not None:
                    if v.integer:
                        cfg[k] = t.suggest_int(k, int(v.low),
                                               int(v.high) - 1)
                    else:
                        cfg[k] = t.suggest_float(k, v.low, v.high,
                                                 log=v.log)
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(self._rng)
                else:
                    cfg[k] = v
            self._trials[tuple(sorted(cfg.items()))] = t
            return _unflatten(cfg)

        def tell(config, value):
            t = self._trials.pop(
                tuple(sorted(_flatten(config).items())), None)
            if t is not None:
                study.tell(t, value)

        super().__init__(ask, tell)


def bohb(param_space: dict, *, metric: str, mode: str = "max",
         num_samples: int = 16, max_t: int = 32, reduction_factor: int = 3,
         seed: int | None = None):
    """BOHB (Falkner et al. 2018) = HyperBand's budget allocation + a
    TPE-style KDE model proposing configs (reference:
    tune/schedulers/hb_bohb.py + tune/search/bohb/). Returns
    (searcher, scheduler) to pass to the Tuner."""
    from ray_tpu_torch.tune.schedulers import HyperBandScheduler

    searcher = TPESearcher(param_space, metric=metric, mode=mode,
                           num_samples=num_samples, seed=seed)
    scheduler = HyperBandScheduler(metric=metric, mode=mode, max_t=max_t,
                                   reduction_factor=reduction_factor)
    return searcher, scheduler
