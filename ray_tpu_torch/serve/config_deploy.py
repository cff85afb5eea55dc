"""Declarative Serve deployment from a config dict or file. Port of
ray_tpu/serve/config_deploy.py (reference: python/ray/serve/schema.py
ServeDeploySchema, the config `serve deploy` applies).

Config shape::

    {"applications": [{
        "name": "app1",                       # optional
        "import_path": "my_module:app",       # a BOUND Deployment
        "route_prefix": "/app1",              # optional
        "deployments": [{                     # optional per-deployment
            "name": "Model",                  #   overrides by name
            "num_replicas": 4,
            "user_config": {...},
            "autoscaling_config": {...},
        }],
    }]}

`deploy_config(cfg)` imports each application's bound Deployment,
applies the overrides and serve.run()s it; `status()` reports what runs.
"""

from __future__ import annotations

import importlib
import json
from typing import Any

from ray_tpu_torch.serve.deployment import AutoscalingConfig, Deployment


def _import_app(path: str) -> Deployment:
    if ":" in path:
        mod_name, attr = path.split(":", 1)
    else:
        mod_name, _, attr = path.rpartition(".")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    if not isinstance(obj, Deployment):
        raise TypeError(f"{path!r} resolved to {type(obj).__name__}, "
                        "expected a bound Deployment")
    return obj


def _graph_names(dep: Deployment) -> set[str]:
    names = {dep.name}
    for a in list(dep._init_args) + list(dep._init_kwargs.values()):
        if isinstance(a, Deployment):
            names |= _graph_names(a)
    return names


# Per-deployment keys a config may override (DeploymentConfig fields).
_OVERRIDE_KEYS = {"num_replicas", "ray_actor_options", "autoscaling_config",
                  "max_ongoing_requests", "user_config"}


def _apply_overrides(app: Deployment, overrides: list[dict]) -> Deployment:
    """Per-deployment config overrides, applied through the whole bound
    graph (children live in init args). Unknown deployment names or
    config keys are ERRORS — a typo must not silently deploy defaults."""
    names = _graph_names(app)
    by_name = {}
    for o in overrides:
        if "name" not in o:
            raise ValueError(f"deployment override missing 'name': {o}")
        if o["name"] not in names:
            raise ValueError(
                f"override for unknown deployment {o['name']!r}; "
                f"this application has {sorted(names)}")
        bad = set(o) - _OVERRIDE_KEYS - {"name"}
        if bad:
            raise ValueError(
                f"unknown config keys for deployment {o['name']!r}: "
                f"{sorted(bad)}; valid: {sorted(_OVERRIDE_KEYS)}")
        by_name[o["name"]] = o

    def rewrite(dep: Deployment) -> Deployment:
        new_args = tuple(rewrite(a) if isinstance(a, Deployment) else a
                         for a in dep._init_args)
        new_kwargs = {k: rewrite(v) if isinstance(v, Deployment) else v
                      for k, v in dep._init_kwargs.items()}
        out = Deployment(dep._target, dep._config, new_args, new_kwargs)
        o = by_name.get(dep.name)
        if o:
            opts = {k: v for k, v in o.items() if k != "name"}
            if isinstance(opts.get("autoscaling_config"), dict):
                opts["autoscaling_config"] = AutoscalingConfig(
                    **opts["autoscaling_config"])
            out = out.options(**opts)
        return out

    return rewrite(app)


def deploy_config(config: dict | str, *, prune: bool = True) -> dict:
    """Apply the config as the GOAL STATE (reference: serve deploy):
    every listed application deploys, and (with prune=True) deployments
    not in any listed application are deleted. Returns {app_name: handle}.

    `config` may be a dict, a JSON object string, or a path to a JSON
    file (anything not starting with '{'/'[')."""
    from ray_tpu_torch import serve

    if isinstance(config, str):
        if config.lstrip().startswith(("{", "[")):
            config = json.loads(config)
        else:
            with open(config) as f:  # missing file -> FileNotFoundError
                config = json.load(f)
    # Phase 1 — resolve and validate EVERY app before touching the
    # cluster, so one bad import_path cannot leave a half-applied config.
    resolved = []
    for i, app in enumerate(config.get("applications", [])):
        dep = _import_app(app["import_path"])
        dep = _apply_overrides(dep, app.get("deployments", []))
        resolved.append((app.get("name") or f"app{i}",
                         dep, app.get("route_prefix")))
    # Phase 2 — deploy.
    handles = {}
    wanted: set[str] = set()
    for name, dep, route_prefix in resolved:
        handles[name] = serve.run(dep, route_prefix=route_prefix)
        wanted |= _graph_names(dep)
    # Phase 3 — prune deployments absent from the goal state.
    if prune:
        for existing in list(serve.status()):
            if existing not in wanted:
                serve.delete(existing)
    return handles
