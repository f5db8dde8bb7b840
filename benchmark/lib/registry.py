"""Everything the harness runs is found by name under `benchmark/`:

  * a cell:               `workloads/<name>.json` ({"config", "traffic", ...})
  * a configuration:      `configs/<name>.json` and its module `configs/<name>.py`
  * a traffic mix:        `traffic/<name>.json`, read by `traffic/generate.py`
  * a per-layer metric:   `metrics/<name>.py` (NAME, UNIT, BETTER, LAYER, MOVES,
                          SOURCE, `read(summary)`, and optionally SITE/`work`)

so a later change adds a cell, a configuration, a mix or a metric as new
files alone."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r} ({path.name})")
    return json.loads(path.read_text())


def _module(kind: str, name: str, root: Path = ROOT):
    path = Path(root) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str, root: Path = ROOT) -> dict:
    return _json("workloads", name, root)


def config(name: str, root: Path = ROOT) -> dict:
    return _json("configs", name, root)


def config_module(name: str, root: Path = ROOT):
    """The module of configuration `name` (`configs/<name>.py`): its `Build`."""
    return _module("configs", name, root)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json("traffic", name, root)


def metrics(root: Path = ROOT) -> list:
    """Every per-layer metric module under `metrics/`, by name."""
    return [_module("metrics", p.stem, root) for p in sorted((Path(root) / "metrics").glob("*.py"))
            if not p.stem.startswith("_")]
