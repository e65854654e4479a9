"""The system under test, built through the port's public entry points.

A configuration's `index` names a class of `turdb_tpu_torch.models` and
its constructor's keyword arguments; the rows go in by its `add` (numpy,
as a user hands them), which returns their ids. A traffic mix's `prepare`
lists methods called on the built index before any query (a serving
pack), its `entry` the method each call goes through and `kwargs` the
operating point; an ingest mix's waves go in by `add` too. Nothing here
knows an index by name."""

from __future__ import annotations

import importlib


def build_index(config: dict, mix: dict, base, device):
    """(the index, the ids its `add` of `base` returned)."""
    models = importlib.import_module("turdb_tpu_torch.models")
    spec = config["index"]
    index = getattr(models, spec["class"])(dim=config["data"]["params"]["dim"], device=device,
                                           **spec.get("kwargs", {}))
    ids = index.add(base)
    for step in mix.get("prepare", []):
        getattr(index, step["method"])(**step.get("kwargs", {}))
    return index, ids


def entry(index, mix: dict):
    """The cell's call: numpy queries in, (dists, ids) numpy out."""
    fn = getattr(index, mix["entry"])
    k, kwargs = mix["k"], dict(mix.get("kwargs", {}))
    return lambda queries: fn(queries, k, **kwargs)
