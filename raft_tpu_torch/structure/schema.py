"""Design-dictionary schema utilities (build time, numpy; counterpart of
``raft_tpu/structure/schema.py``).

``coerce`` mirrors the reference's ``getFromDict``: scalars broadcast to
requested shapes, lists are length-checked, and missing keys either
raise or take defaults.  :func:`load_design` takes a dict, a ``.json``
path (the standard library's parser) or a ``.yaml`` path (PyYAML,
imported only for that case).
"""

from __future__ import annotations

import json
import os

import numpy as np


def coerce(d, key, shape=0, dtype=float, default=None, index=None):
    """Fetch ``d[key]`` coerced to ``dtype`` and ``shape``.

    shape semantics:
      0   scalar expected;
      -1  any shape accepted (scalar stays scalar);
      n   1-D array of length n (scalars tile; ``index`` selects a column
          of 2-D input / tiles an element of 1-D input);
      [m, n]  2-D array (1-D rows tile m times).
    """
    if key in d:
        val = d[key]
        if shape == 0:
            if np.isscalar(val):
                return dtype(val)
            raise ValueError(f"'{key}' expected scalar, got {val!r}")
        if shape == -1:
            return dtype(val) if np.isscalar(val) else np.array(val, dtype=dtype)
        if np.isscalar(val):
            return np.tile(dtype(val), shape)
        if np.isscalar(shape):
            if len(val) != shape:
                raise ValueError(f"'{key}' expected length {shape}, got {val!r}")
            if index is None:
                return np.array([dtype(v) for v in val])
            arr = np.array(val)
            if arr.ndim == 1:
                return np.tile(arr[index], shape)
            return np.array([v[index] for v in val])
        arr = np.array(val, dtype=dtype)
        if list(arr.shape) == list(shape):
            return arr
        if arr.ndim == 1 and len(arr) == shape[1]:
            return np.tile(arr, [shape[0], 1])
        raise ValueError(f"'{key}' incompatible with shape {shape}: {val!r}")
    if default is None:
        raise ValueError(f"Key '{key}' not found in design input")
    if shape in (0, -1):
        return default
    if np.isscalar(default):
        return np.tile(default, shape)
    return np.tile(default, [shape, 1])


def load_design(path_or_dict):
    """A design dict from a dict (passed through), a ``.json`` path or a
    ``.yaml``/``.yml`` path."""
    if isinstance(path_or_dict, dict):
        return path_or_dict
    path = os.fspath(path_or_dict)
    with open(path) as f:
        if path.lower().endswith(".json"):
            return json.load(f)
        try:
            import yaml
        except ImportError:
            raise ImportError(
                f"{path}: reading a YAML design needs PyYAML, which is not "
                "installed; convert the design to JSON (the same dict) or "
                "pass the dict itself") from None
        return yaml.load(f, Loader=yaml.FullLoader)


def parse_cases(design):
    """The load-case table as a list of dicts."""
    if "cases" not in design:
        return []
    keys = design["cases"]["keys"]
    return [dict(zip(keys, row)) for row in design["cases"]["data"]]


def frequency_grid(design):
    """Angular frequency grid from the settings section: min_freq
    doubles as the bin width."""
    settings = design.get("settings", {}) or {}
    min_freq = coerce(settings, "min_freq", default=0.01)
    max_freq = coerce(settings, "max_freq", default=1.00)
    w = np.arange(min_freq, max_freq + 0.5 * min_freq, min_freq) * 2 * np.pi
    return w


def array_units(design):
    """The units of an ``array`` design as (unit design dict, array row)
    pairs, as the reference's array mode reads them: each row of
    ``array`` (``keys`` / ``data``: turbineID, platformID, mooringID,
    x_location, y_location, heading_adjust) picks its entries, 1-based,
    from the ``turbines`` / ``platforms`` / ``moorings`` lists (a single
    ``turbine`` / ``platform`` / ``mooring`` stands for a one-entry list;
    ID 0 means none).  Each unit design carries the shared ``site`` and
    ``settings``."""
    lists = {}
    for one, many in (("turbine", "turbines"), ("platform", "platforms"),
                      ("mooring", "moorings")):
        lists[one] = design.get(many)
        if lists[one] is None and one in design:
            lists[one] = [design[one]]
    units = []
    for row in design["array"]["data"]:
        info = dict(zip(design["array"]["keys"], row))
        unit = {"site": design["site"], "settings": design.get("settings", {})}
        for key in ("turbine", "platform", "mooring"):
            i = info.get(key + "ID", 1 if key == "platform" else 0)
            if i != 0:
                unit[key] = lists[key][i - 1]
        units.append((unit, info))
    return units


def array_mooring(design):
    """(MoorDyn file, bathymetry file or None) of the design's
    ``array_mooring`` section, or None without a file."""
    am = design.get("array_mooring") or {}
    if not am.get("file"):
        return None
    return am["file"], am.get("bathymetry")
