"""The port's plotting layer (``raft_tpu_torch/plotting.py``) against the
JAX package's.

Goldens: ``golden_omdao_plotting.npz`` (``tests/make_torch_port_fixtures.py
--omdao plotting``): the JAX member polylines and catenary points of the
spar and semi_wind demos, the two-unit farm's network line profiles, and
the number of lines each JAX plot function draws under the Agg backend.
Gates: every polyline point within 1e-10 x the largest coordinate of its
polyline; the line counts equal.
"""

import json
import os
import warnings

import matplotlib
import numpy as np
import pytest

from raft_tpu_torch import plotting
from raft_tpu_torch.models.model import Model

matplotlib.use("Agg")

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
TOL = 1e-10
SETS = ("spar", "semi_wind")
FARM = "design_farm_semi_wind_cases.json"

_MODELS = {}


def golden():
    return dict(np.load(os.path.join(FIX, "golden_omdao_plotting.npz")))


def model(name):
    if name not in _MODELS:
        fn = FARM if name == "farm_semi_wind" else f"design_{name}.json"
        with open(os.path.join(FIX, fn)) as f:
            _MODELS[name] = Model(json.load(f), base_dir=FIX)
    return _MODELS[name]


def close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err <= TOL * max(float(np.max(np.abs(b))), 1e-300), (what, err)


@pytest.mark.parametrize("name", SETS)
def test_member_polylines_match_golden(name):
    """Every member's station rings and longitudinal lines."""
    g = golden()
    fs = model(name).fowtList[0]
    off = np.array([fs.x_ref, fs.y_ref, 0.0])
    seen = set()
    for im, mem in enumerate(fs.members):
        if mem.part_of == "nacelle":
            continue
        for k, pts in enumerate(plotting._member_polylines(mem, off)):
            key = f"{name}_poly{im}_{k}"
            close(pts, g[key], key)
            seen.add(key)
    assert seen == {k for k in g if k.startswith(f"{name}_poly")}


@pytest.mark.parametrize("name", SETS)
def test_catenary_points_match_golden(name):
    """Each mooring line's catenary profile, anchor to fairlead."""
    g = golden()
    m = model(name)
    fs, ms = m.fowtList[0], m.ms_list[0]
    off = np.array([fs.x_ref, fs.y_ref, 0.0])
    for il in range(ms.n_lines):
        pts = plotting._catenary_points(ms.r_anchor[il], off + ms.r_fair0[il],
                                        ms.L[il], ms.w[il], ms.EA[il],
                                        device="cpu")
        close(pts, g[f"{name}_line{il}"], f"{name} line {il}")
    assert ms.n_lines == sum(k.startswith(f"{name}_line") for k in g)


def test_farm_network_lines_match_golden():
    """The shared network's line profiles, its free points solved at the
    units' array positions."""
    g = golden()
    lines = [pts for pts, is_line in plotting._system_polylines(
        model("farm_semi_wind"), 12, "cpu") if is_line]
    net = [k for k in g if k.startswith("farm_net")]
    # the units' own lines come first, the network's last
    for il, pts in enumerate(lines[len(lines) - len(net):]):
        close(pts, g[f"farm_net{il}"], f"farm network line {il}")


@pytest.mark.parametrize("name", SETS + ("farm_semi_wind",))
def test_plot_system_and_plot2d_render(name):
    """plot_system and plot2d render under Agg: the axes (and figure)
    returned, as many lines drawn as the reference draws."""
    import matplotlib.pyplot as plt

    counts = json.loads(str(golden()["counts"]))[name]
    ax = plotting.plot_system(model(name), device="cpu")
    assert ax.name == "3d"
    assert len(ax.lines) == counts["plot_system"]
    fig, ax2 = plotting.plot2d(model(name), device="cpu")
    assert ax2.get_figure() is fig
    assert len(ax2.lines) == counts["plot2d"]
    plt.close("all")


def test_plot_responses_render():
    """plot_responses and plot_responses_extended after the spar's
    analyze_cases: one panel per channel, the reference's line count in
    each."""
    import matplotlib.pyplot as plt

    counts = json.loads(str(golden()["counts"]))["spar"]
    m = Model(os.path.join(FIX, "design_spar.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.analyze_cases(device="cpu")
    for fn in ("plot_responses", "plot_responses_extended"):
        fig, axs = getattr(plotting, fn)(m)
        assert [len(a.lines) for a in axs] == counts[fn], fn
        assert all(a.get_figure() is fig for a in axs)
        plt.close("all")
