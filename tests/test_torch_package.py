"""Boundaries of the PyTorch port: it imports neither JAX nor anything of
the JAX package, its flags are the JAX package's main-path flags under
the same names and defaults, and its entry points never fall back to
the CPU on their own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "raft_tpu_torch")


def _sources():
    paths = [os.path.join(base, f) for base, _, files in os.walk(PKG)
             for f in files if f.endswith(".py")]
    return sorted(paths) + [os.path.join(ROOT, "chip_smoke.py")]


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "raft_tpu")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    """AST check: no ``import jax``/``raft_tpu`` (exactly that name or
    its submodules; ``raft_tpu_torch`` is the port itself)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_import_with_jax_blocked():
    """Import every port module in a fresh interpreter where ``jax`` and
    ``yaml`` cannot be imported, build and pack the mhk design from its
    JSON there, and check no ``raft_tpu`` module was loaded."""
    code = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["yaml"] = None
import raft_tpu_torch
for m in pkgutil.walk_packages(raft_tpu_torch.__path__, "raft_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.structure import bucketing
with open("tests/fixtures/torch_port/design_mhk.json") as f:
    model = Model(json.load(f))
leaves = bucketing.pack_design(model)
assert leaves["Imat"].shape == (16, 3, 3, 40), leaves["Imat"].shape
try:
    Model("raft_tpu/designs/mhk_demo.yaml")
except ImportError as e:
    assert "PyYAML" in str(e), e
else:
    raise AssertionError("a YAML design read without PyYAML")
loaded = sorted(n for n in sys.modules
                if n == "raft_tpu" or n.startswith("raft_tpu."))
assert not loaded, loaded
assert sys.modules["jax"] is None and sys.modules["yaml"] is None
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_flags_mirror_the_jax_registry(monkeypatch):
    from raft_tpu.utils import config as jcfg
    from raft_tpu_torch.utils import config as tcfg

    for name in ("SOLVER", "FUSED", "DTYPE", "SCAN_CHUNK", "ITER_SCALE",
                 "COND_CHECK", "COND_THRESHOLD", "BUCKET_ROWS",
                 "BUCKET_STEPS", "SERVE_CACHE_MB"):
        monkeypatch.delenv("RAFT_TPU_" + name, raising=False)
        assert tcfg.FLAGS[name].env == jcfg.FLAGS[name].env
        assert tcfg.get(name) == jcfg.get(name), name
    monkeypatch.setenv("RAFT_TPU_DTYPE", "f32")
    assert tcfg.get("DTYPE") == jcfg.get("DTYPE") == "float32"
    monkeypatch.setenv("RAFT_TPU_SOLVER", "pallas")
    with pytest.raises(ValueError):
        tcfg.get("SOLVER")


def test_compute_dtypes_policy(monkeypatch):
    from raft_tpu_torch.utils.dtypes import compute_dtypes

    monkeypatch.delenv("RAFT_TPU_DTYPE", raising=False)
    assert compute_dtypes() == (torch.float64, torch.complex128)
    f32 = torch.zeros(2, dtype=torch.float32)
    assert compute_dtypes(f32) == (torch.float32, torch.complex64)
    assert compute_dtypes(f32, policy="float64")[0] == torch.float64
    monkeypatch.setenv("RAFT_TPU_DTYPE", "float32")
    assert compute_dtypes() == (torch.float32, torch.complex64)
    with pytest.raises(ValueError):
        compute_dtypes(policy="bf16")


def test_entry_points_raise_without_cuda_and_device(monkeypatch):
    """Without a card and without ``device=``, every entry point raises
    an error naming device="cpu" instead of running on the CPU."""
    import json

    from raft_tpu_torch.api import make_case_evaluator, make_design_evaluator
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.parallel.sweep import sweep_heterogeneous
    from raft_tpu_torch.structure import bucketing as tb

    from raft_tpu_torch.omdao import DesignEvaluation, RAFT_OMDAO_Core

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fix = os.path.join(ROOT, "tests", "fixtures", "torch_port")
    p = tb.load_packed(os.path.join(fix, "packed_mhk.npz"))
    with open(os.path.join(fix, "design_mhk.json")) as f:
        m = Model(json.load(f))
    with open(os.path.join(fix, "weis_semi_wind.json")) as f:
        weis = json.load(f)
    core = RAFT_OMDAO_Core(*(weis[k] for k in (
        "modeling_options", "analysis_options", "turbine_options",
        "mooring_options", "member_options")))
    for call in (lambda: tb.BucketEvaluator(p.sig),
                 lambda: tb.packed_from_numpy(p.leaves),
                 lambda: sweep_heterogeneous([p], [2.0], [8.0], [0.0]),
                 lambda: sweep_heterogeneous([m], [2.0], [8.0], [0.0]),
                 lambda: make_case_evaluator(m),
                 lambda: make_design_evaluator(m),
                 lambda: DesignEvaluation(
                     os.path.join(fix, "design_spar.json")).compute(),
                 lambda: core.compute(weis["inputs"],
                                      weis["discrete_inputs"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    # an explicit device is honoured
    assert tb.BucketEvaluator(p.sig, device="cpu").w.device.type == "cpu"


def test_plotting_imports_without_matplotlib():
    """With matplotlib blocked, raft_tpu_torch.plotting imports, its
    geometry helpers run, and a plot function raises ImportError naming
    matplotlib."""
    code = r"""
import json, sys
sys.modules["matplotlib"] = None
sys.modules["matplotlib.pyplot"] = None
from raft_tpu_torch import plotting
from raft_tpu_torch.models.model import Model
with open("tests/fixtures/torch_port/design_spar.json") as f:
    m = Model(json.load(f))
fs, ms = m.fowtList[0], m.ms_list[0]
polys = plotting._member_polylines(fs.members[0], [0.0, 0.0, 0.0])
pts = plotting._catenary_points(ms.r_anchor[0], ms.r_fair0[0], ms.L[0],
                                ms.w[0], ms.EA[0], device="cpu")
assert pts.shape == (30, 3) and len(polys) > 0
try:
    plotting.plot_system(m, device="cpu")
except ImportError as e:
    assert "matplotlib" in str(e), e
else:
    raise AssertionError("plot_system ran without matplotlib")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
