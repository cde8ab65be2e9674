"""Reverse mode through the aero stage of the port's full evaluator
on semi_wind, a rotor in air: the blade-element root's backward against
forward mode and the evaluator's gradients against
``golden_grad_aero_semi_wind.npz`` (``tests/test_torch_grad_aero.py``
holds the checks and their gates).
"""

import pytest

from test_torch_grad_aero import check_aero_gradients, check_root_backward


@pytest.mark.parametrize("name", ["semi_wind"])
def test_root_backward_matches_jacfwd(name):
    check_root_backward(name)


@pytest.mark.parametrize("name", ["semi_wind"])
def test_aero_gradients_match_goldens(name, monkeypatch):
    check_aero_gradients(name, monkeypatch)
