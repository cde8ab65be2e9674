"""Reverse mode through the aero stage of the port's full evaluator
on mhk_tidal, a submerged rotor: the blade-element root's backward against
forward mode and the evaluator's gradients against
``golden_grad_aero_mhk_tidal.npz`` (``tests/test_torch_grad_aero.py``
holds the checks and their gates).
"""

import pytest

from test_torch_grad_aero import check_aero_gradients, check_root_backward


@pytest.mark.parametrize("name", ["mhk_tidal"])
def test_root_backward_matches_jacfwd(name):
    check_root_backward(name)


@pytest.mark.parametrize("name", ["mhk_tidal"])
def test_aero_gradients_match_goldens(name, monkeypatch):
    check_aero_gradients(name, monkeypatch)
