"""``drivers.run_farm`` against the JAX Model's golden (a driver test
of ``test_torch_drivers.py``, in a file of its own: it takes about a
minute, and pytest-xdist's ``--dist loadfile`` runs it beside the rest).

The farm is two semi_wind units with a shared line over a buoy and a
2-case table (nDOF 12); every unit's metrics, the coupled equilibria
and each unit's drag diagnostics at the gates of
``tests/test_torch_orchestrated.py``, the CSV against the JAX
``save_responses`` text.
"""

import os

from raft_tpu_torch import drivers
from tests.test_torch_orchestrated import FIX, golden, hold_csv, hold_results


def test_run_farm_matches_golden(tmp_path):
    """run_farm on the two-unit semi_wind farm (own moorings, the shared
    network, a 2-case table): every unit's metrics, the coupled
    equilibria and each unit's drag diagnostics as the JAX Model's; the
    system response is N = 12."""
    csv = tmp_path / "farm.csv"
    model = drivers.run_farm(
        os.path.join(FIX, "design_farm_semi_wind_cases.json"),
        save_csv=str(csv), device="cpu")
    g = golden("farm_semi_wind")
    assert model.nFOWT == 2 and model.case_stats[0]["system_n"] == 12
    hold_results(model, g)
    hold_csv(csv.read_text(), g["csv"].item())
    assert "properties" not in model.results
