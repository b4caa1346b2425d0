"""On the card, at each cell's own sizes: the program's readings stay
within the cell's limits, and the control (one precision below the cell's)
and, for a training cell, the half-batch fault each break at least one of
them. Skips without a card."""
import pytest

from benchmark import control, harness

CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_holds(cuda_device, name):
    cell, cfg, mx = harness.load_cell(name)
    limits = cell["limits"]
    seed = 2 ** 31 + 4321
    if mx["kind"] == "volumes":
        got = control._serve_reading(harness, cell, cfg, mx, seed,
                                     cuda_device)
        low = control._serve_reading(harness, cell, cfg, mx, seed,
                                     cuda_device, "fp8")
    else:
        readings = {what: values for what, values in
                    control._train_readings(harness, cell, cfg, mx, seed,
                                            cuda_device, True)}
        got, low = readings["program"], readings["control"]
        half = readings["fault_half"]
        assert any(half[k] > v for k, v in limits.items()), half
    assert all(got[k] <= v for k, v in limits.items()), got
    assert any(low[k] > v for k, v in limits.items()), low
