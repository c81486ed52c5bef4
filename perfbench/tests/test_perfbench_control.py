"""On the card, at each cell's own sizes: the control (the reference in
bf16 with fp8 weights in the program's place) fails the cell's limits and
the port passes them, on three seeds (perfbench/calibrate.py's readings).

    python -m pytest perfbench/tests/test_perfbench_control.py -m cuda -q
"""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from perfbench import calibrate, core

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in core.manifest()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_port_passes(card, cell):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert calibrate.main(["--workload", cell, "--seeds", "7001", "7002", "7003",
                               "--control", "3"]) == 0
    limits = core.cell(cell)[3]["limits"]
    for line in buf.getvalue().splitlines():
        got = json.loads(line)
        assert all(got["port"][k] <= limits[k] for k in limits), got
        assert any(got["control"][k] > limits[k] for k in limits), got
