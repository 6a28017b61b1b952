"""The harness, driven past its look for a card on a small cell on the
CPU (``scenarios.py``), reads correct with the program sound, and not
correct with the timed path broken underneath (each grad step leaving
the state as it was; half of the batch left out) or with the control,
the reference at the precision below the configuration's, put in the
program's place."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
CASES = ("sound", "unchanged", "half_batch", "control")


@pytest.fixture(scope="module")
def outcomes():
    procs = {c: subprocess.Popen(
        [sys.executable, str(HERE / "scenarios.py"), "lm_chapters", c],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in CASES}
    out = {}
    for c, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out[c] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("case", CASES)
def test_correct_only_when_sound(outcomes, case):
    assert outcomes[case]["correct"] is (case == "sound"), outcomes[case]
