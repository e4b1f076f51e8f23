"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have, and a sound run at the same size comes
out correct; also the control (the reference in TF32 in the program's
place) fails the cell's limits. On the CPU at a small tile: the judge and
its limits are the cells' own (``limits/<cell>.json``). The one chip of
a cell has no exchange between chips to leave out."""

import argparse
import shutil
import tempfile

import pytest
import torch

import run
from faults import FAULTS

SMALL = {"max_pts_per_tile": 400, "max_magnitude": 0.5, "max_disp_magnitude": 0.5}

CASES = [(cell, fault) for cell, fs in FAULTS.items() for fault in [None, *fs]]


def _spec(cell):
    spec = run.load_cell(cell)
    spec["config"] = dict(spec["config"], **SMALL)
    spec["traffic"] = dict(spec["traffic"], tiles=1, judge_rows=64)
    return spec


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_program_is_not_correct(cell, fault):
    torch.set_num_threads(4)
    spec = _spec(cell)
    faults = [FAULTS[cell][fault]] if fault else []
    workdir = tempfile.mkdtemp()
    try:
        args = argparse.Namespace(seed=2**31 + 77, seconds=0.0, trace=0)
        m = run.measure(args, spec, torch.device("cpu"), workdir, faults=faults)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct, checks = run.verdict(m["checks"], spec["limits"])
    assert correct == (fault is None), checks


@pytest.mark.parametrize("cell", list(FAULTS))
def test_the_control_is_not_correct(cell):
    import calibrate

    torch.set_num_threads(4)
    spec = _spec(cell)
    workdir = tempfile.mkdtemp()
    try:
        got = {kind: nums for _, kind, nums in calibrate.readings(
            spec, [2**31 + 78], 1, torch.device("cpu"), workdir)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    assert run.verdict(got["program"], spec["limits"])[0]
    assert not run.verdict(got["control"], spec["limits"])[0]
