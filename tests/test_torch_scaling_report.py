"""The port's multi-process tools on the CPU, in gloo worlds of 2 and 4
ranks (each rank a process, the torchrun environment set by hand):

- ``duodiff_tpu_torch.tools.scaling_report``: its rows show the expected
  pattern (the JAX tool's docstring, tools/scaling_report.py): data-parallel
  sampling runs no collective, tensor parallelism sums twice a block a
  forward, the data-parallel train step's one all-reduce carries the fp32
  gradient bytes (the parameter bytes), ``--fsdp`` all-gathers and
  reduce-scatters instead and halves the parameter bytes a rank;
- ``duodiff_tpu_torch.tools.dryrun_multichip``: each leg prints its OK line,
  or SKIPPED with the reason where the world has no axis for it.
"""

import json

import pytest

from duodiff_tpu_torch.tools import dryrun_multichip, scaling_report

SIZE = ["--batch", "8", "--depth", "3", "--embed", "64", "--img", "16", "--patch", "2"]
DEPTH = 3


@pytest.fixture(scope="module")
def reports():
    """Each mode's rows by mesh."""
    runs = {"train": ["--meshes", "2x1,1x2,2x2"],
            "fsdp": ["--meshes", "2x1,2x2", "--fsdp", "--fsdp_min_size", "1024"],
            "sample": ["--meshes", "2x1,1x2,2x2", "--mode", "sample"]}
    return {mode: {row["mesh"]: row for row in scaling_report.main([*SIZE, *argv])}
            for mode, argv in runs.items()}


def test_data_parallel_sampling_runs_no_collective(reports):
    assert reports["sample"]["2x1"]["collectives"] == {}


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tensor_parallel_sampling_sums_twice_a_block(reports, mesh):
    row = reports["sample"][mesh]
    assert row["collectives"] == {"all_reduce": 2 * DEPTH}


def test_data_parallel_train_step_all_reduces_the_gradients(reports):
    row = reports["train"]["2x1"]
    assert row["collectives"] == {"all_reduce": 1}
    assert row["all_reduce_mb"] == pytest.approx(row["param_mb_per_rank"])  # fp32 gradients


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_fsdp_gathers_scatters_and_halves_the_parameters(reports, mesh):
    fs, plain = reports["fsdp"][mesh], reports["train"][mesh]
    assert fs["all_gather"] >= DEPTH and fs["reduce_scatter"] >= DEPTH
    assert fs["all_reduce_mb"] < plain["all_reduce_mb"]
    assert 0.5 <= fs["param_mb_per_rank"] / (plain["param_mb_per_rank"] / 2) < 1.1


def test_the_report_prints_its_rows_as_json(capsys):
    rows = scaling_report.main([*SIZE, "--meshes", "1x1", "--mode", "sample"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == rows and rows[0]["mesh"] == "1x1"


LEGS = ("data-parallel", "FSDP", "tensor-parallel", "pipeline", "multihost")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_prints_each_leg(n, capsys):
    dryrun_multichip.main([str(n)])
    lines = capsys.readouterr().out.strip().splitlines()
    for leg in LEGS:
        found = [line for line in lines if line.startswith(f"dryrun_multichip {leg} leg ")]
        assert len(found) == 1, (leg, lines)
        if leg == "multihost" and n == 2:
            assert "SKIPPED: needs 4 ranks or more" in found[0]
        else:
            assert " leg OK" in found[0], found[0]
