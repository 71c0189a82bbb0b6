"""The port's training supervisor (``duodiff_tpu_torch/tools/supervise_train.py``)
against the repository's (``tools/supervise_train.py``).

The five process-logic cases of ``tests/test_supervisor.py`` run against both
supervisors, which must log the same kinds of events (fake children that
crash by a counter file). Then the port's auto-resume rule on the forms of
its training CLI, and one CPU run of that CLI at a tiny config that dies
once after its first checkpoint and, restarted with ``--resume`` by the
supervisor, ends on the parameters of an unbroken run of the same steps to
the bit (tolerance 0: the step draws are a function of the seed and the
step, and the checkpoint holds the data position).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from duodiff_tpu_torch.data.synthetic import write_palette_cifar  # noqa: E402
from duodiff_tpu_torch.tools import supervise_train  # noqa: E402
from tools.supervise_train import main as jax_supervise  # noqa: E402

SUPERVISORS = {"jax": jax_supervise, "port": supervise_train.main}
# how each supervisor runs as a program of its own
SUPERVISOR_COMMANDS = {
    "jax": [sys.executable, str(REPO / "tools" / "supervise_train.py")],
    "port": [sys.executable, "-m", "duodiff_tpu_torch.tools.supervise_train"],
}

FLAKY_CHILD = textwrap.dedent("""
    import pathlib, sys
    counter = pathlib.Path(sys.argv[1])
    n = int(counter.read_text()) if counter.exists() else 0
    counter.write_text(str(n + 1))
    sys.exit(1 if n < int(sys.argv[2]) else 0)
""")

# the port's training CLI, the arguments after the marker path; on the run
# that finds no marker file it dies (exit 3) right after its first checkpoint
CRASH_ONCE = textwrap.dedent("""
    import os, runpy, sys
    from pathlib import Path

    marker = Path(sys.argv[1])
    if not marker.exists():
        from duodiff_tpu_torch.training.trainer import Trainer

        save = Trainer._save

        def save_then_die(self, step, new_checkpoint):
            save(self, step, new_checkpoint)
            self.checkpointer.wait_until_finished()
            marker.write_text(str(step))
            os._exit(3)

        Trainer._save = save_then_die
    sys.argv = [sys.argv[3], *sys.argv[4:]]
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
""")


def _events(log):
    return [json.loads(line) for line in Path(log).read_text().splitlines()]


# --- the five cases of tests/test_supervisor.py, on both supervisors -------------


@pytest.mark.parametrize("which", ["jax", "port"])
def test_crash_twice_then_succeed(which, tmp_path):
    child = tmp_path / "child.py"
    child.write_text(FLAKY_CHILD)
    counter, log = tmp_path / "count", tmp_path / "sup.log"
    rc = SUPERVISORS[which]([
        "--backoff_base", "0.05", "--backoff_cap", "0.1",
        "--log", str(log), "--",
        sys.executable, str(child), str(counter), "2",
    ])
    assert rc == 0
    assert counter.read_text() == "3"  # two crashes + the clean run
    kinds = [e["event"] for e in _events(log)]
    assert kinds == ["start", "crash", "start", "crash", "start", "complete"]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_usage_error_not_retried(which, tmp_path):
    child = tmp_path / "child.py"
    child.write_text("import sys; sys.exit(2)")
    log = tmp_path / "sup.log"
    rc = SUPERVISORS[which]([
        "--backoff_base", "0.05", "--log", str(log), "--",
        sys.executable, str(child),
    ])
    assert rc == 2
    assert [e["event"] for e in _events(log)] == ["start", "fatal"]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_budget_exhausted(which, tmp_path):
    child = tmp_path / "child.py"
    child.write_text("import sys; sys.exit(7)")
    log = tmp_path / "sup.log"
    rc = SUPERVISORS[which]([
        "--max_restarts", "2", "--backoff_base", "0.05",
        "--log", str(log), "--",
        sys.executable, str(child),
    ])
    assert rc == 7
    kinds = [e["event"] for e in _events(log)]
    assert kinds == ["start", "crash", "start", "crash", "start", "gave_up"]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_auto_resume_appended_to_the_train_cli(which, tmp_path):
    """Each supervisor's own training CLI: the JAX package's ``main.py``,
    the port's ``duodiff_tpu_torch/train.py``."""
    script = (tmp_path / "main.py" if which == "jax"
              else tmp_path / "duodiff_tpu_torch" / "train.py")
    script.parent.mkdir(parents=True, exist_ok=True)
    script.write_text(textwrap.dedent("""
        import sys
        assert "--resume" in sys.argv, sys.argv
        sys.exit(0)
    """))
    log = tmp_path / "sup.log"
    assert SUPERVISORS[which](["--log", str(log), "--", sys.executable, str(script)]) == 0
    assert [e["event"] for e in _events(log)] == ["start", "complete"]

    # and NOT appended under --no_auto_resume
    script.write_text(textwrap.dedent("""
        import sys
        assert "--resume" not in sys.argv, sys.argv
        sys.exit(0)
    """))
    assert SUPERVISORS[which]([
        "--no_auto_resume", "--log", str(tmp_path / "sup2.log"), "--",
        sys.executable, str(script),
    ]) == 0


@pytest.mark.parametrize("which", ["jax", "port"])
def test_sigterm_forwarded_no_restart(which, tmp_path):
    """TERM to the supervisor reaches the child (which saves and exits, as the
    trainer's SIGTERM handler does) and is not retried."""
    child = tmp_path / "child.py"
    marker = tmp_path / "terminated"
    child.write_text(textwrap.dedent(f"""
        import pathlib, signal, sys, time
        def onterm(sig, frame):
            pathlib.Path({str(marker)!r}).write_text("got TERM")
            sys.exit(0)
        signal.signal(signal.SIGTERM, onterm)
        pathlib.Path({str(tmp_path / "ready")!r}).write_text("up")
        time.sleep(60)
    """))
    log = tmp_path / "sup.log"
    proc = subprocess.Popen([
        *SUPERVISOR_COMMANDS[which],
        "--log", str(log), "--grace", "10", "--",
        sys.executable, str(child),
    ], cwd=REPO)
    try:
        deadline = time.time() + 30
        while not (tmp_path / "ready").exists():
            assert time.time() < deadline, "child never came up"
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert marker.read_text() == "got TERM"
    assert rc == 0
    assert [e["event"] for e in _events(log)] == ["start", "shutdown"]


# --- the port's auto-resume rule ------------------------------------------------


@pytest.mark.parametrize("cmd, resumed", [
    (["python", "-m", "duodiff_tpu_torch.train", "--n_steps", "4"], True),
    (["python3", "/work/repo/duodiff_tpu_torch/train.py", "--n_steps", "4"], True),
    (["python", "duodiff_tpu_torch/train.py"], True),
    (["python", "crash_once.py", "marker", "-m", "duodiff_tpu_torch.train"], True),
    (["python", "-m", "duodiff_tpu_torch.train", "--resume"], False),  # already there
    (["python", "main.py", "--n_steps", "4"], False),  # the JAX package's CLI
    (["python", "-m", "duodiff_tpu_torch.sample"], False),
    (["python", "-m", "duodiff_tpu_torch.train_extra"], False),
    (["python", "/work/duodiff_tpu_torch/train.pyc"], False),
    (["python", "duodiff_tpu_torch.train"], False),  # no -m
])
def test_auto_resume_rule(cmd, resumed):
    sup = supervise_train.Supervisor(supervise_train.get_args(["--", *cmd]))
    got = sup._command()
    assert got == (cmd + ["--resume"] if resumed else cmd)
    off = supervise_train.Supervisor(supervise_train.get_args(["--no_auto_resume", "--", *cmd]))
    assert off._command() == cmd


def test_refuses_a_command_line_without_a_train_command():
    with pytest.raises(SystemExit):
        supervise_train.get_args(["--max_restarts", "2"])
    with pytest.raises(SystemExit):
        supervise_train.get_args(["--max_restarts", "2", "--"])


# --- the port's training CLI, killed once and resumed ---------------------------

TINY = """model_params:
  img_size: 32
  patch_size: 8
  in_chans: 3
  embed_dim: 32
  depth: 3
  num_heads: 2
  mlp_ratio: 4
  qkv_bias: False
  mlp_time_embed: False
  num_classes: -1
  normalize_timesteps: True
"""
STEPS, SAVE_EVERY = 6, 2


def _train_argv(work: Path, exp: str) -> list:
    return ["--config_path", str(work / "tiny.yaml"), "--dataset", "cifar10",
            "--data_path", str(work / "data"), "--log_path", str(work / "logs"),
            "--exp_name", exp, "--n_steps", str(STEPS), "--batch_size", "4",
            "--save_every_n_steps", str(SAVE_EVERY), "--num_warmup_steps", "2",
            "--lr", "1e-3", "--device", "cpu", "--seed", "0"]


def _final_state(work: Path, exp: str) -> dict:
    from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE

    (path,) = (work / "logs" / exp).glob(f"*_last/{CHECKPOINT_FILE}")
    return torch.load(path, map_location="cpu", weights_only=False)


def test_supervised_train_cli_dies_once_and_ends_where_an_unbroken_run_ends(
        tmp_path, monkeypatch):
    """Every run is a process of its own with one CPU thread, so that the
    CPU's matrix products sum in one order in all of them."""
    (tmp_path / "tiny.yaml").write_text(TINY)
    write_palette_cifar(tmp_path / "data", seed=0, per_batch=16)
    wrapper, marker = tmp_path / "crash_once.py", tmp_path / "crashed"
    wrapper.write_text(CRASH_ONCE)
    monkeypatch.setenv("PYTHONPATH", str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    log = tmp_path / "sup.log"
    rc = supervise_train.main([
        "--backoff_base", "0.05", "--max_restarts", "1", "--log", str(log), "--",
        sys.executable, str(wrapper), str(marker), "-m", "duodiff_tpu_torch.train",
        *_train_argv(tmp_path, "supervised"),
    ])
    assert rc == 0
    events = _events(log)
    assert [e["event"] for e in events] == ["start", "crash", "start", "complete"]
    assert events[1]["rc"] == 3 and marker.read_text() == str(SAVE_EVERY)
    assert all(e["cmd"][-1] == "--resume" for e in events if e["event"] == "start")

    subprocess.run([sys.executable, "-m", "duodiff_tpu_torch.train",
                    *_train_argv(tmp_path, "unbroken")], check=True, timeout=300)
    got, want = _final_state(tmp_path, "supervised"), _final_state(tmp_path, "unbroken")
    assert got["step"] == want["step"] == STEPS
    assert list(got["model_state_dict"]) == list(want["model_state_dict"])
    for name, value in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][name], value), name
    for key in ("mu", "nu"):
        for name, value in want["optimizer"][key].items():
            assert torch.equal(got["optimizer"][key][name], value), (key, name)
