"""Training supervisor: restart a crashed training run, on top of the port's
checkpoint and resume (counterpart of the repository's
``tools/supervise_train.py``).

Wrap the training command, and on a nonzero exit restart it with
exponential backoff, always with ``--resume``, so that each attempt
continues from the last checkpoint to the bit (the data position in the
middle of an epoch included):

    python -m duodiff_tpu_torch.tools.supervise_train [supervisor flags] -- \
        python -m duodiff_tpu_torch.train --config_path configs/uvit_celeba.yaml ...

Behavior:
- exit 0 from the child ends supervision with exit 0 (run complete);
- "usage" exits (default: code 2, argparse) are never retried: restarting
  a wrong command line cannot fix it;
- a child that stayed up >= --healthy_secs before dying resets the backoff
  and the attempt budget (a crash after hours of healthy training is a fresh
  incident, not the next step of a crash loop);
- SIGTERM / SIGINT to the supervisor is forwarded to the child, which is
  given up to --grace seconds: the trainer's SIGTERM handler checkpoints at
  the next step boundary and returns (``training/trainer.py``), then the
  supervisor exits WITHOUT restarting;
- every event is appended as one JSON line to --log.

``--resume`` is appended to the port's training CLI, ``-m
duodiff_tpu_torch.train`` or a path ending in ``duodiff_tpu_torch/train.py``;
with no checkpoint yet it starts fresh (``Trainer._maybe_resume``). The
supervisor only ever signals its direct child PID.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

TRAIN_MODULE = "duodiff_tpu_torch.train"
TRAIN_SCRIPT = "duodiff_tpu_torch/train.py"


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        usage="python -m duodiff_tpu_torch.tools.supervise_train [flags] -- <train command ...>",
    )
    p.add_argument("--max_restarts", type=int, default=20,
                   help="restart budget per crash-loop incident (reset "
                        "after a run healthy for --healthy_secs)")
    p.add_argument("--backoff_base", type=float, default=5.0,
                   help="first restart delay, seconds; doubles per "
                        "consecutive crash")
    p.add_argument("--backoff_cap", type=float, default=300.0)
    p.add_argument("--healthy_secs", type=float, default=300.0,
                   help="a child that lived this long resets the "
                        "backoff/attempt counters before its crash counts")
    p.add_argument("--grace", type=float, default=600.0,
                   help="seconds to wait after forwarding SIGTERM before "
                        "killing the child (the preemption save of a big "
                        "model can take minutes)")
    p.add_argument("--no_restart_codes", type=str, default="2",
                   help="comma-separated child exit codes never retried "
                        "(2 = argparse usage error)")
    p.add_argument("--no_auto_resume", action="store_true", default=False,
                   help="don't append --resume to the port's training CLI")
    p.add_argument("--log", type=str, default="supervisor.log",
                   help="JSONL event log path")
    if argv is None:
        argv = sys.argv[1:]
    if "--" not in argv:
        p.error("separate the train command with '--'")
    split = argv.index("--")
    args = p.parse_args(argv[:split])
    args.command = argv[split + 1 :]
    if not args.command:
        p.error("empty train command after '--'")
    return args


def is_train_command(cmd) -> bool:
    """Whether ``cmd`` runs the port's training CLI: ``-m
    duodiff_tpu_torch.train`` or a path ending in ``duodiff_tpu_torch/train.py``."""
    module = any(a == "-m" and b == TRAIN_MODULE for a, b in zip(cmd, cmd[1:]))
    return module or any(c.endswith(TRAIN_SCRIPT) for c in cmd)


class Supervisor:
    def __init__(self, args):
        self.args = args
        self.child = None
        self.shutdown = None  # signal number once requested

    def log(self, event: str, **fields):
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(rec, sort_keys=True)
        print(f"[supervisor] {line}", flush=True)
        with open(self.args.log, "a") as f:
            f.write(line + "\n")

    def _on_signal(self, signum, frame):
        self.shutdown = signum
        if self.child is not None and self.child.poll() is None:
            self.child.send_signal(signal.SIGTERM)

    def _command(self):
        cmd = list(self.args.command)
        if (
            not self.args.no_auto_resume
            and "--resume" not in cmd
            and is_train_command(cmd)
        ):
            cmd.append("--resume")
        return cmd

    def run(self) -> int:
        args = self.args
        no_restart = {
            int(c) for c in args.no_restart_codes.split(",") if c.strip()
        }
        signal.signal(signal.SIGTERM, self._on_signal)
        signal.signal(signal.SIGINT, self._on_signal)

        attempt = 0
        while True:
            cmd = self._command()
            self.log("start", attempt=attempt, cmd=cmd)
            started = time.time()
            self.child = subprocess.Popen(cmd)
            if self.shutdown is not None:
                # signal raced the spawn: forward now
                self.child.send_signal(signal.SIGTERM)
            # poll-wait so that a SIGTERM arriving mid-wait still starts the
            # grace clock (and a TERM-ignoring child still gets killed)
            grace_deadline = None
            while True:
                if self.shutdown is not None and grace_deadline is None:
                    grace_deadline = time.time() + args.grace
                try:
                    rc = self.child.wait(timeout=0.2)
                    break
                except subprocess.TimeoutExpired:
                    if (grace_deadline is not None
                            and time.time() > grace_deadline):
                        self.log("grace_exceeded", grace=args.grace)
                        self.child.kill()
                        rc = self.child.wait()
                        break
            lived = time.time() - started

            if self.shutdown is not None:
                # the trainer checkpointed on SIGTERM; don't restart
                self.log("shutdown", rc=rc, lived_s=round(lived, 1),
                         signal=self.shutdown)
                return rc
            if rc == 0:
                self.log("complete", lived_s=round(lived, 1))
                return 0
            if rc in no_restart:
                self.log("fatal", rc=rc,
                         reason="exit code marked non-retryable")
                return rc
            if lived >= args.healthy_secs:
                # fresh incident: full budget again
                attempt = 0
            if attempt >= args.max_restarts:
                self.log("gave_up", rc=rc, attempts=attempt)
                return rc
            delay = min(
                args.backoff_base * (2.0 ** attempt), args.backoff_cap
            )
            self.log("crash", rc=rc, lived_s=round(lived, 1),
                     attempt=attempt, restart_in_s=delay)
            attempt += 1
            deadline = time.time() + delay
            while time.time() < deadline:
                if self.shutdown is not None:
                    self.log("shutdown", rc=rc, signal=self.shutdown,
                             during="backoff")
                    return rc
                time.sleep(min(0.2, max(0.0, deadline - time.time())))


def main(argv=None) -> int:
    """Supervise; the signal handlers the supervisor installs are undone when
    it returns, for a caller that goes on in the same process."""
    supervisor = Supervisor(get_args(argv))
    previous = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return supervisor.run()
    finally:
        for signum, handler in previous.items():
            signal.signal(signum, handler)


if __name__ == "__main__":
    sys.exit(main())
