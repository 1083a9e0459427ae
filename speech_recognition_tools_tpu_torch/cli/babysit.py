"""Babysitter: crash-resilient training driver.

Port of speech_recognition_tools_tpu/cli/babysit.py (the same flags, exit
codes and `_run` / `_sleep` hooks); it is host code and imports no torch.
Native equivalent of the reference's restart loop
(recipes/timit/local_pyspeech/train_rnn_hybrid.sh:118-160): training runs
under a supervisor that relaunches it after any crash; the trainer itself
resumes from the newest checkpoint in its store path (train_am / train_e2e
/ train_lm all implement newest-checkpoint resume), so progress is
monotone across restarts.

Usage:
  python -m speech_recognition_tools_tpu_torch.cli.babysit \\
      --max_restarts 10 --min_uptime 30 -- \\
      python -m speech_recognition_tools_tpu_torch.cli.train_am egs/ exp/am \\
          --arch rnn --epochs 100
"""

import argparse
import subprocess
import sys
import time


def get_parser():
    p = argparse.ArgumentParser(
        "Crash-resilient training supervisor",
        usage="babysit [options] -- command ...",
    )
    p.add_argument("--max_restarts", type=int, default=10,
                   help="give up after this many crashes")
    p.add_argument("--min_uptime", type=float, default=30.0,
                   help="a crash within this many seconds of launch "
                        "counts as fatal (config error, not flakiness)")
    p.add_argument("--backoff", type=float, default=5.0,
                   help="seconds to wait before a restart")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command after --")
    return p


def babysit(command, max_restarts=10, min_uptime=30.0, backoff=5.0,
            _run=subprocess.run, _sleep=time.sleep):
    """Run `command`, restarting on nonzero exit. Returns the final rc.

    Fast crashes (< min_uptime seconds) are treated as deterministic
    failures and stop the loop immediately — the reference's loop has the
    same failure mode (a bad config restarts forever); this one doesn't.
    """
    restarts = 0
    while True:
        t0 = time.time()
        rc = _run(command).returncode
        uptime = time.time() - t0
        if rc == 0:
            return 0
        if uptime < min_uptime:
            print(
                f"babysit: command failed rc={rc} after {uptime:.1f}s "
                f"(< min_uptime) — deterministic failure, giving up",
                file=sys.stderr,
            )
            return rc
        restarts += 1
        if restarts > max_restarts:
            print(
                f"babysit: giving up after {max_restarts} restarts",
                file=sys.stderr,
            )
            return rc
        print(
            f"babysit: crash rc={rc} after {uptime:.1f}s — restart "
            f"{restarts}/{max_restarts} in {backoff:.0f}s",
            file=sys.stderr,
        )
        _sleep(backoff)


def main(argv=None):
    args = get_parser().parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        get_parser().error("no command given (use: babysit [opts] -- cmd)")
    return babysit(cmd, args.max_restarts, args.min_uptime, args.backoff)


if __name__ == "__main__":
    sys.exit(main())
