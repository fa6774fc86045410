"""Fail-fast multi-host launcher with heartbeat monitoring.

SURVEY.md §5 (failure detection): the reference is single-process — a
crash is fatal and that's that. Standard JAX multi-host practice, which
this module supplies, is (a) a launcher that starts one worker process
per host-rank, (b) HEARTBEAT files each worker touches periodically, and
(c) FAIL-FAST teardown: if any worker dies or stops heartbeating, every
other worker is killed immediately — a wedged collective otherwise hangs
the remaining ranks until the collective timeout (minutes) with every card
held throughout. Restartability comes from checkpoints (train/solver.py):
the relaunched job resumes from the latest step.

All ranks run on this host, so each gets ONE card: rank r sees only card r
through ``CUDA_VISIBLE_DEVICES`` (the r-th entry of the caller's own list,
if it set one). A JAX process reserves most of every card it can see when
it starts, so ranks that shared all cards would fail for want of memory.

This is deliberately dependency-free (stdlib only) and transport-agnostic:
workers are plain commands; rank/coordination env vars
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``)
are injected so ``rtgs_tpu.parallel.mesh.initialize_distributed`` picks
them up in each worker.

CLI:  python -m rtgs_tpu.parallel.launcher --num-processes 2 \
          --coordinator localhost:9876 -- python train_worker.py ...
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time

logger = logging.getLogger(__name__)

HEARTBEAT_ENV = "RTGS_HEARTBEAT_FILE"


def touch_heartbeat() -> None:
    """Called by WORKERS: touch the launcher-provided heartbeat file.

    Cheap enough to call every training step; a no-op when the process
    was not started by the launcher."""
    path = os.environ.get(HEARTBEAT_ENV)
    if path:
        try:
            pathlib.Path(path).touch()
        except OSError:  # pragma: no cover - heartbeat must never crash
            pass


def rank_devices(env, rank: int) -> str:
    """``CUDA_VISIBLE_DEVICES`` for ``rank``: its own card only."""
    visible = env.get("CUDA_VISIBLE_DEVICES")
    if visible:
        cards = [c for c in visible.split(",") if c.strip()]
        if rank >= len(cards):
            raise ValueError(
                f"rank {rank} has no card: CUDA_VISIBLE_DEVICES={visible!r}")
        return cards[rank].strip()
    return str(rank)


def launch(cmd, num_processes: int, coordinator: str,
           heartbeat_timeout: float = 300.0, poll_s: float = 1.0,
           env=None) -> int:
    """Run ``cmd`` once per rank; fail fast on any death or stale heartbeat.

    Returns the exit code: 0 iff every rank exited 0. On the first
    failure (non-zero exit, or a rank whose heartbeat file goes stale
    beyond ``heartbeat_timeout`` seconds after its first beat), all other
    ranks receive SIGTERM.
    """
    tmp = tempfile.mkdtemp(prefix="rtgs_hb_")
    procs = []
    hb_files = []
    base_env = dict(os.environ if env is None else env)
    for rank in range(num_processes):
        hb = os.path.join(tmp, f"rank{rank}.hb")
        hb_files.append(hb)
        worker_env = dict(
            base_env,
            JAX_COORDINATOR_ADDRESS=coordinator,
            JAX_NUM_PROCESSES=str(num_processes),
            JAX_PROCESS_ID=str(rank),
            CUDA_VISIBLE_DEVICES=rank_devices(base_env, rank),
            **{HEARTBEAT_ENV: hb},
        )
        procs.append(subprocess.Popen(cmd, env=worker_env))
        logger.info("launched rank %d (pid %d)", rank, procs[-1].pid)

    failed = None
    try:
        while True:
            now = time.time()
            done = 0
            for rank, p in enumerate(procs):
                rc = p.poll()
                if rc is not None:
                    if rc != 0:
                        failed = (rank, f"exit code {rc}")
                        break
                    done += 1
                    continue
                hb = pathlib.Path(hb_files[rank])
                if hb.exists():
                    age = now - hb.stat().st_mtime
                    if age > heartbeat_timeout:
                        failed = (rank, f"heartbeat stale {age:.0f}s")
                        break
            if failed or done == num_processes:
                break
            time.sleep(poll_s)
    finally:
        if failed:
            rank, why = failed
            logger.error("rank %d failed (%s); tearing down all ranks",
                         rank, why)
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            deadline = time.time() + 10.0
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    p.kill()
    return 0 if not failed else 1


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(
        "rtgs-launch",
        description="Fail-fast multi-host launcher with heartbeats.")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", type=str, default="localhost:9876")
    ap.add_argument("--heartbeat-timeout", type=float, default=300.0,
                    help="Seconds without a heartbeat before fail-fast "
                         "teardown (workers call launcher.touch_heartbeat "
                         "each step).")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="Worker command (prefix with --).")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no worker command given")
    return launch(cmd, args.num_processes, args.coordinator,
                  heartbeat_timeout=args.heartbeat_timeout)


if __name__ == "__main__":
    sys.exit(main())
