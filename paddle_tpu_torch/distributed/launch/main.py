"""``python -m paddle_tpu_torch.distributed.launch [options] script.py
[script args]`` (counterpart of ``paddle_tpu/distributed/launch/main.py``).

Starts ``--nproc_per_node`` worker processes of the script on this host,
one rank each, under a controller:

- each worker gets the reference's environment (``PADDLE_TRAINER_ID``,
  ``PADDLE_LOCAL_RANK``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_NNODES``,
  ``PADDLE_JOB_ID``, ``PADDLE_MASTER``) and torch's (``RANK``,
  ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and
  ``PADDLE_DEVICE``: a worker runs on ``cuda:<local rank>`` with NCCL
  unless ``--device cpu`` (gloo) is given; ``--init_method file://...``
  gives the ranks a file store instead of the master's TCP store;
- with ``--log_dir`` (or more than one worker) the controller prints
  every worker line prefixed ``[rank N]`` and, with ``--log_dir``, writes
  it to ``worker.<rank>.log`` there;
- fail-fast: the first worker to exit non-zero makes the controller
  terminate the others (SIGTERM, then SIGKILL after ``GRACE_S``
  seconds for a worker that traps SIGTERM) and exit with that code;
- several hosts: ``--master ip:port --nnodes M --rank r`` on each.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["main"]

GRACE_S = 10.0  # seconds between SIGTERM and SIGKILL


def _parse_args(argv=None):
    parser = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    parser.add_argument("--master", default=None,
                        help="ip:port of rank 0's store for multi-host jobs")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--rank", type=int,
                        default=int(os.environ.get("PADDLE_NODE_RANK", 0)),
                        help="this host's node rank")
    parser.add_argument("--nproc_per_node", type=int, default=1,
                        help="worker processes on this host")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda: worker i on cuda:i with NCCL; cpu: gloo")
    parser.add_argument("--init_method", default=None,
                        help="a file:// store shared by the ranks")
    parser.add_argument("--devices", "--gpus", dest="devices", default=None,
                        help="CUDA_VISIBLE_DEVICES for the workers")
    parser.add_argument("--job_id", default="default")
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--run_mode", default="collective")
    parser.add_argument("training_script")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env(args, local_rank, master):
    env = dict(os.environ)
    world = args.nnodes * args.nproc_per_node
    rank = args.rank * args.nproc_per_node + local_rank
    addr, port = master.rsplit(":", 1)
    env.update({
        "PADDLE_TRAINERS_NUM": str(world), "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_NNODES": str(args.nnodes), "PADDLE_JOB_ID": args.job_id,
        "PADDLE_MASTER": master, "PADDLE_DEVICE": args.device,
        "RANK": str(rank), "LOCAL_RANK": str(local_rank),
        "WORLD_SIZE": str(world), "MASTER_ADDR": addr, "MASTER_PORT": port,
    })
    if args.init_method:
        env["PADDLE_INIT_METHOD"] = args.init_method
    if args.devices is not None:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    return env


def _tail(stream, rank, logf):
    """Every worker line to the controller's stdout with its rank prefix,
    and to the rank's log file."""
    for raw in iter(stream.readline, b""):
        sys.stdout.write(f"[rank {rank}] {raw.decode(errors='replace')}")
        sys.stdout.flush()
        if logf is not None:
            logf.write(raw)
            logf.flush()
    stream.close()


def _watch(procs):
    """Wait for every worker; the first non-zero exit terminates the
    rest. Returns the job's exit code."""
    ret, term_at = 0, None
    alive = {p.pid: p for p in procs}
    while alive:
        for pid, p in list(alive.items()):
            rc = p.poll()
            if rc is None:
                continue
            del alive[pid]
            if rc != 0 and ret == 0:
                print(f"[launch] worker pid={pid} exited rc={rc}; "
                      "terminating remaining workers", file=sys.stderr,
                      flush=True)
                ret, term_at = rc, time.monotonic()
                for q in alive.values():
                    q.terminate()
        if term_at is not None and alive \
                and time.monotonic() - term_at > GRACE_S:
            print(f"[launch] {len(alive)} worker(s) survived SIGTERM "
                  f"{GRACE_S:g}s; killing", file=sys.stderr, flush=True)
            for q in alive.values():
                q.kill()
            term_at = time.monotonic()
        time.sleep(0.05)
    return ret


def main(argv=None):
    args = _parse_args(argv)
    cmd = [sys.executable, args.training_script] + args.training_script_args
    master = args.master or f"127.0.0.1:{_free_port()}"
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    procs, tails, logfiles = [], [], []
    piped = args.nproc_per_node > 1 or bool(args.log_dir)
    for local_rank in range(args.nproc_per_node):
        env = _worker_env(args, local_rank, master)
        logf = None
        if args.log_dir:
            logf = open(os.path.join(
                args.log_dir, f"worker.{env['PADDLE_TRAINER_ID']}.log"), "ab")
            logfiles.append(logf)
        if not piped:
            procs.append(subprocess.Popen(cmd, env=env))
            continue
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        t = threading.Thread(target=_tail,
                             args=(proc.stdout, env["PADDLE_TRAINER_ID"],
                                   logf), daemon=True)
        t.start()
        tails.append(t)
        procs.append(proc)
    try:
        ret = _watch(procs)
    except KeyboardInterrupt:
        ret = 130
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        deadline = time.monotonic() + GRACE_S
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for t in tails:
        t.join(timeout=5)
    for f in logfiles:
        f.close()
    sys.exit(ret)


if __name__ == "__main__":
    main()
