"""``python -m paddle_tpu_torch.distributed.launch`` on the CPU: the
reference's environment contract, ``[rank N]`` log lines and per-rank
log files, fail-fast (also against a worker that traps SIGTERM), the
multi-host environment, and a real two-rank gloo job
(``tests/test_launch_visualdl.py`` is the reference's)."""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _launch(tmp_path, body, args, timeout=120):
    script = tmp_path / "worker.py"
    script.write_text(body)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    # TORCH_CPP_LOG_LEVEL: no c10d warning lines on stderr (merged into
    # the rank's stream) to interleave with the lines the tests read
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", TORCH_CPP_LOG_LEVEL="ERROR")
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args,
         str(script)], env=env, capture_output=True, timeout=timeout,
        cwd=str(tmp_path))


_ENV = ("import os\n"
        "keys = ['PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM', "
        "'PADDLE_LOCAL_RANK', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK', "
        "'MASTER_ADDR', 'PADDLE_DEVICE', 'PADDLE_NNODES']\n"
        "print(' '.join(f'{k}={os.environ[k]}' for k in keys))\n")


def test_launch_env_contract_and_log_prefixes(tmp_path):
    logdir = tmp_path / "logs"
    r = _launch(tmp_path, _ENV, ["--nproc_per_node", "2", "--device", "cpu",
                                 "--log_dir", str(logdir)])
    assert r.returncode == 0, r.stderr
    out = r.stdout.decode()
    for rank in (0, 1):
        line = (f"[rank {rank}] PADDLE_TRAINER_ID={rank} "
                f"PADDLE_TRAINERS_NUM=2 PADDLE_LOCAL_RANK={rank} "
                f"RANK={rank} WORLD_SIZE=2 LOCAL_RANK={rank} "
                f"MASTER_ADDR=127.0.0.1 PADDLE_DEVICE=cpu PADDLE_NNODES=1")
        assert line in out, out
        assert f"PADDLE_TRAINER_ID={rank}" in (
            logdir / f"worker.{rank}.log").read_text()


def test_launch_multi_host_environment(tmp_path):
    r = _launch(tmp_path, _ENV + "print('PORT', os.environ['MASTER_PORT'],"
                " os.environ['PADDLE_MASTER'])\n",
                ["--nnodes", "2", "--rank", "1", "--nproc_per_node", "2",
                 "--master", "10.0.0.5:6170", "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    out = r.stdout.decode()
    assert "[rank 3] PADDLE_TRAINER_ID=3 PADDLE_TRAINERS_NUM=4 " \
           "PADDLE_LOCAL_RANK=1 RANK=3 WORLD_SIZE=4 LOCAL_RANK=1 " \
           "MASTER_ADDR=10.0.0.5" in out
    assert "[rank 2] PORT 6170 10.0.0.5:6170" in out


def test_launch_fail_fast(tmp_path):
    body = ("import os, sys, time\n"
            "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    r = _launch(tmp_path, body, ["--nproc_per_node", "2", "--device", "cpu"])
    assert r.returncode == 3
    assert b"terminating remaining workers" in r.stderr
    assert time.monotonic() - t0 < 30


def test_launch_kills_a_worker_that_traps_sigterm(tmp_path):
    body = ("import os, signal, sys, time\n"
            "signal.signal(signal.SIGTERM, lambda *a: None)\n"
            "if os.environ['PADDLE_TRAINER_ID'] == '0':\n"
            "    time.sleep(0.5)\n"
            "    sys.exit(7)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    r = _launch(tmp_path, body, ["--nproc_per_node", "2", "--device", "cpu"])
    assert r.returncode == 7
    assert b"killing" in r.stderr
    assert time.monotonic() - t0 < 30


def test_launch_runs_gloo_ranks(tmp_path):
    body = ("import torch\n"
            "import paddle_tpu_torch.distributed as dist\n"
            "dist.init_parallel_env()\n"
            "t = torch.tensor([float(dist.get_rank() + 1)])\n"
            "dist.all_reduce(t)\n"
            "print('backend', dist.get_backend(), 'sum', float(t))\n")
    r = _launch(tmp_path, body, ["--nproc_per_node", "2", "--device", "cpu",
                                 "--init_method",
                                 "file://" + str(tmp_path / "store")])
    out = r.stdout.decode()
    assert r.returncode == 0, (out, r.stderr)
    assert "[rank 0] backend gloo sum 3.0" in out, out
    assert "[rank 1] backend gloo sum 3.0" in out, out


def test_launch_without_cuda_refuses_the_cuda_default(tmp_path):
    """No quiet fallback: a worker asking for the default device where no
    CUDA device is visible fails, and the job fails with it."""
    body = ("import paddle_tpu_torch.distributed as dist\n"
            "dist.init_parallel_env()\n")
    r = _launch(tmp_path, body, ["--nproc_per_node", "1"])
    assert r.returncode != 0
    assert b"device='cpu'" in r.stderr
