"""Start the port's multi-process scenarios (``_torch_dist_worker.py``):
one OS process a rank, a gloo process group over ``localhost``, each
rank's observations saved with ``torch.save`` for the test to read.
The workers import torch and the port only (no JAX), as a ``torchrun``
job would."""

import os
import socket
import subprocess
import sys

import torch

WORKER = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``nprocs`` worker processes running ``scenario``; :meth:`wait`
    returns each rank's saved observations (a failed rank's output is in
    the assertion)."""

    def __init__(self, scenario: str, outdir, nprocs: int,
                 timeout: float = 240):
        self.scenario, self.outdir, self.timeout = scenario, outdir, timeout
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONHASHSEED="0")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, scenario, str(i), str(nprocs),
             str(port), str(outdir)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env) for i in range(nprocs)]

    def wait(self):
        try:
            outs = [p.communicate(timeout=self.timeout)[0].decode()
                    for p in self.procs]
        finally:
            # a crashed rank leaves its peers blocked in a collective
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        for i, p in enumerate(self.procs):
            assert p.returncode == 0, f"rank {i} failed:\n{outs[i][-6000:]}"
        return [torch.load(os.path.join(str(self.outdir),
                                        f"{self.scenario}_{i}.pt"),
                           weights_only=False)
                for i in range(len(self.procs))]


def run_ranks(scenario: str, outdir, nprocs: int, timeout: float = 240):
    """Run ``scenario`` on ``nprocs`` ranks and wait for them."""
    return Ranks(scenario, outdir, nprocs, timeout).wait()
