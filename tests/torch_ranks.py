"""Gloo worlds of rank processes for the port's model-parallel tests.

``Worlds`` starts, for each world size, that many processes of a rank
script (``RANK WORLD PORT IN.npz OUT_DIR``, as
``tests/torch_model_parallel_ranks.py`` takes them) at once and in the
background, each world on a free localhost port with its inputs as one
``.npz``, so the test process computes the JAX side meanwhile; ``result``
waits for a world and reads each rank's ``<case>.rank<r>.npz``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
MODEL_PARALLEL_RANKS = REPO / "tests" / "torch_model_parallel_ranks.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Worlds:
    """``cases``: {world size: [case dicts, each with a ``name``]};
    ``arrays``: {world size: {"<case>/<key>": numpy array}}."""

    def __init__(self, tmp, cases, arrays, script=MODEL_PARALLEL_RANKS,
                 timeout_s: float = 240):
        self.timeout_s = timeout_s
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs, self.dirs = {}, {}
        for world, world_cases in cases.items():
            d = Path(tmp) / f"w{world}"
            d.mkdir()
            src = d / "inputs.npz"
            np.savez(src, cases=json.dumps(world_cases), **arrays[world])
            port = free_port()
            self.dirs[world] = d
            self.procs[world] = [subprocess.Popen(
                [sys.executable, str(script), str(r), str(world), str(port),
                 str(src), str(d)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for r in range(world)]

    def result(self, world, name):
        """Each rank's outputs of case ``name``; asserts that every rank
        exited 0 and that none imported JAX."""
        logs = []
        for p in self.procs[world]:
            try:
                logs.append(p.communicate(timeout=self.timeout_s)[0]
                            .decode())
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0].decode())
            except ValueError:  # already collected
                pass
        for p, log in zip(self.procs[world], logs):
            assert p.returncode == 0, log[-4000:]
        outs = []
        for r in range(world):
            res = dict(np.load(self.dirs[world] / f"{name}.rank{r}.npz"))
            assert not res.pop("jax_imported")
            outs.append(res)
        return outs

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
