"""The ranks of a gloo world on localhost, for the port's distributed tests
on the CPU. A test file that uses it runs its own `__main__` block in each
rank as `python <file> <rank> <world> <port> <dir>`; the ranks write their
results as `rank<r>.npz` (arrays) and `rank<r>.json` (the rest) under
<dir>, and the tests read them."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """The ranks of one world size: started at once, read when first needed."""

    def __init__(self, script: str, world: int, tmp: str, timeout_s: float):
        self.world, self.dir, self.timeout_s = world, os.path.join(tmp, f"w{world}"), timeout_s
        os.makedirs(self.dir)
        env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "OMP_NUM_THREADS": "1"}
        port = str(free_port())
        self.procs = [
            subprocess.Popen([sys.executable, os.path.abspath(script), str(r), str(world), port, self.dir],
                             env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)
        ]
        self._ranks = None

    def ranks(self):
        """[(arrays, info)] by rank; fails with the ranks' output if one failed."""
        if self._ranks is None:
            deadline = time.monotonic() + self.timeout_s
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            finally:
                for p in self.procs:
                    p.kill()
            if any(p.returncode for p in self.procs):
                self._ranks = "\n".join(f"--- rank {r} (rc {p.returncode})\n{log[-3000:]}"
                                        for r, (p, log) in enumerate(zip(self.procs, logs)))
            else:
                self._ranks = []
                for r in range(self.world):
                    with open(os.path.join(self.dir, f"rank{r}.json")) as f:
                        self._ranks.append((dict(np.load(os.path.join(self.dir, f"rank{r}.npz"))), json.load(f)))
        if isinstance(self._ranks, str):
            pytest.fail(f"the {self.world} ranks failed:\n{self._ranks}")
        return self._ranks

    def cat(self, key):
        return np.concatenate([a[key] for a, _ in self.ranks()], axis=0)
