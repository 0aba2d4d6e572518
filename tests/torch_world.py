"""Run a function on a local torch.distributed world, one process per rank,
under a hard time limit.

``run_world("path/to/file.py:fn", 4)`` starts 4 Python processes; each
joins a process group through a ``FileStore`` in a fresh temporary
directory (no port to clash over), calls ``fn(rank, world_size, *args)``
and sends back what it returns (pickled). A rank that fails, or a world
that outlives ``timeout`` seconds (a collective that hangs because the
ranks disagree), kills every rank and raises ``RuntimeError`` with the
ranks' error output. The tests of the distributed layer and
``chip_smoke.py``'s multi-rank leg run through it.

``fn`` names a module by dotted name or by file path, then a function in
it; the ranks import it afresh, so keep what it imports at module level
cheap. Each rank runs this file as a script, with the repository's root
first on its path: the tests import the module as ``torch_world``, and
``chip_smoke.py`` loads it by path.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shard_of(x, rank: int, ndev: int, fill=0) -> np.ndarray:
    """Rank ``rank``'s block of the array x padded to s*ndev rows with
    ``fill`` (s = ceil(len(x) / ndev)): the shard a distributed operator
    takes."""
    x = np.asarray(x)
    s = -(-x.shape[0] // ndev)
    pad = s * ndev - x.shape[0]
    if pad:
        x = np.concatenate([x, np.full((pad,), fill, x.dtype)])
    return x[rank * s:(rank + 1) * s]


def _load(spec: str):
    mod_name, fn_name = spec.rsplit(":", 1)
    if mod_name.endswith(".py"):
        s = importlib.util.spec_from_file_location("_world_rank_fn",
                                                   mod_name)
        mod = importlib.util.module_from_spec(s)
        sys.modules[s.name] = mod
        s.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def _rank_main(cfg_path: str) -> None:
    import torch
    import torch.distributed as dist

    with open(cfg_path, "rb") as f:
        cfg = pickle.load(f)
    rank, world = cfg["rank"], cfg["world"]
    if cfg["threads"]:
        torch.set_num_threads(cfg["threads"])
    store = dist.FileStore(cfg["store"], world)
    dist.init_process_group(
        cfg["backend"], store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=cfg["timeout"]))
    try:
        out = _load(cfg["fn"])(rank, world, *cfg["args"])
        with open(cfg["out"], "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_world(fn: str, world_size: int, *, backend: str = "gloo",
              timeout: float = 120, args=(), threads: int = 1,
              env: dict | None = None) -> list:
    """Results of fn(rank, world_size, *args) on every rank, in rank order.
    ``threads`` caps each rank's torch threads (0: torch's default)."""
    with tempfile.TemporaryDirectory(prefix="rs_world_") as tmp:
        procs, outs, logs = [], [], []
        penv = dict(os.environ if env is None else env)
        penv["PYTHONPATH"] = os.pathsep.join(
            [_REPO] + [p for p in penv.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        for r in range(world_size):
            cfg = dict(rank=r, world=world_size, backend=backend,
                       store=os.path.join(tmp, "store"), fn=fn,
                       args=tuple(args), out=os.path.join(tmp, f"out{r}"),
                       timeout=timeout, threads=threads)
            cpath = os.path.join(tmp, f"cfg{r}")
            with open(cpath, "wb") as f:
                pickle.dump(cfg, f)
            log = open(os.path.join(tmp, f"log{r}"), "w+")
            logs.append(log)
            outs.append(cfg["out"])
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), cpath],
                cwd=_REPO, env=penv, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    failed = f"world of {world_size} ranks passed {timeout} s"
                    break
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].poll()}"
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed:
            tails = []
            for r, log in enumerate(logs):
                log.seek(0)
                tails.append(f"--- rank {r} ---\n" + log.read()[-3000:])
            for log in logs:
                log.close()
            raise RuntimeError(failed + "\n" + "\n".join(tails))
        for log in logs:
            log.close()
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


if __name__ == "__main__":
    _rank_main(sys.argv[1])
