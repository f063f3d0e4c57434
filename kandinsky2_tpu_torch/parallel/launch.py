"""One process per shard: spawn a group of ranks joined by
``torch.distributed`` and run functions on all of them, with a deadline.

JAX runs a sharded program in one process; the port runs each shard in a
process of its own.  :class:`RankPool` spawns ``world`` ranks once (the
``spawn`` start method), joins them in a process group over ``backend`` at
a free local port, and runs each task given to :meth:`RankPool.run` on
every rank as ``fn(mesh, *args)``, ``mesh`` the group's one-axis
``Mesh("sp")``.  Results come back by rank.  Where a rank raises, dies or
the deadline passes, the pool kills every rank and raises, so a hung
collective never hangs the caller; the next ``run`` spawns a fresh pool.

The ranks run on the card (``device="cuda"``, the default: a rank fails
where there is none) unless the caller asks for ``device="cpu"``.
Backends: ``"gloo"`` for several ranks that share one card (each rank
keeps its tensors on the card, and the collectives stage what gloo cannot
carry) or on the CPU; ``"nccl"`` for one card a rank.
"""

from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh


def free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, backend, device, threads, init_timeout, tasks, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        elif device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=init_timeout))
        mesh = Mesh()
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, "ok", fn(mesh, *args, **kwargs)))
            except BaseException:  # reported to the parent, which kills the pool
                results.put((rank, "error", traceback.format_exc()))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``world`` ranks over ``backend`` on ``device`` (see the module
    docstring); ``threads`` sets each rank's intra-op threads,
    ``init_timeout`` the process group's timeout in seconds."""

    def __init__(self, world: int, backend: str = "gloo", device: str = "cuda",
                 threads: int = 1, init_timeout: float = 60.0):
        self.world, self.backend, self.device = world, backend, device
        self.threads, self.init_timeout = threads, init_timeout
        self._procs = []

    def start(self) -> None:
        """Spawn the ranks (``run`` does where they are not running)."""
        ctx = mp.get_context("spawn")
        port = free_port()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, self.world, port, self.backend, self.device, self.threads,
                  self.init_timeout, self._tasks[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout: float = 120.0, **kwargs) -> list:
        """``fn(mesh, *args, **kwargs)`` on every rank (``fn`` importable
        by name); the results by rank.  Raises (after killing the ranks)
        where a rank raises or dies, or ``timeout`` seconds pass."""
        if not self._procs:
            self.start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        deadline = time.monotonic() + timeout
        out, done = [None] * self.world, set()
        while len(done) < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                self.kill()
                raise TimeoutError(f"{getattr(fn, '__name__', fn)}: ranks "
                                   f"{sorted(set(range(self.world)) - done)} "
                                   f"did not finish in {timeout} s; killed")
            try:
                rank, status, value = self._results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if p.exitcode is not None and r not in done]
                if dead:
                    self.kill()
                    raise RuntimeError(f"ranks {dead} exited without a result")
                continue
            if status == "error":
                self.kill()
                raise RuntimeError(f"rank {rank} raised:\n{value}")
            out[rank] = value
            done.add(rank)
        return out

    def kill(self) -> None:
        """Stop every rank now."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []

    def close(self, timeout: float = 20.0) -> None:
        """Let the ranks leave the group and exit; kill what is left after
        ``timeout`` seconds."""
        if not self._procs:
            return
        for q in self._tasks:
            q.put(None)
        end = time.monotonic() + timeout
        for p in self._procs:
            p.join(timeout=max(0.1, end - time.monotonic()))
        self.kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn, world: int, *args, backend: str = "gloo", device: str = "cuda",
              threads: int = 1, timeout: float = 600.0, **kwargs) -> list:
    """Spawn ``world`` ranks, run ``fn(mesh, *args, **kwargs)`` once on
    each within ``timeout`` seconds, stop them; the results by rank."""
    with RankPool(world, backend, device, threads) as pool:
        return pool.run(fn, *args, timeout=timeout, **kwargs)
