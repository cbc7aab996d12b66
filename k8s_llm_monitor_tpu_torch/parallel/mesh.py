"""The serving mesh: one process per rank over ``torch.distributed``.

The JAX package's mesh is one controller over a GSPMD ``data x seq x model``
device mesh.  PyTorch has no counterpart, so a mesh of the port is a group
of processes, one per rank, each on its own device:

  * **Rank 0** is the calling process: it holds the engine that schedules
    (the allocator, the prefix cache, the slot table, the read-back).
  * **Ranks 1..N-1** are workers that ``create_mesh`` starts with
    ``torch.multiprocessing`` (spawn).  Each builds the same model on its
    own device, keeping its shard of the weights (parallel/sharding.py),
    and the same engine over its kv-head slice of every page.
  * **Every device call is replayed**: rank 0 sends each call's kind and
    small host inputs (token and table buffers, the grammar table, the
    history rows) down a pipe to each worker, then runs the call itself;
    every rank runs the same program, and the model's collectives
    (models/llama.py) meet across the ranks.  Logits end replicated and
    every rank samples with the same seeded generator, so the tokens
    agree; only rank 0 reads them back.

Collectives run on NCCL when each rank has a card of its own.  A mesh of N
ranks with fewer than N cards raises, as the JAX package's ``create_mesh``
does, unless the caller asks for ``backend="gloo"``: gloo then runs the
collectives through host memory ("host-staged"; a CUDA tensor is copied to
the host and back), several ranks may share a card, and the engine runs
its decode programs eagerly (no CUDA graphs).  The CPU tests ask for gloo.

The ranks form JAX's ``(data, seq, model)`` device array with ``model``
innermost: rank ``r`` sits at ``data_rank = r // (seq * model)``,
``seq_rank = r // model % seq`` and ``model_rank = r % model``.  The
model's collectives (``all_reduce``, ``all_gather``, ``reduce_scatter``)
run over the rank's **model group**, the ``model`` ranks of its
``(data, seq)`` coordinate, exactly as on a mesh of the model axis alone;
``seq_all_gather`` and ``seq_all_reduce`` run over its **seq group**, the
``seq`` ranks of its ``(data, model)`` coordinate (sequence-sharded
prefill, models/llama.py); ``broadcast`` reaches every rank.  Ranks of one
``model_rank`` hold the same shard; a ``data`` replica computes what
replica 0 computes (the JAX engine's serving ``data`` axis replicates the
params, the pages and the token batch), so no collective crosses it.
Every rank builds the groups in the same order (``_init_group``).  One
host only: the JAX package's ``init_multihost`` is ROADMAP A11.

One model and one engine live on a mesh's workers at a time: building a
model on the mesh retires the previous one (and its engine), building an
engine retires the previous engine.  A retired model or engine of rank 0
raises when it is used.

A mesh whose ranks may no longer run the same calls is **broken**, for
good: a worker that exits or reports an error, a send that fails, or a
call of rank 0 that raises after the workers were sent it (they run it,
rank 0 did not, and every later collective would pair two calls' inputs).
Every later call raises ``MeshBroken``; the owner kills the workers and
drops the process group (``abort``) and builds a new mesh.  Over NCCL a
collective with a dead rank never ends, so rank 0 watches its workers and
aborts the process group when one exits, which ends the kernels waiting on
it; the engine reads nothing a call returned after that.  The abort waits
for the call of rank 0 that is launching (``Mesh.launching``) to return,
unless that launch is itself held up behind the dead rank; the call
raises ``MeshBroken`` once its launch returns.

A launch that is held up is what hung rank 0 over NCCL: its step thread
sat inside a prefill's ``dist.all_reduce`` behind the dead rank, and the
watcher's abort waited on that collective.  A prefill round is about a
thousand eager launches, and the queue of a stream that waits behind a
dead rank's collective fills, so the next enqueue blocks for room.  Over
NCCL rank 0 is therefore **paced** (``Mesh.paced``): a prefill round waits
after each layer until the device has run the layer before
(``LaunchPacer``), and a reconcile waits for its call's event, both by
polling the event and ``Mesh.broken`` (``wait_event``), never inside a
blocking CUDA call.  (Unpaced, a killed rank's break hung rank 0 this way
on H100s.)  A broken mark then ends rank 0's launch at the next layer
with ``MeshBroken``; the watcher's abort meets no enqueue of rank 0's and
leaves every group (the default one and the sub-groups).  Every group's
communicator is made when the mesh is built (``_init_group``), so no
first use of one waits on a peer that has died since.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import logging
import os
import socket
import threading
import time
import traceback
from typing import Any, Optional

import torch

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock

logger = logging.getLogger(__name__)

AXES = ("data", "seq", "model")

# Why this process can build no mesh again (None: it can): a process group
# it could not leave within ``Mesh.ABORT_WAIT_S`` (``Mesh._abort_group``).
_STUCK: Optional[str] = None

# The bytes of one message of a worker's state (``Mesh.worker_states``).
_CHUNK = 8 << 20


class MeshBroken(RuntimeError):
    """The mesh's ranks may no longer run the same calls: every call on it
    raises this until it is rebuilt (``Mesh.abort``, then ``create_mesh``).
    """


class MeshUnusable(RuntimeError):
    """This process could not leave a mesh's process group: the abort is
    still running in it, so no mesh can be built here again
    (``create_mesh`` raises this); the process must be restarted."""


def unusable() -> Optional[str]:
    """Why this process can build no mesh again, or None."""
    return _STUCK


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    seq: int = 1
    model: int = 1

    @property
    def size(self) -> int:
        return self.data * self.seq * self.model

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "seq": self.seq, "model": self.model}

    def coords(self, rank: int) -> tuple[int, int, int]:
        """(data, seq, model) coordinate of ``rank``: JAX's device array
        order, ``model`` innermost."""
        return (rank // (self.seq * self.model),
                rank // self.model % self.seq, rank % self.model)

    def groups(self) -> tuple[list[list[int]], list[list[int]]]:
        """(model groups, seq groups): the ranks of each ``(data, seq)``
        coordinate in model order, then of each ``(data, model)``
        coordinate in seq order; a group of one rank, or one that is the
        whole world, is left out (the default group serves it)."""
        n, sm = self.size, self.seq * self.model
        model = [[d * sm + q * self.model + m for m in range(self.model)]
                 for d in range(self.data) for q in range(self.seq)]
        seq = [[d * sm + q * self.model + m for q in range(self.seq)]
               for d in range(self.data) for m in range(self.model)]
        return ([g for g in model if 1 < len(g) < n],
                [g for g in seq if 1 < len(g) < n])


def parse_mesh_shape(text: str) -> MeshConfig:
    """``llm.tpu.mesh_shape`` ("data,seq,model", e.g. "1,1,2")."""
    data, seq, model = (int(x) for x in text.split(","))
    return MeshConfig(data=data, seq=seq, model=model)


class Mesh:
    """One rank's view of a serving mesh: its rank and its coordinates, its
    device, the collectives of its model and seq groups, and on rank 0 the
    pipes to the workers.

    A mesh of one rank has no process group and no workers; a collective
    over a group of one rank returns its input."""

    # How long the watcher waits for a launching call before it aborts
    # the process group under it (``_worker_exited``).
    LAUNCH_WAIT_S = 5.0
    # The poll interval of a paced wait (``wait_event``).
    POLL_S = 0.0002
    # How long leaving the process group may take (``_abort_group``).
    ABORT_WAIT_S = 120.0

    def __init__(self, cfg: MeshConfig, rank: int, devices: list,
                 backend: str, conns=(), procs=(), groups=None):
        self.config = cfg
        self.rank = rank
        self.data_rank, self.seq_rank, self.model_rank = cfg.coords(rank)
        # The process groups of this rank's model and seq groups (None: the
        # default group, or a group of one rank).
        self._model_group, self._seq_group = groups or (None, None)
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[rank]
        self.backend = backend
        self._conns = list(conns)
        self._procs = list(procs)
        self.closed = False
        # A CUDA tensor crosses gloo through host memory.
        self.host_staged = backend == "gloo" and self.device.type == "cuda"
        # The model and engine the workers hold (rank 0 counts them).
        self.model_token = 0
        self.engine_token = 0
        # Why the ranks may no longer run the same calls (None: they do).
        self.broken: Optional[str] = None
        # Held by rank 0 while it talks to the workers and while it sends a
        # call and runs its share.
        self._calls = make_lock("mesh.calls", reentrant=True)
        # Rank 0's calls that are launching device work on the process
        # group (``launching``); the watcher aborts the group only when
        # none is.  Its own RLock, not ``make_lock``'s: the watcher
        # re-enters it through ``_abort_group``, and lockcheck's
        # instrumented lock lacks the owner test a Condition needs.
        self._launch_cv = threading.Condition()
        self._launching = 0
        self._aborted = False
        # The all-reduce's bus rate (GB/s) by payload bytes (``bus_gbs``).
        self._bus_gbs: dict[int, float] = {}
        if self._procs:
            threading.Thread(target=self._watch, daemon=True,
                             name="mesh-watch").start()

    @property
    def shape(self) -> dict[str, int]:
        return self.config.shape

    @property
    def tp(self) -> int:
        """The model (tensor-parallel) degree."""
        return self.config.model

    @property
    def sp(self) -> int:
        """The seq (sequence-parallel prefill) degree."""
        return self.config.seq

    @property
    def size(self) -> int:
        """The ranks of the mesh (``data * seq * model``)."""
        return self.config.size

    @property
    def is_leader(self) -> bool:
        """Rank 0 of a mesh with workers: the rank that sends."""
        return self.rank == 0 and self.size > 1

    @property
    def paced(self) -> bool:
        """Rank 0 of an NCCL mesh: its launches are paced (``LaunchPacer``)
        and its waits poll (``wait_event``), so no enqueue of its blocks
        behind a dead rank's collective."""
        return (self.is_leader and self.backend == "nccl"
                and self.device.type == "cuda")

    def device_kind(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    # -- collectives ------------------------------------------------------

    def _staged(self, fn, x: torch.Tensor) -> torch.Tensor:
        if not self.host_staged:
            return fn(x)
        # A gloo mesh on CUDA: the engine runs its programs eagerly there.
        return fn(x.cpu()).to(x.device)  # graftcheck: disable=capture-hazard -- gloo: no graphs

    def _all_reduce(self, x: torch.Tensor, op: str, n: int, group):
        if n == 1:
            return x
        import torch.distributed as dist

        rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM

        def run(t):
            t = t.contiguous()
            dist.all_reduce(t, op=rop, group=group)
            return t

        return self._staged(run, x)

    def _all_gather(self, x: torch.Tensor, dim: int, n: int, group):
        if n == 1:
            return x
        import torch.distributed as dist

        def run(t):
            t = t.contiguous()
            if self.backend == "gloo":
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t, group=group)
            else:
                out = t.new_empty((n,) + tuple(t.shape))
                dist.all_gather_into_tensor(out, t, group=group)
                parts = list(out.unbind(0))
            return torch.cat(parts, dim=dim)

        return self._staged(run, x)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or max) of ``x`` over the model group, on each of its
        ranks."""
        return self._all_reduce(x, op, self.tp, self._model_group)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The model group's ``x`` concatenated along ``dim`` in model-rank
        order."""
        return self._all_gather(x, dim, self.tp, self._model_group)

    def seq_all_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The seq group's ``x`` concatenated along ``dim`` in seq-rank
        order (a prefill round's K/V slices joined into the chunk's)."""
        return self._all_gather(x, dim, self.sp, self._seq_group)

    def seq_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the seq group, on each of its ranks."""
        return self._all_reduce(x, "sum", self.sp, self._seq_group)

    def reduce_scatter(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum of ``x`` over the
        ranks."""
        if self.tp == 1:
            return x
        import torch.distributed as dist

        def run(t):
            chunks = [c.contiguous() for c in t.chunk(self.tp, dim=dim)]
            out = torch.empty_like(chunks[0])
            if self.backend == "gloo":
                dist.reduce_scatter(out, chunks, group=self._model_group)
            else:
                dist.reduce_scatter_tensor(out, torch.stack(chunks),
                                           group=self._model_group)
            return out

        return self._staged(run, x)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank of the mesh (``x`` gives the shape
        and dtype on the others)."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        def run(t):
            t = t.contiguous()
            dist.broadcast(t, src=0)
            return t

        return self._staged(run, x)

    def bus_gbs(self, nbytes: int, reps: int = 10) -> float:
        """The all-reduce's bus rate over this mesh at a payload of
        ``nbytes`` (GB/s: ``2 (tp - 1) / tp`` of the payload per rank over
        the time of one all-reduce), measured with ``bench_all_reduce`` at
        its first call for that size and kept.  Rank 0, between calls; 0.0
        for a model group of one rank (no all-reduce)."""
        if self.tp == 1:
            return 0.0
        if nbytes not in self._bus_gbs:
            numel = max(nbytes // 2, 1)
            ms = bench_all_reduce(self, numel, reps)
            self._bus_gbs[nbytes] = (2.0 * (self.tp - 1) / self.tp * numel
                                     * 2 / (ms * 1e-3) / 1e9)
        return self._bus_gbs[nbytes]

    # -- the workers (rank 0) ----------------------------------------------

    def mark_broken(self, reason: str) -> None:
        """Record that the ranks may no longer run the same calls (the
        first reason stays)."""
        if self.broken is None:
            self.broken = reason

    def check(self) -> None:
        """Raise ``MeshBroken`` if the mesh is broken or a worker has
        reported an error or exited (a worker only speaks unasked to say
        so)."""
        if self.broken is None and self._conns:
            with self._calls:
                for r, conn in enumerate(self._conns, start=1):
                    if conn.poll():
                        try:
                            msg = conn.recv()[1]
                        except (EOFError, OSError):
                            msg = "exited"
                        self.mark_broken(f"mesh rank {r} failed: {msg}")
                        break
        if self.broken is not None:
            raise MeshBroken(self.broken)

    def send(self, *msg) -> None:
        """Send one message to every worker."""
        if self.closed:
            raise RuntimeError("the mesh is closed")
        with self._calls:
            self.check()
            for conn in self._conns:
                try:
                    conn.send(msg)
                except OSError as exc:
                    self.mark_broken(f"send of {msg[0]!r} failed: {exc!r}")
                    raise MeshBroken(self.broken) from exc

    def request(self, *msg, timeout: Optional[float] = None) -> list:
        """Send one message to every worker and return each one's reply; a
        worker that fails, exits or (with ``timeout``) does not answer in
        time breaks the mesh."""
        with self._calls:
            self.send(*msg)
            out = []
            for r, conn in enumerate(self._conns, start=1):
                if timeout is not None and not conn.poll(timeout):
                    self.mark_broken(f"mesh rank {r} did not answer "
                                     f"{msg[0]!r} in {timeout:.0f} s")
                    raise MeshBroken(self.broken)
                try:
                    kind, payload = conn.recv()
                except (EOFError, OSError):
                    kind, payload = "error", "exited"
                if kind == "error":
                    self.mark_broken(f"mesh rank {r} failed: {payload}")
                    raise MeshBroken(self.broken)
                out.append(payload)
            return out

    @contextlib.contextmanager
    def launching(self):
        """Rank 0 launches device work on the process group inside this
        block: the watcher does not abort the group until the block ends.
        It raises ``MeshBroken`` on entry to a broken mesh, and on exit if
        the mesh broke meanwhile (what the launch enqueued may meet an
        aborted communicator: nothing it returns may be read)."""
        with self._launch_cv:
            if self.broken is not None:
                raise MeshBroken(self.broken)
            self._launching += 1
        try:
            yield
        finally:
            with self._launch_cv:
                self._launching -= 1
                self._launch_cv.notify_all()
        if self.broken is not None:
            raise MeshBroken(self.broken)

    def wait_event(self, event) -> None:
        """Wait until the device has passed ``event`` (a CUDA event) by
        polling it, raising ``MeshBroken`` as soon as the mesh breaks: the
        waiting thread is never inside a blocking CUDA call that the
        watcher's abort would have to end."""
        while not event.query():
            if self.broken is not None:
                raise MeshBroken(self.broken)
            time.sleep(self.POLL_S)

    def replay(self, msg: tuple, run):
        """Send device call ``msg`` to every worker, then return ``run()``,
        rank 0's share of it, launched inside ``launching``.  Whatever
        raises after the send breaks the mesh: the workers run the call
        and rank 0 did not."""
        with self._calls, self.launching():
            self.send(*msg)
            try:
                return run()
            except BaseException as exc:
                # A worker that died under the call is the cause (gloo's
                # collective then fails on the dead peer's socket).
                self._mark_exited()
                self.mark_broken(f"rank 0's {msg[1]!r} call failed after "
                                 f"the workers were sent it: {exc!r}")
                if not isinstance(exc, Exception):
                    raise
                raise MeshBroken(self.broken) from exc

    def _mark_exited(self, timeout: float = 1.0) -> None:
        """Break the mesh for a worker that has exited, if one has or does
        within ``timeout`` (a collective can fail on the dead peer's socket
        before its process is gone; the process is not reaped here)."""
        from multiprocessing.connection import wait

        sentinels = [p.sentinel for p in self._procs]
        ready = wait(sentinels, timeout=timeout)
        if ready:
            self.mark_broken(f"mesh rank {1 + sentinels.index(ready[0])} "
                             "exited")

    def healthy(self, timeout: float = 60.0) -> bool:
        """True when every worker answers a ping within ``timeout`` (after
        the calls sent before it) and the mesh is not broken; a worker
        that does not answer breaks it."""
        if self.broken is not None or self.closed:
            return False
        if not self._conns:
            return True
        if not self._calls.acquire(timeout=timeout):
            self.mark_broken(f"a call held the mesh for {timeout:.0f} s")
            return False
        try:
            self.request("ping", timeout=timeout)
        except MeshBroken:
            return False
        finally:
            self._calls.release()
        return True

    def worker_states(self) -> list[dict]:
        """Each worker's parameters and buffers (CPU tensors), rank 1 on.
        The bytes come in chunks of ``_CHUNK``: a pipe's ``recv`` of one
        message of gigabytes allocates the whole message again for every
        read of the socket (a 2.8 GB state did not arrive in 800 s on the
        H100 host)."""
        with self._calls:
            sizes = self.request("state")
            out = []
            for n, conn in zip(sizes, self._conns, strict=True):
                buf = bytearray(n)
                off = 0
                while off < n:
                    chunk = conn.recv_bytes()
                    buf[off:off + len(chunk)] = chunk
                    off += len(chunk)
                out.append(torch.load(io.BytesIO(buf)))
            return out

    def sync(self) -> None:
        """Wait until every worker has run what it was sent."""
        self.request("ping")

    def build_on_workers(self, builder: str, *args, **kwargs) -> int:
        """Have every worker build its shard of a model with ``builder``
        (a name of ``_builders()``, or ``"quantize"``: the int8 twin of
        the model it holds) on ``args``, rank 0 having built its own;
        returns the model's token."""
        self.send("build", builder, args, kwargs)
        return self._new_model()

    def build_alongside(self, run, builder: str, *args, **kwargs):
        """``build_on_workers``, then ``run()``, rank 0's own build, as a
        replayed call (the ranks' builds meet in their collectives; a
        ``run`` that raises breaks the mesh).  Returns (the model's token,
        what ``run`` returned)."""
        out = self.replay(("build", builder, args, kwargs), run)
        return self._new_model(), out

    def _new_model(self) -> int:
        self.model_token += 1
        self.engine_token += 1
        return self.model_token

    def _watch(self) -> None:
        """Rank 0's watcher: when a worker exits before ``close``, break
        the mesh (``_worker_exited``)."""
        from multiprocessing.connection import wait

        ended = wait([p.sentinel for p in self._procs])
        if self.closed:
            return
        r = 1 + [p.sentinel for p in self._procs].index(ended[0])
        self._procs[r - 1].join(timeout=1.0)
        self._worker_exited(r, self._procs[r - 1].exitcode)

    def _worker_exited(self, r: int, code) -> None:
        """Break the mesh for worker ``r``'s exit; over NCCL also abort the
        process group, which ends the collectives waiting on the dead rank
        (gloo's raise by themselves).  The broken mark comes first, so no
        call starts a launch after it; the abort then waits until the call
        that is launching (``launching``) returns, at most
        ``LAUNCH_WAIT_S``: a launch that has not returned by then is held
        by a full queue of kernels behind the dead rank's collective,
        which only the abort ends (it then raises ``MeshBroken``)."""
        with self._launch_cv:
            self.mark_broken(f"mesh rank {r} exited (code {code})")
            if self.backend != "nccl":
                return
            # A paced launch sees the mark at its next layer and leaves.
            self._launch_cv.wait_for(lambda: not self._launching,
                                     timeout=self.LAUNCH_WAIT_S)
            self._abort_group()

    def _abort_group(self) -> None:
        """Leave the process group without a word to the other ranks (each
        does the same, so no rank waits on another).  The default group's
        abort aborts every group this process made, the model and seq
        groups with it (newest first).

        The abort runs in a thread of its own, waited for at most
        ``ABORT_WAIT_S``: over NCCL the close of a mesh built after two
        breaks hung in it (ROADMAP C4).  An abort that does not return by
        then leaves the group half torn down and still running, so the
        process is marked unusable (``unusable``): the caller returns,
        and every later ``create_mesh`` in this process raises
        ``MeshUnusable``, which ends a supervisor's rebuild (it gives up,
        and the process's own restart policy replaces it)."""
        global _STUCK
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _abort_process_group

        with self._launch_cv:   # the watcher and abort() may race here
            if self._aborted or self.size == 1 or not dist.is_initialized():
                return
            self._aborted = True
            done = threading.Event()
            threading.Thread(target=lambda: (_abort_process_group(),
                                             done.set()),
                             daemon=True, name="mesh-abort").start()
            if not done.wait(self.ABORT_WAIT_S):
                _STUCK = (f"leaving the process group took more than "
                          f"{self.ABORT_WAIT_S:.0f} s (rank {self.rank})")
                logger.error("%s: this process can build no mesh again",
                             _STUCK)

    def abort(self) -> None:
        """Drop a broken mesh: kill the workers and leave the process
        group."""
        self.mark_broken("aborted")
        self.closed = True
        for p in self._procs:
            p.kill()
            p.join()
        self._abort_group()

    def close(self) -> None:
        """Stop the workers and leave the process group.  Every worker
        first answers a ping (so no rank is inside a collective), then
        exits without leaving the group (``_worker_main``); rank 0 joins
        them and then leaves, alone.  A mesh that cannot get there is
        aborted."""
        if self.closed:
            return
        if not self.healthy():
            self.abort()
            return
        self.closed = True
        for conn in self._conns:
            try:
                conn.send(("close",))
            except OSError:
                pass    # exited since the ping: joined below
        if self.size > 1 and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._abort_group()


def bench_all_reduce(mesh: Mesh, numel: int, reps: int) -> float:
    """ms per all-reduce of ``numel`` bf16 elements (CUDA events on the
    card, the host clock elsewhere), after one warm-up; every rank runs it
    (rank 0 sends it to the workers first)."""
    if mesh.is_leader:
        mesh.send("bench_all_reduce", numel, reps)
    x = torch.ones(numel, dtype=torch.bfloat16, device=mesh.device)
    mesh.all_reduce(x)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
    else:
        h0 = time.monotonic()
    for _ in range(reps):
        x = mesh.all_reduce(x)
    if cuda:
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps
    return (time.monotonic() - h0) * 1e3 / reps


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LaunchPacer:
    """Keeps rank 0's launches of one call at most one mark ahead of the
    device: each call records an event on the current stream and waits
    (``Mesh.wait_event``) until the device has passed the previous mark.
    Called after each layer of a prefill round over NCCL, it bounds the
    launch queue to about two layers' kernels, so no enqueue blocks for
    room behind a dead rank's collective."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.last = None

    def __call__(self) -> None:
        ev = torch.cuda.Event()
        ev.record()
        if self.last is not None:
            self.mesh.wait_event(self.last)
        self.last = ev


def _init_group(backend: str, addr: str, rank: int, cfg: MeshConfig,
                device: torch.device):
    """Join the default group as ``rank`` of ``cfg.size``, then make every
    model group and every seq group (every rank makes each, in the same
    order, as ``new_group`` requires); returns this rank's (model group,
    seq group), None where the default group serves or no group is
    needed.

    Each group's communicator is made here, while every rank is alive,
    by one small all-reduce a group: a communicator made at a later first
    use would wait inside that enqueue for its peers (a dead one would
    hold it there, and the abort behind it)."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=600)
    dist.init_process_group(backend, init_method=addr, world_size=cfg.size,
                            rank=rank, timeout=timeout)
    mine = []
    for ranks_of in cfg.groups():
        own = None
        for ranks in ranks_of:
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                own = g
        mine.append(own)
    x = torch.zeros(1, device=device if backend == "nccl" else "cpu")
    for g in [None] + [g for g in mine if g is not None]:
        dist.all_reduce(x, group=g)
    if x.is_cuda:
        torch.cuda.synchronize(device)
    return tuple(mine)


def create_mesh(cfg: Optional[MeshConfig] = None, devices: Optional[list] = None,
                *, backend: str = "nccl", device=None) -> Mesh:
    """Build a ``data x seq x model`` mesh: start ranks 1..N-1 (spawn), join
    the process group as rank 0 and return rank 0's ``Mesh``.

    ``devices`` names one device per rank; by default rank r takes card r
    of ``device``'s type (``cuda`` unless the caller names ``cpu``).  NCCL
    (the default) needs a card per rank: fewer cards than ranks raise, as
    the JAX package's ``create_mesh`` does.  ``backend="gloo"`` must be
    asked for by name: it runs the collectives through host memory, lets
    ranks share cards (rank r on card r mod count) and is the CPU's only
    backend.  The mesh has ``data * seq * model`` ranks on one host (module
    docstring).  Call ``close()`` to stop the workers.
    """
    cfg = cfg or MeshConfig(model=1)
    if min(cfg.data, cfg.seq, cfg.model) < 1:
        raise ValueError(f"mesh {cfg}: every axis must be >= 1")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl | gloo)")
    n = cfg.size
    if devices is None:
        kind = torch.device("cuda" if device is None else device).type
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass device='cpu' and "
                    "backend='gloo' to run the mesh on the CPU")
            count = torch.cuda.device_count()
            if count < n and backend != "gloo":
                raise ValueError(
                    f"mesh {cfg} needs {n} devices, have {count} (pass "
                    "backend='gloo' to share cards through host memory)")
            devices = [torch.device("cuda", r % count) for r in range(n)]
        else:
            devices = [torch.device(kind)] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"mesh {cfg} needs {n} devices, got {len(devices)}")
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("NCCL needs a CUDA device per rank; pass "
                             "backend='gloo' for the CPU")
        if len({d.index for d in devices}) != n:
            raise ValueError("NCCL needs a card per rank; pass "
                             "backend='gloo' to share cards")
    if n == 1:
        return Mesh(cfg, 0, devices, backend)
    import torch.distributed as dist
    import torch.multiprocessing as mp

    if _STUCK is not None:
        raise MeshUnusable(f"{_STUCK}: this process can build no mesh "
                           "again; restart it")
    if dist.is_initialized():
        raise RuntimeError("a process group exists already: close the "
                           "other mesh first")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    conns, procs = [], []
    for r in range(1, n):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_worker_main,
                        args=(cfg, r, [str(d) for d in devices], backend, addr,
                              child),
                        daemon=True, name=f"mesh-rank-{r}")
        p.start()
        child.close()
        conns.append(parent)
        procs.append(p)
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    groups = _init_group(backend, addr, 0, cfg, devices[0])
    return Mesh(cfg, 0, devices, backend, conns, procs, groups=groups)


# ---------------------------------------------------------------------------
# The workers
# ---------------------------------------------------------------------------


def _builders() -> dict:
    """The model builders a worker runs (each takes ``mesh=`` and
    ``device=``)."""
    from k8s_llm_monitor_tpu_torch.convert import params_from_jax
    from k8s_llm_monitor_tpu_torch.models.llama import LlamaModel
    from k8s_llm_monitor_tpu_torch.utils.checkpoint import load_hf_shard
    from k8s_llm_monitor_tpu_torch.utils.quantize import init_params_quantized

    return {"llama": LlamaModel, "quantized": init_params_quantized,
            "jax": params_from_jax, "checkpoint": load_hf_shard}


class _HostRing:
    """Host buffers for the inputs a worker copies in: pinned on CUDA, each
    reused once the copy that read it has completed (its event)."""

    def __init__(self, device: torch.device, depth: int = 8):
        self.cuda = device.type == "cuda"
        self.slots: list = [[None, None] for _ in range(depth)]
        self.i = 0

    def put(self, arr) -> torch.Tensor:
        slot = self.slots[self.i]
        self.i = (self.i + 1) % len(self.slots)
        buf, event = slot
        if event is not None:
            event.synchronize()
        n = arr.size
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 1), dtype=torch.int32,
                              pin_memory=self.cuda)
            slot[0] = buf
        view = buf[:n]
        view.numpy()[:] = arr
        if self.cuda:
            slot[1] = torch.cuda.Event()
        return view

    def mark(self) -> None:
        """Record the event of the buffer handed out last."""
        event = self.slots[self.i - 1][1]
        if event is not None:
            event.record()


def _worker_main(cfg: MeshConfig, rank: int, devices: list, backend: str,
                 addr: str, conn) -> None:
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cpu":
            # The CPU's ranks share its cores: one thread each.
            torch.set_num_threads(1)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        groups = _init_group(backend, addr, rank, cfg, dev)
        mesh = Mesh(cfg, rank, devices, backend, groups=groups)
        _serve(mesh, conn)
    except Exception:  # noqa: BLE001 -- reported to rank 0, then exit
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        os._exit(1)
    # Exit without leaving the group and without the interpreter's
    # teardown: over NCCL a rank's abort waits for its peers' (each worker
    # of a TP-4 mesh held close() for its 30 s join), while a group whose
    # peers have exited is left at once (rank 0, after the joins).
    os._exit(0)


def _serve(mesh: Mesh, conn) -> None:
    """A worker's loop: build what rank 0 builds, replay what it runs."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.serving.engine import InferenceEngine

    model: Any = None
    engine: Any = None
    ring = _HostRing(mesh.device)
    while True:
        msg = conn.recv()
        kind = msg[0]
        if kind == "close":
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            return
        if kind == "build":
            _, name, args, kwargs = msg
            engine = None
            if name == "quantize":
                # The int8 twin of the model this worker holds.
                from k8s_llm_monitor_tpu_torch.utils.quantize import (
                    quantize_params)

                model = quantize_params(model)
            else:
                model = None
                model = _builders()[name](*args, **dict(
                    kwargs, mesh=mesh, device=mesh.device))
        elif kind == "engine":
            _, kwargs, env = msg
            for key, val in env.items():
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
            engine = None
            engine = InferenceEngine(model=model, device=mesh.device,
                                     mesh=mesh, **kwargs)
        elif kind == "op":
            _, name, args = msg
            if name in ("prefill", "decode"):
                args = (ring.put(args[0]),) + tuple(args[1:])
            getattr(engine, "_op_" + name)(*args)
            if name in ("prefill", "decode"):
                ring.mark()
        elif kind == "forward":
            _, tokens, positions = msg
            llama.forward_full(
                model, torch.from_numpy(tokens).to(mesh.device),
                positions=(None if positions is None else
                           torch.from_numpy(positions).to(mesh.device)))
        elif kind == "prefill_logits":
            _, tokens, lengths, bucket, kwargs = msg
            llama.prefill_logits(model, torch.from_numpy(tokens),
                                 torch.from_numpy(lengths), bucket, **kwargs)
        elif kind == "state":
            # torch.save's bytes: bf16 has no numpy dtype.
            buf = io.BytesIO()
            torch.save({k: v.detach().cpu() for k, v in
                        list(model.named_parameters())
                        + list(model.named_buffers())}, buf)
            raw = buf.getbuffer()
            conn.send(("ok", len(raw)))
            for i in range(0, len(raw), _CHUNK):
                conn.send_bytes(raw[i:i + _CHUNK])
        elif kind == "launches":
            from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

            conn.send(("ok", {fn.__name__: fn.launches
                              for fn in pa.KERNEL_WRAPPERS}))
        elif kind == "programs":
            # This rank's decode programs and their captured inputs
            # against its engine's live tensors.
            from k8s_llm_monitor_tpu_torch.devtools.traceguard import (
                program_state)

            conn.send(("ok", None if engine is None
                       else program_state(engine)))
        elif kind == "reset_launches":
            from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

            pa.reset_launch_counts()
        elif kind == "bench_all_reduce":
            _, numel, reps = msg
            bench_all_reduce(mesh, numel, reps)
        elif kind == "ping":
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            conn.send(("ok", mesh.rank))
        else:
            raise ValueError(f"unknown mesh message {kind!r}")
