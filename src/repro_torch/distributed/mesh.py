"""Named device meshes over a ``torch.distributed`` world: the port's
counterpart of the JAX package's ``launch/mesh.py`` (named meshes such as
``("data", "model")``) and ``distributed/compat.py`` (the ``shard_map``
region the collectives run in).

A ``Mesh`` lays the world's ranks out row-major over its named axes, so
a rank's flat index over every axis is its global rank, as the JAX
package's ``core/indexer.py::_flat_device_index`` computes it inside
``shard_map``. Each axis has one process group per line of ranks along
it (``dist.new_group``, built the same way on every rank); a rank's
index in its group is its coordinate on the axis, so chunk ``i`` of an
all-to-all goes to, and the ``i``-th part of an all-gather comes from,
the rank at index ``i`` along the axis, as in ``lax.all_to_all`` and
``lax.all_gather(tiled=True)``.

The transport is picked by the group's backend, never by catching a
failure: NCCL takes CUDA tensors as they are; a gloo group exchanges
host memory, so a CUDA tensor is copied to the host, exchanged and
copied back (``Mesh.host_staged``). Several ranks on one card go over
gloo: NCCL refuses two ranks on one GPU.

A mesh built with no groups (``Mesh(shape, rank)``) only answers
coordinate questions; its collectives raise. The tests and
``chip_smoke.py`` run every rank of such meshes in one process and move
the send buffers between them by hand (``core/indexer.py::
index_step_loopback``).

``spawn_world`` runs a function on every rank of a world of processes on
this host (``spawn`` start method, ``file://`` rendezvous in a directory
of the caller's), with a bounded wait: a rank that fails or overruns
fails the whole world.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

PG_TIMEOUT_S = 60.0     # a collective that waits longer than this raises


class Mesh:
    """Ranks laid out row-major over named axes (``shape``: axis name ->
    size, in order). ``groups``: axis name -> this rank's process group
    along it (``make_mesh`` builds them); without groups the mesh only
    answers coordinate questions. ``device`` is where tensors live that
    the collectives take without staging (CUDA for NCCL, else the host)."""

    def __init__(self, shape: dict, rank: int, groups: dict = None,
                 device=None):
        self.shape = {str(a): int(n) for a, n in dict(shape).items()}
        if not self.shape or min(self.shape.values()) < 1:
            raise ValueError(f"a mesh needs axes of size >= 1: {shape}")
        self.axis_names = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        coords, rest = {}, self.rank
        for name in reversed(self.axis_names):
            coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords = {a: coords[a] for a in self.axis_names}
        self.groups = dict(groups or {})
        self.device = torch.device(device or "cpu")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords})")

    def _axis(self, name: str) -> str:
        if name not in self.shape:
            raise ValueError(f"no axis {name!r} in mesh axes "
                             f"{self.axis_names}")
        return name

    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on ``name`` (``lax.axis_index``)."""
        return self.coords[self._axis(name)]

    def flat_index(self) -> int:
        """Row-major index over every axis: the global rank."""
        idx = 0
        for name in self.axis_names:
            idx = idx * self.shape[name] + self.coords[name]
        return idx

    def rank_at(self, **coords) -> int:
        """The rank at this rank's coordinates with ``coords`` replaced."""
        at = dict(self.coords, **coords)
        idx = 0
        for name in self.axis_names:
            if not 0 <= at[name] < self.shape[name]:
                raise ValueError(f"{name}={at[name]} outside the mesh")
            idx = idx * self.shape[name] + at[name]
        return idx

    def axis_ranks(self, name: str) -> list:
        """The ranks along ``name`` through this rank, by index."""
        return [self.rank_at(**{name: i})
                for i in range(self.axis_size(name))]

    def _group(self, name: str):
        if self._axis(name) not in self.groups:
            raise RuntimeError(f"{self!r} has no process group on {name!r}:"
                               f" build the mesh with make_mesh")
        return self.groups[name]

    def host_staged(self, name: str, tensor: torch.Tensor) -> bool:
        """True when ``tensor`` goes through host memory on ``name``'s
        group: a CUDA tensor on a gloo group."""
        return tensor.is_cuda and \
            dist.get_backend(self._group(name)) == "gloo"

    def all_to_all(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``lax.all_to_all(x, name, 0, 0, tiled=True)`` for ``x`` of
        shape (n, ...), n the axis size: row i goes to the rank at index
        i along ``name``; row j of the result came from index j."""
        group = self._group(name)
        n = self.axis_size(name)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {name!r} ({n} ranks) needs "
                             f"{n} rows, got {tuple(x.shape)}")
        src = x.contiguous()
        staged = self.host_staged(name, src)
        if staged:
            src = src.cpu()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return out.to(x.device) if staged else out

    def all_gather(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``lax.all_gather(x, name, tiled=True)``: the parts of every
        rank along ``name``, by index, concatenated on dim 0."""
        group = self._group(name)
        src = x.contiguous()
        staged = self.host_staged(name, src)
        if staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.axis_size(name))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts)
        return out.to(x.device) if staged else out


def init_world(rank: int, world_size: int, init_file,
               backend: str = "gloo") -> None:
    """Join a world of ``world_size`` processes at ``init_file`` (a
    ``file://`` rendezvous: no port to pick); every collective waits at
    most ``PG_TIMEOUT_S``. NCCL binds the world to this process's current
    card (``torch.cuda.set_device`` it first)."""
    device_id = torch.device("cuda", torch.cuda.current_device()) \
        if backend == "nccl" else None
    dist.init_process_group(
        backend, init_method=f"file://{Path(init_file).resolve()}",
        world_size=world_size, rank=rank, device_id=device_id,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def make_mesh(shape: dict) -> Mesh:
    """A ``Mesh`` over the current world (its size must be the product of
    ``shape``'s sizes) with a process group per line of every axis. Every
    rank must call it, with the same ``shape``, in the same order as
    every other collective."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized world: "
                           "init_world first")
    mesh = Mesh(shape, dist.get_rank())
    if mesh.size != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size} ranks over a world of "
                         f"{dist.get_world_size()}")
    groups = {}
    for name in mesh.axis_names:
        for r in range(mesh.size):
            line = Mesh(shape, r).axis_ranks(name)
            if line[0] != r:         # each line once, from its first rank
                continue
            g = dist.new_group(line)
            if mesh.rank in line:
                groups[name] = g
    backend = dist.get_backend()
    device = torch.device("cuda", torch.cuda.current_device()) \
        if backend == "nccl" else torch.device("cpu")
    return Mesh(shape, mesh.rank, groups, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> Mesh:
    """``launch/mesh.py::make_debug_mesh``: a ``("data", "model")`` mesh
    over the current world."""
    return make_mesh({"data": n_data, "model": n_model})


def _rank_main(fn, rank, world_size, init_file, backend, args, out_dir):
    out = Path(out_dir)
    try:
        init_world(rank, world_size, init_file, backend)
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        tmp = out / f"rank{rank}.pkl.tmp"
        tmp.write_bytes(pickle.dumps(result))
        os.replace(tmp, out / f"rank{rank}.pkl")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_world(fn, world_size: int, work_dir, *, backend: str = "gloo",
                args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes (``spawn``) joined into one world at a ``file://``
    rendezvous in ``work_dir``; returns each rank's result, by rank.
    ``fn`` must be importable at module level and return what pickles
    (numpy and plain Python: never a CUDA tensor). Raises, after killing
    every rank still running, when a rank fails (with its traceback) or
    when the world has not finished in ``timeout_s``."""
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    init_file = work / "rendezvous"
    if init_file.exists():
        init_file.unlink()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                         args=(fn, r, world_size, str(init_file), backend,
                               tuple(args), str(work)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                # the failure's peers usually fail with it: give them a
                # moment, so that every rank's error is reported
                for p in procs:
                    p.join(timeout=2)
                raise RuntimeError(_world_failure(work, procs))
            if time.monotonic() > deadline:
                raise TimeoutError(f"the world of {world_size} ranks did "
                                   f"not finish in {timeout_s}s")
            time.sleep(0.05)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(_world_failure(work, procs))
        return [pickle.loads((work / f"rank{r}.pkl").read_bytes())
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def _world_failure(work: Path, procs) -> str:
    msgs = []
    for r, p in enumerate(procs):
        if p.exitcode in (None, 0):
            continue
        err = work / f"rank{r}.err"
        why = err.read_text()[-3000:] if err.exists() else "(no traceback)"
        msgs.append(f"rank {r} exited {p.exitcode}: {why}")
    return "; ".join(msgs)
