"""Multi-process fleet plumbing: a replica in its own OS process.

``replica_main`` runs a ``ReplicaSyncer`` in a child process over real
``FSDirectory`` paths and serves a tiny command loop on a multiprocessing
``Pipe``; ``RemoteReplica`` is the parent-side proxy that speaks the same
duck-typed replica protocol as an in-process syncer (``collection_stats``
/ ``install_stats`` / ``query_max_ub`` / ``search_batched`` / ``epoch``
/ ``healthy``), so a ``FleetSearcher`` serves a mix of local and remote
replicas without knowing which is which.

The writer process owns the write medium and never serves; each searcher
process owns its own directory and never writes anything but replicated
bytes. The only channel between them is the filesystem the manifests
ship over — the command pipe carries queries and control, never index
data. Everything on the pipe is numpy or plain Python: never a tensor
(a CUDA tensor would travel by CUDA IPC, bound to the sender's life).

Each child takes its own ``device``: on the card it opens its own CUDA
context and loads the kernels the parent built (build them before the
children start: ``kernels/_build.py`` writes through a per-process temp
file, but concurrent first builds would each run ``nvcc``); in the tests
``"cpu"``. The child's ``report()`` carries its kernel launch counts.

Every call waits a bounded time (``timeout_s``): a child that does not
answer, or is gone, raises ``RemoteReplicaError`` and is killed, never
waited on forever. A command that raised in the child raises
``RemoteReplicaError`` in the parent with the child's exception.

``epoch``/``healthy``/``missing_docs`` are cached parent-side and
re-read after every state-changing call (sync/quarantine/repair), so the
fleet's hot routing path costs no IPC beyond the search itself.

The port's counterpart of the JAX package's ``replication/server.py``.
"""
from __future__ import annotations

import multiprocessing as mp

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build


def _state(syncer) -> dict:
    return {"epoch": syncer.epoch, "healthy": syncer.healthy,
            "missing_docs": syncer.missing_docs, "gen": syncer.gen}


def _serve(syncer, cmd: str, payload):
    """One command on ``syncer``; the reply payload (numpy or plain
    Python)."""
    if cmd == "sync":
        return syncer.sync_once(), _state(syncer)
    if cmd == "stats":
        return syncer.collection_stats()
    if cmd == "install_stats":
        return syncer.install_stats(payload)
    if cmd == "ub":
        return np.asarray(syncer.query_max_ub(payload))
    if cmd == "search":
        q, k, theta0 = payload
        v, i = syncer.search_batched(q, k, theta0=theta0)
        return v.cpu().numpy(), i.cpu().numpy()
    if cmd == "quarantine":
        return syncer.quarantine(payload), _state(syncer)
    if cmd == "repair":
        return syncer.repair(payload), _state(syncer)
    if cmd == "anti_entropy":
        return syncer.anti_entropy(), _state(syncer)
    if cmd == "report":
        return {**syncer.report(), "launches": dict(_build.LAUNCHES)}
    if cmd == "state":
        return _state(syncer)
    raise ValueError(f"unknown command {cmd!r}")


def replica_main(conn, replica_id: str, local_path: str, source_path: str,
                 peer_paths=(), device=None) -> None:
    """Child-process entry: serve one replica on ``device`` (None: CUDA,
    raising without one; or ``"cpu"``) until ``stop``. A command's error
    is sent back as an ``"err"`` reply, which ``RemoteReplica._call``
    raises in the parent."""
    torch.set_num_threads(1)
    from repro_torch.replication.syncer import ReplicaSyncer
    from repro_torch.storage.directory import FSDirectory
    syncer = ReplicaSyncer(
        FSDirectory(local_path), FSDirectory(source_path),
        peers=[FSDirectory(p) for p in peer_paths],
        replica_id=replica_id, device=device)
    while True:
        try:
            cmd, payload = conn.recv()
        except (EOFError, OSError):
            return
        if cmd == "stop":
            conn.send(("ok", None))
            return
        try:
            reply = ("ok", _serve(syncer, cmd, payload))
        except Exception as e:
            reply = ("err", f"{type(e).__name__}: {e}")
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            return


class RemoteReplicaError(RuntimeError):
    """A remote replica's command raised, did not answer in time, or its
    process is gone; the message carries the child's exception."""


class RemoteReplica:
    """Parent-side proxy over one searcher process (see module doc).
    ``device`` None is CUDA (raises without one) or ``"cpu"``; the child
    serves on the same device."""

    def __init__(self, replica_id: str, local_path: str, source_path: str,
                 peer_paths=(), device=None, timeout_s: float = 600.0):
        self.replica_id = replica_id
        self.device = resolve_device(device)
        self.timeout_s = float(timeout_s)
        self._args = (replica_id, str(local_path), str(source_path),
                      [str(p) for p in peer_paths], str(self.device))
        self._ctx = mp.get_context("spawn")
        self._proc = None
        self._conn = None
        self._state = {"epoch": 0, "healthy": True,
                       "missing_docs": 0, "gen": 0}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "RemoteReplica":
        parent, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=replica_main, args=(child,) + self._args,
            name=f"replica-{self.replica_id}", daemon=True)
        self._proc.start()
        child.close()
        self._conn = parent
        return self

    def close(self) -> None:
        """Ask the child to stop, then join it; one that does not stop in
        time is terminated, then killed."""
        if self._conn is not None:
            try:
                self._conn.send(("stop", None))
                if self._conn.poll(min(self.timeout_s, 30.0)):
                    self._conn.recv()
            except (BrokenPipeError, EOFError, OSError):
                pass
            self._conn.close()
            self._conn = None
        if self._proc is not None:
            self._proc.join(timeout=30)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=10)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=10)
            self._proc = None

    def _lost(self, cmd: str, why: str) -> RemoteReplicaError:
        """Kill the child (its pipe may hold a late reply) and describe
        what was lost."""
        code = None
        if self._proc is not None:
            self._proc.kill()
            self._proc.join(timeout=10)
            code = self._proc.exitcode
            self._proc = None
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        return RemoteReplicaError(f"{self.replica_id}: {cmd}: {why} "
                                  f"(exit code {code})")

    def _call(self, cmd: str, payload=None):
        if self._conn is None:
            raise RemoteReplicaError(f"{self.replica_id}: {cmd}: the replica "
                                     f"process is not running")
        try:
            self._conn.send((cmd, payload))
            if not self._conn.poll(self.timeout_s):
                raise self._lost(cmd, f"no reply in {self.timeout_s}s")
            status, out = self._conn.recv()
        except (BrokenPipeError, EOFError, ConnectionResetError) as e:
            raise self._lost(cmd, "the replica process is gone") from e
        if status != "ok":
            raise RemoteReplicaError(f"{self.replica_id}: {cmd}: {out}")
        return out

    # -- replica protocol (cached routing state, RPC serving) ---------------
    @property
    def epoch(self) -> int:
        return self._state["epoch"]

    @property
    def healthy(self) -> bool:
        return self._state["healthy"]

    @property
    def missing_docs(self) -> int:
        return self._state["missing_docs"]

    @property
    def gen(self) -> int:
        return self._state["gen"]

    def sync_once(self):
        out, self._state = self._call("sync")
        return out

    def collection_stats(self):
        return self._call("stats")

    def install_stats(self, stats) -> None:
        self._call("install_stats", stats)

    def query_max_ub(self, q2d):
        return self._call("ub", np.asarray(q2d))

    def search_batched(self, q_batch, k: int = 10, theta0=None):
        t = None if theta0 is None else np.asarray(theta0)
        v, i = self._call("search", (np.asarray(q_batch), int(k), t))
        return torch.from_numpy(v), torch.from_numpy(i)

    def quarantine(self, file_name: str):
        out, self._state = self._call("quarantine", file_name)
        return out

    def repair(self, base: str):
        out, self._state = self._call("repair", base)
        return out

    def anti_entropy(self):
        out, self._state = self._call("anti_entropy")
        return out

    def refresh_state(self) -> dict:
        self._state = self._call("state")
        return dict(self._state)

    def report(self) -> dict:
        """The child syncer's report, with ``launches``: the kernel
        launches its process made (zero on the CPU)."""
        return self._call("report")
