"""A mesh of shards stepped by one thread each, and its collectives.

The JAX package steps the local model under ``shard_map`` and meets its
neighbours at three collectives: ``ppermute`` in the halo fills,
``all_to_all`` in the pencil Poisson solve and ``psum`` in CG. The port
keeps the local model's code for one shard and runs it once per shard,
each in a thread of its own (``Mesh.run``), the shards' tensors on the
mesh's devices. The shards take turns: a shard runs until its next
collective, then hands the turn to the next shard (in rank order); a
collective is a round of turns in which every shard posts what it sends,
then a round in which every shard takes what it receives, so no shard
changes what it posted before every other has read it. One shard's
thread runs at a time, so the threads, which share the GIL anyway, do
not hand it over at every torch op; on one card each shard's launches
reach the stream in turn, and a neighbour's strip is written before the
copy that reads it; on several cards the copies go from card to card,
ordered by PyTorch.

Every collective is called by every shard in the same order, as the
shards run the same code. A failure in any thread wakes the others,
which raise instead of waiting, and ``Mesh.run`` raises the first
failure in the caller; a wait for the turn also gives up after
``timeout`` seconds. Sums add the shards' partials in shard order
(row-major over the mesh), the same on every run and every shard.
"""
from __future__ import annotations

import threading

import torch

AXES = ("x", "y")

_local = threading.local()


class CollectiveAborted(RuntimeError):
    """A collective given up: another shard failed, or the wait for the
    turn outlasted the mesh's timeout."""


class Mesh:
    """An (Rx, Ry) mesh of shards over ``devices`` (row-major: shard
    (i, j) has rank i·Ry + j). One device may carry several shards."""

    def __init__(self, shape, devices, timeout=600.0):
        self.shape = tuple(int(n) for n in shape)
        if len(self.shape) != 2 or min(self.shape) < 1:
            raise ValueError(f"a mesh is (Rx, Ry) with Rx, Ry >= 1: {shape}")
        self.size = self.shape[0] * self.shape[1]
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.size:
            raise ValueError(f"a {self.shape} mesh takes {self.size} devices, "
                             f"got {len(self.devices)}")
        self.timeout = float(timeout)
        #: one event a shard, set when it has the turn; the turns each
        #: shard has handed on, and the count of a shard that has ended
        self._turns = [threading.Event() for _ in range(self.size)]
        self._aborted = False
        self._passes = [0] * self.size
        self._ended = [None] * self.size
        self._slots = [None] * self.size
        #: collectives met, copies made and bytes moved since the last
        #: reset, by kind ("exchange", "all_to_all", "sum"): a collective
        #: counted once, its copies and bytes summed over the shards
        self.counts, self.copies, self.bytes = {}, {}, {}

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={self.devices})"

    # -- ranks ------------------------------------------------------------------
    def coords(self, rank):
        return divmod(rank, self.shape[1])

    def rank_of(self, i, j):
        return i * self.shape[1] + j

    def group(self, rank, mesh_axis):
        """The ranks along ``mesh_axis`` ("x" or "y") through ``rank``, in
        coordinate order."""
        i, j = self.coords(rank)
        if mesh_axis == "x":
            return [self.rank_of(k, j) for k in range(self.shape[0])]
        return [self.rank_of(i, k) for k in range(self.shape[1])]

    # -- running ----------------------------------------------------------------
    def run(self, fn):
        """``fn(rank)`` on every shard, each in a thread of its own with the
        shard's device current; returns the results in rank order. Raises
        the first exception of any shard, after every thread has ended."""
        results = [None] * self.size
        errors = [None] * self.size

        def body(rank):
            _local.mesh, _local.rank = self, rank
            try:
                self._wait_turn(rank)
                dev = self.devices[rank]
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        results[rank] = fn(rank)
                else:
                    results[rank] = fn(rank)
                self._ended[rank] = self._passes[rank]
                self._turns[(rank + 1) % self.size].set()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[rank] = e
                self._aborted = True
                for turn in self._turns:
                    turn.set()
            finally:
                _local.mesh = _local.rank = None

        self._aborted = False
        self._passes = [0] * self.size
        self._ended = [None] * self.size
        for turn in self._turns:
            turn.clear()
        self._turns[0].set()

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"shard-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [None] * self.size
        # the first failure that is not an aborted collective (its cause)
        first = next((e for e in errors
                      if e is not None and not isinstance(e, CollectiveAborted)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return results

    def reset_counts(self):
        self.counts, self.copies, self.bytes = {}, {}, {}

    # -- collectives ---------------------------------------------------------------
    def _wait_turn(self, rank):
        if not self._turns[rank].wait(self.timeout) or self._aborted:
            raise CollectiveAborted("a shard of the mesh failed or a collective "
                                    f"waited longer than {self.timeout} s")

    def _pass(self, rank):
        """Hand the turn to the next shard and wait until it comes back:
        every other shard has then run to the same point. A shard that
        ended before this point called one collective fewer: raise."""
        self._passes[rank] += 1
        self._turns[rank].clear()
        if self._aborted:  # set before the clear: do not wait for it
            raise CollectiveAborted("a shard of the mesh failed")
        self._turns[(rank + 1) % self.size].set()
        self._wait_turn(rank)
        if any(n is not None and n < self._passes[rank] for n in self._ended):
            self._aborted = True
            for turn in self._turns:
                turn.set()
            raise CollectiveAborted("a shard ended while another waited in a "
                                    "collective: the shards called different "
                                    "collectives")

    def collective(self, rank, value, take, kind, nbytes=0, copies=0):
        """Post ``value``, then ``take(posted)`` with every shard's posted
        value in rank order; returns what ``take`` returns. ``nbytes`` and
        ``copies``: what this shard reads from the others and the copies it
        makes, added to ``self.bytes[kind]`` and ``self.copies[kind]``."""
        self._slots[rank] = value
        if rank == 0:
            self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.copies[kind] = self.copies.get(kind, 0) + int(copies)
        self._pass(rank)
        out = take(list(self._slots))
        self._pass(rank)
        return out


def current():
    """(mesh, rank) of the calling shard's thread; raises outside
    ``Mesh.run``."""
    mesh = getattr(_local, "mesh", None)
    if mesh is None:
        raise RuntimeError("a FULLY_CONNECTED axis is filled or solved only in "
                           "a shard's thread (DistributedModel.step)")
    return mesh, _local.rank


def axis_index(mesh_axis):
    """This shard's coordinate along ``mesh_axis`` (``lax.axis_index``)."""
    mesh, rank = current()
    return mesh.coords(rank)[AXES.index(mesh_axis)]


def _nbytes(t):
    return t.numel() * t.element_size()


def psum(x, axis_names):
    """The sum of a 0-d tensor over the shards along ``axis_names`` (a
    subset of ("x", "y")), added in shard order: the same value, bit for
    bit, on every shard of a group."""
    axis_names = tuple(a for a in axis_names if a is not None)
    if not axis_names:
        return x
    mesh, rank = current()
    members = sorted({r for r in range(mesh.size)
                      if all(mesh.coords(r)[AXES.index(a)] == mesh.coords(rank)[AXES.index(a)]
                             for a in AXES if a not in axis_names)})

    def take(posted):
        total = posted[members[0]].to(x.device)
        for r in members[1:]:
            total = total + posted[r].to(x.device)
        return total

    return mesh.collective(rank, x, take, "sum", _nbytes(x) * (len(members) - 1),
                           len(members) - 1)


def all_to_all(x, mesh_axis, split_axis, concat_axis):
    """``lax.all_to_all(x, mesh_axis, split_axis, concat_axis,
    tiled=True)``: chunk k of ``split_axis`` goes to the k-th shard along
    ``mesh_axis``, and the received chunks are concatenated along
    ``concat_axis`` in the senders' order."""
    mesh, rank = current()
    members = mesh.group(rank, mesh_axis)
    n = len(members)
    if n == 1:
        return x
    size = x.shape[split_axis]
    if size % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size {size} does "
                         f"not split over {n} shards")
    k = members.index(rank)
    chunk = size // n

    def take(posted):
        parts = [posted[r].narrow(split_axis, k * chunk, chunk).to(x.device)
                 for r in members]
        return torch.cat(parts, dim=concat_axis)

    # every chunk is copied into the concatenation (the shard's own too)
    return mesh.collective(rank, x, take, "all_to_all", _nbytes(x), n)
