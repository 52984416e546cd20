"""The ring of ranks that a row-sharded grid cloth is spread over.

Counterpart of the JAX package's one-axis device mesh
(``softbodyunity_tpu/parallel/halo.py``, axis ``"rows"``): rank r of P holds
rows ``[r * h, (r + 1) * h)`` of a ``[C, ny, nx]`` plane block, h = ny / P,
and the halo paths (:mod:`.halo`) talk to the other ranks through two
collectives only:

- ``exchange_halo(a)``: ``[C, h, nx]`` -> ``[C, h + 2 * HALO, nx]``, the
  block with ``HALO`` rows of each neighbour above and below it
  (``halo.py:36-48``, two ``ppermute``).  The ring is not periodic: the
  first rank's upper halo and the last rank's lower halo are zeros, which
  the halo paths' global-row masks keep out of every spring;
- ``gather_rows(a)``: ``[C, h, nx]`` -> ``[C, ny, nx]``, every rank's block
  in rank order (``halo.py:78``, a tiled ``all_gather``).

Two rings implement them.  :class:`DistRing` is ``torch.distributed`` (NCCL
for CUDA tensors, gloo for CPU ones), one process per rank.
:class:`LocalRing` runs P ranks as P threads of one process, exchanging
through shared slots: the in-process counterpart of the JAX tests' forced
host devices, which runs a P-rank decomposition on one card or on the CPU.
"""

from __future__ import annotations

import threading

import torch

HALO = 2        # rows each side: the bend springs reach two rows
ROWS_AXIS = 1   # the dimension of a [C, rows, nx] block that the ring shards
# how long a LocalRing rank waits for its turn before it gives up: a rank
# that never reaches its collective would otherwise hang the others
TURN_TIMEOUT_S = 600.0


def _with_halos(above: torch.Tensor, a: torch.Tensor,
                below: torch.Tensor) -> torch.Tensor:
    return torch.cat([above, a, below], dim=ROWS_AXIS)


class DistRing:
    """The ranks of a ``torch.distributed`` process group (the default group
    when ``group`` is None), in group-rank order.  The group must be
    initialised first; its backend must take the tensors' device (NCCL for
    CUDA, gloo for the CPU).  Each process is one rank."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def _peer(self, r: int) -> int:
        return (r if self.group is None
                else self._dist.get_global_rank(self.group, r))

    def exchange_halo(self, a: torch.Tensor) -> torch.Tensor:
        dist = self._dist
        above = torch.zeros_like(a[:, :HALO])
        below = torch.zeros_like(a[:, -HALO:])
        ops = []
        # the end ranks post one side, a ring of one posts nothing:
        # batch_isend_irecv refuses an empty list
        if self.rank > 0:
            up = self._peer(self.rank - 1)
            ops += [dist.P2POp(dist.isend, a[:, :HALO].contiguous(), up,
                               self.group),
                    dist.P2POp(dist.irecv, above, up, self.group)]
        if self.rank < self.size - 1:
            down = self._peer(self.rank + 1)
            ops += [dist.P2POp(dist.isend, a[:, -HALO:].contiguous(), down,
                               self.group),
                    dist.P2POp(dist.irecv, below, down, self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return _with_halos(above, a, below)

    def gather_rows(self, a: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(a) for _ in range(self.size)]
        self._dist.all_gather(parts, a.contiguous(), group=self.group)
        return torch.cat(parts, dim=ROWS_AXIS)


class _Aborted(Exception):
    """Raised in the ranks of a :class:`LocalRing` that another rank's
    failure stopped."""


class LocalRing:
    """``size`` ranks as threads of this process, run one at a time.
    :meth:`run` starts one thread per rank; inside it, ``rank`` is that
    thread's rank.  The ranks take turns in rank order: a rank runs until
    its next collective, publishes its tensor in a slot there and hands the
    turn on; when the turn comes back every rank has published, and it
    reads the others' slots.  So the ranks never contend for the
    interpreter (PyTorch releases it in every operation, and P threads
    passing it back and forth ran several times slower than the same work
    on one thread), and the run is P serialised ranks on one device, not a
    parallel one.  CUDA tensors are finished before they are
    published (the device is synchronised at each collective).  The slots
    alternate between two sets, so a rank that runs on to the next
    collective leaves the slots of this one to those still to read them.  A
    rank that raises stops the others at their next turn, and :meth:`run`
    re-raises its error."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a ring has at least one rank, not {size}")
        self.size = size
        self._local = threading.local()
        self._slots = [[None] * size, [None] * size]
        self._go = [threading.Event() for _ in range(size)]
        self._done = [False] * size
        self._failed = False

    @property
    def rank(self) -> int:
        try:
            return self._local.rank
        except AttributeError:
            raise RuntimeError("LocalRing.rank is defined only inside "
                               "LocalRing.run") from None

    def run(self, fn, *args_per_rank):
        """``[fn(*args) for each rank]`` in rank order, each call in its own
        thread as that rank; ``args_per_rank`` are sequences of ``size``
        values, element r going to rank r.  Every rank must make the same
        collectives in the same order."""
        for a in args_per_rank:
            if len(a) != self.size:
                raise ValueError(f"{len(a)} arguments for {self.size} ranks")
        self._done, self._failed = [False] * self.size, False
        for go in self._go:
            go.clear()
        self._go[0].set()
        results = [None] * self.size
        errors = [None] * self.size
        # a new thread starts with the default intra-op thread count (an
        # OpenMP setting of each thread), not the caller's
        n_threads = torch.get_num_threads()

        def body(r):
            torch.set_num_threads(n_threads)
            self._local.rank = r
            self._local.n_collectives = 0
            try:
                self._wait_turn(r)
                results[r] = fn(*(a[r] for a in args_per_rank))
            except BaseException as e:   # noqa: BLE001 (re-raised below)
                errors[r] = e
                self._failed = True
                for go in self._go:      # wake every rank, to stop
                    go.set()
            finally:
                self._done[r] = True
                self._pass_turn(r)

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"LocalRing rank {r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        # the first cause, not a rank that another rank's failure stopped
        for e in failed:
            if not isinstance(e, _Aborted):
                raise e
        if failed:
            raise failed[0]
        return results

    def _pass_turn(self, r: int) -> None:
        """Hand the turn to the next rank after ``r`` still running (only
        the rank holding the turn calls this)."""
        for k in range(1, self.size + 1):
            if not self._done[(r + k) % self.size]:
                self._go[(r + k) % self.size].set()
                return

    def _wait_turn(self, r: int) -> None:
        if not self._go[r].wait(timeout=TURN_TIMEOUT_S):
            raise TimeoutError(f"LocalRing rank {r}: no turn in "
                               f"{TURN_TIMEOUT_S} s")
        self._go[r].clear()
        if self._failed:
            raise _Aborted(f"LocalRing rank {r}: another rank failed")

    def _share(self, t: torch.Tensor) -> list:
        """Every rank's ``t``, in rank order."""
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        r = self.rank
        n = self._local.n_collectives
        self._local.n_collectives = n + 1
        slots = self._slots[n % 2]
        slots[r] = t
        self._pass_turn(r)
        self._wait_turn(r)
        return list(slots)

    def exchange_halo(self, a: torch.Tensor) -> torch.Tensor:
        r = self.rank
        edges = self._share(torch.stack([a[:, :HALO], a[:, -HALO:]]))
        above = (edges[r - 1][1] if r > 0
                 else torch.zeros_like(a[:, :HALO]))
        below = (edges[r + 1][0] if r < self.size - 1
                 else torch.zeros_like(a[:, -HALO:]))
        return _with_halos(above, a, below)

    def gather_rows(self, a: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._share(a), dim=ROWS_AXIS)
