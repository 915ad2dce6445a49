"""The shard programs of the sharded tick, and the traffic between them.

The reference runs its sharded tick as one XLA program and lets the SPMD
partitioner insert the collectives: a few all-reduces for the market
context, and the BTC row's values. The port runs one program per shard
(:func:`run_shards`): each on a thread of its own, under its shard's device
(``torch.cuda.device``, so a kernel wrapper launches on the card that holds
the shard's rows), on its own rows only. Every point where the tick reads
across rows goes through the :class:`ShardComm` its program is given, and
these are the only cross-shard traffic:

* :meth:`ShardComm.gather_rows`: per-shard ``(rows_k, ...)`` pieces to one
  ``(S, ...)`` in row order, on shard 0 (the market context's feature
  columns, the calibration rows);
* :meth:`ShardComm.finalize`: such a gather, one function of it on shard 0,
  and its result broadcast to every shard (the market scalars, computed once
  by the unsharded code, so every shard gets the same bits);
* :meth:`ShardComm.from_owner`: the BTC row's shard computes a value (a
  ``(W,)`` row or a few scalars) and every shard receives it;
* :meth:`ShardComm.reduce_blocks`, :meth:`ShardComm.select_rows` and
  :meth:`ShardComm.count_sum`: per-shard blocks reduced to one on shard 0
  (the digests' counts, the fired slots' values, a count).

Every collective is counted in :data:`TRAFFIC`, per kind: the bytes that
cross between shards (those between shards that share a device included:
the count is what a mesh of separate cards would move) and its result's
size, the largest of which is the figure the reference audits in its
compiled HLO (no collective's result may reach 1/16 of a buffer leaf, so
no ``(S, W)`` field crosses; a gather's result is the whole gathered
array).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from binquant_tpu_torch.parallel.mesh import Mesh, shard_bounds, shard_of_row, tree_leaves, tree_map

# a shard program that waits longer than this at a collective gives up
# (another program died without reaching it)
BARRIER_TIMEOUT_S = 600.0

_local = threading.local()


def current_shard() -> int | None:
    """The shard whose program runs on this thread (None outside one)."""
    return getattr(_local, "shard", None)


class Traffic:
    """Cross-shard traffic per collective kind: the collectives, the bytes
    they moved between shards, and the largest result (one collective's
    output: a gathered array, a reduced block, a broadcast payload)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.by_kind: dict[str, dict[str, int]] = {}

    def note(self, kind: str, moved: int, result: int) -> None:
        with self._lock:
            k = self.by_kind.setdefault(kind, {"collectives": 0, "bytes": 0, "largest": 0})
            k["collectives"] += 1
            k["bytes"] += int(moved)
            k["largest"] = max(k["largest"], int(result))

    def snapshot(self) -> dict:
        """``{"bytes", "collectives", "largest", "by_kind": {...}}``."""
        with self._lock:
            kinds = {k: dict(v) for k, v in self.by_kind.items()}
        return {
            "bytes": sum(v["bytes"] for v in kinds.values()),
            "collectives": sum(v["collectives"] for v in kinds.values()),
            "largest": max((v["largest"] for v in kinds.values()), default=0),
            "by_kind": kinds,
        }


TRAFFIC = Traffic()


def traffic_limit(capacity: int, window: int, num_fields: int) -> int:
    """The reference's audit limit: 1/16 of one ``(S, W, F)`` float32 ring
    leaf, under any ``(S, W)`` field (a tenth of the leaf)."""
    return capacity * window * num_fields * 4 // 16


def check_traffic(snapshot: dict, limit: int) -> None:
    """Raise when a collective's result in ``snapshot`` reaches ``limit``:
    a buffer-scale field crossed shards."""
    if snapshot["largest"] >= limit:
        worst = max(snapshot["by_kind"].items(), key=lambda kv: kv[1]["largest"])
        raise AssertionError(
            f"a cross-shard collective of {snapshot['largest']} bytes (kind {worst[0]!r}) "
            f"reaches the limit {limit}: buffer-scale data crossed the mesh"
        )


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class _Group:
    """The meeting point of one call's shard programs. The programs take
    turns: one runs at a time, from one collective to the next, then hands
    the turn on (rank order, round after round). The tick's host work is a
    long run of small calls, and programs running at once would only fight
    over the interpreter lock; in turns the host issues each shard's work
    back to back, in the same order every call."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.cond = threading.Condition()
        self.turn = 0
        self.rounds: list[list] = []
        self.broken = False

    def wait_turn(self, rank: int) -> None:
        with self.cond:
            while self.turn != rank and not self.broken:
                if not self.cond.wait(timeout=BARRIER_TIMEOUT_S):
                    self.broken = True
                    self.cond.notify_all()
            if self.broken:
                raise threading.BrokenBarrierError

    def hand_on(self, rank: int) -> None:
        with self.cond:
            self.turn = (rank + 1) % self.n
            self.cond.notify_all()

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()

    def exchange(self, rank: int, round_: int, value) -> list:
        """Deposit ``value`` for collective ``round_`` and wait for this
        program's next turn, when every program has deposited its own."""
        with self.cond:
            if len(self.rounds) <= round_:
                self.rounds.append([None] * self.n)
            self.rounds[round_][rank] = value
        self.hand_on(rank)
        self.wait_turn(rank)
        return self.rounds[round_]


# position-wise combination of per-shard digest blocks
SUM, MIN, MAX, FIRST = "sum", "min", "max", "first"


def combine_blocks(blocks: torch.Tensor, ops: tuple[str, ...]) -> torch.Tensor:
    """``(n, L)`` per-shard blocks to one ``(L,)``: counts summed (exact for
    integer counts below 2**24), extremes min/maxed with NaN as "no data"
    (``fmin``/``fmax``: NaN only where every shard has none), replicated
    entries from shard 0."""
    out = blocks[0].clone()
    for op, fold in ((SUM, None), (MIN, torch.fmin), (MAX, torch.fmax)):
        idx = [i for i, o in enumerate(ops) if o == op]
        if not idx:
            continue
        cols = blocks[:, idx]
        if fold is None:
            acc = cols.sum(dim=0)
        else:
            acc = cols[0]
            for k in range(1, cols.shape[0]):
                acc = fold(acc, cols[k])
        out[idx] = acc
    return out


class ShardComm:
    """One shard program's view of its call: its rank, rows ``[lo, hi)`` of
    ``capacity``, device, and the collectives (every program of the call
    reaches each collective in the same order)."""

    def __init__(self, group: _Group, rank: int, mesh: Mesh, capacity: int, btc_row: int):
        self._group = group
        self._round = 0
        self.rank = rank
        self.n = mesh.size
        self.device = mesh.devices[rank]
        self.capacity = int(capacity)
        self.lo, self.hi = shard_bounds(self.capacity, self.n)[rank]
        safe = min(max(int(btc_row), 0), self.capacity - 1)
        # the shard holding the (clamped) BTC row: the row every shard's
        # one-hot extraction would pick
        self.btc_owner = shard_of_row(safe, self.capacity, self.n)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def _exchange(self, value) -> list:
        out = self._group.exchange(self.rank, self._round, value)
        self._round += 1
        return out

    def _to_here(self, tree):
        return tree_map(lambda x: x.to(self.device), tree)

    def _collect(self, tree) -> list | None:
        """Every shard's ``tree`` on shard 0's device in rank order (None
        on the other shards); the caller counts the traffic."""
        trees = self._exchange(tree)
        if not self.is_root:
            return None
        return [tree] + [self._to_here(t) for t in trees[1:]]

    def gather(self, tree, kind: str = "gather") -> list | None:
        """Every shard's ``tree`` on shard 0, in rank order (None on the
        other shards)."""
        parts = self._collect(tree)
        if parts is not None:
            sizes = [_nbytes(p) for p in parts]
            TRAFFIC.note(kind, sum(sizes[1:]), sum(sizes))
        return parts

    def gather_rows(self, tree, kind: str = "gather_rows"):
        """Per-shard ``(rows_k, ...)`` leaves concatenated in row order on
        shard 0 (None on the other shards)."""
        parts = self.gather(tree, kind)
        if parts is None:
            return None
        return tree_map(lambda *ps: torch.cat(ps, dim=0), *parts)

    def broadcast(self, tree, src: int = 0, kind: str = "broadcast"):
        """Shard ``src``'s ``tree`` on every shard's device."""
        trees = self._exchange(tree if self.rank == src else None)
        if self.rank == src:
            size = _nbytes(tree)
            TRAFFIC.note(kind, (self.n - 1) * size, size)
            return tree
        return self._to_here(trees[src])

    def finalize(self, fn, tree, kind: str = "finalize"):
        """``fn`` of the row-ordered gather of ``tree``, computed once on
        shard 0 and handed to every shard."""
        full = self.gather_rows(tree, kind)
        return self.broadcast(fn(full) if self.is_root else None, 0, kind)

    def from_owner(self, fn, kind: str = "btc_row"):
        """``fn()`` computed by the shard owning the BTC row, on every
        shard."""
        return self.broadcast(fn() if self.rank == self.btc_owner else None, self.btc_owner, kind)

    def _reduced(self, tree, kind: str) -> list | None:
        parts = self._collect(tree)
        if parts is not None:
            size = _nbytes(tree)
            TRAFFIC.note(kind, (self.n - 1) * size, size)
        return parts

    def reduce_blocks(self, block: torch.Tensor, ops: tuple[str, ...], kind: str = "reduce"):
        """Per-shard flat blocks combined by :func:`combine_blocks` on
        shard 0 (None on the other shards)."""
        parts = self._reduced(block, kind)
        if parts is None:
            return None
        return combine_blocks(torch.stack(parts), ops)

    def select_rows(self, values: torch.Tensor, own: torch.Tensor, kind: str = "select"):
        """Per-shard ``(K, ...)`` values, each row taken on shard 0 from
        the shard whose ``own`` marks it (zeros where none does)."""
        parts = self._reduced((values, own), kind)
        if parts is None:
            return None
        out = torch.zeros_like(values)
        for vals, mine in parts:
            out = torch.where(mine.reshape(-1, *([1] * (vals.dim() - 1))), vals, out)
        return out

    def count_sum(self, x: torch.Tensor, kind: str = "reduce") -> torch.Tensor:
        """An integer count summed over every shard, on every shard."""
        parts = self._reduced(x, kind)
        total = None if parts is None else torch.stack(parts).sum(dim=0)
        return self.broadcast(total, 0, kind)


def _device_scope(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_shards(mesh: Mesh, fn, per_shard_args, capacity: int, btc_row: int = -1) -> list:
    """Run ``fn(comm, *per_shard_args[k])`` once per shard, each on a thread
    of its own (shard 0 on the calling one), in turns (:class:`_Group`),
    under its shard's device and the caller's grad mode and intra-op thread
    count; returns the results in shard order. A program that raises
    breaks every other program's next collective, and the first error is
    raised here."""
    n = mesh.size
    group = _Group(n)
    results: list = [None] * n
    errors: list = [None] * n
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    # the intra-op thread count is per thread: a new thread would start
    # its own full pool beside every other shard's
    threads_per_op = torch.get_num_threads()

    def body(k: int) -> None:
        _local.shard = k
        if k:
            torch.set_num_threads(threads_per_op)
        try:
            group.wait_turn(k)
            with _device_scope(mesh.devices[k]), torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad):
                comm = ShardComm(group, k, mesh, capacity, btc_row)
                results[k] = fn(comm, *per_shard_args[k])
            group.hand_on(k)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the caller
            errors[k] = exc
            group.abort()
        finally:
            _local.shard = None

    threads = [threading.Thread(target=body, args=(k,), daemon=True) for k in range(1, n)]
    for t in threads:
        t.start()
    body(0)
    for t in threads:
        t.join()
    real = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    for e in errors:
        if e is not None:
            raise e
    return results
