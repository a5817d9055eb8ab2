"""Process meshes for sharded proving on `torch.distributed`.

Counterpart of `starks_tpu/parallel/mesh.py`. The JAX package lays a
("batch", "shard") grid over its devices; here the grid is over the
ranks of an initialized process group, one rank per device. The
"shard" axis partitions the evaluation domain (contiguous rows of
every domain array and Merkle leaf range); the "batch" axis takes
independent claims (`parallel.batch.prove_batch`). Each row of the grid
is its own subgroup, so the collectives of one claim's proof stay in
its row.

The transport follows the process group's backend. NCCL takes CUDA
tensors directly; it needs a card per rank. gloo, used when ranks share
a card (NCCL refuses two ranks on one device) or run on the CPU, takes
host tensors: on the card the mesh copies each collective's operand
through pinned host memory and its result back. The kernels run on the
rank's device either way; nothing falls back to the CPU.

Every collective counts its calls, the bytes of this rank's operand
that other ranks receive (rows a rank addresses to itself stay local
and are not counted) and its host seconds per name (`Mesh.counts`,
`.bytes`, `.seconds`); with
`Mesh.timed` set, each call first and last waits for the device, so
the seconds are the collective's own.
"""

import os
import time

import torch
import torch.distributed as dist

COLLECTIVES = ("all_to_all_single", "all_gather", "all_reduce", "halo")


class Mesh:
    """This rank's place in a [n_batch, n_shard] grid of ranks: its
    device, its shard row's process group, and the collectives the
    sharded prover runs over that row."""

    def __init__(self, group, n_batch: int, n_shard: int, batch_index: int,
                 shard_index: int, device: torch.device, backend: str):
        self.group = group
        self.n_batch, self.n_shard = n_batch, n_shard
        self.batch_index, self.shard_index = batch_index, shard_index
        self.device = device
        self.backend = backend
        self.staged = backend != "nccl" and device.type == "cuda"
        self.transport = backend + (" through pinned host memory"
                                    if self.staged else "")
        self.timed = False
        self.cache = {}          # per-mesh plans and set-ups
        self.reset_counts()

    def __repr__(self):
        return (f"Mesh({self.n_batch}x{self.n_shard}, batch "
                f"{self.batch_index}, shard {self.shard_index}, "
                f"{self.device}, {self.transport})")

    def reset_counts(self):
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.seconds = dict.fromkeys(COLLECTIVES, 0.0)

    def _sync(self):
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _host(self, t):
        """The operand as the transport takes it."""
        t = t.contiguous()
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _back(self, t):
        return t.to(self.device, non_blocking=True) if self.staged else t

    def _count(self, name, sent, t0):
        self._sync()
        self.counts[name] += 1
        self.bytes[name] += sent
        self.seconds[name] += time.perf_counter() - t0

    def _empty(self, shape, dtype):
        return torch.empty(shape, dtype=dtype,
                           device="cpu" if self.staged else self.device)

    def all_to_all_single(self, x, in_splits=None, out_splits=None,
                          name="all_to_all_single"):
        """Rows of x (split along dim 0, `in_splits` rows to each shard
        in order, equal parts when None) go to the shards; returns the
        rows received, in shard order (`out_splits` from each)."""
        self._sync()
        t0 = time.perf_counter()
        rows = x.shape[0]
        if in_splits is None:
            if rows % self.n_shard:
                raise ValueError(f"{rows} rows do not split over "
                                 f"{self.n_shard} shards")
            in_splits = [rows // self.n_shard] * self.n_shard
            out_splits = in_splits if out_splits is None else out_splits
        if sum(in_splits) != rows or out_splits is None:
            raise ValueError("in_splits must cover x, and uneven splits "
                             "need out_splits")
        src = self._host(x)
        out = self._empty((sum(out_splits), *x.shape[1:]), x.dtype)
        dist.all_to_all_single(out, src, list(out_splits), list(in_splits),
                               group=self.group)
        out = self._back(out)
        row = x.element_size() * x[:1].numel()
        self._count(name, row * (rows - in_splits[self.shard_index]), t0)
        return out

    def all_gather(self, x):
        """[n_shard, *x.shape]: every shard's x, in shard order."""
        self._sync()
        t0 = time.perf_counter()
        src = self._host(x).reshape(-1)
        out = self._empty((self.n_shard * x.numel(),), x.dtype)
        dist.all_gather_into_tensor(out, src, group=self.group)
        out = self._back(out).reshape(self.n_shard, *x.shape)
        self._count("all_gather", x.element_size() * x.numel()
                    * (self.n_shard - 1), t0)
        return out

    def all_reduce(self, x):
        """The sum of every shard's x (integer tensors stay exact)."""
        self._sync()
        t0 = time.perf_counter()
        buf = self._host(x)
        if buf is x:
            buf = x.clone()
        dist.all_reduce(buf, group=self.group)
        out = self._back(buf)
        self._count("all_reduce", x.element_size() * x.numel()
                    * (self.n_shard - 1), t0)
        return out

    def halo(self, x, rows: int):
        """The next shard's first `rows` rows of x (cyclically: the last
        shard gets the first shard's); each shard sends its own first
        rows to the one before it."""
        s, r = self.n_shard, self.shard_index
        prev, nxt = (r - 1) % s, (r + 1) % s
        in_splits = [rows if d == prev else 0 for d in range(s)]
        out_splits = [rows if d == nxt else 0 for d in range(s)]
        if s == 1:
            in_splits = out_splits = [rows]
        return self.all_to_all_single(x[:rows], in_splits, out_splits,
                                      name="halo")


def default_device(device=None) -> torch.device:
    """This rank's device: `cuda:(local_rank % device_count)` unless
    `device` names another (e.g. "cpu"); LOCAL_RANK, where the launcher
    sets it, else the global rank."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to shard "
                           "over CPU processes")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_shard: int = None, n_batch: int = 1, group=None,
              device=None) -> Mesh:
    """The [n_batch, n_shard] grid over the ranks of `group` (default:
    the whole initialized process group), in rank order: row b is ranks
    b * n_shard .. (b + 1) * n_shard - 1, each row a subgroup
    (`dist.new_group`, which every rank of `group` must call, so every
    rank calls make_mesh). n_shard defaults to the ranks over n_batch.
    `device` as in `default_device`."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed"
                           " process group")
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    if n_shard is None:
        n_shard = len(ranks) // n_batch
    if n_shard < 1 or n_batch < 1 or n_shard * n_batch != len(ranks):
        raise ValueError(f"a {n_batch}x{n_shard} mesh over {len(ranks)} "
                         f"ranks")
    me = ranks.index(dist.get_rank())
    rows = [ranks[b * n_shard:(b + 1) * n_shard] for b in range(n_batch)]
    if n_batch == 1:
        shard_group = group
    else:
        made = [dist.new_group(row) for row in rows]
        shard_group = made[me // n_shard]
    return Mesh(shard_group, n_batch, n_shard, me // n_shard, me % n_shard,
                default_device(device), dist.get_backend(shard_group))
