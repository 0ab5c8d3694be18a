"""The device mesh type: an ordered list of devices, one per shard.

It lives below ``ops/`` so that the FMM's staged evaluation
(``ops/fmm.fmm_shard_partials``) runs on it without the ops layer
importing ``parallel/``; ``parallel/mesh.py`` re-exports it beside the
constructors (``make_mesh``, ``shard_bodies``). The collectives keep their
JAX names and act on lists of per-shard tensors, shard r's on
``devices[r]``: :meth:`Mesh.ppermute`, :meth:`Mesh.psum` and
:meth:`Mesh.reduce` (added in shard order 0 to P−1, so the result does not
depend on timing), :meth:`Mesh.pmin` / :meth:`Mesh.pmax`,
:meth:`Mesh.all_gather` and :meth:`Mesh.all_to_all`. Results that shards on one
device share are one tensor object, so work replicated in the JAX program
(:meth:`Mesh.per_device`) runs once per distinct device, not once per
shard. A tensor whose device type is not the mesh's raises.

:meth:`Mesh.census` counts the collectives a block of code calls on the
mesh, the counterpart of the JAX package's census of the collectives XLA
compiled (``tools/multichip_scaling.py``). It is off unless the context
manager is open; off, each collective pays one branch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch


def _leaves(x) -> list:
    """The tensors of ``x``: a tensor, or a tuple or list of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _leaves(v)]


def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return type(x)(_zeros_like(v) for v in x)


def _move(x, device: torch.device):
    """``x`` on ``device``: a tensor, or a dataclass, tuple or list of them
    (a tree); other values as they are. Already there: the same object."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _move(getattr(x, f.name), device)
            for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_move(v, device) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered 1-D mesh: shard r runs on ``devices[r]``."""

    devices: Tuple[torch.device, ...]
    # The open census's record (:meth:`census`), None when it is off; set
    # through object.__setattr__, as the mesh is otherwise immutable.
    census_record: Optional[dict] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's devices must all be cpu or all cuda, "
                             f"got {[str(d) for d in self.devices]}")

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    @contextlib.contextmanager
    def census(self):
        """Count the collectives called on this mesh while the block runs.

        Yields ``{op: {"count": calls, "out_bytes": bytes}}``, filled as the
        block runs: ``op`` is the method's name (``ppermute``, ``rotate``,
        ``reduce``, ``psum``, ``pmin``, ``pmax``, ``all_gather``,
        ``all_to_all``); ``out_bytes`` sums each call's output over the
        shards, as the JAX census sums each device's output shapes. One
        call that carries a tuple a shard (the ring's positions and masses)
        counts once, as XLA's combined collective does. Nested censuses:
        the inner one records, the outer resumes after it.
        """
        outer = self.census_record
        record: dict = {}
        object.__setattr__(self, "census_record", record)
        try:
            yield record
        finally:
            object.__setattr__(self, "census_record", outer)

    def _count(self, op: str, outs) -> None:
        row = self.census_record.setdefault(op, {"count": 0, "out_bytes": 0})
        row["count"] += 1
        row["out_bytes"] += sum(t.numel() * t.element_size()
                                for t in _leaves(outs))

    def check(self, *tensors) -> None:
        """Raise unless every tensor's device type is the mesh's (tuples
        and lists of tensors are looked into)."""
        for t in _leaves(tensors):
            if t.device.type != self.device_type:
                raise ValueError(
                    f"a tensor on {t.device} given to a mesh of "
                    f"{self.device_type} devices; move it there first")

    def device_context(self, shard_index: int):
        """The context a shard's launches run in: its card current."""
        d = self.devices[shard_index]
        return torch.cuda.device(d) if d.type == "cuda" \
            else contextlib.nullcontext()

    def per_device(self, fn: Callable[[int], object]) -> list:
        """``fn(r)`` at the first shard r of each distinct device, with its
        card current, as a per-shard list: the shards of one device share
        the result object."""
        done, out = {}, []
        for r, d in enumerate(self.devices):
            if d not in done:
                with self.device_context(r):
                    done[d] = fn(r)
            out.append(done[d])
        return out

    def per_shard(self, fn: Callable[[int], object]) -> list:
        """``fn(r)`` for every shard r in order, with its card current."""
        out = []
        for r in range(self.num_shards):
            with self.device_context(r):
                out.append(fn(r))
        return out

    def replicate(self, x) -> list:
        """``x`` (a tensor or a tree of them) on every shard: one copy per
        distinct device, shared by that device's shards."""
        return self.per_device(lambda r: _move(x, self.devices[r]))

    def _permute(self, xs, perm) -> list:
        self.check(*xs)
        out: list = [None] * self.num_shards
        for src, dst in perm:
            out[dst] = _move(xs[src], self.devices[dst])
        return [_zeros_like(xs[r]) if o is None else o
                for r, o in enumerate(out)]

    def ppermute(self, xs: Sequence[torch.Tensor],
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """Shard ``src``'s entry goes to shard ``dst`` for each (src, dst)
        of ``perm``; a shard that receives nothing gets zeros, as in JAX.
        An entry is a tensor or a tuple of tensors, moved together."""
        out = self._permute(xs, perm)
        if self.census_record is not None:
            self._count("ppermute", out)
        return out

    def rotate(self, xs: Sequence[torch.Tensor],
               hops: int = 1) -> List[torch.Tensor]:
        """:meth:`ppermute` by ``hops`` around the ring (r → r + hops)."""
        p = self.num_shards
        out = self._permute(xs, [(i, (i + hops) % p) for i in range(p)])
        if self.census_record is not None:
            self._count("rotate", out)
        return out

    def _fold(self, op, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``op`` over every shard's tensor in shard order 0 to P−1, on
        ``devices[0]``."""
        self.check(*xs)
        total = xs[0]
        for x in xs[1:]:
            total = op(total, x.to(total.device))
        return total

    def reduce(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of every shard's tensor, added in shard order 0 to P−1
        on ``devices[0]`` and left there."""
        out = self._fold(torch.add, xs)
        if self.census_record is not None:
            self._count("reduce", out)
        return out

    def _all_reduce(self, op: str, fold, xs) -> List[torch.Tensor]:
        out = self.replicate(self._fold(fold, xs))
        if self.census_record is not None:
            self._count(op, out)
        return out

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """:meth:`reduce`, then placed on every shard's device."""
        return self._all_reduce("psum", torch.add, xs)

    def pmin(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise minimum of every shard's tensor, placed on every
        shard's device."""
        return self._all_reduce("pmin", torch.minimum, xs)

    def pmax(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise maximum of every shard's tensor, placed on every
        shard's device."""
        return self._all_reduce("pmax", torch.maximum, xs)

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The shards' tensors concatenated in shard order along axis 0,
        once on each distinct device, placed on every shard's device."""
        self.check(*xs)
        out = list(xs) if len(xs) == 1 else self.per_device(
            lambda r: torch.cat([x.to(self.devices[r]) for x in xs]))
        if self.census_record is not None:
            self._count("all_gather", out)
        return out

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each ``xs[q]`` is [P, ...]: shard r receives the [P, ...] stack of
        ``xs[q][r]`` for q = 0 .. P−1, on ``devices[r]``
        (``jax.lax.all_to_all`` with split and concat axis 0)."""
        self.check(*xs)
        p = self.num_shards
        for x in xs:
            if x.shape[0] != p:
                raise ValueError(f"all_to_all needs a leading axis of {p} "
                                 f"(the shards), got {tuple(x.shape)}")
        out = [torch.stack([x[r].to(d) for x in xs])
               for r, d in enumerate(self.devices)]
        if self.census_record is not None:
            self._count("all_to_all", out)
        return out
