"""Device mesh and sharding layer (counterpart of mtr_tpu/parallel/mesh.py).

The per-read pipeline is embarrassingly parallel over DP jobs, so the one
axis is data parallelism: a batch of jobs is cut on its batch axis into one
contiguous part a slot of the mesh, each part is one launch of the port's
counts or consensus op on its slot's device, and the results concatenate in
order.  There is no shard_map here: a mesh is an explicit list of devices
and the launches are explicit.  Jobs are independent, so the result equals
the one-device launch bit for bit, column 7 of a counts row aside (the wrap
value of the LAUNCH's final row: it depends on what else is in the launch,
a shard is another launch, and nothing reads it).

A CUDA slot launches on a stream of its own.  Its part's tensors are made
on that stream; the resident reads come from the caller's current stream
and the results go back to it, ordered both ways with wait_stream and
record_stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mtr_tpu_torch.native import MAX_PERIOD
from mtr_tpu_torch.ops.wrap_dp_consensus import (
    cap_parts,
    move_row_bytes,
    wrap_dp_consensus,
)
from mtr_tpu_torch.ops.wrap_dp_counts import U_SPANS, wrap_dp_counts


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh: one torch device a slot and, for a CUDA slot, its
    stream (None for a CPU slot).  A device may fill several slots."""

    devices: tuple
    streams: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in slot order."""
        return tuple(dict.fromkeys(self.devices))


def device_count() -> int:
    return torch.cuda.device_count()


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """With n_devices alone: cuda:0 .. cuda:n-1 (every card when None),
    raising when there are fewer cards: a mesh cut silently would let a
    multi-device check pass on one device.  With devices=: those devices,
    one slot each in the order given; a device may be named more than once
    (CPU tests pass ["cpu"] * n; two slots on one card show that a split is
    exact, not that it scales)."""
    if devices is None:
        have = device_count()
        if n_devices is None:
            n_devices = have
        if n_devices < 1 or have < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but "
                f"{have} CUDA devices are visible")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    elif n_devices is not None and n_devices != len(devices):
        raise ValueError(f"n_devices {n_devices} but {len(devices)} devices")
    slots = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= device_count():
                raise RuntimeError(f"{d} named but {device_count()} CUDA "
                                   f"devices are visible")
        slots.append(d)
    if not slots:
        raise ValueError("a mesh needs at least one slot")
    streams = tuple(torch.cuda.Stream(d) if d.type == "cuda" else None
                    for d in slots)
    return Mesh(tuple(slots), streams)


def split_bounds(n: int, parts: int) -> list[int]:
    """parts + 1 bounds cutting range(n) into contiguous parts whose sizes
    differ by at most one."""
    return [n * s // parts for s in range(parts + 1)]


def _run_slots(mesh: Mesh, bounds, work, resident=None) -> list:
    """work(device, lo, hi) -> a tuple of tensors, for every slot with
    lo < hi, on the slot's stream.  `resident` maps a device to the tensors
    made on the caller's stream that the slot's work reads.  Returns the
    tuples in slot order; the caller's streams wait for the slots'."""
    outs = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = bounds[s], bounds[s + 1]
        if lo == hi:
            continue
        stream = mesh.streams[s]
        if stream is None:
            outs.append(work(dev, lo, hi))
            continue
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        for t in (resident or {}).get(dev, ()):
            t.record_stream(stream)
        with torch.cuda.stream(stream):
            res = work(dev, lo, hi)
        for t in res:
            t.record_stream(current)
        outs.append(res)
    for stream, dev in zip(mesh.streams, mesh.devices):
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
    return outs


def _concat(mesh: Mesh, outs, n_fields: int, empty) -> tuple:
    """Slot results -> one tensor a field on the mesh's first device."""
    first = mesh.devices[0]
    if not outs:
        return empty(first)
    return tuple(torch.cat([o[f].to(first) for o in outs])
                 for f in range(n_fields))


def _no_counts(device) -> tuple:
    return (torch.empty((0, 15), dtype=torch.int32, device=device),)


def _host(a, dtype) -> torch.Tensor:
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    return t.to(dtype).contiguous()


def replicate(mesh: Mesh, flat: torch.Tensor) -> dict:
    """A copy of the flat reads on every distinct device of the mesh, one
    upload a device (a copy on the CPU too: the caller may refill its
    staging buffer)."""
    return {d: flat.to(d, non_blocking=True, copy=True)
            for d in mesh.distinct}


def sharded_wrap_dp_step(mesh: Mesh, b: int, u_span: int, r_pad: int):
    """The counts DP step with the batch cut over the mesh (counterpart of
    mtr_tpu.parallel.mesh.sharded_wrap_dp_step): returns fn(scal (b, 8),
    rep (b, r_pad) padded with -1, unit (b, u_span) padded with -2) ->
    (counts (b, 15) int32, counts[:, 7:]) on the mesh's first device.  The
    batch is cut into equal contiguous parts; each part's rows become its
    own resident reads and one wrap_dp_counts launch on its slot."""
    n = mesh.size
    if b % n:
        raise ValueError(f"batch {b} must divide the {n}-slot mesh")
    if u_span not in U_SPANS:
        raise ValueError(f"u_span must be one of {U_SPANS}, got {u_span}")
    bounds = split_bounds(b, n)

    def fn(scal, rep, unit):
        scal = _host(scal, torch.int32)
        rep = _host(rep, torch.int8)
        unit = _host(unit, torch.int8)
        if (tuple(scal.shape), tuple(rep.shape), tuple(unit.shape)) != (
                (b, 8), (b, r_pad), (b, u_span)):
            raise ValueError("sharded_wrap_dp_step: inputs must be "
                             f"({b}, 8), ({b}, {r_pad}), ({b}, {u_span})")

        def work(dev, lo, hi):
            starts = torch.arange(hi - lo, dtype=torch.int32) * r_pad
            return (wrap_dp_counts(
                rep[lo:hi].reshape(-1).to(dev), starts.to(dev),
                scal[lo:hi].to(dev), unit[lo:hi].to(dev), u_span),)

        counts, = _concat(mesh, _run_slots(mesh, bounds, work), 1,
                          _no_counts)
        return counts, counts[:, 7:]

    return fn


def sharded_resident(mesh: Mesh, kind: str, flats: dict, starts, scal,
                     units, u_span: int, factor: int = 0,
                     cap_bytes: int | None = None):
    """One batch of resident DP jobs cut over the mesh (counterpart of
    mtr_tpu.parallel.mesh.sharded_resident_fn).  `flats` holds the batch's
    flat int8 reads on every distinct device (`replicate`); starts (B,),
    scal (B, 8) and units (B, u_span) are host arrays, cut on the batch
    axis into contiguous parts that differ by at most one job (the kernels
    need no equal shards, so no job is padded or dropped; a slot with no
    job launches nothing).

    kind "counts" stands for the reference's counts2, counts2w and counts
    (one kernel takes every unit width): one wrap_dp_counts launch a part,
    -> (B, 15) int32.  kind "consensus": wrap_dp_consensus with traceback
    factor `factor`, each part cut further so that one launch's move
    scratch stays within cap_bytes (longest-first order keeps the cuts
    few), -> ((B, 500, 9) int32, best (B, 8) int32).  Results lie on the
    mesh's first device, in job order."""
    if kind not in ("counts", "consensus"):
        raise ValueError(f"unknown kind {kind!r}")
    starts = _host(starts, torch.int32)
    scal = _host(scal, torch.int32)
    units = _host(units, torch.int8)
    bounds = split_bounds(scal.shape[0], mesh.size)
    resident = {d: (t,) for d, t in flats.items()}

    def part(dev, lo, hi):
        return (flats[dev], starts[lo:hi].to(dev), scal[lo:hi].to(dev),
                units[lo:hi].to(dev), u_span)

    if kind == "counts":
        def work(dev, lo, hi):
            return (wrap_dp_counts(*part(dev, lo, hi)),)

        return _concat(mesh, _run_slots(mesh, bounds, work, resident), 1,
                       _no_counts)[0]

    def work(dev, lo, hi):
        cuts = [hi - lo]
        if cap_bytes is not None:
            sizes = scal[lo:hi, 0].long() * move_row_bytes(
                scal[lo:hi, 1].long())
            cuts = cap_parts(sizes.tolist(), cap_bytes)
        res, a = [], lo
        for cut in cuts:
            res.append(wrap_dp_consensus(*part(dev, a, lo + cut), factor))
            a = lo + cut
        return tuple(torch.cat([r[f] for r in res]) for f in range(2))

    return _concat(
        mesh, _run_slots(mesh, bounds, work, resident), 2,
        lambda d: (torch.empty((0, MAX_PERIOD, 9), dtype=torch.int32,
                               device=d),
                   torch.empty((0, 8), dtype=torch.int32, device=d)))
