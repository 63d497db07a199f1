"""Split-S flash-decode over a serving mesh: the port of
``repro.serving.spmd_decode``.

Layout: a KV ring (B, S, Hkv, D) splits its lanes over the mesh's batch
axis (when B divides; else every group holds every lane) and its SLOTS over
the sequence axis: shard (g, r) holds lane block g's slots [r·S_loc,
(r+1)·S_loc) on its own device, as a tensor of its own (the kernels read
contiguous tensors).  A paged pool ((P, page, Hkv, D) + (P, page) pos)
splits its ROWS over the sequence axis, with every lane on every shard:
pages are shared across lanes.  Each decode step, every shard

  1. writes each lane's new K/V (and ``pos``) if the lane's ring slot or
     pool row lands in its chunk (``cache_index`` may be a per-lane (B,)
     vector: lanes of a continuous batch sit at independent depths),
  2. computes a partial softmax (m, l, acc) over its own slots or rows: the
     decode kernel's partials launch on the card
     (``ops.decode_attention_partials`` / ``paged_decode_attention_partials``),
     ``ref.local_attend`` on the CPU,

and the shards' states, brought to the lead device (the query's), are
joined by ONE log-sum-exp combine launch (``ops.attention_combine``): the
reference's ``pmax``/``psum`` of (B, H) scalars and (B, H, D).

The reference is single-controller and so is this: one process drives
every shard eagerly, shard after shard, and a mesh may repeat a device
(four sequence shards on one card run the partials and the combine for
real).  Lanes replicated over the batch axis (B not divisible, and always
in paged mode) live once, on the first group's devices: the reference's
other groups would compute the same values.  ``shard_cache`` and
``gather_cache`` lay a model cache out over the mesh and put it back
together (the eager counterpart of the reference's ``in_specs`` /
``out_specs``); a plain tensor handed to the spmd functions is laid out
first, and they return the ``Sharded`` tensors, updated in place.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import shared


def _grid(mesh, batch_axis, seq_axis: str, b: int):
    """The devices that hold a cache of ``b`` lanes: a (groups, n_seq)
    list of lists, one row per lane block, and whether lanes are split
    over the rows (``b`` divisible by the batch axes' size).  Axes that
    neither split lanes nor slots take their first coordinate."""
    names = mesh.axis_names
    if seq_axis not in names:
        raise ValueError(f"mesh axes {names} have no sequence axis "
                         f"{seq_axis!r}")
    baxes = () if not batch_axis else (
        tuple(batch_axis) if isinstance(batch_axis, (tuple, list))
        else (batch_axis,))
    ways = math.prod(mesh.shape[a] for a in baxes)
    keep = baxes if b % ways == 0 else ()
    sub = mesh.devices[tuple(slice(None) if a in keep or a == seq_axis else 0
                             for a in names)]
    left = [a for a in names if a in keep or a == seq_axis]
    sub = np.transpose(sub, [left.index(a) for a in keep]
                       + [left.index(seq_axis)])
    rows = sub.reshape(-1, mesh.shape[seq_axis])
    return [list(r) for r in rows], len(rows) > 1


class Sharded:
    """One cache tensor laid out over a serving mesh.

    ``parts[g][r]`` (on ``devices[g][r]``) holds chunk r of dimension
    ``axis`` for lane block g when ``lane_split`` (dimension 0 cut into
    equal blocks); otherwise there is one group, ``parts[0]``, holding
    every lane.  A paged pool (``scratch``) holds one more row below its
    chunk, where a write owned by another shard lands (no table names
    it).  ``shape`` is the global shape."""

    def __init__(self, parts, devices, axis: int, lane_split: bool,
                 scratch: bool, shape):
        self.parts, self.devices = parts, devices
        self.axis, self.lane_split, self.scratch = axis, lane_split, scratch
        self.shape = torch.Size(shape)
        self.chunk = self.shape[axis] // len(devices[0])
        self.block = self.shape[0] // len(devices) if lane_split else None

    @classmethod
    def of(cls, t: torch.Tensor, devices, axis: int, lane_split: bool,
           scratch: bool = False) -> "Sharded":
        devices = devices if lane_split else devices[:1]
        n_seq = len(devices[0])
        if t.shape[axis] % n_seq:
            raise ValueError(f"{t.shape[axis]} {'pool rows' if scratch else 'slots'}"
                             f" do not split over {n_seq} sequence shards")
        chunk = t.shape[axis] // n_seq
        block = t.shape[0] // len(devices) if lane_split else t.shape[0]

        def piece(g, r, dev):
            src = t[g * block:(g + 1) * block] if lane_split else t
            p = src.narrow(axis, r * chunk, chunk)
            if scratch:     # a pos row of -1 (K/V zeros) no table reads
                p = torch.cat([p, torch.full_like(p[:1], -1 if
                               p.dtype == torch.int32 else 0)])
            return p.to(dev).contiguous()

        return cls(_per_shard(devices, piece), devices, axis, lane_split,
                   scratch, t.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    def _chunk(self, g: int, r: int) -> torch.Tensor:
        p = self.parts[g][r]
        return p[:self.chunk] if self.scratch else p

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (the first shard's by default)."""
        device = device if device is not None else self.devices[0][0]
        groups = [torch.cat([self._chunk(g, r).to(device)
                             for r in range(len(row))], dim=self.axis)
                  for g, row in enumerate(self.devices)]
        return torch.cat(groups) if self.lane_split else groups[0]

    def _owner(self, index: int):
        r, loc = divmod(int(index), self.chunk)
        return self.parts[0][r], loc

    # ---- a paged pool: the row reads and writes of model.paged_* ----
    def __getitem__(self, key):
        """``pool[row]`` (an int): that row's view on its shard;
        ``pool[rows, within]`` (index tensors): the gathered entries on
        ``rows``' device."""
        if isinstance(key, int):
            part, loc = self._owner(key)
            return part[loc]
        rows, within = key
        out = None
        for r, part in enumerate(self.parts[0]):
            off, inr = _local_rows(rows, r * self.chunk, self.chunk)
            got = part[off.to(part.device), within.to(part.device)].to(
                rows.device)
            inr = inr.reshape(inr.shape + (1,) * (got.dim() - inr.dim()))
            out = got if out is None else torch.where(
                inr.to(got.device), got, out)
        return out

    def __setitem__(self, key, vals) -> None:
        """``pool[rows, within] = vals``: each shard keeps the entries of
        its rows (the others land in its scratch row)."""
        rows, within = key
        for r, part in enumerate(self.parts[0]):
            off, _ = _local_rows(rows, r * self.chunk, self.chunk)
            dev = part.device
            part[off.to(dev), within.to(dev)] = vals.to(dev)

    # ---- a ring: Replica._insert ----
    def set_lane(self, lane: int, src: torch.Tensor) -> None:
        """Copy lane ``lane``'s whole ring ``src`` ((n, ...), this
        tensor's shape without its lane axis) into its shards."""
        g, loc = divmod(lane, self.block) if self.lane_split else (0, lane)
        for r, part in enumerate(self.parts[g]):
            part[loc].copy_(src.narrow(self.axis - 1, r * self.chunk,
                                       self.chunk))


def _local_rows(rows, start: int, n: int):
    """Offsets of global pool ``rows`` in the shard holding [start, start +
    n): in range as they are, elsewhere the shard's scratch row ``n``; and
    the in-range mask."""
    off = rows - start
    inr = (off >= 0) & (off < n)
    return torch.where(inr, off, n), inr


def shard_layer(layer: dict, mesh, *, paged: bool = False,
                batch_axis="data", seq_axis: str = "model") -> dict:
    """One layer's cache over ``mesh``: an attention layer's ring (or, with
    ``paged``, its pools) as ``Sharded`` tensors; any other layer (a
    recurrent state, a cross-attention layer's encoder K/V) as it is, on
    the device it was on."""
    if "pos" not in layer or "k" not in layer:
        return layer
    if paged:
        devices, _ = _grid(mesh, None, seq_axis, layer["k"].shape[0])
        return {name: t if isinstance(t, Sharded) else
                Sharded.of(t, devices, 0, False, scratch=True)
                for name, t in layer.items()}
    devices, split = _grid(mesh, batch_axis, seq_axis, layer["k"].shape[0])
    return {name: t if isinstance(t, Sharded) else
            Sharded.of(t, devices, 1, split) for name, t in layer.items()}


def shard_cache(cache: Sequence[dict], mesh, *, paged: bool = False,
                batch_axis="data", seq_axis: str = "model") -> List[dict]:
    """A model cache laid out over ``mesh`` (a new list; ``cache`` is left
    as it is): see ``shard_layer``."""
    return [shard_layer(layer, mesh, paged=paged, batch_axis=batch_axis,
                        seq_axis=seq_axis) for layer in cache]


def gather_cache(cache: Sequence[dict], device=None) -> List[dict]:
    """The global tensors of a sharded model cache, on ``device`` (each
    tensor's first shard by default)."""
    return [{name: t.gather(device) if isinstance(t, Sharded) else t
             for name, t in layer.items()} for layer in cache]


# ---------------------------------------------------------------- tracing
# A tracer of one card's share (``launch.dryrun``) counts the lead card's:
# shard (0, 0), which holds lane block 0's first slots, beside the query,
# and the rest of the step.  The other shards' work is not its to count,
# and their partial states have the lead's shapes.
_trace = threading.local()


@contextlib.contextmanager
def lead_shard_only(observe=None):
    """In the ``with`` body, lay out and issue only shard (0, 0): a cache
    laid out here holds the lead's part in every shard's place, the
    decode steps write and attend on the lead's part alone and stand its
    partial states in for every other shard's; ``observe(states)``, when
    given, is called before each combine with the per-shard (ml, part)
    states it joins (a list a lane block of a list a sequence shard)."""
    _trace.lead, _trace.observe = True, observe
    try:
        yield
    finally:
        _trace.lead, _trace.observe = False, None


def _per_shard(devices, issue):
    """``issue(g, r, dev)`` of every shard, a list a lane block of a list a
    sequence shard.  Under ``lead_shard_only`` only shard (0, 0) is issued
    and its result stands in for every other's."""
    if getattr(_trace, "lead", False):
        lead = issue(0, 0, devices[0][0])
        return [[lead] * len(row) for row in devices]
    return [[issue(g, r, dev) for r, dev in enumerate(row)]
            for g, row in enumerate(devices)]


def _combine(states, q):
    """One combine launch over every shard's partial states (a list per
    lane block of per-shard (ml, part)), on q's device: (B, 1, Hq, D)."""
    if getattr(_trace, "observe", None) is not None:
        _trace.observe(states)
    ml = torch.cat([torch.cat([m.to(q.device) for m, _ in grp], dim=1)
                    for grp in states])
    part = torch.cat([torch.cat([p.to(q.device) for _, p in grp], dim=1)
                      for grp in states])
    return ops.attention_combine(ml, part, q.dtype).reshape(q.shape)


def _as_sharded(t, devices, axis: int, split: bool, what: str):
    if not isinstance(t, Sharded):
        return Sharded.of(t, devices, axis, split)
    if t.lane_split != split or len(t.devices[0]) != len(devices[0]) \
            or t.axis != axis:
        raise ValueError(f"{what} is laid out over {len(t.devices)} x "
                         f"{len(t.devices[0])} shards, not {len(devices)} x "
                         f"{len(devices[0])}")
    return t


def spmd_decode_attention(mesh, q, k_cache, v_cache, new_k, new_v, pos,
                          cache_index, *, window: int = 0, scale: float,
                          softcap: float = 0.0,
                          batch_axis: Optional[str] = "data",
                          seq_axis: str = "model", memo=None):
    """Returns (out (B,1,H,D), k_cache', v_cache', pos'), the caches as
    ``Sharded`` tensors updated in place.

    pos: (S,) (or ``Sharded``): or per-lane (B, S): int32 ring-slot
    absolute positions (-1 = empty).  ``cache_index`` is a scalar (all
    lanes at the same depth) or a per-lane ``(B,)`` vector: lane b writes
    its new token's K/V at slot ``cache_index[b] % S`` and masks (validity
    and sliding window) against its OWN position.  Per-lane indices
    require per-lane ``(B, S)`` pos.  Each S-shard writes only the lanes
    whose slot lands in its chunk (clipped offsets and ``torch.where``,
    so the step makes no host sync).  ``memo`` (the model call's) keeps
    the per-shard offsets for every layer of one step."""
    b, _, hq, d = q.shape
    s = k_cache.shape[1]
    pos_batched = len(pos.shape) == 2
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=q.device)
    if idx.dim() == 1 and not pos_batched:
        raise ValueError("per-lane cache_index requires per-lane (B, S) pos")
    n_seq = mesh.shape[seq_axis]
    if s % n_seq:
        raise ValueError(f"ring of {s} slots does not split over {n_seq} "
                         "sequence shards")
    s_loc = s // n_seq
    devices, split = _grid(mesh, batch_axis, seq_axis, b)
    k_cache = _as_sharded(k_cache, devices, 1, split, "k_cache")
    v_cache = _as_sharded(v_cache, devices, 1, split, "v_cache")
    pos = _as_sharded(pos, devices, 1 if pos_batched else 0,
                      split and pos_batched, "pos")
    block = b // len(devices)
    lanes_idx = idx.expand(b).contiguous() if idx.dim() == 0 else idx

    def offsets(g, r, dev):
        lanes = slice(g * block, (g + 1) * block)
        li = lanes_idx[lanes].to(dev)
        off = li % s - r * s_loc
        inr = (off >= 0) & (off < s_loc)
        return (torch.arange(block, device=dev), off.clamp(0, s_loc - 1).long(),
                inr, li, li + 1)

    def partials(g, r, dev):
        lanes = slice(g * block, (g + 1) * block)
        ar, off, inr, li, cl = shared(memo, ("spmd_ring", s, g, r),
                                      lambda: offsets(g, r, dev))
        kl, vl = k_cache.parts[g][r], v_cache.parts[g][r]
        pl = pos.parts[g if pos.lane_split else 0][r]
        keep = inr[:, None, None]
        kl[ar, off] = torch.where(keep, new_k[lanes, 0].to(dev, kl.dtype),
                                  kl[ar, off])
        vl[ar, off] = torch.where(keep, new_v[lanes, 0].to(dev, vl.dtype),
                                  vl[ar, off])
        if pos_batched:
            pl[ar, off] = torch.where(inr, li, pl[ar, off])
            pl2 = pl
        else:
            # one shared (S,) plane, held by the first group: every
            # lane writes the same entry
            if g == 0:
                pl[off[:1]] = torch.where(inr[:1], li[:1], pl[off[:1]])
            pl2 = pl.to(dev).expand(block, s_loc).contiguous()
        return ops.decode_attention_partials(
            q[lanes].to(dev), kl, vl, cache_len=cl, pos=pl2,
            window=window, scale=scale, softcap=softcap)

    return (_combine(_per_shard(devices, partials), q), k_cache, v_cache,
            pos)


def spmd_paged_decode_attention(mesh, q, k_pool, v_pool, pos_pool, tables,
                                new_k, new_v, rows, within, cache_index, *,
                                window: int = 0, scale: float,
                                softcap: float = 0.0,
                                batch_axis: Optional[str] = "data",
                                seq_axis: str = "model", memo=None):
    """Block-table decode under the mesh: page pools sharded over rows.
    Returns (out (B,1,H,D), k_pool', v_pool', pos_pool'), the pools as
    ``Sharded`` tensors updated in place.

    Pools ((P, page, Hkv, D) + (P, page) pos) split their **row** axis over
    ``seq_axis``: pages replace the contiguous S chunks of
    ``spmd_decode_attention``, so each rank holds a contiguous row range
    and the same log-sum-exp combine joins the partial softmaxes.
    ``rows`` / ``within`` are each lane's pre-resolved write coordinates
    ((B,) int, the dump row for absent table slots); ``tables`` is the (B,
    max_pages) block table.  Each rank keeps the write only for lanes
    whose row lands in its range (the others land in its scratch row),
    and attends through a local table in which entries outside its range
    are -1.  A lane with nothing visible on any rank comes out as zeros.

    The batch dim stays replicated: every rank must see every lane's table
    (pages are shared across lanes).  Requires ``P`` divisible by
    ``mesh.shape[seq_axis]``."""
    del batch_axis                       # lanes replicated: pools are shared
    b = q.shape[0]
    prows = k_pool.shape[0]
    n_seq = mesh.shape[seq_axis]
    if prows % n_seq:
        raise ValueError(f"{prows} pool rows do not split over {n_seq} "
                         "sequence shards")
    p_loc = prows // n_seq
    devices, _ = _grid(mesh, None, seq_axis, b)
    k_pool, v_pool, pos_pool = (
        t if isinstance(t, Sharded) else Sharded.of(t, devices, 0, False, True)
        for t in (k_pool, v_pool, pos_pool))
    idx = torch.as_tensor(cache_index, dtype=torch.int32,
                          device=q.device).reshape(-1).expand(b)
    tables = torch.as_tensor(tables, dtype=torch.int32, device=q.device)

    def local(r, dev):
        start = r * p_loc
        off, _ = _local_rows(torch.as_tensor(rows, device=q.device).long(),
                             start, p_loc)
        e_off = tables - start
        mine = (tables >= 0) & (e_off >= 0) & (e_off < p_loc)
        return (off.to(dev), torch.as_tensor(within).long().to(dev),
                torch.where(mine, e_off, -1).to(dev, torch.int32).contiguous(),
                idx.to(dev), (idx + 1).to(dev).contiguous())

    def partials(_, r, dev):
        off, win, tbl, li, cl = shared(memo, ("spmd_paged", prows, r),
                                       lambda: local(r, dev))
        kl, vl, pl = (t.parts[0][r] for t in (k_pool, v_pool, pos_pool))
        kl[off, win] = new_k[:, 0].to(dev, kl.dtype)
        vl[off, win] = new_v[:, 0].to(dev, vl.dtype)
        pl[off, win] = li
        return ops.paged_decode_attention_partials(
            q.to(dev), kl, vl, pl, tbl, cache_len=cl, window=window,
            scale=scale, softcap=softcap)

    return (_combine(_per_shard(devices[:1], partials), q), k_pool, v_pool,
            pos_pool)
