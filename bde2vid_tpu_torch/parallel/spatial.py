"""The spatially sharded forward and its halo exchanges (the port's
counterpart of what XLA inserts for ``bde2vid_tpu/parallel/mesh.py::
spatial_sharding``).

The JAX package places the sensor rows (H) over the mesh's "spatial" axis
and lets the compiler insert the halo exchanges of every conv, resize and
window partition. PyTorch has no such compiler, and the port runs one
process per card: here each rank of the "spatial" group holds a band of
rows and the layers exchange the rows their global geometry reads.

- ``RowPlan``: each rank's band of rows at every encoder level, derived
  from a split of the deepest level's rows so that every stride-2 conv maps
  band onto band. Bands may be uneven (23 rows over 4 ranks: 6, 6, 6, 5);
  a rank with no row is refused.
- ``row_sharded(plan, group)``: the context under which a forward runs
  sharded. ``nn/layers.py``, ``nn/recurrent.py``, ``nn/window_attention.py``
  and the models read it (``current()``): a conv fetches the rows its
  kernel reaches past the band, a resize the row beyond each edge (clamped
  only at the global borders), a norm sums its statistics over the group,
  and a Swin block runs the windows of the global window grid that meet the
  band. Without the context nothing changes.
- ``halo_rows``: the exchange itself, an autograd Function. Its forward
  receives the rows a rank needs from their owners (zeros outside the
  global map, where the unsharded layer pads with zeros); its backward
  sends each received row's gradient back and adds it into the owner's.
  ``group_sum`` sums over the group, differentiably.
- ``shard_rows`` / ``gather_rows``: this rank's band of a whole tensor, and
  every rank's bands collected back (differentiable).
- ``spatial_forward``: a model's forward on a ("data", "spatial") mesh.

Transport: point-to-point with the ranks that hold or need the rows
(``dist.batch_isend_irecv``), on the device under NCCL. Gloo is a host
library: under gloo a CUDA tensor's rows are staged through host memory.
"""

from __future__ import annotations

import collections
import contextlib
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

A16 = "ROADMAP A16"

_CURRENT: Optional["RowContext"] = None

# what this process exchanged: "halo_exchanges" (forward and backward calls
# that moved rows), "halo_bytes" (bytes it sent) and "group_sums" (norm
# statistics); callers clear and read it, as the kernels' launch counts
exchange_counts: collections.Counter = collections.Counter()


class RowPlan:
    """The bands of an ``height``-row map split over ``ranks`` ranks at
    ``levels + 1`` levels: level 0 is the full map, level L its rows after L
    stride-2 convs, ``height >> L``. The deepest level's rows are split as
    evenly as they go, the first ``rows % ranks`` ranks taking one more,
    and a band at level L is the deepest band times ``2 ** (levels - L)``."""

    def __init__(self, height: int, levels: int, ranks: int):
        if levels < 0 or height % (1 << levels):
            raise ValueError(f"{height} rows do not halve {levels} times: pad the map to a "
                             f"multiple of {1 << max(levels, 0)} rows first")
        deep = height >> levels
        if ranks < 1 or deep < ranks:
            raise ValueError(f"{height} rows ({deep} at the deepest of {levels} levels) over "
                             f"{ranks} ranks: a rank would hold no row")
        self.height0, self.levels, self.ranks = height, levels, ranks
        base, extra = divmod(deep, ranks)
        self.deep_rows = [base + (r < extra) for r in range(ranks)]
        self.deep_starts = [sum(self.deep_rows[:r]) for r in range(ranks)]

    def height(self, level: int) -> int:
        return self.height0 >> level

    def band(self, index: int, level: int) -> Tuple[int, int]:
        """[lo, hi) of rank ``index``'s rows at ``level``."""
        s = self.levels - level
        lo = self.deep_starts[index] << s
        return lo, lo + (self.deep_rows[index] << s)

    def rows(self, level: int) -> List[int]:
        """Every rank's band height at ``level``."""
        return [r << (self.levels - level) for r in self.deep_rows]

    def level_of(self, index: int, local_rows: int) -> int:
        """The level at which rank ``index`` holds ``local_rows`` rows."""
        for level in range(self.levels + 1):
            if self.deep_rows[index] << (self.levels - level) == local_rows:
                return level
        raise ValueError(f"rank {index} holds no band of {local_rows} rows: bands "
                         f"{[self.rows(lv)[index] for lv in range(self.levels + 1)]}")

    def level_of_height(self, height: int) -> int:
        """The level whose whole map has ``height`` rows."""
        for level in range(self.levels + 1):
            if self.height(level) == height:
                return level
        raise ValueError(f"a layer's output of {height} rows is at no level of the plan "
                         f"({[self.height(lv) for lv in range(self.levels + 1)]}): the "
                         f"row-sharded forward ({A16}) maps only band onto band")


class RowContext:
    """A forward running row-sharded: the plan, this rank's index in the
    "spatial" group and the group."""

    def __init__(self, plan: RowPlan, group=None):
        self.plan, self.group = plan, group
        self.index = dist.get_rank(group)
        self.ranks = plan.ranks
        if dist.get_world_size(group) != plan.ranks:
            raise ValueError(f"a plan over {plan.ranks} ranks in a group of "
                             f"{dist.get_world_size(group)}")
        self.host_staged = dist.get_backend(group) == "gloo"

    def geometry(self, local_rows: int) -> Tuple[int, int, int, int]:
        """(level, rows of the whole map, lo, hi) of a local band."""
        level = self.plan.level_of(self.index, local_rows)
        return (level, self.plan.height(level), *self.plan.band(self.index, level))

    def bands(self, level: int) -> List[Tuple[int, int]]:
        return [self.plan.band(r, level) for r in range(self.ranks)]


def current() -> Optional[RowContext]:
    """The active row-sharded forward, or None."""
    return _CURRENT


@contextlib.contextmanager
def entered(ctx: Optional[RowContext]):
    """Run under ``ctx`` (None: unsharded); restores the previous one."""
    global _CURRENT
    before, _CURRENT = _CURRENT, ctx
    try:
        yield ctx
    finally:
        _CURRENT = before


def row_sharded(plan: RowPlan, group=None):
    """The context of a row-sharded forward over ``group`` (the mesh's
    "spatial" group; the default group without one). Every rank of the
    group must enter it and run the same layers."""
    ctx = RowContext(plan, group)
    # NCCL wants a group's first point-to-point call to involve every rank
    dist.barrier(group=group)
    return entered(ctx)


def suspended():
    """Run a part of a sharded forward that works on whole windows, not on
    bands of the map (the KV token reduction conv inside each window)."""
    return entered(None)


def refuse(family: str) -> None:
    """Raise if a forward of ``family``, which the row-sharded path does not
    take, runs under the context."""
    if _CURRENT is not None:
        raise ValueError(f"{family} does not run row-sharded (the spatially sharded forward "
                         f"covers BDE2VID and the E2VID family, {A16})")


# ----------------------------------------------------------------- exchange


def _peer(ctx: RowContext, r: int) -> int:
    return r if ctx.group is None else dist.get_global_rank(ctx.group, r)


def _transfer(ctx: RowContext, sends, recvs) -> None:
    """Point-to-point: ``sends`` [(rank, tensor)] go out, ``recvs`` [(rank,
    tensor)] are filled; under gloo CUDA tensors pass through host memory."""
    if not sends and not recvs:
        return
    staged = ctx.host_staged and any(t.is_cuda for _, t in sends + recvs)
    out = [(r, t.contiguous().cpu() if staged else t.contiguous()) for r, t in sends]
    into = [(r, torch.empty(t.shape, dtype=t.dtype) if staged else t) for r, t in recvs]
    ops = ([dist.P2POp(dist.isend, t, _peer(ctx, r), ctx.group) for r, t in out]
           + [dist.P2POp(dist.irecv, t, _peer(ctx, r), ctx.group) for r, t in into])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (_, dst), (_, src) in zip(recvs, into):
            dst.copy_(src)
    exchange_counts["halo_exchanges"] += 1
    exchange_counts["halo_bytes"] += sum(t.numel() * t.element_size() for _, t in out)


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else (lo, lo)


def _wanted(ctx: RowContext, level: int, need, r: int, owner: int) -> Tuple[int, int]:
    """Rows of ``owner``'s band at ``level`` that rank ``r`` reads past its
    own band (``need[r]`` = (above, below); at most one range, as the bands
    are contiguous and ordered)."""
    lo, hi = ctx.plan.band(r, level)
    above, below = need[r]
    own = ctx.plan.band(owner, level)
    if owner < r:
        return _overlap((lo - above, lo), own)
    return _overlap((hi, hi + below), own)


def _rows_shape(x: torch.Tensor, dim: int, rows: int) -> List[int]:
    shape = list(x.shape)
    shape[dim] = rows
    return shape


def _outside(ctx: RowContext, level: int, g0: int, g1: int):
    """The rows of [g0, g1) above and below the map, each with the row of
    the band that a clamped read repeats there (the band must hold that
    edge of the map)."""
    lo, hi = ctx.plan.band(ctx.index, level)
    height = ctx.plan.height(level)
    out = []
    if g0 < 0:
        out.append(((g0, min(g1, 0)), 0))
    if g1 > height:
        out.append(((max(g0, height), g1), hi - lo - 1))
    if (g0 < 0 and lo > 0) or (g1 > height and hi < height):
        raise ValueError(f"a clamped read of rows [{g0}, {g1}) past the map's edge from the band "
                         f"[{lo}, {hi}), which does not hold that edge")
    return out


class _HaloRows(torch.autograd.Function):
    """rows [lo - above, hi + below) of the map along ``dim`` from a band
    [lo, hi): the band's own rows, the others' rows from their owners, and
    outside the map zeros, or with ``clamp`` the map's edge row. A negative
    count crops the band instead."""

    @staticmethod
    def forward(fctx, x, ctx, level, need, dim, clamp):
        fctx.args = (ctx, level, need, dim, clamp)
        me = ctx.index
        lo, hi = ctx.plan.band(me, level)
        g0, g1 = lo - need[me][0], hi + need[me][1]
        out = x.new_zeros(_rows_shape(x, dim, g1 - g0))
        a, b = _overlap((g0, g1), (lo, hi))
        out.narrow(dim, a - g0, b - a).copy_(x.narrow(dim, a - lo, b - a))
        for (r0, r1), edge in _outside(ctx, level, g0, g1) if clamp else ():
            out.narrow(dim, r0 - g0, r1 - r0).copy_(x.narrow(dim, edge, 1))
        sends, recvs = [], []
        for r in range(ctx.ranks):
            if r == me:
                continue
            s0, s1 = _wanted(ctx, level, need, r, me)
            if s1 > s0:
                sends.append((r, x.narrow(dim, s0 - lo, s1 - s0)))
            t0, t1 = _wanted(ctx, level, need, me, r)
            if t1 > t0:
                recvs.append((r, (t0, t1)))
        bufs = [(r, x.new_empty(_rows_shape(x, dim, t1 - t0))) for r, (t0, t1) in recvs]
        _transfer(ctx, sends, bufs)
        for (_, (t0, t1)), (_, buf) in zip(recvs, bufs):
            out.narrow(dim, t0 - g0, t1 - t0).copy_(buf)
        return out

    @staticmethod
    def backward(fctx, g):
        ctx, level, need, dim, clamp = fctx.args
        me = ctx.index
        lo, hi = ctx.plan.band(me, level)
        g0 = lo - need[me][0]
        dx = g.new_zeros(_rows_shape(g, dim, hi - lo))
        a, b = _overlap((g0, g0 + g.shape[dim]), (lo, hi))
        dx.narrow(dim, a - lo, b - a).add_(g.narrow(dim, a - g0, b - a))
        for (r0, r1), edge in _outside(ctx, level, g0, g0 + g.shape[dim]) if clamp else ():
            dx.narrow(dim, edge, 1).add_(g.narrow(dim, r0 - g0, r1 - r0).sum(dim, keepdim=True))
        sends, recvs = [], []
        for r in range(ctx.ranks):
            if r == me:
                continue
            t0, t1 = _wanted(ctx, level, need, me, r)  # rows r lent me: their gradient goes back
            if t1 > t0:
                sends.append((r, g.narrow(dim, t0 - g0, t1 - t0)))
            s0, s1 = _wanted(ctx, level, need, r, me)  # my rows r read
            if s1 > s0:
                recvs.append((r, (s0, s1)))
        bufs = [(r, g.new_empty(_rows_shape(g, dim, s1 - s0))) for r, (s0, s1) in recvs]
        _transfer(ctx, sends, bufs)
        for (_, (s0, s1)), (_, buf) in zip(recvs, bufs):
            dx.narrow(dim, s0 - lo, s1 - s0).add_(buf)
        return dx, None, None, None, None, None


def halo_rows(x: torch.Tensor, above, below, dim: int = -2, clamp: bool = False) -> torch.Tensor:
    """``x``, this rank's band along ``dim``, with ``above`` rows before it
    and ``below`` after it, taken from the ranks that own them; past the
    map's edges zeros, or with ``clamp`` the edge row (for a rank whose band
    holds that edge). ``above`` / ``below`` are counts, or one count for
    each rank of the group: every rank must know what the others read.
    Every rank of the group calls it, in the same order, under
    ``row_sharded``."""
    ctx = current()
    level = ctx.plan.level_of(ctx.index, x.shape[dim])
    ab = [(above, below)] * ctx.ranks if isinstance(above, int) else list(zip(above, below))
    return _HaloRows.apply(x, ctx, level, tuple(map(tuple, ab)), dim % x.dim(), clamp)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        y = x.clone()
        dist.all_reduce(y, group=ctx.group)
        exchange_counts["group_sums"] += 1
        return y

    @staticmethod
    def backward(fctx, g):
        # every rank's copy of the sum feeds that rank's own rows onwards
        g = g.clone()
        dist.all_reduce(g, group=fctx.ctx.group)
        return g, None


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the "spatial" group, on every
    rank, under ``row_sharded``; its gradient is the sum of the ranks'
    gradients."""
    return _GroupSum.apply(x, current())


def moments(x32: torch.Tensor, dims: Tuple[int, ...], keepdim: bool = False):
    """(mean, biased variance, count) of f32 ``x32`` over ``dims``, which
    include the rows: the whole map's, summed over the group in two passes
    as ``Tensor.var`` takes them."""
    _, height, _, _ = current().geometry(x32.shape[2])
    count = height
    for d in dims:
        if d != 2:
            count *= x32.shape[d]
    mean = group_sum(x32.sum(dims, keepdim=True)) / count
    var = group_sum((x32 - mean).square().sum(dims, keepdim=True)) / count
    if not keepdim:
        mean, var = mean.reshape(-1), var.reshape(-1)
    return mean, var, count


# ------------------------------------------------------------ the layers' rows


def _out_level(ctx: RowContext, height: int, k: int, stride: int, pad: int,
               dilation: int = 1) -> int:
    return ctx.plan.level_of_height((height + 2 * pad - dilation * (k - 1) - 1) // stride + 1)


def conv_input(x: torch.Tensor, k: int, stride: int, pad: int, dilation: int = 1) -> torch.Tensor:
    """The rows a conv (kernel ``k``, ``stride``, zero ``pad`` and
    ``dilation`` along H) reads for this rank's band of its output: run the
    conv on the result with no row padding."""
    ctx = current()
    level, height, _, _ = ctx.geometry(x.shape[-2])
    out = _out_level(ctx, height, k, stride, pad, dilation)
    need = []
    for (lo, hi), (a, b) in zip(ctx.bands(level), ctx.bands(out)):
        need.append((lo - (a * stride - pad), (b - 1) * stride - pad + dilation * (k - 1) + 1 - hi))
    return halo_rows(x, *zip(*need))


def output_rows(rows: int, k: int, stride: int, pad: int) -> int:
    """The rows of a conv's output for ``rows`` input rows: under the
    context this rank's band at the output's level, else the formula."""
    ctx = current()
    if ctx is None:
        return (rows + 2 * pad - k) // stride + 1
    _, height, _, _ = ctx.geometry(rows)
    lo, hi = ctx.plan.band(ctx.index, _out_level(ctx, height, k, stride, pad))
    return hi - lo


def transposed_conv_input(x: torch.Tensor, k: int, stride: int, pad: int, output_padding: int,
                          dilation: int = 1) -> Tuple[torch.Tensor, int, int]:
    """(rows, first, count): the input rows a transposed conv reads for this
    rank's band of its output, and where that band starts and how many rows
    it has in the output of the transposed conv run on them with no row
    padding."""
    ctx = current()
    if dilation * (k - 1) < stride - 1:
        raise ValueError(f"a transposed conv of kernel {k} at stride {stride} leaves output rows "
                         f"no input reaches ({A16})")
    level, height, _, _ = ctx.geometry(x.shape[-2])
    out_h = (height - 1) * stride - 2 * pad + dilation * (k - 1) + output_padding + 1
    out = ctx.plan.level_of_height(out_h)
    need, firsts = [], []
    for (lo, hi), (a, b) in zip(ctx.bands(level), ctx.bands(out)):
        i0 = -((-(a + pad - dilation * (k - 1))) // stride)  # ceil
        i1 = (b - 1 + pad) // stride
        need.append((lo - i0, i1 + 1 - hi))
        firsts.append(a - stride * i0 + pad)
    a, b = ctx.plan.band(ctx.index, out)
    return halo_rows(x, *zip(*need)), firsts[ctx.index], b - a


def upsample_input(x: torch.Tensor) -> torch.Tensor:
    """The band with one row beyond each edge, for a x2 bilinear resize:
    the neighbour's row inside the map, the edge row itself at the map's
    border (the resize clamps there)."""
    return halo_rows(x, 1, 1, clamp=True)


def check_halving(x: torch.Tensor) -> None:
    """A bilinear x0.5 resize reads rows 2i and 2i + 1: a band of even rows
    starting at an even row needs no exchange."""
    ctx = current()
    _, _, lo, hi = ctx.geometry(x.shape[-2])
    if lo % 2 or hi % 2:
        raise ValueError(f"a x0.5 resize of rows [{lo}, {hi}) would read across bands ({A16})")


# --------------------------------------------------------- whole tensors


def shard_rows(x: torch.Tensor, plan: RowPlan, index: int, level: int = 0,
               dim: int = -2) -> torch.Tensor:
    """Rank ``index``'s band of the whole-map tensor ``x`` along ``dim``."""
    lo, hi = plan.band(index, level)
    return x.narrow(dim, lo, hi - lo)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, plan, group, index, level, dim):
        fctx.args = (plan, index, level, dim)
        rows = plan.rows(level)
        buf = x.new_zeros(_rows_shape(x, dim, max(rows)))
        buf.narrow(dim, 0, x.shape[dim]).copy_(x)
        parts = [torch.empty_like(buf) for _ in rows]
        dist.all_gather(parts, buf, group=group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, rows)], dim=dim)

    @staticmethod
    def backward(fctx, g):
        # every rank computed the same loss of the same gathered tensor, so
        # the gradient of this rank's own rows, taken from its own copy, is
        # the whole gradient (a sum over the copies would count it S times)
        plan, index, level, dim = fctx.args
        lo, hi = plan.band(index, level)
        return g.narrow(dim, lo, hi - lo).contiguous(), None, None, None, None, None


def gather_rows(x: torch.Tensor, plan: RowPlan, group=None, level: int = 0,
                dim: int = -2) -> torch.Tensor:
    """Every rank's band of the map along ``dim`` collected on every rank
    (one all_gather of bands padded to the tallest). Differentiable: each
    rank keeps the gradient of its own rows, so the ranks must compute the
    same function of the result."""
    if plan.ranks == 1:
        return x
    return _GatherRows.apply(x, plan, group, dist.get_rank(group), level, dim % x.dim())


def model_levels(model: torch.nn.Module) -> int:
    """The stride-2 levels of a model: its encoders (BDE2VID and the
    UNets), 0 for the FireNets."""
    return max((int(m.num_encoders) for m in model.modules() if hasattr(m, "num_encoders")),
               default=0)


def spatial_group(mesh=None):
    """(group, ranks, index) of the "spatial" axis: the mesh's, else the
    default group's."""
    if mesh is not None:
        group = mesh.get_group("spatial")
        return group, dist.get_world_size(group), dist.get_rank(group)
    return None, dist.get_world_size(), dist.get_rank()


def spatial_forward(model: torch.nn.Module, voxels: torch.Tensor, mesh=None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The images (T, N, C, H, W) of ``voxels`` (T, N, B, H, W), the whole
    sequence on every rank, with the rows sharded over ``mesh``'s "spatial"
    axis (the default group without a mesh) and the batch over its "data"
    axis; every rank returns all of them. A sequence model (BDE2VID) takes
    the sequence in one call (``generator`` for its DropPath); a step model
    runs ``models.api.run_sequence`` from its ``initial_state`` at the
    rank's band. H must halve once per encoder; the result equals the
    unsharded forward's. Every rank of the mesh calls it."""
    from bde2vid_tpu_torch.models.api import run_sequence
    from bde2vid_tpu_torch.parallel.mesh import data_group

    group, ranks, index = spatial_group(mesh)
    dgroup, dranks, dindex = data_group(mesh) if mesh is not None else (None, 1, 0)
    t, n = voxels.shape[:2]
    if n % dranks:
        raise ValueError(f"a batch of {n} does not divide over {dranks} data ranks")
    per = n // dranks
    voxels = voxels[:, dindex * per:(dindex + 1) * per]
    plan = RowPlan(voxels.shape[-2], model_levels(model), ranks)
    local = shard_rows(voxels, plan, index)
    with row_sharded(plan, group):
        if getattr(model, "is_sequence_model", False):
            out = model(local, generator=generator)["image"]
        else:
            out = run_sequence(model, local, model.initial_state(per, local.shape[-2],
                                                                 local.shape[-1]))[0]
    images = gather_rows(out, plan, group)
    if dranks == 1:
        return images
    parts = [torch.empty_like(images) for _ in range(dranks)]
    dist.all_gather(parts, images.contiguous(), group=dgroup)
    return torch.cat(parts, dim=1)
