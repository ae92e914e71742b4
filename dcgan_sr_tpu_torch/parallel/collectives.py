"""Collectives over a data-parallel mesh (port of
dcgan_sr_tpu/parallel/collectives.py): the one place the port calls into
`torch.distributed`.  Each function takes the `Mesh` (parallel/mesh.py)
where the JAX function takes an axis name.

Differentiating through a collective: JAX transposes `psum` (and so
`pmean`) into a sum across replicas, so each replica differentiates the SUM
of the replicas' losses; the step's final gradient pmean then gives the
single-device gradient.  `psum` of a tensor is therefore an autograd
function whose forward and backward are both a SUM all_reduce
(`_SumAcrossRanks`); cross-replica batch norm (ops/nn.py) reaches it
through `pmean`.  A list of tensors is reduced as one flattened buffer, one
collective for the whole list, outside autograd (the step's gradient and
metric pmeans).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _SumAcrossRanks(torch.autograd.Function):
    """y = sum over ranks of x; its transpose, the backward, is the same
    sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _flat_sum(tensors, mesh, scale=None):
    """One all_reduce over the tensors (one dtype) packed into one buffer;
    the results in their shapes, times `scale`."""
    with torch.no_grad():
        buf = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(buf, group=mesh.group)
        if scale is not None:
            buf.mul_(scale)
        out, i = [], 0
        for t in tensors:
            out.append(buf[i:i + t.numel()].view(t.shape))
            i += t.numel()
    return out


def psum(x, mesh):
    """Sum over the mesh's ranks: a tensor (differentiable), or a list of
    tensors as one collective."""
    if isinstance(x, (list, tuple)):
        return _flat_sum(x, mesh)
    return _SumAcrossRanks.apply(x, mesh.group)


def pmean(x, mesh):
    """Mean over the mesh's ranks (psum / size), as psum."""
    if isinstance(x, (list, tuple)):
        return _flat_sum(x, mesh, 1.0 / mesh.size)
    return psum(x, mesh) / mesh.size


def all_gather(x, mesh, *, axis=0, tiled=True):
    """Every rank's x, concatenated along `axis` in rank order (`tiled`) or
    stacked on a new `axis`."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _peer(mesh, r):
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def ppermute(x, mesh, perm):
    """x sent along the (source, destination) pairs of `perm` (mesh ranks);
    a rank that no pair sends to gets zeros, as in JAX."""
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == mesh.rank == dst:
            out.copy_(x)
        elif src == mesh.rank:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  _peer(mesh, dst), mesh.group))
        elif dst == mesh.rank:
            ops.append(dist.P2POp(dist.irecv, out, _peer(mesh, src),
                                  mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def reduce_scatter(x, mesh, *, scatter_dimension=0):
    """This rank's block of the sum over ranks, split along
    `scatter_dimension` into `size` equal blocks (JAX's tiled psum_scatter)."""
    if x.shape[scatter_dimension] % mesh.size:
        raise ValueError(f"dimension {scatter_dimension} of {tuple(x.shape)} "
                         f"does not split into {mesh.size} blocks")
    return psum(x, mesh).chunk(mesh.size, scatter_dimension)[mesh.rank] \
        .contiguous()


def broadcast_(tensors, mesh, src=0):
    """Overwrite each tensor, in place, with rank `src`'s value."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.detach(), _peer(mesh, src),
                           group=mesh.group)


def axis_index(mesh):
    return mesh.rank


def axis_size(mesh):
    return mesh.size
