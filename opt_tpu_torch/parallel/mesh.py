"""Multi-device solves: a grid cut into slabs along its leading array axis
(port of opt_tpu/parallel/mesh.py).

The JAX package shards a solve over a device mesh: each device owns a
contiguous block of rows (the D planes of a volume), stencil reads cross
the blocks by halo exchanges, and the solver's sums reduce over the mesh
(opt_tpu/parallel/halo.py, stream_shard.py).  The port keeps that
decomposition and names the pieces: a mesh is a 1-D chain of n slabs, and
every local tensor carries a leading slab axis S, (S, n_local, ...).  The
solver runs on two operations of the mesh:

  ext(a, he)  the halo exchange: (S, n_local, ...) -> (S, n_local + 2 he,
              ...), each slab with its neighbours' he edge rows appended
              above and below, and zeros past the global edges
              (lax.ppermute's semantics, opt_tpu/parallel/halo.py:112-125);
  psum(v)     the global sum of per-slab partials v of shape (S,).

A mesh has two forms, and the loops are written once against them:

  slab form   make_mesh(n, device=...): all n slabs in one process on one
              device (S = n).  ext is a shifted copy along the slab axis,
              psum a plain sum in slab order.  One card holds every slab:
              NCCL puts no two ranks on one GPU.
  group form  make_mesh(group=...): one slab per rank of a
              torch.distributed process group (S = 1).  ext sends and
              receives the edge rows with the two neighbours
              (batch_isend_irecv), psum is an all_reduce.

No collectives inside a kernel: a kernel runs over the slabs that one
process holds, one slab per blockIdx.z.

Unlike the JAX package there is no GSPMD: torch cannot partition a program
by annotations, so every sharded solve runs the explicit halo path
(parallel/halo.py) or a streamed engine (parallel/stream_shard.py).
"""

from __future__ import annotations

import math

import torch


class SlabMesh:
    """n slabs of a grid, S of them in this process, the first of which is
    slab `first` of the chain; tensors live on `device`."""

    def __init__(self, n, device, group=None):
        self.n = n
        self.device = torch.device(device)
        self.group = group
        if group is None:
            self.S, self.first = n, 0
        else:
            import torch.distributed as dist

            self.S, self.first = 1, dist.get_rank(group)

    # -- the two operations ----------------------------------------------

    def ext(self, a, he):
        """(S, n_local, ...) -> (S, n_local + 2 he, ...): the halo rows from
        the neighbour slabs, zeros past the global edges."""
        if he == 0:
            return a
        S, n = a.shape[:2]
        out = a.new_empty((S, n + 2 * he) + tuple(a.shape[2:]))
        out[:, he:he + n] = a
        if self.group is None:
            out[0, :he] = 0
            out[1:, :he] = a[:-1, n - he:]
            out[-1, he + n:] = 0
            out[:-1, he + n:] = a[1:, :he]
            return out
        up, dn = self._exchange(a[0, n - he:], a[0, :he])
        out[0, :he] = 0 if up is None else up
        out[0, he + n:] = 0 if dn is None else dn
        return out

    def _exchange(self, last, first):
        """Send this slab's last rows down the chain and its first rows up;
        return the rows received from above and from below (None at a
        global edge)."""
        import torch.distributed as dist

        rank, ops = self.first, []
        up = dn = None
        peer = lambda r: dist.get_global_rank(self.group, r)
        if rank > 0:
            up = torch.empty_like(last)
            ops += [dist.P2POp(dist.isend, first.contiguous(), peer(rank - 1),
                               self.group),
                    dist.P2POp(dist.irecv, up, peer(rank - 1), self.group)]
        if rank < self.n - 1:
            dn = torch.empty_like(first)
            ops += [dist.P2POp(dist.isend, last.contiguous(), peer(rank + 1),
                               self.group),
                    dist.P2POp(dist.irecv, dn, peer(rank + 1), self.group)]
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return up, dn

    def psum(self, v):
        """The 0-d global sum of per-slab partials v, shape (S,)."""
        total = v.sum()
        if self.group is not None:
            import torch.distributed as dist

            total = total.reshape(1)
            dist.all_reduce(total, group=self.group)
            total = total[0]
        return total

    # -- slabs of global arrays --------------------------------------------

    def shard(self, arr):
        """A global array (H, ...) as this process's slabs (S, n_local,
        ...)."""
        n_local = arr.shape[0] // self.n
        rows = arr[self.first * n_local:(self.first + self.S) * n_local]
        return rows.reshape((self.S, n_local) + tuple(arr.shape[1:]))

    def gather(self, a):
        """This process's slabs (S, n_local, ...) back as the global array
        (H, ...): a reshape in the slab form, an all_gather in the group
        form."""
        flat = a.reshape((-1,) + tuple(a.shape[2:]))
        if self.group is None:
            return flat
        import torch.distributed as dist

        parts = [torch.empty_like(flat) for _ in range(self.n)]
        dist.all_gather(parts, flat.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n=None, device="cuda", shape=None, group=None):
    """A chain of slabs.

    make_mesh(n, device=...) is the slab form: n slabs in this process on
    one device ("cuda" by default; it raises where torch sees none).
    shape=(a, b) asks for a 2-D mesh, which is flattened row-major into
    a * b slabs (as opt_tpu/parallel/dispatch.py:_flat_mesh does).  make_mesh(group=g, device=...) is the group form over a
    torch.distributed process group (dist.group.WORLD for the default
    one): one slab per rank, the chain in rank order."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch sees no CUDA device")
    if shape is not None:
        if n is not None and n != math.prod(shape):
            raise ValueError(f"n={n} does not match shape {shape}")
        n = math.prod(shape)
    if group is not None:
        import torch.distributed as dist

        size = dist.get_world_size(group)
        if n is not None and n != size:
            raise ValueError(f"{n} slabs asked for, but the group has "
                             f"{size} ranks")
        return SlabMesh(size, dev, group=group)
    if not n or n < 1:
        raise ValueError("make_mesh needs n >= 1 slabs (or a group)")
    return SlabMesh(int(n), dev)


class SlabLayout:
    """The local unknown vector of a sharded solve: every unknown's slabs
    (S, n_local, ..., C), flattened and concatenated in declaration order.
    In the slab form this is the global flat layout itself (the slabs
    tile the leading axis), so the solver state needs no reordering."""

    def __init__(self, unknown_shapes, mesh):
        self.mesh = mesh
        self.shapes = {}
        self.offsets = {}
        o = 0
        for name, s in unknown_shapes.items():
            self.shapes[name] = (mesh.S, s[0] // mesh.n) + tuple(s[1:])
            self.offsets[name] = o
            o += math.prod(self.shapes[name])
        self.size = o

    def views(self, buf):
        """name -> (S, n_local, ..., C) view of a local flat vector."""
        return {n: buf[o:o + math.prod(s)].view(s)
                for (n, s), o in zip(self.shapes.items(),
                                     self.offsets.values())}

    def pack(self, tree):
        return torch.cat([tree[n].reshape(-1) for n in self.shapes])

    def partials(self, v):
        """(S,) per-slab sums of a local flat vector."""
        S = self.mesh.S
        return sum(a.reshape(S, -1).sum(1) for a in self.views(v).values())

    def dot(self, a, b):
        """The global <a, b>: per-slab partials summed over the mesh."""
        return self.mesh.psum(self.partials(a * b))

    def shard(self, x, global_layout):
        """The global flat vector as this process's local one."""
        return self.pack({n: self.mesh.shard(v)
                          for n, v in global_layout.views(x).items()})

    def gather(self, v):
        """The local flat vector back in the global flat layout."""
        return torch.cat([self.mesh.gather(a).reshape(-1)
                          for a in self.views(v).values()])


def shard_problem(mesh, data):
    """The bound inputs' constant images as this process's slabs (port of
    opt_tpu/parallel/mesh.py:shard_problem; params stay whole).  Graph
    inputs have no slab form (parallel/dispatch.py raises first)."""
    return {"images": {n: mesh.shard(a) for n, a in data["images"].items()},
            "params": data["params"], "graph_indices": {},
            "graph_incidence": {}}
