"""Process-group mesh for the sharded tier.

Counterpart of ``graphem_rapids_tpu/parallel/mesh.py``. The single mesh axis
'edges' partitions the COO edge list, and vertex state is replicated. A mesh
here is the ranks of a ``torch.distributed`` process group, one rank per card
(NCCL) or, in the tests, one rank per CPU process (gloo):

    distributed_init()          # once per process, e.g. under torchrun
    mesh = make_mesh()          # every rank of the default group

Rank r computes on ``cuda:{LOCAL_RANK or r}`` under NCCL and on the CPU under
gloo. The collectives of the sharded step are the methods of ``Mesh``:
tiled ``lax.all_gather`` is ``all_gather_into_tensor``, ``psum`` is
``all_reduce``, ``lax.all_to_all`` is ``all_to_all_single`` and
``ppermute`` is one ``batch_isend_irecv``. Under NCCL each of them is
enqueued on the rank's current stream and waited for by that stream, never
by the host, so a step made of them can be captured in a CUDA graph once
its communicators exist (the first, eager, call creates them); every rank
must then capture and replay the same sequence. ``all_gather_object``
and ``broadcast_object`` move host objects and are for set-up only.

Without an initialized process group, ``default_mesh()`` is a one-rank mesh
on the current card and every collective returns its input, as the JAX
step's one-device shortcuts do. A one-rank group still runs its collectives
through the backend. As everywhere in the package, the CPU is taken only
when asked for: ``device='cpu'``, or a group started with
``backend='gloo'``; without a card anything else raises.

Deliberate difference: JAX's single-process mesh over all the local
devices has no counterpart; one process drives one card.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

EDGE_AXIS = "edges"


def _rank_device(backend, rank):
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return torch.device("cpu")


def distributed_init(backend=None, init_method=None, world_size=None,
                     rank=None):
    """Start the default process group: NCCL on the cards, or gloo on the
    CPU when ``backend='gloo'`` is passed.

    Thin wrapper over ``torch.distributed.init_process_group``; arguments
    left as None are read from the environment (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them). Under NCCL the
    rank's card becomes the current device first; without a card NCCL
    raises. No-op when a group already exists.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "distributed_init: NCCL needs a CUDA card and none is "
                "available; pass backend='gloo' to run the ranks on the CPU"
            )
        r = rank if rank is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(_rank_device(backend, r))
    kwargs = {}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    dist.init_process_group(backend=backend, **kwargs)


class Mesh:
    """The ranks of one process group along the 'edges' axis.

    ``shape`` is ``{'edges': world_size}``, as a JAX mesh's. ``group`` is
    None for the one-rank mesh without a process group, whose collectives
    return their input.
    """

    def __init__(self, world_size=1, rank=0, device=None, group=None):
        if group is None and world_size != 1:
            raise ValueError("a mesh of several ranks needs a process group")
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.device = torch.device("cpu" if device is None else device)
        self.group = group
        # K3's peer regions, one per ring geometry (parallel/ring_binfold.py)
        self.ring_regions = {}

    @property
    def shape(self):
        return {EDGE_AXIS: self.world_size}

    @property
    def platform(self):
        """'cuda' or 'cpu', the type of the rank's device."""
        return self.device.type

    def all_gather(self, x):
        """(world_size, *x.shape): every rank's ``x``, in rank order."""
        if self.group is None:
            return x.unsqueeze(0)
        # the concatenated layout, which both NCCL and gloo accept
        out = torch.empty((self.world_size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        return out.view((self.world_size,) + tuple(x.shape))

    def all_gather_tiled(self, x):
        """Every rank's ``x`` concatenated along dim 0."""
        return self.all_gather(x).reshape((-1,) + tuple(x.shape[1:]))

    def all_reduce(self, x):
        """Sum over ranks (in place on ``x``, which is returned)."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def all_to_all(self, x):
        """Block j of dim 0 goes to rank j; block j of the result came from
        rank j (``x`` has world_size equal blocks along dim 0)."""
        if self.group is None:
            return x
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.group)
        return out

    def send_recv(self, sends, recvs, dst, src):
        """Post one batch: each of ``sends`` to rank ``dst`` and each of
        ``recvs`` from rank ``src``, matched pairwise by tag. Returns the
        works; the caller waits on them before it reads ``recvs`` or writes
        ``sends`` again."""
        ops = [dist.P2POp(dist.isend, t, dst, group=self.group, tag=j)
               for j, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, src, group=self.group, tag=j)
                for j, t in enumerate(recvs)]
        return dist.batch_isend_irecv(ops)

    def broadcast(self, x, src=0):
        """``x`` replaced, in place, by rank ``src``'s value."""
        if self.group is not None:
            dist.broadcast(x, src=src, group=self.group)
        return x

    def all_gather_object(self, obj):
        """Every rank's picklable ``obj``, in rank order (set-up only)."""
        if self.group is None:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj, src=0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    def __repr__(self):
        return (f"Mesh(world_size={self.world_size}, rank={self.rank}, "
                f"device={self.device})")


def _current_device():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh runs on the current CUDA card and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(n_devices=None, group=None, device=None):
    """A mesh over every rank of ``group`` (default: the default group).

    Without an initialized process group this is the one-rank mesh on
    ``device`` (default: the current card; raises without one). In a group
    the rank's device follows the backend: its card under NCCL, the CPU
    under gloo. ``n_devices``, when given, must equal the group's size: a
    mesh cannot leave ranks out.
    """
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a {n_devices}-rank mesh needs an initialized process "
                f"group of {n_devices} ranks (distributed_init)"
            )
        return Mesh(1, 0, device if device is not None else _current_device())
    if group is None:
        group = dist.group.WORLD
    world = dist.get_world_size(group)
    if n_devices not in (None, world):
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {world} ranks"
        )
    rank = dist.get_rank(group)
    if device is None:
        device = _rank_device(dist.get_backend(group), dist.get_rank())
    return Mesh(world, rank, device, group)


def default_mesh(device=None):
    """Every rank of the default process group, or one rank without one."""
    return make_mesh(device=device)


def mesh_is_multiprocess(mesh):
    """True when the mesh spans other processes (more than one rank)."""
    return mesh.world_size > 1


def replicate_to_mesh(x, mesh):
    """``x`` as a tensor on the rank's device holding rank 0's value on
    every rank."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    t = torch.as_tensor(x, device=mesh.device).clone()
    return mesh.broadcast(t, src=0)
