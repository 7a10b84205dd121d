"""Device meshes over ``torch.distributed`` processes.

Counterpart of ``gppe_tpu.parallel.mesh``. The two parallel axes of this
domain are the reference's:

* ``probe``: the embarrassingly parallel batch axis (Hutchinson / SLQ
  probe vectors, HMC chains); no communication but final sums and
  gathers;
* ``block``: row-block sharding of the operator and of the Krylov vectors
  over n; a product moves the Krylov block along this axis (a ring of
  sends or an all-gather) and the Lanczos reductions are sums over it.

The program is SPMD over processes: one process per rank, every rank
calling the same entry point with the same host arrays, as a ``torchrun``
job or :func:`spawn` runs it. A :class:`Mesh` is this rank's view: the
(probe, block) shape, its coordinates, one process group per axis (the
ranks that share its other coordinate), its device and the backend.
``torch.distributed.device_mesh.DeviceMesh`` does not stand underneath:
its "cuda" device type assumes one card per rank and NCCL, and ranks that
share one card cannot have NCCL.

The backend is the caller's choice, stated where the process group is
made (:func:`multihost_init`, :func:`spawn`): "nccl" where each rank owns
a card, "gloo" for ranks on the CPU or ranks that share a card
(:func:`backend_for` states the rule). NCCL refuses two ranks on one GPU.
gloo's send and receive take host memory only, so a gloo mesh on CUDA
tensors moves every operand of its collectives through host buffers
itself (pinned, one copy each way) and counts the bytes
(:attr:`Mesh.staged_bytes`): that is the declared transport of such a
mesh, not a fallback.
"""

import datetime
import math
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from ..utils.config import warm_cpu_threads

PROBE_AXIS = "probe"
BLOCK_AXIS = "block"
# how long a rank waits for its peers in a collective before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def mesh_shape(nd, probe=None):
    """``(probe, block)`` of a mesh of ``nd`` ranks: ``probe`` as given,
    by default the largest extent <= sqrt(nd) that divides nd (the
    reference's rule, ``gppe_tpu/parallel/mesh.py:34-47``), so that the
    block axis is at least as large. Raises if ``probe`` does not divide
    ``nd``."""
    nd = int(nd)
    if nd < 1:
        raise ValueError(f"a mesh needs at least one rank; got {nd}")
    if probe is None:
        probe = next(c for c in range(math.isqrt(nd), 0, -1) if nd % c == 0)
    probe = int(probe)
    if probe < 1 or nd % probe:
        raise ValueError(f"probe={probe} does not divide {nd} devices")
    return probe, nd // probe


def backend_for(world_size, device):
    """The backend for ``world_size`` ranks on ``device``: "nccl" where each
    rank owns a CUDA card (no more ranks than the host's cards), "gloo" for
    ranks on the CPU or ranks that share a card."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


class Mesh:
    """One rank's view of a (probe, block) mesh of ranks 0 .. nd - 1, rank
    ``r`` at coordinates ``(r // block, r % block)``.

    ``groups[axis]``: the process group of the ranks that share this
    rank's other coordinate (the group that sums, gathers or rotates
    along ``axis``). The collective helpers take and return tensors on
    this rank's device; on a gloo mesh with a CUDA device each operand
    goes through host memory (``staged_bytes``, ``staged_copies`` count
    what moved each way)."""

    def __init__(self, shape, rank, groups, device, backend):
        probe, block = shape
        self.shape = {PROBE_AXIS: int(probe), BLOCK_AXIS: int(block)}
        self.rank = int(rank)
        self.coords = {PROBE_AXIS: self.rank // self.shape[BLOCK_AXIS],
                       BLOCK_AXIS: self.rank % self.shape[BLOCK_AXIS]}
        self.groups = dict(groups)
        self.device = torch.device(device)
        self.backend = backend
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.staged_bytes = 0
        self.staged_copies = 0

    def rank_at(self, probe_index, block_index):
        """The rank at the given coordinates."""
        return probe_index * self.shape[BLOCK_AXIS] + block_index

    # -- transport ---------------------------------------------------------

    def _to_wire(self, t, fresh=False):
        """``t`` as the backend takes it: a host copy on a staged mesh,
        else ``t`` contiguous (a new tensor with ``fresh``, for a
        collective that writes in place)."""
        if not self.staged or t.device.type != "cuda":
            return (t.clone(memory_format=torch.contiguous_format) if fresh
                    else t.contiguous())
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self._count(host)
        return host

    def _from_wire(self, w, like):
        if w.device == like.device:
            return w
        out = w.to(like.device)
        self._count(w)
        return out

    def _count(self, t):
        self.staged_bytes += t.numel() * t.element_size()
        self.staged_copies += 1

    # -- collectives ---------------------------------------------------------

    def all_reduce(self, t, axis, op="sum"):
        """The sum (or, ``op="max"``, the maximum) of ``t`` over ``axis``;
        ``t`` itself is left as it is."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        w = self._to_wire(t, fresh=True)
        dist.all_reduce(w, op=ops[op], group=self.groups[axis])
        return self._from_wire(w, t)

    def all_gather(self, t, axis):
        """Every rank's ``t`` along ``axis``, concatenated over dim 0 in the
        order of the axis index."""
        size = self.shape[axis]
        w = self._to_wire(t)
        if self.backend == "nccl":
            out = torch.empty((size * w.shape[0], *w.shape[1:]),
                              dtype=w.dtype, device=w.device)
            dist.all_gather_into_tensor(out, w, group=self.groups[axis])
        else:
            parts = [torch.empty_like(w) for _ in range(size)]
            dist.all_gather(parts, w, group=self.groups[axis])
            out = torch.cat(parts)
        return self._from_wire(out, t)

    def ring_start(self, t):
        """Post one step of the block ring: ``t`` to the next block rank,
        the previous block rank's into a new buffer. Returns a handle whose
        ``wait()`` gives the received tensor, on ``t``'s device. Post it
        before the work it should overlap."""
        block = self.shape[BLOCK_AXIS]
        p, b = self.coords[PROBE_AXIS], self.coords[BLOCK_AXIS]
        send = self._to_wire(t)
        recv = torch.empty_like(send)
        group = self.groups[BLOCK_AXIS]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.rank_at(p, (b + 1) % block),
                       group),
            dist.P2POp(dist.irecv, recv, self.rank_at(p, (b - 1) % block),
                       group)])
        return _RingStep(self, reqs, send, recv, t)


class _RingStep:
    def __init__(self, mesh, reqs, send, recv, like):
        self._mesh, self._reqs = mesh, reqs
        self._send, self._recv, self._like = send, recv, like

    def wait(self):
        for req in self._reqs:
            req.wait()
        return self._mesh._from_wire(self._recv, self._like)


def _rank_device(device, backend, rank):
    """This rank's device: the CPU, or the card of its local rank (modulo
    the host's cards: ranks of a gloo mesh may share one; an NCCL rank
    must own its card)."""
    device = torch.device(device)
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("an NCCL mesh runs on CUDA devices; use "
                             "backend 'gloo' for ranks on the CPU")
        return device
    if device.type != "cuda":
        raise ValueError(f"a mesh runs on cpu or cuda, not {device}")
    if device.index is not None:
        return device
    count = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl" and local >= count:
        raise ValueError(
            f"NCCL needs one card per rank: local rank {local} has none of "
            f"this host's {count}; use backend 'gloo' for ranks that share "
            f"a card")
    return torch.device("cuda", local % count)


def make_mesh(n_devices=None, probe=None, *, device="cuda"):
    """A 2-D (probe, block) mesh over the first ``n_devices`` ranks of the
    initialised process group (default: all of them), shaped by
    :func:`mesh_shape`. Every rank of the group must call it, with the
    same arguments, since making a process group is collective: a rank
    outside the first ``n_devices`` gets None. ``device``: "cuda" (the
    card of the rank's local rank) or "cpu"."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh needs an initialised process group "
                         "(multihost_init, torchrun, or spawn)")
    world, rank = dist.get_world_size(), dist.get_rank()
    nd = world if n_devices is None else int(n_devices)
    if not 1 <= nd <= world:
        raise ValueError(f"n_devices={n_devices} is not in 1 .. {world} "
                         f"(the process group's size)")
    shape = mesh_shape(nd, probe)
    n_probe, n_block = shape
    backend = dist.get_backend()
    groups = {}
    # every rank makes every group, in one order
    for p in range(n_probe):
        ranks = [p * n_block + b for b in range(n_block)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[BLOCK_AXIS] = g
    for b in range(n_block):
        ranks = [p * n_block + b for p in range(n_probe)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[PROBE_AXIS] = g
    if rank >= nd:
        return None
    dev = _rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(shape, rank, groups, dev, backend)


def multihost_init(coordinator_address=None, num_processes=None,
                   process_id=None, auto=False, *, backend=None):
    """Initialise the default process group: the replacement for the
    reference's mpirun / PBS layer. A no-op for a single process.
    ``auto=True`` takes ``env://``, the variables ``torchrun`` sets.
    ``coordinator_address``: an init method URL, or "host:port" for
    ``tcp://``. ``backend``: "nccl" or "gloo" (see :func:`backend_for`),
    required whenever a group is made."""
    if not auto and (num_processes is None or num_processes <= 1):
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo'; got {backend!r}")
    if auto:
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
        return
    url = (coordinator_address if "://" in str(coordinator_address)
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=TIMEOUT)


def _rank_main(rank, world_size, backend, workdir, threads):
    torch.set_num_threads(threads)
    # a new process: the first vectorised sqrt of a thread can come back
    # approximate on some hosts (utils.config.warm_cpu_threads)
    warm_cpu_threads()
    with open(os.path.join(workdir, "job.pickle"), "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "store"),
        world_size=world_size, rank=rank, timeout=TIMEOUT)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(workdir, f"rank{rank}.pickle")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def spawn(fn, world_size, backend, *args):
    """Run ``fn(*args)`` on ``world_size`` new processes of one host, each
    a rank of a process group on ``backend``, and return their results,
    rank by rank (each pickled: return host objects).

    The group meets through a ``file://`` store in a temporary directory,
    so no port is opened. ``fn`` must be importable by name in a new
    process (a module-level function). Each rank runs with this process's
    torch thread count. A rank that raises ends the others, and the error
    is raised here."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo'; got {backend!r}")
    with tempfile.TemporaryDirectory(prefix="gppe_spawn_") as workdir:
        # the job goes through a file: through the start pipe, a payload
        # larger than the pipe's buffer would hold each start until the
        # child before it had imported everything
        with open(os.path.join(workdir, "job.pickle"), "wb") as f:
            pickle.dump((fn, args), f)
        torch.multiprocessing.spawn(
            _rank_main, args=(int(world_size), backend, workdir,
                              torch.get_num_threads()),
            nprocs=int(world_size), join=True)
        results = []
        for rank in range(int(world_size)):
            with open(os.path.join(workdir, f"rank{rank}.pickle"),
                      "rb") as f:
                results.append(pickle.load(f))
    return results


# -- a rank's share of a host array (the reference's shardings) -------------

def replicated(mesh, a):
    """The whole array: every rank holds all of it."""
    return a


def row_sharded(mesh, a):
    """This rank's block of rows of ``a`` (n, ...): n / block rows at
    block index times that."""
    block = mesh.shape[BLOCK_AXIS]
    n = a.shape[0]
    if n % block:
        raise ValueError(f"{n} rows do not divide over the block extent "
                         f"{block}")
    n_l = n // block
    i = mesh.coords[BLOCK_AXIS]
    return a[i * n_l:(i + 1) * n_l]


def probe_sharded(mesh, a, axis=1):
    """This rank's share of the probe axis ``axis`` of ``a``."""
    probe = mesh.shape[PROBE_AXIS]
    p = a.shape[axis]
    if p % probe:
        raise ValueError(f"{p} probes do not divide over the probe extent "
                         f"{probe}")
    p_l = p // probe
    i = mesh.coords[PROBE_AXIS]
    index = [slice(None)] * a.ndim
    index[axis] = slice(i * p_l, (i + 1) * p_l)
    return a[tuple(index)]
