"""Multi-device scaling harness: the twin of the reference's
``drivers/scaling_efficiency.py``.

Measures the sharded profile-likelihood step
(:func:`gppe_tpu_torch.parallel.sharded.build_sharded_profile_step`) on
meshes of 1, 2 and 4 ranks on one problem (strong scaling) with its
efficiency, and (:func:`main_artifact`) the samplers' samples/s with the
chains over the mesh and the ring against the all-gather schedule.

Each entry point starts the ranks itself, through
:func:`gppe_tpu_torch.parallel.mesh.spawn` on one host: one launch of as
many ranks as the largest mesh, each mesh made of its first ranks (the
others wait at a barrier). The backend follows
:func:`~gppe_tpu_torch.parallel.mesh.backend_for`: NCCL where every rank
owns a card, gloo where ranks share one card or run on the CPU. Each
result carries its grade: "perf" only where every rank owns its card,
"correctness" where ranks share a card or the CPU (the times then say
that the sharded programs run and agree at every rank count, not how
they scale). The device is the caller's (the card by default); nothing
here forces the CPU. No file is written unless a path is given.

    python -m gppe_tpu_torch.drivers.scaling_efficiency [--n 4096]
        [--comm ring|allgather] [--artifact PATH] [--device cuda|cpu]
"""

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_mod
from ..parallel import sharded
from ..utils import data as data_utils

DEVICE_COUNTS = (1, 2, 4)


def grade(world_size, device):
    """"perf" where each of ``world_size`` ranks owns a CUDA card, else
    "correctness"."""
    return ("perf" if mesh_mod.backend_for(world_size, device) == "nccl"
            else "correctness")


def _dtype(device):
    # the kernels' float32 on the card; float64 on the CPU, as the tests
    return torch.float32 if torch.device(device).type == "cuda" else \
        torch.float64


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(n_devices, n, lanczos_steps=24, reps=3, probes_per_dev=8,
            comm="ring", *, device="cuda"):
    """Seconds per sharded profile step on the mesh of the first
    ``n_devices`` ranks of the initialised process group, on the
    reference's problem (n random 2-D points, ``RandomState(0)``, nu 1/2,
    rho 0.1, etas 0.1, 1, 10). Every rank of the group calls it; a rank
    outside the mesh gets None, the others ``{"seconds", "der1",
    "traceinv", "logdet"}`` (this rank's seconds a step after one warm
    step; the step's outputs, whole on every rank)."""
    mesh = mesh_mod.make_mesh(n_devices, device=device)
    if mesh is None:
        return None
    probe_ext = mesh.shape[mesh_mod.PROBE_AXIS]
    rng = np.random.RandomState(0)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    probes = rng.choice([-1.0, 1.0], size=(n, probes_per_dev * probe_ext))
    etas = np.asarray([0.1, 1.0, 10.0])
    step = sharded.build_sharded_profile_step(
        mesh, nu=0.5, lanczos_steps=lanczos_steps, comm=comm,
        dtype=_dtype(mesh.device))
    args = (pts, [0.1, 0.1], X, z, probes, etas)
    step(*args)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(*args)
    _sync(mesh.device)
    seconds = (time.perf_counter() - t0) / reps
    return {"seconds": seconds, **dict(zip(("der1", "traceinv", "logdet"),
                                           (o.tolist() for o in out)))}


def _main_ranks(counts, n, comm, device):
    out = {}
    for nd in counts:
        out[nd] = measure(nd, n, comm=comm, device=device)
        dist.barrier()
    return out


def main(n=4096, device_counts=DEVICE_COUNTS, verbose=True, comm="ring", *,
         device="cuda"):
    """Strong scaling of the sharded step at ``device_counts`` ranks: one
    launch of max(device_counts) ranks (:func:`measure` on each mesh).
    Returns ``{"grade", "platform", "backend", nd: {"seconds",
    "efficiency", "der1", "traceinv", "logdet"}}`` with the seconds of the
    mesh's slowest rank and the outputs of its rank 0."""
    device = torch.device(device)
    world = max(device_counts)
    backend = mesh_mod.backend_for(world, device)
    results = {"grade": grade(world, device),
               "platform": "gpu" if device.type == "cuda" else "cpu",
               "backend": backend}
    if verbose:
        print(f"measurement grade: {results['grade']} ({world} ranks, "
              f"{backend}, {device.type})")
    ranks = mesh_mod.spawn(_main_ranks, world, backend, tuple(device_counts),
                           n, comm, device)
    t1 = None
    for nd in device_counts:
        per_rank = [r[nd] for r in ranks if r[nd] is not None]
        t = max(r["seconds"] for r in per_rank)
        eff = t1 / (t * nd) if t1 is not None else 1.0
        t1 = t if t1 is None else t1
        results[nd] = {**per_rank[0], "seconds": t, "efficiency": eff}
        if verbose:
            print(f"{nd} ranks: {t * 1e3:.1f} ms/step, efficiency "
                  f"{eff:.2f} [{results['grade']}-grade]")
    return results


def measure_sampler(n_devices, num_chains=64, num_samples=100,
                    num_warmup=50, n_side=20, surface=None, *,
                    device="cuda"):
    """Samples/s of ``hmc.sample_posterior_large`` with the chains over the
    mesh of the first ``n_devices`` ranks (their probe axis), on a
    ``KrylovPosteriorSurface`` of an ``n_side`` x ``n_side`` grid. Every
    rank of the group calls it. Returns (samples/s or None outside the
    mesh, surface): pass the surface back to reuse it across meshes (the
    target does not depend on them)."""
    from ..models import hmc
    from ..models.krylov_posterior import KrylovPosteriorSurface

    pts = data_utils.generate_points(n_side, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    mesh = mesh_mod.make_mesh(n_devices, device=device)
    if mesh is None:
        return None, surface
    if surface is None:
        surface = KrylovPosteriorSurface(pts, z, X, nu=0.5,
                                         log10_rho_bounds=(-1.5, -0.5),
                                         device=mesh.device)
    kwargs = dict(nu=0.5, num_chains=num_chains, num_samples=num_samples,
                  num_warmup=num_warmup, key=0, surface=surface, mesh=mesh,
                  log10_eta_bounds=(-3.0, 4.0), device=mesh.device)
    hmc.sample_posterior_large(pts, z, X, **kwargs)        # warm
    _sync(mesh.device)
    t0 = time.perf_counter()
    hmc.sample_posterior_large(pts, z, X, **kwargs)
    _sync(mesh.device)
    return num_chains * num_samples / (time.perf_counter() - t0), surface


def _artifact_ranks(counts, n_step, num_chains, device):
    sampler, surface = {}, None
    for nd in counts:
        sampler[nd], surface = measure_sampler(nd, num_chains=num_chains,
                                               surface=surface,
                                               device=device)
        dist.barrier()
    step = {comm: measure(max(counts), n_step, lanczos_steps=16, reps=3,
                          comm=comm, device=device)["seconds"]
            for comm in ("ring", "allgather")}
    return sampler, step


def main_artifact(n_step=8192, num_chains=64, out_path=None, verbose=True,
                  *, device="cuda", device_counts=DEVICE_COUNTS):
    """(a) HMC samples/s with the chains over meshes of ``device_counts``
    ranks; (b) the ring against the all-gather step at the largest mesh,
    n = ``n_step``. Graded as :func:`main`; written as JSON to
    ``out_path`` if given. Returns the record."""
    device = torch.device(device)
    world = max(device_counts)
    backend = mesh_mod.backend_for(world, device)
    out = {"grade": grade(world, device),
           "platform": "gpu" if device.type == "cuda" else "cpu",
           "backend": backend,
           "sampler": {"num_chains": num_chains, "per_device": {}},
           "step_n": n_step, "step": {}}
    ranks = mesh_mod.spawn(_artifact_ranks, world, backend,
                           tuple(device_counts), n_step, num_chains, device)
    base = None
    for nd in device_counts:
        sps = min(r[0][nd] for r in ranks if r[0][nd] is not None)
        eff = sps / (base * nd) if base is not None else 1.0
        base = sps if base is None else base
        out["sampler"]["per_device"][str(nd)] = {
            "samples_per_s": sps, "efficiency_vs_1dev": eff}
        if verbose:
            print(f"sampler {nd} ranks: {sps:.1f} samples/s "
                  f"({num_chains} chains) [{out['grade']}-grade]")
    for comm in ("ring", "allgather"):
        out["step"][comm] = max(r[1][comm] for r in ranks)
        if verbose:
            print(f"step {comm} @ {world} ranks, n={n_step}: "
                  f"{out['step'][comm]:.3f}s")
    out["step"]["ring_minus_allgather_s"] = (out["step"]["ring"]
                                             - out["step"]["allgather"])
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        if verbose:
            print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--comm", choices=["ring", "allgather"], default="ring",
                   help="the products' communication schedule")
    p.add_argument("--artifact", metavar="PATH",
                   help="write the sampler scaling and the ring against "
                        "the all-gather step as JSON to PATH")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    if a.artifact:
        main_artifact(out_path=a.artifact, device=a.device)
    else:
        main(a.n, comm=a.comm, device=a.device)
