"""Job inputs, made from the seed: a frozen copy of the data function and
basis of ``gppe_tpu_torch/utils/data.py`` (the reference's
``examples/_utilities/data_utilities.py``), so that a later change to the
program cannot change what the benchmark feeds it.

A job's inputs depend on ``(seed, job index)`` alone: the points (new for
every job where the configuration draws them, the same grid where it does
not), ``z = sum_d sin(pi x_d) + noise N(0, 1)``, the degree-``p`` polynomial
basis ``X``, and the engine's random block (Rademacher probes and a normal
deflation start), drawn on the job's device by a ``torch.Generator``. The
program gets the host arrays and the device block; the reference gets the
same.
"""

from dataclasses import dataclass

import numpy as np
import torch

# job index of the warm-up jobs' inputs: far from any window's jobs
WARM_JOB_BASE = 1 << 30


def grid_points(side, dimension=2):
    """The regular grid of ``side`` points per axis on the unit cube, in the
    reference generator's order (``grid=True``)."""
    axis = np.linspace(0, 1, side)
    mesh = np.meshgrid(*np.tile(axis, (dimension, 1)))
    return np.stack([m.ravel() for m in mesh], axis=1).astype(float)


def polynomial_basis(points, degree):
    """All monomials of total degree <= ``degree``, in the reference
    generator's column order (``trigonometric=False``)."""
    points = np.asarray(points)
    n, dimension = points.shape
    powers_mesh = np.meshgrid(*np.tile(np.arange(degree + 1),
                                       (dimension, 1)))
    powers = np.array([m.ravel() for m in powers_mesh])
    powers = powers[:, powers.sum(axis=0) <= degree]
    X = np.ones((n, powers.shape[1]))
    for j in range(powers.shape[1]):
        for i in range(dimension):
            X[:, j] *= points[:, i] ** powers[i, j]
    return X


def _rng(seed, job, stream):
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), int(job),
                                  stream])


def _torch_seed(seed, job):
    return int(np.random.SeedSequence(
        [int(seed) & ((1 << 64) - 1), int(job), 7]).generate_state(
            1, dtype=np.uint64)[0]) & ((1 << 63) - 1)


@dataclass
class Job:
    index: int
    points: np.ndarray      # (n, d) float64
    z: np.ndarray           # (n,) float64
    X: np.ndarray           # (n, m) float64
    probes: torch.Tensor    # (n, p) on the device, the engine's dtype
    v_defl: torch.Tensor    # (n, 1) on the device, the engine's dtype


class JobMaker:
    """Makes each job's inputs from ``(seed, job index)`` for one
    configuration; what every job shares (a fixed grid, its basis and its
    noise-free field) is made once."""

    def __init__(self, config, num_probes, seed, device,
                 dtype=torch.float32):
        self.config = config
        self.num_probes = int(num_probes)
        self.seed = int(seed)
        self.device = device
        self.dtype = dtype
        spec = config["points"]
        self.dimension = int(spec["dimension"])
        if spec["kind"] == "grid":
            self._fixed = grid_points(int(spec["side"]), self.dimension)
            self._fixed_X = polynomial_basis(self._fixed,
                                             int(config["basis_degree"]))
            self._fixed_field = np.sin(self._fixed * np.pi).sum(axis=1)
        elif spec["kind"] == "uniform":
            self._fixed = None
        else:
            raise ValueError(f"unknown points kind {spec['kind']!r}")

    @property
    def n(self):
        spec = self.config["points"]
        if spec["kind"] == "grid":
            return int(spec["side"]) ** self.dimension
        return int(spec["n"])

    def make(self, index):
        noise = float(self.config["noise"])
        if self._fixed is None:
            points = _rng(self.seed, index, 0).random((self.n,
                                                       self.dimension))
            X = polynomial_basis(points, int(self.config["basis_degree"]))
            field = np.sin(points * np.pi).sum(axis=1)
        else:
            points, X, field = self._fixed, self._fixed_X, self._fixed_field
        z = field + noise * _rng(self.seed, index, 1).standard_normal(self.n)
        gen = torch.Generator(device=self.device).manual_seed(
            _torch_seed(self.seed, index))
        draw = torch.randint(0, 2, (self.n, self.num_probes), generator=gen,
                             device=self.device)
        probes = (2 * draw - 1).to(self.dtype)
        v_defl = torch.randn((self.n, 1), generator=gen, device=self.device,
                             dtype=self.dtype)
        return Job(index, points, z, X, probes, v_defl)
