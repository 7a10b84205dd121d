"""Synthetic data generators matching the reference's example utilities.

Bit-for-bit port of the *semantics* of
reference examples/_utilities/data_utilities.py:22-185 (structured grid /
random points in the unit hypercube; z = sum_d sin(pi x_d) + noise with
numpy seed 31; polynomial + trigonometric basis for the linear mean model)
so that golden comparisons against the reference pickles are meaningful.
Host-side numpy by design — data generation feeds the device pipeline.
"""

import numpy as np


def generate_points(num_points, dimension=2, grid=True, seed=None):
    """Points in the unit hypercube: a structured grid with num_points per
    axis (n = num_points**dimension) or uniform random
    (reference data_utilities.py:22-69)."""
    if grid:
        axis = np.linspace(0, 1, num_points)
        axes = np.tile(axis, (dimension, 1))
        mesh = np.meshgrid(*axes)
        n = num_points ** dimension
        points = np.empty((n, dimension), dtype=float)
        for i in range(dimension):
            points[:, i] = mesh[i].ravel()
    else:
        rng = np.random.RandomState(seed)
        points = rng.rand(num_points, dimension)
    return points


def generate_data(points, noise_magnitude, seed=31):
    """z = sum_d sin(pi x_d) + noise * N(0,1) with the reference's fixed
    seed 31 (data_utilities.py:76-129)."""
    points = np.asarray(points)
    z = np.sin(points * np.pi).sum(axis=1)
    rng = np.random.RandomState(seed)
    z = z + noise_magnitude * rng.randn(points.shape[0])
    return z


def generate_basis_functions(points, polynomial_degree=2,
                             trigonometric=False):
    """Design matrix X of all monomials with total degree <=
    polynomial_degree, optionally plus sin/cos of each coordinate
    (reference data_utilities.py:136-185)."""
    points = np.asarray(points)
    n, dimension = points.shape

    powers_array = np.arange(polynomial_degree + 1)
    powers_tile = np.tile(powers_array, (dimension, 1))
    powers_mesh = np.meshgrid(*powers_tile)
    powers_ravel = np.array([powers_mesh[i].ravel()
                             for i in range(dimension)])
    powers_sum = powers_ravel.sum(axis=0)
    powers = powers_ravel[:, powers_sum <= polynomial_degree]

    num_basis = powers.shape[1]
    X = np.ones((n, num_basis), dtype=float)
    for j in range(num_basis):
        for i in range(dimension):
            X[:, j] *= points[:, i] ** powers[i, j]

    if trigonometric:
        X_trig = np.empty((n, 2 * dimension))
        for i in range(dimension):
            X_trig[:, 2 * i] = np.sin(points[:, i] * np.pi)
            X_trig[:, 2 * i + 1] = np.cos(points[:, i] * np.pi)
        X = np.c_[X, X_trig]

    return X
