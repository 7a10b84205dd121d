"""Plotting utilities (headless-safe).

Counterpart of :mod:`gppe_tpu.utils.plot`, covering the reference's
plotting surface: the matrix spy / matshow (generate_correlation.py:
229-281), the likelihood surfaces (_direct_likelihood.py:411-450,
_profile_likelihood.py:421-450), the smoothed (rho, nu) contour
(FindOptimalCovarianceParameters.py:475-626) and the derivative plot with
its bounds, asymptotes, optimum marker and zoomed inset
(_profile_likelihood.py:548-732). Without a display each figure is saved
as SVG in the working directory (plot_utilities.py:104-143).

matplotlib is imported by :func:`_get_plt` only, when a figure is drawn.
Each plot's numbers come from a plain function that needs no matplotlib
(:func:`likelihood_surface`, :func:`refine_contour_grid`,
:func:`der1_eta_curves`) and returns float64 numpy arrays, so they can be
computed where matplotlib is not installed. The numbers are the port's:
``models.profile_likelihood`` and ``models.direct_likelihood`` on the
float64 host tensors of ``make_spectral_data``, so no drawing code meets
a CUDA tensor.
"""

import numpy as np
import torch

from . import display


def _get_plt():
    """``matplotlib.pyplot`` on the Agg backend when there is no display."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "drawing a figure needs matplotlib, which is not installed; "
            "the plot's numbers need no matplotlib (gppe_tpu_torch.utils."
            "plot.likelihood_surface, refine_contour_grid, "
            "der1_eta_curves)") from exc
    if not display.has_display():
        matplotlib.use("agg")
    import matplotlib.pyplot as plt
    return plt


def _show_or_save(plt, filename, verbose=False):
    if display.has_display():
        plt.show()
    else:
        save_plot(plt, filename, verbose=verbose)


def _host(a):
    """A tensor (any device) or array as a float64 numpy array."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def save_plot(plt, filename, pdf=False, verbose=False):
    """Save ``filename``.svg (and .pdf with ``pdf``) (reference
    plot_utilities.py:104-143)."""
    plt.savefig(filename + ".svg", bbox_inches="tight")
    if pdf:
        plt.savefig(filename + ".pdf", bbox_inches="tight")
    if verbose:
        print(f"saved {filename}.svg")


def plot_matrix(matrix, sparse=False, verbose=False, filename="matrix"):
    """Spy plot of a scipy-sparse matrix, matshow of a dense one (a tensor
    on any device comes to the host first) (reference
    generate_correlation.py:229-281). ``sparse`` is the caller's flag,
    kept for the reference's signature; the matrix's type decides."""
    import scipy.sparse

    plt = _get_plt()
    fig, ax = plt.subplots()
    if scipy.sparse.issparse(matrix):
        ax.spy(matrix, markersize=0.5)
    else:
        im = ax.matshow(_host(matrix))
        fig.colorbar(im, ax=ax)
    ax.set_title("Correlation matrix")
    _show_or_save(plt, filename, verbose=verbose)
    plt.close(fig)


def likelihood_surface(lp_fn, x_vals, y_vals):
    """Z[i, j] = lp_fn(x_vals[j], y_vals[i]), float64 (the numbers of
    :func:`plot_likelihood_surface`)."""
    return np.asarray([[float(lp_fn(x, y)) for x in x_vals]
                       for y in y_vals], dtype=np.float64)


def plot_likelihood_surface(lp_fn, x_vals, y_vals, xlabel, ylabel,
                            optimum=None, filename="log_likelihood"):
    """3-D surface of a likelihood over a parameter grid (role of the
    reference's _direct_likelihood.plot_log_likelihood:411-450). Returns
    Z of :func:`likelihood_surface`."""
    plt = _get_plt()
    Z = likelihood_surface(lp_fn, x_vals, y_vals)
    X, Y = np.meshgrid(x_vals, y_vals)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    p = ax.plot_surface(X, Y, Z, linewidth=0, antialiased=False)
    fig.colorbar(p, ax=ax)
    if optimum is not None:
        ax.scatter([optimum[0]], [optimum[1]], [optimum[2]], color="red")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title("Log likelihood")
    _show_or_save(plt, filename)
    plt.close(fig)
    return Z


def refine_contour_grid(x_vals, y_vals, Z, smooth_sigma=1.0, upsample=4):
    """Gaussian smoothing, then bicubic spline upsampling of a grid
    surface Z (len(x_vals), len(y_vals)) (reference
    FindOptimalCovarianceParameters.py:475-626). Returns (x_f, y_f, Zf),
    float64."""
    from scipy.interpolate import RectBivariateSpline
    from scipy.ndimage import gaussian_filter

    Z = np.asarray(Z, dtype=np.float64)
    Zs = gaussian_filter(Z, sigma=smooth_sigma) if smooth_sigma else Z
    x = np.asarray(x_vals, dtype=np.float64)
    y = np.asarray(y_vals, dtype=np.float64)
    if upsample and upsample > 1 and len(x) > 3 and len(y) > 3:
        spl = RectBivariateSpline(x, y, Zs, kx=3, ky=3)
        x_f = np.linspace(x[0], x[-1], len(x) * upsample)
        y_f = np.linspace(y[0], y[-1], len(y) * upsample)
        return x_f, y_f, spl(x_f, y_f)
    return x, y, Zs


def plot_contour_grid(x_vals, y_vals, Z, xlabel, ylabel, optimum=None,
                      smooth_sigma=1.0, upsample=4,
                      filename="parameter_contour", title=None):
    """Filled contour of a (rho, nu)-style parameter grid, smoothed and
    upsampled by :func:`refine_contour_grid`. Z is (len(x_vals),
    len(y_vals)); returns the refined surface."""
    plt = _get_plt()
    x_f, y_f, Zf = refine_contour_grid(x_vals, y_vals, Z, smooth_sigma,
                                       upsample)
    fig, ax = plt.subplots()
    Xg, Yg = np.meshgrid(x_f, y_f, indexing="ij")
    cs = ax.contourf(Xg, Yg, Zf, levels=30)
    ax.contour(Xg, Yg, Zf, levels=10, colors="black", linewidths=0.4)
    fig.colorbar(cs, ax=ax)
    if optimum is not None:
        ax.plot([optimum[0]], [optimum[1]], "o", color="red",
                markersize=6, label="optimum")
        ax.legend(frameon=False)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    _show_or_save(plt, filename)
    plt.close(fig)
    return Zf


def _has_root(optimal_eta):
    return (optimal_eta is not None and np.isfinite(optimal_eta)
            and optimal_eta > 0)


def der1_eta_curves(data, K, X, z, optimal_eta=None):
    """The numbers of :func:`plot_log_likelihood_der1_eta`, as the
    reference's plot computes them (gppe_tpu/utils/plot.py:147-200), all
    float64 numpy: ``eta`` logspace(-3, 3, 100) and d lp / d eta there
    (``der1``), its analytic ``upper`` and ``lower`` bounds, the
    asymptotes ``asym1``, ``asym2`` over ``eta_asym`` logspace(1, 3, 50)
    with their ``roots1``, ``roots2``; with a finite positive
    ``optimal_eta`` also the inset's ``eta_inset`` (60 points, half a
    decade either side) and ``der1_inset``. ``data`` is a SpectralData
    of float64 host tensors; K, X, z any tensors or arrays."""
    from ..models import profile_likelihood as pl_mod

    eta = np.logspace(-3, 3, 100)
    eta_t = torch.as_tensor(eta, dtype=torch.float64)
    ub, lb = pl_mod.compute_bounds_der1_eta(data, eta_t)
    eta_asym = np.logspace(1, 3, 50)
    asym1, asym2, roots1, roots2 = pl_mod.compute_asymptote_der1_eta(
        K, X, z, eta_asym)
    out = {"eta": eta,
           "der1": _host(pl_mod.log_likelihood_der1_eta(
               data, torch.log10(eta_t))),
           "upper": _host(ub), "lower": _host(lb),
           "eta_asym": eta_asym, "asym1": _host(asym1),
           "asym2": _host(asym2), "roots1": np.asarray(roots1),
           "roots2": np.asarray(roots2)}
    if _has_root(optimal_eta):
        e_in = np.logspace(np.log10(optimal_eta) - 0.5,
                           np.log10(optimal_eta) + 0.5, 60)
        out["eta_inset"] = e_in
        out["der1_inset"] = _host(pl_mod.log_likelihood_der1_eta(
            data, torch.log10(torch.as_tensor(e_in, dtype=torch.float64))))
    return out


def plot_log_likelihood_der1_eta(data, K, X, z, optimal_eta=None,
                                 filename="log_likelihood_first_derivative"):
    """d lp / d eta against eta with the analytic bounds, the large-eta
    asymptotes and a zoomed inset around the root (reference
    _profile_likelihood.py:548-732), drawn from :func:`der1_eta_curves`.
    Returns those curves."""
    plt = _get_plt()
    c = der1_eta_curves(data, K, X, z, optimal_eta)
    fig, ax = plt.subplots()
    ax.semilogx(c["eta"], c["upper"], "--", color="black",
                label="Upper bound")
    ax.semilogx(c["eta"], c["lower"], "-.", color="black",
                label="Lower bound")
    ax.semilogx(c["eta"], c["der1"], color="black", label="Exact")
    ax.semilogx(c["eta_asym"], c["asym1"], color="chocolate",
                label="1st order asymptote")
    ax.semilogx(c["eta_asym"], c["asym2"], color="olivedrab",
                label="2nd order asymptote")
    if _has_root(optimal_eta):
        ax.semilogx([optimal_eta], [0.0], "o", color="black",
                    label=rf"root $\hat\eta = {optimal_eta:.3g}$")
    finite = c["der1"][np.isfinite(c["der1"])]
    lim = max(10.0, np.abs(finite).max() * 0.1) if finite.size else 10.0
    ax.set_ylim([-lim, lim])
    ax.set_xlabel(r"$\eta$")
    ax.set_ylabel(r"$d\ell/d\eta$")
    ax.grid(True)
    ax.legend(frameon=False, fontsize="small")
    if _has_root(optimal_eta):
        # the zoomed inset around the root (the reference's inset_axes
        # block); decoration: a failure to draw it never fails the plot
        try:
            axins = ax.inset_axes([0.12, 0.12, 0.4, 0.3])
            axins.semilogx(c["eta_inset"], c["der1_inset"], color="black")
            axins.axhline(0.0, lw=0.5, color="gray")
            axins.plot([optimal_eta], [0.0], "o", color="black",
                       markersize=3)
            axins.tick_params(labelsize="x-small")
            ax.indicate_inset_zoom(axins, edgecolor="gray")
        except Exception:
            pass
    _show_or_save(plt, filename)
    plt.close(fig)
    return c


def krylov_der1_curve(engine, optimal_eta=None,
                      filename="log_likelihood_first_derivative"):
    """d lp / d eta of a Krylov engine
    (:class:`~gppe_tpu_torch.models.large_scale.KrylovProfileLikelihood`)
    over logspace(-3, 3, 100), with the root marked: the operator route's
    plot, where K has no spectrum for the bounds and asymptotes (the
    reference's spectral plot refuses a matrix-free K). Returns (eta,
    der1), float64."""
    plt = _get_plt()
    eta = np.logspace(-3, 3, 100)
    der1 = np.asarray([engine.der1(le) for le in np.log10(eta)],
                      dtype=np.float64)
    fig, ax = plt.subplots()
    ax.semilogx(eta, der1, color="black", label="Krylov")
    if _has_root(optimal_eta):
        ax.semilogx([optimal_eta], [0.0], "o", color="black",
                    label=rf"root $\hat\eta = {optimal_eta:.3g}$")
    ax.axhline(0.0, lw=0.5, color="gray")
    ax.set_xlabel(r"$\eta$")
    ax.set_ylabel(r"$d\ell/d\eta$")
    ax.grid(True)
    ax.legend(frameon=False, fontsize="small")
    _show_or_save(plt, filename)
    plt.close(fig)
    return eta, der1


def _dense_host(K):
    """A dense float64 numpy K from a tensor or a scipy-sparse matrix."""
    import scipy.sparse

    if scipy.sparse.issparse(K):
        return K.toarray().astype(np.float64)
    return _host(K)


def plot_likelihood_result(likelihood, z, results, engine=None):
    """The dispatcher of ``Likelihood.maximize_log_likelihood(plot=True)``:
    the direct method's lp(sigma, sigma0) surface around the optimum, or
    the profiled method's derivative plot, both on the spectral data
    (float64 host tensors). On the operator route, where K has no
    eigendecomposition, the curve of the fit's Krylov ``engine``."""
    from ..models import direct_likelihood as dl

    if likelihood.operator_mode:
        if engine is None:
            raise ValueError("a matrix-free K is plotted from its Krylov "
                             "engine: pass engine=")
        krylov_der1_curve(engine, optimal_eta=results.get("eta"))
        return
    data = dl.make_spectral_data(likelihood.K_mixed, likelihood.X,
                                 _host(z))
    if likelihood.likelihood_method == "direct":
        sig, sig0 = results["sigma"], results["sigma0"]

        def lp_fn(s, s0):
            return dl.log_likelihood(data, s, s0)

        plot_likelihood_surface(
            lp_fn, np.linspace(max(sig * 0.2, 1e-4), sig * 2, 15),
            np.linspace(max(sig0 * 0.5, 1e-4), sig0 * 1.5, 15),
            r"$\sigma$", r"$\sigma_0$",
            optimum=(sig, sig0, results.get("max_lp", 0.0)))
    else:
        plot_log_likelihood_der1_eta(
            data, _dense_host(likelihood.K), likelihood.X, _host(z),
            optimal_eta=results.get("eta"))
