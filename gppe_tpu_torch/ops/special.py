"""Special functions needed by the Matern kernel, on torch tensors.

Counterpart of :mod:`gppe_tpu.ops.special`: the modified Bessel function of
the second kind K_nu and the Gamma function, written from scratch because
torch has no real-order ``kv``. The algorithm is the reference's (Temme /
Thompson-Barnett, as in Numerical Recipes' ``bessik``):

* reduce the order to ``mu in [-1/2, 1/2]`` with ``nu = mu + nl``;
* small argument (x < 2): Temme's series for K_mu and K_{mu+1};
* large argument (x >= 2): Steed's continued fraction CF2, e^x-scaled;
* upward recurrence K_{mu+j+1} = 2(mu+j)/x K_{mu+j} + K_{mu+j-1},
  renormalized at every step, its magnitude carried in a log-scale.

A converged lane leaves its series loop with the state of the step where it
converged, as the reference's freeze keeps it, and the loop stops once
every lane has left: the same values and derivatives. Inside a
``torch.func`` transform (``vmap``, ``jacfwd``, ``jvp``, ``grad``) every loop
runs its full count instead, converged lanes frozen by ``torch.where`` and
both branches evaluated on clamped arguments, as the reference runs them:
no Python branch reads a tensor's value, so ``vmap`` (and ``jacfwd``,
which is a vmap) can batch it; the values are the same. Everything is
differentiable in nu and x, by autograd and by ``torch.func.jvp`` (forward
mode, which the posterior over nu needs: reverse mode through ~200 loop
steps is what blew up memory on the TPU).

This is also the plain version of the general-nu CUDA kernel
(``csrc/matern_general.cu``): :func:`gppe_tpu_torch.ops.kernels.matern`
evaluates general nu through :func:`log_kv`.
"""

import math

import torch

_EULER_GAMMA = 0.57721566490153286060651209008240243


def _as_tensor(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def gamma(x):
    """Gamma function for positive real x (via exp(lgamma))."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.double()
    return torch.exp(torch.lgamma(x))


def _chepolish(x):
    """gam1(x) = [1/Gamma(1-x) - 1/Gamma(1+x)] / (2x) and
    gam2(x) = [1/Gamma(1-x) + 1/Gamma(1+x)] / 2 for |x| <= 1/2; gam1's
    removable singularity at 0 (limit -EulerGamma) is taken below 1e-4."""
    rg_plus = torch.exp(-torch.lgamma(1.0 + x))    # 1/Gamma(1+x)
    rg_minus = torch.exp(-torch.lgamma(1.0 - x))   # 1/Gamma(1-x)
    gam2 = 0.5 * (rg_minus + rg_plus)
    small = torch.abs(x) < 1e-4
    x_safe = torch.where(small, torch.ones_like(x), x)
    gam1_direct = (rg_minus - rg_plus) / (2.0 * x_safe)
    gam1 = torch.where(small, torch.full_like(x, -_EULER_GAMMA), gam1_direct)
    return gam1, gam2


def _safe_ratio(num_fn, arg):
    """num_fn(arg) / arg with 1 where |arg| < 1e-30 (both sides guarded,
    so no NaN reaches a gradient)."""
    tiny = torch.abs(arg) < 1e-30
    safe = torch.where(tiny, torch.ones_like(arg), arg)
    return torch.where(tiny, torch.ones_like(arg), num_fn(safe) / safe)


def _run_series(state, consts, step, first, last, fixed_trips=False):
    """Run ``step(i, state, consts) -> (state, converged)`` for i = first ..
    last over lanes and return each lane's state from the step where it
    converged, or after the last step. ``state`` and ``consts`` (per-lane
    values the step reads) are tuples of 1-D tensors.

    A converged lane leaves: its state goes into the result and the steps
    run on the other lanes only. That is the reference's freeze (a
    converged lane keeps its state) at the cost of the lanes still
    running; values and derivatives are the same. ``fixed_trips``: every
    lane runs every step, the ones converged before it keeping their state
    through ``torch.where`` (the reference's form, batchable by vmap)."""
    if fixed_trips:
        done = torch.zeros_like(state[0], dtype=torch.bool)
        for i in range(first, last + 1):
            new, converged = step(i, state, consts)
            state = tuple(torch.where(done, old, v)
                          for old, v in zip(state, new))
            done = done | converged
        return list(state)
    idx = torch.arange(state[0].shape[0], device=state[0].device)
    out = list(state)
    for i in range(first, last + 1):
        state, converged = step(i, state, consts)
        if bool(converged.any()):
            out = [o.index_put((idx[converged],), v[converged])
                   for o, v in zip(out, state)]
            keep = ~converged
            idx = idx[keep]
            if idx.numel() == 0:
                return out
            state = tuple(v[keep] for v in state)
            consts = tuple(v[keep] for v in consts)
    return [o.index_put((idx,), v) for o, v in zip(out, state)]


def _kv_temme_small(mu, x, n_terms=30, fixed_trips=False):
    """Temme series: K_mu(x), K_{mu+1}(x) for x < 2, |mu| <= 1/2; mu and x
    are tensors of the lanes (1-D, or any shape with ``fixed_trips``)."""
    x2 = 0.5 * x
    pimu = math.pi * mu
    fact = 1.0 / _safe_ratio(torch.sin, pimu)   # pimu / sin(pimu), 1 at 0
    d = -torch.log(x2)
    e = mu * d
    fact2 = _safe_ratio(torch.sinh, e)
    gam1, gam2 = _chepolish(mu)
    gampl = gam2 - mu * gam1   # 1/Gamma(1+mu)
    gammi = gam2 + mu * gam1   # 1/Gamma(1-mu)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    e = torch.exp(e)
    p = 0.5 * e / gampl
    q = 0.5 / (e * gammi)
    eps = torch.finfo(x.dtype).eps

    def step(i, state, consts):
        ff, p, q, c, s, s1 = state
        mu, dd = consts
        ff = (i * ff + p + q) / (i * i - mu * mu)
        c = c * (dd / i)
        p = p / (i - mu)
        q = q / (i + mu)
        dl = c * ff
        s = s + dl
        dl1 = c * (p - i * ff)
        s1 = s1 + dl1
        # BOTH series must have converged, or the derivative chain of s1
        # is cut (see _kv_cf2_large)
        converged = ((torch.abs(dl) < torch.abs(s) * eps)
                     & (torch.abs(dl1) < torch.abs(s1) * eps))
        return (ff, p, q, c, s, s1), converged

    state = (ff, p, q, torch.ones_like(ff), ff, p)
    *_, s, s1 = _run_series(state, (mu, x2 * x2), step, 1, n_terms,
                            fixed_trips)
    return s, s1 * 2.0 / x


def _kv_cf2_large(mu, x, n_iters=60, fixed_trips=False):
    """Steed's CF2: e^x-scaled K_mu(x), K_{mu+1}(x) for x >= 2,
    |mu| <= 1/2 (the true K are these times e^{-x}); mu and x are tensors
    of the lanes (1-D, or any shape with ``fixed_trips``)."""
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    a1 = 0.25 - mu * mu
    s = 1.0 + a1 * d
    eps = torch.finfo(x.dtype).eps

    def step(i, state, consts):
        a, b, c, d, h, delh, q, q1, q2, s = state
        a = a - 2.0 * (i - 1.0)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        h = h + delh
        dels = q * delh
        s = s + dels
        # BOTH the s and the h series: at mu = +-1/2 (a1 = 0) every dels is
        # identically zero, and an s-only test stopped at once - the value
        # exact, the nu-derivative 5-40% wrong
        converged = ((torch.abs(dels) < torch.abs(s) * eps)
                     & (torch.abs(delh) < torch.abs(h) * eps))
        return (a, b, c, d, h, delh, q, q2, qnew, s), converged

    state = (-a1, b, a1, d, d, d, a1, torch.zeros_like(x), torch.ones_like(x),
             s)
    _, _, _, _, h, _, _, _, _, s = _run_series(state, (), step, 2, n_iters,
                                               fixed_trips)
    h = a1 * h
    k_mu = torch.sqrt(math.pi / (2.0 * x)) / s
    k_mu1 = k_mu * (mu + x + 0.5 - h) / x
    return k_mu, k_mu1


def _under_transform():
    """Whether a ``torch.func`` transform is active: there the Bessel loops
    run their fixed trips, which read no tensor's value."""
    return torch._C._functorch.maybe_current_level() is not None


def _kv_parts(nu, x, max_order: int = 128):
    """Scaled evaluation: K_nu(x) = val * exp(log_scale), elementwise.

    The recurrence renormalizes k_hi to unit magnitude at every step and
    the large-x branch keeps its e^{-x} in the scale, so every intermediate
    stays O(1) in float32 (K_25(1e-3) ~ 10^100). For a Python number nu
    the recurrence runs exactly round(nu) steps; for a tensor nu, up to
    the largest round(nu), capped at ``max_order`` (inside a ``torch.func``
    transform: ``max_order`` steps, each lane's last round(nu) of them
    kept)."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.double()
    dtype = x.dtype
    static_nl = None
    if not torch.is_tensor(nu):
        static_nl = min(math.floor(abs(float(nu)) + 0.5), max_order)
    nu = torch.abs(_as_tensor(nu, x))   # K_{-nu} = K_nu
    nu, x = torch.broadcast_tensors(nu, x)

    nl = torch.floor(nu + 0.5)          # number of upward recurrences
    mu = nu - nl                        # in [-1/2, 1/2]

    x_safe = torch.clamp(x, min=1e-30)
    small = x_safe < 2.0
    xl = torch.clamp(x_safe, min=2.0)
    fixed_trips = _under_transform()
    # each lane through its own branch (the reference evaluates both on
    # clamped arguments and selects: the same values, at twice the work)
    if fixed_trips:
        # both branches on clamped arguments, selected (the reference's)
        k_mu_s, k_mu1_s = _kv_temme_small(mu, torch.clamp(x_safe, max=2.0),
                                          fixed_trips=True)
        k_mu_l, k_mu1_l = _kv_cf2_large(mu, xl, fixed_trips=True)
        k_mu = torch.where(small, k_mu_s, k_mu_l)
        k_mu1 = torch.where(small, k_mu1_s, k_mu1_l)
    else:
        k_mu, k_mu1 = (torch.zeros_like(x_safe * mu) for _ in range(2))
        for lanes, branch in ((small, _kv_temme_small),
                              (~small, _kv_cf2_large)):
            if bool(lanes.any()):
                k_a, k_b = branch(mu[lanes], x_safe[lanes])
                k_mu = k_mu.masked_scatter(lanes, k_a)
                k_mu1 = k_mu1.masked_scatter(lanes, k_b)
    sc = torch.where(small, torch.zeros_like(x_safe), -xl)

    # invariant before step j: k_lo = K_{mu+j} e^{-sc}, k_hi = K_{mu+j+1}
    # e^{-sc}
    xi2 = 2.0 / x_safe
    k_lo, k_hi = k_mu, k_mu1
    sc_rec = sc
    if static_nl is not None:
        steps = static_nl
    elif fixed_trips:
        steps = max_order
    else:
        steps = min(int(nl.max()) if nl.numel() else 0, max_order)
    for j in range(steps):
        mag = torch.abs(k_hi)
        mag = torch.where(mag > 0, mag, torch.ones_like(mag))
        k_lo_r = k_lo / mag
        k_hi_r = k_hi / mag
        sc_r = sc_rec + torch.log(mag)
        k_new = (mu + (j + 1.0)) * xi2 * k_hi_r + k_lo_r
        if static_nl is not None:   # every lane takes every step
            k_lo, k_hi, sc_rec = k_hi_r, k_new, sc_r
            continue
        do = j < nl
        k_lo = torch.where(do, k_hi_r, k_lo)
        k_hi = torch.where(do, k_new, k_hi)
        sc_rec = torch.where(do, sc_r, sc_rec)
    val = torch.where(nl == 0, k_mu, k_lo)
    scale = torch.where(nl == 0, sc, sc_rec)
    return val, scale


def kv(nu, x, max_order: int = 128):
    """K_nu(x), elementwise, for real nu >= 0 (a number or a tensor) and
    x > 0; inf for x <= 0. Overflows where K_nu exceeds the dtype's range:
    log-space consumers use :func:`log_kv`."""
    x = torch.as_tensor(x)
    val, scale = _kv_parts(nu, x, max_order=max_order)
    result = val * torch.exp(scale)
    return torch.where(x <= 0, torch.full_like(result, math.inf), result)


def log_kv(nu, x, max_order: int = 128):
    """log K_nu(x), free of overflow and underflow across the dtype's
    range (K_25(10^-3) ~ 10^100 overflows float32; its log is ~230)."""
    x = torch.as_tensor(x)
    val, scale = _kv_parts(nu, x, max_order=max_order)
    tiny = torch.finfo(val.dtype).tiny
    result = torch.log(torch.clamp(val, min=tiny)) + scale
    return torch.where(x <= 0, torch.full_like(result, math.inf), result)


def kve(nu, x, max_order: int = 128):
    """Exponentially scaled K: kve(nu, x) = exp(x) K_nu(x)."""
    x = torch.as_tensor(x)
    val, scale = _kv_parts(nu, x, max_order=max_order)
    result = val * torch.exp(scale + x)
    return torch.where(x <= 0, torch.full_like(result, math.inf), result)
