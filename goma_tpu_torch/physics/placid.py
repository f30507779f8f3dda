"""PLACID: pseudo-steady surface-site / bulk-fraction kinetics solver
(counterpart of ``goma_tpu/physics/placid.py``).

Parity: ``src/mm_placid.c:165`` (``placid()``, Salinger & Moffat): at every
surface quadrature point that carries a surface mechanism, a small dense
damped-Newton system for the surface site fractions (production rate of
every site species = 0) and the bulk mole fractions (proportional to their
deposition rates), with pseudo-transient continuation (``calc_t``), the
bounds-preserving damping rule (``calc_damping``, APPROACH = 0.8), one
sum-to-one row per phase on its largest-fraction species, and convergence
on a weighted update norm 10x tighter than the outer solver
(EXTRA_ACCURACY = 0.1). The converged ``sdot`` feeds the gas species'
surface fluxes (``src/mm_fill_species.c:2376``).

goma_tpu runs the damped Newton as one ``lax.while_loop`` under ``vmap``
over the points, inside the face Jacobian's ``jacfwd``: every lane runs
until all are done, a finished lane is frozen, and the tangent is carried
forward through every iteration (not an implicit-function derivative).
The port keeps those iterates and that tangent:

- the points are a batch; each iteration computes every point's next state
  (its dim x dim Jacobian by ``torch.func.jacfwd``, a batched
  ``torch.linalg.solve``) and ``torch.where`` keeps a finished point's
  state and tangent;
- a Python loop cannot read a tensor under ``torch.func`` transforms, so
  the number of iterations comes from a primal solve of the same points
  first: the inputs' primal values are read through the transforms'
  wrappers (``_primal``) and iterated until every point is done; the
  transformed solve then runs that many masked iterations. Outside any
  transform the loop stops when every point is done.

The solve is float64 inside (goma_tpu casts ``z0`` to float64); the gas
concentrations are formed in the caller's dtype first, as goma_tpu forms
them, and the flux closure returns the caller's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.physics.kinetics import _UNITS
from goma_tpu_torch.physics.materials import _floor

# reference mm_placid.c ifunc modes
SFLUX_INITIALIZE = 1
SFLUX_RESIDUAL = 2
SFLUX_JACOBIAN = 3
SFLUX_TRANSIENT = 4
# bulkFunc
BULK_DEPOSITION = 1
BULK_ETCH = 2

_APPROACH = 0.8          # calc_damping fraction of distance to the bound
_EXTRA_ACCURACY = 0.1    # surface solve overconverges 10x vs outer solver


class SurfaceMechanism:
    """Surface reaction mechanism over gas + site + bulk species.

    Species are ordered [gas (n_gas) | per-phase site/bulk blocks]. Each
    phase is ``(kind, count)`` with kind in {"site", "bulk"}; ``sden0``
    gives the site density per SITE phase (reference ``Ck.SDen0``),
    ``kcov`` the per-species site coverage (``Ck.Kcov``, default 1).

    nu, A, beta, Ea, orders: as :class:`~goma_tpu_torch.physics.kinetics.
    ReactionNetwork` -- mass-action rates r_j = k_j(T) prod c^ord with
    k = A T^beta exp(-Ea/RT); sdot = nu^T r.
    """

    def __init__(self, nu, A, Ea=None, beta=None, orders=None,
                 n_gas=1, phases=(("site", 1),), sden0=(1.0,), kcov=None,
                 units="si"):
        self.nu = np.asarray(nu, dtype=float)
        nr, ns = self.nu.shape
        self.A = np.asarray(A, dtype=float)
        self.Ea = np.zeros(nr) if Ea is None else np.asarray(Ea, float)
        self.beta = np.zeros(nr) if beta is None else np.asarray(beta, float)
        if orders is None:
            orders = np.where(self.nu < 0, -self.nu, 0.0)
        self.orders = np.asarray(orders, dtype=float)
        self.n_gas = int(n_gas)
        self.units = units
        self.phases = list(phases)
        dim = ns - self.n_gas
        self.dim = dim
        kinds, starts, counts = [], [], []
        off = 0
        for kind, cnt in self.phases:
            kinds.append(kind)
            starts.append(off)
            counts.append(int(cnt))
            off += int(cnt)
        if off != dim:
            raise ValueError(f"phase counts sum to {off}, expected {dim}")
        self.kinds = kinds
        self.starts = np.asarray(starts)
        self.counts = np.asarray(counts)
        n_site_ph = sum(1 for k in kinds if k == "site")
        if len(sden0) != n_site_ph:
            raise ValueError("one sden0 per site phase")
        sden_k = np.zeros(dim)
        is_site = np.zeros(dim, dtype=bool)
        phase_of = np.zeros(dim, dtype=np.int64)
        si = 0
        for p, (kind, cnt) in enumerate(self.phases):
            s = self.starts[p]
            phase_of[s:s + cnt] = p
            if kind == "site":
                sden_k[s:s + cnt] = float(sden0[si])
                is_site[s:s + cnt] = True
                si += 1
        self.sden_k = sden_k
        self.is_site = is_site
        self.phase_of = phase_of
        self.kcov = (np.ones(dim) if kcov is None
                     else np.asarray(kcov, dtype=float))
        self.sden_tot = float(sum(sden0))  # bulk relaxation time constant

    # ------------------------------------------------------------- rates
    def tables(self, dtype, device):
        """The rate tables at ``dtype`` on ``device``: A, beta, Ea, the
        orders, nu, the site concentration scale sden0/kcov and the
        site mask."""
        def c(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   dtype=dtype, device=device)

        return (c(self.A), c(self.beta), c(self.Ea), c(self.orders), c(self.nu),
                c(self.sden_k / self.kcov),
                torch.as_tensor(self.is_site, device=device))

    def sdot(self, X_gas, z, T, P, tables=None):
        """Molar production rates (ns,) of ALL species at one point from
        activities: gas concentrations X_g P/(RT) (formed in ``X_gas``'s
        dtype), site concentrations z sden0/kcov, bulk activities z; at
        ``z``'s dtype, float64 inside ``placid`` (which passes ``tables``,
        else they are built here)."""
        R_u = _UNITS[self.units][0]
        f64 = z.dtype
        A, beta, Ea, orders, nu, scale, is_site = (
            tables if tables is not None else self.tables(f64, z.device))
        c_gas = (_floor(X_gas, 0.0) * P / (R_u * T)).to(f64)
        c_surf = torch.where(is_site, z * scale, _floor(z, 0.0))
        logc = torch.log(_floor(torch.cat([c_gas, c_surf]), 1e-300))
        k = A * T.to(f64) ** beta * torch.exp(-Ea / (R_u * T).to(f64))
        r = k * torch.exp(orders @ logc)                       # (nr,)
        return r @ nu                                          # (ns,)


def _phase_masks(mech: SurfaceMechanism):
    """(n_phase, dim) 0/1 membership masks (host, static)."""
    m = np.zeros((len(mech.phases), mech.dim))
    for p in range(len(mech.phases)):
        s, c = mech.starts[p], mech.counts[p]
        m[p, s:s + c] = 1.0
    return m


def _primal(t):
    """The primal values of ``t`` under ``torch.func`` transforms: a plain
    tensor with one leading axis per ``vmap`` level that batches it
    (outermost first), and those levels."""
    from torch._C import _functorch as ft

    levels = []
    while ft.is_functorch_wrapped_tensor(t):
        if ft.is_batchedtensor(t):
            levels.append(ft.maybe_get_level(t))
            t = ft.get_unwrapped(t).movedim(ft.maybe_get_bdim(t), 0)
        else:
            t = ft.get_unwrapped(t)
    return t, levels[::-1]


def _primal_points(*ts):
    """The primal values of per-point inputs (each (n, ...)), flattened
    over every ``vmap`` level that batches any of them: (N, ...) each."""
    out = [_primal(t) for t in ts]
    allv = sorted({lv for _, lvs in out for lv in lvs})
    sizes = {}
    for p, lvs in out:
        for i, lv in enumerate(lvs):
            sizes[lv] = p.shape[i]
    flat = []
    for (p, lvs), t in zip(out, ts):
        for i, lv in enumerate(allv):
            if lv not in lvs:
                p = p.unsqueeze(i)
        p = p.expand(*[sizes[lv] for lv in allv], *p.shape[len(allv):])
        flat.append(p.reshape(-1, *t.shape[1:]))
    return flat


def _is_wrapped(t):
    from torch._C import _functorch as ft

    return ft.is_functorch_wrapped_tensor(t)


def placid_points(mech: SurfaceMechanism, ifunc: int, bulk_func: int,
                  time_scale, X_gas, T, P, z0, reltol=1e-6, abstol=1e-9,
                  iter_max=200):
    """PLACID at a batch of surface points: X_gas (n, n_gas), T (n,), P
    (n,), z0 (n, dim). Returns (z (n, dim), sdot (n, ns), converged (n,),
    iterations (n,) int32), z and sdot in float64 (goma_tpu's ``placid``
    under ``vmap``, the iteration counts its per-lane trip counts)."""
    if any(_is_wrapped(t) for t in (X_gas, T, P, z0)):
        *_, trips = _iterate(mech, ifunc, bulk_func, time_scale,
                             *_primal_points(X_gas, T, P, z0), reltol,
                             abstol, iter_max, None)
        n_iter = int(trips.max()) if trips.numel() else 0
    else:
        n_iter = None
    return _iterate(mech, ifunc, bulk_func, time_scale, X_gas, T, P, z0,
                    reltol, abstol, iter_max, n_iter)


def _iterate(mech, ifunc, bulk_func, time_scale, X_gas, T, P, z0, reltol,
             abstol, iter_max, n_iter):
    """The masked batched loop: ``n_iter`` iterations, or (None) until
    every point is done."""
    from torch.func import jacfwd, vmap

    f64 = torch.float64
    dev = X_gas.device

    def c(a, dtype=f64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    masks = c(_phase_masks(mech))                          # (np, dim)
    is_site = c(mech.is_site, torch.bool)
    sden_k = c(mech.sden_k)
    kcov = c(mech.kcov)
    phase_of = c(mech.phase_of, torch.int64)
    is_bulk_ph = c([1.0 if k == "bulk" else 0.0 for k in mech.kinds])
    time_scale = c(float(time_scale))
    inf = c(np.inf)
    tables = mech.tables(f64, dev)

    do_time0 = ifunc in (SFLUX_INITIALIZE, SFLUX_TRANSIENT)

    def sdot(Xg, z, Tq, Pq):
        return mech.sdot(Xg, z, Tq, Pq, tables)

    def residual(z, z_old, inv_t, do_time, Xg, Tq, Pq):
        sds = sdot(Xg, z, Tq, Pq)[mech.n_gas:]              # (dim,)
        # per-phase growth rate: sum of positive sdots in BULK phases
        pos = _floor(sds, 0.0)
        gr_k = (masks @ pos * is_bulk_ph)[phase_of]        # (dim,)
        # site rows: -kcov*sdot (+ pseudo-transient)
        r_site = -kcov * sds + do_time * inv_t * sden_k * (z - z_old)
        # bulk rows (deposition): z*GR - sdot_+; etch or GR == 0: identity
        if bulk_func == BULK_DEPOSITION:
            r_dep = (z * gr_k - torch.where(sds >= 0.0, sds,
                                            torch.zeros_like(sds))
                     + do_time * inv_t * mech.sden_tot * (z - z_old))
            r_bulk = torch.where(gr_k > 0.0, r_dep, z - z_old)
        else:
            r_bulk = z - z_old
        r = torch.where(is_site, r_site, r_bulk)
        # per-phase sum constraint replaces the argmax-fraction row
        spec = torch.argmax(masks * z[None, :] - 1e30 * (1 - masks), dim=1)
        return r.scatter(0, spec, masks @ z - 1.0)

    def calc_t(sds, z):
        """reference calc_t: max_i |kcov_i sdot_i| / (max(z_i,1e-12)
        sden0) over SITE species."""
        t = torch.abs(kcov * sds) / (_floor(z, 1e-12)
                                     * torch.where(is_site, sden_k, inf))
        return torch.max(torch.where(is_site, t, torch.zeros_like(t)))

    def calc_damping(z, dx, damp_old):
        """APPROACH=0.8 toward the violated bound; <=3x growth."""
        xnew = z - dx
        xtop = 1.0 - 0.1 * torch.abs(1.0 - z)
        xbot = torch.abs(z * 0.1) - 1e-16
        dxs = torch.where(dx == 0, torch.ones_like(dx), dx)
        d_top = -_APPROACH * (1.0 - z) / dxs
        d_bot = _APPROACH * z / dxs
        d_big = -2.0 * _floor(z, 1e-10) / dxs
        d = torch.ones_like(z)
        d = torch.where(xnew > xtop, d_top, d)
        d = torch.where(xnew < xbot, d_bot, d)
        d = torch.where((xnew <= xtop) & (xnew >= xbot)
                        & (xnew > 3.0 * _floor(z, 1e-10)), d_big, d)
        return torch.minimum(_floor(torch.min(d), 1e-6), 3.0 * damp_old)

    def body(z, damp_old, inv_t_prev, t_real, do_time, it, Xg, Tq, Pq):
        z_old = z
        sds = sdot(Xg, z, Tq, Pq)[mech.n_gas:]
        # calc_t heuristics: free before iter 10, then 2x growth cap
        t_new = calc_t(sds, z)
        inv_t = torch.where(it < 10, t_new,
                            torch.minimum(t_new, 2.0 * inv_t_prev))
        if ifunc == SFLUX_TRANSIENT:
            # don't step past time_scale
            inv_t = torch.where(
                t_real + 1.0 / _floor(inv_t, 1e-300) > time_scale,
                1.0 / _floor(time_scale - t_real, 1e-300), inv_t)
        inv_t = torch.where(do_time > 0, inv_t, torch.zeros_like(inv_t))
        # the residual is the primal of its own Jacobian's pass
        J, r = jacfwd(lambda *a: (residual(*a),) * 2, has_aux=True)(
            z, z_old, inv_t, do_time, Xg, Tq, Pq)
        dx = torch.linalg.solve_ex(J, r)[0]  # no host check: NaN is kept
        dx = torch.where(torch.all(torch.isfinite(dx)), dx,
                         torch.zeros_like(dx))
        damp = calc_damping(z, dx, damp_old)
        w = dx / (reltol * torch.abs(z) + abstol)
        un = torch.sqrt(torch.mean(w * w))
        z = z - damp * dx
        t_real = t_real + torch.where(do_time > 0,
                                      damp / _floor(inv_t, 1e-300),
                                      torch.zeros_like(damp))
        # do_time shuts off once t_real passes time_scale (steady endgame)
        do_time_n = torch.where(t_real > time_scale,
                                torch.zeros_like(do_time), do_time)
        return (z, damp, _floor(inv_t, 1e-300), t_real, do_time_n, it + 1,
                un)

    def live(st):
        _, _, _, t_real, do_time, it, un = st
        if ifunc == SFLUX_TRANSIENT:
            go = t_real < time_scale
        else:
            go = (do_time > 0) | (un > _EXTRA_ACCURACY)
        return go & (it < iter_max)

    n = X_gas.shape[0]
    z = z0.to(f64)
    one = torch.ones(n, dtype=f64, device=dev)
    st = (z, one, 1e-300 * one, 0.0 * one, (1.0 if do_time0 else 0.0) * one,
          torch.zeros(n, dtype=torch.int32, device=dev), 1e6 * one)
    step = vmap(body)
    k = 0
    while k < (iter_max if n_iter is None else n_iter):
        go = live(st)
        if n_iter is None and not bool(go.any()):
            break
        new = step(*st[:6], X_gas, T, P)
        st = tuple(torch.where(go[:, None] if a.ndim == 2 else go, a, b)
                   for a, b in zip(new, st))
        k += 1
    z, it, un = st[0], st[5], st[6]
    sd = vmap(sdot)(X_gas, z, T, P)
    conv = (un <= _EXTRA_ACCURACY) | (ifunc == SFLUX_TRANSIENT)
    return z, sd, conv, it


def placid(mech: SurfaceMechanism, ifunc: int, bulk_func: int,
           time_scale, X_gas, T, P, z0, reltol=1e-6, abstol=1e-9,
           iter_max=200):
    """One surface-point PLACID solve. Returns (z, sdot, converged).

    Faithful to ``mm_placid.c`` in: the pseudo-transient ``calc_t`` step
    with its <10-iteration free phase and 2x growth cap, the do_time ->
    steady handoff at ``time_scale``, the per-phase sum-to-one row on the
    argmax species, the bulk deposition/etch rows, the APPROACH=0.8 bounds
    damping with a 3x growth cap, and the weighted update-norm convergence
    at 0.1x(reltol, abstol). ``placid_points`` solves a batch."""
    X_gas = torch.as_tensor(X_gas)
    dt = X_gas.dtype if X_gas.is_floating_point() else torch.float64

    def pt(a):
        return torch.as_tensor(a, dtype=dt, device=X_gas.device).reshape(1)

    z, sd, conv, _ = placid_points(
        mech, ifunc, bulk_func, time_scale, X_gas.to(dt)[None], pt(T), pt(P),
        torch.as_tensor(z0, device=X_gas.device)[None], reltol, abstol,
        iter_max)
    return z[0], sd[0], conv[0]


def surface_kinetics_flux(mech: SurfaceMechanism, species_ids=None,
                          time_scale=1.0, z_init=None, reltol=1e-6,
                          abstol=1e-9, pressure=1.0, mode=SFLUX_RESIDUAL,
                          bulk_func=BULK_DEPOSITION):
    """Flux closure for the species YFLUX family: at every face quadrature
    point, solve the surface-site problem (placid) for the local gas
    composition and return the GAS-species surface production rates as
    inward normal fluxes (the reference's ``src/mm_fill_species.c:2376``
    surface-chemkin hook).

    ``species_ids``: which transported species map to the mechanism's gas
    species (default 0..n_gas-1). Returns ``(sfv, mat, params) -> (nq,
    len(species_ids))`` for :class:`goma_tpu_torch.bc.free_surface.
    NormalFlux` (ncomp = n transported species).
    """
    ids = list(range(mech.n_gas)) if species_ids is None else list(species_ids)
    if z_init is None:
        z_init = np.full(mech.dim, 1.0 / max(mech.dim, 1))

    def flux(sfv, mat, params):
        X = _floor(sfv.val["species"][:, ids], 0.0)
        nq = X.shape[0]
        if "temperature" in sfv.val:
            T = sfv.val["temperature"][:, 0]
        else:
            T = torch.ones(nq, dtype=X.dtype, device=X.device)
        P = torch.full((nq,), float(pressure), dtype=X.dtype, device=X.device)
        z0 = torch.as_tensor(np.asarray(z_init, dtype=np.float64),
                             dtype=X.dtype, device=X.device).expand(nq, -1)
        _, sd, _, _ = placid_points(mech, mode, bulk_func, time_scale, X, T,
                                    P, z0, reltol, abstol)
        # inward flux of transported species = surface production rate
        return sd[:, ids].to(X.dtype)

    return flux
