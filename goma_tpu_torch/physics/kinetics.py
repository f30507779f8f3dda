"""Homogeneous reaction-network kinetics closure for species transport
(counterpart of ``goma_tpu/physics/kinetics.py``).

Parity: the reference's gas kinetics hooks (Chemkin third-party closures,
``src/mm_chemkin.c``; the SENKIN user hook, ``src/user_senkin.F``) feeding
reaction sources into ``assemble_mass_transport``
(``src/mm_fill_species.c``). The gas-phase core is a closure pluggable as
the ``species_source`` material key (and ``heat_source`` for the energy
equation); every Jacobian entry is forward-mode AD through it.

Rate laws (Chemkin-II): modified Arrhenius k = A T^beta exp(-Ea/RT);
reversible steps by constant K_eq, an explicit reverse Arrhenius (REV) or
NASA-7 equilibrium (Kp = exp(dS/R - dH/RT), Kc = Kp (P_atm/RT)^dnu);
third bodies with per-species efficiencies; Lindemann, Troe and SRI
falloff; PLOG interpolation at a fixed pressure; duplicate rows add.

Zero guards: goma_tpu floors concentrations, rate constants and the Troe
centre at 1e-300 before a log. In float32 that floor rounds to 0, so a
species at exactly zero gives log(0) = -inf and, times a zero order, NaN
in the switched-precision prep. The port floors at 1e-300 in float64
(bit-equal to goma_tpu) and at the smallest normal float32 in float32.
``max(c, 0)`` at c = 0 takes half the derivative, as ``jnp.maximum``.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.physics.materials import _floor, _tiny

GAS_R = 8.31446261815324

#: (R in energy/(mol K), P_atm) pairs fixing the concentration units used
#: for thermodynamic Kc conversion: SI = mol/m^3, CGS = mol/cm^3 (the
#: Chemkin convention, where A carries cm-mol-s units).
_UNITS = {
    "si": (GAS_R, 101325.0),
    "cgs": (GAS_R * 1.0e7, 1.01325e6),
}


def _t(a, like):
    """A numpy array or number as a tensor at ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=like.dtype,
                           device=like.device)


class Nasa7:
    """NASA 7-coefficient polynomial thermo data for one species.

    ``a_low`` applies below ``T_mid``, ``a_high`` above; both are the
    standard (a1..a7) sets defining Cp/R, H/RT and S/R.
    """

    def __init__(self, a_low, a_high, T_mid=1000.0, T_low=300.0,
                 T_high=5000.0):
        self.a_low = np.asarray(a_low, dtype=float)
        self.a_high = np.asarray(a_high, dtype=float)
        assert self.a_low.shape == (7,) and self.a_high.shape == (7,)
        self.T_mid = float(T_mid)
        self.T_low = float(T_low)
        self.T_high = float(T_high)

    def h_over_RT(self, T):
        def f(a):
            a = [float(v) for v in a]
            return (a[0] + a[1] * T / 2 + a[2] * T**2 / 3 + a[3] * T**3 / 4
                    + a[4] * T**4 / 5 + a[5] / T)
        return torch.where(T < self.T_mid, f(self.a_low), f(self.a_high))

    def s_over_R(self, T):
        def f(a):
            a = [float(v) for v in a]
            return (a[0] * torch.log(T) + a[1] * T + a[2] * T**2 / 2
                    + a[3] * T**3 / 3 + a[4] * T**4 / 4 + a[6])
        return torch.where(T < self.T_mid, f(self.a_low), f(self.a_high))


class ReactionNetwork:
    """Elementary mass-action network r_r = k_r(T,[M],P) prod_w c_w^ord_rw
    (optionally minus a reverse rate); species source S_w = sum_r nu_rw r_r;
    heat source Q = -sum_r dH_r r_r.

    Optional per-reaction feature lists (length n_rxn, ``None`` = off):

    - ``third_body[j]``: ``{}``/dict of per-species efficiencies (default
      1.0 each; ``{"collider": sid}`` pins [M] to one species) -- the rate
      (both directions) is multiplied by [M].
    - ``falloff[j]``: ``{"low": (A0, b0, Ea0)[, "troe": (a, T3, T1[, T2])]
      [, "sri": (a, b, c[, d, e])]}`` -- unimolecular falloff blending;
      the matching ``third_body[j]`` supplies the collider for Pr.
    - ``rev_arrhenius[j]``: (A, b, Ea) explicit reverse rate (REV card).
    - ``plog[j]``: [(P, A, b, Ea), ...] -- ln-k interpolation in ln P at
      the fixed ``pressure`` attribute.
    - ``K_eq[j]``: number (constant), or the string ``"thermo"`` to use
      ``thermo`` NASA-7 data (list of :class:`Nasa7` or None per species).
    """

    def __init__(self, nu, A, Ea=None, beta=None, orders=None, K_eq=None,
                 dH=None, T_ref=None, third_body=None, falloff=None,
                 rev_arrhenius=None, plog=None, thermo=None, pressure=None,
                 units="si"):
        self.nu = np.asarray(nu, dtype=float)          # (nr, ns)
        nr, ns = self.nu.shape
        self.A = np.asarray(A, dtype=float)
        self.Ea = np.zeros(nr) if Ea is None else np.asarray(Ea, dtype=float)
        self.beta = np.zeros(nr) if beta is None else np.asarray(beta, dtype=float)
        if orders is None:
            orders = np.where(self.nu < 0, -self.nu, 0.0)
        self.orders = np.asarray(orders, dtype=float)
        self.rev_orders = np.where(self.nu > 0, self.nu, 0.0)
        self.K_eq = [None] * nr if K_eq is None else list(K_eq)
        self.dH = np.zeros(nr) if dH is None else np.asarray(dH, dtype=float)
        self.T_ref = T_ref
        self.third_body = [None] * nr if third_body is None else list(third_body)
        self.falloff = [None] * nr if falloff is None else list(falloff)
        self.rev_arrhenius = ([None] * nr if rev_arrhenius is None
                              else list(rev_arrhenius))
        self.plog = [None] * nr if plog is None else list(plog)
        self.thermo = thermo                           # list[Nasa7|None]|None
        self.pressure = pressure
        if units not in _UNITS:
            raise ValueError(f"units must be one of {sorted(_UNITS)}")
        self.units = units
        for j in range(nr):
            if self.falloff[j] is not None and self.third_body[j] is None:
                self.third_body[j] = {}
            if self.K_eq[j] == "thermo":
                if self.thermo is None:
                    raise ValueError(f"reaction {j}: K_eq='thermo' requires "
                                     "NASA thermo data")
                for sid in np.nonzero(self.nu[j])[0]:
                    if self.thermo[sid] is None:
                        raise ValueError(
                            f"reaction {j}: no thermo data for species {sid}")

    # ---------------------------------------------------------------- rates
    def _arrhenius(self, T, A, beta, Ea):
        return float(A) * T**float(beta) * torch.exp(-float(Ea) / (GAS_R * T))

    def _conc_M(self, j, c):
        """Effective third-body concentration [M] at each qp."""
        tb = self.third_body[j]
        if tb and "collider" in tb:
            return c[:, tb["collider"]]
        eff = np.ones(c.shape[1])
        if tb:
            for sid, e in tb.items():
                eff[sid] = e
        return c @ _t(eff, c)

    def _k_forward(self, j, T, M, dtype):
        """Rate coefficient of reaction j incl. plog/falloff blending."""
        if self.plog[j] is not None:
            return self._k_plog(j, T)
        k_inf = self._arrhenius(T, self.A[j], self.beta[j], self.Ea[j])
        fo = self.falloff[j]
        if fo is None:
            return k_inf
        A0, b0, Ea0 = fo["low"]
        k0 = self._arrhenius(T, A0, b0, Ea0)
        Pr = _floor(k0 * M / _floor(k_inf, _tiny(T.dtype)), 1e-30)
        F = torch.ones_like(T)
        if "troe" in fo:
            t = fo["troe"]
            a, T3, T1 = t[0], t[1], t[2]
            Fc = (1 - a) * torch.exp(-T / T3) + a * torch.exp(-T / T1)
            if len(t) > 3 and t[3] is not None:
                Fc = Fc + torch.exp(-t[3] / T)
            logFc = torch.log10(_floor(Fc, _tiny(T.dtype)))
            cc = -0.4 - 0.67 * logFc
            nn = 0.75 - 1.27 * logFc
            lpr = torch.log10(Pr) + cc
            F = 10.0 ** (logFc / (1.0 + (lpr / (nn - 0.14 * lpr)) ** 2))
        elif "sri" in fo:
            s = fo["sri"]
            a, b, cpar = s[0], s[1], s[2]
            d = s[3] if len(s) > 3 else 1.0
            e = s[4] if len(s) > 4 else 0.0
            X = 1.0 / (1.0 + torch.log10(Pr) ** 2)
            F = d * (a * torch.exp(-b / T) + torch.exp(-T / cpar)) ** X * T**e
        return k_inf * Pr / (1.0 + Pr) * F

    def _k_plog(self, j, T):
        if self.pressure is None:
            raise ValueError(f"reaction {j} uses PLOG; set pressure=")
        pts = sorted(self.plog[j])
        lnP = float(np.log(self.pressure))
        lks = [torch.log(_floor(self._arrhenius(T, A, b, Ea), _tiny(T.dtype)))
               for _, A, b, Ea in pts]
        lPs = [float(np.log(P)) for P, *_ in pts]
        if len(pts) == 1 or lnP <= lPs[0]:
            return torch.exp(lks[0])
        if lnP >= lPs[-1]:
            return torch.exp(lks[-1])
        i = int(np.searchsorted(lPs, lnP)) - 1
        w = (lnP - lPs[i]) / (lPs[i + 1] - lPs[i])
        return torch.exp((1 - w) * lks[i] + w * lks[i + 1])

    def _Kc(self, j, T):
        """Equilibrium constant in concentration units for reaction j."""
        Ke = self.K_eq[j]
        if Ke != "thermo":
            return Ke
        R_u, P_atm = _UNITS[self.units]
        dS = torch.zeros_like(T)
        dH = torch.zeros_like(T)
        for sid in np.nonzero(self.nu[j])[0]:
            th = self.thermo[sid]
            dS = dS + float(self.nu[j, sid]) * th.s_over_R(T)
            dH = dH + float(self.nu[j, sid]) * th.h_over_RT(T)
        Kp = torch.exp(dS - dH)
        dn = float(self.nu[j].sum())
        return Kp * (P_atm / (R_u * T)) ** dn

    def _rates(self, fv, params):
        c = _floor(fv.val["species"], 0.0)              # (nq, ns)
        if "temperature" in fv.val:
            T = fv.val["temperature"][:, 0]
        elif self.T_ref is not None:
            T = torch.full((c.shape[0],), float(self.T_ref), dtype=c.dtype,
                           device=c.device)
        else:
            T = torch.ones(c.shape[0], dtype=c.dtype, device=c.device)
        logc = torch.log(_floor(c, _tiny(c.dtype)))
        fwd = torch.exp(logc @ _t(self.orders.T, c))
        cols = []
        for j in range(self.nu.shape[0]):
            M = (self._conc_M(j, c)
                 if self.third_body[j] is not None else None)
            k = self._k_forward(j, T, M, c.dtype)
            r_j = k * fwd[:, j]
            if self.rev_arrhenius[j] is not None:
                Ar, br, Ear = self.rev_arrhenius[j]
                k_rev = self._arrhenius(T, Ar, br, Ear)
            elif self.K_eq[j] is not None:
                k_rev = k / self._Kc(j, T)
            else:
                k_rev = None
            if k_rev is not None:
                rev = torch.exp(logc @ _t(self.rev_orders[j], c))
                r_j = r_j - k_rev * rev
            if M is not None and self.falloff[j] is None:
                r_j = r_j * M                          # three-body [M]
            cols.append(r_j)
        return torch.stack(cols, dim=1)                # (nq, nr)

    def species_source(self, fv, mat, params):
        """(nq, ns) molar production rates (``species_source`` closure)."""
        r = self._rates(fv, params)
        return r @ _t(self.nu, r)

    def heat_source(self, fv, mat, params):
        """(nq,) volumetric heat release -sum_r dH_r r_r."""
        r = self._rates(fv, params)
        return -(r @ _t(self.dH, r))
