"""Lubrication (Reynolds film) equations (counterpart of
``goma_tpu/physics/lubrication.py``).

Parity: the reference shell-lubrication family ``src/mm_fill_shell.c``
(``assemble_lubrication``, the LUBP equations) and the film closures of
``src/mm_std_models_shell.c``: the Reynolds equation on a shell (or on a
2D/1D block parameterizing the film) with a prescribed gap h(x, t) and wall
velocity U,

    div( h^3/(12 mu) grad p ) = U/2 . grad h + dh/dt,

its thin-film multiphase (TFMP) and power-law variants, the level-set
curvature inside the gap, and the end and wall conditions of a
lubrication shell.

Derivatives inside the integrands are ``torch.func`` transforms, so they
nest inside the assembler's ``vmap(jacfwd(...))``: the squeeze term dh/dt
is a ``jvp`` of the gap in ``params["time"]`` (a tensor, so the tangent
reaches the gap callable), grad h a ``jacfwd`` in the position, Krl'(S) and
rho_g'(P) a ``vmap(grad(...))``.
"""

from __future__ import annotations

import math
import types

import torch
from torch.func import grad, jacfwd, jvp, vmap

from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.fem.fields import MESH_VAR
from goma_tpu_torch.physics.materials import as_field, prop

LUB_VAR = "lub_pressure"


def _gap(fv, mat, params, h=None):
    """The gap h at the quadrature points: ``mat["gap"]`` (a constant or a
    callable of (fv, mat, params))."""
    hfun = mat["gap"] if h is None else h
    nq = fv.x.shape[0]
    return hfun(fv, mat, params) if callable(hfun) else as_field(hfun, (nq,), fv.x)


def _wall_velocity(U, fv, mat, params, dim):
    """The wall velocity (nq, dim): a callable's result or a constant."""
    if callable(U):
        return U(fv, mat, params)
    return as_field(U, (fv.x.shape[0], dim), fv.x)


def _gap_dot(fv, mat, params, h):
    """dh/dt of the prescribed gap as a ``jvp`` in ``params["time"]`` (the
    squeeze terms of the reference TFMP/LUBP equations); zero for a
    constant gap."""
    hfun = mat["gap"]
    if not callable(hfun):
        return torch.zeros_like(h)

    def h_of_t(t):
        p2 = dict(params)
        p2["time"] = t
        return hfun(fv, mat, p2)

    t = params["time"]
    return jvp(h_of_t, (t,), (torch.ones_like(t),))[1]


class ReynoldsFilm(Equation):
    """Material keys: ``gap`` h(fv, mat, params) -> (nq,) (callable, may read
    fv.x and params["time"], or a constant), ``mu_lub``,
    ``wall_velocity`` (dim,) constant or callable. ``var``: the solved
    pressure; pass e.g. ``"lub_pressure_2"`` for the reference's
    second-layer R_LUBP_2 equation (``src/mm_fill.c:2029``)."""

    def __init__(self, interp: str = "Q1", transient: bool = False,
                 var: str = LUB_VAR):
        super().__init__(var, 1, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        var = self.var
        gp = fv.grad[var][:, 0, :]
        mu = prop(mat, "mu_lub", fv, params, 1.0)
        h = _gap(fv, mat, params)
        U = mat.get("wall_velocity", None)
        gphi = fv.gphi[var]
        phi = fv.phi[var]
        mob = h**3 / (12.0 * mu)
        contrib = torch.einsum("q,qk,qik->qi", mob, gp, gphi)
        if U is not None:
            Uv = _wall_velocity(U, fv, mat, params, fv.x.shape[1])
            # Couette term: -div(U h / 2) tested weakly
            contrib = contrib - 0.5 * torch.einsum("qk,q,qik->qi", Uv, h, gphi)
        if self.transient:
            dhdt = _gap_dot(fv, mat, params, h)
            contrib = contrib + torch.einsum("q,qi->qi", dhdt, phi)
        return contrib[:, None, :]


TFMP_P, TFMP_S = "tfmp_pres", "tfmp_sat"


def _krl(mat):
    return mat.get("krl", lambda s: s**3)


def _krg(mat):
    return mat.get("krg", lambda s: (1.0 - s) ** 3)


def _tfmp_common(fv, mat, params):
    h = _gap(fv, mat, params)
    S = fv.val[TFMP_S][:, 0]
    gP = fv.grad[TFMP_P][:, 0, :]
    return h, S, gP, _krl(mat)(S), _krg(mat)(S)


class TFMPMass(Equation):
    """Thin-film multiphase LIQUID conservation (reference R_TFMP_MASS rows
    of ``assemble_shell_tfmp``, src/mm_fill_shell.c:17422):

        h dS/dt + S dh/dt - div( h^3/(12 mu_l) Krl(S) grad P )
                 + U_avg . (S grad h + h grad S) + D grad S terms = 0

    Material keys: gap (h), mu_l, krl(S) (default S^3), D_tfmp (artificial
    diffusion), wall_velocity (the average plate motion). ``supg`` adds a
    streamline upwinding along the saturation characteristic."""

    def __init__(self, interp: str = "Q1", transient: bool = True,
                 supg: float = 0.0):
        super().__init__(TFMP_S, 1, interp)
        self.transient = transient
        self.supg = supg

    def residual(self, fv, mat, params):
        mu_l = prop(mat, "mu_l", fv, params)
        h, S, gP, Krl, _ = _tfmp_common(fv, mat, params)
        gS = fv.grad[TFMP_S][:, 0, :]
        phi = fv.phi[TFMP_S]
        gphi = fv.gphi[TFMP_S]

        mob = h**3 / (12.0 * mu_l) * Krl
        c = torch.einsum("q,qk,qik->qi", mob, gP, gphi)
        D = mat.get("D_tfmp", 0.0)
        if D:
            c = c + D * torch.einsum("qk,qik->qi", gS, gphi)
        U = mat.get("wall_velocity", None)
        if U is not None:
            Uv = _wall_velocity(U, fv, mat, params, fv.x.shape[1])
            hfun = mat["gap"]
            if callable(hfun):
                def h_sum(x):
                    fv2 = types.SimpleNamespace(**fv.__dict__)
                    fv2.x = x
                    return hfun(fv2, mat, params).sum()

                gh = jacfwd(h_sum)(fv.x)
            else:
                gh = torch.zeros_like(fv.x)
            adv = S * torch.einsum("qk,qk->q", Uv, gh) \
                + h * torch.einsum("qk,qk->q", Uv, gS)
            c = c + adv[:, None] * phi
        if self.transient:
            dhdt = _gap_dot(fv, mat, params, h)
            c = c + (h * fv.dot[TFMP_S][:, 0] + S * dhdt)[:, None] * phi
        if self.supg > 0:
            # upwinding along a = -(h^3/12 mu_l) Krl'(S) grad P; vanishes on
            # a uniform S
            dkrl = vmap(grad(_krl(mat)))(S)
            a = -(h**3 / (12.0 * mu_l) * dkrl)[:, None] * gP
            a2 = torch.sum(a * a, dim=1)
            tau = self.supg * fv.h_elem * torch.sqrt(a2 + 1e-30) / (2 * a2 + 1e-12)
            adS = torch.einsum("qk,qk->q", a, gS)
            c = c + tau[:, None] * adS[:, None] * torch.einsum("qk,qik->qi", a, gphi)
        return c[:, None, :]


class TFMPBound(Equation):
    """Thin-film multiphase GAS conservation (reference R_TFMP_BOUND rows):

        d/dt( rho_g h (1-S) ) - div( rho_g h^3/(12 mu_g) Krg(S) grad P ) = 0

    ``rho_g``: a constant or a callable of P (compressible gas)."""

    def __init__(self, interp: str = "Q1", transient: bool = True):
        super().__init__(TFMP_P, 1, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        mu_g = prop(mat, "mu_g", fv, params)
        h, S, gP, _, Krg = _tfmp_common(fv, mat, params)
        P = fv.val[TFMP_P][:, 0]
        rg = mat.get("rho_g", 1.0)
        rho = rg(P) if callable(rg) else rg
        phi = fv.phi[TFMP_P]
        gphi = fv.gphi[TFMP_P]
        mob = rho * h**3 / (12.0 * mu_g) * Krg
        c = torch.einsum("q,qk,qik->qi", mob, gP, gphi)
        if self.transient:
            Sdot = fv.dot[TFMP_S][:, 0]
            Pdot = fv.dot[TFMP_P][:, 0]
            drho = vmap(grad(rg))(P) if callable(rg) else torch.zeros_like(P)
            dhdt = _gap_dot(fv, mat, params, h)
            ddt = h * (-rho * Sdot + (1.0 - S) * drho * Pdot) \
                + rho * (1.0 - S) * dhdt
            c = c + ddt[:, None] * phi
        return c[:, None, :]


class ReynoldsFilmPowerLaw(Equation):
    """Reynolds lubrication for a power-law fluid
    (``assemble_lubrication_power_law``, ``src/mm_fill_shell.c:14633``):
    the closed-form pressure-driven channel flux for tau = m (du/dz)^n,

        q = -(2n/(2n+1)) (h/2)^((2n+1)/n) (|grad P|/m)^(1/n)
              grad P / |grad P|  +  U_avg h

    (n = 1 gives h^3/(12 m)), in the mass balance div q + dh/dt = 0 tested
    weakly. Material keys: ``gap``, ``m_lub``, ``n_exp``,
    ``wall_velocity``."""

    def __init__(self, interp: str = "Q1", transient: bool = False,
                 eps_reg: float = 1e-12):
        super().__init__(LUB_VAR, 1, interp)
        self.transient = transient
        self.eps_reg = eps_reg

    def residual(self, fv, mat, params):
        gp = fv.grad[LUB_VAR][:, 0, :]
        m = prop(mat, "m_lub", fv, params, 1.0)
        n = mat.get("n_exp", 1.0)
        h = _gap(fv, mat, params)
        gphi = fv.gphi[LUB_VAR]
        phi = fv.phi[LUB_VAR]
        # |grad P| regularized: the 1/n - 1 power stays finite at gp = 0
        gmag = torch.sqrt(torch.sum(gp * gp, dim=1) + self.eps_reg)
        coef = (2.0 * n / (2.0 * n + 1.0)) * (h / 2.0) ** ((2.0 * n + 1.0) / n)
        qmag_over_g = coef * (gmag / m) ** (1.0 / n) / gmag
        contrib = torch.einsum("q,qk,qik->qi", qmag_over_g, gp, gphi)
        U = mat.get("wall_velocity", None)
        if U is not None:
            Uv = _wall_velocity(U, fv, mat, params, fv.x.shape[1])
            contrib = contrib - torch.einsum("qk,q,qik->qi", Uv, h, gphi)
        if self.transient:
            dhdt = _gap_dot(fv, mat, params, h)
            contrib = contrib + dhdt[:, None] * phi
        return contrib[:, None, :]


LUB_CURV = "lub_curv"  # SHELL_LUB_CURV


class LubricationCurvature(Equation):
    """SHELL_LUB_CURV rows (``assemble_lubrication_curvature``,
    ``src/mm_fill_shell.c:13772``): the in-plane curvature of the
    level-set interface inside a lubrication gap, a pseudo-relaxed
    projection of div(n_LS),

        R_i = (kappa + lambda dkappa/dt) w_i + lambda (v_avg . grad kappa) w_i
              + K_diff h_elem^2 grad(kappa) . grad(phi_i)
              + curvX * n_LS . grad(phi_i)

    with n_LS = grad F/|grad F| of the level set ``fill_var``, SUPG weight
    w_i = phi_i + (v_avg/|v| h) . grad(phi_i) and the interface modulation
    curvX (1 inside |F| < alpha, 2 - |F|/alpha to 2 alpha, 0 beyond).
    Material keys: ``curv_relax``, ``curv_diff`` (default 0.2),
    ``ls_alpha`` (0 disables the modulation), ``lub_velocity`` (callable
    v_avg, default 0)."""

    def __init__(self, interp: str = "Q1", transient: bool = False,
                 supg: float = 1.0, var: str = LUB_CURV,
                 fill_var: str = "fill"):
        super().__init__(var, 1, interp)
        self.transient = transient
        self.supg = supg
        self.fill_var = fill_var

    def residual(self, fv, mat, params):
        var = self.var
        kap = fv.val[var][:, 0]
        gk = fv.grad[var][:, 0, :]
        phi = fv.phi[var]
        gphi = fv.gphi[var]
        F = fv.val[self.fill_var][:, 0]
        gF = fv.grad[self.fill_var][:, 0, :]
        nmag = torch.sqrt(torch.sum(gF * gF, dim=1))
        ninv = torch.where(nmag > 0, 1.0 / torch.clamp_min(nmag, 1e-30),
                           torch.ones_like(nmag))
        nls = gF * ninv[:, None]
        lam = mat.get("curv_relax", 0.0)
        Kd = mat.get("curv_diff", 0.2)
        alpha = mat.get("ls_alpha", 0.0)
        vfun = mat.get("lub_velocity", None)
        wt = phi
        if vfun is not None:
            v = vfun(fv, mat, params)
            if self.supg > 0:
                v2 = torch.sum(v * v, dim=1)
                hinv = torch.where(v2 > 0, fv.h_elem / (2.0 * torch.sqrt(v2 + 1e-30)),
                                   torch.zeros_like(v2))
                wt = phi + self.supg * hinv[:, None] * \
                    torch.einsum("qk,qik->qi", v, gphi)
        c = kap[:, None] * wt
        if lam:
            if self.transient:
                c = c + lam * fv.dot[var][:, 0][:, None] * wt
            if vfun is not None:
                c = c + lam * torch.einsum("qk,qk->q", v, gk)[:, None] * wt
        if Kd:
            c = c + torch.einsum("q,qk,qik->qi", Kd * fv.h_elem ** 2, gk, gphi)
        if alpha:
            aF = torch.abs(F)
            curvX = torch.where(aF < alpha, torch.ones_like(aF),
                                torch.where(aF < 2.0 * alpha, 2.0 - aF / alpha,
                                            torch.zeros_like(aF)))
        else:
            curvX = torch.ones_like(F)
        c = c + curvX[:, None] * torch.einsum("qk,qik->qi", nls, gphi)
        return c[:, None, :]


def tie_lub_film(problem, junction_nodeset, lub_var: str = LUB_VAR,
                 film_var: str = "film_pressure", flux_sign: float = 1.0):
    """LUBP_SH_FP_MATCH + LUBP_SH_FP_FLUX (``src/mm_shell_bc.c:1667``,
    ``:1743``): couple a confined-lubrication (LUBP) shell region to a
    free-film (SHELL_FILMP) region at their junction node(s), as a row
    injection (flux continuity: the lubrication row moved into the film
    row) and a two-variable point constraint (pressure continuity).
    ``flux_sign`` +1 matches this package's weak-form signs."""
    problem.add_row_inject(junction_nodeset, lub_var, film_var,
                           sign=flux_sign)
    problem.add_point_constraint(junction_nodeset, [lub_var, film_var], 0,
                                 lambda q, X0, params: q[0] - q[1])


def _lub_q(sfv, mat, params, var, dim):
    """(h, q): the gap and the lubrication flux q = -h^3/(12 mu) grad p +
    U h/2 (``calculate_lub_q_v``)."""
    mu = prop(mat, "mu_lub", sfv, params, 1.0)
    h = _gap(sfv, mat, params)
    gp = sfv.grad[var][:, 0, :]
    q = -(h ** 3 / (12.0 * mu))[:, None] * gp
    U = mat.get("wall_velocity", None)
    if U is not None:
        q = q + 0.5 * h[:, None] * _wall_velocity(U, sfv, mat, params, dim)
    return h, q


class LubEndKinematic(FaceKernel):
    """VELO_NORMAL_LUB / LUB_KINEMATIC (``src/mm_ns_bc.c:587``): at a
    lubrication-shell endpoint meeting the bulk, the bulk normal motion
    tied to the gap-averaged end flux,

        v . n_end = (lubflux + (q - H xdot) . n_end) / H,

    as a penalty on the rows of ``var`` (the velocity, or the mesh
    displacement for LUB_KINEMATIC). Apply on a shell-endpoint side set
    (``bc.shell_end.shell_end_sidesets``) with ``PassiveVar(var, dim,
    interp)`` on the shell block. Material keys as :class:`ReynoldsFilm`."""

    def __init__(self, dim: int, var: str = "velocity", lubflux=0.0,
                 penalty: float = 1e6, lub_var: str = LUB_VAR):
        super().__init__(var, dim)
        self.dim = dim
        self.lubflux = lubflux
        self.penalty = penalty
        self.lub_var = lub_var

    def residual(self, sfv, mat, params):
        h, q = _lub_q(sfv, mat, params, self.lub_var, self.dim)
        if MESH_VAR in sfv.dot:
            q = q - h[:, None] * sfv.dot[MESH_VAR]
        lf = self.lubflux(sfv, mat, params) if callable(self.lubflux) \
            else self.lubflux
        n = sfv.normal  # the endpoint conormal
        vn = torch.einsum("qk,qk->q", sfv.val[self.var], n)
        s = vn - (lf + torch.einsum("qk,qk->q", q, n)) / h
        return self.penalty * torch.einsum("q,qa,qi->qai", s, n,
                                           sfv.phi[self.var])


class TFMPFreeFlux(FaceKernel):
    """SHELL_TFMP_FREE_LIQ / SHELL_TFMP_FREE_GAS (``src/mm_shell_bc.c``):
    the open end of a thin-film multiphase shell, re-adding the
    integrated-by-parts in-plane flux,

        liquid rows (tfmp_sat):  - phi (h^3/(12 mu_l)) Krl (grad P . n)
        gas rows (tfmp_pres):    - phi rho_g (h^3/(12 mu_g)) Krg (grad P . n)
    """

    def __init__(self, phase: str = "liquid"):
        assert phase in ("liquid", "gas")
        super().__init__(TFMP_S if phase == "liquid" else TFMP_P, 1)
        self.phase = phase

    def residual(self, sfv, mat, params):
        h = _gap(sfv, mat, params)
        S = sfv.val[TFMP_S][:, 0]
        gPn = torch.einsum("qk,qk->q", sfv.grad[TFMP_P][:, 0, :], sfv.normal)
        if self.phase == "liquid":
            mu_l = prop(mat, "mu_l", sfv, params)
            q = -(h**3 / (12.0 * mu_l)) * _krl(mat)(S) * gPn
        else:
            mu_g = prop(mat, "mu_g", sfv, params)
            P = sfv.val[TFMP_P][:, 0]
            rg = mat.get("rho_g", 1.0)
            rho = rg(P) if callable(rg) else rg
            q = -rho * (h**3 / (12.0 * mu_g)) * _krg(mat)(S) * gPn
        return (q[:, None] * sfv.phi[self.var])[:, None, :]


class ShellFlowDeveloped(FaceKernel):
    """SHELL_FLOW_DEVELOPED (``src/mm_shell_bc.c`` shell_n_dot_gradp_bc):
    a fully developed film end, n . grad(P) = 0 on the film-pressure rows
    as a penalty at the shell endpoint."""

    def __init__(self, var: str = "film_pressure", penalty: float = 1e6):
        super().__init__(var, 1)
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        s = torch.einsum("qk,qk->q", sfv.grad[self.var][:, 0, :], sfv.normal)
        return self.penalty * (s[:, None] * sfv.phi[self.var])[:, None, :]


class ShellLubWall(FaceKernel):
    """SHELL_LUB_WALL (``src/mm_shell_bc.c:499``): flow resistance of a
    side wall bounding the lubrication domain, the lubrication flux along
    the wall tangent scaled by the power-law wall factor

        W = -pi (2 + 1/n) / (3 + 1/n) / 2^(2 + 1/n) * fudge,

    loading the lub-pressure rows weakly, W (q . t_wall) phi_i. With a
    level-set field ``fill_var`` on the block the factor is gated by
    1 - H(F) (``physics.level_set.heaviside``, width ``ls_alpha`` or
    ``params["ls_eps"]``)."""

    def __init__(self, pwr_index: float = 1.0, fudge: float = 1.0,
                 lub_var: str = LUB_VAR, fill_var: str = "fill"):
        super().__init__(lub_var, 1)
        self.n_pwr = pwr_index
        self.fudge = fudge
        self.fill_var = fill_var

    def residual(self, sfv, mat, params):
        from goma_tpu_torch.physics.level_set import heaviside

        _, q = _lub_q(sfv, mat, params, self.var, sfv.x.shape[1])
        n = self.n_pwr
        W = -math.pi * (2.0 + 1.0 / n) / (3.0 + 1.0 / n) \
            / 2.0 ** (2.0 + 1.0 / n) * self.fudge
        if self.fill_var in sfv.val:
            eps = mat.get("ls_alpha", params.get("ls_eps", 0.1))
            W = W * (1.0 - heaviside(sfv.val[self.fill_var][:, 0], eps))
        t = sfv.tangents[:, :, 0]
        t = t / torch.linalg.vector_norm(t, dim=1, keepdim=True)
        s = W * torch.einsum("qk,qk->q", q, t)
        return (s[:, None] * sfv.phi[self.var])[:, None, :]


class TFMPAvgPlateVelo(FaceKernel):
    """SHELL_TFMP_AVG_PLATE_VELO (``src/mm_shell_bc.c:2221``): the liquid
    carried out through an open side by the average plate velocity,
    func = h S (n . v_avg), weak on the saturation rows. ``v_avg``
    defaults to the material key ``wall_velocity``."""

    def __init__(self, v_avg=None):
        super().__init__(TFMP_S, 1)
        self.v_avg = v_avg

    def residual(self, sfv, mat, params):
        nq, dim = sfv.x.shape
        h = _gap(sfv, mat, params)
        S = sfv.val[TFMP_S][:, 0]
        v = self.v_avg if self.v_avg is not None else \
            mat.get("wall_velocity", None)
        v = torch.zeros_like(sfv.x) if v is None else \
            _wall_velocity(v, sfv, mat, params, dim)
        vn = torch.einsum("qk,qk->q", v, sfv.normal)
        return ((h * S * vn)[:, None] * sfv.phi[TFMP_S])[:, None, :]
