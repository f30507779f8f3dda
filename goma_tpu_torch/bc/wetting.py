"""Dynamic contact-angle / wetting-speed boundary conditions (level-set
form) and free-surface wall repulsion (counterpart of
``goma_tpu/bc/wetting.py``).

Parity: the reference's diffuse-interface wetting conditions in
``src/mm_ns_bc.c``: WETTING_SPEED_LINEAR / _BLAKE (``:12616``, ``wet_speed
= v0 * sinh(g * (cos_ca_static - cos_ca))``) / _HOFFMAN (``:12598-12650``),
applied over the diffuse interface band on a wall side set as ``t *
wet_speed * delta(F)`` with a slip coefficient ``1/depth``; CAP_REPULSE
(``:5489``), the REP_FORCE family, FILL_CA and WETTING_TENSION. The
reference hand-codes every Jacobian block (``d_wet_speed_dFj`` etc.);
here ``torch.func.jacfwd`` differentiates the whole face kernel, the
level-set normal and the mesh sensitivities included.

The dynamic contact angle comes from the level-set normal at the wall:
``cos(theta_d) = n_wall . n_fluid`` with ``n_fluid = grad F / |grad F|``.
Every correlation takes tensors and has no branch on their values but
``torch.where``, so it maps under ``vmap`` as goma_tpu's does under jit.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import FaceKernel
from goma_tpu_torch.physics.level_set import FILL_VAR, delta
from goma_tpu_torch.physics.materials import _clip, _floor


def hoffman_correlation_ca(cos_theta, n_iter: int = 40):
    """The Hoffman correlation Ca(theta) by the reference's Newton
    iteration (``src/mm_ns_bc.c:12598``): ca with ``ca - 1.31 ca^0.99 A -
    A = 0``, ``A = [log((3 - c)/(1 + c)) / (2 * 5.16)]^(1/0.706)``, c =
    cos(theta); a fixed iteration count, as in goma_tpu."""
    c = _clip(torch.as_tensor(cos_theta, dtype=torch.float64)
              if not torch.is_tensor(cos_theta) else cos_theta,
              -0.999999, 0.999999)
    A = (torch.log((3.0 - c) / (1.0 + c)) / (2.0 * 5.16)) ** (1.0 / 0.706)
    ca = torch.full_like(A, 1.0e6)
    for _ in range(n_iter):
        f = ca - 1.31 * ca**0.99 * A - A
        df = 1.0 - 1.31 * 0.99 * A / ca**0.01
        ca = ca - f / df
    return ca


# 10-point Gauss rule of the reference's Cox integral (mm_ns_bc.c:10454)
_COX_GPT = np.array([
    -0.973906528517172, -0.865063366688985, -0.679409568299024,
    -0.433395394129247, -0.148874338981631, 0.148874338981631,
    0.433395394129247, 0.679409568299024, 0.865063366688985,
    0.973906528517172])
_COX_WT = np.array([
    0.066671344308688, 0.149451349150581, 0.219086362515982,
    0.269266719309996, 0.295524224714753, 0.295524224714753,
    0.269266719309996, 0.219086362515982, 0.149451349150581,
    0.066671344308688])


def cox_f(th, lam):
    """Cox's hydrodynamic angle function f(theta, lambda)
    (``src/mm_ns_bc.c:10594-10640``); ``lam`` the displaced/displacing
    viscosity ratio."""
    s, c = torch.sin(th), torch.cos(th)
    pi = np.pi
    f_num = 2.0 * s * (lam**2 * (th**2 - s**2)
                       + 2.0 * lam * (th * (pi - th) + s**2)
                       + ((pi - th) ** 2 - s**2))
    f_den = (lam * (th**2 - s**2) * (pi - th + s * c)
             + ((pi - th) ** 2 - s**2) * (th - s * c))
    return f_num / f_den


def cox_wetting_ca(theta, theta_eq, lam=0.0, eps_slip=0.01,
                   q_inner=0.0, q_outer=0.0):
    """Capillary number of the Cox dynamic-contact-angle relation
    (VELO_THETA_COX, ``src/mm_ns_bc.c:10594``):

        Ca = [int_theta_eq^theta dth / f(th, lam)] /
             [ln(1/eps_slip) + q_i/f(theta_eq) - q_o/f(theta)]

    with the reference's fixed 10-point Gauss rule."""
    theta = torch.as_tensor(theta, dtype=torch.float64) \
        if not torch.is_tensor(theta) else theta
    kw = {"dtype": theta.dtype, "device": theta.device}
    th = theta_eq + (theta[..., None] - theta_eq) * (
        torch.as_tensor(_COX_GPT, **kw) + 1.0) / 2.0
    g_int = (1.0 / cox_f(th, lam)) @ torch.as_tensor(_COX_WT, **kw)
    g_int = g_int * 0.5 * (theta - theta_eq)
    the = torch.as_tensor(theta_eq, **kw)
    den = (np.log(1.0 / eps_slip) + q_inner / cox_f(the, lam)
           - q_outer / cox_f(theta, lam))
    return g_int / den


def shik_wetting_speed(costheta, costheta_eq, theta_max, v0, g):
    """Shikhmurzaev interface-formation wetting speed (VELO_THETA_SHIK,
    ``src/mm_ns_bc.c:10631-10638``):

        u0(th)  = (sin th - th cos th) / (sin th cos th - th)
        rhs     = (cos th_eq - cos th) /
                  [(v0 - 1)(u0(th) - u0(th_max)) + cos th - cos th_max]
        V       = sqrt(g v0) rhs / (2 sqrt(1 + rhs))

    with the reference's runaway guard th_max -> min(1.01 th, pi) when th
    exceeds th_max."""
    costheta = torch.as_tensor(costheta, dtype=torch.float64) \
        if not torch.is_tensor(costheta) else costheta
    th = torch.arccos(_clip(costheta, -0.999999, 0.999999))
    tmax = th.new_full((), float(theta_max))
    th_max = torch.where(th > tmax, torch.minimum(1.01 * th, th.new_full((), np.pi)),
                         tmax)
    s, c = torch.sin(th), torch.cos(th)
    sm, cm = torch.sin(th_max), torch.cos(th_max)
    u0 = (s - th * c) / (s * c - th)
    u0m = (sm - th_max * cm) / (sm * cm - th_max)
    rhs = (costheta_eq - costheta) / ((v0 - 1.0) * (u0 - u0m)
                                      + costheta - cm)
    return np.sqrt(g * v0) * rhs / (2.0 * torch.sqrt(_floor(1.0 + rhs, 1e-12)))


class LSWettingSpeed(FaceKernel):
    """Diffuse-interface dynamic-contact-angle wetting condition on a wall
    side set (momentum equation): adds

        (1/depth) * delta_alpha(F) * (u - t * V_wet(theta_d)) . phi_i

    with t the contact-line tangent (the fluid-interface normal projected
    onto the wall) and the wetting-speed model:

      model="linear":  V = (cos(theta_s) - cos(theta_d)) / beta
      model="blake":   V = v0 * sinh(g * (cos(theta_s) - cos(theta_d)))
      model="hoffman": V = g/mu * (Ca(theta_d) - Ca(theta_s))
      model="cox":     V = g/mu * Ca_cox(theta_d; lam, eps_slip)
      model="shik":    V from the Shikhmurzaev relation (v0, theta_max)

    Reference cards WETTING_SPEED_LINEAR / _BLAKE / _HOFFMAN and the
    VELO_THETA_TPL / _HOFFMAN / _COX / _SHIK family
    (src/mm_ns_bc.c:10482-10640, 12616ff)."""

    def __init__(self, dim: int, theta_s_deg: float, alpha: float,
                 model: str = "blake", v0: float = 1.0, g: float = 1.0,
                 beta: float = 1.0, depth: float = 1.0, mu: float = 1.0,
                 lam: float = 0.0, eps_slip: float = 0.01,
                 theta_max_deg: float = 180.0):
        super().__init__("velocity", dim)
        self.dim = dim
        self.theta_s = float(np.deg2rad(theta_s_deg))
        self.cos_ts = float(np.cos(self.theta_s))
        self.alpha = alpha
        self.model = model
        self.v0, self.g, self.beta, self.depth, self.mu = v0, g, beta, depth, mu
        self.lam, self.eps_slip = lam, eps_slip
        self.theta_max = float(np.deg2rad(theta_max_deg))
        if model not in ("linear", "blake", "hoffman", "cox", "shik"):
            raise ValueError(f"unknown wetting model {model!r}")

    def wet_speed(self, cos_ca):
        if self.model == "linear":
            return (self.cos_ts - cos_ca) / self.beta
        if self.model == "blake":
            return self.v0 * torch.sinh(self.g * (self.cos_ts - cos_ca))
        if self.model == "cox":
            theta = torch.arccos(_clip(cos_ca, -0.999999, 0.999999))
            ca = cox_wetting_ca(theta, self.theta_s, lam=self.lam,
                                eps_slip=self.eps_slip)
            return (self.g / self.mu) * ca
        if self.model == "shik":
            return shik_wetting_speed(cos_ca, self.cos_ts, self.theta_max,
                                      self.v0, self.g)
        ca_d = hoffman_correlation_ca(-cos_ca)
        ca_s = hoffman_correlation_ca(cos_ca.new_full((), -self.cos_ts))
        return (self.g / self.mu) * (ca_d - ca_s)

    def residual(self, sfv, mat, params):
        F = sfv.val[FILL_VAR][:, 0]
        gF = sfv.grad[FILL_VAR][:, 0, :]
        nf = gF / _floor(torch.linalg.vector_norm(gF, dim=1, keepdim=True), 1e-30)
        nw = sfv.normal
        cos_ca = torch.einsum("qk,qk->q", nw, nf)
        tmag = torch.sqrt(_floor(1.0 - cos_ca**2, 1e-20))
        t = (nf - cos_ca[:, None] * nw) / tmag[:, None]
        V = self.wet_speed(cos_ca)
        dl = delta(F, self.alpha)
        u = sfv.val["velocity"]
        mis = u - t * V[:, None]
        phi = sfv.phi["velocity"]
        return (dl / self.depth)[:, None, None] * torch.einsum(
            "qa,qi->qai", mis, phi)


class CapRepulse(FaceKernel):
    """CAP_REPULSE (``src/mm_ns_bc.c:5489``): repulsive normal traction
    keeping a free surface off a solid boundary, force = -P_rep /
    (dist(x)/hscale)^repexp, added to the capillary traction;
    ``dist_fn(x) -> (nq,)`` the distance to the repelling geometry.
    ``betainv`` adds the matching distance-dependent slip resistance."""

    def __init__(self, dim: int, dist_fn, P_rep: float, hscale: float = 1.0,
                 repexp: float = 2.0, betainv: float = 0.0):
        super().__init__("velocity", dim)
        self.dim = dim
        self.dist_fn = dist_fn
        self.P_rep = P_rep
        self.hscale = hscale
        self.repexp = repexp
        self.betainv = betainv

    def residual(self, sfv, mat, params):
        dist = _floor(torch.as_tensor(self.dist_fn(sfv.x)), 1e-12)
        force = -self.P_rep / (dist / self.hscale) ** self.repexp
        phi = sfv.phi["velocity"]
        n = sfv.normal
        # traction addition sigma.n += force * n -> weak term -phi force n
        out = -torch.einsum("q,qa,qi->qai", force, n, phi)
        if self.betainv:
            invs = self.betainv / (dist / self.hscale) ** self.repexp
            u = sfv.val["velocity"]
            ut = u - torch.einsum("qk,qk->q", n, u)[:, None] * n
            out = out + invs[:, None, None] * torch.einsum("qa,qi->qai", ut, phi)
        return out


class RepulsiveForce(FaceKernel):
    """REP_FORCE / ATTR_FORCE family (``src/mm_fill_solid.c:1570``, roll
    variant :1725): a normal surface traction that keeps a deforming
    boundary away from (or pulls it toward) a wall,

        repulsive:  f = -pr / d(x)^m,   attractive: f = +pr * d(x)^m,

    along the surface normal, optionally with a Coulomb-like tangential
    part ``friction * f``. ``d(x)``: the distance to the plane a x + b y +
    c z + dp = 0, or ``dist_fn(x) -> (nq,)``. ``var`` selects the
    equation."""

    def __init__(self, dim: int, pr: float, repexp: float = 4.0,
                 plane=None, dist_fn=None, friction: float = 0.0,
                 attract: bool = False, var: str = "mesh_displacement"):
        super().__init__(var, dim)
        self.dim = dim
        self.pr = pr
        self.repexp = repexp
        self.friction = friction
        self.attract = attract
        if (plane is None) == (dist_fn is None):
            raise ValueError("give exactly one of plane=(a,b,c,d) or "
                             "dist_fn")
        self.plane = None if plane is None else np.asarray(plane, dtype=float)
        self.dist_fn = dist_fn

    def _dist(self, x):
        if self.dist_fn is not None:
            return self.dist_fn(x)
        p = torch.as_tensor(self.plane, dtype=x.dtype, device=x.device)
        denom = torch.sqrt(torch.sum(p[: self.dim] ** 2))
        return torch.abs(torch.einsum("qk,k->q", x, p[: self.dim]) + p[3]) / denom

    def residual(self, sfv, mat, params):
        d = self._dist(sfv.x)
        f = self.pr * d ** self.repexp if self.attract \
            else -self.pr / d ** self.repexp
        tvec = sfv.normal
        if self.friction:
            t1 = sfv.tangents[:, :, 0]
            t1 = t1 / torch.linalg.vector_norm(t1, dim=1, keepdim=True)
            tvec = tvec + self.friction * t1
        phi = sfv.phi[self.var]
        # weak form adds -phi f n (a traction, reference func[a] convention)
        return -torch.einsum("q,qa,qi->qai", f, tvec, phi)


class HysteresisWetting(LSWettingSpeed):
    """HYSTERESIS_WETTING_BC: the contact line is pinned (zero wetting
    speed) while the dynamic angle sits inside [theta_rec, theta_adv],
    advances linearly beyond theta_adv and recedes below theta_rec:

        V = (cos(theta_adv) - cos(theta_d))/beta_adv   if theta_d > theta_adv
            (cos(theta_rec) - cos(theta_d))/beta_rec   if theta_d < theta_rec
            0                                          otherwise

    (the reference aborts on this card, ``src/mm_ns_bc.c:15573``; goma_tpu
    supplies this stick-slip window), through the same delta-band velocity
    penalty as :class:`LSWettingSpeed`."""

    def __init__(self, dim: int, theta_adv_deg: float, theta_rec_deg: float,
                 alpha: float, beta_adv: float = 1.0, beta_rec: float = None,
                 depth: float = 1.0):
        if theta_rec_deg > theta_adv_deg:
            raise ValueError("receding angle must not exceed advancing")
        super().__init__(dim, theta_s_deg=theta_adv_deg, alpha=alpha,
                         model="linear", beta=beta_adv, depth=depth)
        self.cos_adv = float(np.cos(np.deg2rad(theta_adv_deg)))
        self.cos_rec = float(np.cos(np.deg2rad(theta_rec_deg)))
        self.beta_adv = beta_adv
        self.beta_rec = beta_adv if beta_rec is None else beta_rec

    def wet_speed(self, cos_ca):
        adv = (self.cos_adv - cos_ca) / self.beta_adv  # > 0 past theta_adv
        rec = (self.cos_rec - cos_ca) / self.beta_rec  # < 0 below theta_rec
        zero = torch.zeros_like(cos_ca)
        return torch.where(cos_ca < self.cos_adv, adv,
                           torch.where(cos_ca > self.cos_rec, rec, zero))


def _wall_contact_geometry(sfv, fill_var=FILL_VAR):
    """The diffuse LS-wall contact band: F, |grad F|, n_ls, the wall normal
    n_w, the wall tangent t (oriented by sign((n_ls x n_w)_z) in 2D, the
    reference's pick in apply_CA_FILL src/mm_ns_bc.c:11362; t = n_w x
    (n_ls x n_w)/|..| in 3D) and dp = t . n_ls."""
    F = sfv.val[fill_var][:, 0]
    gF = sfv.grad[fill_var][:, 0, :]
    mag = torch.sqrt(torch.sum(gF * gF, dim=1) + 1e-30)
    n_ls = gF / mag[:, None]
    nw = sfv.normal
    if nw.shape[1] == 2:
        sign = torch.sign(n_ls[:, 0] * nw[:, 1] - n_ls[:, 1] * nw[:, 0])
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        t = torch.stack([sign * nw[:, 1], -sign * nw[:, 0]], dim=1)
    else:
        ll = torch.linalg.cross(n_ls, nw, dim=1)
        ll = ll / _floor(torch.linalg.vector_norm(ll, dim=1, keepdim=True), 1e-30)
        t = torch.linalg.cross(nw, ll, dim=1)
        t = t / _floor(torch.linalg.vector_norm(t, dim=1, keepdim=True), 1e-30)
    dp = torch.einsum("qk,qk->q", t, n_ls)
    return F, mag, n_ls, nw, t, dp


class FillContactAngle(FaceKernel):
    """FILL_CA (``src/mm_ns_bc.c:11306 apply_CA_FILL``): the weak Young
    force on the fluid momentum in the diffuse LS-wall contact band,

        f = delta(F)|grad F| sigma (t . n_ls)
            (sin(theta_ca) n_w + cos(theta_ca) t);

    the band integral of delta |grad F| (t.n_ls) is 1, so the total force
    is the sharp Young traction."""

    def __init__(self, dim: int, theta_deg: float, sigma: float, eps=None):
        super().__init__("velocity", dim)
        self.dim = dim
        self.theta = float(np.deg2rad(theta_deg))
        self.sigma = sigma
        self.eps = eps

    def force_dir(self, nw, t):
        return np.sin(self.theta) * nw + np.cos(self.theta) * t

    def residual(self, sfv, mat, params):
        eps = self.eps if self.eps is not None else params["ls_eps"]
        F, mag, n_ls, nw, t, dp = _wall_contact_geometry(sfv)
        dl = delta(F, eps) * mag
        f = (self.sigma * dl * dp)[:, None] * self.force_dir(nw, t)
        phi = sfv.phi["velocity"]
        return -torch.einsum("qa,qi->qai", f, phi)


class WettingTension(FillContactAngle):
    """WETTING_TENSION (``src/mm_ns_bc.c:13556 apply_wetting_tension``):
    the tangential wetting tension W delta (t.n_ls) t, the theta_ca = 0
    branch of :class:`FillContactAngle` with tension W."""

    def __init__(self, dim: int, wetting_tension: float, eps=None):
        super().__init__(dim, theta_deg=0.0, sigma=wetting_tension, eps=eps)
