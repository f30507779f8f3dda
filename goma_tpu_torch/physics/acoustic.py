"""Time-harmonic acoustic pressure (Helmholtz) equations (counterpart of
``goma_tpu/physics/acoustic.py``).

Parity: reference acoustic variables APR/API (real/imaginary harmonic
pressure, ``include/rf_fem_const.h:861``) assembled in ``src/mm_fill.c``'s
acoustic branch. The complex Helmholtz equation lap(p) + k^2 p = 0 splits
into two coupled real equations; the first-order Sommerfeld boundary
dp/dn = -i k p and the piston drive are face kernels.
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import Equation, FaceKernel
from goma_tpu_torch.physics.materials import as_field, prop

APR, API = "acoustic_preal", "acoustic_pimag"


class AcousticHelmholtz(Equation):
    """One of the two coupled real Helmholtz equations; part "real" or
    "imag". Weak form per part: int grad(phi).grad(p) - k^2 phi p."""

    def __init__(self, part: str, k: float, interp: str = "Q2"):
        super().__init__(APR if part == "real" else API, 1, interp)
        self.part = part
        self.k = k

    def residual(self, fv, mat, params):
        var = self.var
        p = fv.val[var][:, 0]
        gp = fv.grad[var][:, 0, :]
        c = torch.einsum("qk,qik->qi", gp, fv.gphi[var]) - self.k**2 * (
            p[:, None] * fv.phi[var])
        return c[:, None, :]


class SommerfeldBC(FaceKernel):
    """First-order absorbing boundary dp/dn = -i k p: the real equation
    gets -k p_imag, the imaginary +k p_real (weak flux)."""

    def __init__(self, part: str, k: float):
        super().__init__(APR if part == "real" else API, 1)
        self.part = part
        self.k = k

    def residual(self, sfv, mat, params):
        if self.part == "real":
            flux = -self.k * sfv.val[API][:, 0]
        else:
            flux = self.k * sfv.val[APR][:, 0]
        return (flux[:, None] * sfv.phi[self.var])[:, None, :]


class ProjectionEquation(Equation):
    """L2 projection of a derived quantity onto a nodal field, int phi (q -
    source(fv)) (the reference's post-variable projections,
    src/mm_post_proc.c), as an equation."""

    def __init__(self, var: str, ncomp: int, source, interp: str = "Q1"):
        super().__init__(var, ncomp, interp)
        self.source = source

    def residual(self, fv, mat, params):
        q = fv.val[self.var]  # (nq, ncomp)
        return torch.einsum("qc,qi->qci", q - self.source(fv, mat, params),
                            fv.phi[self.var])


class AcousticVelocityBC(FaceKernel):
    """APR_VELOCITY / API_VELOCITY (``src/mm_ns_bc.c:14425
    acoustic_plane_transmission``, velocity branch): a prescribed normal
    velocity drives the pressure pair, -v on the real row and +v on the
    imaginary one (dp_r/dn = +v, dp_i/dn = -v). ``v`` a constant or
    callable(sfv, mat, params) -> (nq,)."""

    def __init__(self, part: str, v):
        super().__init__(APR if part == "real" else API, 1)
        self.part = part
        self.v = v

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        v = self.v(sfv, mat, params) if callable(self.v) else as_field(
            self.v, (nq,), sfv.x)
        sgn = -1.0 if self.part == "real" else 1.0
        return sgn * (v[:, None] * sfv.phi[self.var])[:, None, :]


class LSAcousticRadiation(Equation):
    """LS_ACOUSTIC_SOURCE (``src/mm_fill_terms.c:12424
    assemble_ars_source``): the acoustic-radiation pressure jump at the
    level-set interface as a delta-band momentum source,

        f = [ars_jump (p_r^2 + p_i^2)
             + grad_jump (|grad p_r|^2 + |grad p_i|^2)/(k R)^2] / (4 omega)

    along n_ls = grad F/|grad F|. Material keys ``acoustic_k``,
    ``acoustic_R`` when grad_jump != 0."""

    def __init__(self, dim: int, omega: float, ars_jump: float,
                 grad_jump: float = 0.0, interp: str = "Q2"):
        super().__init__("velocity", dim, interp)
        self.dim = dim
        self.omega = omega
        self.ars_jump = ars_jump
        self.grad_jump = grad_jump

    def residual(self, fv, mat, params):
        from goma_tpu_torch.physics.level_set import FILL_VAR, delta

        eps = params["ls_eps"]
        F = fv.val[FILL_VAR][:, 0]
        gF = fv.grad[FILL_VAR][:, 0, :]
        mag = torch.sqrt(torch.sum(gF * gF, dim=1) + 1e-30)
        n_ls = gF / mag[:, None]
        dl = delta(F, eps) * mag
        pr = fv.val[APR][:, 0]
        pi = fv.val[API][:, 0]
        force = self.ars_jump * (pr**2 + pi**2) / (4.0 * self.omega)
        if self.grad_jump:
            k = prop(mat, "acoustic_k", fv, params, 1.0)
            R = prop(mat, "acoustic_R", fv, params, 1.0)
            gpr = fv.grad[APR][:, 0, :]
            gpi = fv.grad[API][:, 0, :]
            g2 = torch.sum(gpr * gpr + gpi * gpi, dim=1)
            force = force + self.grad_jump * g2 / (
                4.0 * self.omega * (k * R) ** 2)
        return -torch.einsum("q,qa,qi->qai", force * dl, n_ls,
                             fv.phi["velocity"])
