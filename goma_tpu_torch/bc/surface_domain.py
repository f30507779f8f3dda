"""Surface-domain coupling conditions: mass transfer and Stefan flow at
internal surfaces between volumetric domains (counterpart of
``goma_tpu/bc/surface_domain.py``).

Parity: reference ``src/bc_surfacedomain.c`` (``mass_flux_sd_bc:44``,
surface mass transfer between volumetric domains with a convective
contribution) and the SURFDOMAINCHEMKIN (SDC_*) family of
``src/bc_integ.c:1192-1247``: ``SDC_STEFANFLOW`` / ``SDC_KIN_SF``
(``sdc_stefan_flow``, ``src/mm_ns_bc.c:1006``), the strong integrated
condition n . rho (v - xdot) + sum_k W_k S_k = 0 on the normal momentum
row, and ``SDC_KIN_SFV`` (``sdc_stefan_volume_flow``), the volume flow
n.(v - xdot) + sum_k V_k S_k = 0.

The mass-transfer exchange is a two-sided conservative
:class:`~goma_tpu_torch.fem.equations.InterfaceKernel` on the paired faces
of a split interface (``Problem.add_interface_kernel``); the Stefan-flow
closures are one-sided face kernels, on the A-side faces of a split
interface or on an ordinary side set.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.fem.equations import FaceKernel, InterfaceKernel
from goma_tpu_torch.physics.electro import on_comp
from goma_tpu_torch.physics.materials import prop


def _conv_normal(sfv, dim):
    """n.(v - xdot) at face quadrature points (reference
    ``get_convection_velocity``, ``src/bc_surfacedomain.c:101``)."""
    v = sfv.val["velocity"][:, :dim] if "velocity" in sfv.val \
        else torch.zeros_like(sfv.x)
    if "mesh_displacement" in sfv.dot:
        v = v - sfv.dot["mesh_displacement"][:, :dim]
    return torch.einsum("qk,qk->q", sfv.normal, v)


class SurfDomainMassFlux(InterfaceKernel):
    """``mass_flux_sd_bc`` (``src/bc_surfacedomain.c:44``): the flux of
    species ``comp`` across an internal surface,
    q_n(A->B) = mtc (Y_A - Y_c) + Y_A n.(v - xdot), added as +q on the
    A-side species rows and -q on the B side (``two_sided=False``: the
    reference's one-sided application)."""

    def __init__(self, mtc: float, Y_c: float, comp: int = 0,
                 ncomp: int = 1, two_sided: bool = True,
                 var: str = "species"):
        super().__init__(var, ncomp)
        self.mtc, self.Y_c, self.comp = mtc, Y_c, comp
        self.two_sided = two_sided

    def residual(self, sa, sb, mat_a, mat_b, params):
        Ya = sa.val[self.var][:, self.comp]
        q = self.mtc * (Ya - self.Y_c) + Ya * _conv_normal(sa, sa.x.shape[1])
        pa, pb = sa.phi[self.var], sb.phi[self.var]
        ca = on_comp(q[:, None] * pa, self.comp, self.ncomp)
        cb = on_comp(-q[:, None] * pb if self.two_sided
                     else torch.zeros_like(pb), self.comp, self.ncomp)
        return ca, cb


class SDCStefanFlow(FaceKernel):
    """``SDC_STEFANFLOW`` / ``SDC_KIN_SF`` (``src/mm_ns_bc.c:1006``
    ``sdc_stefan_flow``): penalty phi_i n_a [n . rho (v - xdot) +
    sum_k W_k S_k] on the velocity rows, tying the normal mass flux through
    a reacting surface to the surface reactions' net mass production.
    ``rates(sfv, mat, params) -> (nq, nspec)`` gives the molar rates S_k;
    ``mol_weights`` the W_k (float64, as goma_tpu's)."""

    def __init__(self, dim: int, mol_weights, rates, penalty: float = 1e6):
        super().__init__("velocity", dim)
        self.dim = dim
        self.mw = np.asarray(mol_weights, dtype=np.float64)
        self.rates = rates
        self.penalty = penalty

    def _source(self, sfv, mat, params):
        S = self.rates(sfv, mat, params)  # (nq, nspec)
        # a product, not einsum: it promotes as jnp.einsum does
        return (S * torch.as_tensor(self.mw, device=sfv.x.device)).sum(-1)

    def residual(self, sfv, mat, params):
        rho = prop(mat, "rho", sfv, params, 1.0)
        if not torch.is_tensor(rho) or rho.dim() == 0:
            rho = torch.full((sfv.x.shape[0],), float(rho),
                             dtype=torch.float64, device=sfv.x.device)
        f = rho * _conv_normal(sfv, self.dim) + self._source(sfv, mat, params)
        return self.penalty * torch.einsum("q,qa,qi->qai", f, sfv.normal,
                                           sfv.phi["velocity"])


class SDCStefanVolumeFlow(SDCStefanFlow):
    """``SDC_KIN_SFV`` (``sdc_stefan_volume_flow``, ``src/bc_integ.c:1230``):
    n.(v - xdot) + sum_k V_k S_k = 0, the partial molar volumes V_k in the
    ``mol_weights`` slot."""

    def residual(self, sfv, mat, params):
        f = _conv_normal(sfv, self.dim) + self._source(sfv, mat, params)
        return self.penalty * torch.einsum("q,qa,qi->qai", f, sfv.normal,
                                           sfv.phi["velocity"])
