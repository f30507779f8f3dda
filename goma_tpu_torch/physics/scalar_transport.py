"""Energy and species transport equations (counterpart of
``goma_tpu/physics/scalar_transport.py``).

Parity: ``src/mm_fill_energy.c:107 assemble_energy`` and
``src/mm_fill_species.c:191 assemble_mass_transport`` (Fickian flux).
Weak forms:

  energy:  int phi rho Cp (Tdot + u.grad T) + grad phi . (k grad T) - phi H
  species: int phi (cdot_w + u.grad c_w) + grad phi . (D_w grad c_w) - phi S_w

Cut to this slice: constant or callable ``rho``/``Cp``/``k``/
``diffusivity``, the ``heat_source`` and ``species_source`` keys. The
charged-species (electromigration) flux raises; ``ResidenceTime`` and the
interface kernels of the module are later slices.
"""

from __future__ import annotations

import torch

from goma_tpu_torch.fem.equations import Equation
from goma_tpu_torch.physics.fluid import _as_nq, advective_velocity
from goma_tpu_torch.physics.materials import prop


class Energy(Equation):
    def __init__(self, interp: str = "Q2", transient: bool = True,
                 convection: bool = True):
        super().__init__("temperature", 1, interp)
        self.transient = transient
        self.convection = convection

    def residual(self, fv, mat, params):
        x = fv.x
        nq = x.shape[0]
        gT = fv.grad["temperature"][:, 0, :]  # (nq, dim)
        rho = _as_nq(prop(mat, "rho", fv, params, 1.0), nq, x)
        Cp = _as_nq(prop(mat, "Cp", fv, params, 1.0), nq, x)
        k = _as_nq(prop(mat, "k", fv, params, 1.0), nq, x)

        adv = torch.zeros(nq, dtype=x.dtype, device=x.device)
        if self.transient:
            adv = adv + fv.dot["temperature"][:, 0]
        if self.convection and "velocity" in fv.val:
            adv = adv + torch.einsum("qk,qk->q", advective_velocity(fv), gT)
        phi = fv.phi["temperature"]
        contrib = torch.einsum("q,qi->qi", rho * Cp * adv, phi)
        contrib = contrib + torch.einsum("q,qk,qik->qi", k, gT,
                                         fv.gphi["temperature"])
        H = mat.get("heat_source", None)
        if H is not None:
            Hval = _as_nq(H(fv, mat, params) if callable(H) else H, nq, x)
            contrib = contrib - torch.einsum("q,qi->qi", Hval, phi)
        return contrib[:, None, :]


class Species(Equation):
    """Multicomponent Fickian species transport (n_species components)."""

    def __init__(self, n_species: int, interp: str = "Q2",
                 transient: bool = True, convection: bool = True):
        super().__init__("species", n_species, interp)
        self.n_species = n_species
        self.transient = transient
        self.convection = convection

    def residual(self, fv, mat, params):
        if mat.get("charge", None) is not None and "voltage" in fv.val:
            raise NotImplementedError(
                "charged-species flux: later slice of the port, see ROADMAP")
        x = fv.x
        nq, ns = x.shape[0], self.n_species
        gc = fv.grad["species"]  # (nq, ns, dim)
        D = prop(mat, "diffusivity", fv, params, 1.0)
        D = torch.as_tensor(D, dtype=x.dtype, device=x.device)
        if D.ndim == 0:
            D = D.expand(ns)
        adv = torch.zeros((nq, ns), dtype=x.dtype, device=x.device)
        if self.transient:
            adv = adv + fv.dot["species"]
        if self.convection and "velocity" in fv.val:
            adv = adv + torch.einsum("qk,qwk->qw", advective_velocity(fv), gc)
        phi = fv.phi["species"]
        contrib = torch.einsum("qw,qi->qwi", adv, phi)
        contrib = contrib + torch.einsum("w,qwk,qik->qwi", D, gc,
                                         fv.gphi["species"])
        S = mat.get("species_source", None)
        if S is not None:
            Sval = S(fv, mat, params) if callable(S) else torch.as_tensor(
                S, dtype=x.dtype, device=x.device).expand(nq, ns)
            contrib = contrib - torch.einsum("qw,qi->qwi", Sval, phi)
        return contrib
