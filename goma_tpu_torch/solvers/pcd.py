"""PCD (pressure-convection-diffusion) Schur-complement preconditioner
(counterpart of ``goma_tpu/solvers/pcd.py``).

Parity: reference ``src/sl_petsc_pcd.c`` (``PCDShellPCApply:115``) with the
pressure-space operators of ``src/sl_petsc.c set_pcd_matrices:390``:

    Mp    = int phi_i phi_j                      (pressure mass)
    Mp_mu = 0.5/mu * Mp                          (viscous-scaled mass)
    Ap    = int mu grad(phi_i) . grad(phi_j)     (viscous pressure Laplacian)
    Fp    = Ap + int rho (u . grad phi_j) phi_i  (+ rho*ct * Mp transient)

    S^-1 r_p  ~=  Ap^-1 Fp Mp^-1 r_p  +  Mp_mu^-1 r_p

combined with block-Jacobi Richardson sweeps on the velocity block (the
block-triangular field split). As in goma_tpu:

- Ap is formed once on the host (static geometry) and kept as an explicit
  dense float32 inverse: each application is one matvec;
- Fp is matrix-free: the convection term is re-evaluated from the velocity
  at the quadrature points, stored at factor time;
- Mp is lumped (the reference's ``pcd_inverse_diag``);
- ``remove_nodesets`` (the reference's pcd_ss/ns_remove) and the system's
  Dirichlet pressure dofs become identity rows of Ap/Fp.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch.elements import (element_type, eval_basis, geom_interp,
                                     interp_local_nodes, volume_rule)
from goma_tpu_torch.solvers.linear import BlockJacobi, _ext


class PCDFieldSplit:
    """Block-triangular field split with a PCD Schur approximation."""

    def __init__(self, problem, pressure_var: str = "pressure",
                 vel_var: str = "velocity", mu: float = 1.0, rho: float = 1.0,
                 u_sweeps: int = 2, remove_nodesets=(), max_dense: int = 20000):
        dofmap = problem.dofmap
        pattern = problem.pattern
        mesh = problem.mesh
        self.device = dev = problem.device
        self.bj = BlockJacobi(pattern, dofmap, device=dev)
        self.n = pattern.n
        self.u_sweeps = u_sweeps
        self.mu, self.rho = float(mu), float(rho)

        # pressure dof numbering (compressed)
        sv = dofmap.svar(pressure_var)
        pd = dofmap.dof_of_node_svar[:, sv]
        pdofs = np.unique(pd[pd >= 0])
        np_p = pdofs.shape[0]
        if np_p > max_dense:
            raise ValueError(f"PCD dense Ap inverse: {np_p} pressure dofs > {max_dense}")
        self.np_p = np_p
        pidx = np.full(pattern.n, -1, dtype=np.int64)
        pidx[pdofs] = np.arange(np_p)
        pmask = np.zeros(pattern.n, dtype=bool)
        pmask[pdofs] = True
        self.pmask = torch.as_tensor(pmask, device=dev)

        put = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                        device=dev)
        # per-block pressure/velocity quadrature tables (host, static)
        Ap = np.zeros((np_p, np_p))
        Mp_diag = np.zeros(np_p)
        self._blocks = []
        tables = dict(self.bj.tables)
        for bi, (bd, blk) in enumerate(zip(dofmap.blocks, mesh.blocks)):
            try:
                ps = bd.slot(pressure_var)
                vs = bd.slot(vel_var)
            except KeyError:
                continue
            if ps.interp in ("P0", "P1E"):
                continue
            et = element_type(blk.elem_type)
            qpts, qwts = volume_rule(et.family, problem.quad_order)
            _, dNg = eval_basis(et.family, geom_interp(et), qpts)
            Npb, dNp = eval_basis(et.family, ps.interp, qpts)
            Nv, _ = eval_basis(et.family, vs.interp, qpts)
            X = mesh.coords[blk.conn]  # (ne, nn, dim)
            J = np.einsum("qnd,enk->eqkd", dNg, X)
            detJ = np.abs(np.linalg.det(J))
            invJ = np.linalg.inv(J)  # (ne, nq, d, k): dxi_d/dx_k
            gNp = np.einsum("qnd,eqdk->eqnk", dNp, invJ)  # physical grads
            w = detJ * qwts[None, :]  # (ne, nq)
            ln = list(interp_local_nodes(et.family, ps.interp))
            pn = pidx[dofmap.dof_of_node_svar[blk.conn[:, ln], sv]]  # (ne, nbp)
            # velocity local dofs in the element gather, (ne, dim, nbv)
            vg = bd.gather[:, vs.start : vs.start + vs.size].reshape(
                -1, vs.ncomp, vs.nbf)
            Ap_e = self.mu * np.einsum("eq,eqik,eqjk->eij", w, gNp, gNp)
            np.add.at(Ap, (pn[:, :, None], pn[:, None, :]), Ap_e)
            np.add.at(Mp_diag, pn.ravel(), np.einsum("eq,qi->ei", w, Npb).ravel())
            self._blocks.append(bi)
            tables[f"pcd:pn{bi}"] = put(pn)
            # goma_tpu's segment_sum as a segment reduction over the
            # contributions sorted (stably) by pressure dof: no atomics
            order = np.argsort(pn.ravel(), kind="stable")
            tables[f"pcd:order{bi}"] = put(order)
            tables[f"pcd:off{bi}"] = put(np.searchsorted(
                pn.ravel()[order], np.arange(np_p + 1)))
            tables[f"pcd:vg{bi}"] = put(vg.astype(np.int64))
            tables[f"pcd:w{bi}"] = put(w)
            tables[f"pcd:Np{bi}"] = put(Npb)
            tables[f"pcd:Nv{bi}"] = put(Nv)
            tables[f"pcd:gNp{bi}"] = put(gNp)

        # boundary handling (reference pcd_ss/ns_remove): identity rows for
        # the removed node sets and the system's Dirichlet pressure dofs;
        # with none, pin dof 0 to fix Ap's Neumann null space
        rm = []
        for ns in remove_nodesets:
            d = pidx[dofmap.dof_of_node_svar[mesh.nodesets[ns], sv]]
            rm.extend(d[d >= 0].tolist())
        if getattr(problem, "dirichlet_dofs", np.zeros(0)).size:
            d = pidx[problem.dirichlet_dofs]
            rm.extend(d[d >= 0].tolist())
        if not rm:
            rm = [0]
        rm = np.unique(np.asarray(rm, dtype=np.int64))
        Ap[rm, :] = 0.0
        Ap[:, rm] = 0.0
        Ap[rm, rm] = 1.0
        rmask = np.zeros(np_p, dtype=bool)
        rmask[rm] = True
        tables["pcd:rmask"] = put(rmask)
        # dense inverse once (static geometry and viscosity), float32
        tables["pcd:Apinv"] = put(np.linalg.inv(Ap).astype(np.float32))
        tables["pcd:invMp"] = put(
            np.where(Mp_diag > 0, 1.0 / np.maximum(Mp_diag, 1e-300), 0.0))
        tables["pcd:pdofs"] = put(pdofs.astype(np.int64))
        self.tables = tables

    # ---------------------------------------------------------------- factor
    def factor(self, vals, xcur, ct, tb=None):
        """Binv for the velocity sweeps + the current velocity at the
        pressure blocks' quadrature points (drives the matrix-free Fp)."""
        tb = tb or self.tables
        Binv = self.bj.factor(vals)
        uqp = []
        for bi in self._blocks:
            Nv = tb[f"pcd:Nv{bi}"].to(vals.dtype)
            ue = xcur.to(vals.dtype)[tb[f"pcd:vg{bi}"]]  # (ne, dim, nbv)
            uqp.append(torch.einsum("qn,ean->eqa", Nv, ue))
        return (Binv, tuple(uqp),
                torch.as_tensor(ct, dtype=vals.dtype, device=vals.device))

    # ------------------------------------------------------------ Fp matvec
    def _fp_apply(self, a, uqp, ct, tb, dtype):
        """Fp a in pressure space: mu grad-grad + rho u.grad + rho ct mass."""
        out = torch.zeros(self.np_p, dtype=dtype, device=a.device)
        # removed (identity) dofs do not enter the integrals, as the zeroed
        # columns of the stored Ap: Ap^-1 Fp == I in the Stokes limit
        a_ext = _ext(torch.where(tb["pcd:rmask"], 0.0, a))
        for k, bi in enumerate(self._blocks):
            pn = tb[f"pcd:pn{bi}"]
            w = tb[f"pcd:w{bi}"].to(dtype)
            Npb = tb[f"pcd:Np{bi}"].to(dtype)
            gNp = tb[f"pcd:gNp{bi}"].to(dtype)
            ae = a_ext[pn]  # (ne, nbp)
            ga = torch.einsum("eqnk,en->eqk", gNp, ae)
            aq = torch.einsum("qn,en->eq", Npb, ae)
            diff = self.mu * torch.einsum("eq,eqik,eqk->ei", w, gNp, ga)
            conv = self.rho * torch.einsum("eq,eqk,eqk,qi->ei", w, uqp[k], ga, Npb)
            mass = (self.rho * ct) * torch.einsum("eq,eq,qi->ei", w, aq, Npb)
            flat = (diff + conv + mass).reshape(-1)[tb[f"pcd:order{bi}"]]
            out = out + torch.segment_reduce(flat, "sum",
                                             offsets=tb[f"pcd:off{bi}"],
                                             unsafe=True)
        return torch.where(tb["pcd:rmask"], a, out)

    # ----------------------------------------------------------------- apply
    def apply(self, fac, r):
        Binv, uqp, ct, matvec = fac
        tb = self.tables
        dtype = r.dtype
        pm = self.pmask
        r_u = torch.where(pm, 0.0, r)
        z = torch.where(pm, 0.0, self.bj.apply(Binv, r_u))
        for _ in range(self.u_sweeps - 1):
            resid = r_u - torch.where(pm, 0.0, matvec(z))
            z = z + torch.where(pm, 0.0, self.bj.apply(Binv, resid))
        rp = torch.where(pm, r - matvec(z), 0.0)[tb["pcd:pdofs"]]
        invMp = tb["pcd:invMp"].to(dtype)
        # y = Ap^-1 Fp Mp^-1 rp + 2 mu Mp^-1 rp   (PCDShellPCApply order;
        # Mp_mu^-1 = 2 mu Mp^-1)
        a = invMp * rp
        b = self._fp_apply(a, uqp, ct, tb, dtype)
        y = (tb["pcd:Apinv"] @ b.to(torch.float32)).to(dtype)
        y = y + 2.0 * self.mu * invMp * rp
        z_p = torch.zeros(self.n, dtype=dtype, device=r.device)
        z_p[tb["pcd:pdofs"]] = y
        return z + torch.where(pm, z_p, 0.0)
