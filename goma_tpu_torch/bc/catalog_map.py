"""The parity map over the reference's 653 named BC constants
(counterpart of ``goma_tpu/bc/catalog_map.py``, re-pointed at the port).

The reference enumerates every boundary-condition card as a constant in
``include/rf_bc_const.h`` with application metadata (method + target
equation) in ``include/mm_names.h`` ``BC_Desc[]`` (frozen here as the
port's own copy of ``_ref_bc_desc.json``). Each is classified:

- ``kernel``    — a dedicated named construct exists (class/function);
- ``machinery`` — the card is expressible with existing composable
                  machinery (callable Dirichlet values, NormalFlux/Traction
                  closures, rotated constraints, interface exchange, deck GD
                  factors, ...) — the construct column says how;
- ``n/a``       — the card has no referent in this architecture by design;
- ``todo``      — not covered.

``bc_parity()`` returns {BC_NAME: (status, construct, note)}: goma_tpu's
names and statuses, its constructs named by their ``goma_tpu_torch``
paths. The notes cite goma_tpu's tests, which hold the constructs' claims.
"""

from __future__ import annotations

import json
import os
import re

_HERE = os.path.dirname(__file__)

with open(os.path.join(_HERE, "_ref_bc_desc.json")) as f:
    #: {NAME_BC: [card, method, equation]} — frozen snapshot of the
    #: reference's BC_Desc[] (include/mm_names.h:115)
    REF_BC_DESC: dict[str, list[str]] = json.load(f)


# reference R_* equation -> goma_tpu field (None = variable family absent)
_EQ_VAR = {
    "R_MOMENTUM1": "velocity", "R_MOMENTUM2": "velocity",
    "R_MOMENTUM3": "velocity",
    "R_PMOMENTUM1": "pvelocity", "R_PMOMENTUM2": "pvelocity",
    "R_PMOMENTUM3": "pvelocity",
    "R_MESH1": "mesh_displacement", "R_MESH2": "mesh_displacement",
    "R_MESH3": "mesh_displacement",
    "R_SOLID1": "solid_displacement", "R_SOLID2": "solid_displacement",
    "R_SOLID3": "solid_displacement",
    "R_ENERGY": "temperature",
    "R_MASS": "species", "R_MASS_SURF": "species",
    "R_FILL": "fill",
    "R_PRESSURE": "pressure",
    "R_POTENTIAL": "voltage",
    "R_ACOUS_PREAL": "acous_pr", "R_ACOUS_PIMAG": "acous_pi",
    "R_LUBP": "lub_pressure", "R_LUBP_2": "lub_pressure",
    "R_SHELL_LUBP": "lub_pressure",
    "R_SHELL_SURF_DIV_V": "surf_div_v",
    "R_SURF_CHARGE": "surface_charge",
    "R_SHEAR_RATE": "shear_rate_proj",
    "R_SHELL_FILMP": "shell_filmp", "R_SHELL_FILMH": "shell_filmh",
    "R_SHELL_PARTC": "shell_partc",
    "R_SHELL_ENERGY": "shell_temperature",
    "R_SHELL_SAT_CLOSED": "shell_sat_closed",
    "R_SHELL_SAT_OPEN": "shell_p_open", "R_SHELL_SAT_OPEN_2": "shell_p_open",
    "R_SHELL_SAT_1": "shell_sat_1", "R_SHELL_SAT_2": "shell_sat_2",
    "R_SHELL_SAT_3": "shell_sat_3",
    "R_SHELL_SAT_GASN": "shell_sat_gasn",
    "R_SHELL_CURVATURE": "sh_K", "R_SHELL_TENSION": "sh_tens",
    "R_POR_LIQ_PRES": "porous_pressure", "R_POR_GAS_PRES": "porous_pressure",
    "R_POR_SINK_MASS": "sink_mass",
    "R_EDDY_NU": "turb_nu",
    "R_LAGR_MULT1": "lm", "R_LAGR_MULT2": "lm", "R_LAGR_MULT3": "lm",
    "R_MOMENT0": "moments", "R_MOMENT1": "moments", "R_MOMENT2": "moments",
    "R_MOMENT3": "moments",
    "R_TFMP_MASS": "tfmp_s", "R_TFMP_BOUND": "tfmp_p",
    "R_USTAR": "ustar", "R_VSTAR": "ustar", "R_WSTAR": "ustar",
    "R_PSTAR": "pphi",
    "R_EM_E1_REAL": "em_e_re", "R_EM_E2_REAL": "em_e_re",
    "R_EM_E3_REAL": "em_e_re",
    "R_EM_E1_IMAG": "em_e_im", "R_EM_E2_IMAG": "em_e_im",
    "R_EM_E3_IMAG": "em_e_im",
    "R_EM_H1_REAL": "em_h_real", "R_EM_H2_REAL": "em_h_real",
    "R_EM_H3_REAL": "em_h_real",
    "R_EM_H1_IMAG": "em_h_imag", "R_EM_H2_IMAG": "em_h_imag",
    "R_EM_H3_IMAG": "em_h_imag",
    "R_NORMAL1": "ls_normal", "R_NORMAL2": "ls_normal",
    "R_NORMAL3": "ls_normal",
    "R_BOND_EVOLUTION": "bond",
    "R_VORT_DIR1": "vort_dir", "R_VORT_DIR2": "vort_dir",
    "R_VORT_DIR3": "vort_dir",
}

# stress / velocity-gradient equation families
_STRESS_RE = re.compile(r"R_STRESS\d\d(_\d)?$")
_GRAD_RE = re.compile(r"R_GRADIENT\d\d$")

_DIR = "Problem.add_dirichlet"

# explicit classifications; checked before the generic rules. Each value is
# (status, construct, note). For status "kernel" the construct must be an
# importable dotted name (tests resolve it).
OVERRIDES: dict[str, tuple[str, str, str]] = {
    # -- capillarity / free surface ------------------------------------
    "POTENTIAL_NOBC_BC": ("machinery", "", "natural boundary"),
    "H_FREE_BC": ("machinery", "", "natural boundary on the curvature eq"),
    "H_BC": ("machinery", _DIR, "curvature Dirichlet (LSCurvature field)"),
    "CAPILLARY_BC": ("kernel", "goma_tpu_torch.bc.CapillaryBC",
                     "surface-divergence form; tests/test_ale.py"),
    "CAPILLARY_TABLE_BC": ("machinery", "goma_tpu_torch.bc.CapillaryBC",
                           "sigma as a table/callable of coords/params"),
    "CAPILLARY_SHEAR_VISC_BC": ("kernel",
                "goma_tpu_torch.bc.free_surface.SurfaceViscosity",
                "Boussinesq-Scriven dissipative form (the reference's own signs are heuristic, mm_fill_shell.c:3152); tests/test_bc_traction.py (exact stretch moment + zero cross-shear)"),
    "CAP_REPULSE_BC": ("kernel", "goma_tpu_torch.bc.wetting.CapRepulse",
                       "tests/test_edge_wetting_bcs.py"),
    "CAP_REPULSE_ROLL_BC": ("machinery", "goma_tpu_torch.bc.wetting.CapRepulse",
                            "dist_fn= roll geometry"),
    "CAP_REPULSE_TABLE_BC": ("machinery", "goma_tpu_torch.bc.wetting.CapRepulse",
                             "dist_fn= tabulated geometry"),
    "CAP_REPULSE_USER_BC": ("machinery", "goma_tpu_torch.bc.wetting.CapRepulse",
                            "dist_fn= arbitrary callable"),
    "CAP_ENDFORCE_BC": ("kernel", "goma_tpu_torch.bc.cap_end_force",
                        "tests/test_bc_catalog2.py"),
    "CAP_ENDFORCE_SCALAR_BC": ("machinery", "goma_tpu_torch.bc.cap_end_force",
                               "scalar magnitude variant"),
    "CAP_RECOIL_PRESS_BC": ("kernel",
                            "goma_tpu_torch.physics.level_set.kanouff_recoil",
                            "recoil-pressure fit as boundary traction"),
    "SURFTANG_BC": ("machinery", "goma_tpu_torch.bc.cap_end_force",
                    "surface-tangent endpoint force"),
    "SURFTANG_SCALAR_BC": ("machinery", "goma_tpu_torch.bc.cap_end_force", ""),
    "SURFTANG_EDGE_BC": ("machinery", "goma_tpu_torch.bc.cap_end_force",
                         "3D edge variant via add_point_load on edge nodes"),
    "SURFTANG_SCALAR_EDGE_BC": ("machinery", "goma_tpu_torch.bc.cap_end_force",
                                ""),
    "CA_BC": ("kernel", "goma_tpu_torch.bc.contact_angle_force",
              "tests/test_bc_catalog2.py"),
    "CA_OR_FIX_BC": ("machinery",
                "goma_tpu_torch.bc.edge.CAEdgeOrFix",
                "2D nodal flavor of the same gate"),
    "CA_MOMENTUM_BC": ("machinery", "goma_tpu_torch.bc.edge.CAEdge",
                       "CAEdge(var='velocity'): the fapply_CA misfit on the "
                       "momentum rows in place of the kinematic row "
                       "(bc_special.c:642); tests/test_bc_catalog4.py"),
    "CA_EDGE_BC": ("kernel", "goma_tpu_torch.bc.edge.CAEdge",
                   "tests/test_ca_edge_porous.py"),
    "CA_EDGE_INT_BC": ("machinery", "goma_tpu_torch.bc.edge.CAEdge",
                       "integrated variant, same kernel"),
    "CA_EDGE_CURVE_BC": ("machinery",
                "goma_tpu_torch.bc.edge.CAEdge",
                "our CAEdge evaluates the wall normal from the secondary sideset geometry by construction (the _CURVE variant)"),
    "CA_EDGE_CURVE_INT_BC": ("machinery",
                "goma_tpu_torch.bc.edge.CAEdge",
                "strong-integrated flavor of the same condition"),
    "CA_EDGE_OR_FIX_BC": ("kernel",
                "goma_tpu_torch.bc.edge.CAEdgeOrFix",
                "tests/test_ca_edge_porous.py (far-feature CAEdge equivalence + feature pinning)"),
    "VAR_CA_EDGE_BC": ("kernel", "goma_tpu_torch.bc.edge.VarCAEdge",
                       "tests/test_ca_edge_porous.py"),
    "VAR_CA_USER_BC": ("machinery", "goma_tpu_torch.bc.edge.CAEdge",
                       "theta as arbitrary callable"),
    "MOVING_CA_BC": ("kernel", "goma_tpu_torch.bc.edge.MovingCAEdge",
                     "tanh contact-line-speed dynamic angle (static/"
                     "advancing/wall-frame limits exact); "
                     "tests/test_bc_catalog4.py"),
    "KINEMATIC_BC": ("kernel", "goma_tpu_torch.bc.KinematicBC",
                     "tests/test_ale.py"),
    "KINEMATIC_PETROV_BC": ("machinery", "goma_tpu_torch.bc.KinematicBC",
                            "weak/penalty form"),
    "KINEMATIC_COLLOC_BC": ("machinery", "goma_tpu_torch.bc.KinematicBC",
                            "pointwise enforcement variant"),
    "KINEMATIC_DISC_BC": ("machinery",
                          "goma_tpu_torch.mesh.interface.split_interface",
                          "kinematic on a discontinuous interface"),
    "KINEMATIC_EDGE_BC": ("machinery",
                "goma_tpu_torch.bc.edge.VeloNormalEdge",
                "edge-curve kinematic closure on the mesh-normal rows"),
    "KINEMATIC_SPECIES_BC": ("kernel",
                      "goma_tpu_torch.bc.SpeciesKinematicFlux",
                      "tests/test_electrode_ni.py (exact suction balance)"),
    "KINEMATIC_SC_BC": ("n/a",
                "",
                "metadata-only constant in the snapshot (headers only, no assembly)"),
    "KINEMATIC_ETA_BC": ("n/a", "", "reference isoparametric-coordinate "
                         "regularization of its mesh solver"),
    "KINEMATIC_XI_BC": ("n/a", "", "same"),
    "ELLIPTIC_ETA_REGULARIZATION_BC": (
        "n/a", "", "built into EllipticMesh (physics/mesh_motion.py)"),
    "ELLIPTIC_XI_REGULARIZATION_BC": (
        "n/a", "", "built into EllipticMesh"),
    # -- slip family ----------------------------------------------------
    "VELO_SLIP_BC": ("kernel", "goma_tpu_torch.bc.NavierSlip",
                     "tests/test_bc_catalog.py"),
    "VELO_SLIP_ROT_BC": ("machinery", "goma_tpu_torch.bc.NavierSlip",
                         "tangential_only + rotated no-penetration"),
    "VELO_SLIP_SOLID_BC": ("machinery", "goma_tpu_torch.bc.NavierSlip",
                           "u_wall = solid surface velocity callable"),
    "VELO_SLIP_FLUID_BC": ("machinery", "goma_tpu_torch.bc.NavierSlip",
                           "u_wall from the second fluid"),
    "VELO_SLIP_ROT_FLUID_BC": ("machinery", "goma_tpu_torch.bc.NavierSlip", ""),
    "VELO_TANGENT_SOLID_BC": ("machinery", "goma_tpu_torch.bc.NavierSlip",
                              "tests/test_bc_catalog2.py"),
    "VELO_SLIP_POWER_BC": ("kernel", "goma_tpu_torch.bc.PowerLawSlip",
                           "tests/test_bc_catalog3.py"),
    "VELO_SLIP_POWER_CARD_BC": ("machinery", "goma_tpu_torch.bc.PowerLawSlip",
                                "constant-tangent variant (tangent=)"),
    "VELO_SLIP_EK_BC": ("kernel", "goma_tpu_torch.bc.ElectrokineticSlip",
                        "tests/test_bc_catalog3.py"),
    "VELO_STREAMING_BC": ("machinery", "goma_tpu_torch.bc.ElectrokineticSlip",
                          "streaming-potential variant"),
    "VELO_SLIP_FILL_BC": ("kernel", "goma_tpu_torch.bc.LevelSetSlip",
                          "tests/test_bc_catalog3.py"),
    "VELO_SLIP_LEVEL_BC": ("machinery", "goma_tpu_torch.bc.LevelSetSlip", ""),
    "VELO_SLIP_LEVEL_SIC_BC": ("machinery", "goma_tpu_torch.bc.LevelSetSlip",
                               "strong variant via small beta"),
    "VELO_SLIP_LS_HEAVISIDE_BC": ("machinery", "goma_tpu_torch.bc.LevelSetSlip",
                                  ""),
    "VELO_SLIP_LS_ORIENTED_BC": ("machinery", "goma_tpu_torch.bc.LevelSetSlip",
                                 ""),
    "VELO_SLIP_ROT_FILL_BC": ("machinery", "goma_tpu_torch.bc.LevelSetSlip",
                              "tangential_only=True"),
    "VELO_SLIP_LS_ROT_BC": ("machinery", "goma_tpu_torch.bc.LevelSetSlip", ""),
    "AIR_FILM_BC": ("kernel",
                "goma_tpu_torch.bc.AirFilmSlip",
                "tests/test_bc_traction.py (NavierSlip equivalence + gas_flow branch)"),
    "AIR_FILM_ROT_BC": ("machinery",
                "goma_tpu_torch.bc.AirFilmSlip",
                "rotation=(omega, x0, y0) rigid substrate field (value-exact test)"),
    "Q_VELO_SLIP_BC": ("kernel", "goma_tpu_torch.bc.SlipHeating",
                       "tests/test_bc_catalog3.py"),
    "VELO_EK_3D_BC": ("machinery", "goma_tpu_torch.bc.ElectrokineticSlip",
                      "3D tangent set of the Helmholtz-Smoluchowski "
                      "slip"),
    # -- strong velocity constraints -------------------------------------
    "VELO_NORMAL_BC": ("kernel", "goma_tpu_torch.bc.rotation",
                       "add_rotated_dirichlet; tests/test_rotation.py"),
    "VELO_TANGENT_BC": ("kernel", "goma_tpu_torch.bc.rotation",
                        "add_rotated_dirichlet"),
    "VELO_NORM_COLLOC_BC": ("machinery", "goma_tpu_torch.bc.rotation",
                            "collocated strong variant, same rows"),
    "VELO_TANG1_COLLOC_BC": ("machinery", "goma_tpu_torch.bc.rotation", ""),
    "VELO_TANG2_COLLOC_BC": ("machinery", "goma_tpu_torch.bc.rotation", ""),
    "VELO_TANGENT_3D_BC": ("machinery", "goma_tpu_torch.bc.rotation",
                           "tangent direction specified"),
    "ZERO_VELO_TANGENT_3D_BC": ("machinery", "goma_tpu_torch.bc.rotation",
                                "zero tangential velocity"),
    "VELO_TANGENT_USER_BC": ("machinery", "goma_tpu_torch.bc.rotation",
                             "callable value"),
    "VELO_NORMAL_EDGE_BC": ("kernel", "goma_tpu_torch.bc.edge.VeloNormalEdge",
                            "tests/test_edge_wetting_bcs.py"),
    "VELO_TANGENT_EDGE_BC": ("kernel", "goma_tpu_torch.bc.edge.VeloTangentEdge",
                             "tests/test_edge_wetting_bcs.py"),
    "VELO_NORMAL_EDGE_INT_BC": ("machinery",
                                "goma_tpu_torch.bc.edge.VeloNormalEdge", ""),
    "VELO_TANGENT_EDGE_INT_BC": ("machinery",
                                 "goma_tpu_torch.bc.edge.VeloTangentEdge", ""),
    "VELO_NORMAL_SOLID_BC": ("machinery", "goma_tpu_torch.bc.rotation",
                             "value = solid surface normal velocity"),
    "VELO_NORMAL_DISC_BC": ("kernel",
                "goma_tpu_torch.physics.interface.MassFluxContinuity",
                "tests/test_interface.py (exact density-jump velocity)"),
    "VELO_NORMAL_LS_BC": ("kernel", "goma_tpu_torch.bc.LSNoPenetration",
                          "tests/test_ls_velo_bc.py (liquid/gas/leak gate)"),
    "VELO_NORMAL_LS_COLLOC_BC": ("machinery", "goma_tpu_torch.bc.LSNoPenetration",
                                 "collocated weighting variant of the same "
                                 "gated constraint"),
    "VELO_NORMAL_LS_PETROV_BC": ("machinery", "goma_tpu_torch.bc.LSNoPenetration",
                                 "Petrov-Galerkin weighting variant"),
    "VELO_NORMAL_LUB_BC": ("kernel",
                           "goma_tpu_torch.physics.lubrication.LubEndKinematic",
                           "tests/test_lub_film_junction.py (exact mean "
                           "end velocity)"),
    "VELO_TANGENT_LS_BC": ("kernel", "goma_tpu_torch.bc.LSNoPenetration",
                           "tangential=True; tests/test_ls_velo_bc.py "
                           "(Couette exact)"),
    "DVZDR_ZERO_BC": ("kernel",
                "goma_tpu_torch.bc.DvzdrZero",
                "tests/test_acoustic_bc.py (exact free-spin Couette)"),
    "CONT_NORM_VEL_BC": ("n/a", "", "velocity continuous by construction "
                         "(single velocity field)"),
    "CONT_TANG_VEL_BC": ("n/a", "", "same"),
    "DISCONTINUOUS_VELO_BC": ("machinery",
                              "goma_tpu_torch.mesh.interface.split_interface",
                              "node splitting + paired-face kernels"),
    "LAGRANGE_NO_SLIP_BC": ("machinery", "goma_tpu_torch.physics.OversetLM",
                            "LM-enforced no-slip on an immersed boundary"),
    "SOLID_LAGRANGE_MULT_BC": ("machinery", "goma_tpu_torch.physics.OversetLM",
                               ""),
    "LGR_FLOWRATE_BC": ("machinery", "goma_tpu_torch.solvers.bordered",
                        "flow-rate augmenting condition (AC bordering)"),
    "NO_SLIP_BC": ("machinery", "goma_tpu_torch.physics.solid.tie_mesh_to_solid",
                   "v = xdot via kinematic tie"),
    "NO_SLIP_RS_BC": ("machinery",
                      "goma_tpu_torch.physics.solid.tie_mesh_to_solid", ""),
    # -- open boundaries / outflow ---------------------------------------
    "FLOW_PRESSURE_BC": ("kernel", "goma_tpu_torch.bc.FlowPressure",
                         "tests/test_bc_catalog.py"),
    "FLOW_HYDROSTATIC_BC": ("kernel", "goma_tpu_torch.bc.FlowPressure",
                            "tests/test_bc_catalog.py"),
    "FLOW_PRESSURE_VAR_BC": ("machinery", "goma_tpu_torch.bc.FlowPressure",
                             "p0 callable"),
    "FLOW_PRESS_USER_BC": ("machinery", "goma_tpu_torch.bc.FlowPressure", ""),
    "PRESSURE_USER_BC": ("machinery", "goma_tpu_torch.bc.FlowPressure",
                         "tests/test_bc_catalog2.py"),
    "FLOW_STRESSNOBC_BC": ("machinery", "", "natural do-nothing outflow"),
    "FLOW_GRADV_BC": ("kernel", "goma_tpu_torch.bc.FlowGradV",
                      "tests/test_bc_traction.py (Poiseuille outflow)"),
    "FLOW_GRADV_SIC_BC": ("machinery", "goma_tpu_torch.bc.FlowGradV",
                          "penalty= variant (strong SIC application)"),
    "FLOW_GRADV_T_BC": ("machinery", "goma_tpu_torch.bc.FlowGradV",
                        "transpose=True"),
    "HYDROSTATIC_SYMM_BC": ("n/a",
                "",
                "reference aborts: 'HYDROSTATIC_SYMM is no longer supported' (bc_integ.c:1161)"),
    "PSPG_BC": ("n/a", "", "PSPG stabilization is built into Continuity"),
    "STRESS_DEVELOPED_BC": ("machinery",
                            "goma_tpu_torch.physics.viscoelastic.DGStressInflow",
                            "developed VE stress at inflow"),
    "MAX_INLET_BC": ("n/a", "", "legacy input constant: no assembly case "
                     "in the reference snapshot"),
    "FILL_INLET_BC": ("machinery", _DIR, "fill Dirichlet at the inlet"),
    "LS_INLET_BC": ("machinery", _DIR, ""),
    # -- thermal ----------------------------------------------------------
    "QCONV_BC": ("kernel", "goma_tpu_torch.bc.ConvectiveHeatFlux",
                 "tests/test_bc_catalog.py"),
    "QRAD_BC": ("kernel", "goma_tpu_torch.bc.RadiativeHeatFlux",
                "tests/test_bc_catalog2.py"),
    "QRAD_REPULSE_ROLL_BC": ("machinery", "goma_tpu_torch.bc.RadiativeHeatFlux",
                             "compose with roll-distance callable"),
    "DOUBLE_RAD_BC": ("machinery", "goma_tpu_torch.bc.RadiativeHeatFlux",
                      "two kernels on one side set (two environments)"),
    "QSIDE_BC": ("kernel", "goma_tpu_torch.bc.NormalFlux",
                 "tests/test_advice_fixes.py"),
    "QSIDE_DIR_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux",
                     "directional flux via callable with sfv.normal"),
    "QSIDE_LS_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux",
                    "LS-modulated flux via callable of fill"),
    "QUSER_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux", "callable flux"),
    "QVARY_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux",
                 "space/time-dependent flux callable"),
    "QNOBC_BC": ("machinery", "", "natural (insulated) boundary"),
    "Q_LASER_WELD_BC": ("kernel", "goma_tpu_torch.bc.LaserWeldFlux",
                        "tests/test_bc_catalog3.py"),
    "Q_VAPOR_BC": ("kernel", "goma_tpu_torch.bc.QVaporFlux",
                   "tests/test_bc_catalog3.py"),
    "Q_RAIL_BC": ("n/a",
                "",
                "metadata-only constant in the snapshot (headers only, no assembly)"),
    "QREACT_BC": ("machinery",
                  "goma_tpu_torch.physics.placid.surface_kinetics_flux",
                  "surface-reaction heat release closure"),
    "T_CONTACT_RESIS_BC": ("kernel",
                           "goma_tpu_torch.physics.interface.InterfaceExchange",
                           "tests/test_interface.py"),
    "T_CONTACT_RESIS_2_BC": ("machinery",
                             "goma_tpu_torch.physics.interface.InterfaceExchange",
                             "two-sided variant, same kernel"),
    "CONTACT_RESISTANCE_BC": ("machinery",
                              "goma_tpu_torch.physics.interface.InterfaceExchange",
                              ""),
    "T_MELT_BC": ("machinery", _DIR, "T = T_melt on the moving front "
                  "(pairs with DISTNG)"),
    "T_USER_BC": ("machinery", _DIR, "callable Dirichlet value"),
    "LATENT_HEAT_BC": ("kernel", "goma_tpu_torch.bc.LatentHeatFlux",
                       "tests/test_ca_edge_porous.py"),
    "LATENT_HEAT_INTERNAL_BC": ("kernel",
                "goma_tpu_torch.bc.LatentHeatInternal",
                "tests/test_acoustic_bc.py (exact conduction slope)"),
    "HEAT_OF_RXN_BC": ("machinery",
                       "goma_tpu_torch.physics.interface.InterfaceExchange",
                       "interfacial reaction heat closure"),
    # -- species / electrochemistry --------------------------------------
    "YFLUX_BC": ("kernel", "goma_tpu_torch.bc.MassTransferFlux",
                 "tests/test_bc_catalog2.py"),
    "YFLUX_CONST_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux",
                       "constant species flux"),
    "YTOTALFLUX_CONST_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux", ""),
    "YFLUX_USER_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux",
                      "callable flux"),
    "YUSER_BC": ("machinery", _DIR, "callable Dirichlet value"),
    "YFLUX_BV_BC": ("kernel", "goma_tpu_torch.physics.ButlerVolmerBC",
                    "tests/test_physics_breadth.py"),
    "YFLUX_BV2_BC": ("machinery", "goma_tpu_torch.physics.ButlerVolmerBC",
                     "parameterization variant"),
    "YFLUX_HOR_BC": ("kernel", "goma_tpu_torch.physics.electro.HORFlux",
                     "tests/test_bc_catalog2.py"),
    "YFLUX_ORR_BC": ("kernel", "goma_tpu_torch.physics.electro.ORRFlux",
                     "tests/test_physics_breadth.py"),
    "YFLUX_SULFIDATION_BC": (
        "kernel", "goma_tpu_torch.physics.placid.surface_kinetics_flux",
        "PLACID site-fraction flux; tests/test_placid.py"),
    "YFLUX_EQUIL_BC": ("machinery",
                       "goma_tpu_torch.physics.interface.InterfaceExchange",
                       "equilibrium partition flux (Henry/Raoult)"),
    "YFLUX_ALLOY_BC": ("kernel", "goma_tpu_torch.physics.electro.AlloyEvapFlux",
                       "cubic-in-T evaporation; tests/test_electrode_ni.py"),
    "SURFACE_CHARGE_BC": ("kernel",
                          "goma_tpu_torch.physics.electro."
                          "surface_charge_constraint",
                          "strong sum(z_i c_i)=sigma point constraint; "
                          "tests/test_electrode_ni.py"),
    "YFLUX_ETCH_BC": ("kernel",
                "goma_tpu_torch.physics.species_flux.KOHSiEtchFlux",
                "Seidel KOH/Si(100) kinetics verbatim; tests/test_electrode_ni.py (stoichiometry-exact)"),
    "YFLUX_NI_BC": ("kernel",
                    "goma_tpu_torch.physics.electro.NickelPlatingFlux",
                    "4-reaction Ni plating kinetics; "
                    "tests/test_electrode_ni.py (exact flux balance)"),
    "YFLUX_H2O_ANODE_BC": ("kernel",
                "goma_tpu_torch.physics.electro.PEMWaterFlux",
                "tests/test_electrode_ni.py (verbatim closure values)"),
    "YFLUX_H2O_CATHODE_BC": ("machinery",
                "goma_tpu_torch.physics.electro.PEMWaterFlux",
                "side='cathode'; tests/test_electrode_ni.py"),
    "YFLUX_SUS_BC": ("kernel", "goma_tpu_torch.physics.species_flux.SuspensionFlux",
                     "tests/test_bc_catalog4.py (Phillips-flux row-sum exact)"),
    "YFLUX_DISC_RXN_BC": (
        "machinery", "goma_tpu_torch.physics.interface.InterfaceExchange",
        "kf c_a - kr c_b interfacial reaction = InterfaceExchange(coeff=kf, "
        "K=kr/kf) on the split interface (exact 2-resistance jump test); "
        "Lagrangian-inertia convective correction via MassFluxContinuity"),
    "YREACT_BC": ("machinery",
                  "goma_tpu_torch.physics.placid.surface_kinetics_flux",
                  "surface-reaction species flux"),
    "Y_DISCONTINUOUS_BC": ("machinery",
                           "goma_tpu_torch.mesh.interface.split_interface",
                           "discontinuous species + exchange kernel"),
    "RAOULTS_LAW_BC": ("machinery",
                       "goma_tpu_torch.physics.interface.InterfaceExchange",
                       "K = vapor-liquid partition; tests/test_interface.py"),
    "VL_EQUIL_BC": ("machinery",
                    "goma_tpu_torch.physics.interface.InterfaceExchange", ""),
    "VL_EQUIL_PRXN_BC": ("machinery",
                         "goma_tpu_torch.physics.interface.InterfaceExchange",
                         "kinetic flavor coeff=k_f, K=k_b/k_f (+callable "
                         "K); tests/test_interface.py (exact kinetic "
                         "jump)"),
    "IS_EQUIL_PRXN_BC": ("machinery",
                         "goma_tpu_torch.physics.interface.InterfaceExchange",
                         "interfacial-species kinetic exchange"),
    "VL_POLY_BC": ("kernel",
                   "goma_tpu_torch.physics.interface.flory_huggins_partition",
                   "tests/test_interface.py (FH activity equilibrium)"),
    "VP_EQUIL_BC": ("kernel", "goma_tpu_torch.physics.interface.InterfaceMatch",
                    "cross-variable porous/gas equilibrium; "
                    "tests/test_interface.py + kelvin_gas_density"),
    "SF_CHEM_BC": ("n/a",
                "",
                "metadata-only constant in the snapshot (no assembly case)"),
    "CURRENT_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux",
                   "imposed current density on the potential eq"),
    "CURRENT_USER_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux", ""),
    "CURRENT_BV_BC": ("kernel", "goma_tpu_torch.physics.ButlerVolmerBC",
                      "tests/test_physics_breadth.py"),
    "CURRENT_BV2_BC": ("machinery", "goma_tpu_torch.physics.ButlerVolmerBC", ""),
    "CURRENT_HOR_BC": ("machinery", "goma_tpu_torch.physics.electro.HORFlux",
                       "same closure on the potential equation"),
    "CURRENT_ORR_BC": ("machinery", "goma_tpu_torch.physics.electro.ORRFlux", ""),
    "CURRENT_NI_BC": ("kernel",
                      "goma_tpu_torch.physics.electro.NickelPlatingFlux",
                      "mode='current'; tests/test_electrode_ni.py"),
    "CURRENT_SIC_BC": ("kernel", "goma_tpu_torch.physics.electro.CurrentSIC",
                       "tests/test_electrode_ni.py (exact linear "
                       "conductor)"),
    "CURRENT_USER_SIC_BC": ("machinery",
                            "goma_tpu_torch.physics.electro.CurrentSIC",
                            "callable i_app(sfv, mat, params)"),
    "VOLT_USER_BC": ("machinery", _DIR, "callable Dirichlet"),
    "FICK_CHRGD_SURF_GRAD_BC": ("kernel",
                "goma_tpu_torch.physics.species_flux.ChargedSurfaceGradient",
                "tests/test_electrode_ni.py (flux identity at convergence)"),
    "KIN_LEAK_BC": ("kernel", "goma_tpu_torch.bc.VNormLeak",
                    "tests/test_ca_edge_porous.py"),
    "KIN_LEAK_HEAT_BC": ("machinery",
                      "goma_tpu_torch.bc.KinematicBC",
                      "leak= Stefan velocity from the LatentHeatFlux balance"),
    "KIN_CHEM_BC": ("machinery", "goma_tpu_torch.bc.SDCStefanFlow",
                    "reaction-driven normal velocity"),
    "KIN_ELECTRODEPOSITION_BC": ("machinery",
                      "goma_tpu_torch.physics.electro.electrodeposition_velocity",
                      "KinematicBC(leak=...) with the Ni deposition rate; closure tested"),
    "VNORM_ELECTRODEPOSITION_BC": ("machinery",
                      "goma_tpu_torch.physics.electro.electrodeposition_velocity",
                      "normal-velocity penalty vnormal=closure"),
    "VNORM_LEAK_BC": ("kernel", "goma_tpu_torch.bc.VNormLeak",
                      "tests/test_ca_edge_porous.py"),
    "VN_POROUS_BC": ("kernel", "goma_tpu_torch.bc.porous_leak.porous_gas_gen_leak",
                     "Darcy rel-mass-flux leak closure on VNormLeak momentum "
                     "rows; tests/test_bc_catalog4.py"),
    "VN_STEFANFLOW_BC": ("machinery", "goma_tpu_torch.bc.SDCStefanFlow",
                         "Stefan velocity on the interface"),
    "MF_STEFANFLOW_BC": ("machinery", "goma_tpu_torch.bc.SDCStefanFlow", ""),
    "SDC_STEFANFLOW_BC": ("kernel", "goma_tpu_torch.bc.SDCStefanFlow",
                          "tests/test_surface_domain.py"),
    "SDC_KIN_SF_BC": ("machinery", "goma_tpu_torch.bc.SDCStefanFlow", ""),
    "SDC_KIN_SFV_BC": ("machinery", "goma_tpu_torch.bc.SDCStefanFlow", ""),
    "SDC_KIN_CHEM_BC": ("n/a",
                "",
                "metadata-only constant in the snapshot (no assembly case)"),
    "SDC_HEATRXN_BC": ("n/a",
                "",
                "card only sets a DV indexing type in the snapshot (rf_setup_problem.c:1225); no assembly function exists"),
    "SDC_SURFRXN_BC": ("machinery",
                       "goma_tpu_torch.bc.surface_domain.SurfDomainMassFlux",
                       "surface-reaction source at the interface"),
    # -- forces on solids / mesh ------------------------------------------
    "FORCE_BC": ("kernel", "goma_tpu_torch.bc.Traction", "tests/test_solid.py"),
    "NORM_FORCE_BC": ("machinery", "goma_tpu_torch.bc.Traction",
                      "callable with sfv.normal"),
    "FORCE_USER_BC": ("machinery", "goma_tpu_torch.bc.Traction", ""),
    "FORCE_RS_BC": ("machinery", "goma_tpu_torch.physics.solid.SolidTraction",
                    "real-solid equation traction"),
    "FORCE_USER_RS_BC": ("machinery",
                         "goma_tpu_torch.physics.solid.SolidTraction", ""),
    "NORM_FORCE_RS_BC": ("machinery",
                         "goma_tpu_torch.physics.solid.SolidTraction", ""),
    "FORCE_SIC_BC": ("kernel", "goma_tpu_torch.bc.ForceSIC",
                     "tests/test_bc_traction.py (uniform-stress parity "
                     "with weak traction)"),
    "FORCE_USER_SIC_BC": ("machinery", "goma_tpu_torch.bc.ForceSIC",
                          "callable force(sfv, mat, params)"),
    "REP_FORCE_BC": ("kernel", "goma_tpu_torch.bc.wetting.RepulsiveForce",
                     "tests/test_bc_catalog3.py"),
    "REP_FORCE_ROLL_BC": ("machinery", "goma_tpu_torch.bc.wetting.RepulsiveForce",
                          "dist_fn= roll geometry"),
    "REP_FORCE_RS_BC": ("machinery", "goma_tpu_torch.bc.wetting.RepulsiveForce",
                        "var='solid_displacement'"),
    "REP_FORCE_ROLL_RS_BC": ("machinery",
                             "goma_tpu_torch.bc.wetting.RepulsiveForce", ""),
    "REP_FORCE_SHU_BC": (
        "machinery", "goma_tpu_torch.bc.sheet.LubPressureLoad",
        "rep_force_shell_n_dot_f_bc's residual is -p_lub n on the bulk "
        "rows (shear term hardwired 0, mm_fill_shell.c:5988) = "
        "LubPressureLoad(scale=-1, var=mesh); row-sum exact test in "
        "tests/test_lub_film_junction.py"),
    "REP_FORCE_SHU_SIC_BC": (
        "machinery", "goma_tpu_torch.bc.sheet.LubPressureLoad",
        "SIC flavor adds the boundary's own elastic traction: compose "
        "LubPressureLoad(scale=-1) + SolidTraction(traction=n.TT closure "
        "from sfv.grad of the displacement) on the same sideset"),
    "ATTR_FORCE_BC": ("machinery", "goma_tpu_torch.bc.wetting.RepulsiveForce",
                      "attract=True"),
    "ATTR_FORCE_RS_BC": ("machinery", "goma_tpu_torch.bc.wetting.RepulsiveForce",
                         "attract=True, var='solid_displacement'"),
    "FRICTION_BC": ("kernel", "goma_tpu_torch.bc.CoulombFriction",
                    "tests/test_bc_traction.py (block shear exact)"),
    "FRICTION_RS_BC": ("machinery", "goma_tpu_torch.bc.CoulombFriction",
                       "var=solid_displacement"),
    "FRICTION_ACOUSTIC_BC": ("kernel", "goma_tpu_torch.bc.CoulombFriction",
                             "acoustic_velocity= Pade reduction; "
                             "tests/test_bc_traction.py"),
    "FRICTION_ACOUSTIC_RS_BC": ("machinery", "goma_tpu_torch.bc.CoulombFriction",
                                ""),
    "ELEC_TRACTION_BC": ("kernel", "goma_tpu_torch.bc.ElecTraction",
                         "tests/test_bc_traction.py (capacitor exact)"),
    "ELEC_TRACTION_SOLID_BC": ("machinery", "goma_tpu_torch.bc.ElecTraction",
                               "var=mesh_displacement"),
    "FLUID_SOLID_BC": ("kernel", "goma_tpu_torch.physics.overset",
                       "BAAIJENS fluid-solid coupling via overset LM; "
                       "tests/test_overset.py"),
    "SOLID_FLUID_BC": ("machinery", "goma_tpu_torch.physics.overset", ""),
    "BAAIJENS_FLUID_SOLID_BC": ("kernel", "goma_tpu_torch.physics.overset",
                                "tests/test_overset.py"),
    "BAAIJENS_SOLID_FLUID_BC": ("machinery", "goma_tpu_torch.physics.overset",
                                ""),
    "FLUID_SOLID_CONTACT_BC": ("machinery", "goma_tpu_torch.physics.overset",
                               "overlapping-grid LM contact (the Baaijens "
                               "machinery, bc_contact.c:1572)"),
    "SOLID_FLUID_CONTACT_BC": ("machinery", "goma_tpu_torch.physics.overset",
                               "solid-side LM rows (bc_contact.c:368)"),
    "FLUID_SOLID_RS_BC": ("machinery",
                          "goma_tpu_torch.physics.solid.tie_fluid_solid",
                          "fluid rows replaced by the interface tie"),
    "SOLID_FLUID_RS_BC": ("kernel",
                          "goma_tpu_torch.physics.solid.tie_fluid_solid",
                          "row-inject traction balance; "
                          "tests/test_fsi_conforming.py (exact uniaxial "
                          "compression)"),
    "ROLL_FLUID_BC": ("machinery",
                "goma_tpu_torch.bc.pointwise.roll",
                "mesh-node roll-surface point constraint (froll geometry)"),
    "FEATURE_ROLLON_BC": ("machinery",
                "goma_tpu_torch.bc.pointwise.roll",
                "feature-gated roll-on span (restrict the nodeset)"),
    "MESH_CONSTRAINT_BC": ("machinery", "goma_tpu_torch.bc.pointwise",
                           "pointwise geometric constraint"),
    # -- geometry / distinguishing conditions ------------------------------
    "PLANE_BC": ("kernel", "goma_tpu_torch.bc.pointwise",
                 "tests/test_rotation.py"),
    "PLANEX_BC": ("machinery", _DIR, "coordinate-plane Dirichlet"),
    "PLANEY_BC": ("machinery", _DIR, ""),
    "PLANEZ_BC": ("machinery", _DIR, ""),
    "MOVING_PLANE_BC": ("machinery", "goma_tpu_torch.bc.pointwise",
                        "time-dependent plane via callable"),
    "MOVING_PLANE_ETCH_BC": ("machinery",
                "goma_tpu_torch.bc.pointwise.moving_plane",
                "etch-rate receding plane (time-parametric point constraint)"),
    "SPLINE_BC": ("kernel", "goma_tpu_torch.bc.pointwise",
                  "geometry constraint f(x)=0; tests/test_ale.py"),
    "SPLINEX_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "SPLINEY_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "SPLINEZ_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "SPLINE_RS_BC": ("machinery", "goma_tpu_torch.bc.pointwise",
                     "real-solid rows"),
    "SPLINEX_RS_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "SPLINEY_RS_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "SPLINEZ_RS_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "GEOM_BC": ("machinery", "goma_tpu_torch.bc.pointwise",
                "alias of SPLINE (reference synonym)"),
    "GEOMX_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "GEOMY_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "GEOMZ_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "SM_PLANE_BC": ("machinery", "goma_tpu_torch.bc.pointwise", ""),
    "FILLET_BC": ("kernel", "goma_tpu_torch.bc.pointwise",
                  "fillet geometry constraint"),
    "FIX_BC": ("machinery", _DIR, "pin dofs at their current values"),
    "DISTNG_BC": ("kernel", "goma_tpu_torch.bc.ls_embedded.add_distng",
                  "tests/test_ls_embedded_bc.py"),
    "DXDISTNG_BC": ("kernel", "goma_tpu_torch.bc.ls_embedded.add_distng",
                    "melt-front isotherm constraint"),
    "DYDISTNG_BC": ("machinery", "goma_tpu_torch.bc.ls_embedded.add_distng", ""),
    "DZDISTNG_BC": ("machinery", "goma_tpu_torch.bc.ls_embedded.add_distng", ""),
    "DNORMALX_BC": ("machinery", "goma_tpu_torch.bc.rotation",
                    "rotated mesh-normal displacement"),
    "DNORMALY_BC": ("machinery", "goma_tpu_torch.bc.rotation", ""),
    "DNORMALZ_BC": ("machinery", "goma_tpu_torch.bc.rotation", ""),
    "SLOPE_BC": ("kernel", "goma_tpu_torch.bc.SlopeBC",
                 "tests/test_bc_traction.py (exact ramp slope)"),
    "SLOPEX_BC": ("machinery", "goma_tpu_torch.bc.SlopeBC", "comp=0 mesh row"),
    "SLOPEY_BC": ("machinery", "goma_tpu_torch.bc.SlopeBC", "comp=1 mesh row"),
    "SLOPEZ_BC": ("machinery", "goma_tpu_torch.bc.SlopeBC", "comp=2 mesh row"),
    "KIN_DISPLACEMENT_BC": ("machinery",
                            "goma_tpu_torch.physics.solid.tie_mesh_to_solid",
                            "mesh follows real-solid displacement"),
    "KIN_DISPLACEMENT_COLLOC_BC": (
        "machinery", "goma_tpu_torch.physics.solid.tie_mesh_to_solid", ""),
    "KIN_DISPLACEMENT_PETROV_BC": (
        "machinery", "goma_tpu_torch.physics.solid.tie_mesh_to_solid", ""),
    "KIN_DISPLACEMENT_RS_BC": (
        "machinery", "goma_tpu_torch.physics.solid.tie_mesh_to_solid", ""),
    # -- level-set embedded family ----------------------------------------
    "LS_CAPILLARY_BC": ("kernel",
                        "goma_tpu_torch.physics.level_set.CSFSurfaceTension",
                        "tests/test_level_set.py"),
    "LS_CAP_HYSING_BC": ("kernel",
                         "goma_tpu_torch.physics.level_set.CSFHysing",
                         "tests/test_ls_cap_variants.py"),
    "LS_CAP_DENNER_DIFF_BC": ("kernel",
                              "goma_tpu_torch.physics.level_set.CSFDennerDiffusion",
                              "tests/test_ls_cap_variants.py (+_n variant "
                              "via use_solved_normal)"),
    "LS_CAP_DIV_N_BC": ("kernel", "goma_tpu_torch.physics.level_set.CSFDivN",
                        "tests/test_ls_cap_variants.py (static bubble)"),
    "LS_CAP_DIV_S_N_BC": ("kernel", "goma_tpu_torch.physics.level_set.CSFDivN",
                          "surface_div=True; tests/test_ls_cap_variants.py"),
    "LS_CAP_CURVE_BC": ("machinery",
                        "goma_tpu_torch.physics.level_set.CSFSurfaceTension",
                        "curvature-equation-fed CSF"),
    "LS_CAPILLARY_GHOST_BC": ("n/a", "", "input constant only in the "
                              "reference snapshot: no assembly case exists "
                              "(grep LS_CAPILLARY_GHOST src/*.c)"),
    "PF_CAPILLARY_BC": ("machinery",
                        "goma_tpu_torch.physics.level_set.CSFSurfaceTension",
                        "fill_var='phase<i>' per phase field "
                        "(assemble_pf_capillary)"),
    "LS_ATTACH_BC": ("kernel", "goma_tpu_torch.bc.ls_embedded.LSAttach",
                     "tests/test_ls_embedded_bc.py"),
    "LS_WALL_ANGLE_BC": ("kernel", "goma_tpu_torch.bc.ls_embedded.LSWallAngle",
                         "tests/test_ls_embedded_bc.py"),
    "LS_CA_H_BC": ("kernel",
                   "goma_tpu_torch.bc.ls_embedded.LSCurvatureWallAngle",
                   "tests/test_ls_embedded_bc.py"),
    "LS_Q_BC": ("kernel", "goma_tpu_torch.physics.level_set.LSEmbeddedFlux",
                "tests/test_ls_round2.py"),
    "LS_QRAD_BC": ("kernel", "goma_tpu_torch.physics.level_set.qrad_flux",
                   "tests/test_ls_round2.py"),
    "LS_QLASER_BC": ("kernel", "goma_tpu_torch.physics.level_set.qlaser_flux",
                     "traveling-Gaussian embedded source"),
    "LS_QVAPOR_BC": ("kernel", "goma_tpu_torch.physics.level_set.qvapor_flux",
                     "Kanouff evaporative loss at the interface"),
    "LS_RECOIL_PRESSURE_BC": ("kernel",
                              "goma_tpu_torch.physics.level_set.LSRecoilPressure",
                              "tests/test_ls_round2.py"),
    "LS_U_BC": ("kernel",
                "goma_tpu_torch.physics.level_set.LSEmbeddedDirichlet",
                "tests/test_bc_catalog3.py"),
    "LS_V_BC": ("machinery",
                "goma_tpu_torch.physics.level_set.LSEmbeddedDirichlet", ""),
    "LS_W_BC": ("machinery",
                "goma_tpu_torch.physics.level_set.LSEmbeddedDirichlet", ""),
    "LS_T_BC": ("kernel",
                "goma_tpu_torch.physics.level_set.LSEmbeddedDirichlet",
                "tests/test_bc_catalog3.py"),
    "LS_YFLUX_BC": ("machinery",
                    "goma_tpu_torch.physics.level_set.LSEmbeddedFlux",
                    "species flux at the embedded interface"),
    "LS_NO_SLIP_BC": ("machinery",
                      "goma_tpu_torch.physics.level_set.LSEmbeddedDirichlet",
                      "all velocity components pinned at the interface"),
    "LS_FLOW_PRESSURE_BC": ("kernel",
                            "goma_tpu_torch.physics.level_set.LSFlowPressure",
                            "tests/test_bc_catalog3.py"),
    "LS_LATENT_HEAT_BC": ("kernel",
                "goma_tpu_torch.physics.level_set.LSLatentHeat",
                "tests/test_ls_cap_variants.py (exact band source)"),
    "LS_ACOUSTIC_SOURCE_BC": ("kernel",
                      "goma_tpu_torch.physics.acoustic.LSAcousticRadiation",
                      "tests/test_acoustic_bc.py (exact band force)"),
    "LS_ADC_BC": ("kernel",
                "goma_tpu_torch.physics.level_set.apply_ls_adc",
                "tests/test_ls_velo_bc.py (capture + distance/alignment gates)"),
    "LS_ADC_OLD_BC": ("machinery",
                "goma_tpu_torch.physics.level_set.apply_ls_adc",
                "sideset-sweep variant (same host operation)"),
    "LS_EIK_KINEMATIC_BC": (
        "machinery", "goma_tpu_torch.physics.level_set.FillExtV",
        "eikonal form: LSExtVKinematic pin + FillExtV advecting F"),
    "LS_EIK_KIN_LEAK_BC": (
        "machinery", "goma_tpu_torch.physics.level_set.FillExtV",
        "LSExtVKinematic(vnorm=leak closure) + FillExtV"),
    "LS_EXTV_KINEMATIC_BC": (
        "kernel", "goma_tpu_torch.physics.level_set.LSExtVKinematic",
        "tests/test_ext_velocity.py"),
    "LS_EXTV_KIN_LEAK_BC": (
        "machinery", "goma_tpu_torch.physics.level_set.LSExtVKinematic",
        "vnorm= kin_bc_leak-style closure (bc.VNormLeak leak fns), "
        "include_fluid per Fill_Equation convention"),
    "LS_EXTV_FLUID_SIC_BC": (
        "machinery", "goma_tpu_torch.physics.level_set.LSExtVKinematic",
        "penalty-scaled band pin v_ext = u.n "
        "(assemble_interface_extension_velocity_sic)"),
    "LS_EXTV_LATENT_BC": (
        "kernel", "goma_tpu_torch.physics.level_set.LSExtVLatent",
        "tests/test_ext_velocity.py"),
    "LS_SOLID_FLUID_BC": ("n/a", "", "input constant only in the "
                          "reference snapshot (no assembly case)"),
    "LS_VELO_NORMAL_BC": ("n/a", "", "legacy input constant: no assembly "
                          "case in the reference snapshot (superseded by "
                          "VELO_NORMAL_LS)"),
    "LS_VELO_TANGENT_BC": ("n/a", "", "legacy input constant: no assembly "
                           "case (superseded by VELO_TANGENT_LS)"),
    "LS_STRESS_JUMP_BC": ("n/a", "", "stress jump implicit in the diffuse "
                          "one-field viscosity blend"),
    "LS_CONT_FLUX_BC": ("n/a", "", "flux continuity holds by construction "
                        "in the one-field formulation"),
    "LS_CONT_T_BC": ("n/a", "", ""),
    "LS_CONT_VEL_BC": ("n/a", "", ""),
    "LS_CONT_TRACTION_BC": ("n/a", "", ""),
    "F_DIODE_BC": ("n/a", "", "reference snapshot aborts on this card "
                   "(mm_bc.c:536 'F_DIODE_BC has special needs')"),
    "STRONG_FILL_CA_BC": ("machinery",
                          "goma_tpu_torch.bc.wetting.FillContactAngle",
                          "strong variant: same Young force, larger "
                          "penalty weight on the fill rows"),
    "FILL_CA_BC": ("kernel", "goma_tpu_torch.bc.wetting.FillContactAngle",
                   "tests/test_edge_wetting_bcs.py (exact total Young "
                   "force)"),
    "SHARP_CA_2D_BC": ("machinery", "goma_tpu_torch.bc.fluid.contact_angle_force",
                       "sharp contact-point Young force as a point load"),
    "SHARP_WETLIN_VELOCITY_BC": ("machinery",
                                 "goma_tpu_torch.bc.wetting.LSWettingSpeed",
                                 "sharp-interface application point"),
    "SHARP_BLAKE_VELOCITY_BC": ("machinery",
                                "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "SHARP_HOFFMAN_VELOCITY_BC": ("machinery",
                                  "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "SHARP_COX_VELOCITY_BC": ("machinery",
                              "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "SHARP_SHIK_VELOCITY_BC": ("machinery",
                               "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "WETTING_SPEED_LIN_BC": ("kernel", "goma_tpu_torch.bc.wetting.LSWettingSpeed",
                             "tests/test_edge_wetting_bcs.py"),
    "WETTING_SPEED_BLAKE_BC": ("kernel",
                               "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "WETTING_SPEED_HOFFMAN_BC": ("kernel",
                                 "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "WETTING_SPEED_COX_BC": ("kernel",
                             "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "WETTING_SPEED_SHIK_BC": ("kernel",
                              "goma_tpu_torch.bc.wetting.shik_wetting_speed", ""),
    "VELO_THETA_TPL_BC": ("kernel", "goma_tpu_torch.bc.wetting.LSWettingSpeed",
                          "Blake TPL model"),
    "VELO_THETA_HOFFMAN_BC": ("kernel",
                              "goma_tpu_torch.bc.wetting.hoffman_correlation_ca",
                              ""),
    "VELO_THETA_COX_BC": ("kernel", "goma_tpu_torch.bc.wetting.cox_wetting_ca",
                          ""),
    "VELO_THETA_SHIK_BC": ("kernel",
                           "goma_tpu_torch.bc.wetting.shik_wetting_speed", ""),
    "BLAKE_DIRICHLET_BC": ("machinery", "goma_tpu_torch.bc.wetting.LSWettingSpeed",
                           "strong limit via small depth weight"),
    "BLAKE_DIRICH_ROLL_BC": ("machinery",
                             "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "HOFFMAN_DIRICHLET_BC": ("machinery",
                             "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "HOFFMAN_DIRICH_ROLL_BC": ("machinery",
                               "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "COX_DIRICHLET_BC": ("machinery", "goma_tpu_torch.bc.wetting.LSWettingSpeed",
                         ""),
    "COX_DIRICH_ROLL_BC": ("machinery",
                           "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "SHIK_DIRICHLET_BC": ("machinery", "goma_tpu_torch.bc.wetting.LSWettingSpeed",
                          ""),
    "SHIK_DIRICH_ROLL_BC": ("machinery",
                            "goma_tpu_torch.bc.wetting.LSWettingSpeed", ""),
    "LINEAR_WETTING_SIC_BC": ("machinery",
                              "goma_tpu_torch.bc.wetting.LSWettingSpeed",
                              "strong variant via penalty weight"),
    "WETTING_TENSION_BC": ("kernel", "goma_tpu_torch.bc.wetting.WettingTension",
                           "tests/test_edge_wetting_bcs.py"),
    "HYSTERESIS_WETTING_BC": ("kernel",
                              "goma_tpu_torch.bc.wetting.HysteresisWetting",
                              "advancing/receding window; reference "
                              "snapshot aborts on this card "
                              "(mm_ns_bc.c:15573); "
                              "tests/test_edge_wetting_bcs.py"),
    # -- EM ----------------------------------------------------------------
    "EM_ER_SOMMERFELD_BC": ("kernel", "goma_tpu_torch.physics.EMAbsorbingBC",
                            "tests/test_em.py"),
    "EM_EI_SOMMERFELD_BC": ("machinery", "goma_tpu_torch.physics.EMAbsorbingBC",
                            ""),
    "EM_HR_SOMMERFELD_BC": ("kernel", "goma_tpu_torch.physics.EMAbsorbingBCH",
                            "tests/test_em.py"),
    "EM_HI_SOMMERFELD_BC": ("machinery", "goma_tpu_torch.physics.EMAbsorbingBCH",
                            ""),
    "EM_ER_FARFIELD_DIRECT_BC": ("machinery",
                                 "goma_tpu_torch.physics.EMAbsorbingBC",
                                 "farfield incident wave term"),
    "EM_EI_FARFIELD_DIRECT_BC": ("machinery",
                                 "goma_tpu_torch.physics.EMAbsorbingBC", ""),
    "EM_HR_FARFIELD_DIRECT_BC": ("machinery",
                                 "goma_tpu_torch.physics.EMAbsorbingBCH",
                                 "farfield incident wave term (H dual)"),
    "EM_HI_FARFIELD_DIRECT_BC": ("machinery",
                                 "goma_tpu_torch.physics.EMAbsorbingBCH", ""),
    "EM_ER_FREE_BC": ("machinery", "", "natural boundary"),
    "EM_EI_FREE_BC": ("machinery", "", "natural boundary"),
    "EM_HR_FREE_BC": ("machinery", "", "natural boundary (EMWaveH)"),
    "EM_HI_FREE_BC": ("machinery", "", "natural boundary (EMWaveH)"),
    "EM_FARFIELD_REAL_NED_BC": ("machinery",
                                "goma_tpu_torch.physics.EMAbsorbingBC",
                                "Nedelec-basis absorbing (EMWaveEdge)"),
    "EM_FARFIELD_IMAG_NED_BC": ("machinery",
                                "goma_tpu_torch.physics.EMAbsorbingBC", ""),
    "EM_ABSORBING_REAL_BC": ("kernel", "goma_tpu_torch.physics.EMAbsorbingBC",
                             "tests/test_em.py"),
    "EM_ABSORBING_IMAG_BC": ("machinery", "goma_tpu_torch.physics.EMAbsorbingBC",
                             ""),
    "E_ER_FARFIELD_BC": ("machinery", "goma_tpu_torch.physics.EMAbsorbingBC", ""),
    "E_EI_FARFIELD_BC": ("machinery", "goma_tpu_torch.physics.EMAbsorbingBC", ""),
    "E_ER_PLANEWAVE_BC": ("machinery", _DIR,
                          "incident plane wave as callable Dirichlet"),
    "E_EI_PLANEWAVE_BC": ("machinery", _DIR, ""),
    "E_ER_2D_BC": ("machinery", _DIR, ""),
    "E_EI_2D_BC": ("machinery", _DIR, ""),
    "EM_ER_MMS_BC": ("n/a", "", "reference-internal MMS test hook"),
    "EM_MMS_SIDE_BC": ("n/a", "", ""),
    "EM_MMS_SIDE_IMAG_BC": ("n/a", "", ""),
    "EM_CONT_REAL_BC": ("n/a", "", "field continuity by construction"),
    "EM_CONT_IMAG_BC": ("n/a", "", ""),
    # -- acoustics / light --------------------------------------------------
    "APR_PLANE_TRANS_BC": ("kernel", "goma_tpu_torch.physics.SommerfeldBC",
                           "plane-wave transmission;"
                           " tests/test_more_physics.py"),
    "API_PLANE_TRANS_BC": ("machinery", "goma_tpu_torch.physics.SommerfeldBC",
                           ""),
    "APR_NOBC_BC": ("machinery", "", "natural boundary"),
    "API_NOBC_BC": ("machinery", "", "natural boundary"),
    "APR_VELOCITY_BC": ("kernel",
                      "goma_tpu_torch.physics.acoustic.AcousticVelocityBC",
                      "tests/test_acoustic_bc.py (exact piston wave)"),
    "API_VELOCITY_BC": ("machinery",
                      "goma_tpu_torch.physics.acoustic.AcousticVelocityBC",
                      "imag-part row"),
    "LIGHTP_TRANS_BC": ("kernel", "goma_tpu_torch.physics.LightIntensity",
                        "Beer-Lambert transport; tests/test_bc_catalog3.py"),
    "LIGHTM_TRANS_BC": ("machinery", "goma_tpu_torch.physics.LightIntensity",
                        "backward wave"),
    "LIGHTD_TRANS_BC": ("machinery", "goma_tpu_torch.physics.LightIntensity",
                        "diffuse field"),
    "LIGHTP_JUMP_BC": ("kernel",
                       "goma_tpu_torch.physics.scalar_transport.LightFresnelJump",
                       "tests/test_interface.py (exact two-layer Fresnel transmission)"),
    "LIGHTM_JUMP_BC": ("machinery",
                       "goma_tpu_torch.physics.scalar_transport.LightFresnelJump",
                       "var='light_intm' backward wave"),
    "LIGHTP_JUMP_2_BC": ("machinery",
                       "goma_tpu_torch.physics.scalar_transport.LightFresnelJump",
                       "block-pair order variant"),
    "LIGHTM_JUMP_2_BC": ("machinery",
                       "goma_tpu_torch.physics.scalar_transport.LightFresnelJump",
                       ""),
    "SURFACE_ACOUSTIC_VELOCITY_BC": ("machinery",
                "goma_tpu_torch.physics.shell.ShellGradBC",
                "acoustic-gradient flux closure on the shell boundary-velocity rows"),
    # -- porous -------------------------------------------------------------
    "POROUS_FLUX_BC": ("kernel", "goma_tpu_torch.bc.PorousMassFlux",
                       "tests/test_ca_edge_porous.py"),
    "POROUS_LIQ_FLUX_CONST_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux",
                                 "constant flux on porous_pressure comp"),
    "POROUS_GAS_FLUX_CONST_BC": ("machinery", "goma_tpu_torch.bc.NormalFlux",
                                 ""),
    "POROUS_PRESSURE_BC": ("machinery",
                           "goma_tpu_torch.physics.interface.InterfaceExchange",
                           "capillary-pressure continuity across blocks"),
    "DARCY_CONTINUOUS_BC": ("machinery",
                            "goma_tpu_torch.physics.interface.InterfaceExchange",
                            "Darcy flux continuity"),
    "DARCY_LUB_BC": ("machinery",
                     "goma_tpu_torch.physics.shell_porous",
                     "porous-shell/lubrication sink coupling"),
    "POROUS_CONV_BC": ("kernel", "goma_tpu_torch.bc.porous_leak.PorousConvection",
                       "saturated/unsaturated branches value-exact; "
                       "tests/test_bc_catalog4.py"),
    "POROUS_GAS_BC": ("machinery",
                      "goma_tpu_torch.physics.interface.InterfaceMatch",
                      "gas-side species flux into the porous rows "
                      "(put_gas_flux_in_pores semantics via scale_b)"),
    "POROUS_SINK_BC": ("machinery", _DIR, "sink_mass Dirichlet"),
    "POROUS_TEMP_BC": ("machinery", _DIR,
                       "temperature Dirichlet on a porous block"),
    "POROUS_PRESSURE_LUB_BC": ("machinery",
                               "goma_tpu_torch.physics.shell_porous", ""),
    "POROUS_LIQ_PRESSURE_FILL_BC": ("machinery",
                "goma_tpu_torch.bc.porous_leak.PorousLSWickingFlux",
                "large perm_c = the collocated pressure-set limit of the same gate"),
    "POR_LIQ_FLUX_FILL_BC": ("kernel",
                "goma_tpu_torch.bc.porous_leak.PorousLSWickingFlux",
                "tests/test_lub_film_junction.py (wet/dry Robin limits)"),
    "P_EQUIL_BC": ("n/a", "", "input constant only in the reference "
                   "snapshot (no assembly case)"),
    "P_LIQ_USER_BC": ("machinery", _DIR, "callable Dirichlet"),
    # -- shells / lubrication ------------------------------------------------
    "GRAD_LUB_PRESS_BC": ("machinery", "goma_tpu_torch.bc.shell_end.EndpointFlux",
                          "lubrication flux at the shell endpoint"),
    "GRAD_LUBP_NOBC_BC": ("machinery", "", "natural endpoint"),
    "LUB_STATIC_BC": ("machinery", _DIR, "static lubrication pressure"),
    "LUB_PRESS_HYDROSTATIC_BC": ("machinery", _DIR,
                                 "hydrostatic lub pressure via callable"),
    "SHELL_GRAD_FP_BC": ("machinery", "goma_tpu_torch.bc.shell_end.EndpointFlux",
                         "film flux at the shell endpoint"),
    "SHELL_GRAD_FP_NOBC_BC": ("machinery", "", "natural"),
    "SHELL_GRAD_FH_BC": ("machinery", "goma_tpu_torch.bc.shell_end.EndpointFlux",
                         ""),
    "SHELL_GRAD_FH_NOBC_BC": ("machinery", "", "natural"),
    "SHELL_GRAD_PC_BC": ("machinery", "goma_tpu_torch.bc.shell_end.EndpointFlux",
                         ""),
    "SHELL_GRAD_PC_NOBC_BC": ("machinery", "", "natural"),
    "SHELL_GRAD_TEMP_BC": ("machinery",
                           "goma_tpu_torch.bc.shell_end.EndpointFlux", ""),
    "SHELL_GRAD_TEMP_NOBC_BC": ("machinery", "", "natural"),
    "SHELL_LUBRICATION_OUTFLOW_BC": ("machinery",
                "goma_tpu_torch.physics.lubrication.TFMPFreeFlux",
                "open-end outflow closure (both phases)"),
    "SHELL_FLOW_DEVELOPED_BC": ("kernel",
                "goma_tpu_torch.physics.lubrication.ShellFlowDeveloped",
                "tests/test_lub_film_junction.py (exact penalty row)"),
    "SHELL_LUB_WALL_BC": ("kernel",
                          "goma_tpu_torch.physics.lubrication.ShellLubWall",
                          "power-law wall factor + LS gate value-exact; "
                          "tests/test_bc_catalog4.py"),
    "LUB_KINEMATIC_BC": ("machinery",
                         "goma_tpu_torch.physics.lubrication.LubEndKinematic",
                         "var=mesh_displacement (ALE boundary fed by the "
                         "film end flux)"),
    "LUB_CURV_NOBC_BC": ("machinery", "", "natural"),
    "SHELL_TFMP_PRES_BC": ("machinery", _DIR, "tfmp_p Dirichlet"),
    "SHELL_TFMP_SAT_BC": ("machinery", _DIR, "tfmp_s Dirichlet"),
    "SHELL_TFMP_FREE_LIQ_BC": ("kernel",
                "goma_tpu_torch.physics.lubrication.TFMPFreeFlux",
                "tests/test_lub_film_junction.py (exact end flux)"),
    "SHELL_TFMP_FREE_GAS_BC": ("kernel",
                "goma_tpu_torch.physics.lubrication.TFMPFreeFlux",
                "phase='gas'; tests/test_lub_film_junction.py"),
    "SHELL_TFMP_GRAD_S_BC": ("machinery",
                             "goma_tpu_torch.bc.shell_end.EndpointFlux", ""),
    "SHELL_TFMP_AVG_PLATE_VELO_BC": (
        "kernel", "goma_tpu_torch.physics.lubrication.TFMPAvgPlateVelo",
        "h S n.v_avg carry-out row-sum exact; tests/test_bc_catalog4.py"),
    "SHELL_TFMP_NUM_DIFF_BC": ("n/a", "", "numerical-diffusion knob of the "
                               "reference's TFMP discretization"),
    "SHELL_OPEN_PRESS_BC": ("machinery", _DIR, "open porous-shell pressure"),
    "SHELL_OPEN_PRESS_2_BC": ("machinery", _DIR, ""),
    "SH_P_OPEN_USER_BC": ("machinery", _DIR, "callable"),
    "SHELL_TEMP_BC": ("machinery", _DIR, "shell temperature Dirichlet"),
    "SHELL_FILMP_BC": ("machinery", _DIR, ""),
    "SHELL_FILMH_BC": ("machinery", _DIR, ""),
    "SHELL_PARTC_BC": ("machinery", _DIR, ""),
    "SHELL_SAT_1_BC": ("machinery", _DIR, ""),
    "SHELL_SAT_2_BC": ("machinery", _DIR, ""),
    "SHELL_SAT_3_BC": ("machinery", _DIR, ""),
    "SHELL_DIFF_KINEMATIC_BC": (
        "kernel", "goma_tpu_torch.physics.shell.ShellDiffKinematic",
        "Mullins kinematic closure n.xdot = dJs/ds on mesh rows; row-sum "
        "exact, tests/test_bc_catalog4.py"),
    "SHELL_SURFACE_CHARGE_BC": ("kernel",
                                "goma_tpu_torch.physics.shell_film.ShellSpecies",
                                "surface-charge shell transport"),
    "SHELL_SURFACE_CHARGE_SIC_BC": ("machinery",
                                    "goma_tpu_torch.physics.shell_film."
                                    "ShellSpecies", ""),
    "SURFACE_ELECTRIC_FIELD_BC": ("kernel",
                "goma_tpu_torch.physics.shell.ShellGradBC",
                "bulk_normal_current closure; tests/test_shell_rheo.py (exact parabolic charge)"),
    "SURFACE_LUBRICATION_BC": ("machinery",
                "goma_tpu_torch.physics.shell.ShellGradBC",
                "bulk momentum flux into the lubp rows"),
    "SURFACE_USER_SHELL_BC": ("machinery",
                "goma_tpu_torch.physics.shell.ShellGradBC",
                "user flux callable (the reference's user_shell hook)"),
    "SH_FLUID_STRESS_BC": (
        "kernel", "goma_tpu_torch.physics.shell.tie_fluid_shell",
        "put_fluid_stress_on_shell as weighted row injection (n.R_mom -> "
        "sh_K, t.R_mom -> sh_tens); per-node exact, "
        "tests/test_bc_catalog4.py"),
    "SHEAR_TO_SHELL_BC": ("kernel",
                "goma_tpu_torch.bc.sheet.bulk_shear_to_tension",
                "ShellGradBC closure; tests/test_lub_film_junction.py (exact Couette shear load)"),
    "SH_LUBP_SOLID_BC": ("kernel",
                "goma_tpu_torch.bc.sheet.LubPressureLoad",
                "tests/test_lub_film_junction.py"),
    "SH_LUBP_SOLID_RS_BC": ("machinery",
                "goma_tpu_torch.bc.sheet.LubPressureLoad",
                "var=solid_displacement"),
    "SH_SLOPE_X_BC": ("n/a", "",
                      "dead test code in the reference: flags node->"
                      "DBSH_SLOPE_X and dumps a CONSTANT 1.0*BIG_PENALTY "
                      "into the mesh residual with no Jacobian "
                      "(mm_fill.c:4854 'PRS test code 4/21/2004') - not a "
                      "functioning BC; slope pinning is expressible via "
                      "ShMesh2Weak/SlopeBC"),
    "SH_SLOPE_Y_BC": ("n/a", "",
                      "dead test code like SH_SLOPE_X (constant 0.0*"
                      "BIG_PENALTY into R_MESH2, no Jacobian)"),
    "SH_GAMMA1_DERIV_SYMM_BC": ("kernel",
                                "goma_tpu_torch.physics.shell.Gamma1DerivBC",
                                "tests/test_shell_rheo.py"),
    "SH_GAMMA2_DERIV_SYMM_BC": (
        "machinery", "goma_tpu_torch.physics.shell.Gamma1DerivBC",
        "Gamma1DerivBC(var='surf_curv') on the gamma2 projection equation "
        "ShellSurfCurv (div_s n, projection-exact test "
        "tests/test_bc_catalog4.py)"),
    "SH_SDET_BC": ("kernel",
                "goma_tpu_torch.bc.sheet.SdetWeak",
                "tests/test_lub_film_junction.py (exact sdet energy)"),
    "SH_MESH2_WEAK_BC": ("kernel",
                "goma_tpu_torch.bc.sheet.ShMesh2Weak",
                "tests/test_lub_film_junction.py"),
    "SH_S11_WEAK_BC": ("kernel",
                "goma_tpu_torch.bc.sheet.ShellTangentTraction",
                "tests/test_lub_film_junction.py (exact row sums)"),
    "SH_S22_WEAK_BC": ("machinery",
                "goma_tpu_torch.bc.sheet.ShellTangentTraction",
                "which=1 (second tangent, 3D shells)"),
    "SH_USER_BC": ("machinery", _DIR, "callable shell Dirichlet"),
    "SH_X_BC": ("machinery", "goma_tpu_torch.physics.shell.ShellCoordinates",
                "shell coords ARE the mesh coords (reference's const-node-"
                "space realization on R_MESH rows): endpoint pin = "
                "add_dirichlet(mesh comp 0); equation rows exact in "
                "tests/test_bc_catalog4.py"),
    "SH_Y_BC": ("machinery", "goma_tpu_torch.physics.shell.ShellCoordinates",
                "add_dirichlet(mesh comp 1) on the curvature-closure row"),
    "SH_K_BC": ("machinery", _DIR, "sh_K Dirichlet"),
    "SH_TENS_BC": ("machinery", _DIR, "sh_tens Dirichlet"),
    "TENSION_SHEET_BC": ("kernel", "goma_tpu_torch.bc.sheet.TensionSheet",
                         "tests/test_sheet.py"),
    "SHEET_ENDSLOPE_BC": ("kernel", "goma_tpu_torch.bc.sheet.add_sheet_end_slope",
                          "tests/test_sheet.py"),
    "LUBP_SH_FP_FLUX_BC": ("kernel",
                           "goma_tpu_torch.physics.lubrication.tie_lub_film",
                           "row-inject flux continuity "
                           "(Problem.add_row_inject); "
                           "tests/test_lub_film_junction.py"),
    "LUBP_SH_FP_MATCH_BC": ("kernel",
                            "goma_tpu_torch.physics.lubrication.tie_lub_film",
                            "multi-var point constraint lubp = filmp; "
                            "tests/test_lub_film_junction.py"),
    # -- misc strong collocations -------------------------------------------
    "TNRMLSIDE_BC": ("machinery", "goma_tpu_torch.bc.Traction",
                     "normal traction component"),
    "TSHRSIDE_BC": ("machinery", "goma_tpu_torch.bc.Traction",
                    "shear traction component"),
    "TNRMLVARY_BC": ("machinery", "goma_tpu_torch.bc.Traction", "callable"),
    "TSHRVARY_BC": ("machinery", "goma_tpu_torch.bc.Traction", "callable"),
    "NSIDE_BC": ("n/a", "", "legacy liquid-crystal input constant: no "
                 "assembly case in the reference snapshot"),
    "NVARY_BC": ("n/a", "", "legacy input constant, no assembly case"),
    "N_BC": ("n/a", "", "legacy input constant, no assembly case"),
    "NREACT_BC": ("n/a", "", "legacy input constant, no assembly case"),
    "SSIDE_BC": ("n/a", "", "legacy input constant, no assembly case"),
    "SVARY_BC": ("n/a", "", "legacy input constant, no assembly case"),
    "SREACT_BC": ("n/a", "", "legacy input constant, no assembly case"),
    "NEW_WAY_HIGH_BC": ("n/a", "", "reference-internal experiment flags"),
    "NEW_WAY_LOW_BC": ("n/a", "", ""),
    "TABLE_BC": ("machinery", "goma_tpu_torch.input.deck.build_gd_value",
                 "tests/test_deck.py"),
    "TABLE_WICV_BC": ("machinery", "goma_tpu_torch.input.deck.build_gd_value",
                      ""),
    "TABLE_WICS_BC": ("machinery", "goma_tpu_torch.input.deck.build_gd_value",
                      ""),
    "PERIODIC_BC": ("kernel", "goma_tpu_torch.fem.dofmap",
                    "node-aliasing periodic dofs"),
    "INTP_BC": ("machinery", _DIR, "light_intp Dirichlet "
                "(goma_tpu_torch.physics.LightIntensity)"),
    "INTM_BC": ("machinery", _DIR, "backward wave (direction=-s)"),
    "INTD_BC": ("machinery", _DIR, "diffuse field"),
    "RESTIME_BC": ("kernel", "goma_tpu_torch.physics.ResidenceTime",
                   "tests/test_bc_catalog3.py"),
    "RESTIME_GRADSIC_BC": ("machinery", "goma_tpu_torch.physics.ResidenceTime",
                           "gradient strong variant via SUPG weight"),
    "RESTIME_NOBC_BC": ("machinery", "", "natural boundary"),
    "EXT_V_BC": ("machinery", "Problem.add_dirichlet",
                 "Dirichlet on ext_velocity (ExtensionVelocity equation, "
                 "tests/test_ext_velocity.py)"),
    "F1_BC": ("machinery", _DIR, "FillEquation(var='phase1') Dirichlet; "
              "tests/test_bc_catalog3.py"),
    "F2_BC": ("machinery", _DIR, "FillEquation(var='phase2')"),
    "F3_BC": ("machinery", _DIR, ""),
    "F4_BC": ("machinery", _DIR, ""),
    "F5_BC": ("machinery", _DIR, ""),
}

# GD / generalized-Dirichlet factor cards
for _n in ("GD_CONST_BC", "GD_LINEAR_BC", "GD_PARAB_BC", "GD_POLYN_BC",
           "GD_TIME_BC", "GD_TABLE_BC", "GD_CIRC_BC", "GD_INVERSE_BC",
           "GD_PARAB_OFFSET_BC"):
    OVERRIDES[_n] = ("kernel", "goma_tpu_torch.input.deck.build_gd_value",
                     "tests/test_deck.py, tests/test_bc_catalog3.py")


_S33_RE = re.compile(r"S33(_\d)?_BC$")


def _classify(name: str) -> tuple[str, str, str]:
    if name in OVERRIDES:
        return OVERRIDES[name]
    card, method, eq = REF_BC_DESC[name]
    if _S33_RE.match(name):
        # S33 mode Dirichlets predate the BC_Desc metadata (LEGACY rows)
        return ("machinery", _DIR, "stress{mode} component Dirichlet; "
                "tests/test_bc_catalog3.py")
    # VE stress / velocity-gradient Dirichlet families
    if _STRESS_RE.match(eq):
        return ("machinery", _DIR,
                "stress{mode} component Dirichlet; "
                "tests/test_bc_catalog3.py::test_ve_stress_gradient_"
                "dirichlet_family")
    if _GRAD_RE.match(eq):
        return ("machinery", _DIR, "velocity_gradient component Dirichlet; "
                "tests/test_bc_catalog3.py")
    if name.startswith("U_VES"):
        return ("machinery", _DIR,
                "coords-callable stress Dirichlet (parabolic inflow); "
                "tests/test_bc_catalog3.py")
    if method == "DIRICHLET":
        var = _EQ_VAR.get(eq)
        if var is not None:
            note = f"{var} Dirichlet"
            if "USER" in name or "VARY" in name or "PARABOLA" in name \
                    or "TABLE" in name:
                note += " (callable value)"
            return ("machinery", _DIR, note)
        return ("todo", "", f"target equation {eq} absent")
    if method in ("COLLOCATE_SURF", "STRONG_INT_SURF", "LEGACY") and any(
            t in name for t in ("USER", "VARY", "PARABOLA")):
        var = _EQ_VAR.get(eq)
        if var is not None or method == "LEGACY":
            return ("machinery", _DIR,
                    f"coords/params-callable strong value on "
                    f"{var or 'the target field'}")
    return ("todo", "", "")


#: "M machinery" rows whose claims have been exercised end-to-end by the
#: sampled audit (tests/test_bc_machinery_audit.py). Per-round samples:
#: ``random.Random(round).sample(sorted(M_rows), 20)``; round 5 below.
AUDITED: dict[str, str] = {name: "tests/test_bc_machinery_audit.py" for name in (
    "Y_BC", "T_MELT_BC", "DZ_USER_NODE_BC", "PLANEX_BC", "N3_BC",
    "SH_USER_BC", "S12_3_BC", "S33_4_BC", "U_VES13_2_PARABOLA_BC",
    "U_VES13_3_PARABOLA_BC", "U_VES23_5_PARABOLA_BC",
    "U_VES33_7_PARABOLA_BC", "SPLINEZ_BC", "SPLINEZ_RS_BC",
    "VELO_TANGENT_3D_BC", "CAP_REPULSE_ROLL_BC", "CURRENT_BV2_BC",
    "EM_HI_FARFIELD_DIRECT_BC", "GRAD_LUBP_NOBC_BC",
    "HOFFMAN_DIRICHLET_BC")}


def audited_rows() -> list[str]:
    """The round-5 audit sample (reproducible draw over the M rows)."""
    import random

    par = {name: _classify(name) for name in sorted(REF_BC_DESC)}
    m_rows = sorted(n for n, (s, _, _) in par.items() if s == "machinery")
    return sorted(random.Random(5).sample(m_rows, 20))


def bc_parity() -> dict[str, tuple[str, str, str]]:
    """Classification for every reference BC constant:
    {NAME: (status, construct, note)} — audited machinery rows carry the
    audit-test citation in the note."""
    out = {}
    for name in sorted(REF_BC_DESC):
        status, construct, note = _classify(name)
        if name in AUDITED:
            tag = f"AUDITED {AUDITED[name]}"
            note = f"{note}; {tag}" if note else tag
        out[name] = (status, construct, note)
    return out


def summary() -> dict[str, int]:
    from collections import Counter

    c = Counter(v[0] for v in bc_parity().values())
    c["total"] = sum(c.values())
    return dict(c)
