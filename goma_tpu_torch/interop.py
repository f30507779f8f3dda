"""Carry state across from goma_tpu: its parameter dicts, state vectors,
NDLU factors and material dicts, fetched to numpy, become the port's
tensors and objects, so both packages can compute on the same state (the
port's counterpart of loading weights). ``device=None`` is the card, as
everywhere in the port; the CPU tests pass ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from goma_tpu_torch import config

_KEYS = ("ct", "hist", "dirichlet_val", "time")


def params_from_numpy(params: dict, device=None, dtype=torch.float64) -> dict:
    """A goma_tpu ``Problem.base_params()`` dict (values as numpy arrays or
    scalars) -> the port's params on ``device``: the time-scheme keys and
    every external field ``ext_<name>``. goma_tpu's device tables
    (``_tables``) are dropped: the port's Problem builds its own."""
    dev = config.resolve_device(device)
    keys = _KEYS + tuple(k for k in params if k.startswith("ext_"))
    return {k: torch.as_tensor(np.asarray(params[k]), dtype=dtype, device=dev)
            for k in keys}


def state_from_numpy(x, device=None, dtype=torch.float64) -> torch.Tensor:
    """A state vector (numpy or array-like) -> a tensor on ``device``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=config.resolve_device(device))


def ndlu_factors_from_numpy(facs, device=None) -> list:
    """goma_tpu ``NDLU.factor`` output, fetched to numpy (per level
    ``(fwd, bwd, perm, X, Y)``) -> the port's per-level
    ``(fwd, bwd, perm, X, Y)`` tensors for ``NDLU.solve`` /
    ``solve_refined``: a kernel level's perm stays None, a pivoted level's
    becomes an int64 tensor, and empty boundary blocks become None, as the
    port's ``factor_level`` returns them."""
    dev = config.resolve_device(device)

    def put(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    out = []
    for fwd, bwd, perm, X, Y in facs:
        empty = np.asarray(X).size == 0
        out.append((put(fwd), put(bwd),
                    None if perm is None else put(perm, torch.int64),
                    None if empty else put(X), None if empty else put(Y)))
    return out


def _rebuild(v, module):
    """The port's counterpart of a goma_tpu model object ``v``: the class of
    the same name in ``module``, built from ``v``'s attributes named as the
    constructor names its arguments (arrays fetched to numpy, 0-d ones to
    floats), or None when ``module`` has no such class."""
    import inspect

    cls = getattr(module, type(v).__name__, None)
    if not (inspect.isclass(cls) and cls.__module__ == module.__name__):
        return None
    args = {}
    for name in inspect.signature(cls.__init__).parameters:
        if name == "self":
            continue
        a = getattr(v, name)
        if not isinstance(a, (bool, int, float, str)):
            a = np.asarray(a, dtype=np.float64)
            a = float(a) if a.ndim == 0 else a
        args[name] = a
    return cls(**args)


def materials_from_goma(mat: dict) -> dict:
    """A goma_tpu material dict -> the port's. Python scalars pass through;
    tuples, lists and arrays of numbers (``gravity_vec``, a constant
    ``solid_body_force``, ``sink_linear``) pass as float64 numpy arrays; a
    goma_tpu property model (``BoussinesqBodyForce`` and the models of
    ``physics/materials.py``: ``PowerLawViscosity``, ``CarreauViscosity``,
    ``BinghamViscosity``, ``CarreauWLFViscosity``, ``ArrheniusViscosity``,
    ``SuspensionViscosity``, ``FillerDensity``, ``BondViscosity``) is
    recognised by its class name and rebuilt from its attributes, without
    importing goma_tpu. So are ``SATurbulentViscosity`` (of
    ``physics/turbulence.py``) and a bound ``species_source`` or
    ``heat_source`` of a ``ReactionNetwork`` (the network rebuilt by
    ``reaction_network_from_goma``, the port's method of the same name
    taken), and a ``LevelSetProperty`` (of ``physics/level_set.py``, its
    two phases' values translated the same way). Any other callable
    raises."""
    from goma_tpu_torch.physics import level_set, materials, turbulence

    def convert(k, v):
        if isinstance(v, (bool, int, float)):
            return v
        if not callable(v):
            a = np.asarray(v)
            if a.dtype.kind in "biuf":
                return a.astype(np.float64)
        owner = getattr(v, "__self__", None)
        if type(owner).__name__ == "ReactionNetwork" and v.__name__ in (
                "species_source", "heat_source"):
            return getattr(reaction_network_from_goma(owner), v.__name__)
        if type(v).__name__ == "LevelSetProperty":
            return level_set.LevelSetProperty(
                convert(k, v.minus), convert(k, v.plus),
                eps=v.eps if v.eps is None or isinstance(v.eps, str)
                else float(v.eps))
        model = (_rebuild(v, materials) or _rebuild(v, turbulence)
                 if callable(v) else None)
        if model is None:
            raise NotImplementedError(
                f"material property {k!r} of type {type(v).__name__}: later "
                "slice of the port, see ROADMAP")
        return model

    return {k: convert(k, v) for k, v in mat.items()}


def porous_model_from_goma(model):
    """A goma_tpu porous saturation model (``VanGenuchten`` or
    ``TanhHystSaturation`` of ``physics/porous.py``) -> the port's, rebuilt
    from its attributes as ``materials_from_goma`` rebuilds the property
    models, without importing goma_tpu. ``None`` (saturated flow) passes
    through. The hysteresis state travels as external fields
    (``params_from_numpy`` carries ``ext_hyst_curve``,
    ``ext_hyst_sat_switch`` and ``ext_hyst_pc_switch``)."""
    from goma_tpu_torch.physics import porous

    if model is None:
        return None
    out = _rebuild(model, porous)
    if out is None:
        raise NotImplementedError(
            f"porous model of type {type(model).__name__}: not a model of "
            "goma_tpu's physics/porous.py")
    return out


def reaction_network_from_goma(net):
    """A goma_tpu ``ReactionNetwork`` -> the port's, rebuilt from its
    attributes (the per-reaction feature lists copied, NASA-7 thermo data
    rebuilt species by species), without importing goma_tpu."""
    from goma_tpu_torch.physics import kinetics

    def copy(lst):
        return [None if e is None else (dict(e) if isinstance(e, dict)
                                        else list(e) if isinstance(e, list)
                                        else tuple(e)) for e in lst]

    thermo = None
    if net.thermo is not None:
        thermo = [None if th is None else kinetics.Nasa7(
            np.asarray(th.a_low), np.asarray(th.a_high), T_mid=th.T_mid,
            T_low=th.T_low, T_high=th.T_high) for th in net.thermo]
    f64 = lambda a: np.asarray(a, dtype=np.float64)  # noqa: E731
    return kinetics.ReactionNetwork(
        nu=f64(net.nu), A=f64(net.A), Ea=f64(net.Ea), beta=f64(net.beta),
        orders=f64(net.orders), K_eq=list(net.K_eq), dH=f64(net.dH),
        T_ref=net.T_ref, third_body=copy(net.third_body),
        falloff=copy(net.falloff), rev_arrhenius=copy(net.rev_arrhenius),
        plog=copy(net.plog), thermo=thermo, pressure=net.pressure,
        units=net.units)


def surface_mechanism_from_goma(mech):
    """A goma_tpu ``SurfaceMechanism`` -> the port's, rebuilt from its
    attributes (the site densities per site phase read back from its
    per-species table), without importing goma_tpu."""
    from goma_tpu_torch.physics.placid import SurfaceMechanism

    sden0 = [float(mech.sden_k[int(s)])
             for s, kind in zip(mech.starts, mech.kinds) if kind == "site"]
    f64 = lambda a: np.asarray(a, dtype=np.float64)  # noqa: E731
    return SurfaceMechanism(
        nu=f64(mech.nu), A=f64(mech.A), Ea=f64(mech.Ea), beta=f64(mech.beta),
        orders=f64(mech.orders), n_gas=int(mech.n_gas),
        phases=[(str(k), int(c)) for k, c in mech.phases], sden0=sden0,
        kcov=f64(mech.kcov), units=mech.units)
