"""Chemkin-II mechanism file parser feeding :class:`ReactionNetwork`
(counterpart of ``goma_tpu/physics/chemkin.py``; numpy and ``re`` only, the
port keeps its own copy).

Parity: the reference links the actual Chemkin third-party library
(``src/mm_chemkin.c`` ``chemkin_mat_prop_init``, ``ck_decide_vol_chem``)
to evaluate gas-phase mechanisms; this module reads the Chemkin-II input
format directly — ELEMENTS / SPECIES / THERMO / REACTIONS blocks — and
builds the mass-action closure (`physics/kinetics.py`).

Supported:
- ``ELEMENTS``/``SPECIES``/``REACTIONS`` ... ``END`` blocks, ``!`` comments
- stoichiometric prefixes (``2H2O``), irreversible ``=>`` and reversible
  ``=`` / ``<=>`` arrows
- REACTIONS-line Ea units: CAL/MOLE (Chemkin default), KCAL/MOLE,
  JOULES/MOLE, KJOULES/MOLE, KELVINS
- third-body reactions (``+M`` on both sides) with per-species enhanced
  efficiency auxiliary lines (``H2O/6.0/ CO/1.5/``)
- unimolecular falloff ``(+M)`` / ``(+collider)`` with ``LOW``, ``TROE``
  and ``SRI`` auxiliary cards (Lindemann when only LOW is given)
- ``REV / A b Ea /`` explicit reverse rates, ``DUPLICATE``/``DUP``,
  ``PLOG / P A b Ea /`` pressure-interpolated rates (needs ``pressure=``)
- ``THERMO`` block NASA 7-coefficient polynomials (fixed-column format),
  giving thermodynamic equilibrium constants for reversible reactions
  (Kc = exp(dS/R - dH/RT) (P_atm/RT)^dnu in the chosen unit system)

Reversible-K resolution order per reaction: explicit ``K_eq[j]`` argument
> ``REV`` card > THERMO data > error. ``FORD``/``RORD`` order overrides
are rejected with a named error.
"""

from __future__ import annotations

import re

import numpy as np

from goma_tpu_torch.physics.kinetics import Nasa7, ReactionNetwork

_EA_UNIT = {
    "CAL/MOLE": 4.184,
    "KCAL/MOLE": 4184.0,
    "JOULES/MOLE": 1.0,
    "KJOULES/MOLE": 1000.0,
    "KELVINS": 8.31446261815324,
}

_UNSUPPORTED = ("FORD", "RORD")
_AUX_HEADS = ("LOW", "TROE", "SRI", "REV", "PLOG", "DUPLICATE", "DUP")


def _strip(line: str) -> str:
    return line.split("!", 1)[0].rstrip()


def _parse_side(side: str, species_index: dict[str, int], rxn: str):
    """'2H2O + O2 (+M)' -> ({species_id: coef}, tb_kind, collider).

    ``tb_kind``: None | "three_body" (bare +M) | "falloff" ((+M)/(+X));
    ``collider``: species id for a specific-collider falloff, else None.
    """
    tb_kind, collider = None, None
    m = re.search(r"\(\+\s*([A-Za-z0-9_*'()-]*?)\s*\)\s*$", side)
    if m:
        tb_kind = "falloff"
        name = m.group(1)
        if name.upper() != "M":
            if name not in species_index:
                raise ValueError(f"chemkin: falloff collider {name!r} in "
                                 f"{rxn!r} not declared in SPECIES block")
            collider = species_index[name]
        side = side[:m.start()]
    out: dict[int, float] = {}
    for term in re.split(r"(?<![<=>])\+", side):
        term = term.strip()
        if not term:
            continue
        if term.upper() == "M":
            if tb_kind == "falloff":
                raise ValueError(
                    f"chemkin: both +M and (+M) in one side: {rxn!r}")
            tb_kind = "three_body"
            continue
        m = re.match(r"^(\d+(?:\.\d+)?)?\s*(.+)$", term)
        coef = float(m.group(1)) if m.group(1) else 1.0
        name = m.group(2).strip()
        if name not in species_index:
            raise ValueError(f"chemkin: species {name!r} in reaction "
                             f"{rxn!r} not declared in SPECIES block")
        sid = species_index[name]
        out[sid] = out.get(sid, 0.0) + coef
    return out, tb_kind, collider


def _slash_fields(ln: str):
    """'TROE / a b c /' -> [a, b, c] (floats)."""
    body = ln.split("/", 1)[1].rsplit("/", 1)[0]
    return [float(t) for t in body.split()]


def _parse_thermo(lines: list[str], species_index: dict[str, int],
                  thermo: list):
    """Fixed-column NASA-7 THERMO records (4 lines per species)."""
    i = 0
    # optional global T-range line (three bare floats) right after THERMO
    if i < len(lines):
        toks = lines[i].split()
        if len(toks) == 3:
            try:
                [float(t) for t in toks]
                i += 1
            except ValueError:
                pass
    while i + 3 < len(lines):
        l1, l2, l3, l4 = lines[i:i + 4]
        i += 4
        name = l1[:18].split()[0]
        try:
            T_low = float(l1[45:55])
            T_high = float(l1[55:65])
            T_mid_s = l1[65:73].strip()
            T_mid = float(T_mid_s) if T_mid_s else 1000.0
        except ValueError as e:
            raise ValueError(f"chemkin: bad THERMO header line {l1!r}") from e

        def coefs(line, n):
            return [float(line[15 * k:15 * (k + 1)]) for k in range(n)]

        c = coefs(l2, 5) + coefs(l3, 5) + coefs(l4, 4)
        a_high = c[0:7]
        a_low = c[7:14]
        if name in species_index:
            thermo[species_index[name]] = Nasa7(a_low, a_high, T_mid=T_mid,
                                                T_low=T_low, T_high=T_high)


def parse_chemkin(text: str, K_eq: dict[int, float] | None = None,
                  dH: dict[int, float] | None = None, T_ref=None,
                  pressure=None, units="cgs"):
    """Parse a Chemkin-II mechanism string.

    Returns ``(network, species)`` — a :class:`ReactionNetwork` (Ea in
    J/mol; rate-constant and concentration units are whatever the
    mechanism's A-factors use, conventionally cgs) and the SPECIES-block
    name list defining the species ordering. ``K_eq[j]`` overrides the
    equilibrium constant of the j-th reaction; reversible reactions
    without one fall back to a REV card, then to THERMO data.
    ``pressure`` (same units as the Kc system, defaults cgs dyn/cm^2)
    is required when the mechanism uses PLOG.
    """
    lines = [_strip(l) for l in text.splitlines()]
    species: list[str] = []
    rxn_lines: list[str] = []
    thermo_lines: list[str] = []
    ea_scale = _EA_UNIT["CAL/MOLE"]
    block = None
    for ln in lines:
        if not ln.strip():
            continue
        up = ln.upper().strip()
        head = up.split()[0]
        if head in ("ELEMENTS", "ELEM"):
            block = "elements"
            continue
        if head in ("SPECIES", "SPEC"):
            block = "species"
            species.extend(ln.split()[1:])
            continue
        if head in ("REACTIONS", "REAC"):
            block = "reactions"
            for tok in up.split()[1:]:
                if tok in _EA_UNIT:
                    ea_scale = _EA_UNIT[tok]
            continue
        if head == "THERMO":
            block = "thermo"
            continue
        if up == "END":
            block = None
            continue
        if block == "species":
            species.extend(ln.split())
        elif block == "reactions":
            rxn_lines.append(ln)
        elif block == "thermo":
            thermo_lines.append(ln)

    sidx = {s: i for i, s in enumerate(species)}
    ns = len(species)
    thermo: list = [None] * ns
    have_thermo = bool(thermo_lines)
    if have_thermo:
        _parse_thermo(thermo_lines, sidx, thermo)

    nu, A, beta, Ea, rev = [], [], [], [], []
    third_body, falloff, rev_arr, plog = [], [], [], []

    def _is_reaction(ln):
        if not re.search(r"<=>|=>|=", ln):
            return False
        parts = ln.split()
        if len(parts) < 4:
            return False
        try:
            [float(p) for p in parts[-3:]]
            return True
        except ValueError:
            return False

    for ln in rxn_lines:
        up = ln.upper().strip()
        head = re.split(r"[\s/]", up)[0]
        if _is_reaction(ln):
            for kw in _UNSUPPORTED:
                if re.search(rf"\b{kw}\b", up):
                    raise ValueError(f"chemkin: {kw} not supported: {ln!r}")
            parts = ln.split()
            a, b, ea = (float(parts[-3]), float(parts[-2]), float(parts[-1]))
            rxn = " ".join(parts[:-3])
            m = re.split(r"<=>|=>|=", rxn)
            if len(m) != 2:
                raise ValueError(f"chemkin: cannot parse reaction {rxn!r}")
            irreversible = "=>" in rxn and "<=>" not in rxn
            lhs, tb_l, col_l = _parse_side(m[0], sidx, rxn)
            rhs, tb_r, col_r = _parse_side(m[1], sidx, rxn)
            if tb_l != tb_r or col_l != col_r:
                raise ValueError(
                    f"chemkin: third-body mismatch across sides: {rxn!r}")
            row = np.zeros(ns)
            for sid, c in lhs.items():
                row[sid] -= c
            for sid, c in rhs.items():
                row[sid] += c
            nu.append(row)
            A.append(a)
            beta.append(b)
            Ea.append(ea * ea_scale)
            rev.append(not irreversible)
            tb = None
            if tb_l is not None:
                tb = {"collider": col_l} if col_l is not None else {}
            third_body.append(tb)
            falloff.append({} if tb_l == "falloff" else None)
            rev_arr.append(None)
            plog.append(None)
            continue
        # ---- auxiliary line for the previous reaction
        if not nu:
            raise ValueError(f"chemkin: auxiliary line before any "
                             f"reaction: {ln!r}")
        j = len(nu) - 1
        if head in _UNSUPPORTED:
            raise ValueError(f"chemkin: {head} not supported: {ln!r}")
        if head in ("DUPLICATE", "DUP"):
            continue  # parallel rows add naturally
        if head == "LOW":
            if falloff[j] is None:
                raise ValueError(f"chemkin: LOW without (+M): {ln!r}")
            falloff[j]["low"] = tuple(
                v * (ea_scale if k == 2 else 1.0)
                for k, v in enumerate(_slash_fields(ln)))
            continue
        if head == "TROE":
            if falloff[j] is None:
                raise ValueError(f"chemkin: TROE without (+M): {ln!r}")
            falloff[j]["troe"] = tuple(_slash_fields(ln))
            continue
        if head == "SRI":
            if falloff[j] is None:
                raise ValueError(f"chemkin: SRI without (+M): {ln!r}")
            falloff[j]["sri"] = tuple(_slash_fields(ln))
            continue
        if head == "REV":
            f = _slash_fields(ln)
            rev_arr[j] = (f[0], f[1], f[2] * ea_scale)
            continue
        if head == "PLOG":
            f = _slash_fields(ln)
            plog[j] = (plog[j] or []) + [(f[0], f[1], f[2],
                                          f[3] * ea_scale)]
            continue
        # per-species third-body efficiencies: NAME/val/ NAME/val/ ...
        pairs = re.findall(r"([A-Za-z0-9_*'()-]+)\s*/\s*([0-9.eE+-]+)\s*/",
                           ln)
        if pairs and third_body[j] is not None:
            for name, val in pairs:
                if name not in sidx:
                    raise ValueError(f"chemkin: efficiency species {name!r} "
                                     "not declared in SPECIES block")
                third_body[j][sidx[name]] = float(val)
            continue
        raise ValueError(f"chemkin: cannot parse line {ln!r}")

    nr = len(nu)
    for j in range(nr):
        if falloff[j] is not None and "low" not in falloff[j]:
            raise ValueError(f"chemkin: reaction {j} is falloff (+M) but "
                             "has no LOW card")

    K: list = [None] * nr
    for j, r in enumerate(rev):
        if not r:
            continue
        if K_eq is not None and j in K_eq:
            K[j] = K_eq[j]
        elif rev_arr[j] is not None:
            pass  # explicit reverse Arrhenius handles it
        elif have_thermo and all(
                thermo[s] is not None for s in np.nonzero(nu[j])[0]):
            K[j] = "thermo"
        else:
            raise ValueError(
                f"chemkin: reaction {j} is reversible; supply K_eq[{j}], "
                "a REV card, or THERMO data for its species")
    dh = np.zeros(nr)
    if dH:
        for j, v in dH.items():
            dh[j] = v
    net = ReactionNetwork(
        nu=np.asarray(nu), A=A, beta=beta, Ea=Ea, K_eq=K, dH=dh, T_ref=T_ref,
        third_body=third_body, falloff=falloff, rev_arrhenius=rev_arr,
        plog=plog, thermo=thermo if have_thermo else None,
        pressure=pressure, units=units)
    return net, species


def read_chemkin(path: str, **kw):
    """File variant of :func:`parse_chemkin`."""
    with open(path) as f:
        return parse_chemkin(f.read(), **kw)
