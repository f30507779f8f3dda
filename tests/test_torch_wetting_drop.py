"""The wetting drop of ``scripts/ls_decks.py`` (``chip_smoke.py`` phase
61: the XFEM pressure, the solved normal with the div n CSF force, the
solved curvature, the wall angle and level-set slip) at 12x6 in the
PyTorch port against goma_tpu, on the CPU in float64 (the port in one
torch thread).

Tolerances: as tests/test_torch_melt_pool.py's ``check_rungs``.
"""

import pytest

from test_torch_host import one_nd_bisection  # noqa: F401  (autouse)
from test_torch_host import one_torch_thread  # noqa: F401  (autouse)
from test_torch_melt_pool import check_rungs


@pytest.mark.parametrize("kind", ["gmres+ndlu", "tpu_direct"])
def test_wetting_drop_device_rungs(kind):
    """The 12x6 wetting drop of phase 61: see
    ``test_torch_melt_pool.check_rungs``."""
    check_rungs("drop", kind)
