#!/usr/bin/env python3
"""CPU rehearsal of ``chip_smoke.py``: runs its control flow end to end on a
machine without CUDA, at small sizes, to find wrong paths, arguments and
shapes before a run on the card.

    python3 scripts/chip_smoke_rehearsal.py [--only-viscoelastic]
                                            [--only-two-phase]
                                            [--only-slot-coater]
                                            [--only-two-level]
                                            [--only-axisym]
                                            [--only-bc]
                                            [--only-continuation]
                                            [--only-overset]
                                            [--only-shell]

What it fakes: ``torch.cuda`` reports a device, its events time the host
clock and ``synchronize`` does nothing; the script's CUDA tensors are made
on the CPU; each kernel wrapper runs its plain version and counts that as a
launch; the kernels' launch plans are the wrappers' own; ``device_ms`` and
``graph_ms`` return 0 ms; nvcc is not run; the sync debug mode is a no-op (0
syncs).
The decks are cut to 8x8 (cavity, buoyant, static bubble, tilted cavity,
lid-speed continuation, the shell bearing and film), 16x16 (Bratu), 20x10
with 28 segments (the immersed cylinder),
8x4 (viscoelastic), 16x4 (slot coater) and 16x8 (axisymmetric die,
periodic channel), the checks that need the full size
(Ghia, the buoyant Newton count, the paths' agreement, the Laplace jump,
x against goma_tpu's record) are widened, and the linear iteration counts, the slot coater's accepted steps
and free-surface heights and the die's, the tilted cavity's, the periodic
channel's, the continuation decks' and the immersed cylinder's records the
script requires are those of the cut decks (goma_tpu's at 16x4, 16x8, 8x8,
16x16, 20x10 and the shells' 8x8, CPU). Every time it prints is a CPU
time, not a device number.
"""

import argparse
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


class _Event:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def _fake_cuda():
    torch.cuda.Event = _Event
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.is_available = lambda: True
    torch.cuda.get_device_name = lambda i=0: "CPU rehearsal"
    torch.cuda.device_count = lambda: 1
    torch.cuda.empty_cache = lambda: None
    torch.cuda.set_sync_debug_mode = lambda mode: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.mem_get_info = lambda *a: (0, 1)
    torch.cuda.memory_allocated = torch.cuda.memory_reserved = \
        torch.cuda.max_memory_allocated = lambda *a: 0
    lu_factor_ex = torch.linalg.lu_factor_ex
    # the CPU has no unpivoted LU; the pivoted one stands in for its time
    torch.linalg.lu_factor_ex = lambda A, pivot=True: lu_factor_ex(A)

    from goma_tpu_torch import cuda_build
    from goma_tpu_torch.solvers import batched_lu, batched_trsv, front_gather

    cuda_build.load = lambda name: None
    for mod, name in ((batched_lu, "batched_lu"), (batched_trsv, "batched_trsv"),
                      (front_gather, "front_gather")):
        setattr(mod, name, _counted(getattr(mod, name)))
    for mod in (batched_lu, batched_trsv):
        mod.kernel_plan = lambda nn, m, dt, _mod=mod: _mod._plan(nn, m, dt) + (1,)


# goma_tpu's record of the cut shell decks of phases 48-49
# (scripts/shell_reference.py --part bearing --n 8 / --part film --n 8, CPU)
SHELL_REF_8 = {'bearing': {'gmres+ndlu': {'T_min': 0.7854186086515456,
                            'T_samples': [1.0, 0.8052715684394627,
                                          0.8533932283382293,
                                          0.9388363072944469,
                                          0.7854561899214899,
                                          0.8149847287098936,
                                          0.868269883503081,
                                          0.9582910282288675,
                                          0.7868350805799451,
                                          0.8262329838780768,
                                          0.884299160244403,
                                          0.9787314371311134,
                                          0.7907674708069309,
                                          0.8389555279200597,
                                          0.9015092612301031, 1.0,
                                          0.7969524839857254,
                                          0.8531072984762559,
                                          0.9198292891076388,
                                          0.785447775548084, 0.805170178229853,
                                          0.8685830820030755,
                                          0.9390426693365169,
                                          0.7854657590626369],
                            'converged': True,
                            'levels': [[4, 134], [2, 16], [1, 48]],
                            'linear': [1, 31, 20, 21, 15],
                            'load': 108.62669697925821,
                            'newton': 5,
                            'p_max': 293.1693535767728},
             'n': 8,
             'n_dof': 578,
             'nnz': 16900,
             'tpu_direct': {'T_min': 0.78541860865617,
                            'T_samples': [1.0, 0.8052715684432574,
                                          0.8533932283394304,
                                          0.9388363072940967,
                                          0.7854561899256143,
                                          0.8149847287123663,
                                          0.8682698835042753,
                                          0.9582910282283705,
                                          0.7868350805837411,
                                          0.8262329838804281,
                                          0.884299160245653,
                                          0.9787314371302843,
                                          0.7907674708104043,
                                          0.8389555279221963,
                                          0.9015092612306614, 1.0,
                                          0.7969524839887681,
                                          0.853107298477543,
                                          0.9198292891076076,
                                          0.7854477755526376,
                                          0.8051701782326365, 0.86858308200319,
                                          0.9390426693359353,
                                          0.7854657590677443],
                            'converged': True,
                            'levels': [[4, 134], [2, 16], [1, 48]],
                            'linear': [1, 1, 1, 1],
                            'load': 108.6266969703192,
                            'newton': 4,
                            'p_max': 293.1693535453397}},
 'film': {'dt': 0.00015398973382026504,
          'gmres+ndlu': {'C_samples': [0.20000469252813557,
                                       0.20000550380068982, 0.2000051296744966,
                                       0.20000478576809935,
                                       0.20000563189810752,
                                       0.20000536757257145, 0.2000050646633184,
                                       0.20000489373825217,
                                       0.20000541244808215,
                                       0.20000520401710167,
                                       0.20000509557986362, 0.2000051296744966,
                                       0.20000512994713968, 0.20000511344981,
                                       0.20000523725263716,
                                       0.20000541830016622, 0.2000049164153213,
                                       0.20000513084270782,
                                       0.20000543671655563,
                                       0.20000475979715876,
                                       0.20000483370483954,
                                       0.20000522499188253, 0.20000557644927,
                                       0.20000469252813585],
                         'H_samples': [1.0887476276010624, 0.9354413027155154,
                                       1.0006192290266638, 1.068714056946712,
                                       0.9149489100812923, 0.9582766529440289,
                                       1.0129633910268767, 1.0464093400214725,
                                       0.9506116090401866, 0.9871744494982952,
                                       1.0072017045973232, 1.000619229026286,
                                       1.0005970042855348, 1.003878860039232,
                                       0.9811601151089335, 0.9496227655338404,
                                       1.0418624960791179, 1.0005246507855745,
                                       0.9465661824997951, 1.0742122097535103,
                                       1.0586966816621304, 0.9832249013815413,
                                       0.9237157483415323,
                                       1.0887476276003825],
                         'amplitude': 0.09052660047462152,
                         'converged': [True, True, True, True, True],
                         'exact': 0.09048374180359596,
                         'levels': [[2, 105], [4, 192], [2, 24], [1, 72]],
                         'newton': [2, 3, 2, 2, 2],
                         't': 0.0007699486691013252},
          'n': 8,
          'n_dof': 867,
          'nnz': 38025,
          'tpu_direct': {'C_samples': [0.20000469252814032,
                                       0.20000550380070128,
                                       0.20000512967450212,
                                       0.20000478576809758, 0.2000056318981238,
                                       0.200005367572577, 0.20000506466332135,
                                       0.20000489373825012, 0.2000054124480867,
                                       0.20000520401710845,
                                       0.20000509557986718,
                                       0.20000512967450212, 0.200005129947146,
                                       0.2000051134498129, 0.20000523725264305,
                                       0.20000541830017307,
                                       0.20000491641532042, 0.2000051308427136,
                                       0.20000543671656446,
                                       0.20000475979715643,
                                       0.20000483370483607, 0.2000052249918871,
                                       0.2000055764492802,
                                       0.20000469252814046],
                         'H_samples': [1.0887476277576835, 0.9354413027609418,
                                       1.0006192290039904, 1.0687140569568514,
                                       0.9149489101024623, 0.9582766529576505,
                                       1.012963390895992, 1.046409339941167,
                                       0.9506116090644903, 0.987174449424756,
                                       1.007201704430329, 1.000619229003989,
                                       1.0005970042449002, 1.0038788598737074,
                                       0.9811601150631376, 0.9496227655711755,
                                       1.0418624959725598, 1.0005246506897068,
                                       0.9465661825327044, 1.0742122098161808,
                                       1.058696681604184, 0.983224901385817,
                                       0.9237157483585494,
                                       1.0887476277576755],
                         'amplitude': 0.09052660054958522,
                         'converged': [True, True, True, True, True],
                         'exact': 0.09048374180359596,
                         'levels': [[2, 105], [4, 192], [2, 24], [1, 72]],
                         'newton': [2, 2, 1, 1, 1],
                         't': 0.0007699486691013252}}}


BUOY_LINEAR_8 = [1, 4, 7, 6, 10, 6]
VE_LINEAR_4 = [1, 4, 11, 13]
# goma_tpu's bench_slot_coater make() at 16x4 (CPU): Newton per accepted
# step, and the gmres_ndlu rung's free-surface heights at t = 0.08
SC_REF_NEWTON_16 = {
    "gmres_ndlu": {"warm": [8, 7, 7, 6, 6, 7, 7, 6], "timed": [6, 5, 5, 6]},
    "tpu_direct": {"warm": [8, 7, 7, 6, 5, 6, 6, 5], "timed": [6, 5, 5, 5]}}
# goma_tpu's two-level records of the cut decks (scripts/twolevel_reference.py
# --n 8, CPU, float32 Jacobian)
TWOLEVEL_REF_8 = {"cavity": {"newton": 4, "linear": [16, 39, 40, 31]},
                  "buoyant": {"newton": 6, "linear": [60, 92, 75, 72, 72, 69]}}
SC_REF_HEIGHTS_16 = [(1.5, 1.0), (1.75, 0.8769404440331855),
                     (2.0, 0.7523322375211594), (2.375, 0.5868910113006314),
                     (2.625, 0.5227634074595855), (2.875, 0.49500209319838806),
                     (3.125, 0.4865396035429377), (3.5, 0.48471373107941396),
                     (3.75, 0.4868615787472427), (4.0, 0.49554009287321155)]

# goma_tpu's record of the 16x8 die (scripts/axisym_reference.py --nz 16
# --nr 8, CPU)
AX_REF_16 = {
    "AX_REF_NEWTON": {"gmres_ndlu": 4, "tpu_direct": 4},
    "AX_REF_LINEAR": {"gmres_ndlu": [1, 61, 3, 3], "tpu_direct": [1, 1, 1, 1]},
    "AX_REF_UZ": {"gmres_ndlu": 10.29112337678157,
                  "tpu_direct": 10.291123377755389},
    "AX_REF_HEAT": {"gmres_ndlu": -3.647123003207391,
                    "tpu_direct": -3.6471230032569126},
    "AX_REF_FLOW": {"gmres_ndlu": 2.556044900422992,
                    "tpu_direct": 2.5560449005584793}}

# goma_tpu's record of the cut decks of phases 33-37 (scripts/rotation_reference.py --deck tilted --n 8 / --deck periodic
# --n 8, CPU)
TILT_REF_8 = {'gmres_ndlu': {'linear': [1, 13, 13, 10],
                'newton': 4,
                'x_samples': [0.0, 0.0, -0.0356306945113829,
                              -0.02967565535345784, 0.0043383123867215545,
                              -0.06869388199629611, -0.001774285467035952,
                              0.031557085198073764, -0.029847689078451367,
                              -0.1655017417324416, -0.19761601455684286,
                              0.11367733534279978, 0.03303855135891354,
                              -0.1583967302722158, -0.18341790015256265, 0.0,
                              -0.44844102729985025, 0.06672048186737811,
                              0.16793829402013216, 0.265248253759637,
                              0.2311874618571892, 0.5391301795407344,
                              0.8660253863889693, 1.6108214799896814]},
 'tpu_direct': {'linear': [1, 1, 1, 1],
                'newton': 4,
                'x_samples': [0.0, 0.0, -0.03563067902318137,
                              -0.029675712957774682, 0.004338629634437721,
                              -0.06869380423672805, -0.0017739514927718266,
                              0.031557103966915884, -0.029847720092574463,
                              -0.16550171900490313, -0.1976160077430197,
                              0.11367739779576133, 0.03303858845769615,
                              -0.15839681887591903, -0.18341780336755967, 0.0,
                              -0.44844110024243944, 0.06672051910010338,
                              0.16793824405432498, 0.2652482029305371,
                              0.2311875050434013, 0.5391300228087493,
                              0.8660254037844396, 1.6108217589062317]}}
PER_REF_8 = {'gmres_ndlu': {'linear': [1],
                'newton': 1,
                'x_samples': [0.0, 0.0, 1.2065288768070559e-09,
                              -2.51875609258434e-09, 0.21875,
                              -7.239171040396286e-09, 0.3749998211860657,
                              0.4296874701976776, 0.4296875298023224,
                              -3.3635462415304573e-08, 1.0979412934375432e-07,
                              4.784635893884115e-05, -4.707570511186532e-08,
                              -1.266855331749639e-08, 8.857653455152104e-08,
                              0.4296874403953552, 0.4296873211860657,
                              0.3749999701976776, 1.327181653465459e-08,
                              0.21874986588954926, 4.638253813027404e-05,
                              -1.364885893195833e-08, 0.0, 0.0]},
 'tpu_direct': {'linear': [1],
                'newton': 1,
                'x_samples': [0.0, 0.0, -6.884720251362627e-09,
                              2.624153464041666e-08, 0.21875039150864686,
                              -1.0241957282560738e-08, 0.37500030925874567,
                              0.4296880381744385, 0.4296882122054495,
                              -8.053204119580986e-08, 6.461533448890797e-08,
                              5.46273576570083e-05, -1.7445778022600823e-08,
                              -1.0762547494112678e-07, 4.9240079111492516e-08,
                              0.42968811014603264, 0.4296880941729659,
                              0.37500044779066366, 4.359565563807554e-08,
                              0.21875030283099006, 5.3626702288770355e-05,
                              -8.299235430623364e-10, 0.0, 0.0]}}

# goma_tpu's record of phases 39-44 at the cut sizes
# (scripts/continuation_reference.py --part cavity --n 8, --part bratu --n 16,
# --part small; CPU)
CONT_REF_8 = {'gmres_ndlu': {'lam': [1.0, 1.5, 2.25, 3.375, 4.0], 'newton':
    [4, 2, 3, 3, 2], 'predictor_linear': [10, 13, 20, 31],
    'u_min_centre_line': -0.3505625737188893, 'x_samples': [[0.0, 0.0,
    -0.040166527298424626, -0.02549967496361205, 0.004338536157263206,
    -0.035358158130293305, -0.0017740729176694003, 0.04152962889384071,
    -0.03010187314430368, -0.0752777049751785, -0.1620547564494359,
    0.15020312192064011, -0.08644483830903482, -0.2261332369525917,
    -0.10160613671177998, 0.0, -0.44028912805515574, 0.05878004311671248,
    0.20816618625394767, 0.2513512743607862, 0.18412719744810602,
    0.6299326445696352, 1.0, 1.6108215073290921], [0.0, 0.0,
    -0.06715123326284811, -0.04374050127717055, 0.0006422864339015177,
    -0.06456650791096763, -0.007427413938330574, 0.07395103402996028,
    -0.04234372049177182, -0.13367116631388853, -0.26647189327610477,
    0.2517890495437314, -0.16095298082109366, -0.3126951549493242,
    -0.10370631067780778, 0.0, -0.7392351792150293, 0.10155085939186392,
    0.3116254509277496, 0.31463420258660335, 0.3197042239116854,
    0.9089285188492795, 1.5, 3.0160364216717426], [0.0, 0.0,
    -0.12169896110361833, -0.07938179997370298, -0.0186815092668553,
    -0.13063218389629583, -0.031998064141589566, 0.1413307807970341,
    -0.06256607600221287, -0.2594323254147639, -0.44992156899621705,
    0.4524382170939134, -0.2888938756245807, -0.3361866779300726,
    -0.06500212723221921, 0.0, -1.1708060086480145, 0.10998948077747173,
    0.48622684174847564, 0.3769802357487606, 0.4987050841064047,
    1.3027281028432753, 2.25, 5.895401814150318], [0.0, 0.0,
    -0.24573167584065914, -0.15068281479841517, -0.08299310834564722,
    -0.28949930607814167, -0.15055229444169527, 0.2811460408147468,
    -0.09980678271381294, -0.4902480618534355, -0.6903503431408922,
    0.8437398588075666, -0.47045236848907734, -0.27055195344246386,
    0.04661626065171731, 0.0, -1.7190052786904744, 0.08483225033876352,
    0.7752025975416927, 0.41929301175991895, 0.7369368547160775,
    1.8908811753706232, 3.375, 11.847363335301907], [0.0, 0.0,
    -0.33933419087014727, -0.19708318743585096, -0.13995412002287821,
    -0.41029768316548143, -0.28806425612037856, 0.37435752451983717,
    -0.11691242566007531, -0.6103547805128073, -0.7967707209341484,
    1.101000783129166, -0.5557208725917917, -0.2459079715840744,
    0.12216767472818901, 0.0, -1.985151362714987, 0.07084310471680055,
    0.9512942242902227, 0.4192649118679128, 0.8732816871461182,
    2.2396017663984367, 4.0, 15.972223980901163]]}, 'tpu_direct': {'lam':
    [1.0, 1.5, 2.25, 3.375, 4.0], 'newton': [4, 2, 3, 3, 2],
    'predictor_linear': [41, 49, 140, 400], 'u_min_centre_line':
    -0.35056273965589974, 'x_samples': [[0.0, 0.0, -0.040166555135235565,
    -0.025499748640275228, 0.004338629633301513, -0.03535815106700817,
    -0.0017739515146718377, 0.04152971822275261, -0.030101897701736935,
    -0.07527773772191437, -0.1620549351167581, 0.15020332439470668,
    -0.08644490279708261, -0.22613344949573852, -0.10160596615506247, 0.0,
    -0.4402894599183919, 0.05878011066471889, 0.20816627788335865,
    0.2513512663335229, 0.1841273629192799, 0.6299327473916286, 1.0,
    1.6108217583935187], [0.0, 0.0, -0.06715134932390796,
    -0.04374069348562942, 0.0006423285979355641, -0.0645666343148047,
    -0.007427446595089071, 0.0739513953972752, -0.04234372847709777,
    -0.1336714021703641, -0.26647218033859055, 0.2517897204927605,
    -0.1609531360746282, -0.31269450978411467, -0.1037059226753689, 0.0,
    -0.7392352672362037, 0.10155039723784587, 0.3116257469316312,
    0.31463433573519484, 0.3197042063302994, 0.9089284213218878, 1.5,
    3.0160354109275964], [0.0, 0.0, -0.12169915141213215,
    -0.07938199859524459, -0.018680697541755834, -0.13063239389020057,
    -0.031997310259572725, 0.14133093035982908, -0.06256615303932714,
    -0.2594326529223732, -0.44992180763367773, 0.45243860969469246,
    -0.2888939711398486, -0.33618647560512266, -0.0650018600922909, 0.0,
    -1.1708064062042276, 0.10998931109606043, 0.4862270055745582,
    0.37698032414104454, 0.49870528665778735, 1.3027283787521773, 2.25,
    5.895403362396896], [0.0, 0.0, -0.24573173229847406, -0.1506826997632018,
    -0.08299442634409149, -0.2894994407751495, -0.15055364329555265,
    0.2811461688202505, -0.09980688449418522, -0.49024816950616784,
    -0.6903505690749885, 0.8437400923468686, -0.47045239007629147,
    -0.27055185274153853, 0.04661620965847677, 0.0, -1.7190055736182794,
    0.0848321182977633, 0.7752028115886554, 0.4192930738906767,
    0.736937083754216, 1.8908814827556122, 3.375, 11.84736104715136], [0.0,
    0.0, -0.33933477839379483, -0.19708342970354248, -0.1399541494361206,
    -0.41029824249372165, -0.28806494606854216, 0.37435794235313186,
    -0.11691272651898402, -0.6103550932106757, -0.7967708340468885,
    1.1010014663915435, -0.555720913950685, -0.24590783087617446,
    0.1221680470606114, 0.0, -1.985151891907594, 0.07084303982389013,
    0.9512946960425835, 0.4192648724097187, 0.8732821546793141,
    2.2396023067275523, 4.0, 15.972224568569363]]}, 'ac': {'dof': 213,
    'start': 2.25, 'target': -0.943112476134047, 'p': 2.999999999938152,
    'iters': 4, 'res_norms': [0.3420874943494748, 0.028413270151375247,
    0.0002889011578572764, 1.1829561026555679e-06, 2.90837745721376e-12]},
    'flux': {'F': 0.6228705318013417, 'dF_dU': 0.17821359132934722,
    'central_difference': 0.17821359080411048, 'h': 0.001}, 'bratu': {'lam':
    [0.0, 1.0, 2.5, 4.75, 6.0], 'newton': [0, 2, 2, 3, 3], 'arc_lam': [6.0,
    6.491117027880676, 6.805485572903932, 6.485888317186042,
    5.569281282760934, 4.2030469511613555, 2.449924513210624,
    0.882321640433402], 'arc_newton': [0, 3, 3, 4, 4, 4, 4, 5], 'folds': [2],
    'fold_lam': 6.808133423631652, 'fold_iters': 4}, 'small': {'pitchfork':
    {'lam': 9.869736469197013, 'iters': 2, 'converged': True}, 'hopf': {'b':
    2.6899999999943667, 'omega': 1.2999999999925085, 'iters': 5, 'converged':
    True}, 'rb_sweep': [[1.2, -1.8705245979796907], [1.8,
    0.04155504963399331], [2.221, 0.4688221765221141], [2.8,
    -0.1079162936339314], [3.6, -2.897109060779844]], 'film': [[0.2,
    -0.0014868959705559663, -0.0014926375362896798], [0.4,
    -0.009928107306018992, -0.009946356238387022], [0.8, -0.07181276056188003,
    -0.07184933230283652], [1.5, -0.3500930922062093, -0.35011998130697547]],
    'couette': [[0.5, -1.1543599106060125], [2.0, -2.9696508533473507]],
    'heat_device': [-78.99727217857367, -49.36856389720157,
    -49.36856389263032, -19.739855578785836]}}


# goma_tpu's record of the 20x10 immersed cylinder (28 segments)
# (scripts/overset_reference.py --part cylinder --nx 20 --ny 10 --nseg 28)
OVS_REF_20 = {'gmres+ndlu': {'converged': True,
                'drag': 47.43937276333542,
                'levels': [[14, 135], [8, 87], [4, 58], [2, 76], [1, 92]],
                'linear': [1, 1, 1],
                'newton': 3,
                'x_samples': [0.0, 2.0426776812166154, 0.0033867719136375196,
                              0.015164451362392542, 0.029529897346420027,
                              0.14586908143482805, 0.8272734739828945,
                              0.438608374192567, 0.3955568869372126,
                              0.21264743634275013, 0.20445077539091835,
                              0.3180411359662486, 0.134696494687837,
                              0.25429647870747024, 0.09360926432213527,
                              0.140703994165065, 0.13773417673933042,
                              0.02029492026596955, -0.010969264715608502,
                              -0.001247100722379052, -0.009811852263841205,
                              -0.0028601556706662557, 0.0,
                              -18.317747434694624]},
 'n_dof': 2009,
 'n_lm': 56,
 'nnz': 77683,
 'nseg': 28,
 'nx': 20,
 'ny': 10,
 'tpu_direct': {'converged': True,
                'drag': 47.439372763310125,
                'levels': [[14, 135], [8, 87], [4, 58], [2, 76], [1, 92]],
                'linear': [1, 1],
                'newton': 2,
                'x_samples': [0.0, 2.0426776812167047, 0.0033867719136365868,
                              0.015164451362387586, 0.029529897346410403,
                              0.14586908143482666, 0.8272734739828597,
                              0.4386083741926602, 0.3955568869373821,
                              0.2126474363427116, 0.20445077539092912,
                              0.31804113596634087, 0.13469649468780207,
                              0.25429647870743055, 0.09360926432211052,
                              0.1407039941650391, 0.13773417673931934,
                              0.020294920265965896, -0.010969264715620966,
                              -0.001247100722386216, -0.009811852263849128,
                              -0.0028601556706685403, 0.0,
                              -18.317747436057605]}}


def _counted(plain):
    """``plain`` with a launch counter, as the kernel wrappers carry."""
    def counted(*a, **k):
        counted.launches += 1
        return plain(*a, **k)

    counted.launches = 0
    return counted


def load_smoke():
    """chip_smoke as a module whose CUDA devices are the CPU."""
    src = (REPO / "chip_smoke.py").read_text()
    for a, b in (('device="cuda"', 'device="cpu"'),
                 ('torch.device("cuda", 0)', 'torch.device("cpu")'),
                 ("torch.device(d)", 'torch.device("cpu")')):
        src = src.replace(a, b)
    cs = types.ModuleType("chip_smoke")
    cs.__file__ = str(REPO / "chip_smoke.py")
    exec(compile(src, "chip_smoke.py", "exec"), cs.__dict__)
    cs.device_ms = lambda fn, reps, launches=None, required=True, graph=False: (
        fn(), (0.0, launches or 1))[1]
    cs.graph_ms = lambda fn, reps=20: (fn(), 0.0)[1]
    cs.gpu_line = lambda: "CPU rehearsal, 0 W"
    cs.timed_build = lambda name: (0.0, "")
    cs.N_MAIN = cs.N_BUOY = cs.N_BUBBLE = 8
    cs.N_VE = 4
    cs.GHIA_TOL = cs.X_PATHS_TOL = cs.BUBBLE_DP_RTOL = 1.0
    cs.BUOY_NEWTON = 5
    # the cut decks' linear iterations (CPU)
    cs.CAVITY_LINEAR = [1, 13, 13, 10]
    cs.BUOY_LINEAR = BUOY_LINEAR_8
    cs.VE_LINEAR = VE_LINEAR_4
    cs.SC_NX, cs.SC_NY = 16, 4
    cs.SC_REF_NEWTON = SC_REF_NEWTON_16
    cs.SC_REF_HEIGHTS = SC_REF_HEIGHTS_16
    cs.TWOLEVEL_REF = TWOLEVEL_REF_8
    cs.AX_NZ, cs.AX_NR = 16, 8
    for k, v in AX_REF_16.items():
        setattr(cs, k, v)
    cs.TILT_N, cs.TILT_REF = 8, TILT_REF_8
    # the cut periodic deck stops after one inexact float32 step
    cs.REF_X_TOL = 1e-3
    cs.PER_NX, cs.PER_NY, cs.PER_REF = 16, 8, PER_REF_8
    cs.CONT_N, cs.CONT_BRATU_N, cs.CONT_REF = 8, 16, CONT_REF_8
    cs.GHIA400_RTOL = 1.0
    cs.OVS_NX, cs.OVS_NY, cs.OVS_NSEG, cs.OVS_REF = 20, 10, 28, OVS_REF_20
    cs.SHELL_N = 8
    cs.SHELL_REF = dict(SHELL_REF_8, small=cs.SHELL_REF["small"])
    return cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-viscoelastic", action="store_true",
                    help="run phases 14-17 only")
    ap.add_argument("--only-two-phase", action="store_true",
                    help="run phases 18-21 only")
    ap.add_argument("--only-slot-coater", action="store_true",
                    help="run phases 22-25 only")
    ap.add_argument("--only-two-level", action="store_true",
                    help="run phases 26-29 only")
    ap.add_argument("--only-axisym", action="store_true",
                    help="run phases 30-32 only")
    ap.add_argument("--only-bc", action="store_true",
                    help="run phases 33-38 only")
    ap.add_argument("--only-continuation", action="store_true",
                    help="run phases 39-44 only")
    ap.add_argument("--only-overset", action="store_true",
                    help="run phases 45-47 only")
    ap.add_argument("--only-shell", action="store_true",
                    help="run phases 48-50 only")
    args = ap.parse_args()
    _fake_cuda()
    cs = load_smoke()
    t0 = time.perf_counter()
    if args.only_viscoelastic:
        dev = torch.device("cpu")
        cs.cross_check_ve()
        ve = cs.ve_gmres_phase(dev)
        cs.ve_direct_phase(dev, ve.pop("prob"), ve["x"])
        cs.ve_transient_phase(dev)
    elif args.only_two_phase:
        from goma_tpu_torch.solvers import NewtonSolver

        dev = torch.device("cpu")
        cs.cross_check_bubble()
        tp = cs.bubble_gmres_phase(dev)
        cs.bubble_direct_phase(dev, tp.pop("prob"), tp.pop("params"), tp["x"])
        prob = cs.cavity_problem(cs.N_MAIN, dev)
        cs.pipelined_phase(NewtonSolver(prob, cs.cavity_opts()),
                           np.zeros(prob.dofmap.n_dof), prob.base_params())
    elif args.only_slot_coater:
        from goma_tpu_torch.solvers import NewtonSolver

        dev = torch.device("cpu")
        cs.cross_check_slot_coater()
        sc = cs.slot_gmres_phase(dev)
        cs.slot_direct_phase(dev, sc["x"])
        bprob = cs.buoyant_problem(cs.N_BUOY, dev)
        bx = NewtonSolver(bprob, cs.buoyant_opts()).solve(
            np.zeros(bprob.dofmap.n_dof), bprob.base_params()).x
        cs.buoyant_direct_phase(bprob, bx)
    elif args.only_two_level:
        from goma_tpu_torch.solvers import NewtonSolver

        dev = torch.device("cpu")
        cs.small_options_phase()
        prob = cs.cavity_problem(cs.N_MAIN, dev)
        x = NewtonSolver(prob, cs.cavity_opts()).solve(
            np.zeros(prob.dofmap.n_dof), prob.base_params()).x
        cs.twolevel_phase(prob, "cavity twolevel", "cavity", x,
                          cs.TWOLEVEL_X_TOL, relative=False)
        bprob = cs.buoyant_problem(cs.N_BUOY, dev)
        bx = NewtonSolver(bprob, cs.buoyant_opts()).solve(
            np.zeros(bprob.dofmap.n_dof), bprob.base_params()).x
        cs.twolevel_phase(bprob, "buoyant twolevel", "buoyant", bx,
                          cs.BUOY_TWOLEVEL_X_TOL, relative=True, warm_up=False)
        cs.bubble_host_direct_phase(dev, cs.bubble_gmres_phase(dev))
    elif args.only_axisym:
        dev = torch.device("cpu")
        dg = cs.die_gmres_phase(dev)
        cs.die_direct_phase(dev, dg.pop("prob"), dg["x"])
        cs.axisym_small_phase()
    elif args.only_bc:
        from goma_tpu_torch.solvers import NewtonSolver

        dev = torch.device("cpu")
        prob = cs.cavity_problem(cs.N_MAIN, dev)
        res = NewtonSolver(prob, cs.cavity_opts()).solve(
            np.zeros(prob.dofmap.n_dof), prob.base_params())
        tg = cs.tilted_gmres_phase(dev, res.x, res.iters)
        cs.tilted_direct_phase(dev, tg["prob"], tg["x"])
        cs.residual_phase([("cavity", prob, res.x),
                           ("tilted", tg.pop("prob"), tg["x"])])
        pg = cs.periodic_gmres_phase(dev)
        cs.periodic_direct_phase(dev, pg.pop("prob"), pg["x"])
        cs.bc_small_phase()
    elif args.only_continuation:
        dev = torch.device("cpu")
        cg = cs.continuation_phase(dev, "gmres_ndlu")
        cs.continuation_phase(dev, "tpu_direct")
        cs.augmenting_phase(cg["prob"], cg["steps"])
        cs.flux_phase(cg["prob"], cg["steps"][-1].x)
        cs.bratu_phase(dev)
        cs.stability_phase(dev)
    elif args.only_overset:
        dev = torch.device("cpu")
        og = cs.overset_phase(dev, "gmres+ndlu")
        cs.overset_phase(dev, "tpu_direct", og.pop("prob"), og.pop("bi"))
        cs.overset_small_phase()
    elif args.only_shell:
        dev = torch.device("cpu")
        bg = cs.bearing_phase(dev, "gmres+ndlu")
        cs.bearing_phase(dev, "tpu_direct", bg.pop("prob"))
        fg = cs.film_phase(dev, "gmres+ndlu")
        cs.film_phase(dev, "tpu_direct", fg.pop("prob"), fg.pop("x0"))
        cs.shell_small_phase()
    else:
        cs.main()
    print(f"rehearsal passed in {time.perf_counter() - t0:.1f} s (CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
