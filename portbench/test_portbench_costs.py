"""The frozen cost formulas equal the port's ``obs/roofline`` today, at the
flagship shapes (C = 6,144, kp = 112, T = 814; one lane and three)."""

import pytest

from citizensassemblies_tpu_torch.obs import roofline as port
from portbench import costs

FLAGSHIP = dict(C=6144, kp=112, T=814)


def test_peaks_are_the_ports():
    assert costs.HBM_BYTES_PER_S == port.HBM_BYTES_PER_S
    assert costs.F32_FLOPS_PER_S == port.F32_FLOPS_PER_S


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("value_bytes,lane_values", [(4, False), (2, False), (2, True)])
def test_gather_cost(lanes, value_bytes, lane_values):
    mine = costs.gather_cost(**FLAGSHIP, lanes=lanes, value_bytes=value_bytes,
                             lane_values=lane_values)
    theirs = port.gather_cost(**FLAGSHIP, lanes=lanes, value_bytes=value_bytes,
                              lane_values=lane_values)
    assert tuple(mine) == tuple(theirs)
    assert costs.bound(mine) == port.bound(theirs)


@pytest.mark.parametrize("lanes,iters", [(1, 2048), (3, [2048, 1536, 4096])])
def test_two_sided_cost(lanes, iters):
    nnz = 6144 * 110
    mine = costs.two_sided_cost(**FLAGSHIP, nnz=nnz, lanes=lanes, iters=iters, check_every=64)
    theirs = port.two_sided_cost(**FLAGSHIP, nnz=nnz, lanes=lanes, iters=iters, check_every=64)
    assert tuple(mine) == tuple(theirs)
    assert costs.bound(mine) == port.bound(theirs)
    assert costs._evals(iters, 64) == port._evals(iters, 64)


@pytest.mark.parametrize("m1,kp,nv,iters", [(4096, 112, 1728, 1408), (2048, 320, 100_001, 8832)])
def test_lp_cost(m1, kp, nv, iters):
    mine = costs.lp_cost(m1, kp, nv, m1 * kp, iters, 128)
    theirs = port.lp_cost(m1, kp, nv, m1 * kp, iters, 128)
    assert tuple(mine) == tuple(theirs)
    assert costs.bound(mine) == port.bound(theirs)
