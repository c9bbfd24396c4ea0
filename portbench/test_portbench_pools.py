"""The frozen pool generators give the port's pools, array for array."""

import numpy as np
import pytest

from citizensassemblies_tpu_torch.core.generator import sf_e_skewed_instance
from citizensassemblies_tpu_torch.core.instance import featurize
from citizensassemblies_tpu_torch.data.registry import nationwide_registry
from portbench.pools import derived_seed, make_pool, registry_pool, skewed_pool


@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 11])
def test_skewed_pool_is_the_ports_sf_e_pool(seed):
    pool = skewed_pool(seed, 1727, 110, [2, 4, 5, 3, 2, 4, 6], 0.12, 0.4)
    dense, _ = featurize(sf_e_skewed_instance(seed=seed), device="cpu")
    assert np.array_equal(pool.incidence(), dense.A_np)
    assert np.array_equal(pool.qmin, dense.qmin_np)
    assert np.array_equal(pool.qmax, dense.qmax_np)
    assert pool.k == dense.k


@pytest.mark.parametrize("n,seed", [(100_000, 0), (20_000, 5)])
def test_registry_pool_is_the_ports_registry(n, seed):
    reg = nationwide_registry(n=n, seed=seed)
    pool = registry_pool(seed, n, [2, 7, 12, 4, 3], 0.08)
    assert np.array_equal(pool.incidence(), reg.incidence())
    assert np.array_equal(pool.qmin, reg.qmin) and np.array_equal(pool.qmax, reg.qmax)
    assert pool.k == reg.k == (316 if n == 100_000 else 141)


def test_make_pool_reads_a_configuration_block():
    spec = {"generator": "registry", "n": 500, "sizes": [2, 3], "quota_slack": 0.2, "k": 20}
    a, b = make_pool(spec, 9), make_pool(spec, 9)
    assert np.array_equal(a.assign, b.assign) and a.k == 20
    assert not np.array_equal(a.assign, make_pool(spec, 10).assign)


def test_derived_seeds_differ_and_take_large_seeds():
    seeds = {derived_seed(2**40 + 3, i, salt) for i in range(50) for salt in range(3)}
    assert len(seeds) == 150 and all(0 <= s < 2**63 for s in seeds)
