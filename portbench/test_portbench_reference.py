"""The plain LEGACY reference accepts the port's answers and rejects
corrupted ones (small pools, on the CPU): panels drawn from other noise, and
panels drawn with the urgency in the precision below the configuration's.
A panel altered where it is produced is the harness tests' fault."""

import numpy as np
import pytest
import torch

from citizensassemblies_tpu_torch.interop import dense_from_arrays
from citizensassemblies_tpu_torch.models.legacy import legacy_probabilities, sample_feasible_panels
from citizensassemblies_tpu_torch.utils.config import Config
from portbench.requests import pool_arrays
from portbench.pools import registry_pool, skewed_pool
from portbench.reference import legacy as legacy_ref


@pytest.fixture(scope="module")
def registry_arrays():
    # small enough for a CPU run, wide enough that a bfloat16 urgency ties
    # cells that float32 tells apart
    return pool_arrays(registry_pool(3, 3000, [2, 7, 12, 4, 3], 0.08))


def test_legacy_reference_draws_the_ports_panels(registry_arrays):
    A, qmin, qmax, _cat, k, _c = registry_arrays
    dense = dense_from_arrays(*registry_arrays, device="cpu")
    panels, draws = sample_feasible_panels(dense, 200, seed=77, cfg=Config(mc_batch=256))
    want = legacy_ref.draw_feasible(A, qmin, qmax, k, 200, 77, 256, "cpu")
    numbers = legacy_ref.judge(panels, draws, legacy_ref.allocation(panels, A.shape[0], 200),
                               want, A.shape[0], 200)
    assert numbers == {"panel_mismatch": 0.0, "draws_gap": 0.0, "alloc_gap": 0.0}
    assert want["accepted"].sum() >= 200


def test_legacy_reference_matches_the_estimator_and_its_pairs():
    pool = skewed_pool(5, 120, 15, [3, 3, 3], 0.12, 0.4)
    arrays = pool_arrays(pool)
    A, qmin, qmax, _cat, k, _c = arrays
    res = legacy_probabilities(dense_from_arrays(*arrays, device="cpu"), iterations=200, seed=4,
                               cfg=Config(mc_batch=64), device="cpu")
    want = legacy_ref.draw_feasible(A, qmin, qmax, k, 200, 4, 64, "cpu")
    assert np.array_equal(res.panels, want["panels"]) and res.draws_attempted == want["draws"]
    assert np.array_equal(res.allocation, legacy_ref.allocation(want["panels"], A.shape[0], 200))
    assert np.array_equal(res.pair_matrix, legacy_ref.pair_matrix(want["panels"], A.shape[0], 200,
                                                                  "cpu"))


@pytest.mark.parametrize("corruption", ["other_noise", "bfloat16_urgency"])
def test_legacy_reference_rejects(registry_arrays, corruption):
    A, qmin, qmax, _cat, k, _c = registry_arrays
    want = legacy_ref.draw_feasible(A, qmin, qmax, k, 200, 77, 256, "cpu")
    if corruption == "other_noise":
        got = legacy_ref.draw_feasible(A, qmin, qmax, k, 200, 78, 256, "cpu")
    else:
        got = legacy_ref.draw_feasible(A, qmin, qmax, k, 200, 77, 256, "cpu",
                                       ratio_dtype=torch.bfloat16)
    numbers = legacy_ref.judge(got["panels"], got["draws"],
                               legacy_ref.allocation(got["panels"], A.shape[0], 200), want,
                               A.shape[0], 200)
    assert numbers["panel_mismatch"] > 0
