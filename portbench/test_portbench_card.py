"""On the card: the LEGACY reference draws the port's panels bit for bit
from the same seed, and its bfloat16 control does not (a small registry;
the cells' own sizes are read by ``portbench.calibrate``)."""

import pytest
import torch

from citizensassemblies_tpu_torch.interop import dense_from_arrays
from citizensassemblies_tpu_torch.models.legacy import sample_feasible_panels
from citizensassemblies_tpu_torch.utils.config import Config
from portbench.requests import pool_arrays
from portbench.pools import registry_pool
from portbench.reference import legacy as ref


@pytest.mark.card
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_reference_and_control_on_the_card(card, seed):
    arrays = pool_arrays(registry_pool(seed, 20_000, [2, 7, 12, 4, 3], 0.08))
    A, qmin, qmax, _cat, k, _c = arrays
    panels, draws = sample_feasible_panels(dense_from_arrays(*arrays, device=card), 2048,
                                           seed=seed, cfg=Config(mc_batch=2048))
    want = ref.draw_feasible(A, qmin, qmax, k, 2048, seed, 2048, card)
    got = ref.judge(panels, draws, ref.allocation(panels, A.shape[0], 2048), want, A.shape[0],
                    2048)
    assert got == {"panel_mismatch": 0.0, "draws_gap": 0.0, "alloc_gap": 0.0}
    low = ref.draw_feasible(A, qmin, qmax, k, 2048, seed, 2048, card, ratio_dtype=torch.bfloat16)
    ctl = ref.judge(low["panels"], low["draws"], ref.allocation(low["panels"], A.shape[0], 2048),
                    want, A.shape[0], 2048)
    assert ctl["panel_mismatch"] > 0
