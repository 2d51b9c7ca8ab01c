"""The Star cells of ``test_torch_workspace_deep.py``: Star-3D7R at t = 2
(h = 14) and t = 8 (h = 56), the tap-sum and the reuse folds, each on the
smallest grid both packages take, against the port's copy of JAX's
``apply_stencil`` stepped t times, itself held to JAX's for one step
(JAX's decision counting a star's fused support with the port's closed
count, as there)."""
import pytest
import torch

pytest.importorskip("jax")

import test_torch_workspace_deep as deep  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _quick_support_count():
    mp = pytest.MonkeyPatch()
    mp.setattr(deep.jweights, "fused_num_points",
               deep.tweights.fused_num_points)
    yield
    mp.undo()


def test_the_port_oracle_is_jax_apply_stencil():
    deep.jax_one_step_check("Star-3D7R", 14)


@pytest.mark.parametrize("pattern,t,regime", deep.cells("Star"))
def test_deep_star_cells_match_the_oracle(pattern, t, regime):
    deep.check_cell(pattern, t, regime)
