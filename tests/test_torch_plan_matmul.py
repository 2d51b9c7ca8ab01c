"""The whole slice against the JAX package, banded regimes: the port's
``stencil_plan(..., device="cpu", backend=b)(x)`` against the JAX plan for
``matmul``, ``fused_matmul`` and ``fused_matmul_reuse``."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_plan import check_decision, run_both, tolerance  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


@pytest.mark.parametrize("backend", ["matmul", "fused_matmul",
                                     "fused_matmul_reuse"])
@pytest.mark.parametrize("kind", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_plan_matches_jax(backend, kind, r, t):
    x, plan, port, ref = run_both(backend, kind, r, t)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=tolerance(x, torch.float32, t, 1))
    check_decision(plan, t, 4)
