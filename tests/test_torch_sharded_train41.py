"""SMOKE llama3.2-1b's sharded train step on a 4x1 ("data", "model") gloo
world of 4 CPU ranks -- data parallel with the parameters sharded over
`data` (FSDP) -- against the port's single-device step, with the bounds of
``tests/test_torch_sharded_train.py`` (the 2x2 case and the others)."""
import sharded_parity as sp
from repro_torch.launch.world import run_world
from torch_threads import one_intra_op_thread  # noqa: F401


def test_llama_sharded_step_matches_single_device_4x1(tmp_path):
    res = run_world(sp.sharded_rank, 4, args=([sp.FULL], str(tmp_path), ()),
                    mesh_shape=(4, 1), mesh_dim_names=("data", "model"),
                    device="cpu", timeout_s=400)[0]
    sp.check_full(res[sp.FULL], sp.single_reference(), "4x1")
