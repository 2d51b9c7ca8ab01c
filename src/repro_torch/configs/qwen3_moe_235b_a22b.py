"""Config module for ``qwen3-moe-235b-a22b`` (see registry.py for the numbers)."""
from repro_torch.configs.registry import ARCHS, SMOKE, SHAPES, cells_for

ARCH = "qwen3-moe-235b-a22b"
FULL = ARCHS[ARCH]
SMOKE_CFG = SMOKE[ARCH]
CELLS = {name: SHAPES[name] for name in cells_for(ARCH)}
