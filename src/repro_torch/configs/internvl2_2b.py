"""Config module for ``internvl2-2b`` (see registry.py for the numbers)."""
from repro_torch.configs.registry import ARCHS, SMOKE, SHAPES, cells_for

ARCH = "internvl2-2b"
FULL = ARCHS[ARCH]
SMOKE_CFG = SMOKE[ARCH]
CELLS = {name: SHAPES[name] for name in cells_for(ARCH)}
