"""Config module for ``glm4-9b`` (see registry.py for the numbers)."""
from repro_torch.configs.registry import ARCHS, SMOKE, SHAPES, cells_for

ARCH = "glm4-9b"
FULL = ARCHS[ARCH]
SMOKE_CFG = SMOKE[ARCH]
CELLS = {name: SHAPES[name] for name in cells_for(ARCH)}
