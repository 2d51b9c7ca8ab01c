"""Config module for ``rwkv6-1.6b`` (see registry.py for the numbers)."""
from repro_torch.configs.registry import ARCHS, SMOKE, SHAPES, cells_for

ARCH = "rwkv6-1.6b"
FULL = ARCHS[ARCH]
SMOKE_CFG = SMOKE[ARCH]
CELLS = {name: SHAPES[name] for name in cells_for(ARCH)}
