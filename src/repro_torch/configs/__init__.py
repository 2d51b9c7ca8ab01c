"""Model configurations of the port (a copy of ``repro.configs``)."""
from .registry import ARCHS, SMOKE, SHAPES, ModelConfig, MoEConfig, SSMConfig, ShapeCell, cells_for, get
