"""Architecture configuration registry of the port: the 10 assigned archs,
with the same numbers as ``repro.configs.registry`` (a copy; the port
imports nothing of the JAX package).

Every architecture is a ``ModelConfig``; ``SMOKE[name]`` is the reduced
same-family variant used by CPU smoke tests.  Input shapes are the four
assigned (arch-independent) cells; per-arch skips follow DESIGN.md §5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    shared_attn_every: int = 6   # zamba2: shared attention block cadence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | rwkv | whisper | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp_act: str = "swiglu"       # swiglu | gelu
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # whisper: encoder layers == n_layers, decoder layers:
    dec_layers: Optional[int] = None
    # vlm: number of image patch positions fed by the stub frontend
    n_img_patches: int = 0
    tie_embeddings: bool = False
    fsdp: bool = False            # shard params+opt over data axis too (ZeRO-3)
    remat: bool = True
    dtype: str = "bfloat16"       # activation/compute dtype
    sub_quadratic: bool = False   # True => can run long_500k
    attn_chunk: int = 512         # query-chunked exact attention
    # --- beyond-paper perf variants (EXPERIMENTS.md §Perf) ---
    wkv_factored: bool = False    # rwkv6: factored intra-chunk decay
    moe_group: int = 0            # moe: dispatch group size (0 = full seq)
    pure_dp: bool = False         # fold `model` into data parallelism
                                  # (attention-free archs: TP buys nothing)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


ARCHS = {}
SMOKE = {}


def _reg(full: ModelConfig, smoke: ModelConfig):
    ARCHS[full.name] = full
    SMOKE[full.name] = smoke


# --- LM-family transformers (assigned pool) --------------------------------
_reg(
    ModelConfig("llama3.2-1b", "dense", 16, 2048, 32, 8, 8192, 128256, fsdp=True),
    ModelConfig("llama3.2-1b", "dense", 2, 64, 4, 2, 128, 256),
)
_reg(
    ModelConfig("glm4-9b", "dense", 40, 4096, 32, 2, 13696, 151552, fsdp=True),
    ModelConfig("glm4-9b", "dense", 2, 64, 4, 2, 160, 256),
)
_reg(
    ModelConfig("deepseek-7b", "dense", 30, 4096, 32, 32, 11008, 102400,
                rope_theta=10000.0, fsdp=True),
    ModelConfig("deepseek-7b", "dense", 2, 64, 4, 4, 128, 256,
                rope_theta=10000.0),
)
_reg(
    ModelConfig("tinyllama-1.1b", "dense", 22, 2048, 32, 4, 5632, 32000,
                rope_theta=10000.0, fsdp=True),
    ModelConfig("tinyllama-1.1b", "dense", 2, 64, 4, 2, 96, 256,
                rope_theta=10000.0),
)
_reg(
    ModelConfig("internvl2-2b", "vlm", 24, 2048, 16, 8, 8192, 92553,
                n_img_patches=256, fsdp=True),
    ModelConfig("internvl2-2b", "vlm", 2, 64, 4, 2, 128, 256, n_img_patches=16),
)
_reg(
    # pure_dp: d=512 is far too narrow for 16-way TP (§Perf D1: 5.9x);
    # the batch>=chips policy in dryrun falls back to TP for small-batch cells.
    ModelConfig("whisper-base", "whisper", 6, 512, 8, 8, 2048, 51865,
                mlp_act="gelu", dec_layers=6, pure_dp=True, fsdp=True),
    ModelConfig("whisper-base", "whisper", 2, 64, 4, 4, 128, 256,
                mlp_act="gelu", dec_layers=2),
)
_reg(
    ModelConfig("zamba2-1.2b", "hybrid", 38, 2048, 32, 32, 8192, 32000,
                ssm=SSMConfig(state_dim=64), sub_quadratic=True, fsdp=True),
    ModelConfig("zamba2-1.2b", "hybrid", 4, 64, 4, 4, 128, 256,
                ssm=SSMConfig(state_dim=16, head_dim=16), sub_quadratic=True),
)
_reg(
    ModelConfig("olmoe-1b-7b", "moe", 16, 2048, 16, 16, 1024, 50304,
                moe=MoEConfig(64, 8), fsdp=True),
    ModelConfig("olmoe-1b-7b", "moe", 2, 64, 4, 4, 64, 256,
                moe=MoEConfig(8, 2)),
)
_reg(
    ModelConfig("qwen3-moe-235b-a22b", "moe", 94, 4096, 64, 4, 1536, 151936,
                head_dim=128, moe=MoEConfig(128, 8), fsdp=True),
    ModelConfig("qwen3-moe-235b-a22b", "moe", 2, 64, 4, 2, 64, 256,
                moe=MoEConfig(8, 2)),
)
_reg(
    # production config ships the §Perf winners (wkv_factored + pure_dp);
    # paper-faithful baselines were recorded with both flags off.
    ModelConfig("rwkv6-1.6b", "rwkv", 24, 2048, 32, 32, 7168, 65536,
                sub_quadratic=True, fsdp=True, wkv_factored=True,
                pure_dp=True),
    ModelConfig("rwkv6-1.6b", "rwkv", 2, 64, 4, 4, 224, 256,
                sub_quadratic=True),
)


# --- Input shape cells ------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cells_for(arch: str):
    """The shape cells actually lowered for an arch (DESIGN.md §5 skips)."""
    cfg = ARCHS[arch]
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


def get(name: str, smoke: bool = False) -> ModelConfig:
    return (SMOKE if smoke else ARCHS)[name]
