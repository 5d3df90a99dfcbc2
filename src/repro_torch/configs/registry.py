"""--arch <id> resolution for every assigned architecture."""
from repro_torch.configs.base import ModelConfig, SHAPES, reduced, shape_cells

from repro_torch.configs.smollm_135m import CONFIG as smollm_135m
from repro_torch.configs.starcoder2_7b import CONFIG as starcoder2_7b
from repro_torch.configs.nemotron_4_340b import CONFIG as nemotron_4_340b
from repro_torch.configs.minicpm3_4b import CONFIG as minicpm3_4b
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as llama_3_2_vision_11b
from repro_torch.configs.phi3_5_moe_42b import CONFIG as phi3_5_moe_42b
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from repro_torch.configs.mamba2_2_7b import CONFIG as mamba2_2_7b
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    smollm_135m, starcoder2_7b, nemotron_4_340b, minicpm3_4b,
    llama_3_2_vision_11b, phi3_5_moe_42b, deepseek_v2_lite_16b,
    mamba2_2_7b, zamba2_7b, seamless_m4t_large_v2,
]}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells() -> list[tuple[str, str]]:
    """Every live (arch, shape) dry-run cell."""
    out = []
    for name, cfg in ARCHS.items():
        for cell in shape_cells(cfg):
            out.append((name, cell))
    return out
