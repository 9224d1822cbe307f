"""Architecture registry: --arch <id> resolves here."""
from repro_torch.lm.configs.base import ModelConfig, ShapeSpec, SHAPES, cell_applicable

from repro_torch.lm.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.lm.configs.whisper_medium import CONFIG as _whisper
from repro_torch.lm.configs.granite_moe_1b import CONFIG as _granite
from repro_torch.lm.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.lm.configs.command_r_35b import CONFIG as _command_r
from repro_torch.lm.configs.minitron_4b import CONFIG as _minitron
from repro_torch.lm.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.lm.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.lm.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.lm.configs.jamba_52b import CONFIG as _jamba

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        _paligemma, _whisper, _granite, _deepseek, _command_r,
        _minitron, _qwen3, _phi3, _xlstm, _jamba,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_config", "ModelConfig", "ShapeSpec", "SHAPES",
           "cell_applicable"]
