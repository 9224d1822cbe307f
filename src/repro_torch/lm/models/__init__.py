from repro_torch.lm.models.model import Model

__all__ = ["Model"]
