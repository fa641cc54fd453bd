from repro_torch.configs.base import ArchConfig, FedPlan, LM_SHAPES, MLAConfig, MoEConfig, ShapeSpec

__all__ = ["ArchConfig", "FedPlan", "LM_SHAPES", "MLAConfig", "MoEConfig", "ShapeSpec"]
