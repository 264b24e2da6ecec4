from vmas_tpu_torch.environment.environment import Environment

__all__ = ["Environment"]
