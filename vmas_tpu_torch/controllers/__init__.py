from vmas_tpu_torch.controllers.velocity_controller import VelocityController

__all__ = ["VelocityController"]
