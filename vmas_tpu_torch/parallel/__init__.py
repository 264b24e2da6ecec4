from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn, rows_rollout_supported

__all__ = ["rollout_fn", "rows_rollout_fn", "rows_rollout_supported"]
