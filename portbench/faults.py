"""Faults planted under the timed path, to show that the check catches them:
the benchmark's own tests plant each at a small size on the CPU, and
``portbench.calibrate`` at the cell's size on the card, where its readings
set the upper end of a limit.

* ``state_unchanged``: the rows step returns the state it was given (in
  training: the optimizer takes no step, the model stays as it was);
* ``half_batch``: the rows step moves half the envs (in training: the loss
  is the mean over half the batch);
* ``altered_answer``: the rows step's output is altered where it is made
  (one observation of one env by 1e-3; in training every env's reward, by
  1e-3);
* ``done_flipped``: the rows step's done row is flipped where it is made
  (every env's, at every step).

The exchange between chips has no fault here: every cell runs on one card.
"""

from __future__ import annotations

from contextlib import contextmanager

FAULTS = ("state_unchanged", "half_batch", "altered_answer", "done_flipped")


@contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


def _rows_step_fault(kind, cfg, training):
    """A ``make_rows_step`` whose steps carry the fault ``kind``; ``cfg`` is
    the configuration's plain reference, which names the emit's rows."""
    from vmas_tpu_torch.core import fused as F

    real = F.make_rows_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def faulty(carry, act, extra_out=None, carry_out=None):
            new, extra = step(carry, act, extra_out, carry_out)
            if kind == "state_unchanged":
                new.copy_(carry)
            elif kind == "half_batch":
                half = carry.shape[1] // 2
                new[:, half:] = carry[:, half:]
            elif kind == "done_flipped":
                extra[cfg.DONE_ROW] = 1.0 - extra[cfg.DONE_ROW]
            elif training:
                extra[cfg.REWARD_ROW] += 1e-3
            else:
                extra[0, 0] += 1e-3
            return new, extra

        return faulty

    return make


@contextmanager
def planted(kind, cell):
    """Plant fault ``kind`` in the program for cell ``cell``'s traffic."""
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel import ppo as PP

    if kind not in FAULTS:
        raise ValueError(f"no fault {kind!r} (have {FAULTS})")
    training = cell.traffic["runner"] == "ppo"
    if training and kind == "state_unchanged":
        def fit_without_step(model, optimizer, batch, epochs, mesh=None, **loss_kw):
            for _ in range(epochs):
                loss, _ = PP.ppo_loss(model, batch, mesh=mesh, **loss_kw)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            return loss.detach()

        with _patched(PP, "fit", fit_without_step):
            yield
    elif training and kind == "half_batch":
        real = PP.ppo_loss

        def half_loss(model, batch, **kw):
            half = batch["obs"].shape[1] // 2
            return real(model, {k: v[:, :half] for k, v in batch.items()}, **kw)

        with _patched(PP, "ppo_loss", half_loss):
            yield
    else:
        with _patched(F, "make_rows_step", _rows_step_fault(kind, cell.reference, training)):
            yield
