"""MultistageTrainer: optimizer resets at stage boundaries.

Counterpart of ``multivae_tpu/trainers/multistage/multistage_trainer.py``.
Before each epoch the model's stage is set from ``stage_for_epoch`` (where
the model has stages). At each epoch of ``model.reset_optimizer_epochs``
the trainer first saves ``checkpoint_epoch_<epoch - 1>`` (every rank: a
sharded save is a collective; committed before the reset), then the kept
weights (the live ones when none were kept) are loaded into the model, a
fresh optimizer and scheduler are built over its parameters, the kept
weights are dropped and both best losses restart at 1e12, as in the JAX
package. A run resumed from that checkpoint goes on at the boundary epoch
and resets again there, as the uninterrupted run did. For TELBO
(``reset_optimizer_epochs = [warmup]``) the reset comes at the start of
epoch ``warmup``, still in stage 1, and the stage flips at ``warmup + 1``;
for JNF (``[warmup + 1]``) the reset and the flip come at the start of the
same epoch, the stage set first.

The optimizer is a new object after a reset: hooks registered on the old
one do not carry over. A reset and a stage change drop the captured CUDA
graphs of ``steps_per_execution``. The epochs of both are the trainer's
``_prepare_boundaries``, so the pipelined finalization finalizes the epoch
before each at once and defers the others, as in the JAX package.
"""

from __future__ import annotations

import logging

from ..base.base_trainer import BaseTrainer

logger = logging.getLogger(__name__)


class MultistageTrainer(BaseTrainer):
    """Trainer for two-stage models (TELBO, JNF)."""

    def checktrainer(self, model):
        return

    def _prepare_boundaries(self):
        """The reset epochs and the epochs whose stage differs from the one
        before (JAX ``MultistageTrainer._prepare_boundaries``)."""
        model = self.model
        bounds = set(getattr(model, "reset_optimizer_epochs", []) or [])
        if hasattr(model, "stage_for_epoch"):
            for e in range(2, self.training_config.num_epochs + 1):
                if model.stage_for_epoch(e) != model.stage_for_epoch(e - 1):
                    bounds.add(e)
        return bounds

    def prepare_train_step(self, epoch, best_train_loss, best_eval_loss):
        model = self.model
        if hasattr(model, "stage_for_epoch"):
            stage = model.stage_for_epoch(epoch)
            if stage != getattr(model, "current_stage", None):
                self._drop_graphs()
            model.set_stage(stage)
        if epoch not in getattr(model, "reset_optimizer_epochs", []):
            return best_train_loss, best_eval_loss
        logger.info("Epoch %s: reset the optimizer and the best losses, going on "
                    "from the best model so far.", epoch)
        self.save_checkpoint(dir_path=self.training_dir, epoch=epoch - 1)
        self.wait_for_checkpoint()   # the boundary's checkpoint committed first
        self._restore_best()
        self._build_optimizer()
        self._best_state = None
        return 1e12, 1e12
