"""Generic training orchestration: epochs, logging, checkpointing.

Counterpart of `range_tpu/train/fit.py` (reference: the Lightning fit +
ModelCheckpoint on val_loss, `satclip/main_old.py:116-147`, and the CSP
trainer's epoch loop, `csp/main/trainer.py`): one loop over batch
iterators and a step function that updates the model in place.  The
checkpoints are `torch.save` files of the model's parameters, ``last.pt``
and ``best.pt`` (the JAX package writes ``*.msgpack``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Optional

import torch
from torch import nn

from ..utils.checkpoint import save
from ..utils.metrics import AverageMeter, MetricsWriter, setup_logger


@dataclasses.dataclass
class FitConfig:
    epochs: int = 1
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    save_best: bool = True  # monitor val loss (ModelCheckpoint semantics)
    save_last: bool = True
    seed: int = 0
    # scalar-history file (JSONL, one object per event), the reference's
    # TensorBoard `self.log` analog (satclip/main_old.py:69-77)
    metrics_file: Optional[str] = None


def epoch_decay_schedule(lr: float, lr_decay: float, steps_per_epoch: int):
    """The CSP trainer's per-epoch exponential lr decay,
    ``lr * lr_decay**epoch`` with staircase epoch boundaries
    (csp/main/trainer.py:193,730-759), as a schedule ``step -> lr`` for
    `make_optimizer(learning_rate=...)`."""
    def schedule(step: int) -> float:
        return lr * lr_decay ** (int(step) // steps_per_epoch)

    return schedule


def fit(step_fn: Callable, model: nn.Module,
        train_batches: Callable[[int], Iterator[dict]],
        val_batches: Optional[Callable[[], Iterator[dict]]] = None,
        eval_loss_fn: Optional[Callable] = None,
        config: FitConfig = FitConfig(), logger=None) -> dict:
    """Run the loop; the model is trained in place.

    step_fn(batch, generator) -> loss (`train.satclip.make_train_step`)
    train_batches(epoch) -> iterator of batch dicts (numpy or tensors; each
    value is moved to the model's device)
    eval_loss_fn(model, batch) -> scalar loss, run under `torch.no_grad()`

    The generator handed to step_fn is seeded from ``config.seed`` on the
    model's device.  Returns the history ``{"train_loss": [...],
    "val_loss": [...]}``, one entry an epoch.
    """
    logger = logger or setup_logger("range_tpu_torch.fit")
    if config.ckpt_dir:
        os.makedirs(config.ckpt_dir, exist_ok=True)
    writer = MetricsWriter(config.metrics_file) if config.metrics_file else None
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(config.seed)

    def on_device(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    history = {"train_loss": [], "val_loss": []}
    best_val = float("inf")
    step = 0
    for epoch in range(config.epochs):
        meter = AverageMeter()
        for batch in train_batches(epoch):
            loss = step_fn(on_device(batch), generator)
            step += 1
            meter.update(float(loss))
            if step % config.log_every == 0:
                logger.info(f"epoch {epoch} step {step} loss {meter.val:.4f} "
                            f"(avg {meter.avg:.4f})")
                if writer:
                    writer.log(step, epoch=epoch, train_loss=meter.val,
                               train_loss_avg=meter.avg)
        history["train_loss"].append(meter.avg if meter.count else float("nan"))
        if not meter.count:
            logger.warning(f"epoch {epoch}: no training batches")

        if val_batches is not None and eval_loss_fn is not None:
            vmeter = AverageMeter()
            with torch.no_grad():
                for batch in val_batches():
                    vmeter.update(float(eval_loss_fn(model, on_device(batch))))
            history["val_loss"].append(vmeter.avg)
            logger.info(f"epoch {epoch} val_loss {vmeter.avg:.4f}")
            if writer:
                writer.log(step, epoch=epoch, val_loss=vmeter.avg)
            if config.ckpt_dir and config.save_best and vmeter.avg < best_val:
                best_val = vmeter.avg
                save(os.path.join(config.ckpt_dir, "best.pt"), model)

        if config.ckpt_dir and config.save_last:
            save(os.path.join(config.ckpt_dir, "last.pt"), model)
    if writer:
        writer.close()
    return history
