"""Training callbacks for the high-level Model API (counterpart of
paddle_tpu/hapi/callbacks.py).

Reference parity: python/paddle/hapi/callbacks.py: Callback base,
config_callbacks assembly, ProgBarLogger, ModelCheckpoint, LRScheduler,
EarlyStopping, ReduceLROnPlateau, VisualDL (scalars to a JSONL file, as in
the JAX package: visualdl is not a dependency) and WandbCallback (raises:
wandb is not a dependency either).
"""
from __future__ import annotations

import json
import numbers
import os

import numpy as np

from .progressbar import ProgressBar


def config_callbacks(
    callbacks=None,
    model=None,
    batch_size=None,
    epochs=None,
    steps=None,
    log_freq=2,
    verbose=2,
    save_freq=1,
    save_dir=None,
    metrics=None,
    mode="train",
):
    cbks = list(callbacks) if callbacks else []
    if not any(isinstance(k, ProgBarLogger) for k in cbks):
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(k, LRScheduler) for k in cbks):
        cbks = [LRScheduler()] + cbks
    if save_dir and not any(isinstance(k, ModelCheckpoint) for k in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    metrics = metrics or []
    params = {
        "batch_size": batch_size,
        "epochs": epochs,
        "steps": steps,
        "verbose": verbose,
        "metrics": metrics,
    }
    cbk_list.set_params(params)
    return cbk_list


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks) if callbacks else []
        self.params = {}
        self.model = None

    def append(self, callback):
        self.callbacks.append(callback)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        self.params = params
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        self.model = model
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            fn = getattr(c, name, None)
            if fn is not None:
                fn(*args)

    def on_train_begin(self, logs=None):
        self._call("on_train_begin", logs)

    def on_train_end(self, logs=None):
        self._call("on_train_end", logs)

    def on_eval_begin(self, logs=None):
        self._call("on_eval_begin", logs)

    def on_eval_end(self, logs=None):
        self._call("on_eval_end", logs)

    def on_predict_begin(self, logs=None):
        self._call("on_predict_begin", logs)

    def on_predict_end(self, logs=None):
        self._call("on_predict_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_train_batch_begin(self, step, logs=None):
        self._call("on_train_batch_begin", step, logs)

    def on_train_batch_end(self, step, logs=None):
        self._call("on_train_batch_end", step, logs)

    def on_eval_batch_begin(self, step, logs=None):
        self._call("on_eval_batch_begin", step, logs)

    def on_eval_batch_end(self, step, logs=None):
        self._call("on_eval_batch_end", step, logs)

    def on_predict_batch_begin(self, step, logs=None):
        self._call("on_predict_batch_begin", step, logs)

    def on_predict_batch_end(self, step, logs=None):
        self._call("on_predict_batch_end", step, logs)


class Callback:
    """Base class. Subclass and override `on_{train,eval,predict}_{begin,end}`,
    `on_epoch_{begin,end}`, `on_{train,eval,predict}_batch_{begin,end}`."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self.epochs = None
        self.steps = None

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        assert self.epochs is None or self.epochs >= 0
        self.train_metrics = self.params.get("metrics", [])

    def on_epoch_begin(self, epoch=None, logs=None):
        self.steps = self.params.get("steps")
        self.epoch = epoch
        self.train_step = 0
        if self.epochs and self.verbose:
            print(f"Epoch {epoch + 1}/{self.epochs}")
        self.train_progbar = ProgressBar(num=self.steps, verbose=self.verbose)

    def _updates(self, logs, progbar, step):
        values = []
        for k in self.params.get("metrics", []):
            if k in (logs or {}):
                values.append((k, logs[k]))
        progbar.update(step, values)

    def on_train_batch_end(self, step, logs=None):
        self.train_step += 1
        if self.train_step % self.log_freq == 0 or self.train_step == self.steps:
            if self.verbose:
                self._updates(logs, self.train_progbar, self.train_step)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose and logs:
            self._updates(logs, self.train_progbar, self.train_step)

    def on_eval_begin(self, logs=None):
        self.eval_steps = (logs or {}).get("steps")
        self.eval_step = 0
        self.eval_progbar = ProgressBar(num=self.eval_steps, verbose=self.verbose)
        if self.verbose:
            print("Eval begin...")

    def on_eval_batch_end(self, step, logs=None):
        self.eval_step += 1
        if self.verbose and (self.eval_step % self.log_freq == 0 or self.eval_step == self.eval_steps):
            self._updates(logs, self.eval_progbar, self.eval_step)

    def on_eval_end(self, logs=None):
        if self.verbose:
            self._updates(logs, self.eval_progbar, self.eval_step)
            print("Eval samples: %d" % (logs or {}).get("samples", 0))

    def on_predict_begin(self, logs=None):
        self.pred_steps = (logs or {}).get("steps")
        self.pred_step = 0
        self.pred_progbar = ProgressBar(num=self.pred_steps, verbose=self.verbose)
        if self.verbose:
            print("Predict begin...")

    def on_predict_batch_end(self, step, logs=None):
        self.pred_step += 1
        if self.verbose and (self.pred_step % self.log_freq == 0 or self.pred_step == self.pred_steps):
            self.pred_progbar.update(self.pred_step, [])

    def on_predict_end(self, logs=None):
        if self.verbose:
            print("Predict samples: %d" % (logs or {}).get("samples", 0))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler. Reference defaults (hapi
    callbacks.LRScheduler): by_step=True, by_epoch=False — step per batch."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_begin(self, epoch=None, logs=None):
        self.epoch = epoch

    def _is_save(self):
        return self.model and self.save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self._is_save() and (self.epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            print(f"save checkpoint at {os.path.abspath(path)}")
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self._is_save():
            path = os.path.join(self.save_dir, "final")
            print(f"save checkpoint at {os.path.abspath(path)}")
            self.model.save(path)


class EarlyStopping(Callback):
    def __init__(
        self,
        monitor="loss",
        mode="auto",
        patience=0,
        verbose=1,
        min_delta=0,
        baseline=None,
        save_best_model=True,
    ):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.min_delta = abs(min_delta)
        self.wait_epoch = 0
        self.best_weights = None
        self.stopped_epoch = 0
        self.save_best_model = save_best_model
        self.save_dir = None
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "min":
            self.monitor_op = np.less
        elif mode == "max":
            self.monitor_op = np.greater
        else:
            self.monitor_op = np.greater if "acc" in self.monitor else np.less
        self.min_delta *= 1 if self.monitor_op == np.greater else -1

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline
        else:
            self.best_value = np.inf if self.monitor_op == np.less else -np.inf

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if isinstance(current, numbers.Number):
            if self.monitor_op(current - self.min_delta, self.best_value):
                self.best_value = current
                self.wait_epoch = 0
                if self.save_best_model and self.save_dir is not None:
                    self.model.save(os.path.join(self.save_dir, "best_model"))
            else:
                self.wait_epoch += 1
            if self.wait_epoch > self.patience:
                self.model.stop_training = True
                if self.verbose > 0:
                    print(f"Epoch {self.stopped_epoch + 1}: Early stopping.")
                    if self.save_best_model and self.save_dir is not None:
                        print("Best checkpoint has been saved.")
        self.stopped_epoch += 1


class ReduceLROnPlateau(Callback):
    def __init__(
        self,
        monitor="loss",
        factor=0.1,
        patience=10,
        verbose=1,
        mode="auto",
        min_delta=1e-4,
        cooldown=0,
        min_lr=0,
    ):
        super().__init__()
        self.monitor = monitor
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau does not support a factor >= 1.0.")
        self.factor = factor
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.patience = patience
        self.verbose = verbose
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.wait = 0
        self.best = 0
        self.mode = mode
        self.epoch = 0
        self._reset()

    def _reset(self):
        if self.mode == "max" or (self.mode == "auto" and "acc" in self.monitor):
            self.monitor_op = lambda a, b: np.greater(a, b + self.min_delta)
            self.best = -np.inf
        else:
            self.monitor_op = lambda a, b: np.less(a, b - self.min_delta)
            self.best = np.inf
        self.cooldown_counter = 0
        self.wait = 0

    def in_cooldown(self):
        return self.cooldown_counter > 0

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if not isinstance(current, numbers.Number):
            return
        if self.in_cooldown():
            self.cooldown_counter -= 1
            self.wait = 0
        if self.monitor_op(current, self.best):
            self.best = current
            self.wait = 0
        elif not self.in_cooldown():
            self.wait += 1
            if self.wait >= self.patience:
                sched = getattr(opt, "_lr_scheduler", None)
                if sched is not None:
                    # an LRScheduler recomputes last_lr every step, which would
                    # undo the reduction — same limitation as the reference
                    # (hapi ReduceLROnPlateau requires a float learning rate)
                    import warnings

                    warnings.warn("ReduceLROnPlateau requires a float learning_rate, not an LRScheduler; skipped.")
                    self.cooldown_counter = self.cooldown
                    self.wait = 0
                    return
                old_lr = opt.get_lr()
                if old_lr > np.float32(self.min_lr):
                    new_lr = max(old_lr * self.factor, self.min_lr)
                    opt.set_lr(new_lr)
                    if self.verbose > 0:
                        print(f"Epoch {self.epoch + 1}: ReduceLROnPlateau reducing learning rate to {new_lr}.")
                self.cooldown_counter = self.cooldown
                self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        self.epoch = epoch


class VisualDL(Callback):
    """Scalar logging callback. The reference logs to VisualDL
    (python/paddle/hapi/callbacks.py VisualDL); visualdl is not a
    dependency, so scalars append to `<log_dir>/scalars.jsonl` in the same
    tag layout."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self.epochs = None
        self.steps = None
        self.epoch = 0

    def _file(self):
        if getattr(self, "_fh", None) is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        return self._fh

    def _write(self, mode, logs, step):
        f = self._file()
        for k in self.params.get("metrics", []):
            if k in (logs or {}):
                v = logs[k]
                if isinstance(v, (list, tuple)):
                    v = v[0] if len(v) else None
                if isinstance(v, numbers.Number):
                    f.write(json.dumps({"tag": f"{mode}/{k}", "step": step, "value": float(v)}) + "\n")

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._train_step = 0

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        self._write("train", logs, self._train_step)

    def on_eval_end(self, logs=None):
        self._write("eval", logs, self.epoch)

    def on_epoch_end(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_end(self, logs=None):
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None


class WandbCallback(Callback):
    """Raises, as the JAX package's does: wandb is not a dependency."""

    def __init__(self, *args, **kwargs):
        raise RuntimeError("wandb is not available; use VisualDL (jsonl) instead")
