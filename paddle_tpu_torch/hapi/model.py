"""High-level Keras-like training API (counterpart of
paddle_tpu/hapi/model.py).

Reference parity: python/paddle/hapi/model.py:1052: `Model(network)` with
`.prepare(optimizer, loss, metrics)`, `.fit/.evaluate/.predict`,
`train_batch/eval_batch/predict_batch`, `.save/.load`, `.summary`. The
reference dispatches to a DynamicGraphAdapter/StaticGraphAdapter pair; here
there is one eager path, as in the JAX package. `train_batch` and
`eval_batch` read every loss to the host (a float each), which is the
reference's semantics: each step waits for the card there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import device as _device
from ..io import DataLoader, Dataset
from ..metric import Metric
from . import callbacks as cbks_mod
from .callbacks import config_callbacks
from .model_summary import summary as summary_fn


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _to_tensor_list(batch):
    out = []
    for b in _to_list(batch):
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.array(b, order="C")).to(_device.current_device())
        out.append(b)
    return out


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._scaler = None
        self._amp_level = None
        self.stop_training = False

    # ---- preparation ----
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("'loss' must be callable (a Layer or function)")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m} is not a paddle.metric.Metric")
        self._amp_level = None
        if amp_configs:
            if isinstance(amp_configs, str):
                amp_configs = {"level": amp_configs}
            self._amp_level = amp_configs.get("level", "O1")
            from ..amp import GradScaler

            if amp_configs.get("use_loss_scaling", False):
                self._scaler = GradScaler()
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    # ---- single-batch APIs ----
    def _run_forward(self, inputs):
        if self._amp_level:
            from ..amp import auto_cast

            with auto_cast(level=self._amp_level):
                return _to_list(self.network(*inputs))
        return _to_list(self.network(*inputs))

    def _compute_loss(self, outputs, labels):
        lv = self._loss(*(outputs + labels))
        losses = _to_list(lv)
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        return total, losses

    def train_batch(self, inputs, labels=None, update=True, loss_scale=1.0):
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before train_batch")
        self.network.train()
        inputs = _to_tensor_list(inputs)
        labels = _to_tensor_list(labels)
        outputs = self._run_forward(inputs)
        total, losses = self._compute_loss(outputs, labels)
        if loss_scale != 1.0:
            total = total * loss_scale
        if self._scaler is not None:
            self._scaler.scale(total).backward()
            if update:
                self._scaler.step(self._optimizer)
                self._scaler.update()
                self._optimizer.clear_grad()
        else:
            total.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        loss_vals = [float(v.item()) for v in losses]
        if metrics:
            return loss_vals, metrics
        return loss_vals

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = _to_tensor_list(inputs)
        labels = _to_tensor_list(labels)
        outputs = self._run_forward(inputs)
        loss_vals = []
        if self._loss is not None and labels:
            _, losses = self._compute_loss(outputs, labels)
            loss_vals = [float(v.item()) for v in losses]
        metrics = self._update_metrics(outputs, labels)
        if metrics:
            return loss_vals, metrics
        return loss_vals

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = _to_tensor_list(inputs)
        outputs = self._run_forward(inputs)
        return [o.numpy() for o in outputs]

    def _split_batch(self, batch, for_predict=False):
        """Split a loader batch into (inputs, labels): declared specs first,
        then the single-input-plus-label convention when a loss is prepared
        (multi-input nets must declare inputs=, as in the reference).
        predict() only applies the loss fallback to 2-element batches — a
        longer undeclared batch is assumed to be all inputs there, while
        train/eval always need a label to feed the loss."""
        if self._inputs:
            ni = len(self._inputs)
        elif self._labels:
            ni = len(batch) - len(self._labels)
        elif self._loss is not None and (len(batch) == 2 if for_predict else len(batch) > 1):
            ni = len(batch) - 1
        else:
            ni = len(batch)
        return batch[:ni], batch[ni:]

    def _update_metrics(self, outputs, labels):
        metric_vals = []
        for m in self._metrics:
            if hasattr(m, "compute"):
                res = m.compute(*(outputs + labels))
                v = m.update(*_to_list(res))
            else:
                v = m.update(*(outputs + labels))
            metric_vals.append(v)
        return metric_vals

    # ---- loops ----
    def _make_loader(self, data, batch_size, shuffle, num_workers, drop_last=False):
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(
                data, batch_size=batch_size, shuffle=shuffle, num_workers=num_workers, drop_last=drop_last
            )
        return data  # any iterable of batches

    def fit(
        self,
        train_data=None,
        eval_data=None,
        batch_size=1,
        epochs=1,
        eval_freq=1,
        log_freq=10,
        save_dir=None,
        save_freq=1,
        verbose=2,
        drop_last=False,
        shuffle=True,
        num_workers=0,
        callbacks=None,
        accumulate_grad_batches=1,
        num_iters=None,
    ):
        assert train_data is not None, "train_data must be given!"
        train_loader = self._make_loader(train_data, batch_size, shuffle, num_workers, drop_last)
        eval_loader = self._make_loader(eval_data, batch_size, False, num_workers)
        steps = self._len_data_loader(train_loader)
        if num_iters is not None:
            steps = min(num_iters, steps) if steps else num_iters
        metric_names = self._metrics_name()
        cbks = config_callbacks(
            callbacks,
            model=self,
            epochs=epochs,
            steps=steps,
            log_freq=log_freq,
            save_freq=save_freq,
            save_dir=save_dir,
            verbose=verbose,
            metrics=metric_names,
        )
        # EarlyStopping saves the best model into save_dir
        for cbk in cbks:
            if isinstance(cbk, cbks_mod.EarlyStopping):
                cbk.save_dir = save_dir
        self.stop_training = False
        cbks.on_train_begin()
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            logs = self._run_one_epoch(train_loader, cbks, "train", accumulate_grad_batches, num_iters=steps)
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and epoch % eval_freq == 0:
                eval_steps = self._len_data_loader(eval_loader)
                cbks.on_eval_begin({"steps": eval_steps, "metrics": metric_names})
                eval_logs = self._run_one_epoch(eval_loader, cbks, "eval")
                cbks.on_eval_end(eval_logs)
        cbks.on_train_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2, num_workers=0, callbacks=None, num_iters=None):
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        steps = self._len_data_loader(loader)
        if num_iters is not None:
            steps = min(num_iters, steps) if steps else num_iters
        metric_names = self._metrics_name()
        cbks = config_callbacks(
            callbacks, model=self, log_freq=log_freq, verbose=verbose, metrics=metric_names, mode="eval"
        )
        cbks.on_eval_begin({"steps": steps, "metrics": metric_names})
        logs = self._run_one_epoch(loader, cbks, "eval", num_iters=steps)
        cbks.on_eval_end(logs)
        result = {}
        for k in metric_names:
            if k in logs:
                result[k] = logs[k]
        return result

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        steps = self._len_data_loader(loader)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose, metrics=[], mode="predict")
        cbks.on_predict_begin({"steps": steps})
        outputs = []
        count = 0
        for step, batch in enumerate(loader):
            batch, _ = self._split_batch(_to_list(batch), for_predict=True)
            cbks.on_predict_batch_begin(step)
            out = self.predict_batch(batch)
            outputs.append(out)
            n = out[0].shape[0] if out and hasattr(out[0], "shape") and out[0].ndim else 1
            count += n
            cbks.on_predict_batch_end(step, {"batch_size": n})
        # regroup: list over batches of list over outputs -> list over outputs
        outputs = [list(o) for o in zip(*outputs)] if outputs else []
        if stack_outputs:
            outputs = [np.concatenate(o, axis=0) for o in outputs]
        cbks.on_predict_end({"samples": count})
        return outputs

    def _run_one_epoch(self, data_loader, callbacks, mode, accumulate_grad_batches=1, num_iters=None):
        for m in self._metrics:
            m.reset()
        logs = {}
        count = 0
        pending_update = False
        for step, batch in enumerate(data_loader):
            if num_iters is not None and step >= num_iters:
                break
            inputs, labels = self._split_batch(_to_list(batch))
            bs = inputs[0].shape[0] if inputs and len(getattr(inputs[0], "shape", ())) else 1
            callbacks._call(f"on_{mode}_batch_begin", step)
            if mode == "train":
                update = (step + 1) % accumulate_grad_batches == 0
                outs = self.train_batch(
                    inputs, labels, update=update, loss_scale=1.0 / accumulate_grad_batches
                )
                pending_update = not update
            else:
                outs = self.eval_batch(inputs, labels)
            if isinstance(outs, tuple):
                losses, metrics = outs
            else:
                losses, metrics = outs, []
            logs["step"] = step
            logs["batch_size"] = bs
            count += bs
            if losses:
                logs["loss"] = losses[0] if len(losses) == 1 else losses
            for m, v in zip(self._metrics, metrics):
                if v is None:
                    continue  # metrics like Precision only report via accumulate()
                names = m.name() if isinstance(m.name(), list) else [m.name()]
                vals = v if isinstance(v, (list, np.ndarray)) else [v]
                for n, val in zip(names, list(np.ravel(np.asarray(vals, dtype=object)))):
                    logs[n] = float(val)
            callbacks._call(f"on_{mode}_batch_end", step, dict(logs))
        if pending_update:
            # flush gradients accumulated past the last full accumulation window
            if self._scaler is not None:
                self._scaler.step(self._optimizer)
                self._scaler.update()
            else:
                self._optimizer.step()
            self._optimizer.clear_grad()
        logs["samples"] = count
        # final accumulated metrics
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            acc = m.accumulate()
            vals = acc if isinstance(acc, (list, np.ndarray)) else [acc]
            for n, val in zip(names, list(np.ravel(np.asarray(vals, dtype=object)))):
                logs[n] = float(val)
        return logs

    def _metrics_name(self):
        names = ["loss"] if self._loss is not None else []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    @staticmethod
    def _len_data_loader(data_loader):
        try:
            return len(data_loader)
        except Exception:
            return None

    # ---- persistence ----
    def save(self, path, training=True):
        from ..framework import io as fio

        if training:
            fio.save(self.network.state_dict(), path + ".pdparams")
            if self._optimizer is not None:
                fio.save(self._optimizer.state_dict(), path + ".pdopt")
        else:
            # inference export: the forward as a torch.export artifact (jit.save)
            from ..jit import save as jit_save

            jit_save(self.network, path, input_spec=self._inputs or None)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework import io as fio
        import os

        state = fio.load(path + ".pdparams")
        if skip_mismatch:
            own = self.network.state_dict()
            state = {
                k: v for k, v in state.items() if k in own and tuple(own[k].shape) == tuple(v.shape)
            }
        self.network.set_state_dict(state)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and os.path.exists(opt_path):
            self._optimizer.set_state_dict(fio.load(opt_path))

    def summary(self, input_size=None, dtype=None):
        _input_size = input_size or [tuple(s.shape) for s in self._inputs] or None
        if _input_size is None:
            raise ValueError("input_size must be given (no InputSpec was declared)")
        return summary_fn(self.network, _input_size, dtypes=dtype)
