"""DeepSpeedEngine, single-device training (counterpart of
``deepspeed_tpu/runtime/engine.py``; the train path of
``_build_train_step`` / ``_apply_grads`` / ``train_batch`` and the micro
API ``forward`` / ``backward`` / ``step``).

One step: for each of ``gradient_accumulation_steps`` micro-batches, the
loss on the params cast to the compute dtype, scaled by 1/gas, and its
gradients from autograd, cast to the gradient-accumulation dtype and
summed in it; then the global grad norm (fp32, before clipping), the
optimizer update (optional ``clip_by_global_norm`` in front) and
``p + u`` cast to ``p``'s dtype.  The JAX engine returns new immutable
state; this one updates the params in place (no second copy of the
model) and replaces the optimizer state.

Precision, as the reference's: bf16.enabled computes in bf16 and
otherwise in fp32; ``bf16.master_weights_dtype="bfloat16"`` stores the
params in bf16 with Kahan compensation in the optimizer (else fp32
masters); ``bf16.optimizer_states_dtype`` stores the Adam moments;
``data_types.grad_accum_dtype`` ("fp32" | "bf16") the gradients.

Not here (ROADMAP.md queue A): fp16 loss scaling, offload, any mesh
larger than one device, checkpoints, telemetry spans.
"""
import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.runtime.bf16_optimizer import resolve_dtype
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                     RepeatingLoader)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.optimizers import (build_optimizer, chain,
                                                     clip_by_global_norm)
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in tree_leaves(tree)))


class DeepSpeedEngine:
    def __init__(self, config, model, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, collate_fn=None,
                 device=None):
        """``config``: a dict, a JSON path or a :class:`DeepSpeedConfig`.
        ``model_parameters``: a params tree of numpy arrays or tensors;
        None draws the model's seeded host init (seed = config ``seed``).
        ``optimizer``: an object with the optax-shaped ``init`` /
        ``update`` of :class:`GradientTransformation`, in place of the
        config's ``optimizer`` section.  ``device=None`` is the GPU."""
        self._config = (config if isinstance(config, DeepSpeedConfig)
                        else DeepSpeedConfig(config))
        cfg = self._config
        self.device = resolve_device(device)
        self.model = model

        # ---- precision (the reference's rules and messages) -----------
        self.compute_dtype = (torch.bfloat16 if cfg.bf16.enabled
                              else torch.float32)
        master_dt = resolve_dtype(cfg.bf16.master_weights_dtype)
        self._bf16_master = cfg.bf16.enabled and master_dt == torch.bfloat16
        if not cfg.bf16.enabled and master_dt != torch.float32:
            raise ValueError(
                "bf16.master_weights_dtype="
                f"{cfg.bf16.master_weights_dtype!r} requires bf16.enabled "
                "(Kahan-compensated bf16 masters pair with bf16 compute; "
                "remove the key or enable bf16)")
        self._opt_states_dtype = cfg.bf16.optimizer_states_dtype
        if self._opt_states_dtype is not None and not cfg.bf16.enabled:
            raise ValueError(
                "bf16.optimizer_states_dtype="
                f"{self._opt_states_dtype!r} requires bf16.enabled "
                "(the reduced-precision optimizer states pair with bf16 "
                "compute; remove the key or enable bf16)")
        gad = cfg.data_types_config.grad_accum_dtype
        if gad in (None, "fp32", "float32"):
            self.grad_dtype = torch.float32
        elif gad in ("bf16", "bfloat16"):
            if not cfg.bf16.enabled:
                raise ValueError(
                    f"data_types.grad_accum_dtype={gad!r} requires "
                    "bf16.enabled: bf16 gradient accumulation exists to "
                    "halve the bf16 path's gradient-buffer bytes; under "
                    "fp32/fp16 it would silently degrade accumulation")
            self.grad_dtype = torch.bfloat16
        else:
            raise ValueError(
                f"data_types.grad_accum_dtype={gad!r}: supported values "
                "are 'fp32' and 'bf16' (fp16 accumulation is not offered "
                "— the fp16 path accumulates into fp32 masters, as the "
                "reference's default does)")

        # ---- parameters: compute dtype under bf16 masters, else fp32 ---
        storage_dtype = (self.compute_dtype if self._bf16_master
                         else torch.float32)
        if model_parameters is None:
            params = model.init(cfg.seed, self.device, storage_dtype)
        elif isinstance(tree_leaves(model_parameters)[0], np.ndarray):
            params = model.params_from_numpy_fn(model_parameters,
                                                self.device, storage_dtype)
        else:
            params = tree_map(lambda t: t.detach().to(
                self.device, storage_dtype).clone(), model_parameters)
        for p in tree_leaves(params):
            if not p.is_floating_point():
                raise ValueError(f"DeepSpeedEngine: param leaf of dtype "
                                 f"{p.dtype}; every leaf trains")
            p.requires_grad_(True)
        self.params = params

        # ---- optimizer and schedule ------------------------------------
        self.base_lr = float((cfg.optimizer_params or {}).get("lr", 1e-3))
        self.lr_schedule = None
        if cfg.scheduler_name:
            self.lr_schedule = get_lr_schedule(
                cfg.scheduler_name, cfg.scheduler_params,
                base_lr=self.base_lr)
        elif callable(lr_scheduler):
            self.lr_schedule = lr_scheduler
        if optimizer is not None:
            if self._bf16_master or self._opt_states_dtype:
                # a user transform has no Kahan compensation: bf16 masters
                # without it silently drop sub-ulp updates
                raise ValueError(
                    "bf16.master_weights_dtype/optimizer_states_dtype "
                    "cannot be combined with a user-provided optimizer "
                    "instance; configure an Adam-family optimizer by "
                    "name instead (the engine builds the Kahan-"
                    "compensated transform)")
            if not (callable(getattr(optimizer, "init", None))
                    and callable(getattr(optimizer, "update", None))):
                raise TypeError(
                    "optimizer must have init(params) and update(grads, "
                    "state, params) (runtime/bf16_optimizer.py "
                    "GradientTransformation)")
            inner = optimizer
        else:
            inner = build_optimizer(
                cfg.optimizer_name, cfg.optimizer_params,
                lr_schedule=self.lr_schedule,
                mu_dtype=self._opt_states_dtype,
                nu_dtype=self._opt_states_dtype,
                master_dtype=("bfloat16" if self._bf16_master
                              else "float32"))
        self.optimizer = (chain(clip_by_global_norm(cfg.gradient_clipping),
                                inner)
                          if cfg.gradient_clipping > 0 else inner)
        with torch.no_grad():
            self.opt_state = self.optimizer.init(self.params)

        # ---- bookkeeping -----------------------------------------------
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.last_metrics = {}
        self._micro_grads = None      # forward/backward/step accumulator
        self._pending_grads = None    # computed by forward(), banked by
        self._last_loss = None        # backward()
        self._data_iterator = None    # repeating iterator over the loader
        self._client_iter_src = None  # iterable given to train_batch
        self._client_iter = None
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data,
                batch_size=self.train_micro_batch_size_per_gpu(),
                collate_fn=collate_fn)
        logger.info(
            f"DeepSpeedEngine: device {self.device}, ZeRO stage "
            f"{cfg.zero_config.stage} (one device), compute "
            f"{self.compute_dtype}, params {storage_dtype}, grads "
            f"{self.grad_dtype}, batch {self.train_batch_size()} = "
            f"{self.train_micro_batch_size_per_gpu()}x"
            f"{self.gradient_accumulation_steps()}")

    # ------------------------------------------------------------ config api
    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self._config.zero_config.stage

    def get_lr(self):
        if self.lr_schedule is not None:
            return [float(self.lr_schedule(self.global_steps))]
        return [self.base_lr]

    @property
    def lr_scheduler(self):
        return self.lr_schedule

    @property
    def config(self) -> DeepSpeedConfig:
        return self._config

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) \
            % self.gradient_accumulation_steps() == 0

    def get_global_grad_norm(self):
        gn = self.last_metrics.get("grad_norm")
        return float(gn) if gn is not None else None

    def module_state_dict(self):
        return self.params

    # ------------------------------------------------------------ the step
    def _to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _loss_and_grads(self, batch):
        """Loss (scaled by 1/gas) of one micro-batch on the params cast to
        the compute dtype, and its gradients in the grad dtype."""
        cparams = tree_map(lambda p: p.to(self.compute_dtype), self.params)
        loss = self.model.loss(cparams, self._to_device(batch)).float() \
            * (1.0 / self.gradient_accumulation_steps())
        grads = iter(torch.autograd.grad(loss, tree_leaves(self.params)))
        return loss.detach(), tree_map(
            lambda p: next(grads).to(self.grad_dtype), self.params)

    @staticmethod
    def _add(acc, grads):
        """Sum in the grads' dtype (the reference adds to zeros; x + 0 is
        x, so the first micro-batch's gradients are taken as they are)."""
        return grads if acc is None else tree_map(torch.add, acc, grads)

    @torch.no_grad()
    def _apply_grads(self, grads):
        """Global grad norm, optimizer update, ``p + u`` in p's dtype."""
        grad_norm = global_norm(grads)
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        for p, u in zip(tree_leaves(self.params), tree_leaves(updates)):
            p.copy_(p + u)
        return {"grad_norm": grad_norm}

    def _finish_step(self, metrics):
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self.last_metrics = dict(metrics)
        spp = self._config.steps_per_print
        if spp and self.global_steps % spp == 0:
            logger.info(f"step={self.global_steps} "
                        f"loss={float(metrics['loss']):.4f} "
                        f"grad_norm={float(metrics['grad_norm']):.3f}")

    def _micro_batches(self, data_iter, batch):
        gas = self.gradient_accumulation_steps()
        if batch is not None:
            lead = tree_leaves(batch)[0].shape[0]
            if lead != gas:
                raise ValueError(
                    f"train_batch(batch=...) leaves must lead with gas={gas}, "
                    f"got {lead}")
            return [{k: v[i] for k, v in batch.items()} for i in range(gas)]
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs a data iterator or batch")
            # persistent repeating iterator: successive calls advance
            # through the dataset instead of replaying its head
            if self._data_iterator is None:
                self._data_iterator = iter(
                    RepeatingLoader(self.training_dataloader))
            data_iter = self._data_iterator
        if not hasattr(data_iter, "__next__"):
            # an iterable (list, loader): one repeating iterator per object
            if self._client_iter_src is not data_iter:
                self._client_iter_src = data_iter
                self._client_iter = iter(RepeatingLoader(data_iter))
            data_iter = self._client_iter
        return [next(data_iter) for _ in range(gas)]

    def train_batch(self, data_iter=None, batch=None):
        """One training step over ``gradient_accumulation_steps``
        micro-batches, from ``data_iter`` (an iterator or iterable of
        micro-batch dicts), from ``batch`` (a dict whose leaves lead with
        gas) or from ``training_data``.  Returns the mean micro-batch loss
        (a 0-d fp32 tensor on the device; no host sync)."""
        grads, loss_sum = None, None
        for mb in self._micro_batches(data_iter, batch):
            loss, g = self._loss_and_grads(mb)
            grads = self._add(grads, g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        metrics = self._apply_grads(grads)
        metrics["loss"] = loss_sum
        self._finish_step(metrics)
        return loss_sum

    def forward(self, batch):
        """Micro-step API: the loss and the gradients of one micro-batch
        in one autograd pass (as the reference, whose forward runs
        value_and_grad); ``backward`` banks the gradients and ``step``
        applies them at the accumulation boundary."""
        loss, grads = self._loss_and_grads(batch)
        self._pending_grads = self._add(self._micro_grads, grads)
        self._micro_grads = None
        self._last_loss = loss * self.gradient_accumulation_steps()
        return self._last_loss

    def backward(self, loss=None):
        """Bank the gradients computed by the paired ``forward``."""
        if self._pending_grads is None:
            raise RuntimeError("backward() called without a prior forward()")
        self._micro_grads = self._pending_grads
        self._pending_grads = None
        return self._last_loss

    def step(self):
        """Apply the update at the gradient-accumulation boundary."""
        at_boundary = self.is_gradient_accumulation_boundary()
        self.micro_steps += 1
        if not at_boundary:
            return
        if self._micro_grads is None:
            raise RuntimeError("step() called without accumulated gradients")
        metrics = self._apply_grads(self._micro_grads)
        metrics["loss"] = self._last_loss
        self._micro_grads = None
        self._finish_step(metrics)

    @torch.no_grad()
    def eval_batch(self, batch):
        """The loss of one batch (fp32, no gradients)."""
        cparams = tree_map(lambda p: p.to(self.compute_dtype), self.params)
        return self.model.loss(cparams, self._to_device(batch)).float()
