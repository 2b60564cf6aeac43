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

Precision, as the reference's: fp16.enabled computes in fp16 under a
loss scale, bf16.enabled in bf16, otherwise fp32;
``bf16.master_weights_dtype="bfloat16"`` stores the params in bf16 with
Kahan compensation in the optimizer (else fp32 masters);
``bf16.optimizer_states_dtype`` stores the Adam moments;
``data_types.grad_accum_dtype`` ("fp32" | "bf16") the gradients.  Under
fp16 the masters and moments stay fp32; each micro-batch's loss is
multiplied by the scale before autograd, the summed gradients are
divided by it in fp32, and a step whose gradients hold a NaN or an inf
applies no update, reports a grad norm of 0, counts in
``skipped_steps`` and lets the scaler shrink the scale (the reference's
``_apply_grads``).  The scaler's state stays on the device; the one host
read a step is the overflow flag, which decides whether the optimizer
runs at all (the reference selects between old and new state instead,
which on the GPU would read and write the state twice).

Checkpoints (``save_checkpoint`` / ``load_checkpoint``) follow the
reference's crash-safe protocol (``resilience/ckpt.py``) and write the
JAX package's ``NpzCheckpointEngine`` layout: ``<tag>/state.npz`` holds
``params``, ``opt_state``, ``step`` and ``scaler`` under the JAX key
strings of the same configuration (:meth:`DeepSpeedEngine.state_leaves`),
``<tag>/ds_metadata.json`` the step counters, ``skipped_steps`` and the
client state.  The data a step reads is not part of it: as in the
reference, the caller feeds the batches after the saved step again (the
engine's repeating loader starts from the dataset's head).

Not here (ROADMAP.md queue A): offload, any mesh larger than one device,
telemetry spans.
"""
import json
import os
import shutil
import time
import zipfile

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.resilience import ckpt as rckpt
from deepspeed_tpu_torch.resilience.retry import retry_call
from deepspeed_tpu_torch.runtime.bf16_optimizer import (MPAdamState,
                                                         resolve_dtype)
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (
    AsyncNpzCheckpointEngine, NpzCheckpointEngine, flatten_state, from_host,
    to_host, unflatten_like)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                     RepeatingLoader)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    LossScaleState, create_loss_scaler, has_overflow, update_scale)
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
        self.fp16 = cfg.fp16.enabled
        self.compute_dtype = (torch.float16 if self.fp16
                              else torch.bfloat16 if cfg.bf16.enabled
                              else torch.float32)
        if self.fp16 and self.device.type == "cuda" \
                and getattr(model.config, "num_experts", 0):
            raise NotImplementedError(
                "fp16.enabled with a mixture-of-experts model on the GPU: "
                "the grouped expert kernels have no fp16 form yet "
                "(ROADMAP.md Queue A: fp16 grouped and block-sparse "
                "kernels); train MoE models in bf16")
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
        self._user_optimizer = optimizer is not None
        with torch.no_grad():
            self.opt_state = self.optimizer.init(self.params)

        # ---- loss scaling ----------------------------------------------
        f = cfg.fp16
        self.scaler, self.scaler_config = create_loss_scaler(
            enabled=f.enabled, loss_scale=f.loss_scale,
            initial_scale_power=f.initial_scale_power,
            loss_scale_window=f.loss_scale_window, hysteresis=f.hysteresis,
            min_loss_scale=f.min_loss_scale,
            consecutive_hysteresis=f.consecutive_hysteresis,
            device=self.device)

        # ---- checkpoints -----------------------------------------------
        self.checkpoint_engine = None   # a client may set its own backend
        self._pending_ckpt = None
        #: seconds and bytes of the last save / commit / load
        self.checkpoint_times = {}

        # ---- bookkeeping -----------------------------------------------
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.optimizer_steps = 0      # updates applied (the JAX "step")
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

    @property
    def loss_scale(self) -> float:
        return float(self.scaler.cur_scale)

    def module_state_dict(self):
        return self.params

    # ------------------------------------------------------------ the step
    def _to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _loss_and_grads(self, batch, micro: int = 0):
        """Loss (scaled by 1/gas) of one micro-batch on the params cast to
        the compute dtype, and its gradients in the grad dtype (under fp16
        the gradients of the loss times the loss scale).  A loss that
        draws noise (the MoE noisy gate) gets the key (seed, global step,
        ``micro``)."""
        cparams = tree_map(lambda p: p.to(self.compute_dtype), self.params)
        key = (self._config.seed, self.global_steps, micro)
        loss = self.model.loss(cparams, self._to_device(batch),
                               rng=key).float() \
            * (1.0 / self.gradient_accumulation_steps())
        target = loss * self.scaler.cur_scale if self.fp16 else loss
        grads = iter(torch.autograd.grad(target, tree_leaves(self.params)))
        return loss.detach(), tree_map(
            lambda p: next(grads).to(self.grad_dtype), self.params)

    @staticmethod
    def _add(acc, grads):
        """Sum in the grads' dtype (the reference adds to zeros; x + 0 is
        x, so the first micro-batch's gradients are taken as they are)."""
        return grads if acc is None else tree_map(torch.add, acc, grads)

    @torch.no_grad()
    def _apply_grads(self, grads):
        """Global grad norm, optimizer update, ``p + u`` in p's dtype;
        under fp16 the gradients are unscaled first, and an overflow
        skips the update (grad norm 0) and updates the scale."""
        if self.fp16:
            scale = self.scaler.cur_scale
            grads = tree_map(lambda g: g / scale.to(g.dtype), grads)
        grad_norm = global_norm(grads)
        metrics = {"grad_norm": grad_norm}
        skip = False
        if self.fp16:
            overflow = has_overflow(grads)
            skip = bool(overflow)       # the step's one host read
            self.scaler = update_scale(self.scaler, overflow,
                                       self.scaler_config)
            metrics.update(overflow=overflow,
                           loss_scale=self.scaler.cur_scale)
            if skip:
                metrics["grad_norm"] = torch.zeros_like(grad_norm)
                self.skipped_steps += 1
        if not skip:
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params)
            for p, u in zip(tree_leaves(self.params), tree_leaves(updates)):
                p.copy_(p + u)
            self.optimizer_steps += 1
        return metrics

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
        for i, mb in enumerate(self._micro_batches(data_iter, batch)):
            loss, g = self._loss_and_grads(mb, i)
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
        loss, grads = self._loss_and_grads(
            batch, self.micro_steps % self.gradient_accumulation_steps())
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

    # ------------------------------------------------------------ checkpoints
    def _opt_key_map(self):
        """The JAX key prefix of each part of the optimizer state, for the
        configuration this engine runs (the JAX package's
        ``build_optimizer``): with mixed-precision states one
        ``MPAdamState`` (``.count``, ``.mu``, ``.nu``, ``.comp``; with fp32
        masters ``.comp`` holds one 0-d fp32 placeholder a param), else
        optax's chain ``scale_by_adam`` [0], ``add_decayed_weights`` [1]
        (adamw only, no leaves), the learning rate, whose count is stored
        when it follows a schedule; a clipping chain puts all of it under
        [1].  Returns (base, mp, schedule key or None)."""
        cfg = self._config
        base = "opt_state/" + ("[1]/" if cfg.gradient_clipping > 0 else "")
        opt = cfg.optimizer_params or {}
        mp = bool(self._opt_states_dtype or self._bf16_master)
        if mp:
            return base, True, None
        name = (cfg.optimizer_name or "adam").lower()
        wd = float(opt.get("weight_decay", 0.0))
        adamw = name == "adamw" or (opt.get("adam_w_mode", True) and wd > 0)
        sched = (f"{base}[{2 if adamw else 1}]/.count"
                 if self.lr_schedule is not None else None)
        return base, False, sched

    def state_leaves(self) -> dict:
        """The training state as the JAX engine's ``NpzCheckpointEngine``
        stores it for the same configuration: ``{key: leaf}`` with the JAX
        key strings (tensors on the device, Python ints for counts)."""
        if self._user_optimizer:
            raise NotImplementedError(
                "save_checkpoint / load_checkpoint with a user-provided "
                "optimizer instance: its state has no layout in the JAX "
                "package's checkpoints; configure the optimizer by name")
        inner = self.opt_state[1] if self._config.gradient_clipping > 0 \
            else self.opt_state
        base, mp, sched = self._opt_key_map()
        out = dict(flatten_state(self.params, "params"))
        if mp:
            comp = inner.comp if inner.comp is not None else tree_map(
                lambda p: torch.zeros((), dtype=torch.float32,
                                      device=p.device), self.params)
            st = MPAdamState(inner.count, inner.mu, inner.nu, comp)
            out.update(flatten_state(st, base.rstrip("/")))
        else:
            out[f"{base}[0]/.count"] = inner.count
            out.update(flatten_state(inner.mu, f"{base}[0]/.mu"))
            out.update(flatten_state(inner.nu, f"{base}[0]/.nu"))
            if sched is not None:
                out[sched] = inner.count
        out["step"] = self.optimizer_steps
        out.update(flatten_state(self.scaler, "scaler"))
        return out

    def _load_leaves(self, data: dict, load_optimizer_states: bool):
        """Put a checkpoint's leaves (host arrays by JAX key) into this
        engine: params in place, the optimizer state (when asked), the
        optimizer step count and the scaler."""
        like = self.state_leaves()
        with torch.no_grad():
            for key, p in flatten_state(self.params, "params"):
                p.copy_(from_host(data[key], p))
        if load_optimizer_states:
            clip = self._config.gradient_clipping > 0
            inner = self.opt_state[1] if clip else self.opt_state
            base, mp, _ = self._opt_key_map()
            if mp:
                tmpl = inner
                pre = base.rstrip("/")
            else:
                tmpl = MPAdamState(inner.count, inner.mu, inner.nu, None)
                pre = base + "[0]"
            vals = {k: from_host(data[k], like[k])
                    for k, _ in flatten_state(tmpl, pre)}
            new = unflatten_like(tmpl, vals, pre)
            if not mp:
                new = MPAdamState(new.count, new.mu, new.nu, None)
            self.opt_state = (self.opt_state[0], new) if clip else new
        self.optimizer_steps = int(data["step"])
        self.scaler = LossScaleState(*(
            from_host(data[k], v)
            for k, v in flatten_state(self.scaler, "scaler")))

    def _get_checkpoint_engine(self):
        """A client-set ``engine.checkpoint_engine`` wins; else
        ``checkpoint.async_save`` picks the async npz engine, else the
        synchronous one."""
        if self.checkpoint_engine is None:
            self.checkpoint_engine = (
                AsyncNpzCheckpointEngine()
                if self._config.checkpoint_config.async_save
                else NpzCheckpointEngine())
        return self.checkpoint_engine

    def _ckpt_retry(self, fn, *args, describe="", **kwargs):
        """Checkpoint I/O through the retry policy (resilience.retry)."""
        r = self._config.resilience_config.retry
        return retry_call(fn, *args, attempts=r.attempts,
                          base_delay_s=r.base_delay_s,
                          max_delay_s=r.max_delay_s, deadline_s=r.deadline_s,
                          describe=describe, **kwargs)

    def wait_pending_checkpoint(self):
        """Block until an in-flight async save is durable, then publish it
        (manifest, atomic tag rename, ``latest``, retention).  No-op
        without one; called before the next save or load, so at most one
        save overlaps training."""
        if self._pending_ckpt is None:
            return
        tag, summary, finalize = self._pending_ckpt
        self._pending_ckpt = None
        t0 = time.perf_counter()
        summary.join()
        self._get_checkpoint_engine().commit(tag)
        ckpt_dir = finalize()
        self.checkpoint_times["commit_s"] = time.perf_counter() - t0
        logger.info(f"committed checkpoint {ckpt_dir}")

    def _check_tag(self, tag: str):
        """``checkpoint.tag_validation``: with one process no other rank's
        tag can differ; a tag that is not one directory name is refused
        ("Fail") or warned about ("Warn")."""
        mode = str(self._config.checkpoint_config.tag_validation).lower()
        if mode == "ignore" or (tag and os.sep not in tag
                                and tag not in (".", "..")):
            return
        msg = f"checkpoint tag {tag!r} is not a single directory name"
        if mode == "fail":
            raise ValueError(msg)
        logger.warning(msg)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Crash-safe save (resilience/ckpt.py): everything is staged
        under ``<tag>.tmp`` and published by one rename after the fsynced
        manifest lands.  With ``checkpoint.async_save`` the state is
        copied to the host before this returns and written, checksummed
        and published in the background (``wait_pending_checkpoint``)."""
        import threading
        self.wait_pending_checkpoint()
        ckpt_engine = self._get_checkpoint_engine()
        rcfg = self._config.resilience_config
        step = self.global_steps
        tag = str(tag or f"global_step{step}")
        self._check_tag(tag)
        ckpt_dir = os.path.join(save_dir, tag)
        tmp_dir = ckpt_dir + rckpt.TMP_SUFFIX
        t0 = time.perf_counter()
        extra = {"global_steps": step,
                 "global_samples": self.global_samples,
                 "skipped_steps": self.skipped_steps,
                 "micro_steps": self.micro_steps,
                 "client_state": client_state or {},
                 "config": self._config._param_dict}
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir)       # staging left by a crashed save
        os.makedirs(tmp_dir, exist_ok=True)
        # the host snapshot the writer owns: training may change the
        # params in place as soon as this returns
        snap = {k: to_host(v) for k, v in self.state_leaves().items()}
        is_async = getattr(ckpt_engine, "is_async", False)
        leaves = {}

        def summarize():
            leaves.update(rckpt.leaf_summary(
                snap, checksums=rcfg.checkpoint_checksums))
        summary = threading.Thread(target=summarize, name="ds-ckpt-crc32")
        ckpt_engine.create(tag)
        self._ckpt_retry(ckpt_engine.save, snap,
                         os.path.join(tmp_dir, rckpt.STATE_DIR),
                         describe=f"checkpoint save {tag}")
        summary.start()
        with open(os.path.join(tmp_dir, rckpt.METADATA_FILE), "w") as f:
            json.dump(extra, f, indent=2, default=str)
        self.checkpoint_times = {
            "save_s": time.perf_counter() - t0,
            "bytes": int(sum(a.nbytes for a in snap.values()))}

        def finalize():
            """manifest (the last staged write) -> tag rename ->
            ``latest`` -> retention; a failure before the rename leaves
            only the .tmp staging dir."""
            rckpt.write_manifest(tmp_dir, step, tag, leaves)
            if os.path.isdir(ckpt_dir):
                # the old tag moves aside under a name that still
                # verifies, so a crash between the renames keeps it
                stale = ckpt_dir + ".prev"
                if os.path.isdir(stale):
                    shutil.rmtree(stale)
                os.replace(ckpt_dir, stale)
            os.replace(tmp_dir, ckpt_dir)
            shutil.rmtree(ckpt_dir + ".prev", ignore_errors=True)
            try:
                rckpt.fsync_path(save_dir)
            except OSError:
                pass
            if save_latest:
                self._ckpt_retry(rckpt.publish_latest, save_dir, tag,
                                 describe="latest pointer")
            if rcfg.keep_last_k:
                rckpt.gc_tags(save_dir, rcfg.keep_last_k, protect=(tag,))
            return ckpt_dir

        if is_async:
            self._pending_ckpt = (tag, summary, finalize)
            if not getattr(self, "_ckpt_atexit", False):
                # the last save of a run still publishes at exit
                import atexit
                import weakref
                ref = weakref.ref(self)
                atexit.register(
                    lambda: ref() and ref().wait_pending_checkpoint())
                self._ckpt_atexit = True
            logger.info(f"async checkpoint {ckpt_dir} in flight")
            return True
        self._pending_ckpt = (tag, summary, finalize)
        self.wait_pending_checkpoint()
        self.checkpoint_times["save_s"] = time.perf_counter() - t0
        return True

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a tag (``None``: the newest valid one, or ``latest``
        with ``resilience.verify_checkpoint="off"``); returns
        ``(path, client_state)``, or ``(None, {})`` when the root holds
        no tag.  A requested tag that fails verification raises
        :class:`CheckpointCorruptError`.  ``load_module_only`` or
        ``load_optimizer_states=False`` keep this engine's optimizer
        state (the schedule reads the optimizer's count, so
        ``load_lr_scheduler_states`` follows it); the step counters and
        the loss scale are restored either way, as in the reference."""
        self.wait_pending_checkpoint()
        ckpt_engine = self._get_checkpoint_engine()
        verify = self._config.resilience_config.verify_checkpoint
        if tag is None:
            tag = (rckpt.read_latest(load_dir) if verify == "off"
                   else rckpt.find_valid_tag(load_dir))
            if tag is None:
                logger.info(f"no restorable checkpoint in {load_dir}")
                return None, {}
        elif verify != "off":
            ok, reason = rckpt.verify_tag(os.path.join(load_dir, str(tag)))
            if not ok:
                raise rckpt.CheckpointCorruptError(
                    f"requested tag {tag!r} in {load_dir} failed "
                    f"verification: {reason}")
        ckpt_dir = os.path.join(load_dir, str(tag))
        t0 = time.perf_counter()
        try:
            data = self._ckpt_retry(
                ckpt_engine.load, os.path.join(ckpt_dir, rckpt.STATE_DIR),
                template=self.state_leaves(),
                describe=f"checkpoint load {tag}")
        except (zipfile.BadZipFile, ValueError, EOFError) as e:
            raise rckpt.CheckpointCorruptError(
                f"tag {tag!r} in {load_dir}: unreadable state ({e})") from e
        if verify == "full":
            bad = rckpt.verify_restored(data, rckpt.read_manifest(ckpt_dir))
            if bad:
                raise rckpt.CheckpointCorruptError(
                    f"tag {tag!r} failed checksum verification: {bad[:5]}")
        self._load_leaves(data, load_optimizer_states
                          and not load_module_only)
        extra = {}
        meta = os.path.join(ckpt_dir, rckpt.METADATA_FILE)
        if os.path.exists(meta):
            with open(meta) as f:
                extra = json.load(f)
        self.global_steps = extra.get("global_steps", 0)
        self.global_samples = extra.get("global_samples", 0)
        self.skipped_steps = extra.get("skipped_steps", 0)
        self.micro_steps = extra.get("micro_steps", 0)
        self.checkpoint_times["load_s"] = time.perf_counter() - t0
        logger.info(f"loaded checkpoint {ckpt_dir}")
        return ckpt_dir, extra.get("client_state", {})
