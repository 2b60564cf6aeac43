"""Iteration-level continuous-batching scheduler over a paged KV pool
(counterpart of ``deepspeed_tpu/serving/scheduler.py``, core path).

Each ``step()`` is one engine iteration:

1. expire queued requests past their timeout (graceful 429, never a crash);
2. admit queued prefills — highest SLO class, then priority, first — up
   to the ``max_num_batched_tokens`` budget and the free-slot/free-block
   supply; each admission runs the one-shot prefill (prompts bucketed to
   16 tokens) and samples the first token;
3. grow each active row's block table for the token it is about to write
   (allocate-on-decode); under pool exhaustion the lowest-priority active
   request is preempted (blocks freed, request requeued; it resumes later
   by recomputing prompt+generated);
4. run a k-step decode window over the packed active set: per step the
   position-flat pool ``[L, num_blocks*block_size, KV, hd]`` is gathered
   into the dense ``[L, B, S_pad, KV, hd]`` view the model's decode step
   expects, the one new K/V vector per row scatters back, and the next
   token is sampled on the device.  Tokens stay on the device for the
   whole window; the host reads them once at its end.  Finished rows
   retire immediately and their blocks recycle.

The pool holds K/V in the compute dtype, or (``kv_cache_dtype="int8"``)
int8 codes plus one fp32 scale per cached head vector, gathered and
scattered alongside.  ``serving.fused_decode`` runs each decode step
through the fused per-layer kernel instead of the unfused composition
(a family whose spec the kernel does not cover raises).  A mixture-of-
experts model serves its experts through the grouped dispatch
(``serving.moe_dispatch`` "auto" or "grouped"; "einsum" raises).

The decode batch is always ``max_num_seqs`` rows wide and ``S_pad`` long
— padding rows point at the reserved trash block and are ignored — so a
row's arithmetic does not depend on which other requests share the batch.

Greedy decoding follows the static ``InferenceEngine.generate`` path:
both prefill at this scheduler's 16-token bucket (``PROMPT_BUCKET``) and
decode through the same kernels.  What the card holds (``chip_smoke.py``
phases 12, 15 and 18): with a float KV cache the tokens are identical,
preemption included; with an int8 cache they are identical for every
request that was not preempted, at a decode batch of up to 8 rows.  A
resumed request re-prefills its generated tail, so those K/V come from
the prefill's GEMMs instead of the decode's, and a wider batch takes
qgemm's tile path and the group-padded expert kernel, which sum in
another order than the one-row generate: an int8 cache can turn such a
last-bit difference into a whole code step, and the tokens then part.
Sampled requests draw from a ``torch.Generator`` seeded from (seed,
absolute position): the draw is deterministic per (seed, position) and
stable across preemption, but it does not reproduce JAX's ``fold_in``
bits.
"""
import collections
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.sampling import (gumbel_noise,
                                                    process_sampling_logits)
from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention
from deepspeed_tpu_torch.ops.kernels.ds_flash_attention import \
    flash_attention_fwd
from deepspeed_tpu_torch.models.serving import fused_decode_active
from deepspeed_tpu_torch.moe.layer import resolve_dispatch_mode
from deepspeed_tpu_torch.ops.kernels.fused_decode import ds_fused_layer
from deepspeed_tpu_torch.ops.kernels.grouped_gemm import (ds_ggemm,
                                                          ds_ggemm_slots)
from deepspeed_tpu_torch.ops.kernels.qgemm import qgemm
from deepspeed_tpu_torch.ops.kernels.quantization import block_quantize_int8
from deepspeed_tpu_torch.runtime.config import refuse_unported
from deepspeed_tpu_torch.serving.block_manager import BlockManager
from deepspeed_tpu_torch.serving.request import (QueueFullError,
                                                 RequestState,
                                                 RequestTooLongError,
                                                 SamplingParams,
                                                 ServeRequest)
from deepspeed_tpu_torch.utils.logging import logger


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: every output bit depends on every input bit
    (the CPU generator keeps only the low 32 bits of its seed)."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


def position_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator for the token at absolute ``position`` of a request
    sampled with ``seed``: one Philox (CUDA) / mt19937 (CPU) stream per
    (seed, position) pair, so a resumed request redraws exactly."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix64(((int(seed) & 0x7FFFFFFF) << 32)
                         | (int(position) & 0xFFFFFFFF)))
    return g


def sample_rows(logits, seeds, positions, temps, top_ks, top_ps, do_flags):
    """Per-row sampling: greedy rows take the argmax; sampled rows take
    ``argmax(processed logits + Gumbel noise)`` with the noise drawn from
    :func:`position_generator`.  ``logits`` [B, V] on the device; the
    other arguments are host numpy arrays [B].  Returns int32 [B] on the
    device without synchronising."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not do_flags.any():
        return greedy
    dev = logits.device
    x = process_sampling_logits(
        logits, torch.as_tensor(temps, device=dev),
        torch.as_tensor(top_ks, device=dev),
        torch.as_tensor(top_ps, device=dev))
    noise = torch.zeros_like(x)
    for b in np.flatnonzero(do_flags):
        noise[b] = gumbel_noise(
            (x.shape[-1],), position_generator(seeds[b], positions[b], dev),
            dev)
    sampled = torch.argmax(x + noise, dim=-1).to(torch.int32)
    return torch.where(torch.as_tensor(do_flags, device=dev), sampled,
                       greedy)


class ServingMetrics:
    """Counters, gauges and recent-latency windows, rendered as a flat
    snapshot dict and as Prometheus text for ``/metrics``."""

    _WINDOW = 4096
    _QUANTILES = ((50, "p50"), (90, "p90"), (99, "p99"))

    def __init__(self):
        self.counters = collections.Counter()
        self.gauges: Dict[str, float] = {}
        self.ttft_s = collections.deque(maxlen=self._WINDOW)
        self.latency_s = collections.deque(maxlen=self._WINDOW)
        self.queue_wait_s = collections.deque(maxlen=self._WINDOW)
        #: (prefill tokens, bucket, seconds) per one-shot prefill
        self.prefill_s = collections.deque(maxlen=self._WINDOW)
        #: (window steps k, active rows, seconds) per decode window
        self.decode_window_s = collections.deque(maxlen=self._WINDOW)

    def observe_finished(self, req: ServeRequest):
        self.counters["completed"] += 1
        if req.ttft_s is not None:
            self.ttft_s.append(req.ttft_s)
        if req.latency_s is not None:
            self.latency_s.append(req.latency_s)

    def snapshot(self) -> Dict[str, float]:
        out = {f"serving/{k}": float(v) for k, v in self.counters.items()}
        out.update({f"serving/{k}": float(v)
                    for k, v in self.gauges.items()})
        for stem, vals in (("ttft", self.ttft_s),
                           ("latency", self.latency_s),
                           ("queue_wait", self.queue_wait_s)):
            if vals:
                qs = np.percentile(np.asarray(vals),
                                   [q for q, _ in self._QUANTILES])
                for (_q, tag), v in zip(self._QUANTILES, qs):
                    out[f"serving/{stem}_{tag}_ms"] = round(float(v) * 1e3,
                                                            3)
        return out

    def render_prometheus(self) -> str:
        """Prometheus text: every snapshot series, plus the kernel launch
        counts of the serving path."""
        lines = []
        for key, value in sorted(self.snapshot().items()):
            name = key.replace("/", "_")
            kind = ("counter" if key[len("serving/"):] in self.counters
                    else "gauge")
            lines += [f"# TYPE {name} {kind}", f"{name} {value:g}"]
        lines.append("# TYPE kernel_launches counter")
        for kernel, n in (
                ("decode_attention", decode_attention.launches),
                ("decode_attention_int8", decode_attention.int8_launches),
                ("decode_attention_alibi", decode_attention.alibi_launches),
                ("decode_attention_windowed",
                 decode_attention.windowed_launches),
                ("ds_flash_fwd", flash_attention_fwd.launches),
                ("qgemm", qgemm.launches),
                ("ds_fused_layer", ds_fused_layer.launches),
                ("block_quantize_int8", block_quantize_int8.launches),
                ("ds_ggemm", ds_ggemm.launches),
                ("ds_ggemm_slots", ds_ggemm_slots.launches),
                ("ds_ggemm_q", ds_ggemm.int8_launches),
                ("ds_ggemm_slots_q", ds_ggemm_slots.int8_launches)):
            lines.append(f'kernel_launches{{kernel="{kernel}"}} {n}')
        return "\n".join(lines) + "\n"


class ContinuousBatchingScheduler:
    """Drives a Model's prefill/decode functions as a serving loop.

    ``model`` must provide ``init_cache_fn/prefill_fn/decode_fn``;
    ``params`` are the placed inference params (e.g.
    ``InferenceEngine.params``), and the pool lives on their device."""

    PROMPT_BUCKET = 16          # prefill shapes = distinct 16-token buckets

    def __init__(self, model, params, config, kv_cache_dtype=None):
        """``kv_cache_dtype="int8"``: the pool holds int8 K/V plus one fp32
        scale per cached head vector (``k_s``/``v_s``); None keeps the
        compute dtype.  ``config.fused_decode`` selects the fused
        per-layer decode kernel."""
        if (model.init_cache_fn is None or model.prefill_fn is None
                or model.decode_fn is None):
            raise ValueError("model does not expose the KV-cache serving "
                             "surface (init_cache_fn/prefill_fn/decode_fn)")
        # the config may have been mutated after construction (CLI flags)
        refuse_unported(config)
        self.model = model
        self.params = params
        self.cfg = config
        self.device = params["wte"].device
        if kv_cache_dtype not in (None, "int8"):
            raise NotImplementedError(
                f"kv_cache_dtype={kv_cache_dtype!r}: not ported to "
                "deepspeed_tpu_torch yet (ROADMAP.md Queue A: serving "
                "extensions); the pool holds int8 or the compute dtype")
        self.kv_cache_dtype = kv_cache_dtype
        self.cache_dtype = ("int8" if kv_cache_dtype == "int8"
                            else params["wte"].dtype)
        # an explicit fused request on a spec the kernel does not cover
        # raises here, not at the first decode step
        self.fused_decode = fused_decode_active(
            getattr(model, "fused_spec", None), config.fused_decode)
        moe = getattr(model.config, "moe", None)
        if moe is not None and resolve_dispatch_mode(
                moe, train=False, override=config.moe_dispatch) != "grouped":
            raise NotImplementedError(
                "moe dispatch 'einsum' at serving: not ported to "
                "deepspeed_tpu_torch yet (ROADMAP.md Queue A: MoE training "
                "— einsum serving); the scheduler serves the grouped "
                "dispatch ('auto' or 'grouped')")
        self.block_mgr = BlockManager(config.num_blocks, config.block_size)
        bs = config.block_size
        model_ctx = int(getattr(model.config, "max_seq_len", 1 << 30))
        per_seq_cap = (config.max_blocks_per_seq * bs
                       if config.max_blocks_per_seq else model_ctx)
        #: hard per-request length ceiling (prompt + generated)
        self.max_model_len = min(model_ctx, per_seq_cap,
                                 self.block_mgr.num_usable_blocks * bs)
        # dense gather width, fixed for the scheduler's life (a 64
        # multiple, the reference's decode-kernel alignment)
        self.s_pad = _round_up(self.max_model_len, 64)
        self.blocks_per_table = -(-self.s_pad // bs)
        # logical position p lives at table[p // bs] * bs + p % bs
        self._pos_offs = np.arange(self.s_pad) % bs
        self._pos_blk = np.arange(self.s_pad) // bs
        #: per-step block-accounting invariant check (debug aid)
        self._debug_invariant = bool(int(
            os.environ.get("DS_SERVE_DEBUG", "0") or 0))
        self._class_priority = {
            name: int(c.priority) for name, c in config.slo.classes.items()}
        self.retry_after_s = float(config.slo.retry_after_s)
        self._lock = threading.RLock()
        self._queue: List[ServeRequest] = []
        self._slots: List[Optional[ServeRequest]] = \
            [None] * config.max_num_seqs
        self._next_id = 0
        self._step_count = 0
        self._finished_this_step: List[ServeRequest] = []
        self._serve_t0 = time.monotonic()
        self.metrics = ServingMetrics()
        self.pool = self._init_pool()

    def _init_pool(self):
        """Position-flat physical cache {"k", "v"}: [L, num_blocks *
        block_size, KV, hd] (the cache layout with the batch dim collapsed
        into the pool), plus {"k_s", "v_s"} [L, num_blocks * block_size,
        KV] for an int8 pool."""
        n_pos = self.cfg.num_blocks * self.cfg.block_size
        cache = self.model.init_cache_fn(1, n_pos, self.cache_dtype,
                                         self.device)
        return {k: v[:, 0] for k, v in cache.items()}

    # ----------------------------------------------------------- submit
    def submit(self, prompt_ids, sampling=None, priority: int = 0,
               timeout_s: float = 0.0, slo_class: str = "default"
               ) -> ServeRequest:
        """Enqueue a request; raises AdmissionError (429-style) instead of
        crashing or wedging the loop."""
        with self._lock:
            req = ServeRequest(
                request_id=self._next_id, prompt_ids=prompt_ids,
                sampling=sampling or SamplingParams(), priority=priority,
                timeout_s=timeout_s, slo_class=slo_class)
            self._next_id += 1
            vocab = getattr(self.model.config, "vocab_size", None)
            if vocab is not None and (req.prompt_ids.min() < 0
                                      or req.prompt_ids.max() >= vocab):
                # an out-of-range id would index past the embedding on
                # the device (a device-side assert kills the process)
                raise ValueError(f"prompt token ids must lie in [0, {vocab})")
            total = req.prompt_len + req.sampling.max_new_tokens
            if total > self.max_model_len \
                    or not self.block_mgr.fits_ever(total):
                req.state = RequestState.REJECTED
                req.reject_reason = (
                    f"prompt+max_new_tokens={total} exceeds serving "
                    f"capacity {self.max_model_len}")
                self.metrics.counters["rejected_too_long"] += 1
                req.done.set()
                raise RequestTooLongError(req.reject_reason)
            if len(self._queue) >= self.cfg.max_queued:
                req.state = RequestState.REJECTED
                req.reject_reason = (
                    f"queue full ({self.cfg.max_queued} waiting)")
                self.metrics.counters["rejected_queue_full"] += 1
                req.done.set()
                raise QueueFullError(req.reject_reason)
            self.metrics.counters["received"] += 1
            self._queue.append(req)
            return req

    # ------------------------------------------------------------ state
    def active_requests(self) -> List[ServeRequest]:
        with self._lock:
            return [r for r in self._slots if r is not None]

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(
                r is not None for r in self._slots)

    @property
    def step_count(self) -> int:
        return self._step_count

    def render_metrics(self) -> str:
        """Prometheus text for the /metrics endpoint (locked: the loop
        thread mutates the counters mid-step)."""
        with self._lock:
            return self.metrics.render_prometheus()

    # ------------------------------------------------------- lifecycle
    def _retire(self, req: ServeRequest, state: RequestState,
                reason: Optional[str] = None):
        self.block_mgr.free(req.request_id)
        if req.slot >= 0:
            self._slots[req.slot] = None
            req.slot = -1
        req.state = state
        if reason is not None:
            req.reject_reason = reason
        if state == RequestState.FINISHED:
            req.t_finish = time.monotonic()
            self.metrics.observe_finished(req)
            self._finished_this_step.append(req)
        req.done.set()

    def _evict(self, victim: ServeRequest):
        """Preempt: free blocks+slot, requeue for recompute-on-resume."""
        self.block_mgr.free(victim.request_id)
        if victim.slot >= 0:
            self._slots[victim.slot] = None
            victim.slot = -1
        victim.state = RequestState.EVICTED
        victim.num_preemptions += 1
        victim.queued_at = time.monotonic()    # timeout clock restarts
        self.metrics.counters["preemptions"] += 1
        self._queue.append(victim)
        logger.info(f"serving: preempted request {victim.request_id} "
                    f"(priority {victim.priority}, "
                    f"{victim.num_generated} tokens generated)")

    def _expire_queued(self):
        now = time.monotonic()
        for req in list(self._queue):
            if req.timeout_s > 0 and now - req.queued_at > req.timeout_s:
                self._queue.remove(req)
                self.metrics.counters["rejected_timeout"] += 1
                req.state = RequestState.REJECTED
                req.reject_reason = (f"timed out after {req.timeout_s}s "
                                     "queued")
                req.done.set()

    # -------------------------------------------------------- admission
    def _qos_key(self, req: ServeRequest):
        """Scheduling order: SLO class priority, then request priority,
        then eviction count (aging), then arrival (oldest wins).  ``max``
        picks the next admission, ``min`` the preemption victim."""
        cls = req.slo_class if req.slo_class in self._class_priority \
            else "default"
        return (self._class_priority.get(cls, 0), req.priority,
                req.num_preemptions, -req.arrival_time)

    def _admit(self):
        """Admit queued prefills into free slots, bounded by the step
        token budget and the pool."""
        budget = self.cfg.max_num_batched_tokens
        bm = self.block_mgr
        spent = 0
        while self._queue:
            free_slots = [i for i, r in enumerate(self._slots) if r is None]
            if not free_slots:
                break
            req = max(self._queue, key=self._qos_key)
            resumed = req.state == RequestState.EVICTED
            tokens = req.all_token_ids
            # resume re-prefills everything but the last generated token —
            # decode recomputes that one's KV as it proceeds
            inputs = tokens[:-1] if resumed and req.num_generated \
                else tokens
            n_in = int(inputs.size)
            if spent and spent + n_in > budget:
                break
            # blocks covering positions [0, n_in] — prefill fill plus the
            # first decode write — so admission never instantly preempts
            total = bm.blocks_for_tokens(n_in + 1)
            if bm.allocate(req.request_id, total) is None:
                break
            self._queue.remove(req)
            req.state = RequestState.PREFILL
            req.slot = free_slots[0]
            self._slots[req.slot] = req
            self.metrics.queue_wait_s.append(time.monotonic()
                                             - req.queued_at)
            if resumed:
                # the generated tail re-prefilled here is work the pool
                # preemption threw away
                self.metrics.counters["recomputed_tokens"] += max(
                    0, n_in - req.prompt_len)
            spent += n_in
            self._run_prefill(req, inputs)
            if resumed:
                self.metrics.counters["resumed"] += 1

    def _run_prefill(self, req: ServeRequest, inputs: np.ndarray):
        """One-shot prefill of ``inputs`` into the request's blocks."""
        t0 = time.perf_counter()
        n = int(inputs.size)
        sp = min(max(_round_up(n, self.PROMPT_BUCKET), self.PROMPT_BUCKET),
                 self.s_pad)
        padded = np.zeros((1, sp), np.int32)
        padded[0, :n] = inputs
        # flat pool destination per prompt position; pads write into the
        # trash block (positions 0..block_size-1), never a live block
        dest = (np.arange(sp) % self.block_mgr.block_size).astype(np.int64)
        dest[:n] = self._pos_idx_row(req.request_id)[:n]
        dev = self.device
        with torch.no_grad():
            cache = self.model.init_cache_fn(1, _round_up(sp, 64),
                                             self.cache_dtype, dev)
            logits, cache = self.model.prefill_fn(
                self.params, {"input_ids": torch.from_numpy(padded).to(dev)},
                cache)
            dest_t = torch.from_numpy(dest).to(dev)
            for name, pool in self.pool.items():
                pool[:, dest_t] = cache[name][:, 0, :sp]
            last_logits = logits[0, n - 1][None]
        self.metrics.counters["prefills"] += 1
        self.metrics.counters["prefill_tokens"] += n
        self._finish_prefill(req, last_logits)
        self.metrics.prefill_s.append((n, sp, time.perf_counter() - t0))

    def _finish_prefill(self, req: ServeRequest, last_logits):
        """Flip to DECODE and emit the first token, sampled from the last
        prompt position's logits.  A resumed request that already carries
        a generated tail emits nothing: its next token is on record."""
        req.state = RequestState.DECODE
        if req.num_generated:
            return
        s = req.sampling
        tok = int(sample_rows(
            last_logits, np.array([s.seed]), np.array([req.prompt_len]),
            np.array([s.temperature], np.float32),
            np.array([s.top_k], np.int32), np.array([s.top_p], np.float32),
            np.array([s.do_sample]))[0])
        req.record_token(tok)
        self.metrics.counters["generated_tokens"] += 1
        if req.finished_by(tok):
            self._retire(req, RequestState.FINISHED)

    # ------------------------------------------------- decode iteration
    def _grow_tables(self):
        """Allocate-on-decode: each active row needs a block for the
        position it writes this step; exhaustion preempts the lowest-
        priority active request (possibly the grower itself)."""
        bm = self.block_mgr
        for req in list(self._slots):
            if req is None or req.state != RequestState.DECODE:
                continue
            write_pos = int(req.all_token_ids.size) - 1
            while write_pos // bm.block_size >= len(
                    bm.block_table(req.request_id)):
                if bm.allocate(req.request_id, 1) is not None:
                    continue
                active = [r for r in self._slots if r is not None
                          and r.state == RequestState.DECODE]
                victim = min(active, key=self._qos_key)
                self._evict(victim)
                if victim is req:
                    break

    def _prepare_window(self, active, k: int) -> bool:
        """Extend every active row's block table to cover ``k`` upcoming
        writes — all or nothing, never preempting."""
        bm = self.block_mgr
        plan = []
        total = 0
        for req in active:
            last_pos = int(req.all_token_ids.size) - 1 + (k - 1)
            n = last_pos // bm.block_size + 1 \
                - len(bm.block_table(req.request_id))
            if n > 0:
                plan.append((req, n))
                total += n
        if total > bm.num_free_blocks:
            return False
        for req, n in plan:
            bm.allocate(req.request_id, n)
        return True

    def _choose_window(self, active) -> int:
        """Decode-window length: the largest power of two that respects
        max_fused_steps, cannot outrun the first possible retirement, and
        has pool blocks for every write."""
        rem = min(r.remaining_new_tokens for r in active)
        k = 1
        while k * 2 <= min(rem, self.cfg.max_fused_steps):
            k *= 2
        while k > 1 and not self._prepare_window(active, k):
            k //= 2
        return k

    def _pos_idx_row(self, request_id: int) -> np.ndarray:
        """Flat pool position of every logical position 0..s_pad-1 of the
        request; positions past its table ride the trash block."""
        table = np.zeros((self.blocks_per_table,), np.int64)
        t = self.block_mgr.block_table(request_id)
        table[:len(t)] = t
        return (table[self._pos_blk] * self.block_mgr.block_size
                + self._pos_offs)

    def _decode(self):
        """One k-step decode window over every DECODE row."""
        active = [r for r in self._slots if r is not None
                  and r.state == RequestState.DECODE]
        if not active:
            return
        t0 = time.perf_counter()
        B = self.cfg.max_num_seqs
        bm = self.block_mgr
        k = self._choose_window(active)
        tokens = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        # per-step pool destinations; padding rows keep the trash pattern
        dests = np.tile((np.arange(k) % bm.block_size)[:, None],
                        (1, B)).astype(np.int64)
        seeds = np.zeros((B,), np.int64)
        top_ks = np.zeros((B,), np.int32)
        temps = np.ones((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        do_flags = np.zeros((B,), bool)
        pos_idx = np.zeros((B, self.s_pad), np.int64)
        for req in active:
            b = req.slot
            seq = req.all_token_ids
            row = self._pos_idx_row(req.request_id)
            pos_idx[b] = row
            tokens[b], lengths[b] = seq[-1], seq.size - 1
            dests[:, b] = row[seq.size - 1:seq.size - 1 + k]
            s = req.sampling
            seeds[b], top_ks[b] = s.seed, s.top_k
            temps[b], top_ps[b] = s.temperature, s.top_p
            do_flags[b] = s.do_sample
        dev = self.device
        with torch.no_grad():
            toks = torch.from_numpy(tokens).to(dev)
            lens = torch.from_numpy(lengths).to(dev)
            dests_t = torch.from_numpy(dests).to(dev)
            pos_idx_t = torch.from_numpy(pos_idx).to(dev)
            rows = torch.arange(B, device=dev)
            out = []
            for j in range(k):
                dense = {n: p[:, pos_idx_t] for n, p in self.pool.items()}
                logits, dense = self.model.decode_fn(
                    self.params, toks, dense, lens, fused=self.fused_decode)
                # the ONE vector decode wrote per row, back to the pool
                for n, p in self.pool.items():
                    p[:, dests_t[j]] = dense[n][:, rows, lens.long()]
                toks = sample_rows(logits, seeds, lengths + 1 + j, temps,
                                   top_ks, top_ps, do_flags)
                lens = lens + 1
                out.append(toks)
            toks_host = torch.stack(out).cpu().numpy()     # [k, B]
        self.metrics.counters["decode_steps"] += k
        self.metrics.decode_window_s.append(
            (k, len(active), time.perf_counter() - t0))
        for req in active:
            for j in range(k):
                tok = int(toks_host[j, req.slot])
                req.record_token(tok)
                self.metrics.counters["generated_tokens"] += 1
                if req.finished_by(tok):
                    # an EOS inside the window discards the window tail
                    self._retire(req, RequestState.FINISHED)
                    break

    # ------------------------------------------------------------- step
    def step(self) -> List[ServeRequest]:
        """One engine iteration; returns requests finished this step."""
        with self._lock:
            self._finished_this_step = []
            self._expire_queued()
            self._admit()
            self._grow_tables()
            self._decode()
            self._step_count += 1
            if self._debug_invariant:
                self.block_mgr.check_invariant()
            self._update_gauges()
            return list(self._finished_this_step)

    def _update_gauges(self):
        c = self.metrics.counters
        elapsed = time.monotonic() - self._serve_t0
        self.metrics.gauges.update(
            queue_depth=len(self._queue),
            active_seqs=sum(r is not None for r in self._slots),
            block_pool_utilization=round(self.block_mgr.utilization(), 4),
            free_blocks=self.block_mgr.num_free_blocks)
        if elapsed > 0 and c["generated_tokens"]:
            self.metrics.gauges["tokens_per_s"] = round(
                c["generated_tokens"] / elapsed, 3)

    def run_until_idle(self, max_steps: int = 100_000):
        """Drive step() until queue and slots drain (bench/test helper)."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"scheduler did not drain in {max_steps} steps")
        return steps
