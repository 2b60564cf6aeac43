"""Serving and training configuration: copies of
``deepspeed_tpu/runtime/config.py`` ``ServingConfig`` and its sub-sections
and of the training keys of ``DeepSpeedConfig``, with the same field
names, defaults and validation messages, so one JSON dict configures
either package.

This port serves the reference's documented unfused configuration and
trains on one device.  Sections it does not port yet validate exactly as
in the reference and then, when switched on, raise
``NotImplementedError`` naming the ROADMAP item that brings them
(:func:`refuse_unported`, :func:`refuse_unported_training`) — never
silently ignored.
"""
import json
import os
from typing import Any, Dict, Optional, Union

from pydantic import Field

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.utils.logging import logger

#: ``serving.moe_dispatch`` values the reference accepts
DISPATCH_MODES = ("auto", "einsum", "grouped")


class SpecDecodeConfig(DeepSpeedConfigModel):
    """``serving.spec`` — speculative decoding: a proposer
    drafts up to ``max_draft_tokens`` per request per iteration, the
    target model verifies the whole window in one weight pass, and
    rejected suffixes roll back through the paged block tables."""
    #: off | ngram (prompt-lookup self-drafting, no second model) |
    #: draft (a smaller checkpoint sharing the tokenizer — the scheduler
    #: needs a DraftModelProposer handed in, see bin/ds_serve --spec)
    mode: str = "off"
    #: per-request draft-length cap k; each verify window scores k+1
    #: positions (the drafts plus one bonus token from the verify logits)
    max_draft_tokens: int = 4
    #: per-request auto-disable: once a request's rolling acceptance-rate
    #: EMA sits below this after a few verify passes, it decodes plain
    #: for the rest of its life (0 = never disable)
    min_accept_rate: float = 0.0
    #: prompt-lookup n-gram sizes: match the last n tokens (longest
    #: first) against the request's own prompt+output history
    ngram_max: int = 3
    ngram_min: int = 1
    #: draft-model arch:size spec for ds_serve --spec draft
    draft_model: Optional[str] = None
    #: draft proposer's own (small) paged KV pool
    draft_num_blocks: int = 64
    draft_block_size: int = 16

    def __init__(self, **data):
        super().__init__(**data)
        if self.mode not in ("off", "ngram", "draft"):
            raise ValueError(f"serving.spec.mode={self.mode!r}: choose "
                             "off | ngram | draft")
        if self.max_draft_tokens < 1:
            raise ValueError("serving.spec.max_draft_tokens="
                             f"{self.max_draft_tokens}: must be >= 1")
        if not 0.0 <= self.min_accept_rate <= 1.0:
            raise ValueError("serving.spec.min_accept_rate="
                             f"{self.min_accept_rate}: must be in [0, 1]")
        if self.ngram_min < 1 or self.ngram_max < self.ngram_min:
            raise ValueError(
                f"serving.spec ngram sizes min={self.ngram_min} "
                f"max={self.ngram_max}: need 1 <= min <= max")
        if self.draft_num_blocks < 2:
            raise ValueError("serving.spec.draft_num_blocks="
                             f"{self.draft_num_blocks}: need >= 2")
        if self.draft_block_size < 1:
            raise ValueError("serving.spec.draft_block_size="
                             f"{self.draft_block_size}: must be >= 1")


class PrefixCacheConfig(DeepSpeedConfigModel):
    """``serving.prefix_cache`` — cross-request prefix caching:
    full KV blocks become hash-addressed immutable entries shared between
    requests; a new request's prompt is matched block-by-block against
    the cache and prefill starts at the first uncached token."""
    #: off by default: with it on, greedy output is token-identical but
    #: not bitwise in the logits (suffix prefill rides the verify-window
    #: path, ~1-ulp from the one-shot causal prefill)
    enabled: bool = False
    #: minimum matched blocks worth attaching — below this the request
    #: full-prefills (tiny matches don't pay for the suffix-program
    #: dispatch + ref bookkeeping)
    min_prefix_blocks: int = 1
    #: cap on RETAINED refcount-0 cached blocks (0 = bounded only by the
    #: pool); cap it when serving wildly heterogeneous traffic so stale
    #: prefixes can't crowd the free list into constant LRU churn
    max_cached_blocks: int = 0

    def __init__(self, **data):
        super().__init__(**data)
        if self.min_prefix_blocks < 1:
            raise ValueError(
                "serving.prefix_cache.min_prefix_blocks="
                f"{self.min_prefix_blocks}: must be >= 1")
        if self.max_cached_blocks < 0:
            raise ValueError(
                "serving.prefix_cache.max_cached_blocks="
                f"{self.max_cached_blocks}: must be >= 0 (0 = pool-bounded)")


class KvTieringConfig(DeepSpeedConfigModel):
    """``serving.kv_tiering`` — tiered KV-cache spill: LRU
    pressure demotes refcount-0 hashed blocks device→host→NVMe instead
    of dropping them, preemption parks a victim's committed KV on NVMe,
    and a cold-tier prefix hit swaps back in asynchronously instead of
    re-prefilling.  Requires ``serving.prefix_cache.enabled`` — tiers are
    keyed by the prefix cache's chained block hashes."""
    enabled: bool = False
    #: host-RAM tier capacity in KV blocks; overflow spills the oldest
    #: entries to the NVMe tier (0 = unbounded host tier, never spill)
    host_blocks: int = 256
    #: NVMe tier capacity in KV blocks; overflow drops the oldest
    #: entries outright (0 = unbounded)
    nvme_blocks: int = 0
    #: directory for the NVMe tier's payload files; None = a fresh
    #: process-private temp dir (removed with the engine)
    nvme_dir: Optional[str] = None
    #: park a preemption victim's committed KV straight on NVMe so its
    #: resume is a swap-in instead of a re-prefill
    park_on_preempt: bool = True
    #: aio worker threads per direction for the tier files (io_uring
    #: rings when the kernel allows it, thread pools otherwise)
    aio_threads: int = 2
    #: double-buffering depth: max in-flight async reads/writes per
    #: direction before the engine reaps the oldest
    queue_depth: int = 2

    def __init__(self, **data):
        super().__init__(**data)
        if self.host_blocks < 0:
            raise ValueError(
                f"serving.kv_tiering.host_blocks={self.host_blocks}: "
                "must be >= 0 (0 = unbounded)")
        if self.nvme_blocks < 0:
            raise ValueError(
                f"serving.kv_tiering.nvme_blocks={self.nvme_blocks}: "
                "must be >= 0 (0 = unbounded)")
        if self.aio_threads < 1:
            raise ValueError(
                f"serving.kv_tiering.aio_threads={self.aio_threads}: "
                "must be >= 1")
        if self.queue_depth < 1:
            raise ValueError(
                f"serving.kv_tiering.queue_depth={self.queue_depth}: "
                "must be >= 1")


class SLOClassConfig(DeepSpeedConfigModel):
    """One request class's latency targets (``serving.slo.classes``).
    0 = no target for that dimension (requests still counted)."""
    #: time-to-first-token target, milliseconds
    ttft_ms: float = 0.0
    #: time-per-output-token target, milliseconds (mean inter-token)
    tpot_ms: float = 0.0
    #: QoS rank: higher = more important.  Admission and
    #: chunked-prefill service order by it, preemption victimizes the
    #: lowest first, and overload shedding drops classes strictly BELOW
    #: a burning class's priority (shed-lowest-first)
    priority: int = 0

    def __init__(self, **data):
        super().__init__(**data)
        if self.ttft_ms < 0 or self.tpot_ms < 0:
            raise ValueError(
                f"serving.slo class targets ttft_ms={self.ttft_ms} "
                f"tpot_ms={self.tpot_ms}: must be >= 0 (0 = no target)")


class SLOConfig(DeepSpeedConfigModel):
    """``serving.slo`` — per-class latency-target accounting
    plus burn-driven admission control: each finished request
    is scored against its class's TTFT/TPOT targets, feeding violation
    counters and rolling burn-rate gauges; with ``shed_enabled`` the
    scheduler consumes those burn rates at submit time and sheds the
    lowest-priority classes 429-style (with Retry-After) instead of
    letting the queue grow without bound."""
    enabled: bool = False
    #: class name -> SLOClassConfig (dict-in-JSON, validated below);
    #: unknown request classes fall back to "default"
    classes: Any = None
    #: rolling burn-rate window, in requests per class
    window: int = 256
    #: overload shedding: at saturation, reject submissions of
    #: the lowest-priority classes with a 429 + Retry-After instead of
    #: queueing them (requires ``enabled``)
    shed_enabled: bool = False
    #: a class whose rolling TTFT/TPOT burn rate exceeds this sheds
    #: every class with strictly lower priority (the burning class
    #: itself keeps queueing — queue pressure handles the bottom class)
    shed_burn_threshold: float = 0.5
    #: queue depth, as a fraction of ``serving.max_queued``, beyond
    #: which the lowest-priority class sheds outright
    shed_queue_fraction: float = 0.75
    #: minimum requests in a class's burn window before its burn rate
    #: can trigger shedding (one unlucky first request must not drop a
    #: whole class)
    shed_min_requests: int = 4
    #: Retry-After seconds returned with shed 429s
    retry_after_s: float = 1.0

    def __init__(self, **data):
        super().__init__(**data)
        raw = self.classes or {}
        if not isinstance(raw, dict):
            raise ValueError("serving.slo.classes must be an object of "
                             "class-name -> {ttft_ms, tpot_ms, priority}")
        self.classes = {
            str(name): (c if isinstance(c, SLOClassConfig)
                        else SLOClassConfig(**(c or {})))
            for name, c in raw.items()}
        self.classes.setdefault("default", SLOClassConfig())
        if self.window < 1:
            raise ValueError(f"serving.slo.window={self.window}: must "
                             "be >= 1")
        if not 0.0 < self.shed_burn_threshold <= 1.0:
            raise ValueError(
                "serving.slo.shed_burn_threshold="
                f"{self.shed_burn_threshold}: must be in (0, 1]")
        if not 0.0 < self.shed_queue_fraction <= 1.0:
            raise ValueError(
                "serving.slo.shed_queue_fraction="
                f"{self.shed_queue_fraction}: must be in (0, 1]")
        if self.shed_min_requests < 1:
            raise ValueError(
                "serving.slo.shed_min_requests="
                f"{self.shed_min_requests}: must be >= 1")
        if self.retry_after_s < 0:
            raise ValueError(f"serving.slo.retry_after_s="
                             f"{self.retry_after_s}: must be >= 0")


class ChunkedPrefillConfig(DeepSpeedConfigModel):
    """``serving.chunked_prefill`` — Sarathi-style chunked prefill:
    prompts whose prefill exceeds the per-iteration chunk allowance are
    admitted into a persistent PREFILLING state and their prefill runs as
    budget-sized chunks interleaved with decode across scheduler
    iterations, so one long prompt cannot spike every active stream's
    TPOT."""
    enabled: bool = False
    #: max prefill tokens executed per scheduler iteration, shared by
    #: every admission + PREFILLING row (decode rows consume the rest of
    #: ``max_num_batched_tokens``); the scheduler floors effective
    #: progress at one suffix bucket so prefill can never stall outright
    chunk_tokens: int = 256

    def __init__(self, **data):
        super().__init__(**data)
        if self.chunk_tokens < 1:
            raise ValueError(
                "serving.chunked_prefill.chunk_tokens="
                f"{self.chunk_tokens}: must be >= 1")


class FleetConfig(DeepSpeedConfigModel):
    """``serving.fleet`` — replica-fleet serving: a Router
    dispatching requests across N in-process replicas (each its own
    ContinuousBatchingScheduler + HealthMonitor + metrics registry)
    with a weighted policy stack — least-loaded by outstanding token
    budget, session affinity, and prefix-cache-aware scoring against a
    bounded per-replica cache digest.  Membership is health-gated: a
    DRAINING/DEGRADED replica stops receiving new work and its in-flight
    requests are resubmitted to a healthy replica through the existing
    evict/resume machinery."""
    #: replicas ``bin/ds_router`` / ``ds_serve --replicas N`` build over
    #: one shared model+params; 1 = the plain single-scheduler server
    num_replicas: int = 1
    #: "scored" combines the weighted policy stack below; "round_robin"
    #: ignores it (the serve_bench A/B baseline)
    policy: str = "scored"
    #: weight of the normalized outstanding-token load penalty
    least_loaded_weight: float = 1.0
    #: bonus for the replica a live session last decoded on (its KV /
    #: prefix blocks are still warm there)
    affinity_weight: float = 1.0
    #: weight of the matched-prefix fraction from the replica cache
    #: digest
    prefix_weight: float = 1.0
    #: bonus for a replica whose AdapterStore already holds the
    #: request's adapter: dispatching there skips the
    #: swap-in; scaled by the residency tier (HBM full, host/NVMe by
    #: the tier discounts below)
    adapter_weight: float = 1.0
    #: prefix-score multiplier when the deepest digest hit sits in the
    #: replica's host-RAM tier: warm beats cold, HBM beats
    #: warm — attaching it costs a host→HBM swap-in
    host_tier_discount: float = 0.6
    #: same for an NVMe-cold deepest hit: still worth routing toward
    #: for long prefixes, but the swap-in pays NVMe latency
    nvme_tier_discount: float = 0.3
    #: router-side replica-cache digest max age before a dispatch
    #: refreshes it (0 = refresh on every scored dispatch)
    digest_refresh_s: float = 0.5
    #: newest-N hash-chain heads kept per replica digest (bounds router
    #: memory AND the per-dispatch prompt hashing work)
    digest_max_entries: int = 512
    #: times one request may be resubmitted to another replica (drain /
    #: replica loss) before it fails; 0 = never resubmit
    resubmit_budget: int = 3
    #: bounded session->replica affinity map (LRU beyond this)
    session_capacity: int = 4096

    def __init__(self, **data):
        super().__init__(**data)
        if self.num_replicas < 1:
            raise ValueError(f"serving.fleet.num_replicas="
                             f"{self.num_replicas}: must be >= 1")
        if self.policy not in ("scored", "round_robin"):
            raise ValueError(f"serving.fleet.policy={self.policy!r}: "
                             "choose scored | round_robin")
        for k in ("least_loaded_weight", "affinity_weight",
                  "prefix_weight", "adapter_weight"):
            if getattr(self, k) < 0:
                raise ValueError(
                    f"serving.fleet.{k}={getattr(self, k)}: must be >= 0")
        for k in ("host_tier_discount", "nvme_tier_discount"):
            if not 0.0 <= getattr(self, k) <= 1.0:
                raise ValueError(
                    f"serving.fleet.{k}={getattr(self, k)}: must be in "
                    "[0, 1] (a multiplier on the matched-prefix score)")
        if self.digest_refresh_s < 0:
            raise ValueError(f"serving.fleet.digest_refresh_s="
                             f"{self.digest_refresh_s}: must be >= 0")
        if self.digest_max_entries < 1:
            raise ValueError(f"serving.fleet.digest_max_entries="
                             f"{self.digest_max_entries}: must be >= 1")
        if self.resubmit_budget < 0:
            raise ValueError(f"serving.fleet.resubmit_budget="
                             f"{self.resubmit_budget}: must be >= 0")
        if self.session_capacity < 1:
            raise ValueError(f"serving.fleet.session_capacity="
                             f"{self.session_capacity}: must be >= 1")


class AdaptersConfig(DeepSpeedConfigModel):
    """``serving.adapters`` — multi-tenant LoRA adapter serving: a paged
    adapter store holds up to ``max_hbm_adapters`` adapters
    device-resident as slot stacks feeding a batched gather-LoRA pass;
    refcount-0 residents demote LRU to host RAM/NVMe and swap back in
    overlapped with the running decode."""
    enabled: bool = False
    #: adapter_id -> .npz path (the ``save_adapter`` on-disk spelling);
    #: registered + ingested at scheduler construction.  The ``ds_serve
    #: --adapters name=path,...`` flag populates this.
    adapters: Any = None
    #: HBM slot count — adapters concurrently usable in one step; the
    #: gather-LoRA stacks are sized [L, S, d, r_max] by this
    max_hbm_adapters: int = 4
    #: slot rank ceiling; lower-rank adapters zero-pad (exact)
    max_rank: int = 8
    #: restrict target projections ("qkv_w", "wq", ...); empty = any
    #: stacked block weight the registered adapters name
    targets: Any = None
    #: a failed adapter swap-in (fault/IO/integrity) serves the request
    #: from the BASE model (flagged on the response) instead of a typed
    #: rejection
    fallback_to_base: bool = False
    #: adapter_id -> SLO class name: requests
    #: submitted with a defaulted slo_class inherit their tenant's
    slo_class_map: Any = None
    #: host-RAM tier capacity in adapters; overflow spills oldest to
    #: NVMe (0 = unbounded host tier, never spill)
    max_host_adapters: int = 16
    #: directory for NVMe-tier payload files; None = process-private
    #: temp dir (removed with the engine)
    nvme_dir: Optional[str] = None
    #: aio worker threads per direction (kv_tiering semantics)
    aio_threads: int = 2
    #: max in-flight async reads/writes per direction
    queue_depth: int = 2

    def __init__(self, **data):
        super().__init__(**data)
        raw = self.adapters or {}
        if not isinstance(raw, dict):
            raise ValueError("serving.adapters.adapters must be an object "
                             "of adapter_id -> npz path")
        self.adapters = {str(k): str(v) for k, v in raw.items()}
        raw_map = self.slo_class_map or {}
        if not isinstance(raw_map, dict):
            raise ValueError("serving.adapters.slo_class_map must be an "
                             "object of adapter_id -> SLO class name")
        self.slo_class_map = {str(k): str(v) for k, v in raw_map.items()}
        if self.targets is not None and not isinstance(
                self.targets, (list, tuple)):
            raise ValueError("serving.adapters.targets must be a list of "
                             "projection names (or omitted)")
        self.targets = tuple(str(t) for t in (self.targets or ()))
        if self.max_hbm_adapters < 1:
            raise ValueError(
                "serving.adapters.max_hbm_adapters="
                f"{self.max_hbm_adapters}: must be >= 1")
        if self.max_rank < 1:
            raise ValueError(f"serving.adapters.max_rank={self.max_rank}: "
                             "must be >= 1")
        if self.max_host_adapters < 0:
            raise ValueError(
                "serving.adapters.max_host_adapters="
                f"{self.max_host_adapters}: must be >= 0 (0 = unbounded)")
        if self.aio_threads < 1:
            raise ValueError(
                f"serving.adapters.aio_threads={self.aio_threads}: "
                "must be >= 1")
        if self.queue_depth < 1:
            raise ValueError(
                f"serving.adapters.queue_depth={self.queue_depth}: "
                "must be >= 1")


class ServingConfig(DeepSpeedConfigModel):
    """Continuous-batching serving (``deepspeed_tpu_torch/serving/``):
    block-pool sizing, iteration-level scheduler budgets, admission
    control.  Validation is the reference's; :func:`refuse_unported`
    runs last and refuses the sections this port does not serve yet."""
    #: tokens per physical KV-cache block (the paging granularity)
    block_size: int = 16
    #: physical pool blocks, INCLUDING the reserved trash block 0;
    #: pool bytes = (num_blocks*block_size) x layers x 2 x kv_heads x
    #: head_dim x itemsize
    num_blocks: int = 256
    #: decode-batch width = max concurrently running sequences
    max_num_seqs: int = 8
    #: admission control: queued requests beyond this reject 429-style
    max_queued: int = 128
    #: per-step prefill token budget (iteration-level scheduling knob)
    max_num_batched_tokens: int = 2048
    #: per-sequence block-table length cap; 0 = model context / block_size
    max_blocks_per_seq: int = 0
    #: default queued-request timeout (seconds); 0 = wait forever
    request_timeout_s: float = 0.0
    #: scheduler steps between monitor-sink metric emissions
    monitor_interval: int = 16
    #: multi-step decode window cap: up to this many decode iterations
    #: run back to back with tokens kept on the device (no host sync)
    #: when the window provably cannot change a scheduling decision
    #: (window = min remaining tokens over active rows, so it ends
    #: exactly when the first row could retire).  1 disables.  Power of
    #: two.
    max_fused_steps: int = 8
    #: int8-weights decode loop-form threshold in the reference (scan
    #: form above it).  Validated, selects nothing here: the qgemm kernel
    #: consumes every quantized projection in place, so no dequantized
    #: residual is left to count, and the reference keeps its unrolled
    #: loop in that case too; the port has no scan form
    quant_scan_threshold_mb: int = 512
    #: MoE expert dispatch formulation override: "auto" and "grouped"
    #: serve the grouped dispatch; "einsum" (ported for training) is
    #: refused by the scheduler of an MoE model; dense models ignore it
    moe_dispatch: Optional[str] = None
    #: fused decode megakernel toggle: True runs one fused-layer kernel
    #: per layer per decode step (``ops/kernels/fused_decode.py``); None
    #: and False run the unfused per-layer decode.  The reference turns
    #: None on by default on a single TPU; the port keeps None unfused
    #: until the fused step is measured on the GPU (ROADMAP.md Queue C)
    fused_decode: Optional[bool] = None
    #: scheduler watchdog: seconds of pending work with step_count frozen
    #: before the server goes DEGRADED (waiting /generate handlers then
    #: 503 instead of hanging).  DS_SERVE_STALL_TIMEOUT_S overrides; 0
    #: disables the watchdog.
    stall_timeout_s: float = 600.0
    #: consecutive serving-loop step() failures before the server goes
    #: DEGRADED instead of retrying forever; 0 = never degrade
    max_loop_failures: int = 8
    #: speculative decoding sub-section (dict in JSON; validated into a
    #: SpecDecodeConfig below — nested pydantic construction would skip
    #: the sub-config's __init__ validation)
    spec: Any = None
    #: cross-request prefix-cache sub-section (same dict-in-JSON
    #: validation pattern as ``spec``)
    prefix_cache: Any = None
    #: tiered KV-cache spill sub-section (same pattern; requires
    #: ``prefix_cache.enabled``)
    kv_tiering: Any = None
    #: per-class SLO sub-section (same pattern): class priorities order
    #: admission and preemption; burn accounting and shedding
    #: (``enabled``) are not ported yet
    slo: Any = None
    #: chunked-prefill sub-section (same pattern)
    chunked_prefill: Any = None
    #: replica-fleet sub-section (same pattern)
    fleet: Any = None
    #: multi-tenant LoRA adapter sub-section (same pattern)
    adapters: Any = None

    def __init__(self, **data):
        super().__init__(**data)
        if not isinstance(self.spec, SpecDecodeConfig):
            self.spec = SpecDecodeConfig(**(self.spec or {}))
        if not isinstance(self.adapters, AdaptersConfig):
            self.adapters = AdaptersConfig(**(self.adapters or {}))
        if not isinstance(self.fleet, FleetConfig):
            self.fleet = FleetConfig(**(self.fleet or {}))
        if not isinstance(self.prefix_cache, PrefixCacheConfig):
            self.prefix_cache = PrefixCacheConfig(
                **(self.prefix_cache or {}))
        if not isinstance(self.kv_tiering, KvTieringConfig):
            self.kv_tiering = KvTieringConfig(**(self.kv_tiering or {}))
        if self.kv_tiering.enabled and not self.prefix_cache.enabled:
            raise ValueError(
                "serving.kv_tiering.enabled=true requires "
                "serving.prefix_cache.enabled (cold tiers are keyed by "
                "the prefix cache's chained block hashes)")
        if not isinstance(self.slo, SLOConfig):
            self.slo = SLOConfig(**(self.slo or {}))
        if not isinstance(self.chunked_prefill, ChunkedPrefillConfig):
            self.chunked_prefill = ChunkedPrefillConfig(
                **(self.chunked_prefill or {}))
        if self.block_size < 1:
            raise ValueError(f"serving.block_size={self.block_size}: "
                             "must be >= 1")
        if self.num_blocks < 2:
            raise ValueError(f"serving.num_blocks={self.num_blocks}: need "
                             ">= 2 (block 0 is the reserved trash block)")
        if self.max_num_seqs < 1:
            raise ValueError(
                f"serving.max_num_seqs={self.max_num_seqs}: must be >= 1")
        if self.max_queued < 1:
            raise ValueError(
                f"serving.max_queued={self.max_queued}: must be >= 1")
        if self.max_num_batched_tokens < 1:
            raise ValueError("serving.max_num_batched_tokens="
                             f"{self.max_num_batched_tokens}: must be >= 1")
        if self.max_blocks_per_seq < 0:
            raise ValueError("serving.max_blocks_per_seq="
                             f"{self.max_blocks_per_seq}: must be >= 0 "
                             "(0 = model context / block_size)")
        if self.request_timeout_s < 0:
            raise ValueError("serving.request_timeout_s="
                             f"{self.request_timeout_s}: must be >= 0 "
                             "(0 = wait forever)")
        if self.monitor_interval < 1:
            raise ValueError("serving.monitor_interval="
                             f"{self.monitor_interval}: must be >= 1")
        if self.max_fused_steps < 1 or (
                self.max_fused_steps & (self.max_fused_steps - 1)):
            raise ValueError(
                f"serving.max_fused_steps={self.max_fused_steps}: must be "
                "a power of two >= 1 (one compiled program per size)")
        if self.quant_scan_threshold_mb < 0:
            raise ValueError(
                "serving.quant_scan_threshold_mb="
                f"{self.quant_scan_threshold_mb}: must be >= 0")
        if self.moe_dispatch is not None:
            if self.moe_dispatch not in DISPATCH_MODES:
                raise ValueError(
                    f"serving.moe_dispatch={self.moe_dispatch!r}: choose "
                    f"one of {DISPATCH_MODES} (or omit to keep the model "
                    "config's dispatch_mode)")
        if self.stall_timeout_s < 0:
            raise ValueError(
                f"serving.stall_timeout_s={self.stall_timeout_s}: must be "
                ">= 0 (0 disables the stall watchdog)")
        if self.max_loop_failures < 0:
            raise ValueError(
                f"serving.max_loop_failures={self.max_loop_failures}: "
                "must be >= 0 (0 = never degrade on step failures)")
        refuse_unported(self)

    def resolved_stall_timeout_s(self) -> float:
        """Config value with the DS_SERVE_STALL_TIMEOUT_S env override
        applied (the quant_scan_threshold pattern: env wins at use
        site)."""
        env = os.environ.get("DS_SERVE_STALL_TIMEOUT_S")
        if env is not None and env.strip():
            return float(env)
        return self.stall_timeout_s



def refuse_unported(cfg: ServingConfig):
    """Raise ``NotImplementedError`` for every switched-on section of the
    reference serving stack that this port does not serve yet, naming
    the ROADMAP.md item that brings it."""
    checks = (
        (cfg.spec.mode != "off", f"serving.spec.mode={cfg.spec.mode!r}",
         "Queue A: speculative decoding"),
        (cfg.prefix_cache.enabled, "serving.prefix_cache.enabled",
         "Queue A: prefix cache"),
        (cfg.chunked_prefill.enabled, "serving.chunked_prefill.enabled",
         "Queue A: chunked prefill"),
        (cfg.adapters.enabled, "serving.adapters.enabled",
         "Queue A: multi-tenant adapters"),
        (cfg.fleet.num_replicas > 1,
         f"serving.fleet.num_replicas={cfg.fleet.num_replicas}",
         "Queue A: replica fleet"),
        (cfg.kv_tiering.enabled, "serving.kv_tiering.enabled",
         "Queue A: tiered KV cache"),
        (cfg.slo.enabled, "serving.slo.enabled",
         "Queue A: SLO accounting and shedding"),
    )
    for on, what, item in checks:
        if on:
            raise NotImplementedError(
                f"{what}: not ported to deepspeed_tpu_torch yet "
                f"(ROADMAP.md {item}); the port serves the "
                "single-device configuration")


# ------------------------------------------------------------------ training
class FP16Config(DeepSpeedConfigModel):
    """``fp16``: compute in fp16 with a static or dynamic loss scale
    (runtime/fp16/loss_scaler.py); the reference's keys and defaults."""
    enabled: bool = False
    loss_scale: float = 0.0           # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


class CheckpointConfig(DeepSpeedConfigModel):
    """``checkpoint``: ``async_save`` runs the npz write on a background
    thread after a host snapshot (runtime/checkpoint_engine/engine.py);
    ``tag_validation`` is accepted ("Ignore" / "Warn" / "Fail") and, with
    one process, has no other rank's tag to compare."""
    tag_validation: str = "Warn"
    async_save: bool = False

    def __init__(self, **data):
        super().__init__(**data)
        if str(self.tag_validation).lower() not in ("ignore", "warn",
                                                    "fail"):
            raise ValueError(
                f"checkpoint.tag_validation={self.tag_validation!r}: "
                "expected Ignore, Warn or Fail")


class RetryConfig(DeepSpeedConfigModel):
    """Backoff policy for checkpoint I/O (resilience/retry.py
    retry_call: exponential backoff + full jitter + deadline)."""
    attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    #: wall-clock budget across all attempts; None = attempts-bounded only
    deadline_s: Optional[float] = None

    def __init__(self, **data):
        super().__init__(**data)
        if self.attempts < 1:
            raise ValueError(
                f"resilience.retry.attempts={self.attempts}: must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("resilience.retry delays must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"resilience.retry.deadline_s={self.deadline_s}: must be "
                "> 0 (omit for no deadline)")


class ResilienceConfig(DeepSpeedConfigModel):
    """``resilience``: the crash-safe checkpoint protocol's knobs
    (resilience/ckpt.py).  Fault injection (``faults``) is refused until
    it is ported."""
    faults: str = ""
    #: retain only the newest k VALID checkpoint tags after each publish
    #: (0 = keep everything); the fallback tag is never deleted
    keep_last_k: int = 0
    #: record per-leaf crc32s in the checkpoint manifest
    checkpoint_checksums: bool = True
    #: load-time verification: "off", "manifest" (the manifest parses and
    #: its file inventory matches on disk) or "full" (also re-checksums
    #: every restored leaf)
    verify_checkpoint: str = "manifest"
    retry: RetryConfig = Field(default_factory=RetryConfig)

    def __init__(self, **data):
        super().__init__(**data)
        if self.verify_checkpoint not in ("off", "manifest", "full"):
            raise ValueError(
                f"resilience.verify_checkpoint={self.verify_checkpoint!r}: "
                "expected off | manifest | full")
        if self.keep_last_k < 0:
            raise ValueError(
                f"resilience.keep_last_k={self.keep_last_k}: must be >= 0")


class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    # optimizer state dtypes (runtime/bf16_optimizer.py): "bfloat16"
    # masters are Kahan-compensated; bf16 moments keep fp32 math
    master_weights_dtype: str = "float32"      # float32 | bfloat16 (Kahan)
    optimizer_states_dtype: Optional[str] = None   # None=float32 | bfloat16


class OffloadConfig(DeepSpeedConfigModel):
    """``offload_param`` / ``offload_optimizer``: a device other than
    "none" is refused."""
    device: str = "none"              # none | cpu | nvme


class ZeroConfig(DeepSpeedConfigModel):
    """``zero_optimization``: stages 0-3 are accepted; with one device
    (data-parallel world 1) they shard nothing, as in the reference.  The
    bucket, overlap and stage-3 prefetch knobs act only across devices
    and pass through unread; the ZeRO++ quantized switches are refused
    until ZeRO++ is ported."""
    stage: int = 0
    offload_param: Optional[OffloadConfig] = None
    offload_optimizer: Optional[OffloadConfig] = None
    cpu_offload: Optional[bool] = None   # deprecated bool; migrated below
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False

    def __init__(self, **data):
        # deprecated cpu_offload=True == offload_optimizer.device=cpu
        if data.get("cpu_offload") and "offload_optimizer" not in data:
            logger.warning("zero_optimization.cpu_offload is deprecated; use "
                           "offload_optimizer: {device: cpu}")
            data["offload_optimizer"] = {"device": "cpu"}
        super().__init__(**data)


class MeshConfig(DeepSpeedConfigModel):
    """Parallel dimension sizes (every size above 1 is refused here)."""
    model_parallel_size: int = 1
    pipe_parallel_size: int = 1
    sequence_parallel_size: int = 1
    expert_parallel_size: int = 1
    data_parallel_size: Optional[int] = None


class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None


def _any_enabled(section) -> bool:
    """Whether a nested config dict switches anything on (an
    ``"enabled": true`` at any depth)."""
    if not isinstance(section, dict):
        return False
    return bool(section.get("enabled")) or any(
        _any_enabled(v) for v in section.values())


class DeepSpeedConfig:
    """The training keys of the reference's ``DeepSpeedConfig``: typed
    sub-configs + batch math, for one device (data-parallel world 1)."""

    def __init__(self, config: Union[str, Dict]):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise FileNotFoundError(
                    f"DeepSpeed config path not found: {config}")
            with open(config) as f:
                self._param_dict = json.load(f)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        else:
            raise ValueError("config must be a dict or a path to a JSON "
                             f"file, got {type(config)}")
        d = self._param_dict
        self.train_batch_size = d.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = d.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = d.get(
            C.GRADIENT_ACCUMULATION_STEPS)

        self.optimizer_name = None
        self.optimizer_params = None
        opt = d.get(C.OPTIMIZER)
        if opt:
            self.optimizer_name = opt.get("type", "").lower()
            self.optimizer_params = opt.get("params", {})
        sched = d.get(C.SCHEDULER)
        self.scheduler_name = sched.get("type") if sched else None
        self.scheduler_params = sched.get("params", {}) if sched else {}

        self.fp16 = FP16Config(**d.get(C.FP16, {}))
        self.checkpoint_config = CheckpointConfig(**d.get("checkpoint", {}))
        self.resilience_config = ResilienceConfig(**d.get("resilience", {}))
        self.bf16 = BF16Config(**d.get(C.BF16, d.get("bfloat16", {})))
        self.zero_config = ZeroConfig(**d.get(C.ZERO_OPTIMIZATION, {}))
        self.mesh_config = MeshConfig(**d.get("mesh", {}))
        self.data_types_config = DataTypesConfig(**d.get("data_types", {}))
        self.gradient_clipping = float(d.get(C.GRADIENT_CLIPPING, 0.0))
        self.steps_per_print = int(d.get(C.STEPS_PER_PRINT,
                                         C.STEPS_PER_PRINT_DEFAULT))
        self.seed = int(d.get("seed", 42))
        self.compression_config = d.get("compression_training", {})
        self.curriculum_learning = d.get("curriculum_learning", {})
        self.pld_config = d.get("progressive_layer_drop", {})
        self.data_efficiency_config = d.get("data_efficiency", {})
        self.zero_optimization_stage = self.zero_config.stage

        self._resolve_batch_sizes(1)
        self._sanity_check()
        refuse_unported_training(self)

    def _resolve_batch_sizes(self, dp_world: Optional[int]):
        """Batch-size triangulation: train = micro x gas x dp."""
        dp = dp_world or 1
        train, micro, gas = (self.train_batch_size,
                             self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
        elif train is not None and gas is not None:
            micro = train // (gas * dp)
        elif micro is not None and gas is not None:
            train = micro * gas * dp
        elif train is not None:
            gas = 1
            micro = train // dp
        elif micro is not None:
            gas = 1
            train = micro * dp
        else:
            raise ValueError(
                "One of train_batch_size or train_micro_batch_size_per_gpu "
                "must be set in the DeepSpeed config")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
        self._dp_world_for_check = dp

    def _sanity_check(self):
        train, micro, gas = (self.train_batch_size,
                             self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        dp = self._dp_world_for_check
        if micro is None or micro <= 0 or gas is None or gas <= 0:
            raise ValueError(
                f"Invalid batch config: micro={micro} gas={gas} "
                f"(train={train}, dp={dp})")
        if train != micro * gas * dp:
            raise ValueError(
                f"Check batch-size settings: train_batch_size {train} != "
                f"micro_batch {micro} × gradient_accumulation_steps {gas} × "
                f"data-parallel world {dp}")
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        if self.zero_config.stage > 3:
            raise ValueError(
                f"ZeRO stage {self.zero_config.stage} > 3 is invalid")


def refuse_unported_training(cfg: DeepSpeedConfig):
    """Raise ``NotImplementedError`` for every switched-on training
    section this port does not run yet, naming the ROADMAP.md item that
    brings it."""
    zc, mc = cfg.zero_config, cfg.mesh_config
    offload = [f"zero_optimization.{k}.device={sec.device!r}"
               for k, sec in (("offload_optimizer", zc.offload_optimizer),
                              ("offload_param", zc.offload_param))
               if sec is not None and sec.device != "none"]
    sizes = [f"mesh.{k}={getattr(mc, k)}"
             for k in ("model_parallel_size", "pipe_parallel_size",
                       "sequence_parallel_size", "expert_parallel_size",
                       "data_parallel_size")
             if (getattr(mc, k) or 1) > 1]
    quantized = [f"zero_optimization.{k}" for k in
                 ("zero_quantized_weights", "zero_quantized_gradients")
                 if getattr(zc, k)]
    checks = (
        (bool(cfg.resilience_config.faults), "resilience.faults",
         "Queue A: resilience"),
        (bool(offload), ", ".join(offload), "Queue A: offload"),
        (bool(quantized), ", ".join(quantized),
         "Queue A: remaining parallelism (ZeRO++)"),
        (bool(sizes), ", ".join(sizes),
         "Queue A: data parallel, ZeRO and model parallelism"),
        (_any_enabled(cfg.compression_config), "compression_training",
         "Queue A: data efficiency and compression"),
        (_any_enabled(cfg.curriculum_learning),
         "curriculum_learning.enabled",
         "Queue A: data efficiency and compression"),
        (_any_enabled(cfg.pld_config), "progressive_layer_drop.enabled",
         "Queue A: data efficiency and compression"),
        (_any_enabled(cfg.data_efficiency_config), "data_efficiency",
         "Queue A: data efficiency and compression"),
    )
    for on, what, item in checks:
        if on:
            raise NotImplementedError(
                f"{what}: not ported to deepspeed_tpu_torch yet "
                f"(ROADMAP.md {item}); the port trains on one device")
