"""Request lifecycle for the continuous-batching scheduler (counterpart
of ``deepspeed_tpu/serving/request.py``).

State machine::

    QUEUED --admit--> PREFILL --first token--> DECODE --eos/len--> FINISHED
      ^                                           |
      |            (pool pressure, recompute-on-resume)
      +---------------- EVICTED <-----------------+
    QUEUED --timeout / queue full / too long--> REJECTED

An evicted request returns to the queue carrying everything generated so
far; re-admission re-prefills prompt+generated and decoding continues
where it left off (sampling draws are keyed by (seed, absolute
position), so the resumed stream is the uninterrupted one).
"""
import enum
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    EVICTED = "evicted"
    REJECTED = "rejected"


class AdmissionError(Exception):
    """Graceful 429-style rejection (never crashes the serving loop)."""


class QueueFullError(AdmissionError):
    """serving.max_queued requests already waiting."""


class RequestTooLongError(AdmissionError):
    """prompt + max_new_tokens can never fit the block pool / model ctx."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling surface (mirrors InferenceEngine.generate)."""
    max_new_tokens: int = 16
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0


@dataclass
class ServeRequest:
    """One in-flight generation request; mutated only by the scheduler
    (under its lock) after submit()."""
    request_id: int
    prompt_ids: np.ndarray                   # int32 [S]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    priority: int = 0                        # higher = evicted later
    timeout_s: float = 0.0                   # 0 = never times out in queue
    #: ``serving.slo`` class; its priority orders admission/preemption
    slo_class: str = "default"
    arrival_time: float = field(default_factory=time.monotonic)

    # -- scheduler-owned runtime state ----------------------------------
    state: RequestState = RequestState.QUEUED
    #: when the request last ENTERED the queue (submit or eviction);
    #: timeout_s bounds queue wait, not total lifetime
    queued_at: float = field(default_factory=time.monotonic)
    output_ids: List[int] = field(default_factory=list)
    slot: int = -1                           # decode-batch row while active
    num_preemptions: int = 0
    reject_reason: Optional[str] = None
    t_first_token: Optional[float] = None    # monotonic; TTFT = - arrival
    t_finish: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)

    def __post_init__(self):
        self.prompt_ids = np.asarray(self.prompt_ids, np.int32).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError("empty prompt")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt_ids.size)

    @property
    def all_token_ids(self) -> np.ndarray:
        """prompt + everything generated so far (the resume prompt)."""
        return np.concatenate(
            [self.prompt_ids, np.asarray(self.output_ids, np.int32)])

    @property
    def num_generated(self) -> int:
        return len(self.output_ids)

    @property
    def remaining_new_tokens(self) -> int:
        return self.sampling.max_new_tokens - self.num_generated

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.arrival_time

    def record_token(self, tok: int):
        now = time.monotonic()
        if self.t_first_token is None:
            self.t_first_token = now
        self.token_times.append(now)
        self.output_ids.append(int(tok))

    def finished_by(self, tok: int) -> bool:
        eos = self.sampling.eos_token_id
        return ((eos is not None and tok == eos)
                or self.num_generated >= self.sampling.max_new_tokens)

    def to_response(self) -> dict:
        """JSON-ready summary (the /generate response body)."""
        out = {
            "request_id": self.request_id,
            "state": self.state.value,
            "output_ids": list(self.output_ids),
            "num_preemptions": self.num_preemptions,
        }
        if self.reject_reason is not None:
            out["reject_reason"] = self.reject_reason
        if self.ttft_s is not None:
            out["ttft_ms"] = round(self.ttft_s * 1e3, 3)
        if self.latency_s is not None:
            out["latency_ms"] = round(self.latency_s * 1e3, 3)
        return out
