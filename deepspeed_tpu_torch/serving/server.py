"""Stdlib-only HTTP front-end for the continuous-batching scheduler
(counterpart of ``deepspeed_tpu/serving/server.py`` and ``bin/ds_serve``).

Endpoints:
  POST /generate  {"input_ids": [...], "max_new_tokens": 16,
                   "temperature": .., "top_k": .., "top_p": ..,
                   "do_sample": false, "eos_token_id": .., "seed": ..,
                   "priority": 0, "slo_class": "default"}
                  -> 200 {"request_id", "output_ids", "ttft_ms", ...}
                  -> 429 when the queue is full / the request times out
                  -> 400 for malformed bodies or impossible lengths
                  -> 503 while draining / degraded
  GET  /healthz   -> 200 {"state": "ready", "active": n, "queued": m}
                     (503 in any other state)
  GET  /metrics   -> Prometheus text: scheduler counters and gauges,
                     latency quantiles, kernel launch counts

The scheduler loop runs on one background thread; handler threads only
enqueue and wait on the request's done event.

Run it:
    python -m deepspeed_tpu_torch.serving.server --model gpt2:760m \\
        --dtype bfloat16 --port 8000
Mixtral-8x7B at all 32 layers on one 80 GB card: int8 weights (experts
through the int8 grouped GEMMs, projections and router through qgemm;
drawn on the card from a seed) and an int8 KV cache; a JSON config such
as ``{"serving": {"max_num_seqs": 96, "num_blocks": 1729,
"max_blocks_per_seq": 18}}`` (``--config``) serves a wide batch:
    python -m deepspeed_tpu_torch.serving.server --model mixtral:8x7b \\
        --int8-weights --kv-cache-dtype int8 --port 8000
Mixtral in bf16 (16 of the 32 layers fit one 80 GB card):
    python -m deepspeed_tpu_torch.serving.server --model mixtral:8x7b \\
        --num-layers 16 --port 8000
int8 weights (qgemm), an int8 KV cache and the fused per-layer decode:
    python -m deepspeed_tpu_torch.serving.server --model gpt2:760m \\
        --int8-weights --kv-cache-dtype int8 --fused-decode on
Llama-2 7B (all 32 layers, weights drawn on the card from a seed), with
the fused per-layer decode kernel (also on for Mixtral, whose experts
stay on the grouped kernels):
    python -m deepspeed_tpu_torch.serving.server --model llama:7b \\
        --fused-decode on --port 8000
GPT-NeoX-20B (all 44 layers, 41.1 GB of bf16 weights drawn on the card),
fused decode off or on, or with int8 weights and an int8 KV cache:
    python -m deepspeed_tpu_torch.serving.server --model neox:20b \\
        --fused-decode on --port 8000
BLOOM-560m (ALiBi: the decode kernel's ALiBi variant, or the fused
layer's BLOOM spec) and GPT-Neo 2.7B (its local layers' sliding window:
the decode kernel's windowed variant; fused decode is refused, as the
reference's kernel never fuses it):
    python -m deepspeed_tpu_torch.serving.server --model bloom:560m
    python -m deepspeed_tpu_torch.serving.server --model gptneo:2.7b
"""
import argparse
import enum
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from deepspeed_tpu_torch.serving.request import (AdmissionError,
                                                 QueueFullError,
                                                 SamplingParams)
from deepspeed_tpu_torch.utils.logging import logger


def model_from_spec(spec: str, **overrides):
    """``arch:size`` -> Model, e.g. ``gpt2:760m``, ``llama:7b``,
    ``mixtral:8x7b``, ``neox:20b``, ``bloom:560m``, ``gptneo:2.7b`` or
    ``bert:large`` (the reference's registry).  BERT has no KV-cache
    serving surface, so the scheduler refuses it, as the reference's."""
    from deepspeed_tpu_torch.models.bert import bert_model
    from deepspeed_tpu_torch.models.bloom import bloom_model
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.models.gptneo import gptneo_model
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.models.neox import neox_model
    registry = {"gpt2": gpt2_model, "llama": llama_model,
                "mixtral": mixtral_model, "neox": neox_model,
                "bloom": bloom_model, "gptneo": gptneo_model,
                "bert": bert_model}
    arch, _, size = spec.partition(":")
    if arch not in registry:
        raise ValueError(f"unknown model arch {arch!r}; "
                         f"choose from {sorted(registry)}")
    return registry[arch](size or "custom", **overrides)


def parse_generate_body(body: dict, default_timeout_s: float = 0.0):
    """Decode one ``/generate`` JSON body into scheduler submit args.
    Raises KeyError/TypeError/ValueError on malformed bodies (-> 400)."""
    sampling = SamplingParams(
        max_new_tokens=int(body.get("max_new_tokens", 16)),
        do_sample=bool(body.get("do_sample", False)),
        temperature=float(body.get("temperature", 1.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        eos_token_id=body.get("eos_token_id"),
        seed=int(body.get("seed", 0)))
    return {
        "input_ids": body["input_ids"],
        "sampling": sampling,
        "priority": int(body.get("priority", 0)),
        "timeout_s": float(body.get("timeout_s", default_timeout_s)),
        "slo_class": str(body.get("slo_class", "default")),
    }


class HealthState(enum.Enum):
    STARTING = "starting"
    READY = "ready"
    DRAINING = "draining"
    DEGRADED = "degraded"
    STOPPED = "stopped"


class Health:
    """Minimal server health state: starting -> ready -> draining ->
    stopped, or degraded (step failures / a stalled loop)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.state = HealthState.STARTING
        self.reason = ""
        self.since = time.monotonic()

    def _set(self, state: HealthState, reason: str = ""):
        with self._lock:
            if self.state is not state:
                logger.info(f"health: {self.state.value} -> {state.value}"
                            + (f" ({reason})" if reason else ""))
            self.state, self.reason = state, reason
            self.since = time.monotonic()

    def mark_ready(self):
        self._set(HealthState.READY)

    def begin_drain(self, reason: str = ""):
        if self.state is HealthState.READY:
            self._set(HealthState.DRAINING, reason)

    def mark_degraded(self, reason: str):
        self._set(HealthState.DEGRADED, reason)

    def mark_stopped(self, reason: str = ""):
        self._set(HealthState.STOPPED, reason)

    def is_accepting(self) -> bool:
        return self.state is HealthState.READY

    def http_status(self) -> int:
        return 200 if self.state is HealthState.READY else 503

    def snapshot(self) -> dict:
        return {"state": self.state.value, "reason": self.reason,
                "since_s": round(time.monotonic() - self.since, 3)}


class ServingLoop:
    """Background thread driving ``scheduler.step()``; idles when
    drained.  ``max_loop_failures`` consecutive step exceptions, or
    pending work with ``step_count`` frozen for ``stall_timeout_s``, turn
    health DEGRADED; during a drain the loop steps until the scheduler is
    empty, then stops."""

    IDLE_SLEEP_S = 0.002
    FAILURE_SLEEP_S = 0.1

    def __init__(self, scheduler, health=None):
        self.scheduler = scheduler
        self.health = health if health is not None else Health()
        cfg = scheduler.cfg
        self.max_loop_failures = cfg.max_loop_failures
        self.stall_timeout_s = cfg.resolved_stall_timeout_s()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ds-serve-loop")
        self._watchdog = threading.Thread(target=self._watch, daemon=True,
                                          name="ds-serve-watchdog")

    def start(self):
        self._thread.start()
        if self.stall_timeout_s > 0:
            self._watchdog.start()
        self.health.mark_ready()
        return self

    def join(self, timeout=None):
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def _run(self):
        failures = 0
        sched = self.scheduler
        while not self._stop.is_set():
            if (self.health.state is HealthState.DRAINING
                    and not sched.has_work()):
                self.health.mark_stopped("drained")
                break
            if not sched.has_work():
                time.sleep(self.IDLE_SLEEP_S)
                continue
            try:
                sched.step()
                failures = 0
            except Exception:
                failures += 1
                sched.metrics.counters["loop_failures"] += 1
                logger.exception("serving loop: step failed "
                                 f"({failures} consecutive)")
                if self.max_loop_failures and \
                        failures >= self.max_loop_failures:
                    self.health.mark_degraded(
                        f"{failures} consecutive step failures")
                    break
                time.sleep(self.FAILURE_SLEEP_S)

    def _watch(self):
        sched = self.scheduler
        last, t_last = sched.step_count, time.monotonic()
        while not self._stop.wait(min(1.0, self.stall_timeout_s / 4)):
            now = time.monotonic()
            if sched.step_count != last or not sched.has_work():
                last, t_last = sched.step_count, now
            elif now - t_last > self.stall_timeout_s:
                self.health.mark_degraded(
                    f"no scheduler step for {now - t_last:.1f}s with work "
                    "pending")
                return

    def shutdown(self):
        self._stop.set()
        for t in (self._thread, self._watchdog):
            if t.ident is not None:
                t.join(timeout=5)


class _Handler(BaseHTTPRequestHandler):
    scheduler = None            # injected by make_server
    health = None
    default_timeout_s = 0.0

    def log_message(self, fmt, *args):
        logger.debug("serve: " + fmt % args)

    def _send(self, code: int, body: bytes, ctype: str, headers=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: dict, headers=None):
        self._send(code, json.dumps(payload).encode(), "application/json",
                   headers)

    def do_GET(self):
        sched = self.scheduler
        if self.path == "/healthz":
            self._send_json(self.health.http_status(), {
                **self.health.snapshot(),
                "active": len(sched.active_requests()),
                "queued": sched.queue_depth(),
                "step_count": sched.step_count})
            return
        if self.path == "/metrics":
            self._send(200, sched.render_metrics().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
            return
        self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/generate":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        sched = self.scheduler
        if not self.health.is_accepting():
            sched.metrics.counters["rejected_not_accepting"] += 1
            self._send_json(503, {"error": "not accepting requests: "
                                           f"{self.health.state.value}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            parsed = parse_generate_body(body, self.default_timeout_s)
            req = sched.submit(parsed["input_ids"], parsed["sampling"],
                               priority=parsed["priority"],
                               timeout_s=parsed["timeout_s"],
                               slo_class=parsed["slo_class"])
        except QueueFullError as e:
            self._send_json(429, {"error": str(e)}, headers={
                "Retry-After": str(max(1, round(sched.retry_after_s)))})
            return
        except AdmissionError as e:
            self._send_json(400, {"error": str(e)})
            return
        except (KeyError, TypeError, ValueError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        # timeout_s bounds QUEUE wait (the scheduler's expiry path); an
        # admitted request may legitimately decode for a long time
        while not req.done.wait(timeout=1.0):
            if self.health.state is HealthState.DEGRADED:
                self._send_json(503, {"error": "serving loop degraded: "
                                               f"{self.health.reason}"})
                return
        resp = req.to_response()
        self._send_json(429 if req.reject_reason is not None else 200, resp)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    #: listen backlog: a burst of clients as wide as the scheduler's queue
    #: waits in the kernel's accept queue instead of being reset
    #: (socketserver's default is 5 connections)
    request_queue_size = 128


def make_server(scheduler, host: str = "127.0.0.1", port: int = 8000,
                default_timeout_s: float = 0.0):
    """(ThreadingHTTPServer, ServingLoop) — the caller starts and stops
    both; ``port=0`` binds an ephemeral port."""
    loop = ServingLoop(scheduler)
    handler = type("Handler", (_Handler,),
                   {"scheduler": scheduler, "health": loop.health,
                    "default_timeout_s": default_timeout_s})
    return _HTTPServer((host, port), handler), loop


def serve_forever(scheduler, host: str = "127.0.0.1", port: int = 8000,
                  default_timeout_s: float = 0.0):
    """Serve until SIGTERM/SIGINT: the first signal drains (new requests
    503, admitted ones finish), a second one stops at once."""
    httpd, loop = make_server(scheduler, host, port, default_timeout_s)
    health = loop.health
    loop.start()

    def _stop_http():
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    def _on_signal(signum, frame):
        if health.state is HealthState.READY:
            health.begin_drain(f"signal {signum}")
        else:
            _stop_http()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)

    def _await_loop_exit():
        loop._thread.join()
        if health.state is HealthState.STOPPED:
            _stop_http()

    threading.Thread(target=_await_loop_exit, daemon=True).start()
    logger.info(f"serve: listening on http://{host}:{httpd.server_port} "
                f"(pool={scheduler.cfg.num_blocks}x"
                f"{scheduler.cfg.block_size} tokens, "
                f"max_num_seqs={scheduler.cfg.max_num_seqs})")
    try:
        httpd.serve_forever()
    finally:
        loop.shutdown()
        health.mark_stopped()
        httpd.server_close()


def build_parser() -> argparse.ArgumentParser:
    """The server's command line (the reference's ``bin/ds_serve``
    spelling for the flags it shares)."""
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.serving.server",
        description="deepspeed_tpu_torch continuous-batching inference "
                    "server (paged KV cache, CUDA decode and flash "
                    "attention kernels)")
    p.add_argument("--model", default="gpt2:125m",
                   help="arch:size spec (gpt2:760m, llama:7b, "
                        "mixtral:8x7b, neox:20b, neox:pythia-160m, "
                        "bloom:560m, gptneo:2.7b, ...)")
    p.add_argument("--config", default=None,
                   help="DS-style JSON config; its 'serving' section "
                        "configures the scheduler")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--dtype", default="bfloat16",
                   help="compute dtype (bfloat16 or float32)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--kv-cache-dtype", default=None, choices=["int8"],
                   help="int8 = quantized KV-cache pool (half the decode "
                        "bandwidth; the int8 decode-attention kernel)")
    p.add_argument("--int8-weights", action="store_true",
                   help="weight-only int8 serving (quant.enabled): decode "
                        "projections through the fused-dequant qgemm "
                        "kernel, MoE experts through the int8 grouped "
                        "GEMMs")
    p.add_argument("--num-layers", type=int, default=None,
                   help="override the model's depth (e.g. 16 for bf16 "
                        "mixtral:8x7b on one 80 GB card; with "
                        "--int8-weights all 32 layers fit)")
    p.add_argument("--fused-decode", default=None, choices=["on", "off"],
                   help="fused per-layer decode kernel (overrides the "
                        "'serving.fused_decode' config key): one launch "
                        "per layer per decode step; default off; refused "
                        "for gptneo (windowed layers) and GPT-J's "
                        "interleaved rotary")
    return p


def build_scheduler(args, model=None):
    """Engine and scheduler for parsed ``args``; ``model`` overrides the
    ``--model`` spec (built with ``--dtype``).  Returns the scheduler."""
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving.scheduler import \
        ContinuousBatchingScheduler

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    serving_cfg = ServingConfig(**raw.get("serving", {}))
    if args.fused_decode is not None:
        serving_cfg.fused_decode = args.fused_decode == "on"
    if model is None:
        depth = {} if args.num_layers is None \
            else {"num_layers": args.num_layers}
        model = model_from_spec(args.model, dtype=args.dtype, **depth)
    eng = InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype=args.dtype, kv_cache_dtype=args.kv_cache_dtype,
        quant={"enabled": args.int8_weights}), device=args.device)
    return ContinuousBatchingScheduler(model, eng.params, serving_cfg,
                                       kv_cache_dtype=args.kv_cache_dtype)


def main(argv=None):
    args = build_parser().parse_args(argv)
    sched = build_scheduler(args)
    serve_forever(sched, host=args.host, port=args.port,
                  default_timeout_s=sched.cfg.request_timeout_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
