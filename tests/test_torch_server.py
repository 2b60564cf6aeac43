"""deepspeed_tpu_torch HTTP front-end on a thread, tiny GPT-2 on the CPU:
``POST /generate`` returns the scheduler's tokens, ``/healthz`` and
``/metrics`` answer, bad requests are 4xx, a drain stops the loop."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.config import ServingConfig
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from deepspeed_tpu_torch.serving.server import (HealthState, make_server,
                                                model_from_spec,
                                                parse_generate_body)


def _tiny():
    return model_from_spec("gpt2:custom", vocab_size=128, max_seq_len=64,
                           num_layers=2, num_heads=4, d_model=32,
                           dtype="float32")


@pytest.fixture(scope="module")
def server():
    model = _tiny()
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"},
                                             device="cpu")
    sched = ContinuousBatchingScheduler(
        model, eng.params, ServingConfig(block_size=8, num_blocks=32,
                                         max_num_seqs=4, max_queued=8))
    httpd, loop = make_server(sched, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}", eng, loop
    httpd.shutdown()
    loop.shutdown()
    httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_generate_returns_the_schedulers_tokens(server):
    base, eng, _ = server
    prompts = [np.random.default_rng(s).integers(1, 128, (n,)).tolist()
               for s, n in ((1, 5), (2, 11), (3, 3))]
    results = [None] * len(prompts)

    def worker(i):
        results[i] = _post(base + "/generate",
                           {"input_ids": prompts[i], "max_new_tokens": 6})

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for p, (code, body) in zip(prompts, results):
        assert code == 200 and body["state"] == "finished"
        ref = eng.generate(np.asarray(p)[None], max_new_tokens=6)[0, len(p):]
        assert body["output_ids"] == ref.tolist()
        assert body["ttft_ms"] > 0


def test_sampled_request_repeats(server):
    base, _, _ = server
    body = {"input_ids": [5, 6, 7, 8], "max_new_tokens": 8,
            "do_sample": True, "seed": 77, "temperature": 1.3}
    a = _post(base + "/generate", body)
    b = _post(base + "/generate", body)
    assert a[0] == b[0] == 200
    assert a[1]["output_ids"] == b[1]["output_ids"]


def test_healthz_and_metrics(server):
    base, _, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert r.status == 200
        assert json.loads(r.read())["state"] == "ready"
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE serving_generated_tokens counter" in text
    assert 'kernel_launches{kernel="decode_attention"} 0' in text
    assert 'kernel_launches{kernel="ds_flash_fwd"} 0' in text


def test_bad_requests_are_4xx(server):
    base, _, _ = server
    assert _post(base + "/generate", {"max_new_tokens": 2})[0] == 400
    code, body = _post(base + "/generate",
                       {"input_ids": list(range(1, 60)),
                        "max_new_tokens": 30})
    assert code == 400 and "exceeds serving capacity" in body["error"]
    code, body = _post(base + "/generate", {"input_ids": [3, 128]})
    assert code == 400 and "[0, 128)" in body["error"]
    assert _post(base + "/nope", {})[0] == 404


def test_parse_generate_body_defaults():
    parsed = parse_generate_body({"input_ids": [1, 2]}, 3.0)
    assert parsed["sampling"].max_new_tokens == 16
    assert parsed["timeout_s"] == 3.0
    assert parsed["slo_class"] == "default"


def test_unported_arch_refused():
    """Every arch of the reference's registry builds (BERT since it was
    ported); another arch raises, and the scheduler refuses BERT, which
    has no KV-cache serving surface (as the reference's does)."""
    with pytest.raises(ValueError, match="unknown model arch"):
        model_from_spec("t5:small")
    bert = model_from_spec("bert:custom", vocab_size=64, max_seq_len=16,
                           num_layers=1, num_heads=2, d_model=32)
    params = bert.init(0, "cpu")
    with pytest.raises(ValueError, match="KV-cache serving surface"):
        ContinuousBatchingScheduler(bert, params, ServingConfig())


def test_drain_stops_the_loop():
    model = _tiny()
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"},
                                             device="cpu")
    sched = ContinuousBatchingScheduler(model, eng.params,
                                        ServingConfig(num_blocks=16))
    httpd, loop = make_server(sched, port=0)
    loop.start()
    try:
        assert loop.health.state is HealthState.READY
        loop.health.begin_drain("test")
        assert loop.join(timeout=10)
        assert loop.health.state is HealthState.STOPPED
    finally:
        loop.shutdown()
        httpd.server_close()
