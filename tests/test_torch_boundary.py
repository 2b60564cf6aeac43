"""The port's boundary: deepspeed_tpu_torch and chip_smoke.py import no
JAX and nothing of the JAX package; entry points refuse to run on the
CPU unless asked; on CPU tensors no kernel launches; a missing nvcc is a
clear error; the CUDA sources are in the tree."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels import decode_attention as da
from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "deepspeed_tpu_torch"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "scripts").glob("torch_*.py"))


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "deepspeed_tpu" or name.startswith("deepspeed_tpu."))


def test_no_jax_imports_in_port_sources():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                names = [node.module]
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad
    assert len(_port_files()) > 20


def test_importing_every_port_module_loads_no_jax():
    code = """
import importlib, json, pkgutil, sys
import deepspeed_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "deepspeed_tpu" or m.startswith("deepspeed_tpu.")]
print(json.dumps({"modules": mods, "bad": bad}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for m in ("deepspeed_tpu_torch.serving.server",
              "deepspeed_tpu_torch.serving.scheduler",
              "deepspeed_tpu_torch.ops.kernels.build",
              "deepspeed_tpu_torch.checkpoint.jax_params",
              "deepspeed_tpu_torch.ops.kernels.grouped_gemm",
              "deepspeed_tpu_torch.moe.layer",
              "deepspeed_tpu_torch.moe.sharded_moe",
              "deepspeed_tpu_torch.models.mixtral",
              "deepspeed_tpu_torch.models.llama",
              "deepspeed_tpu_torch.models.neox",
              "deepspeed_tpu_torch.models.bloom",
              "deepspeed_tpu_torch.models.gptneo",
              "deepspeed_tpu_torch.models.bert",
              "deepspeed_tpu_torch.ops.sparse_attention",
              "deepspeed_tpu_torch.ops.kernels.block_sparse_attention"):
        assert m in res["modules"]


@pytest.mark.parametrize("module", [
    "ops.kernels.fused_decode", "ops.kernels.qgemm",
    "ops.kernels.quantization", "ops.kernels.decode_attention",
    "models.model", "serving.server", "ops.kernels.grouped_gemm",
    "moe.layer", "models.mixtral", "models.serving", "models.neox",
    "models.bloom", "models.gptneo", "ops.sparse_attention",
    "ops.kernels.block_sparse_attention", "models.bert", "ops.attention"])
def test_each_module_imports_on_its_own(module):
    """Imported first in a fresh interpreter (as chip_smoke.py and a user
    script may): no import cycle between the kernels and the models."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", f"import deepspeed_tpu_torch.{module}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    m = gpt2_model("custom", vocab_size=32, max_seq_len=16, num_layers=1,
                   num_heads=2, d_model=16, dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(m, {"dtype": "float32"})
    eng = deepspeed_tpu_torch.init_inference(m, {"dtype": "float32"},
                                             device="cpu")
    assert eng.params["wte"].device.type == "cpu"


def test_cpu_tensors_never_launch_kernels():
    da.decode_attention.launches = 0
    fa.flash_attention_fwd.launches = 0
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 64, generator=g)
    k = torch.randn(2, 16, 4, 64, generator=g)
    L = torch.tensor([3, 16], dtype=torch.int32)
    torch.testing.assert_close(da.decode_attention(q, k, k, L),
                               da.decode_attention_plain(q, k, k, L))
    qs = torch.randn(1, 20, 4, 64, generator=g)
    o, lse = fa.flash_attention_fwd(qs, qs, qs)
    ro, rl = fa.flash_attention_fwd_plain(qs, qs, qs)
    torch.testing.assert_close(o, ro)
    torch.testing.assert_close(lse, rl)
    assert da.decode_attention.launches == 0
    assert fa.flash_attention_fwd.launches == 0
    # the int8 wrappers: quantizer, qgemm, int8 decode
    from deepspeed_tpu_torch.ops.kernels import qgemm as qg
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    for fn in (qz.block_quantize_int8, qg.qgemm):
        fn.launches = 0
    da.decode_attention.int8_launches = 0
    q8, s8 = qz.block_quantize_int8(torch.randn(64, 96, generator=g))
    assert qg.qgemm(torch.randn(3, 64, generator=g), q8, s8).shape == \
        (3, 96)
    kq, ks = da.quantize_kv(k)
    da.decode_attention(q, kq, kq, L, k_scale=ks, v_scale=ks)
    assert qz.block_quantize_int8.launches == 0
    assert qg.qgemm.launches == 0
    assert da.decode_attention.int8_launches == 0
    # the grouped-GEMM wrappers
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    gg.ds_ggemm.launches = gg.ds_ggemm_slots.launches = 0
    eids = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    x, w = torch.randn(4, 16, generator=g), torch.randn(3, 16, 8, generator=g)
    plan = gg.make_group_plan(eids, 3)
    torch.testing.assert_close(
        gg.gather_from_groups(gg.ds_ggemm(gg.scatter_to_groups(x, plan), w,
                                          plan), plan),
        gg.ds_ggemm_slots(x, w, gg.make_slot_plan(eids, 3)))
    assert gg.ds_ggemm.launches == gg.ds_ggemm_slots.launches == 0
    # the block-sparse attention wrappers, forward and backward
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    for name in ("fwd", "dq", "dkv"):
        getattr(bs, f"block_sparse_attention_{name}").launches = 0
    qs = torch.randn(1, 32, 2, 64, generator=g, requires_grad=True)
    cfg = sa.BigBirdSparsityConfig(2, block=16)
    sa.sparse_self_attention(qs, qs, qs, cfg, causal=True,
                             impl="pallas").sum().backward()
    assert torch.isfinite(qs.grad).all()
    assert (bs.block_sparse_attention_fwd.launches
            == bs.block_sparse_attention_dq.launches
            == bs.block_sparse_attention_dkv.launches == 0)


def test_missing_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "torch_kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["decode_attention"])


def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    """Validation runs before any launch, so it is checkable here."""
    q = torch.zeros(2, 4, 24)
    k = torch.zeros(2, 8, 4, 24)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention_cuda(q, k, k, torch.zeros(2, dtype=torch.int32))
    qs = torch.zeros(1, 8, 4, 24)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd_cuda(qs, qs, qs)
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    plan = bs.BlockSparsePlan(np.ones((4, 1, 1), np.int64), True)
    with pytest.raises(NotImplementedError, match="head_dim 24"):
        bs.block_sparse_attention_fwd_cuda(qs, qs, qs, plan)


def test_cuda_sources_exist():
    for name in ("decode_attention", "ds_flash_fwd", "ds_flash_bwd",
                 "quantization", "qgemm", "fused_decode", "grouped_gemm",
                 "block_sparse_attention"):
        src = build.CSRC_DIR / f"{name}.cu"
        assert src.is_file(), src
        assert "extern \"C\"" in src.read_text()
    assert build.BUILD_DIR == ROOT / "build" / "torch_kernels"
