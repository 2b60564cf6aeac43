"""deepspeed_tpu_torch kernel build (``ops/kernels/build.py``) with nvcc
stubbed, so nothing compiles: a library listed in ``build.PARTS`` (the
fused decode layer) is compiled in pieces, each its own nvcc ``-c``
started together with the other sources, then linked into one library;
a single-source library still compiles straight to its library; the
library's hash follows every piece; a failed piece raises naming it and
leaves no library; the fused layer's eight dtype instances are the eight
the entry source dispatches to."""
import itertools
import re
import shutil
from pathlib import Path

import pytest

from deepspeed_tpu_torch.ops.kernels import build


class _Proc:
    """A stand-in nvcc: writes its -o file, prints a ptxas-like line and
    exits 1 for a command naming ``fail``, else 0."""

    def __init__(self, cmd, fail=None):
        self.cmd = cmd
        self.returncode = 1 if fail and any(fail in c for c in cmd) else 0

    def communicate(self):
        if self.returncode == 0:
            Path(self.cmd[self.cmd.index("-o") + 1]).write_bytes(b"x")
        return "ptxas info    : Used 8 registers", None


class _Nvcc:
    """The commands started (``cmds``) and the text naming the one that
    fails (``fail``)."""

    def __init__(self):
        self.cmds, self.fail = [], None

    def __call__(self, cmd, **kw):
        self.cmds.append(cmd)
        return _Proc(cmd, self.fail)


@pytest.fixture
def nvcc(monkeypatch, tmp_path):
    stub = _Nvcc()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: "/stub/nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", stub)
    monkeypatch.setattr(build, "build_log", {})
    return stub


def test_parts_compile_apart_then_link(nvcc, tmp_path):
    out = build.build(["fused_decode", "qgemm"])
    cmds = nvcc.cmds
    assert all(p.exists() and p.parent == tmp_path for p in out.values())
    compiles, link = cmds[:-1], cmds[-1]
    qgemm = [c for c in compiles if c[-1].endswith("qgemm.cu")]
    assert len(qgemm) == 1 and "-shared" in qgemm[0] and "-c" not in qgemm[0]
    pieces = [c for c in compiles if "-c" in c]
    assert len(pieces) == 9 and all("-shared" not in c for c in pieces)
    srcs = sorted(Path(c[-1]).name for c in pieces)
    assert srcs == ["fused_decode.cu"] + ["fused_decode_layer.cu"] * 8
    defines = {tuple(f for f in c if f.startswith("-DDS_FUSED"))
               for c in pieces}
    assert len(defines) == 9          # the entry source's () and 8 sets
    # the link after every piece: one library from the nine objects
    assert link[1] == "-shared" and len([a for a in link
                                         if a.endswith(".o")]) == 9
    assert not list(tmp_path.glob("*.o"))          # objects removed
    assert set(build.build_log) == {
        "qgemm", "fused_decode", "fused_decode (link)",
        *(tag for tag, _, _ in build.PARTS["fused_decode"])}
    n = len(cmds)
    build.build(["fused_decode", "qgemm"])         # built: nothing to do
    assert len(cmds) == n


def test_a_failed_piece_raises_and_leaves_no_library(nvcc, tmp_path):
    """The failed piece's library is neither linked nor kept; a library
    built beside it is kept, as when every library is one source."""
    nvcc.fail = "DS_FUSED_BF16=1"
    with pytest.raises(RuntimeError, match=r"fused_decode_layer\[bf16"):
        build.build(["fused_decode", "qgemm"])
    assert not any(c[1] == "-shared" for c in nvcc.cmds)   # no link
    assert [p.name.split("-")[0] for p in tmp_path.glob("*.so")] == ["qgemm"]
    assert not list(tmp_path.glob("*.o"))
    assert not list(tmp_path.glob("*.tmp"))


def test_the_hash_follows_every_piece(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {n: build._target(n) for n in ("fused_decode", "qgemm")}
    layer = csrc / "fused_decode_layer.cu"
    layer.write_text(layer.read_text() + "\n// edited\n")
    assert build._target("fused_decode") != before["fused_decode"]
    assert build._target("qgemm") == before["qgemm"]


def test_fused_instances_are_the_dispatched_ones():
    """PARTS compiles each (compute, weight, cache) combination once, and
    fused_decode.cu declares exactly those eight instances."""
    flags = [dict(re.match(r"-D(\w+)=(\d)", f).groups() for f in fl)
             for _, src, fl in build.PARTS["fused_decode"]]
    assert all(src == "fused_decode_layer"
               for _, src, _ in build.PARTS["fused_decode"])
    combos = {(int(f["DS_FUSED_BF16"]), int(f["DS_FUSED_W8"]),
               int(f["DS_FUSED_C8"])) for f in flags}
    assert combos == set(itertools.product((0, 1), repeat=3))
    entry = (build.CSRC_DIR / "fused_decode.cu").read_text()
    declared = re.findall(r"^DS_FUSED_INSTANCE\((\w+), (\w+), (\w+)\)$",
                          entry, re.M)
    t = {0: "float", 1: "__nv_bfloat16"}
    assert sorted(declared) == sorted(
        (t[b], "int8_t" if w else t[b], "int8_t" if c else t[b])
        for b, w, c in combos)
    layer = (build.CSRC_DIR / "fused_decode_layer.cu").read_text()
    for name in ("DS_FUSED_BF16", "DS_FUSED_W8", "DS_FUSED_C8"):
        assert name in layer
