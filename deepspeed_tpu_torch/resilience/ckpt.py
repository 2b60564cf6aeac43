"""Crash-safe checkpoint protocol (a copy of
``deepspeed_tpu/resilience/ckpt.py``, without its fault-injection hooks,
which wait on ROADMAP.md Queue A: resilience).

The durability contract:

1. A tag is staged under ``<tag>.tmp``: the state, the metadata and
   finally a *manifest* recording the step, every leaf's shape / dtype
   (+ optional crc32) and the on-disk file inventory.  The manifest is
   fsynced before the tag is published.
2. Publication is a single ``os.replace(<tag>.tmp, <tag>)``: a crash at
   any earlier point leaves only a ``.tmp`` directory, which readers
   never take for a tag.
3. The ``latest`` pointer is itself written tmp + ``os.replace``.
4. :func:`find_valid_tag` resolves what to load: the newest (by manifest
   step) tag that passes verification, the ``latest`` pointer being
   trusted only when it names that tag.  A torn pointer or a corrupted
   tag delays a restore by one checkpoint but never fails it while any
   valid tag exists.
5. :func:`gc_tags` keeps the newest ``keep_last_k`` *valid* tags (plus
   the tag just published and whatever ``latest`` names).

Leaves are flat: ``{key: array}`` with the JAX package's key strings
(``runtime/checkpoint_engine/engine.py``), so a manifest's keys and its
fp32 leaves' crc32s are the ones the JAX package writes for the same
state.
"""
import json
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger

MANIFEST_FILE = "ds_manifest.json"
LATEST_FILE = "latest"
TMP_SUFFIX = ".tmp"
#: the JAX package's names (runtime/checkpoint_engine/engine.py)
METADATA_FILE = "ds_metadata.json"
STATE_DIR = "state"


class CheckpointCorruptError(RuntimeError):
    """No tag under the checkpoint root passed manifest verification (or a
    requested tag failed it)."""


# ------------------------------------------------------------------ fs io
def fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes):
    """Durable publish of a small file: tmp in the same directory, fsync,
    ``os.replace``, fsync the directory."""
    tmp = path + TMP_SUFFIX
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        fsync_path(os.path.dirname(path) or ".")
    except OSError:          # some filesystems refuse directory fsync
        pass


# ---------------------------------------------------------------- manifest
def dtype_name(arr: np.ndarray) -> str:
    """The JAX package's dtype string of a leaf: a 2-byte void leaf is
    bf16 (numpy has no bf16; the npz engines store its words as V2)."""
    return "bfloat16" if arr.dtype.kind == "V" and arr.itemsize == 2 \
        else str(arr.dtype)


def leaf_summary(flat: Dict[str, np.ndarray],
                 checksums: bool = True) -> Dict[str, Dict]:
    """Per-leaf shape / dtype (+ crc32 of the raw little-endian bytes)
    keyed by the leaf's path, from host arrays.  The checksums run on a
    few threads (zlib releases the GIL over large buffers)."""
    def crc(arr):
        return zlib.crc32(
            np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    arrs = {key: np.asarray(arr) for key, arr in flat.items()}
    crcs = {}
    if checksums:
        with ThreadPoolExecutor(max_workers=min(
                8, os.cpu_count() or 1)) as pool:
            crcs = dict(zip(arrs, pool.map(crc, arrs.values())))
    return {key: {"shape": list(arr.shape), "dtype": dtype_name(arr),
                  "crc32": crcs.get(key)} for key, arr in arrs.items()}


def _inventory(ckpt_dir: str, skip: Tuple[str, ...] = (MANIFEST_FILE,)
               ) -> Dict[str, int]:
    """relpath -> size of every regular file under the tag dir (the
    manifest itself excluded)."""
    inv = {}
    for root, _dirs, files in os.walk(ckpt_dir):
        for name in files:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, ckpt_dir)
            if rel in skip:
                continue
            inv[rel] = os.path.getsize(full)
    return inv


def write_manifest(ckpt_dir: str, step: int, tag: str,
                   leaves: Dict[str, Dict]):
    """Fsynced manifest over everything already staged in ``ckpt_dir``.
    Must be the LAST write before the tag is published."""
    manifest = {"version": 1, "tag": str(tag), "step": int(step),
                "leaves": leaves, "files": _inventory(ckpt_dir)}
    atomic_write_bytes(os.path.join(ckpt_dir, MANIFEST_FILE),
                       json.dumps(manifest, indent=1).encode())


def read_manifest(ckpt_dir: str) -> Optional[Dict]:
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def verify_tag(ckpt_dir: str) -> Tuple[bool, str]:
    """Structural verification: the manifest parses and every file it
    inventories is present with the recorded size.  A tag without a
    manifest but with a state verifies as legacy-valid."""
    if not os.path.isdir(ckpt_dir):
        return False, "missing tag directory"
    try:
        manifest = read_manifest(ckpt_dir)
    except (json.JSONDecodeError, OSError) as e:
        return False, f"unreadable manifest: {e}"
    if manifest is None:
        if os.path.isdir(os.path.join(ckpt_dir, STATE_DIR)) or \
                os.path.exists(os.path.join(ckpt_dir, STATE_DIR + ".npz")):
            return True, "legacy tag (no manifest)"
        return False, "no manifest and no state"
    if not isinstance(manifest.get("files"), dict):
        return False, "manifest missing file inventory"
    for rel, size in manifest["files"].items():
        full = os.path.join(ckpt_dir, rel)
        if not os.path.exists(full):
            return False, f"missing file {rel}"
        actual = os.path.getsize(full)
        if actual != size:
            return False, f"size mismatch {rel}: {actual} != {size}"
    return True, "ok"


def verify_restored(flat: Dict[str, np.ndarray],
                    manifest: Optional[Dict]) -> List[str]:
    """Deep verification: crc32 of every restored leaf against the
    manifest (``resilience.verify_checkpoint: "full"``); the mismatches
    (empty: clean)."""
    if not manifest or not manifest.get("leaves"):
        return []
    recorded = manifest["leaves"]
    mismatches = []
    for key, entry in leaf_summary(flat, checksums=True).items():
        want = recorded.get(key)
        if want is None:
            mismatches.append(f"leaf {key} missing from manifest")
        elif want.get("crc32") is not None \
                and want["crc32"] != entry["crc32"]:
            mismatches.append(f"leaf {key} checksum mismatch")
    return mismatches


# ------------------------------------------------------------- tag lookup
def tag_step(load_dir: str, tag: str) -> int:
    """Ordering key for fallback: manifest step, else metadata step, else
    -1 (legacy tags sort last)."""
    ckpt_dir = os.path.join(load_dir, tag)
    try:
        manifest = read_manifest(ckpt_dir)
        if manifest is not None and isinstance(manifest.get("step"), int):
            return manifest["step"]
    except (json.JSONDecodeError, OSError):
        pass
    meta = os.path.join(ckpt_dir, METADATA_FILE)
    if os.path.exists(meta):
        try:
            with open(meta) as f:
                return int(json.load(f).get("global_steps", -1))
        except (json.JSONDecodeError, OSError, TypeError, ValueError):
            pass
    return -1


def list_tags(load_dir: str) -> List[str]:
    """Published (non-``.tmp``) tag directories under the root;
    ``postmortem-*`` bundles are never tags."""
    if not os.path.isdir(load_dir):
        return []
    return sorted(
        name for name in os.listdir(load_dir)
        if os.path.isdir(os.path.join(load_dir, name))
        and not name.endswith(TMP_SUFFIX)
        and not name.startswith("postmortem-"))


def read_latest(load_dir: str) -> Optional[str]:
    path = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            tag = f.read().strip()
    except (OSError, UnicodeDecodeError):
        return None
    return tag or None


def publish_latest(save_dir: str, tag: str):
    atomic_write_bytes(os.path.join(save_dir, LATEST_FILE),
                       str(tag).encode())


def find_valid_tag(load_dir: str) -> Optional[str]:
    """The tag to restore: the newest (by manifest step) tag that passes
    verification; ``latest`` is trusted only when it names that tag.
    None when the root holds no tags; :class:`CheckpointCorruptError`
    when tags exist but none verify."""
    tags = list_tags(load_dir)
    if not tags:
        return None
    latest = read_latest(load_dir)
    candidates = sorted(tags, key=lambda t: (tag_step(load_dir, t), t),
                        reverse=True)
    for tag in candidates:
        ok, reason = verify_tag(os.path.join(load_dir, tag))
        if ok:
            if tag != latest:
                if latest is not None and \
                        verify_tag(os.path.join(load_dir, latest))[0]:
                    logger.warning(
                        f"checkpoint: 'latest' -> {latest!r} is stale; "
                        f"restoring newer valid tag {tag!r} "
                        f"(step {tag_step(load_dir, tag)})")
                else:
                    logger.warning(
                        f"checkpoint: 'latest' -> {latest!r} is missing, "
                        f"torn, or corrupt; restoring newest valid tag "
                        f"{tag!r} (step {tag_step(load_dir, tag)})")
            return tag
        logger.warning(f"checkpoint: skipping tag {tag!r}: {reason}")
    raise CheckpointCorruptError(
        f"no tag under {load_dir} passed manifest verification "
        f"(checked {candidates})")


# -------------------------------------------------------------- retention
def gc_tags(save_dir: str, keep_last_k: int, protect: Tuple[str, ...] = ()):
    """Delete all but the newest ``keep_last_k`` VALID tags.  Invalid
    tags do not count against the budget; protected tags (the one just
    published, whatever ``latest`` names) are never removed.  Stale
    ``.tmp`` staging dirs are swept too."""
    if keep_last_k <= 0:
        return
    protected = set(protect)
    latest = read_latest(save_dir)
    if latest:
        protected.add(latest)
    valid = [t for t in list_tags(save_dir)
             if verify_tag(os.path.join(save_dir, t))[0]]
    valid.sort(key=lambda t: (tag_step(save_dir, t), t), reverse=True)
    for tag in valid[keep_last_k:]:
        if tag in protected:
            continue
        logger.info(f"checkpoint: retention (keep_last_k={keep_last_k}) "
                    f"removing tag {tag!r}")
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
    if os.path.isdir(save_dir):
        for name in os.listdir(save_dir):
            full = os.path.join(save_dir, name)
            if name.endswith(TMP_SUFFIX) and os.path.isdir(full) \
                    and name[:-len(TMP_SUFFIX)] not in protected:
                shutil.rmtree(full, ignore_errors=True)
