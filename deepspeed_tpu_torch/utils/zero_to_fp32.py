"""zero_to_fp32: offline fp32 consolidation of a checkpoint (counterpart
of ``deepspeed_tpu/utils/zero_to_fp32.py``).

The port's checkpoints are the JAX package's flat-npz layout
(``runtime/checkpoint_engine/engine.py``): one ``<tag>/state.npz`` whose
``params/...`` leaves are the model's params (fp32 masters, or bf16
masters stored as their 2-byte words).  With one device nothing is
partitioned, so consolidation is reading those leaves and widening them
to fp32.  The JAX tool reads Orbax trees instead; both write the same
output.

CLI:
    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_root> \\
        <out.npz> [--tag TAG]

The output is a flat npz: one entry per parameter leaf keyed by its tree
path ("blocks/qkv_w", ...), all fp32, loadable with numpy alone.
"""
import argparse
import os
import sys

import numpy as np

PARAMS = "params/"


def _resolve_tag(checkpoint_root: str, tag=None) -> str:
    if tag is None:
        latest = os.path.join(checkpoint_root, "latest")
        if not os.path.exists(latest):
            raise FileNotFoundError(
                f"no 'latest' file in {checkpoint_root}; pass --tag")
        with open(latest) as f:
            tag = f.read().strip()
    return os.path.join(checkpoint_root, str(tag))


def to_fp32(arr: np.ndarray) -> np.ndarray:
    """A leaf as fp32: bf16 words (a 2-byte void leaf) widened by placing
    them in the high half of an fp32 word (exact), other floats cast."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.itemsize == 2:
        words = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32)
        return (words << 16).view(np.float32)
    return arr.astype(np.float32)


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_root: str,
                                             tag=None) -> dict:
    """{param_path: fp32 ndarray} of the checkpoint's params."""
    ckpt_dir = _resolve_tag(checkpoint_root, tag)
    with np.load(os.path.join(ckpt_dir, "state.npz")) as data:
        return {k[len(PARAMS):]: to_fp32(data[k]) for k in data.files
                if k.startswith(PARAMS)}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_root: str,
                                               output_file: str, tag=None):
    flat = get_fp32_state_dict_from_zero_checkpoint(checkpoint_root, tag)
    np.savez(output_file, **flat)
    total = sum(int(np.prod(v.shape)) for v in flat.values())
    print(f"zero_to_fp32: wrote {len(flat)} tensors ({total / 1e6:.1f}M "
          f"params, fp32) to {output_file}")
    return flat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint_root")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_root, args.output_file, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
