"""Llama-family helpers (counterpart of ``deepspeed_tpu/models/llama.py``
``_rms_norm`` :151 and ``rope`` :157).  The Llama model itself comes with
a later slice (ROADMAP.md: other families); Mixtral uses these two."""
import torch


def _rms_norm(x, scale, eps):
    """RMSNorm in fp32, cast back to the input dtype (the reference's)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(theta: float, head_dim: int, device=None):
    """``theta ** (-arange(hd/2) / (hd/2))`` as the reference computes it
    (jnp with x64 off): the exponent is an fp32 division, and the power is
    the fp32 value nearest the exact one (XLA's fp32 ``pow`` is correctly
    rounded; torch's fp32 ``pow`` can miss by one ulp, so it is evaluated
    on the fp32 operands in double and rounded once).  Not Python floats:
    their float64 exponent is another number."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.int32, device=device) / half
    # theta rounded to fp32 on the host: a device tensor built from a
    # Python number would be a blocking copy on every call
    base = float(torch.tensor(theta, dtype=torch.float32))
    return torch.pow(base, expo.double()).float()


def rope(x, theta: float, positions=None, interleaved: bool = False):
    """Rotary embeddings on [B, S, H, hd] (the reference's ``rope``).
    ``interleaved=False`` pairs dim i with i + hd/2 (the split-half
    pairing of Llama / NeoX / Mixtral); ``interleaved=True`` pairs (2i,
    2i + 1).  ``positions``: [S] (shared across the batch) or [B, S] (per
    row, decode)."""
    B, S, H, hd = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    freqs = rope_freqs(theta, hd, x.device)
    if positions.dim() == 1:
        angles = positions[:, None] * freqs[None, :]             # [S, hd/2]
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    else:
        angles = positions[:, :, None] * freqs[None, None, :]    # [B, S, hd/2]
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(x.shape)
    else:
        x1, x2 = xf.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
