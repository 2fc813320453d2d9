"""Flash attention on Hopper: hand-written CUDA forward, dQ and dK/dV.

Port of ``dlrover_tpu/ops/pallas/flash_attention.py``.  The three kernels
live in ``dlrover_tpu_torch/csrc/flash_attention.cu`` (its header gives the
bound and the design: all three are warp-specialised wgmma + TMA
kernels); this module holds, beside each kernel:

* its plain PyTorch version (``*_plain``): the same function written as
  whole-matrix fp32 math with the same mask fill and the same ``l == 0``
  guard.  A wrapper takes it only for tensors on the CPU;
* its wrapper (``flash_forward``, ``flash_bwd_dq``, ``flash_bwd_dkv``): on
  a CUDA tensor it launches the kernel or raises, and adds one to
  ``launches[<kernel>]`` per launch;
* ``FlashAttention``, the ``torch.autograd.Function`` that mirrors the
  Pallas ``custom_vjp`` (``_fwd``/``_bwd``).

Layouts follow the TPU module: q/out ``[B, S, H, D]``, k/v
``[B, S, H_kv, D]``, the LSE residual ``[B*H, S]`` fp32.  delta =
rowsum(dO * O) is plain torch outside the kernels, as in ``_flash_backward``.
GQA: the kernels read k/v through the head map (q head h reads kv head
h // groups, no expanded copy); dK/dV come out per q head and the backward
sums them over each group, which is the TPU ``_bwd``'s expand-then-sum.
"""

import ctypes
from typing import Tuple

import torch

from dlrover_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
KERNEL_SOURCE = "flash_attention"
HEAD_DIMS = (64, 128)

# launches per kernel since the last reset_launches()
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held against)
# ---------------------------------------------------------------------------


def _expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    groups = heads // x.shape[2]
    return x.repeat_interleave(groups, dim=2) if groups > 1 else x


def _scores(q, k, causal: bool) -> torch.Tensor:
    """fp32 scores [B, H, S, S] with the causal mask filled by NEG_INF."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_forward_plain(q, k, v, causal: bool):
    B, S, H, D = q.shape
    s = _scores(q, _expand_kv(k, H), causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741 - the FA2 name
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bhqd", p, _expand_kv(v, H).float())
    out = (out / safe_l).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(safe_l)).reshape(B * H, S)
    return out, lse


def _probs_and_dscores(q, k, v, dout, lse, delta, causal):
    B, S, H, D = q.shape
    scale = D ** -0.5
    ke, ve = _expand_kv(k, H), _expand_kv(v, H)
    p = torch.exp(_scores(q, ke, causal) - lse.reshape(B, H, S, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), ve.float())
    ds = p * (dp - delta.reshape(B, H, S, 1)) * scale
    return ke, p, ds


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool):
    ke, _, ds = _probs_and_dscores(q, k, v, dout, lse, delta, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, ke.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool):
    """dK, dV per q head ([B, S, H, D], not yet summed over GQA groups)."""
    _, p, ds = _probs_and_dscores(q, k, v, dout, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dlrover_fa_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    "dlrover_fa_bwd_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    "dlrover_fa_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
}


_lib = None  # the loaded library, its functions typed once


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL_SOURCE)
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_kernel_inputs(q, k, v, dout=None, lse=None, delta=None):
    """What the CUDA kernels take: bf16 q/k/v/dout and fp32 lse/delta, all
    contiguous and 16-byte aligned on one CUDA device, head_dim 64 or
    128."""
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash attention kernels run on CUDA tensors, got {q.device}"
        )
    B, S, H, D = q.shape
    expected = (
        ("q", q, torch.bfloat16, (B, S, H, D)),
        ("k", k, torch.bfloat16, (B, S, k.shape[2], D)),
        ("v", v, torch.bfloat16, tuple(k.shape)),
        ("dout", dout, torch.bfloat16, (B, S, H, D)),
        ("lse", lse, torch.float32, (B * H, S)),
        ("delta", delta, torch.float32, (B * H, S)),
    )
    for name, t, dtype, shape in expected:
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"flash attention kernels take {name} as "
                            f"{dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            # TMA reads q/k/v/dout from 16-byte aligned addresses
            raise ValueError(f"{name} must start at a 16-byte aligned "
                             "address")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the kernels "
                         f"(supported: {HEAD_DIMS})")
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k.shape[2]}")


def _launch(fn_name: str, kernel: str, device: torch.device, *args) -> None:
    """Launch on ``device`` (the inputs' card) and its current stream."""
    fn = getattr(_library(), fn_name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    launches[kernel] += 1


def flash_forward(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,S,H,D], lse [B*H,S] fp32)."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal)
    _check_kernel_inputs(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    _launch(
        "dlrover_fa_fwd", "flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, k.shape[2], D, D ** -0.5, int(causal),
    )
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    _check_kernel_inputs(q, k, v, dout, lse, delta)
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    _launch(
        "dlrover_fa_bwd_dq", "flash_bwd_dq", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, S, H, k.shape[2], D, D ** -0.5, int(causal),
    )
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool):
    """dK, dV per q head ([B, S, H, D]); the caller sums GQA groups."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal)
    _check_kernel_inputs(q, k, v, dout, lse, delta)
    B, S, H, D = q.shape
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    _launch(
        "dlrover_fa_bwd_dkv", "flash_bwd_dkv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, H, k.shape[2], D, D ** -0.5, int(causal),
    )
    return dk, dv


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, as ``[B*H, S]``."""
    B, S, H, _ = out.shape
    delta = (dout.float() * out.float()).sum(dim=-1)  # [B, S, H]
    return delta.permute(0, 2, 1).reshape(B * H, S).contiguous()


class FlashAttention(torch.autograd.Function):
    """Mirror of ``pallas_flash_attention``'s custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal)
        B, S, H, D = q.shape
        H_kv = k.shape[2]
        if H != H_kv:
            groups = H // H_kv
            dk = dk.float().reshape(B, S, H_kv, groups, D).sum(dim=3)
            dv = dv.float().reshape(B, S, H_kv, groups, D).sum(dim=3)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None
