"""Argument plumbing shared by the attention kernels' wrappers
(ops/splash.py, ops/band.py).

Every C entry point of csrc/frame_attention.cu and csrc/band_attention.cu
takes the same three arrays (see csrc/attention_tiles.cuh ``make_params``):
11 pointers (q, k, v, o, dout, dq, dk, dv, lse, delta, doc), 24 element
strides (batch, head, row of the eight [B, H, L, Dh] operands) and 7 ints
(B, H, L, Dh, tpf, window, causal), then its floats and the stream.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence

import torch

OPERANDS = ("q", "k", "v", "o", "dout", "dq", "dk", "dv")


@functools.lru_cache(maxsize=None)
def entry(stem: str, name: str, n_floats: int):
    """The C function ``name`` of csrc/<stem>.cu (built at first use),
    taking ``n_floats`` floats after the three arrays."""
    from . import _build
    fn = getattr(_build.load(stem), name)
    fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_longlong),
                    ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_operands(ref: torch.Tensor, **tensors: torch.Tensor):
    """Each tensor: bf16 [B, H, L, Dh] on ``ref``'s CUDA device, Dh 64 or
    128. Raises on anything the kernels do not take."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"attention kernels take bf16, got {name} {t.dtype}")
        if t.shape != ref.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(ref.shape)} (self-attention only)")
    if ref.shape[-1] not in (64, 128):
        raise NotImplementedError(
            f"head dim {ref.shape[-1]}: the kernels take 64 or 128")


def refuse_autograd(*tensors: torch.Tensor):
    """A raw launch has no backward: a caller that needs gradients goes
    through the autograd Function of ops/splash.py or ops/band.py."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "raw kernel launch on tensors that require grad; call "
            "splash_attention / band_attention, whose autograd Function "
            "launches the backward kernels")


def operand(t: torch.Tensor) -> torch.Tensor:
    """The kernels read [B, H, L, Dh] through strides with 16-byte loads:
    the last dim must be contiguous and every stride and the base 16-byte
    aligned. The layouts Attn produces (a transposed view of the
    [B, L, H, Dh] projection) qualify; anything else is copied."""
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def empty_heads(like: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] view of fresh [B, L, H, Dh] storage: the caller's
    transpose back to tokens-major is then free."""
    B, H, L, Dh = like.shape
    return torch.empty(B, L, H, Dh, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def launch(fn, tensors: Dict[str, torch.Tensor], ints: Sequence[int],
           floats: Sequence[float], lse: Optional[torch.Tensor] = None,
           delta: Optional[torch.Tensor] = None,
           doc: Optional[torch.Tensor] = None, what: str = "attention"):
    """Call a C entry point on the current stream; raises on a non-zero
    CUDA error (a refused launch never runs and no synchronize reports
    it)."""
    ptrs, strides = [], []
    for name in OPERANDS:
        t = tensors.get(name)
        ptrs.append(None if t is None else t.data_ptr())
        strides.extend([0, 0, 0] if t is None else t.stride()[:3])
    for t in (lse, delta, doc):
        ptrs.append(None if t is None else t.data_ptr())
    ref = tensors["q"]
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_longlong * len(strides))(*strides),
             (ctypes.c_int * len(ints))(*ints), *floats,
             torch.cuda.current_stream(ref.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
