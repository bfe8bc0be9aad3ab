"""Argument plumbing shared by the attention kernels' wrappers
(ops/splash.py, ops/band.py, ops/band2.py).

Every C entry point of csrc/frame_attention.cu and csrc/band_attention.cu
takes the same three arrays (``make_params`` in
csrc/hopper_attention.cuh): 12 pointers (q, k, v, o, dout, dq, dk, dv,
lse, delta, doc, its tile summary), 24 element strides (batch, head, row of the eight [B,
H, L, Dh] operands, ``map_strides``) and 7 ints (B, H, L, Dh, tpf,
window, causal; band2 adds its plan), then its floats and the stream.
Every kernel reads its inputs through TMA tensor maps built from those
strides (``tma_geometry``), in place (``tma_views``).
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


def refuse_transforms():
    """Raise inside a torch.func transform (MeanFlow's jvp): the kernels'
    autograd Functions have no forward-mode or batching rule, as the JAX
    package's kernels (custom_vjp) have none, and a raw launch would drop
    the tangents."""
    if torch._C._are_functorch_transforms_active():
        raise RuntimeError(
            "the port's attention kernels under a torch.func transform "
            "(jvp, vmap): their autograd Functions have no forward-mode "
            "rule, as the JAX package's splash and band kernels "
            "(custom_vjp) have none")


def check_operands(ref: torch.Tensor, **tensors: torch.Tensor):
    """Each tensor: bf16 [B, H, L, Dh] on ``ref``'s CUDA device, Dh 64 or
    128. Raises on anything the kernels do not take, and inside a
    torch.func transform (``refuse_transforms``)."""
    refuse_transforms()
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
    through the autograd Function of ops/splash.py, ops/band.py or
    ops/band2.py."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "raw kernel launch on tensors that require grad; call "
            "splash_attention / band_attention, whose autograd Function "
            "launches the backward kernels")


# TMA's limits on a tensor map (cuTensorMapEncodeTiled): a 16-byte
# aligned base, byte strides that are multiples of 16 below 2^40, dims at
# most 2^32; the 128-byte swizzle takes boxes of 64 bf16 columns
TMA_ALIGN, TMA_MAX_STRIDE, TMA_MAX_DIM = 16, 1 << 40, 1 << 32


def map_strides(shape: Sequence[int], stride: Sequence[int]) -> tuple:
    """Element strides (batch, head, row) of a [B, H, L, Dh] view as every
    entry point takes them: a dim of extent 1 gets the stride a dense
    layout would give it (its own is never used, and may be one TMA
    refuses, as the 0 of an expanded dim). This is the one place of that
    rule: ``launch`` passes these strides, and csrc/hopper_attention.cuh
    ``encode_map`` builds its tensor maps from them as they are."""
    B, H, L, Dh = shape
    row = stride[2] if L > 1 else Dh
    head = stride[1] if H > 1 else row * L
    batch = stride[0] if B > 1 else head * H
    return batch, head, row


def tma_geometry(shape: Sequence[int], stride: Sequence[int], data_ptr: int,
                 box_rows: int, elem_bytes: int = 2) -> Dict[str, tuple]:
    """The tensor map csrc/hopper_attention.cuh ``encode_map`` makes of a
    [B, H, L, Dh] view (element strides ``stride``): dims (Dh, L, H, B),
    byte strides of the row, head and batch dims (``map_strides``), and a
    box of [box_rows, 64] elements (the 128-byte swizzle's width; Dh 128
    takes two boxes). Raises ValueError on a view TMA cannot read in
    place: the wrappers never copy in silence."""
    B, H, L, Dh = shape
    if Dh not in (64, 128):
        raise ValueError(f"head dim {Dh}: the kernels take 64 or 128")
    if stride[3] != 1:
        raise ValueError(f"the head dim must be contiguous (stride "
                         f"{stride[3]}): TMA reads rows of Dh elements")
    if data_ptr % TMA_ALIGN:
        raise ValueError(f"base address {data_ptr:#x} is not {TMA_ALIGN}-byte"
                         f" aligned, as TMA needs")
    batch, head, row = (s * elem_bytes for s in map_strides(shape, stride))
    for name, s in (("row", row), ("head", head), ("batch", batch)):
        if s <= 0 or s % TMA_ALIGN or s >= TMA_MAX_STRIDE:
            raise ValueError(
                f"{name} stride of {s} bytes: TMA takes positive multiples "
                f"of {TMA_ALIGN} below 2^40 (strides {tuple(stride)})")
    if max(B, H, L) > TMA_MAX_DIM:
        raise ValueError(f"shape {tuple(shape)} exceeds TMA's 2^32 per dim")
    return dict(dims=(Dh, L, H, B), strides=(row, head, batch),
                box=(64, box_rows, 1, 1))


def tma_operand(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is, if TMA can read it in place (``tma_geometry``);
    raises ValueError naming ``name`` otherwise."""
    try:
        tma_geometry(t.shape, t.stride(), t.data_ptr(), 64,
                     t.element_size())
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return t


def tma_views(**tensors: torch.Tensor) -> list:
    """The kernels read q, k, v, out and dout through TMA tensor maps: each
    as it is, or ValueError for a view TMA cannot take (never a copy)."""
    return [tma_operand(name, t) for name, t in tensors.items()]


def dense_cotangent(g: torch.Tensor) -> torch.Tensor:
    """An output cotangent autograd hands a backward, as bf16 the kernels
    can read: the same tensor where TMA takes its layout, else a dense
    copy (autograd may hand an expanded gradient, e.g. of ``out.sum()``,
    whose zero strides no tensor map takes). The caller's own views are
    never copied: ``tma_operand`` raises on them."""
    g = g.to(torch.bfloat16)
    try:
        tma_geometry(g.shape, g.stride(), g.data_ptr(), 64)
        return g
    except ValueError:
        return g.contiguous()


def empty_heads(like: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] view of fresh [B, L, H, Dh] storage: the caller's
    transpose back to tokens-major is then free."""
    B, H, L, Dh = like.shape
    return torch.empty(B, L, H, Dh, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def launch(fn, tensors: Dict[str, torch.Tensor], ints: Sequence[int],
           floats: Sequence[float], lse: Optional[torch.Tensor] = None,
           delta: Optional[torch.Tensor] = None,
           doc: Optional[torch.Tensor] = None,
           doc_summary: Optional[torch.Tensor] = None,
           what: str = "attention"):
    """Call a C entry point on the current stream; raises on a non-zero
    CUDA error (a refused launch never runs and no synchronize reports
    it). ``doc`` comes with its summary (ops/doc_tiles.py)."""
    ptrs, strides = [], []
    for name in OPERANDS:
        t = tensors.get(name)
        ptrs.append(None if t is None else t.data_ptr())
        strides.extend([0, 0, 0] if t is None
                       else map_strides(t.shape, t.stride()))
    for t in (lse, delta, doc, doc_summary):
        ptrs.append(None if t is None else t.data_ptr())
    ref = tensors["q"]
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_longlong * len(strides))(*strides),
             (ctypes.c_int * len(ints))(*ints), *floats,
             torch.cuda.current_stream(ref.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
