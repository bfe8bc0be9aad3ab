"""Static-shape ring-buffer KV cache with split per-layer-group capacity
(counterpart of owl_audio_exps_tpu/nn/kv_cache.py).

The rings are preallocated tensors that every write updates in place
(``index_copy_``), and the counters ``start``, ``length``,
``rope_offset``, ``lstart`` and ``llength`` are 0-d int32 tensors on the
rings' device, also updated in place. No operation reads a value back to
the host, so one token's step of a serve loop keeps its buffers and can
be captured once as a CUDA graph and replayed (sampling/audio_caching.py).

* ``k``/``v``: [layers, B, H, capacity (+ shadow), Dh], keys stored
  already rotated at their absolute write position.
* ``start``/``length``: the ring window over slots; a slot's
  insertion-order index is ``(slot - start) mod capacity``, valid iff it
  is below ``length``.
* Split local ring (``lk``/``lv``): local-window layers read only their
  trailing ``local_window`` frames, so they get a ring of exactly that
  many tokens plus a wrap mirror, while the global layers keep the full
  ring. Both rings share the write clock.
* ``shadow``: the first ``shadow`` slots are mirrored past the end of the
  ring, so the trailing local window is always one contiguous run of
  slots. Single-frame writes keep the mirror; multi-frame prefill writes
  start at slot 0 before the ring wraps.
* ``rope_offset``: the monotonic count of tokens ever written; it
  advances on every commit and is not rewound by ``drop_newest``.
* int8 rings (``kv_quant: int8``): symmetric per-(token, head) int8 over
  head_dim with scales in the model dtype (``ks``/``vs``/``lks``/
  ``lvs``, Dh -> 1), written by the same ring writes.

A write's start slot is clamped so that the write fits the allocation, as
the JAX package's ``dynamic_update_slice`` clamps it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_QMAX = 127.0


def _quantize_kv(x: torch.Tensor, scale_dtype):
    """(q int8 [..., Dh], scale [..., 1] in ``scale_dtype``): symmetric
    over head_dim, the scale rounded to its storage dtype before the
    division so that write and read use the same scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / _QMAX, min=1e-8).to(scale_dtype)
    q = torch.round(xf / scale.float())
    return torch.clamp(q, -_QMAX, _QMAX).to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def _slots(pos: torch.Tensor, t: int, alloc: int) -> torch.Tensor:
    """Slots [pos, pos + t), pos clamped so that they fit ``alloc``."""
    start = torch.clamp(pos, max=alloc - t).long()
    return start + torch.arange(t, dtype=torch.long, device=pos.device)


def _ring_write(buf, new, pos, shadow: int, tpf: int, capacity: int):
    """Write ``new`` [..., t, Dh] into ``buf`` [..., alloc, Dh] at slot
    ``pos``; a single-frame write also refreshes its mirror slot."""
    t, alloc, dim = new.shape[-2], buf.shape[-2], buf.ndim - 2
    new = new.to(buf.dtype)
    buf.index_copy_(dim, _slots(pos, t, alloc), new)
    if shadow and t == tpf:
        mirror = torch.where(pos < shadow, capacity + pos, pos)
        buf.index_copy_(dim, _slots(mirror, t, alloc), new)


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


class KVCache:
    """Ring KV cache; see the module docstring. Build it with ``create``
    or ``from_config``."""

    def __init__(self, k, v, start, length, rope_offset, lk=None, lv=None,
                 lstart=None, llength=None, ks=None, vs=None, lks=None,
                 lvs=None, tokens_per_frame: int = 1, shadow: int = 0,
                 lshadow: int = 0, groups: tuple = (), slots: tuple = ()):
        self.k, self.v = k, v
        self.start, self.length, self.rope_offset = start, length, rope_offset
        self.lk, self.lv, self.lstart, self.llength = lk, lv, lstart, llength
        self.ks, self.vs, self.lks, self.lvs = ks, vs, lks, lvs
        self.tokens_per_frame = tokens_per_frame
        self.shadow, self.lshadow = shadow, lshadow
        # groups[i] == 1: layer i lives in the local ring, at row slots[i]
        self.groups, self.slots = groups, slots

    # ------------------------------------------------------------ geometry
    @property
    def capacity(self) -> int:
        return self.k.shape[3] - self.shadow

    @property
    def local_capacity(self) -> int:
        return 0 if self.lk is None else self.lk.shape[3] - self.lshadow

    @property
    def split(self) -> bool:
        return self.lk is not None

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def n_layers(self) -> int:
        return len(self.groups) if self.groups else self.k.shape[0]

    def is_local_layer(self, layer_idx: int) -> bool:
        return bool(self.groups) and self.groups[layer_idx] == 1

    def ring_view(self, local: bool):
        """(capacity, shadow, start, length) of the ring a layer reads."""
        if local and self.split:
            return (self.local_capacity, self.lshadow, self.lstart,
                    self.llength)
        return (self.capacity, self.shadow, self.start, self.length)

    # ---------------------------------------------------------------- init
    @classmethod
    def create(cls, n_layers: int, batch_size: int, capacity: int,
               n_heads: int, head_dim: int, tokens_per_frame: int = 1,
               dtype=torch.bfloat16, shadow: int = 0,
               local_flags: Optional[Tuple[bool, ...]] = None,
               local_capacity: int = 0, quant: bool = False,
               device=None) -> "KVCache":
        ring_dtype = torch.int8 if quant else dtype

        def ring(shape):
            return torch.zeros(shape, dtype=ring_dtype, device=device)

        def scales(shape):
            if not quant:
                return None
            return torch.zeros(shape[:-1] + (1,), dtype=dtype, device=device)

        split = (local_flags is not None and any(local_flags)
                 and 0 < local_capacity < capacity)
        if not split:
            shape = (n_layers, batch_size, n_heads, capacity + shadow,
                     head_dim)
            return cls(k=ring(shape), v=ring(shape), ks=scales(shape),
                       vs=scales(shape), start=_zero(device),
                       length=_zero(device), rope_offset=_zero(device),
                       tokens_per_frame=tokens_per_frame, shadow=shadow)
        groups = tuple(1 if f else 0 for f in local_flags)
        slots, counters = [], [0, 0]
        for g in groups:
            slots.append(counters[g])
            counters[g] += 1
        # the local ring: the window plus a (window - frame) wrap mirror,
        # so that the trailing window is always one contiguous run
        lshadow = max(local_capacity - tokens_per_frame, 0)
        gshape = (counters[0], batch_size, n_heads, capacity, head_dim)
        lshape = (counters[1], batch_size, n_heads, local_capacity + lshadow,
                  head_dim)
        return cls(k=ring(gshape), v=ring(gshape), lk=ring(lshape),
                   lv=ring(lshape), ks=scales(gshape), vs=scales(gshape),
                   lks=scales(lshape), lvs=scales(lshape),
                   start=_zero(device), length=_zero(device),
                   lstart=_zero(device), llength=_zero(device),
                   rope_offset=_zero(device),
                   tokens_per_frame=tokens_per_frame, shadow=0,
                   lshadow=lshadow, groups=groups, slots=tuple(slots))

    @classmethod
    def from_config(cls, config, batch_size: int, capacity_frames: int = None,
                    dtype=torch.bfloat16, device=None,
                    mesh=None) -> "KVCache":
        """The cache of a model config, as the JAX package sizes it.

        ``batch_size`` is this process's sessions. Under a mesh whose
        tensor axis divides the heads (``mesh``, by default the installed
        one; parallel/sharding.py ``cache_shardings``) the rings hold this
        rank's H / T heads only, the ones its column-parallel QKV
        computes.

        With a ``local_window`` and a dit/mmdit backbone the local layers
        take the split ring when ``split_local_cache`` is true, or under
        ``auto`` when the context is long (> 384 frames) or the local span
        is at most 256 tokens (audio: 16 x 1); otherwise a single ring
        with a shadow of one local span. ``kv_quant: int8`` stores the
        rings as int8 with per-(token, head) scales."""
        tpf = config.tokens_per_frame
        frames = capacity_frames if capacity_frames is not None \
            else config.n_frames
        capacity = frames * tpf
        local_w = config.get("local_window")
        head_dim = config.d_model // config.n_heads
        if mesh is None:
            from ..parallel.mesh import get_mesh
            mesh = get_mesh()
        n_heads = config.n_heads
        if n_heads % mesh.tensor == 0:
            n_heads //= mesh.tensor

        local_flags = None
        local_capacity = 0
        backbone = config.get("backbone", "dit")
        split = config.get("split_local_cache", "auto")
        if split in ("auto", None):
            local_span = (local_w or 0) * tpf
            split = frames > 384 or 0 < local_span <= 256
        if (local_w is not None and 0 < local_w * tpf < capacity
                and backbone in ("dit", "mmdit") and split):
            local_idx = config.get("local_idx", 4) or 4
            local_flags = tuple(
                (i % local_idx != 0) for i in range(config.n_layers))
            local_capacity = local_w * tpf

        shadow = 0
        if (local_flags is None and local_w is not None
                and 0 < local_w * tpf < capacity):
            shadow = local_w * tpf
        return cls.create(
            n_layers=config.n_layers, batch_size=batch_size,
            capacity=capacity, n_heads=n_heads, head_dim=head_dim,
            tokens_per_frame=tpf, dtype=dtype, shadow=shadow,
            local_flags=local_flags, local_capacity=local_capacity,
            quant=config.get("kv_quant") in ("int8", True), device=device)

    # ------------------------------------------------------------- queries
    def slot_rel_idx(self, local: bool = False) -> torch.Tensor:
        """[alloc] int32 insertion-order index of each slot (>= length:
        invalid; shadow slots are always invalid)."""
        S, shadow, start, _ = self.ring_view(local)
        slots = torch.arange(S + shadow, dtype=torch.int32,
                             device=start.device)
        rel = torch.remainder(slots - start, S)
        return rel.masked_fill(slots >= S, S)

    def write_positions(self, t: int) -> torch.Tensor:
        """RoPE positions of t new tokens."""
        return self.rope_offset + torch.arange(
            t, dtype=torch.int32, device=self.rope_offset.device)

    # ------------------------------------------------------------- updates
    def _raw_layer(self, layer_idx: int):
        """(k, v, k_scale, v_scale) views of a layer's ring (scales None
        when the rings are not quantized)."""
        if self.groups and self.groups[layer_idx] == 1:
            bufs, row = (self.lk, self.lv, self.lks, self.lvs), \
                self.slots[layer_idx]
        elif self.groups:
            bufs, row = (self.k, self.v, self.ks, self.vs), \
                self.slots[layer_idx]
        else:
            bufs, row = (self.k, self.v, self.ks, self.vs), layer_idx
        return tuple(None if b is None else b[row] for b in bufs)

    def write_layer(self, layer_idx: int, new_k: torch.Tensor,
                    new_v: torch.Tensor):
        """Write t rotated tokens [B, H, t, Dh] of one layer at the ring's
        write position; the counters move only with ``advance``."""
        t, tpf = new_k.shape[2], self.tokens_per_frame
        if t > self.capacity:
            raise ValueError(f"write of {t} tokens exceeds ring capacity "
                             f"{self.capacity}; truncate the context first")
        if self.capacity % tpf or t % tpf:
            raise ValueError("ring writes must be frame-aligned")
        kbuf, vbuf, ksb, vsb = self._raw_layer(layer_idx)
        if self.is_local_layer(layer_idx):
            cap, shadow = self.local_capacity, self.lshadow
            if t >= cap:
                # a prefill longer than the window: only the trailing
                # window survives, at slot 0 (advance() resets the ring)
                new_k, new_v = new_k[:, :, -cap:], new_v[:, :, -cap:]
                pos = torch.zeros_like(self.lstart)
            else:
                pos = torch.remainder(self.lstart + self.llength, cap)
        else:
            cap, shadow = self.capacity, self.shadow
            pos = torch.remainder(self.start + self.length, cap)
        if self.quantized:
            new_k, sk = _quantize_kv(new_k, ksb.dtype)
            new_v, sv = _quantize_kv(new_v, vsb.dtype)
            _ring_write(ksb, sk, pos, shadow, tpf, cap)
            _ring_write(vsb, sv, pos, shadow, tpf, cap)
        _ring_write(kbuf, new_k, pos, shadow, tpf, cap)
        _ring_write(vbuf, new_v, pos, shadow, tpf, cap)

    def update_all(self, new_k: torch.Tensor, new_v: torch.Tensor):
        """Write t rotated tokens of every layer, [L, B, H, t, Dh] in layer
        order; counters advance separately (``advance``)."""
        for i in range(self.n_layers):
            self.write_layer(i, new_k[i], new_v[i])
        return self

    def advance(self, t: int):
        """Commit t written tokens: grow length (evicting the oldest on
        overflow) and advance the monotonic rope offset."""
        new_len = self.length + t
        overflow = torch.clamp(new_len - self.capacity, min=0)
        self.start.copy_(torch.remainder(self.start + overflow,
                                         self.capacity))
        self.length.copy_(new_len - overflow)
        self.rope_offset.add_(t)
        if self.split:
            cap_l = self.local_capacity
            if t >= cap_l:  # the prefill wrote the trailing window at 0
                self.lstart.zero_()
                self.llength.fill_(cap_l)
            else:
                nl = self.llength + t
                over = torch.clamp(nl - cap_l, min=0)
                self.lstart.copy_(torch.remainder(self.lstart + over, cap_l))
                self.llength.copy_(nl - over)
        return self

    def pop_oldest(self, n_frames: int):
        """Evict the oldest frames."""
        t = torch.clamp(self.length, max=n_frames * self.tokens_per_frame)
        new_len = self.length - t
        self.start.copy_(torch.remainder(self.start + t, self.capacity))
        self.length.copy_(new_len)
        if self.split:
            # the local ring holds the newest tokens; it shrinks only when
            # the remaining context is shorter than the window
            target = torch.minimum(self.llength, new_len)
            shrink = self.llength - target
            self.lstart.copy_(torch.remainder(self.lstart + shrink,
                                              self.local_capacity))
            self.llength.copy_(target)
        return self

    def drop_newest(self, n_frames: int):
        """Drop the newest frames; ``rope_offset`` is not rewound."""
        t = torch.clamp(self.length, max=n_frames * self.tokens_per_frame)
        self.length.sub_(t)
        if self.split:
            self.llength.sub_(torch.minimum(t, self.llength))
        return self

    def reset(self):
        for c in (self.start, self.length, self.rope_offset, self.lstart,
                  self.llength):
            if c is not None:
                c.zero_()
        return self

    # --------------------------------------------------------------- reads
    def read_layer(self, layer_idx: int, noise: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """(k, v) [B, H, alloc, Dh] of a layer, dequantized for int8 rings;
        with ``noise`` > 0, plus ``noise`` times gaussian draws (``draws``
        (zk, zv) when given, else from ``generator``)."""
        k, v, ks, vs = self._raw_layer(layer_idx)
        if ks is not None:
            k, v = _dequantize_kv(k, ks), _dequantize_kv(v, vs)
        if noise > 0.0:
            if draws is None:
                draws = tuple(torch.randn(x.shape, device=x.device,
                                          generator=generator)
                              for x in (k, v))
            k = k + noise * draws[0].to(k.dtype)
            v = v + noise * draws[1].to(v.dtype)
        return k, v

    def gather_trailing(self, layer_idx: int, n_gather: int, local: bool):
        """(k, v, valid) of the trailing ``n_gather`` insertion-order
        tokens of a layer's ring: one contiguous run of slots through the
        shadow mirror where it is wide enough, else the slots one by one.
        For int8 rings only the gathered tokens are dequantized."""
        cap, shadow, start, length = self.ring_view(local)
        ck, cv, cks, cvs = self._raw_layer(layer_idx)
        rel0 = length - n_gather
        rel = rel0 + torch.arange(n_gather, dtype=torch.int32,
                                  device=length.device)
        valid = (rel >= 0) & (rel < length)
        if shadow >= n_gather - self.tokens_per_frame:
            # a frame-aligned start in [0, cap) keeps the run inside the
            # allocation; slots wrapped in while the cache holds fewer
            # tokens than the window are hidden by ``valid``
            idx = _slots(torch.remainder(start + rel0, cap), n_gather,
                         ck.shape[2])
        else:
            idx = torch.remainder(start + rel, cap).long()
        gk, gv = ck.index_select(2, idx), cv.index_select(2, idx)
        if cks is not None:
            gk = _dequantize_kv(gk, cks.index_select(2, idx))
            gv = _dequantize_kv(gv, cvs.index_select(2, idx))
        return gk, gv, valid

    def rebase_rope(self, cos_d, sin_d, delta_tokens: int):
        """Move every cached key's implicit RoPE position down by
        ``delta_tokens``: rotate the K rings by the constant angle of
        ops/rope.py ``rope_rebase_tables`` (exact: relative positions and
        so attention scores are unchanged) and lower ``rope_offset`` by
        the same amount. V rings are not rotated."""
        from ..ops.rope import apply_rope
        dev = self.k.device
        cos_d = torch.as_tensor(cos_d, device=dev)
        sin_d = torch.as_tensor(sin_d, device=dev)

        def rot(k, ks):
            pos = torch.zeros(k.shape[3], dtype=torch.long, device=dev)
            if ks is None:
                k.copy_(apply_rope(k, cos_d, sin_d, pos))
                return
            out = apply_rope(_dequantize_kv(k, ks).float(), cos_d, sin_d, pos)
            q, s = _quantize_kv(out, ks.dtype)
            k.copy_(q)
            ks.copy_(s)

        rot(self.k, self.ks)
        if self.split:
            rot(self.lk, self.lks)
        self.rope_offset.sub_(delta_tokens)
        return self


def rope_rebase_plan(config, cap_frames: int):
    """Plan for serve loops that outlive the RoPE table.

    Returns ``(table_frames, delta_frames, rebase_fn)``: a loop may write
    while ``offset_frames + 1 <= table_frames``; ``rebase_fn(cache)``
    rotates the rings in place and lowers the offset by ``delta_frames``,
    the largest rebase that keeps later writes inside the table;
    ``delta_frames < 1`` means the ring is as large as the table and
    cannot rebase (positions past the table clamp)."""
    from ..ops.rope import rope_rebase_tables, rope_table_for

    tpf = config.tokens_per_frame
    table_frames = rope_table_for(config).n_tokens // tpf
    delta_frames = table_frames - cap_frames - 1
    if delta_frames < 1:
        return table_frames, 0, lambda cache: cache
    cos_d, sin_d = rope_rebase_tables(config, delta_frames)

    def rebase_fn(cache: KVCache) -> KVCache:
        return cache.rebase_rope(cos_d, sin_d, delta_frames * tpf)

    return table_frames, delta_frames, rebase_fn


def rope_rebase_segments(init_frames: int, num_frames: int,
                         table_frames: int, delta_frames: int):
    """Segment lengths of a loop that writes one frame per step from
    ``init_frames`` written frames; callers run ``rebase_fn`` between
    consecutive segments. One segment means no rebase."""
    if delta_frames < 1 or init_frames + num_frames <= table_frames:
        return [num_frames]
    segs = []
    rem = num_frames
    first = min(max(0, table_frames - init_frames), rem)
    if first:
        segs.append(first)
        rem -= first
    while rem > 0:
        segs.append(min(delta_frames, rem))
        rem -= delta_frames
    return segs
