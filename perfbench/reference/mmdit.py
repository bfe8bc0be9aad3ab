"""Plain float32 reference of the dual-stream MMDiT (configs/mmdit_v2.yml:
owl-audio-exps ``owl_wms/nn/mmattn.py`` ``MMAttn``, ``MMDiTBlock``,
``MMDIT``, the SD3 block of Esser et al., arXiv:2403.03206, with the
DiT-Air shared conditioning) inside the joint audio-video wrapper and
loss of ``game_rft_audio``, and its training steps.

Per frame of n frames, V = sample_size^2 video tokens and 1 audio token:
* ``y = W_c SiLU(cond)``, one d -> 12 d projection shared by every block,
  split into each stream's (scale, bias, gate) of its attention and of
  its MLP;
* each stream s (0 video, 1 audio) has its own ``qkv_s``, ``out_s`` and
  ``mlp_s``; ``h_s = adaLN(x_s)``; the two streams' qkv rows are
  interleaved per frame, [V video | 1 audio], into one sequence of
  L = n (V + 1) tokens; q and k are rms-normed and rotated at their
  joint positions; attention runs under the layer's frame mask (causal,
  ``global_window`` frames on layers i % local_idx == 0,
  ``local_window`` elsewhere);
* the output splits back per frame and ``x_s += gate * out_s(o_s)``;
  then ``x_s += gate * mlp_s(adaLN(x_s))``.

Everything outside the backbone (embeddings, conditioning, the final
layers, the rectified-flow loss, Muon + AdamW, the EMA) is reference/
model.py's, reference/train.py's and reference/optim.py's, imported.

Where this departs from upstream's ``mmattn.py``:
* upstream imports ``create_causal_block_mask`` from its ``attn.py``,
  which defines no such function (its builder is ``get_block_mask``), so
  its MMDiT does not import; here the mask is that builder's frame-level
  visibility (``frame_visibility``) and attention is
  ``blocked_attention`` over the visible frames, not flex-attention;
* the whole model runs in float32 with TF32 off, where upstream runs
  under bfloat16 autocast;
* RoPE is reference/rope.py's frozen copy of the ``ortho`` layout;
* the KV-cache path is not modelled: training only.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import (Model, _linear, _mlp, layer_norm, param_spec, per_frame,
                    per_frame_add, rms_norm)
from .optim import Optimizer
from .train import EMA_BETA, loss_of


def mmdit_param_spec(cfg, prefix: str = ""
                     ) -> List[Tuple[str, tuple, int, str]]:
    """reference/model.py ``param_spec`` of the AV model with the
    MMDiT's backbone in place of the DiT's blocks, under the port's
    ``state_dict`` names."""
    d, p = cfg["d_model"], prefix
    head = param_spec(dict(cfg, n_layers=0), prefix)
    cut = next(i for i, (n, *_) in enumerate(head)
               if n.startswith(f"{p}proj_out."))
    s = []
    _linear(s, f"{p}transformer.cond_proj.1", d, 12 * d)
    for i in range(cfg["n_layers"]):
        b = f"{p}transformer.blocks.{i}"
        for j in range(2):
            _linear(s, f"{b}.attn.qkv_projs.{j}", d, 3 * d)
            _linear(s, f"{b}.attn.out_projs.{j}", d, d)
            _mlp(s, f"{b}.mlps.{j}", d, 4 * d, d)
    return head[:cut] + s + head[cut:]


def cond_adaln(x, scale, bias):
    return per_frame_add(per_frame(rms_norm(x), 1.0 + scale), bias)


class MMDiTModel(Model):
    """reference/model.py ``Model`` with the dual-stream backbone; ``av``
    keeps its signature, so reference/train.py ``loss_of`` runs it."""

    def block(self, i, x0, x1, c0, c1, attend):
        cfg, b = self.cfg, f"transformer.blocks.{i}"
        B, n, d = x1.shape
        H = cfg["n_heads"]
        V = x0.shape[1] // n
        a_s0, a_b0, a_g0, m_s0, m_b0, m_g0 = c0.chunk(6, -1)
        a_s1, a_b1, a_g1, m_s1, m_b1, m_g1 = c1.chunk(6, -1)
        q0 = self.lin(f"{b}.attn.qkv_projs.0", cond_adaln(x0, a_s0, a_b0))
        q1 = self.lin(f"{b}.attn.qkv_projs.1", cond_adaln(x1, a_s1, a_b1))
        qkv = torch.cat([q0.view(B, n, V, 3 * d), q1.view(B, n, 1, 3 * d)],
                        2).view(B, n * (V + 1), 3, H, d // H)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        o = attend(i, self.flags[i], rms_norm(q), rms_norm(k), v)
        o = o.transpose(1, 2).reshape(B, n, V + 1, d)
        o0 = self.lin(f"{b}.attn.out_projs.0", o[:, :, :V].reshape(B, n * V,
                                                                   d))
        o1 = self.lin(f"{b}.attn.out_projs.1", o[:, :, V])
        x0 = x0 + per_frame(o0, a_g0)
        x1 = x1 + per_frame(o1, a_g1)
        x0 = x0 + per_frame(self.mlp(f"{b}.mlps.0",
                                     cond_adaln(x0, m_s0, m_b0)), m_g0)
        x1 = x1 + per_frame(self.mlp(f"{b}.mlps.1",
                                     cond_adaln(x1, m_s1, m_b1)), m_g1)
        return x0, x1

    def av(self, x, audio, t, mouse, btn, has_controls, attend):
        """(x [b, n, c, h, w], audio [b, n, c_a]) -> (v_video, v_audio)."""
        b, n, c, h, w = x.shape
        cond = self.cond(t, mouse, btn, has_controls)
        x0 = self.lin("proj_in", x.permute(0, 1, 3, 4, 2)
                      .reshape(b, n * h * w, c), bias=False)
        x1 = self.lin("audio_proj_in", audio, bias=False)
        c0, c1 = self.lin("transformer.cond_proj.1",
                          F.silu(cond)).chunk(2, -1)
        for i in range(self.cfg["n_layers"]):
            if self.remat and torch.is_grad_enabled():
                x0, x1 = checkpoint(self.block, i, x0, x1, c0, c1, attend,
                                    use_reentrant=False)
            else:
                x0, x1 = self.block(i, x0, x1, c0, c1, attend)
        video = self.final("proj_out", layer_norm(x0), layer_norm(cond))
        video = video.reshape(b, n, h, w, c).permute(0, 1, 4, 2, 3)
        return video, self.final("audio_proj_out", x1, cond)


def run(mc, tc, seed, batches, gen_states, precision, device,
        remat=False, rows=None, update=True):
    """reference/train.py ``run`` on the MMDiT: the same steps, draws,
    optimizer and EMA, and the same result."""
    from perfbench.weights import make_weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = make_weights(mmdit_param_spec(mc, "core."), seed,
                          torch.float32, device)
    p0 = {k: v.clone() for k, v in params.items()}
    ema = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    model = MMDiTModel(mc, params, prefix="core.", precision=precision,
                       remat=remat)
    opt = Optimizer(params, tc["opt_kwargs"])
    names = list(params)
    chained = len(gen_states) == 1 and isinstance(gen_states[0],
                                                  torch.Generator)
    losses, grad1 = [], None
    for i, batch in enumerate(batches):
        if chained:
            gen = gen_states[0]
        else:
            gen = torch.Generator(device=device)
            gen.set_state(gen_states[i])
        if i and not update:
            with torch.no_grad():
                losses.append(float(loss_of(model, mc, tc, batch, gen,
                                            device, precision, rows)))
            continue
        loss = loss_of(model, mc, tc, batch, gen, device, precision, rows)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        g = dict(zip(names, grads))
        if i == 0:
            grad1 = {k: float(v.norm()) for k, v in g.items()}
        if update:
            opt.step(g)
            with torch.no_grad():
                for k in names:
                    ema[k].mul_(EMA_BETA).add_(params[k] * (1.0 - EMA_BETA))
        del g, grads, loss
    with torch.no_grad():
        change = {k: float((params[k] - p0[k]).norm()) for k in names}
        ema = {k: float((ema[k] - p0[k]).norm()) for k in names}
    return {"losses": losses, "grad1": grad1, "change": change, "ema": ema}
