"""The MMDiT's training driver: perfbench/drivers/train.py's on the
dual-stream backbone (``backbone: mmdit``, nn/mmattn.py), through the
same trainer, feed and checks. What differs:

* the parameters: reference/mmdit.py ``mmdit_param_spec``, the port's
  names, for the weights made from the seed;
* the reference: reference/mmdit.py ``run``, with train.py's signature,
  so perfbench/control.py's float8 control and the planted faults run
  through it;
* the window's FLOPs: ``train_step_flops`` below, whose per-frame
  conditioning term is the one d -> 12 d projection the stack shares,
  where the DiT has an adaLN and a gate in each block;
* the traced slice also holds ``block_forwards``, the program's count of
  MMDiT block forwards over the traced steps (None where the program
  keeps none), against which the MMDiT's span metrics check their
  records (``span_ms_per_step``).

The attention bound and the expected launches are train.py's: the
MMDiT checkpoints each block (2 forwards a layer) and, at mmdit_v2's
1,000 frames, neither window's span (1,040 and 16,640 tokens) divides
L 65,000, so every layer takes K1 (32 / 16 / 16 a step).
"""

from __future__ import annotations

import torch

from perfbench import flops as F
from perfbench.drivers.train import Driver as TrainDriver
from perfbench.drivers.train import TimedIter
from perfbench.weights import load_into, make_weights, sub_seed


def matmul_flops(cfg, frames: int, batch: int) -> float:
    """Forward matmul FLOPs of the MMDiT AV model: perfbench/flops.py's
    count with the DiT's per-block adaLN and gates (12 d^2 a frame and
    block) replaced by the shared d -> 12 d projection (24 d^2 a frame);
    the per-token terms are the DiT's, each stream's tokens through its
    own weights."""
    d, nl = cfg["d_model"], cfg["n_layers"]
    rows = batch * frames
    dit_cond = nl * 2 * (2 * d * d + d * d) * 2
    return F.matmul_flops(cfg, frames, batch) + rows * (2 * 12 * d * d
                                                        - dit_cond)


def train_step_flops(cfg, frames: int, docs) -> float:
    """FLOPs of one training step: three forwards, attention over the
    visible pairs (perfbench/flops.py ``train_step_flops``'s rule)."""
    dh = cfg["d_model"] // cfg["n_heads"]
    fwd = matmul_flops(cfg, frames, len(docs)) + \
        4 * dh * F.attention_pairs(cfg, frames, docs)
    return 3.0 * fwd


def span_ms_per_step(ctx, per_block):
    """Busy device ms a traced step of the spans ``per_block`` ({name:
    records per block forward}), summed; None where the traced slice has
    no ``block_forwards``, where the records of a name are not that many
    times it (a record dropped, or a capture other than the slice's), or
    without records."""
    from perfbench.phases import device_ms_per_step, traced_spans
    t = ctx.traced
    blocks = None if t is None else t.get("block_forwards")
    recs = traced_spans(ctx)
    if not blocks or recs is None:
        return None
    total = 0.0
    for name, k in per_block.items():
        if sum(r["name"] == name for r in recs) != k * blocks:
            return None
        ms = device_ms_per_step(ctx, name)
        if ms is None:
            return None
        total += ms
    return total


class Driver(TrainDriver):

    def setup(self):
        from owl_audio_exps_tpu_torch.models import get_model_cls
        from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
        from perfbench.reference.mmdit import mmdit_param_spec

        conf = self.program_config()
        trainer = get_trainer_cls(conf.train.trainer_id)(conf,
                                                          device=self.dev)
        model = get_model_cls(conf.model.model_id)(
            conf.model, dtype=torch.bfloat16, device=self.dev, seed=None)
        w = make_weights(mmdit_param_spec(self.mc, "core."), self.run.seed,
                         torch.float32, self.dev)
        load_into(model, w)
        self.p0 = {n: t.cpu() for n, t in w.items()}
        del w
        self.trainer, self.state = trainer, trainer.make_state(model.train())
        self.clip = trainer.grad_clip_norm()
        self.gen = torch.Generator(device=self.dev).manual_seed(
            sub_seed(self.run.seed, "noise"))
        self.batches = TimedIter(trainer.data_stream(
            conf.train.data_id, conf.train.batch_size, conf.train.data_kwargs))
        self.checked = self.first_steps(self.wl["check_steps"],
                                        self.wl["ref_steps"])

    def window(self, seconds):
        w = super().window(seconds)
        w["flops"] = w["steps"] * train_step_flops(
            self.mc, self.frames, [None] * self.tc["batch_size"])
        return w

    def traced(self):
        try:
            from owl_audio_exps_tpu_torch.nn import mmattn
        except ImportError:
            mmattn = None
        before = getattr(mmattn, "block_forwards", None)
        t = super().traced()
        t["block_forwards"] = (None if before is None
                               else mmattn.block_forwards - before)
        return t

    def reference(self, precision="fp32", chained=False, rows=None,
                  update=True):
        """train.py's ``reference`` on the MMDiT (reference/mmdit.py)."""
        from perfbench.reference import mmdit
        n = self.wl["ref_steps"]
        batches = self.reference_batches(n)
        if chained:
            states = [torch.Generator(device=self.dev).manual_seed(
                sub_seed(self.run.seed, "noise"))]
        else:
            states = self.checked["states"][:n]
        return mmdit.run(self.mc, self.tc, self.run.seed, batches, states,
                         precision, self.dev,
                         self.wl.get("ref_remat", False), rows, update)
