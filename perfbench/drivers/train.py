"""The training driver: the port's trainer (``trainers/base.py``
``BaseTrainer.train_step`` through ``RFTTrainer`` or ``AVRFTTrainer``)
on the configuration's model, fed by the trainer's own ``data_stream``.

Set-up builds one trainer state on weights made from the seed, writes
the packed table when the traffic packs documents, and takes the first
``check_steps`` optimizer steps through the window's own call and feed
(they warm up every shape); it keeps each step's loss, the first
gradient as the optimizer holds it after step 1, and each parameter's
change and its EMA's after the first ``ref_steps``, which the reference
(reference/) follows from the same weights, batches and draws. The window then runs
whole steps, each ending in a device sync, until ``--seconds`` have
passed; its length is up to the end of the last step.
"""

from __future__ import annotations

import copy
import math
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from perfbench import flops as F
from perfbench.weights import load_into, make_weights, sub_seed


class TimedIter:
    """An iterator that adds the seconds each ``next`` took to ``wait``."""

    def __init__(self, it):
        self.it, self.wait = it, 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.data_wait"):
            item = next(self.it)
        self.wait += time.perf_counter() - t0
        return item


def doc_lengths(spec) -> list:
    """The packed traffic's document lengths: ``count`` draws, uniform
    over [low, high] frames, from their own fixed seed (the same for
    every --seed: the seed changes the contents, not the work)."""
    rs = np.random.RandomState(spec["seed"])
    return [int(n) for n in rs.randint(spec["low"], spec["high"] + 1,
                                       spec["count"])]


def make_docs(mc, lengths, seed, device):
    """The documents of the packed table, drawn on ``device`` from the
    seed: [{"video" float16 [n, c, p, p], "mouse" float32 [n, 2],
    "buttons" float32 [n, n_buttons]}]."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    total, p = sum(lengths), mc["sample_size"]
    video = torch.randn(total, mc["channels"], p, p, generator=gen,
                        device=device).half().cpu().numpy()
    mouse = torch.randn(total, 2, generator=gen, device=device).cpu().numpy()
    btn = (torch.rand(total, mc["n_buttons"], generator=gen, device=device)
           > 0.5).float().cpu().numpy()
    docs, off = [], 0
    for n in lengths:
        docs.append({"video": video[off:off + n], "mouse": mouse[off:off + n],
                     "buttons": btn[off:off + n]})
        off += n
    return docs


def synthetic_seed(seed) -> int:
    """The synthetic source's stream index (its RandomState takes 1000
    plus it) for a --seed."""
    return sub_seed(seed, "data") % (2 ** 32 - 1001)


def synthetic_shapes(mc, tc, frames):
    """The synthetic source's columns with their batch axis, in order."""
    b, p = tc["batch_size"], mc["sample_size"]
    cols = [((b, frames, mc["channels"], p, p), "normal")]
    if mc.get("has_audio", False):
        cols.append(((b, frames, mc["audio_channels"]), "normal"))
    return cols + [((b, frames, 2), "normal"),
                   ((b, frames, mc["n_buttons"]), "binary")]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    kind = "train"

    def __init__(self, run):
        self.run = run
        self.cfg = copy.deepcopy(run.config)
        self.wl = run.workload
        self.traffic = self.wl["traffic"]
        self.dev = run.device
        self.mc, self.tc = self.cfg["model"], self.cfg["train"]
        self.frames = self.traffic["window_frames"]
        self.tmp = None

    # ------------------------------------------------------------ set-up
    def program_config(self):
        from owl_audio_exps_tpu_torch.configs import Config
        tc = copy.deepcopy(self.tc)
        tr = self.traffic
        if tr["source"] == "packed":
            self.tmp = tempfile.mkdtemp(prefix="perfbench_table_")
            tc["data_id"] = "sequence_packing"
            tc["data_kwargs"] = {"window_length": self.frames,
                                 "dataset_path": self.tmp,
                                 "batch_columns": ["video", "mouse",
                                                   "buttons"]}
        else:
            tc["data_id"] = tr["source"]
            kw = {"window_length": self.frames,
                  "channels": self.mc["channels"],
                  "sample_size": self.mc["sample_size"],
                  "n_buttons": self.mc["n_buttons"],
                  "process_index": synthetic_seed(self.run.seed)}
            if self.mc.get("has_audio", False):
                kw["audio_channels"] = self.mc["audio_channels"]
            tc["data_kwargs"] = kw
        return Config.from_dict({"model": self.mc, "train": tc})

    def write_table(self, path):
        from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
        lengths = doc_lengths(self.traffic["doc_lengths"])
        docs = make_docs(self.mc, lengths, self.run.seed, self.dev)
        table = NpyTable(path, columns=[
            "video", "mouse", "buttons", "tarball", "pt_idx", "missing",
            "truncated", "seq_len"],
            array_columns=["video", "mouse", "buttons"])
        for i, d in enumerate(docs):
            table.append(video=d["video"], mouse=d["mouse"],
                         buttons=d["buttons"], tarball=f"doc{i}", pt_idx=i,
                         missing=False, truncated=False,
                         seq_len=len(d["video"]))

    def setup(self):
        from owl_audio_exps_tpu_torch.models import get_model_cls
        from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
        from perfbench.reference.model import param_spec

        conf = self.program_config()
        if self.tmp is not None:
            self.write_table(self.tmp)
        trainer = get_trainer_cls(conf.train.trainer_id)(conf,
                                                          device=self.dev)
        model = get_model_cls(conf.model.model_id)(
            conf.model, dtype=torch.bfloat16, device=self.dev, seed=None)
        w = make_weights(param_spec(self.mc, "core."), self.run.seed,
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

    def step(self):
        micro = [next(self.batches)]
        metrics = self.trainer.train_step(self.state, micro, self.gen,
                                          clip_norm=self.clip)
        return micro[0], metrics

    def first_steps(self, n, n_ref):
        """The first ``n`` steps: their losses and draws' generator
        states, the first gradient's norm by parameter, and each
        parameter's change and its EMA's after ``n_ref`` steps (the
        reference's)."""
        states, losses = [], []
        grad1 = change = ema = None
        for i in range(n):
            states.append(self.gen.get_state())
            _, m = self.step()
            losses.append(float(m["diffusion_loss"]))
            if i == 0:
                grad1 = self.first_grad_norms()
            if i == n_ref - 1:
                change = self.change_norms()
                ema = self.change_norms(self.state.ema)
        self.p0 = None
        return dict(states=states, losses=losses, grad1=grad1, change=change,
                    ema=ema)

    @torch.no_grad()
    def change_norms(self, tensors=None):
        """Each parameter's (or, given ``tensors`` by name, each of
        those's) distance from its initial value."""
        named = (self.state.model.named_parameters() if tensors is None
                 else tensors.items())
        return {name: float((p.float() - self.p0[name].to(p.device)).norm())
                for name, p in named}

    @torch.no_grad()
    def first_grad_norms(self):
        """Each parameter's first gradient, from the optimizer's state
        after one step: Muon's momentum is (1 - momentum) g, AdamW's
        first moment (1 - beta1) g."""
        opt = self.state.optimizer
        kw = self.tc["opt_kwargs"]
        mom, b1 = kw.get("momentum", 0.95), kw.get("adamw_betas",
                                                   (0.9, 0.999))[0]
        out = {}
        for name, p in self.state.model.named_parameters():
            if opt.labels[name] == "muon":
                g = opt.muon.state[p]["momentum"].float() / (1.0 - mom)
            else:
                g = opt.adamw.state[p]["mu"].float() / (1.0 - b1)
            out[name] = float(g.norm())
        return out

    # ------------------------------------------------------------ window
    def window(self, seconds):
        """Whole steps until ``seconds`` have passed, each ending in a
        device sync."""
        setup_peak = 0
        if self.dev.type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.batches.wait = 0.0
        losses, docs = [], []
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            batch, m = self.step()
            sync(self.dev)
            losses.append(m["diffusion_loss"])
            docs.append(self.batch_docs(batch))
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else 0)
        losses = torch.stack([x.float() for x in losses]).cpu()
        tokens = self.tc["batch_size"] * self.frames * \
            self.mc["tokens_per_frame"]
        flops = sum(F.train_step_flops(self.mc, self.frames, d) for d in docs)
        return dict(seconds=elapsed, steps=len(docs),
                    tokens=tokens * len(docs), wait_s=self.batches.wait,
                    peak_bytes=peak, flops=flops,
                    setup_peak_bytes=setup_peak,
                    nonfinite=int((~torch.isfinite(losses)).sum()))

    def batch_docs(self, batch):
        if len(batch) > 3 and self.traffic["source"] == "packed":
            return [row for row in batch[3].cpu().numpy()]
        return [None] * self.tc["batch_size"]

    def end_to_end(self, w):
        return {"train_tokens_per_s": (w["tokens"] / w["seconds"],
                                       "tokens/s"),
                "train_peak_mem_gib": (w["peak_bytes"] / 2 ** 30, "GiB")}

    def answers(self, w):
        return w["steps"], w["nonfinite"]

    # ------------------------------------------------------------- trace
    def traced(self):
        """``trace_steps`` more steps under the profiler, with the
        program's kernel counters; their attention bound."""
        from perfbench import trace
        from owl_audio_exps_tpu_torch.ops import band, band2, doc_tiles, \
            splash
        n = self.wl["trace_steps"]
        for mod, names in ((splash, ("launches", "dq_launches",
                                     "dkv_launches")),
                           (band, ("fwd_launches", "bwd_launches")),
                           (band2, ("fwd_launches", "bwd_launches")),
                           (doc_tiles, ("launches",))):
            for k in names:
                setattr(mod, k, 0)
        docs = []

        def run():
            for _ in range(n):
                with torch.profiler.record_function("bench.train_step"):
                    batch, _ = self.step()
                docs.append(batch[3] if len(batch) > 3 and
                            self.traffic["source"] == "packed" else None)

        tr = trace.capture(run)
        counted = {"k1_fwd": splash.launches, "k1_dq": splash.dq_launches,
                   "k1_dkv": splash.dkv_launches,
                   "band_fwd": band.fwd_launches + band2.fwd_launches,
                   "band_bwd": band.bwd_launches + band2.bwd_launches}
        bound, expect = 0.0, dict.fromkeys(counted, 0)
        for d in docs:
            rows = ([None] * self.tc["batch_size"] if d is None
                    else list(d.cpu().numpy()))
            b, launches = F.attention_bounds(self.mc, self.frames, rows)
            bound += b
            for k, v in launches.items():
                expect[k] += v
        return dict(trace=tr, steps=n, attn_bound_s=bound,
                    launches=counted, launches_expected=expect,
                    doc_tiles=doc_tiles.launches)

    # -------------------------------------------------------- correctness
    def free(self):
        self.batches = None
        self.trainer = self.state = None
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    def reference_batches(self, n):
        from perfbench.reference import data
        tr = self.traffic
        if tr["source"] == "packed":
            lengths = doc_lengths(tr["doc_lengths"])
            docs = make_docs(self.mc, lengths, self.run.seed, self.dev)
            return data.packed_batches(docs, self.frames, n)
        return data.synthetic_batches(
            1000 + synthetic_seed(self.run.seed),
            synthetic_shapes(self.mc, self.tc, self.frames), n)

    def reference(self, precision="fp32", chained=False, rows=None,
                  update=True):
        """The reference's first ``ref_steps`` steps from the same
        weights, batches and draws: losses, first gradient and change
        norms by parameter. The draws come from the program's generator
        states, or with ``chained`` from one generator seeded as the
        program's and drawn on in the same order (a run without the
        program: the control). ``rows`` (a slice) keeps those batch rows
        only, the draws made for the whole batch, and without ``update``
        no step changes the parameters (planted faults)."""
        from perfbench.reference import train as ref_train
        n = self.wl["ref_steps"]
        batches = self.reference_batches(n)
        if chained:
            gen = torch.Generator(device=self.dev).manual_seed(
                sub_seed(self.run.seed, "noise"))
            states = [gen]
        else:
            states = self.checked["states"][:n]
        return ref_train.run(self.mc, self.tc, self.run.seed, batches,
                             states, precision, self.dev,
                             self.wl.get("ref_remat", False), rows, update)

    def compare(self, ref):
        """The numbers compared, each worst over steps or parameters."""
        return compare_training(self.checked, ref)


def worst_gap(prog, ref, kept):
    """The worst kept parameter's gap between the program's norm and the
    reference's, over the larger of its reference norm and the median
    kept parameter's."""
    r = {k: v for k, v in ref.items() if k in kept}
    med = statistics.median(r.values())
    return max(abs(prog[k] - v) / max(v, med) for k, v in r.items())


def compare_training(prog, ref):
    n = len(ref["losses"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(prog["losses"][:n], ref["losses"]))
    g_ref = ref["grad1"]
    med_g = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["grad1"][k] - g) / max(g, med_g)
                   for k, g in g_ref.items())
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone: left out of the change and of the EMA's
    kept = {k for k, g in g_ref.items() if g >= 1e-3 * med_g}
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap,
           "change_gap": worst_gap(prog["change"], ref["change"], kept),
           "ema_gap": worst_gap(prog["ema"], ref["ema"], kept)}
    if not all(math.isfinite(v) for v in out.values()):
        out = {k: float("inf") for k in out}
    return out, {"left_out_of_change": sorted(set(g_ref) - kept)}
