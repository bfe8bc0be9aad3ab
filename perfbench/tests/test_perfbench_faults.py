"""The correctness check fails what it must, at sizes a test run holds:
the control (the reference in float8, put in the program's place) and
runs of the harness on the CPU with the timed path broken underneath: a
training step that leaves the state unchanged, one that leaves the EMA
unchanged, a step that leaves out half of its batch and takes the mean
over the rest, a tick whose answer is altered where the pipeline makes
it. Each sees ``correct`` false; the
unbroken run sees it true. The cell's own limits apply (the workload
files); the widths are cut, the structure is the cell's.

The same control at the cells' full size runs on the card
(``cuda`` marker)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import control  # noqa: E402
from perfbench import run as R  # noqa: E402

TINY = {"config.model.n_layers": 4, "config.model.d_model": 32,
        "config.model.n_heads": 2, "config.model.channels": 8,
        "config.model.sample_size": 2}
VIDEO = dict(TINY, **{"config.model.tokens_per_frame": 4})
AV = dict(TINY, **{"config.model.tokens_per_frame": 5,
                   "config.model.audio_channels": 6,
                   "config.model.local_window": 3,
                   "config.model.n_frames": 4,
                   "config.model.rope_headroom": 12})
CASES = {
    "dit_v4.train.packed1536": dict(VIDEO, **{
        "workload.traffic.window_frames": 8, "config.model.n_frames": 8,
        "workload.traffic.doc_lengths": {"low": 3, "high": 10, "count": 8,
                                         "seed": 14}}),
    "dit_v4.train.window256": dict(VIDEO, **{
        "workload.traffic.window_frames": 8}),
    "av_v5.train.w16b32": dict(AV, **{"workload.traffic.window_frames": 4,
                                      "config.train.batch_size": 4}),
    "av_v5.serve.cached1": dict(AV, **{
        "workload.traffic.ring_frames": 8,
        "workload.traffic.prime_frames": 8,
        "workload.ref_ticks": 300, "workload.trace_ticks": 2}),
}
SEED = 2 ** 31 + 101


def run_small(name, seconds=0.5):
    return R.run_cell(ROOT, name, SEED, seconds, 0, device="cpu",
                      overrides=CASES[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sound_run_is_correct(name):
    assert run_small(name)["correct"] is True


@pytest.mark.parametrize("name", sorted(CASES))
def test_control_fails(name):
    got = control.readings(name, SEED, ["control"], ticks=60,
                           device="cpu", overrides=CASES[name])["control"]
    limits = R.Cell(ROOT, name).workload["limits"]
    assert any(v > limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("part", ["parameters", "ema"])
@pytest.mark.parametrize("name", ["dit_v4.train.packed1536",
                                  "dit_v4.train.window256",
                                  "av_v5.train.w16b32"])
def test_step_that_leaves_the_state_unchanged_fails(name, part, monkeypatch):
    """The step restores its parameters, or only their EMA."""
    from owl_audio_exps_tpu_torch.trainers.base import BaseTrainer
    real = BaseTrainer.train_step

    def unchanged(self, state, micro, gen, **kw):
        held = (dict(state.model.named_parameters()) if part == "parameters"
                else state.ema)
        keep = {n: t.detach().clone() for n, t in held.items()}
        out = real(self, state, micro, gen, **kw)
        with torch.no_grad():
            for n, t in held.items():
                t.copy_(keep[n])
        return out

    monkeypatch.setattr(BaseTrainer, "train_step", unchanged)
    r = run_small(name)
    assert r["correct"] is False
    gap = "change_gap" if part == "parameters" else "ema_gap"
    assert r["checks"][gap]["value"] == pytest.approx(1.0)
    if part == "ema":
        assert r["checks"]["change_gap"]["value"] < \
            R.Cell(ROOT, name).workload["limits"]["change_gap"]


def test_half_the_batch_left_out_fails(monkeypatch):
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import AVRFTTrainer
    real = AVRFTTrainer.loss_fn

    def half(self, model, batch, generator):
        return real(self, model, [b[: b.shape[0] // 2] for b in batch],
                    generator)

    monkeypatch.setattr(AVRFTTrainer, "loss_fn", half)
    assert run_small("av_v5.train.w16b32")["correct"] is False


def test_an_altered_answer_fails(monkeypatch):
    from owl_audio_exps_tpu_torch.inference import pipeline
    real = pipeline.CachedStreamingPipeline._tick
    count = [0]

    def altered(self, *a, **kw):
        out = real(self, *a, **kw)
        count[0] += 1
        if count[0] == 9:   # the window's first tick (8 warm up)
            out = (out[0] * 1.05,) + tuple(out[1:])
        return out

    monkeypatch.setattr(pipeline.CachedStreamingPipeline, "_tick", altered)
    assert run_small("av_v5.serve.cached1")["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_control_fails_at_full_size_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's size")
    got = control.readings(name, SEED, ["control"], ticks=200)["control"]
    limits = R.Cell(ROOT, name).workload["limits"]
    assert any(v > limits[k] for k, v in got.items()), got
